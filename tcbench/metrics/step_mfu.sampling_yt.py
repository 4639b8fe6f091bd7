"""`readers.step_mfu` in the yt-pass sampling cells (moves sampling_s_per_frame.yt)."""

from tcbench.readers import step_mfu as read  # noqa: F401
