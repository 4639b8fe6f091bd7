"""`readers.other_ms_per_step` in the yt-pass sampling cells (moves sampling_s_per_frame.yt)."""

from tcbench.readers import other_ms_per_step as read  # noqa: F401
