"""`readers.launches_per_step` in the yt-pass sampling cells (moves sampling_s_per_frame.yt)."""

from tcbench.readers import launches_per_step as read  # noqa: F401
