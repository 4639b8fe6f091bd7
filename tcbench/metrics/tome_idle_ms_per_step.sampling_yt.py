"""`spans.tome_idle_ms_per_step` in the yt-pass sampling cells (moves sampling_s_per_frame.yt)."""

from tcbench.spans import tome_idle_ms_per_step as read  # noqa: F401
