"""`spans.tome_device_ms_per_step` in the xy-only sampling cells (moves sampling_s_per_frame)."""

from tcbench.spans import tome_device_ms_per_step as read  # noqa: F401
