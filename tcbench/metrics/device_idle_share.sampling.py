"""`readers.device_idle_share` in the xy-only sampling cells (moves sampling_s_per_frame)."""

from tcbench.readers import device_idle_share as read  # noqa: F401
