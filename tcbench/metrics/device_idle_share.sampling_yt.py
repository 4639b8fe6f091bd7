"""`readers.device_idle_share` in the yt-pass sampling cells (moves sampling_s_per_frame.yt)."""

from tcbench.readers import device_idle_share as read  # noqa: F401
