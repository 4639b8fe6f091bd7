"""`spans.host_syncs_per_step` in the yt-pass sampling cells (moves sampling_s_per_frame.yt)."""

from tcbench.spans import host_syncs_per_step as read  # noqa: F401
