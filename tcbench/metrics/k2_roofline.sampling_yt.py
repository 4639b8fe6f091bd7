"""`readers.k2_roofline` in the yt-pass sampling cells (moves sampling_s_per_frame.yt)."""

from tcbench.readers import k2_roofline as read  # noqa: F401
