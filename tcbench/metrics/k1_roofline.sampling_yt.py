"""`readers.k1_roofline` in the yt-pass sampling cells (moves sampling_s_per_frame.yt)."""

from tcbench.readers import k1_roofline as read  # noqa: F401
