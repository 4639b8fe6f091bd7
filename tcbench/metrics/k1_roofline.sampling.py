"""`readers.k1_roofline` in the xy-only sampling cells (moves sampling_s_per_frame)."""

from tcbench.readers import k1_roofline as read  # noqa: F401
