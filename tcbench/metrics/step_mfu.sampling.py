"""`readers.step_mfu` in the xy-only sampling cells (moves sampling_s_per_frame)."""

from tcbench.readers import step_mfu as read  # noqa: F401
