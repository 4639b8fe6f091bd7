"""Multi-device execution over torch.distributed (counterpart of
tclight_tpu/parallel/)."""
