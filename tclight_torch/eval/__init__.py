"""Evaluation metrics and their checkpoint loaders (counterpart of
tclight_tpu/eval/)."""
