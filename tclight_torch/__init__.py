"""PyTorch + CUDA port of TC-Light (the JAX package `tclight_tpu` is its reference)."""
