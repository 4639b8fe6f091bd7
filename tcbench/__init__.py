"""The benchmark of the PyTorch and CUDA port (tclight_torch); see README.md."""
