"""CUDA kernels of the port, their plain torch versions and wrappers."""
