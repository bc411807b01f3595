"""Hand-written Hopper kernels of the port, each beside its plain torch
version. A wrapper (``<kernel>/ops.py``) runs the plain version for CPU
tensors and launches the CUDA kernel for CUDA tensors (`dispatch.route`)."""
