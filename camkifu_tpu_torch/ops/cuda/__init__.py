"""Hand-written CUDA kernels (csrc/*.cu): ctypes wrappers with launch
counters, and their plain PyTorch versions."""
