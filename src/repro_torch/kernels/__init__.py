"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version; ``ops`` picks one by the device of the input."""
