"""Hand-written CUDA kernels of the port and their plain PyTorch
versions.  Each wrapper runs its kernel on CUDA tensors (or raises) and
its plain version on CPU tensors."""
