"""Hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper takes the kernel for a CUDA tensor (or raises) and the plain
version only for a tensor on the CPU. Kernels are compiled from ``csrc/`` on
first use, never at import.
"""
