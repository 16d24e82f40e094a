"""Kernels of the port: each module holds a hand-written CUDA kernel's
wrapper (launch on a CUDA tensor, or raise) beside its plain PyTorch
version (run on a CPU tensor)."""
