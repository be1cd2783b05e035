"""Tensor-level building blocks of the port: covariance functions, Vecchia
factors and their hand-written CUDA kernels."""
