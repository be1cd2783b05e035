"""Hand-written Hopper kernels of the port (sources in ``csrc/``), each beside
its plain PyTorch version."""
