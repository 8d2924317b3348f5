"""Building and loading the hand-written CUDA kernels of ``csrc/``."""
