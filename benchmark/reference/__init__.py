"""Plain float32 PyTorch references of the benchmark's configurations.

A configuration file names its reference (``"reference": "asr_v2"``);
this package imports neither the port nor JAX."""
