"""Tools of the port: weight conversion from the JAX package, forced
alignment, TTS samples and the kernels' probes."""
