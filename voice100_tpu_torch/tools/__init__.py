"""Tools of the port: weight conversion from the JAX package, forced
alignment, WORLD statistics, TTS samples and the kernels' probes."""
