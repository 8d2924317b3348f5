"""Tools of the port: weight conversion from the JAX package, forced
alignment, WORLD statistics, TTS samples, the trigram LM of beam fusion
and the kernels' probes."""
