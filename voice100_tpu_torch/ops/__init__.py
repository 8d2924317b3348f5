"""Tensor ops of the port: the log-mel front end, masks and the biLSTM,
each CUDA kernel beside its plain PyTorch version."""
