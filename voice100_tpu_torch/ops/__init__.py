"""Tensor ops of the port: the log-mel front end, masks, augmentation,
the biLSTM and the CTC loss, each CUDA kernel beside its plain PyTorch
version."""
