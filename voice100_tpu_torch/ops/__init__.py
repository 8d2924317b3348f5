"""Tensor ops of the port: the log-mel front end, masks, augmentation,
the biLSTM, the CTC loss and the CTC Viterbi alignment, each CUDA kernel
beside its plain PyTorch version; the TTS duration expansion
(``duration``); and the host-side error rates (``metrics``)."""
