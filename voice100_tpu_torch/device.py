"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.

    Asking for CUDA (explicitly or by default) on a machine without it
    raises ``RuntimeError``: nothing falls back to the CPU silently.

    Resolving a CUDA device also turns TF32 off for cuBLAS matmuls and
    cuDNN convolutions (cuDNN convolutions default to TF32). The port is
    held to the JAX reference, whose matmuls run in full float32
    (``Precision.HIGHEST``), and TF32 keeps only about three decimal
    digits.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
