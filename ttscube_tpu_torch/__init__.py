"""ttscube_tpu_torch — the PyTorch/CUDA port of ttscube_tpu for NVIDIA Hopper.

The JAX package `ttscube_tpu` stays the reference; every module here mirrors its
counterpart there (same file layout, same NWC / (B, T, C) layouts at public
functions) and is held against it by the `tests/test_torch_*.py` parity tests.
This package imports torch, numpy and the standard library only.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks for the CPU.

    Asking for CUDA where there is none raises; the port never carries on quietly on
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
