"""A bias-free 1-D convolution with dilation 1 over narrow channels (B5): counterpart of
`ttscube_tpu/ops/pallas_conv.py::narrow_conv_pallas_blocked`.

    out[b, t, o] = Σ_{j, i} x[b, t − (k − 1)//2 + j, i] · w[j, i, o]

with zeros outside [0, T): `fold_conv_kernel`'s padding (ttscube_tpu/ops/conv.py), so
an even k pads (k − 1)//2 on the left. x (B, T, C) and w (k, C, C) are both fp32 or
both bf16; the sums are fp32 and the output is fp32 (the TPU kernel's
`preferred_element_type=float32`). The TPU function's `fold` and `tile` are layout and
change no value, so they are not taken, and T need not be a multiple of a tile.

`narrow_conv_blocked(x, w)` is the wrapper: on a CUDA tensor it launches the
hand-written kernel `csrc/narrow_conv.cu` (and raises if it cannot), on a CPU tensor it
runs `narrow_conv_plain`, `F.pad` and `F.conv1d` in fp32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ttscube_tpu_torch.ops import _build

KERNEL_SOURCE = "narrow_conv"
# the kernel's limits (csrc/narrow_conv.cu; checked against the library when it is
# loaded): channels a multiple of `quantum` up to `max_channels`, k ≤ `max_k`
LIMITS = {"quantum": 32, "max_channels": 256, "max_k": 15}


def _check(x, w) -> None:
    if x.dim() != 3 or w.dim() != 3 or tuple(w.shape[1:]) != (x.shape[2], x.shape[2]):
        raise ValueError(f"narrow_conv: x must be (B, T, C) and w (k, C, C), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"narrow_conv: x and w must both be fp32 or both bf16, got "
                         f"{x.dtype} and {w.dtype}")
    C, k = x.shape[2], w.shape[0]
    q, top, max_k = LIMITS["quantum"], LIMITS["max_channels"], LIMITS["max_k"]
    if C % q or not q <= C <= top or not 1 <= k <= max_k:
        raise ValueError(f"narrow_conv: C = {C}, k = {k} is beyond the kernel's limits (C a "
                         f"multiple of {q} up to {top}, k ≤ {max_k})")


def narrow_conv_plain(x, w):
    """Stock-op version in fp32 (bf16 operands are exact there): x (B, T, C), w (k, C, C)
    → (B, T, C) fp32."""
    k = w.shape[0]
    left = (k - 1) // 2
    xt = F.pad(x.float().transpose(1, 2), (left, k - 1 - left))
    return F.conv1d(xt, w.float().permute(2, 1, 0)).transpose(1, 2)


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(KERNEL_SOURCE, "ttscube_narrow_conv", [p, p, i, i, i, i, i, p, p, p],
                       LIMITS)


def narrow_conv_blocked(x, w):
    """The conv's output (B, T, C) fp32.

    CPU tensors take `narrow_conv_plain`; CUDA tensors launch the kernel on x's device
    or raise. `narrow_conv_blocked.launches` counts kernel launches,
    `narrow_conv_blocked.last_grid` holds the thread blocks of the last one."""
    _check(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return narrow_conv_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"narrow_conv: x and w must lie on one CUDA device or the CPU, got "
                         f"{x.device} and {w.device}")
    x, w = x.contiguous(), w.contiguous()
    B, T, C = x.shape
    out = torch.empty(B, T, C, device=x.device, dtype=torch.float32)
    grid = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ttscube_narrow_conv(
            x.data_ptr(), w.data_ptr(), int(x.dtype == torch.bfloat16), B, T, C, w.shape[0],
            out.data_ptr(), ctypes.addressof(grid),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"narrow_conv: kernel launch failed with CUDA error {err}")
    narrow_conv_blocked.launches += 1
    narrow_conv_blocked.last_grid = grid.value
    return out


narrow_conv_blocked.launches = 0
narrow_conv_blocked.last_grid = 0


def narrow_conv_flops(batch: int, t: int, channels: int, k: int) -> int:
    """Operations (2 per multiply-add): C·C·k multiply-adds per output sample."""
    return 2 * batch * t * channels * channels * k
