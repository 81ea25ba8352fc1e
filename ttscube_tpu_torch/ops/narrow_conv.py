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
runs `narrow_conv_plain`, `F.pad` and `F.conv1d` in fp32. bf16 operands go to the
kernel's tensor-core form, fp32 operands to its CUDA-core form; `plan_chunk` picks the
chunk of input channels each stages at a time, by the kernel's shared-memory arithmetic.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ttscube_tpu_torch.ops import _build
from ttscube_tpu_torch.utils.profiling import count

KERNEL_SOURCE = "narrow_conv"
# the kernel's limits and tiling constants (csrc/narrow_conv.cu; checked against the
# library when it is loaded): channels a multiple of `quantum` up to `max_channels`,
# k ≤ `max_k`; shared memory a block may use; the fp32 form's threads and rows per
# thread; the bf16 form's rows per tile, output channels per block and padding (bf16
# elements) of each staged row
LIMITS = {"quantum": 32, "max_channels": 256, "max_k": 15, "smem_budget": 227 * 1024,
          "threads": 256, "rows_per_thread": 4, "mma_rows": 256, "mma_cols": 32,
          "pad": 8}


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


def smem_bytes(bf16: bool, C: int, k: int, ck: int) -> int:
    """Shared memory (bytes) of one block of the kernel staging `ck` of the C input
    channels at a time: `smem_bytes` in csrc/narrow_conv.cu. fp32: the slab (tile rows
    plus k − 1 halo rows, one float of padding a row, 16-byte aligned) and the weights
    of the chunk; bf16: a weight buffer (k·ck rows of 32 output channels) and a slab
    buffer (256 + k − 1 rows), each row padded by 8 bf16, twice each when the weights
    are staged per chunk, else the weights once and two slabs."""
    L = LIMITS
    if not bf16:
        tr = L["rows_per_thread"] * (L["threads"] // (C // 4))
        xs = ((tr + k - 1) * (ck + 1) + 3) // 4 * 4
        return 4 * (xs + k * ck * C)
    wb = 2 * k * ck * (L["mma_cols"] + L["pad"])
    xb = 2 * (L["mma_rows"] + k - 1) * (ck + L["pad"])
    return wb + 2 * xb if ck == C else 2 * (wb + xb)


def plan_chunk(bf16: bool, C: int, k: int) -> int:
    """Input channels the kernel stages at a time: all C where they fit the budget (the
    weights are then staged once per block), else the largest divisor of C that fits
    (multiples of 32 for bf16, powers of two down to 4 for fp32)."""
    if bf16:
        cands = [C] + [c for c in range(C - 32, 31, -32) if C % c == 0]
    else:
        cands = [C] + [p for p in (128, 64, 32, 16, 8, 4) if p < C and C % p == 0]
    for ck in cands:
        if smem_bytes(bf16, C, k, ck) <= LIMITS["smem_budget"]:
            return ck
    raise ValueError(f"narrow_conv: no chunk of C = {C} input channels fits the kernel's "
                     f"shared memory at k = {k}")


def narrow_conv_plain(x, w):
    """Stock-op version in fp32 (bf16 operands are exact there): x (B, T, C), w (k, C, C)
    → (B, T, C) fp32."""
    k = w.shape[0]
    left = (k - 1) // 2
    xt = F.pad(x.float().transpose(1, 2), (left, k - 1 - left))
    return F.conv1d(xt, w.float().permute(2, 1, 0)).transpose(1, 2)


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(KERNEL_SOURCE, "ttscube_narrow_conv",
                       [p, p, i, i, i, i, i, i, p, p, p], LIMITS)


def narrow_conv_blocked(x, w):
    """The conv's output (B, T, C) fp32.

    CPU tensors take `narrow_conv_plain`; CUDA tensors launch the kernel on x's device
    or raise. Each launch counts `launches.narrow_conv_blocked`
    (`utils/profiling.count`); `narrow_conv_blocked.last_grid` holds the thread blocks of
    the last one."""
    _check(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return narrow_conv_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"narrow_conv: x and w must lie on one CUDA device or the CPU, got "
                         f"{x.device} and {w.device}")
    # the kernel reads 16-byte pieces: a view that starts off that boundary is copied
    x, w = (t if t.data_ptr() % 16 == 0 else t.clone()
            for t in (x.contiguous(), w.contiguous()))
    B, T, C = x.shape
    k = w.shape[0]
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty(B, T, C, device=x.device, dtype=torch.float32)
    grid = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ttscube_narrow_conv(
            x.data_ptr(), w.data_ptr(), int(bf16), B, T, C, k, plan_chunk(bf16, C, k),
            out.data_ptr(), ctypes.addressof(grid),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"narrow_conv: kernel launch failed with CUDA error {err}")
    count("launches.narrow_conv_blocked")
    narrow_conv_blocked.last_grid = grid.value
    return out


narrow_conv_blocked.last_grid = 0


def narrow_conv_flops(batch: int, t: int, channels: int, k: int) -> int:
    """Operations (2 per multiply-add): C·C·k multiply-adds per output sample."""
    return 2 * batch * t * channels * channels * k
