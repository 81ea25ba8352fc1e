"""One ResBlock1 of the HiFi-GAN generator as one kernel (B4): counterpart of
`ttscube_tpu/ops/pallas_resblock.py::fused_resblock1`.

    per dilation d:  x += conv_1(leaky(conv_d(leaky(x))))

All convs are 'same' C → C convs with zero padding, slope 0.1, positions outside
[0, T) reading as zero after every conv (the TPU kernel's mask, `_resblock_kernel`).
`fused_resblock1(x, kernels, biases, kernel_size=, dilations=)` takes the JAX
function's arguments: x (B, T, C) fp32, kernels 2·len(dilations) (k, C_in, C_out)
tensors in call order (per dilation conv_d, then conv_1), biases (C,). The TPU's
`fold` and `rows_per_tile` are layout and change no value, so they are not taken.

A ResBlock1 is an MRF stage with one chain, and the mean over one chain is the
identity: on a CUDA tensor the wrapper launches B3's cooperative kernel through its own
entry point `ttscube_fused_resblock1` (`csrc/fused_mrf_stage.cu`), which takes exactly
one chain, and counts its own launches. On a CPU tensor it runs
`fused_resblock1_plain`, the same function in stock PyTorch ops (`mrf_chains_plain`).

Dtype rule, as in the TPU kernel: with `compute_dtype=torch.bfloat16` only the conv
operands (the activation after leaky, and the weight) are rounded to bf16; products,
sums, biases and the residual stay fp32. The output is fp32.
"""

from __future__ import annotations

import ctypes

import torch

from ttscube_tpu_torch.ops import _build
from ttscube_tpu_torch.ops.fused_mrf import (KERNEL_SOURCE, LIMITS as MRF_LIMITS,
                                             chain_spec, check_chains, mrf_chains_plain,
                                             mrf_flops, pack_convs)
from ttscube_tpu_torch.utils.profiling import count

# B3's limits with one chain (checked against the library when it is loaded)
LIMITS = dict(MRF_LIMITS, max_blocks=1)


def _packed(kernels, biases, kernel_size: int, dilations, compute_dtype, C: int):
    """Check one ResBlock1 against the kernel's limits; its convs packed as B3 packs
    them (each [k][C_in][C_out] flat, rounded to the compute dtype; biases [n][C])."""
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"fused_resblock1: compute_dtype {compute_dtype} not supported")
    q, top = LIMITS["quantum"], LIMITS["max_channels"]
    if C % q or not q <= C <= top:
        raise ValueError(f"fused_resblock1: {C} channels is beyond the kernel's limits (a "
                         f"multiple of {q} up to {top})")
    conv1d = [w.permute(2, 1, 0) for w in kernels]  # (k, C_in, C_out) → Conv1d layout
    check_chains("fused_resblock1", conv1d, biases, C, (kernel_size,), (tuple(dilations),),
                 LIMITS)
    return pack_convs(conv1d, biases, compute_dtype, torch.float32)


def fused_resblock1_plain(x, kernels, biases, *, kernel_size: int, dilations,
                          compute_dtype=None):
    """Stock-op version: x (B, T, C) → (B, T, C) fp32."""
    C = x.shape[2]
    w, b = _packed(kernels, biases, kernel_size, dilations, compute_dtype, C)
    y = mrf_chains_plain(x.float().transpose(1, 2), w, b, (kernel_size,),
                         (tuple(dilations),), compute_dtype)
    return y.transpose(1, 2)


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(KERNEL_SOURCE, "ttscube_fused_resblock1",
                       [p, i, i, i, p, p, p, i, p, p, p, p], LIMITS)


def fused_resblock1(x, kernels, biases, *, kernel_size: int, dilations,
                    compute_dtype=None):
    """The ResBlock1's output (B, T, C) fp32 from x (B, T, C) fp32.

    CPU tensors take `fused_resblock1_plain`; CUDA tensors launch the kernel on x's
    device or raise. Each launch counts `launches.fused_resblock1`
    (`utils/profiling.count`); `fused_resblock1.last_grid` holds the thread blocks of the
    last one."""
    if x.device.type == "cpu":
        return fused_resblock1_plain(x, kernels, biases, kernel_size=kernel_size,
                                     dilations=dilations, compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock1: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"fused_resblock1: x must be a contiguous fp32 (B, T, C) tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    B, T, C = x.shape
    w, b = _packed(kernels, biases, kernel_size, dilations, compute_dtype, C)
    if w.device != x.device or b.device != x.device:
        raise ValueError("fused_resblock1: weights must lie on the input's device")
    out = torch.empty_like(x)
    workspace = torch.empty(2 * x.numel(), device=x.device)
    spec = chain_spec((kernel_size,), (tuple(dilations),))
    spec_arr = (ctypes.c_int * len(spec))(*spec)
    grid = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ttscube_fused_resblock1(
            x.data_ptr(), B, T, C, w.data_ptr(), b.data_ptr(),
            ctypes.cast(spec_arr, ctypes.c_void_p), int(compute_dtype is not None),
            workspace.data_ptr(), out.data_ptr(), ctypes.addressof(grid),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_resblock1: kernel launch failed with CUDA error {err}")
    count("launches.fused_resblock1")
    fused_resblock1.last_grid = grid.value
    return out


fused_resblock1.last_grid = 0


def resblock_flops(batch: int, t: int, channels: int, kernel_size: int, dilations) -> int:
    """Operations (2 per multiply-add) of one ResBlock1 on this input: 2·len(dilations)
    convs of C·C·k multiply-adds per sample."""
    return mrf_flops(batch, t, channels, (kernel_size,), (tuple(dilations),))
