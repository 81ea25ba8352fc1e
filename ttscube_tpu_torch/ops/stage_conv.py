"""One ResBlock1 conv of an unfused serving stage of the HiFi-GAN generator in one pass
(S1, `csrc/stage_conv.cu`), and the stage's whole MRF as 2·Σ len(dilations) of them.

    y = bf16(conv_d(leaky(x)) + bias); then y = bf16(residual + y), y = bf16(accum + y),
    y = bf16(y / n_mean), y = leaky(y), as each is asked for

with the rounding points of the serving generator's plain ResBlock1 at bf16 storage and
operands (`models/hifigan_fused.py`): the leaky in the activation's dtype (`leaky`), the
conv's operands in bf16 and its sum fp32 (`conv_operands`), the fp32 bias, the
result rounded once to the storage dtype, the residual `x = x + h`, the sum of the blocks
`acc + h` and their mean `acc / n` each rounded once more. x is NWC (B, T, C). A conv
whose output only feeds the next conv returns it activated (`leaky_out`), so that the
next one takes it as it is (`leaky_in=False`) and the leaky runs once per tensor.

`stage_conv(x, cw, ...)` is the wrapper: on a CUDA tensor it launches the kernel (and
raises if it cannot), on a CPU tensor it runs `stage_conv_plain`, the same function in
stock ops. The kernel takes bf16 tensors with bf16 operands at the widths `takes`
accepts; the generator (`models/hifigan_fused.py`) sends it nothing else. At bf16
storage the serving path's operands are bf16: `generator_apply_fused` takes the storage
dtype for the compute dtype where none is given, as the JAX function does. It has no
backward: training keeps its stock convs under autograd (`generator_apply_fused_train`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ttscube_tpu_torch.ops import _build
from ttscube_tpu_torch.ops.conv import conv1d
from ttscube_tpu_torch.utils.profiling import count

KERNEL_SOURCE = "stage_conv"
# the kernel's limits and tiling constants (csrc/stage_conv.cu; checked against the
# library when it is loaded): channels a multiple of `quantum` up to `max_channels`, a
# halo d·(k − 1) of at most `max_halo` rows; rows and output channels of a block's tile,
# input channels of a pipeline chunk
LIMITS = {"quantum": 64, "max_channels": 1024, "max_halo": 64, "rows": 512, "cols": 64,
          "chunk": 64}


class ConvWeights(NamedTuple):
    """One weight-normalised conv: its fp32 weight (C_out, C_in, k) and bias (C,) for the
    plain version, and the kernel's bf16 weight (k, C_in, C_out)."""

    weight: torch.Tensor
    bias: torch.Tensor
    taps: torch.Tensor


def leaky(x, slope):
    """`jax.nn.leaky_relu`: the slope takes the activation's dtype (0.1 is
    0.10009765625 in bf16), and the product is rounded once to that dtype."""
    return F.leaky_relu(x, float(torch.tensor(slope, dtype=x.dtype)))


def conv_operands(x, w, compute_dtype):
    """Operands of one conv rounded to the compute dtype and held in fp32, so that the
    conv accumulates and returns fp32 and its result is rounded once, where it is
    stored: the JAX function's bf16 operands with `preferred_element_type=fp32`. (A
    bf16 `F.conv1d` would round its result to bf16 before the bias is added.) On the
    card cuDNN runs these fp32 convs on TF32 tensor cores by default, which hold bf16
    values exactly."""
    if compute_dtype is None:
        return x.float(), w
    return x.to(compute_dtype).float(), w.to(compute_dtype).float()


def pack_conv(weight, bias) -> ConvWeights:
    """A conv's weight (C_out, C_in, k) and bias packed for `stage_conv`: the weight
    rounded to bf16, laid out (k, C_in, C_out)."""
    weight, bias = weight.detach().float(), bias.detach().float()
    return ConvWeights(weight, bias.contiguous(),
                       weight.permute(2, 1, 0).to(torch.bfloat16).contiguous())


def takes(x, compute_dtype, kernel_sizes, dilations) -> bool:
    """Whether the kernel takes a stage with input x (B, T, C), operands in
    `compute_dtype` and these ResBlock1 kernel sizes and dilations: bf16 storage and
    operands, C a multiple of `quantum` up to `max_channels`, odd kernel sizes, each
    halo d·(k − 1) within `max_halo`."""
    C, L = x.shape[-1], LIMITS
    return (x.dtype == torch.bfloat16 and compute_dtype == torch.bfloat16
            and C % L["quantum"] == 0
            and L["quantum"] <= C <= L["max_channels"]
            and all(k % 2 == 1 and d * (k - 1) <= L["max_halo"]
                    for k, ds in zip(kernel_sizes, dilations) for d in ds))


def stage_conv_plain(x, weight, bias, *, dilation: int, slope: float, residual=None,
                     accum=None, n_mean: int = 0, leaky_in: bool = True,
                     leaky_out: bool = False):
    """Stock-op version: x (B, T, C) → (B, T, C) in x's dtype; weight (C_out, C_in, k)
    and bias fp32, the conv's operands rounded to bf16."""
    k = weight.shape[-1]
    xc, w = conv_operands(leaky(x, slope) if leaky_in else x, weight, torch.bfloat16)
    y = (conv1d(xc, w, None, 1, dilation * (k - 1) // 2, dilation) + bias).to(x.dtype)
    if residual is not None:
        y = residual + y
    if accum is not None:
        y = accum + y
    if n_mean:
        y = y / n_mean
    return leaky(y, slope) if leaky_out else y


def _lib():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.bind(KERNEL_SOURCE, "ttscube_stage_conv",
                       [p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, p, p], LIMITS)


def stage_conv(x, cw: ConvWeights, *, dilation: int, slope: float, residual=None,
               accum=None, n_mean: int = 0, leaky_in: bool = True, leaky_out: bool = False,
               out=None):
    """The conv's output (B, T, C) in x's dtype, written into `out` where one is given
    (it may be `residual` or `accum`, never x).

    CPU tensors take `stage_conv_plain`; CUDA tensors launch the kernel on x's device or
    raise. Each launch counts `launches.stage_conv` (`utils/profiling.count`)."""
    if x.device.type == "cpu":
        y = stage_conv_plain(x, cw.weight, cw.bias, dilation=dilation, slope=slope,
                             residual=residual, accum=accum, n_mean=n_mean, leaky_in=leaky_in,
                             leaky_out=leaky_out)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"stage_conv: unsupported device {x.device}")
    k, C = cw.taps.shape[0], x.shape[-1]
    if (x.dim() != 3 or not takes(x, torch.bfloat16, (k,), ((dilation,),))
            or cw.taps.shape[1:] != (C, C) or cw.taps.dtype != torch.bfloat16):
        raise ValueError(f"stage_conv: x {x.dtype} {tuple(x.shape)} with k = {k}, d = "
                         f"{dilation} is beyond the kernel's limits {LIMITS}")
    if out is x:
        raise ValueError("stage_conv: out must not be x")
    others = [t for t in (residual, accum, out) if t is not None]
    for t in (x, *others, cw.taps, cw.bias):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("stage_conv: every tensor must be contiguous, 16-byte aligned "
                             "and on x's device")
    if any(t.shape != x.shape or t.dtype != x.dtype for t in others):
        raise ValueError("stage_conv: residual, accum and out must be x's shape and dtype")
    if out is None:
        out = torch.empty_like(x)
    B, T, _ = x.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ttscube_stage_conv(
            x.data_ptr(), cw.taps.data_ptr(), cw.bias.data_ptr(), ptr(residual), ptr(accum),
            out.data_ptr(), B, T, C, k, dilation, int(leaky_in), int(leaky_out),
            float(torch.tensor(slope, dtype=x.dtype)), 1.0 / n_mean if n_mean else 0.0,
            None, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stage_conv: kernel launch failed with CUDA error {err}")
    count("launches.stage_conv")
    return out


def stage_mrf(x, blocks, dilations, slope: float):
    """The mean of the ResBlock1s `blocks` on x (B, T, C): block j's convs `blocks[j]`
    (ConvWeights, in call order: per dilation conv_d, then conv_1), its dilations
    `dilations[j]`. Each ResBlock1 is `x += conv_1(leaky(conv_d(leaky(x))))` per dilation;
    the last conv of each block adds its output into the running sum, the last block's
    also divides it by their number. The convs write into three buffers: conv_d's output,
    a block's running x and the sum."""
    n = len(blocks)
    t, y, total = (torch.empty_like(x) for _ in range(3))
    acc = None
    for j, (convs, dils) in enumerate(zip(blocks, dilations)):
        res = x
        for m, d in enumerate(dils):
            h = stage_conv(res, convs[2 * m], dilation=d, slope=slope, leaky_out=True, out=t)
            kw = dict(dilation=1, slope=slope, residual=res, leaky_in=False)
            if m < len(dils) - 1:
                res = stage_conv(h, convs[2 * m + 1], out=y, **kw)
            else:
                acc = stage_conv(h, convs[2 * m + 1], accum=acc, n_mean=n if j == n - 1 else 0,
                                 out=total, **kw)
    return acc


def stage_conv_flops(batch: int, t: int, channels: int, k: int) -> int:
    """Operations (2 per multiply-add) of one conv: C·C·k multiply-adds per output row."""
    return 2 * batch * t * channels * channels * k
