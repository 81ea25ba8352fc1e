"""Serving and training forwards of the HiFi-GAN generator, counterpart of
`ttscube_tpu/models/hifigan_fused.py::generator_apply_fused` and
`generator_apply_fused_train`.

It reads the canonical `Generator` module's parameters. The serving forward fuses the
stages whose width is in `fuse_channels` exactly where the JAX function does:
- a stage whose upsample has kernel == stride runs whole as one kernel: the last stage
  with conv_post and tanh (`ops/fused_tail.fused_tail_stage`, kernel B1), a middle
  stage without them (`fused_tail_stage_mid`, kernel B1-mid);
- any other stage runs its upsample as a stock conv and its MRF as one kernel
  (`ops/fused_mrf.fused_mrf1`, kernel B3), where the JAX function's condition on the
  width and the length holds;
- every other stage runs its upsample as a stock conv and, on CUDA tensors at bf16
  storage and operands and the widths S1 takes, each ResBlock1 conv of its MRF as one
  launch of kernel S1 (`ops/stage_conv.stage_mrf`); otherwise (CPU tensors, fp32
  storage or operands, other widths) as stock PyTorch convs.
On CUDA tensors the kernels run; on CPU tensors their plain PyTorch versions. A stage
that the JAX function fuses and no kernel of the port takes raises; it never runs as
stock convs. Between convs the activations are kept in `storage_dtype` (bf16 when
serving); inside a fused stage they stay fp32, as in the TPU kernels. The non-fused
conv_post and tanh run in fp32, as in the JAX function. Its polyphase option
(`polyphase_channels`) is an exact layout transform and is not ported. Both functions
take ResBlock1 generators only and raise ValueError for another resblock kind (the
JAX functions fail with a KeyError there): a ResBlock2 generator is served through
`Generator` with `fused_tail=False`, as in the JAX package. In both functions conv_pre
is the span `tts.gen.pre` and upsample stage i the span `tts.gen.stage<i>`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ttscube_tpu_torch.models.hifigan import LRELU_SLOPE, Generator, HifiganConfig
from ttscube_tpu_torch.ops.conv import conv1d, conv_transpose1d
from ttscube_tpu_torch.ops.fused_mrf import fused_mrf1
from ttscube_tpu_torch.ops.fused_tail import (fused_tail_stage, fused_tail_stage_mid,
                                              fused_tail_stage_train)
from ttscube_tpu_torch.ops.stage_conv import stage_mrf, takes
from ttscube_tpu_torch.ops.stage_conv import conv_operands as _cd, leaky as _leaky
from ttscube_tpu_torch.utils.profiling import span


def _st(x, storage_dtype):
    """Cast an activation for storage between convs."""
    return x if storage_dtype is None else x.to(storage_dtype)


def _conv(x, conv, compute_dtype, dilation=1, padding=None):
    """One weight-normalized conv: fp32 result plus fp32 bias."""
    k = conv.kernel_size
    pad = dilation * (k - 1) // 2 if padding is None else padding
    xc, w = _cd(x, conv.weight(), compute_dtype)
    return conv1d(xc, w, None, 1, pad, dilation) + conv.bias


def _upsample(x, up, stride, kernel_size, compute_dtype=None, storage_dtype=None):
    """leaky → weight-normalized ConvTranspose1d → fp32 bias → storage dtype."""
    xc, w = _cd(_leaky(x, LRELU_SLOPE), up.weight(), compute_dtype)
    y = conv_transpose1d(xc, w, None, stride, (kernel_size - stride) // 2) + up.bias
    return _st(y, storage_dtype)


def _require_resblock1(cfg: HifiganConfig, fn: str) -> None:
    if cfg.resblock != "1":
        raise ValueError(f"{fn}: resblock {cfg.resblock!r} is not fused; serve a resblock "
                         f"{cfg.resblock!r} generator through Generator (fused_tail=False)")


def _plain_resblock1(x, block, compute_dtype=None, storage_dtype=None):
    convs = block.convs()
    for m, d in enumerate(block.dilations):
        h = _leaky(x, LRELU_SLOPE)
        h = _st(_conv(h, convs[2 * m], compute_dtype, dilation=d), storage_dtype)
        h = _leaky(h, LRELU_SLOPE)
        h = _st(_conv(h, convs[2 * m + 1], compute_dtype), storage_dtype)
        x = x + h
    return x


def _serving_mrf(gen: Generator, i: int, x, cfg: HifiganConfig, compute_dtype,
                 storage_dtype):
    """Stage i's MRF, the mean of its ResBlock1s, where no fused kernel takes it. CUDA
    tensors that kernel S1 takes (bf16 storage and operands at its widths,
    `stage_conv.takes`) launch it once per conv (`ops/stage_conv.stage_mrf`) on weights
    packed once per parameter version (`Generator.stage_conv_weights`); every other
    input, CPU tensors, fp32 storage or operands and widths S1 does not tile, runs stock
    convs (`_plain_resblock1`)."""
    dils = cfg.resblock_dilation_sizes
    if x.device.type == "cuda" and takes(x, compute_dtype, cfg.resblock_kernel_sizes, dils):
        # the upsample's output is NCW in memory
        return stage_mrf(x.contiguous(), gen.stage_conv_weights(i), dils, LRELU_SLOPE)
    acc = None
    for j in range(len(cfg.resblock_kernel_sizes)):
        h = _plain_resblock1(x, getattr(gen, f"res_{i}_{j}"), compute_dtype, storage_dtype)
        acc = h if acc is None else acc + h
    return acc / len(cfg.resblock_kernel_sizes)


def generator_apply_fused(gen: Generator, mel: torch.Tensor, cfg: HifiganConfig,
                          compute_dtype=None, fuse_channels: tuple = (32,),
                          storage_dtype=None, max_stages: int | None = None) -> torch.Tensor:
    """mel/cond (B, frames, num_mels) → audio (B, frames·total_upsample) fp32.

    Unlike the JAX function, every batch size takes the fused stages: its cut-off at
    B > 64 (`fuse_max_batch`) was measured on the TPU.

    `max_stages` is the JAX function's profiling hook: the activation after that many
    upsample stages (0: after conv_pre) in place of the audio, so that a stage's cost
    is the time of prefix k less that of prefix k − 1. As in the JAX function, a last
    stage that runs fused (B1) returns the audio, whatever `max_stages` says."""
    _require_resblock1(cfg, "generator_apply_fused")
    if storage_dtype is not None and compute_dtype is None:
        compute_dtype = storage_dtype
    with span("tts.gen.pre"):
        x = _st(_conv(mel, gen.conv_pre, compute_dtype, padding=3), storage_dtype)
    if max_stages == 0:
        return x
    ch = cfg.upsample_initial_channel
    n_stages = len(cfg.upsample_rates)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        ch //= 2
        with span(f"tts.gen.stage{i}"):
            if k == u and (u * ch) % 128 == 0 and ch in fuse_channels:
                # the whole stage (upsample + MRF [+ conv_post + tanh]) as one kernel
                w = gen.stage_weights(i, compute_dtype)
                if i == n_stages - 1:
                    audio = fused_tail_stage(x.float().contiguous(), w)
                    return audio[:, : mel.shape[1] * cfg.total_upsample]
                x = _st(fused_tail_stage_mid(x.float().contiguous(), w), storage_dtype)
                if max_stages == i + 1:
                    return x
                continue
            up = getattr(gen, f"up_{i}")
            x = _upsample(x, up, u, k, compute_dtype, storage_dtype)
            fold = 128 // ch if (ch < 128 and 128 % ch == 0) else 1
            if ch in fuse_channels and ((fold >= 2 and ch * fold == 128
                                         and x.shape[1] % fold == 0) or ch % 128 == 0):
                # the whole MRF (every chain and their mean) as one kernel
                x = _st(fused_mrf1(x.float().contiguous(),
                                   gen.stage_weights(i, compute_dtype)), storage_dtype)
            else:
                x = _serving_mrf(gen, i, x, cfg, compute_dtype, storage_dtype)
            if max_stages == i + 1:
                return x
    # final act/conv/tanh stay fp32, as in Generator
    x = F.leaky_relu(x.float(), 0.01)
    audio = torch.tanh(_conv(x, gen.conv_post, None, padding=3))[..., 0]
    return audio[:, : mel.shape[1] * cfg.total_upsample]


def generator_apply_fused_train(gen: Generator, mel: torch.Tensor,
                                cfg: HifiganConfig) -> torch.Tensor:
    """Differentiable generator forward for training, fp32: mel/cond (B, frames,
    num_mels) → audio (B, frames·total_upsample).

    conv_pre and every stage but the last run as convs under autograd; the last stage,
    when it is the v1 tail (C = 32, kernel == stride == 4), runs through
    `FusedTailStageGrad`: forward kernel B1, backward kernel B2. Its weights are the
    weight-normed tensors with their graph, so autograd pulls the grads on back to
    each v and g (not `Generator.tail_weights`, which packs once, detached, for
    serving)."""
    _require_resblock1(cfg, "generator_apply_fused_train")
    with span("tts.gen.pre"):
        x = _conv(mel, gen.conv_pre, None, padding=3)
    ch = cfg.upsample_initial_channel
    n_stages = len(cfg.upsample_rates)
    n_blocks = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        ch //= 2
        with span(f"tts.gen.stage{i}"):
            up = getattr(gen, f"up_{i}")
            blocks = [getattr(gen, f"res_{i}_{j}") for j in range(n_blocks)]
            if i == n_stages - 1 and k == u == 4 and ch == 32:
                convs = [cv for block in blocks for cv in block.convs()]
                audio = fused_tail_stage_train(
                    x.contiguous(), up.weight(), up.bias, [cv.weight() for cv in convs],
                    [cv.bias for cv in convs], gen.conv_post.weight(), gen.conv_post.bias,
                    kernel_sizes=cfg.resblock_kernel_sizes,
                    dilations=cfg.resblock_dilation_sizes)
                return audio[:, : mel.shape[1] * cfg.total_upsample]
            x = _upsample(x, up, u, k)
            acc = None
            for block in blocks:
                h = _plain_resblock1(x, block)
                acc = h if acc is None else acc + h
            x = acc / n_blocks
    x = F.leaky_relu(x, 0.01)
    audio = torch.tanh(_conv(x, gen.conv_post, None, padding=3))[..., 0]
    return audio[:, : mel.shape[1] * cfg.total_upsample]
