"""HiFi-GAN, counterpart of `ttscube_tpu/models/hifigan.py`: `HifiganConfig`,
`ResBlock1` (v1) and `ResBlock2`, `Generator`, `generate_chunked`, the discriminators
(`DiscriminatorP`, `DiscriminatorS`, `MultiPeriodDiscriminator`,
`MultiScaleDiscriminator`) and the GAN losses. `Generator.forward` is the plain module
path (the JAX `Generator.apply`); the serving path with the fused tail stage is
`models/hifigan_fused.generator_apply_fused`, the training path
`models/hifigan_fused.generator_apply_fused_train`. Every conv takes a
`compute_dtype` (bf16 operands, the result rounded to bf16 and then fp32, the bias in
fp32: `ops/conv.py`); weights and their norms stay fp32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ttscube_tpu_torch.ops.conv import SNConv1d, WNConv1d, WNConv2d, WNConvTranspose1d
from ttscube_tpu_torch.ops.fused_mrf import MrfWeights, pack_mrf_weights
from ttscube_tpu_torch.ops.fused_tail import TailWeights, pack_tail_weights

LRELU_SLOPE = 0.1

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class HifiganConfig:
    """The JAX `HifiganConfig` fields the serving path reads (v1 defaults)."""

    resblock: str = "1"
    upsample_rates: tuple = (5, 3, 4, 4)
    upsample_kernel_sizes: tuple = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80
    sampling_rate: int = 24000
    compute_dtype: str = "float32"
    storage_dtype: str = "float32"
    fused_tail: bool = False
    fuse_channels: tuple = (32,)
    # training: the last stage through the fused tail kernels (forward B1, backward B2),
    # fp32, at every batch size: B2's blocks walk the tiles of all B windows, so it has
    # no batch limit (the JAX package's fused_train_max_batch was set on the TPU)
    fused_tail_train: bool = False

    @property
    def torch_compute_dtype(self):
        return _DTYPES[self.compute_dtype]

    @property
    def torch_storage_dtype(self):
        return _DTYPES[self.storage_dtype]

    @property
    def total_upsample(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


class ResBlock1(nn.Module):
    """MRF residual block: per dilation, leaky → conv(d) → leaky → conv(1) → + residual."""

    def __init__(self, channels: int, kernel_size: int, dilations, compute_dtype=None):
        super().__init__()
        self.dilations = tuple(dilations)
        for m, d in enumerate(self.dilations):
            self.add_module(f"WNConv1d_{2 * m}", WNConv1d(
                channels, channels, kernel_size, dilation=d, compute_dtype=compute_dtype))
            self.add_module(f"WNConv1d_{2 * m + 1}", WNConv1d(
                channels, channels, kernel_size, compute_dtype=compute_dtype))

    def convs(self):
        return [getattr(self, f"WNConv1d_{m}") for m in range(2 * len(self.dilations))]

    def forward(self, x):
        convs = self.convs()
        for m in range(len(self.dilations)):
            h = convs[2 * m](F.leaky_relu(x, LRELU_SLOPE))
            h = convs[2 * m + 1](F.leaky_relu(h, LRELU_SLOPE))
            x = x + h
        return x


class ResBlock2(nn.Module):
    """resblock '2' (HiFi-GAN v3): per dilation, leaky → conv(d) → + residual."""

    def __init__(self, channels: int, kernel_size: int, dilations, compute_dtype=None):
        super().__init__()
        self.dilations = tuple(dilations)
        for m, d in enumerate(self.dilations):
            self.add_module(f"WNConv1d_{m}", WNConv1d(
                channels, channels, kernel_size, dilation=d, compute_dtype=compute_dtype))

    def convs(self):
        return [getattr(self, f"WNConv1d_{m}") for m in range(len(self.dilations))]

    def forward(self, x):
        for conv in self.convs():
            x = x + conv(F.leaky_relu(x, LRELU_SLOPE))
        return x


RESBLOCKS = {"1": ResBlock1, "2": ResBlock2}


class Generator(nn.Module):
    """mel (B, frames, num_mels) → waveform (B, frames · prod(upsample_rates))."""

    def __init__(self, config: HifiganConfig = HifiganConfig()):
        super().__init__()
        c = self.config = config
        if c.resblock not in RESBLOCKS:
            raise ValueError(f"resblock {c.resblock!r}: want one of {sorted(RESBLOCKS)}")
        res_cls = RESBLOCKS[c.resblock]
        cd = c.torch_compute_dtype
        self.conv_pre = WNConv1d(c.num_mels, c.upsample_initial_channel, 7, padding=3,
                                 compute_dtype=cd)
        ch = c.upsample_initial_channel
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            self.add_module(f"up_{i}", WNConvTranspose1d(
                ch, ch // 2, k, stride=u, padding=(k - u) // 2, compute_dtype=cd))
            ch //= 2
            for j, (rk, rd) in enumerate(zip(c.resblock_kernel_sizes,
                                             c.resblock_dilation_sizes)):
                self.add_module(f"res_{i}_{j}", res_cls(ch, rk, rd, compute_dtype=cd))
        self.conv_post = WNConv1d(ch, 1, 7, padding=3)
        self._stage_cache = {}

    def stage_weights(self, i: int, compute_dtype=None) -> TailWeights | MrfWeights:
        """Stage i's weights packed for its fused kernel: the whole stage (upsample, MRF,
        and on the last stage conv_post) as `TailWeights` when its upsample has kernel ==
        stride, else its MRF as `MrfWeights`. Packed once and kept until a parameter
        changes (in place or by a move to another device). Raises ValueError, naming the
        stage, where the stage is beyond its kernel's limits."""
        key = (compute_dtype, self.conv_post.v.device,
               tuple(p._version for p in self.parameters()))
        cached = self._stage_cache.get((i, compute_dtype))
        if cached is not None and cached[0] == key:
            return cached[1]
        c = self.config
        last = i == len(c.upsample_rates) - 1
        whole = c.upsample_rates[i] == c.upsample_kernel_sizes[i]
        convs = [conv for j in range(len(c.resblock_kernel_sizes))
                 for conv in getattr(self, f"res_{i}_{j}").convs()]
        spec = dict(kernel_sizes=c.resblock_kernel_sizes, dilations=c.resblock_dilation_sizes,
                    compute_dtype=compute_dtype)
        up = getattr(self, f"up_{i}")
        try:
            with torch.no_grad():
                kernels = [cv.weight() for cv in convs]
                biases = [cv.bias.detach() for cv in convs]
                if not whole:
                    packed = pack_mrf_weights(kernels, biases, **spec)
                elif last:
                    packed = pack_tail_weights(up.weight(), up.bias.detach(), kernels, biases,
                                               self.conv_post.weight(),
                                               self.conv_post.bias.detach(), **spec)
                else:
                    packed = pack_tail_weights(up.weight(), up.bias.detach(), kernels, biases,
                                               **spec)
        except ValueError as e:
            raise ValueError(f"generator stage {i} (C = {convs[0].v.shape[0]}, upsample "
                             f"{c.upsample_rates[i]}/{c.upsample_kernel_sizes[i]}) cannot be "
                             f"fused: {e}") from e
        self._stage_cache[(i, compute_dtype)] = (key, packed)
        return packed

    def tail_weights(self, compute_dtype=None) -> TailWeights:
        """The last stage's weights packed for the fused tail stage (`stage_weights`)."""
        return self.stage_weights(len(self.config.upsample_rates) - 1, compute_dtype)

    def forward(self, mel):
        c = self.config
        x = self.conv_pre(mel)
        for i in range(len(c.upsample_rates)):
            x = getattr(self, f"up_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            acc = None
            for j in range(len(c.resblock_kernel_sizes)):
                h = getattr(self, f"res_{i}_{j}")(x)
                acc = h if acc is None else acc + h
            x = acc / len(c.resblock_kernel_sizes)
        x = F.leaky_relu(x.float(), 0.01)  # final act/conv stay fp32
        audio = torch.tanh(self.conv_post(x))[..., 0]
        # v1 upsampling yields a few samples more than frames·240; trim once here
        return audio[:, : mel.shape[1] * c.total_upsample]


def generate_chunked(apply_fn, cond, upsample: int, chunk: int = 256, halo: int = 32):
    """Generator inference in windows of bounded size: `apply_fn` (cond (B, F, C) →
    audio (B, F·upsample)) runs over windows of chunk + 2·halo frames, and each keeps
    the audio of its `chunk` central frames. The JAX function's window starts and kept
    spans: every window is a slice of the real signal, never zero-padded, and a kept
    frame is either at least `halo` frames from its window's edges or at a window edge
    that is the utterance's own, where `apply_fn`'s zero padding is the full run's.
    `halo` must cover the generator's receptive field in frames (v1: about 25). The
    windows run one after another, so peak memory is one window's. An input of at most
    one window runs whole."""
    B, T, _ = cond.shape
    W = chunk + 2 * halo
    if T <= W:
        return apply_fn(cond)
    out = None
    for k0 in range(0, T, chunk):
        k1 = min(k0 + chunk, T)               # the kept frames tile [0, T)
        a = min(max(k0 - halo, 0), T - W)     # the window lies in [0, T)
        audio = apply_fn(cond[:, a:a + W])
        if out is None:
            out = audio.new_zeros(B, T * upsample)
        out[:, k0 * upsample:k1 * upsample] = audio[:, (k0 - a) * upsample:(k1 - a) * upsample]
    return out


class DiscriminatorP(nn.Module):
    """Period discriminator: reflect-pad (B, T) to a multiple of the period, fold it to
    (B, 1, T/p, p) and run strided 2-D convs (NCHW; the JAX module runs NHWC). Returns
    the scores (B, ·) and the feature maps (NCHW)."""

    def __init__(self, period: int, channels: tuple = (32, 128, 512, 1024),
                 compute_dtype=None):
        super().__init__()
        self.period = period
        cd = dict(compute_dtype=compute_dtype)
        in_ch = 1
        for i, ch in enumerate(channels):
            self.add_module(f"conv_{i}", WNConv2d(in_ch, ch, (5, 1), (3, 1), (2, 0), **cd))
            in_ch = ch
        self.add_module(f"conv_{len(channels)}",
                        WNConv2d(in_ch, in_ch, (5, 1), (1, 1), (2, 0), **cd))
        self.conv_post = WNConv2d(in_ch, 1, (3, 1), (1, 1), (1, 0), **cd)
        self.n_convs = len(channels) + 1

    def forward(self, x):
        p = self.period
        B, T = x.shape
        if T % p:
            x = F.pad(x[:, None], (0, p - T % p), mode="reflect")[:, 0]
        h = x.reshape(B, 1, -1, p)
        fmap = []
        for i in range(self.n_convs):
            h = F.leaky_relu(getattr(self, f"conv_{i}")(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(B, -1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped 1-D convs over (B, T, 1) (NWC), spectral-normalized
    for scale 0, weight-normalized otherwise. Groups are clamped to divide the channels,
    as in the JAX module, so that narrow test widths work."""

    def __init__(self, use_spectral_norm: bool = False, width: int = 128,
                 compute_dtype=None):
        super().__init__()
        w = width
        layers = [
            dict(features=w, kernel_size=15, stride=1, padding=7, groups=1),
            dict(features=w, kernel_size=41, stride=2, padding=20, groups=4),
            dict(features=2 * w, kernel_size=41, stride=2, padding=20, groups=16),
            dict(features=4 * w, kernel_size=41, stride=4, padding=20, groups=16),
            dict(features=8 * w, kernel_size=41, stride=4, padding=20, groups=16),
            dict(features=8 * w, kernel_size=41, stride=1, padding=20, groups=16),
            dict(features=8 * w, kernel_size=5, stride=1, padding=2, groups=1),
        ]
        conv = SNConv1d if use_spectral_norm else WNConv1d
        self.spectral = use_spectral_norm
        in_ch = 1
        for i, kw in enumerate(layers):
            kw["groups"] = math.gcd(kw["groups"], math.gcd(in_ch, kw["features"]))
            self.add_module(f"conv_{i}", conv(in_ch, **kw, compute_dtype=compute_dtype))
            in_ch = kw["features"]
        self.conv_post = conv(in_ch, 1, kernel_size=3, padding=1, compute_dtype=compute_dtype)
        self.n_convs = len(layers)

    def forward(self, x, update_stats: bool = False):
        kw = {"update_stats": update_stats} if self.spectral else {}
        h = x[:, :, None]
        fmap = []
        for i in range(self.n_convs):
            h = F.leaky_relu(getattr(self, f"conv_{i}")(h, **kw), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h, **kw)
        fmap.append(h)
        return h.reshape(h.shape[0], -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: tuple = (2, 3, 5, 7, 11),
                 channels: tuple = (32, 128, 512, 1024), compute_dtype=None):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"p{p}", DiscriminatorP(p, channels, compute_dtype))

    def forward(self, y, y_hat):
        rs, gs, fmap_rs, fmap_gs = [], [], [], []
        for p in self.periods:
            d = getattr(self, f"p{p}")
            r, fr = d(y)
            g, fg = d(y_hat)
            rs.append(r); gs.append(g); fmap_rs.append(fr); fmap_gs.append(fg)
        return rs, gs, fmap_rs, fmap_gs


def avgpool42(x):
    """AvgPool1d(4, stride=2, padding=2) over (B, T), the padding counted."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=2, count_include_pad=True)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, width: int = 128, compute_dtype=None):
        super().__init__()
        for i in range(3):
            self.add_module(f"s{i}", DiscriminatorS(use_spectral_norm=(i == 0), width=width,
                                                    compute_dtype=compute_dtype))

    def forward(self, y, y_hat, update_stats: bool = False):
        """Scale 0 scores y with `update_stats` (the spectral u may be written) and
        then y_hat without, reading the u that the first call left: the order of the
        JAX module inside one `apply`."""
        rs, gs, fmap_rs, fmap_gs = [], [], [], []
        for i in range(3):
            d = getattr(self, f"s{i}")
            r, fr = d(y, update_stats=update_stats) if i == 0 else d(y)
            g, fg = d(y_hat)
            rs.append(r); gs.append(g); fmap_rs.append(fr); fmap_gs.append(fg)
            y = avgpool42(y)
            y_hat = avgpool42(y_hat)
        return rs, gs, fmap_rs, fmap_gs


def feature_loss(fmap_r, fmap_g):
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for r, g in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(r - g))
    return loss * 2.0


def discriminator_loss(disc_real, disc_generated):
    loss = 0.0
    for dr, dg in zip(disc_real, disc_generated):
        loss = loss + torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
    return loss


def generator_loss(disc_generated):
    loss = 0.0
    for dg in disc_generated:
        loss = loss + torch.mean((1.0 - dg) ** 2)
    return loss
