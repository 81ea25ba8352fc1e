"""HiFi-GAN v1 generator, counterpart of `ttscube_tpu/models/hifigan.py`
(`HifiganConfig`, `ResBlock1`, `Generator`). The discriminators wait for the training
slice. `Generator.forward` is the plain module path (the JAX `Generator.apply`); the
serving path with the fused tail stage is `models/hifigan_fused.generator_apply_fused`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ttscube_tpu_torch.ops.conv import WNConv1d, WNConvTranspose1d
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


class Generator(nn.Module):
    """mel (B, frames, num_mels) → waveform (B, frames · prod(upsample_rates))."""

    def __init__(self, config: HifiganConfig = HifiganConfig()):
        super().__init__()
        c = self.config = config
        if c.resblock != "1":
            raise NotImplementedError("only resblock '1' (HiFi-GAN v1) is ported")
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
                self.add_module(f"res_{i}_{j}", ResBlock1(ch, rk, rd, compute_dtype=cd))
        self.conv_post = WNConv1d(ch, 1, 7, padding=3)
        self._tail_cache = None

    def tail_weights(self, compute_dtype=None) -> TailWeights:
        """The last stage's weights packed for the fused tail stage. Packed once and
        kept until a parameter changes (in place or by a move to another device)."""
        key = (compute_dtype, self.conv_post.v.device,
               tuple(p._version for p in self.parameters()))
        if self._tail_cache is None or self._tail_cache[0] != key:
            c = self.config
            i = len(c.upsample_rates) - 1
            convs = [conv for j in range(len(c.resblock_kernel_sizes))
                     for conv in getattr(self, f"res_{i}_{j}").convs()]
            up = getattr(self, f"up_{i}")
            with torch.no_grad():
                packed = pack_tail_weights(
                    up.weight(), up.bias, [cv.weight() for cv in convs],
                    [cv.bias for cv in convs], self.conv_post.weight(), self.conv_post.bias,
                    kernel_sizes=c.resblock_kernel_sizes, dilations=c.resblock_dilation_sizes,
                    compute_dtype=compute_dtype)
            self._tail_cache = (key, packed)
        return self._tail_cache[1]

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
