"""Dense layer, embedding table and normalizations, the port's stand-ins for flax
`nn.Dense`, `nn.Embed`, `nn.LayerNorm` and `nn.BatchNorm` (the JAX package takes them
from flax)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn


class Embed(nn.Embedding):
    """Plain embedding table (flax `nn.Embed`)."""

    def init_weights(self, gen: torch.Generator):
        # flax's default: normal with stddev 1/√features
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(self.embedding_dim), generator=gen)


class Dense(nn.Linear):
    """flax `nn.Dense` as the JAX models configure it: xavier-uniform kernel, zero bias."""

    def init_weights(self, gen: torch.Generator):
        fout, fin = self.weight.shape
        a = math.sqrt(6.0 / (fin + fout))
        with torch.no_grad():
            self.weight.uniform_(-a, a, generator=gen)
            if self.bias is not None:
                self.bias.zero_()


class LayerNorm(nn.LayerNorm):
    """flax `nn.LayerNorm` over the last axis: scale (`weight`) and bias. flax takes the
    variance as E[x²] − E[x]², PyTorch in two passes: the two differ by a few fp32
    roundings (tests/test_torch_lm.py)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__(features, eps=eps)

    def init_weights(self, gen: torch.Generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over the last axis, with flax's statistics: in training the
    batch mean and the biased variance max(0, E[x²] − E[x]²) over every other axis
    (padding included), and the running averages ra ← 0.99·ra + 0.01·batch, the running
    variance biased too (PyTorch's `BatchNorm1d` keeps the unbiased one). With
    `train=False` (flax's `use_running_average`) the running averages normalize and
    nothing is written. `weight`/`bias` are flax's scale/bias, `running_mean`/
    `running_var` its batch_stats mean/var."""

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def init_weights(self, gen: torch.Generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x, train: bool = False):
        if train:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.running_var.mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
