"""Dense layer and embedding table, the port's stand-ins for flax `nn.Dense` and
`nn.Embed` (the JAX package takes both from flax)."""

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
