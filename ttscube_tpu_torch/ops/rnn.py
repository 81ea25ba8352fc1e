"""LSTM, counterpart of `ttscube_tpu/ops/rnn.py::LSTM`.

`nn.LSTM` (cuDNN on the card) over batch-first (B, T, D) input. Its gates are in the
same i, f, g, o order as the JAX scan. The JAX module stores one bias per layer and
direction (b_ih + b_hh); the port loads it into `bias_ih` and keeps `bias_hh` at zero
(`ttscube_tpu_torch.convert`), taking no grads: a trained second bias would give the
sum two optimizer updates per step where JAX gives it one.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


class LSTM(nn.LSTM):
    """Multi-layer, optionally bidirectional LSTM: (B, T, D) → ((B, T, H·dirs), state)."""

    def __init__(self, input_size: int, features: int, num_layers: int = 1,
                 bidirectional: bool = False):
        super().__init__(input_size, features, num_layers=num_layers,
                         bidirectional=bidirectional, batch_first=True)
        for name, p in self.named_parameters():
            if name.startswith("bias_hh"):
                p.requires_grad_(False)

    def init_weights(self, gen: torch.Generator):
        # JAX init: every weight and the single bias ~ U(−1/√H, 1/√H)
        scale = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.startswith("bias_hh"):
                    p.zero_()
                else:
                    p.uniform_(-scale, scale, generator=gen)
