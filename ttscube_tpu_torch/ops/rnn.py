"""LSTM and GRU, counterparts of `ttscube_tpu/ops/rnn.py`.

`nn.LSTM` (cuDNN on the card) over batch-first (B, T, D) input. Its gates are in the
same i, f, g, o order as the JAX scan. The JAX module stores one bias per layer and
direction (b_ih + b_hh); the port loads it into `bias_ih` and keeps `bias_hh` at zero
(`ttscube_tpu_torch.convert`), taking no grads: a trained second bias would give the
sum two optimizer updates per step where JAX gives it one.

`nn.GRU` and `nn.GRUCell` compute the JAX GRU's formula in its gate order (r, z, n, the
reset gate multiplying h @ W_hn + b_hn), and the JAX GRU stores two biases, bi and bh:
both map onto bias_ih and bias_hh and both are trained, unlike the LSTM's.
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


class LSTMCell(nn.LSTMCell):
    """One LSTM step for the decoders, counterpart of `ttscube_tpu/ops/rnn.py::LSTMCell`:
    `cell(x, (h, c)) -> (h, c)`. The JAX cell's wi (D, 4H), wh (H, 4H) and single bias b
    map onto weight_ih, weight_hh and bias_ih as for `LSTM`, with bias_hh kept at zero
    and out of training."""

    def __init__(self, input_size: int, features: int):
        super().__init__(input_size, features)
        self.bias_hh.requires_grad_(False)

    init_weights = LSTM.init_weights

    @staticmethod
    def initial_state(batch: int, features: int, device=None, dtype=torch.float32):
        """The zero state (h, c), each (batch, features)."""
        return (torch.zeros(batch, features, device=device, dtype=dtype),
                torch.zeros(batch, features, device=device, dtype=dtype))


class GRU(nn.GRU):
    """Multi-layer unidirectional GRU: (B, T, D) → ((B, T, H), h_n (layers, B, H)).
    The JAX module's wi_l{n}/wh_l{n} (D, 3H) map onto weight_ih_l{n}/weight_hh_l{n} (3H,
    D), bi_l{n}/bh_l{n} onto bias_ih_l{n}/bias_hh_l{n}."""

    def __init__(self, input_size: int, features: int, num_layers: int = 1):
        super().__init__(input_size, features, num_layers=num_layers, batch_first=True)

    def init_weights(self, gen: torch.Generator):
        # JAX init: every weight and both biases ~ U(−1/√H, 1/√H)
        scale = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-scale, scale, generator=gen)

    def layer_weights(self, layer: int) -> tuple:
        """(weight_ih, weight_hh, bias_ih, bias_hh) of one layer, for stepping it with
        `torch.gru_cell` (the WaveRNN sampler)."""
        return tuple(getattr(self, f"{n}_l{layer}") for n in
                     ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))


class GRUCell(nn.GRUCell):
    """One GRU step, counterpart of `ttscube_tpu/ops/rnn.py::GRUCell`: `cell(x, h) -> h`.
    The JAX cell's wi, wh, bi and bh map as `GRU`'s do."""

    init_weights = GRU.init_weights
