"""Shared blocks, counterpart of `ttscube_tpu/models/blocks.py`: the additive attention
of the M2M phonemizer and the word G2P. (PreNet, PostNet, ResNet, the upsample nets and
Mel2Style wait for the textcoder and the vocoder.)"""

from __future__ import annotations

import torch
import torch.nn as nn

from ttscube_tpu_torch.ops.conv import Conv1d


class Attention(nn.Module):
    """Conv-projected additive attention (JAX `Attention`): a `kernel_size`-tap conv over
    [hidden broadcast over S, encoder outputs], tanh, a dot with `v`, then the softmax
    over S. `mask` (B, S) bool marks the positions that may be attended (the M2M
    phonemizer's word span); the others score −1e9. Returns (attention (B, S), the
    weighted sum of the encoder outputs (B, E)).

    The JAX module's dropout runs only with `deterministic=False`, which no caller of
    either package passes; the port has no dropout."""

    def __init__(self, hidden_size: int, encoder_size: int, att_proj_size: int = 100,
                 kernel_size: int = 1):
        super().__init__()
        self.attn = Conv1d(hidden_size + encoder_size, att_proj_size, kernel_size,
                           w_init_gain="tanh")
        self.v = nn.Parameter(torch.zeros(att_proj_size))

    def init_weights(self, gen: torch.Generator):
        # flax's uniform(1.0): U[0, 1)
        with torch.no_grad():
            self.v.uniform_(0.0, 1.0, generator=gen)

    def forward(self, hidden, encoder_outputs, mask=None):
        B, S, _ = encoder_outputs.shape
        h = hidden[:, None, :].expand(B, S, hidden.shape[-1])
        energy = torch.tanh(self.attn(torch.cat([h, encoder_outputs], dim=-1)))
        scores = energy @ self.v
        if mask is not None:
            scores = scores.masked_fill(~mask, -1e9)
        attention = torch.softmax(scores, dim=-1)
        weighted = torch.einsum("bs,bse->be", attention, encoder_outputs)
        return attention, weighted
