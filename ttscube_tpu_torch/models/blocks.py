"""Shared blocks, counterpart of `ttscube_tpu/models/blocks.py`: the additive attention
of the M2M phonemizer and the word G2P, and Textcoder's PreNet and PostNet. (ResNet, the
upsample nets and Mel2Style are not ported.)"""

from __future__ import annotations

import torch
import torch.nn as nn

from ttscube_tpu_torch.ops.conv import Conv1d
from ttscube_tpu_torch.ops.linear import BatchNorm, Dense


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


class PreNet(nn.Module):
    """2 × (bias-free Linear, ReLU, dropout): the dropout is always on, at inference too
    (Tacotron 2's trick, kept by the reference), p 0.5, kept units scaled by 1/0.5.

    `masks` are the keep masks, one bool tensor per layer shaped as that layer's output;
    without them they are drawn from `generator` (`draw_masks`)."""


    def __init__(self, in_features: int, sizes: tuple = (256, 256)):
        super().__init__()
        self.sizes = tuple(sizes)
        for i, s in enumerate(self.sizes):
            self.add_module(f"fc_{i}", Dense(in_features if i == 0 else self.sizes[i - 1],
                                             s, bias=False))

    def draw_masks(self, lead: tuple, generator: torch.Generator, device) -> list:
        """Keep masks for inputs of leading shape `lead` (e.g. (B, T)), drawn on the
        generator's device and moved to `device`: a CPU generator gives the same masks
        to a run on the card and one on the CPU."""
        return [(torch.rand((*lead, s), generator=generator, device=generator.device)
                 < 0.5).to(device) for s in self.sizes]

    def forward(self, x, masks=None, generator=None):
        if masks is None:
            masks = self.draw_masks(tuple(x.shape[:-1]), generator, x.device)
        for i, keep in enumerate(masks):
            x = torch.relu(getattr(self, f"fc_{i}")(x))
            x = torch.where(keep, x / 0.5, torch.zeros_like(x))
        return x


class PostNet(nn.Module):
    """5 × (conv k 5, BatchNorm), tanh after all but the last: the residual refiner of
    Textcoder's mel. The BatchNorm is flax's (`ops/linear.BatchNorm`): batch statistics
    with `train=True` (which updates the running averages), the running averages
    otherwise."""

    def __init__(self, n_mel_channels: int = 80, embedding_dim: int = 512,
                 kernel_size: int = 5, n_convolutions: int = 5):
        super().__init__()
        self.n = n_convolutions
        for i in range(n_convolutions):
            last = i == n_convolutions - 1
            self.add_module(f"conv_{i}", Conv1d(
                n_mel_channels if i == 0 else embedding_dim,
                n_mel_channels if last else embedding_dim, kernel_size,
                w_init_gain="linear" if last else "tanh"))
            self.add_module(f"bn_{i}", BatchNorm(n_mel_channels if last else embedding_dim))

    def forward(self, x, train: bool = False):
        for i in range(self.n):
            x = getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(x), train)
            if i < self.n - 1:
                x = torch.tanh(x)
        return x
