"""Shared blocks, counterpart of `ttscube_tpu/models/blocks.py`: the additive attention
of the M2M phonemizer and the word G2P, Textcoder's PreNet and PostNet, and the blocks
that no live path of either package instantiates but that belong to the inventory: the
gated `ResNet`, the upsample nets `UpsampleNet` and `UpsampleNet2`, and the GST
attention `Mel2Style`. The weights keep the JAX tree's names (`conv_i`, `up_i`,
`v_i`/`g_i`/`bias_i`, `ref`, `gst`), so `ttscube_tpu_torch.convert` carries them across."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ttscube_tpu_torch.ops.conv import Conv1d, WNConvTranspose1d
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


class ResNet(nn.Module):
    """Gated conv stack: each of `n_layers` convs gives `filter_size` channels, split
    into sigmoid(first half) × tanh(second half), plus a residual from the second layer
    on. The first conv reads the input's `in_channels`, every later one the
    `filter_size // 2` of the layer before; the output is `filter_size // 2` wide."""

    def __init__(self, in_channels: int, filter_size: int = 512, n_layers: int = 8,
                 kernel_size: int = 3):
        super().__init__()
        self.half, self.n_layers = filter_size // 2, n_layers
        for i in range(n_layers):
            self.add_module(f"conv_{i}", Conv1d(in_channels if i == 0 else self.half,
                                                filter_size, kernel_size))

    def forward(self, x):
        res = None
        for i in range(self.n_layers):
            out = getattr(self, f"conv_{i}")(x)
            x = torch.sigmoid(out[..., :self.half]) * torch.tanh(out[..., self.half:])
            if res is not None:
                x = x + res
            res = x
        return x


class UpsampleNet(nn.Module):
    """Three tanh(conv) layers, then for each scale s tanh(weight-normalized transposed
    conv with kernel 2s, stride s, padding s // 2): (B, T, C_in) → (B, T·∏s, out)."""

    def __init__(self, in_channels: int, upsample_scales: tuple = (2, 2, 4),
                 out_channels: int = 80, kernel_size: int = 3):
        super().__init__()
        self.scales = tuple(upsample_scales)
        for i in range(3):
            self.add_module(f"conv_{i}", Conv1d(in_channels if i == 0 else out_channels,
                                                out_channels, kernel_size))
        for i, s in enumerate(self.scales):
            self.add_module(f"up_{i}", WNConvTranspose1d(out_channels, out_channels, 2 * s,
                                                         stride=s, padding=s // 2))

    def forward(self, c):
        for i in range(3):
            c = torch.tanh(getattr(self, f"conv_{i}")(c))
        for i in range(len(self.scales)):
            c = torch.tanh(getattr(self, f"up_{i}")(c))
        return c


class UpsampleNet2(nn.Module):
    """Time upsampler over (C, T) as a one-channel image: for each scale s a
    weight-normalized 2-D transposed conv with a (3, 2s) kernel, stride (1, s) and
    padding (1, s // 2), then leaky_relu(0.4). (B, T, C) → (B, T·∏s, C).

    The weight norm is one scalar over the whole kernel, v / sqrt(Σ v² + 1e-12) · g, and
    the bias one scalar. The JAX module convolves the stride-dilated input with the kernel
    flipped in both axes and padding k − 1 − p; that is `F.conv_transpose2d` with the
    unflipped kernel and padding p, which the port runs."""

    def __init__(self, upsample_scales: tuple = (2, 2, 2, 2)):
        super().__init__()
        self.scales = tuple(upsample_scales)
        for i, s in enumerate(self.scales):
            self.register_parameter(f"v_{i}", nn.Parameter(torch.zeros(3, 2 * s)))
            self.register_parameter(f"g_{i}", nn.Parameter(torch.ones(1)))
            self.register_parameter(f"bias_{i}", nn.Parameter(torch.zeros(1)))

    def init_weights(self, gen: torch.Generator):
        # as JAX: v He-normal over its 3 rows (fan-in), g = ‖v‖, zero bias
        with torch.no_grad():
            for i in range(len(self.scales)):
                v = getattr(self, f"v_{i}")
                v.normal_(0.0, math.sqrt(2.0 / v.shape[0]), generator=gen)
                getattr(self, f"g_{i}").fill_(float(v.square().sum().sqrt()))
                getattr(self, f"bias_{i}").zero_()

    def forward(self, c):
        x = c.transpose(1, 2)[:, None]  # (B, 1, C, T)
        for i, s in enumerate(self.scales):
            v = getattr(self, f"v_{i}")
            w = v / torch.sqrt(torch.sum(v * v) + 1e-12) * getattr(self, f"g_{i}")[0]
            x = F.conv_transpose2d(x, w[None, None], getattr(self, f"bias_{i}"),
                                   stride=(1, s), padding=(1, s // 2))
            x = F.leaky_relu(x, 0.4)
        return x[:, 0].transpose(1, 2)


class Mel2Style(nn.Module):
    """GST attention over learned style tokens: the mel's time mean → tanh(Dense) →
    softmax(h · gstᵀ / √gst_dim). Returns (attention (B, num_gst), attention @ gst
    (B, gst_dim))."""

    def __init__(self, num_mgc: int = 80, gst_dim: int = 100, num_gst: int = 8):
        super().__init__()
        self.gst_dim = gst_dim
        self.gst = nn.Parameter(torch.zeros(num_gst, gst_dim))
        self.ref = Dense(num_mgc, gst_dim)

    def init_weights(self, gen: torch.Generator):
        with torch.no_grad():  # JAX: normal(0.5)
            self.gst.normal_(0.0, 0.5, generator=gen)

    def forward(self, mel):
        h = torch.tanh(self.ref(mel.mean(dim=1)))
        att = torch.softmax(h @ self.gst.t() / math.sqrt(float(self.gst_dim)), dim=-1)
        return att, att @ self.gst
