"""Convolutions, counterpart of `ttscube_tpu/ops/conv.py`.

Public 1-D functions and modules take and return NWC tensors (B, T, C), as the JAX
package does; inside they transpose to PyTorch's NCW for `F.conv1d`. The one 2-D
module, `WNConv2d`, runs PyTorch's NCHW (the JAX module NHWC). Parameters are
stored in PyTorch's layouts (Conv1d (out, in, k), ConvTranspose1d (in, out, k));
`ttscube_tpu_torch.convert` maps them to and from the JAX trees.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

_GAINS = {"linear": 1.0, "relu": math.sqrt(2.0),
          "leaky_relu": math.sqrt(2.0 / (1 + 0.01 ** 2)), "tanh": 5.0 / 3,
          "sigmoid": 1.0}


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """NWC conv: x (B, T, C_in), weight (C_out, C_in/groups, k) → (B, T', C_out)."""
    y = F.conv1d(x.transpose(1, 2), weight, bias, stride, padding, dilation, groups)
    return y.transpose(1, 2)


def conv_transpose1d(x, weight, bias=None, stride=1, padding=0):
    """NWC transposed conv, PyTorch semantics: weight (C_in, C_out, k),
    out_len = (T−1)·stride − 2·padding + k (the JAX `_conv_transpose`)."""
    y = F.conv_transpose1d(x.transpose(1, 2), weight, bias, stride, padding)
    return y.transpose(1, 2)


def wn_weight(v, g, dim: int = 0):
    """Weight norm g·v/‖v‖ with the norm over every axis but `dim`, and 1e-12 under
    the square root as the JAX `_wn_kernel` has it (so not `nn.utils.weight_norm`)."""
    red = [i for i in range(v.dim()) if i != dim]
    norm = torch.sqrt(torch.sum(v * v, dim=red, keepdim=True) + 1e-12)
    shape = [1] * v.dim()
    shape[dim] = -1
    return v / norm * g.reshape(shape)


def _cast(x, w, compute_dtype):
    if compute_dtype is None:
        return x, w
    return x.to(compute_dtype), w.to(compute_dtype)


class _RoundedConv(torch.autograd.Function):
    """`conv(x, w, **kw)` of bf16 operands on the CPU as XLA computes it: each product
    summed in fp32 and the result rounded once to bf16. The backward takes the bf16
    cotangent, computes both grads in fp32 from the same operands and rounds each once
    to bf16, as JAX's transposed convs of an `astype` VJP do. (PyTorch's CPU bf16 conv
    without oneDNN rounds partial sums: up to 4 bf16 ulps off.)"""

    @staticmethod
    def forward(ctx, x, w, conv, kw):
        ctx.conv, ctx.kw = conv, kw
        ctx.save_for_backward(x, w)
        return conv(x.float(), w.float(), **kw).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
        with torch.enable_grad():
            out = ctx.conv(xf, wf, **ctx.kw)
        dx, dw = torch.autograd.grad(out, (xf, wf), dy.float())
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def _mp_conv(conv, x, w, compute_dtype, **kw):
    """One conv in the JAX package's training precision (`_mp_cast`): operands cast to
    `compute_dtype`, the conv's result in that dtype and then fp32 (the caller adds the
    bias in fp32). Card tensors run PyTorch's conv in bf16 (cuDNN sums in fp32 and
    rounds once); CPU tensors `_RoundedConv`, which rounds at the same places."""
    xc, wc = _cast(x, w, compute_dtype)
    if compute_dtype is None:
        return conv(xc, wc, **kw)
    if xc.device.type == "cpu":
        return _RoundedConv.apply(xc, wc, conv, kw).float()
    return conv(xc, wc, **kw).float()


class Conv1d(nn.Module):
    """Plain Conv1d with xavier-uniform init scaled by a gain (JAX `Conv1d`)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 stride: int = 1, padding: int | None = None, dilation: int = 1,
                 groups: int = 1, use_bias: bool = True, w_init_gain: str = "linear"):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = padding if padding is not None else dilation * (kernel_size - 1) // 2
        self.gain = _GAINS[w_init_gain]
        self.kernel = nn.Parameter(torch.zeros(features, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def init_weights(self, gen: torch.Generator):
        fout, fin, k = self.kernel.shape
        a = self.gain * math.sqrt(6.0 / (k * fin + k * fout))
        with torch.no_grad():
            self.kernel.uniform_(-a, a, generator=gen)

    def forward(self, x):
        return conv1d(x, self.kernel, self.bias, self.stride, self.padding,
                      self.dilation, self.groups)


class WNConv1d(nn.Module):
    """Weight-normalized Conv1d (per-output-channel norm). `compute_dtype` casts the
    operands (activation and normalized kernel) for the conv; the result is fp32 and
    the bias is added in fp32, as the JAX module does."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 stride: int = 1, padding: int | None = None, dilation: int = 1,
                 groups: int = 1, use_bias: bool = True, compute_dtype=None):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.kernel_size = kernel_size
        self.padding = padding if padding is not None else dilation * (kernel_size - 1) // 2
        self.compute_dtype = compute_dtype
        self.v = nn.Parameter(torch.zeros(features, in_channels // groups, kernel_size))
        self.g = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def init_weights(self, gen: torch.Generator):
        # v ~ N(0, 0.01²) as in JAX, but g = 1 (unit-norm kernel rows) where JAX sets
        # g = ‖v‖: random weights then keep the activations' scale and give audible
        # output instead of near-silence
        with torch.no_grad():
            self.v.normal_(0.0, 0.01, generator=gen)
            self.g.fill_(1.0)

    def weight(self):
        return wn_weight(self.v, self.g, 0)

    def forward(self, x):
        y = _mp_conv(conv1d, x, self.weight(), self.compute_dtype, stride=self.stride,
                     padding=self.padding, dilation=self.dilation, groups=self.groups)
        return y + self.bias if self.bias is not None else y


class WNConvTranspose1d(nn.Module):
    """Weight-normalized ConvTranspose1d; `g` is per INPUT channel (the norm of PyTorch's
    (in, out, k) weight over dims 1, 2), as in the JAX module."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int,
                 padding: int = 0, use_bias: bool = True, compute_dtype=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.compute_dtype = compute_dtype
        self.v = nn.Parameter(torch.zeros(in_channels, features, kernel_size))
        self.g = nn.Parameter(torch.ones(in_channels))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def init_weights(self, gen: torch.Generator):
        with torch.no_grad():  # as WNConv1d.init_weights
            self.v.normal_(0.0, 0.01, generator=gen)
            self.g.fill_(1.0)

    def weight(self):
        return wn_weight(self.v, self.g, 0)

    def forward(self, x):
        y = _mp_conv(conv_transpose1d, x, self.weight(), self.compute_dtype,
                     stride=self.stride, padding=self.padding)
        return y + self.bias if self.bias is not None else y


class WNConv2d(nn.Module):
    """Weight-normalized Conv2d (per-output-channel norm), counterpart of the JAX
    `WNConv2d` (the period discriminators'). The JAX module runs NHWC with an HWIO
    kernel (kh, kw, in, out); the port runs NCHW with PyTorch's (out, in, kh, kw), and
    `ttscube_tpu_torch.convert` transposes between them. `compute_dtype` as in
    `WNConv1d`; the weight norm stays fp32."""

    def __init__(self, in_channels: int, features: int, kernel_size: tuple,
                 strides: tuple = (1, 1), padding: tuple = (0, 0), use_bias: bool = True,
                 compute_dtype=None):
        super().__init__()
        self.strides, self.padding = tuple(strides), tuple(padding)
        self.compute_dtype = compute_dtype
        self.v = nn.Parameter(torch.zeros(features, in_channels, *kernel_size))
        self.g = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def init_weights(self, gen: torch.Generator):
        with torch.no_grad():  # as WNConv1d.init_weights
            self.v.normal_(0.0, 0.01, generator=gen)
            self.g.fill_(1.0)

    def weight(self):
        return wn_weight(self.v, self.g, 0)

    def forward(self, x):
        """x (B, C_in, H, W) → (B, features, H', W')."""
        if self.compute_dtype is None:
            return F.conv2d(x, self.weight(), self.bias, self.strides, self.padding)
        y = _mp_conv(F.conv2d, x, self.weight(), self.compute_dtype, stride=self.strides,
                     padding=self.padding)
        return y + self.bias[:, None, None] if self.bias is not None else y


class SNConv1d(nn.Module):
    """Spectral-normalized Conv1d, counterpart of the JAX `SNConv1d`: one power
    iteration in every call, from the stored `u`, with σ = u'ᵀ W v' taken through W
    only (u' and v' held constant); the new u' is stored only under
    `update_stats=True`. Not `torch.nn.utils.spectral_norm`, which iterates in training
    mode only and then always stores. `u` is a buffer (the JAX "spectral" collection);
    `ttscube_tpu_torch.convert` carries it across, never re-seeded. `compute_dtype` as
    in `WNConv1d`: the power iteration and σ stay fp32, only w / σ is cast."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 stride: int = 1, padding: int | None = None, groups: int = 1,
                 use_bias: bool = True, compute_dtype=None):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.compute_dtype = compute_dtype
        self.padding = padding if padding is not None else (kernel_size - 1) // 2
        self.kernel = nn.Parameter(torch.zeros(features, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.register_buffer("u", torch.zeros(features))

    def init_weights(self, gen: torch.Generator):
        # JAX: kernel ~ U(±1/√(fan-in)), u ~ N(0, 1) (from its own key, not this one)
        fout, fin, k = self.kernel.shape
        scale = 1.0 / math.sqrt(fin * k)
        with torch.no_grad():
            self.kernel.uniform_(-scale, scale, generator=gen)
            self.u.normal_(0.0, 1.0, generator=gen)

    def weight(self, update_stats: bool = False):
        wmat = self.kernel.reshape(self.kernel.shape[0], -1)
        with torch.no_grad():
            v = wmat.t() @ self.u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u_new = wmat @ v
            u_new = u_new / (torch.linalg.vector_norm(u_new) + 1e-12)
            if update_stats:
                self.u.copy_(u_new)
        sigma = torch.dot(u_new, wmat @ v)
        return self.kernel / sigma

    def forward(self, x, update_stats: bool = False):
        """x (B, T, C_in) → (B, T', features)."""
        w = self.weight(update_stats)
        if self.compute_dtype is None:
            return conv1d(x, w, self.bias, self.stride, self.padding, 1, self.groups)
        y = _mp_conv(conv1d, x, w, self.compute_dtype, stride=self.stride,
                     padding=self.padding, groups=self.groups)
        return y + self.bias if self.bias is not None else y
