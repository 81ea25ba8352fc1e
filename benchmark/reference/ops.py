"""Plain PyTorch building blocks of the reference: the precision of every matmul and
conv operand, dense layers, convolutions over (B, T, C), weight and spectral
normalisation, and the LSTM as an explicit loop over time.

Nothing here imports the program under test. Every matmul and conv passes its operands
through a `Precision`: fp32 as they are (the reference), or rounded to TF32, to bf16 or
to fp8 (e4m3 with a per-tensor scale), the lower precisions of the controls."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


class Precision:
    """Rounds a matmul's or conv's operands: `None` keeps fp32, "tf32" rounds to
    TF32's 10 stored mantissa bits (to nearest, ties to even), "bf16" to bfloat16,
    "fp8" to float8 e4m3 after scaling the tensor's largest magnitude to 448. The
    arithmetic itself stays fp32 (with TF32 off); gradients pass the rounding
    unchanged."""

    def __init__(self, kind: str | None = None):
        if kind not in (None, "tf32", "bf16", "fp8"):
            raise ValueError(f"precision {kind!r}")
        self.kind = kind

    def __call__(self, x):
        if self.kind is None:
            return x
        if self.kind == "tf32":
            i = x.detach().float().contiguous().view(torch.int32)
            r = ((i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)
            return x + (r - x).detach()
        if self.kind == "bf16":
            return x.to(torch.bfloat16).float()
        scale = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale


@contextlib.contextmanager
def no_tf32():
    """fp32 matmuls and convs in full fp32 on a card inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def dense(q, x, w, b):
    """x (..., in) @ w (out, in)ᵀ + b."""
    return F.linear(q(x), q(w), b)


def conv1d(q, x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    """x (B, T, C_in), w (C_out, C_in/groups, k) → (B, T', C_out)."""
    y = F.conv1d(q(x).transpose(1, 2), q(w), b, stride, padding, dilation, groups)
    return y.transpose(1, 2)


def conv_transpose1d(q, x, w, b, stride, padding):
    """x (B, T, C_in), w (C_in, C_out, k) → (B, (T − 1)·stride − 2·padding + k, C_out)."""
    return F.conv_transpose1d(q(x).transpose(1, 2), q(w), b, stride, padding).transpose(1, 2)


def weight_norm(v, g):
    """g · v / ‖v‖, the norm over every axis but the first, 1e-12 under the root."""
    dims = tuple(range(1, v.dim()))
    norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + 1e-12)
    return v / norm * g.reshape((-1,) + (1,) * (v.dim() - 1))


def spectral_norm(kernel, u, update: bool):
    """kernel / σ, σ from one power iteration from u (u' and v' held constant); returns
    (the normalised kernel, u'); the caller stores u' where `update`."""
    wmat = kernel.reshape(kernel.shape[0], -1)
    with torch.no_grad():
        v = wmat.t() @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u_new = wmat @ v
        u_new = u_new / (torch.linalg.vector_norm(u_new) + 1e-12)
    sigma = torch.dot(u_new, wmat @ v)
    return kernel / sigma, (u_new if update else u)


def masked_embed(table, ids):
    """Rows of `table`, zero where the id is 0."""
    return table[ids] * (ids != 0)[..., None]


def lstm(q, x, W, name: str, layers: int, bidirectional: bool = True):
    """A stacked LSTM over x (B, T, D), gates in the order i, f, g, o, weights named as
    PyTorch names them (`{name}.weight_ih_l0`, `…_reverse`); both directions of a layer
    step together, the reverse one over the whole padded sequence from its end.
    Returns (B, T, H·directions)."""
    suffixes = ("", "_reverse") if bidirectional else ("",)
    h = x
    for layer in range(layers):
        keys = [f"{name}.{{}}_l{layer}{s}" for s in suffixes]
        wih = torch.stack([W[k.format("weight_ih")] for k in keys])
        whh = q(torch.stack([W[k.format("weight_hh")] for k in keys])).transpose(1, 2)
        bias = torch.stack([W[k.format("bias_ih")] + W[k.format("bias_hh")] for k in keys])
        xs = torch.stack([h, h.flip(1)][: len(keys)])
        xp = torch.matmul(q(xs), q(wih).transpose(1, 2)[:, None]) + bias[:, None, None]
        D, B, T, _ = xp.shape
        H = whh.shape[1]
        hs = xp.new_zeros(D, B, H)
        cs = xp.new_zeros(D, B, H)
        outs = []
        for t in range(T):
            gates = xp[:, :, t] + torch.bmm(q(hs), whh)
            i, f, g, o = gates.chunk(4, dim=-1)
            cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(g)
            hs = torch.sigmoid(o) * torch.tanh(cs)
            outs.append(hs)
        out = torch.stack(outs, dim=2)
        h = torch.cat([out[0], out[1].flip(1)], dim=-1) if bidirectional else out[0]
    return h
