"""μ-law and linear 8-bit codecs on tensors, counterpart of `ttscube_tpu/dsp/mulaw.py`.

The arithmetic is the JAX functions', in fp32 and in the same order: the `+ 0.5` before
the truncation toward zero, then the clip. XLA's fp32 log1p and PyTorch's differ by one
ulp on some inputs (~8 % of uniform ones), so a μ-law code can differ where x_mu lands
within an ulp of a truncation boundary: one input in ~2.3 million of a seeded sweep
(tests/test_torch_wavernn.py). The linear codec has no transcendental and is exact."""

from __future__ import annotations

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def mulaw_encode(x, quantization_channels: int = 256) -> torch.Tensor:
    """float waveform in [-1, 1] → int64 codes in [0, channels − 1]."""
    mu = quantization_channels - 1
    x = _f32(x)
    x_mu = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / torch.log1p(_f32(float(mu)))
    codes = ((x_mu + 1.0) / 2.0 * mu + 0.5).to(torch.int32)
    return torch.clamp(codes, 0, quantization_channels - 1).long()


def mulaw_decode(codes, quantization_channels: int = 256) -> torch.Tensor:
    """int codes (or continuous μ-law in [-1, 1]) → float waveform."""
    mu = float(quantization_channels - 1)
    x = _f32(codes) / mu * 2.0 - 1.0
    return torch.clamp(torch.sign(x) * (torch.exp(torch.abs(x) * torch.log1p(
        _f32(mu))) - 1.0) / mu, -1.0, 1.0)


def raw_encode(x, quantization_channels: int = 256) -> torch.Tensor:
    """Linear 8-bit quantization: codes in [0, channels − 1]."""
    n = quantization_channels - 1
    return torch.clamp(((_f32(x) + 1.0) / 2.0) * n, 0, n).to(torch.int32).long()


def raw_decode(codes, quantization_channels: int = 256) -> torch.Tensor:
    n = float(quantization_channels - 1)
    return (_f32(codes) / n - 0.5) * 2.0



