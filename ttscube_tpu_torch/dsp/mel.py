"""Mel front end, counterpart of `ttscube_tpu/dsp/mel.py` (`MelConfig`,
`feature_mel_config`, `gan_mel_config`, `MelSpec`).

The STFT is two matrix products against windowed DFT matrices, then the mel basis, as
in the JAX module. The host-side constants (`hz_to_mel`, `mel_to_hz`, `mel_filterbank`,
`hann_window`, `_dft_matrices`) are the port's own numpy copies: the JAX module imports
jax. `fft`, `ifft` and `griffinlim` are not ported yet.

Two conventions:
  * "feature" mel: zero "center" padding of n_fft/2, |STFT|, slaney mel, log10 with a
    1e-5 floor;
  * "gan" mel (the GAN's mel loss): reflect padding of (n_fft − hop)/2 on each side,
    sqrt(re² + im² + 1e-9), slaney mel up to 12 kHz, natural log with a 1e-5 floor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(frequencies, htk: bool = False):
    f = np.asanyarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    if np.ndim(mels):
        log_region = f >= min_log_hz
        mels = np.where(log_region,
                        min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                        mels)
    elif f >= min_log_hz:
        mels = min_log_mel + np.log(f / min_log_hz) / logstep
    return mels


def mel_to_hz(mels, htk: bool = False):
    m = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    if np.ndim(freqs):
        log_region = m >= min_log_mel
        freqs = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    elif m >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (m - min_log_mel))
    return freqs


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False,
                   norm: str | None = "slaney") -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, 1 + n_fft//2); librosa-compatible."""
    if fmax is None:
        fmax = float(sr) / 2
    n_freq = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, float(sr) / 2, n_freq)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2), htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unsupported norm: {norm}")
    return weights.astype(np.float32)


def hann_window(n: int, periodic: bool = True) -> np.ndarray:
    denom = n if periodic else n - 1
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / denom)).astype(np.float64)


def _dft_matrices(n_fft: int, win_length: int, window: np.ndarray):
    """Windowed real-DFT matrices: frames (..., n_fft) @ cos/sin → (..., n_freq)."""
    n_freq = 1 + n_fft // 2
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w = np.zeros(n_fft)
    off = (n_fft - win_length) // 2
    w[off: off + win_length] = window
    cos_m = (np.cos(ang) * w[:, None]).astype(np.float32)
    sin_m = (-np.sin(ang) * w[:, None]).astype(np.float32)
    return cos_m, sin_m


def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., T) → (..., num_frames, n_fft), frame f starting at sample f·hop."""
    return y.unfold(-1, n_fft, hop)


@dataclasses.dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 24000
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 240
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float | None = None
    padding: str = "center"   # "center": zeros, n_fft//2; "hifigan": reflect, (n_fft-hop)//2
    log_scale: str = "log10"  # "log10" or "ln"
    mag_floor_sq: float = 0.0  # added under the magnitude's square root


def feature_mel_config(sample_rate: int = 24000, n_mels: int = 80,
                       hop_length: int = 240) -> MelConfig:
    """The feature extractor's config."""
    return MelConfig(sample_rate=sample_rate, hop_length=hop_length, n_mels=n_mels,
                     fmax=None, padding="center", log_scale="log10", mag_floor_sq=0.0)


def gan_mel_config(sample_rate: int = 24000, n_mels: int = 80, hop_length: int = 240,
                   fmin: float = 0.0, fmax: float | None = 12000.0) -> MelConfig:
    """The GAN mel loss's config."""
    return MelConfig(sample_rate=sample_rate, hop_length=hop_length, n_mels=n_mels,
                     fmin=fmin, fmax=fmax, padding="hifigan", log_scale="ln",
                     mag_floor_sq=1e-9)


class MelSpec:
    """Waveform → log-mel. Call with (T,) or (B, T); returns (..., frames, n_mels) fp32.
    The constants move to the input's device on first use there."""

    def __init__(self, config: MelConfig | None = None):
        self.config = config or feature_mel_config()
        c = self.config
        window = hann_window(c.win_length, periodic=True)
        cos_m, sin_m = _dft_matrices(c.n_fft, c.win_length, window)
        self._consts = {torch.device("cpu"): (
            torch.from_numpy(cos_m), torch.from_numpy(sin_m),
            torch.from_numpy(np.ascontiguousarray(
                mel_filterbank(c.sample_rate, c.n_fft, c.n_mels, c.fmin, c.fmax).T)))}

    def _on(self, device):
        if device not in self._consts:
            self._consts[device] = tuple(t.to(device) for t in
                                         self._consts[torch.device("cpu")])
        return self._consts[device]

    def _pad(self, y: torch.Tensor) -> torch.Tensor:
        c = self.config
        if c.padding == "center":
            p = c.n_fft // 2
            return F.pad(y, (p, p))
        if c.padding == "hifigan":
            p = (c.n_fft - c.hop_length) // 2
            # reflect padding wants a batch (and channel) axis
            return F.pad(y.reshape(-1, 1, y.shape[-1]), (p, p), mode="reflect").reshape(
                *y.shape[:-1], y.shape[-1] + 2 * p)
        if c.padding == "none":
            return y
        raise ValueError(f"unknown padding mode {c.padding}")

    def magnitude(self, y: torch.Tensor) -> torch.Tensor:
        """Linear-magnitude spectrogram (..., frames, n_freq)."""
        c = self.config
        cos_m, sin_m, _ = self._on(y.device)
        frames = frame_signal(self._pad(y.float()), c.n_fft, c.hop_length)
        re = frames @ cos_m
        im = frames @ sin_m
        return torch.sqrt(re * re + im * im + c.mag_floor_sq)

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        c = self.config
        mel = self.magnitude(y) @ self._on(y.device)[2]
        if c.log_scale == "log10":
            return torch.log10(torch.clamp(mel, min=1e-5))
        if c.log_scale == "ln":
            return torch.log(torch.clamp(mel, min=1e-5))
        raise ValueError(f"unknown log scale {c.log_scale}")
