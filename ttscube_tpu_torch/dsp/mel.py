"""Mel front end, counterpart of `ttscube_tpu/dsp/mel.py` (`MelConfig`,
`feature_mel_config`, `gan_mel_config`, `MelSpec`).

The STFT is two matrix products against windowed DFT matrices, then the mel basis, as
in the JAX module. The host-side constants (`hz_to_mel`, `mel_to_hz`, `mel_filterbank`,
`hann_window`, `_dft_matrices`) are the port's own numpy copies: the JAX module imports
jax.

The inverse path (`preemphasis`, `MelSpec.fft`, `ifft`, `griffinlim`) follows the JAX
module too: the complex STFT through the same DFT matrices, its inverse as an irfft
matrix product and an overlap-add (`index_add_`) normalized by the summed squared
window, and Griffin-Lim phase reconstruction from an initial phase drawn from an
explicit `torch.Generator` or passed in.

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


def preemphasis(y: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """y[n] − coef · y[n − 1], with y[−1] = 0."""
    prev = torch.cat([torch.zeros_like(y[..., :1]), y[..., :-1]], dim=-1)
    return y - coef * prev


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
        self._inverse = {}

    def _inverse_on(self, device):
        """(irfft cos matrix (n_freq, n_fft), its sin matrix, the window (win_length,)),
        fp32 on `device`: the JAX `_istft`'s constants."""
        if device not in self._inverse:
            c = self.config
            n = np.arange(c.n_fft)[:, None]
            k = np.arange(1 + c.n_fft // 2)[None, :]
            ang = 2.0 * np.pi * n * k / c.n_fft
            scale = np.full((1, 1 + c.n_fft // 2), 2.0 / c.n_fft)
            scale[0, 0] = scale[0, -1] = 1.0 / c.n_fft
            icos = (np.cos(ang) * scale).astype(np.float32)
            isin = (-np.sin(ang) * scale).astype(np.float32)
            window = hann_window(c.win_length).astype(np.float32)
            self._inverse[device] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (icos.T, isin.T, window))
        return self._inverse[device]

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

    def magnitude(self, y: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """Linear-magnitude spectrogram (..., frames, n_freq), computed in `dtype`."""
        c = self.config
        cos_m, sin_m, _ = (t.to(dtype) for t in self._on(y.device))
        frames = frame_signal(self._pad(y.to(dtype)), c.n_fft, c.hop_length)
        re = frames @ cos_m
        im = frames @ sin_m
        return torch.sqrt(re * re + im * im + c.mag_floor_sq)

    def __call__(self, y: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """The log-mel, fp32; `dtype` is the arithmetic's type (fp64: the fp32 constants'
        exact transform, rounded once, on any device)."""
        c = self.config
        mel = self.magnitude(y, dtype) @ self._on(y.device)[2].to(dtype)
        if c.log_scale == "log10":
            return torch.log10(torch.clamp(mel, min=1e-5)).float()
        if c.log_scale == "ln":
            return torch.log(torch.clamp(mel, min=1e-5)).float()
        raise ValueError(f"unknown log scale {c.log_scale}")

    # -- the inverse path (Griffin-Lim) ----------------------------------------------------

    def _stft(self, y: torch.Tensor):
        c = self.config
        cos_m, sin_m, _ = self._on(y.device)
        frames = frame_signal(y.float(), c.n_fft, c.hop_length)
        return frames @ cos_m, frames @ sin_m

    def fft(self, y: torch.Tensor, use_preemphasis: bool = True) -> torch.Tensor:
        """Complex STFT (..., frames, n_freq), complex64, of the padded signal
        (preemphasis first by default, as the JAX method)."""
        if use_preemphasis:
            y = preemphasis(y)
        re, im = self._stft(self._pad(y))
        return torch.complex(re, im)

    def ifft(self, spec: torch.Tensor, out_len: int | None = None) -> torch.Tensor:
        """The inverse of `fft` by overlap-add: spec (..., frames, n_freq) complex →
        (..., out_len), out_len (frames − 1)·hop by default."""
        n = out_len if out_len is not None else (spec.shape[-2] - 1) * self.config.hop_length
        return self._istft(spec.real, spec.imag, n)

    def _istft(self, re: torch.Tensor, im: torch.Tensor, out_len: int) -> torch.Tensor:
        """(..., frames, n_freq) real and imaginary parts → the time signal: irfft as a
        matrix product, the window, the frames' overlap-add (`index_add_`) divided by the
        squared window's, and the n_fft // 2 padding cut off."""
        c = self.config
        icos_t, isin_t, window = self._inverse_on(re.device)
        frames = (re @ icos_t + im @ isin_t) * window
        num_frames = frames.shape[-2]
        total = (num_frames - 1) * c.hop_length + c.n_fft
        idx = (torch.arange(num_frames, device=re.device)[:, None] * c.hop_length
               + torch.arange(c.n_fft, device=re.device)[None, :]).reshape(-1)
        lead = frames.shape[:-2]
        sig = torch.zeros(*lead, total, device=re.device).index_add_(
            -1, idx, frames.reshape(*lead, -1))
        wsq = torch.zeros(total, device=re.device).index_add_(
            0, idx, (window * window).repeat(num_frames))
        sig = sig / torch.clamp(wsq, min=1e-8)
        p = c.n_fft // 2
        return sig[..., p: p + out_len]

    def griffinlim(self, magnitude: torch.Tensor, n_iter: int = 32, phase=None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
        """Phase reconstruction from a (..., frames, n_freq) magnitude spectrogram:
        (..., (frames − 1)·hop) samples. The initial phase is `phase`, or uniform on
        [0, 2π) drawn from `generator` (on its own device; a CPU generator seeded 0 by
        default) and moved to the magnitude's device."""
        c = self.config
        magnitude = magnitude.float()
        out_len = (magnitude.shape[-2] - 1) * c.hop_length
        if phase is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            phase = torch.rand(magnitude.shape, generator=generator,
                               device=generator.device) * (2 * np.pi)
        phase = phase.to(magnitude.device, torch.float32)
        re, im = magnitude * torch.cos(phase), magnitude * torch.sin(phase)
        p = c.n_fft // 2
        for _ in range(n_iter):
            sig = F.pad(self._istft(re, im, out_len), (p, p))
            nre, nim = self._stft(sig)
            mag = torch.sqrt(nre * nre + nim * nim + 1e-12)
            re, im = magnitude * nre / mag, magnitude * nim / mag
        return self._istft(re, im, out_len)
