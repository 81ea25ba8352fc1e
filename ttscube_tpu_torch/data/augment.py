"""The port's copy of `ttscube_tpu/data/augment.py` (numpy and scipy).

Audio data-augmentation chain — a WORKING equivalent of the reference's broken
``cube/io_utils/audio.py`` (its ``alter`` at audio.py:61-76 never imports
``random``/``np``/``librosa`` and depends on ``pysndfx``, which is not in its
requirements; no live code calls it). Same four transforms, same 10%-each
composition, rebuilt on numpy/scipy with an explicit ``np.random.Generator``
(no module-global RNG) so augmentation is reproducible per seed.

Host-side (data plane): augmentation runs on CPU inside dataset ``__getitem__``;
the card only ever sees the resulting arrays. Opt-in via
``VocoderDataset(augment_prob=...)`` (data/datasets.py).
"""

from __future__ import annotations

import os

import numpy as np
from scipy import signal


def _shelf(sr: int, f0: float, gain_db: float, kind: str):
    """RBJ-cookbook low/high shelving biquad (b, a) — the working stand-in for
    pysndfx's sox ``highshelf``/``lowshelf`` (reference audio.py:10-13)."""
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * np.pi * f0 / sr
    cw, sw = np.cos(w0), np.sin(w0)
    alpha = sw / 2.0 * np.sqrt(2.0)  # S = 1
    sq = 2.0 * np.sqrt(A) * alpha
    if kind == "low":
        b0 = A * ((A + 1) - (A - 1) * cw + sq)
        b1 = 2 * A * ((A - 1) - (A + 1) * cw)
        b2 = A * ((A + 1) - (A - 1) * cw - sq)
        a0 = (A + 1) + (A - 1) * cw + sq
        a1 = -2 * ((A - 1) + (A + 1) * cw)
        a2 = (A + 1) + (A - 1) * cw - sq
    else:
        b0 = A * ((A + 1) + (A - 1) * cw + sq)
        b1 = -2 * A * ((A - 1) + (A + 1) * cw)
        b2 = A * ((A + 1) + (A - 1) * cw - sq)
        a0 = (A + 1) - (A - 1) * cw + sq
        a1 = 2 * ((A - 1) - (A + 1) * cw)
        a2 = (A + 1) - (A - 1) * cw - sq
    return np.array([b0, b1, b2]) / a0, np.array([1.0, a1 / a0, a2 / a0])


def _phaser(x: np.ndarray, rng: np.random.Generator, sr: int) -> np.ndarray:
    """LFO-swept short delay mixed with the dry signal (sox ``phaser`` stand-in)."""
    t = np.arange(len(x))
    delay = (1.5 + 1.0 * np.sin(2.0 * np.pi * 0.5 * t / sr
                                + rng.uniform(0, 2 * np.pi))) * sr / 1000.0
    pos = np.maximum(t - delay, 0.0)
    i0 = pos.astype(np.int64)
    frac = pos - i0
    i1 = np.minimum(i0 + 1, len(x) - 1)
    return 0.7 * x + 0.5 * ((1.0 - frac) * x[i0] + frac * x[i1])


def add_reverb(x: np.ndarray, rng: np.random.Generator, sr: int) -> np.ndarray:
    """Synthetic-RIR convolution reverb. 50%: plain reverb (reference ``_fx``);
    50%: the 'colored' chain highshelf→reverb→phaser→lowshelf (``_fx2``,
    audio.py:8-21)."""
    colored = rng.random() < 0.5
    if colored:
        b, a = _shelf(sr, 4000.0, rng.uniform(-6.0, -2.0), "high")
        x = signal.lfilter(b, a, x)
    t60 = rng.uniform(0.2, 0.6)
    n = int(t60 * sr)
    tail = rng.standard_normal(n) * np.exp(-6.9 * np.arange(n) / n)
    rir = np.zeros(n + 1)
    rir[0] = 1.0  # direct path
    rir[1:] = 0.25 * tail
    y = signal.fftconvolve(x, rir)[: len(x)]
    if colored:
        y = _phaser(y, rng, sr)
        b, a = _shelf(sr, 200.0, rng.uniform(-6.0, -2.0), "low")
        y = signal.lfilter(b, a, y)
    peak = np.max(np.abs(y)) or 1.0
    if peak > 1.0:
        y = y / peak
    return y.astype(np.float32)


def add_noise(x: np.ndarray, rng: np.random.Generator,
              level: float = 0.01) -> np.ndarray:
    """White noise, 50% gaussian / 50% uniform (reference ``_add_noise``,
    audio.py:24-29)."""
    if rng.random() < 0.5:
        noise = rng.normal(0.0, level, x.shape[0])
    else:
        noise = rng.uniform(-level, level, x.shape[0])
    return (x + noise).astype(np.float32)


def add_real_noise(x: np.ndarray, rng: np.random.Generator, noise_files,
                   sr: int) -> np.ndarray:
    """Mix a random recorded-noise wav, peak-normalized to a random 0.2–0.45 gain
    and tiled to length (reference ``_add_real_noise``, audio.py:36-47)."""
    from ttscube_tpu_torch.utils.wavio import read_wav

    candidates = [f for f in noise_files if os.path.getsize(f) > 22050]
    if not candidates:
        return x
    noise, _ = read_wav(candidates[int(rng.integers(len(candidates)))], target_sr=sr)
    peak = np.max(np.abs(noise)) or 1.0
    noise = noise / peak * (rng.random() / 4 + 0.2)
    reps = int(np.ceil(len(x) / max(len(noise), 1)))
    noise = np.tile(noise, reps)[: len(x)]
    return (x + noise).astype(np.float32)


def downsample(x: np.ndarray, rng: np.random.Generator, sr: int) -> np.ndarray:
    """Round-trip through 8 kHz (50%) or 16 kHz (50%) — bandwidth reduction
    (reference ``_downsample``, audio.py:50-58)."""
    low = 8000 if rng.random() < 0.5 else 16000
    g = int(np.gcd(sr, low))
    y = signal.resample_poly(x, low // g, sr // g)
    y = signal.resample_poly(y, sr // g, low // g)
    return y[: len(x)].astype(np.float32)


def alter(x: np.ndarray, rng: np.random.Generator, sr: int, prob: float = 0.1,
          noise_files=()) -> np.ndarray:
    """Apply each transform independently with probability `prob` (reference
    ``alter``, audio.py:61-76)."""
    if rng.random() < prob:
        x = add_reverb(x, rng, sr)
    if rng.random() < prob:
        x = add_noise(x, rng)
    if noise_files and rng.random() < prob:
        x = add_real_noise(x, rng, noise_files, sr)
    if rng.random() < prob:
        x = downsample(x, rng, sr)
    return x
