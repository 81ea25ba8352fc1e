"""Host-side WAV IO and resampling: the port's copy of `ttscube_tpu/utils/wavio.py`.

PCM16/PCM32/8-bit WAVs through the standard library's `wave` module; resampling by
polyphase filtering, with scipy imported only inside `resample`, so that reading a WAV
at its own rate needs numpy alone.
"""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str, target_sr: int | None = None) -> tuple[np.ndarray, int]:
    """Returns (mono float32 waveform in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    if target_sr is not None and target_sr != sr:
        data = resample(data, sr, target_sr)
        sr = target_sr
    return data, sr


def write_wav(path: str, data: np.ndarray, sr: int):
    """Writes mono PCM16."""
    data = np.asarray(data)
    if data.dtype != np.int16:
        data = np.clip(data, -1.0, 1.0)
        data = (data * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


def resample(data: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    from math import gcd

    from scipy import signal

    g = gcd(sr, target_sr)
    return signal.resample_poly(data, target_sr // g, sr // g).astype(np.float32)
