"""Pitch extraction (RAPT-style NCCF candidates and Viterbi smoothing): counterpart of
`ttscube_tpu/dsp/pitch.py`.

The fast path is the repo's C++ tracker, `native/pitch.cpp` (read, never copied), built
at first use with `g++` into `ttscube_tpu_torch/_build/` (`ops/_build.load_host`: a
hash of the source and the flags names the library, which is written beside its place
and renamed into it) and called through ctypes. Its flags are those of `native/Makefile`,
so both packages run the same arithmetic. `_rapt_numpy`, the numpy twin of the C++ code,
is the plain version, run when the caller asks (`use_native=False`). A failed build
raises: it does not fall back quietly. Host work: pitch is a training target, computed
at import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent.parent / "native" / "pitch.cpp"
FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")


def _native() -> ctypes.CDLL:
    from ttscube_tpu_torch.ops._build import load_host

    lib = load_host(SOURCE, FLAGS)
    lib.ttscube_rapt.restype = ctypes.c_int
    lib.ttscube_rapt.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    return lib


def rapt_pitch(x: np.ndarray, sr: int = 24000, hop: int = 240,
               fmin: float = 60.0, fmax: float = 400.0,
               use_native: bool = True) -> np.ndarray:
    """f0 per hop-frame (Hz, 0 = unvoiced) for a mono float waveform."""
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    num_frames = len(x) // hop + 1
    if not use_native:
        return _rapt_numpy(x, sr, hop, fmin, fmax)
    out = np.zeros(num_frames, np.float32)
    n = _native().ttscube_rapt(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), sr, hop, fmin, fmax,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_frames)
    return out[:n]


def _rapt_numpy(x: np.ndarray, sr: int, hop: int, fmin: float, fmax: float) -> np.ndarray:
    """Vectorized numpy twin of native/pitch.cpp."""
    min_lag = max(2, int(sr / fmax))
    max_lag = int(sr / fmin)
    win = max_lag * 2
    num_frames = len(x) // hop + 1
    need = win + max_lag

    VOICING_BIAS, TRANS_COST, VOICE_SWITCH = 0.35, 0.6, 0.25
    K = 8

    cands = []  # per frame: list[(lag, nccf)]
    for t in range(num_frames):
        start = t * hop
        fc = [(0, 0.0)]
        if len(x) - start >= need:
            s = x[start : start + win]
            e0 = float(s @ s) + 1e-9
            lags = np.arange(min_lag, max_lag + 1)
            # sliding windows at each lag — stride-tricked matrix
            seg = np.lib.stride_tricks.sliding_window_view(
                x[start : start + win + max_lag], win)
            shifted = seg[lags]  # (L, win)
            num = shifted @ s
            el = np.einsum("ij,ij->i", shifted, shifted) + 1e-9
            nccf = num / np.sqrt(e0 * el)
            best_any = float(nccf.max()) if len(nccf) else 0.0
            # peaks
            interior = np.arange(1, len(nccf) - 1)
            is_peak = (nccf[interior] > nccf[interior - 1]) & \
                      (nccf[interior] >= nccf[interior + 1]) & \
                      (nccf[interior] > 0.3 * best_any) & (nccf[interior] > 0.2)
            peak_idx = interior[is_peak]
            order = np.argsort(-nccf[peak_idx])
            for i in peak_idx[order][: K - 1]:
                fc.append((int(lags[i]), float(nccf[i])))
        cands.append(fc)

    # Viterbi
    INF = 1e30
    cost_prev = None
    back = []
    for t, fc in enumerate(cands):
        local = np.array([VOICING_BIAS if lag == 0 else 1.0 - v for lag, v in fc])
        if t == 0:
            cost_prev = local
            back.append(np.full(len(fc), -1, np.int32))
            continue
        pc = cands[t - 1]
        trans = np.zeros((len(pc), len(fc)))
        for i, (li, _) in enumerate(pc):
            for j, (lj, _) in enumerate(fc):
                if li and lj:
                    trans[i, j] = TRANS_COST * abs(np.log(li / lj))
                elif (li != 0) != (lj != 0):
                    trans[i, j] = VOICE_SWITCH
        total = cost_prev[:, None] + trans
        arg = np.argmin(total, axis=0)
        cost_prev = total[arg, np.arange(len(fc))] + local
        back.append(arg.astype(np.int32))

    out = np.zeros(num_frames, np.float32)
    j = int(np.argmin(cost_prev))
    for t in range(num_frames - 1, -1, -1):
        lag = cands[t][j][0]
        out[t] = 0.0 if lag == 0 else sr / lag
        j = int(back[t][j]) if t > 0 else j
    return out
