"""The reference's batches: utterances in the corpus's format padded into the arrays a
GAN step reads, as TTS-Cube's Cubegan collate builds them (phones as ids + 1 with 0
for padding, each phone's duration from the frame map clipped to `duration_cap`, the
frame map padded with its last phone, the phone and frame axes padded to their buckets)
and, with LM conditioning, a window of at most `max_tokens` tokens over the context
before, the sentence and the context after it, its words mapped to their first token + 1."""

from __future__ import annotations

import numpy as np


def _bucket(n: int, step: int) -> int:
    return max(step, -(-n // step) * step)


def collate(items: list, phones: list, speakers: list, k: dict, hop: int, hf: bool) -> dict:
    """numpy arrays of one batch; `k` holds the configuration's `collate` settings."""
    phon2int = {p: i for i, p in enumerate(phones)}
    spk2int = {s: i for i, s in enumerate(speakers)}
    B = len(items)
    N = _bucket(max(len(e["meta"]["phones"]) for e in items), k["bucket_phones"])
    F = _bucket(max(max(len(e["pitch"]) for e in items), k["min_frames"]), k["bucket_frames"])
    out = {"x_char": np.zeros((B, N), np.int64), "x_phon2word": np.zeros((B, N), np.int64),
           "x_speaker": np.zeros((B, 1), np.int64), "y_dur": np.zeros((B, N), np.int64),
           "y_frame2phone": np.zeros((B, F), np.int64), "n_frames": np.zeros(B, np.int64),
           "y_pitch": np.zeros((B, F), np.float32), "y_audio": np.zeros((B, F * hop), np.float32)}
    for i, e in enumerate(items):
        m = e["meta"]
        P = len(m["phones"])
        out["x_char"][i, :P] = [phon2int[p] + 1 for p in m["phones"]]
        out["x_phon2word"][i, :P] = m["phon2word"]
        out["x_speaker"][i, 0] = spk2int[m["speaker"]] + 1
        f2p = np.asarray(m["frame2phon"])
        n = min(len(f2p), F)
        out["y_frame2phone"][i, :n] = f2p[:n]
        out["y_frame2phone"][i, n:] = f2p[n - 1]
        out["n_frames"][i] = n
        out["y_dur"][i, :P] = np.minimum(np.bincount(f2p, minlength=P)[:P], k["duration_cap"])
        out["y_pitch"][i, : len(e["pitch"])] = e["pitch"]
        a = np.asarray(e["audio"], np.float32)[: F * hop]
        out["y_audio"][i, : len(a)] = a
    out["y_frame_mask"] = np.arange(F)[None, :] < out["n_frames"][:, None]
    if hf:
        out.update(_windows(items, k))
    return out


def _windows(items: list, k: dict) -> dict:
    cap = k["max_tokens"]
    windows = []
    for e in items:
        m = e["meta"]
        left, center = m["words_left_hf"]["tok_ids"], m["words_hf"]["tok_ids"]
        right = m["words_right_hf"]["tok_ids"]
        start = 0 if len(left) + len(center) <= cap else len(left) + len(center) - cap
        toks = (list(left) + list(center) + list(right))[start:][:cap]
        w2t = {int(w): int(t) + len(left) - start for w, t in m["words_hf"]["word2tok"].items()}
        windows.append((toks, w2t))
    B = len(items)
    T = min(_bucket(max(len(t) for t, _ in windows), k["bucket_tokens"]), cap)
    W = max(max((max(w) + 1) if w else 1 for _, w in windows), 1)
    ids = np.zeros((B, T), np.int64)
    mask = np.zeros((B, T), bool)
    w2t_arr = np.zeros((B, W), np.int64)
    for i, (toks, w2t) in enumerate(windows):
        n = min(len(toks), T)
        ids[i, :n] = toks[:n]
        mask[i, :n] = True
        for w, t in w2t.items():
            if 0 <= w < W and 0 <= t < n:
                w2t_arr[i, w] = t + 1
    return {"x_tok_ids": ids, "x_tok_mask": mask, "x_word2tok": w2t_arr}
