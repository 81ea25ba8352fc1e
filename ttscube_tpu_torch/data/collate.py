"""The port's copy of the Cubegan collate (numpy only; the JAX package's
``data/collate.py`` is the reference this file is held against).

Pure-array collates with bucketed static shapes.

TPU redesign vs the reference collates (``io_cubegan.py:155-277``, ``io_phonemizer.py:64-117``,
``io_vocoder.py:86-112``):
  * `y_frame2phone` is a dense (B, F) gather-index array + frame mask, precomputed here —
    the reference keeps ragged Python lists and rebuilds numpy indices on the host every
    training step (modules.py:1043-1053);
  * batch shapes are padded up to buckets (multiples of `bucket`) so jit recompiles only
    per bucket, not per batch;
  * word spans for the M2M phonemizer are dense start/stop arrays instead of lists of
    dicts (reference ``io_phonemizer.py:86-90``).
Padding/ignore-index conventions are preserved (phones +1 with 0=PAD, mel pad −5,
duration clip to 100 = 1 s, ignore via masks instead of sentinel class indices).
"""

from __future__ import annotations

import numpy as np

from ttscube_tpu_torch.data.encodings import CubeganEncodings

DURATION_CAP = 100  # frames (reference io_cubegan.py:216-218)
HF_MAX_TOKENS = 512  # transformer context window (reference io_cubegan.py:246-277)


def hf_sliding_window(left_ids, center_ids, right_ids, word2tok):
    """Slide a 512-token window over left+center+right context so the center sentence
    fits, remapping word→token coordinates (reference ``_get_hf_ids``
    io_cubegan.py:246-277: start=0/offset=len(left) when left+center ≤ 512, else
    start=center+left−512, offset=left−start).

    Returns (tok_ids ≤512, {word_index: token_position}) — positions are into the
    returned window."""
    l_size = len(left_ids)
    c_size = len(center_ids)
    if l_size + c_size <= HF_MAX_TOKENS:
        start, offset = 0, l_size
    else:
        start = c_size + l_size - HF_MAX_TOKENS
        offset = l_size - start
    toks = (list(left_ids) + list(center_ids) + list(right_ids))[start:][:HF_MAX_TOKENS]
    w2t = {int(w): int(t) + offset for w, t in word2tok.items()}
    return toks, w2t


def _bucket(n: int, step: int) -> int:
    return max(step, ((n + step - 1) // step) * step)


def frame2phone_dense(frame2phon: list, max_frames: int):
    """Ragged frame→phone list → dense index row + length (pad repeats last entry)."""
    row = np.zeros(max_frames, np.int32)
    n = min(len(frame2phon), max_frames)
    row[:n] = frame2phon[:n]
    if n and n < max_frames:
        row[n:] = frame2phon[n - 1]
    return row, n


class CubeganCollate:
    """Builds Cubegan training batches (reference CubeganCollate io_cubegan.py:155-277).

    `word_embedder(words: list[str]) -> (W, D) array` hooks LM conditioning (fastText
    table export or precomputed HF embeddings); None disables conditioning.
    """

    def __init__(self, encodings: CubeganEncodings, word_embedder=None,
                 bucket_phones: int = 32, bucket_frames: int = 64, hop: int = 240,
                 min_frames: int = 60, hf_conditioning: bool = False,
                 bucket_tokens: int = 64, bucket_words: int = 1):
        self.encodings = encodings
        self.word_embedder = word_embedder
        self.bucket_phones = bucket_phones
        self.bucket_frames = bucket_frames
        self.hop = hop
        self.min_frames = min_frames  # ≥ GAN train window + a margin
        self.hf_conditioning = hf_conditioning  # emit x_tok_ids/x_tok_mask/x_word2tok
        self.bucket_tokens = bucket_tokens
        # bucket the word axis (x_words / x_word2tok) so nearby word counts share one
        # jit trace — serving sets this >1 (api.py) so warmup() covers real requests;
        # default 1 keeps training batches at exact batch-max width
        self.bucket_words = bucket_words

    def __call__(self, batch: list[dict]):
        enc = self.encodings
        B = len(batch)
        max_char = _bucket(max(len(e["meta"]["phones"]) for e in batch), self.bucket_phones)
        max_mel = max(max(e["mgc"].shape[0] for e in batch), self.min_frames)
        max_mel = _bucket(max_mel, self.bucket_frames)

        x_char = np.zeros((B, max_char), np.int32)
        x_phon2word = np.zeros((B, max_char), np.int32)
        x_speaker = np.zeros((B, 1), np.int32)
        y_mgc = np.full((B, max_mel, 80), -5.0, np.float32)
        y_dur = np.zeros((B, max_char), np.int32)
        y_pitch = np.zeros((B, max_mel), np.float32)
        y_frame2phone = np.zeros((B, max_mel), np.int32)
        n_frames = np.zeros((B,), np.int32)
        y_audio = np.zeros((B, max_mel * self.hop), np.float32)
        x_words = None

        for i, e in enumerate(batch):
            meta = e["meta"]
            P = len(meta["phones"])
            mgc = e["mgc"]
            y_mgc[i, : mgc.shape[0]] = mgc
            x_speaker[i] = enc.speaker2int.get(meta["speaker"], -1) + 1
            for j, ph in enumerate(meta["phones"]):
                x_char[i, j] = enc.phon2int.get(ph, -1) + 1
            row, n = frame2phone_dense(meta["frame2phon"], max_mel)
            y_frame2phone[i] = row
            n_frames[i] = n
            counts = np.bincount(np.asarray(meta["frame2phon"], np.int64), minlength=P)
            y_dur[i, :P] = np.clip(counts[:P], 0, DURATION_CAP)
            p2w = np.asarray(meta["phon2word"], np.int64)
            if self.word_embedder is not None and "words_left" in meta:
                # fastText path offsets phon2word by the left-context words
                # (reference io_cubegan.py:198-199)
                p2w = p2w + len(meta["words_left"])
            x_phon2word[i, : len(p2w)] = p2w
            pitch = e["pitch"]
            y_pitch[i, : len(pitch)] = pitch
            if "audio" in e:
                a = np.asarray(e["audio"], np.float32)
                m = min(y_audio.shape[1], a.shape[0])
                y_audio[i, :m] = a[:m]

        if self.word_embedder is not None:
            all_words = [
                list(e["meta"].get("words_left", [])) + list(e["meta"]["words"]) +
                list(e["meta"].get("words_right", []))
                for e in batch
            ]
            W = _bucket(max(max(len(w) for w in all_words), 1), self.bucket_words)
            dim = None
            embs = []
            for words in all_words:
                v = self.word_embedder(words)
                dim = v.shape[1] if len(v) else dim
                embs.append(v)
            dim = dim or 300
            x_words = np.zeros((B, W, dim), np.float32)
            for i, v in enumerate(embs):
                if len(v):
                    x_words[i, : v.shape[0]] = v

        out = {
            "x_char": x_char,
            "x_phon2word": x_phon2word,
            "x_speaker": x_speaker,
            "y_mgc": y_mgc,
            "y_frame2phone": y_frame2phone,
            "y_frame_mask": (np.arange(max_mel)[None, :] < n_frames[:, None]),
            "n_frames": n_frames,
            "y_pitch": y_pitch,
            "y_dur": y_dur,
            "y_audio": y_audio,
        }
        if x_words is not None:
            out["x_words"] = x_words
        if self.hf_conditioning:
            out.update(self._hf_windows(batch))
        return out

    def _hf_windows(self, batch):
        """Dense HF-conditioning arrays: token windows + word→token gather indices.

        `x_word2tok[i, w]` = position of word w's word-start subtoken (as produced by
        HFTokenizer) in `x_tok_ids[i]`, + 1;
        0 means missing/pad (the model prepends a zero row — reference
        ``_expand_i_hf`` modules.py:1055-1077 does the same with invalid→0)."""
        windows = []
        for e in batch:
            meta = e["meta"]
            toks, w2t = hf_sliding_window(
                meta.get("words_left_hf", {}).get("tok_ids", []),
                meta["words_hf"]["tok_ids"],
                meta.get("words_right_hf", {}).get("tok_ids", []),
                meta["words_hf"]["word2tok"])
            windows.append((toks, w2t))
        B = len(batch)
        T = min(_bucket(max(len(t) for t, _ in windows), self.bucket_tokens),
                HF_MAX_TOKENS)
        W = _bucket(max(max((max(w) + 1) if w else 1 for _, w in windows), 1),
                    self.bucket_words)
        x_tok_ids = np.zeros((B, T), np.int32)
        x_tok_mask = np.zeros((B, T), bool)
        x_word2tok = np.zeros((B, W), np.int32)
        for i, (toks, w2t) in enumerate(windows):
            n = min(len(toks), T)
            x_tok_ids[i, :n] = toks[:n]
            x_tok_mask[i, :n] = True
            for w, t in w2t.items():
                if 0 <= w < W and 0 <= t < n:
                    x_word2tok[i, w] = t + 1
        return {"x_tok_ids": x_tok_ids, "x_tok_mask": x_tok_mask,
                "x_word2tok": x_word2tok}
