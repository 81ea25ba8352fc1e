"""GAN training traffic: a pool of `pool` distinct batches of `batch` utterances, cycled
step after step, each step with its own crop starts, as a voice trainer at the
trainer's defaults draws them from a read-speech corpus.

Parameters (the cell file's `params`): `batch`, `pool`; `watch_within`, the window's
first steps among which the one that the check follows is drawn; `frames` [lo, hi], the
utterances' lengths, spread evenly over the range and dealt so that every batch spans
it (every seed gets the same lengths, in another order); `frames_per_phone`;
`phones_per_word` [lo, hi]; with LM conditioning `tokens_per_word` [lo, hi] and the
context tokens around the sentence, enough to fill the encoder's window. The phones,
their durations, the speakers, the words and token ids, the pitch, the mel and the
audio (a voiced tone with harmonics under noise) are drawn from the seed. Utterances
come in the corpus's format, for a collate to batch."""

from __future__ import annotations

import numpy as np

from benchmark.traffic.synth_batch import rng


class Traffic:
    def __init__(self, params: dict, config: dict, seed: int):
        self.p, self.c, self.seed = params, config, seed
        P, B = params["pool"], params["batch"]
        lo, hi = params["frames"]
        lengths = np.round(np.linspace(lo, hi, P * B)).astype(int)
        order = rng(seed, 10).permutation(P)
        self.lengths = [rng(seed, 11, j).permutation(lengths[order[j]::P]) for j in range(P)]

    def phones(self) -> list:
        return [f"p{i}" for i in range(self.c["languasito"]["num_phones"])]

    def speakers(self) -> list:
        return [f"s{i}" for i in range(self.c["languasito"]["num_speakers"])]

    def utterance(self, r, frames: int) -> dict:
        c, p = self.c, self.p
        hop, sr = c["hop_size"], c["sample_rate"]
        n = max(2, int(round(frames / p["frames_per_phone"])))
        cuts = np.sort(r.choice(np.arange(1, frames), n - 1, replace=False))
        durs = np.diff(np.concatenate([[0], cuts, [frames]]))
        phones, speakers = self.phones(), self.speakers()
        words, p2w, w = [], [], 0
        while len(p2w) < n:
            k = int(r.integers(p["phones_per_word"][0], p["phones_per_word"][1] + 1))
            words.append(f"w{int(r.integers(0, 1 << 20))}")
            p2w += [w] * k
            w += 1
        p2w = p2w[:n]
        words = words[: p2w[-1] + 1]
        t = np.arange(frames * hop) / sr
        f0 = r.uniform(90, 250)
        tone = sum(np.sin(2 * np.pi * f0 * (h + 1) * t) / (h + 1) for h in range(4))
        audio = 0.2 * tone + 0.02 * r.standard_normal(frames * hop)
        voiced = r.random(frames) > 0.3
        meta = {"phones": [phones[j] for j in r.integers(0, len(phones), n)],
                "speaker": speakers[int(r.integers(0, len(speakers)))],
                "frame2phon": np.repeat(np.arange(n), durs).tolist(),
                "phon2word": p2w, "words": words}
        if c["languasito"].get("cond_type") == "hf":
            meta.update(self.tokens(r, len(words)))
        return {"meta": meta,
                "mgc": r.standard_normal((frames, c["hifigan"]["num_mels"])).astype(np.float32),
                "pitch": (r.uniform(80, 300, frames) * voiced).astype(np.float32),
                "audio": audio.astype(np.float32)}

    def tokens(self, r, n_words: int) -> dict:
        """Token ids of the sentence (each word `tokens_per_word` tokens, the map to its
        first) and of the context before and after it."""
        lo, hi = self.p["tokens_per_word"]
        vocab = self.c["lm"]["vocab_size"]
        ids, w2t = [], {}
        for w in range(n_words):
            w2t[w] = len(ids)
            ids += r.integers(1000, vocab, int(r.integers(lo, hi + 1))).tolist()
        window = self.c["lm"]["max_position_embeddings"]
        left = max(0, window - len(ids)) + int(r.integers(0, self.p["context_extra"] + 1))
        right = int(r.integers(0, self.p["context_extra"] + 1))
        return {"words_hf": {"tok_ids": ids, "word2tok": w2t},
                "words_left_hf": {"tok_ids": r.integers(1000, vocab, left).tolist(),
                                  "word2tok": {}},
                "words_right_hf": {"tok_ids": r.integers(1000, vocab, right).tolist(),
                                   "word2tok": {}}}

    def batch(self, j: int) -> list:
        """Pool batch j: its utterances, in the corpus's format."""
        r = rng(self.seed, 12, j)
        return [self.utterance(r, int(f)) for f in self.lengths[j]]

    def watched(self) -> int:
        """The step of the measured window (counted from its first) that the check
        follows, drawn from the seed in [0, `watch_within`)."""
        return int(rng(self.seed, 14).integers(0, self.p["watch_within"]))

    def starts(self, k: int, n_frames: np.ndarray) -> np.ndarray:
        """Step k's crop starts, each in [0, max(n_frames − crop − 1, 0)]."""
        crop = self.c["training"]["crop_frames"]
        top = np.maximum(np.asarray(n_frames) - crop - 1, 0)
        return np.floor(rng(self.seed, 13, k).random(len(top)) * (top + 1)).astype(np.int64)
