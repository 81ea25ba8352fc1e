"""Word-vector table for fastText conditioning: the port's copy of
`ttscube_tpu/utils/wordvec.py` (host numpy; the port imports nothing of the JAX package).

A fastText `.vec` text file ("word v1 v2 ... vD" lines, an optional "count dim" header)
becomes a plain (V, D) table and a vocabulary; conditioning is then a host-side lookup
that feeds the collate's `x_words`. A word missing from the table gets the mean of
hashed character-trigram vectors from a fixed table of N_OOV_BUCKETS rows, drawn from
`default_rng(0)` and hashed with crc32, so that its vector is the same in every process
and bit-equal to the JAX package's.
"""

from __future__ import annotations

import zlib

import numpy as np

N_OOV_BUCKETS = 4096


class WordVectors:
    def __init__(self, vocab: dict[str, int], table: np.ndarray):
        self.vocab = vocab
        self.table = table  # (V, D)
        rng = np.random.default_rng(0)
        self._oov = (rng.standard_normal((N_OOV_BUCKETS, table.shape[1]))
                     .astype(np.float32) * 0.1)

    @property
    def dim(self) -> int:
        return self.table.shape[1]

    @classmethod
    def load_vec(cls, path: str, max_words: int | None = None) -> "WordVectors":
        """Parse a fastText .vec text file."""
        vocab: dict[str, int] = {}
        rows = []
        with open(path, encoding="utf-8", errors="replace") as f:
            first = f.readline().rstrip("\n")
            parts = first.split(" ")
            if len(parts) == 2 and all(p.isdigit() for p in parts):
                pass  # header line "count dim"
            else:
                word, vec = parts[0], parts[1:]
                vocab[word] = 0
                rows.append(np.asarray(vec, np.float32))
            for line in f:
                if max_words is not None and len(rows) >= max_words:
                    break
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                word = parts[0]
                if word in vocab:
                    continue
                vocab[word] = len(rows)
                rows.append(np.asarray([p for p in parts[1:] if p], np.float32))
        return cls(vocab, np.stack(rows))

    def save_npz(self, path: str):
        words = [None] * len(self.vocab)
        for w, i in self.vocab.items():
            words[i] = w
        np.savez_compressed(path, table=self.table,
                            words=np.asarray(words, dtype=object))

    @classmethod
    def load_npz(cls, path: str) -> "WordVectors":
        obj = np.load(path, allow_pickle=True)
        words = obj["words"]
        return cls({str(w): i for i, w in enumerate(words)}, obj["table"])

    def _oov_vector(self, word: str) -> np.ndarray:
        word = f"<{word}>"
        acc = np.zeros(self.dim, np.float32)
        n = 0
        for i in range(len(word) - 2):
            # crc32, not builtin hash(): PYTHONHASHSEED randomizes hash() per process,
            # which would give different OOV embeddings at train vs inference time
            h = zlib.crc32(word[i : i + 3].encode("utf-8")) % N_OOV_BUCKETS
            acc += self._oov[h]
            n += 1
        return acc / max(n, 1)

    def __call__(self, words: list[str]) -> np.ndarray:
        """word_embedder hook for CubeganCollate: list[str] → (W, D)."""
        if not words:
            return np.zeros((0, self.dim), np.float32)
        out = np.empty((len(words), self.dim), np.float32)
        for i, w in enumerate(words):
            idx = self.vocab.get(str(w), self.vocab.get(str(w).lower()))
            out[i] = self.table[idx] if idx is not None else self._oov_vector(str(w))
        return out


def make_word_embedder(spec: str):
    """`--lm fasttext:<path.vec|path.npz>` → a collate word_embedder (or None)."""
    if not spec:
        return None
    kind, _, path = spec.partition(":")
    if kind == "hf":
        return None  # hf conditioning runs in-model (models/lm.py), not in the collate
    if kind != "fasttext":
        raise ValueError(f"unknown LM conditioning spec '{spec}' "
                         "(expected fasttext:<path> or hf:<dir>)")
    if path.endswith(".npz"):
        return WordVectors.load_npz(path)
    return WordVectors.load_vec(path)
