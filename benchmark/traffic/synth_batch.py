"""Bulk synthesis traffic: batches of `batch` utterances that go to `Cubegan.infer` back
to back, as a job that phonemized its text ahead does (audiobooks, dataset generation).

Parameters (the cell file's `params`): `batch` items; `phones` [lo, hi], each item's
phone count drawn uniformly; `pad_phones`, the bucket its phone axis is padded to (the
serving API's 32); `max_frames`, the frames every item is synthesised to; `chunk_frames`
(or null), the generator's window. Phone ids are drawn from the configuration's
`num_phones` (id 0 is padding), speakers from its `num_speakers`. Batch i of a seed is
the same in every run, and is made when it is asked for."""

from __future__ import annotations

import numpy as np

SEED_MASK = (1 << 64) - 1


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([seed & SEED_MASK, *keys])


class Traffic:
    def __init__(self, params: dict, config: dict, seed: int):
        self.p, self.c, self.seed = params, config, seed

    def pad(self, n: int) -> int:
        q = self.p["pad_phones"]
        return -(-n // q) * q

    def _draw(self, r, pad_to: int | None = None) -> dict:
        lo, hi = self.p["phones"]
        B = self.p["batch"]
        lengths = r.integers(lo, hi + 1, B)
        n = self.pad(int(lengths.max())) if pad_to is None else pad_to
        lengths = np.minimum(lengths, n)
        ids = r.integers(1, self.c["languasito"]["num_phones"] + 1, (B, n))
        ids[np.arange(n)[None, :] >= lengths[:, None]] = 0
        spk = r.integers(1, self.c["languasito"]["num_speakers"] + 1, (B, 1))
        return {"x_char": ids.astype(np.int64), "x_speaker": spk.astype(np.int64)}

    def batch(self, i: int) -> dict:
        """{"x_char": (B, N) int64, "x_speaker": (B, 1) int64} numpy arrays."""
        return self._draw(rng(self.seed, 1, i))

    def warmup(self) -> list:
        """One batch for each padded phone length the traffic can produce."""
        lo, hi = self.p["phones"]
        pads = sorted({self.pad(m) for m in range(lo, hi + 1)})
        return [self._draw(rng(self.seed, 4, j), n) for j, n in enumerate(pads)]

    def keep(self, i: int) -> bool:
        """Whether batch i is in the sample the check compares: the first batch, and
        each later one with probability `check_share`."""
        return i == 0 or rng(self.seed, 2, i).random() < self.p["check_share"]

    def rows(self, i: int) -> np.ndarray:
        """The rows of a kept batch that the check compares."""
        return np.sort(rng(self.seed, 3, i).choice(self.p["batch"], self.p["check_rows"],
                                                   replace=False))

    def audio_s(self) -> float:
        """Seconds of audio one batch synthesises."""
        return self.p["batch"] * self.p["max_frames"] * self.c["hop_size"] / self.c["sample_rate"]
