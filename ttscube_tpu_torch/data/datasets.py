"""Training corpora on disk, host-side numpy: the port's copies of
`ttscube_tpu/data/datasets.py::CubeganDataset`, `PhonemizerDataset` and
`batch_iterator`.

A corpus folder holds per-utterance `{id}.{mgc,pitch,json,wav}` files, as the JAX
package's importers write them; the phonemizer's data is one JSON list per split. Not
ported: the HF tokenizer's pre-tokenisation (`hf_tokenizer`, with LM conditioning) and
`VocoderDataset`.
"""

from __future__ import annotations

import json
import os
import random
from os.path import join

import numpy as np

from ttscube_tpu_torch.data.text import SimpleTokenizer
from ttscube_tpu_torch.utils.wavio import read_wav

MAX_PHONE_FRAMES = 400  # drop utterances with any phone longer than this


class CubeganDataset:
    """Scans a folder of per-utterance {id}.{mgc,pitch,json,wav} artifacts."""

    def __init__(self, base_path: str, hop_size: int = 240, sample_rate: int = 24000):
        self._hop = hop_size
        self._sr = sample_rate
        self._base_path = base_path
        self._examples: list[dict] = []
        tok = SimpleTokenizer()
        for f in sorted(os.listdir(base_path)):
            if not f.endswith(".mgc") and not f.endswith(".mgc.npy"):
                continue
            bpath = join(base_path, f[: f.index(".mgc")])
            json_file = bpath + ".json"
            if not (os.path.exists(json_file) and
                    (os.path.exists(bpath + ".pitch") or os.path.exists(bpath + ".pitch.npy"))):
                continue
            with open(json_file) as jf:
                example = json.load(jf)
            durs = np.zeros(len(example["phones"]))
            for idx in example["frame2phon"]:
                durs[idx] += 1
            if len(durs) and durs.max() > MAX_PHONE_FRAMES:
                continue
            example["words_left"] = [t.word for t in tok(example.get("left_context", ""))]
            example["words_right"] = [t.word for t in tok(example.get("right_context", ""))]
            self._examples.append(example)

    def __len__(self):
        return len(self._examples)

    @staticmethod
    def _load_npy(base, ext):
        if os.path.exists(f"{base}.{ext}.npy"):
            return np.load(f"{base}.{ext}.npy")
        return np.load(f"{base}.{ext}", allow_pickle=True)

    def _make_absolute_silence(self, audio, pitch, meta):
        """Zero the audio and pitch of the leading and trailing silence phones."""
        f2p = meta["frame2phon"]
        if not f2p:
            return audio, pitch
        max_phone = max(f2p)
        for i, p in enumerate(f2p):
            if p == 0 or p == max_phone:
                audio[i * self._hop: (i + 1) * self._hop] = 0.0
                if i < len(pitch):
                    pitch[i] = 0.0
        return audio, pitch

    def __getitem__(self, item: int) -> dict:
        meta = self._examples[item]
        base = join(self._base_path, str(meta["id"]))
        mgc = self._load_npy(base, "mgc")
        pitch = np.array(self._load_npy(base, "pitch"), np.float32)
        audio, _ = read_wav(base + ".wav", target_sr=self._sr)
        audio = np.array(audio, np.float32)
        audio, pitch = self._make_absolute_silence(audio, pitch, meta)
        return {"meta": meta, "mgc": mgc, "pitch": pitch, "audio": audio}


class PhonemizerDataset:
    """The JSON list of examples that `import_phonemizer_blizzard` writes: each holds
    orig_text, phones, hybrid, words and phon2word."""

    def __init__(self, filename: str):
        with open(filename) as f:
            self._examples = json.load(f)

    def __len__(self):
        return len(self._examples)

    def __getitem__(self, i):
        return self._examples[i]


def batch_iterator(dataset, batch_size: int, collate, shuffle: bool = True, seed: int = 0,
                   drop_last: bool = False):
    """Collated batches over one epoch, in an order shuffled from `seed` (Python's
    `random`, as the JAX package shuffles, so both see the same batches)."""
    order = list(range(len(dataset)))
    if shuffle:
        random.Random(seed).shuffle(order)
    for i in range(0, len(order), batch_size):
        idx = order[i: i + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        yield collate([dataset[j] for j in idx])
