"""Training corpora on disk, host-side numpy: the port's copies of
`ttscube_tpu/data/datasets.py::CubeganDataset`, `PhonemizerDataset`, `VocoderDataset`
and `batch_iterator`.

A corpus folder holds per-utterance `{id}.{mgc,pitch,json,wav}` files, as the JAX
package's importers write them; the phonemizer's data is one JSON list per split. With
an HF tokenizer (`hf_tokenizer`, for HF conditioning) each example's words and its left
and right context are pre-tokenized, and an example whose token windows cannot be used
is dropped (`_hf_example_valid`). The vocoder's data is a folder of wavs.
"""

from __future__ import annotations

import json
import os
import random
from os import listdir
from os.path import isfile, join

import numpy as np

from ttscube_tpu_torch.data.collate import HF_MAX_TOKENS
from ttscube_tpu_torch.data.text import SimpleTokenizer
from ttscube_tpu_torch.utils.wavio import read_wav

MAX_PHONE_FRAMES = 400  # drop utterances with any phone longer than this


def _hf_example_valid(example: dict) -> bool:
    """Each of the three token windows under HF_MAX_TOKENS tokens, and every word2tok
    entry inside its token list."""
    for key in ("words_hf", "words_left_hf", "words_right_hf"):
        part = example[key]
        if len(part["tok_ids"]) >= HF_MAX_TOKENS:
            return False
        for w, t in part["word2tok"].items():
            if t < 0 or t >= len(part["tok_ids"]):
                return False
    return True


class CubeganDataset:
    """Scans a folder of per-utterance {id}.{mgc,pitch,json,wav} artifacts."""

    def __init__(self, base_path: str, hf_tokenizer=None, hop_size: int = 240,
                 sample_rate: int = 24000):
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
            if hf_tokenizer is not None:
                example["words_hf"] = hf_tokenizer(example["words"])
                example["words_left_hf"] = hf_tokenizer(example["words_left"])
                example["words_right_hf"] = hf_tokenizer(example["words_right"])
                if not _hf_example_valid(example):
                    continue
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


class VocoderDataset:
    """A folder of wavs (each larger than max(4096, 2·max_segment_size) bytes) →
    (audio at `target_sample_rate`, audio at `lowres_sample_rate`, log10 mel) examples,
    each a random hop-aligned crop of `max_segment_size` samples, or its head where
    `random_start` is off.

    The features are cached in `cache_dir` per file: the audio peak-normalized to 0.98,
    its low-rate twin, and its mel (`dsp/mel.py`, `feature_mel_config`), computed in fp64
    on `device` and rounded once, as the port's importer computes it. The crop offsets
    come from a numpy Generator seeded with `crop_seed`, not Python's global `random`.
    With `augment_prob` > 0 the crop goes through `data/augment.alter` (draws from a
    Generator seeded with `augment_seed`) and its low-rate twin and mel are recomputed
    from the altered samples."""

    def __init__(self, path: str, target_sample_rate: int = 24000,
                 lowres_sample_rate: int = 2400, max_segment_size: int = -1,
                 random_start: bool = True, hop_size: int = 240,
                 cache_dir: str = "data/cache", augment_prob: float = 0.0,
                 noise_dir: str | None = None, augment_seed: int = 0, crop_seed: int = 0,
                 device="cpu"):
        from ttscube_tpu_torch.dsp.mel import MelSpec, feature_mel_config

        self._sr = target_sample_rate
        self._sr_low = lowres_sample_rate
        self._max_segment = max_segment_size
        self._random_start = random_start
        self._hop = hop_size
        self._cache = cache_dir
        self._device = device
        self._augment_prob = augment_prob
        self._augment_rng = np.random.default_rng(augment_seed)
        self._crop_rng = np.random.default_rng(crop_seed)
        self._noise_files = []
        if noise_dir and os.path.isdir(noise_dir):
            self._noise_files = [join(noise_dir, f) for f in sorted(listdir(noise_dir))
                                 if f.endswith(".wav")]
        os.makedirs(cache_dir, exist_ok=True)
        self._melspec = MelSpec(feature_mel_config(target_sample_rate, hop_length=hop_size))
        self._examples = [join(path, f) for f in sorted(listdir(path))
                          if isfile(join(path, f)) and f.endswith(".wav")
                          and os.stat(join(path, f)).st_size > max(4096, max_segment_size * 2)]

    def __len__(self):
        return len(self._examples)

    def _mel(self, wav: np.ndarray) -> np.ndarray:
        import torch

        return self._melspec(torch.from_numpy(np.asarray(wav, np.float32)).to(self._device),
                             torch.float64).cpu().numpy()

    def __getitem__(self, item):
        from ttscube_tpu_torch.utils.wavio import resample

        filename = self._examples[item]
        cache = join(self._cache, filename.replace("/", "_").replace("\\", "_"))
        if os.path.exists(cache + ".mgc.npy"):
            mel = np.load(cache + ".mgc.npy")
            wav = np.load(cache + ".audio.npy")
            wav_low = np.load(cache + ".audio_low.npy")
        else:
            wav, _ = read_wav(filename, target_sr=self._sr)
            peak = np.max(np.abs(wav)) or 1.0
            wav = wav / peak * 0.98
            wav_low = resample(wav, self._sr, self._sr_low)
            mel = self._mel(wav)
            np.save(cache + ".mgc", mel)
            np.save(cache + ".audio", wav)
            np.save(cache + ".audio_low", wav_low)
        hs = self._sr // self._sr_low
        if self._max_segment == -1 or len(wav) < self._max_segment or not self._random_start:
            if not self._random_start and self._max_segment != -1 and len(wav) > self._max_segment:
                return self._augmented(wav[: self._max_segment],
                                       wav_low[: self._max_segment // hs],
                                       mel[: self._max_segment // self._hop + 1])
            return self._augmented(wav, wav_low, mel)
        # randint(0, n) inclusive, as Python's `random.randint` in the JAX package
        start = int(self._crop_rng.integers(0, len(wav) - self._max_segment - 1,
                                            endpoint=True))
        start = start // self._hop * self._hop
        stop = start + self._max_segment
        return self._augmented(
            wav[start:stop],
            wav_low[start // hs: start // hs + self._max_segment // hs],
            mel[start // self._hop: stop // self._hop + 1])

    def _augmented(self, wav, wav_low, mel):
        if self._augment_prob <= 0.0:
            return wav, wav_low, mel
        from ttscube_tpu_torch.data.augment import alter
        from ttscube_tpu_torch.utils.wavio import resample

        aug = alter(wav, self._augment_rng, self._sr, prob=self._augment_prob,
                    noise_files=self._noise_files)
        if aug is wav:
            return wav, wav_low, mel
        return (aug, resample(aug, self._sr, self._sr_low), self._mel(aug)[: len(mel)])


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
