"""The port's copy of the JSON encodings of `ttscube_tpu/data/encodings.py`: the
vocabularies and stats a trained model was built with, in the same files. The trainers
compute `CubeganEncodings` (`TextcoderEncodings` is the same class) and
`PhonemizerEncodings` from their train sets and save them; the files are the JAX
package's, byte for byte."""

from __future__ import annotations

import json
import os

import numpy as np


def _open_w(filename: str):
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    return open(filename, "w")


class CubeganEncodings:
    def __init__(self, filename: str | None = None):
        self.speaker2int: dict[str, int] = {}
        self.phon2int: dict[str, int] = {}
        self.max_duration = 0
        self.max_pitch = 0
        if filename is not None:
            self.load(filename)

    def compute(self, dataset):
        """Scan a dataset of examples with meta{speaker, phones, frame2phon} + pitch."""
        for example in dataset:
            meta = example["meta"]
            if meta["speaker"] not in self.speaker2int:
                self.speaker2int[meta["speaker"]] = len(self.speaker2int)
            for phone in meta["phones"]:
                if phone not in self.phon2int:
                    self.phon2int[phone] = len(self.phon2int)
            if len(example["pitch"]):
                self.max_pitch = max(self.max_pitch, float(np.max(example["pitch"])))
            durs = np.zeros(len(meta["phones"]), dtype=np.int64)
            for idx in meta["frame2phon"]:
                durs[idx] += 1
            if len(durs):
                self.max_duration = max(self.max_duration, int(np.max(durs)))

    def load(self, filename: str):
        with open(filename) as f:
            obj = json.load(f)
        self.speaker2int = obj["speaker2int"]
        self.phon2int = obj["phon2int"]
        self.max_pitch = obj["max_pitch"]
        self.max_duration = obj["max_duration"]

    def save(self, filename: str):
        with _open_w(filename) as f:
            json.dump({"speaker2int": self.speaker2int, "phon2int": self.phon2int,
                       "max_duration": int(self.max_duration),
                       "max_pitch": int(self.max_pitch)}, f)


# Textcoder's vocabularies have Cubegan's schema
TextcoderEncodings = CubeganEncodings


class PhonemizerEncodings:
    def __init__(self, filename: str | None = None):
        self.grapheme2int: dict[str, int] = {}
        self.phon2int: dict[str, int] = {}
        if filename is not None:
            self.load(filename)

    def compute(self, examples):
        """Graphemes (lower-cased) of `orig_text` and phones of `phones`, each from id 1
        in order of first sight; id 0 is PAD."""
        self.phon2int = {"PAD": 0}
        self.grapheme2int = {"PAD": 0}
        for example in examples:
            for g in example["orig_text"]:
                g = g.lower()
                if g not in self.grapheme2int:
                    self.grapheme2int[g] = len(self.grapheme2int)
            for p in example["phones"]:
                if p not in self.phon2int:
                    self.phon2int[p] = len(self.phon2int)

    @property
    def phonemes(self):
        return self.phon2int

    @property
    def graphemes(self):
        return self.grapheme2int

    def load(self, filename: str):
        with open(filename) as f:
            obj = json.load(f)
        self.grapheme2int = obj["grapheme2int"]
        self.phon2int = obj["phon2int"]

    def save(self, filename: str):
        with _open_w(filename) as f:
            json.dump({"grapheme2int": self.grapheme2int, "phon2int": self.phon2int}, f)
