"""The port's copy of the JSON encodings of `ttscube_tpu/data/encodings.py`: the
vocabularies and stats a trained model was built with, read from the same files.
Standard library only. Building and saving encodings stays with the JAX package's
training tools."""

from __future__ import annotations

import json


class CubeganEncodings:
    def __init__(self, filename: str | None = None):
        self.speaker2int: dict[str, int] = {}
        self.phon2int: dict[str, int] = {}
        self.max_duration = 0
        self.max_pitch = 0
        if filename is not None:
            self.load(filename)

    def load(self, filename: str):
        with open(filename) as f:
            obj = json.load(f)
        self.speaker2int = obj["speaker2int"]
        self.phon2int = obj["phon2int"]
        self.max_pitch = obj["max_pitch"]
        self.max_duration = obj["max_duration"]


class PhonemizerEncodings:
    def __init__(self, filename: str | None = None):
        self.grapheme2int: dict[str, int] = {}
        self.phon2int: dict[str, int] = {}
        if filename is not None:
            self.load(filename)

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
