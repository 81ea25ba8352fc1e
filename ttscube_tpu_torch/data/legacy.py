"""The port's copy of `ttscube_tpu/data/legacy.py`, over the port's `dsp/mulaw.py` (on
tensors; numpy in and out here) and `utils/wavio.py`.

Legacy (DyNet-era) data utilities — kept for inventory parity with the reference's
``cube/io_utils/dataset.py`` and ``cube/io_utils/encodings.py``. The live training paths
use ``data/encodings.py`` + ``data/collate.py``; these support the legacy importer
artifacts (.txt/.lab corpora) and LTS lexicon files.

(The reference's ``cube/io_utils/audio.py`` augmentation chain — broken in the
reference itself: missing imports, absent pysndfx dep, no live caller — has a WORKING
equivalent at ``data/augment.py``, opt-in via ``VocoderDataset(augment_prob=...)``.)
"""

from __future__ import annotations

from os import listdir
from os.path import isfile, join

import numpy as np

from ttscube_tpu_torch.dsp.mulaw import mulaw_decode, mulaw_encode
from ttscube_tpu_torch.utils.wavio import read_wav, write_wav


class PhoneInfo:
    """Phone + context features + HTK-style timing (reference dataset.py:~165)."""

    def __init__(self, char, context, start, stop):
        self.char = char
        self.context = context
        self.start = start
        self.stop = stop
        self.duration = stop - start


class LegacyEncodings:
    """char/context/speaker vocab with the reference's text file format
    (dataset.py:7-53: SYMBOLS/FEATURES/SPEAKERS sections)."""

    def __init__(self):
        self.char2int: dict = {}
        self.context2int: dict = {}
        self.speaker2int: dict = {}

    def update(self, pi: PhoneInfo):
        if pi.char not in self.char2int:
            self.char2int[pi.char] = len(self.char2int)
        for feature in pi.context:
            if feature.startswith("SPEAKER:"):
                if feature not in self.speaker2int:
                    self.speaker2int[feature] = len(self.speaker2int)
            elif feature not in self.context2int:
                self.context2int[feature] = len(self.context2int)

    def store(self, filename: str):
        with open(filename, "w") as f:
            for name, table in (("SYMBOLS", self.char2int),
                                ("FEATURES", self.context2int),
                                ("SPEAKERS", self.speaker2int)):
                f.write(f"{name}\t{len(table)}\n")
                for k, v in table.items():
                    f.write(f"{k}\t{v}\n")

    def load(self, filename: str):
        with open(filename, encoding="utf-8") as f:
            for table in (self.char2int, self.context2int, self.speaker2int):
                n = int(f.readline().split("\t")[1])
                for _ in range(n):
                    parts = f.readline().rstrip("\n").split("\t")
                    table[parts[0]] = int(parts[1])


class LegacyDataset:
    """Folder scan for .txt transcript bases (reference dataset.py Dataset)."""

    def __init__(self, folder: str):
        self.files = sorted(
            join(folder, f[:-4]) for f in listdir(folder)
            if isfile(join(folder, f)) and f.endswith(".txt"))


class LTSEntry:
    def __init__(self, word, transcription):
        self.word = word
        self.transcription = transcription


class LTSDataset:
    """Letter-to-sound lexicon: 'word phones...' lines, digits stripped
    (reference dataset.py LTSDataset)."""

    def __init__(self, filename: str):
        self.entries = []
        for line in open(filename):
            line = "".join(c for c in line if not c.isdigit()).strip()
            parts = line.replace("\t", " ").split(" ")
            if parts and parts[0]:
                self.entries.append(LTSEntry(parts[0].lower(), parts[1:]))


class DatasetIO:
    """Wave/codec IO + HTK label parsing (reference dataset.py:56-161)."""

    def read_wave(self, filename: str, sample_rate: int | None = None):
        return read_wav(filename, target_sr=sample_rate)

    def write_wave(self, filename: str, data, sample_rate: int):
        write_wav(filename, np.asarray(data), sample_rate)

    def read_phs(self, filename: str) -> list[PhoneInfo]:
        """HTK .phs lines: 'start stop phone' in 100 ns units."""
        out = []
        for line in open(filename):
            parts = line.strip().split(" ")
            if len(parts) >= 3:
                out.append(PhoneInfo(parts[2], [], int(parts[0]), int(parts[1])))
        return out

    def read_lab(self, filename: str) -> list[str]:
        return [l.rstrip("\n") for l in open(filename)]

    # μ-law / linear codecs (vectorized twins of dataset.py:112-161)
    def ulaw_encode(self, data):
        codes = mulaw_encode(np.asarray(data, np.float32)).numpy().astype(np.int32)
        continuous = np.sign(data) * np.log1p(255.0 * np.abs(np.asarray(data))) / np.log1p(255.0)
        return [codes.tolist(), np.clip(continuous, -1, 1).tolist()]

    def ulaw_decode(self, data, discreete: bool = True):
        if discreete:
            return mulaw_decode(np.asarray(data)).numpy().tolist()
        x = np.asarray(data, np.float32)
        return (np.sign(x) * (np.power(256.0, np.abs(x)) - 1.0) / 255.0).tolist()

    def b16_enc(self, data):
        return np.clip((np.asarray(data) + 1.0) * 32767, 0, 65535).astype(int).tolist()

    def b16_dec(self, data, discreete: bool = True):
        return (np.asarray(data, np.float32) / 32768 - 1.0).tolist()

    def b16_to_float(self, data, discreete: bool = True):
        return (np.asarray(data, np.float32) / 32768).tolist()
