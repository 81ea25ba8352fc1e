"""TTSCube, the synthesis API: counterpart of `ttscube_tpu/api.py::TTSCube`.

    cube = TTSCube("path/to/cubegan", "path/to/phonemizer")           # on the card
    cube = TTSCube("path/to/cubegan", "path/to/phonemizer", device="cpu")
    audio_int16 = cube("Hello world!", speaker="neb")

Steps, as in the JAX class: text → aligned phonemizer → collate → duration pass (the
total frame count comes back to the host) → frame bucket (multiples of FRAME_BUCKET,
at most MAX_FRAMES) → Cubegan.infer at that bucket → trim to total·hop → int16.

`TTSCube.warmup()` runs the whole path of a request, the audio's copy to the host and
its int16 conversion included, once for each pair of text length and frame bucket it is
given, so that a server's first requests do not pay for what a first call sets up on
the card: the kernels' build (nvcc, at their first launch), the packed stage weights of
the fused generator (`Generator.stage_weights`), cuDNN's handles and algorithm choices,
the caching allocator's blocks, the first copies back to the host, and the modules of
the phonemizer's kernels at each range of text lengths.

`TTSCube(model_path, phonemizer_path)` reads the JAX package's files (`.yaml`,
`.encodings`, flax msgpack `.model`) with the port's own readers
(`utils/config_io.py`, `utils/serialization.py`), so it needs neither yaml nor msgpack;
`TTSCube.from_state_dicts` builds the same object from configs and state dicts.
"""

from __future__ import annotations

import numpy as np
import torch

from ttscube_tpu_torch import resolve_device
from ttscube_tpu_torch.convert import load_jax_params, read_msgpack
from ttscube_tpu_torch.data.collate import CubeganCollate
from ttscube_tpu_torch.data.encodings import CubeganEncodings, PhonemizerEncodings
from ttscube_tpu_torch.data.text import Text2FeatBlizzard
from ttscube_tpu_torch.models.cubegan import Cubegan, CubeganConfig
from ttscube_tpu_torch.models.hifigan import HifiganConfig
from ttscube_tpu_torch.models.languasito import LanguasitoConfig
from ttscube_tpu_torch.models.phonemizer import Phonemizer, PhonemizerConfig
from ttscube_tpu_torch.utils import config_io

FRAME_BUCKET = 256
MAX_FRAMES = 8192
CHAR_BUCKET = 32
# keys of the JAX package's HifiganConfig that a checkpoint's yaml may hold and that
# change no value here: `fold_narrow` and `polyphase_channels` choose exact layout
# transforms for the TPU, `fused_train_max_batch` a batch cap measured on the TPU
IGNORED_HIFIGAN_KEYS = ("fused_train_max_batch", "fold_narrow", "polyphase_channels")


def config_from_yaml(conf: dict, encodings: CubeganEncodings) -> CubeganConfig:
    """The CubeganConfig the JAX TTSCube builds from a checkpoint's yaml, with the
    serving defaults (fused tail, bf16 storage) unless the yaml opts out. The hifigan
    keys in `IGNORED_HIFIGAN_KEYS` are accepted and dropped."""
    cond_type = conf.get("conditioning")
    if cond_type:
        raise NotImplementedError("LM-conditioned models are not ported yet")
    hifi = {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v)
                if isinstance(v, list) else v)
            for k, v in (conf.get("hifigan") or {}).items()
            if k not in IGNORED_HIFIGAN_KEYS}
    hifi.setdefault("fused_tail", True)
    hifi.setdefault("storage_dtype", "bfloat16")
    return CubeganConfig(
        languasito=LanguasitoConfig(
            num_phones=len(encodings.phon2int), num_speakers=len(encodings.speaker2int),
            max_pitch=encodings.max_pitch, max_duration=encodings.max_duration),
        hifigan=HifiganConfig(**hifi),
        sample_rate=conf.get("sample_rate", 24000),
        hop_size=conf.get("hop_size", 240))


def phonemizer_config(penc: PhonemizerEncodings) -> PhonemizerConfig:
    return PhonemizerConfig(num_graphemes=len(penc.graphemes),
                            num_phonemes=len(penc.phonemes))


class TTSCube:
    def __init__(self, model_path: str, phonemizer_path: str, device=None):
        encodings = CubeganEncodings(model_path + ".encodings")
        config = config_from_yaml(config_io.load(model_path + ".yaml") or {}, encodings)
        penc = PhonemizerEncodings(phonemizer_path + ".encodings")
        tree = read_msgpack(model_path + ".model")
        model = load_jax_params(Cubegan(config), {"lang": tree["lang"], "gen": tree["gen"]})
        pmodel = load_jax_params(Phonemizer(phonemizer_config(penc)),
                                 read_msgpack(phonemizer_path + ".model"))
        self._setup(config, encodings, penc, model, pmodel, device)

    @classmethod
    def from_state_dicts(cls, config: CubeganConfig, encodings: CubeganEncodings,
                         phonemizer_encodings: PhonemizerEncodings, model_state: dict,
                         phonemizer_state: dict, device=None) -> "TTSCube":
        """Build from configs and state dicts of `Cubegan` and `Phonemizer`."""
        model = Cubegan(config)
        model.load_state_dict(model_state, strict=True)
        pmodel = Phonemizer(phonemizer_config(phonemizer_encodings))
        pmodel.load_state_dict(phonemizer_state, strict=True)
        self = cls.__new__(cls)
        self._setup(config, encodings, phonemizer_encodings, model, pmodel, device)
        return self

    def _setup(self, config, encodings, penc, model, pmodel, device):
        self.device = resolve_device(device)
        self.config = config
        self.encodings = encodings
        self.model = model.to(self.device).eval()
        pmodel.to(self.device).eval()
        self.text2feat = Text2FeatBlizzard(penc, pmodel, self.device)
        # the word axis is bucketed as in the JAX API, so both see the same inputs
        self.collate = CubeganCollate(encodings, hop=config.hop_size, bucket_words=8)

    def _prepare(self, text: str, speaker: str) -> dict:
        """text → phonemize → collate → the model's input tensors on the device."""
        meta = self.text2feat(text)
        meta["speaker"] = speaker
        meta["frame2phon"] = [0]  # placeholder; free synthesis predicts durations
        example = {"meta": meta, "mgc": np.zeros((8, 80), np.float32),
                   "pitch": np.zeros((8,), np.float32)}
        X = self.collate([example])
        return {k: torch.from_numpy(np.asarray(v, np.int64)).to(self.device)
                for k, v in X.items() if k in ("x_char", "x_speaker", "x_phon2word")}

    @torch.inference_mode()
    def _frames(self, X) -> int:
        total = int(self.model.lang.durations(X).sum().item())
        return max(total, 1)  # all-unknown phones predict 0 frames: one frame of silence

    def frames(self, text: str, speaker: str = "none") -> int:
        """The duration pass alone: how many frames `text` will be synthesized to."""
        return self._frames(self._prepare(text, speaker))

    @torch.inference_mode()
    def synthesize(self, text: str, speaker: str = "none"):
        """(audio fp32 of length total·hop, total predicted frames)."""
        X = self._prepare(text, speaker)
        total = self._frames(X)
        bucket = int(np.clip(((total + FRAME_BUCKET - 1) // FRAME_BUCKET) * FRAME_BUCKET,
                             FRAME_BUCKET, MAX_FRAMES))
        audio, _ = self.model.infer(X, max_frames=bucket)
        return self._to_host(audio, total), total

    def _to_host(self, audio, total: int) -> np.ndarray:
        """The first item's audio of `total` frames, fp32 on the host."""
        return audio[0, : total * self.config.hop_size].float().cpu().numpy()

    @staticmethod
    def _int16(audio: np.ndarray) -> np.ndarray:
        return np.asarray(np.clip(audio, -1, 1) * 32767, dtype=np.int16)

    @torch.inference_mode()
    def warmup(self, frame_buckets=(FRAME_BUCKET, 2 * FRAME_BUCKET),
               char_lens=(CHAR_BUCKET, 2 * CHAR_BUCKET), speaker: str = "none") -> None:
        """Run what a request runs once for each text length in `char_lens` and each
        frame bucket in `frame_buckets`: the real text → phonemizer → collate path, as
        the JAX TTSCube.warmup does, the duration pass, synthesis, and the audio's copy
        to the host and its int16 conversion; then the phonemizer alone on texts of 2,
        4, ..., 512 characters (`_warm_phonemizer`). A server calls it once at start-up."""
        for n in char_lens:
            # about n characters of short words: the aligned phonemizer maps characters
            # about one to one, so the phone axis lands near the n-phone collate bucket
            text = " ".join("ab" for _ in range(max(1, n // 3)))[: max(n - 1, 2)]
            X = self._prepare(text, speaker)
            total = self._frames(X)
            for b in frame_buckets:
                audio, _ = self.model.infer(X, max_frames=b)
                self._int16(self._to_host(audio, min(total, b)))
        self._warm_phonemizer()

    def _warm_phonemizer(self, longest: int = 512) -> None:
        """The phonemizer alone on one text of each power of two characters up to
        `longest`. It runs on each text's exact length, as in the JAX API; on the card
        each range of lengths picks cuDNN kernels of its own, whose modules CUDA loads
        at their first launch (fault C7, PERF.md §5)."""
        n = 2
        while n <= longest:
            self.text2feat("a" * n)
            n *= 2

    def __call__(self, text: str, speaker: str = "none") -> np.ndarray:
        audio, _ = self.synthesize(text, speaker)
        return self._int16(audio)
