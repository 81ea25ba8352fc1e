"""TTSCube, the synthesis API: counterpart of `ttscube_tpu/api.py::TTSCube`.

    cube = TTSCube("path/to/cubegan", "path/to/phonemizer")           # on the card
    cube = TTSCube("path/to/cubegan", "path/to/phonemizer", device="cpu")
    cube = TTSCube.load("blizzard2023")   # a named voice from ~/.ttscube/models
    audio_int16 = cube("Hello world!", speaker="neb")

Steps, as in the JAX class: text → aligned phonemizer → collate → duration pass (the
total frame count comes back to the host) → frame bucket (multiples of FRAME_BUCKET,
at most MAX_FRAMES) → Cubegan.infer at that bucket → trim to total·hop → int16.

Each request is a tree of program spans (`utils/profiling.span`), `tts.api.request#<n>`
at its top, and counts `api.requests`; `shapes.new.text` and `shapes.new.gen` rise when
a request meets an input shape that no earlier call, warmup's among them, met.

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

LM-conditioned voices, as in the JAX class: the yaml's `conditioning` spec names the
kind. A fastText voice reads its word vectors from `<model>.wordvec.npz` (export_model
`--wordvec`); an HF voice builds its encoder from the yaml's `lm_config`, loads it from
the `.model` file's `hf` subtree, and tokenizes each request's words with the tokenizer
of `<model>.hf/` or of the spec's directory (`utils/hfcond.py`). Its warmup also runs the
encoder at each token window a request can reach.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ttscube_tpu_torch import resolve_device
from ttscube_tpu_torch.convert import load_jax_params, read_msgpack
from ttscube_tpu_torch.data.collate import HF_MAX_TOKENS, CubeganCollate
from ttscube_tpu_torch.data.encodings import CubeganEncodings, PhonemizerEncodings
from ttscube_tpu_torch.data.text import Text2FeatBlizzard
from ttscube_tpu_torch.models.cubegan import Cubegan, CubeganConfig, batch_to_torch
from ttscube_tpu_torch.models.hifigan import HifiganConfig
from ttscube_tpu_torch.models.languasito import LanguasitoConfig
from ttscube_tpu_torch.models.lm import LMConfig
from ttscube_tpu_torch.models.phonemizer import Phonemizer, PhonemizerConfig
from ttscube_tpu_torch.utils import config_io, repository
from ttscube_tpu_torch.utils.profiling import count, span

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
    cond_type = cond_type.split(":")[0] if cond_type else None
    lm_config = lm_config_from_yaml(conf)
    hifi = {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v)
                if isinstance(v, list) else v)
            for k, v in (conf.get("hifigan") or {}).items()
            if k not in IGNORED_HIFIGAN_KEYS}
    hifi.setdefault("fused_tail", True)
    hifi.setdefault("storage_dtype", "bfloat16")
    return CubeganConfig(
        languasito=LanguasitoConfig(
            num_phones=len(encodings.phon2int), num_speakers=len(encodings.speaker2int),
            max_pitch=encodings.max_pitch, max_duration=encodings.max_duration,
            cond_type=cond_type,
            lm_dim=lm_config.hidden_size if lm_config is not None else None),
        hifigan=HifiganConfig(**hifi),
        sample_rate=conf.get("sample_rate", 24000),
        hop_size=conf.get("hop_size", 240))


def lm_config_from_yaml(conf: dict) -> LMConfig | None:
    """The HF encoder's config of an HF-conditioned checkpoint (its yaml's `lm_config`),
    else None."""
    spec = conf.get("conditioning") or ""
    return LMConfig(**conf["lm_config"]) if spec.split(":")[0] == "hf" else None


def conditioning_frontends(model_path: str, cond_type) -> tuple:
    """(word_embedder, hf_frontend) of a voice: the word vectors of a fastText voice,
    `<model_path>.wordvec.npz`; the tokenizer front end of an HF voice."""
    if cond_type == "fasttext":
        from ttscube_tpu_torch.utils.wordvec import WordVectors

        wv_path = model_path + ".wordvec.npz"
        if not os.path.exists(wv_path):
            raise FileNotFoundError(
                f"model is fasttext-conditioned but '{wv_path}' is missing — "
                "re-export with scripts/export_model.py --wordvec <table>")
        return WordVectors.load_npz(wv_path), None
    if cond_type == "hf":
        from ttscube_tpu_torch.utils.hfcond import HFCondFrontend

        return None, HFCondFrontend.from_packaged(model_path)
    return None, None


def phonemizer_config(penc: PhonemizerEncodings) -> PhonemizerConfig:
    return PhonemizerConfig(num_graphemes=len(penc.graphemes),
                            num_phonemes=len(penc.phonemes))


class TTSCube:
    def __init__(self, model_path: str, phonemizer_path: str, device=None):
        encodings = CubeganEncodings(model_path + ".encodings")
        conf = config_io.load(model_path + ".yaml") or {}
        config = config_from_yaml(conf, encodings)
        penc = PhonemizerEncodings(phonemizer_path + ".encodings")
        tree = read_msgpack(model_path + ".model")
        model = load_jax_params(Cubegan(config, lm_config=lm_config_from_yaml(conf)),
                                {k: tree[k] for k in ("lang", "gen", "hf") if k in tree})
        pmodel = load_jax_params(Phonemizer(phonemizer_config(penc)),
                                 read_msgpack(phonemizer_path + ".model"))
        self._setup(config, encodings, penc, model, pmodel, device,
                    *conditioning_frontends(model_path, config.languasito.cond_type))

    @classmethod
    def from_state_dicts(cls, config: CubeganConfig, encodings: CubeganEncodings,
                         phonemizer_encodings: PhonemizerEncodings, model_state: dict,
                         phonemizer_state: dict, device=None) -> "TTSCube":
        """Build from configs and state dicts of `Cubegan` and `Phonemizer` (a voice
        without LM conditioning)."""
        model = Cubegan(config)
        model.load_state_dict(model_state, strict=True)
        pmodel = Phonemizer(phonemizer_config(phonemizer_encodings))
        pmodel.load_state_dict(phonemizer_state, strict=True)
        self = cls.__new__(cls)
        self._setup(config, encodings, phonemizer_encodings, model, pmodel, device)
        return self

    @staticmethod
    def load(model_name: str, device=None) -> "TTSCube":
        """The named voice from `~/.ttscube/models/<model_name>`: its volumes are
        fetched and unpacked there first (`utils/repository.download_model`) only where
        `cubegan.model` is missing."""
        base = Path.home() / ".ttscube" / "models" / model_name
        device = resolve_device(device)  # raises before any fetch where CUDA is missing
        if not (base / "cubegan.model").exists():
            base.mkdir(parents=True, exist_ok=True)
            repository.download_model(str(base), model_name)
        return TTSCube(str(base / "cubegan"), str(base / "phonemizer"), device)

    def _setup(self, config, encodings, penc, model, pmodel, device, word_embedder=None,
               hf_frontend=None):
        self.device = resolve_device(device)
        self.config = config
        self.encodings = encodings
        self.model = model.to(self.device).eval()
        pmodel.to(self.device).eval()
        self.text2feat = Text2FeatBlizzard(penc, pmodel, self.device)
        self.hf_frontend = hf_frontend
        # the word axis is bucketed as in the JAX API, so both see the same inputs
        self.collate = CubeganCollate(encodings, word_embedder=word_embedder,
                                      hop=config.hop_size,
                                      hf_conditioning=hf_frontend is not None,
                                      bucket_words=8)

    def _prepare(self, text: str, speaker: str) -> dict:
        """text → phonemize → collate → the model's input tensors on the device (every
        `x_` array of the collate: with LM conditioning `x_words`, or the token window
        `x_tok_ids`, `x_tok_mask`, `x_word2tok`)."""
        with span("tts.api.phonemize"):
            meta = self.text2feat(text)
        meta["speaker"] = speaker
        meta["frame2phon"] = [0]  # placeholder; free synthesis predicts durations
        with span("tts.api.collate"):
            if self.hf_frontend is not None:
                meta = self.hf_frontend(meta)
            example = {"meta": meta, "mgc": np.zeros((8, 80), np.float32),
                       "pitch": np.zeros((8,), np.float32)}
            X = self.collate([example])
            return batch_to_torch({k: v for k, v in X.items() if k.startswith("x_")},
                                  self.device)

    @torch.inference_mode()
    def _frames(self, X) -> int:
        with span("tts.api.durations"):
            total = int(self.model.durations(X).sum().item())
        return max(total, 1)  # all-unknown phones predict 0 frames: one frame of silence

    def frames(self, text: str, speaker: str = "none") -> int:
        """The duration pass alone: how many frames `text` will be synthesized to."""
        return self._frames(self._prepare(text, speaker))

    @torch.inference_mode()
    def synthesize(self, text: str, speaker: str = "none"):
        """(audio fp32 of length total·hop, total predicted frames). The request is the
        span `tts.api.request#<n>` (n counts `api.requests`) around `tts.api.phonemize`,
        `tts.api.collate`, `tts.api.durations`, `tts.infer#…` and `tts.api.to_host`."""
        with span("tts.api.request", count("api.requests")):
            X = self._prepare(text, speaker)
            total = self._frames(X)
            bucket = int(np.clip(((total + FRAME_BUCKET - 1) // FRAME_BUCKET) * FRAME_BUCKET,
                                 FRAME_BUCKET, MAX_FRAMES))
            audio, _ = self.model.infer(X, max_frames=bucket)
            return self._to_host(audio, total), total

    def _to_host(self, audio, total: int) -> np.ndarray:
        """The first item's audio of `total` frames, fp32 on the host."""
        with span("tts.api.to_host"):
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
        4, ..., 512 characters (`_warm_phonemizer`), and an HF voice's encoder at each
        token window the collate can give a request (`_warm_lm`). A server calls it once
        at start-up."""
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
        self._warm_lm()

    def _warm_lm(self) -> None:
        """The HF encoder alone on one window of each token bucket up to
        HF_MAX_TOKENS: cuBLAS picks its kernels by shape, and CUDA loads a kernel's
        module at its first launch."""
        if not hasattr(self.model, "hf"):
            return
        step = self.collate.bucket_tokens
        for n in range(step, HF_MAX_TOKENS + 1, step):
            ids = torch.ones(1, n, dtype=torch.int64, device=self.device)
            self.model.hf(ids, torch.ones(1, n, dtype=torch.bool, device=self.device))

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
