"""Cubegan inference, counterpart of `ttscube_tpu/models/cubegan.py` (`CubeganConfig`,
`Cubegan.infer`). The discriminators, optimizers and the GAN train step wait for the
training slice; so do LM conditioning and chunked generation."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ttscube_tpu_torch.models.hifigan import Generator, HifiganConfig
from ttscube_tpu_torch.models.hifigan_fused import generator_apply_fused
from ttscube_tpu_torch.models.languasito import Languasito2, LanguasitoConfig


@dataclasses.dataclass(frozen=True)
class CubeganConfig:
    languasito: LanguasitoConfig
    hifigan: HifiganConfig = HifiganConfig()
    sample_rate: int = 24000
    hop_size: int = 240


class Cubegan(nn.Module):
    """Text tower (`lang`) and generator (`gen`); the parameter names mirror the JAX
    tree {"lang": ..., "gen": ...}."""

    def __init__(self, config: CubeganConfig):
        super().__init__()
        self.config = config
        self.lang = Languasito2(config.languasito)
        self.gen = Generator(config.hifigan)

    @torch.inference_mode()
    def infer(self, X, max_frames: int):
        """Free synthesis: (audio (B, max_frames·hop) fp32, aux dict)."""
        cond, aux = self.lang.infer(X, max_frames)
        h = self.config.hifigan
        if h.fused_tail:
            audio = generator_apply_fused(
                self.gen, cond, h, compute_dtype=h.torch_compute_dtype,
                storage_dtype=h.torch_storage_dtype, fuse_channels=h.fuse_channels)
        else:
            audio = self.gen(cond)
        return audio, aux
