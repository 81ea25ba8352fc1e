from ttscube_tpu_torch.dsp.mel import (
    MelSpec,
    feature_mel_config,
    gan_mel_config,
    hz_to_mel,
    mel_filterbank,
    mel_to_hz,
    preemphasis,
)
from ttscube_tpu_torch.dsp.mulaw import mulaw_decode, mulaw_encode

__all__ = [
    "MelSpec",
    "feature_mel_config",
    "gan_mel_config",
    "mel_filterbank",
    "hz_to_mel",
    "mel_to_hz",
    "preemphasis",
    "mulaw_encode",
    "mulaw_decode",
]
