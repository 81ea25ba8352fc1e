"""StoryCube, long-form narration: counterpart of `ttscube_tpu/story.py`.

    story = StoryCube("blizzard2023")                          # a named voice, on the card
    story = StoryCube("path/to/cubegan:path/to/phonemizer", device="cpu")
    out = story("First paragraph.\\n\\nSecond paragraph.", speaker="neb")
    out["audio"]  # int16 at 24 kHz;  out["meta"]: intro, each paragraph, with times

Each paragraph (text split at blank lines) is one `TTSCube` request; the story is 5 s of
silence, each paragraph followed by 1 s of silence, and 5 s of silence, mixed on the host
with background music (tiled to the story's length) at gain 0.30, clipped to [−1, 1] and
scaled by 32700, as in the JAX class.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ttscube_tpu_torch.api import TTSCube
from ttscube_tpu_torch.utils.wavio import read_wav

SR = 24000
MUSIC_GAIN = 0.30


class StoryCube:
    """`base_model` is a `TTSCube`, a pair of local bases "path/to/cubegan:path/to/
    phonemizer", or the name of a voice (`TTSCube.load`). The default music is the named
    voice's `~/.ttscube/models/<name>/music.wav` where there is one, else 1 s of silence.
    `device` is where a cube built here runs (the card unless the CPU is asked for)."""

    def __init__(self, base_model, music_path: str | None = None, device=None):
        if isinstance(base_model, TTSCube):
            self._cube = base_model
        elif isinstance(base_model, str) and ":" in base_model:
            cubegan_base, phonemizer_base = base_model.split(":", 1)
            self._cube = TTSCube(cubegan_base, phonemizer_base, device)
        else:
            self._cube = TTSCube.load(base_model, device)
        if music_path is None and isinstance(base_model, str) and ":" not in base_model:
            music_path = str(Path.home() / ".ttscube" / "models" / base_model / "music.wav")
        self._default_music = (read_wav(music_path, target_sr=SR)[0]
                               if music_path and os.path.exists(music_path)
                               else np.zeros(SR))

    def __call__(self, text: str, speaker: str = "none",
                 background_music_path: str | None = None) -> dict:
        """{"audio": int16 samples, "meta": [{"name", "text", "start", "end"}, ...]},
        times in seconds."""
        chunks = [np.zeros(SR * 5, np.float32)]  # 5 s intro
        metadata = [{"name": "intro", "start": 0, "end": 5, "text": ""}]
        start = 5.0
        for part in text.split("\n\n"):
            audio = self._cube(part, speaker=speaker).astype(np.float32) / 32767.0
            chunks.append(audio)
            chunks.append(np.zeros(SR, np.float32))  # 1 s pause
            dur = len(audio) / SR + 1
            metadata.append({"name": "paragraph", "text": part,
                             "start": start, "end": start + dur})
            start += dur
        chunks.append(np.zeros(SR * 5, np.float32))  # 5 s outro
        voice = np.concatenate(chunks)

        music = self._default_music
        if background_music_path is not None:
            music, _ = read_wav(background_music_path, target_sr=SR)
        tiled = np.resize(music, voice.shape[0]) if len(music) else np.zeros_like(voice)
        mix = np.clip(tiled * MUSIC_GAIN + voice, -1.0, 1.0)
        return {"audio": (mix * 32700).astype(np.int16), "meta": metadata}
