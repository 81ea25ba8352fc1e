"""Devset synthesis and spectrogram images: counterpart of
`ttscube_tpu/train/runtime.py`'s `cubegan_synthesize_dataset` (the Cubegan trainer's
epoch hook), `synthesize_devset` (Textcoder's mel through a HiFi-GAN generator) and
`render_spectrogram` (the corpus importer's PNG). Not ported:
`synthesize_from_checkpoint`."""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np
import torch

from ttscube_tpu_torch.models.cubegan import batch_to_torch
from ttscube_tpu_torch.utils.ranks import is_writer
from ttscube_tpu_torch.utils.wavio import write_wav


def cubegan_synthesize_dataset(model, dataset, collate, output_path: str, limit: int = -1,
                               free: bool = True, max_frames: int = 2048,
                               speaker: str | None = None):
    """Synthesize a devset to `{id}.wav` files with the port's Cubegan `model`.

    `free=True` predicts durations and pitch (`Cubegan.infer`) and trims the audio to
    the predicted frames; `free=False` is forced synthesis from the batch's alignment
    (`Cubegan.forward`), trimmed to the example's real frames (the collate pads the
    frame axis to its bucket)."""
    os.makedirs(output_path, exist_ok=True)
    device = next(model.parameters()).device
    hop = model.config.hop_size
    n = len(dataset) if limit == -1 else min(limit, len(dataset))
    for i in range(n):
        example = dataset[i]
        if speaker is not None:
            example["meta"]["speaker"] = speaker
        batch = batch_to_torch(collate([example]), device)
        if free:
            X = {k: v for k, v in batch.items() if k.startswith("x_")}
            audio, aux = model.infer(X, max_frames=max_frames)
            frames = int(aux["frame_mask"][0].sum())
        else:
            audio = model(batch)
            frames = int(batch["n_frames"][0]) if "n_frames" in batch else \
                int(batch["y_frame_mask"][0].sum())
        audio = audio[0, : frames * hop].float().cpu().numpy()
        if is_writer():  # over a mesh every rank synthesizes (a collective), rank 0 writes
            write_wav(os.path.join(output_path, f"{example['meta']['id']}.wav"),
                      np.asarray(audio), model.config.sample_rate)


def synthesize_devset(textcoder, generator, dataset, collate, output_path: str,
                      forced_synthesis: bool = True, limit: int = -1, max_frames: int = 1024,
                      sample_rate: int = 24000, seed: int = 0, masks=None) -> list:
    """Textcoder's post-net mel → HiFi-GAN `generator` (the plain `models/hifigan.py`
    Generator, as the JAX function applies flax's) for each of the first `limit`
    utterances of `dataset`, writing `{id}.png` (`render_spectrogram`) and `{id}.wav`.

    Forced synthesis runs the teacher-forced pass on the utterance's own mel and
    alignment (the PostNet on its running averages); free synthesis `infer`s up to
    `max_frames` frames. The features are log10 mel, the generator takes natural-log
    mel: the mel is multiplied by ln 10 before vocoding. The PreNet masks of utterance i
    come from `crop_generator(seed, i)`, or `masks[i]` where given. Returns the mels
    (numpy, (frames, 80)) in order."""
    from ttscube_tpu_torch.models.cubegan import crop_generator

    os.makedirs(output_path, exist_ok=True)
    device = next(textcoder.parameters()).device
    n = len(dataset) if limit == -1 else min(limit, len(dataset))
    ln10 = math.log(10.0)
    textcoder.eval()
    mels = []
    with torch.no_grad():
        for i in range(n):
            example = dataset[i]
            batch = batch_to_torch(collate([example]), device)
            m = None if masks is None else [t.to(device) for t in masks[i]]
            gen = crop_generator(seed, i)
            if forced_synthesis:
                mel = textcoder(batch, train=False, masks=m, generator=gen)[3]
            else:
                X = {k: v for k, v in batch.items() if k.startswith("x_")}
                mel, _ = textcoder.infer(X, max_frames=max_frames, masks=m, generator=gen)
            mel_np = mel[0].float().cpu().numpy()
            mels.append(mel_np)
            render_spectrogram(mel_np, os.path.join(output_path, f"{example['meta']['id']}.png"))
            audio = generator(mel * ln10)[0].float().cpu().numpy()
            write_wav(os.path.join(output_path, f"{example['meta']['id']}.wav"), audio,
                      sample_rate)
    return mels


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def render_spectrogram(mgc: np.ndarray, output_file: str):
    """(T, n_mels) → a grey 8-bit RGB PNG, T wide and n_mels high, low bands at the
    bottom: the pixels of the JAX function's image, written with the standard library
    (zlib, struct) in place of PIL."""
    mgc = np.asarray(mgc, np.float32)
    lo, hi = float(mgc.min()), float(mgc.max())
    norm = (mgc - lo) / max(hi - lo, 1e-9)
    gray = (norm.T[::-1] * 255).astype(np.uint8)  # (mels, T), flipped
    rgb = np.repeat(gray[:, :, None], 3, axis=2)
    rows = np.concatenate([np.zeros((rgb.shape[0], 1), np.uint8),  # filter type 0
                           rgb.reshape(rgb.shape[0], -1)], axis=1)
    header = struct.pack(">IIBBBBB", rgb.shape[1], rgb.shape[0], 8, 2, 0, 0, 0)
    with open(output_file, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _png_chunk(b"IEND", b""))
