"""Devset synthesis and spectrogram images: counterpart of
`ttscube_tpu/train/runtime.py`'s `cubegan_synthesize_dataset` (the Cubegan trainer's
epoch hook), `synthesize_from_checkpoint` (the same from a trainer's files: a quality
drive's synthesis from its final weights), `synthesize_devset` (Textcoder's mel through
a HiFi-GAN generator) and `render_spectrogram` (the corpus importer's PNG)."""

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


def cubegan_from_checkpoint(base: str, dev_folder: str, which: str = ".last", device=None):
    """(model, dataset, collate) of a trainer's files: a Cubegan rebuilt from
    `{base}.yaml`, `{base}.encodings` and the `lang`, `gen` and, with HF conditioning,
    `hf` subtrees of `{base}{which}`, on `device` (the card unless the CPU is asked for);
    the dataset of `dev_folder`; and the collate the trainer builds. The yaml's
    `conditioning` spec (`hf:<dir>` or `fasttext:<table>`) is read by the trainer's own
    readers. As in the JAX function, the generator is the plain one (HifiganConfig's
    defaults: no fused tail, fp32)."""
    from ttscube_tpu_torch import resolve_device
    from ttscube_tpu_torch.api import lm_config_from_yaml
    from ttscube_tpu_torch.convert import load_jax_params, read_msgpack
    from ttscube_tpu_torch.data.collate import CubeganCollate
    from ttscube_tpu_torch.data.datasets import CubeganDataset
    from ttscube_tpu_torch.data.encodings import CubeganEncodings
    from ttscube_tpu_torch.models.cubegan import Cubegan, CubeganConfig
    from ttscube_tpu_torch.models.languasito import LanguasitoConfig
    from ttscube_tpu_torch.scripts.train_cubegan import lm_setup
    from ttscube_tpu_torch.utils.checkpoint import load_config
    from ttscube_tpu_torch.utils.wordvec import make_word_embedder

    device = resolve_device(device)
    conf = load_config(base)
    spec = conf.get("conditioning")
    cond_type, _, _, hf_tokenizer = lm_setup(spec)
    lm_config = lm_config_from_yaml(conf)  # the yaml's, as the JAX function reads it
    encodings = CubeganEncodings(base + ".encodings")
    cfg = CubeganConfig(
        languasito=LanguasitoConfig(
            num_phones=len(encodings.phon2int), num_speakers=len(encodings.speaker2int),
            max_pitch=encodings.max_pitch, max_duration=encodings.max_duration,
            cond_type=cond_type,
            lm_dim=lm_config.hidden_size if lm_config is not None else None),
        sample_rate=conf.get("sample_rate", 24000), hop_size=conf.get("hop_size", 240))
    tree = read_msgpack(base + which)
    model = load_jax_params(Cubegan(cfg, lm_config=lm_config),
                            {k: tree[k] for k in ("lang", "gen", "hf") if k in tree})
    hf_cond = cond_type == "hf"
    dataset = CubeganDataset(dev_folder, hf_tokenizer=hf_tokenizer,
                             hop_size=cfg.hop_size, sample_rate=cfg.sample_rate)
    collate = CubeganCollate(encodings, word_embedder=make_word_embedder(spec),
                             hop=cfg.hop_size, hf_conditioning=hf_cond,
                             bucket_tokens=512 if hf_cond else 64,
                             bucket_words=8 if hf_cond else 1)
    return model.to(device).eval(), dataset, collate


def synthesize_from_checkpoint(base: str, dev_folder: str, out_folder: str, limit: int = -1,
                               free: bool = True, which: str = ".last", device=None):
    """Synthesize the first `limit` utterances of `dev_folder` into `out_folder`, free
    (`free=True`) or forced, with the Cubegan that `cubegan_from_checkpoint` rebuilds
    from `{base}.yaml`, `{base}.encodings` and `{base}{which}`: a quality drive's
    synthesis from a run's final weights, whatever the trainer's epoch hook did. Runs on
    the card unless `device` says otherwise; returns the model."""
    model, dataset, collate = cubegan_from_checkpoint(base, dev_folder, which, device)
    cubegan_synthesize_dataset(model, dataset, collate, out_folder, limit=limit, free=free)
    return model


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
