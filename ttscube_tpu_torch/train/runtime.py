"""Devset synthesis during training: counterpart of
`ttscube_tpu/train/runtime.py::cubegan_synthesize_dataset`, the trainer's epoch hook.
Not ported: `synthesize_devset` and `synthesize_from_checkpoint` (other model
families)."""

from __future__ import annotations

import os

import numpy as np

from ttscube_tpu_torch.models.cubegan import batch_to_torch
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
        write_wav(os.path.join(output_path, f"{example['meta']['id']}.wav"),
                  np.asarray(audio), model.config.sample_rate)
