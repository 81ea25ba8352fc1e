"""Duration-based length regulation, counterpart of `ttscube_tpu/ops/length_regulator.py`.

Frames beyond the utterance repeat the last valid phone (the JAX function clamps
frame→phone indices to it). `durations_to_frame2phone_np` is the host (numpy) twin of
`durations_to_frame2phone`, for collates and example batches that need no device."""

from __future__ import annotations

import numpy as np
import torch


def durations_to_frame2phone_np(durations: np.ndarray, num_valid_phones: np.ndarray,
                                max_frames: int):
    """(B, N) int durations → (B, F) int32 frame→phone indices and (B, F) validity mask,
    in numpy; the same comparison sum, clamp and mask as `durations_to_frame2phone`."""
    ends = np.cumsum(durations, axis=1)
    frames = np.arange(max_frames)
    f2p = np.sum(frames[None, :, None] >= ends[:, None, :], axis=-1).astype(np.int32)
    total = ends[:, -1]
    last_valid = np.maximum(num_valid_phones - 1, 0)
    f2p = np.minimum(f2p, last_valid[:, None])
    mask = frames[None, :] < total[:, None]
    return f2p, mask


def durations_to_frame2phone(durations: torch.Tensor, num_valid_phones: torch.Tensor,
                             max_frames: int):
    """(B, N) int durations → (B, F) frame→phone indices and (B, F) validity mask.

    Durations of padded phones must be 0 (callers zero them with the phone mask)."""
    ends = torch.cumsum(durations, dim=1)  # (B, N)
    frames = torch.arange(max_frames, device=durations.device)
    # frame f belongs to phone p ⇔ ends[p−1] ≤ f < ends[p], counted as a comparison sum
    f2p = (frames[None, :, None] >= ends[:, None, :]).sum(dim=-1)
    total = ends[:, -1]
    last_valid = torch.clamp(num_valid_phones - 1, min=0)
    f2p = torch.minimum(f2p, last_valid[:, None])
    mask = frames[None, :] < total[:, None]
    return f2p, mask


def regulate_length(x: torch.Tensor, frame2phone: torch.Tensor) -> torch.Tensor:
    """Gather phone-level features (B, N, C) to frame level (B, F, C)."""
    idx = frame2phone[:, :, None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx)


def expand_with_durations(x: torch.Tensor, durations: torch.Tensor,
                          num_valid_phones: torch.Tensor, max_frames: int):
    """durations → (frame-level features (B, F, C), frame2phone, mask)."""
    f2p, mask = durations_to_frame2phone(durations, num_valid_phones, max_frames)
    return regulate_length(x, f2p), f2p, mask
