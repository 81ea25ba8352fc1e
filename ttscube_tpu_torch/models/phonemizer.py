"""Aligned grapheme→phoneme labeler, counterpart of
`ttscube_tpu/models/phonemizer.py::Phonemizer` (the M2M variant is not ported yet).

char + case embeddings → 3 × (conv, tanh) → 2-layer BiLSTM(200) → logits, one phoneme
per character ('_' marks a deletion)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ttscube_tpu_torch.ops.conv import Conv1d
from ttscube_tpu_torch.ops.linear import Dense, Embed
from ttscube_tpu_torch.ops.rnn import LSTM


@dataclasses.dataclass(frozen=True)
class PhonemizerConfig:
    num_graphemes: int
    num_phonemes: int
    char_emb: int = 32
    case_emb: int = 8
    conv_size: int = 256
    conv_layers: int = 3
    rnn_size: int = 200
    rnn_layers: int = 2


class _CharEncoder(nn.Module):
    def __init__(self, c: PhonemizerConfig):
        super().__init__()
        self.char_emb = Embed(c.num_graphemes, c.char_emb)
        self.case_emb = Embed(2, c.case_emb)
        d = c.char_emb + c.case_emb
        for i in range(c.conv_layers):
            self.add_module(f"conv_{i}", Conv1d(d if i == 0 else c.conv_size,
                                                c.conv_size, 3))
        self.n_conv = c.conv_layers
        self.rnn = LSTM(c.conv_size, c.rnn_size, num_layers=c.rnn_layers,
                        bidirectional=True)

    def forward(self, x_char, x_case):
        h = torch.cat([self.char_emb(x_char), self.case_emb(x_case)], dim=-1)
        for i in range(self.n_conv):
            h = torch.tanh(getattr(self, f"conv_{i}")(h))
        h, _ = self.rnn(h)
        return h  # (B, S, 2·rnn_size)


class Phonemizer(nn.Module):
    """Aligned sequence labeler: {x_char, x_case} (B, S) → (B, S, num_phonemes) logits."""

    def __init__(self, config: PhonemizerConfig):
        super().__init__()
        self.config = config
        self.encoder = _CharEncoder(config)
        self.output = Dense(2 * config.rnn_size, config.num_phonemes)

    def forward(self, X):
        return self.output(self.encoder(X["x_char"], X["x_case"]))
