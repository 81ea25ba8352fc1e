"""Grapheme→phoneme models, counterpart of `ttscube_tpu/models/phonemizer.py`.

* `Phonemizer`: the aligned labeler of the synthesis path. char + case embeddings →
  3 × (conv, tanh) → 2-layer BiLSTM(200) → logits, one phoneme per character ('_'
  marks a deletion).
* `PhonemizerM2M`: the attention seq2seq variant on the same encoder. An LSTM decoder
  attends only within the current word's characters (a mask from the word spans) and
  a second head says how many words to advance. The JAX module runs the decode as one
  `lax.scan`; here it is a Python loop over the steps whose every quantity (the word
  index, the fed-back phone) stays a tensor on the model's device, so the loop never
  waits for the device.
* `phonemizer_loss`, `phonemizer_accuracy`, `m2m_loss`: the trainer's losses and the
  PACC/SACC counters.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ttscube_tpu_torch.models.blocks import Attention
from ttscube_tpu_torch.models.languasito import MaskedEmbed
from ttscube_tpu_torch.ops.conv import Conv1d
from ttscube_tpu_torch.ops.linear import Dense, Embed
from ttscube_tpu_torch.ops.rnn import LSTM, LSTMCell


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
    max_word_skip: int = 20  # the M2M "advance-N-words" head size


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


def phonemizer_loss(logits, y_phon):
    """Cross entropy with ignore id 0, the mean over the non-pad targets."""
    mask = y_phon != 0
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, y_phon.clamp(min=0)[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def phonemizer_accuracy(logits, y_phon) -> dict:
    """PACC/SACC counters: an error counts only where both the target and the
    prediction are non-pad."""
    pred = logits.argmax(dim=-1)
    tgt_valid = y_phon != 0
    err = (pred != y_phon) & tgt_valid & (pred != 0)
    return {"phones": tgt_valid.sum(), "perr": err.sum(), "seqs": y_phon.shape[0],
            "serr": (err.sum(dim=-1) > 0).sum()}


def m2m_loss(phon_logits, nw_logits, y_phon, y_new_word):
    """CE(phone) + CE(next word), both with ignore id 0."""
    return phonemizer_loss(phon_logits, y_phon) + phonemizer_loss(nw_logits, y_new_word)


class _M2MStep(nn.Module):
    """One decode step's parameters (the JAX tree's `step`, shared by every step)."""

    def __init__(self, c: PhonemizerConfig):
        super().__init__()
        enc = 2 * c.rnn_size
        self.att = Attention(c.rnn_size, enc, att_proj_size=100, kernel_size=3)
        self.phon_emb = MaskedEmbed(c.num_phonemes, 32)
        for i in range(c.rnn_layers):
            self.add_module(f"dec_cell_{i}", LSTMCell(32 + enc if i == 0 else c.rnn_size,
                                                      c.rnn_size))
        self.n_layers = c.rnn_layers
        self.output_phon = Dense(c.rnn_size, c.num_phonemes)
        self.output_next_word = Dense(c.rnn_size, c.max_word_skip)

    def forward(self, states, dec_out, last_phone, enc, mask):
        _, weighted = self.att(dec_out, enc, mask)
        h = torch.cat([self.phon_emb(last_phone), weighted], dim=-1)
        new_states = []
        for i in range(self.n_layers):
            st = getattr(self, f"dec_cell_{i}")(h, states[i])
            new_states.append(st)
            h = st[0]
        return new_states, h, self.output_phon(h), self.output_next_word(h)


class PhonemizerM2M(nn.Module):
    """Seq2seq phonemizer with per-word span attention.

    Batch keys: x_char/x_case (B, S); x_word_start/x_word_stop (B, W), each word's
    characters; x_num_words (B,). With y_phon and y_new_word (B, T) the decoder takes
    the teacher's phones and advances (teacher forcing, T steps); without them it feeds
    back its own argmax for `max_steps` steps (default 2·S). Returns (phone logits
    (B, T, P), next-word logits (B, T, max_word_skip), finished (B, T)).

    As in the JAX module: the decoder starts from the zero state with dec_out 0 and
    phone 0; a step advances the word index by max(adv − 1, 0); the word index for the
    span is clamped to the last word."""

    def __init__(self, config: PhonemizerConfig):
        super().__init__()
        self.config = config
        self.encoder = _CharEncoder(config)
        self.step = _M2MStep(config)

    def forward(self, X, max_steps: int | None = None):
        c = self.config
        B, S = X["x_char"].shape
        enc = self.encoder(X["x_char"], X["x_case"])
        dev = enc.device
        teacher = "y_phon" in X
        T = X["y_phon"].shape[1] if teacher else (max_steps or 2 * S)

        word_start, word_stop = X["x_word_start"], X["x_word_stop"]
        num_words = X["x_num_words"]
        last_word = (num_words - 1).clamp(min=0)
        pos = torch.arange(S, device=dev)[None, :]
        states = [LSTMCell.initial_state(B, c.rnn_size, dev, enc.dtype)
                  for _ in range(c.rnn_layers)]
        dec_out = enc.new_zeros(B, c.rnn_size)
        last_phone = torch.zeros(B, dtype=torch.long, device=dev)
        index_word = torch.zeros(B, dtype=torch.long, device=dev)
        phon_logits, nw_logits, index_words = [], [], []
        for t in range(T):
            iw = torch.minimum(index_word, last_word)[:, None]
            start = torch.gather(word_start, 1, iw)
            stop = torch.gather(word_stop, 1, iw)
            mask = (pos >= start) & (pos < stop)
            states, dec_out, pl, nw = self.step(states, dec_out, last_phone, enc, mask)
            if teacher:
                last_phone = X["y_phon"][:, t].long()
                advance = (X["y_new_word"][:, t].long() - 1).clamp(min=0)
            else:
                last_phone = pl.argmax(dim=-1)
                advance = (nw.argmax(dim=-1) - 1).clamp(min=0)
            index_word = index_word + advance
            phon_logits.append(pl)
            nw_logits.append(nw)
            index_words.append(index_word)
        finished = torch.stack(index_words, dim=1) >= num_words[:, None]
        return torch.stack(phon_logits, dim=1), torch.stack(nw_logits, dim=1), finished
