"""Languasito2, counterpart of `ttscube_tpu/models/languasito.py`: the two-tower text
encoder that predicts durations, pitch and VUV and builds the 80-d frame-level
conditioning for the generator; and `Languasito`, the single-tower v1 it superseded
(part of the inventory, instantiated by no live path of either package).

With LM conditioning (`cond_type` "fasttext" or "hf") each tower also runs a BiLSTM
(`lm`, 2 layers of 256) over the word vectors `x_words` (B, W, lm_input_dim), gathers
its output per phone by `x_phon2word` and appends it after the speaker embedding, as the
JAX `_Tower` does. `x_words` comes from the collate (fastText) or from
`Cubegan.lm_condition` (the HF encoder's hidden state per word)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from ttscube_tpu_torch.ops.conv import Conv1d
from ttscube_tpu_torch.ops.length_regulator import durations_to_frame2phone, regulate_length
from ttscube_tpu_torch.ops.linear import Dense
from ttscube_tpu_torch.ops.rnn import LSTM
from ttscube_tpu_torch.utils.profiling import span

PHON_EMB_SIZE = 64
SPEAKER_EMB_SIZE = 128
CHAR_CNN_SIZE = 256
CHAR_CNN_KS = 3
CHAR_CNN_NL = 3
CHAR_RNN_NL = 2
CHAR_RNN_SIZE = 256
DUR_RNN_SIZE = 256
DUR_RNN_LAYERS = 2
PITCH_RNN_SIZE = 256
PITCH_RNN_LAYERS = 2
COND_RNN_SIZE = 64
COND_RNN_LAYERS = 2
COND_SIZE = 80
EXTERNAL_COND = 512  # 2 × 256 BiLSTM over the LM word vectors


@dataclasses.dataclass(frozen=True)
class LanguasitoConfig:
    num_phones: int
    num_speakers: int
    max_pitch: float
    max_duration: int
    cond_type: Optional[str] = None  # None | "fasttext" | "hf"
    lm_dim: Optional[int] = None  # the x_words feature size, where it is not the default

    @property
    def lm_input_dim(self) -> int:
        if self.lm_dim is not None:
            return self.lm_dim
        return {"fasttext": 300, "hf": 768}.get(self.cond_type, 0)


class MaskedEmbed(nn.Module):
    """Embedding whose rows for id 0 are zeroed by an id mask (JAX `MaskedEmbed`), not by
    PyTorch's `padding_idx`: the table's row 0 keeps whatever value it holds."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num_embeddings, features))

    def init_weights(self, gen: torch.Generator):
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0, generator=gen)

    def forward(self, ids):
        return self.embedding[ids] * (ids != 0)[..., None]


class _Tower(nn.Module):
    """Phone embedding → char CNN → char BiLSTM, concatenated with the speaker embedding
    and, with LM conditioning, the word BiLSTM's output gathered per phone."""

    def __init__(self, c: LanguasitoConfig):
        super().__init__()
        self.phon_emb = MaskedEmbed(c.num_phones + 1, PHON_EMB_SIZE)
        self.speaker_emb = MaskedEmbed(c.num_speakers + 1, SPEAKER_EMB_SIZE)
        for i in range(CHAR_CNN_NL):
            self.add_module(f"char_cnn_{i}", Conv1d(
                PHON_EMB_SIZE if i == 0 else CHAR_CNN_SIZE, CHAR_CNN_SIZE, CHAR_CNN_KS,
                w_init_gain="tanh"))
        self.char_rnn = LSTM(CHAR_CNN_SIZE, CHAR_RNN_SIZE, num_layers=CHAR_RNN_NL,
                             bidirectional=True)
        if c.cond_type is not None:
            self.lm = LSTM(c.lm_input_dim, EXTERNAL_COND // 2, num_layers=2,
                           bidirectional=True)

    @staticmethod
    def width(c: LanguasitoConfig) -> int:
        """The tower's output features."""
        return 2 * CHAR_RNN_SIZE + SPEAKER_EMB_SIZE + (
            EXTERNAL_COND if c.cond_type is not None else 0)

    def forward(self, x_char, x_speaker, x_words=None, x_phon2word=None):
        h = self.phon_emb(x_char)
        for i in range(CHAR_CNN_NL):
            h = torch.tanh(getattr(self, f"char_cnn_{i}")(h))
        h, _ = self.char_rnn(h)
        spk = self.speaker_emb(x_speaker).expand(h.shape[0], h.shape[1], SPEAKER_EMB_SIZE)
        parts = [h, spk]
        if hasattr(self, "lm"):
            cond, _ = self.lm(x_words)
            idx = x_phon2word.long()[:, :, None].expand(-1, -1, cond.shape[-1])
            parts.append(torch.gather(cond, 1, idx))  # the word of each phone
        return torch.cat(parts, dim=-1)


class Languasito2(nn.Module):
    """Text tower (`tower_t`: durations, pitch, VUV) and GAN tower (`tower_g`:
    conditioning). Inputs are dicts of (B, N) int tensors as the collate builds them."""

    def __init__(self, config: LanguasitoConfig):
        super().__init__()
        c = self.config = config
        tower_out = _Tower.width(c)
        self.tower_t = _Tower(c)
        self.tower_g = _Tower(c)
        self.dur_rnn = LSTM(tower_out, DUR_RNN_SIZE, num_layers=DUR_RNN_LAYERS,
                            bidirectional=True)
        self.dur_output = Dense(2 * DUR_RNN_SIZE, c.max_duration + 1)
        self.pitch_rnn = LSTM(tower_out, PITCH_RNN_SIZE, num_layers=PITCH_RNN_LAYERS,
                              bidirectional=True)
        self.pitch_output = Dense(2 * PITCH_RNN_SIZE, 2)
        self.cond_rnn = LSTM(tower_out + 1, COND_RNN_SIZE, num_layers=COND_RNN_LAYERS,
                             bidirectional=True)
        self.cond_output = Dense(2 * COND_RNN_SIZE, COND_SIZE)

    @staticmethod
    def _tower(tower, X):
        return tower(X["x_char"], X["x_speaker"], X.get("x_words"), X.get("x_phon2word"))

    def text_forward(self, X, frame2phone):
        """Phone-level duration logits; frame-level pitch and VUV."""
        h = self._tower(self.tower_t, X)
        dur_logits = self.dur_output(self.dur_rnn(h)[0])
        po = self.pitch_output(self.pitch_rnn(regulate_length(h, frame2phone))[0])
        return dur_logits, torch.sigmoid(po[:, :, 0]), torch.sigmoid(po[:, :, 1])

    def cond_forward(self, X, frame2phone, pitch):
        """Frame-level 80-d conditioning."""
        h = self._tower(self.tower_g, X)
        hf = regulate_length(h, frame2phone)
        hf = torch.cat([hf, (pitch / self.config.max_pitch)[:, :, None]], dim=-1)
        return self.cond_output(self.cond_rnn(hf)[0])

    @span("tts.text")
    def forward(self, X):
        """Teacher-forced pass (training): the batch's own frame→phone map and pitch.
        Returns (dur_logits, pitch, vuv, cond)."""
        dur_logits, pitch, vuv = self.text_forward(X, X["y_frame2phone"])
        cond = self.cond_forward(X, X["y_frame2phone"], X["y_pitch"])
        return dur_logits, pitch, vuv, cond

    def _durations(self, X, h_t):
        return self.dur_output(self.dur_rnn(h_t)[0]).argmax(dim=-1) * (X["x_char"] != 0)

    def durations(self, X):
        """Predicted per-phone durations (B, N), zero on padded phones."""
        return self._durations(X, self._tower(self.tower_t, X))

    @span("tts.text")
    def infer(self, X, max_frames: int):
        """Free synthesis: predict durations, expand, predict pitch (VUV rounded to 0/1,
        pitch scaled by max_pitch and masked by VUV), build the conditioning. The spans
        `tts.text.tower_t`, `.durations`, `.pitch` and `.cond` name the parts."""
        with span("tts.text.tower_t"):
            h_t = self._tower(self.tower_t, X)
        with span("tts.text.durations"):
            durs = self._durations(X, h_t)
            frame2phone, frame_mask = durations_to_frame2phone(
                durs, (X["x_char"] != 0).sum(dim=-1), max_frames)

        with span("tts.text.pitch"):
            po = self.pitch_output(self.pitch_rnn(regulate_length(h_t, frame2phone))[0])
            pitch = torch.sigmoid(po[:, :, 0])
            vuv = torch.round(torch.sigmoid(po[:, :, 1]))
            pitch = pitch * self.config.max_pitch * vuv

        with span("tts.text.cond"):
            cond = self.cond_forward(X, frame2phone, pitch)
        return cond, {"durations": durs, "pitch": pitch, "vuv": vuv,
                      "frame2phone": frame2phone, "frame_mask": frame_mask}


class Languasito(nn.Module):
    """Languasito v1: one shared tower; durations from `dur_rnn`; at frame rate the
    `rnn_overlay` BiLSTM (512) feeds a classification pitch head (`int(max_pitch) + 1`
    ways, through `pitch_rnn`) and, with the pitch over max_pitch appended, the
    conditioning BiLSTM `rnn_cond` and its 80-d output."""

    def __init__(self, config: LanguasitoConfig):
        super().__init__()
        c = self.config = config
        tower_out = _Tower.width(c)
        self.tower = _Tower(c)
        self.dur_rnn = LSTM(tower_out, DUR_RNN_SIZE, num_layers=DUR_RNN_LAYERS,
                            bidirectional=True)
        self.dur_output = Dense(2 * DUR_RNN_SIZE, c.max_duration + 1)
        self.rnn_overlay = LSTM(tower_out, 512, num_layers=1, bidirectional=True)
        self.pitch_rnn = LSTM(1024, PITCH_RNN_SIZE, num_layers=1, bidirectional=True)
        self.pitch_output = Dense(2 * PITCH_RNN_SIZE, int(c.max_pitch) + 1)
        self.rnn_cond = LSTM(1024 + 1, 256, num_layers=1, bidirectional=True)
        self.cond_output = Dense(512, COND_SIZE)

    def forward(self, X, frame2phone=None, pitch=None):
        """Returns (dur_logits (B, N, max_duration + 1), pitch_logits (B, F,
        int(max_pitch) + 1), cond (B, F, 80)); `frame2phone` and `pitch` default to the
        batch's `y_frame2phone` and `y_pitch`."""
        h = Languasito2._tower(self.tower, X)
        dur_logits = self.dur_output(self.dur_rnn(h)[0])
        if frame2phone is None:
            frame2phone = X["y_frame2phone"]
        overlay = self.rnn_overlay(regulate_length(h, frame2phone.long()))[0]
        pitch_logits = self.pitch_output(self.pitch_rnn(overlay)[0])
        if pitch is None:
            pitch = X["y_pitch"]
        hc = torch.cat([overlay, (pitch / self.config.max_pitch)[:, :, None]], dim=-1)
        cond = self.cond_output(self.rnn_cond(hc)[0])
        return dur_logits, pitch_logits, cond


def languasito_losses(dur_logits, pitch, vuv, batch, max_pitch: float):
    """Duration cross-entropy over real phones + VUV-weighted pitch L1 + VUV L1.

    As in the JAX function, the pitch and VUV means run over the valid frames
    (`y_frame_mask`), not over the padded batch; a batch without a frame mask takes
    plain means. A data-parallel shard of a batch (parallel/mesh.py) carries the global
    counts over the data size as `dur_denom` and `frame_denom`, and divides by those, so
    that the mean of the shards' losses is the global batch's. Returns (loss_duration,
    loss_pitch)."""
    t_dur = batch["y_dur"].long()
    dur_mask = (batch["x_char"] != 0).float()
    logp = torch.log_softmax(dur_logits, dim=-1)
    t_dur_safe = t_dur.clamp(0, dur_logits.shape[-1] - 1)
    nll = -torch.gather(logp, -1, t_dur_safe[..., None])[..., 0]
    dur_denom = batch.get("dur_denom")
    if dur_denom is None:
        dur_denom = dur_mask.sum().clamp(min=1)
    loss_duration = (nll * dur_mask).sum() / dur_denom

    t_pitch = batch["y_pitch"]
    t_vuv = (t_pitch > 1).float()
    F = min(t_pitch.shape[1], pitch.shape[1])
    pitch_l1 = torch.abs(t_pitch[:, :F] / max_pitch - pitch[:, :F]) * t_vuv[:, :F]
    vuv_l1 = torch.abs(t_vuv[:, :F] - vuv[:, :F])
    fmask = batch.get("y_frame_mask")
    if fmask is None:
        loss_pitch = pitch_l1.mean() + vuv_l1.mean()
    else:
        m = fmask[:, :F].float()
        denom = batch.get("frame_denom")
        if denom is None:
            denom = m.sum().clamp(min=1.0)
        loss_pitch = (pitch_l1 * m).sum() / denom + (vuv_l1 * m).sum() / denom
    return loss_duration, loss_pitch
