"""CubenetTextcoder, counterpart of `ttscube_tpu/models/textcoder.py`: the legacy
Tacotron-like autoregressive acoustic model. A phoneme encoder (embedding, char CNN,
BiLSTM) feeds a duration head; the length-regulated overlay BiLSTM feeds a pitch head;
the mel decoder (PreNet on the previous group's last mel frame, a 2-layer LSTM of 512
emitting `pframes` frames per step) and a PostNet residual give the mel.

`forward` is the teacher-forced pass (the JAX module's `__call__`); `infer` runs free,
stepping the same `mel_rnn` LSTM one decoder group at a time with its state carried, so
it needs no second parameter tree (the JAX package's `textcoder_infer_params` remap has
no counterpart: no file holds the remapped tree). The PreNet's dropout is on in both;
its keep masks are passed in (`masks`: one bool tensor (B, groups, 256) per PreNet
layer) or drawn from `generator`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ttscube_tpu_torch.models.blocks import PostNet, PreNet
from ttscube_tpu_torch.models.languasito import MaskedEmbed
from ttscube_tpu_torch.ops.conv import Conv1d
from ttscube_tpu_torch.ops.length_regulator import durations_to_frame2phone, regulate_length
from ttscube_tpu_torch.ops.linear import Dense
from ttscube_tpu_torch.ops.rnn import LSTM

MEL_SIZE = 80
PRENET_SIZE = 256
MEL_RNN_SIZE = 512
MEL_RNN_LAYERS = 2
OVERLAY_RNN_SIZE = 512
GO_FRAME = -5.0
ENC_SIZE = 2 * 256 + 128  # the char BiLSTM and the speaker embedding


@dataclasses.dataclass(frozen=True)
class TextcoderConfig:
    num_phones: int
    num_speakers: int
    max_pitch: int
    max_duration: int
    pframes: int = 3
    lr: float = 2e-4


class _TextEncoder(nn.Module):
    def __init__(self, c: TextcoderConfig):
        super().__init__()
        self.phon_emb = MaskedEmbed(c.num_phones + 1, 64)
        self.speaker_emb = MaskedEmbed(c.num_speakers + 1, 128)
        for i in range(3):
            self.add_module(f"char_cnn_{i}", Conv1d(64 if i == 0 else 256, 256, 3,
                                                    w_init_gain="tanh"))
        self.rnn_char = LSTM(256, 256, num_layers=2, bidirectional=True)

    def forward(self, x_char, x_speaker):
        h = self.phon_emb(x_char)
        for i in range(3):
            h = torch.tanh(getattr(self, f"char_cnn_{i}")(h))
        h, _ = self.rnn_char(h)
        spk = self.speaker_emb(x_speaker).expand(h.shape[0], h.shape[1], 128)
        return torch.cat([h, spk], dim=-1)


class CubenetTextcoder(nn.Module):
    def __init__(self, config: TextcoderConfig):
        super().__init__()
        c = self.config = config
        self.encoder = _TextEncoder(c)
        self.dur_rnn = LSTM(ENC_SIZE, 256, num_layers=2, bidirectional=True)
        self.dur_output = Dense(512, c.max_duration + 1)
        self.rnn_overlay = LSTM(ENC_SIZE, OVERLAY_RNN_SIZE, num_layers=2, bidirectional=True)
        self.pitch_rnn = LSTM(2 * OVERLAY_RNN_SIZE, 256, num_layers=2, bidirectional=True)
        self.pitch_output = Dense(512, c.max_pitch + 1)
        self.prenet = PreNet(MEL_SIZE, (PRENET_SIZE, PRENET_SIZE))
        self.mel_rnn = LSTM(2 * OVERLAY_RNN_SIZE + PRENET_SIZE, MEL_RNN_SIZE,
                            num_layers=MEL_RNN_LAYERS)
        self.mel_output = Dense(MEL_RNN_SIZE, MEL_SIZE * c.pframes)
        self.postnet = PostNet()

    def _encode(self, X):
        enc = self.encoder(X["x_char"], X["x_speaker"])
        hidden_dur, _ = self.dur_rnn(enc)
        return enc, self.dur_output(hidden_dur)

    def _overlay_and_pitch(self, enc, frame2phone):
        # the decoder runs at the group rate: the phone of frame g·pframes
        hidden = regulate_length(enc, frame2phone[:, :: self.config.pframes])
        hidden, _ = self.rnn_overlay(hidden)
        hp, _ = self.pitch_rnn(hidden)
        return hidden, self.pitch_output(hp)

    def _prepare_mel(self, mel):
        """The teacher input of each decoder group: the previous group's last frame,
        the go frame (−5) first."""
        p = self.config.pframes
        last_of_group = mel[:, p - 1:: p][:, :-1]
        go = torch.full((mel.shape[0], 1, MEL_SIZE), GO_FRAME, device=mel.device,
                        dtype=mel.dtype)
        return torch.cat([go, last_of_group], dim=1)

    def forward(self, X, train: bool = False, masks=None, generator=None):
        """Teacher-forced pass → (dur_logits, pitch_logits, mel_pre, mel_post).
        `train=True` normalizes the PostNet by batch statistics and updates its running
        averages. `masks` may cover more groups than the decoder runs (min of the
        overlay's groups and the teacher mel's)."""
        enc, dur_logits = self._encode(X)
        hidden, pitch_logits = self._overlay_and_pitch(enc, X["y_frame2phone"])
        cond_mel = self._prepare_mel(X["y_mgc"])
        T_dec = min(hidden.shape[1], cond_mel.shape[1])
        if masks is not None:
            masks = [m[:, :T_dec] for m in masks]
        pm = self.prenet(cond_mel[:, :T_dec], masks=masks, generator=generator)
        h, _ = self.mel_rnn(torch.cat([hidden[:, :T_dec], pm], dim=-1))
        mel_pre = self.mel_output(h)
        mel_pre = mel_pre.reshape(mel_pre.shape[0], -1, MEL_SIZE)
        return dur_logits, pitch_logits, mel_pre, mel_pre + self.postnet(mel_pre, train)

    def infer(self, X, max_frames: int = 1200, masks=None, generator=None):
        """Free-running synthesis → (post-net mel (B, groups·pframes, 80), aux).

        The durations are argmax · (x_char != 0); the frames expand to the fixed
        `max_frames`, so the overlay and pitch BiLSTMs run over all
        ceil(max_frames / pframes) groups (their reverse direction sees the padded
        tail), and the decoder steps through every group, feeding back the last frame
        of each. aux: frame_mask (B, max_frames), frame2phone, durations, dur_logits,
        mel_pre."""
        enc, dur_logits = self._encode(X)
        valid = X["x_char"] != 0
        durs = torch.argmax(dur_logits, dim=-1) * valid
        frame2phone, frame_mask = durations_to_frame2phone(durs, valid.sum(dim=-1),
                                                           max_frames)
        hidden, _ = self._overlay_and_pitch(enc, frame2phone)
        B, G = hidden.shape[:2]
        if masks is None:
            masks = self.prenet.draw_masks((B, G), generator, hidden.device)
        last = torch.full((B, MEL_SIZE), GO_FRAME, device=hidden.device, dtype=hidden.dtype)
        state, outs = None, []
        for g in range(G):
            pm = self.prenet(last, masks=[m[:, g] for m in masks])
            y, state = self.mel_rnn(torch.cat([hidden[:, g], pm], dim=-1)[:, None], state)
            out = self.mel_output(y[:, 0])
            outs.append(out)
            last = out[:, -MEL_SIZE:]
        mel = torch.stack(outs, dim=1).reshape(B, -1, MEL_SIZE)
        return mel + self.postnet(mel), {"frame_mask": frame_mask, "frame2phone": frame2phone,
                                         "durations": durs, "dur_logits": dur_logits,
                                         "mel_pre": mel}


def _nll(logits, target):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, target[..., None])[..., 0]


def textcoder_losses(outputs, batch, config: TextcoderConfig) -> dict:
    """CE of the durations + CE of the pitch classes + L1 of the pre- and post-net mels,
    each masked to the real phones and frames."""
    dur_logits, pitch_logits, mel_pre, mel_post = outputs
    p = config.pframes
    dur_mask = (batch["x_char"] != 0).to(dur_logits.dtype)
    t_dur = torch.clamp(batch["y_dur"].long(), 0, config.max_duration)
    loss_dur = (_nll(dur_logits, t_dur) * dur_mask).sum() / torch.clamp(dur_mask.sum(), min=1)

    # pitch targets at the group rate: the last frame of each group
    t_pitch = batch["y_pitch"][:, p - 1:: p]
    T = min(t_pitch.shape[1], pitch_logits.shape[1])
    t_pitch_i = torch.clamp(t_pitch[:, :T].to(torch.int64), 0, config.max_pitch)
    mask_p = batch["y_frame_mask"][:, p - 1:: p][:, :T].to(pitch_logits.dtype)
    loss_pitch = (_nll(pitch_logits[:, :T], t_pitch_i) * mask_p).sum() / torch.clamp(
        mask_p.sum(), min=1)

    t_mel = batch["y_mgc"]
    T = min(t_mel.shape[1], mel_pre.shape[1])
    fmask = batch["y_frame_mask"][:, :T, None].to(mel_pre.dtype)
    denom = torch.clamp(fmask.sum() * MEL_SIZE, min=1)
    loss_pre = (torch.abs(mel_pre[:, :T] - t_mel[:, :T]) * fmask).sum() / denom
    loss_post = (torch.abs(mel_post[:, :T] - t_mel[:, :T]) * fmask).sum() / denom
    return {"loss": loss_dur + loss_pitch + loss_pre + loss_post, "loss_dur": loss_dur,
            "loss_pitch": loss_pitch, "loss_mel_pre": loss_pre, "loss_mel_post": loss_post}
