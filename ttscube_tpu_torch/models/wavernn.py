"""WaveRNN and the dual-rate CubenetVocoder, counterpart of
`ttscube_tpu/models/wavernn.py`: a 2.4 kHz WaveRNN conditioned on the mel (`lr`) and a
24 kHz one conditioned on the mel and the low-rate signal (`hr`).

Teacher-forced training runs each net's GRUs over the whole (shifted) signal at once
(`nn.GRU`, cuDNN on the card). Sampling is a Python loop of per-sample steps that runs
each layer's `nn.GRU` weights through `torch.gru_cell` (no second parameter tree, no
remap); its noise for every step is drawn up front from an explicit generator
(`heads.draw_noise`) and indexed per step. `CubenetVocoder.infer` samples the low-rate
signal over the whole utterance, then the high-rate one in `num_chunks` chunks that
advance together as a batch, each seeded with one frame of the previous chunk's mel and
one frame's worth of its low-rate signal (the JAX package's seeding; PARITY.md §2.1).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ttscube_tpu_torch.models.heads import get_output_head
from ttscube_tpu_torch.ops.conv import Conv1d
from ttscube_tpu_torch.ops.linear import Dense
from ttscube_tpu_torch.ops.rnn import GRU

MEL_SIZE = 80
LOWRES_CHANNELS = 20
MEL_PAD = -5.0


def repeat_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, T, C) → (B, T·factor, C) by repetition."""
    return torch.repeat_interleave(x, factor, dim=1)


def linear_interp_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, T) → (B, T·factor), `F.interpolate(mode='linear', align_corners=False)` as the
    JAX function computes it (positions (i + 0.5)/factor − 0.5, clamped at the edges)."""
    T = x.shape[1]
    pos = (torch.arange(T * factor, device=x.device, dtype=x.dtype) + 0.5) / factor - 0.5
    lo = torch.clamp(torch.floor(pos).long(), 0, T - 1)
    hi = torch.clamp(lo + 1, 0, T - 1)
    w = torch.clamp(pos - lo, 0.0, 1.0)
    return x[:, lo] * (1.0 - w) + x[:, hi] * w


@dataclasses.dataclass(frozen=True)
class WaveRNNConfig:
    num_layers: int = 2
    layer_size: int = 512
    upsample: int = 240          # samples per mel frame at this rate
    upsample_low: int = 10       # the high/low sample-rate ratio
    use_lowres: bool = True
    output: str = "mol"


class _CondNet(nn.Module):
    """The low-rate branch of the conditioning: three tanh convs (k 7, 20 channels) over
    the low-rate signal, repeated to the output rate, beside its linear interpolation."""

    def __init__(self):
        super().__init__()
        for i in range(3):
            self.add_module(f"lowres_conv_{i}", Conv1d(1 if i == 0 else LOWRES_CHANNELS,
                                                       LOWRES_CHANNELS, 7))


class WaveRNN(nn.Module):
    """`forward(mel, x, x_low)`: teacher-forced logits; `sample(...)`: the AR loop."""

    def __init__(self, config: WaveRNNConfig):
        super().__init__()
        c = self.config = config
        self.head = get_output_head(c.output)
        if c.use_lowres:
            self.cond = _CondNet()
        cond_size = MEL_SIZE + (LOWRES_CHANNELS + 1 if c.use_lowres else 0)
        for i in range(c.num_layers):
            self.add_module(f"gru_{i}", GRU(cond_size + 1 if i == 0 else c.layer_size,
                                            c.layer_size))
        self.preoutput = Dense(c.layer_size, 256)
        self.output = Dense(256, self.head.sample_size)

    def condition(self, mel, x_low=None):
        """The per-sample conditioning (B, T, cond_size): the mel repeated to the output
        rate [, the low-rate branch]."""
        c = self.config
        cond = repeat_upsample(mel, c.upsample)
        if c.use_lowres:
            interp = linear_interp_upsample(x_low, c.upsample_low)[:, :, None]
            h = x_low[:, :, None]
            for i in range(3):
                h = torch.tanh(getattr(self.cond, f"lowres_conv_{i}")(h))
            up_x = repeat_upsample(h, c.upsample_low)
            m = min(cond.shape[1], up_x.shape[1], interp.shape[1])
            cond = torch.cat([cond[:, :m], up_x[:, :m], interp[:, :m]], dim=-1)
        return cond

    def grus(self) -> list:
        return [getattr(self, f"gru_{i}") for i in range(self.config.num_layers)]

    def forward(self, mel, x, x_low=None):
        """Teacher-forced logits (B, T, sample_size); `x` is the shifted previous-sample
        signal at this net's rate."""
        cond = self.condition(mel, x_low)
        m = min(cond.shape[1], x.shape[1])
        h = torch.cat([cond[:, :m], x[:, :m, None]], dim=-1)
        for gru in self.grus():
            h, _ = gru(h)
        return self.output(torch.tanh(self.preoutput(h)))

    @torch.no_grad()
    def sample(self, mel, x_low=None, generator: torch.Generator | None = None,
               return_logits: bool = False):
        """The AR loop: (B, T) samples, and with `return_logits` the (B, T, sample_size)
        logits each step sampled from. Step t's input is [cond_t, the sample of step
        t − 1] (zero at t = 0); the B rows advance together. The head's noise for all T
        steps is drawn from `generator` first (`draw_noise`) and moved to the card in
        one copy (the Beta head draws per step)."""
        cond = self.condition(mel, x_low)
        B, T, _ = cond.shape
        noise = self.head.draw_noise((T, B), generator)
        if isinstance(noise, tuple):
            noise = tuple(n.to(cond.device) for n in noise)
            noise_at = lambda t: tuple(n[t][:, None] for n in noise)  # noqa: E731
        elif noise is not None:
            noise = noise.to(cond.device)
            noise_at = lambda t: noise[t][:, None]  # noqa: E731
        else:
            noise_at = lambda t: None  # noqa: E731
        weights = [gru.layer_weights(0) for gru in self.grus()]
        states = [cond.new_zeros(B, self.config.layer_size) for _ in weights]
        last = cond.new_zeros(B)
        samples, logits = [], []
        for t in range(T):
            h = torch.cat([cond[:, t], last[:, None]], dim=-1)
            for i, w in enumerate(weights):
                h = states[i] = torch.gru_cell(h, states[i], *w)
            out = self.output(torch.tanh(self.preoutput(h)))
            last = self.head.sample(out[:, None], generator, noise=noise_at(t))[:, 0]
            samples.append(last)
            if return_logits:
                logits.append(out)
        audio = torch.stack(samples, dim=1)
        return (audio, torch.stack(logits, dim=1)) if return_logits else audio


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """The dual-rate vocoder (reference CubenetVocoder)."""

    num_layers_lr: int = 2
    layer_size_lr: int = 512
    num_layers_hr: int = 2
    layer_size_hr: int = 512
    upsample: int = 240
    upsample_low: int = 10
    output: str = "mol"
    lr: float = 1e-4
    lr_decay: float = 5e-5


class CubenetVocoder(nn.Module):
    """The two WaveRNNs: `hr` (24 kHz, with the low-rate branch) and `lr` (2.4 kHz,
    upsample // upsample_low samples per frame, no low-rate branch), named as the JAX
    parameter tree {"hr", "lr"}."""

    def __init__(self, config: VocoderConfig):
        super().__init__()
        self.config = c = config
        self.hr = WaveRNN(WaveRNNConfig(c.num_layers_hr, c.layer_size_hr, c.upsample,
                                        c.upsample_low, use_lowres=True, output=c.output))
        self.add_module("lr", WaveRNN(WaveRNNConfig(
            c.num_layers_lr, c.layer_size_lr, c.upsample // c.upsample_low,
            use_lowres=False, output=c.output)))
        self.head = get_output_head(c.output)

    @property
    def lr_net(self) -> WaveRNN:
        return self._modules["lr"]

    @staticmethod
    def shift(x):
        """The teacher-forcing input: the previous sample, zero first."""
        return F.pad(x[:, :-1], (1, 0))

    def losses(self, batch) -> dict:
        """The joint teacher-forced losses {"hr", "lr", "loss": their mean}."""
        x, x_low, mel = batch["x"], batch["x_low"], batch["mel"]
        out_hr = self.hr(mel, self.shift(x), x_low)
        out_lr = self.lr_net(mel, self.shift(x_low))
        m = min(out_hr.shape[1], x.shape[1])
        loss_hr = self.head.loss(out_hr[:, :m], x[:, :m])
        m = min(out_lr.shape[1], x_low.shape[1])
        loss_lr = self.head.loss(out_lr[:, :m], x_low[:, :m])
        return {"hr": loss_hr, "lr": loss_lr, "loss": (loss_hr + loss_lr) / 2}

    @staticmethod
    def chunks(mel, x_low, num_chunks: int, upsample: int, upsample_low: int):
        """The high-rate pass's inputs: (mel_seed (num_chunks, 1 + T_mel/num_chunks,
        80), low_seed (num_chunks, lr_per_frame + low_len/num_chunks)). Each chunk is
        seeded with the previous chunk's last mel frame (−5 for the first) and its last
        upsample // upsample_low low-rate samples (zeros for the first): one frame's
        worth, so that every conditioning stream stays aligned."""
        T_mel = (mel.shape[1] // num_chunks) * num_chunks
        mel_c = mel[:, :T_mel].reshape(num_chunks, -1, mel.shape[2])
        low_len = (x_low.shape[1] // num_chunks) * num_chunks
        xl_c = x_low[:, :low_len].reshape(num_chunks, -1)
        lr_per_frame = upsample // upsample_low
        seed_frame = torch.full((num_chunks, 1, mel.shape[2]), MEL_PAD, device=mel.device,
                                dtype=mel.dtype)
        seed_frame[1:, 0] = mel_c[:-1, -1]
        seed_low = xl_c.new_zeros(num_chunks, lr_per_frame)
        seed_low[1:] = xl_c[:-1, -lr_per_frame:]
        return (torch.cat([seed_frame, mel_c], dim=1), torch.cat([seed_low, xl_c], dim=1))

    @torch.no_grad()
    def infer(self, mel, generator: torch.Generator, num_chunks: int = 20,
              return_logits: bool = False):
        """Chunk-parallel dual-rate synthesis of one utterance (mel (1, T, 80)) →
        (x_low (1, T·upsample/upsample_low), audio (1, (T // num_chunks)·num_chunks·
        upsample)). With `return_logits` also a dict of what each pass sampled from:
        lr_logits, hr_logits, and the high-rate pass's inputs mel_seed, low_seed and
        its samples audio_c (num_chunks rows, seed frame included)."""
        c = self.config
        if return_logits:
            x_low, lr_logits = self.lr_net.sample(mel, generator=generator, return_logits=True)
        else:
            x_low = self.lr_net.sample(mel, generator=generator)
        mel_seed, low_seed = self.chunks(mel, x_low, num_chunks, c.upsample, c.upsample_low)
        out = self.hr.sample(mel_seed, low_seed, generator=generator,
                             return_logits=return_logits)
        audio_c = out[0] if return_logits else out
        audio = audio_c[:, c.upsample:].reshape(1, -1)  # each chunk's seed frame dropped
        if not return_logits:
            return x_low, audio
        return x_low, audio, {"lr_logits": lr_logits, "hr_logits": out[1],
                              "mel_seed": mel_seed, "low_seed": low_seed, "audio_c": audio_c}
