"""Operations (2 per multiply-add) that Cubegan's work needs at a cell's shapes, counted
from the configuration file `c` (a dict), whatever implements the work: the text model,
the generator, the discriminators, the GAN mel, BERT's encoder, kernel B1 (the
generator's last stage) and kernel B2 (its backward), and their bytes. Element-wise work
(activations, norms, the optimizer) is left out."""

from __future__ import annotations

import math


def conv_out(t: int, k: int, stride: int = 1, pad: int = 0, dilation: int = 1) -> int:
    return (t + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def lstm(batch: int, steps: int, d_in: int, hidden: int, layers: int,
         directions: int = 2) -> int:
    total, d = 0, d_in
    for _ in range(layers):
        total += directions * 2 * batch * steps * 4 * hidden * (d + hidden)
        d = directions * hidden
    return total


def tower_width(c) -> int:
    lc = c["languasito"]
    return (2 * lc["char_rnn_size"] + lc["speaker_emb_size"]
            + (2 * lc["lm_rnn_size"] if lc.get("cond_type") else 0))


def tower(c, batch: int, phones: int, words: int = 0) -> int:
    lc = c["languasito"]
    k, w = lc["char_cnn_kernel"], lc["char_cnn_size"]
    total = 2 * batch * phones * w * k * (lc["phon_emb_size"] + (lc["char_cnn_layers"] - 1) * w)
    total += lstm(batch, phones, w, lc["char_rnn_size"], lc["char_rnn_layers"])
    if lc.get("cond_type"):
        total += lstm(batch, words, c["lm"]["hidden_size"], lc["lm_rnn_size"],
                      lc["lm_rnn_layers"])
    return total


def text_model(c, batch: int, phones: int, frames: int, words: int = 0) -> int:
    """Both towers, the duration head over the phones, the pitch and conditioning
    heads over the frames: the same for free synthesis and the teacher-forced pass."""
    lc = c["languasito"]
    t = tower_width(c)
    total = 2 * tower(c, batch, phones, words)
    total += lstm(batch, phones, t, lc["dur_rnn_size"], lc["dur_rnn_layers"])
    total += 2 * batch * phones * 2 * lc["dur_rnn_size"] * (lc["max_duration"] + 1)
    total += lstm(batch, frames, t, lc["pitch_rnn_size"], lc["pitch_rnn_layers"])
    total += 2 * batch * frames * 2 * lc["pitch_rnn_size"] * 2
    total += lstm(batch, frames, t + 1, lc["cond_rnn_size"], lc["cond_rnn_layers"])
    total += 2 * batch * frames * 2 * lc["cond_rnn_size"] * lc["cond_size"]
    return total


def stage_lengths(c, frames: int) -> list:
    """Samples after each upsample stage for `frames` input frames."""
    h = c["hifigan"]
    out, t = [], frames
    for u, k in zip(h["upsample_rates"], h["upsample_kernel_sizes"]):
        t = (t - 1) * u - 2 * ((k - u) // 2) + k
        out.append(t)
    return out


def mrf(c, batch: int, t: int, ch: int) -> int:
    h = c["hifigan"]
    return sum(2 * len(d) * 2 * batch * t * ch * ch * k
               for k, d in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]))


def generator(c, batch: int, frames: int) -> int:
    h = c["hifigan"]
    ch = h["upsample_initial_channel"]
    total = 2 * batch * frames * ch * h["num_mels"] * 7
    t = frames
    for (u, k), t_out in zip(zip(h["upsample_rates"], h["upsample_kernel_sizes"]),
                             stage_lengths(c, frames)):
        total += 2 * batch * t * ch * (ch // 2) * k
        ch //= 2
        total += mrf(c, batch, t_out, ch)
        t = t_out
    return total + 2 * batch * t * ch * 7


def last_stage_input(c, frames: int) -> tuple:
    """(samples, channels) that the generator's last stage reads for `frames` frames."""
    h = c["hifigan"]
    return stage_lengths(c, frames)[-2], h["upsample_initial_channel"] >> (
        len(h["upsample_rates"]) - 1)


def tail(c, batch: int, frames: int) -> tuple:
    """(operations, bytes) of kernel B1 over the last stage for `frames` frames, fp32
    input, packed weights and output: upsample, the MRF, conv_post."""
    h = c["hifigan"]
    t_in, c_in = last_stage_input(c, frames)
    ch, u = c_in // 2, h["upsample_rates"][-1]
    t_out = t_in * u
    flops = 2 * batch * t_in * c_in * ch * u + mrf(c, batch, t_out, ch) + 2 * batch * t_out * ch * 7
    weights = (c_in * ch * u + ch
               + sum(2 * len(d) * (k * ch * ch + ch)
                     for k, d in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]))
               + 7 * ch + 1)
    return flops, 4 * (batch * t_in * c_in + batch * t_out + weights)


def tail_grad(c, batch: int, frames: int) -> tuple:
    """(operations, bytes) of kernel B2: the stage's forward again, then each conv's
    input cotangent and weight grad (3 × B1's operations); inputs z, dy and the
    weights read, dz and the weight grads written."""
    flops, _ = tail(c, batch, frames)
    t_in, c_in = last_stage_input(c, frames)
    weights = tail(c, 1, frames)[1] // 4 - (t_in * c_in + t_in * c["hifigan"]["upsample_rates"][-1])
    dy = batch * t_in * c["hifigan"]["upsample_rates"][-1]
    return 3 * flops, 4 * (2 * batch * t_in * c_in + dy + 2 * weights)


def _period_layers(c, batch: int, samples: int, period: int) -> list:
    chans = list(c["discriminators"]["mpd_channels"])
    t = -(-samples // period) * period
    hgt = t // period
    out, c_in = [], 1
    for i, c_out in enumerate(chans + [chans[-1], 1]):
        k, s, p = (5, 3, 2) if i < len(chans) else (5, 1, 2) if i == len(chans) else (3, 1, 1)
        hgt = conv_out(hgt, k, s, p)
        out.append(2 * batch * hgt * period * c_out * c_in * k)
        c_in = c_out
    return out


MSD_LAYERS = ((1, 15, 1, 7, 1), (1, 41, 2, 20, 4), (2, 41, 2, 20, 16), (4, 41, 4, 20, 16),
              (8, 41, 4, 20, 16), (8, 41, 1, 20, 16), (8, 5, 1, 2, 1))  # width ×, k, s, p, g


def _scale_layers(c, batch: int, samples: int) -> list:
    width = c["discriminators"]["msd_width"]
    out, c_in, t = [], 1, samples
    for mult, k, s, p, g in MSD_LAYERS + ((None, 3, 1, 1, 1),):
        c_out = 1 if mult is None else mult * width
        g = math.gcd(g, math.gcd(c_in, c_out))
        t = conv_out(t, k, s, p)
        out.append(2 * batch * t * c_out * (c_in // g) * k)
        c_in = c_out
    return out


def discriminator_layers(c, batch: int, samples: int) -> list:
    """Per discriminator, the operations of its layers over one input of `samples`."""
    d = c["discriminators"]
    out = [_period_layers(c, batch, samples, p) for p in d["mpd_periods"]]
    t = samples
    for _ in range(3):
        out.append(_scale_layers(c, batch, t))
        t = conv_out(t, 4, 2, 2)
    return out


def gan_mel(c, batch: int, samples: int) -> int:
    m = c["gan_mel"]
    n_fft, n_freq = m["n_fft"], m["n_fft"] // 2 + 1
    frames = (samples + (n_fft - c["hop_size"]) - n_fft) // c["hop_size"] + 1
    return 2 * batch * frames * n_freq * (2 * n_fft + m["n_mels"])


def encoder(c, batch: int, tokens: int) -> int:
    lm = c["lm"]
    hid, inter = lm["hidden_size"], lm["intermediate_size"]
    per_layer = 2 * batch * tokens * (4 * hid * hid + 2 * hid * inter)
    per_layer += 4 * batch * tokens * tokens * hid
    return lm["num_hidden_layers"] * per_layer


def synthesis_batch(c, batch: int, phones: int, frames: int) -> int:
    """One free-synthesis batch: the text model and the generator over every frame."""
    return text_model(c, batch, phones, frames) + generator(c, batch, frames)


def train_step(c, batch: int, phones: int, frames: int, words: int = 0,
               tokens: int = 0) -> int:
    """One GAN step: forward and backward (input and weight grads) of the text model,
    the encoder and the generator on its crop (3 × forward); the mel of y and ŷ and
    its backward into ŷ; the discriminators on y and ŷ in both phases (4 forwards),
    their weight grads in the discriminators' step (2), and input grads in both phases
    (2 in the discriminators' step, where the first layers need none, and 1 into ŷ)."""
    t = c["training"]
    crop = min(t["crop_frames"], frames)
    samples = crop * c["hop_size"]
    total = 3 * text_model(c, batch, phones, frames, words)
    if c["languasito"].get("cond_type"):
        total += 3 * encoder(c, batch, tokens)
    total += 3 * generator(c, batch, crop)
    total += 3 * gan_mel(c, batch, samples)
    layers = discriminator_layers(c, batch, samples)
    every = sum(sum(d) for d in layers)
    firsts = sum(d[0] for d in layers)
    return total + 9 * every - 2 * firsts
