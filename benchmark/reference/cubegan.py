"""Plain PyTorch reference of Cubegan v1 (TTS-Cube's `cube/networks/cubegan.py`): the
Languasito2 text model, the HiFi-GAN v1 generator with plain stages, the period and scale
discriminators, the GAN mel, the losses, BERT's encoder under `lm_condition`, and the
training step with its per-partition AdamW.

Every function takes the weights as one dict `W` of tensors named as the program's
state dict names them, the sizes from the configuration file `c` (a dict), and a
`Precision` `q` for the operands of each matmul and conv. Nothing here imports the
program under test, and nothing is taken from it but those names."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.ops import (Precision, conv1d, conv_transpose1d, dense, lstm,
                                     masked_embed, spectral_norm, weight_norm)

LRELU = 0.1
FP32 = Precision(None)


# -- the text model ----------------------------------------------------------------------


def tower(W, c, X, side: str, q=FP32):
    """One tower (`tower_t` or `tower_g`): phone embedding → char CNN (tanh) → char
    BiLSTM, the speaker embedding beside it and, with LM conditioning, the word BiLSTM's
    output gathered per phone."""
    lc = c["languasito"]
    p = f"lang.{side}"
    x_char = X["x_char"]
    h = masked_embed(W[f"{p}.phon_emb.embedding"], x_char)
    k = lc["char_cnn_kernel"]
    for i in range(lc["char_cnn_layers"]):
        h = torch.tanh(conv1d(q, h, W[f"{p}.char_cnn_{i}.kernel"], W[f"{p}.char_cnn_{i}.bias"],
                              padding=(k - 1) // 2))
    h = lstm(q, h, W, f"{p}.char_rnn", lc["char_rnn_layers"])
    spk = masked_embed(W[f"{p}.speaker_emb.embedding"], X["x_speaker"])
    parts = [h, spk.expand(h.shape[0], h.shape[1], spk.shape[-1])]
    if lc.get("cond_type"):
        words = lstm(q, X["x_words"], W, f"{p}.lm", lc["lm_rnn_layers"])
        idx = X["x_phon2word"].long()[:, :, None].expand(-1, -1, words.shape[-1])
        parts.append(torch.gather(words, 1, idx))
    return torch.cat(parts, dim=-1)


def regulate(h, frame2phone):
    return torch.gather(h, 1, frame2phone.long()[:, :, None].expand(-1, -1, h.shape[-1]))


def frame2phone(durations, n_valid, max_frames: int):
    """Frame f belongs to phone p where ends[p − 1] ≤ f < ends[p]; frames past the
    utterance take its last phone. Returns (B, F) indices and the (B, F) frame mask."""
    ends = torch.cumsum(durations.long(), dim=1)
    frames = torch.arange(max_frames, device=durations.device)
    f2p = (frames[None, :, None] >= ends[:, None, :]).sum(-1)
    f2p = torch.minimum(f2p, torch.clamp(n_valid.long() - 1, min=0)[:, None])
    return f2p, frames[None, :] < ends[:, -1:]


def dur_logits(W, c, h_t, q=FP32):
    rnn = lstm(q, h_t, W, "lang.dur_rnn", c["languasito"]["dur_rnn_layers"])
    return dense(q, rnn, W["lang.dur_output.weight"], W["lang.dur_output.bias"])


def pitch_head(W, c, h_t, f2p, q=FP32):
    """The frame-level pitch head's two logits (pitch, VUV) before the sigmoid."""
    rnn = lstm(q, regulate(h_t, f2p), W, "lang.pitch_rnn", c["languasito"]["pitch_rnn_layers"])
    return dense(q, rnn, W["lang.pitch_output.weight"], W["lang.pitch_output.bias"])


def cond_forward(W, c, X, f2p, pitch, q=FP32):
    """The frame-level 80-d conditioning from the GAN tower, the frame map and the
    pitch (Hz)."""
    h = regulate(tower(W, c, X, "tower_g", q), f2p)
    h = torch.cat([h, (pitch / c["languasito"]["max_pitch"])[:, :, None]], dim=-1)
    rnn = lstm(q, h, W, "lang.cond_rnn", c["languasito"]["cond_rnn_layers"])
    return dense(q, rnn, W["lang.cond_output.weight"], W["lang.cond_output.bias"])


def text_forward(W, c, X, q=FP32):
    """Teacher-forced (training): (duration logits, pitch, VUV, conditioning) from the
    batch's own frame map and pitch."""
    h_t = tower(W, c, X, "tower_t", q)
    po = pitch_head(W, c, h_t, X["y_frame2phone"], q)
    cond = cond_forward(W, c, X, X["y_frame2phone"], X["y_pitch"], q)
    return dur_logits(W, c, h_t, q), torch.sigmoid(po[..., 0]), torch.sigmoid(po[..., 1]), cond


# -- the generator -----------------------------------------------------------------------


def _wn(W, name):
    return weight_norm(W[f"{name}.v"], W[f"{name}.g"])


def generator(W, c, cond, q=FP32):
    """HiFi-GAN v1 with plain stages: cond (B, F, 80) → audio (B, F·hop)."""
    h = c["hifigan"]
    x = conv1d(q, cond, _wn(W, "gen.conv_pre"), W["gen.conv_pre.bias"], padding=3)
    kernels, dilations = h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        x = conv_transpose1d(q, F.leaky_relu(x, LRELU), _wn(W, f"gen.up_{i}"),
                             W[f"gen.up_{i}.bias"], u, (k - u) // 2)
        acc = 0
        for j, (rk, dils) in enumerate(zip(kernels, dilations)):
            y = x
            for m, d in enumerate(dils):
                a = f"gen.res_{i}_{j}.WNConv1d_{2 * m}"
                b = f"gen.res_{i}_{j}.WNConv1d_{2 * m + 1}"
                t = conv1d(q, F.leaky_relu(y, LRELU), _wn(W, a), W[f"{a}.bias"],
                           padding=d * (rk - 1) // 2, dilation=d)
                t = conv1d(q, F.leaky_relu(t, LRELU), _wn(W, b), W[f"{b}.bias"],
                           padding=(rk - 1) // 2)
                y = y + t
            acc = acc + y
        x = acc / len(kernels)
    x = F.leaky_relu(x, 0.01)
    audio = torch.tanh(conv1d(q, x, _wn(W, "gen.conv_post"), W["gen.conv_post.bias"],
                              padding=3))[..., 0]
    return audio[:, : cond.shape[1] * math.prod(h["upsample_rates"])]


# -- the discriminators --------------------------------------------------------------------


def period_disc(W, c, name: str, period: int, x, q=FP32):
    """Scores (B, ·) and feature maps of one period discriminator."""
    B, T = x.shape
    if T % period:
        x = F.pad(x[:, None], (0, period - T % period), mode="reflect")[:, 0]
    h = x.reshape(B, 1, -1, period)
    n = len(c["discriminators"]["mpd_channels"]) + 1
    fmap = []
    for i in range(n + 1):
        conv = f"{name}.conv_{i}" if i < n else f"{name}.conv_post"
        _, stride, pad = (5, 3, 2) if i < n - 1 else (5, 1, 2) if i == n - 1 else (3, 1, 1)
        h = F.conv2d(q(h), q(_wn(W, conv)), W[f"{conv}.bias"], (stride, 1), (pad, 0))
        if i < n:
            h = F.leaky_relu(h, LRELU)
        fmap.append(h)
    return h.reshape(B, -1), fmap


MSD_LAYERS = ((1, 15, 1, 7, 1), (1, 41, 2, 20, 4), (2, 41, 2, 20, 16), (4, 41, 4, 20, 16),
              (8, 41, 4, 20, 16), (8, 41, 1, 20, 16), (8, 5, 1, 2, 1))  # width ×, k, s, p, g


def scale_disc(W, c, U, name: str, spectral: bool, x, update: bool = False, q=FP32):
    """Scores and feature maps of one scale discriminator; a spectral one reads its u
    from `U` and, where `update`, writes u' back."""
    width = c["discriminators"]["msd_width"]
    h = x[:, :, None]
    fmap = []
    in_ch = 1
    layers = list(MSD_LAYERS) + [None]
    for i, spec in enumerate(layers):
        conv = f"{name}.conv_{i}" if spec is not None else f"{name}.conv_post"
        if spec is None:
            feat, k, s, p, g = 1, 3, 1, 1, 1
        else:
            mult, k, s, p, g = spec
            feat = mult * width
            g = math.gcd(g, math.gcd(in_ch, feat))
        if spectral:
            w, U[f"{conv}.u"] = spectral_norm(W[f"{conv}.kernel"], U[f"{conv}.u"], update)
        else:
            w = _wn(W, conv)
        h = conv1d(q, h, w, W[f"{conv}.bias"], stride=s, padding=p, groups=g)
        if spec is not None:
            h = F.leaky_relu(h, LRELU)
        fmap.append(h)
        in_ch = feat
    return h.reshape(h.shape[0], -1), fmap


def mpd(W, c, y, y_hat, q=FP32):
    out = ([], [], [], [])
    for p in c["discriminators"]["mpd_periods"]:
        r, fr = period_disc(W, c, f"mpd.p{p}", p, y, q)
        g, fg = period_disc(W, c, f"mpd.p{p}", p, y_hat, q)
        for lst, v in zip(out, (r, g, fr, fg)):
            lst.append(v)
    return out


def avgpool42(x):
    return F.avg_pool1d(x[:, None], 4, 2, padding=2, count_include_pad=True)[:, 0]


def msd(W, c, U, y, y_hat, update: bool = False, q=FP32):
    out = ([], [], [], [])
    for i in range(3):
        name = f"msd.s{i}"
        r, fr = scale_disc(W, c, U, name, i == 0, y, update and i == 0, q)
        g, fg = scale_disc(W, c, U, name, i == 0, y_hat, False, q)
        for lst, v in zip(out, (r, g, fr, fg)):
            lst.append(v)
        y, y_hat = avgpool42(y), avgpool42(y_hat)
    return out


def disc_loss(rs, gs):
    return sum(torch.mean((1.0 - r) ** 2) + torch.mean(g ** 2) for r, g in zip(rs, gs))


def gen_loss(gs):
    return sum(torch.mean((1.0 - g) ** 2) for g in gs)


def feature_loss(frs, fgs):
    return 2.0 * sum(torch.mean(torch.abs(r - g)) for fr, fg in zip(frs, fgs)
                     for r, g in zip(fr, fg))


# -- the GAN mel ---------------------------------------------------------------------------


def _hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                    200.0 / 3 * m)


def mel_constants(c, device):
    """(cos, sin, mel basis) of the GAN mel: a periodic Hann window over n_fft, the
    real DFT, the Slaney mel filterbank (area-normalised) from fmin to fmax."""
    m = c["gan_mel"]
    n_fft, sr, n_mels = m["n_fft"], c["sample_rate"], m["n_mels"]
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    ang = 2.0 * np.pi * n * k / n_fft
    cos_m = np.cos(ang) * window[:, None]
    sin_m = -np.sin(ang) * window[:, None]
    freqs = np.linspace(0.0, sr / 2, n_fft // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(m["fmin"]), _hz_to_mel(m["fmax"]), n_mels + 2))
    ramps = edges[:, None] - freqs[None, :]
    lower = -ramps[:-2] / np.diff(edges)[:-1, None]
    upper = ramps[2:] / np.diff(edges)[1:, None]
    basis = np.maximum(0.0, np.minimum(lower, upper)) * (2.0 / (edges[2:] - edges[:-2]))[:, None]
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in (cos_m, sin_m, np.ascontiguousarray(basis.T)))


def gan_mel(consts, c, y, q=FP32):
    """ln of the mel magnitude (floor 1e-5) of y (B, T), reflect-padded by
    (n_fft − hop)/2 on each side."""
    cos_m, sin_m, basis = consts
    n_fft, hop = c["gan_mel"]["n_fft"], c["hop_size"]
    pad = (n_fft - hop) // 2
    frames = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0].unfold(-1, n_fft, hop)
    re, im = q(frames) @ q(cos_m), q(frames) @ q(sin_m)
    mag = torch.sqrt(re * re + im * im + 1e-9)
    return torch.log(torch.clamp(q(mag) @ q(basis), min=1e-5))


def text_losses(c, dur_lg, pitch, vuv, X):
    """Duration cross-entropy over the real phones; VUV-weighted pitch L1 and VUV L1
    over the valid frames."""
    max_pitch = c["languasito"]["max_pitch"]
    mask = (X["x_char"] != 0).float()
    target = X["y_dur"].long().clamp(0, dur_lg.shape[-1] - 1)
    nll = -torch.gather(torch.log_softmax(dur_lg, -1), -1, target[..., None])[..., 0]
    loss_dur = (nll * mask).sum() / mask.sum().clamp(min=1)
    t_pitch = X["y_pitch"]
    t_vuv = (t_pitch > 1).float()
    fm = X["y_frame_mask"].float()
    n = fm.sum().clamp(min=1.0)
    loss_pitch = ((torch.abs(t_pitch / max_pitch - pitch) * t_vuv * fm).sum() / n
                  + (torch.abs(t_vuv - vuv) * fm).sum() / n)
    return loss_dur, loss_pitch


# -- BERT's encoder ------------------------------------------------------------------------


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def bert(W, c, ids, mask, q=FP32):
    """BERT's last hidden state (post-LN, erf GELU, positions from 0, token type 0)."""
    lm = c["lm"]
    eps, heads = lm["layer_norm_eps"], lm["num_attention_heads"]
    T = ids.shape[1]
    h = W["hf.word_emb.weight"][ids] + W["hf.pos_emb.weight"][:T][None]
    h = layer_norm(h + W["hf.type_emb.weight"][0], W["hf.emb_ln.weight"], W["hf.emb_ln.bias"], eps)
    bias = torch.where(mask[:, None, None, :].bool(), 0.0, torch.finfo(torch.float32).min)
    B, _, H = h.shape
    hd = H // heads
    for i in range(lm["num_hidden_layers"]):
        p = f"hf.layer_{i}"
        d = lambda x, n: dense(q, x, W[f"{p}.{n}.weight"], W[f"{p}.{n}.bias"])
        qh, kh, vh = (d(h, f"attn.{n}").view(B, T, heads, hd).transpose(1, 2)
                      for n in ("query", "key", "value"))
        probs = torch.softmax(q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(hd) + bias, -1)
        ctx = (q(probs) @ q(vh)).transpose(1, 2).reshape(B, T, H)
        h = layer_norm(h + d(ctx, "attn.output"), W[f"{p}.attn_ln.weight"],
                       W[f"{p}.attn_ln.bias"], eps)
        f = d(F.gelu(d(h, "ff_in")), "ff_out")
        h = layer_norm(h + f, W[f"{p}.ff_ln.weight"], W[f"{p}.ff_ln.bias"], eps)
    return h


def lm_condition(W, c, X, q=FP32):
    """X with `x_words`: BERT's hidden state per word (a zero row for word position 0)."""
    if not c["languasito"].get("cond_type"):
        return X
    h = bert(W, c, X["x_tok_ids"], X["x_tok_mask"], q)
    h = torch.cat([h.new_zeros(h.shape[0], 1, h.shape[2]), h], 1)
    idx = X["x_word2tok"].long()[:, :, None].expand(-1, -1, h.shape[2])
    return dict(X, x_words=torch.gather(h, 1, idx))


# -- the training step -----------------------------------------------------------------------


def partition(name: str) -> str:
    """g (generator, tower_g, cond_rnn, cond_output), d (discriminators), t (the rest
    of the text model), b (anything else)."""
    top, _, rest = name.partition(".")
    if top == "gen":
        return "g"
    if top in ("mpd", "msd"):
        return "d"
    if top == "lang":
        return "g" if rest.split(".")[0] in ("tower_g", "cond_rnn", "cond_output") else "t"
    return "b"


class Trainer:
    """The reference GAN step on its own copy of the weights: one forward, the
    discriminators' AdamW step on the detached ŷ (writing the scale discriminator's u),
    then the generator and text losses against the updated discriminators and the
    AdamW (g, t) and Adam (b) steps. `trainable` names the leaves that train."""

    def __init__(self, W: dict, c: dict, trainable, q=FP32):
        self.c, self.q = c, q
        self.P = {n: W[n].detach().clone().requires_grad_(True) for n in trainable}
        self.frozen = {n: v for n, v in W.items() if n not in self.P}
        self.U = {n: v.clone() for n, v in W.items() if n.endswith(".u")}
        self.m = {n: torch.zeros_like(p) for n, p in self.P.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.P.items()}
        self.count = {part: 0 for part in "gdtb"}
        self.step_no = 0
        self.mel = None

    def resume(self, m: dict, v: dict, count: dict, step_no: int):
        """Go on from another run's optimizer state: each leaf's moments (zero where it
        has none yet), each partition's count of updates and the step number that sets
        the learning rate."""
        self.m = {n: m[n].clone() if n in m else torch.zeros_like(p) for n, p in self.P.items()}
        self.v = {n: v[n].clone() if n in v else torch.zeros_like(p) for n, p in self.P.items()}
        self.count = {part: count.get(part, 0) for part in "gdtb"}
        self.step_no = step_no

    def weights(self, detach_parts=""):
        W = dict(self.frozen)
        for n, p in self.P.items():
            W[n] = p.detach() if partition(n) in detach_parts else p
        return W

    def _update(self, parts: str):
        t = self.c["training"]
        lr = t["lr"] / (1.0 + t["lr_decay"] * self.step_no)
        with torch.no_grad():
            for part in parts:
                names = [n for n in self.P if partition(n) == part]
                if not names:
                    continue
                self.count[part] += 1
                k = self.count[part]
                if part == "b":
                    rate, (b1, b2), wd = t["b_lr"], t["b_betas"], 0.0
                else:
                    rate, (b1, b2), wd = lr, t["betas"], t["weight_decay"]
                for n in names:
                    p, g = self.P[n], self.P[n].grad
                    g = torch.zeros_like(p) if g is None else g
                    p.mul_(1.0 - rate * wd)
                    self.m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                    self.v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    denom = self.v[n].sqrt() / math.sqrt(1.0 - b2 ** k) + t["eps"]
                    p.addcdiv_(self.m[n], denom, value=-rate / (1.0 - b1 ** k))

    def step(self, X, starts):
        """One step on batch X (tensors) with crop starts (B,); returns its losses
        (floats), and the grads of the step's first update in `self.last_grads`."""
        c, q = self.c, self.q
        if self.mel is None:
            self.mel = mel_constants(c, X["x_char"].device)
        for p in self.P.values():
            p.grad = None
        W = self.weights()
        dur_lg, pitch, vuv, cond = text_forward(W, c, lm_condition(W, c, X, q), q)
        window = min(c["training"]["crop_frames"], cond.shape[1])
        hop = c["hop_size"]
        dev = cond.device
        rows = torch.arange(cond.shape[0], device=dev)[:, None]
        st = starts.to(dev)[:, None]
        cond_w = cond[rows, st + torch.arange(window, device=dev)]
        y = X["y_audio"][rows, st * hop + torch.arange(window * hop, device=dev)]
        y_hat = generator(W, c, cond_w, q)

        rs, gs, _, _ = mpd(W, c, y, y_hat.detach(), q)
        loss_d = disc_loss(rs, gs)
        rs, gs, _, _ = msd(W, c, self.U, y, y_hat.detach(), update=True, q=q)
        loss_d = loss_d + disc_loss(rs, gs)
        loss_d.backward()
        grads = {n: p.grad.clone() for n, p in self.P.items()
                 if p.grad is not None and partition(n) == "d"}
        self._update("d")

        Wd = self.weights(detach_parts="d")
        loss_dur, loss_pitch = text_losses(c, dur_lg, pitch, vuv, X)
        loss_mel = torch.mean(torch.abs(gan_mel(self.mel, c, y, q) - gan_mel(self.mel, c, y_hat, q)))
        _, gs_f, fr_f, fg_f = mpd(Wd, c, y, y_hat, q)
        _, gs_s, fr_s, fg_s = msd(Wd, c, self.U, y, y_hat, q=q)
        loss_fm = feature_loss(fr_f, fg_f) + feature_loss(fr_s, fg_s)
        loss_adv = gen_loss(gs_f) + gen_loss(gs_s)
        loss_g = c["training"]["mel_weight"] * loss_mel + loss_fm + loss_adv
        loss_t = loss_dur + loss_pitch
        (loss_g + loss_t).backward()
        grads.update({n: p.grad.clone() for n, p in self.P.items()
                      if p.grad is not None and partition(n) != "d"})
        self._update("gtb")
        self.last_grads = grads
        self.step_no += 1
        return {k: float(v.detach()) for k, v in dict(
            loss_d=loss_d, loss_g=loss_g, loss_t=loss_t, loss_mel=loss_mel, loss_fm=loss_fm,
            loss_adv=loss_adv, loss_dur=loss_dur, loss_pitch=loss_pitch).items()}
