"""Cubegan, counterpart of `ttscube_tpu/models/cubegan.py`: the config, inference
(`Cubegan.infer`, whole or in windows of `chunk_frames`) and the GAN training step.

Training, as in the JAX module: one forward of the text towers and the generator;
the discriminators' step first, on the detached ŷ (it writes the MSD's spectral u);
then the generator and text losses against the UPDATED discriminators, whose
parameters take no grads there (activations still carry grads into ŷ); one backward
into the generator and the text towers, and their step. Four optimizer partitions:
g (generator, `tower_g`, `cond_rnn`, `cond_output`), d (discriminators), t (the rest
of the text model) with AdamW(0.8, 0.99, wd 0.01) at lr/(1 + lr_decay·step), and b
(anything else) with Adam at 1e-6.

Differences from the JAX module: the port's model holds its parameters (and the MSD's
spectral u, as buffers) and the step updates them in place; `Cubegan(config)` builds
the serving model, `Cubegan(config, train=True)` adds the discriminators; crop offsets
are passed in or drawn from a `torch.Generator` (JAX and torch random bits differ),
made for each train step from (seed, step) and for each validation from the seed
alone, as JAX derives its keys: so validation never moves the training crops, and
every validation sees the same windows.

bf16 training, as in the JAX module: `hifigan.compute_dtype="bfloat16"` runs the
generator's convs (conv_post excepted) and `disc_compute_dtype="bfloat16"` the
discriminators' convs with bf16 operands, each result rounded once to bf16 and then
fp32 (`ops/conv.py`); weights, grads and the AdamW moments stay fp32. The fused tail's
backward (B2) has no bf16 form in either package, so `fused_tail_train` with bf16
raises where the JAX module warns and runs the plain path.

HF conditioning, as in the JAX module: `Cubegan(config, lm_config=...)` holds the
transformer encoder as `hf` (the JAX tree's `params["hf"]`, the `b` partition), and
`lm_condition` turns the batch's token window into `x_words` before the text model runs,
in `forward`, `infer`, `durations` and `gan_forward`. fastText conditioning needs no
module here: the collate puts the table's vectors in `x_words`.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn as nn
from torch.distributed.fsdp import FSDPModule

from ttscube_tpu_torch.dsp.mel import MelSpec, gan_mel_config
from ttscube_tpu_torch.models.hifigan import (_DTYPES, Generator, HifiganConfig,
                                              MultiPeriodDiscriminator,
                                              MultiScaleDiscriminator, discriminator_loss,
                                              feature_loss, generate_chunked,
                                              generator_loss)
from ttscube_tpu_torch.models.languasito import (Languasito2, LanguasitoConfig,
                                                 languasito_losses)
from ttscube_tpu_torch.models.lm import LMConfig, TransformerEncoder

TRAIN_FRAMES = 50   # 12,000-sample GAN window
VAL_FRAMES = 200    # 48,000-sample validation window


@dataclasses.dataclass(frozen=True)
class CubeganConfig:
    languasito: LanguasitoConfig
    hifigan: HifiganConfig = HifiganConfig()
    lr: float = 2e-4
    lr_decay: float = 1e-5
    sample_rate: int = 24000
    hop_size: int = 240
    mel_weight: float = 45.0
    mpd_channels: tuple = (32, 128, 512, 1024)
    msd_width: int = 128
    disc_compute_dtype: str = "float32"  # or "bfloat16": the discriminators' convs

    @property
    def torch_disc_compute_dtype(self):
        return _DTYPES[self.disc_compute_dtype]


def check_fused_tail_train(hifigan: HifiganConfig) -> None:
    """`fused_tail_train` runs B1 and B2, which take fp32 only: with another
    `compute_dtype` it raises (the JAX module falls back to the plain path)."""
    if hifigan.fused_tail_train and hifigan.compute_dtype != "float32":
        raise ValueError(f"fused_tail_train with compute_dtype={hifigan.compute_dtype}: the "
                         "fused tail's backward kernel (B2) is fp32 only; drop "
                         "--fused-tail-train for a bf16 run")


@contextlib.contextmanager
def _frozen(*modules):
    """The modules' parameters take no grads inside (their activations still do)."""
    params = [p for m in modules for p in m.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def batch_to_torch(batch: dict, device) -> dict:
    """A collated numpy batch as tensors on `device`: bools as bool (`x_tok_mask`), ints
    as int64, floats as fp32 (`x_words` among them)."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        dtype = (torch.bool if a.dtype == np.bool_ else
                 torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32)
        out[k] = torch.as_tensor(a).to(device=device, dtype=dtype)
    return out


class Cubegan(nn.Module):
    """Text model (`lang`) and generator (`gen`), plus with `train=True` the
    discriminators (`mpd`, `msd`) and the GAN mel, and with `lm_config` the HF
    conditioning encoder (`hf`); the parameter names mirror the JAX tree {"lang",
    "gen", "mpd", "msd", "hf"}."""

    def __init__(self, config: CubeganConfig, train: bool = False,
                 lm_config: LMConfig | None = None):
        super().__init__()
        self.config = config
        self.lang = Languasito2(config.languasito)
        self.gen = Generator(config.hifigan)
        if lm_config is not None:
            self.hf = TransformerEncoder(lm_config)
        self.train_mode = train
        if train:
            check_fused_tail_train(config.hifigan)
            cd = config.torch_disc_compute_dtype
            self.mpd = MultiPeriodDiscriminator(channels=config.mpd_channels, compute_dtype=cd)
            self.msd = MultiScaleDiscriminator(width=config.msd_width, compute_dtype=cd)
        self.mel = MelSpec(gan_mel_config(config.sample_rate, hop_length=config.hop_size))

    def _no_autograd(self):
        """inference_mode, or no_grad for a model sharded over a mesh (parallel/mesh.py):
        FSDP2 gathers its weights into tensors that must keep a version counter."""
        return torch.no_grad() if isinstance(self, FSDPModule) else torch.inference_mode()

    def lm_condition(self, X):
        """`X` with `x_words` from the HF encoder: its last hidden state over the token
        window `x_tok_ids` (mask `x_tok_mask`), a zero row put before it, gathered per
        word by `x_word2tok` (a token position + 1; 0 for a missing or padded word). `X`
        itself without an encoder or a token window."""
        if not hasattr(self, "hf") or "x_tok_ids" not in X:
            return X
        hidden = self.hf(X["x_tok_ids"], X.get("x_tok_mask"))
        hidden = torch.cat([hidden.new_zeros(hidden.shape[0], 1, hidden.shape[2]), hidden], 1)
        idx = X["x_word2tok"].long()[:, :, None].expand(-1, -1, hidden.shape[2])
        return dict(X, x_words=torch.gather(hidden, 1, idx))

    def forward(self, X):
        """Teacher-forced synthesis: the generator on the conditioning the text model
        builds from the batch's own alignment and pitch. Returns audio (B, frames·hop)."""
        with self._no_autograd():
            _, _, _, cond = self.lang(self.lm_condition(X))
            return self.gen(cond)

    def durations(self, X):
        """The duration pass: predicted per-phone durations (B, N), zero on padded
        phones."""
        with self._no_autograd():
            return self.lang.durations(self.lm_condition(X))

    def infer(self, X, max_frames: int, chunk_frames: int | None = None):
        """Free synthesis: (audio (B, max_frames·hop) fp32, aux dict). With
        `chunk_frames` the generator runs in windows of that many frames plus a halo
        on each side, one after another (`generate_chunked`), which bounds its memory
        for long utterances and large batches; None runs the whole utterance at once."""
        with self._no_autograd():
            cond, aux = self.lang.infer(self.lm_condition(X), max_frames)
            h = self.config.hifigan
            gen = self.gen.fused if h.fused_tail else self.gen
            if chunk_frames is not None:
                return generate_chunked(gen, cond, h.total_upsample, chunk=chunk_frames), aux
            return gen(cond), aux

    # -- the training step's pieces -----------------------------------------------------

    def crop_starts(self, n_frames, window: int, generator: torch.Generator):
        """Per-item window starts in [0, max(n_frames − window − 1, 0)], drawn on the
        host from `generator`."""
        max_start = torch.clamp(n_frames.cpu() - window - 1, min=0)
        r = (torch.rand(n_frames.shape[0], generator=generator)
             * torch.clamp(max_start, min=1)).long()
        return torch.minimum(r, max_start)

    def _crop(self, cond, audio, starts, window: int):
        """Each item's window of `window` frames from `starts`, and its audio."""
        hop = self.config.hop_size
        starts = starts.to(cond.device)
        rows = torch.arange(cond.shape[0], device=cond.device)[:, None]
        cond_w = cond[rows, starts[:, None] + torch.arange(window, device=cond.device)]
        audio_w = audio[rows, starts[:, None] * hop
                        + torch.arange(window * hop, device=cond.device)]
        return cond_w, audio_w

    def gan_forward(self, batch, window: int, starts=None, generator=None):
        """One text-model + generator forward: ((dur_logits, pitch, vuv, ŷ), y_w), y_w
        the cropped real audio. Window starts come from `starts` or are drawn from
        `generator`."""
        h = self.config.hifigan
        dur_logits, pitch, vuv, cond = self.lang(self.lm_condition(batch))
        window = min(window, cond.shape[1])
        if starts is None:
            starts = self.crop_starts(batch["n_frames"], window, generator)
        cond_w, y_w = self._crop(cond, batch["y_audio"], starts, window)
        check_fused_tail_train(h)
        if h.fused_tail_train:
            y_hat = self.gen.fused_train(cond_w)
        else:
            y_hat = self.gen(cond_w)
        return (dur_logits, pitch, vuv, y_hat), y_w

    def d_loss(self, y_w, y_hat_sg, update_spectral: bool):
        """Discriminator loss on the detached ŷ; writes the MSD's spectral u under
        `update_spectral`."""
        rs, gs, _, _ = self.mpd(y_w, y_hat_sg)
        loss_f = discriminator_loss(rs, gs)
        rs, gs, _, _ = self.msd(y_w, y_hat_sg, update_stats=update_spectral)
        return loss_f + discriminator_loss(rs, gs)

    def gt_losses(self, batch, outs, y_w):
        """Generator + text losses from the forward's outputs, against the current
        discriminators, whose parameters take no grads here. Returns (loss, metrics)."""
        cfg = self.config
        dur_logits, pitch, vuv, y_hat = outs
        loss_duration, loss_pitch = languasito_losses(
            dur_logits, pitch, vuv, batch, cfg.languasito.max_pitch)
        loss_mel_raw = torch.mean(torch.abs(self.mel(y_w) - self.mel(y_hat)))
        with _frozen(self.mpd, self.msd):
            _, gs_f, fr_f, fg_f = self.mpd(y_w, y_hat)
            _, gs_s, fr_s, fg_s = self.msd(y_w, y_hat)
        loss_fm = feature_loss(fr_f, fg_f) + feature_loss(fr_s, fg_s)
        loss_adv = generator_loss(gs_f) + generator_loss(gs_s)
        loss_g = cfg.mel_weight * loss_mel_raw + loss_fm + loss_adv
        loss_t = loss_duration + loss_pitch
        metrics = {"loss_g": loss_g, "loss_t": loss_t, "loss_mel": loss_mel_raw,
                   "loss_fm": loss_fm, "loss_adv": loss_adv, "loss_dur": loss_duration,
                   "loss_pitch": loss_pitch}
        return loss_g + loss_t, metrics

    def losses(self, batch, window: int, update_spectral: bool, starts=None,
               generator=None):
        """All loss terms in one pass against the current parameters (the validation
        path; the training step runs the discriminators' step first). Returns (total,
        metrics)."""
        outs, y_w = self.gan_forward(batch, window, starts, generator)
        loss_d = self.d_loss(y_w, outs[3].detach(), update_spectral)
        loss_gt, metrics = self.gt_losses(batch, outs, y_w)
        return loss_d + loss_gt, dict(metrics, loss_d=loss_d)


# -- optimizers and the step -------------------------------------------------------------


def partition_labels(model: Cubegan) -> dict:
    """Each trainable parameter's optimizer partition (g/d/t/b), by top-level key:
    `gen`, and `tower_g`/`cond_rnn`/`cond_output` of `lang` → g; the rest of `lang` → t;
    `mpd`/`msd` → d; anything else → b."""
    labels = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        top, _, rest = name.partition(".")
        if top == "gen":
            labels[name] = "g"
        elif top in ("mpd", "msd"):
            labels[name] = "d"
        elif top == "lang":
            labels[name] = "g" if rest.split(".")[0] in ("tower_g", "cond_rnn",
                                                         "cond_output") else "t"
        else:
            labels[name] = "b"
    return labels


def make_optimizer(model: Cubegan) -> dict:
    """One optimizer per non-empty partition: AdamW (betas 0.8/0.99, eps 1e-8, weight
    decay 0.01) for g, d and t, whose learning rate `train_step` sets to
    lr/(1 + lr_decay·step) before each step (optax's schedule, whose count starts at 0);
    Adam at 1e-6 for b. AdamW's p·(1 − lr·wd) then the Adam step equals optax's
    decoupled decay (update + wd·p, times −lr)."""
    cfg = model.config
    labels = partition_labels(model)
    groups = {part: [p for n, p in model.named_parameters() if labels.get(n) == part]
              for part in "gdtb"}
    opts = {}
    for part in "gdt":
        if groups[part]:
            opts[part] = torch.optim.AdamW(groups[part], lr=cfg.lr, betas=(0.8, 0.99),
                                           eps=1e-8, weight_decay=0.01)
    if groups["b"]:
        opts["b"] = torch.optim.Adam(groups["b"], lr=1e-6)
    return opts


@dataclasses.dataclass
class TrainState:
    """The model (parameters and spectral u), its optimizers, the step count and the
    seed of the crop offsets. `train_step` updates it in place."""

    model: Cubegan
    optimizers: dict
    step: int
    seed: int


def create_train_state(model: Cubegan, seed: int = 0) -> TrainState:
    if not model.train_mode:
        raise ValueError("create_train_state needs Cubegan(config, train=True)")
    return TrainState(model=model, optimizers=make_optimizer(model), step=0, seed=seed)


def crop_generator(seed: int, step: int | None = None) -> torch.Generator:
    """The generator of one step's crop offsets: from (seed, step) for a train step
    (JAX's `fold_in(PRNGKey(seed), step)`), from the seed alone for validation (JAX's
    fixed `val_rng`, `PRNGKey(seed + 1)`). Made afresh for each call, so that no draw
    depends on what ran before."""
    entropy = [seed, 1] if step is None else [seed, 0, step]
    return torch.Generator().manual_seed(
        int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1))


def _step(state: TrainState, parts: str):
    """One optimizer step for `parts`: a parameter without a grad gets zeros, so that
    it decays and its moments move, as with optax's full-tree update."""
    cfg = state.model.config
    lr = cfg.lr / (1.0 + cfg.lr_decay * state.step)
    for part in parts:
        opt = state.optimizers.get(part)
        if opt is None:
            continue
        for group in opt.param_groups:
            if part != "b":
                group["lr"] = lr
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()


def train_step(state: TrainState, batch: dict, starts=None):
    """One GAN step with D-then-G sequencing (see the module docstring). `batch` holds
    tensors on the model's device (`batch_to_torch`); `starts` overrides the crop
    offsets drawn from `crop_generator(state.seed, state.step)`. Returns (state,
    metrics), metrics as detached scalar tensors."""
    model = state.model
    model.zero_grad(set_to_none=True)
    outs, y_w = model.gan_forward(batch, TRAIN_FRAMES, starts,
                                  crop_generator(state.seed, state.step))

    # phase 1: the discriminators' step on the detached ŷ (writes the spectral u)
    loss_d = model.d_loss(y_w, outs[3].detach(), update_spectral=True)
    loss_d.backward()
    _step(state, "d")

    # phase 2: generator and text losses against the updated discriminators
    loss_gt, metrics = model.gt_losses(batch, outs, y_w)
    loss_gt.backward()
    _step(state, "gtb")

    state.step += 1
    return state, {k: v.detach() for k, v in dict(metrics, loss_d=loss_d).items()}


def val_step(state: TrainState, batch: dict, starts=None):
    """Validation losses on a 200-frame window, no update (the spectral u is not
    written); `loss_mel` is the model-selection metric. The windows come from
    `starts` or from `crop_generator(state.seed)`: the same at every call."""
    with torch.no_grad():
        _, metrics = state.model.losses(batch, VAL_FRAMES, update_spectral=False,
                                        starts=starts, generator=crop_generator(state.seed))
    return {k: v.detach() for k, v in metrics.items()}
