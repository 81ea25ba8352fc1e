"""Train states and steps of the phonemizer, textcoder and vocoder trainers, counterpart
of `ttscube_tpu/train/states.py`. (The Cubegan step is in models/cubegan.py.)

`SimpleState` holds the model (its parameters change in place), one optimizer and the
step count. The optimizer is optax's `adamw(lr, weight_decay=0.01)` with optax's
defaults, as torch's AdamW: betas 0.9 / 0.999 and eps 1e-8 outside the square root, both
moments bias-corrected. AdamW's p·(1 − lr·wd) then the Adam step equals optax's
decoupled decay (update + wd·p, times −lr), on every parameter (optax's adamw has no
mask here). The LSTMs' bias_hh, kept at zero, is not trained (ops/rnn.py); the GRUs'
two biases are.

Textcoder and the vocoder step AdamW at the inverse decay lr / (1 + lr_decay · step),
with the step before the update, as optax evaluates its schedule at the count before
it (so the first step uses lr). The vocoder first clips the global norm of every grad
of both nets together to 5, as optax's `clip_by_global_norm` does: g · 5 / ‖g‖ where
‖g‖ ≥ 5 (PyTorch's `clip_grad_norm_` divides by ‖g‖ + 1e-6). Textcoder's PreNet masks of
step k come from `crop_generator(seed, k)` (a CPU generator, so the card and the CPU
draw the same masks, and a resumed run the live run's); its validation's from
`crop_generator(seed)`, the same at every call.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ttscube_tpu_torch.models.cubegan import crop_generator
from ttscube_tpu_torch.models.phonemizer import (PhonemizerM2M, m2m_loss,
                                                 phonemizer_accuracy, phonemizer_loss)
from ttscube_tpu_torch.models.textcoder import textcoder_losses

TEXTCODER_LR_DECAY = 1e-5
VOCODER_CLIP = 5.0


@dataclasses.dataclass
class SimpleState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    seed: int = 0                     # Textcoder: the seed of the PreNet masks
    lr_decay: float | None = None     # the inverse-decay schedule; None: a constant rate
    clip_norm: float | None = None    # the global-norm clip before AdamW (the vocoder)


def trainable(model: nn.Module) -> list:
    return [p for p in model.parameters() if p.requires_grad]


def _adamw(model: nn.Module, lr: float) -> torch.optim.Optimizer:
    opt = torch.optim.AdamW(trainable(model), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    for group in opt.param_groups:
        group["initial_lr"] = lr  # the schedule's lr0
    return opt


def create_phonemizer_state(model: nn.Module, lr: float = 2e-4) -> SimpleState:
    """The phonemizer's state: AdamW(lr, betas 0.9 / 0.999, eps 1e-8, weight decay
    0.01) over every trained parameter, step 0."""
    return SimpleState(model, _adamw(model, lr))


def clip_global_norm(params: list, max_norm: float) -> None:
    """optax's `clip_by_global_norm` on the grads of `params`, in place and without a
    host sync: g ← g / ‖g‖ · max_norm where the global norm ‖g‖ ≥ max_norm."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def apply_step(state: SimpleState, loss) -> SimpleState:
    """Backward of `loss`, then one optimizer step (after the clip and at the scheduled
    rate, where the state has them). A parameter without a grad gets zeros, so that it
    decays and its moments move, as with optax's full-tree update."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if state.clip_norm is not None:
        clip_global_norm(params, state.clip_norm)
    if state.lr_decay is not None:
        for group in state.optimizer.param_groups:
            group["lr"] = group["initial_lr"] / (1.0 + state.lr_decay * state.step)
    state.optimizer.step()
    state.step += 1
    return state


def _losses(model, batch):
    if isinstance(model, PhonemizerM2M):
        pl_, nw, _ = model(batch)
        return m2m_loss(pl_, nw, batch["y_phon"], batch["y_new_word"]), pl_
    logits = model(batch)
    return phonemizer_loss(logits, batch["y_phon"]), logits


def phonemizer_train_step(state: SimpleState, batch: dict):
    """One AdamW step on the phonemizer's loss (M2M: teacher-forced, CE of the phones
    plus CE of the word advance). `batch` holds tensors on the model's device
    (`models/cubegan.batch_to_torch`). Returns (state, {"loss": detached scalar})."""
    state.model.train()
    loss, _ = _losses(state.model, batch)
    return apply_step(state, loss), {"loss": loss.detach()}


def phonemizer_val_step(state: SimpleState, batch: dict) -> dict:
    """The loss and PACC/SACC. For the M2M model PACC and SACC come from a free-running
    decode of y_phon's length (the decoder consumes its own predictions, as the
    reference's validation does; teacher-forced logits would inflate them)."""
    model = state.model
    model.eval()
    with torch.no_grad():
        loss, logits = _losses(model, batch)
        if isinstance(model, PhonemizerM2M):
            free = {k: v for k, v in batch.items() if k not in ("y_phon", "y_new_word")}
            logits, _, _ = model(free, max_steps=batch["y_phon"].shape[1])
        acc = phonemizer_accuracy(logits, batch["y_phon"])
        pacc = 1.0 - acc["perr"] / acc["phones"].clamp(min=1)
        sacc = 1.0 - acc["serr"] / max(acc["seqs"], 1)
    return {"loss": loss, "pacc": pacc, "sacc": sacc, "neg_pacc": -pacc, "neg_sacc": -sacc}


# -- textcoder -----------------------------------------------------------------------------


def create_textcoder_state(model: nn.Module, lr: float = 2e-4, seed: int = 0) -> SimpleState:
    """Textcoder's state: AdamW at lr / (1 + 1e-5 · step), weight decay 0.01; the
    PostNet's running averages live in the model's buffers (JAX's `extra`)."""
    return SimpleState(model, _adamw(model, lr), seed=seed, lr_decay=TEXTCODER_LR_DECAY)


def textcoder_train_step(state: SimpleState, batch: dict, masks=None):
    """One step on CE(durations) + CE(pitch) + L1(pre) + L1(post), the PostNet on batch
    statistics (updating its running averages). The PreNet masks come from
    `crop_generator(state.seed, state.step)`, or `masks`. Returns (state, the losses as
    detached scalars)."""
    model = state.model
    model.train()
    outputs = model(batch, train=True, masks=masks,
                    generator=crop_generator(state.seed, state.step))
    losses = textcoder_losses(outputs, batch, model.config)
    apply_step(state, losses["loss"])
    return state, {k: v.detach() for k, v in losses.items()}


def textcoder_val_step(state: SimpleState, batch: dict, masks=None) -> dict:
    """The losses with the PostNet on its running averages, the PreNet still dropping
    (masks from `crop_generator(state.seed)`, or `masks`)."""
    model = state.model
    model.eval()
    with torch.no_grad():
        outputs = model(batch, train=False, masks=masks,
                        generator=crop_generator(state.seed))
        return textcoder_losses(outputs, batch, model.config)


# -- vocoder -------------------------------------------------------------------------------


def create_vocoder_state(model: nn.Module) -> SimpleState:
    """The vocoder's state over both nets: the global-norm clip at 5, then AdamW at
    config.lr / (1 + config.lr_decay · step), weight decay 0.01."""
    cfg = model.config
    return SimpleState(model, _adamw(model, cfg.lr), lr_decay=cfg.lr_decay,
                       clip_norm=VOCODER_CLIP)


def vocoder_train_step(state: SimpleState, batch: dict):
    """One step on the mean of the two nets' teacher-forced losses. Returns (state,
    {hr, lr, loss} detached)."""
    state.model.train()
    losses = state.model.losses(batch)
    apply_step(state, losses["loss"])
    return state, {k: v.detach() for k, v in losses.items()}


def vocoder_val_step(state: SimpleState, batch: dict) -> dict:
    state.model.eval()
    with torch.no_grad():
        return state.model.losses(batch)
