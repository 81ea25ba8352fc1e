"""Train states and steps of the phonemizer trainer, counterpart of the phonemizer part
of `ttscube_tpu/train/states.py`. (The Cubegan step is in models/cubegan.py; the
textcoder and vocoder steps are not ported yet.)

`SimpleState` holds the model (its parameters change in place), one optimizer and the
step count. The optimizer is optax's `adamw(lr, weight_decay=0.01)` with optax's
defaults, as torch's AdamW: betas 0.9 / 0.999 and eps 1e-8 outside the square root, both
moments bias-corrected. AdamW's p·(1 − lr·wd) then the Adam step equals optax's
decoupled decay (update + wd·p, times −lr), on every parameter (optax's adamw has no
mask here). The LSTMs' bias_hh, kept at zero, is not trained (ops/rnn.py).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ttscube_tpu_torch.models.phonemizer import (PhonemizerM2M, m2m_loss,
                                                 phonemizer_accuracy, phonemizer_loss)


@dataclasses.dataclass
class SimpleState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def trainable(model: nn.Module) -> list:
    return [p for p in model.parameters() if p.requires_grad]


def create_phonemizer_state(model: nn.Module, lr: float = 2e-4) -> SimpleState:
    """The phonemizer's state: AdamW(lr, betas 0.9 / 0.999, eps 1e-8, weight decay
    0.01) over every trained parameter, step 0."""
    return SimpleState(model, torch.optim.AdamW(trainable(model), lr=lr, betas=(0.9, 0.999),
                                                eps=1e-8, weight_decay=0.01))


def apply_step(state: SimpleState, loss) -> SimpleState:
    """Backward of `loss`, then one optimizer step. A parameter without a grad gets
    zeros, so that it decays and its moments move, as with optax's full-tree update."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
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
