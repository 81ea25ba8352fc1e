"""Faults planted in the program under test, to show that a cell's check fails them:
each is a context manager that patches one of the program's functions for its duration.

- `altered_token`: free synthesis gives the first phone of every item one frame more
  than the duration it predicted (a token altered where it is produced);
- `half_batch`: the GAN step sees only the first half of each batch's rows, its losses
  the mean over those;
- `frozen_step`: the GAN step returns its state unchanged (parameters and optimizer
  state as before the step)."""

from __future__ import annotations

import contextlib
import copy


@contextlib.contextmanager
def _patched(owner, name: str, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def altered_token():
    from ttscube_tpu_torch.models.languasito import Languasito2

    def make(orig):
        def durations(self, X, h_t):
            d = orig(self, X, h_t).clone()
            d[:, 0] += (X["x_char"][:, 0] != 0).to(d.dtype)
            return d
        return durations

    return _patched(Languasito2, "_durations", make)


def half_batch():
    from ttscube_tpu_torch.models import cubegan

    def make(orig):
        def train_step(state, batch, starts=None):
            h = batch["x_char"].shape[0] // 2
            return orig(state, {k: v[:h] for k, v in batch.items()},
                        None if starts is None else starts[:h])
        return train_step

    return _patched(cubegan, "train_step", make)


def frozen_step():
    from ttscube_tpu_torch.models import cubegan

    def make(orig):
        def train_step(state, batch, starts=None):
            params = copy.deepcopy(state.model.state_dict())
            opts = {k: copy.deepcopy(o.state_dict()) for k, o in state.optimizers.items()}
            _, metrics = orig(state, batch, starts)
            state.model.load_state_dict(params)
            for k, o in state.optimizers.items():
                o.load_state_dict(opts[k])
            state.step -= 1
            return state, metrics
        return train_step

    return _patched(cubegan, "train_step", make)


FAULTS = {"altered_token": altered_token, "half_batch": half_batch, "frozen_step": frozen_step}
