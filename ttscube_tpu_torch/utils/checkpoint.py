"""The checkpoint store of a training run, in the JAX package's files: counterpart of
`ttscube_tpu/utils/checkpoint.py`.

    {base}.yaml       the config (sample_rate, hop_size, conditioning), `config_io`
    {base}.encodings  the vocabularies (data/encodings.py)
    {base}.best       the parameters of the best validation epoch  \
    {base}.last       the parameters of the last saved epoch        } flax msgpack
    {base}.opt.last   the whole TrainState {params, opt_state, spectral, step} /
                      (the phonemizer's, Textcoder's and the vocoder's: SimpleState
                      {params, opt_state, step, extra}, extra Textcoder's batch_stats)
    {base}.pacc.best, {base}.sacc.best   the phonemizer trainer's best parameters
    {base}.lr.best, {base}.hr.best       the vocoder trainer's best parameters of each
                                         net (the subtrees "lr" and "hr")

Every weight file is the JAX package's pytree written with `utils/serialization.py`,
so a file moves to the other package in either direction: JAX's `load_params` and
`load_train_state` read what this module writes, and this module reads what they
write. A file is written beside its target and renamed into place, so a save that is
cut off leaves the previous file whole.

Over a mesh (parallel/mesh.py) every rank calls the savers, because gathering the
sharded parameters and moments is a collective, and rank 0 alone writes.
"""

from __future__ import annotations

import os

import torch

from ttscube_tpu_torch.convert import (load_jax_params, load_jax_simple_state,
                                       load_jax_train_state, read_msgpack,
                                       simple_state_to_jax, state_dict_to_jax,
                                       train_state_to_jax)
from ttscube_tpu_torch.train.states import SimpleState
from ttscube_tpu_torch.utils import config_io
from ttscube_tpu_torch.utils.ranks import is_writer
from ttscube_tpu_torch.utils.serialization import msgpack_restore, msgpack_serialize


def _write(path: str, tree) -> None:
    if not is_writer():
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(tree))
    os.replace(tmp, path)


def save_params(path: str, params) -> None:
    """A module's parameters (or a JAX parameter tree of numpy arrays) as a weight
    file."""
    _write(path, state_dict_to_jax(params) if isinstance(params, torch.nn.Module) else params)


def load_params(path: str, module: torch.nn.Module) -> torch.nn.Module:
    """Copy a weight file's parameters onto `module` (strict: every weight must be
    there). Returns the module."""
    return load_jax_params(module, read_msgpack(path))


def save_train_state(path: str, state) -> None:
    """The whole TrainState (parameters, optimizer state, spectral u, step) as the
    JAX package's TrainState tree; a SimpleState as its SimpleState tree."""
    _write(path, simple_state_to_jax(state) if isinstance(state, SimpleState)
           else train_state_to_jax(state))


def load_train_state(path: str, state):
    """Restore a TrainState or a SimpleState in place from an `.opt.last` file;
    returns it.

    Raises ValueError, with nothing restored, for an empty file (a save that was cut
    off) and for a legacy single-state optimizer checkpoint: the trainer then resumes
    the weights alone from `.last`."""
    with open(path, "rb") as f:
        data = f.read()
    if not data:
        raise ValueError(
            f"'{path}' is empty (truncated by an interrupted save). Resume weights "
            "only from '.last'; the optimizer restarts from step 0.")
    load = load_jax_simple_state if isinstance(state, SimpleState) else load_jax_train_state
    return load(state, msgpack_restore(data), path)


def save_config(base: str, config: dict) -> None:
    if is_writer():
        config_io.dump(config, base + ".yaml")


def load_config(base: str) -> dict:
    return config_io.load(base + ".yaml")


class BestKeeper:
    """Tracks a minimized metric and writes `{base}.best`, `{base}.last` and
    `{base}.opt.last` (the JAX package's BestKeeper)."""

    def __init__(self, base: str, metric_name: str = "loss"):
        self.base = base
        self.metric_name = metric_name
        self.best = float("inf")
        self._pending = None  # a device-side copy of an unsaved best epoch's state dict
        os.makedirs(os.path.dirname(os.path.abspath(base)), exist_ok=True)

    def update(self, value: float, state, save_opt: bool = True, save_last: bool = True,
               defer_best: bool = False) -> bool:
        """Record this epoch's `value` for `state` (a TrainState). Returns whether it
        improved on the best so far.

        `save_last=False` skips the `.last` write on an epoch that does not improve.
        `defer_best=True` does not write `.best` on an improving epoch either: it keeps
        a copy of the parameters on their device (the port's parameters change in
        place, so a reference would not do) and writes it with the next save."""
        model = state.model
        improved = value < self.best
        pending_now = False
        if improved:
            self.best = value
            # this epoch's parameters are now the best; an older pending copy is stale
            self._pending = None
            if defer_best:
                self._pending = {k: v.detach().clone() for k, v in model.state_dict().items()}
                pending_now = True
        if not (save_last or save_opt or (improved and not defer_best)):
            return improved
        params = state_dict_to_jax(model)
        if improved and not defer_best:
            save_params(self.base + ".best", params)
        if self._pending is not None:
            save_params(self.base + ".best", params if pending_now else
                        state_dict_to_jax(model, self._pending))
            self._pending = None
        if save_last or improved:
            save_params(self.base + ".last", params)
        if save_opt:
            save_train_state(self.base + ".opt.last", state)
        return improved
