"""The training loop: counterpart of `ttscube_tpu/train/loop.py::train`.

Epochs over host-side batch iterators, one train step per batch, validation at each
epoch's end with the mean of each metric over the dev set, `.best`/`.last`/`.opt.last`
checkpoints by the JAX loop's rules, a devset-synthesis hook every `epoch_generation`
epochs, and resume from `{base}.opt.last` (the whole state, step included), falling
back to the weights of `{base}.last` when that file cannot be read.

The steps are the port's: `train_step(state, batch) -> (state, metrics)` and
`val_step(state, batch) -> metrics`, on batches of tensors on `device`
(`models/cubegan.batch_to_torch`), for Cubegan's TrainState or the phonemizer's
SimpleState (train/states.py). Per-step randomness (the crop offsets) comes from
the state's seed and step inside the step, so a resumed run draws what the live run
would have drawn.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional

import numpy as np

from ttscube_tpu_torch.data.datasets import batch_iterator
from ttscube_tpu_torch.models.cubegan import batch_to_torch
from ttscube_tpu_torch.utils.checkpoint import BestKeeper, load_params, load_train_state


def _cached(dataset, batch_size: int, collate, device, budget: int, shuffle: bool,
            seed: int, spent: int):
    """Every collated batch of one pass moved to `device`, counting bytes as they are
    collated: (the batches, bytes so far), or (None, bytes) as soon as the count passes
    `budget` (no more of the set is collated or kept then)."""
    out = []
    for b in batch_iterator(dataset, batch_size, collate, shuffle=shuffle, seed=seed):
        spent += sum(np.asarray(v).nbytes for v in b.values())
        if spent > budget:
            return None, spent
        out.append(batch_to_torch(b, device))
    return out, spent


def train(
    *,
    state,
    train_step,                  # (state, batch) -> (state, metrics)
    val_step,                    # (state, batch) -> metrics
    trainset,
    devset,
    collate,
    batch_size: int,
    output_base: str,
    selection_metric: str,
    device="cpu",
    max_epochs: int = -1,
    max_steps: int = -1,
    log_every: int = 50,
    seed: int = 0,
    resume: bool = False,
    on_epoch_end: Optional[Callable] = None,   # (epoch, state) -> None
    epoch_generation: int = 10,
    opt_save_every: int = 1,     # epochs between whole-state (.opt.last) saves
    defer_best_saves: bool = False,   # keep an improving epoch's parameters on the
    # device and write `.best` on the next opt_save_every save (BestKeeper)
    cache_batches_budget: int = 4 << 30,   # bytes of collated batches the cache may hold
    cache_batches: bool = False,   # collate every train and dev batch once and keep
    # them on the device; the train batches' composition is frozen (from the epoch-0
    # shuffle), their order is shuffled each epoch. Above the budget, batches stream.
):
    if resume and os.path.exists(output_base + ".opt.last"):
        sys.stdout.write(f"Resuming from {output_base}.opt.last\n")
        try:
            state = load_train_state(output_base + ".opt.last", state)
        except ValueError as e:
            # an empty or legacy optimizer checkpoint: resume the weights only
            if not os.path.exists(output_base + ".last"):
                raise
            sys.stdout.write(f"{e}\nFalling back to weights-only resume from "
                             f"{output_base}.last (optimizer restarts at step 0)\n")
            load_params(output_base + ".last", state.model)

    keeper = BestKeeper(output_base, selection_metric)
    epoch = 0
    global_step = int(state.step)

    train_cache = val_cache = None
    if cache_batches:
        train_cache, spent = _cached(trainset, batch_size, collate, device,
                                     cache_batches_budget, shuffle=True, seed=seed, spent=0)
        if train_cache is not None:
            val_cache, spent = _cached(devset, batch_size, collate, device,
                                       cache_batches_budget, shuffle=False, seed=0,
                                       spent=spent)
        if train_cache is None or val_cache is None:
            train_cache = val_cache = None
            sys.stdout.write(
                f"cache_batches: the collated batches passed the budget of "
                f"{cache_batches_budget / 2**30:.1f} GiB at {spent / 2**30:.3f} GiB, "
                f"streaming batches instead\n")

    def _train_batches(epoch):
        if train_cache is not None:
            for i in np.random.default_rng(seed + epoch).permutation(len(train_cache)):
                yield train_cache[i]
        else:
            for b in batch_iterator(trainset, batch_size, collate, shuffle=True,
                                    seed=seed + epoch):
                yield batch_to_torch(b, device)

    def _val_batches():
        if val_cache is not None:
            yield from val_cache
        else:
            for b in batch_iterator(devset, batch_size, collate, shuffle=False):
                yield batch_to_torch(b, device)

    while max_epochs == -1 or epoch < max_epochs:
        t0 = time.time()
        for batch in _train_batches(epoch):
            state, metrics = train_step(state, batch)
            global_step += 1
            if global_step % log_every == 0:
                msg = " ".join(f"{k}={float(v):.4f}" for k, v in sorted(metrics.items()))
                sys.stdout.write(f"step {global_step}: {msg}\n")
                sys.stdout.flush()
            if max_steps != -1 and global_step >= max_steps:
                break

        # validation: the mean of each metric over the dev batches
        fetched = [{k: float(v) for k, v in val_step(state, b).items()}
                   for b in _val_batches()]
        if fetched:
            avg = {k: float(np.mean([m[k] for m in fetched])) for k in fetched[0]}
        else:
            avg = {selection_metric: float("inf")}
        sys.stdout.write(f"\n\tepoch {epoch} ({time.time() - t0:.1f}s) val: " +
                         " ".join(f"{k}={v:.4f}" for k, v in sorted(avg.items())) + "\n")
        # .last saves follow the .opt.last cadence; improving epochs and the terminal
        # epoch (by max_steps or max_epochs) always save, a deferred best included
        done = ((max_steps != -1 and global_step >= max_steps)
                or (max_epochs != -1 and epoch >= max_epochs - 1))
        cadence = epoch % max(opt_save_every, 1) == 0
        improved = keeper.update(avg[selection_metric], state,
                                 save_opt=cadence or done, save_last=cadence or done,
                                 defer_best=defer_best_saves and not done)
        saved_now = cadence or done or (improved and not defer_best_saves)
        sys.stdout.write(f"\tStored {output_base}.last" +
                         (f" + .best ({selection_metric}={avg[selection_metric]:.4f})\n"
                          if improved else "\n")
                         if saved_now else
                         ("\t(best deferred to next cadence save)\n" if improved
                          else "\t(no save this epoch)\n"))
        sys.stdout.flush()

        if on_epoch_end is not None and epoch % epoch_generation == 0:
            on_epoch_end(epoch, state)
        epoch += 1
        if max_steps != -1 and global_step >= max_steps:
            break
    return state
