"""The reference's side of a training check: the reference follows the program's first
steps from the same weights, batches and crop starts, and `compare` reads the program's
record of those steps against it.

A record holds each step's losses, each leaf's gradient norm in the first step (the
program's worked out from its optimizer's first moment after one step), and each leaf's
change over the steps. Norms are compared by the worst leaf: the gap between the two
norms over the reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median leaf's move by
round-off alone, and are left out of the change.

One step of the measured window is followed too: from a snapshot of the program's state
taken just before it (its parameters and buffers, its optimizers' moments and counts,
its step number), which the reference can only take from the program, since following
it there from the seed would take every step before it. That step's losses and each
leaf's change are compared the same way."""

from __future__ import annotations

import statistics

from benchmark.reference.cubegan import Trainer

SILENT_GRAD = 1e-3  # of the median leaf's gradient norm: a leaf that only rounding moves


def follow(W, c, trainable, batches, starts) -> dict:
    """The reference's record over len(batches) steps from the weights W."""
    tr = Trainer(W, c, trainable)
    losses, grads = [], None
    for X, st in zip(batches, starts):
        losses.append(tr.step(X, st))
        if grads is None:
            grads = {n: float(g.norm()) for n, g in tr.last_grads.items()}
    change = {n: float((p.detach() - W[n]).norm()) for n, p in tr.P.items()}
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def follow_from(snap: dict, c, trainable, batch, starts) -> dict:
    """The reference's record of one step from the program's snapshot `snap` (`W`, the
    moments `m` and `v`, each partition's `count`, `step_no`)."""
    tr = Trainer(snap["W"], c, trainable)
    tr.resume(snap["m"], snap["v"], snap["count"], snap["step_no"])
    losses = tr.step(batch, starts)
    return {"losses": [losses],
            "grad_norms": {n: float(g.norm()) for n, g in tr.last_grads.items()},
            "change_norms": {n: float((p.detach() - snap["W"][n]).norm())
                             for n, p in tr.P.items()}}


def leaf_gaps(got: dict, want: dict, names) -> dict:
    """Each leaf's gap: |got − want| over the larger of want and the median leaf's."""
    names = list(names)
    median = statistics.median(want[n] for n in names)
    return {n: abs(got.get(n, 0.0) - want[n]) / max(want[n], median, 1e-30) for n in names}


def loss_gaps(got: dict, want: dict) -> list:
    """Each step's largest relative gap over its losses."""
    return [max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-6) for k in w)
            for g, w in zip(got["losses"], want["losses"])]


def compare(got: dict, want: dict) -> dict:
    """Numbers of a judged record against the reference's: loss_err (the largest
    relative gap of any loss in any step), loss1_err (the same in the first step alone,
    which later steps' amplified rounding does not reach), grad_err and change_err
    (worst leaf); and
    under `detail` what sets them: each step's loss gap, the leaves' gaps by quantile,
    the worst leaves and the leaves left out of the change."""
    grads = want["grad_norms"]
    median = statistics.median(grads.values())
    moving = [n for n in grads if grads[n] >= SILENT_GRAD * median]
    steps = loss_gaps(got, want)
    g = leaf_gaps(got["grad_norms"], grads, grads)
    ch = leaf_gaps(got["change_norms"], want["change_norms"], moving)
    q = lambda d: [statistics.median(d.values()),
                   statistics.quantiles(d.values(), n=10)[-1], max(d.values())]
    detail = {"loss_by_step": steps, "grad_q50_q90_max": q(g), "change_q50_q90_max": q(ch),
              "grad_leaf": max(g, key=g.get), "change_leaf": max(ch, key=ch.get),
              "silent_leaves": sorted(set(grads) - set(moving))}
    return {"loss_err": max(steps), "loss1_err": steps[0], "grad_err": max(g.values()),
            "change_err": max(ch.values()), "detail": detail}


def compare_step(got: dict, want: dict) -> dict:
    """Numbers of one followed window step: loss_w_err (the largest relative gap of its
    losses) and change_w_err (the worst leaf's change, leaves that this step's reference
    gradient leaves silent left out); under `detail` what sets them."""
    grads = want["grad_norms"]
    median = statistics.median(grads.values())
    moving = [n for n in grads if grads[n] >= SILENT_GRAD * median]
    ch = leaf_gaps(got["change_norms"], want["change_norms"], moving)
    detail = {"change_w_q50_max": [statistics.median(ch.values()), max(ch.values())],
              "change_w_leaf": max(ch, key=ch.get),
              "silent_w_leaves": len(grads) - len(moving)}
    return {"loss_w_err": loss_gaps(got, want)[0], "change_w_err": max(ch.values()),
            "detail": detail}
