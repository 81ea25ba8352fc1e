"""The port's mesh (`ttscube_tpu_torch.parallel.mesh`) in gloo processes on the CPU,
against the JAX package's `ttscube_tpu/parallel/mesh.py` and its single-device step:
twins of tests/test_parallel.py.

Limits: two mesh steps' losses at rtol 2e-4 against the port's single-process steps, the
first also against JAX's jitted single-device `train_step` (tests/test_parallel.py:112-124),
on a batch whose items hold different numbers of valid phones and frames; the grads the
first step reduced over 'data' within 5e-6 of each module's largest grad, a limit that
rank 0's grads alone and per-rank means of the text losses each fail; the parameters
after it with at most 0.1 % of the elements beyond 0.01·lr, and none beyond 2·lr plus
rounding (the first Adam step moves each by about lr·sign(g), and a grad near zero may
sum to the other sign in another order). Mesh synthesis is in tests/test_torch_mesh.py.
Each spawn of ranks waits under a timeout of its own (`TIMEOUT`)."""

import copy

import numpy as np
import pytest
import torch

import jax

from ttscube_tpu.models import cubegan as jcg
from ttscube_tpu.parallel import mesh as jmesh
from ttscube_tpu_torch.convert import jax_to_state_dict
from ttscube_tpu_torch.models import cubegan as tcg
from ttscube_tpu_torch.models.languasito import languasito_losses
from ttscube_tpu_torch.parallel import mesh as pm
from tests import torch_mesh_ranks as ranks
from tests.torch_parity import (GRAD_TOL, SHARE, SHARE_LR, TAIL32_HIFI,  # noqa: F401
                                TINY_HIFI, TRAIN_DISC, TRAIN_LANG, exact_cpu_convs,
                                grad_error, jax_crop_starts, one_cpu_thread, param_error,
                                toy_train_batch, train_pair)

pytestmark = pytest.mark.usefixtures("exact_cpu_convs", "one_cpu_thread")

TIMEOUT = 240  # seconds for one spawn of ranks
STEPS = 2  # mesh steps against single-process steps


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _starts(batch, seed):
    return jax_crop_starts(batch["n_frames"], min(jcg.TRAIN_FRAMES, batch["y_frame2phone"]
                                                  .shape[1]),
                           jax.random.fold_in(jax.random.PRNGKey(seed), 0))


@pytest.fixture(scope="module")
def step_2x2():
    """Two steps of the tiny Cubegan on a (2, 2) mesh: (batch, starts, the
    single-process model before its step, the ranks' (metrics, grads and parameters by
    step, placements))."""
    seed = 3
    batch = toy_train_batch(B=4, seed=seed)
    _, jstate, tm = train_pair(TINY_HIFI, batch, seed)
    starts = _starts(batch, seed)
    with torch.backends.mkldnn.flags(enabled=False):
        out = pm.spawn(ranks.step_rank, 4, "cpu", timeout=TIMEOUT,
                       args=((2, 2), (TRAIN_LANG, TINY_HIFI, TRAIN_DISC),
                             _numpy(jstate.params), _numpy(jstate.spectral), batch, starts,
                             STEPS))
    return batch, starts, tm, out


def _rows(batch: dict, rows: slice) -> dict:
    return {k: v[rows] if getattr(v, "ndim", 0) >= 1 else v for k, v in batch.items()}


def _single(tm, batch: dict, starts, steps: int = 1) -> tuple:
    """`steps` train steps in one process from a copy of `tm`: each step's metrics, the
    grads of the first step, and the parameters after it. `batch` holds tensors, and
    may carry the global denominators of a data shard (`pm.global_denominators`)."""
    model = copy.deepcopy(tm)
    state = tcg.create_train_state(model)
    metrics = []
    for i in range(steps):
        state, m = tcg.train_step(state, batch, starts=torch.from_numpy(starts))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                     if p.grad is not None}
            params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return metrics, grads, params


@pytest.mark.parametrize("hifi,shape,against_jax", [
    (TINY_HIFI, (4, 1), True), (TINY_HIFI, (2, 2), False), (TAIL32_HIFI, (2, 1), False)],
    ids=["tiny-4x1", "tiny-2x2", "fused-tail-2x1"])
def test_data_parallel_matches_single_device(hifi, shape, against_jax, request):
    """Two mesh steps against two single-process steps on the same weights, batch and
    crop offsets. The batch's items hold 16 and 11 valid phones and different frame
    counts, so per-rank means of the text losses would miss the global ones by more
    than the tolerance (checked first).

    Held: each step's losses (2e-4 relative; the first also against JAX's jitted
    step), the grads the first step reduced over 'data' (GRAD_TOL of the largest grad
    of the module that holds them), and the parameters after it (at most SHARE of the elements beyond
    SHARE_LR · lr, none beyond 2 lr plus rounding). Two wrong reductions must fail the
    grad limit: rank 0's grads alone (no reduction over 'data'), and the mean of the
    ranks' grads with per-rank means of the text losses.
    `fused-tail-2x1` runs the generator's tail through `Generator.fused_train` (B1/B2 on
    the card, their plain versions here) under the mesh."""
    seed = 3
    batch = toy_train_batch(B=4, seed=seed)
    jm, jstate, tm = train_pair(hifi, batch, seed)
    starts = _starts(batch, seed)
    tb = tcg.batch_to_torch(batch, "cpu")

    # the batch is one where a mean of per-rank means is not the global mean
    with torch.no_grad():
        outs, _ = tm.gan_forward(tb, tcg.TRAIN_FRAMES, starts=torch.from_numpy(starts))
        whole = languasito_losses(*outs[:3], tb, TRAIN_LANG["max_pitch"])
        rows = [languasito_losses(*(o[i:i + 1] for o in outs[:3]),
                                  {k: v[i:i + 1] for k, v in tb.items()},
                                  TRAIN_LANG["max_pitch"]) for i in range(4)]
    misses = [abs(np.mean([float(r[j]) for r in rows]) - float(whole[j])) / float(whole[j])
              for j in range(2)]
    print(f"\nparity mesh {shape}: per-rank means would miss loss_dur, loss_pitch by "
          f"{misses[0]:.2e}, {misses[1]:.2e}")
    assert max(misses) > 2e-4

    if shape == (2, 2):
        metrics, grads, params, _ = request.getfixturevalue("step_2x2")[3]
    else:
        metrics, grads, params, _ = pm.spawn(
            ranks.step_rank, shape[0] * shape[1], "cpu", timeout=TIMEOUT,
            args=(shape, (TRAIN_LANG, hifi, TRAIN_DISC), _numpy(jstate.params),
                  _numpy(jstate.spectral), batch, starts, STEPS))
    single, single_grads, single_params = _single(tm, tb, starts, STEPS)
    want = [("port", i, single[i]) for i in range(STEPS)]
    if against_jax:
        _, jmet = jax.jit(lambda s, b, r: jcg.train_step(jm, s, b, r))(
            jstate, batch, jax.random.PRNGKey(seed))
        want.append(("jax", 0, {k: float(v) for k, v in jmet.items()}))
    for who, i, ref in want:
        for k, v in ref.items():
            rel = abs(metrics[i][k] - v) / abs(v)
            print(f"\nparity mesh {shape} step {i + 1} vs {who} {k}: rel_diff={rel:.3e} "
                  "tol=2e-4")
            assert rel <= 2e-4, (who, i, k, metrics[i][k], v)

    # the controls: reductions that are wrong
    data = shape[0]
    parts = [slice(r * 4 // data, (r + 1) * 4 // data) for r in range(data)]
    denominators = pm.global_denominators(tb, data)
    rank0 = _single(tm, dict(_rows(tb, parts[0]), **denominators), starts[parts[0]])[1]
    per_rank = [_single(tm, _rows(tb, r), starts[r])[1] for r in parts]
    means = {n: sum(g[n] for g in per_rank) / data for n in per_rank[0]}
    errors = {"mesh": grad_error(grads[0], single_grads),
              "rank 0 alone": grad_error(rank0, single_grads),
              "per-rank means": grad_error(means, single_grads)}
    print(f"\nparity mesh {shape} step 1 grads, largest difference over the module's "
          "largest grad: " + ", ".join(f"{k} {v:.3e}" for k, v in errors.items())
          + f" tol={GRAD_TOL:.0e}")
    assert errors["mesh"] <= GRAD_TOL
    assert errors["rank 0 alone"] > GRAD_TOL and errors["per-rank means"] > GRAD_TOL

    worst, share, within = param_error(params[0], single_params, tm.config.lr)
    print(f"\nparity mesh {shape} params after step 1: max {worst:.3f} lr, "
          f"{share:.2e} of them beyond {SHARE_LR} lr (limit {SHARE})")
    assert within and share <= SHARE


def test_partition_params_match_jax():
    """On a 'model' axis of 2, the port shards every parameter on the axis that JAX's
    `partition_params` shards (min_size 2**12, as tests/test_parallel.py:27), read
    through the converter: a JAX leaf that counts along its sharded axis, carried to
    the port's layout by `jax_to_state_dict`, counts along the port's axis. The port
    shards nothing that JAX replicates."""
    batch = toy_train_batch(B=2)
    _, jstate, tm = train_pair(TINY_HIFI, batch, seed=0)
    mesh = jmesh.make_mesh(model=2)
    jsh = jmesh.partition_params(jstate.params, mesh, min_size=2**12)
    got = pm.partition_params(tm, 2, min_size=2**12)

    def marker(leaf, sh):
        spec = tuple(sh.spec) + (None,) * (np.ndim(leaf) - len(sh.spec))
        if "model" not in spec:
            return np.zeros(np.shape(leaf), np.float32)
        return np.indices(np.shape(leaf))[spec.index("model")].astype(np.float32) + 1

    markers = jax.tree_util.tree_map(marker, _numpy(jstate.params), jsh)
    want = {}
    for name, t in jax_to_state_dict(tm, markers).items():
        if name not in got:
            continue  # buffers
        varies = [a for a in range(t.ndim) if t.shape[a] > 1 and
                  not torch.equal(t.narrow(a, 0, 1).expand_as(t), t)]
        want[name] = varies[0] if t.max() > 0 else None
        assert len(varies) <= 1, name
    sharded = {n for n, a in want.items() if a is not None}
    print(f"\nparity partition_params: {len(sharded)} of {len(want)} parameters sharded "
          f"on 'model', as JAX's")
    assert len(sharded) > 5
    assert {n: got[n] for n in want} == want
    # the port's parameters without a JAX counterpart (the LSTMs' zero bias_hh) only
    assert {n for n, a in got.items() if n not in want} <= {
        n for n, _ in tm.named_parameters() if ".bias_hh" in n}


def test_mesh_placements_and_moments(step_2x2):
    """On a (2, 2) mesh each parameter is stored replicated over 'data' and sharded over
    'model' on its `partition_params` axis (FSDP2's default, axis 0, where JAX
    replicates), and after a step both AdamW moments carry the parameter's placement
    (the twin of tests/test_parallel.py:72)."""
    _, _, tm, (_, _, _, placed) = step_2x2
    axes = pm.partition_params(tm, 2)
    n_sharded = 0
    for name, p in tm.named_parameters():
        if not p.requires_grad:
            continue
        want = f"(Replicate(), Shard(dim={axes[name] or 0}))"
        param, moments = placed[name]
        assert param == want and moments == (want, want), (name, placed[name], want)
        n_sharded += axes[name] is not None
    assert n_sharded > 0


def test_sharded_lstms_keep_their_weights():
    """On the card nn.LSTM's `flatten_parameters` moves its weights into one cuDNN buffer
    whenever it sees new weight tensors, as FSDP2's gathered weights are; the next
    all-gather would then fill a buffer the LSTM no longer reads. `shard_model` turns it
    off for every LSTM of the model. On the CPU `flatten_parameters` does nothing, so
    this holds the switch; tests/test_torch_gpu.py's mesh step holds its effect."""
    def body(rank, world, device):
        model = tcg.Cubegan(ranks.config(TRAIN_LANG, TINY_HIFI, TRAIN_DISC), train=True)
        pm.shard_model(model, pm.make_mesh(1, 1, device=device))
        rnns = [m for m in model.modules() if isinstance(m, torch.nn.RNNBase)]
        return len(rnns), all(m.flatten_parameters is pm._keep_rnn_weights for m in rnns)

    n, kept = pm.run_ranks(body, 1, "cpu")
    assert n > 0 and kept
