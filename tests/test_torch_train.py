"""One GAN training step of the port (`ttscube_tpu_torch.models.cubegan.train_step`)
against the JAX package's `train_step` on the CPU, from the same parameters, spectral
u, batch and crop offsets: on tests/test_cubegan.py's tiny config, and on one whose last
stage is 32 wide with fused_tail_train (the port's FusedTailStageGrad path).

Limits: every metric at 1e-5 relative; the grads of each partition at rtol = atol =
2e-4; the spectral u at 1e-5; the parameters after the step in units of the learning
rate: the first Adam step moves each parameter by about lr·sign(g), so a grad that is
near zero may step the other way, but no parameter may differ by more than 2·lr (plus
the float32 rounding of the two updates) and at most 0.1 % of them by more than
0.01·lr. PyTorch runs on `STEP_THREADS` CPU threads (tests/torch_parity.py says why)."""

import numpy as np
import pytest

import jax
import optax
import torch

from ttscube_tpu.models import cubegan as jcg
from ttscube_tpu_torch.convert import jax_to_state_dict, spectral_to_jax
from ttscube_tpu_torch.models import cubegan as tcg
from tests.torch_parity import (TAIL32_HIFI, TINY_HIFI, exact_cpu_convs,  # noqa: F401
                                jax_crop_starts, step_cpu_threads, toy_train_batch,
                                train_pair)

pytestmark = pytest.mark.usefixtures("exact_cpu_convs", "step_cpu_threads")


def _first_step_grads(opt_state) -> dict:
    """The grads JAX's first step applied, read off its optimizer state: after one step
    from a fresh state, each partition's Adam first moment is (1 − b1)·g = 0.2·g."""
    out = {}
    for tx, parts in (("d", "d"), ("gtb", "gt")):
        for part in parts:
            mu = opt_state[tx].inner_states[part].inner_state[0].mu
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]:
                if isinstance(leaf, optax.MaskedNode):
                    continue
                node = out
                for key in path[:-1]:
                    node = node.setdefault(key.key, {})
                node[path[-1].key] = np.asarray(leaf) / 0.2
    return out


def _compare_step(hifi, seed):
    batch = toy_train_batch(seed=seed)
    jm, jstate, tm = train_pair(hifi, batch, seed)
    rng = jax.random.PRNGKey(seed)
    starts = jax_crop_starts(batch["n_frames"], min(jcg.TRAIN_FRAMES, 60),
                             jax.random.fold_in(rng, 0))
    jnew, jmet = jax.jit(lambda s, b, r: jcg.train_step(jm, s, b, r))(jstate, batch, rng)
    jgrads = _first_step_grads(jnew.opt_state)
    state = tcg.create_train_state(tm)
    lr = tm.config.lr
    _, met = tcg.train_step(state, tcg.batch_to_torch(batch, "cpu"),
                            starts=torch.from_numpy(starts))
    assert state.step == 1
    name = f"train_step {hifi['upsample_initial_channel']}"
    for k, v in jmet.items():
        want, got = float(v), met[k].item()
        print(f"\nparity {name} {k}: rel_diff={abs(got - want) / abs(want):.3e} tol=1e-05")
        assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)

    want_grads = jax_to_state_dict(tm, jgrads)
    want_params = jax_to_state_dict(tm, jax.tree_util.tree_map(np.asarray, jnew.params))
    worst_g, n_far, n_all, worst_p, n_over = 0.0, 0, 0, 0.0, 0
    for pname, p in tm.named_parameters():
        if not p.requires_grad:  # the LSTMs' zero bias_hh
            continue
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want_grads[pname].numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=f"grad {pname}")
        worst_g = max(worst_g, float((g - want_grads[pname]).abs().max()))
        w = want_params[pname]
        d = (p.detach() - w).abs()
        worst_p = max(worst_p, float(d.max()))
        # 2·lr, plus the float32 rounding of the two updates (one spacing of |p| each)
        spacing = torch.nextafter(w.abs(), torch.tensor(float("inf"))) - w.abs()
        n_over += int((d > 2 * lr + 2 * spacing).sum())
        n_far += int((d > 0.01 * lr).sum())
        n_all += d.numel()
    print(f"\nparity {name} grads: max_abs_diff={worst_g:.3e} tol=2e-4; params after the "
          f"step: max {worst_p / lr:.3f} lr, {n_far} of {n_all} beyond 0.01 lr")
    assert n_over == 0 and n_far <= 1e-3 * n_all
    u = spectral_to_jax(tm)["msd"]
    worst_u = max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(
        jax.tree_util.tree_leaves(u), jax.tree_util.tree_leaves(jnew.spectral)))
    print(f"\nparity {name} spectral u: max_abs_diff={worst_u:.3e} tol=1e-05")
    assert worst_u <= 1e-5


def test_train_step_matches_jax_tiny():
    _compare_step(TINY_HIFI, seed=0)


def test_train_step_matches_jax_fused_tail():
    """Last stage 32 wide under fused_tail_train: the port's step runs the tail through
    FusedTailStageGrad (B1/B2 on the card, the plain version's autograd here)."""
    _compare_step(TAIL32_HIFI, seed=1)
