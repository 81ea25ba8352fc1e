"""The port's entry points (`ttscube_tpu_torch/entry.py`) against `__graft_entry__.py`:
`entry()`'s synthesis equals JAX's on the same (converted) weights within 5e-5, and
`dryrun_multichip(4, device="cpu")` runs its step, second step, save and restore, third
step and mesh synthesis in four gloo processes (a (2, 2) mesh, as the JAX function
picks for 4 devices), under a timeout of its own."""

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as jentry
from ttscube_tpu_torch import entry
from ttscube_tpu_torch.convert import load_jax_params
from tests.torch_parity import assert_close, exact_cpu_convs, one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("exact_cpu_convs", "one_cpu_thread")


def test_entry_matches_jax():
    jfn, (jparams, jX) = jentry.entry()
    fn, (model, X) = entry.entry(device="cpu")
    for k, v in jX.items():
        np.testing.assert_array_equal(X[k].numpy(), np.asarray(v))
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, jax.device_get(jparams)))
    want = np.asarray(jax.jit(jfn)(jparams, jX))
    got = fn(model, X)
    assert tuple(got.shape) == want.shape == (2, 64 * 240)
    assert_close("entry() synthesis", got, want, 5e-5)


def test_example_batch_is_the_jax_one():
    want = jentry._example_batch(B=4)
    got = entry._example_batch(B=4)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_dryrun_multichip_on_four_cpu_ranks():
    out = entry.dryrun_multichip(4, device="cpu")
    assert set(out) == {"step1", "step2", "step3"}
    assert all(np.isfinite(v) for m in out.values() for v in m.values())


def test_dryrun_on_the_card_needs_the_cards():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 64:
        pytest.skip("a machine with 64 cards")
    with pytest.raises(RuntimeError):
        entry.dryrun_multichip(64)
