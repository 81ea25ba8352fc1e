"""Parity of the port's Languasito v1 (the single-tower text encoder with the
classification pitch head) with the JAX module on the CPU, at B = 2 over ragged phone
lengths, weights carried across by ttscube_tpu_torch.convert."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ttscube_tpu.models import languasito as jla
from ttscube_tpu_torch import convert
from ttscube_tpu_torch.models import languasito as tla
from tests.torch_parity import (LANG, assert_close, assert_trees_equal,  # noqa: F401
                                one_cpu_thread, random_params, t, text_batch)

# PyTorch on one thread: the tier's workers share the machine's cores
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

FRAMES = 40


def _pair():
    jm = jla.Languasito(jla.LanguasitoConfig(**LANG))
    X = text_batch()
    rng = np.random.default_rng(3)
    n_valid = (X["x_char"] != 0).sum(axis=1)
    f2p = np.stack([np.sort(rng.integers(0, n, FRAMES)) for n in n_valid]).astype(np.int32)
    pitch = rng.uniform(0, LANG["max_pitch"], (2, FRAMES)).astype(np.float32)
    X = dict(X, y_frame2phone=f2p, y_pitch=pitch)
    params = random_params(jm, {k: jnp.asarray(v) for k, v in X.items()}, seed=4)
    tm = convert.load_jax_params(tla.Languasito(tla.LanguasitoConfig(**LANG)), params).eval()
    return jm, params, tm, X


def test_languasito_v1_matches_jax_and_round_trips():
    jm, params, tm, X = _pair()
    dur, pitch, cond = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in X.items()})
    Xt = {k: t(v) if v.dtype == np.float32 else t(v).long() for k, v in X.items()}
    with torch.no_grad():
        tdur, tpitch, tcond = tm(Xt)
    assert tdur.shape == (2, X["x_char"].shape[1], LANG["max_duration"] + 1)
    assert tpitch.shape == (2, FRAMES, int(LANG["max_pitch"]) + 1)
    assert tcond.shape == (2, FRAMES, 80)
    assert_close("Languasito v1 dur logits", tdur, dur, 2e-4)
    assert_close("Languasito v1 pitch logits", tpitch, pitch, 2e-4)
    assert_close("Languasito v1 cond", tcond, cond, 2e-5)
    # the explicit frame map and pitch take the place of the batch's
    with torch.no_grad():
        again = tm({k: v for k, v in Xt.items() if k.startswith("x_")},
                   frame2phone=Xt["y_frame2phone"], pitch=Xt["y_pitch"])
    for a, b in zip(again, (tdur, tpitch, tcond)):
        assert torch.equal(a, b)
    back = convert.state_dict_to_jax(tm)
    assert set(back) == {"tower", "dur_rnn", "dur_output", "rnn_overlay", "pitch_rnn",
                         "pitch_output", "rnn_cond", "cond_output"}
    assert_trees_equal(back, params)
