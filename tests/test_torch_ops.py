"""Parity of the PyTorch port's ops with the JAX ops on the CPU: the same numpy inputs
and the same weights (carried across by ttscube_tpu_torch.convert) through the flax
module and its port counterpart."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ttscube_tpu.ops import conv as jconv
from ttscube_tpu.ops import length_regulator as jlr
from ttscube_tpu.ops import rnn as jrnn
from ttscube_tpu_torch import resolve_device
from ttscube_tpu_torch.convert import load_jax_params, state_dict_to_jax
from ttscube_tpu_torch.ops import conv as tconv
from ttscube_tpu_torch.ops import length_regulator as tlr
from ttscube_tpu_torch.ops import rnn as trnn
from tests.torch_parity import assert_close


def _rand_tree(tree, rng, scale=0.3):
    """Replace every leaf of a flax param tree with seeded normal numbers."""
    return jax.tree.map(
        lambda x: (scale * rng.standard_normal(np.shape(x))).astype(np.float32), tree)


def _run_both(jmod, tmod, x, rng):
    params = _rand_tree(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    load_jax_params(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    return want, got, params


@pytest.mark.parametrize("k,stride,dilation,groups", [
    (3, 1, 1, 1), (7, 1, 3, 1), (5, 2, 1, 1), (3, 1, 1, 4)])
def test_conv1d_matches_jax(k, stride, dilation, groups):
    rng = np.random.default_rng(k + stride + dilation + groups)
    x = rng.standard_normal((2, 37, 8)).astype(np.float32)
    jmod = jconv.Conv1d(12, k, stride=stride, dilation=dilation, groups=groups)
    tmod = tconv.Conv1d(8, 12, k, stride=stride, dilation=dilation, groups=groups)
    want, got, _ = _run_both(jmod, tmod, x, rng)
    assert_close(f"Conv1d k={k} stride={stride} d={dilation} groups={groups}", got, want, 2e-5)


@pytest.mark.parametrize("k,dilation,padding", [(3, 1, None), (11, 5, None), (7, 1, 3)])
def test_wn_conv1d_matches_jax(k, dilation, padding):
    rng = np.random.default_rng(k * dilation)
    x = rng.standard_normal((2, 64, 16)).astype(np.float32)
    jmod = jconv.WNConv1d(16, k, dilation=dilation, padding=padding)
    tmod = tconv.WNConv1d(16, 16, k, dilation=dilation, padding=padding)
    want, got, _ = _run_both(jmod, tmod, x, rng)
    assert_close(f"WNConv1d k={k} d={dilation}", got, want, 2e-5)


@pytest.mark.parametrize("k,stride", [(16, 5), (16, 3), (4, 4)])
def test_wn_conv_transpose1d_matches_jax(k, stride):
    """g per input channel; out_len = (T−1)·stride − 2·padding + k."""
    rng = np.random.default_rng(k + stride)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    pad = (k - stride) // 2
    jmod = jconv.WNConvTranspose1d(12, k, stride=stride, padding=pad)
    tmod = tconv.WNConvTranspose1d(24, 12, k, stride=stride, padding=pad)
    want, got, params = _run_both(jmod, tmod, x, rng)
    assert params["g"].shape == (24,)
    assert got.shape == want.shape == (2, (9 - 1) * stride - 2 * pad + k, 12)
    assert_close(f"WNConvTranspose1d k={k} stride={stride}", got, want, 2e-5)


def test_wn_norm_keeps_the_epsilon():
    """The port's weight norm adds 1e-12 under the square root, as the JAX one does."""
    v = np.zeros((3, 2, 4), np.float32)
    g = np.ones((4,), np.float32)
    want = np.asarray(jconv._wn_kernel(jnp.asarray(v), jnp.asarray(g), axis=2))
    got = tconv.wn_weight(torch.from_numpy(np.transpose(v, (2, 1, 0)).copy()),
                          torch.from_numpy(g), 0)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_array_equal(np.transpose(got.numpy(), (2, 1, 0)), want)


@pytest.mark.parametrize("bidirectional,num_layers", [(False, 1), (True, 1), (True, 2)])
def test_lstm_matches_jax(bidirectional, num_layers):
    rng = np.random.default_rng(num_layers + 2 * bidirectional)
    x = rng.standard_normal((2, 19, 12)).astype(np.float32)
    jmod = jrnn.LSTM(24, num_layers=num_layers, bidirectional=bidirectional)
    tmod = trnn.LSTM(12, 24, num_layers=num_layers, bidirectional=bidirectional)
    params = _rand_tree(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want, _ = jmod.apply({"params": params}, jnp.asarray(x))
    load_jax_params(tmod, params)
    with torch.no_grad():
        got, _ = tmod(torch.from_numpy(x))
    assert_close(f"LSTM layers={num_layers} bidirectional={bidirectional}", got, want, 2e-5)
    # and back: the single JAX bias survives bias_ih + bias_hh (= 0) bit-exactly
    back = state_dict_to_jax(tmod)
    for key, val in params.items():
        np.testing.assert_array_equal(back[key], val)


def test_length_regulator_matches_jax():
    rng = np.random.default_rng(3)
    B, N, Fr = 3, 11, 64
    n_valid = np.array([11, 7, 1])
    durs = rng.integers(0, 6, (B, N)).astype(np.int64)
    durs[np.arange(N)[None, :] >= n_valid[:, None]] = 0
    want_f2p, want_mask = jlr.durations_to_frame2phone(jnp.asarray(durs),
                                                       jnp.asarray(n_valid), Fr)
    got_f2p, got_mask = tlr.durations_to_frame2phone(torch.from_numpy(durs),
                                                     torch.from_numpy(n_valid), Fr)
    np.testing.assert_array_equal(got_f2p.numpy(), np.asarray(want_f2p))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    # frames past the utterance repeat the last valid phone
    assert (got_f2p[2] == 0).all()
    x = rng.standard_normal((B, N, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tlr.regulate_length(torch.from_numpy(x), got_f2p).numpy(),
        np.asarray(jlr.regulate_length(jnp.asarray(x), want_f2p)))


def test_entry_points_refuse_a_missing_card():
    """Asking for CUDA where there is none raises instead of running on the CPU."""
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
