"""Parity of the port's remaining blocks with the JAX modules on the CPU: the plain
ConvTranspose1d, the gated ResNet, UpsampleNet, UpsampleNet2 and Mel2Style, each on
seeded inputs with flax-shaped random weights carried across by
ttscube_tpu_torch.convert, whose round trip must change no bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ttscube_tpu.models import blocks as jb
from ttscube_tpu.ops import conv as jconv
from ttscube_tpu_torch import convert
from ttscube_tpu_torch.models import blocks as tb
from ttscube_tpu_torch.ops import ConvTranspose1d
from tests.torch_parity import (assert_close, assert_trees_equal, one_cpu_thread,  # noqa: F401
                                random_params, t)

# PyTorch on one thread: the tier's workers share the machine's cores
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

TOL = 1e-5  # the JAX conv parity tolerance (tests/test_composed_parity.py)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# (name, JAX module, port module, input shape, seed)
CASES = [
    ("ConvTranspose1d k5 s3 p1", lambda: jconv.ConvTranspose1d(6, 5, stride=3, padding=1),
     lambda: ConvTranspose1d(4, 6, 5, stride=3, padding=1), (2, 9, 4), 0),
    ("ResNet", lambda: jb.ResNet(filter_size=32, n_layers=3),
     lambda: tb.ResNet(20, filter_size=32, n_layers=3), (2, 16, 20), 1),
    ("UpsampleNet", lambda: jb.UpsampleNet(upsample_scales=(2, 4), out_channels=12),
     lambda: tb.UpsampleNet(10, upsample_scales=(2, 4), out_channels=12), (2, 7, 10), 2),
    ("UpsampleNet2 (2, 2)", lambda: jb.UpsampleNet2(upsample_scales=(2, 2)),
     lambda: tb.UpsampleNet2(upsample_scales=(2, 2)), (2, 9, 6), 3),
    ("UpsampleNet2 (2, 4)", lambda: jb.UpsampleNet2(upsample_scales=(2, 4)),
     lambda: tb.UpsampleNet2(upsample_scales=(2, 4)), (2, 9, 6), 4),
    ("Mel2Style", lambda: jb.Mel2Style(num_mgc=12, gst_dim=10, num_gst=5),
     lambda: tb.Mel2Style(num_mgc=12, gst_dim=10, num_gst=5), (3, 11, 12), 5),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_block_matches_jax_and_round_trips(case):
    name, jmod, tmod, shape, seed = case
    jm, x = jmod(), _x(shape, seed)
    params = random_params(jm, jnp.asarray(x), seed=seed)
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = convert.load_jax_params(tmod(), params).eval()
    with torch.no_grad():
        got = tm(t(x))
    for g, w in zip(got, want) if isinstance(want, tuple) else ((got, want),):
        assert_close(name, g, np.asarray(w), TOL)
    assert_trees_equal(convert.state_dict_to_jax(tm), params)


def test_upsamplenet2_kernel_is_not_flipped_twice():
    """An asymmetric kernel: the port's unflipped transposed conv, the JAX module's
    flipped dilated conv, and a direct scatter of each input sample agree."""
    jm = jb.UpsampleNet2(upsample_scales=(2,))
    v = np.arange(12, dtype=np.float32).reshape(3, 4) ** 2 / 50.0 - 1.0
    params = {"v_0": v, "g_0": np.array([1.7], np.float32),
              "bias_0": np.array([0.1], np.float32)}
    x = _x((1, 5, 4), 7)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = convert.load_jax_params(tb.UpsampleNet2(upsample_scales=(2,)), params)
    with torch.no_grad():
        got = tm(t(x)).numpy()
    # torch ConvTranspose2d: out[c·1 − 1 + i, t·2 − 1 + j] += x[c, t] · w[i, j]
    w = v / np.sqrt((v * v).sum() + 1e-12) * 1.7
    img = x[0].T  # (C, T)
    full = np.zeros((img.shape[0] + 2, 2 * (img.shape[1] - 1) + 4))
    for c in range(img.shape[0]):
        for s in range(img.shape[1]):
            full[c:c + 3, 2 * s:2 * s + 4] += img[c, s] * w
    ref = full[1:-1, 1:-1] + 0.1
    ref = np.where(ref > 0, ref, 0.4 * ref).T[None]
    assert_close("UpsampleNet2 against a direct scatter", got, ref, TOL)
    assert_close("UpsampleNet2 (asymmetric kernel)", got, want, TOL)


def test_legacy_shapes():
    """The JAX test's shapes (tests/test_legacy_and_runtime.py): the gated ResNet gives
    half its filter size, UpsampleNet (2, 2) four times the frames, UpsampleNet2 the
    product of its scales, Mel2Style (B, num_gst) and (B, gst_dim)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(2, 16, 80)
    rn = convert.init_random(tb.ResNet(80, filter_size=64, n_layers=3), 0)
    up = convert.init_random(tb.UpsampleNet(80, upsample_scales=(2, 2), out_channels=80), 0)
    up2 = convert.init_random(tb.UpsampleNet2(), 0)
    ms = convert.init_random(tb.Mel2Style(), 0)
    with torch.no_grad():
        assert rn(x).shape == (2, 16, 32)
        assert up(x).shape == (2, 64, 80)
        assert up2(torch.randn(2, 16, 80, generator=gen)).shape == (2, 256, 80)
        att, style = ms(torch.randn(2, 16, 80, generator=gen))
    assert att.shape == (2, 8) and style.shape == (2, 100)
    torch.testing.assert_close(att.sum(-1), torch.ones(2))
