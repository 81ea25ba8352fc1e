"""The port's discriminators, their convs and the GAN losses
(`ttscube_tpu_torch.ops.conv`, `ttscube_tpu_torch.models.hifigan`) against the JAX
package on the CPU, from the same seeded weights and spectral `u`. Scores and feature
maps at 2e-5 (the port runs the period discriminators NCHW, JAX NHWC: maps are
compared after a transpose); the losses at 1e-6 relative."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ttscube_tpu.models import hifigan as jhg
from ttscube_tpu.ops import conv as jconv
from ttscube_tpu_torch import convert
from ttscube_tpu_torch.models import hifigan as thg
from ttscube_tpu_torch.ops import conv as tconv
from tests.torch_parity import assert_close, one_cpu_thread, random_params, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

TOL = 2e-5


def _spectral(shapes_tree, seed):
    """A seeded "spectral" tree of unit-scale u vectors shaped as flax made them."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), shapes_tree)


def _init_spectral(module, *example):
    return jax.eval_shape(module.init, jax.random.PRNGKey(0), *example)["spectral"]


def _audio(B, T, seed):
    return (0.3 * np.random.default_rng(seed).standard_normal((B, T))).astype(np.float32)


def test_wnconv2d_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 21, 3, 4)).astype(np.float32)  # NHWC
    jm = jconv.WNConv2d(8, (5, 1), strides=(3, 1), padding=(2, 0))
    params = random_params(jm, jnp.zeros((1, 21, 3, 4)), seed=1)
    params["g"] = np.linspace(0.5, 1.5, 8).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, x))
    tm = convert.load_jax_params(tconv.WNConv2d(4, 8, (5, 1), (3, 1), (2, 0)), params)
    got = tm(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close("WNConv2d", got, want, TOL)
    back = convert.state_dict_to_jax(tm)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])


@pytest.mark.parametrize("groups", [1, 4])
def test_snconv1d_matches_jax_and_updates_u(groups):
    """One power iteration per call from the stored u; u written only under
    update_stats; the output and the new u equal JAX's."""
    x = np.random.default_rng(2).standard_normal((2, 40, 8)).astype(np.float32)
    jm = jconv.SNConv1d(16, kernel_size=5, stride=2, padding=2, groups=groups)
    params = random_params(jm, jnp.zeros((1, 40, 8)), seed=3)
    spec = _spectral(_init_spectral(jm, jnp.zeros((1, 40, 8))), seed=4)
    tm = convert.load_jax_params(tconv.SNConv1d(8, 16, 5, 2, 2, groups), params, spec)
    for update in (False, True):
        want, new = jm.apply({"params": params, "spectral": spec}, x, update_stats=update,
                             mutable=["spectral"])
        u_before = tm.u.clone()
        got = tm(t(x), update_stats=update)
        assert_close(f"SNConv1d groups={groups} update={update}", got, np.asarray(want), TOL)
        assert_close(f"SNConv1d u groups={groups} update={update}", tm.u,
                     np.asarray(new["spectral"]["u"]), 1e-6)
        if not update:
            assert np.array_equal(tm.u.numpy(), u_before.numpy())
        else:
            assert not np.allclose(tm.u.numpy(), u_before.numpy())


@pytest.mark.parametrize("T", [300, 301])  # 301 % p != 0 for every period: reflect pad
def test_discriminator_p_matches_jax(T):
    y = _audio(2, T, seed=T)
    jm = jhg.DiscriminatorP(3, channels=(8, 16))
    params = random_params(jm, jnp.zeros((1, T)), seed=5)
    want, wfmap = jm.apply({"params": params}, y)
    tm = convert.load_jax_params(thg.DiscriminatorP(3, (8, 16)), params)
    got, fmap = tm(t(y))
    assert_close(f"DiscriminatorP T={T} score", got, np.asarray(want), TOL)
    assert len(fmap) == len(wfmap)
    for i, (a, b) in enumerate(zip(fmap, wfmap)):
        assert_close(f"DiscriminatorP T={T} fmap {i}", a.permute(0, 2, 3, 1),
                     np.asarray(b), TOL)


def test_discriminator_s_clamps_groups():
    """width 8: groups 16 clamp to gcd(16, in, out); the convs' shapes equal JAX's."""
    y = _audio(2, 400, seed=6)
    jm = jhg.DiscriminatorS(width=8)
    params = random_params(jm, jnp.zeros((1, 400)), seed=7)
    tm = convert.load_jax_params(thg.DiscriminatorS(width=8), params)
    assert [getattr(tm, f"conv_{i}").groups for i in range(7)] == [1, 4, 8, 16, 16, 16, 1]
    want, wfmap = jm.apply({"params": params}, y)
    got, fmap = tm(t(y))
    assert_close("DiscriminatorS width=8 score", got, np.asarray(want), TOL)
    for i, (a, b) in enumerate(zip(fmap, wfmap)):
        assert_close(f"DiscriminatorS fmap {i}", a, np.asarray(b), TOL)


def _mpd_msd(seed, T=600):
    y, y_hat = _audio(2, T, seed), _audio(2, T, seed + 1)
    jmpd = jhg.MultiPeriodDiscriminator(channels=(8, 16))
    jmsd = jhg.MultiScaleDiscriminator(width=8)
    a0 = jnp.zeros((1, T))
    pmpd = random_params(jmpd, a0, a0, seed=seed + 2)
    pmsd = random_params(jmsd, a0, a0, seed=seed + 3)
    spec = _spectral(_init_spectral(jmsd, a0, a0), seed=seed + 4)
    tmpd = convert.load_jax_params(thg.MultiPeriodDiscriminator(channels=(8, 16)), pmpd)
    tmsd = convert.load_jax_params(thg.MultiScaleDiscriminator(width=8), pmsd, spec)
    return y, y_hat, (jmpd, pmpd, tmpd), (jmsd, pmsd, spec, tmsd)


def _check_outputs(name, got, want, nchw):
    for gl, wl in zip(got, want):  # rs, gs, fmap_rs, fmap_gs
        for i, (a, b) in enumerate(zip(gl, wl)):
            if isinstance(a, list):
                for m, (fa, fb) in enumerate(zip(a, b)):
                    assert_close(f"{name} fmap {i}.{m}",
                                 fa.permute(0, 2, 3, 1) if nchw else fa, np.asarray(fb), TOL)
            else:
                assert_close(f"{name} score {i}", a, np.asarray(b), TOL)


def test_mpd_msd_match_jax_and_scale0_reads_the_updated_u():
    """MSD with update_stats=True: scale 0 scores y, writing u, then y_hat with the u
    that write left (flax reads a variable written earlier in the same apply). The
    control, y_hat scored with the u from before the write, must miss JAX's scores."""
    y, y_hat, (jmpd, pmpd, tmpd), (jmsd, pmsd, spec, tmsd) = _mpd_msd(seed=10)
    _check_outputs("MPD", tmpd(t(y), t(y_hat)), jmpd.apply({"params": pmpd}, y, y_hat), True)
    want, new = jmsd.apply({"params": pmsd, "spectral": spec}, y, y_hat, update_stats=True,
                           mutable=["spectral"])
    u0 = tmsd.s0.conv_0.u.clone()
    got = tmsd(t(y), t(y_hat), update_stats=True)
    _check_outputs("MSD update_stats", got, want, False)
    for name, mod in tmsd.named_modules():
        if isinstance(mod, tconv.SNConv1d):
            node = new["spectral"]
            for part in name.split("."):
                node = node[part]
            assert_close(f"MSD u {name}", mod.u, np.asarray(node["u"]), 1e-6)
    # control: the fake pass of scale 0 with the u from before the real pass's write
    tmsd.s0.conv_0.u.copy_(u0)
    for name, mod in tmsd.s0.named_modules():
        if isinstance(mod, tconv.SNConv1d) and name != "conv_0":
            node = spec["s0"][name]
            mod.u.copy_(t(node["u"]))
    stale, _ = tmsd.s0(t(y_hat))
    assert np.abs(stale.detach().numpy() - np.asarray(want[1][0])).max() > 10 * TOL


def test_gan_losses_match_jax():
    y, y_hat, (jmpd, pmpd, tmpd), (jmsd, pmsd, spec, tmsd) = _mpd_msd(seed=20)
    rs, gs, fr, fg = jmpd.apply({"params": pmpd}, y, y_hat)
    trs, tgs, tfr, tfg = tmpd(t(y), t(y_hat))
    for name, got, want in (
            ("feature_loss", thg.feature_loss(tfr, tfg), jhg.feature_loss(fr, fg)),
            ("discriminator_loss", thg.discriminator_loss(trs, tgs),
             jhg.discriminator_loss(rs, gs)),
            ("generator_loss", thg.generator_loss(tgs), jhg.generator_loss(gs))):
        want = float(want)
        assert_close(name, got, np.float32(want), 1e-6 * abs(want))
