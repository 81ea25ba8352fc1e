"""Parity of the port's mel inverse path with the JAX module on the CPU: preemphasis,
the complex STFT `MelSpec.fft`, its overlap-add inverse `ifft`, and Griffin-Lim from the
JAX run's own initial phase."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ttscube_tpu.dsp import mel as jmel
from ttscube_tpu_torch import dsp as tdsp
from ttscube_tpu_torch.dsp import mel as tmel
from tests.torch_parity import assert_close, one_cpu_thread, t  # noqa: F401

# PyTorch on one thread: the tier's workers share the machine's cores
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

SR = 24000


def _signal(n=12000, seed=0):
    """A tone with a little seeded noise."""
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / SR
    return (0.5 * np.sin(2 * np.pi * 330 * tt) + 0.05 * rng.standard_normal(n)).astype(
        np.float32)


def test_dsp_exports_match_jax():
    from ttscube_tpu import dsp as jdsp

    assert tdsp.__all__ == jdsp.__all__


def test_preemphasis_matches_jax():
    y = np.stack([_signal(4000, 1), _signal(4000, 2)])
    assert_close("preemphasis", tmel.preemphasis(t(y)), jmel.preemphasis(jnp.asarray(y)), 1e-7)
    assert_close("preemphasis coef 0.5", tmel.preemphasis(t(y), 0.5),
                 jmel.preemphasis(jnp.asarray(y), 0.5), 1e-7)


@pytest.mark.parametrize("pre", [True, False], ids=["preemphasis", "plain"])
def test_fft_matches_jax(pre):
    """Within 1e-5 of the spectrum's range, max(1, max |X|): each bin sums 1,024 fp32
    products, and at a peak of ~130 (the plain tone) the two packages' summation orders
    alone part by ~5e-5, as far as JAX's own result lies from the fp64 transform."""
    y = _signal()
    ms = tmel.MelSpec(tmel.feature_mel_config())
    want = np.asarray(jmel.MelSpec(jmel.feature_mel_config()).fft(jnp.asarray(y), pre))
    got = ms.fft(t(y), pre)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert_close("MelSpec.fft real", got.real, want.real, 1e-5 * scale)
    assert_close("MelSpec.fft imag", got.imag, want.imag, 1e-5 * scale)
    # fp64 products of the same fp32 constants: the port sits as close as JAX does
    yp = ms._pad(tmel.preemphasis(t(y)) if pre else t(y)).double()
    frames = tmel.frame_signal(yp, 1024, 240)
    exact = np.asarray(torch.complex(frames @ ms._consts[torch.device("cpu")][0].double(),
                                     frames @ ms._consts[torch.device("cpu")][1].double()))
    port_err, jax_err = (float(np.abs(a - exact).max()) for a in (got.numpy(), want))
    print(f"\nfft from fp64: port {port_err:.3e} JAX {jax_err:.3e}")
    assert port_err <= 2 * jax_err + 1e-6


def test_ifft_inverts_fft_as_jax_does():
    """The JAX test's round trip (tests/test_legacy_and_runtime.py): within 1e-3 of the
    signal away from the edges; and the port's inverse against JAX's on the same
    spectrum."""
    tt = np.arange(12000) / SR
    y = (0.5 * np.sin(2 * np.pi * 330 * tt)).astype(np.float32)
    jms, tms = jmel.MelSpec(jmel.feature_mel_config()), tmel.MelSpec(tmel.feature_mel_config())
    jspec = jms.fft(jnp.asarray(y), use_preemphasis=False)
    rec = tms.ifft(tms.fft(t(y), use_preemphasis=False), out_len=len(y))
    np.testing.assert_allclose(rec.numpy()[1000:-1000], y[1000:-1000], atol=1e-3)
    spec = np.asarray(jspec)
    got = tms.ifft(torch.complex(t(spec.real.copy()), t(spec.imag.copy())), out_len=len(y))
    assert_close("MelSpec.ifft", got, jms.ifft(jspec, out_len=len(y)), 1e-5)
    assert tms.ifft(tms.fft(t(y))).shape == ((spec.shape[0] - 1) * 240,)


def test_griffinlim_matches_jax_from_its_initial_phase():
    """8 iterations from the phase JAX draws from its default key: within 1e-4 of the
    signal's peak."""
    y = _signal()
    jms, tms = jmel.MelSpec(jmel.feature_mel_config()), tmel.MelSpec(tmel.feature_mel_config())
    mag = np.abs(np.asarray(jms.fft(jnp.asarray(y), use_preemphasis=False)))
    want = np.asarray(jms.griffinlim(jnp.asarray(mag), n_iter=8))
    phase = np.array(jax.random.uniform(jax.random.PRNGKey(0), mag.shape, minval=0.0,
                                          maxval=2 * np.pi))
    got = tms.griffinlim(t(mag), n_iter=8, phase=t(phase))
    assert got.shape == want.shape == ((mag.shape[0] - 1) * 240,)
    assert_close("griffinlim (8 iterations)", got, want, 1e-4 * float(np.abs(want).max()))
    # a phase drawn from a generator: seeded, so repeatable
    a = tms.griffinlim(t(mag), n_iter=2, generator=torch.Generator().manual_seed(5))
    b = tms.griffinlim(t(mag), n_iter=2, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
