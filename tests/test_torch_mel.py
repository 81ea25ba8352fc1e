"""The port's mel front end (`ttscube_tpu_torch.dsp.mel`) against the JAX package's
`ttscube_tpu/dsp/mel.py::MelSpec` on the CPU: both configs, (T,) and (B, T) input.

The log amplifies the summation-order noise of the DFT and mel products where the mel
energy is small; the signals here are speech-like (a few harmonics plus noise), so the
log-mel stays well above the 1e-5 clamp and the distance stays at float32 noise."""

import numpy as np
import pytest

import jax.numpy as jnp

from ttscube_tpu.dsp import mel as jmel
from ttscube_tpu_torch.dsp import mel as tmel
from tests.torch_parity import assert_close, t

TOL_LOGMEL = 1e-4


def _audio(shape, seed):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    tt = np.arange(n) / 24000.0
    f0 = rng.uniform(90, 250, shape[:-1] + (1,))
    y = sum(0.3 / h * np.sin(2 * np.pi * h * f0 * tt + rng.uniform(0, 6)) for h in range(1, 6))
    return (y + 0.02 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("which", ["feature", "gan"])
@pytest.mark.parametrize("shape", [(12000,), (2, 9000)])
def test_melspec_matches_jax(which, shape):
    cfg = {"feature": "feature_mel_config", "gan": "gan_mel_config"}[which]
    y = _audio(shape, seed=len(shape))
    want = np.asarray(jmel.MelSpec(getattr(jmel, cfg)())(jnp.asarray(y)))
    got = tmel.MelSpec(getattr(tmel, cfg)())(t(y))
    assert got.shape == want.shape
    assert_close(f"MelSpec {which} {shape}", got, want, TOL_LOGMEL)


def test_constants_equal_jax():
    """The port's numpy copies of the filterbank, window and DFT matrices."""
    np.testing.assert_array_equal(tmel.mel_filterbank(24000, 1024, 80, 0.0, 12000.0),
                                  jmel.mel_filterbank(24000, 1024, 80, 0.0, 12000.0))
    np.testing.assert_array_equal(tmel.hann_window(1024), jmel.hann_window(1024))
    for a, b in zip(tmel._dft_matrices(1024, 1024, tmel.hann_window(1024)),
                    jmel._dft_matrices(1024, 1024, jmel.hann_window(1024))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmel.hz_to_mel(np.array([50.0, 3000.0])),
                                  jmel.hz_to_mel(np.array([50.0, 3000.0])))


def test_gan_mel_pads_by_reflection():
    """392 samples reflected on each side: the frame count is 1 + T // 240 for T a
    multiple of the hop, and the first frame's padding mirrors the signal."""
    y = _audio((4800,), seed=3)
    m = tmel.MelSpec(tmel.gan_mel_config())
    padded = m._pad(t(y)).numpy()
    assert padded.shape == (4800 + 2 * 392,)
    np.testing.assert_array_equal(padded[:392], y[1:393][::-1])
    assert m(t(y)).shape == (1 + (4800 + 784 - 1024) // 240, 80)


def _tone():
    """tests/test_dsp.py's golden signal: two tones and a little noise, one second."""
    rng = np.random.default_rng(0)
    tt = np.arange(24000) / 24000.0
    y = 0.5 * np.sin(2 * np.pi * 220 * tt) + 0.2 * np.sin(2 * np.pi * 1750 * tt)
    return (y + 0.01 * rng.standard_normal(len(tt))).astype(np.float32)


def test_feature_mel_matches_numpy_fft_golden():
    """log10(max(1e-5, mel_basis @ |rfft|)) of centred hann frames, in fp64 numpy; the
    JAX package's golden (tests/test_dsp.py) at its tolerance, 5e-3."""
    y = _tone()
    yp = np.pad(y.astype(np.float64), (512, 512))
    w = tmel.hann_window(1024)
    frames = np.stack([yp[i * 240: i * 240 + 1024] * w for i in range(1 + (len(yp) - 1024) // 240)])
    want = np.log10(np.maximum(1e-5, np.abs(np.fft.rfft(frames, axis=-1))
                               @ tmel.mel_filterbank(24000, 1024, 80).T))
    got = tmel.MelSpec(tmel.feature_mel_config())(t(y))
    assert_close("MelSpec feature vs numpy FFT golden", got, want, 5e-3)


def test_gan_mel_matches_torch_stft_golden():
    """The HiFi-GAN convention through torch.stft (reflect pad, no centring); the JAX
    package's golden (tests/test_dsp.py) at its tolerance, 5e-3."""
    import torch

    y = torch.from_numpy(_tone())[None]
    yp = torch.nn.functional.pad(y[None], (392, 392), mode="reflect")[0]
    spec = torch.stft(yp, 1024, hop_length=240, win_length=1024, window=torch.hann_window(1024),
                      center=False, onesided=True, return_complex=True)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    basis = torch.from_numpy(tmel.mel_filterbank(24000, 1024, 80, 0.0, 12000.0))
    want = torch.log(torch.clamp(basis @ mag, min=1e-5))[0].T
    got = tmel.MelSpec(tmel.gan_mel_config())(y[0])
    assert_close("MelSpec gan vs torch.stft golden", got, want.numpy(), 5e-3)
