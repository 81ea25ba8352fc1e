"""Parity of the port's text side with the JAX models on the CPU: Phonemizer and
Languasito2 (teacher-forced forward and free-synthesis `infer`). The JAX models are
initialised by flax and their trees carried across by ttscube_tpu_torch.convert."""

import numpy as np
import pytest

import torch

from ttscube_tpu.models import languasito as jla
from ttscube_tpu.models import phonemizer as jph
from ttscube_tpu_torch.convert import load_jax_params
from ttscube_tpu_torch.models import phonemizer as tph
from tests.torch_parity import LANG, assert_close, lang_pair_of, random_params, t

FRAMES = 96


@pytest.fixture(scope="module")
def lang_pair():
    return lang_pair_of(FRAMES)


def test_phonemizer_matches_jax():
    cfg = dict(num_graphemes=25, num_phonemes=24)
    jm = jph.Phonemizer(jph.PhonemizerConfig(**cfg))
    rng = np.random.default_rng(1)
    X = {"x_char": rng.integers(0, 25, (2, 17)).astype(np.int32),
         "x_case": rng.integers(0, 2, (2, 17)).astype(np.int32)}
    params = random_params(jm, X, seed=1)
    want = np.asarray(jm.apply({"params": params}, X))
    tm = load_jax_params(tph.Phonemizer(tph.PhonemizerConfig(**cfg)), params).eval()
    with torch.no_grad():
        got = tm({k: t(v).long() for k, v in X.items()}).numpy()
    assert_close("Phonemizer logits", got, want, 2e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_languasito_text_and_cond_forward_match_jax(lang_pair):
    jm, params, tm, X = lang_pair
    rng = np.random.default_rng(2)
    f2p = np.sort(rng.integers(0, 15, (2, FRAMES)), axis=1).astype(np.int32)
    pitch = rng.uniform(0, 300, (2, FRAMES)).astype(np.float32)
    Xj = dict(X, y_frame2phone=f2p, y_pitch=pitch)
    dur, p, vuv, cond = jm.apply({"params": params}, Xj)
    Xt = {k: t(v).long() for k, v in X.items()}
    with torch.no_grad():
        tdur, tp, tvuv = tm.text_forward(Xt, t(f2p).long())
        tcond = tm.cond_forward(Xt, t(f2p).long(), t(pitch))
    assert_close("Languasito2 dur logits", tdur, dur, 2e-4)
    assert_close("Languasito2 pitch", tp, p, 1e-5)
    assert_close("Languasito2 vuv", tvuv, vuv, 1e-5)
    assert_close("Languasito2 cond (teacher-forced)", tcond, cond, 2e-5)


def test_languasito_infer_matches_jax(lang_pair):
    """Free synthesis: equal durations and frame→phone map, pitch/VUV and the
    conditioning within the repo's tolerances."""
    jm, params, tm, X = lang_pair
    cond, aux = jm.apply({"params": params}, X, FRAMES, method=jla.Languasito2.infer)
    with torch.no_grad():
        tcond, taux = tm.infer({k: t(v).long() for k, v in X.items()}, FRAMES)
    np.testing.assert_array_equal(taux["durations"].numpy(), np.asarray(aux["durations"]))
    np.testing.assert_array_equal(taux["frame2phone"].numpy(), np.asarray(aux["frame2phone"]))
    np.testing.assert_array_equal(taux["frame_mask"].numpy(), np.asarray(aux["frame_mask"]))
    np.testing.assert_array_equal(taux["vuv"].numpy(), np.asarray(aux["vuv"]))
    assert_close("Languasito2.infer pitch / max_pitch", taux["pitch"] / LANG["max_pitch"],
                 np.asarray(aux["pitch"]) / LANG["max_pitch"], 1e-5)
    assert_close("Languasito2.infer cond", tcond, cond, 2e-5)
    assert int(taux["durations"].sum()) > 0
