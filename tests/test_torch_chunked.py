"""Serving in windows of frames (`generate_chunked`, `Cubegan.infer(chunk_frames=...)`)
and `TTSCube.warmup` in the port, against the JAX package on the CPU:

- `generate_chunked` against JAX's on tests/test_hifigan.py's config
  (`test_chunked_generator_matches_full`), 2e-6, with the short-input bypass;
- the chunked fused generator (the kernels' plain versions here) against JAX's whole
  flax output on tests/test_pallas_resblock.py's config
  (`test_chunked_generator_with_fused_path`), 3e-5, with the fused tail and with every
  stage fused, so that the fused stages meet the window edges. The input is longer than
  that test's 40 frames, which fit in one window of 12 + 2·28 frames and bypass it;
- `Cubegan.infer(chunk_frames=...)` at B = 3 against JAX's, 5e-5;
- `TTSCube.warmup` leaving the fused generator's packed stage weights in place for the
  requests that follow."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ttscube_tpu.models import cubegan as jcg
from ttscube_tpu.models import hifigan as jhg
from ttscube_tpu.models import languasito as jla
from ttscube_tpu_torch import api as tapi
from ttscube_tpu_torch.convert import init_random, load_jax_params
from ttscube_tpu_torch.data.encodings import CubeganEncodings, PhonemizerEncodings
from ttscube_tpu_torch.models import cubegan as tcg
from ttscube_tpu_torch.models import hifigan as thg
from ttscube_tpu_torch.models import hifigan_fused as thf
from ttscube_tpu_torch.models import languasito as tla
from ttscube_tpu_torch.models.phonemizer import Phonemizer
from tests.torch_parity import (LANG, SMALL_HIFI, assert_close, one_cpu_thread,  # noqa: F401
                                random_params, t, text_batch)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")
DRIVE = Path(__file__).resolve().parent.parent / "artifacts" / "drive_ckpt"
WIDE = (256, 128, 64, 32)


def _biased(params, shift):
    """Nonzero biases, as the JAX tests set them: a zero bias would hide a window edge
    that does not line up (conv(0) + bias ≠ 0 leaking through a window)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x + shift(x) if "bias" in jax.tree_util.keystr(p) else x, params)


def test_generate_chunked_matches_jax():
    cfg = dict(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 3),))
    jg = jhg.Generator(jhg.HifiganConfig(**cfg))
    cond = np.random.default_rng(3).standard_normal((2, 60, 80)).astype(np.float32)
    params = _biased(random_params(jg, cond, seed=3), lambda x: 0.05 * np.sin(
        np.arange(x.size)).reshape(x.shape).astype(x.dtype))
    tg = load_jax_params(thg.Generator(thg.HifiganConfig(**cfg)), params).eval()
    apply_fn = lambda c: jg.apply({"params": params}, c)
    up = jg.config.total_upsample
    want = np.asarray(jax.jit(lambda c: jhg.generate_chunked(apply_fn, c, up, chunk=24,
                                                             halo=16))(cond))
    full = np.asarray(apply_fn(cond))
    with torch.no_grad():
        got = thg.generate_chunked(tg, t(cond), up, chunk=24, halo=16)
    assert got.shape == want.shape == (2, 60 * up) and np.abs(want).max() > 1e-2
    assert_close("generate_chunked vs JAX's", got, want, 2e-6)
    assert_close("generate_chunked vs the whole JAX generator", got, full, 2e-6)
    # an input of at most one window runs whole
    short = np.random.default_rng(4).standard_normal((1, 16, 80)).astype(np.float32)
    want = np.asarray(jhg.generate_chunked(apply_fn, short, up, chunk=24, halo=16))
    with torch.no_grad():
        got = thg.generate_chunked(tg, t(short), up, chunk=24, halo=16)
        whole = tg(t(short))
    assert torch.equal(got, whole)
    assert_close("generate_chunked short input", got, want, 2e-6)


@pytest.mark.parametrize("fuse_channels", [(32,), WIDE], ids=["tail", "every stage"])
def test_chunked_fused_generator_matches_jax(fuse_channels):
    """HiFi-GAN v1's widths with one chain (k 3, dilations 1 and 3), biases +0.03, 100
    frames in windows of 12 + 2·28 (9 windows), through `generator_apply_fused`."""
    cfg = dict(resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
    jg = jhg.Generator(jhg.HifiganConfig(**cfg))
    mel = np.random.default_rng(4).standard_normal((2, 100, 80)).astype(np.float32)
    params = _biased(random_params(jg, mel[:, :4], seed=4), lambda x: 0.03)
    want = np.asarray(jax.jit(lambda m: jg.apply({"params": params}, m))(mel))
    tg = load_jax_params(thg.Generator(thg.HifiganConfig(**cfg)), params).eval()
    windows = []
    fused = lambda c: windows.append(c.shape[1]) or thf.generator_apply_fused(
        tg, c, tg.config, fuse_channels=fuse_channels)
    with torch.no_grad():
        got = thg.generate_chunked(fused, t(mel), 240, chunk=12, halo=28)
    assert windows == [68] * 9 and got.shape == want.shape and np.abs(want).max() > 1e-2
    assert_close(f"chunked generator_apply_fused {fuse_channels}", got, want, 3e-5)


def test_cubegan_infer_chunked_matches_jax():
    """Cubegan.infer(chunk_frames=24) at B = 3 and max_frames 128 (windows of 24 + 2·32
    frames) with the fused tail, against the JAX model's; equal durations, 5e-5."""
    X = text_batch(B=3)
    frames, chunk = 128, 24
    jl = jla.Languasito2(jla.LanguasitoConfig(**LANG))
    lparams = random_params(jl, dict(X, y_frame2phone=np.zeros((3, frames), np.int32),
                                     y_pitch=np.zeros((3, frames), np.float32)), seed=5)
    hifi = dict(SMALL_HIFI, fused_tail=True)
    gparams = _biased(random_params(jhg.Generator(jhg.HifiganConfig(**hifi)),
                                    jnp.zeros((1, 4, 80)), seed=6), lambda x: 0.03)
    params = {"lang": lparams, "gen": gparams}
    jm = jcg.Cubegan(jcg.CubeganConfig(languasito=jla.LanguasitoConfig(**LANG),
                                       hifigan=jhg.HifiganConfig(**hifi), hop_size=16),
                     train=False)
    want, aux = jax.jit(lambda p, x: jm.infer(p, x, frames, chunk_frames=chunk))(params, X)
    tm = tcg.Cubegan(tcg.CubeganConfig(languasito=tla.LanguasitoConfig(**LANG),
                                       hifigan=thg.HifiganConfig(**hifi), hop_size=16))
    load_jax_params(tm, params).eval()
    Xt = {k: t(v).long() for k, v in X.items()}
    got, taux = tm.infer(Xt, max_frames=frames, chunk_frames=chunk)
    whole, _ = tm.infer(Xt, max_frames=frames)
    np.testing.assert_array_equal(taux["durations"].numpy(), np.asarray(aux["durations"]))
    assert got.shape == (3, frames * 16) and int(taux["durations"].sum()) > 0
    assert_close("Cubegan.infer chunk_frames=24 B=3", got, np.asarray(want), 5e-5)
    assert_close("Cubegan.infer chunked vs whole", got, whole, 5e-5)


def test_warmup_fills_the_stage_weight_cache():
    """After warmup a request packs no stage weights: the cache keeps its entries and
    the same packed tensors."""
    enc = CubeganEncodings(str(DRIVE / "cubegan.encodings"))
    penc = PhonemizerEncodings(str(DRIVE / "phonemizer.encodings"))
    hifi = {k: list(v) if isinstance(v, tuple) else v for k, v in SMALL_HIFI.items()}
    cfg = tapi.config_from_yaml({"hop_size": 16, "hifigan": hifi}, enc)
    assert cfg.hifigan.fused_tail and cfg.hifigan.storage_dtype == "bfloat16"
    state = init_random(tcg.Cubegan(cfg), 0).state_dict()
    pstate = init_random(Phonemizer(tapi.phonemizer_config(penc)), 1).state_dict()
    cube = tapi.TTSCube.from_state_dicts(cfg, enc, penc, state, pstate, device="cpu")
    cache = cube.model.gen._stage_cache
    assert not cache
    cube.warmup(frame_buckets=(tapi.FRAME_BUCKET,), char_lens=(tapi.CHAR_BUCKET,))
    packed = {k: v[1] for k, v in cache.items()}
    assert list(packed) == [(1, torch.bfloat16)]  # SMALL_HIFI's last stage, bf16 operands
    pcm = cube("hello world.", speaker=next(iter(enc.speaker2int)))
    assert pcm.dtype == np.int16 and len(pcm) > 0
    assert {k: v[1] for k, v in cache.items()} == packed
    assert all(cache[k][1] is v for k, v in packed.items())
