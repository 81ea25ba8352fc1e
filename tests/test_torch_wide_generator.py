"""The port's serving generator with every HiFi-GAN v1 stage fused (`fuse_channels`
(256, 128, 64, 32): B3 on stages 0 and 1, B1-mid on stage 2, B1 on stage 3; their plain
versions on the CPU) against the JAX package: the generator against JAX's
`Generator.apply` in fp32 and, stage by stage, against JAX ops rounding where the TPU
kernels round in bf16, TTSCube against the JAX TTSCube, the stages the port refuses, and (slow tier) the
JAX function's own fused path through the Pallas kernels in interpret mode."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import yaml

from ttscube_tpu.models import hifigan as jhg
from ttscube_tpu.models import hifigan_fused as jhf
from ttscube_tpu.ops.conv import _conv, _conv_transpose
from ttscube_tpu_torch.convert import init_random, load_jax_params
from ttscube_tpu_torch.models import hifigan as thg
from ttscube_tpu_torch.models import hifigan_fused as thf
from tests.torch_parity import (assert_close, jax_tail_case, jax_tail_stage,  # noqa: F401
                                one_cpu_thread, random_params, t)

# PyTorch on one thread beside the tier's other workers (tests/torch_parity.py)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

WIDE = (256, 128, 64, 32)
# HiFi-GAN v1's widths and upsampling with two of its chains, as in
# tests/test_pallas_resblock.py::test_fused_generator_wide_fuse_channels
HIFI = dict(resblock_kernel_sizes=(3, 11), resblock_dilation_sizes=((1, 3), (1, 3, 5)))


def _pair(hifi, seed):
    """A JAX generator's seeded parameters, biases moved by +0.03 as in the JAX test,
    and the port's generator holding them."""
    jcfg = jhg.HifiganConfig(**hifi)
    params = random_params(jhg.Generator(jcfg), jnp.zeros((1, 4, 80)), seed=seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.03 if "bias" in jax.tree_util.keystr(p) else x, params)
    tg = load_jax_params(thg.Generator(thg.HifiganConfig(**hifi)), params).eval()
    return jcfg, params, tg


def _mrf_mean(x, params, i, cfg, compute_dtype):
    """Stage i's MRF as the TPU kernels compute it: fp32 between convs, operands
    rounded to `compute_dtype`."""
    acc = None
    for j, dils in enumerate(cfg.resblock_dilation_sizes):
        p = params[f"res_{i}_{j}"]
        n = 2 * len(dils)
        h = jhf._plain_resblock1(x, [jhf._wn(p[f"WNConv1d_{m}"]) for m in range(n)],
                                 [p[f"WNConv1d_{m}"]["bias"] for m in range(n)], dils,
                                 compute_dtype=compute_dtype, storage_dtype=None)
        acc = h if acc is None else acc + h
    return acc / len(cfg.resblock_dilation_sizes)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def test_wide_generator_matches_jax_fp32():
    """tests/test_pallas_resblock.py::test_fused_generator_wide_fuse_channels's case
    (v1 geometry, chains (3, 11), 6 frames, biases +0.03) at its tolerance, 3e-5."""
    jcfg, params, tg = _pair(HIFI, seed=8)
    mel = np.random.default_rng(8).standard_normal((1, 6, 80)).astype(np.float32)
    want = np.asarray(jhg.Generator(jcfg).apply({"params": params}, mel))
    with torch.no_grad():
        got = thf.generator_apply_fused(tg, t(mel), tg.config, fuse_channels=WIDE).numpy()
    assert want.shape == got.shape == (1, 6 * 240) and np.abs(want).max() > 1e-2
    assert_close("generator_apply_fused, every stage fused, fp32", got, want, 3e-5)


def test_wide_generator_bf16_stages_within_precision_floor():
    """Serving dtypes with every stage fused, stage by stage: each fused stage gets the
    bf16 input that JAX ops rounding where the JAX function with its TPU kernels rounds
    give it, and is held against those ops' fp32 output of the stage (bf16 conv
    operands, fp32 between convs; conv_pre and the unfused upsamples stored in bf16).
    The floor is the reference stage's bf16-vs-fp32 distance on that input; as for B1,
    the port must sit within half the floor's RMS and within its max, and two controls
    must not: the port's stage in fp32, and (MRF stages) the chains rounding to bf16
    between convs, as the unfused path stores them.

    Held end to end instead, the check would not separate: through four fused stages a
    flipped bf16 rounding grows from conv to conv, and summation order alone (the same
    port without oneDNN) sits 0.76-0.97 of the floor's RMS from the reference over four
    seeds, the fp32 port at 1.0 (PERF.md)."""
    bf, f32 = jnp.bfloat16, jnp.float32
    tbf = torch.bfloat16
    leaky = lambda x: jax.nn.leaky_relu(x, 0.1)
    jcfg, params, tg = _pair(HIFI, seed=5)
    mel = np.random.default_rng(5).standard_normal((1, 12, 80)).astype(np.float32)
    pp = params["conv_pre"]
    x = jhf._st(_conv(*jhf._cd(jnp.asarray(mel), jhf._wn(pp), bf), 1, 3, 1, 1) + pp["bias"], bf)
    last = len(jcfg.upsample_rates) - 1
    for i, (u, k) in enumerate(zip(jcfg.upsample_rates, jcfg.upsample_kernel_sizes)):
        up = params[f"up_{i}"]
        z = x.astype(f32)
        controls = {}
        with torch.no_grad():
            if i == last:
                case = jax_tail_case(params, jcfg, z)
                ref = {cd: jax_tail_stage(case, cd) for cd in (bf, None)}
                got = {cd: thf.fused_tail_stage(t(np.asarray(z)), tg.stage_weights(i, cd)).numpy()
                       for cd in (tbf, None)}
            elif k == u:  # the whole stage: its upsample stays fp32
                stage = lambda cd: _mrf_mean(
                    _conv_transpose(*jhf._cd(leaky(z), jhf._wn(up), cd), u, 0) + up["bias"],
                    params, i, jcfg, cd)
                ref = {cd: np.asarray(stage(cd)) for cd in (bf, None)}
                got = {cd: thf.fused_tail_stage_mid(t(np.asarray(z)), tg.stage_weights(i, cd))
                       .numpy() for cd in (tbf, None)}
            else:         # JAX's unfused upsample stored in bf16, then the MRF kernel
                h = jhf._st(_conv_transpose(*jhf._cd(leaky(x), jhf._wn(up), bf), u,
                                            (k - u) // 2) + up["bias"], bf).astype(f32)
                ref = {cd: np.asarray(_mrf_mean(h, params, i, jcfg, cd)) for cd in (bf, None)}
                got = {cd: thf.fused_mrf1(t(np.asarray(h)), tg.stage_weights(i, cd)).numpy()
                       for cd in (tbf, None)}
                blocks = [getattr(tg, f"res_{i}_{j}") for j in range(len(jcfg.resblock_kernel_sizes))]
                controls["bf16 between convs"] = (sum(
                    thf._plain_resblock1(t(np.asarray(h)).to(tbf), b, tbf, tbf).float()
                    for b in blocks) / len(blocks)).numpy()
        want = ref[bf]
        floor_max, floor_rms = np.abs(want - ref[None]).max(), _rms(want - ref[None])
        within = lambda a: (_rms(a - want) <= 0.5 * floor_rms
                            and np.abs(a - want).max() <= floor_max)
        assert floor_max > 1e-4
        print(f"\nparity wide generator bf16 stage {i}: floor max {floor_max:.3e} rms "
              f"{floor_rms:.3e}; port ({np.abs(got[tbf] - want).max() / floor_max:.3f}, "
              f"{_rms(got[tbf] - want) / floor_rms:.3f}) of it (max, rms)")
        assert within(got[tbf]), i
        assert not within(got[None]), i
        for name, a in controls.items():
            assert not within(a), (i, name)
        if i < last:
            x = jhf._st(jnp.asarray(want), bf)


@pytest.mark.parametrize("hifi,fuse,stage", [
    # a 512-wide first stage: JAX fuses it with fused_mrf1 at fold 1; B3 stops at 256
    (dict(upsample_initial_channel=1024, resblock_kernel_sizes=(3,),
          resblock_dilation_sizes=((1,),)), (512,), 0),
    # a 64-wide last stage with kernel == stride: JAX runs fused_tail_stage with
    # conv_post at C = 64; B1 takes C = 32 only
    (dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 4), upsample_initial_channel=256,
          resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),)), (64,), 1),
])
def test_generator_refuses_a_stage_no_kernel_takes(hifi, fuse, stage):
    """A stage that the JAX function fuses and no kernel of the port takes raises,
    naming the stage and the limit; it never runs as stock convs."""
    gen = init_random(thg.Generator(thg.HifiganConfig(**hifi)), 0)
    with pytest.raises(ValueError, match=f"stage {stage} .*(256|C = 32)"):
        thf.generator_apply_fused(gen, torch.zeros(1, 2, 80), gen.config, fuse_channels=fuse)


@pytest.fixture(scope="module")
def wide_cubes(tmp_path_factory):
    """The JAX TTSCube and the port's, on the same seeded weights: a Cubegan at v1's
    generator widths (two short chains, to keep the CPU's work small), fp32 storage,
    `fuse_channels` (256, 128, 64, 32) in the yaml."""
    from pathlib import Path

    from ttscube_tpu.api import TTSCube as JaxTTSCube
    from ttscube_tpu.data.encodings import CubeganEncodings, PhonemizerEncodings
    from ttscube_tpu.models.cubegan import Cubegan, CubeganConfig
    from ttscube_tpu.models.languasito import LanguasitoConfig
    from ttscube_tpu.models.phonemizer import Phonemizer, PhonemizerConfig
    from ttscube_tpu.utils.checkpoint import save_params
    from ttscube_tpu_torch import api as tapi
    from ttscube_tpu_torch.data import encodings as tenc

    drive = Path(__file__).resolve().parent.parent / "artifacts" / "drive_ckpt"
    base = tmp_path_factory.mktemp("torch_wide")
    penc = PhonemizerEncodings(str(drive / "phonemizer.encodings"))
    penc.save(str(base / "phonemizer.encodings"))
    pm = Phonemizer(PhonemizerConfig(num_graphemes=len(penc.graphemes),
                                     num_phonemes=len(penc.phonemes)))
    pparams = random_params(pm, {"x_char": jnp.zeros((1, 8), jnp.int32),
                                 "x_case": jnp.zeros((1, 8), jnp.int32)}, seed=0)
    save_params(str(base / "phonemizer.model"), pparams)
    enc = CubeganEncodings(str(drive / "cubegan.encodings"))
    enc.save(str(base / "cubegan.encodings"))
    hifi = dict(resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 2), (1,)),
                storage_dtype="float32", fuse_channels=WIDE)
    conf = {"sample_rate": 24000, "hop_size": 240, "conditioning": None,
            "hifigan": {k: [list(x) if isinstance(x, tuple) else x for x in v]
                        if isinstance(v, tuple) else v for k, v in hifi.items()}}
    yaml.dump(conf, open(base / "cubegan.yaml", "w"))
    model = Cubegan(CubeganConfig(
        languasito=LanguasitoConfig(num_phones=len(enc.phon2int),
                                    num_speakers=len(enc.speaker2int),
                                    max_pitch=enc.max_pitch, max_duration=enc.max_duration),
        hifigan=jhg.HifiganConfig(**hifi)), train=False)
    lang = random_params(model.languasito, {
        "x_char": jnp.zeros((1, 8), jnp.int32), "x_speaker": jnp.zeros((1, 1), jnp.int32),
        "y_frame2phone": jnp.zeros((1, 16), jnp.int32),
        "y_pitch": jnp.zeros((1, 16), jnp.float32)}, seed=1)
    gen = random_params(model.generator, jnp.zeros((1, 4, 80)), seed=2)
    save_params(str(base / "cubegan.model"), {"lang": lang, "gen": gen})

    jc = JaxTTSCube(str(base / "cubegan"), str(base / "phonemizer"))
    tenc_ = tenc.CubeganEncodings(str(base / "cubegan.encodings"))
    tpenc = tenc.PhonemizerEncodings(str(base / "phonemizer.encodings"))
    cfg = tapi.config_from_yaml(conf, tenc_)
    assert cfg.hifigan.fuse_channels == WIDE and cfg.hifigan.fused_tail
    state = load_jax_params(tapi.Cubegan(cfg), {"lang": lang, "gen": gen}).state_dict()
    pstate = load_jax_params(tapi.Phonemizer(tapi.phonemizer_config(tpenc)), pparams).state_dict()
    tc = tapi.TTSCube.from_state_dicts(cfg, tenc_, tpenc, state, pstate, device="cpu")
    return jc, tc


def test_ttscube_wide_matches_jax_fp32(wide_cubes):
    """Equal durations; audio within 5e-5 (tests/test_composed_parity.py's audio
    tolerance). The JAX TTSCube runs its plain path on the CPU, the port its kernels'
    plain versions, so the fusion is checked to change no value."""
    from ttscube_tpu.api import FRAME_BUCKET, MAX_FRAMES

    jc, tc = wide_cubes
    speaker = next(iter(jc.encodings.speaker2int))
    text = "hello world."
    Xi = jc._prepare(text, speaker)
    total = max(int(jax.device_get(jc._dur_fn(jc.params, Xi))), 1)
    bucket = int(np.clip(-(-total // FRAME_BUCKET) * FRAME_BUCKET, FRAME_BUCKET, MAX_FRAMES))
    want = np.asarray(jc._infer_at(bucket)(jc.params, Xi))[0][: total * 240]
    got, t_total = tc.synthesize(text, speaker)
    assert t_total == total
    assert np.abs(want).max() > 1e-3
    assert_close("TTSCube audio fp32, every stage fused", got, want, 5e-5)


@pytest.mark.slow
def test_wide_generator_matches_jax_pallas_interpret():
    """The JAX function's own fused path (its Pallas kernels in interpret mode) against
    the port's, fp32, at that function's test tolerance."""
    jcfg, params, tg = _pair(HIFI, seed=8)
    mel = np.random.default_rng(8).standard_normal((1, 6, 80)).astype(np.float32)
    want = np.asarray(jhf.generator_apply_fused(params, jnp.asarray(mel), jcfg,
                                                rows_per_tile=256, interpret=True,
                                                fuse_channels=WIDE))
    with torch.no_grad():
        got = thf.generator_apply_fused(tg, t(mel), tg.config, fuse_channels=WIDE).numpy()
    assert_close("generator_apply_fused every stage fused vs JAX Pallas interpret", got,
                 want, 3e-5)
