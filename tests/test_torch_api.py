"""The port's synthesis API end to end against the JAX TTSCube on the CPU, on random
weights written to a temporary directory in the JAX package's file formats; the port's
copies of the data modules against the originals; and the JAX → PyTorch → JAX round
trip of parameter trees, bit-exact."""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import yaml
from flax import serialization

from ttscube_tpu.data import collate as jcollate
from ttscube_tpu.data.encodings import CubeganEncodings, PhonemizerEncodings
from ttscube_tpu.models.cubegan import Cubegan, CubeganConfig
from ttscube_tpu.models.hifigan import HifiganConfig
from ttscube_tpu.models.languasito import LanguasitoConfig
from ttscube_tpu.models.phonemizer import Phonemizer, PhonemizerConfig
from ttscube_tpu.utils.checkpoint import save_params
from ttscube_tpu_torch import api as tapi
from ttscube_tpu_torch import convert
from ttscube_tpu_torch.data import collate as tcollate
from ttscube_tpu_torch.data import encodings as tenc
from tests.torch_parity import SMALL_HIFI, assert_close, random_params

TEXTS = ("hello world.", "speak to me.")  # one phone bucket: one JAX compile
SPEAKER = "spk1"
HOP = 16  # SMALL_HIFI upsamples ×16
DRIVE = Path(__file__).resolve().parent.parent / "artifacts" / "drive_ckpt"


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A cubegan + phonemizer pair in the JAX package's formats (fp32 serving)."""
    base = tmp_path_factory.mktemp("torch_api")
    penc = PhonemizerEncodings(str(DRIVE / "phonemizer.encodings"))
    penc.save(str(base / "phonemizer.encodings"))
    pm = Phonemizer(PhonemizerConfig(num_graphemes=len(penc.graphemes),
                                     num_phonemes=len(penc.phonemes)))
    pparams = random_params(pm, {"x_char": jnp.zeros((1, 8), jnp.int32),
                                 "x_case": jnp.zeros((1, 8), jnp.int32)}, seed=0)
    save_params(str(base / "phonemizer.model"), pparams)

    enc = CubeganEncodings(str(DRIVE / "cubegan.encodings"))
    enc.save(str(base / "cubegan.encodings"))
    hifi = dict(SMALL_HIFI, storage_dtype="float32")
    yaml.dump({"sample_rate": 24000, "hop_size": HOP, "conditioning": None,
               "hifigan": {k: list(v) if isinstance(v, tuple) else v
                           for k, v in hifi.items()}},
              open(base / "cubegan.yaml", "w"))
    model = Cubegan(CubeganConfig(
        languasito=LanguasitoConfig(num_phones=len(enc.phon2int),
                                    num_speakers=len(enc.speaker2int),
                                    max_pitch=enc.max_pitch, max_duration=enc.max_duration),
        hifigan=HifiganConfig(**hifi), hop_size=HOP), train=False)
    lang = random_params(model.languasito, {
        "x_char": jnp.zeros((1, 8), jnp.int32), "x_speaker": jnp.zeros((1, 1), jnp.int32),
        "y_frame2phone": jnp.zeros((1, 16), jnp.int32),
        "y_pitch": jnp.zeros((1, 16), jnp.float32)}, seed=1)
    gen = random_params(model.generator, jnp.zeros((1, 4, 80)), seed=2)
    save_params(str(base / "cubegan.model"), {"lang": lang, "gen": gen})
    return base


@pytest.fixture(scope="module")
def cubes(artifacts):
    from ttscube_tpu.api import TTSCube as JaxTTSCube

    jc = JaxTTSCube(str(artifacts / "cubegan"), str(artifacts / "phonemizer"))
    tc = tapi.TTSCube(str(artifacts / "cubegan"), str(artifacts / "phonemizer"),
                      device="cpu")
    return jc, tc


def _jax_synthesize(cube, text):
    return _jax_synthesize_as(cube, text, SPEAKER)


def _jax_synthesize_as(cube, text, speaker):
    """The JAX TTSCube.__call__ steps, stopping before the int16 conversion."""
    from ttscube_tpu.api import FRAME_BUCKET, MAX_FRAMES

    Xi = cube._prepare(text, speaker)
    total = max(int(jax.device_get(cube._dur_fn(cube.params, Xi))), 1)
    bucket = int(np.clip(-(-total // FRAME_BUCKET) * FRAME_BUCKET, FRAME_BUCKET, MAX_FRAMES))
    audio = np.asarray(cube._infer_at(bucket)(cube.params, Xi))[0]
    return audio[: total * cube.config.hop_size], total


def test_front_end_matches_jax(cubes):
    """Tokenizer, aligned phonemizer and collate: identical model inputs."""
    jc, tc = cubes
    for text in TEXTS:
        jm, tm = jc.text2feat(text), tc.text2feat(text)
        assert jm == tm
        Xj = jc._prepare(text, SPEAKER)
        Xt = tc._prepare(text, SPEAKER)
        for k, v in Xt.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(Xj[k]))


def test_ttscube_matches_jax_fp32(cubes):
    """Same durations; audio within 5e-5 (fp32); int16 within one step."""
    jc, tc = cubes
    for text in TEXTS:
        want, total = _jax_synthesize(jc, text)
        got, t_total = tc.synthesize(text, SPEAKER)
        assert t_total == total == tc.frames(text, SPEAKER)
        assert got.shape == want.shape == (total * HOP,)
        assert np.abs(want).max() > 1e-3
        assert_close("TTSCube audio fp32", got, want, 5e-5)
        pcm_t, pcm_j = tc(text, SPEAKER), jc(text, SPEAKER)
        assert pcm_t.dtype == np.int16 and pcm_t.shape == pcm_j.shape
        assert np.abs(pcm_t.astype(np.int32) - pcm_j).max() <= 1


def test_unknown_text_yields_one_frame(cubes):
    _, tc = cubes
    pcm = tc("12345", SPEAKER)
    assert pcm.dtype == np.int16 and len(pcm) % HOP == 0 and len(pcm) >= HOP


def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y)


def test_parameter_tree_round_trip_is_bit_exact(artifacts):
    """JAX tree → state dict → JAX tree, for the written Cubegan and phonemizer: the
    port's msgpack reader gives flax's own tree, and the round trip changes no bit."""
    enc = tenc.CubeganEncodings(str(artifacts / "cubegan.encodings"))
    with open(artifacts / "cubegan.yaml") as f:
        cfg = tapi.config_from_yaml(yaml.safe_load(f), enc)
    for name, module in (("cubegan", tapi.Cubegan(cfg)),
                         ("phonemizer", tapi.Phonemizer(tapi.phonemizer_config(
                             tenc.PhonemizerEncodings(str(artifacts / "phonemizer.encodings")))))):
        raw = (artifacts / f"{name}.model").read_bytes()
        tree = convert.read_msgpack(str(artifacts / f"{name}.model"))
        _assert_trees_equal(tree, serialization.msgpack_restore(raw))
        back = convert.state_dict_to_jax(module, convert.jax_to_state_dict(module, tree))
        _assert_trees_equal(back, tree)


def test_committed_phonemizer_round_trip_is_bit_exact():
    """The trained phonemizer in the repo goes to the port and back unchanged."""
    penc = tenc.PhonemizerEncodings(str(DRIVE / "phonemizer.encodings"))
    tree = convert.read_msgpack(str(DRIVE / "phonemizer.best"))
    module = convert.load_jax_params(tapi.Phonemizer(tapi.phonemizer_config(penc)), tree)
    _assert_trees_equal(convert.state_dict_to_jax(module), tree)


@pytest.mark.slow
def test_committed_cubegan_round_trip_is_bit_exact():
    """The trained 392 MB Cubegan `.last` ({lang, gen, mpd, msd}): its lang and gen
    subtrees go to the port and back unchanged."""
    enc = tenc.CubeganEncodings(str(DRIVE / "cubegan.encodings"))
    with open(DRIVE / "cubegan.yaml") as f:
        cfg = tapi.config_from_yaml(yaml.safe_load(f), enc)
    tree = convert.read_msgpack(str(DRIVE / "cubegan.last"))
    sub = {"lang": tree["lang"], "gen": tree["gen"]}
    module = convert.load_jax_params(tapi.Cubegan(cfg), sub)
    _assert_trees_equal(convert.state_dict_to_jax(module), sub)


@pytest.mark.slow
def test_ttscube_matches_jax_on_trained_weights(tmp_path):
    """The trained checkpoint in the repo (its lang and gen subtrees, the phonemizer's
    best weights), served in fp32 by both TTSCubes: equal durations, audio within 5e-5."""
    tree = convert.read_msgpack(str(DRIVE / "cubegan.last"))
    save_params(str(tmp_path / "cubegan.model"), {"lang": tree["lang"], "gen": tree["gen"]})
    (tmp_path / "phonemizer.model").write_bytes((DRIVE / "phonemizer.best").read_bytes())
    for name in ("cubegan.encodings", "phonemizer.encodings"):
        (tmp_path / name).write_bytes((DRIVE / name).read_bytes())
    conf = yaml.safe_load(open(DRIVE / "cubegan.yaml"))
    conf["hifigan"] = {"storage_dtype": "float32"}
    yaml.dump(conf, open(tmp_path / "cubegan.yaml", "w"))
    from ttscube_tpu.api import TTSCube as JaxTTSCube

    jc = JaxTTSCube(str(tmp_path / "cubegan"), str(tmp_path / "phonemizer"))
    tc = tapi.TTSCube(str(tmp_path / "cubegan"), str(tmp_path / "phonemizer"), device="cpu")
    speaker = next(iter(jc.encodings.speaker2int))
    for text in ("hello world.", "the boat sails past the old red lighthouse."):
        want, total = _jax_synthesize_as(jc, text, speaker)
        got, t_total = tc.synthesize(text, speaker)
        assert t_total == total
        assert_close("TTSCube audio fp32, trained weights", got, want, 5e-5)


def test_data_copies_match_the_originals():
    """The port's encodings and collate are copies; they must stay in step."""
    jenc = CubeganEncodings(str(DRIVE / "cubegan.encodings"))
    tenc_ = tenc.CubeganEncodings(str(DRIVE / "cubegan.encodings"))
    assert vars(jenc) == vars(tenc_)
    rng = np.random.default_rng(0)
    phones = list(jenc.phon2int)
    batch = []
    for n in (5, 40):
        p = [phones[i] for i in rng.integers(0, len(phones), n)]
        batch.append({"meta": {"speaker": "spk2", "phones": p, "words": ["w"] * 3,
                               "phon2word": sorted(rng.integers(0, 3, n).tolist()),
                               "frame2phon": sorted(rng.integers(0, n, 3 * n).tolist())},
                      "mgc": rng.standard_normal((3 * n, 80)).astype(np.float32),
                      "pitch": rng.uniform(0, 300, 3 * n).astype(np.float32)})
    want = jcollate.CubeganCollate(jenc, bucket_words=8)(batch)
    got = tcollate.CubeganCollate(tenc_, bucket_words=8)(batch)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
