"""The port's own file formats against the libraries the JAX package writes them with:
`ttscube_tpu_torch.utils.serialization` against flax's msgpack (`msgpack_serialize`,
`msgpack_restore`), and `ttscube_tpu_torch.utils.config_io` against PyYAML. The port
imports neither flax, msgpack nor yaml; these tests do, to hold it to them.

Limits: equal bytes and equal trees (same keys in the same order, same types, arrays of
the same dtype, shape and bits). Also: `TTSCube(model_path, phonemizer_path)` builds
and serves with yaml and msgpack unimportable (fault C5), bit-equal to the same weights
read by flax."""

import copy
import sys

import numpy as np
import pytest

import jax
import yaml
from flax import serialization as fser

from ttscube_tpu_torch import api as tapi
from ttscube_tpu_torch import convert
from ttscube_tpu_torch.utils import config_io, serialization
from tests.test_torch_api import DRIVE, SPEAKER, artifacts  # noqa: F401
from tests.torch_parity import TINY_HIFI, toy_train_batch, train_pair


def assert_same_tree(got, want, path="tree"):
    """Same structure, key order, leaf types, dtypes, shapes and bits."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same_tree(a, b, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def jax_state():
    """A JAX TrainState of the tiny config (parameters, both optimizer states with
    their masked leaves, spectral u, step)."""
    _, jstate, _ = train_pair(TINY_HIFI, toy_train_batch(), seed=5)
    return jstate


def numpy_tree(x):
    """A state dict with numpy leaves, its maps in their own order (jax.tree_util's
    maps would sort the keys)."""
    return {k: numpy_tree(v) for k, v in x.items()} if isinstance(x, dict) else np.asarray(x)


def test_writer_gives_flax_bytes_for_a_train_state(jax_state):
    """flax's `to_bytes` (what the JAX package's checkpoints use) writes the state dict's
    maps in their own order; its `msgpack_serialize` rebuilds the tree through
    jax.tree_util first, which sorts every map's keys. The port's writer keeps the order
    it is given, so it matches each on the tree that one writes."""
    tree = numpy_tree(fser.to_state_dict(jax_state))
    got = serialization.msgpack_serialize(tree)
    print(f"\nparity msgpack writer: {len(got)} bytes, equal to flax's: "
          f"{got == fser.to_bytes(jax_state)}")
    assert got == fser.to_bytes(jax_state)
    assert serialization.msgpack_serialize(jax.tree_util.tree_map(np.asarray, tree)) == \
        fser.msgpack_serialize(tree)


def test_writer_gives_flax_bytes_for_every_leaf_type():
    tree = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63, -1, -32, -33, -128,
                     -129, -2**15 - 1, -2**31 - 1, -2**62],
            "float": 1.5, "none": None, "bools": [True, False], "str": "x" * 40,
            "long_str": "y" * 300, "bytes": b"zz", "empty": {},
            "arrays": {"f32": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "f16": np.ones(3, np.float16), "i64": np.arange(20),
                       "u8": np.arange(4, dtype=np.uint8), "bool": np.array([True, False]),
                       "scalar": np.asarray(7, np.int32), "big": np.zeros(70000, np.float32)},
            "np_scalars": [np.float32(2.5), np.int64(-3), np.float64(0.1)],
            "keys": {str(i): i for i in range(20)}}
    assert serialization.msgpack_serialize(tree) == fser.msgpack_serialize(tree,
                                                                           in_place=True)


def test_reader_gives_flax_tree(jax_state):
    data = fser.to_bytes(jax_state)
    assert_same_tree(serialization.msgpack_restore(data), fser.msgpack_restore(data))


def test_chunked_leaves_both_ways(monkeypatch):
    """flax writes an array above MAX_CHUNK_SIZE bytes (2^30) as a map of flat chunks;
    the limit is lowered here so that a small leaf is chunked."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((7, 9)).astype(np.float32), "s": {"u": np.arange(3.0)},
            "b": np.arange(10, dtype=np.int16)}
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = fser.msgpack_serialize(copy.deepcopy(tree), in_place=True)  # chunks in place
    assert b"__msgpack_chunked_array__" in data
    assert serialization.msgpack_serialize(tree) == data
    got = serialization.msgpack_restore(data)
    assert_same_tree(got, fser.msgpack_restore(data))
    assert_same_tree(got, tree)


def test_reader_refuses_what_flax_does_not_write():
    with pytest.raises(ValueError, match="truncated"):
        serialization.msgpack_restore(fser.msgpack_serialize({"a": np.ones(4)})[:-3])
    with pytest.raises(ValueError, match="extension type 5"):
        serialization.msgpack_restore(b"\xd4\x05\x00")
    with pytest.raises(ValueError, match="follow"):
        serialization.msgpack_restore(b"\xc0\xc0")


# -- config_io ---------------------------------------------------------------------------

CONFIGS = [
    {"sample_rate": 24000, "hop_size": 240, "conditioning": None},
    {"sample_rate": 22050, "hop_size": 256, "conditioning": "hf:/models/bert base"},
    {"conditioning": "fasttext:en", "hop_size": 240, "sample_rate": 24000,
     "lm_config": {"hidden_size": 768, "layer_norm_eps": 1e-12, "dropout": 0.1,
                   "vocab": ["[PAD]", "it's", "a #b"], "nested": [[1, 3, 5], [1, 3]],
                   "flags": {"on": True, "off": False, "none": None}, "empty": {},
                   "none_list": [], "items": [{"a": 1, "b": [2, 3]}, {"c": "null"}],
                   "inf": float("inf"), "neg": -3, "big": 1e20}},
]


def test_reads_the_committed_checkpoint_yaml():
    path = DRIVE / "cubegan.yaml"
    assert config_io.load(str(path)) == yaml.safe_load(path.read_text())


@pytest.mark.parametrize("conf", CONFIGS)
def test_reads_what_yaml_dump_writes_and_writes_it_alike(conf):
    text = yaml.dump(conf)
    assert config_io.loads(text) == conf
    assert yaml.safe_load(config_io.dumps(conf)) == conf
    assert config_io.dumps(conf) == text


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n",           # anchor and alias
    "a: {b: 1}\n",                # flow-style mapping
    "a: [1, 2]\n",                # flow-style list
    "a: !!python/tuple [1]\n",    # tag
    "a: |\n  text\n",             # block scalar
    "a: 0o17\n", "a: 1e5\n",      # numbers whose reading YAML versions disagree on
    "---\na: 1\n",                # documents
    "a:\n\tb: 1\n",               # tab indentation
    "a: b: c\n",                  # a mapping inside a plain scalar
    "a: 1\na: 2\n",               # a repeated key
    "a: 'open\n",                 # a quoted scalar over two lines
])
def test_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError, match="not in the yaml subset"):
        config_io.loads(text)


def test_ttscube_reads_its_files_without_yaml_or_msgpack(artifacts, monkeypatch):  # noqa: F811
    """Fault C5: the port's file-loading path imported yaml and msgpack, which the
    card's machine lacks. With both unimportable, TTSCube reads the JAX package's files
    and serves the same audio as the same weights read by flax."""
    base = artifacts
    conf = yaml.safe_load((base / "cubegan.yaml").read_text())
    enc = tapi.CubeganEncodings(str(base / "cubegan.encodings"))
    penc = tapi.PhonemizerEncodings(str(base / "phonemizer.encodings"))
    cfg = tapi.config_from_yaml(conf, enc)
    tree = fser.msgpack_restore((base / "cubegan.model").read_bytes())
    ptree = fser.msgpack_restore((base / "phonemizer.model").read_bytes())
    state = convert.jax_to_state_dict(tapi.Cubegan(cfg), {"lang": tree["lang"],
                                                          "gen": tree["gen"]})
    pstate = convert.jax_to_state_dict(tapi.Phonemizer(tapi.phonemizer_config(penc)), ptree)
    want = tapi.TTSCube.from_state_dicts(cfg, enc, penc, state, pstate, device="cpu")
    for name in ("yaml", "msgpack"):
        monkeypatch.setitem(sys.modules, name, None)  # `import yaml` now raises
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    got = tapi.TTSCube(str(base / "cubegan"), str(base / "phonemizer"), device="cpu")
    a, b = got("hello world.", speaker=SPEAKER), want("hello world.", speaker=SPEAKER)
    assert a.dtype == np.int16 and len(a) > 0
    np.testing.assert_array_equal(a, b)
