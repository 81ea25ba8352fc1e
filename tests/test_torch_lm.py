"""The port's HF-conditioning encoder (`ttscube_tpu_torch/models/lm.py`) against the JAX
package's `TransformerEncoder` (weights carried by `convert`), against `transformers`'
`BertModel` through `load_local_lm`, and its safetensors reader against
`safetensors.numpy`; on the CPU, at a tiny width (hidden 32, 2 layers, 4 heads).

Limits: the encoder against JAX 2e-5 (flax's LayerNorm takes the variance as E[x²] −
E[x]², PyTorch in two passes), on a batch with a padded row and a row whose tokens are
all masked; against `BertModel` on the unmasked positions at the JAX test's 3e-5
(tests/test_lm.py); the safetensors arrays equal."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ttscube_tpu.models import lm as jlm
from ttscube_tpu_torch.convert import init_random, load_jax_params, state_dict_to_jax
from ttscube_tpu_torch.models import lm as tlm
from tests.torch_parity import assert_close, random_params

TINY = dict(vocab_size=60, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=64, dropout=0.0)


def _batch(seed=0):
    """(B=3, T=9) ids: a full row, a row padded after 6 tokens, a row all masked."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TINY["vocab_size"], (3, 9)).astype(np.int32)
    mask = np.ones((3, 9), bool)
    mask[1, 6:] = False
    ids[1, 6:] = 0
    mask[2] = False
    return ids, mask


@pytest.fixture(scope="module")
def pair():
    jm = jlm.TransformerEncoder(jlm.LMConfig(**TINY))
    ids, mask = _batch()
    params = random_params(jm, jnp.asarray(ids), jnp.asarray(mask), seed=0)
    tm = load_jax_params(tlm.TransformerEncoder(tlm.LMConfig(**TINY)), params).eval()
    return jm, params, tm


def test_encoder_matches_jax(pair):
    """A full row, a padded row (positions past 6 masked) and a row with every token
    masked (a uniform softmax in both, not NaN)."""
    jm, params, tm = pair
    ids, mask = _batch()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert np.isfinite(want).all() and bool(torch.isfinite(got).all())
    assert_close("lm encoder (padded and fully masked rows)", got, want, 2e-5)
    # the default mask is ids != pad
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids)))
    assert_close("lm encoder (default mask)", tm(torch.from_numpy(ids).long()), want, 2e-5)


def test_encoder_never_drops_out(pair):
    """The control of the dropout rule: under train() the encoder gives what eval()
    gives, as the JAX encoder runs deterministic in training too."""
    _, params, _ = pair
    tm = load_jax_params(tlm.TransformerEncoder(tlm.LMConfig(**dict(TINY, dropout=0.5))),
                         params)
    ids, mask = (torch.from_numpy(a) for a in _batch(1))
    a = tm.train()(ids.long(), mask)
    b = tm.eval()(ids.long(), mask)
    assert torch.equal(a, b)


def test_parameter_tree_round_trip(pair):
    """JAX tree → port → JAX tree bit-exact (LayerNorm's scale ↔ weight among the
    rules), and the port's init is BERT's: weights N(0, 0.02), LayerNorm ones."""
    _, params, tm = pair
    back = state_dict_to_jax(tm)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(params), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    fresh = init_random(tlm.TransformerEncoder(tlm.LMConfig(**TINY)), 3)
    w = fresh.layer_0.ff_in.weight
    assert abs(float(w.std()) - 0.02) < 0.003
    assert float(fresh.layer_1.attn.query.bias.abs().max()) == 0
    assert torch.equal(fresh.emb_ln.weight, torch.ones(TINY["hidden_size"]))


def test_lm_config_reads_config_json(tmp_path):
    cfg = {"vocab_size": 60, "hidden_size": 32, "num_hidden_layers": 2,
           "num_attention_heads": 4, "intermediate_size": 64,
           "max_position_embeddings": 64, "hidden_dropout_prob": 0.25}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    got = tlm.LMConfig.from_local_dir(str(tmp_path))
    assert got == tlm.LMConfig(**dict(TINY, dropout=0.25))
    assert got.to_dict() == jlm.LMConfig.from_local_dir(str(tmp_path)).to_dict()
    assert tlm.load_local_lm(str(tmp_path)) == (got, None)


def _bert_dir(tmp_path):
    transformers = pytest.importorskip("transformers")
    tc = transformers.BertConfig(
        vocab_size=60, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    bert = transformers.BertModel(tc).eval()
    tc.save_pretrained(str(tmp_path))
    return bert


def test_load_local_lm_matches_bert_model(tmp_path):
    """`pytorch_model.bin` with a 'bert.' prefix and the pooler: the port's encoder
    against transformers' BertModel, and against the JAX package's importer."""
    bert = _bert_dir(tmp_path)
    torch.save({"bert." + k: v for k, v in bert.state_dict().items()},
               tmp_path / "pytorch_model.bin")
    cfg, sd = tlm.load_local_lm(str(tmp_path))
    enc = tlm.TransformerEncoder(cfg)
    enc.load_state_dict(sd, strict=True)
    ids, mask = _batch()
    ids_t = torch.from_numpy(ids).long()
    with torch.no_grad():
        want = bert(input_ids=ids_t, attention_mask=torch.from_numpy(mask).long()
                    ).last_hidden_state.numpy()
        got = enc.eval()(ids_t, torch.from_numpy(mask)).numpy()
    assert_close("load_local_lm vs BertModel (unmasked positions)", got[mask], want[mask],
                 3e-5)
    jcfg, jparams = jlm.load_local_lm(str(tmp_path))
    assert jcfg.to_dict() == cfg.to_dict()
    for name, v in load_jax_params(tlm.TransformerEncoder(cfg), jparams).state_dict().items():
        assert torch.equal(v, sd[name]), name


def test_safetensors_reader_matches_the_package(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float16),
              "c": rng.integers(-9, 9, (2, 2)).astype(np.int64),
              "d": np.zeros((0, 4), np.float32)}
    path = str(tmp_path / "x.safetensors")
    st.save_file(arrays, path, metadata={"format": "pt"})
    got, want = tlm.read_safetensors(path), st.load_file(path)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    # BF16 (which numpy lacks) comes back as the fp32 of the same values
    bf = torch.randn(4, 3).to(torch.bfloat16)
    header = json.dumps({"w": {"dtype": "BF16", "shape": [4, 3], "data_offsets": [0, 24]}})
    (tmp_path / "bf.safetensors").write_bytes(
        len(header).to_bytes(8, "little") + header.encode()
        + bf.view(torch.int16).numpy().tobytes())
    np.testing.assert_array_equal(tlm.read_safetensors(str(tmp_path / "bf.safetensors"))["w"],
                                  bf.float().numpy())


def test_load_local_lm_reads_safetensors(tmp_path):
    """`model.safetensors` (no `.bin`): the same weights as from the state dict."""
    st = pytest.importorskip("safetensors.numpy")
    bert = _bert_dir(tmp_path)
    st.save_file({k: v.numpy() for k, v in bert.state_dict().items()},
                 str(tmp_path / "model.safetensors"))
    cfg, sd = tlm.load_local_lm(str(tmp_path))
    want = tlm.load_bert_state_dict(bert.state_dict(), cfg)
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in sd)


@pytest.mark.slow
def test_bert_base_encoder_matches_jax():
    """BERT-base width (hidden 768, 12 layers, 12 heads, intermediate 3072), 64 tokens,
    a padded row."""
    cfg = dict(vocab_size=512, dropout=0.0)
    jm = jlm.TransformerEncoder(jlm.LMConfig(**cfg))
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 512, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), bool)
    mask[1, 40:] = False
    params = random_params(jm, jnp.asarray(ids), jnp.asarray(mask), seed=1)
    tm = load_jax_params(tlm.TransformerEncoder(tlm.LMConfig(**cfg)), params).eval()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert_close("lm encoder BERT-base width", got, want, 1e-4)
