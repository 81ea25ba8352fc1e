"""LM conditioning in the port against the JAX package on the CPU: Languasito2 with
`cond_type` "fasttext" and "hf", `Cubegan.lm_condition`, the HF Cubegan's GAN train step
(the encoder in the `b` partition), a `.opt.last` with an `hf` subtree moving between the
packages both ways, the word vectors' OOV rows, and the pre-tokenizing dataset.

Weights are seeded random (tests/torch_parity.py), the encoder tiny (hidden 32, 2
layers, 4 heads). Limits, as tests/test_composed_parity.py and the phonemizer's step
tests hold them: duration logits 2e-4, pitch and VUV 1e-5, the conditioning and
`x_words` 2e-5; a train step's losses 2e-4 relative, its grads within GRAD_TOL (5e-6) of the largest grad of the
module that holds them, and the parameters after it at most 0.1 % beyond 0.01·lr and
none beyond 2·lr, the `b` partition in units of its own lr (1e-6)."""

import copy

import numpy as np
import pytest
import torch

import jax
import optax

from ttscube_tpu.models import cubegan as jcg
from ttscube_tpu.models import languasito as jla
from ttscube_tpu.utils import checkpoint as jckpt
from ttscube_tpu_torch.convert import jax_to_state_dict, load_jax_params
from ttscube_tpu_torch.models import cubegan as tcg
from ttscube_tpu_torch.models import languasito as tla
from ttscube_tpu_torch.utils import checkpoint as ckpt
from tests.torch_parity import (GRAD_TOL, LANG, SHARE, STEP_THREADS,  # noqa: F401
                                TINY_HIFI, TRAIN_LANG, assert_close, exact_cpu_convs, grad_error,
                                jax_crop_starts, one_cpu_thread, param_error,
                                random_params, t, text_batch, torch_threads,
                                toy_train_batch, train_pair)

# PyTorch on one thread: beside the tier's other workers its spinning pool threads slow
# these tests tenfold (tests/torch_parity.py `one_cpu_thread`)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

LM = dict(vocab_size=40, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
          max_position=64, dropout=0.0)
HF_LANG = dict(TRAIN_LANG, cond_type="hf", lm_dim=LM["hidden_size"])
FRAMES = 96
B_LR = 1e-6  # the b partition's Adam
BETA1 = {"d": 0.8, "g": 0.8, "t": 0.8, "b": 0.9}  # AdamW (g/d/t) and Adam (b)


def _words(rng, x_char, W: int):
    """x_phon2word: each real phone's word, non-decreasing over 0..W-1; 0 on padding."""
    p2w = np.zeros(x_char.shape, np.int32)
    for b, row in enumerate(x_char):
        n = int((row != 0).sum())
        p2w[b, :n] = np.sort(rng.integers(0, W, n))
    return p2w


# -- Languasito2 --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[("fasttext", None, 300), ("hf", 32, 32)],
                ids=["fasttext", "hf"])
def cond_pair(request):
    cond_type, lm_dim, dim = request.param
    cfg = dict(LANG, cond_type=cond_type, lm_dim=lm_dim)
    jm = jla.Languasito2(jla.LanguasitoConfig(**cfg))
    rng = np.random.default_rng(7)
    X = text_batch()
    X.update(x_words=rng.standard_normal((2, 6, dim)).astype(np.float32),
             x_phon2word=_words(rng, X["x_char"], 6))
    init = dict(X, y_frame2phone=np.zeros((2, FRAMES), np.int32),
                y_pitch=np.zeros((2, FRAMES), np.float32))
    params = random_params(jm, init, seed=3)
    tm = load_jax_params(tla.Languasito2(tla.LanguasitoConfig(**cfg)), params).eval()
    assert tm.config.lm_input_dim == dim == jm.config.lm_input_dim
    return cond_type, jm, params, tm, X


def _torch_inputs(X):
    return {k: t(v).float() if v.dtype == np.float32 else t(v).long() for k, v in X.items()}


def test_conditioned_languasito_forward_matches_jax(cond_pair):
    cond_type, jm, params, tm, X = cond_pair
    rng = np.random.default_rng(2)
    f2p = np.sort(rng.integers(0, 15, (2, FRAMES)), axis=1).astype(np.int32)
    pitch = rng.uniform(0, 300, (2, FRAMES)).astype(np.float32)
    dur, p, vuv, cond = jm.apply({"params": params}, dict(X, y_frame2phone=f2p,
                                                          y_pitch=pitch))
    Xt = _torch_inputs(X)
    with torch.no_grad():
        tdur, tp, tvuv = tm.text_forward(Xt, t(f2p).long())
        tcond = tm.cond_forward(Xt, t(f2p).long(), t(pitch))
    assert_close(f"Languasito2 {cond_type} dur logits", tdur, dur, 2e-4)
    assert_close(f"Languasito2 {cond_type} pitch", tp, p, 1e-5)
    assert_close(f"Languasito2 {cond_type} vuv", tvuv, vuv, 1e-5)
    assert_close(f"Languasito2 {cond_type} cond (teacher-forced)", tcond, cond, 2e-5)


def test_conditioned_languasito_infer_matches_jax(cond_pair):
    cond_type, jm, params, tm, X = cond_pair
    cond, aux = jm.apply({"params": params}, X, FRAMES, method=jla.Languasito2.infer)
    with torch.no_grad():
        tcond, taux = tm.infer(_torch_inputs(X), FRAMES)
        tdur = tm.durations(_torch_inputs(X))
    for k in ("durations", "frame2phone", "frame_mask", "vuv"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(aux[k]))
    np.testing.assert_array_equal(tdur.numpy(), np.asarray(aux["durations"]))
    assert_close(f"Languasito2.infer {cond_type} pitch / max_pitch",
                 taux["pitch"] / LANG["max_pitch"], np.asarray(aux["pitch"]) / LANG["max_pitch"],
                 1e-5)
    assert_close(f"Languasito2.infer {cond_type} cond", tcond, cond, 2e-5)
    assert int(taux["durations"].sum()) > 0


# -- Cubegan: lm_condition and the train step -------------------------------------------------


def hf_batch(seed: int) -> dict:
    """tests/torch_parity.py's toy batch with HF inputs: 6 words, a 12-token window (the
    second row padded after 8 tokens) and a word→token map whose 0s mark missing words."""
    b = toy_train_batch(seed=seed)
    rng = np.random.default_rng(seed + 100)
    ids = rng.integers(1, LM["vocab_size"], (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), bool)
    mask[1, 8:], ids[1, 8:] = False, 0
    return dict(b, x_phon2word=_words(rng, b["x_char"], 6), x_tok_ids=ids, x_tok_mask=mask,
                x_word2tok=np.array([[1, 2, 4, 6, 9, 11], [1, 3, 5, 7, 0, 0]], np.int32))


def test_lm_condition_matches_jax_and_zero_rows():
    """`x_words` from the encoder, gathered per word: against JAX's `lm_condition`, and a
    word whose `x_word2tok` is 0 gets a zero row."""
    batch = hf_batch(seed=0)
    jm, jstate, tm = train_pair(TINY_HIFI, batch, seed=0, lang=HF_LANG, lm=LM)
    want = np.asarray(jm.lm_condition(jstate.params, batch)["x_words"])
    with torch.no_grad():
        got = tcg.Cubegan.lm_condition(tm, tcg.batch_to_torch(batch, "cpu"))["x_words"]
    assert_close("Cubegan.lm_condition x_words", got, want, 2e-5)
    missing = batch["x_word2tok"] == 0
    assert missing.any() and float(got[torch.from_numpy(missing)].abs().max()) == 0.0
    assert float(got[torch.from_numpy(~missing)].abs().min()) > 0.0


def _jax_grads(opt2, opt1=None) -> dict:
    """The grads JAX's step applied, read off its first moments: mu2 = b1·mu1 + (1 −
    b1)·g, mu1 = 0 before the first step; every partition, `b` (Adam, b1 0.9) too."""
    out = {}
    for tx, parts in (("d", "d"), ("gtb", "gtb")):
        for part in parts:
            is_leaf = lambda x: isinstance(x, optax.MaskedNode)
            b = opt2[tx].inner_states[part].inner_state[0].mu
            a = None if opt1 is None else jax.tree_util.tree_leaves(
                opt1[tx].inner_states[part].inner_state[0].mu, is_leaf=is_leaf)
            for i, (path, y) in enumerate(
                    jax.tree_util.tree_flatten_with_path(b, is_leaf=is_leaf)[0]):
                if isinstance(y, optax.MaskedNode):
                    continue
                x = 0.0 if a is None else np.asarray(a[i], np.float64)
                node = out
                for key in path[:-1]:
                    node = node.setdefault(key.key, {})
                node[path[-1].key] = ((np.asarray(y, np.float64) - BETA1[part] * x)
                                      / (1 - BETA1[part])).astype(np.float32)
    return out


def _compare_steps(what, model, jnew, jmet, met, jopt_before=None):
    """The port's step (its model after it, and its metrics) against JAX's."""
    for k, v in jmet.items():
        want, got = float(v), met[k].item()
        rel = abs(got - want) / abs(want)
        print(f"\nparity {what} {k}: rel_diff={rel:.3e} tol=2e-04")
        assert rel <= 2e-4, (k, got, want)
    want_g = jax_to_state_dict(model, _jax_grads(jnew.opt_state, jopt_before))
    got_g = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters() if p.requires_grad}
    err = grad_error(got_g, {n: want_g[n] for n in got_g})
    hf_err = grad_error({n: g for n, g in got_g.items() if n.startswith("hf.")},
                        {n: want_g[n] for n in got_g if n.startswith("hf.")})
    want_p = jax_to_state_dict(model, jax.tree_util.tree_map(np.asarray, jnew.params))
    params = dict(model.named_parameters())
    gdt = [n for n in got_g if not n.startswith("hf.")]
    worst, share, within = param_error({n: params[n].detach() for n in gdt},
                                       {n: want_p[n] for n in gdt}, model.config.lr)
    b_worst, b_share, b_within, b_skipped = _b_error(
        {n: params[n].detach() for n in got_g if n.startswith("hf.")}, want_p)
    print(f"\nparity {what} grads: worst {err:.3e} of a module's largest (the encoder's "
          f"{hf_err:.3e}) tol={GRAD_TOL:.0e}; params: g/d/t max {worst:.3f} lr, "
          f"{share:.2e} beyond 0.01 lr; b max {b_worst:.3f} lr (1e-6), {b_share:.2e} beyond "
          f"0.01 lr (the {b_skipped} elements of the key biases, whose exact grad is 0, "
          f"held to 2 lr only)")
    assert err <= GRAD_TOL
    assert max(float(g.abs().max()) for n, g in got_g.items() if n.startswith("hf.")) > 0
    assert within and share <= SHARE, (worst, share)
    assert b_within and b_share <= SHARE, (b_worst, b_share)


def _b_error(got: dict, want: dict) -> tuple:
    """The `b` partition's parameters after a step against the reference's, in units of
    its lr (1e-6): the largest difference, the share of elements beyond 0.01 lr, whether
    all are within 2 lr plus two fp32 spacings, and the number of elements of the
    attention's key biases left out of the share. A key bias's exact grad is zero (the
    softmax over keys does not move when every score of a query shifts by the same
    q·b), so each package steps it on the rounding noise of its own sums, which Adam's
    first step turns into ±lr: those are held to 2 lr only."""
    worst, far, total, within, skipped = 0.0, 0, 0, True, 0
    for n, g in got.items():
        w = want[n]
        d = (g - w).abs()
        spacing = torch.nextafter(w.abs(), torch.tensor(float("inf"))) - w.abs()
        within &= bool((d <= 2 * B_LR + 2 * spacing).all())
        worst = max(worst, float(d.max()) / B_LR)
        if n.endswith("attn.key.bias"):
            skipped += d.numel()
            continue
        far += int((d > 0.01 * B_LR).sum())
        total += d.numel()
    return worst, far / total, within, skipped


@pytest.fixture(scope="module")
def hf_steps():
    """A JAX and a port HF Cubegan on the same weights, JAX's jitted train step (one
    compile for every call below), the batch, the key, and the first step of each."""
    batch = hf_batch(seed=1)
    jm, jstate, tm = train_pair(TINY_HIFI, batch, seed=1, lang=HF_LANG, lm=LM)
    rng = jax.random.PRNGKey(1)
    step = jax.jit(lambda s, b, r: jcg.train_step(jm, s, b, r))
    # the first step on STEP_THREADS threads, as tests/test_torch_train.py takes its
    # steps: the generator's conv_post grad sums every audio sample of the batch, and
    # its distance from JAX's moves with the summation order (2.96e-6 of the module's
    # largest on 8 threads, 4.75e-6 on one, against 5e-6)
    with torch.backends.mkldnn.flags(enabled=False), torch_threads(STEP_THREADS):
        j1, jmet = step(jstate, batch, rng)
        state = tcg.create_train_state(copy.deepcopy(tm))
        _, met = tcg.train_step(state, tcg.batch_to_torch(batch, "cpu"),
                                starts=torch.from_numpy(_starts(batch, rng, 0)))
    return dict(batch=batch, jstate=jstate, tm=tm, rng=rng, step=step, j1=j1, jmet=jmet,
                t1=state, met=met)


def _starts(batch, rng, step):
    return jax_crop_starts(batch["n_frames"], min(jcg.TRAIN_FRAMES, 60),
                           jax.random.fold_in(rng, step))


@pytest.mark.usefixtures("exact_cpu_convs")
def test_hf_train_step_matches_jax(hf_steps):
    s = hf_steps
    assert s["t1"].step == 1 and set(s["t1"].optimizers) == {"g", "d", "t", "b"}
    labels = tcg.partition_labels(s["t1"].model)
    assert {n for n, part in labels.items() if part == "b"} == {
        n for n in labels if n.startswith("hf.")}
    _compare_steps("hf train_step", s["t1"].model, s["j1"], s["jmet"], s["met"])
    moved = max(float((p.detach() - s["tm"].state_dict()[n]).abs().max())
                for n, p in s["t1"].model.named_parameters() if n.startswith("hf."))
    print(f"\nparity hf train_step: the encoder moved by at most {moved:.3e} (lr 1e-6)")
    assert 0 < moved < 1e-4


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.usefixtures("exact_cpu_convs")
def test_opt_last_with_hf_moves_both_ways(hf_steps, direction, tmp_path):
    """JAX → port: JAX's `.opt.last` after its first step, resumed by the port (from
    other weights), and the port's next step against JAX's. Port → JAX: the port's file
    after its first step, resumed by JAX, and JAX's next step against the port's."""
    s = hf_steps
    batch, path = s["batch"], str(tmp_path / "state.opt.last")
    starts = torch.from_numpy(_starts(batch, s["rng"], 1))
    with torch.backends.mkldnn.flags(enabled=False):
        if direction == "jax_to_port":
            jckpt.save_train_state(path, s["j1"])
            fresh = tcg.create_train_state(copy.deepcopy(s["tm"]))
            for p in fresh.model.parameters():
                p.data.add_(0.5)  # other weights: the file must replace them
            state = ckpt.load_train_state(path, fresh)
            before = s["j1"]
        else:
            state = copy.deepcopy(s["t1"])
            ckpt.save_train_state(path, state)
            before = jckpt.load_train_state(path, s["jstate"])
            assert int(before.step) == 1 and np.array_equal(
                np.asarray(before.params["hf"]["emb_ln"]["scale"]),
                s["t1"].model.hf.emb_ln.weight.detach().numpy())
        assert state.step == 1
        j2, jmet = s["step"](before, batch, s["rng"])
        _, met = tcg.train_step(state, tcg.batch_to_torch(batch, "cpu"), starts=starts)
    assert state.step == 2
    _compare_steps(f".opt.last {direction} next step", state.model, j2, jmet, met,
                   before.opt_state)


# -- host side ----------------------------------------------------------------------------


def test_word_vectors_match_jax_bit_equal(tmp_path):
    """The port's copy of utils/wordvec.py: the .vec table, the OOV rows (crc32 trigram
    hash over the default_rng(0) table), the npz round trip and the embedder spec."""
    from ttscube_tpu.utils import wordvec as jwv
    from ttscube_tpu_torch.utils import wordvec as twv

    rng = np.random.default_rng(0)
    lines = ["4 300"] + [w + " " + " ".join(f"{v:.5f}" for v in rng.standard_normal(300))
                         for w in ("hello", "world", "the", "ka")]
    vec = tmp_path / "t.vec"
    vec.write_text("\n".join(lines) + "\n")
    words = ["hello", "HELLO", "zxqy", "ka", "", "ünïcode", "selami", "the."]
    a, b = jwv.WordVectors.load_vec(str(vec)), twv.WordVectors.load_vec(str(vec))
    assert a.vocab == b.vocab and np.array_equal(a.table, b.table)
    assert np.array_equal(a._oov, b._oov) and twv.N_OOV_BUCKETS == jwv.N_OOV_BUCKETS
    assert np.array_equal(b(words), a(words)) and np.abs(b(["zxqy"])).max() > 0
    b.save_npz(str(tmp_path / "t.npz"))
    c = jwv.WordVectors.load_npz(str(tmp_path / "t.npz"))
    assert np.array_equal(c(words), a(words))
    assert twv.make_word_embedder(None) is None and twv.make_word_embedder("hf:x") is None
    assert np.array_equal(twv.make_word_embedder(f"fasttext:{tmp_path / 't.npz'}")(words),
                          a(words))
    with pytest.raises(ValueError, match="unknown LM conditioning spec"):
        twv.make_word_embedder("bogus:x")


def test_hf_dataset_and_collate_match_jax(tmp_path):
    """CubeganDataset(hf_tokenizer=...) and CubeganCollate(hf_conditioning=True) of the
    port against the JAX ones on a corpus and the port's demo LM directory."""
    pytest.importorskip("transformers")
    from tests.test_data import make_corpus
    from ttscube_tpu.data.collate import CubeganCollate as JCollate
    from ttscube_tpu.data.datasets import CubeganDataset as JDataset
    from ttscube_tpu.data.encodings import CubeganEncodings as JEnc
    from ttscube_tpu.utils.hf import HFTokenizer as JTok
    from ttscube_tpu_torch.data.collate import CubeganCollate
    from ttscube_tpu_torch.data.datasets import CubeganDataset
    from ttscube_tpu_torch.data.encodings import CubeganEncodings
    from ttscube_tpu_torch.scripts import make_demo_lm
    from ttscube_tpu_torch.utils.hf import HFTokenizer

    make_corpus(tmp_path / "corpus", n=4)
    lm_dir = make_demo_lm.main(["--output", str(tmp_path / "lm")])
    jd = JDataset(str(tmp_path / "corpus"), hf_tokenizer=JTok(lm_dir))
    td = CubeganDataset(str(tmp_path / "corpus"), hf_tokenizer=HFTokenizer(lm_dir))
    assert len(td) == len(jd) == 4
    for i in range(len(jd)):
        assert td[i]["meta"] == jd[i]["meta"]
        assert "words_hf" in td[i]["meta"]
    enc, jenc = CubeganEncodings(), JEnc()
    enc.compute(td)
    jenc.compute(jd)
    kw = dict(min_frames=60, bucket_frames=60, bucket_phones=16, hf_conditioning=True,
              bucket_tokens=16, bucket_words=8)
    got = CubeganCollate(enc, **kw)([td[0], td[1]])
    want = JCollate(jenc, **kw)([jd[0], jd[1]])
    assert got.keys() == want.keys() and {"x_tok_ids", "x_tok_mask", "x_word2tok"} <= set(got)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
