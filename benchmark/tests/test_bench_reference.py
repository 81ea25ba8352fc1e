"""The reference against the program at small sizes on the CPU, in fp32 (oneDNN off,
whose fp32 conv backward is inexact): the generator, the discriminators and the GAN
mel, BERT's encoder, free synthesis, one GAN step, and the batches of the two
collates."""

import numpy as np
import pytest
import torch

from benchmark.runners.common import build
from benchmark.harness import Bench
from benchmark.reference import cubegan as ref
from benchmark.reference.collate import collate
from benchmark.reference.synthesis import judge
from benchmark.reference.training import compare, follow
from benchmark.tests.tiny import REPO, tiny_cell

BENCH = Bench(REPO)
C = BENCH.config("cubegan-v1")
TOL = 2e-5  # fp32 against fp32 in another order


@pytest.fixture(autouse=True)
def _fp32():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def small_bert_config():
    c = BENCH.config("cubegan-v1-bert-base")
    c["lm"].update(vocab_size=300, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=64, max_position_embeddings=128)
    return c


def test_generator_and_discriminators_and_mel():
    model, _, W = build(C, 21, "cpu", train=True)
    cond = torch.randn(2, 6, 80)
    with torch.no_grad():
        want = ref.generator(W, C, cond)
        got = model.gen(cond)
        assert (got - want).abs().max() < TOL
        y, y_hat = torch.randn(2, 1440).tanh(), want
        U = {n: v.clone() for n, v in W.items() if n.endswith(".u")}
        for mine, theirs in ((model.mpd(y, y_hat), ref.mpd(W, C, y, y_hat)),
                             (model.msd(y, y_hat, update_stats=True),
                              ref.msd(W, C, U, y, y_hat, update=True))):
            for a, b in zip(mine, theirs):
                flat_a = [t for x in a for t in (x if isinstance(x, list) else [x])]
                flat_b = [t for x in b for t in (x if isinstance(x, list) else [x])]
                assert all((p - q).abs().max() < TOL * max(1.0, float(q.abs().max()))
                           for p, q in zip(flat_a, flat_b))
        assert all(torch.allclose(model.state_dict()[n], U[n], atol=1e-6) for n in U)
        consts = ref.mel_constants(C, "cpu")
        assert (model.mel(y) - ref.gan_mel(consts, C, y)).abs().max() < 1e-4


def test_encoder():
    c = small_bert_config()
    model, _, W = build(c, 22, "cpu", train=False)
    ids = torch.randint(1, 300, (2, 40))
    mask = torch.ones(2, 40, dtype=torch.bool)
    mask[1, 30:] = False
    with torch.no_grad():
        assert (model.hf(ids, mask) - ref.bert(W, c, ids, mask)).abs().max() < TOL


def test_free_synthesis_in_fp32():
    c = dict(C, serving=dict(C["serving"], storage_dtype="float32", fused_tail=False))
    model, _, W = build(c, 23, "cpu", train=False)
    model.eval()
    out = {}
    for name in ("dur_output", "pitch_output", "cond_output"):
        getattr(model.lang, name).register_forward_hook(
            lambda m, a, o, name=name: out.__setitem__(name, o))
    X = {"x_char": torch.tensor([[5, 9, 3, 7, 0], [2, 4, 6, 1, 8]]),
         "x_speaker": torch.tensor([[1], [3]])}
    audio, aux = model.infer(X, max_frames=20)
    got = dict(aux, dur_logits=out["dur_output"], pitch_logits=out["pitch_output"],
               cond=out["cond_output"], audio=audio)
    with torch.no_grad():
        n = judge(W, c, X, got, 20)
    assert n["f2p_diff"] == 0 and n["audio_err"] < 1e-4
    assert max(n["dur_err"], n["vuv_err"], n["pitch_err"], n["cond_err"]) < 1e-5


def test_one_gan_step():
    from ttscube_tpu_torch.models.cubegan import batch_to_torch, create_train_state, train_step

    cell = tiny_cell("bert-train-b16")  # its traffic, read with cubegan-v1 (no LM)
    tr = BENCH.traffic("gan_train").Traffic(cell["params"], C, 24)
    model, _, W = build(C, 24, "cpu", train=True)
    state = create_train_state(model, seed=24)
    arrays = collate(tr.batch(0), tr.phones(), tr.speakers(), C["collate"], 240, False)
    X = {k: torch.from_numpy(v) for k, v in arrays.items()}
    starts = torch.from_numpy(tr.starts(0, tr.lengths[0]))
    _, met = train_step(state, batch_to_torch(arrays, "cpu"), starts=starts)
    names = {id(p): n for n, p in model.named_parameters()}
    from benchmark.runners.gan_train import grad_norms_from_moments

    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    got = {"losses": [{k: float(v) for k, v in met.items()}],
           "grad_norms": grad_norms_from_moments(state.optimizers, names),
           "change_norms": {n: float((p.detach() - W[n]).norm())
                            for n, p in model.named_parameters() if p.requires_grad}}
    want = follow(W, C, trainable, [X], [starts])
    n = compare(got, want)
    assert n["loss_err"] < 1e-4 and n["grad_err"] < 1e-4 and n["change_err"] < 1e-3


@pytest.mark.parametrize("config_name", ["cubegan-v1", "cubegan-v1-bert-base"])
def test_the_two_collates_agree(config_name):
    """The training traffic's batches, with and without LM conditioning."""
    from ttscube_tpu_torch.data.collate import CubeganCollate
    from ttscube_tpu_torch.data.encodings import CubeganEncodings

    cell = BENCH.cell("bert-train-b16")
    c = BENCH.config(config_name)
    tr = BENCH.traffic("gan_train").Traffic(cell["params"], c, 25)
    enc = CubeganEncodings()
    enc.phon2int = {p: i for i, p in enumerate(tr.phones())}
    enc.speaker2int = {s: i for i, s in enumerate(tr.speakers())}
    hf = c["languasito"]["cond_type"] == "hf"
    items = tr.batch(0)
    mine = collate(items, tr.phones(), tr.speakers(), c["collate"], c["hop_size"], hf)
    k = c["collate"]
    theirs = CubeganCollate(enc, bucket_phones=k["bucket_phones"], bucket_frames=k["bucket_frames"],
                            hop=c["hop_size"], min_frames=k["min_frames"], hf_conditioning=hf,
                            bucket_tokens=k["bucket_tokens"])(items)
    for key, v in mine.items():
        assert np.array_equal(v, theirs[key]), key
    if hf:
        assert mine["x_tok_ids"].shape[1] == c["lm"]["max_position_embeddings"]
