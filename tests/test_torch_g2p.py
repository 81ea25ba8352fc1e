"""The port's word G2P (`ttscube_tpu_torch/models/g2p.py`, `scripts/g2p.py`) and the
decoder parts it shares with the M2M phonemizer (`ops/rnn.LSTMCell`,
`models/blocks.Attention`) on the CPU against the JAX package, and the G2P files and
CLIs, `import_corpus --g2p` among them.

Weights are the parity tests' seeded random weights (`random_params`), carried to the
port by `convert`. Limits: the cell and the attention 1e-6; teacher-forced logits 2e-5;
the free run's logits 1e-6 with its smallest top-1/top-2 margin at least 100 times that
(tests/test_torch_phonemizer_train.py says why), over the steps that decide the
transcription: each word's steps up to its first EOS (`greedy_decode` zeroes what
follows, `G2P.transcribe` stops there; the `done` mask and the decoded tokens are held
over every step). At random weights the decode runs on after EOS over logits within
1e-4 of a tie (3.6e-5 at step 26 here), which no caller reads. The Adam step's loss
2e-4 relative, its grads within GRAD_TOL of each module's largest of JAX's and of the
exact grads (the port's model in fp64), the parameters after it at most 0.1 % beyond
0.01·lr and none beyond 2·lr (tests/torch_parity.py).
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ttscube_tpu.models import blocks as jblocks
from ttscube_tpu.models import g2p as jg
from ttscube_tpu.ops import rnn as jrnn
from ttscube_tpu.utils import checkpoint as jckpt
from ttscube_tpu_torch.convert import jax_to_state_dict, load_jax_params, state_dict_to_jax
from ttscube_tpu_torch.models import blocks as tblocks
from ttscube_tpu_torch.models import g2p as tg
from ttscube_tpu_torch.ops import rnn as trnn
from ttscube_tpu_torch.train.states import SimpleState, apply_step, trainable
from tests.test_torch_importers import (_legacy_corpus, compare_trees, jax_script,
                                        without_device)
from tests.test_torch_phonemizer_train import (assert_steps, check_grads, port_grads,
                                               smallest_margin)
from tests.torch_parity import (GRAD_TOL, SHARE, SHARE_LR, assert_close,  # noqa: F401
                                exact_cpu_convs, grad_error, one_cpu_thread, param_error,
                                random_params)

pytestmark = pytest.mark.usefixtures("exact_cpu_convs", "one_cpu_thread")

TOL_PART = 1e-6
TOL_LOGITS = 2e-5
TOL_FREE = 1e-6
TOL_LOSS = 2e-4
LR = 1e-3  # the G2P trainer's Adam
SMALL = dict(num_input_tokens=12, num_output_tokens=9, embedding_size=8, encoder_size=16,
             decoder_size=16)


# -- the shared parts ----------------------------------------------------------------------


def test_lstm_cell_matches_jax():
    rng = np.random.default_rng(0)
    x, h, c = (rng.standard_normal((3, n)).astype(np.float32) for n in (5, 7, 7))
    jm = jrnn.LSTMCell(7)
    params = random_params(jm, (h, c), x, seed=0)
    (jh, jc), _ = jm.apply({"params": params}, (h, c), x)
    cell = load_jax_params(trnn.LSTMCell(5, 7), params)
    th, tc = cell(torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c)))
    assert_close("LSTMCell h", th, jh, TOL_PART)
    assert_close("LSTMCell c", tc, jc, TOL_PART)
    assert state_dict_to_jax(cell)["b"].shape == (28,) and float(cell.bias_hh.abs().max()) == 0
    zeros = trnn.LSTMCell.initial_state(3, 7)
    assert all(np.array_equal(z.numpy(), j) for z, j in zip(zeros, jrnn.LSTMCell.initial_state(3, 7)))


@pytest.mark.parametrize("mask", ["none", "one position", "a whole row"])
def test_attention_matches_jax(mask):
    """The conv-projected attention (k = 3 as in the M2M phonemizer) with no mask, a
    span of one position, and a row with no position left (a uniform softmax)."""
    rng = np.random.default_rng(1)
    hid, enc = rng.standard_normal((2, 6)).astype(np.float32), \
        rng.standard_normal((2, 9, 10)).astype(np.float32)
    m = None
    if mask != "none":
        m = np.zeros((2, 9), bool)
        m[0, 4] = True
        if mask == "one position":
            m[1, 8] = True
    jm = jblocks.Attention(att_proj_size=12, kernel_size=3)
    params = random_params(jm, hid, enc, m, seed=1)
    ja, jw = jm.apply({"params": params}, hid, enc, mask=m)
    tm = load_jax_params(tblocks.Attention(6, 10, att_proj_size=12, kernel_size=3), params)
    ta, tw = tm(torch.from_numpy(hid), torch.from_numpy(enc),
                None if m is None else torch.from_numpy(m))
    assert_close(f"Attention ({mask}) weights", ta, ja, TOL_PART)
    assert_close(f"Attention ({mask}) weighted", tw, jw, TOL_PART)
    if mask == "a whole row":
        assert np.allclose(ta[1].detach().numpy(), 1 / 9)


# -- Seq2Seq ---------------------------------------------------------------------------------


def s2s_pair(seed: int, x, y):
    jm = jg.Seq2Seq(jg.Seq2SeqConfig(**SMALL))
    params = random_params(jm, jnp.asarray(x), jnp.asarray(y), seed=seed)
    return load_jax_params(tg.Seq2Seq(tg.Seq2SeqConfig(**SMALL)), params), jm, params


def words(seed: int, B: int = 4):
    """Seeded (x, y): words of 3-7 tokens ending in EOS, padded to 8; phones likewise."""
    rng = np.random.default_rng(seed)
    x, y = np.zeros((B, 8), np.int64), np.zeros((B, 8), np.int64)
    for b in range(B):
        n, k = rng.integers(3, 8, 2)
        x[b, :n], x[b, n] = rng.integers(3, SMALL["num_input_tokens"], n), tg.EOS
        y[b, :k], y[b, k] = rng.integers(3, SMALL["num_output_tokens"], k), tg.EOS
    return x, y


def test_seq2seq_matches_jax():
    """Teacher-forced and free-running logits, greedy_decode and seq2seq_loss."""
    x, y = words(2)
    tm, jm, params = s2s_pair(2, x, y)
    jl, jdone = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
    tl, tdone = tm(torch.from_numpy(x), torch.from_numpy(y))
    assert_close("seq2seq teacher-forced logits", tl, jl, TOL_LOGITS)
    assert np.array_equal(tdone.numpy(), np.asarray(jdone))
    assert_close("seq2seq_loss", tg.seq2seq_loss(tl, torch.from_numpy(y)),
                 jg.seq2seq_loss(jl, y), 1e-6)

    T = jg.G2P.MAX_PHONES
    jl, jdone = jm.apply({"params": params}, jnp.asarray(x), max_steps=T)
    tl, tdone = tm(torch.from_numpy(x), max_steps=T)
    assert np.array_equal(tdone.numpy(), np.asarray(jdone))
    jdone = np.asarray(jdone)
    n = int(max(np.argmax(d) if d.any() else T - 1 for d in jdone)) + 1
    read = np.arange(n)[None, :] <= np.array([np.argmax(d) if d.any() else T for d in jdone])[:, None]
    jread = np.where(read[..., None], np.asarray(jl)[:, :n], 0.0)
    smallest_margin(f"seq2seq free run, steps 0-{n - 1} to each EOS",
                    [np.where(read[..., None], jread, np.arange(jl.shape[-1]) * 1e3)], TOL_FREE)
    assert_steps("seq2seq free run logits to each EOS", tl[:, :n] * torch.from_numpy(read[..., None]),
                 jread, TOL_FREE)
    assert np.array_equal(tg.greedy_decode(tl, tdone).numpy(),
                          np.asarray(jg.greedy_decode(jl, jdone)))
    assert tg.G2P.MAX_PHONES == jg.G2P.MAX_PHONES


class _HQuery(tg._S2SStep):
    """The control: the attention queried with the last layer's h in place of c."""

    def forward(self, states, last_emb, enc):
        _, weighted = self.att(states[-1][0], enc)
        h = torch.cat([weighted, last_emb], dim=-1)
        new_states = []
        for i in range(self.n_layers):
            st = getattr(self, f"dec_cell_{i}")(h, states[i])
            new_states.append(st)
            h = st[0]
        return new_states, self.output(h)


def test_adam_step_matches_optax():
    """One step of the G2P trainer (teacher-forced loss, torch Adam at 1e-3) against
    optax `adam(1e-3)` in a jitted step, as scripts/g2p.py takes it."""
    x, y = words(3)
    tm, jm, params = s2s_pair(3, x, y)
    tx = optax.adam(LR)

    def loss_fn(p):
        return jg.seq2seq_loss(jm.apply({"params": p}, x, y)[0], y)

    @jax.jit
    def step(p, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), loss, grads

    jnew, jloss, jgrads = step(params, tx.init(params))
    tx_, ty = torch.from_numpy(x), torch.from_numpy(y)
    loss_of = lambda m: tg.seq2seq_loss(m(tx_, ty)[0], ty)
    exact_model = copy.deepcopy(tm).double()
    loss_of(exact_model).backward()
    exact = port_grads(exact_model)

    state = SimpleState(tm, torch.optim.Adam(trainable(tm), lr=LR, betas=(0.9, 0.999), eps=1e-8))
    loss = loss_of(tm)
    apply_step(state, loss)
    print(f"\nparity g2p Adam step loss: relative {abs(float(loss) - float(jloss)) / float(jloss):.3e}")
    assert abs(float(loss) - float(jloss)) <= TOL_LOSS * float(jloss)
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    sd = jax_to_state_dict(tm, jax.device_get(jgrads))
    want_grads = {n: sd[n] for n in names}
    check_grads("g2p Adam step", port_grads(tm), want_grads, exact)
    after = jax_to_state_dict(tm, jax.device_get(jnew))
    worst, share, within = param_error({n: p.detach() for n, p in tm.named_parameters()
                                        if p.requires_grad}, {n: after[n] for n in names}, LR)
    print(f"  params after it max {worst:.3f} lr, {share:.2e} beyond {SHARE_LR} lr")
    assert within and share <= SHARE

    ctl = load_jax_params(tg.Seq2Seq(tg.Seq2SeqConfig(**SMALL)), params)
    ctl.step.__class__ = _HQuery
    loss_of(ctl).backward()
    e = grad_error(port_grads(ctl), want_grads)
    print(f"  control (query from h): {e:.3e} from JAX's grads")
    assert e > GRAD_TOL


# -- G2P: vocabularies, files, CLIs ------------------------------------------------------------


@pytest.fixture(scope="module")
def lexicon(tmp_path_factory):
    """tests/test_g2p_cli.py's fixture: ten words, each four times, phones = letters."""
    base = tmp_path_factory.mktemp("g2p")
    words_ = ["cat", "bat", "hat", "mat", "rat", "sat", "cab", "tab", "lab", "dab"]
    lines = [f"{w}\t{' '.join(ph.upper() for ph in w)}" for w in words_ * 4]
    (base / "train.tsv").write_text("\n".join(lines))
    (base / "dev.tsv").write_text("\n".join(lines[:10]))
    return base


def test_update_encodings_and_lexicon_match_jax(tmp_path):
    (tmp_path / "lex.tsv").write_text("aa\tA A\naa\tA A\nzq\tZ Q\nbad line\nAb\tA B\n")
    for cutoff in (1, 2):
        t, j = tg.G2P("cpu"), jg.G2P()
        t.update_encodings(tg.G2PDataset(str(tmp_path / "lex.tsv")), cutoff=cutoff)
        j.update_encodings(jg.G2PDataset(str(tmp_path / "lex.tsv")), cutoff=cutoff)
        assert (t.token2int, t.label2int, t.label_list) == (j.token2int, j.label2int, j.label_list)
        assert ("z" in t.token2int) == (cutoff == 1)
        t.load_lexicon(str(tmp_path / "lex.tsv"))
        j.load_lexicon(str(tmp_path / "lex.tsv"))
        assert t.lookup == j.lookup
        assert np.array_equal(t.encode_words(["ab", "zqz"]), j.encode_words(["ab", "zqz"]))
        assert np.array_equal(t.encode_labels([["A"], ["Z", "Q", "A"]]),
                              j.encode_labels([["A"], ["Z", "Q", "A"]]))


@pytest.fixture(scope="module")
def trained(lexicon, tmp_path_factory):
    """The port's CLI trained on the lexicon for 2 epochs: its store base."""
    from ttscube_tpu_torch.scripts import g2p as g2p_cli

    base = str(tmp_path_factory.mktemp("g2p_model") / "g2p")
    with torch.backends.mkldnn.flags(enabled=False):
        g2p_cli.main(["--train-file", str(lexicon / "train.tsv"), "--dev-file",
                      str(lexicon / "dev.tsv"), "--store", base, "--batch-size", "8",
                      "--max-epochs", "2", "--patience", "2", "--device", "cpu"])
    return base


def test_g2p_cli_train_evaluate_transcribe(trained, lexicon, tmp_path, capsys):
    """tests/test_g2p_cli.py on the port's CLI (with --device cpu): train writes the
    .encodings and .last; evaluate prints the word accuracy; transcribe writes a
    line per word. The files load in the JAX package bit-equal; the lexicon overrides."""
    from ttscube_tpu_torch.scripts import g2p as g2p_cli

    for ext in ("encodings", "last"):  # and .best once the dev accuracy rises above 0
        assert Path(f"{trained}.{ext}").stat().st_size > 0, ext
    g2p_cli.main(["--test-file", str(lexicon / "dev.tsv"), "--load", trained, "--device", "cpu"])
    assert "Word accuracy rate" in capsys.readouterr().out
    (tmp_path / "words.txt").write_text("cat\nbat\n")
    g2p_cli.main(["--transcribe-file", str(tmp_path / "words.txt"), "--output-file",
                  str(tmp_path / "trans.tsv"), "--model", trained, "--device", "cpu"])
    lines = (tmp_path / "trans.tsv").read_text().strip().split("\n")
    assert len(lines) == 2 and lines[0].startswith("cat\t")

    port = tg.G2P("cpu")
    port.load(trained)
    j = jg.G2P()
    j.load(trained)
    assert (j.token2int, j.label2int, j.label_list) == (port.token2int, port.label2int,
                                                        port.label_list)
    for n, v in jax_to_state_dict(port.model, jax.device_get(j.params)).items():
        assert torch.equal(port.model.state_dict()[n], v), n
    jckpt.save_params(str(tmp_path / "j.best"), j.params)
    port.save(str(tmp_path / "j"))
    back = tg.G2P("cpu")
    back.load(str(tmp_path / "j"))
    for n, v in port.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[n], v), n

    port.lookup["cat"] = ["K", "AE", "T"]
    tokens = port("Cat bat-")
    assert tokens[0].transcription == ["K", "AE", "T"] and tokens[1].transcription == [" "]
    assert tokens[3].transcription == ["_"] and isinstance(tokens[2].transcription, list)
    assert port.transcribe([]) == [] and port("...")[0].transcription == [""]


def test_import_corpus_with_g2p_matches_jax(trained, tmp_path):
    """`import_corpus --g2p` with the trained G2P writes the files the JAX importer
    writes with the same model (the .lab transcriptions from the G2P)."""
    from ttscube_tpu_torch.scripts import import_corpus

    src = tmp_path / "legacy"
    src.mkdir()
    _legacy_corpus(src)
    outs = {}
    for who in ("port", "jax"):
        out = tmp_path / who
        argv = ["--train-folder", str(src), "--prefix", "P", "--g2p", trained,
                "--train-output", str(out / "train"), "--dev-output", str(out / "dev")]
        if who == "port":
            import_corpus.main(argv + ["--device", "cpu"])
        else:
            jax_script("import_corpus").phase_1_prepare_corpus(
                without_device(import_corpus.parser().parse_args(argv)))
        outs[who] = out
    assert compare_trees(outs["port"], outs["jax"], src, legacy=True) == 2 * 4
    lab = (outs["port"] / "train" / "P_00001.lab").read_text()
    assert '"transcription": ["<START>", ' in lab and '" "' in lab


@pytest.mark.parametrize("cli", ["train_phonemizer", "g2p", "import_corpus"])
def test_clis_take_the_card_by_default(cli, lexicon):
    """Without --device each CLI asks for the card, and raises where there is none
    (no quiet run on the CPU)."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLIs would run on it")
    argv = {"train_phonemizer": ["--train-file", "none.train", "--dev-file", "none.dev"],
            "g2p": ["--train-file", str(lexicon / "train.tsv"), "--dev-file",
                    str(lexicon / "dev.tsv"), "--store", str(lexicon / "never")],
            "import_corpus": ["--train-folder", str(lexicon), "--g2p", str(lexicon / "g2p")]}
    mod = importlib.import_module(f"ttscube_tpu_torch.scripts.{cli}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv[cli])
