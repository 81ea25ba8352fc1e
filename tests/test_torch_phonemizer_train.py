"""The port's phonemizer family on the CPU against the JAX package: `PhonemizerM2M`
teacher-forced and free-running, the losses and PACC/SACC, the trainer's steps
(`ttscube_tpu_torch/train/states.py`), the host-side data path, the `.opt.last` /
`.pacc.best` / `.sacc.best` / `.encodings` files both ways, and the trainer CLI.

Weights are the parity tests' seeded random weights (`random_params`, signals kept at
their scale), carried to the port by `convert`. Limits, the port's own: logits 2e-5 (the cond tolerance of tests/test_composed_parity.py); losses
2e-4 relative; `loss`, `pacc`, `sacc` of a validation step 1e-6; a train step's grads
within GRAD_TOL (5e-6) of the largest grad of the module that holds them, and the
parameters after it at most 0.1 % beyond 0.01·lr and none beyond 2·lr
(tests/torch_parity.py). The port's grads are also held to the step's exact grads (the
port's model in fp64), and JAX's distance from those is printed: where a module's grads
are sums that mostly cancel (the M2M attention's, at weights that leave it little to
do), JAX's own fp32 grads sit up to 6.3e-6 of that module's largest from the exact ones
(PERF.md, PR 12), so a miss of 5e-6 against JAX says which side is off.

A free-running decode feeds its argmax back: two right implementations part where the
top two logits lie within their fp32 noise, so each free-running test prints the
smallest top-1/top-2 margin over the decode and fails, naming the step, where it is
below 100 × the logits tolerance. There the logits are held to TOL_FREE = 1e-6 (the
port's own limit for the cells and the attention; the two packages' free runs sit ~1e-7
apart), so the margin must be 1e-4: over the 256 argmaxes of a 4 x 32-step decode of
a small random model, margins of 2.5e-4-6.5e-4 occur (PERF.md, PR 12), which the 2e-5
logits limit would have had to refuse at 2e-3.
"""

import copy
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ttscube_tpu.data.collate import PhonemizerCollate as JaxCollate
from ttscube_tpu.data.datasets import PhonemizerDataset as JaxDataset
from ttscube_tpu.data.encodings import PhonemizerEncodings as JaxEncodings
from ttscube_tpu.models import phonemizer as jp
from ttscube_tpu.train import states as js
from ttscube_tpu.utils import checkpoint as jckpt
from ttscube_tpu_torch.convert import (init_random, jax_to_state_dict, load_jax_params,
                                       state_dict_to_jax)
from ttscube_tpu_torch.data.collate import PhonemizerCollate
from ttscube_tpu_torch.data.datasets import PhonemizerDataset
from ttscube_tpu_torch.data.encodings import PhonemizerEncodings
from ttscube_tpu_torch.data.importers import merge_alignment
from ttscube_tpu_torch.models import phonemizer as tp
from ttscube_tpu_torch.models.cubegan import batch_to_torch
from ttscube_tpu_torch.train import states as ts
from ttscube_tpu_torch.utils import checkpoint as ckpt
from tests.torch_parity import (GRAD_TOL, SHARE, SHARE_LR, assert_close,  # noqa: F401
                                exact_cpu_convs, grad_error, one_cpu_thread, param_error,
                                random_params)

pytestmark = pytest.mark.usefixtures("exact_cpu_convs", "one_cpu_thread")

SMALL = dict(conv_size=32, rnn_size=16)  # the encoder's widths here; 3 convs, 2 BiLSTMs
TOL_LOGITS = 2e-5
TOL_FREE = 1e-6   # the free runs' logits (see above)
TOL_LOSS = 2e-4   # relative
TOL_VAL = 1e-6
LR = 2e-4         # the trainer's default
WORDS = ["ama", "Emi", "ilo", "onu", "ukela", "sano", "ka", "no", "dime"]


def examples(n: int, seed: int, deletions: bool) -> list:
    """Phonemizer examples as `import_phonemizer_blizzard` writes them: a sentence of
    demo words, one phone per character ('_' for a non-letter, and with `deletions` now
    and then on a letter), merged by `merge_alignment` into hybrid, words, phon2word."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        text = " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), rng.integers(2, 6)))
        text += "."
        phon = [("_" if not ch.isalpha() or (deletions and rng.random() < 0.15)
                 else ch.upper()) for ch in text]
        hybrid, words, phon2word, _ = merge_alignment(text, phon, [50] * len(text))
        out.append({"orig_text": text, "phones": phon, "hybrid": hybrid, "words": words,
                    "phon2word": phon2word})
    return out


def config(encodings, **kw):
    return dict(num_graphemes=len(encodings.graphemes),
                num_phonemes=len(encodings.phonemes), **SMALL, **kw)


def port_model(kind: str, cfg: dict):
    return (tp.PhonemizerM2M if kind == "m2m" else tp.Phonemizer)(tp.PhonemizerConfig(**cfg))


def pair(kind: str, cfg: dict, batch: dict, seed: int):
    """(the port's model, the JAX module, their weights: seeded, as a JAX tree)."""
    jm = (jp.PhonemizerM2M if kind == "m2m" else jp.Phonemizer)(jp.PhonemizerConfig(**cfg))
    params = random_params(jm, jnp_batch(batch), seed=seed)
    return load_jax_params(port_model(kind, cfg), params), jm, params


def data(seed: int, n: int = 4, deletions: bool = True):
    """(encodings, a collated batch) of `n` seeded examples."""
    ex = examples(n, seed, deletions)
    enc = PhonemizerEncodings()
    enc.compute(ex)
    return enc, PhonemizerCollate(enc)(ex)


def step_case(kind: str):
    """(encodings, batch, config) of the step tests: the same shapes for every test of
    a kind, so that JAX's jitted step compiles once."""
    enc, b = data(seed=4, deletions=kind == "m2m")
    return enc, b, config(enc, max_word_skip=5)


def jnp_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def smallest_margin(what: str, logits: list, tol: float) -> float:
    """The smallest top-1/top-2 margin of the free run's argmaxes over `logits` (each
    (B, T, K)); fails naming the step where it is below 100 × tol."""
    worst, where = np.inf, None
    for i, lg in enumerate(logits):
        top = np.sort(np.asarray(lg, np.float64), axis=-1)[..., -2:]
        m = top[..., 1] - top[..., 0]
        idx = np.unravel_index(np.argmin(m), m.shape)
        if m[idx] < worst:
            worst, where = float(m[idx]), (i, int(idx[0]), int(idx[1]))
    print(f"\nparity {what}: smallest top-1/top-2 margin {worst:.3e} (head {where[0]}, "
          f"row {where[1]}, step {where[2]}); limit {100 * tol:.0e}")
    assert worst >= 100 * tol, (f"{what}: a near-tie at step {where[2]} (row {where[1]}, "
                                f"head {where[0]}): margin {worst:.3e}")
    return worst


def assert_steps(what: str, got, want, tol: float) -> None:
    """(B, T, K) logits of a decode held step by step: fails naming the first step
    beyond `tol` (the one to read: the later ones follow from it)."""
    d = np.abs(got.detach().double().numpy() - np.asarray(want, np.float64)).max(axis=(0, 2))
    print(f"\nparity {what}: max_abs_diff={d.max():.3e} over {len(d)} steps tol={tol:.1e}")
    bad = np.flatnonzero(d > tol)
    assert not len(bad), f"{what}: step {bad[0]} differs by {d[bad[0]]:.3e} > {tol:.1e}"


# -- the model ---------------------------------------------------------------------------


def test_m2m_teacher_forced_matches_jax():
    enc, b = data(seed=1)
    tm, jm, params = pair("m2m", config(enc, max_word_skip=5), b, seed=1)
    jl, jnw, jfin = jm.apply({"params": params}, jnp_batch(b))
    tl, tnw, tfin = tm(batch_to_torch(b, "cpu"))
    assert_close("m2m teacher-forced phon_logits", tl, jl, TOL_LOGITS)
    assert_close("m2m teacher-forced nw_logits", tnw, jnw, TOL_LOGITS)
    assert np.array_equal(tfin.numpy(), np.asarray(jfin))
    want = float(jp.m2m_loss(jl, jnw, b["y_phon"], b["y_new_word"]))
    got = float(tp.m2m_loss(tl, tnw, *(torch.from_numpy(b[k]).long()
                                       for k in ("y_phon", "y_new_word"))))
    print(f"\nparity m2m_loss: relative {abs(got - want) / abs(want):.3e} tol={TOL_LOSS:.0e}")
    assert abs(got - want) <= TOL_LOSS * abs(want)


def test_m2m_free_running_matches_jax():
    enc, b = data(seed=2)
    tm, jm, params = pair("m2m", config(enc, max_word_skip=5), b, seed=2)
    X = {k: v for k, v in b.items() if not k.startswith("y_")}
    T = b["y_phon"].shape[1]
    jl, jnw, jfin = jm.apply({"params": params}, jnp_batch(X), max_steps=T)
    tl, tnw, tfin = tm(batch_to_torch(X, "cpu"), max_steps=T)
    smallest_margin("m2m free run", [jl, jnw], TOL_FREE)
    for name, got, want in (("phon_logits", tl, jl), ("nw_logits", tnw, jnw)):
        assert_steps(f"m2m free run {name}", got, want, TOL_FREE)
    assert np.array_equal(tfin.numpy(), np.asarray(jfin))
    assert tfin.any() and not tfin.all()  # the decode advances through the words


def test_losses_and_accuracy_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 6)).astype(np.float32)
    y = rng.integers(0, 6, (3, 7)).astype(np.int32)
    y[:, -2:] = 0  # padding
    logits[0, 0, 0] = 9.0  # a pad prediction: not an error
    got = tp.phonemizer_loss(torch.from_numpy(logits), torch.from_numpy(y).long())
    assert_close("phonemizer_loss", got, jp.phonemizer_loss(logits, y), 1e-6)
    jacc, tacc = jp.phonemizer_accuracy(logits, y), tp.phonemizer_accuracy(
        torch.from_numpy(logits), torch.from_numpy(y).long())
    assert {k: int(v) for k, v in tacc.items()} == {k: int(v) for k, v in jacc.items()}


# -- the steps ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_step(kind: str, cfg: tuple):
    """JAX's jitted `phonemizer_train_step` beside the grads of its loss, one compile."""
    jm = (jp.PhonemizerM2M if kind == "m2m" else jp.Phonemizer)(jp.PhonemizerConfig(**dict(cfg)))

    def loss_fn(params, batch):
        if kind == "m2m":
            pl_, nw, _ = jm.apply({"params": params}, batch)
            return jp.m2m_loss(pl_, nw, batch["y_phon"], batch["y_new_word"])
        return jp.phonemizer_loss(jm.apply({"params": params}, batch), batch["y_phon"])

    @jax.jit
    def step(state, batch):
        grads = jax.grad(loss_fn)(state.params, batch)
        new, metrics = js.phonemizer_train_step(jm, state, batch, lr=LR)
        return new, metrics, grads

    return step


def jax_state(params):
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return js.SimpleState(params=params, opt_state=optax.adamw(LR, weight_decay=0.01).init(
        params), step=jnp.zeros((), jnp.int32))


def port_grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.requires_grad}


def trained(model, tree) -> tuple:
    """(the port's trained parameters, JAX's tree under the port's names)."""
    sd = jax_to_state_dict(model, jax.device_get(tree))
    return ({n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad},
            {n: sd[n] for n, p in model.named_parameters() if p.requires_grad})


def step_loss(model, tb, kind: str):
    if kind == "m2m":
        pl_, nw, _ = model(tb)
        return tp.m2m_loss(pl_, nw, tb["y_phon"], tb["y_new_word"])
    return tp.phonemizer_loss(model(tb), tb["y_phon"])


def exact_grads(model, tb, kind: str) -> dict:
    """The grads of the step's loss at `model`'s current weights, in fp64."""
    m = copy.deepcopy(model).double()
    m.zero_grad(set_to_none=True)
    step_loss(m, tb, kind).backward()
    return port_grads(m)


def check_grads(what: str, got: dict, jax_grads: dict, exact: dict) -> None:
    """The port's grads within GRAD_TOL (of the largest grad of each module) of JAX's
    and of the exact grads; JAX's distance from the exact grads is printed."""
    direct, port_err = grad_error(got, jax_grads), grad_error(got, exact)
    print(f"parity {what} grads, of each module's largest: port vs JAX {direct:.3e} "
          f"(tol {GRAD_TOL:.0e}); from the exact grads: port {port_err:.3e}, JAX "
          f"{grad_error(jax_grads, exact):.3e}")
    assert direct <= GRAD_TOL and port_err <= GRAD_TOL


def control_grads(model, tb, kind: str, what: str) -> dict:
    """The port's grads of a wrong loss: CE over every target (id 0 not ignored), or
    (M2M) the decoder advancing by adv in place of max(adv − 1, 0)."""
    model.zero_grad(set_to_none=True)
    if what == "no ignore id":
        ce = lambda lg, y: torch.nn.functional.cross_entropy(lg.flatten(0, 1), y.flatten())
        if kind == "m2m":
            pl_, nw, _ = model(tb)
            loss = ce(pl_, tb["y_phon"]) + ce(nw, tb["y_new_word"])
        else:
            loss = ce(model(tb), tb["y_phon"])
    else:  # y_new_word + 1 makes the model advance by y_new_word
        pl_, nw, _ = model(dict(tb, y_new_word=tb["y_new_word"] + 1))
        loss = tp.m2m_loss(pl_, nw, tb["y_phon"], tb["y_new_word"])
    loss.backward()
    return port_grads(model)


@pytest.mark.parametrize("kind", ["aligned", "m2m"])
def test_train_step_matches_jax(kind):
    enc, b, cfg = step_case(kind)
    tm, _, params = pair(kind, cfg, b, seed=4)
    tb = batch_to_torch(b, "cpu")
    jnew, jmet, jgrads = jax_step(kind, tuple(sorted(cfg.items())))(jax_state(params),
                                                                    jnp_batch(b))
    exact = exact_grads(tm, tb, kind)
    state = ts.create_phonemizer_state(tm, lr=LR)
    state, met = ts.phonemizer_train_step(state, tb)
    got, want = float(met["loss"]), float(jmet["loss"])
    print(f"\nparity phonemizer {kind} train step loss: relative "
          f"{abs(got - want) / abs(want):.3e} tol={TOL_LOSS:.0e}")
    assert abs(got - want) <= TOL_LOSS * abs(want) and state.step == 1

    want_grads = trained(tm, jgrads)[1]
    check_grads(f"phonemizer {kind} train step", port_grads(tm), want_grads, exact)
    worst, share, within = param_error(*trained(tm, jnew.params), LR)
    print(f"parity phonemizer {kind} train step: params after it max {worst:.3f} lr, "
          f"{share:.2e} beyond {SHARE_LR} lr (limit {SHARE})")
    assert within and share <= SHARE

    # the controls must fail the grad limit (weights as before the step)
    ctl = load_jax_params(port_model(kind, cfg), params)
    for what in ("no ignore id",) + (("advance by adv",) if kind == "m2m" else ()):
        e = grad_error(control_grads(ctl, tb, kind, what), want_grads)
        print(f"  control {what}: {e:.3e} from JAX's grads")
        assert e > GRAD_TOL, what


@pytest.mark.parametrize("kind", ["aligned", "m2m"])
def test_val_step_matches_jax(kind):
    """loss, PACC and SACC as JAX's `phonemizer_val_step`; for M2M the scores of the
    free-running decode, which a teacher-forced scoring does not give."""
    enc, b = data(seed=5, deletions=kind == "m2m")
    tm, jm, params = pair(kind, config(enc, max_word_skip=5), b, seed=5)
    jv = js.phonemizer_val_step(jm, js.SimpleState(params=params, opt_state=None,
                                                   step=jnp.zeros((), jnp.int32)),
                                jnp_batch(b))
    tv = ts.phonemizer_val_step(ts.create_phonemizer_state(tm), batch_to_torch(b, "cpu"))
    for k in ("loss", "pacc", "sacc"):
        assert_close(f"phonemizer {kind} val {k}", tv[k], jv[k], TOL_VAL)
    if kind == "m2m":
        X = {k: v for k, v in b.items() if not k.startswith("y_")}
        free = tm(batch_to_torch(X, "cpu"), max_steps=b["y_phon"].shape[1])
        smallest_margin("m2m val free run", [t.detach() for t in free[:2]], TOL_FREE)
        with torch.no_grad():
            forced = tm(batch_to_torch(b, "cpu"))[0]
        y = torch.from_numpy(b["y_phon"]).long()

        def pacc(logits):
            acc = tp.phonemizer_accuracy(logits, y)
            return float(1 - acc["perr"] / acc["phones"])

        assert float(tv["pacc"]) == pytest.approx(pacc(free[0]), abs=1e-6)
        assert not torch.equal(free[0].argmax(-1), forced.argmax(-1))
        if pacc(free[0]) != pacc(forced):
            assert float(tv["pacc"]) != pytest.approx(pacc(forced), abs=1e-6)


# -- the host-side data path ---------------------------------------------------------------


def test_encodings_dataset_and_collate_match_jax(tmp_path):
    """compute, the JSON dataset and the collate give JAX's ids and arrays; a hybrid
    symbol absent from `phones` (' ', '.') collates to 0, as in the JAX package."""
    ex = examples(6, seed=6, deletions=True)
    path = tmp_path / "ph.train"
    path.write_text(json.dumps(ex))
    tds, jds = PhonemizerDataset(str(path)), JaxDataset(str(path))
    assert len(tds) == len(jds) == 6 and tds[3] == jds[3]
    tenc, jenc = PhonemizerEncodings(), JaxEncodings()
    tenc.compute(tds)
    jenc.compute(jds)
    assert tenc.grapheme2int == jenc.grapheme2int and tenc.phon2int == jenc.phon2int
    tenc.save(str(tmp_path / "t.encodings"))
    jenc.save(str(tmp_path / "j.encodings"))
    assert (tmp_path / "t.encodings").read_bytes() == (tmp_path / "j.encodings").read_bytes()
    for bucket in (16, 8):
        got = PhonemizerCollate(tenc, bucket=bucket)([tds[i] for i in range(6)])
        want = JaxCollate(jenc, bucket=bucket)([jds[i] for i in range(6)])
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert " " in ex[0]["hybrid"] and " " not in tenc.phon2int
    assert not (got["y_phon"][0, :len(ex[0]["hybrid"])] == 0).all()
    assert (got["y_phon"][0][[i for i, h in enumerate(ex[0]["hybrid"]) if h == " "]] == 0).all()


# -- the files both ways -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["aligned", "m2m"])
def test_opt_last_resumes_across_packages(kind, tmp_path):
    """A state after one step, saved by either package's `save_train_state` (the loop's
    `.opt.last` writer), restored by the other: the next step from it (on the same
    batch; it reads the restored moments and count) agrees on both sides by the step's
    limits. `.pacc.best`-style parameter files (`save_params`) load both ways
    bit-equal."""
    _, b1, cfg = step_case(kind)
    step = jax_step(kind, tuple(sorted(cfg.items())))
    tm, _, params = pair(kind, cfg, b1, seed=7)
    ctor = functools.partial(port_model, kind, cfg)

    # JAX writes, the port resumes
    jst, _, _ = step(jax_state(params), jnp_batch(b1))
    jckpt.save_train_state(str(tmp_path / "j.opt.last"), jst)
    resumed = ckpt.load_train_state(str(tmp_path / "j.opt.last"),
                                    ts.create_phonemizer_state(init_random(ctor(), 99), LR))
    assert resumed.step == 1
    # and the port writes, JAX resumes
    st = ts.phonemizer_train_step(ts.create_phonemizer_state(tm, LR), batch_to_torch(b1, "cpu"))[0]
    ckpt.save_train_state(str(tmp_path / "t.opt.last"), st)
    jres = jckpt.load_train_state(str(tmp_path / "t.opt.last"), jst)
    assert int(jres.step) == 1

    tb = batch_to_torch(b1, "cpu")
    for what, port, jstate in (("JAX file, port step", resumed, jst),
                               ("port file, JAX step", st, jres)):
        jnext, jmet, jgrads = step(jstate, jnp_batch(b1))
        exact = exact_grads(port.model, tb, kind)
        port, met = ts.phonemizer_train_step(port, tb)
        got, want = float(met["loss"]), float(jmet["loss"])
        print(f"\nparity phonemizer {kind} resume ({what}): loss {abs(got - want) / abs(want):.3e}")
        check_grads(f"phonemizer {kind} resume ({what})", port_grads(port.model),
                    trained(port.model, jgrads)[1], exact)
        worst, share, within = param_error(*trained(port.model, jnext.params), LR)
        print(f"  params after it max {worst:.3f} lr, {share:.2e} beyond {SHARE_LR} lr")
        assert abs(got - want) <= TOL_LOSS * abs(want) and port.step == 2 == int(jnext.step)
        assert within and share <= SHARE

    jckpt.save_params(str(tmp_path / "j.pacc.best"), jst.params)
    ckpt.save_params(str(tmp_path / "t.sacc.best"), tm)
    params = state_dict_to_jax(tm)
    loaded = ckpt.load_params(str(tmp_path / "j.pacc.best"), ctor())
    for n, v in jax_to_state_dict(loaded, jax.device_get(jst.params)).items():
        assert torch.equal(loaded.state_dict()[n], v), n
    back = jckpt.load_params(str(tmp_path / "t.sacc.best"), jst.params)
    for a, c in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert np.array_equal(np.asarray(a), c)


# -- the CLI -------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def phonemizer_data(tmp_path_factory):
    """The port's demo corpus (8 sentences) imported by `import_phonemizer_blizzard`
    with a quarter of it for dev."""
    from ttscube_tpu_torch.scripts import import_phonemizer_blizzard, make_demo_corpus

    root = tmp_path_factory.mktemp("phon")
    make_demo_corpus.main(make_demo_corpus.parser().parse_args(
        ["--output", str(root / "corpus"), "--sentences", "8"]))
    import_phonemizer_blizzard.main(["--input-file", str(root / "corpus" / "align.txt"),
                                     "--dev-ratio", "0.25", "--output-base",
                                     str(root / "phonemizer")])
    return root


@pytest.mark.parametrize("kind", ["aligned", "m2m"])
def test_trainer_cli_writes_the_jax_files_and_resumes(kind, phonemizer_data, tmp_path,
                                                      monkeypatch, capsys):
    """`train_phonemizer.main` for 3 steps at batch 2 (one epoch of the 6 train
    sentences) writes the files the JAX CLI writes, each loadable by the JAX package;
    `--resume --max-epochs 0` restores the step and the parameters bit-equal, and
    `--resume` goes on from there; `export_model` takes the aligned `.sacc.best` and
    refuses the M2M one."""
    from ttscube_tpu_torch.scripts import train_phonemizer

    monkeypatch.setattr(tp, "PhonemizerConfig", functools.partial(tp.PhonemizerConfig, **SMALL))
    base = str(tmp_path / "ph")
    argv = ["--train-file", str(phonemizer_data / "phonemizer.train"), "--dev-file",
            str(phonemizer_data / "phonemizer.dev"), "--output-base", base,
            "--model-type", kind, "--batch-size", "2", "--device", "cpu"]
    state = train_phonemizer.main(argv + ["--max-steps", "3"])
    assert state.step == 3 and isinstance(state.model, tp.PhonemizerM2M) == (kind == "m2m")
    assert "PACC=" in capsys.readouterr().out
    for ext in ("encodings", "best", "last", "opt.last", "pacc.best", "sacc.best"):
        assert (tmp_path / f"ph.{ext}").stat().st_size > 0, ext
    jenc = JaxEncodings(base + ".encodings")
    jm = (jp.PhonemizerM2M if kind == "m2m" else jp.Phonemizer)(jp.PhonemizerConfig(
        num_graphemes=len(jenc.graphemes), num_phonemes=len(jenc.phonemes), **SMALL))
    template = state_dict_to_jax(state.model)
    jckpt.load_params(base + ".sacc.best", template)
    jres = jckpt.load_train_state(base + ".opt.last", jax_state(template))
    assert int(jres.step) == 3
    x = batch_to_torch(PhonemizerCollate(PhonemizerEncodings(base + ".encodings"))(
        PhonemizerDataset(str(phonemizer_data / "phonemizer.dev"))[:1]), "cpu")
    out = jm.apply({"params": jres.params}, jnp_batch({k: v.numpy() for k, v in x.items()}))
    assert all(np.isfinite(np.asarray(o)).all() for o in jax.tree_util.tree_leaves(out))

    restored = train_phonemizer.main(argv + ["--resume", "--max-epochs", "0"])
    assert restored.step == 3
    for n, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[n], v), n
    more = train_phonemizer.main(argv + ["--resume", "--max-steps", "4"])
    assert more.step == 4

    # export_model's check of the packaged phonemizer (default sacc.best): the aligned
    # model's file passes, an M2M file is refused with the JAX script's message
    from ttscube_tpu_torch import api
    from ttscube_tpu_torch.scripts import export_model

    monkeypatch.setattr(api, "PhonemizerConfig", tp.PhonemizerConfig)
    assert export_model.parser().parse_args(["--input-model", "m", "--input-phonemizer", base,
                                             "--output-model", "o"]).phonemizer_weights == \
        "sacc.best"
    if kind == "aligned":
        export_model._validate_phonemizer(base, "sacc.best")
    else:
        with pytest.raises(SystemExit, match="does not match the aligned Phonemizer template"):
            export_model._validate_phonemizer(base, "sacc.best")


def test_aligned_phonemizer_overfits_two_examples():
    """tests/test_training.py's overfit check on the port: 60 steps at lr 1e-2 on two
    examples take the loss below 0.2 of its first value, and PACC above 0.9."""
    ex = [
        {"orig_text": "abcd ef", "phones": ["A", "B", "C", "D", "_", "E", "F"],
         "phon2word": [0, 0, 0, 0, 1, 2, 2], "words": ["abcd", " ", "ef"]},
        {"orig_text": "fedb ca", "phones": ["F", "E", "D", "B", "_", "C", "A"],
         "phon2word": [0, 0, 0, 0, 1, 2, 2], "words": ["fedb", " ", "ca"]},
    ]
    enc = PhonemizerEncodings()
    enc.compute(ex)
    model = init_random(tp.Phonemizer(tp.PhonemizerConfig(
        num_graphemes=len(enc.graphemes), num_phonemes=len(enc.phonemes),
        conv_size=64, rnn_size=32)), 0)
    batch = batch_to_torch(PhonemizerCollate(enc, bucket=8)(ex), "cpu")
    state = ts.create_phonemizer_state(model, lr=1e-2)
    losses = [float(ts.phonemizer_train_step(state, batch)[1]["loss"]) for _ in range(60)]
    print(f"\noverfit: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < 0.2 * losses[0]
    assert float(ts.phonemizer_val_step(state, batch)["pacc"]) > 0.9
