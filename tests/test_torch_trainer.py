"""The port's trainer (`ttscube_tpu_torch.train.loop`, `utils.checkpoint`, the data path
and the CLI `ttscube_tpu_torch.scripts.train_cubegan`) on the CPU: twins of
tests/test_training.py's loop, checkpoint, resume, cache and synthesis tests, and the
interchange of checkpoint files with the JAX package.

Limits: checkpoints round-trip bit-equal; JAX's loaders read the port's `.last` and
`.opt.last` bit-equal; from a JAX `.opt.last`, the port's next step matches JAX's next
step at tests/test_torch_train.py's tolerances (metrics 1e-5 relative, grads rtol = atol
= 2e-4, parameters within 2·lr plus rounding and at most 0.1 % of them beyond 0.01·lr),
with the same crop offsets."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
from flax import serialization as fser

from ttscube_tpu.models import cubegan as jcg
from ttscube_tpu.utils import checkpoint as jckpt
from ttscube_tpu_torch.convert import (init_random, jax_to_state_dict, state_dict_to_jax,
                                       train_state_to_jax)
from ttscube_tpu_torch.data.collate import CubeganCollate
from ttscube_tpu_torch.data.datasets import CubeganDataset
from ttscube_tpu_torch.data.encodings import CubeganEncodings
from ttscube_tpu_torch.models import cubegan as tcg
from ttscube_tpu_torch.models.hifigan import HifiganConfig
from ttscube_tpu_torch.models.languasito import LanguasitoConfig
from ttscube_tpu_torch.ops.linear import Dense
from ttscube_tpu_torch.train.loop import train
from ttscube_tpu_torch.utils import checkpoint as ckpt
from ttscube_tpu_torch.utils.wavio import read_wav
from tests.test_data import make_corpus
from tests.torch_parity import (TINY_HIFI, TRAIN_DISC, TRAIN_LANG,  # noqa: F401
                                exact_cpu_convs, jax_crop_starts, one_cpu_thread,
                                step_cpu_threads, toy_train_batch, train_pair)


def tiny_config(**kw):
    """tests/test_cubegan.py's tiny_model config, in the port."""
    return tcg.CubeganConfig(languasito=LanguasitoConfig(**TRAIN_LANG),
                             hifigan=HifiganConfig(**TINY_HIFI), **TRAIN_DISC, **kw)


def tiny_state(seed=0):
    return tcg.create_train_state(init_random(tcg.Cubegan(tiny_config(), train=True), seed))


@pytest.fixture
def corpus(tmp_path):
    make_corpus(tmp_path / "corpus", n=4)
    ds = CubeganDataset(str(tmp_path / "corpus"))
    enc = CubeganEncodings()
    enc.compute(ds)
    return ds, CubeganCollate(enc, min_frames=60, bucket_frames=60, bucket_phones=16)


def loop(state, ds, collate, base, **kw):
    return train(state=state, train_step=tcg.train_step, val_step=tcg.val_step,
                 trainset=ds, devset=ds, collate=collate, batch_size=2, output_base=base,
                 selection_metric="loss_mel", **kw)


def equal_state_dicts(a: torch.nn.Module, b: torch.nn.Module, params_only=False) -> bool:
    """Equal parameters and, unless `params_only`, buffers (the spectral u, which a
    weight file does not hold)."""
    pick = (lambda m: dict(m.named_parameters())) if params_only else \
        (lambda m: m.state_dict())
    sa, sb = pick(a), pick(b)
    return sa.keys() == sb.keys() and all(torch.equal(v, sb[k]) for k, v in sa.items())


# -- twins of tests/test_training.py --------------------------------------------------------


@pytest.mark.usefixtures("one_cpu_thread")
def test_cubegan_loop_checkpoints_and_resume(tmp_path, corpus):
    ds, collate = corpus
    base = str(tmp_path / "model" / "cubegan")
    final = loop(tiny_state(), ds, collate, base, max_epochs=2, log_every=1)
    for ext in (".best", ".last", ".opt.last"):
        assert os.path.exists(base + ext)
    assert final.step == 4  # 2 epochs x 2 batches

    # checkpoint round trip
    restored = ckpt.load_params(base + ".last", tcg.Cubegan(tiny_config(), train=True))
    assert equal_state_dicts(restored, final.model, params_only=True)

    # resume restores the whole state, the global step included
    resumed = loop(tiny_state(seed=1), ds, collate, base, max_epochs=0, resume=True)
    assert resumed.step == 4
    assert equal_state_dicts(resumed.model, final.model)
    for part, opt in final.optimizers.items():
        for p, q in zip(opt.param_groups[0]["params"],
                        resumed.optimizers[part].param_groups[0]["params"]):
            a, b = opt.state[p], resumed.optimizers[part].state[q]
            assert float(a["step"]) == float(b["step"]) == 4
            assert torch.equal(a["exp_avg"], b["exp_avg"])
            assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])


@pytest.mark.usefixtures("one_cpu_thread")
def test_resume_falls_back_on_truncated_opt_checkpoint(tmp_path, corpus, capsys):
    """A save cut off in the JAX package's writer leaves a 0-byte `.opt.last`; resume
    falls back to the weights of `.last`, and the step restarts at 0."""
    base = str(tmp_path / "m" / "cubegan")
    ckpt.BestKeeper(base, "loss")  # mkdir
    saved = tiny_state(seed=3)
    ckpt.save_params(base + ".last", saved.model)
    open(base + ".opt.last", "wb").close()  # truncated save

    with pytest.raises(ValueError, match="empty"):
        ckpt.load_train_state(base + ".opt.last", tiny_state())
    got = ckpt.load_params(base + ".last", tcg.Cubegan(tiny_config(), train=True))
    assert equal_state_dicts(got, saved.model, params_only=True)

    ds, collate = corpus
    resumed = loop(tiny_state(), ds, collate, base, max_epochs=0, resume=True)
    assert "Falling back to weights-only resume" in capsys.readouterr().out
    assert resumed.step == 0 and equal_state_dicts(resumed.model, saved.model,
                                                   params_only=True)


def test_legacy_single_state_opt_checkpoint_is_refused(tmp_path):
    path = str(tmp_path / "legacy.opt.last")
    tree = train_state_to_jax(tiny_state())
    tree["opt_state"] = tree["opt_state"]["gtb"]  # round 1: one multi_transform state
    with open(path, "wb") as f:
        f.write(fser.msgpack_serialize(tree))
    with pytest.raises(ValueError, match="legacy"):
        ckpt.load_train_state(path, tiny_state())


def test_opt_checkpoint_of_another_model_is_refused(tmp_path):
    """An `.opt.last` that does not fit the model raises ValueError (the trainer then
    falls back to `.last`, as the JAX loop does when flax's template does not match),
    and restores nothing."""
    path = str(tmp_path / "other.opt.last")
    other = tcg.create_train_state(init_random(tcg.Cubegan(tcg.CubeganConfig(
        languasito=LanguasitoConfig(**dict(TRAIN_LANG, num_phones=31)),
        hifigan=HifiganConfig(**TINY_HIFI), **TRAIN_DISC), train=True), 0))
    ckpt.save_train_state(path, other)
    state = tiny_state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with pytest.raises(ValueError, match="does not fit"):
        ckpt.load_train_state(path, state)
    assert state.step == 0
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())


class _Params(torch.nn.Module):
    """A one-leaf model for BestKeeper: its JAX tree is {"w": {"kernel", "bias"}}."""

    def __init__(self, v: float):
        super().__init__()
        self.w = Dense(2, 2)
        torch.nn.init.constant_(self.w.weight, v)
        torch.nn.init.constant_(self.w.bias, v)


def test_bestkeeper_deferred_best_saves(tmp_path):
    """defer_best=True keeps the improving parameters on the device and writes `.best`
    with the next save (the JAX BestKeeper's contract)."""
    def mk(v):
        return tcg.TrainState(model=_Params(float(v)), optimizers={}, step=0, seed=0)

    def load(path):
        return float(ckpt.load_params(path, _Params(0.0)).w.bias[0])

    base = str(tmp_path / "m" / "cubegan")
    keeper = ckpt.BestKeeper(base, "loss")
    live = mk(1)
    # improving epoch, deferred: nothing hits disk
    assert keeper.update(1.0, live, save_opt=False, save_last=False, defer_best=True)
    assert not os.path.exists(base + ".best") and not os.path.exists(base + ".last")
    # the parameters change in place afterwards (as a train step does): the deferred
    # best must be the copy taken at its epoch
    with torch.no_grad():
        live.model.w.bias.fill_(2.0)
        live.model.w.weight.fill_(2.0)
    assert not keeper.update(2.0, live, save_opt=False, save_last=False, defer_best=True)
    assert not os.path.exists(base + ".best")
    # cadence epoch: the pending best (epoch-1 parameters) flushed, .last is current
    assert not keeper.update(3.0, mk(3), save_opt=True, save_last=True, defer_best=True)
    assert load(base + ".best") == 1.0 and load(base + ".last") == 3.0
    assert os.path.exists(base + ".opt.last")

    # an improvement landing on a cadence epoch: .best == .last
    k2 = str(tmp_path / "m" / "k2")
    assert ckpt.BestKeeper(k2, "loss").update(0.5, mk(5), save_opt=True, save_last=True,
                                              defer_best=True)
    assert load(k2 + ".best") == 5.0 and load(k2 + ".last") == 5.0

    # defer_best=False keeps the immediate save
    k3 = str(tmp_path / "m" / "k3")
    assert ckpt.BestKeeper(k3, "loss").update(0.1, mk(7), save_opt=False, save_last=False)
    assert load(k3 + ".best") == 7.0

    # a newer improvement on a saving epoch beats an older pending best
    k4 = str(tmp_path / "m" / "k4")
    keeper4 = ckpt.BestKeeper(k4, "loss")
    assert keeper4.update(1.0, mk(1), save_opt=False, save_last=False, defer_best=True)
    assert keeper4.update(0.5, mk(9), save_opt=True, save_last=True)
    assert load(k4 + ".best") == 9.0


@pytest.mark.usefixtures("one_cpu_thread")
def test_cubegan_loop_cached_batches(tmp_path, corpus):
    ds, collate = corpus
    base = str(tmp_path / "model" / "cubegan")
    final = loop(tiny_state(), ds, collate, base, max_epochs=2, log_every=1,
                 cache_batches=True)
    assert final.step == 4  # 2 epochs x 2 cached batches
    assert os.path.exists(base + ".last") and os.path.exists(base + ".opt.last")


@pytest.mark.usefixtures("one_cpu_thread")
def test_cubegan_loop_cache_budget_falls_back(tmp_path, corpus, capsys):
    """Collated batches past cache_batches_budget stream instead; the count stops at
    the budget (the first batch here), not after collating the whole set."""
    ds, collate = corpus
    calls = []
    counting = lambda batch: calls.append(len(batch)) or collate(batch)
    final = loop(tiny_state(), ds, counting, str(tmp_path / "model" / "cubegan"),
                 max_epochs=1, log_every=1, cache_batches=True, cache_batches_budget=1)
    assert final.step == 2
    assert "streaming batches instead" in capsys.readouterr().out
    # one batch collated for the cache, then 2 train and 2 validation batches streamed
    assert len(calls) == 1 + 2 + 2


@pytest.mark.usefixtures("one_cpu_thread")
def test_synthesize_dataset_free_and_forced_trim(tmp_path):
    """Free synthesis trims to the predicted frames, forced synthesis to the example's
    real frames (the collate pads to its bucket)."""
    from ttscube_tpu_torch.train.runtime import cubegan_synthesize_dataset

    make_corpus(tmp_path / "corpus", n=2)
    ds = CubeganDataset(str(tmp_path / "corpus"))
    enc = CubeganEncodings()
    enc.compute(ds)
    model = tiny_state().model
    hop = model.config.hop_size
    collate = CubeganCollate(enc, min_frames=96, bucket_frames=96, bucket_phones=16)

    cubegan_synthesize_dataset(model, ds, collate, str(tmp_path / "forced"), free=False,
                               max_frames=96)
    for i in range(2):
        wav, sr = read_wav(str(tmp_path / "forced" / f"{ds[i]['meta']['id']}.wav"))
        n_frames = int(collate([ds[i]])["n_frames"][0])
        assert n_frames * hop < 96 * hop, "the fixture must pad"
        assert len(wav) == n_frames * hop and sr == 24000

    cubegan_synthesize_dataset(model, ds, collate, str(tmp_path / "free"), free=True,
                               max_frames=96)
    for i in range(2):
        wav, _ = read_wav(str(tmp_path / "free" / f"{ds[i]['meta']['id']}.wav"))
        assert len(wav) % hop == 0 and 0 < len(wav) <= 96 * hop


# -- beyond the twins ------------------------------------------------------------------------


@pytest.mark.usefixtures("exact_cpu_convs", "one_cpu_thread")
def test_a_few_steps_lower_the_mel_loss():
    state = tiny_state(seed=2)
    batch = tcg.batch_to_torch(toy_train_batch(seed=2), "cpu")
    starts = torch.tensor([2, 5])
    mel = [tcg.train_step(state, batch, starts=starts)[1]["loss_mel"].item()
           for _ in range(8)]
    print(f"\nloss_mel over 8 steps: {' '.join(f'{v:.4f}' for v in mel)}")
    assert mel[-1] < mel[0]


@pytest.mark.usefixtures("exact_cpu_convs", "one_cpu_thread")
def test_jax_loaders_read_the_ports_checkpoints(tmp_path):
    """JAX's load_params and load_train_state read the port's `.last` and `.opt.last`
    (after a port step, so that every moment and count is live) into a JAX template,
    bit-equal to the port's state."""
    batch = toy_train_batch()
    _, jstate, tm = train_pair(TINY_HIFI, batch, seed=4)
    state = tcg.create_train_state(tm)
    tcg.train_step(state, tcg.batch_to_torch(batch, "cpu"), starts=torch.tensor([1, 2]))
    keeper = ckpt.BestKeeper(str(tmp_path / "m" / "cubegan"), "loss_mel")
    keeper.update(1.0, state)
    base = keeper.base

    want = train_state_to_jax(state)
    params = jckpt.load_params(base + ".last", jax.device_get(jstate.params))
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(want["params"])))
    assert np.array_equal(jax.tree_util.tree_leaves(params)[0],
                          jax.tree_util.tree_leaves(state_dict_to_jax(state.model))[0])
    loaded = jckpt.load_train_state(base + ".opt.last", jstate)
    assert int(loaded.step) == 1
    got_leaves = jax.tree_util.tree_leaves(fser.to_state_dict(loaded))
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(got_leaves, want_leaves))
    # the moments JAX reads are the port's, in JAX's layouts: a (k, in, out) conv kernel
    # of the MSD against the port's (out, in, k) exp_avg
    name, p = next((n, p) for n, p in state.model.named_parameters()
                   if n.startswith("msd.") and n.endswith(".kernel"))
    mu = loaded.opt_state["d"].inner_states["d"].inner_state[0].mu
    for key in name.split("."):
        mu = mu[key]
    exp_avg = state.optimizers["d"].state[p]["exp_avg"]
    assert np.array_equal(np.asarray(mu), exp_avg.permute(2, 1, 0).numpy())
    assert float(np.abs(np.asarray(mu)).max()) > 0
    assert int(loaded.opt_state["gtb"].inner_states["g"].inner_state[0].count) == 1


def _grads_of_second_step(mu1, mu2) -> dict:
    """JAX's step-2 grads read off its first moments: mu2 = b1·mu1 + (1 − b1)·g."""
    import optax

    out = {}
    for tx, parts in (("d", "d"), ("gtb", "gt")):
        for part in parts:
            a = mu1[tx].inner_states[part].inner_state[0].mu
            b = mu2[tx].inner_states[part].inner_state[0].mu
            is_leaf = lambda x: isinstance(x, optax.MaskedNode)
            for (path, x), y in zip(jax.tree_util.tree_flatten_with_path(a, is_leaf=is_leaf)[0],
                                    jax.tree_util.tree_leaves(b, is_leaf=is_leaf)):
                if isinstance(x, optax.MaskedNode):
                    continue
                node = out
                for key in path[:-1]:
                    node = node.setdefault(key.key, {})
                node[path[-1].key] = (np.asarray(y, np.float64) - 0.8 * np.asarray(x)) / 0.2
    return out


@pytest.mark.usefixtures("exact_cpu_convs", "step_cpu_threads")
def test_port_resumes_a_jax_run(tmp_path):
    """JAX takes one step and saves its `.opt.last`; the port, from other weights,
    resumes that file and takes the next step beside JAX's next step, with the same
    crop offsets."""
    batch = toy_train_batch(seed=6)
    jm, jstate, _ = train_pair(TINY_HIFI, batch, seed=6)
    rng = jax.random.PRNGKey(6)
    step = jax.jit(lambda s, b, r: jcg.train_step(jm, s, b, r))
    j1, _ = step(jstate, batch, rng)
    path = str(tmp_path / "jax.opt.last")
    jckpt.save_train_state(path, j1)
    j2, jmet = step(j1, batch, rng)

    state = ckpt.load_train_state(path, tiny_state(seed=9))
    assert state.step == 1
    lr = state.model.config.lr
    starts = jax_crop_starts(batch["n_frames"], min(jcg.TRAIN_FRAMES, 60),
                             jax.random.fold_in(rng, 1))
    _, met = tcg.train_step(state, tcg.batch_to_torch(batch, "cpu"),
                            starts=torch.from_numpy(starts))
    assert state.step == 2
    for k, v in jmet.items():
        want, got = float(v), met[k].item()
        print(f"\nparity resumed step {k}: rel_diff={abs(got - want) / abs(want):.3e} "
              f"tol=1e-05")
        assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)
    want_grads = jax_to_state_dict(state.model, _grads_of_second_step(j1.opt_state,
                                                                      j2.opt_state))
    want_params = jax_to_state_dict(state.model, jax.tree_util.tree_map(np.asarray, j2.params))
    n_over = n_far = n_all = 0
    for name, p in state.model.named_parameters():
        if not p.requires_grad:
            continue
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=f"grad {name}")
        w = want_params[name]
        d = (p.detach() - w).abs()
        spacing = torch.nextafter(w.abs(), torch.tensor(float("inf"))) - w.abs()
        n_over += int((d > 2 * lr + 2 * spacing).sum())
        n_far += int((d > 0.01 * lr).sum())
        n_all += d.numel()
    print(f"\nparity resumed step params: {n_far} of {n_all} beyond 0.01 lr")
    assert n_over == 0 and n_far <= 1e-3 * n_all


@pytest.mark.usefixtures("one_cpu_thread")
def test_cli_trains_two_steps_on_the_cpu(tmp_path, corpus, monkeypatch):
    """`python -m ttscube_tpu_torch.scripts.train_cubegan --device cpu`, on the tiny
    config (the CLI builds v1 widths; its config class is narrowed here)."""
    from ttscube_tpu_torch.scripts import train_cubegan as cli

    monkeypatch.setattr(tcg, "CubeganConfig", functools.partial(
        tcg.CubeganConfig, hifigan=HifiganConfig(**TINY_HIFI), **TRAIN_DISC))
    monkeypatch.chdir(tmp_path)
    base = str(tmp_path / "out" / "cubegan")
    args = ["--train-folder", str(tmp_path / "corpus"), "--dev-folder",
            str(tmp_path / "corpus"), "--output-base", base, "--batch-size", "2",
            "--max-steps", "2", "--epoch-generation", "1", "--device", "cpu"]
    # main returns the final step count; train_on, which it calls, the final TrainState
    state = cli.train_on(cli.parse_args(args), torch.device("cpu"))
    assert state.step == 2
    for ext in (".yaml", ".encodings", ".best", ".last", ".opt.last"):
        assert os.path.exists(base + ext), ext
    assert sorted(os.listdir(tmp_path / "generated_files" / "free")) == \
        [f"utt{i}.wav" for i in range(4)]
    assert ckpt.load_config(base) == {"sample_rate": 24000, "hop_size": 240,
                                      "conditioning": None}
    # fault C6: the config comes from the encodings as saved (max_pitch an int), the
    # same on a fresh run, on resume and in TTSCube
    saved = CubeganEncodings(base + ".encodings")
    assert state.model.config.languasito.max_pitch == saved.max_pitch
    assert isinstance(saved.max_pitch, int)
    resumed = cli.train_on(cli.parse_args(args + ["--resume", "--max-epochs", "0"]),
                           torch.device("cpu"))
    assert resumed.model.config == state.model.config and resumed.step == 2
    assert cli.main(args + ["--resume", "--max-epochs", "0"]) == 2
    # --lm trains (tests/test_torch_lm_serve.py); a spec of no known kind stops the run,
    # and so does a fastText table that is not there; the mesh flags train
    # (tests/test_torch_mesh.py)
    with pytest.raises(SystemExit, match="unknown --lm spec"):
        cli.main(args + ["--lm", "bogus:en"])
    with pytest.raises(FileNotFoundError):
        cli.main(args + ["--lm", "fasttext:en"])
    # bf16 trains (tests/test_torch_bf16_train.py); with the fp32-only fused tail it is
    # refused when the flags are parsed
    with pytest.raises(SystemExit):
        cli.main(args + ["--compute-dtype", "bfloat16", "--fused-tail-train"])
