"""The port's Textcoder (`ttscube_tpu_torch/models/textcoder.py`) on the CPU against the
JAX package at full width: the teacher-forced pass in train and eval mode, the free run,
the losses, a train step, the `.opt.last` file both ways, `synthesize_devset`, and the
trainer CLI.

The PreNet's dropout is always on, so both packages must drop the same units: the JAX
pass runs under `flax.linen.intercept_methods`, which sees the key each PreNet call
gets; the masks are drawn from that key as `PreNet.__call__` draws them (split, then
bernoulli 0.5 per layer), returned by the jitted pass, and handed to the port.

Limits (the port's own, fp32): dur and pitch logits 2e-4; mel_pre and mel_post 5e-5;
the PostNet's running mean and var after a train-mode pass 1e-6; losses 2e-4 relative;
a train step's grads 5e-6 of a module's largest and the parameters after it within 2 lr,
at most 0.1 % beyond 0.01 lr (tests/torch_parity.py). The free run feeds back its
argmax durations and its own frames: its mel is held to JAX's teacher-forced pass fed
the port's free-run mel and frame→phone map, and its durations must equal JAX's
argmax, with the smallest top-1/top-2 margin printed and held to 100 x the logits
limit (as tests/test_torch_g2p.py does).
"""

import functools
import shutil

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from ttscube_tpu.models import blocks as jblocks
from ttscube_tpu.models import textcoder as jtc
from ttscube_tpu.ops.length_regulator import durations_to_frame2phone_np
from ttscube_tpu.ops.rnn import unroll_override
from ttscube_tpu.train import states as js
from ttscube_tpu.utils import checkpoint as jckpt
from ttscube_tpu_torch.convert import (batch_stats_to_jax, init_random, jax_to_state_dict,
                                       load_jax_params, state_dict_to_jax)
from ttscube_tpu_torch.models import textcoder as ttc
from ttscube_tpu_torch.models.cubegan import batch_to_torch
from ttscube_tpu_torch.train import states as ts
from ttscube_tpu_torch.utils import checkpoint as ckpt
from tests.torch_parity import (GRAD_TOL, SHARE, SHARE_LR, assert_close,  # noqa: F401
                                exact_cpu_convs, grad_error, one_cpu_thread, param_error,
                                release_jax_caches, seeded_tree)

pytestmark = pytest.mark.usefixtures("exact_cpu_convs", "one_cpu_thread", "release_jax_caches")

CFG = dict(num_phones=30, num_speakers=3, max_pitch=300, max_duration=50, pframes=3)
TOL_LOGITS = 2e-4
TOL_MEL = 5e-5
TOL_STATS = 1e-6
TOL_LOSS = 2e-4   # relative
LR = 2e-4
TOL_DUR_FREE = 5e-6
FREE_FRAMES = 36  # the free run's max_frames: 12 decoder groups


def toy_batch(B=2, N=10, F=30, seed=0):
    """tests/test_textcoder.py's batch, as numpy arrays."""
    rng = np.random.default_rng(seed)
    x_char = np.zeros((B, N), np.int32)
    durs = np.zeros((B, N), np.int32)
    n_valid = np.array([N, N - 3])
    for b in range(B):
        x_char[b, : n_valid[b]] = rng.integers(1, 30, n_valid[b])
        durs[b, : n_valid[b]] = rng.integers(2, 4, n_valid[b])
    f2p, fmask = durations_to_frame2phone_np(durs, n_valid, F)
    return {"x_char": x_char, "x_speaker": rng.integers(1, 3, (B, 1)).astype(np.int32),
            "y_frame2phone": np.asarray(f2p, np.int32), "y_frame_mask": np.asarray(fmask),
            "y_dur": durs,
            "y_pitch": (rng.uniform(80, 290, (B, F)) * np.asarray(fmask)).astype(np.float32),
            "y_mgc": (rng.standard_normal((B, F, 80)) - 2.0).astype(np.float32)}


def jnp_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def variables_of(batch, seed: int):
    """Seeded {params, batch_stats} for JAX's CubenetTextcoder (shapes from
    `jax.eval_shape`, no init)."""
    model = jtc.CubenetTextcoder(jtc.TextcoderConfig(**CFG))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init({"params": k, "dropout": k}, jnp_batch(batch)))
    return seeded_tree(dict(shapes), seed)


def port_model(variables):
    return load_jax_params(ttc.CubenetTextcoder(ttc.TextcoderConfig(**CFG)),
                           variables["params"], batch_stats=variables["batch_stats"])


def with_masks(fn):
    """`fn` (which applies a flax model) with the masks of the first PreNet call it
    makes, drawn from that call's key as `blocks.PreNet.__call__` draws them."""

    def run(*args):
        masks = []
        # the scans not unrolled: the same math, a fraction of the compile

        def record(next_fun, a, kw, context):
            if isinstance(context.module, jblocks.PreNet) and context.method_name == "__call__" \
                    and not masks:
                lead, r = a[0].shape[:-1], kw["rng"]
                for s in context.module.sizes:
                    r, sub = jax.random.split(r)
                    masks.append(jax.random.bernoulli(sub, 0.5, lead + (s,)))
            return next_fun(*a, **kw)

        with fnn.intercept_methods(record), unroll_override(1):
            out = fn(*args)
        return out, masks

    return run


@functools.lru_cache(maxsize=None)
def jax_forward(train: bool):
    """JAX's teacher-forced pass, jitted: ((outputs, new batch_stats), PreNet masks)."""
    model = jtc.CubenetTextcoder(jtc.TextcoderConfig(**CFG))

    def fn(variables, batch, key):
        if train:
            return model.apply(variables, batch, train=True, mutable=["batch_stats"],
                               rngs={"dropout": key})
        return model.apply(variables, batch, train=False, rngs={"dropout": key}), None

    return jax.jit(with_masks(fn))


def torch_masks(masks):
    return [torch.from_numpy(np.array(m)) for m in masks]


@pytest.mark.parametrize("train", [False, True])
def test_teacher_forced_matches_jax(train):
    b = toy_batch()
    variables = variables_of(b, seed=1)
    (out, new_stats), masks = jax_forward(train)(variables, jnp_batch(b), jax.random.PRNGKey(3))
    tm = port_model(variables)
    got = tm(batch_to_torch(b, "cpu"), train=train, masks=torch_masks(masks))
    for name, g, w, tol in zip(("dur_logits", "pitch_logits", "mel_pre", "mel_post"), got,
                               out, (TOL_LOGITS, TOL_LOGITS, TOL_MEL, TOL_MEL)):
        assert_close(f"textcoder {'train' if train else 'eval'} {name}", g, w, tol)
    stats = batch_stats_to_jax(tm)
    want = new_stats["batch_stats"] if train else variables["batch_stats"]
    for bn in want["postnet"]:
        for k in ("mean", "var"):
            assert_close(f"textcoder postnet {bn} running {k}", stats["postnet"][bn][k],
                         want["postnet"][bn][k], TOL_STATS)
    # other masks give other mels: the masks are what the test holds equal
    with torch.no_grad():
        other = tm(batch_to_torch(b, "cpu"), train=False,
                   generator=torch.Generator().manual_seed(0))
    assert float((other[2] - got[2]).abs().max()) > 100 * TOL_MEL


def smallest_margin(what: str, logits, valid, tol: float) -> float:
    top = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    m = np.where(valid, top[..., 1] - top[..., 0], np.inf)
    idx = np.unravel_index(np.argmin(m), m.shape)
    print(f"\nparity {what}: smallest top-1/top-2 margin {m[idx]:.3e} (row {idx[0]}, "
          f"phone {idx[1]}); limit {100 * tol:.0e}")
    assert m[idx] >= 100 * tol, f"{what}: a near-tie at phone {idx[1]}: {m[idx]:.3e}"
    return float(m[idx])


def test_free_run_matches_jax_teacher_forced_on_its_own_mel():
    b = toy_batch()
    variables = variables_of(b, seed=2)
    tm = port_model(variables)
    key = jax.random.PRNGKey(5)
    shaped = dict(b, y_mgc=np.zeros((2, FREE_FRAMES, 80), np.float32),
                  y_frame2phone=np.zeros((2, FREE_FRAMES), np.int32))
    _, masks = jax_forward(False)(variables, jnp_batch(shaped), key)
    X = {k: v for k, v in batch_to_torch(b, "cpu").items() if k.startswith("x_")}
    with torch.no_grad():
        mel, aux = tm.infer(X, max_frames=FREE_FRAMES, masks=torch_masks(masks))
    assert mel.shape == (2, FREE_FRAMES, 80) and aux["frame_mask"].shape == (2, FREE_FRAMES)
    fed = dict(shaped, y_mgc=aux["mel_pre"].numpy(), y_frame2phone=aux["frame2phone"].numpy()
               .astype(np.int32))
    (out, _), again = jax_forward(False)(variables, jnp_batch(fed), key)
    assert all(np.array_equal(a, c) for a, c in zip(masks, again))
    valid = b["x_char"] != 0
    assert_close("textcoder free run dur_logits", aux["dur_logits"], out[0], TOL_DUR_FREE)
    smallest_margin("textcoder free run durations", out[0], valid, TOL_DUR_FREE)
    want_durs = np.argmax(np.asarray(out[0]), axis=-1) * valid
    assert np.array_equal(aux["durations"].numpy(), want_durs)
    assert aux["frame_mask"].numpy().sum(axis=1).tolist() == np.minimum(
        want_durs.sum(axis=1), FREE_FRAMES).tolist()
    assert_close("textcoder free run mel_pre", aux["mel_pre"], out[2], TOL_MEL)
    assert_close("textcoder free run mel_post", mel, out[3], TOL_MEL)


# -- the losses and the steps ------------------------------------------------------------


def test_losses_match_jax():
    b = toy_batch(seed=4)
    rng = np.random.default_rng(4)
    shapes = {"dur": (2, 10, CFG["max_duration"] + 1), "pitch": (2, 10, CFG["max_pitch"] + 1),
              "pre": (2, 30, 80), "post": (2, 30, 80)}
    outs = [rng.standard_normal(s).astype(np.float32) for s in shapes.values()]
    want = jtc.textcoder_losses([jnp.asarray(o) for o in outs], jnp_batch(b),
                                jtc.TextcoderConfig(**CFG))
    got = ttc.textcoder_losses([torch.from_numpy(o) for o in outs], batch_to_torch(b, "cpu"),
                               ttc.TextcoderConfig(**CFG))
    assert got.keys() == want.keys()
    for k in want:
        rel = abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
        print(f"\nparity textcoder_losses {k}: relative {rel:.3e} tol={TOL_LOSS:.0e}")
        assert rel <= TOL_LOSS, k


def jax_tx():
    return optax.adamw(js._inverse_decay(LR, 1e-5), weight_decay=0.01)


def adam_mu(opt_state):
    return opt_state[0].mu


@functools.lru_cache(maxsize=None)
def jax_step():
    """JAX's jitted `textcoder_train_step` and the masks its PreNet drew: ((new state,
    losses, the step's grads), masks). The grads are read back from Adam's first moment
    (mu' = 0.9 mu + 0.1 g, in fp64 from the fp32 moments), which spares a second
    compile of the backward pass."""
    model = jtc.CubenetTextcoder(jtc.TextcoderConfig(**CFG))
    step = jax.jit(with_masks(lambda state, batch, key: js.textcoder_train_step(
        model, state, batch, key, lr=LR)))

    def run(state, batch, key):
        (new, losses), masks = step(state, batch, key)
        grads = jax.tree_util.tree_map(
            lambda m1, m0: (np.asarray(m1, np.float64) - 0.9 * np.asarray(m0, np.float64))
            / 0.1, jax.device_get(adam_mu(new.opt_state)), jax.device_get(adam_mu(
                state.opt_state)))
        return (new, losses, grads), masks

    return run


def jax_state(variables):
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return js.SimpleState(params=params, opt_state=jax_tx().init(params),
                          step=jnp.zeros((), jnp.int32),
                          extra=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]))


def port_grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.requires_grad}


def trained(model, tree) -> tuple:
    """(the port's trained parameters, JAX's tree under the port's names)."""
    sd = jax_to_state_dict(model, jax.device_get(tree))
    return ({n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad},
            {n: sd[n] for n, p in model.named_parameters() if p.requires_grad})


def check_step(what: str, port_state, metrics, jnew, jlosses, jgrads, masks_used=None):
    """A port step against JAX's: losses, grads, parameters and running averages."""
    model = port_state.model
    for k in jlosses:
        got, want = float(metrics[k]), float(jlosses[k])
        rel = abs(got - want) / abs(want)
        assert rel <= TOL_LOSS, (what, k, rel)
    print(f"\nparity {what}: loss relative "
          f"{abs(float(metrics['loss']) - float(jlosses['loss'])) / float(jlosses['loss']):.3e}")
    want = {n: torch.from_numpy(np.asarray(v)) for n, v in trained(model, jgrads)[1].items()}
    g = grad_error({n: v.double() for n, v in port_grads(model).items()}, want)
    print(f"parity {what} grads, of each module's largest: {g:.3e} (tol {GRAD_TOL:.0e})")
    assert g <= GRAD_TOL
    worst, share, within = param_error(*trained(model, jnew.params), LR)
    print(f"parity {what}: params after it max {worst:.3f} lr, {share:.2e} beyond "
          f"{SHARE_LR} lr (limit {SHARE})")
    assert within and share <= SHARE
    stats = batch_stats_to_jax(model)["postnet"]
    for bn, want in jax.device_get(jnew.extra)["postnet"].items():
        for k in ("mean", "var"):
            d = float(np.abs(stats[bn][k] - want[k]).max())
            assert d <= TOL_STATS, (what, bn, k, d)
    assert port_state.step == int(jnew.step)


def test_train_step_matches_jax():
    b = toy_batch(seed=5)
    variables = variables_of(b, seed=5)
    key = jax.random.PRNGKey(7)
    (jnew, jlosses, jgrads), masks = jax_step()(jax_state(variables), jnp_batch(b), key)
    state = ts.create_textcoder_state(port_model(variables), lr=LR)
    state, met = ts.textcoder_train_step(state, batch_to_torch(b, "cpu"),
                                         masks=torch_masks(masks))
    check_step("textcoder train step", state, met, jnew, jlosses, jgrads)
    # the validation step: the PostNet on the running averages, nothing written
    jv = js.textcoder_val_step(jtc.CubenetTextcoder(jtc.TextcoderConfig(**CFG)), jnew,
                               jnp_batch(b), key)
    stats = batch_stats_to_jax(state.model)
    tv = ts.textcoder_val_step(state, batch_to_torch(b, "cpu"), masks=torch_masks(masks))
    for k in jv:
        assert abs(float(tv[k]) - float(jv[k])) <= TOL_LOSS * abs(float(jv[k])), k
    assert all(np.array_equal(stats["postnet"][n][k], v) for n, d in
               batch_stats_to_jax(state.model)["postnet"].items() for k, v in d.items())


def test_step_masks_follow_the_seed_and_step():
    """Step k draws its masks from crop_generator(seed, k): the step's loss is the loss
    of the train-mode pass with masks drawn from that generator, and not the loss with
    those of another step."""
    from ttscube_tpu_torch.models.cubegan import crop_generator

    b = batch_to_torch(toy_batch(seed=6), "cpu")
    state = ts.create_textcoder_state(port_model(variables_of(toy_batch(seed=6), seed=6)),
                                      lr=LR, seed=3)
    state.step = 5
    model = state.model
    lead = (2, b["y_mgc"].shape[1] // 3)
    with torch.no_grad():
        want, other = (float(ttc.textcoder_losses(model(b, train=True, masks=model.prenet.draw_masks(
            lead, crop_generator(3, k), "cpu")), b, model.config)["loss"]) for k in (5, 6))
    _, met = ts.textcoder_train_step(state, b)
    print(f"\nparity textcoder step masks: loss {float(met['loss']):.7f}, from the masks of "
          f"step 5 {want:.7f}, of step 6 {other:.7f}")
    assert abs(float(met["loss"]) - want) <= 1e-6 * abs(want) < abs(other - want)
    assert state.step == 6


def test_opt_last_resumes_across_packages(tmp_path):
    """A state after one step, written by either package's `save_train_state` and
    restored by the other; the next step from it (JAX's key gives the same masks again)
    agrees with JAX's next step by the step's limits. The batch statistics travel in
    `extra`."""
    b = toy_batch(seed=8)
    variables = variables_of(b, seed=8)
    key = jax.random.PRNGKey(9)
    step = jax_step()
    (jst, _, _), masks = step(jax_state(variables), jnp_batch(b), key)
    tmask = torch_masks(masks)
    jckpt.save_train_state(str(tmp_path / "j.opt.last"), jst)
    fresh = init_random(ttc.CubenetTextcoder(ttc.TextcoderConfig(**CFG)), 99)
    resumed = ckpt.load_train_state(str(tmp_path / "j.opt.last"),
                                    ts.create_textcoder_state(fresh, lr=LR))
    assert resumed.step == 1
    st = ts.textcoder_train_step(ts.create_textcoder_state(port_model(variables), lr=LR),
                                 batch_to_torch(b, "cpu"), masks=tmask)[0]
    ckpt.save_train_state(str(tmp_path / "t.opt.last"), st)
    jres = jckpt.load_train_state(str(tmp_path / "t.opt.last"), jst)
    assert int(jres.step) == 1
    for what, port, jstate in (("JAX file, port step", resumed, jst),
                               ("port file, JAX step", st, jres)):
        (jnext, jlosses, jgrads), again = step(jstate, jnp_batch(b), key)
        assert all(np.array_equal(x, y) for x, y in zip(masks, again))
        port, met = ts.textcoder_train_step(port, batch_to_torch(b, "cpu"), masks=tmask)
        check_step(f"textcoder resume ({what})", port, met, jnext, jlosses, jgrads)
        del jnext, jgrads, port  # each full-width state holds ~0.5 GB
    # parameter files both ways, bit-equal
    del resumed, jres
    jckpt.save_params(str(tmp_path / "j.best"), jst.params)
    loaded = ckpt.load_params(str(tmp_path / "j.best"), ttc.CubenetTextcoder(
        ttc.TextcoderConfig(**CFG)))
    for n, v in jax_to_state_dict(loaded, jax.device_get(jst.params)).items():
        assert torch.equal(loaded.state_dict()[n], v), n
    ckpt.save_params(str(tmp_path / "t.best"), st.model)
    back = jckpt.load_params(str(tmp_path / "t.best"), jst.params)
    want = state_dict_to_jax(st.model)
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        assert np.array_equal(np.asarray(x), y)
    shutil.rmtree(tmp_path)  # ~1 GB of full-width files
