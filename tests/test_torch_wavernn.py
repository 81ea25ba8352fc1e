"""The port's WaveRNN vocoder family on the CPU against the JAX package: the GRU and
its cell (`ops/rnn.py`), the μ-law and linear codecs (`dsp/mulaw.py`), the five output
heads (`models/heads.py`), WaveRNN teacher-forced and sampling, `CubenetVocoder`'s
losses, `infer` and train step (`models/wavernn.py`, `train/states.py`), and the
vocoder's `.opt.last` both ways.

Limits, the port's own (fp32): the GRU's outputs and states 1e-5; codes equal and
decoded values 1e-7; each head's loss 2e-4 relative; the MOL and Gaussian samples 1e-6
and the softmax heads' codes equal, given the uniforms, normals or Gumbel noise JAX
draws from its key; the Beta head's samples by the mean and variance of 20,000 draws,
within 4 standard errors of JAX's; WaveRNN's logits 5e-5. The sampler's logits at each
step are held to JAX's teacher-forced WaveRNN fed the port's own samples (shifted), so
the check needs no JAX scan. A train step's grads 5e-6 of a module's largest, and the
parameters after it within 2 lr, at most 0.1 % beyond 0.01 lr (tests/torch_parity.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ttscube_tpu.dsp import mulaw as jmu
from ttscube_tpu.models import heads as jheads
from ttscube_tpu.models import wavernn as jw
from ttscube_tpu.ops import rnn as jrnn
from ttscube_tpu.train import states as js
from ttscube_tpu.utils import checkpoint as jckpt
from ttscube_tpu_torch.convert import (init_random, jax_to_state_dict, load_jax_params,
                                       state_dict_to_jax)
from ttscube_tpu_torch.dsp import mulaw as tmu
from ttscube_tpu_torch.models import heads as theads
from ttscube_tpu_torch.models import wavernn as tw
from ttscube_tpu_torch.ops import rnn as trnn
from ttscube_tpu_torch.train import states as ts
from ttscube_tpu_torch.utils import checkpoint as ckpt
from tests.torch_parity import (GRAD_TOL, SHARE, SHARE_LR, assert_close,  # noqa: F401
                                grad_error, one_cpu_thread, param_error, release_jax_caches,
                                seeded_tree)

pytestmark = pytest.mark.usefixtures("one_cpu_thread", "scans_not_unrolled",
                                     "release_jax_caches")


@pytest.fixture
def scans_not_unrolled():
    """JAX's GRU scans traced without unrolling (`unroll_override(1)`): the same math,
    a fraction of the compile time."""
    with jrnn.unroll_override(1):
        yield

TOL_GRU = 1e-5
TOL_DECODE = 1e-7
TOL_LOSS = 2e-4   # relative
TOL_SAMPLE = 1e-6
TOL_LOGITS = 5e-5
SMALL = dict(num_layers=2, layer_size=32)  # tests/test_wavernn.py's widths
UP, UP_LOW = 24, 4
HEADS = ["mol", "gm", "beta", "mulaw", "raw"]


def t(x):
    return torch.from_numpy(np.array(x))


# -- GRU ---------------------------------------------------------------------------------


def test_gru_and_cell_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 17, 12)).astype(np.float32)
    h0 = [rng.standard_normal((3, 20)).astype(np.float32) for _ in range(2)]
    jm = jrnn.GRU(20, num_layers=2)
    params = seeded_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"], 1)
    ys, finals = jm.apply({"params": params}, x, initial_state=h0)
    tm = load_jax_params(trnn.GRU(12, 20, num_layers=2), params)
    assert all(p.requires_grad for p in tm.parameters())  # both biases train
    with torch.no_grad():
        got, h_n = tm(t(x), t(np.stack(h0)))
    assert_close("GRU outputs", got, ys, TOL_GRU)
    for i in range(2):
        assert_close(f"GRU final state {i}", h_n[i], finals[i], TOL_GRU)
    # the cell, and the port's weights back to the JAX tree bit-equal
    jc = jrnn.GRUCell(20)
    cparams = seeded_tree(jax.eval_shape(jc.init, jax.random.PRNGKey(0), h0[0], x[:, 0])
                          ["params"], 2)
    tc = load_jax_params(trnn.GRUCell(12, 20), cparams)
    with torch.no_grad():
        assert_close("GRUCell", tc(t(x[:, 0]), t(h0[0])),
                     jc.apply({"params": cparams}, h0[0], x[:, 0]), TOL_GRU)
    for tree, mod in ((params, tm), (cparams, tc)):
        back = state_dict_to_jax(mod)
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(back),
                                                        jax.tree_util.tree_leaves(tree)))


# -- the codecs --------------------------------------------------------------------------


def test_codecs_match_jax():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-1, 1, 100_000), np.linspace(-1.2, 1.2, 4001),
                        [-1.0, 0.0, 1.0, -0.0]]).astype(np.float32)
    for name in ("mulaw_encode", "raw_encode"):
        got, want = getattr(tmu, name)(t(x)).numpy(), np.asarray(getattr(jmu, name)(x))
        assert np.array_equal(got, want), name
    codes = np.arange(256)
    for name in ("mulaw_decode", "raw_decode"):
        assert_close(name, getattr(tmu, name)(t(codes)), getattr(jmu, name)(jnp.asarray(codes)),
                     TOL_DECODE)
    cont = np.linspace(-1, 1, 1001).astype(np.float32)  # continuous μ-law values
    assert_close("mulaw_decode continuous", tmu.mulaw_decode(t(cont)),
                 jmu.mulaw_decode(jnp.asarray(cont)), TOL_DECODE)


def test_mulaw_codes_differ_only_on_a_log1p_ulp():
    """Over a sweep of 2.3 million inputs the μ-law codes differ from JAX's only where
    XLA's fp32 log1p and PyTorch's differ by an ulp and x_mu lands on a truncation
    boundary: each such code is one step off, and the fp64 value sits within 1e-4 of
    the boundary (PERF.md §6, PR 14)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1, 1, 2_000_000).astype(np.float32),
                        np.linspace(-1.2, 1.2, 300_001, dtype=np.float32)])
    got, want = tmu.mulaw_encode(t(x)).numpy(), np.asarray(jmu.mulaw_encode(x))
    bad = np.flatnonzero(got != want)
    x64 = np.clip(x[bad].astype(np.float64), -1, 1)
    pos = (np.sign(x64) * np.log1p(255 * np.abs(x64)) / np.log1p(255.0) + 1) / 2 * 255 + 0.5
    print(f"\nparity mulaw_encode sweep: {len(bad)} of {len(x)} codes differ, each by "
          f"{np.abs(got[bad] - want[bad]).tolist()}, fp64 distance to the boundary "
          f"{np.abs(pos - np.round(pos)).tolist()}")
    assert len(bad) <= 5 and (np.abs(got[bad] - want[bad]) == 1).all()
    assert (np.abs(pos - np.round(pos)) < 1e-4).all()


# -- the heads ---------------------------------------------------------------------------


def head_inputs(name: str, seed: int):
    """(y_hat, y): MOL's log scales spread over [-9, 1], so that cdf_delta falls on both
    sides of 1e-5, and y with values beyond ±0.999 and at ±1."""
    rng = np.random.default_rng(seed)
    size = jheads.get_output_head(name).sample_size
    y_hat = rng.standard_normal((2, 64, size)).astype(np.float32)
    if name == "mol":
        y_hat[..., 10:20] = rng.uniform(-1, 1, (2, 64, 10))
        y_hat[..., 20:] = rng.uniform(-9, 1, (2, 64, 10))
    y = rng.uniform(-1, 1, (2, 64)).astype(np.float32)
    y[0, :8] = [-1.0, 1.0, -0.9995, 0.9995, -0.999, 0.999, 0.0, 0.5]
    return y_hat, y


@pytest.mark.parametrize("name", HEADS)
def test_head_losses_match_jax(name):
    y_hat, y = head_inputs(name, seed=2)
    want = float(jheads.get_output_head(name).loss(jnp.asarray(y_hat), jnp.asarray(y)))
    got = float(theads.get_output_head(name).loss(t(y_hat), t(y)))
    rel = abs(got - want) / abs(want)
    extra = ""
    if name == "mol":  # the branches the inputs reach
        inv = np.exp(-np.maximum(y_hat[..., 20:], np.log(1e-14)))
        c = y[..., None] - y_hat[..., 10:20]
        sig = lambda v: 1 / (1 + np.exp(-v))
        delta = sig(inv * (c + 1 / 65535)) - sig(inv * (c - 1 / 65535))
        n_mid = int((delta > 1e-5).sum())
        n_tail = int((np.abs(y) > 0.999).sum())
        extra = f" (cdf_delta > 1e-5: {n_mid} of {delta.size}; |y| > 0.999: {n_tail})"
        assert 0 < n_mid < delta.size and n_tail >= 4
    print(f"\nparity {name} loss: relative {rel:.3e} tol={TOL_LOSS:.0e}{extra}")
    assert rel <= TOL_LOSS


def test_mol_and_gaussian_samples_match_jax_draws():
    y_hat, _ = head_inputs("mol", seed=3)
    key = jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key)
    u = jax.random.uniform(k1, y_hat[..., :10].shape, minval=1e-5, maxval=1 - 1e-5)
    u2 = jax.random.uniform(k2, y_hat.shape[:-1], minval=1e-5, maxval=1.0 - 1e-5)
    for temp in (1.0, 0.7):
        want = jheads.MOLOutput().sample(jnp.asarray(y_hat), key, temperature=temp)
        got = theads.MOLOutput().sample(t(y_hat), noise=(t(u), t(u2)), temperature=temp)
        assert_close(f"mol sample (temperature {temp})", got, want, TOL_SAMPLE)
    g_hat, _ = head_inputs("gm", seed=5)
    z = jax.random.normal(key, g_hat[..., :1].shape)
    assert_close("gaussian sample", theads.GaussianOutput().sample(t(g_hat), noise=t(z)),
                 jheads.GaussianOutput().sample(jnp.asarray(g_hat), key), TOL_SAMPLE)
    # and from a generator: the right shapes, within [-1, 1] for MOL
    s = theads.MOLOutput().sample(t(y_hat), torch.Generator().manual_seed(0))
    assert s.shape == (2, 64) and float(s.abs().max()) <= 1.0


@pytest.mark.parametrize("name", ["mulaw", "raw"])
def test_softmax_samples_match_jax_gumbel(name):
    y_hat, _ = head_inputs(name, seed=6)
    key = jax.random.PRNGKey(7)
    g = jax.random.gumbel(key, y_hat.shape)
    want = np.asarray(jheads.get_output_head(name).sample(jnp.asarray(y_hat), key))
    got = theads.get_output_head(name).sample(t(y_hat), noise=t(g))
    # decoded codes: equal codes decode within the codec's limit, and two codes lie at
    # least 1e-5 apart after decoding
    assert_close(f"{name} sample (decoded codes)", got, want, TOL_DECODE)


def test_beta_samples_match_jax_moments():
    n = 20_000
    for a, b in ((2.0, 5.0), (0.6, 0.8)):
        y_hat = np.log(np.broadcast_to([a, b], (1, n, 2))).astype(np.float32)
        want = np.asarray(jheads.BetaOutput().sample(jnp.asarray(y_hat), jax.random.PRNGKey(8)),
                          np.float64).ravel()
        got = theads.BetaOutput().sample(t(y_hat), torch.Generator().manual_seed(8)).numpy()
        got = got.astype(np.float64).ravel()
        se_mean = np.sqrt(got.var() / n + want.var() / n)
        se_var = np.sqrt(np.var((got - got.mean()) ** 2) / n + np.var((want - want.mean()) ** 2) / n)
        print(f"\nparity beta({a}, {b}) samples: mean {got.mean():.5f} vs {want.mean():.5f} "
              f"({abs(got.mean() - want.mean()) / se_mean:.2f} SE), var {got.var():.5f} vs "
              f"{want.var():.5f} ({abs(got.var() - want.var()) / se_var:.2f} SE)")
        assert abs(got.mean() - want.mean()) <= 4 * se_mean
        assert abs(got.var() - want.var()) <= 4 * se_var
        assert got.min() >= -1.0 and got.max() <= 1.0


# -- WaveRNN -----------------------------------------------------------------------------


def wave_inputs(T_mel: int, seed: int):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((2, T_mel, 80)).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, (2, T_mel * UP)).astype(np.float32)
    x_low = rng.uniform(-0.5, 0.5, (2, T_mel * UP // UP_LOW)).astype(np.float32)
    return mel, x, x_low


def wavernn_pair(lowres: bool, output: str, seed: int):
    """(JAX WaveRNN, its seeded params, the port's WaveRNN holding them)."""
    kw = dict(SMALL, upsample=UP if lowres else UP // UP_LOW, upsample_low=UP_LOW,
              use_lowres=lowres, output=output)
    jm = jw.WaveRNN(jw.WaveRNNConfig(**kw))
    mel, x, x_low = wave_inputs(3, 0)
    args = (mel, x, x_low) if lowres else (mel, x_low)
    params = seeded_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)["params"], seed)
    return jm, params, load_jax_params(tw.WaveRNN(tw.WaveRNNConfig(**kw)), params)


def test_upsample_helpers_match_jax():
    x = np.random.default_rng(9).standard_normal((2, 7)).astype(np.float32)
    assert_close("linear_interp_upsample", tw.linear_interp_upsample(t(x), 10),
                 jw.linear_interp_upsample(jnp.asarray(x), 10), 1e-6)
    want = torch.nn.functional.interpolate(t(x)[:, None], 70, mode="linear").squeeze(1)
    assert_close("linear_interp_upsample vs F.interpolate", tw.linear_interp_upsample(t(x), 10),
                 want.numpy(), 1e-5)  # tests/test_wavernn.py's limit
    m = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    assert np.array_equal(tw.repeat_upsample(t(m), 5).numpy(),
                          np.asarray(jw.repeat_upsample(jnp.asarray(m), 5)))


@pytest.mark.parametrize("lowres", [True, False], ids=["hr", "lr"])
def test_wavernn_teacher_forced_matches_jax(lowres):
    jm, params, tm = wavernn_pair(lowres, "mol", seed=10)
    mel, x, x_low = wave_inputs(5, seed=11)
    if lowres:
        want = jm.apply({"params": params}, mel, x, x_low)
        with torch.no_grad():
            got = tm(t(mel), t(x), t(x_low))
    else:
        want = jm.apply({"params": params}, mel, x_low)
        with torch.no_grad():
            got = tm(t(mel), t(x_low))
    assert_close(f"WaveRNN {'hr' if lowres else 'lr'} teacher-forced logits", got, want,
                 TOL_LOGITS)
    assert ("cond" in params) == lowres and set(state_dict_to_jax(tm)) == set(params)


@pytest.mark.parametrize("output", ["mol", "mulaw"])
def test_sampler_logits_match_jax_teacher_forced(output):
    """The sampler's logits at each step against JAX's teacher-forced WaveRNN fed the
    port's own samples, shifted: every step saw [cond_t, the previous sample]."""
    jm, params, tm = wavernn_pair(True, output, seed=12)
    mel, _, x_low = wave_inputs(3, seed=13)
    audio, logits = tm.sample(t(mel), t(x_low), torch.Generator().manual_seed(1),
                              return_logits=True)
    assert audio.shape == (2, 3 * UP) and float(audio.abs().max()) <= 1.0
    want = jm.apply({"params": params}, mel, np.asarray(tw.CubenetVocoder.shift(audio)), x_low)
    assert_close(f"WaveRNN sampler logits ({output})", logits, want, TOL_LOGITS)
    # the draws come from the generator: the same seed gives the same audio
    again = tm.sample(t(mel), t(x_low), torch.Generator().manual_seed(1))
    assert torch.equal(again, audio)


LR = 1e-4  # VocoderConfig.lr
# The MOL loss's grads in fp32 are ill-conditioned in both packages: cdf_delta =
# σ(plus_in) − σ(min_in) cancels where it sits near its 1e-5 branch (the logistic's
# width at unit scale), so an ulp of difference between XLA's and PyTorch's sigmoid or
# exp reaches the grads amplified ~1e4, and near the branch fp32 and fp64 take other
# branches (fp64 "exact" grads sit 0.18-0.93 of a module's largest from both packages'
# at log-scale offsets -3 and -5). The two packages' MOL step grads differ by 4e-4 to
# 1.4e-3 of a module's largest (PERF.md §6, PR 14); the μ-law head, which has no
# cancellation, is held to GRAD_TOL. So the MOL step is held to its losses (2e-4), its
# parameters within 2 lr (the share beyond 0.01 lr printed, not held) and its grads to
# MOL_GRAD_TOL.
MOL_GRAD_TOL = 5e-3
VOC = dict(num_layers_lr=2, layer_size_lr=16, num_layers_hr=2, layer_size_hr=24,
           upsample=UP, upsample_low=UP_LOW)


def vocoder_pair(output: str, seed: int, T_mel: int = 6, gain: float = 1.0):
    """(JAX CubenetVocoder, seeded params, the port's holding them, a batch); `gain`
    scales both nets' output kernels, which scales the logits and the grads."""
    cfg = dict(VOC, output=output)
    jv = jw.CubenetVocoder(jw.VocoderConfig(**cfg))
    rng = np.random.default_rng(seed)
    batch = {"mel": rng.standard_normal((2, T_mel, 80)).astype(np.float32),
             "x": rng.uniform(-0.6, 0.6, (2, T_mel * UP)).astype(np.float32),
             "x_low": rng.uniform(-0.6, 0.6, (2, T_mel * UP // UP_LOW)).astype(np.float32)}
    shapes = jax.eval_shape(lambda: jv.init(jax.random.PRNGKey(0), *(jnp.asarray(batch[k])
                                                                     for k in ("mel", "x", "x_low"))))
    params = seeded_tree(shapes, seed)
    for net in ("hr", "lr"):
        params[net]["output"]["kernel"] *= gain
    tv = load_jax_params(tw.CubenetVocoder(tw.VocoderConfig(**cfg)), params)
    return jv, params, tv, batch


def test_infer_chunks_match_jax_teacher_forced():
    """`infer` on 8 frames in 4 chunks: the low-rate pass's logits against JAX's lr net
    on its samples, the high-rate pass's per chunk against JAX's hr net on the chunk's
    seeded inputs and samples; the seeds are the JAX function's (one frame of mel, one
    frame's worth of low-rate samples, from the previous chunk)."""
    jv, params, tv, _ = vocoder_pair("mol", seed=14)
    mel = np.random.default_rng(15).standard_normal((1, 8, 80)).astype(np.float32)
    x_low, audio, aux = tv.infer(t(mel), torch.Generator().manual_seed(2), num_chunks=4,
                                 return_logits=True)
    assert x_low.shape == (1, 8 * UP // UP_LOW) and audio.shape == (1, 8 * UP)
    want_lr = jv.lr_net.apply({"params": params["lr"]}, mel, np.asarray(tv.shift(x_low)))
    assert_close("infer lr logits", aux["lr_logits"], want_lr, TOL_LOGITS)
    per = UP // UP_LOW
    seeds = aux["low_seed"].numpy()
    assert np.array_equal(seeds[0, :per], np.zeros(per))
    xl = x_low.numpy().reshape(4, -1)
    assert np.array_equal(seeds[1:, :per], xl[:-1, -per:]) and np.array_equal(seeds[:, per:], xl)
    assert (aux["mel_seed"][0, 0] == -5.0).all()
    assert torch.equal(aux["mel_seed"][1:, 0], t(mel).reshape(4, 2, 80)[:-1, -1])
    want_hr = jv.hr.apply({"params": params["hr"]}, aux["mel_seed"].numpy(),
                          np.asarray(tv.shift(aux["audio_c"])), seeds)
    assert_close("infer hr logits (per chunk)", aux["hr_logits"], want_hr, TOL_LOGITS)
    assert torch.equal(audio, aux["audio_c"][:, UP:].reshape(1, -1))


# -- the vocoder's losses and step --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_step(output: str):
    jv = jw.CubenetVocoder(jw.VocoderConfig(**dict(VOC, output=output)))
    def step(s, b):
        with jrnn.unroll_override(1):
            return js.vocoder_train_step(jv, s, b)

    return jv, jax.jit(step)


def jax_state(jv, params):
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return js.SimpleState(params=params, opt_state=js._vocoder_tx(jv.config).init(params),
                          step=jnp.zeros((), jnp.int32))


def adam_mu(opt_state):
    return jax.device_get(opt_state[1][0].mu)


def step_grads(old, new):
    """The (clipped) grads of a step, from Adam's first moment: mu' = 0.9 mu + 0.1 g."""
    return jax.tree_util.tree_map(lambda m1, m0: (np.asarray(m1, np.float64) - 0.9 * np.asarray(
        m0, np.float64)) / 0.1, adam_mu(new.opt_state), adam_mu(old.opt_state))


def check_step(what, state, met, jold, jnew, jlosses, grad_tol=GRAD_TOL, share_limit=SHARE):
    model = state.model
    for k in ("hr", "lr", "loss"):
        rel = abs(float(met[k]) - float(jlosses[k])) / abs(float(jlosses[k]))
        assert rel <= TOL_LOSS, (what, k, rel)
    sd = jax_to_state_dict(model, step_grads(jold, jnew))
    got = {n: p.grad.double() for n, p in model.named_parameters()}
    g = grad_error(got, {n: sd[n].double() for n in got})
    new_sd = jax_to_state_dict(model, jax.device_get(jnew.params))
    worst, share, within = param_error({n: p.detach() for n, p in model.named_parameters()},
                                       {n: new_sd[n] for n in got}, LR)
    print(f"\nparity {what}: loss relative "
          f"{abs(float(met['loss']) - float(jlosses['loss'])) / float(jlosses['loss']):.3e}; "
          f"grads {g:.3e} of a module's largest (tol {grad_tol:.0e}); params max {worst:.3f} "
          f"lr, {share:.2e} beyond {SHARE_LR} lr")
    assert g <= grad_tol and within and share <= share_limit and state.step == int(jnew.step)


def global_norm(model) -> float:
    return float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.parameters())))


@pytest.mark.parametrize("output,gain", [("mol", 1.0), ("mulaw", 1.0), ("mulaw", 30.0)],
                         ids=["mol", "mulaw", "mulaw-clipped"])
def test_vocoder_losses_and_train_step_match_jax(output, gain):
    """The losses and a step; at gain 30 the global norm passes 5 and the clip acts.
    The MOL step's grads are held to MOL_GRAD_TOL (see MOL_GRAD_TOL)."""
    jv, params, tv, batch = vocoder_pair(output, seed=16, gain=gain)
    tb = {k: t(v) for k, v in batch.items()}
    want = jax.jit(jv.losses)(params, batch)
    with torch.no_grad():
        got = tv.losses(tb)
    for k in ("hr", "lr", "loss"):
        rel = abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
        print(f"\nparity vocoder {output} loss {k}: relative {rel:.3e} tol={TOL_LOSS:.0e}")
        assert rel <= TOL_LOSS
    jv, step = jax_step(output)
    jold = jax_state(jv, params)
    jnew, jlosses = step(jold, batch)
    state = ts.create_vocoder_state(tv)
    # the unclipped grads' norm: the clip at 5 acts on at least one head's step
    tv.zero_grad()
    tv.losses(tb)["loss"].backward()
    norm = global_norm(tv)
    state, met = ts.vocoder_train_step(state, tb)
    print(f"  global grad norm before the clip {norm:.3f} (clip {ts.VOCODER_CLIP}); after "
          f"{global_norm(tv):.3f}")
    mol = output == "mol"
    check_step(f"vocoder {output} train step", state, met, jold, jnew, jlosses,
               MOL_GRAD_TOL if mol else GRAD_TOL, 1.0 if mol else SHARE)
    assert (norm >= ts.VOCODER_CLIP) == (gain > 1)
    if norm >= ts.VOCODER_CLIP:
        assert abs(global_norm(tv) - ts.VOCODER_CLIP) < 1e-4


def test_clip_is_optax_global_norm():
    """`clip_global_norm` against optax's `clip_by_global_norm` on grads above and
    below the limit."""
    import optax

    rng = np.random.default_rng(17)
    for scale in (0.1, 10.0):
        grads = {"a": (scale * rng.standard_normal((5, 7))).astype(np.float32),
                 "b": (scale * rng.standard_normal(11)).astype(np.float32)}
        want, _ = optax.clip_by_global_norm(5.0).update(grads, optax.EmptyState())
        ps = [torch.nn.Parameter(t(v)) for v in grads.values()]
        for p, v in zip(ps, grads.values()):
            p.grad = t(v)
        ts.clip_global_norm(ps, 5.0)
        for p, k in zip(ps, grads):
            assert_close(f"clip_global_norm x{scale} {k}", p.grad, want[k], 1e-6)


def test_vocoder_opt_last_resumes_across_packages(tmp_path):
    """The μ-law head, so that the resumed steps are held at the full step limits."""
    jv, params, tv, batch = vocoder_pair("mulaw", seed=18)
    tb = {k: t(v) for k, v in batch.items()}
    jv, step = jax_step("mulaw")
    jst, _ = step(jax_state(jv, params), batch)
    jckpt.save_train_state(str(tmp_path / "j.opt.last"), jst)
    fresh = init_random(tw.CubenetVocoder(tw.VocoderConfig(**dict(VOC, output="mulaw"))), 99)
    resumed = ckpt.load_train_state(str(tmp_path / "j.opt.last"), ts.create_vocoder_state(fresh))
    assert resumed.step == 1
    st = ts.vocoder_train_step(ts.create_vocoder_state(tv), tb)[0]
    ckpt.save_train_state(str(tmp_path / "t.opt.last"), st)
    jres = jckpt.load_train_state(str(tmp_path / "t.opt.last"), jst)
    assert int(jres.step) == 1
    for what, port, jstate in (("JAX file, port step", resumed, jst),
                               ("port file, JAX step", st, jres)):
        jnext, jlosses = step(jstate, batch)
        port, met = ts.vocoder_train_step(port, tb)
        check_step(f"vocoder resume ({what})", port, met, jstate, jnext, jlosses)
    # a file of the other optimizer layout is refused, with nothing restored
    from ttscube_tpu_torch.train.states import create_phonemizer_state

    with pytest.raises(ValueError, match="holds no SimpleState"):
        ckpt.load_train_state(str(tmp_path / "j.opt.last"), create_phonemizer_state(fresh))
