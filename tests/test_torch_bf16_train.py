"""bf16 GAN training in the port (`compute_dtype="bfloat16"` in the generator,
`disc_compute_dtype="bfloat16"` in the discriminators) against the JAX package on the
CPU: the discriminators' convs, one whole train step, and the trainer CLI.

Limits, by the repo's bf16 rule (ROADMAP.md ground rules): the floor is the JAX bf16
result against the JAX fp32 one on the same inputs; the port's bf16 result must sit
within BF16_RMS of the floor's RMS and BF16_MAX of its max from JAX's bf16 result, and
the port's fp32 result (the control) must not. The step's parameters are held in units
of the learning rate as in tests/test_torch_train.py: within 2·lr plus rounding, and at
most 0.1 % of them beyond 0.01·lr; the control must exceed that share.

JAX's jitted step is compiled with `xla_allow_excess_precision` off. With it on (XLA's
default) the CPU compiler may drop a bf16 rounding that the JAX code asks for (an
`astype(bfloat16)` followed by an `astype(float32)`), and the jitted step then sits
about one floor from the same code run op by op; with it off the two agree, and the
port is held to what the code says."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ttscube_tpu.models import cubegan as jcg
from ttscube_tpu.models import hifigan as jhg
from ttscube_tpu.ops import conv as jconv
from ttscube_tpu_torch import convert
from ttscube_tpu_torch.convert import jax_to_state_dict, spectral_to_jax
from ttscube_tpu_torch.models import cubegan as tcg
from ttscube_tpu_torch.models import hifigan as thg
from ttscube_tpu_torch.ops import conv as tconv
from tests.test_torch_train import _first_step_grads
from tests.torch_parity import (TINY_HIFI, TRAIN_DISC, exact_cpu_convs,  # noqa: F401
                                jax_crop_starts, one_cpu_thread, random_params,
                                toy_train_batch, train_pair)

# PyTorch on one thread beside the tier's other workers (tests/torch_parity.py)
pytestmark = pytest.mark.usefixtures("exact_cpu_convs", "one_cpu_thread")

BF16_RMS = 0.5
BF16_MAX = 1.0


def _dist(a, b) -> tuple:
    """(max, RMS) of |a − b| over all elements, in fp64."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()), float(np.sqrt(np.mean(d * d)))


def _floor_rule(what: str, floor, err, ctl) -> None:
    within = lambda d: d[0] <= BF16_MAX * floor[0] and d[1] <= BF16_RMS * floor[1]
    print(f"\nparity {what} bf16: max {err[0]:.3e} rms {err[1]:.3e} ({err[0] / floor[0]:.3f}, "
          f"{err[1] / floor[1]:.3f} of the floor max {floor[0]:.3e} rms {floor[1]:.3e}); "
          f"control ({ctl[0] / floor[0]:.3f}, {ctl[1] / floor[1]:.3f})")
    assert floor[0] > 0, f"{what}: bf16 did not move JAX's result"
    assert within(err), f"{what}: {err} not within the floor rule of {floor}"
    assert not within(ctl), f"{what}: the fp32 control passed"


def _flat(tensors) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float64).reshape(-1) for x in tensors])


# -- the discriminators' convs --------------------------------------------------------------

def _wnconv2d(cd):
    return (jconv.WNConv2d(8, (5, 1), strides=(3, 1), padding=(2, 0), compute_dtype=cd),
            lambda tcd: tconv.WNConv2d(4, 8, (5, 1), (3, 1), (2, 0), compute_dtype=tcd),
            (2, 61, 3, 4), "nhwc")


def _snconv1d(groups):
    def make(cd):
        return (jconv.SNConv1d(16, kernel_size=41, stride=2, padding=20, groups=groups,
                               compute_dtype=cd),
                lambda tcd: tconv.SNConv1d(8, 16, 41, 2, 20, groups, compute_dtype=tcd),
                (2, 300, 8), "nwc")
    return make


def _disc_p(cd):
    return (jhg.DiscriminatorP(3, channels=(8, 16), compute_dtype=cd),
            lambda tcd: thg.DiscriminatorP(3, (8, 16), tcd), (2, 1201), "disc_p")


def _disc_s(spectral):
    def make(cd):
        return (jhg.DiscriminatorS(spectral, width=8, compute_dtype=cd),
                lambda tcd: thg.DiscriminatorS(spectral, 8, tcd), (2, 1201), "disc_s")
    return make


def _outputs(out, layout):
    """A module's outputs as one list of arrays in the JAX layout."""
    if layout == "nhwc":
        return [out.permute(0, 2, 3, 1) if isinstance(out, torch.Tensor) else out]
    if layout == "nwc":
        return [out]
    score, fmap = out
    if layout == "disc_p" and isinstance(score, torch.Tensor):
        fmap = [f.permute(0, 2, 3, 1) for f in fmap]
    return [score, *fmap]


@pytest.mark.parametrize("make", [_wnconv2d, _snconv1d(1), _snconv1d(4), _disc_p,
                                  _disc_s(False), _disc_s(True)],
                         ids=["WNConv2d", "SNConv1d g1", "SNConv1d g4", "DiscriminatorP",
                              "DiscriminatorS", "DiscriminatorS spectral"])
def test_bf16_discriminator_convs_match_jax(make, request):
    """Forward, input grad and parameter grads in bf16 against JAX's (op by op), by the
    floor rule; the spectral u and the power iteration stay fp32."""
    jm32, tmake, shape, layout = make(None)
    jm16 = make(jnp.bfloat16)[0]
    rng = np.random.default_rng(sum(shape))
    x = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    variables = jax.eval_shape(jm32.init, jax.random.PRNGKey(0), x)
    params = random_params(jm32, x, seed=1)
    spectral = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        variables.get("spectral", {}))
    res = {}
    for cd, jm in ((None, jm32), (torch.bfloat16, jm16)):
        f = lambda p, xx: jnp.concatenate([o.reshape(-1) for o in _outputs(
            jm.apply({"params": p, "spectral": spectral}, xx), layout)])
        y, vjp = jax.vjp(f, params, x)
        dy = np.random.default_rng(7).standard_normal(y.shape).astype(np.float32)
        gp, gx = vjp(dy)
        tm = convert.load_jax_params(tmake(cd), params, spectral or None)
        xt = torch.from_numpy(x if layout != "nhwc" else x.transpose(0, 3, 1, 2).copy())
        xt.requires_grad_()
        yt = torch.cat([o.reshape(-1) for o in _outputs(tm(xt), layout)])
        yt.backward(torch.from_numpy(dy))
        gxt = xt.grad.permute(0, 2, 3, 1) if layout == "nhwc" else xt.grad
        res[cd] = dict(jax=(np.asarray(y), np.asarray(gx),
                            _flat(jax.tree_util.tree_leaves(gp))),
                       port=(yt.detach().numpy(), gxt.numpy(), _flat(jax.tree_util.tree_leaves(
                           convert.state_dict_to_jax(tm, {n: p.grad for n, p in
                                                          tm.named_parameters()})))))
        assert all(p.dtype == torch.float32 for p in tm.parameters())
    name = request.node.callspec.id
    for i, what in enumerate(("output", "input grad", "parameter grads")):
        j16, j32 = res[torch.bfloat16]["jax"][i], res[None]["jax"][i]
        _floor_rule(f"{name} {what}", _dist(j16, j32), _dist(res[torch.bfloat16]["port"][i], j16),
                    _dist(res[None]["port"][i], j16))


def test_rounded_cpu_conv_rounds_once():
    """The CPU route of a bf16 conv (`ops/conv._RoundedConv`): its result is the fp32
    conv of the bf16 operands rounded once to bf16, and its grads are the fp32 grads
    of the rounded operands for the cotangent rounded to bf16, each rounded once: where
    XLA rounds. PyTorch's own bf16 conv on the CPU without oneDNN differs from that."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 16, 300)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((32, 4, 41)) / 20).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 32, 300)).astype(np.float32))
    xb, wb = (a.bfloat16().requires_grad_() for a in (x, w))
    conv = functools.partial(torch.nn.functional.conv1d, padding=20, groups=4)
    y = tconv._RoundedConv.apply(xb, wb, conv, {})
    y.float().backward(dy)
    x32, w32 = (a.detach().float().requires_grad_() for a in (xb, wb))
    y32 = conv(x32, w32)
    y32.backward(dy.bfloat16().float())
    assert y.dtype == xb.grad.dtype == wb.grad.dtype == torch.bfloat16
    for got, want in ((y, y32), (xb.grad, x32.grad), (wb.grad, w32.grad)):
        assert torch.equal(got, want.bfloat16())
    assert not torch.equal(conv(xb.detach(), wb.detach()), y)


# -- the train step ---------------------------------------------------------------------

def _jit_exact(fn, *args):
    """`jax.jit(fn)(*args)`, compiled to round wherever the JAX code rounds (see the
    module docstring)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _bf16(config):
    return dataclasses.replace(config, hifigan=dataclasses.replace(
        config.hifigan, compute_dtype="bfloat16"), disc_compute_dtype="bfloat16")


def test_bf16_train_step_matches_jax_within_floor():
    """tests/test_cubegan.py's tiny config with bf16 generator and discriminator convs:
    one step of the port against JAX's from the same parameters, u, batch and crop
    offsets. Losses (relative to JAX's fp32 step), grads and parameters by the floor
    rule; every parameter, grad and Adam moment stays fp32."""
    seed = 0
    batch = toy_train_batch(seed=seed)
    jm32, jstate, tm = train_pair(TINY_HIFI, batch, seed)
    jm16 = jcg.Cubegan(_bf16(jm32.config))
    rng = jax.random.PRNGKey(seed)
    starts = torch.from_numpy(jax_crop_starts(batch["n_frames"], min(jcg.TRAIN_FRAMES, 60),
                                              jax.random.fold_in(rng, 0)))
    jax_runs = {k: _jit_exact(lambda s, b, r, m=m: jcg.train_step(m, s, b, r), jstate, batch, rng)
                for k, m in (("32", jm32), ("16", jm16))}
    port_runs = {}
    for k, cfg in (("32", tm.config), ("16", _bf16(tm.config))):
        m = tcg.Cubegan(cfg, train=True)
        m.load_state_dict(tm.state_dict())
        st = tcg.create_train_state(m)
        _, met = tcg.train_step(st, tcg.batch_to_torch(batch, "cpu"), starts=starts)
        port_runs[k] = (st, {n: v.item() for n, v in met.items()})
    keys = sorted(jax_runs["32"][1])
    ref = np.array([abs(float(jax_runs["32"][1][k])) for k in keys])
    rel = lambda met: np.array([float(met[k]) for k in keys]) / ref
    j16, j32 = rel(jax_runs["16"][1]), rel(jax_runs["32"][1])
    _floor_rule("train_step losses (relative)", _dist(j16, j32),
                _dist(rel(port_runs["16"][1]), j16), _dist(rel(port_runs["32"][1]), j16))

    st16, st32 = port_runs["16"][0], port_runs["32"][0]
    names = [n for n, p in st16.model.named_parameters() if p.requires_grad]
    jgrads = {k: jax_to_state_dict(tm, _first_step_grads(jax_runs[k][0].opt_state))
              for k in ("16", "32")}
    grads = lambda st: _flat([st.model.get_parameter(n).grad if st.model.get_parameter(n).grad
                              is not None else torch.zeros_like(st.model.get_parameter(n))
                              for n in names])
    jflat = {k: _flat([jgrads[k][n] for n in names]) for k in ("16", "32")}
    _floor_rule("train_step grads", _dist(jflat["16"], jflat["32"]),
                _dist(grads(st16), jflat["16"]), _dist(grads(st32), jflat["16"]))

    lr = tm.config.lr
    want = jax_to_state_dict(tm, jax.tree_util.tree_map(np.asarray, jax_runs["16"][0].params))
    counts = {}
    for k, st in (("port", st16), ("control", st32)):
        over = far = total = 0
        for n in names:
            w = want[n]
            d = (st.model.get_parameter(n).detach() - w).abs()
            spacing = torch.nextafter(w.abs(), torch.tensor(float("inf"))) - w.abs()
            over += int((d > 2 * lr + 2 * spacing).sum())
            far += int((d > 0.01 * lr).sum())
            total += d.numel()
        counts[k] = (over, far, total)
    print(f"\nparity train_step bf16 params: {counts['port'][1]} of {counts['port'][2]} beyond "
          f"0.01 lr (limit 0.1 %); control {counts['control'][1]}")
    assert counts["port"][0] == 0 and counts["port"][1] <= 1e-3 * counts["port"][2]
    assert counts["control"][1] > 1e-3 * counts["control"][2], "the fp32 control passed"
    u = spectral_to_jax(st16.model)["msd"]
    worst_u = max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(
        jax.tree_util.tree_leaves(u), jax.tree_util.tree_leaves(jax_runs["16"][0].spectral)))
    assert worst_u <= 1e-5
    assert all(p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
               for p in st16.model.parameters())
    moments = [v for opt in st16.optimizers.values() for s in opt.state.values()
               for v in s.values() if isinstance(v, torch.Tensor) and v.dim() > 0]
    assert moments and all(v.dtype == torch.float32 for v in moments)


# -- the trainer CLI ----------------------------------------------------------------------

@pytest.fixture
def bf16_cli(tmp_path, monkeypatch):
    """The CLI on the tiny config (its config class narrowed here), on a 4-utterance
    corpus in the JAX import format, run in `tmp_path`."""
    from tests.test_data import make_corpus
    from ttscube_tpu_torch.scripts import train_cubegan as cli

    make_corpus(tmp_path / "corpus", n=4)
    monkeypatch.setattr(tcg, "CubeganConfig", functools.partial(
        tcg.CubeganConfig, hifigan=thg.HifiganConfig(**TINY_HIFI), **TRAIN_DISC))
    monkeypatch.chdir(tmp_path)
    base = str(tmp_path / "out" / "cubegan")
    args = ["--train-folder", str(tmp_path / "corpus"), "--dev-folder",
            str(tmp_path / "corpus"), "--output-base", base, "--batch-size", "2",
            "--epoch-generation", "0", "--device", "cpu"]
    return cli, args, tmp_path / "corpus", base


def test_cli_trains_bf16_and_resumes(bf16_cli):
    """`--compute-dtype bfloat16` trains two steps with bf16 convs and fp32 state, and
    `--resume` restores it bit-equal; with `--fused-tail-train` the flags are refused."""
    from ttscube_tpu_torch.data.collate import CubeganCollate
    from ttscube_tpu_torch.data.datasets import CubeganDataset
    from ttscube_tpu_torch.data.encodings import CubeganEncodings

    cli, args, corpus, base = bf16_cli
    live = cli.main(args + ["--compute-dtype", "bfloat16", "--max-steps", "2"])
    cfg = live.model.config
    assert live.step == 2 and cfg.hifigan.compute_dtype == cfg.disc_compute_dtype == "bfloat16"
    assert cfg.hifigan.upsample_initial_channel == TINY_HIFI["upsample_initial_channel"]
    assert live.model.gen.conv_pre.compute_dtype == live.model.msd.s0.conv_0.compute_dtype \
        == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in live.model.parameters())
    resumed = cli.main(args + ["--compute-dtype", "bfloat16", "--max-steps", "2", "--resume",
                               "--max-epochs", "0"])
    assert resumed.step == 2 and resumed.model.config == cfg
    sa, sb = live.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(v, sb[k]) for k, v in sa.items())
    # the next step from each, on the same batch and windows: bit-equal
    ds = CubeganDataset(str(corpus))
    collate = CubeganCollate(CubeganEncodings(base + ".encodings"))
    batch = tcg.batch_to_torch(collate([ds[i] for i in range(2)]), "cpu")
    _, m_live = tcg.train_step(live, batch)
    _, m_back = tcg.train_step(resumed, batch)
    assert all(torch.equal(v, m_back[k]) for k, v in m_live.items())
    assert all(torch.equal(p, q) for p, q in zip(live.model.parameters(),
                                                 resumed.model.parameters()))
    with pytest.raises(SystemExit):
        cli.main(args + ["--compute-dtype", "bfloat16", "--fused-tail-train"])
