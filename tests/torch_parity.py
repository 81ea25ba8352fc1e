"""Shared inputs of the port's model parity tests (tests/test_torch_*.py): the small
configurations, seeded batches and flax-initialised weights carried across by
ttscube_tpu_torch.convert."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttscube_tpu.models import hifigan as jhg
from ttscube_tpu.models.hifigan_fused import _plain_resblock1, _wn
from ttscube_tpu.models import languasito as jla
from ttscube_tpu.ops.conv import _conv, _conv_transpose
from ttscube_tpu_torch.convert import load_jax_params
from ttscube_tpu_torch.models import hifigan as thg
from ttscube_tpu_torch.models import languasito as tla

LANG = dict(num_phones=24, num_speakers=3, max_pitch=363.0, max_duration=31)
# the v1 tail stage (C = 32, kernel == stride == 4, all three MRF chains) behind two
# narrow upsample stages instead of four wide ones
SMALL_HIFI = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 4),
                  upsample_initial_channel=128)


@pytest.fixture
def exact_cpu_convs():
    """PyTorch's CPU convolutions without oneDNN. oneDNN's fp32 conv backward drifts by
    up to ~2e-3 relative on this suite's full-width generator (2e-2 on a bias grad of
    10, against 2e-6 with oneDNN off, both measured against the same graph in fp64),
    where JAX's fp32 grads sit at 1e-6; the gradient parity tests take the exact path.
    Use with `pytestmark = pytest.mark.usefixtures("exact_cpu_convs")` and import it."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def release_jax_caches():
    """Drops JAX's compiled executables when the module's tests end: a tier worker runs
    several files one after another, and the full-width Textcoder's steps would
    otherwise stay in its memory through them."""
    yield
    jax.clear_caches()


@contextlib.contextmanager
def torch_threads(n: int):
    """PyTorch's CPU ops on `n` threads, restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def one_cpu_thread():
    """PyTorch on one CPU thread. The tier's workers share the machine's cores; beside
    the other workers' XLA compiles, PyTorch's spinning pool threads made the 5 s
    D-then-G test take 375 s."""
    with torch_threads(1):
        yield


# The whole-step JAX comparisons' thread count. The count sets PyTorch's summation
# order, and in the 32-wide-tail step one input of the tail's first MRF conv sits
# 8.7e-9 from a leaky kink: on 1, 2 or 4 threads it lands on the other side and d up_3
# moves 17x the tolerance from JAX's; on 8 the worst grad sits at 0.4 of it
# (`step_thread_readings` below; PERF.md). Pinned, the outcome no longer depends on the
# machine's core count.
STEP_THREADS = 8


@pytest.fixture
def step_cpu_threads():
    with torch_threads(STEP_THREADS):
        yield


def t(x):
    return torch.from_numpy(np.asarray(x))


def assert_close(piece: str, got, want, atol: float) -> float:
    """Assert max |got − want| ≤ atol and print the measured difference, so that
    `pytest tests/test_torch_*.py -s | grep '^parity'` gives PERF.md's parity table."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (piece, got.shape, want.shape)
    diff = float(np.abs(got.astype(np.float64) - want).max()) if got.size else 0.0
    print(f"\nparity {piece}: max_abs_diff={diff:.3e} tol={atol:.1e}")
    assert diff <= atol, f"{piece}: max abs diff {diff:.3e} > {atol:.1e}"
    return diff


def assert_trees_equal(a, b):
    """Two nested dicts of arrays hold the same keys and bit-equal arrays of the same
    type and shape."""
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y)


# A step's grads and parameters against a reference step's (the mesh, the phonemizer and
# G2P trainers): each grad within GRAD_TOL of the largest grad of the module that holds it;
# after a first Adam step at most SHARE of the elements beyond SHARE_LR · lr, and none
# beyond 2 lr plus rounding (the first step moves each by about lr·sign(g), and a grad
# near zero may sum to the other sign in another order).
GRAD_TOL = 5e-6
SHARE, SHARE_LR = 1e-3, 0.01


def grad_error(got: dict, want: dict) -> float:
    """The largest grad difference in any module (a parameter name's first two parts:
    `lang.tower_g`, `gen.res_3_0`, `msd.s1`), over that module's largest grad."""
    assert got.keys() == want.keys()
    diff, scale = {}, {}
    for n, g in want.items():
        m = ".".join(n.split(".")[:2])
        diff[m] = max(diff.get(m, 0.0), float((torch.as_tensor(got[n]) - g).abs().max()))
        scale[m] = max(scale.get(m, 0.0), float(g.abs().max()))
    return max(diff[m] / max(scale[m], 1e-30) for m in diff)


def param_error(got: dict, want: dict, lr: float) -> tuple:
    """Parameters after a first step against the reference's: (largest difference in
    units of lr, the share of elements beyond SHARE_LR · lr, whether every element is
    within 2 lr plus the rounding of the two updates)."""
    worst, far, total, within = 0.0, 0, 0, True
    for n, w in want.items():
        d = (torch.as_tensor(got[n]) - w).abs()
        within &= bool((d <= 2 * lr + 2 * torch.from_numpy(
            np.spacing(w.abs().numpy().astype(np.float32)))).all())
        worst = max(worst, float(d.max()) / lr)
        far += int((d > SHARE_LR * lr).sum())
        total += d.numel()
    return worst, far / total, within


def random_params(module, *example, seed: int):
    """Seeded random weights for a flax module, shaped by `jax.eval_shape` of its init
    (no eager init: that compiles every scan). Weight-norm g = 1 (unit-norm rows) and
    small random biases (an LSTM cell's `b` among them), so that signals keep their
    scale through the generator;
    other kernels are scaled by 1/sqrt(fan-in)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *example)["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['g']"):
            return np.ones(x.shape, np.float32)
        if name.endswith("['scale']"):  # a LayerNorm's
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if name.endswith("['bias']") or name.endswith("['b']") or "['b_l" in name:
            return (0.05 * rng.standard_normal(x.shape)).astype(np.float32)
        scale = 1.0 if name.endswith("['embedding']") else 1.0 / np.sqrt(
            max(int(np.prod(x.shape[:-1])), 1))
        return (scale * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def seeded_tree(shapes, seed: int):
    """Seeded random values for a tree of shapes (a `jax.eval_shape` result): weight-norm
    g = 1, a norm's scale 1 + 0.1·N, other vectors (biases, a GRU's bi/bh, batch means)
    0.05·N, a batch variance 1 + 0.1·|N|, embeddings N, kernels N / sqrt(fan-in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['g']"):
            return np.ones(x.shape, np.float32)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if name.endswith("['var']"):
            return (1.0 + 0.1 * np.abs(rng.standard_normal(x.shape))).astype(np.float32)
        if len(x.shape) == 1:
            return (0.05 * rng.standard_normal(x.shape)).astype(np.float32)
        scale = 1.0 if name.endswith("['embedding']") else 1.0 / np.sqrt(
            max(int(np.prod(x.shape[:-1])), 1))
        return (scale * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def text_batch(B=2, N=21, seed=0):
    rng = np.random.default_rng(seed)
    x_char = np.zeros((B, N), np.int32)
    for b in range(B):
        n = N - 6 * b
        x_char[b, :n] = rng.integers(1, LANG["num_phones"] + 1, n)
    return {"x_char": x_char, "x_speaker": rng.integers(1, 4, (B, 1)).astype(np.int32)}


def gen_pair(hifi: dict, seed: int):
    jcfg = jhg.HifiganConfig(**hifi)
    jg = jhg.Generator(jcfg)
    params = random_params(jg, jnp.zeros((1, 4, 80)), seed=seed)
    tg = load_jax_params(thg.Generator(thg.HifiganConfig(**hifi)), params).eval()
    return jcfg, jg, params, tg


def lang_pair_of(frames: int):
    """A JAX Languasito2 with seeded random weights, its port with the same weights,
    and a batch."""
    jm = jla.Languasito2(jla.LanguasitoConfig(**LANG))
    X = text_batch()
    init = dict(X, y_frame2phone=np.zeros((2, frames), np.int32),
                y_pitch=np.zeros((2, frames), np.float32))
    params = random_params(jm, init, seed=0)
    tm = load_jax_params(tla.Languasito2(tla.LanguasitoConfig(**LANG)), params).eval()
    return jm, params, tm, X


def jax_tail_stage(c, compute_dtype=None):
    """The generator's final stage in plain JAX ops, rounding where the TPU kernel
    `fused_tail_stage` rounds: every conv operand cast to `compute_dtype`, fp32
    accumulation, residuals and chain mean. `c` holds z (B, T_in, C_in) and the
    stage's weights in JAX layouts: up (4, C, C_in), up_b, kernels and biases in
    chain order, post (7, C, 1), post_b."""
    cd = (lambda a: a.astype(compute_dtype)) if compute_dtype else (lambda a: a)
    x = _conv_transpose(cd(jax.nn.leaky_relu(jnp.asarray(c["z"]), 0.1)),
                        cd(jnp.asarray(c["up"])), c["up"].shape[0], 0) + c["up_b"]
    acc, i = None, 0
    for k, dils in zip(c["ks"], c["dils"]):
        n = 2 * len(dils)
        h = _plain_resblock1(x, [jnp.asarray(w) for w in c["kernels"][i:i + n]],
                             c["biases"][i:i + n], dils, compute_dtype=compute_dtype)
        acc = h if acc is None else acc + h
        i += n
    y = jax.nn.leaky_relu(acc / len(c["ks"]), 0.01)
    return np.asarray(jnp.tanh(_conv(cd(y), cd(jnp.asarray(c["post"])), 1, 3, 1, 1)
                               + c["post_b"]))[..., 0]


def jax_tail_case(params, cfg, z):
    """`jax_tail_stage`'s input for the last stage of a JAX generator: its weights from
    the parameter tree `params` of config `cfg`, and z (the stage's input)."""
    i = len(cfg.upsample_rates) - 1
    convs = [params[f"res_{i}_{j}"][f"WNConv1d_{m}"]
             for j, d in enumerate(cfg.resblock_dilation_sizes) for m in range(2 * len(d))]
    return dict(z=np.asarray(z, np.float32), up=np.asarray(_wn(params[f"up_{i}"])),
                up_b=np.asarray(params[f"up_{i}"]["bias"]),
                kernels=[np.asarray(_wn(p)) for p in convs],
                biases=[np.asarray(p["bias"]) for p in convs],
                post=np.asarray(_wn(params["conv_post"])),
                post_b=np.asarray(params["conv_post"]["bias"]),
                ks=tuple(cfg.resblock_kernel_sizes),
                dils=tuple(tuple(d) for d in cfg.resblock_dilation_sizes))


# -- the GAN training step ---------------------------------------------------------------

TRAIN_LANG = dict(num_phones=30, num_speakers=3, max_pitch=400, max_duration=100)
# tests/test_cubegan.py's tiny generator; with upsample_initial_channel=512 its last
# stage is 32 wide and takes the fused tail (FusedTailStageGrad) under fused_tail_train
TINY_HIFI = dict(upsample_rates=(5, 3, 4, 4), upsample_kernel_sizes=(16, 16, 4, 4),
                 upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                 resblock_dilation_sizes=((1, 3),))
TAIL32_HIFI = dict(TINY_HIFI, upsample_initial_channel=512, fused_tail_train=True)
TRAIN_DISC = dict(mpd_channels=(8, 16), msd_width=8)


def toy_train_batch(B=2, N=16, F=60, seed=0):
    """tests/test_cubegan.py's toy batch, as numpy arrays."""
    from ttscube_tpu.ops.length_regulator import durations_to_frame2phone_np

    rng = np.random.default_rng(seed)
    x_char = np.zeros((B, N), np.int32)
    durs = np.zeros((B, N), np.int32)
    n_valid = np.array([N - (5 if b % 2 else 0) for b in range(B)])
    for b in range(B):
        x_char[b, : n_valid[b]] = rng.integers(1, 30, n_valid[b])
        durs[b, : n_valid[b]] = rng.integers(2, 6, n_valid[b])
    f2p, fmask = durations_to_frame2phone_np(durs, n_valid, F)
    pitch = (rng.uniform(80, 300, (B, F)) * np.asarray(fmask)).astype(np.float32)
    audio = (0.2 * rng.standard_normal((B, F * 240))).astype(np.float32)
    return {"x_char": x_char, "x_speaker": rng.integers(1, 3, (B, 1)).astype(np.int32),
            "y_frame2phone": np.asarray(f2p, np.int32), "y_frame_mask": np.asarray(fmask),
            "y_pitch": pitch, "y_dur": durs, "y_audio": audio,
            "n_frames": np.asarray(fmask, np.int32).sum(axis=1).astype(np.int32)}


def train_pair(hifi: dict, batch: dict, seed: int, lang: dict = TRAIN_LANG,
               lm: dict | None = None):
    """A JAX Cubegan and TrainState with seeded random parameters and spectral u (no
    flax init: shapes from `jax.eval_shape`), and the port's Cubegan(train=True) holding
    the same parameters and u. `lang` is the LanguasitoConfig's fields; `lm`, where
    given, an LMConfig's: both models then hold an HF encoder (`hf`)."""
    from ttscube_tpu.models import cubegan as jcg
    from ttscube_tpu.models import lm as jlm
    from ttscube_tpu_torch.models import cubegan as tcg
    from ttscube_tpu_torch.models import lm as tlm

    jcfg = jcg.CubeganConfig(languasito=jla.LanguasitoConfig(**lang),
                             hifigan=jhg.HifiganConfig(**hifi), **TRAIN_DISC)
    jm = jcg.Cubegan(jcfg, lm=None if lm is None else jlm.TransformerEncoder(
        jlm.LMConfig(**lm)))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['g']"):
            return np.ones(x.shape, np.float32)
        if name.endswith("['scale']"):  # a LayerNorm's
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if name.endswith("['u']"):
            return rng.standard_normal(x.shape).astype(np.float32)
        if name.endswith("['bias']") or "['b_l" in name:
            return (0.05 * rng.standard_normal(x.shape)).astype(np.float32)
        scale = 1.0 if name.endswith("['embedding']") else 1.0 / np.sqrt(
            max(int(np.prod(x.shape[:-1])), 1))
        return (scale * rng.standard_normal(x.shape)).astype(np.float32)

    params, spectral = jax.tree_util.tree_map_with_path(leaf, shapes)
    txs = jcg.make_optimizer(jcfg)
    jstate = jcg.TrainState(params=params,
                            opt_state={k: tx.init(params) for k, tx in txs.items()},
                            spectral=spectral, step=jnp.zeros((), jnp.int32))
    tcfg = tcg.CubeganConfig(languasito=tla.LanguasitoConfig(**lang),
                             hifigan=thg.HifiganConfig(**hifi), **TRAIN_DISC)
    tm = load_jax_params(tcg.Cubegan(tcfg, train=True, lm_config=None if lm is None else
                                     tlm.LMConfig(**lm)), params, {"msd": spectral})
    return jm, jstate, tm


def jax_crop_starts(n_frames, window: int, rng):
    """The window starts the JAX `Cubegan._crop` draws from `rng`."""
    n_frames = jnp.asarray(n_frames)
    max_start = jnp.maximum(n_frames - window - 1, 0)
    r = jax.random.randint(rng, (n_frames.shape[0],), 0, jnp.maximum(max_start, 1))
    return np.asarray(jnp.minimum(r, max_start))


# -- the whole-step comparison's thread dependence (PERF.md) ------------------------------

class _LeakyInputs(torch.overrides.TorchFunctionMode):
    """Records the input of every F.leaky_relu call made under it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.nn.functional.leaky_relu:
            self.seen.append(args[0].detach())
        return func(*args, **(kwargs or {}))


def _port_step(tm, batch, starts):
    """The port's train step from `tm`'s weights: its grads by name, and the tail's
    input z, weights and audio cotangent as FusedTailStageGrad.backward got them."""
    import copy

    from ttscube_tpu_torch.models import cubegan as tcg
    from ttscube_tpu_torch.ops import fused_tail

    m, seen = copy.deepcopy(tm), {}
    backward = fused_tail.FusedTailStageGrad.backward

    def record(ctx, daudio):
        seen.update(saved=[x.detach().clone() for x in ctx.saved_tensors], spec=ctx.spec,
                    dy=daudio.detach().clone())
        return backward(ctx, daudio)

    fused_tail.FusedTailStageGrad.backward = staticmethod(record)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            tcg.train_step(tcg.create_train_state(m), tcg.batch_to_torch(batch, "cpu"),
                           starts=starts)
    finally:
        fused_tail.FusedTailStageGrad.backward = backward
    return {n: p.grad for n, p in m.named_parameters() if p.grad is not None}, seen


def _tail64(saved, spec, dy):
    """The tail stage in fp64 from the saved z and weights: (the grads, the inputs of
    its leaky activations)."""
    from ttscube_tpu_torch.ops import fused_tail

    leaves = [x.double().requires_grad_() for x in saved]
    z, up, ub, pk, pb, *kb = leaves
    n = len(kb) // 2
    w = fused_tail.pack_tail_weights(up, ub, kb[:n], kb[n:], pk, pb, kernel_sizes=spec[0],
                                     dilations=spec[1], dtype=torch.float64)
    with _LeakyInputs() as mode:
        out = fused_tail.fused_tail_stage_plain(z, w)
    return torch.autograd.grad(out, leaves, dy.double()), mode.seen


def step_thread_readings(threads=(1, 2, 4, 8), seed=1):
    """tests/test_torch_train.py's 32-wide-tail step at several PyTorch thread counts.
    Prints, per count, the worst grad's distance from JAX's in units of rtol = atol =
    2e-4; against the last count, the tail's leaky inputs (recomputed in fp64) whose
    sign differs, and what swapping in the other count's z alone does to d up_3."""
    from ttscube_tpu.models import cubegan as jcg
    from ttscube_tpu_torch.convert import jax_to_state_dict
    from tests.test_torch_train import _first_step_grads

    def units(a, b):
        a, b = a.double(), b.double()
        return float(((a - b).abs() / (2e-4 + 2e-4 * b.abs())).max())

    batch = toy_train_batch(seed=seed)
    jm, jstate, tm = train_pair(TAIL32_HIFI, batch, seed)
    rng = jax.random.PRNGKey(seed)
    starts = torch.from_numpy(jax_crop_starts(batch["n_frames"], min(jcg.TRAIN_FRAMES, 60),
                                              jax.random.fold_in(rng, 0)))
    jnew, _ = jax.jit(lambda s, b, r: jcg.train_step(jm, s, b, r))(jstate, batch, rng)
    want = jax_to_state_dict(tm, _first_step_grads(jnew.opt_state))
    runs = {}
    for n in threads:
        with torch_threads(n):
            grads, seen = runs[n] = _port_step(tm, batch, starts)
        worst, name = max((units(g, want[k]), k) for k, g in grads.items())
        print(f"threads={n}: worst grad {worst:.3f} of the tolerance from JAX's ({name})")
    last = runs[threads[-1]][1]
    base, acts = _tail64(last["saved"], last["spec"], last["dy"])
    for n in threads[:-1]:
        z = runs[n][1]["saved"][0]
        grads, other = _tail64([z, *last["saved"][1:]], last["spec"], last["dy"])
        flips = [(i, float(a[(a > 0) != (b > 0)].abs().max()))
                 for i, (a, b) in enumerate(zip(other, acts)) if ((a > 0) != (b > 0)).any()]
        print(f"threads={n} vs {threads[-1]}: z differs by "
              f"{float((z - last['saved'][0]).abs().max()):.2e}; leaky inputs of the other "
              f"sign (input, |value|): {flips}; with this z alone d up_3 moves "
              f"{units(grads[1], base[1]):.3f} of the tolerance")


if __name__ == "__main__":
    step_thread_readings()
