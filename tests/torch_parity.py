"""Shared inputs of the port's model parity tests (tests/test_torch_*.py): the small
configurations, seeded batches and flax-initialised weights carried across by
ttscube_tpu_torch.convert."""

import jax
import jax.numpy as jnp
import numpy as np
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


def random_params(module, *example, seed: int):
    """Seeded random weights for a flax module, shaped by `jax.eval_shape` of its init
    (no eager init: that compiles every scan). Weight-norm g = 1 (unit-norm rows) and
    small random biases, so that signals keep their scale through the generator;
    other kernels are scaled by 1/sqrt(fan-in)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *example)["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['g']"):
            return np.ones(x.shape, np.float32)
        if name.endswith("['bias']") or "['b_l" in name:
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
