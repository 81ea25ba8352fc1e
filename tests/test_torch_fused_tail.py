"""The fused tail stage of the port (`ttscube_tpu_torch.ops.fused_tail`) against the
JAX package: its plain PyTorch version against the JAX stage computed without the
kernel, on the CPU, and once (slow tier) against the Pallas kernel in interpret mode.
The CUDA kernel itself is held against the plain version in tests/test_torch_gpu.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ttscube_tpu_torch.ops import fused_tail
from tests.torch_parity import assert_close, jax_tail_stage

KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3
C_IN, C, FOLD = 64, 32, 4


def _case(B, T_in, seed):
    """Weights in JAX layouts (numpy) and z, at the v1 tail widths."""
    rng = np.random.default_rng(seed)
    n = lambda scale, *s: (scale * rng.standard_normal(s)).astype(np.float32)
    up = n(0.5 / np.sqrt(C_IN), FOLD, C, C_IN)             # (k, out, in)
    kernels = [n(0.5 / np.sqrt(k * C), k, C, C) for k in KS for _ in range(6)]
    biases = [n(0.1, C) for _ in range(18)]
    return dict(z=n(1.0, B, T_in, C_IN), up=up, up_b=n(0.1, C), kernels=kernels,
                biases=biases, post=n(0.3, 7, C, 1), post_b=np.asarray([0.05], np.float32),
                ks=KS, dils=DILS)


def _torch_args(c, compute_dtype=None, device="cpu"):
    """z and the packed weights, from the JAX layouts (k, a, b) → PyTorch (b, a, k)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    tr = lambda a: t(np.transpose(a, (2, 1, 0)))
    w = fused_tail.pack_tail_weights(
        tr(c["up"]), t(c["up_b"]), [tr(w) for w in c["kernels"]],
        [t(b) for b in c["biases"]], tr(c["post"]), t(c["post_b"]),
        kernel_sizes=KS, dilations=DILS, compute_dtype=compute_dtype)
    return t(c["z"]), w


@pytest.mark.parametrize("B,T_in", [(1, 128), (2, 301)])
def test_plain_tail_matches_jax_fp32(B, T_in):
    c = _case(B, T_in, seed=T_in)
    want = jax_tail_stage(c)
    got = fused_tail.fused_tail_stage(*_torch_args(c))  # CPU tensor → the plain version
    assert got.shape == want.shape == (B, FOLD * T_in)
    assert_close(f"fused tail plain fp32 B={B} T_in={T_in}", got, want, 5e-5)


def test_plain_tail_matches_jax_bf16():
    """bf16 operands, fp32 accumulation and residuals on both sides. The two sum in
    different orders, so now and then a bf16 rounding of an intermediate lands one
    bf16 step apart, and the step travels down the chain of 18 convs. The bound is half
    the distance bf16 operands put between this stage and its fp32 result (the
    precision floor); measured here: an eighth of it."""
    c = _case(2, 200, seed=7)
    want = jax_tail_stage(c, jnp.bfloat16)
    floor = np.abs(want - jax_tail_stage(c)).max()
    got = fused_tail.fused_tail_stage(*_torch_args(c, torch.bfloat16)).numpy()
    assert floor > 1e-4  # bf16 really was in play
    print(f"\nparity fused tail bf16 floor (JAX bf16 vs fp32): {floor:.3e}")
    assert_close("fused tail plain bf16", got, want, 0.5 * floor)


def test_tail_flops_counts_the_v1_stage():
    """2·(2,048 upsample + 129,024 MRF + 224 post) multiply-adds per output sample."""
    assert fused_tail.tail_flops(1, 1, C_IN, KS, DILS) == 4 * 262_592


def test_wrapper_refuses_other_devices():
    c = _case(1, 16, seed=1)
    z, w = _torch_args(c)
    with pytest.raises(ValueError, match="device"):
        fused_tail.fused_tail_stage(z.to("meta"), w)


def test_pack_refuses_shapes_the_kernel_cannot_take():
    c = _case(1, 16, seed=1)
    z, w = _torch_args(c)
    up = w.wup.permute(1, 2, 0)
    post = w.wpost.t()[None]
    kernels = [torch.zeros(C, C, k) for k in KS for _ in range(6)]
    with pytest.raises(ValueError, match="halo"):  # k = 25 needs more than 61 samples
        fused_tail.pack_tail_weights(up, w.bup, kernels, list(w.bmrf), post, w.bpost,
                                     kernel_sizes=(3, 7, 25), dilations=DILS)
    with pytest.raises(ValueError, match="up_kernel"):
        fused_tail.pack_tail_weights(up[:, :16], w.bup, kernels, list(w.bmrf), post,
                                     w.bpost, kernel_sizes=KS, dilations=DILS)


@pytest.mark.slow
def test_plain_tail_matches_pallas_interpret():
    """The Pallas kernel itself (interpret mode; minutes of XLA:CPU compile), fp32 and
    bf16, against the port's plain version. bf16 is held to half the Pallas kernel's
    own bf16-vs-fp32 distance, as in test_plain_tail_matches_jax_bf16."""
    from ttscube_tpu.ops.pallas_resblock import fused_tail_stage

    c = _case(1, 300, seed=3)
    want = {cd: np.asarray(fused_tail_stage(
        jnp.asarray(c["z"]), jnp.asarray(c["up"]), jnp.asarray(c["up_b"]),
        [jnp.asarray(w) for w in c["kernels"]], [jnp.asarray(b) for b in c["biases"]],
        kernel_sizes=KS, dilations=DILS, fold=FOLD, post_kernel=jnp.asarray(c["post"]),
        post_bias=jnp.asarray(c["post_b"]), with_post=True, rows_per_tile=128,
        interpret=True, compute_dtype=cd)) for cd in (None, jnp.bfloat16)}
    floor = np.abs(want[jnp.bfloat16] - want[None]).max()
    assert floor > 1e-4
    for cd, tol in ((None, 5e-5), (jnp.bfloat16, 0.5 * floor)):
        got = fused_tail.fused_tail_stage(
            *_torch_args(c, None if cd is None else torch.bfloat16)).numpy()
        assert_close(f"fused tail plain vs Pallas interpret {'fp32' if cd is None else 'bf16'}",
                     got, want[cd], tol)
