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


# -- the form without conv_post (a middle stage; kernel B1-mid on the card) --------------

MID_KS, MID_DILS = (3, 11), ((1, 3), (1, 3, 5))
MID_C_IN, MID_C = 128, 64


def _mid_case(B, T_in, seed):
    """z and a middle stage's weights in JAX layouts, at v1's stage-2 widths with the
    chains of tests/test_pallas_resblock.py::test_fused_tail_stage_fc256_mid_stage."""
    rng = np.random.default_rng(seed)
    n = lambda scale, *s: (scale * rng.standard_normal(s)).astype(np.float32)
    kernels = [n(0.3 / np.sqrt(k * MID_C), k, MID_C, MID_C) for k, d in zip(MID_KS, MID_DILS)
               for _ in range(2 * len(d))]
    return dict(z=n(1.0, B, T_in, MID_C_IN), up=n(0.2 / np.sqrt(MID_C_IN), FOLD, MID_C, MID_C_IN),
                up_b=n(0.1, MID_C), kernels=kernels, biases=[n(0.1, MID_C) for _ in kernels])


def _jax_mid_stage(c, compute_dtype=None):
    """The stage in plain JAX ops, as that test's reference computes it, with every conv
    operand rounded to `compute_dtype` where the TPU kernel rounds."""
    import jax

    from ttscube_tpu.models.hifigan_fused import _plain_resblock1
    from ttscube_tpu.ops.conv import _conv_transpose

    cd = (lambda a: a.astype(compute_dtype)) if compute_dtype else (lambda a: a)
    x = _conv_transpose(cd(jax.nn.leaky_relu(jnp.asarray(c["z"]), 0.1)),
                        cd(jnp.asarray(c["up"])), FOLD, 0) + c["up_b"]
    acc, i = None, 0
    for k, dils in zip(MID_KS, MID_DILS):
        n = 2 * len(dils)
        h = _plain_resblock1(x, [jnp.asarray(w) for w in c["kernels"][i:i + n]],
                             c["biases"][i:i + n], dils, compute_dtype=compute_dtype)
        acc = h if acc is None else acc + h
        i += n
    return np.asarray(acc / len(MID_KS))


def _mid_args(c, compute_dtype=None):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    tr = lambda a: t(np.transpose(a, (2, 1, 0)))
    w = fused_tail.pack_tail_weights(tr(c["up"]), t(c["up_b"]), [tr(w) for w in c["kernels"]],
                                     [t(b) for b in c["biases"]], kernel_sizes=MID_KS,
                                     dilations=MID_DILS, compute_dtype=compute_dtype)
    return t(c["z"]), w


def test_plain_mid_stage_matches_jax_fp32():
    """tests/test_pallas_resblock.py::test_fused_tail_stage_fc256_mid_stage's case
    (C_in = 128, C = 64, fold 4, T_in = 500) at its tolerance."""
    c = _mid_case(2, 500, seed=6)
    want = _jax_mid_stage(c)
    got = fused_tail.fused_tail_stage_mid(*_mid_args(c))  # CPU tensor → the plain version
    assert got.shape == want.shape == (2, FOLD * 500, MID_C)
    assert_close("fused tail plain, no conv_post, fp32", got, want, 3e-5)


def test_plain_mid_stage_matches_jax_bf16():
    """bf16 operands as the TPU kernel rounds them (the upsample's too), fp32 between
    convs: within half the floor's RMS and within its max; the fp32 control not."""
    c = _mid_case(1, 200, seed=8)
    want, want32 = _jax_mid_stage(c, jnp.bfloat16), _jax_mid_stage(c)
    got = fused_tail.fused_tail_stage_mid(*_mid_args(c, torch.bfloat16)).numpy()
    got32 = fused_tail.fused_tail_stage_mid(*_mid_args(c)).numpy()
    rms = lambda a: float(np.sqrt(np.mean(np.square(a.astype(np.float64)))))
    floor_max, floor_rms = np.abs(want - want32).max(), rms(want - want32)
    within = lambda a: rms(a - want) <= 0.5 * floor_rms and np.abs(a - want).max() <= floor_max
    assert floor_max > 1e-4
    print(f"\nparity fused tail no conv_post bf16 floor: max {floor_max:.3e} rms "
          f"{floor_rms:.3e}; port rms {rms(got - want) / floor_rms:.3f} of it")
    assert_close("fused tail plain, no conv_post, bf16", got, want, floor_max)
    assert within(got)
    assert not within(got32)


def test_tail_flops_counts_the_mid_stage():
    """2·(8,192 upsample + 516,096 MRF) multiply-adds per output sample at C_in = 128,
    C = 64 with v1's chains; none for conv_post."""
    assert fused_tail.tail_flops(1, 1, 128, KS, DILS, channels=64, with_post=False) == \
        4 * 2 * (128 * 64 + 126 * 64 * 64)


def test_mid_stage_refuses_what_its_kernel_cannot_take():
    c = _mid_case(1, 16, seed=1)
    z, w = _mid_args(c)
    up, kernels = w.wup.permute(1, 2, 0), [torch.zeros(MID_C, MID_C, k) for k in (3, 3, 11, 11, 11, 11, 11, 11)]
    biases = list(w.bmrf)
    with pytest.raises(ValueError, match="up_kernel"):  # C_in not a multiple of 32
        fused_tail.pack_tail_weights(up[:100], w.bup, kernels[:10], biases, kernel_sizes=MID_KS,
                                     dilations=MID_DILS)
    with pytest.raises(ValueError, match="up_kernel"):  # kernel == stride == 2
        fused_tail.pack_tail_weights(up[:, :, :2], w.bup, kernels[:10], biases,
                                     kernel_sizes=MID_KS, dilations=MID_DILS)
    with pytest.raises(ValueError, match="chains"):
        fused_tail.pack_tail_weights(up, w.bup, kernels[:10], biases, kernel_sizes=(3,) * 5,
                                     dilations=((1,),) * 5)
    with pytest.raises(ValueError, match="conv_post"):  # the last stage's wrapper
        fused_tail.fused_tail_stage(z, w)
    with pytest.raises(ValueError, match="device"):
        fused_tail.fused_tail_stage_mid(z.to("meta"), w)
    zp, wp = _torch_args(_case(1, 16, seed=1))
    with pytest.raises(ValueError, match="conv_post"):  # the middle stage's wrapper
        fused_tail.fused_tail_stage_mid(zp, wp)


@pytest.mark.slow
def test_plain_mid_stage_matches_pallas_interpret():
    """The Pallas kernel with with_post=False (interpret mode), fp32 and bf16, against
    the port's plain version: 3e-5, and half the Pallas kernel's bf16 floor."""
    from ttscube_tpu.ops.pallas_resblock import fused_tail_stage

    c = _mid_case(1, 300, seed=4)
    want = {cd: np.asarray(fused_tail_stage(
        jnp.asarray(c["z"]), jnp.asarray(c["up"]), jnp.asarray(c["up_b"]),
        [jnp.asarray(w) for w in c["kernels"]], [jnp.asarray(b) for b in c["biases"]],
        kernel_sizes=MID_KS, dilations=MID_DILS, fold=FOLD, with_post=False,
        rows_per_tile=128, interpret=True, compute_dtype=cd)) for cd in (None, jnp.bfloat16)}
    floor = np.abs(want[jnp.bfloat16] - want[None]).max()
    assert floor > 1e-4
    for cd, tol in ((None, 3e-5), (jnp.bfloat16, 0.5 * floor)):
        got = fused_tail.fused_tail_stage_mid(
            *_mid_args(c, None if cd is None else torch.bfloat16)).numpy()
        assert_close(f"fused tail no conv_post vs Pallas interpret "
                     f"{'fp32' if cd is None else 'bf16'}", got, want[cd], tol)
