"""The fused MRF stage of the port (`ttscube_tpu_torch.ops.fused_mrf`, kernel B3)
against the JAX package: its plain PyTorch version against the JAX package's plain MRF
chain mean on the CPU, and (slow tier) against the Pallas kernel `fused_mrf1` in
interpret mode. The CUDA kernel itself is held against the plain version in
tests/test_torch_gpu.py and chip_smoke.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ttscube_tpu.models.hifigan_fused import _plain_resblock1
from ttscube_tpu_torch.ops import fused_mrf
from tests.torch_parity import assert_close, one_cpu_thread  # noqa: F401

# PyTorch on one thread beside the tier's other workers (tests/torch_parity.py)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

V1_KS = (3, 7, 11)
V1_DILS = ((1, 3, 5),) * 3


def mrf_case(B, T, C, ks, dils, seed):
    """x (B, T, C) and the stage's weights in JAX layouts (k, C_in, C_out), numpy, at
    the scales of tests/test_pallas_resblock.py."""
    rng = np.random.default_rng(seed)
    n = lambda scale, *s: (scale * rng.standard_normal(s)).astype(np.float32)
    kernels = [n(0.3 / np.sqrt(k * C), k, C, C) for k, d in zip(ks, dils)
               for _ in range(2 * len(d))]
    return dict(x=n(1.0, B, T, C), kernels=kernels, biases=[n(0.1, C) for _ in kernels],
                ks=ks, dils=dils)


def jax_mrf(c, compute_dtype=None):
    """The JAX package's plain MRF: each chain through `_plain_resblock1` (bf16 conv
    operands with fp32 accumulation and fp32 activations between convs when
    `compute_dtype` is bf16), then the mean of the chains."""
    acc, i = None, 0
    for k, dils in zip(c["ks"], c["dils"]):
        n = 2 * len(dils)
        h = _plain_resblock1(jnp.asarray(c["x"]), [jnp.asarray(w) for w in c["kernels"][i:i + n]],
                             [jnp.asarray(b) for b in c["biases"][i:i + n]], dils,
                             compute_dtype=compute_dtype, storage_dtype=None)
        acc = h if acc is None else acc + h
        i += n
    return np.asarray(acc / len(c["ks"]))


def torch_args(c, compute_dtype=None):
    """x and the packed weights, from the JAX layouts (k, a, b) → PyTorch (b, a, k)."""
    tr = lambda a: torch.from_numpy(np.ascontiguousarray(np.transpose(a, (2, 1, 0))))
    w = fused_mrf.pack_mrf_weights([tr(w) for w in c["kernels"]],
                                   [torch.from_numpy(b) for b in c["biases"]],
                                   kernel_sizes=c["ks"], dilations=c["dils"],
                                   compute_dtype=compute_dtype)
    return torch.from_numpy(c["x"]), w


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


@pytest.mark.parametrize("C,ks,dils,T,atol", [
    (32, V1_KS, V1_DILS, 500, 2e-5),                # tests/test_pallas_resblock.py:48
    (128, (3, 11), ((1, 3, 5),) * 2, 600, 3e-5),    # :309, rows not a tile multiple
    (256, (3, 11), ((1, 3, 5),) * 2, 96, 3e-5),     # v1's widest stage
])
def test_plain_mrf_matches_jax_fp32(C, ks, dils, T, atol):
    c = mrf_case(2, T, C, ks, dils, seed=C + T)
    want = jax_mrf(c)
    got = fused_mrf.fused_mrf1(*torch_args(c))  # CPU tensor → the plain version
    assert got.shape == want.shape == (2, T, C)
    assert_close(f"fused_mrf plain fp32 C={C} T={T}", got, want, atol)


def test_plain_mrf_matches_jax_bf16():
    """bf16 operands, fp32 accumulation and fp32 activations between convs on both
    sides. The floor is the JAX chain's own bf16-vs-fp32 distance; the two sum in
    different orders, so now and then a bf16 rounding lands one step apart and travels
    down the chain. The port must sit within half the floor's RMS and within its max;
    the port in fp32 (the control) must not."""
    c = mrf_case(2, 300, 128, (3, 11), ((1, 3), (1, 3, 5)), seed=11)
    want, want32 = jax_mrf(c, jnp.bfloat16), jax_mrf(c)
    got = fused_mrf.fused_mrf1(*torch_args(c, torch.bfloat16)).numpy()
    got32 = fused_mrf.fused_mrf1(*torch_args(c)).numpy()
    floor_max, floor_rms = np.abs(want - want32).max(), _rms(want - want32)
    within = lambda a: _rms(a - want) <= 0.5 * floor_rms and np.abs(a - want).max() <= floor_max
    assert floor_max > 1e-4  # bf16 really was in play
    print(f"\nparity fused_mrf bf16 floor (JAX bf16 vs fp32): max {floor_max:.3e} rms "
          f"{floor_rms:.3e}; port rms {_rms(got - want) / floor_rms:.3f} of it")
    assert_close("fused_mrf plain bf16", got, want, floor_max)
    assert within(got)
    assert not within(got32)


def test_mrf_flops_counts_the_v1_stage():
    """252·T·C² operations for HiFi-GAN v1's chains (3 × 3 dilations × 2 convs,
    k = 3, 7, 11)."""
    for C in (128, 256):
        assert fused_mrf.mrf_flops(2, 1280, C, V1_KS, V1_DILS) == 252 * 2 * 1280 * C * C


def test_pack_refuses_what_the_kernel_cannot_take():
    def pack(C, ks, dils, shapes=None):
        sizes = fused_mrf.conv_sizes(ks, dils)
        kernels = [torch.zeros(*s) for s in shapes] if shapes else \
            [torch.zeros(C, C, k) for k in sizes]
        return fused_mrf.pack_mrf_weights(kernels, [torch.zeros(C) for _ in kernels],
                                          kernel_sizes=ks, dilations=dils)

    with pytest.raises(ValueError, match="256"):       # wider than the kernel takes
        pack(512, (3,), ((1,),))
    with pytest.raises(ValueError, match="multiple of 32"):
        pack(48, (3,), ((1,),))
    with pytest.raises(ValueError, match="odd k"):
        pack(32, (4,), ((1,),))
    with pytest.raises(ValueError, match="odd k"):     # (k − 1)/2·d = 70 > 64
        pack(32, (15,), ((10,),))
    with pytest.raises(ValueError, match="dilations"):
        pack(32, (3,), ((1, 2, 3, 4, 5),))
    with pytest.raises(ValueError, match="chains"):
        pack(32, (3,) * 5, ((1,),) * 5)
    with pytest.raises(ValueError, match=r"\(C, C, k\)"):
        pack(32, (3,), ((1,),), shapes=[(32, 32, 3), (32, 32, 5)])
    assert pack(256, (15,), ((9,),)).channels == 256  # (k − 1)/2·d = 63


def test_wrapper_refuses_other_devices():
    x, w = torch_args(mrf_case(1, 16, 32, (3,), ((1,),), seed=1))
    with pytest.raises(ValueError, match="device"):
        fused_mrf.fused_mrf1(x.to("meta"), w)


@pytest.mark.slow
@pytest.mark.parametrize("C,fold,ks,dils,T", [
    (128, 1, (3, 11), ((1, 3, 5),) * 2, 600),  # fold 1: dilation as strided taps
    (32, 4, V1_KS, V1_DILS, 2000),            # fold 4: densified dilated kernels
])
def test_plain_mrf_matches_pallas_interpret(C, fold, ks, dils, T):
    """The Pallas kernel itself (interpret mode), fp32 and bf16, against the port's
    plain version: fp32 at the JAX package's tolerance, bf16 within half the Pallas
    kernel's own bf16-vs-fp32 distance."""
    from ttscube_tpu.ops.pallas_resblock import fused_mrf1

    c = mrf_case(1, T, C, ks, dils, seed=C)
    want = {cd: np.asarray(fused_mrf1(
        jnp.asarray(c["x"]), [jnp.asarray(w) for w in c["kernels"]],
        [jnp.asarray(b) for b in c["biases"]], kernel_sizes=ks, dilations=dils, fold=fold,
        rows_per_tile=256, interpret=True, compute_dtype=cd)) for cd in (None, jnp.bfloat16)}
    floor = np.abs(want[jnp.bfloat16] - want[None]).max()
    assert floor > 1e-4
    for cd, tol in ((None, 3e-5), (jnp.bfloat16, 0.5 * floor)):
        got = fused_mrf.fused_mrf1(*torch_args(c, None if cd is None else torch.bfloat16))
        assert_close(f"fused_mrf plain vs Pallas interpret C={C} "
                     f"{'fp32' if cd is None else 'bf16'}", got, want[cd], tol)
