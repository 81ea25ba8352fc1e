"""One ResBlock1 of the port (`ttscube_tpu_torch.ops.fused_resblock`, kernel B4) against
the JAX package: its plain PyTorch version against the JAX package's plain ResBlock1
(`_plain_resblock1`) on the CPU at the shapes of tests/test_pallas_resblock.py's
`test_fused_resblock_matches_plain`, and (slow tier, as that JAX file is) against the
Pallas kernel `fused_resblock1` in interpret mode. The CUDA kernel itself is held
against the plain version in tests/test_torch_gpu.py and chip_smoke.py.

Limits: fp32 within 2e-5, the JAX test's atol. bf16 conv operands: within half the
floor's RMS and within its max, the floor being the JAX ResBlock1's own bf16-vs-fp32
distance; the port in fp32 (the control) must miss that."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ttscube_tpu.models.hifigan_fused import _plain_resblock1
from ttscube_tpu_torch.ops import fused_resblock
from tests.torch_parity import assert_close, one_cpu_thread  # noqa: F401

# PyTorch on one thread beside the tier's other workers (tests/torch_parity.py)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# tests/test_pallas_resblock.py::test_fused_resblock_matches_plain: (C, fold, k, dils, T)
JAX_CASES = [
    (32, 4, 11, (1, 3, 5), 2048),
    (32, 4, 3, (1, 3, 5), 8192),
    (64, 2, 7, (1, 3, 5), 1920),
    (128, 1, 11, (1, 3), 1024),
    (32, 4, 11, (1, 3, 5), 7696),
]


def block_case(B, T, C, k, dils, seed):
    """x (B, T, C) and one ResBlock1's weights in JAX layouts (k, C_in, C_out), numpy,
    at the scales of tests/test_pallas_resblock.py."""
    rng = np.random.default_rng(seed)
    n = lambda scale, *s: (scale * rng.standard_normal(s)).astype(np.float32)
    kernels = [n(0.3 / np.sqrt(k * C), k, C, C) for _ in range(2 * len(dils))]
    return dict(x=n(1.0, B, T, C), kernels=kernels, biases=[n(0.1, C) for _ in kernels],
                k=k, dils=dils)


def jax_block(c, compute_dtype=None):
    return np.asarray(_plain_resblock1(
        jnp.asarray(c["x"]), [jnp.asarray(w) for w in c["kernels"]],
        [jnp.asarray(b) for b in c["biases"]], c["dils"], compute_dtype=compute_dtype,
        storage_dtype=None))


def port_block(c, compute_dtype=None):
    return fused_resblock.fused_resblock1(
        torch.from_numpy(c["x"]), [torch.from_numpy(w) for w in c["kernels"]],
        [torch.from_numpy(b) for b in c["biases"]], kernel_size=c["k"],
        dilations=c["dils"], compute_dtype=compute_dtype)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


@pytest.mark.parametrize("C,fold,k,dils,T", JAX_CASES)
def test_plain_resblock_matches_jax_fp32(C, fold, k, dils, T):
    c = block_case(2, T, C, k, dils, seed=C + k + T)
    want = jax_block(c)
    got = port_block(c)  # CPU tensors → the plain version
    assert got.shape == want.shape == (2, T, C) and got.dtype == torch.float32
    assert_close(f"fused_resblock1 plain fp32 C={C} k={k} T={T}", got, want, 2e-5)


@pytest.mark.parametrize("C,k,dils,T", [(32, 11, (1, 3, 5), 2048), (128, 11, (1, 3), 1024)])
def test_plain_resblock_matches_jax_bf16(C, k, dils, T):
    """bf16 conv operands, fp32 products, sums, biases and residual on both sides."""
    c = block_case(2, T, C, k, dils, seed=7 * C + k)
    want, want32 = jax_block(c, jnp.bfloat16), jax_block(c)
    got, got32 = port_block(c, torch.bfloat16).numpy(), port_block(c).numpy()
    floor_max, floor_rms = np.abs(want - want32).max(), _rms(want - want32)
    within = lambda a: _rms(a - want) <= 0.5 * floor_rms and np.abs(a - want).max() <= floor_max
    assert floor_max > 1e-4  # bf16 really was in play
    print(f"\nparity fused_resblock1 bf16 C={C} floor (JAX bf16 vs fp32): max "
          f"{floor_max:.3e} rms {floor_rms:.3e}; port rms {_rms(got - want) / floor_rms:.3f} "
          f"of it, control {_rms(got32 - want) / floor_rms:.3f}")
    assert_close(f"fused_resblock1 plain bf16 C={C}", got, want, floor_max)
    assert within(got)
    assert not within(got32)


def test_resblock_refuses_what_the_kernel_cannot_take():
    def block(C, k=3, dils=(1,), shapes=None):
        kernels = [torch.zeros(*s) for s in shapes] if shapes else \
            [torch.zeros(k, C, C) for _ in range(2 * len(dils))]
        return fused_resblock.fused_resblock1(
            torch.zeros(1, 8, C), kernels, [torch.zeros(C) for _ in kernels], kernel_size=k,
            dilations=dils)

    with pytest.raises(ValueError, match="up to 256"):  # the JAX function's C = 384, fold 1
        block(384)
    with pytest.raises(ValueError, match="multiple of 32"):
        block(48)
    with pytest.raises(ValueError, match="odd k"):
        block(32, k=4)
    with pytest.raises(ValueError, match="odd k"):      # (k − 1)/2·d = 70 > 64
        block(32, k=15, dils=(10,))
    with pytest.raises(ValueError, match=r"\(C, C, k\)"):
        block(32, shapes=[(3, 32, 32), (5, 32, 32)])
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_resblock.fused_resblock1(torch.zeros(1, 8, 32), [torch.zeros(3, 32, 32)] * 2,
                                       [torch.zeros(32)] * 2, kernel_size=3, dilations=(1,),
                                       compute_dtype=torch.float16)
    assert block(256, k=15, dils=(9,)).shape == (1, 8, 256)  # (k − 1)/2·d = 63


def test_resblock_wrapper_refuses_other_devices():
    c = block_case(1, 16, 32, 3, (1,), seed=1)
    with pytest.raises(ValueError, match="device"):
        fused_resblock.fused_resblock1(
            torch.from_numpy(c["x"]).to("meta"), [torch.from_numpy(w) for w in c["kernels"]],
            [torch.from_numpy(b) for b in c["biases"]], kernel_size=3, dilations=(1,))


def test_resblock_flops():
    """2·T·C²·k per conv, 2·len(dilations) convs: 8.30 GFLOP at v1 stage 3 (T = 61,440,
    C = 32, k = 11, dilations (1, 3, 5)), the bound chip_smoke divides by the peaks."""
    n = fused_resblock.resblock_flops(1, 61440, 32, 11, (1, 3, 5))
    assert n == 2 * 61440 * 32 * 32 * 11 * 6
    assert round(n / 1e9, 2) == 8.30
    # the bound: operations over the peak (67 TFLOP/s fp32, 989 bf16) against the bytes
    # (x in and out fp32, the weights) over 3.35 TB/s; operations bound both
    nbytes = 4 * (2 * 61440 * 32 + 6 * (11 * 32 * 32 + 32))
    t_bytes = nbytes / 3.35e12 * 1e3
    assert round(n / 67e12 * 1e3, 3) == 0.124 and round(n / 989e12 * 1e3, 4) == 0.0084
    assert t_bytes < n / 989e12 * 1e3


@pytest.mark.slow
@pytest.mark.parametrize("C,fold,k,dils,T", JAX_CASES)
def test_plain_resblock_matches_pallas_interpret(C, fold, k, dils, T):
    """The Pallas kernel itself (interpret mode) against the port's plain version: fp32
    at the JAX test's 2e-5, bf16 within half the Pallas kernel's own bf16-vs-fp32
    distance."""
    from ttscube_tpu.ops.pallas_resblock import fused_resblock1

    c = block_case(2, T, C, k, dils, seed=C + k + T)
    want = {cd: np.asarray(fused_resblock1(
        jnp.asarray(c["x"]), [jnp.asarray(w) for w in c["kernels"]],
        [jnp.asarray(b) for b in c["biases"]], kernel_size=k, dilations=dils, fold=fold,
        rows_per_tile=256, interpret=True, compute_dtype=cd)) for cd in (None, jnp.bfloat16)}
    floor = np.abs(want[jnp.bfloat16] - want[None]).max()
    assert floor > 1e-4
    for cd, tol in ((None, 2e-5), (jnp.bfloat16, 0.5 * floor)):
        got = port_block(c, None if cd is None else torch.bfloat16)
        assert_close(f"fused_resblock1 plain vs Pallas interpret C={C} k={k} T={T} "
                     f"{'fp32' if cd is None else 'bf16'}", got, want[cd], tol)
