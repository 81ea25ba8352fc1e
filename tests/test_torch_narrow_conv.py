"""The narrow conv of the port (`ttscube_tpu_torch.ops.narrow_conv`, kernel B5) against
the JAX package: its plain PyTorch version against the Pallas kernel
`narrow_conv_pallas_blocked` in interpret mode at tests/test_legacy_and_runtime.py's
shape ((1, 128, 32), k = 7, fold 4, tile 32), at an even k, and in bf16, and against
`jax.lax.conv_general_dilated` at a T that is no multiple of a tile. The CUDA kernel
itself is held against the plain version in tests/test_torch_gpu.py and chip_smoke.py.

Limits: 1e-5, the JAX test's atol. With bf16 operands the products are exact in fp32,
so the same limit holds against the Pallas kernel's bf16 inputs."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ttscube_tpu.ops.pallas_conv import narrow_conv_pallas_blocked
from ttscube_tpu_torch.ops import narrow_conv
from tests.torch_parity import assert_close, one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def conv_case(B, T, C, k, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, C)).astype(np.float32),
            (scale * rng.standard_normal((k, C, C))).astype(np.float32))


@pytest.mark.parametrize("k", [7, 4])
def test_plain_conv_matches_pallas_interpret(k):
    """k = 7 is the JAX test's case; k = 4 pads (k − 1)//2 = 1 on the left and 2 on the
    right, as `fold_conv_kernel` does."""
    x, w = conv_case(1, 128, 32, k, seed=1)
    want = narrow_conv_pallas_blocked(jnp.asarray(x), jnp.asarray(w), fold=4, tile=32,
                                      interpret=True)
    got = narrow_conv.narrow_conv_blocked(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    assert_close(f"narrow_conv plain vs Pallas interpret k={k}", got, want, 1e-5)


def test_plain_conv_bf16_matches_pallas_interpret():
    x, w = conv_case(1, 128, 32, 7, seed=2)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = narrow_conv_pallas_blocked(xb, wb, fold=4, tile=32, interpret=True)
    got = narrow_conv.narrow_conv_blocked(torch.from_numpy(x).bfloat16(),
                                          torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.float32
    assert_close("narrow_conv plain bf16 vs Pallas interpret", got, want, 1e-5)
    # the operands really were rounded: the fp32 conv is further off than the limit
    full = narrow_conv.narrow_conv_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert float((full - torch.from_numpy(np.array(want))).abs().max()) > 1e-3


@pytest.mark.parametrize("B,T,C,k", [(2, 1000, 64, 7), (1, 300, 256, 3), (2, 77, 32, 4),
                                     (1, 50, 32, 15)])
def test_plain_conv_matches_lax_any_length(B, T, C, k):
    x, w = conv_case(B, T, C, k, seed=T + k)
    left = (k - 1) // 2
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (1,),
                                        [(left, k - 1 - left)],
                                        dimension_numbers=("NWC", "WIO", "NWC"))
    got = narrow_conv.narrow_conv_blocked(torch.from_numpy(x), torch.from_numpy(w))
    assert_close(f"narrow_conv plain vs lax B={B} T={T} C={C} k={k}", got, want, 1e-5)


def test_conv_refuses_what_the_kernel_cannot_take():
    conv = lambda C, k, dt=torch.float32, wdt=None: narrow_conv.narrow_conv_blocked(
        torch.zeros(1, 8, C, dtype=dt), torch.zeros(k, C, C, dtype=wdt or dt))
    with pytest.raises(ValueError, match="up to 256"):
        conv(512, 3)
    with pytest.raises(ValueError, match="multiple of 32"):
        conv(48, 3)
    with pytest.raises(ValueError, match="k ≤ 15"):
        conv(32, 17)
    with pytest.raises(ValueError, match="fp32 or both bf16"):
        conv(32, 3, torch.float32, torch.bfloat16)
    with pytest.raises(ValueError, match="fp32 or both bf16"):
        conv(32, 3, torch.float16)
    with pytest.raises(ValueError, match=r"\(k, C, C\)"):
        narrow_conv.narrow_conv_blocked(torch.zeros(1, 8, 32), torch.zeros(3, 32, 64))
    with pytest.raises(ValueError, match="device"):
        narrow_conv.narrow_conv_blocked(torch.zeros(1, 8, 32, device="meta"),
                                        torch.zeros(3, 32, 32, device="meta"))


def test_conv_flops():
    """22.1 GFLOP at the shape of the Pallas kernel's docstring (B = 8, T = 122,880,
    C = 32, k = 11), the bound chip_smoke divides by the peak."""
    n = narrow_conv.narrow_conv_flops(8, 122880, 32, 11)
    assert n == 2 * 8 * 122880 * 32 * 32 * 11 and round(n / 1e9, 1) == 22.1
    # fp32: bound by operations at 67 TFLOP/s; bf16: 63 MB of x in and 126 MB of fp32
    # out over 3.35 TB/s take longer than the operations at 989 TFLOP/s
    assert round(n / 67e12 * 1e3, 2) == 0.33
    x_bf16, out = 2 * 8 * 122880 * 32, 4 * 8 * 122880 * 32
    t_bytes = (x_bf16 + 2 * 11 * 32 * 32 + out) / 3.35e12 * 1e3
    assert round(x_bf16 / 1e6) == 63 and round(out / 1e6) == 126
    assert round(t_bytes, 3) == 0.056 and t_bytes > n / 989e12 * 1e3


@pytest.mark.parametrize("C", range(32, 257, 32))
def test_chunk_plan_fits_the_kernel(C):
    """The chunk of input channels the wrapper hands the kernel, at every k it takes: a
    divisor of C (a multiple of 32 for bf16 operands, of 4 for fp32) whose shared memory
    fits one block's 227 KB, and all of C, so that each block stages the weights once,
    wherever that fits."""
    L = narrow_conv.LIMITS
    for k in range(1, L["max_k"] + 1):
        for bf16 in (False, True):
            ck = narrow_conv.plan_chunk(bf16, C, k)
            assert C % ck == 0 and ck % (L["quantum"] if bf16 else 4) == 0, (k, bf16, ck)
            assert narrow_conv.smem_bytes(bf16, C, k, ck) <= L["smem_budget"]
            if narrow_conv.smem_bytes(bf16, C, k, C) <= L["smem_budget"]:
                assert ck == C, (k, bf16, ck)


def test_chunk_plan_at_the_shapes_that_matter():
    """bf16 at the docstring shape (C = 32, k = 11): the whole weight, 352 rows of 32
    channels padded to 40 (28,160 bytes), beside two slabs of 256 + 10 rows padded to 40
    (21,280 bytes each): 70,720 bytes, three blocks to an SM. C = 256 at k = 15 walks
    chunks of 64 channels: two weight and two slab buffers in 231,360 of the 232,448
    bytes. fp32 keeps the CUDA-core kernel's plan: the whole weight at C = 32, k = 11 (45,056 bytes)
    beside a slab of 128 + 10 rows of 33 floats (18,224 bytes, 16-byte aligned)."""
    assert narrow_conv.plan_chunk(True, 32, 11) == 32
    assert narrow_conv.smem_bytes(True, 32, 11, 32) == 28_160 + 2 * 21_280 == 70_720
    assert 3 * 70_720 <= 228 * 1024 < 4 * 70_720
    assert narrow_conv.plan_chunk(True, 256, 15) == 64
    assert narrow_conv.smem_bytes(True, 256, 15, 64) == 2 * (76_800 + 38_880) == 231_360
    assert narrow_conv.plan_chunk(True, 256, 3) == 128
    assert narrow_conv.plan_chunk(False, 32, 11) == 32
    assert narrow_conv.smem_bytes(False, 32, 11, 32) == 18_224 + 45_056 == 63_280
