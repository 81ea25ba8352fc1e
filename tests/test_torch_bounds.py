"""The bounds chip_smoke.py writes beside each kernel's time (`ops_bound_ms`, `bound`):
bf16 work on the bf16 tensor cores at 989 TFLOP/s; fp32 work on the faster of its
fp32-accurate routes, the fp32 CUDA cores at 67 TFLOP/s or 3xTF32 on the tensor cores
(three TF32 products at 495 TFLOP/s for each), which is 3xTF32's at every shape; and
the larger of that and the bytes over 3.35 TB/s. Held at the v1 shapes chip_smoke
times, from the operation counts of the wrappers."""

import importlib.util
from pathlib import Path

import pytest

from ttscube_tpu_torch.ops import fused_mrf, fused_resblock, fused_tail, narrow_conv

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

V1 = ((3, 7, 11), ((1, 3, 5),) * 3)


@pytest.mark.parametrize("what,flops,mode,want_ms", [
    # B1 at B = 1, F = 256 frames (z (1, 15,376, 64)) and at the training shape
    ("B1 serving", fused_tail.tail_flops(1, 15376, 64, *V1), "bf16", 0.01633),
    ("B1 serving", fused_tail.tail_flops(1, 15376, 64, *V1), "fp32", 0.09788),
    ("B1 training", fused_tail.tail_flops(16, 3000, 64, *V1), "fp32", 0.30556),
    # B3 at v1's stages 0 and 1, B1-mid at stage 2, for 256 frames
    ("B3 stage 0", fused_mrf.mrf_flops(1, 1280, 256, *V1), "bf16", 0.02137),
    ("B3 stage 0", fused_mrf.mrf_flops(1, 1280, 256, *V1), "fp32", 0.12812),
    ("B3 stage 1", fused_mrf.mrf_flops(1, 3840, 128, *V1), "fp32", 0.09609),
    ("B1-mid", fused_tail.tail_flops(1, 3840, 128, *V1, channels=64, with_post=False),
     "fp32", 0.09761),
    # B4 at v1's stage 3 (k = 11), B5 at its docstring shape, B2 at the training shape
    ("B4", fused_resblock.resblock_flops(1, 61440, 32, 11, (1, 3, 5)), "fp32", 0.05033),
    ("B5", narrow_conv.narrow_conv_flops(8, 122880, 32, 11), "fp32", 0.13422),
    ("B2", fused_tail.tail_grad_flops(16, 3000, 64, *V1), "fp32", 0.91668),
])
def test_operation_bounds_at_the_v1_shapes(what, flops, mode, want_ms):
    got = smoke.ops_bound_ms(flops, mode)
    assert got == pytest.approx(want_ms, abs=1e-5), what
    if mode == "fp32":  # 3xTF32 beats the fp32 CUDA cores: 495 / 3 > 67
        assert got == pytest.approx(3 * flops / 495e12 * 1e3)
        assert got < flops / 67e12 * 1e3


def test_bound_takes_the_larger_of_operations_and_bytes():
    """B5 bf16 at its docstring shape is bound by bytes (x in bf16, the fp32 output),
    B1 bf16 at the serving shape by operations."""
    x = 8 * 122880 * 32
    b5 = smoke.bound(narrow_conv.narrow_conv_flops(8, 122880, 32, 11),
                     2 * (x + 11 * 32 * 32) + 4 * x, "bf16")
    assert b5["bound_by"] == "bytes" and b5["bound_ms"] == pytest.approx(0.05634, abs=1e-5)
    b1 = smoke.bound(fused_tail.tail_flops(1, 15376, 64, *V1), 4 * (15376 * 64 * 5), "bf16")
    assert b1["bound_by"] == "operations"
    assert b1["bound_ms"] == smoke.ops_bound_ms(fused_tail.tail_flops(1, 15376, 64, *V1), "bf16")


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        smoke.ops_bound_ms(1e9, "fp16")
