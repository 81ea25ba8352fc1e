"""The card's peaks and a kernel's bound: the least time its operations or its bytes
need on one H100 SXM (NVIDIA's data sheet, dense rates, at the full 700 W).

bf16 work runs on the bf16 tensor cores; fp32 work on the faster of its fp32-accurate
routes, the fp32 CUDA cores or 3xTF32 on the tensor cores (three TF32 products for
each fp32 one); bytes count each input read once and each output written once."""

from __future__ import annotations

PEAK_BF16 = 989e12   # FLOP/s, also the peak of every `mfu`
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12  # B/s, HBM3


def ops_bound_ms(flops: float, mode: str) -> float:
    if mode == "bf16":
        return flops / PEAK_BF16 * 1e3
    if mode == "fp32":
        return min(flops / PEAK_FP32, 3 * flops / PEAK_TF32) * 1e3
    raise ValueError(f"ops_bound_ms: mode {mode!r}")


def bound_ms(flops: float, nbytes: float, mode: str) -> float:
    """The larger of the operations' and the bytes' least times, in ms."""
    return max(ops_bound_ms(flops, mode), nbytes / PEAK_BYTES * 1e3)


def mfu_percent(flops: float, seconds: float) -> float:
    """The share of the bf16 peak that `flops` in `seconds` reach, in %."""
    return 100.0 * flops / seconds / PEAK_BF16
