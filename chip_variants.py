#!/usr/bin/env python3
"""Variants of kernel B2 on the card: the evidence for its design choices (PERF.md).

    python3 chip_variants.py

It first measures the rate mma.sync reaches on the card: a loop of independent TF32
and bf16 MMAs, 16 warps on every SM. Then it builds variants of
csrc/fused_tail_stage_grad.cu, each the shipped source with one design choice undone:

  shipped            the kernel as it is
  one_accumulator    no flush: each product order summed over a whole conv in one
                     running MMA accumulator
  truncated_forward  the forward recompute's operands split without rounding, as the
                     backward's are
  no_split           (a timing, its results are wrong) the operands handed to the MMAs
                     unsplit: what the fp32-to-TF32 splits cost

and for each prints: B2 at a ragged shape (B = 2, T_in = 701) against autograd of the
plain version in fp32 and in fp64 at rtol = atol = 2e-4, chip_smoke.py's check; the
worst relative RMS of the grads against the fp64 VJP at the training shape (B = 16,
T_in = 3,000, seed 3000), whose limit is 5e-3; its median time; thread block 0's
clocks in each phase, and per mma.sync and scheduler in the MMA phases. The variants
are compiled from the source's text into ttscube_tpu_torch/_build/variants/; a change
that no longer finds its snippet in the source stops the script. It takes chip_smoke.py's
helpers and the port's package from beside it.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import chip_smoke as smoke

# every thread of 16 warps an SM: 4 independent accumulators, one TF32 or bf16 MMA into
# each per iteration
MMA_BENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int CH, bool BF16>
__global__ void __launch_bounds__(512, 1) bench(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 7 + i;
  b[0] = threadIdx.x;
  b[1] = threadIdx.x + 1;
  float d[CH][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (BF16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_bench(float* out, int bf16, int iters, int blocks) {
  if (bf16) bench<4, true><<<blocks, 512>>>(out, iters);
  else bench<4, false><<<blocks, 512>>>(out, iters);
  return (int)cudaGetLastError();
}
"""

SPLIT = """  const uint32_t hi = ROUND ? (__float_as_uint(x) + 0x1000u) & 0xffffe000u : __float_as_uint(x);
  p[0][e] = hi;
  p[1][e] = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));"""
TAP_FLUSH = """    for (int nt = 0; nt < 2; ++nt) flush(acc[nt], part[nt]);  // once per tap: 4 steps
  }"""
# each variant: (snippet, replacement) pairs applied to the shipped source
VARIANTS = {
    "shipped": [],
    "one_accumulator": [
        (TAP_FLUSH, "  }\n#pragma unroll\n  for (int nt = 0; nt < 2; ++nt) flush(acc[nt], part[nt]);"),
        ("if (s % 4 == 3 || s + 1 == steps) {", "if (s + 1 == steps) {")],
    "truncated_forward": [("split<!FLIP>", "split<false>")],
    "no_split": [(SPLIT, "  p[0][e] = p[1][e] = __float_as_uint(x);")],
}


def _compile(name: str, text: str):
    from ttscube_tpu_torch.ops import _build

    out = _build.BUILD_ROOT / "variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(text)
    so = out / f"lib{name}.so"
    done = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(out / f"{name}.cu")], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{done.stdout}{done.stderr}")
    regs = [ln.strip() for ln in (done.stdout + done.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(str(so)), regs


def _use(lib) -> None:
    """Make fused_tail's wrapper launch B2 from `lib`: the loader's cache of libraries
    gets `lib` in place of the shipped one, and the wrapper binds it anew."""
    from ttscube_tpu_torch.ops import _build, fused_tail

    _build._libs[fused_tail.GRAD_KERNEL_SOURCE] = lib
    _build._bound.discard((fused_tail.GRAD_KERNEL_SOURCE, "ttscube_fused_tail_stage_grad"))


def mma_rates() -> dict:
    """TFLOP/s of mma.sync on every SM of the card, 16 warps of 4 chains each."""
    import torch

    lib, _ = _compile("mma_bench", MMA_BENCH)
    lib.mma_bench.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 512, device="cuda")
    rates = {}
    for name, bf16, flop in (("tf32", 0, 2 * 16 * 8 * 8), ("bf16", 1, 2 * 16 * 8 * 16)):
        iters = 20000
        ms = statistics.median(smoke.cuda_times(
            lambda: lib.mma_bench(out.data_ptr(), bf16, iters, sms), 5))
        rates[name] = sms * 16 * 4 * iters * flop / (ms * 1e-3) / 1e12
    return rates


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: torch.cuda.is_available() is False; this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.models.hifigan import Generator, HifiganConfig
    from ttscube_tpu_torch.ops import _build, fused_tail

    print(torch.cuda.get_device_name(0), flush=True)
    print("mma.sync TFLOP/s: " + ", ".join(f"{k} {v:.1f}" for k, v in mma_rates().items()),
          flush=True)
    dev = torch.device("cuda")
    gen = init_random(Generator(HifiganConfig()), 0).to(dev)
    cfg = gen.config
    source = (_build.CSRC / f"{fused_tail.GRAD_KERNEL_SOURCE}.cu").read_text()
    with smoke.no_tf32():
        ragged = smoke.tail_leaves(gen, 2, 701, seed=701, device=dev)
        train = smoke.tail_leaves(gen, 16, 3000, seed=3000, device=dev)
        plain_r = smoke.tail_vjp(*ragged, cfg, "plain")
        exact_r = smoke.tail_vjp(*ragged, cfg, "exact")
        exact_t = smoke.tail_vjp(*train, cfg, "exact")
        z, *raw = train[0]
        w = fused_tail.pack_tail_weights(raw[0], raw[1], raw[4:22], raw[22:], raw[2], raw[3],
                                         kernel_sizes=cfg.resblock_kernel_sizes,
                                         dilations=cfg.resblock_dilation_sizes)
        w = w._replace(**{f: getattr(w, f).detach()
                          for f in ("wup", "bup", "wmrf", "bmrf", "wpost", "bpost")})
        tiles0 = len(range(0, 16 * -(-12000 // 256), fused_tail.GRAD_BLOCKS))
        mma = fused_tail.tail_grad_mma_counts(w.kernel_sizes, w.dilations)
        for name, changes in VARIANTS.items():
            text = source
            for old, new in changes:
                if old not in text:
                    raise RuntimeError(f"variant {name}: snippet not in the source: {old!r}")
                text = text.replace(old, new)
            lib, regs = _compile(name, text)
            _use(lib)
            got = smoke.tail_vjp(*ragged, cfg, "kernel")
            ok_plain = all(smoke.within_grad_tol(a, b) for a, b in zip(got, plain_r))
            ok_exact = all(smoke.within_grad_tol(a, b) for a, b in zip(got, exact_r))
            worst = max(smoke.rel_rms(a, e)
                        for a, e in zip(smoke.tail_vjp(*train, cfg, "kernel"), exact_t))
            ms = statistics.median(smoke.cuda_times(
                lambda: fused_tail.fused_tail_stage_grad(z.detach(), w, train[1]), 10))
            clocks = torch.zeros(fused_tail.GRAD_LIMITS["n_phases"], dtype=torch.int64,
                                 device=dev)
            fused_tail.fused_tail_stage_grad(z.detach(), w, train[1], phase_clocks=clocks)
            torch.cuda.synchronize()
            phases = "; ".join(
                f"{p} {c}" + (f" ({c / (tiles0 * mma[p] / 4):.1f}/MMA)" if p in mma else "")
                for p, c in zip(fused_tail.GRAD_PHASES, clocks.tolist()))
            print(f"{name}: ragged within 2e-4 of plain {ok_plain}, of fp64 {ok_exact}; "
                  f"training shape worst relative RMS {worst:.3e}; ms={ms:.4f}; "
                  f"{'; '.join(regs)}", flush=True)
            print(f"  clocks of block 0: {phases}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
