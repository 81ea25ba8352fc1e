#!/usr/bin/env python3
"""Variants of kernels B2 and B1 on the card: the evidence for their design choices
(PERF.md).

    python3 chip_variants.py [b2] [b1] [b3]      (all three when no kernel is named)

It first measures the rate mma.sync reaches on the card: a loop of independent TF32
and bf16 MMAs, 16 warps on every SM. Then it builds variants of each kernel's source,
each the shipped source with one design choice undone. B2,
csrc/fused_tail_stage_grad.cu:

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
clocks in each phase, and per mma.sync and scheduler in the MMA phases. B1,
csrc/fused_tail_stage.cu:

  shipped            the kernel as it is
  no_flush           the fp32 form without flush: each product order summed over all
                     of a conv's taps in one running MMA accumulator
  no_pad             the bf16 form's rows unpadded: 64-byte rows, so that ldmatrix's
                     8 row addresses meet 4 to a group of banks
  warps16            16 warps a block in place of 8 (at most 2 items a warp in a conv
                     pass, at most 128 registers a thread)
  no_weight_loads    (a timing, its results are wrong) the weights staged from
                     constants, not from device memory: what reading them at the start
                     of every conv pass costs
  no_upsample        (a timing, its results are wrong) the upsample's products left
                     out: what the upsample on the CUDA cores costs

and for each prints: B1 fp32 at the training shape (B = 16, T_in = 3,000) against the
plain version (TF32 off) and chip_smoke.py's limit 5e-5; B1 bf16 at the serving shape
(B = 1, F = 256) against the plain bf16 version in units of the floor (the plain bf16
version's distance from fp32; chip_smoke.py's limits are 0.5 of its RMS and 1.0 of
its max); whether two launches are bit-equal; its median times in both forms. Times
are medians of readings over chip_smoke.TIME_PER launches in a row. Then a build of B1
with clock marks at block-wide barriers (`B1_CLOCKS`) prints where a tile's clocks go,
by phase (`B1_PHASES`), in both forms, and the MMA phase's clocks per mma.sync and
scheduler (`fused_tail.tail_mma_counts`); its barriers cost a little time of their own. B3,
csrc/fused_mrf_stage.cu, bf16 (its fp32 form is not on a main path):

  shipped            the kernel as it is
  no_pad             the staged bf16 rows unpadded
  no_weight_loads    (a timing, its results are wrong) the weights staged from
                     constants, not from device memory (L2)
  no_slab_loads      (a timing, its results are wrong) the input slab staged from
                     constants
  no_mma             (a timing, its results are wrong) the MMAs left out

and for each prints B3 at v1's stages 0 and 1 and B1-mid at stage 2 (256 frames):
distance from the plain bf16 version in units of the floor, relaunch bit-equal, median
time. The
variants are compiled from the source's text into ttscube_tpu_torch/_build/variants/;
a change that no longer finds its snippet in the source stops the script. It takes
chip_smoke.py's helpers and the port's package from beside it.
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
B3_VARIANTS = {
    "shipped": [],
    "no_pad": [("constexpr int BPAD = 8;", "constexpr int BPAD = 0;")],
    "no_weight_loads": [
        ("const float4 x0 = __ldg(reinterpret_cast<const float4*>(wp));",
         "const float4 x0 = make_float4(0.f, 0.f, 0.f, wp == w ? 1.f : 0.f);"),
        ("const float4 x1 = __ldg(reinterpret_cast<const float4*>(wp + 4));",
         "const float4 x1 = make_float4(0.f, 0.f, 0.f, 0.f);")],
    "no_slab_loads": [
        ("        v = __ldcg(reinterpret_cast<const float4*>(src + static_cast<size_t>(tt) * C + ci0 + q));",
         "        v = make_float4(1.f, 0.f, 0.f, static_cast<float>(tt));")],
    "no_mma": [("        mma_bf16(acc[n], af, bf[n >> 1][(n & 1) * 2], bf[n >> 1][(n & 1) * 2 + 1]);\n    };",
                "        acc[n][0] += __uint_as_float(af[n] ^ bf[n >> 1][n & 1]);\n    };")],
}
B1_TAP_FLUSH = """    for (int n = 0; n < 4; ++n) flush(acc[n], part[n]);  // once per tap: 4 steps
  }"""
B1_VARIANTS = {
    "shipped": [],
    "no_flush": [(B1_TAP_FLUSH, "  }\n#pragma unroll\n  for (int n = 0; n < 4; ++n) "
                                "flush(acc[n], part[n]);")],
    "no_pad": [("constexpr int PAD = 8;", "constexpr int PAD = 0;")],
    "warps16": [("constexpr int THREADS = 256;", "constexpr int THREADS = 512;")],
    "no_weight_loads": [
        ("__ldg(reinterpret_cast<const float4*>(w + row * C + q));",
         "make_float4(0.f, 0.f, 0.f, 1.f);"),
        ("__ldg(reinterpret_cast<const float4*>(w + row * C + q + 4));",
         "make_float4(0.f, 0.f, 0.f, 1.f);"),
        ("make_float4(__ldg(src), __ldg(src + 8), __ldg(src + 16), __ldg(src + 24));",
         "make_float4(0.f, 0.f, 0.f, src == w ? 1.f : 0.f);")],
    "no_upsample": [("sum[i] = fmaf(x.w, wv[3], fmaf(x.z, wv[2], fmaf(x.y, wv[1], "
                     "fmaf(x.x, wv[0], sum[i]))));", "sum[i] += wv[0];")],
}

# B1 with clock marks: thread 0 of every block adds the clocks from one block-wide
# barrier to the next into the phase they close (a barrier at each mark)
B1_PHASES = ("z rows", "upsample", "chain start", "pass: staging", "pass: MMAs",
             "pass: epilogue", "mean and conv_post")


def _mark(phase: int) -> str:
    return ("__syncthreads(); if (threadIdx.x == 0) { const long long now = clock64(); "
            f"atomicAdd(&phase_clk[{phase}], static_cast<unsigned long long>(now - t_mark)); "
            "t_mark = now; }\n")


B1_CLOCKS = [
    ("struct Spec {", "__device__ unsigned long long phase_clk[8];\n__shared__ long long t_mark;\n"
                      "\nstruct Spec {"),
    ("  // upsample, once per tile:", "  if (threadIdx.x == 0) t_mark = clock64();\n"
                                      "  // upsample, once per tile:"),
    ("  __syncthreads();\n  {\n    // thread: channel co",
     "  " + _mark(0) + "  {\n    // thread: channel co"),
    ("    __syncthreads();  // UP complete; the last chain's reads of XR, A and H are done\n",
     "    " + _mark(1)),
    ("    // the chain: each pair's output region", "    " + _mark(2)
     + "    // the chain: each pair's output region"),
    ("    stage_weights<BF16>(s.W, w + t0 * C * C, nt);\n    __syncthreads();\n",
     "    stage_weights<BF16>(s.W, w + t0 * C * C, nt);\n    " + _mark(3)),
    ("                                 r_lo + 16 * (warp + i * WARPS), r_hi);\n      }\n    }\n  }\n",
     "                                 r_lo + 16 * (warp + i * WARPS), r_hi);\n      }\n    }\n"
     "    " + _mark(4) + "  }\n"),
    ("            *dst = x;\n          }\n        }\n      }\n    }\n  }\n}\n",
     "            *dst = x;\n          }\n        }\n      }\n    }\n  }\n  " + _mark(5) + "}\n"),
    ("    out[static_cast<size_t>(b) * L + t] = tanhf(sum + __ldg(bpost));\n  }\n}",
     "    out[static_cast<size_t>(b) * L + t] = tanhf(sum + __ldg(bpost));\n  }\n  "
     + _mark(6) + "}"),
    ("int ttscube_fused_tail_stage_limits(int* out) {",
     "int ttscube_phase_clocks(unsigned long long* out) {\n"
     "  unsigned long long zero[8] = {};\n"
     "  cudaError_t err = cudaMemcpyFromSymbol(out, phase_clk, sizeof(zero));\n"
     "  if (err == cudaSuccess) err = cudaMemcpyToSymbol(phase_clk, zero, sizeof(zero));\n"
     "  return static_cast<int>(err);\n}\n\nint ttscube_fused_tail_stage_limits(int* out) {"),
]


def _variant(name: str, source: str, changes: list) -> str:
    for old, new in changes:
        if old not in source:
            raise RuntimeError(f"variant {name}: snippet not in the source: {old!r}")
        source = source.replace(old, new)
    return source


def _compile(name: str, text: str):
    from ttscube_tpu_torch.ops import _build

    out = _build.BUILD_ROOT / "variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(text)
    so = out / f"lib{name}.so"
    done = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", str(so), str(out / f"{name}.cu")],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{done.stdout}{done.stderr}")
    regs = [ln.strip() for ln in (done.stdout + done.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(str(so)), regs


def _use(lib, source: str, fn: str) -> None:
    """Make the wrapper of `fn` launch it from `lib`: the loader's cache of libraries
    gets `lib` in place of the one built from csrc/<source>.cu, and the wrapper binds
    it anew."""
    from ttscube_tpu_torch.ops import _build

    _build._libs[source] = lib
    _build._bound.discard((source, fn))


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


def b2_variants(gen) -> None:
    """B2's variants: checks, times and phase clocks (the module's docstring)."""
    import torch
    from ttscube_tpu_torch.ops import _build, fused_tail

    dev = torch.device("cuda")
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
            lib, regs = _compile(name, _variant(name, source, changes))
            _use(lib, fused_tail.GRAD_KERNEL_SOURCE, "ttscube_fused_tail_stage_grad")
            got = smoke.tail_vjp(*ragged, cfg, "kernel")
            ok_plain = all(smoke.within_grad_tol(a, b) for a, b in zip(got, plain_r))
            ok_exact = all(smoke.within_grad_tol(a, b) for a, b in zip(got, exact_r))
            worst = max(smoke.rel_rms(a, e)
                        for a, e in zip(smoke.tail_vjp(*train, cfg, "kernel"), exact_t))
            ms = statistics.median(smoke.cuda_times(
                lambda: fused_tail.fused_tail_stage_grad(z.detach(), w, train[1]), 10,
                smoke.TIME_PER))
            clocks = torch.zeros(fused_tail.GRAD_LIMITS["n_phases"], dtype=torch.int64,
                                 device=dev)
            fused_tail.fused_tail_stage_grad(z.detach(), w, train[1], phase_clocks=clocks)
            torch.cuda.synchronize()
            phases = "; ".join(
                f"{p} {c}" + (f" ({c / (tiles0 * mma[p] / 4):.1f}/MMA)" if p in mma else "")
                for p, c in zip(fused_tail.GRAD_PHASES, clocks.tolist()))
            print(f"B2 {name}: ragged within 2e-4 of plain {ok_plain}, of fp64 {ok_exact}; "
                  f"training shape worst relative RMS {worst:.3e}; ms={ms:.4f}; "
                  f"{'; '.join(regs)}", flush=True)
            print(f"  clocks of block 0: {phases}", flush=True)


def b1_variants(gen) -> None:
    """B1's variants: checks and times (the module's docstring)."""
    import torch
    from ttscube_tpu_torch.ops import _build, fused_tail

    dev = torch.device("cuda")
    kernel, plain = fused_tail.fused_tail_stage, fused_tail.fused_tail_stage_plain
    source = (_build.CSRC / f"{fused_tail.KERNEL_SOURCE}.cu").read_text()
    w32, w16 = gen.tail_weights(None), gen.tail_weights(torch.bfloat16)
    serve = smoke.tail_input(1, 256, seed=256, device=dev)
    train = torch.randn(smoke.TRAIN_BATCH, 3000, 64,
                        generator=torch.Generator().manual_seed(3000)).to(dev)
    with smoke.no_tf32():
        want32 = plain(train, w32)
        want16, floor32 = plain(serve, w16), plain(serve, w32)
    floor = smoke.distance(want16, floor32)
    for name, changes in B1_VARIANTS.items():
        lib, regs = _compile("b1_" + name, _variant(name, source, changes))
        _use(lib, fused_tail.KERNEL_SOURCE, "ttscube_fused_tail_stage")
        with smoke.no_tf32():
            got32, again32 = kernel(train, w32), kernel(train, w32)
            got16, again16 = kernel(serve, w16), kernel(serve, w16)
            ms32 = statistics.median(smoke.cuda_times(lambda: kernel(train, w32), 15,
                                                      smoke.TIME_PER))
        ms16 = statistics.median(smoke.cuda_times(lambda: kernel(serve, w16), 15, smoke.TIME_PER))
        torch.cuda.synchronize()
        e32, e16 = smoke.distance(got32, want32)[0], smoke.distance(got16, want16)
        equal = torch.equal(got32, again32) and torch.equal(got16, again16)
        print(f"B1 {name}: fp32 B={smoke.TRAIN_BATCH} T_in=3000 max_abs_err={e32:.3e} "
              f"(limit {smoke.TOL_FP32:.0e}); bf16 B=1 F=256 {e16[0] / floor[0]:.3f} of the "
              f"floor's max, {e16[1] / floor[1]:.3f} of its RMS (limits {smoke.BF16_MAX}, "
              f"{smoke.BF16_RMS}); relaunch bit-equal {equal}; ms fp32 {ms32:.4f}, bf16 "
              f"{ms16:.4f}; {'; '.join(regs)}", flush=True)
    # where a tile's clocks go, by phase (marks at block-wide barriers)
    lib, _ = _compile("b1_clocks", _variant("clocks", source, B1_CLOCKS))
    _use(lib, fused_tail.KERNEL_SOURCE, "ttscube_fused_tail_stage")
    lib.ttscube_phase_clocks.argtypes = [ctypes.c_void_p]
    clk = (ctypes.c_ulonglong * 8)()
    for label, z, w in (("bf16 B=1 F=256", serve, w16),
                        (f"fp32 B={smoke.TRAIN_BATCH} T_in=3000", train, w32)):
        kernel(z, w)
        torch.cuda.synchronize()
        lib.ttscube_phase_clocks(ctypes.addressof(clk))  # cleared after the warm-up
        kernel(z, w)
        torch.cuda.synchronize()
        if lib.ttscube_phase_clocks(ctypes.addressof(clk)):
            raise RuntimeError("B1 clocks: copying the counters failed")
        tiles = z.shape[0] * -(-4 * z.shape[1] // fused_tail.LIMITS["tile"])
        total = sum(clk[:len(B1_PHASES)])
        # the MMA phase's clocks per mma.sync of each of the SM's 4 schedulers
        mma = sum(fused_tail.tail_mma_counts(w.kernel_sizes, w.dilations,
                                             bf16=w.compute_dtype is not None).values())
        per_mma = clk[B1_PHASES.index("pass: MMAs")] / tiles / (mma / 4)
        print(f"B1 clocks {label}, per tile ({tiles} tiles): {total / tiles:.0f}; " + "; ".join(
            f"{name} {clk[i] / tiles:.0f} ({clk[i] / total:.3f})"
            for i, name in enumerate(B1_PHASES)) + f"; {per_mma:.1f} clocks per mma.sync per "
              f"scheduler in the MMA phase ({mma} a tile)", flush=True)


def b3_variants(gen) -> None:
    """B3's bf16 variants: checks and times (the module's docstring)."""
    import torch
    from ttscube_tpu_torch.ops import _build, fused_mrf, fused_tail

    dev = torch.device("cuda")
    source = (_build.CSRC / f"{fused_mrf.KERNEL_SOURCE}.cu").read_text()
    cases = []
    for label, i, t_len, c_in in (("stage0", 0, 1280, 256), ("stage1", 1, 3840, 128),
                                  ("mid stage2", 2, 3840, 128)):
        x = torch.randn(1, t_len, c_in, generator=torch.Generator().manual_seed(t_len)).to(dev)
        w16, w32 = gen.stage_weights(i, torch.bfloat16), gen.stage_weights(i, None)
        kernel, plain = ((fused_mrf.fused_mrf1, fused_mrf.fused_mrf_plain) if i < 2 else
                         (fused_tail.fused_tail_stage_mid, fused_tail.fused_tail_stage_plain))
        with smoke.no_tf32():
            want16, want32 = plain(x, w16), plain(x, w32)
        cases.append((label, kernel, x, w16, want16, smoke.distance(want16, want32)))
    for name, changes in B3_VARIANTS.items():
        lib, regs = _compile("b3_" + name, _variant(name, source, changes))
        for fn in ("ttscube_fused_mrf1", "ttscube_fused_stage_mid", "ttscube_fused_resblock1"):
            _use(lib, fused_mrf.KERNEL_SOURCE, fn)
        out = []
        for label, kernel, x, w, want, floor in cases:
            got, again = kernel(x, w), kernel(x, w)
            torch.cuda.synchronize()
            err = smoke.distance(got, want)
            ms = statistics.median(smoke.cuda_times(lambda: kernel(x, w), 15, smoke.TIME_PER))
            out.append(f"{label} ms {ms:.4f}, {err[0] / floor[0]:.3f} / {err[1] / floor[1]:.3f} "
                       f"of the floor, relaunch bit-equal {torch.equal(got, again)}")
        print(f"B3 {name}: " + "; ".join(out), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: torch.cuda.is_available() is False; this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.models.hifigan import Generator, HifiganConfig

    kernels = sys.argv[1:] or ["b2", "b1", "b3"]
    if not set(kernels) <= {"b1", "b2", "b3"}:
        print(f"chip_variants: kernels are b1, b2 and b3, not {kernels}", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    print("mma.sync TFLOP/s: " + ", ".join(f"{k} {v:.1f}" for k, v in mma_rates().items()),
          flush=True)
    gen = init_random(Generator(HifiganConfig()), 0).to(torch.device("cuda"))
    for name in kernels:
        {"b1": b1_variants, "b2": b2_variants, "b3": b3_variants}[name](gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
