// The backward of the whole final HiFi-GAN generator stage as one kernel, for sm_90a.
//
// Replaces the TPU kernel `fused_tail_stage_grad` (ttscube_tpu/ops/pallas_resblock.py:664,
// kernel body `_tail_bwd_kernel` :446, custom VJP `_tail_cvjp` :519-661). The stage
// (fp32, with conv_post) is the one csrc/fused_tail_stage.cu computes forward:
//   leaky(0.1) -> ConvTranspose1d, kernel == stride == 4 (C_in -> 32)
//   -> per MRF chain: x += conv_1(leaky(conv_d(leaky(x))))   (32 -> 32, "same")
//   -> mean of the chains -> leaky(0.01) -> conv_post (k = 7, 32 -> 1) -> tanh,
// with positions outside [0, 4 * T_in) zeroed after every conv. Given the audio's
// cotangent dy it computes the cotangent of z and the weight grads of the upsample,
// of every MRF conv and of conv_post, in the wrapper's packed layouts.
//
// What bounds it on an H100: operations. Recompute + input cotangents + weight grads
// are 3 x the forward's 262.6 kFLOP per output sample, against ~8 bytes of input
// (z, dy) per sample: 151 GFLOP at B = 16, T_in = 3,000, 2.26 ms on the fp32 CUDA
// cores at 67 TFLOP/s, 0.92 ms in 3xTF32 on the tensor cores (3 products at 495).
//
// What the design does about it. Every product of the MRF convs, which are ~98 % of
// the work, runs on the tensor cores in 3xTF32: mma.sync.m16n8k8.tf32 with each fp32
// operand split into two TF32 pieces (`split`) and three products (`mma3`), which keeps
// fp32-level accuracy where one-pass TF32 would not. The tensor cores round their
// accumulation toward zero, so the products go into fresh accumulators that are added
// into the fp32 sums every 4 steps (`flush`); without that the forward recompute
// drifts by ~1e-5 and flips leaky slopes. Each conv is three GEMM shapes: the forward
// recompute (rows x k*32 by k*32 x 32), the input cotangent (the same with the kernel
// flipped and transposed, read from the staged weights with the taps reversed) and the
// weight grad (per tap 32 x rows by rows x 32). A conv's weights are staged in shared
// memory by cp.async, overlapping the weight grad that precedes the cotangent pass,
// and ldmatrix reads both fragments of the two conv passes (an 8 x 4-float block of
// shared memory is one TF32 fragment). Slabs of 32 channels are stored with the
// columns of row r XORed by ((r & 3) << 3) | (r & 4), so that the fragment patterns
// (8 rows x 4 columns, 4 rows x 8 columns and their pairs) hit distinct banks. 16 warps
// run in the one block an SM holds (227 KB of shared memory): a conv pass deals its
// rows out in items of 16 rows x 16 channels, the weight grad of a k-tap conv its 4k
// tiles of 16 x 16, each a warp's. The upsample, conv_post and their grads (~2 % of
// the work) stay on the CUDA cores, each weight loaded once per thread; the upsample
// is computed once per tile and kept for the other chains. Measured on an H100 (PERF.md):
// mma.sync reaches ~320 of TF32's 495 TFLOP/s, and this kernel keeps the tensor pipe
// busy ~40 % of the time in its conv passes; fragment loads and splits, 16-row items
// that leave warps idle in a pass's last round, and barriers between the passes take
// the rest.
//
// Design. One thread block per SM walks a fixed list of tiles (tile i of the grid
// goes to block i % gridDim.x), each tile TILE output samples of one batch row with a
// HALO of samples on each side, as the forward kernel tiles. Per tile:
//   1. forward recompute, keeping each conv's input (leaky(x) before conv_d, leaky(h)
//      before conv_1) in a per-block workspace in device memory, with the upsample's
//      output and the chain sum;
//   2. conv_post and tanh backward from the chain sum;
//   3. each chain backward, pair by pair from the last: the weight grads of a conv,
//      then its input cotangent; the cotangent is zeroed at the positions the forward
//      zeroes, and leaky's slope is read off the sign of the saved activation;
//   4. upsample backward: its weight grads, and the cotangent of the tile's z rows,
//      halo rows included, written out for the wrapper to overlap-add.
// Weight grads add up in a per-block partial in device memory, each entry owned by
// one thread, in the fixed order of the block's tiles; the wrapper sums the partials
// of the blocks in a fixed order. No atomics: two launches on the same inputs give
// bit-equal grads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;                      // stage channels
constexpr int FOLD = 4;                    // upsample factor == its kernel size
constexpr int TILE = 256;                  // output samples per tile
constexpr int HALO = 64;                   // slab samples on each side of the tile
constexpr int S = TILE + 2 * HALO;         // slab samples
constexpr int ZROWS = S / FOLD;            // input rows behind the slab
constexpr int POST_K = 7;
constexpr int POST_PAD = (POST_K - 1) / 2;
constexpr int F_LO = HALO - POST_PAD;      // first slab row conv_post reads
constexpr int FROWS = TILE + 2 * POST_PAD; // MRF output rows conv_post reads
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 4;
constexpr int MAX_DILS = 4;
constexpr int MARGIN = 32;                 // zero rows on each side of a cotangent slab
constexpr int SP = S + 2 * MARGIN;
constexpr int MAX_C_IN = 128;
constexpr int MAX_K = 15;                  // taps of an MRF conv: its weights in shared memory
// shared memory (floats): the slabs, either the forward's XR, A, H [S][C] or the
// backward's DX [S][C], DH [SP][C], DH1 [SP][C]; then the current conv's weights
// [k][C][C]; then the bias sums of the weight grad (and conv_post's cotangent)
constexpr int REGION = S * C + 2 * SP * C;
constexpr int RBIAS = WARPS * C;
// workspace floats per block: each conv's input slab, the upsample's output, the
// cotangent of the upsample's output, the chain sum (then its cotangent)
constexpr long long slab_floats = static_cast<long long>(S) * C;

static_assert(TILE <= THREADS, "conv_post maps one thread to one output sample");
static_assert(THREADS == C * FOLD * 4 && ZROWS % 4 == 0, "the upsample's thread map");
static_assert(HALO % FOLD == 0 && TILE % FOLD == 0, "slab must start on an input row");
static_assert(3 * S * C <= REGION, "forward buffers fit the backward's");
static_assert(ZROWS * MAX_C_IN <= S * C, "z rows fit one slab");
static_assert(TILE <= RBIAS, "conv_post's cotangent fits the bias sums' scratch");
static_assert(MARGIN % 8 == 0, "margins keep the swizzle's row phase");

// phases of a tile, for the optional clock profile
enum {
  P_FWD_INPUT,      // the upsample (first chain) or its kept output (the others)
  P_FWD_STAGE,      // saving a conv's input, staging its weights
  P_FWD_CONV_D,     // forward recompute, dilated conv
  P_FWD_CONV_1,     // forward recompute, second conv of the pair
  P_POST,           // conv_post and tanh backward
  P_BWD_STAGE,      // a cotangent slab, a saved input, a conv's weights
  P_BWD_WGRAD,      // weight grads
  P_BWD_CONV_1,     // input cotangent of the second conv
  P_BWD_CONV_D,     // input cotangent of the dilated conv
  P_BWD_SUM,        // adding a chain's cotangent of the upsample's output
  P_UP_BWD,         // upsample backward
  N_PHASES
};

struct Spec {
  int n_blocks;
  int k[MAX_BLOCKS];
  int nd[MAX_BLOCKS];
  int d[MAX_BLOCKS][MAX_DILS];
};

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : x * slope;
}

// leaky's derivative read off the sign of its input (or output: same sign), as
// PyTorch's leaky_relu backward takes it (slope at 0)
__device__ __forceinline__ float dleaky(float x, float slope) {
  return x > 0.f ? 1.f : slope;
}

// element (r, c) of a [rows][32] slab: the columns of row r permuted within aligned
// groups of 4, so a fragment load of 8 rows x 4 columns or 4 rows x 8 columns reads
// 32 distinct banks, and float2 / float4 groups stay contiguous
__device__ __forceinline__ int phase(int r) { return ((r & 3) << 3) | (r & 4); }
__device__ __forceinline__ int sw(int r, int c) { return r * C + (c ^ phase(r)); }

// x = p[0][e] + p[1][e] (element e of a fragment's two pieces), each standing for its
// top 19 bits, which are all the tensor cores read of an operand (TF32); p[1] is the
// rest after p[0], exact in fp32. ROUND: p[0] is x rounded to TF32, and at most
// |x| * 2^-21 is left out; else p[0] is x itself (read as x truncated) and at most
// |x| * 2^-20 is. Integer and fp32 operations: cvt.rna.tf32 would take the conversion
// pipe.
template <bool ROUND, int E>
__device__ __forceinline__ void split(uint32_t (&p)[2][E], int e, float x) {
  const uint32_t hi = ROUND ? (__float_as_uint(x) + 0x1000u) & 0xffffe000u : __float_as_uint(x);
  p[0][e] = hi;
  p[1][e] = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: the products a * b from the operands' pieces, each order of size in its own
// accumulator, part[0] += a0 b0 and part[1] += a1 b0 + a0 b1; each product within
// ~5 * 2^-22 of exact with rounded pieces, ~3 * 2^-20 without. The tensor cores add
// into an accumulator rounding toward zero, so a long run of MMAs into one accumulator
// drifts (by up to ~1e-5 relative over a conv's 44 steps, enough to flip the sign of
// an activation near a leaky kink); `flush` adds the parts into the running sum in
// fp32 (round to nearest) after a few steps and clears them.
__device__ __forceinline__ void mma3(float (&part)[2][4], const uint32_t (&a)[2][4],
                                     const uint32_t (&b)[2][2]) {
  mma_tf32(part[1], a[1], b[0]);
  mma_tf32(part[1], a[0], b[1]);
  mma_tf32(part[0], a[0], b[0]);
}

__device__ __forceinline__ void flush(float (&acc)[4], float (&part)[2][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i] += part[0][i] + part[1][i];
    part[0][i] = part[1][i] = 0.f;
  }
}

// 16 bytes from global to shared memory, zero-filled past src_bytes
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// wait for all but the last group (a conv's weights, copied under the weight grad)
__device__ __forceinline__ void cp_async_wait_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// an m16n8k8 TF32 fragment, or two: four 8 x 4-float blocks of shared memory, each
// lane giving the address of one block's row (16 bytes); lane l receives float l % 4
// of row l / 4 of each block
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// start copying a conv's weights [k][C][C] (rows tap * C + c_in) into W, swizzled, as
// one cp.async group
__device__ void stage_weights(float* W, const float* __restrict__ w, int k) {
  for (int i = threadIdx.x; i < k * C * C / 4; i += THREADS) {
    const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
    cp_async16(W + sw(r, c4), w + r * C + c4);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// out[r][co] = sum over taps and c of in[r + (tap - half) * d][c] * B[tap][c][co] for
// rows [r0, r0 + 16) below r_hi and channels [n0, n0 + 16), handed to epi(r, co,
// v(co), v(co + 1)) for even co, in 3xTF32, with rounded pieces in the forward
// recompute (!FLIP): the signs of its activations set leaky's slopes for the whole
// backward, and truncated pieces flip some that lie within ~1e-6 of a kink. W holds B
// transposed per tap, [tap][co][c]: the forward stages its weights so; FLIP (the input
// cotangent's conv, B[tap][c][co] = w[k - 1 - tap][co][c]) reads the conv's weights as
// packed, taps reversed. ldmatrix reads both fragments.
template <bool FLIP, typename Epi>
__device__ __forceinline__ void conv_tile(const float* in, const float* W, int k, int d,
                                          int r0, int r_hi, int n0, Epi& epi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int half = (k - 1) / 2;
  // the row of a block this lane addresses: A rows 0-15 at channels 0 and 4, B
  // columns 0-7 at channels 0 and 4, then columns 8-15
  const int a_row = lane & 15, a_col = (lane >> 4) * 4;
  const int b_row = (lane >> 4) * 8 + (lane & 7), b_col = ((lane >> 3) & 1) * 4;
  // rows past r_hi repeat its last row: read in bounds, never stored
  const int ra = min(r0 + a_row, r_hi - 1);
  // sw(r, c + kc) == sw(r, c) ^ kc for c < 8 and kc a multiple of 8
  const int bi = sw(n0 + b_row, b_col);
  float acc[2][4] = {}, part[2][2][4] = {};
  for (int tap = 0; tap < k; ++tap) {
    const int ai = sw(ra + (tap - half) * d, a_col);
    const float* wt = W + (FLIP ? k - 1 - tap : tap) * C * C;
#pragma unroll
    for (int kc = 0; kc < C; kc += 8) {
      uint32_t av[4], a[2][4];
      ldsm_x4(av, in + (ai ^ kc));
#pragma unroll
      for (int e = 0; e < 4; ++e) split<!FLIP>(a, e, __uint_as_float(av[e]));
      uint32_t bv[4], b0[2][2], b1[2][2];
      ldsm_x4(bv, wt + (bi ^ kc));
      split<!FLIP>(b0, 0, __uint_as_float(bv[0]));
      split<!FLIP>(b0, 1, __uint_as_float(bv[1]));
      split<!FLIP>(b1, 0, __uint_as_float(bv[2]));
      split<!FLIP>(b1, 1, __uint_as_float(bv[3]));
      mma3(part[0], a, b0);
      mma3(part[1], a, b1);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) flush(acc[nt], part[nt]);  // once per tap: 4 steps
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int co = n0 + nt * 8 + 2 * t;
    if (r0 + g < r_hi) epi(r0 + g, co, acc[nt][0], acc[nt][1]);
    if (r0 + g + 8 < r_hi) epi(r0 + g + 8, co, acc[nt][2], acc[nt][3]);
  }
}

// The conv of conv_tile over rows [r_lo, r_hi), all 32 channels: tiles of 16 rows x 16
// channels go round the warps.
template <bool FLIP, typename Epi>
__device__ __forceinline__ void conv_mma(const float* in, const float* W, int k, int d,
                                         int r_lo, int r_hi, Epi epi) {
  const int items = ((r_hi - r_lo + 15) >> 4) * 2;
  for (int it = threadIdx.x >> 5; it < items; it += WARPS)
    conv_tile<FLIP>(in, W, k, d, r_lo + 16 * (it >> 1), r_hi, (it & 1) * 16, epi);
}

// Weight and bias grads of a conv: pw[tap][ci][co] += sum over rows r in [r_lo, r_hi)
// of in[r + (tap - half) * d][ci] * dout[r][co], pb[co] += sum of dout[r][co]. dout
// is zero on the 7 rows past r_hi, which the last step of 8 rows reads. The 4k tiles
// of 16 c_in x 16 c_out go round the warps, each summed over all the rows by one warp.
// A fragment's row g stands for channel 2g of the tile and row g + 8 for 2g + 1,
// column g of n-tile nt for 2g + nt: then each thread loads its operands in pairs and
// owns 4 adjacent sums. The bias sums meet in rbias after a barrier; the caller's next
// barrier orders their reads before rbias is written again.
__device__ void weight_grad(const float* in, const float* dout, int k, int d, int r_lo,
                            int r_hi, float* __restrict__ pw, float* __restrict__ pb,
                            float* rbias) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int half = (k - 1) / 2;
  {
    float s = 0.f;
    for (int r = r_lo + warp; r < r_hi; r += WARPS) s += dout[sw(r, lane)];
    rbias[warp * C + lane] = s;
  }
  const int steps = (r_hi - r_lo + 7) >> 3;
  for (int q = warp; q < 4 * k; q += WARPS) {
    const int tap = q >> 2, ci0 = ((q >> 1) & 1) * 16, co0 = (q & 1) * 16;
    // this thread's sums: c_in ci0 + 2g and + 1, c_out co0 + 4t .. + 3
    float4* p = reinterpret_cast<float4*>(pw + (tap * C + ci0 + 2 * g) * C + co0 + 4 * t);
    const float4 old0 = p[0], old1 = p[C / 4];  // the latency hides behind the sums
    // step s reads rows ri + 8 s (+ 4) of in and rd + 8 s (+ 4) of dout: a row's
    // swizzle depends on its phase in 8, the same at every step
    const int ri = r_lo + t + (tap - half) * d, rd = r_lo + t;
    const float* ip = in + ri * C;
    const float* dp = dout + rd * C;
    const int i0 = (ci0 + 2 * g) ^ phase(ri), i1 = 4 * C + ((ci0 + 2 * g) ^ phase(ri + 4));
    const int d0 = (co0 + 2 * g) ^ phase(rd), d1 = 4 * C + ((co0 + 2 * g) ^ phase(rd + 4));
    float acc[2][4] = {}, part[2][2][4] = {};
#pragma unroll 2
    for (int s = 0; s < steps; ++s, ip += 8 * C, dp += 8 * C) {
      uint32_t a[2][4], b0[2][2], b1[2][2];
      const float2 x0 = *reinterpret_cast<const float2*>(ip + i0);
      const float2 x1 = *reinterpret_cast<const float2*>(ip + i1);
      const float2 y0 = *reinterpret_cast<const float2*>(dp + d0);
      const float2 y1 = *reinterpret_cast<const float2*>(dp + d1);
      split<false>(a, 0, x0.x);
      split<false>(a, 1, x0.y);
      split<false>(a, 2, x1.x);
      split<false>(a, 3, x1.y);
      split<false>(b0, 0, y0.x);
      split<false>(b0, 1, y1.x);
      split<false>(b1, 0, y0.y);
      split<false>(b1, 1, y1.y);
      mma3(part[0], a, b0);
      mma3(part[1], a, b1);
      if (s % 4 == 3 || s + 1 == steps) {  // every 32 rows
        flush(acc[0], part[0]);
        flush(acc[1], part[1]);
      }
    }
    p[0] = make_float4(old0.x + acc[0][0], old0.y + acc[1][0], old0.z + acc[0][1],
                       old0.w + acc[1][1]);
    p[C / 4] = make_float4(old1.x + acc[0][2], old1.y + acc[1][2], old1.z + acc[0][3],
                           old1.w + acc[1][3]);
  }
  __syncthreads();
  if (tid < C) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += rbias[w * C + tid];
    pb[tid] += s;
  }
}

// start copying src rows in [lo, hi) to dst rows [-MARGIN, S + MARGIN) (dst points at
// row 0), zeros elsewhere, as one cp.async group
__device__ void stage(float* dst, const float* src, int lo, int hi) {
  for (int idx = threadIdx.x; idx < SP * C / 4; idx += THREADS) {
    const int r = idx / (C / 4) - MARGIN;
    const int c = (idx % (C / 4)) * 4;
    const bool inside = r >= lo && r < hi;
    cp_async16(dst + r * C + c, inside ? src + r * C + c : src, inside ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ void copy_slab(float* dst, const float* src) {
  for (int idx = threadIdx.x; idx < S * C / 4; idx += THREADS)
    reinterpret_cast<float4*>(dst)[idx] = reinterpret_cast<const float4*>(src)[idx];
}

__global__ void __launch_bounds__(THREADS, 1)
    tail_grad_kernel(const float* __restrict__ z, int B, int T_in, int C_in,
                     const float* __restrict__ dy, const float* __restrict__ wup,
                     const float* __restrict__ bup, const float* __restrict__ wmrf,
                     const float* __restrict__ wmrf_t, const float* __restrict__ bmrf, const float* __restrict__ wpost,
                     const float* __restrict__ bpost, Spec spec, int n_convs,
                     float* __restrict__ workspace, long long ws_size,
                     float* __restrict__ partials, long long partial_size,
                     float* __restrict__ dzs, unsigned long long* phase_clocks) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  float* XR = base;                               // forward: [S][C] residual stream
  float* A = XR + S * C;                          //          [S][C] first-conv input
  float* H = A + S * C;                           //          [S][C] second-conv input
  float* DX = base;                               // backward: [S][C] residual cotangent
  float* DH = base + S * C + MARGIN * C;          //           [SP][C] (row 0 at MARGIN)
  float* DH1 = DH + SP * C;                       //           [SP][C]
  float* W = base + REGION;                       // the current conv's [k][C][C]
  int k_max = 1;
  for (int j = 0; j < spec.n_blocks; ++j) k_max = max(k_max, spec.k[j]);
  float* rbias = W + k_max * C * C;               // [WARPS][C] bias sums; conv_post's cotangent

  const int tid = threadIdx.x;
  // block 0's thread 0 adds the clocks of each phase, from barrier to barrier, when asked
  unsigned long long* const prof = blockIdx.x == 0 && tid == 0 ? phase_clocks : nullptr;
  long long prof_t = clock64();
  int prof_phase = P_UP_BWD;
  auto mark = [&](int next) {
    if (prof) {
      const long long now = clock64();
      prof[prof_phase] += now - prof_t;
      prof_t = now;
      prof_phase = next;
    }
  };
  const int L = T_in * FOLD;
  const int n_tiles = (L + TILE - 1) / TILE;
  float* ws = workspace + static_cast<size_t>(blockIdx.x) * ws_size;
  float* UP = ws + n_convs * slab_floats;         // upsample output (swizzled, as XR)
  float* DX0 = UP + slab_floats;                  // its cotangent (swizzled)
  float* ACC = DX0 + slab_floats;                 // [FROWS][C] chain sum, then its grad
  float* part = partials + static_cast<size_t>(blockIdx.x) * partial_size;
  float* p_wup = part;
  float* p_bup = p_wup + FOLD * C_in * C;
  float* p_wmrf = p_bup + C;
  int mrf_size = 0;
  for (int j = 0; j < spec.n_blocks; ++j) mrf_size += 2 * spec.nd[j] * spec.k[j] * C * C;
  float* p_bmrf = p_wmrf + mrf_size;
  float* p_wpost = p_bmrf + n_convs * C;
  float* p_bpost = p_wpost + POST_K * C;

  for (int tile_id = blockIdx.x; tile_id < B * n_tiles; tile_id += gridDim.x) {
    const int b = tile_id / n_tiles;
    const int t0 = (tile_id % n_tiles) * TILE;
    const int t_first = t0 - HALO;                // global sample of slab row 0
    const int zrow0 = t_first / FOLD;             // exact: t_first % FOLD == 0
    const float* zb = z + static_cast<size_t>(b) * T_in * C_in;
    auto valid = [&](int r) { return t_first + r >= 0 && t_first + r < L; };

    // ---- 1. forward recompute, saving each conv's input ---------------------------
    {
      const float* w = wmrf_t;  // [tap][c_out][c_in]: conv_mma's layout
      const float* bias = bmrf;
      int conv = 0;
      for (int j = 0; j < spec.n_blocks; ++j) {
        __syncthreads();  // XR, A and H are free again
        mark(P_FWD_INPUT);
        if (j == 0) {
          for (int idx = tid; idx < ZROWS * C_in; idx += THREADS) {
            const int zr = zrow0 + idx / C_in;
            const float v = (zr >= 0 && zr < T_in)
                                ? zb[static_cast<size_t>(zr) * C_in + idx % C_in] : 0.f;
            H[idx] = leaky(v, 0.1f);
          }
          __syncthreads();
          // thread: channel co of fold f for every 4th z row from zq, each weight
          // loaded once
          const int co = tid & (C - 1), f = (tid / C) % FOLD, zq = tid / (C * FOLD);
          float sum[ZROWS / 4] = {};
          for (int ci = 0; ci < C_in; ++ci) {
            const float wv = __ldg(wup + (f * C_in + ci) * C + co);
#pragma unroll
            for (int i = 0; i < ZROWS / 4; ++i)
              sum[i] = fmaf(H[(zq + 4 * i) * C_in + ci], wv, sum[i]);
          }
          const float bias_up = __ldg(bup + co);
#pragma unroll
          for (int i = 0; i < ZROWS / 4; ++i) {
            const int s = (zq + 4 * i) * FOLD + f;
            const float v = valid(s) ? sum[i] + bias_up : 0.f;
            XR[sw(s, co)] = v;
            A[sw(s, co)] = leaky(v, 0.1f);
            UP[sw(s, co)] = v;
          }
        } else {  // the upsample's output, computed once per tile
          for (int idx = tid; idx < S * C / 4; idx += THREADS) {
            const float4 v = reinterpret_cast<const float4*>(UP)[idx];
            reinterpret_cast<float4*>(XR)[idx] = v;
            reinterpret_cast<float4*>(A)[idx] = make_float4(
                leaky(v.x, 0.1f), leaky(v.y, 0.1f), leaky(v.z, 0.1f), leaky(v.w, 0.1f));
          }
        }
        const int k = spec.k[j];
        const int half = (k - 1) / 2;
        const int nd = spec.nd[j];
        int E = 0;
        for (int p = 0; p < nd; ++p) E += (spec.d[j][p] + 1) * half;
        for (int p = 0; p < nd; ++p) {
          const int dp = spec.d[j][p];
          E -= (dp + 1) * half;
          const int r2_lo = F_LO - E, r2_hi = F_LO + FROWS + E;
          __syncthreads();  // W is free, A settled
          mark(P_FWD_STAGE);
          stage_weights(W, w, k);
          copy_slab(ws + conv * slab_floats, A);
          cp_async_wait_all();
          __syncthreads();
          mark(P_FWD_CONV_D);
          {
            const float* bc = bias;
            auto epi = [&](int r, int co, float v0, float v1) {
                              const bool ok = valid(r);
                              *reinterpret_cast<float2*>(H + sw(r, co)) = make_float2(
                                  leaky(ok ? v0 + __ldg(bc + co) : 0.f, 0.1f),
                                  leaky(ok ? v1 + __ldg(bc + co + 1) : 0.f, 0.1f));
                            };
            conv_mma<false>(A, W, k, dp, r2_lo - half, r2_hi + half, epi);
          }
          w += k * C * C;
          bias += C;
          __syncthreads();
          mark(P_FWD_STAGE);
          stage_weights(W, w, k);
          copy_slab(ws + (conv + 1) * slab_floats, H);
          cp_async_wait_all();
          __syncthreads();
          mark(P_FWD_CONV_1);
          {
            const float* bc = bias;
            const bool last = p + 1 == nd, init = j == 0;
            auto epi = [&](int r, int co, float v0, float v1) {
                              const bool ok = valid(r);
                              float2* xr = reinterpret_cast<float2*>(XR + sw(r, co));
                              float2 x = *xr;
                              x.x += ok ? v0 + __ldg(bc + co) : 0.f;
                              x.y += ok ? v1 + __ldg(bc + co + 1) : 0.f;
                              if (!last) {
                                *xr = x;
                                *reinterpret_cast<float2*>(A + sw(r, co)) =
                                    make_float2(leaky(x.x, 0.1f), leaky(x.y, 0.1f));
                              } else {
                                float2* dst =
                                    reinterpret_cast<float2*>(ACC + (r - F_LO) * C + co);
                                if (!init) {
                                  const float2 a = *dst;
                                  x.x += a.x;
                                  x.y += a.y;
                                }
                                *dst = x;
                              }
                            };
            conv_mma<false>(H, W, k, 1, r2_lo, r2_hi, epi);
          }
          w += k * C * C;
          bias += C;
          conv += 2;
        }
      }
    }
    __syncthreads();
    mark(P_POST);

    // ---- 2. conv_post and tanh backward -----------------------------------------
    const float inv_n = 1.f / static_cast<float>(spec.n_blocks);
    float* Y = DX;          // [FROWS][C] conv_post's input
    float* DPRE = rbias;    // [TILE] cotangent of conv_post's output
    for (int idx = tid; idx < FROWS * C; idx += THREADS)
      Y[idx] = leaky(ACC[idx] / static_cast<float>(spec.n_blocks), 0.01f);
    __syncthreads();
    if (tid < TILE) {
      const int t = t0 + tid;
      float g = 0.f;
      if (t < L) {
        float sum = 0.f;
        for (int tap = 0; tap < POST_K; ++tap) {
          const float* row = Y + (tid + tap) * C;
          for (int j = 0; j < C; ++j) {
            const int ci = (j + tid) & (C - 1);
            sum = fmaf(row[ci], __ldg(wpost + tap * C + ci), sum);
          }
        }
        const float a = tanhf(sum + __ldg(bpost));
        g = __ldg(dy + static_cast<size_t>(b) * L + t) * (1.f - a * a);
      }
      DPRE[tid] = g;
    }
    __syncthreads();
    if (tid < POST_K * C) {
      const int tap = tid / C, ci = tid % C;
      float s = 0.f;
      for (int i = 0; i < TILE; ++i) s = fmaf(DPRE[i], Y[(i + tap) * C + ci], s);
      p_wpost[tid] += s;
    } else if (tid == THREADS - 1) {
      float s = 0.f;
      for (int i = 0; i < TILE; ++i) s += DPRE[i];
      p_bpost[0] += s;
    }
    // the chain sum's cotangent, in place of the chain sum
    for (int idx = tid; idx < FROWS * C; idx += THREADS) {
      const int r = idx / C, c = idx % C;
      float g = 0.f;
      for (int tap = 0; tap < POST_K; ++tap) {
        const int i = r - tap;
        if (i >= 0 && i < TILE) g = fmaf(DPRE[i], __ldg(wpost + tap * C + c), g);
      }
      const float dmean = g * dleaky(ACC[idx], 0.01f) * inv_n;
      ACC[idx] = valid(F_LO + r) ? dmean : 0.f;
    }
    __syncthreads();
    mark(P_BWD_STAGE);

    // ---- 3. each chain backward, pair by pair from the last -------------------------
    {
      int conv0 = 0;        // first conv of chain j
      int woff0 = 0;        // its offset in the packed MRF kernels
      for (int j = 0; j < spec.n_blocks; ++j) {
        const int k = spec.k[j];
        const int half = (k - 1) / 2;
        const int nd = spec.nd[j];
        for (int idx = tid; idx < S * C; idx += THREADS) {
          const int r = idx / C, c = idx % C;
          DX[sw(r, c)] = (r >= F_LO && r < F_LO + FROWS) ? ACC[(r - F_LO) * C + c] : 0.f;
        }
        int E = 0;          // halo rows still needed after pair p (E_p)
        for (int p = nd - 1; p >= 0; --p) {
          const int dp = spec.d[j][p];
          const int r2_lo = F_LO - E, r2_hi = F_LO + FROWS + E;
          const int r1_lo = r2_lo - half, r1_hi = r2_hi + half;
          const int r0_lo = r1_lo - half * dp, r0_hi = r1_hi + half * dp;
          const int c1 = conv0 + 2 * p, c2 = c1 + 1;
          const int w1 = woff0 + 2 * p * k * C * C, w2 = w1 + k * C * C;
          __syncthreads();
          mark(P_BWD_STAGE);
          // conv_1's output cotangent (masked) and its saved input leaky(h)
          for (int idx = tid; idx < SP * C / 4; idx += THREADS) {
            const int r = idx / (C / 4) - MARGIN, c = (idx % (C / 4)) * 4;
            *reinterpret_cast<float4*>(DH + sw(r, c)) =
                (r >= r2_lo && r < r2_hi && valid(r))
                    ? *reinterpret_cast<const float4*>(DX + sw(r, c))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          stage(DH1, ws + c2 * slab_floats, r1_lo, r1_hi);
          stage_weights(W, wmrf + w2, k);
          cp_async_wait_but_last();
          __syncthreads();
          mark(P_BWD_WGRAD);
          weight_grad(DH1, DH, k, 1, r2_lo, r2_hi, p_wmrf + w2, p_bmrf + c2 * C, rbias);
          cp_async_wait_all();
          __syncthreads();
          mark(P_BWD_CONV_1);
          // conv_d's output cotangent, in place of leaky(h)
          conv_mma<true>(DH, W, k, 1, r1_lo, r1_hi, [&](int r, int co, float v0, float v1) {
            float2* o = reinterpret_cast<float2*>(DH1 + sw(r, co));
            const float2 g = *o;
            *o = valid(r) ? make_float2(v0 * dleaky(g.x, 0.1f), v1 * dleaky(g.y, 0.1f))
                          : make_float2(0.f, 0.f);
          });
          __syncthreads();
          mark(P_BWD_STAGE);
          stage(DH, ws + c1 * slab_floats, r0_lo, r0_hi);
          stage_weights(W, wmrf + w1, k);
          cp_async_wait_but_last();
          __syncthreads();
          mark(P_BWD_WGRAD);
          weight_grad(DH, DH1, k, dp, r1_lo, r1_hi, p_wmrf + w1, p_bmrf + c1 * C, rbias);
          cp_async_wait_all();
          __syncthreads();
          mark(P_BWD_CONV_D);
          // the residual's cotangent: the identity path (already in DX) + conv_d's
          conv_mma<true>(DH1, W, k, dp, r0_lo, r0_hi, [&](int r, int co, float v0, float v1) {
            const float2 g = *reinterpret_cast<const float2*>(DH + sw(r, co));
            float2* o = reinterpret_cast<float2*>(DX + sw(r, co));
            float2 x = *o;
            x.x += v0 * dleaky(g.x, 0.1f);
            x.y += v1 * dleaky(g.y, 0.1f);
            *o = x;
          });
          E += (dp + 1) * half;
        }
        __syncthreads();
        mark(P_BWD_SUM);
        for (int idx = tid; idx < S * C / 4; idx += THREADS) {
          float4 v = reinterpret_cast<const float4*>(DX)[idx];
          if (j > 0) {
            const float4 o = reinterpret_cast<const float4*>(DX0)[idx];
            v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
          }
          reinterpret_cast<float4*>(DX0)[idx] = v;
        }
        conv0 += 2 * nd;
        woff0 += 2 * nd * k * C * C;
      }
    }
    __syncthreads();
    mark(P_UP_BWD);

    // ---- 4. upsample backward ------------------------------------------------------
    float* LZ = DH;         // [ZROWS][C_in] z rows behind the slab
    for (int idx = tid; idx < S * C / 4; idx += THREADS)
      reinterpret_cast<float4*>(DX)[idx] = valid(idx / (C / 4))
                                               ? reinterpret_cast<const float4*>(DX0)[idx]
                                               : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int idx = tid; idx < ZROWS * C_in; idx += THREADS) {
      const int zr = zrow0 + idx / C_in;
      LZ[idx] = (zr >= 0 && zr < T_in) ? zb[static_cast<size_t>(zr) * C_in + idx % C_in]
                                       : 0.f;
    }
    __syncthreads();
    {
      const int warp = tid >> 5, lane = tid & 31;
      float s = 0.f;
      for (int r = warp; r < S; r += WARPS) s += DX[sw(r, lane)];
      rbias[warp * C + lane] = s;
    }
    for (int idx = tid; idx < FOLD * C_in * (C / 4); idx += THREADS) {
      const int f = idx / (C_in * (C / 4)), ci = (idx / (C / 4)) % C_in, c4 = (idx % (C / 4)) * 4;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int zr = 0; zr < ZROWS; ++zr) {
        const float a = leaky(LZ[zr * C_in + ci], 0.1f);
        const float4 g = *reinterpret_cast<const float4*>(DX + sw(zr * FOLD + f, c4));
        s.x = fmaf(a, g.x, s.x);
        s.y = fmaf(a, g.y, s.y);
        s.z = fmaf(a, g.z, s.z);
        s.w = fmaf(a, g.w, s.w);
      }
      float4* p = reinterpret_cast<float4*>(p_wup + (f * C_in + ci) * C + c4);
      float4 o = *p;
      o.x += s.x;
      o.y += s.y;
      o.z += s.z;
      o.w += s.w;
      *p = o;
    }
    // dz: lanes 4m..4m+3 share a z channel and a group of z rows, each summing 8 of
    // the 32 channels with its weights in registers; two shuffles add the four
    {
      float* dz_tile = dzs + static_cast<size_t>(tile_id) * ZROWS * C_in;
      const int groups = max(1, THREADS / (4 * C_in));
      const int live_lanes = 4 * C_in * groups;
      const unsigned quad = 0xfu << (tid & 28);
      for (int item = tid; item < (live_lanes + 31) / 32 * 32; item += THREADS) {
        const int q = item & 3, ci = (item >> 2) % C_in, zg = (item >> 2) / C_in;
        const bool live = item < live_lanes;
        float wr[FOLD][8];
#pragma unroll
        for (int f = 0; f < FOLD; ++f) {
          const float4* wp = reinterpret_cast<const float4*>(wup + (f * C_in + ci) * C + q * 8);
          const float4 u = __ldg(wp), v = __ldg(wp + 1);
          wr[f][0] = u.x; wr[f][1] = u.y; wr[f][2] = u.z; wr[f][3] = u.w;
          wr[f][4] = v.x; wr[f][5] = v.y; wr[f][6] = v.z; wr[f][7] = v.w;
        }
        for (int zr = live ? zg : 0; zr < ZROWS; zr += groups) {
          float sum = 0.f;
#pragma unroll
          for (int f = 0; f < FOLD; ++f) {
            const float4 u = *reinterpret_cast<const float4*>(DX + sw(zr * FOLD + f, q * 8));
            const float4 v = *reinterpret_cast<const float4*>(DX + sw(zr * FOLD + f, q * 8 + 4));
            sum = fmaf(u.x, wr[f][0], sum);
            sum = fmaf(u.y, wr[f][1], sum);
            sum = fmaf(u.z, wr[f][2], sum);
            sum = fmaf(u.w, wr[f][3], sum);
            sum = fmaf(v.x, wr[f][4], sum);
            sum = fmaf(v.y, wr[f][5], sum);
            sum = fmaf(v.z, wr[f][6], sum);
            sum = fmaf(v.w, wr[f][7], sum);
          }
          sum += __shfl_xor_sync(quad, sum, 1);
          sum += __shfl_xor_sync(quad, sum, 2);
          if (live && q == 0) dz_tile[zr * C_in + ci] = sum * dleaky(LZ[zr * C_in + ci], 0.1f);
        }
      }
    }
    __syncthreads();
    if (tid < C) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += rbias[w * C + tid];
      p_bup[tid] += s;
    }
  }
  mark(P_UP_BWD);
}

}  // namespace

extern "C" {

// z (B, T_in, C_in) fp32; dy (B, 4 * T_in) fp32; wup [4][C_in][32]; bup [32]; wmrf:
// per conv [k][32][32] (tap, c_in, c_out), in chain order, k <= 15, and wmrf_t the same
// convs transposed ([k][c_out][c_in]); bmrf [n_convs][32];
// wpost [7][32]; bpost [1]; spec as for ttscube_fused_tail_stage. All 16-byte aligned.
// n_blocks thread blocks; workspace n_blocks * ws_size floats, ws_size at least
// (n_convs + 2) * 384 * 32 + 262 * 32; partials n_blocks * partial_size floats (a
// multiple of 4, at least the grads' size), zeroed by the caller, each block's laid
// out as wup, bup, wmrf, bmrf, wpost, bpost; dzs (B, n_tiles, 96, C_in) with n_tiles =
// ceil(4 * T_in / 256): each tile's cotangent of z rows [64 * tile - 16, 64 * tile + 80);
// phase_clocks (device, may be null) receives, added to what it holds, block 0's clocks
// in each of the limits' n_phases phases of its tiles. Returns cudaGetLastError() after
// the launch.
int ttscube_fused_tail_stage_grad(const float* z, int B, int T_in, int C_in,
                                  const float* dy, const float* wup, const float* bup,
                                  const float* wmrf, const float* wmrf_t, const float* bmrf,
                                  const float* wpost,
                                  const float* bpost, const int* spec_in, int n_blocks,
                                  float* workspace, long long ws_size, float* partials,
                                  long long partial_size, float* dzs,
                                  unsigned long long* phase_clocks, void* stream) {
  Spec spec{};
  spec.n_blocks = spec_in[0];
  if (spec.n_blocks < 1 || spec.n_blocks > MAX_BLOCKS || C_in < 1 || C_in > MAX_C_IN ||
      B < 1 || T_in < 1 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_convs = 0, k_max = 1;
  long long size = static_cast<long long>(FOLD) * C_in * C + C + POST_K * C + 1;
  for (int j = 0; j < spec.n_blocks; ++j) {
    const int* e = spec_in + 1 + j * (2 + MAX_DILS);
    spec.k[j] = e[0];
    spec.nd[j] = e[1];
    if (spec.nd[j] < 1 || spec.nd[j] > MAX_DILS || e[0] < 1 || e[0] % 2 == 0 || e[0] > MAX_K)
      return static_cast<int>(cudaErrorInvalidValue);
    k_max = e[0] > k_max ? e[0] : k_max;
    const int half = (e[0] - 1) / 2;
    int total = 0;
    for (int p = 0; p < MAX_DILS; ++p) {
      spec.d[j][p] = e[2 + p];
      if (p < spec.nd[j]) {
        total += (e[2 + p] + 1) * half;
        if (e[2 + p] < 1 || half * e[2 + p] > MARGIN) return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    if (total > F_LO) return static_cast<int>(cudaErrorInvalidValue);
    n_convs += 2 * spec.nd[j];
    size += 2LL * spec.nd[j] * (static_cast<long long>(e[0]) * C * C + C);
  }
  // each block's partial starts on a 16-byte boundary for the float4 updates
  if (size > partial_size || partial_size % 4 != 0 ||
      ws_size < (n_convs + 2) * slab_floats + FROWS * C || ws_size % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(REGION + k_max * C * C + RBIAS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tail_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_grad_kernel<<<n_blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      z, B, T_in, C_in, dy, wup, bup, wmrf, wmrf_t, bmrf, wpost, bpost, spec, n_convs, workspace,
      ws_size, partials, partial_size, dzs, phase_clocks);
  return static_cast<int>(cudaGetLastError());
}

// The tiling constants, so that the wrapper can check its inputs against them and
// size the workspace and the z-cotangent slabs.
int ttscube_fused_tail_stage_grad_limits(int* out) {
  out[0] = C;
  out[1] = FOLD;
  out[2] = POST_K;
  out[3] = MAX_BLOCKS;
  out[4] = MAX_DILS;
  out[5] = F_LO;
  out[6] = MAX_C_IN;
  out[7] = TILE;
  out[8] = HALO;
  out[9] = MARGIN;
  out[10] = MAX_K;
  out[11] = N_PHASES;
  return 0;
}

}  // extern "C"
