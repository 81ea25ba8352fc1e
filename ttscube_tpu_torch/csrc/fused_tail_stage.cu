// The whole final HiFi-GAN generator stage as one kernel, for sm_90a.
//
// Replaces the TPU kernel `fused_tail_stage` (ttscube_tpu/ops/pallas_resblock.py:295,
// kernel body `_tail_kernel` :270 / `_tail_tile_fn` :190). Per output sample it computes
//   leaky(0.1) -> ConvTranspose1d with kernel == stride == 4 (C_in -> 32 channels)
//   -> for each MRF ResBlock1 chain (kernel k, dilations d...):
//        x += conv_1(leaky(conv_d(leaky(x))))        (all convs "same", 32 -> 32)
//   -> mean of the chains -> leaky(0.01) -> conv_post (k = 7, 32 -> 1) -> tanh.
// Positions outside [0, 4 * T_in) are zeroed after every conv, which is the plain
// path's zero "same" padding.
//
// What bounds it on an H100: operations. About 262.6 kFLOP per output sample
// (2 * (2,048 upsample + 129,024 MRF + 224 post) MACs at the v1 widths) against a few
// bytes of input and 4 bytes of output per sample, far right of the ridge point: at
// B = 1, F = 256 frames 16.15 GFLOP, 0.016 ms at bf16's 989 TFLOP/s; in fp32 the least
// time is 3xTF32's, three TF32 products at 495 TFLOP/s for each (0.098 ms there, 0.305
// ms at the training shape B = 16, T_in = 3,000).
//
// What the design does about it. Every MRF conv (98 % of the work) runs on the tensor
// cores as an implicit GEMM, M = slab rows, N = the 32 output channels, K = (tap, input
// channel): a tap is a row offset (tap - half) * d into the staged slab, so ldmatrix
// reads the A fragments straight from the slab (no im2col). Two operand forms:
//   bf16 (serving): mma.sync.m16n8k16 bf16 with fp32 accumulators. The conv inputs
//     A = rnd(leaky(x)) and H = rnd(leaky(conv_d)) are bf16 values by the dtype rule,
//     so they are stored as bf16 (exact), rows padded by PAD elements so that
//     ldmatrix's 8 row addresses fall on distinct banks; the weights are staged as
//     bf16 [tap][c_in][c_out] (exact: the wrapper rounded them) and read by
//     ldmatrix.trans.
//   fp32 (training, validation): 3xTF32 on mma.sync.m16n8k8, as kernel B2's forward
//     recompute (csrc/fused_tail_stage_grad.cu): each operand split into two TF32
//     pieces, rounded (`split`), three products (`mma3`) into fresh accumulators
//     flushed into fp32 sums once per tap (`flush`: the tensor cores' accumulation
//     rounds toward zero). Slabs are fp32 with B2's XOR swizzle (`sw`); conv_d's input
//     leaky(x) is taken from the residual stream as it is loaded, so no A slab is
//     kept; weights are staged as [tap][c_in] rows of 32 floats whose four n-tile
//     values for a lane sit in one 16-byte group, the groups XOR-swizzled by the row,
//     so that each B fragment for all four n-tiles is one conflict-free 16-byte load.
// The residual stream XR, the chain sum ACC, biases and the mean stay fp32 in both.
// A conv pass deals items of 16 rows x 32 channels round the 8 warps (at most NI
// each). In bf16 a warp runs its items together, so that each step's B fragments
// serve all of them; in fp32 one item at a time (its 3xTF32 sums need the registers).
// Either way the next step's fragments load while this step's MMAs issue. A conv's
// weights are staged in shared memory once per pass, in chunks of KT taps when k is
// larger (the items' sums stay in registers across the chunks), and a lane's biases
// load before the MMAs. The upsample and conv_post (~2 % of the work) stay on the CUDA
// cores; the upsample is computed once per tile and kept (UP) for the later chains.
// Measured on an H100 (PERF.md, chip_variants.py): padding the bf16 rows makes the
// bf16 form 1.5x faster; 16 warps a block spill in fp32 and gain nothing in bf16;
// what holds the kernel back is each pass's fixed cost (the barriers, the weights'
// staging, the epilogue while the tensor cores idle), about half of a tile's clocks in
// bf16.
//
// Tiling: one thread block per (batch row, tile of TILE output samples). The block
// holds the upsampled activation over the tile plus HALO samples on each side, enough
// for the longest MRF chain (60 samples for k = 11, d = 1, 3, 5) and conv_post (3).
// Each conv computes exactly the rows that the rest of the chain still needs, so the
// region shrinks along the chain; rows of the last item past the region are read
// clamped to its last row and never stored. Every output element is summed by one
// lane in a fixed order, with no atomics: launches are bit-equal.
//
// Precision: with bf16 = 1 every conv operand is rounded to bf16 (activations here,
// the weights by the wrapper when it packs them) while products, sums, biases,
// residuals and the chain mean stay fp32 -- the TPU kernel's rule for serving (bf16
// operands, fp32 accumulation and residuals).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int C = 32;                      // stage channels
constexpr int FOLD = 4;                    // upsample factor == its kernel size
constexpr int TILE = 256;                  // output samples per thread block
constexpr int HALO = 64;                   // slab samples on each side of the tile
constexpr int S = TILE + 2 * HALO;         // slab samples
constexpr int ZROWS = S / FOLD;            // input rows behind the slab
constexpr int POST_K = 7;
constexpr int POST_PAD = (POST_K - 1) / 2;
constexpr int F_LO = HALO - POST_PAD;      // first slab row conv_post reads
constexpr int FROWS = TILE + 2 * POST_PAD; // MRF output rows conv_post reads
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 4;
constexpr int MAX_DILS = 4;
constexpr int MAX_C_IN = 128;
constexpr int ITEMS = S / 16;              // most 16-row items of a conv pass
constexpr int NI = (ITEMS + WARPS - 1) / WARPS;  // most items of a warp in a pass
constexpr int PAD = 8;                     // bf16 elements of padding per bf16 row
constexpr int BS = C + PAD;                // bf16 row stride, elements
constexpr int KT_BF16 = 15;                // taps of a conv's weights staged at once
constexpr int KT_FP32 = 12;

// shared memory, bytes: bf16 [XR fp32][UP fp32][A bf16][H bf16][ACC fp32][W bf16];
// fp32 [XR][UP][H][ACC][W], all fp32
constexpr int SLAB32 = S * C * 4;
constexpr int SLAB16 = S * BS * 2;
constexpr int ACC_BYTES = FROWS * C * 4;

template <bool BF16>
struct Layout {
  static constexpr int XR = 0;
  static constexpr int UP = SLAB32;
  static constexpr int A = 2 * SLAB32;                         // bf16 only
  static constexpr int H = BF16 ? 2 * SLAB32 + SLAB16 : 2 * SLAB32;
  static constexpr int ACC = BF16 ? 2 * SLAB32 + 2 * SLAB16 : 3 * SLAB32;
  static constexpr int W = ACC + ACC_BYTES;
  static constexpr int KT = BF16 ? KT_BF16 : KT_FP32;
  static constexpr int BYTES = W + KT * C * (BF16 ? BS * 2 : C * 4);
  static constexpr int Z = BF16 ? A : H;                       // z rows, before the chains
  static constexpr int Z_BYTES = BF16 ? 2 * SLAB16 : SLAB32;
};

static_assert(Layout<true>::BYTES <= 232448 && Layout<false>::BYTES <= 232448,
              "one block's shared memory");
static_assert(MAX_C_IN % 4 == 0, "z rows padded to 4 channels fit at the most channels");
static_assert(ZROWS * MAX_C_IN * 4 <= Layout<true>::Z_BYTES &&
              ZROWS * MAX_C_IN * 4 <= Layout<false>::Z_BYTES, "z rows fit their scratch");
static_assert(NI * WARPS * 16 >= S, "a pass's items fit the warps' registers");
static_assert(THREADS % (C * FOLD) == 0 && ZROWS % (THREADS / (C * FOLD)) == 0,
              "the upsample's thread map");
static_assert(HALO % FOLD == 0 && TILE % FOLD == 0, "slab must start on an input row");
static_assert(PAD % 8 == 0, "bf16 rows stay 16-byte aligned for ldmatrix");

struct Spec {
  int n_blocks;
  int k[MAX_BLOCKS];
  int nd[MAX_BLOCKS];
  int d[MAX_BLOCKS][MAX_DILS];
};

enum { FIRST = 0, SECOND = 1, LAST = 2 };

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16(x));  // round to nearest even
  } else {
    return x;
  }
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : x * slope;
}

// element (r, c) of an fp32 [rows][32] slab: the columns of row r permuted within
// aligned groups of 4, so a fragment load of 8 rows x 4 columns reads 32 distinct
// banks, and float2 / float4 groups stay contiguous (kernel B2's layout)
__device__ __forceinline__ int phase(int r) { return ((r & 3) << 3) | (r & 4); }
__device__ __forceinline__ int sw(int r, int c) { return r * C + (c ^ phase(r)); }

// the shared-memory buffers of a block
struct Bufs {
  float* XR;             // [S][C] residual stream (swizzled)
  float* UP;             // [S][C] the upsample's output (swizzled)
  __nv_bfloat16* A16;    // bf16 form: [S][BS] conv_d's input
  __nv_bfloat16* H16;    // bf16 form: [S][BS] conv_1's input
  float* H32;            // fp32 form: [S][C] conv_1's input (swizzled)
  float* ACC;            // [FROWS][C] sum of the chains
  void* W;               // the current chunk of a conv's weights
};

// Stage taps [0, nt) of a conv's weights w [tap][c_in][c_out] (fp32 in device memory).
// bf16: as bf16 rows [tap * C + c_in][BS]. fp32: row (tap, c_in) holds c_out 8n + g at
// float 4 (g ^ ((c_in & 3) << 1)) + n.
template <bool BF16>
__device__ void stage_weights(void* W, const float* __restrict__ w, int nt) {
  if constexpr (BF16) {
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(W);
    for (int i = threadIdx.x; i < nt * C * (C / 8); i += THREADS) {
      const int row = i / (C / 8), q = (i % (C / 8)) * 8;
      const float4 x0 = __ldg(reinterpret_cast<const float4*>(w + row * C + q));
      const float4 x1 = __ldg(reinterpret_cast<const float4*>(w + row * C + q + 4));
      *reinterpret_cast<uint4*>(dst + row * BS + q) =
          make_uint4(pack_bf16(x0.x, x0.y), pack_bf16(x0.z, x0.w), pack_bf16(x1.x, x1.y),
                     pack_bf16(x1.z, x1.w));
    }
  } else {
    float* dst = static_cast<float*>(W);
    for (int i = threadIdx.x; i < nt * C * 8; i += THREADS) {
      const int row = i >> 3, g = i & 7;
      const float* src = w + row * C + g;
      *reinterpret_cast<float4*>(dst + row * C + 4 * (g ^ ((row & 3) << 1))) =
          make_float4(__ldg(src), __ldg(src + 8), __ldg(src + 16), __ldg(src + 24));
    }
  }
}

// bf16: acc[i][n] += the products of the warp's item i (rows r_lo + 16 (warp + i WARPS)
// .. + 15, for i < ni; rows past r_hi read as row r_hi - 1) with taps [t0, t0 + nt) of
// the staged weights, for n-tile n (channels 8n .. 8n + 7); `in` the shared address of
// a bf16 [S][BS] slab. The items share each step's B fragments; a step is one tap's 16
// input channels, and the next step's fragments load while this step's MMAs issue.
__device__ __forceinline__ void items_bf16(float (&acc)[NI][4][4], int ni, uint32_t in,
                                           uint32_t W, int t0, int nt, int half, int d,
                                           int r_lo, int r_hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // A: lanes 0-15 rows 0-15 at k 0, lanes 16-31 the same rows at k 8; B (16 k x 16 n,
  // transposed): k rows (lane & 7) + 8 ((lane >> 3) & 1) at n 8 (lane >> 4)
  uint32_t a_base[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int ra = min(r_lo + 16 * (warp + i * WARPS) + (lane & 15), r_hi - 1);
    a_base[i] = in + (ra * BS + (lane >> 4) * 8) * 2;
  }
  const uint32_t b_base = W + (((lane & 7) + ((lane >> 3) & 1) * 8) * BS + (lane >> 4) * 8) * 2;
  auto load = [&](uint32_t (&bf)[2][4], uint32_t (&af)[NI][4], int j, int kk) {
    const uint32_t bp = b_base + (j * C + kk) * BS * 2;
    ldsm_x4_trans(bf[0], bp);
    ldsm_x4_trans(bf[1], bp + 16 * 2);
    const uint32_t a_off = ((t0 + j - half) * d * BS + kk) * 2;
#pragma unroll
    for (int i = 0; i < NI; ++i)
      if (i < ni) ldsm_x4(af[i], a_base[i] + a_off);
  };
  auto mma = [&](const uint32_t (&bf)[2][4], const uint32_t (&af)[NI][4]) {
#pragma unroll
    for (int i = 0; i < NI; ++i)
      if (i < ni) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_bf16(acc[i][n], af[i], bf[n >> 1][(n & 1) * 2], bf[n >> 1][(n & 1) * 2 + 1]);
      }
  };
  static_assert(C == 32, "a tap is two steps of 16 channels");
  uint32_t b0[2][4], b1[2][4], a0[NI][4], a1[NI][4];
  load(b0, a0, 0, 0);
  for (int j = 0; j < nt; ++j) {
    load(b1, a1, j, 16);
    mma(b0, a0);
    if (j + 1 < nt) load(b0, a0, j + 1, 0);
    mma(b1, a1);
  }
}

// fp32 in 3xTF32: acc[n] += the products of rows [r0, r0 + 16) (rows past r_hi read as
// row r_hi - 1) with taps [t0, t0 + nt) of the staged weights, from an fp32 [S][C]
// swizzled slab; LEAKY applies leaky(0.1) to the slab's values as they are loaded
// (conv_d reads leaky(XR)). A step is one tap's 8 input channels, and the next step's
// operands load while this step's are split and multiplied.
template <bool LEAKY>
__device__ __forceinline__ void item_tf32(float (&acc)[4][4], const float* in, const float* W,
                                          int t0, int nt, int half, int d, int r0, int r_hi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = min(r0 + (lane & 15), r_hi - 1);
  const int a_col = (lane >> 4) * 4;  // A: rows 0-15 at channels 0, then 4
  // B: this lane's four n-tile values of column g in weight rows t and t + 4 of a step
  const float* bp = W + t * C + 4 * (g ^ (t << 1));
  // the raw operands of step (j, kc): sw(r, c + kc) == sw(r, c) ^ kc for c < 8 and kc
  // a multiple of 8
  auto load = [&](uint32_t (&av)[4], float4 (&wv)[2], int j, int kc) {
    ldsm_x4(av, smem_addr(in + (sw(ra + (t0 + j - half) * d, a_col) ^ kc)));
    const float* wt = bp + (j * C + kc) * C;
    wv[0] = *reinterpret_cast<const float4*>(wt);
    wv[1] = *reinterpret_cast<const float4*>(wt + 4 * C);
  };
  auto mma = [&](float (&part)[4][2][4], const uint32_t (&av)[4], const float4 (&wv)[2]) {
    uint32_t a[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = __uint_as_float(av[e]);
      split<true>(a, e, LEAKY ? leaky(x, 0.1f) : x);
    }
    const float b0[4] = {wv[0].x, wv[0].y, wv[0].z, wv[0].w};
    const float b1[4] = {wv[1].x, wv[1].y, wv[1].z, wv[1].w};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      uint32_t b[2][2];
      split<true>(b, 0, b0[n]);
      split<true>(b, 1, b1[n]);
      mma3(part[n], a, b);
    }
  };
  static_assert(C % 16 == 0, "a tap is pairs of steps of 8 channels");
  float part[4][2][4] = {};
  uint32_t av0[4], av1[4];
  float4 wv0[2], wv1[2];
  load(av0, wv0, 0, 0);
  for (int j = 0; j < nt; ++j) {
#pragma unroll
    for (int kc = 0; kc < C; kc += 16) {
      load(av1, wv1, j, kc + 8);
      mma(part, av0, wv0);
      if (kc + 16 < C)
        load(av0, wv0, j, kc + 16);
      else if (j + 1 < nt)
        load(av0, wv0, j + 1, 0);
      mma(part, av1, wv1);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) flush(acc[n], part[n]);  // once per tap: 4 steps
  }
}

// One "same" conv over slab rows [r_lo, r_hi): sum over taps and input channels of
// in[r + (tap - half) * d][ci] * w[tap][ci][co], plus bias, zeroed outside [0, L).
//   FIRST:  H = rnd(leaky(out))                       (input of the pair's second conv)
//   SECOND: XR += out; A = rnd(leaky(XR))             (residual; next pair's input; the
//           fp32 form keeps no A and reads leaky(XR) as it loads)
//   LAST:   ACC (=|+=) XR + out                       (chain output into the mean)
// It begins with a barrier: the previous pass's outputs are complete and W is free.
template <bool BF16, int MODE>
__device__ void conv_pass(const Bufs& s, const float* __restrict__ w,
                          const float* __restrict__ bias, int k, int d, int r_lo, int r_hi,
                          int t_first, int L, bool acc_init) {
  constexpr int KT = Layout<BF16>::KT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int half = (k - 1) / 2;
  const int items = (r_hi - r_lo + 15) >> 4;
  // this warp's items: warp, warp + WARPS, ...
  const int ni = items > warp ? (items - warp + WARPS - 1) / WARPS : 0;
  float bv[4][2];  // this lane's biases, loaded under the MMAs
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    bv[n][0] = __ldg(bias + 8 * n + 2 * t);
    bv[n][1] = __ldg(bias + 8 * n + 2 * t + 1);
  }
  float acc[NI][4][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
  for (int t0 = 0; t0 < k; t0 += KT) {
    const int nt = min(KT, k - t0);
    __syncthreads();
    stage_weights<BF16>(s.W, w + t0 * C * C, nt);
    __syncthreads();
    if constexpr (BF16) {
      items_bf16(acc, ni, smem_addr(MODE == FIRST ? s.A16 : s.H16), smem_addr(s.W), t0, nt,
                 half, d, r_lo, r_hi);
    } else {
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        if (i >= ni) break;
        item_tf32<MODE == FIRST>(acc[i], MODE == FIRST ? s.XR : s.H32,
                                 static_cast<const float*>(s.W), t0, nt, half, d,
                                 r_lo + 16 * (warp + i * WARPS), r_hi);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    if (i >= ni) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 16 * (warp + i * WARPS) + g + 8 * h;
      if (r >= r_hi) continue;
      const bool valid = t_first + r >= 0 && t_first + r < L;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int co = 8 * n + 2 * t;
        const float v0 = valid ? acc[i][n][2 * h] + bv[n][0] : 0.f;
        const float v1 = valid ? acc[i][n][2 * h + 1] + bv[n][1] : 0.f;
        if constexpr (MODE == FIRST) {
          if constexpr (BF16) {
            *reinterpret_cast<uint32_t*>(s.H16 + r * BS + co) =
                pack_bf16(leaky(v0, 0.1f), leaky(v1, 0.1f));
          } else {
            *reinterpret_cast<float2*>(s.H32 + sw(r, co)) =
                make_float2(leaky(v0, 0.1f), leaky(v1, 0.1f));
          }
        } else {
          float2* xr = reinterpret_cast<float2*>(s.XR + sw(r, co));
          float2 x = *xr;
          x.x += v0;
          x.y += v1;
          if constexpr (MODE == SECOND) {
            *xr = x;
            if constexpr (BF16)
              *reinterpret_cast<uint32_t*>(s.A16 + r * BS + co) =
                  pack_bf16(leaky(x.x, 0.1f), leaky(x.y, 0.1f));
          } else {
            float2* dst = reinterpret_cast<float2*>(s.ACC + (r - F_LO) * C + co);
            if (!acc_init) {
              const float2 a = *dst;
              x.x += a.x;
              x.y += a.y;
            }
            *dst = x;
          }
        }
      }
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
    tail_kernel(const float* __restrict__ z, int T_in, int C_in,
                const float* __restrict__ wup, const float* __restrict__ bup,
                const float* __restrict__ wmrf, const float* __restrict__ bmrf,
                const float* __restrict__ wpost, const float* __restrict__ bpost,
                Spec spec, float* __restrict__ out) {
  using Lay = Layout<BF16>;
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  Bufs s;
  s.XR = reinterpret_cast<float*>(base + Lay::XR);
  s.UP = reinterpret_cast<float*>(base + Lay::UP);
  s.A16 = reinterpret_cast<__nv_bfloat16*>(base + Lay::A);
  s.H16 = reinterpret_cast<__nv_bfloat16*>(base + Lay::H);
  s.H32 = reinterpret_cast<float*>(base + Lay::H);
  s.ACC = reinterpret_cast<float*>(base + Lay::ACC);
  s.W = base + Lay::W;
  float* Z = reinterpret_cast<float*>(base + Lay::Z);  // [ZROWS][CP], before the chains

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const int L = T_in * FOLD;
  const int t_first = t0 - HALO;                  // global sample of slab row 0
  const int zrow0 = t_first / FOLD;               // exact: t_first % FOLD == 0
  const float* zb = z + static_cast<size_t>(b) * T_in * C_in;
  auto valid = [&](int r) { return t_first + r >= 0 && t_first + r < L; };

  // upsample, once per tile:
  // UP[s][co] = b_up[co] + sum_ci rnd(leaky(z[s / 4][ci])) * Wup[s % 4][ci][co]
  const int CP = (C_in + 3) & ~3;  // Z's row stride: input channels, zero-padded to 4
#pragma unroll 4
  for (int idx = tid; idx < ZROWS * CP; idx += THREADS) {
    const int zr = zrow0 + idx / CP, ci = idx % CP;
    const float v = (zr >= 0 && zr < T_in && ci < C_in)
                        ? zb[static_cast<size_t>(zr) * C_in + ci] : 0.f;
    Z[idx] = rnd<BF16>(leaky(v, 0.1f));
  }
  __syncthreads();
  {
    // thread: channel co of fold f for every ZQ-th z row from zq, each weight loaded once
    constexpr int ZQ = THREADS / (C * FOLD);
    const int co = tid & (C - 1), f = (tid / C) % FOLD, zq = tid / (C * FOLD);
    float sum[ZROWS / ZQ] = {};
    for (int ci = 0; ci < CP; ci += 4) {
      float wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = ci + q < C_in ? __ldg(wup + (f * C_in + ci + q) * C + co) : 0.f;
#pragma unroll
      for (int i = 0; i < ZROWS / ZQ; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(Z + (zq + ZQ * i) * CP + ci);
        sum[i] = fmaf(x.w, wv[3], fmaf(x.z, wv[2], fmaf(x.y, wv[1], fmaf(x.x, wv[0], sum[i]))));
      }
    }
    const float bias_up = __ldg(bup + co);
#pragma unroll
    for (int i = 0; i < ZROWS / ZQ; ++i) {
      const int r = (zq + ZQ * i) * FOLD + f;
      s.UP[sw(r, co)] = valid(r) ? sum[i] + bias_up : 0.f;
    }
  }

  const float* w = wmrf;
  const float* bias = bmrf;
  for (int j = 0; j < spec.n_blocks; ++j) {
    __syncthreads();  // UP complete; the last chain's reads of XR, A and H are done
    for (int idx = tid; idx < S * C / 4; idx += THREADS) {
      const float4 v = reinterpret_cast<const float4*>(s.UP)[idx];
      reinterpret_cast<float4*>(s.XR)[idx] = v;
      if constexpr (BF16) {
        const int r = idx / (C / 4), c = ((idx % (C / 4)) * 4) ^ phase(r);
        *reinterpret_cast<uint2*>(s.A16 + r * BS + c) =
            make_uint2(pack_bf16(leaky(v.x, 0.1f), leaky(v.y, 0.1f)),
                       pack_bf16(leaky(v.z, 0.1f), leaky(v.w, 0.1f)));
      }
    }
    // the chain: each pair's output region is what the later pairs and conv_post read
    const int k = spec.k[j];
    const int half = (k - 1) / 2;
    const int nd = spec.nd[j];
    int E = 0;
    for (int p = 0; p < nd; ++p) E += (spec.d[j][p] + 1) * half;
    for (int p = 0; p < nd; ++p) {
      const int dp = spec.d[j][p];
      E -= (dp + 1) * half;
      const int r2_lo = F_LO - E, r2_hi = F_LO + FROWS + E;
      conv_pass<BF16, FIRST>(s, w, bias, k, dp, r2_lo - half, r2_hi + half, t_first, L,
                             false);
      w += k * C * C;
      bias += C;
      if (p + 1 < nd) {
        conv_pass<BF16, SECOND>(s, w, bias, k, 1, r2_lo, r2_hi, t_first, L, false);
      } else {
        conv_pass<BF16, LAST>(s, w, bias, k, 1, r2_lo, r2_hi, t_first, L, j == 0);
      }
      w += k * C * C;
      bias += C;
    }
  }
  __syncthreads();
  // mean of the chains, leaky(0.01), rounded for conv_post
  for (int idx = tid; idx < FROWS * C; idx += THREADS) {
    s.ACC[idx] = rnd<BF16>(leaky(s.ACC[idx] / static_cast<float>(spec.n_blocks), 0.01f));
  }
  __syncthreads();
  // conv_post (32 -> 1, k = 7) + tanh; one thread per output sample, channels read in
  // a rotated order so that the 32 lanes of a warp hit 32 different banks
  for (int i = tid; i < TILE; i += THREADS) {
    const int t = t0 + i;
    if (t >= L) break;
    float sum = 0.f;
    for (int tap = 0; tap < POST_K; ++tap) {
      const float* row = s.ACC + (i + tap) * C;
      for (int j = 0; j < C; ++j) {
        const int ci = (j + i) & (C - 1);
        sum = fmaf(row[ci], __ldg(wpost + tap * C + ci), sum);
      }
    }
    out[static_cast<size_t>(b) * L + t] = tanhf(sum + __ldg(bpost));
  }
}

template <bool BF16>
int launch(const float* z, int B, int T_in, int C_in, const float* wup,
           const float* bup, const float* wmrf, const float* bmrf, const float* wpost,
           const float* bpost, const Spec& spec, float* out, cudaStream_t stream) {
  const int smem = Layout<BF16>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(tail_kernel<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int L = T_in * FOLD;
  const dim3 grid((L + TILE - 1) / TILE, B);
  tail_kernel<BF16><<<grid, THREADS, smem, stream>>>(z, T_in, C_in, wup, bup, wmrf, bmrf,
                                                     wpost, bpost, spec, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// z (B, T_in, C_in) fp32; wup [4][C_in][32]; bup [32]; wmrf: per conv [k][32][32]
// (tap, c_in, c_out), in chain order; bmrf [n_convs][32]; wpost [7][32]; bpost [1];
// spec (host ints): n_blocks, then per block k, n_dilations, 4 dilations;
// out (B, 4 * T_in) fp32. Returns cudaGetLastError() after the launch.
int ttscube_fused_tail_stage(const float* z, int B, int T_in, int C_in, const float* wup,
                             const float* bup, const float* wmrf, const float* bmrf,
                             const float* wpost, const float* bpost, const int* spec_in,
                             int bf16, float* out, void* stream) {
  Spec spec{};
  spec.n_blocks = spec_in[0];
  if (spec.n_blocks < 1 || spec.n_blocks > MAX_BLOCKS || C_in < 1 || C_in > MAX_C_IN ||
      B < 1 || B > 65535 || T_in < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < spec.n_blocks; ++j) {
    const int* e = spec_in + 1 + j * (2 + MAX_DILS);
    spec.k[j] = e[0];
    spec.nd[j] = e[1];
    if (e[0] < 1 || e[0] % 2 != 1 || spec.nd[j] < 1 || spec.nd[j] > MAX_DILS)
      return static_cast<int>(cudaErrorInvalidValue);
    int total = 0;
    for (int p = 0; p < MAX_DILS; ++p) {
      spec.d[j][p] = e[2 + p];
      if (p >= spec.nd[j]) continue;
      if (e[2 + p] < 1) return static_cast<int>(cudaErrorInvalidValue);
      total += (e[2 + p] + 1) * ((e[0] - 1) / 2);
    }
    if (total > F_LO) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(z, B, T_in, C_in, wup, bup, wmrf, bmrf, wpost, bpost, spec, out, s)
              : launch<false>(z, B, T_in, C_in, wup, bup, wmrf, bmrf, wpost, bpost, spec, out, s);
}

// The tiling constants, so that the wrapper can check its inputs against them.
int ttscube_fused_tail_stage_limits(int* out) {
  out[0] = C;
  out[1] = FOLD;
  out[2] = POST_K;
  out[3] = MAX_BLOCKS;
  out[4] = MAX_DILS;
  out[5] = F_LO;
  out[6] = MAX_C_IN;  // largest C_in
  out[7] = TILE;
  return 0;
}

}  // extern "C"
