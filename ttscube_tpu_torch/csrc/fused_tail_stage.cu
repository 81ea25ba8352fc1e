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
// bytes of input and 4 bytes of output per sample, far right of the ridge point.
// What this design does about it, as a first simple kernel: the C = 32 activation and
// every intermediate stay in shared memory (nothing but z, the weights and the audio
// touch device memory), and the 18 + 2 convs run as fp32 FMAs on the CUDA cores with
// register blocking (4 rows x 4 output channels per thread, float4 broadcast reads
// from shared memory, weights through the read-only cache). Tensor cores (wgmma), TMA
// and a bf16 activation layout are later work.
//
// Tiling: one thread block per (batch row, tile of TILE output samples). The block
// holds the upsampled activation over the tile plus HALO samples on each side, enough
// for the longest MRF chain (60 samples for k = 11, d = 1, 3, 5) and conv_post (3).
// Each conv computes exactly the rows that the rest of the chain still needs, so the
// region shrinks along the chain. The upsample is recomputed for each chain (3 % of
// the work) instead of keeping a fourth activation buffer.
//
// Precision: with bf16 = 1 every conv operand is rounded to bf16 (activations here
// with __float2bfloat16; the weights are rounded by the wrapper when it packs them)
// while products, sums, biases, residuals and the chain mean stay fp32 -- the TPU
// kernel's rule for serving (bf16 operands, fp32 accumulation and residuals).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
constexpr int RB = 4;                      // rows per thread in one pass of a conv
constexpr int PASS_ROWS = (THREADS / 8) * RB;
constexpr int MAX_BLOCKS = 4;
constexpr int MAX_DILS = 4;
constexpr int SMEM_FLOATS = 3 * S * C + FROWS * C;

static_assert(TILE == THREADS, "conv_post maps one thread to one output sample");
static_assert(HALO % FOLD == 0 && TILE % FOLD == 0, "slab must start on an input row");

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

// One "same" conv over slab rows [r_lo, r_hi): sum over taps and input channels of
// in[r + (tap - half) * d][ci] * w[tap][ci][co], plus bias, zeroed outside [0, L).
//   FIRST:  H = rnd(leaky(out))                       (input of the pair's second conv)
//   SECOND: XR += out; A = rnd(leaky(XR))             (residual; next pair's input)
//   LAST:   ACC (=|+=) XR + out                       (chain output into the mean)
template <bool BF16, int MODE>
__device__ void conv_pass(const float* __restrict__ in, const float* __restrict__ w,
                          const float* __restrict__ bias, int k, int d, int r_lo,
                          int r_hi, int t_first, int L, float* __restrict__ H,
                          float* __restrict__ XR, float* __restrict__ A,
                          float* __restrict__ ACC, bool acc_init) {
  const int tid = threadIdx.x;
  const int co4 = (tid & 7) * 4;
  const int rg = tid >> 3;
  const int half = (k - 1) / 2;
  const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + co4));
  for (int base = r_lo; base < r_hi; base += PASS_ROWS) {
    int rows[RB];
    float acc[RB][4];
#pragma unroll
    for (int m = 0; m < RB; ++m) {
      rows[m] = min(base + rg + 32 * m, r_hi - 1);
      acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
    }
    for (int tap = 0; tap < k; ++tap) {
      const int off = (tap - half) * d;
      const float* wt = w + tap * C * C + co4;
#pragma unroll 2
      for (int ci = 0; ci < C; ci += 4) {
        const float4 w0 = __ldg(reinterpret_cast<const float4*>(wt + (ci + 0) * C));
        const float4 w1 = __ldg(reinterpret_cast<const float4*>(wt + (ci + 1) * C));
        const float4 w2 = __ldg(reinterpret_cast<const float4*>(wt + (ci + 2) * C));
        const float4 w3 = __ldg(reinterpret_cast<const float4*>(wt + (ci + 3) * C));
#pragma unroll
        for (int m = 0; m < RB; ++m) {
          const float4 x =
              *reinterpret_cast<const float4*>(in + (rows[m] + off) * C + ci);
          acc[m][0] = fmaf(x.x, w0.x, acc[m][0]);
          acc[m][1] = fmaf(x.x, w0.y, acc[m][1]);
          acc[m][2] = fmaf(x.x, w0.z, acc[m][2]);
          acc[m][3] = fmaf(x.x, w0.w, acc[m][3]);
          acc[m][0] = fmaf(x.y, w1.x, acc[m][0]);
          acc[m][1] = fmaf(x.y, w1.y, acc[m][1]);
          acc[m][2] = fmaf(x.y, w1.z, acc[m][2]);
          acc[m][3] = fmaf(x.y, w1.w, acc[m][3]);
          acc[m][0] = fmaf(x.z, w2.x, acc[m][0]);
          acc[m][1] = fmaf(x.z, w2.y, acc[m][1]);
          acc[m][2] = fmaf(x.z, w2.z, acc[m][2]);
          acc[m][3] = fmaf(x.z, w2.w, acc[m][3]);
          acc[m][0] = fmaf(x.w, w3.x, acc[m][0]);
          acc[m][1] = fmaf(x.w, w3.y, acc[m][1]);
          acc[m][2] = fmaf(x.w, w3.z, acc[m][2]);
          acc[m][3] = fmaf(x.w, w3.w, acc[m][3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < RB; ++m) {
      const int r = base + rg + 32 * m;
      if (r >= r_hi) continue;
      const int t = t_first + r;
      const bool valid = t >= 0 && t < L;
      const float v0 = valid ? acc[m][0] + b4.x : 0.f;
      const float v1 = valid ? acc[m][1] + b4.y : 0.f;
      const float v2 = valid ? acc[m][2] + b4.z : 0.f;
      const float v3 = valid ? acc[m][3] + b4.w : 0.f;
      if constexpr (MODE == FIRST) {
        *reinterpret_cast<float4*>(H + r * C + co4) =
            make_float4(rnd<BF16>(leaky(v0, 0.1f)), rnd<BF16>(leaky(v1, 0.1f)),
                        rnd<BF16>(leaky(v2, 0.1f)), rnd<BF16>(leaky(v3, 0.1f)));
      } else {
        float4 x = *reinterpret_cast<const float4*>(XR + r * C + co4);
        x.x += v0;
        x.y += v1;
        x.z += v2;
        x.w += v3;
        if constexpr (MODE == SECOND) {
          *reinterpret_cast<float4*>(XR + r * C + co4) = x;
          *reinterpret_cast<float4*>(A + r * C + co4) =
              make_float4(rnd<BF16>(leaky(x.x, 0.1f)), rnd<BF16>(leaky(x.y, 0.1f)),
                          rnd<BF16>(leaky(x.z, 0.1f)), rnd<BF16>(leaky(x.w, 0.1f)));
        } else {
          float4* dst = reinterpret_cast<float4*>(ACC + (r - F_LO) * C + co4);
          if (!acc_init) {
            const float4 a = *dst;
            x.x += a.x;
            x.y += a.y;
            x.z += a.z;
            x.w += a.w;
          }
          *dst = x;
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
  extern __shared__ float4 smem4[];
  float* XR = reinterpret_cast<float*>(smem4);  // [S][C] residual stream
  float* A = XR + S * C;                          // [S][C] first-conv input
  float* H = A + S * C;                           // [S][C] second-conv input
  float* ACC = H + S * C;                         // [FROWS][C] sum of the chains

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const int L = T_in * FOLD;
  const int t_first = t0 - HALO;                  // global sample of slab row 0
  const int zrow0 = t_first / FOLD;               // exact: t_first % FOLD == 0
  const float* zb = z + static_cast<size_t>(b) * T_in * C_in;

  const float* w = wmrf;
  const float* bias = bmrf;
  for (int j = 0; j < spec.n_blocks; ++j) {
    // upsample: XR[s][co] = b_up[co] + sum_ci rnd(leaky(z[s / 4][ci])) * Wup[s % 4][ci][co]
    __syncthreads();  // H and A are free again
    for (int idx = tid; idx < ZROWS * C_in; idx += THREADS) {
      const int zr = zrow0 + idx / C_in;
      const float v = (zr >= 0 && zr < T_in) ? zb[static_cast<size_t>(zr) * C_in + idx % C_in]
                                             : 0.f;
      H[idx] = rnd<BF16>(leaky(v, 0.1f));
    }
    __syncthreads();
    {
      const int co = tid & (C - 1);
      for (int s = tid / C; s < S; s += THREADS / C) {
        const int t = t_first + s;
        float v = 0.f;
        if (t >= 0 && t < L) {
          const float* a = H + (s / FOLD) * C_in;
          const float* wj = wup + (s % FOLD) * C_in * C + co;
          float sum = 0.f;
          for (int ci = 0; ci < C_in; ++ci) sum = fmaf(a[ci], __ldg(wj + ci * C), sum);
          v = sum + __ldg(bup + co);
        }
        XR[s * C + co] = v;
        A[s * C + co] = rnd<BF16>(leaky(v, 0.1f));
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
      __syncthreads();
      conv_pass<BF16, FIRST>(A, w, bias, k, dp, r2_lo - half, r2_hi + half, t_first, L,
                             H, XR, A, ACC, false);
      w += k * C * C;
      bias += C;
      __syncthreads();
      if (p + 1 < nd) {
        conv_pass<BF16, SECOND>(H, w, bias, k, 1, r2_lo, r2_hi, t_first, L, H, XR, A,
                                ACC, false);
      } else {
        conv_pass<BF16, LAST>(H, w, bias, k, 1, r2_lo, r2_hi, t_first, L, H, XR, A,
                              ACC, j == 0);
      }
      w += k * C * C;
      bias += C;
    }
  }
  __syncthreads();
  // mean of the chains, leaky(0.01), rounded for conv_post
  for (int idx = tid; idx < FROWS * C; idx += THREADS) {
    ACC[idx] = rnd<BF16>(leaky(ACC[idx] / static_cast<float>(spec.n_blocks), 0.01f));
  }
  __syncthreads();
  // conv_post (32 -> 1, k = 7) + tanh; one thread per output sample, channels read in
  // a rotated order so that the 32 lanes of a warp hit 32 different banks
  const int t = t0 + tid;
  if (t < L) {
    float sum = 0.f;
    for (int tap = 0; tap < POST_K; ++tap) {
      const float* row = ACC + (tid + tap) * C;
      for (int j = 0; j < C; ++j) {
        const int ci = (j + tid) & (C - 1);
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
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tail_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int L = T_in * FOLD;
  const dim3 grid((L + TILE - 1) / TILE, B);
  tail_kernel<BF16><<<grid, THREADS, smem, stream>>>(z, T_in, C_in, wup, bup, wmrf,
                                                     bmrf, wpost, bpost, spec, out);
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
  if (spec.n_blocks < 1 || spec.n_blocks > MAX_BLOCKS || C_in < 1 || C_in * ZROWS > S * C ||
      B < 1 || B > 65535 || T_in < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < spec.n_blocks; ++j) {
    const int* e = spec_in + 1 + j * (2 + MAX_DILS);
    spec.k[j] = e[0];
    spec.nd[j] = e[1];
    if (spec.nd[j] < 1 || spec.nd[j] > MAX_DILS) return static_cast<int>(cudaErrorInvalidValue);
    int total = 0;
    for (int p = 0; p < MAX_DILS; ++p) {
      spec.d[j][p] = e[2 + p];
      if (p < spec.nd[j]) total += (e[2 + p] + 1) * ((e[0] - 1) / 2);
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
  out[6] = S * C / ZROWS;  // largest C_in
  return 0;
}

}  // extern "C"
