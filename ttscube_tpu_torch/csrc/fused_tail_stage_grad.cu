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
// (z, dy) per sample. As a first simple kernel it runs every product as fp32 FMAs on
// the CUDA cores with register blocking (4 x 4 outputs per thread), its operands in
// shared memory; tensor cores and TMA are later work.
//
// Design. One thread block per SM walks a fixed list of tiles (tile i of the grid
// goes to block i % gridDim.x), each tile TILE output samples of one batch row with a
// HALO of samples on each side, as the forward kernel tiles. Per tile:
//   1. forward recompute, as the forward kernel does it, keeping each conv's input
//      (leaky(x) before conv_d, leaky(h) before conv_1) in a per-block workspace in
//      device memory: 18 slabs of 384 x 32 floats do not fit in shared memory;
//   2. conv_post and tanh backward from the chain sum, which stays in shared memory;
//   3. each chain backward, pair by pair from the last: the weight grads of a conv
//      are sums over rows of (input x output cotangent), its input cotangent is the
//      conv with the flipped, transposed kernel (packed by the wrapper); the cotangent
//      is zeroed at the positions the forward zeroes, and leaky's slope is read off
//      the sign of the saved activation;
//   4. upsample backward: its weight grads, and the cotangent of the tile's z rows,
//      halo rows included, written out for the wrapper to overlap-add.
// Weight grads add up in a per-block partial in device memory, each entry owned by
// one thread, in the fixed order of the block's tiles; the wrapper sums the partials
// of the blocks in a fixed order. No atomics: two launches on the same inputs give
// bit-equal grads.

#include <cuda_runtime.h>

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
constexpr int THREADS = 256;
constexpr int RB = 4;                      // rows per thread in one pass of a conv
constexpr int PASS_ROWS = (THREADS / 8) * RB;
constexpr int MAX_BLOCKS = 4;
constexpr int MAX_DILS = 4;
constexpr int MARGIN = 32;                 // zero rows on each side of a cotangent slab
constexpr int SP = S + 2 * MARGIN;
constexpr int MAX_C_IN = 128;
// shared memory: ACC [FROWS][C] for the whole tile, then either the forward's XR, A,
// H [S][C] or the backward's DX [S][C], DH [SP][C], DH1 [SP][C]
constexpr int SMEM_FLOATS = FROWS * C + S * C + 2 * SP * C;

static_assert(TILE == THREADS, "conv_post maps one thread to one output sample");
static_assert(HALO % FOLD == 0 && TILE % FOLD == 0, "slab must start on an input row");
static_assert(3 * S * C <= S * C + 2 * SP * C, "forward buffers fit the backward's");
static_assert(ZROWS * MAX_C_IN <= SP * C, "z rows fit one cotangent slab");

struct Spec {
  int n_blocks;
  int k[MAX_BLOCKS];
  int nd[MAX_BLOCKS];
  int d[MAX_BLOCKS][MAX_DILS];
};

enum { FIRST = 0, SECOND = 1, LAST = 2 };   // forward conv epilogues
enum { GATE_MASK = 0, GATE_ADD = 1 };       // backward conv epilogues

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : x * slope;
}

// leaky's derivative read off the sign of its input (or output: same sign), as
// PyTorch's leaky_relu backward takes it (slope at 0)
__device__ __forceinline__ float dleaky(float x, float slope) {
  return x > 0.f ? 1.f : slope;
}

// sum over taps and input channels of in[r + (tap - half) * d][ci] * w[tap][ci][co]
// for the 4 rows rows[m] and the 4 output channels co4..co4+3 of this thread
__device__ __forceinline__ void conv_rows(const float* in, const float* __restrict__ w,
                                          int k, int d, const int* rows, int co4,
                                          float (&acc)[RB][4]) {
  const int half = (k - 1) / 2;
#pragma unroll
  for (int m = 0; m < RB; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
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
        const float4 x = *reinterpret_cast<const float4*>(in + (rows[m] + off) * C + ci);
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
}

// Forward conv over slab rows [r_lo, r_hi), as in the forward kernel:
//   FIRST:  H = leaky(out)
//   SECOND: XR += out; A = leaky(XR)
//   LAST:   ACC (=|+=) XR + out
template <int MODE>
__device__ void fwd_pass(const float* in, const float* __restrict__ w,
                         const float* __restrict__ bias, int k, int d, int r_lo, int r_hi,
                         int t_first, int L, float* H, float* XR, float* A, float* ACC,
                         bool acc_init) {
  const int co4 = (threadIdx.x & 7) * 4;
  const int rg = threadIdx.x >> 3;
  const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + co4));
  for (int base = r_lo; base < r_hi; base += PASS_ROWS) {
    int rows[RB];
    float acc[RB][4];
#pragma unroll
    for (int m = 0; m < RB; ++m) rows[m] = min(base + rg + 32 * m, r_hi - 1);
    conv_rows(in, w, k, d, rows, co4, acc);
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
        *reinterpret_cast<float4*>(H + r * C + co4) = make_float4(
            leaky(v0, 0.1f), leaky(v1, 0.1f), leaky(v2, 0.1f), leaky(v3, 0.1f));
      } else {
        float4 x = *reinterpret_cast<const float4*>(XR + r * C + co4);
        x.x += v0;
        x.y += v1;
        x.z += v2;
        x.w += v3;
        if constexpr (MODE == SECOND) {
          *reinterpret_cast<float4*>(XR + r * C + co4) = x;
          *reinterpret_cast<float4*>(A + r * C + co4) = make_float4(
              leaky(x.x, 0.1f), leaky(x.y, 0.1f), leaky(x.z, 0.1f), leaky(x.w, 0.1f));
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

// Input cotangent of a conv over slab rows [r_lo, r_hi): `in` is the output
// cotangent (zero outside its own rows), `wt` the flipped, transposed kernel
// wt[tap][co][ci] = w[k - 1 - tap][ci][co], so that this is a conv like the forward.
//   GATE_MASK: out = valid ? acc * leaky'(gate) : 0    (gate may be out itself)
//   GATE_ADD:  out += acc * leaky'(gate)
template <int MODE>
__device__ void bwd_pass(const float* in, const float* __restrict__ wt, int k, int d,
                         int r_lo, int r_hi, int t_first, int L, float* out,
                         const float* gate) {
  const int co4 = (threadIdx.x & 7) * 4;
  const int rg = threadIdx.x >> 3;
  for (int base = r_lo; base < r_hi; base += PASS_ROWS) {
    int rows[RB];
    float acc[RB][4];
#pragma unroll
    for (int m = 0; m < RB; ++m) rows[m] = min(base + rg + 32 * m, r_hi - 1);
    conv_rows(in, wt, k, d, rows, co4, acc);
#pragma unroll
    for (int m = 0; m < RB; ++m) {
      const int r = base + rg + 32 * m;
      if (r >= r_hi) continue;
      const float4 g = *reinterpret_cast<const float4*>(gate + r * C + co4);
      float4 v = make_float4(acc[m][0] * dleaky(g.x, 0.1f), acc[m][1] * dleaky(g.y, 0.1f),
                             acc[m][2] * dleaky(g.z, 0.1f), acc[m][3] * dleaky(g.w, 0.1f));
      float4* dst = reinterpret_cast<float4*>(out + r * C + co4);
      if constexpr (MODE == GATE_MASK) {
        const int t = t_first + r;
        if (t < 0 || t >= L) v = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const float4 o = *dst;
        v.x += o.x;
        v.y += o.y;
        v.z += o.z;
        v.w += o.w;
      }
      *dst = v;
    }
  }
}

// Weight and bias grads of a conv: pw[tap][ci][co] += sum over rows r in [r_lo, r_hi)
// of in[r + (tap - half) * d][ci] * dout[r][co], pb[co] += sum of dout[r][co]. Each
// thread owns a 4 x 4 block of (ci, co) for every fourth tap.
__device__ void weight_grad(const float* in, const float* dout, int k, int d, int r_lo,
                            int r_hi, float* pw, float* pb) {
  const int tid = threadIdx.x;
  const int co4 = (tid & 7) * 4;
  const int ci4 = ((tid >> 3) & 7) * 4;
  const int half = (k - 1) / 2;
  for (int tap = tid >> 6; tap < k; tap += THREADS / 64) {
    const int off = (tap - half) * d;
    float acc[4][4] = {};
    for (int r = r_lo; r < r_hi; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(in + (r + off) * C + ci4);
      const float4 g = *reinterpret_cast<const float4*>(dout + r * C + co4);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        acc[a][0] = fmaf(xs[a], g.x, acc[a][0]);
        acc[a][1] = fmaf(xs[a], g.y, acc[a][1]);
        acc[a][2] = fmaf(xs[a], g.z, acc[a][2]);
        acc[a][3] = fmaf(xs[a], g.w, acc[a][3]);
      }
    }
    float* p = pw + tap * C * C + ci4 * C + co4;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float4 v = *reinterpret_cast<float4*>(p + a * C);
      v.x += acc[a][0];
      v.y += acc[a][1];
      v.z += acc[a][2];
      v.w += acc[a][3];
      *reinterpret_cast<float4*>(p + a * C) = v;
    }
  }
  if (tid < C) {
    float s = 0.f;
    for (int r = r_lo; r < r_hi; ++r) s += dout[r * C + tid];
    pb[tid] += s;
  }
}

// dst rows [-MARGIN, S + MARGIN) (dst points at row 0) = src rows in [lo, hi), else 0
__device__ void stage(float* dst, const float* src, int lo, int hi) {
  for (int idx = threadIdx.x; idx < SP * C / 4; idx += THREADS) {
    const int r = idx / (C / 4) - MARGIN;
    const int c4 = idx % (C / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r >= lo && r < hi) v = reinterpret_cast<const float4*>(src + r * C)[c4];
    reinterpret_cast<float4*>(dst + r * C)[c4] = v;
  }
}

__device__ void copy_slab(float* dst, const float* src) {
  for (int idx = threadIdx.x; idx < S * C / 4; idx += THREADS)
    reinterpret_cast<float4*>(dst)[idx] = reinterpret_cast<const float4*>(src)[idx];
}

__global__ void __launch_bounds__(THREADS, 1)
    tail_grad_kernel(const float* __restrict__ z, int B, int T_in, int C_in,
                     const float* __restrict__ dy, const float* __restrict__ wup,
                     const float* __restrict__ bup, const float* __restrict__ wmrf,
                     const float* __restrict__ wmrf_t, const float* __restrict__ bmrf,
                     const float* __restrict__ wpost, const float* __restrict__ bpost,
                     Spec spec, int n_convs, float* __restrict__ workspace,
                     float* __restrict__ partials, long long partial_size,
                     float* __restrict__ dzs) {
  extern __shared__ float4 smem4[];
  float* ACC = reinterpret_cast<float*>(smem4);   // [FROWS][C] chain sum, then its grad
  float* base = ACC + FROWS * C;
  float* XR = base;                               // forward: [S][C] residual stream
  float* A = XR + S * C;                          //          [S][C] first-conv input
  float* H = A + S * C;                           //          [S][C] second-conv input
  float* DX = base;                               // backward: [S][C] residual cotangent
  float* DH = base + S * C + MARGIN * C;          //           [SP][C] (row 0 at MARGIN)
  float* DH1 = DH + SP * C;                       //           [SP][C]

  const int tid = threadIdx.x;
  const int L = T_in * FOLD;
  const int n_tiles = (L + TILE - 1) / TILE;
  float* ws = workspace + static_cast<size_t>(blockIdx.x) * (n_convs + 1) * S * C;
  float* DX0 = ws + static_cast<size_t>(n_convs) * S * C;  // upsample output's cotangent
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
      const float* w = wmrf;
      const float* bias = bmrf;
      int conv = 0;
      for (int j = 0; j < spec.n_blocks; ++j) {
        __syncthreads();  // H and A are free again
        for (int idx = tid; idx < ZROWS * C_in; idx += THREADS) {
          const int zr = zrow0 + idx / C_in;
          const float v = (zr >= 0 && zr < T_in)
                              ? zb[static_cast<size_t>(zr) * C_in + idx % C_in] : 0.f;
          H[idx] = leaky(v, 0.1f);
        }
        __syncthreads();
        {
          const int co = tid & (C - 1);
          for (int s = tid / C; s < S; s += THREADS / C) {
            float v = 0.f;
            if (valid(s)) {
              const float* a = H + (s / FOLD) * C_in;
              const float* wj = wup + (s % FOLD) * C_in * C + co;
              float sum = 0.f;
              for (int ci = 0; ci < C_in; ++ci) sum = fmaf(a[ci], __ldg(wj + ci * C), sum);
              v = sum + __ldg(bup + co);
            }
            XR[s * C + co] = v;
            A[s * C + co] = leaky(v, 0.1f);
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
          __syncthreads();
          copy_slab(ws + static_cast<size_t>(conv) * S * C, A);
          fwd_pass<FIRST>(A, w, bias, k, dp, r2_lo - half, r2_hi + half, t_first, L, H, XR,
                          A, ACC, false);
          w += k * C * C;
          bias += C;
          __syncthreads();
          copy_slab(ws + static_cast<size_t>(conv + 1) * S * C, H);
          if (p + 1 < nd) {
            fwd_pass<SECOND>(H, w, bias, k, 1, r2_lo, r2_hi, t_first, L, H, XR, A, ACC,
                             false);
          } else {
            fwd_pass<LAST>(H, w, bias, k, 1, r2_lo, r2_hi, t_first, L, H, XR, A, ACC,
                           j == 0);
          }
          w += k * C * C;
          bias += C;
          conv += 2;
        }
      }
    }
    __syncthreads();

    // ---- 2. conv_post and tanh backward -----------------------------------------
    const float inv_n = 1.f / static_cast<float>(spec.n_blocks);
    float* Y = DX;          // [FROWS][C] conv_post's input
    float* DPRE = DH1;      // [TILE] cotangent of conv_post's output
    for (int idx = tid; idx < FROWS * C; idx += THREADS)
      Y[idx] = leaky(ACC[idx] / static_cast<float>(spec.n_blocks), 0.01f);
    __syncthreads();
    {
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

    // ---- 3. each chain backward, pair by pair from the last -------------------------
    {
      int conv0 = 0;        // first conv of chain j
      int woff0 = 0;        // its offset in the packed MRF kernels
      for (int j = 0; j < spec.n_blocks; ++j) {
        const int k = spec.k[j];
        const int half = (k - 1) / 2;
        const int nd = spec.nd[j];
        for (int idx = tid; idx < S * C; idx += THREADS) {
          const int r = idx / C;
          DX[idx] = (r >= F_LO && r < F_LO + FROWS) ? ACC[idx - F_LO * C] : 0.f;
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
          // conv_1's output cotangent (masked) and its saved input leaky(h)
          for (int idx = tid; idx < SP * C; idx += THREADS) {
            const int r = idx / C - MARGIN;
            DH[r * C + idx % C] =
                (r >= r2_lo && r < r2_hi && valid(r)) ? DX[r * C + idx % C] : 0.f;
          }
          stage(DH1, ws + static_cast<size_t>(c2) * S * C, r1_lo, r1_hi);
          __syncthreads();
          weight_grad(DH1, DH, k, 1, r2_lo, r2_hi, p_wmrf + w2, p_bmrf + c2 * C);
          __syncthreads();
          // conv_d's output cotangent, in place of leaky(h)
          bwd_pass<GATE_MASK>(DH, wmrf_t + w2, k, 1, r1_lo, r1_hi, t_first, L, DH1, DH1);
          __syncthreads();
          stage(DH, ws + static_cast<size_t>(c1) * S * C, r0_lo, r0_hi);
          __syncthreads();
          weight_grad(DH, DH1, k, dp, r1_lo, r1_hi, p_wmrf + w1, p_bmrf + c1 * C);
          // the residual's cotangent: the identity path (already in DX) + conv_d's
          bwd_pass<GATE_ADD>(DH1, wmrf_t + w1, k, dp, r0_lo, r0_hi, t_first, L, DX, DH);
          E += (dp + 1) * half;
        }
        __syncthreads();
        for (int idx = tid; idx < S * C; idx += THREADS)
          DX0[idx] = (j == 0 ? 0.f : DX0[idx]) + DX[idx];
        conv0 += 2 * nd;
        woff0 += 2 * nd * k * C * C;
      }
    }
    __syncthreads();

    // ---- 4. upsample backward ------------------------------------------------------
    float* LZ = DH;         // [ZROWS][C_in] z rows behind the slab
    for (int idx = tid; idx < S * C; idx += THREADS) DX[idx] = valid(idx / C) ? DX0[idx] : 0.f;
    for (int idx = tid; idx < ZROWS * C_in; idx += THREADS) {
      const int zr = zrow0 + idx / C_in;
      LZ[idx] = (zr >= 0 && zr < T_in) ? zb[static_cast<size_t>(zr) * C_in + idx % C_in]
                                       : 0.f;
    }
    __syncthreads();
    if (tid < C) {
      float s = 0.f;
      for (int r = 0; r < S; ++r) s += DX[r * C + tid];
      p_bup[tid] += s;
    }
    for (int idx = tid; idx < FOLD * C_in * C; idx += THREADS) {
      const int f = idx / (C_in * C), ci = (idx / C) % C_in, co = idx % C;
      float s = 0.f;
      for (int zr = 0; zr < ZROWS; ++zr)
        s = fmaf(leaky(LZ[zr * C_in + ci], 0.1f), DX[(zr * FOLD + f) * C + co], s);
      p_wup[idx] += s;
    }
    float* dz_tile = dzs + static_cast<size_t>(tile_id) * ZROWS * C_in;
    for (int idx = tid; idx < ZROWS * C_in; idx += THREADS) {
      const int zr = idx / C_in, ci = idx % C_in;
      float s = 0.f;
      for (int f = 0; f < FOLD; ++f) {
        const float* g = DX + (zr * FOLD + f) * C;
        const float* wf = wup + (f * C_in + ci) * C;
        for (int co = 0; co < C; ++co) s = fmaf(g[co], __ldg(wf + co), s);
      }
      dz_tile[idx] = s * dleaky(LZ[idx], 0.1f);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// z (B, T_in, C_in) fp32; dy (B, 4 * T_in) fp32; wup [4][C_in][32]; bup [32]; wmrf:
// per conv [k][32][32] (tap, c_in, c_out), in chain order, and wmrf_t the same convs
// flipped and transposed ([k][c_out][c_in], tap reversed); bmrf [n_convs][32];
// wpost [7][32]; bpost [1]; spec as for ttscube_fused_tail_stage. n_blocks thread
// blocks; workspace n_blocks * (n_convs + 1) * 384 * 32 floats; partials n_blocks *
// partial_size floats (a multiple of 4, at least the grads' size), zeroed by the
// caller, each block's laid out as wup, bup, wmrf, bmrf, wpost, bpost; dzs (B, n_tiles, 96, C_in) with n_tiles = ceil(4 * T_in / 256):
// each tile's cotangent of z rows [64 * tile - 16, 64 * tile + 80). Returns
// cudaGetLastError() after the launch.
int ttscube_fused_tail_stage_grad(const float* z, int B, int T_in, int C_in,
                                  const float* dy, const float* wup, const float* bup,
                                  const float* wmrf, const float* wmrf_t, const float* bmrf,
                                  const float* wpost, const float* bpost, const int* spec_in,
                                  int n_blocks, float* workspace, float* partials,
                                  long long partial_size, float* dzs, void* stream) {
  Spec spec{};
  spec.n_blocks = spec_in[0];
  if (spec.n_blocks < 1 || spec.n_blocks > MAX_BLOCKS || C_in < 1 || C_in > MAX_C_IN ||
      B < 1 || T_in < 1 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_convs = 0;
  long long size = static_cast<long long>(FOLD) * C_in * C + C + POST_K * C + 1;
  for (int j = 0; j < spec.n_blocks; ++j) {
    const int* e = spec_in + 1 + j * (2 + MAX_DILS);
    spec.k[j] = e[0];
    spec.nd[j] = e[1];
    if (spec.nd[j] < 1 || spec.nd[j] > MAX_DILS || e[0] < 1 || e[0] % 2 == 0)
      return static_cast<int>(cudaErrorInvalidValue);
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
  if (size > partial_size || partial_size % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tail_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_grad_kernel<<<n_blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      z, B, T_in, C_in, dy, wup, bup, wmrf, wmrf_t, bmrf, wpost, bpost, spec, n_convs,
      workspace, partials, partial_size, dzs);
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
  return 0;
}

}  // extern "C"
