// A whole MRF stage of the HiFi-GAN generator as one kernel launch, for sm_90a, in two
// forms with three C entry points:
//
//   ttscube_fused_mrf1       replaces the TPU kernel `fused_mrf1`
//                            (ttscube_tpu/ops/pallas_resblock.py:754, kernel body
//                            `_mrf_kernel` :684): x (B, T, C) -> out (B, T, C)
//   ttscube_fused_resblock1  replaces `fused_resblock1` (pallas_resblock.py:110, kernel
//                            body `_resblock_kernel` :55): the same kernel with exactly
//                            one chain, whose mean is the chain itself (a division by 1,
//                            exact); its own entry point, so that its launches are
//                            counted apart from B3's
//   ttscube_fused_stage_mid  replaces `fused_tail_stage` with with_post=False
//                            (pallas_resblock.py:295, `_tail_tile_fn` :190): an upsample
//                            prologue, leaky(0.1) -> ConvTranspose1d with
//                            kernel == stride == 4 (C_in -> C), then the same MRF phases:
//                            z (B, T_in, C_in) -> out (B, 4 * T_in, C)
//
// The MRF: for each ResBlock1 chain j (kernel k_j, dilations d...), x_j = x and per
// dilation x_j += conv_1(leaky(conv_d(leaky(x_j)))), all convs "same" C -> C with zero
// padding outside [0, T) (the TPU kernel's mask after every conv); out = mean of x_j.
//
// What bounds it on an H100: operations. 2 * C * C * sum(k) per sample (252 * C * C
// for HiFi-GAN v1: 21 GFLOP for stage 0 at 256 frames) against 8 * C bytes in and out
// per sample. What this design does about it, as a first simple kernel: each conv is a
// tiled product on the fp32 CUDA cores (128 rows x 32 output channels per tile, 4 x 4
// per thread, the input slab and the weights staged through shared memory in chunks
// of 32 input channels), so the arithmetic is the same in fp32 and in bf16 serving.
// Tensor cores (mma.sync / wgmma on bf16 operands) are later work.
//
// Parallelism at the serving batch (B = 1, a few thousand rows): a tile of one row
// block of one conv is too little work for 132 SMs if each thread block owned a row
// tile of the whole chain, as the TPU kernel's grid does. So the stage is one
// cooperative launch that splits every conv over (chain, batch row, row tile, channel
// tile) work items, runs the chains' p-th convs side by side, and separates the
// phases with grid-wide barriers (cooperative_groups::this_grid().sync()). The
// activations between convs live in a device workspace from the wrapper (per chain
// the residual stream XR and the first conv's output H, each (B, T, C) fp32; a few MB
// at the serving shapes, L2-resident), read through L2 (__ldcg), never through the
// non-coherent read-only path, since other blocks wrote them in the same launch.
// Every output element is summed by one thread in a fixed order: launches are
// bit-equal whatever the grid size.
//
// Precision: with bf16 = 1 every conv operand is rounded to bf16 (activations here,
// after leaky, when a tile is staged; the weights by the wrapper when it packs them)
// while products, sums, biases, residuals, the inter-conv activations and the chain
// mean stay fp32 -- the TPU kernels' rule (bf16 operands, fp32 accumulation).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TR = 128;               // output rows per tile
constexpr int TC = 32;                // output channels per tile
constexpr int CK = 32;                // input channels per shared-memory chunk
constexpr int THREADS = 256;
constexpr int XS = CK + 1;            // padded row stride of the staged input slab
constexpr int RB = 4;                 // rows per thread
constexpr int ROW_STEP = THREADS / (TC / 4);  // rows between one thread's rows
constexpr int MAX_CHAINS = 4;
constexpr int MAX_DILS = 4;
constexpr int MAX_K = 15;
constexpr int MAX_REACH = 64;         // (k - 1) / 2 * d of any conv
constexpr int MAX_C = 256;
constexpr int FOLD = 4;               // the mid form's upsample factor == its kernel size
constexpr int MAX_C_IN = 512;         // the mid form's input channels

static_assert(ROW_STEP * RB == TR, "a tile is RB passes of ROW_STEP rows");
static_assert(ROW_STEP % FOLD == 0, "a thread's rows share one upsample phase");
static_assert(TC == CK, "channel quantum");

struct Spec {
  int n_chains;
  int max_nd;
  int k[MAX_CHAINS];
  int nd[MAX_CHAINS];
  int d[MAX_CHAINS][MAX_DILS];
  long long w_off[MAX_CHAINS][2 * MAX_DILS];  // the conv's first weight in the packing
  int conv[MAX_CHAINS][2 * MAX_DILS];         // the conv's index: its bias row
};

struct Args {
  const float* x;     // MRF input (B, T, C); the mid form reads the upsample's output
  const float* z;     // mid form: the stage input (B, T_in, C_in)
  const float* wup;   // mid form: [FOLD][C_in][C]
  const float* bup;   // mid form: [C]
  const float* w;     // each MRF conv [k][C][C] (tap, c_in, c_out), in chain order
  const float* bias;  // [n_convs][C]
  float* ws;          // workspace: [U (mid form)], then per chain XR and H, (B, T, C) each
  float* out;         // (B, T, C)
  int B, T, C, T_in, C_in;
  int ws_off;         // floats of shared memory before the staged weights
  Spec spec;
};

enum { FIRST = 0, SECOND = 1 };

template <bool BF16>
__device__ __forceinline__ float conv_in(float x) {
  const float v = x >= 0.f ? x : x * 0.1f;  // leaky(0.1)
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16(v));  // round to nearest even
  } else {
    return v;
  }
}

// One tile of one conv: rows [r0, r0 + TR) and channels [c0, c0 + TC) of
//   v[t][co] = bias[co] + sum_{tap, ci} conv_in(src[t + (tap - half) * d][ci]) * w[tap][ci][co]
// on one batch row's (T, C) slabs, rows outside [0, T) reading as zero.
//   FIRST:  dst[t] = v           (the first conv of a pair: H)
//   SECOND: dst[t] = res[t] + v  (the second conv: the residual stream XR)
template <bool BF16, int MODE>
__device__ void conv_tile(const float* src, const float* res, float* dst,
                          const float* __restrict__ w, const float* __restrict__ bias, int k,
                          int d, int T, int C, int r0, int c0, float* smem, int ws_off) {
  const int tid = threadIdx.x;
  const int tx = tid % (TC / 4);
  const int ty = tid / (TC / 4);
  const int reach = (k - 1) / 2 * d;
  const int rows_in = TR + 2 * reach;
  float* xs = smem;           // [rows_in][XS]
  float* wsm = smem + ws_off;  // [k][CK][TC]
  float acc[RB][4];
#pragma unroll
  for (int m = 0; m < RB; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  for (int ci0 = 0; ci0 < C; ci0 += CK) {
    __syncthreads();  // the last chunk's (or tile's) reads of xs and wsm are done
    for (int i = tid; i < rows_in * CK; i += THREADS) {
      const int rr = i / CK, cc = i % CK;
      const int t = r0 - reach + rr;
      xs[rr * XS + cc] =
          (t >= 0 && t < T) ? conv_in<BF16>(__ldcg(src + static_cast<size_t>(t) * C + ci0 + cc))
                            : 0.f;
    }
    for (int i = tid; i < k * CK * (TC / 4); i += THREADS) {
      const int q = i % (TC / 4);
      const int ci = (i / (TC / 4)) % CK;
      const int tap = i / (CK * (TC / 4));
      reinterpret_cast<float4*>(wsm)[i] = __ldg(
          reinterpret_cast<const float4*>(w + (static_cast<size_t>(tap) * C + ci0 + ci) * C + c0) + q);
    }
    __syncthreads();
    for (int tap = 0; tap < k; ++tap) {
      // output row r0 + ty + m * ROW_STEP reads slab row ty + m * ROW_STEP + tap * d
      const float* xr = xs + (ty + tap * d) * XS;
      const float* wr = wsm + tap * CK * TC + 4 * tx;
#pragma unroll 4
      for (int ci = 0; ci < CK; ++ci) {
        const float4 wv = *reinterpret_cast<const float4*>(wr + ci * TC);
#pragma unroll
        for (int m = 0; m < RB; ++m) {
          const float xv = xr[m * ROW_STEP * XS + ci];
          acc[m][0] = fmaf(xv, wv.x, acc[m][0]);
          acc[m][1] = fmaf(xv, wv.y, acc[m][1]);
          acc[m][2] = fmaf(xv, wv.z, acc[m][2]);
          acc[m][3] = fmaf(xv, wv.w, acc[m][3]);
        }
      }
    }
  }
  const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + c0) + tx);
#pragma unroll
  for (int m = 0; m < RB; ++m) {
    const int r = r0 + ty + m * ROW_STEP;
    if (r >= T) continue;
    const size_t at = static_cast<size_t>(r) * C + c0 + 4 * tx;
    float4 v = make_float4(acc[m][0] + b4.x, acc[m][1] + b4.y, acc[m][2] + b4.z,
                           acc[m][3] + b4.w);
    if constexpr (MODE == SECOND) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(res + at));
      v = make_float4(x.x + v.x, x.y + v.y, x.z + v.z, x.w + v.w);
    }
    *reinterpret_cast<float4*>(dst + at) = v;
  }
}

// One tile of the mid form's upsample: rows [r0, r0 + TR) and channels [c0, c0 + TC) of
//   U[t][co] = bup[co] + sum_ci conv_in(z[t / FOLD][ci]) * wup[t % FOLD][ci][co]
// on one batch row (T = FOLD * T_in rows).
template <bool BF16>
__device__ void upsample_tile(const float* __restrict__ z, const float* __restrict__ wup,
                              const float* __restrict__ bup, float* dst, int T_in, int C_in,
                              int C, int T, int r0, int c0, float* smem, int ws_off) {
  constexpr int ZROWS = TR / FOLD;
  const int tid = threadIdx.x;
  const int tx = tid % (TC / 4);
  const int ty = tid / (TC / 4);
  const int zr0 = r0 / FOLD;
  float* xs = smem;            // [ZROWS][XS]
  float* wsm = smem + ws_off;  // [FOLD][CK][TC]
  float acc[RB][4];
#pragma unroll
  for (int m = 0; m < RB; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  for (int ci0 = 0; ci0 < C_in; ci0 += CK) {
    __syncthreads();
    for (int i = tid; i < ZROWS * CK; i += THREADS) {
      const int rr = i / CK, cc = i % CK;
      const int zr = zr0 + rr;
      xs[rr * XS + cc] =
          zr < T_in ? conv_in<BF16>(__ldg(z + static_cast<size_t>(zr) * C_in + ci0 + cc)) : 0.f;
    }
    for (int i = tid; i < FOLD * CK * (TC / 4); i += THREADS) {
      const int q = i % (TC / 4);
      const int ci = (i / (TC / 4)) % CK;
      const int j = i / (CK * (TC / 4));
      reinterpret_cast<float4*>(wsm)[i] = __ldg(
          reinterpret_cast<const float4*>(wup + (static_cast<size_t>(j) * C_in + ci0 + ci) * C + c0) + q);
    }
    __syncthreads();
    const float* wr = wsm + (ty % FOLD) * CK * TC + 4 * tx;
#pragma unroll 4
    for (int ci = 0; ci < CK; ++ci) {
      const float4 wv = *reinterpret_cast<const float4*>(wr + ci * TC);
#pragma unroll
      for (int m = 0; m < RB; ++m) {
        const float xv = xs[((ty + m * ROW_STEP) / FOLD) * XS + ci];
        acc[m][0] = fmaf(xv, wv.x, acc[m][0]);
        acc[m][1] = fmaf(xv, wv.y, acc[m][1]);
        acc[m][2] = fmaf(xv, wv.z, acc[m][2]);
        acc[m][3] = fmaf(xv, wv.w, acc[m][3]);
      }
    }
  }
  const float4 b4 = __ldg(reinterpret_cast<const float4*>(bup + c0) + tx);
#pragma unroll
  for (int m = 0; m < RB; ++m) {
    const int r = r0 + ty + m * ROW_STEP;
    if (r >= T) continue;
    *reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * C + c0 + 4 * tx) = make_float4(
        acc[m][0] + b4.x, acc[m][1] + b4.y, acc[m][2] + b4.z, acc[m][3] + b4.w);
  }
}

template <bool BF16, bool UP>
__global__ void __launch_bounds__(THREADS, 2) mrf_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const Spec& s = a.spec;
  const int T = a.T, C = a.C;
  const size_t slab = static_cast<size_t>(T) * C;
  const size_t buf = static_cast<size_t>(a.B) * slab;
  const int row_tiles = (T + TR - 1) / TR;
  const int col_tiles = C / TC;
  const int per_chain = a.B * row_tiles * col_tiles;
  float* ws = a.ws;
  const float* x0 = a.x;

  if constexpr (UP) {
    for (int item = blockIdx.x; item < per_chain; item += gridDim.x) {
      const int ct = item % col_tiles;
      const int rt = (item / col_tiles) % row_tiles;
      const int b = item / (col_tiles * row_tiles);
      upsample_tile<BF16>(a.z + static_cast<size_t>(b) * a.T_in * a.C_in, a.wup, a.bup,
                          ws + b * slab, a.T_in, a.C_in, C, T, rt * TR, ct * TC, smem,
                          a.ws_off);
    }
    x0 = ws;
    ws += buf;
    grid.sync();
  }

  // phase (p, half): the first (half 0) or second (half 1) conv of dilation p of every
  // chain that has one
  for (int p = 0; p < s.max_nd; ++p) {
    for (int half = 0; half < 2; ++half) {
      for (int item = blockIdx.x; item < s.n_chains * per_chain; item += gridDim.x) {
        const int j = item / per_chain;
        if (p >= s.nd[j]) continue;
        const int rem = item % per_chain;
        const int ct = rem % col_tiles;
        const int rt = (rem / col_tiles) % row_tiles;
        const int b = rem / (col_tiles * row_tiles);
        float* XR = ws + 2 * j * buf + b * slab;
        float* H = XR + buf;
        const float* res = p == 0 ? x0 + b * slab : XR;
        const int m = 2 * p + half;
        const float* wc = a.w + s.w_off[j][m];
        const float* bc = a.bias + static_cast<size_t>(s.conv[j][m]) * C;
        if (half == 0) {
          conv_tile<BF16, FIRST>(res, nullptr, H, wc, bc, s.k[j], s.d[j][p], T, C, rt * TR,
                                 ct * TC, smem, a.ws_off);
        } else {
          conv_tile<BF16, SECOND>(H, res, XR, wc, bc, s.k[j], 1, T, C, rt * TR, ct * TC, smem,
                                  a.ws_off);
        }
      }
      grid.sync();
    }
  }

  // the mean of the chains, summed in chain order
  const size_t n4 = buf / 4;
  const float n = static_cast<float>(s.n_chains);
  for (size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * THREADS) {
    float4 sum = __ldcg(reinterpret_cast<const float4*>(ws) + i);
    for (int j = 1; j < s.n_chains; ++j) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(ws + 2 * j * buf) + i);
      sum = make_float4(sum.x + v.x, sum.y + v.y, sum.z + v.z, sum.w + v.w);
    }
    reinterpret_cast<float4*>(a.out)[i] = make_float4(sum.x / n, sum.y / n, sum.z / n, sum.w / n);
  }
}

// The chains from the wrapper's spec (n_chains, then per chain k, n_dilations and 4
// dilations), with each conv's weight offset and bias row; the widest reach and the
// largest k, for the shared memory. Returns false for what the kernel does not take.
bool parse_spec(const int* in, int C, Spec& s, int& max_k, int& max_reach) {
  s.n_chains = in[0];
  if (s.n_chains < 1 || s.n_chains > MAX_CHAINS) return false;
  long long off = 0;
  int conv = 0;
  s.max_nd = 0;
  max_k = 1;
  max_reach = 0;
  for (int j = 0; j < s.n_chains; ++j) {
    const int* e = in + 1 + j * (2 + MAX_DILS);
    const int k = e[0], nd = e[1];
    if (k < 1 || k > MAX_K || k % 2 != 1 || nd < 1 || nd > MAX_DILS) return false;
    s.k[j] = k;
    s.nd[j] = nd;
    if (nd > s.max_nd) s.max_nd = nd;
    if (k > max_k) max_k = k;
    for (int p = 0; p < MAX_DILS; ++p) {
      s.d[j][p] = e[2 + p];
      if (p >= nd) continue;
      const int reach = (k - 1) / 2 * e[2 + p];
      if (e[2 + p] < 1 || reach > MAX_REACH) return false;
      if (reach > max_reach) max_reach = reach;
      for (int h = 0; h < 2; ++h) {
        s.w_off[j][2 * p + h] = off;
        s.conv[j][2 * p + h] = conv++;
        off += static_cast<long long>(k) * C * C;
      }
    }
  }
  return true;
}

template <bool BF16, bool UP>
int launch(Args& a, int max_k, int max_reach, int* grid_out, cudaStream_t stream) {
  // shared memory: the staged input slab, then the staged weights (16-byte aligned)
  a.ws_off = ((TR + 2 * max_reach) * XS + 3) / 4 * 4;
  const int taps = UP && FOLD > max_k ? FOLD : max_k;
  const size_t smem = (static_cast<size_t>(a.ws_off) + static_cast<size_t>(taps) * CK * TC) *
                      sizeof(float);
  auto kernel = mrf_kernel<BF16, UP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // every block must be resident for the grid barriers: at most per_sm on each SM
  const long long items = static_cast<long long>(a.spec.n_chains) * a.B *
                          ((a.T + TR - 1) / TR) * (a.C / TC);
  const long long most = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(items < most ? items : most);
  if (grid_out) *grid_out = blocks;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                    dim3(THREADS), params, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool UP>
int dispatch(Args& a, int bf16, int max_k, int max_reach, int* grid_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true, UP>(a, max_k, max_reach, grid_out, s)
              : launch<false, UP>(a, max_k, max_reach, grid_out, s);
}

}  // namespace

extern "C" {

// x (B, T, C) fp32; w: per conv [k][C][C] (tap, c_in, c_out), in chain order; bias
// [n_convs][C]; spec (host ints): n_chains, then per chain k, n_dilations, 4 dilations;
// workspace: 2 * n_chains * B * T * C floats; out (B, T, C) fp32; grid_out (host, may be
// null) receives the thread blocks launched. Returns the launch's CUDA error code.
int ttscube_fused_mrf1(const float* x, int B, int T, int C, const float* w,
                       const float* bias, const int* spec_in, int bf16, float* workspace,
                       float* out, int* grid_out, void* stream) {
  Args a{};
  int max_k = 0, max_reach = 0;
  if (B < 1 || T < 1 || C < TC || C > MAX_C || C % TC != 0 ||
      !parse_spec(spec_in, C, a.spec, max_k, max_reach))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = x;
  a.w = w;
  a.bias = bias;
  a.ws = workspace;
  a.out = out;
  a.B = B;
  a.T = T;
  a.C = C;
  return dispatch<false>(a, bf16, max_k, max_reach, grid_out, stream);
}

// One ResBlock1: arguments as ttscube_fused_mrf1's, with spec holding exactly one chain;
// workspace: 2 * B * T * C floats.
int ttscube_fused_resblock1(const float* x, int B, int T, int C, const float* w,
                            const float* bias, const int* spec_in, int bf16,
                            float* workspace, float* out, int* grid_out, void* stream) {
  if (spec_in[0] != 1) return static_cast<int>(cudaErrorInvalidValue);
  return ttscube_fused_mrf1(x, B, T, C, w, bias, spec_in, bf16, workspace, out, grid_out,
                            stream);
}

// z (B, T_in, C_in) fp32; wup [4][C_in][C]; bup [C]; w, bias, spec as above; workspace:
// (1 + 2 * n_chains) * B * 4 * T_in * C floats; out (B, 4 * T_in, C) fp32.
int ttscube_fused_stage_mid(const float* z, int B, int T_in, int C_in, const float* wup,
                            const float* bup, const float* w, const float* bias, int C,
                            const int* spec_in, int bf16, float* workspace, float* out,
                            int* grid_out, void* stream) {
  Args a{};
  int max_k = 0, max_reach = 0;
  if (B < 1 || T_in < 1 || C < TC || C > MAX_C || C % TC != 0 || C_in < CK ||
      C_in > MAX_C_IN || C_in % CK != 0 || !parse_spec(spec_in, C, a.spec, max_k, max_reach))
    return static_cast<int>(cudaErrorInvalidValue);
  a.z = z;
  a.wup = wup;
  a.bup = bup;
  a.w = w;
  a.bias = bias;
  a.ws = workspace;
  a.out = out;
  a.B = B;
  a.T = T_in * FOLD;
  a.C = C;
  a.T_in = T_in;
  a.C_in = C_in;
  return dispatch<true>(a, bf16, max_k, max_reach, grid_out, stream);
}

// The limits, so that the wrappers can check their inputs against them.
int ttscube_fused_mrf1_limits(int* out) {
  out[0] = TC;  // channels: a multiple of this
  out[1] = MAX_C;
  out[2] = MAX_CHAINS;
  out[3] = MAX_DILS;
  out[4] = MAX_K;
  out[5] = MAX_REACH;
  return 0;
}

int ttscube_fused_resblock1_limits(int* out) {
  ttscube_fused_mrf1_limits(out);
  out[2] = 1;  // chains
  return 0;
}

int ttscube_fused_stage_mid_limits(int* out) {
  ttscube_fused_mrf1_limits(out);
  out[6] = FOLD;
  out[7] = MAX_C_IN;
  return 0;
}

}  // extern "C"
