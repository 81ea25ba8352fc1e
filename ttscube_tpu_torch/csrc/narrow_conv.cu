// A bias-free 1-D convolution with dilation 1 over a narrow channel count, for sm_90a:
// replaces the TPU kernel `narrow_conv_pallas_blocked` (ttscube_tpu/ops/pallas_conv.py:46,
// kernel body `_conv_kernel_blocked` :35).
//
//   out[b][t][o] = sum_{j < k, i < C} x[b][t - (k - 1) / 2 + j][i] * w[j][i][o]
//
// with x read as zero outside [0, T) (`fold_conv_kernel`'s padding: an even k pads
// (k - 1) / 2 on the left and k / 2 on the right). x and w are both fp32 or both bf16;
// products are exact in fp32 either way, sums are fp32 and the output is fp32 -- the
// TPU kernel's jnp.dot(..., preferred_element_type=float32).
//
// What bounds it on an H100: operations in fp32 (2 * C * C * k per sample: 22 GFLOP at
// B = 8, T = 122,880, C = 32, k = 11, 0.33 ms at 67 TFLOP/s), bytes in bf16 (the same
// work at 989 TFLOP/s takes 0.022 ms, while the 63 MB in and 126 MB out take 0.056 ms
// at 3.35 TB/s). What this design does about it, as a first simple kernel: a direct
// convolution on the fp32 CUDA cores. One block owns a tile of rows and all C output
// channels; each thread sums RB rows by 4 output channels. The tile's slab of input
// rows plus its k - 1 halo rows and the weights go through shared memory. When the
// whole (k, C, C) weight fits beside the slab (45 KB at C = 32, k = 11), a block stages
// it once and walks row tiles; above that it walks chunks of input channels, staging
// the slab and the weights of one chunk at a time. Each output element is summed by one
// thread in a fixed order, so launches are bit-equal. The TPU kernel's time folding and
// host-gathered halos are layout for its matrix unit, not part of the function.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int RB = 4;            // output rows per thread
constexpr int QUANTUM = 32;      // channels: a multiple of this
constexpr int MAX_C = 256;
constexpr int MAX_K = 15;
constexpr int SMEM_BUDGET = 227 * 1024;  // bytes of shared memory a block may use

struct Args {
  const void* x;  // (B, T, C)
  const void* w;  // (k, C, C): tap, c_in, c_out
  float* out;     // (B, T, C) fp32
  int B, T, C, k;
  int ck;         // input channels per staged chunk (C when the weights fit whole)
  int tr;         // output rows per tile
  int xs_floats;  // floats of shared memory before the staged weights
};

template <typename T>
__device__ __forceinline__ float as_float(T v);
template <>
__device__ __forceinline__ float as_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float as_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) narrow_conv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w = static_cast<const T*>(a.w);
  const int C = a.C, k = a.k, ck = a.ck, tr = a.tr, T_len = a.T;
  const int cols = C / 4;              // threads across the output channels
  const int row_step = THREADS / cols;  // rows between one thread's rows
  const int tid = threadIdx.x;
  const int tx = tid % cols;
  const int ty = tid / cols;
  // where C / 4 does not divide THREADS (C = 96, 160, ...) the last threads own no
  // rows: they stage the slab and the weights with the others and compute nothing
  const bool computes = ty < row_step;
  const int left = (k - 1) / 2;
  const int rows_in = tr + k - 1;
  const int xs_stride = ck + 1;         // padded against bank conflicts
  float* xs = smem;                     // [rows_in][ck + 1]
  float* wsm = smem + a.xs_floats;      // [k][ck][C]
  const bool whole = ck == C;
  const int row_tiles = (T_len + tr - 1) / tr;
  const int tiles = a.B * row_tiles;

  auto stage_weights = [&](int ci0) {
    for (int i = tid; i < k * ck * C; i += THREADS) {
      const int o = i % C;
      const int ci = (i / C) % ck;
      const int tap = i / (C * ck);
      wsm[i] = as_float<T>(w[(static_cast<size_t>(tap) * C + ci0 + ci) * C + o]);
    }
  };
  if (whole) {
    stage_weights(0);  // once: the block's tiles all read the same weights
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / row_tiles;
    const int r0 = (tile % row_tiles) * tr;
    const T* xb = x + static_cast<size_t>(b) * T_len * C;
    float acc[RB][4];
#pragma unroll
    for (int m = 0; m < RB; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

    for (int ci0 = 0; ci0 < C; ci0 += ck) {
      __syncthreads();  // the last chunk's (or tile's) reads of xs and wsm are done
      for (int i = tid; i < rows_in * ck; i += THREADS) {
        const int rr = i / ck, cc = i % ck;
        const int t = r0 - left + rr;
        xs[rr * xs_stride + cc] =
            (t >= 0 && t < T_len) ? as_float<T>(xb[static_cast<size_t>(t) * C + ci0 + cc]) : 0.f;
      }
      if (!whole) stage_weights(ci0);
      __syncthreads();
      for (int tap = 0; computes && tap < k; ++tap) {
        // output row r0 + ty + m * row_step reads slab row ty + m * row_step + tap
        const float* xr = xs + (ty + tap) * xs_stride;
        const float* wr = wsm + static_cast<size_t>(tap) * ck * C + 4 * tx;
        for (int ci = 0; ci < ck; ++ci) {
          const float4 wv = *reinterpret_cast<const float4*>(wr + static_cast<size_t>(ci) * C);
#pragma unroll
          for (int m = 0; m < RB; ++m) {
            const float xv = xr[m * row_step * xs_stride + ci];
            acc[m][0] = fmaf(xv, wv.x, acc[m][0]);
            acc[m][1] = fmaf(xv, wv.y, acc[m][1]);
            acc[m][2] = fmaf(xv, wv.z, acc[m][2]);
            acc[m][3] = fmaf(xv, wv.w, acc[m][3]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < RB; ++m) {
      const int r = r0 + ty + m * row_step;
      if (!computes || r >= T_len) continue;
      *reinterpret_cast<float4*>(a.out + (static_cast<size_t>(b) * T_len + r) * C + 4 * tx) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
  }
}

// The staged chunk of input channels: all C when the weights fit beside the slab, else
// the largest power of two (down to 4) that divides C and fits.
int chunk_channels(int C, int k, int tr, size_t* smem, int* xs_floats) {
  int cands[8], n = 0;
  cands[n++] = C;
  for (int p = 128; p >= 4; p /= 2)
    if (p < C && C % p == 0) cands[n++] = p;
  for (int i = 0; i < n; ++i) {
    const int ck = cands[i];
    const int xs = ((tr + k - 1) * (ck + 1) + 3) / 4 * 4;  // weights 16-byte aligned
    const size_t bytes = (static_cast<size_t>(xs) + static_cast<size_t>(k) * ck * C) * 4;
    if (bytes <= static_cast<size_t>(SMEM_BUDGET)) {
      *smem = bytes;
      *xs_floats = xs;
      return ck;
    }
  }
  return 0;
}

template <typename T>
int launch(Args& a, int* grid_out, cudaStream_t stream) {
  size_t smem = 0;
  a.tr = RB * (THREADS / (a.C / 4));
  a.ck = chunk_channels(a.C, a.k, a.tr, &smem, &a.xs_floats);
  if (a.ck == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = narrow_conv_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = static_cast<long long>(a.B) * ((a.T + a.tr - 1) / a.tr);
  const long long most = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(tiles < most ? tiles : most);
  if (grid_out) *grid_out = blocks;
  kernel<<<blocks, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (B, T, C) and w (k, C, C), both fp32 (bf16 = 0) or both bf16 (bf16 = 1); out (B, T, C)
// fp32; grid_out (host, may be null) receives the thread blocks launched. Returns the
// launch's CUDA error code.
int ttscube_narrow_conv(const void* x, const void* w, int bf16, int B, int T, int C, int k,
                        float* out, int* grid_out, void* stream) {
  if (B < 1 || T < 1 || C < QUANTUM || C > MAX_C || C % QUANTUM != 0 || k < 1 || k > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x;
  a.w = w;
  a.out = out;
  a.B = B;
  a.T = T;
  a.C = C;
  a.k = k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, grid_out, s) : launch<float>(a, grid_out, s);
}

// The limits, so that the wrapper can check its inputs against them.
int ttscube_narrow_conv_limits(int* out) {
  out[0] = QUANTUM;
  out[1] = MAX_C;
  out[2] = MAX_K;
  return 0;
}

}  // extern "C"
