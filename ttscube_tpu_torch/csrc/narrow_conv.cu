// A bias-free 1-D convolution with dilation 1 over a narrow channel count, for sm_90a:
// replaces the TPU kernel `narrow_conv_pallas_blocked` (ttscube_tpu/ops/pallas_conv.py:46,
// kernel body `_conv_kernel_blocked` :35).
//
//   out[b][t][o] = sum_{j < k, i < C} x[b][t - (k - 1) / 2 + j][i] * w[j][i][o]
//
// with x read as zero outside [0, T) (`fold_conv_kernel`'s padding: an even k pads
// (k - 1) / 2 on the left and k / 2 on the right). x and w are both fp32 or both bf16;
// products are exact in fp32 either way, sums are fp32 and the output is fp32 -- the
// TPU kernel's jnp.dot(..., preferred_element_type=float32). The TPU kernel's time
// folding and host-gathered halos are layout for its matrix unit, not part of the
// function.
//
// What bounds it on an H100: in bf16, bytes (at B = 8, T = 122,880, C = 32, k = 11 the
// 63 MB of x in and 126 MB of fp32 out take 0.056 ms at 3.35 TB/s, the 22 GFLOP 0.022 ms
// at 989 TFLOP/s); in fp32, operations (0.33 ms at 67 TFLOP/s on the CUDA cores).
//
// bf16 operands: an implicit GEMM on the tensor cores (`narrow_conv_mma`). M = output
// rows, N = output channels, K = (tap, input channel) pairs, in
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: a tap is a row offset into the staged
// slab, so ldmatrix reads the A fragments straight from it at row r + tap (no im2col),
// and ldmatrix.trans reads the B fragments from the weights as stored, [tap][ci][co].
// A block owns 32 output channels (grid blocks % (C / 32)) and walks row tiles of 256
// rows persistently; each of its 8 warps sums 32 rows x 32 channels. The next tile's
// slab, 256 + k - 1 rows x C bf16, comes in by cp.async into the second of two buffers
// while the warps multiply the current one, so the HBM reads overlap the MMAs. Where
// the block's weights fit beside the two slabs (k x C x 32 bf16: 22.5 KB at C = 32,
// k = 11) they are staged once; above that (C = 256 at k = 15) each step of the
// pipeline is one chunk of input channels, its weights staged with its slab. Rows are
// padded by 16 bytes so that ldmatrix's eight rows fall on distinct banks. Each
// thread writes its accumulators as float2 pairs: a warp's store covers whole 32-byte
// sectors of eight output rows. Every output element is summed by one thread in a fixed
// order, so launches are bit-equal.
//
// fp32 operands: a direct convolution on the fp32 CUDA cores (`narrow_conv_kernel`);
// one-pass TF32 would miss the 1e-5 limit. One block owns a tile of rows and all C
// output channels; each thread sums RB rows by 4 output channels. The tile's slab of
// input rows plus its k - 1 halo rows and the weights go through shared memory: the
// whole (k, C, C) weight staged once where it fits beside the slab (45 KB at C = 32,
// k = 11), else one chunk of input channels at a time.
//
// The caller (ops/narrow_conv.py) picks the chunk of input channels, `ck`, by the same
// shared-memory arithmetic as the `smem_bytes` below and the limits this library
// reports.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RB = 4;            // fp32 kernel: output rows per thread
constexpr int QUANTUM = 32;      // channels: a multiple of this
constexpr int MAX_C = 256;
constexpr int MAX_K = 15;
constexpr int SMEM_BUDGET = 227 * 1024;  // bytes of shared memory a block may use
constexpr int MMA_MT = 2;        // bf16 kernel: 16-row MMA tiles per warp
constexpr int MMA_ROWS = 8 * 16 * MMA_MT;  // bf16 kernel: output rows per tile (8 warps)
constexpr int MMA_COLS = 32;     // bf16 kernel: output channels per block (4 n-tiles of 8)
constexpr int PAD = 8;           // bf16 kernel: bf16 elements of padding per staged row

// -- fp32 operands: the CUDA cores ---------------------------------------------------

struct Args {
  const float* x;  // (B, T, C)
  const float* w;  // (k, C, C): tap, c_in, c_out
  float* out;      // (B, T, C) fp32
  int B, T, C, k;
  int ck;          // input channels per staged chunk (C when the weights fit whole)
  int tr;          // output rows per tile
  int xs_floats;   // floats of shared memory before the staged weights
};

__global__ void __launch_bounds__(THREADS) narrow_conv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const float* __restrict__ x = a.x;
  const float* __restrict__ w = a.w;
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
      wsm[i] = w[(static_cast<size_t>(tap) * C + ci0 + ci) * C + o];
    }
  };
  if (whole) {
    stage_weights(0);  // once: the block's tiles all read the same weights
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / row_tiles;
    const int r0 = (tile % row_tiles) * tr;
    const float* xb = x + static_cast<size_t>(b) * T_len * C;
    float acc[RB][4];
#pragma unroll
    for (int m = 0; m < RB; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

    for (int ci0 = 0; ci0 < C; ci0 += ck) {
      __syncthreads();  // the last chunk's (or tile's) reads of xs and wsm are done
      for (int i = tid; i < rows_in * ck; i += THREADS) {
        const int rr = i / ck, cc = i % ck;
        const int t = r0 - left + rr;
        xs[rr * xs_stride + cc] =
            (t >= 0 && t < T_len) ? xb[static_cast<size_t>(t) * C + ci0 + cc] : 0.f;
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

// -- bf16 operands: the tensor cores --------------------------------------------------

struct MmaArgs {
  const __nv_bfloat16* x;  // (B, T, C)
  const __nv_bfloat16* w;  // (k, C, C): tap, c_in, c_out
  float* out;              // (B, T, C) fp32
  int B, T, C, k;
  int ck;                  // input channels per pipeline step (C: weights staged once)
  int w_bytes;             // bytes of one weight buffer
  int x_bytes;             // bytes of one slab buffer
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS) narrow_conv_mma(MmaArgs a) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const __nv_bfloat16* __restrict__ x = a.x;
  const __nv_bfloat16* __restrict__ w = a.w;
  const int C = a.C, k = a.k, ck = a.ck, T_len = a.T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool whole = ck == C;
  const int n_cg = C / MMA_COLS;
  const int cg = blockIdx.x % n_cg;            // this block's 32 output channels
  const int rt_first = blockIdx.x / n_cg;      // its first row tile
  const int rt_step = gridDim.x / n_cg;        // the launch makes gridDim.x % n_cg == 0
  const int row_tiles = (T_len + MMA_ROWS - 1) / MMA_ROWS;
  const int n_rt = a.B * row_tiles;
  const int n_chunks = C / ck;
  const int my_tiles = rt_first < n_rt ? (n_rt - rt_first + rt_step - 1) / rt_step : 0;
  const int n_steps = my_tiles * n_chunks;
  const int left = (k - 1) / 2;
  const int rows_in = MMA_ROWS + k - 1;
  const int xs_stride = ck + PAD;              // bf16 elements per staged slab row
  const int ws_stride = MMA_COLS + PAD;        // bf16 elements per staged weight row
  // whole: [weights][slab 0][slab 1]; chunked: [weights 0][slab 0][weights 1][slab 1]
  uint32_t wbuf[2], xbuf[2];
  wbuf[0] = smem_addr(smem);
  xbuf[0] = wbuf[0] + a.w_bytes;
  wbuf[1] = whole ? wbuf[0] : xbuf[0] + a.x_bytes;
  xbuf[1] = whole ? xbuf[0] + a.x_bytes : wbuf[1] + a.w_bytes;

  // step s: the s / n_chunks-th of this block's row tiles, chunk s % n_chunks of its
  // input channels, into buffer s & 1
  auto load_step = [&](int s) {
    const int rt = rt_first + (s / n_chunks) * rt_step;
    const int ci0 = (s % n_chunks) * ck;
    const int b = rt / row_tiles, r0 = (rt % row_tiles) * MMA_ROWS;
    const int pieces = ck / 8;  // 16-byte pieces per slab row
    for (int i = tid; i < rows_in * pieces; i += THREADS) {
      const int rr = i / pieces, q = i % pieces;
      const int t = r0 - left + rr;
      const bool inside = t >= 0 && t < T_len;
      const __nv_bfloat16* src =
          inside ? x + (static_cast<size_t>(b) * T_len + t) * C + ci0 + q * 8 : x;
      cp_async16(xbuf[s & 1] + (rr * xs_stride + q * 8) * 2, src, inside ? 16 : 0);
    }
    if (!whole || s == 0) {
      for (int i = tid; i < k * ck * (MMA_COLS / 8); i += THREADS) {
        const int row = i / (MMA_COLS / 8), q = i % (MMA_COLS / 8);
        const int tap = row / ck, ci = row % ck;
        cp_async16(wbuf[s & 1] + (row * ws_stride + q * 8) * 2,
                   w + (static_cast<size_t>(tap) * C + ci0 + ci) * C + cg * MMA_COLS + q * 8,
                   16);
      }
    }
    cp_async_commit();
  };

  // ldmatrix row addresses: A (16 rows x 16 k) from lanes 0-15 rows 0-15 at k 0, lanes
  // 16-31 the same rows at k 8; B (16 k x 16 n), transposed, from lanes' k rows
  // (lane & 7) + 8 * ((lane >> 3) & 1) at n 8 * (lane >> 4)
  const int a_row = warp * 16 * MMA_MT + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_col = (lane >> 4) * 8;
  const int g = lane >> 2, tg = lane & 3;
  float acc[MMA_MT][4][4];

  if (n_steps > 0) load_step(0);
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) {
      load_step(s + 1);  // into the buffer that step s - 1 read, released by its barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int chunk = s % n_chunks;
    if (chunk == 0) {
#pragma unroll
      for (int mt = 0; mt < MMA_MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
            acc[mt][nt][3] = 0.f;
    }
    const uint32_t xs = xbuf[s & 1], ws = wbuf[s & 1];
    for (int tap = 0; tap < k; ++tap) {
      for (int kk = 0; kk < ck; kk += 16) {
        uint32_t af[MMA_MT][4], bf[2][4];
#pragma unroll
        for (int mt = 0; mt < MMA_MT; ++mt)
          ldmatrix_x4(af[mt], xs + ((a_row + mt * 16 + tap) * xs_stride + kk + a_col) * 2);
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldmatrix_x4_trans(bf[np],
                            ws + ((tap * ck + kk + b_row) * ws_stride + np * 16 + b_col) * 2);
#pragma unroll
        for (int mt = 0; mt < MMA_MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[mt][nt], af[mt], bf[nt >> 1][(nt & 1) * 2],
                     bf[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
    if (chunk == n_chunks - 1) {
      const int rt = rt_first + (s / n_chunks) * rt_step;
      const int b = rt / row_tiles, r0 = (rt % row_tiles) * MMA_ROWS;
#pragma unroll
      for (int mt = 0; mt < MMA_MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + warp * 16 * MMA_MT + mt * 16 + g + h * 8;
          if (r >= T_len) continue;
          float* dst = a.out + (static_cast<size_t>(b) * T_len + r) * C + cg * MMA_COLS + 2 * tg;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            *reinterpret_cast<float2*>(dst + nt * 8) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
    }
    __syncthreads();  // buffer s & 1 is free for step s + 2
  }
}

// Shared memory of the fp32 kernel for a chunk of ck input channels: the slab (padded
// by one float a row, the weights after it 16-byte aligned) and the chunk's weights.
// Sets the tile's rows and the floats before the weights.
size_t smem_bytes(Args* a) {
  a->tr = RB * (THREADS / (a->C / 4));
  a->xs_floats = ((a->tr + a->k - 1) * (a->ck + 1) + 3) / 4 * 4;
  return (static_cast<size_t>(a->xs_floats) + static_cast<size_t>(a->k) * a->ck * a->C) * 4;
}

// Shared memory of the bf16 kernel: one weight buffer and two slab buffers when ck == C,
// else two of each. Sets the bytes of one weight buffer and of one slab buffer.
size_t smem_bytes(MmaArgs* a) {
  a->w_bytes = a->k * a->ck * (MMA_COLS + PAD) * 2;
  a->x_bytes = (MMA_ROWS + a->k - 1) * (a->ck + PAD) * 2;
  const size_t w = a->w_bytes, x = a->x_bytes;
  return a->ck == a->C ? w + 2 * x : 2 * (w + x);
}

template <typename K, typename A>
int launch(K kernel, const A& args, size_t smem, long long work, int quantum, int* grid_out,
           cudaStream_t stream) {
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
  // as many blocks as fit on the card at once, but no more than there is work, and a
  // multiple of `quantum` (the bf16 kernel's channel groups)
  long long most = static_cast<long long>(per_sm) * sms;
  if (work < most) most = work;
  const int blocks = static_cast<int>(most < quantum ? quantum : most / quantum * quantum);
  if (grid_out) *grid_out = blocks;
  kernel<<<blocks, THREADS, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (B, T, C) and w (k, C, C), both fp32 (bf16 = 0) or both bf16 (bf16 = 1), each
// 16-byte aligned; out (B, T, C) fp32; ck the input channels per staged chunk (C, or a
// divisor of C: a multiple of 4 for fp32, of 32 for bf16) whose shared memory fits
// the budget; grid_out (host, may be null) receives the thread blocks launched. Returns
// the launch's CUDA error code.
int ttscube_narrow_conv(const void* x, const void* w, int bf16, int B, int T, int C, int k,
                        int ck, float* out, int* grid_out, void* stream) {
  if (B < 1 || T < 1 || C < QUANTUM || C > MAX_C || C % QUANTUM != 0 || k < 1 || k > MAX_K ||
      ck < 1 || C % ck != 0 || ck % (bf16 ? QUANTUM : 4) != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    MmaArgs a{};
    a.x = static_cast<const __nv_bfloat16*>(x);
    a.w = static_cast<const __nv_bfloat16*>(w);
    a.out = out;
    a.B = B;
    a.T = T;
    a.C = C;
    a.k = k;
    a.ck = ck;
    const size_t smem = smem_bytes(&a);
    if (smem > static_cast<size_t>(SMEM_BUDGET)) return static_cast<int>(cudaErrorInvalidValue);
    const int n_cg = C / MMA_COLS;
    const long long work = static_cast<long long>(B) * ((T + MMA_ROWS - 1) / MMA_ROWS) * n_cg;
    return launch(narrow_conv_mma, a, smem, work, n_cg, grid_out, s);
  }
  Args a{};
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.out = out;
  a.B = B;
  a.T = T;
  a.C = C;
  a.k = k;
  a.ck = ck;
  const size_t smem = smem_bytes(&a);
  if (smem > static_cast<size_t>(SMEM_BUDGET)) return static_cast<int>(cudaErrorInvalidValue);
  const long long work = static_cast<long long>(B) * ((T + a.tr - 1) / a.tr);
  return launch(narrow_conv_kernel, a, smem, work, 1, grid_out, s);
}

// The limits and the tiling constants, so that the wrapper can check its inputs and
// plan the chunk of input channels by the same arithmetic.
int ttscube_narrow_conv_limits(int* out) {
  out[0] = QUANTUM;
  out[1] = MAX_C;
  out[2] = MAX_K;
  out[3] = SMEM_BUDGET;
  out[4] = THREADS;
  out[5] = RB;
  out[6] = MMA_ROWS;
  out[7] = MMA_COLS;
  out[8] = PAD;
  return 0;
}

}  // extern "C"
