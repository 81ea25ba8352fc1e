// One weight-normalised ResBlock1 conv of an unfused generator stage (S1), for sm_90a,
// at bf16 storage:
//
//   y[b][t][o] = bf16(bias[o] + sum_{j < k, i < C} h[b][t - d (k - 1) / 2 + j d][i] w[j][i][o])
//   then, as the launch asks: y = bf16(res + y); y = bf16(acc + y); y = bf16(y * scale);
//   y = leaky(y)
//
// with h = leaky(x) (or x, where the producer activated it already), leaky(v) =
// bf16(v > 0 ? v : v * slope) (the slope a bf16 value, the product rounded once, as
// `jax.nn.leaky_relu` on bf16), and h read as zero outside [0, T) ("same" zero padding).
// These are the rounding points of the serving generator's plain ResBlock1 conv at bf16
// storage (`stage_conv_plain`, ops/stage_conv.py): the conv's fp32 sum plus the fp32 bias
// rounded once to bf16; the residual `x = x + h`, the sum of the blocks `acc + h` and
// their mean each rounded once more. Every tensor is NWC (B, T, C): no layout pass runs.
//
// It replaces no TPU kernel: the JAX package leaves these convs to XLA. It was added
// because the serving stages that `fuse_channels` leaves unfused (v1 stages 0-2 at C =
// 256, 128, 64) ran each conv as a chain of launches on the card (the leaky, a bf16 ->
// fp32 copy, cuDNN's NCW -> NHWC layout pass, the conv, the bias, an fp32 -> bf16 copy, the
// residual add), and those passes, not the convs, took most of the time.
//
// What bounds it on an H100: a conv does 2 C k operations per output element against 6
// bytes (bf16 in, out and residual; 8 with the sum) at 3.35 TB/s. With bf16 operands at
// 989 TFLOP/s: bytes where C k is below ~890 (C = 64 at every k, k = 3 at C = 128 and
// 256; at B = 128, stage 2, k = 11: 0.35 TFLOP, 0.36 ms, against 1.5 GB, 0.45 ms),
// operations above.
//
// Design. An implicit GEMM on the tensor cores (mma.sync.m16n8k16 bf16, fp32 sums): M =
// output rows, N = output channels, K = (tap, input channel). A block of 8 warps owns 512
// rows by 64 output channels; each warp sums 128 rows by 32 channels (8 x 4 MMA tiles).
// Blocks are persistent, one per SM, each walking its (row tile, channel block) items, the
// channel block fastest, so that the blocks reading one slab run side by side and share
// it in L2; the walk is counted forward step by step, dividing once per item. A step is
// up to three taps of one 64-channel chunk: the chunk's slab (512 + d (k - 1) rows, the
// leaky applied once in shared memory when it has landed) and the taps' weights (64 x 64
// per tap). A tap is a row offset of d into the slab, so
// ldmatrix reads the A fragments straight from it (no im2col), and ldmatrix.trans reads
// the B fragments from the weights as stored, [ci][co]. The next step's weights and a
// share of the next chunk's slab come in by cp.async while the warps multiply, one
// barrier a step. Rows are padded by 16 bytes so that ldmatrix's eight rows fall on
// distinct banks. The epilogue writes the rounded conv plus bias into the chunk's slab
// buffer, then each warp takes whole rows of the tile in 16-byte pieces (four in flight
// at once where a residual is read): residual and sum read, output written in whole
// 32-byte sectors. out may be res or acc (an element is read, then written, by one
// thread). Every output element is summed by one thread in a fixed order, so launches
// are bit-equal.
//
// Operands: bf16 activations (exact) and the weights rounded to bf16, the operands of a
// bf16 compute type (`conv_operands`); the sums fp32. The tensor cores add into them
// rounding toward zero: over a conv's at most 176 MMA steps (11 taps of 256 channels,
// 16 at a time) that drifts by ~1e-5 relative, far below the bf16 rounding of the
// result. fp32 operands are not taken: the generator sends those convs to cuDNN
// (models/hifigan_fused.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using mma_sm90::ldsm_x4;
using mma_sm90::ldsm_x4_trans;
using mma_sm90::mma_bf16;
using mma_sm90::pack_bf16;
using mma_sm90::smem_addr;

constexpr int WARPS_M = 4;           // warps down a block's rows
constexpr int WARPS_N = 2;           // warps across a block's output channels
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MT = 8;                // 16-row MMA tiles per warp: 128 rows
constexpr int NT = 4;                // 8-channel MMA tiles per warp: 32 channels
constexpr int ROWS = WARPS_M * 16 * MT;  // output rows per block tile
constexpr int COLS = WARPS_N * 8 * NT;   // output channels per block tile (64)
constexpr int CK = 64;               // input channels per pipeline chunk
constexpr int PAD = 8;               // bf16 elements of padding per staged row
constexpr int XS = CK + PAD;         // bf16 elements per staged slab row
constexpr int WS = COLS + PAD;       // bf16 elements per staged weight row
constexpr int EPI_GROUP = 4;         // epilogue: 16-byte pieces a thread reads at once
constexpr int QUANTUM = 64;          // channels: a multiple of this
constexpr int MAX_C = 1024;
constexpr int MAX_HALO = 64;         // d (k - 1): the slab rows beyond the tile's
constexpr int TAPS = 3;              // taps a step multiplies
constexpr int SMEM_BUDGET = 227 * 1024;

struct Args {
  const __nv_bfloat16* x;    // (B, T, C): the conv's input
  const __nv_bfloat16* w;    // (k, C, C): tap, c_in, c_out
  const float* bias;         // (C)
  const __nv_bfloat16* res;  // (B, T, C) or null
  const __nv_bfloat16* acc;  // (B, T, C) or null
  __nv_bfloat16* out;        // (B, T, C); may be res or acc
  int B, T, C, k, d;
  int act_in;                // apply the leaky to x (else x is activated already)
  int act_out;               // apply the leaky to the result, last
  float slope;               // the leaky slope, a bf16 value
  float scale;               // the mean's factor, or 0 for none
  int slab_bytes;            // bytes of one slab buffer
  int w_bytes;               // bytes of one weight buffer
};

// 16 bytes from global to shared memory, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float leaky(float v, float slope) { return v > 0.f ? v : v * slope; }

// leaky on two bf16 of one register, each rounded once to bf16
__device__ __forceinline__ uint32_t leaky2(uint32_t v, float slope) {
  return pack_bf16(leaky(bf16_lo(v), slope), leaky(bf16_hi(v), slope));
}

// The epilogue after the bias on 8 outputs y (bf16, rounded): the residual rv, the sum
// av and the mean's scale where the launch has them, each rounded once, then the leaky
// where asked for
__device__ __forceinline__ uint4 finish(uint4 y, const uint4& rv, const uint4& av,
                                        const Args& a) {
  uint32_t* yw = reinterpret_cast<uint32_t*>(&y);
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(&rv);
  const uint32_t* aw = reinterpret_cast<const uint32_t*>(&av);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v0 = bf16_lo(yw[j]), v1 = bf16_hi(yw[j]);
    if (a.res) {
      v0 = round_bf16(bf16_lo(rw[j]) + v0);
      v1 = round_bf16(bf16_hi(rw[j]) + v1);
    }
    if (a.acc) {
      v0 = round_bf16(bf16_lo(aw[j]) + v0);
      v1 = round_bf16(bf16_hi(aw[j]) + v1);
    }
    if (a.scale != 0.f) {
      v0 *= a.scale;
      v1 *= a.scale;
    }
    yw[j] = pack_bf16(v0, v1);
    if (a.act_out) yw[j] = leaky2(yw[j], a.slope);
  }
  return y;
}

__global__ void __launch_bounds__(THREADS, 1) stage_conv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int C = a.C, k = a.k, d = a.d, T_len = a.T;
  const int halo = d * (k - 1), left = halo / 2;
  const int rows_in = ROWS + halo;
  const int n_chunks = C / CK, n_cb = C / COLS;
  const int row_tiles = (T_len + ROWS - 1) / ROWS;
  const int n_items = a.B * row_tiles * n_cb;
  const int first = blockIdx.x, stride = gridDim.x;
  const int my_items = first < n_items ? (n_items - first + stride - 1) / stride : 0;
  const int chunk_steps = (k + TAPS - 1) / TAPS;  // steps per chunk
  const int n_steps = my_items * n_chunks * chunk_steps;
  const int slab_pieces = rows_in * (CK / 8);  // 16-byte pieces of one slab
  // shared memory: two slab buffers, then two weight buffers
  uint32_t xbuf[2], wbuf[2];
  xbuf[0] = smem_addr(smem);
  xbuf[1] = xbuf[0] + a.slab_bytes;
  wbuf[0] = xbuf[1] + a.slab_bytes;
  wbuf[1] = wbuf[0] + a.w_bytes;

  // A place in this block's walk: its i-th item (row tile and channel block, the channel
  // block fastest) with the item's batch row b, first row r0 and channel block cb, and the
  // chunk and first tap of a step within it. Moved forward one step at a time, so that the
  // walk divides only once per item.
  struct Place {
    int i, chunk, tap, b, r0, cb;
  };
  auto locate = [&](Place& p) {
    const int item = first + p.i * stride;
    const int rt = item / n_cb;
    p.cb = item - rt * n_cb;
    p.b = rt / row_tiles;
    p.r0 = (rt - p.b * row_tiles) * ROWS;
  };
  auto next_chunk = [&](Place& p) {
    p.tap = 0;
    if (++p.chunk == n_chunks) {
      p.chunk = 0;
      ++p.i;
      if (p.i < my_items) locate(p);
    }
  };
  auto next_step = [&](Place& p) {
    p.tap += TAPS;
    if (p.tap >= k) next_chunk(p);
  };

  // part `part` of `of` of the slab of place p (its chunk's input rows, halo included)
  // into slab buffer `buf`
  auto load_slab = [&](const Place& p, int buf, int part, int of) {
    const int hi = slab_pieces * (part + 1) / of;
    const __nv_bfloat16* xb = a.x + static_cast<size_t>(p.b) * T_len * C + p.chunk * CK;
    for (int e = slab_pieces * part / of + tid; e < hi; e += THREADS) {
      const int rr = e / (CK / 8), piece = e % (CK / 8);
      const int t = p.r0 - left + rr;
      const bool inside = t >= 0 && t < T_len;
      cp_async16(xbuf[buf] + (rr * XS + piece * 8) * 2,
                 inside ? xb + static_cast<size_t>(t) * C + piece * 8 : a.x, inside ? 16 : 0);
    }
  };

  // the weights of place p's step, each of its taps for its chunk and channel block,
  // into weight buffer `buf`: rows (tap - p.tap, c_in)
  auto load_w = [&](const Place& p, int buf) {
    const __nv_bfloat16* wt = a.w + static_cast<size_t>(p.chunk) * CK * C + p.cb * COLS;
    for (int e = tid; e < TAPS * CK * (COLS / 8); e += THREADS) {
      const int row = e / (COLS / 8), piece8 = e % (COLS / 8);
      const int ci = row % CK, tap = p.tap + row / CK;
      if (tap < k)
        cp_async16(wbuf[buf] + (row * WS + piece8 * 8) * 2,
                   wt + (static_cast<size_t>(tap) * C + ci) * C + piece8 * 8, 16);
    }
  };

  // ldmatrix row addresses: A (16 rows x 16 k) from lanes 0-15 rows 0-15 at k 0, lanes
  // 16-31 the same rows at k 8; B (16 k x 16 n), transposed, from lanes' k rows
  // (lane & 7) + 8 ((lane >> 3) & 1) at n 8 (lane >> 4)
  const int a_row = wm * 16 * MT + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_col = (lane >> 4) * 8;
  const int g = lane >> 2, tg = lane & 3;
  float acc[MT][NT][4];

  Place cur{0, 0, 0, 0, 0, 0}, ahead, slab_next;  // the step; the next step; the next
  if (my_items > 0) {                              // chunk (its slab)
    locate(cur);
    load_slab(cur, 0, 0, 1);
    load_w(cur, 0);
    cp_async_commit();
  }
  ahead = cur;
  int xb = 0;  // the slab buffer of the current chunk
  for (int s = 0; s < n_steps; ++s) {
    const int tap = cur.tap, wb = s & 1;
    // what step s - 1 fetched has landed: this step's weights and, at tap 0, the last
    // part of this chunk's slab
    cp_async_wait<0>();
    __syncthreads();  // every warp is past step s - 1: its buffers may be refilled
    // the next step's weights, and a k-th of the next chunk's slab, arrive while this
    // step multiplies
    if (s + 1 < n_steps) {
      next_step(ahead);
      load_w(ahead, wb ^ 1);
    }
    if (tap == 0) {
      slab_next = cur;
      next_chunk(slab_next);
    }
    if (slab_next.i < my_items) load_slab(slab_next, xb ^ 1, tap / TAPS, chunk_steps);
    cp_async_commit();
    if (tap == 0 && a.act_in) {
      // this chunk's slab has landed whole: the leaky, once
      __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + xb * a.slab_bytes);
      for (int e = tid; e < slab_pieces; e += THREADS) {
        uint4* p = reinterpret_cast<uint4*>(xs + (e / (CK / 8)) * XS + (e % (CK / 8)) * 8);
        uint4 v = *p;
        v.x = leaky2(v.x, a.slope);
        v.y = leaky2(v.y, a.slope);
        v.z = leaky2(v.z, a.slope);
        v.w = leaky2(v.w, a.slope);
        *p = v;
      }
      __syncthreads();
    }
    if (tap == 0 && cur.chunk == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    }
#pragma unroll
    for (int tt = 0; tt < TAPS; ++tt) {
      if (tap + tt >= k) break;
      const uint32_t xs = xbuf[xb] + ((a_row + (tap + tt) * d) * XS + a_col) * 2;
      const uint32_t ws = wbuf[wb] + ((tt * CK + b_row) * WS + wn * (NT * 8) + b_col) * 2;
#pragma unroll
      for (int kk = 0; kk < CK; kk += 16) {
        uint32_t af[MT][4], bf[2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldsm_x4(af[mt], xs + (mt * 16 * XS + kk) * 2);
#pragma unroll
        for (int np = 0; np < 2; ++np) ldsm_x4_trans(bf[np], ws + (kk * WS + np * 16) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[mt][nt], af[mt], bf[nt >> 1][(nt & 1) * 2],
                     bf[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
    if (tap + TAPS >= k && cur.chunk == n_chunks - 1) {
      // the conv plus bias, rounded, into this chunk's slab buffer (free once every warp
      // is past its last MMAs), ROWS x COLS bf16 in rows of WS; then the rest of the
      // epilogue in 16-byte pieces, whole rows of the tile to a warp: the residual and
      // the sum read, the output written, each in whole 32-byte sectors
      __syncthreads();
      unsigned char* tile = smem + xb * a.slab_bytes;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = wn * (NT * 8) + nt * 8 + 2 * tg;
        const float2 bias = *reinterpret_cast<const float2*>(a.bias + cur.cb * COLS + col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 16 * MT + mt * 16 + g + h * 8;
            *reinterpret_cast<uint32_t*>(tile + (r * WS + col) * 2) =
                pack_bf16(acc[mt][nt][2 * h] + bias.x, acc[mt][nt][2 * h + 1] + bias.y);
          }
      }
      __syncthreads();
      const int rows = T_len - cur.r0 < ROWS ? T_len - cur.r0 : ROWS, n = rows * (COLS / 8);
      const size_t base = (static_cast<size_t>(cur.b) * T_len + cur.r0) * C + cur.cb * COLS;
      // piece e: row e / (COLS / 8) of the tile, channels 8 (e % (COLS / 8)) on
      auto at = [&](int e) {
        return base + static_cast<size_t>(e / (COLS / 8)) * C + e % (COLS / 8) * 8;
      };
      auto staged = [&](int e) {
        return *reinterpret_cast<const uint4*>(tile +
                                               ((e / (COLS / 8)) * WS + e % (COLS / 8) * 8) * 2);
      };
      if (a.res || a.acc) {
        // the residual and the sum of EPI_GROUP pieces in flight at once
        for (int e0 = tid; e0 < n; e0 += EPI_GROUP * THREADS) {
          uint4 rv[EPI_GROUP], av[EPI_GROUP];
#pragma unroll
          for (int i = 0; i < EPI_GROUP; ++i) {
            const int e = e0 + i * THREADS;
            if (e < n && a.res) rv[i] = *reinterpret_cast<const uint4*>(a.res + at(e));
            if (e < n && a.acc) av[i] = *reinterpret_cast<const uint4*>(a.acc + at(e));
          }
#pragma unroll
          for (int i = 0; i < EPI_GROUP; ++i) {
            const int e = e0 + i * THREADS;
            if (e >= n) break;
            *reinterpret_cast<uint4*>(a.out + at(e)) = finish(staged(e), rv[i], av[i], a);
          }
        }
      } else {
#pragma unroll 4
        for (int e = tid; e < n; e += THREADS)
          *reinterpret_cast<uint4*>(a.out + at(e)) = finish(staged(e), uint4{}, uint4{}, a);
      }
    }
    if (tap + TAPS >= k) xb ^= 1;
    next_step(cur);
  }
  cp_async_wait<0>();  // nothing left in flight at exit
}

int launch(const Args& a, int* grid_out, cudaStream_t stream) {
  const size_t smem = 2 * (static_cast<size_t>(a.slab_bytes) + a.w_bytes);
  if (smem > static_cast<size_t>(SMEM_BUDGET)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(stage_conv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stage_conv_kernel,
                                                           THREADS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // as many blocks as fit on the card at once, but no more than there are items
  const long long items = static_cast<long long>(a.B) * ((a.T + ROWS - 1) / ROWS) * (a.C / COLS);
  long long blocks = static_cast<long long>(per_sm) * sms;
  if (items < blocks) blocks = items;
  if (grid_out) *grid_out = static_cast<int>(blocks);
  stage_conv_kernel<<<static_cast<int>(blocks), THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, res, acc and out (B, T, C) bf16 and w (k, C, C) bf16, each 16-byte aligned
// (res and acc may be null; out may be res or acc, never x); bias (C) fp32; k odd, d >= 1,
// d (k - 1) <= MAX_HALO; slope the leaky's slope as a bf16 value; scale the mean's factor
// or 0; grid_out (host, may be null) receives the thread blocks launched. Returns the
// launch's CUDA error code.
int ttscube_stage_conv(const void* x, const void* w, const float* bias, const void* res,
                       const void* acc, void* out, int B, int T, int C, int k, int d,
                       int act_in, int act_out, float slope, float scale,
                       int* grid_out, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(res) | reinterpret_cast<uintptr_t>(acc) |
                          reinterpret_cast<uintptr_t>(out);
  if (B < 1 || T < 1 || C < QUANTUM || C > MAX_C || C % QUANTUM != 0 || k < 1 || k % 2 == 0 ||
      d < 1 || d * (k - 1) > MAX_HALO || align % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bias) % 8 != 0 || out == x ||
      static_cast<long long>(B) * ((T + ROWS - 1) / ROWS) * (C / COLS) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = bias;
  a.res = static_cast<const __nv_bfloat16*>(res);
  a.acc = static_cast<const __nv_bfloat16*>(acc);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B;
  a.T = T;
  a.C = C;
  a.k = k;
  a.d = d;
  a.act_in = act_in;
  a.act_out = act_out;
  a.slope = slope;
  a.scale = scale;
  a.slab_bytes = (ROWS + d * (k - 1)) * XS * 2;
  a.w_bytes = TAPS * CK * WS * 2;
  return launch(a, grid_out, static_cast<cudaStream_t>(stream));
}

// The limits and the tiling constants, so that the wrapper checks its inputs by them.
int ttscube_stage_conv_limits(int* out) {
  out[0] = QUANTUM;
  out[1] = MAX_C;
  out[2] = MAX_HALO;
  out[3] = ROWS;
  out[4] = COLS;
  out[5] = CK;
  return 0;
}

}  // extern "C"
