// Tensor-core helpers shared by the port's Hopper kernels that include it
// (csrc/fused_tail_stage.cu, csrc/fused_mrf_stage.cu): mma.sync in bf16 and in TF32,
// the 3xTF32 split of fp32 operands with its flushed accumulators, ldmatrix, and the
// fp32 to bf16x2 conversion. All of it is sm_80+ PTX; the kernels are built for sm_90a.
//
// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k16" / "mma.m16n8k8"), lane l,
// g = l / 4, t = l % 4:
//   bf16 m16n8k16: A a0 (g, 2t..2t+1), a1 (g+8, ..), a2 (g, 2t+8..), a3 (g+8, 2t+8..);
//                  B b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   tf32 m16n8k8:  A a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
//                  B b0 (k t, n g), b1 (k t+4, n g)
//   both:          C/D c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1), fp32

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 blocks of 16-bit elements (or 8 x 4 of 32-bit ones), each lane giving the
// address of one block's row (16 bytes): lanes 0-7 block 0, 8-15 block 1, ...; lane l
// receives 32 bits (l % 4) of row l / 4 of each block
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the same, each 8 x 8 block of 16-bit elements transposed: lane l receives elements
// (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) of each block
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
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

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two fp32 values as one register of two bf16 (lo in the low half), rounded to nearest
// even: exact for values that are bf16 already
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

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

// 3xTF32: the products a * b from the operands' pieces, each order of size in its own
// accumulator, part[0] += a0 b0 and part[1] += a1 b0 + a0 b1; each product within
// ~5 * 2^-22 of exact with rounded pieces. The tensor cores add into an accumulator
// rounding toward zero, so a long run of MMAs into one accumulator drifts (by up to
// ~1e-5 relative over a conv's 44 steps, enough to flip the sign of an activation near
// a leaky kink); `flush` adds the parts into the running sum in fp32 (round to
// nearest) after a few steps and clears them.
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

}  // namespace mma_sm90
