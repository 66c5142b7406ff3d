// The warp-level tensor-core and asynchronous-copy primitives the port's
// CUDA kernels share (sm_80 instructions, on sm_90a): mma.sync m16n8k16
// bf16 x bf16 -> f32, ldmatrix (plain and transposed), cp.async with its
// commit and wait groups, and named barriers.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..),
//                           a[2] = (g, 2t+8..), a[3] = (g + 8, 2t+8..)
//   B (16 x 8, k x n):      b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8.., n g)
//   C (16 x 8, f32):        c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8, ..)
// so two neighbouring C tiles (columns 0-7 and 8-15) hold exactly the
// elements of one A fragment over those 16 columns (FA-2's reuse of a
// product's result as the next product's left operand, in registers).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace paddle_tpu_torch {

// c += a b: one m16n8k16 bf16 product with f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared without registers; zeros when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}
// 4 bytes global -> shared; zeros when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Named barrier ``id`` (1-15; 0 is __syncthreads') over ``n`` threads,
// whole warps: the warps of one team of a block meet without the rest
__device__ __forceinline__ void named_barrier_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Four 8x8 b16 matrices (or 8x4 b32) from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix4_trans(uint32_t (&r)[4],
                                                const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Two f32 as one bf16x2 register (round to nearest even), ``lo`` in the
// low half: the element of the lower column of an A or B fragment pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two signed int8 codes of ``v`` (bytes i and j) as one bf16x2 register,
// byte i in the low half; exact (|q| <= 128 fits bf16's 8 bits). Each
// byte, its sign bit flipped, goes into the mantissa of 2^23 and leaves
// as f32 less 2^23 + 128 (byte_perm and an add, no integer conversion).
__device__ __forceinline__ uint32_t s8x2_bf16(uint32_t v, int i, int j) {
  const uint32_t u = v ^ 0x80808080u;
  const float lo =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - 8388736.f;
  return pack_bf16(lo, hi);
}

// Two signed int4 codes of ``v`` as one bf16x2 register: the nibbles at
// bits [s, s + 4) (low half) and [s + 16, s + 20); exact. Each nibble n,
// its sign bit flipped, goes into the mantissa of bf16 128 (0x4300 |
// (n ^ 8) is 136 + n), and 136 is taken off in bf16.
__device__ __forceinline__ uint32_t s4x2_bf16(uint32_t v, int s) {
  const uint32_t b = ((v >> s) & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&b);
  x = __hsub2(x, __float2bfloat162_rn(136.f));
  return *reinterpret_cast<const uint32_t*>(&x);
}

// c0 += a b[0..1], c1 += a b[2..3]: the two n8 tiles of one x4 B load
__device__ __forceinline__ void mma2(float (&c0)[4], float (&c1)[4],
                                     const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
  mma_bf16(c0, a, b0);
  mma_bf16(c1, a, b1);
}

// c0 += a b[0..1], c1 += a b[2..3] as products summed from zero and then
// added in f32 (round to nearest): the tensor core aligns its sum to the
// accumulator's magnitude and truncates, and dS = P (dP - delta) cancels
// on rows that see few keys, so dP takes its k-steps' partial sums this
// way to stay as close to an f32 dot as the plain version's (flash
// attention; the block kernels' row-tile products take each k-chunk so).
__device__ __forceinline__ void mma2_rn(float (&c0)[4], float (&c1)[4],
                                        const uint32_t (&a)[4],
                                        const uint32_t (&b)[4]) {
  float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
  mma2(t0, t1, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    c0[e] += t0[e];
    c1[e] += t1[e];
  }
}

// The A fragment over the 16 columns of C tiles c0, c1 in bf16
__device__ __forceinline__ void a_frag(const float (&c0)[4],
                                       const float (&c1)[4],
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The same for an f32 P, split: hi = bf16(P), lo = bf16(P - hi) (the
// difference is exact in f32); hi + lo holds P to 2^-16 of itself, so two
// bf16 products into one f32 sum take the f32 P as the JAX kernel does.
__device__ __forceinline__ void a_frag_split(const float (&c0)[4],
                                             const float (&c1)[4],
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  const float e[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 hv = __floats2bfloat162_rn(e[2 * j], e[2 * j + 1]);
    hi[j] = *reinterpret_cast<const uint32_t*>(&hv);
    lo[j] = pack_bf16(e[2 * j] - __low2float(hv),
                      e[2 * j + 1] - __high2float(hv));
  }
}

}  // namespace paddle_tpu_torch
