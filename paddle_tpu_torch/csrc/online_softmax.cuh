// The page-streaming attention reduction shared by the port's attention
// kernels: port of paddle_tpu/ops/pallas/_util.py's
// online_softmax_page_update and clamped_page_index, and the prefill
// kernel's fold of a chunk's own K/V under its causal mask.
//
// The JAX package keeps these helpers single-definition so that the
// unfused paged-decode kernel and the fused decode-block kernel reduce
// identically, op for op (their bit-parity contract). This header is the
// port's one definition of them: every CUDA kernel that streams KV pages
// through an online softmax includes it, and the page update and the
// chunk fold are one masked update with two masks.
//
// Layout contract (all pointers into shared memory, all f32 except K/V):
//   q      [groups][hd]  the query rows of one KV head, already f32
//   k, v   [bs][hd]      one page of one KV head, in the pool's type: the
//                        model's (f32, bf16), or int8 with the head's f32
//                        scales ks, vs (the int8 KV cache: each element is
//                        dequantized, float(q) * s, before its product, as
//                        the JAX kernels' quant bodies do)
//   s      [groups][bs]  scratch; holds the page's probabilities on return
//   m, l   [groups]      running max and running sum of the softmax
//   alpha  [groups]      scratch (rescale factor of this page)
//   acc    [groups][hd]  running, unnormalised output
// Every thread of the block (or of the team it is given) must call it (it
// synchronises them). The caller synchronises before it overwrites k or v
// afterwards.
#pragma once

#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace paddle_tpu_torch {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One element of a staged K or V tile as f32: the model's types read as
// they are (the scale is not touched); an int8 pool's code times its
// head's scale, rounded on its own (the JAX kernels' k * scale, before any
// product).
__device__ __forceinline__ float kv_float(float x, float) { return x; }
__device__ __forceinline__ float kv_float(__nv_bfloat16 x, float) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float kv_float(int8_t x, float s) {
  return __fmul_rn(static_cast<float>(x), s);
}

// x as an int8 pool stores it and reads it back: clip(round(x / s), -127,
// 127) * s in f32, with IEEE division and half-to-even rounding (the
// quantizer of the port's pool writes, torch.round, and of the JAX
// kernels, jnp.round). The attention kernels fold the new token in
// through it, so they see what the unfused step reads from the pool.
__device__ __forceinline__ float kv_round_trip(float x, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
  return __fmul_rn(q, s);
}

// The threads that run one online-softmax update together: the whole
// block (BlockTeam), or a team of whole warps of it with its own named
// barrier (WarpTeam: the single-launch kernel's attention runs two items
// at once, one a team). A team's result does not depend on its size: each
// score is one warp's sum, each row's max and sum one warp's, each output
// element one thread's sum over the tile's keys in order.
struct BlockTeam {
  __device__ __forceinline__ int tid() const { return threadIdx.x; }
  __device__ __forceinline__ int size() const { return blockDim.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

struct WarpTeam {
  int t, n, id;   // this thread's index in the team, its threads, and its
                  // barrier (1-15; 0 is __syncthreads')
  __device__ __forceinline__ int tid() const { return t; }
  __device__ __forceinline__ int size() const { return n; }
  __device__ __forceinline__ void sync() const { named_barrier_sync(id, n); }
};

// Logical page ``pg`` of a sequence of ``seq_len`` tokens, clamped to its
// last live page, so a fetch never reads a block-table entry past it
// (entries there are padding or belong to nobody).
__device__ __forceinline__ int clamped_page_index(int seq_len, int bs,
                                                  int pg) {
  int last = max(seq_len - 1, 0) / bs;
  return min(pg, last);
}

// The online-softmax update of one staged tile of ``bs`` keys for
// ``groups`` query rows (see the layout contract above); ``seen(g, t)``
// says whether row g sees key t. A row that sees no key of the tile keeps
// its state (alpha 1, nothing added), even before its first key. ``ks``
// and ``vs`` scale an int8 tile (kv_float) and are not read otherwise.
template <typename T, typename Seen, typename Team = BlockTeam>
__device__ __forceinline__ void online_softmax_masked_update(
    const float* q, const T* k, const T* v, int bs, Seen seen, float scale,
    int groups, int hd, float* s, float* m, float* l, float* alpha,
    float* acc, float ks, float vs, Team team = Team()) {
  const int tid = team.tid();
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = team.size() >> 5;

  // scores: one warp per (query row, token), lanes split head_dim; a warp
  // takes two of them at a time (each summed as alone, the two chains
  // interleaved)
  const int n = groups * bs;
  for (int idx = warp; idx < n; idx += 2 * nwarps) {
    const int idx2 = idx + nwarps;
    const bool two = idx2 < n;   // warp-uniform
    const int g = idx / bs, t = idx - g * bs;
    const int g2 = two ? idx2 / bs : g, t2 = two ? idx2 - g2 * bs : t;
    float dot = 0.f, dot2 = 0.f;
    for (int d = lane; d < hd; d += 32) {
      dot += q[g * hd + d] * kv_float(k[t * hd + d], ks);
      dot2 += q[g2 * hd + d] * kv_float(k[t2 * hd + d], ks);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
      dot2 += __shfl_xor_sync(0xffffffffu, dot2, off);
    }
    if (lane == 0) {
      s[idx] = seen(g, t) ? dot * scale : -CUDART_INF_F;
      if (two) s[idx2] = seen(g2, t2) ? dot2 * scale : -CUDART_INF_F;
    }
  }
  team.sync();

  // running max / sum: one warp per query row, lanes over the tokens,
  // reduced across the warp in a fixed order
  for (int g = warp; g < groups; g += nwarps) {
    float* sg = s + g * bs;
    const float m_prev = m[g];
    float mx = -CUDART_INF_F;
    for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < bs; t += 32) {
      const float p = seen(g, t) ? expf(sg[t] - m_new) : 0.f;
      sg[t] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      // 0 on a row's first keys (m_prev -inf); 1 while it has seen none
      const float a = m_new == -CUDART_INF_F ? 1.f : expf(m_prev - m_new);
      l[g] = a * l[g] + sum;
      alpha[g] = a;
      m[g] = m_new;
    }
  }
  team.sync();

  // acc = alpha * acc + p @ v, one output element per thread
  for (int i = tid; i < groups * hd; i += team.size()) {
    const int g = i / hd;
    const int d = i - g * hd;
    const float* pg_row = s + g * bs;
    float a = acc[i] * alpha[g];
#pragma unroll 4
    for (int t = 0; t < bs; ++t)
      a += pg_row[t] * kv_float(v[t * hd + d], vs);
    acc[i] = a;
  }
}

// One KV page's online-softmax update (see the layout contract above).
// Tokens at or after ``seq_len`` are masked out; callers only pass pages
// that hold at least one live token. T is the pool's type; an int8 page
// is dequantized with its head's scales ``ks`` and ``vs``.
template <typename T, typename Team = BlockTeam>
__device__ __forceinline__ void online_softmax_page_update(
    const float* q, const T* k, const T* v, int pg, int bs, int seq_len,
    float scale, int groups, int hd, float* s, float* m, float* l,
    float* alpha, float* acc, float ks = 1.f, float vs = 1.f,
    Team team = Team()) {
  online_softmax_masked_update<T>(
      q, k, v, bs, [=](int, int t) { return pg * bs + t < seq_len; }, scale,
      groups, hd, s, m, l, alpha, acc, ks, vs, team);
}

// One tile of a prefill chunk's own K/V folded into the online softmax
// under the in-chunk causal mask (the prefill counterpart of the page
// update; same layout contract, ``groups`` query rows). Query row g sits
// at chunk position q0 + g % bq (rows are [heads][bq]); key t of the tile
// is chunk position c0 + t and row g sees it iff c0 + t <= min(q0 + g %
// bq, c_last). ``c_last`` is the last real row of the chunk: pad rows see
// only real keys, so their state stays finite.
template <typename T>
__device__ __forceinline__ void online_softmax_chunk_update(
    const float* q, const T* k, const T* v, int c0, int bs, int q0, int bq,
    int c_last, float scale, int groups, int hd, float* s, float* m,
    float* l, float* alpha, float* acc) {
  online_softmax_masked_update<T>(
      q, k, v, bs,
      [=](int g, int t) { return c0 + t <= min(q0 + g % bq, c_last); },
      scale, groups, hd, s, m, l, alpha, acc, 1.f, 1.f);
}

}  // namespace paddle_tpu_torch
