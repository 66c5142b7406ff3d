// Fused lm-head + cross entropy for Hopper (sm_90a): the forward and the
// two backward passes, each a kernel of its own.
//
// Replaces paddle_tpu/ops/pallas/fused_train.py's three Pallas kernels:
//   linear_ce_fwd     _ce_fwd_kernel  (launch in _ce_fwd_call)
//   linear_ce_bwd_dx  _ce_dx_kernel   (launch in _ce_bwd_call)
//   linear_ce_bwd_dh  _ce_dh_kernel   (launch in _ce_bwd_call)
// and the tile recomputation they share (_ce_tile).
//
//   x      [T, D]   f32 or bf16, contiguous (the flattened hidden states)
//   head   [D, V]   x's type, read by its two strides (sd, sv): the
//                   untied lm head is row-major, the tied one is the
//                   embedding [V, D] seen transposed (sd = 1); no copy
//   labels [T]      int64; a negative label is ignored
//   lse, pick [T]   f32: log-sum-exp of the row's logits and the logit at
//                   its label (0 where the label is ignored)
//   coef            one f32 on the device: g / max(count, 1)
//   dx [T, D], dh [D, V] (dh by the strides the caller gives)
//
// The logits S = x head are never stored whole. The forward streams
// (64-token x 128-vocab) tiles of S through an online log-sum-exp; each
// backward pass recomputes its tiles of S and forms
//   P = (exp(S - lse) - onehot(label)) * (label >= 0) * coef
// (_ce_tile), then dx = P head^T and dh = x^T P. Vocab columns >= V are
// masked to -inf (P = 0 there); token rows >= T are read as zeros with
// label -1 and never written.
//
// What bounds them on the H100: operations. At the training shape (T
// 4096, D 4096, V 32000, bf16) the forward is 1.07 TFLOP of products and
// each backward pass 2.15 TFLOP: 1.09 and 2.17 ms at the bf16 tensor-core
// peak (989 TFLOP/s), the P products at the TF32 peak (495) 3.26 ms.
//
// Precision. bf16 inputs: S from mma.sync m16n8k16 bf16 x bf16 with f32
// accumulators (exactly the JAX dot's products); the backward's P
// products (the JAX body multiplies P by the head cast to f32) by TF32
// mma.sync m16n8k8: P is rounded to TF32 (10 mantissa bits), x and the
// head are bf16 and exact in TF32, the sums f32. f32 inputs: every
// product on the CUDA cores in f32 FMAs (no TF32 anywhere), so the loss
// holds to 1e-5 of the plain f32 version. expf / logf are the accurate
// ones, not the __ intrinsics. Both paths share the accumulator layout of
// mma.sync's C fragment, so the epilogues are written once.
//
// Design. The TPU kernels carry the online (m, l, pick), the (bt, D) f32
// dx accumulator and the (D, bv) f32 dh accumulator across a sequential
// grid axis in VMEM (4 MB and 8 MB at its tiles). A Hopper block has 227
// KB of shared memory, and even a 64-row f32 dx tile at D = 4096 is 1 MB,
// so:
//   - forward: a block per (64-token tile, vocab split) walks its split's
//     vocab tiles with an online (m, l, pick) per row and writes them to
//     [3, splits, T] f32; a second kernel combines the splits in split
//     order (splits = 528 / token tiles: at T = 4096, 512 blocks, two
//     whole waves of two blocks per SM);
//   - dx: a block per (64-token tile, vocab split) owns the rows
//     [split][t0, t0 + 64) of an f32 partial buffer [splits, T, D] in
//     device memory that no other block touches: per vocab tile it
//     recomputes P into shared memory, then per 128-column chunk of D
//     adds P head^T to its rows (store at the split's first tile); a
//     second kernel sums the splits in order and casts to x's type
//     (splits = 264 / token tiles, one wave: 4 at the training shape,
//     268 MB of partials);
//   - dh: a block per 128-column vocab tile owns the columns of an f32
//     buffer [D, V] (524 MB at the training shape): per 128 tokens it
//     recomputes P (two logit tiles) into shared memory, then per
//     64-row chunk of D adds x^T P to its columns; a cast kernel writes
//     dh in the head's layout.
// Every kernel fits two blocks on an SM (at most 128 registers a thread;
// 34, 103 and 106 KB of shared memory), so that one block's loads overlap
// the other's products.
// No atomics anywhere: every sum runs in a fixed order, so two launches
// give the same bits. The accumulators' read-modify-write through device
// memory (dx ~32 GB, dh ~33 GB of traffic at the training shape) is the
// price of not splitting D, which would recompute the logits D / chunk
// times; a thread-block cluster holding them in distributed shared memory
// is later work, as are wgmma and TMA.
//
// Two routes through each kernel. The fast one (bf16, D % 8 == 0, V % 8
// == 0, 16-byte aligned rows, an n-contiguous head: the untied lm head):
// every bf16 operand tile is copied by cp.async, 16 bytes a thread, into
// one of two stages while the tensor cores work on the other, and its
// fragments come from ldmatrix; the P products permute k inside each
// step of 8 on both operands so that each TF32 fragment register is one
// load (see dx_product). The generic one (f32, a ragged V, unaligned rows,
// the tied head): plain element loads and scalar fragment loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_sync.cuh"
#include "online_softmax.cuh"

namespace paddle_tpu_torch {
namespace linear_ce {

constexpr int kThreads = 256;   // 8 warps: 2 (rows) x 4 (columns)
constexpr int kBT = 64;         // tokens of a logit tile
constexpr int kBV = 128;        // vocab columns of a logit tile
constexpr int kBK = 32;         // depth of one staged operand slice
constexpr int kBD = 128;        // columns of D one backward product covers
constexpr int kDhT = 128;       // tokens one dh product folds in
constexpr int kBDh = 64;        // rows of D one dh product covers
constexpr int kLdS = kBV + 4;   // forward logit tile row stride
constexpr int kLdH = kBV + 4;   // dx: the head chunk [d][v]
constexpr int kLdPh = kBV + 8;  // dh: P as the B operand, conflict-free
constexpr int kLdX = kBDh + 8;  // dh: the x chunk [t][d]

// Row strides of the logit product's staged operands: 40 bf16 (80 bytes)
// keep the 32-bit fragment loads of 8 rows on distinct banks; 33 f32 do
// the same for the FMA path.
template <typename T> struct Ld;
template <> struct Ld<__nv_bfloat16> { static constexpr int v = kBK + 8; };
template <> struct Ld<float> { static constexpr int v = kBK + 1; };

template <typename T>
__host__ __device__ constexpr int operand_bytes() {
  return (kBT + kBV) * Ld<T>::v * static_cast<int>(sizeof(T));
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Where a thread's accumulators sit: mma.sync's C fragment. Warp (wm, wn)
// owns rows wm * (MI * 16) .. and columns wn * 32 ..; acc[mi][ni][r] is
// row wm*MI*16 + mi*16 + g + 8*(r >> 1), column wn*32 + ni*8 + 2*t4 +
// (r & 1).
struct Frag {
  int wm, wn, g, t4;
};
__device__ __forceinline__ Frag frag() {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return {warp >> 2, warp & 3, lane >> 2, lane & 3};
}
template <int MI>
__device__ __forceinline__ int frag_row(const Frag& f, int mi, int r) {
  return f.wm * MI * 16 + mi * 16 + f.g + 8 * (r >> 1);
}
__device__ __forceinline__ int frag_col(const Frag& f, int ni, int r) {
  return f.wn * 32 + ni * 8 + 2 * f.t4 + (r & 1);
}
template <int MI>
__device__ __forceinline__ void zero(float (&acc)[MI][4][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// The logit tile S[t0 .. t0+64, v0 .. v0+128) = x head, f32 accumulators
// ---------------------------------------------------------------------------
// Fast path (bf16, D % 8 == 0, 16-byte aligned rows): each depth slice
// of x and of the head is copied with cp.async, 16 bytes a thread, into
// one of two stages while the tensor cores work on the other; fragments
// come from ldmatrix. xs[row][k] (row stride 40: the 8 rows of an
// ldmatrix phase fall on distinct banks); the n-contiguous head as
// hs[k][n] (row stride 136), read transposed by ldmatrix.trans.
constexpr int kLdXs = kBK + 8;
constexpr int kLdHn = kBV + 8;
constexpr int kXsBytes = kBT * kLdXs * 2;
constexpr int kHsBytes = kBK * kLdHn * 2;
constexpr int kFastOperandBytes = 2 * (kXsBytes + kHsBytes);

__device__ __forceinline__ void fast_stage(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ head,
    long long sd, int Tn, int D, int V, int t0, int v0, int k0,
    __nv_bfloat16* xs, __nv_bfloat16* hs) {
  const int tid = threadIdx.x;
  {
    const int r = tid >> 2, c = (tid & 3) * 8;
    const bool ok = t0 + r < Tn && k0 + c < D;
    cp_async16(xs + r * kLdXs + c,
               ok ? x + static_cast<long long>(t0 + r) * D + k0 + c : x, ok);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + j * kThreads;
    const int k = i >> 4, c = (i & 15) * 8;
    const bool ok = k0 + k < D && v0 + c < V;
    cp_async16(hs + k * kLdHn + c, ok ? head + (k0 + k) * sd + (v0 + c) : head,
               ok);
  }
}

__device__ __forceinline__ void fast_slice_product(const __nv_bfloat16* xs,
                                                   const __nv_bfloat16* hs,
                                                   float (&acc)[2][4][4],
                                                   const Frag& f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix4(a[mi], xs + (f.wm * 32 + mi * 16 + (lane & 15)) * kLdXs +
                           kk + (lane >> 4) * 8);
#pragma unroll
    for (int ni = 0; ni < 4; ni += 2) {
      uint32_t r[4];
      ldmatrix4_trans(r, hs + (kk + (lane & 15)) * kLdHn + f.wn * 32 + ni * 8 +
                             (lane >> 4) * 8);
      b[ni][0] = r[0];
      b[ni][1] = r[1];
      b[ni + 1][0] = r[2];
      b[ni + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
  }
}

// Generic path (f32, or rows that are not 16-byte aligned): plain loads.
// One depth slice [k0, k0 + kBK) of both operands into shared memory:
// xs[row][k] and hs[n][k] (the head transposed, so a fragment's two
// consecutive k are one 32-bit word). Out-of-range elements are zeros.
template <typename T>
__device__ void stage_slice(const T* __restrict__ x, const T* __restrict__ head,
                            long long sd, long long sv, bool head_kmajor,
                            int Tn, int D, int V, int t0, int v0, int k0,
                            T* xs, T* hs) {
  constexpr int ld = Ld<T>::v;
  for (int i = threadIdx.x; i < kBT * kBK; i += kThreads) {
    const int r = i / kBK, k = i % kBK;
    const int t = t0 + r, d = k0 + k;
    xs[r * ld + k] = (t < Tn && d < D) ? x[static_cast<long long>(t) * D + d]
                                       : from_float<T>(0.f);
  }
  for (int i = threadIdx.x; i < kBV * kBK; i += kThreads) {
    int n, k;   // neighbouring threads on neighbouring addresses of head
    if (head_kmajor) {
      n = i / kBK;
      k = i % kBK;
    } else {
      k = i / kBV;
      n = i % kBV;
    }
    const int v = v0 + n, d = k0 + k;
    hs[n * ld + k] = (v < V && d < D) ? head[d * sd + v * sv]
                                      : from_float<T>(0.f);
  }
}

// acc += xs hs^T over one slice: bf16 on the tensor cores ...
__device__ __forceinline__ void slice_product(const __nv_bfloat16* xs,
                                              const __nv_bfloat16* hs,
                                              float (&acc)[2][4][4],
                                              const Frag& f) {
  constexpr int ld = Ld<__nv_bfloat16>::v;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const __nv_bfloat16* p = xs + (f.wm * 32 + mi * 16 + f.g) * ld + kk +
                               2 * f.t4;
      a[mi][0] = ld32(p);
      a[mi][1] = ld32(p + 8 * ld);
      a[mi][2] = ld32(p + 8);
      a[mi][3] = ld32(p + 8 * ld + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const __nv_bfloat16* q = hs + (f.wn * 32 + ni * 8 + f.g) * ld + kk +
                               2 * f.t4;
      b[ni][0] = ld32(q);
      b[ni][1] = ld32(q + 8);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
  }
}

// ... f32 on the CUDA cores, same accumulator layout
__device__ __forceinline__ void slice_product(const float* xs, const float* hs,
                                              float (&acc)[2][4][4],
                                              const Frag& f) {
  constexpr int ld = Ld<float>::v;
  for (int k = 0; k < kBK; ++k) {
    float a[2][2], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[mi][h] = xs[(f.wm * 32 + mi * 16 + f.g + 8 * h) * ld + k];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        b[ni][j] = hs[(f.wn * 32 + ni * 8 + 2 * f.t4 + j) * ld + k];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[mi][ni][r] = fmaf(a[mi][r >> 1], b[ni][r & 1], acc[mi][ni][r]);
  }
}

// The whole logit tile. Every thread calls it; it synchronises the block
// before it stages anything and after its last product, so the caller may
// overwrite ``ops`` (the staging area) once it returns.
template <typename T, bool FAST>
__device__ void logit_tile(const T* __restrict__ x, const T* __restrict__ head,
                           long long sd, long long sv, bool head_kmajor,
                           int Tn, int D, int V, int t0, int v0,
                           unsigned char* ops, float (&acc)[2][4][4],
                           const Frag& f) {
  zero(acc);
  __syncthreads();
  if constexpr (FAST) {
    auto* xs = reinterpret_cast<__nv_bfloat16*>(ops);
    auto* hs = reinterpret_cast<__nv_bfloat16*>(ops + 2 * kXsBytes);
    constexpr int hstage = kHsBytes / 2;
    const int nk = (D + kBK - 1) / kBK;
    fast_stage(x, head, sd, Tn, D, V, t0, v0, 0, xs, hs);
    cp_async_commit();
    for (int ks = 0; ks < nk; ++ks) {
      const int cur = ks & 1, nxt = cur ^ 1;
      if (ks + 1 < nk)
        fast_stage(x, head, sd, Tn, D, V, t0, v0, (ks + 1) * kBK,
                   xs + nxt * kBT * kLdXs, hs + nxt * hstage);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
      fast_slice_product(xs + cur * kBT * kLdXs, hs + cur * hstage, acc, f);
      __syncthreads();
    }
  } else {
    T* xs = reinterpret_cast<T*>(ops);
    T* hs = xs + kBT * Ld<T>::v;
    for (int k0 = 0; k0 < D; k0 += kBK) {
      stage_slice<T>(x, head, sd, sv, head_kmajor, Tn, D, V, t0, v0, k0, xs,
                     hs);
      __syncthreads();
      slice_product(xs, hs, acc, f);
      __syncthreads();
    }
  }
}

// _ce_tile's P from a logit tile in registers: (exp(s - lse) - onehot) *
// (valid * coef); columns >= V and rows whose label is negative give 0.
// Written to ps[row * ldp + col] or, TRANS, ps[col * ldp + row]; rounded
// to TF32 (RNA) when the products that read it run on TF32 tensor cores
// (TC), so they read it exactly as rounded once.
template <bool TC, bool TRANS>
__device__ __forceinline__ void p_tile(const float (&acc)[2][4][4],
                                       const Frag& f, int v0, int V,
                                       const float* lse_s,
                                       const long long* lab_s, float coef,
                                       float* ps, int ldp) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = frag_row<2>(f, mi, r), col = frag_col(f, ni, r);
        const long long v = v0 + col, lb = lab_s[row];
        float p = 0.f;
        if (v < V) {
          const float e = expf(acc[mi][ni][r] - lse_s[row]);
          p = (e - (v == lb ? 1.f : 0.f)) * (lb >= 0 ? coef : 0.f);
        }
        if (TC) p = __uint_as_float(tf32(p));
        ps[TRANS ? col * ldp + row : row * ldp + col] = p;
      }
}

// The backward products on TF32 tensor cores, fast route. Inside each
// step of 8, k is permuted (the mma's k = t is the tile's 2t, its t + 4 the
// tile's 2t + 1) on both operands, which leaves the sum as it is and lets
// every fragment register come from one load: two neighbouring f32 of P
// in one 8-byte load, two neighbouring bf16 of the head or of x in one
// 32-bit word of an ldmatrix, widened exactly (bf16 is exact in TF32, and
// P was rounded to TF32 when it was written). Rows of f32 tiles are 136
// words apart, of bf16 tiles 272 bytes: conflict-free for both loads.
constexpr int kLdF = 136;   // f32 tiles read by the fast products
constexpr int kLdB = 136;   // bf16 tiles read by ldmatrix
__device__ __forceinline__ void widen(uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo = w << 16;
  hi = w & 0xffff0000u;
}

// dx: C[t][d] += sum_v P[t][v] head[d][v]; ps [64 t][kLdF] f32, hb
// [128 d][kLdB] bf16 (one chunk of D, the tile's 128 vocab columns)
__device__ __forceinline__ void dx_product(const float* ps,
                                           const __nv_bfloat16* hb,
                                           float (&acc)[2][4][4],
                                           const Frag& f) {
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int kk = 0; kk < kBV; kk += 16) {
    uint32_t a[2][2][4], b[2][4][2];   // [k step][tile][register]
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* p =
            ps + (f.wm * 32 + mi * 16 + f.g) * kLdF + kk + st * 8 + 2 * f.t4;
        const float2 lo = *reinterpret_cast<const float2*>(p);
        const float2 hi = *reinterpret_cast<const float2*>(p + 8 * kLdF);
        a[st][mi][0] = __float_as_uint(lo.x);
        a[st][mi][2] = __float_as_uint(lo.y);
        a[st][mi][1] = __float_as_uint(hi.x);
        a[st][mi][3] = __float_as_uint(hi.y);
      }
#pragma unroll
    for (int ni = 0; ni < 4; ni += 2) {
      uint32_t r[4];
      ldmatrix4(r, hb + (f.wn * 32 + ni * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                            kLdB +
                       kk + ((lane >> 3) & 1) * 8);
      widen(r[0], b[0][ni][0], b[0][ni][1]);
      widen(r[1], b[1][ni][0], b[1][ni][1]);
      widen(r[2], b[0][ni + 1][0], b[0][ni + 1][1]);
      widen(r[3], b[1][ni + 1][0], b[1][ni + 1][1]);
    }
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_tf32(acc[mi][ni], a[st][mi], b[st][ni]);
  }
}

// dh: C[d][v] += sum_t x[t][d] P[t][v]; xb [128 t][kLdXb] bf16 (one
// 64-column chunk of D), pt = P^T [128 v][kLdF] f32
constexpr int kLdXb = kBDh + 8;   // 144 bytes: conflict-free for ldmatrix
__device__ __forceinline__ void dh_product(const __nv_bfloat16* xb,
                                           const float* pt,
                                           float (&acc)[2][4][4],
                                           const Frag& f) {
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int kk = 0; kk < kDhT; kk += 16) {
    uint32_t a[2][2][4], b[2][4][2];   // [k step][tile][register]
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      uint32_t r[4];
      ldmatrix4_trans(r, xb + (kk + (lane & 7) + ((lane >> 4) << 3)) * kLdXb +
                             f.wm * 32 + mi * 16 + ((lane >> 3) & 1) * 8);
      widen(r[0], a[0][mi][0], a[0][mi][2]);
      widen(r[1], a[0][mi][1], a[0][mi][3]);
      widen(r[2], a[1][mi][0], a[1][mi][2]);
      widen(r[3], a[1][mi][1], a[1][mi][3]);
    }
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float2 v2 = *reinterpret_cast<const float2*>(
            pt + (f.wn * 32 + ni * 8 + f.g) * kLdF + kk + st * 8 + 2 * f.t4);
        b[st][ni][0] = __float_as_uint(v2.x);
        b[st][ni][1] = __float_as_uint(v2.y);
      }
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_tf32(acc[mi][ni], a[st][mi], b[st][ni]);
  }
}

// One 128 x COLS bf16 tile (rows r0.., columns c0.., row stride ``ld``
// elements in global memory) into dst [128][COLS + 8] by cp.async; rows
// >= nr or columns >= nc are zeros (nc % 8 == 0)
template <int COLS>
__device__ __forceinline__ void stage_bf16_tile(const __nv_bfloat16* src,
                                                long long ld, int r0, int nr,
                                                int c0, int nc,
                                                __nv_bfloat16* dst) {
  constexpr int kChunks = COLS / 8;
#pragma unroll
  for (int j = 0; j < 128 * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int rr = i / kChunks, c8 = (i % kChunks) * 8;
    const bool ok = r0 + rr < nr && c0 + c8 < nc;
    cp_async16(dst + rr * (COLS + 8) + c8,
               ok ? src + (r0 + rr) * ld + c0 + c8 : src, ok);
  }
}

// ---------------------------------------------------------------------------
// C[M][128] += A[M][K] B[K][128] from f32 shared memory, A(m, k) =
// as[m * a_m + k * a_k], B(k, n) = bs[k * b_k + n * b_n]; M = MI * 32.
// TF32 tensor cores (TC) or f32 FMAs, the same accumulator layout.
// ---------------------------------------------------------------------------
template <bool TC, int MI>
__device__ __forceinline__ void smem_product(const float* as, int a_m, int a_k,
                                             const float* bs, int b_k, int b_n,
                                             int K, float (&acc)[MI][4][4],
                                             const Frag& f) {
  const int m0 = f.wm * MI * 16, n0 = f.wn * 32;
  if constexpr (TC) {
    for (int kk = 0; kk < K; kk += 8) {
      uint32_t a[MI][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int m = m0 + mi * 16 + f.g, k = kk + f.t4;
        a[mi][0] = tf32(as[m * a_m + k * a_k]);
        a[mi][1] = tf32(as[(m + 8) * a_m + k * a_k]);
        a[mi][2] = tf32(as[m * a_m + (k + 4) * a_k]);
        a[mi][3] = tf32(as[(m + 8) * a_m + (k + 4) * a_k]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + ni * 8 + f.g, k = kk + f.t4;
        b[ni][0] = tf32(bs[k * b_k + n * b_n]);
        b[ni][1] = tf32(bs[(k + 4) * b_k + n * b_n]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], a[mi], b[ni]);
    }
  } else {
    for (int k = 0; k < K; ++k) {
      float a[MI][2], b[4][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[mi][h] = as[(m0 + mi * 16 + f.g + 8 * h) * a_m + k * a_k];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          b[ni][j] = bs[k * b_k + (n0 + ni * 8 + 2 * f.t4 + j) * b_n];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[mi][ni][r] =
                fmaf(a[mi][r >> 1], b[ni][r & 1], acc[mi][ni][r]);
    }
  }
}

// ---------------------------------------------------------------------------
// linear_ce_fwd
// ---------------------------------------------------------------------------
constexpr int kOperandSmem =
    cmax(cmax(operand_bytes<float>(), operand_bytes<__nv_bfloat16>()),
         kFastOperandBytes);
constexpr int kFwdSmem = cmax(kBT * kLdS * 4, kOperandSmem);

// part: [3][splits][T] f32 -- m, l and pick of each (split, token)
template <typename T, bool FAST>
__global__ void __launch_bounds__(kThreads, 2)
    ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ head,
                  long long sd, long long sv, int head_kmajor,
                  const long long* __restrict__ labels, int Tn, int D, int V,
                  int tiles_per_split, float* __restrict__ part) {
  __shared__ __align__(16) unsigned char smem[kFwdSmem];
  float* ss = reinterpret_cast<float*>(smem);   // the tile, after its product
  const Frag f = frag();
  const int t0 = blockIdx.x * kBT, split = blockIdx.y, splits = gridDim.y;
  const int nvt = (V + kBV - 1) / kBV;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(vt0 + tiles_per_split, nvt);
  // four neighbouring lanes share a row; lane q takes columns q, q+4, ...
  const int row = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int t = t0 + row;
  const long long label = t < Tn ? labels[t] : -1;
  float m = -CUDART_INF_F, l = 0.f, pick = 0.f;
  float acc[2][4][4];
  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * kBV;
    logit_tile<T, FAST>(x, head, sd, sv, head_kmajor, Tn, D, V, t0, v0,
                            smem, acc, f);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int rr = frag_row<2>(f, mi, r), cc = frag_col(f, ni, r);
          ss[rr * kLdS + cc] = v0 + cc < V ? acc[mi][ni][r] : -CUDART_INF_F;
        }
    __syncthreads();
    const float* srow = ss + row * kLdS;
    float mt = -CUDART_INF_F;
    for (int c = q; c < kBV; c += 4) mt = fmaxf(mt, srow[c]);
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);      // finite: column v0 < V
    float sum = 0.f, pk = 0.f;
    for (int c = q; c < kBV; c += 4) {
      const float s = srow[c];
      sum += expf(s - m_new);
      if (v0 + c == label) pk += s;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    pk += __shfl_xor_sync(0xffffffffu, pk, 1);
    pk += __shfl_xor_sync(0xffffffffu, pk, 2);
    l = l * expf(m - m_new) + sum;
    m = m_new;
    pick += pk;
  }
  if (q == 0 && t < Tn) {
    part[static_cast<long long>(split) * Tn + t] = m;
    part[static_cast<long long>(splits + split) * Tn + t] = l;
    part[static_cast<long long>(2 * splits + split) * Tn + t] = pick;
  }
}

// lse = M + log(sum_s l_s exp(m_s - M)), pick = sum_s pick_s, in split
// order
__global__ void ce_fwd_combine(const float* __restrict__ part, int Tn,
                               int splits, float* __restrict__ lse,
                               float* __restrict__ pick) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tn) return;
  float M = -CUDART_INF_F;
  for (int s = 0; s < splits; ++s)
    M = fmaxf(M, part[static_cast<long long>(s) * Tn + t]);
  float L = 0.f, P = 0.f;
  for (int s = 0; s < splits; ++s) {
    L += part[static_cast<long long>(splits + s) * Tn + t] *
         expf(part[static_cast<long long>(s) * Tn + t] - M);
    P += part[static_cast<long long>(2 * splits + s) * Tn + t];
  }
  lse[t] = M + logf(L);
  pick[t] = P;
}

// out[r][c] (row stride ld) = C (first) or += C, for the tile's rows r0 +
// .. < nr and columns c0 + .. < nc; PAIRS: two neighbouring columns in one
// 8-byte access (ld and nc even)
template <bool PAIRS>
__device__ __forceinline__ void accumulate(const float (&c)[2][4][4],
                                           const Frag& f, float* out,
                                           long long ld, int r0, int nr,
                                           int c0, int nc, bool first) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + frag_row<2>(f, mi, 2 * h);
        const int col = c0 + frag_col(f, ni, 0);
        float* o = out + r * ld + col;
        const float x0 = c[mi][ni][2 * h], x1 = c[mi][ni][2 * h + 1];
        if (PAIRS) {
          if (r < nr && col < nc) {
            float2 v = first ? make_float2(0.f, 0.f)
                             : *reinterpret_cast<const float2*>(o);
            *reinterpret_cast<float2*>(o) = make_float2(v.x + x0, v.y + x1);
          }
        } else if (r < nr) {
          if (col < nc) o[0] = first ? x0 : o[0] + x0;
          if (col + 1 < nc) o[1] = first ? x1 : o[1] + x1;
        }
      }
}

// ---------------------------------------------------------------------------
// linear_ce_bwd_dx
// ---------------------------------------------------------------------------
constexpr int kDxSmem = kBT * kLdF * 4 + kBT * 4 + kBT * 8 +
                        cmax(kOperandSmem,
                             cmax(kBD * kLdH * 4, 2 * kBD * kLdB * 2));

// part: [splits][T][D] f32, rows [t0, t0 + 64) of slice ``split`` owned by
// this block alone
template <typename T, bool FAST>
__global__ void __launch_bounds__(kThreads, 2)
    ce_dx_kernel(const T* __restrict__ x, const T* __restrict__ head,
                 long long sd, long long sv, int head_kmajor,
                 const long long* __restrict__ labels,
                 const float* __restrict__ lse, const float* __restrict__ coef_p,
                 int Tn, int D, int V, int tiles_per_split,
                 float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ps = reinterpret_cast<float*>(smem);               // [kBT][kLdF]
  float* lse_s = ps + kBT * kLdF;                            // [kBT]
  long long* lab_s = reinterpret_cast<long long*>(lse_s + kBT);  // [kBT]
  unsigned char* ops = reinterpret_cast<unsigned char*>(lab_s + kBT);
  // after the logit product: the head chunk, as [kBD d][kLdH v] f32
  // (generic) or two cp.async stages of [kBD d][kLdB v] bf16 (fast)
  float* hc = reinterpret_cast<float*>(ops);
  auto* hb = reinterpret_cast<__nv_bfloat16*>(ops);
  constexpr bool kTC = sizeof(T) == 2;
  const Frag f = frag();
  const int t0 = blockIdx.x * kBT, split = blockIdx.y;
  const int nvt = (V + kBV - 1) / kBV;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(vt0 + tiles_per_split, nvt);
  const float coef = *coef_p;
  if (threadIdx.x < kBT) {
    const int t = t0 + threadIdx.x;
    lse_s[threadIdx.x] = t < Tn ? lse[t] : 0.f;
    lab_s[threadIdx.x] = t < Tn ? labels[t] : -1;
  }
  float* out = part + static_cast<long long>(split) * Tn * D;
  float acc[2][4][4];
  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * kBV;
    logit_tile<T, FAST>(x, head, sd, sv, head_kmajor, Tn, D, V, t0, v0,
                            ops, acc, f);
    p_tile<kTC, false>(acc, f, v0, V, lse_s, lab_s, coef, ps, kLdF);
    if constexpr (FAST) {
      __syncthreads();   // P written; the logit operands' readers done
      stage_bf16_tile<kBV>(reinterpret_cast<const __nv_bfloat16*>(head), sd, 0,
                           D, v0, V, hb);
      cp_async_commit();
    }
    for (int dc = 0, d0 = 0; d0 < D; ++dc, d0 += kBD) {
      float c[2][4][4];
      zero(c);
      // C[t][d] = sum_v P[t][v] head[d][v]
      if constexpr (FAST) {
        if (d0 + kBD < D)
          stage_bf16_tile<kBV>(reinterpret_cast<const __nv_bfloat16*>(head),
                               sd, d0 + kBD, D, v0, V,
                               hb + ((dc + 1) & 1) * kBD * kLdB);
        cp_async_commit();
        cp_async_wait1();
        __syncthreads();
        dx_product(ps, hb + (dc & 1) * kBD * kLdB, c, f);
      } else {
        __syncthreads();   // P written; the last chunk's readers done
        for (int i = threadIdx.x; i < kBD * kBV; i += kThreads) {
          int dd, n;
          if (head_kmajor) {
            n = i / kBD;
            dd = i % kBD;
          } else {
            dd = i / kBV;
            n = i % kBV;
          }
          const int d = d0 + dd, v = v0 + n;
          hc[dd * kLdH + n] =
              (d < D && v < V) ? to_float(head[d * sd + v * sv]) : 0.f;
        }
        __syncthreads();
        smem_product<kTC, 2>(ps, kLdF, 1, hc, 1, kLdH, kBV, c, f);
      }
      accumulate<FAST>(c, f, out, D, t0, Tn, d0, D, vt == vt0);
      if constexpr (FAST) __syncthreads();   // this stage's readers done
    }
  }
}

// ---------------------------------------------------------------------------
// linear_ce_bwd_dh
// ---------------------------------------------------------------------------
constexpr int kDhSmem = cmax(kDhT * kLdPh, kBV * kLdF) * 4 + kDhT * 4 +
                        kDhT * 8 +
                        cmax(kOperandSmem,
                             cmax(kDhT * kLdX * 4, 2 * kDhT * kLdXb * 2));

// acc: [D][V] f32, columns [v0, v0 + 128) owned by this block alone
template <typename T, bool FAST>
__global__ void __launch_bounds__(kThreads, 2)
    ce_dh_kernel(const T* __restrict__ x, const T* __restrict__ head,
                 long long sd, long long sv, int head_kmajor,
                 const long long* __restrict__ labels,
                 const float* __restrict__ lse, const float* __restrict__ coef_p,
                 int Tn, int D, int V, float* __restrict__ accum) {
  extern __shared__ __align__(16) unsigned char smem[];
  // P as [t][kLdPh] (generic) or P^T as [v][kLdF] (fast)
  float* ps = reinterpret_cast<float*>(smem);
  float* lse_s = ps + cmax(kDhT * kLdPh, kBV * kLdF);        // [kDhT]
  long long* lab_s = reinterpret_cast<long long*>(lse_s + kDhT);  // [kDhT]
  unsigned char* ops = reinterpret_cast<unsigned char*>(lab_s + kDhT);
  // after the logit products: the x chunk, as [t][kLdX] f32 (generic) or
  // two cp.async stages of [t][kLdB] bf16 (fast)
  float* xc = reinterpret_cast<float*>(ops);
  auto* xb = reinterpret_cast<__nv_bfloat16*>(ops);
  constexpr bool kTC = sizeof(T) == 2;
  const Frag f = frag();
  const int v0 = blockIdx.x * kBV;
  const float coef = *coef_p;
  float acc[2][4][4];
  for (int tg = 0; tg < Tn; tg += kDhT) {
    __syncthreads();     // the last group's readers of lse_s / lab_s done
    if (threadIdx.x < kDhT) {
      const int t = tg + threadIdx.x;
      lse_s[threadIdx.x] = t < Tn ? lse[t] : 0.f;
      lab_s[threadIdx.x] = t < Tn ? labels[t] : -1;
    }
    for (int sub = 0; sub < kDhT / kBT; ++sub) {
      logit_tile<T, FAST>(x, head, sd, sv, head_kmajor, Tn, D, V,
                              tg + sub * kBT, v0, ops, acc, f);
      if constexpr (FAST)
        p_tile<kTC, true>(acc, f, v0, V, lse_s + sub * kBT, lab_s + sub * kBT,
                          coef, ps + sub * kBT, kLdF);
      else
        p_tile<kTC, false>(acc, f, v0, V, lse_s + sub * kBT,
                           lab_s + sub * kBT, coef, ps + sub * kBT * kLdPh,
                           kLdPh);
    }
    if constexpr (FAST) {
      __syncthreads();   // P written; the logit operands' readers done
      stage_bf16_tile<kBDh>(reinterpret_cast<const __nv_bfloat16*>(x), D, tg,
                            Tn, 0, D, xb);
      cp_async_commit();
    }
    for (int dc = 0, d0 = 0; d0 < D; ++dc, d0 += kBDh) {
      float c[2][4][4];
      zero(c);
      // C[d][v] = sum_t x[t][d] P[t][v]
      if constexpr (FAST) {
        if (d0 + kBDh < D)
          stage_bf16_tile<kBDh>(reinterpret_cast<const __nv_bfloat16*>(x), D,
                                tg, Tn, d0 + kBDh, D,
                                xb + ((dc + 1) & 1) * kDhT * kLdXb);
        cp_async_commit();
        cp_async_wait1();
        __syncthreads();
        dh_product(xb + (dc & 1) * kDhT * kLdXb, ps, c, f);
      } else {
        __syncthreads();
        for (int i = threadIdx.x; i < kDhT * kBDh; i += kThreads) {
          const int tt = i / kBDh, dd = i % kBDh;
          const int t = tg + tt, d = d0 + dd;
          xc[tt * kLdX + dd] =
              (t < Tn && d < D)
                  ? to_float(x[static_cast<long long>(t) * D + d])
                  : 0.f;
        }
        __syncthreads();
        smem_product<kTC, 2>(xc, 1, kLdX, ps, kLdPh, 1, kDhT, c, f);
      }
      accumulate<FAST>(c, f, accum, V, d0, D, v0, V, tg == 0);
      if constexpr (FAST) __syncthreads();   // this stage's readers done
    }
  }
}

// out[r, c] (strides so_r, so_c) = sum over p of part[p][r][c], in p
// order, cast to T; walked in the output's contiguous order
template <typename T>
__global__ void sum_cast(const float* __restrict__ part, int parts, int rows,
                         int cols, T* __restrict__ out, long long so_r,
                         long long so_c, int col_major) {
  const long long n = static_cast<long long>(rows) * cols;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long r, c;
    if (col_major) {
      c = i / rows;
      r = i % rows;
    } else {
      r = i / cols;
      c = i % cols;
    }
    const long long src = r * cols + c;
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += part[p * n + src];
    out[r * so_r + c * so_c] = from_float<T>(s);
  }
}

template <typename T>
cudaError_t launch_sum_cast(const float* part, int parts, int rows, int cols,
                            void* out, long long so_r, long long so_c,
                            cudaStream_t st) {
  const long long n = static_cast<long long>(rows) * cols;
  if (n == 0) return cudaSuccess;
  const int blocks = static_cast<int>(
      n / kThreads + 1 < 132 * 16 ? n / kThreads + 1 : 132 * 16);
  sum_cast<T><<<blocks, kThreads, 0, st>>>(part, parts, rows, cols,
                                           static_cast<T*>(out), so_r, so_c,
                                           so_r == 1 && so_c != 1);
  return cudaGetLastError();
}

template <typename T, bool FAST>
cudaError_t fwd(const void* x, const void* head, long long sd, long long sv,
                const long long* labels, float* lse, float* pick, float* part,
                int Tn, int D, int V, int tiles_per_split, cudaStream_t st) {
  const int nvt = (V + kBV - 1) / kBV;
  const int splits = (nvt + tiles_per_split - 1) / tiles_per_split;
  dim3 grid((Tn + kBT - 1) / kBT, splits);
  ce_fwd_kernel<T, FAST><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(head), sd, sv, sd == 1,
      labels, Tn, D, V, tiles_per_split, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_fwd_combine<<<(Tn + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      part, Tn, splits, lse, pick);
  return cudaGetLastError();
}

template <typename T, bool FAST>
cudaError_t bwd_dx(const void* x, const void* head, long long sd, long long sv,
                   const long long* labels, const float* lse,
                   const float* coef, void* dx, float* part, int Tn, int D,
                   int V, int tiles_per_split, cudaStream_t st) {
  const int nvt = (V + kBV - 1) / kBV;
  const int splits = (nvt + tiles_per_split - 1) / tiles_per_split;
  cudaError_t err = cudaFuncSetAttribute(
      ce_dx_kernel<T, FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDxSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tn + kBT - 1) / kBT, splits);
  ce_dx_kernel<T, FAST><<<grid, kThreads, kDxSmem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(head), sd, sv, sd == 1,
      labels, lse, coef, Tn, D, V, tiles_per_split, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_cast<T>(part, splits, Tn, D, dx, D, 1, st);
}

template <typename T, bool FAST>
cudaError_t bwd_dh(const void* x, const void* head, long long sd, long long sv,
                   const long long* labels, const float* lse,
                   const float* coef, void* dh, long long so_d, long long so_v,
                   float* accum, int Tn, int D, int V, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      ce_dh_kernel<T, FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDhSmem);
  if (err != cudaSuccess) return err;
  ce_dh_kernel<T, FAST><<<(V + kBV - 1) / kBV, kThreads, kDhSmem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(head), sd, sv, sd == 1,
      labels, lse, coef, Tn, D, V, accum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_cast<T>(accum, 1, D, V, dh, so_d, so_v, st);
}

// Which instantiation runs: 0 f32; 1 bf16, generic loads (a k-contiguous
// head, the tied one, among them); 2 bf16 fast. The fast path needs an
// n-contiguous head and 16-byte aligned rows: D % 8 == 0, V % 8 == 0 and
// the head's row stride a multiple of 8.
inline int route(const void* x, const void* head, long long sd, long long sv,
                 int D, int V, int dtype) {
  if (dtype != 1) return 0;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(head) % 16 == 0 &&
                       D % 8 == 0 && V % 8 == 0 && sd % 8 == 0;
  return aligned && sv == 1 ? 2 : 1;
}

}  // namespace linear_ce
}  // namespace paddle_tpu_torch

using namespace paddle_tpu_torch::linear_ce;

// dtype: 0 float32, 1 bfloat16; T, D and V >= 1. bt, bv, splits and smem
// are the wrapper's plan: the logit tile (kBT x kBV), the number of vocab
// splits tiles_per_split makes, and the dynamic shared memory of the main
// kernel; a plan other than the kernels' is refused
// (cudaErrorInvalidValue). Each returns cudaError_t as int (0: both of its
// kernels were launched).
inline bool plan_ok(int V, int tiles_per_split, int bt, int bv, int splits) {
  const int nvt = (V + kBV - 1) / kBV;
  return bt == kBT && bv == kBV && tiles_per_split >= 1 &&
         splits == (nvt + tiles_per_split - 1) / tiles_per_split;
}

#define LINEAR_CE_ROUTE(fn, ...)                        \
  switch (route(x, head, sd, sv, D, V, dtype)) {        \
    case 0:                                             \
      return fn<float, false>(__VA_ARGS__);             \
    case 1:                                             \
      return fn<__nv_bfloat16, false>(__VA_ARGS__);     \
    default:                                            \
      return fn<__nv_bfloat16, true>(__VA_ARGS__);      \
  }

extern "C" int linear_ce_fwd(const void* x, const void* head, long long sd,
                             long long sv, const void* labels, void* lse,
                             void* pick, void* part, int Tn, int D, int V,
                             int tiles_per_split, int bt, int bv, int splits,
                             int dtype, void* stream) {
  if (!plan_ok(V, tiles_per_split, bt, bv, splits)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto lab = static_cast<const long long*>(labels);
  auto l = static_cast<float*>(lse), p = static_cast<float*>(pick),
       w = static_cast<float*>(part);
  LINEAR_CE_ROUTE(fwd, x, head, sd, sv, lab, l, p, w, Tn, D, V,
                  tiles_per_split, st)
}

extern "C" int linear_ce_bwd_dx(const void* x, const void* head, long long sd,
                                long long sv, const void* labels,
                                const void* lse, const void* coef, void* dx,
                                void* part, int Tn, int D, int V,
                                int tiles_per_split, int bt, int bv,
                                int splits, int smem, int dtype,
                                void* stream) {
  if (!plan_ok(V, tiles_per_split, bt, bv, splits) || smem != kDxSmem)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto lab = static_cast<const long long*>(labels);
  auto l = static_cast<const float*>(lse), c = static_cast<const float*>(coef);
  auto w = static_cast<float*>(part);
  LINEAR_CE_ROUTE(bwd_dx, x, head, sd, sv, lab, l, c, dx, w, Tn, D, V,
                  tiles_per_split, st)
}

extern "C" int linear_ce_bwd_dh(const void* x, const void* head, long long sd,
                                long long sv, const void* labels,
                                const void* lse, const void* coef, void* dh,
                                long long so_d, long long so_v, void* accum,
                                int Tn, int D, int V, int bv, int smem,
                                int dtype, void* stream) {
  if (bv != kBV || smem != kDhSmem) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto lab = static_cast<const long long*>(labels);
  auto l = static_cast<const float*>(lse), c = static_cast<const float*>(coef);
  auto w = static_cast<float*>(accum);
  LINEAR_CE_ROUTE(bwd_dh, x, head, sd, sv, lab, l, c, dh, so_d, so_v, w, Tn,
                  D, V, st)
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
