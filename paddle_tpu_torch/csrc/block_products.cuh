// The block-wide building blocks of the port's fused layer kernels
// (fused_decode_block.cu, fused_prefill_block.cu) and of the paged
// kernel (paged_attention.cu): the product tile routine, the RMSNorm of a
// pass of rows, the RoPE rotation and the cooperative launch (an
// attention item's scratch and its page stream are paged_stream.cuh's).
// One definition keeps the kernels' rounding orders the same.
//
// A product runs 8 rows at a time (a pass): each thread streams weight
// vectors (neighbouring lanes on neighbouring columns, four loads in
// flight before their FMAs) and multiplies each by the 8 rows of the left
// operand, kept k-major ([k][8 rows]) so one 16-byte shared load serves a
// vector; f32 sums in registers, reduced across lanes and warps in a
// fixed order (no atomics, so two launches give identical bits). Rows
// past the operand's end are zeros.
//
// Weight classes (the product's weight type, separate from the activation
// type T). Every class gives a thread the same V = 16 / sizeof(T) output
// columns and so the same accumulators, reduction tiles and shared memory:
//   kWFp    W in T, [K][N]: 16-byte loads of V columns.
//   kWInt8  int8 [K][N]: V-byte loads (8 bytes in bf16: half the fp load,
//           so the accumulators stay bf16's 8 x 8 floats; a 16-byte load
//           would double them, and the single-launch kernel already needs
//           227 registers). Exact in f32.
//   kWInt4K int4 packed along the contraction axis, [K/2][N]: byte (k', c)
//           holds rows k' (low nibble) and k' + K/2 (high nibble), so a
//           V-byte load of packed row k' multiplies two rows of the left
//           operand, a_t[k'] and a_t[k' + K/2]; the loop runs over K/2.
//   kWInt4N int4 packed along the output axis, [K][N/2] (down_proj): byte
//           (k, c') holds columns c' and c' + N/2, so a V/2-byte load gives
//           a thread V outputs at two column ranges; the tiles run over
//           N/2 packed columns and out_col() maps a result to its column.
// Nibbles are sign-extended ((b & 0xF) ^ 8) - 8 and b >> 4. The
// per-output-channel f32 scale is never applied here: the phases multiply
// the reduced f32 sum by it in their epilogue (dot(h, q) * s), as the JAX
// kernels do, and only then round to T.
//
// Shared memory of a kernel built on these, sized by its Python wrapper
// and passed in: ``region`` bytes for one pass of k-major rows [D][8] (or
// a staged chunk of a product's operand, or the attention scratch of one
// work item), then the per-warp partial sums [kWarps][kMaxLpr * V][8] f32
// and two [kMaxLpr * V][8] f32 result tiles. None of it depends on the
// weight class: these routines stream weights from device memory into
// registers, never staged (the single-launch kernel's bf16 body stages
// them: weight_ring.cuh).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "paged_stream.cuh"

namespace paddle_tpu_torch {
namespace fused {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRB = 8;          // rows summed per pass
constexpr int kMaxLpr = 8;      // lanes per weight row, at most

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);   // elements per 16-byte load
};

__host__ __device__ inline int passes(int B) { return (B + kRB - 1) / kRB; }

// The KV pools' element type: the model's T, or int8 for the int8 cache.
template <typename T, bool KQ>
using PoolT = typename std::conditional<KQ, int8_t, T>::type;

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float (&w)[Vec<T>::n]);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& raw, float (&w)[4]) {
  w[0] = __uint_as_float(raw.x);
  w[1] = __uint_as_float(raw.y);
  w[2] = __uint_as_float(raw.z);
  w[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw,
                                                      float (&w)[8]) {
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(u[i] << 16);
    w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// The 8 rows of one k of a k-major operand in shared memory, as f32.
template <typename T>
__device__ __forceinline__ void rows8(const T* p, float (&a)[kRB]);
template <>
__device__ __forceinline__ void rows8<float>(const float* p, float (&a)[kRB]) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  a[0] = lo.x; a[1] = lo.y; a[2] = lo.z; a[3] = lo.w;
  a[4] = hi.x; a[5] = hi.y; a[6] = hi.z; a[7] = hi.w;
}
template <>
__device__ __forceinline__ void rows8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float (&a)[kRB]) {
  unpack<__nv_bfloat16>(*reinterpret_cast<const uint4*>(p), a);
}

// Round to T and back: the value a T tensor would hold.
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_float(from_float<T>(x));
}

// A phase's tile plan (lanes per weight row, so a column tile of lpr * V
// outputs, and the number of tiles) is chosen by the kernel's Python
// wrapper from the launch's grid and passed in its arguments
// (ops/kernels/fused_decode_block.py: pick_lpr, the one definition), so the
// plan the kernel runs is the plan the kernel-geometry gate audits. A plan
// the kernels can run: lanes per row 2, 4 or 8 (kMaxLpr), tile counts >= 0.
inline bool plan_ok(int lpr, int tiles) {
  return (lpr == 2 || lpr == 4 || lpr == kMaxLpr) && tiles >= 0;
}

// Weight classes: see the file header.
constexpr int kWFp = 0, kWInt8 = 1, kWInt4K = 2, kWInt4N = 3;

// The class of one product under a kernel's weight bits (0 = fp, 8, 4);
// ``out_packed``: int4 packs this product along its output axis.
__host__ __device__ constexpr int wclass(int bits, bool out_packed) {
  return bits == 8 ? kWInt8 : bits == 4 ? (out_packed ? kWInt4N : kWInt4K)
                                        : kWFp;
}

template <typename T, int WC>
struct Wt {
  static constexpr int V = Vec<T>::n;                     // outputs a thread
  static constexpr int cols = WC == kWInt4N ? V / 2 : V;  // stored cols a load
  static constexpr int esz = WC == kWFp ? (int)sizeof(T) : 1;
  static constexpr int bytes = cols * esz;                // bytes a load
};

template <int N> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };
template <typename T, int WC>
using RawT = typename Raw<Wt<T, WC>::bytes>::type;

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
__device__ __forceinline__ uint32_t word(const uint2& r, int i) {
  return i == 0 ? r.x : r.y;
}
__device__ __forceinline__ uint32_t word(unsigned int r, int) { return r; }
__device__ __forceinline__ uint32_t word(unsigned short r, int) { return r; }

// Signed byte i of a raw load, and the two sign-extended nibbles of one.
template <typename R>
__device__ __forceinline__ int sbyte(const R& r, int i) {
  return (int)(int8_t)(word(r, i >> 2) >> (8 * (i & 3)));
}
__device__ __forceinline__ float lo4(int b) {
  return (float)(((b & 0xF) ^ 8) - 8);
}
__device__ __forceinline__ float hi4(int b) { return (float)(b >> 4); }

// Bytes of one stored weight row of ``n`` logical output columns.
template <typename T, int WC>
__host__ __device__ inline size_t row_bytes(int n) {
  return WC == kWFp ? (size_t)n * sizeof(T)
                    : WC == kWInt4N ? (size_t)n / 2 : (size_t)n;
}

template <typename T>
__device__ __forceinline__ void fma8(float (&acc)[kRB][Vec<T>::n],
                                     const float (&a)[kRB],
                                     const float (&w)[Vec<T>::n]) {
#pragma unroll
  for (int r = 0; r < kRB; ++r)
#pragma unroll
    for (int j = 0; j < Vec<T>::n; ++j) acc[r][j] = fmaf(a[r], w[j], acc[r][j]);
}

// acc += a_t[k] x (the thread's weights of stored row k): the left
// operand's 8 rows of k (and, for kWInt4K, of k + K/2 at a_hi) times the
// load ``raw``, converted to f32 in registers.
template <typename T, int WC>
__device__ __forceinline__ void fma_rows(float (&acc)[kRB][Vec<T>::n],
                                         const RawT<T, WC>& raw,
                                         const T* a_k, const T* a_hi_k) {
  constexpr int V = Vec<T>::n;
  float w[V], a[kRB];
  rows8<T>(a_k, a);
  if constexpr (WC == kWFp) {
    unpack<T>(raw, w);
  } else if constexpr (WC == kWInt8) {
#pragma unroll
    for (int j = 0; j < V; ++j) w[j] = (float)sbyte(raw, j);
  } else if constexpr (WC == kWInt4N) {
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      const int b = sbyte(raw, j);
      w[j] = lo4(b);
      w[j + V / 2] = hi4(b);
    }
  } else {   // kWInt4K: low nibbles for row k, high for row k + K/2
    float wh[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int b = sbyte(raw, j);
      w[j] = lo4(b);
      wh[j] = hi4(b);
    }
    fma8<T>(acc, a, w);
    rows8<T>(a_hi_k, a);
    fma8<T>(acc, a, wh);
    return;
  }
  fma8<T>(acc, a, w);
}

// acc[r][j] += sum over stored rows k < kn of the left operand's rows
// (a_t[k*8 + r], and a_hi[k*8 + r] for kWInt4K) times this thread's
// weights of row k, ``ldb`` bytes apart: its load of stored columns
// col0 + (lane % lpr) * cols, over its row slot, then every ``step`` rows.
// Stored columns >= ncols read nothing (ncols is a multiple of the load's
// columns, so a load is all in or all out).
template <typename T, int WC>
__device__ __forceinline__ void tile_accumulate(float (&acc)[kRB][Vec<T>::n],
                                                const T* a_t, const T* a_hi,
                                                const void* __restrict__ W,
                                                size_t ldb, int kn, int col0,
                                                int ncols, int lpr) {
  using Tr = Wt<T, WC>;
  using R = RawT<T, WC>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpw = 32 / lpr;
  const int col = col0 + (lane % lpr) * Tr::cols;
  if (col >= ncols) return;
  const int step = kWarps * rpw;
  const unsigned char* wp =
      static_cast<const unsigned char*>(W) + (size_t)col * Tr::esz;
  int k = warp * rpw + lane / lpr;
  for (; k + 3 * step < kn; k += 4 * step) {
    R raw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      raw[u] = __ldg(reinterpret_cast<const R*>(
          wp + (size_t)(k + u * step) * ldb));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const size_t o = (size_t)(k + u * step) * kRB;
      fma_rows<T, WC>(acc, raw[u], a_t + o, a_hi + o);
    }
  }
  for (; k < kn; k += step)
    fma_rows<T, WC>(acc, __ldg(reinterpret_cast<const R*>(wp + (size_t)k * ldb)),
                    a_t + (size_t)k * kRB, a_hi + (size_t)k * kRB);
}

// The output column of result ``lc`` (tile_reduce's res_s[lc * 8 + r]) of
// the tile whose stored columns start at col0, or -1 when it lies past the
// stored ``ncols``. ``half``: N/2, the kWInt4N high nibbles' offset.
template <typename T, int WC>
__device__ __forceinline__ int out_col(int col0, int lc, int ncols,
                                       int half) {
  if constexpr (WC == kWInt4N) {
    constexpr int V = Vec<T>::n;
    const int j = lc % V;
    const int p = col0 + (lc / V) * (V / 2) + j % (V / 2);
    if (p >= ncols) return -1;
    return j < V / 2 ? p : p + half;
  } else {
    const int c = col0 + lc;
    return c < ncols ? c : -1;
  }
}

// Sum acc across the lanes of a column and across warps, in a fixed
// order, into res_s[c * 8 + r] (f32). Synchronises the block.
template <typename T>
__device__ __forceinline__ void tile_reduce(float (&acc)[kRB][Vec<T>::n],
                                            float* red_s, float* res_s,
                                            int lpr) {
  constexpr int V = Vec<T>::n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tc = lpr * V;
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < kRB; ++r)
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], off);
  }
  if (lane < lpr) {
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int r = 0; r < kRB; ++r)
        red_s[((warp * tc) + lane * V + j) * kRB + r] = acc[r][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tc * kRB; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red_s[w * tc * kRB + i];
    res_s[i] = s;
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void zero(float (&acc)[kRB][Vec<T>::n]) {
#pragma unroll
  for (int r = 0; r < kRB; ++r)
#pragma unroll
    for (int j = 0; j < Vec<T>::n; ++j) acc[r][j] = 0.f;
}

// Rows [k0, k0 + kc) of a k-major operand A_t [.][8] in device memory into
// dst (rows past nr of the 8 as 0). Every thread of the block takes part.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* A_t, int k0, int kc,
                                           T* dst, int nr) {
  constexpr int V = Vec<T>::n;
  const int nv = kc * kRB / V;
  const uint4* src = reinterpret_cast<const uint4*>(A_t + (size_t)k0 * kRB);
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    uint4 v = src[i];
    if (nr < kRB) {
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int j = 0; j < V; ++j)
        if ((i * V + j) % kRB >= nr) e[j] = from_float<T>(0.f);
    }
    reinterpret_cast<uint4*>(dst)[i] = v;
  }
}

// Sums of one pass (8 rows, ``nr`` of them real) of a k-major operand A_t
// [K][8] in device memory times the weights (stored rows ``ldb`` bytes
// apart, the tile's stored columns from col0) into res_s, staging A_t
// through a_s in chunks of kc_max rows of k (rows past nr staged as 0).
// kWInt4K stages the matching rows of both halves of K: chunk rows
// [k0, k0 + kc) of the first half at a_s, of the second at a_s +
// (kc_max / 2) * 8, kc <= kc_max / 2 packed rows a chunk.
template <typename T, int WC>
__device__ void tile_sums_staged(const T* A_t, int K, T* a_s, int kc_max,
                                 const void* __restrict__ W, size_t ldb,
                                 int col0, int ncols, int nr, int lpr,
                                 float* red_s, float* res_s) {
  constexpr int V = Vec<T>::n;
  float acc[kRB][V];
  zero<T>(acc);
  const bool halves = WC == kWInt4K;
  const int kn = halves ? K / 2 : K;                 // stored rows
  const int kcm = halves ? kc_max / 2 : kc_max;      // stored rows a chunk
  T* a_hi = a_s + (size_t)kcm * kRB;
  for (int k0 = 0; k0 < kn; k0 += kcm) {
    const int kc = min(kcm, kn - k0);
    __syncthreads();   // the previous chunk's readers are done with a_s
    stage_rows<T>(A_t, k0, kc, a_s, nr);
    if (halves) stage_rows<T>(A_t, kn + k0, kc, a_hi, nr);
    __syncthreads();
    tile_accumulate<T, WC>(acc, a_s, a_hi,
                           static_cast<const unsigned char*>(W) +
                               (size_t)k0 * ldb,
                           ldb, kc, col0, ncols, lpr);
  }
  tile_reduce<T>(acc, red_s, res_s, lpr);
}

// h_t[k*8 + r] = T(T(x * rsqrt(mean(x^2) + eps)) * nw) for row b = 8p + r
// of pass p, zeros for rows past B; f32 statistics: ops/kernels/norms.py's
// rounding order. x is in T, or f32 (the single-launch block kernel's
// residual, written by other blocks of the same launch: so x is not read
// through the read-only cache). The 8 rows are read together (8 loads in
// flight a thread) and reduced in one block-wide step. Synchronises the
// block.
template <typename T, typename In>
__device__ void rms_pass(const In* x, const T* __restrict__ nw,
                         T* h_t, int p, int B, int D, float eps,
                         float* red_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nr = min(kRB, B - p * kRB);
  const In* xp = x + (size_t)p * kRB * D;
  __syncthreads();   // earlier readers of h_t and red_s are done
  float ss[kRB];
#pragma unroll
  for (int r = 0; r < kRB; ++r) ss[r] = 0.f;
  for (int k = threadIdx.x; k < D; k += kThreads) {
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      if (r < nr) {
        const float v = to_float(xp[(size_t)r * D + k]);
        ss[r] = fmaf(v, v, ss[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRB; ++r) red_s[warp * kRB + r] = ss[r];
  }
  __syncthreads();
  float rstd[kRB];
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += red_s[w * kRB + r];
    rstd[r] = rsqrtf(tot / (float)D + eps);
  }
  for (int k = threadIdx.x; k < D; k += kThreads) {
    const float w = to_float(nw[k]);
    __align__(16) T hk[kRB];
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      float h = 0.f;
      if (r < nr) {
        const float n =
            round_t<T>(__fmul_rn(to_float(xp[(size_t)r * D + k]), rstd[r]));
        h = __fmul_rn(n, w);
      }
      hk[r] = from_float<T>(h);
    }
#pragma unroll
    for (int v = 0; v < kRB * (int)sizeof(T) / 16; ++v)
      reinterpret_cast<uint4*>(h_t + (size_t)k * kRB)[v] =
          reinterpret_cast<const uint4*>(hk)[v];
  }
  __syncthreads();
}

// Makes pass p's normalised rows the ones in h_t, unless they are already
// (``*held`` names the pass h_t holds, -1 for none). Block-uniform.
template <typename T, typename In>
__device__ __forceinline__ void hold_pass(const In* x, const T* nw, T* h_t,
                                          int p, int* held, int B, int D,
                                          float eps, float* red_s) {
  if (*held == p) return;
  rms_pass<T, In>(x, nw, h_t, p, B, D, eps, red_s);
  *held = p;
}

// The neox-halves rotation of element d of one head row, in f32, as
// ops/rope.apply_rope computes it (no fused multiply-add).
template <typename T>
__device__ __forceinline__ float rope_at(const T* row, int d, int hd2,
                                         const float* sn, const float* cs) {
  const int j = d < hd2 ? d : d - hd2;
  const float x1 = to_float(row[j]), x2 = to_float(row[j + hd2]);
  return d < hd2 ? __fsub_rn(__fmul_rn(x1, cs[j]), __fmul_rn(x2, sn[j]))
                 : __fadd_rn(__fmul_rn(x2, cs[j]), __fmul_rn(x1, sn[j]));
}

template <typename Args>
using KernelFn = void (*)(const Args);

// A launcher's kernel for (dtype code: 0 f32, 1 bf16; weight bits: 0 fp,
// 8, 4), or nullptr for a pair it does not take.
#define PADDLE_TPU_PICK_KERNEL(pick, kernel, Args)                   \
  inline KernelFn<Args> pick(int dtype, int wbits) {                  \
    if (dtype == 1) {                                                 \
      if (wbits == 0) return kernel<__nv_bfloat16, 0>;                \
      if (wbits == 8) return kernel<__nv_bfloat16, 8>;                \
      if (wbits == 4) return kernel<__nv_bfloat16, 4>;                \
    } else if (dtype == 0) {                                          \
      if (wbits == 0) return kernel<float, 0>;                        \
      if (wbits == 8) return kernel<float, 8>;                        \
      if (wbits == 4) return kernel<float, 4>;                        \
    }                                                                 \
    return nullptr;                                                   \
  }

// The same for a kernel that reads the KV pools, by (dtype, weight bits,
// pool bits: 0 for T, 8 for int8).
#define PADDLE_TPU_PICK_KV_KERNEL(pick, kernel, Args)                 \
  inline KernelFn<Args> pick(int dtype, int wbits, int kvbits) {      \
    if (kvbits != 0 && kvbits != 8) return nullptr;                   \
    const bool kq = kvbits == 8;                                      \
    if (dtype == 1) {                                                 \
      if (wbits == 0)                                                 \
        return kq ? &kernel<__nv_bfloat16, 0, true>                   \
                  : &kernel<__nv_bfloat16, 0, false>;                 \
      if (wbits == 8)                                                 \
        return kq ? &kernel<__nv_bfloat16, 8, true>                   \
                  : &kernel<__nv_bfloat16, 8, false>;                 \
      if (wbits == 4)                                                 \
        return kq ? &kernel<__nv_bfloat16, 4, true>                   \
                  : &kernel<__nv_bfloat16, 4, false>;                 \
    } else if (dtype == 0) {                                          \
      if (wbits == 0)                                                 \
        return kq ? &kernel<float, 0, true> : &kernel<float, 0, false>; \
      if (wbits == 8)                                                 \
        return kq ? &kernel<float, 8, true> : &kernel<float, 8, false>; \
      if (wbits == 4)                                                 \
        return kq ? &kernel<float, 4, true> : &kernel<float, 4, false>; \
    }                                                                 \
    return nullptr;                                                   \
  }

// The cooperative grid of ``kernel`` at ``smem`` bytes of dynamic shared
// memory a block: every co-resident block (SMs x blocks an SM, from the
// occupancy calculator), worked out once per (kernel, shared memory,
// device): the serving loop launches these kernels once per layer. Raises
// the kernel's dynamic shared-memory limit to ``smem`` on the way, never
// lowers it: a kernel run at a small size after a large one (the gate's
// regression specimen, D 32, after the MLP at D 4096) keeps the limit of
// the large one, which its cached grid was worked out under.
template <typename Args>
cudaError_t coop_blocks(void (*kernel)(const Args), size_t smem, int* out) {
  struct Grid {
    void (*kernel)(const Args);
    size_t smem;
    int dev, blocks;
  };
  static Grid known[64];
  static int n_known = 0;
  cudaError_t e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  for (int i = 0; i < n_known; ++i)
    if (known[i].kernel == kernel && known[i].smem == smem &&
        known[i].dev == dev) {
      *out = known[i].blocks;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  cudaFuncAttributes fa;
  if ((e = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return e;
  if ((int)smem > fa.maxDynamicSharedSizeBytes &&
      (e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  if (n_known < 64) known[n_known++] = Grid{kernel, smem, dev, *out};
  return cudaSuccess;
}

// The exported grid query of a launcher: the blocks of its cooperative
// grid, or minus the cudaError_t (a kernel it does not take: minus
// cudaErrorInvalidValue).
template <typename Args>
int coop_grid_or_error(void (*kernel)(const Args), int smem) {
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t e = coop_blocks(kernel, (size_t)smem, &blocks);
  return e == cudaSuccess ? blocks : -(int)e;
}

// One cooperative launch of ``kernel`` over ``grid`` blocks: the grid its
// wrapper planned the tiles for, which must be every co-resident block
// (coop_blocks). A grid that differs is refused (cudaErrorInvalidValue),
// never launched.
template <typename Args>
cudaError_t launch_coop(void (*kernel)(const Args), const Args& args,
                        size_t smem, int grid, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t e = coop_blocks(kernel, smem, &blocks);
  if (e != cudaSuccess) return e;
  if (grid != blocks) return cudaErrorInvalidValue;
  void* params[] = {const_cast<Args*>(&args)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                  dim3(blocks), dim3(kThreads), params, smem,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace fused
}  // namespace paddle_tpu_torch
