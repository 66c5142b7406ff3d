// Fused decode-block kernels for Hopper (sm_90a): one launch for the
// attention half of a LLaMA decoder layer, one for its MLP half.
//
// decode_attn_block replaces paddle_tpu/ops/pallas/fused_decode_block.py's
// fused_attn_block_pallas (body _attn_block_kernel, launch
// "decode_attn_block"):
//   x [B, D], nw [D], wq [D, H*hd], wk/wv [D, KV*hd], wo [H*hd, D] (type T)
//   sin/cos [Tr, hd/2] f32 (full rope tables), pools [N, BS, KV, hd] (T)
//   block_tables [B, MB] int32, seq_lens [B] int32 (tokens already in the
//   pool; the new token sits at position seq_lens[b])
//   -> x_out = x + o_proj(attn) [B, D] (o_proj alone when residual is 0),
//   k_new/v_new [B, KV, hd]; no pool write.
// decode_mlp_block replaces fused_mlp_block_pallas (body _mlp_block_kernel,
// launch "decode_mlp_block"):
//   x [B, D], nw [D], wg/wu [D, F], wd [F, D] -> x + down(silu(g) * u).
// T is float or __nv_bfloat16. Both follow the rounding order of the plain
// versions (ops/kernels/fused_decode_block.py): RMSNorm in f32, cast to T
// before the weight multiply; every product lands in T; RoPE in f32 on the
// T projection; silu(g)*u in T; the residual add in T.
//
// What bounds them on the H100: memory. At B=8 a layer reads 134 MB
// (attention, 7B bf16) and 270 MB (MLP) of weights for ~2 flops a byte,
// far below the card's ~295 flops/byte ridge. The weights cannot stay in
// shared memory as they stay in the TPU kernel's VMEM, and each phase
// needs all of the previous phase's output (every QKV head before
// attention, every attention head before o_proj, every ff column before
// down). So each kernel is ONE cooperative launch whose blocks (as many as
// are co-resident) split every phase and meet at grid-wide barriers:
//   attention: QKV products by column tiles, each block normalising the
//              8 rows of a pass into shared memory as it needs them
//              -> workspace (T)
//              | grid sync | attention over 8-page chunks of each
//              (sequence, KV head), 4 pages a step through
//              online_softmax_page_update -> f32 partials
//              | grid sync | per (sequence, KV head): the partials and
//              the new token combined in a fixed order -> workspace (T)
//              | grid sync | o_proj by column tiles, + x.
//   MLP:       RMSNorm | gate/up by F tiles (a ragged last tile is
//              masked), silu(g)*u -> workspace (T) | grid sync | down by
//              output column tiles over all of F, + x.
// Every product is one block-wide tile routine: each thread streams
// 16-byte weight vectors (neighbouring lanes on neighbouring columns, four
// loads issued before their FMAs) and multiplies each by 8 rows of the
// left operand, kept k-major ([k][8 rows]) so one 16-byte shared load
// serves a vector; f32 sums in registers, reduced across lanes and warps
// in a fixed order. Rows past B are zeros. Rows go 8 at a time (a pass):
// only one pass of normalised rows is resident, so shared memory does not
// grow with B; a block normalises pass p again for each of its tiles when
// B > 8, reading x from L2 rather than holding every pass. No atomics
// touch any sum, so two launches give identical bits. The tile width is
// picked per phase from the grid so the busiest block has the fewest
// columns. Not done yet (later work): tensor-core products, cp.async/TMA
// pipelining of the weight stream.
//
// Shared memory, sized by the wrapper (ops/kernels/fused_decode_block.py,
// the one definition of the sizes) and passed in: ``region`` bytes for one
// pass of k-major rows [D][8] (or a staged chunk of a product's operand,
// or the attention scratch of one item), then the per-warp partial sums
// [kWarps][kMaxLpr * V][8] f32 and two [kMaxLpr * V][8] f32 result tiles.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace cg = cooperative_groups;

namespace paddle_tpu_torch {
namespace fused {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRB = 8;          // rows (sequences) summed per pass
constexpr int kMaxLpr = 8;      // lanes per weight row, at most
constexpr int kPagesPerStep = 4;
constexpr int kSplitPages = 8;  // pages per attention work item

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);   // elements per 16-byte load
};

__host__ __device__ inline int passes(int B) { return (B + kRB - 1) / kRB; }
__host__ __device__ inline int splits(int MB) {
  return (MB + kSplitPages - 1) / kSplitPages;
}

// f32 scratch of one attention item, at the start of the region: q, acc
// [groups][hd]; scores [groups][pages per step * BS]; m, l, alpha
// [groups]; the new token's k [hd]; padded to 16 bytes. The step's K and
// V pages (T) follow it.
__device__ inline size_t attn_scratch_floats(int groups, int hd, int BS) {
  size_t f = 2 * (size_t)groups * hd + (size_t)groups * kPagesPerStep * BS +
             3 * (size_t)groups + (size_t)hd;
  return (f + 3) / 4 * 4;
}

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

// Lanes per weight row for a phase of ``ncols`` output columns: the width
// that gives the busiest block the fewest columns, the wider on a tie.
__device__ __forceinline__ int pick_lpr(int ncols, int vec) {
  int best = kMaxLpr, best_cost = 0x7fffffff;
  for (int lpr = kMaxLpr; lpr >= 2; lpr >>= 1) {
    const int tc = lpr * vec;
    const int tiles = (ncols + tc - 1) / tc;
    const int cost = ((tiles + (int)gridDim.x - 1) / (int)gridDim.x) * tc;
    if (cost < best_cost) {
      best_cost = cost;
      best = lpr;
    }
  }
  return best;
}

template <typename T>
__device__ __forceinline__ void fma_rows(float (&acc)[kRB][Vec<T>::n],
                                         const uint4& raw, const T* a_k) {
  float w[Vec<T>::n], a[kRB];
  unpack<T>(raw, w);
  rows8<T>(a_k, a);
#pragma unroll
  for (int r = 0; r < kRB; ++r)
#pragma unroll
    for (int j = 0; j < Vec<T>::n; ++j) acc[r][j] = fmaf(a[r], w[j], acc[r][j]);
}

// acc[r][j] += sum over k < kn of a_t[k*8 + r] * W[k*ldw + col + j] for
// this thread's column vector (col = col0 + (lane % lpr) * V) and its rows
// k (its row slot, then every ``step`` rows). Columns >= ncols read
// nothing (ncols is a multiple of V, so a vector is all in or all out).
template <typename T>
__device__ __forceinline__ void tile_accumulate(float (&acc)[kRB][Vec<T>::n],
                                                const T* a_t,
                                                const T* __restrict__ W,
                                                size_t ldw, int kn, int col0,
                                                int ncols, int lpr) {
  constexpr int V = Vec<T>::n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpw = 32 / lpr;
  const int col = col0 + (lane % lpr) * V;
  if (col >= ncols) return;
  const int step = kWarps * rpw;
  const T* wp = W + col;
  int k = warp * rpw + lane / lpr;
  for (; k + 3 * step < kn; k += 4 * step) {
    uint4 raw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      raw[u] = __ldg(reinterpret_cast<const uint4*>(
          wp + (size_t)(k + u * step) * ldw));
#pragma unroll
    for (int u = 0; u < 4; ++u)
      fma_rows<T>(acc, raw[u], a_t + (size_t)(k + u * step) * kRB);
  }
  for (; k < kn; k += step)
    fma_rows<T>(acc, __ldg(reinterpret_cast<const uint4*>(wp + (size_t)k * ldw)),
                a_t + (size_t)k * kRB);
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

// Sums of one pass (8 rows, ``nr`` of them real) of a k-major operand A_t
// [K][8] in device memory times W[:, col0:+tile] into res_s, staging A_t
// through a_s in chunks of kc_max rows of k (rows past nr staged as 0).
template <typename T>
__device__ void tile_sums_staged(const T* A_t, int K, T* a_s, int kc_max,
                                 const T* __restrict__ W, size_t ldw,
                                 int col0, int ncols, int nr, int lpr,
                                 float* red_s, float* res_s) {
  constexpr int V = Vec<T>::n;
  float acc[kRB][V];
  zero<T>(acc);
  for (int k0 = 0; k0 < K; k0 += kc_max) {
    const int kc = min(kc_max, K - k0);
    const int nv = kc * kRB / V;
    __syncthreads();   // the previous chunk's readers are done with a_s
    const uint4* src = reinterpret_cast<const uint4*>(A_t + (size_t)k0 * kRB);
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      uint4 v = src[i];
      if (nr < kRB) {
        T* e = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int j = 0; j < V; ++j)
          if ((i * V + j) % kRB >= nr) e[j] = from_float<T>(0.f);
      }
      reinterpret_cast<uint4*>(a_s)[i] = v;
    }
    __syncthreads();
    tile_accumulate<T>(acc, a_s, W + (size_t)k0 * ldw, ldw, kc, col0, ncols,
                       lpr);
  }
  tile_reduce<T>(acc, red_s, res_s, lpr);
}

// h_t[k*8 + r] = T(T(x * rsqrt(mean(x^2) + eps)) * nw) for row b = 8p + r
// of pass p, zeros for rows past B; f32 statistics: ops/kernels/norms.py's
// rounding order. The 8 rows are read together (8 loads in flight a
// thread) and reduced in one block-wide step. Synchronises the block.
template <typename T>
__device__ void rms_pass(const T* __restrict__ x, const T* __restrict__ nw,
                         T* h_t, int p, int B, int D, float eps,
                         float* red_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nr = min(kRB, B - p * kRB);
  const T* xp = x + (size_t)p * kRB * D;
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
template <typename T>
__device__ __forceinline__ void hold_pass(const T* x, const T* nw, T* h_t,
                                          int p, int* held, int B, int D,
                                          float eps, float* red_s) {
  if (*held == p) return;
  rms_pass<T>(x, nw, h_t, p, B, D, eps, red_s);
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

struct AttnArgs {
  const void *x, *nw, *wq, *wk, *wv, *wo;
  const float *sin, *cos;
  const void *k_pool, *v_pool;
  const int *tables, *seq_lens;
  void *x_out, *k_new, *v_new;
  void *qkv_ws, *attn_ws;             // T: [B][(H+2KV)*hd], [P][H*hd][8]
  float *part_m, *part_l, *part_acc;  // [B][KV][splits][groups](*hd)
  float* s_new;                       // [B][H]
  int B, D, H, KV, hd, BS, MB, rope_rows, residual;
  float eps, scale;
  size_t region;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
decode_attn_block_kernel(const AttnArgs a) {
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, D = a.D, H = a.H, KV = a.KV, hd = a.hd, BS = a.BS;
  const int tid = threadIdx.x;
  const int groups = H / KV, hd2 = hd / 2, NS = splits(a.MB);
  const int nq = H * hd, nkv = KV * hd, ncols = nq + 2 * nkv;
  T* region = reinterpret_cast<T*>(smem);
  float* red_s = reinterpret_cast<float*>(smem + a.region);
  float* res_s = red_s + kWarps * kMaxLpr * V * kRB;
  T* qkv = static_cast<T*>(a.qkv_ws);
  T* attn_t = static_cast<T*>(a.attn_ws);
  cg::grid_group grid = cg::this_grid();

  // 1. q/k/v products by column tiles of the three matrices, rows in T,
  // over the RMSNorm of each pass of rows (k-major in shared memory)
  {
    const int lpr = pick_lpr(ncols, V), tc = lpr * V;
    const int tq = (nq + tc - 1) / tc, tk = (nkv + tc - 1) / tc;
    int held = -1;
    for (int t = blockIdx.x; t < tq + 2 * tk; t += gridDim.x) {
      const T* W;
      int col0, n, base;
      if (t < tq) {
        W = static_cast<const T*>(a.wq); col0 = t * tc; n = nq; base = 0;
      } else if (t < tq + tk) {
        W = static_cast<const T*>(a.wk); col0 = (t - tq) * tc; n = nkv;
        base = nq;
      } else {
        W = static_cast<const T*>(a.wv); col0 = (t - tq - tk) * tc; n = nkv;
        base = nq + nkv;
      }
      for (int p = 0; p < passes(B); ++p) {
        hold_pass<T>(static_cast<const T*>(a.x), static_cast<const T*>(a.nw),
                     region, p, &held, B, D, a.eps, red_s);
        float acc[kRB][V];
        zero<T>(acc);
        tile_accumulate<T>(acc, region, W, n, D, col0, n, lpr);
        tile_reduce<T>(acc, red_s, res_s, lpr);
        for (int i = tid; i < tc * kRB; i += kThreads) {
          const int c = col0 + i / kRB, b = p * kRB + i % kRB;
          if (b < B && c < n)
            qkv[(size_t)b * ncols + base + c] = from_float<T>(res_s[i]);
        }
        __syncthreads();
      }
    }
  }
  grid.sync();

  // 2. attention over 8-page chunks of each (sequence, KV head), 4 pages
  // a step; chunk 0 also makes the new token's k/v and score
  {
    const int SB = kPagesPerStep * BS;   // tokens a step
    float* q_s = reinterpret_cast<float*>(smem);   // [groups][hd]
    float* acc = q_s + groups * hd;                 // [groups][hd]
    float* s = acc + groups * hd;                   // [groups][SB]
    float* m = s + groups * SB;                     // [groups]
    float* l = m + groups;
    float* alpha = l + groups;
    float* kn_s = alpha + groups;                   // [hd]
    T* k_s = reinterpret_cast<T*>(q_s + attn_scratch_floats(groups, hd, BS));
    T* v_s = k_s + SB * hd;
    const int lane = tid & 31, warp = tid >> 5;
    const int row_vecs = hd / V;
    for (int item = blockIdx.x; item < NS * B * KV; item += gridDim.x) {
      const int kvh = item % KV, b = (item / KV) % B, sp = item / (KV * B);
      const int seq_len = a.seq_lens[b];
      const int n_pages = min((seq_len + BS - 1) / BS, a.MB);   // 0 if 0
      const int p0 = sp * kSplitPages;
      const int p1 = min(p0 + kSplitPages, n_pages);
      if (sp > 0 && p0 >= n_pages) continue;   // block-uniform
      const int pos = min(max(seq_len, 0), a.rope_rows - 1);
      const float* sn = a.sin + (size_t)pos * hd2;
      const float* cs = a.cos + (size_t)pos * hd2;
      const T* row = qkv + (size_t)b * ncols;
      const T* qr = row + (size_t)kvh * groups * hd;
      for (int i = tid; i < groups * hd; i += kThreads) {
        const int g = i / hd, d = i - g * hd;
        q_s[i] = round_t<T>(rope_at<T>(qr + g * hd, d, hd2, sn, cs));
        acc[i] = 0.f;
      }
      for (int g = tid; g < groups; g += kThreads) {
        m[g] = -CUDART_INF_F;
        l[g] = 0.f;
      }
      if (sp == 0) {
        const T* kr = row + nq + (size_t)kvh * hd;
        const T* vr = row + nq + nkv + (size_t)kvh * hd;
        const size_t kv_off = ((size_t)b * KV + kvh) * hd;
        for (int d = tid; d < hd; d += kThreads) {
          const T kt = from_float<T>(rope_at<T>(kr, d, hd2, sn, cs));
          static_cast<T*>(a.k_new)[kv_off + d] = kt;
          static_cast<T*>(a.v_new)[kv_off + d] = vr[d];
          kn_s[d] = to_float(kt);   // the pool holds T: T -> pool -> f32
        }
        __syncthreads();
        for (int g = warp; g < groups; g += kWarps) {
          float dot = 0.f;
          for (int d = lane; d < hd; d += 32) dot += q_s[g * hd + d] * kn_s[d];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (lane == 0) a.s_new[b * H + kvh * groups + g] = dot * a.scale;
        }
      }
      const int* table = a.tables + (size_t)b * a.MB;
      for (int pg = p0; pg < p1; pg += kPagesPerStep) {
        __syncthreads();
        // pages past the chunk's last live page are clamped to it and
        // masked by seq_len (the chunk's page count is a multiple of the
        // step except where the sequence ends)
        // four K and four V vectors in flight per thread before any store
        const int nvec = SB * row_vecs;
        for (int i0 = tid; i0 < nvec; i0 += 4 * kThreads) {
          uint4 kk[4], vv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * kThreads;
            if (i < nvec) {
              const int t = i / row_vecs, c = i - t * row_vecs;
              const size_t page =
                  (size_t)table[clamped_page_index(seq_len, BS, pg + t / BS)];
              const size_t off =
                  ((page * BS + t % BS) * KV + kvh) * hd + (size_t)c * V;
              kk[u] = *reinterpret_cast<const uint4*>(
                  static_cast<const T*>(a.k_pool) + off);
              vv[u] = *reinterpret_cast<const uint4*>(
                  static_cast<const T*>(a.v_pool) + off);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * kThreads;
            if (i < nvec) {
              reinterpret_cast<uint4*>(k_s)[i] = kk[u];
              reinterpret_cast<uint4*>(v_s)[i] = vv[u];
            }
          }
        }
        __syncthreads();
        online_softmax_page_update<T>(q_s, k_s, v_s, pg / kPagesPerStep, SB,
                                      seq_len, a.scale, groups, hd, s, m, l,
                                      alpha, acc);
      }
      __syncthreads();
      const size_t pidx = (((size_t)b * KV + kvh) * NS + sp) * groups;
      for (int i = tid; i < groups * hd; i += kThreads)
        a.part_acc[pidx * hd + i] = acc[i];
      for (int g = tid; g < groups; g += kThreads) {
        a.part_m[pidx + g] = m[g];
        a.part_l[pidx + g] = l[g];
      }
      __syncthreads();   // the next item reuses the scratch
    }
  }
  grid.sync();

  // 3. per (sequence, KV head): the chunks' partials and the new token
  // (always unmasked, so l > 0) combined in chunk order
  for (int item = blockIdx.x; item < B * KV; item += gridDim.x) {
    const int b = item / KV, kvh = item - b * KV;
    const int seq_len = a.seq_lens[b];
    const int n_pages = min((seq_len + BS - 1) / BS, a.MB);
    const int ns = (n_pages + kSplitPages - 1) / kSplitPages;
    const size_t pbase = ((size_t)b * KV + kvh) * NS;
    const T* vnew = static_cast<const T*>(a.v_new) + ((size_t)b * KV + kvh) * hd;
    for (int i = tid; i < groups * hd; i += kThreads) {
      const int g = i / hd, d = i - g * hd;
      const float snew = a.s_new[b * H + kvh * groups + g];
      float mx = snew;
      for (int sp = 0; sp < ns; ++sp)
        mx = fmaxf(mx, a.part_m[(pbase + sp) * groups + g]);
      const float pn = expf(snew - mx);
      float l = pn, o = pn * to_float(vnew[d]);
      for (int sp = 0; sp < ns; ++sp) {
        const size_t pi = (pbase + sp) * groups + g;
        const float w = expf(a.part_m[pi] - mx);
        l += w * a.part_l[pi];
        o += w * a.part_acc[pi * hd + d];
      }
      const int col = (kvh * groups + g) * hd + d;
      attn_t[((size_t)(b / kRB) * nq + col) * kRB + b % kRB] =
          from_float<T>(o / l);
    }
  }
  grid.sync();

  // 4. o_proj by column tiles of D, then the residual add in T
  {
    const int lpr = pick_lpr(D, V), tc = lpr * V;
    const int kc_max = min(nq, (int)(a.region / (sizeof(T) * kRB)));
    const T* x = static_cast<const T*>(a.x);
    T* xo = static_cast<T*>(a.x_out);
    const int tiles = (D + tc - 1) / tc;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      for (int p = 0; p < passes(B); ++p) {
        tile_sums_staged<T>(attn_t + (size_t)p * nq * kRB, nq, region, kc_max,
                            static_cast<const T*>(a.wo), D, t * tc, D,
                            min(kRB, B - p * kRB), lpr, red_s, res_s);
        for (int i = tid; i < tc * kRB; i += kThreads) {
          const int c = t * tc + i / kRB, b = p * kRB + i % kRB;
          if (b < B && c < D) {
            const size_t o = (size_t)b * D + c;
            const float d = round_t<T>(res_s[i]);
            xo[o] = from_float<T>(a.residual ? to_float(x[o]) + d : d);
          }
        }
        __syncthreads();
      }
    }
  }
}

struct MlpArgs {
  const void *x, *nw, *wg, *wu, *wd;
  void *out, *ff_ws;   // T: [P][F][8]
  int B, D, F, residual;
  float eps;
  size_t region;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
decode_mlp_block_kernel(const MlpArgs a) {
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, D = a.D, F = a.F;
  const int tid = threadIdx.x;
  T* region = reinterpret_cast<T*>(smem);
  float* red_s = reinterpret_cast<float*>(smem + a.region);
  float* res_g = red_s + kWarps * kMaxLpr * V * kRB;
  float* res_u = res_g + kMaxLpr * V * kRB;
  T* ff_t = static_cast<T*>(a.ff_ws);
  const T* x = static_cast<const T*>(a.x);
  cg::grid_group grid = cg::this_grid();

  // 1. gate and up by F tiles (the last one masked) over the RMSNorm of
  // each pass of rows (k-major in shared memory), silu(g)*u in T
  {
    const int lpr = pick_lpr(F, V), tc = lpr * V;
    const int tiles = (F + tc - 1) / tc;
    int held = -1;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int col0 = t * tc;
      for (int p = 0; p < passes(B); ++p) {
        hold_pass<T>(x, static_cast<const T*>(a.nw), region, p, &held, B, D,
                     a.eps, red_s);
        const T* h = region;
        float acc[kRB][V];
        zero<T>(acc);
        tile_accumulate<T>(acc, h, static_cast<const T*>(a.wg), F, D, col0, F,
                           lpr);
        tile_reduce<T>(acc, red_s, res_g, lpr);
        zero<T>(acc);
        tile_accumulate<T>(acc, h, static_cast<const T*>(a.wu), F, D, col0, F,
                           lpr);
        tile_reduce<T>(acc, red_s, res_u, lpr);
        for (int i = tid; i < tc * kRB; i += kThreads) {
          const int c = col0 + i / kRB, b = p * kRB + i % kRB;
          if (b < B && c < F) {
            const float g = round_t<T>(res_g[i]), u = round_t<T>(res_u[i]);
            const float sg = round_t<T>(g / (1.f + expf(-g)));
            ff_t[((size_t)p * F + c) * kRB + i % kRB] =
                from_float<T>(__fmul_rn(sg, u));
          }
        }
        __syncthreads();
      }
    }
  }
  grid.sync();

  // 2. down by column tiles of D over all of F, then the residual add
  {
    const int lpr = pick_lpr(D, V), tc = lpr * V;
    const int kc_max = min(F, (int)(a.region / (sizeof(T) * kRB)));
    T* out = static_cast<T*>(a.out);
    const int tiles = (D + tc - 1) / tc;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      for (int p = 0; p < passes(B); ++p) {
        tile_sums_staged<T>(ff_t + (size_t)p * F * kRB, F, region, kc_max,
                            static_cast<const T*>(a.wd), D, t * tc, D,
                            min(kRB, B - p * kRB), lpr, red_s, res_g);
        for (int i = tid; i < tc * kRB; i += kThreads) {
          const int c = t * tc + i / kRB, b = p * kRB + i % kRB;
          if (b < B && c < D) {
            const size_t o = (size_t)b * D + c;
            const float d = round_t<T>(res_g[i]);
            out[o] = from_float<T>(a.residual ? to_float(x[o]) + d : d);
          }
        }
        __syncthreads();
      }
    }
  }
}

// One cooperative launch of ``kernel`` with every co-resident block. The
// grid size of each (kernel, shared memory, device) is worked out once:
// the decode step launches these kernels once per layer.
template <typename Args>
cudaError_t launch_coop(void (*kernel)(const Args), const Args& args,
                        size_t smem, cudaStream_t stream) {
  struct Grid {
    void (*kernel)(const Args);
    size_t smem;
    int dev, blocks;
  };
  static Grid known[16];
  static int n_known = 0;
  cudaError_t e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  int blocks = 0;
  for (int i = 0; i < n_known; ++i)
    if (known[i].kernel == kernel && known[i].smem == smem &&
        known[i].dev == dev)
      blocks = known[i].blocks;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess)
      return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess)
      return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks = sms * per_sm;
    if (n_known < 16) known[n_known++] = Grid{kernel, smem, dev, blocks};
  }
  void* params[] = {const_cast<Args*>(&args)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                  dim3(blocks), dim3(kThreads), params, smem,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace fused
}  // namespace paddle_tpu_torch

// C interface, bound with ctypes (paddle_tpu_torch/ops/kernels/
// fused_decode_block.py checks shapes, types, contiguity and alignment,
// sizes shared memory and allocates the workspaces first). dtype: 0 =
// float32, 1 = bfloat16; region and smem: the shared-memory layout's
// bytes (file header). The launchers return the launch's cudaError_t.

// ws_t (T): qkv [B][(H+2KV)*hd], then attention rows [P][H*hd][8] at an
// offset rounded up to 8 elements; ws_f (f32): part_m, part_l
// [B*H*splits] each, part_acc [B*H*splits*hd], s_new [B*H].
extern "C" int decode_attn_block(
    const void* x, const void* nw, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* sin, const void* cos,
    const void* k_pool, const void* v_pool, const void* tables,
    const void* seq_lens, void* x_out, void* k_new, void* v_new, void* ws_t,
    void* ws_f, int B, int D, int H, int KV, int hd, int BS, int MB,
    int rope_rows, int residual, int region, int smem, float eps,
    float scale, int dtype, void* stream) {
  using namespace paddle_tpu_torch::fused;
  if (B == 0) return cudaSuccess;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int item = dtype == 1 ? 2 : 4;
  const size_t n_qkv = ((size_t)B * (H + 2 * KV) * hd + 7) / 8 * 8;
  const size_t n_part = (size_t)B * H * splits(MB);
  float* f = static_cast<float*>(ws_f);
  AttnArgs a{x, nw, wq, wk, wv, wo,
             static_cast<const float*>(sin), static_cast<const float*>(cos),
             k_pool, v_pool, static_cast<const int*>(tables),
             static_cast<const int*>(seq_lens), x_out, k_new, v_new, ws_t,
             static_cast<char*>(ws_t) + n_qkv * item, f, f + n_part,
             f + 2 * n_part, f + 2 * n_part + n_part * hd,
             B, D, H, KV, hd, BS, MB, rope_rows, residual, eps, scale,
             (size_t)region};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_coop(decode_attn_block_kernel<__nv_bfloat16>, a, smem, s);
  return launch_coop(decode_attn_block_kernel<float>, a, smem, s);
}

// ff_ws (T): [P][F][8].
extern "C" int decode_mlp_block(const void* x, const void* nw, const void* wg,
                                const void* wu, const void* wd, void* out,
                                void* ff_ws, int B, int D, int F,
                                int residual, int region, int smem,
                                float eps, int dtype, void* stream) {
  using namespace paddle_tpu_torch::fused;
  if (B == 0) return cudaSuccess;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  MlpArgs a{x, nw, wg, wu, wd, out, ff_ws, B, D, F, residual, eps,
            (size_t)region};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_coop(decode_mlp_block_kernel<__nv_bfloat16>, a, smem, s);
  return launch_coop(decode_mlp_block_kernel<float>, a, smem, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
