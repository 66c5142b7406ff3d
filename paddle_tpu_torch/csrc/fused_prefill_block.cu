// Fused prefill attention block for Hopper (sm_90a): one launch for the
// attention half of a LLaMA decoder layer over one prompt chunk of one
// request.
//
// prefill_attn_block replaces paddle_tpu/ops/pallas/fused_prefill_block.py's
// fused_prefill_attn_pallas (body _prefill_attn_kernel, launch
// "prefill_attn_block"):
//   x [P, D] (the first n_valid rows are the prompt, the rest bucket
//   padding), nw [D], wq [D, H*hd], wk/wv [D, KV*hd], wo [H*hd, D] (type T)
//   sin/cos [P, hd/2] f32: the rope rows of positions pos0..pos0+P-1
//   pools [N, BS, KV, hd] (T), table [MB] int32 (the request's pages)
//   -> x_out = x + o_proj(attn) [P, D] (o_proj alone when residual is 0),
//   k_new (roped) / v_new [P, KV, hd]; no pool write.
// Real row r (r < n_valid, position pos0 + r) attends to every history
// position < pos0, read from the pools through the table, and to the
// chunk's own rows c <= r. Rows at or after n_valid skip all compute and
// are written as zeros (x_out, k_new, v_new): a pad row's output is left
// open by the contract, and zeros keep every row finite at every depth.
// The weights may be T, int8 or int4 packed along the contraction axis,
// with an f32 scale per output column (the JAX kernel's wq_bits body): the
// kernel streams the integers and multiplies each reduced f32 sum by its
// column's scale before the cast to T (q/k/v before RoPE, o before the
// residual add), as fused_decode_block.cu's phases do (its header lists
// the decisions; block_products.cuh's weight classes do the loads).
// The pools may be int8 with static per-head f32 scales k_scale/v_scale
// [KV] (the int8 KV cache, kvbits 8; the JAX kernel's quant body): the
// history pages are staged in shared memory as int8 (16 codes a 16-byte
// load) and each code is dequantized in f32, float(q) * s, before its
// product (online_softmax.cuh's kv_float); the dequantized history stays
// f32, as in the JAX kernel (its composition casts it to the model type
// first). The chunk's own K/V are not quantized inside the kernel: they
// are staged in T, as for fp pools, and only the caller's pool write
// quantizes them.
// T is float or __nv_bfloat16. The rounding order is the plain version's
// (ops/kernels/fused_prefill_block.py: prefill_attn_block_wq_ref, which is
// prefill_attn_block_ref on plain weights up to summation order): RMSNorm in
// f32, cast to T before the weight multiply; every projection lands in T;
// RoPE in f32 on the T value, then T; the chunk's K/V are T before the
// chunk attends to them; the attention output is T before o_proj; the
// residual add in T.
//
// What bounds it on the H100: memory. A 128-row bf16 chunk at LLaMA-7B
// reads 134 MB of weights for 2 * 128 flops per weight, ~128 flops a byte,
// under the card's ~295 flops/byte ridge (P <= 128 is below it in bf16).
// So, as in the decode kernels (fused_decode_block.cu), the launch is ONE
// cooperative grid whose blocks split each phase and meet at grid-wide
// barriers:
//   1. QKV products of the real rows by column tiles (block_products.cuh's
//      tile routine, one pass of 8 normalised rows resident) -> workspace
//   | grid sync | 2. RoPE of q (-> workspace) and k (-> k_new), v -> v_new;
//      zeros in the pad rows of x_out, k_new and v_new
//   | grid sync | 3. attention, one work item per (query block of bq rows,
//      KV head) that holds a real row: the item's groups * bq query rows in
//      f32 in shared memory; the history pages streamed 4 a step through
//      online_softmax_page_update (seq_len = pos0, page fetches clamped to
//      the last history page); then the chunk's own K/V folded in by
//      online_softmax_chunk_update under the causal mask; normalised
//      -> workspace (T, k-major by pass)
//   | grid sync | 4. o_proj of the real rows by column tiles, + x.
// No atomics: two launches give identical bits. Every pass of 8 rows
// streams the weights again (16 passes at P=128), so the products are
// bound by the CUDA cores' FMA rate, not by bytes: this design is right
// and simple first. Not done yet (later work): tensor-core (wgmma) products
// that take the chunk's rows in one pass over the weights, and a
// cp.async/TMA pipeline of the weight and page streams.
//
// Shared memory, sized by the wrapper (ops/kernels/fused_prefill_block.py,
// from fused_decode_block._layout: the one definition of the sizes) and
// passed in, is carved as block_products.cuh describes; the attention
// scratch is that of an item of groups * bq query rows.
#include "block_products.cuh"

namespace paddle_tpu_torch {
namespace fused {

struct PrefillArgs {
  const void *x, *nw, *wq, *wk, *wv, *wo;   // weights: T, int8 or int4
  const float *sq, *sk, *sv, *so;           // f32 [out] scales, or null
  const float *sin, *cos;
  const void *k_pool, *v_pool;           // T, or int8 (KQ)
  const float *k_scale, *v_scale;        // f32 [KV] (int8 pools), or null
  const int* table;
  void *x_out, *k_new, *v_new;
  void *qkv_ws, *q_ws, *attn_ws;   // T: [P][(H+2KV)*hd], [P][H*hd],
                                   //    [passes(P)][H*hd][8]
  int P, D, H, KV, hd, BS, MB, pos0, n_valid, bq, residual;
  float eps, scale;
  size_t region;
  // the tile plan (the wrapper's): lanes per weight row and tile counts of
  // the q/k/v phase (q_tiles of wq, kv_tiles each of wk and wv) and of
  // o_proj
  int qkv_lpr, q_tiles, kv_tiles, o_lpr, o_tiles;
};

template <int WQ>
__device__ __forceinline__ float scaled(float v, const float* s, int c) {
  if constexpr (WQ != 0) return v * s[c];
  return v;
}

template <typename T, int WQ, bool KQ>
__global__ void __launch_bounds__(kThreads, 2)
prefill_attn_block_kernel(const PrefillArgs a) {
  using Pt = PoolT<T, KQ>;                 // the pools' type
  constexpr int V = Vec<T>::n;
  constexpr int PV = 16 / sizeof(Pt);      // pool elements a 16-byte load
  constexpr int WC = wclass(WQ, false);
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = a.P, D = a.D, H = a.H, KV = a.KV, hd = a.hd, BS = a.BS;
  const int nv = a.n_valid, pos0 = a.pos0, bq = a.bq;
  const int tid = threadIdx.x;
  const int groups = H / KV, hd2 = hd / 2;
  const int nq = H * hd, nkv = KV * hd, ncols = nq + 2 * nkv;
  T* region = reinterpret_cast<T*>(smem);
  float* red_s = reinterpret_cast<float*>(smem + a.region);
  float* res_s = red_s + kWarps * kMaxLpr * V * kRB;
  T* qkv = static_cast<T*>(a.qkv_ws);
  T* q_ws = static_cast<T*>(a.q_ws);
  T* attn_t = static_cast<T*>(a.attn_ws);
  T* k_new = static_cast<T*>(a.k_new);
  T* v_new = static_cast<T*>(a.v_new);
  cg::grid_group grid = cg::this_grid();

  // 1. q/k/v products of the real rows by column tiles of the three
  // matrices, over the RMSNorm of each pass of rows
  {
    const int lpr = a.qkv_lpr, tc = lpr * V;
    const int tq = a.q_tiles, tk = a.kv_tiles;
    int held = -1;
    const int kn = WC == kWInt4K ? D / 2 : D;   // stored weight rows
    for (int t = blockIdx.x; t < tq + 2 * tk; t += gridDim.x) {
      const void* W;
      const float* S;
      int col0, n, base;
      if (t < tq) {
        W = a.wq; S = a.sq; col0 = t * tc; n = nq; base = 0;
      } else if (t < tq + tk) {
        W = a.wk; S = a.sk; col0 = (t - tq) * tc; n = nkv; base = nq;
      } else {
        W = a.wv; S = a.sv; col0 = (t - tq - tk) * tc; n = nkv;
        base = nq + nkv;
      }
      for (int p = 0; p < passes(nv); ++p) {
        hold_pass<T>(static_cast<const T*>(a.x), static_cast<const T*>(a.nw),
                     region, p, &held, nv, D, a.eps, red_s);
        float acc[kRB][V];
        zero<T>(acc);
        tile_accumulate<T, WC>(acc, region, region + (size_t)kn * kRB, W,
                               row_bytes<T, WC>(n), kn, col0, n, lpr);
        tile_reduce<T>(acc, red_s, res_s, lpr);
        for (int i = tid; i < tc * kRB; i += kThreads) {
          const int c = col0 + i / kRB, r = p * kRB + i % kRB;
          if (r < nv && c < n)
            qkv[(size_t)r * ncols + base + c] =
                from_float<T>(scaled<WQ>(res_s[i], S, c));
        }
        __syncthreads();
      }
    }
  }
  grid.sync();

  // 2. RoPE at each real row's own rope row: q -> q_ws, k -> k_new, and
  // v -> v_new; zeros in every pad row of k_new, v_new and x_out
  {
    const size_t stride = (size_t)gridDim.x * kThreads;
    const size_t first = (size_t)blockIdx.x * kThreads + tid;
    for (size_t i = first; i < (size_t)P * ncols; i += stride) {
      const int r = (int)(i / ncols), c = (int)(i - (size_t)r * ncols);
      const int d = c % hd;
      if (r >= nv) {
        if (c >= nq) {
          T* out = c < nq + nkv ? k_new : v_new;
          out[(size_t)r * nkv + (c - nq) % nkv] = from_float<T>(0.f);
        }
        continue;
      }
      const T* head = qkv + (size_t)r * ncols + (c - d);
      const float* sn = a.sin + (size_t)r * hd2;
      const float* cs = a.cos + (size_t)r * hd2;
      if (c < nq)
        q_ws[(size_t)r * nq + c] = from_float<T>(rope_at<T>(head, d, hd2, sn, cs));
      else if (c < nq + nkv)
        k_new[(size_t)r * nkv + c - nq] =
            from_float<T>(rope_at<T>(head, d, hd2, sn, cs));
      else
        v_new[(size_t)r * nkv + c - nq - nkv] = head[d];
    }
    T* xo = static_cast<T*>(a.x_out);
    for (size_t i = (size_t)nv * D + first; i < (size_t)P * D; i += stride)
      xo[i] = from_float<T>(0.f);
  }
  grid.sync();

  // 3. attention per (query block, KV head): the history pages, then the
  // chunk's own K/V under the causal mask
  {
    const int SB = kPagesPerStep * BS;   // keys a step
    const int R = groups * bq;           // query rows of an item
    float* q_s = reinterpret_cast<float*>(smem);   // [R][hd], row g*bq + r
    float* acc = q_s + R * hd;                      // [R][hd]
    float* s = acc + R * hd;                        // [R][SB]
    float* m = s + R * SB;                          // [R]
    float* l = m + R;
    float* alpha = l + R;
    // the staged tile: the chunk's own K/V in T, or a step of history
    // pages in the pools' type, in the same place
    T* k_s = reinterpret_cast<T*>(q_s + attn_scratch_floats(R, hd, BS));
    T* v_s = k_s + SB * hd;
    Pt* kh_s = reinterpret_cast<Pt*>(k_s);
    Pt* vh_s = kh_s + SB * hd;
    const int row_vecs = hd / V;
    const int nvec = SB * row_vecs;
    const int hrow_vecs = hd / PV;
    const int hvec = SB * hrow_vecs;
    const int n_hist = (pos0 + BS - 1) / BS;       // pages before pos0
    const int nqb = (nv + bq - 1) / bq;            // blocks with a real row
    for (int item = blockIdx.x; item < nqb * KV; item += gridDim.x) {
      const int kvh = item % KV, q0 = (item / KV) * bq;
      const float ks = KQ ? a.k_scale[kvh] : 1.f;
      const float vs = KQ ? a.v_scale[kvh] : 1.f;
      for (int i = tid; i < R * hd; i += kThreads) {
        const int g = i / hd, d = i - g * hd;
        const int r = q0 + g % bq, h = kvh * groups + g / bq;
        q_s[i] = r < nv ? to_float(q_ws[(size_t)r * nq + h * hd + d]) : 0.f;
        acc[i] = 0.f;
      }
      for (int g = tid; g < R; g += kThreads) {
        m[g] = -CUDART_INF_F;
        l[g] = 0.f;
      }
      // the history: positions < pos0, 4 pages a step, fetches past the
      // last history page clamped to it and masked by seq_len = pos0
      for (int pg = 0; pg < n_hist; pg += kPagesPerStep) {
        __syncthreads();
        for (int i0 = tid; i0 < hvec; i0 += 4 * kThreads) {
          uint4 kk[4], vv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * kThreads;
            if (i < hvec) {
              const int t = i / hrow_vecs, c = i - t * hrow_vecs;
              const size_t page =
                  (size_t)a.table[clamped_page_index(pos0, BS, pg + t / BS)];
              const size_t off =
                  ((page * BS + t % BS) * KV + kvh) * hd + (size_t)c * PV;
              kk[u] = *reinterpret_cast<const uint4*>(
                  static_cast<const Pt*>(a.k_pool) + off);
              vv[u] = *reinterpret_cast<const uint4*>(
                  static_cast<const Pt*>(a.v_pool) + off);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * kThreads;
            if (i < hvec) {
              reinterpret_cast<uint4*>(kh_s)[i] = kk[u];
              reinterpret_cast<uint4*>(vh_s)[i] = vv[u];
            }
          }
        }
        __syncthreads();
        online_softmax_page_update<Pt>(q_s, kh_s, vh_s, pg / kPagesPerStep,
                                       SB, pos0, a.scale, R, hd, s, m, l,
                                       alpha, acc, ks, vs);
      }
      // the chunk's own rows c < min(q0 + bq, n_valid), SB keys a tile;
      // keys past n_valid are staged as zeros (and masked)
      const int c_end = min(q0 + bq, nv);
      for (int c0 = 0; c0 < c_end; c0 += SB) {
        __syncthreads();
        for (int i = tid; i < nvec; i += kThreads) {
          const int t = i / row_vecs, c = i - t * row_vecs;
          uint4 kk = make_uint4(0, 0, 0, 0), vv = kk;
          if (c0 + t < nv) {
            const size_t off = ((size_t)(c0 + t) * KV + kvh) * hd +
                               (size_t)c * V;
            kk = *reinterpret_cast<const uint4*>(k_new + off);
            vv = *reinterpret_cast<const uint4*>(v_new + off);
          }
          reinterpret_cast<uint4*>(k_s)[i] = kk;
          reinterpret_cast<uint4*>(v_s)[i] = vv;
        }
        __syncthreads();
        online_softmax_chunk_update<T>(q_s, k_s, v_s, c0, SB, q0, bq, nv - 1,
                                       a.scale, R, hd, s, m, l, alpha, acc);
      }
      __syncthreads();
      // every real row saw its own key, so l > 0
      for (int i = tid; i < R * hd; i += kThreads) {
        const int g = i / hd, d = i - g * hd;
        const int r = q0 + g % bq, col = (kvh * groups + g / bq) * hd + d;
        if (r < nv)
          attn_t[((size_t)(r / kRB) * nq + col) * kRB + r % kRB] =
              from_float<T>(acc[i] / l[g]);
      }
      __syncthreads();   // the next item reuses the scratch
    }
  }
  grid.sync();

  // 4. o_proj of the real rows by column tiles of D, then the residual add
  {
    const int lpr = a.o_lpr, tc = lpr * V;
    const int kc_max = min(nq, (int)(a.region / (sizeof(T) * kRB)));
    const T* x = static_cast<const T*>(a.x);
    T* xo = static_cast<T*>(a.x_out);
    const int tiles = a.o_tiles;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      for (int p = 0; p < passes(nv); ++p) {
        tile_sums_staged<T, WC>(attn_t + (size_t)p * nq * kRB, nq, region,
                                kc_max, a.wo, row_bytes<T, WC>(D), t * tc,
                                D, min(kRB, nv - p * kRB), lpr, red_s,
                                res_s);
        for (int i = tid; i < tc * kRB; i += kThreads) {
          const int c = t * tc + i / kRB, r = p * kRB + i % kRB;
          if (r < nv && c < D) {
            const size_t o = (size_t)r * D + c;
            const float d = round_t<T>(scaled<WQ>(res_s[i], a.so, c));
            xo[o] = from_float<T>(a.residual ? to_float(x[o]) + d : d);
          }
        }
        __syncthreads();
      }
    }
  }
}

PADDLE_TPU_PICK_KV_KERNEL(prefill_kernel, prefill_attn_block_kernel,
                          PrefillArgs)

}  // namespace fused
}  // namespace paddle_tpu_torch

// C interface, bound with ctypes (paddle_tpu_torch/ops/kernels/
// fused_prefill_block.py checks shapes, types, contiguity, alignment and
// the chunk geometry, sizes shared memory and allocates the outputs and
// workspaces first). dtype: 0 = float32, 1 = bfloat16; wbits: the
// weights' class, 0 = T, 8 = int8, 4 = int4 packed along the contraction
// axis, with the f32 scale pointers s* (null for 0); kvbits: the pools'
// class, 0 = T, 8 = int8 with the f32 [KV] scale pointers k_scale/v_scale
// (null for 0); region and smem: the shared-memory layout's bytes; bq:
// query rows a work item takes (P is a multiple of it); grid and the tile
// plan: the wrapper's, as for fused_decode_block.cu's launchers (a grid
// other than the kernel's cooperative grid, prefill_coop_grid, or a plan
// the kernel cannot run is refused). Returns the launch's cudaError_t; a
// (dtype, wbits, kvbits) it does not take is cudaErrorInvalidValue.

// The cooperative grid of the kernel for (dtype, wbits, kvbits) at
// ``smem`` bytes of dynamic shared memory a block; minus the cudaError_t
// on failure.
extern "C" int prefill_coop_grid(int dtype, int wbits, int kvbits,
                                 int smem) {
  using namespace paddle_tpu_torch::fused;
  return coop_grid_or_error(prefill_kernel(dtype, wbits, kvbits), smem);
}

extern "C" int prefill_attn_block(
    const void* x, const void* nw, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* sq, const void* sk,
    const void* sv, const void* so, const void* sin, const void* cos,
    const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* table, void* x_out, void* k_new,
    void* v_new, void* qkv_ws, void* q_ws, void* attn_ws, int P, int D, int H,
    int KV, int hd, int BS, int MB, int pos0, int n_valid, int bq,
    int residual, int region, int smem, int wbits, int kvbits, int grid,
    int qkv_lpr, int q_tiles, int kv_tiles, int o_lpr, int o_tiles,
    float eps, float scale, int dtype, void* stream) {
  using namespace paddle_tpu_torch::fused;
  const auto kernel = prefill_kernel(dtype, wbits, kvbits);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  if (n_valid < 1 || n_valid > P || bq < 1 || P % bq) return cudaErrorInvalidValue;
  if (!plan_ok(qkv_lpr, q_tiles) || !plan_ok(qkv_lpr, kv_tiles) ||
      !plan_ok(o_lpr, o_tiles))
    return cudaErrorInvalidValue;
  PrefillArgs a{x, nw, wq, wk, wv, wo,
                static_cast<const float*>(sq), static_cast<const float*>(sk),
                static_cast<const float*>(sv), static_cast<const float*>(so),
                static_cast<const float*>(sin), static_cast<const float*>(cos),
                k_pool, v_pool, static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale),
                static_cast<const int*>(table), x_out, k_new,
                v_new, qkv_ws, q_ws, attn_ws, P, D, H, KV, hd, BS, MB, pos0,
                n_valid, bq, residual, eps, scale, (size_t)region, qkv_lpr,
                q_tiles, kv_tiles, o_lpr, o_tiles};
  return launch_coop(kernel, a, smem, grid, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
