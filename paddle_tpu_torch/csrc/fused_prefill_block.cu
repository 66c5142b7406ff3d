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
//   bounds [2] int32: (pos0, n_valid), read from device memory by every
//   block at entry, as the TPU kernel reads them from its scalar-prefetch
//   operand (b_ref): a CUDA graph captured over one chunk replays for any
//   history length and any count of real rows
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
// streams the weights again (16 passes at P=128), so these products are
// bound by the CUDA cores' FMA rate, not by bytes. Shared memory, sized by
// the wrapper (ops/kernels/fused_prefill_block.py, from
// fused_decode_block._layout: the one definition of the sizes) and passed
// in, is carved as block_products.cuh describes; the attention scratch is
// that of an item of groups * bq query rows. f32 launches, and bf16 ones
// whose plan refuses the tensor cores, run this body.
//
// The tensor-core body (kTC, bf16, head dim 128: the wrapper's plan picks
// it) moves the work onto mma.sync, one block an SM (the phase functions
// below): 0. the RMSNorm of every real row once into a [P][D] workspace
// | grid sync | 1. q/k/v by column tiles, every row of the chunk
// against each weight tile in one pass (tile_mma.cuh: each weight byte
// read once a launch) | grid sync | 2. RoPE, as above | grid sync | 3.
// attention on the tensor cores (prefill_attn_tc_phase: S exact in bf16 x
// bf16 -> f32, P V from the f32 P as bf16 hi + lo, the warps splitting the
// keys and combining in a fixed order; over int8 pools the history staged
// as codes, converted exactly to bf16, its scales on the f32 sums) | grid
// sync | 4. o_proj by column tiles, + x. The rounding points are the
// CUDA-core body's, but for the int8 history's scales (on the sums, not
// on each code: a roundoff-level difference); otherwise only the
// summation order differs. Its shared memory is prefill_tc_smem's figure,
// which the launcher holds the wrapper's to. Not done yet: wgmma/TMA and
// warp specialisation of the products.
#include "tile_mma.cuh"

namespace paddle_tpu_torch {
namespace fused {

struct PrefillArgs {
  const void *x, *nw, *wq, *wk, *wv, *wo;   // weights: T, int8 or int4
  const float *sq, *sk, *sv, *so;           // f32 [out] scales, or null
  const float *sin, *cos;
  const void *k_pool, *v_pool;           // T, or int8 (KQ)
  const float *k_scale, *v_scale;        // f32 [KV] (int8 pools), or null
  const int* table;
  const int* bounds;                     // int32 [2]: (pos0, n_valid)
  void *x_out, *k_new, *v_new;
  void *qkv_ws, *q_ws, *attn_ws;   // T: [P][(H+2KV)*hd], [P][H*hd],
                                   //    [passes(P)][H*hd][8] ([P][H*hd]
                                   //    in the tensor-core body)
  void* h_ws;                      // the tensor-core body's [P][D] rows
  int P, D, H, KV, hd, BS, MB, bq, residual;
  float eps, scale;
  size_t region;
  // the tile plan (the wrapper's): lanes per weight row (0 in the
  // tensor-core body, whose tiles are kQkvCols / kOCols columns) and tile
  // counts of the q/k/v phase (q_tiles of wq, kv_tiles each of wk and wv)
  // and of o_proj; the tensor-core body's row tiles of kTileRows rows and
  // o_proj's split of H*hd into o_parts parts, with their f32 partial sums
  // [o_parts][P][D]
  int qkv_lpr, q_tiles, kv_tiles, o_lpr, o_tiles, row_tiles, o_parts;
  float* part_ws;
};

// The chunk's (pos0, n_valid), loaded once by each block from the bounds
// buffer; every block reads the same two values.
struct Bounds {
  int pos0, nv;
};

__device__ __forceinline__ Bounds load_bounds(const PrefillArgs& a) {
  return Bounds{__ldg(a.bounds), __ldg(a.bounds + 1)};
}

template <int WQ>
__device__ __forceinline__ float scaled(float v, const float* s, int c) {
  if constexpr (WQ != 0) return v * s[c];
  return v;
}

// 2. RoPE at each real row's own rope row: q -> q_ws, k -> k_new, and
// v -> v_new; zeros in every pad row of k_new, v_new and x_out. A thread
// takes the pair of columns (j, j + hd/2) of one head, which the rotation
// reads together.
template <typename T>
__device__ void prefill_rope_phase(const PrefillArgs& a, const Bounds b) {
  const int P = a.P, D = a.D, H = a.H, KV = a.KV, hd = a.hd;
  const int nv = b.nv;
  const int hd2 = hd / 2;
  const int nq = H * hd, nkv = KV * hd, ncols = nq + 2 * nkv;
  const int npairs = ncols / 2;
  const T* qkv = static_cast<const T*>(a.qkv_ws);
  T* q_ws = static_cast<T*>(a.q_ws);
  T* k_new = static_cast<T*>(a.k_new);
  T* v_new = static_cast<T*>(a.v_new);
  const size_t stride = (size_t)gridDim.x * kThreads;
  const size_t first = (size_t)blockIdx.x * kThreads + threadIdx.x;
  for (size_t i = first; i < (size_t)P * npairs; i += stride) {
    const int r = (int)(i / npairs), pr = (int)(i - (size_t)r * npairs);
    const int j = pr % hd2, c = (pr / hd2) * hd + j;   // columns c, c + hd2
    if (r >= nv) {
      if (c >= nq) {
        T* out = c < nq + nkv ? k_new : v_new;
        const size_t o = (size_t)r * nkv + (c - nq) % nkv;
        out[o] = out[o + hd2] = from_float<T>(0.f);
      }
      continue;
    }
    const T* head = qkv + (size_t)r * ncols + (c - j);
    const float* sn = a.sin + (size_t)r * hd2;
    const float* cs = a.cos + (size_t)r * hd2;
    T* out;
    size_t o;
    if (c < nq) {
      out = q_ws; o = (size_t)r * nq + c;
    } else if (c < nq + nkv) {
      out = k_new; o = (size_t)r * nkv + c - nq;
    } else {
      v_new[(size_t)r * nkv + c - nq - nkv] = head[j];
      v_new[(size_t)r * nkv + c - nq - nkv + hd2] = head[j + hd2];
      continue;
    }
    out[o] = from_float<T>(rope_at<T>(head, j, hd2, sn, cs));
    out[o + hd2] = from_float<T>(rope_at<T>(head, j + hd2, hd2, sn, cs));
  }
  T* xo = static_cast<T*>(a.x_out);
  for (size_t i = (size_t)nv * D + first; i < (size_t)P * D; i += stride)
    xo[i] = from_float<T>(0.f);
}

// 3. attention per (query block, KV head) on the CUDA cores: the history
// pages, then the chunk's own K/V under the causal mask; the rows go to
// attn_ws k-major by pass (the CUDA-core o_proj's operand)
template <typename T, bool KQ>
__device__ void prefill_attn_cc_phase(const PrefillArgs& a, const Bounds b,
                                      unsigned char* smem) {
  using Pt = PoolT<T, KQ>;                 // the pools' type
  constexpr int V = Vec<T>::n;
  constexpr int PV = 16 / sizeof(Pt);      // pool elements a 16-byte load
  const int H = a.H, KV = a.KV, hd = a.hd, BS = a.BS;
  const int nv = b.nv, pos0 = b.pos0, bq = a.bq;
  const int tid = threadIdx.x;
  const int groups = H / KV;
  const int nq = H * hd;
  T* attn_t = static_cast<T*>(a.attn_ws);
  const T* q_ws = static_cast<const T*>(a.q_ws);
  const T* k_new = static_cast<const T*>(a.k_new);
  const T* v_new = static_cast<const T*>(a.v_new);
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
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16, head dim kHd; the wrapper's plan picks it):
// RMSNorm of every real row once -> h_ws | q/k/v by kQkvCols-column
// tiles over all rows (tile_mma.cuh) | RoPE | attention | o_proj by
// kOCols-column tiles over all rows, split over H*hd into o_parts parts
// when its tiles are fewer than the SMs (| grid sync | the parts added in
// order), + x. The attention runs on the tensor cores too
// (prefill_attn_tc_phase), over fp and int8 pools.
// ---------------------------------------------------------------------------
constexpr int kQkvCols = 64;                 // q/k/v's column tiles
constexpr int kOCols = 64;                   // o_proj's
constexpr int kHd = 128;                     // head dim of the tc attention
constexpr int kQRows = 16;                   // query rows of an item (BQ)
constexpr int kSlice = 16;                   // keys a warp takes a step
constexpr int kKeyStep = kWarps * kSlice;    // keys a step
constexpr int kLdH = kHd + 8;                // bf16 a staged head row

// Shared memory of the tensor-core attention: the item's Q [16][kLdH],
// two stages of K and V [kKeyStep][kLdH] (bf16; a history step over int8
// pools stages its codes [kKeyStep][kHd] bytes in the same place), and
// over int8 pools (kq) each warp's K and V rows converted to bf16
// [kWarps][2][kSlice][kLdH]; the warps' (m, l, acc) for the combine reuse
// the stages.
__host__ __device__ constexpr size_t attn_tc_bytes(bool kq) {
  return (size_t)(kQRows + 2 * 2 * kKeyStep + (kq ? 2 * kKeyStep : 0)) *
         kLdH * sizeof(bf16);
}

// Shared memory of the tensor-core body: the larger of its product
// layout (one weight a tile) and its attention phase's
inline size_t prefill_tc_smem(int wbits, int kvbits) {
  const size_t prod =
      wbits == 8   ? std::max(tile_smem_bytes<kWInt8, 1, kQkvCols>(),
                              tile_smem_bytes<kWInt8, 1, kOCols>())
      : wbits == 4 ? std::max(tile_smem_bytes<kWInt4K, 1, kQkvCols>(),
                              tile_smem_bytes<kWInt4K, 1, kOCols>())
                   : std::max(tile_smem_bytes<kWFp, 1, kQkvCols>(),
                              tile_smem_bytes<kWFp, 1, kOCols>());
  return std::max(prod, attn_tc_bytes(kvbits != 0));
}

// 1. q/k/v of the real rows by kQkvCols-column tiles of wq (q_tiles), wk
// and wv (kv_tiles each), every row of a row tile at once; each scaled sum
// cast to bf16 -> qkv_ws
template <int WQ>
__device__ void prefill_tc_qkv_phase(const PrefillArgs& a, const Bounds b,
                                     unsigned char* smem) {
  constexpr int WC = wclass(WQ, false);
  const int nq = a.H * a.hd, nkv = a.KV * a.hd, ncols = nq + 2 * nkv;
  const int tq = a.q_tiles, tk = a.kv_tiles, tiles = tq + 2 * tk;
  const bf16* h = static_cast<const bf16*>(a.h_ws);
  bf16* qkv = static_cast<bf16*>(a.qkv_ws);
  for (int item = blockIdx.x; item < a.row_tiles * tiles;
       item += gridDim.x) {
    const int t = item % tiles, r0 = (item / tiles) * kTileRows;
    const int rows = min(kTileRows, b.nv - r0);
    if (rows <= 0) continue;   // block-uniform: a tile of pad rows
    const void* W;
    const float* S;
    int col0, n, base;
    if (t < tq) {
      W = a.wq; S = a.sq; col0 = t * kQkvCols; n = nq; base = 0;
    } else if (t < tq + tk) {
      W = a.wk; S = a.sk; col0 = (t - tq) * kQkvCols; n = nkv; base = nq;
    } else {
      W = a.wv; S = a.sv; col0 = (t - tq - tk) * kQkvCols; n = nkv;
      base = nq + nkv;
    }
    const unsigned char* Wp[1] = {static_cast<const unsigned char*>(W)};
    const TileJob j{h, a.D, r0, rows, a.D, col0, n};
    tile_product<WC, 1, kQkvCols>(j, Wp, row_bytes<bf16, WC>(n), smem,
                                  [&](int r, int c, const float* v) {
      qkv[(size_t)r * ncols + base + c] =
          __float2bfloat16(scaled<WQ>(v[0], S, c));
    });
  }
}

// 16 keys' rows of kHd int8 codes (kHd bytes a row) as bf16 rows
// [16][kLdH], exactly; one warp, four codes a lane at a time
__device__ __forceinline__ void codes_rows_bf16(const unsigned char* src,
                                                bf16* dst, int lane) {
#pragma unroll 4
  for (int i = lane; i < kSlice * kHd / 4; i += 32) {
    const int r = i / (kHd / 4), c = (i % (kHd / 4)) * 4;
    const uint32_t v = *reinterpret_cast<const uint32_t*>(src + r * kHd + c);
    uint2 o;
    o.x = s8x2_bf16(v, 0, 1);
    o.y = s8x2_bf16(v, 2, 3);
    *reinterpret_cast<uint2*>(dst + r * kLdH + c) = o;
  }
}

// 3. attention on the tensor cores. Items: (16-row query block, query
// head), the heads of a KV head adjacent. Keys: the history (positions <
// pos0, through the table, fetches clamped to its last page) and then the
// chunk's own rows c < min(q0 + 16, n_valid), 128 a step in two cp.async
// stages (a masked or missing key staged as zeros); warp w takes keys
// [16w, 16w + 16) of each step. S = Q K^T on mma.sync (bf16 operands,
// exact products; each depth step summed from zero and added in f32),
// times the scale; row r sees every history key and chunk key c iff c <=
// min(r, n_valid - 1); the warp's online softmax in f32 (expf; a row that
// sees no key of a step keeps its state); P V from the f32 P as bf16 hi +
// lo (the flash backward's dV scheme: within 2^-16 of P), each step's
// product summed from zero and added to acc * alpha. The 8 warps' (m, l,
// acc) are then combined in warp order (no atomics) and normalised ->
// attn_ws [P][H*hd] (bf16), real rows only.
// KQ (int8 pools): the history's steps come first, each holding history
// keys only, staged as int8 codes (half the bytes); each warp converts its
// 16 keys' K and V codes exactly to bf16 rows of its own, and the scales
// leave the per-code product for the f32 sums: S = k_scale[kvh] * (Q
// codes^T), then the softmax scale; the step's P V product (summed from
// zero) times v_scale[kvh] is added to acc * alpha. The chunk's own steps
// follow, its K/V in bf16 with scale 1 (the caller's pool write quantizes
// them).
template <bool KQ>
__device__ void prefill_attn_tc_phase(const PrefillArgs& a, const Bounds b,
                                      unsigned char* smem) {
  const int H = a.H, KV = a.KV, BS = a.BS;
  const int nv = b.nv, pos0 = b.pos0;
  const int groups = H / KV, nq = H * kHd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  bf16* q_s = reinterpret_cast<bf16*>(smem);   // [16][kLdH]
  bf16* kv_s = q_s + kQRows * kLdH;            // [2][K, V][kKeyStep][kLdH]
  // KQ: this warp's converted K and V rows [2][kSlice][kLdH]
  bf16* kt_s = kv_s + (size_t)2 * 2 * kKeyStep * kLdH +
               (size_t)warp * 2 * kSlice * kLdH;
  bf16* vt_s = kt_s + kSlice * kLdH;
  float* m_s = reinterpret_cast<float*>(kv_s); // combine: [8][16] m, l,
  float* l_s = m_s + kWarps * kQRows;          // [8][16][kHd] acc
  float* acc_s = l_s + kWarps * kQRows;
  const bf16* q_ws = static_cast<const bf16*>(a.q_ws);
  const bf16* k_new = static_cast<const bf16*>(a.k_new);
  const bf16* v_new = static_cast<const bf16*>(a.v_new);
  const bf16* k_pool = static_cast<const bf16*>(a.k_pool);
  const bf16* v_pool = static_cast<const bf16*>(a.v_pool);
  bf16* attn = static_cast<bf16*>(a.attn_ws);
  const int nqb = cdiv(nv, kQRows);
  for (int item = blockIdx.x; item < nqb * H; item += gridDim.x) {
    const int gi = item % groups, kvh = (item / groups) % KV;
    const int q0 = (item / (groups * KV)) * kQRows;
    const int h = kvh * groups + gi;
    const int nk = pos0 + min(q0 + kQRows, nv);   // keys this block sees
    // KQ: hs history steps (keys st * kKeyStep on), then the chunk's
    // (keys pos0 + (st - hs) * kKeyStep on)
    const int hs = KQ ? cdiv(pos0, kKeyStep) : 0;
    const int steps =
        KQ ? hs + cdiv(nk - pos0, kKeyStep) : cdiv(nk, kKeyStep);
    const float ksc = KQ ? a.k_scale[kvh] : 1.f;
    const float vsc = KQ ? a.v_scale[kvh] : 1.f;
    __syncthreads();   // the previous item's combine is done with smem
    {
      const int r = threadIdx.x >> 4, c = (threadIdx.x & 15) * 8;
      const bool ok = q0 + r < nv;
      cp_async16(q_s + r * kLdH + c,
                 ok ? q_ws + (size_t)(q0 + r) * nq + h * kHd + c : q_ws, ok);
    }
    auto first_key = [&](int step) {
      return KQ && step >= hs ? pos0 + (step - hs) * kKeyStep
                              : step * kKeyStep;
    };
    // key i of a step: K rows by threads 0-127, V rows by 128-255
    auto stage = [&](int step, int buf) {
      const int i = threadIdx.x & (kKeyStep - 1), v = threadIdx.x >> 7;
      const int key = first_key(step) + i;
      bf16* dst = kv_s + ((size_t)(buf * 2 + v) * kKeyStep + i) * kLdH;
      if (KQ && step < hs) {   // codes, kHd bytes a key
        const signed char* src = nullptr;
        if (key < pos0) {
          const size_t page =
              (size_t)a.table[clamped_page_index(pos0, BS, key / BS)];
          src = static_cast<const signed char*>(v ? a.v_pool : a.k_pool) +
                ((page * BS + key % BS) * KV + kvh) * kHd;
        }
        unsigned char* d8 =
            reinterpret_cast<unsigned char*>(kv_s +
                                             (size_t)(buf * 2 + v) *
                                                 kKeyStep * kLdH) +
            (size_t)i * kHd;
#pragma unroll
        for (int c = 0; c < kHd; c += 16)
          cp_async16(d8 + c, src ? static_cast<const void*>(src + c) : q_ws,
                     src != nullptr);
        return;
      }
      const bf16* src = nullptr;
      if (key < pos0) {
        const size_t page =
            (size_t)a.table[clamped_page_index(pos0, BS, key / BS)];
        src = (v ? v_pool : k_pool) +
              ((page * BS + key % BS) * KV + kvh) * kHd;
      } else if (key < nk) {
        src = (v ? v_new : k_new) + ((size_t)(key - pos0) * KV + kvh) * kHd;
      }
#pragma unroll
      for (int c = 0; c < kHd; c += 8)
        cp_async16(dst + c, src ? src + c : q_ws, src != nullptr);
    };
    stage(0, 0);
    cp_async_commit();
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
    float acc[kHd / 8][4];
#pragma unroll
    for (int n = 0; n < kHd / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int st = 0; st < steps; ++st) {
      const int buf = st & 1;
      const bool codes = KQ && st < hs;   // block-uniform
      if (st + 1 < steps) stage(st + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait1();   // Q and this step have landed
      __syncthreads();
      const int j0 = first_key(st) + warp * kSlice;
      if (j0 < (codes ? pos0 : nk)) {   // warp-uniform
        const bf16* ks = kv_s + ((size_t)(buf * 2) * kKeyStep +
                                 warp * kSlice) * kLdH;
        const bf16* vs = ks + (size_t)kKeyStep * kLdH;
        if (codes) {
          const unsigned char* c8 = reinterpret_cast<const unsigned char*>(
              kv_s + (size_t)(buf * 2) * kKeyStep * kLdH);
          __syncwarp();   // the warp's reads of its previous rows are done
          codes_rows_bf16(c8 + (size_t)warp * kSlice * kHd, kt_s, lane);
          codes_rows_bf16(c8 + (size_t)kKeyStep * kLdH * sizeof(bf16) +
                              (size_t)warp * kSlice * kHd,
                          vt_s, lane);
          __syncwarp();
          ks = kt_s;
          vs = vt_s;
        }
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 1
        for (int kk = 0; kk < kHd / 16; ++kk) {
          uint32_t aq[4], bk[4];
          ldmatrix4(aq, q_s + (lane & 15) * kLdH + kk * 16 +
                            (lane >> 4) * 8);
          ldmatrix4(bk, ks + ((lane & 7) + ((lane >> 4) << 3)) * kLdH +
                            kk * 16 + ((lane >> 3) & 1) * 8);
          mma2_rn(s[0], s[1], aq, bk);
        }
        // element e of tile n: query row q0 + g + 8 (e >> 1), key j0 + 8n
        // + 2 t4 + (e & 1)
        uint32_t ok = 0;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j0 + n * 8 + 2 * t4 + (e & 1);
            const int row = q0 + g + 8 * (e >> 1);
            bool seen;
            float v = s[n][e];
            if constexpr (KQ) {
              if (codes) {
                seen = key < pos0;
                v = __fmul_rn(v, ksc);   // the history's scale, then S's
              } else {
                seen = key < nk && key - pos0 <= min(row, nv - 1);
              }
            } else {
              seen = key < pos0 ||
                     (key < nk && key - pos0 <= min(row, nv - 1));
            }
            ok |= (uint32_t)seen << (4 * n + e);
            s[n][e] = seen ? __fmul_rn(v, a.scale) : -CUDART_INF_F;
          }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mc = fmaxf(fmaxf(s[0][2 * i], s[0][2 * i + 1]),
                           fmaxf(s[1][2 * i], s[1][2 * i + 1]));
          mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
          mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
          const float mn = fmaxf(m[i], mc);
          // 0 on a row's first keys (m -inf); 1 while it has seen none
          alpha[i] = mn == -CUDART_INF_F ? 1.f : expf(m[i] - mn);
          m[i] = mn;
        }
        float ps[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                ok >> (4 * n + e) & 1 ? expf(s[n][e] - m[e >> 1]) : 0.f;
            ps[e >> 1] += p;
            s[n][e] = p;
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 1);
          ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 2);
          l[i] = alpha[i] * l[i] + ps[i];
        }
        uint32_t phi[4], plo[4];
        a_frag_split(s[0], s[1], phi, plo);
#pragma unroll
        for (int n = 0; n < kHd / 8; n += 2) {
          uint32_t b[4];
          ldmatrix4_trans(b, vs + (lane & 15) * kLdH + n * 8 +
                                 (lane >> 4) * 8);
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
          mma2(t0, t1, phi, b);
          mma2(t0, t1, plo, b);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (KQ) {
              if (codes) {   // the history's scale on the step's product
                t0[e] = __fmul_rn(t0[e], vsc);
                t1[e] = __fmul_rn(t1[e], vsc);
              }
            }
            acc[n][e] = acc[n][e] * alpha[e >> 1] + t0[e];
            acc[n + 1][e] = acc[n + 1][e] * alpha[e >> 1] + t1[e];
          }
        }
      }
      __syncthreads();   // every warp is done with this stage
    }
    cp_async_wait0();
    // the warps' states, then the combine in warp order
    if (t4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m_s[warp * kQRows + g + 8 * i] = m[i];
        l_s[warp * kQRows + g + 8 * i] = l[i];
      }
    }
#pragma unroll
    for (int n = 0; n < kHd / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc_s[(warp * kQRows + g + 8 * (e >> 1)) * kHd + n * 8 + 2 * t4 +
              (e & 1)] = acc[n][e];
    __syncthreads();
    for (int i = threadIdx.x; i < kQRows * kHd; i += kThreads) {
      const int r = i / kHd, d = i - r * kHd;
      if (q0 + r >= nv) continue;
      float mx = -CUDART_INF_F;
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * kQRows + r]);
      // every real row saw its own key, so mx is finite and sum > 0
      float sum = 0.f, o = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(m_s[w * kQRows + r] - mx);
        sum += f * l_s[w * kQRows + r];
        o += f * acc_s[(w * kQRows + r) * kHd + d];
      }
      attn[(size_t)(q0 + r) * nq + h * kHd + d] = __float2bfloat16(o / sum);
    }
  }
}

// o_proj's epilogue of output (r, c) from its f32 sum: scaled, cast to
// bf16, then + x in bf16 (no add when residual is 0)
template <int WQ>
__device__ __forceinline__ void prefill_o_out(const PrefillArgs& a, int r,
                                              int c, float v) {
  const size_t o = (size_t)r * a.D + c;
  const float d = round_t<bf16>(scaled<WQ>(v, a.so, c));
  static_cast<bf16*>(a.x_out)[o] = __float2bfloat16(
      a.residual ? to_float(static_cast<const bf16*>(a.x)[o]) + d : d);
}

// 5. o_proj of the real rows by kOCols-column tiles of D, every row of a
// row tile at once, H*hd split into o_parts parts: the output, or with
// parts the f32 partial sums
template <int WQ>
__device__ void prefill_tc_o_phase(const PrefillArgs& a, const Bounds b,
                                   unsigned char* smem) {
  constexpr int WC = wclass(WQ, false);
  const int nq = a.H * a.hd, D = a.D, tiles = a.o_tiles;
  const int parts = a.o_parts;
  const unsigned char* Wp[1] = {static_cast<const unsigned char*>(a.wo)};
  for (int item = blockIdx.x; item < a.row_tiles * parts * tiles;
       item += gridDim.x) {
    const int t = item % tiles, p = (item / tiles) % parts;
    const int r0 = (item / (tiles * parts)) * kTileRows;
    const int rows = min(kTileRows, b.nv - r0);
    if (rows <= 0) continue;
    const TileJob j{static_cast<const bf16*>(a.attn_ws), nq, r0, rows, nq,
                    t * kOCols, D, p, parts};
    tile_product<WC, 1, kOCols>(j, Wp, row_bytes<bf16, WC>(D), smem,
                                [&](int r, int c, const float* v) {
      if (parts > 1)
        a.part_ws[((size_t)p * a.P + r) * D + c] = v[0];
      else
        prefill_o_out<WQ>(a, r, c, v[0]);
    });
  }
}

// 6. with o_parts > 1: each real row's outputs, parts added in part order,
// then o_proj's epilogue; four outputs a thread (D is a multiple of 32)
template <int WQ>
__device__ void prefill_tc_combine_phase(const PrefillArgs& a,
                                         const Bounds b) {
  const int n4 = a.P * a.D / 4, real4 = b.nv * a.D / 4;
  const float4* part = reinterpret_cast<const float4*>(a.part_ws);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < real4;
       i += gridDim.x * kThreads) {
    float4 v = part[i];
    for (int p = 1; p < a.o_parts; ++p) {
      const float4 w = part[p * n4 + i];
      v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
    }
    const int r = 4 * i / a.D, c = 4 * i - r * a.D;
    prefill_o_out<WQ>(a, r, c, v.x);
    prefill_o_out<WQ>(a, r, c + 1, v.y);
    prefill_o_out<WQ>(a, r, c + 2, v.z);
    prefill_o_out<WQ>(a, r, c + 3, v.w);
  }
}

// kTC: the tensor-core body (bf16; the file header), one block an SM.
template <typename T, int WQ, bool KQ, bool kTC = false>
__global__ void __launch_bounds__(kThreads, kTC ? 1 : 2)
prefill_attn_block_kernel(const PrefillArgs a) {
  constexpr int V = Vec<T>::n;
  constexpr int WC = wclass(WQ, false);
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = a.P, D = a.D, H = a.H, KV = a.KV, hd = a.hd, BS = a.BS;
  const Bounds b = load_bounds(a);
  const int nv = b.nv;
  const int tid = threadIdx.x;
  const int nq = H * hd, nkv = KV * hd, ncols = nq + 2 * nkv;
  T* region = reinterpret_cast<T*>(smem);
  float* red_s = reinterpret_cast<float*>(smem + a.region);
  float* res_s = red_s + kWarps * kMaxLpr * V * kRB;
  T* qkv = static_cast<T*>(a.qkv_ws);
  T* attn_t = static_cast<T*>(a.attn_ws);
  cg::grid_group grid = cg::this_grid();
  if constexpr (kTC) {
    norm_rows(static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.nw),
              static_cast<bf16*>(a.h_ws), nv, D, a.eps,
              reinterpret_cast<float*>(smem));
    grid.sync();
    prefill_tc_qkv_phase<WQ>(a, b, smem);
    grid.sync();
    prefill_rope_phase<T>(a, b);
    grid.sync();
    prefill_attn_tc_phase<KQ>(a, b, smem);
    grid.sync();
    prefill_tc_o_phase<WQ>(a, b, smem);
    if (a.o_parts > 1) {   // grid-uniform
      grid.sync();
      prefill_tc_combine_phase<WQ>(a, b);
    }
  } else {
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
    prefill_rope_phase<T>(a, b);
    grid.sync();
    prefill_attn_cc_phase<T, KQ>(a, b, smem);
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
}

PADDLE_TPU_PICK_KV_KERNEL(prefill_kernel, prefill_attn_block_kernel,
                          PrefillArgs)

// The tensor-core body for (dtype, weight bits, pool bits): bf16 only
inline KernelFn<PrefillArgs> prefill_tc_kernel(int dtype, int wbits,
                                               int kvbits) {
  if (dtype != 1 || (kvbits != 0 && kvbits != 8)) return nullptr;
  const bool kq = kvbits == 8;
  if (wbits == 0)
    return kq ? &prefill_attn_block_kernel<bf16, 0, true, true>
              : &prefill_attn_block_kernel<bf16, 0, false, true>;
  if (wbits == 8)
    return kq ? &prefill_attn_block_kernel<bf16, 8, true, true>
              : &prefill_attn_block_kernel<bf16, 8, false, true>;
  if (wbits == 4)
    return kq ? &prefill_attn_block_kernel<bf16, 4, true, true>
              : &prefill_attn_block_kernel<bf16, 4, false, true>;
  return nullptr;
}

// The body ``body`` (0 CUDA cores, 1 tensor cores) for the classes
inline KernelFn<PrefillArgs> prefill_body(int body, int dtype, int wbits,
                                          int kvbits) {
  return body == 1   ? prefill_tc_kernel(dtype, wbits, kvbits)
         : body == 0 ? prefill_kernel(dtype, wbits, kvbits)
                     : nullptr;
}

}  // namespace fused
}  // namespace paddle_tpu_torch

// C interface, bound with ctypes (paddle_tpu_torch/ops/kernels/
// fused_prefill_block.py checks shapes, types, contiguity, alignment and
// the chunk geometry, sizes shared memory and allocates the outputs and
// workspaces first). dtype: 0 = float32, 1 = bfloat16; wbits: the
// weights' class, 0 = T, 8 = int8, 4 = int4 packed along the contraction
// axis, with the f32 scale pointers s* (null for 0); kvbits: the pools'
// class, 0 = T, 8 = int8 with the f32 [KV] scale pointers k_scale/v_scale
// (null for 0); body: 0 the CUDA-core body, 1 the tensor-core body (its
// h_ws: the normalised rows [P][D] bf16, then o_proj's f32 partial sums
// [o_parts][P][D] at an offset rounded up to 16 bytes); region
// and smem: the shared-memory layout's bytes; bounds: int32 [2] on the
// device, (pos0, n_valid) with pos0's history within the table's MB pages
// and 1 <= n_valid <= P (the wrapper checks the host values it writes
// there; the kernel reads them at run time, so they are not checked
// here); bq: query rows a work item takes (P is a multiple of it); grid
// and the tile plan: the wrapper's, as
// for fused_decode_block.cu's launchers (a grid other than the body's
// cooperative grid, prefill_coop_grid, or a plan the body cannot run is
// refused: the tensor-core body takes bf16, head dim 128, bq 16, lanes 0,
// kQkvCols / kOCols column tiles, row tiles of 128 and prefill_tc_smem's
// shared memory).
// Returns the launch's cudaError_t; a (dtype, wbits, kvbits, body) it does
// not take is cudaErrorInvalidValue.

// The cooperative grid of the body for (dtype, wbits, kvbits) at ``smem``
// bytes of dynamic shared memory a block; minus the cudaError_t on
// failure.
extern "C" int prefill_coop_grid(int dtype, int wbits, int kvbits, int body,
                                 int smem) {
  using namespace paddle_tpu_torch::fused;
  return coop_grid_or_error(prefill_body(body, dtype, wbits, kvbits), smem);
}

extern "C" int prefill_attn_block(
    const void* x, const void* nw, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* sq, const void* sk,
    const void* sv, const void* so, const void* sin, const void* cos,
    const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* table, const void* bounds, void* x_out,
    void* k_new, void* v_new, void* qkv_ws, void* q_ws, void* attn_ws,
    void* h_ws, int P, int D, int H, int KV, int hd, int BS, int MB,
    int bq, int residual, int region, int smem, int wbits, int kvbits,
    int grid, int body, int row_tiles, int o_parts, int qkv_lpr,
    int q_tiles, int kv_tiles, int o_lpr, int o_tiles, float eps,
    float scale, int dtype, void* stream) {
  using namespace paddle_tpu_torch::fused;
  const auto kernel = prefill_body(body, dtype, wbits, kvbits);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  if (bounds == nullptr || bq < 1 || P % bq) return cudaErrorInvalidValue;
  if (body == 1) {
    if (hd != kHd || bq != kQRows || qkv_lpr != 0 || o_lpr != 0 ||
        q_tiles != cdiv(H * hd, kQkvCols) ||
        kv_tiles != cdiv(KV * hd, kQkvCols) ||
        o_tiles != cdiv(D, kOCols) || row_tiles != cdiv(P, kTileRows) ||
        D % 32 || o_parts < 1 || o_parts > 8 ||
        (size_t)smem != prefill_tc_smem(wbits, kvbits))
      return cudaErrorInvalidValue;
  } else if (!plan_ok(qkv_lpr, q_tiles) || !plan_ok(qkv_lpr, kv_tiles) ||
             !plan_ok(o_lpr, o_tiles)) {
    return cudaErrorInvalidValue;
  }
  PrefillArgs a{x, nw, wq, wk, wv, wo,
                static_cast<const float*>(sq), static_cast<const float*>(sk),
                static_cast<const float*>(sv), static_cast<const float*>(so),
                static_cast<const float*>(sin), static_cast<const float*>(cos),
                k_pool, v_pool, static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale),
                static_cast<const int*>(table),
                static_cast<const int*>(bounds), x_out, k_new, v_new, qkv_ws,
                q_ws, attn_ws, h_ws, P, D, H, KV, hd, BS, MB, bq, residual,
                eps, scale, (size_t)region,
                qkv_lpr, q_tiles, kv_tiles, o_lpr, o_tiles, row_tiles,
                body == 1 ? o_parts : 1,
                body == 1 ? reinterpret_cast<float*>(
                                static_cast<char*>(h_ws) +
                                ((size_t)P * D * sizeof(bf16) + 15) / 16 * 16)
                          : nullptr};
  return launch_coop(kernel, a, smem, grid, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
