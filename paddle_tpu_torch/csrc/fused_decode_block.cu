// Fused decode-block kernels for Hopper (sm_90a): one launch for the
// attention half of a LLaMA decoder layer, one for its MLP half, and one
// for the whole layer.
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
// decode_block_fused replaces fused_decode_block_pallas (body
// _block_fused_kernel, launch "decode_block_fused"): both halves in one
// launch, (x, nw, wq, wk, wv, wo, pw, wg, wu, wd, ...) -> (x_out, k_new,
// v_new), the attention-to-MLP residual kept in f32.
// Each weight may be T, int8 or packed int4, with an f32 scale per output
// column (the PTQ harness's leaves, paddle_tpu_torch/quantization/ptq.py);
// the launchers take the scale pointers and the weight bits (0, 8, 4).
// The quantized bodies replace the same JAX kernels' wq_bits bodies
// (paddle_tpu/ops/pallas/fused_decode_block.py, _kernel_weight and the
// epilogue scales of each kernel). Decisions:
//   - the kernels stream the integer weights and convert them to f32 in
//     registers (block_products.cuh's weight classes); the scale multiplies
//     each reduced f32 sum in the epilogue, before the cast to T where the
//     fp kernels cast (q/k/v before RoPE, g/u before SwiGLU, o and down
//     before the residual add; the block kernel adds o * s and down * s to
//     its f32 residual). So they follow dot(h, q) * s, the JAX order, and
//     differ from dequantize-then-matmul (which rounds q * s to T first) by
//     roundoff only;
//   - int8 loads are 8 bytes in bf16 (4 in f32): a thread keeps the fp
//     kernels' 8 output columns and accumulators;
//   - int4 q/k/v/o/gate/up are packed along the contraction axis ([K/2][N]):
//     each packed row multiplies two rows of the k-major operand, k' and
//     k' + K/2, both halves resident (the normalised pass) or staged chunk
//     by chunk (o_proj); int4 down is packed along its output axis
//     ([F][D/2]): the down phase tiles D/2 packed columns and each thread
//     writes two column ranges, with a scale, a residual and a store each;
//   - the load width of every class divides a row of a width the fp kernels
//     take (rows a multiple of 16 bytes in T), so the predicates add only
//     int4's even pack axes; shared memory holds activations only and does
//     not change with the class.
// The pools may be int8 with static per-head f32 scales k_scale/v_scale
// [KV] (the int8 KV cache; the launchers' kvbits 8). Those bodies replace
// the same JAX kernels' quant bodies (_attn_block_kernel and
// _block_fused_kernel with quant=True). Decisions:
//   - a page is staged in shared memory in the pool's type, with 16-byte
//     loads of 16 int8 codes (not Vec<T>::n elements), so the staged pages
//     take half (bf16) or a quarter (f32) of the fp pools' shared memory;
//   - each code is dequantized, float(q) * s, before its product
//     (online_softmax.cuh's kv_float), as the JAX kernels do; factoring the
//     scale out of the dot product would change the rounding;
//   - the new token's k (its score) and v (its P.V term) are
//     clip(round(x / s), -127, 127) * s in f32 (kv_round_trip, IEEE
//     division and half-to-even rounding; the build uses no fast math):
//     the values the unfused step reads back from the pool. k_new/v_new
//     stay raw, in T, for the caller's quantizing pool write.
// T is float or __nv_bfloat16. The two-stage kernels follow the rounding
// order of their plain versions (ops/kernels/fused_decode_block.py:
// attn_block_ref, mlp_block_ref): RMSNorm in f32, cast to T before the
// weight multiply; every product lands in T; RoPE in f32 on the T
// projection; silu(g)*u in T; the residual add in T. The single-launch
// kernel follows decode_block_ref, the JAX kernel's rounding points: the
// attention half as above up to the T attention rows; then o_proj summed
// and kept in f32, resid = f32(x) + o (f32), the post-norm read from that
// f32 row, gate and up f32 sums cast to T, silu(g)*u in T, down summed in
// f32 over all of F, x_out = T(resid + down). So it is a roundoff-level
// variant of the two-stage route, not a bit-identical one.
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
//              | grid sync | attention: paged_stream.cuh's split page
//              stream (items of 8 pages of each (sequence, KV head), 4
//              pages a step, the next step in flight) -> f32 partials
//              | grid sync | per (sequence, KV head): the partials and
//              the new token combined in split order -> workspace (T)
//              | grid sync | o_proj by column tiles, + x.
//   MLP:       RMSNorm | gate/up by F tiles (a ragged last tile is
//              masked), silu(g)*u -> workspace (T) | grid sync | down by
//              output column tiles over all of F, + x.
//   block:     the attention phases, o_proj + x into an f32 residual
//              workspace [B, D] | grid sync | the MLP phases over the
//              RMSNorm of that f32 row, down + the f32 residual -> T.
// The three kernels run the same phase bodies (the __device__ functions
// below). On the TPU the block kernel's residual lives in VMEM for the
// whole launch; here blocks split the columns, so it crosses blocks
// through device memory (128 KB at B=8, which stays in the 50 MB L2). What
// the single launch saves against decode_attn_block + decode_mlp_block is
// one launch and one drain of the grid per layer, not bytes: both routes
// read every weight once.
// Every product is block_products.cuh's tile routine over passes of 8
// rows. Only one pass of normalised rows is resident, so shared memory
// does not grow with B; a block normalises pass p again for each of its
// tiles when B > 8, reading x from L2 rather than holding every pass. No
// atomics touch any sum, so two launches give identical bits. The tile
// width is picked per phase from the grid so the busiest block has the
// fewest columns: the wrapper's plan (tile widths and counts, and the
// grid), passed in the arguments.
//
// decode_block_fused in bf16 at up to 8 rows, with bf16, int8 or int4
// weights (the serving engine's decode step; the wrapper's plan,
// plan["body"] "ring") runs a second kernel, decode_block_ring_kernel: the
// same phases and rounding points, with every product's weights streamed
// through a ring of chunks in shared memory onto mma.sync (the codes
// unchanged, converted in registers), K split into parts that fill the
// grid, and the next product phase's first chunks issued before the
// barrier that precedes it (weight_ring.cuh says why and how). f32 and
// more rows keep the CUDA-core body and its bits.
// decode_mlp_block has a ring body for bf16 at up to 8 rows, every weight
// class and both residual classes (plan["body"] "ring"):
// decode_mlp_ring_kernel (RMSNorm, gate/up on the ring | down on the
// ring). decode_attn_block has one over int8 pools only, every weight
// class and both residual classes: decode_attn_ring_kernel (the RMSNorm
// with q/k/v's first chunks in flight, q/k/v on the ring | pages in
// kAttnRingTeams teams | combine, with o_proj's first chunks issued before
// the barrier | o_proj on the ring). Over bf16 pools its page phase at one
// block an SM is slower than the CUDA-core body's at two blocks an SM by
// more than the ring saves on q/k/v and o_proj (PERF.md), so no bf16-pool
// instance is built; the wrapper's rule says which int8-pool classes take
// it. Both epilogues keep the two-stage rounding points above (o and down
// cast to T before x is added in T, or alone when residual is 0), not the
// single-launch kernel's f32 residual. Not done yet (later work): a
// multi-layer form over thread-block clusters.
//
// Shared memory, sized by the wrapper (ops/kernels/fused_decode_block.py,
// the one definition of the sizes) and passed in, is carved as
// block_products.cuh describes; the block kernel's is the attention
// kernel's layout, the larger of its two halves.
//
// decode_mlp_block at chunk rows (the prefill MLP: 32 and 128 rows; any
// launch of more than 8 rows in bf16, the wrapper's plan) runs a second
// instance of its kernel (kTC), on the tensor cores: at 128 rows the MLP
// is 34.6 GFLOP, which the CUDA cores (67 TFLOP/s f32 at best) cannot do
// in less than 0.52 ms, and the 8-row passes above stream the weights 16
// times. Its phases: the RMSNorm of every row once, into a [B][D] bf16
// workspace | grid sync | gate and up by column tiles of F over all B
// rows at once (tile_mma.cuh: mma.sync bf16 -> f32, both products on one
// staged left operand), each sum scaled and cast to bf16, silu(g)*u in
// bf16 into a [B][F] workspace | grid sync | down by column tiles of D
// over all of F, scaled, cast, + x. The rounding points are the CUDA-core
// body's (mlp_block_wq_ref); only the summation order differs. One block
// an SM: 132 blocks take gate/up's 172 tiles of 64 columns and down's 64
// tiles of 64 in two parts of F (f32 partial sums added in part order
// after one more grid barrier) at LLaMA-7B. 8-row launches, f32, decode_block_fused and the
// gate's specimen keep the CUDA-core code.
#include "tile_mma.cuh"
#include "weight_ring.cuh"

namespace paddle_tpu_torch {
namespace fused {

struct AttnArgs {
  const void *x, *nw, *wq, *wk, *wv, *wo;   // weights: T, int8 or int4
  const float *sq, *sk, *sv, *so;           // f32 [out] scales, or null
  const float *sin, *cos;
  const void *k_pool, *v_pool;        // T, or int8 (KQ)
  const float *k_scale, *v_scale;     // f32 [KV] (int8 pools), or null
  const int *tables, *seq_lens;
  void *x_out, *k_new, *v_new;
  void *qkv_ws, *attn_ws;             // T: [B][(H+2KV)*hd], [P][H*hd][8]
  float *part_m, *part_l, *part_acc;  // [B][KV][splits][groups](*hd)
  float* s_new;                       // [B][H]
  int B, D, H, KV, hd, BS, MB, rope_rows, residual;
  float eps, scale;
  size_t region;
  // the tile plan (the wrapper's): lanes per weight row and tile counts of
  // the q/k/v phase (q_tiles of wq, kv_tiles each of wk and wv) and of
  // o_proj
  int qkv_lpr, q_tiles, kv_tiles, o_lpr, o_tiles;
};

struct MlpArgs {
  const void* x;       // T; the f32 residual in the block kernel
  const void *nw, *wg, *wu, *wd;
  const float *sg, *su, *sd;   // f32 [out] scales, or null
  void *out, *ff_ws;   // T: [P][F][8]
  int B, D, F, residual;
  float eps;
  size_t region;
  // the tile plan (the wrapper's): lanes per weight row and tile counts of
  // the gate/up phase (over F) and of the down phase (over D's stored
  // columns), and the down phase's contraction depth down_k <= F: the
  // first down_k columns of silu(g)*u and rows of wd (F for the MLP; the
  // kernel-geometry gate's regression specimen runs a shorter one)
  int up_lpr, up_tiles, down_lpr, down_tiles, down_k;
  // the tensor-core body's (kTC): the normalised rows [B][D] (bf16), the
  // tiles of kTileRows rows, down's split of F into down_parts parts and
  // their f32 partial sums [down_parts][B][D]
  void* h_ws;
  int row_tiles, down_parts;
  float* part_ws;
};

// The single-launch kernel: the attention half writes resid (f32 [B][D])
// in place of x_out; the MLP half reads it as its x (mlp.x == resid) and
// writes x_out (mlp.out).
struct BlockArgs {
  AttnArgs attn;
  MlpArgs mlp;
  float* resid;
  RingArgs ring;   // the weight-ring body's plan (weight_ring.cuh)
};

// The scaled f32 sum of output column c: the weight's scale multiplies
// it in the epilogue (WQ != 0), before any rounding.
template <int WQ>
__device__ __forceinline__ float scaled(float v, const float* s, int c) {
  if constexpr (WQ != 0) return v * s[c];
  return v;
}

// 1. q/k/v products by column tiles of the three matrices, rows in T,
// over the RMSNorm of each pass of rows (k-major in shared memory)
template <typename T, int WQ>
__device__ void attn_qkv_phase(const AttnArgs& a, unsigned char* smem) {
  constexpr int V = Vec<T>::n;
  constexpr int WC = wclass(WQ, false);
  const int B = a.B, D = a.D, H = a.H, KV = a.KV, hd = a.hd;
  const int tid = threadIdx.x;
  const int nq = H * hd, nkv = KV * hd, ncols = nq + 2 * nkv;
  const int kn = WC == kWInt4K ? D / 2 : D;   // stored weight rows
  T* region = reinterpret_cast<T*>(smem);
  float* red_s = reinterpret_cast<float*>(smem + a.region);
  float* res_s = red_s + kWarps * kMaxLpr * V * kRB;
  T* qkv = static_cast<T*>(a.qkv_ws);
  const int lpr = a.qkv_lpr, tc = lpr * V;
  const int tq = a.q_tiles, tk = a.kv_tiles;
  int held = -1;
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
    for (int p = 0; p < passes(B); ++p) {
      hold_pass<T>(static_cast<const T*>(a.x), static_cast<const T*>(a.nw),
                   region, p, &held, B, D, a.eps, red_s);
      float acc[kRB][V];
      zero<T>(acc);
      tile_accumulate<T, WC>(acc, region, region + (size_t)kn * kRB, W,
                             row_bytes<T, WC>(n), kn, col0, n, lpr);
      tile_reduce<T>(acc, red_s, res_s, lpr);
      for (int i = tid; i < tc * kRB; i += kThreads) {
        const int c = col0 + i / kRB, b = p * kRB + i % kRB;
        if (b < B && c < n)
          qkv[(size_t)b * ncols + base + c] =
              from_float<T>(scaled<WQ>(res_s[i], S, c));
      }
      __syncthreads();
    }
  }
}

// Bytes of one attention item's scratch (paged_stream.cuh's layout, the
// pages in the pool's type P), rounded up to 16.
template <typename P>
__host__ __device__ inline size_t attn_item_bytes(int groups, int hd,
                                                  int BS) {
  const size_t b = attn_scratch_floats(groups, hd, BS) * sizeof(float) +
                   2 * (size_t)kPageStages * kPagesPerStep * BS * hd *
                       sizeof(P);
  return (b + 15) / 16 * 16;
}

// 2. attention over the split page stream (paged_stream.cuh): items of
// kSplitPages pages of each (sequence, KV head), kPagesPerStep pages a
// step, the next step in flight; split 0 also makes the new token's k/v
// and score. KQ: int8 pools, staged as int8 and dequantized per element in
// the page update. kTeams 2: the block's two halves (four warps each, a
// named barrier each) take an item each, with a scratch each (one block an
// SM runs two page chains at once; each item's sums are the same as the
// whole block's).
template <typename T, bool KQ, int kTeams = 1>
__device__ void attn_pages_phase(const AttnArgs& a, unsigned char* smem) {
  using P = PoolT<T, KQ>;
  using Team = typename std::conditional<kTeams == 1, BlockTeam,
                                         WarpTeam>::type;
  const int B = a.B, H = a.H, KV = a.KV, hd = a.hd, BS = a.BS;
  const int groups = H / KV, hd2 = hd / 2, NS = splits(a.MB);
  const int nq = H * hd, nkv = KV * hd, ncols = nq + 2 * nkv;
  const T* qkv = static_cast<const T*>(a.qkv_ws);
  constexpr int kTeamThreads = kThreads / kTeams;
  const int team_id = threadIdx.x / kTeamThreads;
  Team team;
  if constexpr (kTeams > 1)
    team = WarpTeam{(int)threadIdx.x % kTeamThreads, kTeamThreads,
                    1 + team_id};
  const int tid = team.tid(), nthr = team.size();
  const PageScratch<P> c = carve_pages<P>(
      smem + team_id * attn_item_bytes<P>(groups, hd, BS), groups, hd, BS);
  const PagedView pv{a.k_pool, a.v_pool, a.tables, KV, hd, BS, a.MB};
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  paged_items<P>(
      pv, c, blockIdx.x * kTeams + team_id, gridDim.x * kTeams, NS * B * KV,
      groups, a.scale, team,
      [&](int i, PageItem& it) {
        const bool take = page_item(i, B, KV, BS, a.MB, a.seq_lens, true, it);
        if (KQ) {
          it.ks = a.k_scale[it.kvh];
          it.vs = a.v_scale[it.kvh];
        }
        return take;
      },
      [&](const PageItem& it) {
        const int b = it.b, kvh = it.kvh, seq_len = it.seq_len;
        const int pos = min(max(seq_len, 0), a.rope_rows - 1);
        const float* sn = a.sin + (size_t)pos * hd2;
        const float* cs = a.cos + (size_t)pos * hd2;
        const T* row = qkv + (size_t)b * ncols;
        const T* qr = row + (size_t)kvh * groups * hd;
        for (int i = tid; i < groups * hd; i += nthr) {
          const int g = i / hd, d = i - g * hd;
          c.q[i] = round_t<T>(rope_at<T>(qr + g * hd, d, hd2, sn, cs));
          c.acc[i] = 0.f;
        }
        for (int g = tid; g < groups; g += nthr) {
          c.m[g] = -CUDART_INF_F;
          c.l[g] = 0.f;
        }
        if (it.sp != 0) return;
        const T* kr = row + nq + (size_t)kvh * hd;
        const T* vr = row + nq + nkv + (size_t)kvh * hd;
        const size_t kv_off = ((size_t)b * KV + kvh) * hd;
        for (int d = tid; d < hd; d += nthr) {
          const T kt = from_float<T>(rope_at<T>(kr, d, hd2, sn, cs));
          static_cast<T*>(a.k_new)[kv_off + d] = kt;
          static_cast<T*>(a.v_new)[kv_off + d] = vr[d];
          // the value the pool gives back: T itself, or its int8 round trip
          c.extra[d] = KQ ? kv_round_trip(to_float(kt), it.ks)
                          : to_float(kt);
        }
        team.sync();
        for (int g = warp; g < groups; g += nwarps) {
          float dot = 0.f;
          for (int d = lane; d < hd; d += 32)
            dot += c.q[g * hd + d] * c.extra[d];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (lane == 0) a.s_new[b * H + kvh * groups + g] = dot * a.scale;
        }
      },
      [&](const PageItem& it) {
        store_partials<P>(c, a.part_m, a.part_l, a.part_acc,
                          (((size_t)it.b * KV + it.kvh) * NS + it.sp) *
                              groups, groups, hd, team);
      });
}

// 3. per (sequence, KV head): the splits' partials and the new token
// (always unmasked, so l > 0) combined in split order (combine_splits);
// KQ: the new token's v as the int8 pool gives it back. kTeams: the block's
// threads split into that many teams, an item each (each output element
// is one thread's sum either way).
template <typename T, bool KQ, int kTeams = 1>
__device__ void attn_combine_phase(const AttnArgs& a) {
  const int B = a.B, H = a.H, KV = a.KV, hd = a.hd, BS = a.BS;
  const int groups = H / KV, NS = splits(a.MB), nq = H * hd;
  constexpr int kTeamThreads = kThreads / kTeams;
  const int tid = threadIdx.x % kTeamThreads;
  T* attn_t = static_cast<T*>(a.attn_ws);
  for (int item = blockIdx.x * kTeams + threadIdx.x / kTeamThreads;
       item < B * KV; item += gridDim.x * kTeams) {
    const int b = item / KV, kvh = item - b * KV;
    const int seq_len = a.seq_lens[b];
    const int n_pages = min((seq_len + BS - 1) / BS, a.MB);
    const int ns = (n_pages + kSplitPages - 1) / kSplitPages;
    const size_t pbase = ((size_t)b * KV + kvh) * NS;
    const T* vnew = static_cast<const T*>(a.v_new) + ((size_t)b * KV + kvh) * hd;
    const float vs = KQ ? a.v_scale[kvh] : 1.f;
    for (int i = tid; i < groups * hd; i += kTeamThreads) {
      const int g = i / hd, d = i - g * hd;
      const float snew = a.s_new[b * H + kvh * groups + g];
      const float vn = KQ ? kv_round_trip(to_float(vnew[d]), vs)
                          : to_float(vnew[d]);
      const float2 ol = combine_splits<true>(a.part_m, a.part_l, a.part_acc,
                                             pbase, ns, groups, g, d, hd,
                                             snew, vn);
      const int col = (kvh * groups + g) * hd + d;
      attn_t[((size_t)(b / kRB) * nq + col) * kRB + b % kRB] =
          from_float<T>(ol.x / ol.y);
    }
  }
}

// 4. o_proj by column tiles of D. The two-stage kernel rounds o to T and
// adds x in T (x_out); the block kernel keeps o in f32 and writes
// resid = f32(x) + o. A quantized o is the scaled f32 sum.
template <typename T, int WQ, bool kF32Resid>
__device__ void o_proj_phase(const AttnArgs& a, unsigned char* smem,
                             float* resid) {
  constexpr int V = Vec<T>::n;
  constexpr int WC = wclass(WQ, false);
  const int B = a.B, D = a.D, nq = a.H * a.hd;
  const int tid = threadIdx.x;
  T* region = reinterpret_cast<T*>(smem);
  float* red_s = reinterpret_cast<float*>(smem + a.region);
  float* res_s = red_s + kWarps * kMaxLpr * V * kRB;
  const T* attn_t = static_cast<const T*>(a.attn_ws);
  const int lpr = a.o_lpr, tc = lpr * V;
  const int kc_max = min(nq, (int)(a.region / (sizeof(T) * kRB)));
  const T* x = static_cast<const T*>(a.x);
  T* xo = static_cast<T*>(a.x_out);
  const int tiles = a.o_tiles;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int p = 0; p < passes(B); ++p) {
      tile_sums_staged<T, WC>(attn_t + (size_t)p * nq * kRB, nq, region,
                              kc_max, a.wo, row_bytes<T, WC>(D), t * tc, D,
                              min(kRB, B - p * kRB), lpr, red_s, res_s);
      for (int i = tid; i < tc * kRB; i += kThreads) {
        const int c = t * tc + i / kRB, b = p * kRB + i % kRB;
        if (b < B && c < D) {
          const size_t o = (size_t)b * D + c;
          const float v = scaled<WQ>(res_s[i], a.so, c);
          if constexpr (kF32Resid) {
            resid[o] = to_float(x[o]) + v;
          } else {
            const float d = round_t<T>(v);
            xo[o] = from_float<T>(a.residual ? to_float(x[o]) + d : d);
          }
        }
      }
      __syncthreads();
    }
  }
}

// MLP 1. gate and up by F tiles (the last one masked) over the RMSNorm of
// each pass of rows of x (In: T, or the block kernel's f32 residual;
// k-major in shared memory), each scaled sum cast to T, silu(g)*u in T
template <typename T, typename In, int WQ>
__device__ void mlp_up_phase(const MlpArgs& a, unsigned char* smem) {
  constexpr int V = Vec<T>::n;
  constexpr int WC = wclass(WQ, false);
  const int B = a.B, D = a.D, F = a.F;
  const int kn = WC == kWInt4K ? D / 2 : D;   // stored weight rows
  const size_t ldb = row_bytes<T, WC>(F);
  const int tid = threadIdx.x;
  T* region = reinterpret_cast<T*>(smem);
  float* red_s = reinterpret_cast<float*>(smem + a.region);
  float* res_g = red_s + kWarps * kMaxLpr * V * kRB;
  float* res_u = res_g + kMaxLpr * V * kRB;
  T* ff_t = static_cast<T*>(a.ff_ws);
  const In* x = static_cast<const In*>(a.x);
  const int lpr = a.up_lpr, tc = lpr * V;
  const int tiles = a.up_tiles;
  int held = -1;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int col0 = t * tc;
    for (int p = 0; p < passes(B); ++p) {
      hold_pass<T, In>(x, static_cast<const T*>(a.nw), region, p, &held, B,
                       D, a.eps, red_s);
      const T* h = region;
      const T* h_hi = h + (size_t)kn * kRB;
      float acc[kRB][V];
      zero<T>(acc);
      tile_accumulate<T, WC>(acc, h, h_hi, a.wg, ldb, kn, col0, F, lpr);
      tile_reduce<T>(acc, red_s, res_g, lpr);
      zero<T>(acc);
      tile_accumulate<T, WC>(acc, h, h_hi, a.wu, ldb, kn, col0, F, lpr);
      tile_reduce<T>(acc, red_s, res_u, lpr);
      for (int i = tid; i < tc * kRB; i += kThreads) {
        const int c = col0 + i / kRB, b = p * kRB + i % kRB;
        if (b < B && c < F) {
          const float g = round_t<T>(scaled<WQ>(res_g[i], a.sg, c));
          const float u = round_t<T>(scaled<WQ>(res_u[i], a.su, c));
          const float sg = round_t<T>(g / (1.f + expf(-g)));
          ff_t[((size_t)p * F + c) * kRB + i % kRB] =
              from_float<T>(__fmul_rn(sg, u));
        }
      }
      __syncthreads();
    }
  }
}

// MLP 2. down by column tiles of D over the first down_k columns of F (all
// of them but in the gate's regression specimen), then the residual: the
// two-stage kernel rounds down to T and adds x in T; the block kernel adds
// the f32 sum to its f32 residual (x) and rounds once. int4 down is packed
// along D: the tiles run over D/2 packed columns, each result lands on its
// column through out_col.
template <typename T, int WQ, bool kF32Resid>
__device__ void mlp_down_phase(const MlpArgs& a, unsigned char* smem) {
  constexpr int V = Vec<T>::n;
  constexpr int WC = wclass(WQ, true);
  const int B = a.B, D = a.D, F = a.F;
  const int nst = WC == kWInt4N ? D / 2 : D;   // stored columns
  const int tid = threadIdx.x;
  T* region = reinterpret_cast<T*>(smem);
  float* red_s = reinterpret_cast<float*>(smem + a.region);
  float* res_g = red_s + kWarps * kMaxLpr * V * kRB;
  const T* ff_t = static_cast<const T*>(a.ff_ws);
  const int lpr = a.down_lpr;
  const int tcs = lpr * Wt<T, WC>::cols, nres = lpr * V;   // stored, results
  const int K = a.down_k;
  const int kc_max = min(K, (int)(a.region / (sizeof(T) * kRB)));
  T* out = static_cast<T*>(a.out);
  const int tiles = a.down_tiles;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int p = 0; p < passes(B); ++p) {
      tile_sums_staged<T, WC>(ff_t + (size_t)p * F * kRB, K, region, kc_max,
                              a.wd, row_bytes<T, WC>(D), t * tcs, nst,
                              min(kRB, B - p * kRB), lpr, red_s, res_g);
      for (int i = tid; i < nres * kRB; i += kThreads) {
        const int c = out_col<T, WC>(t * tcs, i / kRB, nst, D / 2);
        const int b = p * kRB + i % kRB;
        if (b < B && c >= 0) {
          const size_t o = (size_t)b * D + c;
          const float v = scaled<WQ>(res_g[i], a.sd, c);
          if constexpr (kF32Resid) {
            out[o] = from_float<T>(static_cast<const float*>(a.x)[o] + v);
          } else {
            const float d = round_t<T>(v);
            const float xv = to_float(static_cast<const T*>(a.x)[o]);
            out[o] = from_float<T>(a.residual ? xv + d : d);
          }
        }
      }
      __syncthreads();
    }
  }
}

// The tensor-core MLP body's column tiles: gate/up's (of each of the two
// weights) and down's
constexpr int kUpCols = 64;
constexpr int kDownCols = 64;

// MLP at chunk rows on the tensor cores, 1. gate and up by kUpCols-column
// tiles of F over every row (the normalised rows in h_ws), each scaled sum
// cast to bf16, silu(g)*u in bf16 -> ff_ws [B][F]
template <int WQ>
__device__ void mlp_rows_up_phase(const MlpArgs& a, unsigned char* smem) {
  constexpr int WC = wclass(WQ, false);
  const unsigned char* W[2] = {static_cast<const unsigned char*>(a.wg),
                               static_cast<const unsigned char*>(a.wu)};
  const bf16* h = static_cast<const bf16*>(a.h_ws);
  bf16* ff = static_cast<bf16*>(a.ff_ws);
  const int F = a.F, tiles = a.up_tiles;
  for (int item = blockIdx.x; item < a.row_tiles * tiles;
       item += gridDim.x) {
    const int t = item % tiles, r0 = (item / tiles) * kTileRows;
    const TileJob j{h, a.D, r0, min(kTileRows, a.B - r0), a.D,
                    t * kUpCols, F};
    tile_product<WC, 2, kUpCols>(j, W, row_bytes<bf16, WC>(F), smem,
                                 [&](int r, int c, const float* v) {
      const float g = round_t<bf16>(scaled<WQ>(v[0], a.sg, c));
      const float u = round_t<bf16>(scaled<WQ>(v[1], a.su, c));
      const float sg = round_t<bf16>(g / (1.f + expf(-g)));
      ff[(size_t)r * F + c] = __float2bfloat16(__fmul_rn(sg, u));
    });
  }
}

// down's epilogue of output (r, c) from its f32 sum: scaled, cast to
// bf16, then + x in bf16 (no add when residual is 0)
template <int WQ>
__device__ __forceinline__ void mlp_rows_out(const MlpArgs& a, int r, int c,
                                             float v) {
  const size_t o = (size_t)r * a.D + c;
  const float d = round_t<bf16>(scaled<WQ>(v, a.sd, c));
  static_cast<bf16*>(a.out)[o] = __float2bfloat16(
      a.residual ? to_float(static_cast<const bf16*>(a.x)[o]) + d : d);
}

// 2. down by kDownCols-column tiles of D (half as many stored columns a
// tile for int4, packed along D) over F split into down_parts parts: the
// output, or with parts the f32 partial sums
template <int WQ>
__device__ void mlp_rows_down_phase(const MlpArgs& a, unsigned char* smem) {
  constexpr int WC = wclass(WQ, true);
  const unsigned char* W[1] = {static_cast<const unsigned char*>(a.wd)};
  const bf16* ff = static_cast<const bf16*>(a.ff_ws);
  const int D = a.D, tiles = a.down_tiles, parts = a.down_parts;
  const int nst = WC == kWInt4N ? D / 2 : D;   // stored columns
  for (int item = blockIdx.x; item < a.row_tiles * parts * tiles;
       item += gridDim.x) {
    const int t = item % tiles, p = (item / tiles) % parts;
    const int r0 = (item / (tiles * parts)) * kTileRows;
    const TileJob j{ff, a.F, r0, min(kTileRows, a.B - r0), a.F,
                    t * TileW<WC, kDownCols>::cols, nst, p, parts};
    tile_product<WC, 1, kDownCols>(j, W, row_bytes<bf16, WC>(D), smem,
                                   [&](int r, int c, const float* v) {
      if (parts > 1)
        a.part_ws[((size_t)p * a.B + r) * D + c] = v[0];
      else
        mlp_rows_out<WQ>(a, r, c, v[0]);
    });
  }
}

// 3. with down_parts > 1: each output's parts added in part order, then
// down's epilogue; four outputs a thread (D is a multiple of 32)
template <int WQ>
__device__ void mlp_rows_combine_phase(const MlpArgs& a) {
  const int n4 = a.B * a.D / 4;
  const float4* part = reinterpret_cast<const float4*>(a.part_ws);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += gridDim.x * kThreads) {
    float4 v = part[i];
    for (int p = 1; p < a.down_parts; ++p) {
      const float4 w = part[p * n4 + i];
      v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
    }
    const int r = 4 * i / a.D, c = 4 * i - r * a.D;
    mlp_rows_out<WQ>(a, r, c, v.x);
    mlp_rows_out<WQ>(a, r, c + 1, v.y);
    mlp_rows_out<WQ>(a, r, c + 2, v.z);
    mlp_rows_out<WQ>(a, r, c + 3, v.w);
  }
}

// Shared memory of the tensor-core MLP body: the larger of its two
// phases' tile_mma.cuh layouts (gate/up: two weights; down: one, int4
// packed along D)
inline size_t mlp_tc_smem(int wbits) {
  switch (wbits) {
    case 8:
      return std::max(tile_smem_bytes<kWInt8, 2, kUpCols>(),
                      tile_smem_bytes<kWInt8, 1, kDownCols>());
    case 4:
      return std::max(tile_smem_bytes<kWInt4K, 2, kUpCols>(),
                      tile_smem_bytes<kWInt4N, 1, kDownCols>());
    default:
      return std::max(tile_smem_bytes<kWFp, 2, kUpCols>(),
                      tile_smem_bytes<kWFp, 1, kDownCols>());
  }
}

template <typename T, int WQ, bool KQ>
__global__ void __launch_bounds__(kThreads, 2)
decode_attn_block_kernel(const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  attn_qkv_phase<T, WQ>(a, smem);
  grid.sync();
  attn_pages_phase<T, KQ>(a, smem);
  grid.sync();
  attn_combine_phase<T, KQ>(a);
  grid.sync();
  o_proj_phase<T, WQ, false>(a, smem, nullptr);
}

// kTC: the tensor-core body at chunk rows (bf16 only; the file header),
// one block an SM
template <typename T, int WQ, bool kTC = false>
__global__ void __launch_bounds__(kThreads, kTC ? 1 : 2)
decode_mlp_block_kernel(const MlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  if constexpr (kTC) {
    norm_rows(static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.nw),
              static_cast<bf16*>(a.h_ws), a.B, a.D, a.eps,
              reinterpret_cast<float*>(smem));
    grid.sync();
    mlp_rows_up_phase<WQ>(a, smem);
    grid.sync();
    mlp_rows_down_phase<WQ>(a, smem);
    if (a.down_parts > 1) {   // grid-uniform
      grid.sync();
      mlp_rows_combine_phase<WQ>(a);
    }
  } else {
    mlp_up_phase<T, T, WQ>(a, smem);
    grid.sync();
    mlp_down_phase<T, WQ, false>(a, smem);
  }
}

// One block an SM: under __launch_bounds__(kThreads, 2) (128 registers)
// the merged phases spill 288 B a thread and the gate/up phase slows by
// ~18% (NVIDIA H100, bf16, 7B widths); with one block an SM nothing
// spills (234 registers) and each phase runs at the two-stage kernels'
// pace. The grid is sized from this kernel's own occupancy.
template <typename T, int WQ, bool KQ>
__global__ void __launch_bounds__(kThreads, 1)
decode_block_fused_kernel(const BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  attn_qkv_phase<T, WQ>(a.attn, smem);
  grid.sync();
  attn_pages_phase<T, KQ>(a.attn, smem);
  grid.sync();
  attn_combine_phase<T, KQ>(a.attn);
  grid.sync();
  o_proj_phase<T, WQ, true>(a.attn, smem, a.resid);
  grid.sync();
  mlp_up_phase<T, float, WQ>(a.mlp, smem);
  grid.sync();
  mlp_down_phase<T, WQ, true>(a.mlp, smem);
}

// The weight-ring bodies (weight_ring.cuh) of the single-launch kernel and
// of the two-stage kernels: bf16 activations, bf16, int8 or int4 weights
// (WQ), at most 8 rows, fp or int8 pools (KQ). Shared memory: the ring,
// then the RMSNorm's per-warp sums and the ticket flag (kRingAux bytes),
// then one region that holds either the phase's resident normalised rows
// [D][8] or the attention scratch of one item a team (the block's teams
// of kThreads / teams threads take an item each: the attention phase is
// bound by each item's chain of page steps, not by bytes). The
// single-launch ring runs kRingTeams teams (two items' scratch fits beside
// the ring over bf16 pools); decode_attn_block's ring, over int8 pools
// only, kAttnRingTeams (four teams of two warps: its page phase measured
// faster than two teams of four warps, PERF.md).
constexpr int kRingAux = 512;
constexpr int kRingTeams = 2;
constexpr int kAttnRingTeams = 4;

// ring_smem: a ring body's dynamic shared memory under weight bits WQ for
// D and the attention scratch of ``teams`` items (``attn`` bytes an item:
// one paged_stream scratch with two staged steps in the pools' type,
// attn_item_bytes; 0: decode_mlp_block's body, which has no attention)
template <int WQ>
inline size_t ring_smem(int D, size_t attn, int teams) {
  return (size_t)kRingStages * RingGeom<WQ>::stage + kRingAux +
         std::max((size_t)D * kRB * sizeof(ring_bf16), teams * attn);
}

inline size_t ring_smem_bits(int wbits, int D, size_t attn, int teams) {
  return wbits == 8   ? ring_smem<8>(D, attn, teams)
         : wbits == 4 ? ring_smem<4>(D, attn, teams)
                      : ring_smem<0>(D, attn, teams);
}

template <int WQ, bool KQ>
__global__ void __launch_bounds__(kThreads, 1)
decode_block_ring_kernel(const BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  using T = ring_bf16;
  using G = RingGeom<WQ>;
  // q/k/v, o_proj and gate/up: int4 packed along K; down: along N
  constexpr int WC = wclass(WQ, false), WD = wclass(WQ, true);
  const RingArgs& r = a.ring;
  const int B = a.attn.B, D = a.attn.D;
  unsigned char* ring = smem;
  float* red_s =
      reinterpret_cast<float*>(smem + (size_t)kRingStages * G::stage);
  int* flag = reinterpret_cast<int*>(red_s + kWarps * kRB);
  unsigned char* region = smem + (size_t)kRingStages * G::stage + kRingAux;
  T* h = reinterpret_cast<T*>(region);   // resident rows [D][8]
  Ring g = ring_init<WQ>(r);
  // q/k/v's first chunks fly while the block normalises its rows
  g.stop = g.base[1];
  ring_prefetch<WQ>(r, g, ring, kRingStages - 1);
  ring_norm<T>(static_cast<const T*>(a.attn.x),
               static_cast<const T*>(a.attn.nw), h, B, D, a.attn.eps, red_s);
  const int ncols = r.ph[0].ncols;
  T* qkv = static_cast<T*>(a.attn.qkv_ws);
  ring_phase<WQ, WC>(r, g, ring, h, 0, B, flag,
                     [&](int row, int c, const float* v) {
                       qkv[(size_t)row * ncols + c] = from_float<T>(v[0]);
                     });
  grid.sync();
  attn_pages_phase<T, KQ, kRingTeams>(a.attn, region);
  grid.sync();
  attn_combine_phase<T, KQ>(a.attn);
  // o_proj's first chunks fly across the barrier
  g.stop = g.base[4];
  ring_prefetch<WQ>(r, g, ring, g.base[1] + kRingStages - 1);
  grid.sync();
  ring_open<WQ>(r, g, ring, 1);
  const T* x = static_cast<const T*>(a.attn.x);
  float* resid = a.resid;
  ring_phase<WQ, WC>(r, g, ring, nullptr, 1, B, flag,
                     [&](int row, int c, const float* v) {
                       const size_t o = (size_t)row * D + c;
                       resid[o] = to_float(x[o]) + v[0];
                     });
  grid.sync();
  ring_open<WQ>(r, g, ring, 2);
  ring_norm<float>(resid, static_cast<const T*>(a.mlp.nw), h, B, D,
                   a.mlp.eps, red_s);
  T* ff = static_cast<T*>(a.mlp.ff_ws);
  ring_phase<WQ, WC>(r, g, ring, h, 2, B, flag,
                     [&](int row, int c, const float* v) {
                       const float gt = round_t<T>(v[0]);
                       const float ut = round_t<T>(v[1]);
                       const float sg = round_t<T>(gt / (1.f + expf(-gt)));
                       ff[(size_t)c * kRB + row] =
                           from_float<T>(__fmul_rn(sg, ut));
                     });
  grid.sync();
  ring_open<WQ>(r, g, ring, 3);
  T* xo = static_cast<T*>(a.mlp.out);
  ring_phase<WQ, WD>(r, g, ring, nullptr, 3, B, flag,
                     [&](int row, int c, const float* v) {
                       const size_t o = (size_t)row * D + c;
                       xo[o] = from_float<T>(resid[o] + v[0]);
                     });
  cp_async_wait0();
}

// The two-stage kernels' ring bodies take their half's arguments and the
// ring's plan.
struct AttnRingArgs {
  AttnArgs attn;
  RingArgs ring;   // phases 0 (q/k/v) and 1 (o_proj); 2 and 3 empty
};
struct MlpRingArgs {
  MlpArgs mlp;
  RingArgs ring;   // phases 2 (gate/up) and 3 (down); 0 and 1 empty
};

// decode_attn_block's ring body: the single-launch ring's attention half
// with the two-stage epilogues (q/k/v as above; o = T(the scaled f32 sum),
// x_out = x + o in T, or o alone when residual is 0). The page phase is
// paged_stream.cuh's split page stream in kAttnRingTeams teams (int8
// pools only: KQ is true in every instance); its cp.async groups never mix with the
// ring's (q/k/v's chunks are all consumed before it; o_proj's are issued
// after it).
template <int WQ, bool KQ>
__global__ void __launch_bounds__(kThreads, 1)
decode_attn_ring_kernel(const AttnRingArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  using T = ring_bf16;
  using G = RingGeom<WQ>;
  constexpr int WC = wclass(WQ, false);
  const RingArgs& r = a.ring;
  const int B = a.attn.B, D = a.attn.D;
  unsigned char* ring = smem;
  float* red_s =
      reinterpret_cast<float*>(smem + (size_t)kRingStages * G::stage);
  int* flag = reinterpret_cast<int*>(red_s + kWarps * kRB);
  unsigned char* region = smem + (size_t)kRingStages * G::stage + kRingAux;
  T* h = reinterpret_cast<T*>(region);   // resident rows [D][8]
  Ring g = ring_init<WQ>(r);
  // q/k/v's first chunks fly while the block normalises its rows
  g.stop = g.base[1];
  ring_prefetch<WQ>(r, g, ring, kRingStages - 1);
  ring_norm<T>(static_cast<const T*>(a.attn.x),
               static_cast<const T*>(a.attn.nw), h, B, D, a.attn.eps, red_s);
  const int ncols = r.ph[0].ncols;
  T* qkv = static_cast<T*>(a.attn.qkv_ws);
  ring_phase<WQ, WC>(r, g, ring, h, 0, B, flag,
                     [&](int row, int c, const float* v) {
                       qkv[(size_t)row * ncols + c] = from_float<T>(v[0]);
                     });
  grid.sync();
  attn_pages_phase<T, KQ, kAttnRingTeams>(a.attn, region);
  grid.sync();
  attn_combine_phase<T, KQ, kAttnRingTeams>(a.attn);
  // o_proj's first chunks fly across the barrier
  g.stop = g.base[4];
  ring_prefetch<WQ>(r, g, ring, g.base[1] + kRingStages - 1);
  grid.sync();
  ring_open<WQ>(r, g, ring, 1);
  const T* x = static_cast<const T*>(a.attn.x);
  T* xo = static_cast<T*>(a.attn.x_out);
  const int residual = a.attn.residual;
  ring_phase<WQ, WC>(r, g, ring, nullptr, 1, B, flag,
                     [&](int row, int c, const float* v) {
                       const size_t o = (size_t)row * D + c;
                       const float d = round_t<T>(v[0]);
                       xo[o] = from_float<T>(residual ? to_float(x[o]) + d
                                                      : d);
                     });
  cp_async_wait0();
}

// decode_mlp_block's ring body: the RMSNorm with gate/up's first chunks in
// flight, gate/up on the ring (g and u cast to T, silu(g)*u in T) | down on
// the ring (its weights issued during gate/up, its staged rows once the
// barrier has passed): down = T(the scaled f32 sum over all of F), x_out =
// x + down in T, or down alone when residual is 0.
template <int WQ>
__global__ void __launch_bounds__(kThreads, 1)
decode_mlp_ring_kernel(const MlpRingArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  using T = ring_bf16;
  using G = RingGeom<WQ>;
  constexpr int WC = wclass(WQ, false), WD = wclass(WQ, true);
  const RingArgs& r = a.ring;
  const int B = a.mlp.B, D = a.mlp.D;
  unsigned char* ring = smem;
  float* red_s =
      reinterpret_cast<float*>(smem + (size_t)kRingStages * G::stage);
  int* flag = reinterpret_cast<int*>(red_s + kWarps * kRB);
  T* h = reinterpret_cast<T*>(smem + (size_t)kRingStages * G::stage +
                              kRingAux);   // resident rows [D][8]
  Ring g = ring_init<WQ>(r);   // phases 0 and 1 hold no chunk
  ring_prefetch<WQ>(r, g, ring, kRingStages - 1);
  const T* x = static_cast<const T*>(a.mlp.x);
  ring_norm<T>(x, static_cast<const T*>(a.mlp.nw), h, B, D, a.mlp.eps,
               red_s);
  T* ff = static_cast<T*>(a.mlp.ff_ws);
  ring_phase<WQ, WC>(r, g, ring, h, 2, B, flag,
                     [&](int row, int c, const float* v) {
                       const float gt = round_t<T>(v[0]);
                       const float ut = round_t<T>(v[1]);
                       const float sg = round_t<T>(gt / (1.f + expf(-gt)));
                       ff[(size_t)c * kRB + row] =
                           from_float<T>(__fmul_rn(sg, ut));
                     });
  grid.sync();
  ring_open<WQ>(r, g, ring, 3);
  T* xo = static_cast<T*>(a.mlp.out);
  const int residual = a.mlp.residual;
  ring_phase<WQ, WD>(r, g, ring, nullptr, 3, B, flag,
                     [&](int row, int c, const float* v) {
                       const size_t o = (size_t)row * D + c;
                       const float d = round_t<T>(v[0]);
                       xo[o] = from_float<T>(residual ? to_float(x[o]) + d
                                                      : d);
                     });
  cp_async_wait0();
}

// The ring body for (dtype, weight bits, pool bits): bf16 activations
inline KernelFn<BlockArgs> ring_kernel(int dtype, int wbits, int kvbits) {
  if (dtype != 1 || (kvbits != 0 && kvbits != 8)) return nullptr;
  const bool kq = kvbits == 8;
  if (wbits == 0)
    return kq ? decode_block_ring_kernel<0, true>
              : decode_block_ring_kernel<0, false>;
  if (wbits == 8)
    return kq ? decode_block_ring_kernel<8, true>
              : decode_block_ring_kernel<8, false>;
  if (wbits == 4)
    return kq ? decode_block_ring_kernel<4, true>
              : decode_block_ring_kernel<4, false>;
  return nullptr;
}

// decode_attn_block's ring body: bf16 activations over int8 pools only
inline KernelFn<AttnRingArgs> attn_ring_kernel(int dtype, int wbits,
                                               int kvbits) {
  if (dtype != 1 || kvbits != 8) return nullptr;
  if (wbits == 0) return decode_attn_ring_kernel<0, true>;
  if (wbits == 8) return decode_attn_ring_kernel<8, true>;
  if (wbits == 4) return decode_attn_ring_kernel<4, true>;
  return nullptr;
}

inline KernelFn<MlpRingArgs> mlp_ring_kernel(int dtype, int wbits) {
  if (dtype != 1) return nullptr;
  if (wbits == 0) return decode_mlp_ring_kernel<0>;
  if (wbits == 8) return decode_mlp_ring_kernel<8>;
  if (wbits == 4) return decode_mlp_ring_kernel<4>;
  return nullptr;
}

PADDLE_TPU_PICK_KV_KERNEL(attn_kernel, decode_attn_block_kernel, AttnArgs)
PADDLE_TPU_PICK_KERNEL(mlp_kernel, decode_mlp_block_kernel, MlpArgs)

// The tensor-core MLP body for (dtype, weight bits): bf16 only
inline KernelFn<MlpArgs> mlp_tc_kernel(int dtype, int wbits) {
  if (dtype != 1) return nullptr;
  if (wbits == 0) return decode_mlp_block_kernel<bf16, 0, true>;
  if (wbits == 8) return decode_mlp_block_kernel<bf16, 8, true>;
  if (wbits == 4) return decode_mlp_block_kernel<bf16, 4, true>;
  return nullptr;
}
PADDLE_TPU_PICK_KV_KERNEL(block_kernel, decode_block_fused_kernel, BlockArgs)

// The attention half's arguments, the workspaces carved from ws_t (T):
// qkv [B][(H+2KV)*hd], then the attention rows [P][H*hd][8] at an offset
// rounded up to 8 elements; and from ws_f (f32): part_m, part_l
// [B*H*splits] each, part_acc [B*H*splits*hd], s_new [B*H].
inline AttnArgs attn_args(const void* x, const void* nw, const void* wq,
                          const void* wk, const void* wv, const void* wo,
                          const void* sq, const void* sk, const void* sv,
                          const void* so, const void* sin, const void* cos,
                          const void* k_pool, const void* v_pool,
                          const void* k_scale, const void* v_scale,
                          const void* tables, const void* seq_lens,
                          void* x_out, void* k_new, void* v_new, void* ws_t,
                          void* ws_f, int B, int D, int H, int KV, int hd,
                          int BS, int MB, int rope_rows, int residual,
                          int region, float eps, float scale, int item,
                          const int* plan) {
  const size_t n_qkv = ((size_t)B * (H + 2 * KV) * hd + 7) / 8 * 8;
  const size_t n_part = (size_t)B * H * splits(MB);
  float* f = static_cast<float*>(ws_f);
  return AttnArgs{x, nw, wq, wk, wv, wo,
                  static_cast<const float*>(sq), static_cast<const float*>(sk),
                  static_cast<const float*>(sv), static_cast<const float*>(so),
                  static_cast<const float*>(sin),
                  static_cast<const float*>(cos), k_pool, v_pool,
                  static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale),
                  static_cast<const int*>(tables),
                  static_cast<const int*>(seq_lens), x_out, k_new, v_new,
                  ws_t, static_cast<char*>(ws_t) + n_qkv * item, f,
                  f + n_part, f + 2 * n_part, f + 2 * n_part + n_part * hd,
                  B, D, H, KV, hd, BS, MB, rope_rows, residual, eps, scale,
                  (size_t)region, plan[0], plan[1], plan[2], plan[3],
                  plan[4]};
}

// Ring phase p (0 q/k/v, 1 o_proj, 2 gate/up, 3 down) can run under
// weight bits ``wbits`` at contraction depth K over its slots' columns n:
// its stored rows a whole number of chunks, every stored row whole
// 16-byte copies (int4 packs q/k/v, o_proj and gate/up along K, down along
// its columns). The wrapper's rule (fused_decode_block.ring_width_reason)
// is the same test.
inline bool ring_phase_ok(int wbits, int p, int K, const int* n, int nslot) {
  const int wc = wclass(wbits, p == 3);
  const int rows = wbits ? kRingQRows : kRingK;
  const int esz = wbits ? 1 : 2;
  if (K <= 0 || (wc == kWInt4K && K % 2)) return false;
  if ((wc == kWInt4K ? K / 2 : K) % rows) return false;
  for (int s = 0; s < nslot; ++s) {
    if (n[s] <= 0 || (wc == kWInt4N && n[s] % 2)) return false;
    if (((wc == kWInt4N ? n[s] / 2 : n[s]) * esz) % 16) return false;
  }
  return true;
}

// The ring's plan of phase p from its weights (slots: q/k/v concatenate
// their columns; gate and up are paired over the same columns), their f32
// scales (null for bf16), their columns n, its depth K, its parts of K and
// its staged activation rows (null: resident); ``parts`` 0 is a phase the
// kernel does not run (no item, no chunk).
inline RingPhase ring_phase_plan(int p, int wbits, int nslot,
                                 const void* const* w,
                                 const void* const* sc, const int* n, int K,
                                 int parts, const void* a_src) {
  RingPhase f{};
  if (parts == 0) return f;
  const int wc = wclass(wbits, p == 3);
  const int rows = wbits ? kRingQRows : kRingK;   // stored rows a chunk
  f.nslot = nslot;
  f.paired = p == 2;
  f.parts = parts;
  f.K = K;
  f.kn = wc == kWInt4K ? K / 2 : K;
  f.half = wc == kWInt4K ? K / 2 : 0;
  f.part_rows = cdiv(cdiv(f.kn, rows), parts) * rows;
  f.a_src = static_cast<const ring_bf16*>(a_src);
  int items = 0, ticks = 0, out0 = 0;
  for (int s = 0; s < nslot; ++s) {
    f.w[s] = static_cast<const unsigned char*>(w[s]);
    f.s[s] = wbits ? static_cast<const float*>(sc[s]) : nullptr;
    f.n[s] = n[s];
    f.ns[s] = wc == kWInt4N ? n[s] / 2 : n[s];
    f.tiles[s] = cdiv(f.ns[s], kRingCols);
    f.first[s] = items;
    items += f.tiles[s] * parts;
    f.out0[s] = f.paired ? 0 : out0;
    f.tick0[s] = f.paired ? 0 : ticks;
    if (!f.paired || s == 0) ticks += f.tiles[s];
    out0 += f.paired ? 0 : n[s];
  }
  f.items = items;
  f.ncols = f.paired ? n[0] : out0;
  return f;
}

// The parts of K of each ring phase a kernel runs: 1 to kRingMaxParts.
inline bool ring_parts_ok(const int* parts, int n) {
  for (int i = 0; i < n; ++i)
    if (parts[i] < 1 || parts[i] > kRingMaxParts) return false;
  return true;
}

}  // namespace fused
}  // namespace paddle_tpu_torch

// C interface, bound with ctypes (paddle_tpu_torch/ops/kernels/
// fused_decode_block.py checks shapes, types, contiguity and alignment,
// sizes shared memory and allocates the workspaces first). dtype: 0 =
// float32, 1 = bfloat16; wbits: the weights' class, 0 = T, 8 = int8, 4 =
// packed int4 (down_proj along its output axis, the rest along their
// contraction axis), with the f32 scale pointers s* (null for 0); kvbits:
// the pools' class, 0 = T, 8 = int8 with the f32 [KV] scale pointers
// k_scale/v_scale (null for 0); region and smem: the shared-memory
// layout's bytes (file header). The launchers return the launch's
// cudaError_t; a (dtype, wbits, kvbits) they do not take is
// cudaErrorInvalidValue. grid and the tile plan (lanes per weight row and
// tile count of each phase) are the wrapper's: the grid must be the
// kernel's cooperative grid (decode_coop_grid), else the launch is refused
// (cudaErrorInvalidValue), as is a plan the kernels cannot run.

// The cooperative grid of kernel ``which`` (0 decode_attn_block, 1
// decode_mlp_block, 2 decode_block_fused, 3 decode_mlp_block's
// tensor-core body, 4 decode_block_fused's weight-ring body, 5
// decode_attn_block's and 6 decode_mlp_block's weight-ring bodies) for
// (dtype, wbits, kvbits) at
// ``smem`` bytes of dynamic shared memory a block; minus the cudaError_t
// on failure.
extern "C" int decode_coop_grid(int which, int dtype, int wbits, int kvbits,
                                int smem) {
  using namespace paddle_tpu_torch::fused;
  if (which == 0) return coop_grid_or_error(attn_kernel(dtype, wbits, kvbits), smem);
  if (which == 1) return coop_grid_or_error(mlp_kernel(dtype, wbits), smem);
  if (which == 2) return coop_grid_or_error(block_kernel(dtype, wbits, kvbits), smem);
  if (which == 3) return coop_grid_or_error(mlp_tc_kernel(dtype, wbits), smem);
  if (which == 4) return coop_grid_or_error(ring_kernel(dtype, wbits, kvbits), smem);
  if (which == 5) return coop_grid_or_error(attn_ring_kernel(dtype, wbits, kvbits), smem);
  if (which == 6) return coop_grid_or_error(mlp_ring_kernel(dtype, wbits), smem);
  return -(int)cudaErrorInvalidValue;
}

// ws_t and ws_f as attn_args carves them. body 0: the CUDA-core body
// (the tile plan); body 1: the weight-ring body (bf16 over int8 pools, B
// <= 8, the widths ring_phase_ok takes), whose plan is the parts of K of
// q/k/v and o_proj (1 to kRingMaxParts), at its own shared memory
// (ring_smem over kAttnRingTeams attention items), with ring_ws the f32
// partials of its wider phase and tickets one int per tile of its widest
// phase, 0 before the launch (each launch leaves them 0; one launch at a
// time may hold them).
extern "C" int decode_attn_block(
    const void* x, const void* nw, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* sq, const void* sk,
    const void* sv, const void* so, const void* sin, const void* cos,
    const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* tables, const void* seq_lens,
    void* x_out, void* k_new, void* v_new, void* ws_t, void* ws_f,
    void* ring_ws, void* tickets, int B, int D, int H, int KV, int hd,
    int BS, int MB, int rope_rows, int residual, int region, int smem,
    int wbits, int kvbits, int grid, int qkv_lpr, int q_tiles, int kv_tiles,
    int o_lpr, int o_tiles, int body, int qkv_parts, int o_parts, float eps,
    float scale, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  using namespace paddle_tpu_torch::fused;
  const int plan[5] = {qkv_lpr, q_tiles, kv_tiles, o_lpr, o_tiles};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 0) {
    const auto kernel = attn_kernel(dtype, wbits, kvbits);
    if (kernel == nullptr) return cudaErrorInvalidValue;
    if (!plan_ok(qkv_lpr, q_tiles) || !plan_ok(qkv_lpr, kv_tiles) ||
        !plan_ok(o_lpr, o_tiles))
      return cudaErrorInvalidValue;
    if (B == 0) return cudaSuccess;
    const AttnArgs a = attn_args(
        x, nw, wq, wk, wv, wo, sq, sk, sv, so, sin, cos, k_pool, v_pool,
        k_scale, v_scale, tables, seq_lens, x_out, k_new, v_new, ws_t, ws_f,
        B, D, H, KV, hd, BS, MB, rope_rows, residual, region, eps, scale,
        dtype == 1 ? 2 : 4, plan);
    return launch_coop(kernel, a, smem, grid, st);
  }
  if (body != 1) return cudaErrorInvalidValue;
  const auto kernel = attn_ring_kernel(dtype, wbits, kvbits);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const int nq = H * hd, nkv = KV * hd;
  const int parts[2] = {qkv_parts, o_parts};
  const int n_qkv[3] = {nq, nkv, nkv}, n_o[1] = {D};
  const size_t attn = attn_item_bytes<int8_t>(H / KV, hd, BS);
  if (B > kRB || !ring_parts_ok(parts, 2) ||
      !ring_phase_ok(wbits, 0, D, n_qkv, 3) ||
      !ring_phase_ok(wbits, 1, nq, n_o, 1) ||
      (size_t)smem != ring_smem_bits(wbits, D, attn, kAttnRingTeams))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  AttnRingArgs a{attn_args(
      x, nw, wq, wk, wv, wo, sq, sk, sv, so, sin, cos, k_pool, v_pool,
      k_scale, v_scale, tables, seq_lens, x_out, k_new, v_new, ws_t, ws_f,
      B, D, H, KV, hd, BS, MB, rope_rows, residual, region, eps, scale, 2,
      plan), RingArgs{}};
  const void* w_qkv[3] = {wq, wk, wv};
  const void* s_qkv[3] = {sq, sk, sv};
  a.ring.ph[0] = ring_phase_plan(0, wbits, 3, w_qkv, s_qkv, n_qkv, D,
                                 qkv_parts, nullptr);
  a.ring.ph[1] = ring_phase_plan(1, wbits, 1, &wo, &so, n_o, nq, o_parts,
                                 a.attn.attn_ws);
  a.ring.part = static_cast<float*>(ring_ws);
  a.ring.tickets = static_cast<int*>(tickets);
  return launch_coop(kernel, a, smem, grid, st);
}

// ff_ws (T): [P][F][8] for the CUDA-core body (body 0) and the weight-ring
// body (body 2: bf16, B <= 8, the widths ring_phase_ok takes; its plan the
// parts of K of gate/up and down, up_parts and down_parts, 1 to
// kRingMaxParts, at its own shared memory, ring_smem with no attention;
// ring_ws and tickets as decode_attn_block's); for the tensor-core body
// (body 1, bf16): silu(g)*u [B][F], then the normalised
// rows [B][D] at an offset rounded up to 8 elements, then (down_parts > 1)
// down's f32 partial sums [down_parts][B][D] at an offset rounded up to 16
// bytes. The tensor-core body's plan: up_tiles of kUpCols columns of F,
// down_tiles of kDownCols of D, row_tiles of 128 rows, down over all of F
// in 1 to 8 parts, lanes per row 0, at its own shared memory
// (mlp_tc_smem); any other is refused.
extern "C" int decode_mlp_block(const void* x, const void* nw, const void* wg,
                                const void* wu, const void* wd, const void* sg,
                                const void* su, const void* sd, void* out,
                                void* ff_ws, void* ring_ws, void* tickets,
                                int B, int D, int F, int residual, int region,
                                int smem, int wbits, int grid, int body,
                                int up_lpr, int up_tiles, int down_lpr,
                                int down_tiles, int down_k, int row_tiles,
                                int up_parts, int down_parts, float eps,
                                int dtype, void* stream) {
  using namespace paddle_tpu_torch::fused;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 2) {
    const auto kernel = mlp_ring_kernel(dtype, wbits);
    if (kernel == nullptr) return cudaErrorInvalidValue;
    const int parts[2] = {up_parts, down_parts};
    const int n_up[2] = {F, F}, n_down[1] = {D};
    if (B > kRB || !ring_parts_ok(parts, 2) ||
        !ring_phase_ok(wbits, 2, D, n_up, 2) ||
        !ring_phase_ok(wbits, 3, F, n_down, 1) ||
        (size_t)smem != ring_smem_bits(wbits, D, 0, 0))
      return cudaErrorInvalidValue;
    if (B == 0) return cudaSuccess;
    MlpRingArgs a{MlpArgs{x, nw, wg, wu, wd, static_cast<const float*>(sg),
                          static_cast<const float*>(su),
                          static_cast<const float*>(sd), out, ff_ws, B, D,
                          F, residual, eps, 0, 0, 0, 0, 0, F, nullptr, 0,
                          1, nullptr},
                  RingArgs{}};
    const void* w_up[2] = {wg, wu};
    const void* s_up[2] = {sg, su};
    a.ring.ph[2] = ring_phase_plan(2, wbits, 2, w_up, s_up, n_up, D,
                                   up_parts, nullptr);
    a.ring.ph[3] = ring_phase_plan(3, wbits, 1, &wd, &sd, n_down, F,
                                   down_parts, ff_ws);
    a.ring.part = static_cast<float*>(ring_ws);
    a.ring.tickets = static_cast<int*>(tickets);
    return launch_coop(kernel, a, smem, grid, st);
  }
  if (body != 0 && body != 1) return cudaErrorInvalidValue;
  const auto kernel = body ? mlp_tc_kernel(dtype, wbits)
                           : mlp_kernel(dtype, wbits);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  if (body == 1) {
    if (up_lpr != 0 || down_lpr != 0 || up_tiles != cdiv(F, kUpCols) ||
        down_tiles != cdiv(D, kDownCols) || row_tiles != cdiv(B, kTileRows) ||
        down_k != F || F % 16 || D % 32 || down_parts < 1 ||
        down_parts > 8 || (size_t)smem != mlp_tc_smem(wbits))
      return cudaErrorInvalidValue;
  } else if (!plan_ok(up_lpr, up_tiles) || !plan_ok(down_lpr, down_tiles) ||
             down_k < 0 || down_k > F) {
    return cudaErrorInvalidValue;
  }
  if (B == 0) return cudaSuccess;
  char* h_ws = body ? static_cast<char*>(ff_ws) +
                          ((size_t)B * F + 7) / 8 * 8 * sizeof(bf16)
                    : nullptr;
  float* part_ws =
      body ? reinterpret_cast<float*>(
                 h_ws + ((size_t)B * D * sizeof(bf16) + 15) / 16 * 16)
           : nullptr;
  MlpArgs a{x, nw, wg, wu, wd, static_cast<const float*>(sg),
            static_cast<const float*>(su), static_cast<const float*>(sd),
            out, ff_ws, B, D, F, residual, eps, (size_t)region, up_lpr,
            up_tiles, down_lpr, down_tiles, down_k, h_ws, row_tiles,
            body ? down_parts : 1, part_ws};
  return launch_coop(kernel, a, smem, grid, st);
}

// ws_t (T): attn_args' qkv and attention rows, then ff [P][F][8] at an
// offset rounded up to 8 elements; ws_f (f32): attn_args' partials and
// scores, then resid [B][D] at an offset rounded up to 4 floats. body 0:
// the CUDA-core body; body 1: the weight-ring body (weight_ring.cuh: bf16,
// bf16, int8 or int4 weights, B <= 8, the widths ring_phase_ok takes in
// every phase), whose plan is the
// parts of K of each product phase (1 to kRingMaxParts), at its own shared
// memory (ring_smem), with ring_ws the f32 partials [parts * (1 +
// paired)][8][cols] of its widest phase and tickets one int per tile of
// its widest phase, 0 before the launch (each launch leaves them 0; one
// launch at a time may hold them).
extern "C" int decode_block_fused(
    const void* x, const void* nw, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* pw, const void* wg,
    const void* wu, const void* wd, const void* sq, const void* sk,
    const void* sv, const void* so, const void* sg, const void* su,
    const void* sd, const void* sin, const void* cos, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale,
    const void* tables, const void* seq_lens, void* x_out, void* k_new,
    void* v_new, void* ws_t, void* ws_f, void* ring_ws, void* tickets,
    int B, int D, int H, int KV, int hd, int F, int BS, int MB,
    int rope_rows, int region, int smem, int wbits, int kvbits, int grid,
    int qkv_lpr, int q_tiles, int kv_tiles, int o_lpr, int o_tiles,
    int up_lpr, int up_tiles, int down_lpr, int down_tiles, int body,
    int qkv_parts, int o_parts, int up_parts, int down_parts, float eps,
    float scale, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  using namespace paddle_tpu_torch::fused;
  if (body != 0 && body != 1) return cudaErrorInvalidValue;
  const auto kernel = body ? ring_kernel(dtype, wbits, kvbits)
                           : block_kernel(dtype, wbits, kvbits);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const int item = dtype == 1 ? 2 : 4;
  const int nq = H * hd, nkv = KV * hd;
  if (body == 0) {
    if (!plan_ok(qkv_lpr, q_tiles) || !plan_ok(qkv_lpr, kv_tiles) ||
        !plan_ok(o_lpr, o_tiles) || !plan_ok(up_lpr, up_tiles) ||
        !plan_ok(down_lpr, down_tiles))
      return cudaErrorInvalidValue;
  } else {
    const int parts[4] = {qkv_parts, o_parts, up_parts, down_parts};
    const int n_qkv[3] = {nq, nkv, nkv}, n_o[1] = {D}, n_up[2] = {F, F};
    const size_t attn = kvbits ? attn_item_bytes<int8_t>(H / KV, hd, BS)
                               : attn_item_bytes<ring_bf16>(H / KV, hd, BS);
    if (B > kRB || !ring_parts_ok(parts, 4) ||
        !ring_phase_ok(wbits, 0, D, n_qkv, 3) ||
        !ring_phase_ok(wbits, 1, nq, n_o, 1) ||
        !ring_phase_ok(wbits, 2, D, n_up, 2) ||
        !ring_phase_ok(wbits, 3, F, n_o, 1) ||
        (size_t)smem != ring_smem_bits(wbits, D, attn, kRingTeams))
      return cudaErrorInvalidValue;
  }
  if (B == 0) return cudaSuccess;
  const int plan[5] = {qkv_lpr, q_tiles, kv_tiles, o_lpr, o_tiles};
  const AttnArgs attn = attn_args(
      x, nw, wq, wk, wv, wo, sq, sk, sv, so, sin, cos, k_pool, v_pool,
      k_scale, v_scale, tables, seq_lens, nullptr, k_new, v_new, ws_t, ws_f,
      B, D, H, KV, hd, BS, MB, rope_rows, 1, region, eps, scale, item, plan);
  const size_t n_qkv = ((size_t)B * (H + 2 * KV) * hd + 7) / 8 * 8;
  const size_t n_t = n_qkv + (size_t)passes(B) * kRB * H * hd;
  const size_t n_part = (size_t)B * H * splits(MB);
  const size_t n_f = (2 * n_part + n_part * hd + (size_t)B * H + 3) / 4 * 4;
  float* resid = static_cast<float*>(ws_f) + n_f;
  const MlpArgs mlp{resid, pw, wg, wu, wd, static_cast<const float*>(sg),
                    static_cast<const float*>(su),
                    static_cast<const float*>(sd), x_out,
                    static_cast<char*>(ws_t) + n_t * item, B, D, F, 1, eps,
                    (size_t)region, up_lpr, up_tiles, down_lpr, down_tiles,
                    F};
  RingArgs ring{};
  if (body == 1) {
    // slots: q/k/v concatenate their columns; gate and up are paired
    const void* w[4][kRingSlots] = {{wq, wk, wv}, {wo}, {wg, wu}, {wd}};
    const void* sc[4][kRingSlots] = {{sq, sk, sv}, {so}, {sg, su}, {sd}};
    const int n[4][kRingSlots] = {{nq, nkv, nkv}, {D}, {F, F}, {D}};
    const int nslot[4] = {3, 1, 2, 1}, K[4] = {D, nq, D, F};
    const int parts[4] = {qkv_parts, o_parts, up_parts, down_parts};
    const void* a_src[4] = {nullptr, attn.attn_ws, nullptr, mlp.ff_ws};
    for (int p = 0; p < 4; ++p)
      ring.ph[p] = ring_phase_plan(p, wbits, nslot[p], w[p], sc[p], n[p],
                                   K[p], parts[p], a_src[p]);
    ring.part = static_cast<float*>(ring_ws);
    ring.tickets = static_cast<int*>(tickets);
  }
  const BlockArgs a{attn, mlp, resid, ring};
  return launch_coop(kernel, a, smem, grid, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
