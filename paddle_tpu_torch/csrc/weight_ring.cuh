// The weight ring of the decode kernels' bf16 bodies at up to 8 rows
// (fused_decode_block.cu: decode_block_fused, and the two-stage
// decode_attn_block and decode_mlp_block, with bf16, int8 or int4
// weights): every product phase (q/k/v, o_proj, gate/up, down) streams its
// weights through shared memory and multiplies them on the tensor cores.
// A kernel runs the phases it holds; a phase it does not hold has no item
// (its parts are 0) and no chunk, so one RingArgs serves all three.
//
// Why. At 8 rows a decode layer is a stream of ~404 MB of weights (LLaMA-7B
// in bf16) with ~2 flops a byte. The CUDA-core body (block_products.cuh's
// tile routine) holds its weight loads in registers, four 16-byte loads a
// thread, one block an SM (234 registers): ~16 KB in flight an SM, which
// Little's law puts at the edge of what 3.35 TB/s needs, and each weight
// row is read in runs of at most 128 bytes; each grid barrier drained that
// stream and the next phase started cold.
//
// The ring. A phase's work items are (column tile of kRingCols columns of
// one weight, part of K): K is split into ``parts`` so that the items fill
// the grid (the wrapper's plan, fused_decode_block.ring_plan). An item is
// a run of chunks of kRingK rows of its tile (kRingCols * 2 = 256 bytes of
// each weight row, 16 KB a chunk); each block walks its items' chunks, all
// phases' in one sequence, through a ring of kRingStages chunks in shared
// memory, filled by 16-byte cp.async.cg copies of all threads with
// kRingStages - 1 chunks in flight. Weights never depend on a barrier, so
// the chunks of the next product phase are issued before the grid-wide
// barrier that precedes it (ring_prefetch, and the running issue crossing
// a phase's end): no phase starts cold. The activation operand (8 rows,
// k-major [K][8] bf16, the layout of the CUDA-core body) is either
// resident in shared memory for the whole phase (the RMSNorm of the rows:
// q/k/v, gate/up) or staged beside each weight chunk (the attention rows
// for o_proj, silu(g)*u for down); a staged chunk's rows are issued only
// once the barrier before its phase has passed (ring_open).
//
// The products: mma.sync m16n8k16 in the "swap AB" form: the weight tile
// is the 16-row operand (ldmatrix.trans of 16 k x 16 columns from the
// ring, so the m index is the output column) and the 8 activation rows
// are the n = 8 operand (ldmatrix.trans of the k-major rows), so no half
// of a tile is empty at 8 rows. Warp w takes columns [16w, 16w + 16) of
// each chunk over all its k; each chunk's four depth steps are summed from
// zero and then added to the f32 sum (the tensor core's running sum
// truncates: mma_sync.cuh's mma2_rn lesson). decode_block_ref's rounding
// points stay (f32 sums, q/k/v and g/u cast to bf16, o and down kept in
// f32 into the residual), and so do the two-stage kernels' (o and down
// cast to bf16 before the residual add): the epilogue is each kernel's.
//
// Parts. An item of a split K leaves f32 partial sums [part][8][cols]
// in a workspace; the last of a tile's items to finish (a ticket counter
// per tile, atomicAdd after a fence) adds the tile's parts in part order,
// whatever the order they arrived in, and runs the phase's epilogue; it
// sets the counter back to 0 for the next launch. So the sums are the same
// in every launch, and no atomic touches a value. The counters belong to
// one launch at a time: the wrapper keeps a buffer per (device, stream),
// which the three ring kernels share (launches on one stream run in turn,
// and each leaves its counters at 0).
//
// Quantized weights (block_products.cuh's classes: int8 [K][N]; int4
// packed along K, [K/2][N], byte (k', c) holding rows k' and k' + K/2;
// int4 packed along N for down, [K][N/2], byte (k, c') holding columns c'
// and c' + N/2). The ring carries the stored codes unchanged: a chunk is
// 128 stored rows of a tile of 128 stored columns, 16 KB as in bf16, so as
// many bytes stay in flight while a chunk holds twice (int8) or four times
// (int4) the weights. Its rows sit in 128 bytes with their 16-byte
// segments swizzled (segment s of row r at s ^ (r % 8)), so ldmatrix reads
// eight rows without a bank conflict and no padding is stored. The codes
// reach the tensor cores without a staged bf16 copy: ldmatrix.trans of the
// raw bytes as b16 pairs gives lane (g, t) the four codes of stored rows
// 2t, 2t + 1 and columns 2g, 2g + 1 of a 16 x 16 block, which are exactly
// one m16n8k16 A fragment's elements once the fragment's row m = g stands
// for column 2g and m = g + 8 for column 2g + 1 (the epilogue maps them
// back); the codes are converted in registers, exactly (mma_sync.cuh's
// s8x2_bf16, s4x2_bf16). An int4 along K byte's high nibbles are rows
// k' + K/2, a second depth step against the activation rows K/2 on (the
// resident rows, or a second staged range of o_proj's rows); an int4
// along N byte's high nibbles are columns N/2 on, a second accumulator
// over the same activation fragment. Each product's f32 sum is multiplied
// by its column's f32 scale (the slot's own, indexed by the weight's own
// column) after the whole of K: after the parts are added, in the last
// arriver's epilogue, and only then cast, roped, SiLU'd or added to the
// residual, at the kernel's rounding points.
#pragma once

#include "block_products.cuh"
#include "mma_sync.cuh"

namespace paddle_tpu_torch {
namespace fused {

using ring_bf16 = __nv_bfloat16;

constexpr int kRingCols = 128;   // stored columns a tile (256 B of a bf16 row)
constexpr int kRingK = 64;       // k rows a chunk of bf16 weights
constexpr int kRingStages = 4;   // chunks in the ring, kRingStages - 1 in flight
constexpr int kRingLdw = kRingCols + 8;   // bf16 a staged weight row (8 of
                                          // padding: ldmatrix conflict-free)
constexpr int kRingQRows = 128;  // stored rows a chunk of int8 / int4 codes
constexpr int kRingSlots = 3;    // weights (or column ranges) a phase holds
constexpr int kRingMaxParts = 4; // parts of K a phase splits into, at most

// The ring's geometry under the kernel's weight bits (0: bf16, 8, 4):
// stored rows a chunk, bytes of a staged weight row and of a stage (the
// weights, then the activation rows where a phase stages them: two ranges
// of a chunk's rows for int4 packed along K).
template <int WQ>
struct RingGeom {
  static constexpr int rows = WQ ? kRingQRows : kRingK;
  static constexpr int esz = WQ ? 1 : 2;             // bytes a stored element
  static constexpr int ldw = WQ ? kRingCols : kRingLdw * 2;
  static constexpr int wbytes = rows * ldw;
  static constexpr int arows = WQ == 4 ? 2 * rows : rows;
  static constexpr int stage = wbytes + arows * kRB * 2;
};

// One product phase. Its items are slot-major: slot s (a weight of a
// phase that concatenates its outputs, q/k/v; or one of two paired weights
// over the same columns, gate and up) holds tiles[s] * parts items, part-
// major; item (s, part, t) reads stored rows [part * part_rows,
// +part_rows) of stored column tile t of w[s].
struct RingPhase {
  const unsigned char* w[kRingSlots];
  const float* s[kRingSlots];   // f32 scales [n] of a quantized slot, or null
  int n[kRingSlots];       // columns of each slot's weight
  int ns[kRingSlots];      // its stored columns (n / 2: int4 along N)
  int out0[kRingSlots];    // its first output column in the phase's row
  int first[kRingSlots];   // its first item
  int tiles[kRingSlots];   // its stored column tiles
  int tick0[kRingSlots];   // its first ticket (paired slots share theirs)
  int nslot, paired;       // paired: the slots are gate and up
  int parts, part_rows, K, ncols;   // ncols: the phase's output columns
  int kn;                  // stored rows of K (K / 2: int4 along K)
  int half;                // int4 along K: K / 2, the high nibbles' rows
  int items;
  const ring_bf16* a_src;  // staged activations [K][8], or null: resident
};

struct RingArgs {
  RingPhase ph[4];   // q/k/v, o_proj, gate/up, down
  float* part;       // f32 partials [parts * (1 + paired)][8][ncols]
  int* tickets;      // one per tile of a phase; 0 between launches
};

template <int WQ>
__device__ __forceinline__ int ring_cpi(const RingPhase& f) {
  return f.part_rows / RingGeom<WQ>::rows;   // chunks an item
}

__device__ __forceinline__ int ring_mine(const RingPhase& f) {
  return f.items > (int)blockIdx.x
             ? (f.items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
             : 0;
}

struct RingItem {
  const unsigned char* w;
  int n, ns, col0, out0, ticket, part, slot;
};

__device__ __forceinline__ RingItem ring_item(const RingPhase& f, int i) {
  int s = 0;
  while (s + 1 < f.nslot && i >= f.first[s + 1]) ++s;
  const int j = i - f.first[s];
  RingItem it;
  it.part = j / f.tiles[s];
  const int t = j - it.part * f.tiles[s];
  it.w = f.w[s];
  it.n = f.n[s];
  it.ns = f.ns[s];
  it.col0 = t * kRingCols;
  it.out0 = f.out0[s];
  it.ticket = f.tick0[s] + t;
  it.slot = s;
  return it;
}

// A chunk's place: phase p, the block's j-th item of it (``it``), chunk ci
// of that item, its first stored row.
struct RingPos {
  int p, j, ci, k0;
  RingItem it;
};

// A block's place in its sequence of chunks: phase p's chunks are
// [base[p], base[p + 1]); ``gi`` the next chunk to issue and ``at`` its
// place (kept by stepping, so a chunk's addresses cost no division);
// ``stop`` the first chunk that the running issue may not reach yet,
// ``open`` the last phase whose activation chunks may be issued.
struct Ring {
  int base[5];
  int gi, stop, open;
  RingPos at;
};

// The place of the block's first chunk of phase p at or after its j-th
// item (phases with no item of this block skipped).
__device__ __forceinline__ RingPos ring_pos(const RingArgs& r, int p,
                                            int j) {
  RingPos q;
  for (; p < 4 && j >= ring_mine(r.ph[p]); ++p) j = 0;
  q.p = p;
  q.j = j;
  q.ci = 0;
  if (p < 4) {
    q.it = ring_item(r.ph[p], (int)blockIdx.x + j * (int)gridDim.x);
    q.k0 = q.it.part * r.ph[p].part_rows;
  }
  return q;
}

template <int WQ>
__device__ __forceinline__ void ring_step(const RingArgs& r, RingPos& q) {
  if (++q.ci < ring_cpi<WQ>(r.ph[q.p])) {
    q.k0 += RingGeom<WQ>::rows;
    return;
  }
  q = ring_pos(r, q.p, q.j + 1);
}

template <int WQ>
__device__ __forceinline__ Ring ring_init(const RingArgs& r) {
  Ring g;
  g.base[0] = 0;
  for (int p = 0; p < 4; ++p)
    g.base[p + 1] = g.base[p] + ring_mine(r.ph[p]) * ring_cpi<WQ>(r.ph[p]);
  g.gi = 0;
  g.stop = g.base[4];
  g.open = 0;
  g.at = ring_pos(r, 0, 0);
  return g;
}

// Byte offset of 16-byte segment ``seg`` of staged weight row ``row``:
// bf16 rows padded, code rows swizzled (the file header).
template <int WQ>
__device__ __forceinline__ int ring_wseg(int row, int seg) {
  if constexpr (WQ != 0) return row * kRingCols + ((seg ^ (row & 7)) << 4);
  return row * kRingLdw * 2 + (seg << 4);
}

// The copies of the chunk at ``q`` into stage ``c % kRingStages``: the
// weight tile's stored rows (zeros past the stored rows and columns), and
// the activation rows where the phase stages them (``with_a``; int4 along
// K: rows [k0, k0 + rows) and [half + k0, ...) one after the other).
// Every thread takes part; no commit.
template <int WQ>
__device__ __forceinline__ void ring_copy(const RingArgs& r,
                                          const RingPos& q,
                                          unsigned char* ring, int c,
                                          bool with_w, bool with_a) {
  using G = RingGeom<WQ>;
  const RingPhase& f = r.ph[q.p];
  const RingItem& it = q.it;
  unsigned char* st = ring + (size_t)(c % kRingStages) * G::stage;
  if (with_w) {
    constexpr int kSegs = kRingCols * G::esz / 16;   // 16-byte copies a row
    const int s = threadIdx.x % kSegs, col = it.col0 + s * (16 / G::esz);
    const bool col_ok = col < it.ns;
    const size_t ld = (size_t)it.ns * G::esz;
    for (int row = threadIdx.x / kSegs; row < G::rows;
         row += kThreads / kSegs) {
      const int k = q.k0 + row;
      const bool ok = col_ok && k < f.kn;
      cp_async16(st + ring_wseg<WQ>(row, s),
                 ok ? it.w + (size_t)k * ld + (size_t)col * G::esz : it.w,
                 ok);
    }
  }
  if (with_a && f.a_src != nullptr) {
    unsigned char* at = st + G::wbytes;
    const int nr = f.half ? 2 * G::rows : G::rows;
    for (int row = threadIdx.x; row < nr; row += kThreads) {
      const int hi = row >= G::rows, kr = q.k0 + row - hi * G::rows;
      const bool ok = kr < f.kn;
      cp_async16(at + row * 16,
                 ok ? f.a_src + (size_t)(hi * f.half + kr) * kRB : f.a_src,
                 ok);
    }
  }
}

// Issue the next chunk (gi), weights and, where its phase is open, its
// activation rows; no commit.
template <int WQ>
__device__ __forceinline__ void ring_issue(const RingArgs& r, Ring& g,
                                           unsigned char* ring) {
  ring_copy<WQ>(r, g.at, ring, g.gi, true, g.at.p <= g.open);
  ring_step<WQ>(r, g.at);
  ++g.gi;
}

// Issue chunks [gi, upto) (never past ``stop``), one commit group each.
template <int WQ>
__device__ __forceinline__ void ring_prefetch(const RingArgs& r, Ring& g,
                                              unsigned char* ring, int upto) {
  upto = min(upto, g.stop);
  while (g.gi < upto) {
    ring_issue<WQ>(r, g, ring);
    cp_async_commit();
  }
}

// The barrier before phase p has passed: the activation rows of its
// chunks already issued (weights only) follow, in one group.
template <int WQ>
__device__ __forceinline__ void ring_open(const RingArgs& r, Ring& g,
                                          unsigned char* ring, int p) {
  g.open = p;
  if (r.ph[p].a_src != nullptr) {
    RingPos q = ring_pos(r, p, 0);
    for (int c = g.base[p]; c < min(g.gi, g.base[p + 1]); ++c) {
      ring_copy<WQ>(r, q, ring, c, false, true);
      ring_step<WQ>(r, q);
    }
  }
  cp_async_commit();
}

// Eight bf16 or f32 values of one row of x from column c (x read-only in
// the launch: the bf16 input, through the read-only path; the f32
// residual, written by other blocks of this launch, from L2).
__device__ __forceinline__ void ring_load8(const ring_bf16* x, size_t o,
                                          float (&v)[8]) {
  unpack<ring_bf16>(__ldg(reinterpret_cast<const uint4*>(x + o)), v);
}
__device__ __forceinline__ void ring_load8(const float* x, size_t o,
                                          float (&v)[8]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(x + o));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(x + o) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The resident activation rows: h_t[k][r] = bf16(bf16(x * rsqrt(mean(x^2)
// + eps)) * nw) for the rows r < B of x [B][D] (In: bf16, or the f32
// residual), zeros for the rest: block_products.cuh's rms_pass rounding,
// with each thread's 8 columns of all rows loaded at once (16-byte loads,
// eight rows in flight), the sum of squares per thread in column order,
// then across lanes and warps in a fixed order. D is a multiple of 8.
// rms_pass's element loads cost the q/k/v phase ~6 µs more (NVIDIA H100
// 80GB HBM3, 700 W); it stays for the CUDA-core body, whose bits it fixes.
// Synchronises the block.
template <typename In>
__device__ void ring_norm(const In* x, const ring_bf16* __restrict__ nw,
                          ring_bf16* h_t, int B, int D, float eps,
                          float* red_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ss[kRB];
#pragma unroll
  for (int r = 0; r < kRB; ++r) ss[r] = 0.f;
  for (int c0 = threadIdx.x * 8; c0 < D; c0 += kThreads * 8) {
    float v[kRB][8];
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      if (r < B) {
        ring_load8(x, (size_t)r * D + c0, v[r]);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) v[r][q] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRB; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) ss[r] = fmaf(v[r][q], v[r][q], ss[r]);
  }
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], off);
  }
  __syncthreads();   // earlier readers of red_s and h_t are done
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
  for (int c0 = threadIdx.x * 8; c0 < D; c0 += kThreads * 8) {
    float v[kRB][8], w[8];
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      if (r < B) {
        ring_load8(x, (size_t)r * D + c0, v[r]);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) v[r][q] = 0.f;
      }
    }
    unpack<ring_bf16>(__ldg(reinterpret_cast<const uint4*>(nw + c0)), w);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      __align__(16) ring_bf16 hk[kRB];
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const float n = round_t<ring_bf16>(__fmul_rn(v[r][q], rstd[r]));
        hk[r] = from_float<ring_bf16>(r < B ? __fmul_rn(n, w[q]) : 0.f);
      }
      *reinterpret_cast<uint4*>(h_t + (size_t)(c0 + q) * kRB) =
          *reinterpret_cast<const uint4*>(hk);
    }
  }
  __syncthreads();
}

// acc (this lane's C fragment: columns 16 warp + lane / 4 (+ 8), rows
// 2 (lane % 4) (+ 1)) += the chunk's bf16 weight tile x its 8 activation
// rows (k-major [kRingK][8] at ``a``), its four depth steps summed from
// zero first.
__device__ __forceinline__ void ring_mma(const unsigned char* st,
                                         const ring_bf16* a,
                                         float (&acc)[8]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const ring_bf16* wt = reinterpret_cast<const ring_bf16*>(st);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k2 = 0; k2 < kRingK / 32; ++k2) {
    uint32_t b4[4];   // rows x k 0-7, 8-15 (step 0), 16-23, 24-31 (step 1)
    ldmatrix4_trans(b4, a + (size_t)(k2 * 32 + lane) * kRB);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t af[4];
      ldmatrix4_trans(af, wt + (size_t)(k2 * 32 + h * 16 + (lane & 7) +
                                        ((lane >> 4) << 3)) * kRingLdw +
                              warp * 16 + ((lane >> 3) & 1) * 8);
      const uint32_t bf[2] = {b4[2 * h], b4[2 * h + 1]};
      mma_bf16(t, af, bf);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// acc += the chunk's code tile (class WC) x its activation rows, each 32
// stored rows' depth steps summed from zero first: the lane's C fragment
// holds stored columns 16 warp + 2 (lane / 4) (e < 2) and + 1 (e >= 2),
// rows 2 (lane % 4) (+ 1); int4 along N: acc[4..7] the same for the high
// nibbles' columns (N/2 on). ``a_lo``: the activation rows of the chunk's
// stored rows; ``a_hi``: int4 along K, the rows of its high nibbles.
template <int WC>
__device__ __forceinline__ void ring_mma_codes(const unsigned char* st,
                                               const ring_bf16* a_lo,
                                               const ring_bf16* a_hi,
                                               float (&acc)[8]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k2 = 0; k2 < kRingQRows / 32; ++k2) {
    // stored rows 32 k2 + 8 m + (0..7) of the warp's 16 columns, as b16
    // pairs: w4[m] = codes (2t, 2g), (2t, 2g + 1), (2t + 1, 2g), (2t + 1,
    // 2g + 1) of rows 8m on
    const int row = k2 * 32 + lane;
    uint32_t w4[4], b4[4], bh[4];
    ldmatrix4_trans(w4, st + ring_wseg<1>(row, warp));
    ldmatrix4_trans(b4, a_lo + (size_t)row * kRB);
    if constexpr (WC == kWInt4K) ldmatrix4_trans(bh, a_hi + (size_t)row * kRB);
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t r0 = w4[2 * h], r1 = w4[2 * h + 1];
      const uint32_t bf[2] = {b4[2 * h], b4[2 * h + 1]};
      if constexpr (WC == kWInt8) {
        const uint32_t af[4] = {s8x2_bf16(r0, 0, 2), s8x2_bf16(r0, 1, 3),
                                s8x2_bf16(r1, 0, 2), s8x2_bf16(r1, 1, 3)};
        mma_bf16(t0, af, bf);
      } else {
        const uint32_t lo[4] = {s4x2_bf16(r0, 0), s4x2_bf16(r0, 8),
                                s4x2_bf16(r1, 0), s4x2_bf16(r1, 8)};
        const uint32_t hi[4] = {s4x2_bf16(r0, 4), s4x2_bf16(r0, 12),
                                s4x2_bf16(r1, 4), s4x2_bf16(r1, 12)};
        mma_bf16(t0, lo, bf);
        if constexpr (WC == kWInt4K) {
          // the high nibbles: rows K/2 on, against their own activations
          const uint32_t bfh[2] = {bh[2 * h], bh[2 * h + 1]};
          mma_bf16(t0, hi, bfh);
        } else {
          // int4 along N: columns N/2 on, the same activations
          mma_bf16(t1, hi, bf);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[e] += t0[e];
      if constexpr (WC == kWInt4N) acc[4 + e] += t1[e];
    }
  }
}

// The output column (in the slot's weight) of accumulator e of this lane
// for a tile at stored column col0, or -1 past the stored columns ns.
template <int WC>
__device__ __forceinline__ int ring_col(int col0, int e, int ns) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = WC == kWFp
                    ? col0 + warp * 16 + (lane >> 2) + 8 * ((e & 3) >> 1)
                    : col0 + warp * 16 + 2 * (lane >> 2) + ((e & 3) >> 1);
  if (c >= ns) return -1;
  return e >= 4 ? c + ns : c;   // int4 along N: the high nibbles' columns
}

// A product's f32 sum v of output column c (of slot s's weight) times its
// column's scale where the weight is quantized.
template <int WC>
__device__ __forceinline__ float ring_scaled(const RingPhase& f, int s,
                                             int c, float v) {
  if constexpr (WC != kWFp) return v * f.s[s][c];
  return v;
}

// The last arriver's epilogue of a tile: each output's partial sums added
// in part order (paired: gate's and up's), scaled, handed to ``out``; a
// thread issues every part's load of an output before the first add.
template <int WC, typename Out>
__device__ __forceinline__ void ring_combine(const RingArgs& r,
                                             const RingPhase& f,
                                             const RingItem& it, int B,
                                             Out out) {
  constexpr int kCols = kRingCols;
  constexpr int kOuts = WC == kWInt4N ? 2 : 1;  // output ranges a tile
  constexpr int kSums = 2 * kRingMaxParts;      // partials an output, at most
  const int nm = f.paired ? 2 : 1;
  const size_t pstride = (size_t)kRB * f.ncols;
  for (int i = threadIdx.x; i < kRB * kCols * kOuts; i += kThreads) {
    const int row = i / (kCols * kOuts);
    const int lc = i % (kCols * kOuts), sc = it.col0 + lc % kCols;
    if (row >= B || sc >= it.ns) continue;
    const int col = sc + (lc / kCols) * it.ns;
    const float* base = r.part + (size_t)row * f.ncols + it.out0 + col;
    float x[kSums];
#pragma unroll
    for (int q = 0; q < kSums; ++q)   // q = part * nm + m
      x[q] = q < f.parts * nm ? __ldcg(base + (size_t)q * pstride) : 0.f;
    float v[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float s = x[m];
#pragma unroll
      for (int q = 1; q < kRingMaxParts; ++q)
        if (q < f.parts) s += x[q * nm + m];
      v[m] = m < nm ? ring_scaled<WC>(f, f.paired ? m : it.slot, col, s)
                    : 0.f;
    }
    out(row, it.out0 + col, v);
  }
}

// Phase p of the ring (weights of class WC under the kernel's bits WQ):
// every item of this block, chunk by chunk, then its epilogue:
// ``out(row, col, v)`` with the scaled f32 sums v[0] (and v[1], the
// paired weight's), col the phase's output column. ``a_res``: the
// resident activation rows [K][8] when the phase stages none. The running
// issue keeps kRingStages - 1 chunks in flight, up to ``g.stop``.
// ``flag``: one int of shared memory. Every thread takes part.
template <int WQ, int WC, typename Out>
__device__ void ring_phase(const RingArgs& r, Ring& g, unsigned char* ring,
                           const ring_bf16* a_res, int p, int B, int* flag,
                           Out out) {
  using G = RingGeom<WQ>;
  constexpr int kAcc = WC == kWInt4N ? 8 : 4;   // accumulators a lane
  const RingPhase& f = r.ph[p];
  const int lane = threadIdx.x & 31;
  const int cpi = ring_cpi<WQ>(f), mine = ring_mine(f);
  const int need = f.parts * (f.paired ? 2 : 1);
  for (int j = 0; j < mine; ++j) {
    const RingItem it = ring_item(f, (int)blockIdx.x + j * (int)gridDim.x);
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int ci = 0; ci < cpi; ++ci) {
      const int c = g.base[p] + j * cpi + ci;
      if (c == g.base[p])
        cp_async_wait0();
      else
        cp_async_wait<kRingStages - 2>();
      __syncthreads();   // chunk c has landed for all; c - 1's readers done
      if (g.gi == c + kRingStages - 1 && g.gi < g.stop)
        ring_issue<WQ>(r, g, ring);   // into the stage chunk c - 1 read
      cp_async_commit();
      const int k0 = it.part * f.part_rows + ci * G::rows;
      if (k0 < f.kn) {   // block-uniform: a chunk wholly past K adds 0
        const unsigned char* st =
            ring + (size_t)(c % kRingStages) * G::stage;
        const ring_bf16* a =
            f.a_src != nullptr
                ? reinterpret_cast<const ring_bf16*>(st + G::wbytes)
                : a_res + (size_t)k0 * kRB;
        if constexpr (WC == kWFp)
          ring_mma(st, a, acc);
        else
          ring_mma_codes<WC>(st, a,
                             a + (size_t)(f.a_src != nullptr ? G::rows
                                                             : f.half) * kRB,
                             acc);
      }
    }
    // the lane's outputs: column ring_col(e), row 2 (lane % 4) + (e & 1)
    if (need == 1) {
#pragma unroll
      for (int e = 0; e < kAcc; ++e) {
        const int row = 2 * (lane & 3) + (e & 1);
        const int col = ring_col<WC>(it.col0, e, it.ns);
        if (row < B && col >= 0) {
          const float v = ring_scaled<WC>(f, it.slot, col, acc[e]);
          out(row, it.out0 + col, &v);
        }
      }
      continue;
    }
    const int pslot = f.paired ? it.part * 2 + it.slot : it.part;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) {
      const int row = 2 * (lane & 3) + (e & 1);
      const int col = ring_col<WC>(it.col0, e, it.ns);
      if (row < B && col >= 0)
        r.part[((size_t)pslot * kRB + row) * f.ncols + it.out0 + col] =
            acc[e];
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int old = atomicAdd(r.tickets + it.ticket, 1);
      *flag = old == need - 1;
      if (old == need - 1) r.tickets[it.ticket] = 0;   // for the next launch
    }
    __syncthreads();
    if (*flag) {   // block-uniform: the tile's last item adds its parts
      __threadfence();
      ring_combine<WC>(r, f, it, B, out);
    }
  }
}

}  // namespace fused
}  // namespace paddle_tpu_torch
