// The weight ring of the single-launch decode kernel's bf16 body
// (fused_decode_block.cu, decode_block_fused at up to 8 rows in bf16 with
// bf16 weights): every product phase (q/k/v, o_proj, gate/up, down)
// streams its weights through shared memory and multiplies them on the
// tensor cores.
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
// points stay: f32 sums, q/k/v and g/u cast to bf16, o and down kept in
// f32 into the residual.
//
// Parts. An item of a split K leaves f32 partial sums [part][8][cols]
// in a workspace; the last of a tile's items to finish (a ticket counter
// per tile, atomicAdd after a fence) adds the tile's parts in part order,
// whatever the order they arrived in, and runs the phase's epilogue; it
// sets the counter back to 0 for the next launch. So the sums are the same
// in every launch, and no atomic touches a value.
#pragma once

#include "block_products.cuh"
#include "mma_sync.cuh"

namespace paddle_tpu_torch {
namespace fused {

using ring_bf16 = __nv_bfloat16;

constexpr int kRingCols = 128;   // output columns a tile (256 B of a row)
constexpr int kRingK = 64;       // k rows a chunk
constexpr int kRingStages = 4;   // chunks in the ring, kRingStages - 1 in flight
constexpr int kRingLdw = kRingCols + 8;   // bf16 a staged weight row (8 of
                                          // padding: ldmatrix conflict-free)
constexpr int kRingWBytes = kRingK * kRingLdw * 2;
constexpr int kRingABytes = kRingK * kRB * 2;   // a staged activation chunk
constexpr int kRingStageBytes = kRingWBytes + kRingABytes;
constexpr int kRingSlots = 3;    // weights (or column ranges) a phase holds
constexpr int kRingMaxParts = 4; // parts of K a phase splits into, at most

// One product phase. Its items are slot-major: slot s (a weight of a
// phase that concatenates its outputs, q/k/v; or one of two paired weights
// over the same columns, gate and up) holds tiles[s] * parts items, part-
// major; item (s, part, t) reads rows [part * part_rows, +part_rows) of
// column tile t of w[s].
struct RingPhase {
  const ring_bf16* w[kRingSlots];
  int n[kRingSlots];       // columns of each slot's weight
  int out0[kRingSlots];    // its first output column in the phase's row
  int first[kRingSlots];   // its first item
  int tiles[kRingSlots];   // its column tiles
  int tick0[kRingSlots];   // its first ticket (paired slots share theirs)
  int nslot, paired;       // paired: the slots are gate and up
  int parts, part_rows, K, ncols;   // ncols: the phase's output columns
  int items;
  const ring_bf16* a_src;  // staged activations [K][8], or null: resident
};

struct RingArgs {
  RingPhase ph[4];   // q/k/v, o_proj, gate/up, down
  float* part;       // f32 partials [parts * (1 + paired)][8][ncols]
  int* tickets;      // one per tile of a phase; 0 between launches
};

__device__ __forceinline__ int ring_cpi(const RingPhase& f) {
  return f.part_rows / kRingK;   // chunks an item
}

__device__ __forceinline__ int ring_mine(const RingPhase& f) {
  return f.items > (int)blockIdx.x
             ? (f.items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
             : 0;
}

struct RingItem {
  const ring_bf16* w;
  int n, col0, out0, ticket, part, slot;
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
  it.col0 = t * kRingCols;
  it.out0 = f.out0[s];
  it.ticket = f.tick0[s] + t;
  it.slot = s;
  return it;
}

// A chunk's place: phase p, the block's j-th item of it (``it``), chunk ci
// of that item, its first row of k.
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

__device__ __forceinline__ void ring_step(const RingArgs& r, RingPos& q) {
  if (++q.ci < ring_cpi(r.ph[q.p])) {
    q.k0 += kRingK;
    return;
  }
  q = ring_pos(r, q.p, q.j + 1);
}

__device__ __forceinline__ Ring ring_init(const RingArgs& r) {
  Ring g;
  g.base[0] = 0;
  for (int p = 0; p < 4; ++p)
    g.base[p + 1] = g.base[p] + ring_mine(r.ph[p]) * ring_cpi(r.ph[p]);
  g.gi = 0;
  g.stop = g.base[4];
  g.open = 0;
  g.at = ring_pos(r, 0, 0);
  return g;
}

// The copies of the chunk at ``q`` into stage ``c % kRingStages``: the
// weight tile's rows (zeros past K and past the weight's columns), and
// the activation rows where the phase stages them (``with_a``). Every
// thread takes part; no commit.
__device__ __forceinline__ void ring_copy(const RingArgs& r,
                                          const RingPos& q,
                                          unsigned char* ring, int c,
                                          bool with_w, bool with_a) {
  const RingPhase& f = r.ph[q.p];
  const RingItem& it = q.it;
  unsigned char* st = ring + (size_t)(c % kRingStages) * kRingStageBytes;
  if (with_w) {
    constexpr int kSegs = kRingCols / 8;   // 16-byte copies a row
    const int s = threadIdx.x % kSegs, col = it.col0 + s * 8;
    const bool col_ok = col < it.n;
    for (int row = threadIdx.x / kSegs; row < kRingK;
         row += kThreads / kSegs) {
      const int k = q.k0 + row;
      const bool ok = col_ok && k < f.K;
      cp_async16(st + (size_t)row * kRingLdw * 2 + s * 16,
                 ok ? it.w + (size_t)k * it.n + col : it.w, ok);
    }
  }
  if (with_a && f.a_src != nullptr) {
    unsigned char* at = st + kRingWBytes;
    for (int row = threadIdx.x; row < kRingK; row += kThreads) {
      const bool ok = q.k0 + row < f.K;
      cp_async16(at + row * 16, ok ? f.a_src + (size_t)(q.k0 + row) * kRB
                                   : f.a_src, ok);
    }
  }
}

// Issue the next chunk (gi), weights and, where its phase is open, its
// activation rows; no commit.
__device__ __forceinline__ void ring_issue(const RingArgs& r, Ring& g,
                                           unsigned char* ring) {
  ring_copy(r, g.at, ring, g.gi, true, g.at.p <= g.open);
  ring_step(r, g.at);
  ++g.gi;
}

// Issue chunks [gi, upto) (never past ``stop``), one commit group each.
__device__ __forceinline__ void ring_prefetch(const RingArgs& r, Ring& g,
                                              unsigned char* ring, int upto) {
  upto = min(upto, g.stop);
  while (g.gi < upto) {
    ring_issue(r, g, ring);
    cp_async_commit();
  }
}

// The barrier before phase p has passed: the activation rows of its
// chunks already issued (weights only) follow, in one group.
__device__ __forceinline__ void ring_open(const RingArgs& r, Ring& g,
                                          unsigned char* ring, int p) {
  g.open = p;
  if (r.ph[p].a_src != nullptr) {
    RingPos q = ring_pos(r, p, 0);
    for (int c = g.base[p]; c < min(g.gi, g.base[p + 1]); ++c) {
      ring_copy(r, q, ring, c, false, true);
      ring_step(r, q);
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
// 2 (lane % 4) (+ 1)) += the chunk's weight tile x its 8 activation rows
// (k-major [kRingK][8] at ``a``), its four depth steps summed from zero
// first.
__device__ __forceinline__ void ring_mma(const unsigned char* st,
                                         const ring_bf16* a,
                                         float (&acc)[4]) {
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

// Phase p of the ring: every item of this block, chunk by chunk, then its
// epilogue: ``out(row, col, v)`` with the f32 sums v[0] (and v[1], the
// paired weight's), col the phase's output column. ``a_res``: the
// resident activation rows [K][8] when the phase stages none. The running
// issue keeps kRingStages - 1 chunks in flight, up to ``g.stop``.
// ``flag``: one int of shared memory. Every thread takes part.
template <typename Out>
__device__ void ring_phase(const RingArgs& r, Ring& g, unsigned char* ring,
                           const ring_bf16* a_res, int p, int B, int* flag,
                           Out out) {
  const RingPhase& f = r.ph[p];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cpi = ring_cpi(f), mine = ring_mine(f);
  const int need = f.parts * (f.paired ? 2 : 1);
  for (int j = 0; j < mine; ++j) {
    const RingItem it = ring_item(f, (int)blockIdx.x + j * (int)gridDim.x);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ci = 0; ci < cpi; ++ci) {
      const int c = g.base[p] + j * cpi + ci;
      if (c == g.base[p])
        cp_async_wait0();
      else
        cp_async_wait<kRingStages - 2>();
      __syncthreads();   // chunk c has landed for all; c - 1's readers done
      if (g.gi == c + kRingStages - 1 && g.gi < g.stop)
        ring_issue(r, g, ring);   // into the stage chunk c - 1 read
      cp_async_commit();
      const int k0 = it.part * f.part_rows + ci * kRingK;
      if (k0 < f.K) {   // block-uniform: a chunk wholly past K adds 0
        const unsigned char* st =
            ring + (size_t)(c % kRingStages) * kRingStageBytes;
        ring_mma(st,
                 f.a_src != nullptr
                     ? reinterpret_cast<const ring_bf16*>(st + kRingWBytes)
                     : a_res + (size_t)k0 * kRB,
                 acc);
      }
    }
    // the lane's outputs: columns it.col0 + 16 warp + lane / 4 (+ 8 for
    // e >= 2), rows 2 (lane % 4) + (e & 1)
    const int col_l = it.col0 + warp * 16 + (lane >> 2);
    if (need == 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 2 * (lane & 3) + (e & 1), col = col_l + 8 * (e >> 1);
        if (row < B && col < it.n) out(row, it.out0 + col, &acc[e]);
      }
      continue;
    }
    const int pslot = f.paired ? it.part * 2 + it.slot : it.part;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 2 * (lane & 3) + (e & 1), col = col_l + 8 * (e >> 1);
      if (row < B && col < it.n)
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
      for (int i = threadIdx.x; i < kRB * kRingCols; i += kThreads) {
        const int row = i / kRingCols, col = it.col0 + i % kRingCols;
        if (row >= B || col >= it.n) continue;
        float v[2];
        for (int m = 0; m < (f.paired ? 2 : 1); ++m) {
          float s = 0.f;
          for (int q = 0; q < f.parts; ++q) {
            const int ps = f.paired ? q * 2 + m : q;
            const float x = __ldcg(
                r.part + ((size_t)ps * kRB + row) * f.ncols + it.out0 + col);
            s = q == 0 ? x : s + x;
          }
          v[m] = s;
        }
        out(row, it.out0 + col, v);
      }
    }
  }
}

}  // namespace fused
}  // namespace paddle_tpu_torch
