// The split page stream every paged decode kernel of the port runs:
// paged_attention.cu's paged_attention_decode and fused_decode_block.cu's
// decode_attn_block and decode_block_fused (their attention phases).
//
// A sequence's pages are cut into splits of kSplitPages pages; one work
// item is (split, sequence, KV head). An item takes its split
// kPagesPerStep pages a step through online_softmax_page_update, one
// staged tile of kPagesPerStep * BS keys, and leaves its f32 partials (the
// running max m, sum l and unnormalised output acc of each query row of
// the head group) in a workspace. The partials of a (sequence, KV head)
// are then combined in split order (combine_splits), after one grid-wide
// barrier: no atomics touch a sum, so two launches give identical bits,
// and the three kernels reduce the pool's pages op for op (the JAX
// package's contract between its unfused and fused paged kernels,
// paddle_tpu/ops/pallas/paged_attention.py:68-76). The fused kernels fold
// their new token in at the combine, from registers.
//
// Each step's K and V are staged by 16-byte cp.async.cg copies into two
// buffers: step i + 1 is in flight while step i reduces, across the
// items a block (or a team of its warps) takes in turn (paged_items), so
// a step's load latency is hidden behind the previous step's softmax (the
// first paged kernel waited out each page's load in turn, 72 pages
// deep). The reduction and its order are the page update's, unchanged.
//
// Shared memory of one item (attn_scratch_floats f32, then the staged
// tiles in the pool's type P: K and V of stage 0, then of stage 1):
//   q, acc [groups][hd]; s [groups][kPagesPerStep * BS]; m, l, alpha
//   [groups]; extra [hd] (the fused kernels' new-token k); padded to 16
//   bytes.
#pragma once

#include "mma_sync.cuh"
#include "online_softmax.cuh"

namespace paddle_tpu_torch {

constexpr int kPagesPerStep = 4;   // KV pages a step streams
constexpr int kSplitPages = 8;     // KV pages of one work item
constexpr int kPageStages = 2;     // staged steps (one in flight)

__host__ __device__ inline int splits(int MB) {
  return (MB + kSplitPages - 1) / kSplitPages;
}

// f32 scratch of one item of ``rows`` query rows (the layout above)
__host__ __device__ inline size_t attn_scratch_floats(int rows, int hd,
                                                      int BS) {
  size_t f = 2 * (size_t)rows * hd + (size_t)rows * kPagesPerStep * BS +
             3 * (size_t)rows + (size_t)hd;
  return (f + 3) / 4 * 4;
}

// The pools and tables an item reads.
struct PagedView {
  const void *k_pool, *v_pool;   // [N][BS][KV][hd] in P
  const int* tables;             // [B][MB]
  int KV, hd, BS, MB;
};

// An item's scratch, carved from the start of ``smem``.
template <typename P>
struct PageScratch {
  float *q, *acc, *s, *m, *l, *alpha, *extra;
  P *k[kPageStages], *v[kPageStages];
};

template <typename P>
__device__ __forceinline__ PageScratch<P> carve_pages(unsigned char* smem,
                                                      int groups, int hd,
                                                      int BS) {
  PageScratch<P> c;
  const int SB = kPagesPerStep * BS;
  c.q = reinterpret_cast<float*>(smem);
  c.acc = c.q + groups * hd;
  c.s = c.acc + groups * hd;
  c.m = c.s + groups * SB;
  c.l = c.m + groups;
  c.alpha = c.l + groups;
  c.extra = c.alpha + groups;
  P* kv = reinterpret_cast<P*>(c.q + attn_scratch_floats(groups, hd, BS));
#pragma unroll
  for (int st = 0; st < kPageStages; ++st) {
    c.k[st] = kv + (size_t)(2 * st) * SB * hd;
    c.v[st] = kv + (size_t)(2 * st + 1) * SB * hd;
  }
  return c;
}

// The copies of one step: pages [pg, pg + kPagesPerStep) of the sequence,
// those past its last live page clamped to it (masked by seq_len in the
// update), KV head kvh, into k_s / v_s [SB][hd]. Every thread of the team
// takes part; the caller commits the group.
template <typename P, typename Team>
__device__ __forceinline__ void stage_step(const PagedView& pv,
                                           const int* table, int seq_len,
                                           int kvh, int pg, P* k_s, P* v_s,
                                           Team team) {
  constexpr int PV = 16 / sizeof(P);   // pool elements a 16-byte copy
  const int row_vecs = pv.hd / PV;
  const int nvec = kPagesPerStep * pv.BS * row_vecs;
  const P* kp = static_cast<const P*>(pv.k_pool);
  const P* vp = static_cast<const P*>(pv.v_pool);
  // each page's first element of this head, read from the table once
  size_t base[kPagesPerStep];
#pragma unroll
  for (int i = 0; i < kPagesPerStep; ++i)
    base[i] = ((size_t)table[clamped_page_index(seq_len, pv.BS, pg + i)] *
                   pv.BS * pv.KV + kvh) * pv.hd;
  const size_t row = (size_t)pv.KV * pv.hd;   // elements a token
  for (int i = team.tid(); i < nvec; i += team.size()) {
    const int t = i / row_vecs, c = i - t * row_vecs;
    const int pi = t / pv.BS;
    const size_t off = base[pi] + (size_t)(t - pi * pv.BS) * row +
                       (size_t)c * PV;
    cp_async16(k_s + (size_t)i * PV, kp + off, true);
    cp_async16(v_s + (size_t)i * PV, vp + off, true);
  }
}

// One work item's place: its index and split, sequence b, KV head kvh, the
// sequence's length, its pages [p0, p1) and their steps, and the head's
// int8 scales (1 for the model's types).
struct PageItem {
  int item, sp, b, kvh, seq_len, p0, p1, nsteps;
  float ks, vs;
};

// Item ``item`` of a launch's (split, sequence, KV head) items, split
// slowest: false for a split past its sequence's last live page (split 0
// always counts when ``split0``: the fused kernels fold the new token in
// there).
__device__ __forceinline__ bool page_item(int item, int B, int KV, int BS,
                                          int MB, const int* seq_lens,
                                          bool split0, PageItem& it) {
  it.item = item;
  it.kvh = item % KV;
  it.b = (item / KV) % B;
  const int sp = it.sp = item / (KV * B);
  it.seq_len = seq_lens[it.b];
  const int n_pages = min((it.seq_len + BS - 1) / BS, MB);   // 0 if 0
  it.p0 = sp * kSplitPages;
  it.p1 = min(it.p0 + kSplitPages, n_pages);
  it.nsteps = max(0, (it.p1 - it.p0 + kPagesPerStep - 1) / kPagesPerStep);
  it.ks = it.vs = 1.f;
  return it.p0 < n_pages || (split0 && sp == 0);
}

// A team's work items through one continuous page stream: items first,
// first + stride, ... below n; ``live(i, &it)`` fills item i's place and
// says whether the team takes it (an item past its sequence's pages is
// skipped); ``start(it)`` readies the item's running state (c.q set;
// c.acc, c.m, c.l at their start) and anything else it computes once;
// ``finish(it)`` stores its partials (store_partials). Each item's pages
// go through online_softmax_page_update kPagesPerStep a step; the next
// step, of this item or of the team's next item, is staged by cp.async
// while one reduces, so only the team's first step waits out its load.
// Every thread of the team calls it; it leaves none of its copies in
// flight.
template <typename P, typename Team, typename Live, typename Start,
          typename Finish>
__device__ void paged_items(const PagedView& pv, const PageScratch<P>& c,
                            int first, int stride, int n, int groups,
                            float scale, Team team, Live live, Start start,
                            Finish finish) {
  const int SB = kPagesPerStep * pv.BS;
  auto next_live = [&](int from, PageItem& it) {
    for (int i = from; i < n; i += stride)
      if (live(i, it)) return true;
    return false;
  };
  auto stage = [&](const PageItem& it, int j, int buf) {
    stage_step<P>(pv, pv.tables + (size_t)it.b * pv.MB, it.seq_len, it.kvh,
                  it.p0 + j * kPagesPerStep, c.k[buf], c.v[buf], team);
  };
  PageItem cur;
  bool have = next_live(first, cur);
  bool staged = false;   // cur's first step is in buffer ``buf``
  int buf = 0;
  while (have) {
    if (cur.nsteps > 0 && !staged) {
      team.sync();   // earlier readers of the buffers are done
      stage(cur, 0, buf);
      cp_async_commit();
    }
    start(cur);
    PageItem nx;
    bool nx_have = false, nx_staged = false;
    for (int j = 0; j < cur.nsteps; ++j) {
      // the step after this one: cur's next, or the next item's first
      if (j + 1 < cur.nsteps) {
        stage(cur, j + 1, buf ^ 1);
      } else {
        nx_have = next_live(cur.item + stride, nx);
        if (nx_have && nx.nsteps > 0) {
          stage(nx, 0, buf ^ 1);
          nx_staged = true;
        }
      }
      cp_async_commit();
      cp_async_wait1();   // step j has landed, for this thread
      team.sync();        // ... for every thread
      online_softmax_page_update<P>(
          c.q, c.k[buf], c.v[buf], (cur.p0 + j * kPagesPerStep) /
          kPagesPerStep, SB, cur.seq_len, scale, groups, pv.hd, c.s, c.m,
          c.l, c.alpha, c.acc, cur.ks, cur.vs, team);
      team.sync();        // its readers are done before the buffer refills
      buf ^= 1;
    }
    if (cur.nsteps == 0) nx_have = next_live(cur.item + stride, nx);
    finish(cur);
    cur = nx;
    have = nx_have;
    staged = nx_staged;
  }
  cp_async_wait0();
}

// The item's partials into the workspace: m, l [item][groups], acc
// [item][groups][hd], ``pidx`` = item * groups. Synchronises the team
// after, so the next item may reuse the scratch.
template <typename P, typename Team = BlockTeam>
__device__ __forceinline__ void store_partials(const PageScratch<P>& c,
                                               float* part_m, float* part_l,
                                               float* part_acc, size_t pidx,
                                               int groups, int hd,
                                               Team team = Team()) {
  team.sync();
  for (int i = team.tid(); i < groups * hd; i += team.size())
    part_acc[pidx * hd + i] = c.acc[i];
  for (int g = team.tid(); g < groups; g += team.size()) {
    part_m[pidx + g] = c.m[g];
    part_l[pidx + g] = c.l[g];
  }
  team.sync();
}

// Output element (g, d) of one (sequence, KV head) whose partials start at
// item ``pbase`` (pbase + sp for split sp): the ``ns`` live splits
// combined in split order into (o, l), after the new token's term where
// kNew (score snew, value vn; always unmasked). The caller divides: o / l,
// and l is 0 only for a sequence with no key at all.
template <bool kNew>
__device__ __forceinline__ float2 combine_splits(
    const float* part_m, const float* part_l, const float* part_acc,
    size_t pbase, int ns, int groups, int g, int d, int hd, float snew,
    float vn) {
  float mx = kNew ? snew : -CUDART_INF_F;
  for (int sp = 0; sp < ns; ++sp)
    mx = fmaxf(mx, part_m[(pbase + sp) * groups + g]);
  float l, o;
  if constexpr (kNew) {
    const float pn = expf(snew - mx);
    l = pn;
    o = pn * vn;
  } else {
    l = 0.f;
    o = 0.f;
  }
  for (int sp = 0; sp < ns; ++sp) {
    const size_t pi = (pbase + sp) * groups + g;
    const float w = expf(part_m[pi] - mx);
    l += w * part_l[pi];
    o += w * part_acc[pi * hd + d];
  }
  return make_float2(o, l);
}

}  // namespace paddle_tpu_torch
