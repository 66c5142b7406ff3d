// Paged KV-cache decode attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py's
// paged_attention_decode_pallas (kernel body _decode_kernel, launch
// "paged_attention_decode"): one query token per sequence attends over
// that sequence's pages of the paged K/V pools, read through its block
// table, with grouped-query attention (groups = H / KV query heads share
// one KV head), the caller's scale (1/sqrt(hd) by default), an f32
// online softmax, and exact zeros for a sequence of length 0.
//
//   q            [B, H, hd]        f32 or bf16
//   k_pool/v_pool[N, BS, KV, hd]   same type as q
//   block_tables [B, MB] int32     physical page of each logical page
//   seq_lens     [B] int32         tokens per sequence, current one included
//   out          [B, H, hd]        q's type
//
// What bounds it on the H100: memory. Each live token's K and V row is
// read once and the arithmetic is ~2 flops a byte, far below the card's
// ~295 flops/byte ridge. The first form of this kernel gave each (KV
// head, sequence) one block, which walked up to 72 pages in turn with each
// page's load exposed: a chain of latencies at 22x the byte bound. It runs
// the split page stream of paged_stream.cuh, the one the fused decode
// kernels run (decode_attn_block, decode_block_fused):
//   - one cooperative launch (block_products.cuh's launch_coop: every
//     co-resident block of 256 threads); the blocks take the work items
//     (split of kSplitPages pages, sequence, KV head) in turn, each item
//     kPagesPerStep pages a step with the next step's K/V in flight
//     (cp.async, two buffers), and leave f32 partials in a workspace;
//     items past a sequence's last live page do nothing;
//   - one grid-wide barrier; then per (sequence, KV head) the partials
//     combined in split order (combine_splits, no new token), out = o / l,
//     and 0 where the sequence has no key.
// So the three paged kernels reduce the pool's pages op for op, and two
// launches give identical bits (no atomics).
#include "block_products.cuh"

namespace paddle_tpu_torch {
namespace fused {

struct PagedArgs {
  const void* q;
  PagedView pv;
  const int* seq_lens;
  void* out;
  float *part_m, *part_l, *part_acc;   // [B][KV][splits][groups](*hd)
  int B, H;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
paged_attention_decode_kernel(const PagedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int KV = a.pv.KV, hd = a.pv.hd, BS = a.pv.BS, MB = a.pv.MB;
  const int groups = a.H / KV, NS = splits(MB), tid = threadIdx.x;
  const PageScratch<T> c = carve_pages<T>(smem, groups, hd, BS);
  const T* q = static_cast<const T*>(a.q);
  paged_items<T>(
      a.pv, c, blockIdx.x, gridDim.x, NS * a.B * KV, groups, a.scale,
      BlockTeam(),
      [&](int i, PageItem& it) {
        return page_item(i, a.B, KV, BS, MB, a.seq_lens, false, it);
      },
      [&](const PageItem& it) {
        const T* qr = q + ((size_t)it.b * a.H + (size_t)it.kvh * groups) * hd;
        for (int i = tid; i < groups * hd; i += kThreads) {
          c.q[i] = to_float(qr[i]);
          c.acc[i] = 0.f;
        }
        for (int g = tid; g < groups; g += kThreads) {
          c.m[g] = -CUDART_INF_F;
          c.l[g] = 0.f;
        }
      },
      [&](const PageItem& it) {
        store_partials<T>(c, a.part_m, a.part_l, a.part_acc,
                          (((size_t)it.b * KV + it.kvh) * NS + it.sp) *
                              groups, groups, hd);
      });
  grid.sync();
  T* out = static_cast<T*>(a.out);
  for (int item = blockIdx.x; item < a.B * KV; item += gridDim.x) {
    const int b = item / KV, kvh = item - b * KV;
    const int n_pages = min((a.seq_lens[b] + BS - 1) / BS, MB);
    const int ns = (n_pages + kSplitPages - 1) / kSplitPages;
    const size_t pbase = ((size_t)b * KV + kvh) * NS;
    const size_t o_off = ((size_t)b * a.H + (size_t)kvh * groups) * hd;
    for (int i = tid; i < groups * hd; i += kThreads) {
      const int g = i / hd, d = i - g * hd;
      const float2 ol = combine_splits<false>(a.part_m, a.part_l,
                                              a.part_acc, pbase, ns, groups,
                                              g, d, hd, 0.f, 0.f);
      out[o_off + i] = from_float<T>(ol.y > 0.f ? ol.x / ol.y : 0.f);
    }
  }
}

inline KernelFn<PagedArgs> paged_kernel(int dtype) {
  if (dtype == 1) return paged_attention_decode_kernel<__nv_bfloat16>;
  if (dtype == 0) return paged_attention_decode_kernel<float>;
  return nullptr;
}

// Dynamic shared memory of one block: an item's f32 scratch, then two
// staged steps of K and V in the pools' type (paged_stream.cuh).
inline size_t paged_smem(int groups, int hd, int BS, int item) {
  return attn_scratch_floats(groups, hd, BS) * sizeof(float) +
         2 * (size_t)kPageStages * kPagesPerStep * BS * hd * item;
}

}  // namespace fused
}  // namespace paddle_tpu_torch

// C interface, bound with ctypes (paddle_tpu_torch/ops/kernels/
// paged_attention.py checks shapes, types and contiguity and allocates the
// workspace first). dtype: 0 = float32, 1 = bfloat16. ws: f32 partials,
// part_m and part_l [B * H * splits(MB)] each, then part_acc [B * H *
// splits(MB) * hd]. The plan is the wrapper's: grid, the kernel's
// cooperative grid (paged_coop_grid); smem, paged_smem; split_pages and
// pages_per_step, this source's kSplitPages and kPagesPerStep. Any other
// plan is refused (cudaErrorInvalidValue), never launched. Returns the
// launch's cudaError_t.
extern "C" int paged_attention_decode(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* block_tables,
                                      const void* seq_lens, void* out,
                                      void* ws, int B, int H, int KV, int hd,
                                      int BS, int MB, int grid, int smem,
                                      int split_pages, int pages_per_step,
                                      float scale, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  using namespace paddle_tpu_torch::fused;
  const auto kernel = paged_kernel(dtype);
  if (kernel == nullptr || KV < 1 || H % KV) return cudaErrorInvalidValue;
  const int item = dtype == 1 ? 2 : 4;
  if ((size_t)smem != paged_smem(H / KV, hd, BS, item) ||
      split_pages != kSplitPages || pages_per_step != kPagesPerStep ||
      (hd * item) % 16)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const size_t n_part = (size_t)B * H * splits(MB);
  float* f = static_cast<float*>(ws);
  const PagedArgs a{q, PagedView{k_pool, v_pool,
                                 static_cast<const int*>(block_tables), KV,
                                 hd, BS, MB},
                    static_cast<const int*>(seq_lens), out, f, f + n_part,
                    f + 2 * n_part, B, H, scale};
  return launch_coop(kernel, a, smem, grid, static_cast<cudaStream_t>(stream));
}

// The cooperative grid of the kernel for ``dtype`` at ``smem`` bytes of
// dynamic shared memory a block, or minus the cudaError_t.
extern "C" int paged_coop_grid(int dtype, int smem) {
  using namespace paddle_tpu_torch::fused;
  return coop_grid_or_error(paged_kernel(dtype), smem);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
