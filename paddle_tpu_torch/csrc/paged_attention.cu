// Paged KV-cache decode attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py's
// paged_attention_decode_pallas (kernel body _decode_kernel, launch name
// "paged_attention_decode"): one query token per sequence attends over
// that sequence's pages of the paged K/V pools, read through its block
// table, with grouped-query attention (groups = H / KV query heads share
// one KV head), scale 1/sqrt(hd), an f32 online softmax page by page, and
// exact zeros for a sequence of length 0.
//
//   q            [B, H, hd]        f32 or bf16
//   k_pool/v_pool[N, BS, KV, hd]   same type as q
//   block_tables [B, MB] int32     physical page of each logical page
//   seq_lens     [B] int32         tokens per sequence, current one included
//   out          [B, H, hd]        q's type
//
// What bounds it on the H100: memory. Each live token's K and V row is
// read once (seq_len * KV * hd * 2 * itemsize bytes per sequence) and the
// arithmetic is ~2 flops per byte, far below the card's ~295 flops/byte
// ridge. So the design reads only the live pages, once each:
//   - one thread block per (KV head, sequence); the block loads its own
//     table row entries and loops over ceil(seq_len / BS) pages, never
//     reading an entry past the last live page (clamped_page_index);
//   - each page's K and V rows of this KV head go to shared memory with
//     16-byte loads, then all `groups` query heads use them, so GQA reads
//     a page once for the whole group;
//   - m, l and acc stay in f32 in shared memory across pages; the page
//     update is online_softmax.cuh's, the one definition the fused decode
//     kernel of a later slice reuses.
// Not done yet (later work, and why it matters): the page loads are not
// pipelined (no cp.async/TMA double buffer), so each page's latency is
// exposed; with few (sequence, KV head) pairs, e.g. B=8 and 8 KV heads,
// 64 blocks cannot fill 132 SMs, which needs split-K over pages
// (flash-decoding) with a second reduction pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace paddle_tpu_torch {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_decode_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ seq_lens,
                              T* __restrict__ out, int H, int KV, int hd,
                              int BS, int MB, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int groups = H / KV;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                  // [BS][hd]
  T* v_s = k_s + BS * hd;                               // [BS][hd]
  float* q_s = reinterpret_cast<float*>(v_s + BS * hd);  // [groups][hd]
  float* acc = q_s + groups * hd;                       // [groups][hd]
  float* s = acc + groups * hd;                         // [groups][BS]
  float* m = s + groups * BS;                           // [groups]
  float* l = m + groups;                                // [groups]
  float* alpha = l + groups;                            // [groups]

  const int seq_len = seq_lens[b];
  const int* table = block_tables + (size_t)b * MB;
  const size_t q_off = ((size_t)b * H + (size_t)kvh * groups) * hd;

  for (int i = tid; i < groups * hd; i += blockDim.x) {
    q_s[i] = to_float(q[q_off + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < groups; g += blockDim.x) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
  }

  const int n_pages = min((seq_len + BS - 1) / BS, MB);  // 0 if seq_len 0
  constexpr int kVec = 16 / sizeof(T);                   // elements / 16 B
  const int row_vecs = hd / kVec;
  for (int pg = 0; pg < n_pages; ++pg) {
    __syncthreads();  // the previous page's readers are done with k_s/v_s
    const size_t page = (size_t)table[clamped_page_index(seq_len, BS, pg)];
    for (int i = tid; i < BS * row_vecs; i += blockDim.x) {
      const int t = i / row_vecs;
      const int c = i - t * row_vecs;
      const size_t off = ((page * BS + t) * KV + kvh) * hd + (size_t)c * kVec;
      reinterpret_cast<uint4*>(k_s)[i] =
          *reinterpret_cast<const uint4*>(k_pool + off);
      reinterpret_cast<uint4*>(v_s)[i] =
          *reinterpret_cast<const uint4*>(v_pool + off);
    }
    __syncthreads();
    online_softmax_page_update<T>(q_s, k_s, v_s, pg, BS, seq_len, scale,
                                  groups, hd, s, m, l, alpha, acc);
  }
  __syncthreads();
  for (int i = tid; i < groups * hd; i += blockDim.x) {
    const float lg = l[i / hd];
    out[q_off + i] = from_float<T>(lg > 0.f ? acc[i] / lg : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_tables, const void* seq_lens, void* out,
                   int B, int H, int KV, int hd, int BS, int MB, int grid_x,
                   int grid_y, int smem_in, float scale, cudaStream_t stream) {
  const int groups = H / KV;
  const size_t smem = 2 * (size_t)BS * hd * sizeof(T) +
                      (2 * (size_t)groups * hd + (size_t)groups * BS +
                       3 * (size_t)groups) * sizeof(float);
  // the wrapper's plan must be this kernel's: one block per (KV head,
  // sequence), this shared memory
  if (grid_x != KV || grid_y != B || (size_t)smem_in != smem)
    return cudaErrorInvalidValue;
  auto kernel = paged_attention_decode_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), static_cast<T*>(out), H, KV, hd, BS,
      MB, scale);
  return cudaGetLastError();
}

}  // namespace paddle_tpu_torch

// C interface, bound with ctypes (paddle_tpu_torch/ops/kernels/
// paged_attention.py checks shapes, types and contiguity first).
// dtype: 0 = float32, 1 = bfloat16; grid_x, grid_y and smem: the wrapper's
// plan, (KV, B) and the kernel's shared memory, or the launch is refused
// (cudaErrorInvalidValue). Returns the launch's cudaError_t.
extern "C" int paged_attention_decode(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* block_tables,
                                      const void* seq_lens, void* out, int B,
                                      int H, int KV, int hd, int BS, int MB,
                                      int grid_x, int grid_y, int smem,
                                      float scale, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, block_tables, seq_lens,
                                 out, B, H, KV, hd, BS, MB, grid_x, grid_y,
                                 smem, scale, s);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, block_tables, seq_lens, out, B,
                         H, KV, hd, BS, MB, grid_x, grid_y, smem, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
