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
// Every product is block_products.cuh's tile routine over passes of 8
// rows. Only one pass of normalised rows is resident, so shared memory
// does not grow with B; a block normalises pass p again for each of its
// tiles when B > 8, reading x from L2 rather than holding every pass. No
// atomics touch any sum, so two launches give identical bits. The tile
// width is picked per phase from the grid so the busiest block has the
// fewest columns. Not done yet (later work): tensor-core products,
// cp.async/TMA pipelining of the weight stream.
//
// Shared memory, sized by the wrapper (ops/kernels/fused_decode_block.py,
// the one definition of the sizes) and passed in, is carved as
// block_products.cuh describes.
#include "block_products.cuh"

namespace paddle_tpu_torch {
namespace fused {

constexpr int kSplitPages = 8;  // pages per attention work item

__host__ __device__ inline int splits(int MB) {
  return (MB + kSplitPages - 1) / kSplitPages;
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
