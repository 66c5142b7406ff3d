// The tensor-core row-tile product of the port's chunk-row block kernels
// (fused_decode_block.cu's decode_mlp_block at chunk rows,
// fused_prefill_block.cu's prefill_attn_block in bf16): every row of a
// chunk (up to kTileRows of them) against one tile of TC output columns
// of each of NMAT weights, in ONE pass over the weight tile, so a
// launch reads each weight byte once (the CUDA-core tile routine of
// block_products.cuh streams the weights again for every pass of 8 rows).
//
// Operands. A: bf16 rows [rows][lda] in device memory (the chunk's
// normalised rows, its silu(g)*u rows or its attention rows, written by an
// earlier phase of the same launch). W: a weight in its stored class
// (block_products.cuh: kWFp bf16 [K][N], kWInt8 [K][N], kWInt4K [K/2][N],
// kWInt4N [K][N/2]). Both are staged by 16-byte cp.async, kChunkK logical
// k a stage, in kStages stages: the copies of the next two chunks are in
// flight while the tensor cores work on one. Each stage ends in a block
// barrier, and on an H100 the stage count mattered less than the stage
// depth: 128 k a stage ran 12% faster than 64 (paddle_tpu_torch/tools/
// chunk_variants.py). Rows past the tile's real rows and k past K are staged as zeros (the
// copy's source size 0). A quantized chunk is converted to a bf16 tile in
// shared memory (exact for every class: |q| <= 127); kWInt4K's stored rows
// k' hold logical rows k' and k' + K/2, so a chunk takes stored rows
// [c kChunkK / 2, (c + 1) kChunkK / 2) and A's columns of the same range
// and the same range plus K/2 side by side; kWInt4N's stored column c' holds columns
// c' and c' + N/2, so a tile of TC / 2 stored columns gives TC / 2 outputs
// at each half. TC, the output columns of a tile of one weight (32 or 64),
// is each phase's own: a wider tile reads longer runs of each weight row
// and the left operand fewer times, a narrower one makes more tiles.
//
// Products. mma.sync m16n8k16 bf16 x bf16 -> f32 (mma_sync.cuh): A
// fragments by ldmatrix from the row-major [rows][k] stage, B by
// ldmatrix.trans from the [k][cols] tile. 8 warps: 4 groups of 32 rows by
// 2 groups of TC / 2 columns, a warp 2 x TC / 16 fragments of each weight;
// an m16 fragment wholly past the real rows is skipped. Each chunk's 4 depth
// steps are summed from zero and then added to the f32 sum (the tensor
// core's running sum aligns to the accumulator and truncates; flash
// attention's mma2_rn lesson, taken a chunk at a time here). No atomics:
// two launches give identical bits.
//
// The sums reach the caller's epilogue ``epi(row, col, v)`` as f32, v[m]
// the sum of weight m at output column ``col`` (the class's column map
// applied; columns past N are not passed): the epilogue applies the
// per-column scale of a quantized weight and rounds where the plain
// version rounds. A job may take one part of K's chunks (split K, for a
// phase with fewer tiles than SMs): its epilogue then writes f32 partial
// sums, which the caller adds in part order after a grid-wide barrier.
//
// Shared memory (bytes, tile_smem_bytes; the wrappers define the same
// figure in Python and the launchers hold them to it): the A stages
// [kStages][kTileRows][kLdA] bf16, then for each weight its raw stages
// and, for a quantized class, one converted [kChunkK][TC + 8] bf16 tile.
#pragma once

#include "block_products.cuh"
#include "mma_sync.cuh"

namespace paddle_tpu_torch {
namespace fused {

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 128;      // rows a tile (a chunk's, at most)
constexpr int kChunkK = 128;        // logical k a stage
constexpr int kStages = 3;          // chunks staged: 2 in flight
constexpr int kLdA = kChunkK + 8;   // bf16 a staged A row (8 of padding:
                                    // ldmatrix's 8 rows on distinct banks)

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The staged form of one weight's chunk in class WC, TC output columns a
// tile.
template <int WC, int TC>
struct TileW {
  static_assert(TC == 32 || TC == 64, "tiles of 32 or 64 columns");
  // stored rows a chunk, stored columns a tile, bytes a stored element
  static constexpr int rows = WC == kWInt4K ? kChunkK / 2 : kChunkK;
  static constexpr int cols = WC == kWInt4N ? TC / 2 : TC;
  static constexpr int esz = WC == kWFp ? 2 : 1;
  static constexpr int ldw = TC + 8;   // bf16 a row of the tile mma reads
  static constexpr int ni = TC / 16;   // n8 fragments of a warp
  // bytes a staged row (bf16 is staged padded, as the tile ldmatrix reads)
  static constexpr int ld = WC == kWFp ? ldw * 2 : cols;
  static constexpr int segs = cols * esz / 16;    // 16-byte copies a row
  static constexpr int raw = rows * ld;           // bytes a stage
  static constexpr int cvt = WC == kWFp ? 0 : kChunkK * ldw * 2;
};

__host__ __device__ constexpr size_t tile_a_bytes() {
  return (size_t)kStages * kTileRows * kLdA * sizeof(bf16);
}

template <int WC, int NMAT, int TC>
__host__ __device__ constexpr size_t tile_smem_bytes() {
  return tile_a_bytes() +
         (size_t)NMAT * (kStages * TileW<WC, TC>::raw + TileW<WC, TC>::cvt);
}

// One tile's job: rows [r0, r0 + rows) of A (rows <= kTileRows, the rest
// of the tile zeros), K logical columns, the weights' stored columns from
// col0 (a multiple of TileW<WC, TC>::cols) of ``ncols`` stored columns;
// of K's chunks, part ``part`` of ``parts`` (split K: ranges of
// ceil(chunks / parts) chunks, the last one shorter).
struct TileJob {
  const bf16* a;
  int lda, r0, rows, K, col0, ncols;
  int part = 0, parts = 1;
};

// Chunk c of the job into stage ``st``: A's rows and columns, each
// weight's stored rows.
template <int WC, int NMAT, int TC>
__device__ __forceinline__ void tile_stage(const TileJob& j,
                                           const unsigned char* const* W,
                                           size_t ldb, unsigned char* smem,
                                           int c, int st, int arows) {
  constexpr int kSegs = kChunkK / 8;   // 16-byte copies of an A row
  bf16* a_s = reinterpret_cast<bf16*>(smem) + (size_t)st * kTileRows * kLdA;
  const int half = j.K / 2;
  for (int i = threadIdx.x; i < arows * kSegs; i += kThreads) {
    const int r = i / kSegs, s = i % kSegs;
    int k;
    bool ok;
    if constexpr (WC == kWInt4K) {
      // within a half
      const int kh = c * (kChunkK / 2) + (s % (kSegs / 2)) * 8;
      k = (s / (kSegs / 2)) * half + kh;
      ok = kh < half;
    } else {
      k = c * kChunkK + s * 8;
      ok = k < j.K;
    }
    ok = ok && r < j.rows;
    cp_async16(a_s + r * kLdA + s * 8,
               ok ? j.a + (size_t)(j.r0 + r) * j.lda + k : j.a, ok);
  }
  using Tw = TileW<WC, TC>;
  const int kn = WC == kWInt4K ? half : j.K;   // stored rows
  for (int m = 0; m < NMAT; ++m) {
    unsigned char* w_s = smem + tile_a_bytes() +
                         (size_t)m * (kStages * Tw::raw + Tw::cvt) +
                         (size_t)st * Tw::raw;
    for (int i = threadIdx.x; i < Tw::rows * Tw::segs; i += kThreads) {
      const int r = i / Tw::segs, s = i - r * Tw::segs;
      const int k = c * Tw::rows + r;
      const int col = j.col0 + s * (16 / Tw::esz);
      const bool ok = k < kn && col < j.ncols;
      cp_async16(w_s + r * Tw::ld + s * 16,
                 ok ? W[m] + (size_t)k * ldb + (size_t)col * Tw::esz : W[m],
                 ok);
    }
  }
}

// bf16 of four sign-extended nibbles (low or high) of four bytes
__device__ __forceinline__ void nibbles4(uint32_t b4, bool high,
                                         bf16* out) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int b = (int)(int8_t)(b4 >> (8 * q));
    out[q] = __float2bfloat16(high ? hi4(b) : lo4(b));
  }
}

// A quantized stage of weight m into its converted bf16 tile [kChunkK]
// [TC + 8]: int8 codes as they are; kWInt4K low nibbles into rows 0-31,
// high into rows 32-63; kWInt4N low nibbles into the first TC / 2
// columns, high into the rest. Each thread converts 4 stored bytes at a
// time (TileW::raw bytes a stage over 256 threads).
template <int WC, int TC>
__device__ __forceinline__ void tile_convert(const unsigned char* raw,
                                             bf16* cvt) {
  using Tw = TileW<WC, TC>;
  constexpr int kLdW = Tw::ldw;
  for (int i = threadIdx.x; i < Tw::raw / 4; i += kThreads) {
    const int r = i / (Tw::cols / 4), c0 = (i % (Tw::cols / 4)) * 4;
    const uint32_t v =
        *reinterpret_cast<const uint32_t*>(raw + r * Tw::cols + c0);
    __align__(8) bf16 lo[4], hi[4];
    if constexpr (WC == kWInt8) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        lo[q] = __float2bfloat16((float)(int8_t)(v >> (8 * q)));
      *reinterpret_cast<uint2*>(cvt + r * kLdW + c0) =
          *reinterpret_cast<const uint2*>(lo);
    } else {
      nibbles4(v, false, lo);
      nibbles4(v, true, hi);
      // kWInt4K: the high nibbles are rows K/2 on (this chunk's second
      // half); kWInt4N: columns N/2 on (the tile's second half)
      bf16* h = WC == kWInt4K ? cvt + (r + kChunkK / 2) * kLdW + c0
                              : cvt + r * kLdW + TC / 2 + c0;
      *reinterpret_cast<uint2*>(cvt + r * kLdW + c0) =
          *reinterpret_cast<const uint2*>(lo);
      *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(hi);
    }
  }
}

// The output column of a tile's local column lc (0..TC-1), or -1 past the
// stored ``ncols``; kWInt4N: the high nibbles' columns lie N/2 = ncols
// further on.
template <int WC, int TC>
__device__ __forceinline__ int tile_out_col(int col0, int lc, int ncols) {
  if constexpr (WC == kWInt4N) {
    const int p = col0 + (lc & (TC / 2 - 1));
    if (p >= ncols) return -1;
    return lc < TC / 2 ? p : p + ncols;
  } else {
    const int c = col0 + lc;
    return c < ncols ? c : -1;
  }
}

// The job's f32 sums of every weight (see the file header), handed to
// epi(row, col, v[NMAT]) from the fragments. Every thread of the block
// takes part; synchronises the block on entry and on exit, so the next
// tile may restage at once.
template <int WC, int NMAT, int TC, typename Epi>
__device__ void tile_product(const TileJob& j, const unsigned char* const* W,
                             size_t ldb, unsigned char* smem, Epi epi) {
  using Tw = TileW<WC, TC>;
  constexpr int kLdW = Tw::ldw, kNi = Tw::ni;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 1, wc = warp & 1;   // 32-row, column group
  const int g = lane >> 2, t4 = lane & 3;
  const int arows = min(kTileRows, (j.rows + 15) / 16 * 16);
  const int nall = WC == kWInt4K ? cdiv(j.K / 2, kChunkK / 2)
                                 : cdiv(j.K, kChunkK);
  const int per = cdiv(nall, j.parts);
  const int cb = min(j.part * per, nall), nch = min(per, nall - cb);
  const bf16* a_s = reinterpret_cast<const bf16*>(smem);
  float acc[NMAT][2][kNi][4];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][mi][ni][e] = 0.f;
  // the warp's m16 fragments that hold a real row
  const bool live0 = wr * 32 < j.rows, live1 = wr * 32 + 16 < j.rows;

  __syncthreads();   // earlier readers of the stages are done
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nch) tile_stage<WC, NMAT, TC>(j, W, ldb, smem, cb + c, c, arows);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {   // the part's chunk cb + c
    const int st = c % kStages;
    cp_async_wait<kStages - 2>();   // chunk c has landed
    __syncthreads();    // ... for every thread; chunk c - 1's readers done
    if (c + kStages - 1 < nch)
      tile_stage<WC, NMAT, TC>(j, W, ldb, smem, cb + c + kStages - 1,
                               (c + kStages - 1) % kStages, arows);
    cp_async_commit();
    const bf16* wt[NMAT];
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      unsigned char* base = smem + tile_a_bytes() +
                                  (size_t)m * (kStages * Tw::raw + Tw::cvt);
      if constexpr (WC == kWFp) {
        wt[m] = reinterpret_cast<const bf16*>(base + (size_t)st * Tw::raw);
      } else {
        bf16* cvt = reinterpret_cast<bf16*>(base + kStages * Tw::raw);
        tile_convert<WC, TC>(base + (size_t)st * Tw::raw, cvt);
        wt[m] = cvt;
      }
    }
    if constexpr (WC != kWFp) __syncthreads();   // the converted tiles
    if (!live0) continue;   // warp-uniform: no real row in this warp
    const bf16* as = a_s + (size_t)st * kTileRows * kLdA;
    float t[NMAT][2][kNi][4];
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[m][mi][ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kChunkK / 16; ++kk) {
      uint32_t a[2][4];
      ldmatrix4(a[0], as + (wr * 32 + (lane & 15)) * kLdA + kk * 16 +
                          (lane >> 4) * 8);
      if (live1)
        ldmatrix4(a[1], as + (wr * 32 + 16 + (lane & 15)) * kLdA +
                            kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int ni = 0; ni < kNi; ni += 2) {
          uint32_t b[4];
          ldmatrix4_trans(b, wt[m] + (kk * 16 + (lane & 15)) * kLdW +
                                 wc * (TC / 2) + ni * 8 +
                                 (lane >> 4) * 8);
          mma2(t[m][0][ni], t[m][0][ni + 1], a[0], b);
          if (live1) mma2(t[m][1][ni], t[m][1][ni + 1], a[1], b);
        }
    }
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][mi][ni][e] += t[m][mi][ni][e];
  }
  cp_async_wait0();
  // element e of fragment (mi, ni): row wr*32 + 16 mi + g + 8 (e >> 1),
  // local column wc * TC / 2 + 8 ni + 2 t4 + (e & 1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr * 32 + mi * 16 + g + 8 * (e >> 1);
        const int col = tile_out_col<WC, TC>(
            j.col0, wc * (TC / 2) + ni * 8 + 2 * t4 + (e & 1), j.ncols);
        if (r < j.rows && col >= 0) {
          float v[NMAT];
#pragma unroll
          for (int m = 0; m < NMAT; ++m) v[m] = acc[m][mi][ni][e];
          epi(j.r0 + r, col, v);
        }
      }
  __syncthreads();
}

// h[r][k] = T(T(x * rsqrt(mean(x^2) + eps)) * nw) for every row r < rows
// of x [rows][D], one row a block at a time: block_products.cuh's rms_pass
// rounding (f32 statistics, T before the weight multiply), the sum of
// squares in 8-element runs a thread, reduced across lanes and warps in a
// fixed order. Synchronises the block.
__device__ inline void norm_rows(const bf16* __restrict__ x,
                                 const bf16* __restrict__ nw, bf16* h,
                                 int rows, int D, float eps, float* red_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv8 = D / 8;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * D);
    float ss = 0.f;
    for (int i = threadIdx.x; i < nv8; i += kThreads) {
      float v[8];
      unpack<bf16>(xr[i], v);
#pragma unroll
      for (int q = 0; q < 8; ++q) ss = fmaf(v[q], v[q], ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    __syncthreads();   // the previous row's readers of red_s are done
    if (lane == 0) red_s[warp] = ss;
    __syncthreads();
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += red_s[w];
    const float rstd = rsqrtf(tot / (float)D + eps);
    uint4* hr = reinterpret_cast<uint4*>(h + (size_t)r * D);
    const uint4* wr = reinterpret_cast<const uint4*>(nw);
    for (int i = threadIdx.x; i < nv8; i += kThreads) {
      float v[8], w[8];
      unpack<bf16>(xr[i], v);
      unpack<bf16>(wr[i], w);
      __align__(16) bf16 o[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        o[q] = __float2bfloat16(
            __fmul_rn(round_t<bf16>(__fmul_rn(v[q], rstd)), w[q]));
      hr[i] = *reinterpret_cast<const uint4*>(o);
    }
  }
  __syncthreads();
}

}  // namespace fused
}  // namespace paddle_tpu_torch
