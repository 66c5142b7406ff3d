// Flash attention for Hopper (sm_90a): the forward and the two backward
// passes, each a kernel of its own.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py's three Pallas kernels:
//   flash_attention_fwd      _fwd_kernel      (launch in _fwd)
//   flash_attention_bwd_dq   _bwd_dq_kernel   (launch in _bwd_impl)
//   flash_attention_bwd_dkv  _bwd_dkv_kernel  (launch in _bwd_impl)
// with causal masking (bottom-right: query row r sees key c iff
// r + sk - sq >= c; with sq > sk the top rows see no key and give O = 0)
// and grouped-query attention (h query heads over kvh K/V heads,
// h % kvh == 0, the K/V head indexed, never repeated).
//
// The JAX kernels' optional bodies are runtime flags (struct Extras),
// compiled as a second instance of each kernel (kX = true) so that the
// flag-less instance is the same code as without them:
//   - an additive f32 bias [b|1, h|1, sq, sk] on the scaled scores
//     (s = dot * scale + bias, JAX _fwd_kernel), broadcast over a batch or
//     head axis of size 1;
//   - dbias (dq pass only): P (dP - delta), before the scale, written for
//     every (query row, key) of [b*h, sq, sk] f32, zeros for the key tiles
//     past the causal diagonal, so the whole array is written;
//   - segment ids seg_q [b, sq], seg_k [b, sk] (int32): a query sees only
//     keys of its own segment (JAX _mask); a row left with no key gives 0;
//   - in-kernel dropout: the keep mask is JAX _dropout_keep's hash of
//     (seed, query head b*h + hi, absolute query row, absolute key), so
//     the three kernels and any tiling draw the same mask. The forward
//     multiplies the kept P by inv = 1 / (1 - rate) (rounded to f32 on
//     the host) before P V while l sums the undropped P; the dq pass drops
//     dP; the dkv pass takes the dropped f32 P for dV and the dropped dP
//     for dK; dS = P (dP - delta) always takes the undropped P.
//
//   q, o, dq    [b, sq, h, d]     f32 or bf16 (the public layout, read by
//   k, v, dk, dv [b, sk, kvh, d]  stride; no transposed copy)
//   lse, delta  [b, h, sq]        f32
//
// The forward returns O and the log-sum-exp of every row's scaled scores;
// the backward takes delta = rowsum(O * dO) (f32, computed by the caller,
// as the JAX package does outside its kernels) and recomputes
// P = exp(S - lse): the dq pass forms dS = P * (dP - delta) * scale with
// dP = dO V^T and accumulates dq = dS K; the dkv pass accumulates
// dV += P^T dO and dK += dS^T Q over every query head of its K/V head's
// group. The rounding points are the JAX kernel's: P is cast to V's type
// before P V; dO and V are taken in f32 for dP and dV, where P stays f32;
// dS is cast to K's (Q's) type before dS K (dS^T Q); every product
// accumulates in f32. Masked scores take DEFAULT_MASK_VALUE and their
// probability is zeroed, so a tile that a row sees nothing of adds nothing.
//
// What bounds them on the H100: operations. At the training shape (b 2,
// s 2048, h 32, d 128, bf16, causal) the forward does 68.7 GFLOP against
// 134 MB and the two backward passes 240 GFLOP (S, dP, dQ; S, dP, dV, dK):
// 0.069 ms and 0.243 ms at the bf16 tensor-core peak. These kernels run
// every product on the CUDA cores in f32 FMAs (the f32 path must not round
// through TF32, and the dV product takes an f32 P), so they are bound by
// the CUDA cores' f32 rate and by shared-memory issue well before that;
// their times stand beside those bounds in PERF.md.
//
// Design. The TPU kernels carry m/l/acc (forward), dq (dq pass) and dk/dv
// (dkv pass) across a sequential grid axis in VMEM scratch. Blocks on the
// GPU run in no order, so each carried sum is a loop inside one block:
//   - forward and dq pass: a block per (64-row query tile, b*h head) walks
//     the key tiles from 0 up to the causal diagonal (the TPU index map's
//     causal clamp becomes this loop's bound);
//   - dkv pass: a block per (64-key tile, b*kvh head) walks the query
//     heads of its group and, for each, the query tiles from the causal
//     diagonal on.
// No atomics: two launches on the same inputs give the same bits. Tiles
// live in shared memory as f32 rows with an odd stride (d + 1), so both a
// row walk (S = Q K^T) and a column walk (P V, dS K) are free of bank
// conflicts; 256 threads own 4 x 4 of each 64 x 64 score tile and 4 rows
// x d/16 columns of each output tile. Ragged tails (sq, sk not multiples
// of 64) are masked at the tile edge; rows past sq are neither read nor
// written.
// Not done yet: tensor-core (mma/wgmma) products for bf16 and a pipelined
// (cp.async/TMA) tile load; the kernels reload their tiles unpipelined.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace paddle_tpu_torch {
namespace flash {

constexpr int kThreads = 256;
constexpr int kB = 64;              // rows of a query tile and of a key tile
constexpr int kMaxD = 128;
constexpr int kCols = kMaxD / 16;   // output columns a thread owns
constexpr int kLdP = kB + 1;        // row stride of the score tiles
// the JAX kernel's DEFAULT_MASK_VALUE, -0.7 * float32 max
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

// x rounded to T and read back: the JAX kernel's astype before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Rows [row0, row0 + kB) of one head of a [batch, rows, heads, d] tensor
// (``base`` points at that head's row 0, rows ``row_stride`` apart) into
// an f32 tile [kB][ld]; rows at or past ``n`` become zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ base,
                                          size_t row_stride, int row0, int n,
                                          int d) {
  for (int i = threadIdx.x; i < kB * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    const int gr = row0 + r;
    dst[r * ld + c] = gr < n ? to_float(base[(size_t)gr * row_stride + c])
                             : 0.f;
  }
}

// f32 rows [row0, row0 + kB) of a [bh, n] statistic; zeros past n.
__device__ __forceinline__ void load_stat(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int n) {
  for (int i = threadIdx.x; i < kB; i += kThreads)
    dst[i] = row0 + i < n ? src[row0 + i] : 0.f;
}

// Does query row r (absolute) see key c (absolute)?
__device__ __forceinline__ bool sees(int r, int c, int sq, int sk, int off,
                                     int causal) {
  return r < sq && c < sk && (!causal || r + off >= c);
}

// The optional bodies of one launch (all off: null pointers, rate 0).
struct Extras {
  const float* bias;   // [bias_b * bias_h, sq, sk] f32, or null
  int bias_b, bias_h;  // the bias's batch and head extents (1 = broadcast)
  const int* seg_q;    // [b, sq] segment ids, or null (then seg_k too)
  const int* seg_k;    // [b, sk]
  float* dbias;        // dq pass: [b*h, sq, sk] f32, or null
  uint32_t seed;       // dropout: the hash's seed, the rate and 1/(1-rate)
  float rate, inv;
};

// The bias plane of query head (bi, hi), or null.
__device__ __forceinline__ const float* bias_plane(const Extras& x, int bi,
                                                   int hi, int sq, int sk) {
  if (x.bias == nullptr) return nullptr;
  const int plane =
      (x.bias_b == 1 ? 0 : bi) * x.bias_h + (x.bias_h == 1 ? 0 : hi);
  return x.bias + (size_t)plane * sq * sk;
}

// JAX _dropout_keep: a murmur3 finalizer of the absolute coordinates;
// the top 24 bits as a uniform in [0, 1), kept where u >= rate.
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t qbh,
                                             uint32_t qpos, uint32_t kpos,
                                             float rate) {
  uint32_t x = qpos * 0x9E3779B1u ^ kpos * 0x85EBCA77u ^
               (seed + qbh * 0xC2B2AE3Du);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  const float u = (float)(int)(x >> 8) * (1.0f / 16777216.0f);
  return u >= rate;
}

// The thread's segment ids: rows ty*4 + i of a query tile at q0 and keys
// tx + 16 j of a key tile at k0 (0 past the ends, where nothing is seen).
__device__ __forceinline__ void load_segs(const Extras& x, int bi, int q0,
                                          int k0, int sq, int sk, int ty,
                                          int tx, int (&sgq)[4],
                                          int (&sgk)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i, c = k0 + tx + 16 * i;
    sgq[i] = r < sq ? x.seg_q[(size_t)bi * sq + r] : 0;
    sgk[i] = c < sk ? x.seg_k[(size_t)bi * sk + c] : 0;
  }
}

// Index of the last key tile a query tile starting at q0 sees, plus one.
__device__ __forceinline__ int key_tiles(int q0, int sk, int off,
                                         int causal) {
  int last = sk - 1;
  if (causal) last = min(last, q0 + kB - 1 + off);
  return last < 0 ? 0 : last / kB + 1;
}

// The thread's 4 x 4 block of a score tile: rows ty*4 + i of ``a`` against
// rows tx + 16 j of ``b``, dotted over d (a [kB][ld] x b [kB][ld]).
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          int ld, int d, int ty, int tx,
                                          float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kk = 0; kk < d; ++kk) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty * 4 + i) * ld + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * ld + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// Reductions over the 16 threads that share a row (lanes of one half warp)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// forward: O and lse
// ---------------------------------------------------------------------------
template <typename T, bool kX>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int h, int kvh, int sq, int sk, int d,
           float scale, int causal, const Extras x) {
  const int q0 = blockIdx.x * kB;
  const int bh = blockIdx.y;
  const int bi = bh / h, hi = bh - bi * h;
  const int kvi = hi / (h / kvh);
  const int off = sk - sq;
  const int ld = d + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  extern __shared__ float smem[];
  float* q_s = smem;              // [kB][ld]
  float* k_s = q_s + kB * ld;     // [kB][ld]
  float* v_s = k_s + kB * ld;     // [kB][ld]
  float* p_s = v_s + kB * ld;     // [kB][kLdP]

  const size_t qrs = (size_t)h * d, krs = (size_t)kvh * d;
  const T* qb = q + ((size_t)bi * sq * h + hi) * d;
  const T* kb = k + ((size_t)bi * sk * kvh + kvi) * d;
  const T* vb = v + ((size_t)bi * sk * kvh + kvi) * d;
  load_tile(q_s, ld, qb, qrs, q0, sq, d);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const float* bp = kX ? bias_plane(x, bi, hi, sq, sk) : nullptr;
  const int nkt = key_tiles(q0, sk, off, causal);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's readers are done (and q_s set)
    load_tile(k_s, ld, kb, krs, k0, sk, d);
    load_tile(v_s, ld, vb, krs, k0, sk, d);
    __syncthreads();
    float s[4][4];
    tile_dots(q_s, k_s, ld, d, ty, tx, s);
    int sgq[4], sgk[4];
    if (kX && x.seg_q) load_segs(x, bi, q0, k0, sq, sk, ty, tx, sgq, sgk);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      bool ok[4];
      float mc = kMaskValue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        ok[j] = sees(r, c, sq, sk, off, causal);
        if (kX) {
          if (x.seg_q) ok[j] = ok[j] && sgq[i] == sgk[j];
          float sc = __fmul_rn(s[i][j], scale);
          if (bp && ok[j]) sc = __fadd_rn(sc, bp[(size_t)r * sk + c]);
          s[i][j] = ok[j] ? sc : kMaskValue;
        } else {
          s[i][j] = ok[j] ? s[i][j] * scale : kMaskValue;
        }
        mc = fmaxf(mc, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max16(mc));
      const float alpha = expf(m[i] - mn);  // 0 on the first tile (-inf)
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - mn) : 0.f;
        ps += p;
        float pd = p;   // P V takes the dropped P; l the undropped one
        if (kX && x.rate > 0.f)
          pd = dropout_keep(x.seed, bh, r, k0 + tx + 16 * j, x.rate)
                   ? __fmul_rn(p, x.inv)
                   : 0.f;
        p_s[(ty * 4 + i) * kLdP + tx + 16 * j] = round_to<T>(pd);
      }
      l[i] = alpha * l[i] + row_sum16(ps);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    const int nk = min(kB, sk - k0);
    for (int kk = 0; kk < nk; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty * 4 + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const float vv = v_s[kk * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (((size_t)bi * sq + r) * h + hi) * d;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) orow[col] = from_float<T>(acc[i][c] / ls);
    }
    if (tx == 0) lse[(size_t)bh * sq + r] = m[i] + logf(ls);
  }
}

// The thread's probabilities and dS of one (query tile, key tile) pair,
// from the staged Q, dO, K, V tiles and the query rows' lse and delta:
// P = exp(S * scale - lse) where seen (else 0), dS = P (dP - delta) scale.
// With the extras (kX): S * scale + bias, the segment mask, dP dropped,
// ``dsb`` = P (dP - delta) before the scale (dbias), and P returned
// dropped (the dkv pass's dV takes it); dS keeps the undropped P. ``bp``
// is the query head's bias plane (or null), ``qbh`` its b*h index.
template <typename T, bool kX>
__device__ __forceinline__ void probs_and_ds(
    const float* q_s, const float* do_s, const float* k_s,
    const float* v_s, const float* lse_s, const float* dl_s, int ld, int d,
    int q0, int k0, int sq, int sk, int off, int causal, float scale,
    int ty, int tx, const Extras& x, const float* bp, int bi, uint32_t qbh,
    float (&p)[4][4], float (&ds)[4][4], float (&dsb)[4][4]) {
  float dp[4][4];
  tile_dots(q_s, k_s, ld, d, ty, tx, p);
  tile_dots(do_s, v_s, ld, d, ty, tx, dp);
  int sgq[4], sgk[4];
  if (kX && x.seg_q) load_segs(x, bi, q0, k0, sq, sk, ty, tx, sgq, sgk);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = q0 + rl, c = k0 + tx + 16 * j;
      bool ok = sees(r, c, sq, sk, off, causal);
      if (!kX) {
        p[i][j] = ok ? expf(p[i][j] * scale - lse_s[rl]) : 0.f;
        ds[i][j] = p[i][j] * (dp[i][j] - dl_s[rl]) * scale;
        continue;
      }
      if (x.seg_q) ok = ok && sgq[i] == sgk[j];
      float s = __fmul_rn(p[i][j], scale);
      if (bp && ok) s = __fadd_rn(s, bp[(size_t)r * sk + c]);
      // a select, never a 0/1 multiply: lse may be -inf for a row that
      // sees no key, and exp(+inf) * 0 is NaN
      const float pr = ok ? expf(s - lse_s[rl]) : 0.f;
      float dpv = dp[i][j], pd = pr;
      if (x.rate > 0.f) {
        const bool kp = dropout_keep(x.seed, qbh, r, c, x.rate);
        dpv = kp ? __fmul_rn(dpv, x.inv) : 0.f;
        pd = kp ? __fmul_rn(pr, x.inv) : 0.f;
      }
      dsb[i][j] = pr * (dpv - dl_s[rl]);
      ds[i][j] = dsb[i][j] * scale;
      p[i][j] = pd;
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dq pass
// ---------------------------------------------------------------------------
template <typename T, bool kX>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int h, int kvh, int sq, int sk, int d,
          float scale, int causal, const Extras x) {
  const int q0 = blockIdx.x * kB;
  const int bh = blockIdx.y;
  const int bi = bh / h, hi = bh - bi * h;
  const int kvi = hi / (h / kvh);
  const int off = sk - sq;
  const int ld = d + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  extern __shared__ float smem[];
  float* q_s = smem;              // [kB][ld]
  float* do_s = q_s + kB * ld;    // [kB][ld]
  float* k_s = do_s + kB * ld;    // [kB][ld]
  float* v_s = k_s + kB * ld;     // [kB][ld]
  float* ds_s = v_s + kB * ld;    // [kB][kLdP]
  float* lse_s = ds_s + kB * kLdP;  // [kB]
  float* dl_s = lse_s + kB;         // [kB]

  const size_t qrs = (size_t)h * d, krs = (size_t)kvh * d;
  const size_t qhead = ((size_t)bi * sq * h + hi) * d;
  const T* kb = k + ((size_t)bi * sk * kvh + kvi) * d;
  const T* vb = v + ((size_t)bi * sk * kvh + kvi) * d;
  load_tile(q_s, ld, q + qhead, qrs, q0, sq, d);
  load_tile(do_s, ld, dout + qhead, qrs, q0, sq, d);
  load_stat(lse_s, lse + (size_t)bh * sq, q0, sq);
  load_stat(dl_s, delta + (size_t)bh * sq, q0, sq);

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const float* bp = kX ? bias_plane(x, bi, hi, sq, sk) : nullptr;
  // dbias: the rows of this query tile in [b*h, sq, sk]
  float* db = kX && x.dbias ? x.dbias + (size_t)bh * sq * sk : nullptr;
  const int nkt = key_tiles(q0, sk, off, causal);
  // with dbias every key tile is visited: past the diagonal, to write 0
  const int nvisit = db ? (sk + kB - 1) / kB : nkt;
  for (int kt = 0; kt < nvisit; ++kt) {
    const int k0 = kt * kB;
    if (kX && kt >= nkt) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = q0 + ty * 4 + i, c = k0 + tx + 16 * j;
          if (r < sq && c < sk) db[(size_t)r * sk + c] = 0.f;
        }
      continue;
    }
    __syncthreads();
    load_tile(k_s, ld, kb, krs, k0, sk, d);
    load_tile(v_s, ld, vb, krs, k0, sk, d);
    __syncthreads();
    float p[4][4], ds[4][4], dsb[4][4];
    probs_and_ds<T, kX>(q_s, do_s, k_s, v_s, lse_s, dl_s, ld, d, q0, k0, sq,
                        sk, off, causal, scale, ty, tx, x, bp, bi, bh, p,
                        ds, dsb);
    if (db) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = q0 + ty * 4 + i, c = k0 + tx + 16 * j;
          if (r < sq && c < sk) db[(size_t)r * sk + c] = dsb[i][j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds_s[(ty * 4 + i) * kLdP + tx + 16 * j] = round_to<T>(ds[i][j]);
    __syncthreads();
    const int nk = min(kB, sk - k0);
    for (int kk = 0; kk < nk; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ds_s[(ty * 4 + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const float kv = k_s[kk * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(a[i], kv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    T* row = dq + qhead + (size_t)r * qrs;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) row[col] = from_float<T>(acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dkv pass
// ---------------------------------------------------------------------------
template <typename T, bool kX>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int h, int kvh, int sq,
           int sk, int d, float scale, int causal, const Extras x) {
  const int k0 = blockIdx.x * kB;
  const int bkv = blockIdx.y;
  const int bi = bkv / kvh, kvi = bkv - bi * kvh;
  const int groups = h / kvh;
  const int off = sk - sq;
  const int ld = d + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  extern __shared__ float smem[];
  float* q_s = smem;              // [kB][ld]
  float* do_s = q_s + kB * ld;    // [kB][ld]
  float* k_s = do_s + kB * ld;    // [kB][ld]
  float* v_s = k_s + kB * ld;     // [kB][ld]
  float* p_s = v_s + kB * ld;     // [kB][kLdP]  (query row, key)
  float* ds_s = p_s + kB * kLdP;  // [kB][kLdP]
  float* lse_s = ds_s + kB * kLdP;  // [kB]
  float* dl_s = lse_s + kB;         // [kB]

  const size_t qrs = (size_t)h * d, krs = (size_t)kvh * d;
  const size_t khead = ((size_t)bi * sk * kvh + kvi) * d;
  load_tile(k_s, ld, k + khead, krs, k0, sk, d);
  load_tile(v_s, ld, v + khead, krs, k0, sk, d);

  // the thread owns keys ty*4 + i of the tile and columns tx + 16 c
  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // first query tile that sees a key of this tile (the TPU index map's
  // clamp, here the loop's start)
  const int first = causal ? max(k0 - off, 0) / kB : 0;
  const int nqt = (sq + kB - 1) / kB;
  for (int g = 0; g < groups; ++g) {
    const int hq = kvi * groups + g;
    const size_t bh = (size_t)bi * h + hq;
    const size_t qhead = ((size_t)bi * sq * h + hq) * d;
    const float* bp = kX ? bias_plane(x, bi, hq, sq, sk) : nullptr;
    for (int qt = first; qt < nqt; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the previous pair's readers are done (k/v set)
      load_tile(q_s, ld, q + qhead, qrs, q0, sq, d);
      load_tile(do_s, ld, dout + qhead, qrs, q0, sq, d);
      load_stat(lse_s, lse + bh * sq, q0, sq);
      load_stat(dl_s, delta + bh * sq, q0, sq);
      __syncthreads();
      // p comes back dropped (dV's), ds from the undropped P (dK's)
      float p[4][4], ds[4][4], dsb[4][4];
      probs_and_ds<T, kX>(q_s, do_s, k_s, v_s, lse_s, dl_s, ld, d, q0, k0,
                          sq, sk, off, causal, scale, ty, tx, x, bp, bi,
                          (uint32_t)bh, p, ds, dsb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = (ty * 4 + i) * kLdP + tx + 16 * j;
          p_s[at] = p[i][j];
          ds_s[at] = round_to<T>(ds[i][j]);
        }
      __syncthreads();
      const int nr = min(kB, sq - q0);
      for (int rr = 0; rr < nr; ++rr) {
        float pa[4], da[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = p_s[rr * kLdP + ty * 4 + i];
          da[i] = ds_s[rr * kLdP + ty * 4 + i];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = tx + 16 * c;
          if (col < d) {
            const float dov = do_s[rr * ld + col];
            const float qv = q_s[rr * ld + col];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dv_acc[i][c] = fmaf(pa[i], dov, dv_acc[i][c]);
              dk_acc[i][c] = fmaf(da[i], qv, dk_acc[i][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c0 = k0 + ty * 4 + i;
    if (c0 >= sk) continue;
    T* krow = dk + khead + (size_t)c0 * krs;
    T* vrow = dv + khead + (size_t)c0 * krs;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        krow[col] = from_float<T>(dk_acc[i][c]);
        vrow[col] = from_float<T>(dv_acc[i][c]);
      }
    }
  }
}

// Shared-memory bytes of each kernel (the f32 tiles of its layout).
inline size_t fwd_smem(int d) {
  return (3 * (size_t)kB * (d + 1) + (size_t)kB * kLdP) * sizeof(float);
}
inline size_t dq_smem(int d) {
  return (4 * (size_t)kB * (d + 1) + (size_t)kB * kLdP + 2 * kB) *
         sizeof(float);
}
inline size_t dkv_smem(int d) {
  return (4 * (size_t)kB * (d + 1) + 2 * (size_t)kB * kLdP + 2 * kB) *
         sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Whether a launch takes the kernel instance with the optional bodies.
inline bool any_extra(const Extras& x) {
  return x.bias || x.seg_q || x.dbias || x.rate > 0.f;
}

template <typename T, bool kX>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int b, int h, int kvh, int sq, int sk,
                       int d, float scale, int causal, const Extras& x,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem(d);
  cudaError_t e = allow_smem(fwd_kernel<T, kX>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((sq + kB - 1) / kB, b * h);
  fwd_kernel<T, kX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      h, kvh, sq, sk, d, scale, causal, x);
  return cudaGetLastError();
}

template <typename T, bool kX>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int b, int h, int kvh, int sq, int sk, int d,
                      float scale, int causal, const Extras& x,
                      cudaStream_t stream) {
  const size_t smem = dq_smem(d);
  cudaError_t e = allow_smem(dq_kernel<T, kX>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((sq + kB - 1) / kB, b * h);
  dq_kernel<T, kX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), h, kvh, sq, sk, d, scale, causal, x);
  return cudaGetLastError();
}

template <typename T, bool kX>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int b, int h, int kvh, int sq,
                       int sk, int d, float scale, int causal,
                       const Extras& x, cudaStream_t stream) {
  const size_t smem = dkv_smem(d);
  cudaError_t e = allow_smem(dkv_kernel<T, kX>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((sk + kB - 1) / kB, b * kvh);
  dkv_kernel<T, kX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), h, kvh, sq, sk, d, scale,
      causal, x);
  return cudaGetLastError();
}

// The instance of ``launch`` for the launch's type and extras.
#define FLASH_DISPATCH(launch, dtype, x, ...)                              \
  (dtype == 1 ? (any_extra(x) ? launch<__nv_bfloat16, true>(__VA_ARGS__)   \
                              : launch<__nv_bfloat16, false>(__VA_ARGS__)) \
   : dtype == 0 ? (any_extra(x) ? launch<float, true>(__VA_ARGS__)         \
                                : launch<float, false>(__VA_ARGS__))       \
                : cudaErrorInvalidValue)

inline Extras make_extras(const void* bias, int bias_b, int bias_h,
                          const void* seg_q, const void* seg_k, void* dbias,
                          long long seed, float rate, float inv) {
  return Extras{static_cast<const float*>(bias), bias_b, bias_h,
                static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
                static_cast<float*>(dbias), (uint32_t)seed, rate, inv};
}

}  // namespace flash
}  // namespace paddle_tpu_torch

// C interface, bound with ctypes (paddle_tpu_torch/ops/kernels/
// flash_attention.py checks devices, types, shapes and contiguity first).
// dtype: 0 = float32, 1 = bfloat16; block and smem: the wrapper's plan, the
// kernels' kB-row tiles and the kernel's shared memory, or the launch is
// refused (cudaErrorInvalidValue). The optional bodies: bias (f32, or
// null) with its batch and head extents bias_b, bias_h; seg_q, seg_k
// (int32, or both null); dbias (dq pass, or null); the dropout seed (its
// low 32 bits), rate and inv = 1 / (1 - rate) (rate 0: no dropout). Each
// returns its launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* seg_q, const void* seg_k,
                                   void* o, void* lse, int b, int h, int kvh,
                                   int sq, int sk, int d, int block,
                                   int smem, int bias_b, int bias_h,
                                   long long seed, float scale, float rate,
                                   float inv, int causal, int dtype,
                                   void* stream) {
  using namespace paddle_tpu_torch::flash;
  if (block != kB || (size_t)smem != fwd_smem(d)) return cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Extras x = make_extras(bias, bias_b, bias_h, seg_q, seg_k, nullptr,
                               seed, rate, inv);
  return FLASH_DISPATCH(launch_fwd, dtype, x, q, k, v, o, lse, b, h, kvh,
                        sq, sk, d, scale, causal, x, s);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      const void* seg_q, const void* seg_k,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dq,
                                      void* dbias, int b, int h, int kvh,
                                      int sq, int sk, int d, int block,
                                      int smem, int bias_b, int bias_h,
                                      long long seed, float scale,
                                      float rate, float inv, int causal,
                                      int dtype, void* stream) {
  using namespace paddle_tpu_torch::flash;
  if (block != kB || (size_t)smem != dq_smem(d)) return cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Extras x = make_extras(bias, bias_b, bias_h, seg_q, seg_k, dbias,
                               seed, rate, inv);
  return FLASH_DISPATCH(launch_dq, dtype, x, q, k, v, dout, lse, delta, dq,
                        b, h, kvh, sq, sk, d, scale, causal, x, s);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* seg_q, const void* seg_k,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv,
                                       int b, int h, int kvh, int sq, int sk,
                                       int d, int block, int smem,
                                       int bias_b, int bias_h,
                                       long long seed, float scale,
                                       float rate, float inv, int causal,
                                       int dtype, void* stream) {
  using namespace paddle_tpu_torch::flash;
  if (block != kB || (size_t)smem != dkv_smem(d)) return cudaErrorInvalidValue;
  if (b == 0 || sk == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Extras x = make_extras(bias, bias_b, bias_h, seg_q, seg_k, nullptr,
                               seed, rate, inv);
  return FLASH_DISPATCH(launch_dkv, dtype, x, q, k, v, dout, lse, delta, dk,
                        dv, b, h, kvh, sq, sk, d, scale, causal, x, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
