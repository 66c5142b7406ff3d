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
// 0.069 ms and 0.243 ms at the bf16 tensor-core peak.
//
// The f32 instances run every product on the CUDA cores in f32 FMAs: the
// f32 path must not round through TF32. A block per (64-row query tile,
// b*h head) (forward, dq) or per (64-key tile, b*kvh head) (dkv) walks the
// other side's tiles: the TPU kernels carry m/l/acc, dq and dk/dv across a
// sequential grid axis in VMEM scratch, and blocks on the GPU run in no
// order, so each carried sum is a loop inside one block (the TPU index
// map's causal clamp becomes the loop's bound). Tiles live in shared
// memory as f32 rows with an odd stride (d + 1), so row and column walks
// are free of bank conflicts; 256 threads own 4 x 4 of each 64 x 64 score
// tile and 4 rows x d/16 columns of each output tile. They are bound by
// shared-memory issue (8 operand loads for every 16 FMAs), at about a
// quarter of the 67 TFLOP/s f32 rate.
//
// Every bf16 launch (fwd_tc_kernel, dq_tc_kernel, dkv_tc_kernel, after
// FA-2) runs every product on the tensor cores: mma.sync m16n8k16 bf16 x
// bf16 into f32, at the JAX kernels' rounding points. S = Q K^T and dP =
// dO V^T take bf16 operands (dO and V are bf16 values, so the JAX kernel's
// f32 dP has the same products); each k-step's 16 products are summed from
// zero and added in f32 (mma2_rn): the tensor core's own running sum
// truncates, and dS = P (dP - delta) cancels on rows that see few keys,
// where a dS one bf16 ulp off moves dq and dk by more than two ulps. The
// forward casts P (dropped, times the f32 inv) to bf16 before P V, sums each
// 64-key tile's P V from zero and adds it to O alpha in f32, as JAX adds
// dot(P, V) to acc * alpha; l sums the undropped f32 P. dQ = bf16(dS) K and
// dK = bf16(dS)^T Q cast dS as JAX does; dV = P^T dO takes an f32 P in
// JAX, so P is split into hi = bf16(P) and lo = bf16(P - hi) and both
// products go into one f32 sum (what remains is under 2^-16 of P, far
// below dV's own bf16 rounding). Plan: 128 threads, 4 warps of 16 tile rows
// each, 64 x 64 score tiles; every operand tile is a bf16 [64][D + 8] tile
// in shared memory (8 columns of padding: ldmatrix conflict-free), copied
// by 16-byte cp.async into one of two stages while the tensor cores work
// on the other; ragged rows and columns past d are zero-filled by the
// copy's source size. D is 64 or 128 (the instance that holds d; columns
// past d are zeros, never written). A warp's score tile stays in registers
// from product to product (a C fragment pair is an A fragment): the
// forward holds S/P (16 x 64) and O (16 x D) in f32; dq holds S, dP and dQ;
// dkv computes the transposed scores 32 query rows at a time so that dK
// and dV (2 x 16 x D) stay in registers across the whole walk. Shared
// memory at D = 128: forward 87,040, dq 104,448 and dkv 105,472 bytes, two
// blocks an SM (8 warps, __launch_bounds__(128, 2)); a staged bias (two
// [64][72] or [64][68] f32 tiles beside K/V or Q) leaves one. ptxas -v
// (sm_90a), registers a thread without and with the bodies, no spills:
// forward 240 / 240, dq 238 / 255 and dkv 246 / 254 at D = 128; forward
// 160 / 192, dq 208 / 250 and dkv 173 / 205 at D = 64. The S/dP depth loop
// runs one step at a time (unrolled, ptxas hoisted the next steps'
// fragments and spilled), and the dkv body instance at D = 128 scores 16
// query rows a sub-step instead of 32 for the same reason. The bias tile
// is copied with its operand tile (no device read a score); dbias is
// written from the fragments, zeros for every tile the pass does not
// compute. Segment ids skip every (query tile, key tile) pair whose id
// ranges do not meet (id_range: exact, since P is 0 on such a pair;
// conservative, since it tests [min, max] only). A row whose pairs are all
// skipped keeps the lse fwd_kernel gives it (kMaskValue once its query tile
// has a key tile, -inf without one), so the backward reads the same lse.
//
// The forward is bound by instruction issue, not by the tensor cores: per
// score it spends a scale, a max, an exponential, a sum and a select on
// the CUDA cores, and per tile a rescale of O, against two products on the
// tensor cores. Its exponentials are exp2f(x log2 e) (exp_2), a fifth of
// its time less than expf. 128-row query tiles (8 warps, the K/V reads per
// score halved) were tried on the card and not kept: 28% faster with a
// bias (8 warps an SM where the 64-row plan with the bias stages fits 4),
// but 6% slower without a body or with dropout, 19-21% with segment ids
// (the skip tests coarser pairs) (paddle_tpu_torch/tools/flash_variants.py).
// Not done yet: wgmma (warpgroup products from shared memory), TMA copies
// and warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <initializer_list>

#include "mma_sync.cuh"
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
  const int* seed;     // dropout: the hash's seed (one int32 word in device
  float rate, inv;     // memory, or null), the rate and 1/(1-rate)
};

// The dropout seed, read from device memory as the TPU kernels read
// seed_ref[0]: a replayed CUDA graph reads the word its call wrote. An
// invariant load, so the compiler keeps it out of the keep-mask loops.
__device__ __forceinline__ uint32_t seed_of(const Extras& x) {
  return (uint32_t)__ldg(x.seed);
}

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
          pd = dropout_keep(seed_of(x), bh, r, k0 + tx + 16 * j, x.rate)
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
        const bool kp = dropout_keep(seed_of(x), qbh, r, c, x.rate);
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

// ---------------------------------------------------------------------------
// backward, bf16: the dq and dkv passes on the tensor cores
// ---------------------------------------------------------------------------
// 4 warps; each owns 16 rows of the block's tile (query rows in the dq
// pass, keys in the dkv pass) and every product's result for them, so a
// score tile's probabilities and dS pass from one product to the next in
// registers (mma_sync.cuh: a C fragment pair is an A fragment).
using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;
constexpr int kLdBiasQ = kB + 8;   // dq: bias [query][key], float2 reads
constexpr int kLdBiasK = kB + 4;   // dkv: bias [query][key], column reads

// The instance a head dim runs: 64 or 128 columns (past d: zeros)
inline int tc_dim(int d) { return d <= 64 ? 64 : 128; }
// Bytes of one staged [kB][D + 8] bf16 tile (8 columns of padding: the 8
// rows of an ldmatrix phase fall on distinct banks)
__host__ __device__ constexpr size_t tc_tile(int D) {
  return (size_t)kB * (D + 8) * sizeof(bf16);
}
// forward: Q, two stages of K and V; the bias and the key ids, two stages
inline size_t fwd_tc_smem(int D, bool bias, bool seg) {
  return 5 * tc_tile(D) + (bias ? 2 * kB * kLdBiasQ * sizeof(float) : 0) +
         (seg ? 2 * kB * sizeof(int) : 0);
}
// dq: Q, dO, two stages of K and V; the bias and the key ids, two stages
inline size_t dq_tc_smem(int D, bool bias, bool seg) {
  return 6 * tc_tile(D) + (bias ? 2 * kB * kLdBiasQ * sizeof(float) : 0) +
         (seg ? 2 * kB * sizeof(int) : 0);
}
// dkv: K, V, two stages of Q, dO, lse and delta; the bias and the query
// ids, two stages
inline size_t dkv_tc_smem(int D, bool bias, bool seg) {
  return 6 * tc_tile(D) + 4 * kB * sizeof(float) +
         (bias ? 2 * kB * kLdBiasK * sizeof(float) : 0) +
         (seg ? 2 * kB * sizeof(int) : 0);
}

// e^x as 2^(x log2 e): exp2f is one MUFU.EX2 (with its range check),
// expf a longer range reduction around it; within a few f32 ulps of expf,
// far below the bf16 rounding of P that follows (the forward's softmax)
__device__ __forceinline__ float exp_2(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// Rows [row0, row0 + kB) of one head of a [batch, rows, heads, d] bf16
// tensor into a [kB][D + 8] tile by 16-byte cp.async; rows at or past n
// and columns at or past d are zero-filled (the copy's source size 0).
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst,
                                           const bf16* __restrict__ base,
                                           size_t row_stride, int row0, int n,
                                           int d) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kB * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = row0 + r < n && c < d;
    cp_async16(dst + r * (D + 8) + c,
               ok ? base + (size_t)(row0 + r) * row_stride + c : base, ok);
  }
}

// Entries [p0, p0 + kB) of a row of n 4-byte values (a statistic, ids);
// zeros past n.
template <typename T>
__device__ __forceinline__ void stage_vec(T* dst, const T* __restrict__ src,
                                          int p0, int n) {
  for (int i = threadIdx.x; i < kB; i += kTcThreads) {
    const bool ok = p0 + i < n;
    cp_async4(dst + i, ok ? src + p0 + i : src, ok);
  }
}

// The bias tile (query rows [r0, r0 + kB), keys [c0, c0 + kB)) of one
// [sq, sk] f32 plane into a [kB][LDB] tile: 16-byte copies when the rows
// allow them (sk % 4 == 0), else 4-byte ones; zeros outside the plane.
template <int LDB>
__device__ __forceinline__ void stage_bias(float* dst,
                                           const float* __restrict__ bp,
                                           int r0, int c0, int sq, int sk) {
  if ((sk & 3) == 0) {
    for (int i = threadIdx.x; i < kB * kB / 4; i += kTcThreads) {
      const int r = i / (kB / 4), c = (i % (kB / 4)) * 4;
      const bool ok = r0 + r < sq && c0 + c < sk;
      cp_async16(dst + r * LDB + c,
                 ok ? bp + (size_t)(r0 + r) * sk + c0 + c : bp, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kB * kB; i += kTcThreads) {
      const int r = i / kB, c = i % kB;
      const bool ok = r0 + r < sq && c0 + c < sk;
      cp_async4(dst + r * LDB + c,
                ok ? bp + (size_t)(r0 + r) * sk + c0 + c : bp, ok);
    }
  }
}

// [min, max] of the ids [p0, min(p0 + kB, n)) of a row, reduced over the
// warp (all 32 lanes call it). Two tiles whose ranges do not meet hold no
// (query, key) pair of one id, so every P of the pair is 0 and the pair
// adds nothing: the segment-tile skip. The test is conservative: ids
// interleaved across a tile keep it.
__device__ __forceinline__ int2 id_range(const int* __restrict__ ids, int p0,
                                         int n) {
  int lo = 0x7fffffff, hi = -0x7fffffff - 1;
  for (int i = threadIdx.x & 31; i < kB; i += 32) {
    if (p0 + i < n) {
      const int s = ids[p0 + i];
      lo = min(lo, s);
      hi = max(hi, s);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return make_int2(lo, hi);
}
__device__ __forceinline__ bool ranges_meet(int2 a, int2 b) {
  return a.y >= b.x && b.y >= a.x;
}

// One score element, probs_and_ds's arithmetic, with every choice a
// select (the optional bodies' loads and hashes run beforehand, each in a
// loop of its own under one uniform branch, so the 16-32 elements of a
// lane interleave). ``s``: the query row dotted with the key (kX: already
// scaled, the bias added); ``dpv``: dO V^T; ``ok``: the key is seen;
// ``keep``: dropout keeps it (``drop``: rate > 0). Returns P as the dV
// product takes it (dropped) in p, dS in ds and P (dP - delta) (dbias)
// in dsb.
template <bool kX>
__device__ __forceinline__ void score(float s, float dpv, float lse,
                                      float dl, float scale, bool ok,
                                      bool drop, bool keep, float inv,
                                      float& p, float& ds, float& dsb) {
  if (!kX) {
    p = ok ? expf(s * scale - lse) : 0.f;
    ds = p * (dpv - dl) * scale;
    dsb = 0.f;
    return;
  }
  // a select, never a 0/1 multiply: lse is -inf on a row that sees no key
  const float pr = ok ? expf(s - lse) : 0.f;
  dpv = drop ? (keep ? __fmul_rn(dpv, inv) : 0.f) : dpv;
  p = drop ? (keep ? __fmul_rn(pr, inv) : 0.f) : pr;
  dsb = pr * (dpv - dl);
  ds = dsb * scale;
}

// Zeros into the dbias tile (query rows [q0, q0 + kB), keys [k0, k0 +
// kB)) of a [sq, sk] plane: a pair the dq pass does not compute.
__device__ __forceinline__ void zero_dbias(float* db, int q0, int k0, int sq,
                                           int sk) {
  for (int i = threadIdx.x; i < kB * kB; i += kTcThreads) {
    const int r = q0 + i / kB, c = k0 + i % kB;
    if (r < sq && c < sk) db[(size_t)r * sk + c] = 0.f;
  }
}

// forward: a block per (query tile, b*h head), the last query tiles (the
// most key tiles under the causal mask) first. Q is staged once; the key
// tiles it visits (with segment ids, those whose ids meet the query
// tile's) stream through two stages of K, V (and the bias and key ids) by
// cp.async. Warp w owns query rows 16w .. 16w + 15: S = Q K^T by mma.sync
// (ldmatrix from the row-major tiles), the online softmax on S's C
// fragments (a row's max and sum over the 4 lanes that hold it), P's C
// fragment pairs cast to bf16 as the A fragments of P V, V read
// transposed by ldmatrix.trans. Each tile's P V is summed from zero and
// added to O alpha in f32, as JAX adds dot(P, V) to acc * alpha; O stays in
// f32 registers to the end. The mask runs only on a tile that crosses the
// warp's causal diagonal or the end of the keys (or with segment ids).
template <int D, bool kX>
__global__ void __launch_bounds__(kTcThreads, 2)
fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, int h, int kvh, int sq, int sk, int d,
              float scale, int causal, const Extras x) {
  constexpr int LD = D + 8, KS = D / 16, NT = D / 8;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;
  const int bh = blockIdx.y;
  const int bi = bh / h, hi = bh - bi * h;
  const int kvi = hi / (h / kvh);
  const int off = sk - sq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_tc);
  bf16* k_s = q_s + kB * LD;       // [2][kB][LD]
  bf16* v_s = k_s + 2 * kB * LD;   // [2][kB][LD]
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * kB * LD);
  const float* bp = kX ? bias_plane(x, bi, hi, sq, sk) : nullptr;
  int* segk_s = reinterpret_cast<int*>(bias_s + (bp ? 2 * kB * kLdBiasQ : 0));
  const bool seg = kX && x.seg_q != nullptr;
  const bool drop = kX && x.rate > 0.f;
  const int* sgk = seg ? x.seg_k + (size_t)bi * sk : nullptr;

  const size_t qrs = (size_t)h * d, krs = (size_t)kvh * d;
  const size_t qhead = ((size_t)bi * sq * h + hi) * d;
  const bf16* kb = k + ((size_t)bi * sk * kvh + kvi) * d;
  const bf16* vb = v + ((size_t)bi * sk * kvh + kvi) * d;

  // the lane's two query rows: g and g + 8 of its warp's 16
  int rows[2], sgq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = q0 + warp * 16 + g + 8 * i;
    sgq[i] = seg && rows[i] < sq ? x.seg_q[(size_t)bi * sq + rows[i]] : 0;
  }
  const int2 qids = seg ? id_range(x.seg_q + (size_t)bi * sq, q0, sq)
                        : make_int2(0, 0);

  const int nkt = key_tiles(q0, sk, off, causal);
  // fwd_kernel's running max is at least kMaskValue once a tile is
  // visited: a row whose tiles are all skipped keeps its lse (kMaskValue),
  // a query tile with no key tile its -inf
  float m[2], l[2] = {0.f, 0.f}, acc[NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) m[i] = nkt > 0 ? kMaskValue : -CUDART_INF_F;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // the first key tile from kt on whose ids meet the query tile's
  auto next = [&](int kt) {
    if (seg)
      while (kt < nkt && !ranges_meet(qids, id_range(sgk, kt * kB, sk))) ++kt;
    return kt;
  };
  auto stage = [&](int kt, int buf) {
    const int k0 = kt * kB;
    stage_rows<D>(k_s + buf * kB * LD, kb, krs, k0, sk, d);
    stage_rows<D>(v_s + buf * kB * LD, vb, krs, k0, sk, d);
    if (bp) stage_bias<kLdBiasQ>(bias_s + buf * kB * kLdBiasQ, bp, q0, k0, sq,
                                 sk);
    if (seg) stage_vec(segk_s + buf * kB, sgk, k0, sk);
  };

  int kt = next(0);
  if (kt < nkt) {
    stage_rows<D>(q_s, q + qhead, qrs, q0, sq, d);
    stage(kt, 0);
  }
  cp_async_commit();
  for (int buf = 0; kt < nkt; buf ^= 1) {
    const int nx = next(kt + 1);
    if (nx < nkt) stage(nx, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();   // Q and this tile have landed
    __syncthreads();
    const int k0 = kt * kB;
    const bf16* ks = k_s + buf * kB * LD;
    const bf16* vs = v_s + buf * kB * LD;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    // one depth step at a time (dq_tc_kernel: unrolled, the compiler
    // hoists the next steps' fragments and spills)
#pragma unroll 1
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4];
      ldmatrix4(aq, q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                        (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t bk[4];
        ldmatrix4(bk, ks + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
        mma2_rn(s[n], s[n + 1], aq, bk);
      }
    }
    // element e of tile n (bit 4n + e of the masks): query row rows[e >>
    // 1], key k0 + 8n + 2 t4 + (e & 1). JAX's s = dot * scale + bias, each
    // rounded.
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale);
    if (kX && bp) {
      const float* bt = bias_s + buf * kB * kLdBiasQ +
                        (warp * 16 + g) * kLdBiasQ + 2 * t4;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = __fadd_rn(s[n][e], bt[(e >> 1) * 8 * kLdBiasQ + n * 8 +
                                          (e & 1)]);
    }
    uint32_t ok = 0xffffffffu, keep = 0;
    if ((causal && k0 + kB - 1 > q0 + warp * 16 + off) || k0 + kB > sk ||
        seg) {
      ok = 0;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ok |= (uint32_t)sees(rows[e >> 1], k0 + n * 8 + 2 * t4 + (e & 1),
                               sq, sk, off, causal) << (4 * n + e);
      if (seg) {
        const int* st = segk_s + buf * kB + 2 * t4;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (sgq[e >> 1] != st[n * 8 + (e & 1)]) ok &= ~(1u << (4 * n + e));
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!(ok >> (4 * n + e) & 1)) s[n][e] = kMaskValue;
    }
    if (drop) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          keep |= (uint32_t)dropout_keep(seed_of(x), bh, rows[e >> 1],
                                         k0 + n * 8 + 2 * t4 + (e & 1),
                                         x.rate) << (4 * n + e);
    }
    // the online softmax: the tile's row max (from kMaskValue, as
    // fwd_kernel), alpha, P (a select to 0 where masked), l from the
    // undropped P; P V takes the dropped P
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mc = kMaskValue;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mc = fmaxf(mc, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float mn = fmaxf(m[i], mc);
      alpha[i] = exp_2(m[i] - mn);
      m[i] = mn;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, bit = 4 * n + e;
        const float p = ok >> bit & 1 ? exp_2(s[n][e] - m[i]) : 0.f;
        ps[i] += p;
        s[n][e] = drop ? (keep >> bit & 1 ? __fmul_rn(p, x.inv) : 0.f) : p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 1);
      ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 2);
      l[i] = __fadd_rn(__fmul_rn(alpha[i], l[i]), ps[i]);
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(s[2 * kk], s[2 * kk + 1], pa[kk]);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[4];
        ldmatrix4_trans(b, vs + (kk * 16 + (lane & 15)) * LD + n * 8 +
                               (lane >> 4) * 8);
        mma2(t0, t1, pa[kk], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[n][e] = __fadd_rn(__fmul_rn(acc[n][e], alpha[e >> 1]), t0[e]);
        acc[n + 1][e] =
            __fadd_rn(__fmul_rn(acc[n + 1][e], alpha[e >> 1]), t1[e]);
      }
    }
    __syncthreads();   // every warp is done with this stage
    kt = nx;
  }
  cp_async_wait0();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    if (t4 == 0) lse[(size_t)bh * sq + rows[i]] = m[i] + logf(ls);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(o + qhead + (size_t)rows[i] * qrs +
                                           col) =
            __floats2bfloat162_rn(acc[n][2 * i] / ls, acc[n][2 * i + 1] / ls);
    }
  }
}

// dq pass: a block per (query tile, b*h head), the last query tiles (the
// most key tiles under the causal mask) first. Q and dO are staged once;
// the key tiles it computes stream through two stages of K, V (and the
// bias and key ids) by cp.async, the next one copied while the current
// one is multiplied. Warp w owns query rows 16w .. 16w + 15: S = Q K^T
// and dP = dO V^T (ldmatrix from the row-major tiles), P and dS in
// registers, dQ += bf16(dS) K (dS's C fragments as the A operand, K read
// transposed by ldmatrix.trans), dQ in f32 registers to the end.
template <int D, bool kX>
__global__ void __launch_bounds__(kTcThreads, 2)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int h, int kvh, int sq, int sk, int d,
             float scale, int causal, const Extras x) {
  constexpr int LD = D + 8, KS = D / 16, NT = D / 8;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;
  const int bh = blockIdx.y;
  const int bi = bh / h, hi = bh - bi * h;
  const int kvi = hi / (h / kvh);
  const int off = sk - sq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_tc);
  bf16* do_s = q_s + kB * LD;
  bf16* k_s = do_s + kB * LD;      // [2][kB][LD]
  bf16* v_s = k_s + 2 * kB * LD;   // [2][kB][LD]
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * kB * LD);
  const float* bp = kX ? bias_plane(x, bi, hi, sq, sk) : nullptr;
  int* segk_s = reinterpret_cast<int*>(bias_s + (bp ? 2 * kB * kLdBiasQ : 0));
  const bool seg = kX && x.seg_q != nullptr;
  const int* sgk = seg ? x.seg_k + (size_t)bi * sk : nullptr;
  float* db = kX && x.dbias ? x.dbias + (size_t)bh * sq * sk : nullptr;

  const size_t qrs = (size_t)h * d, krs = (size_t)kvh * d;
  const size_t qhead = ((size_t)bi * sq * h + hi) * d;
  const bf16* kb = k + ((size_t)bi * sk * kvh + kvi) * d;
  const bf16* vb = v + ((size_t)bi * sk * kvh + kvi) * d;

  // the lane's two query rows: g and g + 8 of its warp's 16
  int rows[2], sgq[2];
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = q0 + warp * 16 + g + 8 * i;
    const bool in = rows[i] < sq;
    lse_r[i] = in ? lse[(size_t)bh * sq + rows[i]] : 0.f;
    dl_r[i] = in ? delta[(size_t)bh * sq + rows[i]] : 0.f;
    sgq[i] = seg && in ? x.seg_q[(size_t)bi * sq + rows[i]] : 0;
  }
  const int2 qids = seg ? id_range(x.seg_q + (size_t)bi * sq, q0, sq)
                        : make_int2(0, 0);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int nkt = key_tiles(q0, sk, off, causal);
  // the first key tile from kt on that the block computes; with dbias the
  // tiles skipped on the way get their zeros
  auto next = [&](int kt) {
    for (; kt < nkt; ++kt) {
      if (!seg || ranges_meet(qids, id_range(sgk, kt * kB, sk))) break;
      if (db) zero_dbias(db, q0, kt * kB, sq, sk);
    }
    return kt;
  };
  auto stage = [&](int kt, int buf) {
    const int k0 = kt * kB;
    stage_rows<D>(k_s + buf * kB * LD, kb, krs, k0, sk, d);
    stage_rows<D>(v_s + buf * kB * LD, vb, krs, k0, sk, d);
    if (bp) stage_bias<kLdBiasQ>(bias_s + buf * kB * kLdBiasQ, bp, q0, k0, sq,
                                 sk);
    if (seg) stage_vec(segk_s + buf * kB, sgk, k0, sk);
  };

  int kt = next(0);
  if (kt < nkt) {
    stage_rows<D>(q_s, q + qhead, qrs, q0, sq, d);
    stage_rows<D>(do_s, dout + qhead, qrs, q0, sq, d);
    stage(kt, 0);
  }
  cp_async_commit();
  for (int buf = 0; kt < nkt; buf ^= 1) {
    const int nx = next(kt + 1);
    if (nx < nkt) stage(nx, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();   // Q, dO and this tile have landed
    __syncthreads();
    const int k0 = kt * kB;
    const bf16* ks = k_s + buf * kB * LD;
    const bf16* vs = v_s + buf * kB * LD;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
// one depth step at a time: unrolled, the compiler hoists the next
    // steps' fragments and spills
#pragma unroll 1
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ado[4];
      const int ai = (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
      ldmatrix4(aq, q_s + ai);
      ldmatrix4(ado, do_s + ai);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        const int bi_ = (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bk[4], bv[4];
        ldmatrix4(bk, ks + bi_);
        ldmatrix4(bv, vs + bi_);
        mma2_rn(s[n], s[n + 1], aq, bk);
        mma2_rn(dp[n], dp[n + 1], ado, bv);
      }
    }
    // element e of tile n (bit 4n + e of the masks): query row rows[e >>
    // 1], key k0 + 8n + 2 t4 + (e & 1); dS replaces dP, dbias's P (dP -
    // delta) replaces S
    uint32_t ok = 0, keep = 0;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ok |= (uint32_t)sees(rows[e >> 1], k0 + n * 8 + 2 * t4 + (e & 1), sq,
                             sk, off, causal) << (4 * n + e);
    if (kX) {
      // JAX's s = dot * scale + bias, each rounded
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale);
      if (bp) {
        const float* bt = bias_s + buf * kB * kLdBiasQ +
                          (warp * 16 + g) * kLdBiasQ + 2 * t4;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = __fadd_rn(s[n][e], bt[(e >> 1) * 8 * kLdBiasQ + n * 8 +
                                            (e & 1)]);
      }
      if (seg) {
        const int* st = segk_s + buf * kB + 2 * t4;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (sgq[e >> 1] != st[n * 8 + (e & 1)]) ok &= ~(1u << (4 * n + e));
      }
      if (x.rate > 0.f) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            keep |= (uint32_t)dropout_keep(seed_of(x), bh, rows[e >> 1],
                                           k0 + n * 8 + 2 * t4 + (e & 1),
                                           x.rate) << (4 * n + e);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, bit = 4 * n + e;
        float p, ds, dsb;
        score<kX>(s[n][e], dp[n][e], lse_r[i], dl_r[i], scale, ok >> bit & 1,
                  kX && x.rate > 0.f, keep >> bit & 1, x.inv, p, ds, dsb);
        dp[n][e] = ds;
        s[n][e] = dsb;
      }
    if (kX && db) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = k0 + n * 8 + 2 * t4;
          if (rows[i] >= sq || c >= sk) continue;
          float* dst = db + (size_t)rows[i] * sk + c;
          if ((sk & 1) == 0) {
            *reinterpret_cast<float2*>(dst) =
                make_float2(s[n][2 * i], s[n][2 * i + 1]);
          } else {
            dst[0] = s[n][2 * i];
            if (c + 1 < sk) dst[1] = s[n][2 * i + 1];
          }
        }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a_frag(dp[2 * kk], dp[2 * kk + 1], a);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        ldmatrix4_trans(b, ks + (kk * 16 + (lane & 15)) * LD + n * 8 +
                               (lane >> 4) * 8);
        mma2(acc[n], acc[n + 1], a, b);
      }
    }
    __syncthreads();   // every warp is done with this stage
    kt = nx;
  }
  cp_async_wait0();
  if (db)
    for (int t = nkt; t < (sk + kB - 1) / kB; ++t)
      zero_dbias(db, q0, t * kB, sq, sk);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = n * 8 + 2 * t4;
      if (rows[i] < sq && col < d)
        *reinterpret_cast<__nv_bfloat162*>(dq + qhead +
                                           (size_t)rows[i] * qrs + col) =
            __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
    }
}

// dkv pass: a block per (key tile, b*kvh head). K and V are staged once;
// for each query head of the group, the query tiles that see the key tile
// (from the causal diagonal on, and with segment ids those whose ids meet
// the key tile's) stream through two stages of Q, dO, lse, delta (and the
// bias and query ids). Warp w owns keys 16w .. 16w + 15 and computes the
// transposed scores S^T = K Q^T and dP^T = V dO^T, RS query rows at a
// time (so that dK and dV, 2 x 16 x D f32 a warp, stay in registers);
// dV += P^T dO with the f32 P split into two bf16 terms, dK += bf16(dS)^T
// Q, both with the query rows as the product's depth (dO and Q read
// transposed).
template <int D, bool kX>
__global__ void __launch_bounds__(kTcThreads, 2)
dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int h, int kvh,
              int sq, int sk, int d, float scale, int causal,
              const Extras x) {
  constexpr int LD = D + 8, KS = D / 16, NT = D / 8;
  // query rows a sub-step scores: 32, or 16 where the bodies' registers
  // would push the D = 128 instance past 255 a thread
  constexpr int RS = kX && D == 128 ? 16 : 32, NS = RS / 8;
  const int k0 = blockIdx.x * kB;
  const int bkv = blockIdx.y;
  const int bi = bkv / kvh, kvi = bkv - bi * kvh;
  const int groups = h / kvh;
  const int off = sk - sq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_tc);
  bf16* v_s = k_s + kB * LD;
  bf16* q_s = v_s + kB * LD;        // [2][kB][LD]
  bf16* do_s = q_s + 2 * kB * LD;   // [2][kB][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kB * LD);  // [2][kB]
  float* dl_s = lse_s + 2 * kB;                                 // [2][kB]
  float* bias_s = dl_s + 2 * kB;    // [2][kB][kLdBiasK]
  const bool has_bias = kX && x.bias != nullptr;
  int* segq_s = reinterpret_cast<int*>(bias_s +
                                       (has_bias ? 2 * kB * kLdBiasK : 0));
  const bool seg = kX && x.seg_q != nullptr;
  const int* sgq = seg ? x.seg_q + (size_t)bi * sq : nullptr;

  const size_t qrs = (size_t)h * d, krs = (size_t)kvh * d;
  const size_t khead = ((size_t)bi * sk * kvh + kvi) * d;

  // the lane's two keys: g and g + 8 of its warp's 16
  int keys[2], sgk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    keys[i] = k0 + warp * 16 + g + 8 * i;
    sgk[i] = seg && keys[i] < sk ? x.seg_k[(size_t)bi * sk + keys[i]] : 0;
  }
  const int2 kids = seg ? id_range(x.seg_k + (size_t)bi * sk, k0, sk)
                        : make_int2(0, 0);

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // work item t: query head kvi * groups + t / span, query tile first +
  // t % span (the TPU index map's causal clamp, here the walk's start)
  const int first = causal ? max(k0 - off, 0) / kB : 0;
  const int span = (sq + kB - 1) / kB - first;
  const int items = groups * span;
  auto next = [&](int t) {
    if (seg)
      while (t < items &&
             !ranges_meet(kids, id_range(sgq, (first + t % span) * kB, sq)))
        ++t;
    return t;
  };
  auto stage = [&](int t, int buf) {
    const int hq = kvi * groups + t / span, q0 = (first + t % span) * kB;
    const size_t bh = (size_t)bi * h + hq;
    const size_t qhead = ((size_t)bi * sq * h + hq) * d;
    stage_rows<D>(q_s + buf * kB * LD, q + qhead, qrs, q0, sq, d);
    stage_rows<D>(do_s + buf * kB * LD, dout + qhead, qrs, q0, sq, d);
    stage_vec(lse_s + buf * kB, lse + bh * sq, q0, sq);
    stage_vec(dl_s + buf * kB, delta + bh * sq, q0, sq);
    if (has_bias)
      stage_bias<kLdBiasK>(bias_s + buf * kB * kLdBiasK,
                           bias_plane(x, bi, hq, sq, sk), q0, k0, sq, sk);
    if (seg) stage_vec(segq_s + buf * kB, sgq, q0, sq);
  };

  int t = next(0);
  if (t < items) {
    stage_rows<D>(k_s, k + khead, krs, k0, sk, d);
    stage_rows<D>(v_s, v + khead, krs, k0, sk, d);
    stage(t, 0);
  }
  cp_async_commit();
  for (int buf = 0; t < items; buf ^= 1) {
    const int nx = next(t + 1);
    if (nx < items) stage(nx, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();   // K, V and this tile have landed
    __syncthreads();
    const int hq = kvi * groups + t / span, q0 = (first + t % span) * kB;
    const uint32_t qbh = (uint32_t)(bi * h + hq);
    const bf16* qs = q_s + buf * kB * LD;
    const bf16* dos = do_s + buf * kB * LD;
    const float* lses = lse_s + buf * kB;
    const float* dls = dl_s + buf * kB;
    const float* bs = bias_s + buf * kB * kLdBiasK;
    const int* sqs = segq_s + buf * kB;
#pragma unroll
    for (int part = 0; part < kB / RS; ++part) {
      const int r0 = part * RS;
      if (q0 + r0 >= sq) break;
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ak[4], av[4];
        const int ai = (warp * 16 + (lane & 15)) * LD + kk * 16 +
                       (lane >> 4) * 8;
        ldmatrix4(ak, k_s + ai);
        ldmatrix4(av, v_s + ai);
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          const int bi_ = (r0 + n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t bq[4], bdo[4];
          ldmatrix4(bq, qs + bi_);
          ldmatrix4(bdo, dos + bi_);
          mma2_rn(s[n], s[n + 1], ak, bq);
          mma2_rn(dp[n], dp[n + 1], av, bdo);
        }
      }
      // element e of tile n (bit 4n + e of the masks): key keys[e >> 1],
      // query row q0 + r0 + 8n + 2 t4 + (e & 1); the dropped P replaces S,
      // dS replaces dP
      uint32_t ok = 0, keep = 0;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ok |= (uint32_t)sees(q0 + r0 + n * 8 + 2 * t4 + (e & 1),
                               keys[e >> 1], sq, sk, off, causal)
                << (4 * n + e);
      if (kX) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale);
        if (has_bias) {
          const float* bt = bs + (r0 + 2 * t4) * kLdBiasK + warp * 16 + g;
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[n][e] = __fadd_rn(s[n][e], bt[(n * 8 + (e & 1)) * kLdBiasK +
                                              (e >> 1) * 8]);
        }
        if (seg) {
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (sqs[r0 + n * 8 + 2 * t4 + (e & 1)] != sgk[e >> 1])
                ok &= ~(1u << (4 * n + e));
        }
        if (x.rate > 0.f) {
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              keep |= (uint32_t)dropout_keep(
                          seed_of(x), qbh, q0 + r0 + n * 8 + 2 * t4 + (e & 1),
                          keys[e >> 1], x.rate)
                      << (4 * n + e);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = r0 + n * 8 + 2 * t4 + (e & 1), bit = 4 * n + e;
          float p, ds, dsb;
          score<kX>(s[n][e], dp[n][e], lses[rl], dls[rl], scale,
                    ok >> bit & 1, kX && x.rate > 0.f, keep >> bit & 1,
                    x.inv, p, ds, dsb);
          s[n][e] = p;
          dp[n][e] = ds;
        }
#pragma unroll
      for (int kk = 0; kk < RS / 16; ++kk) {
        uint32_t phi[4], plo[4], a[4];
        a_frag_split(s[2 * kk], s[2 * kk + 1], phi, plo);
        a_frag(dp[2 * kk], dp[2 * kk + 1], a);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          const int bi_ = (r0 + kk * 16 + (lane & 15)) * LD + n * 8 +
                          (lane >> 4) * 8;
          uint32_t b[4];
          ldmatrix4_trans(b, dos + bi_);
          mma2(dv_acc[n], dv_acc[n + 1], phi, b);
          mma2(dv_acc[n], dv_acc[n + 1], plo, b);
          ldmatrix4_trans(b, qs + bi_);
          mma2(dk_acc[n], dk_acc[n + 1], a, b);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
    t = nx;
  }
  cp_async_wait0();
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = n * 8 + 2 * t4;
      if (keys[i] >= sk || col >= d) continue;
      const size_t at = khead + (size_t)keys[i] * krs + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
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

template <int D, bool kX>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          void* o, void* lse, int b, int h, int kvh, int sq,
                          int sk, int d, float scale, int causal,
                          const Extras& x, size_t smem, cudaStream_t stream) {
  cudaError_t e = allow_smem(fwd_tc_kernel<D, kX>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((sq + kB - 1) / kB, b * h);
  fwd_tc_kernel<D, kX><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), h, kvh, sq, sk, d, scale, causal, x);
  return cudaGetLastError();
}

template <int D, bool kX>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int b, int h, int kvh, int sq, int sk,
                         int d, float scale, int causal, const Extras& x,
                         size_t smem, cudaStream_t stream) {
  cudaError_t e = allow_smem(dq_tc_kernel<D, kX>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((sq + kB - 1) / kB, b * h);
  dq_tc_kernel<D, kX><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), h, kvh, sq, sk, d, scale, causal, x);
  return cudaGetLastError();
}

template <int D, bool kX>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int b, int h,
                          int kvh, int sq, int sk, int d, float scale,
                          int causal, const Extras& x, size_t smem,
                          cudaStream_t stream) {
  cudaError_t e = allow_smem(dkv_tc_kernel<D, kX>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((sk + kB - 1) / kB, b * kvh);
  dkv_tc_kernel<D, kX><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, kvh, sq, sk, d,
      scale, causal, x);
  return cudaGetLastError();
}

// The tensor-core instance of ``launch`` for the head dim and extras.
#define TC_DISPATCH(launch, d, x, ...)                                  \
  (tc_dim(d) == 64 ? (any_extra(x) ? launch<64, true>(__VA_ARGS__)      \
                                   : launch<64, false>(__VA_ARGS__))    \
                   : (any_extra(x) ? launch<128, true>(__VA_ARGS__)     \
                                   : launch<128, false>(__VA_ARGS__)))

// The f32 (CUDA-core) instance of ``launch`` for the extras.
#define F32_DISPATCH(launch, x, ...)                   \
  (any_extra(x) ? launch<float, true>(__VA_ARGS__)     \
                : launch<float, false>(__VA_ARGS__))

// Whether every pointer is 16-byte aligned (the tensor-core passes copy
// 16 bytes at a time)
inline bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

inline Extras make_extras(const void* bias, int bias_b, int bias_h,
                          const void* seg_q, const void* seg_k, void* dbias,
                          const void* seed, float rate, float inv) {
  return Extras{static_cast<const float*>(bias), bias_b, bias_h,
                static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
                static_cast<float*>(dbias), static_cast<const int*>(seed),
                rate, inv};
}

}  // namespace flash
}  // namespace paddle_tpu_torch

// C interface, bound with ctypes (paddle_tpu_torch/ops/kernels/
// flash_attention.py checks devices, types, shapes and contiguity first).
// dtype: 0 = float32, 1 = bfloat16; block and smem: the wrapper's plan, the
// kernels' kB-row tiles and the shared memory of the instance the launch
// runs (in bf16 the tensor-core kernel's, with the bias and id stages it
// takes), or the launch is refused (cudaErrorInvalidValue; a bf16 operand
// not 16-byte aligned: cudaErrorMisalignedAddress). The optional bodies:
// bias (f32, or
// null) with its batch and head extents bias_b, bias_h; seg_q, seg_k
// (int32, or both null); dbias (dq pass, or null); the dropout seed (one
// int32 word in device memory, read by the kernel; null when rate is 0),
// rate and inv = 1 / (1 - rate) (rate 0: no dropout; a rate without a
// seed: cudaErrorInvalidValue). Each returns its launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* seg_q, const void* seg_k,
                                   void* o, void* lse, int b, int h, int kvh,
                                   int sq, int sk, int d, int block,
                                   int smem, int bias_b, int bias_h,
                                   const void* seed, float scale, float rate,
                                   float inv, int causal, int dtype,
                                   void* stream) {
  using namespace paddle_tpu_torch::flash;
  const size_t want = dtype == 1 ? fwd_tc_smem(tc_dim(d), bias != nullptr,
                                               seg_q != nullptr)
                                 : fwd_smem(d);
  if (block != kB || (size_t)smem != want) return cudaErrorInvalidValue;
  if (rate > 0.f && seed == nullptr) return cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Extras x = make_extras(bias, bias_b, bias_h, seg_q, seg_k, nullptr,
                               seed, rate, inv);
  if (dtype == 1) {
    if (!aligned16({q, k, v, bias})) return cudaErrorMisalignedAddress;
    return TC_DISPATCH(launch_fwd_tc, d, x, q, k, v, o, lse, b, h, kvh, sq,
                       sk, d, scale, causal, x, want, s);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  return F32_DISPATCH(launch_fwd, x, q, k, v, o, lse, b, h, kvh, sq, sk, d,
                      scale, causal, x, s);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      const void* seg_q, const void* seg_k,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dq,
                                      void* dbias, int b, int h, int kvh,
                                      int sq, int sk, int d, int block,
                                      int smem, int bias_b, int bias_h,
                                      const void* seed, float scale,
                                      float rate, float inv, int causal,
                                      int dtype, void* stream) {
  using namespace paddle_tpu_torch::flash;
  const size_t want = dtype == 1 ? dq_tc_smem(tc_dim(d), bias != nullptr,
                                              seg_q != nullptr)
                                 : dq_smem(d);
  if (block != kB || (size_t)smem != want) return cudaErrorInvalidValue;
  if (rate > 0.f && seed == nullptr) return cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Extras x = make_extras(bias, bias_b, bias_h, seg_q, seg_k, dbias,
                               seed, rate, inv);
  if (dtype == 1) {
    if (!aligned16({q, k, v, dout, bias})) return cudaErrorMisalignedAddress;
    return TC_DISPATCH(launch_dq_tc, d, x, q, k, v, dout, lse, delta, dq, b,
                       h, kvh, sq, sk, d, scale, causal, x, want, s);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  return F32_DISPATCH(launch_dq, x, q, k, v, dout, lse, delta, dq, b, h, kvh,
                      sq, sk, d, scale, causal, x, s);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* seg_q, const void* seg_k,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv,
                                       int b, int h, int kvh, int sq, int sk,
                                       int d, int block, int smem,
                                       int bias_b, int bias_h,
                                       const void* seed, float scale,
                                       float rate, float inv, int causal,
                                       int dtype, void* stream) {
  using namespace paddle_tpu_torch::flash;
  const size_t want = dtype == 1 ? dkv_tc_smem(tc_dim(d), bias != nullptr,
                                               seg_q != nullptr)
                                 : dkv_smem(d);
  if (block != kB || (size_t)smem != want) return cudaErrorInvalidValue;
  if (rate > 0.f && seed == nullptr) return cudaErrorInvalidValue;
  if (b == 0 || sk == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Extras x = make_extras(bias, bias_b, bias_h, seg_q, seg_k, nullptr,
                               seed, rate, inv);
  if (dtype == 1) {
    if (!aligned16({q, k, v, dout, bias})) return cudaErrorMisalignedAddress;
    return TC_DISPATCH(launch_dkv_tc, d, x, q, k, v, dout, lse, delta, dk,
                       dv, b, h, kvh, sq, sk, d, scale, causal, x, want, s);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  return F32_DISPATCH(launch_dkv, x, q, k, v, dout, lse, delta, dk, dv, b, h,
                      kvh, sq, sk, d, scale, causal, x, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
