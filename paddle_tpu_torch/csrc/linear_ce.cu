// Fused lm-head + cross entropy for Hopper (sm_90a): the forward, and the
// backward as a P pass and two products.
//
// Replaces paddle_tpu/ops/pallas/fused_train.py's three Pallas kernels:
//   linear_ce_fwd     _ce_fwd_kernel  (:72, launch in _ce_fwd_call :246)
//   linear_ce_bwd_dx  _ce_dx_kernel   (:130, launch in _ce_bwd_call :273)
//   linear_ce_bwd_dh  _ce_dh_kernel   (:151, launch in _ce_bwd_call :289)
// and the tile recomputation they share (_ce_tile, :113).
//
//   x      [T, D]   f32 or bf16, rows of sx elements (the flattened hidden
//                   states)
//   head   [D, V]   x's type, in one of two layouts: the untied lm head
//                   row-major (rows of D, sh elements apart), or the tied
//                   one, the embedding [V, D] seen transposed (rows of V,
//                   sh elements apart); the wrapper copies any other
//   labels [T]      int64; a negative label is ignored
//   lse, pick [T]   f32: log-sum-exp of the row's logits and the logit at
//                   its label (0 where the label is ignored)
//   coef            one f32 on the device: g / max(count, 1)
//
// Every bf16 pass forms S = x head, or a product over P, as one bf16 GEMM
// with its sum in registers: output tiles of 128 x 256, two consumer
// warpgroups of 64 rows each (m64n256k16, f32 accumulators), operand tiles
// 64 deep (dh's 32: x and P both MN-major, five stages) staged by TMA with
// the 128-byte swizzle into a ring of stages behind mbarriers, one
// producer warp; one tile a block, the tiles taken in groups of output
// rows so that the blocks in flight share their operand panels in the
// 50 MB L2. x, P and the head are read K-major or MN-major as the product
// needs, by wgmma's transpose bits (hopper_gemm.cuh). The passes differ in
// their epilogue, a template argument of the one kernel body.
//
// The forward (linear_ce_fwd). The TPU kernel walks the vocab tiles of a
// token tile in a sequential grid axis, carrying an online log-sum-exp in
// VMEM. Here each 128 x 256 tile of S is one block's product, and its
// epilogue reduces the tile's rows to stats: for each row, m = the max of
// its columns below V, l = sum exp(s - m) over them, pick = s at the row's
// label when the label falls in the tile; a row's 256 columns sit on the 4
// lanes of a quad, so it reduces with two shuffles. The stats go to part
// [3][vocab tiles][T] f32 (rows >= T never written); a second kernel
// combines a token's vocab tiles in a fixed order (8 strands of tiles v,
// v + 8, ..., each in tile order, then the strands in order): lse = M +
// log(sum l exp(m - M)), M the max of the m, and pick the sum of the
// picks. f32 keeps the CUDA-core forward: (64-token x 128-vocab) FMA tiles
// through an online log-sum-exp, a block per token tile and vocab split,
// the splits combined in split order.
//
// The backward. The TPU kernels recompute S tile by tile in each pass and
// carry the dx and dh sums across a sequential grid axis in VMEM. A Hopper
// block cannot hold those sums (a 64-row f32 dx tile at D = 4096 is 1 MB),
// so doing the same here means f32 partial sums in device memory for every
// logit tile (~65 GB of traffic at the training shape) and S computed
// twice. Instead, P is formed once:
//   1. the P pass (linear_ce_p): S = x head, then in the epilogue
//      P = (exp(S - lse) - onehot(label)) * (label >= 0) * coef, columns
//      >= V zero, written as two bf16 arrays hi = bf16(P), lo = bf16(P -
//      hi) [rows, Vp] (Vp = V rounded up to 64);
//   2. dx = hi head^T + lo head^T (linear_ce_bwd_dx): K = Vp, one staged
//      head tile feeds both products into the same f32 registers;
//   3. dh = x^T hi + x^T lo (linear_ce_bwd_dh): K = T, into dh [D, V], or
//      dh^T = hi^T x + lo^T x into [V, D] when dh is the tied embedding's
//      gradient, so that its stores run along the embedding's rows.
// hi + lo carries ~16 bits of P, the head is exact in bf16, so the
// products hold P to better than the TF32 the TPU kernels round it to.
//
// Token chunks. The wrapper bounds P's workspace (T Vp 4 bytes <= 1 GiB,
// one chunk at the training shape) and walks chunks of rows beyond it: dx
// rows are whole in each chunk (dx's call walks them last to first, so
// that the workspace it leaves holds the first); dh accumulates over the
// chunks in chunk order in an f32 buffer [M, N] (``mode``: 1 store, 2 add,
// 3 add and cast; 0 cast a single chunk's sum), the last chunk's epilogue
// casting it.
//
// f32 inputs run the same passes on CUDA-core FMA tiles (64 x 128, 256
// threads) with an f32 P and no TF32 anywhere, so the loss and both
// gradients hold to 1e-5 of the plain f32 version; expf / logf are the
// accurate ones.
//
// What bounds them on the H100: operations. At the training shape (T
// 4096, D 4096, V 32000, bf16) the forward is 1.07 TFLOP of products
// (1.09 ms at the bf16 peak of 989 TFLOP/s), the dx call S plus one
// product (2.15 TFLOP: 2.17 ms), the dh call over a given P one product
// (1.07 TFLOP: 1.09 ms); the backward pair 3.26 ms. The hi + lo products
// run twice the operations the function needs.
//
// No atomics anywhere: every sum runs in a fixed order, so two launches
// give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace paddle_tpu_torch {
namespace linear_ce {

// The f32 (CUDA-core) tiles of every pass
constexpr int kThreads = 256;   // 8 warps: 2 (rows) x 4 (columns)
constexpr int kBT = 64;         // tokens of a logit tile
constexpr int kBV = 128;        // vocab columns of a logit tile
constexpr int kBK = 32;         // depth of one staged operand slice
constexpr int kLdS = kBV + 4;   // forward logit tile row stride
// row stride of the staged operands: 33 f32 keep the loads of 8 rows on
// distinct banks
constexpr int kLd = kBK + 1;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Where a thread's accumulators sit: mma.sync's C fragment layout. Warp
// (wm, wn) owns rows wm * (MI * 16) .. and columns wn * 32 ..; acc[mi][ni]
// [r] is row wm*MI*16 + mi*16 + g + 8*(r >> 1), column wn*32 + ni*8 +
// 2*t4 + (r & 1).
struct Frag {
  int wm, wn, g, t4;
};
__device__ __forceinline__ Frag frag() {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return {warp >> 2, warp & 3, lane >> 2, lane & 3};
}
template <int MI>
__device__ __forceinline__ int frag_row(const Frag& f, int mi, int r) {
  return f.wm * MI * 16 + mi * 16 + f.g + 8 * (r >> 1);
}
__device__ __forceinline__ int frag_col(const Frag& f, int ni, int r) {
  return f.wn * 32 + ni * 8 + 2 * f.t4 + (r & 1);
}
template <int MI>
__device__ __forceinline__ void zero(float (&acc)[MI][4][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
}

// ---------------------------------------------------------------------------
// The f32 logit tile S[t0 .. t0+64, v0 .. v0+128) = x head
// ---------------------------------------------------------------------------
// One depth slice [k0, k0 + kBK) of both operands into shared memory:
// xs[row][k] and hs[n][k] (the head transposed, so a row's consecutive k
// are neighbours). Out-of-range elements are zeros.
__device__ void stage_slice(const float* __restrict__ x,
                            const float* __restrict__ head, long long sd,
                            long long sv, bool head_kmajor, int Tn, int D,
                            int V, int t0, int v0, int k0, float* xs,
                            float* hs) {
  for (int i = threadIdx.x; i < kBT * kBK; i += kThreads) {
    const int r = i / kBK, k = i % kBK;
    const int t = t0 + r, d = k0 + k;
    xs[r * kLd + k] = (t < Tn && d < D) ? x[static_cast<long long>(t) * D + d]
                                        : 0.f;
  }
  for (int i = threadIdx.x; i < kBV * kBK; i += kThreads) {
    int n, k;   // neighbouring threads on neighbouring addresses of head
    if (head_kmajor) {
      n = i / kBK;
      k = i % kBK;
    } else {
      k = i / kBV;
      n = i % kBV;
    }
    const int v = v0 + n, d = k0 + k;
    hs[n * kLd + k] = (v < V && d < D) ? head[d * sd + v * sv] : 0.f;
  }
}

// acc += xs hs^T over one slice, f32 on the CUDA cores
__device__ __forceinline__ void slice_product(const float* xs, const float* hs,
                                              float (&acc)[2][4][4],
                                              const Frag& f) {
  for (int k = 0; k < kBK; ++k) {
    float a[2][2], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[mi][h] = xs[(f.wm * 32 + mi * 16 + f.g + 8 * h) * kLd + k];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        b[ni][j] = hs[(f.wn * 32 + ni * 8 + 2 * f.t4 + j) * kLd + k];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[mi][ni][r] = fmaf(a[mi][r >> 1], b[ni][r & 1], acc[mi][ni][r]);
  }
}

// The whole logit tile. Every thread calls it; it synchronises the block
// before it stages anything and after its last product, so the caller may
// overwrite ``ops`` (the staging area) once it returns.
__device__ void logit_tile(const float* __restrict__ x,
                           const float* __restrict__ head, long long sd,
                           long long sv, bool head_kmajor, int Tn, int D,
                           int V, int t0, int v0, unsigned char* ops,
                           float (&acc)[2][4][4], const Frag& f) {
  zero(acc);
  __syncthreads();
  float* xs = reinterpret_cast<float*>(ops);
  float* hs = xs + kBT * kLd;
  for (int k0 = 0; k0 < D; k0 += kBK) {
    stage_slice(x, head, sd, sv, head_kmajor, Tn, D, V, t0, v0, k0, xs, hs);
    __syncthreads();
    slice_product(xs, hs, acc, f);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// linear_ce_fwd, f32
// ---------------------------------------------------------------------------
constexpr int kFwdSmem = cmax(kBT * kLdS * 4, (kBT + kBV) * kLd * 4);

// part: [3][splits][T] f32 -- m, l and pick of each (split, token)
__global__ void __launch_bounds__(kThreads, 2)
    ce_fwd_kernel(const float* __restrict__ x, const float* __restrict__ head,
                  long long sd, long long sv, int head_kmajor,
                  const long long* __restrict__ labels, int Tn, int D, int V,
                  int tiles_per_split, float* __restrict__ part) {
  __shared__ __align__(16) unsigned char smem[kFwdSmem];
  float* ss = reinterpret_cast<float*>(smem);   // the tile, after its product
  const Frag f = frag();
  const int t0 = blockIdx.x * kBT, split = blockIdx.y, splits = gridDim.y;
  const int nvt = (V + kBV - 1) / kBV;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(vt0 + tiles_per_split, nvt);
  // four neighbouring lanes share a row; lane q takes columns q, q+4, ...
  const int row = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int t = t0 + row;
  const long long label = t < Tn ? labels[t] : -1;
  float m = -CUDART_INF_F, l = 0.f, pick = 0.f;
  float acc[2][4][4];
  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * kBV;
    logit_tile(x, head, sd, sv, head_kmajor, Tn, D, V, t0, v0, smem, acc, f);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int rr = frag_row<2>(f, mi, r), cc = frag_col(f, ni, r);
          ss[rr * kLdS + cc] = v0 + cc < V ? acc[mi][ni][r] : -CUDART_INF_F;
        }
    __syncthreads();
    const float* srow = ss + row * kLdS;
    float mt = -CUDART_INF_F;
    for (int c = q; c < kBV; c += 4) mt = fmaxf(mt, srow[c]);
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);      // finite: column v0 < V
    float sum = 0.f, pk = 0.f;
    for (int c = q; c < kBV; c += 4) {
      const float s = srow[c];
      sum += expf(s - m_new);
      if (v0 + c == label) pk += s;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    pk += __shfl_xor_sync(0xffffffffu, pk, 1);
    pk += __shfl_xor_sync(0xffffffffu, pk, 2);
    l = l * expf(m - m_new) + sum;
    m = m_new;
    pick += pk;
  }
  if (q == 0 && t < Tn) {
    part[static_cast<long long>(split) * Tn + t] = m;
    part[static_cast<long long>(splits + split) * Tn + t] = l;
    part[static_cast<long long>(2 * splits + split) * Tn + t] = pick;
  }
}

// lse = M + log(sum_s l_s exp(m_s - M)), pick = sum_s pick_s, in split
// order
__global__ void ce_fwd_combine(const float* __restrict__ part, int Tn,
                               int splits, float* __restrict__ lse,
                               float* __restrict__ pick) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tn) return;
  float M = -CUDART_INF_F;
  for (int s = 0; s < splits; ++s)
    M = fmaxf(M, part[static_cast<long long>(s) * Tn + t]);
  float L = 0.f, P = 0.f;
  for (int s = 0; s < splits; ++s) {
    L += part[static_cast<long long>(splits + s) * Tn + t] *
         expf(part[static_cast<long long>(s) * Tn + t] - M);
    P += part[static_cast<long long>(2 * splits + s) * Tn + t];
  }
  lse[t] = M + logf(L);
  pick[t] = P;
}

// ---------------------------------------------------------------------------
// linear_ce_fwd, bf16: the combine of the wgmma tiles' stats
// ---------------------------------------------------------------------------
// A block takes kCombTokens tokens (one a lane) and kCombStrands warps;
// warp w walks the vocab tiles w, w + kCombStrands, ... in order, the
// strands' sums then add in strand order. part: [3][tiles][T] (m, l,
// pick), rows of T.
constexpr int kCombTokens = 32;
constexpr int kCombStrands = 8;

__global__ void __launch_bounds__(kCombTokens * kCombStrands)
    ce_fwd_stats_combine(const float* __restrict__ part, int Tn, int tiles,
                         float* __restrict__ lse, float* __restrict__ pick) {
  __shared__ float red[3][kCombStrands][kCombTokens];
  const int lane = threadIdx.x & 31, s = threadIdx.x >> 5;
  const int t = blockIdx.x * kCombTokens + lane;
  const bool ok = t < Tn;
  const long long plane = static_cast<long long>(tiles) * Tn;
  float M = -CUDART_INF_F;
  if (ok)
    for (int v = s; v < tiles; v += kCombStrands)
      M = fmaxf(M, part[static_cast<long long>(v) * Tn + t]);
  red[0][s][lane] = M;
  __syncthreads();
  M = red[0][0][lane];
#pragma unroll
  for (int k = 1; k < kCombStrands; ++k) M = fmaxf(M, red[0][k][lane]);
  float L = 0.f, P = 0.f;
  if (ok)
    for (int v = s; v < tiles; v += kCombStrands) {
      const long long o = static_cast<long long>(v) * Tn + t;
      L += part[plane + o] * expf(part[o] - M);
      P += part[2 * plane + o];
    }
  red[1][s][lane] = L;
  red[2][s][lane] = P;
  __syncthreads();
  if (s == 0 && ok) {
    L = red[1][0][lane];
    P = red[2][0][lane];
#pragma unroll
    for (int k = 1; k < kCombStrands; ++k) {
      L += red[1][k][lane];
      P += red[2][k][lane];
    }
    lse[t] = M + logf(L);
    pick[t] = P;
  }
}

// ---------------------------------------------------------------------------
// The bf16 passes on wgmma: the forward's stats, the P pass, the dx and dh
// products
// ---------------------------------------------------------------------------
namespace gemm {

using namespace hopper;

constexpr int kGBM = 128;                 // output rows of a tile (2 x 64)
constexpr int kGBN = 256;                 // output columns of a tile
constexpr int kGThreads = 384;            // 2 consumer warpgroups, 1 producer
constexpr int kStageBudget = 200 * 1024;
constexpr int kMaxStages = 6;
// PAIR: 0 one product (the P pass); 1 two A tiles (hi, lo) share the staged
// B tile; 2 two B tiles share the staged A tile (dh: x and P both MN-major,
// stages 32 deep so that the ring holds five)
template <int PAIR>
__host__ __device__ constexpr int depth() {
  return PAIR == 2 ? 32 : 64;
}
template <int PAIR>
__host__ __device__ constexpr int a_tile() {
  return kGBM * depth<PAIR>() * 2;
}
template <int PAIR>
__host__ __device__ constexpr int b_tile() {
  return kGBN * depth<PAIR>() * 2;
}
template <int PAIR>
__host__ __device__ constexpr int stage_bytes() {
  return (PAIR == 1 ? 2 : 1) * a_tile<PAIR>() +
         (PAIR == 2 ? 2 : 1) * b_tile<PAIR>();
}
template <int PAIR>
__host__ __device__ constexpr int stages() {
  return kStageBudget / stage_bytes<PAIR>() < kMaxStages
             ? kStageBudget / stage_bytes<PAIR>()
             : kMaxStages;
}
// the ring, 1 KB to align it, the full and empty barriers
template <int PAIR>
__host__ __device__ constexpr int smem_bytes() {
  return stages<PAIR>() * stage_bytes<PAIR>() + 1024 + 2 * kMaxStages * 8;
}

struct Epi {
  // the P pass
  const long long* labels;
  const float* lse;
  const float* coef;
  int V;
  void* hi;          // P itself for f32
  void* lo;
  int ldp;           // Vp
  // the gradients
  void* out;
  long long ldo;
  int out_vmajor;    // f32 dh only: element (m, n) at n * ldo + m
  float* work;       // [M, N] f32 across token chunks
  int mode;          // 0 cast; 1 store, 2 add, 3 add and cast (work)
  // the forward: [3][N tiles][M] f32, each row's (m, l, pick) of a tile
  float* part;
};

// What the epilogue does with a tile (a template argument of the body)
constexpr int kEpiOut = 0;     // the gradients: cast, or the f32 chunk sum
constexpr int kEpiP = 1;       // the P pass: hi and lo out
constexpr int kEpiStats = 2;   // the forward: each row's m, l and pick

__device__ __forceinline__ float p_value(float s, int v, int V, float lse,
                                         long long lab, float scale) {
  return v < V ? (expf(s - lse) - (v == lab ? 1.f : 0.f)) * scale : 0.f;
}

// one operand tile of R rows of the product (M or N) x BK deep, at row r0
// and depth k0; T 0: K-major (one box of 64 x R; BK 64), 1: MN-major (R /
// 64 boxes of 64 columns x BK rows, 64 BK 2 bytes apart)
template <int T, int R, int BK>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int r0, int k0) {
  if constexpr (T == 0) {
    tma_load_2d(dst, map, bar, k0, r0);
  } else {
#pragma unroll
    for (int c = 0; c < R / 64; ++c)
      tma_load_2d(dst + c * 64 * BK * 2, map, bar, r0 + 64 * c, k0);
  }
}

// the descriptor of a tile's 16-deep step kk
template <int T, int BK>
__device__ __forceinline__ uint64_t step_desc(const unsigned char* tile,
                                              int kk) {
  return T == 0 ? wgmma_desc(tile + kk * 32, 16, 1024)
                : wgmma_desc(tile + kk * 2048, 64 * BK * 2, 1024);
}

// C[M, N] = sum_k A(m, k) B(k, n) over one 128 x 256 tile a block; TA, TB:
// 0 K-major, 1 MN-major; the maps are the kernel's __grid_constant__
// parameters. EPI: kEpiP the P pass's epilogue (hi and lo out), kEpiStats
// the forward's (each row's stats), kEpiOut the gradients' (cast, or the
// f32 sum across chunks).
template <int PAIR, int TA, int TB, int EPI>
__device__ __forceinline__ void gemm_tile(const CUtensorMap* a0,
                                          const CUtensorMap* a1,
                                          const CUtensorMap* b0,
                                          const CUtensorMap* b1, int M,
                                          int N, int K, int group_m,
                                          const Epi& epi) {
  constexpr int S = stages<PAIR>(), SB = stage_bytes<PAIR>();
  constexpr int BK = depth<PAIR>(), AT = a_tile<PAIR>(), BT = b_tile<PAIR>();
  constexpr int NA = PAIR == 1 ? 2 : 1;
  static_assert(BK == 64 || (TA == 1 && TB == 1),
                "a K-major tile is 128 bytes deep");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * SB);
  uint64_t* empty = full + S;
  // grouped order: group_m tile rows walk the tile columns together
  const int nm = (M + kGBM - 1) / kGBM, nn = (N + kGBN - 1) / kGBN;
  const int per_group = group_m * nn, g = blockIdx.x / per_group;
  const int first = g * group_m;
  const int gm = nm - first < group_m ? nm - first : group_m;
  const int in = blockIdx.x - g * per_group;
  const int m0 = (first + in % gm) * kGBM, n0 = (in / gm) * kGBN;
  const int nk = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // the producer: one thread keeps the ring full
    regs_release_40();
    if (threadIdx.x == 256) {
      for (int ks = 0; ks < nk; ++ks) {
        const int s = ks % S;
        mbar_wait(&empty[s], ((ks / S) & 1) ^ 1);
        unsigned char* st = smem + s * SB;
        mbar_expect_tx(&full[s], SB);
        const int k0 = ks * BK;
        load_tile<TA, kGBM, BK>(st, a0, &full[s], m0, k0);
        if constexpr (PAIR == 1)
          load_tile<TA, kGBM, BK>(st + AT, a1, &full[s], m0, k0);
        unsigned char* bt = st + NA * AT;
        load_tile<TB, kGBN, BK>(bt, b0, &full[s], n0, k0);
        if constexpr (PAIR == 2)
          load_tile<TB, kGBN, BK>(bt + BT, b1, &full[s], n0, k0);
      }
    }
  } else {
    regs_claim_232();
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < nk; ++ks) {
      const int s = ks % S;
      mbar_wait(&full[s], (ks / S) & 1);
      const unsigned char* st = smem + s * SB;
      // this warpgroup's 64 rows of A: rows wg * 64 (K-major) or the
      // wg-th 64-column box (MN-major), 64 BK 2 bytes in either case
      const unsigned char* at = st + wg * 64 * BK * 2;
      const unsigned char* bt = st + NA * AT;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = step_desc<TA, BK>(at, kk);
        const uint64_t db = step_desc<TB, BK>(bt, kk);
        wgmma_m64n256k16<TA, TB>(acc, da, db);
        if constexpr (PAIR == 1)
          wgmma_m64n256k16<TA, TB>(acc, step_desc<TA, BK>(at + AT, kk), db);
        if constexpr (PAIR == 2)
          wgmma_m64n256k16<TA, TB>(acc, da, step_desc<TB, BK>(bt + BT, kk));
      }
      wgmma_commit();
      fence_regs(acc);
      // the stage before this one has been read: hand it back
      wgmma_wait<1>();
      fence_regs(acc);
      if (ks > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(ks - 1) % S]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    const int rbase = m0 + wg * 64 + wq * 16 + (lane >> 2);
    const int cbase = n0 + 2 * (lane & 3);
    if constexpr (EPI == kEpiP) {
      float lse_h[2], sc_h[2];
      long long lab_h[2];
      const float coef = *epi.coef;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rbase + 8 * h;
        const bool ok = row < M;
        lse_h[h] = ok ? epi.lse[row] : 0.f;
        lab_h[h] = ok ? epi.labels[row] : -1;
        sc_h[h] = lab_h[h] >= 0 ? coef : 0.f;
      }
      auto* hi = static_cast<__nv_bfloat16*>(epi.hi);
      auto* lo = static_cast<__nv_bfloat16*>(epi.lo);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = cbase + j * 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rbase + 8 * h;
          if (row >= M || col >= epi.ldp) continue;
          const float p0 = p_value(acc[j * 4 + 2 * h], col, epi.V, lse_h[h],
                                   lab_h[h], sc_h[h]);
          const float p1 = p_value(acc[j * 4 + 2 * h + 1], col + 1, epi.V,
                                   lse_h[h], lab_h[h], sc_h[h]);
          const __nv_bfloat162 vh = __floats2bfloat162_rn(p0, p1);
          const __nv_bfloat162 vl = __floats2bfloat162_rn(
              p0 - __low2float(vh), p1 - __high2float(vh));
          const long long o = static_cast<long long>(row) * epi.ldp + col;
          *reinterpret_cast<__nv_bfloat162*>(hi + o) = vh;
          *reinterpret_cast<__nv_bfloat162*>(lo + o) = vl;
        }
      }
    } else if constexpr (EPI == kEpiStats) {
      // a row's 256 columns sit on the 4 lanes of a quad (64 each):
      // the row's max, then its sum of exp and its pick, each reduced
      // over the quad by two shuffles; columns >= V do not count
      const int vt = n0 / kGBN;
      const long long plane = static_cast<long long>(nn) * M;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rbase + 8 * h;
        const long long lab = row < M ? epi.labels[row] : -1;
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (cbase + j * 8 + e < epi.V)
              mx = fmaxf(mx, acc[j * 4 + 2 * h + e]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float l = 0.f, pk = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = cbase + j * 8 + e;
            if (col < epi.V) {
              const float sv = acc[j * 4 + 2 * h + e];
              l += expf(sv - mx);
              if (col == lab) pk = sv;
            }
          }
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        pk += __shfl_xor_sync(0xffffffffu, pk, 1);
        pk += __shfl_xor_sync(0xffffffffu, pk, 2);
        if ((lane & 3) == 0 && row < M) {
          float* p = epi.part + static_cast<long long>(vt) * M + row;
          p[0] = mx;
          p[plane] = l;
          p[2 * plane] = pk;
        }
      }
    } else {
      auto* out = static_cast<__nv_bfloat16*>(epi.out);
      const bool pairs = epi.mode == 0 && epi.ldo % 2 == 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = cbase + j * 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rbase + 8 * h;
          if (row >= M || col >= N) continue;
          const float x0 = acc[j * 4 + 2 * h], x1 = acc[j * 4 + 2 * h + 1];
          const long long o = row * epi.ldo + col;
          if (pairs && col + 1 < N) {
            *reinterpret_cast<__nv_bfloat162*>(out + o) =
                __floats2bfloat162_rn(x0, x1);
            continue;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e >= N) break;
            float v = e ? x1 : x0;
            if (epi.mode != 0) {
              float* w = epi.work + static_cast<long long>(row) * N + col + e;
              if (epi.mode != 1) v += *w;
              if (epi.mode != 3) {
                *w = v;
                continue;
              }
            }
            out[o + e] = __float2bfloat16_rn(v);
          }
        }
      }
    }
  }
}

template <int PAIR, int TA, int TB, bool P_EPI>
__global__ void __launch_bounds__(kGThreads, 1)
    ce_gemm_kernel(const __grid_constant__ CUtensorMap a0,
                   const __grid_constant__ CUtensorMap a1,
                   const __grid_constant__ CUtensorMap b0,
                   const __grid_constant__ CUtensorMap b1, int M, int N,
                   int K, int group_m, Epi epi) {
  gemm_tile<PAIR, TA, TB, P_EPI ? kEpiP : kEpiOut>(&a0, &a1, &b0, &b1, M, N,
                                                    K, group_m, epi);
}

// the forward's S = x head: x K-major; the head MN-major (TB 1, the untied
// [D][V]) or K-major (TB 0, the tied [V][D])
template <int TB>
__global__ void __launch_bounds__(kGThreads, 1)
    ce_fwd_gemm_kernel(const __grid_constant__ CUtensorMap x,
                       const __grid_constant__ CUtensorMap head, int M,
                       int N, int K, int group_m, Epi epi) {
  gemm_tile<0, 0, TB, kEpiStats>(&x, &x, &head, &head, M, N, K, group_m,
                                 epi);
}

template <int PAIR, int TA, int TB, bool P_EPI>
cudaError_t launch_gemm(const CUtensorMap (&maps)[4], int M, int N, int K,
                        int group_m, const Epi& epi, cudaStream_t st) {
  auto kern = ce_gemm_kernel<PAIR, TA, TB, P_EPI>;
  constexpr int smem = smem_bytes<PAIR>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nm = (M + kGBM - 1) / kGBM, nn = (N + kGBN - 1) / kGBN;
  if (nm == 0 || nn == 0) return cudaSuccess;
  kern<<<nm * nn, kGThreads, smem, st>>>(maps[0], maps[1], maps[2], maps[3],
                                        M, N, K, group_m < nm ? group_m : nm,
                                        epi);
  return cudaGetLastError();
}

// the forward's product and stats: every tile row walks the tile columns
// together (group_m = the tile rows), as the P pass does
template <int TB>
cudaError_t launch_fwd(const CUtensorMap& x, const CUtensorMap& head, int M,
                       int N, int K, const Epi& epi, cudaStream_t st) {
  auto kern = ce_fwd_gemm_kernel<TB>;
  constexpr int smem = smem_bytes<0>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nm = (M + kGBM - 1) / kGBM, nn = (N + kGBN - 1) / kGBN;
  if (nm == 0 || nn == 0) return cudaSuccess;
  kern<<<nm * nn, kGThreads, smem, st>>>(x, head, M, N, K, nm, epi);
  return cudaGetLastError();
}

// --- f32: the same passes on the CUDA cores ---------------------------------

// C[M, N] = sum_k A(m, k) B(k, n), A(m, k) = a[m sam + k sak] (k < K),
// B(k, n) = b[k sbk + n sbn] (k < KB, n < NB; zero elsewhere), one 64 x
// 128 tile a block in mma.sync's accumulator layout (slice_product)
template <bool P_EPI>
__global__ void __launch_bounds__(linear_ce::kThreads, 2)
    ce_f32_gemm_kernel(const float* __restrict__ a, long long sam,
                       long long sak, const float* __restrict__ b,
                       long long sbk, long long sbn, int M, int N, int K,
                       int KB, int NB, Epi epi) {
  __shared__ __align__(16) float as[kBT * kLd];
  __shared__ __align__(16) float bs[kBV * kLd];
  const Frag f = frag();
  const int m0 = blockIdx.y * kBT, n0 = blockIdx.x * kBV;
  float acc[2][4][4];
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    // neighbouring threads on neighbouring addresses of each operand
    for (int i = threadIdx.x; i < kBT * kBK; i += linear_ce::kThreads) {
      int r, k;
      if (sak == 1) {
        r = i / kBK;
        k = i % kBK;
      } else {
        k = i / kBT;
        r = i % kBT;
      }
      const int m = m0 + r, kk = k0 + k;
      as[r * kLd + k] = (m < M && kk < K) ? a[m * sam + kk * sak] : 0.f;
    }
    for (int i = threadIdx.x; i < kBV * kBK; i += linear_ce::kThreads) {
      int n, k;
      if (sbn == 1) {
        k = i / kBV;
        n = i % kBV;
      } else {
        n = i / kBK;
        k = i % kBK;
      }
      const int nn = n0 + n, kk = k0 + k;
      bs[n * kLd + k] =
          (nn < NB && kk < KB) ? b[kk * sbk + nn * sbn] : 0.f;
    }
    __syncthreads();
    slice_product(as, bs, acc, f);
    __syncthreads();
  }
  const float coef = P_EPI ? *epi.coef : 0.f;
  auto* out = static_cast<float*>(epi.out);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + frag_row<2>(f, mi, r);
        const int col = n0 + frag_col(f, ni, r);
        if (row >= M || col >= N) continue;
        float v = acc[mi][ni][r];
        if constexpr (P_EPI) {
          const long long lab = epi.labels[row];
          static_cast<float*>(epi.hi)[static_cast<long long>(row) * epi.ldp +
                                      col] =
              p_value(v, col, epi.V, epi.lse[row], lab,
                      lab >= 0 ? coef : 0.f);
        } else {
          const long long o = epi.out_vmajor
                                  ? col * epi.ldo + row
                                  : row * epi.ldo + col;
          if (epi.mode != 0) {
            float* w = epi.work + static_cast<long long>(row) * N + col;
            if (epi.mode != 1) v += *w;
            if (epi.mode != 3) {
              *w = v;
              continue;
            }
          }
          out[o] = v;
        }
      }
}

template <bool P_EPI>
cudaError_t launch_f32(const void* a, long long sam, long long sak,
                       const void* b, long long sbk, long long sbn, int M,
                       int N, int K, int KB, int NB, const Epi& epi,
                       cudaStream_t st) {
  dim3 grid((N + kBV - 1) / kBV, (M + kBT - 1) / kBT);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  ce_f32_gemm_kernel<P_EPI><<<grid, linear_ce::kThreads, 0, st>>>(
      static_cast<const float*>(a), sam, sak, static_cast<const float*>(b),
      sbk, sbn, M, N, K, KB, NB, epi);
  return cudaGetLastError();
}

}  // namespace gemm

// the f32 forward: the CUDA-core tiles, then the combine in split order
inline cudaError_t fwd_f32(const float* x, const float* head, long long sd,
                           long long sv, int head_kmajor,
                           const long long* labels, float* lse, float* pick,
                           float* part, int Tn, int D, int V,
                           int tiles_per_split, cudaStream_t st) {
  const int nvt = (V + kBV - 1) / kBV;
  const int splits = (nvt + tiles_per_split - 1) / tiles_per_split;
  dim3 grid((Tn + kBT - 1) / kBT, splits);
  ce_fwd_kernel<<<grid, kThreads, 0, st>>>(x, head, sd, sv, head_kmajor,
                                           labels, Tn, D, V,
                                           tiles_per_split, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_fwd_combine<<<(Tn + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      part, Tn, splits, lse, pick);
  return cudaGetLastError();
}

}  // namespace linear_ce
}  // namespace paddle_tpu_torch

using namespace paddle_tpu_torch::linear_ce;
namespace hopper = paddle_tpu_torch::hopper;

// The backward's launchers. dtype: 0 float32, 1 bfloat16; ``smem`` is the
// wrapper's plan of the launch's dynamic shared memory (the bf16 kernels'
// smem_bytes; 0 for f32, whose tiles are static), refused otherwise
// (cudaErrorInvalidValue), as is a bf16 operand TMA cannot read (a base
// not 16-byte aligned, a row stride not a multiple of 8 elements).
// ``head_kmajor``: 0 the untied layout (rows of D), 1 the tied one (rows
// of V). Each returns cudaError_t as int.
namespace {

bool aligned(const void* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0;
}

// the bf16 P pass's and gradients' dynamic shared memory
constexpr int kSmemP = gemm::smem_bytes<0>();
constexpr int kSmemPairA = gemm::smem_bytes<1>();
constexpr int kSmemPairB = gemm::smem_bytes<2>();

gemm::Epi no_epi() {
  gemm::Epi e{};
  return e;
}

}  // namespace

// The forward's launcher. dtype: 0 float32, 1 bfloat16; T, D and V >= 1.
// bt x bv is the wrapper's logit tile, tiles_per_split and splits its
// vocab plan and smem its dynamic shared memory: for f32 the CUDA-core
// tiles (kBT x kBV; ``splits`` runs of ``tiles_per_split`` vocab tiles;
// smem 0; x in rows of D), for bf16 the wgmma tiles (128 x 256, one vocab
// tile a split, the P pass's smem_bytes). A plan other than the kernels'
// is refused (cudaErrorInvalidValue), as is a bf16 operand TMA cannot
// read. part: [3][splits][T] f32, the stats the combine reads. Returns
// cudaError_t as int (0: both of its kernels were launched).
extern "C" int linear_ce_fwd(const void* x, long long sx, const void* head,
                             long long sh, int head_kmajor,
                             const void* labels, void* lse, void* pick,
                             void* part, int Tn, int D, int V, int bt, int bv,
                             int tiles_per_split, int splits, int smem,
                             int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto lab = static_cast<const long long*>(labels);
  auto l = static_cast<float*>(lse), p = static_cast<float*>(pick),
       w = static_cast<float*>(part);
  if (dtype == 0) {
    const int nvt = (V + kBV - 1) / kBV;
    if (bt != kBT || bv != kBV || tiles_per_split < 1 ||
        splits != (nvt + tiles_per_split - 1) / tiles_per_split ||
        smem != 0 || sx != D)
      return cudaErrorInvalidValue;
    // the head's element (d, v) at d sd + v sv
    const long long sd = head_kmajor ? 1 : sh, sv = head_kmajor ? sh : 1;
    return fwd_f32(static_cast<const float*>(x),
                   static_cast<const float*>(head), sd, sv, head_kmajor, lab,
                   l, p, w, Tn, D, V, tiles_per_split, st);
  }
  const int nvt = (V + gemm::kGBN - 1) / gemm::kGBN;
  if (bt != gemm::kGBM || bv != gemm::kGBN || tiles_per_split != 1 ||
      splits != nvt || smem != kSmemP || !aligned(x, sx) ||
      !aligned(head, sh))
    return cudaErrorInvalidValue;
  CUtensorMap xm, hm;
  bool ok = hopper::make_map(&xm, x, Tn, D, sx, gemm::kGBM);
  if (head_kmajor) {          // [V][D]: B K-major
    ok = ok && hopper::make_map(&hm, head, V, D, sh, gemm::kGBN);
  } else {                    // [D][V]: B MN-major
    ok = ok && hopper::make_map(&hm, head, D, V, sh, 64);
  }
  if (!ok) return cudaErrorInvalidValue;
  gemm::Epi epi = no_epi();
  epi.labels = lab;
  epi.V = V;
  epi.part = w;
  cudaError_t err = head_kmajor
                        ? gemm::launch_fwd<0>(xm, hm, Tn, V, D, epi, st)
                        : gemm::launch_fwd<1>(xm, hm, Tn, V, D, epi, st);
  if (err != cudaSuccess) return err;
  ce_fwd_stats_combine<<<(Tn + kCombTokens - 1) / kCombTokens,
                         kCombTokens * kCombStrands, 0, st>>>(w, Tn, nvt, l,
                                                              p);
  return cudaGetLastError();
}

// P over the ``rows`` rows of x (the chunk's first row at ``x``): p0 = hi,
// p1 = lo [rows, Vp] bf16; f32: p0 = P [rows, Vp] f32
extern "C" int linear_ce_p(const void* x, long long sx, const void* head,
                           long long sh, int head_kmajor, const void* labels,
                           const void* lse, const void* coef, void* p0,
                           void* p1, int rows, int D, int V, int Vp,
                           int smem, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  gemm::Epi epi = no_epi();
  epi.labels = static_cast<const long long*>(labels);
  epi.lse = static_cast<const float*>(lse);
  epi.coef = static_cast<const float*>(coef);
  epi.V = V;
  epi.hi = p0;
  epi.lo = p1;
  epi.ldp = Vp;
  if (dtype == 0) {
    if (smem != 0) return cudaErrorInvalidValue;
    // B(k = d, n = v)
    return head_kmajor
               ? gemm::launch_f32<true>(x, sx, 1, head, 1, sh, rows, Vp, D, D,
                                       V, epi, st)
               : gemm::launch_f32<true>(x, sx, 1, head, sh, 1, rows, Vp, D, D,
                                       V, epi, st);
  }
  if (smem != kSmemP || !aligned(x, sx) || !aligned(head, sh) ||
      !aligned(p0, Vp) || !aligned(p1, Vp))
    return cudaErrorInvalidValue;
  CUtensorMap m[4];
  bool ok = hopper::make_map(&m[0], x, rows, D, sx, gemm::kGBM);
  m[1] = m[0];
  if (head_kmajor) {          // [V][D]: B K-major
    ok = ok && hopper::make_map(&m[2], head, V, D, sh, gemm::kGBN);
  } else {                    // [D][V]: B MN-major
    ok = ok && hopper::make_map(&m[2], head, D, V, sh, 64);
  }
  m[3] = m[2];
  if (!ok) return cudaErrorInvalidValue;
  const int nm = (rows + gemm::kGBM - 1) / gemm::kGBM;
  return head_kmajor
             ? gemm::launch_gemm<0, 0, 0, true>(m, rows, Vp, D, nm, epi, st)
             : gemm::launch_gemm<0, 0, 1, true>(m, rows, Vp, D, nm, epi, st);
}

// dx [rows, D] (x's type, rows of D) = P head^T over the chunk's P
extern "C" int linear_ce_bwd_dx(const void* p0, const void* p1,
                                const void* head, long long sh,
                                int head_kmajor, void* dx, int rows, int D,
                                int V, int Vp, int smem, int dtype,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  gemm::Epi epi = no_epi();
  epi.out = dx;
  epi.ldo = D;
  if (dtype == 0) {
    if (smem != 0) return cudaErrorInvalidValue;
    // A = P [rows][Vp]; B(k = v, n = d)
    return head_kmajor
               ? gemm::launch_f32<false>(p0, Vp, 1, head, sh, 1, rows, D, Vp,
                                        V, D, epi, st)
               : gemm::launch_f32<false>(p0, Vp, 1, head, 1, sh, rows, D, Vp,
                                        V, D, epi, st);
  }
  if (smem != kSmemPairA || !aligned(head, sh) || !aligned(p0, Vp) ||
      !aligned(p1, Vp))
    return cudaErrorInvalidValue;
  CUtensorMap m[4];
  bool ok = hopper::make_map(&m[0], p0, rows, Vp, Vp, gemm::kGBM) &&
            hopper::make_map(&m[1], p1, rows, Vp, Vp, gemm::kGBM);
  if (head_kmajor) {          // [V][D]: B(k = v, n = d) MN-major
    ok = ok && hopper::make_map(&m[2], head, V, D, sh, 64);
  } else {                    // [D][V]: K-major
    ok = ok && hopper::make_map(&m[2], head, D, V, sh, gemm::kGBN);
  }
  m[3] = m[2];
  if (!ok) return cudaErrorInvalidValue;
  return head_kmajor
             ? gemm::launch_gemm<1, 0, 1, false>(m, rows, D, Vp, 8, epi, st)
             : gemm::launch_gemm<1, 0, 0, false>(m, rows, D, Vp, 8, epi, st);
}

// dh from the chunk's P and x: out_vmajor 0: dh [D, V] (row stride ldo);
// 1: dh^T [V, D] (row stride ldo). ``work``: the f32 sum [M, N] across
// chunks for ``mode`` 1-3 (see the file's header), unused for mode 0.
extern "C" int linear_ce_bwd_dh(const void* x, long long sx, const void* p0,
                                const void* p1, void* dh, long long ldo,
                                int out_vmajor, void* work, int mode,
                                int rows, int D, int V, int Vp, int smem,
                                int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (mode < 0 || mode > 3 || (mode != 0 && work == nullptr))
    return cudaErrorInvalidValue;
  gemm::Epi epi = no_epi();
  epi.out = dh;
  epi.ldo = ldo;
  epi.out_vmajor = out_vmajor;
  epi.work = static_cast<float*>(work);
  epi.mode = mode;
  if (dtype == 0) {
    if (smem != 0) return cudaErrorInvalidValue;
    // A(m = d, k = t) = x[t sx + d], B(k = t, n = v) = P[t Vp + v]
    return gemm::launch_f32<false>(x, 1, sx, p0, Vp, 1, D, V, rows, rows, V,
                                  epi, st);
  }
  if (smem != (out_vmajor ? kSmemPairA : kSmemPairB) || !aligned(x, sx) ||
      !aligned(p0, Vp) || !aligned(p1, Vp))
    return cudaErrorInvalidValue;
  CUtensorMap m[4];
  CUtensorMap xm, hi, lo;
  // MN-major boxes: 64 columns x the stage's depth
  const int bk = out_vmajor ? gemm::depth<1>() : gemm::depth<2>();
  bool ok = hopper::make_map(&xm, x, rows, D, sx, bk) &&
            hopper::make_map(&hi, p0, rows, Vp, Vp, bk) &&
            hopper::make_map(&lo, p1, rows, Vp, Vp, bk);
  if (!ok) return cudaErrorInvalidValue;
  if (out_vmajor) {           // dh^T = P^T x: A = hi, lo; B = x
    m[0] = hi;
    m[1] = lo;
    m[2] = m[3] = xm;
    return gemm::launch_gemm<1, 1, 1, false>(m, V, D, rows, 8, epi, st);
  }
  m[0] = m[1] = xm;           // dh = x^T P: A = x; B = hi, lo
  m[2] = hi;
  m[3] = lo;
  return gemm::launch_gemm<2, 1, 1, false>(m, D, V, rows, 32, epi, st);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
