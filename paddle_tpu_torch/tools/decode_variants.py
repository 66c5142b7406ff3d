#!/usr/bin/env python3
"""The single-launch decode kernel's weight stream, measured alone, and its
weight-ring body beside the designs tried, on one GPU.

    python3 paddle_tpu_torch/tools/decode_variants.py [--stages 1 2 4]
        [--cols 64 128 256] [--variants committed nomma ...]
        [--wbits 0 8 4]

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit. decode_block_fused reads ~404 MB of weights a layer at
LLaMA-7B widths in bf16 (q/k/v, o_proj, gate/up, down) for 8 rows of
activations: its time is the time of that stream. This tool builds a
stream-only kernel (:data:`STREAM_SOURCE`, into a temporary directory):
the loads and addressing of the kernel's weight ring
(``csrc/weight_ring.cuh``), with no product at all.
Each block of one cooperative grid (one block an SM, 256 threads) walks
the same items the kernel's plan gives it (``fused_decode_block.
ring_plan``: column tiles of ``cols`` columns a weight row, K split into
parts so the items fill the grid; slot-major, then part, then column
tile), chunk by chunk (16 KB of bf16 a chunk: 16384 / (2 cols) rows of
k), through a ring of
``stages`` chunks in shared memory, filled by 16-byte ``cp.async.cg``
copies of all threads with ``stages - 1`` chunks in flight; the next
phase's first chunks are issued before each grid-wide barrier, as in the
kernel. One stage is a load, a wait and a barrier per chunk.

For each (stages, cols) it prints the device time of the four phases'
stream (``chip_smoke.cold_ms``: L2 flushed before every launch) and its
rate in TB/s, beside the card's name and power limit; the bytes are the
weights' (each read once).

Then the committed body itself (``--variants``): each variant is the
committed sources with a few lines replaced (:data:`PATCHES`), built into
a temporary directory with block 0 stamping the global timer after each
grid barrier (``cuda_phase_times.stamped``) and loaded in place of the
built library, so the wrapper runs it unchanged (with its plan constants
set to the variant's): ``committed``; ``nomma``, the same copies and
barriers with no product, and over codes no conversion either (the
body's own stream; its errors are meaningless); ``stages2`` and
``stages6``, two and six chunks in the ring (six do not fit beside the
attention's two items: the card refuses it, and the row says so);
``teams1`` and ``teams4``, the single-launch ring's attention phase with
the whole block on one item at a time, or four teams of two warps on an
item each (kRingTeams; four items' scratch fits beside the ring over int8
pools only: over bf16 pools the wrapper refuses it, and the row says so);
``attn_teams2``, decode_attn_block's ring with two teams of four warps
(kAttnRingTeams; committed: four of two);
``noconv``, the codes handed to the tensor cores unconverted (the
conversion's cost; its errors are meaningless; the code classes only).
For each weight class of
``--wbits`` (bf16, int8 and int4 codes of the same weights, the port's
PTQ harness): decode_block_fused at LLaMA-7B widths, 8 rows, bf16 (its
worst error against ``decode_block_ref`` in units of chip_smoke.py's
two-ulp bound, ``bf16_close``: 1 is the limit),
its time and its stamped phases at chip_smoke.py's kernel-phase lengths
and at serving-like ones (300-520 tokens); and decode_attn_block's ring
body on the same weights over int8 pools (the only pools it is built
for; taken in every class, ``attn_body_ab.ring_taken``, whatever the
rule says), beside its CUDA-core body (the row ``cuda_core``; its error
against ``attn_block_wq_ref`` in the same units, its time and its stamped
phases at both sets of lengths).

One JSON object per line; the last is ``{"ok": true}``. It imports
nothing of JAX or of ``paddle_tpu``.
"""
import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

STREAM_SOURCE = r'''
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace cg = cooperative_groups;

// one phase: NMAT weights of [K][row_bytes], column tiles of tile_bytes,
// K in parts of part_rows rows (a multiple of kc), chunks of kc rows
struct Phase {
  const unsigned char* w[3];
  int nmat, K, row_bytes, tile_bytes, parts, part_rows;
};
struct Args {
  Phase ph[4];
  int nph, kc;
  unsigned* sink;
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

// a block's place in its chunks: phase p, its j-th item there, chunk c;
// stepped one chunk at a time (no division a chunk)
struct Cur { int p, j, c; };

__device__ __forceinline__ int mine_of(const Args& a, int p) {
  const Phase& f = a.ph[p];
  const int items = f.row_bytes / f.tile_bytes * f.parts * f.nmat;
  return items > (int)blockIdx.x
             ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
}

__device__ __forceinline__ void settle(const Args& a, Cur& q) {
  while (q.p < a.nph && q.j >= mine_of(a, q.p)) { ++q.p; q.j = 0; }
}

__device__ __forceinline__ void step(const Args& a, Cur& q) {
  if (++q.c < a.ph[q.p].part_rows / a.kc) return;
  q.c = 0;
  ++q.j;
  settle(a, q);
}

__device__ void issue(const Args& a, const Cur& q, unsigned char* st) {
  const Phase& f = a.ph[q.p];
  const int tiles = f.row_bytes / f.tile_bytes;
  const int item = (int)blockIdx.x + q.j * (int)gridDim.x;
  // slot-major, then part, then column tile (the ring's ring_item)
  const int m = item / (tiles * f.parts), j = item % (tiles * f.parts);
  const int part = j / tiles, t = j % tiles;
  const int k0 = part * f.part_rows + q.c * a.kc;
  const int segs = f.tile_bytes / 16;
  const int s = threadIdx.x % segs;
  for (int r = threadIdx.x / segs; r < a.kc; r += blockDim.x / segs) {
    const bool ok = k0 + r < f.K;
    cp16(st + (size_t)r * f.tile_bytes + s * 16,
         f.w[m] + (ok ? (size_t)(k0 + r) * f.row_bytes +
                            (size_t)t * f.tile_bytes + s * 16 : 0), ok);
  }
}

template <int S>
__global__ void __launch_bounds__(256, 1) stream_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int stage = a.kc * a.ph[0].tile_bytes;
  unsigned acc = 0;
  Cur q{0, 0, 0};   // the next chunk to issue
  settle(a, q);
  int issued = 0, used = 0;
  for (int i = 0; S > 1 && i < S - 1; ++i) {
    if (q.p < a.nph) {
      issue(a, q, smem + (size_t)(issued++ % S) * stage);
      step(a, q);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // every block meets every phase's barrier, items of it or none
  for (int p = 0; p < a.nph; ++p) {
    if (p > 0) grid.sync();
    const int n = mine_of(a, p) * (a.ph[p].part_rows / a.kc);
    for (int i = 0; i < n; ++i) {
      if (S == 1) {
        issue(a, q, smem);
        step(a, q);
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();
      } else {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(S > 1 ? S - 2 : 0));
        __syncthreads();   // chunk ``used`` landed; the one before read
        if (q.p < a.nph) {
          issue(a, q, smem + (size_t)(issued++ % S) * stage);
          step(a, q);
        }
        asm volatile("cp.async.commit_group;\n" ::);
      }
      acc ^= reinterpret_cast<const unsigned*>(
          smem + (size_t)(used++ % S) * stage)[threadIdx.x];
      if (S == 1) __syncthreads();
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  if (acc == 0x9e3779b9u) a.sink[0] = acc;
}

extern "C" int stream_launch(const Args* a, int stages, int smem) {
  void* k = stages == 1 ? (void*)stream_kernel<1>
          : stages == 2 ? (void*)stream_kernel<2>
          : stages == 4 ? (void*)stream_kernel<4>
          : stages == 6 ? (void*)stream_kernel<6> : nullptr;
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  void* params[] = {const_cast<Args*>(a)};
  e = cudaLaunchCooperativeKernel(k, dim3(sms), dim3(256), params, smem, 0);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
'''

#: bytes of one ring chunk (kc rows of one column tile)
CHUNK_BYTES = 16384


class _Phase(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p * 3), ("nmat", ctypes.c_int),
                ("K", ctypes.c_int), ("row_bytes", ctypes.c_int),
                ("tile_bytes", ctypes.c_int), ("parts", ctypes.c_int),
                ("part_rows", ctypes.c_int)]


class _Args(ctypes.Structure):
    _fields_ = [("ph", _Phase * 4), ("nph", ctypes.c_int),
                ("kc", ctypes.c_int), ("sink", ctypes.c_void_p)]


def parts_for(tiles, chunks, grid):
    """The parts K's ``chunks`` chunks split into for ``tiles`` column
    tiles on ``grid`` blocks: the fewest chunks for the busiest block
    (``fused_decode_block.ring_parts``)."""
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    return fdb.ring_parts(tiles, chunks, grid)


def stream_args(ws, cols, grid, sink):
    """The four phases of the weights ``ws`` (q, k, v, o, g, u, d) at
    ``cols`` bf16 columns a tile."""
    tile = cols * 2
    kc = CHUNK_BYTES // tile
    a = _Args()
    groups = ((ws[0:3], ws[0].shape[0], ws[0].shape[1]),
              (ws[3:4], ws[3].shape[0], ws[3].shape[1]),
              (ws[4:6], ws[4].shape[0], ws[4].shape[1]),
              (ws[6:7], ws[6].shape[0], ws[6].shape[1]))
    for i, (mats, K, N) in enumerate(groups):
        tiles = N * 2 // tile
        chunks = -(-K // kc)
        parts = parts_for(tiles * len(mats), chunks, grid)
        f = a.ph[i]
        for j, m in enumerate(mats):
            f.w[j] = m.data_ptr()
        f.nmat, f.K, f.row_bytes, f.tile_bytes = len(mats), K, N * 2, tile
        f.parts, f.part_rows = parts, -(-chunks // parts) * kc
    a.nph, a.kc, a.sink = 4, kc, sink.data_ptr()
    return a


def _set(name, old, new):
    return ("weight_ring.cuh", f"constexpr int {name} = {old};",
            f"constexpr int {name} = {new};")


#: variant -> ((file in csrc/, old, new) replacements, the wrapper's module
#: constants it runs with)
PATCHES = {
    "committed": ((), {}),
    "nomma": ((("weight_ring.cuh", "      if (k0 < f.kn) {   // block-uniform",
                "      if (false) {   // block-uniform"),), {}),
    "stages2": ((_set("kRingStages", 4, 2),), {"RING_STAGES": 2}),
    "stages6": ((_set("kRingStages", 4, 6),), {"RING_STAGES": 6}),
    "teams1": ((("fused_decode_block.cu",
                 "constexpr int kRingTeams = 2;",
                 "constexpr int kRingTeams = 1;"),), {"RING_TEAMS": 1}),
    "teams4": ((("fused_decode_block.cu",
                 "constexpr int kRingTeams = 2;",
                 "constexpr int kRingTeams = 4;"),), {"RING_TEAMS": 4}),
    "attn_teams2": ((("fused_decode_block.cu",
                      "constexpr int kAttnRingTeams = 4;",
                      "constexpr int kAttnRingTeams = 2;"),),
                    {"ATTN_RING_TEAMS": 2}),
    "noconv": ((("weight_ring.cuh",
                 "{s8x2_bf16(r0, 0, 2), s8x2_bf16(r0, 1, 3),\n" + " " * 32
                 + "s8x2_bf16(r1, 0, 2), s8x2_bf16(r1, 1, 3)}",
                 "{r0, r0 >> 8, r1, r1 >> 8}"),
                ("weight_ring.cuh",
                 "{s4x2_bf16(r0, 0), s4x2_bf16(r0, 8),\n" + " " * 32
                 + "s4x2_bf16(r1, 0), s4x2_bf16(r1, 8)}",
                 "{r0, r0 >> 8, r1, r1 >> 8}"),
                ("weight_ring.cuh",
                 "{s4x2_bf16(r0, 4), s4x2_bf16(r0, 12),\n" + " " * 32
                 + "s4x2_bf16(r1, 4), s4x2_bf16(r1, 12)}",
                 "{r0 >> 4, r0 >> 12, r1 >> 4, r1 >> 12}")), {}),
}
#: variants that differ from the committed body only over codes
CODES_ONLY = ("noconv",)


def body_variants(names, gpu, work, wbits=(0,)):
    """The committed body and its variants (the module header), for each
    weight class of ``wbits``."""
    import torch
    sys.path.insert(0, str(ROOT / "paddle_tpu_torch" / "tools"))
    import cuda_phase_times as pt
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    from paddle_tpu_torch.ops.rope import build_rope_cache
    procs = {}
    for name in names:
        src = work / name
        shutil.copytree(_build.CSRC, src)
        for f, old, new in PATCHES[name][0]:
            text = (src / f).read_text()
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in {f}")
            (src / f).write_text(text.replace(old, new))
        cu = src / "fused_decode_block.cu"
        cu.write_text(pt.stamped(cu.read_text()))
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
             str(src / "libfused_decode_block.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        (work / name / "lib.log").write_text(log)
        libs[name] = ctypes.CDLL(str(work / name /
                                     "libfused_decode_block.so"))
        cs.emit({"phase": "build", "variant": name, "gpu": gpu,
                 "ptxas": {k: v for k, v in
                           cs._ptxas(work / name / "lib.log").items()
                           if "ring" in k}})
    gen = torch.Generator(device="cuda").manual_seed(6)
    rope = build_rope_cache(4096, cs.HD7, device="cuda")
    fp = list(cs.block_inputs(gen, torch.bfloat16, cs.H7, cs.F7, rope,
                              cs.B8))
    # chip_smoke's kernel-phase lengths, and serving-like ones
    serving = torch.randint(300, 520, (cs.B8,), generator=gen,
                            device="cuda").to(torch.int32)
    default = {k: getattr(fdb, k) for _, consts in PATCHES.values()
               for k in consts}
    for bits in wbits:
        args = pt.quantized(fp, bits)
        refs = list(args)
        refs[12], refs[13] = args[12].clone(), args[13].clone()
        want = fdb.decode_block_ref(*refs)[0]
        lengths = {"kernel_phase_lengths": args[15],
                   "serving_lengths": serving}
        run_variants([n for n in names if bits or n not in CODES_ONLY],
                     libs, gpu, args, want, lengths, bits, default)
        attn_variants(["cuda_core"] * ("committed" in names)
                      + [n for n in names if n not in CODES_ONLY], libs,
                      gpu, args, lengths, bits, default)
    fdb.block_spec.cache_clear()
    fdb.attn_spec.cache_clear()
    fdb._block_setup.cache_clear()
    fdb._attn_setup.cache_clear()


#: decode_attn_block's stamped phases (its ring body's and its CUDA-core
#: body's barriers)
ATTN_PHASES = ("qkv", "pages", "combine", "o_proj")


def attn_variants(names, libs, gpu, block_args, lengths, bits, default):
    """decode_attn_block's rows of one weight class over int8 pools: each
    variant's worst error against attn_block_wq_ref (two-ulp units), its
    time and its stamped phases at both sets of lengths."""
    sys.path.insert(0, str(ROOT / "paddle_tpu_torch" / "tools"))
    import cuda_phase_times as pt
    from attn_body_ab import ring_taken
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    a = list(block_args[:6]) + list(block_args[10:])
    kw = {}
    a[8], a[9], kw["kv_scales"], _, _ = cs.kv8_pools(a[8], a[9])
    ref = list(a)
    ref[8], ref[9] = a[8].clone(), a[9].clone()
    want = fdb.attn_block_wq_ref(*ref, **kw)[0]
    for name in names:
        # "cuda_core": the committed sources on the CUDA-core body; every
        # other variant on the ring body
        lib = libs["committed" if name == "cuda_core" else name]
        pt.use(fdb, lib)
        fdb.attn_spec.cache_clear()
        fdb._attn_setup.cache_clear()
        for k, v in dict(default, **PATCHES.get(name, ((), {}))[1]).items():
            setattr(fdb, k, v)
        row = {"phase": "attn_variant", "variant": name, "wbits": bits,
               "pools": "int8", "gpu": gpu}
        body = cs.cuda_core_block(fdb) if name == "cuda_core" \
            else ring_taken(fdb)
        try:
            with body:
                for label, lens in lengths.items():
                    a[11] = lens

                    def run(a=list(a)):
                        return fdb.decode_attn_block_cuda(*a, **kw)
                    if label == "kernel_phase_lengths":
                        row["body"] = cs.launch_plan(run)["body"]
                        row["err_units"] = cs.bf16_close(
                            run()[0], want)[1] / 2 ** -6
                    times = pt.phases(fdb, lib, run)
                    row[label] = {"ms": cs.cold_ms(run, iters=30),
                                  "phases_us": dict(zip(ATTN_PHASES, times))
                                  if len(times) == 4 else times}
        except (RuntimeError, ValueError) as e:   # one the card refuses
            row["error"] = str(e)[:300]
        cs.emit(row)
    for k, v in default.items():
        setattr(fdb, k, v)


def run_variants(names, libs, gpu, args, want, lengths, bits, default):
    """body_variants' rows of one weight class."""
    sys.path.insert(0, str(ROOT / "paddle_tpu_torch" / "tools"))
    import cuda_phase_times as pt
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    for name in names:
        pt.use(fdb, libs[name])
        fdb.block_spec.cache_clear()
        fdb._block_setup.cache_clear()
        for k, v in dict(default, **PATCHES[name][1]).items():
            setattr(fdb, k, v)
        row = {"phase": "variant", "variant": name, "wbits": bits,
               "gpu": gpu}
        try:
            for label, lens in lengths.items():
                a = args[:15] + [lens]

                def run(a=a):
                    return fdb.decode_block_fused_cuda(*a)
                if label == "kernel_phase_lengths":
                    row["err_units"] = cs.bf16_close(
                        run()[0], want)[1] / 2 ** -6
                row[label] = {"ms": cs.cold_ms(run, iters=30),
                              "phases_us": pt.block_phases(
                                  fdb, pt.phases(fdb, libs[name], run),
                                  bits=bits)}
        except (RuntimeError, ValueError) as e:   # one the card refuses
            row["error"] = str(e)[:300]
        cs.emit(row)
    for k, v in default.items():
        setattr(fdb, k, v)


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--cols", type=int, nargs="+", default=[64, 128, 256])
    ap.add_argument("--variants", nargs="*", default=list(PATCHES))
    ap.add_argument("--wbits", type=int, nargs="+", default=[0, 8, 4],
                    choices=(0, 8, 4))
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops.kernels import _build
    gpu = cs.gpu_line()
    work = Path(tempfile.mkdtemp(prefix="decode_variants_"))
    try:
        cu = work / "stream.cu"
        cu.write_text(STREAM_SOURCE)
        so = work / "libstream.so"
        log = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            capture_output=True, text=True)
        if log.returncode:
            raise RuntimeError(f"nvcc failed:\n{log.stdout}{log.stderr}")
        (work / "libstream.log").write_text(log.stdout + log.stderr)
        cs.emit({"phase": "build", "gpu": gpu,
                 "ptxas": cs._ptxas(work / "libstream.log")})
        lib = ctypes.CDLL(str(so))
        lib.stream_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int]
        lib.stream_launch.restype = ctypes.c_int
        gen = torch.Generator(device="cuda").manual_seed(9)
        D, F = cs.D7, cs.F7
        shapes = ((D, D), (D, D), (D, D), (D, D), (D, F), (D, F), (F, D))
        ws = [torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
              for s in shapes]
        nbytes = sum(w.numel() * 2 for w in ws)
        sink = torch.zeros(4, dtype=torch.int32, device="cuda")
        grid = torch.cuda.get_device_properties(0).multi_processor_count
        for cols in opts.cols:
            a = stream_args(ws, cols, grid, sink)
            for stages in opts.stages:
                smem = stages * CHUNK_BYTES

                def run(a=a, stages=stages, smem=smem):
                    err = lib.stream_launch(ctypes.byref(a), stages, smem)
                    if err:
                        raise RuntimeError(f"stream launch failed: {err}")
                ms = cs.cold_ms(run, iters=20)
                cs.emit({"phase": "stream", "gpu": gpu, "stages": stages,
                         "cols": cols, "row_bytes_a_run": cols * 2,
                         "chunk_rows": a.kc,
                         "parts": [a.ph[i].parts for i in range(4)],
                         "ms": ms, "bytes": nbytes,
                         "tb_per_s": nbytes / ms / 1e9})
        del ws
        torch.cuda.empty_cache()
        if opts.variants:
            body_variants(opts.variants, gpu, work, opts.wbits)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
