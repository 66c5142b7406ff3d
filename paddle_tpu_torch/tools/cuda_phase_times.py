#!/usr/bin/env python3
"""Per-phase device times of the PyTorch/CUDA port's fused decode and
prefill kernels on one GPU.

    python3 paddle_tpu_torch/tools/cuda_phase_times.py [--part decode|prefill|all]
        [--wbits 0 8 4] [--pools fp int8]

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit. It builds copies of ``paddle_tpu_torch/csrc/
fused_decode_block.cu`` into a temporary directory: one with block 0
stamping ``%globaltimer`` at the start of each kernel and after each
grid-wide barrier, for the single-launch kernel under
``__launch_bounds__(256, 1)`` (as committed) and ``(256, 2)``, and one
unstamped copy under each bound. For each copy it prints ptxas's
registers and spills per bf16 kernel, and then, at LLaMA-7B widths, 8
slots, bf16, at two sets of lengths (chip_smoke.py's kernel-phase
lengths, and serving-like lengths of 300-520 tokens):

- for each weight class of ``--wbits`` (bf16, int8 and int4 codes, made
  by the port's PTQ harness from the same bf16 weights), the time of
  decode_block_fused and of decode_attn_block followed by
  decode_mlp_block on the same inputs (chip_smoke.py's ``cold_ms``);
- the stamped phases, microseconds: decode_attn_block (qkv, pages,
  combine, o_proj), decode_mlp_block (gate/up, down) and
  decode_block_fused (all six: qkv, pages, combine, o_proj, gate/up,
  down), each with the body it ran: the body the wrapper picks at 8 bf16
  rows (the weight ring, ``csrc/weight_ring.cuh``, in a tree whose
  kernels have one: decode_block_fused and decode_mlp_block; over bf16
  pools decode_attn_block keeps its CUDA-core body) and, where the tree
  has a ring, the CUDA-core bodies too (``chip_smoke.cuda_core_block``),
  which are also timed (the block alone and the pair); in a tree whose
  decode_attn_block has a ring body (over int8 pools only), its phases
  over int8 pools made from the same pools on the ring
  (``attn_body_ab.ring_taken``: in every class) and on the CUDA-core
  body. The stamps add a barrier at the end of each kernel and change
  register allocation: compare phases with phases, not with the
  unstamped times.

The prefill part (``--part prefill``) builds an unstamped and a stamped
copy of ``fused_prefill_block.cu`` and of ``fused_decode_block.cu`` (every
cooperative kernel of each stamped) and, at LLaMA-7B widths in bf16,
times prefill_attn_block at P 128 (all rows real) with pos0 0, 512 and
896 (a history of that many pool positions of 1152), over the pools of
``--pools`` (bf16, and int8 codes of the same pools with their per-head
scales: the int8-pool attention on the tensor cores) and for each weight
class of ``--wbits``, and decode_mlp_block
at 16, 20, 32 and 128 rows (the prefill MLP's chunk rows): each with its
stamped phases, labelled by the kernel body's barriers (the CUDA-core
bodies: products with their RMSNorm inside, RoPE, attention, o_proj;
gate/up, down; a body with a phase of its own for the RMSNorm lists it
first, and one that splits o_proj's or down's K adds their combine).
Where the wrappers choose a body by a row threshold
(``fused_decode_block.MLP_TC_MIN_ROWS``), each row count is timed under
both bodies: the crossover.

The copies keep the launchers' ``extern "C"`` signatures, and the
wrappers run on them unchanged: :func:`use` loads a copy in place of the
built library, and ``_build.c_fn`` binds each launcher with the
wrappers' argument codes (the codes the gate's ARG_MISMATCH rule holds
against the source), with the wrapper's own plan and its copy's
cooperative grid (the grid cache is emptied, so each copy's occupancy
query answers for its own launch bounds).

One JSON object per line; the last is ``{"ok": true}``. It imports
nothing of JAX or of ``paddle_tpu``.
"""
import argparse
import contextlib
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: the launchers the copies are driven through
LAUNCHERS = ("decode_attn_block", "decode_mlp_block", "decode_block_fused")
STAMP = ('\n  if (blockIdx.x == 0 && threadIdx.x == 0 && g_n < 64) {'
         ' unsigned long long t;'
         ' asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));'
         ' g_stamps[g_n++] = t; }\n')
READ = '''
extern "C" int read_stamps(unsigned long long* out) {
  using namespace paddle_tpu_torch::fused;
  int n = 0, z = 0;
  cudaMemcpyFromSymbol(&n, g_n, sizeof(int));
  cudaMemcpyFromSymbol(out, g_stamps, sizeof(unsigned long long) * 64);
  cudaMemcpyToSymbol(g_n, &z, sizeof(int));
  return n;
}
'''


#: a cooperative kernel's head: ``<name>_kernel(const <Args> a) {``
KERNEL_HEAD = re.compile(r"\b(\w+_kernel)\(const (\w+) a\) \{")


def stamped(src):
    """``src`` with block 0 stamping the global timer at the start of each
    cooperative kernel (a body that takes ``cg::this_grid()``), after each
    grid sync, and after a final grid sync."""
    decl = ("__device__ unsigned long long g_stamps[64];\n"
            "__device__ int g_n;\n")
    at = src.index("namespace fused {\n") + len("namespace fused {\n")
    out = src[:at] + decl + src[at:]
    pos = 0
    while True:
        m = KERNEL_HEAD.search(out, pos)
        if m is None:
            break
        j = out.index("\n}\n", m.end())
        body = out[m.start():j]
        if "cg::this_grid();" not in body:
            pos = j
            continue
        body = body.replace("cg::this_grid();", "cg::this_grid();" + STAMP)
        body = body.replace("grid.sync();", "grid.sync();" + STAMP)
        body += "\n  grid.sync();" + STAMP
        out = out[:m.start()] + body + out[j:]
        pos = m.start() + len(body)
    return out + READ


def variants(src):
    one = "__launch_bounds__(kThreads, 1)\ndecode_block_fused_kernel"
    two = "__launch_bounds__(kThreads, 2)\ndecode_block_fused_kernel"
    if one not in src:
        raise RuntimeError("decode_block_fused_kernel is not under "
                           "__launch_bounds__(kThreads, 1)")
    lb2 = src.replace(one, two)
    return {"lb1": src, "lb2": lb2, "lb1_stamped": stamped(src),
            "lb2_stamped": stamped(lb2)}


def prefill_variants(prefill_src, decode_src):
    """The prefill part's copies: each source unstamped and stamped."""
    return {"prefill": prefill_src, "prefill_stamped": stamped(prefill_src),
            "decode": decode_src, "decode_stamped": stamped(decode_src)}


def build(work, srcs):
    """nvcc of every copy, all started together; ptxas's report of each
    bf16 kernel by copy."""
    from paddle_tpu_torch.ops.kernels import _build
    procs = {}
    for name, text in srcs.items():
        cu = work / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
               str(_build.CSRC), "-o", str(work / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        (work / f"lib{name}.log").write_text(log)
        ptxas[name] = {k: v for k, v in
                       cs._ptxas(work / f"lib{name}.log").items()
                       if "nv_bfloat16" in k}
        libs[name] = ctypes.CDLL(str(work / f"lib{name}.so"))
    return libs, ptxas


def use(fdb, lib, source="fused_decode_block"):
    """Run the wrappers of ``fdb`` (``ops.kernels.fused_decode_block``, or
    of the prefill module with ``source`` "fused_prefill_block") on
    ``lib``'s launchers: ``lib`` takes the built library's place in
    ``_build``, whose ``c_fn`` binds each launcher at its next call with
    the codes of the wrapper's launch spec, and the cooperative grids are
    asked of ``lib`` anew."""
    _build = fdb._build
    _build._LIBS[source] = lib
    for key in [k for k in _build._FNS if k[0] == source]:
        del _build._FNS[key]
    (getattr(fdb, "_fdb", None) or fdb)._GRIDS.clear()


def phases(fdb, lib, fn, reps=6):
    """Block 0's stamped phases of one launch of ``fn``, microseconds,
    L2 flushed before; the median launch of ``reps``."""
    import numpy as np
    import torch
    buf = (ctypes.c_ulonglong * 64)()
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    lib.read_stamps.restype = ctypes.c_int
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    runs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda.synchronize()
        lib.read_stamps(buf)
        fn()
        torch.cuda.synchronize()
        n = lib.read_stamps(buf)
        runs.append([(buf[j + 1] - buf[j]) / 1e3 for j in range(n - 1)])
    return [round(float(v), 1) for v in np.median(np.array(runs), axis=0)]


#: the prefill part's shapes: chunk rows, history lengths, MLP rows
PREFILL_P = 128
PREFILL_POS0 = (0, 512, 896)
MLP_ROWS = (16, 20, 32, 128)
#: the phases of each body, by the number of stamped intervals
PHASE_NAMES = {
    "prefill_attn_block": {4: ("qkv_with_norm", "rope", "attention",
                               "o_proj"),
                           5: ("norm", "qkv", "rope", "attention",
                               "o_proj"),
                           6: ("norm", "qkv", "rope", "attention",
                               "o_proj", "combine")},
    "decode_mlp_block": {2: ("gate_up_with_norm", "down"),
                         3: ("norm", "gate_up", "down"),
                         4: ("norm", "gate_up", "down", "combine")},
}


def named(kernel, times):
    """Stamped intervals under their phase names (a list where the count
    is not one the table knows)."""
    names = PHASE_NAMES[kernel].get(len(times))
    return dict(zip(names, times)) if names else times


def quantized(args, bits):
    """decode_block_fused's arguments with the weights as int8 or int4
    leaves of the port's PTQ harness (down_proj packed along its output
    axis), or as they are for ``bits`` 0."""
    if not bits:
        return list(args)
    return [*args[:2], *cs.wq_leaves(args[2:6], bits), args[6],
            *cs.wq_leaves(args[7:10], bits, down=args[9]), *args[10:]]


def decode_part(fdb, libs, gpu, wbits=(0,)):
    """The fused decode kernels at 8 slots (the part's header above)."""
    import torch
    from paddle_tpu_torch.ops.rope import build_rope_cache
    gen = torch.Generator(device="cuda").manual_seed(6)
    rope = build_rope_cache(4096, cs.HD7, device="cuda")
    fp = list(cs.block_inputs(gen, torch.bfloat16, cs.H7, cs.F7, rope,
                              cs.B8))
    serving = torch.randint(300, 520, (cs.B8,), generator=gen,
                            device="cuda").to(torch.int32)
    for bits in wbits:
        args = quantized(fp, bits)
        decode_lengths(fdb, libs, gpu, args, bits, serving)


def decode_lengths(fdb, libs, gpu, args, bits, serving):
    """decode_part's rows of one weight class, at both sets of lengths."""
    ring_attn = hasattr(fdb, "attn_ring_pays")
    if ring_attn:
        from attn_body_ab import ring_taken
        kq, vq, scales, _, _ = cs.kv8_pools(args[12], args[13])
    for label, lens in (("kernel_phase_lengths", args[15]),
                        ("serving_lengths", serving)):
        args[15] = lens
        x, nw, wq, wk, wv, wo, pw, wg, wu, wd = args[:10]
        attn = (x, nw, wq, wk, wv, wo, *args[10:])

        def block():
            return fdb.decode_block_fused_cuda(*args)

        def pair():
            xo = fdb.decode_attn_block_cuda(*attn)[0]
            return fdb.decode_mlp_block_cuda(xo, pw, wg, wu, wd)
        row = {"phase": "times", "gpu": gpu, "lengths": label,
               "wbits": bits, "seq_lens": lens.tolist()}
        ring = hasattr(fdb, "RING_MAX_ROWS")
        for name in ("lb1", "lb2"):
            use(fdb, libs[name])
            row[f"{name}_block_ms"] = cs.cold_ms(block, iters=40)
            row[f"{name}_pair_ms"] = cs.cold_ms(pair, iters=40)
            if ring:
                with cs.cuda_core_block(fdb):
                    row[f"{name}_block_cuda_core_ms"] = cs.cold_ms(
                        block, iters=40)
                    row[f"{name}_pair_cuda_core_ms"] = cs.cold_ms(
                        pair, iters=40)
        for name in ("lb1_stamped", "lb2_stamped"):
            use(fdb, libs[name])
            row[name] = stamped_kernels(fdb, libs[name], block, attn,
                                        (x, pw, wg, wu, wd), bits)
            if ring_attn:
                kv8 = (*attn[:8], kq, vq, *attn[10:])

                def attn_kv8(a=kv8):
                    return fdb.decode_attn_block_cuda(*a, kv_scales=scales)
                for body, ctx in (("ring", ring_taken),
                                  ("cuda_core", cs.cuda_core_block)):
                    with ctx(fdb):
                        times = phases(fdb, libs[name], attn_kv8)
                    row[name][f"decode_attn_block_kv8_{body}"] = dict(
                        zip(TWO_STAGE_PHASES["decode_attn_block"], times))
            if ring:
                with cs.cuda_core_block(fdb):
                    core = stamped_kernels(fdb, libs[name], block, attn,
                                           (x, pw, wg, wu, wd), bits)
                row[name].update({f"{k}_cuda_core": v
                                  for k, v in core.items()})
        cs.emit(row)


#: the two-stage kernels' stamped phases (either body: the weight ring runs
#: its RMSNorm inside q/k/v and gate/up, as the CUDA-core body does)
TWO_STAGE_PHASES = {"decode_attn_block": ("qkv", "pages", "combine",
                                          "o_proj"),
                    "decode_mlp_block": ("gate_up", "down")}


def stamped_kernels(fdb, lib, block, attn, mlp, bits):
    """The three fused decode kernels' stamped phases at 8 rows, each with
    the body its plan ran (the tree's own rule, or the CUDA-core bodies
    under ``chip_smoke.cuda_core_block``)."""
    out = {}
    for kernel, fn in (
            ("decode_attn_block", lambda: fdb.decode_attn_block_cuda(*attn)),
            ("decode_mlp_block", lambda: fdb.decode_mlp_block_cuda(*mlp))):
        times = phases(fdb, lib, fn)
        names = TWO_STAGE_PHASES[kernel]
        out[kernel] = {"body": cs.launch_plan(fn).get("body", "cuda_core"),
                       "phases_us": (dict(zip(names, times))
                                     if len(times) == len(names) else times)}
    out["decode_block_fused"] = block_phases(
        fdb, phases(fdb, lib, block),
        cs.launch_plan(block).get("body", "cuda_core"), bits)
    return out


#: decode_block_fused's stamped phases by body: the weight ring's norm runs
#: inside q/k/v and gate/up; the CUDA-core body's in each product
BLOCK_PHASES = ("qkv", "pages", "combine", "o_proj", "gate_up", "down")


def block_phases(fdb, times, body=None, bits=0):
    """decode_block_fused's stamped intervals under their phase names, with
    the body they ran (the wrapper's rule at 8 bf16 rows in weight class
    ``bits``, or ``body``)."""
    if body is None:
        body = (fdb.block_body(8, cs.D7, cs.H7, cs.H7, cs.HD7, cs.F7,
                               "bfloat16", bits)[0]
                if hasattr(fdb, "block_body") else "cuda_core")
    out = dict(zip(BLOCK_PHASES, times)) if len(times) == 6 else times
    return {"body": body, "phases_us": out}


def prefill_inputs(gen, P, pos0):
    """prefill_attn_block's arguments at LLaMA-7B widths (KV = H), bf16:
    P rows, all real, over a permuted table of 72 pages of 16."""
    import torch
    from paddle_tpu_torch.ops.rope import build_rope_cache
    D, H, hd, BS, MB = cs.D7, cs.H7, cs.HD7, cs.BS16, cs.MB72
    dt = torch.bfloat16

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * std).to(dt)
    sin, cos = build_rope_cache(MB * BS, hd, device="cuda")
    table = (torch.randperm(MB, generator=gen, device="cuda") + 1
             ).to(torch.int32)
    nw = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(dt)
    return (rn(P, D), nw, rn(D, H * hd, std=0.02), rn(D, H * hd, std=0.02),
            rn(D, H * hd, std=0.02), rn(H * hd, D, std=0.02),
            sin[pos0:pos0 + P], cos[pos0:pos0 + P],
            rn(MB + 1, BS, H, hd), rn(MB + 1, BS, H, hd), table, pos0, P)


def mlp_inputs(gen, rows):
    """decode_mlp_block's arguments at LLaMA-7B widths, bf16."""
    import torch
    dt = torch.bfloat16

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * std).to(dt)
    nw = (1 + 0.1 * torch.randn(cs.D7, generator=gen, device="cuda")).to(dt)
    return (rn(rows, cs.D7), nw, rn(cs.D7, cs.F7, std=0.02),
            rn(cs.D7, cs.F7, std=0.02), rn(cs.F7, cs.D7, std=0.02))


@contextlib.contextmanager
def mlp_body(fdb, body):
    """Run decode_mlp_block under ``body`` ("tc": the tensor-core body
    from 9 rows on; "cuda_core": never; None: the committed threshold) by
    moving the threshold; a tree without one has a single body."""
    old = getattr(fdb, "MLP_TC_MIN_ROWS", None)
    if old is not None and body is not None:
        fdb.MLP_TC_MIN_ROWS = 9 if body == "tc" else 1 << 30
    try:
        yield
    finally:
        if old is not None:
            fdb.MLP_TC_MIN_ROWS = old


def prefill_part(fdb, fpb, libs, gpu, wbits=(0,), pools=("fp",)):
    """prefill_attn_block at P 128 over histories of PREFILL_POS0 (each
    weight class of ``wbits``, each pool class of ``pools``), and
    decode_mlp_block at MLP_ROWS, bf16, 7B widths: times and phases."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(7)
    for pos0 in PREFILL_POS0:
        fp = prefill_inputs(gen, PREFILL_P, pos0)
        for bits in wbits:
            args = list(fp)
            if bits:
                args[2:6] = cs.wq_leaves(fp[2:6], bits)
            for pool in pools:
                a, kw = list(args), {}
                if pool == "int8":
                    kq, vq, kw["kv_scales"], _, _ = cs.kv8_pools(a[8], a[9])
                    a[8], a[9] = kq, vq

                def run(a=a, kw=kw):
                    return fpb.prefill_attn_block_cuda(*a, **kw)
                use(fpb, libs["prefill"], "fused_prefill_block")
                row = {"phase": "prefill_attn_block", "gpu": gpu,
                       "P": PREFILL_P, "pos0": pos0, "wbits": bits,
                       "pools": pool, "ms": cs.cold_ms(run, iters=40)}
                use(fpb, libs["prefill_stamped"], "fused_prefill_block")
                row["phases_us"] = named(
                    "prefill_attn_block",
                    phases(fpb, libs["prefill_stamped"], run))
                cs.emit(row)
    tc = getattr(fdb, "MLP_TC_MIN_ROWS", None) is not None
    for rows in MLP_ROWS:
        args = mlp_inputs(gen, rows)

        def run():
            return fdb.decode_mlp_block_cuda(*args)
        row = {"phase": "decode_mlp_block", "gpu": gpu, "rows": rows}
        for body in (("tc", "cuda_core") if tc else (None,)):
            with mlp_body(fdb, body):
                use(fdb, libs["decode"])
                ms = cs.cold_ms(run, iters=40)
                use(fdb, libs["decode_stamped"])
                ph = named("decode_mlp_block",
                           phases(fdb, libs["decode_stamped"], run))
            key = body or "committed"
            row[key] = {"ms": ms, "phases_us": ph}
        cs.emit(row)


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("decode", "prefill", "all"),
                    default="all")
    ap.add_argument("--wbits", type=int, nargs="+", default=[0, 8, 4],
                    choices=(0, 8, 4))
    ap.add_argument("--pools", nargs="+", default=["fp", "int8"],
                    choices=("fp", "int8"))
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("cuda_phase_times: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
    gpu = cs.gpu_line()
    decode_src = (fdb._build.CSRC / "fused_decode_block.cu").read_text()
    prefill_src = (fdb._build.CSRC / "fused_prefill_block.cu").read_text()
    work = Path(tempfile.mkdtemp(prefix="phase_times_"))
    srcs = {}
    if opts.part in ("decode", "all"):
        srcs.update(variants(decode_src))
    if opts.part in ("prefill", "all"):
        srcs.update(prefill_variants(prefill_src, decode_src))
    try:
        libs, ptxas = build(work, srcs)
        cs.emit({"phase": "build", "gpu": gpu, "ptxas": ptxas})
        if opts.part in ("decode", "all"):
            decode_part(fdb, libs, gpu, opts.wbits)
        if opts.part in ("prefill", "all"):
            prefill_part(fdb, fpb, libs, gpu, opts.wbits, opts.pools)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
