#!/usr/bin/env python3
"""Per-phase device times of the PyTorch/CUDA port's fused decode kernels
on one GPU.

    python3 paddle_tpu_torch/tools/cuda_phase_times.py

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

- the time of decode_block_fused and of decode_attn_block followed by
  decode_mlp_block on the same inputs (chip_smoke.py's ``cold_ms``);
- the stamped phases, microseconds: decode_attn_block (qkv, pages,
  combine, o_proj), decode_mlp_block (gate/up, down) and
  decode_block_fused (all six). The stamps add a barrier at the end of
  each kernel and change register allocation: compare phases with
  phases, not with the unstamped times.

The copies keep the launchers' ``extern "C"`` signatures, and the
wrappers run on them unchanged: :func:`use` loads a copy in place of the
built library, and ``_build.c_fn`` binds each launcher with
``fused_decode_block.CALLS``' argument codes (the codes the gate's
ARG_MISMATCH rule holds against the source), with the wrapper's own plan
and its copy's cooperative grid (the grid cache is emptied, so each copy's
occupancy query answers for its own launch bounds).

One JSON object per line; the last is ``{"ok": true}``. It imports
nothing of JAX or of ``paddle_tpu``.
"""
import ctypes
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
STAMP = ('\n  if (blockIdx.x == 0 && threadIdx.x == 0) {'
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


def stamped(src):
    """``src`` with block 0 stamping the global timer at each kernel's
    start, after each grid sync, and after a final grid sync."""
    out = src.replace("struct BlockArgs {",
                      "__device__ unsigned long long g_stamps[64];\n"
                      "__device__ int g_n;\nstruct BlockArgs {", 1)
    for name, args in (("decode_attn_block", "AttnArgs"),
                       ("decode_mlp_block", "MlpArgs"),
                       ("decode_block_fused", "BlockArgs")):
        head = f"{name}_kernel(const {args} a) {{"
        i = out.index(head)
        j = out.index("\n}\n", i)
        body = out[i:j].replace("cg::this_grid();", "cg::this_grid();" + STAMP)
        body = body.replace("grid.sync();", "grid.sync();" + STAMP)
        out = out[:i] + body + "\n  grid.sync();" + STAMP + out[j:]
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


def use(fdb, lib):
    """Run the wrappers of ``fdb`` (``ops.kernels.fused_decode_block``) on
    ``lib``'s launchers: ``lib`` takes the built library's place in
    ``_build``, whose ``c_fn`` binds each launcher at its next call with
    the codes of ``fdb.CALLS`` (through the wrapper's launch spec), and
    the cooperative grids are asked of ``lib`` anew."""
    _build = fdb._build
    _build._LIBS["fused_decode_block"] = lib
    for key in [k for k in _build._FNS if k[0] == "fused_decode_block"]:
        del _build._FNS[key]
    fdb._GRIDS.clear()


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


def main():
    import torch
    if not torch.cuda.is_available():
        print("cuda_phase_times: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    from paddle_tpu_torch.ops.rope import build_rope_cache
    gpu = cs.gpu_line()
    src = (fdb._build.CSRC / "fused_decode_block.cu").read_text()
    work = Path(tempfile.mkdtemp(prefix="phase_times_"))
    try:
        libs, ptxas = build(work, variants(src))
        cs.emit({"phase": "build", "gpu": gpu, "ptxas": ptxas})
        gen = torch.Generator(device="cuda").manual_seed(6)
        rope = build_rope_cache(4096, cs.HD7, device="cuda")
        args = list(cs.block_inputs(gen, torch.bfloat16, cs.H7, cs.F7, rope,
                                    cs.B8))
        serving = torch.randint(300, 520, (cs.B8,), generator=gen,
                                device="cuda").to(torch.int32)
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
                   "seq_lens": lens.tolist()}
            for name in ("lb1", "lb2"):
                use(fdb, libs[name])
                row[f"{name}_block_ms"] = cs.cold_ms(block, iters=40)
                row[f"{name}_pair_ms"] = cs.cold_ms(pair, iters=40)
            for name in ("lb1_stamped", "lb2_stamped"):
                use(fdb, libs[name])
                row[name] = {
                    "decode_attn_block": phases(
                        fdb, libs[name],
                        lambda: fdb.decode_attn_block_cuda(*attn)),
                    "decode_mlp_block": phases(
                        fdb, libs[name],
                        lambda: fdb.decode_mlp_block_cuda(x, pw, wg, wu,
                                                          wd)),
                    "decode_block_fused": phases(fdb, libs[name], block)}
            cs.emit(row)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
