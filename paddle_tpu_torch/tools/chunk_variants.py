#!/usr/bin/env python3
"""The chunk-row tensor-core bodies beside the designs tried and not kept,
on one GPU.

    python3 paddle_tpu_torch/tools/chunk_variants.py [VARIANT ...]

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit. Each variant is the committed sources of decode_mlp_block's
and prefill_attn_block's tensor-core bodies (``paddle_tpu_torch/csrc/
tile_mma.cuh``, their row-tile product, and the phase constants of
``fused_decode_block.cu`` and ``fused_prefill_block.cu``) with a few lines
replaced (:data:`PATCHES`), built into a temporary directory and loaded in
place of the built libraries, so that the wrappers run them unchanged
(with their plan constants set to the variant's; "committed" is the
source as it is):

- ``first``: the first design measured: 64 k a stage in 3 stages,
  32-column tiles in every product phase, no split of K;
- ``k64s6``: the same in 6 stages (five chunks in flight);
- ``cols32``: 32-column tiles in every product phase (committed: 64),
  in 4 stages (the room the narrower tiles leave), no split of K;
- ``nosplit``: down and o_proj on 32-column tiles (128 of them, for 132
  SMs) over all of K, instead of 64-column tiles over two parts of K (the
  left operand read half as often);
- ``running_sum``: each product summed by the tensor core's running sum
  over all of K, instead of each stage's depth summed from zero and
  added in f32;
- ``nomma``: no tensor-core work at all, the copies and barriers alone
  (its errors are meaningless): the pipeline's own time.

The copies are built with block 0 stamping the global timer after each
grid-wide barrier (``cuda_phase_times.stamped``), so each variant's phases
print beside its time; the stamps add a barrier at each kernel's end.

For each variant it prints ptxas's registers and spills of the
tensor-core instances, the worst error of decode_mlp_block at 32 and 128
rows and of prefill_attn_block at P 128 (pos0 512) against their plain
versions in units of chip_smoke.py's two-ulp bound (``bf16_close``: 1 is
the limit), and their times (``cold_ms``), bf16 at LLaMA-7B widths. One
JSON object per line; the last is ``{"ok": true}``. It imports nothing of
JAX or of ``paddle_tpu``.
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

sys.path.insert(0, str(ROOT / "paddle_tpu_torch" / "tools"))
import cuda_phase_times as pt  # noqa: E402
from cuda_phase_times import stamped  # noqa: E402

#: the wrappers' module constants a variant may change, as committed
DEFAULTS = {}

def _set(f, name, old, new):
    return (f, f"constexpr int {name} = {old};",
            f"constexpr int {name} = {new};")


_DEC, _PRE, _TM = ("fused_decode_block.cu", "fused_prefill_block.cu",
                   "tile_mma.cuh")
_NARROW_DO = (_set(_DEC, "kDownCols", 64, 32), _set(_PRE, "kOCols", 64, 32))
_NARROW = (_set(_DEC, "kUpCols", 64, 32), _set(_PRE, "kQkvCols", 64, 32),
           *_NARROW_DO)
_NARROW_PY = {"fdb.MLP_UP_COLS": 32, "fpb.QKV_COLS": 32,
              "fdb.MLP_DOWN_COLS": 32, "fpb.O_COLS": 32}
_K64 = _set(_TM, "kChunkK", 128, 64)
#: variant -> ((file in csrc/, old, new) replacements, the wrappers'
#: module constants it runs with, "fdb.NAME" / "fpb.NAME")
PATCHES = {
    "committed": ((), {}),
    "first": (_NARROW + (_K64,), dict(_NARROW_PY, **{"fdb.TC_CHUNK_K": 64})),
    "k64s6": (_NARROW + (_K64, _set(_TM, "kStages", 3, 6)),
              dict(_NARROW_PY, **{"fdb.TC_CHUNK_K": 64, "fdb.TC_STAGES": 6})),
    "cols32": (_NARROW + (_set(_TM, "kStages", 3, 4),),
               dict(_NARROW_PY, **{"fdb.TC_STAGES": 4})),
    "nosplit": (_NARROW_DO, {"fdb.MLP_DOWN_COLS": 32, "fpb.O_COLS": 32}),
    "running_sum": (
        ((_TM, "mma2(t[m][0][ni], t[m][0][ni + 1], a[0], b);",
          "mma2(acc[m][0][ni], acc[m][0][ni + 1], a[0], b);"),
         (_TM, "if (live1) mma2(t[m][1][ni], t[m][1][ni + 1], a[1], b);",
          "if (live1) mma2(acc[m][1][ni], acc[m][1][ni + 1], a[1], b);")),
        {}),
    "nomma": (((_TM, "if (!live0) continue;", "continue;"),), {}),
}
LIBS = ("fused_decode_block", "fused_prefill_block")


def patched(name, file, text):
    """csrc/``file``'s ``text`` as variant ``name`` has it."""
    for f, old, new in PATCHES[name][0]:
        if f != file:
            continue
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} is not in {file}")
        text = text.replace(old, new)
    return text


def build(work, names):
    """Every variant's copy of csrc/ with its tile_mma.cuh, both sources
    built against it, all nvcc processes started together."""
    from paddle_tpu_torch.ops.kernels import _build
    procs = {}
    for name in names:
        src = work / name
        shutil.copytree(_build.CSRC, src)
        for f in {f for f, _, _ in PATCHES[name][0]}:
            (src / f).write_text(patched(name, f, (src / f).read_text()))
        for lib in LIBS:
            cu = src / f"{lib}.cu"
            cu.write_text(stamped(cu.read_text()))
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src),
                   "-o", str(src / f"lib{lib}.so"), str(src / f"{lib}.cu")]
            procs[(name, lib)] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    libs, ptxas = {}, {}
    for (name, lib), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}/{lib}:\n{log}")
        (work / name / f"lib{lib}.log").write_text(log)
        rep = cs._ptxas(work / name / f"lib{lib}.log")
        ptxas.setdefault(name, {}).update(
            {k: v for k, v in rep.items() if "Lb1EEEvNS0" in k
             and ("mlp_block" in k or "prefill" in k)})
        libs[(name, lib)] = ctypes.CDLL(str(work / name / f"lib{lib}.so"))
    return libs, ptxas


def use(fdb, fpb, libs, name):
    """The variant's libraries in the built ones' place, its stage count
    in the wrappers' plans, every binding and cooperative grid asked
    anew."""
    _build = fdb._build
    for lib in LIBS:
        _build._LIBS[lib] = libs[(name, lib)]
    for key in [k for k in _build._FNS if k[0] in LIBS]:
        del _build._FNS[key]
    fdb._GRIDS.clear()
    # the specs are cached by shape and shared memory, not by the plan
    # constants a variant sets
    fdb.mlp_spec.cache_clear()
    fpb.prefill_spec.cache_clear()
    mods = {"fdb": fdb, "fpb": fpb}
    for key, value in dict(DEFAULTS, **PATCHES[name][1]).items():
        mod, attr = key.split(".")
        setattr(mods[mod], attr, value)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chunk_variants: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
    mods = {"fdb": fdb, "fpb": fpb}
    DEFAULTS.update({k: getattr(mods[k.split(".")[0]], k.split(".")[1])
                     for _, consts in PATCHES.values() for k in consts})
    names = sys.argv[1:] or list(PATCHES)
    gpu = cs.gpu_line()
    work = Path(tempfile.mkdtemp(prefix="chunk_variants_"))
    try:
        libs, ptxas = build(work, names)
        cs.emit({"phase": "build", "gpu": gpu, "ptxas": ptxas})
        gen = torch.Generator(device="cuda").manual_seed(8)
        mlp = {r: pt.mlp_inputs(gen, r) for r in (32, 128)}
        pre = pt.prefill_inputs(gen, 128, 512)
        want = {r: fdb.mlp_block_wq_ref(*a) for r, a in mlp.items()}
        want_p = fpb.prefill_attn_block_wq_ref(*pre)[0]
        for name in names:
            use(fdb, fpb, libs, name)
            row = {"phase": "variant", "variant": name, "gpu": gpu}
            for r, a in mlp.items():
                got = fdb.decode_mlp_block_cuda(*a)
                row[f"mlp_{r}_err_units"] = cs.bf16_close(
                    got, want[r])[1] / 2 ** -6
                row[f"mlp_{r}_ms"] = cs.cold_ms(
                    lambda a=a: fdb.decode_mlp_block_cuda(*a))
                row[f"mlp_{r}_phases_us"] = pt.named(
                    "decode_mlp_block", pt.phases(
                        fdb, libs[(name, LIBS[0])],
                        lambda a=a: fdb.decode_mlp_block_cuda(*a)))
            got = fpb.prefill_attn_block_cuda(*pre)[0]
            row["prefill_err_units"] = cs.bf16_close(got, want_p)[1] / 2 ** -6
            row["prefill_ms"] = cs.cold_ms(
                lambda: fpb.prefill_attn_block_cuda(*pre))
            row["prefill_phases_us"] = pt.named(
                "prefill_attn_block", pt.phases(
                    fpb, libs[(name, LIBS[1])],
                    lambda: fpb.prefill_attn_block_cuda(*pre)))
            cs.emit(row)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
