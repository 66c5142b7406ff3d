#!/usr/bin/env python3
"""Variants of the linear-CE kernels against the committed ones, on one GPU.

    python3 paddle_tpu_torch/tools/ce_variants.py [--part dh|fwd] [--iters N]

``--part dh`` (the default): the backward's dh product with 64-deep stages
against the committed 32-deep ones.

dh's product reads x and P both MN-major; at 64 deep a stage of x and the
hi and lo tiles is 80 KB and two fit the ring, at 32 deep five do
(``gemm::depth`` in ``csrc/linear_ce.cu``). This builds the committed
library and a copy of the sources with ``depth`` 64 for every product,
then at the train step's shape (T 4096, D 4096, V 32000, bf16, inputs
from a fixed seed) times the P pass, dx's product and dh's product of
the committed build, and dh's product of both builds in turns
(committed, variant, variant, committed; ``chip_smoke.cold_ms``), and
checks that the two give the same bits (the depth of a stage does not
change the order of the sums). Prints one JSON line with the card's name
and power limit.

``--part fwd``: what the bf16 forward's epilogue costs. The variant keeps
the forward's mainloop (the same wgmma tiles, ring and tile order) and
replaces the stats epilogue (each row's max, sum of exp and pick, reduced
over a quad) by one store a row of its first accumulator; at the train
step's shape, untied head, the two whole calls (product, then the
combine) are timed in turns (committed, variant, variant, committed), so
their difference is the epilogue's cost. The variant's lse is not the
function's.

It imports nothing of JAX or of ``paddle_tpu``.
"""
import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
_DEPTH = "return PAIR == 2 ? 32 : 64;"
_STATS = "    } else if constexpr (EPI == kEpiStats) {\n"
_OUT = "    } else {\n      auto* out = static_cast<__nv_bfloat16*>(epi.out);"
_ONE_STORE = """    } else if constexpr (EPI == kEpiStats) {
      if ((lane & 3) == 0 && rbase < M)
        epi.part[static_cast<long long>(n0 / kGBN) * M + rbase] = acc[0];
"""


def _build_variant(edit):
    """A copy of the sources with linear_ce.cu edited by ``edit(text)``,
    built and loaded (ctypes)."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build
    tmp = Path(tempfile.mkdtemp())
    try:
        shutil.copytree(_build.CSRC, tmp / "csrc")
        src = tmp / "csrc" / "linear_ce.cu"
        src.write_text(edit(src.read_text()))
        lib = tmp / "libvariant.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                        str(tmp / "csrc"), "-o", str(lib), str(src)],
                       check=True, capture_output=True)
        return ctypes.CDLL(str(lib))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _no_stats(text):
    a, b = text.find(_STATS), text.find(_OUT)
    if a < 0 or b < a:
        raise SystemExit("the stats epilogue not found in linear_ce.cu")
    return text[:a] + _ONE_STORE + text[b:]


def _depth64(text):
    if _DEPTH not in text:
        raise SystemExit("gemm::depth not found in linear_ce.cu")
    return text.replace(_DEPTH, "return 64;")


def _forward(cs, torch, kft, committed, iters):
    """The committed forward against the one-store epilogue, in turns."""
    from paddle_tpu_torch.ops.kernels import _build
    variant = _build_variant(_no_stats)
    gen = torch.Generator(device="cuda").manual_seed(8)
    T, D, V = 4096, 4096, 32000
    x = (torch.randn(T, D, generator=gen, device="cuda") * 0.5).to(
        torch.bfloat16)
    head = (torch.randn(D, V, generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    lab = torch.randint(0, V, (T,), generator=gen, device="cuda")
    turns = []
    try:
        for name, lib in (("committed", committed), ("one_store", variant),
                          ("one_store", variant), ("committed", committed)):
            _build._LIBS["linear_ce"] = lib
            _build._FNS.clear()
            turns.append((name, cs.cold_ms(
                lambda: kft.linear_ce_fwd_cuda(x, head, lab), iters=iters)))
    finally:
        _build._LIBS["linear_ce"] = committed
        _build._FNS.clear()
    return {"shape": {"T": T, "D": D, "V": V, "head": "untied"},
            "forward_ms": turns,
            "cublas_S_ms": cs.cold_ms(lambda: x @ head, iters=iters)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("dh", "fwd"), default="dh")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(_ROOT))
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import fused_train as kft
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    gpu = cs.gpu_line()
    _build.build(["linear_ce"])
    committed = _build.load("linear_ce")
    if args.part == "fwd":
        out = {"gpu": gpu, **_forward(cs, torch, kft, committed, args.iters)}
        print(json.dumps(out), flush=True)
        return 0
    variant = _build_variant(_depth64)
    # the variant's dh ring: two stages of x (128 x 64) and P's hi and lo
    # (256 x 64 each), bf16, the 1 KB alignment and the barriers
    smem64 = 2 * (128 * 64 * 2 + 2 * 256 * 64 * 2) + 1024 + 2 * 6 * 8
    smem32 = kft.CE_PAIR_B_SMEM

    gen = torch.Generator(device="cuda").manual_seed(8)
    T, D, V = 4096, 4096, 32000
    x = (torch.randn(T, D, generator=gen, device="cuda") * 0.5).to(
        torch.bfloat16)
    head = (torch.randn(D, V, generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    lab = torch.randint(0, V, (T,), generator=gen, device="cuda")
    coef = torch.tensor([1.0 / T], device="cuda")
    lse = kft.linear_ce_fwd_cuda(x, head, lab)[0]
    ops = kft.ce_operands(x, head)
    sdx = kft.ce_spec("linear_ce_bwd_dx", T, D, V, "bfloat16", "bfloat16")
    sdh = kft.ce_spec("linear_ce_bwd_dh", T, D, V, "bfloat16", "bfloat16",
                      p_given=True)
    ws = kft.ce_workspace(x, T, V)
    kft.ce_p_pass(sdx, ops, lab, lse, coef, ws, 0, T)
    dx = torch.empty_like(x)
    dh = torch.empty(D, V, dtype=torch.bfloat16, device="cuda")

    def use(lib, smem):
        _build._LIBS["linear_ce"] = lib
        _build._FNS.clear()
        kft.CE_PAIR_B_SMEM = smem

    def dh_ms():
        return cs.cold_ms(lambda: kft.ce_dh_product(sdh, ops, ws, dh, None,
                                                    0), iters=args.iters)
    out = {"gpu": gpu, "shape": {"T": T, "D": D, "V": V},
           "p_pass_ms": cs.cold_ms(lambda: kft.ce_p_pass(
               sdx, ops, lab, lse, coef, ws, 0, T), iters=args.iters),
           "dx_product_ms": cs.cold_ms(lambda: kft.ce_dx_product(
               sdx, ops, ws, dx), iters=args.iters)}
    turns = []
    bits = {}
    try:
        for name, lib, smem in (("depth32", committed, smem32),
                                ("depth64", variant, smem64),
                                ("depth64", variant, smem64),
                                ("depth32", committed, smem32)):
            use(lib, smem)
            turns.append((name, dh_ms()))
            bits[name] = dh.clone()
    finally:
        use(committed, smem32)
    out["dh_product_ms"] = turns
    out["same_bits"] = bool(torch.equal(bits["depth32"], bits["depth64"]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
