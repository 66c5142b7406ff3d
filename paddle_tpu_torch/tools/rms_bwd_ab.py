#!/usr/bin/env python3
"""The RMSNorm backward's former kernels beside the committed ones, on one
GPU.

    python3 paddle_tpu_torch/tools/rms_bwd_ab.py [--programs 264 396 528]

The former body (:func:`parent_rms_norm_bwd`, kept here as it was before
the redesign, not in the package): a row kernel of 264 programs, each
loading a row only once it has finished the last, then the dw partials
summed on D / 1024 programs, each walking the partial rows one at a time.
The committed body is ``ops/kernels/norms.py``'s :func:`rms_norm_bwd_triton`.

At [4096, 4096] bf16 (inputs from a fixed seed, L2 flushed, the card held
before each launch: ``chip_smoke.cold_ms``) it times, in turns (former,
committed, committed, former): each body's whole call, and each of its two
device kernels on its own; the committed row kernel at the program counts
of ``--programs``; and ``torch.ops.aten._fused_rms_norm_backward`` on the
same inputs, its rstd from ``torch.ops.aten._fused_rms_norm`` outside the
timed window. Every body is held against :func:`rms_bwd_ref` (dx and dw
to two bf16 ulps, ``chip_smoke.bf16_close``). Prints one JSON line with
the card's name and power limit. ``chip_smoke.py`` times
:func:`parent_rms_norm_bwd` beside the committed kernel. It imports
nothing of JAX or of ``paddle_tpu``.
"""
import argparse
import dataclasses
import json
import statistics
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
_kernels = {}
tl = None          # triton.language, bound by triton_jit at the first launch
_PROGRAMS = 264
_SUM_BLOCK = 1024


def _rms_bwd_kernel(x_ptr, w_ptr, g_ptr, dx_ptr, part_ptr, rows, D, eps,
                    BLOCK: "tl.constexpr"):
    pid = tl.program_id(0)
    nprog = tl.num_programs(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < D
    wf = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    dw = tl.zeros([BLOCK], tl.float32)
    for r in range(pid, rows, nprog):
        off = r.to(tl.int64) * D + cols
        x = tl.load(x_ptr + off, mask=mask, other=0.0)
        xf = x.to(tl.float32)
        gf = tl.load(g_ptr + off, mask=mask, other=0.0).to(tl.float32)
        inv = tl.rsqrt(tl.sum(xf * xf, axis=0) / D + eps)
        xhat = xf * inv
        gw = gf * wf
        dx = inv * (gw - xhat * (tl.sum(gw * xhat, axis=0) / D))
        tl.store(dx_ptr + off, dx.to(x.dtype), mask=mask)
        dw += gf * xhat
    tl.store(part_ptr + pid.to(tl.int64) * D + cols, dw, mask=mask)


def _sum_rows_kernel(part_ptr, out_ptr, n_rows, D, BLOCK: "tl.constexpr"):
    """out[c] = sum of part[p, c] over p = 0, 1, ... in that order."""
    cols = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = cols < D
    acc = tl.zeros([BLOCK], tl.float32)
    for p in range(0, n_rows):
        acc += tl.load(part_ptr + p * D + cols, mask=mask, other=0.0)
    tl.store(out_ptr + cols, acc.to(out_ptr.dtype.element_ty), mask=mask)


def _parent_kernels(x, weight, g, epsilon):
    """The former body's two launches: ``(row, sum, (dx, dw))``, each a
    callable that launches one device kernel."""
    import torch

    from paddle_tpu_torch.ops.kernels import _build
    D = x.shape[-1]
    x2, g2 = x.reshape(-1, D), g.reshape(-1, D)
    rows = x2.shape[0]
    block = 1 << max(D - 1, 0).bit_length()
    nprog = max(1, min(rows, _PROGRAMS))
    dx = torch.empty_like(x2)
    dw = torch.empty(D, dtype=weight.dtype, device=x.device)
    part = torch.empty(nprog, D, dtype=torch.float32, device=x.device)
    row_k = _build.triton_jit(globals(), "_rms_bwd_kernel")
    sum_k = _build.triton_jit(globals(), "_sum_rows_kernel")
    warps = 8 if block >= 2048 else 4

    def row():
        row_k[(nprog,)](x2, weight, g2, dx, part, rows, D, float(epsilon),
                        BLOCK=block, num_warps=warps)

    def col_sum():
        sum_k[(-(-D // _SUM_BLOCK),)](part, dw, nprog, D, BLOCK=_SUM_BLOCK,
                                      num_warps=4)
    return row, col_sum, (dx.reshape(x.shape), dw)


def parent_rms_norm_bwd(x, weight, g, epsilon=1e-6):
    """The former body on CUDA tensors: ``(dx, dw)`` as ``rms_bwd_ref``."""
    row, col_sum, out = _parent_kernels(x, weight, g, epsilon)
    row()
    col_sum()
    return out


def _committed_kernels(norms, x, weight, g, epsilon):
    """The committed body's two launches, as ``_parent_kernels``."""
    import torch

    from paddle_tpu_torch.ops.kernels import _launch
    D = x.shape[-1]
    rows = x.numel() // D
    spec = norms.rms_bwd_spec(rows, D, _launch.dtype_name(x.dtype))
    dx = torch.empty_like(x)
    dw = torch.empty(D, dtype=weight.dtype, device=x.device)
    part = torch.empty(spec.plan["part"], dtype=torch.float32,
                       device=x.device)
    args = [(x, weight, g, dx, part, rows, D, float(epsilon)),
            (part, dw, spec.plan["part"][0], D)]
    one, two = (dataclasses.replace(spec, calls=spec.calls[part_of],
                                    plan={"launches":
                                          spec.plan["launches"][part_of]})
                for part_of in (slice(0, 1), slice(1, 2)))
    return (lambda: _launch.triton_run(vars(norms), one, args[:1]),
            lambda: _launch.triton_run(vars(norms), two, args[1:]),
            (dx, dw))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--programs", type=int, nargs="*", default=[396, 528])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    sys.path.insert(0, str(_ROOT))
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import norms
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    gpu = cs.gpu_line()
    gen = torch.Generator(device="cuda").manual_seed(8)
    T, D, eps, bf = 4096, 4096, 1e-6, torch.bfloat16
    x, g = (torch.randn(T, D, generator=gen, device="cuda").to(bf)
            for _ in range(2))
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(bf)
    want = norms.rms_bwd_ref(eps, (x, w), g)

    def held(out):
        return all(cs.bf16_close(a, b)[0] for a, b in zip(out, want))

    def ms(fn):
        return cs.cold_ms(fn, iters=args.iters)
    p_row, p_sum, p_out = _parent_kernels(x, w, g, eps)
    c_row, c_sum, c_out = _committed_kernels(norms, x, w, g, eps)
    for fn in (p_row, p_sum, c_row, c_sum):
        fn()
    torch.cuda.synchronize()
    out = {"gpu": gpu, "shape": [T, D], "dtype": "bfloat16",
           "held": {"parent": held(p_out), "committed": held(c_out)},
           "bitwise_repeatable": None, "turns": []}
    first = norms.rms_norm_bwd_triton(x, w, g, eps)
    again = norms.rms_norm_bwd_triton(x, w, g, eps)
    out["bitwise_repeatable"] = all(torch.equal(a, b)
                                    for a, b in zip(first, again))
    for body in ("parent", "committed", "committed", "parent"):
        row, col_sum = (p_row, p_sum) if body == "parent" \
            else (c_row, c_sum)
        call = (lambda: parent_rms_norm_bwd(x, w, g, eps)) \
            if body == "parent" else \
            (lambda: norms.rms_norm_bwd_triton(x, w, g, eps))
        out["turns"].append({"body": body, "call_ms": ms(call),
                             "row_kernel_ms": ms(row),
                             "sum_kernel_ms": ms(col_sum)})
    for body in ("parent", "committed"):
        got = [t for t in out["turns"] if t["body"] == body]
        out[f"{body}_ms"] = statistics.mean(t["call_ms"] for t in got)
    programs = {}
    base = norms._BWD_PROGRAMS
    try:
        for n in args.programs:
            norms._BWD_PROGRAMS = n
            norms.rms_bwd_spec.cache_clear()
            row, col_sum, res = _committed_kernels(norms, x, w, g, eps)
            row()
            col_sum()
            programs[n] = {"call_ms": ms(lambda: norms.rms_norm_bwd_triton(
                x, w, g, eps)), "row_kernel_ms": ms(row),
                "sum_kernel_ms": ms(col_sum), "held": held(res)}
    finally:
        norms._BWD_PROGRAMS = base
        norms.rms_bwd_spec.cache_clear()
    out["programs"] = programs
    out["library"] = None
    op = getattr(torch.ops.aten, "_fused_rms_norm_backward", None)
    if op is not None:
        _, rstd = torch.ops.aten._fused_rms_norm(x, [D], w, eps)
        lib = op(g, x, [D], rstd, w, [True, True])
        out["library"] = {
            "call": "torch.ops.aten._fused_rms_norm_backward",
            "ms": ms(lambda: op(g, x, [D], rstd, w, [True, True])),
            "held": held(lib)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
