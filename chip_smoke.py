#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA H100. It builds
the port's kernels from the sources in the checkout (one nvcc per CUDA
C++ source, one after another; Triton's JIT for the Triton kernel) and
prints one JSON line per phase; a phase that fails raises, so the script
exits non-zero:

1. GPU: the card's name and power limit, as ``nvidia-smi`` prints them.
2. kernels: every kernel of both routes against its plain version on the
   card, at the routes' shapes (LLaMA-7B widths, 8 slots, chunks of 32
   and 128 rows), with its time (L2 flushed before every launch), its
   plain version's time, the time of one PyTorch library call computing
   the same function where there is one, and its bound. The two fused
   decode-block kernels run at KV=32 and KV=8, in f32 and bf16, with
   lengths 0/1/15/16/17/1151, a ragged F for the MLP, 20 and 32 slots
   (more than one pass of 8 rows; dispatch must pick the kernels there
   too), and two launches that must agree bit for bit; decode_mlp_block
   also at 32 and 128 rows (the prefill MLP). prefill_attn_block runs at
   KV=32 and 8, f32 and bf16, P=32 and 128, permuted tables and (pos0,
   n_valid) = (0, P), (0, 1), (0, P-3), (5, P-3), (16, P), (600, 21 at
   P=32, 77 at P=128): the real rows against the plain version, every row
   finite, two launches bit for bit; timed at P=128, bf16, pos0 0 and 512
   beside its bound, its plain version, its four products alone
   (``torch.matmul``) and SDPA over the same attention.
3. parity: LLaMA-7B widths, 2 layers, f32: greedy tokens for 5 requests
   through 2 slots from the engine on its default route (fused prefill
   and fused decode) and on the unfused route, each against the port's
   dense ``generate``.
4. serving (the main path): LLaMA-7B, 32 layers, bf16, random weights
   from a seeded ``torch.Generator`` on the card: 12 requests of 40-600
   prompt tokens and 64 new tokens each through 8 slots, on the default
   route (``fused_decode`` and ``fused_prefill`` "auto"). The launch
   counts are set to 0 just before and read just after:
   prefill_attn_block once per layer per prefill chunk, decode_attn_block
   once per layer per decode step, decode_mlp_block once per layer per
   step and per chunk, paged attention never, RMSNorm once per decode
   step and once per chunk (the final norms).
5. profile of that engine: 8 requests of 384 prompt tokens; the first
   two chunks of the first one (alone on the engine) traced with
   torch.profiler (device time per chunk by kernel group), every later
   chunk timed with CUDA events (ms per chunk by bucket); then a window
   of decode steps with all 8 slots live, timed, then traced: device
   time per step by kernel group and the card's busy share.
6. serving and profile again on the unfused route (``fused_decode=False,
   fused_prefill=False``, same parameters and requests): paged attention
   once per layer per decode step, RMSNorm 2L+1 times per decode step and
   per chunk, the prefill and decode-block kernels never.
7. routes: the bf16 greedy ids of both routes and of dense bf16
   ``generate`` on the same requests, compared pairwise (common prefix
   lengths, and the top-2 logit gap of dense bf16 logits at each first
   divergence). Informational: bf16 routes round at other places.

Then the ``kernels`` summary line (each kernel's launches from the
serving phase of the route that runs it) and, last, ``{"ok": true,
"device": {...}}``. Without CUDA it exits 1 and prints no result. It
imports nothing of JAX or of ``paddle_tpu``.
"""
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"float32": 67e12,  # f32 outside the tensor cores
                  "bfloat16": 989e12}
RMS_SOURCE = "paddle_tpu_torch/ops/kernels/norms.py"
PAGED_SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
FUSED_SOURCE = "paddle_tpu_torch/csrc/fused_decode_block.cu"
PREFILL_SOURCE = "paddle_tpu_torch/csrc/fused_prefill_block.cu"
CUDA_SOURCES = ("paged_attention", "fused_decode_block",
                "fused_prefill_block")
# LLaMA-7B widths and the serving phase's table geometry
D7, H7, HD7, F7, B8, BS16, MB72 = 4096, 32, 128, 11008, 8, 16, 72


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(out, flush=True)
    return out


def cold_ms(fn, iters=30, warmup=3):
    """Median device time of ``fn`` with L2 flushed before each call:
    CUDA events around every call, read after one final sync. A spin of
    ~1 ms on the card after the flush lets the host queue ``fn``'s
    launches before the start event fires, so the host's own time (the
    wrapper's checks, the launch call) stays out of the reading."""
    import torch
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()           # 256 MB: evicts the 50 MB L2
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def ulp_close(got, want, rel):
    """|got - want| <= rel * max(|got|, |want|), in f32 (one ulp of the
    working type for rel = its machine epsilon), plus 1e-6 absolute for
    values near zero."""
    import torch
    g, w = got.float(), want.float()
    tol = rel * torch.maximum(g.abs(), w.abs()) + 1e-6
    return bool(((g - w).abs() <= tol).all())


def bf16_close(got, want, rel=2.0 ** -6):
    """|got - want| <= rel * (max(|got|, |want|) + rms(want)): two bf16
    ulps (eps 2^-7) at the element's own magnitude, plus two at the
    tensor's RMS for elements a residual add cancelled towards zero.
    Returns (ok, the worst error in units of that scale)."""
    g, w = got.float(), want.float()
    scale = (g.abs().maximum(w.abs())
             + w.pow(2).mean().sqrt()).clamp_min(1e-30)
    worst = float(((g - w).abs() / scale).max())
    return worst <= rel, worst


def build_kernels():
    """One nvcc per CUDA source, one after another, then Triton's compile
    of the RMSNorm kernel on a first launch."""
    import torch
    from paddle_tpu_torch.ops.kernels import _build, norms
    t0 = time.perf_counter()
    for name in CUDA_SOURCES:
        _build.load(name)
    t_nvcc = time.perf_counter() - t0
    x = torch.ones(2, 64, device="cuda")
    norms.rms_norm_fwd_triton(x, torch.ones(64, device="cuda"))
    torch.cuda.synchronize()
    root = _build.CSRC.parent.parent
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_s": round(t_nvcc, 3),
          "libraries": {n: str(_build.library_path(n).relative_to(root))
                        for n in CUDA_SOURCES},
          "ptxas": {n: [ln.strip() for ln in _build.library_path(n)
                        .with_suffix(".log").read_text().splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n in CUDA_SOURCES}})


def rms_phase(gpu):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.norms import (rms_norm_fwd_triton,
                                                    rms_norm_ref)
    gen = torch.Generator(device="cuda").manual_seed(0)
    D, eps = 4096, 1e-6
    cases, max_err, timed = [], 0.0, None
    for rows in (8, 128):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(rows, D, generator=gen, device="cuda").to(dt)
            w = (1 + 0.1 * torch.randn(D, generator=gen,
                                       device="cuda")).to(dt)
            got = rms_norm_fwd_triton(x, w, eps)
            want = rms_norm_ref(x, w, eps)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if dt == torch.float32:
                ok = bool(torch.allclose(got, want, atol=1e-5, rtol=1e-5))
                tol = "atol=rtol=1e-5"
            else:
                ok = ulp_close(got, want, torch.finfo(dt).eps)
                tol = "one bf16 ulp (rel 2^-7)"
            cases.append({"shape": [rows, D], "dtype": str(dt)[6:],
                          "max_abs_err": err, "tol": tol, "ok": ok})
            max_err = max(max_err, err)
            if not ok:
                raise AssertionError(f"rms_norm_fwd disagrees: {cases[-1]}")
            if rows == 8 and dt == torch.bfloat16:
                timed = (x, w)
    x, w = timed                              # the decode step's shape
    item = x.element_size()
    b_ms, b_by = bound(2 * x.numel() * item + D * item, 4 * x.numel(),
                       "bfloat16")
    lib = (cold_ms(lambda: F.rms_norm(x, (D,), w, eps))
           if hasattr(F, "rms_norm") else None)
    row = {"name": "rms_norm_fwd", "route": "triton", "source": RMS_SOURCE,
           "replaces": "paddle_tpu/ops/pallas/norms.py:73",
           "shape": [8, D], "dtype": "bfloat16",
           "max_abs_err": max_err,
           "ms": cold_ms(lambda: rms_norm_fwd_triton(x, w, eps)),
           "plain_ms": cold_ms(lambda: rms_norm_ref(x, w, eps)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
           "library": "torch.nn.functional.rms_norm", "ok": True}
    emit({"phase": "kernel", "kernel": "rms_norm_fwd", "gpu": gpu,
          "cases": cases})
    return row


def paged_inputs(gen, dt, B, H, KV, hd, BS, MB):
    import torch
    full = MB * BS
    rand = torch.randint(2, full, (B - 5,), generator=gen, device="cuda")
    seq = torch.tensor([0, 1, BS, BS + 1, full], device="cuda")
    seq_lens = torch.cat([seq, rand]).to(torch.int32)
    N = B * MB + 1
    perm = torch.randperm(N - 1, generator=gen, device="cuda") + 1
    tables = perm[:B * MB].reshape(B, MB).to(torch.int32).contiguous()
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
    k = torch.randn(N, BS, KV, hd, generator=gen, device="cuda").to(dt)
    v = torch.randn(N, BS, KV, hd, generator=gen, device="cuda").to(dt)
    return q, k, v, tables, seq_lens


def paged_bytes(lens, H, KV, hd, BS, item):
    """Bytes one paged-attention launch must move: the live K and V rows
    of every sequence (``lens`` tokens each), q in and out, the lengths
    and the live table entries."""
    n_tok = int(sum(int(n) for n in lens))
    n_pages = sum(-(-int(n) // BS) for n in lens)
    return (n_tok * KV * hd * 2 * item + 2 * len(lens) * H * hd * item
            + 4 * len(lens) + 4 * n_pages)


def paged_phase(gpu):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_decode_cuda, paged_attention_decode_ref)
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, H, hd, BS, MB = 8, 32, 128, 16, 72     # the serving phase's shapes
    cases, max_err, timed = [], 0.0, None
    for dt, KV in ((torch.bfloat16, 32), (torch.float32, 32),
                   (torch.bfloat16, 8), (torch.float32, 8)):
        args = paged_inputs(gen, dt, B, H, KV, hd, BS, MB)
        got = paged_attention_decode_cuda(*args)
        want = paged_attention_decode_ref(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = 1e-5 if dt == torch.float32 else 2e-2
        ok = bool(torch.allclose(got.float(), want.float(), atol=tol,
                                 rtol=tol))
        zero = bool((got[args[4] == 0] == 0).all())
        cases.append({"dtype": str(dt)[6:], "KV": KV,
                      "seq_lens": args[4].tolist(), "max_abs_err": err,
                      "tol": f"atol=rtol={tol}", "zero_for_len_0": zero,
                      "ok": ok and zero})
        max_err = max(max_err, err)
        if not (ok and zero):
            raise AssertionError(
                f"paged_attention_decode disagrees: {cases[-1]}")
        if dt == torch.bfloat16 and KV == H:
            timed = args
    q, k, v, tables, seq_lens = timed
    lens = seq_lens.long()
    nbytes = paged_bytes(lens, H, k.shape[2], hd, BS, q.element_size())
    b_ms, b_by = bound(nbytes, 4 * H * hd * int(lens.sum()), "bfloat16")
    # yardstick: SDPA over K/V gathered densely beforehand (the gather is
    # not timed), the padding masked out
    T = MB * BS
    kd = k[tables.long()].reshape(B, T, H, hd).transpose(1, 2)
    vd = v[tables.long()].reshape(B, T, H, hd).transpose(1, 2)
    mask = (torch.arange(T, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = cold_ms(lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask))
    row = {"name": "paged_attention_decode", "route": "cuda",
           "source": PAGED_SOURCE,
           "replaces": "paddle_tpu/ops/pallas/paged_attention.py:135",
           "shape": {"B": B, "H": H, "KV": k.shape[2], "hd": hd, "BS": BS,
                     "MB": MB,
                     "seq_lens": seq_lens.tolist()},
           "dtype": "bfloat16", "max_abs_err": max_err,
           "ms": cold_ms(lambda: paged_attention_decode_cuda(*timed)),
           "plain_ms": cold_ms(lambda: paged_attention_decode_ref(*timed)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
           "library": "torch.nn.functional.scaled_dot_product_attention "
                      "(dense K/V, masked)", "ok": True}
    emit({"phase": "kernel", "kernel": "paged_attention_decode",
          "gpu": gpu, "cases": cases})
    return row


def attn_bytes(lens, D, H, KV, hd, BS, item):
    """Bytes one decode_attn_block launch must move: the four weight
    matrices and the norm weight, the live K and V rows (``lens`` tokens
    already in the pool per sequence), x in and out, k_new and v_new out,
    one f32 rope row pair per sequence, the lengths and the live table
    entries."""
    B = len(lens)
    n_tok = int(sum(int(n) for n in lens))
    n_pages = sum(-(-int(n) // BS) for n in lens)
    weights = (2 * D * H * hd + 2 * D * KV * hd + D) * item
    acts = (2 * B * D + 2 * B * KV * hd) * item + B * hd * 4
    return (weights + n_tok * KV * hd * 2 * item + acts + 4 * B
            + 4 * n_pages)


def attn_ops(lens, D, H, KV, hd):
    B = len(lens)
    attended = sum(int(n) + 1 for n in lens)
    return 2 * B * D * (H + 2 * KV) * hd + 2 * B * H * hd * D \
        + 4 * H * hd * attended


def fused_attn_inputs(gen, dt, KV, rope, B=B8):
    import torch
    D, H, hd, BS, MB = D7, H7, HD7, BS16, MB72
    full = MB * BS
    rand = torch.randint(2, full, (B - 6,), generator=gen, device="cuda")
    seq = torch.tensor([0, 1, BS - 1, BS, BS + 1, full - 1], device="cuda")
    seq_lens = torch.cat([seq, rand]).to(torch.int32)
    N = B * MB + 1
    perm = torch.randperm(N - 1, generator=gen, device="cuda") + 1
    tables = perm[:B * MB].reshape(B, MB).to(torch.int32).contiguous()

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * std).to(dt)
    x, nw = rn(B, D), (1 + 0.1 * torch.randn(D, generator=gen,
                                             device="cuda")).to(dt)
    wq, wk, wv = (rn(D, H * hd, std=0.02), rn(D, KV * hd, std=0.02),
                  rn(D, KV * hd, std=0.02))
    wo = rn(H * hd, D, std=0.02)
    kp, vp = rn(N, BS, KV, hd), rn(N, BS, KV, hd)
    return (x, nw, wq, wk, wv, wo, rope[0], rope[1], kp, vp, tables,
            seq_lens)


def _check_case(name, got, want, dt, f32_tol):
    """One output against the plain version: f32 allclose at ``f32_tol``,
    bf16 by :func:`bf16_close`. Returns the case's record."""
    import torch
    err = float((got.float() - want.float()).abs().max())
    if dt == torch.float32:
        ok = bool(torch.allclose(got, want, atol=f32_tol, rtol=f32_tol))
        return {"max_abs_err": err, "tol": f"atol=rtol={f32_tol}", "ok": ok}
    ok, worst = bf16_close(got, want)
    return {"max_abs_err": err, "tol": "2^-6 x (max(|got|,|want|) + "
            "rms(want)), 2 bf16 ulps", "worst_in_tol_units": worst / 2 ** -6,
            "ok": ok}


def _dispatched(fdb, B, KV, F, dt):
    """The variants dispatch picks at these shapes on the card."""
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    meta = fdb.decode_meta_dims(B, D7, H7, KV, HD7, F, BS16, MB72, dt, dt,
                                False)
    return [KERNELS.dispatch(op, meta)[0]
            for op in ("decode_attn_block", "decode_mlp_block")]


def fused_attn_phase(gpu):
    """decode_attn_block against attn_block_ref (the unfused composition:
    RMSNorm and paged-attention kernels, cuBLAS products) on the card.
    f32 holds the kernel to atol=rtol=1e-4 on x_out (a 4096-term product
    into an attention into another 4096-term product, summed in another
    order than cuBLAS) and 1e-5 on k_new/v_new (one product); bf16 to two
    ulps (bf16_close). Two launches on the same inputs must give the same
    bits: no sum uses atomics. At 20 and 32 slots dispatch must pick the
    kernel (its shared memory does not grow with B); the bf16 32-slot
    case is timed."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    from paddle_tpu_torch.ops.rope import build_rope_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    rope = build_rope_cache(4096, HD7, device="cuda")
    cases, max_err, timed = [], 0.0, None
    for dt, KV, B in ((torch.bfloat16, 32, B8), (torch.float32, 32, B8),
                      (torch.bfloat16, 8, B8), (torch.float32, 8, B8),
                      (torch.bfloat16, 32, 32), (torch.float32, 8, 20)):
        args = fused_attn_inputs(gen, dt, KV, rope, B)
        picked = _dispatched(fdb, B, KV, F7, dt)
        got = fdb.decode_attn_block_cuda(*args)
        again = fdb.decode_attn_block_cuda(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        want = fdb.attn_block_ref(*args)      # writes the new token's K/V
        torch.cuda.synchronize()
        outs = {}
        for nm, g, w, tol in (("x_out", got[0], want[0], 1e-4),
                              ("k_new", got[1], want[1], 1e-5),
                              ("v_new", got[2], want[2], 1e-5)):
            outs[nm] = _check_case(nm, g, w, dt, tol)
            max_err = max(max_err, outs[nm]["max_abs_err"])
        case = {"dtype": str(dt)[6:], "KV": KV, "B": B,
                "seq_lens": args[11].tolist(), "outputs": outs,
                "bitwise_repeatable": same, "dispatch": picked[0],
                "smem_bytes": fdb.attn_smem_bytes(
                    D7, H7, KV, HD7, BS16, args[0].element_size()),
                "ok": same and picked[0] == "cuda_fused"
                and all(o["ok"] for o in outs.values())}
        if B == 32:
            case["ms"] = cold_ms(lambda: fdb.decode_attn_block_cuda(*args))
        cases.append(case)
        if not case["ok"]:
            emit({"phase": "kernel", "kernel": "decode_attn_block",
                  "gpu": gpu, "cases": cases})
            raise AssertionError(f"decode_attn_block disagrees: {case}")
        if dt == torch.bfloat16 and KV == H7 and B == B8:
            timed = args
    x, nw, wq, wk, wv, wo = timed[:6]
    lens = timed[11].tolist()
    b_ms, b_by = bound(attn_bytes(lens, D7, H7, H7, HD7, BS16, 2),
                       attn_ops(lens, D7, H7, H7, HD7), "bfloat16")
    h, a = torch.randn_like(x), torch.randn_like(x)
    row = {"name": "decode_attn_block", "route": "cuda",
           "source": FUSED_SOURCE,
           "replaces": "paddle_tpu/ops/pallas/fused_decode_block.py:436",
           "shape": {"B": B8, "D": D7, "H": H7, "KV": H7, "hd": HD7,
                     "BS": BS16, "MB": MB72, "seq_lens": lens},
           "dtype": "bfloat16", "max_abs_err": max_err,
           "ms": cold_ms(lambda: fdb.decode_attn_block_cuda(*timed)),
           "plain_ms": cold_ms(lambda: fdb.attn_block_ref(*timed)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "library": "none: no single PyTorch call computes the block",
           "matmul_ms": cold_ms(lambda: (h @ wq, h @ wk, h @ wv, a @ wo)),
           "ok": True}
    emit({"phase": "kernel", "kernel": "decode_attn_block", "gpu": gpu,
          "cases": cases})
    return row


def mlp_timing(fdb, args):
    """decode_mlp_block's time at ``args`` (bf16) beside its bound, its
    plain version's time and its three products alone."""
    import torch
    x, nw, wg, wu, wd = args
    R, D = x.shape
    F = wg.shape[1]
    b_ms, b_by = bound((3 * D * F + 2 * R * D + D) * 2, 6 * R * D * F,
                       "bfloat16")
    h, ff = torch.randn_like(x), torch.randn(R, F, device="cuda").to(x.dtype)
    return {"ms": cold_ms(lambda: fdb.decode_mlp_block_cuda(*args)),
            "plain_ms": cold_ms(lambda: fdb.mlp_block_ref(*args)),
            "bound_ms": b_ms, "bound_by": b_by,
            "matmul_ms": cold_ms(lambda: (h @ wg, h @ wu, ff @ wd))}


def fused_mlp_phase(gpu):
    """decode_mlp_block against mlp_block_ref on the card, at F=11008 and
    at an F no tile width divides (the last F tile masked), f32 and bf16,
    8, 20 and 32 slots and 32 and 128 rows (the prefill MLP's chunks),
    tolerances as for the attention block (x_out at 1e-4 in f32); the bf16
    cases of 32 and 128 rows are timed beside their bound."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases, max_err, timed = [], 0.0, None
    # 11000 = 8 * 1375: no bf16 tile (16, 32, 64) divides it; 11012 = 4 *
    # 2753: no f32 tile (8, 16, 32) divides it
    rows = {}
    for dt, F, B in ((torch.bfloat16, F7, B8), (torch.float32, F7, B8),
                     (torch.bfloat16, 11000, B8), (torch.float32, 11012, B8),
                     (torch.bfloat16, F7, 32), (torch.float32, 11012, 20),
                     (torch.float32, F7, 32), (torch.bfloat16, F7, 128),
                     (torch.float32, F7, 128)):
        def rn(*shape, std=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda")
                    * std).to(dt)
        picked = _dispatched(fdb, B, H7, F, dt)
        args = (rn(B, D7), (1 + 0.1 * torch.randn(
            D7, generator=gen, device="cuda")).to(dt),
            rn(D7, F, std=0.02), rn(D7, F, std=0.02), rn(F, D7, std=0.02))
        got = fdb.decode_mlp_block_cuda(*args)
        again = fdb.decode_mlp_block_cuda(*args)
        want = fdb.mlp_block_ref(*args)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        out = _check_case("x_out", got, want, dt, 1e-4)
        max_err = max(max_err, out["max_abs_err"])
        case = {"dtype": str(dt)[6:], "F": F, "B": B, "output": out,
                "bitwise_repeatable": same, "dispatch": picked[1],
                "smem_bytes": fdb.mlp_smem_bytes(D7, args[0].element_size()),
                "ok": out["ok"] and same and picked[1] == "cuda_fused"}
        if dt == torch.bfloat16 and F == F7 and B in (32, 128):
            rows[B] = mlp_timing(fdb, args)
            case["ms"] = rows[B]["ms"]
        cases.append(case)
        if not case["ok"]:
            emit({"phase": "kernel", "kernel": "decode_mlp_block",
                  "gpu": gpu, "cases": cases})
            raise AssertionError(f"decode_mlp_block disagrees: {case}")
        if dt == torch.bfloat16 and F == F7 and B == B8:
            timed = args
    x, nw, wg, wu, wd = timed
    b_ms, b_by = bound((3 * D7 * F7 + 2 * B8 * D7 + D7) * 2,
                       6 * B8 * D7 * F7, "bfloat16")
    h, ff = torch.randn_like(x), torch.randn(B8, F7, device="cuda").to(x.dtype)
    row = {"name": "decode_mlp_block", "route": "cuda",
           "source": FUSED_SOURCE,
           "replaces": "paddle_tpu/ops/pallas/fused_decode_block.py:645",
           "shape": {"B": B8, "D": D7, "F": F7}, "dtype": "bfloat16",
           "max_abs_err": max_err,
           "ms": cold_ms(lambda: fdb.decode_mlp_block_cuda(*timed)),
           "plain_ms": cold_ms(lambda: fdb.mlp_block_ref(*timed)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "library": "none: no single PyTorch call computes the block",
           "matmul_ms": cold_ms(lambda: (h @ wg, h @ wu, ff @ wd)),
           "prefill_rows": rows, "ok": True}
    emit({"phase": "kernel", "kernel": "decode_mlp_block", "gpu": gpu,
          "cases": cases, "prefill_rows": rows})
    return row


def prefill_bytes(P, n, pos0, D, H, KV, hd, BS, item):
    """Bytes one prefill_attn_block launch must move: the four weight
    matrices and the norm weight, the real rows of x in and every row of
    x_out, k_new and v_new out, the chunk's f32 rope rows, the history's
    K and V rows (``pos0`` tokens) and its table entries."""
    weights = (2 * D * H * hd + 2 * D * KV * hd + D) * item
    acts = (n * D + P * D + 2 * P * KV * hd) * item + P * hd * 4
    return (weights + acts + 2 * pos0 * KV * hd * item
            + 4 * -(-pos0 // BS))


def prefill_ops(n, pos0, D, H, KV, hd):
    """Multiply-adds x 2 of the real rows: the four products, and q.k and
    p.v over each row's history and its chunk prefix."""
    attended = sum(pos0 + r + 1 for r in range(n))
    return 2 * n * D * (H + 2 * KV) * hd + 2 * n * H * hd * D \
        + 4 * H * hd * attended


PREFILL_CASES = ((0, 0), (0, 1), (0, -3), (5, -3), (16, 0), (600, None))


def prefill_attn_phase(gpu):
    """prefill_attn_block against prefill_attn_block_ref (the dense
    composition: the RMSNorm kernel, cuBLAS products, attention over the
    gathered view) on the card, at LLaMA-7B widths with KV=32 and KV=8,
    f32 (TF32 off) and bf16, chunks of 32 and 128 rows, a permuted table
    of 72 pages, and the (pos0, n_valid) cases of PREFILL_CASES (n_valid
    0 = P, negative = P minus it, None = 21 at P=32 and 77 at P=128).
    The real rows of x_out (f32 1e-4), k_new and v_new (f32 1e-5) must
    agree, bf16 to two ulps (bf16_close); every row of x_out must be
    finite; two launches must give the same bits. Dispatch must pick the
    kernel at every shape. Timed at P=128, bf16, KV=32, pos0 0 and 512."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    from paddle_tpu_torch.ops.rope import build_rope_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    D, H, hd, BS, MB = D7, H7, HD7, BS16, MB72
    sin, cos = build_rope_cache(MB * BS, hd, device="cuda")
    cases, max_err, timed = [], 0.0, {}
    for dt in (torch.bfloat16, torch.float32):
        def rn(*shape, std=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda")
                    * std).to(dt)
        for KV in (H, 8):
            perm = torch.randperm(MB, generator=gen, device="cuda") + 1
            table = perm.to(torch.int32).contiguous()
            weights = (
                (1 + 0.1 * torch.randn(D, generator=gen,
                                       device="cuda")).to(dt),
                rn(D, H * hd, std=0.02), rn(D, KV * hd, std=0.02),
                rn(D, KV * hd, std=0.02), rn(H * hd, D, std=0.02))
            kp, vp = rn(MB + 1, BS, KV, hd), rn(MB + 1, BS, KV, hd)
            for P in (32, 128):
                meta = fpb.prefill_meta_dims(P, D, H, KV, hd, F7, BS, MB, dt,
                                             dt, False)
                picked = KERNELS.dispatch("prefill_attn_block", meta)[0]
                for pos0, nv in PREFILL_CASES:
                    n = ({32: 21, 128: 77}[P] if nv is None
                         else P + nv if nv <= 0 else nv)
                    args = (rn(P, D), *weights, sin[pos0:pos0 + P],
                            cos[pos0:pos0 + P], kp, vp, table, pos0, n)
                    got = fpb.prefill_attn_block_cuda(*args)
                    again = fpb.prefill_attn_block_cuda(*args)
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    want = fpb.prefill_attn_block_ref(*args)
                    torch.cuda.synchronize()
                    outs = {}
                    for nm, g, w, tol in (("x_out", got[0], want[0], 1e-4),
                                          ("k_new", got[1], want[1], 1e-5),
                                          ("v_new", got[2], want[2], 1e-5)):
                        outs[nm] = _check_case(nm, g[:n], w[:n], dt, tol)
                        max_err = max(max_err, outs[nm]["max_abs_err"])
                    finite = bool(torch.isfinite(got[0]).all())
                    case = {"dtype": str(dt)[6:], "KV": KV, "P": P,
                            "pos0": pos0, "n_valid": n, "outputs": outs,
                            "pad_rows_finite": finite,
                            "bitwise_repeatable": same, "dispatch": picked,
                            "ok": same and finite and picked == "cuda_fused"
                            and all(o["ok"] for o in outs.values())}
                    cases.append(case)
                    if not case["ok"]:
                        emit({"phase": "kernel", "kernel":
                              "prefill_attn_block", "gpu": gpu,
                              "cases": cases})
                        raise AssertionError(
                            f"prefill_attn_block disagrees: {case}")
            if dt == torch.bfloat16 and KV == H:
                for pos0 in (0, 512):
                    args = (rn(128, D), *weights, sin[pos0:pos0 + 128],
                            cos[pos0:pos0 + 128], kp, vp, table, pos0, 128)
                    timed[pos0] = prefill_timing(fpb, F, args)
    row = {"name": "prefill_attn_block", "route": "cuda",
           "source": PREFILL_SOURCE,
           "replaces": "paddle_tpu/ops/pallas/fused_prefill_block.py:431",
           "shape": {"P": 128, "n_valid": 128, "pos0": 512, "D": D, "H": H,
                     "KV": H, "hd": hd, "BS": BS, "MB": MB},
           "dtype": "bfloat16", "max_abs_err": max_err,
           **{k: timed[512][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "matmul_ms",
                                         "sdpa_ms")},
           "library_ms": None,
           "library": "none: no single PyTorch call computes the block",
           "at_pos0_0": timed[0], "ok": True}
    emit({"phase": "kernel", "kernel": "prefill_attn_block", "gpu": gpu,
          "cases": cases, "timed": timed})
    return row


def prefill_timing(fpb, F, args):
    """prefill_attn_block's time at ``args`` (bf16, KV = H) beside its
    bound, its plain version's time, its four products alone
    (``torch.matmul``, the yardstick) and SDPA over its attention alone
    (the history gathered densely beforehand, not timed; information)."""
    import torch
    x, nw, wq, wk, wv, wo, sin, cos, kp, vp, table, pos0, n = args
    P, D = x.shape
    _, BS, KV, hd = kp.shape
    H = wq.shape[1] // hd
    b_ms, b_by = bound(
        prefill_bytes(P, n, pos0, D, H, KV, hd, BS, x.element_size()),
        prefill_ops(n, pos0, D, H, KV, hd), "bfloat16")
    h, a = torch.randn_like(x), torch.randn_like(x)
    T = pos0 + P
    q = torch.randn(1, H, P, hd, device="cuda").to(x.dtype)
    kd = kp[table.long()].reshape(-1, KV, hd)[:T].transpose(0, 1)[None]
    vd = vp[table.long()].reshape(-1, KV, hd)[:T].transpose(0, 1)[None]
    mask = (torch.arange(T, device="cuda")[None, :]
            <= pos0 + torch.arange(P, device="cuda")[:, None])
    return {"pos0": pos0, "n_valid": n,
            "ms": cold_ms(lambda: fpb.prefill_attn_block_cuda(*args)),
            "plain_ms": cold_ms(lambda: fpb.prefill_attn_block_ref(*args)),
            "bound_ms": b_ms, "bound_by": b_by,
            "matmul_ms": cold_ms(lambda: (h @ wq, h @ wk, h @ wv, a @ wo)),
            "sdpa_ms": cold_ms(lambda: F.scaled_dot_product_attention(
                q, kd, vd, attn_mask=mask))}


def parity_phase(gpu):
    """Route parity, f32 at LLaMA-7B widths with 2 layers: the engine on
    its default route (the prefill and decode-block CUDA kernels) and on
    the unfused route (paged-attention and RMSNorm kernels, the verbatim
    prefill chunk), each against the port's dense ``generate``. Tokens
    must be equal, or the first divergence must sit on a near tie (top-2
    logit gap < 1e-4)."""
    import dataclasses
    import torch
    from paddle_tpu_torch.inference import (GenerationConfig,
                                            ServingEngine, generate)
    from paddle_tpu_torch.inference.generation import (cached_forward,
                                                       init_cache)
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LLAMA_7B, num_hidden_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, seed=1)
    specs = [(5, 6), (40, 4), (300, 5), (17, 3), (129, 5)]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, S).astype(np.int32)
               for S, _ in specs]
    wants = [generate(params, p[None], cfg,
                      GenerationConfig(max_new_tokens=N, greedy=True)
                      )[0, S:].tolist()
             for p, (S, N) in zip(prompts, specs)]
    routes = {}
    for route, fused in (("fused", None), ("unfused", False)):
        eng = ServingEngine(params, cfg, capacity=2, block_size=16,
                            max_seq_len=512, prefill_buckets=(32, 128),
                            fused_decode=fused, fused_prefill=fused)
        reqs = [eng.submit(p, GenerationConfig(max_new_tokens=N,
                                               greedy=True))
                for p, (_, N) in zip(prompts, specs)]
        eng.drain()
        results = []
        for (S, N), p, r, want in zip(specs, prompts, reqs, wants):
            res = {"S": S, "N": N, "match": r.tokens == want}
            if not res["match"]:
                j = next(i for i, (a, b) in enumerate(zip(r.tokens, want))
                         if a != b)
                prefix = torch.tensor([[int(t) for t in p] + want[:j]],
                                      device="cuda")
                kc, vc = init_cache(cfg, 1, prefix.shape[1])
                logits, _, _ = cached_forward(params, prefix, cfg, kc, vc, 0)
                top2 = torch.topk(logits[0, -1].float(), 2).values
                res.update(first_divergent_step=j,
                           top2_logit_gap=float(top2[0] - top2[1]))
            results.append(res)
        routes[route] = {"decode_variant": eng.decode_variant,
                         "prefill_variant": eng.prefill_variant,
                         "requests": results,
                         "tokens": [r.tokens for r in reqs]}
    routes["fused_equals_unfused"] = (routes["fused"]["tokens"]
                                      == routes["unfused"]["tokens"])
    emit({"phase": "parity", "gpu": gpu, "dtype": "float32", "layers": 2,
          **{k: ({kk: vv for kk, vv in v.items() if kk != "tokens"}
                 if isinstance(v, dict) else v) for k, v in routes.items()}})
    _check_default_route(routes["fused"], "parity engine")
    for route in ("fused", "unfused"):
        for res in routes[route]["requests"]:
            if not res["match"] and res["top2_logit_gap"] >= 1e-4:
                raise AssertionError(
                    f"{route} engine and generate diverge: {res}")


DEFAULT_ROUTE = {
    "decode_variant": {"mode": "auto", "block": "composed",
                       "attn": "cuda_fused", "mlp": "cuda_fused"},
    "prefill_variant": {"mode": "auto", "attn": "cuda_fused",
                        "mlp": "cuda_fused"}}


def _check_default_route(variants, what):
    """The engine's default route must run the CUDA kernels for both the
    prefill chunk and the decode step."""
    got = {k: variants[k] for k in DEFAULT_ROUTE}
    if got != DEFAULT_ROUTE:
        raise AssertionError(f"{what} is not on the CUDA kernels: {got}")


SERVE_REQUESTS, SERVE_NEW = 12, 64


def serving_phase(gpu, params, fused):
    """LLaMA-7B at full depth, bf16, 8 slots, 12 requests, on the default
    route (``fused`` None: both knobs left at their default) or the
    unfused one (``fused`` False: ``fused_decode=False,
    fused_prefill=False``). The launch counts are set to 0 just before
    the requests go in and read just after the engine drains."""
    import torch
    from paddle_tpu_torch.inference import GenerationConfig, ServingEngine
    from paddle_tpu_torch.models import LLAMA_7B
    from paddle_tpu_torch.ops import kernels
    cfg = LLAMA_7B
    L = cfg.num_hidden_layers
    eng = ServingEngine(params, cfg, capacity=8, block_size=16,
                        max_seq_len=1024, prefill_buckets=(32, 128),
                        fused_decode=fused, fused_prefill=fused)
    rng = np.random.default_rng(0)
    lens = rng.integers(40, 601, SERVE_REQUESTS)
    gen = GenerationConfig(max_new_tokens=SERVE_NEW, greedy=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    t0 = time.perf_counter()
    reqs = [eng.submit(p, gen) for p in prompts]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    m = eng.metrics()
    steps, chunks = m["decode_steps"], m["prefill_chunks"]
    route = "fused" if fused is None else "unfused"
    emit({"phase": "serving", "route": route, "gpu": gpu,
          "model": "LLAMA_7B", "layers": L, "dtype": "bfloat16",
          "requests": len(reqs), "prompt_tokens": [int(n) for n in lens],
          "decode_variant": m["decode_variant"],
          "prefill_variant": m["prefill_variant"],
          "wall_s": round(wall, 3),
          "tokens_per_sec": m["tokens_per_sec"],
          "prefill_tokens_per_sec": m["prefill_tokens_per_sec"],
          "ttft_ms_mean": m["ttft_ms_mean"],
          "ttft_ms_max": m["ttft_ms_max"],
          "decode_step_ms_mean": m["decode_step_ms_mean"],
          "decode_steps": steps, "prefill_chunks": chunks,
          "slot_utilization": m["slot_utilization"],
          "launches": counts,
          "peak_memory_gb": round(torch.cuda.max_memory_allocated()
                                  / 2 ** 30, 3)})
    for r in reqs:
        if not (r.done and len(r.tokens) == SERVE_NEW):
            raise AssertionError(f"request {r.req_id} unfinished: "
                                 f"{len(r.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.req_id}: token out of range")
    if route == "fused":
        # the prefill MLP is decode_mlp_block over the chunk's rows; the
        # final norm of every chunk and step is the RMSNorm kernel
        want = {"prefill_attn_block": L * chunks,
                "decode_attn_block": L * steps,
                "decode_mlp_block": L * (steps + chunks),
                "paged_attention_decode": 0, "rms_norm_fwd": steps + chunks}
        _check_default_route(m, "main path")
    else:
        want = {"prefill_attn_block": 0, "decode_attn_block": 0,
                "decode_mlp_block": 0, "paged_attention_decode": L * steps,
                "rms_norm_fwd": (2 * L + 1) * (steps + chunks)}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"{route} launches {counts} != {want} "
                             f"({steps} decode steps, {chunks} chunks)")
    return counts, eng, prompts, [r.tokens for r in reqs]


def routes_phase(gpu, params, prompts, routes):
    """The bf16 greedy ids of the two engine routes and of dense bf16
    ``generate`` on the serving phase's requests, compared pairwise: the
    common prefix of each request and, at each first divergence, the
    top-2 gap of dense bf16 logits on the common prefix (with the top
    logit, to read the gap in bf16 ulps). Informational: in bf16 the
    routes round at other places, so near ties part them."""
    import torch
    from paddle_tpu_torch.inference import GenerationConfig, generate
    from paddle_tpu_torch.inference.generation import (cached_forward,
                                                       init_cache)
    from paddle_tpu_torch.models import LLAMA_7B
    cfg = LLAMA_7B
    gen = GenerationConfig(max_new_tokens=SERVE_NEW, greedy=True)
    t0 = time.perf_counter()
    routes = dict(routes, dense=[
        generate(params, p[None], cfg, gen)[0, len(p):].tolist()
        for p in prompts])
    dense_s = time.perf_counter() - t0

    def gap_at(prompt, prefix):
        ids = torch.tensor([[int(t) for t in prompt] + list(prefix)],
                           device="cuda")
        kc, vc = init_cache(cfg, 1, ids.shape[1])
        logits, _, _ = cached_forward(params, ids, cfg, kc, vc, 0)
        top2 = torch.topk(logits[0, -1].float(), 2).values
        return float(top2[0] - top2[1]), float(top2[0])

    pairs = {}
    for a, b in (("fused", "unfused"), ("unfused", "dense"),
                 ("fused", "dense")):
        rows = []
        for p, ta, tb in zip(prompts, routes[a], routes[b]):
            j = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                     len(ta))
            row = {"common_prefix": j}
            if j < len(ta):
                row["top2_gap"], row["top1"] = gap_at(p, ta[:j])
            rows.append(row)
        pairs[f"{a}_vs_{b}"] = {
            "requests_equal": sum(r["common_prefix"] == SERVE_NEW
                                  for r in rows),
            "common_prefix": [r["common_prefix"] for r in rows],
            "top2_gap": [r.get("top2_gap") for r in rows],
            "top1": [r.get("top1") for r in rows]}
    emit({"phase": "routes", "gpu": gpu, "dtype": "bfloat16",
          "requests": len(prompts), "new_tokens": SERVE_NEW,
          "dense_generate_s": round(dense_s, 3), **pairs})


def _kernel_group(name):
    for op in ("prefill_attn_block", "decode_attn_block", "decode_mlp_block",
               "paged_attention_decode"):
        if op in name:
            return op
    if "rms_fwd" in name:
        return "rms_norm_fwd"
    if any(s in name.lower() for s in ("gemm", "gemv", "cutlass", "xmma",
                                       "nvjet", "cublas", "splitk")):
        return "matmul"
    return "other"


def _device_groups(prof, per):
    """Device activities (kernels, copies) of a torch.profiler run, per
    ``per`` steps or chunks: ({name: (ms, count)}, {group: [ms, count]})."""
    import torch
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + e.time_range.elapsed_us() / 1e3 / per,
                               n + 1 / per)
    groups = {}
    for name, (ms, n) in kernels.items():
        g = groups.setdefault(_kernel_group(name), [0.0, 0.0])
        g[0] += ms
        g[1] += n
    return kernels, groups


def _rounded(groups):
    return {k: {"ms": round(v[0], 3), "launches": round(v[1], 2)}
            for k, v in sorted(groups.items())}


def _timed_chunks(eng):
    """Wrap the engine's two chunk programs so that each chunk records
    CUDA events around it: returns the list of (bucket, start, end) that
    fills as chunks run, and a switch to pause recording."""
    import torch
    record = {"on": True, "events": []}
    for attr in ("_prefill_chunk", "_prefill_chunk_fused"):
        fn = getattr(eng, attr)

        def timed(toks, *a, _fn=fn):
            if not record["on"]:
                return _fn(toks, *a)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _fn(toks, *a)
            end.record()
            record["events"].append((int(toks.shape[1]), start, end))
            return out
        setattr(eng, attr, timed)
    return record


def profile_phase(gpu, eng, route, steps=10, prompt=384):
    """Where a prefill chunk's and a decode step's time go, after the
    serving phase (its launches are not counted there): 8 fresh requests
    of ``prompt`` tokens (about the serving phase's median) fill every
    slot. The first request's first two chunks run alone (no slot decodes
    yet) under torch.profiler: device time per chunk by kernel group.
    Every later chunk is timed with CUDA events around it (ms per chunk
    by bucket). Then ``steps`` steps that only decode are timed as they
    run, and ``steps`` more under torch.profiler. Device time is summed
    per kernel from the profiled steps; busy share = device time /
    unprofiled step time. Each kernel of the route is held against its
    byte bound at the profiled lengths."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import GenerationConfig
    rng = np.random.default_rng(2)
    chunks = -(-prompt // eng.buckets[-1])
    gen = GenerationConfig(
        max_new_tokens=2 * steps + chunks * eng.capacity + 4, greedy=True)
    for _ in range(eng.capacity):
        eng.submit(rng.integers(0, eng.cfg.vocab_size, prompt)
                   .astype(np.int32), gen)
    record = _timed_chunks(eng)
    record["on"] = False
    cfg = eng.cfg
    traced = 2            # chunks at pos0 0 and P of the first request
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            eng.step()
        torch.cuda.synchronize()
    _, chunk_groups = _device_groups(prof, traced)
    record["on"] = True
    while any(s.phase != "decode" for s in eng._slots):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    by_bucket = {}
    for P, start, end in record["events"]:
        by_bucket.setdefault(P, []).append(start.elapsed_time(end))
    chunk_ms = {str(P): {"chunks": len(v), "ms_mean": float(np.mean(v)),
                         "ms_max": float(np.max(v))}
                for P, v in sorted(by_bucket.items())}
    record["on"] = False
    H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    item = eng._k_pools.element_size()
    prefill = {"chunks_traced": traced,
               "per_chunk_by_group": _rounded(chunk_groups),
               "device_ms_per_chunk": round(sum(
                   v[0] for v in chunk_groups.values()), 3),
               "chunk_ms_by_bucket": chunk_ms}
    ms, n = chunk_groups.get("prefill_attn_block", [0.0, 0.0])
    if n:
        P = eng.buckets[-1]
        nbytes = float(np.mean([prefill_bytes(
            P, P, pos0, cfg.hidden_size, H, KV, hd, eng.block_size, item)
            for pos0 in range(0, traced * P, P)]))
        prefill["prefill_attn_block_per_launch"] = {
            "bytes": nbytes, "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
            "us": ms / n * 1e3}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    # tokens already in the pool for each slot at each profiled step
    lens = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            lens.append([s.seq_len for s in eng._slots
                         if s.phase == "decode"])
            eng.step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels, groups = _device_groups(prof, steps)
    device_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    per_launch = {}
    byte_models = {
        # attention over cached tokens + the new one
        "paged_attention_decode": lambda ls: paged_bytes(
            [n + 1 for n in ls], H, KV, hd, eng.block_size, item),
        "decode_attn_block": lambda ls: attn_bytes(
            ls + [0] * (eng.capacity - len(ls)), cfg.hidden_size, H, KV, hd,
            eng.block_size, item),
        "decode_mlp_block": lambda ls: (
            3 * cfg.hidden_size * cfg.intermediate_size
            + (2 * eng.capacity + 1) * cfg.hidden_size) * item,
    }
    for op, model in byte_models.items():
        ms, n = groups.get(op, [0.0, 0.0])
        if not n:
            continue
        nbytes = float(np.mean([model(ls) for ls in lens]))
        us = ms / n * 1e3
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        per_launch[op] = {"bytes": nbytes, "bound_us": bound_us, "us": us,
                          "x_bound": us / bound_us}
    emit({"phase": "profile", "route": route, "gpu": gpu,
          "prefill": prefill,
          "decode_steps": steps, "live_slots": eng.capacity,
          "live_tokens_mean": float(np.mean([sum(ls) for ls in lens])),
          "step_ms": round(step_ms, 3),
          "profiled_step_ms": round(profiled_ms, 3),
          "device_ms_per_step": round(device_ms, 3),
          "device_busy_share": round(device_ms / step_ms, 4),
          "device_activities_per_step": round(
              sum(n for _, n in kernels.values()), 2),
          "per_step_by_group": _rounded(groups),
          "per_launch": per_launch,
          "top_kernels": [{"name": k[:120], "ms_per_step": round(ms, 4),
                           "launches_per_step": round(n, 2)}
                          for k, (ms, n) in top]})
    eng.drain()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    import paddle_tpu_torch  # noqa: F401  (fails outside the repository)
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    gpu = gpu_line()
    build_kernels()
    rows = [paged_phase(gpu), rms_phase(gpu), fused_attn_phase(gpu),
            fused_mlp_phase(gpu), prefill_attn_phase(gpu)]
    parity_phase(gpu)
    params = init_params(LLAMA_7B, seed=0)
    fused_counts, eng, prompts, fused_tokens = serving_phase(gpu, params,
                                                             None)
    profile_phase(gpu, eng, "fused")
    del eng
    unfused_counts, eng, _, unfused_tokens = serving_phase(gpu, params,
                                                           False)
    profile_phase(gpu, eng, "unfused")
    del eng
    routes_phase(gpu, params, prompts,
                 {"fused": fused_tokens, "unfused": unfused_tokens})
    for row in rows:
        # each kernel's launches on the serving phase of the route that
        # runs it (RMSNorm runs on both; the main path's count is kept)
        counts = (unfused_counts if row["name"] == "paged_attention_decode"
                  else fused_counts)
        row["launches"] = counts[row["name"]]
        row["gpu"] = gpu
        # ms and max_abs_err, also under their longer names
        row["kernel_ms"], row["max_err"] = row["ms"], row["max_abs_err"]
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
