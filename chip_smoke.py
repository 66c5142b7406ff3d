#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA H100. It builds
the port's kernels from the sources in the checkout (nvcc for the CUDA
C++, Triton's JIT for the Triton kernel) and prints one JSON line per
phase; a phase that fails raises, so the script exits non-zero:

1. GPU: the card's name and power limit, as ``nvidia-smi`` prints them.
2. kernels: every kernel of the serving path against its plain PyTorch
   version on the card, at the path's shapes, with its time (L2 flushed
   before every launch), its plain version's time, the time of one
   PyTorch library call computing the same function, and its bound.
3. parity: LLaMA-7B widths, 2 layers, f32: the ServingEngine's greedy
   tokens for 5 requests through 2 slots against the port's dense
   ``generate``.
4. serving: LLaMA-7B, 32 layers, bf16, random weights from a seeded
   ``torch.Generator`` on the card: 12 requests of 40-600 prompt tokens
   and 64 new tokens each through 8 slots. The kernels' launch counts are
   set to 0 just before this phase and read just after it: each kernel
   must have run there (paged attention once per layer per decode step,
   RMSNorm 2L+1 times per decode step and per prefill chunk).
5. profile: on the same engine, a window of decode steps with all 8
   slots live, timed and then traced with torch.profiler: device time
   per step by kernel and the card's busy share.

Then the ``kernels`` summary line (launch counts from the serving phase)
and, last, ``{"ok": true, "device": {...}}``. Without CUDA it exits 1
and prints no result. It imports nothing of JAX or of ``paddle_tpu``.
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
    CUDA events around every call, read after one final sync."""
    import torch
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()           # 256 MB: evicts the 50 MB L2
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


def build_kernels():
    """nvcc for the CUDA source, then Triton's compile of the RMSNorm
    kernel on a first launch."""
    import torch
    from paddle_tpu_torch.ops.kernels import _build, norms
    t0 = time.perf_counter()
    _build.load("paged_attention")
    t_nvcc = time.perf_counter() - t0
    x = torch.ones(2, 64, device="cuda")
    norms.rms_norm_fwd_triton(x, torch.ones(64, device="cuda"))
    torch.cuda.synchronize()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_s": round(t_nvcc, 3),
          "libraries": {"paged_attention": str(
              _build.library_path("paged_attention")
              .relative_to(_build.CSRC.parent.parent))}})


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
           "shape": {"B": B, "H": H, "KV": H, "hd": hd, "BS": BS, "MB": MB,
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


def parity_phase(gpu):
    """Engine (paged kernel + RMSNorm kernel) against dense generate, f32
    at LLaMA-7B widths with 2 layers."""
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
    eng = ServingEngine(params, cfg, capacity=2, block_size=16,
                        max_seq_len=512, prefill_buckets=(32, 128))
    rng = np.random.default_rng(1)
    specs = [(5, 6), (40, 4), (300, 5), (17, 3), (129, 5)]
    reqs = []
    for S, N in specs:
        p = rng.integers(0, cfg.vocab_size, S).astype(np.int32)
        reqs.append((p, eng.submit(p, GenerationConfig(max_new_tokens=N,
                                                       greedy=True))))
    eng.drain()
    results = []
    for (S, N), (p, r) in zip(specs, reqs):
        want = generate(params, p[None], cfg,
                        GenerationConfig(max_new_tokens=N, greedy=True)
                        )[0, S:].tolist()
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
    emit({"phase": "parity", "gpu": gpu, "dtype": "float32", "layers": 2,
          "requests": results})
    for res in results:
        if not res["match"] and res["top2_logit_gap"] >= 1e-4:
            raise AssertionError(f"engine and generate diverge: {res}")


def serving_phase(gpu):
    import torch
    from paddle_tpu_torch.inference import GenerationConfig, ServingEngine
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    from paddle_tpu_torch.ops import kernels
    cfg = LLAMA_7B
    L = cfg.num_hidden_layers
    params = init_params(cfg, seed=0)
    eng = ServingEngine(params, cfg, capacity=8, block_size=16,
                        max_seq_len=1024, prefill_buckets=(32, 128))
    rng = np.random.default_rng(0)
    lens = rng.integers(40, 601, 12)
    gen = GenerationConfig(max_new_tokens=64, greedy=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, int(n))
                       .astype(np.int32), gen) for n in lens]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    m = eng.metrics()
    steps, chunks = m["decode_steps"], m["prefill_chunks"]
    emit({"phase": "serving", "gpu": gpu, "model": "LLAMA_7B", "layers": L,
          "dtype": "bfloat16", "requests": len(reqs),
          "prompt_tokens": [int(n) for n in lens],
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
        if not (r.done and len(r.tokens) == 64):
            raise AssertionError(f"request {r.req_id} unfinished: "
                                 f"{len(r.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.req_id}: token out of range")
    if counts["paged_attention_decode"] != L * steps:
        raise AssertionError(f"paged_attention_decode launches "
                             f"{counts} != {L} x {steps} decode steps")
    if counts["rms_norm_fwd"] < (2 * L + 1) * steps:
        raise AssertionError(f"rms_norm_fwd launches {counts} < "
                             f"{2 * L + 1} x {steps} decode steps")
    return counts, eng


def _kernel_group(name):
    if "paged_attention" in name:
        return "paged_attention_decode"
    if "rms_fwd" in name:
        return "rms_norm_fwd"
    if any(s in name.lower() for s in ("gemm", "gemv", "cutlass", "xmma",
                                       "nvjet", "cublas", "splitk")):
        return "matmul"
    return "other"


def profile_phase(gpu, eng, steps=10, prompt=384):
    """Where one decode step's time goes, after the serving phase (its
    launches are not counted there): 8 fresh requests of ``prompt``
    tokens (about the serving phase's median) fill every slot; then
    ``steps`` steps that only decode are timed as they run, and ``steps``
    more under torch.profiler. Device time is summed per kernel from the
    profiled steps; busy share = device time / unprofiled step time."""
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
    while any(s.phase != "decode" for s in eng._slots):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    # lengths each paged-attention launch of the profiled steps attends
    # over (cached tokens + the new one), for its byte bound
    lens = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            lens.append([s.seq_len + 1 for s in eng._slots
                         if s.phase == "decode"])
            eng.step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = {}                 # device activities only (kernels, copies)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + e.time_range.elapsed_us() / 1e3 / steps,
                               n + 1 / steps)
    device_ms = sum(ms for ms, _ in kernels.values())
    groups = {}
    for name, (ms, n) in kernels.items():
        g = groups.setdefault(_kernel_group(name), [0.0, 0.0])
        g[0] += ms
        g[1] += n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    cfg = eng.cfg
    pa_bytes = float(np.mean([paged_bytes(
        ls, cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
        eng.block_size, eng._k_pools.element_size()) for ls in lens]))
    pa_ms, pa_n = groups.get("paged_attention_decode", [0.0, 0.0])
    pa_us = pa_ms / pa_n * 1e3 if pa_n else None
    pa_bound_us = pa_bytes / HBM_BYTES_PER_S * 1e6
    emit({"phase": "profile", "gpu": gpu, "decode_steps": steps,
          "live_slots": eng.capacity,
          "step_ms": round(step_ms, 3),
          "profiled_step_ms": round(profiled_ms, 3),
          "device_ms_per_step": round(device_ms, 3),
          "device_busy_share": round(device_ms / step_ms, 4),
          "per_step_by_group": {k: {"ms": round(v[0], 3),
                                    "launches": round(v[1], 2)}
                                for k, v in sorted(groups.items())},
          "paged_attention_per_launch": {
              "live_tokens_mean": float(np.mean([sum(ls) for ls in lens])),
              "bytes": pa_bytes, "bound_us": pa_bound_us, "us": pa_us,
              "x_bound": pa_us / pa_bound_us if pa_us else None},
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
    gpu = gpu_line()
    build_kernels()
    rows = [paged_phase(gpu), rms_phase(gpu)]
    parity_phase(gpu)
    counts, eng = serving_phase(gpu)
    profile_phase(gpu, eng)
    for row in rows:
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
