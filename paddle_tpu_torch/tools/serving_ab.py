#!/usr/bin/env python3
"""Serving metrics of one tree of the port, for A/B runs of two commits on
one GPU.

    python3 paddle_tpu_torch/tools/serving_ab.py --root DIR \
        [--routes two_stage ...] [--kernel] [--generate-paged]

Imports ``chip_smoke`` and ``paddle_tpu_torch`` from the tree at ``DIR``
(so the same script drives a checkout of another commit), builds its
kernels and runs ``chip_smoke.serving_phase`` (LLaMA-7B, 32 layers, bf16,
seeded random weights, 12 requests through 8 slots) on each route named,
``chip_smoke.tp_serving_phase`` for a tensor-parallel route
(``tp1_psum``, ``tp2_psum``, ...: shards colocated on the card), then
prints one JSON line: each route's two passes (fresh engines; the
process's first pays its first launches): decode-step ms and prefill-chunk ms
(CUDA events around each chunk's prefill step, by bucket: mean, median,
and both over the chunks after each bucket's first two), tokens/s,
TTFT and the captured programs' graph nodes (the decode step's and each
bucket's chunk's, ``Program.nodes``), and the card's name and power
limit. ``--kernel`` adds
prefill_attn_block's time at P 128 (bf16, LLaMA-7B widths, pos0 0 and
512) through ``chip_smoke.prefill_timing``; ``--generate-paged`` adds
``generate_paged``'s ms a token (bf16, 4 prompts of 40-600 tokens, 32 new
tokens, default route, three passes over the 4, one call each) and its
ids. Run it for two trees
in one call, in turns (A, B, B, A), and compare within the call:
host-bound steps move between calls. It imports nothing of JAX or of
``paddle_tpu``.
"""
import argparse
import json
import os
import sys
import time

#: serving passes a route, each on a fresh engine
PASSES = 2


def _timed_chunks():
    """CUDA events around every prefill step that runs a chunk, on any
    engine (``ServingEngine._run_prefill``, which every tree has): returns
    the list of (bucket, start, end) events it fills."""
    import torch
    from paddle_tpu_torch.inference.serving import ServingEngine
    events = []
    run = ServingEngine._run_prefill

    def timed(self):
        P = next((self._bucket_for(min(s.req.prompt.size - s.prefill_pos,
                                       self.buckets[-1]))
                  for s in self._slots if s.phase == "prefill"), None)
        if P is None:
            return run(self)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(self)
        end.record()
        events.append((P, start, end))
        return out
    ServingEngine._run_prefill = timed
    return events


def _kernel(cs, torch):
    """prefill_attn_block at P 128, bf16, KV = H, pos0 0 and 512."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
    from paddle_tpu_torch.ops.rope import build_rope_cache
    gen = torch.Generator(device="cuda").manual_seed(5)
    D, H, hd, BS, MB = cs.D7, cs.H7, cs.HD7, cs.BS16, cs.MB72

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * std).to(torch.bfloat16)
    sin, cos = build_rope_cache(MB * BS, hd, device="cuda")
    table = (torch.randperm(MB, generator=gen, device="cuda") + 1).to(
        torch.int32)
    weights = ((1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(
        torch.bfloat16), rn(D, H * hd, std=0.02), rn(D, H * hd, std=0.02),
        rn(D, H * hd, std=0.02), rn(H * hd, D, std=0.02))
    kp, vp = rn(MB + 1, BS, H, hd), rn(MB + 1, BS, H, hd)
    out = {}
    for pos0 in (0, 512):
        args = (rn(128, D), *weights, sin[pos0:pos0 + 128],
                cos[pos0:pos0 + 128], kp, vp, table, pos0, 128)
        t = cs.prefill_timing(fpb, F, args)
        out[f"pos0_{pos0}"] = {k: t[k] for k in ("ms", "bound_ms",
                                                 "plain_ms")}
    return out


def _generate_paged(params, cfg, torch, np, passes=3):
    """generate_paged's ms a token over 4 prompts of 40-600 tokens (32 new,
    greedy, default route), ``passes`` times over the 4: each call's ms,
    the median of all, and the ids of the last pass."""
    from paddle_tpu_torch.inference import GenerationConfig, generate_paged
    lens = [int(n) for n in np.random.default_rng(3).integers(40, 601, 4)]
    g = GenerationConfig(max_new_tokens=32, greedy=True)
    ms, ids = [], []
    for _ in range(passes):
        ids = []
        for i, n in enumerate(lens):
            p = np.random.default_rng(10 + i).integers(
                0, cfg.vocab_size, (1, n)).astype(np.int32)
            torch.cuda.synchronize()
            t = time.perf_counter()
            o = generate_paged(params, p, cfg, g)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3 / 32)
            ids.append(o[0, n:].tolist())
    return {"prompt_tokens": lens, "ms_per_token": ms,
            "ms_per_token_mean": float(np.mean(ms)),
            "ms_per_token_median": float(np.median(ms)), "ids": ids}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--routes", nargs="*",
                    default=["two_stage", "unfused", "default"])
    ap.add_argument("--kernel", action="store_true")
    ap.add_argument("--generate-paged", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    gpu = cs.gpu_line()
    cs.build_kernels()
    out = {"root": root, "gpu": gpu, "routes": {}}
    if args.kernel:
        out["prefill_attn_block"] = _kernel(cs, torch)
    params = init_params(LLAMA_7B, seed=0)
    chunks = _timed_chunks()
    # every route's phase twice, each on a fresh engine: the first engine
    # of the process also pays the process's first launches (Triton's
    # JIT, cuBLAS's set-up) in its first chunks
    for route in [r for r in args.routes for _ in range(PASSES)]:
        chunks.clear()
        if route in cs.TP_ROUTES:
            _, eng = cs.tp_serving_phase(gpu, params, route)
        else:
            _, eng, _, _ = cs.serving_phase(gpu, params, route)
        m = eng.metrics()
        row = {k: m.get(k) for k in ("decode_step_ms_mean",
                                     "tokens_per_sec", "ttft_ms_mean",
                                     "ttft_ms_max")}
        torch.cuda.synchronize()
        by_bucket = {}
        for P, a, b in chunks:
            by_bucket.setdefault(str(P), []).append(a.elapsed_time(b))
        # each bucket's chunks after its first two (the change's warm-up
        # and capture), and all of them
        row["chunk_ms"] = {P: {
            "chunks": len(v), "mean": float(np.mean(v)),
            "median": float(np.median(v)), "first": v[:2],
            "steady_mean": float(np.mean(v[2:])) if v[2:] else None,
            "steady_median": float(np.median(v[2:])) if v[2:] else None}
            for P, v in by_bucket.items()}
        row["graph_nodes"] = {
            "decode": [p.nodes for p in eng._decode_fns.values()],
            "chunks": {str(k[0]): p.nodes
                       for k, p in eng._prefill_fns.items()}}
        out["routes"].setdefault(route, []).append(row)
        del eng
        torch.cuda.empty_cache()
    if args.generate_paged:
        out["generate_paged"] = _generate_paged(params, LLAMA_7B, torch, np)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
