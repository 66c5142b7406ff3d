#!/usr/bin/env python3
"""Serving metrics of one tree of the port, for A/B runs of two commits on
one GPU.

    python3 paddle_tpu_torch/tools/serving_ab.py --root DIR \
        [--routes two_stage ...]

Imports ``chip_smoke`` and ``paddle_tpu_torch`` from the tree at ``DIR``
(so the same script drives a checkout of another commit), builds its
kernels and runs ``chip_smoke.serving_phase`` (LLaMA-7B, 32 layers, bf16,
seeded random weights, 12 requests through 8 slots) on each route named,
``chip_smoke.tp_serving_phase`` for a tensor-parallel route
(``tp1_psum``, ``tp2_psum``, ...: shards colocated on the card), then
prints one JSON line: each route's decode-step ms and prefill-chunk ms
(CUDA events around each), tokens/s and TTFT, and the card's name and
power limit. Run it for two
trees in one call, in turns (A, B, B, A), and compare within the call:
host-bound steps move between calls. It imports nothing of JAX or of
``paddle_tpu``.
"""
import argparse
import json
import os
import sys


def _timed_chunks():
    """CUDA events around every prefill chunk any engine runs: returns the
    list of (start, end) events it fills."""
    import torch
    from paddle_tpu_torch.inference.serving import ServingEngine
    events = []
    for attr in ("_prefill_chunk", "_prefill_chunk_fused"):
        fn = getattr(ServingEngine, attr)

        def timed(self, *a, _fn=fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _fn(self, *a)
            end.record()
            events.append((start, end))
            return out
        setattr(ServingEngine, attr, timed)
    return events


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--routes", nargs="+",
                    default=["two_stage", "unfused", "default"])
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    gpu = cs.gpu_line()
    cs.build_kernels()
    params = init_params(LLAMA_7B, seed=0)
    out = {"root": root, "gpu": gpu, "routes": {}}
    chunks = _timed_chunks()
    for route in args.routes:
        chunks.clear()
        if route in cs.TP_ROUTES:
            _, eng = cs.tp_serving_phase(gpu, params, route)
        else:
            _, eng, _, _ = cs.serving_phase(gpu, params, route)
        m = eng.metrics()
        out["routes"][route] = {k: m.get(k) for k in (
            "decode_step_ms_mean", "tokens_per_sec", "ttft_ms_mean")}
        torch.cuda.synchronize()
        out["routes"][route]["chunk_ms_mean"] = sum(
            a.elapsed_time(b) for a, b in chunks) / max(len(chunks), 1)
        del eng
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
