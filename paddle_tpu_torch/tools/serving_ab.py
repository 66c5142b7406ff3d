#!/usr/bin/env python3
"""Serving metrics of one tree of the port, for A/B runs of two commits on
one GPU.

    python3 paddle_tpu_torch/tools/serving_ab.py --root DIR \
        [--routes two_stage ...]

Imports ``chip_smoke`` and ``paddle_tpu_torch`` from the tree at ``DIR``
(so the same script drives a checkout of another commit), builds its
kernels and runs ``chip_smoke.serving_phase`` (LLaMA-7B, 32 layers, bf16,
seeded random weights, 12 requests through 8 slots) on each route named,
then prints one JSON line: each route's decode-step ms (CUDA events),
tokens/s and TTFT, and the card's name and power limit. Run it for two
trees in one call, in turns (A, B, B, A), and compare within the call:
host-bound steps move between calls. It imports nothing of JAX or of
``paddle_tpu``.
"""
import argparse
import json
import os
import sys


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
    for route in args.routes:
        _, eng, _, _ = cs.serving_phase(gpu, params, route)
        m = eng.metrics()
        out["routes"][route] = {k: m.get(k) for k in (
            "decode_step_ms_mean", "tokens_per_sec", "ttft_ms_mean")}
        del eng
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
