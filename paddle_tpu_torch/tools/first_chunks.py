#!/usr/bin/env python3
"""Where a fresh serving engine's first chunks and steps spend their time,
on one GPU.

    python3 paddle_tpu_torch/tools/first_chunks.py

Runs ``chip_smoke.serving_phase``'s default route (LLaMA-7B, 32 layers,
bf16, seeded random weights, 12 requests of 40-600 prompt tokens, 64 new
tokens, 8 slots) on two engines in turn in one process, with every
program call (``inference.program.Program``: a warm-up, a capture, a
replay; decode steps and prefill chunks alike) timed between device syncs,
and ``gc.collect()`` and ``torch.cuda.empty_cache()`` timed alone just
before each capture. Prints one JSON line: each engine's wall seconds,
TTFT mean, every call that was not a replay (a capture's graph nodes tell
the decode step, 347 nodes, from a chunk, 538) and the replays' median
ms. The syncs serialise what the engine overlaps: the wall and TTFT are
not the engine's own. It imports nothing of JAX or of ``paddle_tpu``.
"""
import gc
import json
import pathlib
import sys
import time

_ROOT = pathlib.Path(__file__).resolve().parents[2]


def main():
    sys.path.insert(0, str(_ROOT))
    import numpy as np
    import torch

    import chip_smoke as c
    from paddle_tpu_torch.inference import GenerationConfig, ServingEngine
    from paddle_tpu_torch.inference import program as pm
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    gpu = c.gpu_line()
    c.build_kernels()
    params = init_params(LLAMA_7B, seed=0)
    log = []
    real_cap, real_call = pm.Program._capture, pm.Program.__call__

    def cap(self):
        torch.cuda.synchronize()
        t = time.perf_counter()
        gc.collect()
        t_gc = time.perf_counter() - t
        t = time.perf_counter()
        torch.cuda.empty_cache()
        t_ec = time.perf_counter() - t
        t = time.perf_counter()
        real_cap(self)
        torch.cuda.synchronize()
        log.append({"what": "capture", "s": time.perf_counter() - t,
                    "gc_s": t_gc, "empty_cache_s": t_ec,
                    "capture_s": self.capture_s, "nodes": self.nodes})

    def call(self, respec=None):
        what = "replay" if self.graph is not None else "warm"
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_call(self, respec)
        torch.cuda.synchronize()
        log.append({"what": what, "s": time.perf_counter() - t})

    pm.Program._capture, pm.Program.__call__ = cap, call
    out = []
    for trial in range(2):
        log.clear()
        eng = ServingEngine(params, LLAMA_7B, capacity=8, block_size=16,
                            max_seq_len=1024, prefill_buckets=(32, 128))
        rng = np.random.default_rng(0)
        lens = rng.integers(40, 601, c.SERVE_REQUESTS)
        gen = GenerationConfig(max_new_tokens=c.SERVE_NEW, greedy=True)
        t = time.perf_counter()
        for n in lens:
            eng.submit(rng.integers(0, LLAMA_7B.vocab_size, int(n))
                       .astype(np.int32), gen)
        eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        m = eng.metrics()
        reps = [e["s"] for e in log if e["what"] == "replay"]
        out.append({"trial": trial, "wall_s": wall,
                    "ttft_ms_mean": m["ttft_ms_mean"],
                    "not_replays": [e for e in log
                                    if e["what"] != "replay"],
                    "replays": len(reps),
                    "replay_ms_median": 1e3 * float(np.median(reps))})
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"gpu": gpu, "trials": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
