#!/usr/bin/env python3
"""Training metrics, the linear CE and the RMSNorm backward of one tree of
the port, for A/B runs of two commits on one GPU.

    python3 paddle_tpu_torch/tools/train_ab.py --root DIR

Imports ``chip_smoke`` and ``paddle_tpu_torch`` from the tree at ``DIR``
(so the same script drives a checkout of another commit), builds the
kernels the train step runs, then:

- times the linear CE at the train step's shape (T 4096, D 4096, V
  32000, bf16, untied head; inputs from a fixed seed, L2 flushed,
  ``chip_smoke.cold_ms``): the forward, over the untied and the tied head
  (the embedding [V, D] seen transposed); the backward's dx call, the dh
  call as ``LinearCE`` makes it (over the P dx's call keeps, where the
  tree's wrappers take one) and the pair;
- times the RMSNorm backward at [4096, 4096] bf16;
- runs ``chip_smoke.train_phase`` on the default route (the 1.07B rung,
  batch 2 x 2048): step ms, MFU, peak memory and the profiled step's
  device ms by group, the CE group being the three ``linear_ce_*``
  groups;

and prints one JSON line with the card's name and power limit. With
``--ce-memory`` it then runs the train phase once more with
``LinearCE``'s backward watched: the memory allocated when it starts and
the most allocated by its end, each step (the step's peak figure of that
run is then not the step's). With ``--nodes`` it instead reads the
captured train programs' graph nodes (``Program.nodes``, libcuda's
``cuGraphGetNodes``): GPT-2 small, BERT-base MLM and ViT-B/16 at the
models phase's widths and batches, and the 1.07B LLaMA rung on its default
and "ref" routes (bf16 moments, as the train phase), two steps each (the
warm-up and the capture); node counts are deterministic, so one run a tree
answers whether a change moved them. Run it for two
trees in one call, in turns (A, B, B, A), and compare within the call.
It imports nothing of JAX or of ``paddle_tpu``.
"""
import argparse
import inspect
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--ce-memory", action="store_true")
    ap.add_argument("--nodes", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import fused_train as kft
    from paddle_tpu_torch.ops.kernels import norms as kn
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    gpu = cs.gpu_line()
    if args.nodes:
        cs.build_kernels()
        print(json.dumps({"root": root, "gpu": gpu,
                          "graph_nodes": _nodes(torch, cs)}), flush=True)
        return 0
    _build.build(["flash_attention", "linear_ce"])
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(8)
    T, D, V = 4096, 4096, 32000
    x = (torch.randn(T, D, generator=gen, device="cuda") * 0.5).to(
        torch.bfloat16)
    head = (torch.randn(D, V, generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    lab = torch.randint(0, V, (T,), generator=gen, device="cuda")
    coef = torch.tensor([1.0 / T], device="cuda")
    emb = (torch.randn(V, D, generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    fwd = {"untied_ms": cs.cold_ms(lambda: kft.linear_ce_fwd_cuda(
        x, head, lab), iters=10),
        "tied_ms": cs.cold_ms(lambda: kft.linear_ce_fwd_cuda(
            x, emb.T, lab), iters=10)}
    del emb
    g = torch.randn(T, D, generator=gen, device="cuda").to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(
        torch.bfloat16)
    rms = {"ms": cs.cold_ms(lambda: kn.rms_norm_bwd_triton(x, w, g, 1e-6))}
    del g, w
    # nothing of this part stays allocated: the train phase's peak
    # counts what is live when it starts
    lse = kft.linear_ce_fwd_cuda(x, head, lab)[0]
    keeps = "keep_p" in inspect.signature(
        kft.linear_ce_bwd_dx_cuda).parameters

    def pair():
        if keeps:
            _, p = kft.linear_ce_bwd_dx_cuda(x, head, lab, lse, coef,
                                             keep_p=True)
            return kft.linear_ce_bwd_dh_cuda(x, head, lab, lse, coef, p=p)
        kft.linear_ce_bwd_dx_cuda(x, head, lab, lse, coef)
        return kft.linear_ce_bwd_dh_cuda(x, head, lab, lse, coef)
    ce = {"dx_call_ms": cs.cold_ms(lambda: kft.linear_ce_bwd_dx_cuda(
        x, head, lab, lse, coef), iters=10),
        "pair_ms": cs.cold_ms(pair, iters=10)}
    if keeps:
        dx, p = kft.linear_ce_bwd_dx_cuda(x, head, lab, lse, coef,
                                          keep_p=True)
        ce["dh_call_ms"] = cs.cold_ms(lambda: kft.linear_ce_bwd_dh_cuda(
            x, head, lab, lse, coef, p=p), iters=10)
        del dx, p
    else:
        ce["dh_call_ms"] = cs.cold_ms(lambda: kft.linear_ce_bwd_dh_cuda(
            x, head, lab, lse, coef), iters=10)
    del x, head, lab, lse
    torch.cuda.empty_cache()
    _, res = cs.train_phase(gpu, None)
    groups = res["profiled_step"]["by_group"]
    out = {"root": root, "gpu": gpu, "ce_forward": fwd, "ce_backward": ce,
           "rms_norm_bwd": rms,
           "train": {k: res[k] for k in (
               "step_ms_mean", "wall_ms_per_step", "tokens_per_sec", "mfu",
               "peak_memory_gb")},
           "device_ms": res["profiled_step"]["device_ms"],
           "busy_share": res["profiled_step"]["busy_share"],
           "ce_group_ms": round(sum(
               v["ms"] for k, v in groups.items()
               if k.startswith("linear_ce")), 3),
           "by_group": groups}
    if args.ce_memory:
        out["ce_memory_gb"] = _ce_memory(torch, cs, kft, gpu)
    print(json.dumps(out), flush=True)
    return 0


def _nodes(torch, cs):
    """{program: graph nodes} of the captured train steps (``--nodes``)."""
    import gc

    import numpy as np
    from paddle_tpu_torch.distributed import Trainer
    from paddle_tpu_torch.models import init_params, llama
    rng = np.random.default_rng(0)
    runs = []
    for name in ("gpt", "bert", "vit"):
        cfg = cs.model_config(name)
        runs.append((name, lambda n=name, c=cfg: (
            Trainer(cs.model_loss(n, c), lr=1e-4),
            cs.model_params(n, c, seed=0),
            cs._on_card(cs.model_batches(n, c, 1, 40, cs.MODELS[n])[0]))))
    for route in (None, "ref"):
        def rung(cfg=cs.train_config(fused_train=route)):
            toks = torch.as_tensor(rng.integers(
                0, cfg.vocab_size, (cs.TRAIN_RUNG["batch"],
                                    cs.TRAIN_RUNG["seq"])), device="cuda")
            return (Trainer(lambda p, t, lab: llama.loss_fn(p, t, lab, cfg),
                            lr=1e-4, moment_dtype=torch.bfloat16),
                    init_params(cfg, seed=0),
                    (toks, torch.roll(toks, -1, -1)))
        runs.append((f"llama_rung_{route or 'default'}", rung))
    nodes = {}
    for name, make in runs:
        tr, params, batch = make()
        state = tr.init_state(params)
        del params
        for _ in range(2):
            state, _ = tr.step(state, *batch)
        torch.cuda.synchronize()
        nodes[name] = cs.step_program(tr).nodes
        del tr, state, batch
        gc.collect()
        torch.cuda.empty_cache()
    return nodes


def _ce_memory(torch, cs, kft, gpu):
    """[(allocated when LinearCE's backward starts, the most allocated by
    its end)] of each step of a train phase, GiB."""
    backward = kft.LinearCE.backward
    seen = []

    def watched(ctx, g):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        out = backward(ctx, g)
        torch.cuda.synchronize()
        seen.append([start / 2 ** 30,
                     torch.cuda.max_memory_allocated() / 2 ** 30])
        return out
    kft.LinearCE.backward = staticmethod(watched)
    try:
        cs.train_phase(gpu, None)
    finally:
        kft.LinearCE.backward = staticmethod(backward)
    return [[round(v, 4) for v in s] for s in seen]


if __name__ == "__main__":
    sys.exit(main())
