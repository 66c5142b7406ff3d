#!/usr/bin/env python3
"""The disaggregated engine's page handoff, timed on one GPU in the ways
PyTorch offers to gather pages off one pool and write them into another.

    python3 paddle_tpu_torch/tools/handoff_copy.py

Pools at LLaMA-7B (32 layers, 16-token pages, 32 KV heads of 128, bf16:
8 MiB a page across both pools): the prefill pool of 641 pages and the
decode pool of 513 that ``DisaggregatedEngine(capacity=8, prefill_slots=2,
max_seq_len=1024)`` builds, one page list of 38 (a 600-token prompt's, 304
MiB) and one of 8 (a 128-token chunk's partial window), scattered pages on
both sides. Each variant runs the extract (gather into a new block) and the
insert (write the block into the decode pool's pages) of both pools:

- ``index_select``: ``index_select``/``index_copy_`` on dim 1 of the
  [L, N, BS, KV, hd] pools (the engine's);
- ``bytes_view``: the same two ops on the pools viewed as [L, N, E] of
  int64 (each page's bytes, eight at a time);
- ``advanced_index``: ``pool[:, idx]`` and ``pool[:, idx] = block``;
- ``page_copies``: one strided ``copy_`` a page, each way.

Prints one JSON line: each variant's median device ms (CUDA events, 20
runs after 3 warm-ups; extract and insert apart and together), the payload
GB/s (the pages' bytes over the pair's time), the bound (each page read
and written by both the extract and the insert, 4 x the payload, at 3.35
TB/s) and whether its blocks and written pools equal the ``index_select``
variant's bit for bit. It imports nothing of JAX or of ``paddle_tpu``.
"""
import json
import pathlib
import sys

_ROOT = pathlib.Path(__file__).resolve().parents[2]
L, BS, KV, HD = 32, 16, 32, 128
PRE_PAGES, DEC_PAGES = 641, 513


def _variants(torch):
    def bytes_view(p):
        return p.view(p.shape[0], p.shape[1], -1).view(torch.int64)

    def page_extract(p, idx):
        out = p.new_empty((p.shape[0], len(idx)) + tuple(p.shape[2:]))
        for j, s in enumerate(idx.tolist()):
            out[:, j].copy_(p[:, s])
        return out

    def page_insert(p, idx, t):
        for j, d in enumerate(idx.tolist()):
            p[:, d].copy_(t[:, j])

    def adv_insert(p, idx, t):
        p[:, idx] = t

    return {
        "index_select": (lambda p, i: p.index_select(1, i),
                         lambda p, i, t: p.index_copy_(1, i, t)),
        "bytes_view": (lambda p, i: bytes_view(p).index_select(1, i),
                       lambda p, i, t: bytes_view(p).index_copy_(1, i, t)),
        "advanced_index": (lambda p, i: p[:, i], adv_insert),
        "page_copies": (page_extract, page_insert),
    }


def main():
    sys.path.insert(0, str(_ROOT))
    import numpy as np
    import torch

    import chip_smoke as c
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    gpu = c.gpu_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    pre = [torch.randn((L, PRE_PAGES, BS, KV, HD), generator=gen,
                       device="cuda", dtype=torch.bfloat16) for _ in range(2)]
    rng = np.random.default_rng(0)
    out = {"gpu": gpu, "page_bytes": 2 * L * BS * KV * HD * 2}
    for n in (38, 8):
        src = torch.as_tensor(rng.choice(np.arange(1, PRE_PAGES), n, False),
                              device="cuda")
        dst = torch.as_tensor(rng.choice(np.arange(1, DEC_PAGES), n, False),
                              device="cuda")
        payload = n * out["page_bytes"]
        rows, ref = {}, None
        for name, (extract, insert) in _variants(torch).items():
            dec = [torch.zeros((L, DEC_PAGES, BS, KV, HD), device="cuda",
                               dtype=torch.bfloat16) for _ in range(2)]
            ms = {"extract": [], "insert": []}
            for it in range(23):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
                blocks = [extract(p, src) for p in pre]
                ev[1].record()
                for p, b in zip(dec, blocks):
                    insert(p, dst, b)
                ev[2].record()
                torch.cuda.synchronize()
                if it >= 3:
                    ms["extract"].append(ev[0].elapsed_time(ev[1]))
                    ms["insert"].append(ev[1].elapsed_time(ev[2]))
            blocks = [b.view(torch.bfloat16).view(L, n, BS, KV, HD)
                      for b in blocks]
            if ref is None:
                ref = (blocks, dec)
            ext = float(np.median(ms["extract"]))
            ins = float(np.median(ms["insert"]))
            pair = float(np.median(np.add(ms["extract"], ms["insert"])))
            rows[name] = {
                "extract_ms": round(ext, 4), "insert_ms": round(ins, 4),
                "pair_ms": round(pair, 4),
                "payload_gb_per_s": round(payload / (pair * 1e-3) / 1e9, 2),
                "bits_equal": all(torch.equal(a, b) for a, b in
                                  zip(blocks + dec, ref[0] + ref[1]))}
            del dec, blocks
            torch.cuda.empty_cache()
        out[f"pages_{n}"] = {"payload_bytes": payload,
                             "bound_ms": round(4 * payload / 3.35e12 * 1e3,
                                               4), **rows}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
