#!/usr/bin/env python3
"""decode_attn_block's two bodies over int8 pools, timed in turns on one
GPU: the data behind its body rule (``fused_decode_block.attn_ring_pays``).

    python3 paddle_tpu_torch/tools/attn_body_ab.py [--rounds 5]

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit. For each class of :data:`CLASSES` (weight bits, query heads
a shard against D 4096, the residual class), at LLaMA-7B widths, 8 rows,
bf16, over int8 pools made from the same bf16 pools (``chip_smoke.
kv8_pools``), and at two sets of lengths (chip_smoke.py's kernel-phase
lengths, and serving-like ones of 300-520 tokens), it times the
weight-ring body and the CUDA-core body on the same inputs
(``chip_smoke.cold_ms``: L2 flushed before every launch), ``--rounds``
times each, alternating which goes first. The ring body runs in every
class, whatever the rule says (this tool sets the rule's measured part,
``attn_ring_pays``, to take it, and restores it); the CUDA-core body under
``chip_smoke.cuda_core_block``. Each ring launch is held against the plain
version (``attn_block_wq_ref``) at chip_smoke.py's kv8 tolerances. One JSON
object per class and length set: both bodies' times, their medians, the
ratio ring / CUDA-core and the body the committed rule picks; the card's
name and power limit on every line; the last line is ``{"ok": ...}``. It
imports nothing of JAX or of ``paddle_tpu``.
"""
import argparse
import contextlib
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: (weight bits, query heads a shard (KV = H), residual): LLaMA-7B at full
#: width in each weight class, and the tp=2 and tp=4 shards' partials
CLASSES = ((0, 32, True), (8, 32, True), (4, 32, True), (0, 16, False),
           (8, 16, False), (0, 8, False))


@contextlib.contextmanager
def ring_taken(fdb):
    """decode_attn_block on its ring body wherever its kernel and widths
    take it: the rule's measured part answers "pays" in every class."""
    pays = fdb.attn_ring_pays
    fdb.attn_ring_pays = lambda bits, pool_item, nq, D: (
        None if pool_item == 1 else pays(bits, pool_item, nq, D))
    fdb._attn_setup.cache_clear()
    fdb.attn_spec.cache_clear()
    try:
        yield
    finally:
        fdb.attn_ring_pays = pays
        fdb._attn_setup.cache_clear()
        fdb.attn_spec.cache_clear()


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_body_ab: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    from paddle_tpu_torch.ops.rope import build_rope_cache
    gpu = cs.gpu_line()
    cs.build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(11)
    rope = build_rope_cache(4096, cs.HD7, device="cuda")
    serving = torch.randint(300, 520, (cs.B8,), generator=gen,
                            device="cuda").to(torch.int32)
    bad = 0
    for bits, H, residual in CLASSES:
        base = list(cs.fused_attn_inputs(gen, torch.bfloat16, H, rope, H=H))
        if bits:
            base[2:6] = cs.wq_leaves(base[2:6], bits)
        base[8], base[9], scales, _, _ = cs.kv8_pools(base[8], base[9])
        rule = fdb.attn_body(cs.B8, cs.D7, H, H, cs.HD7, cs.BS16, 1,
                             "bfloat16", bits)
        for label, lens in (("kernel_phase_lengths", base[11]),
                            ("serving_lengths", serving)):
            args = base[:11] + [lens]

            def run(a=args):
                return fdb.decode_attn_block_cuda(
                    *a, kv_scales=scales, residual=residual)
            with ring_taken(fdb):
                body = cs.launch_plan(run)["body"]
                got = run()
                want = fdb.attn_block_wq_ref(
                    *args[:8], args[8].clone(), args[9].clone(), *args[10:],
                    kv_scales=scales, residual=residual)
                torch.cuda.synchronize()
                outs = cs._kv8_decode_outputs(got, want, torch.bfloat16,
                                              scales)[0]
            ok = body == "ring" and all(o["ok"] for o in outs.values())
            bad += not ok
            times = {"ring": [], "cuda_core": []}
            for r in range(opts.rounds):
                order = ("ring", "cuda_core") if r % 2 else (
                    "cuda_core", "ring")
                for name in order:
                    ctx = (ring_taken(fdb) if name == "ring"
                           else cs.cuda_core_block(fdb))
                    with ctx:
                        times[name].append(cs.cold_ms(run))
            med = {k: statistics.median(v) for k, v in times.items()}
            cs.emit({"phase": "attn_body_ab", "gpu": gpu, "wbits": bits,
                     "H": H, "KV": H, "pools": "int8",
                     "residual": residual, "lengths": label,
                     "seq_lens": lens.tolist(), "rule_body": rule[0],
                     "rule_reason": rule[1], "ring_ok": ok,
                     "ring_max_abs_err": max(o["max_abs_err"]
                                             for o in outs.values()),
                     "ms": times, "median_ms": med,
                     "ring_over_cuda_core": med["ring"] / med["cuda_core"]})
    cs.emit({"ok": bad == 0, "bad": bad})
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
