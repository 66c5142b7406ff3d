#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA H100. It builds
the port's kernels from the sources in the checkout (one nvcc per CUDA
C++ source, all started together; Triton's JIT for the Triton kernels)
and prints one JSON line per phase; a phase that fails raises, so the
script exits non-zero:

1. GPU: the card's name and power limit, as ``nvidia-smi`` prints them.
2. kernels: every kernel of the serving routes against its plain version
   on the card, at the routes' shapes (LLaMA-7B widths, 8 slots, chunks
   of 32 and 128 rows), with its time (L2 flushed before every launch),
   its plain version's time, the time of one PyTorch library call
   computing the same function where there is one, and its bound: the
   kernel catalog's model of the launch (``paddle_tpu_torch.analysis.
   kernel_rules.bound``: the plan captured while the launch runs once,
   each input byte read once and each output byte written once, the
   pools at the case's live lengths, and the operations its data needs,
   over 3.35 TB/s and 989 TFLOP/s bf16 or 67 f32). The
   three fused decode-block kernels (decode_attn_block, decode_mlp_block
   and the single-launch decode_block_fused) run at KV=32 and KV=8, in
   f32 and bf16, with lengths 0/1/15/16/17/1151, a ragged F for the MLP,
   20 and 32 slots (more than one pass of 8 rows; dispatch must pick the
   kernels there too), and two launches that must agree bit for bit;
   decode_block_fused also against the two-stage kernels in f32, each
   case's body recorded (bf16 at up to 8 rows: the weight ring, for
   decode_mlp_block too, and for decode_attn_block over int8 pools but
   for bf16 weights on a tp=4 shard's heads), and each 8-row bf16 kernel
   on the ring timed beside the body the ring replaces on the same
   inputs; paged_attention_decode (the split page stream) at KV 32 and 8,
   MB 72 and 75, f32 and bf16, lengths 0/1/16/17/127/the whole table,
   zeros for length 0 and two launches bit for bit; decode_mlp_block
   also at 16, 32 and 128 rows (the prefill MLP: in bf16 its tensor-core
   body, each case's body recorded). layer_norm_fwd, which no
   runtime route launches (as in the JAX package), at the JAX kernel
   catalog's 24 x 128 and 4096 x 1024 f32 and at [4095, 1024] bf16,
   timed at 4096 x 1024 beside F.layer_norm. prefill_attn_block runs at
   KV=32 and 8, f32 and bf16, P=32 and 128 (and 16 in bf16: the
   tensor-core body), permuted tables and (pos0, n_valid) = (0, P), (0,
   1), (0, P-3), (5, P-3), (16, P), (600, 11 at P=16, 21 at P=32, 77 at
   P=128): the real rows against the plain version, every row finite, two
   launches bit for bit; the kernel reads (pos0, n_valid) from its device
   bounds buffer: captured in a CUDA graph at one pair and replayed after
   five others are written there, bit for bit equal to a launch at each
   (bf16 and f32, KV 32 and 8, P 128); timed at P=128, bf16, pos0 0, 512 and 896 and at
   P=32, pos0 512, beside its bound, its plain version, its four products
   alone (``torch.matmul``) and SDPA over the same attention. rms_norm_fwd also
   runs at the train phase's shape (x [2, 2048, 4096] bf16, the f32 norm
   weight cast to bf16), alone and through ``RMSNorm``'s autograd, and is
   timed there too.
   The same four block kernels with int8 and int4 weights (the PTQ
   harness's leaves, made on the card; int4 down_proj packed along its
   output axis, the rest along the contraction axis): against their
   epilogue-order plain versions (``attn_block_wq_ref``,
   ``mlp_block_wq_ref``, ``decode_block_ref``,
   ``prefill_attn_block_wq_ref``), f32 and bf16, KV 32 and 8, 8 to 128
   rows, the ragged F, the prefill (pos0, n_valid) cases; in f32 also
   against dequantize-then-matmul; two launches bit for bit; timed at
   B 8 / P 128 in bf16 beside the bound (integer weights and f32
   scales), the plain version, the fp kernel on the same activations,
   the quantized two-stage pair (for the block kernel) and
   ``torch._weight_int8pack_mm`` over the int8 products.
   The three kernels that read the KV pools (decode_attn_block,
   decode_block_fused, prefill_attn_block) over int8 pools with f32
   per-head scales (the int8 KV cache; pools made by the port's
   ``quantize_pools`` on the card), in fp, int8 and int4 weights: against
   their kernel-order plain versions with ``kv_scales`` at the fp phases'
   tolerances (a decode row whose new-token codes differ between kernel
   and plain version by a roundoff across a rounding boundary is held
   with KV8_FLIP_ATOL more, and counted), bf16 and (fp weights) f32, KV 32
   and 8; two launches bit for bit; dispatch on the int8-pool meta; timed
   at B 8 / P 128 in bf16 beside the bound (int8 pages and their scales)
   the plain version and the fp-pool kernel on the same activations
   (the codes dequantized to bf16).
   The residual=False bodies of decode_attn_block, decode_mlp_block and
   prefill_attn_block (the tensor-parallel "psum" placement's partial
   products) at one shard's shapes: H = KV = 32, 16 and 8 heads and F =
   11008, 5504 and 2752 columns against D 4096 (tp 1, 2, 4), fp and int8
   pools, int8 weights at full width and over int8 pools at tp 2, bf16
   and f32, against their plain
   versions with ``residual=False`` at the fp and kv8 phases' tolerances;
   two launches bit for bit; the residual body on the same inputs equal,
   bit for bit, to x plus the partial output; timed beside the bound at
   the shard's shapes, the plain version, the residual body and, where
   the case runs the weight ring, the body it replaces on the same
   inputs.
3. parity: LLaMA-7B widths, 2 layers, f32: greedy tokens for 5 requests
   through 2 slots from the engine on its default route (fused prefill,
   the single-launch decode kernel), on the two-stage decode route
   (``fused_decode="pallas"``) and on the unfused route, each against
   the port's dense ``generate``; then the same over an int8 and an
   int4 tree quantized on the card (one layer's leaves byte-equal to the
   CPU's quantization of the same layer). Then the three routes with
   ``cache_dtype="int8"``: equal greedy ids and scales, and the int8
   codes each request wrote differing between a kernel route and the
   unfused route by one step at most, in at most KV8_PARITY_FLIPS of
   them; every int8-pool kernel launch in the int8 pool class.
4. serving (the main path): LLaMA-7B, 32 layers, bf16, random weights
   from a seeded ``torch.Generator`` on the card: 12 requests of 40-600
   prompt tokens and 64 new tokens each through 8 slots, on the default
   route (``fused_decode`` and ``fused_prefill`` "auto"). The launch
   counts are set to 0 just before and read just after:
   prefill_attn_block once per layer per prefill chunk,
   decode_block_fused once per layer per decode step, decode_attn_block
   never, decode_mlp_block once per layer per chunk (the prefill MLP),
   paged attention never, RMSNorm once per decode step and once per chunk
   (the final norms); every prefill_attn_block and every chunk's
   decode_mlp_block launch on the tensor-core body, every decode step's
   decode_mlp_block (the two-stage and tp psum routes) on the weight ring
   and decode_attn_block on its rule's body (the weight ring on the kv8
   two-stage and tp=2 int8-pool psum routes, the CUDA-core body on the
   others; ``launches_by_body``).
5. profile of that engine: 8 requests of 384 prompt tokens; the first
   two chunks of the first one (alone on the engine) traced with
   torch.profiler (device time per chunk by kernel group), every later
   chunk timed with CUDA events (ms per chunk by bucket); then a window
   of decode steps with all 8 slots live, timed, then traced: device
   time per step by kernel group and the card's busy share.
6. serving and profile again on the two-stage decode route
   (``fused_decode="pallas"``, same parameters and requests):
   decode_attn_block once per layer per decode step, decode_mlp_block
   once per layer per step and per chunk, decode_block_fused never; and
   on the unfused route (``fused_decode=False, fused_prefill=False``):
   paged attention once per layer per decode step, RMSNorm 2L+1 times per
   decode step and per chunk, the prefill and decode-block kernels never.
7. routes: the bf16 greedy ids of the three routes and of dense bf16
   ``generate`` on the same requests, compared pairwise (common prefix
   lengths, and the top-2 logit gap of dense bf16 logits at each first
   divergence). Informational: bf16 routes round at other places.
7b. weight-quantized serving (this slice's main path): the serving phase
   with ``weight_quant="int8"`` and ``"int4"`` on the default route and
   int8 on the two-stage route (the engine quantizes the bf16 tree on the
   card, timed): the fp routes' launch counts, every launch of the four
   block kernels in the quantized class (``launches_by_weight``), no
   dequantize-then-matmul call; the profile on int8's default route.
7c. the int8 KV cache (this slice's main path): the serving phase with
   ``cache_dtype="int8"`` on the default, two-stage and unfused routes
   and with int8 weights on the default route (``kv8_default``,
   ``kv8_two_stage``, ``kv8_unfused``, ``int8_kv8_default``): the fp
   routes' launch counts plus the calibration's dense forward (its
   RMSNorm launches and, over int8 weights, its dequantize-then-matmul
   products, counted apart) and no paged-attention launch on the unfused
   route (its attention over int8 pools is the dequantizing composition,
   as in the JAX package); every launch of the three kernels that read
   the pools in the int8 pool class (``launches_by_pool``); the pools'
   bytes and the calibration's seconds; the profile on kv8_default.
7d. tensor-parallel parity (f32, 2 layers, 7B widths, shards colocated
   on the card): greedy ids of the tp=1 "psum" mesh and the meshless
   two-stage route equal, with logits bit for bit; tp=1 "gather" and
   tp=2 "gather" against the meshless unfused route, tp=2 "psum" against
   the two-stage route: ids equal (or parting on a near tie), the largest
   |logit| difference printed.
7e. tensor-parallel serving (this slice's main path): the serving
   phase's requests on ``ServingEngine(mesh=ServingMesh.make(tp,
   collective=..., devices=["cuda:0"] * tp))``: tp=1 "psum" (the
   two-stage kernels with residual=False and the fused chunk), tp=2
   "psum", tp=2 "gather" and tp=2 "psum" over int8 pools. On the psum
   routes decode_attn_block and decode_mlp_block launch tp x L times a
   step, all in the "partial" residual class
   (``launches_by_residual``), decode_block_fused never; the gather route
   runs the composition (paged attention tp x L a step). Two shards on
   one card share its memory rate: no scaling is measured. The profile
   on tp2_psum.

8. flash: the three flash-attention kernels (fwd, dq, dkv) against
   their plain versions, and autograd through them against autograd
   through the plain ``_ref_attention``, at the training shape (b 2,
   s 2048, h = kv 32, d 128, bf16, causal), GQA 4:1, f32, non-causal,
   sq 256 / sk 1024, a ragged s of 1000 and s = 1; two launches bit for
   bit; timed at the training shape beside their bounds, their plain
   versions and SDPA (forward; backward).
8b. flash bodies: every optional body of the three flash kernels against
   its plain version, two launches bit for bit: an additive f32 bias
   [b, h], [1, h] and [b, 1] with its gradient (the dq pass's dbias body),
   segment ids with a padding id (-1), dropout 0.1 over GQA 4:1, segments
   and dropout, causal sq 1024 > sk 512 (O exactly 0 on the rows that see
   no key; lse compared on the others), at the training shape, and three
   small ragged cases (f32 and bf16, every body at once, sq > sk, sq <
   sk). Each body class timed at the training shape beside the same
   kernel without it on the same inputs, its bound, its plain version and
   SDPA with a float (bias) or boolean (segments) mask.
8c. keep mask: the dropout keep mask read out of the forward kernel
   (q = 0, V = I: O = keep / (128 (1 - rate))) and the dkv kernel (dO = I,
   GQA 4:1: dV counts the group's kept heads), equal to the torch
   ``dropout_keep`` bit for bit.
8d. varlen path (this slice's main path): ``nn.functional.
   flash_attn_unpadded`` over 4096 packed tokens of 8 seeded documents
   (64-1024 tokens each) at LLaMA-7B's attention widths (h = kv 32, d 128,
   bf16, causal, dropout 0.1), forward and backward;
   ``flash_attn_varlen_qkvpacked`` on the same packing at h 32 over kv 8;
   ``scaled_dot_product_attention`` with is_causal, sq 1024 > sk 512.
   Each against the same call on the plain route (``KERNELS.force(
   "flash_attention", "unfused")``, one generator seed so one keep mask)
   at the flash phase's bf16 tolerance; 1 launch of each flash kernel a
   call (counted by body class), each timed on both routes.
8e. bias path (this slice's main path): ``incubate.nn.functional.
   fused_multi_head_attention`` at BERT-base widths (hidden 768, 12 heads
   of 64, batch 8 x 512, post-LN, dropout 0.1 on attention and the
   out-projection), with an additive padding mask [8, 1, 1, 512] from
   seeded lengths 128-512 and with a learned relative-position bias
   [1, 12, 512, 512] f32 that requires grad (the dbias body); forward and
   backward, f32 against the plain route (one generator seed), bf16 for
   the times.
9. adamw: the fused AdamW Triton kernel against its plain version at the
   training phase's flat size and a ragged size, f32 and bf16 moments,
   with and without the bf16 shadow, grad_scale < 1, in place; timed at
   the training size beside its bound, its plain version and
   ``torch._fused_adamw_``.
10. fused-train kernels: rms_norm_bwd and residual_rms_norm_fwd at
   [4096, 4096] and [4095, 4096] bf16 and [1024, 4096] f32, swiglu_fwd and
   swiglu_bwd at [4096, 11008] and [4095, 11008] bf16, [7, 1001] bf16 and
   [1024, 11008] f32, the three linear-CE kernels at T 4096, D 4096, V
   32000 bf16 (the train step's), T 4095 / V 32003, the tied head (the
   embedding seen transposed), every label ignored (dx and dh exactly 0),
   f32 (T 512, V 32003) and the backward's P workspace in two token
   chunks: each against its plain version, two launches bit for bit; the
   backward's P pass against its plain hi + lo split, dh over the P dx's
   call keeps bit for bit equal to dh alone; timed at the train step's
   shapes beside the bound, the plain version and, for the CE, cuBLAS on
   the same products (the backward's also as the hi + lo pair); the P
   pass and each backward product on their own.
11. train parity: LLaMA at 7B widths, 2 layers, f32, b 2, s 256, on the
   "ref" route and on the default route (``fused_train=None``): each
   route's loss and every gradient through its kernels against the same
   route with every kernel replaced by its plain version; then 3
   ``Trainer`` steps each way: the loss trajectories and the parameters'
   updates; and the default route against the "ref" route.
2b. demo: the kernel-geometry gate's regression specimen,
   decode_mlp_block's kernel under the floor-divided plan of the JAX
   package's ``demo_prefix_mlp_block`` (B 2, D 32, F 96, 64-column tiles,
   bf16): against its plain version (the MLP over the first 64
   intermediate columns) at decode_mlp_block's bf16 tolerance, two
   launches bit for bit, more than ten times that tolerance away from the
   full MLP, and its captured plan audited: exactly three GRID_FLOOR_DROP
   findings, on wg, wu and wd. Timed beside its bound and plain version.
12. train (the main path): bench.py's "1.07B-h4096" ladder rung
   (vocab 32000, D 4096, F 11008, 32 heads, 4 layers, batch 2 x seq 2048,
   bf16 weights, f32 norms, bf16 moments, remat, fused optimizer) on the
   default route (``fused_train=None``): 1 warm-up and 6 timed steps on
   one batch, the launch counts set to 0 just before the timed steps and
   read just after (flash fwd 2L, dq and dkv L, fused_adamw 1, RMSNorm
   2L + 1, residual + RMSNorm 2L, rms_norm_bwd 2L + 1, swiglu_fwd 2L,
   swiglu_bwd L, each linear-CE kernel 1 a step); step ms, tokens/s, MFU,
   peak memory, the loss per step; one more step traced: device time by
   kernel group and the busy share. Then the same on the "ref" route
   (RMSNorm 4L + 1 a step, the fused-train kernels never).

7f. prefix (this slice's main path; the parity size after the graph
   phase's, the serving size after it): the radix prefix cache, its host
   tier and ``generate_paged`` (``prefix_phase``). At 7B widths, 2 layers,
   f32: the streams of tests/test_prefix_cache.py and the spill/restore
   streams of tests/test_fleet.py (lengths scaled to block 16), three of
   them also on the two-stage and unfused routes: ids equal to a cold
   engine and to dense ``generate``, every prefix and offload counter
   equal to the port's CPU run, one decode capture, tickets zero, cached
   bytes untouched by a divergent writer, restored bytes equal to the
   spilled; every stream and route also beside an eager twin (its chunks
   and steps uncaptured): ids, pools (but scratch page 0) and launch
   counts by class equal, each bucket's chunk program captured once where
   it ran twice or more and replayed at every later chunk;
   ``generate_paged`` on three routes, an int8 cache and a store called
   twice, and on every route, int8 weights, a colocated tp=2 mesh and
   top-k/top-p sampling with its decode steps captured against eager:
   ids equal. At LLaMA-7B, bf16: bench.py's prefix stream (24 requests
   of 224 shared + 32 own tokens, 64 new) cold, warm and over the host
   tier, then 8 of them again from the host tier (tokens/s, TTFT, prefill
   tokens = the cold run's less tokens_skipped, spill/restore GB/s), and
   ``generate_paged`` over 4 prompts of 40-600 tokens (ms a token,
   captured, and eager on the default route: ids equal).
   ``python3 chip_smoke.py prefix`` runs the build and this phase alone.
7g. graph (the parity size after tp parity, the serving size after the
   routes phase; ``graph_phase``): every route's engine beside an eager
   twin whose decode steps and prefill chunks run their uncaptured
   bodies: ids (greedy, and sampled at the parity size), pools and launch
   counts by class equal; the decode step one graph replayed at every
   step but the first; each bucket's chunk one graph
   (``prefill_traces`` 1 where the bucket ran twice or more), replays =
   chunks - buckets used. At the serving size the 128- and 32-row chunk
   ms (CUDA events), TTFT mean and max and tokens/s of both.
7h. disagg (this slice's main path; the parity size after the prefix
   phase's, the serving size after it; ``disagg_phase``):
   ``DisaggregatedEngine`` and ``ServingFleet``. At 7B widths, 2 layers,
   f32, both groups on the card: the streams of tests/test_disagg.py at
   block 16 (the 22-request mixed stream, the prefix cache's warm path,
   int8 pools, colocated tp=2 groups under "psum" and "gather", prefill
   tp 1 into decode tp 2, partial windows, the abort marker, preemption on
   the decode group, a one-token budget): ids equal to the colocated
   engine on the same route, every handed-off page equal to its prefill
   page bit for bit when its insert lands, the decode group's pools and
   scales never rebound, one decode capture on the decode group and none
   on the prefill group, the schedule equal to the port's CPU run; then
   tests/test_fleet.py's mixed-kind fleet on both policies. At LLaMA-7B,
   bf16: the serving phase's requests through the disaggregated engine in
   turns with the colocated one (tokens/s, TTFT, step ms, handoffs, bytes,
   the handoff's ms and GB/s, peak memory, launch counts), and bench.py's
   fleet traffic on both policies. ``python3 chip_smoke.py disagg`` runs
   the build and this phase alone.
7i. obs (this slice's main path; the parity size after the disagg
   phase's, the serving size after it; ``obs_phase``): the observability
   and telemetry harness. At 7B widths, 2 layers, f32, beside the port's
   CPU run of tests/test_observability.py's model: an observed engine
   against the plain one (ids equal) and the CPU twin (key sets, timeline
   events and request ids in order, schedule counters equal), its Chrome
   trace and JSONL (tools/trace_summary.py), the retrace watchdog (0
   warnings over warmed buckets, 1 at a new bucket's capture), stall dumps
   (a 0 s step deadline, a drain starved by hostage pages), a colocated
   tp=2 mesh's flight recorder, ``generate_paged``, the disaggregated
   engine (one shared timeline, handoff events) and the fleet (route
   events). At LLaMA-7B, bf16: the serving phase's requests through
   ``ServingEngine(..., observability=True, telemetry=True)`` in turns
   with the plain engine (observed, plain, observed, plain; tokens/s and
   their ratio, TTFT, decode_step_ms p50/p95 beside decode_step_ms_mean,
   ``metrics()``'s host ms, launch counts; 0 retrace warnings, a clean
   exposition with no alert, the exports), a bucket first captured after
   the reset (1 warning) and a 0 s deadline's dump; then the trainer at
   rung "1.07B-h4096" observed and plain in turns (losses bit-identical;
   stage, dispatch and sync ms, host-gap findings 0, the ``compile``
   entry, ``hbm``, the counted-FLOPs ``mfu`` beside bench.py's formula
   MFU) and ``Profiler`` with the GPU target over 3 steps (its device
   trace names every train-route kernel). ``python3 chip_smoke.py obs``
   runs the build and this phase alone.
13. audit: the plans of every launch of the default serving route's
   phase and of the default train route's phase, captured while they
   ran, audited by the kernel-geometry gate (0 findings), and the whole
   catalog too; each cooperative kernel's grid (the launcher's occupancy
   query on the card) equal to the catalog's assumption (132 SMs times
   its blocks an SM), and ptxas's static shared memory of every device
   kernel at most its launch's declared figure.

Then the ``kernels`` summary line, 18 rows and ``decode_mlp_block[tc]``
(its tensor-core body at a 128-row chunk; launches: the default route's
chunks, by bucket), the specimen's row
(``demo_prefix_mlp_block``, launches from its own phase), the 8 quantized rows
(``decode_attn_block[int8]`` ... ``prefill_attn_block[int4]``, launches
from the quantized serving routes) and the 9 int8-pool rows
(``decode_attn_block[kv8]`` ... ``prefill_attn_block[int4,kv8]``,
launches from the int8-cache routes), the 11 residual=False rows
(``decode_attn_block[partial,tp2]`` ... ``prefill_attn_block[partial,
tp2,kv8]``, launches in the "partial" class from the tensor-parallel
routes: 0 for tp 4, for int8 weights and for prefill_attn_block, which
no route runs), the 16 flash body rows (``flash_attention_fwd[bias]``
... ``flash_attention_bwd_dkv[causal_sq_gt_sk]``, ``flash_attention_bwd_
dq[dbias]``; launches from the varlen and bias path phases in the body
classes that hold the row's flags) (each kernel's launches from
the serving phase of the route that runs it, from the default route's
train phase, or, for layer_norm_fwd, from its own phase; the
decode_mlp_block, decode_block_fused and prefill_attn_block rows also
carry ``prefix_launches``, their launches in the prefix phase's serving
size, ``disagg_launches``, their launches in the disagg phase's first
disaggregated run at the serving size, and ``obs_launches`` (RMSNorm's
too), their launches in the obs phase's first observed run, the train rows
``obs_train_launches``, the observed trainer's, and
``prefill_attn_block[kv8]`` its int8-cache stream's) and,
last, ``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and
prints no result. It imports nothing of JAX or of ``paddle_tpu``.
"""
import contextlib
import gc
import json
import subprocess
import sys
import time
import types

import numpy as np

RMS_SOURCE = "paddle_tpu_torch/ops/kernels/norms.py"
PAGED_SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
FUSED_SOURCE = "paddle_tpu_torch/csrc/fused_decode_block.cu"
PREFILL_SOURCE = "paddle_tpu_torch/csrc/fused_prefill_block.cu"
FLASH_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
ADAMW_SOURCE = "paddle_tpu_torch/ops/kernels/fused_adamw.py"
CUDA_SOURCES = ("paged_attention", "fused_decode_block",
                "fused_prefill_block", "flash_attention", "linear_ce")
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


def bound(launch, seq_lens=None, segments=None):
    """``(ms, "bytes" | "operations", bytes, operations)``: the least time
    the card could take for the launch ``launch()`` makes, from the kernel
    catalog's model (``paddle_tpu_torch.analysis.kernel_rules.bound``): its
    plan is captured while it runs once, then each input byte is read once
    and each output byte written once (the pools' live tokens at
    ``seq_lens``, the tokens in the pools of each sequence), and the
    operations this launch's data needs (a flash launch's pairs of one
    segment at ``segments``, its seg_q and seg_k), over 3.35 TB/s and the
    working type's peak."""
    import torch
    from paddle_tpu_torch.analysis.kernel_rules import bound as model
    from paddle_tpu_torch.ops.kernels._launch import capture_kernel_launches
    with capture_kernel_launches() as specs:
        launch()
    torch.cuda.synchronize()
    if len(specs) != 1:
        raise AssertionError(f"bound: {len(specs)} launches captured, "
                             f"expected one: {[s.name for s in specs]}")
    return model(specs[0], seq_lens, segments)


def launch_plan(launch):
    """The plan the launch ``launch()`` makes runs with (its spec's
    ``plan``: tile rows, threads, shared memory, "mma" or "simt"), and for
    a flash pass with segment ids the (query tile, key tile) pairs it
    computes against those the causal mask alone leaves."""
    import torch
    from paddle_tpu_torch.ops.kernels._launch import capture_kernel_launches
    with capture_kernel_launches() as specs:
        launch()
    torch.cuda.synchronize()
    plan = dict(specs[0].plan)
    for key in ("pairs", "pairs_causal"):
        if key in specs[0].params:
            plan[key] = specs[0].params[key]
    return plan


def ulp_close(got, want, rel):
    """|got - want| <= rel * max(|got|, |want|), in f32 (one ulp of the
    working type for rel = its machine epsilon), plus 1e-6 absolute for
    values near zero."""
    import torch
    g, w = got.float(), want.float()
    tol = rel * torch.maximum(g.abs(), w.abs()) + 1e-6
    return bool(((g - w).abs() <= tol).all())


def bf16_close(got, want, rel=2.0 ** -6, floor=0.0):
    """|got - want| <= rel * (max(|got|, |want|) + rms(want)) + floor: two
    bf16 ulps (eps 2^-7) at the element's own magnitude, plus two at the
    tensor's RMS for elements a residual add cancelled towards zero, plus
    an absolute ``floor``. Returns (ok, the worst error in units of that
    scale)."""
    g, w = got.float(), want.float()
    scale = (g.abs().maximum(w.abs())
             + w.pow(2).mean().sqrt()).clamp_min(1e-30)
    worst = float((((g - w).abs() - floor).clamp_min(0) / scale).max())
    return worst <= rel, worst


def build_kernels():
    """One nvcc per CUDA source, all started together, then Triton's
    compile of the RMSNorm and AdamW kernels on a first launch."""
    import torch
    from paddle_tpu_torch.ops.kernels import _build, fused_adamw, norms
    t0 = time.perf_counter()
    _build.build(CUDA_SOURCES)
    for name in CUDA_SOURCES:
        _build.load(name)
    t_nvcc = time.perf_counter() - t0
    x = torch.ones(2, 64, device="cuda")
    norms.rms_norm_fwd_triton(x, torch.ones(64, device="cuda"))
    z = torch.zeros(8, device="cuda")
    fused_adamw.fused_adamw_triton(z, z.clone(), z.clone(), z.clone(), 1e-3, 1,
                                   shadow_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    root = _build.CSRC.parent.parent
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_s": round(t_nvcc, 3),
          "libraries": {n: str(_build.library_path(n).relative_to(root))
                        for n in CUDA_SOURCES},
          "ptxas": {n: _ptxas(_build.library_path(n).with_suffix(".log"))
                    for n in CUDA_SOURCES}})


def _ptxas(log):
    """ptxas's registers, static shared memory and spills of each kernel in
    a build log, under the kernel's (mangled) name."""
    out, fn = {}, None
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif fn and ("registers" in ln or "spill" in ln):
            out.setdefault(fn, []).append(ln.split(":", 1)[-1].strip())
    return out


def _static_smem(lines):
    """The static shared-memory bytes in ptxas's lines of one kernel."""
    for ln in lines:
        for part in ln.split(","):
            if part.strip().endswith("bytes smem"):
                return int(part.split()[0])
    return 0


def rms_phase(gpu):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.norms import (RMSNorm, rms_bwd_ref,
                                                    rms_norm_fwd_triton,
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
    # the train phase's shape: x [batch, seq, D] bf16, the f32 norm weight
    # cast to x's type as the decoder layer casts it. Both versions round
    # twice: the normalised row to bf16, then its product with w. Their f32
    # sums run in another order, so the first rounding may flip by one ulp
    # (the rare element near a tie; 16.8 M elements here); times |w| and
    # rounded again, that is up to two ulps of the output. So: the
    # normalised rows (w = 1) within one ulp, the kernel's output equal to
    # its normalised rows times w (one rounding), and against the plain
    # version two ulps. Then the same through RMSNorm's autograd (forward:
    # the kernel; backward: the plain rms_bwd_ref that fused_train="ref"
    # pins).
    bf16 = torch.bfloat16
    one_ulp = torch.finfo(bf16).eps
    tb, ts = TRAIN_RUNG["batch"], TRAIN_RUNG["seq"]
    xt = torch.randn(tb, ts, D, generator=gen, device="cuda").to(bf16)
    w32 = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda"))
    wt = w32.to(bf16)
    ones = torch.ones(D, dtype=bf16, device="cuda")
    got = rms_norm_fwd_triton(xt, wt, eps)
    want = rms_norm_ref(xt, wt, eps)
    norm_k = rms_norm_fwd_triton(xt, ones, eps)
    norm_p = rms_norm_ref(xt, ones, eps)
    xl, wl = xt.clone().requires_grad_(True), w32.clone().requires_grad_(True)
    before = rms_norm_fwd_triton.launches
    y = RMSNorm.apply(xl, wl.to(bf16), eps, "ref")
    launched = rms_norm_fwd_triton.launches - before
    g = torch.randn(tb, ts, D, generator=gen, device="cuda").to(bf16)
    y.backward(g)
    want_dx, want_dw = rms_bwd_ref(eps, (xt, wt), g)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    checks = {
        "normalised_within_one_ulp": ulp_close(norm_k, norm_p, one_ulp),
        "output_is_normalised_times_w": bool(torch.equal(got, norm_k * wt)),
        "output_within_two_ulps": ulp_close(got, want, 2 * one_ulp),
        "autograd_forward_is_the_kernel": bool(torch.equal(y.detach(), got))
        and launched == 1,
        "autograd_dx_is_rms_bwd_ref": bool(torch.equal(xl.grad, want_dx)),
        "autograd_dw_through_the_cast": wl.grad.dtype == torch.float32
        and bool(torch.equal(wl.grad, want_dw.float()))}
    gf, wf = got.float(), want.float()
    over = int(((gf - wf).abs() > one_ulp * gf.abs().maximum(wf.abs())
                + 1e-6).sum())
    ok = all(checks.values())
    cases.append({"shape": [tb, ts, D], "dtype": "bfloat16",
                  "weight": "float32 cast to bfloat16",
                  "max_abs_err": err,
                  "normalised_max_abs_err": float(
                      (norm_k.float() - norm_p.float()).abs().max()),
                  "elements_over_one_ulp": over,
                  "tol": "normalised rows one bf16 ulp (rel 2^-7); output "
                         "two (rel 2^-6)",
                  "checks": checks, "ok": ok})
    max_err = max(max_err, err)
    if not ok:
        raise AssertionError(f"rms_norm_fwd disagrees: {cases[-1]}")
    del xl, wl, y, g, want_dx, want_dw, got, want, norm_k, norm_p, ones
    tb_ms, tb_by = bound(lambda: rms_norm_fwd_triton(xt, wt, eps))[:2]
    train = {"shape": [tb, ts, D], "dtype": "bfloat16",
             "ms": cold_ms(lambda: rms_norm_fwd_triton(xt, wt, eps)),
             "plain_ms": cold_ms(lambda: rms_norm_ref(xt, wt, eps)),
             "bound_ms": tb_ms, "bound_by": tb_by,
             "library_ms": (cold_ms(lambda: F.rms_norm(xt, (D,), wt, eps))
                            if hasattr(F, "rms_norm") else None)}
    del xt, wt, w32
    x, w = timed                              # the decode step's shape
    b_ms, b_by = bound(lambda: rms_norm_fwd_triton(x, w, eps))[:2]
    lib = (cold_ms(lambda: F.rms_norm(x, (D,), w, eps))
           if hasattr(F, "rms_norm") else None)
    row = {"name": "rms_norm_fwd", "route": "triton", "source": RMS_SOURCE,
           "replaces": "paddle_tpu/ops/pallas/norms.py:73",
           "shape": [8, D], "dtype": "bfloat16",
           "max_abs_err": max_err,
           "ms": cold_ms(lambda: rms_norm_fwd_triton(x, w, eps)),
           "plain_ms": cold_ms(lambda: rms_norm_ref(x, w, eps)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
           "library": "torch.nn.functional.rms_norm", "train": train,
           "ok": True}
    emit({"phase": "kernel", "kernel": "rms_norm_fwd", "gpu": gpu,
          "cases": cases, "train": train})
    return row


def paged_inputs(gen, dt, B, H, KV, hd, BS, MB):
    import torch
    full = MB * BS
    rand = torch.randint(2, full, (B - 6,), generator=gen, device="cuda")
    seq = torch.tensor([0, 1, BS, BS + 1, 127, full], device="cuda")
    seq_lens = torch.cat([seq, rand]).to(torch.int32)
    N = B * MB + 1
    perm = torch.randperm(N - 1, generator=gen, device="cuda") + 1
    tables = perm[:B * MB].reshape(B, MB).to(torch.int32).contiguous()
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
    k = torch.randn(N, BS, KV, hd, generator=gen, device="cuda").to(dt)
    v = torch.randn(N, BS, KV, hd, generator=gen, device="cuda").to(dt)
    return q, k, v, tables, seq_lens


#: paged_attention_decode's cases: (dtype, KV, MB); MB 75 is no multiple of
#: the split page stream's 8 pages (a short last split)
PAGED_CASES = (("bfloat16", 32, 72), ("float32", 32, 72), ("bfloat16", 8, 72),
               ("float32", 8, 72), ("bfloat16", 8, 75), ("float32", 32, 75))


def paged_phase(gpu):
    """paged_attention_decode (the split page stream, csrc/paged_stream.cuh)
    against its plain version at the serving shapes (B 8, H 32, hd 128, BS
    16), KV 32 and 8 (GQA 4:1), MB 72 and 75, f32 at 1e-5 and bf16 at
    2e-2, lengths 0, 1, 16, 17, 127, the whole table and random ones:
    exact zeros for length 0, two launches bit for bit, the plan recorded.
    Timed in bf16 at KV 32, MB 72 beside SDPA over the K/V gathered
    densely beforehand."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_decode_cuda, paged_attention_decode_ref)
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, H, hd, BS = 8, 32, 128, 16     # the serving phase's shapes
    cases, max_err, timed = [], 0.0, None
    for dname, KV, MB in PAGED_CASES:
        dt = getattr(torch, dname)
        args = paged_inputs(gen, dt, B, H, KV, hd, BS, MB)
        got = paged_attention_decode_cuda(*args)
        again = paged_attention_decode_cuda(*args)
        want = paged_attention_decode_ref(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = 1e-5 if dt == torch.float32 else 2e-2
        ok = bool(torch.allclose(got.float(), want.float(), atol=tol,
                                 rtol=tol))
        zero = bool((got[args[4] == 0] == 0).all())
        same = bool(torch.equal(got, again))
        cases.append({"dtype": dname, "KV": KV, "MB": MB,
                      "seq_lens": args[4].tolist(), "max_abs_err": err,
                      "tol": f"atol=rtol={tol}", "zero_for_len_0": zero,
                      "bitwise_repeatable": same,
                      "plan": launch_plan(
                          lambda a=args: paged_attention_decode_cuda(*a)),
                      "ok": ok and zero and same})
        max_err = max(max_err, err)
        if not cases[-1]["ok"]:
            raise AssertionError(
                f"paged_attention_decode disagrees: {cases[-1]}")
        if dt == torch.bfloat16 and KV == H and MB == 72:
            timed = args
    q, k, v, tables, seq_lens = timed
    lens = seq_lens.long()
    b_ms, b_by = bound(lambda: paged_attention_decode_cuda(*timed),
                       lens.tolist())[:2]
    # yardstick: SDPA over K/V gathered densely beforehand (the gather is
    # not timed), the padding masked out
    MB = tables.shape[1]
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


def fused_attn_inputs(gen, dt, KV, rope, B=B8, H=H7):
    """decode_attn_block's arguments at LLaMA-7B widths, ``H`` query heads
    (one shard's under tensor parallelism) and ``KV`` KV heads."""
    import torch
    D, hd, BS, MB = D7, HD7, BS16, MB72
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
    case is timed. Each case records its body and the rule's reason (the
    CUDA-core body in every class: decode_attn_block's weight ring runs
    over int8 pools only, :func:`kv8_decode_phase`)."""
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
        plan = launch_plan(lambda a=args: fdb.decode_attn_block_cuda(*a))
        case = {"dtype": str(dt)[6:], "KV": KV, "B": B,
                "seq_lens": args[11].tolist(), "outputs": outs,
                "bitwise_repeatable": same, "dispatch": picked[0],
                "body": plan["body"], "body_rule": plan["body_rule"],
                "smem_bytes": fdb.attn_smem_bytes(
                    D7, H7, KV, HD7, BS16, args[0].element_size()),
                "ok": same and picked[0] == "cuda_fused"
                and plan["body"] == "cuda_core"
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
    b_ms, b_by = bound(lambda: fdb.decode_attn_block_cuda(*timed), lens)[:2]
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
           **body_row(fdb, lambda: fdb.decode_attn_block_cuda(*timed)),
           "ok": True}
    emit({"phase": "kernel", "kernel": "decode_attn_block", "gpu": gpu,
          "cases": cases, **{k: row[k] for k in (
              "ms", "plain_ms", "bound_ms", "body", "body_rule")}})
    return row


def mlp_timing(fdb, args):
    """decode_mlp_block's time at ``args`` (bf16) beside its bound, its
    plain version's time and its three products alone."""
    import torch
    x, nw, wg, wu, wd = args
    R, D = x.shape
    F = wg.shape[1]
    b_ms, b_by = bound(lambda: fdb.decode_mlp_block_cuda(*args))[:2]
    h, ff = torch.randn_like(x), torch.randn(R, F, device="cuda").to(x.dtype)
    return {"ms": cold_ms(lambda: fdb.decode_mlp_block_cuda(*args)),
            "plain_ms": cold_ms(lambda: fdb.mlp_block_ref(*args)),
            "bound_ms": b_ms, "bound_by": b_by,
            "matmul_ms": cold_ms(lambda: (h @ wg, h @ wu, ff @ wd))}


def fused_mlp_phase(gpu):
    """decode_mlp_block against mlp_block_ref on the card, at F=11008 and
    at an F no tile width divides (the last F tile masked), f32 and bf16,
    8, 20 and 32 slots and 16, 32 and 128 rows (the prefill MLP's chunks:
    bf16 from 9 rows on runs the tensor-core body, at up to 8 the weight
    ring, each case records the body its plan took), tolerances as for the
    attention block (x_out at 1e-4 in f32); the bf16 cases of 16, 32 and
    128 rows are timed beside their bound, and the 8-row row beside the
    CUDA-core body on the same inputs."""
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
                     (torch.float32, F7, 128), (torch.bfloat16, F7, 16)):
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
        plan = launch_plan(lambda: fdb.decode_mlp_block_cuda(*args))
        case = {"dtype": str(dt)[6:], "F": F, "B": B, "output": out,
                "bitwise_repeatable": same, "dispatch": picked[1],
                "body": plan["body"], "body_rule": plan["body_rule"],
                "ok": out["ok"] and same and picked[1] == "cuda_fused"}
        if dt == torch.bfloat16 and F == F7 and B in (16, 32, 128):
            rows[B] = dict(mlp_timing(fdb, args), body=plan["body"])
            case["ms"] = rows[B]["ms"]
        cases.append(case)
        if not case["ok"]:
            emit({"phase": "kernel", "kernel": "decode_mlp_block",
                  "gpu": gpu, "cases": cases})
            raise AssertionError(f"decode_mlp_block disagrees: {case}")
        if dt == torch.bfloat16 and F == F7 and B == B8:
            timed = args
    x, nw, wg, wu, wd = timed
    b_ms, b_by = bound(lambda: fdb.decode_mlp_block_cuda(*timed))[:2]
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
           "body": launch_plan(
               lambda: fdb.decode_mlp_block_cuda(*timed))["body"],
           "cuda_core_ms": core_ms(
               fdb, lambda: fdb.decode_mlp_block_cuda(*timed)),
           "prefill_rows": rows, "ok": True}
    emit({"phase": "kernel", "kernel": "decode_mlp_block", "gpu": gpu,
          "cases": cases, "prefill_rows": rows, **{k: row[k] for k in (
              "ms", "cuda_core_ms", "plain_ms", "bound_ms", "body")}})
    # the tensor-core body at the 128-row chunk (the main path's prefill
    # MLP), a row of its own
    tc_row = dict(row, name="decode_mlp_block[tc]",
                  shape={"B": 128, "D": D7, "F": F7}, max_abs_err=max(
                      c["output"]["max_abs_err"] for c in cases
                      if c["body"] == "tc"),
                  **{k: rows[128][k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "matmul_ms")})
    for k in ("prefill_rows", "cuda_core_ms"):
        del tc_row[k]
    tc_row["body"] = rows[128]["body"]
    return [row, tc_row]


def block_inputs(gen, dt, KV, F, rope, B):
    """decode_block_fused's arguments: fused_attn_inputs' with the
    post-norm and MLP weights at ``F`` spliced in after wo."""
    import torch
    a = fused_attn_inputs(gen, dt, KV, rope, B)
    pw = (1 + 0.1 * torch.randn(D7, generator=gen, device="cuda")).to(dt)
    wg, wu = (torch.randn(D7, F, generator=gen, device="cuda") * 0.02
              ).to(dt), (torch.randn(D7, F, generator=gen, device="cuda")
                         * 0.02).to(dt)
    wd = (torch.randn(F, D7, generator=gen, device="cuda") * 0.02).to(dt)
    return (*a[:6], pw, wg, wu, wd, *a[6:])


def block_phase(gpu):
    """decode_block_fused against decode_block_ref (its plain version: the
    attention through the RMSNorm and paged-attention kernels, cuBLAS
    products, the JAX block kernel's f32 residual) on the card, over the
    two-stage kernels' cases: KV=32 and 8, f32 and bf16, lengths
    0/1/15/16/17/1151 and random, F=11008 and an F no tile width divides
    (11000 bf16, 11012 f32), 8, 20 and 32 slots. Bounds as the two-stage
    kernels' (x_out f32 atol=rtol=1e-4, k_new/v_new 1e-5; bf16 two ulps,
    bf16_close); two launches bit for bit; dispatch must pick the kernel.
    In f32 also against decode_block_composed on the card (the
    decode_attn_block and decode_mlp_block kernels): f32 rounds nowhere
    between the halves, so the two routes differ by summation order only
    (1e-4). Timed at B 8, 7B widths, bf16, beside its bound, its plain
    version and the two-stage pair on the same inputs."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    from paddle_tpu_torch.ops.rope import build_rope_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(6)
    rope = build_rope_cache(4096, HD7, device="cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    cases, max_err, timed = [], 0.0, None
    for dt, KV, B, F in ((bf16, 32, B8, F7), (f32, 32, B8, F7),
                         (bf16, 8, B8, F7), (f32, 8, B8, F7),
                         (bf16, 32, 32, F7), (f32, 8, 20, F7),
                         (bf16, 32, B8, 11000), (f32, 8, B8, 11012)):
        args = block_inputs(gen, dt, KV, F, rope, B)
        meta = fdb.decode_meta_dims(B, D7, H7, KV, HD7, F, BS16, MB72, dt,
                                    dt, False)
        picked = KERNELS.dispatch("decode_block_fused", meta)[0]
        got = fdb.decode_block_fused_cuda(*args)
        again = fdb.decode_block_fused_cuda(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        outs = {}
        want = fdb.decode_block_ref(*args)    # writes the new token's K/V
        if dt == f32:
            composed = fdb.decode_block_composed(*args)
            torch.cuda.synchronize()
            outs["x_out_vs_composed"] = _check_case(
                "x_out", got[0], composed[0], dt, 1e-4)
        torch.cuda.synchronize()
        for nm, g, w, tol in (("x_out", got[0], want[0], 1e-4),
                              ("k_new", got[1], want[1], 1e-5),
                              ("v_new", got[2], want[2], 1e-5)):
            outs[nm] = _check_case(nm, g, w, dt, tol)
        max_err = max([max_err] + [outs[k]["max_abs_err"]
                                   for k in ("x_out", "k_new", "v_new")])
        plan = launch_plan(lambda a=args: fdb.decode_block_fused_cuda(*a))
        case = {"dtype": str(dt)[6:], "KV": KV, "B": B, "F": F,
                "seq_lens": args[15].tolist(), "outputs": outs,
                "bitwise_repeatable": same, "dispatch": picked,
                "body": plan["body"], "body_rule": plan["body_rule"],
                "smem_bytes": fdb.ring_smem(D7, H7, KV, HD7, BS16, 2)
                if plan["body"] == "ring" else fdb.block_smem_bytes(
                    D7, H7, KV, HD7, BS16, args[0].element_size()),
                "ok": same and picked == "cuda_block"
                and all(o["ok"] for o in outs.values())}
        cases.append(case)
        if not case["ok"]:
            emit({"phase": "kernel", "kernel": "decode_block_fused",
                  "gpu": gpu, "cases": cases})
            raise AssertionError(f"decode_block_fused disagrees: {case}")
        if dt == bf16 and KV == H7 and B == B8 and F == F7:
            timed = args
    (x, nw, wq, wk, wv, wo, pw, wg, wu, wd, sin, cos, kp, vp, tables,
     lens) = timed
    lens = lens.tolist()
    b_ms, b_by = bound(lambda: fdb.decode_block_fused_cuda(*timed), lens)[:2]
    attn_args = (x, nw, wq, wk, wv, wo, sin, cos, kp, vp, tables, timed[15])

    def two_stage():
        xo, _, _ = fdb.decode_attn_block_cuda(*attn_args)
        return fdb.decode_mlp_block_cuda(xo, pw, wg, wu, wd)
    with cuda_core_block(fdb):
        core_ms = cold_ms(lambda: fdb.decode_block_fused_cuda(*timed))
    row = {"name": "decode_block_fused", "route": "cuda",
           "source": FUSED_SOURCE,
           "replaces": "paddle_tpu/ops/pallas/fused_decode_block.py:1021",
           "shape": {"B": B8, "D": D7, "H": H7, "KV": H7, "hd": HD7,
                     "F": F7, "BS": BS16, "MB": MB72, "seq_lens": lens},
           "dtype": "bfloat16", "max_abs_err": max_err,
           "ms": cold_ms(lambda: fdb.decode_block_fused_cuda(*timed)),
           "plain_ms": cold_ms(lambda: fdb.decode_block_ref(*timed)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "library": "none: no single PyTorch call computes the layer",
           "two_stage_ms": cold_ms(two_stage), "cuda_core_ms": core_ms,
           "body": launch_plan(
               lambda: fdb.decode_block_fused_cuda(*timed))["body"],
           "ok": True}
    emit({"phase": "kernel", "kernel": "decode_block_fused", "gpu": gpu,
          "cases": cases, "ms": row["ms"], "two_stage_ms": row["two_stage_ms"],
          "cuda_core_ms": core_ms, "bound_ms": b_ms})
    return row


@contextlib.contextmanager
def cuda_core_block(fdb):
    """decode_block_fused, decode_attn_block and decode_mlp_block on their
    CUDA-core bodies at up to 8 rows (the 8-row passes of
    block_products.cuh; the weight ring's threshold moved to 0 rows), for
    a time on the same inputs."""
    old = fdb.RING_MAX_ROWS
    fdb.RING_MAX_ROWS = 0
    try:
        yield
    finally:
        fdb.RING_MAX_ROWS = old


def body_row(fdb, fn):
    """The body a launch of ``fn`` runs (its plan's ``body`` and
    ``body_rule``) and, where that is the weight ring, the CUDA-core
    body's time on the same inputs in the same call (:func:`core_ms`)."""
    plan = launch_plan(fn)
    row = {"body": plan["body"], "body_rule": plan["body_rule"]}
    if plan["body"] == "ring":
        row["cuda_core_ms"] = core_ms(fdb, fn)
    return row


def attn_route_body(fdb, H, KV, pool_item, bits):
    """The body decode_attn_block's rule gives a decode step of 8 bf16
    rows at LLaMA-7B widths with ``H`` heads a shard (the routes' class)."""
    return fdb.attn_body(B8, D7, H, KV, HD7, BS16, pool_item, "bfloat16",
                         bits)[0]


def core_ms(fdb, fn):
    """``fn``'s time with the decode kernels on their CUDA-core bodies
    (:func:`cuda_core_block`): the body the ring replaces, same inputs,
    same call."""
    with cuda_core_block(fdb):
        return cold_ms(fn)


LN_CASES = (((24, 128), "float32"), ((4096, 1024), "float32"),
            ((4095, 1024), "bfloat16"))


def layer_norm_phase(gpu):
    """layer_norm_fwd against layer_norm_ref on the card at the JAX kernel
    catalog's two shapes (24 x 128 and 4096 x 1024 f32) and a ragged bf16
    one: f32 atol=rtol=1e-5 (sums in another order; the kernel may fuse
    the weight multiply and the bias add), bf16 by bf16_close; two
    launches bit for bit. No runtime route launches it (as in the JAX
    package), so its launches are this phase's. Timed at 4096 x 1024 f32
    beside its bound, its plain version and F.layer_norm."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.norms import (layer_norm_fwd_triton,
                                                    layer_norm_ref)
    gen = torch.Generator(device="cuda").manual_seed(7)
    eps = 1e-5
    cases, max_err, timed = [], 0.0, None
    layer_norm_fwd_triton.launches = 0
    for shape, dname in LN_CASES:
        dt = getattr(torch, dname)
        D = shape[-1]
        x = (torch.randn(*shape, generator=gen, device="cuda") * 2
             + 0.5).to(dt)
        w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(dt)
        b = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(dt)
        got = layer_norm_fwd_triton(x, w, b, eps)
        again = layer_norm_fwd_triton(x, w, b, eps)
        want = layer_norm_ref(x, w, b, eps)
        torch.cuda.synchronize()
        case = {"shape": list(shape), **_check_case("y", got, want, dt, 1e-5),
                "bitwise_repeatable": bool(torch.equal(got, again))}
        case["dtype"] = dname
        case["ok"] = case["ok"] and case["bitwise_repeatable"]
        cases.append(case)
        max_err = max(max_err, case["max_abs_err"])
        if not case["ok"]:
            emit({"phase": "kernel", "kernel": "layer_norm_fwd", "gpu": gpu,
                  "cases": cases})
            raise AssertionError(f"layer_norm_fwd disagrees: {case}")
        if shape == (4096, 1024):
            timed = (x, w, b)
    launches = layer_norm_fwd_triton.launches
    x, w, b = timed
    b_ms, b_by = bound(lambda: layer_norm_fwd_triton(x, w, b, eps))[:2]
    row = {"name": "layer_norm_fwd", "route": "triton", "source": RMS_SOURCE,
           "replaces": "paddle_tpu/ops/pallas/norms.py:347",
           "shape": list(x.shape), "dtype": "float32",
           "max_abs_err": max_err,
           "ms": cold_ms(lambda: layer_norm_fwd_triton(x, w, b, eps)),
           "plain_ms": cold_ms(lambda: layer_norm_ref(x, w, b, eps)),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": cold_ms(lambda: F.layer_norm(x, (x.shape[1],), w, b,
                                                      eps)),
           "library": "torch.nn.functional.layer_norm",
           "launches": launches, "ok": True}
    emit({"phase": "kernel", "kernel": "layer_norm_fwd", "gpu": gpu,
          "cases": cases, "launches": launches})
    return row


PREFILL_CASES = ((0, 0), (0, 1), (0, -3), (5, -3), (16, 0), (600, None))
# n_valid of PREFILL_CASES' None case by chunk rows
PREFILL_PARTIAL = {16: 11, 32: 21, 128: 77}


def prefill_attn_phase(gpu):
    """prefill_attn_block against prefill_attn_block_ref (the dense
    composition: the RMSNorm kernel, cuBLAS products, attention over the
    gathered view) on the card, at LLaMA-7B widths with KV=32 and KV=8,
    f32 (TF32 off) and bf16, chunks of 32 and 128 rows (and 16 in bf16),
    a permuted table of 72 pages, and the (pos0, n_valid) cases of
    PREFILL_CASES (n_valid 0 = P, negative = P minus it, None =
    PREFILL_PARTIAL's). The real rows of x_out (f32 1e-4), k_new and v_new
    (f32 1e-5) must agree, bf16 to two ulps (bf16_close); every row of
    x_out must be finite; two launches must give the same bits. Dispatch
    must pick the kernel at every shape; each case records the body its
    plan took (bf16: the tensor cores). Timed at P=128, bf16, KV=32, pos0
    0, 512 and 896, and at P=32, pos0 512."""
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
    cases, max_err, timed, replayed = [], 0.0, {}, []
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
            for P in ((16, 32, 128) if dt == torch.bfloat16 else (32, 128)):
                meta = fpb.prefill_meta_dims(P, D, H, KV, hd, F7, BS, MB, dt,
                                             dt, False)
                picked = KERNELS.dispatch("prefill_attn_block", meta)[0]
                for pos0, nv in PREFILL_CASES:
                    n = (PREFILL_PARTIAL[P] if nv is None
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
                            "body": launch_plan(
                                lambda: fpb.prefill_attn_block_cuda(
                                    *args))["body"],
                            "ok": same and finite and picked == "cuda_fused"
                            and all(o["ok"] for o in outs.values())}
                    cases.append(case)
                    if not case["ok"]:
                        emit({"phase": "kernel", "kernel":
                              "prefill_attn_block", "gpu": gpu,
                              "cases": cases})
                        raise AssertionError(
                            f"prefill_attn_block disagrees: {case}")
            replayed.append(bounds_replay(fpb, rn(128, D), weights, sin, cos,
                                          kp, vp, table))
            if not replayed[-1]["ok"]:
                raise AssertionError(f"prefill_attn_block's bounds replay: "
                                     f"{replayed[-1]}")
            if dt == torch.bfloat16 and KV == H:
                for P, pos0 in ((128, 0), (128, 512), (128, 896), (32, 512)):
                    args = (rn(P, D), *weights, sin[pos0:pos0 + P],
                            cos[pos0:pos0 + P], kp, vp, table, pos0, P)
                    timed[(P, pos0)] = prefill_timing(fpb, F, args)
    row = {"name": "prefill_attn_block", "route": "cuda",
           "source": PREFILL_SOURCE,
           "replaces": "paddle_tpu/ops/pallas/fused_prefill_block.py:431",
           "shape": {"P": 128, "n_valid": 128, "pos0": 512, "D": D, "H": H,
                     "KV": H, "hd": hd, "BS": BS, "MB": MB},
           "dtype": "bfloat16", "max_abs_err": max_err,
           **{k: timed[(128, 512)][k] for k in ("ms", "plain_ms",
                                                "bound_ms", "bound_by",
                                                "matmul_ms", "sdpa_ms")},
           "library_ms": None,
           "library": "none: no single PyTorch call computes the block",
           "at_pos0_0": timed[(128, 0)], "at_pos0_896": timed[(128, 896)],
           "at_p32": timed[(32, 512)], "ok": True}
    emit({"phase": "kernel", "kernel": "prefill_attn_block", "gpu": gpu,
          "cases": cases, "bounds_replay": replayed,
          "timed": {f"P{P},pos0 {p0}": t for (P, p0), t in timed.items()}})
    return row


# (pos0, n_valid) written into a captured launch's bounds buffer; the
# capture's own is the first
BOUNDS_REPLAY = ((512, 128), (0, 128), (5, 125), (600, 77), (16, 1))


def bounds_replay(fpb, x, weights, sin, cos, kp, vp, table):
    """prefill_attn_block (P 128) captured in a CUDA graph over a bounds
    buffer at BOUNDS_REPLAY's first (pos0, n_valid), then replayed after
    each case's values (and its RoPE rows) are written into the buffers:
    x_out, k_new and v_new equal, bit for bit, to a launch of the wrapper
    at that case (which writes its own bounds): the kernel reads pos0 and
    n_valid from device memory, as the TPU kernel reads its
    scalar-prefetch operand."""
    import torch
    P = x.shape[0]
    s_buf, c_buf = (torch.empty_like(t[:P]) for t in (sin, cos))
    bounds = torch.zeros(2, dtype=torch.int32, device="cuda")

    def write(pos0, n):
        s_buf.copy_(sin[pos0:pos0 + P])
        c_buf.copy_(cos[pos0:pos0 + P])
        bounds.copy_(torch.tensor([pos0, n], dtype=torch.int32))

    def launch(pos0, n, **kw):
        return fpb.prefill_attn_block_cuda(x, *weights, s_buf, c_buf, kp, vp,
                                           table, pos0, n, **kw)
    write(*BOUNDS_REPLAY[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(*BOUNDS_REPLAY[0], bounds=bounds)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = launch(*BOUNDS_REPLAY[0], bounds=bounds)
    held = []
    for pos0, n in BOUNDS_REPLAY:
        write(pos0, n)
        graph.replay()
        want = launch(pos0, n)
        torch.cuda.synchronize()
        held.append({"pos0": pos0, "n_valid": n, "equal": all(
            torch.equal(a, b) for a, b in zip(outs, want))})
    del graph
    return {"dtype": str(x.dtype)[6:], "KV": kp.shape[2], "P": P,
            "cases": held, "ok": all(h["equal"] for h in held)}


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
    b_ms, b_by = bound(lambda: fpb.prefill_attn_block_cuda(*args))[:2]
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


# ---------------------------------------------------------------------------
# quantized weights: decode_attn_block, decode_mlp_block,
# decode_block_fused and prefill_attn_block with int8 and int4 weights.
# Each is held against its epilogue-order plain version at the fp phases'
# tolerances: f32 at atol=rtol=1e-4 (x_out) and 1e-5 (k_new, v_new); bf16
# at two bf16 ulps (bf16_close), since both sum the same exact products
# (integer weights are exact in f32) in f32 in other orders and round at
# the same points. In f32 each is also held against dequantize-then-matmul
# at 1e-4: the two differ by the rounding of q * s to f32.
# ---------------------------------------------------------------------------
WQ_BITS = {8: "int8", 4: "int4"}


def wq_leaves(ws, bits, down=None):
    """The fp weights ``ws`` as quantized leaves, made on the card by the
    port's PTQ harness (``down``, down_proj, packs its output axis)."""
    from paddle_tpu_torch.quantization import quantize_leaf
    return [quantize_leaf(w, bits, pack_axis=1 if w is down else 0)
            for w in ws]


def _library_products(x, leaves, rows):
    """``torch._weight_int8pack_mm`` over a block's int8 products on the
    same rows (the yardstick: a library call for the quantized products
    alone), or None where the card's PyTorch build has no CUDA kernel for
    it or the class is int4."""
    import torch
    if "qw8" not in leaves[0]:
        return None, "no PyTorch call takes int4 weights in this layout"
    try:
        args = [(torch.randn(rows, lf["qw8"].shape[0], device="cuda")
                 .to(x.dtype), lf["qw8"].t().contiguous(),
                 lf["scale"].to(x.dtype)) for lf in leaves]
        for a in args:
            torch._weight_int8pack_mm(*a)
        torch.cuda.synchronize()
        return (cold_ms(lambda: [torch._weight_int8pack_mm(*a)
                                 for a in args]),
                "torch._weight_int8pack_mm over the products")
    except (RuntimeError, NotImplementedError) as e:
        return None, f"torch._weight_int8pack_mm: {str(e)[:100]}"


def quant_attn_phase(gpu, bits):
    """decode_attn_block with int8/int4 weights against attn_block_wq_ref
    (its epilogue-order plain version) on the card at KV=32 and 8, f32
    and bf16, 8 and 20 slots, the fp phase's lengths; in f32 also against
    attn_block_ref (dequantize-then-matmul), at the fp tolerances; two
    launches bit for bit; dispatch must pick the kernel; each case records
    its body and the rule's reason (over bf16 pools the CUDA-core body).
    Timed at B 8, bf16, KV=32 beside its bound (integer weights and
    scales), its plain version and the fp kernel on the same
    activations."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    from paddle_tpu_torch.ops.rope import build_rope_cache
    wd = WQ_BITS[bits]
    gen = torch.Generator(device="cuda").manual_seed(30 + bits)
    rope = build_rope_cache(4096, HD7, device="cuda")
    cases, max_err, timed = [], 0.0, None
    for dt, KV, B in ((torch.bfloat16, 32, B8), (torch.float32, 32, B8),
                      (torch.bfloat16, 8, B8), (torch.float32, 8, 20)):
        fp = fused_attn_inputs(gen, dt, KV, rope, B)
        args = (*fp[:2], *wq_leaves(fp[2:6], bits), *fp[6:])
        meta = fdb.decode_meta_dims(B, D7, H7, KV, HD7, F7, BS16, MB72, dt,
                                    dt, False, weight_dtype=wd)
        picked = KERNELS.dispatch("decode_attn_block", meta)[0]
        got = fdb.decode_attn_block_cuda(*args)
        again = fdb.decode_attn_block_cuda(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        want = fdb.attn_block_wq_ref(*args)
        outs = {}
        for nm, g, w, tol in (("x_out", got[0], want[0], 1e-4),
                              ("k_new", got[1], want[1], 1e-5),
                              ("v_new", got[2], want[2], 1e-5)):
            outs[nm] = _check_case(nm, g, w, dt, tol)
            max_err = max(max_err, outs[nm]["max_abs_err"])
        if dt == torch.float32:
            comp = fdb.attn_block_ref(*args)
            outs["x_out_vs_dequant"] = _check_case("x_out", got[0], comp[0],
                                                   dt, 1e-4)
        torch.cuda.synchronize()
        case = {"dtype": str(dt)[6:], "KV": KV, "B": B, "outputs": outs,
                "bitwise_repeatable": same, "dispatch": picked,
                "body": launch_plan(lambda a=args: fdb.decode_attn_block_cuda(
                    *a))["body"],
                "ok": same and picked == "cuda_fused"
                and all(o["ok"] for o in outs.values())}
        cases.append(case)
        if not case["ok"]:
            emit({"phase": "kernel", "kernel": f"decode_attn_block[{wd}]",
                  "gpu": gpu, "cases": cases})
            raise AssertionError(f"decode_attn_block[{wd}] disagrees: {case}")
        if dt == torch.bfloat16 and KV == H7 and B == B8:
            timed, timed_fp = args, fp
    lens = timed[11].tolist()
    b_ms, b_by = bound(lambda: fdb.decode_attn_block_cuda(*timed), lens)[:2]
    lib_ms, lib = _library_products(timed[0], timed[2:6], B8)
    row = {"name": f"decode_attn_block[{wd}]", "route": "cuda",
           "source": FUSED_SOURCE,
           "replaces": "paddle_tpu/ops/pallas/fused_decode_block.py:436",
           "weights": wd,
           "shape": {"B": B8, "D": D7, "H": H7, "KV": H7, "hd": HD7,
                     "BS": BS16, "MB": MB72, "seq_lens": lens},
           "dtype": "bfloat16", "max_abs_err": max_err,
           "ms": cold_ms(lambda: fdb.decode_attn_block_cuda(*timed)),
           "plain_ms": cold_ms(lambda: fdb.attn_block_wq_ref(*timed)),
           "bound_ms": b_ms, "bound_by": b_by,
           "fp_kernel_ms": cold_ms(
               lambda: fdb.decode_attn_block_cuda(*timed_fp)),
           **body_row(fdb, lambda: fdb.decode_attn_block_cuda(*timed)),
           "library_ms": None,
           "library": "none: no single PyTorch call computes the block",
           "library_products_ms": lib_ms, "library_products": lib,
           "ok": True}
    emit({"phase": "kernel", "kernel": row["name"], "gpu": gpu,
          "cases": cases, **{k: row[k] for k in (
              "ms", "plain_ms", "bound_ms", "fp_kernel_ms", "body",
              "body_rule", "library_products_ms")}})
    return row


def quant_mlp_phase(gpu, bits):
    """decode_mlp_block with int8/int4 weights (gate/up packed along D,
    down along its output D) against mlp_block_wq_ref, f32 and bf16, F
    11008 and the fp phase's ragged F (11000 bf16, 11012 f32: served, the
    classes' loads divide those rows), 8, 20, 32 and 128 rows; in f32
    also against mlp_block_ref (dequantize-then-matmul); each case records
    its body. Timed in bf16 at 8, 16, 32 and 128 rows (at 8 the weight
    ring over the codes, beside its CUDA-core body on the same inputs;
    from 16 on the tensor-core body)."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    wd = WQ_BITS[bits]
    gen = torch.Generator(device="cuda").manual_seed(40 + bits)
    cases, max_err, rows = [], 0.0, {}
    for dt, F, B in ((torch.bfloat16, F7, B8), (torch.float32, F7, B8),
                     (torch.bfloat16, 11000, B8), (torch.float32, 11012, 20),
                     (torch.bfloat16, F7, 16), (torch.bfloat16, F7, 32),
                     (torch.bfloat16, F7, 128), (torch.float32, F7, 128)):
        def rn(*shape, std=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda")
                    * std).to(dt)
        fp = (rn(B, D7), (1 + 0.1 * torch.randn(
            D7, generator=gen, device="cuda")).to(dt),
            rn(D7, F, std=0.02), rn(D7, F, std=0.02), rn(F, D7, std=0.02))
        args = (*fp[:2], *wq_leaves(fp[2:], bits, down=fp[4]))
        meta = fdb.decode_meta_dims(B, D7, H7, H7, HD7, F, BS16, MB72, dt,
                                    dt, False, weight_dtype=wd)
        picked = KERNELS.dispatch("decode_mlp_block", meta)[0]
        got = fdb.decode_mlp_block_cuda(*args)
        again = fdb.decode_mlp_block_cuda(*args)
        want = fdb.mlp_block_wq_ref(*args)
        torch.cuda.synchronize()
        outs = {"x_out": _check_case("x_out", got, want, dt, 1e-4)}
        if dt == torch.float32:
            outs["x_out_vs_dequant"] = _check_case(
                "x_out", got, fdb.mlp_block_ref(*args), dt, 1e-4)
        max_err = max(max_err, outs["x_out"]["max_abs_err"])
        same = torch.equal(got, again)
        case = {"dtype": str(dt)[6:], "F": F, "B": B, "outputs": outs,
                "bitwise_repeatable": same, "dispatch": picked,
                "body": launch_plan(lambda a=args: fdb.decode_mlp_block_cuda(
                    *a))["body"],
                "ok": same and picked == "cuda_fused"
                and all(o["ok"] for o in outs.values())}
        if dt == torch.bfloat16 and F == F7:
            b_ms, b_by = bound(
                lambda: fdb.decode_mlp_block_cuda(*args))[:2]
            rows[B] = {
                "ms": cold_ms(lambda: fdb.decode_mlp_block_cuda(*args)),
                "plain_ms": cold_ms(lambda: fdb.mlp_block_wq_ref(*args)),
                "bound_ms": b_ms, "bound_by": b_by,
                "fp_kernel_ms": cold_ms(
                    lambda: fdb.decode_mlp_block_cuda(*fp))}
            rows[B]["library_products_ms"], rows[B]["library_products"] = \
                _library_products(fp[0], args[2:], B)
            rows[B]["body"] = case["body"]
            if B == B8:
                rows[B]["cuda_core_ms"] = core_ms(
                    fdb, lambda: fdb.decode_mlp_block_cuda(*args))
            case["ms"] = rows[B]["ms"]
        cases.append(case)
        if not case["ok"]:
            emit({"phase": "kernel", "kernel": f"decode_mlp_block[{wd}]",
                  "gpu": gpu, "cases": cases})
            raise AssertionError(f"decode_mlp_block[{wd}] disagrees: {case}")
    row = {"name": f"decode_mlp_block[{wd}]", "route": "cuda",
           "source": FUSED_SOURCE,
           "replaces": "paddle_tpu/ops/pallas/fused_decode_block.py:645",
           "weights": wd, "shape": {"B": B8, "D": D7, "F": F7},
           "dtype": "bfloat16", "max_abs_err": max_err, **rows[B8],
           "library_ms": None,
           "library": "none: no single PyTorch call computes the block",
           "prefill_rows": {k: v for k, v in rows.items() if k != B8},
           "ok": True}
    emit({"phase": "kernel", "kernel": row["name"], "gpu": gpu,
          "cases": cases, "rows": rows})
    return row


def quant_block_phase(gpu, bits):
    """decode_block_fused with int8/int4 weights against decode_block_ref
    (the JAX block kernel's rounding points, scales in the epilogue) at
    KV=32 and 8, f32 and bf16, 8 and 20 slots, F 11008 and 11000; in f32
    also against the dequantize composition (attn_block_ref then
    mlp_block_ref); two launches bit for bit; dispatch must pick it; each
    case records its body (bf16 at up to 8 rows: the weight ring over the
    codes; f32, 20 slots and F 11000: the CUDA-core body), and bf16 at 7
    slots runs the ring too. Timed at B 8, bf16, beside its bound, its
    plain version, the bf16-weight ring on the same activations, the
    quantized two-stage pair and its own CUDA-core body on the same
    inputs."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    from paddle_tpu_torch.ops.rope import build_rope_cache
    wd = WQ_BITS[bits]
    gen = torch.Generator(device="cuda").manual_seed(50 + bits)
    rope = build_rope_cache(4096, HD7, device="cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    cases, max_err, timed = [], 0.0, None
    for dt, KV, B, F in ((bf16, 32, B8, F7), (f32, 32, B8, F7),
                         (bf16, 8, B8, F7), (f32, 8, 20, F7),
                         (bf16, 32, B8, 11000), (bf16, 32, 7, F7)):
        fp = block_inputs(gen, dt, KV, F, rope, B)
        args = (*fp[:2], *wq_leaves(fp[2:6], bits), fp[6],
                *wq_leaves(fp[7:10], bits, down=fp[9]), *fp[10:])
        plan = launch_plan(lambda a=args: fdb.decode_block_fused_cuda(*a))
        meta = fdb.decode_meta_dims(B, D7, H7, KV, HD7, F, BS16, MB72, dt,
                                    dt, False, weight_dtype=wd)
        picked = KERNELS.dispatch("decode_block_fused", meta)[0]
        got = fdb.decode_block_fused_cuda(*args)
        again = fdb.decode_block_fused_cuda(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        want = fdb.decode_block_ref(*args)
        outs = {}
        for nm, g, w, tol in (("x_out", got[0], want[0], 1e-4),
                              ("k_new", got[1], want[1], 1e-5),
                              ("v_new", got[2], want[2], 1e-5)):
            outs[nm] = _check_case(nm, g, w, dt, tol)
        max_err = max([max_err] + [o["max_abs_err"] for o in outs.values()])
        if dt == f32:
            xo, _, _ = fdb.attn_block_ref(*args[:6], *args[10:])
            comp = fdb.mlp_block_ref(xo, *args[6:10])
            outs["x_out_vs_dequant"] = _check_case("x_out", got[0], comp,
                                                   dt, 1e-4)
        torch.cuda.synchronize()
        case = {"dtype": str(dt)[6:], "KV": KV, "B": B, "F": F,
                "outputs": outs, "bitwise_repeatable": same,
                "dispatch": picked, "body": plan["body"],
                "body_rule": plan["body_rule"],
                "ok": same and picked == "cuda_block"
                and all(o["ok"] for o in outs.values())}
        cases.append(case)
        if not case["ok"]:
            emit({"phase": "kernel", "kernel": f"decode_block_fused[{wd}]",
                  "gpu": gpu, "cases": cases})
            raise AssertionError(f"decode_block_fused[{wd}] disagrees: {case}")
        if dt == bf16 and KV == H7 and B == B8 and F == F7:
            timed, timed_fp = args, fp
    lens = timed[15].tolist()
    b_ms, b_by = bound(lambda: fdb.decode_block_fused_cuda(*timed),
                       lens)[:2]

    def two_stage():
        xo, _, _ = fdb.decode_attn_block_cuda(*timed[:6], *timed[10:])
        return fdb.decode_mlp_block_cuda(xo, *timed[6:10])
    with cuda_core_block(fdb):
        core_ms = cold_ms(lambda: fdb.decode_block_fused_cuda(*timed))
    row = {"name": f"decode_block_fused[{wd}]", "route": "cuda",
           "source": FUSED_SOURCE,
           "replaces": "paddle_tpu/ops/pallas/fused_decode_block.py:1021",
           "weights": wd,
           "shape": {"B": B8, "D": D7, "H": H7, "KV": H7, "hd": HD7,
                     "F": F7, "BS": BS16, "MB": MB72, "seq_lens": lens},
           "dtype": "bfloat16", "max_abs_err": max_err,
           "ms": cold_ms(lambda: fdb.decode_block_fused_cuda(*timed)),
           "plain_ms": cold_ms(lambda: fdb.decode_block_ref(*timed)),
           "bound_ms": b_ms, "bound_by": b_by,
           "fp_kernel_ms": cold_ms(
               lambda: fdb.decode_block_fused_cuda(*timed_fp)),
           "two_stage_ms": cold_ms(two_stage), "cuda_core_ms": core_ms,
           "body": launch_plan(
               lambda: fdb.decode_block_fused_cuda(*timed))["body"],
           "library_ms": None,
           "library": "none: no single PyTorch call computes the layer",
           "ok": True}
    emit({"phase": "kernel", "kernel": row["name"], "gpu": gpu,
          "cases": cases, **{k: row[k] for k in (
              "ms", "plain_ms", "bound_ms", "fp_kernel_ms",
              "two_stage_ms", "cuda_core_ms", "body")}})
    return row


def quant_prefill_phase(gpu, bits):
    """prefill_attn_block with int8/int4 weights against
    prefill_attn_block_wq_ref at KV=32 and 8, f32 and bf16, P=32 and 128
    (and 16 in bf16), (pos0, n_valid) = (0, P), (5, P-3) and (600,
    PREFILL_PARTIAL's); in f32 also
    against prefill_attn_block_ref (dequantize-then-matmul); the real rows
    at the fp tolerances, every row finite, two launches bit for bit.
    Timed at P=128, bf16, KV=32, pos0 512, beside its bound, its plain
    version and the fp kernel on the same activations."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    from paddle_tpu_torch.ops.rope import build_rope_cache
    wd = WQ_BITS[bits]
    gen = torch.Generator(device="cuda").manual_seed(60 + bits)
    D, H, hd, BS, MB = D7, H7, HD7, BS16, MB72
    sin, cos = build_rope_cache(MB * BS, hd, device="cuda")
    cases, max_err, timed = [], 0.0, None
    for dt in (torch.bfloat16, torch.float32):
        def rn(*shape, std=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda")
                    * std).to(dt)
        for KV in (H, 8):
            table = (torch.randperm(MB, generator=gen, device="cuda") + 1
                     ).to(torch.int32)
            fpw = ((1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
                    ).to(dt), rn(D, H * hd, std=0.02),
                   rn(D, KV * hd, std=0.02), rn(D, KV * hd, std=0.02),
                   rn(H * hd, D, std=0.02))
            weights = (fpw[0], *wq_leaves(fpw[1:], bits))
            kp, vp = rn(MB + 1, BS, KV, hd), rn(MB + 1, BS, KV, hd)
            for P in ((16, 32, 128) if dt == torch.bfloat16 else (32, 128)):
                meta = fpb.prefill_meta_dims(P, D, H, KV, hd, F7, BS, MB, dt,
                                             dt, False, weight_dtype=wd)
                picked = KERNELS.dispatch("prefill_attn_block", meta)[0]
                for pos0, n in ((0, P), (5, P - 3),
                                (600, PREFILL_PARTIAL[P])):
                    args = (rn(P, D), *weights, sin[pos0:pos0 + P],
                            cos[pos0:pos0 + P], kp, vp, table, pos0, n)
                    got = fpb.prefill_attn_block_cuda(*args)
                    again = fpb.prefill_attn_block_cuda(*args)
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    want = fpb.prefill_attn_block_wq_ref(*args)
                    outs = {}
                    for nm, g, w, tol in (("x_out", got[0], want[0], 1e-4),
                                          ("k_new", got[1], want[1], 1e-5),
                                          ("v_new", got[2], want[2], 1e-5)):
                        outs[nm] = _check_case(nm, g[:n], w[:n], dt, tol)
                        max_err = max(max_err, outs[nm]["max_abs_err"])
                    if dt == torch.float32:
                        comp = fpb.prefill_attn_block_ref(*args)
                        outs["x_out_vs_dequant"] = _check_case(
                            "x_out", got[0][:n], comp[0][:n], dt, 1e-4)
                    torch.cuda.synchronize()
                    finite = bool(torch.isfinite(got[0]).all())
                    case = {"dtype": str(dt)[6:], "KV": KV, "P": P,
                            "pos0": pos0, "n_valid": n, "outputs": outs,
                            "pad_rows_finite": finite,
                            "bitwise_repeatable": same, "dispatch": picked,
                            "body": launch_plan(
                                lambda a=args: fpb.prefill_attn_block_cuda(
                                    *a))["body"],
                            "ok": same and finite and picked == "cuda_fused"
                            and all(o["ok"] for o in outs.values())}
                    cases.append(case)
                    if not case["ok"]:
                        emit({"phase": "kernel",
                              "kernel": f"prefill_attn_block[{wd}]",
                              "gpu": gpu, "cases": cases})
                        raise AssertionError(
                            f"prefill_attn_block[{wd}] disagrees: {case}")
            if dt == torch.bfloat16 and KV == H:
                pos0 = 512
                x = rn(128, D)
                timed = (x, *weights, sin[pos0:pos0 + 128],
                         cos[pos0:pos0 + 128], kp, vp, table, pos0, 128)
                timed_fp = (x, *fpw, *timed[6:])
    b_ms, b_by = bound(lambda: fpb.prefill_attn_block_cuda(*timed))[:2]
    row = {"name": f"prefill_attn_block[{wd}]", "route": "cuda",
           "source": PREFILL_SOURCE,
           "replaces": "paddle_tpu/ops/pallas/fused_prefill_block.py:431",
           "weights": wd,
           "shape": {"P": 128, "n_valid": 128, "pos0": 512, "D": D, "H": H,
                     "KV": H, "hd": hd, "BS": BS, "MB": MB},
           "dtype": "bfloat16", "max_abs_err": max_err,
           "ms": cold_ms(lambda: fpb.prefill_attn_block_cuda(*timed)),
           "plain_ms": cold_ms(lambda: fpb.prefill_attn_block_wq_ref(*timed)),
           "bound_ms": b_ms, "bound_by": b_by,
           "fp_kernel_ms": cold_ms(
               lambda: fpb.prefill_attn_block_cuda(*timed_fp)),
           "library_ms": None,
           "library": "none: no single PyTorch call computes the block",
           "ok": True}
    emit({"phase": "kernel", "kernel": row["name"], "gpu": gpu,
          "cases": cases, **{k: row[k] for k in (
              "ms", "plain_ms", "bound_ms", "fp_kernel_ms")}})
    return row


def quant_kernel_phases(gpu):
    """The four quantized-weight kernels, int8 then int4."""
    rows = []
    for bits in WQ_BITS:
        rows += [quant_attn_phase(gpu, bits), quant_mlp_phase(gpu, bits),
                 quant_block_phase(gpu, bits),
                 quant_prefill_phase(gpu, bits)]
    return rows


# ---------------------------------------------------------------------------
# the int8-pool bodies (the int8 KV cache): decode_attn_block,
# decode_block_fused and prefill_attn_block over int8 pools with f32
# per-head scales, in fp, int8 and int4 weights, each against its
# kernel-order plain version (attn_block_wq_ref, decode_block_ref,
# prefill_attn_block_wq_ref with kv_scales) at the fp-pool phases'
# tolerances, and timed beside the fp-pool kernel on the same activations
# (pools holding the int8 codes dequantized to the model type).
# ---------------------------------------------------------------------------
KV8_WEIGHTS = (0, 8, 4)
# extra absolute error allowed on a decode row whose new-token K or V
# codes differ between the kernel and the plain version: their k_new/v_new
# differ by product roundoff, which now and then straddles a rounding
# boundary of round(x / s); one code step of that one token (s ~ absmax /
# 127) moves the row's attention output by up to ~s
KV8_FLIP_ATOL = 5e-3


def kv8_pools(kp, vp):
    """int8 pools and their f32 [KV] scales made from fp pools by the
    port's ``quantize_pools`` (on the card), and the fp pools they stand
    for (the codes dequantized to the pools' type): the same activations
    for the fp-pool kernel."""
    from paddle_tpu_torch.ops.paged_attention import quantize_pools
    kq, vq, ks, vs = quantize_pools(kp, vp)

    def deq(q, sc):
        return (q.float() * sc[None, None, :, None]).to(kp.dtype)
    return kq, vq, (ks, vs), deq(kq, ks), deq(vq, vs)


def _code_flips(got, want, sc):
    """Rows of a new-token K or V [rows, KV, hd] whose int8 codes under the
    scales ``sc`` differ between two computations, and how many codes
    differ."""
    import torch

    def codes(t):
        return torch.clamp(torch.round(t.float() / sc[None, :, None]),
                           -127, 127)
    d = codes(got) != codes(want)
    return d.flatten(1).any(1), int(d.sum())


def _kv8_decode_outputs(got, want, dt, scales):
    """A decode kernel's (x_out, k_new, v_new) over int8 pools against its
    plain version's: k_new and v_new at the fp phases' tolerances; x_out
    at the fp phases' tolerances on every row whose new-token codes agree,
    and with KV8_FLIP_ATOL more on a row whose codes differ. Returns (the
    outputs' records, rows with a differing code, codes that differ)."""
    import torch
    fk, nk = _code_flips(got[1], want[1], scales[0])
    fv, nv = _code_flips(got[2], want[2], scales[1])
    flipped = fk | fv
    outs = {"k_new": _check_case("k_new", got[1], want[1], dt, 1e-5),
            "v_new": _check_case("v_new", got[2], want[2], dt, 1e-5)}
    keep = ~flipped
    outs["x_out"] = _check_case("x_out", got[0][keep], want[0][keep], dt,
                                1e-4)
    if bool(flipped.any()):
        g, w = got[0][flipped].float(), want[0][flipped].float()
        if dt == torch.float32:
            ok = bool(torch.allclose(g, w, atol=1e-4 + KV8_FLIP_ATOL,
                                     rtol=1e-4))
        else:
            ok = bf16_close(g, w, floor=KV8_FLIP_ATOL)[0]
        outs["x_out_rows_with_a_code_flip"] = {
            "max_abs_err": float((g - w).abs().max()),
            "tol": f"the x_out tolerance + {KV8_FLIP_ATOL} absolute",
            "ok": ok}
    return outs, int(flipped.sum()), nk + nv


def kv8_decode_phase(gpu, op):
    """``op`` ("decode_attn_block" or "decode_block_fused") over int8
    pools in fp, int8 and int4 weights: bf16 at KV=32 and 8 slots and, for
    fp weights, f32 at KV=32 (8 slots) and KV=8 (20 slots, GQA, three
    passes), int8 and int4 also bf16 at KV=8; the fp phases' lengths
    (0/1/15/16/17/1151 and random). Each case: two launches bit for bit,
    dispatch picks the kernel on the int8-pool meta, and the outputs hold
    the kernel-order plain version (_kv8_decode_outputs). Timed at B 8,
    bf16, KV=32 beside its bound (int8 pages and their scales, the
    weights in their class), its plain version and the fp-pool kernel on
    the same activations; each case records its body (decode_attn_block's
    ring at 8 bf16 rows in every weight class, held against the plain
    version as every case is); each timed row its body,
    the rule's reason and, on the ring, the CUDA-core body's time on the
    same inputs (:func:`body_row`); decode_block_fused's row also the
    two-stage pair's (decode_attn_block then decode_mlp_block) and, for
    int8 and int4 weights, the bf16-weight ring's on the same activations
    and pools (decode_block_fused's bf16 cases at 8 slots run the weight
    ring over bf16, int8 and int4 weights)."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    from paddle_tpu_torch.ops.rope import build_rope_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attn = op == "decode_attn_block"
    wrapper = fdb.decode_attn_block_cuda if attn \
        else fdb.decode_block_fused_cuda
    plain = fdb.attn_block_wq_ref if attn else fdb.decode_block_ref
    variant = "cuda_fused" if attn else "cuda_block"
    ip = 8 if attn else 12            # k_pool's place in the arguments
    gen = torch.Generator(device="cuda").manual_seed(80 + attn)
    rope = build_rope_cache(4096, HD7, device="cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    for bits in KV8_WEIGHTS:
        wd = WQ_BITS.get(bits)
        name = f"{op}[{wd + ',' if wd else ''}kv8]"
        specs = (((bf16, 32, B8), (f32, 32, B8), (f32, 8, 20)) if not bits
                 else ((bf16, 32, B8), (bf16, 8, B8)))
        cases, max_err, timed = [], 0.0, None
        for dt, KV, B in specs:
            base = (fused_attn_inputs(gen, dt, KV, rope, B) if attn
                    else block_inputs(gen, dt, KV, F7, rope, B))
            fp_weights = base
            if bits and attn:
                base = (*base[:2], *wq_leaves(base[2:6], bits), *base[6:])
            elif bits:
                base = (*base[:2], *wq_leaves(base[2:6], bits), base[6],
                        *wq_leaves(base[7:10], bits, down=base[9]),
                        *base[10:])
            kq, vq, scales, kd, vd = kv8_pools(base[ip], base[ip + 1])
            args = (*base[:ip], kq, vq, *base[ip + 2:])
            fp_args = (*base[:ip], kd, vd, *base[ip + 2:])
            meta = fdb.decode_meta_dims(B, D7, H7, KV, HD7, F7, BS16, MB72,
                                        dt, torch.int8, True,
                                        weight_dtype=wd)
            picked = KERNELS.dispatch(op, meta)[0]
            got = wrapper(*args, kv_scales=scales)
            again = wrapper(*args, kv_scales=scales)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            want = plain(*args, kv_scales=scales)  # writes the new codes
            torch.cuda.synchronize()
            outs, flip_rows, flip_codes = _kv8_decode_outputs(got, want, dt,
                                                              scales)
            max_err = max([max_err] + [o["max_abs_err"]
                                       for o in outs.values()])
            case = {"dtype": str(dt)[6:], "KV": KV, "B": B,
                    "seq_lens": args[ip + 3].tolist(), "outputs": outs,
                    "rows_with_a_code_flip": flip_rows,
                    "codes_flipped": flip_codes,
                    "bitwise_repeatable": same, "dispatch": picked,
                    "body": launch_plan(lambda a=args: wrapper(
                        *a, kv_scales=scales)).get("body", "cuda_core"),
                    "ok": same and picked == variant
                    and all(o["ok"] for o in outs.values())}
            cases.append(case)
            if not case["ok"]:
                emit({"phase": "kernel", "kernel": name, "gpu": gpu,
                      "cases": cases})
                raise AssertionError(f"{name} disagrees: {case}")
            if dt == bf16 and KV == H7 and B == B8:
                timed, timed_fp, tsc = args, fp_args, scales
                timed_bf16w = (*fp_weights[:ip], kq, vq,
                               *fp_weights[ip + 2:])
        lens = timed[ip + 3].tolist()
        b_ms, b_by = bound(lambda: wrapper(*timed, kv_scales=tsc), lens)[:2]
        row = {"name": name, "route": "cuda", "source": FUSED_SOURCE,
               "replaces": "paddle_tpu/ops/pallas/fused_decode_block.py:"
                           + ("436" if attn else "1021"),
               "weights": wd or "bfloat16", "pools": "int8",
               "shape": {"B": B8, "D": D7, "H": H7, "KV": H7, "hd": HD7,
                         **({} if attn else {"F": F7}), "BS": BS16,
                         "MB": MB72, "seq_lens": lens},
               "dtype": "bfloat16", "max_abs_err": max_err,
               "ms": cold_ms(lambda: wrapper(*timed, kv_scales=tsc)),
               "plain_ms": cold_ms(lambda: plain(*timed, kv_scales=tsc)),
               "bound_ms": b_ms, "bound_by": b_by,
               "fp_pool_kernel_ms": cold_ms(lambda: wrapper(*timed_fp)),
               "library_ms": None,
               "library": "none: no single PyTorch call computes the "
                          + ("block" if attn else "layer"),
               "ok": True}
        row.update(body_row(fdb, lambda: wrapper(*timed, kv_scales=tsc)))
        if not attn:
            def two_stage():
                xo, _, _ = fdb.decode_attn_block_cuda(
                    *timed[:6], *timed[10:], kv_scales=tsc)
                return fdb.decode_mlp_block_cuda(xo, *timed[6:10])
            row["two_stage_ms"] = cold_ms(two_stage)
            if bits:
                row["bf16_ring_ms"] = cold_ms(
                    lambda: wrapper(*timed_bf16w, kv_scales=tsc))
        emit({"phase": "kernel", "kernel": name, "gpu": gpu,
              "cases": cases, **{k: row[k] for k in (
                  "ms", "plain_ms", "bound_ms", "fp_pool_kernel_ms",
                  "cuda_core_ms", "two_stage_ms", "bf16_ring_ms", "body",
                  "body_rule")
                  if k in row}})
        rows.append(row)
    return rows


def kv8_prefill_phase(gpu):
    """prefill_attn_block over int8 history pages in fp, int8 and int4
    weights against prefill_attn_block_wq_ref (history dequantized in f32,
    the chunk's K/V at the model type): bf16, KV=32, P=128 with (pos0,
    n_valid) = (0, 128), (5, 125), (600, 77), KV=32, P=32 with (5, 29) and
    (600, 21), and KV=8, P=16 with (0, 16) and (600, 11); for fp weights
    also f32,
    KV=8, P=32 with (5, 29) and (600, 21); the real rows at the fp
    tolerances (the kernel quantizes nothing, so no code can flip), every
    row finite, two launches bit for bit, dispatch on the int8-pool meta.
    Timed at P=128, bf16, KV=32, pos0 512 beside its bound, its plain
    version and the fp-pool kernel on the same activations. Each case
    records its body (bf16: the tensor cores, the history's codes
    converted exactly to bf16 with the scales on the f32 sums; f32: the
    CUDA cores)."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    from paddle_tpu_torch.ops.rope import build_rope_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(90)
    D, H, hd, BS, MB = D7, H7, HD7, BS16, MB72
    sin, cos = build_rope_cache(MB * BS, hd, device="cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    for bits in KV8_WEIGHTS:
        wd = WQ_BITS.get(bits)
        name = f"prefill_attn_block[{wd + ',' if wd else ''}kv8]"
        specs = [(bf16, H, 128, ((0, 128), (5, 125), (600, 77))),
                 (bf16, H, 32, ((5, 29), (600, 21))),
                 (bf16, 8, 16, ((0, 16), (600, 11)))]
        if not bits:
            specs.append((f32, 8, 32, ((5, 29), (600, 21))))
        cases, max_err, timed = [], 0.0, None
        for dt, KV, P, spans in specs:
            def rn(*shape, std=1.0):
                return (torch.randn(*shape, generator=gen, device="cuda")
                        * std).to(dt)
            table = (torch.randperm(MB, generator=gen, device="cuda") + 1
                     ).to(torch.int32)
            fpw = ((1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
                    ).to(dt), rn(D, H * hd, std=0.02),
                   rn(D, KV * hd, std=0.02), rn(D, KV * hd, std=0.02),
                   rn(H * hd, D, std=0.02))
            weights = (fpw[0], *wq_leaves(fpw[1:], bits)) if bits else fpw
            kq, vq, scales, kd, vd = kv8_pools(rn(MB + 1, BS, KV, hd),
                                               rn(MB + 1, BS, KV, hd))
            meta = fpb.prefill_meta_dims(P, D, H, KV, hd, F7, BS, MB, dt,
                                         torch.int8, True, weight_dtype=wd)
            picked = KERNELS.dispatch("prefill_attn_block", meta)[0]
            for pos0, n in spans:
                args = (rn(P, D), *weights, sin[pos0:pos0 + P],
                        cos[pos0:pos0 + P], kq, vq, table, pos0, n)
                got = fpb.prefill_attn_block_cuda(*args, kv_scales=scales)
                again = fpb.prefill_attn_block_cuda(*args, kv_scales=scales)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                want = fpb.prefill_attn_block_wq_ref(*args, kv_scales=scales)
                outs = {}
                for nm, g, w, tol in (("x_out", got[0], want[0], 1e-4),
                                      ("k_new", got[1], want[1], 1e-5),
                                      ("v_new", got[2], want[2], 1e-5)):
                    outs[nm] = _check_case(nm, g[:n], w[:n], dt, tol)
                    max_err = max(max_err, outs[nm]["max_abs_err"])
                torch.cuda.synchronize()
                finite = bool(torch.isfinite(got[0]).all())
                case = {"dtype": str(dt)[6:], "KV": KV, "P": P,
                        "pos0": pos0, "n_valid": n, "outputs": outs,
                        "pad_rows_finite": finite,
                        "bitwise_repeatable": same, "dispatch": picked,
                        "body": launch_plan(
                            lambda a=args: fpb.prefill_attn_block_cuda(
                                *a, kv_scales=scales))["body"],
                        "ok": same and finite and picked == "cuda_fused"
                        and all(o["ok"] for o in outs.values())}
                cases.append(case)
                if not case["ok"]:
                    emit({"phase": "kernel", "kernel": name, "gpu": gpu,
                          "cases": cases})
                    raise AssertionError(f"{name} disagrees: {case}")
            if dt == bf16 and P == 128:
                pos0 = 512
                x = rn(128, D)
                timed = (x, *weights, sin[pos0:pos0 + 128],
                         cos[pos0:pos0 + 128], kq, vq, table, pos0, 128)
                timed_fp = (*timed[:8], kd, vd, *timed[10:])
                tsc = scales
        b_ms, b_by = bound(lambda: fpb.prefill_attn_block_cuda(
            *timed, kv_scales=tsc))[:2]
        row = {"name": name, "route": "cuda", "source": PREFILL_SOURCE,
               "replaces": "paddle_tpu/ops/pallas/fused_prefill_block.py:431",
               "weights": wd or "bfloat16", "pools": "int8",
               "shape": {"P": 128, "n_valid": 128, "pos0": 512, "D": D,
                         "H": H, "KV": H, "hd": hd, "BS": BS, "MB": MB},
               "dtype": "bfloat16", "max_abs_err": max_err,
               "ms": cold_ms(lambda: fpb.prefill_attn_block_cuda(
                   *timed, kv_scales=tsc)),
               "plain_ms": cold_ms(lambda: fpb.prefill_attn_block_wq_ref(
                   *timed, kv_scales=tsc)),
               "bound_ms": b_ms, "bound_by": b_by,
               "fp_pool_kernel_ms": cold_ms(
                   lambda: fpb.prefill_attn_block_cuda(*timed_fp)),
               "body": launch_plan(lambda: fpb.prefill_attn_block_cuda(
                   *timed, kv_scales=tsc))["body"],
               "library_ms": None,
               "library": "none: no single PyTorch call computes the block",
               "ok": True}
        emit({"phase": "kernel", "kernel": name, "gpu": gpu,
              "cases": cases, **{k: row[k] for k in (
                  "ms", "plain_ms", "bound_ms", "fp_pool_kernel_ms")}})
        rows.append(row)
    return rows


def kv8_kernel_phases(gpu):
    """The three int8-pool bodies, each in fp, int8 and int4 weights."""
    return (kv8_decode_phase(gpu, "decode_attn_block")
            + kv8_decode_phase(gpu, "decode_block_fused")
            + kv8_prefill_phase(gpu))


# the serving routes: the engine's knobs for each
ROUTES = {"default": {"fused_decode": None, "fused_prefill": None},
          "two_stage": {"fused_decode": "pallas", "fused_prefill": None},
          "unfused": {"fused_decode": False, "fused_prefill": False}}
# the weight-quantized routes (this slice's main path: int8 and int4 on the
# default route, int8 on the two-stage route)
QUANT_ROUTES = {"int8_default": dict(ROUTES["default"], weight_quant="int8"),
                "int4_default": dict(ROUTES["default"], weight_quant="int4"),
                "int8_two_stage": dict(ROUTES["two_stage"],
                                       weight_quant="int8")}
# the int8 KV cache (this slice's main path): the three routes over int8
# pools, and int8 weights on int8 pools on the default route
KV8_ROUTES = {f"kv8_{r}": dict(ROUTES[r], cache_dtype="int8")
              for r in ROUTES}
KV8_ROUTES["int8_kv8_default"] = dict(KV8_ROUTES["kv8_default"],
                                      weight_quant="int8")
ALL_ROUTES = {**ROUTES, **QUANT_ROUTES, **KV8_ROUTES}
# the pool codes that may differ between two routes over int8 pools, as a
# share of the codes written: a kernel's new-token K/V differ from the
# composition's by product roundoff, which now and then crosses a rounding
# boundary of round(x / s), and the next layer and later tokens inherit
# that one-code step as an input difference of ~s / 127 relative
KV8_PARITY_FLIPS = 0.01


def _route_base(route):
    """The decode/prefill route under a route's weight and pool classes:
    "default", "two_stage" or "unfused"."""
    for prefix in ("int8_", "int4_", "kv8_"):
        route = route.removeprefix(prefix)
    return route


@contextlib.contextmanager
def counted_dequantize():
    """Counts the calls of the dequantize-then-matmul building block
    (``quantization.quanters.dequantize_weight``) inside the block."""
    from paddle_tpu_torch.quantization import quanters
    orig, calls = quanters.dequantize_weight, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)
    quanters.dequantize_weight = counted
    try:
        yield calls
    finally:
        quanters.dequantize_weight = orig


def parity_phase(gpu, wq=None):
    """Route parity, f32 at LLaMA-7B widths with 2 layers: the engine on
    its default route (the prefill kernel, decode_mlp_block as the prefill
    MLP, the single-launch decode_block_fused kernel), on the two-stage
    decode route (``fused_decode="pallas"``: decode_attn_block and
    decode_mlp_block) and on the unfused route (paged-attention and
    RMSNorm kernels, the verbatim prefill chunk), each against the port's
    dense ``generate``. Tokens must be equal, or the first divergence must
    sit on a near tie (top-2 logit gap < 1e-4). With ``wq`` ("int8",
    "int4") the tree is quantized on the card first, and every engine and
    ``generate`` serve that one tree (the fused routes through the
    kernels' quantized bodies, the unfused routes and ``generate``
    dequantize-then-matmul); one layer's quantized leaves must equal, byte
    for byte, the same layer quantized on the CPU."""
    import dataclasses
    import torch
    from paddle_tpu_torch.inference import (GenerationConfig,
                                            ServingEngine, generate)
    from paddle_tpu_torch.inference.generation import (cached_forward,
                                                       init_cache)
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    from paddle_tpu_torch.quantization import WQ_KEYS, quantize_weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LLAMA_7B, num_hidden_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, seed=1)
    card_vs_cpu = None
    if wq:
        bits = {"int8": 8, "int4": 4}[wq]
        fp = params
        params = quantize_weights(fp, bits=bits)
        cpu = quantize_weights({"layers": {k: fp["layers"][k][1:].cpu()
                                           for k in WQ_KEYS}}, bits=bits)
        card_vs_cpu = all(
            torch.equal(params["layers"][k][part][1:].cpu(), t)
            for k in WQ_KEYS for part, t in cpu["layers"][k].items())
        del fp, cpu
    specs = [(5, 6), (40, 4), (300, 5), (17, 3), (129, 5)]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, S).astype(np.int32)
               for S, _ in specs]
    wants = [generate(params, p[None], cfg,
                      GenerationConfig(max_new_tokens=N, greedy=True)
                      )[0, S:].tolist()
             for p, (S, N) in zip(prompts, specs)]
    routes = {}
    for route, knobs in ROUTES.items():
        eng = ServingEngine(params, cfg, capacity=2, block_size=16,
                            max_seq_len=512, prefill_buckets=(32, 128),
                            **knobs)
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
    for route in ("two_stage", "unfused"):
        routes[f"default_equals_{route}"] = (routes["default"]["tokens"]
                                             == routes[route]["tokens"])
    emit({"phase": "parity", "gpu": gpu, "dtype": "float32", "layers": 2,
          "weight_quant": wq, "quantized_on_card_equals_cpu": card_vs_cpu,
          **{k: ({kk: vv for kk, vv in v.items() if kk != "tokens"}
                 if isinstance(v, dict) else v) for k, v in routes.items()}})
    if card_vs_cpu is False:
        raise AssertionError(f"{wq}: the card's quantized leaves differ "
                             "from the CPU's")
    _check_default_route(routes["default"], "parity engine")
    if routes["two_stage"]["decode_variant"]["attn"] != "cuda_fused":
        raise AssertionError("the two-stage parity engine is not on the "
                             "decode_attn_block kernel: "
                             f"{routes['two_stage']['decode_variant']}")
    for route in ROUTES:
        for res in routes[route]["requests"]:
            if not res["match"] and res["top2_logit_gap"] >= 1e-4:
                raise AssertionError(
                    f"{route} engine and generate diverge: {res}")


def _snapshot_written_codes(eng):
    """As each request of ``eng`` finishes, a copy of the K and V codes it
    wrote ([L, positions, KV, hd]: its prompt and every generated token
    but the last), read from its pages before they are released; a later
    request may reuse the pages, and a verbatim chunk's pad rows land past
    the written positions. Returns the dict {req_id: (k, v)} it fills."""
    import torch
    codes, finish = {}, eng._finish

    def snapshot_then_finish(slot_id):
        req = eng._slots[slot_id].req
        n = int(req.prompt.size) + len(req.tokens) - 1
        pages = torch.tensor(eng.mgr.tables[req.req_id], device=eng.device)
        L, _, _, KV, hd = eng._k_pools.shape
        codes[req.req_id] = tuple(
            pool[:, pages].reshape(L, -1, KV, hd)[:, :n].clone()
            for pool in (eng._k_pools, eng._v_pools))
        finish(slot_id)
    eng._finish = snapshot_then_finish
    return codes


def kv8_parity_phase(gpu):
    """Route parity over int8 pools, f32 at LLaMA-7B widths with 2 layers:
    the engine with ``cache_dtype="int8"`` on its default route (the fused
    chunk and the single-launch decode kernel, their int8-pool bodies), on
    the two-stage route and on the unfused route (the verbatim chunk
    dequantizing its dense view, the dequantizing paged-attention
    composition). The three engines calibrate from the same first prompt
    through the same dense forward, so their scales must be equal; their
    greedy ids for 5 requests through 2 slots must be equal; the pool
    codes each request wrote (its prompt and every generated token but
    the last, read from its pages as it finishes) on each kernel route
    against the unfused route's may differ by one code step only, in at
    most KV8_PARITY_FLIPS of them; every launch of the three int8-pool
    kernels must be in the int8 pool class."""
    import dataclasses
    import torch
    from paddle_tpu_torch.inference import GenerationConfig, ServingEngine
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    from paddle_tpu_torch.ops import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LLAMA_7B, num_hidden_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, seed=1)
    specs = [(5, 6), (40, 4), (300, 5), (17, 3), (129, 5)]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, S).astype(np.int32)
               for S, _ in specs]
    L, KV, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                 cfg.head_dim)
    written = sum(S + N - 1 for S, N in specs) * L * KV * hd * 2
    routes, engines, written_codes = {}, {}, {}
    for r in ROUTES:
        kernels.reset_launches()
        eng = ServingEngine(params, cfg, capacity=2, block_size=16,
                            max_seq_len=512, prefill_buckets=(32, 128),
                            **KV8_ROUTES[f"kv8_{r}"])
        written_codes[r] = _snapshot_written_codes(eng)
        reqs = [eng.submit(p, GenerationConfig(max_new_tokens=N,
                                               greedy=True))
                for p, (_, N) in zip(prompts, specs)]
        eng.drain()
        torch.cuda.synchronize()
        by_pool = kernels.launches_by_pool()
        routes[r] = {"decode_variant": eng.decode_variant,
                     "prefill_variant": eng.prefill_variant,
                     "launches_by_pool": by_pool,
                     "tokens": [q.tokens for q in reqs]}
        engines[r] = eng
        if any(by["fp"] for by in by_pool.values()):
            raise AssertionError(f"kv8 parity, {r}: fp-pool launches "
                                 f"{by_pool}")
    ref = engines["unfused"]
    res = {}
    for r in ("default", "two_stage"):
        e = engines[r]
        steps = [(a.int() - b.int()).abs()
                 for rid, pair in written_codes[r].items()
                 for a, b in zip(pair, written_codes["unfused"][rid])]
        res[r] = {
            "tokens_equal_unfused": routes[r]["tokens"]
            == routes["unfused"]["tokens"],
            "scales_equal_unfused": all(torch.equal(a, b) for a, b in
                                        zip(e._kv_scales, ref._kv_scales)),
            "codes_compared": sum(d.numel() for d in steps),
            "codes_differing": sum(int((d > 0).sum()) for d in steps),
            "largest_code_step": max(int(d.max()) for d in steps)}
    emit({"phase": "kv8_parity", "gpu": gpu, "dtype": "float32",
          "layers": L, "codes_written": written,
          "flip_bound": KV8_PARITY_FLIPS,
          **{r: {k: v for k, v in routes[r].items() if k != "tokens"}
             for r in routes}, **{f"{r}_vs_unfused": v
                                  for r, v in res.items()}})
    _check_default_route(routes["default"], "kv8 parity engine")
    if routes["two_stage"]["decode_variant"]["attn"] != "cuda_fused":
        raise AssertionError("the kv8 two-stage parity engine is not on the "
                             "decode_attn_block kernel")
    for r, v in res.items():
        if not (v["tokens_equal_unfused"] and v["scales_equal_unfused"]
                and v["codes_compared"] == written
                and v["largest_code_step"] <= 1
                and v["codes_differing"] <= KV8_PARITY_FLIPS * written):
            raise AssertionError(f"kv8 parity, {r} against unfused: {v}")


DEFAULT_ROUTE = {
    "decode_variant": {"mode": "auto", "block": "cuda_block",
                       "attn": "cuda_block", "mlp": "cuda_block"},
    "prefill_variant": {"mode": "auto", "attn": "cuda_fused",
                        "mlp": "cuda_fused"}}


def _check_default_route(variants, what):
    """The engine's default route must run the CUDA kernels for both the
    prefill chunk and the decode step (the single-launch kernel)."""
    got = {k: variants[k] for k in DEFAULT_ROUTE}
    if got != DEFAULT_ROUTE:
        raise AssertionError(f"{what} is not on the CUDA kernels: {got}")


SERVE_REQUESTS, SERVE_NEW = 12, 64


def serving_phase(gpu, params, route):
    """LLaMA-7B at full depth, bf16, 8 slots, 12 requests, on one of
    ``ALL_ROUTES``: the default (both knobs left at their default: the
    single-launch decode kernel), the two-stage decode route
    (``fused_decode="pallas"``) or the unfused one (``fused_decode=False,
    fused_prefill=False``), on fp weights; or the default and two-stage
    routes with ``weight_quant="int8"|"int4"`` (the engine quantizes the
    fp tree on the card in its constructor, timed). The launch counts
    are set to 0 just before the requests go in and read just after the
    engine drains; on a quantized route every launch of the four block
    kernels must be in the quantized class and no dequantize-then-matmul
    may run. On an int8-cache route (``cache_dtype="int8"``) every launch
    of the three kernels that read the pools must be in the int8 pool
    class, the unfused route's attention is the dequantizing composition
    (no paged-attention launch), and the pools' bytes and the calibration's
    seconds (the first admission's dense forward, CUDA-synchronised) are
    printed; on the other routes every such launch is in the fp class.
    Every prefill_attn_block launch and every chunk's decode_mlp_block
    launch runs the tensor-core body (``launches_by_body`` "tc"), every
    decode step's decode_mlp_block (the two-stage route's 8 rows, bf16)
    the weight ring ("ring"), and its decode_attn_block the body its rule
    gives the route's class (:func:`attn_route_body`: the weight ring on
    the kv8 two-stage route, the CUDA-core body over bf16 pools)."""
    import torch
    from paddle_tpu_torch.inference import GenerationConfig, ServingEngine
    from paddle_tpu_torch.models import LLAMA_7B
    from paddle_tpu_torch.ops import kernels
    cfg = LLAMA_7B
    L = cfg.num_hidden_layers
    wq = ALL_ROUTES[route].get("weight_quant")
    kv8 = ALL_ROUTES[route].get("cache_dtype") == "int8"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServingEngine(params, cfg, capacity=8, block_size=16,
                        max_seq_len=1024, prefill_buckets=(32, 128),
                        **ALL_ROUTES[route])
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    lens = rng.integers(40, 601, SERVE_REQUESTS)
    gen = GenerationConfig(max_new_tokens=SERVE_NEW, greedy=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    t0 = time.perf_counter()
    # the int8 cache's calibration (a dense forward at the first admission:
    # its RMSNorm launches, and over a quantized tree its dequantize-then-
    # matmul products, as in the JAX engine) is timed and counted apart
    calib_s, calib_dequant = [], [0]
    with counted_dequantize() as dequant_calls:
        calibrate = eng._calibrate

        def timed_calibrate(prompt):
            before = dequant_calls[0]
            torch.cuda.synchronize()
            t = time.perf_counter()
            calibrate(prompt)
            torch.cuda.synchronize()
            calib_s.append(time.perf_counter() - t)
            calib_dequant[0] += dequant_calls[0] - before
        eng._calibrate = timed_calibrate
        reqs = [eng.submit(p, gen) for p in prompts]
        eng.drain()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_dequant = dequant_calls[0] - calib_dequant[0]
    counts = kernels.launches()
    by_weight = kernels.launches_by_weight()
    by_pool = kernels.launches_by_pool()
    by_body = {k: v for k, v in kernels.launches_by_body().items()
               if k in ("decode_mlp_block", "prefill_attn_block",
                        "decode_attn_block")}
    m = eng.metrics()
    steps, chunks = m["decode_steps"], m["prefill_chunks"]
    graph = graph_stats(captured(eng, route, chunks), eng)
    emit({"phase": "serving", "route": route, "gpu": gpu,
          "model": "LLAMA_7B", "layers": L, "dtype": "bfloat16",
          "decode_traces": m["decode_traces"],
          "prefill_traces": m["prefill_traces"], **graph,
          "weight_quant": wq, "cache_dtype": "int8" if kv8 else None,
          "pool_bytes": 2 * eng._k_pools.numel()
          * eng._k_pools.element_size(),
          "calibration_s": [round(t, 4) for t in calib_s],
          "calibration_traces": m["calibration_traces"],
          "construct_s": round(construct_s, 3),
          "requests": len(reqs), "prompt_tokens": [int(n) for n in lens],
          "decode_variant": m["decode_variant"],
          "prefill_variant": m["prefill_variant"],
          "weight_quant_variant": m["weight_quant_variant"],
          "dequantize_calls": serve_dequant,
          "calibration_dequantize_calls": calib_dequant[0],
          "launches_by_weight": by_weight, "launches_by_pool": by_pool,
          "launches_by_body": by_body, "wall_s": round(wall, 3),
          "tokens_per_sec": m["tokens_per_sec"],
          "prefill_tokens_per_sec": m["prefill_tokens_per_sec"],
          "ttft_ms_mean": m["ttft_ms_mean"],
          "ttft_ms_max": m["ttft_ms_max"],
          "decode_step_ms_mean": m["decode_step_ms_mean"],
          "decode_steps": steps, "prefill_chunks": chunks,
          "slot_utilization": m["slot_utilization"],
          "roofline": m["roofline"],
          "launches": counts,
          "peak_memory_gb": round(torch.cuda.max_memory_allocated()
                                  / 2 ** 30, 3)})
    for r in reqs:
        if not (r.done and len(r.tokens) == SERVE_NEW):
            raise AssertionError(f"request {r.req_id} unfinished: "
                                 f"{len(r.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.req_id}: token out of range")
    # the prefill MLP is decode_mlp_block over the chunk's rows; the final
    # norm of every chunk and step is the RMSNorm kernel
    base = _route_base(route)
    pool_class = "int8" if kv8 else "fp"
    for op, by in by_pool.items():
        if by[pool_class] != counts[op]:
            raise AssertionError(f"{route}: {op} launched {by} (all "
                                 f"{counts[op]} must be {pool_class})")
    if kv8 != (len(calib_s) == 1 == m["calibration_traces"]):
        raise AssertionError(f"{route}: {len(calib_s)} calibrations, "
                             f"{m['calibration_traces']} counted")
    if wq:
        if serve_dequant:
            raise AssertionError(f"{route}: {serve_dequant} dequantize-"
                                 "then-matmul products ran")
        for op, by in by_weight.items():
            if by[wq] != counts[op]:
                raise AssertionError(f"{route}: {op} launched {by} (all "
                                     f"{counts[op]} must be {wq})")
        want_wq = {"mode": wq, "weight_dtype": wq,
                   **{k: m["decode_variant"][k]
                      for k in ("block", "attn", "mlp")}}
        if m["weight_quant_variant"] != want_wq:
            raise AssertionError(f"{route}: weight_quant_variant "
                                 f"{m['weight_quant_variant']}")
    if base == "default":
        want = {"prefill_attn_block": L * chunks,
                "decode_block_fused": L * steps, "decode_attn_block": 0,
                "decode_mlp_block": L * chunks,
                "paged_attention_decode": 0, "rms_norm_fwd": steps + chunks}
        _check_default_route(m, "main path")
    elif base == "two_stage":
        want = {"prefill_attn_block": L * chunks, "decode_block_fused": 0,
                "decode_attn_block": L * steps,
                "decode_mlp_block": L * (steps + chunks),
                "paged_attention_decode": 0, "rms_norm_fwd": steps + chunks}
    else:
        # over int8 pools the attention is the dequantizing composition, as
        # in the JAX package
        want = {"prefill_attn_block": 0, "decode_block_fused": 0,
                "decode_attn_block": 0, "decode_mlp_block": 0,
                "paged_attention_decode": 0 if kv8 else L * steps,
                "rms_norm_fwd": (2 * L + 1) * (steps + chunks)}
    want["rms_norm_fwd"] += (2 * L + 1) * len(calib_s)
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"{route} launches {counts} != {want} "
                             f"({steps} decode steps, {chunks} chunks, "
                             f"{len(calib_s)} calibrations)")
    # every bf16 chunk (32 or 128 rows) runs the tensor-core bodies; the
    # two-stage route's decode step (8 rows) the weight ring for the MLP
    # and its rule's body for the attention
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    chunk_mlp = L * chunks if base != "unfused" else 0
    attn_n = counts["decode_attn_block"]
    attn_ring = attn_route_body(fdb, H7, H7, 1 if kv8 else 2,
                                {"int8": 8, "int4": 4}.get(wq, 0)) == "ring"
    want_body = {"prefill_attn_block": {"tc": counts["prefill_attn_block"],
                                        "cuda_core": 0},
                 "decode_mlp_block": {"tc": chunk_mlp, "cuda_core": 0,
                                      "ring": counts["decode_mlp_block"]
                                      - chunk_mlp},
                 "decode_attn_block": {"ring": attn_n * attn_ring,
                                       "cuda_core": attn_n * (not attn_ring)}}
    if by_body != want_body:
        raise AssertionError(f"{route}: launches by body {by_body} != "
                             f"{want_body}")
    return (dict(counts, by_weight=by_weight, by_pool=by_pool,
                 by_body=by_body), eng, prompts, [r.tokens for r in reqs])


def routes_phase(gpu, params, prompts, routes):
    """The bf16 greedy ids of the three engine routes and of dense bf16
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
    for a, b in (("default", "two_stage"), ("two_stage", "unfused"),
                 ("unfused", "dense"), ("default", "dense")):
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
               "decode_block_fused", "paged_attention_decode"):
        if op in name:
            return op
    for ring, op in (("decode_block_ring_kernel", "decode_block_fused"),
                     ("decode_attn_ring_kernel", "decode_attn_block"),
                     ("decode_mlp_ring_kernel", "decode_mlp_block")):
        if ring in name:   # a ring body
            return op
    for part, op in (("res_rms_fwd", "residual_rms_norm_fwd"),
                     ("ln_fwd", "layer_norm_fwd"),
                     ("rms_fwd", "rms_norm_fwd"),
                     ("rms_bwd", "rms_norm_bwd"),
                     ("dw_sum", "rms_norm_bwd"),
                     ("swiglu_fwd", "swiglu_fwd"),
                     ("swiglu_bwd", "swiglu_bwd"),
                     ("ce_fwd", "linear_ce_fwd"),
                     # the backward: the P pass runs in dx's call on the
                     # main path; dx's product pairs two A tiles over a
                     # K-major one (<1, 0, ...>), dh's are <2, ...> and,
                     # for the tied layout, <1, 1, ...>
                     ("ce_gemm_kernel<0,", "linear_ce_bwd_dx"),
                     ("ce_f32_gemm_kernel<true>", "linear_ce_bwd_dx"),
                     ("ce_gemm_kernel<1, 0,", "linear_ce_bwd_dx"),
                     ("ce_gemm_kernel<1, 1,", "linear_ce_bwd_dh"),
                     ("ce_gemm_kernel<2,", "linear_ce_bwd_dh")):
        if part in name:
            return op
    if "ce_f32_gemm_kernel<false>" in name:
        return None     # f32 dx or dh product: see _device_groups
    if "adamw_kernel" in name:
        return "fused_adamw"
    if "flash" in name:
        for part, op in (("fwd_kernel", "flash_attention_fwd"),
                         ("fwd_tc_kernel", "flash_attention_fwd"),
                         ("dkv_kernel", "flash_attention_bwd_dkv"),
                         ("dkv_tc_kernel", "flash_attention_bwd_dkv"),
                         ("dq_kernel", "flash_attention_bwd_dq"),
                         ("dq_tc_kernel", "flash_attention_bwd_dq")):
            if part in name:
                return op
    if any(s in name.lower() for s in ("gemm", "gemv", "cutlass", "xmma",
                                       "nvjet", "cublas", "splitk")):
        return "matmul"
    return "other"


def _device_groups(prof, per):
    """Device activities (kernels, copies) of a torch.profiler run, per
    ``per`` steps or chunks: ({name: (ms, count)}, {group: [ms, count]}).
    Every device kernel a wrapper call launches counts in its op's group:
    a kernel whose name does not tell the op (linear_ce's f32 product,
    shared by dx and dh) joins the group of the activity before it, which
    is a kernel of the same call."""
    import torch
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    kernels, groups, prev = {}, {}, "other"
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3 / per
        k_ms, k_n = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (k_ms + ms, k_n + 1 / per)
        prev = _kernel_group(e.name) or prev
        g = groups.setdefault(prev, [0.0, 0.0])
        g[0] += ms
        g[1] += 1 / per
    return kernels, groups


def _rounded(groups):
    return {k: {"ms": round(v[0], 3), "launches": round(v[1], 2)}
            for k, v in sorted(groups.items())}


def next_bucket(eng):
    """The bucket of the prefill chunk the engine's next step runs, or
    None (its ``_run_prefill``'s choice: the first slot in prefill)."""
    for s in eng._slots:
        if s.phase == "prefill":
            return eng._bucket_for(min(s.req.prompt.size - s.prefill_pos,
                                       eng.buckets[-1]))
    return None


def _timed_chunks(eng):
    """Wrap the engine's prefill step so that each chunk records CUDA
    events around it (staging and the chunk's program: a replay, or the
    eager body): returns the list of (bucket, start, end) that fills as
    chunks run, and a switch to pause recording."""
    import torch
    record = {"on": True, "events": []}
    run = eng._run_prefill

    def timed():
        P = next_bucket(eng)
        if not record["on"] or P is None:
            return run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run()
        end.record()
        record["events"].append((P, start, end))
        return out
    eng._run_prefill = timed
    return record


def chunk_ms(record):
    """Chunk ms by bucket from :func:`_timed_chunks`'s events (after a
    sync): count, mean, median, max, and the mean and median of the
    chunks after each bucket's first two (on CUDA those two are the
    warm-up and the capture)."""
    by_bucket = {}
    for P, start, end in record["events"]:
        by_bucket.setdefault(P, []).append(start.elapsed_time(end))
    return {str(P): {"chunks": len(v), "ms_mean": float(np.mean(v)),
                     "ms_median": float(np.median(v)),
                     "ms_max": float(np.max(v)), "first_ms": v[:2],
                     "steady_ms_mean": (float(np.mean(v[2:])) if v[2:]
                                        else None),
                     "steady_ms_median": (float(np.median(v[2:])) if v[2:]
                                          else None)}
            for P, v in sorted(by_bucket.items())}


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
    from paddle_tpu_torch.analysis.kernel_rules import (HBM_BYTES_PER_S,
                                                        modeled_launch_bytes)
    from paddle_tpu_torch.inference import GenerationConfig
    from paddle_tpu_torch.ops.kernels._launch import capture_kernel_launches
    rng = np.random.default_rng(2)
    chunks = -(-prompt // eng.buckets[-1])
    gen = GenerationConfig(
        max_new_tokens=2 * steps + chunks * eng.capacity + 4, greedy=True)
    for _ in range(eng.capacity):
        eng.submit(rng.integers(0, eng.cfg.vocab_size, prompt)
                   .astype(np.int32), gen)
    record = _timed_chunks(eng)
    record["on"] = False
    traced = 2            # chunks at pos0 0 and P of the first request
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            capture_kernel_launches() as chunk_specs:
        for _ in range(traced):
            eng.step()
        torch.cuda.synchronize()
    _, chunk_groups = _device_groups(prof, traced)
    record["on"] = True
    while any(s.phase != "decode" for s in eng._slots):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    record["on"] = False
    prefill = {"chunks_traced": traced,
               "per_chunk_by_group": _rounded(chunk_groups),
               "device_ms_per_chunk": round(sum(
                   v[0] for v in chunk_groups.values()), 3),
               "chunk_ms_by_bucket": chunk_ms(record)}
    ms, n = chunk_groups.get("prefill_attn_block", [0.0, 0.0])
    if n:
        # the catalog's byte model of each traced launch (a shard's under
        # a mesh), at its own history length
        nbytes = float(np.mean([
            modeled_launch_bytes(sp)["total_bytes"] for sp in chunk_specs
            if sp.name == "prefill_attn_block"]))
        prefill["prefill_attn_block_per_launch"] = {
            "bytes": nbytes, "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
            "us": ms / n * 1e3}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    # tokens already in the pool for each slot at each profiled step, and
    # the plans of the step's launches
    lens, step_specs = [], []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            lens.append([s.seq_len for s in eng._slots
                         if s.phase == "decode"])
            with capture_kernel_launches() as specs:
                eng.step()
            step_specs.append(specs)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels, groups = _device_groups(prof, steps)
    device_ms = sum(ms for ms, _ in kernels.values())
    # every decode step of the windows is a replay of the one graph, and
    # every chunk after a bucket's first a replay of its graph
    graph = graph_stats(captured(eng, route,
                                 eng.counters["prefill_chunks"]), eng)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    per_launch = {}
    launch_bytes = {}
    for ls, specs in zip(lens, step_specs):
        for sp in specs:
            rows = next((op.shape[0] for op in sp.inputs
                         if op.paged == "pages"), len(ls))
            # the pools' live tokens of each row: the cached ones (paged
            # attention also reads the new one, written first); idle
            # slots 0
            live = [n + (sp.name == "paged_attention_decode") for n in ls]
            live += [0] * (rows - len(live))
            launch_bytes.setdefault(sp.name, []).append(
                modeled_launch_bytes(sp, live)["total_bytes"])
    for op, sizes in launch_bytes.items():
        ms, n = groups.get(op, [0.0, 0.0])
        if not n:
            continue
        nbytes = float(np.mean(sizes))
        us = ms / n * 1e3
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        per_launch[op] = {"bytes": nbytes, "bound_us": bound_us, "us": us,
                          "x_bound": us / bound_us}
    emit({"phase": "profile", "route": route, "gpu": gpu,
          "prefill": prefill, "decode": "graph replays", **graph,
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


# ---------------------------------------------------------------------------
# tensor-parallel serving: the residual=False bodies of decode_attn_block,
# decode_mlp_block and prefill_attn_block (the "psum" placement's partial
# products) at one shard's shapes, and ServingEngine(mesh=...) with its
# shards colocated on the one card
# ---------------------------------------------------------------------------
TP_REPLACES = {
    "decode_attn_block": "paddle_tpu/ops/pallas/fused_decode_block.py:436",
    "decode_mlp_block": "paddle_tpu/ops/pallas/fused_decode_block.py:645",
    "prefill_attn_block": "paddle_tpu/ops/pallas/fused_prefill_block.py:431"}
# (tp, int8 pools, weight bits, dtype): H = KV = 32 / tp query heads of a
# shard against the full D; tp 1 is the tp=1 mesh's shard (full width)
TP_ATTN_CASES = ((1, False, 0, "bfloat16"), (2, False, 0, "bfloat16"),
                 (4, False, 0, "bfloat16"), (2, True, 0, "bfloat16"),
                 (4, True, 0, "bfloat16"), (1, False, 8, "bfloat16"),
                 (2, True, 8, "bfloat16"), (2, False, 0, "float32"),
                 (4, True, 0, "float32"))
# (tp, dtype): F = 11008 / tp columns of a shard (2752: no tile divides)
TP_MLP_CASES = ((1, "bfloat16"), (2, "bfloat16"), (4, "bfloat16"),
                (2, "float32"), (4, "float32"))
# (tp, int8 pools, dtype, P, (pos0, n_valid) spans); the first span of a
# bf16 case is timed
TP_PREFILL_CASES = ((2, False, "bfloat16", 128, ((512, 128), (5, 125),
                                                 (600, 77))),
                    (2, True, "bfloat16", 128, ((512, 128), (600, 77))),
                    (4, False, "float32", 32, ((5, 29), (16, 32))))


def _tp_row(name, op, tp, kv8, wd, shape, max_err, timing):
    """A kernels-line row of a residual=False body."""
    return {"name": name, "route": "cuda",
            "source": PREFILL_SOURCE if op == "prefill_attn_block"
            else FUSED_SOURCE,
            "replaces": TP_REPLACES[op], "residual": False, "tp": tp,
            "weights": wd or "bfloat16",
            "pools": "int8" if kv8 else "bfloat16",
            "shape": shape, "dtype": "bfloat16", "max_abs_err": max_err,
            **timing, "library_ms": None,
            "library": "none: no single PyTorch call computes the block",
            "ok": True}


def _tp_name(op, tp, kv8=False, wd=None):
    return (f"{op}[partial,tp{tp}" + (",kv8" if kv8 else "")
            + (f",{wd}" if wd else "") + "]")


def _adds_up(full, part, x, n=None):
    """The residual body's x_out is x plus the residual=False body's
    output, rounded once: x_out = T(f32(x) + f32(o)), bit for bit (both
    bodies round o to T the same way). ``n``: the real rows."""
    import torch
    n = full.shape[0] if n is None else n
    return bool(torch.equal(full[:n],
                            (x.float() + part.float()).to(x.dtype)[:n]))


def tp_attn_phase(gpu):
    """decode_attn_block's residual=False body against its plain version
    (``attn_block_ref`` for fp weights and pools, ``attn_block_wq_ref``
    with int8 pools or weights) at one shard's shapes (TP_ATTN_CASES:
    H = KV = 32, 16, 8 heads against D 4096, B 8, the fp phases'
    lengths), at the fp and kv8 phases' tolerances; two launches bit for
    bit; the residual body on the same inputs equal to x plus this one's
    output, and its k_new/v_new equal; dispatch on the per-shard meta
    (tp in it) picks the kernel; each case records its body (over int8
    pools the weight ring but for bf16 weights at tp=4, held against the
    plain version as every case is). Each bf16 case is timed beside its bound at the
    shard's shapes, its plain version, the residual body and, on the ring,
    the CUDA-core body on the same inputs (:func:`body_row`)."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    from paddle_tpu_torch.ops.rope import build_rope_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(100)
    rope = build_rope_cache(4096, HD7, device="cuda")
    rows, cases = [], []
    for tp, kv8, bits, dtn in TP_ATTN_CASES:
        dt, H, wd = getattr(torch, dtn), H7 // tp, WQ_BITS.get(bits)
        name = _tp_name("decode_attn_block", tp, kv8, wd)
        base = fused_attn_inputs(gen, dt, H, rope, H=H)
        if bits:
            base = (*base[:2], *wq_leaves(base[2:6], bits), *base[6:])
        kw = {}
        plain = fdb.attn_block_wq_ref if kv8 or bits else fdb.attn_block_ref
        if kv8:
            kq, vq, kw["kv_scales"], _, _ = kv8_pools(base[8], base[9])
            base = (*base[:8], kq, vq, *base[10:])
        meta = fdb.decode_meta_dims(B8, D7, H, H, HD7, F7 // tp, BS16, MB72,
                                    dt, base[8].dtype, kv8, tp=tp,
                                    weight_dtype=wd)
        picked = KERNELS.dispatch("decode_attn_block", meta)[0]
        got = fdb.decode_attn_block_cuda(*base, **kw, residual=False)
        again = fdb.decode_attn_block_cuda(*base, **kw, residual=False)
        full = fdb.decode_attn_block_cuda(*base, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        adds = (_adds_up(full[0], got[0], base[0])
                and torch.equal(full[1], got[1])
                and torch.equal(full[2], got[2]))
        want = plain(*base, **kw, residual=False)  # writes the new token
        torch.cuda.synchronize()
        flips = None
        if kv8:
            outs, flip_rows, flip_codes = _kv8_decode_outputs(
                got, want, dt, kw["kv_scales"])
            flips = {"rows": flip_rows, "codes": flip_codes}
        else:
            outs = {nm: _check_case(nm, g, w, dt, tol)
                    for nm, g, w, tol in (("x_out", got[0], want[0], 1e-4),
                                          ("k_new", got[1], want[1], 1e-5),
                                          ("v_new", got[2], want[2], 1e-5))}
        case = {"kernel": name, "dtype": dtn, "H": H, "KV": H,
                "outputs": outs, "code_flips": flips,
                "bitwise_repeatable": same, "equals_residual_body": adds,
                "dispatch": picked, "body": launch_plan(
                    lambda: fdb.decode_attn_block_cuda(
                        *base, **kw, residual=False))["body"],
                "ok": same and adds and picked == "cuda_fused"
                and all(o["ok"] for o in outs.values())}
        cases.append(case)
        if not case["ok"]:
            emit({"phase": "kernel", "kernel": "decode_attn_block[partial]",
                  "gpu": gpu, "cases": cases})
            raise AssertionError(f"{name} disagrees: {case}")
        if dtn != "bfloat16":
            continue
        lens = base[11].tolist()
        b_ms, b_by = bound(lambda: fdb.decode_attn_block_cuda(
            *base, **kw, residual=False), lens)[:2]
        rows.append(_tp_row(
            name, "decode_attn_block", tp, kv8, wd,
            {"B": B8, "D": D7, "H": H, "KV": H, "hd": HD7, "BS": BS16,
             "MB": MB72, "seq_lens": lens},
            max(o["max_abs_err"] for o in outs.values()),
            {"ms": cold_ms(lambda: fdb.decode_attn_block_cuda(
                *base, **kw, residual=False)),
             "plain_ms": cold_ms(lambda: plain(*base, **kw, residual=False)),
             "bound_ms": b_ms, "bound_by": b_by,
             "full_residual_ms": cold_ms(
                 lambda: fdb.decode_attn_block_cuda(*base, **kw)),
             **body_row(fdb, lambda: fdb.decode_attn_block_cuda(
                 *base, **kw, residual=False))}))
    emit({"phase": "kernel", "kernel": "decode_attn_block[partial]",
          "gpu": gpu, "cases": cases,
          "timed": {r["name"]: {k: r[k] for k in (
              "ms", "plain_ms", "bound_ms", "full_residual_ms", "body",
              "body_rule", "cuda_core_ms") if k in r} for r in rows}})
    return rows


def tp_mlp_phase(gpu):
    """decode_mlp_block's residual=False body against ``mlp_block_ref``
    (residual=False) at one shard's columns (TP_MLP_CASES: F = 11008,
    5504, 2752 against D 4096, 8 rows; no tile width divides 2752) at the
    fp phase's tolerances; two launches bit for bit; the residual body
    equal to x plus this one's output; dispatch on the per-shard meta;
    each case records its body (bf16: the weight ring). The bf16 cases
    timed beside their bound, plain version, residual body and CUDA-core
    body on the same inputs."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(101)
    rows, cases = [], []
    for tp, dtn in TP_MLP_CASES:
        dt, F = getattr(torch, dtn), F7 // tp
        name = _tp_name("decode_mlp_block", tp)

        def rn(*shape, std=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda")
                    * std).to(dt)
        args = (rn(B8, D7), (1 + 0.1 * torch.randn(
            D7, generator=gen, device="cuda")).to(dt),
            rn(D7, F, std=0.02), rn(D7, F, std=0.02), rn(F, D7, std=0.02))
        meta = fdb.decode_meta_dims(B8, D7, H7 // tp, H7 // tp, HD7, F, BS16,
                                    MB72, dt, dt, False, tp=tp)
        picked = KERNELS.dispatch("decode_mlp_block", meta)[0]
        got = fdb.decode_mlp_block_cuda(*args, residual=False)
        again = fdb.decode_mlp_block_cuda(*args, residual=False)
        full = fdb.decode_mlp_block_cuda(*args)
        want = fdb.mlp_block_ref(*args, residual=False)
        torch.cuda.synchronize()
        same, adds = torch.equal(got, again), _adds_up(full, got, args[0])
        out = _check_case("x_out", got, want, dt, 1e-4)
        case = {"kernel": name, "dtype": dtn, "F": F, "output": out,
                "bitwise_repeatable": same, "equals_residual_body": adds,
                "dispatch": picked, "body": launch_plan(
                    lambda: fdb.decode_mlp_block_cuda(
                        *args, residual=False))["body"],
                "ok": out["ok"] and same and adds and picked == "cuda_fused"}
        cases.append(case)
        if not case["ok"]:
            emit({"phase": "kernel", "kernel": "decode_mlp_block[partial]",
                  "gpu": gpu, "cases": cases})
            raise AssertionError(f"{name} disagrees: {case}")
        if dtn != "bfloat16":
            continue
        b_ms, b_by = bound(lambda: fdb.decode_mlp_block_cuda(
            *args, residual=False))[:2]
        rows.append(_tp_row(
            name, "decode_mlp_block", tp, False, None,
            {"B": B8, "D": D7, "F": F}, out["max_abs_err"],
            {"ms": cold_ms(lambda: fdb.decode_mlp_block_cuda(
                *args, residual=False)),
             "plain_ms": cold_ms(lambda: fdb.mlp_block_ref(
                 *args, residual=False)),
             "bound_ms": b_ms, "bound_by": b_by,
             "full_residual_ms": cold_ms(
                 lambda: fdb.decode_mlp_block_cuda(*args)),
             "body": case["body"],
             "cuda_core_ms": core_ms(fdb, lambda: fdb.decode_mlp_block_cuda(
                 *args, residual=False))}))
    emit({"phase": "kernel", "kernel": "decode_mlp_block[partial]",
          "gpu": gpu, "cases": cases,
          "timed": {r["name"]: {k: r[k] for k in (
              "ms", "plain_ms", "bound_ms", "full_residual_ms", "body",
              "cuda_core_ms")} for r in rows}})
    return rows


def tp_prefill_phase(gpu):
    """prefill_attn_block's residual=False body (no runtime route of the
    JAX package launches it: its tp=1 mesh runs the residual body, tp > 1
    the verbatim chunk) against ``prefill_attn_block_ref`` (fp pools) or
    ``prefill_attn_block_wq_ref`` (int8 pools), residual=False, at one
    shard's heads (TP_PREFILL_CASES: H = KV = 16 and 8, P 128 and 32, a
    permuted table, history up to 600 tokens): the real rows at the fp
    phase's tolerances, every row finite, two launches bit for bit, the
    residual body's real rows equal to x plus this one's, dispatch on the
    per-shard meta. Timed at P=128, pos0 512, bf16 beside its bound, its
    plain version and the residual body."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    from paddle_tpu_torch.ops.rope import build_rope_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(102)
    D, hd, BS, MB = D7, HD7, BS16, MB72
    sin, cos = build_rope_cache(MB * BS, hd, device="cuda")
    rows, cases = [], []
    for tp, kv8, dtn, P, spans in TP_PREFILL_CASES:
        dt, H = getattr(torch, dtn), H7 // tp
        name = _tp_name("prefill_attn_block", tp, kv8)

        def rn(*shape, std=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda")
                    * std).to(dt)
        table = (torch.randperm(MB, generator=gen, device="cuda") + 1
                 ).to(torch.int32)
        weights = ((1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
                    ).to(dt), rn(D, H * hd, std=0.02),
                   rn(D, H * hd, std=0.02), rn(D, H * hd, std=0.02),
                   rn(H * hd, D, std=0.02))
        kp, vp = rn(MB + 1, BS, H, hd), rn(MB + 1, BS, H, hd)
        kw, plain, fp_pools = {}, fpb.prefill_attn_block_ref, None
        if kv8:
            kp, vp, kw["kv_scales"], kd, vd = kv8_pools(kp, vp)
            plain = fpb.prefill_attn_block_wq_ref
            fp_pools = (kd, vd)
        meta = fpb.prefill_meta_dims(P, D, H, H, hd, F7 // tp, BS, MB, dt,
                                     kp.dtype, kv8)
        picked = KERNELS.dispatch("prefill_attn_block", meta)[0]
        max_err, timed = 0.0, None
        for pos0, n in spans:
            args = (rn(P, D), *weights, sin[pos0:pos0 + P],
                    cos[pos0:pos0 + P], kp, vp, table, pos0, n)
            got = fpb.prefill_attn_block_cuda(*args, **kw, residual=False)
            again = fpb.prefill_attn_block_cuda(*args, **kw, residual=False)
            full = fpb.prefill_attn_block_cuda(*args, **kw)
            want = plain(*args, **kw, residual=False)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            adds = (_adds_up(full[0], got[0], args[0], n)
                    and all(torch.equal(a[:n], b[:n])
                            for a, b in zip(full[1:], got[1:])))
            outs = {}
            for nm, g, w, tol in (("x_out", got[0], want[0], 1e-4),
                                  ("k_new", got[1], want[1], 1e-5),
                                  ("v_new", got[2], want[2], 1e-5)):
                outs[nm] = _check_case(nm, g[:n], w[:n], dt, tol)
                max_err = max(max_err, outs[nm]["max_abs_err"])
            finite = bool(torch.isfinite(got[0]).all())
            case = {"kernel": name, "dtype": dtn, "H": H, "KV": H, "P": P,
                    "pos0": pos0, "n_valid": n, "outputs": outs,
                    "pad_rows_finite": finite, "bitwise_repeatable": same,
                    "equals_residual_body": adds, "dispatch": picked,
                    "body": launch_plan(
                        lambda a=args: fpb.prefill_attn_block_cuda(
                            *a, **kw, residual=False))["body"],
                    "ok": same and adds and finite
                    and picked == "cuda_fused"
                    and all(o["ok"] for o in outs.values())}
            cases.append(case)
            if not case["ok"]:
                emit({"phase": "kernel", "kernel":
                      "prefill_attn_block[partial]", "gpu": gpu,
                      "cases": cases})
                raise AssertionError(f"{name} disagrees: {case}")
            if timed is None:
                timed = args
        if dtn != "bfloat16":
            continue
        x, pos0, n = timed[0], timed[11], timed[12]
        b_ms, b_by = bound(lambda: fpb.prefill_attn_block_cuda(
            *timed, **kw, residual=False))[:2]
        extra = {}
        if fp_pools is not None:   # the fp-pool body, same activations
            fp_timed = (*timed[:8], *fp_pools, *timed[10:])
            extra["fp_pool_kernel_ms"] = cold_ms(
                lambda: fpb.prefill_attn_block_cuda(*fp_timed,
                                                    residual=False))
        rows.append(_tp_row(
            name, "prefill_attn_block", tp, kv8, None,
            {"P": P, "n_valid": n, "pos0": pos0, "D": D, "H": H, "KV": H,
             "hd": hd, "BS": BS, "MB": MB}, max_err,
            {"ms": cold_ms(lambda: fpb.prefill_attn_block_cuda(
                *timed, **kw, residual=False)),
             "plain_ms": cold_ms(lambda: plain(*timed, **kw,
                                               residual=False)),
             "bound_ms": b_ms, "bound_by": b_by,
             "full_residual_ms": cold_ms(
                 lambda: fpb.prefill_attn_block_cuda(*timed, **kw)),
             "body": launch_plan(lambda: fpb.prefill_attn_block_cuda(
                 *timed, **kw, residual=False))["body"], **extra}))
    emit({"phase": "kernel", "kernel": "prefill_attn_block[partial]",
          "gpu": gpu, "cases": cases,
          "timed": {r["name"]: {k: r[k] for k in (
              "ms", "plain_ms", "bound_ms", "full_residual_ms", "body",
              "fp_pool_kernel_ms") if k in r}
              for r in rows}})
    return rows


def tp_kernel_phases(gpu):
    """The three residual=False bodies at one shard's shapes."""
    return tp_attn_phase(gpu) + tp_mlp_phase(gpu) + tp_prefill_phase(gpu)


# the tensor-parallel serving routes: (tp, placement, cache_dtype), the
# shards colocated on cuda:0, both knobs at their default
TP_ROUTES = {"tp1_psum": (1, "psum", None), "tp2_psum": (2, "psum", None),
             "tp2_gather": (2, "gather", None),
             "tp2_psum_kv8": (2, "psum", "int8")}


def tp_serving_phase(gpu, params, route):
    """LLaMA-7B at full depth and width, bf16, the serving phase's 12
    requests, on ``ServingEngine(mesh=ServingMesh.make(tp, collective=...,
    devices=["cuda:0"] * tp))``: two shards on one card share its memory
    rate, so the numbers measure the per-shard kernels, the psum and the
    doubled launches, not tensor-parallel scaling. The launch counts are
    set to 0 just before the requests go in and read just after the
    engine drains. On the psum routes decode_attn_block and
    decode_mlp_block launch tp x L times a decode step, every decode
    launch in the "partial" residual class, decode_block_fused never; the
    tp=1 mesh runs the fused chunk (prefill_attn_block and the prefill
    MLP in the "full" class once per layer per chunk), tp=2 the verbatim
    chunk (RMSNorm 2L+1 a chunk); every decode launch of decode_mlp_block
    runs the weight ring (``launches_by_body`` "ring") and of
    decode_attn_block the body its rule gives the shard's class
    (:func:`attn_route_body`: the weight ring over int8 pools, the
    CUDA-core body over bf16 pools), the chunks' MLP the tensor-core
    body. The gather route runs the composition:
    paged attention tp x L times a step, RMSNorm 2L+1 a step and a chunk,
    no block kernel. Over int8 pools every pool read is in the int8 class
    and the calibration (the placement's dense forward) adds 2L+1
    RMSNorm launches."""
    import torch
    from paddle_tpu_torch.inference import (GenerationConfig, ServingEngine,
                                            ServingMesh)
    from paddle_tpu_torch.models import LLAMA_7B
    from paddle_tpu_torch.ops import kernels
    cfg = LLAMA_7B
    L = cfg.num_hidden_layers
    tp, coll, cache = TP_ROUTES[route]
    mesh = ServingMesh.make(tp, collective=coll, devices=["cuda:0"] * tp)
    # earlier phases' engines may sit in reference cycles (their timing
    # wrappers): free them, so the peak is this engine's
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(params, cfg, capacity=8, block_size=16,
                        max_seq_len=1024, prefill_buckets=(32, 128),
                        mesh=mesh, cache_dtype=cache)
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    lens = rng.integers(40, 601, SERVE_REQUESTS)
    gen = GenerationConfig(max_new_tokens=SERVE_NEW, greedy=True)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    kernels.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, gen) for p in prompts]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    by_res = kernels.launches_by_residual()
    by_pool = kernels.launches_by_pool()
    by_body = {k: v for k, v in kernels.launches_by_body().items()
               if k in ("decode_attn_block", "decode_mlp_block")}
    m = eng.metrics()
    steps, chunks = m["decode_steps"], m["prefill_chunks"]
    calib = m["calibration_traces"]
    graph = graph_stats(captured(eng, route, chunks), eng)
    emit({"phase": "serving", "route": route, "gpu": gpu,
          "model": "LLAMA_7B", "layers": L, "dtype": "bfloat16",
          "decode_traces": m["decode_traces"], **graph,
          "mesh": m["mesh"], "devices": [str(d) for d in mesh.devices],
          "cache_dtype": cache, "construct_s": round(construct_s, 3),
          "pool_bytes": sum(2 * p.numel() * p.element_size()
                            for p in eng._k_pools),
          "requests": len(reqs), "prompt_tokens": [int(n) for n in lens],
          "decode_variant": m["decode_variant"],
          "prefill_variant": m["prefill_variant"],
          "launches_by_residual": by_res, "launches_by_pool": by_pool,
          "launches_by_body": by_body,
          "wall_s": round(wall, 3), "tokens_per_sec": m["tokens_per_sec"],
          "prefill_tokens_per_sec": m["prefill_tokens_per_sec"],
          "ttft_ms_mean": m["ttft_ms_mean"], "ttft_ms_max": m["ttft_ms_max"],
          "decode_step_ms_mean": m["decode_step_ms_mean"],
          "decode_steps": steps, "prefill_chunks": chunks,
          "calibration_traces": calib, "roofline": m["roofline"],
          "launches": counts,
          "peak_memory_gb": round(torch.cuda.max_memory_allocated()
                                  / 2 ** 30, 3)})
    for r in reqs:
        if not (r.done and len(r.tokens) == SERVE_NEW
                and all(0 <= t < cfg.vocab_size for t in r.tokens)):
            raise AssertionError(f"{route}: request {r.req_id} unfinished "
                                 f"or out of range: {r.tokens}")
    if m["mesh"] != {"axis": "tp", "tp": tp, "collective": coll}:
        raise AssertionError(f"{route}: mesh {m['mesh']}")
    if (calib == 1) != (cache == "int8"):
        raise AssertionError(f"{route}: {calib} calibrations")
    norms = (2 * L + 1) * calib
    pool_class = "int8" if cache else "fp"
    for op, by in by_pool.items():
        if by[pool_class] != counts[op]:
            raise AssertionError(f"{route}: {op} launched {by} (all "
                                 f"{counts[op]} must be {pool_class})")
    if coll == "psum":
        fused = tp == 1
        want = {"decode_attn_block": tp * L * steps,
                "decode_mlp_block": tp * L * steps
                + (L * chunks if fused else 0),
                "decode_block_fused": 0, "paged_attention_decode": 0,
                "prefill_attn_block": L * chunks if fused else 0,
                "rms_norm_fwd": steps + norms
                + (chunks if fused else (2 * L + 1) * chunks)}
        want_res = {"decode_attn_block": {"full": 0,
                                          "partial": tp * L * steps},
                    "decode_mlp_block": {"full": L * chunks if fused else 0,
                                         "partial": tp * L * steps},
                    "prefill_attn_block": {"full": L * chunks if fused
                                           else 0, "partial": 0}}
        if by_res != want_res:
            raise AssertionError(f"{route}: launches by residual {by_res} "
                                 f"!= {want_res}")
        from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
        n = tp * L * steps
        ring = attn_route_body(fdb, H7 // tp, H7 // tp,
                               1 if cache == "int8" else 2, 0) == "ring"
        want_body = {"decode_attn_block": {"ring": n * ring,
                                           "cuda_core": n * (not ring)},
                     "decode_mlp_block": {"ring": tp * L * steps,
                                          "tc": L * chunks if fused else 0,
                                          "cuda_core": 0}}
        if by_body != want_body:
            raise AssertionError(f"{route}: launches by body {by_body} != "
                                 f"{want_body}")
        want_var = {"mode": "auto", "block": "composed",
                    "attn": "cuda_fused", "mlp": "cuda_fused"}
    else:
        want = {"decode_attn_block": 0, "decode_mlp_block": 0,
                "decode_block_fused": 0, "prefill_attn_block": 0,
                "paged_attention_decode": tp * L * steps,
                "rms_norm_fwd": (2 * L + 1) * (steps + chunks) + norms}
        want_var = {"mode": "auto", "block": "composed", "attn": "unfused",
                    "mlp": "unfused"}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"{route} launches {counts} != {want} "
                             f"({steps} decode steps, {chunks} chunks)")
    if m["decode_variant"] != want_var:
        raise AssertionError(f"{route}: decode_variant "
                             f"{m['decode_variant']}")
    want_pre = ("cuda_fused" if coll == "psum" and tp == 1 else "unfused")
    if m["prefill_variant"]["attn"] != want_pre:
        raise AssertionError(f"{route}: prefill_variant "
                             f"{m['prefill_variant']}")
    return dict(counts, by_residual=by_res, by_body=by_body), eng


@contextlib.contextmanager
def recorded_logits():
    """Every logits tensor the serving engine samples from, copied, in
    order, while the block runs: a prefill chunk's as it samples, a
    decode step's from the step's logits buffer after the step (its body
    runs captured, so no Python sees its logits at replay)."""
    from paddle_tpu_torch.inference import serving
    cls = serving.ServingEngine
    sample, body, run = (serving._sample_slots, cls._decode_body,
                         cls._run_decode)
    seen, in_body = [], [False]

    def record(logits, *a):
        if not in_body[0]:
            seen.append(logits.detach().clone())
        return sample(logits, *a)

    def decode_body(self):
        in_body[0] = True
        try:
            return body(self)
        finally:
            in_body[0] = False

    def run_decode(self):
        did = run(self)
        if did:
            seen.append(self._d_logits.clone())
        return did
    serving._sample_slots = record
    cls._decode_body, cls._run_decode = decode_body, run_decode
    try:
        yield seen
    finally:
        serving._sample_slots = sample
        cls._decode_body, cls._run_decode = body, run


def tp_parity_phase(gpu):
    """Tensor-parallel parity, f32 at LLaMA-7B widths with 2 layers, the
    parity phase's 5 requests through 2 slots, shards colocated on the
    card. Greedy ids must be equal between: the tp=1 "psum" mesh and the
    meshless two-stage route (``fused_decode="pallas"``: the same kernels
    with the residual in the kernel; the same fused chunk), whose logits
    must also be equal bit for bit (in f32 ``x + T(o)`` is the kernel's
    own residual add); the tp=1 "gather" mesh and the meshless unfused
    route, logits bit-equal too; tp=2 "gather" and the meshless unfused
    route. tp=2 "psum" against the meshless two-stage route may part on a
    near tie only (top-2 logit gap < 1e-4, as in the parity phase). The
    largest |logit| difference of each pair is printed."""
    import dataclasses
    import torch
    from paddle_tpu_torch.inference import (GenerationConfig,
                                            ServingEngine, ServingMesh)
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

    def mk(tp, coll):
        return ServingMesh.make(tp, collective=coll,
                                devices=["cuda:0"] * tp)
    engines = {"meshless_two_stage": {"fused_decode": "pallas"},
               "meshless_unfused": {"fused_decode": False,
                                    "fused_prefill": False},
               "tp1_psum": {"mesh": mk(1, "psum")},
               "tp1_gather": {"mesh": mk(1, "gather")},
               "tp2_psum": {"mesh": mk(2, "psum")},
               "tp2_gather": {"mesh": mk(2, "gather")}}
    runs = {}
    for name, knobs in engines.items():
        eng = ServingEngine(params, cfg, capacity=2, block_size=16,
                            max_seq_len=512, prefill_buckets=(32, 128),
                            **knobs)
        with recorded_logits() as logits:
            reqs = [eng.submit(p, GenerationConfig(max_new_tokens=N,
                                                   greedy=True))
                    for p, (_, N) in zip(prompts, specs)]
            eng.drain()
            torch.cuda.synchronize()
        runs[name] = {"tokens": [r.tokens for r in reqs], "logits": logits,
                      "decode_variant": eng.decode_variant,
                      "prefill_variant": eng.prefill_variant}
        del eng

    def gap_at(prompt, prefix):
        ids = torch.tensor([[int(t) for t in prompt] + list(prefix)],
                           device="cuda")
        kc, vc = init_cache(cfg, 1, ids.shape[1])
        out, _, _ = cached_forward(params, ids, cfg, kc, vc, 0)
        top2 = torch.topk(out[0, -1].float(), 2).values
        return float(top2[0] - top2[1])

    pairs = {}
    for a, b in (("tp1_psum", "meshless_two_stage"),
                 ("tp1_gather", "meshless_unfused"),
                 ("tp2_gather", "meshless_unfused"),
                 ("tp2_psum", "meshless_two_stage")):
        ta, tb = runs[a]["tokens"], runs[b]["tokens"]
        parted = []
        for p, x, y in zip(prompts, ta, tb):
            if x != y:
                j = next(i for i, (u, v) in enumerate(zip(x, y)) if u != v)
                parted.append({"step": j, "top2_gap": gap_at(p, x[:j])})
        la, lb = runs[a]["logits"], runs[b]["logits"]
        aligned = len(la) == len(lb) and not parted
        pairs[f"{a}_vs_{b}"] = {
            "ids_equal": ta == tb, "parted": parted,
            "logits_bit_equal": aligned and all(
                torch.equal(u, v) for u, v in zip(la, lb)),
            "max_abs_logit_diff": max(float((u - v).abs().max())
                                      for u, v in zip(la, lb))
            if aligned else None}
    emit({"phase": "tp_parity", "gpu": gpu, "dtype": "float32", "layers": 2,
          "variants": {k: {"decode": v["decode_variant"],
                           "prefill": v["prefill_variant"]}
                       for k, v in runs.items()}, **pairs})
    # only the tp=2 psum route sums its o_proj/down partials in another
    # order than one device does: a near tie may part its ids there. The
    # gather placement keeps the single-device op sequence, so its ids
    # are equal, and at tp=1 its logits too, as are tp=1 psum's
    for pair, res in pairs.items():
        if pair.startswith("tp2_psum"):
            if any(p["top2_gap"] >= 1e-4 for p in res["parted"]):
                raise AssertionError(f"{pair}: ids part off a near tie: "
                                     f"{res}")
        elif not res["ids_equal"]:
            raise AssertionError(f"{pair}: ids differ: {res}")
    for pair in ("tp1_psum_vs_meshless_two_stage",
                 "tp1_gather_vs_meshless_unfused"):
        if not pairs[pair]["logits_bit_equal"]:
            raise AssertionError(f"{pair}: logits differ: {pairs[pair]}")
    for name in ("tp1_psum", "tp2_psum"):
        if runs[name]["decode_variant"]["attn"] != "cuda_fused":
            raise AssertionError(f"{name} is not on the kernels: "
                                 f"{runs[name]['decode_variant']}")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the captured decode step: every serving route's decode step replayed as
# one CUDA graph, held against a twin engine whose every step runs the
# uncaptured body
# ---------------------------------------------------------------------------
class EagerStep:
    """A twin's program: its body, run eagerly at every call (nothing
    captured); ``calls`` counts them."""

    def __init__(self, prog):
        self.body = prog.body
        self.calls = 0

    def prepare(self):
        pass

    def __call__(self, respec=None):
        self.calls += 1
        self.body()


def eager_twin(eng):
    """``eng``, its decode steps and its prefill chunks running their
    programs' uncaptured bodies (one EagerStep a bucket, in
    ``eng._twin_chunks``)."""
    build, build_chunk = eng._decode_program, eng._prefill_program
    eng._decode_program = lambda: EagerStep(build())
    eng._twin_chunks = {}

    def chunk_program(P):
        if P not in eng._twin_chunks:
            eng._twin_chunks[P] = EagerStep(build_chunk(P))
        return eng._twin_chunks[P]
    eng._prefill_program = chunk_program
    return eng


@contextlib.contextmanager
def eager_programs():
    """``generate_paged``'s decode steps run eagerly inside the block:
    its step program (``inference.program.Program``) swapped for
    EagerStep."""
    from paddle_tpu_torch.inference import program
    real = program.Program
    program.Program = lambda body, *a, **k: EagerStep(
        types.SimpleNamespace(body=body))
    try:
        yield
    finally:
        program.Program = real


def captured(eng, route, chunks=None):
    """The engine's one decode program, which must have been captured
    once (``decode_traces`` 1) and replayed at every decode step after
    the first (the warm-up), and its prefill programs: one a bucket used,
    captured (``prefill_traces[P]`` 1) where the bucket ran more than one
    chunk, every chunk after a bucket's first a replay (``chunks``, the
    engine's chunk count where no ``reset_metrics`` intervened, = the
    replays plus the buckets used). Returns the decode program."""
    progs = list(eng._decode_fns.values())
    steps = eng.counters["decode_steps"]
    if (len(progs) != 1 or eng.counters["decode_traces"] != 1
            or progs[0].graph is None or progs[0].replays != steps - 1):
        raise AssertionError(
            f"{route}: the decode step is not one replayed graph: "
            f"{len(progs)} program(s), decode_traces "
            f"{eng.counters['decode_traces']}, {steps} steps, replays "
            f"{[p.replays for p in progs]}")
    chunk_progs = {key[0]: p for key, p in eng._prefill_fns.items()}
    traces = eng.counters["prefill_traces"]
    bad = [P for P, p in chunk_progs.items()
           if traces.get(P) != int(p.graph is not None)
           or (p.graph is None and p.replays)]
    replays = sum(p.replays for p in chunk_progs.values())
    if (len(chunk_progs) != len(eng._prefill_fns) or bad
            or set(traces) != set(chunk_progs)
            or (chunks is not None
                and replays != chunks - len(chunk_progs))):
        raise AssertionError(
            f"{route}: the prefill chunks are not one replayed graph a "
            f"bucket: programs {list(eng._prefill_fns)}, prefill_traces "
            f"{traces}, replays {[p.replays for p in chunk_progs.values()]}"
            f", {chunks} chunks")
    return progs[0]


def chunk_replays_held(g, t, route):
    """Engine ``g``'s prefill programs against its eager twin ``t``'s
    chunks: each bucket's program captured (``prefill_traces`` 1) where
    the bucket ran more than one chunk and replayed at every chunk but its
    first; the twin captured nothing. Returns the twin's chunks by
    bucket."""
    twin = {P: st.calls for P, st in t._twin_chunks.items()}
    got = {pk[0]: (p.replays, g.counters["prefill_traces"][pk[0]])
           for pk, p in g._prefill_fns.items()}
    want = {P: (n - 1, int(n > 1)) for P, n in twin.items()}
    if got != want or t.counters["decode_traces"] or any(
            t.counters["prefill_traces"].values()):
        raise AssertionError(
            f"{route}: chunk (replays, prefill_traces) by bucket {got}, "
            f"want {want} from the twin's chunks; twin's traces "
            f"{t.counters['decode_traces']}, {t.counters['prefill_traces']}")
    return twin


def graph_stats(prog, eng=None):
    """A decode program's capture seconds, graph nodes and replays and,
    given its engine, each bucket's prefill program's."""
    out = {"capture_s": round(prog.capture_s, 4),
           "graph_nodes": prog.nodes, "replays": prog.replays}
    if eng is not None:
        out["chunk_programs"] = {
            str(key[0]): {"capture_s": p.capture_s and round(p.capture_s, 4),
                          "graph_nodes": p.nodes, "replays": p.replays}
            for key, p in eng._prefill_fns.items()}
    return out


GRAPH_PARITY_ROUTES = {
    **ROUTES, **QUANT_ROUTES,
    "int4_two_stage": dict(ROUTES["two_stage"], weight_quant="int4"),
    "kv8_default": KV8_ROUTES["kv8_default"],
    "kv8_two_stage": KV8_ROUTES["kv8_two_stage"],
    "tp1_psum": {"mesh": (1, "psum")}, "tp2_psum": {"mesh": (2, "psum")}}
GRAPH_SERVING_ROUTES = ("default", "two_stage", "unfused", "kv8_default")
# the routes whose sampled ids are held too, at the parity size
GRAPH_SAMPLED = ("default", "two_stage", "unfused", "kv8_default")
GRAPH_SEEDS = (0, 1)


def _graph_engine(params, cfg, route, routes, engine_kw, seed):
    from paddle_tpu_torch.inference import ServingEngine, ServingMesh
    kw = dict(routes[route])
    if "mesh" in kw:
        tp, coll = kw.pop("mesh")
        kw["mesh"] = ServingMesh.make(tp, collective=coll,
                                      devices=["cuda:0"] * tp)
    return ServingEngine(params, cfg, seed=seed, **engine_kw, **kw)


def _graph_run(eng, prompts, gens):
    """The requests through ``eng``: (ids, launches, launches by class,
    serving metrics: tokens/s, TTFT mean and max, decode-step ms and the
    chunk ms by bucket)."""
    import torch
    from paddle_tpu_torch.ops import kernels
    kernels.reset_launches()
    record = _timed_chunks(eng)
    reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    eng.drain()
    torch.cuda.synchronize()
    m = eng.metrics()
    served = {k: m[k] for k in ("tokens_per_sec", "ttft_ms_mean",
                                "ttft_ms_max", "decode_step_ms_mean",
                                "prefill_chunks")}
    served["chunk_ms"] = chunk_ms(record)
    return ([r.tokens for r in reqs], kernels.launches(),
            kernels.launches_by_class(), served)


def _pools_equal(a, b):
    """The engines' pools byte for byte, but scratch page 0 (the inactive
    slots' and pad rows' duplicate writes land there, in no fixed
    order)."""
    import torch
    pa = a._k_pools if isinstance(a._k_pools, list) else [a._k_pools]
    pb = b._k_pools if isinstance(b._k_pools, list) else [b._k_pools]
    va = a._v_pools if isinstance(a._v_pools, list) else [a._v_pools]
    vb = b._v_pools if isinstance(b._v_pools, list) else [b._v_pools]
    return all(torch.equal(x[:, 1:], y[:, 1:])
               for x, y in zip(pa + va, pb + vb))


def _tickets_zero():
    """Whether every ticket counter of the weight ring reads zero."""
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    return all(not bool(t.any()) for t in fdb._TICKETS.values())


def graph_phase(gpu, size, params=None):
    """The captured decode step against its eager twin. ``size``
    "parity": LLaMA-7B widths, 2 layers, f32, the parity phase's 5
    requests through 2 slots, on every route of GRAPH_PARITY_ROUTES
    (default, two-stage, unfused; int8 and int4 weights on the default and
    two-stage routes; int8 pools on both; tp=1 and colocated tp=2
    "psum"); "serving": the serving phase's size (32 layers, bf16, 8
    slots, its 12 requests, over ``params``, the serving phases' tree) on
    GRAPH_SERVING_ROUTES. Each engine runs
    beside a twin built with the same seed and parameters whose every
    decode step calls the uncaptured body (:func:`eager_twin`): greedy ids
    equal, pools byte-equal after the drain (but scratch page 0), launch
    counts (and by class) equal, ``decode_traces`` 1 with every step after
    the first a replay, the weight ring's tickets zero after the drain; at
    the parity size on GRAPH_SAMPLED also sampled ids (temperature 0.8,
    seeds 0 and 1) equal to the twin's for the same seed. The prefill
    chunks the same way: the twin's run its buckets' uncaptured bodies;
    the engine's one program a bucket used, captured (``prefill_traces``
    1) where the bucket ran more than one chunk, every chunk after a
    bucket's first a replay (replays = chunks - buckets used), the
    twin's ``prefill_traces`` all 0. Prints each route's capture seconds
    and graph nodes (decode and a bucket's chunk), and both engines'
    step ms, chunk ms by bucket (CUDA events around each chunk),
    tokens/s and TTFT mean and max."""
    import dataclasses
    import torch
    from paddle_tpu_torch.inference import GenerationConfig
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    if size == "parity":
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = dataclasses.replace(LLAMA_7B, num_hidden_layers=2,
                                  dtype=torch.float32)
        params = init_params(cfg, seed=1)
        specs = [(5, 6), (40, 4), (300, 5), (17, 3), (129, 5)]
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, S).astype(np.int32)
                   for S, _ in specs]
        news = [N for _, N in specs]
        engine_kw = dict(capacity=2, block_size=16, max_seq_len=512,
                         prefill_buckets=(32, 128))
        routes, sampled = GRAPH_PARITY_ROUTES, GRAPH_SAMPLED
    else:
        cfg = LLAMA_7B
        rng = np.random.default_rng(0)
        lens = rng.integers(40, 601, SERVE_REQUESTS)
        prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
                   for n in lens]
        news = [SERVE_NEW] * len(prompts)
        engine_kw = dict(capacity=8, block_size=16, max_seq_len=1024,
                         prefill_buckets=(32, 128))
        routes = {r: ALL_ROUTES[r] for r in GRAPH_SERVING_ROUTES}
        sampled = ()
    greedy = [GenerationConfig(max_new_tokens=N, greedy=True) for N in news]
    out, bad = {}, []
    t0 = time.perf_counter()
    for route in routes:
        runs = {}
        for seed, gens in [(0, greedy)] + [
                (sd, [GenerationConfig(max_new_tokens=N, temperature=0.8)
                      for N in news])
                for sd in (GRAPH_SEEDS if route in sampled else ())]:
            pair = []
            for twin in (False, True):
                eng = _graph_engine(params, cfg, route, routes, engine_kw,
                                    seed)
                if twin:
                    eager_twin(eng)
                ids, counts, by_class, served = _graph_run(eng, prompts,
                                                           gens)
                pair.append((eng, ids, counts, by_class, served))
            (g, ids, counts, by_class, served), (t, t_ids, t_counts,
                                                 t_by_class, t_served) = pair
            key = "greedy" if gens is greedy else f"sampled_seed{seed}"
            res = {"ids_equal": ids == t_ids,
                   "launches_equal": counts == t_counts
                   and by_class == t_by_class,
                   "pools_equal": _pools_equal(g, t),
                   "tickets_zero": _tickets_zero(),
                   "decode_traces": g.counters["decode_traces"],
                   "twin_decode_traces": t.counters["decode_traces"],
                   "prefill_traces": g.counters["prefill_traces"],
                   "twin_prefill_traces": t.counters["prefill_traces"],
                   "decode_steps": g.counters["decode_steps"],
                   "served": served, "twin_served": t_served}
            try:
                res.update(graph_stats(captured(
                    g, route, g.counters["prefill_chunks"]), g))
                res["twin_chunks_by_bucket"] = chunk_replays_held(g, t,
                                                                  route)
            except AssertionError as e:
                res["captured"] = str(e)
                bad.append((route, key, "captured"))
            for k in ("ids_equal", "launches_equal", "pools_equal",
                      "tickets_zero"):
                if not res[k]:
                    bad.append((route, key, k))
            if key == "greedy":
                res["launches"] = {k: v for k, v in counts.items() if v}
            runs[key] = res
            del pair, g, t
            gc.collect()
            torch.cuda.empty_cache()
        out[route] = runs
    emit({"phase": "graph", "size": size, "gpu": gpu,
          "dtype": str(cfg.dtype).replace("torch.", ""),
          "layers": cfg.num_hidden_layers, "routes": out,
          "failed": [list(b) for b in bad],
          "seconds": round(time.perf_counter() - t0, 1)})
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"graph phase ({size}): {bad}")


# ---------------------------------------------------------------------------
# the radix prefix cache, its host tier and generate_paged
# ---------------------------------------------------------------------------
# the parity size's engine (the graph phase's); the streams of
# tests/test_prefix_cache.py and tests/test_fleet.py run at block 16: their
# token lengths and the undersized pool's max_seq_len scaled by 4 (their
# block is 4), the pools' page counts kept
PREFIX_ENGINE = dict(capacity=2, block_size=16, max_seq_len=512,
                     prefill_buckets=(32, 128))
PREFIX_TIE = 1e-4       # the parity phase's near-tie bound on a top-2 gap


def _pgen(n, greedy=True, temperature=1.0):
    from paddle_tpu_torch.inference import GenerationConfig
    return GenerationConfig(max_new_tokens=n, greedy=greedy,
                            temperature=temperature)


def _pages_of(eng, pages):
    return [(eng._k_pools[:, p].clone(), eng._v_pools[:, p].clone())
            for p in pages]


def _same_pages(eng, pages, saved):
    import torch
    return all(torch.equal(eng._k_pools[:, p], k)
               and torch.equal(eng._v_pools[:, p], v)
               for p, (k, v) in zip(pages, saved))


def _ps_twice(n_tokens, n_new):
    def stream(eng, rng, V):
        p = rng.integers(0, V, n_tokens).astype(np.int32)
        r1 = eng.submit(p, _pgen(n_new))
        eng.drain()
        r2 = eng.submit(p, _pgen(n_new))
        eng.drain()
        return [r1, r2]
    return stream


def _ps_three(eng, rng, V):
    sysp = rng.integers(0, V, 48).astype(np.int32)
    reqs = [eng.submit(np.concatenate(
        [sysp, rng.integers(0, V, 20 + 4 * i).astype(np.int32)]), _pgen(5))
        for i in range(3)]
    eng.drain()
    return reqs


def _ps_cow(eng, rng, V):
    """A request diverging inside the cached prompt's partial tail page:
    the cached pages keep their bytes exactly."""
    base = rng.integers(0, V, 40).astype(np.int32)
    r1 = eng.submit(base, _pgen(4))
    eng.drain()
    pages = saved = None
    if eng._pcache is not None:
        full, tail, _ = eng._pcache.match(base)
        pages = [n.page for n in full] + [tail.page]
        saved = _pages_of(eng, pages)
    div = base.copy()
    div[36] = (div[36] + 1) % V
    div = np.concatenate([div, rng.integers(0, V, 24).astype(np.int32)])
    r2 = eng.submit(div, _pgen(4))
    eng.drain()
    if pages is not None and not _same_pages(eng, pages, saved):
        raise AssertionError("prefix: a divergent writer changed a cached "
                             f"page (of {pages})")
    r3 = eng.submit(base, _pgen(4))
    eng.drain()
    return [r1, r2, r3]


def _ps_in_flight(eng, rng, V):
    p = rng.integers(0, V, 48).astype(np.int32)
    r1 = eng.submit(p, _pgen(8))
    eng.step()
    r2 = eng.submit(np.concatenate(
        [p, rng.integers(0, V, 16).astype(np.int32)]), _pgen(8))
    eng.drain()
    return [r1, r2]


def _ps_many(n_tokens, n_new, repeat_first=False):
    def stream(eng, rng, V):
        prompts = [rng.integers(0, V, n_tokens).astype(np.int32)
                   for _ in range(6)]
        reqs = [eng.submit(p, _pgen(n_new)) for p in prompts]
        eng.drain()
        if repeat_first:
            reqs.append(eng.submit(prompts[0], _pgen(n_new)))
            eng.drain()
        return reqs
    return stream


def _ps_mixed(eng, rng, V):
    sysp = rng.integers(0, V, 32).astype(np.int32)
    reqs = []
    for i in range(12):
        p = rng.integers(0, V, int(rng.integers(12, 60))).astype(np.int32)
        if i % 2:
            p = np.concatenate([sysp, p[:24]])
        reqs.append(eng.submit(p, _pgen(int(rng.integers(2, 6)),
                                        greedy=bool(i % 3),
                                        temperature=0.7)))
        eng.step()
    eng.drain()
    return reqs


def _ps_spill(eng, rng, V):
    """The whole tree spilled to host memory, then hit again: the restored
    pages hold the spilled bytes bit for bit."""
    p = rng.integers(0, V, 48).astype(np.int32)
    r1 = eng.submit(p, _pgen(4))
    eng.drain()
    pc = eng._pcache
    if pc is not None:
        full, _, _ = pc.match(p)
        saved = _pages_of(eng, [n.page for n in full])
        if pc.evict(100) < 3 or pc.cached_pages:
            raise AssertionError("prefix: the tree did not spill whole")
    r2 = eng.submit(p, _pgen(4))
    eng.drain()
    if pc is not None:
        full, _, _ = pc.match(p)
        if not _same_pages(eng, [n.page for n in full[:2]], saved[:2]):
            raise AssertionError("prefix: restored bytes differ from the "
                                 "spilled ones")
    return [r1, r2]


UNDERSIZED = dict(num_blocks=14, max_seq_len=128)
# name -> (stream, seed, engine keywords beside prefix_cache=True)
PREFIX_STREAMS = {
    "warm_cache": (_ps_twice(80, 5), 0, {}),
    "three_shared": (_ps_three, 1, {}),
    "cow_divergent": (_ps_cow, 2, {}),
    "in_flight": (_ps_in_flight, 8, {}),
    "eviction": (_ps_many(64, 4), 3, UNDERSIZED),
    "tail_upgrade": (_ps_many(40, 3), 7, UNDERSIZED),
    "int8": (_ps_twice(48, 5), 4, dict(cache_dtype="int8")),
    "mixed": (_ps_mixed, 5, dict(capacity=3)),
    "spill_restore": (_ps_spill, 4, dict(kv_offload=True)),
    "pressure": (_ps_many(64, 4, repeat_first=True), 5,
                 dict(UNDERSIZED, kv_offload=True)),
    "host_budget": (_ps_many(64, 4), 6, dict(UNDERSIZED, kv_offload=2)),
}
# the streams also run on the two-stage and the unfused decode routes
PREFIX_ROUTE_STREAMS = ("three_shared", "cow_divergent", "pressure")


def _prefix_engine(params, cfg, device, kw):
    from paddle_tpu_torch.inference import ServingEngine
    return ServingEngine(params, cfg, device=device,
                         **dict(PREFIX_ENGINE, **kw))


def _tie_gap(params, cfg, prompt, ids):
    """The top-2 gap of the port's dense logits after ``prompt + ids`` on
    the card."""
    import torch
    from paddle_tpu_torch.inference.generation import (cached_forward,
                                                       init_cache)
    x = torch.tensor([[int(t) for t in prompt] + list(ids)], device="cuda")
    kc, vc = init_cache(cfg, 1, x.shape[1])
    logits, _, _ = cached_forward(params, x, cfg, kc, vc, 0)
    top2 = torch.topk(logits[0, -1].float(), 2).values
    return float(top2[0] - top2[1])


def _ids_held(params, cfg, prompt, got, want):
    """None when equal, else the first divergent step and the dense top-2
    gap there (which must be a near tie)."""
    if got == want:
        return None
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    return {"step": j, "top2_gap": _tie_gap(params, cfg, prompt, want[:j])}


def _prefix_compare(name, route, eng, reqs, cold, cpu, params, cfg, dense):
    """One stream's card run on ``route`` against the cold engine, the
    port's dense ``generate`` and the port's CPU run of the same stream."""
    m = eng.metrics()
    cpu_eng, cpu_reqs = cpu
    parts = []
    for r, c in zip(reqs, cold):
        if not r.gen.greedy:
            continue
        for what, want in (("cold", c.tokens),
                           ("dense", None if name == "int8"
                            else dense(r.prompt, len(r.tokens)))):
            if want is None:
                continue
            d = _ids_held(params, cfg, r.prompt, r.tokens, want)
            if d is not None:
                parts.append(dict(d, req=r.req_id, against=what))
    same_ids = all(a.tokens == b.tokens for a, b in zip(reqs, cpu_reqs))
    summary = eng.prefix_summary()
    # the tree's paths carry the generated ids: where a sampled or parted
    # request's differ from the CPU run's, the summaries are held in their
    # lengths and the counters in those the prompts alone decide
    keys = (list(m["prefix_cache"]) if same_ids else
            ["hits", "misses", "tokens_skipped", "shared_pages",
             "cow_forks"])
    cpu_m = cpu_eng.metrics()["prefix_cache"]
    res = {"requests": len(reqs), "parted": parts,
           "ids_equal_cpu": same_ids,
           "prefix_cache": m["prefix_cache"],
           "offload": eng.offload_metrics(),
           "prefix_cache_equal_cpu": all(m["prefix_cache"][k] == cpu_m[k]
                                         for k in keys),
           "offload_equal_cpu": (not same_ids or eng.offload_metrics()
                                 == cpu_eng.offload_metrics()),
           "summary_equal_cpu": (
               summary == cpu_eng.prefix_summary() if same_ids else
               sorted(summary.values())
               == sorted(cpu_eng.prefix_summary().values())),
           "decode_traces": m["decode_traces"],
           "prefill_traces": m["prefill_traces"],
           "checks": eng.mgr.check(False) + eng._pcache.check(False),
           "tickets_zero": _tickets_zero()}
    bad = [k for k in ("prefix_cache_equal_cpu", "offload_equal_cpu",
                       "summary_equal_cpu", "tickets_zero") if not res[k]]
    if res["decode_traces"] != 1 or any(
            n > 1 for n in res["prefill_traces"].values()):
        bad.append("traces")
    if res["checks"]:
        bad.append("checks")
    # over int8 pools a chunk's codes may round across a boundary where
    # the cold run's did not: parted ids there are printed, not held
    bad += [f"ids ({p['against']})" for p in parts
            if p["top2_gap"] >= PREFIX_TIE and name != "int8"]
    return res, [(name, route, b) for b in bad]


def _generate_paged_parity(params, cpu_params, cfg, dense):
    """``generate_paged`` at the parity size on the card: two 40-token
    prompts, 6 new tokens, on the default, two-stage and unfused decode
    routes against dense ``generate``; over an int8 cache against the same
    call on the CPU; a ``PagedKVCacheStore`` called twice (the second call
    warm: the one-token suffix through the fused chunk) against dense
    ``generate`` and its counters against a CPU store's. Every route, and
    int8 weights, a colocated tp=2 mesh and top-k/top-p sampling besides,
    also runs with its decode steps eager (:func:`eager_programs`): the
    captured steps' ids equal to the eager ones."""
    import torch
    from paddle_tpu_torch.inference import (GenerationConfig,
                                            PagedKVCacheStore, ServingMesh,
                                            generate_paged)
    rng = np.random.default_rng(9)
    p = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    g = _pgen(6)
    want = [dense(row, 6) for row in p]
    out, bad = {}, []

    def eager_held(name, ids, tree=params, gen=g, **kw):
        """The same call with the decode steps eager: ids equal."""
        with eager_programs():
            eager = generate_paged(tree, p, cfg, gen, **kw)
        out.setdefault(name, {})["eager_ids_equal"] = torch.equal(ids,
                                                                  eager)
        if not torch.equal(ids, eager):
            bad.append(("generate_paged", name, "captured != eager"))

    def held(name, ids, wants, hold=True):
        parts = [dict(d, row=i) for i, (row, got, w) in
                 enumerate(zip(p, ids, wants))
                 if (d := _ids_held(params, cfg, row, got, w)) is not None]
        out[name] = {"parted": parts}
        bad.extend(("generate_paged", name, "ids") for d in parts
                   if d["top2_gap"] >= PREFIX_TIE and hold)

    for route, fused in (("default", None), ("two_stage", "pallas"),
                         ("unfused", False)):
        ids = generate_paged(params, p, cfg, g, fused_decode=fused)
        held(route, ids[:, 40:].tolist(), want)
        eager_held(route, ids, fused_decode=fused)
    kv8 = generate_paged(params, p, cfg, g, cache_dtype="int8")
    kv8_cpu = generate_paged(cpu_params, p, cfg, g, cache_dtype="int8",
                             device="cpu")
    # int8 codes may round differently on the card: printed, not held
    held("int8_cache", kv8[:, 40:].tolist(), kv8_cpu[:, 40:].tolist(),
         hold=False)
    eager_held("int8_cache", kv8, cache_dtype="int8")
    for name, kw in (
            ("int8_weights", dict(weight_quant="int8")),
            ("tp2_psum", dict(mesh=ServingMesh.make(
                2, collective="psum", devices=["cuda:0"] * 2))),
            ("sampled_top_k_p", dict(seed=3))):
        gen = (GenerationConfig(max_new_tokens=6, temperature=0.8,
                                top_k=40, top_p=0.9)
               if name.startswith("sampled") else g)
        eager_held(name, generate_paged(params, p, cfg, gen, **kw),
                   gen=gen, **kw)
    store = PagedKVCacheStore(cfg, block_size=16, num_blocks=64)
    cpu_store = PagedKVCacheStore(cfg, block_size=16, num_blocks=64,
                                  device="cpu")
    eager_store = PagedKVCacheStore(cfg, block_size=16, num_blocks=64)
    for call in ("cold", "warm"):
        ids = generate_paged(params, p, cfg, g, prefix_cache=store)
        generate_paged(cpu_params, p, cfg, g, prefix_cache=cpu_store)
        held(f"store_{call}", ids[:, 40:].tolist(), want)
        eager_held(f"store_{call}", ids, prefix_cache=eager_store)
        out[f"store_{call}"]["metrics"] = store.metrics()
        if store.metrics() != cpu_store.metrics():
            bad.append(("generate_paged", f"store_{call}", "metrics"))
    if store.cache.stats["tokens_skipped"] != 2 * 39:
        bad.append(("generate_paged", "store_warm", "tokens_skipped"))
    torch.cuda.synchronize()
    return out, bad


PREFIX_SERVE = {"requests": 24, "shared": 224, "tail": 32, "new": 64}
# the offload run's pool: the 8 slots' live pages (14 shared + 8 x 6) fit,
# the tree of 24 finished requests (14 + 24 x 6 pages) does not
PREFIX_OFFLOAD_BLOCKS = 96


def _prefix_stream(params, cfg, prompts, warm, gen, on_engine=None, **kw):
    """bench.py's prefix stream (``bench_serving_prefix_cache``) through
    one engine: a warm-up request (the first prompt, 2 new tokens; it
    seeds a prefix cache) and one more sharing the system prompt, then
    ``reset_metrics`` and every request submitted at once and drained.
    ``on_engine`` sees the engine before its first request."""
    import torch
    from paddle_tpu_torch.inference import ServingEngine
    eng = ServingEngine(params, cfg, capacity=8, block_size=16,
                        max_seq_len=1024, prefill_buckets=(32, 128), **kw)
    if on_engine is not None:
        on_engine(eng)
    for p in (prompts[0], warm):
        eng.submit(p, _pgen(2))
        eng.drain()
    eng.reset_metrics()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, gen) for p in prompts]
    eng.drain()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0


def _timed_offload(eng, acc):
    """The tree's spill and restore callbacks, each batch timed between two
    device syncs (the pinned copies are otherwise left in flight), its
    seconds, pages and bytes summed into ``acc`` by direction."""
    import torch
    pc = eng._pcache

    def wrap(fn, key, pages_arg):
        def timed(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            n = len(a[pages_arg])
            acc[key]["s"] += time.perf_counter() - t
            acc[key]["pages"] += n
            acc[key]["bytes"] += n * eng._page_nbytes
            return out
        return timed
    pc._spill_batch = wrap(pc._spill_batch, "spill", 0)
    pc._restore_batch = wrap(pc._restore_batch, "restore", 1)


def _stream_row(eng, reqs, wall):
    m = eng.metrics()
    row = {"wall_s": round(wall, 3),
           "tokens_per_sec": round(sum(len(r.tokens) for r in reqs) / wall,
                                   3),
           "ttft_ms_mean": m["ttft_ms_mean"], "ttft_ms_max": m["ttft_ms_max"],
           "prefill_chunks": m["prefill_chunks"],
           "prefill_tokens": m["prefill_tokens"],
           "decode_steps": m["decode_steps"],
           "decode_step_ms_mean": m["decode_step_ms_mean"],
           "decode_traces": m["decode_traces"],
           "prefill_traces": m["prefill_traces"]}
    if "prefix_cache" in m:
        pc = m["prefix_cache"]
        row.update({k: pc[k] for k in ("hits", "misses", "tokens_skipped",
                                       "shared_pages", "cow_forks",
                                       "evicted_pages")},
                   offload=eng.offload_metrics())
    return row


def prefix_phase(gpu, size, params=None):
    """The radix prefix cache, its host tier and ``generate_paged`` on the
    card. Returns the launch counts of its serving-size run (0 at the
    parity size) and of its int8-pool stream.

    ``size`` "parity": LLaMA-7B widths, 2 layers, f32 (the graph phase's
    config and engine): the streams of tests/test_prefix_cache.py (warm
    cache, three requests sharing a prefix, a divergent writer over a COW
    fork, in-flight sharing, eviction in an undersized pool twice, the int8
    cache, the 12-request mixed stream) and the spill/restore streams of
    tests/test_fleet.py (the whole tree spilled and hit again, pressure on
    an undersized pool and a repeat served from the host tier, a host
    budget of 2 pages), PREFIX_ROUTE_STREAMS also on the two-stage and
    unfused routes. Each run holds: greedy ids equal to the same stream on
    a cold engine (no prefix cache, same route) and to dense ``generate``
    (or parting on a near tie, gap < PREFIX_TIE), ``metrics()
    ["prefix_cache"]``, ``offload_metrics()`` and ``prefix_summary()``
    equal to the port's CPU run of the stream, one decode capture and at
    most one chunk route a bucket, both checks clean and the ring's
    tickets zero after the replays; a cached page's bytes unchanged by a
    divergent writer and restored bytes equal to the spilled ones. Then
    ``generate_paged`` (:func:`_generate_paged_parity`).

    ``size`` "serving": LLaMA-7B (32 layers, ``params``, bf16), the
    serving phase's engine (capacity 8, block 16, max 1024, buckets 32 and
    128): bench.py's prefix stream, 24 requests of a 224-token shared
    prefix and a 32-token unique tail, 64 greedy new tokens, submitted at
    once after a warm-up, cold (no prefix cache), warm, and warm with
    ``kv_offload`` over PREFIX_OFFLOAD_BLOCKS pages, then its first 8
    prompts again (served from the host tier). Prints tokens/s, TTFT mean
    and max, prefill chunks and tokens, hits, tokens skipped, COW forks,
    spilled and restored pages and bytes, the pinned copies' GB/s, and
    each warm request's common prefix with its cold twin (bf16 ids may
    part); holds that the warm run prefills exactly the cold run's tokens
    less ``tokens_skipped``. Then ``generate_paged`` over 4 prompts of
    40-600 tokens, 32 new tokens, one call each, on the default route,
    the int8 cache, int8 weights and a ``PagedKVCacheStore`` called twice:
    ms a token."""
    import dataclasses
    import torch
    from paddle_tpu_torch.inference import (PagedKVCacheStore, generate,
                                            generate_paged)
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    from paddle_tpu_torch.models.llama import params_to
    from paddle_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    if size == "parity":
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = dataclasses.replace(LLAMA_7B, num_hidden_layers=2,
                                  dtype=torch.float32)
        params = init_params(cfg, seed=1)
        cpu_params = params_to(params, "cpu")
        dense_ids = {}

        def dense(prompt, n):
            key = (prompt.tobytes(), n)
            if key not in dense_ids:
                dense_ids[key] = generate(params, prompt[None], cfg,
                                          _pgen(n))[0, prompt.size:].tolist()
            return dense_ids[key]

        out, bad, kv8_counts = {}, [], {}
        for name, (stream, seed, kw) in PREFIX_STREAMS.items():
            kw = dict(kw, prefix_cache=True)
            cpu_eng = _prefix_engine(cpu_params, cfg, "cpu", kw)
            cpu = (cpu_eng, stream(cpu_eng, np.random.default_rng(seed),
                                   cfg.vocab_size))
            routes = (ROUTES if name in PREFIX_ROUTE_STREAMS
                      else {"default": ROUTES["default"]})
            out[name] = {}
            for route, knobs in routes.items():
                cold_kw = {k: v for k, v in kw.items()
                           if k not in ("prefix_cache", "kv_offload")}
                cold_eng = _prefix_engine(params, cfg, None,
                                          dict(cold_kw, **knobs))
                cold = stream(cold_eng, np.random.default_rng(seed),
                              cfg.vocab_size)
                del cold_eng
                runs = []
                for twin in (False, True):
                    kernels.reset_launches()
                    e = _prefix_engine(params, cfg, None, dict(kw, **knobs))
                    if twin:
                        eager_twin(e)
                    r = stream(e, np.random.default_rng(seed),
                               cfg.vocab_size)
                    torch.cuda.synchronize()
                    runs.append((e, r, kernels.launches(),
                                 kernels.launches_by_class()))
                    if name == "int8" and not twin:
                        kv8_counts = {"launches": kernels.launches(),
                                      "by_pool": kernels.launches_by_pool()}
                (eng, reqs, counts, by_class), (t, t_reqs, t_counts,
                                                t_by_class) = runs
                res, b = _prefix_compare(name, route, eng, reqs, cold, cpu,
                                         params, cfg, dense)
                # the captured chunks and steps against the eager twin's
                twin = {"ids_equal": [r.tokens for r in reqs]
                        == [r.tokens for r in t_reqs],
                        "pools_equal": _pools_equal(eng, t),
                        "launches_equal": counts == t_counts
                        and by_class == t_by_class}
                try:
                    twin["chunks_by_bucket"] = chunk_replays_held(eng, t,
                                                                  route)
                    twin["chunk_programs"] = graph_stats(
                        captured(eng, route), eng)["chunk_programs"]
                except AssertionError as e:
                    twin["captured"] = str(e)
                    b.append((name, route, "captured"))
                b += [(name, route, f"twin {k}") for k in
                      ("ids_equal", "pools_equal", "launches_equal")
                      if not twin[k]]
                res["eager_twin"] = twin
                out[name][route] = res
                bad += b
                del eng, t, runs
                gc.collect()
                torch.cuda.empty_cache()
        gp, b = _generate_paged_parity(params, cpu_params, cfg, dense)
        bad += b
        emit({"phase": "prefix", "size": size, "gpu": gpu,
              "dtype": "float32", "layers": 2, "streams": out,
              "generate_paged": gp, "failed": [list(x) for x in bad],
              "seconds": round(time.perf_counter() - t0, 1)})
        del params, cpu_params
        gc.collect()
        torch.cuda.empty_cache()
        if bad:
            raise AssertionError(f"prefix phase (parity): {bad}")
        return {"int8_stream": kv8_counts}

    cfg = LLAMA_7B
    S = PREFIX_SERVE
    rng = np.random.default_rng(0)
    sysp = rng.integers(0, cfg.vocab_size, S["shared"])
    prompts = [np.concatenate([sysp, rng.integers(0, cfg.vocab_size,
                                                  S["tail"])])
               .astype(np.int32) for _ in range(S["requests"])]
    warm = np.concatenate([sysp, rng.integers(0, cfg.vocab_size, S["tail"])
                           ]).astype(np.int32)
    gen = _pgen(S["new"])
    kernels.reset_launches()
    rows, bad = {}, []
    cold_eng, cold, wall = _prefix_stream(params, cfg, prompts, warm, gen)
    rows["cold"] = _stream_row(cold_eng, cold, wall)
    del cold_eng
    torch.cuda.empty_cache()
    warm_eng, warm_reqs, wall = _prefix_stream(params, cfg, prompts, warm,
                                               gen, prefix_cache=True)
    rows["warm"] = _stream_row(warm_eng, warm_reqs, wall)
    rows["warm"]["common_prefix_with_cold"] = [
        next((i for i, (a, b) in enumerate(zip(r.tokens, c.tokens))
              if a != b), len(r.tokens)) for r, c in zip(warm_reqs, cold)]
    progs = list(warm_eng._decode_fns.values())
    if len(progs) != 1 or progs[0].graph is None:
        bad.append(("serving", "warm decode step not one captured graph"))
    else:
        rows["warm"].update(graph_stats(progs[0]))
    del warm_eng, progs
    torch.cuda.empty_cache()
    moved = {k: {"s": 0.0, "pages": 0, "bytes": 0}
             for k in ("spill", "restore")}
    off_eng, off_reqs, wall = _prefix_stream(
        params, cfg, prompts, warm, gen,
        on_engine=lambda e: _timed_offload(e, moved), prefix_cache=True,
        kv_offload=True, num_blocks=PREFIX_OFFLOAD_BLOCKS)
    rows["offload"] = _stream_row(off_eng, off_reqs, wall)
    rows["offload"]["common_prefix_with_cold"] = [
        next((i for i, (a, b) in enumerate(zip(r.tokens, c.tokens))
              if a != b), len(r.tokens)) for r, c in zip(off_reqs, cold)]
    # the tree's accounting before reset_metrics zeroes its counters (after
    # it the spill identity no longer closes, as in the JAX engine)
    checks = off_eng.mgr.check(False) + off_eng._pcache.check(False)
    # the first 8 prompts again: their tails were spilled, the hits restore
    off_eng.reset_metrics()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    again = [off_eng.submit(p, gen) for p in prompts[:8]]
    off_eng.drain()
    torch.cuda.synchronize()
    rows["offload_repeat"] = _stream_row(off_eng, again,
                                         time.perf_counter() - t1)
    rows["offload_repeat"]["common_prefix_with_first_run"] = [
        next((i for i, (a, b) in enumerate(zip(r.tokens, c.tokens))
              if a != b), len(r.tokens)) for r, c in zip(again, off_reqs)]
    off = rows["offload"]["offload"]
    rows["offload_moved"] = {
        k: dict(v, s=round(v["s"], 4),
                gb_per_s=(round(v["bytes"] / v["s"] / 1e9, 3)
                          if v["s"] else None))
        for k, v in moved.items()}
    rows["offload_moved"]["page_bytes"] = off_eng._page_nbytes
    checks += off_eng.mgr.check(False)
    del off_eng
    gc.collect()
    torch.cuda.empty_cache()
    serve_counts = {"launches": kernels.launches(),
                    "by_pool": kernels.launches_by_pool()}
    for r in cold + warm_reqs + off_reqs + again:
        if not (r.done and len(r.tokens) == S["new"]
                and all(0 <= t < cfg.vocab_size for t in r.tokens)):
            raise AssertionError(f"prefix stream: request {r.req_id} "
                                 f"unfinished or out of range")
    c, w = rows["cold"], rows["warm"]
    if w["prefill_tokens"] != c["prefill_tokens"] - w["tokens_skipped"]:
        bad.append(("serving", "warm prefill tokens",
                    w["prefill_tokens"], c["prefill_tokens"],
                    w["tokens_skipped"]))
    if not (w["hits"] == S["requests"] and w["tokens_skipped"]
            >= S["requests"] * S["shared"]):
        bad.append(("serving", "hits", w["hits"], w["tokens_skipped"]))
    o = rows["offload"]
    if o["prefill_tokens"] != c["prefill_tokens"] - o["tokens_skipped"]:
        bad.append(("serving", "offload prefill tokens"))
    rep = rows["offload_repeat"]["offload"]
    if not (off["spilled_pages"] > 0 and rep["restored_pages"] > 0):
        bad.append(("serving", "offload", off))
    if checks:
        bad.append(("serving", "checks", checks))
    for k in ("cold", "warm", "offload", "offload_repeat"):
        if rows[k]["decode_traces"] != 1 or any(
                n > 1 for n in rows[k]["prefill_traces"].values()):
            bad.append(("serving", k, "traces"))
    # generate_paged: 4 prompts of 40-600 tokens, one call each
    lens = [int(n) for n in np.random.default_rng(3).integers(40, 601, 4)]
    gp_prompts = [np.random.default_rng(10 + i).integers(
        0, cfg.vocab_size, (1, n)).astype(np.int32)
        for i, n in enumerate(lens)]
    g32 = _pgen(32)
    from paddle_tpu_torch.quantization import quantize_weights
    torch.cuda.synchronize()
    tq = time.perf_counter()
    q8 = quantize_weights(params, bits=8)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - tq
    store = PagedKVCacheStore(cfg, block_size=16, num_blocks=512)
    gp = {"prompt_tokens": lens, "new_tokens": 32,
          "int8_quantize_s": round(quant_s, 3)}
    runs = {"default": (params, {}), "int8_cache": (params,
                                                    dict(cache_dtype="int8")),
            "int8_weights": (q8, {}),
            "store_cold": (params, dict(prefix_cache=store)),
            "store_warm": (params, dict(prefix_cache=store)),
            # the default route with its decode steps eager, as before
            # they were captured
            "default_eager": (params, {})}
    ids = {}
    for name, (tree, kw) in runs.items():
        ms, ids[name] = [], []
        for p in gp_prompts:
            torch.cuda.synchronize()
            t = time.perf_counter()
            with (eager_programs() if name.endswith("_eager")
                  else contextlib.nullcontext()):
                o = generate_paged(tree, p, cfg, g32, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3 / 32)
            toks = o[0, p.shape[1]:].tolist()
            if len(toks) != 32 or not all(0 <= x < cfg.vocab_size
                                          for x in toks):
                raise AssertionError(f"generate_paged {name}: {toks}")
            ids[name].append(toks)
        gp[name] = {"ms_per_token": [round(x, 3) for x in ms],
                    "ms_per_token_mean": round(float(np.mean(ms)), 3)}
    gp["default_eager_ids_equal"] = ids["default_eager"] == ids["default"]
    if not gp["default_eager_ids_equal"]:
        bad.append(("generate_paged", "default captured != eager"))
    gp["store"] = store.metrics()
    gp["store_warm_common_prefix_with_cold"] = [
        next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
        for x, y in zip(ids["store_warm"], ids["store_cold"])]
    if store.cache.stats["tokens_skipped"] != sum(n - 1 for n in lens):
        bad.append(("generate_paged", "store tokens_skipped",
                    store.cache.stats["tokens_skipped"]))
    del q8, store
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "prefix", "size": size, "gpu": gpu, "model": "LLAMA_7B",
          "layers": cfg.num_hidden_layers, "dtype": "bfloat16",
          "stream": dict(S, offload_blocks=PREFIX_OFFLOAD_BLOCKS),
          **rows, "generate_paged": gp,
          "launches": {k: v for k, v in serve_counts["launches"].items()
                       if v},
          "failed": [list(map(str, b)) for b in bad],
          "seconds": round(time.perf_counter() - t0, 1)})
    if bad:
        raise AssertionError(f"prefix phase (serving): {bad}")
    return serve_counts


# ---------------------------------------------------------------------------
# disaggregated prefill/decode serving and the fleet router
# ---------------------------------------------------------------------------
# the parity size runs the streams of tests/test_disagg.py and
# tests/test_fleet.py at block 16: their token lengths, buckets, max_seq_len
# and new tokens scaled by 4 (their block is 4), page counts kept, prompt
# ids below 97 (their vocabulary), so that the port's CPU run of each stream
# (their model: vocabulary 97, hidden 64, 2 layers, f32) takes the same
# prompts. What it holds of the CPU run is the schedule (handoffs, pages
# moved, routing, prefix hits, offload pages), which no generated id moves:
# no stream stops at an EOS, and no prompt holds a generated id
DISAGG_SCALE = 4
DISAGG_V = 97
DISAGG_ENGINE = dict(capacity=3, block_size=16, prefill_buckets=(32, 64),
                     max_seq_len=256)
DISAGG_HANDOFF = ("handoffs", "partial_handoffs", "handoff_traces",
                  "requests_submitted", "drain_truncations")


def _dprompt(rng, n):
    return rng.randint(0, DISAGG_V, int(n)).astype(np.int32)


def _ds_mixed(n=22, seed=7, new=5, sizes=(4, 14)):
    """tests/test_disagg.py's (and, with n 30 and sizes 4-14,
    tests/test_fleet.py's) stream: n requests arriving in waves
    interleaved with steps."""
    def stream(eng):
        rng = np.random.RandomState(seed)
        lens = rng.randint(*sizes, n) * DISAGG_SCALE
        reqs = []
        for i, s in enumerate(lens):
            reqs.append(eng.submit(_dprompt(rng, s),
                                   _pgen(new * DISAGG_SCALE)))
            if i % 3 == 2:
                eng.step()
                eng.step()
        eng.drain()
        return reqs
    return stream


def _ds_twice(eng):
    """The prefix cache's warm path: the mixed stream cold, then again."""
    return _ds_mixed()(eng) + _ds_mixed()(eng)


def _ds_eos_first(eng):
    """A one-token budget: done on the prefill group, no handoff."""
    r = eng.submit(np.arange(1, 8 * DISAGG_SCALE + 1, dtype=np.int32),
                   _pgen(1))
    eng.drain()
    return [r]


def _ds_partial(eng):
    """Prompts longer than the largest bucket: partial windows."""
    rng = np.random.RandomState(9)
    reqs = [eng.submit(_dprompt(rng, 21 * DISAGG_SCALE),
                       _pgen(6 * DISAGG_SCALE)) for _ in range(4)]
    eng.drain()
    return reqs


def _ds_abort(eng):
    """A long prompt with a one-token budget: partials, then the abort
    marker releases the decode-side pages."""
    free0 = len(eng.decode.mgr.free) if hasattr(eng, "decode") else None
    r = eng.submit(np.arange(1, 21 * DISAGG_SCALE + 1, dtype=np.int32),
                   _pgen(1))
    eng.drain()
    if free0 is not None and len(eng.decode.mgr.free) != free0:
        raise AssertionError("disagg: the abort left decode pages held")
    return [r]


def _ds_preempt(eng):
    """A class-0 handoff preempts a class-2 decode slot."""
    rng = np.random.RandomState(4)
    prompts = [_dprompt(rng, 8 * DISAGG_SCALE) for _ in range(3)]
    g = _pgen(20 * DISAGG_SCALE)
    r0 = eng.submit(prompts[0], g, priority=2)
    r1 = eng.submit(prompts[1], g, priority=2)
    for _ in range(8):
        eng.step()
    hp = eng.submit(prompts[2], g, priority=0)
    eng.drain()
    return [r0, r1, hp]


# name -> (stream, keywords: the engine's beside DISAGG_ENGINE; "groups"
# = (prefill tp, decode tp, placement) for mesh groups on one device)
DISAGG_STREAMS = {
    "mixed22": (_ds_mixed(), {}),
    "prefix_warm": (_ds_twice, dict(prefix_cache=True)),
    "int8_pools": (_ds_mixed(n=8), dict(cache_dtype="int8")),
    "tp2_psum": (_ds_mixed(), dict(groups=(2, 2, "psum"))),
    "tp2_gather": (_ds_mixed(), dict(groups=(2, 2, "gather"))),
    "reshard_tp1_to_tp2": (_ds_mixed(), dict(groups=(1, 2, "gather"))),
    "partial": (_ds_partial, {}),
    "abort": (_ds_abort, {}),
    "preempt": (_ds_preempt, dict(capacity=2, prefill_slots=1,
                                  prefill_buckets=(32,))),
    "eos_first_token": (_ds_eos_first, dict(prefill_buckets=(32,))),
}


def _disagg_engine(params, cfg, device, kw):
    from paddle_tpu_torch.inference import DisaggregatedEngine
    kw = dict(DISAGG_ENGINE, **kw)
    kw.setdefault("prefill_slots", 2)
    groups = kw.pop("groups", None)
    if groups:
        tp_p, tp_d, coll = groups
        kw.update(prefill_devices=[device] * tp_p,
                  decode_devices=[device] * tp_d, collective=coll)
    else:
        kw["device"] = device
    return DisaggregatedEngine(params, cfg, **kw)


def _colocated_twin(params, cfg, device, kw):
    """The colocated engine on the route of a disaggregated engine built
    with ``kw``: the decode group's mesh and placement."""
    from paddle_tpu_torch.inference import ServingEngine, ServingMesh
    kw = {k: v for k, v in dict(DISAGG_ENGINE, **kw).items()
          if k != "prefill_slots"}
    groups = kw.pop("groups", None)
    if groups:
        kw["mesh"] = ServingMesh.make(groups[1], collective=groups[2],
                                      devices=[device] * groups[1])
    else:
        kw["device"] = device
    return ServingEngine(params, cfg, **kw)


def _group_pages(eng, pages):
    """An engine's pages ``pages`` of both pools, the shards' KV heads
    joined: (k, v) [L, n, BS, KV, hd] on its device."""
    import torch
    out = []
    for pools in (eng._k_pools, eng._v_pools):
        shards = pools if isinstance(pools, list) else [pools]
        idx = torch.as_tensor(list(pages), device=shards[0].device)
        out.append(torch.cat([p.index_select(1, idx) for p in shards],
                             dim=3))
    return out


def _decode_storage(eng):
    """The decode group's pools' and (once bound) scales' addresses."""
    dec = eng.decode
    ts = []
    for pools in (dec._k_pools, dec._v_pools):
        ts += pools if isinstance(pools, list) else [pools]
    if dec._kv_scales is not None:
        ts += list(dec._kv_scales) + [s for p in dec._shard_scales
                                      for s in p]
    return [t.data_ptr() for t in ts]


def _watch_handoffs(eng, held):
    """Each landed insert's decode pages against the prefill pages read
    when its transfer was issued (bit for bit, into ``held["pages"]``),
    and the decode group's storage after it (``held["storage"]``)."""
    import torch
    start, complete = eng._start_transfer, eng._complete_transfer

    def started(job):
        st = start(job)
        st["src_copy"] = _group_pages(eng.prefill,
                                      job.src_pages[job.offset:])
        return st

    def completed(st):
        complete(st)
        if not st["job"].abort:
            got = _group_pages(eng.decode, st["dst"])
            held["pages"].append(all(torch.equal(a, b) for a, b in
                                     zip(got, st["src_copy"])))
            held["storage"].append(_decode_storage(eng))
    eng._start_transfer, eng._complete_transfer = started, completed


def _handoff_schedule(eng):
    """What a disaggregated engine's schedule decides, on any device and
    model: the handoff counters, the pages moved, both groups' steps and
    chunks, preemptions and the prefill group's prefix hits."""
    m = eng.metrics()
    pre, dec = m["groups"]["prefill"], m["groups"]["decode"]
    out = {k: m[k] for k in DISAGG_HANDOFF}
    out["pages_moved"] = (m["kv_bytes_transferred"]
                          // eng.prefill._page_nbytes)
    out.update(prefill_chunks=pre["prefill_chunks"],
               decode_steps=dec["decode_steps"],
               preemptions=dec["preemptions"],
               requests_completed=m["requests_completed"])
    if "prefix_cache" in pre:
        out["prefix_cache"] = {k: pre["prefix_cache"][k] for k in (
            "hits", "misses", "tokens_skipped", "shared_pages",
            "cow_forks")}
    return out


def _groups_held(eng, name):
    """The decode group: one decode capture (where it stepped twice or
    more; replays = steps - 1) and no chunk; the prefill group: no decode
    program, at most one chunk capture a bucket."""
    pre, dec = eng.prefill, eng.decode
    bad = []
    if dec.counters["decode_steps"] >= 2:
        try:
            captured(dec, f"{name} decode group")
        except AssertionError as e:
            bad.append(str(e))
    elif dec.counters["decode_traces"]:
        bad.append("decode group captured without a second step")
    if dec.counters["prefill_chunks"] or dec._prefill_fns:
        bad.append("decode group ran a chunk")
    if pre._decode_fns or pre.counters["decode_traces"]:
        bad.append("prefill group built a decode step")
    traces = pre.counters["prefill_traces"]
    for key, p in pre._prefill_fns.items():
        if traces.get(key[0]) != int(p.graph is not None):
            bad.append(f"prefill group bucket {key[0]}: {traces}")
    return bad


def _disagg_parity(params, cfg, cpu_params, cpu_cfg):
    """The streams of DISAGG_STREAMS on the card (both groups on cuda:0)
    beside the colocated engine on the same route and the port's CPU
    run."""
    import torch
    out, bad = {}, []
    for name, (stream, kw) in DISAGG_STREAMS.items():
        eng = _disagg_engine(params, cfg, "cuda:0", kw)
        held = {"pages": [], "storage": []}
        _watch_handoffs(eng, held)
        pools0 = _decode_storage(eng)
        reqs = stream(eng)
        torch.cuda.synchronize()
        twin = _colocated_twin(params, cfg, "cuda:0", kw)
        twin_reqs = stream(twin)
        cpu = _disagg_engine(cpu_params, cpu_cfg, "cpu", kw)
        stream(cpu)
        sched = _handoff_schedule(eng)
        storage = held["storage"] + [_decode_storage(eng)]
        # the twin's route is the decode group's; with the groups' tp
        # apart (the reshard) no colocated engine runs the prefill group's
        # route, whose products differ in shape: there the prefix phase's
        # rule holds (equal, or parting at a near tie of dense logits)
        parted = [dict(d, req=i) for i, (r, w) in enumerate(
            zip(reqs, twin_reqs)) if (d := _ids_held(
                params, cfg, r.prompt, r.tokens, w.tokens)) is not None]
        resharded = "groups" in kw and kw["groups"][0] != kw["groups"][1]
        res = {"requests": len(reqs),
               "ids_equal_colocated": not parted or (resharded and all(
                   d["top2_gap"] < PREFIX_TIE for d in parted)),
               "parted": parted,
               "pages_bit_equal": all(held["pages"]),
               "inserts": len(held["pages"]),
               "storage_kept": all(s[:len(pools0)] == pools0
                                   and s == storage[-1]
                                   for s in storage),
               "tickets_zero": _tickets_zero(),
               "schedule": sched,
               "schedule_equal_cpu": sched == _handoff_schedule(cpu),
               "decode_traces": eng.decode.counters["decode_traces"],
               "prefill_traces": eng.prefill.counters["prefill_traces"]}
        fails = [k for k in ("ids_equal_colocated", "pages_bit_equal",
                             "storage_kept", "tickets_zero",
                             "schedule_equal_cpu") if not res[k]]
        fails += _groups_held(eng, name)
        if not all(r.done for r in reqs):
            fails.append("unfinished")
        if name == "preempt" and not sched["preemptions"]:
            fails.append("no preemption")
        if name in ("partial", "abort") and not sched["partial_handoffs"]:
            fails.append("no partial handoff")
        if name == "prefix_warm" and not sched["prefix_cache"]["hits"]:
            fails.append("no prefix hit")
        if sched["handoffs"] and sched["handoff_traces"] != 2:
            fails.append("handoff builds")
        res["failed"] = fails
        bad += [(name, f) for f in fails]
        out[name] = res
        del eng, twin, cpu
        gc.collect()
        torch.cuda.empty_cache()
    return out, bad


# tests/test_fleet.py's mixed-kind fleet at the parity size: a colocated
# replica with the host tier over an undersized pool, a colocated tp=2
# "gather" mesh (shards on the card) and a disaggregated replica, all with
# the prefix cache; each request's ids are held against the colocated
# engine on its replica's route
FLEET_PARITY = (("coloc_offload", dict(prefix_cache=True, kv_offload=True,
                                       num_blocks=14)),
                ("tp2_gather", dict(prefix_cache=True,
                                    groups=(2, 2, "gather"))),
                ("disagg", dict(prefix_cache=True, prefill_slots=1)))


def _fleet_replicas(params, cfg, device):
    reps = []
    for name, kw in FLEET_PARITY:
        kw = dict(kw, capacity=2)
        if name == "disagg":
            eng = _disagg_engine(params, cfg, device, kw)
        else:
            eng = _colocated_twin(params, cfg, device, kw)
        submit = eng.submit

        def tagged(*a, _submit=submit, _name=name, **k):
            r = _submit(*a, **k)
            r.replica = _name
            return r
        eng.submit = tagged
        reps.append((name, eng))
    return reps


def _fleet_schedule(fleet):
    m = fleet.metrics()
    rt = m["routing"]
    return {"routing": {k: rt[k] for k in ("warm", "cold", "diverted")},
            "per_replica": {n: {k: v[k] for k in ("routed", "warm_routed")}
                            for n, v in rt["per_replica"].items()},
            "offload_pages": {k: m["offload"][k] for k in (
                "spilled_pages", "restored_pages", "readopted_pages",
                "host_evicted_pages")},
            "requests_completed": m["requests_completed"]}


def _fleet_parity(params, cfg, cpu_params, cpu_cfg):
    """The mixed-kind fleet on both policies, its 30-request stream cold
    and, after reset_metrics, warm; ids against the colocated engine of
    each replica's route; the routing and offload schedule against the
    port's CPU run."""
    import torch
    from paddle_tpu_torch.inference import ServingFleet
    stream = _ds_mixed(n=30, sizes=(4, 15))
    refs = {route: [r.tokens for r in stream(_colocated_twin(
        params, cfg, "cuda:0", dict(kw, capacity=3)))]
        for route, kw in (("default", {}),
                          ("tp2_gather", dict(groups=(2, 2, "gather"))))}
    out, bad = {}, []
    for policy in ("prefix", "round_robin"):
        runs = {}
        for where, tree, c in (("cuda:0", params, cfg),
                               ("cpu", cpu_params, cpu_cfg)):
            fleet = ServingFleet(_fleet_replicas(tree, c, where),
                                 policy=policy)
            cold = stream(fleet)
            cold_sched = _fleet_schedule(fleet)
            fleet.reset_metrics()
            warm = stream(fleet)
            runs[where] = (fleet, cold, warm, cold_sched,
                           _fleet_schedule(fleet))
        fleet, cold, warm, cold_sched, warm_sched = runs["cuda:0"]
        torch.cuda.synchronize()
        # a warm request prefills a suffix where its reference prefilled
        # the whole prompt (the prefix phase's rule): equal ids, or parting
        # at a near tie of dense logits
        parted = []
        for run, reqs in (("cold", cold), ("warm", warm)):
            for i, r in enumerate(reqs):
                want = refs["tp2_gather" if r.replica == "tp2_gather"
                            else "default"][i]
                d = _ids_held(params, cfg, r.prompt, r.tokens, want)
                if d is not None:
                    parted.append(dict(d, run=run, req=i,
                                       replica=r.replica))
        m = fleet.metrics()
        res = {"cold": cold_sched, "warm": warm_sched,
               "schedule_equal_cpu": (cold_sched, warm_sched)
               == runs["cpu"][3:],
               "parted": parted, "tickets_zero": _tickets_zero(),
               "decode_traces": {
                   n: (e.decode if hasattr(e, "decode") else e).counters[
                       "decode_traces"] for n, e in
                   ((r.name, r.engine) for r in fleet._replicas)},
               "warm_hit_ratio": m["routing"]["warm_hit_ratio"]}
        fails = [k for k in ("schedule_equal_cpu", "tickets_zero")
                 if not res[k]]
        if any(p["top2_gap"] >= PREFIX_TIE for p in parted):
            fails.append("ids")
        if any(v != 1 for v in res["decode_traces"].values()):
            fails.append("decode captures")
        if not all(r.done for r in cold + warm):
            fails.append("unfinished")
        if policy == "prefix" and not warm_sched["routing"]["warm"]:
            fails.append("no warm route")
        res["failed"] = fails
        bad += [("fleet", policy, f) for f in fails]
        out[policy] = res
        del fleet, runs
        gc.collect()
        torch.cuda.empty_cache()
    return out, bad


def _timed_handoff(eng, acc):
    """CUDA events around each transfer's extract and insert (no sync):
    ``acc`` collects (pages, extract events, insert events)."""
    import torch
    extract, insert = eng._extract, eng._insert

    def timed(fn, key):
        def run(*a):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a)
            ev[1].record()
            acc[key].append((len(a[0]), ev))
            return out
        return run
    eng._extract = timed(extract, "extract")
    eng._insert = timed(insert, "insert")


def _serve_turn(params, cfg, kind, prompts, gen):
    """One turn of the serving size: the serving phase's requests through
    the disaggregated engine or the colocated default engine."""
    import torch
    from paddle_tpu_torch.inference import DisaggregatedEngine, ServingEngine
    from paddle_tpu_torch.ops import kernels
    L = cfg.num_hidden_layers
    kw = dict(capacity=8, block_size=16, max_seq_len=1024,
              prefill_buckets=(32, 128))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if kind == "disagg":
        eng = DisaggregatedEngine(params, cfg, prefill_slots=2, **kw)
        acc = {"extract": [], "insert": []}
        _timed_handoff(eng, acc)
    else:
        eng = ServingEngine(params, cfg, **kw)
    kernels.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, gen) for p in prompts]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    m = eng.metrics()
    row = {"wall_s": round(wall, 3), "tokens_per_sec": m["tokens_per_sec"],
           "ttft_ms_mean": m["ttft_ms_mean"], "ttft_ms_max": m["ttft_ms_max"],
           "peak_memory_gb": round(torch.cuda.max_memory_allocated()
                                   / 2 ** 30, 3),
           "launches": {k: v for k, v in counts.items() if v}}
    bad = []
    if kind == "disagg":
        pre, dec = m["groups"]["prefill"], m["groups"]["decode"]
        chunks, steps = pre["prefill_chunks"], dec["decode_steps"]
        ms = [sum(ev[0].elapsed_time(ev[1]) for _, ev in pair)
              for pair in zip(acc["extract"], acc["insert"])]
        nbytes = m["kv_bytes_transferred"]
        row.update({
            "decode_step_ms_mean": dec["decode_step_ms_mean"],
            "handoffs": m["handoffs"],
            "partial_handoffs": m["partial_handoffs"],
            "kv_bytes_transferred": nbytes,
            "pages_moved": nbytes // eng.prefill._page_nbytes,
            "handoff_ms_mean": m["handoff_ms_mean"],
            "handoff_ms_max": m["handoff_ms_max"],
            "handoff_device_ms_total": round(sum(ms), 4),
            "handoff_device_ms_max": round(max(ms), 4) if ms else None,
            "handoff_gb_per_s": (round(nbytes / (sum(ms) * 1e-3) / 1e9, 3)
                                 if ms else None),
            # the least time: each moved page read and written by the
            # extract and again by the insert, at 3.35 TB/s
            "handoff_bound_ms": round(4 * nbytes / 3.35e12 * 1e3, 4),
            "prefill_chunks": chunks, "decode_steps": steps,
            "decode_traces": dec["decode_traces"],
            "prefill_traces": pre["prefill_traces"],
            "decode_variant": dec["decode_variant"],
            "prefill_variant": pre["prefill_variant"]})
        bad += [("serving", f) for f in _groups_held(eng, "serving")]
    else:
        chunks, steps = m["prefill_chunks"], m["decode_steps"]
        row.update({"decode_step_ms_mean": m["decode_step_ms_mean"],
                    "prefill_chunks": chunks, "decode_steps": steps})
    want = {"prefill_attn_block": L * chunks, "decode_mlp_block": L * chunks,
            "decode_block_fused": L * steps, "decode_attn_block": 0,
            "paged_attention_decode": 0, "rms_norm_fwd": steps + chunks}
    if {k: counts[k] for k in want} != want:
        bad.append(("serving", kind, "launches", counts, want))
    for r in reqs:
        if not (r.done and len(r.tokens) == gen.max_new_tokens
                and all(0 <= t < cfg.vocab_size for t in r.tokens)):
            bad.append(("serving", kind, "request", r.req_id))
    return row, [r.tokens for r in reqs], bad


def _common_prefix(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


# bench.py serving_fleet's traffic shape at LLaMA-7B: two prefix-cached
# replicas with the host tier over bench's undersized pool, 24 requests,
# each one of 4 templates of 224 tokens picked Zipf(1.2) plus 32 tokens of
# its own, 64 new
FLEET_SERVE = {"replicas": 2, "capacity": 4, "requests": 24,
               "templates": 4, "template_tokens": 224, "tail": 32,
               "new": 64, "zipf_a": 1.2}


def _fleet_serving(params, cfg):
    """Both policies over the same prompts, and one colocated engine."""
    import torch
    from paddle_tpu_torch.inference import ServingEngine, ServingFleet
    S = FLEET_SERVE
    rng = np.random.RandomState(0)
    V = cfg.vocab_size
    templates = [rng.randint(0, V, S["template_tokens"])
                 for _ in range(S["templates"])]
    picks = np.minimum(rng.zipf(S["zipf_a"], S["requests"]) - 1,
                       S["templates"] - 1)
    prompts = [np.concatenate([templates[int(k)], rng.randint(0, V,
                                                              S["tail"])])
               .astype(np.int32) for k in picks]
    warm_tail = rng.randint(0, V, S["tail"])
    ctx = S["template_tokens"] + S["tail"]
    req_pages = -(-(ctx + S["new"]) // 16)
    kw = dict(block_size=16, max_seq_len=ctx + S["new"],
              prefill_buckets=(32, 128))
    gen = _pgen(S["new"])
    out, ids, bad = {}, {}, []
    for policy in ("prefix", "round_robin"):
        reps = []
        for _ in range(S["replicas"]):
            eng = ServingEngine(
                params, cfg, capacity=S["capacity"], prefix_cache=True,
                kv_offload=True,
                num_blocks=(S["capacity"] + 1) * req_pages
                + req_pages // 2 + 1, **kw)
            # bench's warm-up: both buckets run (and are captured) outside
            # the window
            eng.submit(prompts[0], _pgen(2))
            eng.drain()
            eng.submit(np.concatenate([prompts[0][:S["template_tokens"]],
                                       warm_tail]).astype(np.int32),
                       _pgen(2))
            eng.drain()
            reps.append(eng)
        fleet = ServingFleet(reps, policy=policy)
        fleet.reset_metrics()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = []
        for i, p in enumerate(prompts):
            reqs.append(fleet.submit(p, gen))
            if i % 3 == 2:
                fleet.step()
        fleet.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = fleet.metrics()
        ids[policy] = [r.tokens for r in reqs]
        out[policy] = {
            "wall_s": round(wall, 3), "tokens_per_sec": m["tokens_per_sec"],
            "ttft_ms_mean": m["ttft_ms_mean"],
            "ttft_ms_max": m["ttft_ms_max"],
            "warm_hit_ratio": m["routing"]["warm_hit_ratio"],
            "routing": {k: m["routing"][k] for k in ("warm", "cold",
                                                     "diverted")},
            "tokens_skipped": sum(r["prefix_cache"]["tokens_skipped"]
                                  for r in m["replicas"].values()),
            "prefill_tokens": sum(r["prefill_tokens"]
                                  for r in m["replicas"].values()),
            "offload": m["offload"],
            "decode_step_ms_mean": [r["decode_step_ms_mean"]
                                    for r in m["replicas"].values()]}
        if not all(r.done and len(r.tokens) == S["new"] for r in reqs):
            bad.append(("fleet serving", policy, "unfinished"))
        del fleet, reps
        gc.collect()
        torch.cuda.empty_cache()
    eng = ServingEngine(params, cfg, capacity=8, **kw)
    reqs = [eng.submit(p, gen) for p in prompts]
    eng.drain()
    ids["colocated"] = [r.tokens for r in reqs]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    for a, b in (("prefix", "round_robin"), ("prefix", "colocated"),
                 ("round_robin", "colocated")):
        cp = [_common_prefix(x, y) for x, y in zip(ids[a], ids[b])]
        out[f"{a}_vs_{b}_common_prefix"] = cp
        if any(c != S["new"] for c in cp):
            bad.append(("fleet serving", f"{a} ids != {b}"))
    return dict(out, stream=S, templates_picked=[int(k) for k in picks]), \
        bad


def disagg_phase(gpu, size, params=None):
    """Disaggregated prefill/decode serving and the fleet router on the
    card. Returns the launch counts of its serving-size disaggregated run
    (empty at the parity size).

    ``size`` "parity": LLaMA-7B widths, 2 layers, f32, both groups on
    cuda:0, decode steps and chunks captured: the streams of
    tests/test_disagg.py at block 16 (DISAGG_STREAMS: the 22-request mixed
    stream, the prefix cache's warm path, int8 pools, colocated tp=2 groups
    under "psum" and "gather", prefill tp 1 into decode tp 2, partial
    windows, the abort marker, preemption on the decode group, a one-token
    budget), each held to: ids equal to the colocated engine on the same
    route (bit for bit in f32), every handed-off page equal to its prefill
    page bit for bit right after its insert lands, the decode group's pools
    and scales never rebound, the decode group one decode capture and no
    chunk, the prefill group no decode step and at most one chunk capture a
    bucket, the ring's tickets zero, and the schedule (handoffs, pages
    moved, steps, preemptions, prefix hits) equal to the port's CPU run.
    Then tests/test_fleet.py's mixed-kind fleet (a colocated replica with
    the host tier, a colocated tp=2 "gather" mesh, a disaggregated
    replica) on the "prefix" and "round_robin" policies: ids against the
    colocated engine on each replica's route, the routing and offload
    schedule against the CPU run.

    ``size`` "serving": LLaMA-7B (32 layers, ``params``, bf16): the serving
    phase's 12 requests through ``DisaggregatedEngine(capacity=8,
    prefill_slots=2, block_size=16, max_seq_len=1024, prefill_buckets=(32,
    128))`` on the default routes, in turns with the colocated default
    engine (disaggregated, colocated, disaggregated, colocated): tokens/s,
    TTFT, the decode group's step ms, handoffs, partial handoffs, bytes
    moved, the handoff's host ms (issue to landed insert) and device ms
    (CUDA events around extract and insert) and GB/s, peak memory; launch
    counts (prefill_attn_block and decode_mlp_block L a chunk,
    decode_block_fused L a step, RMSNorm once a chunk and a step), the
    bf16 ids' common prefix with the colocated engine's. Then bench.py
    serving_fleet's traffic shape (FLEET_SERVE) on both policies and one
    colocated engine: warm-hit ratio, tokens skipped, tokens/s, TTFT; ids
    equal across the three."""
    import dataclasses
    import torch
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    from paddle_tpu_torch.models import llama as tl
    t0 = time.perf_counter()
    if size == "parity":
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = dataclasses.replace(LLAMA_7B, num_hidden_layers=2,
                                  dtype=torch.float32)
        params = init_params(cfg, seed=1)
        # tests/test_disagg.py's model, for the CPU run of the schedule
        cpu_cfg = tl.LlamaConfig(vocab_size=DISAGG_V, hidden_size=64,
                                 intermediate_size=128, num_hidden_layers=2,
                                 num_attention_heads=4, num_key_value_heads=4,
                                 max_position_embeddings=512,
                                 dtype=torch.float32)
        cpu_params = init_params(cpu_cfg, seed=0, device="cpu")
        streams, bad = _disagg_parity(params, cfg, cpu_params, cpu_cfg)
        fleet, b = _fleet_parity(params, cfg, cpu_params, cpu_cfg)
        bad += b
        emit({"phase": "disagg", "size": size, "gpu": gpu,
              "dtype": "float32", "layers": 2, "streams": streams,
              "fleet": fleet, "failed": [list(map(str, x)) for x in bad],
              "seconds": round(time.perf_counter() - t0, 1)})
        del params
        gc.collect()
        torch.cuda.empty_cache()
        if bad:
            raise AssertionError(f"disagg phase (parity): {bad}")
        return {}
    from paddle_tpu_torch.ops import kernels
    cfg = LLAMA_7B
    rng = np.random.default_rng(0)
    lens = rng.integers(40, 601, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    gen = _pgen(SERVE_NEW)
    turns, ids, bad = [], {}, []
    disagg_counts = None
    for kind in ("disagg", "colocated", "disagg", "colocated"):
        row, toks, b = _serve_turn(params, cfg, kind, prompts, gen)
        bad += b
        if kind in ids and ids[kind] != toks:
            bad.append(("serving", kind, "ids differ between turns"))
        ids.setdefault(kind, toks)
        if kind == "disagg" and disagg_counts is None:
            disagg_counts = dict(kernels.launches())
        turns.append(dict(row, kind=kind))
        gc.collect()
        torch.cuda.empty_cache()
    common = [_common_prefix(a, b) for a, b in zip(ids["disagg"],
                                                   ids["colocated"])]
    fleet, b = _fleet_serving(params, cfg)
    bad += b
    emit({"phase": "disagg", "size": size, "gpu": gpu, "model": "LLAMA_7B",
          "layers": cfg.num_hidden_layers, "dtype": "bfloat16",
          "requests": len(prompts), "prompt_tokens": [int(n) for n in lens],
          "new_tokens": SERVE_NEW, "turns": turns,
          "disagg_vs_colocated_common_prefix": common,
          "requests_equal": sum(c == SERVE_NEW for c in common),
          "fleet": fleet, "failed": [list(map(str, x)) for x in bad],
          "seconds": round(time.perf_counter() - t0, 1)})
    if bad:
        raise AssertionError(f"disagg phase (serving): {bad}")
    return disagg_counts


def disagg_only(gpu):
    """``python3 chip_smoke.py disagg``: the build and the disagg phase
    alone, both sizes (the serving size over the serving phases' seeded
    tree)."""
    import torch
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    build_kernels()
    disagg_phase(gpu, "parity")
    disagg_phase(gpu, "serving", init_params(LLAMA_7B, seed=0))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# ---------------------------------------------------------------------------
# the observability and telemetry harness (paddle_tpu_torch/observability/,
# profiler/, distributed/flight_recorder.py) on the serving engines and the
# trainer
# ---------------------------------------------------------------------------
# the parity size's engine (2 layers, f32) and the CPU twin's model
OBS_KW = dict(capacity=2, block_size=16, prefill_buckets=(16, 32),
              max_seq_len=128)
# the serving size's engine: the serving phase's
OBS_SERVE_KW = dict(capacity=8, block_size=16, max_seq_len=1024,
                    prefill_buckets=(32, 128))
# the metrics() keys the harness adds (tests/test_observability.py)
OBS_KEYS = {"latency", "gauges", "retrace_warnings", "stall_dumps",
            "timeline_events", "timeline_dropped"}
OBS_TRAIN_KEYS = {"latency", "gauges", "compile", "compiles",
                  "retrace_warnings", "mfu", "hbm", "host_gap_findings",
                  "stall_dumps", "timeline_events", "timeline_dropped"}


def _trace_summary():
    """tools/trace_summary.py, imported from the checkout."""
    import importlib
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    try:
        return importlib.import_module("trace_summary")
    finally:
        sys.path.pop(0)


def _obs_exports(eng, tmp, name, mode="serving"):
    """``eng``'s Chrome trace and JSONL, read back: the trace's request
    rows and ``roofline:`` tracks, and tools/trace_summary.py over the
    JSONL (its summary rendered). Returns (row, failures)."""
    ts = _trace_summary()
    trace_p = f"{tmp}/{name}.trace.json"
    jsonl_p = f"{tmp}/{name}.jsonl"
    eng.export_trace(trace_p)
    eng.write_timeline(jsonl_p)
    with open(trace_p) as f:
        evs = json.load(f)["traceEvents"]
    spans = {e["name"] for e in evs if e.get("ph") == "X"}
    meta, events, requests = ts.load(jsonl_p)
    if mode == "train":
        text = ts.render_train(ts.summarize_train(meta, events, top=3))
    else:
        text = ts.render(ts.summarize(meta, events, requests, top=3))
    row = {"trace_events": len(evs),
           "request_rows": sum(n.startswith("req") for n in spans),
           "roofline_tracks": sorted(e["name"] for e in evs
                                     if e.get("ph") == "C" and
                                     e["name"].startswith("roofline:")),
           "jsonl_events": len(events), "jsonl_requests": len(requests),
           "summary_chars": len(text)}
    bad = []
    if mode == "serving" and not row["request_rows"]:
        bad.append((name, "no request rows in the trace"))
    if mode != "train" and not row["roofline_tracks"]:
        bad.append((name, "no roofline track in the trace"))
    if not events:
        bad.append((name, "empty JSONL"))
    return row, bad


def _obs_timeline(eng):
    return [(e.name, e.req_id) for e in eng.observability.timeline.events()]


def _obs_stream(eng, prompts, gen):
    reqs = [eng.submit(p, gen) for p in prompts]
    eng.drain()
    return reqs


def _obs_parity(gpu):
    """The parity size: LLaMA-7B widths, 2 layers, f32, on cuda:0, beside
    the port's CPU run of tests/test_observability.py's model on the same
    stream (the schedule: events, counters and key sets hold across
    them)."""
    import dataclasses
    import tempfile
    import warnings
    import torch
    from paddle_tpu_torch.inference import (DisaggregatedEngine,
                                            ServingEngine, ServingFleet,
                                            ServingMesh, generate_paged)
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.observability import Observability
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(LLAMA_7B, num_hidden_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, seed=1)
    cpu_cfg = tl.LlamaConfig(vocab_size=97, hidden_size=64,
                             intermediate_size=128, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2,
                             max_position_embeddings=128,
                             dtype=torch.float32)
    cpu_params = init_params(cpu_cfg, seed=0, device="cpu")
    rng = np.random.RandomState(14)
    prompts = [rng.randint(0, 97, (int(s),)).astype(np.int32)
               for s in rng.randint(3, 40, 8)]
    gen = _pgen(6)
    tmp = tempfile.mkdtemp(prefix="obs_parity_")
    res, bad = {}, []

    def engine(p, c, device, **kw):
        return ServingEngine(p, c, device=device, **dict(OBS_KW, **kw))

    # the observed engine against the plain one and the CPU twin
    obs = engine(params, cfg, None, observability=True)
    obs_reqs = _obs_stream(obs, prompts, gen)
    plain = engine(params, cfg, None)
    plain_reqs = _obs_stream(plain, prompts, gen)
    cpu = engine(cpu_params, cpu_cfg, "cpu", observability=True)
    _obs_stream(cpu, prompts, gen)
    m, mc, mp = obs.metrics(), cpu.metrics(), plain.metrics()
    sched = ("decode_steps", "prefill_chunks", "prefill_tokens",
             "tokens_generated", "requests_completed")
    res["engine"] = {
        "ids_equal": [r.tokens for r in obs_reqs]
        == [r.tokens for r in plain_reqs],
        "keys_equal_cpu": set(m) == set(mc),
        "obs_keys": set(m) - set(mp) == OBS_KEYS,
        "latency_keys_equal_cpu": set(m["latency"]) == set(mc["latency"]),
        "timeline_equal_cpu": _obs_timeline(obs) == _obs_timeline(cpu),
        "counters_equal_cpu": all(m[k] == mc[k] for k in sched),
        "timeline_events": m["timeline_events"],
        "decode_step_ms": m["latency"]["decode_step_ms"],
        "decode_step_ms_mean": m["decode_step_ms_mean"]}
    exp, b = _obs_exports(obs, tmp, "engine")
    res["engine"]["exports"] = exp
    bad += b + [("engine", k) for k in ("ids_equal", "keys_equal_cpu",
                                        "obs_keys",
                                        "latency_keys_equal_cpu",
                                        "timeline_equal_cpu",
                                        "counters_equal_cpu")
                if not res["engine"][k]]
    del obs, plain, cpu
    # the watchdog: every bucket warmed (a bucket is captured at its
    # second use), armed by reset_metrics, silent on warmed traffic; a
    # bucket first seen after the reset fires once, at its capture
    eng = engine(params, cfg, None, observability=True)
    for s in (10, 10, 25, 25):
        _obs_stream(eng, [prompts[0][:1].repeat(s)], _pgen(3))
    eng.reset_metrics()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        _obs_stream(eng, prompts[:4], gen)
        warmed = eng.metrics()["retrace_warnings"]
    eng2 = engine(params, cfg, None, observability=True)
    for s in (10, 10):
        _obs_stream(eng2, [prompts[0][:1].repeat(s)], _pgen(3))
    eng2.reset_metrics()
    with warnings.catch_warnings(record=True) as caught2:
        warnings.simplefilter("always", RuntimeWarning)
        for _ in range(2):
            _obs_stream(eng2, [prompts[1][:1].repeat(25)], _pgen(3))
    forced = eng2.metrics()["retrace_warnings"]
    res["watchdog"] = {"warmed": warmed, "forced": forced,
                       "events": eng2.observability.watchdog.events,
                       "warned": len(caught) + len(caught2)}
    if warmed != 0 or forced != 1 or \
            eng2.observability.watchdog.events[0]["program"] != "prefill[32]":
        bad.append(("watchdog", res["watchdog"]))
    del eng, eng2
    # stall dumps: a blown step deadline, and a drain starved by pages
    # held hostage (tests/test_observability.py's)
    dl = f"{tmp}/deadline.json"
    eng = engine(params, cfg, None, observability=Observability(
        step_deadline_s=0.0, stall_dump_path=dl))
    eng.submit(prompts[0], _pgen(2))
    eng.step()
    st = f"{tmp}/starved.json"
    eng2 = engine(params, cfg, None, num_blocks=10,
                  observability=Observability(stall_dump_path=st))
    eng2.mgr.allocate(999, 7 * 16)
    eng2.submit(rng.randint(0, 97, (20,)).astype(np.int32), _pgen(60))
    try:
        eng2.drain()
        starved = "no error"
    except RuntimeError as e:
        starved = str(e)
    res["stall"] = {"deadline_dump": _json_file(dl).get("reason"),
                    "starved_error": starved,
                    "starved_dump": _json_file(st).get("reason")}
    if not (res["stall"]["deadline_dump"] or "").count("deadline"):
        bad.append(("stall", "no deadline dump"))
    if st not in starved or not res["stall"]["starved_dump"]:
        bad.append(("stall", "no starved-drain dump"))
    del eng, eng2
    # a colocated tp=2 mesh: the flight recorder's collectives
    eng = engine(params, cfg, None, observability=True,
                 mesh=ServingMesh.make(2, collective="psum",
                                       devices=["cuda:0"] * 2))
    _obs_stream(eng, prompts[:3], gen)
    coll = eng.metrics().get("collectives", {})
    res["mesh"] = {"collectives_calls": coll.get("calls"),
                   "collectives_bytes": coll.get("bytes")}
    if not (coll.get("calls") or {}).get("psum@tp"):
        bad.append(("mesh", "no psum collectives recorded"))
    del eng
    # generate_paged, observed against plain
    ids = rng.randint(0, 97, (2, 12)).astype(np.int32)
    o = Observability()
    a = generate_paged(params, ids, cfg, _pgen(40), block_size=16,
                       observability=o)
    b = generate_paged(params, ids, cfg, _pgen(40), block_size=16)
    names = [e.name for e in o.timeline.events()]
    res["generate_paged"] = {"ids_equal": bool(torch.equal(a, b)),
                             "events": names,
                             "decode_step_ms":
                                 o.latency_snapshot()["decode_step_ms"]}
    if not torch.equal(a, b) or "decode_step" not in names:
        bad.append(("generate_paged", names))
    # the disaggregated engine: one shared timeline with handoff events
    dis = DisaggregatedEngine(params, cfg, capacity=2, prefill_slots=1,
                              block_size=16, prefill_buckets=(16, 32),
                              max_seq_len=128, observability=True)
    dis_reqs = _obs_stream(dis, prompts, gen)
    names = [e.name for e in dis.observability.timeline.events()]
    dm = dis.metrics()
    res["disagg"] = {"ids_equal_colocated": [r.tokens for r in dis_reqs]
                     == [r.tokens for r in plain_reqs],
                     "handoff_events": names.count("handoff"),
                     "handoff_ms": dm["latency"]["handoff_ms"],
                     "collectives_calls": dm["collectives"]["calls"],
                     "shared_timeline": dis.prefill.observability.timeline
                     is dis.decode.observability.timeline
                     is dis.observability.timeline}
    exp, b = _obs_exports(dis, tmp, "disagg")
    res["disagg"]["exports"] = exp
    bad += b
    if not (res["disagg"]["ids_equal_colocated"]
            and res["disagg"]["handoff_events"]
            and res["disagg"]["shared_timeline"]):
        bad.append(("disagg", res["disagg"]))
    del dis
    # the fleet: route events, the exports
    fleet = ServingFleet([engine(params, cfg, None, prefix_cache=True,
                                 observability=True),
                          engine(params, cfg, None)], observability=True)
    fl_reqs = _obs_stream(fleet, prompts, gen)
    names = [e.name for e in fleet.observability.timeline.events()]
    res["fleet"] = {"ids_equal_colocated": [r.tokens for r in fl_reqs]
                    == [r.tokens for r in plain_reqs],
                    "route_events": names.count("route")}
    exp, b = _obs_exports(fleet, tmp, "fleet", mode="fleet")
    res["fleet"]["exports"] = exp
    bad += b
    if not (res["fleet"]["ids_equal_colocated"]
            and res["fleet"]["route_events"] == len(prompts)):
        bad.append(("fleet", res["fleet"]))
    del fleet
    gc.collect()
    torch.cuda.empty_cache()
    return res, bad


def _json_file(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _obs_serving(gpu, params):
    """The serving size: LLaMA-7B (``params``, bf16), the serving phase's
    12 requests on the default route, observed (observability and
    telemetry) and plain in turns: observed, plain, observed, plain; each
    engine warms both buckets and the decode step (each captured at its
    second use) and resets its metrics first."""
    import tempfile
    import warnings
    import torch
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models import LLAMA_7B
    from paddle_tpu_torch.observability import (Observability,
                                                lint_exposition)
    from paddle_tpu_torch.ops import kernels
    cfg = LLAMA_7B
    L = cfg.num_hidden_layers
    rng = np.random.default_rng(0)
    lens = rng.integers(40, 601, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    warm = [np.full(n, 7, np.int32) for n in (20, 20, 100, 100)]
    gen = _pgen(SERVE_NEW)
    tmp = tempfile.mkdtemp(prefix="obs_serving_")
    turns, ids, bad, obs_counts = [], {}, [], None
    for kind in ("observed", "plain", "observed", "plain"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        kw = (dict(observability=True, telemetry=True)
              if kind == "observed" else {})
        eng = ServingEngine(params, cfg, **OBS_SERVE_KW, **kw)
        for p in warm:
            _obs_stream(eng, [p], _pgen(2))
        eng.reset_metrics()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", RuntimeWarning)
            reqs = _obs_stream(eng, prompts, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        host = []
        for _ in range(5):
            t = time.perf_counter()
            m = eng.metrics()
            host.append((time.perf_counter() - t) * 1e3)
        steps, chunks = m["decode_steps"], m["prefill_chunks"]
        row = {"kind": kind, "wall_s": round(wall, 3),
               "tokens_per_sec": m["tokens_per_sec"],
               "ttft_ms_mean": m["ttft_ms_mean"],
               "ttft_ms_max": m["ttft_ms_max"],
               "decode_step_ms_mean": m["decode_step_ms_mean"],
               "decode_steps": steps, "prefill_chunks": chunks,
               "metrics_host_ms": [round(x, 3) for x in host]}
        want = {"prefill_attn_block": L * chunks,
                "decode_mlp_block": L * chunks,
                "decode_block_fused": L * steps, "decode_attn_block": 0,
                "paged_attention_decode": 0, "rms_norm_fwd": steps + chunks}
        if {k: counts[k] for k in want} != want:
            bad.append(("serving", kind, "launches", counts, want))
        if kind == "observed":
            lat = m["latency"]
            tel = eng.telemetry
            expo = tel.expose()
            row.update({
                "decode_step_ms": lat["decode_step_ms"],
                "prefill_chunk_ms": lat["prefill_chunk_ms"],
                "step_ms": lat["step_ms"], "ttft_ms": lat["ttft_ms"],
                "tpot_ms": lat["tpot_ms"],
                "retrace_warnings": m["retrace_warnings"],
                "runtime_warnings": [str(w.message)[:80] for w in caught],
                "telemetry": m["telemetry"],
                "alerts": [dict(a) for a in tel.alerts],
                "exposition_lint": lint_exposition(expo),
                "exposition_lines": expo.count("\n"),
                "keys_ok": OBS_KEYS | {"telemetry"} <= set(m)})
            exp, b = _obs_exports(eng, tmp, f"serving{len(turns)}")
            row["exports"] = exp
            bad += b
            if m["retrace_warnings"] or caught:
                bad.append(("serving", "retrace after warm-up",
                            m["retrace_warnings"]))
            if row["exposition_lint"] or \
                    m["telemetry"]["alerts"] != {"page": 0, "ticket": 0}:
                bad.append(("serving", "telemetry",
                            row["exposition_lint"][:3],
                            m["telemetry"]["alerts"]))
            if not row["keys_ok"]:
                bad.append(("serving", "metrics keys", sorted(m)))
            if obs_counts is None:
                obs_counts = dict(counts)
        toks = [r.tokens for r in reqs]
        if not all(r.done and len(r.tokens) == SERVE_NEW for r in reqs):
            bad.append(("serving", kind, "unfinished"))
        ids.setdefault(kind, toks)
        if ids[kind] != toks:
            bad.append(("serving", kind, "ids differ between turns"))
        turns.append(row)
        del eng
        gc.collect()
    if ids["observed"] != ids["plain"]:
        bad.append(("serving", "observed ids != plain ids"))
    tps = {k: [t["tokens_per_sec"] for t in turns if t["kind"] == k]
           for k in ("observed", "plain")}
    ratio = float(np.mean(tps["observed"]) / np.mean(tps["plain"]))
    # one bucket first seen after the reset (128: only 32 was warmed)
    # fires the watchdog once, at its capture; then a step past a 0 s
    # deadline writes a stall dump
    dump = f"{tmp}/deadline.json"
    obs = Observability(stall_dump_path=dump)
    eng = ServingEngine(params, cfg, observability=obs, **OBS_SERVE_KW)
    for p in warm[:2]:
        _obs_stream(eng, [p], _pgen(2))
    eng.reset_metrics()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        for p in warm[2:]:
            _obs_stream(eng, [p], _pgen(2))
    forced = {"retrace_warnings": eng.metrics()["retrace_warnings"],
              "events": obs.watchdog.events, "warned": len(caught)}
    if forced["retrace_warnings"] != 1 or \
            obs.watchdog.events[0]["program"] != "prefill[128]":
        bad.append(("serving", "forced bucket", forced))
    obs.step_deadline_s = 0.0
    eng.submit(warm[0], _pgen(2))
    eng.step()
    forced["deadline_dump"] = _json_file(dump).get("reason")
    if not forced["deadline_dump"]:
        bad.append(("serving", "no deadline dump"))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return ({"requests": len(prompts), "new_tokens": SERVE_NEW,
             "turns": turns, "tokens_per_sec_ratio": round(ratio, 4),
             "forced": forced,
             "ids_equal": ids["observed"] == ids["plain"]},
            obs_counts, bad)


def _obs_train(gpu):
    """The 1.07B-h4096 rung on the default route, observed and plain in
    turns (observed, plain, observed, plain), each warmed one step and
    reset, then TRAIN_STEPS steps; then the Profiler with the GPU target
    over 3 steps of the last turn's trainer."""
    import tempfile
    import torch
    from paddle_tpu_torch.distributed import Trainer
    from paddle_tpu_torch.distributed.trainer import tree_leaves
    from paddle_tpu_torch.models import init_params, llama
    from paddle_tpu_torch.observability import live_hbm_bytes
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.profiler import Profiler, ProfilerTarget
    cfg = train_config(fused_train=None)
    L, B, S = cfg.num_hidden_layers, TRAIN_RUNG["batch"], TRAIN_RUNG["seq"]
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           device="cuda")
    labels = torch.roll(toks, -1, -1)
    turns, losses, bad, obs_counts = [], {}, [], None
    tr = state = None
    for kind in ("observed", "plain", "observed", "plain"):
        del tr, state
        gc.collect()
        torch.cuda.empty_cache()
        params = init_params(cfg, seed=0)
        n_params = sum(v.numel() for v in tree_leaves(params))
        tr = Trainer(lambda p, t, l: llama.loss_fn(p, t, l, cfg), lr=1e-4,
                     moment_dtype=torch.bfloat16,
                     observability=kind == "observed")
        state = tr.init_state(params)
        del params
        state, m = tr.step(state, toks, labels)          # warm-up
        run = [float(m["loss"])]
        tr.reset_metrics()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        step_losses = []
        for _ in range(TRAIN_STEPS):
            state, m = tr.step(state, toks, labels)
            step_losses.append(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        run += [float(x) for x in step_losses]
        tps = B * S * TRAIN_STEPS / wall
        formula_flops = (6 * n_params + 6 * L * S * cfg.hidden_size) * B * S
        row = {"kind": kind, "wall_ms_per_step":
               round(wall * 1e3 / TRAIN_STEPS, 3),
               "tokens_per_sec": round(tps, 1),
               "mfu_formula": round(tps / (B * S) * formula_flops / 989e12,
                                    4)}
        if kind == "observed":
            mm = tr.metrics()
            lat = mm["latency"]
            comp = mm["compile"]["programs"].get("train_step", {})
            counted = (mm["mfu"] or {}).get("flops_per_step_per_device")
            row.update({
                "phases_ms": {k: {"p50": lat[k]["p50"], "mean": lat[k]["mean"]}
                              for k in ("step_ms", "stage_ms", "dispatch_ms",
                                        "sync_ms")},
                "host_gap_findings": mm["host_gap_findings"],
                "compile": mm["compile"], "hbm": mm["hbm"],
                "mfu": mm["mfu"],
                "counted_over_formula_flops": (round(counted / formula_flops, 4)
                                               if counted else None),
                "hbm_bytes_in_use": mm["gauges"].get(
                    "hbm_bytes_in_use", {}).get("last"),
                "live_hbm_bytes": live_hbm_bytes("cuda"),
                "keys_ok": set(mm) >= OBS_TRAIN_KEYS,
                "retrace_warnings": mm["retrace_warnings"]})
            num = (row["hbm_bytes_in_use"], (mm["mfu"] or {}).get("mfu"),
                   (mm["hbm"] or {}).get("temp_bytes"),
                   (mm["hbm"] or {}).get("argument_bytes"),
                   comp.get("cost", {}).get("flops"))
            if not all(isinstance(x, (int, float)) and x > 0 for x in num):
                bad.append(("train", "hbm/mfu/memory not numbers", num))
            if mm["host_gap_findings"] or mm["retrace_warnings"] or \
                    not row["keys_ok"]:
                bad.append(("train", "findings", mm["host_gap_findings"],
                            mm["retrace_warnings"], sorted(mm)))
            if obs_counts is None:
                obs_counts = dict(counts)
        losses.setdefault(kind, run)
        row["losses"] = run
        if run != losses[kind]:
            bad.append(("train", kind, "losses differ between turns"))
        turns.append(row)
    if losses["observed"] != losses["plain"]:
        bad.append(("train", "observed loss != plain loss"))
    # the profiler with the GPU target over 3 steps of the last trainer
    tmp = tempfile.mkdtemp(prefix="obs_profile_")
    with Profiler(targets=[ProfilerTarget.CPU, ProfilerTarget.GPU],
                  trace_dir=tmp) as prof:
        for _ in range(3):
            state, m = tr.step(state, toks, labels)
            prof.step()
    names = set()
    if prof.device_trace_path is None:
        bad.append(("profiler", "no device trace written"))
    else:
        with open(prof.device_trace_path) as f:
            evs = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in evs if e.get("cat") == "kernel"}
    groups = sorted({g for g in map(_kernel_group, names) if g})
    want = {"flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv", "fused_adamw", "rms_norm_fwd",
            "residual_rms_norm_fwd", "rms_norm_bwd", "swiglu_fwd",
            "swiglu_bwd", "linear_ce_fwd", "linear_ce_bwd_dx",
            "linear_ce_bwd_dh"}
    profiled = {"trace_kernels": len(names), "groups": groups,
                "steps": prof.step_num}
    if not want <= set(groups):
        bad.append(("profiler", "kernels missing",
                    sorted(want - set(groups))))
    del tr, state
    gc.collect()
    torch.cuda.empty_cache()
    return ({"rung": TRAIN_RUNG["label"], "steps": TRAIN_STEPS,
             "turns": turns, "profiler": profiled,
             "losses_equal": losses["observed"] == losses["plain"]},
            obs_counts, bad)


def obs_phase(gpu, size, params=None):
    """The observability and telemetry harness on the card. Returns the
    launch counts of its observed runs at the serving size (empty at the
    parity size): {"serving": ..., "train": ...}.

    ``size`` "parity": LLaMA-7B widths, 2 layers, f32, on cuda:0, the
    port's CPU run beside: an observed engine (8 requests) against the
    plain one (ids equal) and the CPU twin (the same metrics() and
    latency key sets, the same timeline events and request ids in order,
    the same schedule counters); its Chrome trace (request rows, the
    ``roofline:`` track) and JSONL (read by tools/trace_summary.py); the
    retrace watchdog silent on traffic over warmed buckets (each bucket
    captured at its second use) and firing once when a bucket first seen
    after the reset is captured; a stall dump on a blown step deadline
    and on a drain starved by pages held hostage; a colocated tp=2 mesh's
    flight recorder (psum calls and bytes); ``generate_paged`` observed
    (ids equal); the disaggregated engine (one timeline shared by both
    groups, handoff events, its exports; ids equal to the colocated
    engine's) and the fleet (route events, its exports).

    ``size`` "serving": the serving phase's 12 requests through
    ``ServingEngine(..., observability=True, telemetry=True)`` on the
    default route (decode steps and chunks captured) in turns with the
    plain engine: ids equal, the enabled key set, 0 retrace warnings after
    the warmed reset, the exposition lint-clean with no alert, the
    exports; tokens/s, TTFT, decode_step_ms p50/p95 (dispatch to the
    step's token read) beside decode_step_ms_mean (CUDA events), the host
    ms of ``metrics()``; launch counts (the default route's); a bucket
    first captured after the reset fires the watchdog once, a 0 s step
    deadline writes a dump. Then the trainer at rung "1.07B-h4096" on the
    default route, observed and plain in turns: losses bit-identical, the
    phase split (stage, dispatch, sync), host-gap findings (0), the
    ``compile`` entry, ``hbm`` and the counted-FLOPs ``mfu`` (numbers),
    beside bench.py's formula MFU; and ``Profiler`` with the GPU target
    over 3 steps, whose device trace names the train route's kernels."""
    import torch
    t0 = time.perf_counter()
    if size == "parity":
        res, bad = _obs_parity(gpu)
        emit({"phase": "obs", "size": size, "gpu": gpu, "dtype": "float32",
              "layers": 2, **res, "failed": [list(map(str, x)) for x in bad],
              "seconds": round(time.perf_counter() - t0, 1)})
        if bad:
            raise AssertionError(f"obs phase (parity): {bad}")
        return {}
    serving, serve_counts, bad = _obs_serving(gpu, params)
    train, train_counts, b = _obs_train(gpu)
    bad += b
    emit({"phase": "obs", "size": size, "gpu": gpu, "model": "LLAMA_7B",
          "dtype": "bfloat16", "serving": serving, "train": train,
          "failed": [list(map(str, x)) for x in bad],
          "seconds": round(time.perf_counter() - t0, 1)})
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"obs phase (serving): {bad}")
    return {"serving": serve_counts, "train": train_counts}


def obs_only(gpu):
    """``python3 chip_smoke.py obs``: the build and the obs phase alone,
    both sizes (the serving size over the serving phases' seeded tree)."""
    import torch
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    build_kernels()
    obs_phase(gpu, "parity")
    obs_phase(gpu, "serving", init_params(LLAMA_7B, seed=0))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# ---------------------------------------------------------------------------
# training: flash attention, fused AdamW, the train step
# ---------------------------------------------------------------------------
# bench.py's LLAMA_LADDER rung "1.07B-h4096": LLaMA-7B widths, 4 layers
TRAIN_RUNG = {"label": "1.07B-h4096", "batch": 2, "seq": 2048,
              "layers": 4, "moment_dtype": "bfloat16"}
TRAIN_STEPS = 6
FLASH_OPS = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
FLASH_REPLACES = {
    "flash_attention_fwd": "paddle_tpu/ops/pallas/flash_attention.py:270",
    "flash_attention_bwd_dq": "paddle_tpu/ops/pallas/flash_attention.py:511",
    "flash_attention_bwd_dkv":
        "paddle_tpu/ops/pallas/flash_attention.py:590"}
# (label, b, sq, sk, h, kvh, d, causal, dtype); the first is the training
# shape, and the one timed
FLASH_CASES = (
    ("train", 2, 2048, 2048, 32, 32, 128, True, "bfloat16"),
    ("gqa_4to1", 2, 2048, 2048, 32, 8, 128, True, "bfloat16"),
    ("f32", 1, 1024, 1024, 32, 32, 128, True, "float32"),
    ("non_causal", 2, 1024, 1024, 32, 32, 128, False, "bfloat16"),
    ("sq256_sk1024", 2, 256, 1024, 32, 32, 128, True, "bfloat16"),
    ("ragged_1000", 2, 1000, 1000, 32, 8, 128, True, "bfloat16"),
    ("s1", 2, 1, 1, 32, 32, 128, True, "bfloat16"))


def train_config(layers=TRAIN_RUNG["layers"], dtype=None, fused_train="ref",
                 **kw):
    """LLaMA at the 7B widths (bench.py's ladder cuts depth only)."""
    import dataclasses
    import torch
    from paddle_tpu_torch.models import LLAMA_7B
    return dataclasses.replace(
        LLAMA_7B, num_hidden_layers=layers, fused_train=fused_train,
        max_position_embeddings=TRAIN_RUNG["seq"],
        dtype=dtype or torch.bfloat16, **kw)


def flat_size(cfg):
    """The fused optimizer's flat length for ``cfg``'s parameters, padded
    to the trainer's 131072 multiple."""
    D, F, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    n = 2 * V * D + D + L * (2 * D + 2 * D * H * hd + 2 * D * KV * hd
                             + 3 * D * F)
    return n + (-n) % 131072


def _held(got, want, dt, f32_tol, bf16_norm=False, floor=0.0):
    """f32: |got - want| <= f32_tol x max|want| + floor (the sums run in
    another order); bf16: two ulps as :func:`bf16_close` (plus
    ``floor``), or with ``bf16_norm`` |got - want|_2 <= 2^-6 |want|_2 +
    floor sqrt(n) (against an f32 reference that does not round where the
    kernel does). ``floor`` is an absolute slack for outputs that should
    be 0 and hold rounding noise."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max())
    if dt == torch.float32:
        bnd = f32_tol * float(w.abs().max()) + floor
        return {"max_abs_err": err, "tol": f"{f32_tol} x max|want| + "
                f"{floor:.3g}", "ok": err <= bnd}
    if bf16_norm:
        nd, nw = float(diff.norm()), float(w.norm())
        return {"max_abs_err": err, "rel_l2_err": nd / max(nw, 1e-30),
                "tol": f"L2 <= 2^-6 x L2(want) + {floor:.3g} sqrt(n)",
                "ok": nd <= 2 ** -6 * nw + floor * diff.numel() ** 0.5}
    ok, worst = bf16_close(got, want, floor=floor)
    return {"max_abs_err": err, "tol": "2^-6 x (max(|got|,|want|) + "
            f"rms(want)) + {floor:.3g}, 2 bf16 ulps",
            "worst_in_tol_units": worst / 2 ** -6, "ok": ok}


def flash_phase(gpu):
    """The three flash kernels on the cases of FLASH_CASES: each against
    its plain version on the kernel's own inputs (f32: O and lse within
    1e-5, grads 1e-4 of the tensor's largest magnitude; bf16 by
    bf16_close), autograd through the kernels against autograd through
    ``_ref_attention`` (f32 as before; bf16 within 2^-6 relative L2: the
    kernels round P and dS to bf16 and take delta from the bf16 O, as the
    JAX kernels do, where ``_ref_attention`` stays in f32), and two
    launches bit for bit. The gradients' bounds add an absolute floor of
    1e-5 x max|dO| x max|V|, the scale of dP and delta: with one key, dq
    and dk are 0 and both sides return rounding noise. Timed at the
    training shape."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.flash_attention import _ref_attention
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases, max_err, timed = [], dict.fromkeys(FLASH_OPS, 0.0), None
    for label, b, sq, sk, h, kvh, d, causal, dtn in FLASH_CASES:
        dt = getattr(torch, dtn)

        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dt)
        q, k, v, do = rn(b, sq, h, d), rn(b, sk, kvh, d), rn(b, sk, kvh, d), \
            rn(b, sq, h, d)
        runs = []
        for _ in range(2):
            o, lse = kfa.flash_fwd_cuda(q, k, v, causal)
            delta = (o.float() * do.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            dq = kfa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal)
            runs.append((o, lse, dq) + kfa.flash_bwd_dkv_cuda(
                q, k, v, do, lse, delta, causal))
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        o, lse, dq, dk, dv = runs[0]
        want_o, want_lse = kfa.flash_fwd_ref(q, k, v, causal)
        want_dq = kfa.flash_bwd_dq_ref(q, k, v, do, lse, delta, causal)
        want_dk, want_dv = kfa.flash_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                 causal)
        # the scale of dP and delta, whose difference is all dS holds
        floor = 1e-5 * float(do.float().abs().max() * v.float().abs().max())
        plain = {"o": _held(o, want_o, dt, 1e-5),
                 "lse": _held(lse, want_lse, torch.float32, 1e-5),
                 "dq": _held(dq, want_dq, dt, 1e-4, floor=floor),
                 "dk": _held(dk, want_dk, dt, 1e-4, floor=floor),
                 "dv": _held(dv, want_dv, dt, 1e-4, floor=floor)}
        del runs, want_o, want_lse, want_dq, want_dk, want_dv
        grads = []
        for fn in (lambda *a: kfa.FlashAttention.apply(*a, causal, None),
                   lambda *a: _ref_attention(*a, causal=causal)):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = fn(*leaves)
            out.backward(do)
            grads.append([out.detach()] + [t.grad for t in leaves])
        auto = {nm: _held(g, w, dt, 1e-5 if nm == "o" else 1e-4,
                          bf16_norm=True, floor=0.0 if nm == "o" else floor)
                for nm, g, w in zip(("o", "dq", "dk", "dv"), *grads)}
        del grads
        for op, keys in zip(FLASH_OPS, (("o", "lse"), ("dq",), ("dk", "dv"))):
            for kk in keys:
                max_err[op] = max(max_err[op], plain[kk]["max_abs_err"])
        case = {"case": label, "b": b, "sq": sq, "sk": sk, "h": h,
                "kvh": kvh, "d": d, "causal": causal, "dtype": dtn,
                "vs_plain": plain, "autograd_vs_ref_attention": auto,
                "bitwise_repeatable": same,
                "ok": same and all(x["ok"] for x in plain.values())
                and all(x["ok"] for x in auto.values())}
        cases.append(case)
        if not case["ok"]:
            emit({"phase": "flash", "gpu": gpu, "cases": cases})
            raise AssertionError(f"flash attention disagrees: {case}")
        if timed is None:
            timed = (label, b, sq, sk, h, kvh, d, causal, q, k, v, do)
        del q, k, v, do, o, lse, dq, dk, dv, delta
        torch.cuda.empty_cache()
    label, b, sq, sk, h, kvh, d, causal, q, k, v, do = timed
    o, lse = kfa.flash_fwd_cuda(q, k, v, causal)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, delta, causal)
    # SDPA ([b, h, s, d], is_causal: square, so top-left = bottom-right)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    sdpa = {"fwd_ms": cold_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))}
    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    sdpa["bwd_ms"] = cold_ms(lambda: torch.autograd.grad(
        out, leaves, dot, retain_graph=True))
    sdpa["fwd_bwd_ms"] = cold_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, is_causal=causal), leaves,
        dot))
    fns = {"flash_attention_fwd": (lambda: kfa.flash_fwd_cuda(q, k, v,
                                                              causal),
                                   lambda: kfa.flash_fwd_ref(q, k, v, causal),
                                   sdpa["fwd_ms"]),
           "flash_attention_bwd_dq": (lambda: kfa.flash_bwd_dq_cuda(*bwd),
                                      lambda: kfa.flash_bwd_dq_ref(*bwd),
                                      sdpa["bwd_ms"]),
           "flash_attention_bwd_dkv": (lambda: kfa.flash_bwd_dkv_cuda(*bwd),
                                       lambda: kfa.flash_bwd_dkv_ref(*bwd),
                                       sdpa["bwd_ms"])}
    rows = []
    for op in FLASH_OPS:
        kernel, plain_fn, lib = fns[op]
        b_ms, b_by, nbytes, ops = bound(kernel)
        rows.append({
            "name": op, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES[op],
            "shape": {"b": b, "sq": sq, "sk": sk, "h": h, "kvh": kvh, "d": d,
                      "causal": causal},
            "dtype": "bfloat16", "max_abs_err": max_err[op],
            "ms": cold_ms(kernel), "plain_ms": cold_ms(plain_fn),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "operations": ops, "plan": launch_plan(kernel),
            "library_ms": lib,
            "library": ("torch.nn.functional.scaled_dot_product_attention"
                        + (" forward" if op == "flash_attention_fwd" else
                           " backward (dq, dk and dv in one call)")),
            "ok": True})
    emit({"phase": "flash", "gpu": gpu, "cases": cases, "sdpa": sdpa,
          "timed": {r["name"]: {k: r[k] for k in ("ms", "plain_ms",
                                                  "bound_ms", "library_ms",
                                                  "plan")}
                    for r in rows}})
    return rows


# ---------------------------------------------------------------------------
# the flash kernels' optional bodies, and the attention functionals' paths
# ---------------------------------------------------------------------------
# (label, b, sq, sk, h, kvh, d, causal, dtype, bias extents ("bh", "1h",
# "b1" or None), segment ids, dropout rate, dbias); the first seven at the
# training shape, the last three small and ragged
FLASH_BODY_CASES = (
    ("bias_bh", 2, 2048, 2048, 32, 32, 128, True, "bfloat16", "bh", False,
     0.0, True),
    ("bias_1h", 2, 2048, 2048, 32, 32, 128, True, "bfloat16", "1h", False,
     0.0, True),
    ("bias_b1", 2, 2048, 2048, 32, 32, 128, True, "bfloat16", "b1", False,
     0.0, True),
    ("seg", 2, 2048, 2048, 32, 32, 128, True, "bfloat16", None, True, 0.0,
     False),
    ("dropout_gqa", 2, 2048, 2048, 32, 8, 128, True, "bfloat16", None,
     False, 0.1, False),
    ("seg_dropout", 2, 2048, 2048, 32, 32, 128, True, "bfloat16", None,
     True, 0.1, False),
    ("causal_sq1024_sk512", 2, 1024, 512, 32, 32, 128, True, "bfloat16",
     None, False, 0.0, False),
    ("small_all_f32", 2, 200, 200, 4, 2, 64, True, "float32", "1h", True,
     0.2, True),
    ("small_sq_gt_sk_f32", 1, 300, 130, 4, 2, 64, True, "float32", "bh",
     True, 0.1, True),
    ("small_full_bf16", 2, 100, 170, 4, 1, 64, False, "bfloat16", "b1",
     True, 0.3, True))
FLASH_DROPOUT_SEED = 0xDEADBEEF
# the timed body classes: (class, the case whose inputs time it, the
# kernels it has); the library call of each (SDPA with a float or boolean
# mask) where one PyTorch call computes the same function
# where each body sits in the JAX kernels (paddle_tpu/ops/pallas/
# flash_attention.py)
FLASH_BODY_SITES = {
    "bias": ":153 (fwd), :344 (dq), :423 (dkv); _bias_index :201",
    "dbias": ":360-373 (_bwd_dq_kernel's has_dbias)",
    "seg": "_mask :60-83", "dropout": "_dropout_keep :85-111; :166, :355, "
    ":434", "seg,dropout": "_mask :60-83; _dropout_keep :85-111",
    "causal_sq_gt_sk": "off = sk - sq :244, :465"}
FLASH_BODY_ROWS = (("bias", "bias_bh", FLASH_OPS),
                   ("dbias", "bias_bh", ("flash_attention_bwd_dq",)),
                   ("seg", "seg", FLASH_OPS),
                   ("dropout", "dropout_gqa", FLASH_OPS),
                   ("seg,dropout", "seg_dropout", FLASH_OPS),
                   ("causal_sq_gt_sk", "causal_sq1024_sk512", FLASH_OPS))


def _segments(gen, b, s, docs=6, pad=100):
    """[b, s] int32 ids: ``docs`` seeded documents a row, the last ``pad``
    positions padding (id -1, which padding keys share)."""
    import torch
    ids = []
    for _ in range(b):
        cuts = torch.sort(torch.randint(1, s - pad, (docs - 1,),
                                        generator=gen, device="cuda"))[0]
        row = torch.searchsorted(cuts, torch.arange(s, device="cuda"),
                                 right=True).to(torch.int32)
        row[s - pad:] = -1
        ids.append(row)
    return torch.stack(ids).contiguous()


def _body_inputs(gen, case):
    import torch
    label, b, sq, sk, h, kvh, d, causal, dtn, bias, seg, rate, dbias = case
    dt = getattr(torch, dtn)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)
    q, k, v, do = rn(b, sq, h, d), rn(b, sk, kvh, d), rn(b, sk, kvh, d), \
        rn(b, sq, h, d)
    kw = {"seed": FLASH_DROPOUT_SEED, "rate": rate}
    if bias is not None:
        ext = {"bh": (b, h), "1h": (1, h), "b1": (b, 1)}[bias]
        kw["bias"] = 0.5 * torch.randn(*ext, sq, sk, generator=gen,
                                       device="cuda")
    if seg:
        kw["seg_q"] = _segments(gen, b, sq, pad=min(100, sq // 4))
        kw["seg_k"] = kw["seg_q"] if sq == sk else _segments(
            gen, b, sk, pad=min(100, sk // 4))
    return q, k, v, do, kw


def _body_run(kfa, q, k, v, do, causal, kw, dbias):
    """One launch of each kernel with the case's bodies: (o, lse, dq,
    dk, dv, dbias or None), and delta."""
    import torch
    o, lse = kfa.flash_fwd_cuda(q, k, v, causal, None, **kw)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq = kfa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, None, **kw,
                               bias_grad=dbias)
    dq, db = dq if dbias else (dq, None)
    dk, dv = kfa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, None,
                                    **kw)
    torch.cuda.synchronize()
    return (o, lse, dq, dk, dv, db), delta


def flash_bodies_phase(gpu):
    """Every optional body of the three flash kernels against its plain
    version (FLASH_BODY_CASES; the tolerances of :func:`flash_phase`;
    lse on the rows that see a key, O exactly 0 on the rows that see none,
    dbias as f32 at 1e-4), two launches bit for bit; then each body class of
    FLASH_BODY_ROWS timed at the training shape beside the same kernel
    without the flag on the same inputs, its bound, its plain version and
    the library call. Returns the rows (launches filled in by main)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases, max_err, kept = [], {}, {}
    for case in FLASH_BODY_CASES:
        label, b, sq, sk, h, kvh, d, causal, dtn, bias, seg, rate, dbias = \
            case
        dt = getattr(torch, dtn)
        q, k, v, do, kw = _body_inputs(gen, case)
        (run1, delta), (run2, _) = (_body_run(kfa, q, k, v, do, causal, kw,
                                              dbias) for _ in range(2))
        same = all(x is None or torch.equal(x, y) for x, y in zip(run1,
                                                                  run2))
        o, lse, dq, dk, dv, db = run1
        del run2
        want_o, want_lse = kfa.flash_fwd_ref(q, k, v, causal, None, **kw)
        seen = want_lse > kfa.MASK_VALUE / 2         # rows that see a key
        unseen_ok = bool((lse[~seen] <= kfa.MASK_VALUE / 2).all()) and \
            bool((o.transpose(1, 2)[~seen] == 0).all())
        want_dq = kfa.flash_bwd_dq_ref(q, k, v, do, lse, delta, causal,
                                       None, **kw, bias_grad=dbias)
        want_dq, want_db = want_dq if dbias else (want_dq, None)
        want_dk, want_dv = kfa.flash_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                 causal, None, **kw)
        floor = 1e-5 * float(do.float().abs().max() * v.float().abs().max())
        plain = {"o": _held(o, want_o, dt, 1e-5),
                 "lse_seen_rows": _held(lse[seen], want_lse[seen],
                                        torch.float32, 1e-5),
                 "dq": _held(dq, want_dq, dt, 1e-4, floor=floor),
                 "dk": _held(dk, want_dk, dt, 1e-4, floor=floor),
                 "dv": _held(dv, want_dv, dt, 1e-4, floor=floor)}
        if dbias:
            plain["dbias"] = _held(db, want_db, torch.float32, 1e-4,
                                   floor=floor)
        ok = same and unseen_ok and all(x["ok"] for x in plain.values())
        cases.append({"case": label, "b": b, "sq": sq, "sk": sk, "h": h,
                      "kvh": kvh, "d": d, "causal": causal, "dtype": dtn,
                      "bias": bias, "segments": seg, "dropout": rate,
                      "dbias": dbias, "rows_seeing_no_key":
                      int((~seen).sum()), "no_key_rows_zero": unseen_ok,
                      "vs_plain": plain, "bitwise_repeatable": same,
                      "ok": ok})
        if not ok:
            emit({"phase": "flash_bodies", "gpu": gpu, "cases": cases})
            raise AssertionError(f"flash body disagrees: {cases[-1]}")
        for op, keys in zip(FLASH_OPS, (("o", "lse_seen_rows"),
                                        ("dq", "dbias"), ("dk", "dv"))):
            for kk in keys:
                if kk in plain:
                    max_err[(label, op)] = max(max_err.get((label, op), 0.0),
                                               plain[kk]["max_abs_err"])
        if label in {r[1] for r in FLASH_BODY_ROWS}:
            kept[label] = (case, q, k, v, do, kw, o, lse, delta)
        del run1, want_o, want_lse, want_dq, want_dk, want_dv, want_db
        torch.cuda.empty_cache()
    rows = []
    for cls, label, ops in FLASH_BODY_ROWS:
        case, q, k, v, do, kw, o, lse, delta = kept[label]
        b, sq, sk, h, kvh, d, causal = case[1:8]
        want = set(cls.split(","))
        bias_grad = cls == "dbias"
        args = (q, k, v, do, lse, delta, causal, None)
        lib, lib_name = _body_library(cls, q, k, v, do, kw, causal)
        # the same kernel without the flags, on the same inputs (a causal
        # sq > sk launch has no flag-less form: the shape is the body)
        bare = {"seed": 0, "rate": 0.0}
        fns = {"flash_attention_fwd": (
            lambda kw=kw: kfa.flash_fwd_cuda(q, k, v, causal, None, **kw),
            lambda: kfa.flash_fwd_ref(q, k, v, causal, None, **kw),
            lib[0]),
            "flash_attention_bwd_dq": (
            lambda kw=kw: kfa.flash_bwd_dq_cuda(
                *args, **kw, bias_grad=bias_grad and "bias" in kw),
            lambda: kfa.flash_bwd_dq_ref(*args, **kw, bias_grad=bias_grad),
            lib[1]),
            "flash_attention_bwd_dkv": (
            lambda kw=kw: kfa.flash_bwd_dkv_cuda(*args, **kw),
            lambda: kfa.flash_bwd_dkv_ref(*args, **kw), lib[1])}
        for op in ops:
            kernel, plain_fn, lib_ms = fns[op]
            b_ms, b_by, nbytes, ops_n = bound(kernel, segments=(
                (kw["seg_q"], kw["seg_k"]) if "seg_q" in kw else None))
            ms = cold_ms(kernel)
            flagless = (None if cls == "causal_sq_gt_sk"
                        else cold_ms(lambda: kernel(bare)))
            errs = [e for (lb, o_), e in max_err.items() if o_ == op
                    and want <= _case_flags(FLASH_BODY_CASES, lb)]
            rows.append({
                "name": f"{op}[{cls}]", "route": "cuda",
                "source": FLASH_SOURCE, "replaces": FLASH_REPLACES[op],
                "replaces_body": FLASH_BODY_SITES[cls],
                "body": cls, "shape": {"b": b, "sq": sq, "sk": sk, "h": h,
                                       "kvh": kvh, "d": d, "causal": causal,
                                       "bias": case[9]},
                "dtype": case[8], "max_abs_err": max(errs),
                "ms": ms, "flagless_ms": flagless,
                "flag_cost": ms / flagless if flagless else None,
                "plain_ms": cold_ms(plain_fn, iters=3, warmup=1),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                "operations": ops_n, "plan": launch_plan(kernel),
                "library_ms": lib_ms,
                "library": lib_name, "ok": True})
            torch.cuda.empty_cache()
    del kept
    torch.cuda.empty_cache()
    emit({"phase": "flash_bodies", "gpu": gpu, "cases": cases,
          "timed": {r["name"]: {kk: r[kk] for kk in (
              "ms", "flagless_ms", "flag_cost", "plain_ms", "bound_ms",
              "library_ms", "plan")} for r in rows}})
    return rows


def _case_flags(cases, label):
    """The body flags a case of FLASH_BODY_CASES runs."""
    case = next(c for c in cases if c[0] == label)
    _, b, sq, sk, h, kvh, d, causal, dtn, bias, seg, rate, dbias = case
    return ({"bias"} if bias else set()) | ({"dbias"} if dbias else set()) \
        | ({"seg"} if seg else set()) | ({"dropout"} if rate else set()) \
        | ({"causal_sq_gt_sk"} if causal and sq > sk else set())


def _body_library(cls, q, k, v, do, kw, causal):
    """((forward ms, backward ms), name) of the one PyTorch call that
    computes a body class's function where there is one: SDPA with a float
    mask (the bias plus the causal mask's -inf, in q's type, which rounds
    the bias) for bias and dbias (whose backward also returns the mask's
    gradient), with a boolean mask (causal and same segment; no row fully
    masked: padding keys share the padding id) for segments. None for
    dropout (no torch call draws this keep mask) and for causal sq > sk
    (its rows that see no key are NaN in SDPA, 0 here)."""
    import torch
    import torch.nn.functional as F
    if cls not in ("bias", "dbias", "seg"):
        why = ("dropout: no PyTorch call draws the kernels' keep mask"
               if "dropout" in cls else "causal sq > sk: SDPA's rows that "
               "see no key are NaN, the kernels' 0")
        return (None, None), "none (" + why + ")"
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    sq, sk = q.shape[1], k.shape[1]
    tri = torch.ones(sq, sk, dtype=torch.bool, device="cuda").tril(sk - sq)
    if cls == "seg":
        mask = tri & (kw["seg_q"][:, None, :, None]
                      == kw["seg_k"][:, None, None, :])
        name = "boolean attn_mask (causal and same segment)"
    else:
        mask = torch.where(tri, kw["bias"], -torch.inf).to(q.dtype)
        name = f"float attn_mask (bias + causal, {q.dtype})"
        mask.requires_grad_(cls == "dbias")
    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    grads = leaves + ([mask] if cls == "dbias" else [])
    fwd = cold_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask.detach()))
    out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    bwd = cold_ms(lambda: torch.autograd.grad(out, grads, dot,
                                              retain_graph=True))
    return ((fwd, bwd), "torch.nn.functional.scaled_dot_product_attention "
            + name + ": forward; backward " + (
                "(dq, dk, dv and the mask's gradient)" if cls == "dbias"
                else "(dq, dk and dv in one call)"))


def flash_keep_readout_phase(gpu):
    """The keep mask read out of the forward and dkv kernels (f32, b 2,
    h 4 over kv 1, sq = sk = d = 128, dropout 0.1, seed 0xDEADBEEF). With
    q = 0 every score is 0, so P is uniform (1 / 128) over the keys; with
    V = I the forward's O[r, c] is keep(r, c) inv / 128 exactly. With
    dO = I the dkv kernel's dV[k, c] is inv P times the number of query
    heads of the group whose keep(c, k) holds (the query head rebuilt from
    the K/V head's grid). Both against the torch ``dropout_keep``, bit for
    bit. Both are read out of the bf16 kernels too (the tensor-core
    kernels, whose lanes hold the scores in mma.sync's fragment layout):
    the forward's O is bf16(keep inv / 128) (P = inv rounded to bf16, then
    a power of two), the dkv pass's each count times inv P rounded to
    bf16, 2^-9 of it, far from a neighbouring count."""
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    b, h, kvh, n, rate = 2, 4, 1, 128, 0.1
    eye = torch.eye(n, device="cuda")
    q = torch.zeros(b, n, h, n, device="cuda")
    k = torch.randn(b, n, kvh, n, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    v = eye[None, :, None, :].expand(b, n, kvh, n).contiguous()
    kw = {"seed": FLASH_DROPOUT_SEED, "rate": rate}
    o, lse = kfa.flash_fwd_cuda(q, k, v, False, None, **kw)
    qbh = torch.arange(b * h, device="cuda").reshape(b, h, 1, 1)
    pos = torch.arange(n, device="cuda")
    keep = kfa.dropout_keep(FLASH_DROPOUT_SEED, qbh, pos[:, None],
                            pos[None, :], rate)              # [b, h, r, c]
    inv = kfa.dropout_inv(rate)
    want_o = torch.where(keep, inv / n, 0.0).transpose(1, 2)
    fwd_equal = bool(torch.equal(o, want_o))
    do = eye[None, :, None, :].expand(b, n, h, n).contiguous()
    delta = (o * do).sum(-1).transpose(1, 2).contiguous()
    _, dv = kfa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, False, None,
                                   **kw)
    want_count = keep.sum(1).transpose(1, 2).float()       # [b, key, c]

    def count_equal(dv, lse):
        p = torch.exp(-lse[0, 0, 0])          # the kernels' P = 1 / 128
        count = torch.round(dv[:, :, 0, :].float() / (inv * p))
        return bool(torch.equal(count, want_count))
    dkv_equal = count_equal(dv, lse)
    bf = [t.to(torch.bfloat16) for t in (q, k, v, do)]
    o16, lse16 = kfa.flash_fwd_cuda(*bf[:3], False, None, **kw)
    delta16 = (o16.float() * bf[3].float()).sum(-1).transpose(1, 2) \
        .contiguous()
    _, dv16 = kfa.flash_bwd_dkv_cuda(*bf, lse16, delta16, False, None,
                                     **kw)
    bf16_equal = count_equal(dv16, lse16)
    fwd16_equal = bool(torch.equal(o16, want_o.to(torch.bfloat16)))
    res = {"phase": "flash_keep_readout", "gpu": gpu, "b": b, "h": h,
           "kvh": kvh, "n": n, "rate": rate, "seed": FLASH_DROPOUT_SEED,
           "kept_share": float(keep.float().mean()),
           "fwd_keep_equal": fwd_equal, "dkv_keep_count_equal": dkv_equal,
           "fwd_bf16_keep_equal": fwd16_equal,
           "dkv_bf16_keep_count_equal": bf16_equal,
           "ok": fwd_equal and dkv_equal and fwd16_equal and bf16_equal}
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"keep mask read out of the kernels: {res}")


# the varlen path: 8 documents of 64-1024 tokens packed into 4096, at
# LLaMA-7B's attention widths
VARLEN = {"tokens": 4096, "docs": 8, "min": 64, "max": 1024, "h": 32,
          "d": 128, "dropout": 0.1, "sdpa": (2, 1024, 512)}
# the bias path: BERT-base's attention block (hidden 768, 12 heads of 64),
# batch 8 x 512, post-LN, padding lengths 128-512
BERT = {"b": 8, "s": 512, "hidden": 768, "heads": 12, "min": 128,
        "dropout": 0.1}


def _doc_lengths(seed=11):
    """VARLEN's seeded document lengths, each in [min, max], summing to
    the tokens."""
    rng = np.random.RandomState(seed)
    lens = np.full(VARLEN["docs"], VARLEN["min"])
    rest = VARLEN["tokens"] - int(lens.sum())
    while rest:
        i = rng.randint(VARLEN["docs"])
        add = min(rest, int(rng.randint(1, 257)), VARLEN["max"] - lens[i])
        lens[i] += add
        rest -= add
    return lens


def _grad_run(fn, arrays, grad_idx, dout, seed):
    """fn(*leaves, generator) and the gradients of sum(out * dout) for
    ``grad_idx``, with a fresh CUDA generator seeded ``seed``."""
    import torch
    leaves = [a.detach().requires_grad_(i in grad_idx)
              for i, a in enumerate(arrays)]
    out = fn(*leaves, torch.Generator(device="cuda").manual_seed(seed))
    out.backward(dout)
    return [out.detach()] + [leaves[i].grad for i in grad_idx]


def _routes_held(got, want, names, dt, floor):
    """The kernel route against the plain route: f32 as :func:`_held` (O
    1e-5, gradients 1e-4 of the largest magnitude), bf16 within 2^-6
    relative L2 (flash_phase's autograd check)."""
    return {nm: _held(g, w, dt, 1e-5 if nm == "o" else 1e-4,
                      bf16_norm=True, floor=0.0 if nm == "o" else floor)
            for nm, g, w in zip(names, got, want)}


def varlen_path_phase(gpu):
    """The packed varlen path at full width (VARLEN): ``nn.functional.
    flash_attn_unpadded`` over one packed batch of 4096 tokens (h = kv 32,
    d 128, bf16, causal, dropout 0.1), forward and backward; then
    ``flash_attn_varlen_qkvpacked`` on the same packing at h 32 over kv 8;
    then ``scaled_dot_product_attention`` with is_causal and sq 1024 > sk
    512 (b 2, dropout 0.1). Each against the same call under
    ``KERNELS.force("flash_attention", "unfused")`` with the same generator
    seed, so the same keep mask (sq > sk: on the rows that see a key; the
    kernels' other rows are 0, the plain route's the mean of V). The
    launch counts are set to 0 just before the kernel-route calls and read
    just after (1 fwd, 1 dq, 1 dkv a call, by body class); each call timed
    forward + backward on both routes, beside its launches' bounds (the
    pairs of one document). Returns the counts by body."""
    import torch
    from paddle_tpu_torch.analysis.kernel_rules import bound as model
    from paddle_tpu_torch.nn import functional as NF
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.flash_attention import \
        segment_ids_from_cu_seqlens
    from paddle_tpu_torch.ops.kernels._launch import capture_kernel_launches
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    gen = torch.Generator(device="cuda").manual_seed(12)
    lens = _doc_lengths()
    cu = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]),
                         dtype=torch.int32, device="cuda")
    T, H, D, rate = VARLEN["tokens"], VARLEN["h"], VARLEN["d"], \
        VARLEN["dropout"]
    b2, sq, sk = VARLEN["sdpa"]
    bf = torch.bfloat16

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf)
    calls = {
        "flash_attn_unpadded": (
            lambda q, k, v, g: NF.flash_attn_unpadded(
                q, k, v, cu, cu, dropout=rate, causal=True,
                generator=g)[0],
            [rn(T, H, D), rn(T, H, D), rn(T, H, D)], (0, 1, 2),
            rn(T, H, D)),
        "flash_attn_varlen_qkvpacked_gqa4": (
            lambda p, g: NF.flash_attn_varlen_qkvpacked(
                p, cu, cu, dropout=rate, causal=True, generator=g)[0],
            [rn(T, 4 + 2, H // 4, D)], (0,), rn(T, H, D)),
        # dO 0 on the rows that see no key: the plain route gives them
        # the mean of V, whose gradient the kernels do not have
        f"sdpa_causal_sq{sq}_sk{sk}": (
            lambda q, k, v, g: NF.scaled_dot_product_attention(
                q, k, v, dropout_p=rate, is_causal=True, generator=g),
            [rn(b2, sq, H, D), rn(b2, sk, H, D), rn(b2, sk, H, D)],
            (0, 1, 2), torch.cat([torch.zeros(b2, sq - sk, H, D, dtype=bf,
                                              device="cuda"),
                                  rn(b2, sk, H, D)], 1))}
    kernels.reset_launches()
    got = {nm: _grad_run(fn, arrays, gi, dout, 7)
           for nm, (fn, arrays, gi, dout) in calls.items()}
    torch.cuda.synchronize()
    counts = kernels.launches_by_body()
    totals = kernels.launches()
    res = {"phase": "varlen_path", "gpu": gpu, "doc_lengths":
           lens.tolist(), "launches_by_body": counts, "calls": {}}
    ok = all(totals[op] == len(calls) for op in FLASH_OPS)
    for nm, (fn, arrays, gi, dout) in calls.items():
        with KERNELS.force("flash_attention", "unfused"):
            want = _grad_run(fn, arrays, gi, dout, 7)
        g = got[nm]
        names = ["o"] + [f"d{i}" for i in gi]
        if nm.startswith("sdpa"):
            # rows 0..sq-sk-1 see no key: O = 0 from the kernels, compared
            # apart
            top = g[0][:, :sq - sk].float().abs().max() == 0 and \
                g[1][:, :sq - sk].float().abs().max() == 0
            g, want = ([g[0][:, sq - sk:]] + g[1:],
                       [want[0][:, sq - sk:]] + want[1:])
        floor = 1e-5 * float(dout.float().abs().max()
                             * arrays[-1].float().abs().max())
        held = _routes_held(g, want, names, bf, floor)
        call_ok = all(x["ok"] for x in held.values()) and all(
            bool(torch.isfinite(x).all()) for x in g)
        if nm.startswith("sdpa"):
            call_ok = call_ok and bool(top)
        res["calls"][nm] = {"vs_unfused": held, "ok": call_ok}
        ok = ok and call_ok
        del want, g
        torch.cuda.empty_cache()
    ids = segment_ids_from_cu_seqlens(cu, T)[None]
    for nm, (fn, arrays, gi, dout) in calls.items():
        def step(fn=fn, arrays=arrays, gi=gi, dout=dout):
            _grad_run(fn, arrays, gi, dout, 7)
        # the least time of the call's three launches: the pairs of one
        # document under the causal mask (no segments in the SDPA call)
        with capture_kernel_launches(all_threads=True) as specs:
            step()
        torch.cuda.synchronize()
        segs = None if nm.startswith("sdpa") else (ids, ids)
        res["calls"][nm]["bound_ms"] = {
            sp.name: model(sp, segments=segs)[0] for sp in specs}
        res["calls"][nm]["fwd_bwd_ms"] = cold_ms(step, iters=10)
        with KERNELS.force("flash_attention", "unfused"):
            res["calls"][nm]["unfused_fwd_bwd_ms"] = cold_ms(step, iters=3,
                                                             warmup=1)
        torch.cuda.empty_cache()
    res["ok"] = ok
    emit(res)
    if not ok:
        raise AssertionError(f"varlen path: {res}")
    return counts


def _bert_inputs(gen, dt):
    import torch
    b, s, hid, nh = BERT["b"], BERT["s"], BERT["hidden"], BERT["heads"]
    hd = hid // nh

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * std).to(dt)
    lens = torch.randint(BERT["min"], s + 1, (b,), generator=gen,
                         device="cuda")
    pad = torch.where(torch.arange(s, device="cuda")[None] < lens[:, None],
                      0.0, -1e4).reshape(b, 1, 1, s)
    arrays = {"x": rn(b, s, hid), "qkv_weight": rn(3, nh, hd, hid,
                                                   std=0.02),
              "linear_weight": rn(hid, hid, std=0.02),
              "qkv_bias": rn(3, nh, hd, std=0.02),
              "linear_bias": rn(hid, std=0.02),
              "ln_scale": (1 + 0.1 * rn(hid, std=1.0)).to(dt),
              "ln_bias": rn(hid, std=0.1)}
    learned = 0.5 * torch.randn(1, nh, s, s, generator=gen, device="cuda")
    return arrays, pad, learned, rn(b, s, hid), lens


def bias_path_phase(gpu):
    """The bias path at full width (BERT): ``incubate.nn.functional.
    fused_multi_head_attention`` (hidden 768, 12 heads of 64, batch 8 x
    512, post-LN, training, attention and out-projection dropout 0.1) with
    an additive padding mask [8, 1, 1, 512] from seeded lengths 128-512,
    then with a learned relative-position bias [1, 12, 512, 512] f32 that
    requires grad (the dbias body); forward and backward. f32 against the
    same call under ``KERNELS.force("flash_attention", "unfused")`` (one
    generator seed: the same attention keep mask and out-projection
    dropout mask), bf16 for the times. Counts set to 0 before the
    kernel-route calls (f32 and bf16, both masks) and read after. Returns
    the counts by body."""
    import torch
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    gen = torch.Generator(device="cuda").manual_seed(13)
    names = ["x", "qkv_weight", "linear_weight", "qkv_bias", "linear_bias",
             "ln_scale", "ln_bias", "attn_mask"]
    runs = {}
    for dtn in ("float32", "bfloat16"):
        dt = getattr(torch, dtn)
        arrays, pad, learned, dout, lens = _bert_inputs(gen, dt)
        for kind, mask in (("padding", pad), ("learned", learned)):
            def fn(*vals):
                a = dict(zip(names, vals[:-1]))
                return IF.fused_multi_head_attention(
                    a.pop("x"), a.pop("qkv_weight"), a.pop("linear_weight"),
                    dropout_rate=BERT["dropout"],
                    attn_dropout_rate=BERT["dropout"], training=True,
                    generator=vals[-1], **a)
            gi = (0, 1, 2) + ((7,) if kind == "learned" else ())
            runs[(dtn, kind)] = (fn, [arrays[n] for n in names[:-1]]
                                 + [mask], gi, dout)
    kernels.reset_launches()
    got = {key: _grad_run(*run, 21) for key, run in runs.items()}
    torch.cuda.synchronize()
    counts = kernels.launches_by_body()
    totals = kernels.launches()
    ok = all(totals[op] == len(runs) for op in FLASH_OPS)
    res = {"phase": "bias_path", "gpu": gpu, "padding_lengths":
           lens.tolist(), "launches_by_body": counts, "runs": {}}
    for key, (fn, arrays, gi, dout) in runs.items():
        g = got[key]
        finite = all(bool(torch.isfinite(x.float()).all()) for x in g)
        entry = {"finite": finite}
        if key[0] == "float32":
            with KERNELS.force("flash_attention", "unfused"):
                want = _grad_run(fn, arrays, gi, dout, 21)
            held = {nm: _held(x, w, torch.float32,
                              1e-5 if nm == "out" else 1e-4)
                    for nm, x, w in zip(["out"] + [names[i] for i in gi],
                                        g, want)}
            entry["vs_unfused"] = held
            finite = finite and all(x["ok"] for x in held.values())
            del want
        entry["ok"] = finite
        ok = ok and finite
        res["runs"]["/".join(key)] = entry
    for key, (fn, arrays, gi, dout) in runs.items():
        if key[0] != "bfloat16":
            continue

        def step(fn=fn, arrays=arrays, gi=gi, dout=dout):
            _grad_run(fn, arrays, gi, dout, 21)
        res["runs"]["/".join(key)]["fwd_bwd_ms"] = cold_ms(step, iters=10)
        with KERNELS.force("flash_attention", "unfused"):
            res["runs"]["/".join(key)]["unfused_fwd_bwd_ms"] = cold_ms(
                step, iters=3, warmup=1)
    res["ok"] = ok
    emit(res)
    if not ok:
        raise AssertionError(f"bias path: {res}")
    return counts


def body_launches(counts, cls):
    """Launches of each flash kernel on the path phases in the body
    classes that hold every flag of ``cls``."""
    want = set(cls.split(","))
    out = dict.fromkeys(FLASH_OPS, 0)
    for c in counts:
        for op, by in c.items():
            if op not in out:   # the block kernels' "tc"/"cuda_core"
                continue
            for k, n in by.items():
                if want <= set(k.split(",")):
                    out[op] += n
    return out


def _rel_ulps(got, want, chunk=1 << 26):
    """Largest |got - want| / max(|got|, |want|) over the buffers, in f32,
    a chunk at a time."""
    import torch
    worst = 0.0
    for i in range(0, got.numel(), chunk):
        g, w = got[i:i + chunk].float(), want[i:i + chunk].float()
        r = (g - w).abs() / torch.maximum(g.abs(), w.abs()).clamp_min(1e-38)
        worst = max(worst, float(r.max()))
    return worst


def adamw_phase(gpu, n_train):
    """The fused AdamW kernel against its plain version (both update in
    place), at the training phase's flat size ``n_train`` (its layout:
    bf16 moments and shadow) and a ragged size (f32 and bf16 moments,
    with and without the bf16 shadow), grad_scale < 1 and none. Every output within 2 ulps of its stored type
    (relative error <= 2 eps); bit equality is reported. Timed at the
    training layout (f32 master and grad, bf16 moments and shadow)."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_adamw as kfw
    gen = torch.Generator(device="cuda").manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    kw = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, weight_decay=0.1)
    cases, max_err = [], 0.0
    for n, mdt, shadow, scale in ((n_train, bf16, bf16, 0.5),
                                  (1_000_003, f32, bf16, 0.25),
                                  (1_000_003, bf16, None, 0.5),
                                  (1_000_003, f32, None, None)):
        def state():
            g = torch.Generator(device="cuda").manual_seed(n + 1)
            return (torch.randn(n, generator=g, device="cuda"),
                    torch.randn(n, generator=g, device="cuda") * 1e-2,
                    (torch.randn(n, generator=g, device="cuda")
                     * 1e-3).to(mdt),
                    (torch.rand(n, generator=g, device="cuda")
                     * 1e-4).to(mdt))
        step = torch.tensor(3.0, device="cuda")
        sc = None if scale is None else torch.tensor(scale, device="cuda")
        a = state()
        got = kfw.fused_adamw_triton(*a, 1e-4, step, grad_scale=sc,
                                     shadow_dtype=shadow, **kw)
        in_place = all(got[i] is a[j] for i, j in ((0, 0), (1, 2), (2, 3)))
        b_ = state()
        want = kfw.adamw_update_ref(*b_, 1e-4, step, grad_scale=sc,
                                    shadow_dtype=shadow, **kw)
        torch.cuda.synchronize()
        outs = {}
        for nm, g, w in zip(("param", "moment1", "moment2", "shadow"), got,
                            want):
            rel = _rel_ulps(g, w)
            eps = torch.finfo(g.dtype).eps
            outs[nm] = {"dtype": str(g.dtype)[6:], "max_rel_err": rel,
                        "tol": f"2 ulps (rel {2 * eps:.3g})",
                        "bitwise_equal": bool(torch.equal(g, w)),
                        "ok": rel <= 2 * eps}
            max_err = max(max_err, float((g.float() - w.float()).abs().max()))
        case = {"n": n, "moment_dtype": str(mdt)[6:],
                "shadow": None if shadow is None else str(shadow)[6:],
                "grad_scale": scale, "in_place": in_place, "outputs": outs,
                "ok": in_place and all(o["ok"] for o in outs.values())}
        cases.append(case)
        del a, b_, got, want
        torch.cuda.empty_cache()
        if not case["ok"]:
            emit({"phase": "adamw", "gpu": gpu, "cases": cases})
            raise AssertionError(f"fused_adamw disagrees: {case}")
    n = n_train
    p = torch.randn(n, generator=gen, device="cuda")
    g = torch.randn(n, generator=gen, device="cuda") * 1e-2
    m = torch.zeros(n, dtype=bf16, device="cuda")
    v = torch.zeros(n, dtype=bf16, device="cuda")
    step = torch.tensor(1.0, device="cuda")
    sc = torch.tensor(0.5, device="cuda")
    args = (p, g, m, v, 1e-4, step)
    # f32 master r/w, f32 grad r, bf16 moments r/w, bf16 shadow w
    b_ms, b_by = bound(lambda: kfw.fused_adamw_triton(
        *args, grad_scale=sc, shadow_dtype=bf16, **kw))[:2]
    row = {"name": "fused_adamw", "route": "triton", "source": ADAMW_SOURCE,
           "replaces": "paddle_tpu/ops/pallas/fused_adamw.py:93",
           "shape": {"n": n, "master": "float32", "grad": "float32",
                     "moments": "bfloat16", "shadow": "bfloat16"},
           "dtype": "float32", "max_abs_err": max_err,
           "ms": cold_ms(lambda: kfw.fused_adamw_triton(
               *args, grad_scale=sc, shadow_dtype=bf16, **kw)),
           "plain_ms": cold_ms(lambda: kfw.adamw_update_ref(
               *args, grad_scale=sc, shadow_dtype=bf16, **kw), iters=10),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": 22 * n,
           "operations": 16 * n, "library_ms": None,
           "library": "torch._fused_adamw_ on the same f32 master with f32 "
                      "moments (its moments cannot be bf16)", "ok": True}
    del m, v
    torch.cuda.empty_cache()
    if hasattr(torch, "_fused_adamw_"):
        m32 = torch.zeros(n, device="cuda")
        v32 = torch.zeros(n, device="cuda")
        steps = [torch.tensor(1.0, device="cuda")]
        row["library_ms"] = cold_ms(lambda: torch._fused_adamw_(
            [p], [g], [m32], [v32], [], steps, lr=1e-4, beta1=0.9,
            beta2=0.95, weight_decay=0.1, eps=1e-8, amsgrad=False,
            maximize=False))
        del m32, v32
    emit({"phase": "adamw", "gpu": gpu, "cases": cases,
          "timed": {k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "library_ms")}})
    del p, g
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# the fused-train kernels: RMSNorm backward, residual + RMSNorm, SwiGLU,
# linear CE
# ---------------------------------------------------------------------------
FT_TRITON_SOURCE = "paddle_tpu_torch/ops/kernels/fused_train.py"
CE_SOURCE = "paddle_tpu_torch/csrc/linear_ce.cu"
FT_REPLACES = {
    "rms_norm_bwd": "paddle_tpu/ops/pallas/norms.py:148",
    "residual_rms_norm_fwd": "paddle_tpu/ops/pallas/norms.py:248",
    "swiglu_fwd": "paddle_tpu/ops/pallas/fused_train.py:516",
    "swiglu_bwd": "paddle_tpu/ops/pallas/fused_train.py:530",
    "linear_ce_fwd": "paddle_tpu/ops/pallas/fused_train.py:246",
    "linear_ce_bwd_dx": "paddle_tpu/ops/pallas/fused_train.py:273",
    "linear_ce_bwd_dh": "paddle_tpu/ops/pallas/fused_train.py:289"}
FT_OPS = tuple(FT_REPLACES)
# (label, T, V, dtype, head, labels[, backward chunk rows]); the first is
# the train step's shape (batch 2 x seq 2048 tokens, D 4096) and the one
# timed; the last forces P's workspace into two token chunks
CE_CASES = (("train", 4096, 32000, "bfloat16", "untied", "mixed"),
            ("ragged_T4095_V32003", 4095, 32003, "bfloat16", "untied",
             "mixed"),
            ("tied_head", 4096, 32000, "bfloat16", "tied", "mixed"),
            ("all_ignored", 1024, 32000, "bfloat16", "untied", "ignored"),
            ("f32", 512, 32003, "float32", "untied", "mixed"),
            ("two_chunks", 4096, 32000, "bfloat16", "untied", "mixed",
             2048))


def _twice(fn):
    """Two launches of ``fn`` on the same inputs: (outputs, bit-equal)."""
    import torch
    a, b = fn(), fn()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    torch.cuda.synchronize()
    return a, all(torch.equal(x, y) for x, y in zip(a, b))


def fused_train_phase(gpu):
    """The seven fused-train kernels against their plain versions on the
    card (f32: 1e-5 of the largest magnitude for values, 1e-4 for sums
    over rows or the vocab; bf16: two ulps, ``bf16_close``), two launches
    bit for bit, at the train step's shapes and edge cases (ragged rows
    and elements; for the CE: T 4095 and V 32003, the tied head, every
    label ignored, f32, P's workspace in two token chunks; the forward's
    lse and pick against its plain vocab-tile stats and their combine too;
    the backward's P pass against its plain hi + lo split, dh over the P
    dx's call keeps and dh alone bit for bit). Timed at the train step's
    shapes, L2 flushed, beside the bound, the plain version, the former
    RMSNorm backward (``tools/rms_bwd_ab.py``'s ``parent_rms_norm_bwd``),
    the library's ``_fused_rms_norm_backward`` and, for the CE (no single
    PyTorch call computes it), cuBLAS's time for the same products (bf16
    once, and the backward's as the hi + lo pair); the forward over the
    tied head too; the backward's P pass and each product on their own,
    and the pair of calls."""
    import torch
    from paddle_tpu_torch.ops.kernels import fused_train as kft
    from paddle_tpu_torch.ops.kernels import norms as kn
    from paddle_tpu_torch.tools.rms_bwd_ab import parent_rms_norm_bwd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(8)
    bf16, f32 = torch.bfloat16, torch.float32
    eps = 1e-6
    T, D, F = TRAIN_RUNG["batch"] * TRAIN_RUNG["seq"], D7, F7
    cases = {op: [] for op in FT_OPS}
    max_err = dict.fromkeys(FT_OPS, 0.0)

    def rn(*shape, dt=bf16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dt)

    def record(op, case):
        cases[op].append(case)
        for o in case["outputs"].values():
            max_err[op] = max(max_err[op], o["max_abs_err"])
        if not case["ok"]:
            emit({"phase": "fused_train_kernels", "gpu": gpu,
                  "cases": cases})
            raise AssertionError(f"{op} disagrees: {case}")

    # -- the row and elementwise kernels -----------------------------------
    # the norms at the train step's rows, ragged rows, f32, fewer rows
    # than the backward's programs at a D that is no power of two, and the
    # widest row the kernels take (MAX_D)
    for rows, d, dt in ((T, D, bf16), (T - 1, D, bf16), (1024, D, f32),
                        (7, 1000, bf16), (300, kn.MAX_D, f32)):
        x, g, delta = rn(rows, d, dt=dt), rn(rows, d, dt=dt), rn(rows, d,
                                                                  dt=dt)
        w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dt)
        got, same = _twice(lambda: kn.rms_norm_bwd_triton(x, w, g, eps))
        want = kn.rms_bwd_ref(eps, (x, w), g)
        outs = {"dx": _held(got[0], want[0], dt, 1e-5),
                "dw": _held(got[1], want[1], dt, 1e-4)}
        record("rms_norm_bwd", {
            "rows": rows, "D": d, "dtype": str(dt)[6:], "outputs": outs,
            "bitwise_repeatable": same,
            "ok": same and all(o["ok"] for o in outs.values())})
        got, same = _twice(lambda: kn.residual_rms_norm_fwd_triton(
            delta, x, w, eps))
        want = kn.residual_rms_norm_fwd_ref(delta, x, w, eps)
        outs = {"y": _held(got[0], want[0], dt, 0.0),
                "h": _held(got[1], want[1], dt, 1e-5)}
        outs["y"]["bitwise_equal"] = bool(torch.equal(got[0], want[0]))
        record("residual_rms_norm_fwd", {
            "rows": rows, "D": d, "dtype": str(dt)[6:], "outputs": outs,
            "bitwise_repeatable": same,
            "ok": same and outs["y"]["bitwise_equal"]
            and outs["h"]["ok"]})
        del x, g, delta, got, want
    for shape, dt in (((T, F), bf16), ((T - 1, F), bf16), ((7, 1001), bf16),
                      ((1024, F), f32)):
        g, u, d = rn(*shape, dt=dt, scale=2), rn(*shape, dt=dt), rn(
            *shape, dt=dt)
        got, same = _twice(lambda: kft.swiglu_fwd_triton(g, u))
        outs = {"out": _held(got[0], kft.swiglu_fwd_ref(g, u), dt, 1e-5)}
        record("swiglu_fwd", {"shape": list(shape), "dtype": str(dt)[6:],
                              "outputs": outs, "bitwise_repeatable": same,
                              "ok": same and outs["out"]["ok"]})
        got, same = _twice(lambda: kft.swiglu_bwd_triton(g, u, d))
        want = kft.swiglu_bwd_ref(g, u, d)
        outs = {"dg": _held(got[0], want[0], dt, 1e-5),
                "du": _held(got[1], want[1], dt, 1e-5)}
        record("swiglu_bwd", {"shape": list(shape), "dtype": str(dt)[6:],
                              "outputs": outs, "bitwise_repeatable": same,
                              "ok": same and all(o["ok"]
                                                 for o in outs.values())})
        del g, u, d, got, want
    torch.cuda.empty_cache()

    # -- linear CE ----------------------------------------------------------
    timed = None
    for label, t, v, dtn, head_kind, lab_kind, *chunk in CE_CASES:
        chunk = chunk[0] if chunk else None
        dt = getattr(torch, dtn)
        x = rn(t, D, dt=dt, scale=0.5)
        if head_kind == "tied":
            head = rn(v, D, dt=dt, scale=0.02).T     # the embedding, seen
        else:                                        # transposed
            head = rn(D, v, dt=dt, scale=0.02)
        rng = np.random.default_rng(t + v)
        lab = rng.integers(0, v, t)
        if lab_kind == "ignored":
            lab[:] = -100
        else:
            drop = rng.random(t) < 0.1
            lab[drop] = np.where(rng.random(int(drop.sum())) < 0.5, -1, -100)
        lab = torch.as_tensor(lab, device="cuda")
        coef = torch.tensor([1.0 / max(int((lab >= 0).sum()), 1)],
                            device="cuda")
        shape = {"case": label, "T": t, "D": D, "V": v, "dtype": dtn,
                 "head": head_kind, "chunk_rows": chunk}
        if chunk is None:
            (lse, pick), same_f = _twice(lambda: kft.linear_ce_fwd_cuda(
                x, head, lab))
            want_lse, want_pick = kft.ce_fwd_ref(x, head, lab)
            outs = {"lse": _held(lse, want_lse, f32, 1e-5),
                    "pick": _held(pick, want_pick, f32, 1e-5)}
            if dt == bf16:
                # the wgmma body's split: each vocab tile's stats, then
                # their combine in the kernel's order
                m_lse, m_pick = kft.ce_fwd_combine_ref(
                    kft.ce_fwd_stats_ref(x, head, lab))
                outs["lse_model"] = _held(lse, m_lse, f32, 1e-5)
                outs["pick_model"] = _held(pick, m_pick, f32, 1e-5)
                del m_lse, m_pick
            record("linear_ce_fwd", dict(
                shape, outputs=outs, bitwise_repeatable=same_f,
                body=launch_plan(lambda: kft.linear_ce_fwd_cuda(
                    x, head, lab))["body"],
                ok=same_f and all(o["ok"] for o in outs.values())))
            del want_lse, want_pick
        else:
            lse, _ = kft.linear_ce_fwd_cuda(x, head, lab)
        # the backward passes take the plain forward's lse, as the plain
        # versions do, so both sides see the same inputs; dh over the P
        # that dx's call keeps, as LinearCE runs them
        def dx_call():
            dx, ws = kft.linear_ce_bwd_dx_cuda(x, head, lab, lse, coef,
                                               chunk_rows=chunk, keep_p=True)
            return (dx, ws.hi) + (() if ws.lo is None else (ws.lo,))
        (dx, *p_ws), same = _twice(dx_call)
        want = kft.ce_bwd_dx_ref(x, head, lab, lse, coef)
        o = _held(dx, want, dt, 1e-4)
        ok = same and o["ok"]
        if lab_kind == "ignored":
            o["all_zero"] = not bool(dx.any())
            ok = ok and o["all_zero"]
        outs = {"dx": o}
        if chunk is None:
            # the P pass's hi + lo (f32: P) against the plain split: f32
            # sums in another order, 1e-5 of P's largest magnitude
            p0, p1 = kft.ce_p_split_ref(x, head, lab, lse, coef)
            got = sum(t.float() for t in p_ws)
            outs["p"] = _held(got, p0.float() + (
                0 if p1 is None else p1.float()), f32, 1e-5)
            ok = ok and outs["p"]["ok"]
            del p0, p1, got
        record("linear_ce_bwd_dx", dict(
            shape, outputs=outs, bitwise_repeatable=same, ok=ok))
        del dx, want

        def pair():
            _, p = kft.linear_ce_bwd_dx_cuda(x, head, lab, lse, coef,
                                             chunk_rows=chunk, keep_p=True)
            return kft.linear_ce_bwd_dh_cuda(x, head, lab, lse, coef, p=p,
                                             chunk_rows=chunk)
        (dh,), same = _twice(pair)
        alone = kft.linear_ce_bwd_dh_cuda(x, head, lab, lse, coef,
                                          chunk_rows=chunk)
        want = kft.ce_bwd_dh_ref(x, head, lab, lse, coef)
        o = _held(dh, want, dt, 1e-4)
        o["layout_as_head"] = dh.stride() == head.stride()
        # dh's own P passes give the bits of the P dx's call kept
        o["alone_bitwise_equal"] = bool(torch.equal(alone, dh))
        ok = same and o["ok"] and o["layout_as_head"] \
            and o["alone_bitwise_equal"]
        if lab_kind == "ignored":
            o["all_zero"] = not bool(dh.any())
            ok = ok and o["all_zero"]
        record("linear_ce_bwd_dh", dict(
            shape, outputs={"dh": o}, bitwise_repeatable=same, ok=ok))
        del dh, want, alone, p_ws
        if timed is None:
            timed = (x, head, lab, lse, coef)
        else:
            del x, head, lab, lse, coef
        torch.cuda.empty_cache()

    # -- timing at the train step's shapes ----------------------------------
    rows = []

    def row(op, route, source, shape, dt, kernel, plain, extra=None):
        b_ms, b_by, nbytes, ops = bound(kernel)
        r = {"name": op, "route": route, "source": source,
             "replaces": FT_REPLACES[op], "shape": shape, "dtype": dt,
             "max_abs_err": max_err[op], "ms": cold_ms(kernel),
             "plain_ms": cold_ms(plain, iters=10), "bound_ms": b_ms,
             "bound_by": b_by, "bytes": nbytes, "operations": ops,
             "library_ms": None, "ok": True}
        r.update(extra or {})
        rows.append(r)

    x, g, delta = rn(T, D), rn(T, D), rn(T, D)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(bf16)
    n = x.numel()
    # the library's fused RMSNorm backward on the same inputs, its rstd
    # from the library's forward outside the timed window (never called by
    # the port)
    lib = getattr(torch.ops.aten, "_fused_rms_norm_backward", None)
    lib_ms = None
    if lib is not None:
        _, rstd = torch.ops.aten._fused_rms_norm(x, [D], w, eps)
        lib_ms = cold_ms(lambda: lib(g, x, [D], rstd, w, [True, True]))
        del rstd
    row("rms_norm_bwd", "triton", RMS_SOURCE, [T, D], "bfloat16",
        lambda: kn.rms_norm_bwd_triton(x, w, g, eps),
        lambda: kn.rms_bwd_ref(eps, (x, w), g),
        {"library": "torch.ops.aten._fused_rms_norm_backward"
                    if lib is not None else "none in this torch",
         "library_ms": lib_ms,
         "parent_ms": cold_ms(lambda: parent_rms_norm_bwd(x, w, g, eps))})
    row("residual_rms_norm_fwd", "triton", RMS_SOURCE, [T, D], "bfloat16",
        lambda: kn.residual_rms_norm_fwd_triton(delta, x, w, eps),
        lambda: kn.residual_rms_norm_fwd_ref(delta, x, w, eps),
        {"library": "none"})
    del x, g, delta
    g, u, d = rn(T, F, scale=2), rn(T, F), rn(T, F)
    n = g.numel()
    row("swiglu_fwd", "triton", FT_TRITON_SOURCE, [T, F], "bfloat16",
        lambda: kft.swiglu_fwd_triton(g, u),
        lambda: kft.swiglu_fwd_ref(g, u),
        {"library": "none (F.silu(g) * u is two calls)"})
    row("swiglu_bwd", "triton", FT_TRITON_SOURCE, [T, F], "bfloat16",
        lambda: kft.swiglu_bwd_triton(g, u, d),
        lambda: kft.swiglu_bwd_ref(g, u, d), {"library": "none"})
    del g, u, d
    torch.cuda.empty_cache()
    x, head, lab, lse, coef = timed
    V = head.shape[1]
    # the backward's pieces on their own, on the P dx's call keeps
    _, ws = kft.linear_ce_bwd_dx_cuda(x, head, lab, lse, coef, keep_p=True)
    ops = kft.ce_operands(x, head)
    sdx = kft.ce_spec("linear_ce_bwd_dx", T, D, V, "bfloat16", "bfloat16")
    sdh = kft.ce_spec("linear_ce_bwd_dh", T, D, V, "bfloat16", "bfloat16",
                      p_given=True)
    dx_out, dh_out = torch.empty_like(x), torch.empty(D, V, dtype=bf16,
                                                      device="cuda")
    wp = kft.ce_workspace(x, T, V)
    pieces = {
        "p_pass_ms": cold_ms(lambda: kft.ce_p_pass(sdx, ops, lab, lse, coef,
                                                   wp, 0, T)),
        "dx_product_ms": cold_ms(lambda: kft.ce_dx_product(sdx, ops, ws,
                                                           dx_out)),
        "dh_product_ms": cold_ms(lambda: kft.ce_dh_product(sdh, ops, ws,
                                                           dh_out, None, 0))}

    def pair():
        _, p = kft.linear_ce_bwd_dx_cuda(x, head, lab, lse, coef,
                                         keep_p=True)
        kft.linear_ce_bwd_dh_cuda(x, head, lab, lse, coef, p=p)
    pieces["pair_ms"] = cold_ms(pair)
    pieces["dh_alone_ms"] = cold_ms(lambda: kft.linear_ce_bwd_dh_cuda(
        x, head, lab, lse, coef))
    # the cuBLAS yardstick on the same products (never called by the
    # port): bf16 once, and as the hi + lo pair
    hi, lo = ws.hi[:, :V], ws.lo[:, :V]
    yard = {"S_ms": cold_ms(lambda: x @ head),
            "dx_bf16_ms": cold_ms(lambda: (x @ head, hi @ head.T)),
            "dx_hilo_ms": cold_ms(lambda: (x @ head, hi @ head.T,
                                           lo @ head.T)),
            "dh_bf16_ms": cold_ms(lambda: x.T @ hi),
            "dh_hilo_ms": cold_ms(lambda: (x.T @ hi, x.T @ lo))}
    del dx_out, dh_out, wp, hi, lo
    shape = {"T": T, "D": D, "V": V, "head": "untied"}
    note = ("none: no single PyTorch call; products_ms is cuBLAS (bf16) "
            "on the same products")
    # the forward over the tied head (the embedding [V, D] seen
    # transposed) at the same shape, on the same body
    emb = rn(V, D, scale=0.02)
    tied_ms = cold_ms(lambda: kft.linear_ce_fwd_cuda(x, emb.T, lab))
    del emb
    row("linear_ce_fwd", "cuda", CE_SOURCE, shape, "bfloat16",
        lambda: kft.linear_ce_fwd_cuda(x, head, lab),
        lambda: kft.ce_fwd_ref(x, head, lab),
        {"library": note, "products_ms": yard["S_ms"], "tied_ms": tied_ms,
         "plan": launch_plan(lambda: kft.linear_ce_fwd_cuda(x, head, lab))})
    row("linear_ce_bwd_dx", "cuda", CE_SOURCE, shape, "bfloat16",
        lambda: kft.linear_ce_bwd_dx_cuda(x, head, lab, lse, coef),
        lambda: kft.ce_bwd_dx_ref(x, head, lab, lse, coef),
        {"library": note, "products_ms": yard["dx_bf16_ms"],
         "products_hilo_ms": yard["dx_hilo_ms"],
         "p_pass_ms": pieces["p_pass_ms"],
         "product_ms": pieces["dx_product_ms"],
         "pair_ms": pieces["pair_ms"], "plan": launch_plan(
             lambda: kft.linear_ce_bwd_dx_cuda(x, head, lab, lse, coef))})
    row("linear_ce_bwd_dh", "cuda", CE_SOURCE, shape, "bfloat16",
        lambda: kft.linear_ce_bwd_dh_cuda(x, head, lab, lse, coef, p=ws),
        lambda: kft.ce_bwd_dh_ref(x, head, lab, lse, coef),
        {"library": note, "products_ms": yard["dh_bf16_ms"],
         "products_hilo_ms": yard["dh_hilo_ms"],
         "product_ms": pieces["dh_product_ms"],
         "alone_ms": pieces["dh_alone_ms"], "given_p": True,
         "plan": launch_plan(lambda: kft.linear_ce_bwd_dh_cuda(
             x, head, lab, lse, coef, p=ws))})
    del x, head, lab, lse, coef, timed, ws
    torch.cuda.empty_cache()
    emit({"phase": "fused_train_kernels", "gpu": gpu, "cases": cases,
          "timed": {r["name"]: {k: r.get(k) for k in (
              "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "parent_ms", "tied_ms", "products_ms", "products_hilo_ms",
              "p_pass_ms", "product_ms", "pair_ms", "alone_ms") if k in r}
              for r in rows}})
    return rows


def _params_like(base):
    """A fresh copy of a parameter tree."""
    return {k: _params_like(v) if isinstance(v, dict) else v.clone()
            for k, v in base.items()}


def _plain_ce_dx(x2, head, labels, lse, coef, chunk_rows=None,
                 keep_p=False):
    """linear_ce_bwd_dx_cuda's call, on the plain version (no P kept)."""
    from paddle_tpu_torch.ops.kernels import fused_train as kft
    dx = kft.ce_bwd_dx_ref(x2, head, labels, lse, coef)
    return (dx, None) if keep_p else dx


def _plain_ce_dh(x2, head, labels, lse, coef, p=None, chunk_rows=None):
    """linear_ce_bwd_dh_cuda's call, on the plain version."""
    from paddle_tpu_torch.ops.kernels import fused_train as kft
    return kft.ce_bwd_dh_ref(x2, head, labels, lse, coef)


@contextlib.contextmanager
def plain_kernels(fused_train):
    """The train step's kernels replaced by their plain versions on the
    card: flash attention and AdamW
    through their registry pins; for the default route also the seven
    fused-train kernels (RMSNorm backward, residual + RMSNorm, SwiGLU,
    linear CE), whose wrappers are swapped for their plain versions for
    the ``with`` block (the Functions look them up at each call). The
    RMSNorm forward stays the kernel on both sides."""
    from paddle_tpu_torch.ops.kernels import fused_train as kft
    from paddle_tpu_torch.ops.kernels import norms as kn
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    swaps = [] if fused_train == "ref" else [
        (kn, "rms_norm_bwd_triton",
         lambda x, w, g, eps: kn.rms_bwd_ref(eps, (x, w), g)),
        (kn, "residual_rms_norm_fwd_triton", kn.residual_rms_norm_fwd_ref),
        (kft, "swiglu_fwd_triton", kft.swiglu_fwd_ref),
        (kft, "swiglu_bwd_triton", kft.swiglu_bwd_ref),
        (kft, "linear_ce_fwd_cuda", kft.ce_fwd_ref),
        (kft, "linear_ce_bwd_dx_cuda", _plain_ce_dx),
        (kft, "linear_ce_bwd_dh_cuda", _plain_ce_dh)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        with KERNELS.force("flash_attention", "unfused"), \
                KERNELS.force("fused_adamw", "unfused"):
            yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _route_run(cfg, base, toks, labels):
    """Loss and every gradient, then 3 Trainer steps, of ``cfg``'s route;
    the kernels' launches over both."""
    import torch
    from paddle_tpu_torch.distributed import Trainer
    from paddle_tpu_torch.distributed.trainer import tree_leaves
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernels
    kernels.reset_launches()
    params = _params_like(base)
    leaves = [v.requires_grad_(True) for v in tree_leaves(params)]
    loss = llama.loss_fn(params, toks, labels, cfg)
    grads = torch.autograd.grad(loss, leaves)
    tr = Trainer(lambda p, t, l: llama.loss_fn(p, t, l, cfg), lr=1e-4)
    state = tr.init_state(_params_like(base))
    losses = []
    for _ in range(3):
        state, m = tr.step(state, toks, labels)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    return {"loss": loss.detach(), "grads": grads, "trajectory": losses,
            "params": state.params, "fused": tr._fused,
            "launches": kernels.launches()}


def _route_diff(a, b, base, floor=0.0):
    """Loss (relative), gradients (of the largest magnitude), trajectory
    (relative, past an absolute ``floor``) and updates (of the update's L2
    norm) of run ``a`` against run ``b``."""
    import torch
    from paddle_tpu_torch.distributed.trainer import tree_leaves
    with torch.no_grad():
        grad = max(float((x - y).abs().max() / y.abs().max().clamp_min(
            1e-30)) for x, y in zip(a["grads"], b["grads"]))
        upd = max(float((pa - pb).norm() / (pb - b0).norm().clamp_min(1e-30))
                  for pa, pb, b0 in zip(tree_leaves(a["params"]),
                                        tree_leaves(b["params"]),
                                        tree_leaves(base)))
    return {"loss_rel_err": abs(float(a["loss"]) - float(b["loss"]))
            / abs(float(b["loss"])),
            "grad_err_over_max": grad,
            "trajectory_rel_err": max(max(abs(x - y) - floor, 0.0) / abs(y)
                                      for x, y in zip(a["trajectory"],
                                                      b["trajectory"])),
            "trajectory_floor": floor,
            "update_err_over_norm": upd}


def _diff_ok(d):
    return (d["loss_rel_err"] <= 1e-5 and d["grad_err_over_max"] <= 1e-4
            and d["trajectory_rel_err"] <= 1e-5
            and d["update_err_over_norm"] <= 1e-3)


def train_parity_phase(gpu):
    """LLaMA at 7B widths, 2 layers, f32 (TF32 off), b 2, s 256, on both
    routes: "ref" and the default (``fused_train=None``). Each
    route's loss and every gradient through its kernels against the same
    route with every kernel replaced by its plain version (loss within
    1e-5 relative; each gradient within 1e-4 of its largest magnitude:
    4096-term products summed in another order); then 3 Trainer steps each
    way (losses within 1e-5 relative, and each parameter's update within
    1e-3 of the plain update's L2 norm: an element whose gradient is ~0 may
    flip the sign of its first Adam step, so no elementwise bound holds).
    The default route's kernel run is held against the "ref" route's by
    the same bounds. On the default route (and across routes) the
    trajectory's bound has an absolute floor of a quarter of one f32 ulp
    of the first step's loss: the loss is a mean of lse - pick, terms of
    that size (~11 here, lse ~ ln V at the random start), and by the third
    step it has fallen ~4e4 times below them, so a relative bound alone
    would ask for 0.003 ulps of the terms (the seven kernels sum in
    another order than their plain versions). The mean of 512 terms that
    each differ by about an ulp in no common direction differs by about
    ulp / sqrt(512) = 0.044 ulp; the third step's difference reads 0.055
    ulp, and the floor is about five times that. The "ref" route's runs
    share everything but flash attention and AdamW, and keep the bound
    without a floor."""
    import torch
    from paddle_tpu_torch.models import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_ref = train_config(layers=2, dtype=torch.float32)
    cfg_def = train_config(layers=2, dtype=torch.float32, fused_train=None)
    base = init_params(cfg_ref, seed=2)
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg_ref.vocab_size, (2, 256)),
                           device="cuda")
    labels = torch.roll(toks, -1, -1)
    route_ops = {"ref": FLASH_OPS + ("fused_adamw",),
                 "default": FLASH_OPS + ("fused_adamw",) + FT_OPS}
    res = {"phase": "train_parity", "gpu": gpu, "dtype": "float32",
           "layers": 2, "batch": 2, "seq": 256, "routes": {}}
    runs = {}
    ok = True
    floor = 0.0
    for route, cfg in (("ref", cfg_ref), ("default", cfg_def)):
        kern = _route_run(cfg, base, toks, labels)
        with plain_kernels(cfg.fused_train):
            plain = _route_run(cfg, base, toks, labels)
        d = _route_diff(kern, plain, base, floor)
        floor = 0.25 * float(np.spacing(np.float32(
            plain["trajectory"][0])))
        ops = route_ops[route]
        r = dict(d, fused_train=cfg.fused_train,
                 fused_optimizer=kern["fused"],
                 loss_kernels=float(kern["loss"]),
                 loss_plain=float(plain["loss"]), grads=len(kern["grads"]),
                 trajectory_kernels=kern["trajectory"],
                 trajectory_plain=plain["trajectory"],
                 launches_kernel_run={k: kern["launches"][k] for k in ops},
                 launches_plain_run={k: plain["launches"][k] for k in ops})
        r["ok"] = (_diff_ok(d) and kern["fused"]
                   and all(kern["launches"][k] > 0 for k in ops)
                   and not any(plain["launches"][k] for k in ops))
        ok = ok and r["ok"]
        res["routes"][route] = r
        runs[route] = kern
        del plain
        torch.cuda.empty_cache()
    d = _route_diff(runs["default"], runs["ref"], base, floor)
    res["default_vs_ref"] = dict(d, ok=_diff_ok(d))
    res["ok"] = ok and res["default_vs_ref"]["ok"]
    emit(res)
    if not res["ok"]:
        raise AssertionError("train parity failed")
    del base, runs
    torch.cuda.empty_cache()


def train_phase(gpu, fused_train):
    """The 1.07B-h4096 rung through ``Trainer.step`` on the route
    ``fused_train`` picks (None: the default route, the main path; "ref"
    beside it); see the module docstring. Returns the launch counts of
    the timed steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.analysis.kernel_rules import PEAK_OPS_PER_S
    from paddle_tpu_torch.distributed import Trainer
    from paddle_tpu_torch.distributed.trainer import tree_leaves
    from paddle_tpu_torch.models import init_params, llama
    from paddle_tpu_torch.ops import kernels
    cfg = train_config(fused_train=fused_train)
    L, B, S = cfg.num_hidden_layers, TRAIN_RUNG["batch"], TRAIN_RUNG["seq"]
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    n_params = sum(v.numel() for v in tree_leaves(params))
    tr = Trainer(lambda p, t, l: llama.loss_fn(p, t, l, cfg), lr=1e-4,
                 moment_dtype=torch.bfloat16)
    state = tr.init_state(params)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           device="cuda")
    labels = torch.roll(toks, -1, -1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = tr.step(state, toks, labels)          # warm-up
    losses = [float(m["loss"])]
    warm_s = time.perf_counter() - t0
    tr.reset_metrics()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(TRAIN_STEPS)]
    step_losses = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for start, end in events:
        start.record()
        state, m = tr.step(state, toks, labels)
        end.record()
        step_losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    losses += [float(x) for x in step_losses]
    step_ms = [s.elapsed_time(e) for s, e in events]
    wall_ms = wall * 1e3 / TRAIN_STEPS
    tps = B * S / (wall_ms / 1e3)
    flops_per_tok = 6 * n_params + 6 * L * S * cfg.hidden_size
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = tr.step(state, toks, labels)
        torch.cuda.synchronize()
    kern, groups = _device_groups(prof, 1)
    device_ms = sum(ms for ms, _ in kern.values())
    n = TRAIN_STEPS
    want = dict.fromkeys(kernels.WRAPPERS, 0)
    want.update({"flash_attention_fwd": 2 * L * n,
                 "flash_attention_bwd_dq": L * n,
                 "flash_attention_bwd_dkv": L * n, "fused_adamw": n})
    if fused_train == "ref":
        want["rms_norm_fwd"] = (4 * L + 1) * n
    else:
        # the post-attention norm moves into the residual kernel; remat
        # runs each layer's forward twice
        want.update({"rms_norm_fwd": (2 * L + 1) * n,
                     "residual_rms_norm_fwd": 2 * L * n,
                     "rms_norm_bwd": (2 * L + 1) * n,
                     "swiglu_fwd": 2 * L * n, "swiglu_bwd": L * n,
                     "linear_ce_fwd": n, "linear_ce_bwd_dx": n,
                     "linear_ce_bwd_dh": n})
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:12]
    res = {"phase": "train", "gpu": gpu, "rung": TRAIN_RUNG["label"],
           "model": {"vocab": cfg.vocab_size, "D": cfg.hidden_size,
                     "F": cfg.intermediate_size,
                     "H": cfg.num_attention_heads,
                     "KV": cfg.num_key_value_heads, "layers": L},
           "params": n_params, "batch": B, "seq": S,
           "dtype": "bfloat16 weights, float32 norms, bfloat16 moments",
           "fused_train": cfg.fused_train, "remat": cfg.remat,
           "fused_optimizer": tr._fused, "setup_s": round(setup_s, 3),
           "warmup_s": round(warm_s, 3), "losses": losses,
           "step_ms_events": [round(x, 3) for x in step_ms],
           "step_ms_mean": round(float(np.mean(step_ms)), 3),
           "wall_ms_per_step": round(wall_ms, 3),
           "tokens_per_sec": round(tps, 1),
           "mfu": round(tps * flops_per_tok / PEAK_OPS_PER_S["bfloat16"],
                        4),
           "mfu_formula": "tokens/s x (6 N + 6 L S D) / 989e12 (bench.py)",
           "peak_memory_gb": round(peak_gb, 3),
           "launches": counts, "launches_per_step": {
               k: counts[k] / n for k in want if counts[k]},
           "profiled_step": {"device_ms": round(device_ms, 3),
                             "busy_share": round(device_ms / wall_ms, 4),
                             "by_group": _rounded(groups),
                             "top_kernels": [
                                 {"name": k[:120], "ms": round(ms, 3),
                                  "launches": round(c, 2)}
                                 for k, (ms, c) in top]}}
    emit(res)
    if tr._fused is not True:
        raise AssertionError("the train phase is not on the fused optimizer")
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"train launches {counts} != {want}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train losses not finite and falling: {losses}")
    del state, params, tr
    torch.cuda.empty_cache()
    return counts, res


# ---------------------------------------------------------------------------
# the kernel-geometry gate on the card: the plans the serving and training
# paths really launch, audited; the cooperative grids and the static shared
# memory the card and ptxas report against the plans; and the gate's
# regression specimen, launched
# ---------------------------------------------------------------------------
# each device kernel of a library (a substring of its mangled name) -> the
# launch it belongs to
PTXAS_KERNELS = {
    "paged_attention": {"paged_attention_decode_kernel":
                        "paged_attention_decode"},
    "fused_decode_block": {"decode_attn_block_kernel": "decode_attn_block",
                           "decode_mlp_block_kernel": "decode_mlp_block",
                           "decode_block_fused_kernel": "decode_block_fused",
                           "decode_block_ring_kernel": "decode_block_fused",
                           "decode_attn_ring_kernel": "decode_attn_block",
                           "decode_mlp_ring_kernel": "decode_mlp_block"},
    "fused_prefill_block": {"prefill_attn_block_kernel":
                            "prefill_attn_block"},
    "flash_attention": {"dkv_kernel": "flash_attention_bwd_dkv",
                        "dq_kernel": "flash_attention_bwd_dq",
                        "dkv_tc_kernel": "flash_attention_bwd_dkv",
                        "dq_tc_kernel": "flash_attention_bwd_dq",
                        "fwd_kernel": "flash_attention_fwd",
                        "fwd_tc_kernel": "flash_attention_fwd"},
    "linear_ce": {"ce_fwd_gemm_kernel": "linear_ce_fwd",
                  "ce_fwd_stats_combine": "linear_ce_fwd",
                  "ce_fwd_kernel": "linear_ce_fwd",
                  "ce_fwd_combine": "linear_ce_fwd",
                  "ce_gemm_kernel": ("linear_ce_bwd_dx", "linear_ce_bwd_dh"),
                  "ce_f32_gemm_kernel": ("linear_ce_bwd_dx",
                                         "linear_ce_bwd_dh")},
}
DEMO_REPLACES = "paddle_tpu/analysis/kernel_catalog.py:864"


def audit_phase(gpu, stream_specs):
    """The gate over the launches the card made: ``stream_specs`` maps a
    path ("serving_default", "train_default") to the plans captured while
    it ran and its launch counts; every kernel the counts saw launch must
    have a captured plan, every distinct plan is audited (0 findings), so
    is the whole catalog (the CPU gate, here too). Each cooperative plan's
    grid, which the wrapper took from the launcher's occupancy query on
    the card, must equal the catalog's assumption (132 SMs times the blocks
    an SM holds), and ptxas's static shared memory of every device kernel
    must be at most its launch's declared figure."""
    from paddle_tpu_torch.analysis.kernel_catalog import (audit_kernels,
                                                          audit_specs,
                                                          kernel_cases,
                                                          capture_case)
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels.fused_decode_block import assumed_grid
    t0 = time.perf_counter()
    paths, grids = {}, {}
    for path, (specs, counts) in stream_specs.items():
        distinct = list({id(sp): sp for sp in specs}.values())
        launched = sorted(k for k, n in counts.items()
                          if isinstance(n, int) and n)
        rep = audit_specs(distinct, f"{path}@card", launched)
        paths[path] = {"launches": len(specs), "distinct_plans":
                       len(distinct), "kernels": rep.meta["kernels"],
                       "findings": [f.to_dict() for f in rep.findings]}
        if rep.findings or not distinct:
            emit({"phase": "audit", "gpu": gpu, "paths": paths})
            raise AssertionError(f"the gate found {len(rep.findings)} "
                                 f"finding(s) in {path}'s plans")
        for sp in distinct:
            if sp.cooperative:
                want = assumed_grid(sp.name, sp.dyn_smem, sp.blocks_per_sm)
                grids[(path, sp.name, sp.dyn_smem, sp.grid[0])] = {
                    "path": path, "kernel": sp.name, "smem": sp.dyn_smem,
                    "card": sp.grid[0], "assumed": want,
                    "ok": sp.grid[0] == want}
    grids = list(grids.values())
    catalog = audit_kernels()
    n_catalog = sum(len(r.findings) for r in catalog)
    declared = {}
    for case in kernel_cases():
        specs, err = capture_case(case)
        if err is not None:
            raise AssertionError(f"{case.name} failed to capture: {err}")
        for sp in specs:
            declared[sp.name] = max(declared.get(sp.name, 0), sp.static_smem)
    smem = []
    for lib, kernels in PTXAS_KERNELS.items():
        report = _ptxas(_build.library_path(lib).with_suffix(".log"))
        for fn, lines in report.items():
            launch = next((v for k, v in kernels.items() if k in fn), None)
            if launch is None:
                raise AssertionError(f"ptxas kernel {fn} of lib{lib} belongs "
                                     "to no launch of the catalog")
            for name in (launch if isinstance(launch, tuple) else (launch,)):
                got = _static_smem(lines)
                smem.append({"kernel": fn[:90], "launch": name,
                             "ptxas_static": got,
                             "declared": declared[name],
                             "ok": got <= declared[name]})
    ok = (all(g["ok"] for g in grids) and all(m["ok"] for m in smem)
          and n_catalog == 0)
    res = {"phase": "audit", "gpu": gpu, "paths": paths,
           "cooperative_grids": grids, "catalog_cases": len(catalog),
           "catalog_findings": n_catalog, "static_smem": smem, "ok": ok,
           "seconds": round(time.perf_counter() - t0, 3)}
    emit(res)
    if not ok:
        raise AssertionError("audit phase: a grid, a static shared-memory "
                             "figure or the catalog disagrees")
    return res


def demo_phase(gpu):
    """The gate's regression specimen on the card: decode_mlp_block's
    kernel under the floor-divided plan (``demo_prefix_mlp_block_cuda``) at
    the JAX specimen's geometry (B 2, D 32, F 96, tile 64) in bf16. It
    must hold its plain version (the MLP over the first 64 intermediate
    columns) at decode_mlp_block's bf16 tolerance (bf16_close), relaunch
    bit for bit, differ from the full MLP by more than ten times that
    tolerance (the dropped columns are real), and its captured plan must
    give exactly the three GRID_FLOOR_DROP findings on wg, wu and wd.
    Timed beside its bound and its plain version; the launches are this
    phase's (no path runs it)."""
    import torch
    from paddle_tpu_torch.analysis.kernel_catalog import (DEMO_SHAPE,
                                                          audit_specs)
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    from paddle_tpu_torch.ops.kernels._launch import capture_kernel_launches
    B, D, F = (DEMO_SHAPE[k] for k in ("B", "D", "F"))
    tile = fdb.DEMO_TILE
    gen = torch.Generator(device="cuda").manual_seed(10)
    bf16 = torch.bfloat16

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * std).to(bf16)
    x = rn(B, D)
    nw = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(bf16)
    args = (x, nw, rn(D, F, std=0.3), rn(D, F, std=0.3), rn(F, D, std=0.3))
    wrapper = fdb.demo_prefix_mlp_block_cuda
    wrapper.launches = 0
    with capture_kernel_launches() as specs:
        got = wrapper(*args)
    again = wrapper(*args)
    want = fdb.demo_prefix_mlp_block_ref(*args)
    full = fdb.mlp_block_ref(*args)
    torch.cuda.synchronize()
    launches = wrapper.launches
    held, worst = bf16_close(got, want)
    _, worst_full = bf16_close(got, full)
    rep = audit_specs(specs, "demo_prefix_mlp_block@card",
                      ("demo_prefix_mlp_block",))
    sites = sorted(f.site.split("/")[1] for f in rep.findings)
    codes = {f.code for f in rep.findings}
    case = {"shape": {"B": B, "D": D, "F": F, "tile": tile},
            "dtype": "bfloat16", "plan": specs[0].plan,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "worst_in_tol_units": worst / 2 ** -6,
            "vs_full_max_abs": float((got.float() - full.float()).abs()
                                     .max()),
            "vs_full_in_tol_units": worst_full / 2 ** -6,
            "bitwise_repeatable": bool(torch.equal(got, again)),
            "findings": [(f.code, f.site,
                          f.detail.get("first_missing_element"))
                         for f in rep.findings]}
    case["ok"] = (held and case["bitwise_repeatable"]
                  and worst_full > 10 * 2 ** -6
                  and codes == {"GRID_FLOOR_DROP"}
                  and sites == ["wd", "wg", "wu"])
    emit({"phase": "demo", "gpu": gpu, "case": case})
    if not case["ok"]:
        raise AssertionError(f"demo_prefix_mlp_block: {case}")
    b_ms, b_by = bound(lambda: wrapper(*args))[:2]
    return {"name": "demo_prefix_mlp_block", "route": "cuda",
            "source": FUSED_SOURCE, "replaces": DEMO_REPLACES,
            "shape": case["shape"], "dtype": "bfloat16",
            "max_abs_err": case["max_abs_err"],
            "ms": cold_ms(lambda: wrapper(*args)),
            "plain_ms": cold_ms(lambda: fdb.demo_prefix_mlp_block_ref(
                *args)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": "none: no single PyTorch call computes the block",
            "launches": launches, "launches_route": "demo phase",
            "ok": True}


def prefix_only(gpu):
    """``python3 chip_smoke.py prefix``: the build and the prefix phase
    alone, both sizes (the serving size over the serving phases' seeded
    tree)."""
    import torch
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    build_kernels()
    prefix_phase(gpu, "parity")
    prefix_phase(gpu, "serving", init_params(LLAMA_7B, seed=0))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main(argv=()):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    import paddle_tpu_torch  # noqa: F401  (fails outside the repository)
    from paddle_tpu_torch.models import LLAMA_7B, init_params
    from paddle_tpu_torch.ops.kernels._launch import capture_kernel_launches
    t_start = time.perf_counter()
    gpu = gpu_line()
    if list(argv) == ["prefix"]:
        return prefix_only(gpu)
    if list(argv) == ["disagg"]:
        return disagg_only(gpu)
    if list(argv) == ["obs"]:
        return obs_only(gpu)
    if argv:
        print(f"chip_smoke: unknown arguments {list(argv)}; run it with "
              "none, or with 'prefix', 'disagg' or 'obs'", file=sys.stderr)
        return 2
    build_kernels()
    rows = [paged_phase(gpu), rms_phase(gpu), fused_attn_phase(gpu),
            *fused_mlp_phase(gpu), block_phase(gpu), prefill_attn_phase(gpu)]
    quant_rows = quant_kernel_phases(gpu)
    kv8_rows = kv8_kernel_phases(gpu)
    tp_rows = tp_kernel_phases(gpu)
    ln_row = layer_norm_phase(gpu)
    demo_row = demo_phase(gpu)
    train_rows = flash_phase(gpu) + [adamw_phase(gpu,
                                                 flat_size(train_config()))]
    # this slice: the flash kernels' optional bodies, and the attention
    # functionals' paths that run them (the main path of this slice)
    body_rows = flash_bodies_phase(gpu)
    flash_keep_readout_phase(gpu)
    path_counts = [varlen_path_phase(gpu), bias_path_phase(gpu)]
    train_rows += fused_train_phase(gpu)
    train_parity_phase(gpu)
    # the plans of the default train route's launches (the gate audits
    # them after the serving phases); the backward's run on autograd's
    # device thread
    with capture_kernel_launches(all_threads=True) as train_specs:
        train_counts, _ = train_phase(gpu, None)
    ref_counts, _ = train_phase(gpu, "ref")
    for wq in (None, "int8", "int4"):
        parity_phase(gpu, wq)
    kv8_parity_phase(gpu)
    tp_parity_phase(gpu)
    # this slice's main path: every route's decode step captured once and
    # replayed, against an eager twin, at the parity size
    graph_phase(gpu, "parity")
    # this slice's main path: the radix prefix cache, its host tier and
    # generate_paged, first at the parity size
    prefix_counts = prefix_phase(gpu, "parity")
    # this slice's main path: disaggregated prefill/decode serving and the
    # fleet router, first at the parity size
    disagg_phase(gpu, "parity")
    # this slice's main path: the observability and telemetry harness on
    # the engines and the trainer, first at the parity size
    obs_phase(gpu, "parity")
    params = init_params(LLAMA_7B, seed=0)
    counts, tokens = {}, {}
    prompts = None
    for route in ROUTES:
        with capture_kernel_launches() as specs:
            counts[route], eng, prompts, tokens[route] = serving_phase(
                gpu, params, route)
        if route == "default":
            serving_specs = specs
            # the chunk kernels' launches by chunk rows (the buckets)
            bucket_launches = {
                op: {f"{P} rows": sum(sp.name == op and
                                      sp.operand("x").shape[0] == P
                                      for sp in specs) for P in (32, 128)}
                for op in ("decode_mlp_block", "prefill_attn_block")}
        profile_phase(gpu, eng, route)
        del eng
    routes_phase(gpu, params, prompts, tokens)
    # and at the serving size, on the serving phases' tree
    graph_phase(gpu, "serving", params)
    # and bench.py's prefix stream at the serving size
    prefix_counts.update(prefix_phase(gpu, "serving", params))
    # and the disaggregated engine, the colocated one in turns with it, and
    # bench.py's fleet traffic at the serving size
    disagg_counts = disagg_phase(gpu, "serving", params)
    # and the observed default engine in turns with the plain one, and the
    # observed trainer at the train rung
    obs_counts = obs_phase(gpu, "serving", params)
    audit_phase(gpu, {"serving_default": (serving_specs, counts["default"]),
                      "train_default": (train_specs, train_counts)})
    del serving_specs, train_specs
    # this slice's main path: the weight-quantized routes (a profile of the
    # int8 default route's decode step)
    for route in QUANT_ROUTES:
        counts[route], eng, _, _ = serving_phase(gpu, params, route)
        if route == "int8_default":
            profile_phase(gpu, eng, route)
        del eng
        torch.cuda.empty_cache()
    # this slice's main path: the int8 KV cache on the three routes and
    # under int8 weights (a profile of the kv8 default route's decode step)
    for route in KV8_ROUTES:
        counts[route], eng, _, _ = serving_phase(gpu, params, route)
        if route == "kv8_default":
            profile_phase(gpu, eng, route)
        del eng
        torch.cuda.empty_cache()
    # this slice's main path: tensor-parallel serving, shards colocated on
    # the card (a profile of each psum route's decode step)
    for route in TP_ROUTES:
        counts[route], eng = tp_serving_phase(gpu, params, route)
        if TP_ROUTES[route][1] == "psum":
            profile_phase(gpu, eng, route)
        del eng
        torch.cuda.empty_cache()
    # each kernel's launches on the serving phase of the route that runs
    # it: paged attention on the unfused route, decode_attn_block on the
    # two-stage route, the rest (RMSNorm runs on every route) on the
    # default route, the main path
    home = {"paged_attention_decode": "unfused",
            "decode_attn_block": "two_stage"}
    for row in rows:
        # the prefix phase's serving-size launches (its stream cold, warm
        # and over the host tier, and generate_paged with its int8 cache)
        if row["name"] in ("decode_mlp_block", "decode_block_fused",
                           "prefill_attn_block"):
            row["prefix_launches"] = prefix_counts["launches"][row["name"]]
            # and its disaggregated run's (the serving phase's requests)
            row["disagg_launches"] = disagg_counts[row["name"]]
        if row["name"] in ("decode_mlp_block", "decode_block_fused",
                           "prefill_attn_block", "rms_norm_fwd"):
            # the observed engine's run (the obs phase, serving size)
            row["obs_launches"] = obs_counts["serving"][row["name"]]
        if row["name"] == "decode_mlp_block[tc]":
            # the chunks' MLP on the default route, by bucket
            row["launches"] = counts["default"]["by_body"][
                "decode_mlp_block"]["tc"]
            row["launches_by_bucket"] = bucket_launches["decode_mlp_block"]
            continue
        row["launches"] = counts[home.get(row["name"], "default")][
            row["name"]]
        if row["name"] == "decode_mlp_block":
            # the 8-row body on the two-stage route's decode steps
            row["two_stage_launches"] = counts["two_stage"]["by_body"][
                row["name"]]["cuda_core"]
        if row["name"] == "prefill_attn_block":
            row["launches_by_bucket"] = bucket_launches[row["name"]]
        if row["name"] == "rms_norm_fwd":
            row["train_launches"] = train_counts["rms_norm_fwd"]
            row["ref_train_launches"] = ref_counts["rms_norm_fwd"]
    # the quantized kernels' launches on the quantized routes: the
    # two-stage attention kernel on int8's two-stage route (no int4
    # two-stage route is driven), the rest on each class's default route
    for row in quant_rows:
        name, wd = row["name"].split("[")[0], row["weights"]
        route = (f"{wd}_two_stage" if name == "decode_attn_block"
                 else f"{wd}_default")
        row["launches"] = (counts[route]["by_weight"][name][wd]
                           if route in counts else 0)
        row["launches_route"] = route if route in counts else None
        if name == "decode_mlp_block" and f"{wd}_two_stage" in counts:
            row["two_stage_launches"] = counts[f"{wd}_two_stage"][
                "by_weight"][name][wd]
    rows += quant_rows
    # the int8-pool bodies' launches on the int8-cache routes: the
    # two-stage attention kernel with fp weights on kv8_two_stage, the
    # single-launch and prefill kernels on kv8_default (fp weights) and
    # int8_kv8_default; no int4-weight kv8 route, nor an int8-weight
    # two-stage one, is driven
    for row in kv8_rows:
        name, wd = row["name"].split("[")[0], row["weights"]
        route = {"bfloat16": "kv8_two_stage" if name == "decode_attn_block"
                 else "kv8_default"}.get(wd)
        if wd == "int8" and name != "decode_attn_block":
            route = "int8_kv8_default"
        row["launches"] = counts[route]["by_pool"][name]["int8"] \
            if route else 0
        row["launches_route"] = route
        if name == "decode_attn_block" and wd == "bfloat16":
            row["default_route_launches"] = counts["kv8_default"][name]
        if row["name"] == "prefill_attn_block[kv8]":
            # the prefix phase's int8-cache stream (f32, parity size)
            row["prefix_launches"] = prefix_counts["int8_stream"][
                "by_pool"][name]["int8"]
    rows += kv8_rows
    # the residual=False bodies' launches on the tensor-parallel routes:
    # the tp=1 and tp=2 psum routes (tp2_psum_kv8 for the int8-pool body);
    # no tp=4 route or quantized mesh route is driven, and no route of the
    # JAX package launches prefill_attn_block's residual=False body
    for row in tp_rows:
        op = row["name"].split("[")[0]
        route = {(1, "bfloat16"): "tp1_psum", (2, "bfloat16"): "tp2_psum",
                 (2, "int8"): "tp2_psum_kv8"}.get((row["tp"], row["pools"]))
        if row["weights"] != "bfloat16" or op == "prefill_attn_block":
            route = None
        row["launches"] = (counts[route]["by_residual"][op]["partial"]
                           if route else 0)
        row["launches_route"] = route
    rows += tp_rows
    rows += [ln_row, demo_row]
    for row in train_rows:
        # the training kernels' launches on the default route's timed
        # steps (the main path), and on the "ref" route's
        row["launches"] = train_counts[row["name"]]
        row["ref_train_launches"] = ref_counts[row["name"]]
        # the observed trainer's timed steps (the obs phase)
        row["obs_train_launches"] = obs_counts["train"][row["name"]]
    for row in body_rows:
        # each body class's launches on the varlen and bias path phases, in
        # the classes that hold all of its flags
        op = row["name"].split("[")[0]
        row["launches"] = body_launches(path_counts, row["body"])[op]
        row["launches_route"] = "varlen and bias path phases"
    for row in rows + train_rows + body_rows:
        row["gpu"] = gpu
        # ms and max_abs_err, also under their longer names
        row["kernel_ms"], row["max_err"] = row["ms"], row["max_abs_err"]
    emit({"kernels": rows + train_rows + body_rows,
          "seconds": round(time.perf_counter() - t_start, 1)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
