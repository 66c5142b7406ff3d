"""Continuous-batching serving engine over the paged KV cache (port of
``paddle_tpu/inference/serving.py``: one device or a tensor-parallel
mesh; the fused and the unfused decode route, the fused and the unfused
prefill chunk; fp or int8 pools).

- a fixed-capacity SLOT TABLE: every decode step runs over all
  ``capacity`` slots. Inactive slots are padded -- seq_len 0, block table
  pointing at the reserved scratch page 0 -- so their K/V write lands on
  a page no live sequence reads, and their attention output is zero.
- BUCKETED CHUNKED PREFILL: a new request's prompt runs in chunks of at
  most the largest bucket, padded to a bucket, interleaved with decode
  steps. The fused chunk (``_fused_prefill_forward``) runs per layer the
  ``prefill_attn_block`` kernel over the request's pages, writes the
  chunk's own K/V into the pools and runs the ``decode_mlp_block`` kernel
  over its rows. The verbatim unfused chunk gathers the request's pages
  into a dense [L, 1, MB*BS, KV, hd] view, runs ``cached_forward``'s math
  (that of ``generate``'s prefill, as ``_tp_cached_forward`` over one
  "gather" shard: the same op sequence) and scatters the whole view back
  through the request's WRITE table. Both chunks write through the WRITE
  table, the read table with the prefix cache's shared pages sent to
  scratch page 0: a shared page never receives a prefill write. Padded
  table entries and pad rows go to page 0 too, so the duplicate writes of
  the in-place scatters (``index_put_``) all land on the scratch page.
- RADIX PREFIX CACHE (``prefix_cache=True``, ``inference/prefix_cache.py``):
  at admission a prompt longest-prefix matches the tree (capped at S-1
  tokens), its full matched pages join its table shared in place, a
  matched partial tail is COW-forked (one page copied on the device,
  ``make_page_copier``), and only the suffix prefills. The prompt is
  indexed when its prefill completes and again, with the generated
  tokens, when the request finishes. The pages are host bookkeeping, so
  neither the captured decode step nor a bucket's chunk route changes
  with a hit: shared pages reach the decode step through its table
  buffer. It works over int8 pools (the engine's static scales) and
  under a mesh (page indices are global). ``kv_offload=True`` (or an int
  host-page budget) adds the host tier: eviction spills pages to pinned
  host memory in windows of ``_OFFLOAD_WINDOW`` pages, without a host
  sync, and a hit restores them byte for byte (``_spill_pages``,
  ``_restore_pages``).
- SLOT RECYCLING, priority/deadline admission and preemption with
  bit-identical resume, as in the JAX package.
- INT8 CACHE (``cache_dtype="int8"``): the pools store int8 with static
  per-layer, per-head f32 scales, calibrated once, in ``_admit``, from
  the first admitted prompt before its first chunk (padded with token 0
  to its bucket, as the JAX engine pads it: the absmax covers the pad
  rows too). The fused chunk and the decode kernels read int8 pages and
  the pool writes quantize; the verbatim chunk dequantizes its dense view
  to the model type and quantizes it back on the way out (exact for the
  positions it did not write); the unfused decode step dequantizes after
  its gather. Pool bytes halve against bf16.
- TENSOR PARALLELISM (``mesh=ServingMesh(...)`` or an int tp,
  ``inference/tp.py``): the weights, the pools' KV heads and the
  per-slot attention split over the mesh's shards, one process driving
  every shard on its device (devices may repeat: colocated shards). The
  page tables stay global. The "psum" placement's decode step runs
  ``decode_attn_block`` and ``decode_mlp_block`` per shard with
  ``residual=False`` and sums the parts; "gather" runs the single-device
  composition on gathered heads and columns. The prefill chunk is the
  verbatim one over each shard's dense local view (a tp=1 "psum" mesh
  keeps the fused chunk, as in the JAX engine); an int8 cache calibrates
  through the placement's own prefill forward, each shard over its own
  KV heads. ``weight_quant`` with tp > 1, ``fused_decode="block"`` under
  any mesh and "pallas" under "gather" are refused with the JAX engine's
  reasons; ``metrics()["mesh"]`` describes the mesh.

Each step does admission, one prefill chunk and one decode step; the one
host sync per decode step is the read of the sampled tokens, where the
host detects EOS / length-done and recycles slots, and a request's last
prefill chunk syncs on its first token.

The decode step follows ``fused_decode`` as in the JAX engine. The
default ("auto", also None/True) runs ``_fused_decode_step`` through the
registry: on CUDA per layer the single-launch ``decode_block_fused``
kernel where its predicate takes the shapes (at LLaMA-7B it does, where
the TPU's refuses), else the ``decode_attn_block`` and
``decode_mlp_block`` kernels (a two-stage predicate that refuses makes the
constructor raise with its reason); on the CPU the unfused composition;
``decode_variant`` says which. "block" forces the single-launch kernel
and "pallas" the two-stage kernels (both refused on the CPU), "ref" the
composition, False the unfused ``_paged_decode_step`` (RMSNorm in Triton,
paged attention in CUDA C++).
The prefill chunk follows ``fused_prefill`` the same way: the default
("auto", also None/True) runs the fused chunk on CUDA (a refusing
predicate makes the constructor raise) and the verbatim unfused chunk on
the CPU, where dispatch picks the composition, as the JAX engine does
off the TPU; "pallas" forces the fused chunk on the CUDA kernels (and is
refused on the CPU); "ref" and False run the verbatim chunk everywhere;
``prefill_variant`` says which. ``weight_quant`` ("int8"/"int4", or a
tree the PTQ harness already quantized) serves int8/int4 weights as the
JAX engine does: a plain tree is quantized once in the constructor, on
the engine's device; the fused routes run the kernels' quantized-weight
bodies, the unfused routes dequantize before each product;
``weight_quant_variant`` reports it. It composes with the int8 cache.
``observability=True`` (or an ``Observability`` instance) threads the
metrics and tracing harness (``paddle_tpu_torch/observability/``) through
the scheduler as the JAX engine does: request lifecycle events in a
bounded ring, TTFT/TPOT/queue-wait/chunk/step histograms, per-step
allocator and prefix-cache gauges, the retrace watchdog armed by
``reset_metrics()`` (a new CUDA-graph capture after warm-up is a
retrace), stall dumps on a starved ``drain()`` or a blown
``step_deadline_s``, ``export_trace``/``write_timeline``; under a mesh a
bound flight recorder replays the mesh's declared collective inventory
around each step. ``telemetry=True`` (or a ``TelemetryConfig``) adds the
telemetry plane, and implies observability. Every hook is host code
around the programs, never inside a captured graph: ``decode_step_ms``
runs from the dispatch to the step's existing token read (no added
sync), ``prefill_chunk_ms`` is the chunk's host dispatch. Disabled, the
engine holds ``None`` and allocates no event object.
``PADDLE_TPU_CHECK_INVARIANTS=1`` runs the
allocator's and the tree's ``check()`` after every step (the JAX
engine's opt-in self-check).

THE DECODE PROGRAM (the JAX engine's ``_make_decode_fn``, one jitted step
a dispatch): the step's carried state is fixed buffers on the engine's
device (the next tokens, the lengths, the tables, the temperatures, the
logits), allocated once; a change on the host is copied into them, and
the step writes its next tokens and lengths back into them, as
``_DECODE_CARRY`` maps the JAX step's outputs to its arguments. On CUDA
the first decode step runs the step's body eagerly on a stream the engine
owns (the warm-up: kernels built, Triton compiled, the weight ring's
tickets and partials allocated for that stream), the second captures the
body as one CUDA graph and replays it, every later step replays it: one
``cudaGraphLaunch`` a step, sampling included (the engine's generator is
registered with the graph, so every replay draws fresh noise). On the
CPU the body runs eagerly over the same buffers. The graph is keyed by
the registry's force pins (``KERNELS.forced_state()``, in "auto" mode);
every other input of dispatch is fixed when the engine is built. A
replay adds the launches its capture made to the kernels' counts and
reports their plans to an active ``capture_kernel_launches``. A mesh
whose shards sit on more than one card is refused: one graph runs on
one card.

THE PREFILL PROGRAMS (the JAX engine's ``_prefill_fns``, one jitted chunk
a bucket): one program a bucket and key (``(P,) + _prefill_key()``, the
JAX engine's program key), the fused, the verbatim or the mesh chunk as
the bucket's route says, over the bucket's fixed buffers
(``_ChunkBuffers``: tokens, bounds = (pos0, n), read and write tables,
temperature, the sampled token), which each chunk's values are staged
into first. Every position is read from the bounds buffer on the device
(``prefill_attn_block`` reads it too, as the TPU kernel reads its
scalar-prefetch operand), so one graph serves every chunk of a bucket:
at a prefix hit's ``pos0`` off a bucket multiple and with a write table
that sends shared pages to scratch. A bucket's first chunk runs eagerly
(the warm-up), its second is captured and replayed, every later chunk is
one replay; the prefill graphs share one memory pool. A COW fork, a
host-tier restore and the int8 cache's calibration run before the
chunk, outside its graph, on the same stream. A replay reports each
``prefill_attn_block`` launch at its own chunk's (pos0, n).

``metrics()`` has the JAX engine's keys (with observability off or on,
one device or a mesh) plus ``decode_step_ms_mean`` (device time between
CUDA events around the step on the card). ``decode_traces`` counts the decode
program's captures on CUDA (as ``jax.jit`` traces once: 1 an engine) and
its builds on the CPU (1); ``prefill_traces[P]`` counts bucket P's
prefill programs' captures on CUDA and their builds on the CPU (at most
1 a bucket and key, as the JAX engine's traces) and ``calibration_traces``
the int8 cache's calibrations (one an engine), ``offload_traces`` the
host tier's spill and restore paths at their first use (at most 1 each,
as the JAX engine's two programs trace once), and ``kv_spill_bytes`` /
``kv_restore_bytes`` the bytes the tier moved each way (both pools, all
layers, a page). With a prefix cache ``metrics()["prefix_cache"]`` and
``scheduler_snapshot()["prefix_cache"]`` carry the tree's counters;
``offload_metrics()``, ``prefix_summary()`` and ``prefix_cache_version``
are the JAX engine's.
``roofline`` models each decode route's bytes a step against the H100's
memory rate (``observability/roofline.py``), with 1-byte pools for the
int8 cache.
"""
from __future__ import annotations

import os
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import params_to
from ..ops.paged_attention import BlockManager, dequant_cache, quant_cache
from ..observability import Observability, TelemetryConfig, TelemetryPlane
from ..ops.rope import build_rope_cache
from ..quantization.ptq import (ensure_quantized, normalize_weight_quant,
                                weight_quant_mode)
from .admission import AdmissionQueue
from .generation import (GenerationConfig, _check_span,
                         _fused_decode_step, _fused_mode,
                         _fused_prefill_forward, _fused_prefill_mode,
                         _gumbel, _paged_decode_step)
from .program import Program as _Program
from .tp import (ServingMesh, _tp_cached_forward, _tp_decode_step,
                 normalize_mesh)

__all__ = ["Request", "ServingEngine"]

_SCRATCH_SEQ = -1      # BlockManager key owning the reserved page 0
_OFFLOAD_WINDOW = 8    # pages a spill or restore transfer moves at most


def _sample_slots(logits, generator, temps):
    """[C, V] logits -> [C] int32 next tokens. ``temps[i] <= 0`` selects
    greedy for that slot; otherwise temperature sampling (Gumbel-max
    with ``generator``)."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    noisy = (logits / torch.clamp(temps, min=1e-6)[:, None]
             + _gumbel(logits.shape, generator, logits.device))
    sampled = torch.argmax(noisy, dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)


def _pairs(k_pools, v_pools):
    """(k pool, v pool) of each shard (one pair meshless)."""
    if isinstance(k_pools, list):
        return list(zip(k_pools, v_pools))
    return [(k_pools, v_pools)]


def _offload_extract(k_pools, v_pools, idx):
    """The host tier's spill program: the pages ``idx`` [W] of every
    shard's pools, page-major ([W, L, BS, KV, hd], contiguous), one (k, v)
    pair a shard (the JAX engine's spill-side extract). ``idx`` may lie on
    any shard's device: each shard reads its own copy (none on one
    device)."""
    out = []
    for pair in _pairs(k_pools, v_pools):
        i = idx.to(pair[0].device)
        out.append(tuple(p[:, i].transpose(0, 1).contiguous() for p in pair))
    return out


def _offload_insert(k_pools, v_pools, idx, windows):
    """The host tier's restore program: each shard's page-major (k, v)
    ``windows`` written into its pools' pages ``idx``, in place (the JAX
    engine's donated restore-side insert). ``idx`` as in
    :func:`_offload_extract`. -> (k_pools, v_pools)."""
    for pair, win in zip(_pairs(k_pools, v_pools), windows):
        i = idx.to(pair[0].device)
        for pool, buf in zip(pair, win):
            pool[:, i] = buf.transpose(0, 1)
    return k_pools, v_pools


def _collectives_snapshot(counters: Dict, obs: Observability) -> Dict:
    """The structured ``metrics()["collectives"]`` sub-dict (the
    Trainer.metrics contract): per-(op, axis) call/byte counters from
    the adopted dict + latency histograms from the bound recorder.
    ONE definition shared by ServingEngine and DisaggregatedEngine."""
    return {"calls": dict(counters.get("collective_calls", {})),
            "bytes": dict(counters.get("collective_bytes", {})),
            "latency_ms": {
                name[len("collective_"):-len("_ms")]: h.snapshot()
                for name, h in sorted(obs.registry.histograms.items())
                if name.startswith("collective_")
                and name.endswith("_ms")}}


def _drain_loop(eng, max_steps: Optional[int], starve_reason: str,
                starve_error: str) -> int:
    """The drain loop of every engine kind (the JAX package's, shared by
    ServingEngine, DisaggregatedEngine and ServingFleet): step ``eng``
    until it is idle and return the step count. A capped drain that stops
    with work pending sets ``last_drain_truncated``, counts
    ``drain_truncations`` and records a ``drain_truncated`` event; a step
    that runs nothing while work is pending raises ``starve_error``,
    after a stall dump named ``starve_reason`` when the engine has the
    observability harness, unless that step left the engine idle (its
    last request only expired)."""
    n = 0
    eng.last_drain_truncated = False
    while not eng.idle:
        if not eng.step():
            if eng.idle:
                break       # the last step only expired a request
            dump = ""
            if eng._obs is not None:
                dump = eng._obs.stall_dump(starve_reason,
                                           eng.scheduler_snapshot(),
                                           metrics=eng.metrics())
            raise RuntimeError(
                starve_error + (f"; stall dump: {dump}" if dump else ""))
        n += 1
        if max_steps is not None and n >= max_steps:
            if not eng.idle:
                eng.last_drain_truncated = True
                eng.counters["drain_truncations"] += 1
                eng._drain_truncated_event(n)
            break
    return n


@dataclass
class Request:
    """One serving request and its lifecycle record."""
    req_id: int
    prompt: np.ndarray                       # [S] int32
    gen: GenerationConfig
    submit_t: float = 0.0
    priority: int = 1                        # class, LOWER = more urgent
    deadline_s: Optional[float] = None       # admission SLO (vs submit)
    tokens: List[int] = field(default_factory=list)   # generated ids
    ttft: Optional[float] = None             # sec, first token - submit
    admit_t: Optional[float] = None          # absolute, engine clock
    first_token_t: Optional[float] = None    # absolute, engine clock
    finish_t: Optional[float] = None
    done: bool = False
    expired: bool = False                    # deadline passed in queue
    preemptions: int = 0
    # (seq_len, last sampled token): set while a preempted request holds
    # its KV pages but no slot; admission resumes decode from exactly
    # these values, so the resumed run is bit-identical
    resume: Optional[Tuple[int, int]] = None
    # the request's live admission-queue entry, reused by preemption's
    # requeue so the victim keeps its line position
    qentry: Optional[object] = field(default=None, repr=False)

    @property
    def output_ids(self) -> np.ndarray:
        """The prompt followed by the generated ids, int32."""
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.tokens, np.int32)])


class _Slot:
    __slots__ = ("req", "phase", "seq_len", "prefill_pos")

    def __init__(self):
        self.req: Optional[Request] = None
        self.phase = "idle"          # idle | prefill | decode
        self.seq_len = 0             # tokens cached in the pools
        self.prefill_pos = 0         # next prompt position to prefill


class _ChunkBuffers:
    """One bucket's fixed buffers, the prefill program's arguments on the
    engine's device: ``toks`` [1, P] int64, ``bounds`` int32 [2] = (pos0,
    n), the READ ``table`` and WRITE ``wtable`` [MB] (int32 for the fused
    chunk, int64 for the verbatim one), ``temp`` [1] f32 and the sampled
    token ``tok`` [1] int32; ``at``: the staged (pos0, n) on the host.

    :meth:`stage` writes a chunk's values into them on the current stream.
    On CUDA it copies from a ring of two pinned host slots without a host
    sync: chunks that are not a request's last do not sync, so a slot is
    rewritten only once the copy that last read it has run (its event),
    and a queued chunk never sees the next chunk's values."""

    _RING = 2

    def __init__(self, P: int, MB: int, table_dtype, device):
        shapes = {"toks": ((1, P), torch.int64),
                  "bounds": ((2,), torch.int32),
                  "table": ((MB,), table_dtype),
                  "wtable": ((MB,), table_dtype),
                  "temp": ((1,), torch.float32)}
        self.dev = {k: torch.zeros(sh, dtype=dt, device=device)
                    for k, (sh, dt) in shapes.items()}
        self.toks, self.bounds, self.table, self.wtable, self.temp = (
            self.dev[k] for k in shapes)
        self.tok = torch.zeros((1,), dtype=torch.int32, device=device)
        self.at = (0, 1)
        self._ring = ([{k: torch.zeros(sh, dtype=dt, pin_memory=True)
                        for k, (sh, dt) in shapes.items()}
                       for _ in range(self._RING)]
                      if device.type == "cuda" else [])
        self._events = [None] * len(self._ring)
        self._next = 0

    def stage(self, toks, pos0: int, n: int, table, wtable, temp: float):
        vals = {"toks": toks[None], "bounds": (pos0, n), "table": table,
                "wtable": wtable, "temp": (temp,)}
        self.at = (pos0, n)
        if not self._ring:
            for k, v in vals.items():
                self.dev[k].copy_(torch.as_tensor(np.asarray(v)))
            return
        i = self._next
        self._next = (i + 1) % len(self._ring)
        if self._events[i] is not None:
            self._events[i].synchronize()
        for k, h in self._ring[i].items():
            h.numpy()[...] = vals[k]
            self.dev[k].copy_(h, non_blocking=True)
        self._events[i] = torch.cuda.Event()
        self._events[i].record()


class ServingEngine:
    """Continuous-batching engine over a shared paged KV pool.

    ``submit()`` enqueues a request; ``step()`` runs one scheduler
    iteration (admit -> one prefill chunk -> one decode step over all
    live slots); ``drain()`` steps until idle. ``metrics()`` reports
    tokens/s, TTFT, decode-step time and slot utilization.

    ``device``: ``None`` runs on CUDA (and raises without a card);
    ``"cpu"`` runs the kernels' plain versions. ``params`` are moved to
    the device if they are not there already. ``fused_decode`` and
    ``fused_prefill`` pick the decode and the prefill route (module
    docstring); ``decode_variant`` and ``prefill_variant`` report them.
    ``mesh``: a :class:`~.tp.ServingMesh` (or an int tp over the visible
    cards); the engine's ``device`` is then shard 0's (a ``device`` that
    differs raises), ``params`` is the list of per-shard trees and the
    pools are per-shard lists. ``observability``/``telemetry``: the
    harness and the telemetry plane (module docstring).
    """

    def __init__(self, params: Dict, cfg, capacity: int = 4,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 max_seq_len: Optional[int] = None, cache_dtype=None,
                 prefill_buckets=(32, 128), seed: int = 0,
                 prefix_cache: bool = False, kv_offload=False,
                 observability=False, fused_decode=None, mesh=None,
                 fused_prefill=None, weight_quant=None,
                 aging_s: Optional[float] = None, telemetry=False,
                 clock=None, device=None):
        self._fused = _fused_mode(fused_decode)
        self._fused_prefill = _fused_prefill_mode(fused_prefill)
        self._mesh = normalize_mesh(mesh)
        # the fused chunk keeps running on a tp=1 "psum" mesh; tp > 1 and
        # the "gather" placement run the verbatim chunk, as in the JAX
        # engine (its contract, and no fused tensor-parallel prefill)
        self._prefill_mesh_ok = self._mesh is None or (
            self._mesh.tp == 1 and self._mesh.collective != "gather")
        if self._mesh is not None:
            self._check_mesh(cfg, normalize_weight_quant(weight_quant)
                             or weight_quant_mode(params))
        if kv_offload and not prefix_cache:
            raise ValueError(
                "kv_offload requires prefix_cache=True: the host tier "
                "spills radix-tree pages, not per-request tables")
        if cache_dtype in ("int8", torch.int8):
            self._quant = True
        elif cache_dtype in (None, "bfloat16", "float32", torch.bfloat16,
                             torch.float32):
            self._quant = False
        else:
            raise ValueError(f"cache_dtype must be bfloat16|float32|int8,"
                             f" got {cache_dtype!r}")
        if self._mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = self._mesh.devices[0]
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(
                    f"ServingEngine(device={device!r}) is not the mesh's "
                    f"shard 0 device {self.device}")
        for knob, mode in (("fused_decode", self._fused),
                           ("fused_prefill", self._fused_prefill)):
            if mode in ("pallas", "block") and self.device.type != "cuda":
                # a pin must never silently no-op: the CUDA kernels have no
                # CPU form (the JAX engine's rule for unhonourable pins)
                raise ValueError(
                    f'{knob}="{mode}" forces the CUDA kernels, which do '
                    f"not run on {self.device}; use 'auto' or 'ref' there")
        self._clock = clock if clock is not None else time.perf_counter
        # opt-in per-step self-check: the allocator's and the tree's
        # invariants after every step (they walk the pool and the tree)
        self._check_inv = os.environ.get(
            "PADDLE_TPU_CHECK_INVARIANTS", "") == "1"
        # weight quantization (quantization/ptq.py): "int8"/"int4"
        # quantizes a plain tree once, on the engine's device; a quantized
        # tree rides as-is and None adopts its mode; a requested mode that
        # differs from the tree's raises
        self.params, self._wq = ensure_quantized(
            params_to(params, self.device), weight_quant)
        if self._mesh is not None:
            self.params = self._mesh.shard(
                self.params, self._mesh.param_specs(cfg, self.params))
        self.cfg = cfg
        self.capacity = int(capacity)
        self.block_size = int(block_size)
        self.max_seq_len = int(max_seq_len
                               or cfg.max_position_embeddings)
        if self.max_seq_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the rope table "
                f"bound max_position_embeddings "
                f"= {cfg.max_position_embeddings}")
        self.buckets = tuple(sorted({int(b) for b in prefill_buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError("prefill_buckets must be positive")
        BS = self.block_size
        # the chunk's dense view is MB*BS wide; the last chunk may pad
        # past max_seq_len by up to a bucket, so the table gets the slack
        self.max_blocks = -(-(self.max_seq_len + self.buckets[-1]) // BS)
        if num_blocks is None:
            num_blocks = self.capacity * (-(-self.max_seq_len // BS)) + 1
        self.num_blocks = int(num_blocks)

        L, KV, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                     cfg.head_dim)
        # the pool type follows the model unless the cache is int8, as in
        # the JAX package
        self._pool_dtype = torch.int8 if self._quant else cfg.dtype
        if self._mesh is None:
            shape = (L, self.num_blocks, BS, KV, hd)
            self._k_pools = torch.zeros(shape, dtype=self._pool_dtype,
                                        device=self.device)
            self._v_pools = torch.zeros(shape, dtype=self._pool_dtype,
                                        device=self.device)
        else:
            # one pool pair a shard, over its KV heads; page indices are
            # global, so the BlockManager below is the meshless one
            shape = (L, self.num_blocks, BS, KV // self._mesh.tp, hd)
            self._k_pools, self._v_pools = (
                [torch.zeros(shape, dtype=self._pool_dtype, device=d)
                 for d in self._mesh.devices] for _ in range(2))
        # (k_scale [L, KV], v_scale [L, KV]) f32 once calibrated, and each
        # shard's [L, KV_loc] slices on its device (one shard meshless)
        self._kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._shard_scales: Optional[List[Tuple[torch.Tensor,
                                                torch.Tensor]]] = None
        # decode reads rows < max_seq_len; a fused chunk slices rows
        # pos0..pos0+P-1, which the last, bucket-padded chunk of a long
        # prompt takes past max_position_embeddings (up to MB*BS)
        self._rope = build_rope_cache(
            max(self.max_blocks * BS, cfg.max_position_embeddings), hd,
            base=cfg.rope_theta, device=self.device)

        self.mgr = BlockManager(self.num_blocks, BS, self.max_blocks)
        # reserve physical page 0 as scratch: padded table entries (and
        # inactive decode slots) point there
        scratch = self.mgr.allocate(_SCRATCH_SEQ, 1)
        if scratch != [0]:
            raise RuntimeError("scratch must be page 0 (tables pad with 0)")
        # the radix prefix cache and its host tier: kv_offload=True (or an
        # int host-page budget) spills evicted tree pages to host memory
        # and restores them on a hit
        self._pcache = None
        self._kv_offload = bool(kv_offload)
        # one page across both pools, all layers, in bytes (the spill and
        # restore byte counters)
        self._page_nbytes = int(2 * L * BS * KV * hd * torch.empty(
            (), dtype=self._pool_dtype).element_size())
        # the offload directions used so far ("spill", "restore")
        self._offload_paths = set()
        if prefix_cache:
            from .prefix_cache import PrefixCache, make_page_copier
            self._copy_fn = make_page_copier()
            budget = (int(kv_offload)
                      if kv_offload and kv_offload is not True else None)
            self._pcache = PrefixCache(
                self.mgr, BS, copy_page=self._copy_page,
                spill_pages=self._spill_pages if kv_offload else None,
                restore_pages=(self._restore_pages if kv_offload
                               else None),
                host_budget_pages=budget)

        C, MB = self.capacity, self.max_blocks
        self._slots = [_Slot() for _ in range(C)]
        self._queue = AdmissionQueue(aging_s=aging_s, clock=self._clock)
        # per-class queue-wait stats: cls -> [admitted, wait_ms_sum,
        # wait_ms_max]; slo = [with-deadline seen, attained]
        self._sched_cls: Dict[int, List[float]] = {}
        self._slo = [0, 0]
        self._requests: List[Request] = []
        self._next_id = 0
        self._slot_tables = np.zeros((C, MB), np.int32)
        # prefill WRITE tables: the true tables with the shared prefix
        # entries sent to scratch page 0, so no prefill chunk writes a page
        # another request or the tree reads
        self._slot_wtables = np.zeros((C, MB), np.int32)
        # the decode program's inputs: fixed buffers on the device, each
        # with its host mirror (pinned on CUDA; the _h_* arrays are numpy
        # views of them), copied in when the host changes them (_dirty).
        # Mid-prefill slots keep table 0 / seq 0 here: their decode write
        # must hit scratch.
        pin = self.device.type == "cuda"
        shapes = {"tok": ((C,), torch.int32), "seq": ((C,), torch.int32),
                  "tables": ((C, MB), torch.int32),
                  "temps": ((C,), torch.float32)}
        self._host_carry = {k: torch.zeros(sh, dtype=dt, pin_memory=pin)
                            for k, (sh, dt) in shapes.items()}
        self._h_tok, self._h_seq, self._h_tables, self._h_temps = (
            self._host_carry[k].numpy() for k in shapes)
        self._d_tok, self._d_seq, self._d_tables, self._d_temps = (
            torch.zeros(sh, dtype=dt, device=self.device)
            for sh, dt in shapes.values())
        # the step's logits [C, V], in the model's type (sampled from here)
        self._d_logits = torch.zeros((C, cfg.vocab_size), dtype=cfg.dtype,
                                     device=self.device)
        self._dirty = True
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(seed))
        # the decode programs by key (_decode_key) and, on CUDA, the stream
        # their warm-up and capture run on
        self._decode_fns: Dict[Tuple, _Program] = {}
        self._stream = (torch.cuda.Stream(self.device) if pin else None)
        # the prefill programs by (bucket,) + key (_prefill_key), each
        # bucket's fixed buffers, and on CUDA the one memory pool their
        # graphs share (they never run at once)
        self._prefill_fns: Dict[Tuple, _Program] = {}
        self._prefill_bufs: Dict[int, _ChunkBuffers] = {}
        self._prefill_pool = (torch.cuda.graph_pool_handle() if pin
                              else None)
        # the JAX engine's counters; decode_traces counts the decode
        # program's captures (builds on the CPU), the other *_traces route
        # resolutions, calibrations and offload paths (module docstring)
        self.counters = {
            "decode_traces": 0, "prefill_traces": {},
            "calibration_traces": 0, "decode_steps": 0,
            "prefill_chunks": 0, "prefill_tokens": 0,
            "prefill_pad_tokens": 0, "live_slot_steps": 0,
            "tokens_generated": 0, "requests_submitted": 0,
            "requests_completed": 0, "drain_truncations": 0,
            "preemptions": 0, "requeues": 0, "deadline_expired": 0,
            "offload_traces": 0, "kv_spill_bytes": 0,
            "kv_restore_bytes": 0,
        }
        # the decode and prefill variants, recorded when the decode program
        # is built and at the first fused chunk
        self._decode_variant: Optional[Dict] = None
        self._prefill_variant: Optional[Dict] = None
        self._decode_ms = 0.0          # summed decode-step time
        self._t_first = None
        self._t_last = None
        self._metrics_reset_t = None   # TTFTs from before this are warmup
        self.last_drain_truncated = False
        # observability: None when disabled — every hook below is a
        # single `is not None` check, so the disabled hot loop allocates
        # NO event objects and issues NO extra device syncs (the per-
        # step d2h token read in _run_decode stays the only sync point).
        # telemetry implies observability: the plane's alerts land
        # timeline events and stall dumps, both owned by the harness.
        _tcfg = TelemetryConfig.coerce(telemetry)
        if observability or _tcfg is not None:
            self._obs = (observability
                         if isinstance(observability, Observability)
                         else Observability())
            self._obs.registry.adopt_counters(self.counters)
            if self._kv_offload:
                # handoff_ms-style distributions for the host tier
                self._obs.ensure_histograms(("spill_ms", "restore_ms"))
        else:
            self._obs = None
        # serving-collective instrumentation: a mesh'd engine with
        # observability on binds an engine-scoped flight recorder and
        # replays the DECLARED per-step collective inventory around each
        # dispatched program (host-observed spans; byte counters exact,
        # the shapes being static); metrics() surfaces them under
        # "collectives" like Trainer.metrics()
        self._flight = None
        self._coll_decode = ()
        self._coll_prefill: Dict[int, tuple] = {}
        if self._mesh is not None and self._obs is not None:
            from ..distributed.flight_recorder import FlightRecorder
            rec = FlightRecorder(capacity=4096)
            rec.enabled = True
            self._flight = self._obs.bind_flight_recorder(rec)
            self._coll_decode = tuple(self._mesh.collective_inventory(
                cfg, B=self.capacity))
        # the telemetry plane: samples this engine's metrics() on a step
        # cadence into bounded series with burn-rate/anomaly alerting;
        # None when disabled
        self._telemetry = None
        if _tcfg is not None:
            self._telemetry = TelemetryPlane(
                _tcfg, on_alert=self._telemetry_alert)
            self._telemetry.register("serving_engine", self.metrics,
                                     counters=self.counters)
        if self._fused:
            # on CUDA a kernel that refuses the shapes raises here, with
            # the predicate's reason, rather than at the first decode step
            self._resolve_variant()
        # which chunk each bucket runs; on CUDA "auto" raises here for a
        # bucket whose prefill kernel refuses the shapes
        self._fused_buckets = {P: self._prefill_fused_for(P)
                               for P in self.buckets}

    def _check_mesh(self, cfg, wq):
        """The refusals under a mesh, with their reasons: shards on more
        than one device (the decode step is one CUDA graph); and the JAX
        engine's: a quantized tree over tp > 1, a model the mesh cannot
        split, the "pallas" decode pin under "gather", the "block" pin
        under any mesh and the "pallas" prefill pin where the chunk cannot
        be fused."""
        sm = self._mesh
        if len(set(sm.devices)) > 1:
            raise ValueError(
                f"ServingEngine(mesh=...): shards on {len(set(sm.devices))}"
                " devices; the decode step is one CUDA graph, which runs on"
                " one card, and no collective spans cards yet (the "
                "multi-card backend, ROADMAP A10(b)/A11): colocate the "
                "shards on one device")
        if wq and sm.tp > 1:
            raise ValueError(
                f"ServingEngine(weight_quant={wq!r}) cannot shard"
                f" over tp={sm.tp} > 1: packed-int4 rows and "
                "per-channel scale trees need per-shard packing specs "
                "(named headroom) — run quantized serving single-device"
                " or on tp=1 groups")
        ok, reason = sm.supports(cfg)
        if not ok:
            raise ValueError(f"ServingEngine(mesh=...): {reason}")
        if sm.collective == "gather" and self._fused == "pallas":
            # the gather placement runs the exact composition by contract
            raise ValueError(
                'fused_decode="pallas" cannot be honored under '
                'collective="gather" — that placement runs the '
                "exact unfused composition (its bit-parity "
                'contract); use collective="psum" or drop the pin')
        if self._fused == "block":
            raise ValueError(
                'fused_decode="block" is single-device: the '
                "single-launch decode-block kernel runs outside "
                "shard_map — drop the mesh or the pin")
        if self._fused_prefill == "pallas" and not self._prefill_mesh_ok:
            raise ValueError(
                'fused_prefill="pallas" cannot be honored on this mesh'
                " — tensor-parallel (tp > 1) and gather-placement "
                "prefill run the unfused chunk by contract; use "
                'collective="psum" with tp=1 or drop the pin')

    def _record_collectives(self, inventory):
        """Open one CommTask per declared collective class; returns the
        tasks for :meth:`_end_collectives` after the program's sync."""
        if self._flight is None or not inventory:
            return None
        return [self._flight.begin(op, ax, shape, dt)
                for op, ax, shape, dt in inventory]

    def _end_collectives(self, tasks):
        if tasks:
            for t in tasks:
                self._flight.end(t)

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """Host mirror -> device, as a copy (never aliasing the mirror,
        which the scheduler goes on mutating)."""
        return torch.from_numpy(np.array(x)).to(self.device)

    def _copy_page(self, src: int, dst: int):
        """The prefix cache's COW copy: page ``src`` -> ``dst`` of every
        layer in both pools (every shard's), on the device."""
        self._copy_fn(self._k_pools, self._v_pools, src, dst)

    # -- host-RAM KV offload tier -------------------------------------
    def _count_offload(self, path: str):
        if path not in self._offload_paths:
            self._offload_paths.add(path)
            self.counters["offload_traces"] += 1

    def _spill_pages(self, pages):
        """The prefix cache's batch spill: the pages' raw bytes to host
        memory, ``_OFFLOAD_WINDOW`` pages a transfer: each pool's window
        gathered on the device page-major ([W, L, BS, KV, hd], contiguous)
        and copied into pinned memory without a host sync
        (:func:`~.prefix_cache.host_put`). Returns one payload a page: a
        (k, v) pair of contiguous [L, BS, KV, hd] host views a shard;
        only :meth:`_restore_pages` reads them, after a copy ordered
        behind the spill's on the same stream."""
        from .prefix_cache import host_put
        self._count_offload("spill")
        t0 = self._clock()
        payloads = []
        for w0 in range(0, len(pages), _OFFLOAD_WINDOW):
            win = [int(p) for p in pages[w0:w0 + _OFFLOAD_WINDOW]]
            idx = torch.as_tensor(win, device=self.device)
            per_shard = [tuple(host_put(t) for t in pair)
                         for pair in _offload_extract(
                             self._k_pools, self._v_pools, idx)]
            for j in range(len(win)):
                payloads.append(tuple((k[j], v[j]) for k, v in per_shard))
        self.counters["kv_spill_bytes"] += self._page_nbytes * len(pages)
        if self._obs is not None and pages:
            # host time (the copies run on the stream behind it)
            dur = (self._clock() - t0) * 1e3
            per = dur / len(pages)
            for _ in pages:      # one observation per PAGE (the
                self._obs.hist("spill_ms").observe(per)   # count
            self._obs.timeline.record(   # contract: count == pages)
                "kv_spill", pages=[int(p) for p in pages],
                bytes=self._page_nbytes * len(pages),
                dur_ms=round(dur, 3))
        return payloads

    def _restore_pages(self, payloads, dsts):
        """The prefix cache's batch restore: the spilled bytes back into
        pages ``dsts``, byte for byte, ``_OFFLOAD_WINDOW`` pages a
        transfer: each page copied from its pinned payload into a window
        on the device without a host sync, then the window written into
        the pool's pages. The copies are ordered before the suffix prefill
        chunk that reads the pages next, on the same stream."""
        self._count_offload("restore")
        t0 = self._clock()
        for w0 in range(0, len(dsts), _OFFLOAD_WINDOW):
            win_d = [int(d) for d in dsts[w0:w0 + _OFFLOAD_WINDOW]]
            win_p = payloads[w0:w0 + _OFFLOAD_WINDOW]
            idx = torch.as_tensor(win_d, device=self.device)
            windows = []
            for s, (kp, vp) in enumerate(_pairs(self._k_pools,
                                                self._v_pools)):
                bufs = []
                for j_pool, pool in enumerate((kp, vp)):
                    buf = torch.empty((len(win_d),) + pool.shape[:1]
                                      + pool.shape[2:], dtype=pool.dtype,
                                      device=pool.device)
                    for j, payload in enumerate(win_p):
                        buf[j].copy_(payload[s][j_pool], non_blocking=True)
                    bufs.append(buf)
                windows.append(tuple(bufs))
            _offload_insert(self._k_pools, self._v_pools, idx, windows)
        self.counters["kv_restore_bytes"] += self._page_nbytes * len(dsts)
        if self._obs is not None and dsts:
            dur = (self._clock() - t0) * 1e3
            per = dur / len(dsts)
            for _ in dsts:
                self._obs.hist("restore_ms").observe(per)
            self._obs.timeline.record(
                "kv_restore", pages=[int(d) for d in dsts],
                bytes=self._page_nbytes * len(dsts),
                dur_ms=round(dur, 3))

    # -- public API ---------------------------------------------------
    def _alloc_tokens(self, req: Request) -> int:
        """Token span the engine allocates KV pages for: prompt plus
        generation."""
        return int(req.prompt.size) + int(req.gen.max_new_tokens)

    def submit(self, prompt, gen: Optional[GenerationConfig] = None,
               priority: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Enqueue one request. Admission happens inside ``step()``
        when a slot and enough KV pages are free, ordered by priority
        class (LOWER = more urgent; FIFO within a class, aging per
        ``aging_s``). A request still queued past ``deadline_s`` is
        rejected (``expired``), never admitted late. ``priority`` and
        ``deadline_s`` default from ``gen``."""
        gen = gen or GenerationConfig()
        if gen.top_k > 0 or gen.top_p < 1.0:
            raise NotImplementedError(
                "ServingEngine: per-request top-k/top-p is not supported;"
                " greedy and temperature sampling are")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        total = int(prompt.size) + int(gen.max_new_tokens)
        if total > self.max_seq_len:
            raise ValueError(
                f"prompt+max_new_tokens = {total} exceeds engine "
                f"max_seq_len = {self.max_seq_len}")
        if priority is None:
            priority = gen.priority
        if deadline_s is None:
            deadline_s = gen.deadline_s
        req = Request(self._next_id, prompt, gen, submit_t=self._clock(),
                      priority=int(priority), deadline_s=deadline_s)
        need = -(-self._alloc_tokens(req) // self.block_size)
        if need > self.num_blocks - 1:          # minus the scratch page
            raise ValueError(
                f"request needs {need} KV pages but the pool only has "
                f"{self.num_blocks - 1}; raise num_blocks")
        self._next_id += 1
        req.qentry = self._queue.push(req, cls=req.priority,
                                      submit_t=req.submit_t,
                                      deadline_s=deadline_s)
        self._requests.append(req)
        self.counters["requests_submitted"] += 1
        if self._obs is not None:
            self._obs.timeline.record(
                "submit", req.req_id, prompt_tokens=int(prompt.size),
                max_new_tokens=int(gen.max_new_tokens),
                priority=req.priority,
                **({"deadline_s": deadline_s}
                   if deadline_s is not None else {}))
        return req

    def step(self) -> bool:
        """One scheduler iteration: admit from the queue, run one
        prefill chunk (if an admission is in flight), then one decode
        step over all live slots. Returns True if any work ran,
        deadline expiries included."""
        obs = self._obs
        t0 = self._clock() if obs is not None else 0.0
        if self._t_first is None:
            self._t_first = self._clock()
        expired = self._admit()
        did = self._run_prefill()
        did = self._run_decode() or did
        if did:
            self._t_last = self._clock()
        if obs is not None:
            self._observe_step(t0, did)
        if self._telemetry is not None:
            self._telemetry.on_step()
        if self._check_inv:
            # PADDLE_TPU_CHECK_INVARIANTS=1: the allocator's and the
            # tree's invariants after every step
            self.mgr.check()
            if self._pcache is not None:
                self._pcache.check()
        return did or expired > 0

    def _observe_step(self, t0: float, did: bool):
        """Post-step observability: gauges, watchdog, step deadline.
        Pure host bookkeeping — reads only host mirrors, never the
        device."""
        obs = self._obs
        now = self._clock()
        free = len(self.mgr.free)
        vals = {
            "pages_free": free,
            "pages_in_use": self.num_blocks - free,
            "kv_refcount_total": int(self.mgr.refcount.sum()),
            "queue_depth": len(self._queue),
            "live_slots": sum(1 for s in self._slots
                              if s.phase != "idle"),
        }
        if self._slo[0]:
            vals["slo_attainment"] = self._slo[1] / self._slo[0]
        if self._pcache is not None:
            st = self._pcache.stats
            looked = st["hits"] + st["misses"]
            vals["prefix_tree_pages"] = self._pcache.cached_pages
            vals["prefix_hit_ratio"] = (round(st["hits"] / looked, 4)
                                        if looked else 0.0)
            if self._kv_offload:
                vals["prefix_host_pages"] = self._pcache.host_pages
        obs.sample_gauges(now, vals)
        if obs.watchdog.check(self.counters):
            obs.timeline.record("retrace",
                                events=len(obs.watchdog.events))
        if did:
            dur = now - t0
            obs.hist("step_ms").observe(dur * 1e3)
            if obs.step_deadline_s is not None \
                    and dur > obs.step_deadline_s:
                obs.stall_dump(
                    f"step took {dur * 1e3:.1f} ms "
                    f"(deadline {obs.step_deadline_s * 1e3:.1f} ms)",
                    self.scheduler_snapshot())

    @property
    def idle(self) -> bool:
        return not self._queue and all(
            s.phase == "idle" for s in self._slots)

    @property
    def queue_depth(self) -> int:
        """Requests submitted but not yet admitted."""
        return len(self._queue)

    @property
    def live_slots(self) -> int:
        return sum(1 for s in self._slots if s.phase != "idle")

    @property
    def prefix_cache_version(self) -> int:
        """Monotone radix-tree version (0 without a prefix cache): a
        router refreshes its cached tree summary when this moves."""
        return 0 if self._pcache is None else self._pcache.version

    def prefix_summary(self) -> Dict[int, int]:
        """The router's tree summary: ``{prefix_hash: n_tokens}`` for every
        page-aligned cached path (empty without a prefix cache)."""
        return {} if self._pcache is None else self._pcache.summary()

    def offload_metrics(self) -> Dict:
        """The host tier's report (the JAX engine's keys): page counts from
        the radix tree, bytes from the engine's counters. All zeros
        without ``kv_offload``."""
        pc = self._pcache.stats if self._pcache is not None else {}
        return {
            "spilled_pages": pc.get("spilled_pages", 0),
            "restored_pages": pc.get("restored_pages", 0),
            "readopted_pages": pc.get("readopted_pages", 0),
            "host_evicted_pages": pc.get("host_evicted_pages", 0),
            "host_pages": (self._pcache.host_pages
                           if self._pcache is not None else 0),
            "spill_bytes": self.counters["kv_spill_bytes"],
            "restore_bytes": self.counters["kv_restore_bytes"],
        }

    def scheduler_snapshot(self) -> Dict:
        """Host-side scheduler state: queue depth, the first 16 queued
        requests, slot phases, per-slot seq_len, free pages and, with a
        prefix cache, its counters (the JAX engine's)."""
        snap = {
            "queue_depth": len(self._queue),
            "queued": [{"req_id": e.item.req_id,
                        "prompt_tokens": int(e.item.prompt.size),
                        "priority": e.item.priority,
                        "requeues": e.requeues,
                        "need_pages":
                            -(-self._alloc_tokens(e.item)
                              // self.block_size)}
                       for e in list(self._queue)[:16]],
            "slots": [{"slot": i, "phase": s.phase,
                       "req_id": s.req.req_id if s.req else None,
                       "seq_len": s.seq_len,
                       "prefill_pos": s.prefill_pos}
                      for i, s in enumerate(self._slots)],
            "pages_free": len(self.mgr.free),
            "num_blocks": self.num_blocks,
            "capacity": self.capacity,
        }
        if self._pcache is not None:
            snap["prefix_cache"] = self._pcache.metrics()
        return snap

    def drain(self, max_steps: Optional[int] = None) -> int:
        """Step until queue and slots are empty; returns the step count.
        Hitting ``max_steps`` with work pending sets
        ``last_drain_truncated``; a step that can run nothing while
        requests wait raises (the shared :func:`_drain_loop`)."""
        return _drain_loop(
            self, max_steps,
            starve_reason="drain starved: queued requests cannot be "
                          "admitted",
            starve_error="engine starved: queued requests cannot be "
                         "admitted (KV pool too small for the in-flight "
                         "mix?)")

    def _drain_truncated_event(self, n: int):
        if self._obs is not None:
            self._obs.timeline.record(
                "drain_truncated", steps=n,
                queue_depth=len(self._queue),
                live_slots=sum(1 for s in self._slots
                               if s.phase != "idle"))

    @property
    def telemetry(self) -> Optional[TelemetryPlane]:
        """The continuous telemetry plane, or None when disabled."""
        return self._telemetry

    def _telemetry_alert(self, alert: Dict):
        """Plane alert callback: stamp an ``alert`` timeline event; a
        page-severity alert additionally self-documents through the
        flight-recorder stall-dump machinery (scheduler snapshot + the
        alert that fired)."""
        obs = self._obs
        if obs is None:
            return
        obs.timeline.record(
            "alert", rule=alert.get("rule"),
            severity=alert.get("severity"), metric=alert.get("metric"),
            value=alert.get("value"), threshold=alert.get("threshold"))
        if (alert.get("severity") == "page"
                and self._telemetry is not None
                and self._telemetry.config.page_dumps):
            obs.stall_dump(
                f"telemetry alert: {alert.get('rule')} on "
                f"{alert.get('metric')}", self.scheduler_snapshot(),
                metrics={"alert": alert})

    def metrics(self) -> Dict:
        # the flight recorder parks raw collective_calls/bytes counters
        # in the adopted dict; they surface ONLY under the structured
        # "collectives" key below (the Trainer.metrics contract)
        c = {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in self.counters.items()
             if k not in ("collective_calls", "collective_bytes")}
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        c["wall_time_s"] = round(wall, 6)
        c["tokens_per_sec"] = (round(c["tokens_generated"] / wall, 3)
                               if wall > 0 else 0.0)
        c["prefill_tokens_per_sec"] = (
            round(c["prefill_tokens"] / wall, 3) if wall > 0 else 0.0)
        # TTFTs from before the last reset_metrics() belong to the warmup
        cut = self._metrics_reset_t
        ttfts = [r.ttft for r in self._requests
                 if r.ttft is not None
                 and (cut is None or (r.first_token_t or 0.0) >= cut)]
        c["ttft_ms_mean"] = (round(float(np.mean(ttfts)) * 1e3, 3)
                             if ttfts else None)
        c["ttft_ms_max"] = (round(float(np.max(ttfts)) * 1e3, 3)
                            if ttfts else None)
        steps = c["decode_steps"]
        c["decode_step_ms_mean"] = self._decode_step_ms_mean()
        c["slot_utilization"] = (
            round(c["live_slot_steps"] / (steps * self.capacity), 4)
            if steps else 0.0)
        c["decode_variant"] = self.decode_variant
        c["prefill_variant"] = self.prefill_variant
        c["weight_quant_variant"] = self.weight_quant_variant
        c["roofline"] = self._roofline_metrics(c["decode_step_ms_mean"])
        c["scheduler"] = self._scheduler_metrics()
        if self._pcache is not None:
            c["prefix_cache"] = self._pcache.metrics()
        if self._mesh is not None:
            c["mesh"] = self._mesh.describe()
        if self._telemetry is not None:
            c["telemetry"] = self._telemetry.snapshot()
        if self._obs is not None:
            obs = self._obs
            c["latency"] = obs.latency_snapshot()
            c["gauges"] = obs.gauges_snapshot()
            c["retrace_warnings"] = len(obs.watchdog.events)
            c["stall_dumps"] = (len(obs.stall_dumps)
                                + obs.stall_dumps_suppressed)
            c["timeline_events"] = len(obs.timeline)
            c["timeline_dropped"] = obs.timeline.dropped
            if self._flight is not None:
                c["collectives"] = _collectives_snapshot(self.counters,
                                                         obs)
        return c

    def reset_metrics(self):
        """Zero the throughput counters and timers (e.g. after a warm-up
        pass), as the JAX engine does. The trace counters are cumulative
        and stay; TTFTs of requests that got their first token before
        this call leave the mean. With a prefix cache its workload
        counters restart as well; the cached pages stay. The retrace
        watchdog arms HERE: a program captured (built, on the CPU) after
        this call is a steady-state retrace and warns."""
        for k in ("decode_steps", "prefill_chunks", "prefill_tokens",
                  "prefill_pad_tokens",
                  "live_slot_steps", "tokens_generated",
                  "requests_submitted", "requests_completed",
                  "drain_truncations", "preemptions", "requeues",
                  "deadline_expired", "kv_spill_bytes",
                  "kv_restore_bytes"):
            self.counters[k] = 0
        self._sched_cls = {}
        self._slo = [0, 0]
        if self._pcache is not None:
            # the tree's workload counters restart too (its pages stay)
            for k in self._pcache.stats:
                self._pcache.stats[k] = 0
        self._decode_ms = 0.0
        self._t_first = self._t_last = None
        self._metrics_reset_t = self._clock()
        self._requests = [r for r in self._requests if not r.done]
        if self._flight is not None:
            # the recorder's call/byte counters restart with the
            # collective latency histograms: one window
            self.counters.pop("collective_calls", None)
            self.counters.pop("collective_bytes", None)
        if self._obs is not None:
            self._obs.reset_window()
            self._obs.watchdog.mark_warmup(self.counters)

    # -- observability export -----------------------------------------
    @property
    def observability(self) -> Optional[Observability]:
        return self._obs

    def _require_obs(self) -> Observability:
        if self._obs is None:
            raise RuntimeError(
                "observability is disabled for this engine; construct "
                "with ServingEngine(..., observability=True)")
        return self._obs

    def export_trace(self, path: str) -> str:
        """Write the request-lifecycle chrome trace (+ gauge counter
        tracks + the per-route roofline annotation track) to ``path`` —
        open in Perfetto / chrome://tracing."""
        from ..observability.roofline import roofline_chrome_events
        return self._require_obs().export_chrome(
            path, extra_events=roofline_chrome_events(
                self._roofline_metrics(self._decode_step_ms_mean())))

    def write_timeline(self, path: str) -> str:
        """Write the structured per-phase JSONL (events + per-request
        records) to ``path`` — input for tools/trace_summary.py. The
        meta header carries the per-route roofline model."""
        return self._require_obs().write_jsonl(
            path, header={"capacity": self.capacity,
                          "num_blocks": self.num_blocks,
                          "block_size": self.block_size,
                          "roofline": self._roofline_metrics(
                              self._decode_step_ms_mean())})

    def _decode_step_ms_mean(self) -> Optional[float]:
        """The mean decode-step time: on CUDA device time between events
        around the step, read at the step's own sync (host clock on the
        CPU); None before the first step."""
        steps = self.counters["decode_steps"]
        return round(self._decode_ms / steps, 3) if steps else None

    def _active_arm(self) -> str:
        """The roofline arm the decode step runs: the single-launch
        kernel, the two-stage kernels, or the composition."""
        v = self.decode_variant
        if v["block"] == "cuda_block":
            return "cuda_block"
        return "cuda_fused" if v["attn"] == "cuda_fused" else "unfused"

    def _roofline_metrics(self, step_ms) -> Dict:
        """Each decode route's modeled bytes a step (per layer times the
        layers, plus the lm-head read; one shard's dims under a mesh, as
        in the JAX engine) and the least step time at the H100's memory
        rate; for the active route on the card, the share of that rate
        the measured mean step time achieves (None on the CPU, whose clock
        says nothing of the card)."""
        from ..observability.roofline import (decode_roofline,
                                              decode_step_bytes)
        cfg = self.cfg
        tp = 1 if self._mesh is None else self._mesh.tp
        act = torch.empty((), dtype=cfg.dtype).element_size()
        pool = torch.empty((), dtype=self._pool_dtype).element_size()
        wbytes = {"int8": 1.0, "int4": 0.5}.get(self._wq or "", float(act))
        L = cfg.num_hidden_layers
        per_layer = decode_step_bytes(
            self.capacity, cfg.hidden_size, cfg.num_attention_heads // tp,
            cfg.num_key_value_heads // tp, cfg.head_dim,
            cfg.intermediate_size // tp,
            self.block_size, self.max_blocks, act_itemsize=act,
            weight_itemsize=wbytes, pool_itemsize=pool)
        head = cfg.vocab_size * cfg.hidden_size * act
        step_bytes = {k: int(v * L + head) for k, v in per_layer.items()}
        active = self._active_arm()
        measured = ({active: step_ms * 1e3}
                    if step_ms and self.device.type == "cuda" else {})
        r = decode_roofline(step_bytes, measured_us=measured)
        r["active"] = active
        r["layers"] = L
        return r

    def _resolve_variant(self) -> Dict:
        from ..ops.kernels.fused_decode_block import (decode_meta,
                                                      decode_meta_dims,
                                                      resolve_decode_blocks,
                                                      resolve_decode_step)
        sm, cfg = self._mesh, self.cfg
        if sm is None:
            meta = decode_meta(cfg, B=self.capacity, BS=self.block_size,
                               MB=self.max_blocks, pool_dtype=self._pool_dtype,
                               quant=self._quant, weight_dtype=self._wq,
                               device=self.device)
            _, _, _, names = resolve_decode_step(meta, self._fused)
            return {"mode": str(self._fused), **names}
        if sm.collective == "gather":
            # its contract is the single-device op sequence: always the
            # composition, whatever the knob says
            return {"mode": str(self._fused), "block": "composed",
                    "attn": "unfused", "mlp": "unfused"}
        # the per-shard shape class with tp in the meta, as
        # _tp_decode_step dispatches it: the two stages, per shard
        tp = sm.tp
        meta = decode_meta_dims(
            self.capacity, cfg.hidden_size, cfg.num_attention_heads // tp,
            cfg.num_key_value_heads // tp, cfg.head_dim,
            cfg.intermediate_size // tp, self.block_size, self.max_blocks,
            cfg.dtype, self._pool_dtype, self._quant, tp=tp,
            weight_dtype=self._wq, device=self.device)
        _, _, names = resolve_decode_blocks(meta, self._fused)
        return {"mode": str(self._fused), "block": "composed", **names}

    @property
    def decode_variant(self) -> Dict:
        """Which decode-block implementation the decode step runs:
        ``{"mode", "block", "attn", "mlp"}``: every name "cuda_block" for
        the single-launch kernel, else block "composed" and attn/mlp
        "cuda_fused" or "unfused". Recorded when the decode program is
        built (under the pins it is keyed by); before it, what dispatch
        would pick now."""
        if not self._fused:
            return {"mode": "unfused", "block": "composed",
                    "attn": "unfused", "mlp": "unfused"}
        if self._decode_variant is not None:
            return dict(self._decode_variant)
        return self._resolve_variant()

    def _prefill_meta(self, P: int) -> Dict:
        from ..ops.kernels.fused_prefill_block import prefill_meta
        return prefill_meta(self.cfg, P, self.block_size, self.max_blocks,
                            self._pool_dtype, quant=self._quant,
                            weight_dtype=self._wq, device=self.device)

    def _prefill_fused_for(self, P: int) -> bool:
        """Whether bucket ``P`` runs the fused chunk: ALL-OR-NOTHING, both
        prefill-block ops must resolve to the CUDA kernels; otherwise the
        verbatim unfused chunk runs. Never on a tp > 1 or "gather" mesh."""
        if not self._fused_prefill or not self._prefill_mesh_ok:
            return False
        from ..ops.kernels import fused_prefill_block
        return fused_prefill_block.prefill_fused_selected(
            self._prefill_meta(P), self._fused_prefill)

    def _resolve_prefill_variant(self, P: int) -> Dict:
        from ..ops.kernels.fused_prefill_block import resolve_prefill_blocks
        _, _, names = resolve_prefill_blocks(self._prefill_meta(P),
                                             self._fused_prefill)
        return {"mode": str(self._fused_prefill), **names}

    @property
    def prefill_variant(self) -> Dict:
        """Which prefill-chunk implementation the buckets run:
        ``{"mode", "attn", "mlp"}`` with attn/mlp "cuda_fused" or
        "unfused". Captured at the first fused chunk; before it, what
        dispatch would pick now for the largest bucket."""
        if not self._fused_prefill or not self._prefill_mesh_ok:
            return {"mode": "unfused", "attn": "unfused", "mlp": "unfused"}
        if self._prefill_variant is not None:
            return dict(self._prefill_variant)
        return self._resolve_prefill_variant(self.buckets[-1])

    @property
    def weight_quant_variant(self) -> Dict:
        """The weight class the decode step serves: ``{"mode": "off"}``
        for plain weights, else ``{"mode": "int8"|"int4", "weight_dtype":
        ..., "block": ..., "attn": ..., "mlp": ...}`` with the decode
        variants (:attr:`decode_variant`) that serve the quantized tree."""
        if not self._wq:
            return {"mode": "off"}
        v = self.decode_variant
        return {"mode": self._wq, "weight_dtype": self._wq,
                "block": v["block"], "attn": v["attn"], "mlp": v["mlp"]}

    def _scheduler_metrics(self) -> Dict:
        per = {str(cls): {
                   "admitted": int(st[0]),
                   "queue_wait_ms_mean": (round(st[1] / st[0], 3)
                                          if st[0] else 0.0),
                   "queue_wait_ms_max": round(st[2], 3)}
               for cls, st in sorted(self._sched_cls.items())}
        n, ok = self._slo
        return {"per_class": per,
                "slo_attainment": (round(ok / n, 4) if n else None),
                "slo_seen": int(n), "slo_attained": int(ok),
                "queue_depth": len(self._queue)}

    # -- scheduling ---------------------------------------------------
    def _temp_of(self, gen: GenerationConfig) -> float:
        return 0.0 if (gen.greedy or gen.temperature == 0.0) \
            else float(gen.temperature)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _admit(self) -> int:
        """Admit from the queue until blocked; returns the number of
        deadline expiries (scheduler progress the caller must count)."""
        now = self._clock()
        expired = self._queue.pop_expired(now)
        for entry in expired:
            self._expire(entry.item, now)
        while self._queue:
            entry = self._queue.best(now)
            req = entry.item
            # a slot first: idle, or a strictly lower-priority decode
            # victim (preempted only once the page check passes)
            slot_id = next((i for i, s in enumerate(self._slots)
                            if s.phase == "idle"), None)
            victim = None
            if slot_id is None:
                victim = self._preempt_candidate(req)
                if victim is None:
                    break
            ok, acquired = ((True, None) if req.resume is not None
                            else self._acquire_pages(req))
            if not ok:
                # the line head is page-starved. Fresh requests may not
                # overtake it, but a RESUME entry allocates nothing and
                # holds pages whose release may be what the head waits
                # for, so the best resume entry admits instead
                entry = self._queue.best(
                    now, pred=lambda e: e.item.resume is not None)
                if entry is None:
                    break
                req = entry.item
                if slot_id is None:
                    victim = self._preempt_candidate(req)
                    if victim is None:
                        break
            if slot_id is None:
                slot_id = self._preempt(victim)
            self._queue.remove(entry)
            if req.resume is not None:
                self._admit_resume(slot_id, req, now)
                continue
            slot = self._slots[slot_id]
            if self._quant and self._kv_scales is None:
                # the static scales come from the first admitted prompt,
                # before any chunk or decode step reads the pools
                self._calibrate(req.prompt)
            matched = shared = 0
            if acquired is not None:
                pages, matched, shared = acquired
                # the matched pages join the table; their references pass
                # to the request's table entries
                self.mgr.attach(req.req_id, pages, owned=True)
            table = self.mgr.allocate(req.req_id, self._alloc_tokens(req))
            slot.req = req
            slot.phase = "prefill"
            slot.seq_len = 0
            slot.prefill_pos = matched     # prefill only the suffix
            self._slot_tables[slot_id] = 0
            self._slot_tables[slot_id, :len(table)] = table
            self._slot_wtables[slot_id] = self._slot_tables[slot_id]
            self._slot_wtables[slot_id, :shared] = 0
            self._record_admit(req, slot_id, now, matched)
        return len(expired)

    def _acquire_pages(self, req: Request):
        """Page-availability check for a fresh admission: ``(ok,
        acquired)``. Without a prefix cache a free-list check; with one,
        ``PrefixCache.acquire`` longest-prefix matches (capped at S-1, so
        at least one token prefills and gives the first token's logits),
        pins the matched pages and checks that free plus evictable pages
        cover the rest."""
        need = -(-self._alloc_tokens(req) // self.block_size)
        if self._pcache is None:
            return len(self.mgr.free) >= need, None
        acquired = self._pcache.acquire(
            req.prompt, int(req.prompt.size) - 1, need)
        return acquired is not None, acquired

    def _record_admit(self, req: Request, slot_id: int, now: float,
                      matched: int = 0):
        """Admission bookkeeping shared by the fresh and resume paths:
        queue-wait stats per priority class and SLO attainment at a
        request's first admission (a resume keeps the first), the
        queue_wait histogram and the timeline event."""
        first = req.admit_t is None
        if first:
            req.admit_t = self._clock()
            wait_ms = (req.admit_t - req.submit_t) * 1e3
            st = self._sched_cls.setdefault(req.priority, [0, 0.0, 0.0])
            st[0] += 1
            st[1] += wait_ms
            st[2] = max(st[2], wait_ms)
            if req.deadline_s is not None:
                self._slo[0] += 1
                if wait_ms <= req.deadline_s * 1e3:
                    self._slo[1] += 1
            if self._obs is not None:
                self._obs.hist("queue_wait_ms").observe(wait_ms)
        if self._obs is not None:
            wait_ms = (self._clock() - req.submit_t) * 1e3
            self._obs.timeline.record(
                "admit" if first else "resume", req.req_id,
                slot=slot_id, queue_wait_ms=round(wait_ms, 3),
                matched_tokens=matched, priority=req.priority)

    def _expire(self, req: Request, now: float):
        """Admission deadline passed while queued: reject, never admit
        late."""
        req.done = True
        req.expired = True
        req.finish_t = now
        self.counters["deadline_expired"] += 1
        if req.deadline_s is not None:
            self._slo[0] += 1       # a deadline seen and MISSED
        if req.req_id in self.mgr.tables:
            self.mgr.release(req.req_id)
        if self._obs is not None:
            self._obs.timeline.record(
                "expired", req.req_id, priority=req.priority,
                waited_ms=round((now - req.submit_t) * 1e3, 3))

    def _preempt_candidate(self, req: Request) -> Optional[int]:
        """The decode slot a waiting ``req`` may evict: the strictly
        lower-priority (HIGHER class) live decode slot, worst class
        first, latest-admitted within a class. Raw classes compare:
        aging promotes queue order, not the right to evict."""
        cand = [(s.req.priority, s.req.admit_t or 0.0, i)
                for i, s in enumerate(self._slots)
                if s.phase == "decode"]
        if not cand:
            return None
        cls, _, slot_id = max(cand)
        return slot_id if cls > req.priority else None

    def _preempt(self, slot_id: int) -> int:
        """Evict a decode slot: its KV pages stay attached and its
        decode carry (seq_len, last token) is saved on the request, which
        re-enters the queue at its original position."""
        slot = self._slots[slot_id]
        req = slot.req
        req.resume = (slot.seq_len, int(self._h_tok[slot_id]))
        req.preemptions += 1
        self.counters["preemptions"] += 1
        self.counters["requeues"] += 1
        self._queue.requeue(req.qentry)
        if self._obs is not None:
            self._obs.timeline.record(
                "preempt", req.req_id, slot=slot_id,
                priority=req.priority,
                gen_tokens=len(req.tokens), seq_len=slot.seq_len)
        self._clear_slot(slot_id)
        return slot_id

    def _admit_resume(self, slot_id: int, req: Request, now: float):
        """Re-enter decode from the saved carry: the slot gets exactly
        the values the vacated slot held."""
        seq_len, tok = req.resume
        req.resume = None
        table = self.mgr.tables.get(req.req_id)
        if not table:
            raise RuntimeError(
                f"resume of request {req.req_id} without attached KV "
                "pages — preemption must retain the victim's pages")
        slot = self._slots[slot_id]
        slot.req = req
        slot.phase = "decode"
        slot.seq_len = seq_len
        slot.prefill_pos = int(req.prompt.size)
        self._slot_tables[slot_id] = 0
        self._slot_tables[slot_id, :len(table)] = table
        self._slot_wtables[slot_id] = self._slot_tables[slot_id]
        self._h_tok[slot_id] = tok
        self._h_seq[slot_id] = seq_len
        self._h_tables[slot_id] = self._slot_tables[slot_id]
        self._h_temps[slot_id] = self._temp_of(req.gen)
        self._dirty = True
        self._record_admit(req, slot_id, now)

    def _dense_view(self, pool, table, scale):
        """A request's pages of one pool [L, N, BS, KV, hd] (a shard's,
        under a mesh) as a dense [L, 1, MB*BS, KV, hd] view at the model
        type: int8 pages dequantized with their [L, KV] ``scale``."""
        L, _, BS, KV, hd = pool.shape
        view = pool[:, table].reshape(L, 1, self.max_blocks * BS, KV, hd)
        return (view if scale is None
                else dequant_cache(view, scale).to(self.cfg.dtype))

    def _scatter_view(self, pool, table, view, scale):
        """``view`` back into ``pool`` through the table, in place (int8
        pools: quantized with ``scale`` first). Padded table entries are
        all page 0: those duplicate writes land on the scratch page, which
        nothing reads."""
        L, _, BS, KV, hd = pool.shape
        if scale is not None:
            view = quant_cache(view, scale)
        pool[:, table] = view.reshape(L, self.max_blocks, BS, KV, hd)

    def _shards_of(self, params, k_pools, v_pools):
        """(mesh, per-shard params, k pools, v pools) of a program's
        arguments: the engine's mesh, or, meshless, the pools' device as a
        one-shard "gather" mesh, whose op sequence is ``cached_forward``'s
        (equal bit for bit); it names no axis, having no collective."""
        if self._mesh is not None:
            return self._mesh, params, k_pools, v_pools
        return (ServingMesh((k_pools.device,), axis="",
                            collective="gather"),
                [params], [k_pools], [v_pools])

    def _prefill_chunk(self, params, toks, bounds, table, wtable, k_pools,
                       v_pools, scales):
        """One verbatim prefill chunk (the JAX engine's
        ``_make_prefill_fn_ref`` program, and under a mesh
        ``_make_prefill_fn_tp``): each shard gathers the request's pages of
        its KV heads into a dense view through the read ``table`` (page
        indices are global; int8 pools dequantized to the model type with
        the shard's ``scales``), ``_tp_cached_forward`` runs the placement
        over the views at ``bounds[0]``, each view is scattered back in
        place through the WRITE table (int8: quantized back first; shared
        pages go to scratch page 0). -> the logits of row ``bounds[1] -
        1``, [1, V]."""
        sm, shards, k_pools, v_pools = self._shards_of(params, k_pools,
                                                       v_pools)
        tables = sm.replicate(table)
        wtables = sm.replicate(wtable)
        scales = scales or [(None, None)] * sm.tp
        kcs = [self._dense_view(p, t, sc[0])
               for p, t, sc in zip(k_pools, tables, scales)]
        vcs = [self._dense_view(p, t, sc[1])
               for p, t, sc in zip(v_pools, tables, scales)]
        logits, _, _ = _tp_cached_forward(shards, toks, self.cfg, kcs, vcs,
                                          bounds[0], sm)
        for i, (t, sc) in enumerate(zip(wtables, scales)):
            self._scatter_view(k_pools[i], t, kcs[i], sc[0])
            self._scatter_view(v_pools[i], t, vcs[i], sc[1])
        return logits.index_select(1, bounds[1:] - 1)[:, 0]

    def _prefill_chunk_fused(self, params, toks, bounds, table, wtable,
                             k_pools, v_pools, rope, kv_scales, at, mode):
        """One prefill chunk through the fused prefill-block ops (the JAX
        engine's ``_make_prefill_fn_fused`` program): straight over the
        pools, reading the history through ``table``, only the chunk's own
        K/V written, through the WRITE table ``wtable`` (both int32), every
        position read from ``bounds`` on the device (the host's ``at`` =
        (pos0, n) goes to the kernels' checks and plans). -> the logits of
        row ``bounds[1] - 1``, [1, V]."""
        if self._mesh is not None:          # one shard (tp=1)
            params, k_pools, v_pools = params[0], k_pools[0], v_pools[0]
        logits, _, _ = _fused_prefill_forward(
            params, toks[0], self.cfg, k_pools, v_pools, table, wtable,
            at[0], at[1], rope=rope, mode=mode, kv_scales=kv_scales,
            bounds=bounds)
        return logits.index_select(0, bounds[1:] - 1)

    # the prefill chunk over explicit arguments: (params, toks, bounds,
    # table, wtable, temp, gen, k_pools, v_pools, tok, rope, kv_scales, at)
    # -> (tok, gen, k_pools, v_pools), each output written back into the
    # argument _PREFILL_CARRY maps it to (the JAX chunk's (params, toks,
    # pos0, table, wtable, last_idx, temp, key, k_pools, v_pools) -> (tok,
    # key, k_pools, v_pools); its sampled token lands in the bucket's
    # buffer here). The pools and the token buffer are written in place
    _PREFILL_CARRY = {0: 9, 1: 6, 2: 7, 3: 8}    # out idx -> argnum
    _PREFILL_INPLACE = (6, 7, 8, 9)

    def _prefill_args(self, P: int) -> Tuple:
        """Bucket ``P``'s chunk arguments: the engine's tensors and the
        bucket's fixed buffers (the scales the bucket's chunk reads)."""
        buf = self._prefill_bufs[P]
        scales = (self._kv_scales if self._fused_buckets[P]
                  else self._shard_scales)
        return (self.params, buf.toks, buf.bounds, buf.table, buf.wtable,
                buf.temp, self._gen, self._k_pools, self._v_pools, buf.tok,
                self._rope, scales, buf.at)

    def _prefill_step(self, params, toks, bounds, table, wtable, temp, gen,
                      k_pools, v_pools, tok, rope, kv_scales, at, *,
                      fused: bool, mode=None):
        """The prefill program: the fused chunk (``mode``: the route, the
        engine's own by default) or the verbatim one, a token sampled from
        the last prompt row into ``tok``. Bucket ``P``'s captured program
        runs it over :meth:`_prefill_args`; its spec traces it."""
        if fused:
            last = self._prefill_chunk_fused(
                params, toks, bounds, table, wtable, k_pools, v_pools, rope,
                kv_scales, at, mode or self._fused_prefill)
        else:
            last = self._prefill_chunk(params, toks, bounds, table, wtable,
                                       k_pools, v_pools, kv_scales)
        out = (_sample_slots(last, gen, temp), gen, k_pools, v_pools)
        tok.copy_(out[0])
        return out

    def _prefill_body(self, P: int):
        """Bucket ``P``'s chunk over its fixed buffers: the fused or the
        verbatim chunk, the sampled token written into ``tok``."""
        self._prefill_step(*self._prefill_args(P),
                           fused=self._fused_buckets[P])

    def _prefill_key(self) -> Tuple:
        """The prefill programs' key beside the bucket: the registry's
        force pins in "auto" mode (the JAX engine's route key, as
        :meth:`_decode_key`)."""
        from ..ops.kernels.registry import KERNELS
        return (KERNELS.forced_state() if self._fused_prefill == "auto"
                else ())

    def _make_prefill_fn(self, P: int) -> _Program:
        """Bucket ``P``'s prefill program (the JAX engine's
        ``_make_prefill_fn``) of the current key, over the bucket's fixed
        buffers (made at its first program); records the fused chunk's
        variant under the same pins. ``prefill_traces[P]`` counts a build
        on the CPU and a capture on CUDA."""
        if P not in self._prefill_bufs:
            tdt = torch.int32 if self._fused_buckets[P] else torch.int64
            self._prefill_bufs[P] = _ChunkBuffers(P, self.max_blocks, tdt,
                                                  self.device)
        if self._fused_buckets[P]:
            self._prefill_variant = self._resolve_prefill_variant(P)
        traces = self.counters["prefill_traces"]
        traces.setdefault(P, 0)
        if self.device.type != "cuda":
            traces[P] += 1
        engine = weakref.ref(self)   # no cycle through the program

        def body():
            engine()._prefill_body(P)

        def captured():
            traces[P] += 1
        return _Program(body, self.device, self._stream, self._gen,
                        on_capture=captured, pool=self._prefill_pool)

    def _prefill_program(self, P: int) -> _Program:
        key = (P,) + self._prefill_key()
        prog = self._prefill_fns.get(key)
        if prog is None:
            prog = self._prefill_fns[key] = self._make_prefill_fn(P)
        return prog

    def _run_prefill(self) -> bool:
        from ..ops.kernels.fused_prefill_block import prefill_spec_at
        for slot_id, slot in enumerate(self._slots):
            if slot.phase != "prefill":
                continue
            req = slot.req
            S = req.prompt.size
            pos0 = slot.prefill_pos
            n = min(S - pos0, self.buckets[-1])
            P = self._bucket_for(n)
            # the programs read pos0 on the device: check it here
            _check_span(pos0, P, self.max_blocks * self.block_size)
            prog = self._prefill_program(P)
            buf = self._prefill_bufs[P]
            toks = np.zeros(P, np.int64)
            toks[:n] = req.prompt[pos0:pos0 + n]
            t0 = self._clock() if self._obs is not None else 0.0
            if self._flight is not None:
                inv = self._coll_prefill.get(P)
                if inv is None:
                    inv = self._coll_prefill[P] = tuple(
                        self._mesh.collective_inventory(self.cfg, B=1,
                                                        chunk=P))
                tasks = self._record_collectives(inv)
            else:
                tasks = None
            buf.stage(toks, pos0, n, self._slot_tables[slot_id],
                      self._slot_wtables[slot_id], self._temp_of(req.gen))
            prog.prepare()
            prog(respec=lambda sp: prefill_spec_at(sp, pos0, n))
            self._end_collectives(tasks)
            self.counters["prefill_chunks"] += 1
            self.counters["prefill_tokens"] += n
            self.counters["prefill_pad_tokens"] += P - n
            if self._obs is not None:
                # host dispatch time only (the chunk completes on the
                # card behind it; waiting here would ADD a sync)
                dur_ms = (self._clock() - t0) * 1e3
                self._obs.hist("prefill_chunk_ms").observe(dur_ms)
                self._obs.timeline.record(
                    "prefill_chunk", req.req_id, dur_ms=dur_ms,
                    pos0=pos0, n=n, bucket=P,
                    variant=("cuda_fused" if self._fused_buckets[P]
                             else "ref"))
            slot.prefill_pos += n
            if slot.prefill_pos < S:
                # a chunk before the prompt's last: the chunked-prefill
                # handoff's hook (host state only, no sync)
                self._on_prefill_chunk(slot_id)
            if slot.prefill_pos == S:
                first = int(buf.tok[0])      # syncs on the final chunk
                req.first_token_t = self._clock()
                req.ttft = req.first_token_t - req.submit_t
                req.tokens.append(first)
                if self._obs is not None:
                    self._obs.timeline.record(
                        "first_token", req.req_id,
                        ttft_ms=round(req.ttft * 1e3, 3))
                self.counters["tokens_generated"] += 1
                slot.seq_len = S
                if self._pcache is not None:
                    # the prompt's KV is whole now: index it, so requests
                    # sharing the prefix hit while this one decodes
                    # (decode appends at positions >= S, past every
                    # position the tree claims of these pages)
                    self._pcache.insert(
                        req.prompt,
                        list(self.mgr.tables.get(req.req_id, ())))
                self._on_prefill_complete(slot_id, first)
            return True
        return False

    def _on_prefill_chunk(self, slot_id: int):
        """Hook: a chunk before the prompt's last ran (the slot's
        ``prefill_pos`` has advanced, prompt remains). A no-op here; the
        disaggregated engine's prefill worker hands the pages the chunk
        completed to the decode group (``inference/disagg.py``). It reads
        host state only: the chunk is not synced."""

    def _on_prefill_complete(self, slot_id: int, first: int):
        """Prompt prefilled and first token sampled: move the slot to
        decode, or finish on EOS / a one-token budget."""
        slot = self._slots[slot_id]
        req = slot.req
        if (first == req.gen.eos_token_id
                or req.gen.max_new_tokens <= 1):
            self._finish(slot_id)
        else:
            slot.phase = "decode"
            self._h_tok[slot_id] = first
            self._h_seq[slot_id] = slot.seq_len
            self._h_tables[slot_id] = self._slot_tables[slot_id]
            self._h_temps[slot_id] = self._temp_of(req.gen)
            self._dirty = True

    # -- the decode program ------------------------------------------
    # the JAX engine's decode step: (params, tok, seq_lens, tables, temps,
    # key, k_pools, v_pools) -> (tok, seq_lens, key, k_pools, v_pools).
    # Its carry, output index -> argument index, is here the buffer each
    # output is written into: the next tokens into tok's, the lengths into
    # seq_lens'; the pools are written in place and the key is the
    # generator, whose offset the step's draws advance. The port's step
    # takes three more arguments: the logits buffer, the rope tables and
    # the int8 cache's scales (None for fp pools); it writes in place the
    # JAX step's donated arguments and the logits buffer
    _DECODE_CARRY = {0: 1, 1: 2, 2: 5, 3: 6, 4: 7}   # out idx -> argnum
    _DECODE_INPLACE = (1, 2, 5, 6, 7, 8)

    def _decode_args(self):
        """The decode program's arguments: the engine's fixed buffers."""
        pools = (self._k_pools, self._v_pools)
        scales = (self._shard_scales if self._mesh is not None
                  else self._kv_scales)
        return (self.params, self._d_tok, self._d_seq, self._d_tables,
                self._d_temps, self._gen) + pools + (
                    self._d_logits, self._rope, scales)

    def _decode_step(self, params, tok, seq, tables, temps, gen, k_pools,
                     v_pools, logits_buf, rope, kv_scales, mode=None):
        """The decode step over explicit arguments: one token for every
        slot, sampled (from ``logits_buf``, written first), the carry
        written back as ``_DECODE_CARRY`` maps it; returns the outputs.
        ``mode``: the route (the engine's own ``fused_decode`` by default).
        Inactive slots hold seq 0 and stay there; their write landed in
        scratch page 0. The captured decode program runs it over
        :meth:`_decode_args`; its spec traces it."""
        args = (params, tok, seq, tables, temps, gen, k_pools, v_pools)
        mode = self._fused if mode is None else mode
        if self._mesh is not None:
            logits, k_pools, v_pools = _tp_decode_step(
                params, tok, self.cfg, k_pools, v_pools, tables, seq,
                self._mesh, rope=rope, kv_scales=kv_scales, fused=mode)
        elif mode:
            logits, k_pools, v_pools = _fused_decode_step(
                params, tok, self.cfg, k_pools, v_pools, tables, seq,
                rope=rope, mode=mode, kv_scales=kv_scales)
        else:
            logits, k_pools, v_pools = _paged_decode_step(
                params, tok, self.cfg, k_pools, v_pools, tables, seq,
                rope=rope, kv_scales=kv_scales)
        logits_buf.copy_(logits)
        out = (_sample_slots(logits_buf, gen, temps),
               torch.where(seq > 0, seq + 1, 0), gen, k_pools, v_pools)
        for o, a in self._DECODE_CARRY.items():
            if out[o] is not args[a]:
                args[a].copy_(out[o])
        return out

    def _decode_body(self):
        """The decode step over the fixed buffers."""
        self._decode_step(*self._decode_args())

    def _decode_key(self) -> Tuple:
        """The decode program's key: the registry's force pins, which
        "auto" dispatch reads when the program is built. Nothing else that
        dispatch reads changes within an engine (shapes, types, weight and
        pool classes are fixed in the constructor)."""
        from ..ops.kernels.registry import KERNELS
        return KERNELS.forced_state() if self._fused == "auto" else ()

    def _make_decode_fn(self) -> _Program:
        """The decode program (the JAX engine's ``_make_decode_fn``) of the
        current key; records the variant its dispatch picks, under the
        same pins. Counts a build in ``decode_traces`` on the CPU (on CUDA
        the program counts its capture)."""
        if self._fused:
            self._decode_variant = self._resolve_variant()
        if self.device.type != "cuda":
            self.counters["decode_traces"] += 1
        # the program must not keep its engine alive (the engine holds the
        # program): a cycle would keep the pools and the graph's memory
        # until the next full collection
        engine = weakref.ref(self)

        def body():
            engine()._decode_body()

        counters = self.counters

        def captured():
            counters["decode_traces"] += 1
        return _Program(body, self.device, self._stream, self._gen,
                        on_capture=captured)

    def _decode_program(self) -> _Program:
        key = self._decode_key()
        prog = self._decode_fns.get(key)
        if prog is None:
            prog = self._decode_fns[key] = self._make_decode_fn()
        return prog

    def _upload_carry(self):
        """The host mirrors into the decode program's buffers (from pinned
        memory on CUDA, without a sync: no mirror changes before the
        step's token read, which syncs)."""
        for d, h in zip((self._d_tok, self._d_seq, self._d_tables,
                         self._d_temps), self._host_carry.values()):
            d.copy_(h, non_blocking=True)

    def _run_decode(self) -> bool:
        live = [i for i, s in enumerate(self._slots)
                if s.phase == "decode"]
        if not live:
            return False
        prog = self._decode_program()
        if self._dirty:
            self._upload_carry()
            self._dirty = False
        t_obs = self._clock() if self._obs is not None else 0.0
        tasks = self._record_collectives(self._coll_decode)
        prog.prepare()
        if self.device.type == "cuda":
            ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            ev0.record()
            prog()
            ev1.record()
            nxt = self._d_tok.cpu().numpy()    # the per-step host sync
            self._decode_ms += ev0.elapsed_time(ev1)
        else:
            t0 = time.perf_counter()
            prog()
            nxt = self._d_tok.numpy().copy()
            self._decode_ms += (time.perf_counter() - t0) * 1e3
        self._end_collectives(tasks)
        self.counters["decode_steps"] += 1
        self.counters["live_slot_steps"] += len(live)
        if self._obs is not None:
            # dispatch-to-sync wall time: the token read above already
            # synchronizes every step, so this measures real step
            # latency without adding a device round trip
            dur_ms = (self._clock() - t_obs) * 1e3
            self._obs.hist("decode_step_ms").observe(dur_ms)
            # which decode-block implementation served this step
            # (tools/trace_summary.py --mode serving attributes by it)
            v = self.decode_variant
            dv = v["block"] if v["block"] == "cuda_block" else v["attn"]
            self._obs.timeline.record("decode_step", dur_ms=dur_ms,
                                      live_slots=len(live),
                                      decode_variant=dv)
        for i in live:
            slot = self._slots[i]
            req = slot.req
            t = int(nxt[i])
            req.tokens.append(t)
            self.counters["tokens_generated"] += 1
            slot.seq_len += 1
            self._h_seq[i] = slot.seq_len
            self._h_tok[i] = t
            if (t == req.gen.eos_token_id
                    or len(req.tokens) >= req.gen.max_new_tokens):
                self._finish(i)
        return True

    def _calibrate(self, prompt: np.ndarray):
        """The int8 cache's static scales, from one prompt (the JAX
        engine's ``_calibrate``): its first tokens, at most the largest
        bucket, padded with token 0 to their bucket, through a dense
        forward at the model type (the placement's ``_tp_cached_forward``;
        meshless ``cached_forward``'s op sequence); per layer and KV head,
        ``max(absmax / 127, 1e-8)`` of the K and of the V rows written
        there, pad rows included. Each shard takes the absmax over its own
        KV heads, and the shards' scales concatenate to [L, KV] (under
        "gather" the meshless op sequence, so the meshless engine's
        scales)."""
        cfg = self.cfg
        self.counters["calibration_traces"] += 1
        P = self._bucket_for(min(int(prompt.size), self.buckets[-1]))
        n = min(int(prompt.size), P)
        toks = np.zeros((1, P), np.int64)
        toks[0, :n] = prompt[:n]
        toks = self._upload(toks)
        sm, shards, k_pools, _ = self._shards_of(
            self.params, self._k_pools, self._v_pools)
        shape = (cfg.num_hidden_layers, 1, P) + tuple(k_pools[0].shape[3:])
        kcs, vcs = ([torch.zeros(shape, dtype=cfg.dtype, device=d)
                     for d in sm.devices] for _ in range(2))
        _tp_cached_forward(shards, toks, cfg, kcs, vcs, 0, sm)

        def scale(c):
            div = torch.tensor(127.0, device=c.device)
            return torch.clamp_min(
                torch.amax(c.float().abs(), dim=(1, 2, 4)) / div, 1e-8)
        self._shard_scales = [(scale(kc), scale(vc))
                              for kc, vc in zip(kcs, vcs)]
        self._kv_scales = tuple(
            torch.cat([sc[j].to(self.device) for sc in self._shard_scales],
                      dim=1) for j in (0, 1))

    # -- the static program audit -------------------------------------
    def _scales_signature(self, fused: bool):
        """The int8 cache's scales as a program argument: the engine's own
        once calibrated, else their structs ([L, KV] f32 for the fused
        routes, a shard's [L, KV/tp] pair each for the placements); None
        for fp pools."""
        from ..analysis.registry import TensorStruct, abstract_signature
        have = self._kv_scales if fused else self._shard_scales
        if have is not None or not self._quant:
            return abstract_signature(have)
        cfg = self.cfg
        L, KV = cfg.num_hidden_layers, cfg.num_key_value_heads
        tp = 1 if self._mesh is None else self._mesh.tp
        pair = lambda kv: tuple(TensorStruct(                 # noqa: E731
            (L, kv), torch.float32, self.device) for _ in range(2))
        return pair(KV) if fused else [pair(KV // tp) for _ in range(tp)]

    def program_specs(self, register: bool = True, route=None):
        """:class:`~paddle_tpu_torch.analysis.ProgramSpec` entries for the
        engine's programs, under the JAX engine's names: the decode step
        (``serving_decode``, ``serving_decode_fused`` on the two-stage
        "pallas" route, ``serving_decode_block`` on the single-launch
        "block" route), one prefill chunk a bucket
        (``serving_prefill_<P>``, ``serving_prefill_fused_<P>`` on the
        forced fused chunk), with a prefix cache the COW page copier
        (``serving_page_copy``) and with the host tier its window pair
        (``serving_kv_spill_extract``/``serving_kv_restore_insert``);
        ``_tp`` after ``serving_decode``/``serving_prefill``/... under a
        mesh. Each spec's ``fn`` is the code the program runs
        (:meth:`_decode_step`, :meth:`_prefill_step`, the copier,
        :func:`_offload_extract`/:func:`_offload_insert`), its arguments the
        abstract signature of the engine's own buffers (the generator left
        out: a fake trace draws without one, and torch's fake tensors on
        CUDA take none); the in-place arguments and the carry are the JAX
        engine's.

        ``route``: "pallas" or "block" describes that forced route's
        decode step (and, for "pallas", the fused chunk of every bucket)
        in place of the engine's own, as an engine built with the pin
        would run it; off CUDA those programs trace over meta tensors,
        their kernels recorded as launches, as the kernel gate runs the
        wrappers. A mesh takes no forced route here."""
        from ..analysis.registry import (REGISTRY, ProgramSpec,
                                         TensorStruct, abstract_signature,
                                         carry_map)
        if route not in (None, "pallas", "block"):
            raise ValueError(f"route must be None, 'pallas' or 'block', "
                             f"got {route!r}")
        sm = self._mesh
        if route is not None and sm is not None:
            raise ValueError("program_specs(route=...) describes a forced "
                             "single-device route; this engine has a mesh")
        dev = ("meta" if route is not None and self.device.type != "cuda"
               else None)
        tp_sfx = "_tp" if sm is not None else ""
        axes = (sm.axis,) if sm is not None else ()
        tags = ("serving",) + (("tp",) if sm is not None else ())
        dmode = route or self._fused
        decode_name = {"pallas": "serving_decode_fused",
                       "block": "serving_decode_block"}.get(
                           dmode, "serving_decode")
        args = list(abstract_signature(self._decode_args()))
        args[10] = self._scales_signature(sm is None)
        args[5] = None           # the draws traced without the generator
        args = tuple(args)
        import functools
        specs = [ProgramSpec(
            name=decode_name + tp_sfx,
            fn=functools.partial(self._decode_step, mode=dmode), args=args,
            donate_argnums=self._DECODE_INPLACE,
            carry=carry_map(args, self._DECODE_CARRY), mesh_axes=axes,
            tags=tags, device=dev)]
        ppin = route == "pallas" or self._fused_prefill == "pallas"
        prefill_base = ("serving_prefill_fused" if ppin
                        else "serving_prefill")
        pools = abstract_signature((self._k_pools, self._v_pools))
        MB = self.max_blocks
        for P in self.buckets:
            fused = route == "pallas" or self._fused_buckets[P]
            tdt = torch.int32 if fused else torch.int64
            ts = lambda shape, dt: TensorStruct(               # noqa: E731
                shape, dt, self.device)
            args = (abstract_signature(self.params), ts((1, P), torch.int64),
                    ts((2,), torch.int32), ts((MB,), tdt), ts((MB,), tdt),
                    ts((1,), torch.float32), None, *pools,
                    ts((1,), torch.int32),
                    abstract_signature(self._rope),
                    self._scales_signature(fused), (0, P))
            specs.append(ProgramSpec(
                name=f"{prefill_base}{tp_sfx}_{P}",
                fn=functools.partial(
                    self._prefill_step, fused=fused,
                    mode="pallas" if route == "pallas" else None),
                args=args, donate_argnums=self._PREFILL_INPLACE,
                carry=carry_map(args, self._PREFILL_CARRY), mesh_axes=axes,
                tags=tags, device=dev if route == "pallas" else None))
        if self._pcache is not None:
            args = pools + (0, 1)
            specs.append(ProgramSpec(
                name="serving_page_copy" + tp_sfx, fn=self._copy_fn,
                args=args, donate_argnums=(0, 1),
                carry=carry_map(args, {0: 0, 1: 1}), mesh_axes=axes,
                tags=tags))
        if self._kv_offload:
            W = _OFFLOAD_WINDOW
            idx = TensorStruct((W,), torch.int64, self.device)
            windows = [tuple(TensorStruct((W, p.shape[0]) + p.shape[2:],
                                          p.dtype, p.device) for p in pair)
                       for pair in _pairs(*pools)]
            args = pools + (idx, windows)
            specs += [
                ProgramSpec(name="serving_kv_spill_extract" + tp_sfx,
                            fn=_offload_extract, args=pools + (idx,),
                            mesh_axes=axes, tags=tags + ("offload",)),
                ProgramSpec(name="serving_kv_restore_insert" + tp_sfx,
                            fn=_offload_insert, args=args,
                            donate_argnums=(0, 1),
                            carry=carry_map(args, {0: 0, 1: 1}),
                            mesh_axes=axes, tags=tags + ("offload",))]
        if register:
            for s in specs:
                REGISTRY.register(s)
        return specs

    def audit(self, register: bool = True, route=None):
        """Static audit of every engine program (:meth:`program_specs`):
        trace-only, nothing executes, launches, allocates on the device or
        captures; the trace counters are snapshotted and restored. Returns
        the list of :class:`~paddle_tpu_torch.analysis.AuditReport`; the
        finding count lands in the ``audit_findings`` counter."""
        import copy
        from ..analysis.auditor import audit_spec, publish_findings
        snap = {k: copy.deepcopy(self.counters[k])
                for k in ("decode_traces", "prefill_traces",
                          "calibration_traces", "offload_traces")}
        try:
            reports = [audit_spec(s) for s in
                       self.program_specs(register=register, route=route)]
        finally:
            self.counters.update(snap)
        publish_findings(reports, counters=self.counters, obs=self._obs)
        return reports

    def _finish(self, slot_id: int):
        slot = self._slots[slot_id]
        req = slot.req
        req.done = True
        req.finish_t = self._clock()
        if self._obs is not None:
            n_gen = len(req.tokens)
            tpot_ms = (((req.finish_t - req.first_token_t)
                        / (n_gen - 1)) * 1e3
                       if n_gen > 1 and req.first_token_t is not None
                       else None)
            rec = {
                "req_id": req.req_id,
                "prompt_tokens": int(req.prompt.size),
                "gen_tokens": n_gen,
                "queue_wait_ms": (round((req.admit_t - req.submit_t)
                                        * 1e3, 3)
                                  if req.admit_t is not None else None),
                "ttft_ms": (round(req.ttft * 1e3, 3)
                            if req.ttft is not None else None),
                "tpot_ms": (round(tpot_ms, 3)
                            if tpot_ms is not None else None),
                "e2e_ms": round((req.finish_t - req.submit_t) * 1e3, 3),
                "priority": req.priority,
                **({"preemptions": req.preemptions}
                   if req.preemptions else {}),
            }
            # a request whose first token predates the last reset carries
            # a warm-up TTFT: its record stays, the histograms skip it
            # (the predicate metrics() uses for ttft_ms_mean/max)
            cut = self._metrics_reset_t
            self._obs.observe_request(
                rec, stale=(cut is not None
                            and req.first_token_t is not None
                            and req.first_token_t < cut))
            self._obs.timeline.record("finish", req.req_id,
                                      gen_tokens=n_gen)
        if self._pcache is not None and slot.seq_len > 0:
            # the pages go to the radix tree instead of the free list: the
            # valid KV covers the prompt and every generated token but the
            # last sampled one (never written), slot.seq_len positions
            gen_n = slot.seq_len - req.prompt.size
            seq = np.concatenate(
                [req.prompt, np.asarray(req.tokens[:gen_n], np.int32)])
            self._pcache.insert(
                seq, list(self.mgr.tables.get(req.req_id, ())))
        self.mgr.release(req.req_id)
        self._clear_slot(slot_id)
        self.counters["requests_completed"] += 1

    def _clear_slot(self, slot_id: int):
        """Vacate a slot WITHOUT touching the request's KV pages: the
        finish path releases them first; preemption keeps them."""
        slot = self._slots[slot_id]
        slot.req = None
        slot.phase = "idle"
        slot.seq_len = 0
        slot.prefill_pos = 0
        self._slot_tables[slot_id] = 0
        self._slot_wtables[slot_id] = 0
        self._h_tok[slot_id] = 0
        self._h_seq[slot_id] = 0
        self._h_tables[slot_id] = 0
        self._h_temps[slot_id] = 0.0
        self._dirty = True          # vacated slot must not be written
