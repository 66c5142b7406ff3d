"""Disaggregated prefill/decode serving with a KV-page handoff (port of
``paddle_tpu/inference/disagg.py``).

- a **prefill group** and a **decode group**, each a
  :class:`~.serving.ServingEngine` over its OWN paged KV pools: the
  prefill group (:class:`_PrefillWorker`) runs only bucketed chunked
  prefill (plus the int8 cache's calibration and the radix prefix cache)
  over pages for the prompt alone, and never builds a decode step; the
  decode group runs only the decode step (one captured CUDA graph on the
  card) and never a chunk.
- a finished prefill hands its KV pages to the decode group: ``extract``
  gathers the request's ``n`` real pages off the prefill pools
  (``index_select`` on the page axis, per shard under a mesh, each page's
  bytes seen as integer words), cut for the
  decode group's shards (joined on the KV-head axis and cut again where
  the groups' tp differ: what the JAX package's ``jax.device_put`` onto
  the decode sharding does), and ``insert`` writes them into the decode
  pools IN PLACE (``index_copy_``). The JAX engine pads the
  page list to a fixed width so that one trace serves every request; eager
  PyTorch has no trace to share, so only the real pages move, and the
  bytes counted are theirs, as in the JAX engine. The pools are never
  rebound: the decode group's captured step reads the pool tensors it was
  captured with, and a rebound pool would leave it reading the old ones.
  The same holds for the int8 cache's scales (:meth:`_sync_scales`).
  **Page-table translation is host-side**: each group's ``BlockManager``
  numbers its own pages; the handoff allocates the decode-side pages and
  the prefill side releases its own (the radix tree keeps its references,
  so warm admissions keep hitting on the prefill group).
- the handoff is **double-buffered**, as in the JAX engine: a transfer's
  extract is issued in one orchestrator step and its insert lands at the
  top of the next (at most two in flight); the request's resume entry is
  pushed only when its final insert has landed.
- **chunked-prefill handoff**: a chunk before a prompt's last streams the
  pages it completed as a partial window (:meth:`ServingEngine.
  _on_prefill_chunk`), but only where the decode pool can already hold the
  whole request; a request that then finishes on the prefill group
  (a one-token budget, or EOS at its first token) queues an abort marker
  that releases its decode-side pages after the inserts ahead of it.

Everything runs on the caller's current stream, one device: stream order
is what makes a final job's early release of its prefill pages safe (its
gather is queued before any later chunk writes those pages). On one card
the groups' work therefore runs back to back; it overlaps only across
cards, which waits for the multi-card backend (ROADMAP A10(b)/A11), as
does any group on a second card.

Greedy parity: the prefill group runs the colocated engine's prefill math
and the decode group its decode math; the handoff moves raw page bytes. On
one device, or under the "gather" placement, greedy output equals the
colocated ``ServingEngine``'s bit for bit. ``metrics()`` has the JAX
engine's keys.

Observability (``observability=``/``telemetry=``, as the JAX engine's):
both groups share the DisaggregatedEngine's timeline ring and
request-record log, each transfer feeds a bound flight recorder
(``kv_handoff@xfer``) plus the ``handoff_ms`` histogram and a
``handoff``/``handoff_partial``/``handoff_abort`` event, and
``export_trace``/``write_timeline`` write the whole engine's trace.
``program_specs``/``audit`` are the static program audit of both groups'
programs and the handoff pair (:mod:`paddle_tpu_torch.analysis`).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import params_to
from ..observability import Observability, TelemetryConfig, TelemetryPlane
from ..quantization.ptq import ensure_quantized
from .generation import GenerationConfig
from .serving import (Request, ServingEngine, _collectives_snapshot,
                      _drain_loop)
from .tp import ServingMesh, normalize_mesh

__all__ = ["DisaggregatedEngine"]

# the engine-level latency set: request-level distributions (fed by
# whichever group admits or finishes the request: the histogram objects
# are SHARED with both groups' registries) plus what only the
# orchestrator can time (handoff, whole-engine step)
DISAGG_HISTOGRAMS = ("ttft_ms", "tpot_ms", "queue_wait_ms", "e2e_ms",
                     "handoff_ms", "step_ms")
# the sub-set shared by reference with the groups' registries
_SHARED_HISTOGRAMS = ("ttft_ms", "tpot_ms", "queue_wait_ms", "e2e_ms")


def _to_index(pages, device) -> torch.Tensor:
    """Page ids as an int64 index on ``device``, through pinned memory on
    CUDA so that the copy does not sync the stream."""
    h = torch.tensor(list(pages), dtype=torch.long)
    if device.type == "cuda":
        h = h.pin_memory()
    return h.to(device, non_blocking=True)


def _words(t: torch.Tensor) -> torch.Tensor:
    """A contiguous pool or page block [L, N, ...] viewed as [L, N, W]: each
    page's bytes as the widest integer words that divide them. The handoff
    copies bytes, and a gather or scatter of fewer, wider elements runs
    about twice as fast (``tools/handoff_copy.py``)."""
    flat = t.view(t.shape[0], t.shape[1], -1)
    nbytes = flat.shape[2] * flat.element_size()
    for dt, size in ((torch.int64, 8), (torch.int32, 4), (torch.int16, 2)):
        if nbytes % size == 0:
            return flat.view(dt)
    return flat.view(torch.int8)


def _handoff_extract(k_pools, v_pools, idx, n_dec: int):
    """The handoff's extract program: the pages ``idx`` of every prefill
    shard's pools (one pool a shard in each list), cut for ``n_dec`` decode
    shards: ([k a decode shard], [v a decode shard]), each [L, n, BS,
    KV_shard, hd]. Each page is read as integer words (:func:`_words`);
    where the groups' tp differ, the prefill shards' pages are joined on
    the KV-head axis and cut again (both groups are on one device, so
    nothing moves between devices)."""
    n = idx.shape[0]
    out = []
    for pools in (k_pools, v_pools):
        parts = [_words(p).index_select(1, idx).view(p.dtype).view(
            (p.shape[0], n) + p.shape[2:]) for p in pools]
        if len(parts) != n_dec:
            parts = [t.contiguous() for t in
                     torch.cat(parts, dim=3).chunk(n_dec, dim=3)]
        out.append(parts)
    return out[0], out[1]


def _handoff_insert(k_pools, v_pools, idx, kpag, vpag):
    """The handoff's insert program: the extracted pages into the decode
    shards' pools at pages ``idx``, in place. -> (k_pools, v_pools)."""
    for pools, pages in ((k_pools, kpag), (v_pools, vpag)):
        for p, t in zip(pools, pages):
            _words(p).index_copy_(1, idx, _words(t))
    return k_pools, v_pools


class _HandoffJob:
    """One queued transfer: a slice of a request's prefill-side pages
    (``src_pages[offset:]``) bound for the decode group. ``final`` carries
    the resume entry; ``abort`` releases the decode-side allocation of a
    request that finished on the prefill group after shipping partials."""

    __slots__ = ("req", "src_pages", "offset", "final", "abort")

    def __init__(self, req: Request, src_pages: List[int], offset: int,
                 final: bool, abort: bool = False):
        self.req = req
        self.src_pages = src_pages
        self.offset = int(offset)
        self.final = final
        self.abort = abort


class _PrefillWorker(ServingEngine):
    """The prefill group: a ServingEngine that allocates KV pages for the
    PROMPT only and, instead of moving a prefilled request into a decode
    slot, vacates the slot (the pages stay attached) and hands the request
    to the DisaggregatedEngine's handoff queue. A chunk before a prompt's
    last reports through ``on_chunk`` (the chunked-prefill handoff).
    Requests that finish during prefill (EOS at the first token, a
    one-token budget) complete here and never reach the decode group."""

    def __init__(self, *args, on_complete=None, on_chunk=None, **kw):
        self._on_complete_cb = on_complete
        self._on_chunk_cb = on_chunk
        super().__init__(*args, **kw)

    def _alloc_tokens(self, req: Request) -> int:
        return int(req.prompt.size)     # generation lives elsewhere

    def _on_prefill_chunk(self, slot_id: int):
        if self._on_chunk_cb is not None:
            slot = self._slots[slot_id]
            self._on_chunk_cb(
                slot.req,
                list(self.mgr.tables.get(slot.req.req_id, ())),
                slot.prefill_pos)

    def _on_prefill_complete(self, slot_id: int, first: int):
        slot = self._slots[slot_id]
        req = slot.req
        if (first == req.gen.eos_token_id
                or req.gen.max_new_tokens <= 1):
            self._finish(slot_id)       # done entirely on this group
            self._on_complete_cb(req, None)
            return
        pages = list(self.mgr.tables.get(req.req_id, ()))
        # vacate the slot but KEEP the pages attached: the handoff owns
        # their transfer to the decode group and their release
        self._clear_slot(slot_id)
        self._on_complete_cb(req, pages)


class DisaggregatedEngine:
    """Prefill/decode-disaggregated serving over two engine groups.

    Construction (one of):

    - neither device lists nor a mesh: both groups on the one device
      ``device`` (None: the CUDA card; ``"cpu"`` runs the kernels' plain
      versions), each meshless: the JAX engine's single-device fallback,
      and the card's case. (The JAX engine splits all visible devices
      when there are two or more; groups on two cards are refused here.)
    - ``prefill_devices=[...], decode_devices=[...]``: each list becomes
      a tp=len(list) :class:`~.tp.ServingMesh`; the devices may repeat.
    - ``mesh=ServingMesh(...)`` (or an int tp over the visible cards) and
      ``prefill_tp=k``: the mesh's first ``k`` shards are the prefill
      group, the rest the decode group (``ServingMesh.split``).

    Every device of both groups must be one device: a group, or a pair of
    groups, on two cards waits for the multi-card backend (ROADMAP
    A10(b)/A11). ``submit()/step()/drain()/metrics()`` mirror the
    colocated :class:`~.serving.ServingEngine`; ``priority``/``deadline_s``
    ride per request. ``weight_quant`` quantizes the tree once here: both
    groups hold the same parameter tensors (one copy of the weights on the
    card).
    """

    def __init__(self, params, cfg, prefill_devices=None,
                 decode_devices=None, mesh=None, prefill_tp: int = 1,
                 collective: str = "psum",
                 capacity: int = 4, prefill_slots: int = 2,
                 block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefill_num_blocks: Optional[int] = None,
                 max_seq_len: Optional[int] = None, cache_dtype=None,
                 prefill_buckets=(32, 128), seed: int = 0,
                 prefix_cache: bool = False, kv_offload=False,
                 observability=False,
                 fused_decode=None, fused_prefill=None,
                 weight_quant=None,
                 aging_s: Optional[float] = None, telemetry=False,
                 clock=None, device=None):
        # one injectable scheduler clock for both groups
        self._clock = clock if clock is not None else time.perf_counter
        pre_mesh, dec_mesh = self._resolve_groups(
            prefill_devices, decode_devices, mesh, prefill_tp, collective)
        where = (resolve_device(device) if pre_mesh is None
                 else pre_mesh.devices[0])
        # quantized ONCE, on the groups' device, so that both groups hold
        # the same tree (the decode group continues exactly the prefill
        # group's math); the workers adopt the carried mode
        params, self._weight_quant = ensure_quantized(
            params_to(params, where), weight_quant)
        self.cfg = cfg
        self.counters = {
            "handoffs": 0, "partial_handoffs": 0, "handoff_traces": 0,
            "kv_bytes_transferred": 0, "requests_submitted": 0,
            "drain_truncations": 0,
        }
        # telemetry implies observability (alerts land timeline events
        # and stall dumps, both owned by the harness)
        _tcfg = TelemetryConfig.coerce(telemetry)
        if observability or _tcfg is not None:
            self._obs = (observability
                         if isinstance(observability, Observability)
                         else Observability(histograms=DISAGG_HISTOGRAMS))
            self._obs.registry.adopt_counters(self.counters)
            pre_obs: object = Observability()
            dec_obs: object = Observability()
        else:
            self._obs = None
            pre_obs = dec_obs = False
        self._flight = None
        if self._obs is not None:
            from ..distributed.flight_recorder import FlightRecorder
            rec = FlightRecorder(capacity=4096)
            rec.enabled = True
            self._flight = self._obs.bind_flight_recorder(rec)
        BS = int(block_size)
        msl = int(max_seq_len or cfg.max_position_embeddings)
        if prefill_num_blocks is None:
            # prompt pages for every prefill slot PLUS slack for pages
            # parked in the handoff queue while the decode pool pushes back
            prefill_num_blocks = \
                (int(prefill_slots) + int(capacity)) * (-(-msl // BS)) + 1
        self.prefill = _PrefillWorker(
            params, cfg, capacity=prefill_slots, block_size=BS,
            num_blocks=prefill_num_blocks, max_seq_len=msl,
            cache_dtype=cache_dtype, prefill_buckets=prefill_buckets,
            seed=seed, prefix_cache=prefix_cache, kv_offload=kv_offload,
            observability=pre_obs,
            fused_decode=False, fused_prefill=fused_prefill,
            mesh=pre_mesh, aging_s=aging_s, clock=clock, device=device,
            on_complete=self._on_prefilled,
            on_chunk=self._on_prefill_chunk)
        self.decode = ServingEngine(
            params, cfg, capacity=capacity, block_size=BS,
            num_blocks=num_blocks, max_seq_len=msl,
            cache_dtype=cache_dtype, prefill_buckets=prefill_buckets,
            seed=seed + 1, prefix_cache=False, observability=dec_obs,
            fused_decode=fused_decode, fused_prefill=fused_prefill,
            mesh=dec_mesh, aging_s=aging_s, clock=clock, device=device)
        if self._obs is not None:
            # one timeline ring + one request-record log for the whole
            # engine: both groups' events interleave with the
            # orchestrator's handoff events, so one JSONL export
            # describes the full request lifecycle
            self.prefill._obs.timeline = self._obs.timeline
            self.decode._obs.timeline = self._obs.timeline
            self.prefill._obs.request_records = self._obs.request_records
            self.decode._obs.request_records = self._obs.request_records
            self._share_histograms()
        # the telemetry plane: the orchestrator rollup plus each group's
        # engine under a `group` label, so a decode-side regression is
        # attributable without un-merging the rollup
        self._telemetry = None
        if _tcfg is not None:
            self._telemetry = TelemetryPlane(
                _tcfg, on_alert=self._telemetry_alert)
            self._telemetry.register("disagg_engine", self.metrics,
                                     counters=self.counters,
                                     skip=("groups",))
            self._telemetry.register(
                "disagg_group", self.prefill.metrics,
                labels={"group": "prefill"},
                counters=self.prefill.counters, skip=("groups",))
            self._telemetry.register(
                "disagg_group", self.decode.metrics,
                labels={"group": "decode"},
                counters=self.decode.counters, skip=("groups",))
        self.block_size = BS
        self.max_seq_len = msl
        self.capacity = int(capacity)
        self.prefill_slots = int(prefill_slots)
        self._quant = self.decode._quant
        # the handoff functions used so far ("extract", "insert"): each
        # counts once in handoff_traces, as a jitted function traces once
        self._handoff_built = set()
        self._handoffs: Deque[_HandoffJob] = deque()
        # issued transfers whose insert lands at the top of the NEXT step
        # (double-buffered: at most two in flight)
        self._inflight: Deque[Dict] = deque()
        self._partial_sent: Dict[int, int] = {}   # req_id -> pages sent
        self._requests: List[Request] = []
        self._hand_stats = [0, 0.0, 0.0]    # count, sum_ms, max_ms
        self._t_first = self._t_last = None
        self._metrics_reset_t = None
        self.last_drain_truncated = False

    # -- group resolution ---------------------------------------------
    @staticmethod
    def _resolve_groups(prefill_devices, decode_devices, mesh, prefill_tp,
                        collective) -> Tuple[Optional[ServingMesh],
                                             Optional[ServingMesh]]:
        """(prefill mesh, decode mesh); (None, None) for the meshless
        single-device groups."""
        if prefill_devices is not None or decode_devices is not None:
            if not prefill_devices or not decode_devices:
                raise ValueError(
                    "explicit groups need BOTH prefill_devices and "
                    "decode_devices non-empty")
            groups = tuple(ServingMesh.make(tp=len(d), collective=collective,
                                            devices=list(d))
                           for d in (prefill_devices, decode_devices))
        elif mesh is not None:
            if isinstance(mesh, int):
                mesh = ServingMesh.make(tp=mesh, collective=collective)
            groups = normalize_mesh(mesh).split(prefill_tp)
        else:
            return None, None
        DisaggregatedEngine._check_one_device(
            groups[0].devices + groups[1].devices)
        return groups

    @staticmethod
    def _check_one_device(devices):
        """Both groups must sit on one device: each group's step is one
        CUDA graph on one card, and the handoff's copy between two cards
        (and any collective across them) waits for the multi-card
        backend."""
        distinct = sorted({str(d) for d in devices})
        if len(distinct) > 1:
            raise ValueError(
                f"DisaggregatedEngine: groups on {len(distinct)} devices "
                f"({', '.join(distinct)}); a prefill and a decode group on "
                "different cards wait for the multi-card backend (ROADMAP "
                "A10(b)/A11): put both groups on one device")

    # -- public API ---------------------------------------------------
    def submit(self, prompt, gen: Optional[GenerationConfig] = None,
               priority: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Enqueue one request on the prefill group (the decode group
        admits it through the KV handoff once its prompt is prefilled)."""
        gen = gen or GenerationConfig()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size >= 1:
            total = int(prompt.size) + int(gen.max_new_tokens)
            need = -(-total // self.decode.block_size)
            if need > self.decode.num_blocks - 1:
                raise ValueError(
                    f"request needs {need} KV pages but the DECODE "
                    f"group's pool only has {self.decode.num_blocks - 1}"
                    "; raise num_blocks")
        req = self.prefill.submit(prompt, gen, priority=priority,
                                  deadline_s=deadline_s)
        self._requests.append(req)
        self.counters["requests_submitted"] += 1
        return req

    def step(self) -> bool:
        """One orchestrator iteration: land the inserts issued last step
        and issue new transfers, then one prefill-group step (admission and
        one chunk) and one decode-group step (resume admission and one
        decode step over every live slot)."""
        obs = self._obs
        t0 = self._clock() if obs is not None else 0.0
        if self._t_first is None:
            self._t_first = self._clock()
        did = self._run_handoffs()
        did = self.prefill.step() or did
        did = self.decode.step() or did
        if did:
            self._t_last = self._clock()
            if obs is not None:
                obs.hist("step_ms").observe(
                    (self._clock() - t0) * 1e3)
        if self._telemetry is not None:
            self._telemetry.on_step()
        return did

    @property
    def idle(self) -> bool:
        return (not self._handoffs and not self._inflight
                and self.prefill.idle and self.decode.idle)

    # -- the fleet router's surface (inference/fleet.py) ---------------
    @property
    def queue_depth(self) -> int:
        """Un-admitted work anywhere in the engine: both groups' admission
        queues plus the handoffs queued or in flight."""
        return (len(self.prefill._queue) + len(self.decode._queue)
                + len(self._handoffs) + len(self._inflight))

    @property
    def live_slots(self) -> int:
        return self.prefill.live_slots + self.decode.live_slots

    @property
    def prefix_cache_version(self) -> int:
        return self.prefill.prefix_cache_version

    def prefix_summary(self):
        """The radix tree lives on the prefill group (where admission
        happens): its summary is this engine's warm-state summary."""
        return self.prefill.prefix_summary()

    def offload_metrics(self) -> Dict:
        return self.prefill.offload_metrics()

    def drain(self, max_steps: Optional[int] = None) -> int:
        """Step until both groups and the handoff queue are empty (the
        shared :func:`~.serving._drain_loop`: a capped drain records the
        truncation; a starved one raises)."""
        return _drain_loop(
            self, max_steps,
            starve_reason="disaggregated drain starved: pending work "
                          "cannot progress",
            starve_error="disaggregated engine starved: pending "
                         "requests cannot be admitted or handed off "
                         "(KV pools too small for the in-flight mix?)")

    def _drain_truncated_event(self, n: int):
        if self._obs is not None:
            self._obs.timeline.record(
                "drain_truncated", steps=n,
                handoff_queue_depth=(len(self._handoffs)
                                     + len(self._inflight)))

    # -- handoff ------------------------------------------------------
    def _need_pages(self, req: Request) -> int:
        return -(-(int(req.prompt.size) + int(req.gen.max_new_tokens))
                 // self.decode.block_size)

    def _on_prefill_chunk(self, req: Request, pages: List[int], pos: int):
        """Chunked-prefill handoff: a chunk before the prompt's last ran;
        queue the prompt pages it completed (every position < ``pos`` is
        final; later chunks rewrite them with identical bytes) as a
        partial transfer. Skipped unless the decode pool can already hold
        the WHOLE request, so a partial never strands half a prompt
        against backpressure."""
        dec = self.decode
        done = pos // self.block_size
        sent = self._partial_sent.get(req.req_id, 0)
        if done <= sent:
            return
        if req.req_id not in dec.mgr.tables:
            if len(dec.mgr.free) < self._need_pages(req):
                return
            dec.mgr.allocate(req.req_id, int(req.prompt.size)
                             + int(req.gen.max_new_tokens))
        self._partial_sent[req.req_id] = done
        self._handoffs.append(
            _HandoffJob(req, pages[:done], sent, final=False))

    def _on_prefilled(self, req: Request, pages: Optional[List[int]]):
        sent = self._partial_sent.pop(req.req_id, 0)
        if pages is None:
            # finished on the prefill group. If partials already went
            # across, an abort marker releases the decode-side pages,
            # queued BEHIND them so that it lands after their inserts
            if req.req_id in self.decode.mgr.tables:
                self._handoffs.append(
                    _HandoffJob(req, [], sent, final=False, abort=True))
            return
        self._handoffs.append(_HandoffJob(req, pages, sent, final=True))

    def _next_startable_job(self) -> Optional[int]:
        """Index of the next job the handoff may start, or None. FIFO,
        except that a job which allocates NOTHING (an abort, a partial, or
        a final whose decode table its partials already made) may overtake
        a page-blocked head: its pages are held already, and completing it
        is the only way they ever free (without it a page-blocked short
        final ahead of a partially sent long one deadlocks the engine). An
        allocating final never overtakes."""
        dec = self.decode
        for i, job in enumerate(self._handoffs):
            needs_alloc = (job.final and not job.abort
                           and job.req.req_id not in dec.mgr.tables)
            if not needs_alloc:
                return i
            if i == 0 and (len(dec.mgr.free)
                           >= self._need_pages(job.req)):
                return i
            # a page-blocked (or non-head) allocating final waits
        return None

    def _run_handoffs(self) -> bool:
        """Land the inserts of the transfers issued LAST step, then issue
        new ones (at most two in flight)."""
        did = False
        while self._inflight:
            self._complete_transfer(self._inflight.popleft())
            did = True
        while self._handoffs and len(self._inflight) < 2:
            idx = self._next_startable_job()
            if idx is None:
                break       # decode-pool backpressure: a finish frees
            job = self._handoffs[idx]
            del self._handoffs[idx]
            if job.abort:
                self._inflight.append({"job": job})
            else:
                self._inflight.append(self._start_transfer(job))
            did = True
        return did

    def _count_build(self, fn: str):
        if fn not in self._handoff_built:
            self._handoff_built.add(fn)
            self.counters["handoff_traces"] += 1

    @staticmethod
    def _pool_shards(eng: ServingEngine):
        """The engine's (k pools, v pools), each a list of one pool a
        shard (one, meshless)."""
        if isinstance(eng._k_pools, list):
            return eng._k_pools, eng._v_pools
        return [eng._k_pools], [eng._v_pools]

    def _extract(self, src: List[int]):
        """The pages ``src`` of every prefill pool, cut for the decode
        group's shards: ([k a decode shard], [v a decode shard]), each
        [L, n, BS, KV_shard, hd] (:func:`_handoff_extract`)."""
        self._count_build("extract")
        k_pools, v_pools = self._pool_shards(self.prefill)
        n_dec = len(self._pool_shards(self.decode)[0])
        return _handoff_extract(k_pools, v_pools,
                                _to_index(src, k_pools[0].device), n_dec)

    def _insert(self, dst: List[int], kpag, vpag):
        """The extracted pages into the decode pools' pages ``dst``, in
        place (:func:`_handoff_insert`; the pools keep their storage: the
        decode step's graph reads them)."""
        self._count_build("insert")
        k_pools, v_pools = self._pool_shards(self.decode)
        _handoff_insert(k_pools, v_pools, _to_index(dst, k_pools[0].device),
                        kpag, vpag)

    def _sync_scales(self):
        """The prefill group's one-shot int8 calibration onto the decode
        group, before the decode group's first step: a copy of the global
        [L, KV] scales, and each decode shard's slice of its KV heads.
        Bound once, never rebound (the captured decode step reads these
        tensors)."""
        dec = self.decode
        dec._kv_scales = tuple(s.clone() for s in self.prefill._kv_scales)
        n = len(self._pool_shards(dec)[0])
        w = dec._kv_scales[0].shape[1] // n
        dec._shard_scales = [tuple(s[:, i * w:(i + 1) * w].contiguous()
                                   for s in dec._kv_scales)
                             for i in range(n)]

    def _start_transfer(self, job: _HandoffJob) -> Dict:
        """Issue one transfer's extract (its insert lands next step):
        host-side page-table translation first (the decode-side
        allocation, reused across a request's partial windows), then the
        gather off the prefill pools onto the decode shards. A FINAL job
        releases the request's prefill-side pages here: the gather is
        queued on the stream ahead of any later chunk that could write
        them, and the radix tree's shared references survive."""
        pre, dec = self.prefill, self.decode
        req = job.req
        if self._quant and dec._kv_scales is None:
            self._sync_scales()
        t0 = self._clock()
        total = int(req.prompt.size) + int(req.gen.max_new_tokens)
        # the decode-side allocation IS the page-table translation: the
        # first len(src_pages) pages receive the prompt's KV, the rest are
        # decode headroom; partial windows extend one table
        dst_table = dec.mgr.allocate(req.req_id, total)
        src = job.src_pages[job.offset:]
        n = len(src)
        task = None
        if self._flight is not None:
            cfg = self.cfg
            task = self._flight.begin(
                "kv_handoff", "xfer",
                (2 * cfg.num_hidden_layers, n * self.block_size,
                 cfg.num_key_value_heads * cfg.head_dim),
                str(pre._pool_dtype).replace("torch.", ""))
        kpag, vpag = self._extract(src)
        t1 = self._clock()
        if job.final:
            pre.mgr.release(req.req_id)
        return {"job": job, "kpag": kpag, "vpag": vpag,
                "dst": dst_table[job.offset:job.offset + n], "pages": n,
                "nbytes": pre._page_nbytes * n, "task": task, "t0": t0,
                "t1": t1}

    def _complete_transfer(self, st: Dict):
        """Land one transfer: the insert into the decode pools, then (final
        jobs only) the resume entry into the decode group's admission
        queue, pushed strictly after the insert, so that the decode group
        never admits onto half-arrived pages. An abort marker releases the
        decode-side allocation instead."""
        job = st["job"]
        req = job.req
        dec = self.decode
        if job.abort:
            dec.mgr.release(req.req_id)
            if self._obs is not None:
                self._obs.timeline.record("handoff_abort", req.req_id)
            return
        t2 = self._clock()
        self._insert(st["dst"], st["kpag"], st["vpag"])
        t3 = self._clock()
        if st["task"] is not None:
            self._flight.end(st["task"])
        dur_ms = (t3 - st["t0"]) * 1e3
        self.counters["kv_bytes_transferred"] += st["nbytes"]
        # host times of the phases; "put" (the JAX engine's copy onto the
        # decode group's devices) is 0: both groups sit on one device
        phase_ms = {
            "extract_ms": round((st["t1"] - st["t0"]) * 1e3, 3),
            "put_ms": 0.0,
            "insert_ms": round((t3 - t2) * 1e3, 3),
        }
        if not job.final:
            self.counters["partial_handoffs"] += 1
            if self._obs is not None:
                self._obs.timeline.record(
                    "handoff_partial", req.req_id, dur_ms=dur_ms,
                    pages=st["pages"], bytes=st["nbytes"], **phase_ms)
            return
        # the resume entry: (prompt length, first sampled token), exactly
        # the colocated engine's decode-entry state; started=True: the
        # admission SLO was met at prefill admission
        req.resume = (int(req.prompt.size), int(req.tokens[-1]))
        req.qentry = dec._queue.push(req, cls=req.priority,
                                     submit_t=req.submit_t, started=True)
        self.counters["handoffs"] += 1
        hs = self._hand_stats
        hs[0] += 1
        hs[1] += dur_ms
        hs[2] = max(hs[2], dur_ms)
        if self._obs is not None:
            self._obs.hist("handoff_ms").observe(dur_ms)
            self._obs.timeline.record(
                "handoff", req.req_id, dur_ms=dur_ms,
                pages=st["pages"], bytes=st["nbytes"], **phase_ms)

    # -- reporting ----------------------------------------------------
    def scheduler_snapshot(self) -> Dict:
        return {"handoff_queue_depth": (len(self._handoffs)
                                        + len(self._inflight)),
                "handoff_inflight": len(self._inflight),
                "handoffs_pending": [j.req.req_id
                                     for j in list(self._handoffs)[:16]],
                "prefill": self.prefill.scheduler_snapshot(),
                "decode": self.decode.scheduler_snapshot()}

    def metrics(self) -> Dict:
        """The JAX engine's report: the handoff counters, tokens/s and
        TTFT over both groups, the handoff's host time (issue to landed
        insert, spanning one orchestrator step), the scheduler report,
        both groups' metrics and the decode group's roofline; with
        observability, the latency histograms, both groups' retrace
        warnings, the stall-dump and timeline counters and the handoff's
        ``collectives``; with telemetry, its snapshot."""
        c = {k: v for k, v in self.counters.items()
             if k not in ("collective_calls", "collective_bytes")}
        pre_m, dec_m = self.prefill.metrics(), self.decode.metrics()
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None
                and self._t_last is not None else 0.0)
        c["wall_time_s"] = round(wall, 6)
        gen_tokens = pre_m["tokens_generated"] + dec_m["tokens_generated"]
        c["tokens_generated"] = gen_tokens
        c["tokens_per_sec"] = (round(gen_tokens / wall, 3)
                               if wall > 0 else 0.0)
        c["requests_completed"] = (pre_m["requests_completed"]
                                   + dec_m["requests_completed"])
        cut = self._metrics_reset_t
        ttfts = [r.ttft for r in self._requests
                 if r.ttft is not None
                 and (cut is None or (r.first_token_t or 0.0) >= cut)]
        c["ttft_ms_mean"] = (round(float(np.mean(ttfts)) * 1e3, 3)
                             if ttfts else None)
        c["ttft_ms_max"] = (round(float(np.max(ttfts)) * 1e3, 3)
                            if ttfts else None)
        n, s, mx = self._hand_stats
        c["handoff_ms_mean"] = round(s / n, 3) if n else None
        c["handoff_ms_max"] = round(mx, 3) if n else None
        sched = self.prefill._scheduler_metrics()
        sched["preemptions"] = dec_m["preemptions"]
        sched["requeues"] = dec_m["requeues"]
        sched["deadline_expired"] = pre_m["deadline_expired"]
        sched["handoff_queue_depth"] = (len(self._handoffs)
                                        + len(self._inflight))
        c["scheduler"] = sched
        c["groups"] = {"prefill": pre_m, "decode": dec_m}
        # the decode group runs the decode steps: its roofline is the
        # engine's (each group also carries its own under "groups")
        c["roofline"] = self.decode._roofline_metrics(
            dec_m["decode_step_ms_mean"])
        if self._obs is not None:
            obs = self._obs
            c["latency"] = obs.latency_snapshot()
            c["retrace_warnings"] = (
                len(self.prefill._obs.watchdog.events)
                + len(self.decode._obs.watchdog.events))
            c["stall_dumps"] = (len(obs.stall_dumps)
                                + obs.stall_dumps_suppressed)
            c["timeline_events"] = len(obs.timeline)
            c["timeline_dropped"] = obs.timeline.dropped
            if self._flight is not None:
                c["collectives"] = _collectives_snapshot(self.counters,
                                                         obs)
        if self._telemetry is not None:
            c["telemetry"] = self._telemetry.snapshot()
        return c

    @property
    def telemetry(self) -> Optional[TelemetryPlane]:
        """The continuous telemetry plane, or None when disabled."""
        return self._telemetry

    def _telemetry_alert(self, alert: Dict):
        """Stamp an ``alert`` timeline event; page-severity alerts also
        land a flight-recorder dump with the whole-engine scheduler
        snapshot (both groups + handoff queue)."""
        obs = self._obs
        if obs is None:
            return
        obs.timeline.record(
            "alert", rule=alert.get("rule"),
            severity=alert.get("severity"), metric=alert.get("metric"),
            value=alert.get("value"), threshold=alert.get("threshold"))
        if (alert.get("severity") == "page"
                and self._telemetry.config.page_dumps):
            obs.stall_dump(
                f"telemetry alert: {alert.get('rule')} on "
                f"{alert.get('metric')}", self.scheduler_snapshot(),
                metrics={"alert": alert})

    def reset_metrics(self):
        """Restart the measurement window here and on both groups (each
        group's retrace watchdog arms; the handoff build counter is
        cumulative, like every build counter)."""
        for k in ("handoffs", "partial_handoffs",
                  "kv_bytes_transferred", "requests_submitted",
                  "drain_truncations"):
            self.counters[k] = 0
        self._hand_stats = [0, 0.0, 0.0]
        self._t_first = self._t_last = None
        self._metrics_reset_t = self._clock()
        self._requests = [r for r in self._requests if not r.done]
        if self._flight is not None:
            self.counters.pop("collective_calls", None)
            self.counters.pop("collective_bytes", None)
        if self._obs is not None:
            self._obs.reset_window()
        self.prefill.reset_metrics()
        self.decode.reset_metrics()
        if self._obs is not None:
            # the groups' reset_window() replaced their histogram
            # objects — re-share the request-level set
            self._share_histograms()

    def _share_histograms(self):
        """Point both groups' request-level latency histograms at the
        engine-level objects: a request admits on the prefill group and
        finishes on the decode group (or on the prefill group for an
        EOS-at-first-token), and its TTFT/TPOT/queue-wait must land in
        ONE distribution wherever it completes."""
        for name in _SHARED_HISTOGRAMS:
            h = self._obs.registry.histogram(name)
            self.prefill._obs.registry.histograms[name] = h
            self.decode._obs.registry.histograms[name] = h

    # -- observability export -----------------------------------------
    @property
    def observability(self) -> Optional[Observability]:
        return self._obs

    def _require_obs(self) -> Observability:
        if self._obs is None:
            raise RuntimeError(
                "observability is disabled for this engine; construct "
                "with DisaggregatedEngine(..., observability=True)")
        return self._obs

    def _decode_roofline(self) -> Dict:
        dec = self.decode
        return dec._roofline_metrics(dec._decode_step_ms_mean())

    def export_trace(self, path: str) -> str:
        """The whole engine's chrome trace: both groups' request rows and
        the handoff spans on the shared timeline, gauge tracks, the
        flight recorder's handoff track and the decode group's roofline
        track."""
        from ..observability.roofline import roofline_chrome_events
        return self._require_obs().export_chrome(
            path, process_name="paddle_tpu disagg serving",
            extra_events=roofline_chrome_events(self._decode_roofline()))

    def write_timeline(self, path: str) -> str:
        """The structured per-phase JSONL of the whole engine."""
        return self._require_obs().write_jsonl(
            path, header={"mode": "serving",
                          "disaggregated": True,
                          "capacity": self.capacity,
                          "prefill_slots": self.prefill_slots,
                          "block_size": self.block_size,
                          "roofline": self._decode_roofline()})

    # -- the static program audit -------------------------------------
    def program_specs(self, register: bool = True):
        """Both groups' programs under the JAX engine's disagg names: the
        decode group's decode step (``disagg_decode``), the prefill group's
        chunk a bucket (``disagg_prefill_<P>``), its page copier and host
        tier pair where it has them, and the handoff pair
        (``disagg_kv_extract`` on the prefill pools, ``disagg_kv_insert``
        into the decode pools, in place), at the JAX engine's fixed width:
        the largest prompt's pages."""
        import dataclasses
        from ..analysis.registry import (REGISTRY, ProgramSpec,
                                         TensorStruct, abstract_signature,
                                         carry_map)
        specs = []
        for s in self.decode.program_specs(register=False):
            if s.name.startswith("serving_decode"):
                specs.append(dataclasses.replace(
                    s, name="disagg_decode", tags=s.tags + ("disagg",)))
        for s in self.prefill.program_specs(register=False):
            if "prefill" in s.name:
                name = "disagg_prefill_" + s.name.rsplit("_", 1)[1]
            elif "page_copy" in s.name:
                name = "disagg_page_copy"
            elif "kv_spill" in s.name or "kv_restore" in s.name:
                # the prefill group's host tier pair
                name = "disagg_" + s.name[len("serving_"):]
            else:              # the prefill group's unused decode step
                continue
            specs.append(dataclasses.replace(s, name=name,
                                             tags=s.tags + ("disagg",)))
        pre = abstract_signature(self._pool_shards(self.prefill))
        dec = abstract_signature(self._pool_shards(self.decode))
        W = -(-self.max_seq_len // self.block_size)
        idx = TensorStruct((W,), torch.long, self.decode.device)
        pages = [TensorStruct((p.shape[0], W) + p.shape[2:], p.dtype,
                              p.device) for p in dec[0]]
        ins_args = dec + (idx, pages, list(pages))
        specs += [
            ProgramSpec(name="disagg_kv_extract", fn=_handoff_extract,
                        args=pre + (idx, len(dec[0])),
                        tags=("serving", "disagg")),
            ProgramSpec(name="disagg_kv_insert", fn=_handoff_insert,
                        args=ins_args, donate_argnums=(0, 1),
                        carry=carry_map(ins_args, {0: 0, 1: 1}),
                        tags=("serving", "disagg"))]
        if register:
            for s in specs:
                REGISTRY.register(s)
        return specs

    def audit(self, register: bool = True):
        """Static audit of every program of both groups (trace-only; the
        groups' trace counters and ``handoff_traces`` are snapshotted and
        restored). Returns the reports; their count of findings lands in
        ``audit_findings``."""
        import copy
        from ..analysis.auditor import audit_spec, publish_findings
        snaps = [(eng.counters, {k: copy.deepcopy(eng.counters[k])
                                 for k in ("decode_traces", "prefill_traces",
                                           "calibration_traces",
                                           "offload_traces")})
                 for eng in (self.prefill, self.decode)]
        h_snap = self.counters["handoff_traces"]
        try:
            reports = [audit_spec(s)
                       for s in self.program_specs(register=register)]
        finally:
            for counters, snap in snaps:
                counters.update(snap)
            self.counters["handoff_traces"] = h_snap
        publish_findings(reports, counters=self.counters, obs=self._obs)
        return reports
