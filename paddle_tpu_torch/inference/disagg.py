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
engine's keys with observability off; ``observability=``/``telemetry=``
(ROADMAP A8) and the program audit (A12) raise.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import params_to
from ..quantization.ptq import ensure_quantized
from .generation import GenerationConfig
from .serving import Request, ServingEngine, _drain_loop
from .tp import ServingMesh, normalize_mesh

__all__ = ["DisaggregatedEngine"]


def _later_slice(what: str, item: str):
    raise NotImplementedError(
        f"DisaggregatedEngine: {what} is not ported yet (ROADMAP {item})")


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
        if observability or telemetry:
            _later_slice("the observability and telemetry harness", "A8")
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
            fused_decode=False, fused_prefill=fused_prefill,
            mesh=pre_mesh, aging_s=aging_s, clock=clock, device=device,
            on_complete=self._on_prefilled,
            on_chunk=self._on_prefill_chunk)
        self.decode = ServingEngine(
            params, cfg, capacity=capacity, block_size=BS,
            num_blocks=num_blocks, max_seq_len=msl,
            cache_dtype=cache_dtype, prefill_buckets=prefill_buckets,
            seed=seed + 1, prefix_cache=False,
            fused_decode=fused_decode, fused_prefill=fused_prefill,
            mesh=dec_mesh, aging_s=aging_s, clock=clock, device=device)
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
        if self._t_first is None:
            self._t_first = self._clock()
        did = self._run_handoffs()
        did = self.prefill.step() or did
        did = self.decode.step() or did
        if did:
            self._t_last = self._clock()
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
        [L, n, BS, KV_shard, hd]. Where the groups' tp differ, the prefill
        shards' pages are joined on the KV-head axis and cut again (both
        groups are on one device, so nothing moves between devices)."""
        self._count_build("extract")
        k_pools, v_pools = self._pool_shards(self.prefill)
        n_dec = len(self._pool_shards(self.decode)[0])
        idx = _to_index(src, k_pools[0].device)
        out = []
        for pools in (k_pools, v_pools):
            parts = [_words(p).index_select(1, idx).view(p.dtype).view(
                (p.shape[0], len(src)) + p.shape[2:]) for p in pools]
            if len(parts) != n_dec:
                parts = [t.contiguous() for t in
                         torch.cat(parts, dim=3).chunk(n_dec, dim=3)]
            out.append(parts)
        return out[0], out[1]

    def _insert(self, dst: List[int], kpag, vpag):
        """The extracted pages into the decode pools' pages ``dst``, in
        place (the pools keep their storage: the decode step's graph reads
        them)."""
        self._count_build("insert")
        k_pools, v_pools = self._pool_shards(self.decode)
        idx = _to_index(dst, k_pools[0].device)
        for pools, pages in ((k_pools, kpag), (v_pools, vpag)):
            for p, t in zip(pools, pages):
                _words(p).index_copy_(1, idx, _words(t))

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
        kpag, vpag = self._extract(src)
        if job.final:
            pre.mgr.release(req.req_id)
        return {"job": job, "kpag": kpag, "vpag": vpag,
                "dst": dst_table[job.offset:job.offset + n], "pages": n,
                "nbytes": pre._page_nbytes * n, "t0": t0}

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
            return
        self._insert(st["dst"], st["kpag"], st["vpag"])
        dur_ms = (self._clock() - st["t0"]) * 1e3
        self.counters["kv_bytes_transferred"] += st["nbytes"]
        if not job.final:
            self.counters["partial_handoffs"] += 1
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
        """The JAX engine's report with observability off: the handoff
        counters, tokens/s and TTFT over both groups, the handoff's host
        time (issue to landed insert, spanning one orchestrator step), the
        scheduler report, both groups' metrics and the decode group's
        roofline."""
        c = dict(self.counters)
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
        return c

    def reset_metrics(self):
        """Restart the measurement window here and on both groups (the
        handoff build counter is cumulative, like every build counter)."""
        for k in ("handoffs", "partial_handoffs",
                  "kv_bytes_transferred", "requests_submitted",
                  "drain_truncations"):
            self.counters[k] = 0
        self._hand_stats = [0, 0.0, 0.0]
        self._t_first = self._t_last = None
        self._metrics_reset_t = self._clock()
        self._requests = [r for r in self._requests if not r.done]
        self.prefill.reset_metrics()
        self.decode.reset_metrics()

    # -- surfaces of later slices -------------------------------------
    def export_trace(self, path: str) -> str:
        _later_slice("the Chrome trace export", "A8")

    def write_timeline(self, path: str) -> str:
        _later_slice("the timeline export", "A8")

    def program_specs(self, register: bool = True):
        _later_slice("the static program audit", "A12")

    def audit(self, register: bool = True):
        _later_slice("the static program audit", "A12")
