"""Lifecycle model checker over the port's host classes (port of
``paddle_tpu/analysis/lifecycle.py``): exhaustive small-scope exploration
of the page/slot/COW/spill/handoff state machine.

The kernel-geometry gate (:mod:`.kernel_audit`) checks the launches; this
one checks the HOST side of serving. It drives the port's own bookkeeping
classes (``ops/paged_attention.BlockManager``,
``inference/prefix_cache.PrefixCache``, ``inference/admission.
AdmissionQueue``) under a transcription of the scheduling shims of
``inference/serving.ServingEngine`` and ``inference/disagg.
DisaggregatedEngine`` (a fake clock, the device work stubbed: page ids
only, no tensors) through EVERY interleaving of enabled actions at small
scopes (2-3 requests, pools of 4-9 pages), with exact-state dedup, a
bounded depth and BFS, so that the first trace reaching a violation is a
SHORTEST counterexample, replayable as a plain action list.

Each action is one scheduler unit, finer than the engines' ``step()``
(admission to quiescence, one chunk, one decode sweep), so the model
reaches a SUPERSET of the engines' states: a structural violation or a
deadlock found here is one no schedule defines away.

The transcription is the JAX checker's, and it is the port's too: the
port's engines keep the JAX engines' bookkeeping line for line
(``_admit`` with its resume overtake, ``_run_prefill`` calling
``_on_prefill_chunk`` after a chunk before the prompt's last, ``_finish``
indexing ``seq_len`` positions into the tree before the release, the
handoff's partial windows, abort markers, ``_next_startable_job`` and the
prefill-side release when a final job is issued). Where the port's code
differs from the JAX engines', it differs in tensor work the model stubs:
the handoff moves the ``n`` real pages with ``index_select`` /
``index_copy_`` into pools that keep their storage, where the JAX engine
pads a fixed-width page block and rebinds donated pools; the pages and
tables are the same.

Invariants checked after every transition:

- page conservation, free-list integrity, refcount EQUAL to references
  (``BlockManager.check`` and ``PrefixCache.check``, the definitions
  ``PADDLE_TPU_CHECK_INVARIANTS=1`` runs in the engines);
- no page writable through two tables unless shared read-only (a slot's
  next write position clears every tree-claimed span it holds);
- evict never takes a page with refcount > 1 (instrumented around the
  real ``PrefixCache.evict``);
- spilled nodes stay matchable and restore once (residency XOR host
  payload, the offload accounting identity);
- a handoff releases the prefill-side pages once; an abort releases the
  decode-side partial allocation (every page table has a live owner);
- started admissions never expire;
- bounded progress: no reachable pending state without a successor (the
  deadlock class, found by exhaustion, not by timeout).

Findings use the frozen ``Finding`` schema of :mod:`.rules` and gate
against ``lifecycle_baseline.json`` beside this module through ``python -m
paddle_tpu_torch.analysis.lifecycle_audit``.
"""
from __future__ import annotations

import copy
import random
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..inference.admission import AdmissionQueue
from ..inference.prefix_cache import PrefixCache
from ..ops.paged_attention import BlockManager
from .auditor import AuditReport
from .rules import Finding

__all__ = ["ReqSpec", "Scope", "ExploreResult", "make_world", "explore",
           "fuzz", "replay_trace", "SCOPES", "DEMO_SCOPES", "BUGS"]

_SCRATCH = -1       # scratch page owner (page 0, slot-table padding)
_EOS = -1           # sentinel never produced by _gen_tok

# injectable regression bugs (--demo-regression): key -> description
BUGS = {
    "starved_head": "an _admit that breaks on a page-starved head "
                    "instead of admitting the best RESUME entry "
                    "(starvation deadlock)",
    "abort_leak": "disagg abort handoff skips the decode-side "
                  "release (page leak)",
}


class _FakeClock:
    """Deterministic injectable clock — a class (NOT a lambda) so
    ``copy.deepcopy`` rebinds it through the memo and a cloned world
    shares ONE clock instance with its own AdmissionQueue(s)."""

    __slots__ = ("now",)

    def __init__(self, now: float = 0.0):
        self.now = float(now)

    def __call__(self) -> float:
        return self.now


@dataclass(frozen=True)
class ReqSpec:
    """One request in a scope: prompt token ids (< 100 so generated
    ids never collide), generation budget, priority class, optional
    admission deadline (seconds of fake-clock time)."""
    prompt: Tuple[int, ...]
    max_new: int = 1
    priority: int = 1
    deadline: Optional[float] = None


@dataclass(frozen=True)
class Scope:
    """One finite configuration the checker explores exhaustively."""
    name: str
    requests: Tuple[ReqSpec, ...]
    mode: str = "colocated"             # "colocated" | "disagg"
    capacity: int = 1                   # decode slots
    num_blocks: int = 6                 # decode-side page pool
    block_size: int = 2
    chunk: int = 2                      # prefill chunk (bucket) tokens
    prefix_cache: bool = False
    spill: bool = False                 # offload tier (implies cache)
    host_budget: Optional[int] = None
    aging: Optional[float] = None
    clock_max: int = 0                  # explicit `tick` actions allowed
    prefill_slots: int = 1              # disagg prefill group slots
    prefill_blocks: Optional[int] = None
    max_states: int = 60000
    max_depth: int = 80
    bug: Optional[str] = None           # BUGS key (demo scopes only)
    note: str = ""


class _SimReq:
    """Host-side request bookkeeping (the checker's Request analog)."""

    __slots__ = ("rid", "prompt", "max_new", "priority", "deadline",
                 "submitted", "done", "expired", "resume", "qentry",
                 "tokens", "submit_t", "admit_t", "preemptions")

    def __init__(self, rid: int, spec: ReqSpec):
        self.rid = rid
        self.prompt = tuple(int(t) for t in spec.prompt)
        self.max_new = int(spec.max_new)
        self.priority = int(spec.priority)
        self.deadline = spec.deadline
        self.submitted = False
        self.done = False
        self.expired = False
        self.resume = None          # (seq_len, last_token) carry
        self.qentry = None
        self.tokens: List[int] = []
        self.submit_t = 0.0
        self.admit_t = None
        self.preemptions = 0


class _Slot:
    __slots__ = ("req", "phase", "seq_len", "prefill_pos", "shared")

    def __init__(self):
        self.req = None
        self.phase = "idle"
        self.seq_len = 0
        self.prefill_pos = 0
        self.shared = 0


def _gen_tok(req: _SimReq, k: int) -> int:
    """Deterministic generated token ids, unique per (request, step)
    and disjoint from prompt ids (< 100) and ``_EOS``: interleavings
    that reach the same scheduling state hash identically."""
    return 1000 + req.rid * 100 + k


class _Group:
    """One scheduling domain: a REAL BlockManager (+ optional REAL
    PrefixCache) + REAL AdmissionQueue + slots, driven by a faithful
    transcription of serving.py's admit/prefill/decode/finish paths.
    ``prompt_only=True`` is the disagg _PrefillWorker variant."""

    def __init__(self, name: str, scope: Scope, num_blocks: int,
                 capacity: int, clock: _FakeClock,
                 prompt_only: bool = False,
                 prefix_cache: bool = False):
        self.name = name
        self.bs = scope.block_size
        self.chunk = scope.chunk
        self.num_blocks = num_blocks
        self.prompt_only = prompt_only
        self.clock = clock
        self.mgr = BlockManager(num_blocks, self.bs, num_blocks)
        scratch = self.mgr.allocate(_SCRATCH, 1)
        assert scratch == [0], "scratch must be page 0"
        self.pcache = None
        if prefix_cache:
            kw = {}
            if scope.spill:
                kw = dict(spill_pages=self._spill_stub,
                          restore_pages=self._restore_stub,
                          host_budget_pages=scope.host_budget)
            self.pcache = PrefixCache(self.mgr, self.bs,
                                      copy_page=self._copy_stub, **kw)
        self.queue = AdmissionQueue(aging_s=scope.aging, clock=clock)
        self.slots = [_Slot() for _ in range(capacity)]
        # disagg hooks (bound methods deepcopy through the memo)
        self.on_chunk = None        # fn(req, pages, pos)
        self.on_complete = None     # fn(req, pages_or_None)

    # -- stubbed device programs (host bookkeeping only) --------------
    def _copy_stub(self, src: int, dst: int):
        pass                        # COW page copy: bytes not modeled

    def _spill_stub(self, pages):
        return [True] * len(pages)  # payload: presence only

    def _restore_stub(self, payloads, dsts):
        pass

    # -- transcribed scheduler (serving.py) ---------------------------
    def alloc_tokens(self, req: _SimReq) -> int:
        if self.prompt_only:
            return len(req.prompt)          # _PrefillWorker override
        return len(req.prompt) + req.max_new

    def need_pages(self, req: _SimReq) -> int:
        return -(-self.alloc_tokens(req) // self.bs)

    def acquire_pages(self, req: _SimReq):
        """serving._acquire_pages: (ok, acquired)."""
        need = self.need_pages(req)
        if self.pcache is None:
            return len(self.mgr.free) >= need, None
        acquired = self.pcache.acquire(
            req.prompt, len(req.prompt) - 1, need)
        return acquired is not None, acquired

    def idle_slot(self) -> Optional[int]:
        return next((i for i, s in enumerate(self.slots)
                     if s.phase == "idle"), None)

    def preempt_candidate(self, req: _SimReq) -> Optional[int]:
        cand = [(s.req.priority, s.req.admit_t or 0.0, i)
                for i, s in enumerate(self.slots)
                if s.phase == "decode"]
        if not cand:
            return None
        cls, _, slot_id = max(cand)
        return slot_id if cls > req.priority else None

    def preempt(self, slot_id: int) -> int:
        """serving._preempt: carry saved, pages stay attached, entry
        requeued at its original line position with started=True."""
        slot = self.slots[slot_id]
        req = slot.req
        req.resume = (slot.seq_len, req.tokens[-1])
        req.preemptions += 1
        self.queue.requeue(req.qentry)
        self.clear_slot(slot_id)
        return slot_id

    def admit_resume(self, slot_id: int, req: _SimReq, now: float):
        seq_len, _tok = req.resume
        req.resume = None
        table = self.mgr.tables.get(req.rid)
        if not table:
            raise RuntimeError(
                f"resume of request {req.rid} without attached KV "
                "pages — preemption must retain the victim's pages")
        slot = self.slots[slot_id]
        slot.req = req
        slot.phase = "decode"
        slot.seq_len = seq_len
        slot.prefill_pos = len(req.prompt)
        slot.shared = 0
        if req.admit_t is None:
            req.admit_t = now

    def admit_once(self, now: float,
                   allow_overtake: bool = True) -> Optional[str]:
        """ONE iteration of serving._admit's while loop (iterations are
        atomic in the real scheduler, so this is the natural action
        unit). Returns "admit" / "preempt" (an admission that evicted a
        victim) / None (blocked; no state mutated).
        ``allow_overtake=False`` re-injects the fixed starvation bug:
        break on a page-starved head instead of admitting a resume
        entry."""
        if not self.queue:
            return None
        entry = self.queue.best(now)
        req = entry.item
        slot_id = self.idle_slot()
        victim = None
        if slot_id is None:
            victim = self.preempt_candidate(req)
            if victim is None:
                return None
        acquired = None
        if req.resume is None:
            ok, acquired = self.acquire_pages(req)
            if not ok:
                if not allow_overtake:
                    return None         # BUG "starved_head"
                entry = self.queue.best(
                    now, pred=lambda e: e.item.resume is not None)
                if entry is None:
                    return None
                req = entry.item
                if slot_id is None:
                    victim = self.preempt_candidate(req)
                    if victim is None:
                        return None
        preempted = False
        if slot_id is None:
            slot_id = self.preempt(victim)
            preempted = True
        self.queue.remove(entry)
        if req.resume is not None:
            self.admit_resume(slot_id, req, now)
            return "preempt" if preempted else "admit"
        matched = shared = 0
        if acquired is not None:
            pages, matched, shared = acquired
            self.mgr.attach(req.rid, pages, owned=True)
        self.mgr.allocate(req.rid, self.alloc_tokens(req))
        slot = self.slots[slot_id]
        slot.req = req
        slot.phase = "prefill"
        slot.seq_len = 0
        slot.prefill_pos = matched
        slot.shared = shared
        if req.admit_t is None:
            req.admit_t = now
        return "preempt" if preempted else "admit"

    def prefill_step(self, slot_id: int):
        """serving._run_prefill for ONE slot's next chunk."""
        slot = self.slots[slot_id]
        req = slot.req
        S = len(req.prompt)
        n = min(S - slot.prefill_pos, self.chunk)
        slot.prefill_pos += n
        if slot.prefill_pos < S:
            if self.on_chunk is not None:
                self.on_chunk(req,
                              list(self.mgr.tables.get(req.rid, ())),
                              slot.prefill_pos)
            return
        first = _gen_tok(req, 0)
        req.tokens.append(first)
        slot.seq_len = S
        if self.pcache is not None:
            self.pcache.insert(req.prompt,
                               list(self.mgr.tables.get(req.rid, ())))
        self.prefill_complete(slot_id)

    def prefill_complete(self, slot_id: int):
        slot = self.slots[slot_id]
        req = slot.req
        if self.prompt_only:
            # disagg _PrefillWorker._on_prefill_complete
            if req.max_new <= 1:
                self.finish(slot_id)
                self.on_complete(req, None)
                return
            pages = list(self.mgr.tables.get(req.rid, ()))
            self.clear_slot(slot_id)
            self.on_complete(req, pages)
            return
        if req.max_new <= 1:
            self.finish(slot_id)
        else:
            slot.phase = "decode"

    def decode_step(self, slot_id: int, eos: bool = False):
        slot = self.slots[slot_id]
        req = slot.req
        t = _EOS if eos else _gen_tok(req, len(req.tokens))
        req.tokens.append(t)
        slot.seq_len += 1
        if eos or len(req.tokens) >= req.max_new:
            self.finish(slot_id)

    def finish(self, slot_id: int):
        """serving._finish: index prompt+generated KV into the tree
        (exactly seq_len positions — the last sampled token's KV was
        never written), then release and vacate."""
        slot = self.slots[slot_id]
        req = slot.req
        req.done = True
        if self.pcache is not None and slot.seq_len > 0:
            gen_n = slot.seq_len - len(req.prompt)
            seq = req.prompt + tuple(req.tokens[:gen_n])
            self.pcache.insert(seq,
                               list(self.mgr.tables.get(req.rid, ())))
        self.mgr.release(req.rid)
        self.clear_slot(slot_id)

    def expire_sweep(self, now: float) -> int:
        """serving._admit's expiry preamble as a standalone sweep."""
        expired = self.queue.pop_expired(now)
        for entry in expired:
            req = entry.item
            req.done = True
            req.expired = True
            if req.rid in self.mgr.tables:      # defensive (serving.py)
                self.mgr.release(req.rid)
        return len(expired)

    def clear_slot(self, slot_id: int):
        slot = self.slots[slot_id]
        slot.req = None
        slot.phase = "idle"
        slot.seq_len = 0
        slot.prefill_pos = 0
        slot.shared = 0


class _Job:
    """disagg._HandoffJob analog (page ids only)."""

    __slots__ = ("rid", "src_pages", "offset", "final", "abort")

    def __init__(self, rid: int, src_pages, offset: int, final: bool,
                 abort: bool = False):
        self.rid = rid
        self.src_pages = tuple(src_pages)
        self.offset = int(offset)
        self.final = final
        self.abort = abort

    def key(self):
        return (self.rid, self.src_pages, self.offset, self.final,
                self.abort)


def _classify(msg: str) -> Tuple[str, str]:
    """Map a BlockManager/PrefixCache.check problem string to the
    finding (code, site) pair — sites name invariants, so fingerprints
    stay stable while messages carry the specifics."""
    m = msg.lower()
    if "negative" in m:
        return "REFCOUNT_NEGATIVE", "refcount"
    if "leaked" in m:
        return "PAGE_LEAK", "page_conservation"
    if "free list" in m or "free page" in m:
        return "FREE_LIST", "free_list"
    if "refcount" in m or "over-share" in m or "references" in m:
        return "REFCOUNT", "refcount"
    if ("host" in m or "offload" in m or "spilled" in m
            or "resident" in m):
        return "OFFLOAD", "offload_accounting"
    return "STRUCTURE", "tree_structure"


class _World:
    """Shared action/check machinery; subclasses wire the groups."""

    def __init__(self, scope: Scope):
        self.scope = scope
        self.clock = _FakeClock(0.0)
        self.reqs = [_SimReq(i, s) for i, s in enumerate(scope.requests)]
        self.bug = scope.bug
        self._step_problems: List[Tuple[str, str, str]] = []

    # -- shared actions -----------------------------------------------
    def submit(self, i: int, group: "_Group"):
        req = self.reqs[i]
        req.submitted = True
        req.submit_t = self.clock.now
        req.qentry = group.queue.push(req, cls=req.priority,
                                      submit_t=req.submit_t,
                                      deadline_s=req.deadline)

    def _evict_instrumented(self, g: _Group):
        """Run the REAL evict for one page, instrumented for the
        'evict never touches refcount>1' invariant (pure refcount
        equality cannot see it — the eviction itself decrefs)."""
        before = {nd.page: int(g.mgr.refcount[nd.page])
                  for nd in g.pcache._walk() if nd.page is not None}
        g.pcache.evict(1)
        resident = {nd.page for nd in g.pcache._walk()
                    if nd.page is not None}
        for p, rc in before.items():
            if p not in resident and rc != 1:
                self._step_problems.append((
                    "EVICT_PINNED", "evict_refcount",
                    f"[{g.name}] evict removed page {p} with refcount "
                    f"{rc} (shared pages are pinned, never evictable)"))

    def _restore_one(self, g: _Group) -> bool:
        """Restore-ahead: bring the canonically-first spilled node
        back on device through the REAL restore path (the same code
        acquire() runs on a prefix hit over spilled nodes)."""
        spilled = [nd for nd in self._tree_nodes(g.pcache)
                   if nd.page is None and nd.host is not None]
        if not spilled or not g.mgr.free:
            return False
        g.pcache._restore_nodes([spilled[0]])
        return True

    @staticmethod
    def _tree_nodes(pcache):
        """Deterministic preorder walk (dicts preserve insertion
        order, which is itself deterministic per path)."""
        out = []
        stack = [pcache.root]
        while stack:
            nd = stack.pop()
            if nd is not pcache.root:
                out.append(nd)
            stack.extend(reversed(list(nd.children.values())))
        return out

    # -- invariants ---------------------------------------------------
    def _group_problems(self, g: _Group):
        out = []
        if g.pcache is not None:
            probs = g.pcache.check(raise_on_violation=False)
        else:
            probs = g.mgr.check(raise_on_violation=False)
            # no tree: refcounts must EQUAL table references exactly
            table_refs = np.zeros(g.num_blocks, np.int64)
            for table in g.mgr.tables.values():
                for p in table:
                    if 0 <= p < g.num_blocks:
                        table_refs[p] += 1
            for p in range(g.num_blocks):
                if int(g.mgr.refcount[p]) != int(table_refs[p]):
                    probs.append(
                        f"page {p} refcount {int(g.mgr.refcount[p])} "
                        f"!= {int(table_refs[p])} table references")
        for msg in probs:
            code, site = _classify(msg)
            out.append((code, site, f"[{g.name}] {msg}"))
        return out

    def _write_exclusivity(self, g: _Group):
        """No page is writable through two tables unless shared read-
        only: for every tree-claimed page a live slot holds, the
        slot's next write position must clear the claimed token span,
        and the table index must equal the claim's page depth."""
        if g.pcache is None:
            return []
        out = []
        claims = {}                 # page -> (depth, claim_end, partial)
        def walk(nd, depth):
            for ch in nd.children.values():
                if ch.page is not None:
                    claims[ch.page] = (depth,
                                       depth * g.bs + len(ch.tokens),
                                       len(ch.tokens) < g.bs)
                walk(ch, depth + 1)
        walk(g.pcache.root, 0)
        for slot in g.slots:
            if slot.req is None:
                continue
            w = (slot.prefill_pos if slot.phase == "prefill"
                 else slot.seq_len)
            for i, p in enumerate(g.mgr.tables.get(slot.req.rid, ())):
                if p not in claims:
                    continue
                depth, cend, _partial = claims[p]
                if i != depth:
                    out.append((
                        "WRITE_SHARED", "write_exclusive",
                        f"[{g.name}] slot of req {slot.req.rid} holds "
                        f"tree page {p} at table index {i} but the "
                        f"tree claims it at depth {depth}"))
                elif w < cend:
                    out.append((
                        "WRITE_SHARED", "write_exclusive",
                        f"[{g.name}] req {slot.req.rid} may write from "
                        f"position {w} into tree-claimed span ending "
                        f"{cend} of page {p}"))
        # partial-claim pages are COW-only: never shared across tables
        table_count = {}
        for sid, table in g.mgr.tables.items():
            if sid == _SCRATCH:
                continue
            for p in set(table):
                table_count[p] = table_count.get(p, 0) + 1
        for p, (depth, cend, partial) in claims.items():
            if partial and table_count.get(p, 0) >= 2:
                out.append((
                    "WRITE_SHARED", "write_exclusive",
                    f"[{g.name}] partial-tail page {p} shared by "
                    f"{table_count[p]} tables (partials are COW-only)"))
        return out

    def _request_problems(self):
        out = []
        for req in self.reqs:
            if req.expired and (req.admit_t is not None
                                or req.resume is not None):
                out.append((
                    "STARTED_EXPIRED", "started_never_expires",
                    f"req {req.rid} expired after service started "
                    f"(admit_t={req.admit_t}, resume={req.resume})"))
        return out

    def check(self) -> List[Tuple[str, str, str]]:
        out = list(self._step_problems)
        self._step_problems = []
        for g in self.groups():
            out.extend(self._group_problems(g))
            out.extend(self._write_exclusivity(g))
        out.extend(self._request_problems())
        out.extend(self._reachability())
        return out

    # -- state key helpers --------------------------------------------
    @staticmethod
    def _queue_key(queue: AdmissionQueue):
        return (queue._next_seq, tuple(sorted(
            (e.seq, e.item.rid, e.cls, e.submit_t, e.deadline_s or -1.0,
             e.started) for e in queue._entries)))

    @staticmethod
    def _tree_key(pcache):
        ticks = sorted({nd.last_used
                        for nd in _World._tree_nodes(pcache)})
        rank = {t: i for i, t in enumerate(ticks)}

        def node_key(nd):
            kids = tuple(sorted(node_key(ch)
                                for ch in nd.children.values()))
            return (nd.tokens, nd.page if nd.page is not None else -1,
                    nd.host is not None, rank.get(nd.last_used, 0),
                    kids)
        return tuple(sorted(node_key(ch)
                            for ch in pcache.root.children.values()))

    def _group_key(self, g: _Group):
        return (
            tuple(g.mgr.free),
            tuple(int(x) for x in g.mgr.refcount),
            tuple(sorted((sid, tuple(t))
                         for sid, t in g.mgr.tables.items())),
            self._queue_key(g.queue),
            tuple((s.req.rid if s.req is not None else -1, s.phase,
                   s.seq_len, s.prefill_pos, s.shared)
                  for s in g.slots),
            self._tree_key(g.pcache) if g.pcache is not None else None,
            g.pcache._host_pages if g.pcache is not None else 0,
        )

    def _req_key(self):
        return tuple((r.submitted, r.done, r.expired, r.resume,
                      len(r.tokens), r.submit_t,
                      -1.0 if r.admit_t is None else r.admit_t)
                     for r in self.reqs)


class ColocatedWorld(_World):
    """ServingEngine transcription: one group, prompt+gen allocation."""

    def __init__(self, scope: Scope):
        super().__init__(scope)
        self.g = _Group("engine", scope, scope.num_blocks,
                        scope.capacity, self.clock,
                        prefix_cache=scope.prefix_cache or scope.spill)

    def groups(self):
        return [self.g]

    def pending(self) -> bool:
        return any(r.submitted and not r.done for r in self.reqs)

    def actions(self):
        out = []
        for i, r in enumerate(self.reqs):
            if not r.submitted:
                out.append(("submit", i))
        if self.clock.now < self.scope.clock_max:
            out.append(("tick",))
        now = self.clock.now
        expired = any(e.expired(now) for e in self.g.queue._entries)
        if expired:
            out.append(("expire",))
        elif self.g.queue:
            out.append(("admit",))
        for s, slot in enumerate(self.g.slots):
            if slot.phase == "prefill":
                out.append(("prefill", s))
            elif slot.phase == "decode":
                out.append(("decode", s))
                if len(slot.req.tokens) + 1 < slot.req.max_new:
                    out.append(("finish", s))
        if self.g.pcache is not None:
            if self.g.pcache.evictable_count() > 0:
                out.append(("evict",))
            if self.scope.spill and self.g.mgr.free and any(
                    nd.host is not None
                    for nd in self._tree_nodes(self.g.pcache)):
                out.append(("restore",))
        return out

    def apply(self, action) -> Tuple[bool, str]:
        kind = action[0]
        if kind == "submit":
            self.submit(action[1], self.g)
            return True, f"submit:{action[1]}"
        if kind == "tick":
            self.clock.now += 1.0
            return True, "tick"
        if kind == "expire":
            n = self.g.expire_sweep(self.clock.now)
            return n > 0, "expire"
        if kind == "admit":
            label = self.g.admit_once(
                self.clock.now,
                allow_overtake=self.bug != "starved_head")
            return label is not None, label or "admit"
        if kind == "prefill":
            self.g.prefill_step(action[1])
            return True, f"prefill:{action[1]}"
        if kind == "decode":
            self.g.decode_step(action[1])
            return True, f"decode:{action[1]}"
        if kind == "finish":
            self.g.decode_step(action[1], eos=True)
            return True, f"finish:{action[1]}"
        if kind == "evict":
            kind2 = ("evict_spill" if self.scope.spill else "evict_drop")
            self._evict_instrumented(self.g)
            return True, kind2
        if kind == "restore":
            return self._restore_one(self.g), "restore"
        raise ValueError(f"unknown action {action!r}")

    def _reachability(self):
        """Every page table must have a live owner; resume entries
        must hold pages; fresh queue entries must hold none."""
        g = self.g
        out = []
        allowed = {_SCRATCH}
        for slot in g.slots:
            if slot.req is not None:
                allowed.add(slot.req.rid)
        for e in g.queue._entries:
            req = e.item
            if req.resume is not None:
                allowed.add(req.rid)
                if req.rid not in g.mgr.tables:
                    out.append((
                        "RESUME_NO_PAGES", "resume_pages",
                        f"queued resume entry for req {req.rid} holds "
                        "no KV pages (resume would crash)"))
            elif req.rid in g.mgr.tables:
                out.append((
                    "PAGE_LEAK", "table_reachability",
                    f"fresh queued req {req.rid} already owns a page "
                    "table"))
        for sid in g.mgr.tables:
            if sid not in allowed and not any(
                    e.item.rid == sid for e in g.queue._entries):
                out.append((
                    "PAGE_LEAK", "table_reachability",
                    f"page table of req {sid} has no live owner (slot, "
                    "queue entry or scratch)"))
        return out

    def summary(self) -> Dict:
        g = self.g
        return {
            "clock": self.clock.now,
            "free_pages": len(g.mgr.free),
            "queue": [(e.item.rid, e.cls, e.item.resume is not None)
                      for e in g.queue._entries],
            "slots": [(s.req.rid if s.req else None, s.phase)
                      for s in g.slots],
            "requests": [(r.rid, "done" if r.done else
                          "queued" if r.submitted else "unsubmitted")
                         for r in self.reqs],
        }

    def state_key(self):
        return (self.clock.now, self._req_key(), self._group_key(self.g))


class DisaggWorld(_World):
    """DisaggregatedEngine transcription: prompt-only prefill group,
    decode group, double-buffered handoff queue with partial windows
    and abort markers."""

    def __init__(self, scope: Scope):
        super().__init__(scope)
        pre_blocks = scope.prefill_blocks or scope.num_blocks
        self.pre = _Group("prefill", scope, pre_blocks,
                          scope.prefill_slots, self.clock,
                          prompt_only=True)
        self.dec = _Group("decode", scope, scope.num_blocks,
                          scope.capacity, self.clock)
        self.pre.on_chunk = self._on_prefill_chunk
        self.pre.on_complete = self._on_prefilled
        self.handoffs: List[_Job] = []
        self.inflight: deque = deque()
        self.partial_sent: Dict[int, int] = {}

    def groups(self):
        return [self.pre, self.dec]

    def pending(self) -> bool:
        return (any(r.submitted and not r.done for r in self.reqs)
                or bool(self.handoffs) or bool(self.inflight))

    # -- transcribed handoff plumbing (disagg.py) ---------------------
    def _need_total(self, req: _SimReq) -> int:
        return -(-(len(req.prompt) + req.max_new) // self.scope.block_size)

    def _on_prefill_chunk(self, req: _SimReq, pages, pos: int):
        done = pos // self.scope.block_size
        sent = self.partial_sent.get(req.rid, 0)
        if done <= sent:
            return
        if req.rid not in self.dec.mgr.tables:
            if len(self.dec.mgr.free) < self._need_total(req):
                return
            self.dec.mgr.allocate(req.rid,
                                  len(req.prompt) + req.max_new)
        self.partial_sent[req.rid] = done
        self.handoffs.append(_Job(req.rid, pages[:done], sent,
                                  final=False))

    def _on_prefilled(self, req: _SimReq, pages):
        sent = self.partial_sent.pop(req.rid, 0)
        if pages is None:
            if req.rid in self.dec.mgr.tables:
                self.handoffs.append(_Job(req.rid, (), sent,
                                          final=False, abort=True))
            return
        self.handoffs.append(_Job(req.rid, pages, sent, final=True))

    def _next_startable_job(self) -> Optional[int]:
        for i, job in enumerate(self.handoffs):
            needs_alloc = (job.final and not job.abort
                           and job.rid not in self.dec.mgr.tables)
            if not needs_alloc:
                return i
            if i == 0 and (len(self.dec.mgr.free)
                           >= self._need_total(self.reqs[job.rid])):
                return i
        return None

    def _start_job(self) -> str:
        idx = self._next_startable_job()
        job = self.handoffs.pop(idx)
        if job.abort:
            self.inflight.append(job)
            return "extract:abort"
        req = self.reqs[job.rid]
        self.dec.mgr.allocate(req.rid, len(req.prompt) + req.max_new)
        if job.final:
            self.pre.mgr.release(req.rid)
        self.inflight.append(job)
        return "extract:final" if job.final else "extract:partial"

    def _complete_job(self) -> str:
        job = self.inflight.popleft()
        req = self.reqs[job.rid]
        if job.abort:
            if self.bug != "abort_leak":
                self.dec.mgr.release(req.rid)
            return "abort"
        if not job.final:
            return "insert:partial"
        req.resume = (len(req.prompt), req.tokens[-1])
        req.qentry = self.dec.queue.push(req, cls=req.priority,
                                         submit_t=req.submit_t,
                                         started=True)
        return "insert:final"

    # -- action machinery ---------------------------------------------
    def actions(self):
        out = []
        for i, r in enumerate(self.reqs):
            if not r.submitted:
                out.append(("submit", i))
        if self.clock.now < self.scope.clock_max:
            out.append(("tick",))
        now = self.clock.now
        expired = any(e.expired(now) for e in self.pre.queue._entries)
        if expired:
            out.append(("expire",))
        elif self.pre.queue:
            out.append(("admit", "pre"))
        if self.dec.queue:
            out.append(("admit", "dec"))
        for s, slot in enumerate(self.pre.slots):
            if slot.phase == "prefill":
                out.append(("prefill", s))
        for s, slot in enumerate(self.dec.slots):
            if slot.phase == "decode":
                out.append(("decode", s))
                if len(slot.req.tokens) + 1 < slot.req.max_new:
                    out.append(("finish", s))
        if len(self.inflight) < 2 and self._next_startable_job() is not None:
            out.append(("handoff_start",))
        if self.inflight:
            out.append(("handoff_complete",))
        return out

    def apply(self, action) -> Tuple[bool, str]:
        kind = action[0]
        if kind == "submit":
            self.submit(action[1], self.pre)
            return True, f"submit:{action[1]}"
        if kind == "tick":
            self.clock.now += 1.0
            return True, "tick"
        if kind == "expire":
            n = self.pre.expire_sweep(self.clock.now)
            return n > 0, "expire"
        if kind == "admit":
            g = self.pre if action[1] == "pre" else self.dec
            label = g.admit_once(
                self.clock.now,
                allow_overtake=self.bug != "starved_head")
            return (label is not None,
                    f"{label or 'admit'}:{action[1]}")
        if kind == "prefill":
            self.pre.prefill_step(action[1])
            return True, f"prefill:{action[1]}"
        if kind == "decode":
            self.dec.decode_step(action[1])
            return True, f"decode:{action[1]}"
        if kind == "finish":
            self.dec.decode_step(action[1], eos=True)
            return True, f"finish:{action[1]}"
        if kind == "handoff_start":
            return True, self._start_job()
        if kind == "handoff_complete":
            return True, self._complete_job()
        raise ValueError(f"unknown action {action!r}")

    def _reachability(self):
        out = []
        job_rids = ({j.rid for j in self.handoffs}
                    | {j.rid for j in self.inflight})
        final_queued = {j.rid for j in self.handoffs
                        if j.final and not j.abort}
        # prefill side: scratch + live slots + queued (not yet issued)
        # final jobs — _start_transfer releases the prefill table
        pre_allowed = {_SCRATCH} | final_queued
        for slot in self.pre.slots:
            if slot.req is not None:
                pre_allowed.add(slot.req.rid)
        for e in self.pre.queue._entries:
            if e.item.rid in self.pre.mgr.tables:
                out.append((
                    "PAGE_LEAK", "table_reachability",
                    f"[prefill] queued req {e.item.rid} already owns "
                    "a page table"))
            pre_allowed.add(e.item.rid)
        for sid in self.pre.mgr.tables:
            if sid not in pre_allowed:
                out.append((
                    "HANDOFF_RELEASE", "handoff_release",
                    f"[prefill] page table of req {sid} survived its "
                    "handoff (prefill pages must release exactly once)"))
        # decode side: scratch + live slots + resume queue + partial
        # windows in progress + any queued/inflight job (incl. abort)
        dec_allowed = ({_SCRATCH} | set(self.partial_sent) | job_rids)
        for slot in self.dec.slots:
            if slot.req is not None:
                dec_allowed.add(slot.req.rid)
        for e in self.dec.queue._entries:
            req = e.item
            dec_allowed.add(req.rid)
            if req.resume is not None and req.rid not in self.dec.mgr.tables:
                out.append((
                    "RESUME_NO_PAGES", "resume_pages",
                    f"[decode] queued resume entry for req {req.rid} "
                    "holds no KV pages"))
        for sid in self.dec.mgr.tables:
            if sid in dec_allowed:
                continue
            if 0 <= sid < len(self.reqs) and self.reqs[sid].done:
                out.append((
                    "ABORT_LEAK", "abort_release",
                    f"[decode] req {sid} finished on the prefill group "
                    "but its decode-side partial allocation was never "
                    "released (abort must release exactly once)"))
            else:
                out.append((
                    "PAGE_LEAK", "table_reachability",
                    f"[decode] page table of req {sid} has no live "
                    "owner"))
        return out

    def summary(self) -> Dict:
        return {
            "clock": self.clock.now,
            "prefill_free": len(self.pre.mgr.free),
            "decode_free": len(self.dec.mgr.free),
            "prefill_queue": [e.item.rid
                              for e in self.pre.queue._entries],
            "decode_queue": [e.item.rid
                             for e in self.dec.queue._entries],
            "handoffs": [j.key() for j in self.handoffs],
            "inflight": [j.key() for j in self.inflight],
            "requests": [(r.rid, "done" if r.done else
                          "queued" if r.submitted else "unsubmitted")
                         for r in self.reqs],
        }

    def state_key(self):
        return (self.clock.now, self._req_key(),
                self._group_key(self.pre), self._group_key(self.dec),
                tuple(j.key() for j in self.handoffs),
                tuple(j.key() for j in self.inflight),
                tuple(sorted(self.partial_sent.items())))


def make_world(scope: Scope) -> _World:
    for spec in scope.requests:
        need = -(-(len(spec.prompt)
                   + (0 if scope.mode == "disagg" else spec.max_new))
                 // scope.block_size)
        dec_need = -(-(len(spec.prompt) + spec.max_new)
                     // scope.block_size)
        pool = ((scope.prefill_blocks or scope.num_blocks)
                if scope.mode == "disagg" else scope.num_blocks)
        if need > pool - 1 or dec_need > scope.num_blocks - 1:
            raise ValueError(
                f"scope {scope.name}: request {spec} cannot fit its "
                "pool — the checker would report a trivial deadlock")
    if scope.mode == "disagg":
        return DisaggWorld(scope)
    return ColocatedWorld(scope)


# ---------------------------------------------------------------------
# exploration
# ---------------------------------------------------------------------

@dataclass
class ExploreResult:
    """One scope's exploration: the audit report plus search stats."""
    report: AuditReport
    states: int = 0
    transitions: int = 0
    truncated: bool = False
    wall_s: float = 0.0


def _finding(scope: Scope, code: str, site: str, message: str,
             trace, labels, state: Optional[Dict] = None) -> Finding:
    detail = {"scope": scope.name,
              "trace": [list(a) for a in trace],
              "labels": list(labels)}
    if scope.bug:
        detail["injected_bug"] = scope.bug
    if state is not None:
        detail["state"] = state
    return Finding(rule="lifecycle", code=code, severity="error",
                   program=f"lifecycle_{scope.name}", site=site,
                   message=message, detail=detail)


def explore(scope: Scope, max_states: Optional[int] = None,
            max_depth: Optional[int] = None,
            deadline_s: Optional[float] = None) -> ExploreResult:
    """BFS over every interleaving of enabled actions from the empty
    world. Each generated state is invariant-checked BEFORE dedup (a
    violation is never masked by an earlier clean path to the same
    key); violating states are reported once per fingerprint — with
    the BFS-shortest trace — and not expanded. A pending state with
    zero successors (below the depth cap) is the deadlock class."""
    max_states = max_states or scope.max_states
    max_depth = max_depth or scope.max_depth
    t0 = time.perf_counter()
    root = make_world(scope)
    findings: List[Finding] = []
    seen_fp = set()

    def report(code, site, message, trace, labels, state=None):
        f = _finding(scope, code, site, message, trace, labels, state)
        if f.fingerprint not in seen_fp:
            seen_fp.add(f.fingerprint)
            findings.append(f)

    for code, site, msg in root.check():
        report(code, site, msg, (), ())
    visited = {root.state_key()}
    frontier = deque([(root, 0, (), ())])
    states, transitions, truncated = 1, 0, False
    while frontier:
        if deadline_s is not None \
                and time.perf_counter() - t0 > deadline_s:
            truncated = True
            break
        world, depth, trace, labels = frontier.popleft()
        if depth >= max_depth:
            truncated = True
            continue
        successors = 0
        for action in world.actions():
            child = copy.deepcopy(world)
            try:
                changed, label = child.apply(action)
            except RuntimeError as exc:
                transitions += 1
                report("CRASH", "runtime_assert", str(exc),
                       trace + (action,), labels + (f"crash:{action[0]}",))
                continue
            if not changed:
                continue
            successors += 1
            transitions += 1
            t2, l2 = trace + (action,), labels + (label,)
            problems = child.check()
            if problems:
                for code, site, msg in problems:
                    report(code, site, msg, t2, l2,
                           state=child.summary())
                continue                    # do not expand violations
            key = child.state_key()
            if key in visited:
                continue
            if len(visited) >= max_states:
                truncated = True
                continue
            visited.add(key)
            states += 1
            frontier.append((child, depth + 1, t2, l2))
        if successors == 0 and world.pending():
            report("DEADLOCK", "bounded_progress",
                   "reachable state where drain cannot advance: no "
                   "enabled action makes progress but requests are "
                   "still pending",
                   trace, labels, state=world.summary())
    wall = time.perf_counter() - t0
    rep = AuditReport(
        program=f"lifecycle_{scope.name}", findings=findings,
        rules_run=["lifecycle"],
        meta={"mode": scope.mode, "states": states,
              "transitions": transitions, "truncated": truncated,
              "wall_s": round(wall, 3), "max_depth": max_depth,
              "max_states": max_states,
              **({"injected_bug": scope.bug} if scope.bug else {}),
              **({"note": scope.note} if scope.note else {})})
    return ExploreResult(report=rep, states=states,
                         transitions=transitions, truncated=truncated,
                         wall_s=wall)


def fuzz(scope: Scope, n_walks: int, seed: int = 0,
         max_len: int = 200) -> ExploreResult:
    """Deterministic random walks for scopes past exhaustive reach:
    walk ``w`` draws from ``random.Random(f"{seed}:{w}")`` over the
    deterministically-ordered enabled actions, mutating ONE world in
    place (no clones), invariant-checking after every applied action.
    A failing walk reports the exact action trace — replayable
    byte-for-byte with :func:`replay_trace`."""
    t0 = time.perf_counter()
    findings: List[Finding] = []
    seen_fp = set()
    transitions = 0
    for w in range(n_walks):
        rng = random.Random(f"{seed}:{w}")
        world = make_world(scope)
        trace: Tuple = ()
        labels: Tuple = ()
        for _ in range(max_len):
            acts = world.actions()
            progressed = False
            while acts and not progressed:
                action = acts.pop(rng.randrange(len(acts)))
                try:
                    progressed, label = world.apply(action)
                except RuntimeError as exc:
                    f = _finding(scope, "CRASH", "runtime_assert",
                                 str(exc), trace + (action,),
                                 labels + (f"crash:{action[0]}",))
                    f.detail["walk"] = w
                    f.detail["seed"] = seed
                    if f.fingerprint not in seen_fp:
                        seen_fp.add(f.fingerprint)
                        findings.append(f)
                    progressed = None
                    break
            if progressed is None:
                break
            if not progressed:
                if world.pending():
                    f = _finding(scope, "DEADLOCK", "bounded_progress",
                                 "random walk wedged: no enabled "
                                 "action makes progress but requests "
                                 "are still pending", trace, labels,
                                 state=world.summary())
                    f.detail["walk"] = w
                    f.detail["seed"] = seed
                    if f.fingerprint not in seen_fp:
                        seen_fp.add(f.fingerprint)
                        findings.append(f)
                break
            transitions += 1
            trace += (action,)
            labels += (label,)
            problems = world.check()
            if problems:
                for code, site, msg in problems:
                    f = _finding(scope, code, site, msg, trace, labels,
                                 state=world.summary())
                    f.detail["walk"] = w
                    f.detail["seed"] = seed
                    if f.fingerprint not in seen_fp:
                        seen_fp.add(f.fingerprint)
                        findings.append(f)
                break
    wall = time.perf_counter() - t0
    rep = AuditReport(
        program=f"lifecycle_{scope.name}", findings=findings,
        rules_run=["lifecycle_fuzz"],
        meta={"mode": scope.mode, "walks": n_walks, "seed": seed,
              "transitions": transitions, "wall_s": round(wall, 3),
              **({"injected_bug": scope.bug} if scope.bug else {})})
    return ExploreResult(report=rep, states=0, transitions=transitions,
                         truncated=False, wall_s=wall)


def replay_trace(scope: Scope, trace: Sequence[Sequence]
                 ) -> Tuple[_World, List[Tuple[str, str, str]]]:
    """Re-apply a counterexample's action list on a fresh world.
    Returns ``(world, problems)`` where ``problems`` is the first
    non-empty invariant-check result along the trace (empty when the
    whole trace stays clean) — the test-side half of the trace
    format's replayability contract."""
    world = make_world(scope)
    problems = world.check()
    if problems:
        return world, problems
    for step in trace:
        action = tuple(step)
        try:
            changed, _label = world.apply(action)
        except RuntimeError as exc:
            return world, [("CRASH", "runtime_assert", str(exc))]
        problems = world.check()
        if problems:
            return world, problems
    return world, []


# ---------------------------------------------------------------------
# scope catalog
# ---------------------------------------------------------------------
# The committed gate: every scope here must explore CLEAN (0 findings
# in lifecycle_baseline.json). Sizes are chosen so the union covers
# >= 10^4 distinct states yet finishes well under a minute on CPU.

SCOPES: Dict[str, Scope] = {s.name: s for s in (
    Scope(
        name="coloc_nocache",
        note="priorities + deadline expiry + aging + preemption/requeue"
             " on the bare allocator (no prefix tree): refcount == "
             "table references exactly",
        requests=(ReqSpec((1, 2, 3), max_new=2, priority=1),
                  ReqSpec((1, 2), max_new=2, priority=0, deadline=1.5),
                  ReqSpec((5, 6), max_new=2, priority=2)),
        capacity=2, num_blocks=6, block_size=2, chunk=2,
        aging=1.0, clock_max=2),
    Scope(
        name="coloc_prefix",
        note="radix sharing + COW forks + evict-drop under page "
             "pressure: write-exclusivity over tree claims",
        requests=(ReqSpec((1, 2, 3, 4), max_new=2),
                  ReqSpec((1, 2, 3, 4), max_new=2),
                  ReqSpec((1, 2, 7), max_new=1)),
        capacity=2, num_blocks=8, block_size=2, chunk=2,
        prefix_cache=True),
    Scope(
        name="coloc_spill",
        note="host-offload tier: evict-spill, restore-on-hit, "
             "restore-ahead, host budget enforcement",
        requests=(ReqSpec((1, 2, 3, 4), max_new=1),
                  ReqSpec((1, 2, 5, 6), max_new=1)),
        capacity=1, num_blocks=5, block_size=2, chunk=2,
        prefix_cache=True, spill=True, host_budget=1),
    Scope(
        name="disagg",
        note="chunked-prefill partial handoff windows, final handoff "
             "with prefill-side release, abort of a prefill-finished "
             "request, decode-group resume + preemption",
        requests=(ReqSpec((1, 2, 3, 4), max_new=2, priority=1),
                  ReqSpec((5, 6), max_new=2, priority=0),
                  ReqSpec((7, 8, 9, 10), max_new=1, priority=1)),
        mode="disagg", capacity=1, prefill_slots=1,
        num_blocks=9, prefill_blocks=6, block_size=2, chunk=2),
)}

# --demo-regression: verbatim re-injections of two fixed lifecycle
# bugs; each MUST produce a finding with a short replayable trace.
DEMO_SCOPES: Dict[str, Scope] = {s.name: s for s in (
    Scope(
        name="demo_starved_head",
        note="the fixed _admit break-on-starved-head: a preempted "
             "victim parks behind a page-short fresh head forever",
        requests=(ReqSpec((1, 2, 3, 4), max_new=2, priority=1),
                  ReqSpec((5, 6), max_new=2, priority=0),
                  ReqSpec((7, 8, 9, 10), max_new=2, priority=0)),
        capacity=1, num_blocks=6, block_size=2, chunk=4,
        bug="starved_head"),
    Scope(
        name="demo_abort_leak",
        note="abort handoff that skips the decode-side release: the "
             "partial-window allocation of a prefill-finished request "
             "leaks",
        requests=(ReqSpec((1, 2, 3, 4), max_new=1),),
        mode="disagg", capacity=1, prefill_slots=1,
        num_blocks=6, prefill_blocks=4, block_size=2, chunk=2,
        bug="abort_leak"),
)}
