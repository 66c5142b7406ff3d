"""Radix prefix cache: copy-on-write KV page sharing across requests (port
of ``paddle_tpu/inference/prefix_cache.py``).

Serving traffic (system prompts, few-shot templates, multi-turn chat)
repeats long token prefixes. This module turns the paged ``BlockManager``
from a per-request allocator into a CROSS-REQUEST cache: a radix tree
indexes token-id prefixes at PAGE granularity, and each tree node owns one
ref-counted physical page in the pools.

- FULL pages (``block_size`` tokens) are shared IN PLACE: a longest-prefix
  match at admission appends the matched physical pages to the request's
  block table (incref), and the request prefills only its un-cached
  suffix. Matching full pages is page-aligned and capped at
  ``len(prompt) - 1`` tokens, so every position a request writes (suffix
  prefill and decode appends) lands in a page it owns; the engine's WRITE
  table also sends the shared entries to scratch page 0.
- The PARTIALLY-FILLED TAIL page of a cached sequence is never shared in
  place: it is handed out only as a COPY-ON-WRITE fork (fresh page +
  device copy), so a divergent continuation writes its own copy.
- KV pages are position-causal (the KV at position i depends only on
  tokens <= i), so any PREFIX of a cached page's valid tokens is valid too.
- EVICTION is LRU over refcount-1 leaves (tree-only pages; a page shared
  with a live request has refcount >= 2 and is pinned), cascading upward.
  It runs on demand through ``BlockManager.reclaim`` when the free list is
  dry.
- HOST-RAM OFFLOAD TIER (``spill_pages``/``restore_pages`` from the pool
  owner): eviction SPILLS the victims' bytes to host memory (pinned on
  CUDA, :func:`host_put`) and the nodes stay in the tree with
  ``page=None``; a later hit RESTORES them, byte-identical.
  ``host_budget_pages`` bounds the tier; past it the LRU childless spilled
  node is dropped for real.

The tree is host bookkeeping, a copy of the JAX package's (plain Python
and numpy there too); the device work it asks for is the one-page COW copy
(:func:`make_page_copier`) and the owner's spill/restore pair. The decode
and prefill programs do not change with it: a shared page reaches the
captured decode step through its table buffer.
"""
from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.paged_attention import BlockManager

__all__ = ["PrefixCache", "PagedKVCacheStore", "host_put",
           "make_page_copier"]


def host_put(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bytes in host memory, copied raw (no cast: the
    spill/restore byte-identity contract). From a CUDA tensor into pinned
    memory without a host sync: the copy is ordered on the current stream
    before any later kernel that reuses the page, and the caching host
    allocator keeps the buffer until it is done. From a CPU tensor, a plain
    copy."""
    if x.device.type == "cuda":
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x, non_blocking=True)
        return out
    return x.clone()


class _Node:
    """One radix-tree node owning ONE physical KV page.

    ``tokens`` (a tuple of 1..block_size ids) are the tokens whose KV
    the page holds. A node with ``len(tokens) == block_size`` is a full
    page: shareable in place and extendable with children. A shorter
    node is a partial tail: leaf-only, handed out via COW fork, and
    upgradeable in place when a later insert extends it.

    With the offload tier a node is either RESIDENT (``page`` set,
    ``host`` None) or SPILLED (``page`` None, ``host`` holding the
    page's bytes in host memory); spilled nodes stay matchable and
    restore on demand."""

    __slots__ = ("tokens", "page", "children", "parent", "last_used",
                 "host")

    def __init__(self, tokens: Tuple[int, ...], page: Optional[int],
                 parent: Optional["_Node"]):
        self.tokens = tokens
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = 0
        self.host = None


def _common(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class PrefixCache:
    """Radix index over one ``BlockManager``'s pages.

    ``copy_page(src, dst)`` is supplied by the pool owner (ServingEngine
    or PagedKVCacheStore) and copies one physical page on the device — the
    COW primitive. The cache installs itself as the manager's ``reclaim``
    callback so allocation pressure drives eviction.

    ``spill_pages(pages) -> payloads`` / ``restore_pages(payloads,
    dsts)`` (both supplied, or neither) enable the host-RAM offload
    tier: eviction spills instead of dropping, and a prefix hit on a
    spilled node restores before sharing — both move whole batches so
    the owner can window the transfers. ``host_budget_pages`` caps the
    tier (None = unbounded); past it the LRU childless spilled node
    dies."""

    def __init__(self, mgr: BlockManager, block_size: int,
                 copy_page: Callable[[int, int], None],
                 host_budget_pages: Optional[int] = None,
                 spill_pages: Optional[Callable] = None,
                 restore_pages: Optional[Callable] = None):
        if (spill_pages is None) != (restore_pages is None):
            raise ValueError("spill_pages and restore_pages come as a "
                             "pair: a tier that can spill but not "
                             "restore would silently drop warm KV")
        self.mgr = mgr
        self.bs = int(block_size)
        self.copy_page = copy_page
        # the batched offload pair: spill_pages(pages) -> one opaque
        # per-page payload each; restore_pages(payloads, dsts) — the pool
        # owner moves whole batches in fixed-width multi-page windows
        # (serving.py's _spill_pages / _restore_pages)
        self._spill_batch = spill_pages
        self._restore_batch = restore_pages
        self.host_budget = (None if host_budget_pages is None
                            else int(host_budget_pages))
        self.root = _Node((), None, None)
        self._tick = 0
        self._host_pages = 0
        # bumped on every structural change (insert/evict/spill/
        # restore/drop): the fleet router's tree-summary staleness check
        self.version = 0
        self.stats = {"hits": 0, "misses": 0, "tokens_skipped": 0,
                      "shared_pages": 0, "cow_forks": 0,
                      "evicted_pages": 0, "inserted_pages": 0,
                      "spilled_pages": 0, "restored_pages": 0,
                      "readopted_pages": 0, "host_evicted_pages": 0}
        mgr.reclaim = self.evict

    # -- introspection ------------------------------------------------
    def _walk(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    @property
    def cached_pages(self) -> int:
        """Device-RESIDENT tree pages (spilled nodes hold no page)."""
        return sum(1 for n in self._walk() if n.page is not None)

    @property
    def host_pages(self) -> int:
        """Pages currently living in the host tier."""
        return self._host_pages

    def evictable_count(self) -> int:
        """Pages reclaimable right now: nodes whose whole subtree is
        unpinned (refcount 1, i.e. tree-only — eviction is leaf-first,
        so a pinned descendant blocks its ancestors; a spilled node
        holds no page and pins nothing)."""
        def walk(n: _Node) -> Tuple[int, bool]:
            cnt, free_sub = 0, True
            for ch in n.children.values():
                c, f = walk(ch)
                cnt += c
                free_sub = free_sub and f
            if n is self.root:
                return cnt, False
            if n.page is None:
                return cnt, free_sub
            if free_sub and int(self.mgr.refcount[n.page]) == 1:
                return cnt + 1, True
            return cnt, False
        return walk(self.root)[0]

    def metrics(self) -> Dict:
        m = dict(self.stats)
        m["cached_pages"] = self.cached_pages
        m["evictable_pages"] = self.evictable_count()
        m["host_pages"] = self._host_pages
        return m

    def check(self, raise_on_violation: bool = True):
        """Structural + accounting invariant sweep over the radix tree
        and its BlockManager — the single definition shared by the
        lifecycle model checker (analysis/lifecycle.py) and the
        engines' opt-in per-step self-check
        (``PADDLE_TPU_CHECK_INVARIANTS=1``). Returns violation strings
        (empty = clean); raises when ``raise_on_violation``. Runs the
        manager's own check first, then the cross-structure checks only
        the tree can do:

        - node structure: ``parent.children`` keyed by the child's
          EXACT token tuple (the upgrade-in-place rekey contract),
          parent back-pointers consistent, token runs 1..block_size,
          partial tails (< block_size tokens) leaf-only;
        - residency: every non-root node is resident (page set, host
          None) XOR spilled (page None, host payload kept matchable);
          resident pages valid, never free-listed, refcount >= 1 (the
          tree's own reference), and distinct across nodes;
        - host tier: ``host_pages`` equals the spilled-node count,
          never exceeds the budget, and the accounting identity
          spilled == restored + readopted + host_evicted + host_pages
          stays closed;
        - refcount EQUALITY: every page's refcount equals its table
          references plus its tree references — no reference is ever
          leaked or double-counted anywhere in the serving stack.
        """
        problems = self.mgr.check(raise_on_violation=False)
        tree_refs: Dict[int, int] = {}
        n_spilled = 0
        for parent in [self.root] + list(self._walk()):
            for key, ch in parent.children.items():
                if key != ch.tokens:
                    problems.append(
                        f"child keyed {key} but holds tokens "
                        f"{ch.tokens} (rekey bug: keyed delete misses)")
                if ch.parent is not parent:
                    problems.append(
                        f"node {ch.tokens} parent pointer broken")
        for nd in self._walk():
            nt = len(nd.tokens)
            if not (1 <= nt <= self.bs):
                problems.append(
                    f"node has {nt} tokens (must be 1..{self.bs})")
            if nt < self.bs and nd.children:
                problems.append(
                    f"partial tail {nd.tokens} has children (partials "
                    "are COW-only leaves)")
            if (nd.page is None) == (nd.host is None):
                problems.append(
                    f"node {nd.tokens} is neither cleanly resident nor "
                    f"spilled (page={nd.page}, host set="
                    f"{nd.host is not None})")
            if nd.page is not None:
                if not (0 <= nd.page < self.mgr.num_blocks):
                    problems.append(
                        f"node {nd.tokens} holds invalid page {nd.page}")
                    continue
                tree_refs[nd.page] = tree_refs.get(nd.page, 0) + 1
                if tree_refs[nd.page] > 1:
                    problems.append(
                        f"page {nd.page} owned by two tree nodes")
                if int(self.mgr.refcount[nd.page]) < 1:
                    problems.append(
                        f"resident node {nd.tokens} page {nd.page} has "
                        f"refcount {int(self.mgr.refcount[nd.page])}")
            elif nd.host is not None:
                n_spilled += 1
        if n_spilled != self._host_pages:
            problems.append(
                f"host_pages counter {self._host_pages} != "
                f"{n_spilled} spilled nodes in the tree")
        if self.host_budget is not None \
                and self._host_pages > self.host_budget:
            problems.append(
                f"host tier over budget: {self._host_pages} > "
                f"{self.host_budget}")
        st = self.stats
        if st["spilled_pages"] != (st["restored_pages"]
                                   + st["readopted_pages"]
                                   + st["host_evicted_pages"]
                                   + self._host_pages):
            problems.append(
                "offload accounting broken: spilled "
                f"{st['spilled_pages']} != restored "
                f"{st['restored_pages']} + readopted "
                f"{st['readopted_pages']} + host_evicted "
                f"{st['host_evicted_pages']} + host {self._host_pages}")
        table_refs = np.zeros(self.mgr.num_blocks, np.int64)
        for table in self.mgr.tables.values():
            for p in table:
                if 0 <= p < self.mgr.num_blocks:
                    table_refs[p] += 1
        for p in range(self.mgr.num_blocks):
            expect = int(table_refs[p]) + tree_refs.get(p, 0)
            if int(self.mgr.refcount[p]) != expect:
                problems.append(
                    f"page {p} refcount {int(self.mgr.refcount[p])} != "
                    f"{int(table_refs[p])} table + "
                    f"{tree_refs.get(p, 0)} tree references")
        if problems and raise_on_violation:
            raise RuntimeError(
                "PrefixCache.check failed:\n  " + "\n  ".join(problems))
        return problems

    def summary(self) -> Dict[int, int]:
        """The fleet router's tree summary: ``{prefix_hash: n_tokens}``
        for every page-aligned cached path (resident AND spilled — a
        spilled node is still a warm hit; it restores on acquire).
        Hashes are over the token-id tuple from the root, so a router
        can test "does this replica hold the first k pages of this
        prompt" without holding the tree itself; ``version`` tells it
        when a cached summary went stale."""
        out: Dict[int, int] = {}

        def walk(node: _Node, toks: Tuple[int, ...]):
            for ch in node.children.values():
                if len(ch.tokens) != self.bs:
                    continue        # partial tails: page-aligned only
                t = toks + ch.tokens
                out[hash(t)] = len(t)
                walk(ch, t)
        walk(self.root, ())
        return out

    # -- lookup -------------------------------------------------------
    def _touch(self, node: Optional[_Node]):
        self._tick += 1
        while node is not None and node is not self.root:
            node.last_used = self._tick
            node = node.parent

    def match(self, tokens: Sequence[int]
              ) -> Tuple[List[_Node], Optional[_Node], int]:
        """Longest cached prefix of ``tokens``: (full_nodes, tail_node,
        tail_len). ``full_nodes`` are whole-page in-place matches;
        ``tail_len`` leading tokens of ``tail_node`` are additionally
        usable through a COW fork. Read-only (no refcount changes)."""
        toks = [int(t) for t in tokens]
        node, pos, full = self.root, 0, []
        while pos < len(toks):
            rem = toks[pos:pos + self.bs]
            best, best_c = None, 0
            for ch in node.children.values():
                c = _common(ch.tokens, rem)
                if c > best_c:
                    best, best_c = ch, c
            if best is None or best_c == 0:
                break
            if best_c == self.bs:          # whole page matched in place
                full.append(best)
                node = best
                pos += self.bs
                continue
            return full, best, best_c      # partial: COW-fork territory
        return full, None, 0

    # -- admission ----------------------------------------------------
    def acquire(self, tokens: Sequence[int], limit: int,
                total_pages: int):
        """Admission-side lookup with backpressure: match at most
        ``limit`` tokens (callers pass ``len(prompt) - 1`` so at least
        one suffix token always prefills and produces logits), pin the
        matched full pages, and check that free + evictable pages cover
        the request's remaining ``total_pages`` need. Returns ``None``
        (wait; nothing mutated) when they do not, else
        ``(pages, matched_tokens, n_shared)`` where every returned page
        carries exactly one reference owned by the caller — full pages
        a fresh share, the COW fork its allocation.

        Matched SPILLED nodes count toward the page need (each restore
        consumes one fresh pool page) and are restored — copied back to
        the device into fresh pages — only after the backpressure check
        passes, root-first and pinned as they land so a later restore's
        reclaim can never spill them straight back."""
        toks = [int(t) for t in tokens][:max(int(limit), 0)]
        full, tail, tail_len = self.match(toks)
        will_fork = tail is not None and tail_len > 0
        resident = [nd for nd in full if nd.page is not None]
        n_restore = len(full) - len(resident)
        if will_fork and tail.page is None:
            n_restore += 1
        # pin the matched RESIDENT path — including a resident fork
        # SOURCE — before counting evictables, so the backpressure
        # check can never count a page the allocation below will find
        # pinned (that mismatch would crash allocation instead of
        # waiting)
        for nd in resident:
            self.mgr.incref(nd.page)
        if will_fork and tail.page is not None:
            self.mgr.incref(tail.page)
        # fork + fresh suffix pages + one pool page per restore
        needed = total_pages - len(full) + n_restore
        if len(self.mgr.free) < needed and \
                len(self.mgr.free) + self.evictable_count() < needed:
            if will_fork and tail.page is not None:
                self.mgr.decref(tail.page)
            for nd in resident:
                self.mgr.decref(nd.page)
            return None
        spilled = [nd for nd in full if nd.page is None]
        fork_spilled = will_fork and tail.page is None
        if spilled or fork_spilled:
            # ONE batched restore, root-first (list order); the pin
            # below lands before any later caller's reclaim can run
            batch = spilled + ([tail] if fork_spilled else [])
            self._restore_nodes(batch)
            for nd in spilled:
                self.mgr.incref(nd.page)    # the caller's reference
            if fork_spilled:
                self.mgr.incref(tail.page)  # the fork-source pin
        pages = [nd.page for nd in full]
        matched = len(full) * self.bs
        if will_fork:
            dst = self.mgr.fork(tail.page)   # src ALSO pinned above, so
            self.copy_page(tail.page, dst)   # the pin spans the copy
            self.mgr.decref(tail.page)       # drop the outer pin
            pages.append(dst)
            matched += tail_len
            self.stats["cow_forks"] += 1
            self._touch(tail)
        elif full:
            self._touch(full[-1])
        self.stats["hits" if matched else "misses"] += 1
        self.stats["tokens_skipped"] += matched
        self.stats["shared_pages"] += len(full)
        return pages, matched, len(full)

    def _restore_nodes(self, nodes: List[_Node]):
        """Bring spilled nodes back on device: fresh pool pages (rc 1
        — the tree's reference) + ONE batched ``restore_pages``
        transfer through the owner's ``restore_pages`` (fixed-width
        multi-page windows, copied without a host sync: the copy is
        ordered before the suffix prefill chunk issued next on the same
        stream). The allocations may reclaim;
        matched resident pages are pinned by then, restoring nodes
        hold no page, and the freshly-allocated destinations are not
        in the tree — so the reclaim can never touch the batch."""
        dsts = [self.mgr.alloc_page() for _ in nodes]
        self._restore_batch([nd.host for nd in nodes], dsts)
        for nd, dst in zip(nodes, dsts):
            nd.page = dst
            nd.host = None
            self._host_pages -= 1
            self.stats["restored_pages"] += 1
            self.version += 1

    # -- insertion ----------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int]):
        """Index a finished sequence's pages under its token ids
        (``tokens`` must cover exactly the positions with valid KV).
        Walks the tree page by page: already-cached pages are left for
        the caller's ``release`` to drop, novel pages are adopted
        (incref — they survive the release), and a partial tail node is
        upgraded in place when the new page extends its tokens."""
        toks = [int(t) for t in tokens]
        node = self.root
        for i in range(0, len(toks), self.bs):
            pi = i // self.bs
            pt = tuple(toks[i:i + self.bs])
            if pi >= len(pages) or not pt:
                break
            page = pages[pi]
            best, best_c = None, 0
            for ch in node.children.values():
                c = _common(ch.tokens, pt)
                if c > best_c:
                    best, best_c = ch, c
            if best is not None and best_c == len(best.tokens) == len(pt):
                if best.page is None:
                    # a finished request re-covered a SPILLED node:
                    # re-adopt its device page directly — cheaper than
                    # a restore, same bytes by position-causality
                    self.mgr.incref(page)
                    best.page = page
                    best.host = None
                    self._host_pages -= 1
                    self.stats["readopted_pages"] += 1
                    self.version += 1
                node = best                  # exact: already cached
                self._touch(node)
                continue
            if best is not None and best_c == len(best.tokens) < len(pt):
                # ours extends a partial tail: upgrade its page in place
                # (partial nodes are COW-only => refcount 1, no children).
                # parent.children is keyed by the node's tokens, so the
                # entry must be rekeyed or eviction's keyed delete misses
                old = best.page
                self.mgr.incref(page)
                del node.children[best.tokens]
                best.tokens = pt
                best.page = page
                if best.host is not None:
                    # a spilled tail re-materialized by the caller's
                    # longer page: the host copy is superseded —
                    # counted as a re-adoption so the tier's page
                    # accounting (spilled == restored + readopted +
                    # host_evicted + host_pages) stays closed
                    best.host = None
                    self._host_pages -= 1
                    self.stats["readopted_pages"] += 1
                node.children[pt] = best
                if old is not None:
                    self.mgr.decref(old)
                self.stats["inserted_pages"] += 1
                self.version += 1
                node = best
                self._touch(node)
                continue
            if best is not None and best_c == len(pt) <= len(best.tokens):
                self._touch(best)            # cached covers ours: drop
                break                        # (< bs tokens => last page)
            # novel or divergent-within-page: adopt as a sibling node
            self.mgr.incref(page)
            ch = _Node(pt, page, node)
            node.children[pt] = ch
            self.stats["inserted_pages"] += 1
            self.version += 1
            node = ch
            self._touch(node)

    # -- eviction -----------------------------------------------------
    def evict(self, n_pages: int) -> int:
        """Reclaim up to ``n_pages`` refcount-1 pages for the
        allocator, LRU-first. Without the offload tier the victim's
        node is dropped from the tree; with it the node SPILLS — bytes
        to host memory, node kept matchable. Pages shared with a live
        request (refcount >= 2) are never touched. Installed as the
        BlockManager's ``reclaim`` hook."""
        if self._spill_batch is not None:
            return self._evict_spill(n_pages)
        return self._evict_drop(n_pages)

    def _evict_drop(self, n_pages: int) -> int:
        """LRU-evict refcount-1 leaf pages, cascading to parents as
        they become childless (the pre-offload behavior)."""
        heap = [(nd.last_used, id(nd), nd) for nd in self._walk()
                if not nd.children
                and int(self.mgr.refcount[nd.page]) == 1]
        heapq.heapify(heap)
        freed = 0
        while heap and freed < n_pages:
            _, _, nd = heapq.heappop(heap)
            if nd.children or nd.parent is None:
                continue                      # stale heap entry
            if int(self.mgr.refcount[nd.page]) != 1:
                continue                      # pinned since collection
            parent = nd.parent
            del parent.children[nd.tokens]
            nd.parent = None
            self.mgr.decref(nd.page)          # 1 -> 0: back to the pool
            freed += 1
            self.stats["evicted_pages"] += 1
            self.version += 1
            if (parent is not self.root and not parent.children
                    and int(self.mgr.refcount[parent.page]) == 1):
                heapq.heappush(
                    heap, (parent.last_used, id(parent), parent))
        return freed

    def _evict_spill(self, n_pages: int) -> int:
        """Offload-tier eviction: spill the LRU resident leaf-of-the-
        resident-subtree (rc-1, no resident descendant — children spill
        before parents, so hot shared ancestors stay on device longest)
        to host memory; the node stays in the tree with ``page=None``
        and restores on the next prefix hit."""
        freed = 0
        while freed < n_pages:
            cands = self._resident_leaves()
            if not cands:
                break
            cands.sort(key=lambda nd: (nd.last_used, id(nd)))
            batch = cands[:n_pages - freed]
            self._spill_nodes(batch)    # one call spills the whole
            freed += len(batch)         # LRU layer (windowed transfer)
            # loop: spilling a layer of leaves may expose their parents
        return freed

    def _resident_leaves(self) -> List[_Node]:
        """Resident rc-1 nodes with no resident descendant — the
        spillable frontier."""
        out: List[_Node] = []

        def walk(n: _Node) -> bool:
            any_res = False
            for ch in n.children.values():
                any_res = walk(ch) or any_res
            res = n is not self.root and n.page is not None
            if (res and not any_res
                    and int(self.mgr.refcount[n.page]) == 1):
                out.append(n)
            return res or any_res
        walk(self.root)
        return out

    def _spill_nodes(self, nodes: List[_Node]):
        """Spill a batch of victim nodes: one batched transfer through
        the owner's ``spill_pages`` (fixed-width multi-page windows)."""
        pages = [nd.page for nd in nodes]
        payloads = self._spill_batch(pages)
        for nd, payload in zip(nodes, payloads):
            nd.host = payload
            self.mgr.decref(nd.page)    # 1 -> 0: back to the pool
            nd.page = None
            self._host_pages += 1
            self.stats["spilled_pages"] += 1
            self.version += 1
        self._enforce_host_budget()

    def _enforce_host_budget(self):
        """Past the host budget the LRU CHILDLESS spilled node dies for
        real (dropping a mid-tree node would orphan the descendants'
        token paths; leaf-first spill order makes the oldest spilled
        nodes childless in practice)."""
        while (self.host_budget is not None
               and self._host_pages > self.host_budget):
            cands = [nd for nd in self._walk()
                     if nd.page is None and nd.host is not None
                     and not nd.children]
            if not cands:
                break
            nd = min(cands, key=lambda n: (n.last_used, id(n)))
            del nd.parent.children[nd.tokens]
            nd.parent = None
            nd.host = None
            self._host_pages -= 1
            self.stats["host_evicted_pages"] += 1
            self.stats["evicted_pages"] += 1
            self.version += 1


def make_page_copier():
    """The COW copy: page ``src`` -> page ``dst`` of every layer, in both
    pools ([L, N, BS, KV, hd], or per-shard lists of them), in place, with
    one index copy a pool on the pools' device."""
    def cp(k_pools, v_pools, src: int, dst: int):
        for pools in (k_pools, v_pools):
            for p in (pools if isinstance(pools, list) else [pools]):
                p[:, dst] = p[:, src]
        return k_pools, v_pools
    return cp


class PagedKVCacheStore:
    """Persistent pools + BlockManager + PrefixCache backing
    ``generate_paged(prefix_cache=...)``.

    ``generate_paged`` builds fresh pools a call, so nothing is reused
    across calls; this store owns the pools instead and outlives the call,
    so a later call skips prefill for any prompt prefix an earlier call
    computed. bf16/f32 only: the int8 path quantizes whole pools with
    per-call scales, which cannot hold pages that outlive the call (the
    ServingEngine's int8 cache, with its engine-wide static scales, does
    share). ``device``: None is CUDA, ``"cpu"`` the CPU."""

    _SCRATCH_SEQ = -1

    def __init__(self, cfg, block_size: int = 16, num_blocks: int = 256,
                 dtype=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        L, KV, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                     cfg.head_dim)
        shape = (L, self.num_blocks, self.block_size, KV, hd)
        self.k_pools = torch.zeros(shape, dtype=dtype or cfg.dtype,
                                   device=self.device)
        self.v_pools = torch.zeros(shape, dtype=dtype or cfg.dtype,
                                   device=self.device)
        self.mgr = BlockManager(self.num_blocks, self.block_size,
                                self.num_blocks)
        # page 0 is scratch: padded block-table entries default there
        scratch = self.mgr.allocate(self._SCRATCH_SEQ, 1)
        if scratch != [0]:
            raise RuntimeError("scratch must be page 0")
        self._copy_fn = make_page_copier()
        self.cache = PrefixCache(self.mgr, self.block_size,
                                 copy_page=self._copy_page)
        self.next_seq_id = 0

    def _copy_page(self, src: int, dst: int):
        self._copy_fn(self.k_pools, self.v_pools, src, dst)

    def metrics(self) -> Dict:
        m = self.cache.metrics()
        m["free_pages"] = len(self.mgr.free)
        return m
