"""Paged KV cache for serving (port of ``paddle_tpu/ops/paged_attention.py``).

The KV cache lives in pools of fixed-size pages ``[N, BS, KV, hd]``; each
sequence owns a list of page ids, its block table. :class:`BlockManager`
hands pages out and takes them back on the host.

``paged_attention_decode`` dispatches on where ``q`` lies: a CUDA tensor
goes to the CUDA kernel (``kernels/paged_attention.py``), a CPU tensor to
the plain version ``paged_attention_decode_ref``. There is no flag that
selects the plain version on the card and no fallback: a kernel that
fails raises.

The int8 KV cache (static per-head scales, the serving engine's
``cache_dtype="int8"``): :func:`quantize_pools`, :func:`quant_cache`,
:func:`dequant_cache`, the quantizing pool writes and
:func:`paged_attention_decode_quant`. That last one is the plain
composition on the CPU and on the card alike, as in the JAX package,
whose ``paged_attention_decode_quant`` is an XLA gather and einsum on
every backend (its Pallas paged-attention kernel takes no scales). Every
quantizer is ``clip(round(x / s), -127, 127)`` in f32 with ``torch.round``
(half to even, as ``jnp.round``) and ``s`` a tensor: PyTorch's CUDA
division by a Python scalar multiplies by its reciprocal, which can round
differently.

Unlike the JAX package, whose arrays are immutable, the pool writes
update the pools in place (``index_put_``) and return them.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernels.paged_attention import (paged_attention_decode_cuda,
                                      paged_attention_decode_ref)

__all__ = ["paged_attention_decode", "paged_attention_decode_ref",
           "paged_attention_decode_quant", "write_to_pool",
           "write_chunk_to_pool", "write_to_pool_quant",
           "write_chunk_to_pool_quant", "quantize_pools", "quant_cache",
           "dequant_cache", "BlockManager"]


def paged_attention_decode(q, k_pool, v_pool, block_tables, seq_lens):
    """Single-step decode attention over a paged cache.

    q:            [B, H, hd]     query for the current position
    k_pool/v_pool:[N, BS, KV, hd] physical block pools
    block_tables: [B, MB] int32  physical block id per logical block
    seq_lens:     [B]    int32   valid tokens per sequence (incl. current)
    returns       [B, H, hd], scale 1/sqrt(hd)
    """
    if q.device.type == "cpu":
        return paged_attention_decode_ref(q, k_pool, v_pool, block_tables,
                                          seq_lens)
    return paged_attention_decode_cuda(q, k_pool, v_pool, block_tables,
                                       seq_lens)


def write_to_pool(k_pool, v_pool, block_tables, seq_lens, k_new, v_new):
    """Write one token's K/V per sequence into the paged pools, in place.

    k_new/v_new: [B, KV, hd] for the token at position seq_lens[b]
    (0-based position == current length before the append). Returns the
    (updated) pools.
    """
    BS = k_pool.shape[1]
    pos = seq_lens.long()
    phys = block_tables.long().gather(1, (pos // BS)[:, None])[:, 0]
    off = pos % BS
    k_pool[phys, off] = k_new
    v_pool[phys, off] = v_new
    return k_pool, v_pool


def write_chunk_to_pool(k_pool, v_pool, wtable, pos0, n_valid, k_new,
                        v_new):
    """Write one prefill chunk's K/V into the paged pools, in place.

    k_new/v_new: [P, KV, hd] for positions pos0..pos0+P-1 of ONE request;
    ``wtable`` [MB] is the request's WRITE table (a prefix cache redirects
    its shared pages to scratch page 0 there). Rows at or after
    ``n_valid`` (bucket padding) go to scratch page 0 too, so only the
    chunk's own tokens land in the request's pages. Those duplicate writes
    all hit page 0, which nothing reads, so which of them wins does not
    matter. Returns the (updated) pools."""
    P = k_new.shape[0]
    BS = k_pool.shape[1]
    rows = torch.arange(P, device=k_pool.device)
    pos = pos0 + rows
    logical = (pos // BS).clamp_max(wtable.shape[0] - 1)
    page = torch.where(rows < n_valid, wtable.long()[logical], 0)
    off = pos % BS
    k_pool.index_put_((page, off), k_new.to(k_pool.dtype))
    v_pool.index_put_((page, off), v_new.to(v_pool.dtype))
    return k_pool, v_pool


# -- int8 cache quantization (static per-head scales) -----------------------
def _quant(x, s):
    """``clip(round(x / s), -127, 127)`` as int8, in f32; ``s`` an f32
    tensor broadcast against ``x`` (a bf16 ``x`` is promoted to f32 by the
    division itself: one launch fewer per call on the decode step's
    pool write)."""
    return torch.div(x, s).round_().clamp_(-127, 127).to(torch.int8)


def quantize_pools(k_pool, v_pool):
    """bf16/f32 pools [N, BS, KV, hd] -> (int8 pools, k_scale [KV],
    v_scale [KV]) with symmetric per-head absmax scales (unwritten slots
    are zero, so the whole pool's absmax is safe)."""
    def one(p):
        amax = torch.amax(p.float().abs(), dim=(0, 1, 3))
        scale = torch.clamp_min(amax / torch.tensor(127.0,
                                                    device=amax.device),
                                1e-8)                           # [KV]
        return _quant(p, scale[None, None, :, None]), scale
    kq, ks = one(k_pool)
    vq, vs = one(v_pool)
    return kq, vq, ks, vs


def dequant_cache(x, scale):
    """int8 dense cache view [L, B, T, KV, hd] -> f32, with per-layer,
    per-head scales [L, KV] (the serving engine's verbatim prefill chunk
    reads quantized pages into its dense view through this)."""
    return x.float() * scale[:, None, None, :, None]


def quant_cache(x, scale):
    """Inverse of :func:`dequant_cache`: fp dense view -> int8 with the
    same static scales. round(q * s / s) == q, so positions that were only
    dequantized, not rewritten, quantize back to their own codes."""
    return _quant(x, scale[:, None, None, :, None])


def write_to_pool_quant(k_pool, v_pool, block_tables, seq_lens, k_new,
                        v_new, k_scale, v_scale):
    """:func:`write_to_pool` for int8 pools: the new token's K/V [B, KV,
    hd] quantize with the static per-head scales [KV] on the way in."""
    return write_to_pool(k_pool, v_pool, block_tables, seq_lens,
                         _quant(k_new, k_scale[None, :, None]),
                         _quant(v_new, v_scale[None, :, None]))


def write_chunk_to_pool_quant(k_pool, v_pool, wtable, pos0, n_valid, k_new,
                              v_new, k_scale, v_scale):
    """:func:`write_chunk_to_pool` for int8 pools: the chunk's K/V [P, KV,
    hd] quantize with the static per-head scales [KV] on the way in (the
    formula of :func:`quant_cache`, so re-quantizing untouched positions
    stays exact)."""
    return write_chunk_to_pool(k_pool, v_pool, wtable, pos0, n_valid,
                               _quant(k_new, k_scale[None, :, None]),
                               _quant(v_new, v_scale[None, :, None]))


def paged_attention_decode_quant(q, k_pool, v_pool, block_tables, seq_lens,
                                 k_scale, v_scale):
    """Decode attention over int8 pools: gather the int8 pages, dequantize
    per head in f32, then the same attention math as the fp pools'
    (:func:`paged_attention_decode_ref`). A composition on every device,
    as in the JAX package (module docstring)."""
    return paged_attention_decode_ref(q, k_pool, v_pool, block_tables,
                                      seq_lens, k_scale=k_scale,
                                      v_scale=v_scale)


class BlockManager:
    """Host-side physical block allocator with reference-counted pages
    (the JAX package's, which is plain Python and numpy, without the
    prefix cache's copy-on-write ``fork`` and ``reclaim`` hook).

    ``allocate`` hands out pages at refcount 1, ``attach`` appends
    already-populated shared pages to a table (incref), ``release``
    decrefs every table entry and a page returns to the free list only
    when its count hits 0. ``max_blocks_per_seq`` is the width of a
    block table (the reference's constructor)."""

    def __init__(self, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.free = list(range(num_blocks - 1, -1, -1))
        self.tables = {}            # seq_id -> list of physical block ids
        self.refcount = np.zeros(num_blocks, np.int32)

    def alloc_page(self) -> int:
        """Pop one free page at refcount 1 (sole owner: the caller)."""
        if not self.free:
            raise RuntimeError("KV cache pool exhausted")
        p = self.free.pop()
        if self.refcount[p] != 0:
            raise RuntimeError(
                f"free list corrupt: page {p} has refcount "
                f"{int(self.refcount[p])}")
        self.refcount[p] = 1
        return p

    def incref(self, page: int):
        if self.refcount[page] <= 0:
            raise RuntimeError(
                f"incref on unowned page {page}: sharing a freed page "
                "would alias live KV data")
        self.refcount[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; returns True when the page was freed.
        Going below zero is a bookkeeping bug and raises."""
        rc = int(self.refcount[page]) - 1
        if rc < 0:
            raise RuntimeError(f"refcount of page {page} went negative")
        self.refcount[page] = rc
        if rc == 0:
            self.free.append(page)
            return True
        return False

    def attach(self, seq_id: int, pages, owned: bool = False):
        """Append already-populated pages to a sequence's table. Must run
        before ``allocate`` fills the suffix."""
        table = self.tables.setdefault(seq_id, [])
        for p in pages:
            if not owned:
                self.incref(p)
            table.append(p)
        return table

    def allocate(self, seq_id: int, num_tokens: int):
        need = (num_tokens + self.block_size - 1) // self.block_size
        table = self.tables.setdefault(seq_id, [])
        while len(table) < need:
            table.append(self.alloc_page())
        return table

    def release(self, seq_id: int):
        for b in self.tables.pop(seq_id, []):
            self.decref(b)

    def check(self, raise_on_violation: bool = True):
        """Structural invariant sweep: refcounts never negative, free
        pages at refcount 0 and listed once, every page either free or
        referenced, and no page referenced by more table entries than
        its refcount. Returns the violations (empty = clean), or raises
        when ``raise_on_violation``."""
        problems = []
        seen_free = set()
        for p in self.free:
            if not (0 <= p < self.num_blocks):
                problems.append(f"free list holds invalid page {p}")
                continue
            if p in seen_free:
                problems.append(f"page {p} appears twice in free list")
            seen_free.add(p)
            if int(self.refcount[p]) != 0:
                problems.append(
                    f"free page {p} has refcount "
                    f"{int(self.refcount[p])} (must be 0)")
        table_refs = np.zeros(self.num_blocks, np.int64)
        for sid, table in self.tables.items():
            for p in table:
                if not (0 <= p < self.num_blocks):
                    problems.append(
                        f"table {sid} holds invalid page {p}")
                    continue
                table_refs[p] += 1
        for p in range(self.num_blocks):
            rc = int(self.refcount[p])
            if rc < 0:
                problems.append(f"page {p} refcount negative ({rc})")
            if rc == 0 and p not in seen_free:
                problems.append(
                    f"page {p} leaked: refcount 0 but not in free list")
            if rc > 0 and p in seen_free:
                problems.append(
                    f"page {p} in free list with refcount {rc}")
            if rc < int(table_refs[p]):
                problems.append(
                    f"page {p} refcount {rc} < {int(table_refs[p])} "
                    "table references (tables over-share the page)")
        if problems and raise_on_violation:
            raise RuntimeError(
                "BlockManager.check failed:\n  " + "\n  ".join(problems))
        return problems
