"""Flash attention: the three CUDA kernels' wrappers, their plain PyTorch
versions and the ``torch.autograd.Function`` that joins them.

Replaces ``paddle_tpu/ops/pallas/flash_attention.py``'s
``flash_attention_pallas`` (launches ``flash_attention_fwd``,
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``), with every
body of those kernels: causal (bottom-right, ``sq > sk`` included) or
full, GQA, an additive f32 bias ``[b|1, h|1, sq, sk]`` and its gradient
(``dbias``, the dq pass's ``[b*h, sq, sk]`` f32 output), segment ids, and
in-kernel dropout keyed by :func:`dropout_keep`. The kernels are
``paddle_tpu_torch/csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``,
built by :mod:`._build` at the first launch and bound with ctypes; that
file's header says what bounds them on the H100 (operations) and how their
design follows from it. Every bf16 launch runs on the tensor cores
(``fwd_tc_kernel``, ``dq_tc_kernel``, ``dkv_tc_kernel``: 128 threads, bf16
tiles, two ``cp.async`` stages; :func:`flash_plan`), and with segment ids
they skip every (query tile, key tile) pair whose id ranges do not meet
(:func:`segment_tiles_kept`, the kernels' test in numpy); the f32 launches
run the CUDA-core kernels.

Layout: the public ``[batch, seq, heads, head_dim]`` (q, o: ``h`` heads;
k, v: ``kvh`` heads, ``h % kvh == 0``), read by stride; the log-sum-exp
and ``delta`` rows are ``[batch, h, sq]`` f32, the JAX package's
``[b*h, sq]``; segment ids ``[b, sq]`` / ``[b, sk]`` int32.

The plain versions are op for op the JAX kernels' arithmetic, dense:
:func:`flash_fwd_ref` (O and lse, ``S * scale + bias``, ``P`` dropped and
cast to V's type before ``P V``, taken against the running max of each
``BLOCK``-key tile as the kernels' online softmax takes it, while ``l``
sums the undropped ``P``),
:func:`flash_bwd_dq_ref` and :func:`flash_bwd_dkv_ref` (``P`` recomputed
from lse, ``dP`` dropped, ``dS = P (dP - delta) scale`` from the undropped
``P``, dS cast to K's and Q's type for dq and dk, ``dV`` from the dropped
f32 ``P``; ``dbias = P (dP - delta)``). ``chip_smoke.py`` holds each
kernel against its plain version on the card; the CPU tests hold the plain
versions against the JAX kernels in interpret mode.

A query row that sees no key (causal with ``sq > sk``, or a segment with
no key of its id) gives O = 0 in the kernels and in their plain versions,
as in the JAX kernels; its lse is ``MASK_VALUE`` or ``-inf`` depending on
whether its tile visited a key tile (so lse is compared only on rows that
see a key). The semantics-level plain version,
:func:`paddle_tpu_torch.ops.flash_attention._ref_attention`, gives the
mean of V on such a causal row, as the JAX package's ``_ref_attention``
does (it zeroes only rows that segment ids leave empty); the two differ
there by design.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import _build, _launch

__all__ = ["flash_fwd_ref", "flash_bwd_dq_ref", "flash_bwd_dkv_ref",
           "flash_fwd_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda",
           "FlashAttention", "flash_attention_cuda", "flash_unsupported",
           "dropout_keep", "dropout_inv", "body_class", "BODY_FLAGS",
           "MASK_VALUE", "flash_plan", "flash_smem", "flash_spec",
           "tensor_cores", "SegTiles", "tile_id_ranges",
           "segment_tiles_kept", "segment_tiles_needed"]

#: the JAX kernel's DEFAULT_MASK_VALUE (-0.7 x float32 max)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_U32 = 0xFFFFFFFF


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _mul32(a, c):
    """``a * c`` mod 2^32 for int64 ``a`` in [0, 2^32) and a 32-bit
    constant, in halves so that no product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def dropout_keep(seed, qbh, qpos, kpos, rate):
    """The JAX kernels' keep mask (``_dropout_keep``): a murmur3 finalizer
    of ``(seed, query head b*h + hi, absolute query row, absolute key)``,
    kept where the top 24 bits as a uniform in [0, 1) are at least
    ``rate`` (compared in f32). ``qbh``, ``qpos``, ``kpos``: int tensors
    that broadcast together; ``seed``: a Python int (its low 32 bits).
    Torch has no full uint32 arithmetic, so the hash runs in int64 masked
    to 32 bits; it gives JAX's bits."""
    qbh, qpos, kpos = (torch.as_tensor(t).to(torch.int64) & _U32
                       for t in (qbh, qpos, kpos))
    seed = int(seed) & _U32
    x = (_mul32(qpos, 0x9E3779B1) ^ _mul32(kpos, 0x85EBCA77)
         ^ ((seed + _mul32(qbh, 0xC2B2AE3D)) & _U32))
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u >= float(np.float32(rate))


def dropout_inv(rate) -> float:
    """``1 / (1 - rate)`` rounded to f32: the constant the JAX kernels
    multiply the kept probabilities by (a weak-typed Python float)."""
    return float(np.float32(1.0 / (1.0 - float(rate))))


# ---------------------------------------------------------------------------
# plain versions: the kernels' arithmetic, dense
# ---------------------------------------------------------------------------
def _repeat_kv(t, h):
    g = h // t.shape[2]
    return torch.repeat_interleave(t, g, dim=2) if g > 1 else t


def _scores(q, k, causal, scale, bias=None, seg_q=None, seg_k=None):
    """Scaled f32 scores [b, h, sq, sk] (plus the bias) and the seen mask
    (None when every key is seen)."""
    h = q.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     _repeat_kv(k, h).float()) * scale
    if bias is not None:
        s = s + bias.float()
    sq, sk = s.shape[-2], s.shape[-1]
    valid = None
    if causal:
        valid = torch.ones(sq, sk, dtype=torch.bool,
                           device=q.device).tril(sk - sq)
    if seg_q is not None:
        same = (seg_q[:, None, :, None] == seg_k[:, None, None, :])
        valid = same if valid is None else valid & same
    return s, valid


def _keep(q, sk, seed, rate):
    """[b, h, sq, sk] keep mask of the launch's query heads."""
    b, sq, h, _ = q.shape
    dev = q.device
    qbh = torch.arange(b * h, device=dev).reshape(b, h, 1, 1)
    return dropout_keep(seed, qbh, torch.arange(sq, device=dev)[:, None],
                        torch.arange(sk, device=dev)[None, :], rate)


def _dropped(t, keep, rate):
    """``keep ? t * inv : 0`` with the f32 ``inv`` (the kernels' select)."""
    inv = torch.tensor(dropout_inv(rate), dtype=torch.float32,
                       device=t.device)
    return torch.where(keep, t * inv, 0.0)


def _running_tile_max(s):
    """[..., sk] -> for each key, the running max of the scores over the
    ``BLOCK``-key tiles up to its own: the max the kernels take its P
    against before rounding P to V's type."""
    sk = s.shape[-1]
    nt = -(-sk // BLOCK)
    tiles = torch.nn.functional.pad(s, (0, nt * BLOCK - sk),
                                    value=MASK_VALUE).unflatten(-1,
                                                                (nt, BLOCK))
    run = tiles.amax(-1).cummax(-1).values
    return run.repeat_interleave(BLOCK, -1)[..., :sk]


def flash_fwd_ref(q, k, v, causal=False, scale=None, bias=None, seg_q=None,
                  seg_k=None, seed=0, rate=0.0):
    """(o [b, sq, h, d] in q's type, lse [b, h, sq] f32). ``P V`` takes
    each key tile's P against the running max up to that tile, dropped,
    rounded to V's type and then brought to the row's final max in f32,
    as the kernels' online softmax does; ``l`` sums the undropped P."""
    scale = _scale(q, scale)
    s, valid = _scores(q, k, causal, scale, bias, seg_q, seg_k)
    if valid is not None:
        s = torch.where(valid, s, MASK_VALUE)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    run = _running_tile_max(s)
    p = torch.exp(s - run)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    if rate > 0.0:
        p = _dropped(p, _keep(q, k.shape[1], seed, rate), rate)
    p = p.to(v.dtype).float() * torch.exp(run - m)
    vr = _repeat_kv(v, q.shape[2])
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
    o = o / l_safe.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale, bias, seg_q,
                  seg_k, seed, rate):
    """(P as dV takes it, dS, dbias): P dropped where dropout is on, dS and
    dbias from the undropped P."""
    s, valid = _scores(q, k, causal, scale, bias, seg_q, seg_k)
    p = torch.exp(s - lse[..., None])
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(),
                      _repeat_kv(v, q.shape[2]).float())
    p_v = p
    if rate > 0.0:
        keep = _keep(q, k.shape[1], seed, rate)
        dp = _dropped(dp, keep, rate)
        p_v = _dropped(p, keep, rate)
    dsb = p * (dp - delta[..., None])
    return p_v, dsb * scale, dsb


def _sum_groups(t, kvh):
    """[b, sk, h, d] -> [b, sk, kvh, d]: the query heads of each group
    summed into their K/V head."""
    b, sk, h, d = t.shape
    return t.reshape(b, sk, kvh, h // kvh, d).sum(3)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=False, scale=None,
                     bias=None, seg_q=None, seg_k=None, seed=0, rate=0.0,
                     bias_grad=False):
    """dq [b, sq, h, d] in q's type from the forward's lse and
    ``delta = rowsum(o * do)`` (both [b, h, sq] f32); with ``bias_grad``
    ``(dq, dbias)``, dbias [b*h, sq, sk] f32 (the kernel's dbias body)."""
    scale = _scale(q, scale)
    _, ds, dsb = _probs_and_ds(q, k, v, do, lse, delta, causal, scale, bias,
                               seg_q, seg_k, seed, rate)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      _repeat_kv(k, q.shape[2]).float()).to(q.dtype)
    if bias_grad:
        b, h = q.shape[0], q.shape[2]
        return dq, dsb.reshape(b * h, *dsb.shape[2:])
    return dq


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal=False, scale=None,
                      bias=None, seg_q=None, seg_k=None, seed=0, rate=0.0):
    """(dk, dv) [b, sk, kvh, d] in k's and v's types."""
    scale = _scale(q, scale)
    p, ds, _ = _probs_and_ds(q, k, v, do, lse, delta, causal, scale, bias,
                             seg_q, seg_k, seed, rate)
    kvh = k.shape[2]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return (_sum_groups(dk, kvh).to(k.dtype),
            _sum_groups(dv, kvh).to(v.dtype))


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------
#: rows of a query tile and of a key tile (``kB`` in csrc/flash_attention.cu;
#: the launchers refuse another)
BLOCK = 64
#: threads of a block: the CUDA-core kernels' 256; the bf16 launches' 128
#: (4 warps on the tensor cores, ``kTcThreads``)
_THREADS, _TC_THREADS = 256, 128
_TC_PASSES = ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv")
_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
#: pointer arguments of each launcher (q, k, v, bias, seg_q, seg_k, then
#: the pass's own)
_N_PTR = {"flash_attention_fwd": 8, "flash_attention_bwd_dq": 11,
          "flash_attention_bwd_dkv": 11}


def flash_codes(name):
    """The ctypes argument codes of launcher ``name``: its pointers, ten
    ints (b, h, kvh, sq, sk, d, block, smem, bias_b, bias_h), the seed (a
    long long), three floats (scale, rate, inv), causal, the dtype code and
    the stream."""
    return (("p",) * _N_PTR[name] + ("i",) * 10 + ("l",) + ("f",) * 3
            + ("i", "i", "p"))


def tensor_cores(name, dt) -> bool:
    """Whether launch ``name`` in type ``dt`` (a dtype name) runs on the
    tensor cores: every bf16 launch (``fwd_tc_kernel``, ``dq_tc_kernel``,
    ``dkv_tc_kernel``); the f32 launches run the CUDA-core kernels."""
    return name in _TC_PASSES and dt == "bfloat16"


def flash_smem(name, d, dt="float32", bias=False, seg=False) -> int:
    """Dynamic shared memory of one block of kernel ``name`` in type
    ``dt`` (the figure its launcher holds the plan to). CUDA-core kernels:
    f32 tiles of ``BLOCK`` rows (row stride d + 1) and the score tiles
    (stride BLOCK + 1) (``fwd_smem``/``dq_smem``/``dkv_smem``). The
    tensor-core kernels (``fwd_tc_smem``/``dq_tc_smem``/``dkv_tc_smem``):
    bf16 [BLOCK][D + 8] tiles (forward: Q and two stages of K and V; dq: Q,
    dO and two stages of K and V; dkv: K, V and two stages of Q and dO),
    the dkv pass's two stages of lse and delta, and, with a bias or segment
    ids, two stages of the bias tile ([BLOCK][BLOCK + 8] or [BLOCK][BLOCK +
    4] f32) and of the other side's ids."""
    if tensor_cores(name, dt):
        # the instance that holds d: 64 or 128 columns (``tc_dim``)
        tile = BLOCK * ((64 if d <= 64 else 128) + 8) * 2
        ids = 2 * BLOCK * 4 if seg else 0
        if name != "flash_attention_bwd_dkv":
            tiles = 5 if name == "flash_attention_fwd" else 6
            return tiles * tile + (2 * BLOCK * (BLOCK + 8) * 4 if bias
                                   else 0) + ids
        return 6 * tile + 4 * BLOCK * 4 + (
            2 * BLOCK * (BLOCK + 4) * 4 if bias else 0) + ids
    tile, ldp = BLOCK * (d + 1), BLOCK * (BLOCK + 1)
    return 4 * {"flash_attention_fwd": 3 * tile + ldp,
                "flash_attention_bwd_dq": 4 * tile + ldp + 2 * BLOCK,
                "flash_attention_bwd_dkv": 4 * tile + 2 * ldp
                + 2 * BLOCK}[name]


def flash_plan(name, d, dt, bias=False, seg=False) -> dict:
    """The numbers launch ``name`` runs with: tile rows ("block"),
    "threads", shared memory ("smem"), the blocks an SM holds by that
    shared memory ("blocks_per_sm": two for a tensor-core pass that fits
    two, else one) and where its products run ("mma": the tensor cores,
    "simt": the CUDA cores)."""
    tc = tensor_cores(name, dt)
    smem = flash_smem(name, d, dt, bias, seg)
    two = 2 * (smem + _launch.SMEM_RESERVED) <= _launch.SMEM_SM
    return {"block": BLOCK, "threads": _TC_THREADS if tc else _THREADS,
            "smem": smem, "blocks_per_sm": 2 if tc and two else 1,
            "products": "mma" if tc else "simt"}


def _key_tiles(q0, sk, off, causal):
    """Key tiles a query tile starting at row ``q0`` sees (``key_tiles``
    in the source); ``q0`` may be a numpy array."""
    last = sk - 1
    if causal:
        last = np.minimum(last, q0 + BLOCK - 1 + off)
    return np.where(np.asarray(last) < 0, 0, np.asarray(last) // BLOCK + 1)


# ---------------------------------------------------------------------------
# the segment-tile skip of the tensor-core passes, in numpy
# ---------------------------------------------------------------------------
def tile_id_ranges(ids):
    """[b, n] ids -> ([b, nt] min, [b, nt] max) of the ids of each
    ``BLOCK``-row tile (``id_range`` in the source)."""
    ids = np.asarray(ids, dtype=np.int64)
    b, n = ids.shape
    nt = -(-n // BLOCK)
    lo = np.full((b, nt * BLOCK), np.iinfo(np.int32).max, np.int64)
    hi = np.full((b, nt * BLOCK), np.iinfo(np.int32).min, np.int64)
    lo[:, :n] = hi[:, :n] = ids
    return (lo.reshape(b, nt, BLOCK).min(-1),
            hi.reshape(b, nt, BLOCK).max(-1))


def segment_tiles_kept(seg_q, seg_k):
    """[b, nqt, nkt] bool: the (query tile, key tile) pairs whose id
    ranges meet, which the tensor-core passes compute (``ranges_meet``);
    every other pair holds no (query, key) pair of one id."""
    qlo, qhi = tile_id_ranges(seg_q)
    klo, khi = tile_id_ranges(seg_k)
    return ((qhi[:, :, None] >= klo[:, None, :])
            & (khi[:, None, :] >= qlo[:, :, None]))


def segment_tiles_needed(seg_q, seg_k, causal):
    """[b, nqt, nkt] bool: the pairs that hold a (query, key) pair of one
    id that the mask lets the query see (bottom-right causal when
    ``causal``): the work the function needs."""
    seg_q, seg_k = np.asarray(seg_q), np.asarray(seg_k)
    (b, sq), sk = seg_q.shape, seg_k.shape[1]
    same = seg_q[:, :, None] == seg_k[:, None, :]
    if causal:
        same &= np.tri(sq, sk, sk - sq, dtype=bool)
    nqt, nkt = -(-sq // BLOCK), -(-sk // BLOCK)
    pad = np.zeros((b, nqt * BLOCK, nkt * BLOCK), dtype=bool)
    pad[:, :sq, :sk] = same
    return pad.reshape(b, nqt, BLOCK, nkt, BLOCK).any(axis=(2, 4))


@dataclasses.dataclass(frozen=True)
class SegTiles:
    """A launch's segment ids at tile granularity, for its plan (hashable,
    so that :func:`flash_spec` caches on it): the pairs the tensor-core
    passes compute (:func:`segment_tiles_kept`) and the pairs the function
    needs (:func:`segment_tiles_needed`), each [b, nqt, nkt] bool."""
    shape: tuple
    kept_bits: bytes
    needed_bits: bytes

    @classmethod
    def of(cls, seg_q, seg_k, causal, kept=None):
        """From the ids (tensors or arrays); ``kept`` overrides the
        kernels' predicate (the gate's regression specimen)."""
        seg_q, seg_k = (np.asarray(torch.as_tensor(t).cpu())
                        for t in (seg_q, seg_k))
        kept = segment_tiles_kept(seg_q, seg_k) if kept is None else kept
        need = segment_tiles_needed(seg_q, seg_k, causal)
        return cls(need.shape, np.packbits(kept).tobytes(),
                   np.packbits(need).tobytes())

    def _unpack(self, bits):
        n = int(np.prod(self.shape))
        return np.unpackbits(np.frombuffer(bits, np.uint8),
                             count=n).astype(bool).reshape(self.shape)

    @property
    def kept(self):
        return self._unpack(self.kept_bits)

    @property
    def needed(self):
        return self._unpack(self.needed_bits)


@functools.lru_cache(maxsize=128)
def flash_spec(name, b, sq, sk, h, kvh, d, dt, causal, bias=None,
               seg=False, dbias=False, dropout=False):
    """The launch spec of one flash kernel. Forward and dq: one block per
    (query tile, batch x head), grid (sq / BLOCK, b * h), reading the
    tile's rows of q (and do, lse, delta, seg_q) and every key tile it
    sees (under the causal mask, those up to its diagonal: k, v, the bias
    tile, seg_k), writing its rows of o and lse (or dq, and with ``dbias``
    the tile's rows of dbias over every key tile, zeros past the
    diagonal). dkv: one block per (key tile, batch x KV head), grid
    (sk / BLOCK, b * kvh), reading the tile's rows of k, v and seg_k and,
    for each query head of the group, every query tile that sees it (with
    its bias tile and seg_q), writing its rows of dk and dv. ``bias``: the
    bias's (batch, head) extents, each 1 (broadcast) or the full one.
    ``seg``: whether segment ids are given, or for a tensor-core pass the
    launch's :class:`SegTiles`: then the pass computes only the kept pairs,
    and the other side's operands (k, v, seg_k for dq; q, do, lse, delta,
    seg_q for dkv; the bias) must be read at every tile a needed pair
    holds (``masked``), not at every tile."""
    nqt, nkt = -(-sq // BLOCK), -(-sk // BLOCK)
    off, rep_ = sk - sq, h // kvh
    op = _launch.KernelOperand
    tile = (1, BLOCK, 1, d)
    btile, stile, rtile = (1, 1, BLOCK, BLOCK), (1, BLOCK), (1, 1, BLOCK)
    tiles = seg if isinstance(seg, SegTiles) and tensor_cores(name, dt) \
        else None
    need = None if tiles is None else tiles.needed
    qt_ = np.arange(nqt)[:, None]
    kt_ = np.arange(nkt)[None, :]
    # the (query tile, key tile) pairs each pass visits under the causal
    # mask: up to the query tile's diagonal (forward, dq), from the key
    # tile's first query tile on (dkv)
    visit = np.broadcast_to(kt_ < _key_tiles(qt_ * BLOCK, sk, off, causal),
                            (nqt, nkt))
    if name == "flash_attention_bwd_dkv":
        first = np.maximum(kt_ * BLOCK - off, 0) // BLOCK if causal else 0
        visit = np.broadcast_to(qt_ >= first, (nqt, nkt))
    computed = None
    if tiles is not None:
        computed = visit[None] & tiles.kept          # [b, nqt, nkt]

    def pair_seen(qt, kt):
        # some row of query tile qt sees some key of key tile kt
        return np.minimum(qt * BLOCK + BLOCK, sq) - 1 + off >= kt * BLOCK

    def rows_seen(t, axis):
        # tiles of a per-query-row operand whose rows see some key
        return _launch.Seen(t, lambda c: pair_seen(c[:, axis], 0))

    def needed(t, b_ax, q_ax=None, k_ax=None):
        # tiles holding a needed pair: [b, tile] over the other axis
        side = need.any(axis=2) if k_ax is None else need.any(axis=1)
        ax = q_ax if k_ax is None else k_ax
        return _launch.Seen(t, lambda c: side[c[:, b_ax], c[:, ax]])
    # causal with sq > sk: the top query rows see no key, so the dkv pass,
    # which walks the query tiles each key tile sees, never reads them
    dkv = name == "flash_attention_bwd_dkv"
    top = dkv and causal and sq > sk
    q_mask = (needed(tile, 0, q_ax=1) if dkv and tiles else
              rows_seen(tile, 1) if top else None)
    k_mask = needed(tile, 0, k_ax=1) if tiles and not dkv else None
    q_, k_, v_ = (op("q", (b, sq, h, d), dt, masked=q_mask),
                  op("k", (b, sk, kvh, d), dt, masked=k_mask),
                  op("v", (b, sk, kvh, d), dt, masked=k_mask))
    do_ = op("do", (b, sq, h, d), dt, masked=q_mask)
    r_mask = (needed(rtile, 0, q_ax=2) if dkv and tiles else
              rows_seen(rtile, 2) if top else None)
    stat = lambda n: op(n, (b, h, sq), "float32", masked=r_mask)  # noqa
    A = _launch.Access
    extra_in = ()
    if bias is not None:
        # under the causal mask the tiles past the diagonal are never read;
        # with skipped pairs, only the tiles of needed pairs must be
        if tiles is not None:
            any_b = need.any(axis=0)
            b_mask = _launch.Seen(btile, lambda c: np.where(
                bias[0] > 1, need[np.minimum(c[:, 0], b - 1), c[:, 2],
                                  c[:, 3]], any_b[c[:, 2], c[:, 3]]))
        else:
            b_mask = (_launch.Seen(btile, lambda c: pair_seen(c[:, 2],
                                                             c[:, 3]))
                      if causal else None)
        extra_in += (op("bias", (*bias, sq, sk), "float32", masked=b_mask),)
    if seg:
        extra_in += (op("seg_q", (b, sq), "int32", masked=(
                         needed(stile, 0, q_ax=1) if dkv and tiles else
                         rows_seen(stile, 1) if top else None)),
                     op("seg_k", (b, sk), "int32", masked=(
                         needed(stile, 0, k_ax=1) if tiles and not dkv
                         else None)))

    def bias_at(bb, hh, qt, kt):
        return (bb if bias[0] > 1 else 0 * bb,
                hh if bias[1] > 1 else 0 * hh, qt, kt)
    if dkv:
        grid = (nkt, b * kvh)
        ins = (q_, k_, v_, do_, stat("lse"), stat("delta")) + extra_in
        outs = (op("dk", (b, sk, kvh, d), dt), op("dv", (b, sk, kvh, d), dt))

        def own(i):
            return (i // nkt // kvh, i % nkt, i // nkt % kvh, 0)

        if computed is None:
            def seen_q(i):
                # item: (tile kt, batch x KV head, group member g, query
                # tile)
                qt, rest = i % nqt, i // nqt
                g, rest = rest % rep_, rest // rep_
                kt, bk = rest % nkt, rest // nkt
                first = (np.maximum(kt * BLOCK - off, 0) // BLOCK if causal
                         else 0)
                return (bk // kvh, np.maximum(qt, first),
                        bk % kvh * rep_ + g, 0)

            def key_of(i):
                return i // nqt // rep_ % nkt
            n_seen = nkt * b * kvh * rep_ * nqt
        else:
            # item: a computed (batch, query tile, key tile) pair, for each
            # (KV head, group member)
            cb, cq, ck = (np.repeat(a, h) for a in np.nonzero(computed))
            ch = np.tile(np.arange(h), len(cb) // h)

            def seen_q(i):
                return (cb[i], cq[i], ch[i], 0)

            def key_of(i):
                return ck[i]
            n_seen = len(cb)

        def seen_stat(i):
            bb, qt, hh, _ = seen_q(i)
            return (bb, hh, qt)

        def seen_bias(i):
            bb, qt, hh, _ = seen_q(i)
            return bias_at(bb, hh, qt, key_of(i))
        key_reads = (A("k", tile, own), A("v", tile, own))
        q_reads = (A("q", tile, seen_q), A("do", tile, seen_q),
                   A("lse", rtile, seen_stat),
                   A("delta", rtile, seen_stat))
        if seg:
            key_reads += (A("seg_k", stile,
                            lambda i: (i // nkt // kvh, i % nkt)),)
            q_reads += (A("seg_q", stile, lambda i: seen_stat(i)[::2]),)
        if bias is not None:
            q_reads += (A("bias", btile, seen_bias),)
        phases = (_launch.KernelPhase(
            "keys", nkt * b * kvh, key_reads,
            (A("dk", tile, own), A("dv", tile, own))),
            _launch.KernelPhase("queries", n_seen, q_reads))
    else:
        grid = (nqt, b * h)
        dq = name == "flash_attention_bwd_dq"
        ins = (q_, k_, v_)
        if dq:
            ins += (do_, stat("lse"), stat("delta"))
            outs = (op("dq", (b, sq, h, d), dt),)
            if dbias:
                outs += (op("dbias", (b * h, sq, sk), "float32"),)
        else:
            outs = (op("o", (b, sq, h, d), dt), stat("lse_out"))
        ins += extra_in

        def own(i):
            return (i // nqt // h, i % nqt, i // nqt % h, 0)

        def own_stat(i):
            return (i // nqt // h, i // nqt % h, i % nqt)

        if computed is None:
            def seen_pair(i):
                # item: (query tile, batch x head, key tile) -> (batch,
                # head, query tile, key tile)
                kt, rest = i % nkt, i // nkt
                qt, bh = rest % nqt, rest // nqt
                last = _key_tiles(qt * BLOCK, sk, off, causal) - 1
                return (bh // h, bh % h, qt,
                        np.minimum(kt, np.maximum(last, 0)))
            n_pairs = nqt * b * h * nkt
        else:
            # item: a computed (batch, query tile, key tile) pair, for each
            # head
            cb, cq, ck = (np.repeat(a, h) for a in np.nonzero(computed))
            ch = np.tile(np.arange(h), len(cb) // h)

            def seen_pair(i):
                return (cb[i], ch[i], cq[i], ck[i])
            n_pairs = len(cb)

        def seen_k(i):
            bb, hh, _, kt = seen_pair(i)
            return (bb, kt, hh // rep_, 0)

        def seen_bias(i):
            return bias_at(*seen_pair(i))
        reads = [A("q", tile, own)]
        key_reads = [A("k", tile, seen_k), A("v", tile, seen_k)]
        if dq:
            reads += [A("do", tile, own), A("lse", rtile, own_stat),
                      A("delta", rtile, own_stat)]
            writes = (A("dq", tile, own),)
        else:
            writes = (A("o", tile, own),
                      A("lse_out", rtile, own_stat))
        if seg:
            reads.append(A("seg_q", stile, lambda i: own_stat(i)[::2]))
            key_reads.append(A("seg_k", stile,
                               lambda i: seen_k(i)[:2]))
        if bias is not None:
            key_reads.append(A("bias", btile, seen_bias))
        phases = (_launch.KernelPhase("queries", nqt * b * h, tuple(reads),
                                      writes),
                  _launch.KernelPhase("keys", n_pairs, tuple(key_reads)))
        if dq and dbias:
            # every (query tile, key tile) of each head: P (dP - delta)
            # where computed, zeros elsewhere
            phases += (_launch.KernelPhase(
                "dbias", nqt * b * h * nkt, (),
                (A("dbias", (1, BLOCK, BLOCK),
                   lambda i: (i // nkt // nqt, i // nkt % nqt, i % nkt)),)),)
    plan = flash_plan(name, d, dt, bias is not None, bool(seg))
    params = {"causal": bool(causal), "bias": bias, "segments": bool(seg),
              "dbias": bool(dbias), "dropout": bool(dropout)}
    if computed is not None:
        # the (query tile, key tile) pairs of one head the pass computes
        # over the batch, and those the causal mask alone leaves
        params["pairs"] = int(computed.sum())
        params["pairs_causal"] = int(visit.sum()) * b
    return _launch.KernelLaunchSpec(
        name, "cuda", _SOURCE, grid, plan["threads"], ins, outs, phases,
        ((name, flash_codes(name)),), dt, dyn_smem=plan["smem"],
        blocks_per_sm=plan["blocks_per_sm"], params=params, plan=plan)


def flash_unsupported(q, k, causal=False):
    """Why the kernels do not take these operands, or None."""
    if q.dtype not in _build.DTYPES:
        return f"dtype {q.dtype} (the kernels take float32 and bfloat16)"
    if q.dim() != 4 or k.dim() != 4:
        return "q, k and v must be [batch, seq, heads, head_dim]"
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    if d > 128 or d % 8:
        return f"head_dim {d} (the kernels take a multiple of 8 up to 128)"
    if h % kvh:
        return f"{h} query heads are not a multiple of {kvh} K/V heads"
    if b * max(h, kvh) > 65535:
        return f"batch x heads = {b * h} passes the grid's 65535"
    return None


def _check(name, q, k, v, causal, *more):
    why = flash_unsupported(q, k, causal)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    _launch.check_device(name, q.device)
    for t in (k, v) + more:
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if not q.is_contiguous():
        raise ValueError(f"{name}: operands must be contiguous")
    if k.dtype != q.dtype or v.dtype != q.dtype or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: q {tuple(q.shape)} {q.dtype}, k "
                         f"{tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} "
                         f"{v.dtype} do not match")


def _check_extras(name, q, k, bias, seg_q, seg_k, rate):
    """The optional operands: a [b|1, h|1, sq, sk] f32 bias, [b, sq] and
    [b, sk] int32 segment ids (both or neither), 0 <= rate < 1."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    if bias is not None:
        if bias.dtype != torch.float32 or bias.dim() != 4 \
                or bias.shape[0] not in (1, b) or bias.shape[1] not in (1, h) \
                or tuple(bias.shape[2:]) != (sq, sk):
            raise ValueError(f"{name}: bias must be [b|1, h|1, sq, sk] = "
                             f"[{b}|1, {h}|1, {sq}, {sk}] float32, got "
                             f"{tuple(bias.shape)} {bias.dtype}")
    if (seg_q is None) != (seg_k is None):
        raise ValueError(f"{name}: give both segment ids or neither")
    if seg_q is not None:
        for nm, t, n in (("seg_q", seg_q, sq), ("seg_k", seg_k, sk)):
            if t.dtype != torch.int32 or tuple(t.shape) != (b, n):
                raise ValueError(f"{name}: {nm} must be [{b}, {n}] int32, "
                                 f"got {tuple(t.shape)} {t.dtype}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{name}: dropout rate {rate} is not in [0, 1)")


def _ptr(t):
    return None if t is None else t.data_ptr()


#: the optional bodies, in the order a body class names them
BODY_FLAGS = ("bias", "dbias", "seg", "dropout", "causal_sq_gt_sk")


def body_class(bias=False, dbias=False, seg=False, dropout=False,
               causal_sq_gt_sk=False) -> str:
    """The body class a launch counts under (``<wrapper>.launches_by_body``):
    its optional bodies joined by commas in :data:`BODY_FLAGS` order
    ("seg,dropout"), or "plain"."""
    on = dict(bias=bias, dbias=dbias, seg=seg, dropout=dropout,
              causal_sq_gt_sk=causal_sq_gt_sk)
    return ",".join(f for f in BODY_FLAGS if on[f]) or "plain"


def _run(name, wrapper, q, k, v, bias, seg_q, seg_k, *ptrs, causal, scale,
         seed, rate, dbias=False):
    b, sq, h, d = q.shape
    kvh, sk = k.shape[2], k.shape[1]
    dt = _launch.dtype_name(q.dtype)
    seg = seg_q is not None
    plan_of = flash_spec
    if seg and tensor_cores(name, dt) and q.device.type == "cuda" \
            and _launch.capturing():
        # the gate's capture: the plan of the pairs this launch's ids keep
        # (read on the host; the launch path itself never syncs), built
        # uncached, since it holds index arrays over the pairs
        seg = SegTiles.of(seg_q, seg_k, causal)
        plan_of = flash_spec.__wrapped__
    spec = plan_of(name, b, sq, sk, h, kvh, d, dt, bool(causal),
                   None if bias is None else tuple(bias.shape[:2]),
                   seg, bool(dbias), rate > 0.0)
    if not _launch.begin(spec, q.device):
        return
    fn = _build.c_fn("flash_attention", *spec.calls[0])
    bb, bhh = (1, 1) if bias is None else tuple(bias.shape[:2])
    cls = body_class(bias is not None, dbias, seg_q is not None, rate > 0.0,
                     bool(causal) and sq > sk)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch.count(wrapper, body=cls)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
                 _ptr(seg_q), _ptr(seg_k), *(_ptr(t) for t in ptrs), b, h,
                 kvh, sq, sk, d, spec.plan["block"], spec.plan["smem"], bb,
                 bhh, int(seed) & 0xFFFFFFFF, float(scale), float(rate),
                 dropout_inv(rate) if rate > 0.0 else 1.0,
                 int(bool(causal)), _build.DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + fn.error_string(err).decode())


def _aligned(*ts):
    """The tensors, each copied to a fresh allocation where its data does
    not start on 16 bytes (the tensor-core passes copy 16 bytes at a
    time; a contiguous view may start anywhere)."""
    return tuple(t if t is None or t.data_ptr() % 16 == 0 else t.clone()
                 for t in ts)


def flash_fwd_cuda(q, k, v, causal=False, scale=None, bias=None,
                   seg_q=None, seg_k=None, seed=0, rate=0.0):
    """Launch ``flash_attention_fwd``: (o, lse) as :func:`flash_fwd_ref`.
    Raises for what the kernel does not take; never falls back."""
    name = "flash_attention_fwd"
    _check(name, q, k, v, causal, bias, seg_q, seg_k)
    _check_extras(name, q, k, bias, seg_q, seg_k, rate)
    q, k, v, bias = _aligned(q, k, v, bias)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                      dtype=torch.float32, device=q.device)
    _run(name, flash_fwd_cuda, q, k, v, bias, seg_q, seg_k, o, lse,
         causal=causal, scale=_scale(q, scale), seed=seed, rate=rate)
    return o, lse


def _check_stats(name, q, do, lse, delta):
    want = (q.shape[0], q.shape[2], q.shape[1])
    for nm, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"{name}: {nm} must be {list(want)} float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: do {tuple(do.shape)} {do.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=False, scale=None,
                      bias=None, seg_q=None, seg_k=None, seed=0, rate=0.0,
                      bias_grad=False):
    """Launch ``flash_attention_bwd_dq``: dq as :func:`flash_bwd_dq_ref`;
    with ``bias_grad`` (a bias given) ``(dq, dbias)``, the kernel's dbias
    body writing every element of dbias [b*h, sq, sk] f32."""
    name = "flash_attention_bwd_dq"
    _check(name, q, k, v, causal, do, lse, delta, bias, seg_q, seg_k)
    _check_stats(name, q, do, lse, delta)
    _check_extras(name, q, k, bias, seg_q, seg_k, rate)
    if bias_grad and bias is None:
        raise ValueError(f"{name}: bias_grad needs a bias")
    q, k, v, do, bias = _aligned(q, k, v, do, bias)
    dq = torch.empty_like(q)
    dbias = (torch.empty(q.shape[0] * q.shape[2], q.shape[1], k.shape[1],
                         dtype=torch.float32, device=q.device)
             if bias_grad else None)
    _run(name, flash_bwd_dq_cuda, q, k, v, bias, seg_q, seg_k, do, lse,
         delta, dq, dbias, causal=causal, scale=_scale(q, scale), seed=seed,
         rate=rate, dbias=bias_grad)
    return (dq, dbias) if bias_grad else dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=False, scale=None,
                       bias=None, seg_q=None, seg_k=None, seed=0, rate=0.0):
    """Launch ``flash_attention_bwd_dkv``: (dk, dv) as
    :func:`flash_bwd_dkv_ref`."""
    name = "flash_attention_bwd_dkv"
    _check(name, q, k, v, causal, do, lse, delta, bias, seg_q, seg_k)
    _check_stats(name, q, do, lse, delta)
    _check_extras(name, q, k, bias, seg_q, seg_k, rate)
    q, k, v, do, bias = _aligned(q, k, v, do, bias)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _run(name, flash_bwd_dkv_cuda, q, k, v, bias, seg_q, seg_k, do, lse,
         delta, dk, dv, causal=causal, scale=_scale(q, scale), seed=seed,
         rate=rate)
    return dk, dv


for _w in (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda):
    # the launches by body class, keys added as the classes launch
    _launch.counted(_w, body=())


def _sum_broadcast(dbias, bias_shape, b, h):
    """dbias [b*h, sq, sk] f32 summed over the bias's broadcast axes into
    ``bias_shape`` (the JAX ``_flash_bwd_rule``)."""
    d = dbias.reshape(b, h, *dbias.shape[1:])
    if bias_shape[1] == 1:
        d = d.sum(1, keepdim=True)
    if bias_shape[0] == 1:
        d = d.sum(0, keepdim=True)
    return d


class FlashAttention(torch.autograd.Function):
    """The kernels as one differentiable op (the JAX package's
    ``custom_vjp`` ``_flash``): the forward launches
    ``flash_attention_fwd`` and saves q, k, v, o, lse, the f32 bias, the
    segment ids and the dropout seed; the backward computes
    ``delta = rowsum(o * do)`` in f32 and launches the dq pass (with its
    dbias body when the bias needs a gradient) and the dkv pass. The bias
    gradient is summed over the bias's broadcast axes in f32 and cast to
    the bias's type. Arguments after ``scale``: bias ``[b|1, h|1, sq,
    sk]`` (any float type; converted to contiguous f32 once, which is
    exact), seg_q, seg_k (int32), the dropout seed and rate."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, bias=None, seg_q=None,
                seg_k=None, seed=0, rate=0.0):
        bias32 = None if bias is None else bias.float().contiguous()
        o, lse = flash_fwd_cuda(q, k, v, causal, scale, bias32, seg_q,
                                seg_k, seed, rate)
        ctx.save_for_backward(q, k, v, o, lse, bias32, seg_q, seg_k)
        ctx.causal, ctx.scale, ctx.seed, ctx.rate = causal, scale, seed, rate
        ctx.bias_meta = None if bias is None else (tuple(bias.shape),
                                                   bias.dtype)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, bias32, seg_q, seg_k = ctx.saved_tensors
        do = do.contiguous()
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        extras = (bias32, seg_q, seg_k, ctx.seed, ctx.rate)
        bias_grad = bias32 is not None and ctx.needs_input_grad[5]
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, ctx.causal,
                               ctx.scale, *extras, bias_grad=bias_grad)
        dbias = None
        if bias_grad:
            dq, full = dq
            shape, dtype = ctx.bias_meta
            dbias = _sum_broadcast(full, shape, q.shape[0],
                                   q.shape[2]).to(dtype)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, ctx.causal,
                                    ctx.scale, *extras)
        return dq, dk, dv, None, None, dbias, None, None, None, None


def flash_attention_cuda(q, k, v, causal=False, scale=None, bias=None,
                         segment_ids=None, kv_segment_ids=None,
                         dropout_rate=0.0, dropout_seed=0):
    """Flash attention through the CUDA kernels, differentiable in q, k, v
    and the bias (a learned bias: the caller leaves it attached; a
    constant one is detached). Never falls back to a plain version."""
    seg_q = seg_k = None
    if segment_ids is not None:
        kv = kv_segment_ids if kv_segment_ids is not None else segment_ids
        seg_q = segment_ids.to(torch.int32).contiguous()
        seg_k = kv.to(torch.int32).contiguous()
    rate = float(dropout_rate or 0.0)
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), bool(causal), scale, bias,
                                seg_q, seg_k, int(dropout_seed or 0), rate)
