"""Flash attention: the three CUDA kernels' wrappers, their plain PyTorch
versions and the ``torch.autograd.Function`` that joins them.

Replaces ``paddle_tpu/ops/pallas/flash_attention.py``'s
``flash_attention_pallas`` (launches ``flash_attention_fwd``,
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``). The kernels
are ``paddle_tpu_torch/csrc/flash_attention.cu``, CUDA C++ for
``sm_90a``, built by :mod:`._build` at the first launch and bound with
ctypes; that file's header says what bounds them on the H100 (operations)
and how their design follows from it.

Layout: the public ``[batch, seq, heads, head_dim]`` (q, o: ``h`` heads;
k, v: ``kvh`` heads, ``h % kvh == 0``), read by stride; the log-sum-exp
and ``delta`` rows are ``[batch, h, sq]`` f32, the JAX package's
``[b*h, sq]``.

The plain versions are op for op the JAX kernels' arithmetic, dense:
:func:`flash_fwd_ref` (O and lse, ``P`` cast to V's type before ``P V``),
:func:`flash_bwd_dq_ref` and :func:`flash_bwd_dkv_ref` (``P`` recomputed
from lse, ``dS = P (dP - delta) scale``, dS cast to K's and Q's type for
dq and dk, ``dV`` from an f32 P). ``chip_smoke.py`` holds each kernel
against its plain version on the card; the CPU tests hold the plain
versions against the JAX kernels in interpret mode. The semantics-level
plain version with bias and segment ids is
:func:`paddle_tpu_torch.ops.flash_attention._ref_attention`.

Not ported (the wrappers raise): additive bias, segment ids, in-kernel
dropout, and causal attention with ``sq > sk`` (a row that sees no key:
the JAX kernel returns zeros there and its plain version the mean of V,
so no plain version can hold the kernel).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _build, _launch

__all__ = ["flash_fwd_ref", "flash_bwd_dq_ref", "flash_bwd_dkv_ref",
           "flash_fwd_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda",
           "FlashAttention", "flash_attention_cuda", "flash_unsupported",
           "MASK_VALUE"]

#: the JAX kernel's DEFAULT_MASK_VALUE (-0.7 x float32 max)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


# ---------------------------------------------------------------------------
# plain versions: the kernels' arithmetic, dense
# ---------------------------------------------------------------------------
def _repeat_kv(t, h):
    g = h // t.shape[2]
    return torch.repeat_interleave(t, g, dim=2) if g > 1 else t


def _scores(q, k, causal, scale):
    """Scaled f32 scores [b, h, sq, sk] and the seen mask (None when every
    key is seen)."""
    h = q.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     _repeat_kv(k, h).float()) * scale
    sq, sk = s.shape[-2], s.shape[-1]
    valid = None
    if causal:
        valid = torch.ones(sq, sk, dtype=torch.bool,
                           device=q.device).tril(sk - sq)
    return s, valid


def flash_fwd_ref(q, k, v, causal=False, scale=None):
    """(o [b, sq, h, d] in q's type, lse [b, h, sq] f32)."""
    scale = _scale(q, scale)
    s, valid = _scores(q, k, causal, scale)
    if valid is not None:
        s = torch.where(valid, s, MASK_VALUE)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    vr = _repeat_kv(v, q.shape[2])
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vr.float())
    o = o / l_safe.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    s, valid = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(),
                      _repeat_kv(v, q.shape[2]).float())
    return p, p * (dp - delta[..., None]) * scale


def _sum_groups(t, kvh):
    """[b, sk, h, d] -> [b, sk, kvh, d]: the query heads of each group
    summed into their K/V head."""
    b, sk, h, d = t.shape
    return t.reshape(b, sk, kvh, h // kvh, d).sum(3)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=False, scale=None):
    """dq [b, sq, h, d] in q's type from the forward's lse and
    ``delta = rowsum(o * do)`` (both [b, h, sq] f32)."""
    scale = _scale(q, scale)
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      _repeat_kv(k, q.shape[2]).float())
    return dq.to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal=False, scale=None):
    """(dk, dv) [b, sk, kvh, d] in k's and v's types."""
    scale = _scale(q, scale)
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
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
_THREADS = 256
_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
_N_PTR = {"flash_attention_fwd": 5, "flash_attention_bwd_dq": 7,
          "flash_attention_bwd_dkv": 8}


def flash_smem(name, d) -> int:
    """Dynamic shared memory of one block of kernel ``name``: its f32 tiles
    of ``BLOCK`` rows (row stride d + 1) and the score tiles (stride
    BLOCK + 1) (``fwd_smem``/``dq_smem``/``dkv_smem`` in the source, which
    the launchers hold this figure to)."""
    tile, ldp = BLOCK * (d + 1), BLOCK * (BLOCK + 1)
    return 4 * {"flash_attention_fwd": 3 * tile + ldp,
                "flash_attention_bwd_dq": 4 * tile + ldp + 2 * BLOCK,
                "flash_attention_bwd_dkv": 4 * tile + 2 * ldp
                + 2 * BLOCK}[name]


def _key_tiles(q0, sk, off, causal):
    """Key tiles a query tile starting at row ``q0`` sees (``key_tiles``
    in the source); ``q0`` may be a numpy array."""
    last = sk - 1
    if causal:
        last = np.minimum(last, q0 + BLOCK - 1 + off)
    return np.where(np.asarray(last) < 0, 0, np.asarray(last) // BLOCK + 1)


@functools.lru_cache(maxsize=128)
def flash_spec(name, b, sq, sk, h, kvh, d, dt, causal):
    """The launch spec of one flash kernel. Forward and dq: one block per
    (query tile, batch x head), grid (sq / BLOCK, b * h), reading the
    tile's rows of q (and do, lse, delta) and every key tile it sees
    (under the causal mask, those up to its diagonal), writing its rows of
    o and lse (or dq). dkv: one block per (key tile, batch x KV head),
    grid (sk / BLOCK, b * kvh), reading the tile's rows of k and v and, for
    each query head of the group, every query tile that sees it, writing
    its rows of dk and dv."""
    nqt, nkt = -(-sq // BLOCK), -(-sk // BLOCK)
    off, rep_ = sk - sq, h // kvh
    op = _launch.KernelOperand
    q_, k_, v_ = (op("q", (b, sq, h, d), dt), op("k", (b, sk, kvh, d), dt),
                  op("v", (b, sk, kvh, d), dt))
    stat = lambda n: op(n, (b, h, sq), "float32")   # noqa: E731
    tile = (1, BLOCK, 1, d)
    A = _launch.Access
    if name == "flash_attention_bwd_dkv":
        grid = (nkt, b * kvh)
        ins = (q_, k_, v_, op("do", (b, sq, h, d), dt), stat("lse"),
               stat("delta"))
        outs = (op("dk", (b, sk, kvh, d), dt), op("dv", (b, sk, kvh, d), dt))

        def own(i):
            return (i // nkt // kvh, i % nkt, i // nkt % kvh, 0)

        def seen_q(i):
            # item: (tile kt, batch x KV head, group member g, query tile)
            qt, rest = i % nqt, i // nqt
            g, rest = rest % rep_, rest // rep_
            kt, bk = rest % nkt, rest // nkt
            first = (np.maximum(kt * BLOCK - off, 0) // BLOCK if causal
                     else 0)
            return (bk // kvh, np.maximum(qt, first), bk % kvh * rep_ + g, 0)

        def seen_stat(i):
            bb, qt, hh, _ = seen_q(i)
            return (bb, hh, qt)
        n_seen = nkt * b * kvh * rep_ * nqt
        phases = (_launch.KernelPhase(
            "keys", nkt * b * kvh, (A("k", tile, own), A("v", tile, own)),
            (A("dk", tile, own), A("dv", tile, own))),
            _launch.KernelPhase(
                "queries", n_seen,
                (A("q", tile, seen_q), A("do", tile, seen_q),
                 A("lse", (1, 1, BLOCK), seen_stat),
                 A("delta", (1, 1, BLOCK), seen_stat))))
    else:
        grid = (nqt, b * h)
        dq = name == "flash_attention_bwd_dq"
        ins = (q_, k_, v_)
        if dq:
            ins += (op("do", (b, sq, h, d), dt), stat("lse"), stat("delta"))
            outs = (op("dq", (b, sq, h, d), dt),)
        else:
            outs = (op("o", (b, sq, h, d), dt), stat("lse_out"))

        def own(i):
            return (i // nqt // h, i % nqt, i // nqt % h, 0)

        def own_stat(i):
            return (i // nqt // h, i // nqt % h, i % nqt)

        def seen_k(i):
            # item: (query tile, batch x head, key tile)
            kt, rest = i % nkt, i // nkt
            qt, bh = rest % nqt, rest // nqt
            last = _key_tiles(qt * BLOCK, sk, off, causal) - 1
            return (bh // h, np.minimum(kt, np.maximum(last, 0)),
                    bh % h // rep_, 0)
        reads = [A("q", tile, own)]
        if dq:
            reads += [A("do", tile, own), A("lse", (1, 1, BLOCK), own_stat),
                      A("delta", (1, 1, BLOCK), own_stat)]
            writes = (A("dq", tile, own),)
        else:
            writes = (A("o", tile, own),
                      A("lse_out", (1, 1, BLOCK), own_stat))
        phases = (_launch.KernelPhase("queries", nqt * b * h, tuple(reads),
                                      writes),
                  _launch.KernelPhase("keys", nqt * b * h * nkt,
                                      (A("k", tile, seen_k),
                                       A("v", tile, seen_k))))
    smem = flash_smem(name, d)
    codes = ("p",) * _N_PTR[name] + ("i",) * 8 + ("f", "i", "i", "p")
    return _launch.KernelLaunchSpec(
        name, "cuda", _SOURCE, grid, _THREADS, ins, outs, phases,
        ((name, codes),), dt, dyn_smem=smem,
        params={"causal": bool(causal)},
        plan={"block": BLOCK, "smem": smem})


def flash_unsupported(q, k, causal):
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
    if causal and sq > sk:
        return (f"causal attention with sq={sq} > sk={sk} is not ported "
                "(rows that see no key)")
    if b * max(h, kvh) > 65535:
        return f"batch x heads = {b * h} passes the grid's 65535"
    return None


def _check(name, q, k, v, causal, *more):
    why = flash_unsupported(q, k, causal)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    _launch.check_device(name, q.device)
    for t in (k, v) + more:
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


def _run(name, wrapper, q, *ptrs, causal, scale):
    b, sq, h, d = q.shape
    kvh, sk = ptrs[0].shape[2], ptrs[0].shape[1]      # ptrs[0] is k
    spec = flash_spec(name, b, sq, sk, h, kvh, d,
                      _launch.dtype_name(q.dtype), bool(causal))
    if not _launch.begin(spec, q.device):
        return
    fn = _build.c_fn("flash_attention", *spec.calls[0])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        wrapper.launches += 1
        err = fn(q.data_ptr(), *(t.data_ptr() for t in ptrs), b, h, kvh, sq,
                 sk, d, spec.plan["block"], spec.plan["smem"], float(scale),
                 int(bool(causal)), _build.DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + fn.error_string(err).decode())


def flash_fwd_cuda(q, k, v, causal=False, scale=None):
    """Launch ``flash_attention_fwd``: (o, lse) as :func:`flash_fwd_ref`.
    Raises for what the kernel does not take; never falls back."""
    _check("flash_attention_fwd", q, k, v, causal)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                      dtype=torch.float32, device=q.device)
    _run("flash_attention_fwd", flash_fwd_cuda, q, k, v, o, lse,
            causal=causal, scale=_scale(q, scale))
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


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=False, scale=None):
    """Launch ``flash_attention_bwd_dq``: dq as :func:`flash_bwd_dq_ref`."""
    _check("flash_attention_bwd_dq", q, k, v, causal, do, lse, delta)
    _check_stats("flash_attention_bwd_dq", q, do, lse, delta)
    dq = torch.empty_like(q)
    _run("flash_attention_bwd_dq", flash_bwd_dq_cuda, q, k, v, do, lse,
            delta, dq, causal=causal, scale=_scale(q, scale))
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=False, scale=None):
    """Launch ``flash_attention_bwd_dkv``: (dk, dv) as
    :func:`flash_bwd_dkv_ref`."""
    _check("flash_attention_bwd_dkv", q, k, v, causal, do, lse, delta)
    _check_stats("flash_attention_bwd_dkv", q, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _run("flash_attention_bwd_dkv", flash_bwd_dkv_cuda, q, k, v, do, lse,
            delta, dk, dv, causal=causal, scale=_scale(q, scale))
    return dk, dv


for _w in (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda):
    _w.launches = 0


class FlashAttention(torch.autograd.Function):
    """The kernels as one differentiable op (the JAX package's
    ``custom_vjp`` ``_flash``): the forward launches
    ``flash_attention_fwd`` and saves q, k, v, o and lse; the backward
    computes ``delta = rowsum(o * do)`` in f32 and launches the dq and
    dkv passes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd_cuda(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, ctx.causal,
                               ctx.scale)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, ctx.causal,
                                    ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_cuda(q, k, v, causal=False, scale=None, bias=None,
                         segment_ids=None, kv_segment_ids=None):
    """Flash attention through the CUDA kernels, differentiable in q, k
    and v. Raises ``NotImplementedError`` for bias and segment ids, which
    are not ported; never falls back to a plain version."""
    if bias is not None or segment_ids is not None \
            or kv_segment_ids is not None:
        raise NotImplementedError(
            "flash attention's CUDA kernels: additive bias and segment ids "
            "are not ported (ROADMAP B7)")
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), bool(causal), scale)
