"""The fused training path's kernels (port of
``paddle_tpu/ops/pallas/fused_train.py``): SwiGLU forward and backward
(Triton) and the lm-head + cross entropy (CUDA C++), their wrappers,
their plain PyTorch versions and the ``torch.autograd.Function`` of
each op.

SwiGLU replaces ``_swiglu_fwd_kernel`` (launch ``swiglu_fwd``, in
``_swiglu_fwd_call``) and ``_swiglu_bwd_kernel`` (``swiglu_bwd``,
``_swiglu_bwd_call``): ``silu(g) * u`` and its gradients ``dg = d u (s +
silu(g) (1 - s))``, ``du = d silu(g)`` with ``s = sigmoid(g)``, in f32
inside and rounded once per output. Bound on the H100: memory (fwd 3, bwd
5 tensors of [R, F] once each: 270.5 and 450.9 MB at [4096, 11008] bf16,
0.081 and 0.135 ms). Design: one Triton program per 1024 elements of the
flattened tensors with masked loads and stores, so any F works (the TPU's
rule that ``block_f`` divides F is a tile constraint, not semantics). The
plain versions :func:`swiglu_fwd_ref` and :func:`swiglu_bwd_ref` round
where the kernels do; the unfused composition ``F.silu(g) * u`` (the
op's ``"unfused"`` variant in :mod:`..fused_train`) rounds after each op
and is another function.

The linear CE replaces ``_ce_fwd_kernel``, ``_ce_dx_kernel`` and
``_ce_dh_kernel`` (launches ``linear_ce_fwd``, ``linear_ce_bwd_dx``,
``linear_ce_bwd_dh``); the kernels are
``paddle_tpu_torch/csrc/linear_ce.cu``, built by :mod:`._build` at the
first launch and bound with ctypes. That file's header says what bounds
them (operations: 1.07 TFLOP the forward, 2.15 the dx call, 1.07 the dh
call over a given P at the training shape) and how they are laid out:
in bf16 every pass is one wgmma GEMM with its sum in registers, told
apart by its epilogue. The forward's reduces each 128 x 256 tile of S to
its rows' stats (max, sum of exp, the logit at the label) in a partials
buffer of [3, vocab tiles, T] f32, which a second kernel combines in a
fixed order (:func:`ce_fwd_stats_ref` and :func:`ce_fwd_combine_ref` are
that split, plainly); f32 keeps the CUDA-core tiles and their vocab
splits (:func:`ce_splits`). The backward's P pass writes P = (softmax -
onehot) * valid * coef once, as bf16 hi + lo (f32 for f32 inputs), then
dx = P head^T and dh = x^T P are plain products over it.
``linear_ce_bwd_dx``'s call runs the P pass and dx and can keep P
(:class:`CEWorkspace`) for ``linear_ce_bwd_dh``'s, which then runs only
its product; P's workspace
is held to ``P_CAP_BYTES`` by token chunks (:func:`ce_chunk_rows`). Each
wrapper call is counted once, whatever kernels it runs. The plain
versions :func:`ce_fwd_ref`, :func:`ce_bwd_dx_ref` and
:func:`ce_bwd_dh_ref` compute the same functions densely in f32;
:func:`ce_p_split_ref`, :func:`ce_bwd_dx_split_ref` and
:func:`ce_bwd_dh_split_ref` are the P pass's split and the products over
it, plainly. :class:`LinearCE` does what the JAX package does
outside its kernels: flatten to [T, D], count the labels >= 0 (negative
labels, -1 and -100 alike, are ignored), the masked mean of ``lse -
pick`` over ``max(count, 1)``, and ``coef = g / max(count, 1)``. Labels
are taken as int64 (int32 widens; nothing narrows). Every call reads x
and the head through :func:`ce_operands`: the head in either dense layout
by its strides, so the tied head (the embedding seen transposed) is not
copied, and a bf16 head or x whose rows the card's tensor memory
accelerator cannot read is copied to aligned rows; dh is written in the
head's layout.

The Functions run the kernels for CUDA tensors and the plain versions for
CPU ones; a wrapper given anything else raises, never falls back.
Triton is imported, and the CUDA library built, at the first launch,
never at import.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build, _launch
from ._build import DTYPES

__all__ = ["swiglu_fwd_ref", "swiglu_bwd_ref", "swiglu_fwd_triton",
           "swiglu_bwd_triton", "SwiGLU", "ce_fwd_ref", "ce_bwd_dx_ref",
           "ce_bwd_dh_ref", "ce_fwd_stats_ref", "ce_fwd_combine_ref",
           "ce_p_split_ref", "ce_bwd_dx_split_ref",
           "ce_bwd_dh_split_ref", "linear_ce_fwd_cuda",
           "linear_ce_bwd_dx_cuda", "linear_ce_bwd_dh_cuda", "LinearCE",
           "CEOperands", "CEWorkspace", "ce_operands", "ce_workspace",
           "ce_p_pass", "ce_dx_product", "ce_dh_product", "ce_splits",
           "ce_chunk_rows", "ce_vtiles", "p_width", "BT", "BV"]

BLOCK = 1024
#: the f32 passes' logit tile (``kBT`` x ``kBV`` in linear_ce.cu; the
#: launchers refuse another)
BT, BV = 64, 128
_SMS = _launch.H100_SMS
_TRITON_SOURCE = "paddle_tpu_torch/ops/kernels/fused_train.py"
_CE_SOURCE = "paddle_tpu_torch/csrc/linear_ce.cu"
_CE_THREADS = 256
#: the f32 forward's static shared memory (kFwdSmem)
CE_FWD_SMEM = 33792
#: every bf16 pass's GEMM (linear_ce.cu, ``gemm::``): output tiles of
#: GEMM_BM x GEMM_BN, depth stages of GEMM_BK (dh's, x and P both
#: MN-major: GEMM_BK_DH), 384 threads (two consumer warpgroups and a
#: producer), one block an SM
GEMM_BM, GEMM_BN, GEMM_BK, GEMM_BK_DH, GEMM_THREADS = 128, 256, 64, 32, 384
#: their stages and dynamic shared memory (``gemm::stages``,
#: ``gemm::smem_bytes``): one product (the forward and the P pass); two A
#: tiles on one B tile (dx, and dh^T for the tied layout); two B tiles on
#: one A tile (dh)
CE_STAGES = {"p": 4, "pair_a": 3, "pair_b": 5}
CE_P_SMEM, CE_PAIR_A_SMEM, CE_PAIR_B_SMEM = 197728, 197728, 205920
#: the bf16 forward's combine: a block of COMBINE_TOKENS tokens by
#: COMBINE_STRANDS strands of vocab tiles (``kCombTokens``,
#: ``kCombStrands``)
COMBINE_TOKENS, COMBINE_STRANDS = 32, 8
#: the f32 backward's CUDA-core tiles: BT x BV, depth F32_BK, static
#: shared memory (BT + BV) x (F32_BK + 1) f32
F32_BK, CE_F32_SMEM = 32, 25344
#: P's columns are V rounded up to P_ALIGN; its workspace (hi + lo, or the
#: f32 P: T Vp 4 bytes) is held to P_CAP_BYTES by token chunks
P_ALIGN, P_CAP_BYTES = 64, 1 << 30
#: the launchers' ctypes argument codes
CE_CALLS = {
    "linear_ce_fwd": ("p", "l", "p", "l", "i") + ("p",) * 4 + ("i",) * 8
    + ("i", "p"),
    "linear_ce_p": ("p", "l", "p", "l", "i") + ("p",) * 5 + ("i",) * 5
    + ("i", "p"),
    "linear_ce_bwd_dx": ("p", "p", "p", "l", "i", "p") + ("i",) * 5
    + ("i", "p"),
    "linear_ce_bwd_dh": ("p", "l", "p", "p", "p", "l", "i", "p")
    + ("i",) * 6 + ("i", "p")}
_kernels = {}
tl = None          # triton.language, bound by triton_jit at the first launch


# ---------------------------------------------------------------------------
# SwiGLU
# ---------------------------------------------------------------------------
def swiglu_fwd_ref(gate, up):
    """``silu(g) * u`` in f32, rounded once to g's type."""
    gf, uf = gate.float(), up.float()
    return (gf * torch.sigmoid(gf) * uf).to(gate.dtype)


def swiglu_bwd_ref(gate, up, d):
    """``(dg, du)`` in f32, each rounded once to its input's type."""
    gf, uf, df = gate.float(), up.float(), d.float()
    sig = torch.sigmoid(gf)
    sil = gf * sig
    return ((df * uf * (sig + sil * (1.0 - sig))).to(gate.dtype),
            (df * sil).to(up.dtype))


def _swiglu_fwd_kernel(g_ptr, u_ptr, o_ptr, n, BLOCK: "tl.constexpr"):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    gf = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    uf = tl.load(u_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    sig = 1.0 / (1.0 + tl.exp(-gf))
    tl.store(o_ptr + offs, (gf * sig * uf).to(o_ptr.dtype.element_ty),
             mask=mask)


def _swiglu_bwd_kernel(g_ptr, u_ptr, d_ptr, dg_ptr, du_ptr, n,
                       BLOCK: "tl.constexpr"):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    gf = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    uf = tl.load(u_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    df = tl.load(d_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    sig = 1.0 / (1.0 + tl.exp(-gf))
    sil = gf * sig
    tl.store(dg_ptr + offs,
             (df * uf * (sig + sil * (1.0 - sig))).to(
                 dg_ptr.dtype.element_ty), mask=mask)
    tl.store(du_ptr + offs, (df * sil).to(du_ptr.dtype.element_ty),
             mask=mask)


def _check_elementwise(name, first, *more):
    _launch.check_device(name, first.device)
    for t in (first,) + more:
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} takes float32 and bfloat16, got "
                            f"{t.dtype}")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{name}: operands {tuple(t.shape)} on "
                             f"{t.device} and {tuple(first.shape)} on "
                             f"{first.device} do not match")


@functools.lru_cache(maxsize=128)
def swiglu_spec(name, n, dt):
    """One program per ``BLOCK`` elements of the flattened tensors: the
    forward reads g and u and writes the product; the backward reads g, u
    and the incoming gradient and writes dg and du."""
    op = _launch.KernelOperand
    names = (("gate", "up"), ("out",)) if name == "swiglu_fwd" \
        else (("gate", "up", "d"), ("dgate", "dup"))
    ins = tuple(op(k, (n,), dt) for k in names[0])
    outs = tuple(op(k, (n,), dt) for k in names[1])
    progs = -(-n // BLOCK)
    phase = _launch.KernelPhase(
        "elements", progs,
        tuple(_launch.flat_access(o, BLOCK) for o in ins),
        tuple(_launch.flat_access(o, BLOCK) for o in outs))
    fn = "_swiglu_fwd_kernel" if name == "swiglu_fwd" \
        else "_swiglu_bwd_kernel"
    return _launch.triton_spec(
        name, _TRITON_SOURCE, dt, (phase,), ins, outs,
        ((fn, len(ins) + len(outs) + 1, (progs,), {"BLOCK": BLOCK}, 4),))


def swiglu_fwd_triton(gate, up):
    """Launch ``swiglu_fwd``: :func:`swiglu_fwd_ref` on CUDA tensors of one
    shape. Raises for anything else; never falls back."""
    _check_elementwise("swiglu_fwd_triton", gate, up)
    g, u = gate.contiguous(), up.contiguous()
    out = torch.empty_like(g)
    n = g.numel()
    if n:
        spec = swiglu_spec("swiglu_fwd", n, _launch.dtype_name(g.dtype))
        if _launch.begin(spec, g.device, (g, u), (out,)):
            with torch.cuda.device(g.device):
                swiglu_fwd_triton.launches += 1
                _launch.triton_run(globals(), spec, [(g, u, out, n)])
    return out


def swiglu_bwd_triton(gate, up, d):
    """Launch ``swiglu_bwd``: ``(dg, du)`` as :func:`swiglu_bwd_ref`."""
    _check_elementwise("swiglu_bwd_triton", gate, up, d)
    g, u, dd = gate.contiguous(), up.contiguous(), d.contiguous()
    dg, du = torch.empty_like(g), torch.empty_like(u)
    n = g.numel()
    if n:
        spec = swiglu_spec("swiglu_bwd", n, _launch.dtype_name(g.dtype))
        if _launch.begin(spec, g.device, (g, u, dd), (dg, du)):
            with torch.cuda.device(g.device):
                swiglu_bwd_triton.launches += 1
                _launch.triton_run(globals(), spec, [(g, u, dd, dg, du, n)])
    return dg, du


class SwiGLU(torch.autograd.Function):
    """``silu(gate) * up`` with the JAX package's ``_swiglu_vjp``: saves g
    and u; the backward is one ``swiglu_bwd`` pass (kernels on CUDA, the
    plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        if gate.device.type == "cpu":
            return swiglu_fwd_ref(gate, up)
        return swiglu_fwd_triton(gate, up)

    @staticmethod
    def backward(ctx, d):
        gate, up = ctx.saved_tensors
        if gate.device.type == "cpu":
            return swiglu_bwd_ref(gate, up, d)
        return swiglu_bwd_triton(gate, up, d)


# ---------------------------------------------------------------------------
# lm-head + cross entropy
# ---------------------------------------------------------------------------
def _logits(x2, head):
    """f32 logits [T, V] (f32 products of the exact bf16 values)."""
    return x2.float() @ head.float()


def _onehot(lab, V):
    return lab[:, None] == torch.arange(V, device=lab.device)


def ce_fwd_ref(x2, head, labels):
    """``(lse, pick)`` [T] f32: the log-sum-exp of each row of ``x2 @
    head`` and the logit at its label (0 for a negative or out-of-range
    label, as the kernel's column match gives)."""
    s = _logits(x2, head)
    return (torch.logsumexp(s, -1),
            torch.where(_onehot(labels, s.shape[1]), s, 0.0).sum(-1))


def ce_vtiles(V):
    """The bf16 forward's vocab tiles: V in tiles of ``GEMM_BN`` columns
    (the last one partial)."""
    return -(-V // GEMM_BN)


def ce_fwd_stats_ref(x2, head, labels):
    """The bf16 forward's partials, plainly: ``part`` [3, ce_vtiles(V), T]
    f32 holding, for each vocab tile of ``GEMM_BN`` columns and each token,
    m = the max of the row's logits in the tile (columns past V do not
    count), l = the sum of exp(s - m) over them, and pick = the logit at
    the label when the label falls in the tile, else 0."""
    s = _logits(x2, head)
    T, V = s.shape
    nvt = ce_vtiles(V)
    pad = nvt * GEMM_BN - V
    tiles = torch.nn.functional.pad(s, (0, pad), value=-torch.inf).view(
        T, nvt, GEMM_BN)
    m = tiles.amax(-1)
    l = torch.exp(tiles - m[..., None]).sum(-1)
    pick = torch.nn.functional.pad(
        torch.where(_onehot(labels, V), s, 0.0), (0, pad)).view(
        T, nvt, GEMM_BN).sum(-1)
    return torch.stack([m, l, pick]).transpose(1, 2).contiguous()


def ce_fwd_combine_ref(part):
    """``(lse, pick)`` [T] from :func:`ce_fwd_stats_ref`'s partials in the
    combine kernel's order: M = the max of a token's m; strand k of
    ``COMBINE_STRANDS`` sums l exp(m - M) and pick over the vocab tiles k,
    k + strands, ... in tile order; the strands add in strand order;
    lse = M + log(L)."""
    m, l, pick = part[0], part[1], part[2]
    M = m.amax(0)
    w = l * torch.exp(m - M)
    L, P = torch.zeros_like(M), torch.zeros_like(M)
    for k in range(COMBINE_STRANDS):
        lk, pk = torch.zeros_like(M), torch.zeros_like(M)
        for v in range(k, m.shape[0], COMBINE_STRANDS):
            lk = lk + w[v]
            pk = pk + pick[v]
        L, P = L + lk, P + pk
    return M + torch.log(L), P


def _ce_p(x2, head, labels, lse, coef):
    """``_ce_tile``'s P, dense: (softmax - onehot) * valid * coef."""
    s = _logits(x2, head)
    valid = (labels >= 0).float()[:, None]
    return (torch.exp(s - lse[:, None]) - _onehot(labels, s.shape[1]).float()
            ) * (valid * coef.reshape(()))


def ce_bwd_dx_ref(x2, head, labels, lse, coef):
    """``dx = P head^T`` in x's type."""
    return (_ce_p(x2, head, labels, lse, coef) @ head.float().T).to(x2.dtype)


def ce_bwd_dh_ref(x2, head, labels, lse, coef):
    """``dh = x^T P`` in the head's type."""
    return (x2.float().T @ _ce_p(x2, head, labels, lse, coef)).to(head.dtype)


def p_width(V):
    """P's columns: V rounded up to ``P_ALIGN``."""
    return -(-V // P_ALIGN) * P_ALIGN


def ce_p_split_ref(x2, head, labels, lse, coef):
    """The P pass's output, plainly: ``(hi, lo)``, hi = bf16(P), lo =
    bf16(P - hi), [T, Vp] with zeros past V; for f32 inputs ``(P, None)``,
    P f32 [T, Vp]."""
    p = _ce_p(x2, head, labels, lse, coef)
    p = torch.nn.functional.pad(p, (0, p_width(p.shape[1]) - p.shape[1]))
    if x2.dtype != torch.bfloat16:
        return p, None
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.float()).to(torch.bfloat16)


def _p_value(p0, p1, V):
    """The first V columns of P as the products read it: hi + lo in f32."""
    return (p0.float() if p1 is None else p0.float() + p1.float())[:, :V]


def ce_bwd_dx_split_ref(p0, p1, head, dtype):
    """dx from the P pass's output as the kernel sums it: ``hi head^T +
    lo head^T`` in f32, cast to ``dtype``."""
    return (_p_value(p0, p1, head.shape[1]) @ head.float().T).to(dtype)


def ce_bwd_dh_split_ref(x2, p0, p1, V, dtype, chunk_rows=None):
    """dh from the P pass's output: ``x^T hi + x^T lo`` over chunks of
    ``chunk_rows`` rows (all of T by default), the chunks' f32 sums added
    in chunk order, cast to ``dtype`` once."""
    T = x2.shape[0]
    step = T if chunk_rows is None else chunk_rows
    acc = None
    for r0 in range(0, T, step):
        part = x2[r0:r0 + step].float().T @ _p_value(
            p0[r0:r0 + step], None if p1 is None else p1[r0:r0 + step], V)
        acc = part if acc is None else acc + part
    return acc.to(dtype)


def ce_splits(T, V, blocks):
    """``(tiles_per_split, splits)``: the vocab tiles cut into ``splits``
    runs so that at most ``blocks`` blocks of 64 tokens run (whole waves
    of the card: two blocks per SM), at least one split; no split is
    empty."""
    nt, nvt = -(-T // BT), -(-V // BV)
    want = min(nvt, max(1, blocks // nt))
    tps = -(-nvt // want)
    return tps, -(-nvt // tps)


def ce_chunk_rows(T, V, chunk_rows=None):
    """Rows of P one backward chunk holds: all of T while ``T Vp 4 <=
    P_CAP_BYTES`` (the training shape's 524 MB is one chunk), else the most
    multiple of ``GEMM_BM`` that fits; a given ``chunk_rows`` (a multiple
    of ``GEMM_BM``) forces the size."""
    if chunk_rows is None:
        fit = P_CAP_BYTES // (p_width(V) * 4)
        chunk_rows = T if T <= fit else max(GEMM_BM, fit // GEMM_BM * GEMM_BM)
    elif chunk_rows < 1 or (chunk_rows < T and chunk_rows % GEMM_BM):
        raise ValueError(f"chunk_rows {chunk_rows}: a multiple of {GEMM_BM}")
    return min(T, chunk_rows)


def _chunks(T, rows):
    """``[(r0, n), ...]``: the token chunks in order."""
    return [(r0, min(rows, T - r0)) for r0 in range(0, T, rows)]


def _grouped(i, nm, nn, gm):
    """Tile (m, n) of block ``i`` in the kernels' grouped order: ``gm``
    tile rows walk the tile columns together (numpy-friendly)."""
    gm = min(gm, nm)
    g = i // (gm * nn)
    first = g * gm
    size = np.minimum(nm - first, gm)
    j = i - g * gm * nn
    return first + j % size, j // size


def _tile_order(bf, nm, nn, gm):
    """Block index -> output tile (m, n): the bf16 kernels' grouped order,
    the f32 kernels' grid (blockIdx.x over the tile columns)."""
    if bf:
        return lambda i: _grouped(i, nm, nn, gm)
    return lambda i: (i // nn, i % nn)


@functools.lru_cache(maxsize=64)
def ce_spec(name, T, D, V, dt, head_dt, splits=1, head_kmajor=False,
            chunk_rows=None, p_given=False, staged=(), dh_vmajor=False):
    """The launch spec of one linear-CE wrapper call.

    - ``linear_ce_fwd``, bf16: one block per 128 x 256 tile of S (x's rows,
      the head's columns), the tiles in the grouped order (every tile row
      walks the tile columns together), each block writing its rows' stats
      to the partials (``plan["part"]``: [3, vocab tiles, T] f32, a
      workspace), then the combine (a block per 32 tokens) into lse and
      pick. f32: one block of 256 threads per (64-token tile, vocab split
      of ``splits``), then the combine of the split partials (one thread a
      token).
    - ``linear_ce_bwd_dx``: per token chunk (last to first), the P pass
      (a 128 x 256 tile of P a block: x's rows, the head's columns; hi and
      lo out) and the dx product (a 128 x 256 tile of dx a block: P's
      rows, the head's rows). P's workspace (``p_hi``, ``p_lo``; f32
      ``p``) is an output: after the call it holds the first chunk.
    - ``linear_ce_bwd_dh``: per chunk (first to last) the dh product (a
      128 x 256 tile of dh, or of dh^T for a head laid out as the tied
      embedding, a block: x's and P's columns over the chunk's rows), each
      chunk's P from the given workspace (``p_given``: an input, holding
      the first chunk) or from a P pass of its own; several chunks add
      into an f32 sum ``dh_sum`` in chunk order.

    ``head_kmajor``: the head is read in the tied layout (the embedding
    [V, D]); ``dh_vmajor``: dh is written as the embedding's gradient
    [V, D] seen transposed; ``staged``: operands copied to 16-byte
    aligned rows first."""
    op = _launch.KernelOperand
    A, whole = _launch.Access, _launch.whole
    x, head = op("x", (T, D), dt), op("head", (D, V), head_dt)
    labels = op("labels", (T,), "int64")
    lse, coef = op("lse", (T,), "float32"), op("coef", (1,), "float32")
    if name == "linear_ce_fwd":
        outs = (op("lse_out", (T,), "float32"), op("pick", (T,), "float32"))
        params = {"head_layout": "tied" if head_kmajor else "untied",
                  "staged": tuple(staged)}
        calls = ((name, CE_CALLS[name]),)
        if dt == "bfloat16":
            nm, nn = -(-T // GEMM_BM), ce_vtiles(V)
            mn = _tile_order(True, nm, nn, nm)
            main = _launch.KernelPhase(
                "tiles", nm * nn,
                (A("x", (GEMM_BM, D), lambda i: (mn(i)[0], 0)),
                 A("labels", (GEMM_BM,), lambda i: (mn(i)[0],)),
                 A("head", (D, GEMM_BN), lambda i: (0, mn(i)[1]))))
            comb = _launch.KernelPhase(
                "combine", -(-T // COMBINE_TOKENS), (),
                tuple(A(o.name, (COMBINE_TOKENS,), lambda i: (i,))
                      for o in outs))
            return _launch.KernelLaunchSpec(
                name, "cuda", _CE_SOURCE, (nm * nn,), GEMM_THREADS,
                (x, head, labels), outs, (main, comb), calls, dt,
                blocks_per_sm=1, dyn_smem=CE_P_SMEM, params=params,
                plan={"body": "wgmma", "tile": (GEMM_BM, GEMM_BN),
                      "tiles_per_split": 1, "splits": nn,
                      "depth_step": GEMM_BK, "stages": CE_STAGES["p"],
                      "group_m": nm, "smem": CE_P_SMEM, "part": (3, nn, T),
                      "part_bytes": 3 * nn * T * 4,
                      "combine": (COMBINE_TOKENS, COMBINE_STRANDS)})
        nt, nvt = -(-T // BT), -(-V // BV)
        tps = -(-nvt // splits)
        main = _launch.KernelPhase(
            "token_tiles", nt * splits,
            (A("x", (BT, D), lambda i: (i % nt, 0)),
             A("labels", (BT,), lambda i: (i % nt,)),
             A("head", (D, tps * BV), lambda i: (0, i // nt))))
        n_comb = -(-T // _CE_THREADS)
        comb = _launch.KernelPhase(
            "combine", n_comb, (),
            tuple(A(o.name, (_CE_THREADS,), lambda i: (i,)) for o in outs))
        return _launch.KernelLaunchSpec(
            name, "cuda", _CE_SOURCE, (nt, splits), _CE_THREADS,
            (x, head, labels), outs, (main, comb), calls, dt,
            blocks_per_sm=2, static_smem=CE_FWD_SMEM, params=params,
            plan={"body": "cuda_core", "tile": (BT, BV),
                  "tiles_per_split": tps, "splits": splits, "smem": 0,
                  "part": (3, splits, T), "part_bytes": 3 * splits * T * 4})
    bf = dt == "bfloat16"
    vp = p_width(V)
    rows = ce_chunk_rows(T, V, chunk_rows)
    chunks = _chunks(T, rows)
    pdt = "bfloat16" if bf else "float32"
    p_names = ("p_hi", "p_lo") if bf else ("p",)
    vmajor = dh_vmajor and name == "linear_ce_bwd_dh"
    if bf:
        bm, bn = GEMM_BM, GEMM_BN
        threads, per_sm, static = GEMM_THREADS, 1, 0
        smem_p = CE_P_SMEM
        smem_g = CE_PAIR_A_SMEM if name == "linear_ce_bwd_dx" or vmajor \
            else CE_PAIR_B_SMEM
    else:
        bm, bn = BT, BV
        threads, per_sm, static = _CE_THREADS, 2, CE_F32_SMEM
        smem_p = smem_g = 0

    def tiles(M, N):
        return -(-M // bm), -(-N // bn)

    def p_pass(c, r0, n, names, skip=0):
        # skip: rows of labels and lse before the operands' first (the
        # chunk whose P the dh call is given)
        nm, nn = tiles(n, vp)
        t0 = r0 // bm
        f = (lambda i: ((r0 - skip) // bm + i % nm,))
        reads = (A("x", (bm, D), lambda i: (t0 + i % nm, 0)),
                 A("labels", (bm,), f), A("lse", (bm,), f), whole(coef),
                 A("head", (D, bn), lambda i: (0, i // nm)))
        writes = tuple(A(p, (bm, bn), lambda i: (i % nm, i // nm))
                       for p in names)
        return _launch.KernelPhase(f"p_pass[{c}]", nm * nn, reads, writes)

    phases, calls = [], []
    ins = [x]
    if name == "linear_ce_bwd_dx":
        ins += [head, labels, lse, coef]
        outs = [op("dx", (T, D), dt)] + [op(p, (rows, vp), pdt)
                                         for p in p_names]
        gm = 8 if bf else 1
        for c, (r0, n) in reversed(list(enumerate(chunks))):
            phases.append(p_pass(c, r0, n, p_names))
            nm, nn = tiles(n, D)
            t0 = r0 // bm
            mn = _tile_order(bf, nm, nn, gm)
            phases.append(_launch.KernelPhase(
                f"dx[{c}]", nm * nn,
                tuple(A(p, (bm, vp), lambda i, mn=mn: (mn(i)[0], 0))
                      for p in p_names)
                + (A("head", (bn, V), lambda i, mn=mn: (mn(i)[1], 0)),),
                (A("dx", (bm, bn),
                   lambda i, mn=mn, t0=t0: (t0 + mn(i)[0], mn(i)[1])),)))
        calls = [("linear_ce_p", CE_CALLS["linear_ce_p"]),
                 ("linear_ce_bwd_dx", CE_CALLS["linear_ce_bwd_dx"])]
        accum = tuple(p_names) if len(chunks) > 1 else ()
    else:
        own = [f"{p}_chunks" for p in p_names] if p_given else p_names
        if p_given:
            ins += [op(p, (rows, vp), pdt) for p in p_names]
        skip = rows if p_given else 0
        if not p_given or len(chunks) > 1:
            ins += [head, op("labels", (T - skip,), "int64"),
                    op("lse", (T - skip,), "float32"), coef]
        outs = [op("dh", (D, V), head_dt)]
        if not p_given or len(chunks) > 1:
            # given P, the later chunks' P passes overwrite the given
            # workspace in place: its rows they write (a short last
            # chunk writes fewer than the workspace holds)
            own_rows = max(n for _, n in chunks[1:]) if p_given else rows
            outs += [op(p, (own_rows, vp), pdt) for p in own]
        if len(chunks) > 1:
            outs.append(op("dh_sum", (D, V), "float32"))
        # M x N: dh [D, V], or dh^T [V, D] for the tied layout (bf16)
        dh_t = vmajor and bf
        M, N = (V, D) if dh_t else (D, V)
        nm, nn = tiles(M, N)
        gm = (8 if vmajor else 32) if bf else 1
        for c, (r0, n) in enumerate(chunks):
            src = p_names if p_given and c == 0 else own
            if not (p_given and c == 0):
                phases.append(p_pass(c, r0, n, own, skip))
            mn = _tile_order(bf, nm, nn, gm)
            if not dh_t:      # dh = x^T P: tile (d, v)
                reads = (A("x", (rows, bm), lambda i, mn=mn, c=c:
                           (c, mn(i)[0])),) + tuple(
                    A(p, (rows, bn), lambda i, mn=mn: (0, mn(i)[1]))
                    for p in src)
                dmap = (lambda i, mn=mn: mn(i))
                dtile = (bm, bn)
            else:             # dh^T = P^T x: tile (v, d)
                reads = tuple(A(p, (rows, bm), lambda i, mn=mn: (0, mn(i)[0]))
                              for p in src) + (
                    A("x", (rows, bn), lambda i, mn=mn, c=c: (c, mn(i)[1])),)
                dmap = (lambda i, mn=mn: (mn(i)[1], mn(i)[0]))
                dtile = (bn, bm)
            writes = (A("dh", dtile, dmap),)
            if len(chunks) > 1:
                writes += (A("dh_sum", dtile, dmap),)
            phases.append(_launch.KernelPhase(f"dh[{c}]", nm * nn, reads,
                                              writes))
        if not p_given or len(chunks) > 1:
            calls.append(("linear_ce_p", CE_CALLS["linear_ce_p"]))
        calls.append(("linear_ce_bwd_dh", CE_CALLS["linear_ce_bwd_dh"]))
        p_passes = len(chunks) - (1 if p_given else 0)
        accum = (("dh", "dh_sum") if len(chunks) > 1 else ()) + (
            tuple(own) if p_passes > 1 else ())
    nm, nn = tiles(min(rows, T), vp)
    return _launch.KernelLaunchSpec(
        name, "cuda", _CE_SOURCE, (nm * nn,), threads, tuple(ins),
        tuple(outs), tuple(phases), tuple(calls), dt, blocks_per_sm=per_sm,
        dyn_smem=max(smem_p, smem_g), static_smem=static,
        accum_outputs=accum,
        params={"head_layout": "tied" if head_kmajor else "untied",
                "p_given": p_given, "staged": tuple(staged)},
        plan={"body": "wgmma" if bf else "cuda_core", "tile": (bm, bn),
              "depth_step": (GEMM_BK_DH if smem_g == CE_PAIR_B_SMEM
                             else GEMM_BK) if bf else F32_BK, "vp": vp,
              "stages": (CE_STAGES["p"], CE_STAGES[
                  "pair_a" if smem_g == CE_PAIR_A_SMEM else "pair_b"])
              if bf else None,
              "chunk_rows": rows, "chunks": len(chunks),
              "p_smem": smem_p, "gemm_smem": smem_g,
              "dh_layout": ("vd" if vmajor else "dv")
              if name == "linear_ce_bwd_dh" else None})


def _check_ce(name, x2, head, labels, *stats):
    _launch.check_device(name, x2.device)
    if x2.dtype not in DTYPES:
        raise TypeError(f"{name} takes float32 and bfloat16, got {x2.dtype}")
    if x2.dim() != 2 or head.dim() != 2 or head.shape[0] != x2.shape[1]:
        raise ValueError(f"{name}: x [T, D] and head [D, V], got "
                         f"{tuple(x2.shape)} and {tuple(head.shape)}")
    T, D = x2.shape
    if min(T, D, head.shape[1]) < 1:
        raise ValueError(f"{name}: T, D and V must be >= 1, got "
                         f"{(T, D, head.shape[1])}")
    if head.dtype != x2.dtype or head.device != x2.device:
        raise ValueError(f"{name}: head {head.dtype} on {head.device}, x "
                         f"{x2.dtype} on {x2.device}")
    if not x2.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if labels.dtype != torch.int64 or tuple(labels.shape) != (T,) \
            or labels.device != x2.device or not labels.is_contiguous():
        raise ValueError(f"{name}: labels must be contiguous int64 [{T}] on "
                         f"{x2.device}, got {tuple(labels.shape)} "
                         f"{labels.dtype}")
    for t in stats:
        if t.dtype != torch.float32 or t.device != x2.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: lse and coef must be contiguous "
                             "float32 on x's device")


def _run(name, x2, spec, *args):
    """One C launcher of ``spec`` (by name) on x's current stream; raises
    with the card's error string."""
    fn = _build.c_fn("linear_ce", name, dict(spec.calls)[name])
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = fn(*args, DTYPES[x2.dtype], stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + fn.error_string(err).decode())


def linear_ce_fwd_cuda(x2, head, labels):
    """Launch ``linear_ce_fwd``: ``(lse, pick)`` as :func:`ce_fwd_ref`.
    ``x2`` [T, D] contiguous, ``head`` [D, V] of x's type with any
    strides (read through :func:`ce_operands`), ``labels`` int64 [T]."""
    _check_ce("linear_ce_fwd", x2, head, labels)
    T, D = x2.shape
    V = head.shape[1]
    ops = ce_operands(x2, head)
    splits = ce_vtiles(V) if x2.dtype == torch.bfloat16 \
        else ce_splits(T, V, 4 * _SMS)[1]
    spec = ce_spec("linear_ce_fwd", T, D, V, _launch.dtype_name(x2.dtype),
                   _launch.dtype_name(head.dtype), splits, ops.head_kmajor,
                   staged=ops.staged)
    lse = torch.empty(T, dtype=torch.float32, device=x2.device)
    pick = torch.empty_like(lse)
    part = torch.empty(spec.plan["part"], dtype=torch.float32,
                       device=x2.device)
    if _launch.begin(spec, x2.device, (ops.x, ops.head, labels),
                     (lse, pick, part)):
        linear_ce_fwd_cuda.launches += 1
        bt, bv = spec.plan["tile"]
        _run("linear_ce_fwd", ops.x, spec, ops.x.data_ptr(), ops.sx,
             ops.head.data_ptr(), ops.sh, int(ops.head_kmajor),
             labels.data_ptr(), lse.data_ptr(), pick.data_ptr(),
             part.data_ptr(), T, D, V, bt, bv, spec.plan["tiles_per_split"],
             splits, spec.plan["smem"])
    return lse, pick


# -- the operands and the backward ----------------------------------------
@dataclasses.dataclass
class CEOperands:
    """x and the head as the CE kernels read them: row-major rows of
    ``sx`` / ``sh`` elements; ``head_kmajor`` the tied layout (the head's
    rows run along V); ``staged``: the operands copied first (bf16 rows
    TMA cannot read: a stride not a multiple of 16 bytes, a base not
    16-byte aligned, or a head in neither layout)."""
    x: torch.Tensor
    sx: int
    head: torch.Tensor
    sh: int
    head_kmajor: bool
    staged: Tuple[str, ...]
    D: int
    V: int


def _rows_ok(t, ld, bf):
    # a fake tensor (a program audit's trace) has no address: taken as
    # aligned, so the trace takes the route an aligned tensor gets
    return not bf or ((_launch.is_fake(t) or t.data_ptr() % 16 == 0)
                      and ld % 8 == 0)


def ce_operands(x2, head):
    """:class:`CEOperands` of ``x2`` [T, D] and ``head`` [D, V]: the
    tensors themselves where their rows are readable, else padded copies
    (rows rounded up to 8 elements, the pad never read)."""
    T, D = x2.shape
    V = head.shape[1]
    bf = x2.dtype == torch.bfloat16
    staged = []
    x, sx = x2, D
    if not _rows_ok(x2, D, bf):
        sx = -(-D // 8) * 8
        x = torch.empty(T, sx, dtype=x2.dtype, device=x2.device)
        x[:, :D].copy_(x2)
        staged.append("x")
    s0, s1 = head.stride()
    if s1 == 1 and _rows_ok(head, s0, bf):
        h, sh, kmajor = head, s0, False
    elif s0 == 1 and _rows_ok(head, s1, bf):
        h, sh, kmajor = head, s1, True
    else:
        sh = -(-V // 8) * 8 if bf else V
        h = torch.empty(D, sh, dtype=head.dtype, device=head.device)
        h[:, :V].copy_(head)
        kmajor = False
        staged.append("head")
    return CEOperands(x, sx, h, sh, kmajor, tuple(staged), D, V)


@dataclasses.dataclass
class CEWorkspace:
    """P of one token chunk, rows [r0, r0 + rows): bf16 ``hi`` and ``lo``
    [chunk rows, Vp], or f32 ``hi`` (= P) and ``lo`` None."""
    hi: torch.Tensor
    lo: Optional[torch.Tensor]
    r0: int
    rows: int

    def ptrs(self):
        hi = self.hi.data_ptr()
        return hi, hi if self.lo is None else self.lo.data_ptr()


def ce_workspace(x2, rows, V):
    """An empty :class:`CEWorkspace` of ``rows`` rows for x's type."""
    bf = x2.dtype == torch.bfloat16
    hi = torch.empty(rows, p_width(V), device=x2.device,
                     dtype=torch.bfloat16 if bf else torch.float32)
    return CEWorkspace(hi, torch.empty_like(hi) if bf else None, 0, 0)


def _smem(x2, pair):
    if x2.dtype != torch.bfloat16:
        return 0
    return {"p": CE_P_SMEM, "a": CE_PAIR_A_SMEM, "b": CE_PAIR_B_SMEM}[pair]


def ce_p_pass(spec, ops, labels, lse, coef, ws, r0, n):
    """The P pass over rows [r0, r0 + n) into ``ws`` (no count: the
    wrappers count their calls)."""
    p0, p1 = ws.ptrs()
    isz = ops.x.element_size()
    _run("linear_ce_p", ops.x, spec, ops.x.data_ptr() + r0 * ops.sx * isz,
         ops.sx, ops.head.data_ptr(), ops.sh, int(ops.head_kmajor),
         labels.data_ptr() + r0 * 8, lse.data_ptr() + r0 * 4,
         coef.data_ptr(), p0, p1, n, ops.D, ops.V, p_width(ops.V),
         _smem(ops.x, "p"))
    ws.r0, ws.rows = r0, n


def ce_dx_product(spec, ops, ws, dx):
    """dx's rows of ``ws``'s chunk from its P."""
    p0, p1 = ws.ptrs()
    _run("linear_ce_bwd_dx", ops.x, spec, p0, p1, ops.head.data_ptr(),
         ops.sh, int(ops.head_kmajor),
         dx.data_ptr() + ws.r0 * ops.D * dx.element_size(), ws.rows, ops.D,
         ops.V, p_width(ops.V), _smem(ops.x, "a"))


def ce_dh_product(spec, ops, ws, dh, work, mode):
    """dh (``mode`` 0) or its f32 sum across chunks (1 store, 2 add, 3 add
    and cast into dh) from ``ws``'s chunk."""
    p0, p1 = ws.ptrs()
    vmajor = _dh_vmajor(dh)
    isz = ops.x.element_size()
    _run("linear_ce_bwd_dh", ops.x, spec,
         ops.x.data_ptr() + ws.r0 * ops.sx * isz, ops.sx, p0, p1,
         dh.data_ptr(), dh.stride(1) if vmajor else dh.stride(0),
         int(vmajor), 0 if work is None else work.data_ptr(), mode, ws.rows,
         ops.D, ops.V, p_width(ops.V),
         _smem(ops.x, "a" if vmajor else "b"))


def _dh_out(head):
    """dh laid out as the head is when it is dense: the tied head's dh is
    the embedding's gradient [V, D] seen transposed."""
    D, V = head.shape
    if head.stride(0) == 1 and head.stride(1) == D:
        return torch.empty(V, D, dtype=head.dtype, device=head.device).T
    return torch.empty(D, V, dtype=head.dtype, device=head.device)


def _dh_vmajor(dh):
    D, V = dh.shape
    return dh.stride(0) == 1 and dh.stride(1) == D and V > 1


def linear_ce_bwd_dx_cuda(x2, head, labels, lse, coef, chunk_rows=None,
                          keep_p=False):
    """Launch ``linear_ce_bwd_dx``: dx [T, D] as :func:`ce_bwd_dx_ref`;
    ``coef`` one f32 on the card. Per token chunk (:func:`ce_chunk_rows`;
    ``chunk_rows`` forces it), last to first: the P pass, then dx's rows.
    ``keep_p``: return ``(dx, workspace)``, the workspace holding the first
    chunk's P for :func:`linear_ce_bwd_dh_cuda`."""
    _check_ce("linear_ce_bwd_dx", x2, head, labels, lse, coef)
    T, D = x2.shape
    V = head.shape[1]
    ops = ce_operands(x2, head)
    rows = ce_chunk_rows(T, V, chunk_rows)
    spec = ce_spec("linear_ce_bwd_dx", T, D, V,
                   _launch.dtype_name(x2.dtype),
                   _launch.dtype_name(head.dtype), 1, ops.head_kmajor, rows,
                   False, ops.staged)
    dx = torch.empty_like(x2)
    ws = ce_workspace(x2, rows, V)
    if _launch.begin(spec, x2.device, (ops.x, ops.head, labels, lse, coef),
                     (dx, ws.hi, ws.lo)):
        linear_ce_bwd_dx_cuda.launches += 1
        for r0, n in reversed(_chunks(T, rows)):
            ce_p_pass(spec, ops, labels, lse, coef, ws, r0, n)
            ce_dx_product(spec, ops, ws, dx)
    else:
        ws.rows = min(rows, T)
    return (dx, ws) if keep_p else dx


def linear_ce_bwd_dh_cuda(x2, head, labels, lse, coef, p=None,
                          chunk_rows=None):
    """Launch ``linear_ce_bwd_dh``: dh [D, V] as :func:`ce_bwd_dh_ref`,
    laid out as the head is when it is dense (the tied head's dh is the
    embedding's gradient seen transposed). ``p``: the workspace
    :func:`linear_ce_bwd_dx_cuda` kept for the same inputs (its first
    chunk is not recomputed; the call may overwrite it); without it each
    chunk's P pass runs here. Chunks run first to last; several add into
    an f32 sum in that order."""
    _check_ce("linear_ce_bwd_dh", x2, head, labels, lse, coef)
    T, D = x2.shape
    V = head.shape[1]
    ops = ce_operands(x2, head)
    rows = ce_chunk_rows(T, V, chunk_rows if p is None
                         else chunk_rows or p.hi.shape[0])
    if p is not None and (p.r0 != 0 or p.rows != min(rows, T)
                          or tuple(p.hi.shape) != (rows, p_width(V))):
        raise ValueError("linear_ce_bwd_dh: the workspace does not hold "
                         f"the first chunk of {rows} rows of this call")
    dh = _dh_out(head)
    chunks = _chunks(T, rows)
    spec = ce_spec("linear_ce_bwd_dh", T, D, V,
                   _launch.dtype_name(x2.dtype),
                   _launch.dtype_name(head.dtype), 1, ops.head_kmajor, rows,
                   p is not None, ops.staged, _dh_vmajor(dh))
    ws = p if p is not None else ce_workspace(x2, rows, V)
    work = None
    if len(chunks) > 1:
        work = torch.empty(D * V, dtype=torch.float32, device=x2.device)
    if _launch.begin(spec, x2.device, (ops.x, ops.head, labels, lse, coef)
                     + ((ws.hi, ws.lo) if p is not None else ()),
                     (dh, ws.hi, ws.lo, work)):
        linear_ce_bwd_dh_cuda.launches += 1
        for c, (r0, n) in enumerate(chunks):
            if not (p is not None and c == 0):
                ce_p_pass(spec, ops, labels, lse, coef, ws, r0, n)
            mode = 0 if len(chunks) == 1 else (
                1 if c == 0 else 3 if c == len(chunks) - 1 else 2)
            ce_dh_product(spec, ops, ws, dh, work, mode)
    return dh


for _w in (swiglu_fwd_triton, swiglu_bwd_triton, linear_ce_fwd_cuda,
           linear_ce_bwd_dx_cuda, linear_ce_bwd_dh_cuda):
    _launch.counted(_w)


class LinearCE(torch.autograd.Function):
    """The JAX package's ``_linear_ce_vjp`` with the flattening and the
    masked mean around it: ``hidden [..., D]``, ``head [D, V]``, ``labels
    [...]`` int -> the f32 mean over labels >= 0 of ``lse - pick``. The
    kernels on CUDA (the backward's P pass runs once: dx's call keeps P
    for dh's), the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, hidden, head, labels):
        D = hidden.shape[-1]
        x2 = hidden.reshape(-1, D).contiguous()
        lab = labels.reshape(-1).to(torch.int64).contiguous()
        if lab.shape[0] != x2.shape[0]:
            raise ValueError(f"{lab.shape[0]} labels for {x2.shape[0]} "
                             "tokens")
        fwd = ce_fwd_ref if x2.device.type == "cpu" else linear_ce_fwd_cuda
        lse, pick = fwd(x2, head, lab)
        valid = lab >= 0
        count = valid.sum().float()
        loss = torch.where(valid, lse - pick, 0.0).sum() \
            / torch.clamp(count, min=1.0)
        ctx.save_for_backward(x2, head, lab, lse, count)
        ctx.shape = hidden.shape
        return loss

    @staticmethod
    def backward(ctx, g):
        x2, head, lab, lse, count = ctx.saved_tensors
        coef = (g.float() / torch.clamp(count, min=1.0)).reshape(1)
        need_dx, need_dh = ctx.needs_input_grad[:2]
        dx = dh = p = None
        if x2.device.type == "cpu":
            if need_dx:
                dx = ce_bwd_dx_ref(x2, head, lab, lse, coef)
            if need_dh:
                dh = ce_bwd_dh_ref(x2, head, lab, lse, coef)
        else:
            if need_dx:
                dx = linear_ce_bwd_dx_cuda(x2, head, lab, lse, coef,
                                           keep_p=need_dh)
                if need_dh:
                    dx, p = dx
            if need_dh:
                dh = linear_ce_bwd_dh_cuda(x2, head, lab, lse, coef, p=p)
        return None if dx is None else dx.reshape(ctx.shape), dh, None
