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
them (operations: 1.07 / 2.15 / 2.15 TFLOP at the training shape), how
their f32 accumulators live in device memory, and where they round. Each
wrapper call is two device kernels (the main one and a fixed-order
combine or cast), counted once. The plain versions :func:`ce_fwd_ref`,
:func:`ce_bwd_dx_ref` and :func:`ce_bwd_dh_ref` compute the same
functions densely in f32. :class:`LinearCE` does what the JAX package does
outside its kernels: flatten to [T, D], count the labels >= 0 (negative
labels, -1 and -100 alike, are ignored), the masked mean of ``lse -
pick`` over ``max(count, 1)``, and ``coef = g / max(count, 1)``. Labels
are taken as int64 (int32 widens; nothing narrows). The head is read by
its strides, so the tied head (the embedding seen transposed) is not
copied, and dh is written in the head's layout.

The Functions run the kernels for CUDA tensors and the plain versions for
CPU ones; a wrapper given anything else raises, never falls back.
Triton is imported, and the CUDA library built, at the first launch,
never at import.
"""
from __future__ import annotations

import functools

import torch

from . import _build, _launch
from ._build import DTYPES

__all__ = ["swiglu_fwd_ref", "swiglu_bwd_ref", "swiglu_fwd_triton",
           "swiglu_bwd_triton", "SwiGLU", "ce_fwd_ref", "ce_bwd_dx_ref",
           "ce_bwd_dh_ref", "linear_ce_fwd_cuda", "linear_ce_bwd_dx_cuda",
           "linear_ce_bwd_dh_cuda", "LinearCE", "ce_splits", "BT", "BV"]

BLOCK = 1024
#: the linear-CE kernels' logit tile (``kBT`` x ``kBV`` in linear_ce.cu;
#: the launchers refuse another)
BT, BV = 64, 128
_SMS = _launch.H100_SMS
_TRITON_SOURCE = "paddle_tpu_torch/ops/kernels/fused_train.py"
_CE_SOURCE = "paddle_tpu_torch/csrc/linear_ce.cu"
_CE_THREADS = 256
#: shared memory of the CE kernels (linear_ce.cu): the forward's static
#: tile (kFwdSmem), the dx and dh kernels' dynamic ones (kDxSmem, kDhSmem,
#: which their launchers hold these figures to)
CE_FWD_SMEM, CE_DX_SMEM, CE_DH_SMEM = 33792, 105216, 108032
#: the launchers' ctypes argument codes
CE_CALLS = {
    "linear_ce_fwd": ("p", "p", "l", "l") + ("p",) * 4 + ("i",) * 7
    + ("i", "p"),
    "linear_ce_bwd_dx": ("p", "p", "l", "l") + ("p",) * 5 + ("i",) * 8
    + ("i", "p"),
    "linear_ce_bwd_dh": ("p", "p", "l", "l") + ("p",) * 4 + ("l", "l", "p")
    + ("i",) * 5 + ("i", "p")}
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
        if _launch.begin(spec, g.device):
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
        if _launch.begin(spec, g.device):
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


def ce_splits(T, V, blocks):
    """``(tiles_per_split, splits)``: the vocab tiles cut into ``splits``
    runs so that at most ``blocks`` blocks of 64 tokens run (whole waves
    of the card: two blocks per SM), at least one split; no split is
    empty."""
    nt, nvt = -(-T // BT), -(-V // BV)
    want = min(nvt, max(1, blocks // nt))
    tps = -(-nvt // want)
    return tps, -(-nvt // tps)


@functools.lru_cache(maxsize=64)
def ce_spec(name, T, D, V, dt, head_dt, splits):
    """The launch spec of one linear-CE wrapper call: its main kernel
    (forward and dx: one block of 256 threads per (64-token tile, vocab
    split), reading the tile's rows of x and labels and the split's
    columns of the head; dh: one block per 128-column vocab tile, reading
    all of x) and its second kernel (the forward's combine of the split
    partials into lse and pick, one thread a token; dx's and dh's
    fixed-order cast of the f32 accumulators into the output)."""
    op = _launch.KernelOperand
    A, whole = _launch.Access, _launch.whole
    nt, nvt = -(-T // BT), -(-V // BV)
    x, head = op("x", (T, D), dt), op("head", (D, V), head_dt)
    labels = op("labels", (T,), "int64")
    stats = (op("lse", (T,), "float32"), op("coef", (1,), "float32"))
    if name == "linear_ce_bwd_dh":
        ins = (x, head, labels) + stats
        outs = (op("dh", (D, V), head_dt),)
        grid, smem = (nvt,), CE_DH_SMEM
        main = _launch.KernelPhase(
            "vocab_tiles", nvt,
            (A("head", (D, BV), lambda i: (0, i)), whole(x), whole(labels),
             whole(stats[0]), whole(stats[1])))
        plan = {"bv": BV, "smem": smem}
    else:
        tps = -(-nvt // splits)
        grid = (nt, splits)
        reads = (A("x", (BT, D), lambda i: (i % nt, 0)),
                 A("labels", (BT,), lambda i: (i % nt,)),
                 A("head", (D, tps * BV), lambda i: (0, i // nt)))
        if name == "linear_ce_fwd":
            ins = (x, head, labels)
            outs = (op("lse_out", (T,), "float32"),
                    op("pick", (T,), "float32"))
            smem = 0
        else:
            ins = (x, head, labels) + stats
            outs = (op("dx", (T, D), dt),)
            reads += (A("lse", (BT,), lambda i: (i % nt,)),
                      whole(stats[1]))
            smem = CE_DX_SMEM
        main = _launch.KernelPhase("token_tiles", nt * splits, reads)
        plan = {"bt": BT, "bv": BV, "tiles_per_split": tps,
                "splits": splits, "smem": smem}
    if name == "linear_ce_fwd":
        n_comb = -(-T // _CE_THREADS)
        second = _launch.KernelPhase(
            "combine", n_comb, (),
            tuple(A(o.name, (_CE_THREADS,), lambda i: (i,)) for o in outs))
    else:
        second = _launch.KernelPhase("cast", 1, (), (whole(outs[0]),))
    return _launch.KernelLaunchSpec(
        name, "cuda", _CE_SOURCE, grid, _CE_THREADS, ins, outs,
        (main, second), ((name, CE_CALLS[name]),), dt, blocks_per_sm=2,
        dyn_smem=smem, static_smem=CE_FWD_SMEM if name == "linear_ce_fwd"
        else 0, plan=plan)


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


def _run(name, wrapper, x2, spec, *args):
    if not _launch.begin(spec, x2.device):
        return
    fn = _build.c_fn("linear_ce", *spec.calls[0])
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        wrapper.launches += 1
        err = fn(*args, DTYPES[x2.dtype], stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + fn.error_string(err).decode())


def _head_args(head):
    return head.data_ptr(), head.stride(0), head.stride(1)


def linear_ce_fwd_cuda(x2, head, labels):
    """Launch ``linear_ce_fwd``: ``(lse, pick)`` as :func:`ce_fwd_ref`.
    ``x2`` [T, D] contiguous, ``head`` [D, V] of x's type with any
    strides, ``labels`` int64 [T]."""
    _check_ce("linear_ce_fwd", x2, head, labels)
    T, D = x2.shape
    V = head.shape[1]
    tps, splits = ce_splits(T, V, 4 * _SMS)
    spec = ce_spec("linear_ce_fwd", T, D, V, _launch.dtype_name(x2.dtype),
                   _launch.dtype_name(head.dtype), splits)
    lse = torch.empty(T, dtype=torch.float32, device=x2.device)
    pick = torch.empty_like(lse)
    part = torch.empty(3, splits, T, dtype=torch.float32, device=x2.device)
    _run("linear_ce_fwd", linear_ce_fwd_cuda, x2, spec, x2.data_ptr(),
         *_head_args(head), labels.data_ptr(), lse.data_ptr(),
         pick.data_ptr(), part.data_ptr(), T, D, V, tps, BT, BV, splits)
    return lse, pick


def linear_ce_bwd_dx_cuda(x2, head, labels, lse, coef):
    """Launch ``linear_ce_bwd_dx``: dx [T, D] as :func:`ce_bwd_dx_ref`;
    ``coef`` one f32 on the card."""
    _check_ce("linear_ce_bwd_dx", x2, head, labels, lse, coef)
    T, D = x2.shape
    V = head.shape[1]
    tps, splits = ce_splits(T, V, 2 * _SMS)
    spec = ce_spec("linear_ce_bwd_dx", T, D, V,
                   _launch.dtype_name(x2.dtype),
                   _launch.dtype_name(head.dtype), splits)
    dx = torch.empty_like(x2)
    part = torch.empty(splits, T, D, dtype=torch.float32, device=x2.device)
    _run("linear_ce_bwd_dx", linear_ce_bwd_dx_cuda, x2, spec, x2.data_ptr(),
         *_head_args(head), labels.data_ptr(), lse.data_ptr(),
         coef.data_ptr(), dx.data_ptr(), part.data_ptr(), T, D, V, tps, BT,
         BV, splits, CE_DX_SMEM)
    return dx


def linear_ce_bwd_dh_cuda(x2, head, labels, lse, coef):
    """Launch ``linear_ce_bwd_dh``: dh [D, V] as :func:`ce_bwd_dh_ref`,
    laid out as the head is when it is dense (the tied head's dh is the
    embedding's gradient seen transposed)."""
    _check_ce("linear_ce_bwd_dh", x2, head, labels, lse, coef)
    T, D = x2.shape
    V = head.shape[1]
    if head.stride(0) == 1 and head.stride(1) == D:
        dh = torch.empty(V, D, dtype=head.dtype, device=head.device).T
    else:
        dh = torch.empty(D, V, dtype=head.dtype, device=head.device)
    accum = torch.empty(D, V, dtype=torch.float32, device=x2.device)
    spec = ce_spec("linear_ce_bwd_dh", T, D, V,
                   _launch.dtype_name(x2.dtype),
                   _launch.dtype_name(head.dtype), 1)
    _run("linear_ce_bwd_dh", linear_ce_bwd_dh_cuda, x2, spec, x2.data_ptr(),
         *_head_args(head), labels.data_ptr(), lse.data_ptr(),
         coef.data_ptr(), dh.data_ptr(), dh.stride(0), dh.stride(1),
         accum.data_ptr(), T, D, V, BV, CE_DH_SMEM)
    return dh


for _w in (swiglu_fwd_triton, swiglu_bwd_triton, linear_ce_fwd_cuda,
           linear_ce_bwd_dx_cuda, linear_ce_bwd_dh_cuda):
    _w.launches = 0


class LinearCE(torch.autograd.Function):
    """The JAX package's ``_linear_ce_vjp`` with the flattening and the
    masked mean around it: ``hidden [..., D]``, ``head [D, V]``, ``labels
    [...]`` int -> the f32 mean over labels >= 0 of ``lse - pick``. The
    kernels on CUDA, the plain versions on the CPU."""

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
        cpu = x2.device.type == "cpu"
        dx = dh = None
        if ctx.needs_input_grad[0]:
            dx = (ce_bwd_dx_ref if cpu else linear_ce_bwd_dx_cuda)(
                x2, head, lab, lse, coef).reshape(ctx.shape)
        if ctx.needs_input_grad[1]:
            dh = (ce_bwd_dh_ref if cpu else linear_ce_bwd_dh_cuda)(
                x2, head, lab, lse, coef)
        return dx, dh, None
