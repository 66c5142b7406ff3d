"""RMSNorm and LayerNorm: the four Triton kernels' wrappers (RMSNorm's
forward, backward, and residual add + forward; LayerNorm's forward),
their plain PyTorch versions, and the differentiable ops the training
path runs.

Replaces four kernels of ``paddle_tpu/ops/pallas/norms.py``:

- ``_rms_fwd_kernel`` (launch ``rms_norm_fwd``, reached through
  ``rms_norm_pallas``) by :func:`rms_norm_fwd_triton`: each row of ``x
  [..., D]`` is scaled by the reciprocal root of its mean square,
  computed in f32, cast to x's type, then multiplied by the weight
  (already in x's type at every call site) -- the rounding order of
  :func:`rms_norm_ref`, so kernel and plain version agree to one ulp of
  x's type. Bound on the H100: memory, ``rows * D * itemsize * 2``
  bytes. One program per row with ``BLOCK = next_pow2(D)``: a 4096-wide
  row is one block held in registers, read once and written once.
- ``_rms_bwd_kernel`` (launch ``rms_norm_bwd``, ``rms_norm_bwd_pallas``)
  by :func:`rms_norm_bwd_triton`: ``dx`` per row and ``dw = sum over rows
  of g * x_hat`` (f32, cast once to the weight's type), dx op for op
  :func:`rms_bwd_ref`. Bound: memory, x and g read and dx written once
  (100.7 MB at [4096, 4096] bf16, 0.030 ms). The TPU carries dw through
  a sequential grid in VMEM; Hopper's blocks run in no order, so each of
  ``P <= 264`` programs (two per SM) walks rows ``pid, pid + P, ...``,
  keeps its dw partial in registers and writes it to a ``[P, D]`` f32
  buffer (:func:`rms_bwd_partition`). What bounds a row is memory
  latency: a program's two row reductions depend on its loads, so a
  program that loads a row only when the last is done keeps one row in
  flight and the SM's memory pipe idles through the reductions. Each
  program therefore issues the next row's loads before it reduces the
  current one (two rows of x and g in flight a program, four an SM).
  The second kernel sums the partials over the whole card: a program
  per ``_SUM_COLS`` columns adds chunks of ``_SUM_ROWS`` partial rows in
  chunk order, each chunk by ``tl.sum``'s fixed tree
  (:func:`rms_dw_combine_ref` is that order, plainly). No atomics:
  relaunches are bit-identical. One wrapper call is those two device
  kernels (one count in ``.launches``); the partials add 2 P D 4 bytes
  (8.7 MB at D = 4096, 8.6% of the bound's bytes). Triton, not CUDA C++:
  the work is a row normalisation and a column sum with no tensor-core
  product, bound by memory, and Triton's vectorised loads and tree
  reductions move the same bytes a second as hand-written loads would.
- ``_res_rms_fwd_kernel`` (launch ``residual_rms_norm_fwd``,
  ``_res_rms_fwd_call``) by :func:`residual_rms_norm_fwd_triton`: ``y = x +
  delta`` rounded in the model dtype first (the f32 sum cast back, as
  PyTorch's own add rounds), then the forward norm of that rounded y --
  the order of :func:`residual_rms_norm_fwd_ref`, so y is bit-equal and h
  within the forward's bound. Bound: memory, delta and x read, y and h
  written (134.2 MB at [4096, 4096] bf16, 0.040 ms). One program per row.
- ``_ln_fwd_kernel`` (launch ``layer_norm_fwd``, ``layer_norm_pallas``) by
  :func:`layer_norm_fwd_triton`: per row an f32 interior, the mean, the
  variance as the mean of squared deviations, ``rsqrt(var + eps)``, the
  normalised row rounded to x's type, then ``* w`` and ``+ b`` each
  rounded in that type -- :func:`layer_norm_ref`'s order. Bound: memory,
  x read and y written once (33.6 MB at [4096, 1024] f32, 0.010 ms). A
  program holds ``ROWS`` whole rows in registers (several rows for a
  narrow D), the rows past the end masked, where the TPU kernel pads them
  to its row block. No runtime route of the JAX package launches it
  (``ops.layer_norm`` is its plain version there and here); only its
  kernel catalog does, at 24 x 128 and 4096 x 1024 f32.

Training: :class:`RMSNorm` is the JAX package's ``rms_norm_pallas``
custom_vjp and :class:`ResidualRMSNorm` its ``_res_rms_vjp``. Their
forwards are the kernels on CUDA (the plain versions on the CPU); their
backward is the op ``"rms_norm_bwd"``, resolved through the fused-train
mode when the forward runs: the JAX package resolves it at trace time,
and the caller's thread holds the registry pins, which the autograd
engine's thread does not see. ``"rms_norm_bwd"`` has two variants: the
kernel (``"cuda_fused"``, CUDA f32/bf16 with ``D <= 16384``; pinned on
the CPU it runs the plain version, as the Functions do) and the
composition :func:`rms_bwd_ref` (``"unfused"``, CPU metas; mode "ref"
pins it on the card). A CUDA meta the kernel refuses raises with its
reason; the composition never stands in on the card.

Triton is imported when a kernel is first launched, never at import:
the CPU tests import this module where Triton is absent.
"""
from __future__ import annotations

import functools

import torch

from . import _launch
from ._build import DTYPES
from .registry import KERNELS, dispatch_fused_variant

__all__ = ["rms_norm_ref", "rms_norm_fwd_triton", "rms_bwd_ref",
           "rms_norm_bwd_triton", "rms_bwd_partition", "rms_dw_combine_ref",
           "residual_rms_norm_fwd_ref",
           "residual_rms_norm_fwd_triton", "layer_norm_ref",
           "layer_norm_fwd_triton", "rms_bwd_meta", "RMSNorm",
           "ResidualRMSNorm", "MAX_D"]

_kernels = {}
tl = None          # triton.language, bound by triton_jit at the first launch
MAX_D = 16384      # a row is one register-resident block
_BWD_PROGRAMS = 264                  # dw partials: two programs per SM
_SOURCE = "paddle_tpu_torch/ops/kernels/norms.py"
_SUM_ROWS, _SUM_COLS = 128, 32       # a dw-sum program's chunk of partials


def rms_norm_ref(x, weight, epsilon=1e-6):
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + epsilon)).to(x.dtype) * weight


def _rms_fwd_kernel(x_ptr, w_ptr, y_ptr, D, eps, BLOCK: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < D
    x = tl.load(x_ptr + row * D + cols, mask=mask, other=0.0)
    xf = x.to(tl.float32)
    ms = tl.sum(xf * xf, axis=0) / D
    y = (xf * tl.rsqrt(ms + eps)).to(x.dtype)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0)
    tl.store(y_ptr + row * D + cols, y * w, mask=mask)


def _rms_bwd_kernel(x_ptr, w_ptr, g_ptr, dx_ptr, part_ptr, rows, D, eps,
                    BLOCK: "tl.constexpr"):
    pid = tl.program_id(0)
    nprog = tl.num_programs(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < D
    wf = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    dw = tl.zeros([BLOCK], tl.float32)
    off = pid.to(tl.int64) * D + cols       # row pid < rows: a first row
    x = tl.load(x_ptr + off, mask=mask, other=0.0)
    g = tl.load(g_ptr + off, mask=mask, other=0.0)
    for r in range(pid, rows, nprog):
        # the next row's loads go out before this row's reductions
        nxt = r + nprog
        noff = nxt.to(tl.int64) * D + cols
        x_next = tl.load(x_ptr + noff, mask=mask & (nxt < rows), other=0.0)
        g_next = tl.load(g_ptr + noff, mask=mask & (nxt < rows), other=0.0)
        xf = x.to(tl.float32)
        gf = g.to(tl.float32)
        inv = tl.rsqrt(tl.sum(xf * xf, axis=0) / D + eps)
        xhat = xf * inv
        gw = gf * wf
        dx = inv * (gw - xhat * (tl.sum(gw * xhat, axis=0) / D))
        tl.store(dx_ptr + off, dx.to(x.dtype), mask=mask)
        dw += gf * xhat
        x, g, off = x_next, g_next, noff
    tl.store(part_ptr + pid.to(tl.int64) * D + cols, dw, mask=mask)


def _dw_sum_kernel(part_ptr, out_ptr, n_rows, D, ROWS: "tl.constexpr",
                   COLS: "tl.constexpr"):
    """out[c] = the sum of part[p, c] over p: chunks of ROWS partial rows
    in chunk order, each chunk summed by ``tl.sum``'s fixed tree."""
    cols = tl.program_id(0) * COLS + tl.arange(0, COLS)
    cmask = cols < D
    acc = tl.zeros([COLS], tl.float32)
    for p0 in range(0, n_rows, ROWS):
        r = p0 + tl.arange(0, ROWS)
        m = (r < n_rows)[:, None] & cmask[None, :]
        acc += tl.sum(tl.load(part_ptr + r.to(tl.int64)[:, None] * D
                              + cols[None, :], mask=m, other=0.0), axis=0)
    tl.store(out_ptr + cols, acc.to(out_ptr.dtype.element_ty), mask=cmask)


def _res_rms_fwd_kernel(d_ptr, x_ptr, w_ptr, y_ptr, h_ptr, D, eps,
                        BLOCK: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < D
    x = tl.load(x_ptr + row * D + cols, mask=mask, other=0.0)
    d = tl.load(d_ptr + row * D + cols, mask=mask, other=0.0)
    y = (x.to(tl.float32) + d.to(tl.float32)).to(x.dtype)
    tl.store(y_ptr + row * D + cols, y, mask=mask)
    yf = y.to(tl.float32)
    ms = tl.sum(yf * yf, axis=0) / D
    hn = (yf * tl.rsqrt(ms + eps)).to(x.dtype)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0)
    tl.store(h_ptr + row * D + cols, hn * w, mask=mask)


def layer_norm_ref(x, weight, bias, epsilon=1e-5):
    """The JAX package's ``ops.layer_norm_ref``: an f32 interior, the
    normalised row cast to x's type, then ``* weight`` and ``+ bias``
    (either may be None)."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, correction=0, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def _ln_fwd_kernel(x_ptr, w_ptr, b_ptr, y_ptr, rows, D, eps,
                   ROWS: "tl.constexpr", BLOCK: "tl.constexpr"):
    r = tl.program_id(0).to(tl.int64) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK)
    mask = (r < rows)[:, None] & (cols < D)[None, :]
    off = r[:, None] * D + cols[None, :]
    x = tl.load(x_ptr + off, mask=mask, other=0.0)
    xf = x.to(tl.float32)
    mean = tl.sum(xf, axis=1) / D
    diff = tl.where(mask, xf - mean[:, None], 0.0)
    var = tl.sum(diff * diff, axis=1) / D
    xhat = (diff * tl.rsqrt(var + eps)[:, None]).to(x.dtype)
    w = tl.load(w_ptr + cols, mask=cols < D, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + cols, mask=cols < D, other=0.0).to(tl.float32)
    y = (xhat.to(tl.float32) * w[None, :]).to(x.dtype)
    y = (y.to(tl.float32) + b[None, :]).to(x.dtype)
    tl.store(y_ptr + off, y, mask=mask)


def _check_rows(name, x, weight, *more, max_d=None):
    """Raise unless ``x`` is a CUDA f32/bf16 tensor (with ``D <= max_d``
    when given), ``weight`` is [D] of x's type, and ``more`` match x."""
    _launch.check_device(name, x.device)
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    D = x.shape[-1]
    if max_d is not None and D > max_d:
        raise ValueError(f"{name}: D={D} passes the kernel's {max_d}")
    if weight.dtype != x.dtype or tuple(weight.shape) != (D,) \
            or weight.device != x.device:
        raise ValueError(f"weight must be [{D}] {x.dtype} on {x.device}, "
                         f"got {tuple(weight.shape)} {weight.dtype} on "
                         f"{weight.device}")
    for t in more:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype} "
                             f"on {t.device} does not match x "
                             f"{tuple(x.shape)} {x.dtype}")


def _warps(block):
    return 8 if block >= 2048 else 4


def _pow2(n):
    return 1 << max(int(n) - 1, 0).bit_length()


def _op(name, shape, dt):
    return _launch.KernelOperand(name, tuple(shape), dt)


@functools.lru_cache(maxsize=256)
def rms_fwd_spec(rows, D, dt):
    """One program per row, ``BLOCK = next_pow2(D)`` columns."""
    x, w, y = _op("x", (rows, D), dt), _op("w", (D,), dt), \
        _op("y", (rows, D), dt)
    block = _pow2(D)
    phase = _launch.KernelPhase("rows", rows, (_launch.rows_access(x),
                                               _launch.whole(w)),
                                (_launch.rows_access(y),))
    return _launch.triton_spec(
        "rms_norm_fwd", _SOURCE, dt, (phase,), (x, w), (y,),
        (("_rms_fwd_kernel", 5, (rows,), {"BLOCK": block}, _warps(block)),))


def rms_bwd_partition(rows):
    """``(programs, [rows of program p, in its order])``: the row kernel's
    ``min(rows, 264)`` programs (at least one), program p taking rows p,
    p + programs, ..."""
    nprog = max(1, min(rows, _BWD_PROGRAMS))
    return nprog, [list(range(p, rows, nprog)) for p in range(nprog)]


def rms_dw_combine_ref(part, dtype):
    """dw from the row kernel's ``part`` [P, D] f32 as the sum kernel adds
    it: chunks of ``_SUM_ROWS`` partial rows in chunk order (each chunk's
    own sum a fixed tree on the card, here torch's), cast once."""
    acc = torch.zeros(part.shape[1], dtype=torch.float32, device=part.device)
    for p0 in range(0, part.shape[0], _SUM_ROWS):
        acc = acc + part[p0:p0 + _SUM_ROWS].sum(0)
    return acc.to(dtype)


@functools.lru_cache(maxsize=256)
def rms_bwd_spec(rows, D, dt):
    """The row kernel (:func:`rms_bwd_partition`'s programs striding over
    the rows, each keeping an f32 partial of dw and loading its next row
    before it reduces the current one) and the sum of the partials (one
    program per ``_SUM_COLS`` columns, chunks of ``_SUM_ROWS`` partial rows
    in order). ``plan["part"]``: the partials' shape, a workspace."""
    x, w, g = (_op("x", (rows, D), dt), _op("w", (D,), dt),
               _op("g", (rows, D), dt))
    dx, dw = _op("dx", (rows, D), dt), _op("dw", (D,), dt)
    block = _pow2(D)
    nprog, _ = rms_bwd_partition(rows)
    nsum = -(-D // _SUM_COLS)
    phases = (
        _launch.KernelPhase("rows", rows, (_launch.rows_access(x),
                                           _launch.rows_access(g),
                                           _launch.whole(w)),
                            (_launch.rows_access(dx),)),
        _launch.KernelPhase("dw", nsum, (),
                            (_launch.flat_access(dw, _SUM_COLS),)))
    spec = _launch.triton_spec(
        "rms_norm_bwd", _SOURCE, dt, phases, (x, w, g), (dx, dw),
        (("_rms_bwd_kernel", 8, (nprog,), {"BLOCK": block}, _warps(block)),
         ("_dw_sum_kernel", 4, (nsum,),
          {"ROWS": _SUM_ROWS, "COLS": _SUM_COLS}, 4)))
    spec.plan["part"] = (nprog, D)
    return spec


@functools.lru_cache(maxsize=256)
def res_rms_fwd_spec(rows, D, dt):
    """One program per row: ``y = x + delta`` and its RMSNorm ``h``."""
    d, x, w = (_op("delta", (rows, D), dt), _op("x", (rows, D), dt),
               _op("w", (D,), dt))
    y, h = _op("y", (rows, D), dt), _op("h", (rows, D), dt)
    block = _pow2(D)
    phase = _launch.KernelPhase(
        "rows", rows, (_launch.rows_access(d), _launch.rows_access(x),
                       _launch.whole(w)),
        (_launch.rows_access(y), _launch.rows_access(h)))
    return _launch.triton_spec(
        "residual_rms_norm_fwd", _SOURCE, dt, (phase,), (d, x, w), (y, h),
        (("_res_rms_fwd_kernel", 7, (rows,), {"BLOCK": block},
          _warps(block)),))


@functools.lru_cache(maxsize=256)
def ln_fwd_spec(rows, D, dt):
    """One program per ``ROWS`` whole rows (several for a narrow D)."""
    x, w, b = (_op("x", (rows, D), dt), _op("w", (D,), dt),
               _op("b", (D,), dt))
    y = _op("y", (rows, D), dt)
    block = _pow2(D)
    per = max(1, min(16, 4096 // block))     # rows a program holds
    progs = -(-rows // per)
    phase = _launch.KernelPhase(
        "rows", progs, (_launch.rows_access(x, per), _launch.whole(w),
                        _launch.whole(b)),
        (_launch.rows_access(y, per),))
    return _launch.triton_spec(
        "layer_norm_fwd", _SOURCE, dt, (phase,), (x, w, b), (y,),
        (("_ln_fwd_kernel", 7, (progs,), {"ROWS": per, "BLOCK": block},
          _warps(block * per)),))


def rms_norm_fwd_triton(x, weight, epsilon=1e-6):
    """Launch the Triton kernel over the rows of ``x``. CUDA tensors
    only; raises for anything the kernel does not take. Never falls
    back."""
    _check_rows("rms_norm_fwd_triton", x, weight)
    D = x.shape[-1]
    x2 = x.reshape(-1, D).contiguous()
    w = weight.contiguous()
    y = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows:
        spec = rms_fwd_spec(rows, D, _launch.dtype_name(x.dtype))
        if _launch.begin(spec, x.device):
            with torch.cuda.device(x.device):
                rms_norm_fwd_triton.launches += 1
                _launch.triton_run(globals(), spec,
                                   [(x2, w, y, D, float(epsilon))])
    return y.reshape(x.shape)


def rms_norm_bwd_triton(x, weight, g, epsilon=1e-6):
    """Launch the backward kernels: ``(dx, dw)`` as :func:`rms_bwd_ref`
    (dx in x's type, dw in the weight's). CUDA tensors only, ``weight``
    in x's type; raises for anything else, never falls back."""
    _check_rows("rms_norm_bwd_triton", x, weight, g, max_d=MAX_D)
    D = x.shape[-1]
    x2 = x.reshape(-1, D).contiguous()
    g2 = g.reshape(-1, D).contiguous()
    rows = x2.shape[0]
    dx = torch.empty_like(x2)
    if not rows:            # no row: dw is a sum of nothing
        return dx.reshape(x.shape), torch.zeros(D, dtype=weight.dtype,
                                                device=x.device)
    dw = torch.empty(D, dtype=weight.dtype, device=x.device)
    spec = rms_bwd_spec(rows, D, _launch.dtype_name(x.dtype))
    nprog = spec.plan["part"][0]
    part = torch.empty(spec.plan["part"], dtype=torch.float32,
                       device=x.device)
    if _launch.begin(spec, x.device):
        with torch.cuda.device(x.device):
            rms_norm_bwd_triton.launches += 1
            _launch.triton_run(globals(), spec, [
                (x2, weight.contiguous(), g2, dx, part, rows, D,
                 float(epsilon)), (part, dw, nprog, D)])
    return dx.reshape(x.shape), dw


def residual_rms_norm_fwd_ref(delta, x, weight, epsilon=1e-6):
    """``(y, h)``: ``y = x + delta`` in x's type, ``h = rms_norm_ref(y)``
    (the JAX kernel's order: the sum is rounded before its moment)."""
    y = x + delta
    return y, rms_norm_ref(y, weight, epsilon)


def residual_rms_norm_fwd_triton(delta, x, weight, epsilon=1e-6):
    """Launch the residual + RMSNorm kernel: ``(y, h)`` as
    :func:`residual_rms_norm_fwd_ref`. CUDA tensors only; never falls
    back."""
    _check_rows("residual_rms_norm_fwd_triton", x, weight, delta,
                max_d=MAX_D)
    D = x.shape[-1]
    x2 = x.reshape(-1, D).contiguous()
    d2 = delta.reshape(-1, D).contiguous()
    y, h = torch.empty_like(x2), torch.empty_like(x2)
    rows = x2.shape[0]
    if rows:
        spec = res_rms_fwd_spec(rows, D, _launch.dtype_name(x.dtype))
        if _launch.begin(spec, x.device):
            with torch.cuda.device(x.device):
                residual_rms_norm_fwd_triton.launches += 1
                _launch.triton_run(globals(), spec, [
                    (d2, x2, weight.contiguous(), y, h, D, float(epsilon))])
    return y.reshape(x.shape), h.reshape(x.shape)


def layer_norm_fwd_triton(x, weight, bias, epsilon=1e-5):
    """Launch the LayerNorm kernel over the rows of ``x``: the contract of
    :func:`layer_norm_ref` with ``weight`` and ``bias`` [D] in x's type.
    CUDA tensors only; raises for anything the kernel does not take.
    Never falls back."""
    name = "layer_norm_fwd_triton"
    _check_rows(name, x, weight, max_d=MAX_D)
    _check_rows(name, x, bias)
    D = x.shape[-1]
    x2 = x.reshape(-1, D).contiguous()
    y = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows:
        spec = ln_fwd_spec(rows, D, _launch.dtype_name(x.dtype))
        if _launch.begin(spec, x.device):
            with torch.cuda.device(x.device):
                layer_norm_fwd_triton.launches += 1
                _launch.triton_run(globals(), spec, [
                    (x2, weight.contiguous(), bias.contiguous(), y, rows, D,
                     float(epsilon))])
    return y.reshape(x.shape)


for _w in (rms_norm_fwd_triton, rms_norm_bwd_triton,
           residual_rms_norm_fwd_triton, layer_norm_fwd_triton):
    _launch.counted(_w)


def rms_bwd_ref(epsilon, res, g):
    """The JAX package's ``_rms_bwd_ref``: (dx in x's type, dw in the
    weight's type) from the saved ``res = (x, weight)`` and the output's
    cotangent ``g``, all in f32 inside."""
    x, weight = res
    xf, gf, wf = x.float(), g.float(), weight.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + epsilon)
    xhat = xf * inv
    dw = torch.sum(gf * xhat, dim=tuple(range(x.dim() - 1))).to(
        weight.dtype)
    gw = gf * wf
    dx = inv * (gw - xhat * torch.mean(gw * xhat, dim=-1, keepdim=True))
    return dx.to(x.dtype), dw


def rms_bwd_meta(rows, d, dtype, device) -> dict:
    return {"rows": int(rows), "d": int(d), "dtype": str(dtype),
            "device": torch.device(device).type}


def supports_cuda(what, width=None):
    """``supports`` of a kernel variant: CUDA, f32/bf16 and, for a row
    kernel, ``meta[width] <= MAX_D`` (a row is one block of registers)."""
    def supports(meta):
        if meta["device"] != "cuda":
            return False, f"{what} take CUDA tensors"
        if meta["dtype"] not in ("torch.float32", "torch.bfloat16"):
            return False, (f"{what} take float32 and bfloat16, not "
                           f"{meta['dtype']}")
        if width is not None and meta[width] > MAX_D:
            return False, (f"{what} hold a row in one block of registers: "
                           f"{width}={meta[width]} passes {MAX_D}")
        return True, what
    return supports


def supports_plain(meta):
    """The compositions' ``supports``: CPU metas only (on the card the
    kernel runs or the call raises; mode "ref" pins a composition)."""
    if meta["device"] != "cpu":
        return False, ("the composition is the CPU's route; on the card "
                       "the kernel runs or the call raises "
                       "(fused_train='ref' pins the composition)")
    return True, "composition on the CPU"


def _rms_bwd_kernel_variant(epsilon, res, g):
    """The kernel on CUDA tensors, its plain version on CPU ones (as the
    Functions do)."""
    x, weight = res
    if x.device.type == "cpu":
        return rms_bwd_ref(epsilon, res, g)
    return rms_norm_bwd_triton(x, weight, g, epsilon)


KERNELS.register("rms_norm_bwd", "cuda_fused", _rms_bwd_kernel_variant,
                 priority=10, supports=supports_cuda(
                     "the rms_norm_bwd Triton kernels", "d"))
KERNELS.register("rms_norm_bwd", "unfused", rms_bwd_ref, priority=0,
                 supports=supports_plain)
# the JAX declaration, with ``device`` for ``interpret``
KERNELS.declare_cache_key("rms_norm_bwd", ("rows", "d", "dtype", "device"))


class RMSNorm(torch.autograd.Function):
    """RMSNorm with the JAX package's custom backward. ``mode`` (the
    fused-train knob) picks the backward variant when the forward runs."""

    @staticmethod
    def forward(ctx, x, weight, epsilon, mode):
        ctx.bwd = dispatch_fused_variant(
            "rms_norm_bwd",
            rms_bwd_meta(x.numel() // x.shape[-1], x.shape[-1], x.dtype,
                         x.device), mode)
        ctx.save_for_backward(x, weight)
        ctx.epsilon = epsilon
        if x.device.type == "cpu":
            return rms_norm_ref(x, weight, epsilon)
        return rms_norm_fwd_triton(x, weight, epsilon)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = ctx.bwd(ctx.epsilon, (x, weight), g)
        return dx, dw, None, None


class ResidualRMSNorm(torch.autograd.Function):
    """``(y, h) = (x + delta, rms_norm(x + delta))`` with the JAX package's
    ``_res_rms_vjp``: the forward is the kernel on CUDA (the plain version
    on the CPU); the backward runs ``"rms_norm_bwd"`` (resolved through
    ``mode`` when the forward runs) on the saved sum y, then adds the
    residual cotangent gy once: ``d_delta = dx = dn + gy``."""

    @staticmethod
    def forward(ctx, delta, x, weight, epsilon, mode):
        ctx.bwd = dispatch_fused_variant(
            "rms_norm_bwd",
            rms_bwd_meta(x.numel() // x.shape[-1], x.shape[-1], x.dtype,
                         x.device), mode)
        if x.device.type == "cpu":
            y, h = residual_rms_norm_fwd_ref(delta, x, weight, epsilon)
        else:
            y, h = residual_rms_norm_fwd_triton(delta, x, weight, epsilon)
        ctx.save_for_backward(y, weight)
        ctx.epsilon = epsilon
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        y, weight = ctx.saved_tensors
        dn, dw = ctx.bwd(ctx.epsilon, (y, weight), gh)
        ds = dn + gy
        return ds, ds, dw, None, None
