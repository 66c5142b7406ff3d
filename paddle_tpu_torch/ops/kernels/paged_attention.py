"""Paged KV-cache decode attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``paddle_tpu/ops/pallas/paged_attention.py``'s
``paged_attention_decode_pallas`` (launch ``paged_attention_decode``).
The kernel is ``paddle_tpu_torch/csrc/paged_attention.cu``, CUDA C++ for
``sm_90a``, built by :mod:`._build` at its first launch and bound with
ctypes. It runs the split page stream of ``csrc/paged_stream.cuh``, the
one the fused decode kernels run: one cooperative launch whose blocks
take (split of :data:`SPLIT_PAGES` pages, sequence, KV head) items,
:data:`PAGES_PER_STEP` pages a step with the next step's K/V in flight,
leave f32 partials in a workspace, and after one grid barrier combine
them in split order. :func:`paged_spec` records that plan (grid, shared
memory, the split and step) and the launcher refuses any other.

:func:`paged_attention_decode_ref` is the plain version, the counterpart
of the JAX package's ``paged_attention_decode_xla``: it gathers each
sequence's pages densely and runs masked softmax attention in f32. The
CPU tests use it, and ``chip_smoke.py`` holds the kernel against it on
the card. With ``k_scale``/``v_scale`` it reads int8 pools, dequantized
right after the gather; that is the int8 cache's decode attention on every
device (``ops.paged_attention.paged_attention_decode_quant``), as in the
JAX package, whose Pallas kernel takes no scales. The CUDA kernel takes fp
pools only.
"""
from __future__ import annotations

import functools
import math

import torch

from . import _build, _launch

__all__ = ["paged_attention_decode_ref", "paged_attention_decode_cuda",
           "paged_spec", "paged_smem", "SPLIT_PAGES", "PAGES_PER_STEP"]

_SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
_THREADS = 256
#: blocks an SM the kernel is built for (its __launch_bounds__)
BOUNDS = 3
#: the launcher's ctypes argument codes: q, pools, tables, lengths, out and
#: the partials' workspace; B, H, KV, hd, BS, MB and the plan's grid,
#: smem, split_pages, pages_per_step; the scale
CALL = ("paged_attention_decode",
        ("p",) * 7 + ("i",) * 10 + ("f", "i", "p"))
#: the split page stream's constants (csrc/paged_stream.cuh): pages a work
#: item, pages a step, staged steps
SPLIT_PAGES, PAGES_PER_STEP, PAGE_STAGES = 8, 4, 2
_GRIDS = {}


def paged_attention_decode_ref(q, k_pool, v_pool, block_tables, seq_lens,
                               k_scale=None, v_scale=None):
    """q [B, H, hd]; pools [N, BS, KV, hd]; block_tables [B, MB];
    seq_lens [B] (current token included) -> [B, H, hd] in q's type,
    scale 1/sqrt(hd).
    Positions at/after ``seq_len`` get score -1e30 (finite, so a slot of
    length 0 softmaxes without NaN) and a slot of length 0 returns 0.
    ``k_scale``/``v_scale`` [KV] f32: int8 pools, dequantized per head in
    f32 right after the gather, so the rest of the math is the fp pools'
    (the JAX ``paged_attention_decode_xla``)."""
    B, H, hd = q.shape
    N, BS, KV, _ = k_pool.shape
    MB = block_tables.shape[1]
    scale = 1.0 / math.sqrt(hd)
    tables = block_tables.long()
    k = k_pool[tables].reshape(B, MB * BS, KV, hd)
    v = v_pool[tables].reshape(B, MB * BS, KV, hd)
    if k_scale is not None:
        k = k.float() * k_scale[None, None, :, None]
    if v_scale is not None:
        v = v.float() * v_scale[None, None, :, None]
    rep = H // KV
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale
    T = MB * BS
    mask = (torch.arange(T, device=q.device)[None, None, :]
            < seq_lens[:, None, None])
    # a fill, not a copy from the host: the int8 cache's unfused decode
    # step runs this inside the captured CUDA graph
    scores = torch.where(mask, scores,
                         torch.full((), -1e30, dtype=torch.float32,
                                    device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bht,bthd->bhd", probs, v.float())
    out = torch.where(seq_lens[:, None, None] > 0, out, 0.0)
    return out.to(q.dtype)


def paged_smem(groups, hd, BS, item):
    """Dynamic shared memory of one block (the source's ``paged_smem``):
    one item's f32 scratch (``attn_scratch_floats``: q and acc of the
    group, the scores of a step, m, l, alpha and one spare row, padded to
    16 bytes), then two staged steps of K and V in the pools' type."""
    sb = PAGES_PER_STEP * BS
    f = 2 * groups * hd + groups * sb + 3 * groups + hd
    return -(-f // 4) * 16 + 2 * PAGE_STAGES * sb * hd * item


def splits(MB):
    """Work items of a sequence's pages: splits of SPLIT_PAGES pages."""
    return -(-MB // SPLIT_PAGES)


def coop_grid(device, dtype, smem):
    """The kernel's cooperative grid: on the meta device the H100's (132
    SMs times the blocks an SM holds: BOUNDS, or fewer where ``smem`` does
    not fit twice); on a card the launcher's occupancy query
    (``paged_coop_grid``), asked once per (device, type, shared memory)."""
    if device.type == "meta":
        per_sm = min(BOUNDS, _launch.SMEM_SM // (smem + _launch.SMEM_RESERVED))
        return _launch.H100_SMS * per_sm
    key = (device.index, dtype, smem)
    grid = _GRIDS.get(key)
    if grid is None:
        with torch.cuda.device(device):
            fn = _build.c_fn("paged_attention", "paged_coop_grid", ("i", "i"))
            grid = fn(_build.DTYPES[dtype], smem)
        if grid <= 0:
            raise RuntimeError(f"paged_attention_decode: no cooperative grid "
                               f"at {smem} B of shared memory "
                               f"(cudaError {-grid})")
        _GRIDS[key] = grid
    return grid


@functools.lru_cache(maxsize=256)
def paged_spec(B, H, KV, hd, BS, MB, N, dt, grid):
    """The launch spec: one cooperative launch of ``grid`` blocks of 256
    threads (csrc/paged_stream.cuh's split page stream). Phase "pages": the
    work items (split of SPLIT_PAGES pages, sequence, KV head), each
    reading its head group's q rows and its split's live pages (paged) and
    writing f32 partials to a workspace; phase "combine", after the grid
    barrier: one item per (sequence, KV head), its partials combined in
    split order into the group's output rows."""
    groups = H // KV
    item = 4 if dt == "float32" else 2
    smem = paged_smem(groups, hd, BS, item)
    ns = splits(MB)
    op = _launch.KernelOperand
    ins = (op("q", (B, H, hd), dt),
           op("k_pool", (N, BS, KV, hd), dt, "tokens"),
           op("v_pool", (N, BS, KV, hd), dt, "tokens"),
           op("block_tables", (B, MB), "int32", "pages"),
           op("seq_lens", (B,), "int32"))
    outs = (op("out", (B, H, hd), dt),)

    def head_rows(i):
        return ((i // KV) % B, i % KV, 0)
    A = _launch.Access
    pages = _launch.KernelPhase(
        "pages", ns * B * KV,
        (A("q", (1, groups, hd), head_rows), _launch.whole(ins[4])))
    combine = _launch.KernelPhase(
        "combine", B * KV, (), (A("out", (1, groups, hd), head_rows),))
    return _launch.KernelLaunchSpec(
        "paged_attention_decode", "cuda", _SOURCE, (grid,), _THREADS, ins,
        outs, (pages, combine), (CALL,), dt,
        blocks_per_sm=min(BOUNDS, _launch.SMEM_SM
                          // (smem + _launch.SMEM_RESERVED)),
        cooperative=True, dyn_smem=smem,
        plan={"grid": grid, "smem": smem, "threads": _THREADS,
              "launch": "cooperative", "split_pages": SPLIT_PAGES,
              "pages_per_step": PAGES_PER_STEP, "stages": PAGE_STAGES,
              "items": ns * B * KV, "combine": "split order"})


def _check(q, k_pool, v_pool, block_tables, seq_lens):
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype == torch.int8:
            raise TypeError(
                f"{name} is int8: the kernel takes fp pools; int8 pools "
                "go through paged_attention_decode_quant, a composition "
                "on every device, as in the JAX package (XLA)")
    _launch.check_device("paged_attention_decode_cuda", q.device)
    if q.dtype not in _build.DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("seq_lens", seq_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, H, hd = q.shape
    N, BS, KV, hd2 = k_pool.shape
    if v_pool.shape != k_pool.shape or hd2 != hd:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if (hd * q.element_size()) % 16:
        raise ValueError(f"head_dim {hd} rows are not a multiple of 16 "
                         "bytes (the kernel's load width)")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"seq_lens {tuple(seq_lens.shape)} do not match B={B}")


def paged_attention_decode_cuda(q, k_pool, v_pool, block_tables, seq_lens):
    """Launch the CUDA kernel (same contract as the plain version) on
    PyTorch's current stream. Raises for anything the kernel does not
    take, and if the launch is refused. Never falls back."""
    _check(q, k_pool, v_pool, block_tables, seq_lens)
    B, H, hd = q.shape
    N, BS, KV, _ = k_pool.shape
    MB = block_tables.shape[1]
    smem = paged_smem(H // KV, hd, BS, q.element_size())
    if smem > _launch.SMEM_BLOCK:
        raise ValueError(f"paged_attention_decode_cuda: needs {smem} B of "
                         f"shared memory a block, over the card's "
                         f"{_launch.SMEM_BLOCK}")
    grid = coop_grid(q.device, q.dtype, smem)
    spec = paged_spec(B, H, KV, hd, BS, MB, N, _launch.dtype_name(q.dtype),
                      grid)
    out = torch.empty_like(q)
    # the f32 partials: m and l of every (sequence, head, split), then acc
    n_part = B * H * splits(MB)
    ws = torch.empty(n_part * (2 + hd), dtype=torch.float32, device=q.device)
    if not _launch.begin(spec, q.device):
        return out
    fn = _build.c_fn("paged_attention", *spec.calls[0])
    pl = spec.plan
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        paged_attention_decode_cuda.launches += 1
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), seq_lens.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), B, H, KV, hd, BS, MB,
                 pl["grid"], pl["smem"], pl["split_pages"],
                 pl["pages_per_step"], 1.0 / math.sqrt(hd),
                 _build.DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError("paged_attention_decode launch failed: "
                           + fn.error_string(err).decode())
    return out


_launch.counted(paged_attention_decode_cuda)
