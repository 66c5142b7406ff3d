"""Kernel-geometry rules over the port's launch plans (port of
``paddle_tpu/analysis/kernel_rules.py``).

Every wrapper in ``ops/kernels/`` records a
:class:`~paddle_tpu_torch.ops.kernels._launch.KernelLaunchSpec` before it
launches: its grid, threads, shared memory, the C launcher's argument
types and, for each phase of the kernel, the tiles its work items read
and write. The rules evaluate the tile maps concretely over every item
(numpy, on the CPU) and prove, for the persistent grid-stride kernels of
this card, what the JAX rules prove for a Pallas grid:

- ``GRID_FLOOR_DROP``: an output tile that no item writes; for operands
  read through static tile maps, an input tile that no item reads (the
  floor-divided grid that drops the trailing columns). Operands read
  through the block tables (the KV pools, the tables, the rope rows at
  each sequence's length: ``KernelOperand.paged``) read live pages only,
  by design, and are exempt, as the JAX rule exempts scalar-prefetch
  launches. An input read only where a mask lets a query see it
  (``KernelOperand.masked``: flash attention's bias under the causal
  mask) must have every tile the mask lets some query see read.
- ``OOB_BLOCK``: a tile that starts outside its array (or a map whose
  arity is not the array's). A partial last tile is legal: the kernels
  guard every column and row against the extent.
- ``WRITE_RACE``: two work items write the same output tile and the
  output is not declared accumulated (``accum_outputs``). Blocks run in
  no order here, so an undeclared revisit is a race, not last-write-wins.
- ``SMEM_OVERCOMMIT`` (the TPU's ``VMEM_OVERCOMMIT``): dynamic plus static
  shared memory of a block over 227 KB, or the blocks an SM the kernel is
  built for (``blocks_per_sm``, its ``__launch_bounds__``) not fitting the
  SM's 228 KB with the card's 1 KB a block.
- ``ARG_MISMATCH`` (the TPU's ``SCRATCH_MISMATCH``): a wrapper's ctypes
  argument types (pointers, ints, long longs, floats, the dtype code and
  the stream) differ from the parameters of the ``extern "C"`` launcher,
  read from ``csrc/*.cu``'s text, so the rule runs on the CPU; for a
  Triton kernel, the positional arguments and constexpr keywords of its
  launch against the kernel function's signature (read from the module,
  which imports without ``triton``).

The registry lint ``DISPATCH_KEY_GAP`` (:func:`dispatch_key_rule`) checks
a program's key: every meta key that a variant's ``supports()`` reads must
be covered by the op's ``KERNELS.declare_cache_key`` declaration, or a
changed value would replay a program built under the other dispatch (the
serving engine's captured decode step keys its CUDA graph by the pins and
is built for the shapes its engine fixes).

:func:`modeled_launch_bytes` and :func:`bound` are the one model of what a
launch must move and do: each input byte read once and each output byte
written once (the union of the tiles the plan touches), the paged operands
by the live lengths, and the operations of
:data:`~.kernel_catalog.FLOP_FORMULAS`; over the H100's 3.35 TB/s and
989 TFLOP/s (bf16) or 67 TFLOP/s (f32).
"""
from __future__ import annotations

import functools
import importlib
import inspect
import re
from collections.abc import Mapping
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops.kernels import _launch
from .rules import Finding

__all__ = ["KERNEL_RULE_CODES", "check_launch", "modeled_launch_bytes",
           "bound", "c_launchers", "launchers_in", "dispatch_key_rule",
           "HBM_BYTES_PER_S", "PEAK_OPS_PER_S"]

KERNEL_RULE_CODES = ("GRID_FLOOR_DROP", "OOB_BLOCK", "WRITE_RACE",
                     "SMEM_OVERCOMMIT", "ARG_MISMATCH")

#: the H100 SXM's memory rate and peak operation rates (NVIDIA's data
#: sheet, dense): bf16 on the tensor cores, f32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

_REPO = Path(__file__).resolve().parents[2]


def _finding(program, code, site, message, detail):
    return Finding(rule="kernel_geometry", code=code, severity="error",
                   program=program, site=site, message=message,
                   detail=detail)


def _cdiv(a, b):
    return -(-a // b)


# -- tile maps, evaluated over every item -------------------------------


def _coords(acc, phase) -> np.ndarray:
    """[items, ndim] int64 tile coordinates of ``acc`` over its items of
    ``phase``."""
    n = phase.items - acc.first
    if acc.items is not None:
        n = min(n, acc.items)
    n = max(n, 0)
    raw = acc.index_map(np.arange(n, dtype=np.int64))
    if not isinstance(raw, tuple):
        raw = (raw,)
    cols = [np.broadcast_to(np.asarray(c, dtype=np.int64), (n,))
            for c in raw]
    if not cols:
        return np.zeros((n, 0), dtype=np.int64)
    return np.stack(cols, axis=1)


def _accesses(spec, role):
    """operand name -> [(phase, access, coords)] of ``role`` ("reads" or
    "writes")."""
    out: Dict[str, list] = {}
    for ph in spec.phases:
        for acc in getattr(ph, role):
            out.setdefault(acc.operand, []).append((ph, acc,
                                                    _coords(acc, ph)))
    return out


def _malformed(op, entries) -> bool:
    nd = len(op.shape)
    return any(len(acc.tile) != nd or coords.shape[1] != nd
               for _, acc, coords in entries)


def _oob(spec, program, op, role, entries) -> List[Finding]:
    """OOB_BLOCK for one operand: a map of the wrong arity, or the first
    tile that starts outside the array (one proof per operand)."""
    for ph, acc, coords in entries:
        nd = len(op.shape)
        if len(acc.tile) != nd or coords.shape[1] != nd:
            return [_finding(
                program, "OOB_BLOCK", f"{spec.name}/{op.name}",
                (f"{spec.name} {op.name}: phase {ph.name} maps items to "
                 f"{coords.shape[1]} coordinates of a {len(acc.tile)}-d "
                 f"tile for a {nd}-d array {list(op.shape)}"),
                {"kernel": spec.name, "phase": ph.name,
                 "operand": op.name, "role": role})]
        bad = ~_in_bounds(op.shape, acc.tile, coords)
        if bad.any():
            j = int(np.argmax(bad))
            c = [int(v) for v in coords[j]]
            start = [ci * t for ci, t in zip(c, acc.tile)]
            return [_finding(
                program, "OOB_BLOCK", f"{spec.name}/{op.name}",
                (f"{spec.name} {op.name}: item {acc.first + j} of phase "
                 f"{ph.name} maps to tile {c} (elements from {start}) "
                 f"outside the array {list(op.shape)}: the {role[:-1]} is "
                 "past the array"),
                {"kernel": spec.name, "phase": ph.name, "operand": op.name,
                 "item": acc.first + j, "tile_coords": c,
                 "first_element": start, "shape": list(op.shape)})]
    return []


def _groups(entries):
    """The entries' tile coordinates grouped by tile shape."""
    out: Dict[tuple, list] = {}
    for _, acc, coords in entries:
        out.setdefault(tuple(acc.tile), []).append(coords)
    return {t: np.concatenate(cs) for t, cs in out.items()}


def _tile_grid(shape, tile):
    return tuple(_cdiv(e, t) for e, t in zip(shape, tile))


def _linear(shape, tile, coords):
    coords = coords[_in_bounds(shape, tile, coords)]
    if not len(coords):
        return np.zeros(0, dtype=np.int64)
    return np.ravel_multi_index(tuple(coords.T), _tile_grid(shape, tile))


def _in_bounds(shape, tile, coords):
    start = coords * np.asarray(tile, dtype=np.int64)
    return ((start >= 0)
            & (start < np.asarray(shape, dtype=np.int64))).all(axis=1)


def _mask(shape, groups):
    """Elements of an array of ``shape`` that the tiles touch (for an
    operand touched through tiles of several shapes)."""
    m = np.zeros(shape, dtype=bool)
    for tile, coords in groups.items():
        for c in coords[_in_bounds(shape, tile, coords)]:
            m[tuple(slice(ci * t, ci * t + t) for ci, t in zip(c, tile))] = 1
    return m


def _coverage(spec, program, op, entries, verb) -> Optional[Finding]:
    """GRID_FLOOR_DROP for ``op`` unless every element is touched."""
    if not op.shape or int(np.prod(op.shape)) == 0:
        return None
    groups = _groups(entries)
    if len(groups) == 1:
        (tile, coords), = groups.items()
        grid = _tile_grid(op.shape, tile)
        required = int(np.prod(grid))
        seen = np.unique(_linear(op.shape, tile, coords))
        if len(seen) == required:
            return None
        gaps = np.nonzero(seen != np.arange(len(seen)))[0]
        first_lin = int(gaps[0]) if len(gaps) else len(seen)
        first = [int(v) for v in np.unravel_index(first_lin, grid)]
        start = [f * t for f, t in zip(first, tile)]
        missing = required - len(seen)
        detail = {"missing_tiles": missing, "required_tiles": required,
                  "first_missing": first, "tile": list(tile)}
    elif groups:
        m = _mask(op.shape, groups)
        if m.all():
            return None
        missing = int((~m).sum())
        start = [int(v) for v in np.unravel_index(int(np.argmin(m)),
                                                 op.shape)]
        detail = {"missing_elements": missing}
    else:
        start = [0] * len(op.shape)
        missing = int(np.prod(op.shape))
        detail = {"missing_elements": missing}
    detail.update({"kernel": spec.name, "operand": op.name,
                   "first_missing_element": start, "shape": list(op.shape),
                   "grid": list(spec.grid)})
    return _finding(
        program, "GRID_FLOOR_DROP", f"{spec.name}/{op.name}",
        (f"{spec.name} {op.name}: part of the array is never {verb} "
         f"(first missing element {start} of {list(op.shape)}): a "
         "floor-divided tile count is dropping the trailing tiles (the "
         "non-divisor block_f class)"), detail)


def _seen_coverage(spec, program, op, entries) -> Optional[Finding]:
    """GRID_FLOOR_DROP for a masked input unless every tile its mask lets
    some query see (``op.masked``) is read, by reads of that tile shape."""
    tile = tuple(op.masked.tile)
    grid = _tile_grid(op.shape, tile)
    every = np.indices(grid).reshape(len(grid), -1).T
    need = every[np.asarray(op.masked.seen(every), dtype=bool)]
    read = _groups(entries).get(tile, np.zeros((0, len(tile)), np.int64))
    miss = need[~np.isin(np.ravel_multi_index(tuple(need.T), grid),
                         _linear(op.shape, tile, read))]
    if not len(miss):
        return None
    first = [int(v) for v in miss[0]]
    start = [f * t for f, t in zip(first, tile)]
    return _finding(
        program, "GRID_FLOOR_DROP", f"{spec.name}/{op.name}",
        (f"{spec.name} {op.name}: {len(miss)} tile(s) that the mask lets "
         f"a query see are never read (first at element {start} of "
         f"{list(op.shape)}): the plan drops work the function needs"),
        {"kernel": spec.name, "operand": op.name, "missing_tiles":
         len(miss), "required_tiles": len(need), "first_missing": first,
         "tile": list(tile), "first_missing_element": start,
         "shape": list(op.shape), "grid": list(spec.grid)})


def _race(spec, program, op, entries) -> Optional[Finding]:
    groups = _groups(entries)
    if len(groups) == 1:
        (tile, coords), = groups.items()
        lin = _linear(op.shape, tile, coords)
        revisits = len(lin) - len(np.unique(lin))
    else:
        touched = sum(int(np.prod([min(t, e - ci * t) for ci, t, e in
                                   zip(c, tile, op.shape)]))
                      for tile, coords in groups.items()
                      for c in coords[_in_bounds(op.shape, tile,
                                                       coords)])
        revisits = touched - int(_mask(op.shape, groups).sum())
    if revisits <= 0:
        return None
    return _finding(
        program, "WRITE_RACE", f"{spec.name}/{op.name}",
        (f"{spec.name} {op.name}: {revisits} tile write(s) land on a tile "
         "another item also writes, and the output is not declared "
         "accumulated: blocks run in no order on this card, so the "
         "result depends on the schedule; declare it in accum_outputs "
         "if the revisit is an intended accumulation"),
        {"kernel": spec.name, "operand": op.name, "revisits": revisits})


def _smem(spec, program) -> List[Finding]:
    out = []
    per_block = spec.dyn_smem + spec.static_smem
    if per_block > _launch.SMEM_BLOCK:
        out.append(_finding(
            program, "SMEM_OVERCOMMIT", f"{spec.name}/block",
            (f"{spec.name}: {per_block} B of shared memory a block "
             f"(dynamic {spec.dyn_smem} + static {spec.static_smem}) over "
             f"the card's {_launch.SMEM_BLOCK}: the launch is refused"),
            {"kernel": spec.name, "smem_bytes": per_block,
             "limit_bytes": _launch.SMEM_BLOCK}))
    need = spec.blocks_per_sm * (per_block + _launch.SMEM_RESERVED)
    if need > _launch.SMEM_SM:
        out.append(_finding(
            program, "SMEM_OVERCOMMIT", f"{spec.name}/sm",
            (f"{spec.name}: {spec.blocks_per_sm} blocks an SM (its launch "
             f"bounds) need {need} B of shared memory with the card's "
             f"{_launch.SMEM_RESERVED} B each, over the SM's "
             f"{_launch.SMEM_SM}: fewer blocks fit than the kernel is "
             "built for"),
            {"kernel": spec.name, "blocks_per_sm": spec.blocks_per_sm,
             "need_bytes": need, "sm_bytes": _launch.SMEM_SM}))
    return out


# -- launcher signatures ------------------------------------------------

_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _code(param: str) -> str:
    p = " ".join(param.split())
    if "*" in p:
        return "p"
    if p.startswith(("long long", "const long long")):
        return "l"
    if p.startswith(("float", "const float")):
        return "f"
    if p.startswith(("int", "const int")):
        return "i"
    return "?"


def launchers_in(text: str) -> Dict[str, tuple]:
    """``{launcher: argument codes}`` of every ``extern "C" int`` function
    declared in the CUDA source ``text``."""
    text = re.sub(r"//[^\n]*", "", text)
    return {name: tuple(_code(p) for p in params.split(",") if p.strip())
            for name, params in _EXTERN.findall(text)}


@functools.lru_cache(maxsize=None)
def c_launchers(source: str) -> Dict[str, tuple]:
    """:func:`launchers_in` of ``source`` (a path in the repository)."""
    return launchers_in((_REPO / source).read_text())


def _triton_params(source, name):
    """(positional parameter names, constexpr parameter names) of the
    Triton kernel function ``name`` of module ``source``."""
    mod = importlib.import_module(
        source[:-len(".py")].replace("/", "."))
    fn = getattr(mod, name)
    pos, const = [], []
    for p in inspect.signature(fn).parameters.values():
        (const if "constexpr" in str(p.annotation) else pos).append(p.name)
    return pos, const


def _args(spec, program) -> List[Finding]:
    out = []
    for launcher, args in spec.calls:
        if spec.route == "cuda":
            have = c_launchers(spec.source).get(launcher)
            if have == tuple(args):
                continue
            msg = (f"{spec.name}: the wrapper binds {launcher} with "
                   f"argument types {''.join(args)} but "
                   f"{spec.source} declares "
                   + ("no such extern \"C\" launcher" if have is None
                      else "".join(have))
                   + ": a miscounted ctypes signature corrupts memory "
                     "silently on the card")
            detail = {"kernel": spec.name, "launcher": launcher,
                      "wrapper": list(args),
                      "source": None if have is None else list(have)}
        else:
            npos, cnames = args
            try:
                pos, const = _triton_params(spec.source, launcher)
            except (ImportError, AttributeError) as e:
                pos, const = None, None
                why = f"{type(e).__name__}: {e}"
            if pos is not None and len(pos) == npos \
                    and sorted(const) == sorted(cnames):
                continue
            msg = (f"{spec.name}: {launcher} is launched with {npos} "
                   f"positional arguments and constexprs {list(cnames)}; "
                   + (f"its function could not be read ({why})"
                      if pos is None else
                      f"it takes {len(pos)} and {const}"))
            detail = {"kernel": spec.name, "launcher": launcher,
                      "launch": [npos, list(cnames)],
                      "function": None if pos is None
                      else [len(pos), const]}
        out.append(_finding(program, "ARG_MISMATCH",
                            f"{spec.name}/{launcher}", msg, detail))
    return out


def check_launch(spec, program: str = None) -> List[Finding]:
    """Every rule over one launch spec. ``program`` names the audited
    case (the kernel's name by default) and keys the fingerprints."""
    program = program or spec.name
    out: List[Finding] = []
    reads, writes = _accesses(spec, "reads"), _accesses(spec, "writes")
    for op in spec.outputs:
        entries = writes.get(op.name, [])
        out.extend(_oob(spec, program, op, "writes", entries))
        if _malformed(op, entries):
            continue   # the arity finding stands alone
        for f in (_coverage(spec, program, op, entries, "written"),
                  None if op.name in spec.accum_outputs
                  else _race(spec, program, op, entries)):
            if f is not None:
                out.append(f)
    for op in spec.inputs:
        entries = reads.get(op.name, [])
        out.extend(_oob(spec, program, op, "reads", entries))
        if op.paged or _malformed(op, entries):
            continue
        f = (_seen_coverage(spec, program, op, entries) if op.masked
             else _coverage(spec, program, op, entries, "read"))
        if f is not None:
            out.append(f)
    out.extend(_smem(spec, program))
    out.extend(_args(spec, program))
    return out


# -- what a launch must move and do -------------------------------------


def _touched_bytes(op, entries) -> int:
    groups = _groups(entries)
    if not groups:
        return 0
    if len(groups) == 1:
        (tile, coords), = groups.items()
        coords = coords[_in_bounds(op.shape, tile, coords)]
        coords = np.unique(coords, axis=0) if len(coords) else coords
        start = coords * np.asarray(tile, dtype=np.int64)
        size = np.minimum(np.asarray(tile, dtype=np.int64),
                          np.asarray(op.shape, dtype=np.int64) - start)
        n = int(np.prod(size, axis=1).sum()) if len(coords) else 0
    else:
        n = int(_mask(op.shape, groups).sum())
    return n * op.itemsize


def _live(spec, seq_lens):
    """The tokens of the pools each sequence reads: ``seq_lens``, else the
    launch's own (``params["live"]``), else every page of the tables."""
    if seq_lens is not None:
        return [int(n) for n in seq_lens]
    if "live" in spec.params:
        return list(spec.params["live"])
    pool = next(op for op in spec.inputs if op.paged == "tokens")
    table = next(op for op in spec.inputs if op.paged == "pages")
    rows = table.shape[0] if len(table.shape) == 2 else 1
    return [table.shape[-1] * pool.shape[1]] * rows


def _paged_bytes(spec, op, live) -> int:
    pool = next(o for o in spec.inputs if o.paged == "tokens")
    if op.paged == "tokens":
        return sum(live) * int(np.prod(op.shape[2:])) * op.itemsize
    if op.paged == "pages":
        return sum(_cdiv(n, pool.shape[1]) for n in live) * op.itemsize
    return len(live) * int(np.prod(op.shape[1:])) * op.itemsize   # rows


def modeled_launch_bytes(spec, seq_lens: Optional[Sequence[int]] = None
                         ) -> Dict:
    """The bytes one launch must move: each input byte read once and each
    output byte written once, over the union of the tiles its plan
    touches; operands read through the block tables by the live lengths
    (``seq_lens``: the tokens in the pools of each sequence; by default
    the launch's own, or the full tables). Workspaces the kernel keeps
    for itself (partials, the f32 residual) are not the function's
    traffic. Returns ``{"total_bytes", "read_bytes", "written_bytes",
    "operands": [{"operand", "bytes"}, ...]}``."""
    reads, writes = _accesses(spec, "reads"), _accesses(spec, "writes")
    live = None
    read = written = 0
    detail = []
    for role, ops in (("in", spec.inputs), ("out", spec.outputs)):
        for op in ops:
            if op.paged:
                if live is None:
                    live = _live(spec, seq_lens)
                n = _paged_bytes(spec, op, live)
            else:
                n = _touched_bytes(op, (reads if role == "in"
                                        else writes).get(op.name, []))
            if role == "in":
                read += n
            else:
                written += n
            detail.append({"operand": f"{role}:{op.name}", "bytes": n})
    return {"total_bytes": read + written, "read_bytes": read,
            "written_bytes": written, "operands": detail}


def bound(spec, seq_lens: Optional[Sequence[int]] = None, segments=None):
    """``(ms, "bytes" | "operations", bytes, operations)``: the least time
    an H100 could take for the launch, the larger of its bytes
    (:func:`modeled_launch_bytes`) over 3.35 TB/s and the operations this
    launch's data needs (:func:`.kernel_catalog.needed_flops`: causal
    pairs, pairs of one segment given a flash launch's ``segments`` (its
    seg_q and seg_k), live lengths) over the working type's peak."""
    from .kernel_catalog import needed_flops
    nbytes = modeled_launch_bytes(spec, seq_lens)["total_bytes"]
    ops = needed_flops(spec, seq_lens, segments)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[spec.dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


# -- the registry lint ----------------------------------------------------


class _RecordingMeta(Mapping):
    """A meta that records every key a ``supports()`` predicate (or what it
    calls) reads. A membership test counts as a read, and any iteration or
    copy (``dict(meta)``, ``{**meta}``, ``items()``) as reading every key.
    Not a dict subclass: ``dict(subclass)`` skips overridden methods,
    while copying a Mapping goes through the recorded protocol."""

    def __init__(self, data):
        self._data = dict(data)
        self.accessed = set()

    def __getitem__(self, k):
        self.accessed.add(k)
        return self._data[k]

    def get(self, k, default=None):
        self.accessed.add(k)
        return self._data.get(k, default)

    def __contains__(self, k):
        self.accessed.add(k)
        return k in self._data

    def __iter__(self):
        self.accessed.update(self._data)
        return iter(self._data)

    def __len__(self):
        return len(self._data)


def dispatch_key_rule(registry, op: str, meta: Dict,
                      program: str = "kernel_registry") -> List[Finding]:
    """``DISPATCH_KEY_GAP`` (port of the JAX gate's rule): run every
    variant's ``supports()`` of ``op`` over ``meta`` and flag each meta key
    it reads that the op's declared program-key coverage
    (``registry.declare_cache_key``) does not include; an op that never
    declared its coverage, and a predicate that raises, are findings too.
    A ``supports()`` read is an input of dispatch: a program (the serving
    engine's captured decode step) whose key does not cover it would
    replay the route chosen under another value."""
    decl = registry.cache_key_decl(op)
    if decl is None:
        return [_finding(program, "DISPATCH_KEY_GAP", f"{op}:undeclared",
                         f"kernel op {op!r} has supports() dispatch but no "
                         "declare_cache_key() coverage: the lint cannot "
                         "show that its callers' program keys cover every "
                         "dispatch input", {"op": op})]
    fields, covers = decl
    fieldset = set(fields)
    out: List[Finding] = []
    for variant in registry.variants(op):
        if variant.supports is None:
            continue
        rec = _RecordingMeta(meta)
        try:
            variant.supports(rec)
        except Exception as e:  # noqa: BLE001 - a raising predicate is a bug
            out.append(_finding(
                program, "DISPATCH_KEY_GAP", f"{op}/{variant.name}:raised",
                f"supports() of {op}/{variant.name} raised "
                f"{type(e).__name__}: {e}",
                {"op": op, "variant": variant.name,
                 "exception": type(e).__name__}))
            continue
        gap = sorted(k for k in rec.accessed
                     if k not in fieldset and covers.get(k) not in fieldset)
        if gap:
            out.append(_finding(
                program, "DISPATCH_KEY_GAP", f"{op}/{variant.name}",
                f"supports() of {op}/{variant.name} reads meta key(s) "
                f"{gap} that the op's declared program-key coverage does "
                "not include: a changed value would flip dispatch without "
                "a new program; add the key to the caller's program key "
                "and to declare_cache_key()",
                {"op": op, "variant": variant.name, "gap": gap,
                 "accessed": sorted(rec.accessed),
                 "declared": sorted(fieldset)}))
    return out
