"""Launch plans of the port's kernels, and their capture for the
kernel-geometry gate (port of the capture layer of
``paddle_tpu/ops/pallas/_util.py``: ``KernelOperand``,
``KernelLaunchSpec``, ``capture_kernel_launches``).

Every wrapper in ``ops/kernels/`` builds a :class:`KernelLaunchSpec` for
its launch (its *plan*: the grid, the threads, the shared memory, the
work of each phase, the C launcher's argument types) and launches the
kernel with the numbers of that plan. The spec describes the work the
way a ``BlockSpec`` grid does on the TPU, translated for the persistent
grid-stride kernels of this card: a spec holds one :class:`KernelPhase`
per phase of the kernel (a phase between two grid-wide barriers, or the
whole kernel when it has none); a phase runs ``items`` work items, and
for each operand it touches it gives the tile shape and a map from item
index to tile coordinates (:class:`Access`). A map is written so that it
takes one item index or a numpy array of them (``//``, ``%``,
``np.minimum``), so the rules evaluate it over every item at once.

:func:`begin` is the one gateway every launch passes, right before it:
under an active :class:`capture_kernel_launches` it records the spec
(thread-local, nested captures all see it; no cost when none is
active). Given tensors on the ``meta`` device it then tells the wrapper
not to launch: the wrapper returns empty meta outputs of the right
shapes, and no launch is counted. This is the port's ``jax.eval_shape``:
the gate (:mod:`paddle_tpu_torch.analysis.kernel_catalog`) runs every
wrapper over meta tensors on a machine without a card. Outside a
capture, meta tensors raise, as CPU tensors do. A program that replays
launches made once (the serving engine's CUDA graph of its decode step)
records their specs apart while it captures them (``isolated=True``) and
hands them to the active captures at each replay (:func:`report`).

The launch counts: each wrapper counts its launches in ``.launches`` and,
where its kernel has classes (weight, pool, residual or body), in one
store ``.launches_by_class`` keyed by (family, class);
``.launches_by_<family>`` is that family's view of the store
(:func:`counted`, :func:`count`).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections.abc import MutableMapping
from typing import Any, Callable, Dict, Optional, Tuple

import torch

__all__ = ["KernelOperand", "Seen", "Access", "KernelPhase",
           "KernelLaunchSpec", "capture_kernel_launches", "capturing",
           "begin", "report", "check_device", "dtype_name", "whole",
           "rows_access", "flat_access", "triton_spec", "triton_run",
           "counted", "count", "ClassCounts", "H100_SMS", "SMEM_BLOCK",
           "SMEM_SM", "SMEM_RESERVED"]

#: streaming multiprocessors of an H100 SXM
H100_SMS = 132
#: shared memory one block may use (227 KB), one SM holds (228 KB), and
#: what the card reserves of it for each resident block (1 KB)
SMEM_BLOCK = 227 * 1024
SMEM_SM = 228 * 1024
SMEM_RESERVED = 1024


@dataclasses.dataclass(frozen=True)
class KernelOperand:
    """One array a launch reads or writes. ``paged``: how a read that
    depends on the data is counted, for operands no tile map can
    describe: "tokens" (a KV pool [N, BS, KV, hd]: the live tokens of the
    tables), "pages" (a block table: its live entries), "rows" (a rope
    table: one row per sequence, at its length). Paged operands are
    exempt from the input-coverage rule, as the JAX gate exempts
    scalar-prefetch launches. ``masked``: an input read only at the tiles
    a mask lets some query see (a bias under the causal mask: the tiles
    past the diagonal are never needed); its reads must cover those tiles
    (:class:`Seen`), not the whole array; its bytes are the tiles read."""
    name: str
    shape: Tuple[int, ...]
    dtype: str
    paged: Optional[str] = None
    masked: Optional["Seen"] = None

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=getattr(torch, self.dtype)).element_size()


@dataclasses.dataclass(frozen=True)
class Seen:
    """The tiles of a masked input that its mask lets some query see:
    tiles of shape ``tile``, ``seen(coords)`` true for those of the tile
    coordinates ``coords`` ([n, ndim] int64) that some query sees."""
    tile: Tuple[int, ...]
    seen: Callable[[Any], Any]


@dataclasses.dataclass(frozen=True)
class Access:
    """The tiles of one operand that some of a phase's work items touch:
    item ``first + j`` (``j`` below ``items``; by default every item from
    ``first`` on) touches the tile of shape ``tile`` at tile coordinates
    ``index_map(j)``."""
    operand: str
    tile: Tuple[int, ...]
    index_map: Callable[[Any], Tuple]
    first: int = 0
    items: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class KernelPhase:
    """One phase of a kernel: ``items`` work items (a grid-stride loop's
    trip count over the whole grid, or the grid itself), the tiles each
    reads and writes."""
    name: str
    items: int
    reads: Tuple[Access, ...] = ()
    writes: Tuple[Access, ...] = ()


@dataclasses.dataclass(frozen=True)
class KernelLaunchSpec:
    """The plan of one launch, recorded before it is made.

    - ``name``: the TPU launch name it replaces; ``route``: "cuda" or
      "triton"; ``source``: the kernel's file in the repository.
    - ``grid``, ``threads``; ``blocks_per_sm``: the blocks an SM holds at
      once that the kernel is built for (its ``__launch_bounds__``, or
      the co-resident blocks of a cooperative grid); ``cooperative``.
    - ``dyn_smem``, ``static_smem``: shared memory of one block, bytes.
    - ``inputs``, ``outputs``: :class:`KernelOperand`; ``phases``;
      ``accum_outputs``: names of outputs whose tiles several items
      write on purpose.
    - ``calls``: each launcher the wrapper call runs, ``(launcher,
      args)``: for CUDA the C launcher's name and its ctypes argument
      types in order ("p" pointer, "i" int, "l" long long, "f" float);
      for Triton the kernel function's name and ``(positional count,
      constexpr keyword names)``.
    - ``dtype``: the working type (the peak its operations are held
      to); ``params``: the launch's scalar arguments (causal, pos0, ...)
      and ``plan``: the numbers the kernel is launched with.
    """
    name: str
    route: str
    source: str
    grid: Tuple[int, ...]
    threads: int
    inputs: Tuple[KernelOperand, ...]
    outputs: Tuple[KernelOperand, ...]
    phases: Tuple[KernelPhase, ...]
    calls: Tuple[Tuple[str, Tuple], ...]
    dtype: str
    blocks_per_sm: int = 1
    cooperative: bool = False
    dyn_smem: int = 0
    static_smem: int = 0
    accum_outputs: Tuple[str, ...] = ()
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    plan: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def operand(self, name) -> KernelOperand:
        for op in self.inputs + self.outputs:
            if op.name == name:
                return op
        raise KeyError(f"{self.name}: no operand {name!r}")


_CAPTURE = threading.local()
_TRITON_SEEN = set()              # Triton specializations launched so far


_ALL_THREADS = []                 # captures that see every thread
_ALL_LOCK = threading.Lock()


class capture_kernel_launches:
    """``with capture_kernel_launches() as specs: ...`` collects the
    :class:`KernelLaunchSpec` of every launch the block makes (or, over
    meta tensors, would make). Thread-local and nestable: an inner
    capture also feeds the outer ones. ``all_threads=True`` also collects
    the launches other threads make meanwhile: autograd runs a CUDA
    backward on its own device thread, so a training step's backward
    kernels are seen only this way. ``isolated=True`` collects this
    thread's launches for this capture alone, hidden from the captures
    around it (a program recording what it will replay)."""

    def __init__(self, all_threads=False, isolated=False):
        self.specs = []
        self.all_threads = all_threads
        self.isolated = isolated
        self._saved = None

    def __enter__(self):
        if self.all_threads:
            with _ALL_LOCK:
                _ALL_THREADS.append(self.specs)
            return self.specs
        if self.isolated:
            self._saved = (getattr(_CAPTURE, "stack", None),
                           getattr(_CAPTURE, "isolated", False))
            _CAPTURE.stack, _CAPTURE.isolated = [self.specs], True
            return self.specs
        stack = getattr(_CAPTURE, "stack", None)
        if stack is None:
            stack = _CAPTURE.stack = []
        stack.append(self.specs)
        return self.specs

    def __exit__(self, *exc):
        if self.all_threads:
            with _ALL_LOCK:
                _ALL_THREADS.remove(self.specs)
        elif self.isolated:
            _CAPTURE.stack, _CAPTURE.isolated = self._saved
        else:
            _CAPTURE.stack.pop()
        return False


def _sinks():
    """The spec lists of the captures that see this thread's launches."""
    stack = list(getattr(_CAPTURE, "stack", None) or ())
    if getattr(_CAPTURE, "isolated", False):
        return stack
    with _ALL_LOCK:
        return stack + list(_ALL_THREADS)


def capturing() -> bool:
    """Whether a capture is active on this thread (or on all of them)."""
    return bool(_sinks())


def report(specs):
    """Hand ``specs``, launches made again without their wrappers (a
    replayed CUDA graph's), to the active captures, as :func:`begin` would
    have."""
    for sink in _sinks():
        sink.extend(specs)


def check_device(name, device):
    """Raise unless ``device`` is a CUDA device, or the meta device under
    an active capture."""
    if device.type == "cuda" or (device.type == "meta" and capturing()):
        return
    if device.type == "meta":
        raise ValueError(f"{name}: meta tensors are taken only under "
                         "capture_kernel_launches (the gate's plan "
                         "capture); launches need CUDA tensors")
    raise ValueError(f"{name} needs CUDA tensors, got {device}")


def begin(spec: KernelLaunchSpec, device) -> bool:
    """The gateway of every launch, called right before it: records
    ``spec`` in the active captures, and returns whether to launch (True
    for CUDA tensors, False for meta tensors under a capture). Raises for
    any other device."""
    if not getattr(_CAPTURE, "stack", None) and not _ALL_THREADS:
        # the launch path: no capture
        if device.type == "cuda":
            return True
        check_device(spec.name, device)
    for sink in _sinks():
        sink.append(spec)
    check_device(spec.name, device)
    return device.type == "cuda"


class ClassCounts(MutableMapping):
    """One family's view ``{class: count}`` of a wrapper's
    ``launches_by_class`` store, whose keys are (family, class). Setting a
    class the family does not have yet adds it (the flash bodies' classes
    appear as they launch)."""

    def __init__(self, store, family):
        self._store, self._family = store, family

    def __getitem__(self, cls):
        return self._store[(self._family, cls)]

    def __setitem__(self, cls, n):
        self._store[(self._family, cls)] = n

    def __delitem__(self, cls):
        del self._store[(self._family, cls)]

    def __iter__(self):
        return iter([c for f, c in self._store if f == self._family])

    def __len__(self):
        return sum(f == self._family for f, _ in self._store)

    def __repr__(self):
        return repr(dict(self))


def counted(fn, **families):
    """Give wrapper ``fn`` its launch counts: ``fn.launches`` (0), the store
    ``fn.launches_by_class`` with each family's classes at 0, and
    ``fn.launches_by_<family>``, the family's view of the store.
    ``families``: family name -> its classes (may be empty)."""
    fn.launches = 0
    fn.launches_by_class = {(f, c): 0 for f, classes in families.items()
                            for c in classes}
    for f in families:
        setattr(fn, f"launches_by_{f}", ClassCounts(fn.launches_by_class, f))


def count(fn, **classes):
    """One launch of ``fn``'s kernel, in the class given for each family
    (``weight="int8"``, ``body="ring"``, ...)."""
    fn.launches += 1
    store = fn.launches_by_class
    for f, c in classes.items():
        store[(f, c)] = store.get((f, c), 0) + 1


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> "bfloat16": the name a spec records."""
    return str(dtype).replace("torch.", "")


def whole(op: KernelOperand, items=None) -> Access:
    """Item 0 of a phase (or the first ``items``) touches all of ``op``."""
    nd = len(op.shape)
    return Access(op.name, op.shape, lambda i: (0,) * nd, 0,
                  1 if items is None else items)


def triton_run(namespace, spec, args_per_call, **options):
    """Launch the Triton kernels of ``spec`` in order, each as its plan
    says: ``spec.calls[j]`` is ``(kernel function name, (positional count,
    constexpr names))`` and ``spec.plan["launches"][j]`` its ``(grid,
    {constexpr: value}, num_warps)``; ``args_per_call[j]`` its positional
    arguments, whose count must be the spec's. ``namespace``: the kernel
    module's ``globals()`` (``_build.triton_jit``). The first launch of
    each specialization (kernel, constexprs, warps, argument types) is
    timed on the host and counted in ``_build.build_seconds`` (Triton
    compiles it then)."""
    from ._build import add_build_seconds, triton_jit
    for (name, (npos, cnames)), (grid, consts, warps), args in zip(
            spec.calls, spec.plan["launches"], args_per_call):
        if len(args) != npos or tuple(consts) != tuple(cnames):
            raise ValueError(f"{spec.name}: {name} launched with "
                             f"{len(args)} arguments and {tuple(consts)}, "
                             f"its spec says {npos} and {cnames}")
        key = (name, tuple(consts.items()), warps,
               tuple(getattr(a, "dtype", type(a)) for a in args))
        first = key not in _TRITON_SEEN
        t0 = time.perf_counter() if first else 0.0
        triton_jit(namespace, name)[grid](*args, **consts, num_warps=warps,
                                          **options)
        if first:
            _TRITON_SEEN.add(key)
            add_build_seconds(time.perf_counter() - t0)


def triton_spec(name, source, dtype, phases, inputs, outputs, launches,
                params=None):
    """The spec of a wrapper call that runs Triton kernels: ``launches``,
    one ``(kernel function name, positional count, grid, {constexpr:
    value}, num_warps)`` per kernel, in order; the first one's grid is the
    spec's."""
    calls = tuple((fn, (npos, tuple(consts)))
                  for fn, npos, _, consts, _ in launches)
    plan = {"launches": tuple((grid, dict(consts), warps)
                              for _, _, grid, consts, warps in launches)}
    return KernelLaunchSpec(
        name, "triton", source, tuple(launches[0][2]), 32 * launches[0][4],
        tuple(inputs), tuple(outputs), tuple(phases), calls, dtype,
        params=dict(params or {}), plan=plan)


def rows_access(op, rows_per_item=1):
    """Item ``i`` touches rows [i * rows_per_item, ...) of the 2-D ``op``,
    every column."""
    return Access(op.name, (rows_per_item, op.shape[1]), lambda i: (i, 0))


def flat_access(op, block):
    """Item ``i`` touches elements [i * block, (i + 1) * block) of the 1-D
    ``op``."""
    return Access(op.name, (block,), lambda i: (i,))
