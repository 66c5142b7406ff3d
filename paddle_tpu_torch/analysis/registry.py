"""Program registry: named programs and their abstract signatures (port of
``paddle_tpu/analysis/registry.py``).

The auditor never wants live tensors: a program is auditable from its
callable and the *abstract* signature it is called with. A tensor leaf
becomes a :class:`TensorStruct` (shape, dtype, device, whether it
requires a gradient), which the auditor turns into a fake tensor; any
other leaf (an int, a float, a generator, a config) stays as it is, and is
a constant of the traced program, frozen as a CUDA graph freezes it.
:class:`ProgramSpec` records the signature with the static metadata the
rule passes read: the arguments the program writes in place (a captured
program's donation: ``donate_argnums``), static argument values, the mesh
axes its collectives may name, the carry map (which outputs are written
back into which inputs for the next call), and ``device``, the device the
spec traces on (None: each leaf's own).

A module-level :data:`REGISTRY` collects the specs the port's components
hand over (``Trainer.audit``, ``ServingEngine.audit``, the catalog
functions of :mod:`.catalog`), so the CLI (:mod:`.program_audit`) audits
one shared set.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

__all__ = ["TensorStruct", "ProgramSpec", "ProgramRegistry", "REGISTRY",
           "abstract_signature", "signature_key", "register_program",
           "carry_map", "leaf_offsets"]


@dataclass(frozen=True)
class TensorStruct:
    """The abstract value of one tensor argument (the port's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device = torch.device("cpu")
    requires_grad: bool = False


def _abstract_leaf(v):
    if isinstance(v, torch.Tensor):
        return TensorStruct(tuple(int(s) for s in v.shape), v.dtype,
                            v.device, bool(v.requires_grad))
    return v


def abstract_signature(tree):
    """A tree of tensors -> the same tree of :class:`TensorStruct` (other
    leaves kept). Works on live tensors and on structs already."""
    return pytree.tree_map(_abstract_leaf, tree)


def _leaf_key(v):
    if isinstance(v, (torch.Tensor, TensorStruct)):
        return (tuple(int(s) for s in v.shape), str(v.dtype),
                str(v.device))
    return ((), type(v).__name__, "")


def signature_key(args: Tuple, kwargs: Dict) -> Tuple:
    """Hashable (tree structure, per-leaf (shape, dtype, device)) key of a
    call signature: the retrace-hazard rule compares these. Every distinct
    key is one capture of the program (and one memory pool)."""
    leaves, spec = pytree.tree_flatten((tuple(args), dict(kwargs or {})))
    return (repr(spec), tuple(_leaf_key(v) for v in leaves))


def leaf_offsets(args: Tuple) -> List[Tuple[int, int]]:
    """(first flat leaf, leaf count) of each positional argument, in the
    flat order the auditor numbers inputs (``args`` then ``kwargs``)."""
    out, off = [], 0
    for a in args:
        n = len(pytree.tree_leaves(a))
        out.append((off, n))
        off += n
    return out


def carry_map(args: Tuple, out_to_arg: Dict[int, int]) -> Dict[int, int]:
    """A carry declared by argument (output position -> argnum, the JAX
    package's class-level maps) as flat leaves: output ``o`` has the tree
    of argument ``out_to_arg[o]``, leaf for leaf; the outputs are numbered
    in order, each the size of its argument."""
    offs = leaf_offsets(args)
    flat, o_off = {}, 0
    for o in sorted(out_to_arg):
        a_off, n = offs[out_to_arg[o]]
        for j in range(n):
            flat[o_off + j] = a_off + j
        o_off += n
    return flat


@dataclass
class ProgramSpec:
    """One auditable program: callable, abstract call signature and the
    static metadata of the rule passes.

    ``donate_argnums``: the arguments the program writes in place (a
    captured program's donation: a CUDA graph writes the buffers it was
    captured with). ``carry`` maps a flat OUTPUT leaf to the flat INPUT
    leaf it is written back into for the next call; the retrace-hazard
    rule compares the pair (a ``copy_`` would cast or broadcast a drift
    without a word). ``axis_env`` is kept for the JAX spec's fields: the
    port's per-shard bodies name their mesh's axis themselves, so the
    trace binds nothing. ``device``: the device the spec's tensors are
    faked on (None: each struct's own); "meta" traces the kernel routes on
    a machine without a card, as the kernel gate does."""
    name: str
    fn: Callable
    args: Tuple = ()
    kwargs: Dict = field(default_factory=dict)
    donate_argnums: Tuple[int, ...] = ()
    static_argnums: Tuple[int, ...] = ()
    static_argvals: Tuple = ()
    mesh_axes: Tuple[str, ...] = ()
    axis_env: Tuple[Tuple[str, int], ...] = ()
    carry: Optional[Dict[int, int]] = None
    tags: Tuple[str, ...] = ()
    signatures: List[Tuple] = field(default_factory=list)
    device: Optional[Any] = None

    def record_signature(self, args: Tuple = None, kwargs: Dict = None):
        """Record one observed call signature (deduplicated). With no
        arguments, records the spec's own."""
        args = self.args if args is None else args
        kwargs = self.kwargs if kwargs is None else (kwargs or {})
        key = signature_key(args, kwargs)
        if key not in self.signatures:
            self.signatures.append(key)
        return key


class ProgramRegistry:
    """Name -> :class:`ProgramSpec`, latest registration wins."""

    def __init__(self):
        self._specs: Dict[str, ProgramSpec] = {}

    def register(self, spec: ProgramSpec) -> ProgramSpec:
        spec.record_signature()
        old = self._specs.get(spec.name)
        if old is not None and old.fn is spec.fn:
            # the same program registered again (Trainer.audit after its
            # steps recorded their signatures): keep the history, or
            # MULTIPLE_SIGNATURES goes blind. Another callable under the
            # name is another program and starts fresh.
            for sig in old.signatures:
                if sig not in spec.signatures:
                    spec.signatures.append(sig)
        self._specs[spec.name] = spec
        return spec

    def record_signature(self, name: str, *args, **kwargs):
        spec = self._specs.get(name)
        if spec is not None:
            spec.record_signature(abstract_signature(args),
                                  abstract_signature(kwargs))

    def get(self, name: str) -> Optional[ProgramSpec]:
        return self._specs.get(name)

    def names(self) -> List[str]:
        return sorted(self._specs)

    def specs(self) -> List[ProgramSpec]:
        return [self._specs[n] for n in self.names()]

    def remove(self, name: str):
        self._specs.pop(name, None)

    def clear(self):
        self._specs.clear()

    def __len__(self):
        return len(self._specs)

    def __contains__(self, name: str) -> bool:
        return name in self._specs


REGISTRY = ProgramRegistry()


def register_program(name: str, fn: Callable, *args,
                     registry: Optional[ProgramRegistry] = None,
                     **meta) -> ProgramSpec:
    """Build a spec with an abstracted signature and register it.
    ``meta`` forwards ProgramSpec fields (donate_argnums, mesh_axes,
    carry, tags, device...)."""
    kwargs = meta.pop("kwargs", {})
    spec = ProgramSpec(name=name, fn=fn,
                       args=tuple(abstract_signature(args)),
                       kwargs=dict(abstract_signature(kwargs)), **meta)
    return (registry if registry is not None else REGISTRY).register(spec)
