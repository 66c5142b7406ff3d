"""Kernel registry: variant dispatch by shape class (port of
``paddle_tpu/ops/pallas/registry.py``).

An OP (e.g. ``decode_attn_block``) owns several VARIANTS (a hand-written
CUDA kernel, a composition of the port's smaller kernels, ...), each with
a ``supports`` predicate over a static meta dict (shapes, types, device).
``dispatch`` returns the highest-priority supported variant, or raises
with every variant's reason when none supports the meta. The decode
step's ops register the hand-written kernel (CUDA tensors, a
shared-memory need the card can meet, a supported head dim) and the
priority-0 composition (CPU tensors only), so a refused kernel on the
card raises rather than running the composition in its place.

``force()`` pins an op to a named variant for a ``with`` block,
bypassing ``supports``; pins stack and are per thread. ``forced_state()``
and ``pinned()`` carry a thread's pins to another thread: the autograd
engine runs a CUDA backward (and a checkpointed layer's recomputation) in
a thread of its own.

A program that bakes a dispatch choice in keys its cache by everything
dispatch reads, as the JAX package's jitted programs do: the serving
engine's captured decode step (a CUDA graph) by ``forced_state()``, the
pins dispatch consults, and by the shapes, types and classes that are
fixed when the engine is built. ``declare_cache_key`` states, per op,
the meta keys its callers' program keys cover; the ``DISPATCH_KEY_GAP``
lint (:func:`paddle_tpu_torch.analysis.kernel_rules.dispatch_key_rule`)
holds every ``supports()`` predicate to that declaration.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["KernelVariant", "KernelRegistry", "KERNELS", "fused_train_mode",
           "dispatch_fused_variant"]


@dataclass
class KernelVariant:
    """One implementation of an op. ``supports(meta)`` returns True,
    False, or a (bool, reason) pair; it must be pure in ``meta``."""
    op: str
    name: str
    fn: Callable
    priority: int = 0
    supports: Optional[Callable[[Dict[str, Any]], Any]] = None

    def check(self, meta: Dict[str, Any]):
        """-> (supported: bool, reason: str)."""
        if self.supports is None:
            return True, "unconditional"
        r = self.supports(dict(meta))
        if isinstance(r, tuple):
            ok, reason = r
            return bool(ok), str(reason)
        return bool(r), ("supported" if r else "unsupported")


class KernelRegistry:
    """op name -> priority-ordered variants. Registration is latest-wins
    per (op, variant): a re-registration replaces, never duplicates."""

    def __init__(self):
        self._ops: Dict[str, List[KernelVariant]] = {}
        self._forced = threading.local()
        self._cache_keys: Dict[str, Tuple[Tuple[str, ...],
                                          Dict[str, str]]] = {}

    def register(self, op: str, name: str, fn: Callable, *,
                 priority: int = 0, supports=None) -> KernelVariant:
        var = KernelVariant(op=op, name=name, fn=fn, priority=priority,
                            supports=supports)
        lst = [v for v in self._ops.get(op, []) if v.name != name]
        lst.append(var)
        lst.sort(key=lambda v: -v.priority)
        self._ops[op] = lst
        return var

    def declare_cache_key(self, op: str, fields, covers=None) -> None:
        """Declare the meta keys that the program keys of ``op``'s callers
        cover: explicitly (the serving engine's decode-program key holds
        ``forced_state()``) or because the caller's program is built for
        them and never sees another value (the shapes, types and classes
        an engine fixes in its constructor). ``covers`` maps a derived key
        to the declared key that subsumes it (``{"itemsize": "dtype"}``).
        The ``DISPATCH_KEY_GAP`` lint flags any meta key a ``supports()``
        reads that the declaration does not cover."""
        self._cache_keys[op] = (tuple(fields), dict(covers or {}))

    def cache_key_decl(self, op: str):
        """(declared fields, covers) of ``op``, or None if it never
        declared its program-key coverage."""
        return self._cache_keys.get(op)

    def ops(self) -> List[str]:
        return sorted(self._ops)

    def variant(self, op: str, name: str) -> KernelVariant:
        for v in self._ops.get(op, []):
            if v.name == name:
                return v
        raise KeyError(f"kernel op {op!r} has no variant {name!r} "
                       f"(registered: {[v.name for v in self._ops.get(op, [])]})")

    def variants(self, op: str) -> List[KernelVariant]:
        return list(self._ops.get(op, []))

    def force(self, op: str, name: str):
        """Context manager pinning ``op`` to variant ``name`` (bypasses
        ``supports``: the caller asserts legality). Nested forces stack;
        exit restores the previous pin."""
        registry = self
        registry.variant(op, name)       # fail fast on a typo'd name

        class _Force:
            def __enter__(self_f):
                stack = getattr(registry._forced, "stack", None)
                if stack is None:
                    stack = registry._forced.stack = []
                stack.append((op, name))
                return registry

            def __exit__(self_f, *exc):
                registry._forced.stack.pop()
                return False
        return _Force()

    def forced_state(self) -> Tuple[Tuple[str, str], ...]:
        """This thread's (op, variant) pins, innermost last: an immutable
        snapshot. Dispatch consults the pins when a program is built, so
        a program cache keys on this snapshot: a program built under a
        pin is never replayed for calls without it (and the reverse)."""
        return tuple(getattr(self._forced, "stack", None) or ())

    @contextlib.contextmanager
    def pinned(self, pins):
        """Context manager that re-enters ``pins`` (from
        :meth:`forced_state`, possibly of another thread) on this
        thread."""
        stack = getattr(self._forced, "stack", None)
        if stack is None:
            stack = self._forced.stack = []
        n = len(stack)
        stack.extend(pins)
        try:
            yield self
        finally:
            del stack[n:]

    def _forced_for(self, op: str) -> Optional[str]:
        for o, n in reversed(getattr(self._forced, "stack", None) or []):
            if o == op:
                return n
        return None

    def dispatch(self, op: str, meta: Dict[str, Any]
                 ) -> Tuple[str, Callable]:
        """Highest-priority supported variant -> (name, fn). Raises if
        the op is unknown or no variant supports ``meta``."""
        forced = self._forced_for(op)
        if forced is not None:
            return forced, self.variant(op, forced).fn
        cands = self._ops.get(op)
        if not cands:
            raise KeyError(f"no kernel variants registered for {op!r}")
        for v in cands:
            ok, _ = v.check(meta)
            if ok:
                return v.name, v.fn
        raise RuntimeError(
            f"no variant of {op!r} supports meta={meta!r}: "
            + "; ".join(f"{v.name}: {v.check(meta)[1]}" for v in cands))

    def explain(self, op: str, meta: Dict[str, Any]) -> List[Dict]:
        """Per variant: name, priority, supported, reason, selected."""
        sel = None
        try:
            sel, _ = self.dispatch(op, meta)
        except (KeyError, RuntimeError):
            pass
        out = []
        for v in self._ops.get(op, []):
            ok, reason = v.check(meta)
            out.append({"name": v.name, "priority": v.priority,
                        "supported": ok, "reason": reason,
                        "selected": v.name == sel})
        return out


KERNELS = KernelRegistry()


def fused_train_mode(mode=None) -> str:
    """Normalise a fused-train mode knob to ``auto | pallas | ref`` (port
    of ``paddle_tpu/ops/pallas/_util.py``'s ``fused_train_mode``).

    ``None``/``True``/"auto" mean registry dispatch (the JAX package's
    ``FLAGS_fused_train`` default; the port has no global flag);
    ``False``/``0``/"ref" pin the unfused composition; "pallas"/"force"
    pin the hand-written kernels."""
    if mode in (False, 0, "ref"):
        return "ref"
    if mode in ("pallas", "force"):
        return "pallas"
    if mode in (True, 1, None, "auto"):
        return "auto"
    raise ValueError(
        f"fused_train mode must be auto|pallas|ref, got {mode!r}")


def dispatch_fused_variant(op: str, meta, mode=None):
    """The one fused-training mode contract: ``op`` resolved to a callable
    -- registry dispatch in "auto", the pinned ``"cuda_fused"`` kernel
    variant for "pallas", the ``"unfused"`` composition for "ref"."""
    mode = fused_train_mode(mode)
    if mode == "auto":
        return KERNELS.dispatch(op, meta)[1]
    return KERNELS.variant(
        op, "cuda_fused" if mode == "pallas" else "unfused").fn
