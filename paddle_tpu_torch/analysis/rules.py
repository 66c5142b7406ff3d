"""The gate's finding schema and the program rule passes (port of
``paddle_tpu/analysis/rules.py``).

A program's artifact is the aten-level ``torch.fx`` graph of
``make_fx(fn, tracing_mode="fake")`` over the spec's arguments as fake
tensors (:func:`paddle_tpu_torch.analysis.auditor.trace_artifacts`), with
the input and output metas, the inputs the graph writes in place (read
from each node's schema alias info, ``(a!)``, through views), the kernel
launches (one ``paddle_tpu_torch.kernel_launch`` node each) and the
collectives (one ``paddle_tpu_torch.collective`` node each). Each rule is
a pure function ``rule(art: ProgramArtifacts, **cfg) -> List[Finding]``;
none executes anything.

The rules and the bug class each catches, with the JAX codes:

- ``dtype_promotion``: ``F64_PROMOTION``, a float64 value in a program
  whose inputs are at most f32, read from a second trace under
  ``torch.set_default_dtype(torch.float64)`` (the JAX x64 probe: it widens
  every tensor made from a bare Python float); ``BF16_UPCAST_BLOAT``,
  bf16 -> f32 conversions of at least ``upcast_min_bytes`` (8 MiB).
- ``donation``: ``DONATED_UNALIASED``, an argument declared in place that
  the graph never writes; ``DONATABLE_NOT_DONATED``, an input of at least
  1 MiB with the shape and type of an output the graph allocates fresh,
  so that a captured program's pool holds both.
- ``retrace_hazard`` (a recapture, in the port): ``MULTIPLE_SIGNATURES``,
  more than one recorded signature, each a capture and a pool;
  ``FLOAT_STATIC_ARG``, a Python float argument, frozen into a capture;
  ``CARRY_DTYPE_DRIFT``/``CARRY_SHAPE_DRIFT``, a carried output whose type
  or shape differs from the buffer it is written back into, which
  ``copy_`` casts or broadcasts without a word.
- ``collective_consistency``: ``UNKNOWN_COLLECTIVE_AXIS``, a mesh
  collective naming an axis that is not in the spec's ``mesh_axes``.
- ``constant_bloat``: ``LARGE_CONSTANT``, a tensor constant of at least
  1 MiB in the graph: a tensor closed over or built from host data in the
  body, which a capture freezes.

The JAX codes with no torch counterpart are dropped (:data:`DROPPED_CODES`,
with the reason of each): ``CARRY_WEAK_DRIFT`` (a torch tensor has no weak
type), ``COND_COLLECTIVE_DIVERGENCE`` and ``COLLECTIVE_IN_WHILE`` (an fx
trace specialises Python control flow: it holds no cond or while to read;
revisited with the multi-process backend, ROADMAP A11).

Finding identity (``fingerprint``) is ``program::rule::code::site``, with
``site`` a rule-chosen stable discriminator: the baseline diff of
:mod:`.auditor` keys on it, so message wording can change without
churning a baseline.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["Finding", "SEVERITIES", "ProgramArtifacts", "ALL_RULES",
           "RULE_CODES", "DROPPED_CODES", "dtype_promotion_rule",
           "donation_rule", "retrace_hazard_rule",
           "collective_consistency_rule", "constant_bloat_rule",
           "node_val", "alias_root", "written_inputs"]

SEVERITIES = ("error", "warning", "info")

#: each rule's codes
RULE_CODES = {
    "dtype_promotion": ("F64_PROMOTION", "BF16_UPCAST_BLOAT"),
    "donation": ("DONATED_UNALIASED", "DONATABLE_NOT_DONATED"),
    "retrace_hazard": ("MULTIPLE_SIGNATURES", "FLOAT_STATIC_ARG",
                       "CARRY_DTYPE_DRIFT", "CARRY_SHAPE_DRIFT"),
    "collective_consistency": ("UNKNOWN_COLLECTIVE_AXIS",),
    "constant_bloat": ("LARGE_CONSTANT",),
}

#: the JAX codes the port does not have, with the reason
DROPPED_CODES = {
    "CARRY_WEAK_DRIFT": "a torch tensor has no weak type: a carried value "
                        "is a buffer of one dtype",
    "COND_COLLECTIVE_DIVERGENCE": "an fx trace specialises Python control "
                                  "flow: the graph holds no cond to read "
                                  "(revisit with ROADMAP A11's "
                                  "multi-process backend)",
    "COLLECTIVE_IN_WHILE": "an fx trace unrolls Python loops: the graph "
                           "holds no while to read (revisit with ROADMAP "
                           "A11's multi-process backend)",
}


@dataclass
class Finding:
    """One audit finding. ``to_dict()`` is the FROZEN export schema:
    rule, code, severity, program, site, message, detail, fingerprint."""
    rule: str
    code: str
    severity: str
    program: str
    message: str
    site: str = ""
    detail: Dict = field(default_factory=dict)

    @property
    def fingerprint(self) -> str:
        return f"{self.program}::{self.rule}::{self.code}::{self.site}"

    def to_dict(self) -> Dict:
        return {"rule": self.rule, "code": self.code,
                "severity": self.severity, "program": self.program,
                "site": self.site, "message": self.message,
                "detail": dict(self.detail),
                "fingerprint": self.fingerprint}


@dataclass
class ProgramArtifacts:
    """What every rule reads about one traced program.

    - ``graph``: the ``GraphModule`` of the ambient trace; ``graph_f64``
      the trace under the float64 default dtype (None when the probe was
      off or failed);
    - ``in_metas``/``out_metas``: one entry per flat input leaf (``args``
      then ``kwargs``) and per flat output leaf: a
      :class:`~.registry.TensorStruct`, or None for a leaf that is not a
      tensor; ``*_f64`` the probe's;
    - ``written``: per flat input, whether the graph writes it in place;
      ``declared``: per flat input, whether the spec declares it so;
    - ``out_fresh``: per flat output, whether the graph allocates it (it is
      no input or view of one);
    - ``launches``: the launch names of the ``kernel_launch`` nodes in
      graph order; ``plans``: the kernel plans recorded during the trace;
      ``collectives``: (op, axis) of each ``collective`` node;
      ``f64_site``: the source line of the port where the probe's first
      float64 value was made."""
    spec: object
    graph: object
    graph_f64: Optional[object] = None
    in_metas: Tuple = ()
    out_metas: Tuple = ()
    in_metas_f64: Tuple = ()
    out_metas_f64: Tuple = ()
    written: Tuple[bool, ...] = ()
    declared: Tuple[bool, ...] = ()
    out_fresh: Tuple[bool, ...] = ()
    launches: Tuple[str, ...] = ()
    plans: Tuple = ()
    collectives: Tuple[Tuple[str, str], ...] = ()
    f64_site: Optional[str] = None


# -- graph walking ------------------------------------------------------


def node_val(n):
    """The fake value a node produced (a tensor, a list of them, ...)."""
    return n.meta.get("val") if hasattr(n, "meta") else None


def _schema(n):
    return getattr(n.target, "_schema", None) \
        if n.op == "call_function" else None


def alias_root(n):
    """The node ``n`` is a view or in-place result of, followed back
    through every op whose return aliases an argument (views, ``copy_``,
    ``index_copy_``, ...), and through ``getitem`` of a list of views: a
    placeholder when ``n`` is an input's storage."""
    while isinstance(n, torch.fx.Node) and n.op == "call_function":
        if n.target is operator.getitem:
            n = n.args[0]
            continue
        sch = _schema(n)
        if sch is None or not sch.returns \
                or sch.returns[0].alias_info is None:
            return n
        nxt = None
        for a, v in zip(sch.arguments, n.args):
            if a.alias_info is not None and isinstance(v, torch.fx.Node):
                nxt = v
                break
        if nxt is None:
            return n
        n = nxt
    return n


def written_inputs(gm) -> set:
    """The placeholder names the graph writes in place: every argument
    marked written (``(a!)``) in an op's schema, followed back to its
    root."""
    out = set()
    for n in gm.graph.nodes:
        sch = _schema(n)
        if sch is None:
            continue
        vals = {}
        for i, a in enumerate(sch.arguments):
            if i < len(n.args):
                vals[a.name] = n.args[i]
            elif a.name in n.kwargs:
                vals[a.name] = n.kwargs[a.name]
        for a in sch.arguments:
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            v = vals.get(a.name)
            for item in (v if isinstance(v, (list, tuple)) else (v,)):
                if isinstance(item, torch.fx.Node):
                    r = alias_root(item)
                    if r.op == "placeholder":
                        out.add(r.name)
    return out


def _dtype(x):
    return getattr(x, "dtype", None)


def _is_wide_float(dt) -> bool:
    return dt in (torch.float64, torch.complex128)


def _nbytes(x) -> int:
    dt = _dtype(x)
    if not isinstance(dt, torch.dtype):
        return 0
    n = 1
    for s in getattr(x, "shape", ()):
        n *= int(s)
    return n * torch.empty((), dtype=dt).element_size()


def _aval_str(a) -> str:
    dt = _dtype(a)
    name = str(dt).replace("torch.", "") if dt is not None else "?"
    return f"{name}{[int(s) for s in getattr(a, 'shape', ())]}"


def _op_name(n) -> str:
    if n.op == "get_attr":
        return "const"
    return str(n.target)


def _tensor_vals(n):
    v = node_val(n)
    vals = v if isinstance(v, (list, tuple)) else (v,)
    return [x for x in vals if isinstance(x, torch.Tensor)]


# -- rule 1: dtype promotion --------------------------------------------

_UPCASTS = ("aten._to_copy.default", "aten.to.dtype",
            "aten.to.dtype_layout", "aten.copy_.default",
            "aten.copy.default")


def dtype_promotion_rule(art: ProgramArtifacts, *,
                         upcast_min_bytes: int = 8 << 20) -> List[Finding]:
    """f64 values in a <= f32-input program; large bf16 -> f32 upcasts."""
    out: List[Finding] = []
    name = art.spec.name
    probed = art.graph_f64 is not None
    gm = art.graph_f64 if probed else art.graph
    in_metas = art.in_metas_f64 if probed else art.in_metas
    if gm is not None and not any(_is_wide_float(_dtype(a))
                                  for a in in_metas if a is not None):
        offenders = []
        for n in gm.graph.nodes:
            if n.op not in ("call_function", "get_attr"):
                continue
            for v in _tensor_vals(n):
                # a value with no element holds nothing to widen (torch's
                # checkpoint makes a [0] placeholder in the default dtype);
                # whatever it feeds that holds data is flagged itself
                if _is_wide_float(v.dtype) and v.numel():
                    offenders.append((_op_name(n), _aval_str(v)))
        if offenders:
            prim, aval = offenders[0]
            out.append(Finding(
                rule="dtype_promotion", code="F64_PROMOTION",
                severity="error", program=name, site=f"{prim}:{aval}",
                message=(
                    f"{len(offenders)} float64 value(s) inside a program "
                    f"whose inputs are all <= float32 (first: {prim} -> "
                    f"{aval}): a tensor made from a Python float took the "
                    "default dtype (the `1 - b1**step` AdamW class); "
                    "under a float64 default the state widens"),
                detail={"f64_ops": len(offenders),
                        "first_primitive": prim, "first_aval": aval,
                        "first_site": art.f64_site, "probed_f64": probed}))
    total, count, first = 0, 0, None
    for n in art.graph.graph.nodes:
        if n.op != "call_function" or str(n.target) not in _UPCASTS:
            continue
        copy = "copy" in str(n.target)
        src = n.args[1] if copy and len(n.args) > 1 else n.args[0]
        if not isinstance(src, torch.fx.Node):
            continue
        s, d = node_val(src), node_val(n)
        if _dtype(s) == torch.bfloat16 and _dtype(d) == torch.float32 \
                and _nbytes(d) >= upcast_min_bytes:
            count += 1
            total += _nbytes(d)
            if first is None:
                first = _aval_str(d)
    if count:
        out.append(Finding(
            rule="dtype_promotion", code="BF16_UPCAST_BLOAT",
            severity="info", program=name, site=f"bf16->f32:{first}",
            message=(f"{count} bf16->f32 upcast(s) totalling "
                     f"{total >> 20} MiB of f32 output (first: {first}): "
                     "fine for master-weight math, silent memory and "
                     "bandwidth anywhere else"),
            detail={"upcasts": count, "total_bytes": total,
                    "first_aval": first}))
    return out


# -- rule 2: donation ---------------------------------------------------


def donation_rule(art: ProgramArtifacts, *,
                  min_bytes: int = 1 << 20) -> List[Finding]:
    """Declared in-place arguments against what the graph writes, and
    fresh outputs an undeclared input could have held."""
    out: List[Finding] = []
    name = art.spec.name
    ins, outs = art.in_metas, art.out_metas
    if len(art.declared) != len(ins) or len(art.written) != len(ins):
        return out
    key = lambda a: (tuple(a.shape), a.dtype)          # noqa: E731
    free = [j for j, o in enumerate(outs)
            if o is not None and j < len(art.out_fresh) and art.out_fresh[j]]

    def claim(a) -> bool:
        for j in free:
            if key(outs[j]) == key(a):
                free.remove(j)
                return True
        return False

    for i, a in enumerate(ins):
        if a is None or not art.declared[i]:
            continue
        claim(a)       # a declared buffer holds a matching fresh output
        if not art.written[i]:
            out.append(Finding(
                rule="donation", code="DONATED_UNALIASED",
                severity="warning", program=name,
                site=f"arg{i}:{_aval_str(a)}",
                message=(f"input {i} ({_aval_str(a)}) is declared written "
                         "in place, and the program never writes it: the "
                         "declaration is wrong, or the write went to a "
                         "copy"),
                detail={"flat_arg": i, "aval": _aval_str(a),
                        "bytes": _nbytes(a)}))
    for i, a in enumerate(ins):
        if a is None or art.declared[i] or art.written[i] \
                or _nbytes(a) < min_bytes:
            continue
        if claim(a):
            out.append(Finding(
                rule="donation", code="DONATABLE_NOT_DONATED",
                severity="warning", program=name,
                site=f"arg{i}:{_aval_str(a)}",
                message=(f"input {i} ({_aval_str(a)}, "
                         f"{_nbytes(a) >> 20} MiB) matches an output the "
                         "program allocates fresh: a captured program "
                         "holds both copies where it could write in "
                         "place"),
                detail={"flat_arg": i, "aval": _aval_str(a),
                        "bytes": _nbytes(a)}))
    return out


# -- rule 3: retrace (recapture) hazards --------------------------------


def retrace_hazard_rule(art: ProgramArtifacts) -> List[Finding]:
    """Signature drift, float statics, and carry drift."""
    out: List[Finding] = []
    spec = art.spec
    name = spec.name
    sigs = list(getattr(spec, "signatures", ()) or ())
    if len(sigs) > 1:
        out.append(Finding(
            rule="retrace_hazard", code="MULTIPLE_SIGNATURES",
            severity="warning", program=name, site="signatures",
            message=(f"{len(sigs)} distinct call signatures recorded: "
                     "each is one capture of the program and one memory "
                     "pool; steady state should see one"),
            detail={"signatures": len(sigs)}))
    from torch.utils import _pytree as pytree
    floats = [(f"static{i}", v) for i, v in
              enumerate(getattr(spec, "static_argvals", ()) or ())
              if isinstance(v, float)]
    leaves = pytree.tree_leaves((tuple(spec.args), dict(spec.kwargs)))
    floats += [(f"arg{i}", v) for i, v in enumerate(leaves)
               if isinstance(v, float)]
    for site, v in floats:
        out.append(Finding(
            rule="retrace_hazard", code="FLOAT_STATIC_ARG",
            severity="warning", program=name, site=site,
            message=(f"argument {site} is a Python float ({v!r}): a capture "
                     "freezes it, so every new value needs a new program; "
                     "pass it as a device word"),
            detail={"site": site, "value": v}))
    carry = getattr(spec, "carry", None)
    if carry:
        probed = art.graph_f64 is not None and bool(art.out_metas_f64)
        ins = art.in_metas_f64 if probed else art.in_metas
        outs = art.out_metas_f64 if probed else art.out_metas
        for o, i in sorted(carry.items()):
            if o >= len(outs) or i >= len(ins) or outs[o] is None \
                    or ins[i] is None:
                continue
            oa, ia = outs[o], ins[i]
            detail = {"out_index": o, "in_index": i,
                      "out_aval": _aval_str(oa), "in_aval": _aval_str(ia)}
            if oa.dtype != ia.dtype:
                out.append(Finding(
                    rule="retrace_hazard", code="CARRY_DTYPE_DRIFT",
                    severity="error", program=name, site=f"out{o}->in{i}",
                    message=(f"carried state drifts dtype: output {o} "
                             f"({_aval_str(oa)}) is written back into input "
                             f"{i} ({_aval_str(ia)}): copy_ casts it "
                             "silently"),
                    detail=dict(detail, probed_f64=probed)))
            elif tuple(oa.shape) != tuple(ia.shape):
                out.append(Finding(
                    rule="retrace_hazard", code="CARRY_SHAPE_DRIFT",
                    severity="error", program=name, site=f"out{o}->in{i}",
                    message=(f"carried state drifts shape: output {o} "
                             f"({_aval_str(oa)}) is written back into input "
                             f"{i} ({_aval_str(ia)}): copy_ broadcasts it "
                             "silently"),
                    detail=detail))
    return out


# -- rule 4: collective consistency -------------------------------------


def collective_consistency_rule(art: ProgramArtifacts) -> List[Finding]:
    out: List[Finding] = []
    name = art.spec.name
    axes = set(getattr(art.spec, "mesh_axes", ()) or ())
    seen: Dict[str, int] = {}
    for op, ax in art.collectives:
        if ax not in axes:
            seen[f"{op}@{ax}"] = seen.get(f"{op}@{ax}", 0) + 1
    for site, n in seen.items():
        op, ax = site.split("@", 1)
        out.append(Finding(
            rule="collective_consistency", code="UNKNOWN_COLLECTIVE_AXIS",
            severity="error", program=name, site=site,
            message=(f"{n} {op} call(s) over axis {ax!r}, which the "
                     f"program's mesh does not have (declared axes: "
                     f"{sorted(axes)}): it cannot run on the declared "
                     "mesh"),
            detail={"primitive": op, "axis": ax, "calls": n,
                    "in_scope": sorted(axes)}))
    return out


# -- rule 5: constant bloat ---------------------------------------------


def constant_bloat_rule(art: ProgramArtifacts, *,
                        min_bytes: int = 1 << 20) -> List[Finding]:
    out: List[Finding] = []
    name = art.spec.name
    n = 0
    for node in art.graph.graph.nodes:
        if node.op != "get_attr":
            continue
        c = getattr(art.graph, node.target, None)
        if not isinstance(c, torch.Tensor):
            continue
        nb = _nbytes(c)
        if nb >= min_bytes:
            n += 1
            out.append(Finding(
                rule="constant_bloat", code="LARGE_CONSTANT",
                severity="warning", program=name,
                site=f"const#{n}:{_aval_str(c)}",
                message=(f"constant {_aval_str(c)} ({nb >> 20} MiB) is "
                         "frozen into the program: a tensor closed over "
                         "or built from host data in the body; pass it "
                         "as an argument instead"),
                detail={"aval": _aval_str(c), "bytes": nb}))
    return out


ALL_RULES = (dtype_promotion_rule, donation_rule, retrace_hazard_rule,
             collective_consistency_rule, constant_bloat_rule)
