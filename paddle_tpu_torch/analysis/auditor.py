"""Audit orchestration: trace a spec, run the rule passes, diff the
findings against a committed baseline (port of
``paddle_tpu/analysis/auditor.py``).

Tracing is the only torch work an audit does: ``make_fx(...,
tracing_mode="fake")`` over the spec's callable with its tensor leaves as
fake tensors (on the spec's ``device``, or each leaf's own), inside an
isolated ``capture_kernel_launches`` (the kernel plans the wrappers
record, kept from the captures around the audit), plus a
second trace under ``torch.set_default_dtype(torch.float64)`` (the probe,
the JAX x64 probe's counterpart: every tensor made from a bare Python
float widens, which is what the dtype and carry rules hunt). Neither
trace executes, launches a kernel, allocates device memory or captures a
graph: a wrapper given fake tensors returns at ``_launch.begin``, which
puts one ``kernel_launch`` node in the graph.

Baselines: ``write_baseline`` freezes the current finding fingerprints;
``diff_findings`` splits a later run into (new, fixed). The gates
(``python -m paddle_tpu_torch.analysis.program_audit`` and
``python -m paddle_tpu_torch.analysis.kernel_audit``) fail on NEW findings
only; a fixed finding shrinks the baseline on its next refresh.
"""
from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .registry import (REGISTRY, ProgramRegistry, ProgramSpec,
                       TensorStruct, abstract_signature, leaf_offsets)
from .rules import (ALL_RULES, Finding, ProgramArtifacts, alias_root,
                    written_inputs)

__all__ = ["AuditReport", "audit_spec", "audit_program", "audit_registry",
           "trace_artifacts", "launch_counts", "findings_to_json", "write_baseline",
           "load_baseline", "diff_findings", "publish_findings",
           "BASELINE_VERSION"]

BASELINE_VERSION = 1


@dataclass
class AuditReport:
    """Findings and provenance of one audited program (a program of the
    registry, or one kernel case of the kernel catalog)."""
    program: str
    findings: List[Finding] = field(default_factory=list)
    rules_run: List[str] = field(default_factory=list)
    meta: Dict = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {"program": self.program,
                "findings": [f.to_dict() for f in self.findings],
                "rules_run": list(self.rules_run),
                "meta": dict(self.meta)}


def _meta(v) -> Optional[TensorStruct]:
    if isinstance(v, torch.Tensor):
        return TensorStruct(tuple(int(s) for s in v.shape), v.dtype,
                            v.device, bool(v.requires_grad))
    return None


class _FirstWide(TorchDispatchMode):
    """A pass-through dispatch mode that keeps the source line of the
    port's code where the first float64 value of a trace was made (the
    probe's F64_PROMOTION names it)."""
    site = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.site is None and any(
                isinstance(t, torch.Tensor)
                and t.dtype in (torch.float64, torch.complex128)
                for t in pytree.tree_leaves(out)):
            self.site = _port_frame()
        return out


def _port_frame() -> str:
    """``file:line (function)`` of the innermost frame of the port's code
    outside this module."""
    import traceback
    for fr in reversed(traceback.extract_stack()):
        path = fr.filename.replace("\\", "/")
        if "paddle_tpu_torch/" in path \
                and not path.endswith("analysis/auditor.py"):
            return (f"{path[path.rindex('paddle_tpu_torch/'):]}:"
                    f"{fr.lineno} ({fr.name})")
    return "outside the port"


def _trace(spec: ProgramSpec, f64: bool = False):
    """One fake-tensor trace of ``spec``: (graph module, input metas,
    output metas, the output leaves' nodes, the plans recorded, the flat
    indices of the tensor leaves, the first float64 value's source line
    when ``f64``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    from ..ops.kernels._launch import capture_kernel_launches
    leaves, tree = pytree.tree_flatten((tuple(spec.args),
                                        dict(spec.kwargs)))
    idx = [i for i, v in enumerate(leaves) if isinstance(v, TensorStruct)]
    dev = None if spec.device is None else torch.device(spec.device)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fakes = [torch.empty(leaves[i].shape, dtype=leaves[i].dtype,
                             device=dev or leaves[i].device
                             ).requires_grad_(leaves[i].requires_grad)
                 for i in idx]
    outs: List = []
    watch = _FirstWide() if f64 else contextlib.nullcontext()

    def flat_fn(*tensors):
        vals = list(leaves)
        for j, i in enumerate(idx):
            vals[i] = tensors[j]
        args, kwargs = pytree.tree_unflatten(vals, tree)
        with watch:
            res = pytree.tree_leaves(spec.fn(*args, **kwargs))
        outs.append([_meta(v) for v in res])
        return [v for v in res if isinstance(v, torch.Tensor)]

    old = torch.get_default_dtype()
    try:
        if f64:
            torch.set_default_dtype(torch.float64)
        # isolated, on every thread (autograd's backward thread of a fake
        # CUDA trace too): the trace's plans are the audit's own, and no
        # surrounding capture takes them for launches the card made
        with capture_kernel_launches(isolated=True,
                                     all_threads=True) as plans:
            gm = make_fx(flat_fn, tracing_mode="fake")(*fakes)
    finally:
        torch.set_default_dtype(old)
    in_metas = [None] * len(leaves)
    for i in idx:
        in_metas[i] = leaves[i] if dev is None else TensorStruct(
            leaves[i].shape, leaves[i].dtype, dev, leaves[i].requires_grad)
    out_nodes = list(pytree.tree_leaves(
        [n for n in gm.graph.nodes if n.op == "output"][0].args))
    return (gm, tuple(in_metas), tuple(outs[-1]), out_nodes, list(plans),
            idx, getattr(watch, "site", None))


def trace_artifacts(spec: ProgramSpec, f64_probe: bool = True
                    ) -> ProgramArtifacts:
    """Trace ``spec`` into :class:`ProgramArtifacts` (the ambient graph
    and, with ``f64_probe``, the float64-default one). Raises whatever the
    trace raises: callers turn that into a TRACE_ERROR finding."""
    from ..ops.kernels._launch import trace_ops
    ops = trace_ops()
    gm, in_metas, out_metas, out_nodes, plans, idx, _ = _trace(spec)
    places = [n for n in gm.graph.nodes if n.op == "placeholder"]
    wrote = written_inputs(gm)
    written = [False] * len(in_metas)
    for j, i in enumerate(idx):
        written[i] = places[j].name in wrote
    declared = [False] * len(in_metas)
    leaves = pytree.tree_flatten((tuple(spec.args),
                                  dict(spec.kwargs)))[0]
    offs = leaf_offsets(spec.args)
    for a in spec.donate_argnums:
        o, n = offs[a]
        for i in range(o, o + n):
            declared[i] = isinstance(leaves[i], TensorStruct)
    fresh = []
    nodes = iter(out_nodes)
    for m in out_metas:
        if m is None:
            fresh.append(False)
            continue
        node = next(nodes)
        fresh.append(isinstance(node, torch.fx.Node)
                     and alias_root(node).op != "placeholder")
    launches, colls = [], []
    for n in gm.graph.nodes:
        if n.op != "call_function":
            continue
        if n.target is ops.kernel_launch.default:
            launches.append(n.args[0])
        elif n.target is ops.collective.default:
            colls.append((n.args[0], n.args[1]))
    art = ProgramArtifacts(
        spec=spec, graph=gm, in_metas=in_metas, out_metas=out_metas,
        written=tuple(written), declared=tuple(declared),
        out_fresh=tuple(fresh), launches=tuple(launches),
        plans=tuple(plans), collectives=tuple(colls))
    if f64_probe:
        try:
            (art.graph_f64, art.in_metas_f64, art.out_metas_f64, _, _, _,
             art.f64_site) = _trace(spec, f64=True)
        except Exception:  # noqa: BLE001 - the probe is best-effort
            art.graph_f64 = None
    return art


def launch_counts(art: ProgramArtifacts) -> Dict[str, int]:
    """``{launch name: kernel_launch nodes}`` of a traced program."""
    out: Dict[str, int] = {}
    for name in art.launches:
        out[name] = out.get(name, 0) + 1
    return out


def audit_spec(spec: ProgramSpec, rules=ALL_RULES,
               config: Optional[Dict[str, Dict]] = None,
               f64_probe: bool = True) -> AuditReport:
    """Run every rule pass over one spec. A trace failure becomes a single
    TRACE_ERROR finding (severity error): a registered program that stopped
    tracing is itself a regression the gate must catch. ``config`` maps a
    rule function's __name__ to its keyword arguments (thresholds). The
    report's meta holds the graph's node count, its launches by name and
    whether the probe ran."""
    report = AuditReport(program=spec.name,
                         rules_run=[r.__name__ for r in rules])
    try:
        art = trace_artifacts(spec, f64_probe=f64_probe)
    except Exception as e:  # noqa: BLE001
        report.findings.append(Finding(
            rule="auditor", code="TRACE_ERROR", severity="error",
            program=spec.name, site=type(e).__name__,
            message=f"program failed to trace: {type(e).__name__}: {e}",
            detail={"exception": type(e).__name__}))
        report.meta["trace_error"] = str(e)
        return report
    report.meta.update(
        f64_probed=art.graph_f64 is not None,
        nodes=len(art.graph.graph.nodes), launches=launch_counts(art),
        collectives=len(art.collectives))
    cfg = config or {}
    for rule in rules:
        report.findings.extend(rule(art, **cfg.get(rule.__name__, {})))
    return report


def audit_program(fn, *args, name: str = "program", rules=ALL_RULES,
                  config=None, f64_probe: bool = True,
                  **meta) -> AuditReport:
    """Ad-hoc audit of a callable: a throwaway spec (the abstract
    signature of ``args``) through :func:`audit_spec`. ``meta`` forwards
    ProgramSpec fields (donate_argnums, carry, mesh_axes, device...)."""
    kwargs = meta.pop("kwargs", {})
    spec = ProgramSpec(name=name, fn=fn,
                       args=tuple(abstract_signature(args)),
                       kwargs=dict(abstract_signature(kwargs)), **meta)
    return audit_spec(spec, rules=rules, config=config, f64_probe=f64_probe)


def audit_registry(registry: Optional[ProgramRegistry] = None,
                   names: Optional[Iterable[str]] = None,
                   rules=ALL_RULES, config=None,
                   f64_probe: bool = True) -> List[AuditReport]:
    registry = registry if registry is not None else REGISTRY
    wanted = list(names) if names is not None else registry.names()
    reports = []
    for n in wanted:
        spec = registry.get(n)
        if spec is None:
            reports.append(AuditReport(
                program=n, findings=[Finding(
                    rule="auditor", code="UNKNOWN_PROGRAM",
                    severity="error", program=n, site="registry",
                    message=f"no program named {n!r} in the registry")]))
            continue
        reports.append(audit_spec(spec, rules=rules, config=config,
                                  f64_probe=f64_probe))
    return reports


def findings_to_json(reports: List[AuditReport]) -> Dict:
    """The CLI's JSON document: per-program reports and a summary."""
    n_by_sev: Dict[str, int] = {}
    for r in reports:
        for f in r.findings:
            n_by_sev[f.severity] = n_by_sev.get(f.severity, 0) + 1
    return {"version": BASELINE_VERSION,
            "programs": {r.program: r.to_dict() for r in reports},
            "summary": {"programs": len(reports),
                        "findings": sum(len(r.findings) for r in reports),
                        "by_severity": dict(sorted(n_by_sev.items()))}}


def _all_findings(reports: List[AuditReport]) -> List[Finding]:
    return [f for r in reports for f in r.findings]


def write_baseline(reports: List[AuditReport], path: str) -> Dict:
    """Freeze the current fingerprints as the accepted baseline."""
    doc = {"version": BASELINE_VERSION,
           "findings": {f.fingerprint: {
               "rule": f.rule, "code": f.code, "severity": f.severity,
               "program": f.program, "message": f.message}
               for f in _all_findings(reports)}}
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return doc


def load_baseline(path: str) -> Dict:
    """A baseline document; raises ValueError when it is not one."""
    with open(path) as fh:
        try:
            doc = json.load(fh)
        except json.JSONDecodeError as e:
            raise ValueError(f"baseline {path}: not JSON ({e})") from None
    if not isinstance(doc, dict) or doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path}: version "
            f"{doc.get('version') if isinstance(doc, dict) else None!r} != "
            f"{BASELINE_VERSION}: regenerate with --write-baseline")
    if not isinstance(doc.get("findings"), dict):
        raise ValueError(f"baseline {path}: missing findings dict")
    return doc


def diff_findings(reports: List[AuditReport], baseline: Dict
                  ) -> Tuple[List[Finding], List[str]]:
    """(new findings not in the baseline, baseline fingerprints now
    fixed). The gate fails on ``new`` only."""
    current = _all_findings(reports)
    base = set(baseline.get("findings", {}))
    new = [f for f in current if f.fingerprint not in base]
    have = {f.fingerprint for f in current}
    fixed = sorted(fp for fp in base if fp not in have)
    return new, fixed


_SEV_RANK = {"info": 0, "warning": 1, "error": 2}


def publish_findings(findings, counters: Optional[Dict] = None,
                     obs=None, min_severity: str = "warning") -> int:
    """An audit's result to the observability layer: the ``audit_findings``
    counter in the component's counter dict and a ``program_audit``
    timeline event. Only findings at ``min_severity`` or above count
    (default warning: info findings, such as the intended master-weight
    bf16 -> f32 upcast, are report detail). Returns the counted number."""
    flat: List[Finding] = []
    for x in ([findings] if isinstance(findings, AuditReport)
              else list(findings)):
        flat.extend(x.findings if isinstance(x, AuditReport) else [x])
    floor = _SEV_RANK.get(min_severity, 1)
    n = sum(1 for f in flat if _SEV_RANK.get(f.severity, 2) >= floor)
    if counters is not None:
        counters["audit_findings"] = counters.get("audit_findings", 0) + n
    if obs is not None:
        obs.timeline.record("program_audit", findings=n, total=len(flat))
    return n
