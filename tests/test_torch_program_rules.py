"""PyTorch/CUDA port, the static program audit's rules, registry,
baseline and CLI (``paddle_tpu_torch/analysis/{rules,registry,auditor,
program_audit}.py``) against the JAX package's (tests/test_analysis.py),
on the CPU.

Each rule runs on a specimen of its bug class and on the fixed version,
one test per JAX test of tests/test_analysis.py. Where both packages can
express a specimen on the same shapes, the set of (rule, code) pairs the
port's audit reports EQUALS the JAX audit's on the JAX specimen. The port
traces with ``make_fx(..., tracing_mode="fake")``: nothing executes.

Not expressible in the port (dropped codes, pinned below with their
reasons): ``CARRY_WEAK_DRIFT``, ``COND_COLLECTIVE_DIVERGENCE`` and
``COLLECTIVE_IN_WHILE``. The donation specimens differ in form where the
two packages do: a donated JAX input is, in the port, an input the
program writes in place."""
import inspect
import io
import contextlib
import warnings

import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.analysis as jan
from paddle_tpu.analysis import rules as jrules
from paddle_tpu_torch.analysis import (DROPPED_CODES, RULE_CODES, Finding,
                                       ProgramRegistry, ProgramSpec,
                                       TensorStruct, audit_program,
                                       audit_spec, diff_findings,
                                       findings_to_json, load_baseline,
                                       publish_findings, trace_artifacts,
                                       write_baseline)
from paddle_tpu_torch.analysis import program_audit
from paddle_tpu_torch.analysis.catalog import (CATALOG_PROGRAMS, WAITING,
                                               build_catalog,
                                               build_demo_regression,
                                               build_demo_tp_regression)
from paddle_tpu_torch.ops.kernels import _launch

pytestmark = pytest.mark.torch_port

F32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)      # noqa: E731
T32 = lambda *s: TensorStruct(s, torch.float32)             # noqa: E731


def _codes(report):
    return sorted(f.code for f in report.findings)


def _pairs(report):
    return sorted({(f.rule, f.code) for f in report.findings})


# -- rule 1: dtype promotion --------------------------------------------

def test_dtype_rule_flags_prefix_adamw_and_not_fixed():
    """The pre-fix bias correction fires F64_PROMOTION (error) in both
    packages' specimens; the shipped per-leaf AdamW of both trainers is
    silent."""
    from paddle_tpu.analysis.catalog import build_demo_regression as j_demo
    from paddle_tpu.distributed.trainer import _adamw_update as j_adamw
    from paddle_tpu_torch.distributed.trainer import _adamw_update
    rep = audit_spec(build_demo_regression())
    jrep = jan.audit_spec(j_demo())
    f = next(f for f in rep.findings if f.code == "F64_PROMOTION")
    assert (f.rule, f.severity) == ("dtype_promotion", "error")
    assert ("dtype_promotion", "F64_PROMOTION") in _pairs(jrep)

    def fixed_step(state, g, lr):
        return _adamw_update(g, state, lr)

    w = lambda: {"w": T32(8, 4)}                          # noqa: E731
    state = (w(), w(), w(), w(), TensorStruct((), torch.int32))
    rep2 = audit_program(fixed_step, state, w(), T32(),
                         name="fixed_adamw", donate_argnums=(0,),
                         carry={i: i for i in range(5)})
    jstate = ((F32(8, 4),), (F32(8, 4),), (F32(8, 4),), (F32(8, 4),),
              jax.ShapeDtypeStruct((), jnp.int32))
    jrep2 = jan.audit_program(
        jax.jit(lambda s, g: j_adamw(g, s, jnp.float32(1e-3))), jstate,
        (F32(8, 4),), name="fixed_adamw", carry={i: i for i in range(5)})
    assert rep2.findings == [] and jrep2.findings == []


def test_dtype_rule_silent_when_inputs_are_f64():
    rep = audit_program(lambda x: x * 2.0,
                        TensorStruct((8,), torch.float64), name="native")
    jrep = jan.audit_program(jax.jit(lambda x: x * 2.0),
                             jax.ShapeDtypeStruct((8,), jnp.float64),
                             name="native")
    assert rep.findings == [] and jrep.findings == []


def test_dtype_rule_ignores_empty_placeholders():
    """A float64 value with no element (torch's checkpoint makes a [0]
    placeholder in the default dtype) holds nothing to widen; one that
    feeds a value with data is flagged there."""
    rep = audit_program(lambda x: (x * 2, torch.empty(0)), T32(4),
                        name="placeholder")
    assert rep.findings == []
    rep = audit_program(lambda x: x + torch.empty(0).sum(), T32(4),
                        name="fed")
    assert [(f.code, f.site) for f in rep.findings] == [
        ("F64_PROMOTION", "aten.sum.default:float64[]")]
    assert rep.findings[0].detail["first_site"] == "outside the port"
    site = audit_spec(build_demo_regression()).findings[0].detail[
        "first_site"]
    assert site.startswith("paddle_tpu_torch/analysis/catalog.py:")
    assert site.endswith("(prefix_adamw)")


def test_dtype_rule_bf16_upcast_threshold():
    cfg = {"dtype_promotion_rule": {"upcast_min_bytes": 1 << 20}}
    rep = audit_program(lambda x: x.float().sum(),
                        TensorStruct((2048, 2048), torch.bfloat16),
                        name="upcast", config=cfg)
    jrep = jan.audit_program(
        jax.jit(lambda x: x.astype(jnp.float32).sum()),
        jax.ShapeDtypeStruct((2048, 2048), jnp.bfloat16), name="upcast",
        config=cfg)
    assert _pairs(rep) == _pairs(jrep) == [
        ("dtype_promotion", "BF16_UPCAST_BLOAT")]
    f = rep.findings[0]
    assert f.detail["upcasts"] == 1 and f.detail["total_bytes"] == 16 << 20
    small = audit_program(lambda x: x.float().sum(),
                          TensorStruct((16, 16), torch.bfloat16),
                          name="upcast_small")
    assert small.findings == []


# -- rule 2: donation (in-place declarations) ---------------------------

def test_donation_rule_donated_unaliased():
    """Declared in place and never written (the JAX donated input that
    matches no output)."""
    rep = audit_program(lambda a: a.sum(), T32(64, 64), name="dead",
                        donate_argnums=(0,))
    jrep = jan.audit_program(jax.jit(lambda a: jnp.float32(a.sum()),
                                     donate_argnums=(0,)), F32(64, 64),
                             name="dead")
    assert _pairs(rep) == _pairs(jrep) == [("donation",
                                            "DONATED_UNALIASED")]


def test_donation_rule_donatable_not_donated():
    rep = audit_program(lambda a: a + 1.0, T32(1024, 1024), name="missed")
    jrep = jan.audit_program(jax.jit(lambda a: a + 1.0), F32(1024, 1024),
                             name="missed")
    assert _pairs(rep) == _pairs(jrep) == [("donation",
                                            "DONATABLE_NOT_DONATED")]
    # written in place and declared: clean (JAX: donated)
    rep2 = audit_program(lambda a: a.add_(1.0), T32(1024, 1024),
                         name="inplace", donate_argnums=(0,))
    jrep2 = jan.audit_program(jax.jit(lambda a: a + 1.0,
                                      donate_argnums=(0,)),
                              F32(1024, 1024), name="donated")
    assert rep2.findings == [] and jrep2.findings == []
    rep3 = audit_program(lambda a: a + 1.0, T32(8, 8), name="small")
    assert rep3.findings == []


def test_donation_rule_sees_writes_through_views():
    """An in-place write through a view (a slice, a dtype view, a row of
    an unbind) marks its input written."""
    def f(a, b, c):
        a[:, 1:3].mul_(2.0)
        b.view(torch.int32).index_copy_(
            0, torch.zeros(1, dtype=torch.long),
            torch.zeros(1, 4, dtype=torch.int32))
        c.unbind(0)[1].zero_()
        return a
    art = trace_artifacts(ProgramSpec(name="views", fn=f,
                                      args=(T32(4, 4), T32(4, 4),
                                            T32(3, 4))))
    assert art.written == (True, True, True)
    assert art.out_fresh == (False,)


# -- rule 3: retrace (recapture) hazards --------------------------------

def test_retrace_rule_multiple_signatures():
    spec = ProgramSpec(name="sig_drift", fn=lambda x: x + 1,
                       args=(T32(4, 4),))
    spec.record_signature()
    spec.record_signature((T32(8, 4),), {})
    jspec = jan.ProgramSpec(name="sig_drift", fn=jax.jit(lambda x: x + 1),
                            args=(F32(4, 4),))
    jspec.record_signature()
    jspec.record_signature((F32(8, 4),), {})
    assert _pairs(audit_spec(spec)) == _pairs(jan.audit_spec(jspec)) == [
        ("retrace_hazard", "MULTIPLE_SIGNATURES")]
    spec2 = ProgramSpec(name="sig_stable", fn=lambda x: x + 1,
                        args=(T32(4, 4),))
    spec2.record_signature()
    spec2.record_signature()
    assert audit_spec(spec2).findings == []


def test_retrace_rule_float_static_arg():
    spec = ProgramSpec(name="float_static", fn=lambda x, s: x * s,
                       args=(T32(4), 0.5), static_argnums=(1,),
                       static_argvals=(0.5,))
    jspec = jan.ProgramSpec(
        name="float_static",
        fn=jax.jit(lambda x, s: x * s, static_argnums=(1,)),
        args=(F32(4), 0.5), static_argnums=(1,), static_argvals=(0.5,))
    assert _pairs(audit_spec(spec)) == _pairs(jan.audit_spec(jspec)) == [
        ("retrace_hazard", "FLOAT_STATIC_ARG")]
    # the scale as a device word: clean
    assert audit_program(lambda x, s: x * s, T32(4), T32(),
                         name="word").findings == []


@pytest.mark.parametrize("kind", ["dtype", "shape"])
def test_retrace_rule_carry_drift(kind):
    """A carried output whose type or shape differs from its buffer (a
    ``copy_`` back would cast or broadcast it silently)."""
    if kind == "dtype":
        tf, jf = (lambda s: s.to(torch.bfloat16)), \
            (lambda s: s.astype(jnp.bfloat16))
    else:
        tf, jf = (lambda s: s[:2]), (lambda s: s[:2])
    rep = audit_program(tf, T32(4), name="drift", carry={0: 0})
    jrep = jan.audit_program(jax.jit(jf), F32(4), name="drift",
                             carry={0: 0})
    code = f"CARRY_{kind.upper()}_DRIFT"
    assert _pairs(rep) == _pairs(jrep) == [("retrace_hazard", code)]
    assert rep.findings[0].severity == "error"
    assert audit_program(lambda s: s * 2, T32(4), name="ok",
                         carry={0: 0}).findings == []


# -- rule 4: collective consistency -------------------------------------

def test_collective_rule_unknown_axis():
    from paddle_tpu_torch.inference.tp import ServingMesh
    mesh = ServingMesh(("cpu",) * 2, axis="model")

    def body(a, b):
        return mesh.psum([a, b])[0] + mesh.all_gather([a, b], 0)[0].sum()
    ok = audit_program(body, T32(4), T32(4), name="ok",
                       mesh_axes=("model",))
    assert ok.findings == [] and ok.meta["collectives"] == 2
    bad = audit_program(body, T32(4), T32(4), name="bad", mesh_axes=("dp",))
    assert _codes(bad) == ["UNKNOWN_COLLECTIVE_AXIS"] * 2
    assert {f.site for f in bad.findings} == {"psum@model",
                                              "all_gather@model"}
    # the real tp decode step, declared over another axis
    rep = audit_spec(build_demo_tp_regression())
    assert _pairs(rep) == [("collective_consistency",
                            "UNKNOWN_COLLECTIVE_AXIS")]
    assert rep.findings[0].site == "psum@tp"


def test_dropped_codes_pinned_with_reasons():
    """The port's codes are the JAX rules' codes less the three it cannot
    read from an fx graph, each dropped with a reason."""
    src = inspect.getsource(jrules)
    jax_codes = {c for c in (
        "F64_PROMOTION", "BF16_UPCAST_BLOAT", "DONATED_UNALIASED",
        "DONATABLE_NOT_DONATED", "MULTIPLE_SIGNATURES", "FLOAT_STATIC_ARG",
        "CARRY_DTYPE_DRIFT", "CARRY_SHAPE_DRIFT", "CARRY_WEAK_DRIFT",
        "UNKNOWN_COLLECTIVE_AXIS", "COND_COLLECTIVE_DIVERGENCE",
        "COLLECTIVE_IN_WHILE", "LARGE_CONSTANT") if f'"{c}"' in src}
    assert len(jax_codes) == 13
    ours = {c for codes in RULE_CODES.values() for c in codes}
    assert set(DROPPED_CODES) == {"CARRY_WEAK_DRIFT",
                                  "COND_COLLECTIVE_DIVERGENCE",
                                  "COLLECTIVE_IN_WHILE"}
    assert ours | set(DROPPED_CODES) == jax_codes
    assert not ours & set(DROPPED_CODES)
    assert all(len(r) > 20 for r in DROPPED_CODES.values())


# -- rule 5: constant bloat ---------------------------------------------

def test_constant_bloat_rule():
    C = torch.ones(640, 640)                       # ~1.6 MiB
    rep = audit_program(lambda x: x + C, T32(640, 640), name="const")
    jC = jnp.ones((640, 640), jnp.float32)
    jrep = jan.audit_program(jax.jit(lambda x: x + jC), F32(640, 640),
                             name="const")
    assert ("constant_bloat", "LARGE_CONSTANT") in _pairs(rep)
    assert ("constant_bloat", "LARGE_CONSTANT") in _pairs(jrep)
    rep2 = audit_program(lambda x, c: x + c, T32(640, 640), T32(640, 640),
                         name="const_arg")
    assert "LARGE_CONSTANT" not in _codes(rep2)


# -- the kernel launch and collective nodes -----------------------------

def test_begin_puts_one_node_per_launch_and_marks_writes():
    """Over fake tensors ``_launch.begin`` never launches: it records the
    plan, adds one ``kernel_launch`` node (its written tensors marked
    ``(a!)``) and returns False; over real meta tensors (the kernel gate's
    capture) it records and adds no op; over fake CPU tensors it raises
    as over real ones."""
    from paddle_tpu_torch.ops.kernels.fused_adamw import (
        adamw_update, fused_adamw_triton)

    def step(master, grad, mu, nu, lr, t):
        adamw_update(master, grad, mu, nu, lr, t)
        return master

    n = 1 << 17
    spec = ProgramSpec(name="adamw", fn=step, device="meta",
                       args=(T32(n), T32(n), T32(n), T32(n), T32(), T32()),
                       donate_argnums=(0, 2, 3))
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    with KERNELS.force("fused_adamw", "cuda"):
        art = trace_artifacts(spec)
    assert art.launches == ("fused_adamw",)
    assert [p.name for p in art.plans] == ["fused_adamw"]
    assert art.written == (True, False, True, True, False, False)
    assert audit_spec(spec).findings[0].code == "TRACE_ERROR"  # unpinned
    with KERNELS.force("fused_adamw", "cuda"):
        assert audit_spec(spec).findings == []
    before = _launch.trace_ops  # the op set exists once
    with _launch.capture_kernel_launches() as plans:
        m = torch.empty(n, device="meta")
        fused_adamw_triton(m, m.clone(), m.clone(), m.clone(), 1e-3, 1.0)
    assert [p.name for p in plans] == ["fused_adamw"]
    assert _launch.trace_ops is before
    with pytest.raises(ValueError, match="CUDA tensors"):
        with KERNELS.force("fused_adamw", "cuda"):
            trace_artifacts(ProgramSpec(name="cpu", fn=step,
                                        args=spec.args))


# -- finding schema / baseline / registry -------------------------------

FINDING_KEYS = {"rule", "code", "severity", "program", "site",
                "message", "detail", "fingerprint"}


def test_finding_schema_frozen():
    rep = audit_spec(build_demo_regression())
    assert rep.findings
    for f in rep.findings:
        d = f.to_dict()
        assert set(d) == FINDING_KEYS == set(jan.Finding(
            "r", "C", "info", "p", "m").to_dict())
        assert d["severity"] in ("error", "warning", "info")
        assert d["fingerprint"] == \
            f"{d['program']}::{d['rule']}::{d['code']}::{d['site']}"
    doc = findings_to_json([rep])
    assert set(doc) == {"version", "programs", "summary"}
    assert set(doc["summary"]) == {"programs", "findings", "by_severity"}


def test_baseline_roundtrip_and_diff(tmp_path):
    rep = audit_spec(build_demo_regression())
    path = str(tmp_path / "baseline.json")
    write_baseline([rep], path)
    base = load_baseline(path)
    assert diff_findings([rep], base) == ([], [])
    victim = rep.findings[0].fingerprint
    del base["findings"][victim]
    new, _ = diff_findings([rep], base)
    assert [f.fingerprint for f in new] == [victim]
    base["findings"]["ghost::rule::CODE::site"] = {"rule": "rule"}
    assert diff_findings([rep], base)[1] == ["ghost::rule::CODE::site"]


def test_broken_baseline_raises(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text('{"version": 99, "findings": {}}')
    with pytest.raises(ValueError, match="version"):
        load_baseline(str(p))
    p.write_text("not json")
    with pytest.raises(ValueError, match="not JSON"):
        load_baseline(str(p))


def test_catalog_rejects_unknown_program_names():
    with pytest.raises(ValueError, match="unknown catalog program"):
        build_catalog(names=["serving-decode"])
    with pytest.raises(ValueError, match="not ported yet"):
        build_catalog(names=["collectives"])
    from paddle_tpu.analysis.catalog import CATALOG_PROGRAMS as J
    assert list(CATALOG_PROGRAMS) == [n for n in J if n not in WAITING]
    assert len(CATALOG_PROGRAMS) == 18


def test_registry_latest_wins_and_trace_error():
    reg = ProgramRegistry()
    f = lambda x: x + 1                                   # noqa: E731
    reg.register(ProgramSpec(name="p", fn=f, args=(T32(4),)))
    assert "p" in reg and len(reg) == 1
    spec2 = ProgramSpec(name="p", fn=lambda x: x + 1, args=(T32(8),))
    reg.register(spec2)
    assert reg.get("p") is spec2

    def broken(x):
        raise RuntimeError("boom")
    rep = audit_spec(ProgramSpec(name="b", fn=broken, args=(T32(4),)))
    assert _codes(rep) == ["TRACE_ERROR"]
    assert rep.findings[0].severity == "error"
    from paddle_tpu_torch.analysis import audit_registry
    reps = audit_registry(reg, names=["p", "missing"])
    assert [r.findings[0].code for r in reps[1:]] == ["UNKNOWN_PROGRAM"]


def test_registry_reregister_keeps_signatures_for_same_fn():
    reg = ProgramRegistry()
    fn = lambda x: x + 1                                  # noqa: E731
    spec = reg.register(ProgramSpec(name="p", fn=fn, args=(T32(4),)))
    spec.record_signature((T32(8),), {})
    again = reg.register(ProgramSpec(name="p", fn=fn, args=(T32(4),)))
    assert len(again.signatures) == 2
    assert "MULTIPLE_SIGNATURES" in _codes(audit_spec(again))
    other = reg.register(ProgramSpec(name="p", fn=lambda x: x * 2,
                                     args=(T32(4),)))
    assert len(other.signatures) == 1


def test_publish_findings_counter():
    rep = audit_spec(build_demo_regression())
    counters = {}
    n = publish_findings(rep, counters=counters)
    assert n == len(rep.findings) > 0
    assert counters["audit_findings"] == n
    publish_findings([], counters=counters)
    assert counters["audit_findings"] == n
    info = Finding(rule="dtype_promotion", code="BF16_UPCAST_BLOAT",
                   severity="info", program="p", message="m")
    assert publish_findings([info], counters=counters) == 0


# -- the CLI -------------------------------------------------------------

def _cli(*args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = program_audit.main(list(args))
    return rc, out.getvalue()


def test_cli_gate_clean_against_committed_baseline():
    """The whole catalog against the committed baseline: exit 0, every
    program traced, no trace warning about a fake tensor's address."""
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        rc, out = _cli()
    assert rc == 0, out
    assert "gate clean" in out
    for name in CATALOG_PROGRAMS:
        assert f"[audit] {name}: 0 finding(s)" in out
    assert not [w for w in ws if "data_ptr" in str(w.message)]


def test_cli_demo_regression_fails_the_gate(tmp_path):
    rc, out = _cli("--demo-regression", "--program", "serving_page_copy",
                   "--json", str(tmp_path / "doc.json"))
    assert rc == 2
    assert "demo_regression_adamw::dtype_promotion::F64_PROMOTION" in out
    assert ("demo_regression_tp_axis::collective_consistency::"
            "UNKNOWN_COLLECTIVE_AXIS::psum@tp") in out
    assert "SELF-CHECK FAILED" not in out


@pytest.mark.parametrize("args", [
    ("--program", "serving-decode"),
    ("--write-baseline", "--demo-regression"),
    ("--write-baseline", "--program", "serving_page_copy"),
    ("--no-such-flag",)])
def test_cli_bad_invocations_exit_3(args):
    assert _cli(*args)[0] == 3


def test_cli_list_and_baseline_file(tmp_path):
    rc, out = _cli("--list")
    assert rc == 0 and out.split() == list(CATALOG_PROGRAMS)
    base = str(tmp_path / "b.json")
    assert _cli("--write-baseline", "--baseline", base, "--program",
                "serving_page_copy")[0] == 0
    assert load_baseline(base)["findings"] == {}
    assert load_baseline(program_audit.DEFAULT_BASELINE)["findings"] == {}
