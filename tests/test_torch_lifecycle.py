"""PyTorch/CUDA port, the lifecycle model checker
(``paddle_tpu_torch/analysis/lifecycle.py``) against the JAX package's
(``paddle_tpu/analysis/lifecycle.py``), on the CPU.

Both checkers explore every scope of ``SCOPES`` and ``DEMO_SCOPES``, the
port's over the port's ``BlockManager``, ``PrefixCache`` and
``AdmissionQueue``, the JAX package's over its own. Held EXACTLY: the same
distinct-state and transition counts, 0 findings on ``SCOPES``, both demo
bugs found with the same finding codes, fingerprints and shortest trace,
the same fuzz walks, and the CLI's exit codes on the port's baseline
(``paddle_tpu_torch/analysis/lifecycle_baseline.json``)."""
import copy
import json
import os
import pathlib
import subprocess
import sys

import pytest

from paddle_tpu.analysis import lifecycle as jlc
from paddle_tpu_torch.analysis import lifecycle as tlc
from paddle_tpu_torch.analysis import lifecycle_audit

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cli(*args):
    """The CLI as ``python -m`` runs it, in a subprocess."""
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.analysis.lifecycle_audit",
         *args], cwd=ROOT, capture_output=True, text=True, timeout=600)


def _main(capsys, *args):
    """The CLI's ``main`` in this process: (exit code, stdout + stderr)."""
    rc = lifecycle_audit.main(list(args))
    out = capsys.readouterr()
    return rc, out.out + out.err


def _summary(res):
    rep = res.report
    return {"states": res.states, "transitions": res.transitions,
            "truncated": res.truncated, "program": rep.program,
            "rules": rep.rules_run,
            "findings": [(f.fingerprint, f.severity, f.message,
                          f.detail["trace"], f.detail["labels"])
                         for f in rep.findings]}


def test_catalogs_are_the_reference_scopes():
    """The port's scope catalogs are the JAX package's, field for field
    but the notes (which name no round of the reference here)."""
    for cat in ("SCOPES", "DEMO_SCOPES"):
        a, b = getattr(jlc, cat), getattr(tlc, cat)
        assert list(a) == list(b)
        for name in a:
            fa, fb = vars(a[name]).copy(), vars(b[name]).copy()
            fa.pop("note"), fb.pop("note")
            assert repr(fa) == repr(fb), name
    assert set(jlc.BUGS) == set(tlc.BUGS)


@pytest.mark.parametrize("name", sorted(jlc.SCOPES))
def test_scope_explores_like_the_reference(name):
    """Each committed scope explored exhaustively by both checkers: the
    same distinct states and transitions, untruncated, 0 findings."""
    want = _summary(jlc.explore(jlc.SCOPES[name]))
    got = _summary(tlc.explore(tlc.SCOPES[name]))
    assert got == want
    assert got["findings"] == [] and not got["truncated"]
    assert got["states"] > 50


@pytest.mark.parametrize("name,code", [("demo_starved_head", "DEADLOCK"),
                                       ("demo_abort_leak", "ABORT_LEAK")])
def test_demo_bug_found_with_the_reference_trace(name, code):
    """Each injected bug is found by both checkers with the same
    findings and the same BFS-shortest trace, and the port's trace
    replays to the problem on a fresh world."""
    sc = tlc.DEMO_SCOPES[name]
    res = tlc.explore(sc)
    assert _summary(res) == _summary(jlc.explore(jlc.DEMO_SCOPES[name]))
    f = next(f for f in res.report.findings if f.code == code)
    assert len(f.detail["trace"]) == 8
    assert f.detail["injected_bug"] == sc.bug
    world, problems = tlc.replay_trace(sc, f.detail["trace"])
    if code == "DEADLOCK":
        # a progress property: the replay ends pending, with no action
        # that changes the world
        assert problems == [] and world.pending()
        for action in world.actions():
            assert not copy.deepcopy(world).apply(action)[0], action
    else:
        assert any(c == code for c, _, _ in problems)


def test_fuzz_walks_match_the_reference():
    """Deterministic random walks: the same transitions as the JAX
    checker's from the same seed, clean, and repeatable."""
    for name in ("coloc_nocache", "disagg"):
        a = jlc.fuzz(jlc.SCOPES[name], 20, seed=11)
        b = tlc.fuzz(tlc.SCOPES[name], 20, seed=11)
        c = tlc.fuzz(tlc.SCOPES[name], 20, seed=11)
        assert a.transitions == b.transitions == c.transitions
        assert b.report.findings == [] == a.report.findings


def test_make_world_rejects_request_that_cannot_fit():
    sc = tlc.Scope(name="too_big",
                   requests=(tlc.ReqSpec((1, 2, 3, 4, 5, 6), max_new=2),),
                   capacity=1, num_blocks=3, block_size=2)
    with pytest.raises(ValueError, match="trivial deadlock"):
        tlc.make_world(sc)


def test_package_baseline_holds_zero_findings():
    with open(lifecycle_audit.DEFAULT_BASELINE) as fh:
        doc = json.load(fh)
    assert doc == {"findings": {}, "version": 1}


@pytest.mark.parametrize("args,rc,text", [
    (("--max-states", "1500", "--quiet"), 0, ""),
    (("--list",), 0, "bug=abort_leak"),
    (("--fuzz", "5", "--seed", "3", "--scope", "coloc_spill"), 0, "walk(s)"),
    (("--write-baseline", "--demo-regression"), 3, "refusing"),
    (("--write-baseline", "--scope", "coloc_spill"), 3, "refusing"),
    (("--scope", "no_such_scope"), 3, "unknown scope"),
    (("--bogus-flag",), 3, "unrecognized"),
])
def test_cli_exit_codes(capsys, args, rc, text):
    got, out = _main(capsys, *args)
    assert got == rc, out
    assert text in out


def test_cli_demo_regression_fails_the_gate(tmp_path):
    """``--demo-regression`` finds both bugs and exits 2 on the port's
    baseline; the JSON document and the dumps hold their traces."""
    doc_path = tmp_path / "doc.json"
    dumps = tmp_path / "ce"
    p = _cli("--scope", "demo_starved_head", "--scope", "demo_abort_leak",
             "--demo-regression", "--json", str(doc_path),
             "--dump-dir", str(dumps))
    assert p.returncode == 2, p.stdout + p.stderr
    assert "GATE FAILED" in p.stderr
    doc = json.loads(doc_path.read_text())
    codes = {f["code"] for r in doc["programs"].values()
             for f in r["findings"]}
    assert codes == {"DEADLOCK", "ABORT_LEAK"}
    files = sorted(os.listdir(dumps))
    assert files == ["lifecycle_ce_0.json", "lifecycle_ce_1.json"]
    dump = json.loads((dumps / files[1]).read_text())
    assert dump["reason"] == "lifecycle:ABORT_LEAK"
    assert dump["injected_bug"] == "abort_leak"
    assert dump["fingerprint"].startswith("lifecycle_demo_abort_leak::")
    assert len(dump["timeline_tail"]) == 8
    assert all(e["event"] == "action" for e in dump["timeline_tail"])


def test_cli_write_baseline_to_another_file(capsys, tmp_path):
    """``--write-baseline`` over a subset is refused on the package's
    baseline and allowed on another file, which then gates clean."""
    path = str(tmp_path / "base.json")
    rc, out = _main(capsys, "--scope", "coloc_spill", "--write-baseline",
                    "--baseline", path)
    assert rc == 0, out
    assert json.loads(open(path).read()) == {"findings": {}, "version": 1}
    assert _main(capsys, "--scope", "coloc_spill", "--baseline", path)[0] == 0
    with open(path, "w") as fh:
        fh.write("{")
    rc, out = _main(capsys, "--scope", "coloc_spill", "--baseline", path)
    assert rc == 3 and "BROKEN BASELINE" in out
