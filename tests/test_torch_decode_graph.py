"""PyTorch/CUDA port, the decode program (the JAX engine's one jitted
decode step, a CUDA graph on the card): on the CPU the engine runs the
program's body eagerly over the same fixed buffers, so these tests hold
that structure against the JAX engine. The fixed-buffer step's greedy ids
against the JAX engine's on every serving route, through admission,
preemption, a deadline expiry and slot reuse; the buffers' addresses and
the carry they hold after each step; the program's key (the registry's
force pins); a replay's launch and plan accounting, in plain Python; the
registry's program-key lint (DISPATCH_KEY_GAP) against the JAX gate's;
the refusal of a mesh over more than one device."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.inference as jinf
from paddle_tpu.analysis import kernel_rules as jrules
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas import registry as jreg
from paddle_tpu_torch.analysis import kernel_catalog as kc
from paddle_tpu_torch.analysis import kernel_rules as trules
from paddle_tpu_torch.inference import (GenerationConfig, ServingEngine,
                                        ServingMesh)
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import _launch
from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
from paddle_tpu_torch.ops.kernels.registry import KERNELS, KernelRegistry

pytestmark = pytest.mark.torch_port

CFG = jllama.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=4,
                         max_position_embeddings=160, dtype=jnp.float32,
                         remat=False)
TCFG = tllama.LlamaConfig(
    **{f.name: getattr(CFG, f.name)
       for f in dataclasses.fields(tllama.LlamaConfig) if f.name != "dtype"},
    dtype=torch.float32)
ENGINE = dict(capacity=2, block_size=4, prefill_buckets=(8, 16),
              max_seq_len=64)
COUNTERS = ("decode_steps", "prefill_chunks", "prefill_tokens",
            "tokens_generated", "requests_completed", "preemptions",
            "requeues", "deadline_expired")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


def _stream(runs, after_step=None):
    """One request stream through 2 slots (test_torch_serving.py's
    streams, merged), driven in lockstep through each of ``runs``, a list
    of (engine, GenerationConfig class, clock): two low-priority requests
    decode; an urgent one preempts the later-admitted of them, which
    resumes; a request whose deadline passes in the queue expires; then
    the specs of the engine test arrive into freed slots (slot reuse).
    ``after_step()`` runs after every step. Returns each run's requests."""
    rng = np.random.RandomState(7)
    reqs = [[] for _ in runs]

    def step():
        for eng, _, _ in runs:
            eng.step()
        if after_step is not None:
            after_step()

    def sub(S, N, **kw):
        p = rng.randint(0, 97, (S,)).astype(np.int32)
        for out, (eng, gen_cls, _) in zip(reqs, runs):
            out.append(eng.submit(p, gen_cls(max_new_tokens=N, greedy=True),
                                  **kw))

    sub(6, 8, priority=2)
    sub(9, 6, priority=2)
    for _ in range(4):
        step()
    sub(5, 3, priority=0)
    sub(7, 2, priority=2, deadline_s=0.5)
    for _, _, clk in runs:
        clk.t += 1.0
    step()
    for S, N in [(5, 6), (13, 5), (7, 3), (21, 5)]:
        sub(S, N)
    while not all(eng.idle for eng, _, _ in runs):
        step()
    return reqs


ROUTES = {
    "default": {},
    "ref": {"fused_decode": "ref"},
    "unfused": {"fused_decode": False, "fused_prefill": False},
    "int8_weights": {"weight_quant": "int8"},
    "int8_cache": {"cache_dtype": "int8"},
    "int8_cache_unfused": {"cache_dtype": "int8", "fused_decode": False,
                           "fused_prefill": False},
    "tp1_psum": {"mesh": (1, "psum")},
    "tp2_psum": {"mesh": (2, "psum")},
    "tp2_gather": {"mesh": (2, "gather")},
}


def _knobs(route, port):
    kw = dict(ROUTES[route])
    if "mesh" in kw:
        tp, coll = kw.pop("mesh")
        kw["mesh"] = (ServingMesh.make(tp, collective=coll,
                                       devices=["cpu"] * tp) if port else
                      jinf.ServingMesh.make(tp=tp, collective=coll))
    return kw


@pytest.mark.parametrize("route", list(ROUTES))
def test_decode_program_matches_jax_engine(params, route):
    """The port's engine, whose decode step is one program over fixed
    buffers, against the JAX engine's jitted step on the same stream and
    route: equal greedy ids, expiries and scheduler counters, and one
    program build (decode_traces 1, as the JAX engine traces once)."""
    jp, tp = params
    jclk, tclk = FakeClock(), FakeClock()
    je = jinf.ServingEngine(jp, CFG, clock=jclk, **ENGINE,
                            **_knobs(route, False))
    te = ServingEngine(tp, TCFG, device="cpu", clock=tclk, **ENGINE,
                       **_knobs(route, True))
    jr, tr = _stream([(je, jinf.GenerationConfig, jclk),
                      (te, GenerationConfig, tclk)])
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert [r.expired for r in tr] == [r.expired for r in jr]
    assert any(r.expired for r in tr) and any(r.preemptions for r in tr)
    for k in COUNTERS:
        assert te.counters[k] == je.counters[k], k
    assert te.counters["decode_traces"] == je.counters["decode_traces"] == 1
    assert len(te._decode_fns) == 1


def test_carry_buffers_keep_their_addresses(params):
    """The four inputs of the decode program never move: their
    ``data_ptr()`` holds across admission, preemption, expiry, completion
    and re-admission. After each step, once one has decoded, they hold
    what the JAX engine's carry holds (its ``_DECODE_CARRY`` maps the
    step's next tokens and lengths onto the token and length arguments;
    the tables and temperatures are the host's), and the port declares
    that mapping as the JAX engine does."""
    jp, tp = params
    assert tserving.ServingEngine._DECODE_CARRY \
        == jinf.ServingEngine._DECODE_CARRY
    jclk, tclk = FakeClock(), FakeClock()
    je = jinf.ServingEngine(jp, CFG, clock=jclk, **ENGINE)
    te = ServingEngine(tp, TCFG, device="cpu", clock=tclk, **ENGINE)
    names = ("_d_tok", "_d_seq", "_d_tables", "_d_temps")
    ptrs = {n: getattr(te, n).data_ptr() for n in names}
    checked = []

    def check():
        assert {n: getattr(te, n).data_ptr() for n in names} == ptrs
        if te.counters["decode_steps"]:
            for n in names:
                np.testing.assert_array_equal(getattr(te, n).numpy(),
                                              np.asarray(getattr(je, n)),
                                              err_msg=n)
            checked.append(te.counters["decode_steps"])

    _stream([(je, jinf.GenerationConfig, jclk),
             (te, GenerationConfig, tclk)], after_step=check)
    assert te.counters["preemptions"] == je.counters["preemptions"] > 0
    assert te.counters["requests_completed"] == 7 and len(checked) > 10


def test_decode_program_is_keyed_by_the_pins(params):
    """A step under a new ``KERNELS.force`` pin builds a second program
    (decode_traces 2) and records the variant it dispatches; steps under
    the first pins keep the first program, and a step under the pin again
    reuses the second. Dispatch reads the pins when a program is built,
    so a program built under other pins is never run."""
    _, tp = params
    eng = ServingEngine(tp, TCFG, device="cpu", **ENGINE)
    rng = np.random.RandomState(3)
    reqs = [eng.submit(rng.randint(0, 97, (S,)).astype(np.int32),
                       GenerationConfig(max_new_tokens=12, greedy=True))
            for S in (5, 9)]
    while eng.counters["decode_steps"] < 2:
        eng.step()
    first = eng._decode_program()
    assert eng.counters["decode_traces"] == 1
    assert eng._decode_key() == KERNELS.forced_state() == ()
    pin = ("decode_block_fused", "composed")
    with KERNELS.force(*pin):
        eng.step()
        second = eng._decode_program()
        assert eng._decode_key() == (pin,)
    assert second is not first
    assert eng.counters["decode_traces"] == 2
    assert eng.decode_variant["block"] == "composed"
    eng.step()
    assert eng._decode_program() is first
    with KERNELS.force(*pin):
        eng.step()
        assert eng._decode_program() is second
    eng.drain()
    assert eng.counters["decode_traces"] == 2 and len(eng._decode_fns) == 2
    assert all(r.done and len(r.tokens) == 12 for r in reqs)
    # "ref" pins its variants itself: the pins do not key its program
    ref = ServingEngine(tp, TCFG, device="cpu", fused_decode="ref", **ENGINE)
    with KERNELS.force(*pin):
        assert ref._decode_key() == ()


class _Replayed:
    """A stand-in for a captured CUDA graph: ``replay()`` counts."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_accounting_in_plain_python():
    """A program's capture bumps the launch counters by a known delta and
    records its plans apart (the counters and the captures around it see
    nothing); N replays add N times the delta to ``launches()``, to the
    one store ``launches_by_class()`` and to each family's reader, and
    hand N copies of the plans to an active capture. The replays run
    through ``Program.__call__`` itself, over a stand-in graph."""
    kernels.reset_launches()
    block, paged = fdb.decode_block_fused_cuda, kernels.WRAPPERS[
        "paged_attention_decode"]
    case = next(c for c in kc.kernel_cases()
                if c.name == "decode_block_fused@tiny")

    def capture_body():
        for _ in range(3):
            _launch.count(block, weight="int8", pool="fp", body="ring")
        paged.launches += 2
        kc.capture_case(case)

    with _launch.capture_kernel_launches() as outer:
        with kernels.launches_apart() as delta, \
                _launch.capture_kernel_launches(isolated=True) as specs:
            capture_body()
    assert outer == [] and specs and not any(kernels.launches().values())
    assert delta == {"decode_block_fused": (3, {
        ("weight", "int8"): 3, ("pool", "fp"): 3, ("body", "ring"): 3}),
        "paged_attention_decode": (2, {})}
    counters = {"decode_traces": 0}
    prog = tserving._Program(capture_body, torch.device("cpu"), None, None,
                             on_capture=lambda: counters.update(
                                 decode_traces=counters["decode_traces"] + 1))
    prog.graph, prog.launches, prog.specs = _Replayed(), delta, specs
    N = 5
    with _launch.capture_kernel_launches() as outer:
        for _ in range(N):
            prog()
    assert prog.graph.replays == N and counters["decode_traces"] == 0
    assert len(outer) == N * len(specs)
    assert [s.name for s in outer[:len(specs)]] == [s.name for s in specs]
    got = kernels.launches()
    assert got["decode_block_fused"] == 3 * N
    assert got["paged_attention_decode"] == 2 * N
    assert kernels.launches_by_class()["decode_block_fused"] == {
        ("weight", "fp"): 0, ("weight", "int8"): 3 * N, ("weight", "int4"): 0,
        ("pool", "fp"): 3 * N, ("pool", "int8"): 0,
        ("body", "ring"): 3 * N, ("body", "cuda_core"): 0}
    assert kernels.launches_by_weight()["decode_block_fused"]["int8"] == 3 * N
    assert kernels.launches_by_pool()["decode_block_fused"]["fp"] == 3 * N
    assert kernels.launches_by_body()["decode_block_fused"]["ring"] == 3 * N
    assert block.launches_by_weight == {"fp": 0, "int8": 3 * N, "int4": 0}
    assert not any(v for by in kernels.launches_by_residual().values()
                   for v in by.values())
    kernels.reset_launches()
    assert not any(kernels.launches().values())
    assert not any(v for by in kernels.launches_by_class().values()
                   for v in by.values())


def test_registry_lint_is_clean():
    """The port's registry lint over every registered op at the
    catalog's flagship metas: each op declares its program-key coverage,
    has a lint meta, and no supports() reads a key outside it."""
    rep = kc.audit_kernel_registry()
    assert rep.findings == []
    assert set(rep.meta["ops"]) == set(kc.lint_metas())
    assert all(KERNELS.cache_key_decl(op) for op in KERNELS.ops())
    assert "kernel_registry" in {r.program for r in kc.audit_kernels(
        ["kernel_registry"])}


def _gap_findings(reg_cls, rule):
    """One op whose kernel variant's predicate reads a key its program
    key does not declare (``secret``), in a fresh registry of
    ``reg_cls``, through the gate's ``rule``."""
    reg = reg_cls()

    def supports(meta):
        return meta["B"] <= 8 and meta.get("secret", 0) == 0

    reg.register("decode_attn_block", "kernel", lambda: None, priority=10,
                 supports=supports)
    reg.register("decode_attn_block", "plain", lambda: None, priority=0)
    reg.declare_cache_key("decode_attn_block", ("B", "D"))
    return rule(reg, "decode_attn_block", {"B": 8, "D": 64, "secret": 1})


def test_dispatch_key_gap_matches_the_jax_lint():
    """An injected predicate that reads an undeclared key gives one
    DISPATCH_KEY_GAP finding naming that key; the JAX package's rule over
    the same entry in a JAX registry gives the same code and the same
    missing key. An undeclared op is a finding of both."""
    got = _gap_findings(KernelRegistry, trules.dispatch_key_rule)
    want = _gap_findings(jreg.KernelRegistry, jrules.dispatch_key_rule)
    assert [f.code for f in got] == [f.code for f in want] \
        == ["DISPATCH_KEY_GAP"]
    assert got[0].detail["gap"] == want[0].detail["gap"] == ["secret"]
    assert got[0].site == want[0].site
    for reg_cls, rule in ((KernelRegistry, trules.dispatch_key_rule),
                          (jreg.KernelRegistry, jrules.dispatch_key_rule)):
        reg = reg_cls()
        reg.register("op", "v", lambda: None, supports=lambda m: m["x"])
        found = rule(reg, "op", {"x": 1})
        assert [(f.code, f.site) for f in found] == [("DISPATCH_KEY_GAP",
                                                      "op:undeclared")]


def test_mesh_over_two_devices_is_refused(params, monkeypatch):
    """A mesh whose shards sit on two devices is refused in the
    constructor, before anything touches a device: the decode step is one
    CUDA graph, which runs on one card (the multi-card backend is ROADMAP
    A10(b)/A11). Colocated shards are taken."""
    _, tp = params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    mesh = ServingMesh.make(2, devices=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match=r"one card.*A10\(b\)/A11"):
        ServingEngine(tp, TCFG, mesh=mesh, **ENGINE)
    monkeypatch.undo()
    eng = ServingEngine(tp, TCFG, mesh=ServingMesh.make(
        2, devices=["cpu", "cpu"]), **ENGINE)
    assert eng.metrics()["mesh"]["tp"] == 2
