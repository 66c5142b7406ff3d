"""PyTorch/CUDA port, serving level: the port's ServingEngine against the
JAX ServingEngine on its unfused route (fused_decode=False,
fused_prefill=False) on the same parameters, on the CPU; the copied
AdmissionQueue against the JAX one; the port's device default and its
isolation from JAX and from paddle_tpu."""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.inference as jinf
from paddle_tpu.inference.admission import AdmissionQueue as JQueue
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.inference import (AdmissionQueue, GenerationConfig,
                                        ServingEngine, ServingMesh, generate)
from paddle_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = jllama.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=128, dtype=jnp.float32,
                         remat=False)
TCFG = tllama.LlamaConfig(
    **{f.name: getattr(CFG, f.name)
       for f in dataclasses.fields(tllama.LlamaConfig) if f.name != "dtype"},
    dtype=torch.float32)
ENGINE = dict(capacity=2, block_size=4, prefill_buckets=(8, 16),
              max_seq_len=64)
COUNTERS = ("decode_steps", "prefill_chunks", "prefill_tokens",
            "tokens_generated", "requests_completed", "preemptions",
            "deadline_expired")


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


def _engines(params):
    jp, tp = params
    je = jinf.ServingEngine(jp, CFG, fused_decode=False,
                            fused_prefill=False, **ENGINE)
    te = ServingEngine(tp, TCFG, device="cpu", **ENGINE)
    return je, te


def _finish_order(reqs):
    return sorted(range(len(reqs)), key=lambda i: reqs[i].finish_t)


def test_engine_matches_jax_engine(params):
    """The five (S, N) specs of test_outputs_match_single_request_generate
    (one prompt spans two chunks) through 2 slots: identical greedy ids,
    finish order and counters."""
    je, te = _engines(params)
    rng = np.random.RandomState(0)
    specs = [(5, 6), (9, 4), (13, 5), (7, 3), (21, 5)]
    jr, tr = [], []
    for S, N in specs:
        p = rng.randint(0, 97, (S,)).astype(np.int32)
        jr.append(je.submit(p, jinf.GenerationConfig(max_new_tokens=N,
                                                     greedy=True)))
        tr.append(te.submit(p, GenerationConfig(max_new_tokens=N,
                                                greedy=True)))
    je.drain()
    te.drain()
    for a, b in zip(jr, tr):
        assert a.tokens == b.tokens and b.done and b.ttft is not None
    assert _finish_order(jr) == _finish_order(tr)
    for k in COUNTERS:
        assert je.counters[k] == te.counters[k], k
    m = te.metrics()
    assert m["tokens_per_sec"] > 0 and m["ttft_ms_mean"] > 0
    assert 0.0 < m["slot_utilization"] <= 1.0
    assert m["decode_step_ms_mean"] > 0


def test_engine_matches_own_generate(params):
    """The paged engine equals the port's dense generate, request by
    request (the parity chip_smoke.py repeats on the card)."""
    _, tp = params
    te = ServingEngine(tp, TCFG, device="cpu", **ENGINE)
    rng = np.random.RandomState(6)
    reqs = []
    for S, N in [(3, 7), (17, 4), (30, 6)]:
        p = rng.randint(0, 97, (S,)).astype(np.int32)
        g = GenerationConfig(max_new_tokens=N, greedy=True)
        reqs.append((p, g, te.submit(p, g)))
    te.drain()
    for p, g, r in reqs:
        want = generate(tp, p[None], TCFG, g, device="cpu")[0, p.size:]
        assert r.tokens == want.tolist()


def test_preemption_and_deadline_match_jax_engine(params):
    """One slot, a fake clock: a low-priority request is preempted by an
    urgent one and resumes; a request whose deadline passes in the queue
    expires. Both engines make the same decisions and emit the same
    tokens."""
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 97, (S,)).astype(np.int32) for S in (6, 5, 9)]
    runs = []
    jp, tp = params
    kw = {**ENGINE, "capacity": 1}
    for make, gen_cls in (
            (lambda clk: jinf.ServingEngine(
                jp, CFG, fused_decode=False, fused_prefill=False,
                clock=clk, **kw), jinf.GenerationConfig),
            (lambda clk: ServingEngine(tp, TCFG, device="cpu", clock=clk,
                                       **kw), GenerationConfig)):
        clk = FakeClock()
        eng = make(clk)
        low = eng.submit(prompts[0], gen_cls(max_new_tokens=8, greedy=True),
                         priority=2)
        for _ in range(3):
            eng.step()
        urgent = eng.submit(prompts[1], gen_cls(max_new_tokens=3,
                                                greedy=True), priority=0)
        late = eng.submit(prompts[2], gen_cls(max_new_tokens=2,
                                              greedy=True),
                          priority=1, deadline_s=0.5)
        eng.step()
        clk.t += 1.0
        eng.drain()
        reqs = [low, urgent, late]
        runs.append(([r.tokens for r in reqs], [r.expired for r in reqs],
                     [r.preemptions for r in reqs], _finish_order(reqs[:2]),
                     {k: eng.counters[k] for k in COUNTERS}))
    assert runs[0] == runs[1]
    tokens, expired, preemptions, _, counters = runs[1]
    assert expired == [False, False, True] and preemptions[0] == 1
    assert counters["preemptions"] == 1 and len(tokens[0]) == 8


def test_slot_recycle_and_page_release(params):
    _, tp = params
    eng = ServingEngine(tp, TCFG, device="cpu", **ENGINE)
    free0 = len(eng.mgr.free)
    rng = np.random.RandomState(1)
    rs = [eng.submit(rng.randint(0, 97, (6,)).astype(np.int32),
                     GenerationConfig(max_new_tokens=4, greedy=True))
          for _ in range(6)]
    eng.step()
    assert 1 <= sum(s.phase != "idle" for s in eng._slots) <= 2
    assert len(eng.mgr.free) < free0
    eng.drain()
    assert all(r.done and len(r.tokens) == 4 for r in rs)
    assert eng.counters["requests_completed"] == 6
    assert len(eng.mgr.free) == free0
    assert eng.idle and eng.mgr.check() == []


def test_submit_validation(params):
    _, tp = params
    eng = ServingEngine(tp, TCFG, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(np.zeros(60, np.int32),
                   GenerationConfig(max_new_tokens=10))
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros(0, np.int32))
    with pytest.raises(NotImplementedError, match="top-k"):
        eng.submit(np.zeros(4, np.int32),
                   GenerationConfig(max_new_tokens=2, top_k=5))


@pytest.mark.parametrize("kw", [
    {"cache_dtype": torch.int8},
    {"kv_offload": True}, {"mesh": 2}, {"prefix_cache": True},
    {"cache_dtype": "int8"},
    {"observability": True}, {"telemetry": True}])
def test_routes_of_later_slices_raise(params, kw):
    """The arguments of slices still to come raise "not ported". The int8
    KV cache (both spellings) has been ported since: it builds int8 pools
    and no scales until its first admission calibrates them. So has
    tensor-parallel serving: an int tp takes the visible CUDA cards (with
    none, it raises), a mesh of CPU devices serves. So has the prefix
    cache: ``prefix_cache=True`` builds the radix tree, ``kv_offload``
    builds its host tier beside it and alone raises the JAX engine's
    "requires prefix_cache" error. So have observability and telemetry
    (the harness, tests/test_torch_observability.py): the engine holds
    the harness (and the plane), which telemetry implies."""
    _, tp = params
    if "prefix_cache" in kw:
        eng = ServingEngine(tp, TCFG, device="cpu", **ENGINE, **kw)
        assert eng.metrics()["prefix_cache"]["cached_pages"] == 0
        assert eng.offload_metrics()["host_pages"] == 0
        return
    if "kv_offload" in kw:
        with pytest.raises(ValueError, match="requires prefix_cache"):
            ServingEngine(tp, TCFG, device="cpu", **ENGINE, **kw)
        eng = ServingEngine(tp, TCFG, device="cpu", prefix_cache=True,
                            **ENGINE, **kw)
        assert eng._pcache._spill_batch is not None
        assert eng._pcache.host_budget is None
        return
    if "cache_dtype" in kw:
        eng = ServingEngine(tp, TCFG, device="cpu", **ENGINE, **kw)
        assert eng._k_pools.dtype == eng._v_pools.dtype == torch.int8
        assert eng._kv_scales is None
        return
    if "mesh" in kw:
        if not torch.cuda.is_available():
            with pytest.raises(ValueError, match="only 0 device"):
                ServingEngine(tp, TCFG, device="cpu", **ENGINE, **kw)
        eng = ServingEngine(tp, TCFG, mesh=ServingMesh.make(
            2, devices=["cpu"] * 2), **ENGINE)
        assert eng.metrics()["mesh"]["tp"] == 2
        return
    eng = ServingEngine(tp, TCFG, device="cpu", **ENGINE, **kw)
    assert eng.observability is not None
    assert (eng.telemetry is not None) == ("telemetry" in kw)
    assert "latency" in eng.metrics()


def test_admission_queue_matches_jax():
    """The copied queue orders, ages, expires and requeues exactly like
    the JAX package's under the same fake clock."""
    orders = []
    for Q in (JQueue, AdmissionQueue):
        clk = FakeClock()
        q = Q(aging_s=2.0, clock=clk)
        entries = [q.push(name, cls=c, deadline_s=d) for name, c, d in
                   [("batch", 3, None), ("std", 1, None), ("rt", 0, 1.5),
                    ("std2", 1, 0.5), ("bulk", 2, None)]]
        log = [q.best().item]
        clk.t = 1.0
        log.append([e.item for e in q.pop_expired()])
        first = q.pop()
        log.append(first.item)
        clk.t = 5.0
        q.requeue(first)
        log.append([(s["cls"], s["effective_cls"], s["seq"],
                     s["requeues"], s["started"]) for s in q.snapshot()])
        log.append([q.pop().item for _ in range(len(q))])
        log.append(entries[0].requeues)
        orders.append(log)
    assert orders[0] == orders[1]
    assert orders[1][1] == ["std2"]


def test_entry_points_default_to_cuda(params):
    """Without device= the port runs on CUDA; with no card it raises
    rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tp = params
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tp, TCFG, **ENGINE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.init_params(TCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(tp, np.zeros((1, 3), np.int32), TCFG)
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_paddle_tpu():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert bad == []
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.inference, "
            "paddle_tpu_torch.ops.kernels; print(sorted(m for m in "
            "sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu', 'triton')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"



def test_chip_smoke_records_every_chunk_after_it_ran(params):
    """chip_smoke.recorded_logits (the card's tensor-parallel parity
    reads it) records one (tag, logits) pair for every prefill chunk and
    every decode step, in the order they ran; a chunk's are the logits of
    its last row, read from a buffer the chunk copies them into (on the
    card outside the graphs' memory pool, after the chunk's replay)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    _, tp = params
    te = ServingEngine(tp, TCFG, device="cpu", **ENGINE)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, 97, (S,)).astype(np.int32) for S in (19, 5)]
    with chip_smoke.recorded_logits() as (seen, stale):
        for p in prompts:
            te.submit(p, GenerationConfig(max_new_tokens=3, greedy=True))
        te.drain()
    tags = [t for t, _ in seen]
    assert stale == []                       # nothing is captured here
    assert tags.count("warmup") == te.counters["prefill_chunks"] == 3
    assert tags.count("step") == te.counters["decode_steps"] > 0
    assert len(tags) == 3 + te.counters["decode_steps"]
    # chunks of 16 and 3 rows of the first prompt, then the second's 5
    with torch.no_grad():
        dense = [tllama.forward(tp, torch.as_tensor(p[None]).long(),
                                TCFG)[0] for p in prompts]
    want = [dense[0][15], dense[0][18], dense[1][4]]
    got = [x for t, x in seen if t == "warmup"]
    for x, w in zip(got, want):
        assert x.shape == (1, TCFG.vocab_size)
        torch.testing.assert_close(x[0], w, atol=1e-4, rtol=1e-4)
