"""PyTorch/CUDA port, the program audit of the catalog and the components
(``paddle_tpu_torch/analysis/catalog.py``, ``ServingEngine``/
``DisaggregatedEngine``/``ServingFleet.program_specs``/``audit``,
``Trainer.audit``) against the JAX package's (tests/test_analysis.py,
tests/test_program_audit.py), on the CPU at the catalog's tiny sizes.

Held: the catalog's programs trace clean, the kernel routes' graphs hold
one ``kernel_launch`` node per launch (at 2 layers: ``serving_decode_block``
two ``decode_block_fused`` and one ``rms_norm_fwd``), the components'
program names EQUAL the JAX components' for the same construction, an
audit leaves an engine's counters, the registry's pins, its generator and
its greedy tokens as a twin's that was not audited (EXACT), and a trainer
whose steps made two programs reports MULTIPLE_SIGNATURES. Nothing here
traces fake CUDA tensors (a CPU build of torch cannot)."""
import dataclasses
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.utils import _pytree as pytree

import paddle_tpu.inference as jinf
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.analysis import REGISTRY, audit_spec, trace_artifacts
from paddle_tpu_torch.analysis.auditor import launch_counts
from paddle_tpu_torch.analysis.catalog import CATALOG_PROGRAMS, build_catalog
from paddle_tpu_torch.distributed.trainer import Trainer
from paddle_tpu_torch.inference import (DisaggregatedEngine,
                                        GenerationConfig, ServingEngine,
                                        ServingFleet, ServingMesh)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops.kernels.registry import KERNELS

pytestmark = pytest.mark.torch_port

CFG = jllama.LlamaConfig(vocab_size=128, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=4,
                         max_position_embeddings=64, dtype=jnp.float32,
                         remat=False)
TCFG = tllama.LlamaConfig(
    **{f.name: getattr(CFG, f.name)
       for f in dataclasses.fields(tllama.LlamaConfig) if f.name != "dtype"},
    dtype=torch.float32)
ENGINE = dict(capacity=2, block_size=8, max_seq_len=64,
              prefill_buckets=(16, 32))


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32)
    return jp, tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


@pytest.fixture(scope="module")
def catalog():
    return {s.name: s for s in build_catalog(register=False)}


# -- the catalog --------------------------------------------------------

@pytest.mark.parametrize("name,launches", [
    ("serving_decode_block", {"decode_block_fused": 2, "rms_norm_fwd": 1}),
    ("serving_decode_fused", {"decode_attn_block": 2,
                              "decode_mlp_block": 2, "rms_norm_fwd": 1}),
    ("serving_prefill_fused", {"prefill_attn_block": 2,
                               "decode_mlp_block": 2, "rms_norm_fwd": 1}),
    ("train_step_fused", {
        "flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
        "flash_attention_bwd_dkv": 2, "rms_norm_fwd": 3,
        "residual_rms_norm_fwd": 2, "rms_norm_bwd": 5, "swiglu_fwd": 2,
        "swiglu_bwd": 2, "linear_ce_fwd": 1, "linear_ce_bwd_dx": 1,
        "linear_ce_bwd_dh": 1, "fused_adamw": 1}),
    ("serving_decode", {})])
def test_kernel_routes_hold_one_node_per_launch(catalog, name, launches):
    """A kernel route's graph holds one ``kernel_launch`` node per launch,
    with the plan its wrapper recorded, and nothing launched or counted;
    the plain route holds none. The fused AdamW's node writes the flat
    master and moments in place. No trace warns about an address."""
    from paddle_tpu_torch.ops import kernels
    before = kernels.launches()
    spec = catalog[name]
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        art = trace_artifacts(spec, f64_probe=False)
    assert launch_counts(art) == launches
    assert sorted(p.name for p in art.plans) == sorted(art.launches)
    assert kernels.launches() == before
    assert not [w for w in ws if "data_ptr" in str(w.message)]
    assert (spec.device == "meta") == bool(launches)
    if name == "train_step_fused":
        # the state (params, flat master, mu, nu, step): all written
        n_p = len(pytree.tree_leaves(spec.args[0][0]))
        assert art.written[:n_p + 4] == (True,) * (n_p + 4)


def test_catalog_names_and_tags(catalog):
    assert list(catalog) == list(CATALOG_PROGRAMS)
    assert catalog["serving_decode_tp"].mesh_axes == ("tp",)
    assert catalog["serving_decode"].carry and \
        catalog["serving_decode"].donate_argnums
    assert "fused" in catalog["train_step_fused"].tags


# -- the components' program names --------------------------------------

def _names(eng):
    return sorted(s.name for s in eng.program_specs(register=False))


@pytest.mark.parametrize("kind", ["plain", "offload", "tp", "disagg",
                                  "fleet"])
def test_program_names_equal_the_jax_components(params, kind):
    jp, tp = params
    if kind == "plain":
        j = jinf.ServingEngine(jp, CFG, **ENGINE)
        t = ServingEngine(tp, TCFG, device="cpu", **ENGINE)
    elif kind == "offload":
        kw = dict(ENGINE, prefix_cache=True, kv_offload=True)
        j = jinf.ServingEngine(jp, CFG, **kw)
        t = ServingEngine(tp, TCFG, device="cpu", **kw)
    elif kind == "tp":
        j = jinf.ServingEngine(jp, CFG, mesh=jinf.ServingMesh.make(tp=2),
                               **ENGINE)
        t = ServingEngine(tp, TCFG, mesh=ServingMesh(("cpu",) * 2),
                          **ENGINE)
    elif kind == "disagg":
        kw = dict(ENGINE, prefill_slots=1, prefix_cache=True)
        j = jinf.DisaggregatedEngine(
            jp, CFG, prefill_devices=jax.devices()[:1],
            decode_devices=jax.devices()[1:2], **kw)
        t = DisaggregatedEngine(tp, TCFG, device="cpu", **kw)
    else:
        j = jinf.ServingFleet([jinf.ServingEngine(jp, CFG, **ENGINE),
                               jinf.ServingEngine(jp, CFG, prefix_cache=True,
                                                  **ENGINE)])
        t = ServingFleet([ServingEngine(tp, TCFG, device="cpu", **ENGINE),
                          ServingEngine(tp, TCFG, device="cpu",
                                        prefix_cache=True, **ENGINE)])
    assert _names(t) == _names(j)


# -- an audit changes nothing -------------------------------------------

def _stream(eng, n, seed):
    rng = np.random.RandomState(seed)
    reqs = [eng.submit(rng.randint(0, 128, (int(s),)).astype(np.int32),
                       GenerationConfig(max_new_tokens=4, greedy=True))
            for s in rng.randint(4, 30, n)]
    eng.drain()
    return [r.output_ids.tolist() for r in reqs]


def test_engine_audit_leaves_the_engine_as_a_twin(params):
    """``audit()`` on every route (its own, "pallas", "block") after a
    stream: the counters (but ``audit_findings``), the pins, the
    generator's state and the next stream's greedy tokens equal a twin's
    that was not audited. The reports are clean and counted."""
    tp = params[1]
    kw = dict(ENGINE, prefix_cache=True, kv_offload=True)
    a = ServingEngine(tp, TCFG, device="cpu", **kw)
    b = ServingEngine(tp, TCFG, device="cpu", **kw)
    assert _stream(a, 4, 1) == _stream(b, 4, 1)
    pins, gen = KERNELS.forced_state(), a._gen.get_state()
    reports = [r for route in (None, "pallas", "block")
               for r in a.audit(register=False, route=route)]
    assert [r.program for r in reports if r.findings] == []
    assert a.counters.pop("audit_findings") == 0
    assert a.counters == b.counters
    assert KERNELS.forced_state() == pins
    assert torch.equal(a._gen.get_state(), gen)
    assert _stream(a, 4, 2) == _stream(b, 4, 2)
    assert a.counters == b.counters
    with pytest.raises(ValueError, match="route"):
        a.program_specs(route="two_stage")


def test_engine_audit_registers_its_programs(params):
    eng = ServingEngine(params[1], TCFG, device="cpu", **ENGINE)
    eng.audit()
    assert REGISTRY.get("serving_prefill_32").args[1].shape == (1, 32)
    assert len(REGISTRY.get("serving_decode").signatures) == 1


@pytest.mark.parametrize("kind", ["disagg", "fleet"])
def test_disagg_and_fleet_audits_count_findings(params, kind):
    tp = params[1]
    if kind == "disagg":
        eng = DisaggregatedEngine(tp, TCFG, device="cpu", prefill_slots=1,
                                  **ENGINE)
        h = eng.counters["handoff_traces"]
    else:
        eng = ServingFleet([ServingEngine(tp, TCFG, device="cpu",
                                          **ENGINE)])
    reports = eng.audit()
    assert reports and all(r.findings == [] for r in reports)
    assert eng.counters["audit_findings"] == 0
    if kind == "disagg":
        assert eng.counters["handoff_traces"] == h
        assert "disagg_kv_insert" in REGISTRY
    else:
        assert "fleet.replica0.serving_decode" in REGISTRY


# -- the trainer --------------------------------------------------------

def _trainer(remat=True):
    cfg = dataclasses.replace(TCFG, remat=remat)
    tr = Trainer(lambda p, t, lab: tllama.loss_fn(p, t, lab, cfg), lr=1e-4,
                 device="cpu")
    return tr, tr.init_state(tllama.init_params(cfg, 0, device="cpu"))


def test_trainer_audit_clean_and_remat_traces():
    """At 2 layers under ``remat`` (the checkpointed layers traced with
    their recomputation): clean, counted, the state declared in place and
    written, and nothing stepped; the remat graph is the larger."""
    tr, state = _trainer()
    toks = np.zeros((2, 16), np.int64)
    rep = tr.audit(state, toks, toks)
    assert rep.findings == [] and tr.counters["audit_findings"] == 0
    assert tr.counters["steps"] == 0 and int(state.step) == 0
    spec = tr.audit_spec(state, toks, toks, register=False)
    art = trace_artifacts(spec, f64_probe=False)
    n_state = len(pytree.tree_leaves(state.tree()))
    assert spec.carry == {i: i for i in range(n_state)}
    assert art.written == (True,) * n_state + (False,) * 3
    with pytest.raises(ValueError, match="init_state"):
        tr.audit(None)
    flat, flat_state = _trainer(remat=False)
    assert len(art.graph.graph.nodes) > len(trace_artifacts(
        flat.audit_spec(flat_state, toks, toks, register=False),
        f64_probe=False).graph.graph.nodes)


def test_trainer_two_signatures_report_multiple_signatures():
    """A trainer whose steps made two programs (two batch shapes) records
    both signatures on its registered spec: MULTIPLE_SIGNATURES."""
    tr, state = _trainer(remat=False)
    for S in (16, 8):
        toks = np.zeros((2, S), np.int64)
        tr.step(state, toks, toks)
    spec = REGISTRY.get("train_step")
    assert len(spec.signatures) == 2
    rep = tr.audit(state, toks, toks)
    assert [f.code for f in rep.findings] == ["MULTIPLE_SIGNATURES"]
    assert tr.counters["audit_findings"] == 1
    assert audit_spec(REGISTRY.get("train_step")).findings == rep.findings


def test_remat_kernel_route_holds_the_recomputation():
    """The kernel route under ``remat`` (the card's train rung): the
    checkpointed layers' forward kernels appear twice, as the captured step
    launches them (chip_smoke's train phase: ``rms_norm_fwd`` 2L+1,
    ``residual_rms_norm_fwd``, ``swiglu_fwd`` and ``flash_attention_fwd``
    2L a step)."""
    from paddle_tpu_torch.analysis.catalog import (_kernel_route,
                                                   _tiny_llama_cfg)
    cfg = _tiny_llama_cfg(seq=32, remat=True, fused_train="pallas")
    tr = Trainer(lambda p, t, lab: tllama.loss_fn(p, t, lab, cfg), lr=1e-4,
                 device="cpu", fused_optimizer=True)
    state = tr.init_state(tllama.init_params(cfg, 0, device="cpu"))
    toks = np.zeros((2, 32), np.int64)
    spec = dataclasses.replace(
        tr.audit_spec(state, toks, toks, register=False), device="meta",
        fn=_kernel_route(tr._train_step_fn(), "flash_attention",
                         "fused_adamw"))
    L = cfg.num_hidden_layers
    assert launch_counts(trace_artifacts(spec, f64_probe=False)) == {
        "rms_norm_fwd": 2 * L + 1, "residual_rms_norm_fwd": 2 * L,
        "swiglu_fwd": 2 * L, "flash_attention_fwd": 2 * L,
        "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
        "rms_norm_bwd": 2 * L + 1, "swiglu_bwd": L, "linear_ce_fwd": 1,
        "linear_ce_bwd_dx": 1, "linear_ce_bwd_dh": 1, "fused_adamw": 1}


def test_fake_trace_reads_no_address(catalog, monkeypatch):
    """The three address checks (``fused_decode_block._check_tensor``,
    ``flash_attention._aligned``, ``fused_train._rows_ok``) skip a fake
    tensor, which has no address: with ``FakeTensor.data_ptr`` made to
    raise, the kernel routes still trace, and the routes the checks pick
    are an aligned real tensor's (nothing copied, nothing staged)."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    from paddle_tpu_torch.ops.kernels import fused_train as kft

    def no_address(self):
        raise AssertionError("a fake tensor's address was read")
    monkeypatch.setattr(FakeTensor, "data_ptr", no_address)
    for name in ("serving_decode_block", "serving_decode_fused",
                 "serving_prefill_fused", "train_step_fused"):
        art = trace_artifacts(catalog[name], f64_probe=False)
        assert art.launches
    with FakeTensorMode():
        x = torch.empty(64, 256, dtype=torch.bfloat16, device="meta")
        head = torch.empty(256, 512, dtype=torch.bfloat16, device="meta")
    assert kfa._aligned(x, None)[0] is x
    assert kft._rows_ok(x, 256, True)
    assert kft.ce_operands(x, head).staged == ()


def test_audit_plans_stay_out_of_surrounding_captures(catalog):
    """An audit inside a capture (chip_smoke audits a trainer inside its
    train path's capture of every thread) hands the capture none of the
    plans its fake traces record: the capture sees the launches the card
    made, and the audit still counts its own."""
    from paddle_tpu_torch.ops.kernels._launch import capture_kernel_launches
    with capture_kernel_launches(all_threads=True) as every, \
            capture_kernel_launches() as local:
        rep = audit_spec(catalog["serving_decode_block"])
    assert rep.meta["launches"] == {"decode_block_fused": 2,
                                    "rms_norm_fwd": 1}
    assert every == [] and local == []


class _OnDevice(torch.Tensor):
    """A CPU tensor that claims ``device`` (no CUDA needed): indexing holds
    its index tensors to lie on the indexed tensor's device, as a mesh over
    several cards needs; ``.to`` moves the claim."""

    @staticmethod
    def __new__(cls, elem, device):
        t = torch.Tensor._make_wrapper_subclass(
            cls, elem.shape, strides=elem.stride(), dtype=elem.dtype,
            device=device)
        t.elem = elem
        return t

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.to:
            dev = torch.device(kwargs.get("device", args[1]))
            return args[0] if dev == args[0].device else _OnDevice(
                args[0].elem.clone(), dev)
        return super().__torch_function__(func, types, args, kwargs)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if func in (aten.index.Tensor, aten.index_put_.default):
            for i in args[1]:
                if i is not None and i.device != args[0].device:
                    raise RuntimeError(f"an index on {i.device} for a "
                                       f"tensor on {args[0].device}")
        dev = next(a.device for a in pytree.tree_leaves(args)
                   if isinstance(a, _OnDevice))
        out = func(*pytree.tree_map_only(_OnDevice, lambda t: t.elem, args),
                   **pytree.tree_map_only(_OnDevice, lambda t: t.elem,
                                          kwargs or {}))
        if func is aten.index_put_.default:
            return args[0]
        return pytree.tree_map_only(torch.Tensor,
                                    lambda t: _OnDevice(t, dev), out)


def test_offload_pair_reads_the_index_on_each_shards_device():
    """The host tier's window pair on a mesh whose shards lie on
    different devices: the engine builds the page index on shard 0's
    device, and each shard's pools read it on their own. The pages come
    back and go in byte for byte."""
    from paddle_tpu_torch.inference.serving import (_offload_extract,
                                                    _offload_insert)
    rng = np.random.default_rng(0)
    devs = ("cpu", "meta")
    pools = [[_OnDevice(torch.as_tensor(rng.standard_normal(
        (2, 6, 4, 1, 3)).astype(np.float32)), d) for d in devs]
        for _ in range(2)]
    idx = _OnDevice(torch.tensor([4, 1]), devs[0])
    got = _offload_extract(pools[0], pools[1], idx)
    for s, (k, v) in enumerate(got):
        assert k.device == torch.device(devs[s])
        for pool, t in ((pools[0][s], k), (pools[1][s], v)):
            assert torch.equal(t.elem, pool.elem[:, [4, 1]].transpose(0, 1))
    dst = _OnDevice(torch.tensor([0, 5]), devs[0])
    _offload_insert(pools[0], pools[1], dst, got)
    for s, (k, v) in enumerate(got):
        assert torch.equal(pools[0][s].elem[:, [0, 5]],
                           k.elem.transpose(0, 1))
        assert torch.equal(pools[1][s].elem[:, [0, 5]],
                           v.elem.transpose(0, 1))
