"""The program catalog of the audit gate (port of
``paddle_tpu/analysis/catalog.py``).

One shared, deterministic set of the programs the port ships: the
trainer's step (the default route and the kernel route), the serving
engine's decode step on its three routes and with int8 weights, the
prefill chunk per bucket and forced onto the fused kernels, the prefix
cache's page copier and the host tier's window pair, the tensor-parallel
decode step and chunk, and the disaggregated engine's programs. Each is
built at the JAX catalog's tiny sizes through the component hook that
production code uses (``Trainer.audit_spec``,
``ServingEngine.program_specs``, ``DisaggregatedEngine.program_specs``), so
the catalog cannot drift from what the components run.

``device``: "cpu" (the default) traces the plain routes on fake CPU
tensors, and the kernel routes (``train_step_fused``,
``serving_decode_fused``, ``serving_decode_block``,
``serving_prefill_fused``) on fake meta tensors with their kernels
recorded as launches (the JAX catalog forces "pallas" the same way);
"cuda" builds every program on the card and traces it on fake CUDA
tensors, the routes the card runs.

Two JAX entries wait for their modules: ``fused_optimizer_step`` (the
eager optimizer's fused step, ROADMAP A9's ``optimizer.py``) and
``collectives`` (a multi-device program, ROADMAP A11's
``distributed/collective.py``). The regression specimens
(:func:`build_demo_regression`, :func:`build_demo_tp_regression`) are
opt-in and never part of the default catalog.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

__all__ = ["build_catalog", "build_demo_regression",
           "build_demo_tp_regression", "CATALOG_PROGRAMS", "WAITING"]

# the default gate set, in audit order
CATALOG_PROGRAMS = ("train_step", "train_step_fused",
                    "serving_decode", "serving_decode_fused",
                    "serving_decode_block",
                    "serving_decode_wq",
                    "serving_prefill_16", "serving_prefill_32",
                    "serving_prefill_fused",
                    "serving_page_copy",
                    "serving_kv_spill_extract",
                    "serving_kv_restore_insert",
                    "serving_decode_tp", "serving_prefill_tp_16",
                    "disagg_decode", "disagg_prefill_16",
                    "disagg_kv_extract", "disagg_kv_insert")

#: the JAX catalog's entries with no port yet, and the ROADMAP item each
#: waits for
WAITING = {"fused_optimizer_step": "A9 (the eager optimizer's fused step)",
           "collectives": "A11 (distributed/collective.py)"}


def _tiny_llama_cfg(seq: int = 64, **kw):
    from ..models.llama import LlamaConfig
    cfg = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=2,
               num_key_value_heads=2, max_position_embeddings=seq,
               remat=False)
    return LlamaConfig(**dict(cfg, **kw))


def _tp_cfg():
    """Divisible head counts for the tensor-parallel specs."""
    return _tiny_llama_cfg(num_attention_heads=4, num_key_value_heads=4,
                           dtype=torch.float32)


class _Owned:
    """A spec function that keeps the object it belongs to alive (a
    trainer's step function holds its trainer weakly)."""

    def __init__(self, fn, owner):
        self.fn, self.owner = fn, owner

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def _kernel_route(fn, *ops):
    """``fn`` with ``ops`` pinned to their CUDA kernels (the route the card
    runs; the meta trace's dispatch would find no variant)."""
    import contextlib

    from ..ops.kernels.registry import KERNELS

    def pinned(*args, **kwargs):
        with contextlib.ExitStack() as stack:
            for op in ops:
                stack.enter_context(KERNELS.force(op, "cuda"))
            return fn(*args, **kwargs)
    return pinned


def _register(specs, register: bool):
    if register:
        from .registry import REGISTRY
        for s in specs:
            REGISTRY.register(s)
    return specs


def _trainer_spec(device, fused: bool):
    import numpy as np

    from ..distributed.trainer import Trainer
    from ..models import llama
    cfg = _tiny_llama_cfg(seq=32, **({"fused_train": "pallas"}
                                     if fused else {}))
    params = llama.init_params(cfg, 0, device=device)
    tr = Trainer(lambda p, t, lab: llama.loss_fn(p, t, lab, cfg), lr=1e-4,
                 device=device, fused_optimizer=True if fused else None)
    state = tr.init_state(params)
    toks = np.zeros((2, 32), np.int64)
    spec = tr.audit_spec(state, toks, toks, register=False)
    fn = _Owned(spec.fn, tr)
    if not fused:
        return dataclasses.replace(spec, fn=fn)
    # the step on its kernels: the fused-train kernels ("pallas"), flash
    # and the fused AdamW, over meta tensors off the card
    return dataclasses.replace(
        spec, name="train_step_fused", tags=spec.tags + ("fused",),
        fn=_kernel_route(fn, "flash_attention", "fused_adamw"),
        device="meta" if torch.device(device).type != "cuda" else None)


def _serving_specs(device, wanted):
    from ..inference.serving import ServingEngine
    from ..models.llama import init_params
    cfg = _tiny_llama_cfg()
    params = init_params(cfg, 0, device=device)
    eng = ServingEngine(params, cfg, capacity=2, block_size=8,
                        max_seq_len=64, prefill_buckets=(16, 32),
                        prefix_cache=True, device=device)
    specs = eng.program_specs(register=False)
    one = dict(capacity=2, block_size=8, max_seq_len=64,
               prefill_buckets=(16,), device=device)
    if wanted & {"serving_decode_fused", "serving_prefill_fused"}:
        # the forced two-stage decode kernels and fused chunk (the JAX
        # catalog's fused_decode="pallas"/fused_prefill="pallas" engines)
        fp = ServingEngine(params, cfg, **one)
        for s in fp.program_specs(register=False, route="pallas"):
            if s.name == "serving_decode_fused":
                specs.append(s)
            elif s.name == "serving_prefill_fused_16":
                specs.append(dataclasses.replace(
                    s, name="serving_prefill_fused"))
    if "serving_decode_block" in wanted:
        blk = ServingEngine(params, cfg, **one)
        specs += [s for s in blk.program_specs(register=False,
                                               route="block")
                  if s.name == "serving_decode_block"]
    if "serving_decode_wq" in wanted:
        wq = ServingEngine(params, cfg, weight_quant="int8", **one)
        specs += [dataclasses.replace(s, name="serving_decode_wq",
                                      tags=s.tags + ("weight_quant",))
                  for s in wq.program_specs(register=False)
                  if s.name == "serving_decode"]
    if wanted & {"serving_kv_spill_extract", "serving_kv_restore_insert"}:
        off = ServingEngine(params, cfg, prefix_cache=True, kv_offload=True,
                            **one)
        specs += [s for s in off.program_specs(register=False)
                  if s.name.startswith("serving_kv_")]
    return specs


def _serving_tp_specs(device):
    from ..inference.serving import ServingEngine
    from ..inference.tp import ServingMesh
    from ..models.llama import init_params
    cfg = _tp_cfg()
    params = init_params(cfg, 0, device=device)
    eng = ServingEngine(params, cfg, capacity=2, block_size=8,
                        max_seq_len=64, prefill_buckets=(16,),
                        mesh=ServingMesh((device,) * 2))
    return eng.program_specs(register=False)


def _disagg_specs(device):
    from ..inference.disagg import DisaggregatedEngine
    from ..models.llama import init_params
    cfg = _tp_cfg()
    params = init_params(cfg, 0, device=device)
    eng = DisaggregatedEngine(params, cfg, capacity=2, prefill_slots=1,
                              block_size=8, max_seq_len=64,
                              prefill_buckets=(16,), device=device)
    return eng.program_specs(register=False)


def build_catalog(names: Optional[List[str]] = None, register: bool = True,
                  device="cpu"):
    """The catalog's ProgramSpecs (all of CATALOG_PROGRAMS, or the named
    subset), in catalog order. Building traces nothing: a spec holds a
    callable and an abstract signature. An unknown name raises (a typo'd
    gate must never pass after auditing nothing)."""
    wanted = set(names) if names is not None else set(CATALOG_PROGRAMS)
    unknown = wanted - set(CATALOG_PROGRAMS)
    if unknown:
        raise ValueError(
            f"unknown catalog program(s): {sorted(unknown)}; known: "
            f"{list(CATALOG_PROGRAMS)}"
            + (f"; not ported yet: {sorted(unknown & set(WAITING))}"
               if unknown & set(WAITING) else ""))
    specs = []
    if "train_step" in wanted:
        specs.append(_trainer_spec(device, fused=False))
    if "train_step_fused" in wanted:
        specs.append(_trainer_spec(device, fused=True))
    if any(n.startswith("serving_") and not n.endswith(("_tp", "_tp_16"))
           for n in wanted):
        specs += _serving_specs(device, wanted)
    if wanted & {"serving_decode_tp", "serving_prefill_tp_16"}:
        specs += _serving_tp_specs(device)
    if any(n.startswith("disagg_") for n in wanted):
        specs += _disagg_specs(device)
    by_name = {s.name: s for s in specs}
    return _register([by_name[n] for n in CATALOG_PROGRAMS
                      if n in wanted], register)


def build_demo_regression(register: bool = False):
    """The PRE-FIX AdamW update in torch as an auditable spec: its bias
    correction ``1 - b1 ** step`` is ``torch.pow`` of a Python float by the
    int32 step tensor, whose result takes the DEFAULT dtype: under a
    float64 default the f32 state's update runs through float64. The
    dtype rule's self-test and the CLI's ``--demo-regression`` check;
    never in the default catalog."""
    from .registry import REGISTRY, ProgramSpec, TensorStruct

    def prefix_adamw(master, mu, nu, step, lr, g):
        b1, b2, eps = 0.9, 0.95, 1e-8
        step.add_(1)
        mu_n = b1 * mu + (1 - b1) * g
        nu_n = b2 * nu + (1 - b2) * torch.square(g)
        mhat = mu_n / (1 - torch.pow(b1, step))     # the bug
        vhat = nu_n / (1 - torch.pow(b2, step))
        master.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
        mu.copy_(mu_n)
        nu.copy_(nu_n)
        return master, mu, nu, step

    f32 = lambda *s: TensorStruct(s, torch.float32)      # noqa: E731
    spec = ProgramSpec(
        name="demo_regression_adamw", fn=prefix_adamw,
        args=(f32(256), f32(256), f32(256), TensorStruct((), torch.int32),
              f32(), f32(256)),
        donate_argnums=(0, 1, 2, 3), carry={0: 0, 1: 1, 2: 2, 3: 3},
        tags=("demo",))
    if register:
        REGISTRY.register(spec)
    return spec


def build_demo_tp_regression(register: bool = False):
    """A mismatched mesh axis for the collective rule: the REAL per-shard
    tensor-parallel decode step (``inference.tp._tp_decode_step``, the
    "psum" placement) over a mesh whose axis is "tp", while the spec
    DECLARES ``mesh_axes=("model",)``: the bug a mesh-axis rename
    introduces (the engine provides "model", the body still reduces over
    "tp"). ``UNKNOWN_COLLECTIVE_AXIS`` must fire. Never in the default
    catalog."""
    from ..inference.tp import ServingMesh, _tp_decode_step
    from ..models.llama import init_params
    from ..ops.rope import build_rope_cache
    from .registry import (REGISTRY, ProgramSpec, TensorStruct,
                           abstract_signature)
    cfg, tp = _tp_cfg(), 2
    mesh = ServingMesh(("cpu",) * tp, axis="tp")
    shards = mesh.shard(init_params(cfg, 0, device="cpu"),
                        mesh.param_specs(cfg))
    L, KV, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                 cfg.head_dim)
    B, BS, NB, MB = 2, 8, 9, 8
    i32 = lambda *s: TensorStruct(s, torch.int32)        # noqa: E731
    pools = [TensorStruct((L, NB, BS, KV // tp, hd), torch.float32)] * tp

    def step(shards, tok, k_pools, v_pools, tables, seq, rope):
        return _tp_decode_step(shards, tok, cfg, k_pools, v_pools, tables,
                               seq, mesh, rope=rope, kv_scales=None,
                               fused=False)
    spec = ProgramSpec(
        name="demo_regression_tp_axis", fn=step,
        args=(abstract_signature(shards), i32(B), pools, list(pools),
              i32(B, MB), i32(B),
              abstract_signature(build_rope_cache(64, hd))),
        mesh_axes=("model",),          # the mismatch: the body psums @tp
        tags=("demo",))
    if register:
        REGISTRY.register(spec)
    return spec
