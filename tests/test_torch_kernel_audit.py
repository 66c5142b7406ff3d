"""The port's kernel-geometry gate (``paddle_tpu_torch.analysis``) held
against the JAX package's (``paddle_tpu.analysis``) on the CPU: the same
findings on the same synthetic geometries and on the regression
specimen, the same FLOP model at the cases the two catalogs share, the
whole catalog captured over meta tensors with no finding, the
shared-memory and signature rules at their edges, and the CLI's exit
codes."""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from paddle_tpu.analysis import kernel_rules as jkr
from paddle_tpu.analysis.kernel_catalog import (
    ALL_KERNEL_NAMES as JAX_KERNEL_NAMES, build_demo_kernel_regression as
    jax_demo, capture_case as jax_capture_case, kernel_cases as
    jax_kernel_cases, modeled_flops as jax_modeled_flops)
from paddle_tpu.ops.pallas._util import (KernelLaunchSpec as JSpec,
                                         KernelOperand as JOperand)
from paddle_tpu_torch.analysis import kernel_catalog as kc
from paddle_tpu_torch.analysis.kernel_rules import (bound, check_launch,
                                                    modeled_launch_bytes)
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import _launch
from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def port_reports():
    return kc.audit_kernels()


@pytest.fixture
def no_x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _codes(findings):
    return sorted(f.code for f in findings)


# -- the synthetic specimens of tests/test_kernel_audit.py, both gates --


def _jax(grid, outs, ins=(), accum=(), nsp=0, prefetch=()):
    mk = lambda s: JOperand(shape=tuple(s[0]), dtype="float32",  # noqa
                            block_shape=tuple(s[1]), index_map=s[2])
    return JSpec(name="synthetic", grid=tuple(grid), num_scalar_prefetch=nsp,
                 prefetch=tuple(prefetch), inputs=tuple(mk(s) for s in ins),
                 outputs=tuple(mk(s) for s in outs),
                 accum_outputs=tuple(accum), vmem_budget=10 << 20,
                 interpret=True)


def _port(grid, outs, ins=(), accum=(), paged=()):
    """The same geometry as a port spec: one phase whose items are the
    grid's points (a 1-D grid here), each operand's tile and map as the
    BlockSpec's; ``paged`` inputs are read through tables (no map)."""
    A, O = _launch.Access, _launch.KernelOperand
    items = int(np.prod(grid))
    i_ops = [O(f"in{i}", tuple(s[0]), "float32") for i, s in enumerate(ins)]
    i_ops += [O(name, shape, "float32", kind) for name, shape, kind in paged]
    o_ops = [O(f"out{i}", tuple(s[0]), "float32")
             for i, s in enumerate(outs)]
    phase = _launch.KernelPhase(
        "grid", items,
        tuple(A(f"in{i}", tuple(s[1]), s[2]) for i, s in enumerate(ins)),
        tuple(A(f"out{i}", tuple(s[1]), s[2]) for i, s in enumerate(outs)))
    return _launch.KernelLaunchSpec(
        "synthetic", "cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
        tuple(grid), 128, tuple(i_ops), tuple(o_ops), (phase,), (), "float32",
        accum_outputs=tuple(f"out{i}" for i in accum))


SYNTHETIC = {
    # (grid, outs, ins, accum): the specimens of the JAX tests
    "floor_drop_output": ((3,), [((128,), (32,), lambda i: (i,))], (), ()),
    "floor_drop_mlp_input": ((1,), [((2, 8), (2, 8), lambda j: (0, 0))],
                             [((8, 96), (8, 64), lambda j: (0, j))], (0,)),
    "divisor_grid": ((4,), [((128,), (32,), lambda i: (i,))], (), ()),
    "oob_input": ((4,), [((128,), (32,), lambda i: (i,))],
                  [((128,), (32,), lambda i: (i + 1,))], ()),
    "partial_last_block": ((4,), [((100,), (32,), lambda i: (i,))], (), ()),
    "race_undeclared": ((2,), [((2, 8), (2, 8), lambda j: (0, 0))],
                        [((8, 64), (8, 32), lambda j: (0, j))], ()),
    "race_declared": ((2,), [((2, 8), (2, 8), lambda j: (0, 0))],
                      [((8, 64), (8, 32), lambda j: (0, j))], (0,)),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_specimen_codes_equal_jax(name):
    grid, outs, ins, accum = SYNTHETIC[name]
    want = _codes(jkr.check_launch(_jax(grid, outs, ins, accum)))
    got = check_launch(_port(grid, outs, ins, accum))
    assert _codes(got) == want
    if name == "floor_drop_mlp_input":
        assert [f.site for f in got] == ["synthetic/in0"]
        assert got[0].detail["first_missing_element"] == [0, 64]
    if name in ("divisor_grid", "partial_last_block", "race_declared"):
        assert got == []


def test_paged_reads_are_exempt_like_scalar_prefetch():
    """JAX exempts scalar-prefetch launches from input coverage; the port
    exempts operands read through the block tables."""
    jspec = _jax((2,), [((2, 4), (1, 4), lambda b, bt: (b, 0))],
                 [((16, 4), (1, 4), lambda b, bt: (int(bt[b]), 0))],
                 nsp=1, prefetch=[((2,), "int32")])
    assert jkr.check_launch(jspec) == []
    spec = _port((2,), [((2, 4), (1, 4), lambda b: (b, 0))],
                 paged=[("pool", (16, 1, 1, 4), "tokens"),
                        ("table", (2, 8), "pages")])
    assert check_launch(spec) == []


def _drop_tile(spec, operand, drop):
    """``spec`` with ``operand``'s reads moved off the tiles ``drop(coords)``
    picks (to the tile coordinates it returns)."""
    def doctor(acc):
        if acc.operand != operand:
            return acc
        return dataclasses.replace(
            acc, index_map=lambda i, f=acc.index_map: drop(
                tuple(np.asarray(c) for c in f(i))))
    return dataclasses.replace(spec, phases=tuple(
        dataclasses.replace(ph, reads=tuple(doctor(a) for a in ph.reads))
        for ph in spec.phases))


@pytest.mark.parametrize("name", ["flash_attention_fwd",
                                  "flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv"])
def test_masked_bias_must_cover_the_seen_tiles(name):
    """The bias under the causal mask is exempt past the diagonal only: a
    plan that skips a diagonal bias tile (one some query sees) drops
    work the function needs and fires GRID_FLOOR_DROP."""
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_spec
    spec = flash_spec(name, 2, 256, 256, 4, 2, 64, "float32", True,
                      bias=(1, 4))
    assert check_launch(spec) == []

    def drop(c):
        bb, hh, qt, kt = c
        # the diagonal tile of query tile 2 is read as its neighbour
        return bb, hh, qt, np.where((qt == 2) & (kt == 2), 1, kt)
    bad = check_launch(_drop_tile(spec, "bias", drop))
    assert [(f.code, f.site) for f in bad] == [
        ("GRID_FLOOR_DROP", f"{name}/bias")]
    assert bad[0].detail["first_missing"] == [0, 0, 2, 2]


def test_masked_rows_must_cover_the_rows_that_see_a_key():
    """Causal with sq > sk: the dkv pass need not read the query rows that
    see no key, but must read every query tile that sees one."""
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_spec
    spec = flash_spec("flash_attention_bwd_dkv", 1, 300, 130, 4, 2, 64,
                      "float32", True, seg=True)
    assert check_launch(spec) == []
    last = -(-300 // 64) - 1

    def drop(c):
        bb, qt, hh, z = c
        return bb, np.where(qt == last, last - 1, qt), hh, z
    bad = check_launch(_drop_tile(spec, "q", drop))
    assert [(f.code, f.site) for f in bad] == [
        ("GRID_FLOOR_DROP", "flash_attention_bwd_dkv/q")]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bound_counts_the_pairs_of_one_segment(causal):
    """Given a launch's segment ids, the operations are the pairs of one
    id (under the causal mask), counted by brute force here."""
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_spec
    b, s, h, d = 2, 96, 4, 32
    rng = np.random.default_rng(4)
    seg = np.sort(rng.integers(0, 5, (b, s)), axis=1).astype(np.int32)
    seg[:, -7:] = -1
    spec = flash_spec("flash_attention_fwd", b, s, s, h, h, d, "bfloat16",
                      causal, seg=True)
    pairs = sum(int(seg[bi, r] == seg[bi, c]) for bi in range(b)
                for r in range(s) for c in range(s)
                if not causal or c <= r)
    want = 4.0 * h * d * pairs
    assert kc.needed_flops(spec, segments=(seg, seg)) == want
    assert bound(spec, segments=(torch.as_tensor(seg),
                                 torch.as_tensor(seg)))[3] == want
    # without the ids: every (causal) pair, as the modeled figure
    assert kc.needed_flops(spec) > want
    with pytest.raises(ValueError):
        kc.needed_flops(spec, [1], (seg, seg))


# -- the bf16 backward passes: plans and the segment-tile skip ----------

_BWD = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
_TC = ("flash_attention_fwd",) + _BWD
#: the parent's f32 plans: 256 threads, f32 tiles of stride d + 1
#: (csrc/flash_attention.cu's fwd_smem, dq_smem, dkv_smem)
_PARENT_SMEM = {("flash_attention_fwd", 64): 66560,
                ("flash_attention_fwd", 128): 115712,
                ("flash_attention_bwd_dq", 64): 83712,
                ("flash_attention_bwd_dq", 128): 149248,
                ("flash_attention_bwd_dkv", 64): 100352,
                ("flash_attention_bwd_dkv", 128): 165888}


@pytest.mark.parametrize("name", _TC)
@pytest.mark.parametrize("d", [64, 128])
def test_tensor_core_plans_pass_smem_and_arg_rules(name, d):
    """The bf16 plans of the three kernels (128 threads, bf16 tiles, the
    bias and id stages where the launch has them) fit the card and bind
    the launcher's signature, at both instances' head dims."""
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_spec
    for bias, seg, dbias in ((None, False, False), ((1, 4), True, True),
                             ((2, 4), False, False), (None, True, False)):
        dbias = dbias and name == "flash_attention_bwd_dq"
        spec = flash_spec(name, 2, 256, 256, 4, 2, d, "bfloat16", True,
                          bias=bias, seg=seg, dbias=dbias)
        assert spec.threads == 128 and spec.plan["products"] == "mma"
        assert spec.plan["block"] == 64
        assert spec.dyn_smem == spec.plan["smem"] <= _launch.SMEM_BLOCK
        bad = [f for f in check_launch(spec)
               if f.code in ("SMEM_OVERCOMMIT", "ARG_MISMATCH")]
        assert bad == [], bad
        # two blocks an SM without a bias (8 warps), one with it at d 128
        assert spec.blocks_per_sm == (1 if bias and d == 128 else 2)


@pytest.mark.parametrize("name,d", sorted(_PARENT_SMEM))
def test_f32_plans_are_the_parents(name, d):
    """The f32 instances of the three kernels keep the CUDA-core kernels
    and their plans: 256 threads, the parent's shared memory."""
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_spec
    for bias, seg in ((None, False), ((1, 4), True)):
        spec = flash_spec(name, 1, 128, 128, 4, 2, d, "float32", True,
                          bias=bias, seg=seg)
        assert (spec.threads, spec.dyn_smem, spec.blocks_per_sm) == \
            (256, _PARENT_SMEM[(name, d)], 1)
        assert spec.plan["products"] == "simt"


@st.composite
def _segment_ids(draw):
    """(seg_q [b, sq], seg_k [b, sk]): random ids, monotone packings with
    padding -1 at the end (seg_k = seg_q when the lengths agree), or a
    packing's ids shuffled."""
    b = draw(st.integers(1, 2))
    sq = draw(st.integers(1, 300))
    sk = draw(st.sampled_from([sq, draw(st.integers(1, 300))]))
    kind = draw(st.sampled_from(["random", "packed", "shuffled"]))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)

    def packed(n):
        docs = int(rng.integers(1, 9))
        cuts = np.sort(rng.integers(0, n + 1, docs - 1))
        ids = np.searchsorted(cuts, np.arange(n), side="right")
        ids[n - int(rng.integers(0, n // 3 + 1)):] = -1
        return ids

    def one(n):
        if kind == "random":
            return rng.integers(-1, 4, n)
        ids = packed(n)
        return rng.permutation(ids) if kind == "shuffled" else ids
    seg_q = np.stack([one(sq) for _ in range(b)]).astype(np.int32)
    seg_k = seg_q if sk == sq and kind == "packed" else \
        np.stack([one(sk) for _ in range(b)]).astype(np.int32)
    return seg_q, seg_k


@settings(max_examples=80, deadline=None)
@given(_segment_ids(), st.booleans())
def test_segment_tile_skip_never_drops_a_pair_of_one_id(ids, causal):
    """The Python twin of the kernels' skip (``ranges_meet`` of the two
    tiles' [min, max] ids) keeps every (query tile, key tile) pair that
    holds a (query, key) pair of one id the mask lets see, counted by
    brute force; the tile ranges are each tile's min and max."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    seg_q, seg_k = ids
    b, sq = seg_q.shape
    sk = seg_k.shape[1]
    kept = fa.segment_tiles_kept(seg_q, seg_k)
    need = fa.segment_tiles_needed(seg_q, seg_k, causal)
    brute = np.zeros_like(need)
    for bi in range(b):
        for r in range(sq):
            for c in range(sk):
                if seg_q[bi, r] == seg_k[bi, c] and (not causal
                                                      or r + sk - sq >= c):
                    brute[bi, r // 64, c // 64] = True
    assert np.array_equal(need, brute)
    assert not (need & ~kept).any()
    lo, hi = fa.tile_id_ranges(seg_q)
    for t in range(lo.shape[1]):
        chunk = seg_q[:, t * 64:(t + 1) * 64]
        assert np.array_equal(lo[:, t], chunk.min(1))
        assert np.array_equal(hi[:, t], chunk.max(1))


@pytest.mark.parametrize("name", _TC)
@pytest.mark.parametrize("seed,causal,sq,sk", [(0, True, 512, 512),
                                               (1, True, 700, 300),
                                               (2, False, 300, 450)])
def test_segment_skip_plan_covers_every_needed_tile(name, seed, causal, sq,
                                                    sk):
    """Given the launch's ids, a tensor-core pass's plan computes the pairs
    the skip keeps under the causal mask, and still reads every tile a
    needed pair holds (bias and dbias included): no finding."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    rng = np.random.default_rng(seed)
    ids = []
    for n in (sq, sk):
        cuts = np.sort(rng.integers(1, n, 5))
        row = np.searchsorted(cuts, np.arange(n), side="right")
        row[n - 40:] = -1
        ids.append(np.stack([row, row[::-1].copy()]).astype(np.int32))
    tiles = fa.SegTiles.of(*ids, causal)
    spec = fa.flash_spec(name, 2, sq, sk, 4, 2, 64, "bfloat16", causal,
                         bias=(1, 4), seg=tiles,
                         dbias=name == "flash_attention_bwd_dq")
    assert check_launch(spec) == []
    nqt, nkt = -(-sq // 64), -(-sk // 64)
    q_, k_ = np.arange(nqt)[:, None], np.arange(nkt)[None, :]
    if name != "flash_attention_bwd_dkv":
        visit = k_ < fa._key_tiles(q_ * 64, sk, sk - sq, causal)
    else:
        visit = q_ >= (np.maximum(k_ * 64 - (sk - sq), 0) // 64 if causal
                       else 0)
    visit = np.broadcast_to(visit, (nqt, nkt))
    assert spec.params["pairs"] == int((visit & tiles.kept).sum())
    assert spec.params["pairs_causal"] == 2 * int(visit.sum())
    assert spec.params["pairs"] < spec.params["pairs_causal"]


def test_segment_skip_regression_fires_grid_floor_drop():
    """The specimen's ids under the kernels' skip: no finding; under a skip
    that drops the tile two segments share, GRID_FLOOR_DROP on the
    operands that tile's pairs need (the forward's and the dq pass's key
    side, the dkv pass's query side)."""
    specs = kc.capture_segment_skip()
    assert [sp.name for sp in specs] == list(_TC)
    assert all(check_launch(sp) == [] for sp in specs)
    rep = kc.build_segment_skip_regression()
    assert {f.code for f in rep.findings} == {"GRID_FLOOR_DROP"}
    assert sorted(f.site for f in rep.findings) == sorted(
        [f"{n}/{o}" for n in ("flash_attention_fwd", "flash_attention_bwd_dq")
         for o in ("k", "v", "seg_k")]
        + [f"flash_attention_bwd_dkv/{o}"
           for o in ("q", "do", "lse", "delta", "seg_q")])
    for n in ("flash_attention_fwd", "flash_attention_bwd_dq"):
        k_drop = next(f for f in rep.findings if f.site == f"{n}/k")
        assert k_drop.detail["first_missing"] == [0, 1, 0, 0]


# -- the regression specimen --------------------------------------------

_DEMO_SITES = {"in2": "wg", "in3": "wu", "in4": "wd"}


def test_demo_regression_matches_the_jax_specimen():
    """Three GRID_FLOOR_DROP findings, on wg, wu and wd, with the JAX
    specimen's first missing elements ([0, 64], [0, 64], [64, 0])."""
    jrep = jax_demo()
    want = {}
    for f in jrep.findings:
        assert f.code == "GRID_FLOOR_DROP"
        elem = [b * s for b, s in zip(f.detail["first_missing"],
                                      f.detail["block_shape"])]
        want[_DEMO_SITES[f.site.split("/")[1]]] = elem
    rep = kc.build_demo_kernel_regression()
    assert _codes(rep.findings) == ["GRID_FLOOR_DROP"] * 3
    got = {f.detail["operand"]: f.detail["first_missing_element"]
           for f in rep.findings}
    assert got == want == {"wg": [0, 64], "wu": [0, 64], "wd": [64, 0]}


def test_demo_plan_is_the_floor_divided_one():
    spec, = kc.capture_demo()
    assert spec.name == "demo_prefix_mlp_block"
    assert (spec.plan["up_tiles"], spec.plan["down_k"]) == (1, 64)
    # the plain version cuts the weights to the same 64 columns
    g = torch.Generator().manual_seed(0)
    x, nw = torch.randn(2, 32, generator=g), torch.rand(32, generator=g) + .5
    wg, wu = torch.randn(32, 96, generator=g), torch.randn(32, 96, generator=g)
    wd = torch.randn(96, 32, generator=g)
    cut = fdb.demo_prefix_mlp_block_ref(x, nw, wg, wu, wd)
    assert torch.equal(cut, fdb.mlp_block_ref(x, nw, wg[:, :64], wu[:, :64],
                                              wd[:64]))
    assert not torch.allclose(cut, fdb.mlp_block_ref(x, nw, wg, wu, wd),
                              atol=1e-2)


def test_demo_is_no_runtime_kernel():
    assert "demo_prefix_mlp_block" not in K.WRAPPERS
    assert K.DEMO_WRAPPERS["demo_prefix_mlp_block"] is \
        fdb.demo_prefix_mlp_block_cuda
    from paddle_tpu_torch.ops.kernels.registry import KERNELS
    for op in KERNELS._ops:
        for v in KERNELS.variants(op):
            assert v.fn is not fdb.demo_prefix_mlp_block_cuda


# -- the catalog ----------------------------------------------------------


def test_catalog_is_clean_and_captures_every_declared_kernel(port_reports):
    captured = set()
    for r in port_reports:
        assert r.findings == [], [f.to_dict() for f in r.findings]
        captured.update(r.meta.get("kernels", []))
    assert kc.ALL_KERNEL_NAMES == JAX_KERNEL_NAMES
    assert len(kc.ALL_KERNEL_NAMES) == 18
    assert captured == set(kc.ALL_KERNEL_NAMES)
    assert set(kc.FLOP_FORMULAS) >= set(kc.ALL_KERNEL_NAMES)


def test_catalog_has_tiny_and_flagship_for_every_kernel():
    classes = {}
    for c in kc.kernel_cases():
        for k in c.kernels:
            classes.setdefault(k, set()).add(c.case.split("_")[0])
    for k in kc.ALL_KERNEL_NAMES:
        assert {"tiny", "flagship"} <= classes[k], k


def test_flop_counts_equal_jax_at_shared_cases(no_x64):
    """At every case of the JAX catalog whose launches the port's case of
    the same name makes at the same shapes, the port's modeled FLOPs equal
    the JAX package's, launch for launch."""
    port = {c.name: c for c in kc.kernel_cases()}
    compared = []
    for jc in jax_kernel_cases():
        if jc.name not in port:
            continue
        jspecs, err = jax_capture_case(jc)
        assert err is None, err
        pspecs, perr = kc.capture_case(port[jc.name])
        assert perr is None, perr
        jflops = {s.name: jax_modeled_flops(s) for s in jspecs}
        pflops = {s.name: kc.modeled_flops(s) for s in pspecs}
        if jc.case.startswith("tiny"):
            assert set(jflops) == set(pflops), jc.name
        for name in set(jflops) & set(pflops):
            if jflops[name] == pflops[name]:
                compared.append((jc.name, name))
            else:
                # only a flagship class may differ: its shapes are the
                # port's (LLaMA-7B, the 1.07B rung), not the JAX bench's
                assert not jc.case.startswith("tiny"), (jc.name, name)
    tiny = {c for c, _ in compared if "@tiny" in c}
    assert len(tiny) >= 14, sorted(tiny)
    assert {n for _, n in compared} == set(kc.ALL_KERNEL_NAMES)


def test_bytes_model_matches_the_hand_counts():
    """The catalog's byte model of a decode MLP (weights, x in and out, the
    norm weight) and of a decode attention block at live lengths (the
    pools' live tokens, the live table entries, one rope row per
    sequence)."""
    B, D, F = 8, 4096, 11008
    spec = fdb.mlp_spec(B, D, F, "bfloat16", 0, True, 264, 86016)
    assert modeled_launch_bytes(spec)["total_bytes"] == \
        (3 * D * F + 2 * B * D + D) * 2
    H = KV = 32
    hd, BS, MB = 128, 16, 72
    lens = [0, 1, 15, 16, 17, 1151, 300, 700]
    spec = fdb.attn_spec(B, D, H, KV, hd, BS, MB, B * MB + 1, MB * BS + 1,
                         "bfloat16", 0, 0, True, 264, 86016)
    pages = sum(-(-n // BS) for n in lens)
    want = ((2 * D * H * hd + 2 * D * KV * hd + D) * 2
            + sum(lens) * KV * hd * 2 * 2 + (2 * B * D + 2 * B * KV * hd) * 2
            + B * hd * 4 + 4 * B + 4 * pages)
    assert modeled_launch_bytes(spec, lens)["total_bytes"] == want
    ms, by, nbytes, ops = bound(spec, lens)
    assert by == "bytes" and ms == pytest.approx(want / 3.35e12 * 1e3)


@pytest.mark.parametrize("bits,per_weight", [(8, 1.0), (4, 0.5)])
def test_bytes_model_counts_quantized_weights(bits, per_weight):
    """int8 weights move a byte an element, int4 half of one, plus the
    f32 scale row of each matrix; activations stay in the model type."""
    B, D, F = 8, 4096, 11008
    spec = fdb.mlp_spec(B, D, F, "bfloat16", bits, True, 264, 86016)
    assert modeled_launch_bytes(spec)["total_bytes"] == \
        int(3 * D * F * per_weight) + 4 * (2 * F + D) + (2 * B * D + D) * 2


# -- shared memory at its edges --------------------------------------------


def _smem_spec(dyn, blocks):
    return dataclasses.replace(
        _port((1,), [((8,), (8,), lambda i: (i,))]), dyn_smem=dyn,
        blocks_per_sm=blocks)


@pytest.mark.parametrize("dyn,blocks,sites", [
    # at 227 KB a block fits (with the card's 1 KB, one SM's 228 KB);
    # one byte more passes the block's limit and the SM's
    (227 * 1024, 1, []), (227 * 1024 + 1, 1, ["block", "sm"]),
    # two blocks an SM: 113 KB each with their 1 KB fill the SM exactly
    ((228 * 1024) // 2 - 1024, 2, []),
    ((228 * 1024) // 2 - 1024 + 1, 2, ["sm"])])
def test_smem_overcommit_edges(dyn, blocks, sites):
    found = check_launch(_smem_spec(dyn, blocks))
    assert _codes(found) == ["SMEM_OVERCOMMIT"] * len(sites)
    assert sorted(f.site.split("/")[1] for f in found) == sites


# -- launcher signatures ----------------------------------------------------


def _all_specs():
    specs = []
    for c in kc.kernel_cases():
        got, err = kc.capture_case(c)
        assert err is None, (c.name, err)
        specs += got
    return specs + kc.capture_demo()


def test_arg_rule_silent_on_every_real_launcher():
    specs = _all_specs()
    launchers = {(s.source, name) for s in specs for name, _ in s.calls}
    assert len(launchers) >= 18
    for s in specs:
        assert [f for f in check_launch(s) if f.code == "ARG_MISMATCH"] \
            == [], s.name


def test_arg_rule_fires_on_a_doctored_signature():
    spec, = kc.capture_demo()
    name, codes = spec.calls[0]
    for bad in (codes[:-3] + codes[-2:],            # a float dropped
                ("i",) + codes[1:],                 # a pointer as an int
                codes[:10] + ("l",) + codes[11:]):  # an int as a long long
        doctored = dataclasses.replace(spec, calls=((name, bad),))
        assert "ARG_MISMATCH" in _codes(check_launch(doctored))
    doctored = dataclasses.replace(spec, calls=(("no_such_launcher",
                                                 codes),))
    assert "ARG_MISMATCH" in _codes(check_launch(doctored))


def test_arg_rule_reads_triton_arity():
    spec = K.norms.rms_fwd_spec(24, 128, "float32")
    assert check_launch(spec) == []
    (fn, (npos, consts)), = spec.calls
    for bad in ((npos + 1, consts), (npos, ("ROWS",))):
        doctored = dataclasses.replace(spec, calls=((fn, bad),))
        assert _codes(check_launch(doctored)) == ["ARG_MISMATCH"]


# -- the tile plan ------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 40000), st.sampled_from([2, 4, 8]),
       st.integers(1, 600))
def test_pick_lpr_plan_covers_every_column(ncols, vec, grid):
    lpr = fdb.pick_lpr(ncols, vec, grid)
    assert lpr in (2, 4, 8)
    tc = lpr * vec
    tiles = -(-ncols // tc)
    assert tiles * tc >= ncols > (tiles - 1) * tc
    # the busiest block's columns are the least of the three widths
    cost = lambda w: -(-(-(-ncols // (w * vec))) // grid) * w * vec  # noqa
    assert cost(lpr) == min(cost(w) for w in (2, 4, 8))


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 700).map(lambda n: 8 * n), st.integers(1, 600),
       st.sampled_from(["bfloat16", "float32"]))
def test_mlp_plan_reads_and_writes_everything(F, grid, dt):
    """Any F (a multiple of the 16-byte load) on any grid: the plan's
    gate/up tiles read every column of wg and wu, down reads every row of
    wd and writes every column of the output."""
    spec = fdb.mlp_spec(3, 64, F, dt, 0, True, grid, 4096)
    assert check_launch(spec) == []


# -- capture over meta tensors --------------------------------------------


def _counts():
    out = {}
    for name, fn in list(K.WRAPPERS.items()) + list(K.DEMO_WRAPPERS.items()):
        out[name] = (fn.launches, dict(getattr(fn, "launches_by_weight", {})),
                     dict(getattr(fn, "launches_by_pool", {})),
                     dict(getattr(fn, "launches_by_residual", {})))
    return out


def test_capture_over_meta_counts_no_launch():
    K.reset_launches()
    before = _counts()
    specs = _all_specs()
    assert len(specs) > 40
    assert _counts() == before
    assert all(v[0] == 0 for v in before.values())


@pytest.mark.parametrize("case", ["rms_norm@tiny", "decode_mlp_block@tiny",
                                  "paged_attention@tiny",
                                  "flash_attention@tiny",
                                  "fused_linear_ce@tiny"])
def test_meta_tensors_outside_a_capture_raise(case):
    c = {k.name: k for k in kc.kernel_cases()}[case]
    with pytest.raises(ValueError, match="meta tensors are taken only"):
        c.build()()


def test_all_threads_capture_sees_other_threads():
    """Autograd runs a CUDA backward on its own thread: a thread-local
    capture misses its launches, an all-threads capture records them."""
    import threading
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731

    def launch():
        with _launch.capture_kernel_launches():   # the worker's own
            K.swiglu_fwd_triton(m(4, 64), m(4, 64))
    with _launch.capture_kernel_launches() as local, \
            _launch.capture_kernel_launches(all_threads=True) as every:
        t = threading.Thread(target=launch)
        t.start()
        t.join()
    assert local == [] and [s.name for s in every] == ["swiglu_fwd"]
    assert not _launch.capturing()


def test_meta_outputs_have_the_kernel_shapes():
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    with _launch.capture_kernel_launches() as specs:
        out = fdb.decode_mlp_block_cuda(m(8, 64), m(64), m(64, 96),
                                        m(64, 96), m(96, 64))
        with _launch.capture_kernel_launches() as inner:
            o, lse = K.flash_fwd_cuda(m(1, 128, 4, 64), m(1, 128, 2, 64),
                                      m(1, 128, 2, 64), True)
    assert out.device.type == "meta" and tuple(out.shape) == (8, 64)
    assert tuple(lse.shape) == (1, 4, 128)
    assert [s.name for s in specs] == ["decode_mlp_block",
                                       "flash_attention_fwd"]
    assert [s.name for s in inner] == ["flash_attention_fwd"]


# -- every launch records its spec -------------------------------------------


def _calls(fn_node):
    names = set()
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Call):
            f = node.func
            names.add(f.attr if isinstance(f, ast.Attribute)
                      else getattr(f, "id", None))
    return names


def test_every_launch_site_records_its_spec():
    """Each function of ops/kernels/ that launches (binds a C launcher
    from its spec's calls, or runs Triton kernels) passes ``begin`` first;
    no module but _build and _launch binds a library or compiles a
    Triton kernel itself."""
    root = REPO / "paddle_tpu_torch" / "ops" / "kernels"
    launch_sites = []
    for path in sorted(root.glob("*.py")):
        text = path.read_text()
        if path.name not in ("_build.py", "_launch.py"):
            assert "_build.load(" not in text, path.name
            assert "triton_jit(" not in text.replace(
                "triton_jit at the first launch", ""), path.name
            assert "argtypes" not in text, path.name
        for node in ast.walk(ast.parse(text)):
            if not isinstance(node, ast.FunctionDef):
                continue
            calls = _calls(node)
            binds = any(isinstance(c, ast.Call)
                        and getattr(c.func, "attr", None) == "c_fn"
                        and any(isinstance(a, ast.Starred) for a in c.args)
                        for c in ast.walk(node))
            if binds or "triton_run" in calls:
                launch_sites.append(f"{path.name}:{node.name}")
                assert "begin" in calls, f"{path.name}:{node.name}"
    assert len(launch_sites) >= 13, launch_sites


# -- the CLI ------------------------------------------------------------


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.analysis.kernel_audit",
         "--quiet", *args], capture_output=True, text=True, env=env,
        timeout=300, cwd=str(REPO))


def test_cli_exit_codes(tmp_path):
    out = tmp_path / "doc.json"
    assert _cli("--json", str(out)).returncode == 0      # the whole catalog
    doc = json.loads(out.read_text())
    assert doc["summary"]["findings"] == 0
    # every case, the FLOP formulas and the registry lint
    assert len(doc["programs"]) == len(kc.KERNEL_CASE_NAMES) + 2
    demo = _cli("--case", "decode_mlp_block@tiny", "--demo-regression")
    assert demo.returncode == 2
    assert demo.stderr.count("GRID_FLOOR_DROP") == 3
    # the bad invocations, in this process
    from paddle_tpu_torch.analysis.kernel_audit import main
    assert main(["--quiet", "--case", "no_such_case"]) == 3
    broken = tmp_path / "broken.json"
    broken.write_text("{\"version\": 0}")
    assert main(["--quiet", "--case", "fused_swiglu@tiny", "--baseline",
                 str(broken)]) == 3
    assert main(["--write-baseline", "--demo-regression"]) == 3
    assert main(["--no-such-flag"]) == 3


def test_package_baseline_holds_no_findings():
    from paddle_tpu_torch.analysis import load_baseline
    from paddle_tpu_torch.analysis.kernel_audit import DEFAULT_BASELINE
    assert load_baseline(DEFAULT_BASELINE)["findings"] == {}


# ---------------------------------------------------------------------------
# the chunk-row bodies on the tensor cores: their catalog cases, a dropped
# tile, the body counters
# ---------------------------------------------------------------------------
_TC_CASES = ["prefill_mlp_block@flagship_serving",
             "prefill_mlp_block@chunk128_int8_weights",
             "prefill_mlp_block@chunk128_int4_weights",
             "prefill_mlp_block@chunk32",
             "prefill_mlp_block@chunk32_int8_weights",
             "prefill_mlp_block@chunk32_int4_weights",
             "prefill_mlp_block@tiny_tc",
             "prefill_attn_block@flagship_serving",
             "prefill_attn_block@chunk32", "prefill_attn_block@chunk32_int8",
             "prefill_attn_block@chunk32_int8_weights",
             "prefill_attn_block@chunk32_int4_weights",
             "prefill_attn_block@tiny_tc",
             "prefill_attn_block@chunk128_ragged"]


@pytest.mark.parametrize("name", _TC_CASES)
def test_tensor_core_body_cases_are_clean(name):
    """Every catalog case of the tensor-core bodies captures that body's
    plan and gives no finding."""
    case = {c.name: c for c in kc.kernel_cases()}[name]
    rep = kc.audit_case(case)
    assert rep.findings == [], [f.message for f in rep.findings]
    specs, err = kc.capture_case(case)
    assert err is None and [s.plan["body"] for s in specs] == ["tc"]


@pytest.mark.parametrize("drop,operands", [
    ("up_tiles", {"wg", "wu"}), ("down_tiles", {"wd"}),
    ("down_parts", {"wd"})])
def test_dropped_mlp_tensor_core_tile_is_a_floor_drop(drop, operands):
    """The tensor-core MLP plan with one column tile or one part of F fewer
    leaves rows or columns of the weights it reads untouched: the gate
    reports GRID_FLOOR_DROP on exactly those operands (down's split writes
    x_out whole in its combine, from the parts' workspace)."""
    from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
    from paddle_tpu_torch.ops.kernels import _launch
    B, D, F = 128, 4096, 11008
    plan = fdb.mlp_tc_plan(B, D, F, 0, 132)
    ok = _launch.KernelLaunchSpec(
        "decode_mlp_block", "cuda", fdb._SOURCE, (132,), 256,
        *fdb._mlp_tc_parts(B, D, F, "bfloat16", 0, plan),
        (("decode_mlp_block", fdb.CALLS["decode_mlp_block"]),),
        "bfloat16", blocks_per_sm=1, cooperative=True,
        dyn_smem=fdb.mlp_tc_smem(0), plan=plan)
    assert check_launch(ok) == []
    plan = dict(plan, **{drop: plan[drop] - 1})
    if drop == "down_parts":   # 3 parts' rows, of which 2 are read
        plan["down_parts"] = 3
        ok_parts = fdb._mlp_tc_parts(B, D, F, "bfloat16", 0, plan)[2]
        down = ok_parts[2]
        ok_parts[2] = dataclasses.replace(down, items=down.items * 2 // 3)
        found = check_launch(dataclasses.replace(ok, phases=tuple(ok_parts)))
        assert {f.detail["operand"] for f in found} == operands
        return
    bad = dataclasses.replace(ok, **dict(zip(
        ("inputs", "outputs", "phases"),
        fdb._mlp_tc_parts(B, D, F, "bfloat16", 0, plan))))
    found = check_launch(bad)
    assert {f.code for f in found} == {"GRID_FLOOR_DROP"}
    assert {f.detail["operand"] for f in found} == operands


def test_dropped_prefill_tensor_core_tile_is_a_floor_drop(monkeypatch):
    """prefill_attn_block's tensor-core plan with one o_proj tile fewer:
    GRID_FLOOR_DROP on wo (x_out is written whole by the split's
    combine)."""
    from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
    real = fpb.prefill_tc_plan

    def short(*a):
        plan = real(*a)
        plan["o_tiles"] -= 1
        return plan
    monkeypatch.setattr(fpb, "prefill_tc_plan", short)
    spec = fpb.prefill_spec.__wrapped__(
        128, 4096, 32, 32, 128, 16, 72, 577, "bfloat16", 0, 0, True, 512,
        128, 132, fpb.prefill_tc_smem(0, 0), "tc")
    found = check_launch(spec)
    assert {f.code for f in found} == {"GRID_FLOOR_DROP"}
    assert {f.detail["operand"] for f in found} == {"wo"}


def test_block_wrappers_count_by_body():
    """decode_mlp_block and prefill_attn_block count their launches by body
    ("tc", "cuda_core"; decode_mlp_block "ring" too) under
    launches_by_body(), beside the flash kernels' classes, and
    reset_launches zeroes them."""
    from paddle_tpu_torch.ops import kernels
    by = kernels.launches_by_body()
    want = {"decode_mlp_block": {"ring", "tc", "cuda_core"},
            "prefill_attn_block": {"tc", "cuda_core"}}
    for name in ("decode_mlp_block", "prefill_attn_block"):
        assert set(by[name]) == want[name]
        kernels.WRAPPERS[name].launches_by_body["tc"] += 3
    kernels.reset_launches()
    assert all(v == 0 for name in ("decode_mlp_block", "prefill_attn_block")
               for v in kernels.launches_by_body()[name].values())
