"""The two-stage decode kernels' weight-ring bodies on the CPU:
``decode_attn_block`` (over int8 pools) and ``decode_mlp_block`` in bf16
at up to 8 rows (``paddle_tpu_torch/csrc/fused_decode_block.cu``, kernels
``decode_attn_ring_kernel`` and ``decode_mlp_ring_kernel`` over
``csrc/weight_ring.cuh``). The kernels run on the card only
(``chip_smoke.py``); here:

- torch twins of the two bodies' summation order (the ring's products as
  ``tests/test_torch_quant_ring.py``'s ``ring_mm`` sums them: each K in the
  plan's parts, a part in chunks, each chunk's depth steps summed from
  zero, the parts added in part order, the column scale last) with the
  two-stage epilogues (q/k/v cast before RoPE; o and down cast to the model
  type, then ``x +`` in that type, or alone without the residual; g and u
  cast, silu(g) * u in the model type), held against the JAX Pallas
  kernels (interpret mode, x64 off) and the port's plain versions
  (``attn_block_wq_ref``, ``mlp_block_wq_ref``) on the same inputs, made
  with numpy from a seed: bf16, int8 and int4 weights, int8 pools (the
  attention's ring is built for no other), residual on and off, 1, 5 and
  8 rows;
- the body rule (dtype, rows, weight class, pool class, shard widths) and
  its one width predicate; each ring plan covering every (weight, tile,
  chunk) once; shared memory against the source's layout; the tickets and
  partial sums the three ring kernels share on a stream; the gate's ring
  cases and a dropped part.

Tolerances: f32 3e-5 absolute, 1e-5 relative (the JAX quantized tests'
own); bf16 two bf16 ulps at the element's magnitude plus two at the
tensor's RMS (``chip_smoke.bf16_close``, the card's bound)."""
import dataclasses
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import fused_decode_block as jfdb
from paddle_tpu_torch.analysis import kernel_catalog as kc
from paddle_tpu_torch.analysis.kernel_rules import check_launch
from paddle_tpu_torch.ops import rms_norm, swiglu
from paddle_tpu_torch.ops.kernels import _build, _launch
from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
from test_torch_quant_ring import (_bf16_close, _close, _pallas, _pools,
                                   _port, _rope, _weights, ring_mm)

pytestmark = pytest.mark.torch_port

#: a small grid splits the tiny K into parts (the card's is 132)
GRID = 5
D, H, HD, FI = 256, 4, 64, 384


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------
def _mm(h, w, part_rows):
    """``h @ w`` in the ring's order, f32: quantized leaves as ``ring_mm``
    sums them (32 stored rows a step); bf16 weights chunk by chunk
    (RING_K rows, their four depth steps summed from zero first), the
    chunks of a part in order, then the parts in part order."""
    if isinstance(w, dict):
        return ring_mm(h, w, part_rows)
    hf, wf = h.float(), w.float()
    total = None
    for p0 in range(0, hf.shape[1], part_rows):
        part = None
        for g0 in range(p0, min(p0 + part_rows, hf.shape[1]), fdb.RING_K):
            t = hf[:, g0:g0 + fdb.RING_K] @ wf[g0:g0 + fdb.RING_K]
            part = t if part is None else part + t
        total = part if total is None else total + part
    return total


def _bits(w):
    return fdb._wq_parts(w)[2]


def attn_ring_twin(args, kv_scales, grid, residual, eps=1e-6):
    """decode_attn_block's ring body in its order: the plan's parts of
    q/k/v and o_proj, the two-stage epilogues."""
    x, nw, wq, wk, wv, wo, sin, cos, kp, vp, tables, lens = args
    B, Dm = x.shape
    _, _, KV, hd = kp.shape
    Hq = fdb._wq_parts(wq)[0].shape[1] // hd
    plan = fdb.ring_plan(B, Dm, Hq, KV, hd, 0, grid, _bits(wq),
                         fdb.ATTN_RING_PHASES)
    rows = {n: plan[n]["part_rows"] for n in fdb.ATTN_RING_PHASES}
    attn, k_new, v_new = fdb._attention(
        x, nw, wq, wk, wv, sin, cos, kp, vp, tables, lens, kv_scales, eps,
        lambda h, w: _mm(h, w, rows["qkv"]).to(h.dtype))
    o = _mm(attn, wo, rows["o_proj"]).to(x.dtype)
    return (x + o if residual else o), k_new, v_new


def mlp_ring_twin(args, grid, residual, eps=1e-6):
    """decode_mlp_block's ring body in its order: the plan's parts of
    gate/up and down, the two-stage epilogues."""
    x, nw, wg, wu, wd = args
    B, Dm = x.shape
    Fi = fdb._wq_parts(wg)[0].shape[1]
    plan = fdb.ring_plan(B, Dm, 0, 1, 0, Fi, grid, _bits(wg),
                         fdb.MLP_RING_PHASES)
    rows = {n: plan[n]["part_rows"] for n in fdb.MLP_RING_PHASES}
    dt = x.dtype
    h = rms_norm(x[:, None], nw, eps)[:, 0]
    ff = swiglu(_mm(h, wg, rows["gate_up"]).to(dt),
                _mm(h, wu, rows["gate_up"]).to(dt))
    o = _mm(ff, wd, rows["down"]).to(dt)
    return x + o if residual else o


def _fp_weights(rng, shapes):
    return [(rng.randn(*s) * s[0] ** -0.5).astype(np.float32)
            for s in shapes]


def _attn_case(seed, B, bits, kv8, KV):
    rng = np.random.RandomState(seed)
    BS, MB = 16, 9
    N = B * MB + 2
    x = (rng.randn(B, D) * 0.5).astype(np.float32)
    nw = (rng.rand(D) + 0.5).astype(np.float32)
    shapes = [(D, H * HD), (D, KV * HD), (D, KV * HD), (H * HD, D)]
    ws = _weights(rng, bits, shapes) if bits else _fp_weights(rng, shapes)
    sin, cos = _rope(BS * MB, HD)
    tables = (rng.permutation(N - 1)[:B * MB] + 1).reshape(B, MB).astype(
        np.int32)
    lens = np.asarray([143, 0, 17, 70, 1, 100, 33, 64][:B], np.int32)
    kp, vp, scales = _pools(rng, kv8, N, BS, KV, HD)
    return [x, nw, *ws, sin, cos, kp, vp, tables, lens], scales


def _mlp_case(seed, B, bits):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, D) * 0.5).astype(np.float32)
    nw = (rng.rand(D) + 0.5).astype(np.float32)
    shapes = [(D, FI), (D, FI), (FI, D)]
    ws = (_weights(rng, bits, shapes, down=2) if bits
          else _fp_weights(rng, shapes))
    return [x, nw, *ws]


def _torch(args, dt, fp_idx):
    """The numpy arguments as port tensors: the activations (and plain
    weights) at ``dt``; quantized leaves, pools of codes, tables and
    lengths as they are."""
    out = [_port(a) for a in args]
    for i in fp_idx:
        if not isinstance(out[i], dict) and out[i].is_floating_point():
            out[i] = out[i].to(dt)
    return out


def _jax(a, dt=jnp.float32):
    if isinstance(a, dict):
        return {k: jnp.asarray(v) for k, v in a.items()}
    a = np.asarray(a)
    return jnp.asarray(a, dt) if a.dtype == np.float32 else jnp.asarray(a)


def _fresh(a):
    a = list(a)
    a[8], a[9] = a[8].clone(), a[9].clone()
    return a


_ATTN_CASES = [(bits, KV, res)
               for bits in (0, 8, 4) for KV in (1, 4)
               for res in (True, False)]


@pytest.mark.parametrize("bits,KV,residual", _ATTN_CASES, ids=[
    f"w{b}-kv8-kv{k}-{'full' if r else 'partial'}"
    for b, k, r in _ATTN_CASES])
def test_attn_ring_twin_matches_jax_and_plain(bits, KV, residual):
    """decode_attn_block's ring order over int8 pools (D 256, H 4, KV 1 and
    4, K split into parts on a 5-block grid but for int4's single chunk)
    against the JAX two-stage attention kernel and attn_block_wq_ref in
    f32, and against attn_block_wq_ref in bf16; the rule picks the ring
    at these widths (H * hd = D) in every weight class. Rows 1, 5 and 8
    alternate across the cases."""
    i = _ATTN_CASES.index((bits, KV, residual))
    B, kv8 = (1, 5, 8)[i % 3], True
    args, scales = _attn_case(100 + i, B, bits, kv8, KV)
    assert fdb.ring_width_reason(bits, D, H * HD, KV * HD, 0,
                                 fdb.ATTN_RING_PHASES) is None
    assert fdb.attn_body(B, D, H, KV, HD, 16, 1, "bfloat16",
                         bits)[0] == "ring"
    plan = fdb.ring_plan(B, D, H, KV, HD, 0, GRID, bits,
                         fdb.ATTN_RING_PHASES)
    # int4 packs K = 256 into 128 stored rows: one chunk, one part
    assert max(plan[n]["parts"] for n in fdb.ATTN_RING_PHASES) > 1 \
        or bits == 4
    jsc = None if scales is None else tuple(map(jnp.asarray, scales))
    want = _pallas(jfdb.fused_attn_block_pallas, *map(_jax, args),
                   kv_scales=jsc, residual=residual)
    tsc = None if scales is None else tuple(map(_port, scales))
    fp_idx = (0, 1, 2, 3, 4, 5) + (() if kv8 else (8, 9))
    t32 = _torch(args, torch.float32, fp_idx)
    twin = attn_ring_twin(_fresh(t32), tsc, GRID, residual)
    plain = fdb.attn_block_wq_ref(*_fresh(t32), kv_scales=tsc,
                                  residual=residual)
    for g, w, p in zip(twin, want, plain):
        _close(g, w)
        _close(g, p)
    t16 = _torch(args, torch.bfloat16, fp_idx)
    twin = attn_ring_twin(_fresh(t16), tsc, GRID, residual)
    plain = fdb.attn_block_wq_ref(*_fresh(t16), kv_scales=tsc,
                                  residual=residual)
    for g, p in zip(twin, plain):
        _bf16_close(g, p)


@pytest.mark.parametrize("B", [1, 5, 8])
@pytest.mark.parametrize("residual", [True, False], ids=["full", "partial"])
@pytest.mark.parametrize("bits", [0, 8, 4], ids=["bf16", "int8", "int4"])
def test_mlp_ring_twin_matches_jax_and_plain(bits, residual, B):
    """decode_mlp_block's ring order (D 256, F 384, gate/up paired, int4
    down packed along its columns, K split into parts on a 5-block grid)
    against the JAX two-stage MLP kernel and mlp_block_wq_ref in f32, and
    against mlp_block_wq_ref in bf16."""
    args = _mlp_case(200 + bits + B + 10 * residual, B, bits)
    assert fdb.mlp_body(B, D, FI, "bfloat16", bits=bits)[0] == "ring"
    plan = fdb.ring_plan(B, D, 0, 1, 0, FI, GRID, bits, fdb.MLP_RING_PHASES)
    assert max(plan[n]["parts"] for n in fdb.MLP_RING_PHASES) > 1
    want = _pallas(jfdb.fused_mlp_block_pallas, *map(_jax, args),
                   residual=residual)
    t32 = _torch(args, torch.float32, range(5))
    twin = mlp_ring_twin(t32, GRID, residual)
    _close(twin, want)
    _close(twin, fdb.mlp_block_wq_ref(*t32, residual=residual))
    t16 = _torch(args, torch.bfloat16, range(5))
    _bf16_close(mlp_ring_twin(t16, GRID, residual),
                fdb.mlp_block_wq_ref(*t16, residual=residual))


def test_ring_twins_differ_from_one_part_by_roundoff_only():
    """The parts change the f32 sums by roundoff only: the same blocks on
    1 and on 5 blocks (1 and several parts a phase) agree to f32
    roundoff, and the summation order is real (not bit for bit)."""
    args, scales = _attn_case(7, 8, 0, True, 4)
    tsc = tuple(map(_port, scales))
    t32 = _torch(args, torch.float32, range(6))
    one = attn_ring_twin(_fresh(t32), tsc, 1, True)[0]
    five = attn_ring_twin(_fresh(t32), tsc, GRID, True)[0]
    _close(one, five)
    m = _torch(_mlp_case(8, 8, 0), torch.float32, range(5))
    _close(mlp_ring_twin(m, 1, True), mlp_ring_twin(m, GRID, True))
    h = torch.from_numpy(np.random.RandomState(3).randn(8, 384)
                         .astype(np.float32))
    assert not torch.equal(_mm(h, m[4], 384), _mm(h, m[4], 128))


# ---------------------------------------------------------------------------
# the body rule and its one width predicate
# ---------------------------------------------------------------------------
SEVEN_B = dict(D=4096, H=32, KV=32, hd=128, F=11008)
TP2 = dict(SEVEN_B, H=16, KV=16, F=5504)
TP4 = dict(SEVEN_B, H=8, KV=8, F=2752)


@pytest.mark.parametrize("B,dt,bits,dims,attn,mlp", [
    (8, "bfloat16", 0, SEVEN_B, "ring", "ring"),
    (1, "bfloat16", 8, SEVEN_B, "ring", "ring"),
    (5, "bfloat16", 4, SEVEN_B, "ring", "ring"),
    (9, "bfloat16", 0, SEVEN_B, "cuda_core", "tc"),
    (8, "float32", 0, SEVEN_B, "cuda_core", "cuda_core"),
    (8, "float32", 8, SEVEN_B, "cuda_core", "cuda_core"),
    (8, "bfloat16", 0, TP2, "ring", "ring"),
    (8, "bfloat16", 8, TP2, "ring", "ring"),
    (8, "bfloat16", 4, TP2, "ring", "ring"),
    (8, "bfloat16", 0, TP4, "cuda_core", "ring"),
    (8, "bfloat16", 8, TP4, "ring", "cuda_core"),
    (8, "bfloat16", 4, TP4, "ring", "cuda_core"),
    (8, "bfloat16", 0, dict(SEVEN_B, F=11000), "ring", "cuda_core"),
    (8, "bfloat16", 4, dict(SEVEN_B, D=4224), "cuda_core", "cuda_core")])
def test_two_stage_body_rule(B, dt, bits, dims, attn, mlp):
    """decode_mlp_block takes the ring in bf16 at up to 8 rows in every
    weight class where its phases pass the ring's width test; the tp=2
    shard widths (H = KV = 16, F 5504) pass in every class; the quantized
    tp=4 F 2752 (not a multiple of RING_QROWS) keeps the MLP's CUDA-core
    body with its reason; f32 keeps the CUDA-core bodies, more rows the
    tensor-core MLP. decode_attn_block (``attn``: its body over int8
    pools) takes the ring where its widths pass and it is measured
    faster (attn_ring_pays: int8 or int4 weights, or bf16 weights at full
    width and at tp=2, not at tp=4); over bf16 pools never. Every rule has
    a reason."""
    got_m, why_m = fdb.mlp_body(B, dims["D"], dims["F"], dt, bits=bits)
    assert got_m == mlp and why_m
    for pool, want in ((1, attn), (2, "cuda_core")):
        got_a, why_a = fdb.attn_body(B, dims["D"], dims["H"], dims["KV"],
                                     dims["hd"], 16, pool, dt, bits)
        assert got_a == want and why_a
        if dt == "bfloat16" and B <= 8 and dims["D"] == 4096:
            assert (why_a == fdb.ATTN_RING_FP_POOLS) == (pool == 2)
    if mlp == "cuda_core" and dt == "bfloat16" and B <= 8:
        assert str(fdb.RING_QROWS if bits else fdb.RING_K) in why_m


def test_gate_specimen_and_chunk_rows_keep_their_bodies():
    """The gate's specimen keeps the CUDA-core plan at 8 bf16 rows; more
    rows keep the tensor-core body; moving RING_MAX_ROWS to 0 (the
    CUDA-core timing on the same inputs) sends 8 rows back to it."""
    assert fdb.mlp_body(8, 64, 96, "bfloat16", fdb.DEMO_TILE)[0] \
        == "cuda_core"
    assert fdb.mlp_body(32, 4096, 11008, "bfloat16", bits=8)[0] == "tc"
    old = fdb.RING_MAX_ROWS
    try:
        fdb.RING_MAX_ROWS = 0
        assert fdb.mlp_body(8, 4096, 11008, "bfloat16")[0] == "cuda_core"
        assert fdb.attn_body(8, 4096, 32, 32, 128, 16, 1, "bfloat16",
                             8)[0] == "cuda_core"
    finally:
        fdb.RING_MAX_ROWS = old


def test_the_three_ring_rules_share_one_width_predicate(monkeypatch):
    """block_body, attn_body and mlp_body ask ring_width_reason, each for
    its own phases, and record its reason."""
    asked = []

    def refuse(bits, D_, nq, nkv, F_, phases=fdb.RING_PHASES):
        asked.append(tuple(phases))
        return "refused by the width test"
    monkeypatch.setattr(fdb, "ring_width_reason", refuse)
    assert fdb.block_body(8, 4096, 32, 32, 128, 11008, "bfloat16", 0) == \
        ("cuda_core", "refused by the width test")
    assert fdb.attn_body(8, 4096, 32, 32, 128, 16, 2, "bfloat16", 0) == \
        ("cuda_core", "refused by the width test")
    assert fdb.mlp_body(8, 4096, 11008, "bfloat16") == \
        ("cuda_core", "refused by the width test")
    assert asked == [fdb.RING_PHASES, fdb.ATTN_RING_PHASES,
                     fdb.MLP_RING_PHASES]


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_width_predicate_matches_the_source_test(bits):
    """ring_width_reason refuses exactly the widths the launchers'
    ring_phase_ok refuses (a transcription of the source's test, over a
    grid of widths)."""
    src = (_build.CSRC / "fused_decode_block.cu").read_text()
    assert "inline bool ring_phase_ok(" in src

    def phase_ok(p, K, ns):
        wc = fdb.wclass(bits, p == 3)
        rows, esz = (fdb.RING_QROWS, 1) if bits else (fdb.RING_K, 2)
        if K <= 0 or (wc == fdb._WINT4K and K % 2):
            return False
        if (K // 2 if wc == fdb._WINT4K else K) % rows:
            return False
        return all(n > 0 and not (wc == fdb._WINT4N and n % 2)
                   and ((n // 2 if wc == fdb._WINT4N else n) * esz) % 16 == 0
                   for n in ns)
    for Dm in (256, 320, 384, 4096, 4224):
        for nq, nkv in ((512, 128), (576, 192), (256, 72)):
            for Fi in (384, 640, 2752, 5504, 11000):
                ok = (phase_ok(0, Dm, (nq, nkv, nkv))
                      and phase_ok(1, nq, (Dm,))
                      and phase_ok(2, Dm, (Fi, Fi))
                      and phase_ok(3, Fi, (Dm,)))
                got = fdb.ring_width_reason(bits, Dm, nq, nkv, Fi)
                assert (got is None) == ok, (Dm, nq, nkv, Fi, got)


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------
def _walk(plan, name, grid, rows_c):
    """{(slot, tile, first stored row of a chunk): reads} of one phase, as
    the kernel walks its items (block b takes items b, b + grid, ...;
    slot-major, then part, then column tile)."""
    ph = plan[name]
    P, rows, kn, tiles = (ph["parts"], ph["part_rows"], ph["kn"],
                          ph["tiles"])
    firsts = np.cumsum([0] + [t * P for t in tiles])
    seen = {}
    for blk in range(grid):
        for i in range(blk, ph["items"], grid):
            s = int(np.searchsorted(firsts, i, side="right") - 1)
            part, t = divmod(i - firsts[s], tiles[s])
            for k0 in range(part * rows, (part + 1) * rows, rows_c):
                if k0 < kn:
                    seen[(s, t, k0)] = seen.get((s, t, k0), 0) + 1
    want = {(s, t, k0) for s, T in enumerate(tiles) for t in range(T)
            for k0 in range(0, kn, rows_c)}
    return seen, want


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["bf16", "int8", "int4"])
@pytest.mark.parametrize("dims,grid", [
    (SEVEN_B, 132), (TP2, 132), (dict(SEVEN_B, KV=8), 132),
    (dict(D=512, H=4, KV=2, hd=64, F=640), 3),
    (dict(D=256, H=4, KV=1, hd=64, F=384), 7)])
def test_two_stage_ring_plans_cover_every_chunk_once(bits, dims, grid):
    """decode_attn_block's plan holds q/k/v and o_proj, decode_mlp_block's
    gate/up and down: each the same phase as decode_block_fused's plan,
    and walked as the kernel walks it, every (weight, stored column tile,
    chunk) is read exactly once, in parts that start inside K; the
    workspaces are sized for the kernel's own phases."""
    Dm, Hq, KV, hd, Fi = (dims[k] for k in ("D", "H", "KV", "hd", "F"))
    full = fdb.ring_plan(8, Dm, Hq, KV, hd, Fi, grid, bits)
    rows_c = fdb.ring_rows(bits)
    for phases, Fk in ((fdb.ATTN_RING_PHASES, 0), (fdb.MLP_RING_PHASES, Fi)):
        Hk, KVk, hdk = (Hq, KV, hd) if Fk == 0 else (0, 1, 0)
        plan = fdb.ring_plan(8, Dm, Hk, KVk, hdk, Fk, grid, bits, phases)
        assert plan["phases"] == phases
        assert set(fdb.RING_PHASES) - set(phases) & set(plan) == set()
        part_ws = tickets = 0
        for name in phases:
            assert plan[name] == full[name], name
            ph = plan[name]
            assert 1 <= ph["parts"] <= fdb.RING_MAX_PARTS
            assert (ph["parts"] - 1) * ph["part_rows"] < ph["kn"]
            seen, want = _walk(plan, name, grid, rows_c)
            assert set(seen) == want and set(seen.values()) == {1}, name
            m = ph["parts"] * (2 if ph["paired"] else 1)
            if m > 1:
                part_ws = max(part_ws, m * 8 * ph["ncols"])
            tickets = max(tickets, ph["tickets"])
        assert (plan["part_ws"], plan["tickets"]) == (part_ws, tickets)


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["bf16", "int8", "int4"])
@pytest.mark.parametrize("KV,pool", [(32, 2), (8, 2), (32, 1), (16, 1)])
def test_ring_shared_memory_is_the_sources(bits, KV, pool):
    """Each ring body's shared memory is the source's ring_smem: the
    source's stages of the class's chunk, kRingAux bytes, then the larger
    of the resident rows [D][8] and one attention item a team
    (decode_attn_block; paged_stream.cuh's scratch with two staged steps)
    or the rows alone (decode_mlp_block); within a block's 227 KB at one
    block an SM, so the grid is 132 blocks. Over int8 pools the items are
    decode_attn_block's kAttnRingTeams, over bf16 pools
    decode_block_fused's kRingTeams."""
    src = (_build.CSRC / "fused_decode_block.cu").read_text()
    ring = (_build.CSRC / "weight_ring.cuh").read_text()
    assert _const(src, "kRingTeams") == fdb.RING_TEAMS
    assert _const(src, "kAttnRingTeams") == fdb.ATTN_RING_TEAMS
    assert _const(src, "kRingAux") == fdb.RING_AUX
    assert _const(ring, "kRingStages") == fdb.RING_STAGES
    g, hd, BS = 32 // KV, 128, 16
    f = 2 * g * hd + g * 4 * BS + 3 * g + hd
    item = -(-(-(-f // 4) * 16 + 2 * 2 * 4 * BS * hd * pool) // 16) * 16
    ring_bytes = fdb.RING_STAGES * fdb.ring_stage_bytes(bits) + fdb.RING_AUX
    # decode_attn_block's ring (int8 pools) in its teams; over bf16 pools
    # the single-launch ring's
    name, teams = (("decode_attn_block_ring", fdb.ATTN_RING_TEAMS)
                   if pool == 1 else ("decode_block_fused_ring",
                                      fdb.RING_TEAMS))
    attn = fdb.ring_smem(4096, 32, KV, hd, BS, pool, bits, teams)
    mlp = fdb.ring_smem(4096, bits=bits)
    assert attn == ring_bytes + max(4096 * 8 * 2, teams * item)
    assert mlp == ring_bytes + 4096 * 8 * 2
    for name, smem in ((name, attn), ("decode_mlp_block_ring", mlp)):
        assert smem <= fdb.SMEM_LIMIT
        assert fdb.assumed_grid(name, smem) == 132


def test_attn_body_refuses_what_does_not_fit():
    """A group of queries whose ATTN_RING_TEAMS attention items and the
    ring do not fit a block (GQA 4:1 over int8 pools with int4 weights)
    keeps the CUDA-core body, with the bytes in its reason."""
    body, why = fdb.attn_body(8, 4096, 32, 8, 128, 16, 1, "bfloat16", 4)
    assert body == "cuda_core" and "shared memory" in why
    assert fdb.ring_smem(4096, 32, 8, 128, 16, 1, 4,
                         fdb.ATTN_RING_TEAMS) > fdb.SMEM_LIMIT


def test_ring_kernels_share_one_ticket_buffer_per_stream(monkeypatch):
    """decode_attn_block then decode_mlp_block (then decode_block_fused, and
    a tp=2 shard's pair) on one stream take the one buffer of that stream:
    each launch leaves its counters at 0 and launches on one stream run in
    turn; it holds a ticket for every tile of the widest phase of each.
    Their f32 partial sums are held the same way: one buffer a stream,
    as large as the largest launch's."""
    monkeypatch.setattr(fdb, "_TICKETS", {})
    monkeypatch.setattr(fdb, "_PARTIALS", {})
    dev = torch.device("cpu")
    plans = [fdb.ring_plan(8, 4096, 32, 32, 128, 0, 132, 0,
                           fdb.ATTN_RING_PHASES),
             fdb.ring_plan(8, 4096, 0, 1, 0, 11008, 132, 0,
                           fdb.MLP_RING_PHASES),
             fdb.ring_plan(8, 4096, 32, 32, 128, 11008, 132, 0),
             fdb.ring_plan(8, 4096, 16, 16, 128, 0, 132, 4,
                           fdb.ATTN_RING_PHASES),
             fdb.ring_plan(8, 4096, 0, 1, 0, 5504, 132, 4,
                           fdb.MLP_RING_PHASES)]
    bufs = [fdb._ring_tickets(dev, p["tickets"], 7) for p in plans]
    assert all(b is bufs[0] for b in bufs)
    assert bufs[0].numel() >= max(p["tickets"] for p in plans)
    assert fdb._ring_tickets(dev, 96, 8) is not bufs[0]
    n = max(p["part_ws"] for p in plans)
    first = fdb._ring_partials(dev, n, 7)
    parts = [fdb._ring_partials(dev, p["part_ws"], 7) for p in plans]
    assert all(b is first for b in parts) and first.numel() >= n
    assert first.dtype == torch.float32
    assert fdb._ring_partials(dev, 4, 8) is not first


def test_launch_setup_is_cached_and_follows_the_plan_constants(monkeypatch):
    """Each wrapper decides its body once a shape (a cached setup: body,
    kernel, region, shared memory), keyed by the plan constants too:
    moving RING_MAX_ROWS (as chip_smoke.cuda_core_block does) gives the
    setup the moved rule's body, and moving it back the cached one."""
    mlp = (8, 4096, 11008, 2, "bfloat16", 0, None)
    first = fdb._mlp_setup(*mlp, fdb._plan_constants())
    assert first[:2] == ("ring", "decode_mlp_block_ring")
    assert fdb._mlp_setup(*mlp, fdb._plan_constants()) is first
    attn = (8, 4096, 32, 32, 128, 16, 2, 1, "bfloat16", 0)
    ring = fdb._attn_setup(*attn, fdb._plan_constants())
    assert ring[:2] == ("ring", "decode_attn_block_ring")
    assert ring[3] == fdb.ring_smem(4096, 32, 32, 128, 16, 1, 0,
                                    fdb.ATTN_RING_TEAMS)
    monkeypatch.setattr(fdb, "RING_MAX_ROWS", 0)
    assert fdb._mlp_setup(*mlp, fdb._plan_constants())[0] == "cuda_core"
    assert fdb._attn_setup(*attn, fdb._plan_constants())[:2] == \
        ("cuda_core", "decode_attn_block")
    monkeypatch.setattr(fdb, "RING_MAX_ROWS", 8)
    assert fdb._mlp_setup(*mlp, fdb._plan_constants()) is first


# ---------------------------------------------------------------------------
# the gate's ring cases
# ---------------------------------------------------------------------------
ATTN_RING_CASES = ["tiny_ring_int8", "tiny_ring_int8_weights_int8",
                   "tiny_ring_int4_weights_int8", "flagship_serving_int8",
                   "flagship_serving_int8_weights_int8",
                   "flagship_serving_int4_weights_int8",
                   "flagship_serving_gqa_int8_weights_int8",
                   "flagship_serving_tp2_partial_int8",
                   "flagship_serving_tp2_partial_int8_weights_int8",
                   "flagship_serving_tp4_partial_int4_weights_int8"]
MLP_RING_CASES = ["tiny_ring", "tiny_ring_int8_weights",
                  "tiny_ring_int4_weights", "flagship_serving",
                  "flagship_serving_int8_weights",
                  "flagship_serving_int4_weights",
                  "flagship_serving_tp2_partial",
                  "flagship_serving_tp2_partial_int8_weights"]
_CASES = ([("decode_attn_block", c) for c in ATTN_RING_CASES]
          + [("decode_mlp_block", c) for c in MLP_RING_CASES])


def _case(op, name):
    return {c.name: c for c in kc.kernel_cases()}[f"{op}@{name}"]


@pytest.mark.parametrize("op,name", _CASES,
                         ids=[f"{o}@{n}" for o, n in _CASES])
def test_two_stage_ring_catalog_cases_are_clean(op, name):
    """Every ring case of the catalog captures its kernel's ring plan at
    the ring's shared memory and grid (one block an SM), its phases in the
    kernel's order, and the gate finds nothing."""
    case = _case(op, name)
    specs, err = kc.capture_case(case)
    assert err is None and len(specs) == 1
    spec = specs[0]
    assert spec.plan["body"] == "ring" and spec.grid == (132,)
    assert spec.blocks_per_sm == 1 and spec.plan["body_rule"]
    want = (["qkv", "pages", "combine", "o_proj"]
            if op == "decode_attn_block" else ["gate_up", "down"])
    assert [p.name for p in spec.phases] == want
    assert kc.audit_case(case).findings == []
    assert check_launch(spec) == []


_DROPS = ([("decode_attn_block", c, d) for c in
           ("flagship_serving_int8", "flagship_serving_int4_weights_int8",
            "tiny_ring_int8")
           for d in ("qkv", "o_proj")]
          + [("decode_mlp_block", c, d) for c in
             ("flagship_serving", "flagship_serving_int8_weights",
              "tiny_ring_int4_weights") for d in ("gate_up", "down")])


@pytest.mark.parametrize("op,name,drop", _DROPS,
                         ids=[f"{o}@{n}-{d}" for o, n, d in _DROPS])
def test_two_stage_ring_dropped_part_is_a_floor_drop(op, name, drop):
    """A ring plan whose phase runs one part fewer than it splits K into
    leaves weight rows unread: GRID_FLOOR_DROP on that phase's weights."""
    spec = kc.capture_case(_case(op, name))[0][0]
    phases = list(spec.phases)
    at = [p.name for p in phases].index(drop)
    ph = phases[at]
    P = spec.plan[drop]["parts"]
    assert P > 1
    reads = tuple(dataclasses.replace(a, items=a.items // P * (P - 1))
                  if a.operand.startswith("w") else a for a in ph.reads)
    phases[at] = dataclasses.replace(ph, reads=reads)
    found = check_launch(dataclasses.replace(spec, phases=tuple(phases)))
    want = {"qkv": {"wq", "wk", "wv"}, "o_proj": {"wo"},
            "gate_up": {"wg", "wu"}, "down": {"wd"}}[drop]
    assert {f.code for f in found} == {"GRID_FLOOR_DROP"}
    assert {f.detail["operand"] for f in found} == want


@pytest.mark.parametrize("name,kv8,bits,H", [
    ("flagship_serving", False, 0, 32),
    ("flagship_serving_tp4_partial_int8", True, 0, 8),
    ("flagship_serving_int8_weights", False, 8, 32),
    ("flagship_serving_tp2_partial", False, 0, 16)])
def test_attn_rule_records_the_measured_reason(name, kv8, bits, H):
    """decode_attn_block's bf16 8-row classes whose ring its measurements
    turn down (bf16 pools; bf16 weights on a tp=4 shard's heads over int8
    pools) capture the CUDA-core plan, and the plan records why
    (attn_ring_pays)."""
    spec = kc.capture_case(_case("decode_attn_block", name))[0][0]
    why = fdb.attn_ring_pays(bits, 1 if kv8 else 2, H * 128, 4096)
    assert why in (fdb.ATTN_RING_FP_POOLS, fdb.ATTN_RING_SHARD)
    assert spec.plan["body"] == "cuda_core" and spec.grid == (264,)
    assert spec.plan["body_rule"] == why
    assert (spec.params["kvbits"], spec.params["wbits"]) == \
        (8 if kv8 else 0, bits)


def test_two_stage_launchers_match_their_signatures():
    """ARG_MISMATCH stays silent on decode_attn_block's launcher (25
    pointers, 22 ints, 2 floats) and decode_mlp_block's (12, 17, 1) at
    every catalog case of both, every body."""
    assert fdb.CALLS["decode_attn_block"] == ("p",) * 25 + ("i",) * 22 \
        + ("f",) * 2 + ("i", "p")
    assert fdb.CALLS["decode_mlp_block"] == ("p",) * 12 + ("i",) * 17 \
        + ("f",) + ("i", "p")
    for c in kc.kernel_cases():
        if not {"decode_attn_block", "decode_mlp_block"} & set(c.kernels):
            continue
        for s in kc.capture_case(c)[0]:
            assert [f for f in check_launch(s) if f.code == "ARG_MISMATCH"] \
                == [], c.name


def test_two_stage_wrappers_count_ring_launches():
    """decode_attn_block counts its launches by body ("ring",
    "cuda_core") and decode_mlp_block by "ring", "tc" and "cuda_core",
    under launches_by_body(); reset_launches zeroes them; a capture over
    meta tensors launches nothing and counts nothing."""
    from paddle_tpu_torch.ops import kernels as K
    by = K.launches_by_body()
    assert set(by["decode_attn_block"]) == {"ring", "cuda_core"}
    assert set(by["decode_mlp_block"]) == {"ring", "tc", "cuda_core"}
    K.WRAPPERS["decode_attn_block"].launches_by_body["ring"] += 2
    K.WRAPPERS["decode_mlp_block"].launches_by_body["ring"] += 2
    K.reset_launches()
    assert all(v == 0 for n in ("decode_attn_block", "decode_mlp_block")
               for v in K.launches_by_body()[n].values())
    with _launch.capture_kernel_launches() as specs:
        kc.capture_case(_case("decode_mlp_block", "flagship_serving"))
    assert K.launches_by_body()["decode_mlp_block"]["ring"] == 0
    assert specs == [] or all(s.plan["body"] == "ring" for s in specs)


def test_chip_smoke_groups_and_audits_the_ring_kernels():
    """chip_smoke's trace groups count the two ring bodies' device kernels
    under their launches, and its ptxas audit maps them to their launch
    names (a kernel it cannot map fails the audit phase)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    attn = ("void paddle_tpu_torch::fused::decode_attn_ring_kernel<8, true>"
            "(paddle_tpu_torch::fused::AttnRingArgs)")
    mlp = ("void paddle_tpu_torch::fused::decode_mlp_ring_kernel<0>"
           "(paddle_tpu_torch::fused::MlpRingArgs)")
    assert chip_smoke._kernel_group(attn) == "decode_attn_block"
    assert chip_smoke._kernel_group(mlp) == "decode_mlp_block"
    kernels = chip_smoke.PTXAS_KERNELS["fused_decode_block"]
    for mangled, launch in (
            ("_ZN16paddle_tpu_torch5fused23decode_attn_ring_kernelILi4ELb1E"
             "EEvNS0_12AttnRingArgsE", "decode_attn_block"),
            ("_ZN16paddle_tpu_torch5fused22decode_mlp_ring_kernelILi8EEEvNS0"
             "_11MlpRingArgsE", "decode_mlp_block")):
        assert [v for k, v in kernels.items() if k in mangled] == [launch]
