"""The split page stream (``paddle_tpu_torch/csrc/paged_stream.cuh``) and
the single-launch decode kernel's weight ring (``csrc/weight_ring.cuh``),
on the CPU: the paged kernel's plan and a numpy twin of its split, step and
combine order against the plain version and the JAX package's
``paged_attention_decode_xla``; the ring's plan (tiles, parts, items,
shared memory, grid, the body rule), its catalog cases under the gate, and
the launchers' signatures. The kernels themselves run on the card only
(``chip_smoke.py``)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.analysis import kernel_catalog as kc
from paddle_tpu_torch.analysis.kernel_rules import check_launch
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import _launch
from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
from paddle_tpu_torch.ops.kernels import paged_attention as pa

pytestmark = pytest.mark.torch_port


def _case(lens, H, KV, MB, hd=16, BS=16, seed=3):
    rng = np.random.RandomState(seed)
    B = len(lens)
    N = B * MB + 1
    table = (rng.permutation(N - 1)[:B * MB] + 1).reshape(B, MB)
    return (rng.randn(B, H, hd).astype(np.float32),
            rng.randn(N, BS, KV, hd).astype(np.float32),
            rng.randn(N, BS, KV, hd).astype(np.float32),
            table.astype(np.int32), np.asarray(lens, np.int32))


def split_stream_np(q, k_pool, v_pool, tables, lens, reverse=False):
    """The kernel's reduction order in numpy f32: per (sequence, KV head)
    splits of SPLIT_PAGES pages, each PAGES_PER_STEP pages a step through
    the online softmax (pages past the last live one clamped to it and
    masked), f32 partials, combined in split order (``reverse``: the
    other way round); 0 with no key."""
    f32 = np.float32
    B, H, hd = q.shape
    _, BS, KV, _ = k_pool.shape
    MB = tables.shape[1]
    G = H // KV
    scale = f32(1.0 / np.sqrt(hd))
    SB = pa.PAGES_PER_STEP * BS
    out = np.zeros_like(q)
    for b in range(B):
        n_pages = min(-(-int(lens[b]) // BS), MB)
        last = max(int(lens[b]) - 1, 0) // BS
        for h in range(KV):
            qg = q[b, h * G:(h + 1) * G]                     # [G, hd]
            parts = []
            for p0 in range(0, n_pages, pa.SPLIT_PAGES):
                p1 = min(p0 + pa.SPLIT_PAGES, n_pages)
                m = np.full(G, -np.inf, f32)
                l = np.zeros(G, f32)
                acc = np.zeros((G, hd), f32)
                for pg in range(p0, p1, pa.PAGES_PER_STEP):
                    pages = [tables[b, min(pg + i, last)]
                             for i in range(pa.PAGES_PER_STEP)]
                    kk = np.concatenate([k_pool[p, :, h] for p in pages])
                    vv = np.concatenate([v_pool[p, :, h] for p in pages])
                    pos = pg * BS + np.arange(SB)
                    seen = pos < lens[b]
                    s = np.where(seen, (qg @ kk.T) * scale, -np.inf)
                    m_new = np.maximum(m, s.max(axis=1))
                    p = np.where(seen, np.exp(s - m_new[:, None]), 0)
                    a = np.where(m_new == -np.inf, 1,
                                 np.exp(m - m_new)).astype(f32)
                    l = (a * l + p.sum(axis=1)).astype(f32)
                    acc = (acc * a[:, None] + p.astype(f32) @ vv
                           ).astype(f32)
                    m = m_new.astype(f32)
                parts.append((m, l, acc))
            if not parts:
                continue
            mx = np.max([pm for pm, _, _ in parts], axis=0)
            lt = np.zeros(G, f32)
            ot = np.zeros((G, hd), f32)
            for pm, pl_, pacc in parts[::-1] if reverse else parts:
                w = np.exp(pm - mx).astype(f32)
                lt = lt + w * pl_
                ot = ot + w[:, None] * pacc
            out[b, h * G:(h + 1) * G] = ot / lt[:, None]
    return out


LENS = [0, 1, 16, 17, 127, None]   # None: MB * BS, the whole table


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
@pytest.mark.parametrize("MB", [9, 11, 16])
def test_split_stream_twin_matches_plain_and_jax(H, KV, MB):
    """The numpy twin of the split page stream (splits of 8 pages, steps
    of 4, f32 partials combined in split order) against the plain version
    and JAX's paged_attention_decode_xla at f32 roundoff: ragged lengths
    0, 1, 16, 17, 127 and the whole table, GQA 1:1 and 4:1, tables of 9,
    11 and 16 pages (a short last split, and none). Length 0 gives exact
    zeros."""
    lens = [MB * 16 if n is None else n for n in LENS]
    args = _case(lens, H, KV, MB)
    twin = split_stream_np(*args)
    ref = pa.paged_attention_decode_ref(*[torch.from_numpy(a) for a in args])
    jx = np.asarray(jpa.paged_attention_decode_xla(
        *[jnp.asarray(a) for a in args]))
    np.testing.assert_allclose(twin, ref.numpy(), atol=2e-6, rtol=2e-5)
    np.testing.assert_allclose(twin, jx, atol=2e-6, rtol=2e-5)
    np.testing.assert_allclose(ref.numpy(), jx, atol=2e-6, rtol=2e-5)
    assert np.all(twin[0] == 0) and np.all(ref.numpy()[0] == 0)


def test_split_order_changes_only_roundoff():
    """Combining the splits in reverse order moves the result by roundoff
    only: the order is a choice of the kernel (fixed, so two launches give
    identical bits), not of the function."""
    args = _case([300, 129, 55, 1], 8, 2, 20)
    a = split_stream_np(*args)
    b = split_stream_np(*args, reverse=True)
    np.testing.assert_array_equal(a, split_stream_np(*args))
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)
    ref = pa.paged_attention_decode_ref(*[torch.from_numpy(x) for x in args])
    np.testing.assert_allclose(a, ref.numpy(), atol=2e-6, rtol=2e-5)


def _capture_paged(B, H, KV, hd, BS, MB, dt="bfloat16"):
    N = B * MB + 1
    meta = lambda *s, d=dt: torch.empty(s, dtype=getattr(torch, d),  # noqa
                                        device="meta")
    with _launch.capture_kernel_launches() as specs:
        pool = meta(N, BS, KV, hd)
        pa.paged_attention_decode_cuda(meta(B, H, hd), pool, pool,
                                       meta(B, MB, d="int32"),
                                       meta(B, d="int32"))
    assert len(specs) == 1
    return specs[0]


@pytest.mark.parametrize("B,H,KV,hd,BS,MB,dt", [
    (8, 32, 32, 128, 16, 72, "bfloat16"), (8, 32, 8, 128, 16, 75, "bfloat16"),
    (8, 32, 32, 128, 16, 72, "float32"), (6, 8, 2, 16, 8, 11, "float32")])
def test_paged_plan_is_the_split_stream(B, H, KV, hd, BS, MB, dt):
    """The paged kernel's recorded plan: one cooperative launch over the
    H100's co-resident blocks (132 x blocks an SM), splits of 8 pages in
    steps of 4 with two staged steps, one item per (split, sequence, KV
    head), the combine in split order; shared memory as the source sizes
    it and within a block's 227 KB; the gate finds nothing."""
    spec = _capture_paged(B, H, KV, hd, BS, MB, dt)
    item = 4 if dt == "float32" else 2
    smem = pa.paged_smem(H // KV, hd, BS, item)
    sb = 4 * BS
    f = 2 * (H // KV) * hd + (H // KV) * sb + 3 * (H // KV) + hd
    assert smem == -(-f // 4) * 16 + 2 * 2 * sb * hd * item
    assert smem <= _launch.SMEM_BLOCK
    per_sm = min(pa.BOUNDS, _launch.SMEM_SM // (smem + 1024))
    assert spec.plan == {
        "grid": 132 * per_sm, "smem": smem, "threads": 256,
        "launch": "cooperative", "split_pages": 8, "pages_per_step": 4,
        "stages": 2, "items": -(-MB // 8) * B * KV, "combine": "split order"}
    assert spec.cooperative and spec.dyn_smem == smem
    assert [p.name for p in spec.phases] == ["pages", "combine"]
    assert check_launch(spec) == []


def test_paged_wrapper_takes_only_cuda_or_meta():
    """On CPU tensors the wrapper raises (the op runs the plain version
    there, bit for bit the twin's function); int8 pools are refused with
    the composition's reason."""
    args = [torch.from_numpy(a) for a in _case([5, 20], 4, 2, 4)]
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention_decode_cuda(*args)
    got = tpa.paged_attention_decode(*args)
    torch.testing.assert_close(got, pa.paged_attention_decode_ref(*args),
                               rtol=0, atol=0)
    q, k, v, t, n = args
    with pytest.raises(TypeError, match="int8"):
        pa.paged_attention_decode_cuda(q, k.to(torch.int8), v.to(torch.int8),
                                       t, n)


# -- the weight ring ------------------------------------------------------
SEVEN_B = dict(D=4096, H=32, KV=32, hd=128, F=11008)


@pytest.mark.parametrize("dims,grid", [
    (SEVEN_B, 132), (dict(SEVEN_B, KV=8), 132),
    (dict(D=512, H=4, KV=2, hd=64, F=640), 3),
    (dict(D=256, H=4, KV=4, hd=64, F=384), 7)])
def test_ring_plan_covers_every_chunk_once(dims, grid):
    """The ring's items, walked as the kernel walks them (block b takes
    items b, b + grid, ...; slot-major, then part, then column tile), read
    every (weight, column tile, chunk of k) exactly once, in parts that
    start inside K; tiles of 128 columns, chunks of 64 rows."""
    D, H, KV, hd, F = (dims[k] for k in ("D", "H", "KV", "hd", "F"))
    plan = fdb.ring_plan(8, D, H, KV, hd, F, grid)
    assert plan["body"] == "ring" and plan["ring_cols"] == 128
    want_cols = {"qkv": (H * hd, KV * hd, KV * hd), "o_proj": (D,),
                 "gate_up": (F, F), "down": (D,)}
    busiest = 0
    for name in fdb.RING_PHASES:
        ph = plan[name]
        P, rows, K_ = ph["parts"], ph["part_rows"], ph["K"]
        assert 1 <= P <= fdb.RING_MAX_PARTS and rows % fdb.RING_K == 0
        assert (P - 1) * rows < K_ <= P * rows
        tiles = ph["tiles"]
        assert tiles == [-(-n // 128) for n in want_cols[name]]
        seen = {}
        firsts = np.cumsum([0] + [t * P for t in tiles])
        for blk in range(grid):
            chunks = 0
            for i in range(blk, ph["items"], grid):
                s = int(np.searchsorted(firsts, i, side="right") - 1)
                j = i - firsts[s]
                part, t = divmod(j, tiles[s])
                for k0 in range(part * rows, (part + 1) * rows, fdb.RING_K):
                    chunks += 1
                    if k0 < K_:
                        key = (s, t, k0)
                        seen[key] = seen.get(key, 0) + 1
            busiest = max(busiest, chunks)
        want = {(s, t, k0) for s, T in enumerate(tiles) for t in range(T)
                for k0 in range(0, K_, fdb.RING_K)}
        assert set(seen) == want and set(seen.values()) == {1}, name
    assert busiest > 0


def test_ring_parts_fill_the_grid_at_7b():
    """At LLaMA-7B on 132 blocks the parts give the busiest block at most
    ~1.05x the chunks of a perfect spread, with at most 4 parts (the
    partial sums stay a few MB)."""
    plan = fdb.ring_plan(8, 4096, 32, 32, 128, 11008, 132)
    assert [plan[n]["parts"] for n in fdb.RING_PHASES] == [4, 4, 3, 4]
    for n in fdb.RING_PHASES:
        ph = plan[n]
        cpi = ph["part_rows"] // 64
        busiest = -(-ph["items"] // 132) * cpi
        perfect = sum(ph["tiles"]) * -(-ph["K"] // 64) / 132
        assert busiest <= 1.05 * perfect + cpi, n
    assert plan["part_ws"] * 4 <= 3 * 2 ** 20 and plan["tickets"] == 96


@pytest.mark.parametrize("B,dt,bits,dims,body", [
    (8, "bfloat16", 0, SEVEN_B, "ring"),
    (1, "bfloat16", 0, SEVEN_B, "ring"),
    (9, "bfloat16", 0, SEVEN_B, "cuda_core"),
    (8, "float32", 0, SEVEN_B, "cuda_core"),
    (8, "bfloat16", 8, SEVEN_B, "ring"),
    (8, "bfloat16", 4, SEVEN_B, "ring"),
    (8, "bfloat16", 0, dict(SEVEN_B, F=11000), "cuda_core"),
    (5, "bfloat16", 4, dict(SEVEN_B, KV=8), "ring"),
    (9, "bfloat16", 8, SEVEN_B, "cuda_core"),
    (8, "float32", 4, SEVEN_B, "cuda_core"),
    (8, "bfloat16", 8, dict(SEVEN_B, F=11000), "cuda_core"),
    (8, "bfloat16", 4, dict(SEVEN_B, D=4224), "cuda_core")])
def test_block_body_rule(B, dt, bits, dims, body):
    """decode_block_fused's body: the weight ring in bf16 at up to 8 rows,
    for bf16 weights with D, F, H * hd multiples of 64 and for int8 and
    int4 codes with every phase's stored rows a multiple of 128 (int4
    packed along K halves D and H * hd); the CUDA-core body (the code and
    bits it had before the ring) for f32, more rows and ragged widths.
    The rule is recorded in the plan."""
    got, why = fdb.block_body(B, dims["D"], dims["H"], dims["KV"],
                              dims["hd"], dims["F"], dt, bits)
    assert got == body and why


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("dims,grid", [
    (SEVEN_B, 132), (dict(SEVEN_B, KV=8), 132),
    (dict(D=512, H=4, KV=2, hd=64, F=640), 3),
    (dict(D=256, H=4, KV=1, hd=64, F=384), 7)])
def test_ring_plan_covers_every_stored_chunk_once(bits, dims, grid):
    """Over int8 and int4 codes the ring's items, walked as the kernel
    walks them, read every (weight, stored column tile, chunk of 128
    stored rows) exactly once: int8 [K][N]; int4 along K (q/k/v, o_proj,
    gate/up: K/2 stored rows, each holding rows k' and k' + K/2); int4
    along N (down: N/2 stored columns, each holding columns c' and
    c' + N/2), in parts that start inside the stored rows."""
    D, H, KV, hd, F = (dims[k] for k in ("D", "H", "KV", "hd", "F"))
    plan = fdb.ring_plan(8, D, H, KV, hd, F, grid, bits)
    assert plan["ring_k"] == fdb.RING_QROWS == 128 and plan["wbits"] == bits
    h = 2 if bits == 4 else 1
    want_cols = {"qkv": (H * hd, KV * hd, KV * hd), "o_proj": (D,),
                 "gate_up": (F, F), "down": (D // h,)}
    want_kn = {"qkv": D // h, "o_proj": H * hd // h, "gate_up": D // h,
               "down": F}
    rows_c = fdb.ring_rows(bits)
    for name in fdb.RING_PHASES:
        ph = plan[name]
        P, rows, kn = ph["parts"], ph["part_rows"], ph["kn"]
        assert kn == want_kn[name] and rows % rows_c == 0
        assert 1 <= P <= fdb.RING_MAX_PARTS and (P - 1) * rows < kn
        assert kn <= P * rows
        tiles = ph["tiles"]
        assert ph["stored_cols"] == list(want_cols[name])
        assert tiles == [-(-n // 128) for n in want_cols[name]]
        seen = {}
        firsts = np.cumsum([0] + [t * P for t in tiles])
        for blk in range(grid):
            for i in range(blk, ph["items"], grid):
                s = int(np.searchsorted(firsts, i, side="right") - 1)
                part, t = divmod(i - firsts[s], tiles[s])
                for k0 in range(part * rows, (part + 1) * rows, rows_c):
                    if k0 < kn:
                        seen[(s, t, k0)] = seen.get((s, t, k0), 0) + 1
        want = {(s, t, k0) for s, T in enumerate(tiles) for t in range(T)
                for k0 in range(0, kn, rows_c)}
        assert set(seen) == want and set(seen.values()) == {1}, name


def test_ring_code_stage_carries_bf16s_bytes():
    """A chunk of codes is 16 KB of weights as a bf16 chunk is (128 rows
    of 128 stored columns, no padding: swizzled), so the ring keeps as
    many bytes in flight; int4's stage adds the second row range of the
    staged activations. The plan's constants are the source's."""
    import re
    from paddle_tpu_torch.ops.kernels import _build
    src = (_build.CSRC / "weight_ring.cuh").read_text()
    for name, const in (("kRingQRows", fdb.RING_QROWS),
                        ("kRingCols", fdb.RING_COLS), ("kRingK", fdb.RING_K)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src)[1]) \
            == const, name
    assert fdb.ring_stage_bytes(0) == 64 * 136 * 2 + 64 * 8 * 2
    assert fdb.ring_stage_bytes(8) == 128 * 128 + 128 * 8 * 2
    assert fdb.ring_stage_bytes(4) == 128 * 128 + 2 * 128 * 8 * 2
    for bits in (0, 8, 4):
        weights = fdb.ring_rows(bits) * 128 * (1 if bits else 2)
        assert weights == 16384


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["bf16", "int8", "int4"])
@pytest.mark.parametrize("KV,pool", [(32, "bfloat16"), (8, "bfloat16"),
                                     (32, "int8"), (8, "int8")])
def test_ring_shared_memory_fits_every_class(bits, KV, pool):
    """The ring body's shared memory for each weight class over both pool
    classes at 7B: 4 stages of the class's chunk, 512 B, and the larger
    of the resident rows and two attention items; within 227 KB at one
    block an SM, so the grid is 132 blocks."""
    item = 1 if pool == "int8" else 2
    smem = fdb.ring_smem(4096, 32, KV, 128, 16, item, bits)
    base = fdb.ring_smem(4096, 32, KV, 128, 16, item)
    assert smem == base + 4 * (fdb.ring_stage_bytes(bits)
                               - fdb.ring_stage_bytes(0))
    assert smem <= _launch.SMEM_BLOCK
    assert fdb.assumed_grid("decode_block_fused_ring", smem) == 132


@pytest.mark.parametrize("KV,pool", [(32, "bfloat16"), (8, "bfloat16"),
                                     (32, "int8")])
def test_ring_shared_memory_and_grid(KV, pool):
    """The ring body's shared memory: 4 stages of (64 x 136 bf16 weights +
    64 x 8 bf16 rows), 512 B of sums and flag, and the larger of the
    resident rows [D][8] and two attention items' scratch (the body's two
    teams) with two staged steps each; within 227 KB at one block an SM,
    so the grid is 132 blocks."""
    item = 1 if pool == "int8" else 2
    smem = fdb.ring_smem(4096, 32, KV, 128, 16, item)
    g = 32 // KV
    f = 2 * g * 128 + g * 64 + 3 * g + 128
    attn = -(-f // 4) * 16 + 2 * 2 * 64 * 128 * item
    assert smem == 4 * (64 * 136 * 2 + 64 * 8 * 2) + 512 + max(65536,
                                                                2 * attn)
    assert smem <= _launch.SMEM_BLOCK < 2 * (smem + 1024)
    assert fdb.assumed_grid("decode_block_fused_ring", smem) == 132


RING_CASES = ["decode_block_fused@flagship_serving",
              "decode_block_fused@flagship_serving_int8",
              "decode_block_fused@tiny_ring",
              "decode_block_fused@flagship_serving_gqa",
              "decode_block_fused@flagship_serving_5_slots",
              "decode_block_fused@flagship_serving_int8_weights",
              "decode_block_fused@flagship_serving_int4_weights",
              "decode_block_fused@tiny_ring_int8_weights",
              "decode_block_fused@tiny_ring_int4_weights",
              "decode_block_fused@flagship_serving_int8_weights_int8"]


@pytest.mark.parametrize("name", RING_CASES)
def test_ring_catalog_cases_are_clean(name):
    """Every ring case of the catalog captures the ring body's plan at its
    own shared memory and grid, and the gate finds nothing (every weight
    tile read, x_out written once, no launcher argument mismatch)."""
    case = {c.name: c for c in kc.kernel_cases()}[name]
    specs, err = kc.capture_case(case)
    assert err is None and len(specs) == 1
    spec = specs[0]
    assert spec.plan["body"] == "ring" and spec.grid == (132,)
    assert spec.blocks_per_sm == 1
    assert [p.name for p in spec.phases] == [
        "qkv", "pages", "combine", "o_proj", "gate_up", "down"]
    assert kc.audit_case(case).findings == []
    assert check_launch(spec) == []


@pytest.mark.parametrize("drop", ["qkv", "gate_up", "down"])
def test_ring_dropped_part_is_a_floor_drop(drop):
    """A ring plan whose phase runs one part fewer than it splits K into
    leaves weight rows unread: GRID_FLOOR_DROP on that phase's weights."""
    import dataclasses
    case = {c.name: c for c in kc.kernel_cases()}[
        "decode_block_fused@flagship_serving"]
    spec = kc.capture_case(case)[0][0]
    phases = list(spec.phases)
    at = [p.name for p in phases].index(drop)
    ph = phases[at]
    P = spec.plan[drop]["parts"]
    reads = tuple(dataclasses.replace(a, items=a.items // P * (P - 1))
                  if a.items and a.items > 1 else a for a in ph.reads)
    phases[at] = dataclasses.replace(ph, reads=reads)
    found = check_launch(dataclasses.replace(spec, phases=tuple(phases)))
    want = {"qkv": {"wq", "wk", "wv"}, "gate_up": {"wg", "wu"},
            "down": {"wd"}}[drop]
    assert {f.code for f in found} == {"GRID_FLOOR_DROP"}
    assert {f.detail["operand"] for f in found} == want


@pytest.mark.parametrize("drop", ["qkv", "o_proj", "gate_up", "down"])
@pytest.mark.parametrize("case", ["flagship_serving_int8_weights",
                                  "flagship_serving_int4_weights",
                                  "flagship_serving_int8_weights_int8"])
def test_ring_dropped_part_of_codes_is_a_floor_drop(case, drop):
    """Over codes too, a phase that runs one part fewer than its plan
    splits K into leaves stored weight rows unread: GRID_FLOOR_DROP on
    that phase's weights (the scales, read by each tile's last item,
    stay whole)."""
    import dataclasses
    spec = kc.capture_case({c.name: c for c in kc.kernel_cases()}[
        "decode_block_fused@" + case])[0][0]
    assert spec.plan["body"] == "ring" and spec.params["wbits"] in (8, 4)
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


def test_new_launchers_match_their_signatures():
    """ARG_MISMATCH stays silent on the paged launcher (7 pointers, 10 ints,
    the scale) and on decode_block_fused's (32 pointers, 28 ints, 2
    floats) at every catalog case, f32 and quantized bodies included."""
    assert pa.CALL[1] == ("p",) * 7 + ("i",) * 10 + ("f", "i", "p")
    assert fdb.CALLS["decode_block_fused"] == ("p",) * 32 + ("i",) * 28 \
        + ("f",) * 2 + ("i", "p")
    for c in kc.kernel_cases():
        if c.op not in ("paged_attention", "decode_block_fused"):
            continue
        for s in kc.capture_case(c)[0]:
            assert [f for f in check_launch(s) if f.code == "ARG_MISMATCH"] \
                == [], c.name


def test_decode_block_counts_by_body():
    """decode_block_fused counts its launches by body ("ring",
    "cuda_core") under launches_by_body(); reset_launches zeroes them."""
    by = K.launches_by_body()
    assert set(by["decode_block_fused"]) == {"ring", "cuda_core"}
    K.WRAPPERS["decode_block_fused"].launches_by_body["ring"] += 2
    K.reset_launches()
    assert set(K.launches_by_body()["decode_block_fused"].values()) == {0}


def _decode_variants():
    import importlib.util
    from pathlib import Path
    path = (Path(__file__).resolve().parents[1] / "paddle_tpu_torch" /
            "tools" / "decode_variants.py")
    spec = importlib.util.spec_from_file_location("decode_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_decode_variants_patch_the_committed_ring():
    """Every variant of ``decode_variants.py`` applies to the committed
    weight ring and sets only the wrapper's own plan constants; its
    stream-only model's ctypes structs hold the C structs' fields in
    order (pointers 8 bytes, ints 4); the stream launcher's arguments are
    what it binds."""
    import re
    from paddle_tpu_torch.ops.kernels import _build
    tool = _decode_variants()
    assert tool.PATCHES["committed"] == ((), {})
    for name, (patches, consts) in tool.PATCHES.items():
        for f, old, new in patches:
            assert old in (_build.CSRC / f).read_text(), (name, f)
        for key in consts:
            assert hasattr(fdb, key), (name, key)
    src = tool.STREAM_SOURCE

    def fields(struct):
        body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S)[1]
        return re.findall(r"(\w+)(?:\[\d+\])?[,;]", body)
    assert fields("Phase") == [f for f, _ in tool._Phase._fields_]
    assert fields("Args") == [f for f, _ in tool._Args._fields_]
    assert ctypes_size(tool._Phase) == 48 and ctypes_size(tool._Args) == 208


def ctypes_size(t):
    import ctypes
    return ctypes.sizeof(t)


@pytest.mark.parametrize("cols", [64, 128, 256])
def test_stream_model_partitions_like_the_ring(cols):
    """The stream-only model splits each phase's K with the ring's own
    rule (ring_parts) over its column tiles: chunks of 16 KB, parts that
    start inside K."""
    tool = _decode_variants()
    D, F = 4096, 11008
    ws = [torch.empty(*s, dtype=torch.bfloat16) for s in
          ((D, D), (D, D), (D, D), (D, D), (D, F), (D, F), (F, D))]
    a = tool.stream_args(ws, cols, 132, torch.zeros(4))
    assert a.kc * cols * 2 == tool.CHUNK_BYTES and a.nph == 4
    for i, (nmat, K, N) in enumerate(((3, D, D), (1, D, D), (2, D, F),
                                      (1, F, D))):
        ph = a.ph[i]
        tiles = N * 2 // ph.tile_bytes
        chunks = -(-K // a.kc)
        assert ph.nmat == nmat and ph.K == K
        assert ph.parts == fdb.ring_parts(tiles * nmat, chunks, 132)
        assert (ph.parts - 1) * ph.part_rows < K <= ph.parts * ph.part_rows


def test_profile_groups_the_ring_kernel_as_its_launch():
    """chip_smoke's trace groups count the ring body's device kernel
    (``decode_block_ring_kernel``) under decode_block_fused, and the
    paged kernel under paged_attention_decode."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    ring = ("void paddle_tpu_torch::fused::decode_block_ring_kernel<false>"
            "(paddle_tpu_torch::fused::BlockArgs)")
    paged = ("void paddle_tpu_torch::fused::paged_attention_decode_kernel"
             "<__nv_bfloat16>(paddle_tpu_torch::fused::PagedArgs)")
    assert chip_smoke._kernel_group(ring) == "decode_block_fused"
    assert chip_smoke._kernel_group(paged) == "paged_attention_decode"
