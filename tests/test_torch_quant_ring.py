"""The summation orders of two kernel bodies, as torch twins on the CPU:
``decode_block_fused``'s weight ring over int8 and int4 codes
(``paddle_tpu_torch/csrc/weight_ring.cuh``) and ``prefill_attn_block``'s
tensor-core attention over int8 pools (``csrc/fused_prefill_block.cu``,
``prefill_attn_tc_phase<true>``). Each twin computes what its kernel
computes in the kernel's order; it is held against the JAX Pallas kernel
(interpret mode, x64 off) and against the port's plain version
(``decode_block_ref``, ``prefill_attn_block_wq_ref``) on the same inputs,
made with numpy from a seed. The kernels themselves run on the card only
(``chip_smoke.py``).

- The ring's order: each product's K in the plan's parts (``ring_plan``),
  a part in chunks of 128 stored rows, each 32 stored rows' depth steps
  summed from zero and added to the part's f32 sum (an int4 byte packed
  along K: its rows k' and k' + K/2 in one step), the parts added in part
  order, and only then the column's scale.
- The kv8 attention's order: per (16-row query block, query head) the
  history's steps first, 128 keys each, then the chunk's; warp w's keys
  [16w, 16w + 16) of each step; S = k_scale * (Q codes^T), then the
  softmax scale; P split into bf16 hi + lo; each step's P V summed from
  zero, times v_scale, added to acc * alpha; the 8 warps combined in warp
  order.

Tolerances: f32 against the JAX kernel and the plain version 3e-5
absolute, 1e-5 relative (the JAX quantized tests' own); bf16 two bf16
ulps at the element's magnitude plus two at the tensor's RMS
(``chip_smoke.bf16_close``, the card's bound for these kernels)."""
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from paddle_tpu.ops.pallas import fused_decode_block as jfdb
from paddle_tpu.ops.pallas import fused_prefill_block as jfpb
from paddle_tpu.quantization import ptq as jptq
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb
from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb

pytestmark = pytest.mark.torch_port

TOL = dict(atol=3e-5, rtol=1e-5)
#: the card's block grid is 132; a small grid splits the tiny K into parts
GRID = 5


def _pallas(fn, *args, **kw):
    """A JAX Pallas kernel in interpret mode, traced with x64 off."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        return fn(*args, **kw)
    finally:
        jax.config.update("jax_enable_x64", prev)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _bf16_close(got, want):
    """Two bf16 ulps (2^-6 relative) at the element's magnitude plus two
    at the tensor's RMS."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    scale = np.maximum(np.abs(g), np.abs(w)) + np.sqrt(np.mean(w * w))
    worst = float(np.max(np.abs(g - w) / scale))
    assert worst <= 2.0 ** -6, worst


def _port(a):
    if isinstance(a, dict):
        return tllama.params_from_jax({k: np.asarray(v) for k, v in
                                       a.items()}, device="cpu")
    return torch.from_numpy(np.array(a))


def _rope(T, hd, pos=None):
    inv = 1.0 / (10000.0 ** (np.arange(0, hd, 2) / hd))
    t = (np.arange(T) if pos is None else pos)[:, None] * inv[None, :]
    return np.sin(t).astype(np.float32), np.cos(t).astype(np.float32)


def _weights(rng, bits, shapes, down=None):
    ws = [(rng.randn(*s) * s[0] ** -0.5).astype(np.float32) for s in shapes]
    return [jptq.quantize_leaf(w, bits, pack_axis=1 if i == down else 0)
            for i, w in enumerate(ws)]


def _pools(rng, kv8, N, BS, KV, hd):
    if kv8:
        kp = rng.randint(-127, 128, (N, BS, KV, hd)).astype(np.int8)
        vp = rng.randint(-127, 128, (N, BS, KV, hd)).astype(np.int8)
        return kp, vp, ((rng.rand(KV) * 0.02 + 0.005).astype(np.float32),
                        (rng.rand(KV) * 0.02 + 0.005).astype(np.float32))
    return (rng.randn(N, BS, KV, hd).astype(np.float32),
            rng.randn(N, BS, KV, hd).astype(np.float32), None)


# ---------------------------------------------------------------------------
# the weight ring over codes
# ---------------------------------------------------------------------------
def ring_mm(h, w, part_rows, group=32):
    """``h @ w`` for a quantized leaf in the ring's order (the module
    header): f32 [rows, N], the column scale applied last."""
    q, s, bits, axis = fdb._wq_parts(w)
    hf = h.float()
    K = hf.shape[1]
    along_k = bits == 4 and axis == 0
    qf = (fdb.unpack_int4(q, axis) if bits == 4 else q).float()
    kn = K // 2 if along_k else K                     # stored rows
    total = None
    for p0 in range(0, kn, part_rows):
        part = None
        for g0 in range(p0, min(p0 + part_rows, kn), group):
            idx = torch.arange(g0, min(g0 + group, kn))
            if along_k:
                idx = torch.cat([idx, idx + K // 2])
            t = hf[:, idx] @ qf[idx]
            part = t if part is None else part + t
        total = part if total is None else total + part
    return total * s.float()


def ring_block_twin(args, kv_scales, grid, eps=1e-6):
    """decode_block_fused's ring body over codes, in its order: the plan's
    parts for each phase, decode_block_ref's rounding points."""
    (x, nw, wq, wk, wv, wo, pw, wg, wu, wd, sin, cos, kp, vp, tables,
     lens) = args
    B, D = x.shape
    _, _, KV, hd = kp.shape
    H = fdb._wq_parts(wq)[0].shape[1] // hd
    Fi = fdb._wq_parts(wg)[0].shape[1]
    bits = fdb._wq_parts(wq)[2]
    plan = fdb.ring_plan(B, D, H, KV, hd, Fi, grid, bits)
    rows = {n: plan[n]["part_rows"] for n in fdb.RING_PHASES}
    dt = x.dtype
    attn, k_new, v_new = fdb._attention(
        x, nw, wq, wk, wv, sin, cos, kp, vp, tables, lens, kv_scales, eps,
        lambda h, w: ring_mm(h, w, rows["qkv"]).to(h.dtype))
    resid = x.float() + ring_mm(attn, wo, rows["o_proj"])
    ms = torch.mean(torch.square(resid), dim=-1, keepdim=True)
    h = (resid * torch.rsqrt(ms + eps)).to(dt) * pw
    g = ring_mm(h, wg, rows["gate_up"]).to(dt)
    u = ring_mm(h, wu, rows["gate_up"]).to(dt)
    down = ring_mm(F.silu(g) * u, wd, rows["down"])
    return (resid + down).to(dt), k_new, v_new


def _block_case(seed, B, bits, kv8, D=256, H=4, KV=1, hd=64, Fi=384):
    rng = np.random.RandomState(seed)
    BS, MB = 16, 9
    N = B * MB + 2
    x = (rng.randn(B, D) * 0.5).astype(np.float32)
    nw = (rng.rand(D) + 0.5).astype(np.float32)
    pw = (rng.rand(D) + 0.5).astype(np.float32)
    ws = _weights(rng, bits, [(D, H * hd), (D, KV * hd), (D, KV * hd),
                              (H * hd, D), (D, Fi), (D, Fi), (Fi, D)],
                  down=6)
    sin, cos = _rope(BS * MB, hd)
    tables = (rng.permutation(N - 1)[:B * MB] + 1).reshape(B, MB).astype(
        np.int32)
    lens = np.asarray([0, 1, 17, 70, 143, 100, 33, 64][:B], np.int32)
    kp, vp, scales = _pools(rng, kv8, N, BS, KV, hd)
    args = [x, nw, *ws[:4], pw, *ws[4:], sin, cos, kp, vp, tables, lens]
    return args, scales


def _torch_args(args, dt):
    out = [_port(a) for a in args]
    for i in (0, 1, 6):                        # x, nw, pw
        out[i] = out[i].to(dt)
    if out[12].dtype != torch.int8:            # fp pools
        out[12], out[13] = out[12].to(dt), out[13].to(dt)
    return out


def _fresh_pools(a):
    a = list(a)
    a[12], a[13] = a[12].clone(), a[13].clone()
    return a


@pytest.mark.parametrize("B", [5, 8])
@pytest.mark.parametrize("kv8", [False, True], ids=["fp_pools",
                                                    "int8_pools"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_ring_twin_matches_jax_and_plain(bits, kv8, B):
    """The ring's order over codes (GQA 4:1, D 256, F 384, K split into
    parts on a 5-block grid) against the JAX single-launch kernel and
    decode_block_ref in f32, and against decode_block_ref in bf16; the
    plan is the ring's at these widths."""
    args, scales = _block_case(60 + bits + B + 2 * kv8, B, bits, kv8)
    assert fdb.block_body(B, 256, 4, 1, 64, 384, "bfloat16", bits)[0] \
        == "ring"
    plan = fdb.ring_plan(B, 256, 4, 1, 64, 384, GRID, bits)
    assert max(plan[n]["parts"] for n in fdb.RING_PHASES) > 1
    jsc = None if scales is None else tuple(map(jnp.asarray, scales))
    want = _pallas(jfdb.fused_decode_block_pallas,
                   *[jnp.asarray(a) if not isinstance(a, dict) else
                     {k: jnp.asarray(v) for k, v in a.items()}
                     for a in args], kv_scales=jsc)
    tsc = None if scales is None else tuple(map(_port, scales))
    t32 = _torch_args(args, torch.float32)
    twin = ring_block_twin(_fresh_pools(t32), tsc, GRID)
    plain = fdb.decode_block_ref(*_fresh_pools(t32), kv_scales=tsc)
    for g, w, p in zip(twin, want, plain):
        _close(g, w)
        _close(g, p)
    t16 = _torch_args(args, torch.bfloat16)
    twin = ring_block_twin(_fresh_pools(t16), tsc, GRID)
    plain = fdb.decode_block_ref(*_fresh_pools(t16), kv_scales=tsc)
    for g, p in zip(twin, plain):
        _bf16_close(g, p)


def test_ring_twin_orders_differ_only_by_roundoff():
    """The ring's parts change the f32 sums by roundoff only: the same
    layer on 1 and on 5 blocks (1 and up to 4 parts a phase) agree to f32
    roundoff, and not bit for bit (the order is real)."""
    args, scales = _block_case(71, 8, 8, False)
    t32 = _torch_args(args, torch.float32)
    one = ring_block_twin(_fresh_pools(t32), None, 1)[0]
    five = ring_block_twin(_fresh_pools(t32), None, GRID)[0]
    _close(one, five)
    h = torch.from_numpy(np.random.RandomState(3).randn(8, 384)
                         .astype(np.float32))
    w = _port(args[9])
    assert not torch.equal(ring_mm(h, w, 128), ring_mm(h, w, 32, group=8))


# ---------------------------------------------------------------------------
# the kv8 tensor-core attention
# ---------------------------------------------------------------------------
KEY_STEP, SLICE, WARPS = 128, 16, 8


def _split_bf16(p):
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def kv8_tc_attention(q, codes_k, codes_v, ks, vs, k_new, v_new, pos0, nv,
                     scale):
    """prefill_attn_tc_phase<true>'s attention in its order (the module
    header). q [P, H, hd] (bf16 values); codes [pos0, KV, hd] int8 (the
    history gathered); k_new/v_new [P, KV, hd] (bf16 values). Returns the
    normalised rows [P, H, hd] f32 (real rows only)."""
    P, H, hd = q.shape
    KV = codes_k.shape[1]
    G = H // KV
    out = torch.zeros(P, H, hd)
    ck, cv = codes_k.float(), codes_v.float()
    for q0 in range(0, nv, 16):
        rows = torch.arange(q0, q0 + 16)
        nk = pos0 + min(q0 + 16, nv)
        hs = -(-pos0 // KEY_STEP)
        steps = hs + -(-(nk - pos0) // KEY_STEP)
        for h in range(H):
            kvh = h // G
            Q = q[q0:q0 + 16, h].float()
            if Q.shape[0] < 16:
                Q = torch.cat([Q, torch.zeros(16 - Q.shape[0], hd)])
            ws = []
            for w in range(WARPS):
                m = torch.full((16,), -math.inf)
                l = torch.zeros(16)
                acc = torch.zeros(16, hd)
                for st in range(steps):
                    hist = st < hs
                    k0 = (st * KEY_STEP if hist
                          else pos0 + (st - hs) * KEY_STEP) + w * SLICE
                    keys = torch.arange(k0, k0 + SLICE)
                    if k0 >= (pos0 if hist else nk):
                        continue            # the warp holds no key
                    if hist:
                        live = keys < pos0
                        kk = torch.zeros(SLICE, hd)
                        vv = torch.zeros(SLICE, hd)
                        kk[live] = ck[keys[live], kvh]
                        vv[live] = cv[keys[live], kvh]
                        s = (Q @ kk.T) * float(ks[kvh]) * scale
                        seen = live[None, :].expand(16, SLICE)
                    else:
                        c = keys - pos0
                        live = keys < nk
                        kk = torch.zeros(SLICE, hd)
                        vv = torch.zeros(SLICE, hd)
                        kk[live] = k_new[c[live], kvh].float()
                        vv[live] = v_new[c[live], kvh].float()
                        s = (Q @ kk.T) * scale
                        seen = live[None, :] & (
                            c[None, :] <= torch.minimum(
                                rows, torch.tensor(nv - 1))[:, None])
                    s = torch.where(seen, s, torch.tensor(-math.inf))
                    mn = torch.maximum(m, s.max(dim=1).values)
                    alpha = torch.where(mn == -math.inf, torch.ones(16),
                                        torch.exp(m - mn))
                    p = torch.where(seen, torch.exp(s - mn[:, None]),
                                    torch.zeros(()))
                    l = alpha * l + p.sum(dim=1)
                    hi, lo = _split_bf16(p)
                    t = hi @ vv + lo @ vv
                    if hist:
                        t = t * float(vs[kvh])
                    acc = acc * alpha[:, None] + t
                    m = mn
                ws.append((m, l, acc))
            mx = torch.stack([m for m, _, _ in ws]).max(dim=0).values
            tot = torch.zeros(16)
            o = torch.zeros(16, hd)
            for m, l, acc in ws:
                f = torch.exp(m - mx)
                tot = tot + f * l
                o = o + f[:, None] * acc
            real = rows < nv
            out[rows[real], h] = (o / tot[:, None])[real]
    return out


def kv8_prefill_twin(args, pos0, nv, scales, eps=1e-6):
    """prefill_attn_block's tensor-core body over int8 pools in its order:
    the plain version's products and rounding points around the kv8
    attention twin."""
    from paddle_tpu_torch.ops import rms_norm
    from paddle_tpu_torch.ops.rope import apply_rope
    x, nw, wq, wk, wv, wo, sin, cos, kp, vp, table = args
    P, D = x.shape
    _, BS, KV, hd = kp.shape
    H = fdb._wq_parts(wq)[0].shape[1] // hd
    dt = x.dtype
    mm = fdb._epi_mm
    h = rms_norm(x[None], nw, eps)[0]
    q = apply_rope(mm(h, wq).reshape(1, P, H, hd), sin, cos)[0]
    k_new = apply_rope(mm(h, wk).reshape(1, P, KV, hd), sin, cos)[0]
    v_new = mm(h, wv).reshape(P, KV, hd)
    T = table.shape[0] * BS
    ck = kp[table.long()].reshape(T, KV, hd)[:pos0]
    cv = vp[table.long()].reshape(T, KV, hd)[:pos0]
    attn = kv8_tc_attention(q, ck, cv, scales[0], scales[1], k_new, v_new,
                            pos0, nv, 1.0 / math.sqrt(hd))
    o = fdb._f32mm(attn.to(dt).reshape(P, H * hd), wo).to(dt)
    return x + o, k_new, v_new


@pytest.mark.parametrize("pos0,nv", [(150, 29), (0, 32), (256, 17)])
@pytest.mark.parametrize("bits", [0, 8, 4], ids=["fp", "int8", "int4"])
def test_kv8_tc_twin_matches_jax_and_plain(bits, pos0, nv):
    """The kv8 tensor-core attention's order (GQA 4:1, D 256, a 32-row
    chunk with ragged real rows, the history a partial last step or none)
    against the JAX prefill kernel's quant body and
    prefill_attn_block_wq_ref in bf16: x_out's real rows, k_new and
    v_new."""
    rng = np.random.RandomState(80 + bits + pos0 + nv)
    P, D, H, KV, hd, BS = 32, 256, 4, 1, 64, 16
    MB = -(-(pos0 + P) // BS) + 1
    N = MB + 3
    x = (rng.randn(P, D) * 0.5).astype(np.float32)
    nw = (rng.rand(D) + 0.5).astype(np.float32)
    shapes = [(D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D)]
    ws = (_weights(rng, bits, shapes) if bits else
          [(rng.randn(*s) * s[0] ** -0.5).astype(np.float32)
           for s in shapes])
    sin, cos = _rope(P, hd, pos=pos0 + np.arange(P))
    kp, vp, scales = _pools(rng, True, N, BS, KV, hd)
    tab = (rng.permutation(N - 1)[:MB] + 1).astype(np.int32)
    bf = jnp.bfloat16
    jw = [jnp.asarray(w, bf) if not isinstance(w, dict) else
          {k: jnp.asarray(v) for k, v in w.items()} for w in ws]
    want = _pallas(jfpb.fused_prefill_attn_pallas, jnp.asarray(x, bf),
                   jnp.asarray(nw, bf), *jw, jnp.asarray(sin),
                   jnp.asarray(cos), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(tab), jnp.int32(pos0), jnp.int32(nv),
                   kv_scales=tuple(map(jnp.asarray, scales)))
    tw = [_port(w) if isinstance(w, dict) else
          _port(w).to(torch.bfloat16) for w in ws]
    targs = [_port(x).to(torch.bfloat16), _port(nw).to(torch.bfloat16),
             *tw, _port(sin), _port(cos), _port(kp), _port(vp), _port(tab)]
    tsc = tuple(map(_port, scales))
    twin = kv8_prefill_twin(targs, pos0, nv, tsc)
    plain = fpb.prefill_attn_block_wq_ref(*targs, pos0, nv, kv_scales=tsc)
    for g, w, p in zip(twin, want, plain):
        _bf16_close(g[:nv], np.asarray(w.astype(jnp.float32))[:nv])
        _bf16_close(g[:nv], p[:nv])


# ---------------------------------------------------------------------------
# the ring's tickets: one buffer a (device, stream)
# ---------------------------------------------------------------------------
def test_ring_tickets_are_per_stream(monkeypatch):
    """Two stream keys get two zeroed buffers; one key keeps its buffer
    across calls and grows it (zeroed anew) when a launch needs more."""
    monkeypatch.setattr(fdb, "_TICKETS", {})
    dev = torch.device("cpu")
    a = fdb._ring_tickets(dev, 96, 11)
    b = fdb._ring_tickets(dev, 96, 12)
    assert a.data_ptr() != b.data_ptr()
    assert a.dtype == torch.int32 and not a.any() and not b.any()
    assert fdb._ring_tickets(dev, 50, 11) is a
    a[3] = 7                                 # a launch left mid-way
    grown = fdb._ring_tickets(dev, 1000, 11)
    assert grown.numel() >= 1000 and not grown.any()
    assert fdb._ring_tickets(dev, 96, 11) is grown
    assert fdb._ring_tickets(dev, 96, 12) is b
