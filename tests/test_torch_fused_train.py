"""PyTorch/CUDA port, the fused-train route on the CPU: each kernel's plain
version against its JAX Pallas kernel (interpret mode), each
``torch.autograd.Function`` against ``jax.value_and_grad`` of the JAX
fused op, and LLaMA's loss and every gradient on the forced fused route
against the JAX package's ``fused_train="pallas"`` (interpret).

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs with x64 off (its Pallas calls are ``no_x64``, which this
jax cannot enter under x64).

Tolerances, the JAX fused-train tests' own: f32 1e-5 (loss, dx, dh, h,
the SwiGLU grads), 2e-5 for the residual norm's grads and the RMSNorm
backward (two means deep), LLaMA's grads 5e-5 + 5e-4 relative. bf16: two
ulps of the element (relative 2^-6) plus two ulps at 1e-3 of the
tensor's largest magnitude, never bit equality: the two frameworks round
bf16 at other places (``jax.nn.sigmoid`` and ``torch.sigmoid`` already
differ in f32 ulps)."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas import fused_train as jft
from paddle_tpu.ops.pallas import norms as jnorms
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import fused_train as tft
from paddle_tpu_torch.ops.kernels import fused_train as kft
from paddle_tpu_torch.ops.kernels import norms as tnorms
from paddle_tpu_torch.ops.kernels.registry import KERNELS

pytestmark = pytest.mark.torch_port

F32 = dict(atol=1e-5, rtol=1e-5)
F32_RES = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
EPS = 1e-6


@pytest.fixture(autouse=True)
def no_x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _np(t):
    return np.asarray(t.detach().float()) if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
        dtype).requires_grad_(grad)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _close(got, want, bf16=False, tol=F32):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if not bf16:
        np.testing.assert_allclose(g, w, **tol)
        return
    scale = np.maximum(np.abs(g), np.abs(w)) + 1e-3 * np.abs(w).max()
    assert np.all(np.abs(g - w) <= 2.0 ** -6 * scale), \
        float((np.abs(g - w) / scale).max())


def _labels(rng, shape, v, ignore_frac=0.25):
    """Valid ids mixed with both ignore conventions, -1 and -100."""
    lab = rng.randint(0, v, shape)
    drop = rng.rand(*shape) < ignore_frac
    lab[drop] = np.where(rng.rand(int(drop.sum())) < 0.5, -1, -100)
    return lab.astype(np.int64)


# ---------------------------------------------------------------------------
# per launch: each plain version against its Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,bf16", [((70, 48), False), ((2, 5, 64), False),
                                        ((33, 64), True)])
def test_rms_bwd_ref_matches_pallas_kernel(shape, bf16):
    rng = np.random.RandomState(len(shape) + bf16)
    x, g = rng.randn(*shape), rng.randn(*shape)
    w = 1 + 0.1 * rng.randn(shape[-1])
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                          torch.float32)
    want = jnorms.rms_norm_bwd_pallas(_j(x, jd), _j(w, jd), _j(g, jd), EPS)
    got = tnorms.rms_bwd_ref(EPS, (_t(x, td), _t(w, td)), _t(g, td))
    for a, b in zip(got, want):
        assert a.dtype == td
        _close(a, b, bf16, F32_RES)


def _rms_bwd_model(x, w, g, eps=EPS):
    """The RMSNorm backward as the Triton kernels partition it: dx per row
    (op for op ``rms_bwd_ref``), each program's f32 dw partial summed over
    its rows in its order, then the partials' chunk-order combine."""
    xf, gf = x.float(), g.float()
    inv = torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    xhat = xf * inv
    nprog, parts = tnorms.rms_bwd_partition(x.shape[0])
    part = torch.zeros(nprog, x.shape[1])
    for p, rows in enumerate(parts):
        for r in rows:
            part[p] += gf[r] * xhat[r]
    dx, _ = tnorms.rms_bwd_ref(eps, (x, w), g)
    return dx, tnorms.rms_dw_combine_ref(part, w.dtype), part


@pytest.mark.parametrize("rows,d,bf16", [(70, 48, False), (300, 40, False),
                                         (600, 64, True), (5, 33, True)])
def test_rms_bwd_partition_model_matches_ref_and_pallas_kernel(rows, d, bf16):
    """More rows than the 264 programs (300, 600: programs of two or three
    rows, the 264 partial rows combined in three chunks of 128), fewer (5,
    70), D never a power of two: the model of the kernels' partition and
    combine order against ``rms_bwd_ref`` and the JAX kernel
    (``rms_norm_bwd_pallas``, interpret) on the same inputs, at the
    module's RMSNorm-backward tolerance (f32 2e-5; bf16 two ulps)."""
    rng = np.random.RandomState(rows + d)
    x, g = rng.randn(rows, d), rng.randn(rows, d)
    w = 1 + 0.1 * rng.randn(d)
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                          torch.float32)
    tx, tw, tg = _t(x, td), _t(w, td), _t(g, td)
    dx, dw, part = _rms_bwd_model(tx, tw, tg)
    nprog = min(rows, 264)
    assert part.shape == (nprog, d)
    want = tnorms.rms_bwd_ref(EPS, (tx, tw), tg)
    assert torch.equal(dx, want[0]) and dw.dtype == td
    _close(dw, want[1], bf16, F32_RES)
    jdx, jdw = jnorms.rms_norm_bwd_pallas(_j(x, jd), _j(w, jd), _j(g, jd),
                                          EPS)
    _close(dx, jdx, bf16, F32_RES)
    _close(dw, jdw, bf16, F32_RES)


@pytest.mark.parametrize("rows,d,dt", [(4096, 4096, "bfloat16"),
                                       (4095, 4096, "bfloat16"),
                                       (7, 1000, "bfloat16"),
                                       (300, 16384, "float32"),
                                       (24, 128, "float32"),
                                       (1, 64, "bfloat16")])
def test_rms_bwd_spec_covers_every_row_and_column_once(rows, d, dt):
    """The partition gives each row to one program, in increasing order
    within a program; min(rows, 264) programs (at least one); the dw sum
    one program per 32 columns over chunks of 128 partial rows; the
    partials [programs, D] f32; every row of x, g and dx and every column
    of dw covered, clean under the gate's rules."""
    from paddle_tpu_torch.analysis.kernel_rules import check_launch
    nprog, parts = tnorms.rms_bwd_partition(rows)
    assert nprog == max(1, min(rows, 264)) == len(parts)
    seen = sorted(r for rows_p in parts for r in rows_p)
    assert seen == list(range(rows))
    assert all(rp == sorted(rp) for rp in parts)
    sp = tnorms.rms_bwd_spec(rows, d, dt)
    (g1, c1, w1), (g2, c2, w2) = sp.plan["launches"]
    assert g1 == (nprog,) and c1 == {"BLOCK": 1 << (d - 1).bit_length()}
    assert g2 == (-(-d // 32),) and c2 == {"ROWS": 128, "COLS": 32}
    assert sp.plan["part"] == (nprog, d)
    assert [c[0] for c in sp.calls] == ["_rms_bwd_kernel", "_dw_sum_kernel"]
    assert check_launch(sp) == []
    assert tnorms.rms_bwd_partition(0) == (1, [[]])


@pytest.mark.parametrize("rows,d,bf16", [(37, 48, False), (16, 64, True)])
def test_residual_rms_norm_fwd_ref_matches_pallas_kernel(rows, d, bf16):
    rng = np.random.RandomState(rows)
    x, delta = rng.randn(rows, d), rng.randn(rows, d)
    w = 1 + 0.1 * rng.randn(d)
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                          torch.float32)
    wy, wh = jnorms._res_rms_fwd_call(_j(delta, jd), _j(x, jd), _j(w, jd),
                                      EPS)
    gy, gh = tnorms.residual_rms_norm_fwd_ref(_t(delta, td), _t(x, td),
                                              _t(w, td), EPS)
    # the sum is rounded once in both frameworks: bit-equal
    np.testing.assert_array_equal(_np(gy), _np(wy))
    _close(gh, wh, bf16)


@pytest.mark.parametrize("rows,f,bf16", [(16, 256, False), (8, 70, False),
                                         (16, 128, True)])
def test_swiglu_refs_match_pallas_kernels(rows, f, bf16):
    """Rows a multiple of the Pallas call's 8, F whole (70: ragged for
    every tile the kernels would take)."""
    rng = np.random.RandomState(f)
    g, u, d = (rng.randn(rows, f) * 2 for _ in range(3))
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                          torch.float32)
    want = jft._swiglu_fwd_call(_j(g, jd), _j(u, jd), 8, f)
    _close(kft.swiglu_fwd_ref(_t(g, td), _t(u, td)), want, bf16)
    wdg, wdu = jft._swiglu_bwd_call(_j(g, jd), _j(u, jd), _j(d, jd), 8, f)
    tdg, tdu = kft.swiglu_bwd_ref(_t(g, td), _t(u, td), _t(d, td))
    assert tdg.dtype == tdu.dtype == td
    _close(tdg, wdg, bf16)
    _close(tdu, wdu, bf16)


def _ce_inputs(seed, t, d, v, bf16=False, ignore_all=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(t, d) * 0.3
    head = rng.randn(d, v) * 0.1
    lab = np.full(t, -100, np.int64) if ignore_all else _labels(rng, (t,), v)
    return x, head, lab


def _pallas_ce(x, head, lab, jd, bt=8, bv=128):
    """The JAX kernels on the padded problem, as ``linear_ce_pallas`` pads
    it: (lse, pick, dx, dh) of the first T rows and V columns, with coef
    0.37."""
    t, v = x.shape[0], head.shape[1]
    tp, vp = -(-t // bt) * bt, -(-v // bv) * bv
    x2 = jnp.pad(_j(x, jd), ((0, tp - t), (0, 0)))
    hp = jnp.pad(_j(head, jd), ((0, 0), (0, vp - v)))
    lab2 = jnp.asarray(np.pad(lab, (0, tp - t), constant_values=-1),
                       jnp.int32).reshape(tp, 1)
    lse, pick = jft._ce_fwd_call(x2, hp, lab2, v, bt, bv)
    coef = jnp.full((1, 1), 0.37, jnp.float32)
    dx, dh = jft._ce_bwd_call(x2, hp, lab2, lse, coef, v, bt, bv)
    return lse[:t, 0], pick[:t, 0], dx[:t], dh[:, :v]


@pytest.mark.parametrize("t,d,v,bf16", [(37, 32, 131, False),
                                        (19, 48, 33, False),
                                        (26, 32, 97, True)])
def test_ce_refs_match_pallas_kernels(t, d, v, bf16):
    """T and V never a tile multiple; the backward refs take the JAX
    forward's lse, so both sides see the same inputs."""
    x, head, lab = _ce_inputs(t + v, t, d, v, bf16)
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                          torch.float32)
    lse, pick, dx, dh = _pallas_ce(x, head, lab, jd)
    tx, th, tl_ = _t(x, td), _t(head, td), torch.from_numpy(lab)
    glse, gpick = kft.ce_fwd_ref(tx, th, tl_)
    _close(glse, lse)
    _close(gpick, pick)
    tlse = _t(np.asarray(lse))
    coef = torch.tensor([0.37])
    gdx = kft.ce_bwd_dx_ref(tx, th, tl_, tlse, coef)
    gdh = kft.ce_bwd_dh_ref(tx, th, tl_, tlse, coef)
    assert gdx.dtype == gdh.dtype == td
    _close(gdx, dx, bf16)
    _close(gdh, dh, bf16)


# ---------------------------------------------------------------------------
# the bf16 forward (linear_ce.cu's wgmma tiles and their combine): the plain
# model of its split
# ---------------------------------------------------------------------------
def _pallas_ce_fwd(x, head, lab, jd, bt=8, bv=128):
    """The JAX forward kernel (``_ce_fwd_call``, interpret mode) on the
    padded problem, as ``linear_ce_pallas`` pads it: (lse, pick) of the
    first T rows."""
    t, v = x.shape[0], head.shape[1]
    tp, vp = -(-t // bt) * bt, -(-v // bv) * bv
    x2 = jnp.pad(_j(x, jd), ((0, tp - t), (0, 0)))
    hp = jnp.pad(_j(head, jd), ((0, 0), (0, vp - v)))
    lab2 = jnp.asarray(np.pad(lab, (0, tp - t), constant_values=-1),
                       jnp.int32).reshape(tp, 1)
    lse, pick = jft._ce_fwd_call(x2, hp, lab2, v, bt, bv)
    return lse[:t, 0], pick[:t, 0]


@pytest.mark.parametrize("t,d,v,bf16,tied,ignore_all", [
    (37, 32, 131, False, False, False),     # one partial vocab tile
    (26, 32, 97, True, False, False),
    (40, 48, 600, False, True, False),      # three tiles, the tied layout
    (24, 32, 520, True, True, False),       # 8 columns in the last tile
    (19, 48, 300, True, False, True)])      # every label ignored
def test_ce_fwd_stats_model_matches_ref_and_pallas_kernel(t, d, v, bf16, tied,
                                                         ignore_all):
    """The bf16 forward's split, plainly: each vocab tile of 256 columns
    reduced to (m, l, pick) per token, then the combine in the kernel's
    order (8 strands of tiles, then the strands in order), against the
    dense ``ce_fwd_ref`` and the JAX kernel (``_ce_fwd_call``, interpret)
    on the same inputs: f32 1e-5 (the module's tolerance; both compute in
    f32 from the same bf16 operands). V is never a multiple of 256, one
    label sits in the last, partial tile; the tied head is the embedding
    [V, D] seen transposed."""
    x, head, lab = _ce_inputs(t + v, t, d, v, ignore_all=ignore_all)
    if not ignore_all:
        lab[-1] = v - 1
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                          torch.float32)
    tx, tl_ = _t(x, td), torch.from_numpy(lab)
    th = _t(head.T, td).T if tied else _t(head, td)
    part = kft.ce_fwd_stats_ref(tx, th, tl_)
    nvt = kft.ce_vtiles(v)
    assert part.shape == (3, nvt, t) and nvt == -(-v // 256)
    m, l, pick = part
    assert bool(torch.isfinite(m).all()) and bool((l >= 1.0).all())
    s = tx.float() @ th.float()
    for r in range(t):
        tile = int(lab[r]) // 256
        if lab[r] >= 0:
            assert float(pick[tile, r]) == float(s[r, lab[r]])
        others = [k for k in range(nvt) if lab[r] < 0 or k != tile]
        assert not pick[others, r].any()
    lse, got_pick = kft.ce_fwd_combine_ref(part)
    want_lse, want_pick = kft.ce_fwd_ref(tx, th, tl_)
    _close(lse, want_lse)
    _close(got_pick, want_pick)
    jlse, jpick = _pallas_ce_fwd(x, head, lab, jd)
    _close(lse, jlse)
    _close(got_pick, jpick)
    if ignore_all:
        assert not got_pick.any()


def test_ce_fwd_combine_order():
    """The combine's order on made-up stats: M the max of the m; strand k
    sums tiles k, k + 8, ... in order; the strands add in order. Against a
    direct loop in float64 and, for 19 tiles, bit for bit against the same
    order written out in f32."""
    rng = np.random.RandomState(3)
    nvt, t = 19, 5
    part = torch.from_numpy(np.stack([
        rng.randn(nvt, t), rng.rand(nvt, t) * 40 + 1,
        np.where(rng.rand(nvt, t) < 0.1, rng.randn(nvt, t), 0.0)])).float()
    lse, pick = kft.ce_fwd_combine_ref(part)
    m, l, pk = (a.double() for a in part)
    M = m.max(0).values
    np.testing.assert_allclose(
        _np(lse), _np(M + torch.log((l * torch.exp(m - M)).sum(0))),
        rtol=1e-6)
    np.testing.assert_allclose(_np(pick), _np(pk.sum(0)), rtol=1e-6)
    w = part[1] * torch.exp(part[0] - part[0].max(0).values)
    strands = [sum((w[v] for v in range(k, nvt, 8)), torch.zeros(t))
               for k in range(8)]
    assert torch.equal(lse, part[0].max(0).values
                       + torch.log(sum(strands, torch.zeros(t))))


def _ce_forward_spec(T, D, V, dt=torch.bfloat16, tied=False):
    from paddle_tpu_torch.ops.kernels import _launch
    x = _meta(T, D, dtype=dt)
    head = _meta(V, D, dtype=dt).T if tied else _meta(D, V, dtype=dt)
    with _launch.capture_kernel_launches() as specs:
        lse, pick = kft.linear_ce_fwd_cuda(x, head,
                                           _meta(T, dtype=torch.int64))
    assert lse.shape == pick.shape == (T,)
    spec, = specs
    return spec


def test_forward_spec_at_the_training_shape():
    """T 4096, D 4096, V 32000, bf16: 32 x 125 tiles of 128 x 256 on the
    wgmma body, in the grouped order (the 32 tile rows walk each tile
    column together), each tile once; partials [3, 125, 4096] f32 (6.1
    MB); a combine of 128 blocks of 32 tokens; the P pass's ring (one
    block of 384 threads an SM); 2 T D V + 3 T V operations, 1.086 ms at
    the bf16 peak; clean under the gate's rules."""
    from paddle_tpu_torch.analysis.kernel_rules import bound, check_launch
    T, D, V = 4096, 4096, 32000
    for tied in (False, True):
        sp = _ce_forward_spec(T, D, V, tied=tied)
        assert sp.plan["body"] == "wgmma" and sp.grid == (32 * 125,)
        assert sp.params["head_layout"] == ("tied" if tied else "untied")
        assert sp.params["staged"] == ()
        assert sp.threads == kft.GEMM_THREADS and sp.blocks_per_sm == 1
        assert sp.dyn_smem == kft.CE_P_SMEM and sp.static_smem == 0
        assert sp.plan["tile"] == (128, 256) and sp.plan["group_m"] == 32
        assert sp.plan["splits"] == kft.ce_vtiles(V) == 125
        assert sp.plan["part"] == (3, 125, T)
        assert sp.plan["part_bytes"] == 3 * 125 * T * 4 == 6_144_000
        assert [(ph.name, ph.items) for ph in sp.phases] == [
            ("tiles", 4000), ("combine", 128)]
        assert check_launch(sp) == []
        ms, by, nbytes, ops = bound(sp)
        assert by == "operations" and ops == 2.0 * T * D * V + 3.0 * T * V
        assert 1.08 < ms < 1.09
    # the grouped order: block i's tile, every (m, n) once, the first 32
    # blocks on tile column 0
    tiles = [kft._grouped(i, 32, 125, 32) for i in range(4000)]
    assert len({(int(m), int(n)) for m, n in tiles}) == 4000
    assert {int(n) for _, n in tiles[:32]} == {0}
    assert [int(m) for m, _ in tiles[:32]] == list(range(32))


def test_forward_specs_staging_and_f32():
    """V 32003: the untied head's rows (64006 bytes) are copied to aligned
    rows first, the tied head's (rows of D) are read in place; 126 vocab
    tiles, the last holding 3 columns. f32 keeps the CUDA-core tiles:
    (64 x 128) blocks over ``ce_splits``' vocab splits, 256 threads, two
    blocks an SM, the static tile buffer, the split combine."""
    from paddle_tpu_torch.analysis.kernel_rules import check_launch
    for tied, staged in ((False, ("head",)), (True, ())):
        sp = _ce_forward_spec(4095, 4096, 32003, tied=tied)
        assert sp.params["staged"] == staged
        assert sp.plan["splits"] == 126 and sp.grid == (32 * 126,)
        assert check_launch(sp) == []
    T, D, V = 512, 4096, 32003
    sp = _ce_forward_spec(T, D, V, dt=torch.float32)
    tps, splits = kft.ce_splits(T, V, 4 * 132)
    assert sp.plan["body"] == "cuda_core" and sp.grid == (8, splits)
    assert sp.plan["tile"] == (kft.BT, kft.BV)
    assert (sp.plan["tiles_per_split"], sp.plan["splits"]) == (tps, splits)
    assert sp.plan["part"] == (3, splits, T) and sp.plan["smem"] == 0
    assert sp.threads == 256 and sp.blocks_per_sm == 2
    assert sp.static_smem == kft.CE_FWD_SMEM and sp.dyn_smem == 0
    assert [ph.name for ph in sp.phases] == ["token_tiles", "combine"]
    assert check_launch(sp) == []


# ---------------------------------------------------------------------------
# the backward's P pass and products (linear_ce.cu): their plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t,d,v,bf16", [(37, 32, 131, False),
                                        (26, 32, 97, True),
                                        (64, 48, 320, True)])
def test_p_split_reproduces_ce_p(t, d, v, bf16):
    """hi + lo carries P to 2^-16 of its magnitude (hi: 8 bits, lo the
    next 8, so 2^-17 at worst, one rounding of each); columns past V, up
    to Vp, are zero; f32 keeps P itself."""
    x, head, lab = _ce_inputs(t + v, t, d, v)
    td = torch.bfloat16 if bf16 else torch.float32
    tx, th, tl_ = _t(x, td), _t(head, td), torch.from_numpy(lab)
    lse, _ = kft.ce_fwd_ref(tx, th, tl_)
    coef = torch.tensor([0.37])
    p = kft._ce_p(tx, th, tl_, lse, coef)
    hi, lo = kft.ce_p_split_ref(tx, th, tl_, lse, coef)
    vp = kft.p_width(v)
    assert hi.shape == (t, vp) and vp % kft.P_ALIGN == 0 and vp - v < 64
    if not bf16:
        assert lo is None and hi.dtype == torch.float32
        assert torch.equal(hi[:, :v], p)
        assert not hi[:, v:].any()
        return
    assert hi.dtype == lo.dtype == torch.bfloat16
    got = hi.float() + lo.float()
    assert not got[:, v:].any()
    err = (got[:, :v] - p).abs()
    assert bool((err <= 2.0 ** -16 * p.abs()).all()), float(
        (err / p.abs().clamp_min(1e-30)).max())
    # hi alone is bf16's rounding: the pair is what carries P
    assert float((hi.float()[:, :v] - p).abs().max()) > float(err.max())


@pytest.mark.parametrize("t,d,v,bf16", [(37, 32, 131, False),
                                        (19, 48, 33, False),
                                        (26, 32, 97, True)])
def test_split_products_match_refs_and_pallas_kernels(t, d, v, bf16):
    """dx = hi head^T + lo head^T and dh = x^T hi + x^T lo (the kernels'
    sums, f32) against the dense plain versions and the JAX kernels
    (``_ce_bwd_call``, interpret mode) on the same lse: f32 1e-5, bf16 two
    ulps (the module's tolerances; hi + lo holds P to 2^-16)."""
    x, head, lab = _ce_inputs(t + v, t, d, v, bf16)
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                          torch.float32)
    lse, _, wdx, wdh = _pallas_ce(x, head, lab, jd)
    tx, th, tl_ = _t(x, td), _t(head, td), torch.from_numpy(lab)
    tlse, coef = _t(np.asarray(lse)), torch.tensor([0.37])
    p0, p1 = kft.ce_p_split_ref(tx, th, tl_, tlse, coef)
    gdx = kft.ce_bwd_dx_split_ref(p0, p1, th, td)
    gdh = kft.ce_bwd_dh_split_ref(tx, p0, p1, v, td)
    assert gdx.dtype == gdh.dtype == td
    _close(gdx, wdx, bf16)
    _close(gdh, wdh, bf16)
    _close(gdx, kft.ce_bwd_dx_ref(tx, th, tl_, tlse, coef), bf16)
    _close(gdh, kft.ce_bwd_dh_ref(tx, th, tl_, tlse, coef), bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_chunked_dh_equals_unchunked(bf16):
    """dh summed over token chunks of 128 rows (the f32 sum the kernels
    carry across chunks, in chunk order) against one sum over all rows:
    f32 sums regrouped, 1e-6 of the largest magnitude; the cast results
    within one bf16 rounding of each other."""
    t, d, v = 300, 48, 131
    x, head, lab = _ce_inputs(5, t, d, v)
    td = torch.bfloat16 if bf16 else torch.float32
    tx, th, tl_ = _t(x, td), _t(head, td), torch.from_numpy(lab)
    lse, _ = kft.ce_fwd_ref(tx, th, tl_)
    p0, p1 = kft.ce_p_split_ref(tx, th, tl_, lse, torch.tensor([0.37]))
    whole = kft.ce_bwd_dh_split_ref(tx, p0, p1, v, torch.float32)
    chunked = kft.ce_bwd_dh_split_ref(tx, p0, p1, v, torch.float32,
                                      chunk_rows=128)
    np.testing.assert_allclose(_np(chunked), _np(whole), rtol=0,
                               atol=1e-6 * float(whole.abs().max()))
    assert not torch.equal(chunked, whole) or t <= 128
    cast = kft.ce_bwd_dh_split_ref(tx, p0, p1, v, td, chunk_rows=128)
    _close(cast, whole.to(td), bf16)


def test_ce_chunk_rows():
    """One chunk while T Vp 4 fits 1 GiB (the training shape: 524 MB);
    beyond it the most multiple of 128 rows that fits; a forced size must
    be a multiple of 128 below T."""
    assert kft.ce_chunk_rows(4096, 32000) == 4096
    fit = kft.P_CAP_BYTES // (kft.p_width(32000) * 4)
    assert kft.ce_chunk_rows(16384, 32000) == fit // 128 * 128 < 16384
    assert kft.ce_chunk_rows(4096, 32000, 2048) == 2048
    assert kft.ce_chunk_rows(100, 131, 4096) == 100
    with pytest.raises(ValueError, match="multiple of 128"):
        kft.ce_chunk_rows(4096, 32000, 1000)
    assert kft._chunks(300, 128) == [(0, 128), (128, 128), (256, 44)]


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _ce_backward_specs(T, D, V, dt=torch.bfloat16, tied=False, chunk=None):
    """The plans LinearCE's backward records: dx keeping P, then dh over
    it; and dh alone."""
    from paddle_tpu_torch.ops.kernels import _launch
    x = _meta(T, D, dtype=dt)
    head = _meta(V, D, dtype=dt).T if tied else _meta(D, V, dtype=dt)
    lab = _meta(T, dtype=torch.int64)
    lse, coef = _meta(T, dtype=torch.float32), _meta(1, dtype=torch.float32)
    with _launch.capture_kernel_launches() as specs:
        dx, p = kft.linear_ce_bwd_dx_cuda(x, head, lab, lse, coef,
                                          chunk_rows=chunk, keep_p=True)
        dh = kft.linear_ce_bwd_dh_cuda(x, head, lab, lse, coef, p=p,
                                       chunk_rows=chunk)
        kft.linear_ce_bwd_dh_cuda(x, head, lab, lse, coef, chunk_rows=chunk)
    assert dx.shape == (T, D) and dh.shape == (D, V)
    assert dh.stride() == head.stride() or not tied
    return specs


def test_backward_specs_at_the_training_shape():
    """T 4096, D 4096, V 32000, bf16: the P workspace is dx's output and
    dh's input; one chunk; the P pass 32 x 125 tiles of 128 x 256, dx 32 x
    16, dh 32 x 125; one block of 384 threads an SM; the rings' shared
    memory; needed operations 4 TDV (dx: S and one product) and 2 TDV (dh
    over the given P), 3.26 ms together at the bf16 peak."""
    from paddle_tpu_torch.analysis import kernel_catalog as kc
    from paddle_tpu_torch.analysis.kernel_rules import bound, check_launch
    T, D, V = 4096, 4096, 32000
    dx, dh, alone = _ce_backward_specs(T, D, V)
    assert [o.name for o in dx.outputs] == ["dx", "p_hi", "p_lo"]
    assert [o.shape for o in dx.outputs[1:]] == [(T, V), (T, V)]
    assert {"p_hi", "p_lo"} <= {o.name for o in dh.inputs}
    assert "head" not in {o.name for o in dh.inputs}
    assert [o.name for o in alone.outputs] == ["dh", "p_hi", "p_lo"]
    assert [ph.name for ph in dx.phases] == ["p_pass[0]", "dx[0]"]
    assert [ph.items for ph in dx.phases] == [32 * 125, 32 * 16]
    assert [ph.name for ph in dh.phases] == ["dh[0]"]
    assert dh.phases[0].items == 32 * 125
    assert [ph.name for ph in alone.phases] == ["p_pass[0]", "dh[0]"]
    for sp in (dx, dh, alone):
        assert sp.threads == kft.GEMM_THREADS and sp.blocks_per_sm == 1
        assert sp.plan["chunks"] == 1 and sp.plan["chunk_rows"] == T
        assert sp.plan["body"] == "wgmma"
        assert sp.dyn_smem <= 227 * 1024 and sp.static_smem == 0
        assert check_launch(sp) == []
    assert dx.plan["gemm_smem"] == kft.CE_PAIR_A_SMEM
    assert dh.plan["gemm_smem"] == kft.CE_PAIR_B_SMEM
    assert dh.plan["depth_step"] == kft.GEMM_BK_DH
    assert dx.plan["stages"] == (4, 3) and dh.plan["stages"] == (4, 5)
    tdv = T * D * V
    assert kc.needed_flops(dx) == 4.0 * tdv
    assert kc.needed_flops(dh) == 2.0 * tdv
    assert kc.needed_flops(alone) == 4.0 * tdv
    assert kc.modeled_flops(dh) == 4.0 * tdv      # the JAX model
    ms = bound(dx)[0] + bound(dh)[0]
    assert bound(dx)[1] == bound(dh)[1] == "operations"
    assert abs(ms - 6.0 * tdv / 989e12 * 1e3) < 1e-9 and 3.25 < ms < 3.27


@pytest.mark.parametrize("tied,chunk,dt", [(True, None, torch.bfloat16),
                                           (False, 2048, torch.bfloat16),
                                           (False, 128, torch.float32)])
def test_backward_specs_in_every_layout(tied, chunk, dt):
    """The tied head (dh^T into the embedding's layout, two A tiles on one
    B tile), forced chunks (dx last to first, dh first to last over an f32
    sum, its later chunks' P passes its own), f32 (the CUDA-core tiles):
    every plan clean under the gate's rules."""
    from paddle_tpu_torch.analysis import kernel_catalog as kc
    from paddle_tpu_torch.analysis.kernel_rules import check_launch
    T, D, V = (4096, 4096, 32000) if dt == torch.bfloat16 else (300, 48, 131)
    dx, dh, alone = _ce_backward_specs(T, D, V, dt, tied, chunk)
    n = -(-T // (chunk or T))
    for sp in (dx, dh, alone):
        assert sp.plan["chunks"] == n
        assert check_launch(sp) == [], [f.to_dict() for f in
                                        check_launch(sp)]
    if tied:
        assert dh.plan["dh_layout"] == "vd" and dx.params["head_layout"] \
            == "tied"
        assert dh.plan["gemm_smem"] == kft.CE_PAIR_A_SMEM
    if n > 1:
        assert [ph.name for ph in dx.phases][:2] == [f"p_pass[{n - 1}]",
                                                     f"dx[{n - 1}]"]
        assert "dh_sum" in dh.accum_outputs
        assert [ph.name for ph in dh.phases][:2] == ["dh[0]", "p_pass[1]"]
        tdv = T * D * V
        assert kc.needed_flops(dh) == 2.0 * tdv + 2.0 * (T - chunk) * D * V
    if dt == torch.float32:
        assert dx.plan["body"] == "cuda_core"
        assert dx.static_smem == kft.CE_F32_SMEM and dx.dyn_smem == 0


def test_ragged_operands_are_staged():
    """bf16 rows TMA cannot read are copied to aligned rows first: a head
    of V 32003 (64006-byte rows), an x of D 4095; aligned ones and f32 are
    read in place, the tied head by its own layout."""
    ops = kft.ce_operands(_meta(8, 64), _meta(64, 32003))
    assert ops.staged == ("head",) and ops.sh == 32008 \
        and not ops.head_kmajor
    ops = kft.ce_operands(_meta(8, 4095), _meta(4095, 320))
    assert ops.staged == ("x",) and ops.sx == 4096
    ops = kft.ce_operands(_meta(8, 64), _meta(320, 64).T)
    assert ops.staged == () and ops.head_kmajor and ops.sh == 64
    ops = kft.ce_operands(_meta(8, 63, dtype=torch.float32),
                          _meta(63, 131, dtype=torch.float32))
    assert ops.staged == ()
    assert kft.ce_operands(_meta(8, 64), _meta(64, 640)[:, ::2]).staged \
        == ("head",)


# ---------------------------------------------------------------------------
# per Function: against jax.value_and_grad of the JAX fused ops
# ---------------------------------------------------------------------------
def _jax_ce(x, head, lab, jd, lead=None):
    jl = jnp.asarray(lab, jnp.int32)
    jx = _j(x, jd)
    if lead is not None:
        jx, jl = jx.reshape(*lead, -1), jl.reshape(lead)
    return jax.value_and_grad(
        lambda a, h: jft.linear_ce_pallas(a, h, jl, block_t=8, block_v=128),
        argnums=(0, 1))(jx, _j(head, jd))


@pytest.mark.parametrize("case", ["ragged", "all_ignored", "leading",
                                  "tied", "bf16"])
def test_linear_ce_function_matches_jax(case):
    t, d, v = (26, 32, 97) if case == "bf16" else (37, 32, 131)
    x, head, lab = _ce_inputs(3, t, d, v, ignore_all=case == "all_ignored")
    bf16 = case == "bf16"
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                          torch.float32)
    lead = (1, t) if case == "leading" else None
    want, (wdx, wdh) = _jax_ce(x, head, lab, jd, lead)
    tx = _t(x, td, grad=True)
    hx = tx.reshape(*lead, d) if lead else tx
    tlab = torch.from_numpy(lab).reshape(lead) if lead \
        else torch.from_numpy(lab)
    if case == "tied":
        emb = _t(head.T, td, grad=True)          # [V, D], seen transposed
        th = emb.T
    else:
        emb = th = _t(head, td, grad=True)
    loss = kft.LinearCE.apply(hx, th, tlab)
    loss.backward()
    loss = loss.detach()
    assert loss.dtype == torch.float32
    dh = emb.grad.T if case == "tied" else emb.grad
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5,
                               atol=1e-5)
    _close(tx.grad, np.asarray(wdx, np.float32).reshape(t, d), bf16)
    _close(dh, wdh, bf16)
    if case == "all_ignored":
        assert float(loss) == 0.0
        assert not tx.grad.any() and not dh.any()


@pytest.mark.parametrize("shape,bf16", [((2, 5, 70), False), ((16, 64), True)])
def test_swiglu_function_matches_jax(shape, bf16):
    rng = np.random.RandomState(7)
    g, u, c = (rng.randn(*shape) * 2 for _ in range(3))
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                          torch.float32)
    f = shape[-1]
    want, (wg, wu) = jax.value_and_grad(
        lambda a, b: jnp.sum(jft.swiglu_pallas(a, b, block_f=f)
                             .astype(jnp.float32) * _j(c)),
        argnums=(0, 1))(_j(g, jd), _j(u, jd))
    tg, tu = _t(g, td, grad=True), _t(u, td, grad=True)
    out = kft.SwiGLU.apply(tg, tu)
    _close(out, jft.swiglu_pallas(_j(g, jd), _j(u, jd), block_f=f), bf16)
    (out.float() * _t(c)).sum().backward()
    _close(tg.grad, wg, bf16)
    _close(tu.grad, wu, bf16)


@pytest.mark.parametrize("shape,bf16", [((2, 7, 48), False), ((24, 64), True)])
def test_residual_rms_norm_function_matches_jax(shape, bf16):
    """The JAX epilogue with its norm backward pinned to the Pallas
    kernel ("pallas"); the port's with "pallas" too (on the CPU the
    backward variant runs the plain version)."""
    rng = np.random.RandomState(9)
    delta, x, cy, ch = (rng.randn(*shape) for _ in range(4))
    w = 1 + 0.1 * rng.randn(shape[-1])
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                          torch.float32)

    def jloss(a, b, c):
        y, h = jnorms.residual_rms_norm_pallas(a, b, c, EPS, "pallas")
        return jnp.sum(y.astype(jnp.float32) * _j(cy)
                       + h.astype(jnp.float32) * _j(ch)), (y, h)
    (_, (wy, wh)), wgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(_j(delta, jd), _j(x, jd),
                                                 _j(w, jd))
    leaves = [_t(a, td, grad=True) for a in (delta, x, w)]
    y, h = tnorms.ResidualRMSNorm.apply(*leaves, EPS, "pallas")
    (y.float() * _t(cy) + h.float() * _t(ch)).sum().backward()
    np.testing.assert_array_equal(_np(y), _np(wy))
    _close(h, wh, bf16)
    for a, b in zip(leaves, wgrads):
        _close(a.grad, b, bf16, F32_RES)


# ---------------------------------------------------------------------------
# LLaMA on the forced fused route
# ---------------------------------------------------------------------------
def test_llama_loss_and_every_grad_on_the_fused_route_match_jax():
    """LLAMA_TINY, f32: the port with fused_train="pallas" (every op's
    "cuda_fused" variant; on the CPU the Functions run the plain versions)
    against the JAX package's loss_fn with fused_train="pallas" in
    interpret mode, the oracle of tests/test_fused_train.py; and "auto"
    on the CPU is the composition route, bit for bit "ref"."""
    jcfg = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32,
                               fused_train="pallas")
    names = [f.name for f in dataclasses.fields(tllama.LlamaConfig)
             if f.name not in ("dtype", "fused_train")]
    tcfg = tllama.LlamaConfig(**{n: getattr(jcfg, n) for n in names},
                              dtype=torch.float32, fused_train="pallas")
    jp = jllama.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    rng = np.random.RandomState(11)
    toks = rng.randint(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    lab = _labels(rng, (2, 16), jcfg.vocab_size)
    want, wgrads = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(p, jnp.asarray(toks),
                                 jnp.asarray(lab, jnp.int32), jcfg)))(jp)
    wleaves = jax.tree_util.tree_leaves(wgrads)

    def grads(cfg):
        tp = tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
        leaves = [v.requires_grad_(True) for v in
                  _leaves(tp)]
        loss = tllama.loss_fn(tp, toks, lab, cfg)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    loss, got = grads(tcfg)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5,
                               atol=1e-5)
    assert len(got) == len(wleaves)
    for a, b in zip(got, wleaves):
        np.testing.assert_allclose(_np(a), np.asarray(b), **GRAD_TOL)
    la, ga = grads(dataclasses.replace(tcfg, fused_train=None))
    lr, gr = grads(dataclasses.replace(tcfg, fused_train="ref"))
    assert torch.equal(la, lr) and all(torch.equal(a, b)
                                       for a, b in zip(ga, gr))


def _leaves(tree):
    from paddle_tpu_torch.distributed.trainer import tree_leaves
    return tree_leaves(tree)


def test_forced_variants_run_the_functions_on_the_cpu():
    """Pinned on the CPU, each op's "cuda_fused" variant is its Function
    (whose plain versions run for CPU tensors); nothing launches."""
    from paddle_tpu_torch.ops import kernels
    kernels.reset_launches()
    rng = np.random.RandomState(4)
    h = _t(rng.randn(6, 16), grad=True)
    head = _t(rng.randn(16, 40) * 0.1, grad=True)
    lab = torch.tensor([1, -1, 3, 39, -100, 0])
    loss = tft.fused_linear_ce(h, head, lab, mode="pallas")
    assert type(loss.grad_fn).__name__ == "LinearCEBackward"
    g = tft.fused_swiglu(h, h, mode="pallas")
    assert type(g.grad_fn).__name__ == "SwiGLUBackward"
    y, n = tft.residual_rms_norm(h, h, _t(np.ones(16)), mode="pallas")
    assert type(n.grad_fn).__name__ == "ResidualRMSNormBackward"
    (loss + g.sum() + y.sum() + n.sum()).backward()
    with KERNELS.force("fused_swiglu", "cuda_fused"):
        assert type(tft.fused_swiglu(h, h, mode=None).grad_fn).__name__ \
            == "SwiGLUBackward"
    assert not any(kernels.launches().values())


def test_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only: nothing falls back."""
    x = torch.ones(4, 8)
    w = torch.ones(8)
    lab = torch.zeros(4, dtype=torch.int64)
    for call in (lambda: kft.swiglu_fwd_triton(x, x),
                 lambda: kft.swiglu_bwd_triton(x, x, x),
                 lambda: kft.linear_ce_fwd_cuda(x, x.T.contiguous(), lab),
                 lambda: tnorms.rms_norm_bwd_triton(x, w, x),
                 lambda: tnorms.residual_rms_norm_fwd_triton(x, x, w)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_backward_wrappers_refuse_cpu_tensors():
    """The backward's wrappers take CUDA tensors only, the workspace-taking
    dh call too: nothing falls back to the plain versions."""
    x, head = torch.ones(4, 8), torch.ones(8, 16)
    lab = torch.zeros(4, dtype=torch.int64)
    lse, coef = torch.zeros(4), torch.ones(1)
    ws = kft.CEWorkspace(torch.zeros(4, 64), None, 0, 4)
    for call in (lambda: kft.linear_ce_bwd_dx_cuda(x, head, lab, lse, coef),
                 lambda: kft.linear_ce_bwd_dx_cuda(x, head, lab, lse, coef,
                                                   keep_p=True),
                 lambda: kft.linear_ce_bwd_dh_cuda(x, head, lab, lse, coef),
                 lambda: kft.linear_ce_bwd_dh_cuda(x, head, lab, lse, coef,
                                                   p=ws)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_ce_splits_cover_every_vocab_tile():
    for t, v, blocks in ((4096, 32000, 528), (4096, 32000, 264),
                         (4095, 32003, 528), (37, 131, 528), (1, 1, 8)):
        tps, splits = kft.ce_splits(t, v, blocks)
        nvt = -(-v // kft.BV)
        assert (splits - 1) * tps < nvt <= splits * tps
        assert splits * -(-t // kft.BT) <= max(blocks, -(-t // kft.BT))
    assert kft.ce_splits(4096, 32000, 528) == (32, 8)
    assert kft.ce_splits(4096, 32000, 264) == (63, 4)
