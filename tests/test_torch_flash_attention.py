"""PyTorch/CUDA port, flash attention and fused AdamW: the plain versions
against the JAX package's references and its Pallas kernels (interpret
mode), with every body of the flash kernels (additive bias and its
gradient, segment ids, in-kernel dropout, causal sq > sk), the dropout
keep mask bit for bit, the dispatch of both ops, and the wrappers'
refusals, on the CPU (f32 unless a test says otherwise).

Inputs are made with numpy from a seed and handed to both packages."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.ops.pallas import flash_attention as jpfa
from paddle_tpu.ops.pallas import fused_adamw as jfw
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import flash_attention as kfa
from paddle_tpu_torch.ops.kernels import fused_adamw as kfw
from paddle_tpu_torch.ops.kernels.registry import KERNELS

pytestmark = pytest.mark.torch_port

FWD_TOL = dict(atol=2e-5, rtol=1e-5)    # f32, sums in another order
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)   # f32, two more products deep


def _pallas(fn, *args, **kw):
    """A JAX Pallas kernel in interpret mode, traced with x64 off: what
    the JAX package's ``no_x64`` does through
    ``jax.experimental.disable_x64``, which this jax no longer has."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        return fn(*args, **kw)
    finally:
        jax.config.update("jax_enable_x64", prev)


def _qkvd(seed, b, sq, sk, h, kvh, d):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return (mk(b, sq, h, d), mk(b, sk, kvh, d), mk(b, sk, kvh, d),
            mk(b, sq, h, d))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


# (b, sq, sk, h, kvh, d, causal): causal and full, GQA 1:1, 2:1, 4:1,
# sq < sk causal (the bottom-right offset), a ragged length
CASES = [(2, 64, 64, 4, 4, 16, True), (2, 64, 64, 4, 2, 16, False),
         (1, 64, 64, 4, 1, 32, True), (1, 24, 64, 4, 2, 16, True),
         (1, 37, 37, 4, 4, 8, False)]


def _jax_value_and_grads(fn, q, k, v, do):
    """``fn``'s value and its vjp of ``do``, in one jitted program (one
    compile, where op-by-op dispatch compiles every primitive)."""
    def value_and_vjp(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(do)
    return jax.jit(value_and_vjp)(*(jnp.asarray(a) for a in (q, k, v, do)))


def _port_value_and_grads(fn, q, k, v, do):
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = fn(tq, tk, tv)
    out.backward(_t(do))
    return out, (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize("case", CASES)
def test_flash_attention_matches_jax_ref(case):
    """The port's flash_attention (the plain version on the CPU) against
    the JAX ``_ref_attention`` and ``jax.vjp`` through it."""
    b, sq, sk, h, kvh, d, causal = case
    q, k, v, do = _qkvd(sum(case[:6]), b, sq, sk, h, kvh, d)
    want, wgrads = _jax_value_and_grads(
        lambda *a: jfa._ref_attention(*a, causal=causal), q, k, v, do)
    got, grads = _port_value_and_grads(
        lambda *a: tfa.flash_attention(*a, causal=causal), q, k, v, do)
    _close(got, want, FWD_TOL)
    for g, w in zip(grads, wgrads):
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("case", CASES[:4])
def test_flash_attention_matches_pallas_kernels(case):
    """The same against the JAX Pallas kernels (forward, and the dq/dkv
    backward through their custom_vjp) in interpret mode."""
    b, sq, sk, h, kvh, d, causal = case
    q, k, v, do = _qkvd(sum(case[:6]) + 1, b, sq, sk, h, kvh, d)
    want, wgrads = _pallas(_jax_value_and_grads, lambda *a:
                           jpfa.flash_attention_pallas(*a, causal=causal),
                           q, k, v, do)
    got, grads = _port_value_and_grads(
        lambda *a: tfa.flash_attention(*a, causal=causal), q, k, v, do)
    _close(got, want, FWD_TOL)
    for g, w in zip(grads, wgrads):
        _close(g, w, GRAD_TOL)


def _heads_first(a, b, s, h):
    return jnp.swapaxes(jnp.asarray(a), 1, 2).reshape(b * h, s, -1)


@pytest.mark.parametrize("case", CASES[:4])
def test_kernel_plain_versions_match_pallas_passes(case):
    """The three kernels' plain versions (the arithmetic chip_smoke.py
    holds each CUDA kernel to) against the JAX ``_fwd`` and ``_bwd_impl``
    launches one by one: O and lse, then dq, dk and dv from the same lse
    and delta."""
    b, sq, sk, h, kvh, d, causal = case
    q, k, v, do = _qkvd(sum(case[:6]) + 2, b, sq, sk, h, kvh, d)
    scale = 1.0 / np.sqrt(d)
    meta = (h, kvh, 1, 1, False)
    jq, jk, jv, jdo = (_heads_first(q, b, sq, h), _heads_first(k, b, sk, kvh),
                       _heads_first(v, b, sk, kvh), _heads_first(do, b, sq, h))
    jo, jlse = _pallas(jpfa._fwd, jq, jk, jv, None, None, None, scale,
                       causal, meta)
    jdq, jdk, jdv, _ = _pallas(jpfa._bwd_impl, jq, jk, jv, None, None, None,
                               jo, jlse, jdo, scale, causal, meta)
    o, lse = kfa.flash_fwd_ref(_t(q), _t(k), _t(v), causal)
    back = lambda t, s, n: np.swapaxes(  # noqa: E731
        np.asarray(t).reshape(b, n, s, d), 1, 2)
    _close(o, back(jo, sq, h), FWD_TOL)
    _close(lse.reshape(b * h, sq), jlse, FWD_TOL)
    delta = (o.float() * _t(do)).sum(-1).transpose(1, 2).contiguous()
    dq = kfa.flash_bwd_dq_ref(_t(q), _t(k), _t(v), _t(do), lse, delta,
                              causal)
    dk, dv = kfa.flash_bwd_dkv_ref(_t(q), _t(k), _t(v), _t(do), lse, delta,
                                   causal)
    _close(dq, back(jdq, sq, h), GRAD_TOL)
    _close(dk, back(jdk, sk, kvh), GRAD_TOL)
    _close(dv, back(jdv, sk, kvh), GRAD_TOL)


def test_kernel_plain_versions_match_autograd():
    """dq, dk, dv of the plain versions equal autograd through the plain
    forward (f32, where the casts are exact)."""
    q, k, v, do = _qkvd(7, 2, 40, 48, 4, 2, 16)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    o, lse = kfa.flash_fwd_ref(tq, tk, tv, True)
    o.backward(_t(do))
    delta = (o.detach() * _t(do)).sum(-1).transpose(1, 2).contiguous()
    args = (_t(q), _t(k), _t(v), _t(do), lse.detach(), delta, True)
    _close(kfa.flash_bwd_dq_ref(*args), tq.grad.numpy(), GRAD_TOL)
    dk, dv = kfa.flash_bwd_dkv_ref(*args)
    _close(dk, tk.grad.numpy(), GRAD_TOL)
    _close(dv, tv.grad.numpy(), GRAD_TOL)


def test_kernel_plain_versions_round_like_the_kernels_in_bf16():
    """bf16: P is cast to V's type before P V, so O differs from the f32
    softmax by bf16 rounding only (2 ulps of the output's scale)."""
    q, k, v, _ = _qkvd(8, 1, 32, 32, 2, 2, 16)
    bq, bk, bv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    o, _ = kfa.flash_fwd_ref(bq, bk, bv, True)
    want = tfa._ref_attention(bq.float(), bk.float(), bv.float(), causal=True)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), want.numpy(),
                               atol=2 * 2 ** -8 * float(want.abs().max()))


def test_bias_and_segments_match_jax_ref():
    b, s, h, d = 2, 24, 4, 16
    q, k, v, do = _qkvd(9, b, s, s, h, 2, d)
    rng = np.random.RandomState(10)
    bias = rng.randn(1, h, s, s).astype(np.float32)
    seg = np.sort(rng.randint(0, 3, (b, s)), axis=1).astype(np.int32)
    seg[1, :5] = -1           # padding rows: no valid key -> 0
    kw_j = dict(causal=True, bias=jnp.asarray(bias),
                segment_ids=jnp.asarray(seg))
    kw_t = dict(causal=True, bias=_t(bias), segment_ids=_t(seg))
    want, wgrads = _jax_value_and_grads(
        lambda *a: jfa._ref_attention(*a, **kw_j), q, k, v, do)
    got, grads = _port_value_and_grads(
        lambda *a: tfa.flash_attention(*a, **kw_t), q, k, v, do)
    _close(got, want, FWD_TOL)
    for g, w in zip(grads, wgrads):
        _close(g, w, GRAD_TOL)


def test_segment_ids_from_cu_seqlens_matches_jax():
    cu = np.array([0, 3, 7, 9], np.int32)
    want = jfa.segment_ids_from_cu_seqlens(jnp.asarray(cu), 12)
    got = tfa.segment_ids_from_cu_seqlens(cu, 12)
    assert got.tolist() == np.asarray(want).tolist()


def test_dropout_is_ported_with_the_jax_keep_mask():
    """Dropout, refused before it was ported, now runs: the op and
    ``_ref_attention`` with an explicit seed equal the JAX
    ``_ref_attention`` with the same seed (one keep mask), and a seed
    drawn from a seeded ``torch.Generator`` is the same on both routes of
    one call and repeatable."""
    q, k, v, _ = _qkvd(11, 1, 8, 8, 2, 2, 8)
    want = jfa._ref_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              dropout_rate=0.1, dropout_seed=1234)
    for fn in (tfa.flash_attention, tfa._ref_attention):
        got = fn(_t(q), _t(k), _t(v), dropout_rate=0.1, dropout_seed=1234)
        _close(got, want, FWD_TOL)
    a = tfa.flash_attention(_t(q), _t(k), _t(v), dropout_rate=0.5,
                            generator=torch.Generator().manual_seed(3))
    seed = tfa.draw_dropout_seed(torch.Generator().manual_seed(3))
    b = tfa._ref_attention(_t(q), _t(k), _t(v), dropout_rate=0.5,
                           dropout_seed=seed)
    assert torch.equal(a, b)


class _DeviceGenerator:
    """A CUDA generator's host-side surface: its seed and Philox offset."""

    def __init__(self, seed):
        self.device = torch.device("cuda")
        self.manual_seed(seed)

    def manual_seed(self, seed):
        self.seed, self.offset = seed, 0
        return self

    def initial_seed(self):
        return self.seed

    def get_offset(self):
        return self.offset

    def set_offset(self, off):
        self.offset = off


def test_dropout_seed_from_a_device_generator_is_drawn_on_the_host():
    """A CUDA generator's seed is drawn from its seed and offset, never
    read on the device: each draw advances the offset as a draw does, the
    seeds are in range and differ, and reseeding replays them."""
    g = _DeviceGenerator(7)
    first = [tfa.draw_dropout_seed(g) for _ in range(4)]
    assert g.get_offset() == 16
    assert all(0 <= x < 2 ** 31 - 1 for x in first)
    assert len(set(first)) == 4
    g.manual_seed(7)
    assert [tfa.draw_dropout_seed(g) for _ in range(4)] == first
    assert tfa.draw_dropout_seed(_DeviceGenerator(8)) != first[0]


def _cuda_meta(**kw):
    q, k, _, _ = (_t(a) for a in _qkvd(12, 2, 64, 64, 4, 2, 16))
    meta = tfa.flash_meta(q, k, True)
    meta.update(device="cuda", **kw)
    return meta


def test_flash_dispatch_on_cuda_metas():
    """On the card the kernels run or the call raises: the plain version
    never stands in. Bias (and its gradient), segment ids, dropout and
    causal sq > sk all go to the kernels."""
    assert KERNELS.dispatch("flash_attention", _cuda_meta())[0] == "cuda"
    for kw in ({"bias": True}, {"bias": True, "bias_grad": True},
               {"segments": True}, {"dropout": 0.1},
               {"bias": True, "segments": True, "dropout": 0.3}):
        assert KERNELS.dispatch("flash_attention",
                                _cuda_meta(**kw))[0] == "cuda"
    with pytest.raises(RuntimeError, match="head_dim 160"):
        KERNELS.dispatch("flash_attention",
                         _cuda_meta(unsupported=kfa.flash_unsupported(
                             torch.empty(1, 4, 2, 160),
                             torch.empty(1, 4, 2, 160), True)))
    q, k, _, _ = (_t(a) for a in _qkvd(13, 1, 8, 4, 2, 2, 8))
    assert kfa.flash_unsupported(q, k, True) is None     # sq=8 > sk=4
    meta = tfa.flash_meta(q, k, True)
    assert KERNELS.dispatch("flash_attention", meta)[0] == "unfused"
    meta["device"] = "cuda"
    assert KERNELS.dispatch("flash_attention", meta)[0] == "cuda"


def test_wrappers_refuse_cpu_tensors():
    q, k, v, do = (_t(a) for a in _qkvd(14, 1, 8, 8, 2, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kfa.flash_fwd_cuda(q, k, v)
    for kw in ({"bias": torch.zeros(1, 1, 8, 8)},
               {"segment_ids": torch.zeros(1, 8, dtype=torch.int32)},
               {"dropout_rate": 0.1, "dropout_seed": 5}):
        with pytest.raises(ValueError, match="CUDA"):
            kfa.flash_attention_cuda(q, k, v, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        kfa.flash_bwd_dq_cuda(q, k, v, do, torch.zeros(1, 2, 8),
                              torch.zeros(1, 2, 8), bias=torch.zeros(
                                  1, 2, 8, 8), bias_grad=True)
    p = torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA"):
        kfw.fused_adamw_triton(p, p.clone(), p.clone(), p.clone(), 1e-3, 1)


# ---------------------------------------------------------------------------
# the optional bodies: bias and dbias, segment ids, dropout, causal sq > sk
# ---------------------------------------------------------------------------
# (label, b, sq, sk, h, kvh, d, causal, bias extents, segments, rate)
BODY_CASES = [
    ("bias_bh", 2, 64, 64, 4, 2, 16, True, (2, 4), False, 0.0),
    ("bias_1h", 2, 64, 64, 4, 2, 16, True, (1, 4), False, 0.0),
    ("bias_b1", 2, 48, 64, 4, 4, 16, False, (2, 1), False, 0.0),
    ("seg_padding", 2, 64, 64, 4, 2, 16, True, None, True, 0.0),
    ("dropout_gqa", 1, 64, 64, 4, 1, 16, True, None, False, 0.2),
    ("seg_dropout_bias", 2, 40, 40, 4, 2, 16, True, (1, 1), True, 0.1),
    ("causal_sq_gt_sk", 1, 64, 24, 4, 2, 16, True, None, False, 0.0),
]
SEED = 2024


def _body_inputs(case):
    label, b, sq, sk, h, kvh, d, causal, bias, seg, rate = case
    q, k, v, do = _qkvd(len(label) + sq, b, sq, sk, h, kvh, d)
    rng = np.random.RandomState(sk + h)
    extra = {}
    if bias is not None:
        extra["bias"] = (rng.randn(*bias, sq, sk) * 0.5).astype(np.float32)
    if seg:
        sgq = np.sort(rng.randint(0, 3, (b, sq)), axis=1).astype(np.int32)
        sgq[-1, :5] = -1      # padding rows: no key of their id
        sgk = sgq.copy() if sq == sk else np.sort(
            rng.randint(0, 3, (b, sk)), axis=1).astype(np.int32)
        sgk[-1, :5] = -2
        extra["seg_q"], extra["seg_k"] = sgq, sgk
    return q, k, v, do, extra


def _sees_a_key(case, extra):
    """[b, h, sq] rows that see at least one key."""
    _, b, sq, sk, h, _, _, causal, _, _, _ = case
    valid = np.ones((b, 1, sq, sk), bool)
    if causal:
        valid &= np.tril(np.ones((sq, sk), bool), sk - sq)
    if "seg_q" in extra:
        valid &= (extra["seg_q"][:, None, :, None]
                  == extra["seg_k"][:, None, None, :])
    return np.broadcast_to(valid.any(-1), (b, h, sq))


@pytest.mark.parametrize("case", BODY_CASES, ids=[c[0] for c in BODY_CASES])
def test_plain_bodies_match_pallas_passes(case):
    """The plain versions of the three kernels with each optional body
    against the JAX ``_fwd`` and ``_bwd_impl`` launches (interpret mode):
    O everywhere, lse on the rows that see a key (a row that sees none
    gets MASK_VALUE or -inf depending on the tile plan), dq, dk, dv and
    dbias (``bias_grad``, [b*h, sq, sk]) from the same lse and delta."""
    label, b, sq, sk, h, kvh, d, causal, bias, seg, rate = case
    q, k, v, do, extra = _body_inputs(case)
    scale = 1.0 / np.sqrt(d)
    bb, bhh = bias if bias is not None else (1, 1)
    meta = (h, kvh, bb, bhh, bias is not None, None, rate)
    jq, jk, jv, jdo = (_heads_first(q, b, sq, h), _heads_first(k, b, sk, kvh),
                       _heads_first(v, b, sk, kvh), _heads_first(do, b, sq, h))
    jb = (jnp.asarray(extra["bias"]).reshape(bb * bhh, sq, sk)
          if bias is not None else None)
    jsq = (jnp.asarray(extra["seg_q"]).reshape(b, 1, sq) if seg else None)
    jsk = (jnp.asarray(extra["seg_k"]).reshape(b, 1, sk) if seg else None)
    jseed = jnp.asarray([SEED], jnp.uint32) if rate else None
    jo, jlse = _pallas(jpfa._fwd, jq, jk, jv, jb, jsq, jsk, scale, causal,
                       meta, seed=jseed)
    jdq, jdk, jdv, jdb = _pallas(jpfa._bwd_impl, jq, jk, jv, jb, jsq, jsk,
                                 jo, jlse, jdo, scale, causal, meta,
                                 seed=jseed)
    kw = {nm: _t(a) for nm, a in extra.items()}
    kw.update(seed=SEED, rate=rate)
    o, lse = kfa.flash_fwd_ref(_t(q), _t(k), _t(v), causal, **kw)
    back = lambda t, s, n: np.swapaxes(  # noqa: E731
        np.asarray(t).reshape(b, n, s, d), 1, 2)
    _close(o, back(jo, sq, h), FWD_TOL)
    seen = _sees_a_key(case, extra)
    _close(torch.where(torch.from_numpy(seen.copy()), lse, 0.0),
           np.where(seen, np.asarray(jlse).reshape(b, h, sq), 0.0), FWD_TOL)
    delta = (o.float() * _t(do)).sum(-1).transpose(1, 2).contiguous()
    args = (_t(q), _t(k), _t(v), _t(do), lse, delta, causal)
    dq = kfa.flash_bwd_dq_ref(*args, **kw, bias_grad=bias is not None)
    if bias is not None:
        dq, dbias = dq
        _close(dbias, jdb, GRAD_TOL)
    dk, dv = kfa.flash_bwd_dkv_ref(*args, **kw)
    _close(dq, back(jdq, sq, h), GRAD_TOL)
    _close(dk, back(jdk, sk, kvh), GRAD_TOL)
    _close(dv, back(jdv, sk, kvh), GRAD_TOL)


def test_causal_sq_gt_sk_rows_are_zero():
    """A causal row with sq > sk that sees no key gives O = 0 in the
    kernels' plain versions (as the JAX kernel does), and no gradient; the
    semantic ``_ref_attention`` gives the mean of V there, as JAX's
    does."""
    q, k, v, do = (_t(a) for a in _qkvd(15, 1, 40, 16, 2, 2, 8))
    o, lse = kfa.flash_fwd_ref(q, k, v, True)
    top = 40 - 16                 # rows 0..23 see no key
    assert torch.equal(o[:, :top], torch.zeros_like(o[:, :top]))
    assert o[:, top:].abs().sum() > 0
    delta = (o * do).sum(-1).transpose(1, 2).contiguous()
    dq = kfa.flash_bwd_dq_ref(q, k, v, do, lse, delta, True)
    assert torch.equal(dq[:, :top], torch.zeros_like(dq[:, :top]))
    ref = tfa._ref_attention(q, k, v, causal=True)
    _close(ref[:, :top], v.mean(1, keepdim=True).expand(1, top, 2, 8),
           FWD_TOL)
    # lse -inf (a tile that visited no key) is taken without a NaN
    lse_inf = torch.where(torch.arange(40) < top, -torch.inf, lse)
    dk, dv = kfa.flash_bwd_dkv_ref(q, k, v, do, lse_inf, delta, True)
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


@pytest.mark.parametrize("body", ["causal_sq_gt_sk", "segments"])
def test_plain_forward_rows_that_see_no_key(body):
    """A row that sees no key (causal with sq > sk; a segment id no key
    has) gets lse = MASK_VALUE and O = 0 from the plain forward, the value
    the CUDA kernels give a row whose query tile visits a key tile, and the
    JAX kernel's on the same inputs (one tile: every row's tile visits)."""
    b, sq, sk, h, kvh, d = 2, 40, 16, 2, 1, 8
    q, k, v, _ = _qkvd(16, b, sq, sk, h, kvh, d)
    kw, jseg = {}, (None, None)
    if body == "segments":
        rng = np.random.RandomState(3)
        sgq = rng.randint(0, 3, (b, sq)).astype(np.int32)
        sgq[:, :7] = 9                  # no key has id 9
        sgk = rng.randint(0, 3, (b, sk)).astype(np.int32)
        kw = {"seg_q": _t(sgq), "seg_k": _t(sgk)}
        jseg = (jnp.asarray(sgq).reshape(b, 1, sq),
                jnp.asarray(sgk).reshape(b, 1, sk))
    causal = body == "causal_sq_gt_sk"
    o, lse = kfa.flash_fwd_ref(_t(q), _t(k), _t(v), causal, **kw)
    unseen = ~torch.from_numpy(_sees_a_key(
        ("", b, sq, sk, h, kvh, d, causal, None, None, None),
        {nm: t.numpy() for nm, t in kw.items()}).copy())
    assert int(unseen.sum()) == (2 * 2 * 24 if causal else 2 * 2 * 7)
    assert bool((lse[unseen] == kfa.MASK_VALUE).all())
    assert bool((o.transpose(1, 2)[unseen] == 0).all())
    assert bool((lse[~unseen] > kfa.MASK_VALUE / 2).all())
    meta = (h, kvh, 1, 1, False, None, 0.0)
    _, jlse = _pallas(jpfa._fwd, _heads_first(q, b, sq, h),
                      _heads_first(k, b, sk, kvh), _heads_first(v, b, sk, kvh),
                      None, *jseg, 1.0 / np.sqrt(d), causal, meta)
    jlse = np.asarray(jlse).reshape(b, h, sq)
    assert (jlse[unseen.numpy()] == np.float32(kfa.MASK_VALUE)).all()


@pytest.mark.parametrize("seed", [0, 1, 77, 2 ** 31 - 2, 2 ** 32 - 1])
def test_dropout_keep_is_jax_bit_for_bit(seed):
    """The torch keep mask against JAX's ``_dropout_keep`` over a grid of
    heads and absolute positions (the hash in int64 masked to 32 bits
    against JAX's uint32), at three rates."""
    for qbh, q0, k0, rate in ((0, 0, 0, 0.1), (7, 512, 64, 0.3),
                              (4095, 100_000, 131_000, 0.5)):
        want = np.asarray(jpfa._dropout_keep(
            jnp.asarray(seed, jnp.uint32), jnp.int32(qbh),
            jnp.int32(q0 // 32), jnp.int32(k0 // 16), 32, 16, rate))
        got = kfa.dropout_keep(seed, qbh,
                               torch.arange(32)[:, None] + q0 // 32 * 32,
                               torch.arange(16)[None, :] + k0 // 16 * 16,
                               rate)
        assert np.array_equal(got.numpy(), want)
        assert 0 < want.mean() < 1


def test_wrappers_refuse_malformed_bodies():
    """Over meta tensors under a capture (no card needed) the wrappers
    check the optional operands before any launch: a bias that is not
    [b|1, h|1, sq, sk] f32, one segment-id tensor without the other or of
    the wrong shape or type, a dropout rate outside [0, 1), dbias without
    a bias; and record each body's spec."""
    from paddle_tpu_torch.ops.kernels import _launch

    def m(*shape, dt=torch.float32):
        return torch.empty(*shape, dtype=dt, device="meta")
    q, k = m(2, 64, 4, 16), m(2, 48, 2, 16)
    st = m(2, 4, 64)
    seg_q, seg_k = m(2, 64, dt=torch.int32), m(2, 48, dt=torch.int32)
    bad = [({"bias": m(2, 2, 64, 48)}, "bias must be"),
           ({"bias": m(1, 4, 64, 48, dt=torch.bfloat16)}, "bias must be"),
           ({"bias": m(1, 4, 48, 64)}, "bias must be"),
           ({"seg_q": seg_q}, "both segment ids"),
           ({"seg_q": seg_q, "seg_k": m(2, 64, dt=torch.int32)}, "seg_k"),
           ({"seg_q": seg_q.float(), "seg_k": seg_k}, "seg_q"),
           ({"rate": 1.0}, "dropout rate")]
    with _launch.capture_kernel_launches() as specs:
        for kw, msg in bad:
            with pytest.raises(ValueError, match=msg):
                kfa.flash_fwd_cuda(q, k, k, True, **kw)
        with pytest.raises(ValueError, match="bias_grad needs a bias"):
            kfa.flash_bwd_dq_cuda(q, k, k, q, st, st, True, bias_grad=True)
        assert specs == []
        o, lse = kfa.flash_fwd_cuda(q, k, k, True, bias=m(1, 4, 64, 48),
                                    seg_q=seg_q, seg_k=seg_k, seed=3,
                                    rate=0.1)
        dq, db = kfa.flash_bwd_dq_cuda(q, k, k, q, st, st, True,
                                       bias=m(2, 1, 64, 48), bias_grad=True)
    assert o.shape == q.shape and lse.shape == (2, 4, 64)
    assert db.shape == (8, 64, 48) and db.dtype == torch.float32
    assert [sp.params for sp in specs] == [
        {"causal": True, "bias": (1, 4), "segments": True, "dbias": False,
         "dropout": True},
        {"causal": True, "bias": (2, 1), "segments": False, "dbias": True,
         "dropout": False}]
    assert kfa.body_class(bias=True, seg=True, dropout=True) == \
        "bias,seg,dropout"
    assert kfa.body_class() == "plain"


def test_dropout_inv_is_the_f32_constant():
    for rate in (0.1, 0.3, 0.5):
        assert kfa.dropout_inv(rate) == float(np.float32(1 / (1 - rate)))


def _jax_ref_vjp(q, k, v, do, extra, **kw):
    """JAX ``_ref_attention``'s value and its vjp (with the bias's)."""
    bias = extra.get("bias")
    seg = extra.get("seg_q")
    args = [jnp.asarray(a) for a in (q, k, v)] + (
        [jnp.asarray(bias)] if bias is not None else [])

    def fn(q, k, v, *b):
        return jfa._ref_attention(
            q, k, v, bias=b[0] if b else None,
            segment_ids=None if seg is None else jnp.asarray(seg),
            kv_segment_ids=(None if seg is None
                            else jnp.asarray(extra["seg_k"])), **kw)

    def value_and_vjp(*a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(jnp.asarray(do))
    return jax.jit(value_and_vjp)(*args)


def _plain_kernel_route(q, k, v, do, extra, causal, seed, rate):
    """O and the gradients through the kernels' plain versions (the
    arithmetic the CUDA kernels are held to), and the bias's summed over
    its broadcast axes as ``FlashAttention.backward`` sums it."""
    kw = {nm: _t(a) for nm, a in extra.items()}
    kw.update(seed=seed, rate=rate)
    o, lse = kfa.flash_fwd_ref(_t(q), _t(k), _t(v), causal, **kw)
    delta = (o * _t(do)).sum(-1).transpose(1, 2).contiguous()
    args = (_t(q), _t(k), _t(v), _t(do), lse, delta, causal)
    has_bias = "bias" in extra
    dq = kfa.flash_bwd_dq_ref(*args, **kw, bias_grad=has_bias)
    grads = list((dq if has_bias else (dq,))[:1])
    grads += list(kfa.flash_bwd_dkv_ref(*args, **kw))
    if has_bias:
        grads.append(kfa._sum_broadcast(dq[1], extra["bias"].shape,
                                        q.shape[0], q.shape[2]))
    return o, grads


# (label, b, s, h, kvh, d, causal, bias extents, segments, rate, seed)
STREAM_CASES = [
    # tests/test_pallas_ops.py::TestFlashAttentionExtended (:191)
    ("gqa_causal", 2, 256, 4, 1, 64, True, None, False, 0.0, 0),
    ("gqa_full", 2, 256, 4, 1, 64, False, None, False, 0.0, 0),
    ("bias_fwd_bwd", 2, 128, 2, 2, 64, True, (1, 2), False, 0.0, 0),
    ("segment_ids", 2, 256, 2, 2, 64, True, None, True, 0.0, 5),
    # ::TestFlashDropout (:370)
    ("dropout_exact_mask", 2, 128, 4, 2, 64, True, None, False, 0.3, 0),
    ("dropout_segments", 2, 128, 2, 2, 64, True, None, True, 0.3, 0),
]


def _stream_inputs(case):
    label, b, s, h, kvh, d, causal, bias, seg, rate, seed = case
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, kvh, d).astype(np.float32)
    v = rng.randn(b, s, kvh, d).astype(np.float32)
    do = np.random.RandomState(99).randn(b, s, h, d).astype(np.float32)
    extra = {}
    if bias is not None:
        extra["bias"] = (np.random.RandomState(3).randn(*bias, s, s)
                         * 0.5).astype(np.float32)
    if seg and rate:
        sg = np.concatenate([np.zeros((b, s // 2)), np.ones((b, s // 2))],
                            1).astype(np.int32)
        extra["seg_q"] = extra["seg_k"] = sg
    elif seg:
        sg = np.sort(np.random.RandomState(6).randint(0, 3, (b, s)),
                     axis=1).astype(np.int32)
        extra["seg_q"] = extra["seg_k"] = sg
    return q, k, v, do, extra


@pytest.mark.parametrize("case", STREAM_CASES,
                         ids=[c[0] for c in STREAM_CASES])
def test_jax_flash_streams_replayed(case):
    """The input streams of the JAX package's flash tests (the seeds,
    shapes, bias, segments and dropout seeds of TestFlashAttentionExtended
    and TestFlashDropout), through the port: the op (its plain route on
    the CPU) and the kernels' plain versions against JAX's
    ``_ref_attention`` and its vjp (with the bias's, as ``bias_grad``),
    which those JAX tests hold the Pallas kernels to. Dropout seeds 77 and
    11 as there."""
    label, b, s, h, kvh, d, causal, bias, seg, rate, _ = case
    q, k, v, do, extra = _stream_inputs(case)
    seed = 11 if seg else 77
    dkw = dict(dropout_rate=rate, dropout_seed=seed) if rate else {}
    want, wgrads = _jax_ref_vjp(q, k, v, do, extra, causal=causal, **dkw)
    o, grads = _plain_kernel_route(q, k, v, do, extra, causal, seed, rate)
    _close(o, want, FWD_TOL)
    for g, w in zip(grads, wgrads):
        scale = float(np.abs(np.asarray(w)).max()) + 1e-9
        _close(g / scale, np.asarray(w) / scale, GRAD_TOL)
    leaves = [_t(a, True) for a in (q, k, v)]
    tb = _t(extra["bias"], True) if bias is not None else None
    out = tfa.flash_attention(
        *leaves, causal=causal, bias=tb, bias_grad=tb is not None,
        segment_ids=_t(extra["seg_q"]) if seg else None,
        kv_segment_ids=_t(extra["seg_k"]) if seg else None, **dkw)
    out.backward(_t(do))
    _close(out, want, FWD_TOL)
    for g, w in zip([t.grad for t in leaves] + ([tb.grad] if tb is not None
                                                else []), wgrads):
        _close(g, w, GRAD_TOL)


def test_dropout_deterministic_and_mean_preserving():
    """::TestFlashDropout's last stream: one seed gives one output; the
    mean over 24 seeds approaches the undropped output."""
    rng = np.random.RandomState(0)
    q, k, v = (_t(rng.randn(1, 128, n, 64).astype(np.float32))
               for n in (2, 1, 1))
    o0 = tfa.flash_attention(q, k, v, causal=True)
    a = tfa.flash_attention(q, k, v, causal=True, dropout_rate=0.3,
                            dropout_seed=5)
    b = tfa.flash_attention(q, k, v, causal=True, dropout_rate=0.3,
                            dropout_seed=5)
    assert torch.equal(a, b)
    acc = sum(tfa.flash_attention(q, k, v, causal=True, dropout_rate=0.3,
                                  dropout_seed=s) for s in range(24)) / 24
    err = float((acc - o0).abs().mean() / o0.abs().mean())
    assert err < 0.25, err


@pytest.mark.parametrize("bias_shape", [(1, 4), (2, 1), (2, 4), (1, 1)])
def test_flash_attention_function_bias_grad_sums_broadcast_axes(bias_shape):
    """``FlashAttention.backward``'s dbias: the dq body's [b*h, sq, sk]
    summed over the bias's broadcast axes in f32, cast to the bias's type,
    equal to autograd through ``_ref_attention``'s additive bias."""
    q, k, v, do = _qkvd(16, 2, 24, 24, 4, 2, 8)
    bias = np.random.RandomState(17).randn(*bias_shape, 24, 24).astype(
        np.float32)
    extra = {"bias": bias}
    _, grads = _plain_kernel_route(q, k, v, do, extra, True, 0, 0.0)
    tb = _t(bias, True)
    out = tfa._ref_attention(_t(q), _t(k), _t(v), causal=True, bias=tb)
    out.backward(_t(do))
    assert grads[-1].shape == tb.shape
    _close(grads[-1], tb.grad.numpy(), GRAD_TOL)


# ---------------------------------------------------------------------------
# fused AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,mdt,shadow,scale", [
    (1000, np.float32, None, None), (4099, np.float32, "bfloat16", 0.25),
    (777, "bfloat16", "bfloat16", 0.5)])
def test_adamw_matches_jax_ref_and_pallas(n, mdt, shadow, scale):
    """The plain version against the JAX ``adamw_update_ref`` and the
    Pallas ``fused_adamw`` (interpret mode), in place. Tolerance: f32
    results within 2 f32 ulps of the tensor's largest magnitude (XLA may
    contract ``b1*m + (1-b1)*g`` into an FMA, and the bias corrections'
    pow may round differently), bf16 moments and shadow within one bf16
    ulp of it (2^-7)."""
    rng = np.random.RandomState(n)
    p = rng.randn(n).astype(np.float32)
    g = (rng.randn(n) * 1e-2).astype(np.float32)
    m = (rng.randn(n) * 1e-3).astype(np.float32)
    v = (rng.rand(n) * 1e-4).astype(np.float32)
    jm, jv = (jnp.asarray(a).astype(mdt) for a in (m, v))
    kw = dict(beta1=0.9, beta2=0.95, weight_decay=0.1, grad_scale=scale)
    wants = [_pallas(jfw.adamw_update_ref, jnp.asarray(p), jnp.asarray(g),
                     jm, jv, 1e-3, 3.0, shadow_dtype=shadow, **kw),
             _pallas(jfw.fused_adamw, jnp.asarray(p), jnp.asarray(g), jm, jv,
                     1e-3, 3.0, shadow_dtype=shadow, **kw)]
    tdt = torch.float32 if mdt == np.float32 else torch.bfloat16
    tp, tg = _t(p), _t(g)
    tm, tv = _t(m).to(tdt), _t(v).to(tdt)
    got = kfw.adamw_update(tp, tg, tm, tv, 1e-3, 3,
                           shadow_dtype=(None if shadow is None
                                         else torch.bfloat16), **kw)
    assert got[0] is tp and got[1] is tm and got[2] is tv
    assert len(got) == (4 if shadow else 3)
    for want in wants:
        for gt, w in zip(got, want):
            rtol = 2.4e-7 if gt.dtype == torch.float32 else 2 ** -7
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(gt.float().numpy(), w, rtol=rtol,
                                       atol=rtol * float(np.abs(w).max()))


def test_adamw_dispatch():
    assert KERNELS.dispatch("fused_adamw", kfw.adamw_meta(
        10, torch.float32, torch.bfloat16, True, "cuda"))[0] == "cuda"
    assert KERNELS.dispatch("fused_adamw", kfw.adamw_meta(
        10, torch.float32, torch.float32, False, "cpu"))[0] == "unfused"
    with pytest.raises(RuntimeError, match="f32 master"):
        KERNELS.dispatch("fused_adamw", kfw.adamw_meta(
            10, torch.bfloat16, torch.float32, False, "cuda"))


def test_build_starts_one_nvcc_per_source_together(tmp_path, monkeypatch):
    """``_build.build`` compiles every missing library at once: each
    source gets its own nvcc process, all running before any is waited
    for (the fake nvcc waits until both have started, and fails after
    10 s)."""
    from paddle_tpu_torch.ops.kernels import _build
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "out=''; prev=''\n"
        "for a in \"$@\"; do [ \"$prev\" = -o ] && out=$a; prev=$a; done\n"
        f"touch {tmp_path}/started.$$\n"
        "n=0\n"
        f"while [ $(ls {tmp_path} | grep -c started) -lt 2 ]; do\n"
        "  n=$((n+1)); [ $n -gt 200 ] && exit 1; sleep 0.05\n"
        "done\n"
        "echo 'ptxas info    : Used 32 registers'\n"
        "touch \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.build(["flash_attention", "paged_attention"])
    for name in ("flash_attention", "paged_attention"):
        lib = _build.library_path(name)
        assert lib.exists()
        assert "registers" in lib.with_suffix(".log").read_text()
