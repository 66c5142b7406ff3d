"""PyTorch/CUDA port, the attention functionals
(``paddle_tpu_torch.nn.functional``) and the fused attention block
(``paddle_tpu_torch.incubate.nn.functional``) against the JAX package's on
the CPU, f32, on the same numpy arrays.

Dropout: the flash op's keep mask is a hash of a seed, so both packages'
``flash_attention`` ops are handed one explicit seed (each package draws
its own seed from its own RNG otherwise); the out-projection's Bernoulli
dropout of ``fused_multi_head_attention`` draws from each package's RNG and
is compared at rate 0. Tolerances: ``FWD_TOL``/``GRAD_TOL`` of
tests/test_torch_flash_attention.py (f32 sums in another order)."""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.ops.flash_attention as jfa
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.torch_port

FWD_TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
SEED = 4321


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = want.numpy() if hasattr(want, "numpy") else np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _j(a, grad=False):
    return paddle.to_tensor(a, stop_gradient=not grad)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.fixture
def fixed_seed(monkeypatch):
    """Both packages' flash ops with dropout seed ``SEED``."""
    def pin(fn):
        @functools.wraps(fn)
        def call(*a, **kw):
            kw["dropout_seed"] = SEED
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(jfa, "flash_attention", pin(jfa.flash_attention))
    monkeypatch.setattr(tfa, "flash_attention", pin(tfa.flash_attention))
    monkeypatch.setattr(TIF, "_flash", pin(TIF._flash))


def _run_both(jfn, tfn, arrays, dout, grad_idx=None):
    """(JAX out and grads, port out and grads) of the functionals on the
    same arrays; grads of ``sum(out * dout)`` for ``grad_idx``."""
    grad_idx = range(len(arrays)) if grad_idx is None else grad_idx
    js = [_j(a, i in grad_idx) for i, a in enumerate(arrays)]
    ts = [_t(a, i in grad_idx) for i, a in enumerate(arrays)]
    jout, tout = jfn(*js), tfn(*ts)
    jout = jout[0] if isinstance(jout, tuple) else jout
    tout = tout[0] if isinstance(tout, tuple) else tout
    (jout * _j(dout)).sum().backward()
    (tout * _t(dout)).sum().backward()
    return ((jout.numpy(), [js[i].grad.numpy() for i in grad_idx]),
            (tout, [ts[i].grad for i in grad_idx]))


def _check(both):
    (jo, jg), (to, tg) = both
    _close(to, jo, FWD_TOL)
    for g, w in zip(tg, jg):
        _close(g, w, GRAD_TOL)


def _qkv(seed, b, s, h, kvh, d, sk=None):
    rng = np.random.RandomState(seed)
    sk = s if sk is None else sk
    return (rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, sk, kvh, d).astype(np.float32),
            rng.randn(b, sk, kvh, d).astype(np.float32),
            rng.randn(b, s, h, d).astype(np.float32))


@pytest.mark.parametrize("causal,rate,kvh", [(True, 0.0, 2), (False, 0.0, 4),
                                             (True, 0.2, 1), (False, 0.1, 2)])
def test_sdpa_matches_jax(fixed_seed, causal, rate, kvh):
    """No mask: the flash op, dropout in-kernel (one seed on both
    sides)."""
    q, k, v, do = _qkv(1, 2, 24, 4, kvh, 16)
    _check(_run_both(
        lambda *a: JF.scaled_dot_product_attention(
            *a, dropout_p=rate, is_causal=causal),
        lambda *a: TF.scaled_dot_product_attention(
            *a, dropout_p=rate, is_causal=causal), (q, k, v), do))


def test_sdpa_causal_sq_gt_sk_matches_jax():
    """is_causal with sq > sk: the top rows see no key; on the CPU both
    packages take the composition, which gives them the mean of V."""
    q, k, v, do = _qkv(2, 1, 20, 2, 2, 8, sk=12)
    _check(_run_both(
        lambda *a: JF.scaled_dot_product_attention(*a, is_causal=True),
        lambda *a: TF.scaled_dot_product_attention(*a, is_causal=True),
        (q, k, v), do))


@pytest.mark.parametrize("kind", ["float", "bool"])
def test_sdpa_with_mask_matches_jax(kind):
    """A mask: ``_sdpa_ref`` (additive float or boolean keep)."""
    q, k, v, do = _qkv(3, 2, 16, 2, 2, 8)
    rng = np.random.RandomState(4)
    mask = (rng.randn(2, 1, 16, 16).astype(np.float32) if kind == "float"
            else rng.rand(2, 1, 16, 16) > 0.3)
    _check(_run_both(
        lambda q, k, v, m: JF.scaled_dot_product_attention(q, k, v, m),
        lambda q, k, v, m: TF.scaled_dot_product_attention(q, k, v, m),
        (q, k, v, mask), do, grad_idx=(0, 1, 2)))


def test_sdpa_ref_dropout_draws_from_the_generator():
    """``_sdpa_ref``'s Bernoulli dropout: one generator state, one mask;
    the kept share near 1 - p, the kept values scaled by 1 / (1 - p)."""
    q, k, v, _ = (_t(a) for a in _qkv(5, 1, 64, 2, 2, 8))
    m = torch.zeros(1, 1, 64, 64)
    a, b = (TF.scaled_dot_product_attention(
        q, k, v, m, dropout_p=0.5, generator=torch.Generator().manual_seed(
            9)) for _ in range(2))
    assert torch.equal(a, b)
    ones = torch.ones(1, 64, 2, 8)
    out = TF.scaled_dot_product_attention(
        torch.zeros(1, 64, 2, 8), torch.zeros(1, 64, 2, 8), ones, m,
        dropout_p=0.5, generator=torch.Generator().manual_seed(1))
    # uniform P = 1/64: each output is (kept count) * 2 / 64
    kept = out[0, :, :, 0] * 32
    assert torch.allclose(kept, kept.round(), atol=1e-4)
    assert 0.4 < float(kept.mean()) / 64 < 0.6


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_flash_attention_functional_matches_jax(fixed_seed, rate):
    q, k, v, do = _qkv(6, 2, 32, 4, 2, 16)
    _check(_run_both(
        lambda *a: JF.flash_attention(*a, dropout=rate, causal=True),
        lambda *a: TF.flash_attention(*a, dropout=rate, causal=True),
        (q, k, v), do))
    out, sm = TF.flash_attention(*(_t(a) for a in (q, k, v)),
                                 return_softmax=True)
    assert sm is None


def _packed(seed, lens, h, kvh, d):
    rng = np.random.RandomState(seed)
    total = sum(lens)
    cu = np.cumsum([0] + list(lens)).astype(np.int32)
    return (rng.randn(total, h, d).astype(np.float32),
            rng.randn(total, kvh, d).astype(np.float32),
            rng.randn(total, kvh, d).astype(np.float32),
            rng.randn(total, h, d).astype(np.float32), cu)


@pytest.mark.parametrize("causal,rate,kvh", [(True, 0.0, 2), (True, 0.3, 2),
                                             (False, 0.1, 1)])
def test_flash_attn_unpadded_matches_jax(fixed_seed, causal, rate, kvh):
    """The packed varlen path (the lengths of
    ``TestFlashAttentionExtended::test_flash_attn_unpadded``): segment ids
    from cu_seqlens, causal within each sequence, dropout in-kernel."""
    q, k, v, do, cu = _packed(7, [60, 100, 96], 2, kvh, 16)
    _check(_run_both(
        lambda q, k, v, c: JF.flash_attn_unpadded(
            q, k, v, c, c, dropout=rate, causal=causal),
        lambda q, k, v, c: TF.flash_attn_unpadded(
            q, k, v, c, c, dropout=rate, causal=causal),
        (q, k, v, cu), do, grad_idx=(0, 1, 2)))


def test_flash_attn_unpadded_per_sequence_and_causal_check():
    """Each packed sequence attends only itself (against a per-sequence
    composition), and causal with two packings raises as in JAX."""
    q, k, v, _, cu = _packed(8, [5, 9, 3], 2, 2, 8)
    out, _ = TF.flash_attn_unpadded(_t(q), _t(k), _t(v), _t(cu), _t(cu),
                                    causal=True)
    for a, b in zip(cu[:-1], cu[1:]):
        want = tfa._ref_attention(*(_t(x[a:b][None]) for x in (q, k, v)),
                                  causal=True)[0]
        _close(out[a:b], want.numpy(), FWD_TOL)
    # one packing given as two tensors of two integer types is the same
    same, _ = TF.flash_attn_unpadded(_t(q), _t(k), _t(v), _t(cu),
                                     torch.as_tensor(cu, dtype=torch.int64),
                                     causal=True)
    assert torch.equal(same, out)
    other = np.array([0, 6, 14, 17], np.int32)
    with pytest.raises(NotImplementedError, match="cu_seqlens_q"):
        TF.flash_attn_unpadded(_t(q), _t(k), _t(v), _t(cu), _t(other),
                               causal=True)
    out2, _ = TF.flash_attn_unpadded(_t(q), _t(k), _t(v), _t(cu), _t(other))
    assert torch.isfinite(out2).all()


@pytest.mark.parametrize("g,rate", [(1, 0.0), (4, 0.0), (2, 0.2)])
def test_flash_attn_qkvpacked_matches_jax(fixed_seed, g, rate):
    """qkv [B, S, G + 2, Hk, D]: G query heads a K/V head, consecutive."""
    rng = np.random.RandomState(9 + g)
    qkv = rng.randn(2, 16, g + 2, 2, 8).astype(np.float32)
    do = rng.randn(2, 16, 2 * g, 8).astype(np.float32)
    _check(_run_both(
        lambda p: JF.flash_attn_qkvpacked(p, dropout=rate, causal=True),
        lambda p: TF.flash_attn_qkvpacked(p, dropout=rate, causal=True),
        (qkv,), do))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_attn_varlen_qkvpacked_matches_jax(fixed_seed, rate):
    """The packed varlen form, GQA 4:1, causal, dropout."""
    rng = np.random.RandomState(10)
    lens = [7, 12, 5]
    cu = np.cumsum([0] + lens).astype(np.int32)
    qkv = rng.randn(sum(lens), 6, 2, 8).astype(np.float32)
    do = rng.randn(sum(lens), 8, 8).astype(np.float32)
    _check(_run_both(
        lambda p, c: JF.flash_attn_varlen_qkvpacked(
            p, c, c, dropout=rate, causal=True),
        lambda p, c: TF.flash_attn_varlen_qkvpacked(
            p, c, c, dropout=rate, causal=True),
        (qkv, cu), do, grad_idx=(0,)))


# tests/test_api_longtail.py's flashmask streams (:215, :229, :529)
def test_flashmask_full_visible_matches_plain():
    rng = np.random.RandomState(1)
    B, S, H, D = 1, 8, 2, 8
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    idx = np.full((B, H, S, 1), S, np.int32)
    got = TF.flashmask_attention(_t(q), _t(k), _t(v), _t(idx), causal=True)
    want = JF.flashmask_attention(_j(q), _j(k), _j(v), _j(idx), causal=True)
    _close(got, want.numpy(), FWD_TOL)
    ref, _ = TF.flash_attention(_t(q), _t(k), _t(v), causal=True)
    _close(got, ref.numpy(), FWD_TOL)


def test_flashmask_blocks_range():
    B, S, H, D = 1, 6, 1, 4
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    idx = np.full((B, H, S, 1), S, np.int32)
    idx[0, 0, 0, 0] = 2
    got = TF.flashmask_attention(_t(q), _t(k), _t(v), _t(idx), causal=True)
    want = JF.flashmask_attention(_j(q), _j(k), _j(v), _j(idx), causal=True)
    _close(got, want.numpy(), FWD_TOL)
    s = (q[0, :, 0] @ k[0, :, 0].T) / np.sqrt(D)
    mask = np.triu(np.ones((S, S), bool), 1)
    mask[2:, 0] = True
    s = np.where(mask, -np.inf, s)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    _close(got[0, :, 0], p @ v[0, :, 0], FWD_TOL)


@pytest.mark.parametrize("causal,L", [(True, 2), (False, 2), (False, 4)])
def test_flashmask_ranges_match_jax(causal, L):
    rng = np.random.RandomState(3 + L)
    B, S, H, Hk, D = 2, 8, 4, 2, 8
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    idx = np.sort(rng.randint(0, S + 1, (B, Hk, S, L)), -1).astype(np.int32)
    got = TF.flashmask_attention(_t(q), _t(k), _t(v), _t(idx),
                                 causal=causal)
    want = JF.flashmask_attention(_j(q), _j(k), _j(v), _j(idx),
                                  causal=causal)
    _close(got, want.numpy(), FWD_TOL)


def test_flashmask_fully_masked_row_no_nan():
    B, S, H, D = 1, 4, 1, 4
    rng = np.random.RandomState(8)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    idx = np.zeros((B, H, S, 1), np.int32)
    got = TF.flashmask_attention(_t(q), _t(k), _t(v), _t(idx), causal=True)
    assert torch.isfinite(got).all()
    want = JF.flashmask_attention(_j(q), _j(k), _j(v), _j(idx), causal=True)
    _close(got, want.numpy(), FWD_TOL)


def test_sequence_mask_and_sparse_attention_match_jax():
    lens = np.array([[1, 3], [0, 4]], np.int64)
    for maxlen, dt in ((None, "int64"), (6, "float32"), (5, "bool")):
        got = TF.sequence_mask(_t(lens), maxlen, dt)
        want = JF.sequence_mask(_j(lens), maxlen, dt)
        assert str(got.dtype).endswith(dt)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    B, H, S, D = 1, 2, 5, 8
    rng = np.random.RandomState(12)
    q, k, v = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(3))
    cols, offs = [], [0]
    for i in range(S):
        row = sorted({0, i} if i != 3 else set())   # row 3 attends nothing
        cols.extend(row)
        offs.append(len(cols))
    off = np.tile(np.array(offs, np.int32), (B, H, 1))
    col = np.tile(np.array(cols, np.int32), (B, H, 1))
    kpm = np.array([[1, 1, 0, 1, 1]], np.int32)
    for extra in ((), (kpm,)):
        got = TF.sparse_attention(_t(q), _t(k), _t(v), _t(off), _t(col),
                                  *(_t(a) for a in extra))
        want = JF.sparse_attention(_j(q), _j(k), _j(v), _j(off), _j(col),
                                   *(_j(a) for a in extra))
        _close(got, want.numpy(), FWD_TOL)
        assert float(got[0, :, 3].abs().max()) == 0.0


def test_dropout_functional():
    """``nn.functional.dropout``: scaled kept values, one mask per
    generator state, axis-shared decisions, inference modes."""
    x = torch.ones(4, 256)
    a = TF.dropout(x, 0.25, generator=torch.Generator().manual_seed(2))
    b = TF.dropout(x, 0.25, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) <= {0.0, float(np.float32(1 / 0.75))}
    assert 0.65 < float((a > 0).float().mean()) < 0.85
    c = TF.dropout(x, 0.5, axis=1, generator=torch.Generator().manual_seed(
        4))
    assert torch.equal(c, c[:1].expand(4, 256))
    d = TF.dropout(x, 0.5, mode="downscale_in_infer",
                   generator=torch.Generator().manual_seed(5))
    assert set(d.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(TF.dropout(x, 0.5, training=False), x)
    assert torch.equal(TF.dropout(x, 0.5, training=False,
                                  mode="downscale_in_infer"), x * 0.5)
    got = JF.dropout(_j(x.numpy()), 0.5, training=False,
                     mode="downscale_in_infer")
    np.testing.assert_array_equal(got.numpy(), (x * 0.5).numpy())


def test_fused_matmul_bias_matches_jax():
    rng = np.random.RandomState(13)
    x, y = rng.randn(3, 4, 5).astype(np.float32), \
        rng.randn(3, 6, 5).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    got = TIF.fused_matmul_bias(_t(x), _t(y), _t(bias), transpose_y=True)
    want = JIF.fused_matmul_bias(_j(x), _j(y), _j(bias), transpose_y=True)
    _close(got, want.numpy(), FWD_TOL)
    got = TIF.fused_matmul_bias(_t(x).transpose(1, 2), _t(y),
                                transpose_x=True, transpose_y=True)
    want = JIF.fused_matmul_bias(_j(x).transpose([0, 2, 1]), _j(y),
                                 transpose_x=True, transpose_y=True)
    _close(got, want.numpy(), FWD_TOL)


def _mha_inputs(seed, b, s, hid, nh, mask):
    rng = np.random.RandomState(seed)
    hd = hid // nh
    arrays = {
        "x": rng.randn(b, s, hid).astype(np.float32),
        "qkv_weight": (rng.randn(3, nh, hd, hid) * 0.2).astype(np.float32),
        "linear_weight": (rng.randn(hid, hid) * 0.2).astype(np.float32),
        "qkv_bias": (rng.randn(3, nh, hd) * 0.1).astype(np.float32),
        "linear_bias": (rng.randn(hid) * 0.1).astype(np.float32),
        "ln_scale": (1 + 0.1 * rng.randn(hid)).astype(np.float32),
        "ln_bias": (0.1 * rng.randn(hid)).astype(np.float32)}
    if mask == "padding":
        lens = rng.randint(s // 2, s + 1, b)
        pad = np.where(np.arange(s)[None] < lens[:, None], 0.0, -1e4)
        arrays["attn_mask"] = pad.reshape(b, 1, 1, s).astype(np.float32)
    else:
        arrays["attn_mask"] = (rng.randn(1, nh, s, s) * 0.5).astype(
            np.float32)
    return arrays, rng.randn(b, s, hid).astype(np.float32)


@pytest.mark.parametrize("mask,pre_ln,attn_rate", [
    ("padding", False, 0.0), ("padding", False, 0.1),
    ("learned", True, 0.0), ("learned", False, 0.2)])
def test_fused_multi_head_attention_matches_jax(fixed_seed, mask, pre_ln,
                                                attn_rate):
    """The MHA block: a padding mask [b, 1, 1, s] broadcast into the
    kernels' bias (a constant), or a learned relative-position bias
    [1, h, s, s] that requires grad (the dbias body, summed over the
    batch); attention dropout in-kernel with one seed; out-projection
    dropout at 0. Values and the gradients of x, the QKV weight and a
    learned bias."""
    arrays, dout = _mha_inputs(14, 2, 16, 32, 4, mask)
    names = list(arrays)
    grads = {"x", "qkv_weight"} | ({"attn_mask"} if mask == "learned"
                                   else set())

    def call(mod, *vals):
        a = dict(zip(names, vals))
        if pre_ln:
            a["pre_ln_scale"], a["pre_ln_bias"] = a.pop("ln_scale"), \
                a.pop("ln_bias")
        return mod.fused_multi_head_attention(
            a.pop("x"), a.pop("qkv_weight"), a.pop("linear_weight"),
            pre_layer_norm=pre_ln, dropout_rate=0.0,
            attn_dropout_rate=attn_rate, **a)
    _check(_run_both(functools.partial(call, JIF),
                     functools.partial(call, TIF),
                     [arrays[n] for n in names], dout,
                     grad_idx=[i for i, n in enumerate(names)
                               if n in grads]))


def test_fused_multi_head_attention_queued_paths_raise():
    x = torch.zeros(1, 4, 8)
    w = torch.zeros(3, 2, 4, 8)
    with pytest.raises(NotImplementedError, match="A14"):
        TIF.fused_multi_head_attention(x, w, torch.zeros(8, 8),
                                       cache_kv=torch.zeros(2, 1, 2, 3, 4))
    for fn in (TIF.fused_feedforward, TIF.fused_multi_transformer):
        with pytest.raises(NotImplementedError, match="A14"):
            fn(x)
    import paddle_tpu_torch.incubate.nn as tin
    with pytest.raises(NotImplementedError, match="A14"):
        tin.FusedMultiHeadAttention
    with pytest.raises(AttributeError):
        tin.NoSuchLayer
