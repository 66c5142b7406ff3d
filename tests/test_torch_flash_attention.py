"""PyTorch/CUDA port, flash attention and fused AdamW: the plain versions
against the JAX package's references and its Pallas kernels (interpret
mode), the dispatch of both ops, and the wrappers' refusals, on the CPU
(f32 unless a test says otherwise).

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


def test_dropout_is_not_ported():
    q, k, v, _ = (_t(a) for a in _qkvd(11, 1, 8, 8, 2, 2, 8))
    with pytest.raises(NotImplementedError, match="dropout"):
        tfa.flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(NotImplementedError, match="dropout"):
        tfa._ref_attention(q, k, v, dropout_rate=0.1)


def _cuda_meta(**kw):
    q, k, _, _ = (_t(a) for a in _qkvd(12, 2, 64, 64, 4, 2, 16))
    meta = tfa.flash_meta(q, k, True)
    meta.update(device="cuda", **kw)
    return meta


def test_flash_dispatch_on_cuda_metas():
    """On the card the kernels run or the call raises: the plain version
    never stands in, and bias/segments are refused as not ported."""
    assert KERNELS.dispatch("flash_attention", _cuda_meta())[0] == "cuda"
    with pytest.raises(RuntimeError, match="not ported"):
        KERNELS.dispatch("flash_attention", _cuda_meta(bias=True))
    with pytest.raises(RuntimeError, match="head_dim 160"):
        KERNELS.dispatch("flash_attention",
                         _cuda_meta(unsupported=kfa.flash_unsupported(
                             torch.empty(1, 4, 2, 160),
                             torch.empty(1, 4, 2, 160), True)))
    q, k, _, _ = (_t(a) for a in _qkvd(13, 1, 8, 4, 2, 2, 8))
    assert "sq=8 > sk=4" in kfa.flash_unsupported(q, k, True)
    assert KERNELS.dispatch("flash_attention",
                            tfa.flash_meta(q, k, True))[0] == "unfused"


def test_wrappers_refuse_cpu_tensors():
    q, k, v, do = (_t(a) for a in _qkvd(14, 1, 8, 8, 2, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kfa.flash_fwd_cuda(q, k, v)
    with pytest.raises(NotImplementedError, match="not ported"):
        kfa.flash_attention_cuda(q, k, v, bias=torch.zeros(1, 1, 8, 8))
    p = torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA"):
        kfw.fused_adamw_triton(p, p.clone(), p.clone(), p.clone(), 1e-3, 1)


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
