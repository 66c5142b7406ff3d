"""PyTorch/CUDA port, op level: paddle_tpu_torch.ops against the JAX
package on the CPU (the port with device="cpu", where each kernel wrapper
runs its plain PyTorch version; JAX on its own CPU composition). Inputs
come from seeded numpy and go to both as arrays."""
import os
import stat

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu import ops as jops
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import rope as jrope
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import rope as trope
from paddle_tpu_torch.ops.kernels import (_build, paged_attention_decode_cuda,
                                          rms_norm_fwd_triton)

pytestmark = pytest.mark.torch_port


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    want = np.asarray(jops.rms_norm_ref(jnp.asarray(x), jnp.asarray(w),
                                        1e-6))
    got = tops.rms_norm(_t(x), _t(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_rms_norm_ref_rounds_before_the_weight():
    """bf16: the normalised row is cast to x's type BEFORE the weight
    multiply (the JAX rounding order), so scaling by a weight of ones is
    exactly the cast row."""
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    xb = x.to(torch.bfloat16)
    ones = torch.ones(32, dtype=torch.bfloat16)
    ms = xb.float().square().mean(-1, keepdim=True)
    want = (xb.float() * torch.rsqrt(ms + 1e-6)).to(torch.bfloat16)
    assert torch.equal(tops.rms_norm_ref(xb, ones), want)


@pytest.mark.parametrize("T,hd", [(128, 16), (64, 128)])
def test_rope_cache_matches_jax(T, hd):
    js, jc = jrope.build_rope_cache(T, hd)
    ts, tc = trope.build_rope_cache(T, hd)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)


@pytest.mark.parametrize("with_ids", [False, True])
def test_apply_rope_matches_jax(with_ids):
    """Neox rope with rows 0..seq-1 of the table, or rows picked per
    token by position_ids."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 4, 16).astype(np.float32)
    pos = np.array([[5, 9, 0], [31, 2, 7]], np.int32)
    js, jc = jrope.build_rope_cache(32, 16)
    ts, tc = trope.build_rope_cache(32, 16)
    if with_ids:
        want = jrope.apply_rope(jnp.asarray(x), js, jc, jnp.asarray(pos))
        got = trope.apply_rope(_t(x), ts, tc, _t(pos))
    else:
        want = jrope.apply_rope(jnp.asarray(x), js[:3], jc[:3])
        got = trope.apply_rope(_t(x), ts[:3], tc[:3])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-6)


def _paged_case(seq_lens, B=4, H=8, KV=2, hd=16, BS=16, seed=2):
    rng = np.random.RandomState(seed)
    MB = -(-max(seq_lens) // BS)
    N = B * MB + 1
    table = (rng.permutation(N - 1)[:B * MB] + 1).reshape(B, MB)
    return (rng.randn(B, H, hd).astype(np.float32),
            rng.randn(N, BS, KV, hd).astype(np.float32),
            rng.randn(N, BS, KV, hd).astype(np.float32),
            table.astype(np.int32), np.asarray(seq_lens, np.int32))


def test_paged_attention_matches_xla():
    """GQA (H=8 over KV=2), a permuted table, lengths across page
    boundaries and a length-0 slot, against paged_attention_decode_xla
    (the JAX engine's own CPU path; not the interpret-mode Pallas
    kernel)."""
    args = _paged_case([1, 37, 0, 128])
    want = np.asarray(jpa.paged_attention_decode_xla(
        *[jnp.asarray(a) for a in args]))
    got = tpa.paged_attention_decode(*[_t(a) for a in args])
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert np.all(got.numpy()[2] == 0.0)


def test_write_to_pool_matches_jax():
    rng = np.random.RandomState(3)
    kp = rng.randn(9, 4, 2, 8).astype(np.float32)
    vp = rng.randn(9, 4, 2, 8).astype(np.float32)
    tables = np.array([[3, 5, 0], [0, 0, 0], [7, 1, 2]], np.int32)
    seq = np.array([6, 0, 9], np.int32)
    k_new = rng.randn(3, 2, 8).astype(np.float32)
    v_new = rng.randn(3, 2, 8).astype(np.float32)
    jk, jv = jpa.write_to_pool(*[jnp.asarray(a) for a in
                                 (kp, vp, tables, seq, k_new, v_new)])
    tk, tv = _t(kp), _t(vp)
    out = tpa.write_to_pool(tk, tv, _t(tables), _t(seq), _t(k_new),
                            _t(v_new))
    assert out[0] is tk and out[1] is tv            # updated in place
    assert tk.numpy().tobytes() == np.asarray(jk).tobytes()
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()


def test_block_manager_matches_jax():
    """The same allocate/attach/release sequence leaves both managers in
    the same state, and both checks agree."""
    mgrs = [jpa.BlockManager(12, 4, 5), tpa.BlockManager(12, 4, 5)]
    for m in mgrs:
        m.allocate(-1, 1)
        m.allocate(0, 9)
        m.allocate(1, 5)
        m.attach(2, m.tables[0][:2])
        m.allocate(2, 13)
        m.release(0)
        m.allocate(1, 9)
        assert m.check() == []
    j, t = mgrs
    assert j.free == t.free and j.tables == t.tables
    np.testing.assert_array_equal(j.refcount, t.refcount)
    for m in mgrs:
        m.refcount[t.tables[1][0]] = 0
        assert len(m.check(raise_on_violation=False)) == 2
        with pytest.raises(RuntimeError, match="check failed"):
            m.check()


def test_kernel_wrappers_refuse_non_cuda_tensors():
    """No silent fallback: the kernel wrappers take CUDA tensors only,
    and the dispatchers send anything that is not on the CPU to them."""
    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rms_norm_fwd_triton(x, torch.ones(8))
    args = [_t(a) for a in _paged_case([1, 5, 0, 3])]
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_decode_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        tops.rms_norm(x.to("meta"), torch.ones(8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention_decode(*[a.to("meta") for a in args])


def test_kernel_build_failure_raises_with_nvcc_output(tmp_path,
                                                      monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'paged_attention.cu(1): error: "
                    "boom' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="error: boom"):
        _build.load("paged_attention")
    lib_dir = _build.library_path("paged_attention").parent
    assert not any(p.suffix == ".so" for p in lib_dir.iterdir())
    assert os.path.basename(str(lib_dir)) == _build._digest()
