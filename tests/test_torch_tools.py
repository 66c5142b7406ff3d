"""PyTorch/CUDA port, the measurement scripts of ``paddle_tpu_torch/tools``
on the CPU: ``cuda_phase_times.py`` binds the fused decode and prefill
launchers with the codes their ``extern "C"`` declarations take, in the
committed sources and in each instrumented copy it builds (the gate's
ARG_MISMATCH check, applied to the tool), and its ``use`` hands the copies
to the wrappers through ``_build.c_fn``; ``plan_bits.py``'s compare;
``flash_variants.py``'s and ``chunk_variants.py``'s patches apply to the
committed sources."""
import ctypes
import importlib.util
from pathlib import Path

import pytest

from paddle_tpu_torch.analysis import kernel_rules
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import fused_decode_block as fdb

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    path = ROOT / "paddle_tpu_torch" / "tools" / "cuda_phase_times.py"
    spec = importlib.util.spec_from_file_location("cuda_phase_times", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_times_bindings_match_every_copy():
    tool = _tool()
    src = (_build.CSRC / "fused_decode_block.cu").read_text()
    declared = kernel_rules.c_launchers(fdb._SOURCE)
    copies = tool.variants(src)
    assert set(copies) == {"lb1", "lb2", "lb1_stamped", "lb2_stamped"}
    for name in tool.LAUNCHERS:
        assert fdb.CALLS[name] == declared[name], name
        for label, text in copies.items():
            assert kernel_rules.launchers_in(text)[name] == \
                fdb.CALLS[name], (label, name)
    assert "read_stamps" in kernel_rules.launchers_in(
        copies["lb1_stamped"])
    assert "__launch_bounds__(kThreads, 2)\ndecode_block_fused_kernel" \
        in copies["lb2"]


def test_phase_times_use_rebinds_through_c_fn(monkeypatch):
    """``use`` puts a copy in the built library's place and forgets the
    old bindings and grids, so ``_build.c_fn`` binds the copy's launchers
    with ``CALLS``' codes."""
    tool = _tool()

    class Fn:
        pass

    class Lib:
        cuda_error_string = Fn()

    lib = Lib()
    for name in tool.LAUNCHERS:
        setattr(lib, name, Fn())
    monkeypatch.setattr(_build, "_LIBS", {"fused_decode_block": object()})
    monkeypatch.setattr(_build, "_FNS", {("fused_decode_block", "x", ()):
                                         object(), ("flash_attention", "y",
                                                    ()): object()})
    monkeypatch.setattr(fdb, "_GRIDS", {"cached": 264})
    tool.use(fdb, lib)
    assert _build._LIBS["fused_decode_block"] is lib
    assert list(_build._FNS) == [("flash_attention", "y", ())]
    assert fdb._GRIDS == {}
    for name in tool.LAUNCHERS:
        fn = _build.c_fn("fused_decode_block", name, fdb.CALLS[name])
        assert fn is getattr(lib, name)
        assert fn.argtypes == [_build.CTYPES[c] for c in fdb.CALLS[name]]
        assert fn.restype is ctypes.c_int


def _plan_bits():
    path = ROOT / "paddle_tpu_torch" / "tools" / "plan_bits.py"
    spec = importlib.util.spec_from_file_location("plan_bits", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plan_bits_compare_lets_only_expected_cases_differ(tmp_path):
    """``--compare`` fails on any case whose bits differ, except those
    ``--expect`` names (shell patterns): a redesigned kernel's cases."""
    import torch
    tool = _plan_bits()
    base = {"flash_attention_bwd_dq": [torch.ones(4)],
            "flash_attention_bwd_dq[seg]": [torch.ones(2)],
            "rms_norm_fwd": [torch.zeros(3)]}
    moved = dict(base, **{"flash_attention_bwd_dq": [torch.full((4,), 2.)],
                          "flash_attention_bwd_dq[seg]": [torch.zeros(2)]})
    paths = {}
    for label, res in (("a", base), ("b", moved),
                       ("c", dict(moved, rms_norm_fwd=[torch.ones(3)]))):
        paths[label] = str(tmp_path / f"{label}.pt")
        torch.save(res, paths[label])
    expect = ("flash_attention_bwd_dq*",)
    assert tool.compare(paths["a"], paths["a"]) == 0
    assert tool.compare(paths["a"], paths["b"]) == 1
    assert tool.compare(paths["a"], paths["b"], expect=expect) == 0
    assert tool.compare(paths["a"], paths["c"], expect=expect) == 1


def test_plan_bits_forward_patterns_spare_the_f32_case(tmp_path):
    """The forward's ``--expect`` patterns (``[[]`` a literal bracket)
    let every bf16 forward case differ and hold ``[f32]`` and the
    backward cases to their bits."""
    import torch
    tool = _plan_bits()
    names = ("flash_attention_fwd", "flash_attention_fwd[bias]",
             "flash_attention_fwd[causal_sq_gt_sk]",
             "flash_attention_fwd[f32]", "flash_attention_bwd_dq[f32]",
             "flash_attention_bwd_dq")
    base = {n: [torch.zeros(2)] for n in names}
    expect = ("flash_attention_fwd", "flash_attention_fwd[[][!f]*")
    for name in names:
        a, b = str(tmp_path / "a.pt"), str(tmp_path / f"{name}.pt")
        torch.save(base, a)
        torch.save(dict(base, **{name: [torch.ones(2)]}), b)
        bf16_fwd = name.startswith("flash_attention_fwd") and "f32" not in name
        assert tool.compare(a, b, expect=expect) == (0 if bf16_fwd else 1), \
            name


def _flash_variants():
    path = ROOT / "paddle_tpu_torch" / "tools" / "flash_variants.py"
    spec = importlib.util.spec_from_file_location("flash_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flash_variants_patch_the_committed_source():
    """Every design ``flash_variants.py`` builds applies to the committed
    source: ``running_s`` sums S by the running sum in all three kernels,
    ``expf`` takes the forward's two exponentials back to expf, and
    ``rows128`` adds a 128-row forward whose C entry takes the launcher's
    argument codes."""
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    tool = _flash_variants()
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert src.count("mma2_rn(s[n], s[n + 1]") == 3
    assert tool.patched("committed", src) == src
    running = tool.patched("running_s", src)
    assert running.count("mma2_rn(s[n], s[n + 1]") == 0
    assert running.count("mma2(s[n], s[n + 1]") == 3
    assert tool.patched("expf", src).count("exp_2(") == src.count("exp_2(") - 2
    rows = tool.patched("rows128", src)
    assert "fwd_tc128_kernel<D, kX><<<grid, 256, smem, stream>>>" in rows
    launchers = kernel_rules.launchers_in(rows)
    assert launchers["flash_attention_fwd128"] == \
        launchers["flash_attention_fwd"] == kfa.flash_codes(
            "flash_attention_fwd")


def test_phase_times_prefill_copies_bind_like_the_sources():
    """The prefill part's copies of ``fused_prefill_block.cu`` and
    ``fused_decode_block.cu`` keep every launcher's ``extern "C"`` codes,
    the stamped ones stamp every cooperative kernel (both bodies of the
    two chunk kernels) and export ``read_stamps``; stamped phases take the
    names of the body that ran."""
    from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
    tool = _tool()
    psrc = (_build.CSRC / "fused_prefill_block.cu").read_text()
    dsrc = (_build.CSRC / "fused_decode_block.cu").read_text()
    copies = tool.prefill_variants(psrc, dsrc)
    assert set(copies) == {"prefill", "prefill_stamped", "decode",
                           "decode_stamped"}
    for label, text in copies.items():
        launchers = kernel_rules.launchers_in(text)
        if label.startswith("prefill"):
            assert launchers["prefill_attn_block"] == fpb.CALL[1]
        else:
            for name in tool.LAUNCHERS:
                assert launchers[name] == fdb.CALLS[name], (label, name)
        assert ("read_stamps" in launchers) == label.endswith("stamped")
    # a stamp at the kernel's start, after every grid barrier of both
    # bodies, and one after a last barrier at its end
    text = copies["prefill_stamped"]
    assert text.count("g_stamps[g_n++]") == psrc.count("grid.sync();") + 2
    assert tool.named("decode_mlp_block", [1.0, 2.0, 3.0, 4.0]) == {
        "norm": 1.0, "gate_up": 2.0, "down": 3.0, "combine": 4.0}
    assert tool.named("prefill_attn_block", [1.0] * 4) == {
        "qkv_with_norm": 1.0, "rope": 1.0, "attention": 1.0, "o_proj": 1.0}


def _chunk_variants():
    path = ROOT / "paddle_tpu_torch" / "tools" / "chunk_variants.py"
    spec = importlib.util.spec_from_file_location("chunk_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chunk_variants_patch_the_committed_sources():
    """Every design ``chunk_variants.py`` builds applies to the committed
    sources, and the plan constants it sets are the wrappers' own names,
    so a variant's plan matches its kernels."""
    from paddle_tpu_torch.ops.kernels import fused_prefill_block as fpb
    tool = _chunk_variants()
    mods = {"fdb": fdb, "fpb": fpb}
    for name, (patches, consts) in tool.PATCHES.items():
        for f in {f for f, _, _ in patches}:
            text = (_build.CSRC / f).read_text()
            assert tool.patched(name, f, text) != text, (name, f)
        for key in consts:
            mod, attr = key.split(".")
            assert hasattr(mods[mod], attr), (name, key)
    assert tool.PATCHES["committed"] == ((), {})
