#!/usr/bin/env python3
"""The bf16 flash kernels beside the designs tried and not kept, on one GPU.

    python3 paddle_tpu_torch/tools/flash_variants.py [VARIANT ...]

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit. Each variant is ``paddle_tpu_torch/csrc/flash_attention.cu``
with a few lines replaced (:data:`PATCHES`), built into a temporary
directory and loaded in place of the built library, so that the wrappers
run it unchanged ("committed" is the source as it is):

- ``running_s``: S = Q K^T summed by the tensor core's running sum over
  the depth steps (``mma2``) instead of each step from zero and added in
  f32 (``mma2_rn``), in all three kernels;
- ``expf``: the forward's exponentials by ``expf`` instead of ``exp_2``;
- ``rows128``: the forward on 128-row query tiles (8 warps, 256 threads,
  one block an SM), launched through a C entry of its own,
  ``flash_attention_fwd128``.

For each variant it prints ptxas's registers and spills of the forward's
instances and, on ``chip_smoke.py``'s bf16 ``FLASH_CASES`` and the first
seven ``FLASH_BODY_CASES``: the forward's worst error against
``flash_fwd_ref`` in units of the two-ulp bound ``chip_smoke.py`` holds
it to (``bf16_close``: 1 is the limit), and, for the ``FLASH_CASES``, dq,
dk and dv against their plain versions from the kernel forward's lse and
delta (as ``flash_phase`` takes them) and dq against an f64 reference on
the first two cases; then the forward's time (``cold_ms``) at the training
shape and on the body cases, with the flag-less kernel on the same inputs.
One JSON object per line; the last is ``{"ok": true}``. It imports nothing
of JAX or of ``paddle_tpu``.
"""
import ctypes
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

_FWD_HEAD = ("template <int D, bool kX>\n__global__ void "
             "__launch_bounds__(kTcThreads, 2)\nfwd_tc_kernel")
_DQ_NOTE = "// dq pass: a block per (query tile"

#: the forward on 128-row query tiles: (old, new) in fwd_tc_kernel's text
_ROWS128 = (
    ("__launch_bounds__(kTcThreads, 2)\nfwd_tc_kernel",
     "__launch_bounds__(256, 1)\nfwd_tc128_kernel"),
    ("constexpr int LD = D + 8, KS = D / 16, NT = D / 8;",
     "constexpr int LD = D + 8, KS = D / 16, NT = D / 8, BQ = 128;"),
    ("const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;",
     "const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;"),
    ("bf16* k_s = q_s + kB * LD;", "bf16* k_s = q_s + BQ * LD;"),
    ("  const int2 qids = seg ? id_range(x.seg_q + (size_t)bi * sq, q0, sq)\n"
     "                        : make_int2(0, 0);",
     "  int2 qids = seg ? id_range(x.seg_q + (size_t)bi * sq, q0, sq)\n"
     "                  : make_int2(0, 0);\n"
     "  if (seg) {\n"
     "    const int2 q2 = id_range(x.seg_q + (size_t)bi * sq, q0 + kB, sq);\n"
     "    qids = make_int2(min(qids.x, q2.x), max(qids.y, q2.y));\n"
     "  }"),
    ("const int nkt = key_tiles(q0, sk, off, causal);",
     "const int nkt = key_tiles(q0 + kB, sk, off, causal);"),
    ("    if (bp) stage_bias<kLdBiasQ>(bias_s + buf * kB * kLdBiasQ, bp, q0, "
     "k0, sq,\n                                 sk);",
     "    if (bp) {\n"
     "      stage_bias<kLdBiasQ>(bias_s + buf * BQ * kLdBiasQ, bp, q0, k0, "
     "sq, sk);\n"
     "      stage_bias<kLdBiasQ>(bias_s + buf * BQ * kLdBiasQ + kB * "
     "kLdBiasQ, bp,\n                           q0 + kB, k0, sq, sk);\n"
     "    }"),
    ("bias_s + (bp ? 2 * kB * kLdBiasQ : 0));",
     "bias_s + (bp ? 2 * BQ * kLdBiasQ : 0));"),
    ("    stage_rows<D>(q_s, q + qhead, qrs, q0, sq, d);\n    stage(kt, 0);",
     "    stage_rows<D>(q_s, q + qhead, qrs, q0, sq, d);\n"
     "    stage_rows<D>(q_s + kB * LD, q + qhead, qrs, q0 + kB, sq, d);\n"
     "    stage(kt, 0);"),
    ("      const float* bt = bias_s + buf * kB * kLdBiasQ +",
     "      const float* bt = bias_s + buf * BQ * kLdBiasQ +"))
_ROWS128_LAUNCH = '''
template <int D, bool kX>
cudaError_t launch_fwd_tc128(const void* q, const void* k, const void* v,
                             void* o, void* lse, int b, int h, int kvh,
                             int sq, int sk, int d, float scale, int causal,
                             const Extras& x, size_t smem,
                             cudaStream_t stream) {
  cudaError_t e = allow_smem(fwd_tc128_kernel<D, kX>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((sq + 127) / 128, b * h);
  fwd_tc128_kernel<D, kX><<<grid, 256, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), h, kvh, sq, sk, d, scale, causal, x);
  return cudaGetLastError();
}
'''
_ROWS128_ENTRY = '''
extern "C" int flash_attention_fwd128(
    const void* q, const void* k, const void* v, const void* bias,
    const void* seg_q, const void* seg_k, void* o, void* lse, int b, int h,
    int kvh, int sq, int sk, int d, int block, int smem, int bias_b,
    int bias_h, const void* seed, float scale, float rate, float inv,
    int causal, int dtype, void* stream) {
  using namespace paddle_tpu_torch::flash;
  // a second Q tile and, with a bias, two more bias tiles
  const size_t want = fwd_tc_smem(tc_dim(d), bias != nullptr,
                                  seg_q != nullptr) + tc_tile(tc_dim(d)) +
                      (bias ? 2 * kB * kLdBiasQ * sizeof(float) : 0);
  const Extras x = make_extras(bias, bias_b, bias_h, seg_q, seg_k, nullptr,
                               seed, rate, inv);
  return TC_DISPATCH(launch_fwd_tc128, d, x, q, k, v, o, lse, b, h, kvh, sq,
                     sk, d, scale, causal, x, want,
                     static_cast<cudaStream_t>(stream));
}
'''


def _rows128(text):
    """The source with fwd_tc128_kernel, its launcher and its C entry
    added (the staging loops stride by the block's threads)."""
    a, b = text.index(_FWD_HEAD), text.index(_DQ_NOTE)
    kernel = text[a:b]
    for old, new in _ROWS128:
        assert kernel.count(old) == 1, old
        kernel = kernel.replace(old, new)
    text = text.replace("i += kTcThreads)", "i += blockDim.x)")
    i = text.index(_DQ_NOTE)
    text = text[:i] + kernel + text[i:]
    i = text.index("template <int D, bool kX>\ncudaError_t launch_dq_tc(")
    text = text[:i] + _ROWS128_LAUNCH + text[i:]
    i = text.index('extern "C" const char* cuda_error_string')
    return text[:i] + _ROWS128_ENTRY + text[i:]


#: variant -> the (old, new) replacements of csrc/flash_attention.cu (each
#: old text once), or a function of the text
PATCHES = {
    "committed": (),
    "running_s": (
        ("        mma2_rn(s[n], s[n + 1], aq, bk);\n"
         "        mma2_rn(dp[n], dp[n + 1], ado, bv);",
         "        mma2(s[n], s[n + 1], aq, bk);\n"
         "        mma2_rn(dp[n], dp[n + 1], ado, bv);"),
        ("        mma2_rn(s[n], s[n + 1], aq, bk);\n      }",
         "        mma2(s[n], s[n + 1], aq, bk);\n      }"),
        ("mma2_rn(s[n], s[n + 1], ak, bq);", "mma2(s[n], s[n + 1], ak, bq);")),
    "expf": (("alpha[i] = exp_2(m[i] - mn);", "alpha[i] = expf(m[i] - mn);"),
             ("? exp_2(s[n][e] - m[i]) : 0.f;", "? expf(s[n][e] - m[i]) : 0.f;")),
    "rows128": _rows128,
}


def patched(name, text):
    """csrc/flash_attention.cu's text under variant ``name``."""
    patch = PATCHES[name]
    if callable(patch):
        return patch(text)
    for old, new in patch:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
    return text


def use(name):
    """Build variant ``name`` in a temporary copy of csrc/ and load it in
    place of the built library; ptxas's lines of its forward instances."""
    from paddle_tpu_torch.ops.kernels import _build
    src = Path(tempfile.mkdtemp()) / "csrc"
    shutil.copytree(ROOT / "paddle_tpu_torch" / "csrc", src)
    cu = src / "flash_attention.cu"
    cu.write_text(patched(name, cu.read_text()))
    _build.CSRC = src
    _build._LIBS.clear()
    _build._FNS.clear()
    _build.build(["flash_attention"])
    _build.load("flash_attention")
    log = _build.library_path("flash_attention").with_suffix(".log")
    return {fn: lines for fn, lines in cs._ptxas(log).items()
            if "fwd_tc" in fn}


def fwd128(q, k, v, causal, scale=None, bias=None, seg_q=None, seg_k=None,
           seed=0, rate=0.0):
    """(o, lse) from the rows128 variant's C entry (the library in use)."""
    import torch
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    fn = _build.load("flash_attention").flash_attention_fwd128
    fn.argtypes = [_build.CTYPES[c] for c in
                   kfa.flash_codes("flash_attention_fwd")]
    fn.restype = ctypes.c_int
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq, device=q.device)
    bb, bhh = (1, 1) if bias is None else tuple(bias.shape[:2])
    # the seed as the kernels read it: an int32 word on the card
    word = kfa.seed_word(seed, q.device) if rate else None
    ptr = [None if t is None else t.data_ptr()
           for t in (q, k, v, bias, seg_q, seg_k, o, lse, word)]
    err = fn(*ptr[:8], b, h, k.shape[2], sq, k.shape[1], d, kfa.BLOCK, 0, bb,
             bhh, ptr[8], 1 / d ** 0.5, rate,
             kfa.dropout_inv(rate) if rate else 1.0,
             int(causal), 1, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd128: error {err}")
    return o, lse


def _units(got, want, floor=0.0):
    """The worst error in units of bf16_close's bound (1 is the limit)."""
    return round(cs.bf16_close(got, want, floor=floor)[1] / 2 ** -6, 4)


def _dq64(q, k, v, do, lse, delta, causal):
    """dq in f64 (S, P, dP, dS), dS rounded to bf16 where the kernels
    round it, per batch element."""
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    out = []
    for i in range(q.shape[0]):
        qi, ki, vi, di = (t[i:i + 1] for t in (q, k, v, do))
        h, d = q.shape[2], q.shape[3]
        kr = kfa._repeat_kv(ki, h).double()
        s = torch.einsum("bqhd,bkhd->bhqk", qi.double(), kr) / d ** 0.5
        sq, sk = s.shape[-2:]
        valid = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
        if causal:
            valid = valid.tril(sk - sq)
        p = torch.where(valid, torch.exp(s - lse[i:i + 1].double()[..., None]),
                        0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", di.double(),
                          kfa._repeat_kv(vi, h).double())
        ds = p * (dp - delta[i:i + 1].double()[..., None]) / d ** 0.5
        out.append(torch.einsum("bhqk,bkhd->bqhd",
                                ds.to(torch.bfloat16).double(), kr))
    return torch.cat(out)


def run(name):
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"variant": name, "ptxas": use(name), "cases": {}, "ms": {}}
    fwd = fwd128 if name == "rows128" else kfa.flash_fwd_cuda
    gen = torch.Generator(device="cuda").manual_seed(6)   # flash_phase's
    for i, (label, b, sq, sk, h, kvh, d, causal, dtn) in enumerate(
            cs.FLASH_CASES):
        dt = getattr(torch, dtn)

        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dt)
        q, k, v, do = rn(b, sq, h, d), rn(b, sk, kvh, d), rn(b, sk, kvh, d), \
            rn(b, sq, h, d)
        if dt != torch.bfloat16:
            continue
        o, lse = fwd(q, k, v, causal)
        case = {"o": _units(o, kfa.flash_fwd_ref(q, k, v, causal)[0])}
        if name != "rows128":
            delta = (o.float() * do.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            bwd = (q, k, v, do, lse, delta, causal)
            floor = 1e-5 * float(do.float().abs().max()
                                 * v.float().abs().max())
            dq = kfa.flash_bwd_dq_cuda(*bwd)
            dk, dv = kfa.flash_bwd_dkv_cuda(*bwd)
            want_dk, want_dv = kfa.flash_bwd_dkv_ref(*bwd)
            case.update(dq=_units(dq, kfa.flash_bwd_dq_ref(*bwd), floor),
                        dk=_units(dk, want_dk, floor),
                        dv=_units(dv, want_dv, floor))
            if i < 2:
                case["dq_vs_f64"] = _units(dq, _dq64(*bwd), floor)
        res["cases"][label] = case
        if label == "train":
            res["ms"]["train"] = cs.cold_ms(lambda: fwd(q, k, v, causal))
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(11)  # the bodies'
    for case in cs.FLASH_BODY_CASES[:7]:
        label, causal = case[0], case[7]
        q, k, v, do, kw = cs._body_inputs(gen, case)
        o, _ = fwd(q, k, v, causal, None, **kw)
        res["cases"][label] = {"o": _units(o, kfa.flash_fwd_ref(
            q, k, v, causal, None, **kw)[0])}
        res["ms"][label] = cs.cold_ms(lambda: fwd(q, k, v, causal, None,
                                                  **kw))
        if label != "causal_sq1024_sk512":
            res["ms"][label + " flag-less"] = cs.cold_ms(
                lambda: fwd(q, k, v, causal))
        del q, k, v, do, kw, o
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


def main():
    names = sys.argv[1:] or list(PATCHES)
    unknown = set(names) - set(PATCHES)
    if unknown:
        raise SystemExit(f"unknown variant(s) {sorted(unknown)}; "
                         f"known: {list(PATCHES)}")
    print(json.dumps({"gpu": cs.gpu_line()}), flush=True)
    for name in names:
        run(name)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
