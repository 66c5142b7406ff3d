#!/usr/bin/env python3
"""Bit-for-bit check of the port's kernels across two trees on one GPU.

    python3 paddle_tpu_torch/tools/plan_bits.py --root DIR --out FILE.pt
    python3 paddle_tpu_torch/tools/plan_bits.py --compare A.pt B.pt

The first form imports ``paddle_tpu_torch`` from the tree at ``DIR`` (so
the same script drives a checkout of another commit), builds its kernels,
runs every CUDA kernel (and the Triton ones) on inputs made from a fixed
seed at the shapes of ``chip_smoke.py``'s kernel phases (LLaMA-7B widths,
8 slots, a 128-row prefill chunk at position 512; fp, int8 and int4
weights, int8 pools, a tensor-parallel shard's ``residual=False`` bodies;
flash attention (bf16, and f32 cases), the linear CE and the norms at
smaller training shapes) and saves every output on the host; a tree
whose flash kernels take the optional bodies (bias and dbias, segment
ids, dropout, causal sq > sk) adds a case of each. The second form compares two such files
case by case: the number of elements that differ in their bits (cases
only the second file has are listed as new, not failed).
Two trees whose kernels run the same tiles in the same order give 0
everywhere. One JSON object per line; ``--compare`` exits 1 if any case
differs or is missing from the second file, except the cases ``--expect``
names (a change that reorders a kernel's sums on purpose), which may
differ::

    python3 paddle_tpu_torch/tools/plan_bits.py --compare A.pt B.pt \
        --expect "flash_attention_fwd" "flash_attention_fwd[[][!f]*"

(``[[]`` is a literal bracket: every bf16 forward case, not ``[f32]``).
The bf16 backward cases take their lse and delta from the plain forward
(``flash_fwd_ref``), so a change to the forward kernel shows only in the
forward's cases.
Against a tree from before the chunk-row bodies moved to the tensor cores
(PR 14), the bf16 chunk-row MLP and bf16 prefill cases differ, nothing
else::

    --expect "decode_mlp_block[[]*rows*" \
        "prefill_attn_block[[]torch.bfloat16*"

Against a tree from before the split page stream and the weight ring,
the paged case and the bf16-weight decode-block cases differ
(the paged kernel's new reduction order; decode_block_fused's ring body),
nothing else::

    --expect "paged_attention_decode*" \
        "decode_block_fused[[]torch.bfloat16*" "decode_block_fused[[]kv8]"

Against a tree from before the ring carried int8 and int4 codes and the
prefill attention over int8 pools moved to the tensor cores, the
quantized decode-block cases (8 rows, both pool classes) and the kv8
prefill cases differ, nothing else (the cases the parent lacks are
new)::

    --expect "decode_block_fused[[]int*" "prefill_attn_block[[]*kv8*"

Against a tree from before the two-stage kernels took the weight ring
(bf16 at up to 8 rows), decode_mlp_block's bf16 8-row cases differ (every
weight class, the tp=4 partial) and decode_attn_block's over int8 pools
(full width in every weight class, the tp=2 shard), nothing else: its
cases over bf16 pools, the f32 and the chunk-row cases keep their bits
(a tree older than the tool lacks the int8-pool attention cases with
quantized weights and the tp=2 shard's over int8 pools: new there)::

    --expect "decode_mlp_block[[]torch.bfloat16]" \
        "decode_mlp_block[[]int?]" "decode_mlp_block[[]partial*" \
        "decode_attn_block[[]kv8]" "decode_attn_block[[]int?,kv8]" \
        "decode_attn_block[[]partial,tp2,kv8]"

Against a tree from before the linear-CE backward formed P once (a P pass
writing bf16 hi + lo, then dx and dh as products over it), the CE
backward cases differ in both types (new summation orders), nothing
else; the forward keeps its bits::

    --expect "linear_ce_bwd_dx*" "linear_ce_bwd_dh*"

Against a tree from before the bf16 forward moved onto wgmma (each
128 x 256 tile of S reduced to its rows' stats, combined in a fixed
order) and the RMSNorm backward's rows and dw sum were redesigned, the
bf16 forward case differs and the RMSNorm backward case may (its dw's f32
sums run in another order; cast to bf16 they kept every bit on an H100),
nothing else (the backward cases take lse from the plain forward,
``ce_fwd_ref``)::

    --expect "linear_ce_fwd[[]torch.bfloat16]" "rms_norm_bwd"

It imports nothing of JAX or
of ``paddle_tpu``.
"""
import argparse
import inspect
import json
import sys
import time


def _cases(torch, k):
    """(name, thunk) of every kernel call, inputs made from one seed."""
    from paddle_tpu_torch.quantization import quantize_leaf
    fdb, fpb = k.fused_decode_block, k.fused_prefill_block
    gen = torch.Generator(device="cuda").manual_seed(1234)
    bf, f32 = torch.bfloat16, torch.float32
    D, H, hd, F, B, BS, MB = 4096, 32, 128, 11008, 8, 16, 72

    def rn(*shape, dt=bf, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * std).to(dt)

    def lens(B, full):
        rand = torch.randint(2, full, (B - 6,), generator=gen, device="cuda")
        fix = torch.tensor([0, 1, BS - 1, BS, BS + 1, full - 1],
                           device="cuda")
        return torch.cat([fix, rand]).to(torch.int32)

    def decode_args(dt, KV, Hq=H):
        N = B * MB + 1
        perm = torch.randperm(N - 1, generator=gen, device="cuda") + 1
        tables = perm[:B * MB].reshape(B, MB).to(torch.int32).contiguous()
        rope = rn(MB * BS + 1, hd // 2, dt=f32), rn(MB * BS + 1, hd // 2,
                                                    dt=f32)
        return [rn(B, D, dt=dt), (1 + 0.1 * rn(D, dt=f32)).to(dt),
                rn(D, Hq * hd, dt=dt, std=0.02), rn(D, KV * hd, dt=dt,
                                                    std=0.02),
                rn(D, KV * hd, dt=dt, std=0.02),
                rn(Hq * hd, D, dt=dt, std=0.02), *rope,
                rn(N, BS, KV, hd, dt=dt), rn(N, BS, KV, hd, dt=dt), tables,
                lens(B, MB * BS)]

    def kv8(kp, vp):
        ks = (kp.float().abs().amax(dim=(0, 1, 3)) / 127).clamp_min(1e-8)
        vs = (vp.float().abs().amax(dim=(0, 1, 3)) / 127).clamp_min(1e-8)

        def q(t, s):
            return torch.round(t.float() / s[None, None, :, None]).clamp(
                -127, 127).to(torch.int8)
        return q(kp, ks), q(vp, vs), (ks, vs)

    def wq(ws, bits, down=None):
        return [quantize_leaf(w, bits, pack_axis=1 if w is down else 0)
                for w in ws]

    def mlp_w(dt, F, D=D):
        return [rn(D, F, dt=dt, std=0.02), rn(D, F, dt=dt, std=0.02),
                rn(F, D, dt=dt, std=0.02)]

    out = []
    for dt, KV in ((bf, 32), (f32, 8)):
        a = decode_args(dt, KV)
        out.append((f"decode_attn_block[{dt},{KV}]",
                    lambda a=a: fdb.decode_attn_block_cuda(*a)))
        m = mlp_w(dt, F)
        pw = (1 + 0.1 * rn(D, dt=f32)).to(dt)
        out.append((f"decode_block_fused[{dt},{KV}]",
                    lambda a=a, m=m, pw=pw: fdb.decode_block_fused_cuda(
                        *a[:6], pw, *m, *a[6:])))
        out.append((f"decode_mlp_block[{dt}]",
                    lambda a=a, m=m: fdb.decode_mlp_block_cuda(a[0], a[1],
                                                               *m)))
    a = decode_args(bf, 32)
    m = mlp_w(bf, F)
    x128 = rn(128, D)
    out.append(("decode_mlp_block[128 rows]",
                lambda: fdb.decode_mlp_block_cuda(x128, a[1], *m)))
    for bits in (8, 4):
        qa = wq(a[2:6], bits)
        qm = wq(m, bits, down=m[2])
        out.append((f"decode_attn_block[int{bits}]",
                    lambda qa=qa: fdb.decode_attn_block_cuda(
                        a[0], a[1], *qa, *a[6:])))
        out.append((f"decode_mlp_block[int{bits}]",
                    lambda qm=qm: fdb.decode_mlp_block_cuda(a[0], a[1],
                                                            *qm)))
        out.append((f"decode_block_fused[int{bits}]",
                    lambda qa=qa, qm=qm: fdb.decode_block_fused_cuda(
                        a[0], a[1], *qa, a[1], *qm, *a[6:])))
    kq, vq, sc = kv8(a[8], a[9])
    out.append(("decode_attn_block[kv8]", lambda: fdb.decode_attn_block_cuda(
        *a[:8], kq, vq, *a[10:], kv_scales=sc)))
    out.append(("decode_block_fused[kv8]",
                lambda: fdb.decode_block_fused_cuda(
                    *a[:6], a[1], *m, *a[6:8], kq, vq, *a[10:],
                    kv_scales=sc)))
    # int8 and int4 codes over int8 pools (no input drawn: the weights and
    # pools above, quantized)
    for bits in (8, 4):
        qa, qm = wq(a[2:6], bits), wq(m, bits, down=m[2])
        out.append((f"decode_block_fused[int{bits},kv8]",
                    lambda qa=qa, qm=qm: fdb.decode_block_fused_cuda(
                        a[0], a[1], *qa, a[1], *qm, *a[6:8], kq, vq,
                        *a[10:], kv_scales=sc)))
        out.append((f"decode_attn_block[int{bits},kv8]",
                    lambda qa=qa: fdb.decode_attn_block_cuda(
                        a[0], a[1], *qa, *a[6:8], kq, vq, *a[10:],
                        kv_scales=sc)))
    a16 = decode_args(bf, 16, Hq=16)
    out.append(("decode_attn_block[partial,tp2]",
                lambda: fdb.decode_attn_block_cuda(*a16, residual=False)))
    # the same shard over int8 pools (no input drawn; bound now: the
    # names are taken again below)
    out.append(("decode_attn_block[partial,tp2,kv8]",
                lambda q=kv8(a16[8], a16[9]): fdb.decode_attn_block_cuda(
                    *a16[:8], *q[:2], *a16[10:], kv_scales=q[2],
                    residual=False)))
    m2 = mlp_w(bf, F // 4)
    out.append(("decode_mlp_block[partial,tp4]",
                lambda: fdb.decode_mlp_block_cuda(a[0], a[1], *m2,
                                                  residual=False)))
    # prefill: a 128-row chunk at position 512 and a 32-row one at 5
    for dt, P, pos0, nv, bits in ((bf, 128, 512, 128, 0),
                                  (f32, 32, 5, 29, 0), (bf, 128, 512, 128, 4)):
        KV, N = 32, MB + 1
        table = (torch.randperm(N - 1, generator=gen, device="cuda")[:MB]
                 + 1).to(torch.int32)
        ws = [rn(D, H * hd, dt=dt, std=0.02), rn(D, KV * hd, dt=dt,
                                                 std=0.02),
              rn(D, KV * hd, dt=dt, std=0.02), rn(H * hd, D, dt=dt,
                                                  std=0.02)]
        if bits:
            ws = wq(ws, bits)
        args = (rn(P, D, dt=dt), (1 + 0.1 * rn(D, dt=f32)).to(dt), *ws,
                rn(P, hd // 2, dt=f32), rn(P, hd // 2, dt=f32),
                rn(N, BS, KV, hd, dt=dt), rn(N, BS, KV, hd, dt=dt), table,
                pos0, nv)
        out.append((f"prefill_attn_block[{dt},{P},{pos0},w{bits}]",
                    lambda args=args: fpb.prefill_attn_block_cuda(*args)))
    # the chunk-row bodies' classes (the tensor cores in bf16 from PR 14):
    # the MLP at 32 rows and with int8 and int4 weights at 128, and the
    # prefill block at a 32-row chunk, with int8 weights and over int8
    # pools; inputs from a generator of their own
    gc = torch.Generator(device="cuda").manual_seed(97)

    def rc(*shape, std=1.0):
        return (torch.randn(*shape, generator=gc, device="cuda")
                * std).to(bf)
    x32, mc = rc(32, D), [rc(D, F, std=0.02), rc(D, F, std=0.02),
                          rc(F, D, std=0.02)]
    out.append(("decode_mlp_block[32 rows]",
                lambda: fdb.decode_mlp_block_cuda(x32, a[1], *mc)))
    xc = rc(128, D)
    for bits in (8, 4):
        qm = wq(mc, bits, down=mc[2])
        out.append((f"decode_mlp_block[128 rows,int{bits}]",
                    lambda qm=qm: fdb.decode_mlp_block_cuda(xc, a[1], *qm)))
    KV, N = 32, MB + 1
    table = (torch.randperm(N - 1, generator=gc, device="cuda")[:MB]
             + 1).to(torch.int32)
    wc = [rc(D, H * hd, std=0.02), rc(D, KV * hd, std=0.02),
          rc(D, KV * hd, std=0.02), rc(H * hd, D, std=0.02)]
    kpc, vpc = rc(N, BS, KV, hd), rc(N, BS, KV, hd)
    kq8, vq8, sc8 = kv8(kpc, vpc)
    for P, pos0, nv, bits, pools in ((32, 40, 21, 0, False),
                                     (128, 512, 128, 8, False),
                                     (128, 512, 128, 0, True)):
        rope = torch.randn(2, P, hd // 2, generator=gc, device="cuda")
        args = (rc(P, D), (1 + 0.1 * rc(D).float()).to(bf),
                *(wq(wc, bits) if bits else wc), rope[0], rope[1],
                *((kq8, vq8) if pools else (kpc, vpc)), table, pos0, nv)
        kw = {"kv_scales": sc8} if pools else {}
        out.append((f"prefill_attn_block[{bf},{P},{pos0},w{bits}"
                    f"{',kv8' if pools else ''}]",
                    lambda args=args, kw=kw: fpb.prefill_attn_block_cuda(
                        *args, **kw)))
    # a tensor-parallel shard's body over int8 pools (H = KV = 16, no
    # residual), drawn after every case above
    w16 = [rc(D, 16 * hd, std=0.02), rc(D, 16 * hd, std=0.02),
           rc(D, 16 * hd, std=0.02), rc(16 * hd, D, std=0.02)]
    kq16, vq16, sc16 = kv8(rc(N, BS, 16, hd), rc(N, BS, 16, hd))
    rope = torch.randn(2, 128, hd // 2, generator=gc, device="cuda")
    a16p = (rc(128, D), (1 + 0.1 * rc(D).float()).to(bf), *w16, rope[0],
            rope[1], kq16, vq16, table, 512, 128)
    out.append((f"prefill_attn_block[{bf},128,512,w0,kv8,partial,tp2]",
                lambda: fpb.prefill_attn_block_cuda(
                    *a16p, kv_scales=sc16, residual=False)))
    pa = decode_args(bf, 32)
    q = rn(B, H, hd)
    out.append(("paged_attention_decode",
                lambda: k.paged_attention.paged_attention_decode_cuda(
                    q, pa[8], pa[9], pa[10], pa[11] + 1)))
    # training kernels at smaller shapes
    fa = k.flash_attention
    qf, kf, vf = rn(1, 1024, 8, 128), rn(1, 1024, 8, 128), rn(1, 1024, 8,
                                                             128)
    # the bf16 backward cases take lse and delta from the plain forward, so
    # that a change to the forward kernel shows in its own cases only
    o, lse = fa.flash_fwd_ref(qf, kf, vf, True)
    do = rn(1, 1024, 8, 128)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    out.append(("flash_attention_fwd", lambda: fa.flash_fwd_cuda(
        qf, kf, vf, True)))
    out.append(("flash_attention_bwd_dq", lambda: fa.flash_bwd_dq_cuda(
        qf, kf, vf, do, lse, delta, True)))
    out.append(("flash_attention_bwd_dkv", lambda: fa.flash_bwd_dkv_cuda(
        qf, kf, vf, do, lse, delta, True)))
    # the optional bodies (a tree without them has no such cases): a
    # [1, 8] bias with its gradient, segment ids, dropout over GQA 4:1,
    # causal sq 1024 > sk 512; their inputs from a generator of their own,
    # so that every other case's inputs are the parent tree's
    if "rate" in inspect.signature(fa.flash_fwd_cuda).parameters:
        gb = torch.Generator(device="cuda").manual_seed(99)
        seg = (torch.arange(1024, device="cuda") // 300).to(
            torch.int32)[None].contiguous()
        kg = torch.randn(1, 1024, 2, 128, generator=gb, device="cuda").to(bf)
        bias = torch.randn(1, 8, 1024, 1024, generator=gb, device="cuda")
        bodies = {
            "bias": (qf, kf, vf, {"bias": bias}),
            "seg": (qf, kf, vf, {"seg_q": seg, "seg_k": seg}),
            "dropout": (qf, kg, kg, {"seed": 0xDEADBEEF, "rate": 0.1}),
            "causal_sq_gt_sk": (qf, kf[:, :512].contiguous(),
                                vf[:, :512].contiguous(), {})}
        for cls, (qb, kb, vb, kw) in bodies.items():
            ob, lb = fa.flash_fwd_ref(qb, kb, vb, True, None, **kw)
            db = (ob.float() * do.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            grad = cls == "bias"
            out += [
                (f"flash_attention_fwd[{cls}]",
                 lambda a=(qb, kb, vb), kw=kw: fa.flash_fwd_cuda(
                     *a, True, None, **kw)),
                (f"flash_attention_bwd_dq[{cls}]",
                 lambda a=(qb, kb, vb, do, lb, db), kw=kw, g=grad:
                 fa.flash_bwd_dq_cuda(*a, True, None, **kw, bias_grad=g)),
                (f"flash_attention_bwd_dkv[{cls}]",
                 lambda a=(qb, kb, vb, do, lb, db), kw=kw:
                 fa.flash_bwd_dkv_cuda(*a, True, None, **kw))]
    # the f32 passes (the CUDA-core kernels in every tree) at a small
    # shape, inputs from a generator of their own
    g32 = torch.Generator(device="cuda").manual_seed(98)
    q32, k32, v32, do32 = (torch.randn(1, 300, 4, 128, generator=g32,
                                       device="cuda") for _ in range(4))
    o32, lse32 = fa.flash_fwd_cuda(q32, k32, v32, True)
    d32 = (o32 * do32).sum(-1).transpose(1, 2).contiguous()
    a32 = (q32, k32, v32, do32, lse32, d32, True)
    out += [("flash_attention_fwd[f32]",
             lambda: fa.flash_fwd_cuda(q32, k32, v32, True)),
            ("flash_attention_bwd_dq[f32]",
             lambda: fa.flash_bwd_dq_cuda(*a32)),
            ("flash_attention_bwd_dkv[f32]",
             lambda: fa.flash_bwd_dkv_cuda(*a32))]
    ft = k.fused_train
    for dt, T, Dc, V in ((bf, 1024, 1024, 8000), (f32, 256, 512, 1003)):
        x2, head = rn(T, Dc, dt=dt), rn(Dc, V, dt=dt, std=0.02)
        labels = torch.randint(0, V, (T,), generator=gen,
                               device="cuda").to(torch.int64)
        # the backward cases take lse from the plain forward, so that a
        # change to the forward kernel shows in the forward's cases only
        lse_ce, _ = ft.ce_fwd_ref(x2, head, labels)
        coef = torch.full((), 1.0 / T, device="cuda")
        out.append((f"linear_ce_fwd[{dt}]",
                    lambda x2=x2, h=head, lb=labels: ft.linear_ce_fwd_cuda(
                        x2, h, lb)))
        out.append((f"linear_ce_bwd_dx[{dt}]",
                    lambda x2=x2, h=head, lb=labels, ls=lse_ce, c=coef:
                    ft.linear_ce_bwd_dx_cuda(x2, h, lb, ls, c)))
        out.append((f"linear_ce_bwd_dh[{dt}]",
                    lambda x2=x2, h=head, lb=labels, ls=lse_ce, c=coef:
                    ft.linear_ce_bwd_dh_cuda(x2, h, lb, ls, c)))
    nm = k.norms
    xr, wr = rn(4095, 4096), (1 + 0.1 * rn(4096, dt=f32)).to(bf)
    out += [("rms_norm_fwd", lambda: nm.rms_norm_fwd_triton(xr, wr)),
            ("rms_norm_bwd", lambda: nm.rms_norm_bwd_triton(xr, wr, xr)),
            ("residual_rms_norm_fwd",
             lambda: nm.residual_rms_norm_fwd_triton(xr, xr, wr)),
            ("layer_norm_fwd", lambda: nm.layer_norm_fwd_triton(
                xr.float()[:, :1024].contiguous(), wr.float()[:1024],
                wr.float()[:1024]))]
    g, u = rn(1000, 1001), rn(1000, 1001)
    out += [("swiglu_fwd", lambda: ft.swiglu_fwd_triton(g, u)),
            ("swiglu_bwd", lambda: ft.swiglu_bwd_triton(g, u, g))]
    n = 1_000_003
    pm, gm = rn(n, dt=f32), rn(n, dt=f32)

    def adamw():
        p, m1, m2 = pm.clone(), torch.zeros(n, dtype=bf, device="cuda"), \
            torch.zeros(n, dtype=bf, device="cuda")
        return k.fused_adamw.fused_adamw_triton(p, gm, m1, m2, 1e-3, 1,
                                                shadow_dtype=bf)
    out.append(("fused_adamw", adamw))
    return out


def run(root, path):
    sys.path.insert(0, root)
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.ops import kernels as k
    from paddle_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.build(("paged_attention", "fused_decode_block",
                  "fused_prefill_block", "flash_attention", "linear_ce"))
    built = time.perf_counter() - t0
    res = {}
    for name, fn in _cases(torch, k):
        got = fn()
        torch.cuda.synchronize()
        got = got if isinstance(got, (tuple, list)) else (got,)
        res[name] = [t.detach().cpu() for t in got]
    torch.save(res, path)
    print(json.dumps({"root": root, "package": paddle_tpu_torch.__file__,
                      "cases": len(res), "build_s": round(built, 1),
                      "seconds": round(time.perf_counter() - t0, 1)}),
          flush=True)


def compare(a, b, expect=()):
    import fnmatch

    import torch
    ra, rb = torch.load(a), torch.load(b)
    bad = 0
    for name in sorted(set(ra) | set(rb)):
        if name not in ra:
            # a body the first (parent) tree does not have
            print(json.dumps({"case": name, "new": True}))
            continue
        if name not in ra or name not in rb:
            print(json.dumps({"case": name, "missing": True}))
            bad += 1
            continue
        diff = sum(int((x.view(torch.uint8) != y.view(torch.uint8)).sum())
                   if x.shape == y.shape and x.dtype == y.dtype else -1
                   for x, y in zip(ra[name], rb[name]))
        expected = any(fnmatch.fnmatchcase(name, p) for p in expect)
        bad += diff != 0 and not expected
        print(json.dumps({"case": name, "differing_bytes": diff,
                          "elements": sum(x.numel() for x in ra[name]),
                          "expected_to_differ": expected}))
    print(json.dumps({"cases": len(set(ra) | set(rb)), "differ": bad,
                      "ok": bad == 0}))
    return 1 if bad else 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--expect", nargs="*", default=(),
                    help="case names (shell patterns) that may differ")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare, expect=args.expect)
    run(args.root, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
