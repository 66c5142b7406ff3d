"""Autoregressive generation with a KV cache (port of
``paddle_tpu/inference/generation.py``, serving side, unfused route).

PyTorch runs eagerly, so what the JAX package wrote as jitted programs and
``lax.scan`` loops are plain Python loops over the layers here. The
caches are updated in place where the JAX package returned new arrays:
``cached_forward`` writes the new tokens' K/V into the caches it is given,
and ``_paged_decode_step`` writes the new token's K/V into the pools.

Dense cache layout: [L, B, T_max, KV, hd]. Paged pools: [L, N, BS, KV, hd].

Two paged decode steps share one signature: ``_paged_decode_step`` (the
unfused route: RMSNorm, projections, RoPE, pool write, paged attention,
o_proj, SwiGLU MLP, op by op) and ``_fused_decode_step`` (the JAX engine's
default route: per layer one ``decode_block_fused``, or one
``decode_attn_block`` and one ``decode_mlp_block``, with the pool write
after the attention, each resolved through the kernel registry).
``_fused_prefill_forward`` is the JAX engine's default prefill chunk: per
layer one ``prefill_attn_block``, the chunk's pool write, one
``prefill_mlp_block``, straight over the pools.

Every function takes a weight-quantized tree (:mod:`..quantization`) as
well as a plain one: the unfused products (``_mm``) dequantize each leaf
first, and the fused steps hand the leaves to the kernels, which stream
the integers and scale in their epilogue.

The paged steps and the fused chunk also take int8 pools with their
static per-layer, per-head scales, ``kv_scales = (k_scale [L, KV],
v_scale [L, KV])`` (the int8 KV cache): the pool writes quantize
(``write_to_pool_quant``, ``write_chunk_to_pool_quant``), the unfused
step's attention dequantizes after the gather
(``paged_attention_decode_quant``) and the kernels read int8 pages, as in
the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import llama as _llama
from ..ops import rms_norm, swiglu
from ..ops.paged_attention import (paged_attention_decode,
                                   paged_attention_decode_quant,
                                   write_chunk_to_pool,
                                   write_chunk_to_pool_quant, write_to_pool,
                                   write_to_pool_quant)
from ..ops.rope import apply_rope, build_rope_cache
from ..quantization.ptq import weight_quant_mode
from ..quantization.quanters import maybe_dequantize

__all__ = ["GenerationConfig", "init_cache", "cached_forward",
           "sample_token", "generate"]

_FUSED_MODES = ("auto", "pallas", "ref", "block")
_FUSED_PREFILL_MODES = ("auto", "pallas", "ref")


@dataclass
class GenerationConfig:
    """Sampling and scheduling knobs of a request (the JAX package's
    fields). ``priority``/``deadline_s`` are ServingEngine.submit()
    defaults; lower priority = more urgent, ``deadline_s`` bounds queue
    wait."""

    max_new_tokens: int = 64
    temperature: float = 1.0
    top_k: int = 0            # 0 = disabled
    top_p: float = 1.0        # 1.0 = disabled
    eos_token_id: int = -1    # -1 = never stop early
    greedy: bool = False
    priority: int = 1
    deadline_s: Optional[float] = None


def _mm(h, w):
    """``h @ w``, where ``w`` may be a quantized leaf (``{"qw8"|"qw4": q,
    "scale": s}``): dequantize-then-matmul in h's type, the one product of
    every unfused site, as in the JAX package."""
    return h @ maybe_dequantize(w, h.dtype)


def _wq_mode(params):
    """The weight-quant mode a tree carries (None/"int8"/"int4"), read off
    its structure: the dispatch metas' ``weight_dtype``."""
    return weight_quant_mode(params)


def _repeat_kv(x, n):
    """[B, T, KV, hd] -> [B, T, KV*n, hd] (dense-cache GQA expansion)."""
    if n == 1:
        return x
    b, t, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, t, kv, n, hd).reshape(
        b, t, kv * n, hd)


def _layer(params, i):
    """Layer ``i``'s weights as views into the stacked ``layers`` dict (a
    quantized leaf's integers and scales alike)."""
    return {k: ({n: t[i] for n, t in w.items()} if isinstance(w, dict)
                else w[i]) for k, w in params["layers"].items()}


def _head(params):
    head = params.get("lm_head")
    return params["embed_tokens"].T if head is None else head


def init_cache(cfg: _llama.LlamaConfig, batch: int, max_len: int,
               device=None):
    device = resolve_device(device)
    shape = (cfg.num_hidden_layers, batch, max_len,
             cfg.num_key_value_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def _chunk_attention(h, lp, sin, cos, kc, vc, pos):
    """One layer's attention rows for S new tokens at absolute position
    ``pos``, from the normalised rows h [B, S, D]: the q/k/v products
    (their H and KV heads read off the products: a tensor-parallel
    shard's own), RoPE, the tokens' K/V written into the dense cache
    kc/vc [B, T, KV, hd] in place at ``pos..pos+S-1``, then causal
    attention over absolute positions in f32: [B, S, H, hd]."""
    b, s, _ = h.shape
    T, hd = kc.shape[1], kc.shape[3]
    q = apply_rope(_mm(h, lp["q_proj"]).reshape(b, s, -1, hd), sin, cos)
    k = apply_rope(_mm(h, lp["k_proj"]).reshape(b, s, -1, hd), sin, cos)
    v = _mm(h, lp["v_proj"]).reshape(b, s, -1, hd)
    kc[:, pos:pos + s] = k.to(kc.dtype)
    vc[:, pos:pos + s] = v.to(vc.dtype)
    rep = q.shape[2] // k.shape[2]
    kk = _repeat_kv(kc, rep)    # [B, T, H, hd]
    vv = _repeat_kv(vc, rep)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kk.float()) * scale
    # query i at pos+i sees keys <= pos+i
    t_idx = torch.arange(T, device=h.device)[None, None, None, :]
    q_idx = pos + torch.arange(s, device=h.device)[None, None, :, None]
    scores = scores.masked_fill(t_idx > q_idx, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, vv.float())


def _cached_layer(lp, x, sin, cos, cfg, kc, vc, pos):
    """Decoder block over S new tokens at absolute position ``pos``.
    kc/vc: [B, T, KV, hd], written in place at ``pos..pos+S-1``."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["input_norm"].to(x.dtype), cfg.rms_norm_eps)
    attn = _chunk_attention(h, lp, sin, cos, kc, vc, pos)
    x = x + _mm(attn.to(x.dtype).reshape(b, s, -1), lp["o_proj"])
    h = rms_norm(x, lp["post_norm"].to(x.dtype), cfg.rms_norm_eps)
    ff = swiglu(_mm(h, lp["gate_proj"]), _mm(h, lp["up_proj"]))
    x = x + _mm(ff, lp["down_proj"])
    return x, kc, vc


def cached_forward(params: Dict, tokens, cfg: _llama.LlamaConfig,
                   k_cache, v_cache, pos: int):
    """Forward over S tokens starting at absolute position ``pos``.
    Writes their K/V into the caches in place and returns (logits
    [B, S, V], k_cache, v_cache)."""
    s = tokens.shape[1]
    T = k_cache.shape[2]
    if pos < 0 or pos + s > T:
        raise ValueError(f"tokens at {pos}..{pos + s - 1} do not fit a "
                         f"cache of {T} positions")
    x = params["embed_tokens"][tokens.long()]
    sin_full, cos_full = build_rope_cache(T, cfg.head_dim,
                                          base=cfg.rope_theta,
                                          device=x.device)
    sin, cos = sin_full[pos:pos + s], cos_full[pos:pos + s]
    for i in range(cfg.num_hidden_layers):
        x, _, _ = _cached_layer(_layer(params, i), x, sin, cos, cfg,
                                k_cache[i], v_cache[i], pos)
    x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.rms_norm_eps)
    return x @ _head(params), k_cache, v_cache


def _gumbel(shape, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def sample_token(logits, gen: GenerationConfig,
                 generator: Optional[torch.Generator] = None):
    """[B, V] -> [B] next tokens: greedy (``greedy`` or temperature 0;
    the first maximum, as ``jnp.argmax``) or temperature sampling with
    ``generator`` (Gumbel-max, the form of ``jax.random.categorical``;
    the numbers differ from JAX's). Top-k/top-p come with a later
    slice."""
    logits = logits.float()
    if gen.greedy or gen.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if gen.top_k > 0 or gen.top_p < 1.0:
        raise NotImplementedError("top-k/top-p sampling is not ported yet")
    logits = logits / max(gen.temperature, 1e-6)
    return torch.argmax(
        logits + _gumbel(logits.shape, generator, logits.device), dim=-1)


def generate(params: Dict, input_ids, cfg: _llama.LlamaConfig,
             gen: Optional[GenerationConfig] = None, seed: int = 0,
             device=None) -> torch.Tensor:
    """Dense-cache generation. input_ids [B, S_in] -> [B, S_in + N].

    Prefill, then N-1 single-token steps over a dense [L, B, S_in+N, KV,
    hd] cache: the same math as the JAX ``generate``, and the in-port
    oracle the paged serving engine is held against. ``params`` must lie
    on ``device``."""
    gen = gen or GenerationConfig()
    device = resolve_device(device)
    ids = torch.as_tensor(np.asarray(input_ids), device=device).long()
    B, S = ids.shape
    N = gen.max_new_tokens
    generator = torch.Generator(device=device).manual_seed(int(seed))
    k_cache, v_cache = init_cache(cfg, B, S + N, device=device)
    logits, _, _ = cached_forward(params, ids, cfg, k_cache, v_cache, 0)
    tok = sample_token(logits[:, -1], gen, generator)
    done = tok == gen.eos_token_id
    out = [tok]
    for i in range(N - 1):
        logits, _, _ = cached_forward(params, tok[:, None], cfg, k_cache,
                                      v_cache, S + i)
        nxt = sample_token(logits[:, -1], gen, generator)
        nxt = torch.where(done, gen.eos_token_id, nxt)
        done = done | (nxt == gen.eos_token_id)
        out.append(nxt)
        tok = nxt
    return torch.cat([ids, torch.stack(out, dim=1)], dim=1)


def _layer_scales(kv_scales, i):
    """Layer ``i``'s (k_scale [KV], v_scale [KV]), or None for fp pools."""
    return None if kv_scales is None else (kv_scales[0][i], kv_scales[1][i])


def _write_new_token(kp, vp, block_tables, seq_lens, k_new, v_new, scales):
    """The new token's K/V [B, KV, hd] into one layer's pools at
    ``seq_lens``, in place: cast to the pools' type, or over int8 pools
    quantized with the layer's (k_scale, v_scale)."""
    if scales is None:
        write_to_pool(kp, vp, block_tables, seq_lens, k_new.to(kp.dtype),
                      v_new.to(vp.dtype))
    else:
        write_to_pool_quant(kp, vp, block_tables, seq_lens, k_new, v_new,
                            *scales)


def _decode_attention(h, lp, sin, cos, kp, vp, block_tables, seq_lens,
                      attn_lens, scales):
    """One layer's attention rows of the unfused decode step, from the
    normalised rows h [B, D]: the q/k/v products (their H and KV heads
    read off the products: a tensor-parallel shard's own), RoPE at
    ``seq_lens``, the new token's pool write, paged attention over
    ``attn_lens`` (seq_lens + 1) tokens, dequantizing over int8 pools
    (``scales``). Returns [B, H, hd]."""
    B, hd = h.shape[0], kp.shape[3]
    pos_ids = seq_lens[:, None]       # [B, 1] rope position per sequence
    q = apply_rope(_mm(h, lp["q_proj"]).reshape(B, 1, -1, hd), sin, cos,
                   position_ids=pos_ids)
    k = apply_rope(_mm(h, lp["k_proj"]).reshape(B, 1, -1, hd), sin, cos,
                   position_ids=pos_ids)
    v = _mm(h, lp["v_proj"]).reshape(B, 1, -1, hd)
    _write_new_token(kp, vp, block_tables, seq_lens, k[:, 0], v[:, 0],
                     scales)
    if scales is None:
        return paged_attention_decode(q[:, 0], kp, vp, block_tables,
                                      attn_lens)
    return paged_attention_decode_quant(q[:, 0], kp, vp, block_tables,
                                        attn_lens, *scales)


def _paged_decode_step(params, tok, cfg, k_pools, v_pools, block_tables,
                       seq_lens, rope=None, kv_scales=None):
    """One decode token per sequence over paged pools.

    tok: [B] current tokens; k_pools/v_pools: [L, N, BS, KV, hd];
    block_tables: [B, MB] int32; seq_lens: [B] int32 lengths BEFORE the
    current token (the new token is written at seq_lens, rope takes
    position seq_lens, and attention runs over seq_lens+1 tokens).
    ``rope``: a (sin, cos) table of ``cfg.max_position_embeddings`` rows
    to reuse across steps; built here when None. ``kv_scales``: (k_scale
    [L, KV], v_scale [L, KV]) f32 when the pools are int8 (the int8 KV
    cache: quantizing write, attention dequantized in f32).
    Returns (logits [B, V], k_pools, v_pools), pools updated in place.
    """
    B = tok.shape[0]
    x = params["embed_tokens"][tok.long()]               # [B, D]
    if rope is None:
        rope = build_rope_cache(cfg.max_position_embeddings, cfg.head_dim,
                                base=cfg.rope_theta, device=x.device)
    sin, cos = rope
    attn_lens = seq_lens + 1
    for i in range(cfg.num_hidden_layers):
        lp = _layer(params, i)
        h = rms_norm(x[:, None], lp["input_norm"].to(x.dtype),
                     cfg.rms_norm_eps)[:, 0]
        attn = _decode_attention(h, lp, sin, cos, k_pools[i], v_pools[i],
                                 block_tables, seq_lens, attn_lens,
                                 _layer_scales(kv_scales, i))
        x = x + _mm(attn.reshape(B, -1).to(x.dtype), lp["o_proj"])
        h = rms_norm(x[:, None], lp["post_norm"].to(x.dtype),
                     cfg.rms_norm_eps)[:, 0]
        ff = swiglu(_mm(h, lp["gate_proj"]), _mm(h, lp["up_proj"]))
        x = x + _mm(ff, lp["down_proj"])
    x = rms_norm(x[:, None], params["final_norm"].to(x.dtype),
                 cfg.rms_norm_eps)[:, 0]
    return x @ _head(params), k_pools, v_pools


def _fused_mode(fused_decode):
    """Normalise a ``fused_decode`` knob to the JAX engine's values: None
    and True -> "auto" (the JAX flag's default; the port has no flag),
    False -> False, "auto"/"pallas"/"ref"/"block" as given. "pallas"
    forces the hand-written CUDA kernels (the name is the JAX engine's,
    so one keyword drives both engines)."""
    if fused_decode is None or fused_decode is True:
        return "auto"
    if fused_decode is False:
        return False
    if fused_decode in _FUSED_MODES:
        return fused_decode
    raise ValueError(f"fused_decode must be bool|auto|pallas|ref|block, "
                     f"got {fused_decode!r}")


def _fused_decode_step(params, tok, cfg, k_pools, v_pools, block_tables,
                       seq_lens, rope=None, mode="auto", kv_scales=None):
    """``_paged_decode_step`` through the fused decode-block kernels.

    Per layer either one ``decode_block_fused`` launch (the whole layer:
    RMSNorm + QKV + RoPE + paged attention with the new token + o_proj +
    residual + RMSNorm + SwiGLU + residual), then the new token's pool
    write; or the two-stage route: one ``decode_attn_block``, the pool
    write, one ``decode_mlp_block``. Which one, and each op's variant
    (the hand-written CUDA kernels on CUDA tensors, the unfused
    composition on the CPU, bit-identical to ``_paged_decode_step``),
    comes from the kernel registry; ``mode`` forwards to
    :func:`paddle_tpu_torch.ops.kernels.fused_decode_block.resolve_decode_step`.
    Signature, carried state (``kv_scales`` included) and in-place pool
    update match ``_paged_decode_step``."""
    from ..ops.kernels.fused_decode_block import (decode_meta,
                                                  resolve_decode_step)
    B = tok.shape[0]
    meta = decode_meta(cfg, B=B, BS=k_pools.shape[2],
                       MB=block_tables.shape[1], pool_dtype=k_pools.dtype,
                       quant=kv_scales is not None,
                       weight_dtype=_wq_mode(params), device=k_pools.device)
    block_fn, attn_fn, mlp_fn, _ = resolve_decode_step(meta, mode)
    x = params["embed_tokens"][tok.long()]               # [B, D]
    if rope is None:
        rope = build_rope_cache(cfg.max_position_embeddings, cfg.head_dim,
                                base=cfg.rope_theta, device=x.device)
    sin, cos = rope
    eps = cfg.rms_norm_eps
    for i in range(cfg.num_hidden_layers):
        lp = _layer(params, i)
        kp, vp = k_pools[i], v_pools[i]
        scales = _layer_scales(kv_scales, i)
        if block_fn is not None:
            # one launch per layer; the pool write stays with the caller
            # (the MLP half reads no pool state, so writing after it is
            # the same math as between the stages)
            x, k_new, v_new = block_fn(
                x, lp["input_norm"].to(x.dtype), lp["q_proj"],
                lp["k_proj"], lp["v_proj"], lp["o_proj"],
                lp["post_norm"].to(x.dtype), lp["gate_proj"],
                lp["up_proj"], lp["down_proj"], sin, cos, kp, vp,
                block_tables, seq_lens, scales, eps)
        else:
            x, k_new, v_new = attn_fn(
                x, lp["input_norm"].to(x.dtype), lp["q_proj"],
                lp["k_proj"], lp["v_proj"], lp["o_proj"], sin, cos, kp,
                vp, block_tables, seq_lens, scales, eps)
        _write_new_token(kp, vp, block_tables, seq_lens, k_new, v_new,
                         scales)
        if block_fn is None:
            x = mlp_fn(x, lp["post_norm"].to(x.dtype), lp["gate_proj"],
                       lp["up_proj"], lp["down_proj"], eps)
    x = rms_norm(x[:, None], params["final_norm"].to(x.dtype), eps)[:, 0]
    return x @ _head(params), k_pools, v_pools


def _decode_variant_name(cfg, B, BS, MB, pool_dtype, fused,
                         device="cuda", wq=None, quant=False):
    """The variant one decode step would run, as one string: "cuda_block"
    (the single-launch kernel), "cuda_fused" (the two hand-written
    kernels) or "unfused" (the composition). ``quant``: int8 pools with
    scales (the int8 KV cache)."""
    if not fused:
        return "unfused"
    from ..ops.kernels.fused_decode_block import (decode_meta,
                                                  resolve_decode_step)
    meta = decode_meta(cfg, B=B, BS=BS, MB=MB, pool_dtype=pool_dtype,
                       quant=quant, weight_dtype=wq, device=device)
    block_fn, _, _, names = resolve_decode_step(meta, fused)
    return names["block"] if block_fn is not None else names["attn"]


def _fused_prefill_mode(fused_prefill):
    """Normalise a ``fused_prefill`` knob to the JAX engine's values: None
    and True -> "auto" (the JAX flag's default; the port has no flag),
    False -> False, "auto"/"pallas"/"ref" as given. "pallas" forces the
    hand-written CUDA kernels."""
    if fused_prefill is None or fused_prefill is True:
        return "auto"
    if fused_prefill is False:
        return False
    if fused_prefill in _FUSED_PREFILL_MODES:
        return fused_prefill
    raise ValueError(f"fused_prefill must be bool|auto|pallas|ref, got "
                     f"{fused_prefill!r}")


def _fused_prefill_forward(params, toks, cfg, k_pools, v_pools, table,
                           wtable, pos0, n_valid, rope=None, mode="auto",
                           kv_scales=None):
    """One request's prefill chunk through the fused prefill-block ops,
    straight over the pools.

    toks: [P] bucket-padded chunk tokens (``n_valid`` real, host int);
    pools [L, N, BS, KV, hd]; table/wtable [MB] int32: the request's READ
    and WRITE tables; pos0: host int, tokens already in the pools. Per
    layer: one ``prefill_attn_block`` (RMSNorm + QKV + RoPE + attention
    over the paged history and the chunk + o_proj + residual), the
    chunk's own K/V written into the pools in place through the write
    table (:func:`write_chunk_to_pool`, pad rows to scratch page 0; over
    int8 pools with ``kv_scales`` the quantizing
    :func:`write_chunk_to_pool_quant`), one ``prefill_mlp_block``. Each op's variant comes from the kernel
    registry; ``mode`` forwards to
    :func:`paddle_tpu_torch.ops.kernels.fused_prefill_block.resolve_prefill_blocks`.
    ``rope``: a (sin, cos) table of at least pos0 + P rows; built here with
    MB*BS rows when None. Returns (logits [P, V], k_pools, v_pools).
    Callers guard with ``prefill_fused_selected``: unless both ops resolve
    to the CUDA kernels they run the verbatim unfused chunk."""
    from ..ops.kernels.fused_prefill_block import (prefill_meta,
                                                   resolve_prefill_blocks)
    P = toks.shape[0]
    BS, MB = k_pools.shape[2], table.shape[0]
    meta = prefill_meta(cfg, P, BS, MB, k_pools.dtype,
                        quant=kv_scales is not None,
                        weight_dtype=_wq_mode(params), device=k_pools.device)
    attn_fn, mlp_fn, _ = resolve_prefill_blocks(meta, mode)
    x = params["embed_tokens"][toks.long()]              # [P, D]
    if rope is None:
        rope = build_rope_cache(MB * BS, cfg.head_dim, base=cfg.rope_theta,
                                device=x.device)
    sin, cos = rope[0][pos0:pos0 + P], rope[1][pos0:pos0 + P]
    eps = cfg.rms_norm_eps
    for i in range(cfg.num_hidden_layers):
        lp = _layer(params, i)
        kp, vp = k_pools[i], v_pools[i]
        scales = _layer_scales(kv_scales, i)
        x, k_new, v_new = attn_fn(
            x, lp["input_norm"].to(x.dtype), lp["q_proj"], lp["k_proj"],
            lp["v_proj"], lp["o_proj"], sin, cos, kp, vp, table, pos0,
            n_valid, scales, eps)
        if scales is None:
            write_chunk_to_pool(kp, vp, wtable, pos0, n_valid, k_new, v_new)
        else:
            write_chunk_to_pool_quant(kp, vp, wtable, pos0, n_valid, k_new,
                                      v_new, *scales)
        x = mlp_fn(x, lp["post_norm"].to(x.dtype), lp["gate_proj"],
                   lp["up_proj"], lp["down_proj"], eps)
    x = rms_norm(x[None], params["final_norm"].to(x.dtype), eps)[0]
    return x @ _head(params), k_pools, v_pools
