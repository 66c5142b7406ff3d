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

``generate_paged`` is the JAX package's paged serving loop: a dense
prefill repacked into pools (or, over a persistent ``PagedKVCacheStore``,
a radix prefix match and a suffix-only prefill per sequence), then decode
steps over the pools in chunks of ``_DECODE_CHUNK`` steps
(``_paged_chunk_runner``): on CUDA the step is captured once as a CUDA
graph over the call's fixed buffers and replayed (``_decode_chunks``), on
the CPU it runs eagerly.

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

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import llama as _llama
from ..models.llama import params_to
from ..ops import rms_norm, swiglu
from ..ops.paged_attention import (BlockManager, paged_attention_decode,
                                   paged_attention_decode_quant,
                                   quantize_pools, write_chunk_to_pool,
                                   write_chunk_to_pool_quant, write_to_pool,
                                   write_to_pool_quant)
from ..ops.rope import apply_rope, build_rope_cache
from ..quantization.ptq import ensure_quantized, weight_quant_mode
from ..quantization.quanters import maybe_dequantize

__all__ = ["GenerationConfig", "init_cache", "cached_forward",
           "sample_token", "generate", "generate_paged"]

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
               dtype=None, device=None):
    """The dense (k, v) caches [L, batch, max_len, KV, hd], zeros of
    ``dtype`` (default ``cfg.dtype``), as the JAX package's."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.num_hidden_layers, batch, max_len,
             cfg.num_key_value_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _positions(pos, s, device):
    """Absolute positions pos..pos+s-1 [s]: ``pos`` a host int, or a 0-d
    tensor on ``device`` (a captured program's buffer, read on the device
    with no host sync)."""
    return pos + torch.arange(s, device=device)


def _check_span(pos, s, T):
    """Raise unless positions pos..pos+s-1 fit T; a tensor ``pos`` is the
    caller's to check (it checked the host value it wrote there)."""
    if not torch.is_tensor(pos) and (pos < 0 or pos + s > T):
        raise ValueError(f"tokens at {pos}..{pos + s - 1} do not fit a "
                         f"cache of {T} positions")


def _chunk_attention(h, lp, sin, cos, kc, vc, pos):
    """One layer's attention rows for S new tokens at absolute position
    ``pos`` (a host int or a 0-d tensor), from the normalised rows h [B,
    S, D]: the q/k/v products (their H and KV heads read off the
    products: a tensor-parallel shard's own), RoPE, the tokens' K/V
    written into the dense cache kc/vc [B, T, KV, hd] in place at
    ``pos..pos+S-1``, then causal attention over absolute positions in
    f32: [B, S, H, hd]."""
    b, s, _ = h.shape
    T, hd = kc.shape[1], kc.shape[3]
    q = apply_rope(_mm(h, lp["q_proj"]).reshape(b, s, -1, hd), sin, cos)
    k = apply_rope(_mm(h, lp["k_proj"]).reshape(b, s, -1, hd), sin, cos)
    v = _mm(h, lp["v_proj"]).reshape(b, s, -1, hd)
    rows = _positions(pos, s, h.device)
    kc.index_copy_(1, rows, k.to(kc.dtype))
    vc.index_copy_(1, rows, v.to(vc.dtype))
    rep = q.shape[2] // k.shape[2]
    kk = _repeat_kv(kc, rep)    # [B, T, H, hd]
    vv = _repeat_kv(vc, rep)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kk.float()) * scale
    # query i at pos+i sees keys <= pos+i
    t_idx = torch.arange(T, device=h.device)[None, None, None, :]
    q_idx = rows[None, None, :, None]
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
    """Forward over S tokens starting at absolute position ``pos`` (a host
    int, or a 0-d tensor on the caches' device holding the same value:
    the same results, bit for bit). Writes their K/V into the caches in
    place and returns (logits [B, S, V], k_cache, v_cache)."""
    s = tokens.shape[1]
    T = k_cache.shape[2]
    _check_span(pos, s, T)
    x = params["embed_tokens"][tokens.long()]
    sin_full, cos_full = build_rope_cache(T, cfg.head_dim,
                                          base=cfg.rope_theta,
                                          device=x.device)
    rows = _positions(pos, s, x.device)
    sin, cos = sin_full.index_select(0, rows), cos_full.index_select(0, rows)
    for i in range(cfg.num_hidden_layers):
        x, _, _ = _cached_layer(_layer(params, i), x, sin, cos, cfg,
                                k_cache[i], v_cache[i], pos)
    x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.rms_norm_eps)
    return x @ _head(params), k_cache, v_cache


def _gumbel(shape, generator, device):
    # f32 whatever the default dtype (the program audit's F64_PROMOTION)
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def _filter_logits(logits, gen: GenerationConfig):
    """Temperature-scaled f32 logits [B, V] with the JAX package's top-k
    and top-p filters applied (a filtered logit is -inf): top-k keeps the
    logits at or above the k-th largest, top-p the smallest sorted set
    whose cumulative probability reaches ``top_p`` (the top token
    always)."""
    logits = logits.float() / max(gen.temperature, 1e-6)
    if gen.top_k > 0:
        k = min(int(gen.top_k), logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if gen.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # the first sorted index whose cumulative probability reaches
        # top_p (clamped: a sum that rounds short keeps every token)
        cutoff_idx = torch.sum(cum < gen.top_p, dim=-1).clamp_max(
            logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def sample_token(logits, gen: GenerationConfig,
                 generator: Optional[torch.Generator] = None):
    """[B, V] -> [B] next tokens: greedy (``greedy`` or temperature 0;
    the first maximum, as ``jnp.argmax``), else temperature sampling with
    ``generator`` over the top-k/top-p filtered logits
    (:func:`_filter_logits`). The draw is Gumbel-max (the form of
    ``jax.random.categorical``; the numbers differ from JAX's)."""
    if gen.greedy or gen.temperature == 0.0:
        return torch.argmax(logits.float(), dim=-1)
    logits = _filter_logits(logits, gen)
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
                         device="cuda", wq=None, quant=False, tp=1):
    """The variant one decode step would run, as one string: "cuda_block"
    (the single-launch kernel), "cuda_fused" (the two hand-written
    kernels) or "unfused" (the composition). ``quant``: int8 pools with
    scales (the int8 KV cache); ``tp``: the mesh's (the JAX package's
    attribution of the decode_step timeline events)."""
    if not fused:
        return "unfused"
    from ..ops.kernels.fused_decode_block import (decode_meta,
                                                  resolve_decode_step)
    meta = decode_meta(cfg, B=B, BS=BS, MB=MB, pool_dtype=pool_dtype,
                       quant=quant, tp=tp, weight_dtype=wq, device=device)
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
                           kv_scales=None, bounds=None):
    """One request's prefill chunk through the fused prefill-block ops,
    straight over the pools.

    toks: [P] bucket-padded chunk tokens (``n_valid`` real, host int);
    pools [L, N, BS, KV, hd]; table/wtable [MB] int32: the request's READ
    and WRITE tables; pos0: host int, tokens already in the pools.
    ``bounds``: an int32 [2] tensor on the pools' device holding (pos0,
    n_valid) (a captured chunk's buffer; without one, one is written,
    once for every layer): every position on the device -- the RoPE rows,
    the pool writes, the kernels' bounds -- is read from it, and the host
    ints go only to the kernels' checks and plans. Per
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
    from ..ops.kernels.fused_prefill_block import device_bounds
    x = params["embed_tokens"][toks.long()]              # [P, D]
    if rope is None:
        rope = build_rope_cache(MB * BS, cfg.head_dim, base=cfg.rope_theta,
                                device=x.device)
    if bounds is None:
        bounds = device_bounds(pos0, n_valid, x.device)
    at, nv = bounds[0], bounds[1]
    rows = _positions(at, P, x.device)
    sin, cos = rope[0].index_select(0, rows), rope[1].index_select(0, rows)
    eps = cfg.rms_norm_eps
    for i in range(cfg.num_hidden_layers):
        lp = _layer(params, i)
        kp, vp = k_pools[i], v_pools[i]
        scales = _layer_scales(kv_scales, i)
        x, k_new, v_new = attn_fn(
            x, lp["input_norm"].to(x.dtype), lp["q_proj"], lp["k_proj"],
            lp["v_proj"], lp["o_proj"], sin, cos, kp, vp, table, pos0,
            n_valid, scales, eps, bounds=bounds)
        if scales is None:
            write_chunk_to_pool(kp, vp, wtable, at, nv, k_new, v_new)
        else:
            write_chunk_to_pool_quant(kp, vp, wtable, at, nv, k_new, v_new,
                                      *scales)
        x = mlp_fn(x, lp["post_norm"].to(x.dtype), lp["gate_proj"],
                   lp["up_proj"], lp["down_proj"], eps)
    x = rms_norm(x[None], params["final_norm"].to(x.dtype), eps)[0]
    return x @ _head(params), k_pools, v_pools


# ---------------------------------------------------------------------------
# generate_paged: the paged serving loop
# ---------------------------------------------------------------------------
_PAGED_CACHE: Dict = {}
_FUSED_PREFILL_CACHE: Dict = {}
_TP_PREFILL_CACHE: Dict = {}
# decode steps a runner call takes (the JAX package's default chunk)
_DECODE_CHUNK = 32


def _cache_get(cache: Dict, key):
    """LRU read: re-insert on a hit, so dict order follows recency."""
    hit = cache.get(key)
    if hit is not None:
        del cache[key]
        cache[key] = hit
    return hit


def _cache_put(cache: Dict, key, value):
    if len(cache) > 16:            # evict the least recent runner only
        cache.pop(next(iter(cache)))
    cache[key] = value
    return value


def _mesh_route(sm):
    """The mesh's part of a runner-cache key: axis name, tp degree,
    collective placement and the devices (two meshes over different cards
    must not share a runner)."""
    if sm is None:
        return ()
    return (sm.axis, sm.tp, sm.collective,
            tuple(str(d) for d in sm.devices))


def _route_key(mode):
    """The inputs of dispatch beyond the shapes that a runner's steps
    resolve: the registry's force pins, which "auto" dispatch reads."""
    if mode not in ("auto", True):
        return ()
    from ..ops.kernels.registry import KERNELS
    return KERNELS.forced_state()


def _paged_chunk_runner(cfg, gen, quant=False, fused=False, sm=None,
                        wq=None):
    """The decode step of ``generate_paged``'s loop (the step of the JAX
    package's jitted scan), cached per (cfg values, gen values, int8
    pools, route and its pins, mesh, weight mode) as the JAX
    ``_PAGED_CACHE`` is. It runs ``_fused_decode_step`` (route ``fused``),
    ``_paged_decode_step`` (False) or, under a mesh,
    ``tp._tp_decode_step``, then samples with the call's generator; a
    sequence that drew EOS keeps drawing EOS.

    The runner: ``step(b)``, one decode step over the call's fixed
    buffers ``b`` (:func:`_decode_chunks`): it reads ``b.tok``,
    ``b.seq``, ``b.tables``, the pools, the scales and the RoPE table, and
    writes the next tokens into ``b.tok`` and row ``b.idx`` of ``b.out``,
    ``b.done``, ``b.seq + 1`` and ``b.idx + 1`` in place, the pools in
    place: no host value changes from one step to the next, so the step
    is one capturable program."""
    ck = (dataclasses.astuple(cfg), dataclasses.astuple(gen), bool(quant),
          fused, _route_key(fused), _mesh_route(sm), wq)
    cached = _cache_get(_PAGED_CACHE, ck)
    if cached is not None:
        return cached
    if sm is not None:
        from .tp import _tp_decode_step

        def logits_of(b):
            return _tp_decode_step(b.params, b.tok, cfg, b.k_pools,
                                   b.v_pools, b.tables, b.seq, sm,
                                   rope=b.rope, kv_scales=b.kv_scales,
                                   fused=fused)[0]
    elif fused:
        def logits_of(b):
            return _fused_decode_step(b.params, b.tok, cfg, b.k_pools,
                                      b.v_pools, b.tables, b.seq,
                                      rope=b.rope, mode=fused,
                                      kv_scales=b.kv_scales)[0]
    else:
        def logits_of(b):
            return _paged_decode_step(b.params, b.tok, cfg, b.k_pools,
                                      b.v_pools, b.tables, b.seq,
                                      rope=b.rope, kv_scales=b.kv_scales)[0]

    def step(b):
        nxt = sample_token(logits_of(b), gen, b.generator)
        nxt = torch.where(b.done, gen.eos_token_id, nxt)
        torch.logical_or(b.done, nxt == gen.eos_token_id, out=b.done)
        b.seq.add_(1)
        b.tok.copy_(nxt)
        b.out.index_copy_(0, b.idx, nxt[None])
        b.idx.add_(1)

    return _cache_put(_PAGED_CACHE, ck, step)


def _decode_chunks(step, gen, params, tok, generator, k_pools, v_pools,
                   seq_lens, block_tables, kv_scales, rope, obs=None,
                   variant=None):
    """The first sampled token ``tok`` [B] and ``gen.max_new_tokens - 1``
    more from ``step`` (a :func:`_paged_chunk_runner`), as the JAX loop
    runs its scan, ``_DECODE_CHUNK`` steps a chunk: [B, max_new_tokens].
    The step is one program (:class:`.program.Program`) over fixed
    buffers made here: the tokens, the EOS flags, the lengths, the step
    index and the [N - 1, B] output on the device; the tables, pools,
    scales, RoPE table and generator are the call's. On CUDA the first
    step runs eagerly (the warm-up), the second is captured as one CUDA
    graph (the generator registered) and every step is a replay, with no
    host sync until the caller reads the output; on the CPU each step
    runs eagerly. The pools belong to the call (a store's persist, but
    its tables change per call), so a capture serves one call. ``obs``:
    an observability harness, which gets each chunk's host dispatch time
    (``decode_step_ms`` a step, a ``decode_step`` event a chunk, stamped
    ``variant``)."""
    from types import SimpleNamespace
    from .program import Program
    left = gen.max_new_tokens - 1
    if left <= 0:
        return tok[:, None]
    dev = tok.device
    b = SimpleNamespace(
        params=params, k_pools=k_pools, v_pools=v_pools,
        tables=block_tables, kv_scales=kv_scales, rope=rope,
        generator=generator, tok=tok.clone(),
        done=tok == gen.eos_token_id, seq=seq_lens.clone(),
        idx=torch.zeros((1,), dtype=torch.long, device=dev),
        out=torch.empty((left, tok.shape[0]), dtype=tok.dtype, device=dev))
    cuda = dev.type == "cuda"
    prog = Program(lambda: step(b), dev,
                   torch.cuda.Stream(dev) if cuda else None,
                   generator if cuda else None)
    while left > 0:
        n = min(_DECODE_CHUNK, left)
        t0 = time.perf_counter() if obs is not None else 0.0
        for _ in range(n):
            prog.prepare()
            prog()
        if obs is not None:
            dur = (time.perf_counter() - t0) * 1e3
            obs.hist("decode_step_ms").observe(dur / n)
            obs.timeline.record("decode_step", dur_ms=dur,
                                live_slots=int(tok.shape[0]),
                                tokens=int(n * tok.shape[0]),
                                decode_variant=variant)
        left -= n
    return torch.cat([tok[:, None], b.out.T], dim=1)


def _suffix_prefill_runner(cfg, P, MB, mode):
    """The prefix-store path's fused suffix prefill: one sequence's
    un-cached suffix of exactly ``P`` tokens through
    :func:`_fused_prefill_forward`, pool-direct (the warm prefix pages are
    its paged history), cached per (cfg values, P, table width, mode,
    pins) as the JAX runner is. The chunk goes in padded to the prefill
    kernel's 16-row query blocks (``n_valid = P``: the pad rows' K/V go
    to scratch page 0), so ``MB`` must cover ``pos0`` plus the padded
    width. ``run(params, toks [P], pos0, table [MB], k_pools, v_pools,
    wtable [MB], rope) -> logits [V]`` of the last suffix token."""
    from ..ops.kernels.fused_prefill_block import BQ
    ck = (dataclasses.astuple(cfg), P, MB, mode, _route_key(mode))
    cached = _cache_get(_FUSED_PREFILL_CACHE, ck)
    if cached is not None:
        return cached
    P_pad = -(-P // BQ) * BQ

    def run(params, toks, pos0, table, k_pools, v_pools, wtable, rope=None):
        dev = k_pools.device
        padded = torch.zeros(P_pad, dtype=torch.long, device=dev)
        padded[:P] = toks
        logits, _, _ = _fused_prefill_forward(
            params, padded, cfg, k_pools, v_pools, table, wtable, pos0, P,
            rope=rope, mode=mode)
        return logits[P - 1]

    return _cache_put(_FUSED_PREFILL_CACHE, ck, run)


def _tp_prefill_runner(cfg, sm, B, S, T):
    """The tensor-parallel dense prefill of ``generate_paged``: each
    shard's own dense cache [L, B, T, KV_loc, hd] built on its device and
    ``tp._tp_cached_forward`` over them, cached per (cfg values, geometry,
    mesh) as the JAX runner is. ``run(shards, ids) -> (logits [B, S, V],
    k_caches, v_caches)``."""
    ck = (dataclasses.astuple(cfg), B, S, T, _mesh_route(sm))
    cached = _cache_get(_TP_PREFILL_CACHE, ck)
    if cached is not None:
        return cached
    from .tp import _tp_cached_forward
    L, hd = cfg.num_hidden_layers, cfg.head_dim
    KV_loc = cfg.num_key_value_heads // sm.tp

    def run(shards, ids):
        shape = (L, B, T, KV_loc, hd)
        kcs, vcs = ([torch.zeros(shape, dtype=cfg.dtype, device=d)
                     for d in sm.devices] for _ in range(2))
        return _tp_cached_forward(shards, ids, cfg, kcs, vcs, 0, sm)

    return _cache_put(_TP_PREFILL_CACHE, ck, run)


def _scatter_prefill_pages(kp, vp, wtable, kc, vc):
    """One sequence's dense prefill view [L, 1, MB*BS, KV, hd] back into
    the pools [L, N, BS, KV, hd] through its WRITE table [MB], in place
    (shared entries are page 0: those duplicate writes land on the scratch
    page, which nothing reads)."""
    L, _, BS, KV, hd = kp.shape
    MB = wtable.shape[0]
    kp[:, wtable] = kc.reshape(L, MB, BS, KV, hd).to(kp.dtype)
    vp[:, wtable] = vc.reshape(L, MB, BS, KV, hd).to(vp.dtype)
    return kp, vp


def _quantize_layer_pools(k_pools, v_pools):
    """[L, N, BS, KV, hd] pools -> int8 pools and their (k_scale [L, KV],
    v_scale [L, KV]): :func:`quantize_pools` a layer (the JAX package
    vmaps it over the layers)."""
    per = [quantize_pools(k_pools[i], v_pools[i])
           for i in range(k_pools.shape[0])]
    return tuple(torch.stack([p[j] for p in per]) for j in range(4))


_FP_CACHE_DTYPES = (None, "bfloat16", "float32", torch.bfloat16,
                    torch.float32)


def generate_paged(params: Dict, input_ids, cfg: _llama.LlamaConfig,
                   gen: Optional[GenerationConfig] = None,
                   block_size: int = 16, seed: int = 0, cache_dtype=None,
                   prefix_cache=None, observability=None,
                   fused_decode=None, mesh=None, fused_prefill=None,
                   weight_quant=None, device=None) -> torch.Tensor:
    """vLLM-style serving loop over a paged KV cache (the JAX package's
    ``generate_paged``). input_ids [B, S] -> [B, S + N].

    The prompts prefill through the dense cache (``cached_forward``), the
    dense cache is repacked into pools of ``block_size``-token pages (every
    sequence's whole generation allocated up front by a ``BlockManager``),
    then the decode steps run over the pools in chunks of
    ``_DECODE_CHUNK`` (:func:`_paged_chunk_runner`): on CUDA one captured
    CUDA graph replayed a step (:func:`_decode_chunks`).

    ``cache_dtype="int8"``: the pools quantize after the prefill with
    static per-layer, per-head scales from their absmax (the port's
    ``quantize_pools``), and decode reads int8 pages.
    ``prefix_cache``: a :class:`~.prefix_cache.PagedKVCacheStore` whose
    pools and radix tree outlive the call: each prompt longest-prefix
    matches the store and prefills only its un-cached suffix (fused
    through :func:`_fused_prefill_forward` where ``fused_prefill``
    dispatches both prefill ops to the CUDA kernels, else the dense chunk
    over a gathered view), the shared pages never written; finished
    sequences are indexed back into the tree. fp caches only (int8 is
    refused, as in the JAX package); not under a mesh.
    ``fused_decode``: the decode route, as the engine's (None/True/"auto"
    the registry's pick, "pallas"/"block" the CUDA kernels, "ref" the
    composition, False the unfused step). ``mesh``: a ``ServingMesh`` (or
    an int tp): the prefill and the decode steps run tensor-parallel over
    the head axis (``inference/tp.py``), pools per shard; on CUDA its
    shards must share one card (the step is one CUDA graph).
    ``weight_quant``: "int8"/"int4" quantizes a plain tree once on the
    way in (a quantized tree rides as-is); not with a mesh, as in the JAX
    package. ``observability``: True or an ``Observability`` harness,
    which gets host-side phase times (each prefill's dispatch, each decode
    chunk's) and pool gauges in its timeline and histograms: no added
    sync, the same output. ``device``: None is CUDA (a mesh's shard 0, a
    store's device), ``"cpu"`` the plain versions; ``params`` move
    there."""
    from .tp import normalize_mesh
    gen = gen or GenerationConfig()
    if observability is True:      # mirror ServingEngine's normalization
        from ..observability import Observability
        observability = Observability()
    fused = _fused_mode(fused_decode)
    sm = normalize_mesh(mesh)
    if sm is not None:
        home = sm.devices[0]
    elif prefix_cache is not None:
        home = prefix_cache.device
    else:
        home = resolve_device(device)
    if device is not None and resolve_device(device) != home:
        raise ValueError(f"generate_paged(device={device!r}) is not the "
                         f"mesh's or the store's device {home}")
    params, wq_mode = ensure_quantized(params_to(params, home), weight_quant)
    if wq_mode is not None and sm is not None:
        raise ValueError(
            "generate_paged(weight_quant=...) does not take a mesh: "
            "sharding quantized weight trees (packed int4 + per-channel"
            " scales) over tp > 1 is named headroom — run quantized "
            "serving single-device, or use ServingEngine with tp=1 "
            "groups")
    if sm is not None:
        ok, reason = sm.supports(cfg)
        if not ok:
            raise ValueError(f"generate_paged(mesh=...): {reason}")
        if home.type == "cuda" and len(set(sm.devices)) > 1:
            raise ValueError(
                f"generate_paged(mesh=...): shards on "
                f"{len(set(sm.devices))} devices; the decode step is one "
                "CUDA graph, which runs on one card: colocate the shards "
                "on one device")
        if prefix_cache is not None:
            raise NotImplementedError(
                "generate_paged(prefix_cache=...) does not take a mesh:"
                " the persistent store owns single-device pools that "
                "outlive the call. Use ServingEngine(mesh=..., "
                "prefix_cache=True) for sharded prefix sharing")
    if cache_dtype not in _FP_CACHE_DTYPES + ("int8", torch.int8):
        raise ValueError(f"cache_dtype must be bfloat16|float32|int8, "
                         f"got {cache_dtype!r}")
    if prefix_cache is not None:
        return _generate_paged_prefix(
            params, input_ids, cfg, gen, block_size, seed, cache_dtype,
            prefix_cache, observability, fused=fused,
            fused_prefill=_fused_prefill_mode(fused_prefill), wq=wq_mode)
    obs = observability or None
    ids = torch.as_tensor(np.asarray(input_ids), device=home).long()
    B, S = ids.shape
    T = S + gen.max_new_tokens
    if T > cfg.max_position_embeddings:
        raise ValueError(
            f"prompt+max_new_tokens = {T} exceeds max_position_embeddings "
            f"= {cfg.max_position_embeddings} (rope table bound)")
    L, hd = cfg.num_hidden_layers, cfg.head_dim
    BS = block_size
    MB = -(-T // BS)
    num_blocks = B * MB + 1

    # prefill with the dense cache, then repack into pools
    t0 = time.perf_counter() if obs is not None else 0.0
    if sm is None:
        k_cache, v_cache = init_cache(cfg, B, T, device=home)
        logits, k_cache, v_cache = cached_forward(params, ids, cfg, k_cache,
                                                  v_cache, 0)
        kcs, vcs = [k_cache], [v_cache]
    else:
        params = sm.shard(params, sm.param_specs(cfg, params))
        logits, kcs, vcs = _tp_prefill_runner(cfg, sm, B, S, T)(params, ids)
    if obs is not None:
        # host dispatch time (the card completes it behind; waiting here
        # would add a sync)
        dur = (time.perf_counter() - t0) * 1e3
        obs.hist("prefill_chunk_ms").observe(dur)
        obs.timeline.record("prefill_chunk", dur_ms=dur, pos0=0,
                            n=int(B * S), bucket=int(S))

    mgr = BlockManager(num_blocks, BS, MB)
    for sid in range(B):
        # the whole generation up front: the steps' tables stay fixed
        mgr.allocate(sid, T)
    tables = mgr.table_array(range(B))
    flat = torch.as_tensor(tables.reshape(-1), device=home).long()
    pad = MB * BS - T
    k_pools, v_pools = [], []
    for kc, vc in zip(kcs, vcs):
        KVl, dev = kc.shape[3], kc.device
        for dense, pools in ((kc, k_pools), (vc, v_pools)):
            pool = torch.zeros((L, num_blocks, BS, KVl, hd),
                               dtype=dense.dtype, device=dev)
            dense = torch.nn.functional.pad(dense, (0, 0, 0, 0, 0, pad))
            pool[:, flat.to(dev)] = dense.reshape(L, B * MB, BS, KVl, hd)
            pools.append(pool)

    kv_scales = None
    if cache_dtype in ("int8", torch.int8):
        # static per-layer, per-head scales from the prefill KV; each
        # shard quantizes its own heads (the same scales: a head lies in
        # one shard)
        shard_scales = []
        for i in range(len(k_pools)):
            k_pools[i], v_pools[i], ks, vs = _quantize_layer_pools(
                k_pools[i], v_pools[i])
            shard_scales.append((ks, vs))
        kv_scales = shard_scales if sm is not None else shard_scales[0]
    if sm is None:
        k_pools, v_pools = k_pools[0], v_pools[0]

    chunk_fn = _paged_chunk_runner(cfg, gen, quant=kv_scales is not None,
                                   fused=fused, sm=sm, wq=wq_mode)
    rope = build_rope_cache(cfg.max_position_embeddings, hd,
                            base=cfg.rope_theta, device=home)
    generator = torch.Generator(device=home).manual_seed(int(seed))
    dv = None
    if obs is not None:
        free = len(mgr.free)
        obs.sample_gauges(time.perf_counter(), {
            "pages_free": free, "pages_in_use": num_blocks - free})
        dv = _decode_variant_name(
            cfg, B, BS, MB, k_pools[0].dtype if sm is not None
            else k_pools.dtype, fused, device=home.type, wq=wq_mode,
            quant=kv_scales is not None,
            tp=(sm.tp if sm is not None else 1))
    out = _decode_chunks(
        chunk_fn, gen, params, sample_token(logits[:, -1], gen, generator),
        generator, k_pools, v_pools,
        torch.full((B,), S, dtype=torch.int32, device=home),
        torch.as_tensor(tables, device=home), kv_scales, rope, obs=obs,
        variant=dv)
    return torch.cat([ids, out], dim=1)


def _generate_paged_prefix(params, input_ids, cfg, gen, block_size, seed,
                           cache_dtype, store, observability=None,
                           fused=False, fused_prefill=False, wq=None):
    """``generate_paged`` over a persistent ``PagedKVCacheStore``.

    Admission longest-prefix-matches each prompt against the store's radix
    tree (full pages shared in place, the partial tail as a COW fork) and
    prefills only the un-cached suffix, one sequence at a time (each has
    its own start position): pool-direct through the fused prefill ops
    where ``fused_prefill`` selects both CUDA kernels, else the dense
    chunk over the sequence's gathered pages scattered back through a
    WRITE table whose shared entries are page 0, so shared pages are never
    written. Decode runs the cold path's chunk runner; finished sequences
    are indexed back into the tree (cut at the first EOS) and released."""
    from ..ops.kernels.fused_prefill_block import (BQ, prefill_fused_selected,
                                                   prefill_meta)
    if cache_dtype not in _FP_CACHE_DTYPES:
        raise ValueError(
            "generate_paged(prefix_cache=...) supports bf16/f32 caches "
            f"only, got cache_dtype={cache_dtype!r}: the int8 path "
            "recalibrates per call, which cannot share pages that "
            "outlive the call (use ServingEngine's static-scale int8)")
    if int(block_size) != store.block_size:
        raise ValueError(
            f"block_size {block_size} != prefix store block_size "
            f"{store.block_size}")
    dev = store.device
    prompts = np.asarray(input_ids, np.int32)
    B, S = prompts.shape
    T = S + gen.max_new_tokens
    if T > cfg.max_position_embeddings:
        raise ValueError(
            f"prompt+max_new_tokens = {T} exceeds max_position_embeddings "
            f"= {cfg.max_position_embeddings} (rope table bound)")
    L, KV, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                 cfg.head_dim)
    BS = store.block_size
    MB = -(-T // BS)
    # the fused suffix's table: wide enough for pos0 plus the padded chunk
    MBw = -(-(T + BQ) // BS)
    mgr, cache = store.mgr, store.cache

    seq_ids, matched_ns, shared_ns = [], [], []
    tables = np.zeros((B, MB), np.int32)
    for b in range(B):
        sid = store.next_seq_id
        store.next_seq_id += 1
        got = cache.acquire(prompts[b], S - 1, MB)
        if got is None:
            for done_sid in seq_ids:
                mgr.release(done_sid)
            raise RuntimeError(
                f"prefix store pool exhausted: batch needs up to "
                f"{B * MB} pages, store has {store.num_blocks - 1}")
        pages, matched, shared = got
        mgr.attach(sid, pages, owned=True)
        t = mgr.allocate(sid, T)
        tables[b, :len(t)] = t
        seq_ids.append(sid)
        matched_ns.append(matched)
        shared_ns.append(shared)

    obs = observability or None
    if obs is not None:
        obs.sample_gauges(time.perf_counter(), {
            "pages_free": len(mgr.free),
            "pages_in_use": store.num_blocks - len(mgr.free),
            "prefix_tree_pages": cache.cached_pages})
    rope = build_rope_cache(max(MBw * BS, cfg.max_position_embeddings), hd,
                            base=cfg.rope_theta, device=dev)
    ids = torch.as_tensor(prompts, device=dev).long()
    logits_last = []
    for b in range(B):
        M = matched_ns[b]
        wt = tables[b].copy()
        wt[:shared_ns[b]] = 0              # never write a shared page
        t0 = time.perf_counter() if obs is not None else 0.0
        P = S - M
        use_fused = bool(fused_prefill) and prefill_fused_selected(
            prefill_meta(cfg, -(-P // BQ) * BQ, BS, MBw,
                         store.k_pools.dtype, False, weight_dtype=wq,
                         device=dev), fused_prefill)
        if use_fused:
            wide = np.zeros((2, MBw), np.int32)
            wide[0, :MB], wide[1, :MB] = tables[b], wt
            wide = torch.as_tensor(wide, device=dev)
            run = _suffix_prefill_runner(cfg, P, MBw, fused_prefill)
            logits_last.append(run(params, ids[b, M:], M, wide[0],
                                   store.k_pools, store.v_pools, wide[1],
                                   rope)[None])
        else:
            tb = torch.as_tensor(tables[b], device=dev).long()
            kc = store.k_pools[:, tb].reshape(L, 1, MB * BS, KV, hd)
            vc = store.v_pools[:, tb].reshape(L, 1, MB * BS, KV, hd)
            lg, kc, vc = cached_forward(params, ids[b:b + 1, M:], cfg, kc,
                                        vc, M)
            _scatter_prefill_pages(store.k_pools, store.v_pools,
                                   torch.as_tensor(wt, device=dev).long(),
                                   kc, vc)
            logits_last.append(lg[:, -1])
        if obs is not None:
            dur = (time.perf_counter() - t0) * 1e3
            obs.hist("prefill_chunk_ms").observe(dur)
            obs.timeline.record("prefill_chunk", req_id=seq_ids[b],
                                dur_ms=dur, pos0=M, n=int(S - M),
                                matched_tokens=M,
                                variant=("cuda_fused" if use_fused
                                         else "ref"))

    generator = torch.Generator(device=dev).manual_seed(int(seed))
    dv = (_decode_variant_name(cfg, B, BS, MB, store.k_pools.dtype, fused,
                               device=dev.type, wq=wq)
          if obs is not None else None)
    out = _decode_chunks(
        _paged_chunk_runner(cfg, gen, quant=False, fused=fused, wq=wq),
        gen, params,
        sample_token(torch.cat(logits_last, dim=0), gen, generator),
        generator, store.k_pools, store.v_pools,
        torch.full((B,), S, dtype=torch.int32, device=dev),
        torch.as_tensor(tables, device=dev), None, rope, obs=obs,
        variant=dv)                                             # [B, N]

    out_np = out.cpu().numpy()
    for b in range(B):
        # KV is valid for prompt + N-1 generated tokens (the last one's
        # KV was never written); forced-EOS padding after the first EOS
        # is not traffic, so the index stops there
        valid = gen.max_new_tokens - 1
        if gen.eos_token_id >= 0:
            hits = np.nonzero(out_np[b] == gen.eos_token_id)[0]
            if hits.size:
                valid = min(valid, int(hits[0]) + 1)
        seq = np.concatenate([prompts[b], out_np[b, :valid]])
        cache.insert(seq, list(mgr.tables.get(seq_ids[b], ())))
        mgr.release(seq_ids[b])
    return torch.cat([ids, out], dim=1)
