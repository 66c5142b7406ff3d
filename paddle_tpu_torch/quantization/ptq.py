"""One-shot post-training weight quantization for serving (port of
``paddle_tpu/quantization/ptq.py``).

Decode re-reads every weight on every step, so int8/int4 weights cut the
bytes of the step's largest stream by 2x/4x. The quantized parameter tree
replaces each of the seven per-layer projection weights in
``params["layers"]`` with a leaf dict

    {"qw8": int8 [L, in, out], "scale": f32 [L, out]}          (int8)
    {"qw4": int8 packed,       "scale": f32 [L, out]}          (int4)

with per-layer, per-output-channel f32 scales. int4 packs two values a
byte along the axis every kernel tile covers whole: the contraction axis
of q/k/v/o/gate/up (axis 1 of ``[L, in, out]``) and the output axis of
down_proj (axis 2). Embedding, norms and lm_head stay in the model's
type.

Quantization runs on the tensors' own device (on the card, quantizing
LLaMA-7B takes seconds) one stacked key at a time, so the f32 temporary
is one weight stack (5.8 GB for LLaMA-7B's gate_proj). Its f32 division,
round-half-to-even and the f64 clip search are those of the JAX
package's numpy code, so the two give byte-identical trees.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .quanters import _true_div, pack_int4

__all__ = ["WQ_KEYS", "weight_quant_mode", "normalize_weight_quant",
           "ensure_quantized", "quantize_weights", "quantize_leaf",
           "activation_absmax", "weight_hbm_bytes"]

#: the per-layer projection weights the harness quantizes, with the int4
#: pack axis of each stacked [L, ...] array
WQ_KEYS: Dict[str, int] = {
    "q_proj": 1, "k_proj": 1, "v_proj": 1, "o_proj": 1,
    "gate_proj": 1, "up_proj": 1, "down_proj": 2,
}

#: clip-factor grid of the activation-aware search (1.0 = plain absmax)
_CLIP_GRID = (1.0, 0.95, 0.9, 0.85, 0.8, 0.7)


def normalize_weight_quant(weight_quant) -> Optional[str]:
    """None/False/0 -> None, 8/"int8"/torch.int8 -> "int8", 4/"int4" ->
    "int4": the accepted values of every ``weight_quant=`` argument."""
    if weight_quant in (None, False, 0):
        return None
    if weight_quant in ("int8", 8, torch.int8):
        return "int8"
    if weight_quant in ("int4", 4):
        return "int4"
    raise ValueError(
        f"weight_quant must be None|int8|int4, got {weight_quant!r}")


def weight_quant_mode(params) -> Optional[str]:
    """The mode a parameter tree carries (None | "int8" | "int4"), read
    off its structure."""
    layers = params.get("layers") if isinstance(params, dict) else None
    if not isinstance(layers, dict):
        return None
    for k in WQ_KEYS:
        w = layers.get(k)
        if isinstance(w, dict):
            return "int4" if "qw4" in w else "int8"
    return None


def ensure_quantized(params, weight_quant):
    """The engines' one entry point -> (params, mode). None on a plain
    tree is a no-op; a quantized tree's mode is adopted, and a requested
    mode that differs from it raises. A mode on a plain tree quantizes it
    in one shot (absmax)."""
    mode = normalize_weight_quant(weight_quant)
    carried = weight_quant_mode(params)
    if carried is not None:
        if mode is not None and mode != carried:
            raise ValueError(
                f"params carry {carried} quantized weights but "
                f"weight_quant={mode!r} was requested — requantize "
                "from the original fp tree")
        return params, carried
    if mode is None:
        return params, None
    return quantize_weights(params, bits=8 if mode == "int8" else 4), mode


def _stacked_quantize(v: torch.Tensor, qmax: float, clip=None):
    """Per-(layer, output channel) symmetric quantization of a 2-D or
    leading-stacked f32 array: the absmax over the second-to-last axis,
    shrunk by ``clip`` when given. -> (q int8, scale f32)."""
    absmax = v.abs().amax(dim=-2)
    if clip is not None:
        absmax = absmax * clip
    scale = _true_div(absmax.clamp_min(1e-8), qmax)
    q = torch.round(v / scale[..., None, :]).clamp_(-qmax, qmax)
    return q.to(torch.int8), scale


def _clip_search(v: torch.Tensor, qmax: float, act: torch.Tensor):
    """Per-output-channel clip factor from ``_CLIP_GRID`` minimising the
    activation-weighted quantization error in f64. ``v`` [..., in, out];
    ``act`` [..., in] input-channel absmax. -> the clip array, shaped like
    the scale."""
    a2 = (act.to(torch.float64) ** 2)[..., :, None]
    best_err = None
    best = torch.ones(v.shape[:-2] + v.shape[-1:], dtype=torch.float32,
                      device=v.device)
    for c in _CLIP_GRID:
        q, scale = _stacked_quantize(v, qmax,
                                     clip=torch.full_like(best, c))
        deq = q.to(torch.float64) * scale[..., None, :]
        err = ((v - deq) ** 2 * a2).sum(dim=-2)
        if best_err is None:
            best_err = err
        else:
            win = err < best_err
            best_err = torch.where(win, err, best_err)
            best = torch.where(win, torch.full_like(best, c), best)
    return best


def _leaf(q, scale, bits, pack_axis):
    if bits == 8:
        return {"qw8": q, "scale": scale}
    return {"qw4": pack_int4(q, pack_axis), "scale": scale}


def quantize_leaf(w, bits: int, pack_axis: int = 0) -> Dict:
    """One weight array (``[in, out]`` or stacked ``[L, in, out]``) as a
    quantized leaf dict on its own device: per-output-channel f32 scales;
    int4 packs along ``pack_axis``."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    q, scale = _stacked_quantize(w.float(), 127.0 if bits == 8 else 7.0)
    return _leaf(q, scale, bits, pack_axis)


def quantize_weights(params: Dict, bits: int = 8,
                     act_absmax: Optional[Dict] = None) -> Dict:
    """One-shot PTQ of a LLaMA-style tree -> the quantized tree (module
    docstring), on the weights' device. ``act_absmax``: optional ``{key:
    [L, in] absmax}`` from :func:`activation_absmax`, which turns on the
    clip search for the keys it covers. Deterministic."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if weight_quant_mode(params) is not None:
        raise ValueError("params are already weight-quantized — "
                         "requantize from the original fp tree")
    qmax = 127.0 if bits == 8 else 7.0
    out = dict(params)
    layers = dict(params["layers"])
    for key, pack_axis in WQ_KEYS.items():
        w = layers.get(key)
        if w is None:
            continue
        v = w.float()
        clip = None
        if act_absmax is not None and key in act_absmax:
            clip = _clip_search(v, qmax, act_absmax[key].to(v.device))
        q, scale = _stacked_quantize(v, qmax, clip=clip)
        del v
        layers[key] = _leaf(q, scale, bits, pack_axis)
    out["layers"] = layers
    return out


@torch.no_grad()
def activation_absmax(params: Dict, cfg, prompt) -> Dict:
    """One dense fp forward over ``prompt`` capturing each projection's
    input-channel absmax per layer -> ``{key: [L, in] f32}`` for
    :func:`quantize_weights`' clip search. Runs on the parameters'
    device."""
    from ..ops import rms_norm, swiglu
    from ..ops.rope import apply_rope, build_rope_cache

    dev = params["embed_tokens"].device
    toks = torch.as_tensor(prompt, device=dev).reshape(1, -1).long()
    S = toks.shape[1]
    H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    sin, cos = build_rope_cache(S, hd, base=cfg.rope_theta, device=dev)
    x = params["embed_tokens"][toks]
    keys = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
            "up_proj", "down_proj")
    acc = {k: [] for k in keys}

    def amax(t):
        return t.float().reshape(-1, t.shape[-1]).abs().amax(dim=0)

    for li in range(cfg.num_hidden_layers):
        lp = {k: v[li] for k, v in params["layers"].items()}
        h = rms_norm(x, lp["input_norm"].to(x.dtype), cfg.rms_norm_eps)
        for k in ("q_proj", "k_proj", "v_proj"):
            acc[k].append(amax(h))
        b, s, _ = x.shape
        q = apply_rope((h @ lp["q_proj"]).reshape(b, s, H, hd), sin, cos)
        k_ = apply_rope((h @ lp["k_proj"]).reshape(b, s, KV, hd), sin, cos)
        v_ = (h @ lp["v_proj"]).reshape(b, s, KV, hd)
        rep = H // KV
        kk = k_.repeat_interleave(rep, dim=2).float()
        vv = v_.repeat_interleave(rep, dim=2).float()
        scores = torch.einsum("bshd,bthd->bhst", q.float(), kk) \
            / math.sqrt(hd)
        mask = torch.tril(torch.ones(s, s, dtype=torch.bool, device=dev))
        scores = scores.masked_fill(~mask, float("-inf"))
        attn = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, -1),
                            vv).to(x.dtype).reshape(b, s, H * hd)
        acc["o_proj"].append(amax(attn))
        x = x + attn @ lp["o_proj"]
        h = rms_norm(x, lp["post_norm"].to(x.dtype), cfg.rms_norm_eps)
        acc["gate_proj"].append(amax(h))
        acc["up_proj"].append(amax(h))
        ff = swiglu(h @ lp["gate_proj"], h @ lp["up_proj"])
        acc["down_proj"].append(amax(ff))
        x = x + ff @ lp["down_proj"]
    return {k: torch.stack(v) for k, v in acc.items()}


def weight_hbm_bytes(params: Dict) -> int:
    """Bytes of the per-layer projection weights and their scales: what a
    decode step streams from device memory for them."""
    total = 0
    layers = params.get("layers", {})
    for k in WQ_KEYS:
        w = layers.get(k)
        if w is None:
            continue
        for t in (w.values() if isinstance(w, dict) else (w,)):
            total += t.numel() * t.element_size()
    return total
