"""The decode step's roofline model on one NVIDIA H100 (port of the
per-decode-variant half of ``paddle_tpu/observability/roofline.py``).

:func:`decode_step_bytes` models the device-memory bytes one decode step
of each of the port's routes moves, closed form from the engine's static
dims; :func:`decode_roofline` turns them into the least step time the
card's memory rate allows and, given a measured step time, the achieved
share of that rate: the ``roofline`` sub-dict of
``ServingEngine.metrics()``, in the JAX engine's schema. The peaks are the
H100 SXM data sheet's, never a TPU's. Host arithmetic only.
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["peak_snapshot", "decode_step_bytes", "decode_roofline"]

#: NVIDIA H100 SXM5 (80 GB HBM3) data-sheet peaks, dense
PEAK_HBM_BW = 3.35e12
PEAK_FLOPS = 989e12
_SOURCE = "NVIDIA H100 SXM5 data sheet"


def peak_snapshot() -> Dict:
    """The labelled peak pair every row is priced against."""
    return {"peak_flops": PEAK_FLOPS, "peak_hbm_bw": PEAK_HBM_BW,
            "peak_source": {
                "flops": f"{_SOURCE}: 989 TFLOP/s bf16 dense",
                "hbm_bw": f"{_SOURCE}: 3.35 TB/s HBM3"}}


def _sig4(x: float) -> float:
    return float(f"{x:.4g}")


def decode_step_bytes(B: int, D: int, H: int, KV: int, hd: int, F: int,
                      BS: int, MB: int, act_itemsize: float = 2,
                      weight_itemsize: float = 2,
                      pool_itemsize: float = 2) -> Dict[str, int]:
    """Modeled device-memory bytes of ONE decoder layer's decode step on
    each route, at full occupancy (``B`` live rows, full ``MB``-page
    tables, the JAX model's convention):

    - ``cuda_block`` (``decode_block_fused``, one launch): every weight
      read once (the kernel streams the MLP weights once for all rows;
      the TPU kernel's per-row refetch does not apply), x in and out, and
      the f32 residual written and read once between its halves;
    - ``cuda_fused`` (``decode_attn_block`` + ``decode_mlp_block``): every
      weight once, x in and out of each launch;
    - ``unfused`` (the composition): every weight once plus ~10 (B, D)
      activation round trips and the (B, F) gate/up/SwiGLU tensors.

    ``weight_itemsize`` is the bytes a weight element: the model type's,
    1 for int8 weights, 0.5 for packed int4. The quantized weights' f32
    scale rows (``(2H + 2KV) * hd + 2F + D`` floats a layer: 170 KB at
    LLaMA-7B, 0.17% of its int4 weights) are not counted, as in the JAX
    model. Rope rows, tables and the kernels' small workspaces are
    ignored."""
    Hhd, KVhd = H * hd, KV * hd
    w_attn = (D * Hhd + 2 * D * KVhd + Hhd * D) * weight_itemsize
    w_mlp = 3 * D * F * weight_itemsize
    kv = 2 * B * MB * BS * KVhd * pool_itemsize
    x = B * D * act_itemsize
    return {
        "cuda_block": int(w_attn + w_mlp + kv + 2 * x + 2 * B * D * 4),
        "cuda_fused": int(w_attn + w_mlp + kv + 4 * x),
        "unfused": int(w_attn + w_mlp + kv + 10 * x
                       + 6 * B * F * act_itemsize),
    }


def decode_roofline(step_bytes: Dict[str, int],
                    measured_us: Optional[Dict[str, float]] = None,
                    peaks: Optional[Dict] = None) -> Dict:
    """Per route: modeled bytes a step, the least step time at the card's
    memory rate, and the achieved share of it where a measured mean step
    time is given (``measured_us``: route -> microseconds)."""
    peaks = peaks or peak_snapshot()
    peak_bw = peaks["peak_hbm_bw"]
    measured_us = measured_us or {}
    variants = {}
    for name, nbytes in step_bytes.items():
        t_bw_us = nbytes / peak_bw * 1e6
        row = {"bytes_per_step": int(nbytes),
               "step_us_at_peak_bw": round(t_bw_us, 3),
               "achieved_bw_frac": None}
        t = measured_us.get(name)
        if t:
            row["achieved_bw_frac"] = _sig4(t_bw_us / t)
        variants[name] = row
    return {"variants": variants, "peak_hbm_bw": peak_bw,
            "peak_source": peaks["peak_source"]}
