"""Kernel roofline observatory on one NVIDIA H100 (port of
``paddle_tpu/observability/roofline.py``): modeled bytes and FLOPs of each
kernel launch, and the decode step's model of each serving route.

- :func:`roofline_point` classifies one (bytes, FLOPs[, measured time])
  point against the card's roofline;
- :func:`kernel_cost` prices one launch's captured plan
  (:class:`~paddle_tpu_torch.ops.kernels._launch.KernelLaunchSpec`): its
  bytes from ``analysis/kernel_rules.modeled_launch_bytes`` (each input
  read once, each output written once, by the live lengths), its FLOPs
  from ``analysis/kernel_catalog.modeled_flops`` (the JAX package's
  full-table formulas);
- :func:`capture_kernel_costs` runs a function over meta tensors under
  ``capture_kernel_launches`` (the port's ``jax.eval_shape``: every
  wrapper records its plan and launches nothing) and prices every launch;
- :func:`decode_step_bytes` models the device-memory bytes one decode step
  of each of the port's routes moves, closed form from the engine's
  static dims; :func:`decode_roofline` turns them into the least step time
  the card's memory rate allows and, given a measured step time, the
  achieved share of that rate: the ``roofline`` sub-dict of
  ``ServingEngine.metrics()``, in the JAX engine's schema;
  :func:`roofline_chrome_events` renders it as the ``roofline:`` counter
  track of the engines' Chrome traces.

The peaks are read from ``observability/compile.py``'s one table (the
H100 SXM data sheet's, never a TPU's), so no two denominators can
disagree. Host arithmetic only: no device work, no syncs.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .compile import (H100_HBM_BW, H100_PEAK_OPS, device_peak_flops,
                      device_peak_hbm_bw)

__all__ = ["peak_snapshot", "kernel_cost", "roofline_point",
           "capture_kernel_costs", "decode_step_bytes", "decode_roofline",
           "roofline_chrome_events", "PEAK_HBM_BW", "PEAK_FLOPS"]

#: NVIDIA H100 SXM5 (80 GB HBM3) data-sheet peaks, dense (the peak table's
#: entry, ``observability/compile.py``)
PEAK_HBM_BW = H100_HBM_BW
PEAK_FLOPS = H100_PEAK_OPS["bfloat16"]


def peak_snapshot() -> Dict:
    """The labelled peak pair every roofline row prices against."""
    flops, flops_src = device_peak_flops()
    bw, bw_src = device_peak_hbm_bw()
    return {"peak_flops": flops, "peak_hbm_bw": bw,
            "peak_source": {"flops": flops_src, "hbm_bw": bw_src}}


def _sig4(x: float) -> float:
    return float(f"{x:.4g}")


def roofline_point(bytes_modeled: Optional[float],
                   flops_modeled: Optional[float],
                   time_us: Optional[float] = None,
                   peaks: Optional[Dict] = None) -> Dict:
    """Classify one (bytes, FLOPs[, measured time]) point against the
    device roofline.

    Returns ``intensity`` (FLOPs/byte), ``bound`` (``"memory"`` /
    ``"compute"`` by the ridge point ``peak_flops / peak_hbm_bw``),
    the bound-side lower-bound execution time ``time_at_roofline_us``
    and — when a measured ``time_us`` is given — ``achieved_bw_frac``,
    ``achieved_flops_frac`` and ``roofline_frac`` (lower bound over
    measured: 1.0 means the launch runs AT the roofline). Fields whose
    inputs are missing are ``None``, never silently zero.
    """
    peaks = peaks or peak_snapshot()
    peak_flops = peaks["peak_flops"]
    peak_bw = peaks["peak_hbm_bw"]
    out: Dict = {"intensity": None, "bound": None,
                 "time_at_roofline_us": None,
                 "achieved_bw_frac": None, "achieved_flops_frac": None,
                 "roofline_frac": None,
                 "peak_source": peaks["peak_source"]}
    has_bytes = bytes_modeled is not None and bytes_modeled > 0
    has_flops = flops_modeled is not None and flops_modeled > 0
    if has_bytes and has_flops:
        intensity = flops_modeled / bytes_modeled
        out["intensity"] = round(intensity, 3)
        ridge = peak_flops / peak_bw
        out["bound"] = "memory" if intensity < ridge else "compute"
    t_bw = bytes_modeled / peak_bw if has_bytes else None
    t_fl = flops_modeled / peak_flops if has_flops else None
    t_roof = max(t for t in (t_bw, t_fl) if t is not None) \
        if (t_bw is not None or t_fl is not None) else None
    if t_roof is not None:
        out["time_at_roofline_us"] = round(t_roof * 1e6, 3)
    if time_us is not None and time_us > 0:
        t_s = time_us * 1e-6
        if has_bytes:
            out["achieved_bw_frac"] = _sig4(
                bytes_modeled / t_s / peak_bw)
        if has_flops:
            out["achieved_flops_frac"] = _sig4(
                flops_modeled / t_s / peak_flops)
        if t_roof is not None:
            out["roofline_frac"] = _sig4(t_roof / t_s)
    return out


def kernel_cost(spec, time_us: Optional[float] = None,
                seq_lens=None, peaks: Optional[Dict] = None) -> Dict:
    """One captured launch -> its full roofline row: modeled bytes
    (read/written split; paged operands by ``seq_lens``, by default the
    launch's own live lengths), modeled FLOPs (``None`` + a
    ``flops_model: "missing"`` marker when the kernel has no registered
    formula — the gap is also a gate finding), and the
    :func:`roofline_point` classification."""
    from ..analysis.kernel_catalog import modeled_flops
    from ..analysis.kernel_rules import modeled_launch_bytes

    bm = modeled_launch_bytes(spec, seq_lens)
    flops = modeled_flops(spec)
    row = {"kernel": spec.name, "grid": list(spec.grid),
           "bytes_modeled": int(bm["total_bytes"]),
           "read_bytes": int(bm["read_bytes"]),
           "written_bytes": int(bm["written_bytes"]),
           "flops_modeled": flops,
           "flops_model": "formula" if flops is not None else "missing"}
    row.update(roofline_point(row["bytes_modeled"], flops,
                              time_us=time_us, peaks=peaks))
    return row


def capture_kernel_costs(fn: Callable, *args,
                         times_us: Optional[Dict[str, float]] = None
                         ) -> List[Dict]:
    """Run ``fn(*args)`` over meta tensors under launch capture (the
    port's ``jax.eval_shape``: each wrapper records its plan and launches
    nothing) and price every captured launch. ``args`` hold meta tensors
    (``torch.empty(..., device="meta")``). ``times_us`` optionally maps
    kernel name -> measured microseconds to fill the achieved
    fractions."""
    from ..ops.kernels._launch import capture_kernel_launches

    with capture_kernel_launches() as specs:
        fn(*args)
    peaks = peak_snapshot()
    times_us = times_us or {}
    return [kernel_cost(s, time_us=times_us.get(s.name), peaks=peaks)
            for s in specs]


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


def roofline_chrome_events(report: Dict, t_us: float = 0.0) -> List[Dict]:
    """Render a :func:`decode_roofline` report (or any
    ``{"variants": {name: {...}}}`` mapping) as chrome-trace counter
    events — one ``roofline:<name>`` annotation track per route carrying
    the modeled bytes/step, so the Perfetto view of a serving trace
    shows the bandwidth-bound floor next to the measured rows."""
    events = []
    for name, row in sorted(report.get("variants", {}).items()):
        events.append({"name": f"roofline:{name}", "ph": "C",
                       "ts": t_us,
                       "args": {"bytes_per_step":
                                row.get("bytes_per_step", 0)}})
    return events
