"""Step telemetry + host-vs-device gap detection (port of
``paddle_tpu/observability/compile.py``).

The JAX package AOT-compiles each jitted program through a watcher that
records its compile time, its ``cost_analysis()`` FLOPs and its
``memory_analysis()`` HBM breakdown. PyTorch compiles no step program:
the step runs eagerly, its CUDA kernels are built by nvcc and Triton at
their first use. So :class:`CompileWatcher` records, for each new step
SIGNATURE (the caller's key: batch shapes and dtypes, the route), one
"program" entry on that signature's first step:

- ``wall_s``: the seconds that step spent building kernels (nvcc in
  ``ops/kernels/_build.build``, Triton at a kernel's first launch:
  ``_build.build_seconds()``); 0 when all were built;
- ``cost.flops``: the FLOPs counted over that step: the aten ops' (the
  formulas of ``torch.utils.flop_counter.FlopCounterMode``, applied by
  :class:`_OpFlops`, which runs every op as called: ``FlopCounterMode``
  itself decomposes the ops it has no formula for, which changes the
  step's rounding) plus, for every launch
  of the port's own kernels (ctypes and Triton launches, which the flop
  counter cannot see), ``kernel_catalog.modeled_flops`` of the plan
  ``capture_kernel_launches(all_threads=True)`` records (the backward's
  launches run on autograd's device thread); ``cost.kernel_flops`` is the
  kernels' part;
- ``memory``: the JAX keys (bytes): ``argument_bytes`` (the step's
  inputs), ``output_bytes`` (what it writes: the state, updated in place,
  and the metrics), ``alias_bytes`` (the in-place part, the JAX step's
  donated buffers), ``temp_bytes`` (the allocator's peak during the step
  over what was allocated at its start, from ``torch.cuda`` memory stats;
  None on the CPU, which has no such stats), ``generated_code_bytes``
  (always None: kernel images live outside the caching allocator, and
  CUDA reports no size for them) and ``total_bytes`` (the JAX sum, a None
  counted as 0).

Any later new signature is a retrace once :meth:`CompileWatcher.arm` was
called, as in the JAX package. :meth:`CompileWatcher.mfu` divides the
counted FLOPs by the ONE peak table below, which
``observability/roofline.py`` and ``analysis/kernel_rules.py`` read too.

It also hosts the :class:`HostGapDetector` (verbatim): per-step phase
timings (stage/h2d, dispatch, host sync) are compared and a
flight-recorder-style dump fires when host-side time dwarfs the time
actually spent waiting on the device.
"""
from __future__ import annotations

import contextlib
import os
import warnings
from typing import Dict, Optional

__all__ = ["CompileWatcher", "HostGapDetector", "device_peak_flops",
           "device_peak_hbm_bw", "live_hbm_bytes", "H100_PEAK_OPS",
           "H100_HBM_BW"]

#: NVIDIA's H100 SXM5 data sheet (80 GB HBM3, dense rates, at the 700 W
#: limit): peak operations per second by working type (bf16 on the tensor
#: cores, f32 outside them) and the memory rate in bytes/s
H100_PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
H100_HBM_BW = 3.35e12
_SHEET = "NVIDIA H100 SXM5 data sheet"
# the per-card peaks (bf16 dense FLOP/s, HBM bytes/s), matched on
# torch.cuda.get_device_name; the labelled default is the H100's
_DEFAULT_CARD = "H100"
_PEAK_FLOPS = {"H100": H100_PEAK_OPS["bfloat16"]}
_PEAK_HBM_BW = {"H100": H100_HBM_BW}


def _card_name() -> str:
    """The CUDA card's name ("" without one)."""
    import torch
    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(0)


def _device_peak(table, env_var):
    """Shared peak-lookup contract: ``(value, source)`` in the order env
    override (exact hardware known to the operator) > the card's name
    matched in the table > the labelled H100 default. The source string
    rides into ``metrics()`` and the roofline reports so a fraction
    computed against an *assumed* peak is labelled as such."""
    env = os.environ.get(env_var)
    if env:
        try:
            return float(env), "env"
        except ValueError:
            pass
    name = _card_name()
    for k, v in table.items():
        if k in name:
            return v, f"card:{name} ({_SHEET})"
    return table[_DEFAULT_CARD], f"default:{_DEFAULT_CARD} ({_SHEET})"


def device_peak_flops(default: float = None):
    """Best-effort peak bf16 FLOPs/s of the card: ``(value, source)``.

    Order: ``PADDLE_TPU_PEAK_FLOPS`` env override > the card's table
    entry > the labelled H100 default (``default``, when given,
    overrides the table default — the JAX package's signature)."""
    val, source = _device_peak(_PEAK_FLOPS, "PADDLE_TPU_PEAK_FLOPS")
    if default is not None and source.startswith("default"):
        return float(default), source
    return val, source


def device_peak_hbm_bw():
    """Best-effort peak memory rate of the card in bytes/s:
    ``(value, source)``. Same contract as :func:`device_peak_flops` with
    the ``PADDLE_TPU_PEAK_HBM_BW`` env override."""
    return _device_peak(_PEAK_HBM_BW, "PADDLE_TPU_PEAK_HBM_BW")


def live_hbm_bytes(device=None) -> Optional[int]:
    """Bytes the caching allocator holds allocated on the CUDA ``device``
    (``torch.cuda.memory_allocated``); None on the CPU, which reports
    none. A host query: no device sync."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.memory_allocated(device)) or None


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _op_flops_mode():
    """An :class:`_OpFlops` dispatch mode (built at first use: the class
    derives from torch's ``TorchDispatchMode``)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    class _OpFlops(TorchDispatchMode):
        """Sums ``FlopCounterMode``'s formulas over the aten ops it sees,
        each op run exactly as called (no decomposition, so the numerics
        are the plain step's, bit for bit). The autograd engine carries
        the mode to its device threads."""

        def __init__(self):
            super().__init__()
            self.formulas = FlopCounterMode(display=False).flop_registry
            self.total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = self.formulas.get(func._overloadpacket)
            if formula is not None:
                self.total += int(formula(*args, **kwargs, out_val=out))
            return out

    return _OpFlops()


class _StepProbe:
    """What a signature's first step measured (filled by
    :meth:`CompileWatcher.first_step`)."""

    __slots__ = ("wall_s", "cost", "memory")

    def __init__(self):
        self.wall_s = 0.0
        self.cost: Optional[Dict] = None
        self.memory: Optional[Dict] = None


class CompileWatcher:
    """Per-signature step telemetry with a retrace watchdog.

    ``first_step(name, key, ...)`` wraps the first step of a new
    signature: it times the kernel builds, counts the FLOPs and reads the
    memory around it, and records the program entry (the JAX watcher's
    ``compile``). Once :meth:`arm` is called (the warmup→reset idiom the
    serving watchdog established), any new signature of an armed program
    warns — a steady-state train loop must run ONE step signature.
    """

    def __init__(self, registry=None, timeline=None, warn: bool = True):
        self.registry = registry
        self.timeline = timeline
        self.warn = warn
        self.programs: Dict[str, Dict] = {}
        self.retrace_events: list = []
        self._armed = False
        self._seen = set()

    def known(self, name: str, key) -> bool:
        """Whether ``name`` already ran a step of signature ``key``."""
        return (name, key) in self._seen

    @contextlib.contextmanager
    def first_step(self, name: str, key, device, inputs=(), outputs=(),
                   aliased=()):
        """Wrap the first step of signature ``key``; yields a
        :class:`_StepProbe`, filled and recorded when the block exits.
        ``inputs``/``outputs``/``aliased``: the step's input tensors, the
        tensors it writes, and those written in place (``memory``). Adds
        no device sync: the counters and the allocator's stats are host
        state."""
        import torch

        from ..analysis.kernel_catalog import modeled_flops
        from ..ops.kernels import _build
        from ..ops.kernels._launch import capture_kernel_launches
        cuda = torch.device(device).type == "cuda"
        probe = _StepProbe()
        if cuda:
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        built0 = _build.build_seconds()
        counter = _op_flops_mode()
        with capture_kernel_launches(all_threads=True) as specs, counter:
            yield probe
        probe.wall_s = _build.build_seconds() - built0
        kernel_flops = sum(modeled_flops(s) or 0.0 for s in specs)
        probe.cost = {"flops": float(counter.total) + kernel_flops,
                      "kernel_flops": kernel_flops}
        mem = {"argument_bytes": _nbytes(inputs),
               "output_bytes": _nbytes(outputs),
               "temp_bytes": (int(torch.cuda.max_memory_allocated(device))
                              - base if cuda else None),
               "alias_bytes": _nbytes(aliased),
               "generated_code_bytes": None}
        mem["total_bytes"] = (mem["argument_bytes"] + mem["output_bytes"]
                              + (mem["temp_bytes"] or 0)
                              - mem["alias_bytes"])
        probe.memory = mem
        self._seen.add((name, key))
        self._record(name, probe)

    def _record(self, name: str, probe: _StepProbe):
        wall_s = probe.wall_s
        rec = self.programs.get(name)
        if rec is None:
            rec = self.programs[name] = {
                "count": 0, "wall_s_total": 0.0, "wall_s_last": 0.0,
                "cost": None, "memory": None}
        rec["count"] += 1
        rec["wall_s_total"] += wall_s
        rec["wall_s_last"] = wall_s
        # cost/memory reflect the LAST signature: a retrace changed the
        # step, so the stale count would misprice MFU
        rec["cost"] = probe.cost
        rec["memory"] = probe.memory
        if self.registry is not None:
            self.registry.histogram("compile_ms").observe(wall_s * 1e3)
        if self.timeline is not None:
            self.timeline.record("compile", program=name,
                                 dur_ms=wall_s * 1e3,
                                 count=rec["count"])
        if self._armed:
            finding = {"program": name, "traces": 1,
                       "compile_ms": round(wall_s * 1e3, 3)}
            self.retrace_events.append(finding)
            if self.warn:
                warnings.warn(
                    f"compile of {name!r} after warmup "
                    f"({wall_s * 1e3:.1f} ms) — a steady-state train "
                    "loop must reuse one step signature; a shape or "
                    "dtype leak in the batch stream retraces every "
                    "occurrence", RuntimeWarning, stacklevel=4)

    def record_capture(self, name: str, seconds: float,
                       nodes: Optional[int] = None):
        """Record a capture of program ``name`` as one CUDA graph (the
        port's counterpart of the executable a JAX compile builds): its
        seconds and graph nodes, listed under ``programs[name]
        ["captures"]`` and stamped on the timeline. A capture is not a
        retrace: a new state's program captures a known signature, and a
        new signature has already warned at its first step."""
        rec = self.programs.setdefault(name, {
            "count": 0, "wall_s_total": 0.0, "wall_s_last": 0.0,
            "cost": None, "memory": None})
        rec.setdefault("captures", []).append(
            {"capture_ms": round(seconds * 1e3, 3), "graph_nodes": nodes})
        if self.timeline is not None:
            self.timeline.record("capture", program=name,
                                 dur_ms=seconds * 1e3, graph_nodes=nodes)

    def arm(self):
        """Declare warmup complete: further new signatures warn + count.
        Re-arming restarts the retrace window — a fixed leak's old
        warnings must not haunt the next window's snapshot (the
        compile_ms histogram resets alongside, via reset_window)."""
        self._armed = True
        self.retrace_events = []

    @property
    def armed(self) -> bool:
        return self._armed

    @property
    def total_compiles(self) -> int:
        return sum(r["count"] for r in self.programs.values())

    def flops_per_step(self, name: str) -> Optional[float]:
        rec = self.programs.get(name)
        if rec and rec.get("cost"):
            return rec["cost"].get("flops")
        return None

    def mfu(self, name: str, steps: int, wall_s: float) -> Optional[Dict]:
        """Counted-FLOPs MFU over a measured window: the step's counted
        FLOPs (recompute under remat included: what the card ran) times
        the steps, over the wall time and the card's peak."""
        flops = self.flops_per_step(name)
        if not flops or steps <= 0 or wall_s <= 0:
            return None
        peak, source = device_peak_flops()
        return {"mfu": round(flops * steps / (wall_s * peak), 4),
                "flops_per_step_per_device": flops,
                "peak_flops_per_chip": peak, "peak_source": source}

    def snapshot(self) -> Dict:
        progs = {}
        for name, r in self.programs.items():
            progs[name] = {
                "count": r["count"],
                "wall_ms_total": round(r["wall_s_total"] * 1e3, 3),
                "wall_ms_last": round(r["wall_s_last"] * 1e3, 3),
                **({"cost": r["cost"]} if r["cost"] else {}),
                **({"memory": r["memory"]} if r["memory"] else {}),
                **({"captures": list(r["captures"])}
                   if r.get("captures") else {}),
            }
        return {"count": self.total_compiles,
                "retraces_after_warmup": len(self.retrace_events),
                "programs": progs}


class HostGapDetector:
    """Detect steps where host-side time dwarfs device-wait time.

    Per step the trainer hands over its phase split: ``stage_ms``
    (batch h2d staging), ``dispatch_ms`` (the eager step's enqueue
    returning — pure host work while the card runs behind it) and
    ``sync_ms`` (the wait for the step's completion, i.e. the time the
    device was actually the bottleneck). When ``stage + dispatch >
    factor × sync`` and the step is big enough to matter, the host — not
    the device — owns the step, and a flight-recorder-style dump is
    emitted through the provided callback (bounded count; detection keeps
    counting after the cap).
    """

    def __init__(self, factor: float = 4.0, min_wall_ms: float = 50.0,
                 max_dumps: int = 4):
        self.factor = float(factor)
        self.min_wall_ms = float(min_wall_ms)
        self.max_dumps = int(max_dumps)
        self.findings: list = []
        self.dumps = 0

    def reset(self):
        """Restart the detection window (the warmup→reset idiom):
        findings clear and the dump budget refills — warmup's first-
        staging gap must not spend the measured window's budget."""
        self.findings = []
        self.dumps = 0

    def observe(self, step: int, stage_ms: float, dispatch_ms: float,
                sync_ms: float) -> Optional[Dict]:
        host_ms = stage_ms + dispatch_ms
        wall_ms = host_ms + sync_ms
        if wall_ms < self.min_wall_ms:
            return None
        if host_ms <= self.factor * max(sync_ms, 1e-3):
            return None
        finding = {"step": step, "host_ms": round(host_ms, 3),
                   "stage_ms": round(stage_ms, 3),
                   "dispatch_ms": round(dispatch_ms, 3),
                   "device_wait_ms": round(sync_ms, 3),
                   "host_over_device": round(
                       host_ms / max(sync_ms, 1e-3), 1)}
        self.findings.append(finding)
        return finding

    def should_dump(self) -> bool:
        if self.dumps >= self.max_dumps:
            return False
        self.dumps += 1
        return True

