"""The trainer on one device (port of ``paddle_tpu/distributed/trainer.py``).

``Trainer(loss_fn, lr=..., ...)`` runs ``loss_fn(params, *batch)``, its
gradient and a functional AdamW with f32 master weights, one step per
:meth:`Trainer.step`. PyTorch runs eagerly, so the JAX package's jitted
step program is the step body itself (:meth:`Trainer._step_body`), and
the state is updated IN PLACE: parameters, master and moments keep their
storage from step to step, which is what donation buys the JAX step
(``donate`` is accepted and needs nothing more).

The optimizer has the JAX package's two paths:

- fused (``fused_optimizer=None`` picks it on CUDA for an eligible tree;
  True forces it): flat f32 master and moments in the JAX package's
  leaf order (``jax.tree_util`` sorts dict keys), padded to a multiple of
  131072; the grads concatenated (in the low-precision type only when
  every grad has it), clipped by their global f32 norm inside the
  ``fused_adamw`` kernel (:func:`..ops.kernels.fused_adamw.adamw_update`,
  one launch a step), the updated parameters copied back from the master
  (f32 leaves) or from the low-precision shadow the kernel writes;
- per leaf (:func:`_adamw_update`, the CPU's default as the JAX
  package's default off the TPU).

``observability=True`` (or an ``Observability`` instance) runs the
OBSERVED step, as the JAX trainer's: the same step body, phase-timed into
``stage_ms`` (the batch's host-to-device staging), ``dispatch_ms`` (the
host's enqueue of the whole eager step: forward, ``torch.autograd.grad``
and the optimizer update; a new signature's kernel builds excluded) and
``sync_ms`` (the wait for the step's end: one CUDA event and its
``synchronize()``, the observed step's one sync, as the JAX trainer's
``block_until_ready``); loss, grad-norm and live-memory gauges; the step
telemetry of ``observability/compile.py`` (kernel-build time, counted
FLOPs and counted-FLOPs MFU, the memory breakdown, new signatures after
``reset_metrics()`` warned as retraces); and the host-vs-device gap
detector, which dumps when the host's time dwarfs the wait. The step
body reads no tensor on the host. ``telemetry=`` adds the telemetry plane
(implies observability). Disabled, the trainer holds ``None`` and
allocates no event object.

Not ported here (raise ``NotImplementedError`` unless off): ``mesh``,
``param_specs`` and ``data_spec`` (distributed training, ROADMAP A11),
:meth:`Trainer.prefetch` (A9) and :meth:`Trainer.audit` (A12).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..observability import (TRAIN_HISTOGRAMS, CompileWatcher,
                             HostGapDetector, Observability,
                             TelemetryConfig, TelemetryPlane,
                             live_hbm_bytes)

__all__ = ["TrainState", "Trainer", "tree_leaves", "tree_unflatten"]

_BLOCK = 131072          # the JAX fused path's flat padding multiple


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in ``jax.tree_util.tree_leaves``
    order (keys sorted at every level)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


class TrainState:
    """params (model dtype) + f32 master + moments + the step count (an
    int32 0-d tensor on the device)."""

    def __init__(self, params, master, mu, nu, step):
        self.params = params
        self.master = master
        self.mu = mu
        self.nu = nu
        self.step = step

    def tree(self):
        return (self.params, self.master, self.mu, self.nu, self.step)


def _adamw_update(grads, state: Tuple, lr, b1=0.9, b2=0.95, eps=1e-8,
                  wd=0.1, grad_clip=1.0):
    """The per-leaf AdamW of the JAX package, in place: ``lr`` an f32 0-d
    tensor; bias corrections ``1 - f32(b)**f32(step)``; moments kept in
    their stored type; params written from the new master."""
    params, master, mu, nu, step = state
    step = step + 1
    flat_g = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in flat_g))
    scale = (torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
             if grad_clip else 1.0)
    stepf = step.float()
    f32 = torch.float32
    bc1 = 1.0 - torch.full((), b1, dtype=f32, device=stepf.device) ** stepf
    bc2 = 1.0 - torch.full((), b2, dtype=f32, device=stepf.device) ** stepf
    for g, m, mu_i, nu_i, p in zip(flat_g, tree_leaves(master),
                                   tree_leaves(mu), tree_leaves(nu),
                                   tree_leaves(params)):
        g32 = g.float() * scale
        mu_n = b1 * mu_i.float() + (1 - b1) * g32
        nu_n = b2 * nu_i.float() + (1 - b2) * torch.square(g32)
        mhat = mu_n / bc1
        vhat = nu_n / bc2
        m.copy_(m * (1.0 - lr * wd) - lr * mhat / (torch.sqrt(vhat) + eps))
        mu_i.copy_(mu_n)
        nu_i.copy_(nu_n)
        p.copy_(m)
    return (params, master, mu, nu, step), gnorm


def _not_ported(name, slice_):
    raise NotImplementedError(
        f"Trainer: {name} is not ported to paddle_tpu_torch ({slice_})")


class Trainer:
    _COUNTER_KEYS = ("steps", "samples", "tokens")

    def __init__(self, loss_fn: Callable, mesh=None, param_specs=None,
                 data_spec=None, lr=3e-4, b1=0.9, b2=0.95,
                 weight_decay=0.1, grad_clip=1.0, accumulate_steps: int = 1,
                 donate: bool = True,
                 fused_optimizer: Optional[bool] = None,
                 moment_dtype=None, observability=False,
                 host_gap_factor: float = 4.0,
                 host_gap_min_ms: float = 50.0, telemetry=False,
                 device=None):
        """``loss_fn(params, *batch) -> scalar``. ``fused_optimizer``:
        None picks the flat fused path on CUDA for an eligible tree and
        the per-leaf path on the CPU; True/False force. ``moment_dtype``:
        storage type of the AdamW moments (None = f32; bf16 halves them,
        the update still runs in f32). ``observability``/``telemetry``
        and the gap detector's ``host_gap_factor``/``host_gap_min_ms``:
        the module docstring. ``device``: CUDA by default; ``"cpu"`` runs
        the plain versions."""
        for name, val, off, slice_ in (
                ("mesh", mesh, None, "distributed training, ROADMAP A11"),
                ("param_specs", param_specs, None, "ROADMAP A11"),
                ("data_spec", data_spec, None, "ROADMAP A11")):
            if val is not off and val != off:
                _not_ported(name, slice_)
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.lr = lr
        self.hp = dict(b1=b1, b2=b2, wd=weight_decay, grad_clip=grad_clip)
        self.accumulate_steps = accumulate_steps
        self._fused_opt = fused_optimizer
        self._fused = False
        self._flat_meta = None
        self._lr_cache = None
        self.moment_dtype = moment_dtype
        self.counters = {"steps": 0, "samples": 0, "tokens": 0}
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        # telemetry implies observability (alerts land timeline events
        # and stall dumps, both owned by the harness)
        _tcfg = TelemetryConfig.coerce(telemetry)
        if observability or _tcfg is not None:
            self._obs = (observability
                         if isinstance(observability, Observability)
                         else Observability(histograms=TRAIN_HISTOGRAMS))
            self._obs.registry.adopt_counters(self.counters)
            self._compile = CompileWatcher(self._obs.registry,
                                           self._obs.timeline)
            self._gap = HostGapDetector(factor=host_gap_factor,
                                        min_wall_ms=host_gap_min_ms)
        else:
            self._obs = None
            self._compile = None
            self._gap = None
        # the telemetry plane samples metrics() on a step cadence; None
        # when disabled
        self._telemetry = None
        if _tcfg is not None:
            self._telemetry = TelemetryPlane(
                _tcfg, on_alert=self._telemetry_alert)
            self._telemetry.register("trainer", self.metrics,
                                     counters=self.counters)

    # -- state init ----------------------------------------------------------
    @staticmethod
    def _fused_tree_ok(params) -> bool:
        """Non-empty, all floating, at most one type besides f32: f32
        leaves slice back from the master, the rest from one shadow."""
        leaves = tree_leaves(params)
        non_f32 = {v.dtype for v in leaves} - {torch.float32}
        return (len(leaves) > 0
                and all(v.dtype.is_floating_point for v in leaves)
                and len(non_f32) <= 1)

    def _decide_fused(self, params) -> bool:
        if self._fused_opt is not None:
            return bool(self._fused_opt)
        if self.device.type != "cuda":
            return False   # the JAX rule off the TPU: the per-leaf path
        return self._fused_tree_ok(params)

    def init_state(self, params) -> TrainState:
        """The trainer's state over ``params`` (moved to the device; the
        trainer updates these tensors in place from now on)."""
        params = tree_unflatten(params, [
            v.to(self.device).requires_grad_(True)
            for v in tree_leaves(params)])
        self._fused = self._decide_fused(params)
        if self._fused and self._fused_opt and \
                not self._fused_tree_ok(params):
            dts = sorted({str(v.dtype) for v in tree_leaves(params)})
            raise ValueError(
                "fused_optimizer=True requires a non-empty param tree of "
                "floating dtype with at most one dtype besides float32 "
                f"(one flat shadow); got {dts}.")
        step = torch.zeros((), dtype=torch.int32, device=self.device)
        mdt = self.moment_dtype or torch.float32
        leaves = tree_leaves(params)
        with torch.no_grad():
            if self._fused:
                sizes = [v.numel() for v in leaves]
                n = sum(sizes)
                pad = (-n) % _BLOCK
                non_f32 = [v.dtype for v in leaves
                           if v.dtype != torch.float32]
                pdtype = non_f32[0] if non_f32 else None
                self._flat_meta = (sizes, pdtype, pad)
                master = torch.zeros(n + pad, dtype=torch.float32,
                                     device=self.device)
                off = 0
                for v, sz in zip(leaves, sizes):
                    master[off:off + sz].copy_(v.reshape(-1))
                    off += sz
                mu = torch.zeros(master.shape, dtype=mdt, device=self.device)
                nu = torch.zeros(master.shape, dtype=mdt, device=self.device)
                return TrainState(params, master, mu, nu, step)
            master = tree_unflatten(params, [
                v.detach().to(torch.float32, copy=True) for v in leaves])
            mu = tree_unflatten(params, [
                torch.zeros(v.shape, dtype=mdt, device=self.device)
                for v in leaves])
            nu = tree_unflatten(params, [
                torch.zeros(v.shape, dtype=mdt, device=self.device)
                for v in leaves])
        return TrainState(params, master, mu, nu, step)

    # -- the step ------------------------------------------------------------
    def _grads(self, params, batch):
        leaves = tree_leaves(params)
        loss = self.loss_fn(params, *batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    def _step_body(self, state: TrainState, lr, batch):
        """Loss and grads (micro-batches summed in f32 and averaged when
        ``accumulate_steps > 1``, over the batch's leading axis), then
        the optimizer update, in place."""
        params = state.params
        if self.accumulate_steps > 1:
            n = self.accumulate_steps
            tot, acc = None, None
            for i in range(n):
                loss, g = self._grads(params, tuple(b[i] for b in batch))
                if acc is None:
                    tot = loss.float()
                    acc = [x.float() for x in g]
                else:
                    tot = tot + loss
                    acc = [a + x for a, x in zip(acc, g)]
            loss, grads = tot / n, [a / n for a in acc]
        else:
            loss, grads = self._grads(params, batch)
        hp = self.hp
        with torch.no_grad():
            if self._fused:
                # lr as a Python float: the kernel takes it as an f32
                # argument, with no device read
                gnorm = self._fused_update(grads, state, self.lr)
            else:
                tree, gnorm = _adamw_update(
                    tree_unflatten(params, grads), state.tree(), lr,
                    b1=hp["b1"], b2=hp["b2"], eps=1e-8, wd=hp["wd"],
                    grad_clip=hp["grad_clip"])
                state.step = tree[4]
        return {"loss": loss, "grad_norm": gnorm}

    def _fused_update(self, grads, state: TrainState, lr):
        """One ``fused_adamw`` launch over the flat f32 state (+ the
        low-precision shadow); the new params copied back in place."""
        from ..ops.kernels.fused_adamw import adamw_update
        hp = self.hp
        sizes, pdtype, pad = self._flat_meta
        state.step = state.step + 1
        # the low-precision type only when every grad has it (lossless);
        # a mixed tree concatenates in f32
        gdt = (pdtype if pdtype is not None
               and {g.dtype for g in grads} == {pdtype} else torch.float32)
        g_flat = torch.cat([g.reshape(-1).to(gdt) for g in grads]
                           + ([torch.zeros(pad, dtype=gdt,
                                           device=self.device)]
                              if pad else []))
        gnorm = torch.linalg.vector_norm(g_flat, dtype=torch.float32)
        scale = (torch.clamp(hp["grad_clip"] / torch.clamp(gnorm, min=1e-12),
                             max=1.0)
                 if hp["grad_clip"] else torch.ones((), device=self.device))
        outs = adamw_update(
            state.master, g_flat, state.mu, state.nu, lr,
            state.step.float(), beta1=hp["b1"], beta2=hp["b2"],
            epsilon=1e-8, weight_decay=hp["wd"], grad_scale=scale,
            shadow_dtype=pdtype)
        master = outs[0]
        shadow = outs[3] if pdtype is not None else master
        off = 0
        for p, sz in zip(tree_leaves(state.params), sizes):
            src = master if p.dtype == torch.float32 else shadow
            p.copy_(src[off:off + sz].view(p.shape))
            off += sz
        return gnorm

    def _stage(self, b):
        if isinstance(b, torch.Tensor):
            return b.to(self.device)
        return torch.as_tensor(np.asarray(b), device=self.device)

    def _count_step(self, batch, t_end: float):
        """samples = leading batch dims, tokens = the element count of
        the first batch array (covers the (acc, B, S) layout)."""
        self.counters["steps"] += 1
        shape = tuple(batch[0].shape) if batch else ()
        if shape:
            if len(shape) >= 2:
                self.counters["samples"] += int(np.prod(shape[:-1]))
                self.counters["tokens"] += int(np.prod(shape))
            else:
                self.counters["samples"] += int(shape[0])
        self._t_last = t_end

    def _lr_tensor(self) -> torch.Tensor:
        """lr as an f32 0-d tensor on the device: one copy when it
        changes, not one a step."""
        if self._lr_cache is None or self._lr_cache[0] != self.lr:
            self._lr_cache = (self.lr, torch.tensor(
                self.lr, dtype=torch.float32, device=self.device))
        return self._lr_cache[1]

    def step(self, state: TrainState, *batch) -> Tuple[TrainState, Dict]:
        """One training step; ``state`` is updated in place and returned.
        The metrics ``loss`` and ``grad_norm`` are 0-d device tensors
        (reading them synchronises)."""
        if self._obs is not None:
            out = self._step_observed(state, batch)
            if self._telemetry is not None:
                self._telemetry.on_step()
            return out
        if self._t_first is None:
            self._t_first = time.perf_counter()
        batch = tuple(self._stage(b) for b in batch)
        metrics = self._step_body(state, self._lr_tensor(), batch)
        self._count_step(batch, time.perf_counter())
        return state, metrics

    # -- observed step (enabled mode) ---------------------------------------
    def _signature(self, staged) -> Tuple:
        """The step's signature, the key of the step telemetry: the batch
        shapes and dtypes, the registry's force pins, the optimizer path
        and the accumulation count (what makes the eager step run other
        kernels or other shapes)."""
        from ..ops.kernels.registry import KERNELS
        return (tuple((tuple(b.shape), b.dtype) for b in staged),
                KERNELS.forced_state(), self._fused,
                self.accumulate_steps)

    def _wait(self):
        """The observed step's one sync: the wait for everything the step
        enqueued (one CUDA event recorded after it, synchronised). The
        CPU's eager step is done when it returns."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()

    def _step_observed(self, state: TrainState, batch
                       ) -> Tuple[TrainState, Dict]:
        """The enabled-mode step: the same step body, phase-timed into
        stage (batch h2d), dispatch (the eager step's enqueue returning)
        and sync (the wait for its end) — the split the host-vs-device gap
        detector reads. A new signature's first step runs under the
        watcher's probe (kernel builds timed and left out of dispatch,
        FLOPs counted, memory read): the same numerics; the gap detector
        skips that step."""
        obs = self._obs
        t0 = obs.now()
        if self._t_first is None:
            self._t_first = t0
        staged = tuple(self._stage(b) for b in batch)
        t_stage = obs.now()
        lr = self._lr_tensor()
        key = self._signature(staged)
        compile_ms = 0.0
        first = not self._compile.known("train_step", key)
        if not first:
            metrics = self._step_body(state, lr, staged)
        else:
            state_tensors = [t for part in state.tree()
                             for t in tree_leaves(part)]
            outputs = list(state_tensors)
            with self._compile.first_step(
                    "train_step", key, self.device,
                    inputs=state_tensors + [lr, *staged],
                    outputs=outputs, aliased=state_tensors) as probe:
                metrics = self._step_body(state, lr, staged)
                outputs += list(metrics.values())
            compile_ms = probe.wall_s * 1e3
        t_disp = obs.now()
        self._wait()
        t_sync = obs.now()
        stage_ms = (t_stage - t0) * 1e3
        # dispatch = the step's enqueue; a new signature's kernel builds
        # are timed by the watcher and excluded here rather than
        # masquerading as dispatch work
        dispatch_ms = max((t_disp - t_stage) * 1e3 - compile_ms, 0.0)
        sync_ms = (t_sync - t_disp) * 1e3
        step_ms = (t_sync - t0) * 1e3
        self._count_step(staged, t_sync)
        step_idx = self.counters["steps"]
        for name, v in (("step_ms", step_ms), ("stage_ms", stage_ms),
                        ("dispatch_ms", dispatch_ms),
                        ("sync_ms", sync_ms)):
            obs.hist(name).observe(v)
        # the step has ended: these reads wait for nothing
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        vals = {"loss": loss, "grad_norm": gnorm}
        hbm = live_hbm_bytes(self.device)
        if hbm is not None:
            vals["hbm_bytes_in_use"] = hbm
        obs.sample_gauges(t_sync, vals)
        obs.timeline.record(
            "train_step", dur_ms=step_ms, step=step_idx,
            stage_ms=round(stage_ms, 3),
            dispatch_ms=round(dispatch_ms, 3),
            sync_ms=round(sync_ms, 3), loss=round(loss, 6))
        # a signature's first step is not judged: its dispatch carries the
        # watcher's counting (the JAX trainer's compile, which it leaves
        # out of dispatch too)
        finding = (None if first else
                   self._gap.observe(step_idx, stage_ms, dispatch_ms,
                                     sync_ms))
        if finding is not None:
            obs.timeline.record("host_gap", **finding)
            if self._gap.should_dump():
                obs.stall_dump(
                    f"host-vs-device gap: step {step_idx} spent "
                    f"{finding['host_ms']:.1f} ms on the host "
                    f"(stage {finding['stage_ms']:.1f} + dispatch "
                    f"{finding['dispatch_ms']:.1f}) vs "
                    f"{finding['device_wait_ms']:.1f} ms waiting on "
                    "the device — per-step h2d staging or host-side "
                    "work owns this step, not compute",
                    scheduler={"phase_split": finding,
                               "mesh": self._mesh_shape(),
                               "accumulate_steps": self.accumulate_steps},
                    metrics={"steps": step_idx})
        if obs.step_deadline_s is not None \
                and step_ms > obs.step_deadline_s * 1e3:
            obs.stall_dump(
                f"train step {step_idx} took {step_ms:.1f} ms "
                f"(deadline {obs.step_deadline_s * 1e3:.1f} ms)",
                scheduler={"step": step_idx,
                           "phases": {"stage_ms": round(stage_ms, 3),
                                      "dispatch_ms": round(dispatch_ms, 3),
                                      "sync_ms": round(sync_ms, 3)}})
        return state, metrics

    @staticmethod
    def _mesh_shape() -> Dict[str, int]:
        """The one-device trainer's mesh, as the JAX trainer's
        single-device mesh describes itself: every axis 1."""
        return {"pp": 1, "dp": 1, "fsdp": 1, "sp": 1, "tp": 1}

    @property
    def observability(self) -> Optional[Observability]:
        return self._obs

    def _require_obs(self) -> Observability:
        if self._obs is None:
            raise RuntimeError(
                "observability is disabled for this trainer; construct "
                "with Trainer(..., observability=True)")
        return self._obs

    @property
    def telemetry(self) -> Optional[TelemetryPlane]:
        """The continuous telemetry plane, or None when disabled."""
        return self._telemetry

    def _telemetry_alert(self, alert: Dict):
        """Stamp an ``alert`` timeline event; page-severity alerts also
        land a flight-recorder dump (the trainer has no scheduler, so
        the dump carries the throughput counters instead)."""
        obs = self._obs
        if obs is None:
            return
        obs.timeline.record(
            "alert", rule=alert.get("rule"),
            severity=alert.get("severity"), metric=alert.get("metric"),
            value=alert.get("value"), threshold=alert.get("threshold"))
        if (alert.get("severity") == "page"
                and self._telemetry.config.page_dumps):
            obs.stall_dump(
                f"telemetry alert: {alert.get('rule')} on "
                f"{alert.get('metric')}",
                {"counters": {k: self.counters[k]
                              for k in self._COUNTER_KEYS}},
                metrics={"alert": alert})

    def export_trace(self, path: str) -> str:
        """Write the per-step chrome trace (train_step/compile spans +
        gauge counter tracks) — open in Perfetto / chrome://tracing."""
        return self._require_obs().export_chrome(
            path, process_name="paddle_tpu trainer")

    def write_timeline(self, path: str) -> str:
        """Write the structured per-step JSONL — input for
        ``tools/trace_summary.py --mode train``."""
        return self._require_obs().write_jsonl(
            path, header={"mode": "train", "mesh": self._mesh_shape(),
                          "accumulate_steps": self.accumulate_steps})

    def prefetch(self, batches, depth: int = 2):
        _not_ported("prefetch", "double-buffered ingest, ROADMAP A9")


    def audit(self, state: TrainState, *batch, register: bool = True):
        _not_ported("audit", "static program audit, ROADMAP A12")

    # -- metrics --------------------------------------------------------------
    def metrics(self) -> Dict:
        """Step, sample and token counters and their rates over the
        window. Disabled, the window closes when :meth:`step` returns,
        before the device finishes: read a metric (``float(m["loss"])``)
        first for exact rates; the observed step waits for its end, so
        its window is exact. With observability on (the JAX trainer's
        keys): the phase histograms, gauges, the step telemetry
        (``compile``, ``compiles``, ``retrace_warnings``, counted-FLOPs
        ``mfu``, ``hbm``: the step's memory breakdown), the host-gap,
        stall-dump and timeline counters, and ``collectives`` where a
        bound flight recorder fed the counters."""
        c = {k: self.counters[k] for k in self._COUNTER_KEYS}
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        c["wall_time_s"] = round(wall, 6)
        c["samples_per_sec"] = (round(c["samples"] / wall, 3)
                                if wall > 0 else 0.0)
        c["tokens_per_sec"] = (round(c["tokens"] / wall, 3)
                               if wall > 0 else 0.0)
        if self._obs is None:
            return c
        obs = self._obs
        c["latency"] = obs.latency_snapshot(TRAIN_HISTOGRAMS)
        c["gauges"] = obs.gauges_snapshot()
        comp = self._compile.snapshot()
        c["compile"] = comp
        c["compiles"] = comp["count"]
        c["retrace_warnings"] = comp["retraces_after_warmup"]
        c["mfu"] = self._compile.mfu("train_step", steps=c["steps"],
                                     wall_s=wall)
        prog = self._compile.programs.get("train_step")
        c["hbm"] = prog.get("memory") if prog else None
        c["host_gap_findings"] = len(self._gap.findings)
        c["stall_dumps"] = (len(obs.stall_dumps)
                            + obs.stall_dumps_suppressed)
        c["timeline_events"] = len(obs.timeline)
        c["timeline_dropped"] = obs.timeline.dropped
        calls = self.counters.get("collective_calls")
        if calls:
            c["collectives"] = {
                "calls": dict(calls),
                "bytes": dict(self.counters.get("collective_bytes", {})),
                "latency_ms": {
                    name[len("collective_"):-len("_ms")]: h.snapshot()
                    for name, h in sorted(
                        obs.registry.histograms.items())
                    if name.startswith("collective_")
                    and name.endswith("_ms")}}
        if self._telemetry is not None:
            c["telemetry"] = self._telemetry.snapshot()
        return c

    def reset_metrics(self):
        """Zero the throughput window (e.g. after warm-up). With
        observability on this also restarts the histogram window and ARMS
        the step watcher: a new step signature after this call is a
        steady-state retrace and warns. Only the trainer's own counter
        keys reset."""
        for k in self._COUNTER_KEYS:
            self.counters[k] = 0
        self._t_first = self._t_last = None
        if self._obs is not None:
            self._obs.reset_window()
            self._compile.arm()
            # warmup's first-staging host gap must neither show up in the
            # measured window's findings nor spend its dump budget
            self._gap.reset()
