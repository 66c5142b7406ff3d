"""The trainer on one device (port of ``paddle_tpu/distributed/trainer.py``).

``Trainer(loss_fn, lr=..., ...)`` runs ``loss_fn(params, *batch)``, its
gradient and a functional AdamW with f32 master weights, one step per
:meth:`Trainer.step`. The state is updated IN PLACE: parameters, master,
moments and the step count keep their storage from step to step, which
is what donation buys the JAX step (``donate`` is accepted and needs
nothing more).

The step is one program, as the JAX package jits its step into one
donated program: on CUDA one captured CUDA graph a step signature and
state (:class:`..inference.program.Program` over the step body
:meth:`Trainer._step_body`). A key's first step runs eagerly on the
trainer's side stream (the warm-up: kernels built, Triton compiled), its
second captures the graph (one memory pool shared by the trainer's
graphs), and every step after that is one replay; a capture that fails
raises with CUDA's error. The graph reads only fixed tensors: the state,
the batch buffers of its key (each step's batch copied in before the
replay), and the trainer's one f32 lr word (a changed ``lr`` written
into it outside the graph; ``fused_adamw`` and the per-leaf update read
it on the device). ``loss`` and ``grad_norm`` are copied out of the
graph's pool after each step, so a step's metrics outlive the next one.
On the CPU the body runs at every step. The key is the signature (batch
shapes and types, the registry's pins, the optimizer path,
``accumulate_steps``) and the state's tensors: a second
:meth:`init_state` gets a program of its own.

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
``stage_ms`` (the batch's staging into the key's buffers),
``dispatch_ms`` (the host's enqueue of the step: one replay, or the
warm-up's eager forward, ``torch.autograd.grad`` and optimizer update; a
new signature's kernel builds and a capture excluded) and
``sync_ms`` (the wait for the step's end: one CUDA event and its
``synchronize()``, the observed step's one sync, as the JAX trainer's
``block_until_ready``); loss, grad-norm and live-memory gauges; the step
telemetry of ``observability/compile.py`` (kernel-build time, counted
FLOPs and counted-FLOPs MFU and the memory breakdown, probed on a
signature's warm-up; each capture's seconds and graph nodes; new
signatures after ``reset_metrics()`` warned as retraces, a new state's
capture not); and the host-vs-device gap
detector, which dumps when the host's time dwarfs the wait. The step
body reads no tensor on the host. ``telemetry=`` adds the telemetry plane
(implies observability). Disabled, the trainer holds ``None`` and
allocates no event object.

:meth:`Trainer.prefetch` stages the next batches on the device behind the
current step (pinned memory and a side stream on the card).

:meth:`Trainer.audit` is the static program audit of the step
(:mod:`paddle_tpu_torch.analysis`): a fake-tensor trace of the step body,
the rules over it. Each new step program's signature is recorded in the
analysis registry's ``train_step`` spec, as the JAX trainer records each
compile's.

Not ported here (raise ``NotImplementedError`` unless off): ``mesh``,
``param_specs`` and ``data_spec`` (distributed training, ROADMAP A11).
"""
from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..inference.program import Program
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
    int32 0-d tensor on the device), each updated in place by every step:
    a captured step writes the tensors it was captured with."""

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
    """The per-leaf AdamW of the JAX package, in place (the step count
    too: a captured step reads its address): ``lr`` an f32 0-d tensor;
    bias corrections ``1 - f32(b)**f32(step)``; moments kept in their
    stored type; params written from the new master."""
    params, master, mu, nu, step = state
    step.add_(1)
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
        # the one f32 lr word the step reads, and the value written in it
        self._lr_word: Optional[torch.Tensor] = None
        self._lr_value: Optional[float] = None
        # the step programs by (signature, state) and what each reads and
        # writes (module docstring); on CUDA the side stream their
        # warm-ups and captures run on and the pool their graphs share
        self._programs: Dict[Tuple, Tuple] = {}
        self._stream = None
        self._pool = None
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
                # lr the f32 word: the kernel reads it on the device
                gnorm = self._fused_update(grads, state, lr)
            else:
                _, gnorm = _adamw_update(
                    tree_unflatten(params, grads), state.tree(), lr,
                    b1=hp["b1"], b2=hp["b2"], eps=1e-8, wd=hp["wd"],
                    grad_clip=hp["grad_clip"])
        return {"loss": loss, "grad_norm": gnorm}

    def _fused_update(self, grads, state: TrainState, lr):
        """One ``fused_adamw`` launch over the flat f32 state (+ the
        low-precision shadow); the new params copied back in place."""
        from ..ops.kernels.fused_adamw import adamw_update
        hp = self.hp
        sizes, pdtype, pad = self._flat_meta
        state.step.add_(1)
        # the low-precision type only when every grad has it (lossless);
        # a mixed tree concatenates in f32
        gdt = (pdtype if pdtype is not None
               and {g.dtype for g in grads} == {pdtype} else torch.float32)
        dev = state.master.device      # the trainer's (a trace's own)
        g_flat = torch.cat([g.reshape(-1).to(gdt) for g in grads]
                           + ([torch.zeros(pad, dtype=gdt, device=dev)]
                              if pad else []))
        gnorm = torch.linalg.vector_norm(g_flat, dtype=torch.float32)
        scale = (torch.clamp(hp["grad_clip"] / torch.clamp(gnorm, min=1e-12),
                             max=1.0)
                 if hp["grad_clip"]
                 else torch.ones((), dtype=torch.float32, device=dev))
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

    def _stage(self, b) -> torch.Tensor:
        """A batch array as a tensor where it lies (numpy on the CPU, a
        prefetched batch on the device): :meth:`_load` copies it into the
        step's buffer."""
        if isinstance(b, torch.Tensor):
            return b
        return torch.as_tensor(np.asarray(b))

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
        """The trainer's one f32 lr word on the device, which every step
        program reads: a changed ``self.lr`` is written into it by one
        fill on the stream (no copy from the host), outside the graph, as
        the JAX trainer makes one ``jnp.float32`` a change."""
        if self._lr_word is None:
            self._lr_word = torch.zeros((), dtype=torch.float32,
                                        device=self.device)
        lr = float(self.lr)
        if self._lr_value != lr:
            self._lr_word.fill_(lr)
            self._lr_value = lr
        return self._lr_word

    def _state_key(self, state: TrainState) -> Tuple:
        """The identity of ``state``'s tensors (addresses, shapes, types):
        a program writes the tensors it was captured with."""
        return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                     for part in state.tree() for t in tree_leaves(part))

    def _step_program(self, body):
        """The program of one step key over ``body`` (chip_smoke.py swaps
        in an eager twin here): on CUDA on the trainer's side stream, its
        graph in the trainer's shared pool, its launch plans recorded on
        every thread (the backward runs on autograd's)."""
        if self.device.type == "cuda" and self._stream is None:
            with torch.cuda.device(self.device):
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
        return Program(body, self.device, self._stream, None,
                       pool=self._pool, all_threads=True)

    def _program(self, state: TrainState, key, staged):
        """The step program of (``key``, ``state``), made at its first
        step: (program, its batch buffers, the dict its body fills with
        the step's metrics)."""
        pkey = (key, self._state_key(state))
        entry = self._programs.get(pkey)
        if entry is None:
            bufs = tuple(torch.empty(b.shape, dtype=b.dtype,
                                     device=self.device) for b in staged)
            out: Dict = {}
            word = self._lr_tensor()
            trainer = weakref.ref(self)   # no cycle through the program

            def body():
                out.update(trainer()._step_body(state, word, bufs))
            entry = self._programs[pkey] = (self._step_program(body),
                                            bufs, out)
            self._record_program(state, bufs)
        return entry

    def _load(self, state: TrainState, batch):
        """The step's batch into its program's buffers (on the stream,
        before the replay): (the staged batch, the signature, the
        program's entry)."""
        staged = tuple(self._stage(b) for b in batch)
        key = self._signature(staged)
        entry = self._program(state, key, staged)
        for buf, b in zip(entry[1], staged):
            buf.copy_(b)
        return staged, key, entry

    @staticmethod
    def _run(prog) -> Optional[float]:
        """One step of ``prog``: the capture first where it is due (the
        key's second step on CUDA); returns the capture's seconds, or None
        when this step captured nothing."""
        fresh = getattr(prog, "graph", None) is None
        prog.prepare()
        prog()
        return (prog.capture_s if fresh
                and getattr(prog, "graph", None) is not None else None)

    @staticmethod
    def _metrics(out) -> Dict:
        """The step's metrics, copied out of the program's outputs (the
        next replay overwrites those)."""
        return {k: v.clone() for k, v in out.items()}

    def step(self, state: TrainState, *batch) -> Tuple[TrainState, Dict]:
        """One training step; ``state`` is updated in place and returned.
        The metrics ``loss`` and ``grad_norm`` are 0-d device tensors
        (reading them synchronises), the step's own (the next step does
        not change them)."""
        if self._obs is not None:
            out = self._step_observed(state, batch)
            if self._telemetry is not None:
                self._telemetry.on_step()
            return out
        if self._t_first is None:
            self._t_first = time.perf_counter()
        staged, _, (prog, _, out) = self._load(state, batch)
        self._lr_tensor()                  # a changed lr into its word
        self._run(prog)
        metrics = self._metrics(out)
        self._count_step(staged, time.perf_counter())
        return state, metrics

    # -- observed step (enabled mode) ---------------------------------------
    def _signature(self, staged) -> Tuple:
        """The step's signature, the key of the step telemetry and, with
        the state's identity, of the step programs: the batch shapes and
        dtypes, the registry's force pins, the optimizer path and the
        accumulation count (what makes the step run other kernels or other
        shapes)."""
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
        """The enabled-mode step: the same program, phase-timed into
        stage (the batch into the key's buffers), dispatch (the replay's
        enqueue, or the warm-up's eager one) and sync (the wait for its
        end) — the split the host-vs-device gap detector reads. A new
        signature's first step (its warm-up) runs under the watcher's
        probe (kernel builds timed and left out of dispatch, FLOPs
        counted, memory read): the same numerics; a capture is timed,
        recorded with its graph nodes and left out of dispatch too; the
        gap detector skips both steps."""
        obs = self._obs
        t0 = obs.now()
        if self._t_first is None:
            self._t_first = t0
        staged, key, (prog, bufs, out) = self._load(state, batch)
        t_stage = obs.now()
        lr = self._lr_tensor()
        compile_ms = 0.0
        first = not self._compile.known("train_step", key)
        if not first:
            capture_s = self._run(prog)
        else:
            state_tensors = [t for part in state.tree()
                             for t in tree_leaves(part)]
            outputs = list(state_tensors)
            with self._compile.first_step(
                    "train_step", key, self.device,
                    inputs=state_tensors + [lr, *bufs],
                    outputs=outputs, aliased=state_tensors) as probe:
                capture_s = self._run(prog)
                outputs += list(out.values())
            compile_ms = probe.wall_s * 1e3
        metrics = self._metrics(out)
        if capture_s is not None:
            self._compile.record_capture("train_step", capture_s,
                                         getattr(prog, "nodes", None))
            compile_ms += capture_s * 1e3
        t_disp = obs.now()
        self._wait()
        t_sync = obs.now()
        stage_ms = (t_stage - t0) * 1e3
        # dispatch = the step's enqueue; a new signature's kernel builds
        # and a capture are timed apart and excluded here rather than
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
        # out of dispatch too); nor is a capture's
        finding = (None if first or capture_s is not None else
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
        """Double-buffered ingest (reference:
        python/paddle/io/dataloader/dataloader_iter.py:368 buffer reader):
        yields batches already staged on the trainer's device while the
        NEXT batch's host-to-device copy runs behind the CURRENT step's
        compute, so a steady step costs max(compute, copy) instead of
        their sum. ``batches`` yields a tuple/list per step (the ``*batch``
        of :meth:`step`) or a single array. On the card each batch goes
        through pinned memory on a side stream, and the step's stream
        waits on its copy's event (``io.dataloader._DevicePrefetchIter``).
        With observability on, each pull samples the staged-queue depth as
        the ``prefetch_queue_depth`` gauge: a queue pinned at 0 means the
        consumer is ingest-bound, at ``depth`` compute-bound."""
        from ..io.dataloader import _DevicePrefetchIter

        on_next = None
        obs = self._obs
        if obs is not None:
            def on_next(qsize):
                obs.registry.gauge("prefetch_queue_depth",
                                   obs.gauge_window).set(qsize, obs.now())

        return _DevicePrefetchIter(iter(batches), self.device,
                                   depth=max(1, depth), on_next=on_next)

    # -- the static program audit --------------------------------------------
    def _train_step_fn(self):
        """The step program's function over explicit arguments, ``(state
        tree, lr word, *batch) -> (state tree, metrics)``: the body the
        captured program runs (:meth:`_step_body`), in place on the state.
        One function a trainer (the registry knows its program by it),
        holding the trainer weakly (a registered spec must not keep a
        trainer and its state alive)."""
        fn = self.__dict__.get("_step_fn")
        if fn is None:
            ref = weakref.ref(self)

            def train_step(tree, lr, *batch):
                trainer = ref()
                if trainer is None:
                    raise RuntimeError("the trainer of this train_step "
                                       "spec no longer exists")
                state = TrainState(*tree)
                metrics = trainer._step_body(state, lr, batch)
                return state.tree(), metrics
            fn = self._step_fn = train_step
        return fn

    def _build_audit_spec(self, state: TrainState, batch):
        """The ONE definition of the step's ProgramSpec (shared by
        :meth:`audit_spec` and the step's registration of a new key): the
        abstract signature (state, the f32 lr word, the batch as the
        program's buffers on the device), the state written in place and
        carried leaf for leaf."""
        from torch.utils import _pytree as pytree
        from ..analysis.registry import (ProgramSpec, TensorStruct,
                                         abstract_signature)
        tree = abstract_signature(state.tree())
        args = (tree, TensorStruct((), torch.float32, self.device)) + tuple(
            TensorStruct(tuple(b.shape), b.dtype, self.device)
            for b in batch)
        n_state = len(pytree.tree_leaves(tree))
        return ProgramSpec(name="train_step", fn=self._train_step_fn(),
                           args=args, donate_argnums=(0,),
                           carry={i: i for i in range(n_state)},
                           tags=("trainer",))

    def _record_program(self, state: TrainState, staged):
        """A new step program's signature into the registry's
        ``train_step`` spec (registering this trainer's spec when the name
        is another's or free): a second signature is what the audit
        reports as MULTIPLE_SIGNATURES."""
        from ..analysis.registry import REGISTRY
        spec = REGISTRY.get("train_step")
        new = self._build_audit_spec(state, staged)
        if spec is None or spec.fn is not new.fn:
            REGISTRY.register(new)
        else:
            spec.record_signature(new.args, {})

    def audit_spec(self, state: TrainState, *batch, register: bool = True):
        """The :class:`~paddle_tpu_torch.analysis.ProgramSpec` of the step
        program at this state and batch signature (no tensor kept);
        ``register=True`` files it in the analysis registry."""
        from ..analysis.registry import REGISTRY
        if not isinstance(state, TrainState):
            raise ValueError("Trainer.audit needs the TrainState that "
                             "init_state() made")
        spec = self._build_audit_spec(
            state, tuple(self._stage(b) for b in batch))
        if register:
            spec = REGISTRY.register(spec)
        return spec

    def audit(self, state: TrainState, *batch, register: bool = True):
        """Static audit of the step program (trace-only: nothing executes,
        launches, allocates on the device or captures): the rule passes of
        :mod:`paddle_tpu_torch.analysis` over a fake-tensor trace of
        :meth:`_step_body`. Under ``remat`` the checkpointed layers trace
        with their recomputation (``models._common._same_pins``), as the
        captured step runs them. Returns the report; its finding count
        lands in the ``audit_findings`` counter."""
        from ..analysis.auditor import audit_spec, publish_findings
        report = audit_spec(self.audit_spec(state, *batch,
                                            register=register))
        publish_findings(report, counters=self.counters, obs=self._obs)
        return report

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
