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

Not ported here (raise ``NotImplementedError`` unless off): ``mesh``,
``param_specs`` and ``data_spec`` (distributed training, ROADMAP A11),
``observability`` and ``telemetry`` (A8), :meth:`Trainer.prefetch` and
:meth:`Trainer.audit` (A12).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

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
                 moment_dtype=None, observability=False, telemetry=False,
                 device=None):
        """``loss_fn(params, *batch) -> scalar``. ``fused_optimizer``:
        None picks the flat fused path on CUDA for an eligible tree and
        the per-leaf path on the CPU; True/False force. ``moment_dtype``:
        storage type of the AdamW moments (None = f32; bf16 halves them,
        the update still runs in f32). ``device``: CUDA by default;
        ``"cpu"`` runs the plain versions."""
        for name, val, off, slice_ in (
                ("mesh", mesh, None, "distributed training, ROADMAP A11"),
                ("param_specs", param_specs, None, "ROADMAP A11"),
                ("data_spec", data_spec, None, "ROADMAP A11"),
                ("observability", observability, False, "ROADMAP A8"),
                ("telemetry", telemetry, False, "ROADMAP A8")):
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

    def step(self, state: TrainState, *batch) -> Tuple[TrainState, Dict]:
        """One training step; ``state`` is updated in place and returned.
        The metrics ``loss`` and ``grad_norm`` are 0-d device tensors
        (reading them synchronises)."""
        if self._t_first is None:
            self._t_first = time.perf_counter()
        batch = tuple(self._stage(b) for b in batch)
        if self._lr_cache is None or self._lr_cache[0] != self.lr:
            self._lr_cache = (self.lr, torch.tensor(
                self.lr, dtype=torch.float32, device=self.device))
        metrics = self._step_body(state, self._lr_cache[1], batch)
        self._count_step(batch, time.perf_counter())
        return state, metrics

    def prefetch(self, batches, depth: int = 2):
        _not_ported("prefetch", "double-buffered ingest, ROADMAP A9")

    def audit(self, state: TrainState, *batch, register: bool = True):
        _not_ported("audit", "static program audit, ROADMAP A12")

    # -- metrics --------------------------------------------------------------
    def metrics(self) -> Dict:
        """Step, sample and token counters and their rates over the
        window. The window closes when :meth:`step` returns, before the
        device finishes: read a metric (``float(m["loss"])``) first for
        exact rates."""
        c = {k: self.counters[k] for k in self._COUNTER_KEYS}
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        c["wall_time_s"] = round(wall, 6)
        c["samples_per_sec"] = (round(c["samples"] / wall, 3)
                                if wall > 0 else 0.0)
        c["tokens_per_sec"] = (round(c["tokens"] / wall, 3)
                               if wall > 0 else 0.0)
        return c

    def reset_metrics(self):
        """Zero the throughput window (e.g. after warm-up)."""
        for k in self._COUNTER_KEYS:
            self.counters[k] = 0
        self._t_first = self._t_last = None
