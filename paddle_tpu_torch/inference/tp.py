"""Tensor-parallel serving over a list of devices (port of
``paddle_tpu/inference/tp.py``).

The JAX package runs ONE program over a named device mesh: ``shard_map``
runs the per-shard body on every device of the mesh, the collectives are
``psum`` and ``all_gather`` over the mesh axis, and the host's
``BlockManager`` and page tables stay global. The port keeps that
single-controller design. A :class:`ServingMesh` is an ordered list of
torch devices, which may repeat (shards on one device are colocated:
``["cuda:0"] * 2`` runs two shards' per-shard shapes on one card). One
process runs each shard's body on its device in turn, and the two
collectives are methods of the mesh: :meth:`ServingMesh.psum`, a sum of
the shards' parts in shard order on shard 0's device, and
:meth:`ServingMesh.all_gather`, their concatenation in shard order, each
handed back to every shard's device. A backend that spans several cards
can stand behind the same two methods without touching the step.

Sharding scheme (:func:`paddle_tpu_torch.models.llama.tp_param_specs`):

- KV pools ``[L, N_pages, BS, KV, hd]`` are split on the KV-head axis:
  shard i holds ``[L, N_pages, BS, KV/tp, hd]``. Page indices stay
  global: a page index names the same physical page on every shard, each
  shard holding that page's slice of the heads, so the ``BlockManager``
  works unchanged.
- q/k/v/gate/up split their output columns (head-major, so a contiguous
  column range is a contiguous head range); embedding, norms and lm_head
  stay whole on every shard, so the residual stream is replicated and
  sampling runs once, on the replicated logits.

Collective placement (``ServingMesh.collective``), as in the JAX package:

- ``"psum"`` (default): o_proj/down_proj split their rows; each
  sub-block computes a partial product over its local heads or SwiGLU
  columns and one psum a sub-block (two a layer) rebuilds the residual.
  The decode step runs the registry's ``decode_attn_block`` and
  ``decode_mlp_block`` per shard with ``residual=False`` over the
  per-shard meta (``tp`` in it): on the card the CUDA kernels'
  ``residual=0`` bodies. The sum associates differently from one device's
  product, so greedy output agrees with the single-device engine up to
  roundoff.
- ``"gather"``: o_proj/down_proj stay whole; the per-shard attention
  heads and SwiGLU columns are gathered first, so every product sees the
  single-device operands, shapes and reduction order, and greedy output
  equals the single-device engine's. This placement always runs the
  unfused composition: its contract is the single-device op sequence.

Replicated math (the residual adds, the norms, the gathered products) is
the same on every shard; colocated shards compute it once
(:func:`_once_per_device`) and share the result.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..models.llama import tp_param_specs
from ..ops import rms_norm, swiglu
from ..ops.rope import build_rope_cache
from .generation import (_chunk_attention, _decode_attention, _head, _layer,
                         _layer_scales, _mm, _wq_mode, _write_new_token)

__all__ = ["ServingMesh", "tp_reject_reason", "normalize_mesh"]

_COLLECTIVES = ("psum", "gather")


def normalize_mesh(mesh) -> Optional["ServingMesh"]:
    """None | ServingMesh | int tp -> ServingMesh | None: the one
    mesh-argument normalisation of the serving engine. An int takes the
    first ``tp`` visible CUDA cards (:meth:`ServingMesh.make`)."""
    if mesh is None:
        return None
    if isinstance(mesh, ServingMesh):
        return mesh
    if isinstance(mesh, int):
        return ServingMesh.make(tp=mesh)
    raise TypeError(f"mesh must be ServingMesh | int | None, got "
                    f"{type(mesh).__name__}")


def tp_reject_reason(cfg, tp: int) -> Optional[str]:
    """Why ``cfg`` cannot shard over ``tp`` shards, or None when it can:
    head-axis sharding needs every split dimension to divide evenly."""
    if tp == 1:
        return None
    checks = (("num_key_value_heads", cfg.num_key_value_heads),
              ("num_attention_heads", cfg.num_attention_heads),
              ("intermediate_size", cfg.intermediate_size))
    for name, v in checks:
        if v % tp != 0:
            return (f"{name}={v} is not divisible by tp={tp}: head-axis "
                    f"sharding needs {name} % tp == 0 (use a divisor of "
                    f"{v}, or tp=1)")
    return None


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """The serving stack's tensor-parallel mesh: an ordered list of
    devices (shard i on ``devices[i]``; a device may repeat), the axis
    name and the collective placement. Build with :meth:`make`."""
    devices: Tuple[torch.device, ...]
    axis: str = "tp"
    collective: str = "psum"

    def __post_init__(self):
        if self.collective not in _COLLECTIVES:
            raise ValueError(f"collective must be one of {_COLLECTIVES},"
                             f" got {self.collective!r}")
        devices = tuple(resolve_device(d) for d in self.devices)
        if not devices:
            raise ValueError("ServingMesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @classmethod
    def make(cls, tp: Optional[int] = None, axis: str = "tp",
             collective: str = "psum", devices=None) -> "ServingMesh":
        """The first ``tp`` of ``devices`` (default: the visible CUDA
        cards; all of them when ``tp`` is None). An explicit list may
        repeat a device."""
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = list(devices)
        tp = len(devices) if tp is None else int(tp)
        if tp < 1 or tp > len(devices):
            raise ValueError(f"tp={tp} but only {len(devices)} device(s)"
                             " visible")
        return cls(tuple(devices[:tp]), axis=axis, collective=collective)

    @property
    def tp(self) -> int:
        return len(self.devices)

    def split(self, first: int) -> Tuple["ServingMesh", "ServingMesh"]:
        """The first ``first`` devices and the rest, as two meshes with
        this mesh's axis and placement."""
        devs = self.devices
        if not 1 <= first < len(devs):
            raise ValueError(
                f"split(first={first}) needs 1 <= first < {len(devs)} "
                f"(the mesh has {len(devs)} device(s); both groups "
                "need at least one)")
        return (ServingMesh(devs[:first], self.axis, self.collective),
                ServingMesh(devs[first:], self.axis, self.collective))

    def describe(self) -> Dict:
        return {"axis": self.axis, "tp": self.tp,
                "collective": self.collective}

    def param_specs(self, cfg, params=None) -> Dict:
        """The split dim of each leaf of a llama tree (pass ``params``
        when it may carry quantized leaves)."""
        return tp_param_specs(cfg, axis=self.axis,
                              collective=self.collective, params=params)

    # -- placement ------------------------------------------------------
    def replicate(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` on every shard's device: one tensor a device, shared by
        the shards there (no copy where ``t`` already lies)."""
        per_dev = {d: t.to(d) for d in dict.fromkeys(self.devices)}
        return [per_dev[d] for d in self.devices]

    def shard(self, tree, specs) -> List:
        """One tree per shard. A leaf whose spec is a dim is cut into tp
        equal slices along it, slice i made contiguous on shard i's
        device; a leaf whose spec is None is whole on every shard, one
        tensor a device (:meth:`replicate`). ``specs`` mirrors ``tree``
        (:meth:`param_specs`), or is one spec for every leaf."""
        tp = self.tp

        def cut(t, dim):
            if dim is None:
                return self.replicate(t)
            n = t.shape[dim]
            if n % tp:
                raise ValueError(f"dim {dim} of size {n} does not split "
                                 f"into tp={tp} shards")
            w = n // tp
            return [t.narrow(dim, i * w, w).to(d).contiguous()
                    for i, d in enumerate(self.devices)]

        def walk(t, s):
            if isinstance(t, dict):
                parts = {k: walk(v, s[k] if isinstance(s, dict) else s)
                         for k, v in t.items()}
                return [{k: p[i] for k, p in parts.items()}
                        for i in range(tp)]
            return cut(t, s)

        return walk(tree, specs)

    # -- the collectives --------------------------------------------------
    def psum(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """The all-reduce: the shards' parts summed in shard order
        0..tp-1, in their own type, on shard 0's device; the sum handed
        to every shard's device."""
        d0 = self.devices[0]
        acc = parts[0].to(d0)
        for p in parts[1:]:
            acc = acc + p.to(d0)
        return self.replicate(acc)

    def all_gather(self, parts: List[torch.Tensor],
                   dim: int) -> List[torch.Tensor]:
        """The tiled all-gather: the shards' parts concatenated along
        ``dim`` in shard order on shard 0's device, handed to every
        shard's device."""
        if len(parts) == 1:      # one shard: the gather is the part
            return self.replicate(parts[0])
        d0 = self.devices[0]
        return self.replicate(torch.cat([p.to(d0) for p in parts], dim))

    # -- validation -------------------------------------------------------
    def reject_reason(self, cfg) -> Optional[str]:
        return tp_reject_reason(cfg, self.tp)

    def supports(self, cfg) -> Tuple[bool, str]:
        """(ok, reason): the kernel-registry ``supports()`` idiom."""
        reason = self.reject_reason(cfg)
        if reason is not None:
            return False, reason
        return True, (f"tp={self.tp} over axis {self.axis!r} "
                      f"({self.collective} placement)")

    def collective_inventory(self, cfg, B: int, chunk: int = 1) -> list:
        """The declared collectives of one decode step (or one prefill
        chunk of ``chunk`` tokens): [(op, axis, shape, dtype)], the
        per-step call count folded into the leading dim (the JAX
        package's inventory, dtype by name)."""
        L, D = cfg.num_hidden_layers, cfg.hidden_size
        dt = str(cfg.dtype).replace("torch.", "")
        if self.collective == "psum":
            return [("psum", self.axis, (2 * L, B * chunk, D), dt)]
        H, hd = cfg.num_attention_heads, cfg.head_dim
        F = cfg.intermediate_size
        return [
            ("all_gather", self.axis,
             (L, B * chunk, H // self.tp, hd), dt),
            ("all_gather", self.axis, (L, B * chunk, F // self.tp), dt),
        ]


# ---------------------------------------------------------------------------
# the per-shard bodies: lists hold one entry per shard (its parameters,
# pools and scales, or a replicated value on its device)
# ---------------------------------------------------------------------------
def _once_per_device(mesh, fn, *per_shard):
    """``fn`` over the per-shard lists' entries, run for the first shard
    on each device and shared by the shards colocated with it: for
    replicated math, which is the same on every shard."""
    done: Dict[torch.device, object] = {}
    for i, d in enumerate(mesh.devices):
        if d not in done:
            done[d] = fn(*(p[i] for p in per_shard))
    return [done[d] for d in mesh.devices]


def _wshape(w):
    """Stored shape of a weight leaf (a tensor or a quantized leaf). int4
    packs the contraction axis of q/k/v/gate/up, never their output
    columns, which are what the local dims read."""
    if isinstance(w, dict):
        return tuple((w["qw8"] if "qw8" in w else w["qw4"]).shape)
    return tuple(w.shape)


def _local_dims(params, cfg):
    """(H_loc, KV_loc, F_loc) of one shard, read off its stacked
    weights."""
    hd, lay = cfg.head_dim, params["layers"]
    return (_wshape(lay["q_proj"])[2] // hd, _wshape(lay["k_proj"])[2] // hd,
            _wshape(lay["gate_proj"])[2])


def _rope_rows(mesh, cfg, device, rope):
    if rope is None:
        rope = build_rope_cache(cfg.max_position_embeddings, cfg.head_dim,
                                base=cfg.rope_theta, device=device)
    return mesh.replicate(rope[0]), mesh.replicate(rope[1])


def _final_logits(shards, xs, cfg):
    """The final norm and the head, once, on shard 0's replicated row."""
    x = rms_norm(xs[0][:, None], shards[0]["final_norm"].to(xs[0].dtype),
                 cfg.rms_norm_eps)[:, 0]
    return x @ _head(shards[0])


def _tp_decode_step(shards, tok, cfg, k_pools, v_pools, block_tables,
                    seq_lens, mesh, rope=None, kv_scales=None, fused=False):
    """One tensor-parallel decode token per slot (the JAX package's
    ``_tp_decode_step``, run over every shard in turn).

    shards: the per-shard parameter trees (:meth:`ServingMesh.shard`);
    k_pools/v_pools: the per-shard pools [L, N, BS, KV_loc, hd], written
    in place; kv_scales: the per-shard (k [L, KV_loc], v [L, KV_loc]) of
    int8 pools, or None; tok, seq_lens, block_tables and the rope table on
    shard 0's device. ``fused``: the decode-block route, False for the
    exact composition, "auto"/"pallas"/"ref" for registry dispatch over
    the per-shard meta; the "gather" placement always runs the
    composition. Returns (logits [B, V] on shard 0's device, k_pools,
    v_pools)."""
    from ..ops.kernels.fused_decode_block import (attn_block_ref,
                                                  decode_meta_dims,
                                                  mlp_block_ref,
                                                  resolve_decode_blocks)
    if fused == "block":
        # the single-launch kernel is single-device (its predicate refuses
        # tp != 1): a forced "block" under a mesh is a configuration error
        raise ValueError("fused_decode='block' is single-device: "
                         "tensor-parallel decode runs the per-stage "
                         "kernels")
    if mesh.collective == "gather":
        return _tp_decode_step_gather(shards, tok, cfg, k_pools, v_pools,
                                      block_tables, seq_lens, mesh, rope,
                                      kv_scales)
    B = tok.shape[0]
    if fused:
        H_loc, KV_loc, F_loc = _local_dims(shards[0], cfg)
        meta = decode_meta_dims(
            B, cfg.hidden_size, H_loc, KV_loc, cfg.head_dim, F_loc,
            k_pools[0].shape[2], block_tables.shape[1], cfg.dtype,
            k_pools[0].dtype, kv_scales is not None, tp=mesh.tp,
            weight_dtype=_wq_mode(shards[0]), device=k_pools[0].device)
        attn_fn, mlp_fn, _ = resolve_decode_blocks(meta, fused)
    else:
        attn_fn, mlp_fn = attn_block_ref, mlp_block_ref
    eps = cfg.rms_norm_eps
    xs = mesh.replicate(shards[0]["embed_tokens"][tok.long()])   # [B, D]
    sins, coss = _rope_rows(mesh, cfg, xs[0].device, rope)
    seqs, tables = mesh.replicate(seq_lens), mesh.replicate(block_tables)
    for layer in range(cfg.num_hidden_layers):
        lps = [_layer(p, layer) for p in shards]
        scs = [_layer_scales(kv_scales[i] if kv_scales else None, layer)
               for i in range(mesh.tp)]
        parts, new = [], []
        for i, lp in enumerate(lps):
            part, k_new, v_new = attn_fn(
                xs[i], lp["input_norm"].to(xs[i].dtype), lp["q_proj"],
                lp["k_proj"], lp["v_proj"], lp["o_proj"], sins[i], coss[i],
                k_pools[i][layer], v_pools[i][layer], tables[i], seqs[i],
                scs[i], eps, residual=False)
            parts.append(part)
            new.append((k_new, v_new))
        # one all-reduce for the attention sub-block, then the replicated
        # residual add (the partial sums associate differently from one
        # device's product: roundoff-level parity)
        xs = _once_per_device(mesh, torch.add, xs, mesh.psum(parts))
        for i, (k_new, v_new) in enumerate(new):
            _write_new_token(k_pools[i][layer], v_pools[i][layer], tables[i],
                             seqs[i], k_new, v_new, scs[i])
        parts = [mlp_fn(xs[i], lp["post_norm"].to(xs[i].dtype),
                        lp["gate_proj"], lp["up_proj"], lp["down_proj"], eps,
                        residual=False) for i, lp in enumerate(lps)]
        xs = _once_per_device(mesh, torch.add, xs, mesh.psum(parts))
    return _final_logits(shards, xs, cfg), k_pools, v_pools


def _tp_decode_step_gather(shards, tok, cfg, k_pools, v_pools, block_tables,
                           seq_lens, mesh, rope, kv_scales):
    """The "gather" placement's decode body: per-shard heads and columns,
    gathered before o_proj and down_proj, so every product has the
    single-device operands (``_paged_decode_step``'s op sequence)."""
    B, eps = tok.shape[0], cfg.rms_norm_eps
    xs = mesh.replicate(shards[0]["embed_tokens"][tok.long()])
    sins, coss = _rope_rows(mesh, cfg, xs[0].device, rope)
    seqs, tables = mesh.replicate(seq_lens), mesh.replicate(block_tables)
    lens = mesh.replicate(seq_lens + 1)

    def norm(name):
        return lambda x, lp: rms_norm(x[:, None], lp[name].to(x.dtype),
                                      eps)[:, 0]

    for layer in range(cfg.num_hidden_layers):
        lps = [_layer(p, layer) for p in shards]
        hs = _once_per_device(mesh, norm("input_norm"), xs, lps)
        # heads shard contiguously, so the gather on the head axis
        # rebuilds the single-device [B, H, hd]
        attn = mesh.all_gather([_decode_attention(
            hs[i], lp, sins[i], coss[i], k_pools[i][layer], v_pools[i][layer],
            tables[i], seqs[i], lens[i],
            _layer_scales(kv_scales[i] if kv_scales else None, layer))
            for i, lp in enumerate(lps)], 1)
        xs = _once_per_device(
            mesh, lambda x, a, lp: x + _mm(a.reshape(B, -1).to(x.dtype),
                                           lp["o_proj"]), xs, attn, lps)
        hs = _once_per_device(mesh, norm("post_norm"), xs, lps)
        ff = mesh.all_gather([swiglu(_mm(h, lp["gate_proj"]),
                                     _mm(h, lp["up_proj"]))
                              for h, lp in zip(hs, lps)], 1)     # [B, F]
        xs = _once_per_device(mesh, lambda x, f, lp: x + _mm(
            f, lp["down_proj"]), xs, ff, lps)
    return _final_logits(shards, xs, cfg), k_pools, v_pools


def _tp_cached_layer(lps, xs, sins, coss, cfg, kcs, vcs, pos, mesh):
    """Tensor-parallel ``generation._cached_layer``: one decoder block over
    S new tokens at absolute position ``pos`` on every shard, each reading
    and writing its slice of the dense cache (kcs/vcs: [B, T, KV_loc, hd]
    per shard, written in place). Returns the replicated rows."""
    eps = cfg.rms_norm_eps
    b, s, _ = xs[0].shape
    gather = mesh.collective == "gather"
    hs = _once_per_device(mesh, lambda x, lp: rms_norm(
        x, lp["input_norm"].to(x.dtype), eps), xs, lps)
    attn = [_chunk_attention(h, lp, sin, cos, kc, vc, pos)
            for h, lp, kc, vc, sin, cos in zip(hs, lps, kcs, vcs, sins, coss)]
    if gather:
        attn = mesh.all_gather(attn, 2)
        xs = _once_per_device(mesh, lambda x, a, lp: x + _mm(
            a.to(x.dtype).reshape(b, s, -1), lp["o_proj"]), xs, attn, lps)
    else:
        xs = _once_per_device(mesh, torch.add, xs, mesh.psum(
            [_mm(a.to(x.dtype).reshape(b, s, -1), lp["o_proj"])
             for a, x, lp in zip(attn, xs, lps)]))
    hs = _once_per_device(mesh, lambda x, lp: rms_norm(
        x, lp["post_norm"].to(x.dtype), eps), xs, lps)
    ff = [swiglu(_mm(h, lp["gate_proj"]), _mm(h, lp["up_proj"]))
          for h, lp in zip(hs, lps)]
    if gather:
        ff = mesh.all_gather(ff, 2)
        return _once_per_device(mesh, lambda x, f, lp: x + _mm(
            f, lp["down_proj"]), xs, ff, lps)
    return _once_per_device(mesh, torch.add, xs, mesh.psum(
        [_mm(f, lp["down_proj"]) for f, lp in zip(ff, lps)]))


def _tp_cached_forward(shards, tokens, cfg, k_caches, v_caches, pos: int,
                       mesh):
    """Tensor-parallel ``generation.cached_forward``, the per-shard prefill
    body: ``k_caches``/``v_caches`` are each shard's dense view
    [L, B, T, KV_loc, hd] (written in place); tokens on shard 0's device.
    Returns (logits [B, S, V] on shard 0's device, k_caches, v_caches)."""
    s = tokens.shape[1]
    T = k_caches[0].shape[2]
    if pos < 0 or pos + s > T:
        raise ValueError(f"tokens at {pos}..{pos + s - 1} do not fit a "
                         f"cache of {T} positions")
    xs = mesh.replicate(shards[0]["embed_tokens"][tokens.long()])
    sin, cos = build_rope_cache(T, cfg.head_dim, base=cfg.rope_theta,
                                device=xs[0].device)
    sins = mesh.replicate(sin[pos:pos + s])
    coss = mesh.replicate(cos[pos:pos + s])
    for layer in range(cfg.num_hidden_layers):
        xs = _tp_cached_layer([_layer(p, layer) for p in shards], xs, sins,
                              coss, cfg, [k[layer] for k in k_caches],
                              [v[layer] for v in v_caches], pos, mesh)
    x = rms_norm(xs[0], shards[0]["final_norm"].to(xs[0].dtype),
                 cfg.rms_norm_eps)
    return x @ _head(shards[0]), k_caches, v_caches
