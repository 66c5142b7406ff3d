"""Continuous-batching serving engine over the paged KV cache (port of
``paddle_tpu/inference/serving.py``: one device or a tensor-parallel
mesh; the fused and the unfused decode route, the fused and the unfused
prefill chunk; fp or int8 pools).

- a fixed-capacity SLOT TABLE: every decode step runs over all
  ``capacity`` slots. Inactive slots are padded -- seq_len 0, block table
  pointing at the reserved scratch page 0 -- so their K/V write lands on
  a page no live sequence reads, and their attention output is zero.
- BUCKETED CHUNKED PREFILL: a new request's prompt runs in chunks of at
  most the largest bucket, padded to a bucket, interleaved with decode
  steps. The fused chunk (``_fused_prefill_forward``) runs per layer the
  ``prefill_attn_block`` kernel over the request's pages, writes the
  chunk's own K/V into the pools and runs the ``decode_mlp_block`` kernel
  over its rows. The verbatim unfused chunk gathers the request's pages
  into a dense [L, 1, MB*BS, KV, hd] view, runs ``cached_forward``'s math
  (that of ``generate``'s prefill, as ``_tp_cached_forward`` over one
  "gather" shard: the same op sequence) and scatters the whole view back
  through the request's table. Padded table entries and pad rows go to
  page 0, so the duplicate writes of the in-place scatters
  (``index_put_``) all land on the scratch page. (The JAX engine writes through a separate WRITE
  table that redirects prefix-cache pages to scratch; without a prefix
  cache the two tables are equal, and the port adds it with the prefix
  cache.)
- SLOT RECYCLING, priority/deadline admission and preemption with
  bit-identical resume, as in the JAX package.
- INT8 CACHE (``cache_dtype="int8"``): the pools store int8 with static
  per-layer, per-head f32 scales, calibrated once, in ``_admit``, from
  the first admitted prompt before its first chunk (padded with token 0
  to its bucket, as the JAX engine pads it: the absmax covers the pad
  rows too). The fused chunk and the decode kernels read int8 pages and
  the pool writes quantize; the verbatim chunk dequantizes its dense view
  to the model type and quantizes it back on the way out (exact for the
  positions it did not write); the unfused decode step dequantizes after
  its gather. Pool bytes halve against bf16.
- TENSOR PARALLELISM (``mesh=ServingMesh(...)`` or an int tp,
  ``inference/tp.py``): the weights, the pools' KV heads and the
  per-slot attention split over the mesh's shards, one process driving
  every shard on its device (devices may repeat: colocated shards). The
  page tables stay global. The "psum" placement's decode step runs
  ``decode_attn_block`` and ``decode_mlp_block`` per shard with
  ``residual=False`` and sums the parts; "gather" runs the single-device
  composition on gathered heads and columns. The prefill chunk is the
  verbatim one over each shard's dense local view (a tp=1 "psum" mesh
  keeps the fused chunk, as in the JAX engine); an int8 cache calibrates
  through the placement's own prefill forward, each shard over its own
  KV heads. ``weight_quant`` with tp > 1, ``fused_decode="block"`` under
  any mesh and "pallas" under "gather" are refused with the JAX engine's
  reasons; ``metrics()["mesh"]`` describes the mesh.

Each step does admission, one prefill chunk and one decode step; the one
host sync per decode step is the read of the sampled tokens, where the
host detects EOS / length-done and recycles slots.

The decode step follows ``fused_decode`` as in the JAX engine. The
default ("auto", also None/True) runs ``_fused_decode_step`` through the
registry: on CUDA per layer the single-launch ``decode_block_fused``
kernel where its predicate takes the shapes (at LLaMA-7B it does, where
the TPU's refuses), else the ``decode_attn_block`` and
``decode_mlp_block`` kernels (a two-stage predicate that refuses makes the
constructor raise with its reason); on the CPU the unfused composition;
``decode_variant`` says which. "block" forces the single-launch kernel
and "pallas" the two-stage kernels (both refused on the CPU), "ref" the
composition, False the unfused ``_paged_decode_step`` (RMSNorm in Triton,
paged attention in CUDA C++).
The prefill chunk follows ``fused_prefill`` the same way: the default
("auto", also None/True) runs the fused chunk on CUDA (a refusing
predicate makes the constructor raise) and the verbatim unfused chunk on
the CPU, where dispatch picks the composition, as the JAX engine does
off the TPU; "pallas" forces the fused chunk on the CUDA kernels (and is
refused on the CPU); "ref" and False run the verbatim chunk everywhere;
``prefill_variant`` says which. ``weight_quant`` ("int8"/"int4", or a
tree the PTQ harness already quantized) serves int8/int4 weights as the
JAX engine does: a plain tree is quantized once in the constructor, on
the engine's device; the fused routes run the kernels' quantized-weight
bodies, the unfused routes dequantize before each product;
``weight_quant_variant`` reports it. It composes with the int8 cache.
The prefix cache, host offload, observability and telemetry come with
later slices: their constructor arguments raise here.

THE DECODE PROGRAM (the JAX engine's ``_make_decode_fn``, one jitted step
a dispatch): the step's carried state is fixed buffers on the engine's
device (the next tokens, the lengths, the tables, the temperatures, the
logits), allocated once; a change on the host is copied into them, and
the step writes its next tokens and lengths back into them, as
``_DECODE_CARRY`` maps the JAX step's outputs to its arguments. On CUDA
the first decode step runs the step's body eagerly on a stream the engine
owns (the warm-up: kernels built, Triton compiled, the weight ring's
tickets and partials allocated for that stream), the second captures the
body as one CUDA graph and replays it, every later step replays it: one
``cudaGraphLaunch`` a step, sampling included (the engine's generator is
registered with the graph, so every replay draws fresh noise). On the
CPU the body runs eagerly over the same buffers. The graph is keyed by
the registry's force pins (``KERNELS.forced_state()``, in "auto" mode);
every other input of dispatch is fixed when the engine is built. A
replay adds the launches its capture made to the kernels' counts and
reports their plans to an active ``capture_kernel_launches``. A mesh
whose shards sit on more than one card is refused: one graph runs on
one card. Prefill chunks run eagerly.

``metrics()`` has the JAX engine's keys (observability off, one device)
plus ``decode_step_ms_mean``. ``decode_traces`` counts the decode
program's captures on CUDA (as ``jax.jit`` traces once: 1 an engine) and
its builds on the CPU (1); ``prefill_traces`` counts how often a bucket's
chunk route is resolved (at most 1 per bucket) and ``calibration_traces``
the int8 cache's calibrations (one an engine); the offload counters and
the spill and restore bytes stay 0 until the host tier is ported.
``roofline`` models each decode route's bytes a step against the H100's
memory rate (``observability/roofline.py``), with 1-byte pools for the
int8 cache.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import params_to
from ..ops.paged_attention import BlockManager, dequant_cache, quant_cache
from ..ops.rope import build_rope_cache
from ..quantization.ptq import (ensure_quantized, normalize_weight_quant,
                                weight_quant_mode)
from .admission import AdmissionQueue
from .generation import (GenerationConfig, _fused_decode_step,
                         _fused_mode, _fused_prefill_forward,
                         _fused_prefill_mode, _gumbel, _paged_decode_step)
from .tp import (ServingMesh, _tp_cached_forward, _tp_decode_step,
                 normalize_mesh)

__all__ = ["Request", "ServingEngine"]

_SCRATCH_SEQ = -1      # BlockManager key owning the reserved page 0


def _sample_slots(logits, generator, temps):
    """[C, V] logits -> [C] int32 next tokens. ``temps[i] <= 0`` selects
    greedy for that slot; otherwise temperature sampling (Gumbel-max
    with ``generator``)."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    noisy = (logits / torch.clamp(temps, min=1e-6)[:, None]
             + _gumbel(logits.shape, generator, logits.device))
    sampled = torch.argmax(noisy, dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)


def _graph_nodes(graph) -> int:
    """The node count of a captured CUDA graph (kept with ``keep_graph``),
    read through libcuda's ``cuGraphGetNodes``."""
    import ctypes
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return n.value


class _DecodeProgram:
    """One decode step as a program (the JAX engine's ``jax.jit`` of its
    step): ``body`` reads and writes only the engine's fixed buffers.

    On the CPU each call runs ``body``. On CUDA the first call runs it
    eagerly on the engine's ``stream`` (the warm-up, a real step: the
    kernels are built, Triton compiles, cuBLAS sets its workspace and the
    weight ring allocates its tickets and partials for that stream);
    :meth:`prepare` before the second call captures it on that stream as a
    CUDA graph with a memory pool of its own (the ring's tickets zeroed
    first, outside the graph; the engine's generator registered, so every
    replay draws fresh noise and capturing draws none), and every call
    from then on is one replay, on the caller's stream. Capturing runs no
    kernel, so it counts nothing: the launches and the plans its wrappers
    recorded are kept (``launches``, ``specs``) and added to the counts,
    and reported to an active ``capture_kernel_launches``, at each replay.
    A capture that fails raises with CUDA's error."""

    def __init__(self, body, device, stream, generator, counters):
        self.body = body
        self.device = device
        self._stream = stream
        self._gen = generator
        self._counters = counters
        self._warm = False
        self.graph = None
        self.replays = 0
        self.launches: Dict = {}       # what one replay launches
        self.specs: List = []          # the plans of those launches
        self.capture_s: Optional[float] = None
        self.nodes: Optional[int] = None
        self._keep: Tuple = ()         # the ring buffers the graph reads

    def prepare(self):
        """Capture the body once its warm-up has run (CUDA only)."""
        if self.graph is None and self._warm:
            self._capture()

    def __call__(self):
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            from ..ops import kernels
            from ..ops.kernels import _launch
            kernels.add_launches(self.launches)
            _launch.report(self.specs)
        elif self.device.type == "cuda":
            main = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(main)
            with torch.cuda.stream(self._stream):
                self.body()
            main.wait_stream(self._stream)
            self._warm = True
        else:
            self.body()

    def _capture(self):
        from ..ops import kernels
        from ..ops.kernels import _launch
        from ..ops.kernels.fused_decode_block import ring_buffers
        t0 = time.perf_counter()
        self._keep = ring_buffers(self.device, self._stream.cuda_stream)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.register_generator_state(self._gen)
        with kernels.launches_apart() as launches, \
                _launch.capture_kernel_launches(isolated=True) as specs:
            with torch.cuda.graph(graph, stream=self._stream):
                self.body()
        graph.instantiate()
        self.nodes = _graph_nodes(graph)
        self.graph, self.launches, self.specs = graph, launches, specs
        self.capture_s = time.perf_counter() - t0
        self._counters["decode_traces"] += 1


def _not_ported(arg: str, value, what: str):
    raise NotImplementedError(
        f"ServingEngine({arg}={value!r}): {what} is not ported yet; this "
        "engine runs the single-device fused and unfused routes")


@dataclass
class Request:
    """One serving request and its lifecycle record."""
    req_id: int
    prompt: np.ndarray                       # [S] int32
    gen: GenerationConfig
    submit_t: float = 0.0
    priority: int = 1                        # class, LOWER = more urgent
    deadline_s: Optional[float] = None       # admission SLO (vs submit)
    tokens: List[int] = field(default_factory=list)   # generated ids
    ttft: Optional[float] = None             # sec, first token - submit
    admit_t: Optional[float] = None          # absolute, engine clock
    first_token_t: Optional[float] = None    # absolute, engine clock
    finish_t: Optional[float] = None
    done: bool = False
    expired: bool = False                    # deadline passed in queue
    preemptions: int = 0
    # (seq_len, last sampled token): set while a preempted request holds
    # its KV pages but no slot; admission resumes decode from exactly
    # these values, so the resumed run is bit-identical
    resume: Optional[Tuple[int, int]] = None
    # the request's live admission-queue entry, reused by preemption's
    # requeue so the victim keeps its line position
    qentry: Optional[object] = field(default=None, repr=False)

    @property
    def output_ids(self) -> np.ndarray:
        """The prompt followed by the generated ids, int32."""
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.tokens, np.int32)])


class _Slot:
    __slots__ = ("req", "phase", "seq_len", "prefill_pos")

    def __init__(self):
        self.req: Optional[Request] = None
        self.phase = "idle"          # idle | prefill | decode
        self.seq_len = 0             # tokens cached in the pools
        self.prefill_pos = 0         # next prompt position to prefill


class ServingEngine:
    """Continuous-batching engine over a shared paged KV pool.

    ``submit()`` enqueues a request; ``step()`` runs one scheduler
    iteration (admit -> one prefill chunk -> one decode step over all
    live slots); ``drain()`` steps until idle. ``metrics()`` reports
    tokens/s, TTFT, decode-step time and slot utilization.

    ``device``: ``None`` runs on CUDA (and raises without a card);
    ``"cpu"`` runs the kernels' plain versions. ``params`` are moved to
    the device if they are not there already. ``fused_decode`` and
    ``fused_prefill`` pick the decode and the prefill route (module
    docstring); ``decode_variant`` and ``prefill_variant`` report them.
    ``mesh``: a :class:`~.tp.ServingMesh` (or an int tp over the visible
    cards); the engine's ``device`` is then shard 0's (a ``device`` that
    differs raises), ``params`` is the list of per-shard trees and the
    pools are per-shard lists.
    """

    def __init__(self, params: Dict, cfg, capacity: int = 4,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 max_seq_len: Optional[int] = None, cache_dtype=None,
                 prefill_buckets=(32, 128), seed: int = 0,
                 prefix_cache: bool = False, kv_offload=False,
                 observability=False, fused_decode=None, mesh=None,
                 fused_prefill=None, weight_quant=None,
                 aging_s: Optional[float] = None, telemetry=False,
                 clock=None, device=None):
        self._fused = _fused_mode(fused_decode)
        self._fused_prefill = _fused_prefill_mode(fused_prefill)
        self._mesh = normalize_mesh(mesh)
        # the fused chunk keeps running on a tp=1 "psum" mesh; tp > 1 and
        # the "gather" placement run the verbatim chunk, as in the JAX
        # engine (its contract, and no fused tensor-parallel prefill)
        self._prefill_mesh_ok = self._mesh is None or (
            self._mesh.tp == 1 and self._mesh.collective != "gather")
        if self._mesh is not None:
            self._check_mesh(cfg, normalize_weight_quant(weight_quant)
                             or weight_quant_mode(params))
        if prefix_cache or kv_offload:
            _not_ported("prefix_cache/kv_offload",
                        prefix_cache or kv_offload,
                        "the radix prefix cache and its host tier")
        if cache_dtype in ("int8", torch.int8):
            self._quant = True
        elif cache_dtype in (None, "bfloat16", "float32", torch.bfloat16,
                             torch.float32):
            self._quant = False
        else:
            raise ValueError(f"cache_dtype must be bfloat16|float32|int8,"
                             f" got {cache_dtype!r}")
        if observability or telemetry:
            _not_ported("observability/telemetry",
                        observability or telemetry,
                        "the observability and telemetry harness")
        if self._mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = self._mesh.devices[0]
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(
                    f"ServingEngine(device={device!r}) is not the mesh's "
                    f"shard 0 device {self.device}")
        for knob, mode in (("fused_decode", self._fused),
                           ("fused_prefill", self._fused_prefill)):
            if mode in ("pallas", "block") and self.device.type != "cuda":
                # a pin must never silently no-op: the CUDA kernels have no
                # CPU form (the JAX engine's rule for unhonourable pins)
                raise ValueError(
                    f'{knob}="{mode}" forces the CUDA kernels, which do '
                    f"not run on {self.device}; use 'auto' or 'ref' there")
        self._clock = clock if clock is not None else time.perf_counter
        # weight quantization (quantization/ptq.py): "int8"/"int4"
        # quantizes a plain tree once, on the engine's device; a quantized
        # tree rides as-is and None adopts its mode; a requested mode that
        # differs from the tree's raises
        self.params, self._wq = ensure_quantized(
            params_to(params, self.device), weight_quant)
        if self._mesh is not None:
            self.params = self._mesh.shard(
                self.params, self._mesh.param_specs(cfg, self.params))
        self.cfg = cfg
        self.capacity = int(capacity)
        self.block_size = int(block_size)
        self.max_seq_len = int(max_seq_len
                               or cfg.max_position_embeddings)
        if self.max_seq_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the rope table "
                f"bound max_position_embeddings "
                f"= {cfg.max_position_embeddings}")
        self.buckets = tuple(sorted({int(b) for b in prefill_buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError("prefill_buckets must be positive")
        BS = self.block_size
        # the chunk's dense view is MB*BS wide; the last chunk may pad
        # past max_seq_len by up to a bucket, so the table gets the slack
        self.max_blocks = -(-(self.max_seq_len + self.buckets[-1]) // BS)
        if num_blocks is None:
            num_blocks = self.capacity * (-(-self.max_seq_len // BS)) + 1
        self.num_blocks = int(num_blocks)

        L, KV, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                     cfg.head_dim)
        # the pool type follows the model unless the cache is int8, as in
        # the JAX package
        self._pool_dtype = torch.int8 if self._quant else cfg.dtype
        if self._mesh is None:
            shape = (L, self.num_blocks, BS, KV, hd)
            self._k_pools = torch.zeros(shape, dtype=self._pool_dtype,
                                        device=self.device)
            self._v_pools = torch.zeros(shape, dtype=self._pool_dtype,
                                        device=self.device)
        else:
            # one pool pair a shard, over its KV heads; page indices are
            # global, so the BlockManager below is the meshless one
            shape = (L, self.num_blocks, BS, KV // self._mesh.tp, hd)
            self._k_pools, self._v_pools = (
                [torch.zeros(shape, dtype=self._pool_dtype, device=d)
                 for d in self._mesh.devices] for _ in range(2))
        # (k_scale [L, KV], v_scale [L, KV]) f32 once calibrated, and each
        # shard's [L, KV_loc] slices on its device (one shard meshless)
        self._kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._shard_scales: Optional[List[Tuple[torch.Tensor,
                                                torch.Tensor]]] = None
        # decode reads rows < max_seq_len; a fused chunk slices rows
        # pos0..pos0+P-1, which the last, bucket-padded chunk of a long
        # prompt takes past max_position_embeddings (up to MB*BS)
        self._rope = build_rope_cache(
            max(self.max_blocks * BS, cfg.max_position_embeddings), hd,
            base=cfg.rope_theta, device=self.device)

        self.mgr = BlockManager(self.num_blocks, BS, self.max_blocks)
        # reserve physical page 0 as scratch: padded table entries (and
        # inactive decode slots) point there
        scratch = self.mgr.allocate(_SCRATCH_SEQ, 1)
        if scratch != [0]:
            raise RuntimeError("scratch must be page 0 (tables pad with 0)")

        C, MB = self.capacity, self.max_blocks
        self._slots = [_Slot() for _ in range(C)]
        self._queue = AdmissionQueue(aging_s=aging_s, clock=self._clock)
        # per-class queue-wait stats: cls -> [admitted, wait_ms_sum,
        # wait_ms_max]; slo = [with-deadline seen, attained]
        self._sched_cls: Dict[int, List[float]] = {}
        self._slo = [0, 0]
        self._requests: List[Request] = []
        self._next_id = 0
        self._slot_tables = np.zeros((C, MB), np.int32)
        # the decode program's inputs: fixed buffers on the device, each
        # with its host mirror (pinned on CUDA; the _h_* arrays are numpy
        # views of them), copied in when the host changes them (_dirty).
        # Mid-prefill slots keep table 0 / seq 0 here: their decode write
        # must hit scratch.
        pin = self.device.type == "cuda"
        shapes = {"tok": ((C,), torch.int32), "seq": ((C,), torch.int32),
                  "tables": ((C, MB), torch.int32),
                  "temps": ((C,), torch.float32)}
        self._host_carry = {k: torch.zeros(sh, dtype=dt, pin_memory=pin)
                            for k, (sh, dt) in shapes.items()}
        self._h_tok, self._h_seq, self._h_tables, self._h_temps = (
            self._host_carry[k].numpy() for k in shapes)
        self._d_tok, self._d_seq, self._d_tables, self._d_temps = (
            torch.zeros(sh, dtype=dt, device=self.device)
            for sh, dt in shapes.values())
        # the step's logits [C, V], in the model's type (sampled from here)
        self._d_logits = torch.zeros((C, cfg.vocab_size), dtype=cfg.dtype,
                                     device=self.device)
        self._dirty = True
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(seed))
        # the decode programs by key (_decode_key) and, on CUDA, the stream
        # their warm-up and capture run on
        self._decode_fns: Dict[Tuple, _DecodeProgram] = {}
        self._stream = (torch.cuda.Stream(self.device) if pin else None)
        # the JAX engine's counters; decode_traces counts the decode
        # program's captures (builds on the CPU), the other *_traces route
        # resolutions and calibrations (module docstring), the offload ones
        # stay 0 without a host tier
        self.counters = {
            "decode_traces": 0, "prefill_traces": {},
            "calibration_traces": 0, "decode_steps": 0,
            "prefill_chunks": 0, "prefill_tokens": 0,
            "prefill_pad_tokens": 0, "live_slot_steps": 0,
            "tokens_generated": 0, "requests_submitted": 0,
            "requests_completed": 0, "drain_truncations": 0,
            "preemptions": 0, "requeues": 0, "deadline_expired": 0,
            "offload_traces": 0, "kv_spill_bytes": 0,
            "kv_restore_bytes": 0,
        }
        # the decode and prefill variants, recorded when the decode program
        # is built and at the first fused chunk
        self._decode_variant: Optional[Dict] = None
        self._prefill_variant: Optional[Dict] = None
        self._decode_ms = 0.0          # summed decode-step time
        self._t_first = None
        self._t_last = None
        self._metrics_reset_t = None   # TTFTs from before this are warmup
        self.last_drain_truncated = False
        if self._fused:
            # on CUDA a kernel that refuses the shapes raises here, with
            # the predicate's reason, rather than at the first decode step
            self._resolve_variant()
        # which chunk each bucket runs; on CUDA "auto" raises here for a
        # bucket whose prefill kernel refuses the shapes
        self._fused_buckets = {P: self._prefill_fused_for(P)
                               for P in self.buckets}

    def _check_mesh(self, cfg, wq):
        """The refusals under a mesh, with their reasons: shards on more
        than one device (the decode step is one CUDA graph); and the JAX
        engine's: a quantized tree over tp > 1, a model the mesh cannot
        split, the "pallas" decode pin under "gather", the "block" pin
        under any mesh and the "pallas" prefill pin where the chunk cannot
        be fused."""
        sm = self._mesh
        if len(set(sm.devices)) > 1:
            raise ValueError(
                f"ServingEngine(mesh=...): shards on {len(set(sm.devices))}"
                " devices; the decode step is one CUDA graph, which runs on"
                " one card, and no collective spans cards yet (the "
                "multi-card backend, ROADMAP A10(b)/A11): colocate the "
                "shards on one device")
        if wq and sm.tp > 1:
            raise ValueError(
                f"ServingEngine(weight_quant={wq!r}) cannot shard"
                f" over tp={sm.tp} > 1: packed-int4 rows and "
                "per-channel scale trees need per-shard packing specs "
                "(named headroom) — run quantized serving single-device"
                " or on tp=1 groups")
        ok, reason = sm.supports(cfg)
        if not ok:
            raise ValueError(f"ServingEngine(mesh=...): {reason}")
        if sm.collective == "gather" and self._fused == "pallas":
            # the gather placement runs the exact composition by contract
            raise ValueError(
                'fused_decode="pallas" cannot be honored under '
                'collective="gather" — that placement runs the '
                "exact unfused composition (its bit-parity "
                'contract); use collective="psum" or drop the pin')
        if self._fused == "block":
            raise ValueError(
                'fused_decode="block" is single-device: the '
                "single-launch decode-block kernel runs outside "
                "shard_map — drop the mesh or the pin")
        if self._fused_prefill == "pallas" and not self._prefill_mesh_ok:
            raise ValueError(
                'fused_prefill="pallas" cannot be honored on this mesh'
                " — tensor-parallel (tp > 1) and gather-placement "
                "prefill run the unfused chunk by contract; use "
                'collective="psum" with tp=1 or drop the pin')

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """Host mirror -> device, as a copy (never aliasing the mirror,
        which the scheduler goes on mutating)."""
        return torch.from_numpy(np.array(x)).to(self.device)

    # -- public API ---------------------------------------------------
    def _alloc_tokens(self, req: Request) -> int:
        """Token span the engine allocates KV pages for: prompt plus
        generation."""
        return int(req.prompt.size) + int(req.gen.max_new_tokens)

    def submit(self, prompt, gen: Optional[GenerationConfig] = None,
               priority: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Enqueue one request. Admission happens inside ``step()``
        when a slot and enough KV pages are free, ordered by priority
        class (LOWER = more urgent; FIFO within a class, aging per
        ``aging_s``). A request still queued past ``deadline_s`` is
        rejected (``expired``), never admitted late. ``priority`` and
        ``deadline_s`` default from ``gen``."""
        gen = gen or GenerationConfig()
        if gen.top_k > 0 or gen.top_p < 1.0:
            raise NotImplementedError(
                "ServingEngine: per-request top-k/top-p is not supported;"
                " greedy and temperature sampling are")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        total = int(prompt.size) + int(gen.max_new_tokens)
        if total > self.max_seq_len:
            raise ValueError(
                f"prompt+max_new_tokens = {total} exceeds engine "
                f"max_seq_len = {self.max_seq_len}")
        if priority is None:
            priority = gen.priority
        if deadline_s is None:
            deadline_s = gen.deadline_s
        req = Request(self._next_id, prompt, gen, submit_t=self._clock(),
                      priority=int(priority), deadline_s=deadline_s)
        need = -(-self._alloc_tokens(req) // self.block_size)
        if need > self.num_blocks - 1:          # minus the scratch page
            raise ValueError(
                f"request needs {need} KV pages but the pool only has "
                f"{self.num_blocks - 1}; raise num_blocks")
        self._next_id += 1
        req.qentry = self._queue.push(req, cls=req.priority,
                                      submit_t=req.submit_t,
                                      deadline_s=deadline_s)
        self._requests.append(req)
        self.counters["requests_submitted"] += 1
        return req

    def step(self) -> bool:
        """One scheduler iteration: admit from the queue, run one
        prefill chunk (if an admission is in flight), then one decode
        step over all live slots. Returns True if any work ran,
        deadline expiries included."""
        if self._t_first is None:
            self._t_first = self._clock()
        expired = self._admit()
        did = self._run_prefill()
        did = self._run_decode() or did
        if did:
            self._t_last = self._clock()
        return did or expired > 0

    @property
    def idle(self) -> bool:
        return not self._queue and all(
            s.phase == "idle" for s in self._slots)

    @property
    def queue_depth(self) -> int:
        """Requests submitted but not yet admitted."""
        return len(self._queue)

    @property
    def live_slots(self) -> int:
        return sum(1 for s in self._slots if s.phase != "idle")

    def scheduler_snapshot(self) -> Dict:
        """Host-side scheduler state: queue depth, the first 16 queued
        requests, slot phases, per-slot seq_len, free pages (the JAX
        engine's, without its prefix-cache entry)."""
        return {
            "queue_depth": len(self._queue),
            "queued": [{"req_id": e.item.req_id,
                        "prompt_tokens": int(e.item.prompt.size),
                        "priority": e.item.priority,
                        "requeues": e.requeues,
                        "need_pages":
                            -(-self._alloc_tokens(e.item)
                              // self.block_size)}
                       for e in list(self._queue)[:16]],
            "slots": [{"slot": i, "phase": s.phase,
                       "req_id": s.req.req_id if s.req else None,
                       "seq_len": s.seq_len,
                       "prefill_pos": s.prefill_pos}
                      for i, s in enumerate(self._slots)],
            "pages_free": len(self.mgr.free),
            "num_blocks": self.num_blocks,
            "capacity": self.capacity,
        }

    def drain(self, max_steps: Optional[int] = None) -> int:
        """Step until queue and slots are empty; returns the step count.
        Hitting ``max_steps`` with work pending sets
        ``last_drain_truncated``; a step that can run nothing while
        requests wait raises."""
        n = 0
        self.last_drain_truncated = False
        while not self.idle:
            if not self.step():
                if self.idle:
                    break       # the last step only expired a request
                raise RuntimeError(
                    "engine starved: queued requests cannot be admitted "
                    "(KV pool too small for the in-flight mix?)")
            n += 1
            if max_steps is not None and n >= max_steps:
                if not self.idle:
                    self.last_drain_truncated = True
                    self.counters["drain_truncations"] += 1
                break
        return n

    def metrics(self) -> Dict:
        c = {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in self.counters.items()}
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        c["wall_time_s"] = round(wall, 6)
        c["tokens_per_sec"] = (round(c["tokens_generated"] / wall, 3)
                               if wall > 0 else 0.0)
        c["prefill_tokens_per_sec"] = (
            round(c["prefill_tokens"] / wall, 3) if wall > 0 else 0.0)
        # TTFTs from before the last reset_metrics() belong to the warmup
        cut = self._metrics_reset_t
        ttfts = [r.ttft for r in self._requests
                 if r.ttft is not None
                 and (cut is None or (r.first_token_t or 0.0) >= cut)]
        c["ttft_ms_mean"] = (round(float(np.mean(ttfts)) * 1e3, 3)
                             if ttfts else None)
        c["ttft_ms_max"] = (round(float(np.max(ttfts)) * 1e3, 3)
                            if ttfts else None)
        steps = c["decode_steps"]
        # on CUDA: device time between events around the step, read at
        # the step's own sync (host clock on the CPU)
        c["decode_step_ms_mean"] = (round(self._decode_ms / steps, 3)
                                    if steps else None)
        c["slot_utilization"] = (
            round(c["live_slot_steps"] / (steps * self.capacity), 4)
            if steps else 0.0)
        c["decode_variant"] = self.decode_variant
        c["prefill_variant"] = self.prefill_variant
        c["weight_quant_variant"] = self.weight_quant_variant
        c["roofline"] = self._roofline_metrics(c["decode_step_ms_mean"])
        c["scheduler"] = self._scheduler_metrics()
        if self._mesh is not None:
            c["mesh"] = self._mesh.describe()
        return c

    def reset_metrics(self):
        """Zero the throughput counters and timers (e.g. after a warm-up
        pass), as the JAX engine does. The trace counters are cumulative
        and stay; TTFTs of requests that got their first token before
        this call leave the mean."""
        for k in ("decode_steps", "prefill_chunks", "prefill_tokens",
                  "prefill_pad_tokens",
                  "live_slot_steps", "tokens_generated",
                  "requests_submitted", "requests_completed",
                  "drain_truncations", "preemptions", "requeues",
                  "deadline_expired", "kv_spill_bytes",
                  "kv_restore_bytes"):
            self.counters[k] = 0
        self._sched_cls = {}
        self._slo = [0, 0]
        self._decode_ms = 0.0
        self._t_first = self._t_last = None
        self._metrics_reset_t = self._clock()
        self._requests = [r for r in self._requests if not r.done]

    def _active_arm(self) -> str:
        """The roofline arm the decode step runs: the single-launch
        kernel, the two-stage kernels, or the composition."""
        v = self.decode_variant
        if v["block"] == "cuda_block":
            return "cuda_block"
        return "cuda_fused" if v["attn"] == "cuda_fused" else "unfused"

    def _roofline_metrics(self, step_ms) -> Dict:
        """Each decode route's modeled bytes a step (per layer times the
        layers, plus the lm-head read; one shard's dims under a mesh, as
        in the JAX engine) and the least step time at the H100's memory
        rate; for the active route on the card, the share of that rate
        the measured mean step time achieves (None on the CPU, whose clock
        says nothing of the card)."""
        from ..observability.roofline import (decode_roofline,
                                              decode_step_bytes)
        cfg = self.cfg
        tp = 1 if self._mesh is None else self._mesh.tp
        act = torch.empty((), dtype=cfg.dtype).element_size()
        pool = torch.empty((), dtype=self._pool_dtype).element_size()
        wbytes = {"int8": 1.0, "int4": 0.5}.get(self._wq or "", float(act))
        L = cfg.num_hidden_layers
        per_layer = decode_step_bytes(
            self.capacity, cfg.hidden_size, cfg.num_attention_heads // tp,
            cfg.num_key_value_heads // tp, cfg.head_dim,
            cfg.intermediate_size // tp,
            self.block_size, self.max_blocks, act_itemsize=act,
            weight_itemsize=wbytes, pool_itemsize=pool)
        head = cfg.vocab_size * cfg.hidden_size * act
        step_bytes = {k: int(v * L + head) for k, v in per_layer.items()}
        active = self._active_arm()
        measured = ({active: step_ms * 1e3}
                    if step_ms and self.device.type == "cuda" else {})
        r = decode_roofline(step_bytes, measured_us=measured)
        r["active"] = active
        r["layers"] = L
        return r

    def _resolve_variant(self) -> Dict:
        from ..ops.kernels.fused_decode_block import (decode_meta,
                                                      decode_meta_dims,
                                                      resolve_decode_blocks,
                                                      resolve_decode_step)
        sm, cfg = self._mesh, self.cfg
        if sm is None:
            meta = decode_meta(cfg, B=self.capacity, BS=self.block_size,
                               MB=self.max_blocks, pool_dtype=self._pool_dtype,
                               quant=self._quant, weight_dtype=self._wq,
                               device=self.device)
            _, _, _, names = resolve_decode_step(meta, self._fused)
            return {"mode": str(self._fused), **names}
        if sm.collective == "gather":
            # its contract is the single-device op sequence: always the
            # composition, whatever the knob says
            return {"mode": str(self._fused), "block": "composed",
                    "attn": "unfused", "mlp": "unfused"}
        # the per-shard shape class with tp in the meta, as
        # _tp_decode_step dispatches it: the two stages, per shard
        tp = sm.tp
        meta = decode_meta_dims(
            self.capacity, cfg.hidden_size, cfg.num_attention_heads // tp,
            cfg.num_key_value_heads // tp, cfg.head_dim,
            cfg.intermediate_size // tp, self.block_size, self.max_blocks,
            cfg.dtype, self._pool_dtype, self._quant, tp=tp,
            weight_dtype=self._wq, device=self.device)
        _, _, names = resolve_decode_blocks(meta, self._fused)
        return {"mode": str(self._fused), "block": "composed", **names}

    @property
    def decode_variant(self) -> Dict:
        """Which decode-block implementation the decode step runs:
        ``{"mode", "block", "attn", "mlp"}``: every name "cuda_block" for
        the single-launch kernel, else block "composed" and attn/mlp
        "cuda_fused" or "unfused". Recorded when the decode program is
        built (under the pins it is keyed by); before it, what dispatch
        would pick now."""
        if not self._fused:
            return {"mode": "unfused", "block": "composed",
                    "attn": "unfused", "mlp": "unfused"}
        if self._decode_variant is not None:
            return dict(self._decode_variant)
        return self._resolve_variant()

    def _prefill_meta(self, P: int) -> Dict:
        from ..ops.kernels.fused_prefill_block import prefill_meta
        return prefill_meta(self.cfg, P, self.block_size, self.max_blocks,
                            self._pool_dtype, quant=self._quant,
                            weight_dtype=self._wq, device=self.device)

    def _prefill_fused_for(self, P: int) -> bool:
        """Whether bucket ``P`` runs the fused chunk: ALL-OR-NOTHING, both
        prefill-block ops must resolve to the CUDA kernels; otherwise the
        verbatim unfused chunk runs. Never on a tp > 1 or "gather" mesh."""
        if not self._fused_prefill or not self._prefill_mesh_ok:
            return False
        from ..ops.kernels import fused_prefill_block
        return fused_prefill_block.prefill_fused_selected(
            self._prefill_meta(P), self._fused_prefill)

    def _resolve_prefill_variant(self, P: int) -> Dict:
        from ..ops.kernels.fused_prefill_block import resolve_prefill_blocks
        _, _, names = resolve_prefill_blocks(self._prefill_meta(P),
                                             self._fused_prefill)
        return {"mode": str(self._fused_prefill), **names}

    @property
    def prefill_variant(self) -> Dict:
        """Which prefill-chunk implementation the buckets run:
        ``{"mode", "attn", "mlp"}`` with attn/mlp "cuda_fused" or
        "unfused". Captured at the first fused chunk; before it, what
        dispatch would pick now for the largest bucket."""
        if not self._fused_prefill or not self._prefill_mesh_ok:
            return {"mode": "unfused", "attn": "unfused", "mlp": "unfused"}
        if self._prefill_variant is not None:
            return dict(self._prefill_variant)
        return self._resolve_prefill_variant(self.buckets[-1])

    @property
    def weight_quant_variant(self) -> Dict:
        """The weight class the decode step serves: ``{"mode": "off"}``
        for plain weights, else ``{"mode": "int8"|"int4", "weight_dtype":
        ..., "block": ..., "attn": ..., "mlp": ...}`` with the decode
        variants (:attr:`decode_variant`) that serve the quantized tree."""
        if not self._wq:
            return {"mode": "off"}
        v = self.decode_variant
        return {"mode": self._wq, "weight_dtype": self._wq,
                "block": v["block"], "attn": v["attn"], "mlp": v["mlp"]}

    def _scheduler_metrics(self) -> Dict:
        per = {str(cls): {
                   "admitted": int(st[0]),
                   "queue_wait_ms_mean": (round(st[1] / st[0], 3)
                                          if st[0] else 0.0),
                   "queue_wait_ms_max": round(st[2], 3)}
               for cls, st in sorted(self._sched_cls.items())}
        n, ok = self._slo
        return {"per_class": per,
                "slo_attainment": (round(ok / n, 4) if n else None),
                "slo_seen": int(n), "slo_attained": int(ok),
                "queue_depth": len(self._queue)}

    # -- scheduling ---------------------------------------------------
    def _temp_of(self, gen: GenerationConfig) -> float:
        return 0.0 if (gen.greedy or gen.temperature == 0.0) \
            else float(gen.temperature)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _admit(self) -> int:
        """Admit from the queue until blocked; returns the number of
        deadline expiries (scheduler progress the caller must count)."""
        now = self._clock()
        expired = self._queue.pop_expired(now)
        for entry in expired:
            self._expire(entry.item, now)
        while self._queue:
            entry = self._queue.best(now)
            req = entry.item
            # a slot first: idle, or a strictly lower-priority decode
            # victim (preempted only once the page check passes)
            slot_id = next((i for i, s in enumerate(self._slots)
                            if s.phase == "idle"), None)
            victim = None
            if slot_id is None:
                victim = self._preempt_candidate(req)
                if victim is None:
                    break
            if req.resume is None and not self._acquire_pages(req):
                # the line head is page-starved. Fresh requests may not
                # overtake it, but a RESUME entry allocates nothing and
                # holds pages whose release may be what the head waits
                # for, so the best resume entry admits instead
                entry = self._queue.best(
                    now, pred=lambda e: e.item.resume is not None)
                if entry is None:
                    break
                req = entry.item
                if slot_id is None:
                    victim = self._preempt_candidate(req)
                    if victim is None:
                        break
            if slot_id is None:
                slot_id = self._preempt(victim)
            self._queue.remove(entry)
            if req.resume is not None:
                self._admit_resume(slot_id, req, now)
                continue
            slot = self._slots[slot_id]
            if self._quant and self._kv_scales is None:
                # the static scales come from the first admitted prompt,
                # before any chunk or decode step reads the pools
                self._calibrate(req.prompt)
            table = self.mgr.allocate(req.req_id, self._alloc_tokens(req))
            slot.req = req
            slot.phase = "prefill"
            slot.seq_len = 0
            slot.prefill_pos = 0
            self._slot_tables[slot_id] = 0
            self._slot_tables[slot_id, :len(table)] = table
            self._record_admit(req)
        return len(expired)

    def _acquire_pages(self, req: Request) -> bool:
        """Page-availability check for a fresh admission (the JAX
        engine's no-prefix-cache branch: a free-list check)."""
        need = -(-self._alloc_tokens(req) // self.block_size)
        return len(self.mgr.free) >= need

    def _record_admit(self, req: Request):
        """Queue-wait stats per priority class and SLO attainment, at a
        request's first admission (a resume keeps the first)."""
        if req.admit_t is not None:
            return
        req.admit_t = self._clock()
        wait_ms = (req.admit_t - req.submit_t) * 1e3
        st = self._sched_cls.setdefault(req.priority, [0, 0.0, 0.0])
        st[0] += 1
        st[1] += wait_ms
        st[2] = max(st[2], wait_ms)
        if req.deadline_s is not None:
            self._slo[0] += 1
            if wait_ms <= req.deadline_s * 1e3:
                self._slo[1] += 1

    def _expire(self, req: Request, now: float):
        """Admission deadline passed while queued: reject, never admit
        late."""
        req.done = True
        req.expired = True
        req.finish_t = now
        self.counters["deadline_expired"] += 1
        if req.deadline_s is not None:
            self._slo[0] += 1       # a deadline seen and MISSED
        if req.req_id in self.mgr.tables:
            self.mgr.release(req.req_id)

    def _preempt_candidate(self, req: Request) -> Optional[int]:
        """The decode slot a waiting ``req`` may evict: the strictly
        lower-priority (HIGHER class) live decode slot, worst class
        first, latest-admitted within a class. Raw classes compare:
        aging promotes queue order, not the right to evict."""
        cand = [(s.req.priority, s.req.admit_t or 0.0, i)
                for i, s in enumerate(self._slots)
                if s.phase == "decode"]
        if not cand:
            return None
        cls, _, slot_id = max(cand)
        return slot_id if cls > req.priority else None

    def _preempt(self, slot_id: int) -> int:
        """Evict a decode slot: its KV pages stay attached and its
        decode carry (seq_len, last token) is saved on the request, which
        re-enters the queue at its original position."""
        slot = self._slots[slot_id]
        req = slot.req
        req.resume = (slot.seq_len, int(self._h_tok[slot_id]))
        req.preemptions += 1
        self.counters["preemptions"] += 1
        self.counters["requeues"] += 1
        self._queue.requeue(req.qentry)
        self._clear_slot(slot_id)
        return slot_id

    def _admit_resume(self, slot_id: int, req: Request, now: float):
        """Re-enter decode from the saved carry: the slot gets exactly
        the values the vacated slot held."""
        seq_len, tok = req.resume
        req.resume = None
        table = self.mgr.tables.get(req.req_id)
        if not table:
            raise RuntimeError(
                f"resume of request {req.req_id} without attached KV "
                "pages — preemption must retain the victim's pages")
        slot = self._slots[slot_id]
        slot.req = req
        slot.phase = "decode"
        slot.seq_len = seq_len
        slot.prefill_pos = int(req.prompt.size)
        self._slot_tables[slot_id] = 0
        self._slot_tables[slot_id, :len(table)] = table
        self._h_tok[slot_id] = tok
        self._h_seq[slot_id] = seq_len
        self._h_tables[slot_id] = self._slot_tables[slot_id]
        self._h_temps[slot_id] = self._temp_of(req.gen)
        self._dirty = True
        self._record_admit(req)

    def _dense_view(self, pool, table, scale):
        """A request's pages of one pool [L, N, BS, KV, hd] (a shard's,
        under a mesh) as a dense [L, 1, MB*BS, KV, hd] view at the model
        type: int8 pages dequantized with their [L, KV] ``scale``."""
        L, _, BS, KV, hd = pool.shape
        view = pool[:, table].reshape(L, 1, self.max_blocks * BS, KV, hd)
        return (view if scale is None
                else dequant_cache(view, scale).to(self.cfg.dtype))

    def _scatter_view(self, pool, table, view, scale):
        """``view`` back into ``pool`` through the table, in place (int8
        pools: quantized with ``scale`` first). Padded table entries are
        all page 0: those duplicate writes land on the scratch page, which
        nothing reads."""
        L, _, BS, KV, hd = pool.shape
        if scale is not None:
            view = quant_cache(view, scale)
        pool[:, table] = view.reshape(L, self.max_blocks, BS, KV, hd)

    def _shards(self):
        """(mesh, per-shard params, k pools, v pools): the engine's mesh,
        or, meshless, its one device as a one-shard "gather" mesh, whose
        op sequence is ``cached_forward``'s (equal bit for bit)."""
        if self._mesh is not None:
            return self._mesh, self.params, self._k_pools, self._v_pools
        return (ServingMesh((self.device,), collective="gather"),
                [self.params], [self._k_pools], [self._v_pools])

    def _prefill_chunk(self, toks, pos0, table, last_idx, temp):
        """One prefill chunk (the JAX engine's ``_make_prefill_fn_ref``
        program, and under a mesh ``_make_prefill_fn_tp``): each shard
        gathers the request's pages of its KV heads into a dense view
        (page indices are global; int8 pools dequantized to the model type
        with the shard's scales), ``_tp_cached_forward`` runs the
        placement over the views, each view is scattered back in place
        through the table (int8: quantized back first), and a token is
        sampled from row ``last_idx``."""
        sm, shards, k_pools, v_pools = self._shards()
        tables = sm.replicate(table)
        scales = self._shard_scales or [(None, None)] * sm.tp
        kcs = [self._dense_view(p, t, sc[0])
               for p, t, sc in zip(k_pools, tables, scales)]
        vcs = [self._dense_view(p, t, sc[1])
               for p, t, sc in zip(v_pools, tables, scales)]
        logits, _, _ = _tp_cached_forward(shards, toks, self.cfg, kcs, vcs,
                                          pos0, sm)
        for i, (t, sc) in enumerate(zip(tables, scales)):
            self._scatter_view(k_pools[i], t, kcs[i], sc[0])
            self._scatter_view(v_pools[i], t, vcs[i], sc[1])
        return _sample_slots(logits[:, last_idx], self._gen, temp)[0]

    def _prefill_chunk_fused(self, toks, pos0, table, n, temp):
        """One prefill chunk through the fused prefill-block ops (the JAX
        engine's ``_make_prefill_fn_fused`` program): straight over the
        pools, only the chunk's own K/V written, a token sampled from row
        ``n - 1``. ``table`` is int32 and serves as the write table too."""
        if self._prefill_variant is None:
            self._prefill_variant = self._resolve_prefill_variant(
                toks.shape[1])
        _, shards, kps, vps = self._shards()    # one shard (tp=1)
        logits, _, _ = _fused_prefill_forward(
            shards[0], toks[0], self.cfg, kps[0], vps[0], table, table,
            pos0, n, rope=self._rope, mode=self._fused_prefill,
            kv_scales=self._kv_scales)
        return _sample_slots(logits[n - 1:n], self._gen, temp)[0]

    def _run_prefill(self) -> bool:
        for slot_id, slot in enumerate(self._slots):
            if slot.phase != "prefill":
                continue
            req = slot.req
            S = req.prompt.size
            pos0 = slot.prefill_pos
            n = min(S - pos0, self.buckets[-1])
            P = self._bucket_for(n)
            toks = np.zeros((1, P), np.int64)
            toks[0, :n] = req.prompt[pos0:pos0 + n]
            temp = self._upload(np.array([self._temp_of(req.gen)],
                                         np.float32))
            traces = self.counters["prefill_traces"]
            if P not in traces:
                traces[P] = 1        # the bucket's chunk resolved once
            if self._fused_buckets[P]:
                tok = self._prefill_chunk_fused(
                    self._upload(toks), pos0,
                    self._upload(self._slot_tables[slot_id]), n, temp)
            else:
                tok = self._prefill_chunk(
                    self._upload(toks), pos0,
                    self._upload(self._slot_tables[slot_id].astype(
                        np.int64)), n - 1, temp)
            self.counters["prefill_chunks"] += 1
            self.counters["prefill_tokens"] += n
            self.counters["prefill_pad_tokens"] += P - n
            slot.prefill_pos += n
            if slot.prefill_pos == S:
                first = int(tok)             # syncs on the final chunk
                req.first_token_t = self._clock()
                req.ttft = req.first_token_t - req.submit_t
                req.tokens.append(first)
                self.counters["tokens_generated"] += 1
                slot.seq_len = S
                self._on_prefill_complete(slot_id, first)
            return True
        return False

    def _on_prefill_complete(self, slot_id: int, first: int):
        """Prompt prefilled and first token sampled: move the slot to
        decode, or finish on EOS / a one-token budget."""
        slot = self._slots[slot_id]
        req = slot.req
        if (first == req.gen.eos_token_id
                or req.gen.max_new_tokens <= 1):
            self._finish(slot_id)
        else:
            slot.phase = "decode"
            self._h_tok[slot_id] = first
            self._h_seq[slot_id] = slot.seq_len
            self._h_tables[slot_id] = self._slot_tables[slot_id]
            self._h_temps[slot_id] = self._temp_of(req.gen)
            self._dirty = True

    # -- the decode program ------------------------------------------
    # the JAX engine's decode step: (params, tok, seq_lens, tables, temps,
    # key, k_pools, v_pools) -> (tok, seq_lens, key, k_pools, v_pools).
    # Its carry, output index -> argument index, is here the buffer each
    # output is written into: the next tokens into tok's, the lengths into
    # seq_lens'; the pools are written in place and the key is the
    # generator, whose offset the step's draws advance
    _DECODE_CARRY = {0: 1, 1: 2, 2: 5, 3: 6, 4: 7}   # out idx -> argnum

    def _decode_args(self):
        pools = (self._k_pools, self._v_pools)
        return (self.params, self._d_tok, self._d_seq, self._d_tables,
                self._d_temps, self._gen) + pools

    def _decode_body(self):
        """The decode step over the fixed buffers: one token for every
        slot, sampled (into the logits buffer first), the carry written
        back as ``_DECODE_CARRY`` maps it. Inactive slots hold seq 0 and
        stay there; their write landed in scratch page 0."""
        args = self._decode_args()
        params, tok, seq, tables, temps, gen, k_pools, v_pools = args
        if self._mesh is not None:
            logits, k_pools, v_pools = _tp_decode_step(
                params, tok, self.cfg, k_pools, v_pools, tables, seq,
                self._mesh, rope=self._rope, kv_scales=self._shard_scales,
                fused=self._fused)
        elif self._fused:
            logits, k_pools, v_pools = _fused_decode_step(
                params, tok, self.cfg, k_pools, v_pools, tables, seq,
                rope=self._rope, mode=self._fused,
                kv_scales=self._kv_scales)
        else:
            logits, k_pools, v_pools = _paged_decode_step(
                params, tok, self.cfg, k_pools, v_pools, tables, seq,
                rope=self._rope, kv_scales=self._kv_scales)
        self._d_logits.copy_(logits)
        out = (_sample_slots(self._d_logits, gen, temps),
               torch.where(seq > 0, seq + 1, 0), gen, k_pools, v_pools)
        for o, a in self._DECODE_CARRY.items():
            if out[o] is not args[a]:
                args[a].copy_(out[o])

    def _decode_key(self) -> Tuple:
        """The decode program's key: the registry's force pins, which
        "auto" dispatch reads when the program is built. Nothing else that
        dispatch reads changes within an engine (shapes, types, weight and
        pool classes are fixed in the constructor)."""
        from ..ops.kernels.registry import KERNELS
        return KERNELS.forced_state() if self._fused == "auto" else ()

    def _make_decode_fn(self) -> _DecodeProgram:
        """The decode program (the JAX engine's ``_make_decode_fn``) of the
        current key; records the variant its dispatch picks, under the
        same pins. Counts a build in ``decode_traces`` on the CPU (on CUDA
        the program counts its capture)."""
        if self._fused:
            self._decode_variant = self._resolve_variant()
        if self.device.type != "cuda":
            self.counters["decode_traces"] += 1
        # the program must not keep its engine alive (the engine holds the
        # program): a cycle would keep the pools and the graph's memory
        # until the next full collection
        engine = weakref.ref(self)

        def body():
            engine()._decode_body()
        return _DecodeProgram(body, self.device, self._stream, self._gen,
                              self.counters)

    def _decode_program(self) -> _DecodeProgram:
        key = self._decode_key()
        prog = self._decode_fns.get(key)
        if prog is None:
            prog = self._decode_fns[key] = self._make_decode_fn()
        return prog

    def _upload_carry(self):
        """The host mirrors into the decode program's buffers (from pinned
        memory on CUDA, without a sync: no mirror changes before the
        step's token read, which syncs)."""
        for d, h in zip((self._d_tok, self._d_seq, self._d_tables,
                         self._d_temps), self._host_carry.values()):
            d.copy_(h, non_blocking=True)

    def _run_decode(self) -> bool:
        live = [i for i, s in enumerate(self._slots)
                if s.phase == "decode"]
        if not live:
            return False
        prog = self._decode_program()
        if self._dirty:
            self._upload_carry()
            self._dirty = False
        prog.prepare()
        if self.device.type == "cuda":
            ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            ev0.record()
            prog()
            ev1.record()
            nxt = self._d_tok.cpu().numpy()    # the per-step host sync
            self._decode_ms += ev0.elapsed_time(ev1)
        else:
            t0 = time.perf_counter()
            prog()
            nxt = self._d_tok.numpy().copy()
            self._decode_ms += (time.perf_counter() - t0) * 1e3
        self.counters["decode_steps"] += 1
        self.counters["live_slot_steps"] += len(live)
        for i in live:
            slot = self._slots[i]
            req = slot.req
            t = int(nxt[i])
            req.tokens.append(t)
            self.counters["tokens_generated"] += 1
            slot.seq_len += 1
            self._h_seq[i] = slot.seq_len
            self._h_tok[i] = t
            if (t == req.gen.eos_token_id
                    or len(req.tokens) >= req.gen.max_new_tokens):
                self._finish(i)
        return True

    def _calibrate(self, prompt: np.ndarray):
        """The int8 cache's static scales, from one prompt (the JAX
        engine's ``_calibrate``): its first tokens, at most the largest
        bucket, padded with token 0 to their bucket, through a dense
        forward at the model type (the placement's ``_tp_cached_forward``;
        meshless ``cached_forward``'s op sequence); per layer and KV head,
        ``max(absmax / 127, 1e-8)`` of the K and of the V rows written
        there, pad rows included. Each shard takes the absmax over its own
        KV heads, and the shards' scales concatenate to [L, KV] (under
        "gather" the meshless op sequence, so the meshless engine's
        scales)."""
        cfg = self.cfg
        self.counters["calibration_traces"] += 1
        P = self._bucket_for(min(int(prompt.size), self.buckets[-1]))
        n = min(int(prompt.size), P)
        toks = np.zeros((1, P), np.int64)
        toks[0, :n] = prompt[:n]
        toks = self._upload(toks)
        sm, shards, k_pools, _ = self._shards()
        shape = (cfg.num_hidden_layers, 1, P) + tuple(k_pools[0].shape[3:])
        kcs, vcs = ([torch.zeros(shape, dtype=cfg.dtype, device=d)
                     for d in sm.devices] for _ in range(2))
        _tp_cached_forward(shards, toks, cfg, kcs, vcs, 0, sm)

        def scale(c):
            div = torch.tensor(127.0, device=c.device)
            return torch.clamp_min(
                torch.amax(c.float().abs(), dim=(1, 2, 4)) / div, 1e-8)
        self._shard_scales = [(scale(kc), scale(vc))
                              for kc, vc in zip(kcs, vcs)]
        self._kv_scales = tuple(
            torch.cat([sc[j].to(self.device) for sc in self._shard_scales],
                      dim=1) for j in (0, 1))

    def _finish(self, slot_id: int):
        slot = self._slots[slot_id]
        req = slot.req
        req.done = True
        req.finish_t = self._clock()
        self.mgr.release(req.req_id)
        self._clear_slot(slot_id)
        self.counters["requests_completed"] += 1

    def _clear_slot(self, slot_id: int):
        """Vacate a slot WITHOUT touching the request's KV pages: the
        finish path releases them first; preemption keeps them."""
        slot = self._slots[slot_id]
        slot.req = None
        slot.phase = "idle"
        slot.seq_len = 0
        slot.prefill_pos = 0
        self._slot_tables[slot_id] = 0
        self._h_tok[slot_id] = 0
        self._h_seq[slot_id] = 0
        self._h_tables[slot_id] = 0
        self._h_temps[slot_id] = 0.0
        self._dirty = True          # vacated slot must not be written
