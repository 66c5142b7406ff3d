"""A step as one program (the JAX package's ``jax.jit`` of a step): a
body that reads and writes only fixed buffers, run eagerly once on CUDA,
then captured as one CUDA graph and replayed.

The serving engine's decode step and its prefill chunk (one program a
bucket and route key, ``inference/serving.py``), ``generate_paged``'s
decode steps (``inference/generation.py``) and the trainer's step (one
program a signature and state, ``distributed/trainer.py``) are such
programs.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["Program", "graph_nodes"]


def graph_nodes(graph) -> int:
    """The node count of a captured CUDA graph (kept with ``keep_graph``),
    read through libcuda's ``cuGraphGetNodes``."""
    import ctypes
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return n.value


class Program:
    """``body`` (reading and writing only fixed buffers) as a program.

    On the CPU each call runs ``body``. On CUDA the first call runs it
    eagerly on ``stream`` (the warm-up, a real call: the kernels are
    built, Triton compiles, cuBLAS sets its workspace and the weight ring
    allocates its tickets and partials for that stream); :meth:`prepare`
    before the second call captures it on that stream as a CUDA graph (in
    the memory pool ``pool``, or one of its own; the ring's tickets zeroed
    first, outside the graph; ``generator``, when given, registered, so
    every replay draws fresh numbers and capturing draws none), and every
    call from then on is one replay, on the caller's stream. A capture
    runs no kernel, so it counts nothing: the launches and the plans its
    wrappers recorded are kept (``launches``, ``specs``), added to the
    counts and reported to an active ``capture_kernel_launches`` at each
    replay (through ``respec``, a call's own plans where they differ from
    the captured call's). ``all_threads``: the body launches on other
    threads too (a train step's backward runs on autograd's device
    thread), so the capture records every thread's plans, hidden from
    every other capture while it lasts, and CUDA's capture checks only
    the capturing thread ("thread_local"): another thread of the process
    (a prefetch thread pinning and copying the next batch) keeps working,
    while autograd's thread launches into the captured stream.
    ``on_capture`` is called once the graph is captured (the callers'
    trace counters). A capture that fails raises with CUDA's error."""

    def __init__(self, body, device, stream, generator,
                 on_capture: Optional[Callable[[], None]] = None, pool=None,
                 all_threads: bool = False):
        self.body = body
        self.device = device
        self._stream = stream
        self._gen = generator
        self._on_capture = on_capture
        self._pool = pool
        self._all_threads = all_threads
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

    def __call__(self, respec=None):
        """Run the program once. ``respec(spec)``: the plan a replayed
        launch has in this call (default: the captured call's)."""
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            from ..ops import kernels
            from ..ops.kernels import _launch
            kernels.add_launches(self.launches)
            if _launch.capturing():
                _launch.report(self.specs if respec is None
                               else [respec(s) for s in self.specs])
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
        if self._gen is not None:
            graph.register_generator_state(self._gen)
        with kernels.launches_apart() as launches, \
                _launch.capture_kernel_launches(
                    isolated=True, all_threads=self._all_threads) as specs:
            with torch.cuda.graph(
                    graph, pool=self._pool, stream=self._stream,
                    capture_error_mode=("thread_local" if self._all_threads
                                        else "global")):
                self.body()
        graph.instantiate()
        self.nodes = graph_nodes(graph)
        self.graph, self.launches, self.specs = graph, launches, specs
        self.capture_s = time.perf_counter() - t0
        if self._on_capture is not None:
            self._on_capture()
