"""Build the port's CUDA C++ kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, for Hopper only (``sm_90a``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -I csrc -o lib<name>.so csrc/<name>.cu

The build runs at first use into ``paddle_tpu_torch/build/`` (listed in
``.gitignore``), in a directory named by a hash of the flags and of every
source under ``csrc/`` (headers included), so an edited kernel rebuilds
and an unchanged one loads at once; :func:`build` compiles several
sources at once, one nvcc process each, all started together. ptxas's
report (registers, shared memory, spills) is kept beside the library as
``lib<name>.log``. A failed build raises with nvcc's output.

A C launcher is bound by :func:`c_fn` from its argument types, the codes
of :data:`CTYPES` in order; the wrappers record the same codes in their
launch specs (``_launch.KernelLaunchSpec.calls``), which the gate's
``ARG_MISMATCH`` rule holds against the ``extern "C"`` declaration in the
source. The Triton kernels are built by :func:`triton_jit` at their first
launch. :func:`build_seconds` is the wall time spent building so far (nvcc
here, Triton's compiles at the first launch of each specialization in
``_launch.triton_run``): the observability harness's ``compile`` entry.
:data:`DTYPES` is the types every kernel takes, with the code the
C launchers read. Nothing here runs at import: this module imports without
nvcc, Triton, CUDA or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "DTYPES", "CTYPES",
           "nvcc_path", "library_path", "build", "load", "c_fn", "c_codes",
           "triton_jit", "build_seconds", "add_build_seconds"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the kernels' element types and the C launchers' ``dtype`` code of each
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: a C launcher's argument types: pointer, int, long long, float
CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
          "f": ctypes.c_float}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, object] = {}
_BUILD_S = [0.0]          # seconds spent building kernels in this process


def build_seconds() -> float:
    """Wall seconds this process has spent building kernels: nvcc
    (:func:`build`) and Triton's compiles at first launch."""
    return _BUILD_S[0]


def add_build_seconds(seconds: float):
    _BUILD_S[0] += seconds


def nvcc_path() -> str:
    """nvcc from ``$CUDA_HOME``, the ``PATH`` or ``/usr/local/cuda``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, "
        "/usr/local/cuda/bin): the port's CUDA kernels build on the "
        "machine with the card")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library lives for the current sources."""
    return BUILD_DIR / _digest() / f"lib{name}.so"


def build(names):
    """Compile every ``csrc/<name>.cu`` of ``names`` whose library is
    missing: one nvcc process per source, all started together, then wait
    for all of them. Raises with nvcc's output of each source that
    failed."""
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        log = out.with_name(f".{out.name}.{os.getpid()}.log")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        jobs.append((name, out, tmp, log, proc))
    failed = []
    for name, out, tmp, log, proc in jobs:
        rc = proc.wait()
        text = log.read_text()
        log.unlink()
        if rc != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for csrc/{name}.cu (exit {rc}):\n"
                          f"{text}")
            continue
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)            # atomic: readers never see a part
    if jobs:
        add_build_seconds(time.perf_counter() - t0)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s library, built first if needed; loaded once
    per process."""
    lib = _LIBS.get(name)
    if lib is None:
        out = library_path(name)
        if not out.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(out))
    return lib


def c_codes(nptr, nint, nfloat):
    """The argument codes of a launcher taking ``nptr`` pointers, ``nint``
    ints and ``nfloat`` floats, then the dtype code and the stream."""
    return ("p",) * nptr + ("i",) * nint + ("f",) * nfloat + ("i", "p")


def c_fn(source, name, codes):
    """The C launcher ``name`` of ``csrc/<source>.cu``, bound once with the
    ctypes argument types of ``codes`` (:data:`CTYPES`) and an int return
    (a cudaError_t); ``.error_string(err)`` is the library's
    ``cuda_error_string``."""
    fn = _FNS.get((source, name, codes))
    if fn is None:
        lib = load(source)
        fn = getattr(lib, name)
        fn.argtypes = [CTYPES[c] for c in codes]
        fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        fn.error_string = lib.cuda_error_string
        _FNS[(source, name, codes)] = fn
    return fn


def triton_jit(namespace, name):
    """``namespace[name]`` compiled by ``triton.jit``, once: cached in the
    module's ``_kernels``. Binds the module's ``tl`` to ``triton.language``
    first, which the kernels' bodies read. Pass the kernel module's
    ``globals()``."""
    cache = namespace["_kernels"]
    fn = cache.get(name)
    if fn is None:
        import triton
        import triton.language as tl
        namespace["tl"] = tl
        fn = cache[name] = triton.jit(namespace[name])
    return fn
