"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, for one NVIDIA
H100 (sm_90a).

It serves LLaMA through the same data plane as ``paddle_tpu``'s serving
routes -- model parameters, ops, paged KV cache and the
continuous-batching ``ServingEngine``, disaggregated into prefill and
decode groups or behind the fleet router -- and trains it on one device
(``models.llama.loss_fn``, ``distributed.Trainer``, its step one captured
CUDA graph a signature, driven by ``optimizer.lr``'s schedulers), runs the
attention functionals (``nn.functional``, ``incubate.nn.functional``),
with the TPU's Pallas kernels rewritten by hand for Hopper
(``ops/kernels/``). It imports ``torch``, never ``jax``, and nothing of
``paddle_tpu``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; on the
CPU every kernel is replaced by its plain PyTorch version. Kernels build
(nvcc) or compile (Triton) at their first launch, never at import.
"""
from . import (device, distributed, incubate, inference, models,  # noqa
               nn, ops, optimizer, quantization)
from .device import resolve_device  # noqa: F401

__all__ = ["device", "distributed", "incubate", "inference", "models",
           "nn", "ops", "optimizer", "quantization", "resolve_device"]
