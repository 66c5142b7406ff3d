"""Serving data plane of the PyTorch/CUDA port: dense generation, the
paged decode step, the continuous-batching ServingEngine and its
tensor-parallel mesh."""
from .admission import AdmissionQueue
from .generation import (GenerationConfig, cached_forward, generate,
                         init_cache, sample_token)
from .serving import Request, ServingEngine
from .tp import ServingMesh

__all__ = ["GenerationConfig", "generate", "cached_forward", "init_cache",
           "sample_token", "Request", "ServingEngine", "ServingMesh",
           "AdmissionQueue"]
