"""Serving data plane of the PyTorch/CUDA port: dense generation, the
paged decode step and the continuous-batching ServingEngine."""
from .admission import AdmissionQueue
from .generation import (GenerationConfig, cached_forward, generate,
                         init_cache, sample_token)
from .serving import Request, ServingEngine

__all__ = ["GenerationConfig", "generate", "cached_forward", "init_cache",
           "sample_token", "Request", "ServingEngine", "AdmissionQueue"]
