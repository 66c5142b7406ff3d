"""Serving data plane of the PyTorch/CUDA port: dense and paged
generation, the paged decode step, the continuous-batching ServingEngine,
its radix prefix cache and its tensor-parallel mesh."""
from .admission import AdmissionQueue
from .generation import (GenerationConfig, cached_forward, generate,
                         generate_paged, init_cache, sample_token)
from .prefix_cache import PagedKVCacheStore, PrefixCache
from .serving import Request, ServingEngine
from .tp import ServingMesh

__all__ = ["GenerationConfig", "generate", "generate_paged",
           "cached_forward", "init_cache", "sample_token", "Request",
           "ServingEngine", "ServingMesh", "PrefixCache",
           "PagedKVCacheStore", "AdmissionQueue"]
