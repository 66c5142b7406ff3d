"""Serving data plane of the PyTorch/CUDA port: dense and paged
generation, the paged decode step, the continuous-batching ServingEngine,
its radix prefix cache and its tensor-parallel mesh, disaggregated
prefill/decode serving and the prefix-aware fleet router."""
from .admission import AdmissionQueue
from .disagg import DisaggregatedEngine
from .fleet import ServingFleet
from .generation import (GenerationConfig, cached_forward, generate,
                         generate_paged, init_cache, sample_token)
from .prefix_cache import PagedKVCacheStore, PrefixCache
from .serving import Request, ServingEngine
from .tp import ServingMesh

__all__ = ["GenerationConfig", "generate", "generate_paged",
           "cached_forward", "init_cache", "sample_token", "Request",
           "ServingEngine", "ServingMesh", "PrefixCache",
           "PagedKVCacheStore", "AdmissionQueue", "DisaggregatedEngine",
           "ServingFleet"]
