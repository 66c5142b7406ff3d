"""Models of the PyTorch/CUDA port: LLaMA, for serving and training."""
from . import llama  # noqa: F401
from .llama import (LLAMA_7B, LLAMA_TINY, LlamaConfig,  # noqa: F401
                    init_params, params_from_jax)

__all__ = ["llama", "LlamaConfig", "LLAMA_7B", "LLAMA_TINY",
           "init_params", "params_from_jax"]
