"""Models of the PyTorch/CUDA port: LLaMA, for serving and training; GPT,
BERT/ERNIE and ViT, for training. ``params_from_jax`` converts a JAX tree
of any of them (the layouts agree)."""
from . import bert, gpt, llama, vit  # noqa: F401
from ._common import params_from_jax  # noqa: F401
from .llama import (LLAMA_7B, LLAMA_TINY, LlamaConfig,  # noqa: F401
                    init_params)

__all__ = ["llama", "gpt", "bert", "vit", "LlamaConfig", "LLAMA_7B",
           "LLAMA_TINY", "init_params", "params_from_jax"]
