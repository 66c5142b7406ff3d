"""Optimizers (port of ``paddle_tpu/optimizer``): the learning-rate
schedulers. AdamW itself is the trainer's (``distributed/trainer.py``);
the JAX package's ``Optimizer`` classes wait for its tensor layer."""
from . import lr  # noqa: F401

__all__ = ["lr"]
