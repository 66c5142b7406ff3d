"""The port's ``incubate`` (counterpart of ``paddle_tpu/incubate``): so far
``nn.functional``'s fused attention block."""
from . import nn  # noqa: F401

__all__ = ["nn"]
