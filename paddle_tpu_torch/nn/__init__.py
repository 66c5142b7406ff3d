"""The port's ``nn`` (counterpart of ``paddle_tpu/nn``): so far its
attention functionals and ``dropout`` (:mod:`.functional`)."""
from . import functional  # noqa: F401

__all__ = ["functional"]
