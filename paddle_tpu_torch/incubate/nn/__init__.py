"""The port's ``incubate.nn``: :mod:`.functional`. The layers of
``paddle_tpu/incubate/nn/layers.py`` (FusedLinear, FusedMultiHeadAttention,
FusedMultiTransformer, ...) launch no kernel body that the functionals do
not, and are queued (ROADMAP A14(b)): naming one raises."""
from . import functional  # noqa: F401

__all__ = ["functional"]

_QUEUED_LAYERS = ("FusedLinear", "FusedDropoutAdd",
                  "FusedBiasDropoutResidualLayerNorm", "FusedFeedForward",
                  "FusedMultiHeadAttention", "FusedMultiTransformer",
                  "FusedTransformerEncoderLayer", "FP8Linear")


def __getattr__(name):
    if name in _QUEUED_LAYERS:
        raise NotImplementedError(
            f"incubate.nn.{name} is not ported yet (ROADMAP A14(b)); "
            "incubate.nn.functional.fused_multi_head_attention is")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
