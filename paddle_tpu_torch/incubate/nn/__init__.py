from . import functional  # noqa: F401
from .fused_transformer import (  # noqa: F401
    FusedBiasDropoutResidualLayerNorm, FusedFeedForward, FusedLinear,
    FusedMultiHeadAttention, FusedMultiTransformer,
    FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedBiasDropoutResidualLayerNorm",
           "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedLinear"]
