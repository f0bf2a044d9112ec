from . import functional  # noqa: F401
from .fused_transformer import FusedBiasDropoutResidualLayerNorm  # noqa: F401

__all__ = ["functional", "FusedBiasDropoutResidualLayerNorm"]
