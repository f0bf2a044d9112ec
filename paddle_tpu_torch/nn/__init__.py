from . import clip, functional, initializer, layer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import (MultiHeadAttention, Transformer,  # noqa: F401
                    TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer)

__all__ = ["clip", "functional", "initializer", "layer",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]
