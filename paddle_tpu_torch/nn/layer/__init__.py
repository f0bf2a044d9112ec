from . import (activation, common, container, conv, norm,  # noqa: F401
               pooling, transformer)
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["activation", "common", "container", "conv", "norm", "pooling",
           "transformer", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", *activation.__all__,
           *common.__all__, *container.__all__, *conv.__all__,
           *norm.__all__, *pooling.__all__]
