from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .attention import (scaled_dot_product_attention,  # noqa: F401
                        paged_decode_attention)
from .common import channel_shuffle, dropout  # noqa: F401
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv
from .loss import cross_entropy  # noqa: F401
from .norm import (batch_norm, group_norm, instance_norm,  # noqa: F401
                   local_response_norm)
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling
from .vision import *  # noqa: F401,F403
from .vision import __all__ as _vision

__all__ = ["scaled_dot_product_attention", "paged_decode_attention",
           "cross_entropy", "dropout", "channel_shuffle", "batch_norm",
           "instance_norm", "group_norm", "local_response_norm",
           *_activation, *_conv, *_pooling, *_vision]
