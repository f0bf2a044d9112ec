from .activation import gelu, relu  # noqa: F401
from .attention import (scaled_dot_product_attention,  # noqa: F401
                        paged_decode_attention)
from .loss import cross_entropy  # noqa: F401

__all__ = ["scaled_dot_product_attention", "paged_decode_attention",
           "cross_entropy", "relu", "gelu"]
