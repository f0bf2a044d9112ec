from .attention import (scaled_dot_product_attention,  # noqa: F401
                        paged_decode_attention)

__all__ = ["scaled_dot_product_attention", "paged_decode_attention"]
