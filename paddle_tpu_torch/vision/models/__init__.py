from .vit import (PatchEmbed, VisionTransformer, vit_b_16,  # noqa: F401
                  vit_l_16, vit_l_32)

__all__ = ["PatchEmbed", "VisionTransformer", "vit_b_16", "vit_l_16",
           "vit_l_32"]
