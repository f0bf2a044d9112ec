from . import clip, functional  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)

__all__ = ["clip", "functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue"]
