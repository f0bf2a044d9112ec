from . import clip, functional, initializer, layer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers

__all__ = ["clip", "functional", "initializer", "layer",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           *[name for name in _layers if name[0].isupper()]]
