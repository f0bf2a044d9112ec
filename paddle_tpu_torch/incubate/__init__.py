from . import checkpoint, models, nn  # noqa: F401
from .checkpoint import ServeCheckpointer  # noqa: F401

__all__ = ["checkpoint", "models", "nn", "ServeCheckpointer"]
