from . import lr  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import Adam, AdamW  # noqa: F401

__all__ = ["Optimizer", "Adam", "AdamW", "lr"]
