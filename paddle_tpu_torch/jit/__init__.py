from .api import InputSpec, TranslatedLayer, load, save  # noqa: F401
from .train_step import TrainStep  # noqa: F401

__all__ = ["TrainStep", "InputSpec", "TranslatedLayer", "save", "load"]
