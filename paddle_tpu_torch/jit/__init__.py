from .train_step import TrainStep  # noqa: F401

__all__ = ["TrainStep"]
