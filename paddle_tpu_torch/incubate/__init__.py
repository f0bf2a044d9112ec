from . import checkpoint, models, nn  # noqa: F401
from .checkpoint import (EpochRange, ServeCheckpointer,  # noqa: F401
                         StepCheckpointer, train_epoch_range)

__all__ = ["checkpoint", "models", "nn", "ServeCheckpointer",
           "StepCheckpointer", "EpochRange", "train_epoch_range"]
