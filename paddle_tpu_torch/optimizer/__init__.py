from . import lr, regularizer  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                         AdamW, Lamb, Lars, Momentum, RMSProp)
from .regularizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Lamb", "Lars",
           "RMSProp", "Adagrad", "Adadelta", "Adamax", "L1Decay", "L2Decay",
           "lr", "regularizer"]
