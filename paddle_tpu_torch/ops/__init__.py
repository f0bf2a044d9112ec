"""Operator-level services of the port. So far `guardian`: the fault
injector (the serving engine's chaos hooks) and the loss-scale transition
of `amp.GradScaler`."""
from . import guardian  # noqa: F401

__all__ = ["guardian"]
