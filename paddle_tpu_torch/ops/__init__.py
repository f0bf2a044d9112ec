"""Operator-level services of the port. So far only the fault injector
(`guardian`), the serving engine's chaos hooks."""
from . import guardian  # noqa: F401

__all__ = ["guardian"]
