from . import flags, io  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401

__all__ = ["flags", "io", "get_flags", "set_flags"]
