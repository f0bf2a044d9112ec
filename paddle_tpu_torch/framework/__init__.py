from . import flags  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401

__all__ = ["flags", "get_flags", "set_flags"]
