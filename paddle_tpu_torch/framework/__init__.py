from . import flags, io, random  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401
from .random import seed  # noqa: F401

__all__ = ["flags", "io", "random", "get_flags", "set_flags", "seed"]
