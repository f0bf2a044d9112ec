from . import models, nn  # noqa: F401

__all__ = ["models", "nn"]
