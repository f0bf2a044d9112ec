from . import functional  # noqa: F401

__all__ = ["functional"]
