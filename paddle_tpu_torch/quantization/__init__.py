from . import kv_cache  # noqa: F401

__all__ = ["kv_cache"]
