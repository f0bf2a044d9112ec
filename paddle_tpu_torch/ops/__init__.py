"""Operator-level services of the port: `guardian` (the numeric guard's
predicate, its lazy check queue and statistics, the fault injector, the
loss-scale transition of `amp.GradScaler`) and `numerics` (the per-op
checks of ``FLAGS_check_nan_inf`` and ``FLAGS_check_numerics``)."""
from . import guardian, numerics  # noqa: F401

__all__ = ["guardian", "numerics"]
