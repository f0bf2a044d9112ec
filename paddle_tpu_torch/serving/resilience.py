"""Structured admission refusals.

Counterpart of `ServeRefusal` in `paddle_tpu/serving/resilience.py`. The
rest of that module (the hung-step watchdog, the eager fallback and the
crash-resume payloads) is not ported.
"""
from __future__ import annotations

__all__ = ["ServeRefusal"]


class ServeRefusal(ValueError):
    """Admission refused with a machine-readable reason (`queue_full` /
    `deadline_infeasible` / `kv_exhausted` / `sampler_mismatch`); `detail`
    carries the numbers behind it. A ValueError, so callers that catch
    ValueError on admission keep working."""

    def __init__(self, reason, message, detail=None):
        super().__init__(message)
        self.reason = reason
        self.detail = dict(detail or {})
