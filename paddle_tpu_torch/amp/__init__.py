"""Automatic mixed precision: `auto_cast` (alias `amp_guard`), `decorate`
and `GradScaler`.

Counterpart of `paddle_tpu/amp/` (``auto_cast.py``, ``grad_scaler.py``).
"""
from .auto_cast import (BLACK_LIST, WHITE_LIST, amp_cast_inputs,  # noqa: F401
                        amp_guard, auto_cast, current_amp_state, decorate,
                        record_casts, suspended)
from .grad_scaler import GradScaler  # noqa: F401

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "WHITE_LIST", "BLACK_LIST", "amp_cast_inputs",
           "current_amp_state", "record_casts", "suspended"]
