"""Global flags of the port.

Counterpart of `paddle_tpu/framework/flags.py` (`set_flags` / `get_flags`),
holding only the flags the ported paths read, with the reference's
defaults:

- ``FLAGS_use_flash_attention`` (True): eligible attention goes through
  the flash kernels (`nn.functional.scaled_dot_product_attention`);
- ``FLAGS_use_fused_cross_entropy`` (False): `nn.functional.cross_entropy`
  routes 2-D logits with a vocabulary of at least 8192 through the fused
  cross-entropy kernels (`kernels.cross_entropy.is_eligible`);
- ``FLAGS_use_fused_layer_norm`` (True): eligible calls of
  `incubate.nn.functional.fused_bias_dropout_residual_layer_norm` go
  through the fused bias-residual LayerNorm kernel
  (`kernels.fused_ln.is_eligible`);
- ``FLAGS_serve_step_timeout_ms`` (0): the serving engine's hung-step
  watchdog budget for one decode or prefill step, in milliseconds; 0
  disarms it (`serving.resilience.watchdog_budget_s`);
- ``FLAGS_serve_attention_kernel`` ("blockwise"): the serving engine's
  paged attention variant when ``LLMEngine(attention_kernel=None)``, one
  of ``("pallas", "blockwise", "reference")``
  (`nn.functional.attention.resolve_paged_kernel`);
- ``FLAGS_check_numerics`` (False): the numeric guard (`ops.guardian`):
  every optimizer's update becomes a bitwise no-op where a gradient or
  the new state is not finite (the step count still advances), a
  `GradScaler` step never reads found-inf on the host, and each op's
  output is checked lazily (`ops.numerics`), a non-finite one raising
  `FloatingPointError` at the next step boundary;
- ``FLAGS_check_numerics_level`` (0): 0 raises on a non-finite forward
  output, 1 or more warns;
- ``FLAGS_check_nan_inf`` (False): the strict debug mode: every op's
  inexact outputs are checked with a host sync and a non-finite one
  raises naming the op (`ops.numerics`); it takes precedence over
  ``FLAGS_check_numerics``;
- ``FLAGS_check_nan_inf_level`` (0): 0 raises, 1 or more warns.

Flags are process-wide, as in the reference. Naming any other flag raises,
so a setting the port does not read never passes silently. Setting one of
the two check flags also turns the per-op check on or off for the calling
thread (`ops.numerics.sync_thread`).
"""
from __future__ import annotations

import threading

__all__ = ["set_flags", "get_flags"]

_lock = threading.Lock()
_FLAGS = {"FLAGS_use_flash_attention": True,
          "FLAGS_use_fused_cross_entropy": False,
          "FLAGS_use_fused_layer_norm": True,
          "FLAGS_serve_step_timeout_ms": 0,
          "FLAGS_serve_attention_kernel": "blockwise",
          "FLAGS_check_numerics": False,
          "FLAGS_check_numerics_level": 0,
          "FLAGS_check_nan_inf": False,
          "FLAGS_check_nan_inf_level": 0}


def _known(name):
    if name not in _FLAGS:
        raise ValueError(f"unknown flag {name!r}: the port has "
                         f"{sorted(_FLAGS)}")
    return name


def set_flags(flags: dict):
    """Set each ``{name: value}``; raises ValueError on an unknown name
    (and then sets none)."""
    for name in flags:
        _known(name)
    with _lock:
        _FLAGS.update(flags)
    if "FLAGS_check_numerics" in flags or "FLAGS_check_nan_inf" in flags:
        from ..ops import numerics
        numerics.sync_thread()


def get_flags(flags):
    """``{name: value}`` for a name or a list of names."""
    if isinstance(flags, str):
        flags = [flags]
    return {_known(name): _FLAGS[name] for name in flags}
