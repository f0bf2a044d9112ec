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
  (`nn.functional.attention.resolve_paged_kernel`).

Flags are process-wide, as in the reference. Naming any other flag raises,
so a setting the port does not read never passes silently.
"""
from __future__ import annotations

import threading

__all__ = ["set_flags", "get_flags"]

_lock = threading.Lock()
_FLAGS = {"FLAGS_use_flash_attention": True,
          "FLAGS_use_fused_cross_entropy": False,
          "FLAGS_use_fused_layer_norm": True,
          "FLAGS_serve_step_timeout_ms": 0,
          "FLAGS_serve_attention_kernel": "blockwise"}


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


def get_flags(flags):
    """``{name: value}`` for a name or a list of names."""
    if isinstance(flags, str):
        flags = [flags]
    return {_known(name): _FLAGS[name] for name in flags}
