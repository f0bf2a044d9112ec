"""Per-op numeric checks: ``FLAGS_check_nan_inf`` and the forward checks of
``FLAGS_check_numerics``.

Counterpart of `paddle_tpu/ops/dispatch.py`'s `_scan_nan_inf` /
`_debug_checks` (the strict mode) and of the per-op all-finite scalar its
cached executables emit under the guard. The reference checks every op at
its one dispatch funnel; the port has no funnel, so two hooks take its
place:

- a `torch.utils._python_dispatch.TorchDispatchMode` (`_CheckMode`) that
  sees every aten op the thread runs and checks its floating outputs;
  views and ops whose outputs are uninitialised memory (`empty` and the
  like) are left out, and so is every op of a backward pass, as the
  reference checks forward outputs only;
- one `check` call in each kernel wrapper, where it counts its launch,
  for what the kernel wrote (a ctypes launch is no aten op).

So the op names a finding carries are aten's and the port's kernels' (for
example ``mm``, ``gelu``, ``flash_attention_fwd``), not Paddle's.

The modes:

- strict (``FLAGS_check_nan_inf``): each floating output is reduced and
  read on the host at once (one sync an output), and a non-finite one
  raises ``FloatingPointError("Operator '<name>' output contains
  NaN/Inf")`` at ``FLAGS_check_nan_inf_level`` 0 and warns at 1 or more;
- lazy (``FLAGS_check_numerics``, the guard on): one ``isfinite(x).all()``
  device scalar an op, queued with `guardian.enqueue_fwd` and resolved at
  the next step boundary (`guardian.maybe_flush`).

Both skip ops inside a CUDA graph capture (the graph carries its own
checks, as the reference drops the scalars of a trace) and ops inside
`suspended()`, which the optimizer's update, the `GradScaler` and a
`TrainStep`'s build and step run under: the reference's jitted update and
step are not dispatched ops either.

`framework.set_flags` calls `sync_thread` when either flag is named: the
calling thread enters the mode when one of the two is set and leaves it
when both are clear, so setting and clearing the flag is all it takes.
The mode is the thread's own (PyTorch keeps the dispatch-mode stack per
thread): another thread is not checked until it sets a flag itself.
"""
from __future__ import annotations

import contextlib
import threading
import warnings

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode)

from ..framework.flags import _FLAGS
from . import guardian

__all__ = ["check", "suspended", "sync_thread", "active"]

_aten = torch.ops.aten
# ops whose outputs are memory nobody has written yet
_UNWRITTEN = {_aten.empty, _aten.empty_like, _aten.empty_strided,
              _aten.new_empty, _aten.new_empty_strided, _aten.resize_,
              _aten.set_}


class _TLS(threading.local):
    def __init__(self):
        self.mode = None        # this thread's `_CheckMode`, when on
        self.quiet = 0          # depth of `suspended()`


_tls = _TLS()


def active():
    """Whether the calling thread checks ops now."""
    return _tls.mode is not None and not _tls.quiet


@contextlib.contextmanager
def suspended():
    """No op of the calling thread is checked inside."""
    _tls.quiet += 1
    try:
        yield
    finally:
        _tls.quiet -= 1


def _floating(out):
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _floating(o)]
    return []


def _capturing(tensors):
    return any(t.is_cuda for t in tensors) and \
        torch.cuda.is_current_stream_capturing()


def check(name, *outputs):
    """Check op `name`'s floating `outputs` under the thread's mode (see
    the module docstring); nothing when the thread does not check, in a
    backward pass or while a CUDA graph is captured."""
    if not active() or torch._C._current_autograd_node() is not None:
        return
    tensors = [t for t in _floating(outputs) if t.numel()]
    if not tensors or _capturing(tensors):
        return
    with suspended():
        if _FLAGS["FLAGS_check_nan_inf"]:
            for t in tensors:
                if not bool(torch.isfinite(t).all()):
                    msg = f"Operator '{name}' output contains NaN/Inf"
                    if int(_FLAGS["FLAGS_check_nan_inf_level"]) == 0:
                        raise FloatingPointError(msg)
                    warnings.warn(msg)
        elif guardian.enabled():
            guardian.observe(name, tensors)


class _CheckMode(TorchDispatchMode):
    """Checks the outputs of every aten op the thread runs (`check`)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _tls.quiet and not func.is_view \
                and func.overloadpacket not in _UNWRITTEN:
            check(func.overloadpacket.__name__, out)
        return out


def sync_thread():
    """Enter the check mode on the calling thread when
    ``FLAGS_check_nan_inf`` or ``FLAGS_check_numerics`` is set, and leave
    it when neither is (`framework.set_flags` calls this)."""
    want = bool(_FLAGS["FLAGS_check_nan_inf"] or
                _FLAGS["FLAGS_check_numerics"])
    mode = _tls.mode
    if want and mode is None:
        mode = _CheckMode()
        mode.__enter__()
        _tls.mode = mode
    elif not want and mode is not None:
        if _get_current_dispatch_mode() is not mode:
            raise RuntimeError(
                "cannot turn the op checks off: a TorchDispatchMode entered "
                "after they were turned on is still active; leave it first")
        _tls.mode = None
        mode.__exit__(None, None, None)
