"""Fault injection: the chaos hooks the serving engine consults.

Counterpart of the fault-injection part of `paddle_tpu/ops/guardian.py`
(`ChaosFault`, `inject_fault`, `clear_faults`, `faults_armed`,
`poll_fault`), copied, and `update_scaler_state`, the dynamic loss-scale
transition `amp.GradScaler.update` runs on the device. The rest of the
reference's guardian (the numeric guard of the fused tiers,
``FLAGS_check_numerics`` and its statistics) belongs to ROADMAP Queue 1
item 5 and is not ported; nothing here dispatches operators, so only
`poll_fault` fires an injector.

The sites are the serving engine's: ``serve.decode`` (a decode step's
monitored wait and its outputs) and ``serve.prefill`` (a prefill's
monitored wait). The kinds:

  * ``hang``: the site behaves as if its device work never completed;
    the watchdog raises `StepHang` at once, without burning its budget
    (`serving.resilience.MonitoredWait`);
  * ``stall``: the same, after sleeping the real budget;
  * ``nan_output``: the decode step's outputs are poisoned: the engine
    discards the launch and finishes the running streams eagerly;
  * ``raise``: treated as ``nan_output`` at the decode site.

Injectors are process-wide, as in the reference: a test that arms one
clears them (`clear_faults`) when it is done.
"""
from __future__ import annotations

import torch

__all__ = ["ChaosFault", "inject_fault", "clear_faults", "faults_armed",
           "poll_fault", "update_scaler_state", "KINDS"]

KINDS = ("nan_output", "raise", "hang", "stall")


class ChaosFault(RuntimeError):
    """Deliberate mid-step failure raised by an injected fault hook."""


class _Injector:
    __slots__ = ("kind", "op", "after", "times", "seen", "fired")

    def __init__(self, kind, op, after, times):
        self.kind = kind
        self.op = op
        self.after = after
        self.times = times
        self.seen = 0
        self.fired = 0

    def remove(self):
        try:
            _INJECTORS.remove(self)
        except ValueError:
            pass


_INJECTORS: list = []


def inject_fault(kind, op=None, after=0, times=1):
    """Register a fault hook: `kind` one of `KINDS`, `op` the site's name
    (None: any site), fired after `after` matching polls, `times` times.
    Returns the injector; ``.remove()`` disarms it early."""
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r}")
    inj = _Injector(kind, op, int(after), int(times))
    _INJECTORS.append(inj)
    return inj


def clear_faults():
    del _INJECTORS[:]


def faults_armed():
    """Whether any injector is registered (one truthiness check when none
    is)."""
    return bool(_INJECTORS)


def poll_fault(name, kinds):
    """Fire the first armed injector matching site `name` with a kind in
    `kinds` and return its kind, or None. The caller implements the
    fault's semantics."""
    for inj in list(_INJECTORS):
        if inj.fired >= inj.times or inj.kind not in kinds:
            continue
        if inj.op is not None and inj.op != name:
            continue
        inj.seen += 1
        if inj.seen <= inj.after:
            continue
        inj.fired += 1
        return inj.kind
    return None


def update_scaler_state(scale, good, bad, found_inf, incr_ratio,
                        decr_ratio, incr_every_n_steps,
                        decr_every_n_nan_or_inf):
    """The dynamic loss-scale transition, the reference's
    (`paddle_tpu/ops/guardian.py` `update_scaler_state`), on device
    tensors: `scale` fp32, `good` and `bad` int32, `found_inf` bool, all
    0-d. Returns ``(scale, good, bad)`` after the step; nothing syncs."""
    bad2 = torch.where(found_inf, bad + 1, 0)
    good2 = torch.where(found_inf, 0, good + 1)
    shrink = found_inf & (bad2 >= decr_every_n_nan_or_inf)
    grow = ~found_inf & (good2 >= incr_every_n_steps)
    scale2 = torch.where(
        shrink, torch.clamp(scale * decr_ratio, min=1.0),
        torch.where(grow, scale * incr_ratio, scale))
    return (scale2, torch.where(grow, 0, good2),
            torch.where(shrink, 0, bad2))
