"""The numeric guard and the fault injector.

Counterpart of `paddle_tpu/ops/guardian.py`. Three parts:

The guard (``FLAGS_check_numerics``; `enabled`, `skip_step_enabled`).
Every optimizer's update computes one all-finite predicate over the
step's gradients and its new parameters and accumulators and applies the
update only where it holds, so a poisoned batch or an lr spike that
overflows the state is a bitwise no-op step (`optimizer.Optimizer`; on
the card the predicate is an int32 device flag that the guarded kernels
OR into and read, `kernels.finite_check`). ``FLAGS_check_nan_inf``, the
strict per-op debug mode (`ops.numerics`), takes precedence: with it set
the guard is off.

The lazy check queue. Device scalars that say whether something was
finite are queued per thread without a sync: a forward op's outputs
(`enqueue_fwd`, `observe`, from `ops.numerics`), a step's outcome
(`note_step`: the skip predicate, the loss's finiteness, whether the
loss scale held) and a loss-scale transition (`note_scaler`). At each
boundary (the end of `Optimizer.step`, `GradScaler.step`, a
`TrainStep` call) `maybe_flush` seals the queue into one batch (on the
card: the batch's scalars stacked and copied into pinned host memory
with ``non_blocking=True`` behind a CUDA event) and resolves the batches
whose event has completed, blocking only on those beyond
`_PIPELINE_DEPTH` batches in flight; `flush` resolves them all. A
non-finite forward output raises `FloatingPointError` at level 0 and
warns at level 1 or more, except on a thread where a `GradScaler` is
active (`mark_scaler_active`), where it is only counted: the scaler's
skip and backoff are the designed response to an overflow. Gradients
never raise: the skip already rescued the step. `guardian_stats()` has
the reference's seven counters. The reference's flight-recorder events
are not ported (ROADMAP.md Queue 1 item 6).

The fault injector, copied: `ChaosFault`, `inject_fault`,
`clear_faults`, `faults_armed`, `poll_fault`. The sites are the serving
engine's: ``serve.decode`` (a decode step's monitored wait and its
outputs) and ``serve.prefill`` (a prefill's monitored wait). The kinds:

  * ``hang``: the site behaves as if its device work never completed;
    the watchdog raises `StepHang` at once, without burning its budget
    (`serving.resilience.MonitoredWait`);
  * ``stall``: the same, after sleeping the real budget;
  * ``nan_output``: the decode step's outputs are poisoned: the engine
    discards the launch and finishes the running streams eagerly;
  * ``raise``: treated as ``nan_output`` at the decode site.

Injectors are process-wide, as in the reference: a test that arms one
clears them (`clear_faults`) when it is done. `update_scaler_state` is
the dynamic loss-scale transition `amp.GradScaler.update` runs on the
device.
"""
from __future__ import annotations

import threading
import warnings
from collections import deque

import torch

from ..framework.flags import _FLAGS

__all__ = ["mode", "enabled", "skip_step_enabled", "finite_all", "flush",
           "maybe_flush", "guardian_stats", "reset_guardian_stats",
           "reset_thread_state", "mark_scaler_active", "enqueue_fwd",
           "observe", "note_step", "note_scaler", "GUARD_STATS",
           "ChaosFault", "inject_fault", "clear_faults", "faults_armed",
           "poll_fault", "update_scaler_state", "KINDS"]

# queued scalars past this count are flushed at once, so a loop without
# boundaries cannot grow the queue
_MAX_QUEUE = 1024
# boundary batches left in flight before a resolve blocks: a finding
# surfaces at most this many boundaries late, and no boundary waits for
# the device's current work
_PIPELINE_DEPTH = 2


def mode():
    """The numeric check in force: "strict" for ``FLAGS_check_nan_inf``
    (it takes precedence), "check" for ``FLAGS_check_numerics`` (the
    guard), else None."""
    if _FLAGS["FLAGS_check_nan_inf"]:
        return "strict"
    return "check" if _FLAGS["FLAGS_check_numerics"] else None


def enabled():
    """Whether the guard is on: ``FLAGS_check_numerics`` set and
    ``FLAGS_check_nan_inf`` (the strict mode, which takes precedence)
    not."""
    return mode() == "check"


# the skip-step rescue rides the same flag
skip_step_enabled = enabled


def finite_all(vals):
    """One bool scalar: every element of every floating tensor of `vals`
    is finite (True, on the CPU, when none is floating). No sync."""
    fin = None
    for v in vals:
        if not v.is_floating_point():
            continue
        f = torch.isfinite(v).all()
        fin = f if fin is None else fin & f
    return torch.tensor(True) if fin is None else fin


# -- statistics ---------------------------------------------------------------

class GuardianStats:
    """The process-wide counters of the guard."""

    _KEYS = ("checks_enqueued", "flushes", "nonfinite_outputs",
             "steps_guarded", "steps_skipped", "scaler_backoffs",
             "faults_injected")

    def __init__(self):
        self.reset()

    def reset(self):
        for key in self._KEYS:
            setattr(self, key, 0)

    def snapshot(self):
        return {key: getattr(self, key) for key in self._KEYS}


GUARD_STATS = GuardianStats()


def guardian_stats():
    """``{counter: count}``: checks enqueued, flushes (batches sealed),
    non-finite forward outputs, steps guarded, steps skipped, loss-scale
    backoffs and faults injected."""
    return GUARD_STATS.snapshot()


def reset_guardian_stats():
    GUARD_STATS.reset()


# -- the lazy check queue ---------------------------------------------------

class _TLS(threading.local):
    def __init__(self):
        self.queue = deque()
        self.inflight = deque()     # sealed `_Batch`es, oldest first
        # set once an enabled GradScaler touches the thread (sticky)
        self.scaler_active = False


_tls = _TLS()


def reset_thread_state():
    """Drop the calling thread's queued checks, its batches in flight and
    its scaler mark (a test's isolation)."""
    _tls.queue.clear()
    _tls.inflight.clear()
    _tls.scaler_active = False


def mark_scaler_active():
    """Called by an enabled `GradScaler` (`scale`, `step`): from now on a
    non-finite forward output on this thread is counted, not raised."""
    _tls.scaler_active = True


def _enqueue(entry):
    GUARD_STATS.checks_enqueued += 1
    _tls.queue.append(entry)
    if len(_tls.queue) >= _MAX_QUEUE:
        flush()


def enqueue_fwd(name, finite):
    """Queue op `name`'s all-finite scalar (a bool tensor or a bool)."""
    _enqueue(("fwd", name, (finite,), None))


def observe(name, out_vals):
    """Queue the all-finite scalar of the floating tensors of `out_vals`
    (none: nothing is queued)."""
    vals = [v for v in out_vals
            if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if vals:
        enqueue_fwd(name, finite_all(vals))


def note_step(label, finite, fwd_finite=None, scale_before=None,
              scale_after=None, step_index=None):
    """Queue a guarded step's outcome: `finite` the skip predicate (False:
    the step was skipped), `fwd_finite` the loss's finiteness, and, with
    a loss scale folded into the step, the scale before and after it
    (a drop counts as a backoff); `step_index` the optimizer's step
    count at the decision. Never raises at resolve for the gradients."""
    held = None
    if scale_before is not None and scale_after is not None:
        held = torch.as_tensor(scale_after) >= torch.as_tensor(scale_before)
    GUARD_STATS.steps_guarded += 1
    _enqueue(("step", label, (finite, fwd_finite, held), step_index))


def note_scaler(scale_before, scale_after):
    """Queue an eager `GradScaler.update`'s transition: a scale that
    dropped is a backoff. The predicate is computed on the device now,
    so the tensors may change after the call."""
    _enqueue(("scaler", "grad_scaler",
              (torch.as_tensor(scale_after) >= torch.as_tensor(scale_before),),
              None))


class _Batch:
    """A sealed boundary's entries and their scalars' host values: numbers
    and CPU tensors read at once, each device's scalars stacked and copied
    into pinned host memory behind an event."""

    __slots__ = ("entries", "values", "pending")

    def __init__(self, entries):
        self.entries = entries
        scalars = [s for e in entries for s in e[2] if s is not None]
        self.values = [None] * len(scalars)
        self.pending = []
        on_device = {}
        for i, s in enumerate(scalars):
            if isinstance(s, torch.Tensor) and s.device.type == "cuda":
                on_device.setdefault(s.device, []).append(i)
            else:
                self.values[i] = bool(s)
        for device, idx in on_device.items():
            with torch.cuda.device(device):
                stacked = torch.stack([scalars[i].reshape(()) for i in idx])
                host = torch.empty(len(idx), dtype=torch.bool,
                                   pin_memory=True)
                host.copy_(stacked.to(torch.bool), non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            self.pending.append((event, host, idx))

    def ready(self):
        return all(event.query() for event, _, _ in self.pending)

    def host_values(self):
        """Every scalar's value (waits for the copies still in flight)."""
        for event, host, idx in self.pending:
            event.synchronize()
            for i, value in zip(idx, host.tolist()):
                self.values[i] = value
        self.pending = []
        return self.values


def _seal():
    q = _tls.queue
    if not q:
        return
    entries = list(q)
    q.clear()
    GUARD_STATS.flushes += 1
    _tls.inflight.append(_Batch(entries))


def maybe_flush():
    """The boundary hook: seal the queue into a batch and resolve every
    batch in flight whose copies have completed, blocking only on those
    beyond `_PIPELINE_DEPTH`. One truthiness check when nothing is
    queued."""
    if _tls.queue or _tls.inflight:
        _seal()
        _resolve_ready(block=False)


def flush():
    """Seal the queue and resolve every batch in flight, waiting for the
    device as needed (a loop's end, a test)."""
    _seal()
    _resolve_ready(block=True)


def _resolve_ready(block):
    inflight = _tls.inflight
    first_error = None
    while inflight:
        batch = inflight[0]
        if not block and len(inflight) <= _PIPELINE_DEPTH \
                and not batch.ready():
            break
        inflight.popleft()
        err = _resolve_batch(batch)
        if err is not None and first_error is None:
            first_error = err
    if first_error is not None:
        raise first_error


def _forward_finding(msg):
    """A non-finite forward output or loss: counted; raised at level 0
    (returned, so the caller resolves the rest first), warned at 1 or
    more, only counted on a thread with an active scaler."""
    GUARD_STATS.nonfinite_outputs += 1
    if _tls.scaler_active:
        return None
    if int(_FLAGS["FLAGS_check_numerics_level"]) == 0:
        return FloatingPointError(msg)
    warnings.warn(msg)
    return None


def _resolve_batch(batch):
    """Walk the batch's entries where any scalar is false; returns the
    first `FloatingPointError` to raise, or None."""
    values = batch.host_values()
    if all(values):
        return None
    first_error = None
    at = 0
    for kind, label, scalars, step_index in batch.entries:
        vals = []
        for s in scalars:
            if s is None:
                vals.append(True)
            else:
                vals.append(values[at])
                at += 1
        err = None
        if kind == "fwd":
            if not vals[0]:
                err = _forward_finding(
                    f"Operator '{label}' produced a non-finite output "
                    f"(FLAGS_check_numerics guard; set FLAGS_check_nan_inf "
                    f"to find the op synchronously)")
        elif kind == "scaler":
            if not vals[0]:
                GUARD_STATS.scaler_backoffs += 1
        else:
            finite, fwd_finite, held = vals
            if not finite:
                GUARD_STATS.steps_skipped += 1
            if not fwd_finite:
                where = "" if step_index is None else f" at step {step_index}"
                err = _forward_finding(
                    f"Fused step '{label}' produced a non-finite loss"
                    f"{where} (FLAGS_check_numerics guard; the skip left "
                    f"the parameters as they were; set FLAGS_check_nan_inf "
                    f"to find the op)")
            if not held:
                GUARD_STATS.scaler_backoffs += 1
        if err is not None and first_error is None:
            first_error = err
    return first_error


# -- fault injection ----------------------------------------------------------

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
        GUARD_STATS.faults_injected += 1
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
