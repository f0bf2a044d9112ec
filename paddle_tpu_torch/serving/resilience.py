"""Serving resilience: structured refusals, the hung-step watchdog, and
crash-resume payloads.

Counterpart of `paddle_tpu/serving/resilience.py`:

  * `ServeRefusal`: an admission refused with a machine-readable reason
    (a ValueError, so callers that catch ValueError keep working);
  * `StepHang`, `watchdog_budget_s` and `MonitoredWait`: a bounded wait on
    a decode or prefill step. The port's steps end in a CUDA event
    recorded behind the step's output copy; `MonitoredWait.wait` polls
    ``event.query()`` (never a blocking synchronize) against the
    ``FLAGS_serve_step_timeout_ms`` budget on the reference's schedule of
    two phases: back to back for the first 5 ms, then 1 ms sleeps, so a
    step that is merely slow costs no host core and a wedged one raises
    `StepHang` within the budget plus one poll interval. No waiter
    thread. The reference yields (``time.sleep(0)``) between its early
    polls so as not to slow XLA's compute threads on the same cores; here
    the step runs on the card, and on the H100's host a ``time.sleep(0)``
    took 19 us at the median: yielding polls added 0.17 ms to a 0.60 ms
    bf16 decode step, back-to-back ``event.query()`` polls (2 us each)
    nothing measurable (PERF.md §6). A kernel cannot be interrupted from the
    host: the wait gives up, the work stays queued on the device, and the
    engine's ladder decides what to do with it (`serving/engine.py`). On
    the CPU a step is done when it returns (no event): only the injected
    faults reach the ladder there. An injected ``hang``
    (`ops.guardian.inject_fault("hang", op="serve.decode")`) raises
    without burning time, so ``times=N`` hangs exactly N waits; ``stall``
    sleeps the real budget first;
  * `request_payload` / `payload_request`: a Request's resumable identity
    (prompt, emitted tokens, arrival order, remaining TTL, the adapter and
    the resolved sampler config, seed included) as a JSON-able dict, and
    back. Never device state: a restored stream re-prefills prompt +
    emitted tokens and continues byte-identically
    (`LLMEngine.state_payload` / `restore_state`,
    `incubate.checkpoint.ServeCheckpointer`).
"""
from __future__ import annotations

import time

from ..framework.flags import get_flags
from ..ops import guardian
from .scheduler import Request

__all__ = ["ServeRefusal", "StepHang", "MonitoredWait", "watchdog_budget_s",
           "request_payload", "payload_request"]


class ServeRefusal(ValueError):
    """Admission refused with a machine-readable reason (`queue_full` /
    `deadline_infeasible` / `kv_exhausted` / `sampler_mismatch` /
    `adapter_mismatch` / `torn_swap`); `detail` carries the numbers behind
    it. A ValueError, so callers that catch ValueError on admission keep
    working."""

    def __init__(self, reason, message, detail=None):
        super().__init__(message)
        self.reason = reason
        self.detail = dict(detail or {})


class StepHang(RuntimeError):
    """A monitored decode/prefill step blew the watchdog budget."""

    def __init__(self, phase, budget_ms, attempt):
        super().__init__(
            f"serving {phase} step exceeded the "
            f"FLAGS_serve_step_timeout_ms budget ({budget_ms} ms, "
            f"attempt {attempt})")
        self.phase = phase
        self.budget_ms = budget_ms
        self.attempt = attempt


def watchdog_budget_s():
    """The armed watchdog budget in seconds, or None when disarmed."""
    value = get_flags("FLAGS_serve_step_timeout_ms")[
        "FLAGS_serve_step_timeout_ms"]
    try:
        ms = float(value or 0)
    except (TypeError, ValueError):
        ms = 0.0
    return ms / 1e3 if ms > 0 else None


# a step still pending after this long is no longer latency-critical:
# millisecond sleeps from here on (before it, polls back to back)
_ESCALATE_S = 0.005
_COARSE_SLEEP_S = 0.001


class MonitoredWait:
    """Bounded wait on a step's completion event.

    ``wait(event, phase, attempt)`` returns once `event` (a
    `torch.cuda.Event`, or None for work that is already done) has
    completed, at once when the watchdog is disarmed (the caller then
    blocks on the event as before), or raises `StepHang` when the budget
    elapses first. An error the event reports (a fault in the step's
    kernels) propagates to the caller. `budget_s` fixes the budget
    (None: read ``FLAGS_serve_step_timeout_ms`` at each wait)."""

    def __init__(self, budget_s=None):
        self._budget_s = budget_s

    @property
    def budget_s(self):
        return (self._budget_s if self._budget_s is not None
                else watchdog_budget_s())

    @property
    def armed(self):
        return self.budget_s is not None

    def wait(self, event, phase, attempt=1):
        budget = self.budget_s
        if guardian.faults_armed():
            kind = guardian.poll_fault(f"serve.{phase}", ("hang", "stall"))
            if kind == "stall":
                # the wall-clock variant: the real budget passes first;
                # disarmed, a slow step that then returns
                time.sleep(budget if budget is not None
                           else _ESCALATE_S * 10)
                if budget is None:
                    return
                raise StepHang(phase, budget * 1e3, attempt)
            if kind is not None:
                raise StepHang(phase, (budget or 0) * 1e3, attempt)
        if budget is None or event is None:
            return
        start = time.perf_counter()
        deadline = start + budget
        escalate = start + min(_ESCALATE_S, budget / 2)
        while not event.query():
            now = time.perf_counter()
            if now >= deadline:
                raise StepHang(phase, budget * 1e3, attempt)
            if now >= escalate:
                time.sleep(_COARSE_SLEEP_S)


# ---------------------------------------------------------------------------
# crash-resume payloads
# ---------------------------------------------------------------------------

def request_payload(req, now_ns=None):
    """A Request's resumable identity as a JSON-able dict: what was asked
    and what has been emitted, never device state. A deadline travels as
    REMAINING seconds (the monotonic clock does not survive the
    process)."""
    return {
        "rid": req.rid,
        "prompt": list(req.prompt),
        "max_new_tokens": req.max_new_tokens,
        "eos_token_id": req.eos_token_id,
        "generated": list(req.generated),
        "arrival_seq": req.arrival_seq,
        "preemptions": req.preemptions,
        "ttl_remaining_s": req.ttl_remaining_s(now_ns),
        "adapter": req.adapter,
        # the resolved sampler config, seed included: (seed, prompt,
        # sampler) reproduces the stream, so a restored one continues at
        # the same draw positions
        "temperature": req.temperature,
        "top_k": req.top_k,
        "top_p": req.top_p,
        "repetition_penalty": req.repetition_penalty,
        "seed": req.seed,
    }


def payload_request(payload, on_token=None):
    """A QUEUED Request from `request_payload` output. Its emitted tokens
    ride in `generated`, so the first admission re-prefills prompt +
    generated and the stream continues where the dead process stopped.
    Callbacks do not serialize: the restoring caller passes `on_token`."""
    ttl = payload.get("ttl_remaining_s")
    req = Request(payload["rid"], payload["prompt"],
                  payload["max_new_tokens"],
                  eos_token_id=payload.get("eos_token_id"),
                  on_token=on_token,
                  ttl_s=max(0.0, ttl) if ttl is not None else None,
                  adapter=payload.get("adapter"),
                  temperature=payload.get("temperature", 0.0),
                  top_k=payload.get("top_k", 0),
                  top_p=payload.get("top_p", 1.0),
                  repetition_penalty=payload.get("repetition_penalty", 1.0),
                  seed=payload.get("seed"))
    req.generated = list(payload.get("generated") or [])
    # the logprobs of tokens emitted before the crash died with the
    # process: None keeps the panels aligned with `generated`
    req.token_logprobs = [None] * len(req.generated)
    req.alt_ids = [None] * len(req.generated)
    req.alt_logprobs = [None] * len(req.generated)
    req.preemptions = int(payload.get("preemptions") or 0)
    return req
