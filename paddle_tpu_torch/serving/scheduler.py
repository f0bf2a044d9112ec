"""Continuous-batching request scheduler (iteration-level scheduling).

A copy of `paddle_tpu/serving/scheduler.py` (pure host Python): the port
keeps its own so that it imports nothing of the JAX package. `Request` and
`Scheduler` behave exactly as there, the prefix hook and the adapter and
chew fields included (serving/tenancy.py and the engine use them).

Reference analog: the reference serves through a pool of
`AnalysisPredictor` workers, one request per predictor run — batch
composition is frozen for a request's whole lifetime. This module is the
Orca (OSDI'22) iteration-level design instead: scheduling decisions happen
at TOKEN boundaries, so a request joins the running batch the moment a
slot and enough KV blocks are free, and leaves the moment it finishes —
no head-of-batch stragglers, no padding to the slowest tenant.

Policy (deliberately small and predictable):

  * **FCFS admission** — the waiting queue is ordered by arrival; only
    the head is considered (strict FCFS: no skipping past a big request
    to admit a small one, so no starvation).
  * **Free-block watermark** — a request is admitted only if, after
    taking its prompt's blocks, at least `watermark_blocks` remain free.
    The watermark is the growth reserve: running sequences allocate one
    block every `block_size` tokens, and growth ignores the watermark
    (the reserve exists exactly for it).
  * **Preempt-resume by block-table edit** — when growth finds the pool
    dry, the most recently admitted running request is evicted: its
    blocks return to the pool and the request rejoins the waiting queue
    at its original arrival position (FCFS preserved). Nothing is
    copied; resume re-prefills prompt + tokens generated so far
    (recompute-style preemption, the vLLM default) and continues
    token-identically.

Resilience policy (paired with serving/resilience.py):

  * **Deadlines/TTLs** — a request may carry an absolute deadline
    (monotonic ns). The scheduler never decides on wall time itself; it
    exposes the bookkeeping (`Request.expired`, `expired_waiting`) and
    the engine applies it at admission and at every iteration boundary.
  * **Bounded queue** — `max_queue_depth` caps the waiting queue; the
    engine turns a full queue into a structured `ServeRefusal`
    (`queue_full`) instead of queueing work that will expire unserved.
    `estimated_wait_steps` is the admission-time feasibility signal:
    a lower bound on decode steps before a new arrival gets a slot.
  * **Anti-starvation aging guard** — LIFO preemption alone can ping-pong
    one victim forever: a request that keeps being the newest admission
    is evicted every time the pool runs dry and never finishes. A request
    preempted `aging_max_preemptions` times becomes *protected*:
    `preempt_victim` skips protected requests, so its next admission is
    the one that sticks. When every candidate is protected the caller
    must stop evicting (grow fails / self-preempts) rather than starve.

The scheduler is pure host-side bookkeeping over integers — it owns no
device state and is unit-testable without a device. The engine
(serving/engine.py) asks it *who* runs; the block pool (serving/cache.py)
says *where* their KV lives.
"""
from __future__ import annotations

import math
import time

__all__ = ["Request", "Scheduler", "QUEUED", "RUNNING", "FINISHED",
           "FAILED", "CANCELLED", "EXPIRED"]

QUEUED = "QUEUED"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
FAILED = "FAILED"
CANCELLED = "CANCELLED"   # client called cancel(request_id)
EXPIRED = "EXPIRED"       # deadline/TTL passed while queued or running


class Request:
    """One generation request's lifecycle state.

    `generated` accumulates output token ids (streamed through
    `on_token` as they land); `cached_len` is how many tokens of
    prompt+generated currently have KV in the pool (0 after a
    preemption — resume re-prefills). `blocks` is the request's block
    table: the ONLY thing admission/eviction edits.
    """

    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_token_id",
                 "on_token", "state", "generated", "blocks", "slot",
                 "cached_len", "arrival_seq", "admit_seq", "preemptions",
                 "error", "enqueue_ns", "first_token_ns", "finish_ns",
                 "deadline_ns", "cancel_requested", "admit_ns",
                 "last_token_ns", "token_ns", "adapter", "prefix_hit",
                 "chew", "temperature", "top_k", "top_p",
                 "repetition_penalty", "seed", "token_logprobs",
                 "alt_ids", "alt_logprobs")

    def __init__(self, rid, prompt, max_new_tokens, eos_token_id=None,
                 on_token=None, ttl_s=None, adapter=None,
                 temperature=0.0, top_k=0, top_p=1.0,
                 repetition_penalty=1.0, seed=None):
        self.rid = rid
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.on_token = on_token
        self.state = QUEUED
        self.generated = []
        self.blocks = []
        self.slot = None
        self.cached_len = 0
        self.arrival_seq = None
        self.admit_seq = None
        self.preemptions = 0
        self.error = None
        self.enqueue_ns = time.perf_counter_ns()
        self.first_token_ns = None
        self.finish_ns = None
        # latency accounting: first admission time (queue wait =
        # admit_ns - enqueue_ns) and per-token emission timestamps
        # (bounded by max_new_tokens) so a completed handle can report
        # its own TTFT / inter-token percentiles
        self.admit_ns = None
        self.last_token_ns = None
        self.token_ns = []
        # absolute deadline on the perf_counter_ns clock (None = no TTL);
        # checked by the ENGINE at admission and at iteration boundaries
        self.deadline_ns = (None if ttl_s is None
                            else self.enqueue_ns + int(ttl_s * 1e9))
        # set by engine.cancel(): honored immediately when the engine is
        # between steps, or by the next boundary sweep when the cancel
        # arrives from inside a streaming callback mid-step — the fixed
        # slot layout is only ever edited between decode steps
        self.cancel_requested = False
        # multi-tenant serving (the JAX package's serving/tenancy.py): the named
        # LoRA-style adapter this stream decodes under (None = base
        # weights); `prefix_hit` is the shared-prefix token count the
        # LAST admission aliased from the prefix cache (0 = cold), and
        # `chew` holds the un-prefilled suffix tokens a prefix-hit
        # admission still has to feed through the decode step one per
        # iteration before real sampling resumes
        self.adapter = adapter
        self.prefix_hit = 0
        self.chew = []
        # stochastic sampling (serving/sampling.py): per-request sampler
        # config (temperature=0 is greedy). `seed` is resolved by the
        # engine (crc32(rid) default), so the stream replays
        # byte-identically across preempt/resume. `token_logprobs` parallels
        # `generated` (None for tokens re-fed from chew/prefix, whose
        # logprob was never an output of the step that emitted them);
        # `alt_ids`/`alt_logprobs` hold the optional static-K top-k
        # alternative panels when the engine enables logprobs_topk.
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.repetition_penalty = float(repetition_penalty)
        self.seed = seed
        self.token_logprobs = []
        self.alt_ids = []
        self.alt_logprobs = []

    @property
    def context_len(self):
        """Tokens the model has consumed/produced so far (prompt +
        generated) — what a resume must re-prefill."""
        return len(self.prompt) + len(self.generated)

    @property
    def remaining_tokens(self):
        """Decode steps this request still wants (upper bound: eos may
        stop it earlier)."""
        return max(0, self.max_new_tokens - len(self.generated))

    @property
    def finished(self):
        return self.state in (FINISHED, FAILED, CANCELLED, EXPIRED)

    def expired(self, now_ns=None):
        """Deadline passed (False when the request carries no TTL)."""
        if self.deadline_ns is None:
            return False
        if now_ns is None:
            now_ns = time.perf_counter_ns()
        return now_ns >= self.deadline_ns

    def latency(self):
        """Per-request latency summary off the emission timestamps:
        TTFT (enqueue -> first token), queue wait (enqueue -> first
        admission), and inter-token p50/p99 over this request's own
        token stream. Valid any time; most useful on a completed
        handle. Times in milliseconds; None where not yet observed."""
        out = {
            "ttft_ms": (None if self.first_token_ns is None
                        else (self.first_token_ns - self.enqueue_ns)
                        / 1e6),
            "queue_wait_ms": (None if self.admit_ns is None
                              else (self.admit_ns - self.enqueue_ns)
                              / 1e6),
            "tokens": len(self.generated),
            "inter_token_p50_ms": None,
            "inter_token_p99_ms": None,
        }
        if len(self.token_ns) >= 2:
            gaps = sorted((b - a) / 1e6 for a, b in
                          zip(self.token_ns, self.token_ns[1:]))
            out["inter_token_p50_ms"] = gaps[len(gaps) // 2]
            out["inter_token_p99_ms"] = gaps[
                min(len(gaps) - 1, int(0.99 * len(gaps)))]
        return out

    def logprobs(self):
        """Per-token logprob summary, `latency()`-style: the sampled
        token's logprob under the RAW (pre-masking) distribution for each
        generated token, plus the optional top-k alternative panels when
        the engine was built with ``logprobs_topk > 0``. Entries are None
        for tokens re-fed from a prefix hit or crash resume (their
        emitting step's outputs no longer exist). Valid any time —
        streaming callbacks may read the live handle mid-flight."""
        return {
            "token_logprobs": list(self.token_logprobs),
            "topk_ids": [None if a is None else list(a)
                         for a in self.alt_ids],
            "topk_logprobs": [None if a is None else list(a)
                              for a in self.alt_logprobs],
        }

    def ttl_remaining_s(self, now_ns=None):
        """Seconds until the deadline (None without one; may be <= 0).
        Serialized into crash-resume snapshots so a restored request
        re-arms RELATIVE time — the monotonic clock does not survive a
        process."""
        if self.deadline_ns is None:
            return None
        if now_ns is None:
            now_ns = time.perf_counter_ns()
        return (self.deadline_ns - now_ns) / 1e9


class Scheduler:
    """FCFS + watermark admission + preempt-resume over `allocator`."""

    def __init__(self, num_slots, allocator, block_size,
                 watermark_blocks=None, max_queue_depth=None,
                 aging_max_preemptions=3):
        self.num_slots = int(num_slots)
        self.allocator = allocator
        self.block_size = int(block_size)
        if watermark_blocks is None:
            # default growth reserve: one block per slot, bounded by 5%
            # of the pool — enough that a full batch can each cross a
            # block boundary once without an eviction storm
            watermark_blocks = min(self.num_slots,
                                   max(1, allocator.capacity // 20))
        self.watermark_blocks = int(watermark_blocks)
        # bounded-queue backpressure: None = unbounded (library default;
        # a production deployment should size this against its SLO)
        self.max_queue_depth = (None if max_queue_depth is None
                                else int(max_queue_depth))
        # aging guard: preemptions a request absorbs before it becomes
        # protected from further eviction (see preempt_victim)
        self.aging_max_preemptions = int(aging_max_preemptions)
        self.waiting = []            # Requests, ordered by arrival_seq
        self.running = []            # admission order
        self.slots = [None] * self.num_slots
        self._arrivals = 0
        self._admissions = 0

    # -- sizing -------------------------------------------------------------
    def blocks_needed(self, num_tokens):
        """Blocks for `num_tokens` cached tokens plus the next write."""
        return max(1, math.ceil((num_tokens + 1) / self.block_size))

    def max_blocks_of(self, req):
        """Blocks the request needs at its longest (prompt fully decoded:
        the final generated token is returned but never written)."""
        peak = len(req.prompt) + req.max_new_tokens - 1
        return self.blocks_needed(peak)

    def block_budget(self):
        """Blocks a single request may ever hold: pool capacity minus the
        admission watermark (try_admit never hands out the reserve, so a
        request needing more than this could wait forever)."""
        return self.allocator.capacity - self.watermark_blocks

    def can_ever_fit(self, req, shared_blocks=0):
        """False when no amount of waiting/eviction can serve this
        request — its peak block need exceeds what admission will ever
        grant (capacity minus the watermark reserve). Refuse such a
        request at enqueue: strict FCFS would deadlock the whole queue
        behind it.

        `shared_blocks` is the prefix-cache aliasing credit:
        blocks the request would inherit by reference rather than
        allocate. The pre-aliasing math assumed exclusive ownership and
        would spuriously refuse a multi-tenant request whose private
        footprint fits fine once its shared system prompt is counted
        once — refcounted blocks cost the pool nothing extra."""
        return self.max_blocks_of(req) - int(shared_blocks) \
            <= self.block_budget()

    def queue_full(self):
        """The bounded waiting queue is at capacity (engine refuses with
        `queue_full` instead of enqueueing)."""
        return self.max_queue_depth is not None \
            and len(self.waiting) >= self.max_queue_depth

    def estimated_wait_steps(self, req=None):
        """Lower bound on decode steps before a NEW arrival gets a slot:
        every token still owed to requests ahead of it (running + the
        whole waiting queue), served `num_slots` at a time. Deliberately
        optimistic — it ignores preemption re-prefills and eos early
        stops cut it the other way — so a refusal on this bound
        (`deadline_infeasible`) is never pessimistic guessing."""
        ahead = sum(r.remaining_tokens for r in self.running) \
            + sum(r.remaining_tokens for r in self.waiting if r is not req)
        return math.ceil(ahead / max(1, self.num_slots))

    # -- queue --------------------------------------------------------------
    def enqueue(self, req):
        req.arrival_seq = self._arrivals
        self._arrivals += 1
        self.waiting.append(req)

    def remove_waiting(self, req):
        """Drop a queued request (cancel/expiry); no-op when absent."""
        try:
            self.waiting.remove(req)
        except ValueError:
            pass

    def expired_waiting(self, now_ns=None):
        """Queued requests whose deadline has passed (engine clears them
        at the iteration boundary before admission looks at the head —
        an expired head must never block FCFS admission of live work)."""
        if now_ns is None:
            now_ns = time.perf_counter_ns()
        return [r for r in self.waiting if r.expired(now_ns)]

    def _requeue(self, req):
        """Re-insert a preempted request by ORIGINAL arrival order."""
        req.state = QUEUED
        i = 0
        while i < len(self.waiting) \
                and self.waiting[i].arrival_seq < req.arrival_seq:
            i += 1
        self.waiting.insert(i, req)

    # -- admission ----------------------------------------------------------
    def try_admit(self, prefix_hook=None):
        """Admit the FCFS head if a slot is free and its context's blocks
        leave the watermark intact. Returns the Request (now RUNNING,
        blocks + slot assigned, KV not yet filled) or None.

        `prefix_hook(req) -> (shared_blocks, hit_tokens)` is the
        shared-prefix probe: it ACQUIRES (increfs) the longest cached
        block run matching the head's context, so admission only
        allocates the private remainder and the watermark check counts
        each refcounted block once. When admission then fails anyway
        (watermark / slot pressure) the acquired references are dropped
        symmetrically — the hook's incref and this free are the only
        two sides of the claim."""
        if not self.waiting:
            return None
        try:
            slot = self.slots.index(None)
        except ValueError:
            return None
        req = self.waiting[0]
        shared, hit = [], 0
        if prefix_hook is not None:
            shared, hit = prefix_hook(req)
        needed = max(0, self.blocks_needed(req.context_len) - len(shared))
        if self.allocator.num_free - needed < self.watermark_blocks:
            if shared:
                self.allocator.free(shared)     # undo the hook's claim
            return None
        blocks = self.allocator.allocate(needed)
        if blocks is None:
            if shared:
                self.allocator.free(shared)
            return None
        self.waiting.pop(0)
        req.blocks = list(shared) + blocks
        req.prefix_hit = hit
        req.slot = slot
        req.state = RUNNING
        req.admit_seq = self._admissions
        self._admissions += 1
        self.slots[slot] = req
        self.running.append(req)
        return req

    # -- growth / preemption ------------------------------------------------
    def grow(self, req):
        """Allocate one more block for `req`. Growth may dip into the
        watermark reserve — that is what it is for."""
        got = self.allocator.allocate(1)
        if got is None:
            return False
        req.blocks.extend(got)
        return True

    def protected(self, req):
        """The aging guard: a request preempted `aging_max_preemptions`
        times has paid its dues — it is never chosen as a victim again,
        so sustained LIFO preemption cannot starve it forever."""
        return req.preemptions >= self.aging_max_preemptions

    def preempt_victim(self, exclude=None):
        """The most recently admitted running request other than
        `exclude` (LIFO eviction: the newest tenant re-prefills, the
        oldest keeps its progress). Requests past the aging guard are
        skipped; when every candidate is protected this returns None and
        the caller must stop evicting (fail or self-preempt the grower)
        rather than override the guard."""
        cands = [r for r in self.running
                 if r is not exclude and not self.protected(r)]
        return max(cands, key=lambda r: r.admit_seq) if cands else None

    def preempt(self, req):
        """Evict: blocks back to the pool (a DECREF — shared prefix
        blocks survive for their other owners), KV forgotten
        (cached_len=0 — resume re-prefills context_len tokens), request
        back in the waiting queue at its arrival position."""
        self._detach(req)
        req.preemptions += 1
        req.cached_len = 0
        req.prefix_hit = 0
        req.chew = []
        self._requeue(req)

    def release(self, req):
        """A finished/failed request leaves the batch."""
        self._detach(req)

    def _detach(self, req):
        if req.blocks:
            self.allocator.free(req.blocks)
            req.blocks = []
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None
        if req in self.running:
            self.running.remove(req)

    # -- introspection ------------------------------------------------------
    @property
    def demand(self):
        """Requests that want a slot right now."""
        return len(self.running) + len(self.waiting)

    def info(self):
        return {
            "waiting": len(self.waiting),
            "running": len(self.running),
            "free_blocks": self.allocator.num_free,
            "shared_blocks": getattr(self.allocator, "num_shared", 0),
            "watermark_blocks": self.watermark_blocks,
            "max_queue_depth": self.max_queue_depth,
            "aging_max_preemptions": self.aging_max_preemptions,
            "slots": [r.rid if r is not None else None
                      for r in self.slots],
        }
