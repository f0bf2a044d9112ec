"""Continuous-batching serving engine over a paged KV cache, PyTorch port.

Counterpart of `paddle_tpu/serving/engine.py` (`ServeStats`, `LLMEngine`).
The host side is the reference's: iteration-level FCFS scheduling with a
free-block watermark (serving/scheduler.py), LIFO preempt-resume by
block-table edits, bucketed prefill, streaming `on_token` callbacks,
deadlines, cancellation and structured refusals. Host state stays in
numpy: the fixed slot layout ``tokens [S]``, ``tables [S, M]``,
``lens [S]``, ``active [S]`` and the per-slot sampler config.

The device side runs eagerly on ``device``: the only device state is the
two pools ``[L, num_blocks, block_size, H, D]``, which every prefill and
decode step edits in place. A prefill runs the prompt (right-padded to a
power-of-two bucket) through the model's dynamic-cache path — causal
attention through the flash kernel — and scatters its K/V into the pools;
a decode step runs one token per slot through the paged path — the paged
kernel in every layer — and samples the next tokens.

Left out of the port, and refused with NotImplementedError when a
constructor argument asks for them: tenancy (prefix cache, adapters,
weight hot-swap), int8 KV, a kernel variant switch and pipelined decode.
The hung-step watchdog with its eager fallback, AOT warm start,
crash-resume and the telemetry plane are not ported either.
"""
from __future__ import annotations

import math
import time
from collections import deque

import numpy as np
import torch

from ..device import resolve_device
from .cache import PagedCacheView, PagedKVCache, scatter_prefill
from .resilience import ServeRefusal
from .sampling import default_seed, sample_tokens, validate_sampler
from .scheduler import (Request, Scheduler, RUNNING, FINISHED, FAILED,
                        CANCELLED, EXPIRED)

__all__ = ["LLMEngine", "ServeStats"]

# recent step-time samples averaged into the admission-time wait estimate
_EST_WINDOW = 32

_MIN_BUCKET = 8

# recent samples each latency percentile is read from
_SAMPLES = 4096


def _pct(samples, p):
    return float(np.percentile(np.asarray(samples), p)) if samples else 0.0


class ServeStats:
    """Engine counters + latency samples. Percentiles read the last
    `_SAMPLES` observations of each kind (bounded memory however long the
    engine runs). Times are host-clock seconds around work that ends in a
    device-to-host copy of the sampled tokens, so they include the
    device's time."""

    def __init__(self):
        self.reset()

    def reset(self):
        """Zero the counters and drop the samples (a fresh measurement
        window; the pools and the running requests are untouched)."""
        self.steps = 0
        self.tokens_generated = 0
        self.prefills = 0
        self.admitted = 0
        self.evictions = 0
        self.completed = 0
        self.failed = 0
        self.refused = 0
        self.refused_queue_full = 0
        self.refused_deadline = 0
        self.cancelled = 0
        self.expired = 0
        self.occupancy_sum = 0.0
        self.saturated_steps = 0
        self.saturated_occupancy_sum = 0.0
        self.sampled_tokens = 0
        # recent raw samples only (the admission wait estimate averages
        # the tail)
        self.step_times_s = []
        self.step_s = deque(maxlen=_SAMPLES)
        self.ttft_s = deque(maxlen=_SAMPLES)
        self.inter_token_s = deque(maxlen=_SAMPLES)
        self.queue_wait_s = deque(maxlen=_SAMPLES)
        self.prefill_s = {}          # bucket -> recent prefill times
        self.wall_t0 = None
        self.wall_t1 = None

    def observe_step(self, active, num_slots, demand, dt_s):
        self.steps += 1
        occ = active / num_slots
        self.occupancy_sum += occ
        if demand >= num_slots:
            self.saturated_steps += 1
            self.saturated_occupancy_sum += occ
        self.step_times_s.append(dt_s)
        if len(self.step_times_s) > 4 * _EST_WINDOW:
            del self.step_times_s[:-_EST_WINDOW]
        self.step_s.append(dt_s)

    def observe_prefill(self, bucket, dt_s):
        self.prefill_s.setdefault(bucket, deque(maxlen=_SAMPLES)).append(dt_s)

    def snapshot(self):
        elapsed = None
        if self.wall_t0 is not None and self.wall_t1 is not None:
            elapsed = self.wall_t1 - self.wall_t0
        return {
            "steps": self.steps,
            "tokens_generated": self.tokens_generated,
            "prefills": self.prefills,
            "admitted": self.admitted,
            "evictions": self.evictions,
            "completed": self.completed,
            "failed": self.failed,
            "refused": self.refused,
            "refused_queue_full": self.refused_queue_full,
            "refused_deadline": self.refused_deadline,
            "cancelled": self.cancelled,
            "expired": self.expired,
            "sampled_tokens": self.sampled_tokens,
            "occupancy_mean": (self.occupancy_sum / self.steps
                               if self.steps else 0.0),
            "occupancy_saturated": (
                self.saturated_occupancy_sum / self.saturated_steps
                if self.saturated_steps else 0.0),
            "p50_step_ms": _pct(self.step_s, 50) * 1e3,
            "p99_step_ms": _pct(self.step_s, 99) * 1e3,
            "ttft_p50_ms": _pct(self.ttft_s, 50) * 1e3,
            "ttft_p99_ms": _pct(self.ttft_s, 99) * 1e3,
            "inter_token_p50_ms": _pct(self.inter_token_s, 50) * 1e3,
            "inter_token_p99_ms": _pct(self.inter_token_s, 99) * 1e3,
            "queue_wait_p50_ms": _pct(self.queue_wait_s, 50) * 1e3,
            "queue_wait_p99_ms": _pct(self.queue_wait_s, 99) * 1e3,
            "prefill_p50_ms": {b: _pct(s, 50) * 1e3
                               for b, s in sorted(self.prefill_s.items())},
            "elapsed_s": elapsed,
            "tokens_per_sec": (self.tokens_generated / elapsed
                               if elapsed else 0.0),
        }


class LLMEngine:
    """Autoregressive serving over a GPT-family model
    (`paddle_tpu_torch.incubate.models.GPTForCausalLM`).

    Usage::

        engine = LLMEngine(model, max_batch_size=8, block_size=16)
        engine.add_request([1, 2, 3], max_new_tokens=32,
                           on_token=lambda req, tok, text: ...)
        while engine.step():
            pass                      # or engine.run()

    ``device=None`` means ``cuda`` and raises where there is no card; the
    model's parameters must already live on that device. Greedy decoding
    (temperature 0, the default) is exact; the pools take the model's
    parameter dtype.
    """

    def __init__(self, model, max_batch_size=8, block_size=16,
                 num_blocks=None, max_context=None, watermark_blocks=None,
                 tokenizer=None, max_queue_depth=None,
                 aging_max_preemptions=3, kv_dtype=None,
                 attention_kernel=None, enable_prefix_cache=False,
                 max_adapters=0, hot_swap=False, logprobs_topk=0,
                 pipeline_decode=False, device=None):
        asked = {"kv_dtype": kv_dtype is not None,
                 "attention_kernel": attention_kernel is not None,
                 "enable_prefix_cache": bool(enable_prefix_cache),
                 "max_adapters": bool(max_adapters),
                 "hot_swap": bool(hot_swap),
                 "pipeline_decode": bool(pipeline_decode)}
        unported = [name for name, on in asked.items() if on]
        if unported:
            raise NotImplementedError(
                f"paddle_tpu_torch's LLMEngine does not port {unported} "
                "(int8 KV, kernel variants, tenancy and pipelined decode "
                "stay in the JAX package for now)")
        device = resolve_device(device)
        param = next(model.parameters())
        if param.device.type != device.type or (
                device.index is not None
                and param.device.index != device.index):
            raise ValueError(f"model parameters live on {param.device}, "
                             f"the engine was asked for {device}")
        self.device = param.device
        cfg = model.config
        model.eval()
        self._model = model
        self._tokenizer = tokenizer
        self.max_batch_size = int(max_batch_size)
        self.block_size = int(block_size)
        self.max_context = int(max_context or cfg.max_position_embeddings)
        if self.max_context > cfg.max_position_embeddings:
            raise ValueError(
                f"max_context {self.max_context} exceeds the model's "
                f"max_position_embeddings {cfg.max_position_embeddings}")
        self.max_blocks_per_seq = math.ceil(self.max_context
                                            / self.block_size)
        if num_blocks is None:
            # default: every slot can reach max_context (+ null block)
            num_blocks = 1 + self.max_batch_size * self.max_blocks_per_seq
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.cache = PagedKVCache(cfg.num_hidden_layers,
                                  cfg.num_attention_heads, head_dim,
                                  num_blocks, self.block_size,
                                  dtype=param.dtype, device=self.device)
        self.scheduler = Scheduler(self.max_batch_size,
                                   self.cache.allocator, self.block_size,
                                   watermark_blocks,
                                   max_queue_depth=max_queue_depth,
                                   aging_max_preemptions=
                                   aging_max_preemptions)
        self._stats = ServeStats()
        # fixed slot-layout state every decode step consumes
        s, m = self.max_batch_size, self.max_blocks_per_seq
        self._tables = np.zeros((s, m), np.int32)
        self._lens = np.zeros(s, np.int32)
        self._active = np.zeros(s, bool)
        self._tokens = np.zeros(s, np.int32)
        # per-slot sampler config; the no-op values of a cleared slot keep
        # it on the greedy path
        self._logprobs_topk = int(logprobs_topk)
        self._temps = np.zeros(s, np.float32)
        self._topks = np.zeros(s, np.int32)
        self._topps = np.ones(s, np.float32)
        self._rpens = np.ones(s, np.float32)
        self._seeds = np.zeros(s, np.uint32)
        # per-slot context history for the repetition penalty; positions
        # <= lens are valid
        self._history = np.zeros((s, self.max_context), np.int32)
        self._k_pools = self.cache.k_pools
        self._v_pools = self.cache.v_pools
        self._next_rid = 0
        # rid -> Request: the id registry; terminal handles stay until the
        # caller drains them with pop_finished()
        self.requests = {}
        # True while step() edits the slot arrays: a cancel() from inside
        # a streaming callback then defers to the next boundary
        self._stepping = False

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def add_request(self, prompt_ids, max_new_tokens=16, request_id=None,
                    eos_token_id=None, on_token=None, ttl_s=None,
                    adapter=None, temperature=0.0, top_k=0, top_p=1.0,
                    repetition_penalty=1.0, seed=None):
        """Enqueue a generation request; returns the Request handle.

        ``temperature=0`` (the default) is greedy; otherwise `top_k`,
        `top_p` and `repetition_penalty` shape the distribution and `seed`
        (default: a stable hash of the request id) makes the stream replay
        byte-identically. `ttl_s` arms a deadline.

        Raises `ServeRefusal` (a ValueError) for doomed work:
        `sampler_mismatch`, `queue_full`, `kv_exhausted` (the peak KV
        footprint can never fit) or `deadline_infeasible`. Plain
        validation errors stay ValueError.
        """
        if adapter is not None:
            raise NotImplementedError(
                "adapters (multi-tenant serving) are not ported")
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        rid = request_id
        if rid is None:
            rid = f"r{self._next_rid}"
        self._next_rid += 1
        prev = self.requests.get(rid)
        if prev is not None and not prev.finished:
            raise ValueError(
                f"request id {rid!r} is already queued/running; ids may "
                "only be reused after the previous request finishes")
        req = Request(rid, prompt, max_new_tokens, eos_token_id, on_token,
                      ttl_s=ttl_s, temperature=temperature, top_k=top_k,
                      top_p=top_p, repetition_penalty=repetition_penalty,
                      seed=(default_seed(rid) if seed is None
                            else int(seed) & 0xFFFFFFFF))
        try:
            validate_sampler(temperature, top_k, top_p, repetition_penalty)
        except ValueError as e:
            self._refuse(req, "sampler_mismatch", f"request {rid}: {e}",
                         {"temperature": temperature, "top_k": top_k,
                          "top_p": top_p,
                          "repetition_penalty": repetition_penalty})
        if len(prompt) + req.max_new_tokens > self.max_context:
            raise ValueError(
                f"request {rid}: prompt ({len(prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_context "
                f"({self.max_context})")
        self._admission_policy(req)
        self.scheduler.enqueue(req)
        self.requests[rid] = req
        return req

    def _admission_policy(self, req):
        """Refuse-early backpressure, in cost order: queue depth, pool
        feasibility, deadline feasibility."""
        sched = self.scheduler
        if sched.queue_full():
            self._refuse(req, "queue_full",
                         f"request {req.rid}: waiting queue is at "
                         f"max_queue_depth ({sched.max_queue_depth}); "
                         "shed load upstream or add capacity",
                         {"queue_depth": len(sched.waiting),
                          "max_queue_depth": sched.max_queue_depth})
        peak = sched.max_blocks_of(req)
        budget = sched.block_budget()
        if not sched.can_ever_fit(req):
            self._refuse(req, "kv_exhausted",
                         f"request {req.rid}: needs {peak} KV blocks at "
                         f"peak but the pool only ever has {budget} "
                         f"(capacity {self.cache.allocator.capacity} - "
                         f"watermark {sched.watermark_blocks}); refuse "
                         "instead of deadlock",
                         {"blocks_needed": peak, "blocks_budget": budget})
        if req.deadline_ns is None:
            return
        remaining = req.ttl_remaining_s()
        if remaining <= 0:
            self._refuse(req, "deadline_infeasible",
                         f"request {req.rid}: deadline already expired "
                         "at enqueue",
                         {"ttl_remaining_s": round(remaining, 6)})
        times = self._stats.step_times_s
        if times:
            avg = sum(times[-_EST_WINDOW:]) / len(times[-_EST_WINDOW:])
            need_steps = sched.estimated_wait_steps(req) \
                + req.max_new_tokens
            est = need_steps * avg
            if est > remaining:
                self._refuse(
                    req, "deadline_infeasible",
                    f"request {req.rid}: estimated wait + service "
                    f"{est:.3f}s exceeds the remaining TTL "
                    f"{remaining:.3f}s; refusing now beats expiring "
                    "later",
                    {"estimated_s": round(est, 4),
                     "ttl_remaining_s": round(remaining, 4),
                     "est_steps": need_steps})

    def _refuse(self, req, reason, message, detail):
        self._stats.refused += 1
        if reason == "queue_full":
            self._stats.refused_queue_full += 1
        elif reason == "deadline_infeasible":
            self._stats.refused_deadline += 1
        raise ServeRefusal(reason, message, detail)

    def cancel(self, request_id):
        """Client cancellation: reclaim the stream's slot/KV. Between steps
        the request is cleared at once; a cancel from inside a streaming
        callback is deferred to the next boundary sweep. Returns True when
        the request was live."""
        req = self.requests.get(request_id)
        if req is None or req.finished:
            return False
        req.cancel_requested = True
        if self._stepping and req.slot is not None:
            return True          # boundary sweep picks it up next step
        self._cancel_now(req)
        return True

    def _cancel_now(self, req):
        slot = req.slot
        self.scheduler.remove_waiting(req)
        self.scheduler.release(req)
        if slot is not None:
            self._clear_slot(slot)
        req.state = CANCELLED
        req.error = "client_cancel"
        req.finish_ns = time.perf_counter_ns()
        self._stats.cancelled += 1

    def _expire(self, req):
        """Deadline passed while queued or running: clear the request."""
        slot = req.slot
        self.scheduler.remove_waiting(req)
        self.scheduler.release(req)
        if slot is not None:
            self._clear_slot(slot)
        req.state = EXPIRED
        req.error = "deadline_expired"
        req.finish_ns = time.perf_counter_ns()
        self._stats.expired += 1

    def _boundary_housekeeping(self):
        """Honor deferred cancels, then expire queued requests (an expired
        head must never block FCFS admission) and running ones."""
        sched = self.scheduler
        for req in [r for r in list(sched.waiting) + list(sched.running)
                    if r.cancel_requested]:
            self._cancel_now(req)
        now = time.perf_counter_ns()
        for req in sched.expired_waiting(now):
            self._expire(req)
        for req in [r for r in list(sched.running) if r.expired(now)]:
            self._expire(req)

    def step(self):
        """One engine iteration: expire/cancel at the boundary, admit (and
        prefill), grow/evict for KV headroom, run one decode step over
        every slot, stream the produced tokens, retire finished requests.
        Returns True while any request is running or waiting."""
        if self._stats.wall_t0 is None:
            self._stats.wall_t0 = time.perf_counter()
        self._stepping = True
        try:
            return self._step_locked()
        finally:
            self._stepping = False

    def _step_locked(self):
        sched = self.scheduler
        self._boundary_housekeeping()
        while True:
            # expire a dead head BEFORE admission assigns it a slot
            while sched.waiting and sched.waiting[0].expired():
                self._expire(sched.waiting[0])
            req = sched.try_admit()
            if req is None:
                break
            self._admit(req)
        if not sched.running:
            self._stats.wall_t1 = time.perf_counter()
            return bool(sched.waiting)
        # -- KV growth, preempting (newest first) when the pool is dry --
        for req in sorted(list(sched.running), key=lambda r: r.admit_seq):
            if req.state != RUNNING:
                continue
            need = sched.blocks_needed(req.cached_len)
            while len(req.blocks) < need and req.state == RUNNING:
                if sched.grow(req):
                    self._sync_slot(req)
                    continue
                victim = sched.preempt_victim(exclude=req)
                if victim is not None:
                    self._evict(victim)
                    continue
                if not sched.protected(req):
                    # aging guard: every other tenant is protected — the
                    # grower steps aside (requeued, not failed)
                    self._evict(req)
                    break
                self._fail(req, "kv_exhausted")
                break
        if not sched.running:
            self._stats.wall_t1 = time.perf_counter()
            return bool(sched.waiting)
        # -- one decode step over the fixed slot layout ----------------
        demand = sched.demand
        n_active = len(sched.running)
        t0 = time.perf_counter()
        toks, logps, aids, alps = self._decode_step()
        dt = time.perf_counter() - t0
        self._stats.observe_step(n_active, self.max_batch_size, demand, dt)
        # -- stream + retire -------------------------------------------
        for req in list(sched.running):
            if req.finished or req.slot is None:
                continue         # retired mid-loop by a streaming callback
            slot = req.slot
            req.cached_len += 1
            self._lens[slot] = req.cached_len
            tok = int(toks[slot])
            self._tokens[slot] = tok
            if req.cached_len < self.max_context:
                self._history[slot, req.cached_len] = tok
            self._emit_token(req, tok, logp=float(logps[slot]),
                             alts=((aids[slot], alps[slot])
                                   if self._logprobs_topk else None))
        self._stats.wall_t1 = time.perf_counter()
        return bool(sched.running or sched.waiting)

    def run(self, max_steps=None):
        """Drive step() until every request drains (or `max_steps`)."""
        n = 0
        while self.step():
            n += 1
            if max_steps is not None and n >= max_steps:
                break
        return n

    def generate(self, prompts, max_new_tokens=16, eos_token_id=None):
        """Batch convenience: enqueue every prompt, run to drain, return
        the generated token lists."""
        reqs = [self.add_request(p, max_new_tokens,
                                 eos_token_id=eos_token_id)
                for p in prompts]
        self.run()
        for r in reqs:
            if r.state in (FAILED, EXPIRED, CANCELLED):
                raise RuntimeError(f"request {r.rid} failed: {r.error}")
        return [list(r.generated) for r in reqs]

    def stats(self):
        snap = self._stats.snapshot()
        snap["scheduler"] = self.scheduler.info()
        snap["kv_blocks"] = self.cache.num_blocks
        snap["block_size"] = self.block_size
        snap["kv_dtype"] = str(self.cache.dtype).replace("torch.", "")
        snap["device"] = str(self.device)
        return snap

    def reset_stats(self):
        """Start a fresh measurement window (counters and samples); the
        pools and the running requests are untouched."""
        self._stats.reset()

    def pop_finished(self):
        """Drain terminal request handles from the id registry and return
        them as {rid: Request}; drained ids become reusable."""
        done = {rid: r for rid, r in self.requests.items() if r.finished}
        for rid in done:
            del self.requests[rid]
        return done

    # ------------------------------------------------------------------
    # admission / prefill
    # ------------------------------------------------------------------
    @staticmethod
    def _bucket_for(n):
        return max(_MIN_BUCKET, 1 << (int(n - 1)).bit_length())

    def _admit(self, req):
        """Bucketed prefill of prompt + already-generated tokens (the
        resume case) into the request's freshly assigned blocks, then join
        the decode batch."""
        ctx = req.prompt + req.generated
        # capped at max_context: padded positions stay inside the
        # position table and the block table
        bucket = min(self._bucket_for(len(ctx)), self.max_context)
        self._stats.admitted += 1
        self._stats.prefills += 1
        now = time.perf_counter_ns()
        if req.admit_ns is None:
            req.admit_ns = now
            self._stats.queue_wait_s.append((now - req.enqueue_ns) / 1e9)
        row = np.zeros(self.max_blocks_per_seq, np.int32)
        row[:len(req.blocks)] = req.blocks
        t0 = time.perf_counter()
        nxt, logp, aids, alps = self._prefill(ctx, bucket, row, req)
        self._stats.observe_prefill(bucket, time.perf_counter() - t0)
        req.cached_len = len(ctx)
        self._sync_slot(req)
        tok = int(nxt[0])
        # the prefill's sampled token is the next decode step's input
        self._tokens[req.slot] = tok
        if req.cached_len < self.max_context:
            self._history[req.slot, req.cached_len] = tok
        self._emit_token(req, tok, logp=float(logp[0]),
                         alts=((aids[0], alps[0]) if self._logprobs_topk
                               else None))

    @torch.no_grad()
    def _prefill(self, ctx, bucket, row, req):
        """Run the padded context through the dynamic-cache forward (causal
        attention over the bucket: padded positions never reach a real
        row), scatter its K/V into the pools and sample the next token at
        position len(ctx)."""
        length = len(ctx)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :length] = ctx
        ids = torch.from_numpy(padded).to(self.device)
        logits, caches = self._model(ids, caches=self._model.gen_caches(1))
        scatter_prefill(self._k_pools, self._v_pools,
                        [k[0] for k, _ in caches], [v[0] for _, v in caches],
                        torch.from_numpy(row).to(self.device), length,
                        self.block_size)
        valid = (np.arange(bucket) < length)[None, :]
        return sample_tokens(
            logits[0, length - 1][None, :],
            np.array([req.temperature], np.float32),
            np.array([req.top_k], np.int32),
            np.array([req.top_p], np.float32),
            np.array([req.repetition_penalty], np.float32),
            np.array([req.seed or 0], np.uint32),
            np.array([length], np.int64), padded, valid,
            logprobs_topk=self._logprobs_topk)

    @torch.no_grad()
    def _decode_step(self):
        """One token for every slot through the paged path (inactive slots
        compute garbage into the null block). Returns the sampler's numpy
        outputs."""
        dev = self.device
        tokens = torch.from_numpy(self._tokens).to(dev)
        tables = torch.from_numpy(self._tables).to(dev)
        lens = torch.from_numpy(self._lens).to(dev)
        active = torch.from_numpy(self._active).to(dev)
        views = [PagedCacheView(self._k_pools[l], self._v_pools[l], tables,
                                lens, active, self.block_size)
                 for l in range(self._k_pools.shape[0])]
        logits, _ = self._model(tokens[:, None], caches=views)
        # the input token enters the context at index `lens`
        rows = np.arange(self.max_batch_size)
        hist = self._history.copy()
        hist[rows, np.clip(self._lens, 0, hist.shape[1] - 1)] = self._tokens
        valid = np.arange(hist.shape[1])[None, :] <= self._lens[:, None]
        # sampling position = known context tokens = lens + 1
        return sample_tokens(
            logits[:, -1, :], self._temps, self._topks, self._topps,
            self._rpens, self._seeds, self._lens.astype(np.int64) + 1, hist,
            valid, logprobs_topk=self._logprobs_topk)

    def _sync_slot(self, req):
        slot = req.slot
        row = np.zeros(self.max_blocks_per_seq, np.int32)
        row[:len(req.blocks)] = req.blocks
        self._tables[slot] = row
        self._lens[slot] = req.cached_len
        self._active[slot] = True
        self._temps[slot] = req.temperature
        self._topks[slot] = req.top_k
        self._topps[slot] = req.top_p
        self._rpens[slot] = req.repetition_penalty
        self._seeds[slot] = req.seed or 0
        ctx = req.prompt + req.generated
        self._history[slot] = 0
        n = min(len(ctx), self.max_context)
        self._history[slot, :n] = ctx[:n]

    def _clear_slot(self, slot):
        self._tables[slot] = 0
        self._lens[slot] = 0
        self._active[slot] = False
        self._tokens[slot] = 0
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        self._topps[slot] = 1.0
        self._rpens[slot] = 1.0
        self._seeds[slot] = 0
        self._history[slot] = 0

    # ------------------------------------------------------------------
    # token delivery / retirement
    # ------------------------------------------------------------------
    def _emit_token(self, req, tok, logp=None, alts=None):
        req.generated.append(tok)
        req.token_logprobs.append(logp)
        if alts is None:
            req.alt_ids.append(None)
            req.alt_logprobs.append(None)
        else:
            req.alt_ids.append([int(i) for i in alts[0]])
            req.alt_logprobs.append([float(v) for v in alts[1]])
        self._stats.tokens_generated += 1
        if req.temperature > 0:
            self._stats.sampled_tokens += 1
        now = time.perf_counter_ns()
        if req.first_token_ns is None:
            req.first_token_ns = now
            self._stats.ttft_s.append((now - req.enqueue_ns) / 1e9)
        elif req.last_token_ns is not None:
            self._stats.inter_token_s.append((now - req.last_token_ns) / 1e9)
        req.last_token_ns = now
        req.token_ns.append(now)
        if req.on_token is not None:
            text = None
            if self._tokenizer is not None:
                text = self._tokenizer.decode([tok])
            req.on_token(req, tok, text)
        done = len(req.generated) >= req.max_new_tokens
        if req.eos_token_id is not None and tok == req.eos_token_id:
            done = True
        if done:
            self._finish(req)

    def _finish(self, req):
        slot = req.slot
        self.scheduler.release(req)
        if slot is not None:
            self._clear_slot(slot)
        req.state = FINISHED
        req.finish_ns = time.perf_counter_ns()
        self._stats.completed += 1

    def _fail(self, req, why):
        slot = req.slot
        self.scheduler.release(req)
        if slot is not None:
            self._clear_slot(slot)
        req.state = FAILED
        req.error = why
        req.finish_ns = time.perf_counter_ns()
        self._stats.failed += 1

    def _evict(self, victim):
        """Preempt-resume: forget the victim's KV (a block-table edit) and
        requeue it at its arrival position; resume re-prefills."""
        slot = victim.slot
        self._stats.evictions += 1
        self.scheduler.preempt(victim)
        if slot is not None:
            self._clear_slot(slot)
