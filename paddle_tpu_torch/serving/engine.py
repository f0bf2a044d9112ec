"""Continuous-batching serving engine over a paged KV cache, PyTorch port.

Counterpart of `paddle_tpu/serving/engine.py` (`ServeStats`, `LLMEngine`).
The host side is the reference's: iteration-level FCFS scheduling with a
free-block watermark (serving/scheduler.py), LIFO preempt-resume by
block-table edits, bucketed prefill, streaming `on_token` callbacks,
deadlines, cancellation and structured refusals. Host state stays in
numpy: the fixed slot layout ``tokens [S]``, ``tables [S, M]``,
``lens [S]``, ``active [S]``, the per-slot sampler config and the
override mask of pipelined decode.

The device side lives on ``device``: the two pools ``[L, num_blocks,
block_size, H, D]`` (with ``kv_dtype="int8"``, int8 pools and their fp32
scales ``[L, num_blocks, H]``), which every prefill and decode step edits
in place, each slot's context history ``[S, max_context]`` (the
repetition penalty's), and the prefill and decode programs' buffers.

A prefill runs one program per power-of-two bucket (capped at
``max_context``), built at the first prompt that lands in the bucket and
never again (`ServeStats.prefill_compiles`, the reference's count of
prefill traces; a new sampler config never rebuilds one). Its inputs are
static device buffers — the prompt's ids (a ``[max_context]`` row, zero
past the prompt), the block row, the length, the slot and the sampler
config, packed in one buffer that one copy fills from a pinned host
buffer — and the program runs the prompt (right-padded to the bucket)
through the model's dynamic-cache path (causal attention through the
flash kernel), scatters its K/V into the pools (one kernel launch for
every layer, quantized with int8 pools), picks the last real row's logits
by a device index and writes the ids into the slot's history row through
a device slot index. A sampler head over those logits, with the ids row
as history, samples the first token at position ``length``: the full head
for a sampled request, the greedy head otherwise, each built once. On the
card each bucket's program is one CUDA graph and each head another, all in
one memory pool of their own, captured after one eager warm-up that
writes nothing live (an all-null block row, length 0, and the spare
history row ``S``); a prefill is one staging copy, the bucket's replay,
one head's replay and one copy out. On the CPU the same code runs over
the same buffers without capture. A capture or replay that fails raises.

The decode step is one program, built once per engine at its first
decode step (`ServeStats.decode_compiles`, the reference's count of decode
traces) and run for every token of every stream, as the reference's one
``jax.jit`` is. Its inputs are static device buffers — tokens, tables,
lens, active, the sampler config and the override mask, packed in one
buffer that one copy fills each step from the host mirrors — and twelve
`PagedCacheView`s over them and the pools, made once. The program takes
each slot's input token from the host's copy where ``override`` is set
and from the device feedback buffer (the previous step's sampled token)
elsewhere, runs the decode forward (embeddings, every layer with its
fused KV write and paged attention, ``ln_f``, the LM head), writes the
input token into the history at ``lens`` and samples (`sample_tokens`:
the filter kernel, which writes the sampled rows' processed logits into
a buffer allocated once, then the keyed draw kernel, which writes the
next token into the output and feedback buffers). A step in which no
launched slot samples takes the greedy head instead: every row's raw
argmax, without the processors, its outputs on greedy rows those of the
full head bit for bit. On the card the program is three CUDA graphs (the
forward, the full head, the greedy head), captured in one build after
one eager warm-up step; a step replays the forward's and one head's. On the CPU
the same code runs over the same buffers without capture. Each launch's
outputs go to a pinned host buffer of its own, with an event. A capture
that fails raises; a decode step whose replay or completion reports an
error takes the fault path of the watchdog's paragraph below.

With ``pipeline_decode=True`` step N+1 is launched on the fed-back tokens
before step N's tokens are committed (streamed, retired), so the host's
commit overlaps the device's step, as the reference's `_step_pipelined`
does; the streams are bitwise those of the unpipelined engine. No host
buffer a queued launch still reads is rewritten: the staging copy and
the output copy each alternate between two pinned buffers, and a buffer
is written again only after the event of its last copy.

Multi-tenant serving (serving/tenancy.py), as the reference's:

  * ``enable_prefix_cache=True`` indexes every prefilled prompt's blocks by
    content (`PrefixCache`), per adapter: a prompt's K and V depend on the
    adapter its qkv projection ran under, so a stream aliases only blocks
    prefilled under its own adapter (the reference shares them across
    adapters). An admission whose context hits the index
    aliases the cached blocks (refcounted), runs no prefill, joins the
    decode batch at ``cached_len = hit`` and "chews" the known suffix: each
    decode step feeds its next context token (host-authored, ``override``
    set) and emits nothing, until the last one's step samples. Its history
    row is written by one stream-ordered copy at admission. Before each
    launch a copy-on-write sweep gives every stream whose write block is
    still shared (refcount > 1) a private copy of it (`_copy_block`: every
    layer's K and V, and the int8 scale rows), so the fused paged kernel,
    which writes and requantizes its write block in place, never writes a
    block another owner reads. Cold index entries are reclaimed before any
    stream is preempted.
  * ``max_adapters=K`` (``adapter_rank=r``) builds an `AdapterSet`, whose
    stacks live on the device, allocated once, and hooks its delta into
    every layer's ``qkv_proj`` and ``out_proj``. The per-slot adapter index
    joins the decode slot buffer and the prefill's adapter slot the
    prefill buffer, so registering, unregistering and routing tenants
    changes values, never a captured graph (`add_request(adapter=name)`,
    `register_adapter`, `unregister_adapter`).
  * ``hot_swap=True``: `stage_weights` / `swap_weights` take one array per
    ``model.parameters()`` entry (the port's order and ``[out, in]``
    layout; `convert.jax_state_values` turns the JAX model's arrays into
    that) and, at the next iteration boundary, preempt every running
    stream (no eviction counted), empty the prefix index and copy the
    values into the parameters' own storage, so the captured graphs serve
    the new weights without a recapture.

Pools of another float type (``kv_dtype`` any of fp32, bf16 and float16
other than the model's) hold the reference's ``.astype``: every write casts
the model's K/V to the pools' type (round to nearest even) and the paged
kernel reads them into fp32 scores. The admission budget counts the pools'
own bytes (`pool_bytes_per_block`: 2 a value for bf16 and float16).

``attention_kernel=`` (None: ``FLAGS_serve_attention_kernel``, default
``"blockwise"``) takes the reference's names, resolved once per engine and
reported as ``stats()["attention_kernel"]``: ``"pallas"`` and
``"blockwise"`` run the hand-written paged kernel, ``"reference"`` the
dense-gather oracle (PyTorch ops), reached only when named; another name
raises ValueError. The reference keys its stored decode executable on the
name; the port stores none (each engine builds its graphs), so no state
carries it.

The hung-step watchdog (``FLAGS_serve_step_timeout_ms``, 0 = disarmed)
bounds every decode and prefill: the host waits on the step's output
event through `MonitoredWait` (`event.query()` polls, never a blocking
synchronize) and a wait past the budget raises `StepHang` into the
reference's recovery ladder. A launched CUDA graph cannot be withdrawn,
and a second replay of the same step is not the same step (the fused
write requantizes an int8 block again; a pipelined launch reads the
feedback its first replay wrote), so no rung relaunches:

  * decode, rung 1 (`hangs` 1): wait again for the same launch;
  * rung 2: ask for a rebuild of the decode program, then wait again for
    the same launch. A capture waits for the whole device, so the rebuild
    runs only once the last launch has completed (at once if it has, else
    at the first later launch that finds it so; `decode_compiles` counts
    it then, and launches until then replay the old graphs): the old
    graphs are never freed in flight, and a step that never completes
    cannot block the ladder;
  * rung 3: fail every running request with ``step_hang``, ask for the
    rebuild, and keep serving queued and new work;
  * pipelined commit: wait again once, then fail every running request
    (both outstanding launches sit behind a wedged device), discarding
    both launches' records, and ask for the rebuild;
  * prefill: wait again once, then fail that request with ``step_hang``.

The launch a ladder gives up on stays queued on the device; whatever it
writes lands before any later work on the stream, into blocks and rows
whose owners have left. A device that never comes back fails each later
step within three budgets; recovery from it is crash-resume's (below).
A decode whose outputs are poisoned (an injected ``nan_output``) is
discarded, not rebuilt: every running stream finishes through
`GPTForCausalLM.generate` from its prompt and emitted tokens, through the
normal `on_token` path (`stats()["eager_fallbacks"]`), an adapter
tenant's under `AdapterSet.merged`. An error that a step's event or
output copy reports fails every running request with ``decode_fault``
and is raised, for the supervisor to restart from the last snapshot; no
stream finishes on another path. A device synchronize tells a sticky
error (the context is lost) from one the process survives; after the
latter the pools are zeroed and the program rebuilt, so the engine can
serve on. An error from building or launching the program (a kernel
build, a capture, a wrapper's launch) is not a device fault: it is raised
as it is, and fails no request. The engine is `degraded` from a hang or
fault until its next clean decode step.

Crash-resume: `state_payload()` is the reference's JSON-able snapshot of
every live request (no device state); `restore_state(payload)` in a fresh
process re-admits them in arrival order, each re-prefilling prompt +
emitted tokens and continuing byte-identically
(`incubate.checkpoint.ServeCheckpointer` saves one every step). AOT warm
start and the telemetry plane are not ported.
"""
from __future__ import annotations

import contextlib
import functools
import math
import time
import weakref
import zlib
from collections import deque

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import capture_graph, warm_up
from ..nn.functional.attention import resolve_paged_kernel
from .cache import (BlockAllocator, PagedCacheView, PagedKVCache, is_int8,
                    scatter_prefill)
from ..ops import guardian
from .resilience import (MonitoredWait, ServeRefusal, StepHang,
                         payload_request, request_payload)
from .sampling import default_seed, sample_tokens, validate_sampler
from .scheduler import (Request, Scheduler, RUNNING, FINISHED, FAILED,
                        CANCELLED, EXPIRED)
from .tenancy import AdapterSet, PrefixCache

__all__ = ["LLMEngine", "ServeStats"]


def _weak_method(method):
    """`method`, a bound method of an engine, as a function that holds the
    engine weakly: a program the engine keeps (the CPU's decode and
    prefill programs call its methods) then makes no reference cycle with
    it, so its pools go with its last reference, not at the next cyclic
    collection."""
    ref = weakref.WeakMethod(method)

    def call(*args, **kwargs):
        return ref()(*args, **kwargs)

    return call


# recent step-time samples averaged into the admission-time wait estimate
_EST_WINDOW = 32

_MIN_BUCKET = 8

# recent samples each latency percentile is read from
_SAMPLES = 4096


def _slot_buffer(s, m, device, pin=False):
    """The decode program's slot state, zeroed (every slot inactive): the
    4-byte fields of `_slot_views` and the two bool masks packed in one
    byte buffer, so that one copy moves them all."""
    return torch.zeros(4 * s * (m + 8) + 2 * s, dtype=torch.uint8,
                       device=device, pin_memory=pin)


def _slot_views(buf, s, m):
    """``(tokens [S], tables [S, M], lens [S], active [S], temperature [S],
    top_k [S], top_p [S], repetition_penalty [S], seeds [S], override
    [S], adapter [S])`` views of a buffer from `_slot_buffer`: int32
    tokens, tables, lens, top-k, seeds (the uint32 seed's bits) and
    adapter slots, float32 temperature, top-p and penalty, bool active and
    override."""
    words = 4 * s * (m + 8)
    i32 = buf[:words].view(torch.int32)
    f32 = buf[:words].view(torch.float32)
    flags = buf[words:].view(torch.bool)
    o = s * (m + 2)
    return (i32[:s], i32[s:s * (m + 1)].view(s, m), i32[s * (m + 1):o],
            flags[:s], f32[o:o + s], i32[o + s:o + 2 * s],
            f32[o + 2 * s:o + 3 * s], f32[o + 3 * s:o + 4 * s],
            i32[o + 4 * s:o + 5 * s], flags[s:], i32[o + 5 * s:o + 6 * s])


def _host_slot_views(buf, s, m):
    """`_slot_views` of a host buffer as numpy arrays, the seeds as uint32
    (the host mirror's type)."""
    views = [v.numpy() for v in _slot_views(buf, s, m)]
    views[8] = views[8].view(np.uint32)
    return views


def _out_buffer(s, k, device, pin=False):
    """The outputs of `s` rows (a decode step's slots, or a prefill's one
    row) packed in one byte buffer (`_out_views`)."""
    return torch.zeros(8 * s * (1 + k), dtype=torch.uint8, device=device,
                       pin_memory=pin)


def _out_views(buf, s, k):
    """``(next_token [S] int32, chosen_logprob [S] float32, alt_ids [S, K]
    int32, alt_logprobs [S, K] float32)`` views of `_out_buffer`."""
    i32, f32 = buf.view(torch.int32), buf.view(torch.float32)
    a = 2 * s + s * k
    return (i32[:s], f32[s:2 * s], i32[2 * s:a].view(s, k),
            f32[a:a + s * k].view(s, k))


def _prefill_buffer(c, m, device, pin=False):
    """A prefill program's inputs packed in one byte buffer
    (`_prefill_views`), zeroed."""
    return torch.zeros(4 * (c + m + 8), dtype=torch.uint8, device=device,
                       pin_memory=pin)


def _prefill_views(buf, c, m):
    """``(ids [C], block_row [M], length [1], slot [1], top_k [1], seed [1]
    int32 (the uint32 seed's bits), temperature [1], top_p [1],
    repetition_penalty [1] float32, adapter [1] int32)`` views of a buffer
    from `_prefill_buffer`."""
    i32, f32 = buf.view(torch.int32), buf.view(torch.float32)
    o = c + m
    return (i32[:c], i32[c:o], i32[o:o + 1], i32[o + 1:o + 2],
            i32[o + 2:o + 3], i32[o + 3:o + 4], f32[o + 4:o + 5],
            f32[o + 5:o + 6], f32[o + 6:o + 7], i32[o + 7:o + 8])


def _copies(views, event):
    """Wait for `event` (None: nothing to wait for) and return copies of
    the numpy `views` of a host output buffer."""
    if event is not None:
        event.synchronize()
    return tuple(v.copy() for v in views)


def _host_bytes(t):
    """Tensor `t`'s bytes as a numpy uint8 array (copied to the host)."""
    return t.detach().to("cpu").contiguous().reshape(-1).view(
        torch.uint8).numpy()


def _pct(samples, p):
    return float(np.percentile(np.asarray(samples), p)) if samples else 0.0


def _pool_dtype(kv_dtype, model_dtype):
    """The pools' dtype for the engine's `kv_dtype` (None: the model's;
    ``"int8"`` / ``torch.int8``; float32, bfloat16 or float16 as a torch
    dtype or its name). Other types raise ValueError."""
    if kv_dtype is None:
        return model_dtype
    if is_int8(kv_dtype):
        return torch.int8
    dtype = getattr(torch, kv_dtype, None) if isinstance(kv_dtype, str) \
        else kv_dtype
    if dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"kv_dtype {kv_dtype!r}: the port's pools are "
                         "float32, bfloat16, float16 or int8")
    return dtype


class ServeStats:
    """Engine counters + latency samples. Percentiles read the last
    `_SAMPLES` observations of each kind (bounded memory however long the
    engine runs). Times are host-clock seconds around work that ends in a
    device-to-host copy of sampled tokens, so they include the device's
    time (pipelined: launch N+1, then wait for step N's tokens and commit
    them). `decode_compiles` counts builds of the decode program (its
    three CUDA graph captures on the card, the buffers' views on the CPU,
    whatever the slots sample): 1 for an engine's life, however requests
    join, leave or are evicted. `prefill_compiles` counts builds of
    bucket prefill programs: one per distinct bucket for an engine's life,
    0 in a window whose buckets were all built before it.
    `commit_rollbacks` counts speculative tokens a pipelined commit
    discarded because the slot's request was cancelled, expired, preempted
    or finished between launch and commit. The tenancy counters are the
    reference's: `prefix_hit_tokens` over `prefix_prompt_tokens` (every
    admitted context token that could have hit the prefix index) is the
    hit rate; `prefix_evictions` counts index entries reclaimed under pool
    pressure, `cow_copies` private block copies, `adapter_switches` changes
    of a slot's adapter index, `weight_swaps` committed hot-swaps. The
    resilience counters are the reference's: `hangs` watchdog firings,
    `eager_fallbacks` streams finished through `generate` after a decode
    fault, `resumed` requests re-admitted by `restore_state`."""

    def __init__(self):
        self.reset()

    def reset(self):
        """Zero the counters IN PLACE and drop the samples (a fresh
        measurement window; the pools, the running requests and the built
        decode and prefill programs are untouched)."""
        self.steps = 0
        self.decode_compiles = 0
        self.prefill_compiles = 0
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
        self.hangs = 0
        self.eager_fallbacks = 0
        self.resumed = 0
        self.occupancy_sum = 0.0
        self.saturated_steps = 0
        self.saturated_occupancy_sum = 0.0
        self.sampled_tokens = 0
        self.commit_rollbacks = 0
        self.prefix_hit_tokens = 0
        self.prefix_prompt_tokens = 0
        self.prefix_evictions = 0
        self.cow_copies = 0
        self.adapter_switches = 0
        self.weight_swaps = 0
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
            "decode_compiles": self.decode_compiles,
            "prefill_compiles": self.prefill_compiles,
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
            "hangs": self.hangs,
            "eager_fallbacks": self.eager_fallbacks,
            "resumed": self.resumed,
            "sampled_tokens": self.sampled_tokens,
            "commit_rollbacks": self.commit_rollbacks,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hit_rate": (self.prefix_hit_tokens
                                / self.prefix_prompt_tokens
                                if self.prefix_prompt_tokens else 0.0),
            "prefix_evictions": self.prefix_evictions,
            "cow_copies": self.cow_copies,
            "adapter_switches": self.adapter_switches,
            "weight_swaps": self.weight_swaps,
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
    model's parameters must already live on that device (fp32, bf16 or
    float16). Greedy decoding (temperature 0, the default) is exact; the
    pools take the model's parameter dtype, another float type with
    ``kv_dtype=torch.float32``, ``torch.bfloat16`` or ``torch.float16``, or
    int8 with ``kv_dtype="int8"`` (or
    ``torch.int8``): one byte per cached element, dequantized inside the
    paged kernel, so the same pool bytes admit about twice the streams of
    bf16.
    ``enable_prefix_cache=True`` shares prompt KV blocks across streams
    with copy-on-write, ``max_adapters=K`` serves per-tenant low-rank
    adapters (``add_request(..., adapter=name)``) and ``hot_swap=True``
    lets `swap_weights` replace the weights between steps; none of them
    rebuilds a captured graph (module docstring).
    """

    def __init__(self, model, max_batch_size=8, block_size=16,
                 num_blocks=None, max_context=None, watermark_blocks=None,
                 tokenizer=None, max_queue_depth=None,
                 aging_max_preemptions=3, kv_dtype=None,
                 attention_kernel=None, enable_prefix_cache=False,
                 max_adapters=0, adapter_rank=4, hot_swap=False,
                 logprobs_topk=0, pipeline_decode=False, device=None):
        # the attention variant, resolved once for the engine's life
        self._attn_kernel = resolve_paged_kernel(attention_kernel)
        device = resolve_device(device)
        param = next(model.parameters())
        kv = _pool_dtype(kv_dtype, param.dtype)
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
        self._num_blocks = int(num_blocks)
        self.cache = PagedKVCache(cfg.num_hidden_layers,
                                  cfg.num_attention_heads, head_dim,
                                  num_blocks, self.block_size, dtype=kv,
                                  device=self.device)
        self.scheduler = Scheduler(self.max_batch_size,
                                   self.cache.allocator, self.block_size,
                                   watermark_blocks,
                                   max_queue_depth=max_queue_depth,
                                   aging_max_preemptions=
                                   aging_max_preemptions)
        self._stats = ServeStats()
        # -- multi-tenant layer (serving/tenancy.py) ---------------------
        self._prefix = (PrefixCache(self.cache.allocator, self.block_size)
                        if enable_prefix_cache else None)
        self._adapters = None
        if max_adapters > 0:
            self._adapters = AdapterSet(model, max_adapters, adapter_rank)
            self._adapters.install()
        self._hot_swap = bool(hot_swap)
        # the tenant half of state_payload (the reference's `_tenant`)
        self._tenant = self._hot_swap or self._adapters is not None
        self._weight_epoch = 0
        self._pending_weights = None
        self._weights_crc = self._params_crc() if self._hot_swap else None
        # fixed slot-layout state every decode step consumes
        s, m = self.max_batch_size, self.max_blocks_per_seq
        self._tables = np.zeros((s, m), np.int32)
        self._lens = np.zeros(s, np.int32)
        self._active = np.zeros(s, bool)
        self._tokens = np.zeros(s, np.int32)
        # per-slot adapter index into the stacks (0 = base), staged with the
        # slot state; deliberately NOT reset by _clear_slot, as in the
        # reference: a stale index on an inactive slot is masked out, and
        # clearing it would count a spurious switch at the next admission
        self._aslots = np.zeros(s, np.int32)
        # per-slot sampler config; the no-op values of a cleared slot keep
        # it on the greedy path
        self._logprobs_topk = int(logprobs_topk)
        self._temps = np.zeros(s, np.float32)
        self._topks = np.zeros(s, np.int32)
        self._topps = np.ones(s, np.float32)
        self._rpens = np.ones(s, np.float32)
        self._seeds = np.zeros(s, np.uint32)
        # per-slot context history for the repetition penalty, on the
        # device: a prefill writes the slot's row, each decode step its
        # input token at `lens`; positions <= lens are valid. Row S is
        # spare: a prefill program's warm-up writes there
        self._history_rows = torch.zeros((s + 1, self.max_context),
                                         dtype=torch.int32,
                                         device=self.device)
        self._history = self._history_rows[:s]
        # -- pipelined decode: launch step N+1 on device-fed tokens while
        # step N's host commit runs. `_inflight` holds the uncommitted
        # launch, `_feedback` each slot's last sampled token on the device,
        # and `_override[slot]` marks slots whose HOST token (admission)
        # must win over the feedback; the unpipelined engine keeps every
        # override set
        self._pipeline = bool(pipeline_decode)
        self._inflight = None
        self._override = np.ones(s, bool)
        self._feedback = torch.zeros(s, dtype=torch.int32, device=self.device)
        # the decode program's inputs and outputs on the device; the host
        # side of each copy alternates between two (pinned on the card)
        # buffers, each written again only after the event of its last
        # copy (None on the CPU, where copies are synchronous); the program
        # itself is built at the first decode step
        cpu, cuda = torch.device("cpu"), self.device.type == "cuda"
        self._slots_dev = _slot_buffer(s, m, self.device)
        self._out_dev = _out_buffer(s, self._logprobs_topk, self.device)
        # the full sampler head's filtered logits (its sampled rows; the
        # keyed draw reads raw logits for the others)
        self._filtered = torch.zeros((s, model.config.vocab_size),
                                     dtype=torch.float32, device=self.device)
        self._staging = []
        self._outputs = []
        for _ in range(2):
            host = _slot_buffer(s, m, cpu, pin=cuda)
            self._staging.append([host, _host_slot_views(host, s, m), None])
            host = _out_buffer(s, self._logprobs_topk, cpu, pin=cuda)
            self._outputs.append(
                (host, [v.numpy() for v in
                        _out_views(host, s, self._logprobs_topk)]))
        self._out_views = _out_views(self._out_dev, s, self._logprobs_topk)
        self._positions = torch.arange(self.max_context, device=self.device)
        # the prefill programs (bucket -> program, each built at the
        # bucket's first prompt) and the two sampler heads they share,
        # built with the first; their inputs (`_prefill_views`), staged in
        # one pinned host buffer whose copy's event is `_pf_copied`, the
        # last real row's logits, the full head's filtered logits and the
        # outputs, with one pinned host buffer for them
        c = self.max_context
        self._prefill_fns = {}
        self._prefill_heads = None
        self._pf_pool = None
        self._pf_dev = _prefill_buffer(c, m, self.device)
        self._pf_views = _prefill_views(self._pf_dev, c, m)
        self._pf_host = _prefill_buffer(c, m, cpu, pin=cuda)
        self._pf_staged = [v.numpy() for v in _prefill_views(self._pf_host,
                                                             c, m)]
        self._pf_staged[5] = self._pf_staged[5].view(np.uint32)
        self._pf_copied = None
        self._pf_logits = torch.zeros((1, cfg.vocab_size), dtype=param.dtype,
                                      device=self.device)
        self._pf_filtered = torch.zeros((1, cfg.vocab_size),
                                        dtype=torch.float32,
                                        device=self.device)
        self._pf_out_dev = _out_buffer(1, self._logprobs_topk, self.device)
        self._pf_out_views = _out_views(self._pf_out_dev, 1,
                                        self._logprobs_topk)
        self._pf_out_host = _out_buffer(1, self._logprobs_topk, cpu, pin=cuda)
        self._pf_outputs = [v.numpy() for v in _out_views(
            self._pf_out_host, 1, self._logprobs_topk)]
        self._launches = 0
        # runs the program once: a graph replay on the card, the decode
        # code on the CPU; returns the step's logits [S, 1, V]
        self._decode_program = None
        # a rebuild the watchdog asked for and the last launch's output
        # event, which it waits for (`_rebuild_decode`)
        self._decode_stale = False
        self._last_event = None
        self._k_pools = self.cache.k_pools
        self._v_pools = self.cache.v_pools
        self._k_scales = self.cache.k_scales       # None unless int8 KV
        self._v_scales = self.cache.v_scales
        self._next_rid = 0
        # rid -> Request: the id registry; terminal handles stay until the
        # caller drains them with pop_finished()
        self.requests = {}
        # True while step() edits the slot arrays: a cancel() from inside
        # a streaming callback then defers to the next boundary
        self._stepping = False
        # the hung-step watchdog (module docstring): its monitored wait,
        # the degraded latch (set by a hang or fault, cleared by the next
        # clean decode step) and its last transition
        self._monitor = MonitoredWait()
        self.degraded = False
        self.degrade_reason = None

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
        byte-identically. `ttl_s` arms a deadline. `adapter` names the
        registered adapter the stream decodes under (None: the base
        weights).

        Raises `ServeRefusal` (a ValueError) for doomed work:
        `sampler_mismatch`, `adapter_mismatch` (the adapter is not
        registered, or the engine has none), `queue_full`, `kv_exhausted`
        (the peak KV footprint can never fit) or `deadline_infeasible`.
        Plain validation errors stay ValueError.
        """
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
                      ttl_s=ttl_s, adapter=adapter, temperature=temperature,
                      top_k=top_k, top_p=top_p,
                      repetition_penalty=repetition_penalty,
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
        if adapter is not None and (
                self._adapters is None
                or not self._adapters.is_registered(adapter)):
            self._refuse(req, "adapter_mismatch",
                         f"request {rid}: adapter {adapter!r} is not "
                         "registered with this engine; register it (or "
                         "build the engine with max_adapters > 0) before "
                         "routing its tenant here",
                         {"adapter": adapter,
                          "registered": ([] if self._adapters is None
                                         else self._adapters.names())})
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
        shared = 0
        if self._prefix is not None:
            # aliasing credit: blocks this prompt would inherit by
            # reference (advisory: no references are taken)
            shared, _ = self._prefix.probe(req.prompt + req.generated,
                                           namespace=req.adapter)
        if not sched.can_ever_fit(req, shared_blocks=shared):
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
        # -- weight hot-swap cutover (an exact iteration boundary) -------
        if self._pending_weights is not None:
            self._commit_swap()
        self._boundary_housekeeping()
        hook = self._prefix_hook if self._prefix is not None else None
        while True:
            # expire a dead head BEFORE admission assigns it a slot
            while sched.waiting and sched.waiting[0].expired():
                self._expire(sched.waiting[0])
            req = sched.try_admit(prefix_hook=hook)
            if req is None:
                # the pool may be dry only because the prefix index hoards
                # cold entries: release those and retry (only with a slot
                # free: batch pressure is not block pressure)
                if (self._prefix is not None and sched.waiting
                        and None in sched.slots
                        and self._reclaim_prefix(
                            sched.blocks_needed(
                                sched.waiting[0].context_len)
                            + sched.watermark_blocks)):
                    continue
                break
            self._admit(req)
        if not sched.running:
            self._flush_inflight()
            self._stats.wall_t1 = time.perf_counter()
            return bool(sched.waiting)
        # -- KV growth, preempting (newest first) when the pool is dry --
        for req in sorted(list(sched.running), key=lambda r: r.admit_seq):
            if req.state != RUNNING:
                continue
            need = sched.blocks_needed(req.cached_len)
            while len(req.blocks) < need and req.state == RUNNING:
                if self._take_block(req, lambda r=req: sched.grow(r)):
                    self._sync_slot(req)
        # -- copy-on-write boundary: privatize shared write blocks ------
        if self._prefix is not None:
            self._cow_sweep()
        if not sched.running:
            self._flush_inflight()
            self._stats.wall_t1 = time.perf_counter()
            return bool(sched.waiting)
        # -- software-pipelined tail: launch N+1, commit N (lag 1) -----
        if self._pipeline:
            return self._step_pipelined()
        # -- one decode step over the fixed slot layout ----------------
        demand = sched.demand
        n_active = len(sched.running)
        t0 = time.perf_counter()
        out = self._decode_step()
        if out is None:
            # the ladder's last rung or the eager fallback retired the
            # batch; queued and new work is served as before
            self._stats.wall_t1 = time.perf_counter()
            return bool(sched.running or sched.waiting)
        toks, logps, aids, alps = out
        dt = time.perf_counter() - t0
        self._stats.observe_step(n_active, self.max_batch_size, demand, dt)
        self._recovered()
        # -- stream + retire -------------------------------------------
        for req in list(sched.running):
            if req.finished or req.slot is None:
                continue         # retired mid-loop by a streaming callback
            slot = req.slot
            req.cached_len += 1
            self._lens[slot] = req.cached_len
            if req.chew:
                # prefix-hit warm-up: the next context token is KNOWN; feed
                # it as the next input and drop the prediction (made from
                # a mid-context position, it is no output token)
                self._tokens[slot] = req.chew.pop(0)
                continue
            tok = int(toks[slot])
            self._tokens[slot] = tok
            self._emit_token(req, tok, logp=float(logps[slot]),
                             alts=((aids[slot], alps[slot])
                                   if self._logprobs_topk else None))
        self._stats.wall_t1 = time.perf_counter()
        return bool(sched.running or sched.waiting)

    # ------------------------------------------------------------------
    # software-pipelined decode: launch N+1, commit N at lag 1
    # ------------------------------------------------------------------
    def _step_pipelined(self):
        """Pipelined tail of one iteration: LAUNCH this step's decode on
        device-fed tokens (the previous launch's sampled ids feed back
        through the device buffer, no host round trip), then COMMIT the
        previous launch's host work (callbacks, retirement) while the
        device runs the new one. Steady-state step time is max(device,
        host commit) instead of their sum."""
        sched = self.scheduler
        demand = sched.demand
        n_active = len(sched.running)
        t0 = time.perf_counter()
        launched = self._launch_decode()
        try:
            ok = self._commit_inflight()
        except BaseException:
            # a streaming callback raised mid-commit: the new launch stays
            # in flight and the next step commits it
            self._inflight = launched
            raise
        if not ok:
            # the ladder or the fallback retired the batch: the launch
            # just issued read state that no longer holds
            if launched is not None:
                self._discard_records(launched)
            self._reset_pipeline()
            self._stats.wall_t1 = time.perf_counter()
            return bool(sched.running or sched.waiting)
        self._inflight = launched
        if launched is not None:
            self._stats.observe_step(n_active, self.max_batch_size, demand,
                                     time.perf_counter() - t0)
            self._recovered()
        self._stats.wall_t1 = time.perf_counter()
        return bool(sched.running or sched.waiting
                    or self._inflight is not None)

    def _launch_decode(self):
        """Launch one decode step without waiting for it. Structural state
        (cached_len, lens) advances HERE, since the KV write at position
        `lens` is certain whatever token the launch samples; the
        token-dependent state (generated, callbacks, finish) waits for the
        lag-1 commit. Returns the in-flight record, or None when no slot
        can take another token."""
        sched = self.scheduler
        if not sched.running:
            return None
        launch_active = self._active.copy()
        plan = []
        for req in list(sched.running):
            if req.state != RUNNING or req.slot is None:
                continue
            slot = req.slot
            pending = 1 if self._has_pending(req, slot) else 0
            if (not req.chew
                    and len(req.generated) + pending >= req.max_new_tokens):
                # every remaining token is committed or in flight:
                # launching this slot could only overshoot max_new_tokens
                launch_active[slot] = False
                continue
            plan.append((req, slot))
        if not plan:
            return None
        out = self._launch(launch_active)
        records = []
        for req, slot in plan:
            req.cached_len += 1
            self._lens[slot] = req.cached_len
            if req.chew:
                # a chew launch emits nothing, so it leaves no record; the
                # next known context token is the slot's next input, from
                # the host (override stays set)
                self._tokens[slot] = req.chew.pop(0)
                self._override[slot] = True
                continue
            records.append((req, slot, req.admit_seq))
            self._override[slot] = False
        return {"out": out, "records": records}

    def _commit_inflight(self):
        """Commit the PREVIOUS launch: the monitored wait for its outputs,
        then stream its tokens through the normal emission path. A record
        whose request was cancelled, expired, preempted or finished since
        the launch is discarded (`_rollback`): each departed stream loses
        exactly its one speculative token. A streaming callback that raises
        does not stop the commit: the launch after this one already took
        every record's token from the feedback buffer, so each is emitted,
        and the first exception is raised once all are. Returns False when
        the ladder (a second hang: every running request fails) or a
        poisoned launch (the eager fallback) retired the batch; a device
        fault is raised (`_device_fault`)."""
        inf, self._inflight = self._inflight, None
        if inf is None:
            return True
        out = inf["out"]
        attempt = 1
        while True:
            try:
                outputs = self._completed(out, attempt)
                break
            except StepHang:
                self._stats.hangs += 1
                if attempt >= 2:
                    # a wedged device holds both outstanding launches
                    self._degrade("step_hang", {"rung": "fail_active",
                                                "phase": "commit"})
                    self._discard_records(inf)
                    for req in list(self.scheduler.running):
                        self._fail(req, "step_hang")
                    self._reset_pipeline()
                    self._rebuild_decode()
                    return False
                self._degrade("step_hang", {"rung": "retry",
                                            "phase": "commit"})
                attempt += 1
            except RuntimeError:
                # a device fault (`_device_fault` failed every running
                # request): this launch's tokens are never committed
                self._discard_records(inf)
                self._reset_pipeline()
                raise
        if guardian.poll_fault("serve.decode",
                               ("nan_output", "raise")) is not None:
            self._degrade("decode_fault", {"injected": True})
            self._discard_records(inf)
            self._reset_pipeline()
            self._recover_with_fallback()
            return False
        toks, logps, aids, alps = outputs
        raised = None
        for req, slot, aseq in inf["records"]:
            if (req.state != RUNNING or req.slot != slot
                    or req.admit_seq != aseq):
                self._rollback()
                continue
            tok = int(toks[slot])
            self._tokens[slot] = tok
            try:
                self._emit_token(req, tok, logp=float(logps[slot]),
                                 alts=((aids[slot], alps[slot])
                                       if self._logprobs_topk else None))
            except Exception as exc:     # raised by a streaming callback
                if raised is None:
                    raised = exc
        if raised is not None:
            raise raised
        return True

    def _has_pending(self, req, slot):
        inf = self._inflight
        if inf is None:
            return False
        return any(r is req and s == slot for r, s, _ in inf["records"])

    def _rollback(self):
        """One speculative token discarded at the lag-1 boundary."""
        self._stats.commit_rollbacks += 1

    def _discard_records(self, inf):
        """Roll back every record of an in-flight launch."""
        for _ in inf["records"]:
            self._rollback()

    def _flush_inflight(self):
        """Commit (or roll back) the pending pipelined launch now. At a
        drain point no speculative token may stay in flight; afterwards
        the host token mirror is authoritative for every slot. A no-op
        when nothing is pending (always, for the unpipelined engine)."""
        if self._inflight is not None:
            self._commit_inflight()
        self._reset_pipeline()

    def _reset_pipeline(self):
        self._inflight = None
        self._override[:] = True

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
        snap["attention_kernel"] = self._attn_kernel
        snap["device"] = str(self.device)
        if self._prefix is not None:
            snap["prefix_entries"] = self._prefix.entries
        if self._hot_swap or self._adapters is not None:
            snap["weight_epoch"] = self._weight_epoch
            snap["adapters"] = ([] if self._adapters is None
                                else self._adapters.names())
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
        the decode batch. A prefix-hit admission (try_admit aliased cached
        blocks) skips the prefill (`_admit_prefix_hit`)."""
        ctx = req.prompt + req.generated
        if req.prefix_hit > 0:
            self._admit_prefix_hit(req, ctx)
            return
        if self._prefix is not None:
            self._stats.prefix_prompt_tokens += len(ctx)
        # capped at max_context: padded positions stay inside the
        # position table and the block table
        bucket = min(self._bucket_for(len(ctx)), self.max_context)
        self._stats.admitted += 1
        self._stats.prefills += 1
        self._note_admission(req)
        row = np.zeros(self.max_blocks_per_seq, np.int32)
        row[:len(req.blocks)] = req.blocks
        t0 = time.perf_counter()
        res = self._prefill(ctx, bucket, row, req)
        if res is None:
            self._fail(req, "step_hang")      # the watchdog gave up on it
            return
        nxt, logp, aids, alps = res
        self._stats.observe_prefill(bucket, time.perf_counter() - t0)
        req.cached_len = len(ctx)
        self._sync_slot(req)
        self._set_adapter_slot(req)
        if self._prefix is not None:
            # index this prompt's blocks for the NEXT stream sharing it; a
            # resume's partial tail holds generated-token KV, which must
            # never be served as prompt KV
            self._prefix.publish(ctx, req.blocks,
                                 include_tail=not req.generated,
                                 namespace=req.adapter)
        tok = int(nxt[0])
        # the prefill's sampled token is the next decode step's input, from
        # the host's copy
        self._tokens[req.slot] = tok
        self._override[req.slot] = True
        self._emit_token(req, tok, logp=float(logp[0]),
                         alts=((aids[0], alps[0]) if self._logprobs_topk
                               else None))

    def _note_admission(self, req):
        now = time.perf_counter_ns()
        if req.admit_ns is None:
            req.admit_ns = now
            self._stats.queue_wait_s.append((now - req.enqueue_ns) / 1e9)

    @torch.no_grad()
    def _admit_prefix_hit(self, req, ctx):
        """Prefix-hit admission: the aliased blocks already hold the first
        `prefix_hit` tokens' KV, so there is NO prefill. The stream joins
        the decode batch at ``cached_len = hit`` with ``ctx[hit]`` as its
        input, and the decode steps chew the rest of the known context
        (one token a step, nothing emitted) before sampling. Its history
        row (the repetition penalty's) is ``ctx[:hit]`` and zeros, written
        by one copy queued on the stream behind every launch that may still
        read the row; the decode steps write each input token at ``lens``
        after it."""
        hit = req.prefix_hit
        self._stats.admitted += 1
        self._stats.prefix_hit_tokens += hit
        self._stats.prefix_prompt_tokens += len(ctx)
        self._note_admission(req)
        req.cached_len = hit
        self._sync_slot(req)
        self._set_adapter_slot(req)
        self._stage_prefill(ctx[:hit], self._tables[req.slot], req.slot, 0.0,
                            0, 1.0, 1.0, 0, 0)
        ids, _, _, slot = self._pf_views[:4]
        self._history_rows.index_copy_(0, slot.long(), ids[None])
        self._tokens[req.slot] = int(ctx[hit])
        self._override[req.slot] = True
        req.chew = [int(t) for t in ctx[hit + 1:]]

    def _set_adapter_slot(self, req):
        """Point the request's batch slot at its tenant's adapter index
        (0 = base); a change of index counts as an adapter switch."""
        if self._adapters is None:
            return
        idx = self._adapters.slot_of(req.adapter)
        if idx != int(self._aslots[req.slot]):
            self._stats.adapter_switches += 1
        self._aslots[req.slot] = idx

    def _adapter_index(self, req):
        return 0 if self._adapters is None else \
            self._adapters.slot_of(req.adapter)

    def _armed(self, idx):
        """A context arming the adapter hooks with the rows' adapter slots
        `idx` (a no-op context for an engine without adapters)."""
        if self._adapters is None:
            return contextlib.nullcontext()
        return self._adapters.arm(idx)

    @torch.no_grad()
    def _prefill(self, ctx, bucket, row, req):
        """Prefill `ctx` through its bucket's program (built here at the
        bucket's first prompt): stage the inputs into the pinned host
        buffer, copy them in, run the program (the bucket's replay, then
        the full head's for a sampled request, else the greedy head's),
        copy the outputs out and wait for them (monitored: a second hang
        gives up, returning None). Returns ``(next_token [1],
        chosen_logprob [1], alt_ids [1, K], alt_logprobs [1, K])``."""
        program = self._prefill_fns.get(bucket)
        if program is None:
            program = self._build_prefill(bucket)
        self._stage_prefill(ctx, row, req.slot, req.temperature, req.top_k,
                            req.top_p, req.repetition_penalty, req.seed or 0,
                            self._adapter_index(req))
        program(req.temperature > 0)
        self._pf_out_host.copy_(self._pf_out_dev, non_blocking=True)
        event = self._event()
        attempt = 1
        while True:
            try:
                self._monitor.wait(event, "prefill", attempt)
                break
            except StepHang:
                # one tenant: wait again once, then fail the request
                self._stats.hangs += 1
                if attempt >= 2:
                    self._degrade("step_hang", {"rung": "fail_request",
                                                "phase": "prefill",
                                                "rid": req.rid})
                    return None
                self._degrade("step_hang", {"rung": "retry",
                                            "phase": "prefill"})
                attempt += 1
        return _copies(self._pf_outputs, event)

    @torch.no_grad()
    def _prefill_eager(self, ctx, bucket, row, req):
        """The prefill without a program: fresh host-to-device copies of
        the ids, the block row and the sampler config, the padded context
        through the dynamic-cache forward, the K/V scatter, the context as
        the slot's history row and the sampler head at position len(ctx),
        launch by launch. No entry point reaches it; it stays to time the
        program against."""
        length = len(ctx)
        dev = self.device
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :length] = ctx
        ids = torch.from_numpy(padded).to(dev)
        adapter = torch.tensor([self._adapter_index(req)], dtype=torch.int32,
                               device=dev)
        with self._armed(adapter):
            logits, caches = self._model(ids,
                                         caches=self._model.gen_caches(1))
        scatter_prefill(self._k_pools, self._v_pools,
                        [k[0] for k, _ in caches], [v[0] for _, v in caches],
                        torch.from_numpy(row).to(dev), length,
                        self.block_size, k_scales=self._k_scales,
                        v_scales=self._v_scales)
        # queued on the stream behind any launch still reading the row
        self._history[req.slot].zero_()
        self._history[req.slot, :bucket].copy_(ids[0])
        floats = torch.tensor([req.temperature, req.top_p,
                               req.repetition_penalty]).to(dev)
        seed = int(np.uint32(req.seed or 0).view(np.int32))
        ints = torch.tensor([req.top_k, seed, length],
                            dtype=torch.int32).to(dev)
        valid = (torch.arange(bucket, device=dev) < length)[None, :]
        out = sample_tokens(logits[0, length - 1][None, :], floats[0:1],
                            ints[0:1], floats[1:2], floats[2:3], ints[1:2],
                            ints[2:3], self._history[req.slot:req.slot + 1,
                                                     :bucket], valid,
                            logprobs_topk=self._logprobs_topk,
                            greedy_only=req.temperature <= 0)
        return tuple(t.cpu().numpy() for t in out)

    def _stage_prefill(self, ids, row, slot, temperature, top_k, top_p,
                       penalty, seed, adapter=0):
        """Write a prefill's inputs into the pinned host buffer (once the
        copy that last read it is done) and copy them to the device
        buffer in one copy."""
        if self._pf_copied is not None:
            self._pf_copied.synchronize()
        staged = self._pf_staged
        n = len(ids)
        staged[0][:n] = ids
        staged[0][n:] = 0
        staged[1][:] = row
        for view, value in zip(staged[2:], (n, slot, top_k, seed,
                                            temperature, top_p, penalty,
                                            adapter), strict=True):
            view[0] = value
        self._pf_dev.copy_(self._pf_host, non_blocking=True)
        self._pf_copied = self._event()

    def _prefill_forward(self, bucket, caches):
        """A bucket program's model part over the static inputs: the ids
        through the dynamic-cache forward (`caches`: empty per-layer K/V),
        the K/V scatter into the pools, the last real row's logits into
        `_pf_logits` (row ``length - 1``, by a device index; row 0 when
        length is 0) and the ids row into history row ``slot``."""
        ids, row, length, slot = self._pf_views[:4]
        with self._armed(self._pf_views[9]):
            logits, kv = self._model(ids[:bucket][None], caches=caches)
        scatter_prefill(self._k_pools, self._v_pools, [k[0] for k, _ in kv],
                        [v[0] for _, v in kv], row, length[0],
                        self.block_size, k_scales=self._k_scales,
                        v_scales=self._v_scales)
        last = (length.long() - 1).clamp(min=0)
        self._pf_logits.copy_(logits[0].index_select(0, last))
        self._history_rows.index_copy_(0, slot.long(), ids[None])

    def _prefill_head(self, sampled):
        """A prefill's sampler head over `_pf_logits` and the ids row as
        history (positions < length valid), at position ``length``,
        writing into `_pf_out_dev`: the full head, or with ``sampled``
        False the greedy head (the raw argmax, no processors)."""
        ids, _, length, _, top_k, seed, temp, top_p, penalty = \
            self._pf_views[:9]
        valid = self._positions[None, :] < length[:, None]
        sample_tokens(self._pf_logits, temp, top_k, top_p, penalty, seed,
                      length, ids[None], valid, self._logprobs_topk,
                      out=self._pf_out_views, greedy_only=not sampled,
                      filtered=self._pf_filtered)

    @torch.no_grad()
    def _build_prefill(self, bucket):
        """Build the prefill program of `bucket`, once, and with the first
        bucket the two sampler heads. The inputs are staged for a warm-up
        that writes nothing live (an all-null block row, length 0, the
        spare history row) and the program runs once eagerly, on a side
        stream on the card, where it loads cuBLAS at the bucket's shapes
        and the kernels' modules before capture; then the bucket's program
        (`_prefill_forward`) and, the first time, each head
        (`_prefill_head`) is captured in a CUDA graph of the prefill
        programs' shared memory pool. A build waits for the work in
        flight (a capture starts with a device synchronize). Returns the
        program: ``program(sampled)`` replays the bucket's graph, then the
        full head's (``sampled``) or the greedy head's."""
        self._stats.prefill_compiles += 1
        caches = self._model.gen_caches(1)
        forward = functools.partial(_weak_method(self._prefill_forward),
                                    bucket, caches)
        head_fns = {} if self._prefill_heads is not None else {
            sampled: functools.partial(_weak_method(self._prefill_head),
                                       sampled)
            for sampled in (True, False)}
        self._stage_prefill((), np.zeros(self.max_blocks_per_seq, np.int32),
                            self.max_batch_size, 0.0, 0, 1.0, 1.0, 0, 0)
        if self.device.type != "cuda":
            for fn in (forward, *head_fns.values()):
                fn()
            run, built = forward, head_fns
        else:
            warm_up(lambda: [fn() for fn in (forward, *head_fns.values())],
                    self.device)
            if self._pf_pool is None:
                self._pf_pool = torch.cuda.graph_pool_handle()
            run = self._captured(forward)
            built = {sampled: self._captured(fn)
                     for sampled, fn in head_fns.items()}
        if self._prefill_heads is None:
            self._prefill_heads = built
        heads = self._prefill_heads

        def program(sampled):
            run()
            heads[sampled]()

        self._prefill_fns[bucket] = program
        return program

    def _captured(self, fn):
        """Capture fn() in a CUDA graph of the prefill programs' memory
        pool; returns a function that replays it and adds its launches.
        The pool holds only the graphs' temporaries (each one's results
        go to buffers made outside it, and the next replay reads them
        from there), so the graphs may replay in any order, one at a
        time."""
        return capture_graph(fn, self._pf_pool)[0]

    def _decode_step(self):
        """One token for every slot through the decode program (inactive
        slots compute garbage nobody reads), through the monitored wait
        and its ladder (module docstring); returns the step's outputs as
        numpy arrays, or None when the ladder's last rung or a poisoned
        launch's eager fallback retired the batch. A device fault is
        raised (`_device_fault`)."""
        out = self._launch(self._active)
        attempt = 1
        while True:
            try:
                outputs = self._completed(out, attempt)
                break
            except StepHang:
                if not self._on_hang(attempt):
                    return None
                attempt += 1
        if guardian.poll_fault("serve.decode",
                               ("nan_output", "raise")) is not None:
            # poisoned outputs: commit nothing from this launch; the
            # program itself is sound, so no rebuild
            self._degrade("decode_fault", {"injected": True})
            self._recover_with_fallback()
            return None
        return outputs

    def _completed(self, out, attempt):
        """The monitored wait for a launch's outputs (`_launch`), then
        copies of them (`_read_outputs`). `StepHang` goes to the caller's
        ladder; any other error here is one the step's event or output copy
        reported, and goes to `_device_fault`, which raises it."""
        try:
            self._monitor.wait(out[1], "decode", attempt)
            return self._read_outputs(out)
        except StepHang:
            raise
        except RuntimeError as exc:
            self._device_fault(exc)
            raise

    @torch.no_grad()
    def _decode_step_eager(self):
        """The decode step without the program: the slot state staged into
        a fresh host buffer, copied to a fresh device buffer, fresh views
        over it, and the step's launches one by one. No entry point reaches
        it; it stays to time the program against."""
        s, m = self.max_batch_size, self.max_blocks_per_seq
        host = _slot_buffer(s, m, torch.device("cpu"))
        self._stage(_host_slot_views(host, s, m), self._active)
        slots = _slot_views(host.to(self.device), s, m)
        self._decode_code(slots, self._paged_views(*slots[1:4]),
                          self._samples(self._active))
        return tuple(v.cpu().numpy() for v in self._out_views)

    def _paged_views(self, tables, lens, active):
        quant = self._k_scales is not None
        return [PagedCacheView(self._k_pools[l], self._v_pools[l], tables,
                               lens, active, self.block_size,
                               k_scales=self._k_scales[l] if quant else None,
                               v_scales=self._v_scales[l] if quant else None,
                               kernel=self._attn_kernel)
                for l in range(self._k_pools.shape[0])]

    def _decode_forward(self, slots, views):
        """The decode step's model part over slot-state views (`_slot_views`)
        and paged views over them: the input tokens (the host's where
        ``override`` is set, else the fed-back ones), the forward, and the
        input token into each active slot's history at ``lens``. Returns
        the logits ``[S, 1, V]``."""
        tokens, _, lens, active = slots[:4]
        tokens = torch.where(slots[9], tokens, self._feedback)
        with self._armed(slots[10]):
            logits = self._model(tokens[:, None], caches=views)[0]
        at = lens.long().clamp(0, self.max_context - 1)[:, None]
        hist = self._history
        hist.scatter_(1, at, torch.where(active[:, None], tokens[:, None],
                                         hist.gather(1, at)))
        return logits

    def _decode_head(self, slots, logits, sampled):
        """The decode step's sampler over `_decode_forward`'s logits, at
        position ``lens + 1``, writing into the output and feedback
        buffers. With ``sampled`` False (no launched slot samples) every
        row takes its raw argmax without the processors' sort: the outputs
        of each greedy row are those of the full head, bit for bit."""
        _, _, lens, _, temps, top_k, top_p, penalty, seeds = slots[:9]
        valid = self._positions[None, :] <= lens[:, None]
        sample_tokens(logits[:, -1, :], temps, top_k, top_p, penalty, seeds,
                      lens + 1, self._history, valid, self._logprobs_topk,
                      out=self._out_views, feedback=self._feedback,
                      greedy_only=not sampled, filtered=self._filtered)

    def _decode_code(self, slots, views, sampled):
        """`_decode_forward`, then `_decode_head`; returns the logits."""
        logits = self._decode_forward(slots, views)
        self._decode_head(slots, logits, sampled)
        return logits

    @torch.no_grad()
    def _build_decode(self, warm=True):
        """Build the decode program, once: the paged views over the static
        slot buffers and the pools; on the card, one eager warm-up step on
        a side stream (it loads cuBLAS and the kernels' libraries and
        modules before capture), then three CUDA graph captures: the
        forward (`_decode_forward`) and, over its logits, the sampler head
        (`_decode_head`) with and without the processors. The program
        replays the forward's graph, then the full head's where a launched
        slot samples and the greedy head's elsewhere. Runs before the first
        step's copy into the buffers, so the warm-up sees every slot
        inactive and writes no live block and no history. A rebuild
        (``warm=False``, the watchdog's) captures without the warm-up,
        which would run the live slots' step again."""
        slots = _slot_views(self._slots_dev, self.max_batch_size,
                            self.max_blocks_per_seq)
        views = self._paged_views(*slots[1:4])
        self._stats.decode_compiles += 1
        if self.device.type != "cuda":
            self._decode_program = functools.partial(
                _weak_method(self._decode_code), slots, views)
            return
        if warm:
            def step():
                logits = self._decode_forward(slots, views)
                for sampled in (True, False):
                    self._decode_head(slots, logits, sampled)

            warm_up(step, self.device)
        forward, logits = capture_graph(
            functools.partial(self._decode_forward, slots, views))
        heads = {sampled: capture_graph(functools.partial(
            self._decode_head, slots, logits, sampled))[0]
            for sampled in (True, False)}

        def replay(sampled):
            forward()
            heads[sampled]()
            return logits

        self._decode_program = replay

    def _event(self):
        """An event recorded on the current stream (None on the CPU, where
        every copy is done when it returns)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _samples(self, active):
        """Whether any of the `active` slots samples (temperature > 0): the
        step then runs the full sampler head."""
        return bool((self._temps[active] > 0).any())

    def _stage(self, staged, active):
        """Copy the host mirrors (with `active`, the slots a launch decodes)
        into the numpy views of a host slot buffer (`_host_slot_views`)."""
        for dst, src in zip(staged, (self._tokens, self._tables, self._lens,
                                     active, self._temps, self._topks,
                                     self._topps, self._rpens, self._seeds,
                                     self._override, self._aslots),
                            strict=True):
            np.copyto(dst, src)

    @torch.no_grad()
    def _launch(self, active):
        """Launch one decode step: stage the host mirrors (with `active`,
        the slots it decodes) into this turn's host buffer, copy them to the
        device in one copy, run the decode program, and copy the outputs to
        this turn's host buffer. Returns that buffer's ``(numpy views,
        event)``; the event follows the output copy. The host buffers take
        turns: a launch rewrites one only after the event of its last copy,
        and the output buffer of launch N is read (committed) before launch
        N + 2."""
        if self._decode_program is None:
            self._build_decode()
        elif self._decode_stale:
            self._rebuild_if_idle()
        turn = self._launches % 2
        self._launches += 1
        staging = self._staging[turn]
        host, staged, copied = staging
        if copied is not None:
            copied.synchronize()
        self._stage(staged, active)
        self._slots_dev.copy_(host, non_blocking=True)
        staging[2] = self._event()
        self._decode_program(self._samples(active))
        out_host, views = self._outputs[turn]
        out_host.copy_(self._out_dev, non_blocking=True)
        self._last_event = self._event()
        return views, self._last_event

    @staticmethod
    def _read_outputs(out):
        """Wait for a launch's outputs (`_launch`) and return copies of
        them: ``(next_token [S], chosen_logprob [S], alt_ids [S, K],
        alt_logprobs [S, K])``."""
        return _copies(*out)

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
        self._override[slot] = True

    # ------------------------------------------------------------------
    # multi-tenant serving (serving/tenancy.py)
    # ------------------------------------------------------------------
    def _prefix_hook(self, req):
        """try_admit's shared-prefix acquisition: the longest cached block
        run matching the head's context among blocks prefilled under the
        same adapter (its KV depends on the adapter), increfed for the
        admission (the scheduler frees it again when the admission
        fails)."""
        return self._prefix.acquire(req.prompt + req.generated,
                                    namespace=req.adapter)

    def _reclaim_prefix(self, num_free_target):
        """Drop cold prefix-index entries (leaf first, least popular first)
        until the allocator can serve `num_free_target` free blocks. True
        when anything was freed."""
        dropped = self._prefix.reclaim(num_free_target)
        self._stats.prefix_evictions += dropped
        return dropped > 0

    def _take_block(self, req, take):
        """Claim one block for `req` by `take()` (truthy once it got one),
        climbing the pool-pressure ladder while the pool is dry: cold
        prefix entries go first, then the newest other stream is
        preempted; with neither left, `req` steps aside (requeued) unless
        every other tenant is protected (the aging guard), and then fails
        with kv_exhausted. Returns take()'s result, or None when `req` no
        longer runs. KV growth and the copy-on-write target share it."""
        sched = self.scheduler
        while True:
            got = take()
            if got:
                return got
            if self._prefix is not None and self._reclaim_prefix(1):
                continue
            victim = sched.preempt_victim(exclude=req)
            if victim is not None:
                self._evict(victim)
                continue
            if not sched.protected(req):
                self._evict(req)
            else:
                self._fail(req, "kv_exhausted")
            return None

    def _cow_sweep(self):
        """Copy-on-write boundary: before the next launch writes each
        stream's KV at position ``cached_len`` (in pipelined mode the
        previous launch already moved ``cached_len``, so this is the block
        the NEXT launch writes), any stream whose write block is still
        shared (refcount > 1: a prefix entry or another stream owns it
        too) gets a private copy: the copy, a table edit that the next
        launch's staging copy carries, a decref of the original. The fused
        paged kernel writes (and with int8 pools requantizes) its write
        block in place, so it must never see a shared one."""
        sched = self.scheduler
        alloc = self.cache.allocator
        for req in sorted(list(sched.running), key=lambda r: r.admit_seq):
            if req.state != RUNNING:
                continue      # evicted or failed by an earlier copy's ladder
            wi = req.cached_len // self.block_size
            if wi >= len(req.blocks):
                continue
            src = req.blocks[wi]
            if alloc.refcount(src) <= 1:
                continue
            got = self._take_block(req, lambda: alloc.allocate(1))
            if got is None:
                continue
            dst = got[0]
            self._copy_block(src, dst)
            # the decref leaves src with its other owners (its refcount
            # was > 1), so no later allocation can hand it out while a
            # launch queued before this copy may still read it
            alloc.free([src])
            req.blocks[wi] = dst
            self._sync_slot(req)
            self._stats.cow_copies += 1

    @torch.no_grad()
    def _copy_block(self, src, dst):
        """Copy pool block `src` into `dst`: every layer's K and V and, with
        int8 pools, the scale rows. The copies are queued on the current
        stream, so they read `src` after every launch queued before them
        wrote it and before the next launch writes `dst`."""
        for pool in (self._k_pools, self._v_pools, self._k_scales,
                     self._v_scales):
            if pool is not None:
                pool[:, dst].copy_(pool[:, src])

    def register_adapter(self, name, weights=None, scale=1.0, seed=None):
        """Install a tenant's adapter into a free slot of the stacks (in
        place: no graph is rebuilt). See `tenancy.AdapterSet.register` for
        the weights' layout."""
        if self._adapters is None:
            raise ValueError(
                "engine was built with max_adapters=0; adapters need "
                "max_adapters > 0 at construction (the stacks' shapes are "
                "fixed with the captured graphs)")
        return self._adapters.register(name, weights=weights, scale=scale,
                                       seed=seed)

    def unregister_adapter(self, name):
        """Free a departed tenant's slot and drop the prefix entries
        prefilled under it. Refuses while a live stream still decodes
        under the adapter."""
        if self._adapters is None:
            raise ValueError("engine was built with max_adapters=0")
        live = [r.rid for r in (list(self.scheduler.waiting)
                                + list(self.scheduler.running))
                if r.adapter == name]
        if live:
            raise ValueError(
                f"adapter {name!r} still serves live requests {live}; "
                "drain or cancel them first")
        slot = self._adapters.unregister(name)
        if self._prefix is not None:
            self._prefix.invalidate(name)
        return slot

    def _params_crc(self):
        """CRC over every parameter's bytes: the identity of the serving
        weight set."""
        crc = 0
        for p in self._model.parameters():
            crc = zlib.crc32(_host_bytes(p), crc)
        return crc

    def stage_weights(self, values):
        """Stage a live weight hot-swap: `values` (one array or tensor per
        ``model.parameters()`` entry, in the port's order and layout;
        `convert.jax_state_values` gives them from the JAX model's arrays)
        replace the weights at the next iteration boundary, so every token
        is produced under one weight set or the other. Returns True when
        staged, False when the set is byte-identical to the serving one."""
        if not self._hot_swap:
            raise ValueError(
                "engine was built without hot_swap=True; build it with "
                "hot_swap=True to swap its weights")
        params = list(self._model.parameters())
        if len(values) != len(params):
            raise ValueError(f"stage_weights: got {len(values)} arrays for "
                             f"{len(params)} parameters")
        vals, crc = [], 0
        for p, v in zip(params, values):
            t = (v.detach() if torch.is_tensor(v)
                 else torch.tensor(np.asarray(v))).to("cpu", p.dtype)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"stage_weights: shape {tuple(t.shape)} "
                                 f"does not match parameter shape "
                                 f"{tuple(p.shape)}")
            crc = zlib.crc32(_host_bytes(t), crc)
            vals.append(t)
        if crc == self._weights_crc and self._pending_weights is None:
            return False
        self._pending_weights = ([t.to(self.device, copy=True)
                                  for t in vals], crc)
        return True

    def swap_weights(self, values):
        """Stage and commit a hot-swap: between steps the cutover happens
        at once; from inside a streaming callback it commits at the next
        iteration boundary. Returns the serving weight epoch."""
        if self.stage_weights(values) and not self._stepping:
            self._commit_swap()
        return self._weight_epoch

    @torch.no_grad()
    def _commit_swap(self):
        """The cutover: commit a pipelined launch in flight (issued under
        the old weights), preempt every running stream (they re-prefill
        under the new weights and continue from their emitted tokens; a
        planned cutover, so no eviction is counted), empty the prefix
        index (cached KV is a function of the weights), copy the staged
        values into each parameter's existing storage (the captured
        graphs read the parameters by address: rebinding them would leave
        the graphs on the old weights) and bump the epoch."""
        self._flush_inflight()
        values, crc = self._pending_weights
        self._pending_weights = None
        sched = self.scheduler
        for req in list(sched.running):
            slot = req.slot
            sched.preempt(req)
            if slot is not None:
                self._clear_slot(slot)
        if self._prefix is not None:
            self._prefix.invalidate()
        for p, v in zip(self._model.parameters(), values):
            p.copy_(v)
        self._weight_epoch += 1
        self._weights_crc = crc
        self._stats.weight_swaps += 1

    @property
    def weight_epoch(self):
        """Serving weight-set generation (0 = the construction weights)."""
        return self._weight_epoch

    # ------------------------------------------------------------------
    # watchdog and degraded-mode recovery (serving/resilience.py)
    # ------------------------------------------------------------------
    def _degrade(self, reason, detail):
        """Enter (or deepen) degraded mode; `degrade_reason` keeps the
        transition (the reference emits it as a ``serve.degrade``
        event)."""
        self.degraded = True
        self.degrade_reason = (reason, dict(detail))

    def _recovered(self):
        """A clean decode step: leave degraded mode."""
        self.degraded = False

    def _on_hang(self, attempt):
        """One watchdog firing on the serial decode step: climb the
        ladder. True: wait again for the same launch (rung 1, or rung 2
        after asking for a rebuild); False after rung 3 (every running
        request failed with ``step_hang``, a rebuild asked for)."""
        self._stats.hangs += 1
        if attempt >= 3:
            self._degrade("step_hang", {"rung": "fail_active"})
            for req in list(self.scheduler.running):
                self._fail(req, "step_hang")
            self._rebuild_decode()
            return False
        if attempt == 1:
            self._degrade("step_hang", {"rung": "retry"})
        else:
            self._degrade("step_hang", {"rung": "rebuild"})
            self._rebuild_decode()
        return True

    def _rebuild_decode(self):
        """Ask for a recapture of the decode program (counted in
        `decode_compiles` when it runs), without a warm-up. A capture waits
        for the whole device (`kernels.capture_graph`), so it runs only
        once the last launch has completed: now if it has, else at the
        first `_launch` that finds it completed; launches until then
        replay the old graphs. So a device that never finishes the step
        never blocks the ladder, and the old graphs, let go when the new
        program replaces them, are never freed while a replay of them may
        still run."""
        if self._decode_program is not None:
            self._decode_stale = True
            self._rebuild_if_idle()

    def _rebuild_if_idle(self):
        """The rebuild `_rebuild_decode` asked for, if the last launch has
        completed (on the CPU, always)."""
        last = self._last_event
        if last is None or last.query():
            self._decode_stale = False
            self._build_decode(warm=False)

    def _device_fault(self, exc):
        """An error that a decode step's event or output copy reported:
        every running request fails with ``decode_fault``, and the caller
        raises `exc` (recovery is a restart from the last `state_payload`
        snapshot). Nothing finishes on another path. A device synchronize
        tells a sticky error (the context is lost: it raises again) from
        one the process survives; after the latter the pools, which the
        step may have written in part, are zeroed (`_reset_kv_state`) and
        the program is rebuilt, so that a caller who goes on stepping
        serves queued and new work."""
        sticky = False
        if self.device.type == "cuda":
            try:
                torch.cuda.synchronize(self.device)
            except RuntimeError:
                sticky = True
        self._degrade("decode_fault", {"organic": True, "sticky": sticky,
                                       "error": str(exc)[:200]})
        for req in list(self.scheduler.running):
            self._fail(req, "decode_fault")
        if not sticky:
            self._reset_kv_state()
            self._rebuild_decode()

    def _recover_with_fallback(self):
        """Finish every running stream through the model's `generate`
        (`_fallback_eager`) after a poisoned launch (an injected
        ``nan_output``); the pools and the program stay as they are."""
        for req in list(self.scheduler.running):
            self._fallback_eager(req)

    @torch.no_grad()
    def _fallback_eager(self, req):
        """Finish one request through ``model.generate`` (greedy) from its
        prompt and emitted tokens, streamed through the normal emission
        path; an adapter tenant's under its merged weights."""
        self._stats.eager_fallbacks += 1
        remaining = req.remaining_tokens
        if remaining > 0:
            ctx = np.asarray([req.prompt + req.generated], np.int64)
            merged = (self._adapters.merged(req.adapter)
                      if self._adapters is not None
                      and req.adapter is not None
                      else contextlib.nullcontext())
            with merged:
                out = self._model.generate(ctx, max_new_tokens=remaining,
                                           do_sample=False)
            for tok in out[0].tolist():
                if req.finished:
                    break
                self._emit_token(req, int(tok))
        if not req.finished:
            self._finish(req)

    @torch.no_grad()
    def _reset_kv_state(self):
        """A fresh block pool and slot state after the pools stopped being
        trustworthy. Only with no running stream (the callers retire them
        first); queued requests hold no blocks and re-prefill. The pools
        are zeroed in place (the captured graphs read them by address), the
        allocator is new, and the prefix index forgets its entries."""
        if self.scheduler.running:
            raise RuntimeError("KV reset with running streams would "
                               "corrupt them")
        for pool in (self._k_pools, self._v_pools, self._k_scales,
                     self._v_scales):
            if pool is not None:
                pool.zero_()
        self.cache.allocator = BlockAllocator(self._num_blocks)
        self.scheduler.allocator = self.cache.allocator
        for slot in range(self.max_batch_size):
            self._clear_slot(slot)
        self._aslots[:] = 0
        self._history_rows.zero_()
        self._reset_pipeline()
        if self._prefix is not None:
            self._prefix.reset(self.cache.allocator)

    # ------------------------------------------------------------------
    # crash-resume (serving/resilience.py, incubate.ServeCheckpointer)
    # ------------------------------------------------------------------
    def state_payload(self):
        """JSON-able snapshot of every live request (prompt, emitted
        tokens, arrival order, remaining TTL, adapter, sampler), never
        the KV pool, which re-prefills token-identically on resume; with
        tenancy (hot swap or adapters) the weight epoch and CRC and the
        registered adapters too. The reference's dict: a JAX engine's
        snapshot restores here and this one there."""
        now = time.perf_counter_ns()
        live = sorted(list(self.scheduler.waiting)
                      + list(self.scheduler.running),
                      key=lambda r: (r.arrival_seq
                                     if r.arrival_seq is not None else -1))
        payload = {"version": 1, "kind": "serve_state",
                   "next_rid": self._next_rid,
                   "requests": [request_payload(r, now) for r in live]}
        if self._tenant:
            payload["weight_epoch"] = self._weight_epoch
            payload["weights_crc"] = self._weights_crc
            payload["swap_pending"] = self._pending_weights is not None
            payload["adapters"] = ([] if self._adapters is None
                                   else self._adapters.names())
        return payload

    def restore_state(self, payload, on_token=None):
        """Re-admit every request of a `state_payload()` snapshot in its
        arrival order, each QUEUED with its emitted tokens: its first
        admission re-prefills prompt + emitted tokens and the stream
        continues byte-identically. `on_token`: None, one callable for
        every request, or ``{request_id: callable}``. Refuses
        (`ServeRefusal`) with ``torn_swap`` when a hot-swap engine serves
        another weight set than the snapshot's, ``adapter_mismatch`` for a
        request whose adapter is not registered here; ValueError for a
        request id live in this engine. Returns the restored Requests."""
        if not payload:
            return []
        crc = payload.get("weights_crc")
        if self._hot_swap and crc is not None and crc != self._weights_crc:
            raise ServeRefusal(
                "torn_swap",
                f"state snapshot was taken under weights_crc {crc:#x} but "
                f"this engine serves {self._weights_crc:#x}; load the "
                "matching weight set before restoring",
                {"payload_crc": crc, "engine_crc": self._weights_crc})
        restored = []
        for rp in sorted(payload.get("requests", ()),
                         key=lambda p: p.get("arrival_seq") or 0):
            rid = rp["rid"]
            ad = rp.get("adapter")
            if ad is not None and (self._adapters is None
                                   or not self._adapters.is_registered(ad)):
                raise ServeRefusal(
                    "adapter_mismatch",
                    f"restore_state: request {rid!r} decodes under adapter "
                    f"{ad!r}, which is not registered in this engine; "
                    "re-register every tenant before restoring",
                    {"rid": rid, "adapter": ad})
            prev = self.requests.get(rid)
            if prev is not None and not prev.finished:
                raise ValueError(f"restore_state: request id {rid!r} is "
                                 "already live in this engine")
            cb = (on_token.get(rid) if isinstance(on_token, dict)
                  else on_token)
            req = payload_request(rp, cb)
            self.scheduler.enqueue(req)
            self.requests[rid] = req
            self._stats.resumed += 1
            restored.append(req)
        self._next_rid = max(self._next_rid,
                             int(payload.get("next_rid") or 0))
        self._weight_epoch = max(self._weight_epoch,
                                 int(payload.get("weight_epoch") or 0))
        return restored

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
        try:
            if req.on_token is not None:
                text = None
                if self._tokenizer is not None:
                    text = self._tokenizer.decode([tok])
                req.on_token(req, tok, text)
        finally:
            # also when the callback raised: a stream that reached its
            # last token retires, whichever engine emitted it
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
