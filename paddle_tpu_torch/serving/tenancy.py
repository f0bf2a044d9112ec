"""Multi-tenant serving primitives, PyTorch port: shared-prefix KV reuse
and batched low-rank adapters.

Counterpart of `paddle_tpu/serving/tenancy.py`.

  * `PrefixCache` is a copy of the reference's (pure host Python over the
    refcounted `BlockAllocator`): a content-addressed index of
    prompt-aligned blocks in the paged pool. Full blocks key by a rolling
    chain digest; partial tails key under their parent with the exact
    token tuple, and a lookup may also take the leading tokens of a
    published block, which is the copy-on-write case. The index holds its
    own reference on every published block; reclaim drops leaves first,
    least aged hit count first, recency breaking ties. A match is capped
    at ``len - 1`` tokens, so the decode step, never the prefill, produces
    the first sampled token. One change: every chain starts at a root of
    its `namespace` (the engine passes the request's adapter name), since
    a prompt's K and V depend on the adapter its qkv projection ran
    under. The reference keys by tokens alone, so its adapter tenants
    attend over KV that another tenant's adapter computed; the base
    namespace (None) keeps the reference's root, so base-tenant traffic
    is indexed exactly as there.

  * `AdapterSet` holds per-tenant low-rank deltas of the attention
    projections (``qkv_proj``, ``out_proj``) in fixed padded stacks on the
    model's device, ``A [K, L, in, r]`` and ``B [K, L, r, out]`` per
    target and ``scale [K]`` (fp32), K = max_adapters + 1 with slot 0 the
    all-zero base. The stacks are allocated once: `register` and
    `unregister` write into them in place (copies on the device's stream,
    ordered behind every launch already queued), so the engine's captured
    CUDA graphs, which read them by address, serve a new tenant without a
    recapture. `install` adds a forward hook to every target projection;
    while the engine arms it (`arm`) the hook adds the rows' deltas to the
    projection's output in place through `kernels.lora_delta` (the
    hand-written kernel on the card, its plain twin on the CPU), before
    the output is viewed as heads, where the reference's instance forward
    applies it. Unarmed, the hook leaves the output untouched.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
import zlib

import numpy as np
import torch

from ..kernels.lora_delta import lora_delta

__all__ = ["PrefixCache", "AdapterSet"]

# chain root for the first block of every prompt of the base namespace
_ROOT = "prefix:root"


# `PrefixCache.invalidate`'s default: every namespace
_EVERY = object()


def _root(namespace):
    return _ROOT if namespace is None else (_ROOT, namespace)


def _digest(parent, tokens):
    """Rolling chain digest: stable across processes (crc32, not Python's
    salted hash), the reference's exactly."""
    h = zlib.crc32(repr(parent).encode())
    h = zlib.crc32(repr(tuple(int(t) for t in tokens)).encode(), h)
    return h


# acquires between hit-count halvings: popularity decays, so yesterday's
# hot prompt cannot squat on the blocks today's traffic needs
_AGE_PERIOD = 256


class _Entry:
    __slots__ = ("key", "parent", "block", "tokens", "hits", "tick",
                 "namespace")

    def __init__(self, key, parent, block, tokens, tick=0, namespace=None):
        self.key = key
        self.parent = parent
        self.block = block
        self.tokens = tokens      # the tokens whose KV this block holds
        self.hits = 0             # aged popularity (halved every period)
        self.tick = tick          # last-use tick (recency tie-break)
        self.namespace = namespace


class PrefixCache:
    """Content-hash index of prompt-aligned block runs in the paged pool.

    `acquire(tokens)` returns the longest cached run matching a prompt
    prefix, already increfed; `publish(tokens, blocks)` indexes a freshly
    prefilled prompt's blocks (increfing them for the index); `reclaim(n)`
    drops cold leaves until the allocator has `n` free blocks;
    `invalidate()` empties the index (a weight hot-swap: cached KV is a
    function of the weights), `invalidate(namespace)` one namespace's
    chains (an adapter left); `reset(allocator)` forgets everything
    without releasing (the pool was rebuilt). `namespace` (default None,
    the reference's one index) separates chains whose KV differs for the
    same tokens.
    """

    def __init__(self, allocator, block_size):
        self.allocator = allocator
        self.block_size = int(block_size)
        self._lock = threading.Lock()
        self._entries = {}          # key -> _Entry
        self._children = {}         # parent key -> {key: _Entry}
        self._tick = 0              # lookup clock for recency ordering
        self.hits = 0
        self.misses = 0

    @property
    def entries(self):
        with self._lock:
            return len(self._entries)

    def _walk(self, tokens, namespace):
        """Longest cached run covering a strict prefix of `tokens` (capped
        at len - 1) in `namespace`. Caller holds the lock. Returns
        (entries, hit_tokens)."""
        bs = self.block_size
        limit = len(tokens) - 1
        path, hit, parent = [], 0, _root(namespace)
        i = 0
        while (i + 1) * bs <= limit:
            key = ("b", _digest(parent, tokens[i * bs:(i + 1) * bs]))
            e = self._entries.get(key)
            if e is None:
                break
            path.append(e)
            parent = key
            hit += bs
            i += 1
        # partial step: the longest common prefix between the remaining
        # tokens and any published child (a tail entry, or the leading
        # tokens of a full block): the next write lands inside this
        # still-shared block, so the engine copies it first
        rest = tokens[hit:limit]
        best, best_t = None, 0
        for e in self._children.get(parent, {}).values():
            t = 0
            for a, b in zip(e.tokens, rest):
                if int(a) != int(b):
                    break
                t += 1
            if t > best_t:
                best, best_t = e, t
        if best is not None and best_t > 0:
            path.append(best)
            hit += best_t
        return path, hit

    def probe(self, tokens, namespace=None):
        """Non-acquiring probe: (shared_block_count, hit_tokens), advisory
        (admission sizing); takes no references."""
        with self._lock:
            path, hit = self._walk(list(tokens), namespace)
            if not self._usable(hit, len(tokens)):
                return 0, 0
            return len(path), hit

    def _usable(self, hit, prompt_len):
        # a hit below one block (unless it covers the whole cacheable
        # prompt) saves less prefill than its chew steps cost
        return hit > 0 and (hit >= self.block_size
                            or hit == prompt_len - 1)

    def _touch(self, e):
        e.hits += 1
        e.tick = self._tick

    def _advance_clock(self):
        """Bump the lookup clock; every `_AGE_PERIOD` ticks halve every hit
        count. Caller holds the lock."""
        self._tick += 1
        if self._tick % _AGE_PERIOD == 0:
            for e in self._entries.values():
                e.hits >>= 1

    def acquire(self, tokens, namespace=None):
        """Longest cached run for a prompt prefix in `namespace`, increfed
        for the caller (one reference per block). Returns (blocks,
        hit_tokens); ([], 0) on a miss. Touches the matched entries."""
        tokens = list(tokens)
        with self._lock:
            self._advance_clock()
            path, hit = self._walk(tokens, namespace)
            if not self._usable(hit, len(tokens)):
                self.misses += 1
                return [], 0
            blocks = []
            for e in path:
                self.allocator.incref(e.block)
                blocks.append(e.block)
                self._touch(e)
            self.hits += 1
            return blocks, hit

    def publish(self, tokens, blocks, include_tail=True, namespace=None):
        """Index a freshly prefilled prompt's aligned blocks in `namespace`;
        every new entry increfs its block for the index.
        `include_tail=False` skips the partial last block (a resume's tail
        holds generated-token KV). Returns the number of entries added."""
        tokens = list(tokens)
        bs = self.block_size
        added = 0
        with self._lock:
            parent = _root(namespace)
            n_full = len(tokens) // bs
            for i in range(n_full):
                chunk = tokens[i * bs:(i + 1) * bs]
                key = ("b", _digest(parent, chunk))
                if key not in self._entries:
                    if i >= len(blocks):
                        break
                    self.allocator.incref(blocks[i])
                    e = _Entry(key, parent, blocks[i], tuple(chunk),
                               tick=self._tick, namespace=namespace)
                    self._entries[key] = e
                    self._children.setdefault(parent, {})[key] = e
                    added += 1
                parent = key
            tail = tokens[n_full * bs:]
            if include_tail and tail and n_full < len(blocks):
                key = ("t", _digest(parent, tail), len(tail))
                if key not in self._entries:
                    self.allocator.incref(blocks[n_full])
                    e = _Entry(key, parent, blocks[n_full], tuple(tail),
                               tick=self._tick, namespace=namespace)
                    self._entries[key] = e
                    self._children.setdefault(parent, {})[key] = e
                    added += 1
        return added

    def _drop(self, e):
        """Remove one entry and release the index's reference. Caller holds
        the lock."""
        self._entries.pop(e.key, None)
        kids = self._children.get(e.parent)
        if kids:
            kids.pop(e.key, None)
            if not kids:
                del self._children[e.parent]
        self.allocator.free([e.block])

    def reclaim(self, num_free_target):
        """Release cold entries until the allocator has `num_free_target`
        free blocks or no leaf is left. Victims are leaves, ordered by
        (aged hit count, last-use tick). Returns the entries dropped."""
        dropped = 0
        with self._lock:
            while self.allocator.num_free < num_free_target:
                victim, best = None, None
                for e in self._entries.values():
                    if self._children.get(e.key):
                        continue              # interior: kids pin it
                    score = (e.hits, e.tick)
                    if best is None or score < best:
                        victim, best = e, score
                if victim is None:
                    break
                self._drop(victim)
                dropped += 1
        return dropped

    def invalidate(self, namespace=_EVERY):
        """Empty the index, or only `namespace`'s chains, releasing the
        index's references. Returns the number of entries released."""
        with self._lock:
            if namespace is _EVERY:
                n = len(self._entries)
                for e in list(self._entries.values()):
                    self.allocator.free([e.block])
                self._entries.clear()
                self._children.clear()
                return n
            gone = [e for e in self._entries.values()
                    if e.namespace == namespace]
            for e in gone:
                self._drop(e)
        return len(gone)

    def reset(self, allocator):
        """Forget everything WITHOUT releasing references (the old
        allocator died with the old pool)."""
        with self._lock:
            self._entries.clear()
            self._children.clear()
            self.allocator = allocator


def _targets(model):
    """``[(layer, target name, nn.Linear)]`` of every adapted projection."""
    return [(layer, name, lin) for layer, block in enumerate(model.gpt.h)
            for name, lin in (("qkv", block.attn.qkv_proj),
                              ("out", block.attn.out_proj))]


def _hook(model, layer, tname):
    """The forward hook of one target projection: with the model armed
    (`AdapterSet.arm`), add each row's delta to the output in place; else
    leave it untouched. The hook holds the model weakly: the model holds
    the hook, and a strong reference would keep the model (its weights,
    its `generate` programs) alive past its last user reference, until
    the next cyclic collection."""
    owner = weakref.ref(model)

    def hook(module, inputs, output):
        model = owner()
        armed = None if model is None else model._tenancy_armed
        if armed is None:
            return None
        ad, idx = armed
        rows = inputs[0].reshape(-1, inputs[0].shape[-1])
        lora_delta(output.view(-1, output.shape[-1]), rows, ad.a[tname],
                   ad.b[tname], ad.scale,
                   idx.expand(rows.shape[0]) if idx.numel() == 1 else idx,
                   layer)
        return None

    return hook


class AdapterSet:
    """Per-tenant low-rank deltas batched into fixed padded stacks on the
    model's device.

    For each target (``"qkv"``, ``"out"``) the set owns ``A [K, L, in, r]``
    and ``B [K, L, r, out]`` in the model's dtype (`a`, `b`), and
    ``scale [K]`` in fp32, K = max_adapters + 1; slot 0 is the base
    adapter, all zeros, whose rows the delta leaves untouched, so base
    tenants stay bit for bit with an adapter-free engine. Registration
    writes values into the stacks in place; their storage never changes.
    """

    def __init__(self, model, max_adapters, rank):
        cfg = model.config
        if max_adapters < 1:
            raise ValueError("max_adapters must be >= 1")
        if rank < 1:
            raise ValueError("adapter rank must be >= 1")
        self.model = model
        self.max_adapters = int(max_adapters)
        self.rank = int(rank)
        self.num_layers = int(cfg.num_hidden_layers)
        hidden = int(cfg.hidden_size)
        param = next(model.parameters())
        self.dtype = param.dtype
        self.device = param.device
        k, l, r = self.max_adapters + 1, self.num_layers, self.rank
        # target name -> (in_features, out_features)
        self.targets = {"qkv": (hidden, 3 * hidden),
                        "out": (hidden, hidden)}
        self.a = {t: torch.zeros((k, l, i, r), dtype=self.dtype,
                                 device=self.device)
                  for t, (i, _) in self.targets.items()}
        self.b = {t: torch.zeros((k, l, r, o), dtype=self.dtype,
                                 device=self.device)
                  for t, (_, o) in self.targets.items()}
        self.scale = torch.zeros(k, dtype=torch.float32, device=self.device)
        self._scale_host = np.zeros(k, np.float32)
        self._lock = threading.Lock()
        self._names = {}            # name -> slot (1..max_adapters)

    # -- registry -----------------------------------------------------------
    def names(self):
        with self._lock:
            return sorted(self._names)

    def slot_of(self, name):
        """Stack slot for an adapter name (0 = base for None)."""
        if name is None:
            return 0
        with self._lock:
            slot = self._names.get(name)
        if slot is None:
            raise KeyError(f"adapter {name!r} is not registered")
        return slot

    def is_registered(self, name):
        if name is None:
            return True
        with self._lock:
            return name in self._names

    def register(self, name, weights=None, scale=1.0, seed=None):
        """Install an adapter into a free slot. `weights` maps target name
        (``"qkv"`` / ``"out"``) to an ``(A [L, in, r], B [L, r, out])``
        pair (numpy arrays or tensors); with ``weights=None`` both factors
        draw from the reference's seeded normal (std 0.05), so a seed
        gives both packages the same adapter. Returns the slot."""
        if name is None:
            raise ValueError("adapter name must be a non-empty string")
        new = {}
        for t, (i, o) in self.targets.items():
            if weights is not None:
                a, b = (torch.as_tensor(np.asarray(w, np.float32)
                                        if not torch.is_tensor(w) else w)
                        for w in weights[t])
            else:
                rng = np.random.default_rng(
                    zlib.crc32(f"{name}:{t}:{seed}".encode()))
                a = torch.from_numpy(rng.normal(
                    0.0, 0.05, (self.num_layers, i, self.rank))
                    .astype(np.float32))
                b = torch.from_numpy(rng.normal(
                    0.0, 0.05, (self.num_layers, self.rank, o))
                    .astype(np.float32))
            want_a = (self.num_layers, i, self.rank)
            want_b = (self.num_layers, self.rank, o)
            if tuple(a.shape) != want_a or tuple(b.shape) != want_b:
                raise ValueError(
                    f"adapter {name!r} target {t!r}: want A{want_a} / "
                    f"B{want_b}, got A{tuple(a.shape)} / B{tuple(b.shape)}")
            new[t] = (a.to(self.dtype), b.to(self.dtype))
        with self._lock:
            if name in self._names:
                raise ValueError(f"adapter {name!r} is already registered")
            used = set(self._names.values())
            slot = next((s for s in range(1, self.max_adapters + 1)
                         if s not in used), None)
            if slot is None:
                raise ValueError(
                    f"all {self.max_adapters} adapter slots are in use")
            self._write(slot, new, float(scale))
            self._names[name] = slot
        return slot

    def unregister(self, name):
        """Free an adapter's slot, zeroing it in place. The caller ensures
        no live stream still decodes under it."""
        with self._lock:
            slot = self._names.pop(name, None)
            if slot is None:
                raise KeyError(f"adapter {name!r} is not registered")
            self._write(slot, None, 0.0)
        return slot

    def _write(self, slot, new, scale):
        """Write slot `slot`'s factors (None: zeros) and scale into the
        stacks in place, on the current stream. Caller holds the lock."""
        for t in self.targets:
            if new is None:
                self.a[t][slot].zero_()
                self.b[t][slot].zero_()
            else:
                self.a[t][slot].copy_(new[t][0])
                self.b[t][slot].copy_(new[t][1])
        self._scale_host[slot] = scale
        self.scale[slot:slot + 1].copy_(
            torch.from_numpy(self._scale_host[slot:slot + 1]))

    # -- model wiring -------------------------------------------------------
    def install(self):
        """Add the delta hook to every target projection of the model, once
        per model (engines built later on the same model share the hooks;
        each arms them with its own stacks)."""
        model = self.model
        if getattr(model, "_tenancy_hooked", False):
            return
        for layer, tname, lin in _targets(model):
            lin.register_forward_hook(_hook(model, layer, tname))
        model._tenancy_hooked = True
        model._tenancy_armed = None

    @contextlib.contextmanager
    def arm(self, idx):
        """Arm the model's hooks with this set for one forward: `idx` is the
        rows' adapter slots, an int32 tensor on the model's device, ``[N]``
        (decode: one a batch slot) or ``[1]`` (prefill: every row one
        slot)."""
        self.model._tenancy_armed = (self, idx)
        try:
            yield
        finally:
            self.model._tenancy_armed = None

    # -- eager merge --------------------------------------------------------
    def merged(self, name):
        """Context manager: fold one adapter into the target weights
        (``W + (A @ B * scale)^T`` in torch's ``[out, in]`` layout) in
        place, restoring the base weights bit for bit on exit. The merge
        is mathematically, not bitwise, equal to the activation-level
        delta."""
        return _MergedAdapter(self, name)


class _MergedAdapter:
    def __init__(self, adapters, name):
        self._adapters = adapters
        self._name = name
        self._saved = []

    @torch.no_grad()
    def __enter__(self):
        ad = self._adapters
        slot = ad.slot_of(self._name)
        if slot == 0:
            return self
        scale = float(ad._scale_host[slot])
        for layer, tname, lin in _targets(ad.model):
            w = lin.weight
            self._saved.append((w, w.detach().clone()))
            delta = (ad.a[tname][slot, layer].float()
                     @ ad.b[tname][slot, layer].float()) * scale
            w.add_(delta.to(w.dtype).T)
        return self

    @torch.no_grad()
    def __exit__(self, *exc):
        for w, saved in self._saved:
            w.copy_(saved)
        self._saved = []
        return False
