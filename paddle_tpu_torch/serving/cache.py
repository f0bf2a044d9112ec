"""Paged KV cache: block-pool attention memory for continuous batching.

Counterpart of `paddle_tpu/serving/cache.py` (the PagedAttention memory
model): ONE preallocated block pool per layer, stacked over layers as
``[L, num_blocks, block_size, H, D]`` on the engine's device; each sequence
owns an ordered list of block ids (its block table), and token position
``p`` lives at ``(table[p // block_size], p % block_size)``. Admission,
growth, eviction and preemption are host-side edits of integer tables.

Block 0 is the reserved null block: inactive slots and padded table
entries point at it, so gathers and scatters need no branch; its content
is garbage by design and is always masked out of attention.

``dtype=torch.int8`` is the quantized KV mode (quantization/kv_cache.py):
int8 pools plus fp32 per-block-per-head scales ``[L, num_blocks, H]``
(`k_scales` / `v_scales`), one byte per cached element. The allocator and
sizing are copied as they are (pure Python).
"""
from __future__ import annotations

from collections import deque

import torch

from ..device import resolve_device
from ..kernels.prefill_scatter import prefill_scatter

__all__ = ["BlockAllocator", "PagedKVCache", "PagedCacheView",
           "scatter_prefill", "NULL_BLOCK", "pool_bytes_per_block",
           "num_blocks_for_bytes"]

# block id 0 is never allocated: it is the write/read target for inactive
# slots and out-of-range table entries (see module docstring)
NULL_BLOCK = 0


class BlockAllocator:
    """Host-side refcounted free-list allocator over the pool's block ids.

    Pure bookkeeping — no device state. O(1) allocate/free; the free
    count is the scheduler's admission-watermark signal. Ownership is
    refcounted (a block aliased into several tables carries one reference
    per owner); `free` is a decref that returns the block to the free list
    only at zero, so `num_free` counts every shared block once.
    """

    def __init__(self, num_blocks):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (one is the reserved null block), got "
                f"{num_blocks}")
        self.num_blocks = int(num_blocks)
        # block 0 reserved; 1..num_blocks-1 allocatable
        self._free = deque(range(1, self.num_blocks))
        self._refs = {}          # block id -> refcount (allocated only)

    @property
    def num_free(self):
        return len(self._free)

    @property
    def capacity(self):
        """Allocatable blocks (pool minus the null block)."""
        return self.num_blocks - 1

    @property
    def num_shared(self):
        """Allocated blocks with more than one owner (prefix aliases)."""
        return sum(1 for rc in self._refs.values() if rc > 1)

    def refcount(self, block):
        """Live owners of `block` (0 when free/never allocated)."""
        return self._refs.get(block, 0)

    def allocate(self, n):
        """Pop `n` block ids (each at refcount 1), or None (allocating
        nothing) when fewer than `n` are free — admission is
        all-or-nothing."""
        if n > len(self._free):
            return None
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def incref(self, block):
        """Add an owner to an ALLOCATED block."""
        if block == NULL_BLOCK:
            raise ValueError("attempt to share the reserved null block")
        rc = self._refs.get(block)
        if rc is None:
            raise ValueError(
                f"incref of free/unallocated block {block}")
        self._refs[block] = rc + 1

    def free(self, blocks):
        """Drop one owner per listed block; a block rejoins the free
        list only when its LAST owner lets go."""
        for b in blocks:
            if b == NULL_BLOCK:
                raise ValueError("attempt to free the reserved null block")
            rc = self._refs.get(b)
            if rc is None:
                raise ValueError(f"free of unallocated block {b}")
            if rc == 1:
                del self._refs[b]
                self._free.append(b)
            else:
                self._refs[b] = rc - 1


class PagedCacheView:
    """One layer's paged cache as the model sees it during a decode step:
    the layer's pools (views into the engine's stacked pools, written in
    place) plus the batch's block tables / lengths / active mask as device
    tensors. `GPTAttention` detects this view by its `block_tables`
    attribute and routes to the paged decode path. In int8 mode it also
    carries the layer's scales ``[num_blocks, H]`` (`k_scales` /
    `v_scales`), written in place with the pools. `kernel` is the engine's
    attention variant (`nn.functional.attention.PAGED_KERNELS`)."""

    __slots__ = ("k_pool", "v_pool", "block_tables", "seq_lens", "active",
                 "block_size", "k_scales", "v_scales", "kernel")

    def __init__(self, k_pool, v_pool, block_tables, seq_lens, active,
                 block_size, k_scales=None, v_scales=None,
                 kernel="blockwise"):
        self.k_pool = k_pool
        self.v_pool = v_pool
        self.block_tables = block_tables
        self.seq_lens = seq_lens
        self.active = active
        self.block_size = int(block_size)
        self.k_scales = k_scales
        self.v_scales = v_scales
        self.kernel = kernel

    def updated(self, k_pool, v_pool, k_scales=None, v_scales=None):
        return PagedCacheView(k_pool, v_pool, self.block_tables,
                              self.seq_lens, self.active, self.block_size,
                              k_scales=k_scales, v_scales=v_scales,
                              kernel=self.kernel)


def is_int8(dtype):
    """Does `dtype` (``"int8"`` or ``torch.int8``) name the quantized KV
    mode?"""
    return dtype in ("int8", torch.int8)


def _check_dtype(dtype):
    if not (is_int8(dtype) or dtype.is_floating_point):
        raise ValueError(f"KV pools are floating point or int8, got {dtype}")


class PagedKVCache:
    """The device pools + the allocator, sized once at engine start.
    Pools are ``[L, num_blocks, block_size, H, D]`` on `device`
    (``None``: ``cuda``, raising where there is no card); with
    ``dtype=torch.int8`` they are int8 and `k_scales` / `v_scales` hold
    fp32 ``[L, num_blocks, H]`` (else None)."""

    def __init__(self, num_layers, num_heads, head_dim, num_blocks,
                 block_size, dtype=torch.float32, device=None):
        _check_dtype(dtype)
        device = resolve_device(device)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.quantized = is_int8(dtype)
        self.dtype = torch.int8 if self.quantized else dtype
        shape = (self.num_layers, self.num_blocks, self.block_size,
                 self.num_heads, self.head_dim)
        self.k_pools = torch.zeros(shape, dtype=self.dtype, device=device)
        self.v_pools = torch.zeros(shape, dtype=self.dtype, device=device)
        self.k_scales = self.v_scales = None
        if self.quantized:
            sshape = (self.num_layers, self.num_blocks, self.num_heads)
            self.k_scales = torch.zeros(sshape, dtype=torch.float32,
                                        device=device)
            self.v_scales = torch.zeros(sshape, dtype=torch.float32,
                                        device=device)
        self.allocator = BlockAllocator(self.num_blocks)


def pool_bytes_per_block(num_layers, num_heads, head_dim, block_size,
                         dtype=torch.float32):
    """Device bytes ONE pool block costs across k+v (and the int8 scales)
    over every layer — the unit of the serving capacity math."""
    _check_dtype(dtype)
    if is_int8(dtype):
        payload = block_size * num_heads * head_dim         # 1 byte/elem
        return 2 * num_layers * (payload + num_heads * 4)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * num_layers * block_size * num_heads * head_dim * itemsize


def num_blocks_for_bytes(budget_bytes, num_layers, num_heads, head_dim,
                         block_size, dtype=torch.float32):
    """Blocks a byte budget buys (>= 2: the null block + one real one)."""
    per = pool_bytes_per_block(num_layers, num_heads, head_dim,
                               block_size, dtype)
    return max(2, int(budget_bytes) // per)


def scatter_prefill(k_pools, v_pools, k_layers, v_layers, block_row,
                    length, block_size, k_scales=None, v_scales=None):
    """Bulk-insert a prefilled prompt's K/V into the pools, in place.

    k_layers/v_layers: per-layer ``[T_bucket, H, D]`` prompt K/V from the
    bucketed prefill (right-padded to the bucket). block_row:
    ``[max_blocks]`` int32 tensor, the sequence's block table. length:
    the true prompt length, an int or a 0-dim int32 tensor on the pools'
    device; padded positions are never written into a real block
    (attention masks by length). With int8 pools pass the scales ``[L,
    num_blocks, H]``: each layer's tokens quantize under freshly computed
    per-block-per-head scales (`quantize_scatter`), and the call returns
    ``(k_pools, v_pools, k_scales, v_scales)``. Otherwise returns the
    pools. On the card every layer's write is one kernel launch
    (`kernels.prefill_scatter`); on the CPU its twin runs, which routes
    the padded positions to the null block.
    """
    prefill_scatter(k_pools, v_pools, k_layers, v_layers, block_row, length,
                    block_size, k_scales=k_scales, v_scales=v_scales)
    if k_scales is not None:
        return k_pools, v_pools, k_scales, v_scales
    return k_pools, v_pools
