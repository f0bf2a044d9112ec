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

The port keeps floating-point pools only; the JAX package's int8 pools
are not ported yet. The allocator and sizing are copied as they are (pure
Python).
"""
from __future__ import annotations

from collections import deque

import torch

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
    attribute and routes to the paged decode path."""

    __slots__ = ("k_pool", "v_pool", "block_tables", "seq_lens", "active",
                 "block_size")

    def __init__(self, k_pool, v_pool, block_tables, seq_lens, active,
                 block_size):
        self.k_pool = k_pool
        self.v_pool = v_pool
        self.block_tables = block_tables
        self.seq_lens = seq_lens
        self.active = active
        self.block_size = int(block_size)

    def updated(self, k_pool, v_pool):
        return PagedCacheView(k_pool, v_pool, self.block_tables,
                              self.seq_lens, self.active, self.block_size)


def _check_fp(dtype):
    if not dtype.is_floating_point:
        raise NotImplementedError(
            f"paddle_tpu_torch keeps floating-point KV pools only; "
            f"{dtype} pools (the JAX package's int8 KV) are not ported")


class PagedKVCache:
    """The device pools + the allocator, sized once at engine start.
    Pools are ``[L, num_blocks, block_size, H, D]`` on `device`."""

    def __init__(self, num_layers, num_heads, head_dim, num_blocks,
                 block_size, dtype=torch.float32, device="cpu"):
        _check_fp(dtype)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.dtype = dtype
        shape = (self.num_layers, self.num_blocks, self.block_size,
                 self.num_heads, self.head_dim)
        self.k_pools = torch.zeros(shape, dtype=dtype, device=device)
        self.v_pools = torch.zeros(shape, dtype=dtype, device=device)
        self.allocator = BlockAllocator(self.num_blocks)


def pool_bytes_per_block(num_layers, num_heads, head_dim, block_size,
                         dtype=torch.float32):
    """Device bytes ONE pool block costs across k+v over every layer — the
    unit of the serving capacity math."""
    _check_fp(dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * num_layers * block_size * num_heads * head_dim * itemsize


def num_blocks_for_bytes(budget_bytes, num_layers, num_heads, head_dim,
                         block_size, dtype=torch.float32):
    """Blocks a byte budget buys (>= 2: the null block + one real one)."""
    per = pool_bytes_per_block(num_layers, num_heads, head_dim,
                               block_size, dtype)
    return max(2, int(budget_bytes) // per)


def scatter_prefill(k_pools, v_pools, k_layers, v_layers, block_row,
                    length, block_size):
    """Bulk-insert a prefilled prompt's K/V into the pools, in place.

    k_layers/v_layers: per-layer ``[T_bucket, H, D]`` prompt K/V from the
    bucketed prefill (right-padded to the bucket). block_row:
    ``[max_blocks]`` int32 device tensor, the sequence's block table.
    length: true prompt length; padded positions are routed to the null
    block (garbage by construction, never read: attention masks by
    length). Returns the pools.
    """
    t_bucket = k_layers[0].shape[0]
    pidx = torch.arange(t_bucket, device=k_pools.device)
    blocks = torch.where(pidx < length,
                         block_row.long()[pidx // block_size],
                         torch.full_like(pidx, NULL_BLOCK))
    offs = pidx % block_size
    for layer, (k, v) in enumerate(zip(k_layers, v_layers)):
        k_pools[layer].index_put_((blocks, offs), k.to(k_pools.dtype))
        v_pools[layer].index_put_((blocks, offs), v.to(v_pools.dtype))
    return k_pools, v_pools
