"""Serving: continuous batching + paged KV cache, PyTorch port.

Counterpart of `paddle_tpu/serving` for the parts ported: `LLMEngine`
(serving/engine.py), `Scheduler` and `Request` (serving/scheduler.py),
`PagedKVCache` and its helpers (serving/cache.py), `ServeRefusal`
(serving/resilience.py) and the sampler (serving/sampling.py).

Quick start::

    from paddle_tpu_torch.incubate.models import GPTForCausalLM, gpt2_124m
    from paddle_tpu_torch.serving import LLMEngine
    model = GPTForCausalLM(gpt2_124m())            # on cuda
    engine = LLMEngine(model, max_batch_size=8, block_size=16)
    outs = engine.generate([[5, 3, 9], [7, 1]], max_new_tokens=32)
"""
from __future__ import annotations

from .cache import (BlockAllocator, PagedKVCache, PagedCacheView,  # noqa: F401
                    scatter_prefill, NULL_BLOCK, pool_bytes_per_block,
                    num_blocks_for_bytes)
from .scheduler import (Request, Scheduler, QUEUED, RUNNING,  # noqa: F401
                        FINISHED, FAILED, CANCELLED, EXPIRED)
from .resilience import ServeRefusal  # noqa: F401
from .engine import LLMEngine, ServeStats  # noqa: F401

__all__ = ["LLMEngine", "ServeStats", "Request", "Scheduler",
           "PagedKVCache", "PagedCacheView", "BlockAllocator",
           "scatter_prefill", "NULL_BLOCK", "QUEUED", "RUNNING",
           "FINISHED", "FAILED", "CANCELLED", "EXPIRED",
           "ServeRefusal", "pool_bytes_per_block", "num_blocks_for_bytes"]
