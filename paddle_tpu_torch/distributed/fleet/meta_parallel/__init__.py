"""Meta-parallel, PyTorch port: the data-parallel part of
`paddle_tpu/distributed/fleet/meta_parallel/`. The tensor-parallel
layers, the pipeline and the sequence-parallel attention are ROADMAP
item 7(b)."""
from .hybrid_optimizer import (  # noqa: F401
    HybridParallelClipGrad, HybridParallelOptimizer,
)

__all__ = ["HybridParallelOptimizer", "HybridParallelClipGrad"]
