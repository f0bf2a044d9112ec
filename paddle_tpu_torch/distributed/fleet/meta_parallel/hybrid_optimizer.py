"""HybridParallelOptimizer, PyTorch port, at data parallelism only.

Counterpart of `paddle_tpu/distributed/fleet/meta_parallel/
hybrid_optimizer.py`: the user's optimizer behind a wrapper that passes
everything through (`step`, `clear_grad`, `state_dict`, attribute
reads), its `ClipGradByGlobalNorm` swapped for `HybridParallelClipGrad`.
Over a data-parallel group every rank clips the same averaged gradients,
so the local global norm is the group's. A sharding degree above 1 (the
optimizer's state sharded over its group) is ROADMAP item 7(b) and
raises.
"""
from __future__ import annotations

from ....nn.clip import ClipGradByGlobalNorm

__all__ = ["HybridParallelOptimizer", "HybridParallelClipGrad"]


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    def __init__(self, clip, hcg):
        super().__init__(clip.clip_norm if isinstance(
            clip, ClipGradByGlobalNorm) else float(clip))
        self._hcg = hcg


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy=None):
        if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
            raise NotImplementedError(
                "a sharding degree above 1 shards the optimizer's state over "
                "its group: ROADMAP item 7(b)")
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        if isinstance(optimizer._grad_clip, ClipGradByGlobalNorm):
            optimizer._grad_clip = HybridParallelClipGrad(
                optimizer._grad_clip, hcg)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        self._inner_opt.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self._inner_opt.minimize(loss, startup_program, parameters,
                                        no_grad_set)

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, state):
        return self._inner_opt.set_state_dict(state)
