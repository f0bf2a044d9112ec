"""Gradient clipping, applied by `Optimizer.step` before the update.

Counterpart of `paddle_tpu/nn/clip.py` (`ClipGradByValue`, `ClipGradByNorm`,
`ClipGradByGlobalNorm`). Each takes and returns a list of
``(parameter, gradient)`` pairs; a pair whose gradient is None or whose
parameter has ``need_clip = False`` passes through unchanged. Norms are
taken in fp32 and each gradient keeps its dtype.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


def _clippable(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every element to ``[min, max]`` (``min`` defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max)) if _clippable(p, g)
                else (p, g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient on its own so its L2 norm is at most
    `clip_norm`."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _clippable(p, g):
                out.append((p, g))
                continue
            g32 = g.float()
            norm = torch.sqrt((g32 * g32).sum())
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, (g32 * scale).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale all clippable gradients by one factor so their joint L2 norm
    is at most `clip_norm`. The norm stays on the device (no host sync, so
    a CUDA graph captures the clip); `global_norm` holds the last call's,
    a 0-d fp32 tensor (inside a graph, the one each replay rewrites)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)
        self.global_norm = None

    def __call__(self, params_grads):
        # each gradient cast to fp32 once (a no-op for fp32 ones)
        f32 = {i: g.float() for i, (p, g) in enumerate(params_grads)
               if _clippable(p, g)}
        if not f32:
            return params_grads
        total = sum((g * g).sum() for g in f32.values())
        self.global_norm = torch.sqrt(total)
        scale = self.clip_norm / torch.clamp(self.global_norm,
                                             min=self.clip_norm)
        return [(p, (f32[i] * scale).to(g.dtype)) if i in f32 else (p, g)
                for i, (p, g) in enumerate(params_grads)]
