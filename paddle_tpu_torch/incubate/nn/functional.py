"""Fused functionals of the incubate namespace.

Counterpart of `paddle_tpu/incubate/nn/functional.py`; so far only
`fused_softmax_cross_entropy` (the fused bias-residual LayerNorm and its
kernel are still to port, see ROADMAP.md).
"""
from __future__ import annotations

import torch

from ...kernels import cross_entropy as _fused_ce
from ...nn.functional.loss import cross_entropy

__all__ = ["fused_softmax_cross_entropy"]


def fused_softmax_cross_entropy(logits, label, ignore_index=-100,
                                reduction="mean"):
    """Cross-entropy through the fused kernels whatever
    ``FLAGS_use_fused_cross_entropy`` and the vocabulary size say (the
    explicit entry point); only logits that are not 2-D with 1-D labels take
    `nn.functional.cross_entropy` instead, as in the reference."""
    if _fused_ce.is_eligible(logits, label, force=True):
        lab_idx = torch.clamp(label, 0, logits.shape[1] - 1).long()
        nll = _fused_ce.fused_softmax_cross_entropy(logits, lab_idx)
        return _fused_ce.masked_reduce(nll, label, ignore_index, reduction)
    return cross_entropy(logits, label, ignore_index=ignore_index,
                         reduction=reduction)
