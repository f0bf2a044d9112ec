"""Cross-entropy loss.

Counterpart of `paddle_tpu/nn/functional/loss.py::cross_entropy`, with the
reference's semantics: hard labels are clipped to ``[0, C-1]`` and rows
whose raw label equals `ignore_index` are then masked out; "mean" divides by
the number of valid rows (at least 1), or by the valid rows' class weights
when `weight` is given; `soft_label`, `label_smoothing`, `weight` and
``use_softmax=False`` take the plain path. 2-D logits with 1-D labels that
pass `kernels.cross_entropy.is_eligible` (``FLAGS_use_fused_cross_entropy``
and a vocabulary of at least 8192) go through the fused kernels, on both
devices alike.
"""
from __future__ import annotations

import torch

from ... import amp
from ...kernels.cross_entropy import (fused_softmax_cross_entropy,
                                      is_eligible, masked_reduce)

__all__ = ["cross_entropy"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _log_probs(logits, axis, use_softmax):
    if use_softmax:
        return torch.log_softmax(logits, dim=axis)
    return torch.log(torch.clamp(logits, min=1e-30))


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross-entropy of `input` (logits over `axis`) against `label`
    (class ids, or a distribution with ``soft_label=True``). Under
    `amp.auto_cast` the call is one op, the reference's ``cross_entropy``
    (black-listed: float inputs go to fp32), its body uncast."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    inputs = [input, label] + ([weight] if weight is not None else [])
    input, label, *weight = amp.amp_cast_inputs("cross_entropy", inputs)
    with amp.suspended():
        return _cross_entropy(input, label, weight[0] if weight else None,
                              ignore_index, reduction, soft_label, axis,
                              use_softmax, label_smoothing)


def _cross_entropy(input, label, weight, ignore_index, reduction, soft_label,
                   axis, use_softmax, label_smoothing):
    n_classes = input.shape[axis]
    if soft_label:
        loss = -(label * _log_probs(input, axis, use_softmax)).sum(dim=axis)
        if weight is not None:
            loss = loss * (label * weight).sum(dim=axis)
        return _reduce(loss, reduction)

    if label.ndim == input.ndim and label.shape[axis] == 1:
        label = label.squeeze(axis)
    lab_idx = torch.clamp(label, 0, n_classes - 1).long()
    if (weight is None and label_smoothing == 0.0 and use_softmax
            and input.ndim == 2 and axis in (-1, 1) and lab_idx.ndim == 1
            and is_eligible(input, lab_idx)):
        nll = fused_softmax_cross_entropy(input, lab_idx)
        return masked_reduce(nll, label, ignore_index, reduction)

    logp = _log_probs(input, axis, use_softmax)
    picked = logp.gather(axis, lab_idx.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0.0:
        smooth = logp.mean(dim=axis)
        nll = -(1.0 - label_smoothing) * picked - label_smoothing * smooth
    else:
        nll = -picked
    valid = label != ignore_index
    zero = torch.zeros((), dtype=nll.dtype, device=nll.device)
    nll = torch.where(valid, nll, zero)
    if weight is not None:
        cw = weight[lab_idx]
        nll = nll * cw
        if reduction == "mean":
            denom = torch.where(valid, cw, torch.zeros_like(cw)).sum()
            return nll.sum() / torch.clamp(denom, min=1e-12)
    if reduction == "mean":
        return nll.sum() / torch.clamp(valid.to(input.dtype).sum(), min=1.0)
    if reduction == "sum":
        return nll.sum()
    return nll
