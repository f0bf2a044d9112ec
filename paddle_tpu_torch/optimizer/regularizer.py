"""Weight-decay regularizers, added to the gradient before the update.

Counterpart of `paddle_tpu/optimizer/regularizer.py` (`L1Decay`,
`L2Decay`). The decay term is computed in the gradient's dtype and added
to the gradient:

    L2Decay: g + coeff * p
    L1Decay: g + coeff * sign(p)

each product rounded to the gradient's dtype before the sum, as the
reference's ``grad + coeff * param.astype(grad.dtype)`` is. A parameter's
own ``regularizer`` attribute (an `L1Decay` or `L2Decay` set on the
`nn.Parameter`) overrides the optimizer's, as the reference's
``ParamAttr.regularizer`` does.

`Optimizer.step` and `jit.TrainStep` apply the regularizer before the
gradient clip; `apply_all` takes a whole list of ``(param, grad)`` pairs
with two multi-tensor ops per (regularizer, dtype) group, which is what
both of them call.
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay", "apply_all"]


class _Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def _terms(self, params, dtype):
        """``coeff * f(p)`` in `dtype` for each of `params`."""
        raise NotImplementedError

    def apply(self, param, grad):
        """`grad` with the decay of the regularizer that governs `param`
        (its own, else this one) added; None stays None."""
        if grad is None:
            return grad
        reg = getattr(param, "regularizer", None)
        if reg is not None and reg is not self:
            return reg.apply_own(param, grad)
        return self.apply_own(param, grad)

    def apply_own(self, param, grad):
        """`grad` plus this regularizer's decay of `param`."""
        return grad + self._terms([param.detach()], grad.dtype)[0]


class L2Decay(_Decay):
    def _terms(self, params, dtype):
        return torch._foreach_mul(_cast(params, dtype), self.coeff)


class L1Decay(_Decay):
    def _terms(self, params, dtype):
        return torch._foreach_mul(torch._foreach_sign(_cast(params, dtype)),
                                  self.coeff)


def _cast(tensors, dtype):
    if all(t.dtype == dtype for t in tensors):
        return list(tensors)
    return [t.to(dtype) for t in tensors]


def apply_all(regularizer, params_grads):
    """`params_grads` with each gradient regularized as
    ``regularizer.apply`` would (a parameter's own ``regularizer``
    first; with neither, the pair passes unchanged): the decay terms of
    each (regularizer, gradient dtype) group in one multi-tensor op and
    their sums in another."""
    groups = {}
    for i, (p, g) in enumerate(params_grads):
        reg = getattr(p, "regularizer", None) or regularizer
        if g is None or reg is None:
            continue
        groups.setdefault((id(reg), g.dtype), (reg, []))[1].append(i)
    out = list(params_grads)
    for (_, dtype), (reg, idx) in groups.items():
        grads = [params_grads[i][1] for i in idx]
        terms = reg._terms([params_grads[i][0].detach() for i in idx], dtype)
        for i, new in zip(idx, torch._foreach_add(grads, terms)):
            out[i] = (params_grads[i][0], new)
    return out
