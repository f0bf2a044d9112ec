"""Adam and AdamW in Paddle's formula.

Counterpart of `paddle_tpu/optimizer/optimizers.py` (`Adam`, `AdamW`). The
rule differs from `torch.optim.AdamW`'s: epsilon is added to sqrt(m2)
before bias correction, which goes into the step size instead,

    lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)
    p   -= lr_t * m1 / (sqrt(m2) + epsilon)

and AdamW's decoupled decay scales the fp32 base first,
``base * (1 - lr * coeff)``. Moments are fp32 whatever the parameter's
dtype; with ``multi_precision=True`` every non-fp32 parameter also keeps an
fp32 master copy, updated in fp32 and written back cast to the parameter's
dtype.
"""
from __future__ import annotations

import math

import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._multi_precision = multi_precision

    def _create_accumulators(self, params):
        for p in params:
            if p in self._accumulators["moment1"]:
                continue
            self._accumulators["moment1"][p] = torch.zeros_like(
                p, dtype=torch.float32)
            self._accumulators["moment2"][p] = torch.zeros_like(
                p, dtype=torch.float32)
            if self._multi_precision and p.dtype != torch.float32:
                self._accumulators["master_weight"][p] = \
                    p.detach().to(torch.float32)

    def _adam_core(self, p, g, m1, m2, lr, step, master=None):
        gf = g.to(torch.float32)
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m1n = b1 * m1 + (1 - b1) * gf
        m2n = b2 * m2 + (1 - b2) * gf * gf
        lr_t = lr * math.sqrt(1 - b2 ** step) / (1 - b1 ** step)
        base = master if master is not None else p.to(torch.float32)
        new_master = base - lr_t * m1n / (torch.sqrt(m2n) + eps)
        return new_master.to(p.dtype), m1n, m2n, new_master

    def _single_update(self, p, g, accs, lr, step):
        master = accs.get("master_weight")
        new_p, m1, m2, new_master = self._adam_core(
            p, g, accs["moment1"], accs["moment2"], lr, step, master)
        out = {"moment1": m1, "moment2": m2}
        if master is not None:
            out["master_weight"] = new_master
        return new_p, out


class AdamW(Adam):
    """Adam with decoupled weight decay. `apply_decay_param_fun` gets each
    parameter's name from ``model.named_parameters()`` (so pass that as
    `parameters`) and returns whether it decays."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision)
        self._coeff = weight_decay
        self._decay_skip = set()
        if apply_decay_param_fun is not None:
            if len(self._names) != len(self._parameter_list):
                raise ValueError("apply_decay_param_fun needs parameter "
                                 "names: pass model.named_parameters()")
            self._decay_skip = {p for p in self._parameter_list
                                if not apply_decay_param_fun(self._names[p])}

    def _update_args(self, p):
        return {"decay": p not in self._decay_skip}

    def _single_update(self, p, g, accs, lr, step, decay=True):
        master = accs.get("master_weight")
        base = master if master is not None else p.to(torch.float32)
        decayed = base * (1.0 - lr * self._coeff) if decay and self._coeff \
            else base
        if master is not None:
            new_p, m1, m2, new_master = self._adam_core(
                p, g, accs["moment1"], accs["moment2"], lr, step, decayed)
        else:
            new_p, m1, m2, new_master = self._adam_core(
                decayed.to(p.dtype), g, accs["moment1"], accs["moment2"], lr,
                step)
        out = {"moment1": m1, "moment2": m2}
        if master is not None:
            out["master_weight"] = new_master
        return new_p, out
