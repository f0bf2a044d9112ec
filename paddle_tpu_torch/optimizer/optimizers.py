"""Adam and AdamW in Paddle's formula.

Counterpart of `paddle_tpu/optimizer/optimizers.py` (`Adam`, `AdamW`). The
rule differs from `torch.optim.AdamW`'s: epsilon is added to sqrt(m2)
before bias correction, which goes into the step size instead,

    lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)
    p   -= lr_t * m1 / (sqrt(m2) + epsilon)

and AdamW's decoupled decay scales the fp32 base first,
``base * (1 - lr * coeff)``. All of it is fp32, with lr and the step t as
fp32 scalars, as the reference's jitted update computes it
(`kernels.adam_update.adam_rule`, the per-tensor rule `_single_update`
applies). Moments are fp32 whatever the parameter's dtype; with
``multi_precision=True`` every non-fp32 parameter also keeps an fp32 master
copy, updated in fp32 and written back cast to the parameter's dtype.

An update over a list (`_update`) groups the pairs by device and parameter
dtype and makes one `kernels.adam_update.adam_update` call per group: one
kernel launch on the card (per 512 tensors), the rule tensor by tensor on
the CPU.
"""
from __future__ import annotations

import torch

from ..kernels.adam_update import adam_rule, adam_update
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

    # AdamW's decoupled decay (0: none)
    _coeff = 0.0

    def _create_accumulators(self, params):
        for p in params:
            if p in self._accumulators["moment1"]:
                continue
            self._accumulators["moment1"][p] = torch.zeros_like(
                p, dtype=torch.float32, memory_format=torch.contiguous_format)
            self._accumulators["moment2"][p] = torch.zeros_like(
                p, dtype=torch.float32, memory_format=torch.contiguous_format)
            if self._multi_precision and p.dtype != torch.float32:
                self._accumulators["master_weight"][p] = \
                    p.detach().to(torch.float32).contiguous()

    def _decays(self, p):
        """Whether AdamW's decay applies to parameter `p`."""
        return False

    def _single_update(self, p, g, accs, lr, step):
        new_p, m1, m2, new_master = adam_rule(
            p, g, accs["moment1"], accs["moment2"],
            accs.get("master_weight"), lr, step, self._beta1, self._beta2,
            self._epsilon, self._coeff, self._decays(p))
        out = {"moment1": m1, "moment2": m2}
        if new_master is not None:
            out["master_weight"] = new_master
        return new_p, out

    def _update(self, params_grads):
        accs = self._accumulators
        groups = {}
        for p, g in params_grads:
            groups.setdefault((p.device, p.dtype), []).append((p, g))
        for (device, _), pairs in groups.items():
            lr, t = self._device_scalars(device)
            adam_update(
                [p.detach() for p, _ in pairs],
                [g.to(p.dtype).contiguous() for p, g in pairs],
                [accs["moment1"][p] for p, _ in pairs],
                [accs["moment2"][p] for p, _ in pairs],
                [accs["master_weight"].get(p) for p, _ in pairs],
                [self._decays(p) for p, _ in pairs], lr, t, self._beta1,
                self._beta2, self._epsilon, self._coeff)


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

    def _decays(self, p):
        return bool(self._coeff) and p not in self._decay_skip
