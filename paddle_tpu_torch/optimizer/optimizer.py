"""Optimizer base.

Counterpart of `paddle_tpu/optimizer/optimizer.py` (`Optimizer`): the
parameter list, fp32 accumulators per parameter, gradient clipping before
the update, and `_single_update`, the per-parameter update rule a subclass
writes as a function of tensors (the same rule `jit.TrainStep` applies).
The update runs eagerly, one parameter at a time, and writes each new value
into its parameter in place.

Not ported yet (each raises NotImplementedError naming ROADMAP.md Queue 1
item 9): learning-rate schedulers and regularizers (``weight_decay=`` on a
non-AdamW optimizer, L2Decay).
"""
from __future__ import annotations

import numbers
from collections import defaultdict

import torch

__all__ = ["Optimizer"]

_LATER = "not ported yet (ROADMAP.md Queue 1 item 9, training remainder)"


def _split_named(parameters):
    """``(params, {param: name})`` from parameters or (name, param) pairs
    such as ``model.named_parameters()``; names are empty for bare
    parameters."""
    params, names = [], {}
    for item in parameters:
        if isinstance(item, tuple):
            name, item = item
            names[item] = name
        params.append(item)
    return params, names


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if parameters is None:
            raise ValueError("parameters is required (pass model.parameters() "
                             "or model.named_parameters())")
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError(
                f"learning-rate schedulers are {_LATER}; pass a float")
        if weight_decay:
            raise NotImplementedError(
                f"regularizers (weight_decay={weight_decay!r}, L2Decay) are "
                f"{_LATER}; AdamW's decoupled decay is ported")
        self._parameter_list, self._names = _split_named(parameters)
        self._learning_rate = float(learning_rate)
        self._grad_clip = grad_clip
        # accumulator name -> {parameter: tensor}
        self._accumulators = defaultdict(dict)
        self._step_count = 0

    # -- learning rate ------------------------------------------------------
    def get_lr(self):
        return self._learning_rate

    # -- subclass interface -------------------------------------------------
    def _create_accumulators(self, params):
        pass

    def _single_update(self, p, g, accs, lr, step):
        """``(param, grad, {accumulators}, lr, step) -> (new param,
        {new accumulators})``, without side effects."""
        raise NotImplementedError

    def _update_args(self, p):
        """Extra keyword arguments of `_single_update` for parameter `p`."""
        return {}

    # -- main entry points --------------------------------------------------
    @torch.no_grad()
    def step(self):
        """Clip the gradients (if a clip is set) and update every parameter
        that has one."""
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.grad is not None]
        if not params_grads:
            return
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._apply_optimize(params_grads)

    @torch.no_grad()
    def _apply_optimize(self, params_grads):
        """One update of each ``(param, grad)`` pair, as they are given."""
        self._create_accumulators([p for p, _ in params_grads])
        self._step_count += 1
        lr = self.get_lr()
        for p, g in params_grads:
            accs = {name: slot[p] for name, slot in self._accumulators.items()
                    if p in slot}
            new_p, new_accs = self._single_update(
                p.detach(), g, accs, lr, self._step_count,
                **self._update_args(p))
            p.copy_(new_p)
            for name, value in new_accs.items():
                self._accumulators[name][p] = value

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None
