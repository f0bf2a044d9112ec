"""Optimizer base.

Counterpart of `paddle_tpu/optimizer/optimizer.py` (`Optimizer`): the
parameter list, the learning rate (a float, or an `lr.LRScheduler` read at
every update), fp32 accumulators per parameter, gradient clipping before
the update, and `_single_update`, the per-parameter update rule a subclass
writes as a function of tensors.

Like the reference's jitted batch update, one update covers every
``(param, grad)`` pair at once (`_update`; Adam and AdamW: one kernel
launch per parameter dtype on the card). Accumulators are made once and
updated in place, so a CUDA graph that captured the update and an eager
`step` after it work on the same tensors. The host keeps the step count;
the update reads lr and the step from two fp32 device scalars
(`_device_scalars`), which `_begin_step` fills by value before each launch
or graph replay.

Not ported yet (each raises NotImplementedError naming ROADMAP.md Queue 1
item 9(b)): regularizers (``weight_decay=`` on a non-AdamW optimizer,
L2Decay).
"""
from __future__ import annotations

import numbers
from collections import defaultdict

import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]

_LATER = "not ported yet (ROADMAP.md Queue 1 item 9(b), training remainder)"


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


def _check_lr(learning_rate):
    if not isinstance(learning_rate, (numbers.Real, LRScheduler)):
        raise TypeError(f"learning_rate must be a float or an LRScheduler, "
                        f"got {type(learning_rate).__name__}")
    return learning_rate if isinstance(learning_rate, LRScheduler) \
        else float(learning_rate)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if parameters is None:
            raise ValueError("parameters is required (pass model.parameters() "
                             "or model.named_parameters())")
        if weight_decay:
            raise NotImplementedError(
                f"regularizers (weight_decay={weight_decay!r}, L2Decay) are "
                f"{_LATER}; AdamW's decoupled decay is ported")
        self._parameter_list, self._names = _split_named(parameters)
        self._learning_rate = _check_lr(learning_rate)
        self._grad_clip = grad_clip
        # accumulator name -> {parameter: tensor}, each made once
        self._accumulators = defaultdict(dict)
        self._step_count = 0
        # device -> (lr, t): the fp32 scalars the update reads
        self._scalars = {}

    # -- learning rate ------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the lr is an LRScheduler; call "
                "scheduler.step() instead")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        if not isinstance(scheduler, LRScheduler):
            raise TypeError(f"set_lr_scheduler takes an LRScheduler, got "
                            f"{type(scheduler).__name__}")
        self._learning_rate = scheduler

    # -- device scalars -----------------------------------------------------
    def _device_scalars(self, device):
        """``(lr, t)``, the fp32 scalars on `device` that the update reads
        (made once per device; a CUDA graph keeps reading these)."""
        device = torch.device(device)
        if device not in self._scalars:
            self._scalars[device] = tuple(
                torch.zeros((), dtype=torch.float32, device=device)
                for _ in range(2))
        return self._scalars[device]

    def _begin_step(self, devices):
        """Count one step and fill lr and t on each of `devices` by value,
        as the reference's step does before its update."""
        self._step_count += 1
        lr = self.get_lr()
        for device in devices:
            lr_dev, t_dev = self._device_scalars(device)
            lr_dev.fill_(lr)
            t_dev.fill_(self._step_count)

    # -- subclass interface -------------------------------------------------
    def _create_accumulators(self, params):
        pass

    def _single_update(self, p, g, accs, lr, step):
        """``(param, grad, {accumulators}, lr, step) -> (new param,
        {new accumulators})``, without side effects."""
        raise NotImplementedError

    def _update(self, params_grads):
        """Update every ``(param, grad)`` pair in place, from the device
        scalars of `_begin_step`; the optimizer's accumulators exist."""
        raise NotImplementedError

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
        self._begin_step({p.device for p, _ in params_grads})
        self._update(params_grads)

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None
