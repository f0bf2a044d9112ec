"""Optimizer base.

Counterpart of `paddle_tpu/optimizer/optimizer.py` (`Optimizer`): the
parameter list, the learning rate (a float, or an `lr.LRScheduler` read at
every update), accumulators per parameter, the regularizer and the
gradient clip before the update (in that order, as the reference's
`step`), `state_dict` / `set_state_dict`, and `_single_update`, the
per-parameter update rule a subclass writes as a function of tensors.

Like the reference's jitted batch update, one update covers every
``(param, grad)`` pair at once (`_update`: multi-tensor ops per (device,
dtype) group; Adam and AdamW: one kernel launch per parameter dtype on the
card). Accumulators are made once and updated in place, so a CUDA graph
that captured the update, an eager `step` after it and a `set_state_dict`
(which copies into them) all work on the same tensors. The host keeps the
step count; the update reads lr and the step from two fp32 device scalars
(`_device_scalars`), which `_begin_step` fills by value before each launch
or graph replay.

``weight_decay=<float>`` means `L2Decay(weight_decay)`; a regularizer
object is taken as it is. State-dict keys are ``<param name>_<accumulator
name>``, ``LR_Scheduler`` and ``_step_count``, the reference's; a
parameter's name is its ``named_parameters()`` name where the optimizer
was given those, else ``param_<i>`` by position.
"""
from __future__ import annotations

import numbers
from collections import defaultdict

import torch

from .. import amp
from .lr import LRScheduler
from .regularizer import L2Decay, apply_all

__all__ = ["Optimizer"]


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
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters is required (pass model.parameters() "
                             "or model.named_parameters())")
        self._parameter_list, self._names = _split_named(parameters)
        self._learning_rate = _check_lr(learning_rate)
        self._grad_clip = grad_clip
        self._name = name
        if isinstance(weight_decay, numbers.Real):
            self.regularization = L2Decay(weight_decay) if weight_decay \
                else None
        else:
            self.regularization = weight_decay
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

    # -- accumulators -------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, dtype=None):
        """Make accumulator `name` of `param` once: `fill_value` in `dtype`
        (the parameter's when None), contiguous, on its device."""
        slot = self._accumulators[name]
        if param not in slot:
            slot[param] = torch.full_like(
                param, fill_value, dtype=dtype or param.dtype,
                memory_format=torch.contiguous_format)
        return slot[param]

    def _param_name(self, i, p):
        return self._names.get(p) or f"param_{i}"

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

    def _groups(self, params_grads):
        """``(device, dtype, params, grads)`` for each (device, parameter
        dtype) group of `params_grads`, in first-seen order. `_update`
        runs under `torch.no_grad()` (its callers see to it), so it may
        write the parameters in place."""
        groups = {}
        for p, g in params_grads:
            ps, gs = groups.setdefault((p.device, p.dtype), ([], []))
            ps.append(p)
            gs.append(g)
        return [(d, t, ps, gs) for (d, t), (ps, gs) in groups.items()]

    # -- main entry points --------------------------------------------------
    def _prepare(self, params_grads):
        """The regularizer, then the gradient clip, over `params_grads`, as
        the reference's `step` applies them before its update."""
        if self.regularization is not None or any(
                getattr(p, "regularizer", None) is not None
                for p, _ in params_grads):
            params_grads = apply_all(self.regularization, params_grads)
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        return params_grads

    @torch.no_grad()
    def step(self):
        """Regularize and clip the gradients (where a regularizer or a clip
        is set) and update every parameter that has one. An `amp.auto_cast`
        around the call does not reach the update."""
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.grad is not None]
        if not params_grads:
            return
        with amp.suspended():
            self._apply_optimize(self._prepare(params_grads))

    @torch.no_grad()
    def _apply_optimize(self, params_grads):
        """One update of each ``(param, grad)`` pair, as they are given."""
        self._create_accumulators([p for p, _ in params_grads])
        self._begin_step({p.device for p, _ in params_grads})
        self._update(params_grads)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then `step`; returns ``(None, None)`` as the
        reference's dygraph `minimize` does."""
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    # -- state dict ---------------------------------------------------------
    def state_dict(self):
        """``{"<param name>_<accumulator>": tensor}`` (copies, on the
        accumulators' devices), ``"LR_Scheduler"`` (the schedule's state)
        where the lr is an `LRScheduler`, and ``"_step_count"``."""
        names = {p: self._param_name(i, p)
                 for i, p in enumerate(self._parameter_list)}
        state = {}
        for acc, per_param in self._accumulators.items():
            for p, value in per_param.items():
                if p in names:
                    state[f"{names[p]}_{acc}"] = value.detach().clone()
        if isinstance(self._learning_rate, LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
        state["_step_count"] = self._step_count
        return state

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Load `state_dict` (`state_dict`'s form; tensors or arrays on any
        device): the schedule's state, the step count, and each
        accumulator the optimizer has, copied into the tensor it already
        holds (a CUDA graph that captured the update reads those), cast to
        its dtype. Keys of accumulators it does not have are ignored, as
        the reference ignores them."""
        if "LR_Scheduler" in state_dict and \
                isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(
                dict(state_dict["LR_Scheduler"]))
        self._step_count = int(state_dict.get("_step_count", 0))
        self._create_accumulators(self._parameter_list)
        for i, p in enumerate(self._parameter_list):
            name = self._param_name(i, p)
            for acc, per_param in self._accumulators.items():
                key = f"{name}_{acc}"
                if p in per_param and key in state_dict:
                    per_param[p].copy_(torch.as_tensor(state_dict[key]))

    load_state_dict = set_state_dict
