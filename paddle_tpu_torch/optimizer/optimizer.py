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

The numeric guard (``FLAGS_check_numerics``, `ops.guardian`): with
`guardian.skip_step_enabled()`, `_update(..., guard="check")` zeroes an
int32 device flag per device (`_guard_flag`, made once like the scalars),
computes the new state of every group without writing it, ORs into the
flag whether any gradient (after the regularizer and the clip) or new
parameter, master or accumulator is not finite, across all the step's
dtype groups (the guard takes parameters on one device, as `TrainStep`'s
graph does), and only then writes every group where the flag is clear:
a bad step changes no bit of the state, and the step count still
advances. Adam and AdamW probe and apply with their kernel's two
forms; the others compute their new state out of place
(`_update_group` on copies), check it with
`kernels.finite_check.multi_tensor_finite` and copy it in with
`multi_tensor_copy_if`. ``guard="strict"`` (`jit.TrainStep` under
``FLAGS_check_nan_inf``) writes where a flag its caller set is clear. The
guard's names are `guardian.mode`'s.
`step` queues the outcome (`guardian.note_step`) and ends at the
boundary `guardian.maybe_flush()`; nothing syncs. With the guard off the
update is the unguarded one, launch for launch.

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
from ..kernels.finite_check import multi_tensor_copy_if, multi_tensor_finite
from ..ops import guardian, numerics
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
        # device -> the guard's int32 flag (nonzero: skip the step)
        self._flags = {}

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

    def _guard_flag(self, device):
        """The guard's int32 flag on `device` (made once per device; a
        CUDA graph keeps reading it): nonzero where the step must not
        write."""
        device = torch.device(device)
        if device not in self._flags:
            self._flags[device] = torch.zeros((), dtype=torch.int32,
                                              device=device)
        return self._flags[device]

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

    def _update_group(self, device, keys, ps, gs, accs):
        """The multi-tensor update of one (device, dtype) group: write the
        new values into `ps` and ``accs[name]`` (lists in the order of
        `keys`, the group's parameters, which name each tensor's own
        settings) from `gs`, in place."""
        raise NotImplementedError

    def _group_accs(self, ps):
        """``{accumulator name: [tensor of each of ps]}``."""
        return {name: [slot[p] for p in ps]
                for name, slot in self._accumulators.items()
                if ps and all(p in slot for p in ps)}

    def _update(self, params_grads, guard=None):
        """Update every ``(param, grad)`` pair in place, from the device
        scalars of `_begin_step`; the optimizer's accumulators exist.
        `guard`: None, "check" or "strict" (`guardian.mode`; module
        docstring)."""
        groups = self._groups(params_grads)
        if guard is None:
            for device, _, ps, gs in groups:
                self._update_group(device, ps, ps, gs, self._group_accs(ps))
            return
        staged = []
        for device, _, ps, gs in groups:
            accs = self._group_accs(ps)
            olds = list(ps) + [t for ts in accs.values() for t in ts]
            news = [torch.empty_like(t) for t in olds]
            torch._foreach_copy_(news, olds)
            new_accs, at = {}, len(ps)
            for name, ts in accs.items():
                new_accs[name] = news[at:at + len(ts)]
                at += len(ts)
            self._update_group(device, ps, news[:len(ps)], gs, new_accs)
            staged.append((device, olds, news, gs))
        if guard == "check":
            for d in {d for d, _, _, _ in staged}:
                self._guard_flag(d).zero_()
            for d, _, news, gs in staged:
                multi_tensor_finite(list(gs) + news, self._guard_flag(d))
        for d, olds, news, _ in staged:
            multi_tensor_copy_if(olds, news, self._guard_flag(d))

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
        is set) and update every parameter that has one (under the guard,
        only where the step is finite), then resolve the guard's checks
        that are ready. An `amp.auto_cast` around the call does not reach
        the update, nor do the per-op checks (`ops.numerics`)."""
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.grad is not None]
        if params_grads:
            with amp.suspended(), numerics.suspended():
                self._apply_optimize(self._prepare(params_grads))
        guardian.maybe_flush()

    @torch.no_grad()
    def _apply_optimize(self, params_grads):
        """One update of each ``(param, grad)`` pair, as they are given;
        under the guard, the checked update and its outcome queued."""
        self._create_accumulators([p for p, _ in params_grads])
        devices = {p.device for p, _ in params_grads}
        guarded = guardian.skip_step_enabled()
        if guarded and len(devices) > 1:
            raise NotImplementedError("the numeric guard takes parameters "
                                      "on one device")
        self._begin_step(devices)
        if not guarded:
            self._update(params_grads)
            return
        self._update(params_grads, guard="check")
        guardian.note_step("eager_step",
                           self._guard_flag(next(iter(devices))).eq(0),
                           step_index=self._step_count)

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
