"""The optimizers, in Paddle's formulas.

Counterpart of `paddle_tpu/optimizer/optimizers.py`: `SGD`, `Momentum`,
`Adam`, `AdamW`, `Lamb`, `RMSProp`, `Adagrad`, `Adadelta`, `Adamax` and
`Lars`, each rule as the reference writes it, in the reference's dtypes:
`SGD` and `Momentum` compute in the parameter's dtype (Momentum's velocity
has that dtype too), the others in fp32 with fp32 accumulators, writing
the parameter back cast to its dtype. lr and the step t are fp32 scalars.

Each optimizer has two code paths:

- `_single_update(p, g, accs, lr, step)`, the rule on one tensor with
  plain torch ops and no side effects: the plain version;
- `_update_group(device, keys, ps, gs, accs)`, the same operations in
  the same order over one (device, parameter dtype) group at once as
  multi-tensor ops (``torch._foreach_*``, `torch._foreach_norm` for
  Lamb's and Lars' per-tensor norms), written into `ps` and `accs` in
  place: the parameters and accumulators themselves, or under the
  numeric guard copies of them (`Optimizer._update`). This is what
  `step` and `jit.TrainStep` run.

On the CPU the two are equal bit for bit (the multi-tensor ops run the
same kernels tensor by tensor there); the tests hold them so. The
reference computes these rules with XLA ops, not in a Pallas kernel, so
none has a hand-written kernel of its own (the guard's check and copy are
`kernels.finite_check`); `Adam` and `AdamW` have theirs.

Adam and AdamW. The rule differs from `torch.optim.AdamW`'s: epsilon is
added to sqrt(m2) before bias correction, which goes into the step size
instead,

    lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)
    p   -= lr_t * m1 / (sqrt(m2) + epsilon)

and AdamW's decoupled decay scales the fp32 base first,
``base * (1 - lr * coeff)``. All of it is fp32
(`kernels.adam_update.adam_rule`, the per-tensor rule `_single_update`
applies). Moments are fp32 whatever the parameter's dtype; with
``multi_precision=True`` every non-fp32 parameter also keeps an fp32 master
copy, updated in fp32 and written back cast to the parameter's dtype. An
update over a list makes one `kernels.adam_update.adam_update` call per
group: one kernel launch on the card (per 512 tensors), the rule tensor by
tensor on the CPU; under the guard, every group's probe, then every
group's gated apply. ``lazy_mode`` changes nothing for dense gradients, and
AdamW stores ``lr_ratio`` without applying it, as the reference does
(ROADMAP.md Queue 3).
"""
from __future__ import annotations

import torch

from ..kernels.adam_update import _f32, adam_rule, adam_update
from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Lamb", "Lars", "RMSProp",
           "Adagrad", "Adadelta", "Adamax"]

_F32 = torch.float32


def _scalars(p, lr, step):
    """lr and the step as fp32 scalars on `p`'s device (numbers or 0-d
    tensors in; `_single_update` takes either)."""
    return (torch.as_tensor(lr, dtype=_F32, device=p.device),
            torch.as_tensor(step, dtype=_F32, device=p.device))


def _as_dtype(tensors, dtype=_F32):
    """`tensors` in `dtype`: the same list when they are, else copies (one
    multi-tensor copy)."""
    if all(t.dtype == dtype for t in tensors):
        return list(tensors)
    out = [torch.empty_like(t, dtype=dtype) for t in tensors]
    torch._foreach_copy_(out, tensors)
    return out


def _subtract_into(ps, pfs, deltas):
    """``p = pf - delta`` for each parameter, cast to its dtype (in place
    when the parameters are fp32, so `pfs` are they)."""
    if pfs[0] is ps[0]:
        torch._foreach_sub_(ps, deltas)
    else:
        torch._foreach_copy_(ps, torch._foreach_sub(pfs, deltas))


def _ema_(accs, decay, xs):
    """``acc = decay * acc + (1 - decay) * x`` in place, with the
    reference's two products and one sum."""
    torch._foreach_mul_(accs, decay)
    torch._foreach_add_(accs, torch._foreach_mul(xs, _f32(1 - decay)))


def _ema_sq_(accs, decay, xs):
    """``acc = decay * acc + (1 - decay) * x * x`` in place."""
    sq = torch._foreach_mul(xs, _f32(1 - decay))
    torch._foreach_mul_(sq, xs)
    torch._foreach_mul_(accs, decay)
    torch._foreach_add_(accs, sq)


class SGD(Optimizer):
    """``p - lr * g``, in the parameter's dtype."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _single_update(self, p, g, accs, lr, step):
        lr, _ = _scalars(p, lr, step)
        return p - lr.to(p.dtype) * g.to(p.dtype), {}

    def _update_group(self, device, keys, ps, gs, accs):
        lr, _ = self._device_scalars(device)
        dtype = ps[0].dtype
        torch._foreach_sub_(ps, torch._foreach_mul(_as_dtype(gs, dtype),
                                                   lr.to(dtype)))


class Momentum(Optimizer):
    """``v = momentum * v + g``; ``p - lr * v`` (Nesterov: ``p - lr * (g +
    momentum * v)``), all in the parameter's dtype."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("velocity", p)

    def _single_update(self, p, g, accs, lr, step):
        lr, _ = _scalars(p, lr, step)
        v = accs["velocity"]
        g = g.to(v.dtype)
        v_new = self._momentum * v + g
        upd = g + self._momentum * v_new if self._use_nesterov else v_new
        return p - lr.to(p.dtype) * upd.to(p.dtype), {"velocity": v_new}

    def _update_group(self, device, keys, ps, gs, accs):
        lr, _ = self._device_scalars(device)
        dtype = ps[0].dtype
        vs = accs["velocity"]
        gs = _as_dtype(gs, dtype)
        # out of place: on the CPU the in-place multi-tensor product by a
        # number rounds the number to a bf16 velocity's dtype
        v_new = torch._foreach_mul(vs, self._momentum)
        torch._foreach_add_(v_new, gs)
        torch._foreach_copy_(vs, v_new)
        upd = vs
        if self._use_nesterov:
            upd = torch._foreach_mul(vs, self._momentum)
            torch._foreach_add_(upd, gs)
        torch._foreach_sub_(ps, torch._foreach_mul(upd, lr.to(dtype)))


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = lazy_mode
        self._multi_precision = multi_precision

    # AdamW's decoupled decay (0: none)
    _coeff = 0.0

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("moment1", p, dtype=_F32)
            self._add_accumulator("moment2", p, dtype=_F32)
            if self._multi_precision and p.dtype != _F32 \
                    and p not in self._accumulators["master_weight"]:
                self._accumulators["master_weight"][p] = \
                    p.detach().to(_F32).contiguous()

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

    def _update(self, params_grads, guard=None):
        accs = self._accumulators
        calls = []
        for device, dtype, ps, gs in self._groups(params_grads):
            lr, t = self._device_scalars(device)
            calls.append((device, (
                ps, [g.to(dtype).contiguous() for g in gs],
                [accs["moment1"][p] for p in ps],
                [accs["moment2"][p] for p in ps],
                [accs["master_weight"].get(p) for p in ps],
                [self._decays(p) for p in ps], lr, t, self._beta1,
                self._beta2, self._epsilon, self._coeff)))
        if guard is None:
            for _, args in calls:
                adam_update(*args)
            return
        if guard == "check":
            for device in {device for device, _ in calls}:
                self._guard_flag(device).zero_()
            for device, args in calls:
                adam_update(*args, guard="probe",
                            flag=self._guard_flag(device))
        for device, args in calls:
            adam_update(*args, guard="apply", flag=self._guard_flag(device))


class AdamW(Adam):
    """Adam with decoupled weight decay. `apply_decay_param_fun` gets each
    parameter's name from ``model.named_parameters()`` (so pass that as
    `parameters`) and returns whether it decays."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._coeff = weight_decay
        # stored and never applied, as the reference (ROADMAP.md Queue 3)
        self._lr_ratio = lr_ratio
        self._decay_skip = set()
        if apply_decay_param_fun is not None:
            if len(self._names) != len(self._parameter_list):
                raise ValueError("apply_decay_param_fun needs parameter "
                                 "names: pass model.named_parameters()")
            self._decay_skip = {p for p in self._parameter_list
                                if not apply_decay_param_fun(self._names[p])}

    def _decays(self, p):
        return bool(self._coeff) and p not in self._decay_skip


class Lamb(Optimizer):
    """Adam's moments with bias correction, ``r = m1_hat / (sqrt(m2_hat) +
    eps) + wd * p`` (``wd`` where the parameter decays), and the step
    ``lr * trust * r`` with ``trust = |p| / |r|`` (1 where either norm is
    0). `exclude_from_weight_decay_fn` takes the parameter (an
    `nn.Parameter`) and returns True where it must not decay."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._wd = lamb_weight_decay
        self._excluded = {
            p for p in self._parameter_list
            if exclude_from_weight_decay_fn is not None
            and exclude_from_weight_decay_fn(p)}

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("moment1", p, dtype=_F32)
            self._add_accumulator("moment2", p, dtype=_F32)

    def _decays(self, p):
        return bool(self._wd) and p not in self._excluded

    def _single_update(self, p, g, accs, lr, step):
        lr, t = _scalars(p, lr, step)
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        gf, pf = g.to(_F32), p.to(_F32)
        m1 = b1 * accs["moment1"] + _f32(1 - b1) * gf
        m2 = b2 * accs["moment2"] + _f32(1 - b2) * gf * gf
        m1_hat = m1 / (1 - torch.pow(b1, t))
        m2_hat = m2 / (1 - torch.pow(b2, t))
        r = m1_hat / (torch.sqrt(m2_hat) + eps)
        if self._decays(p):
            r = r + self._wd * pf
        w_norm = torch.linalg.vector_norm(pf)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        new_p = pf - lr * trust * r
        return new_p.to(p.dtype), {"moment1": m1, "moment2": m2}

    def _update_group(self, device, keys, ps, gs, accs):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        lr, t = self._device_scalars(device)
        m1s, m2s = accs["moment1"], accs["moment2"]
        gfs, pfs = _as_dtype(gs), _as_dtype(ps)
        _ema_(m1s, b1, gfs)
        _ema_sq_(m2s, b2, gfs)
        r = torch._foreach_div(m1s, 1 - torch.pow(b1, t))
        den = torch._foreach_sqrt(torch._foreach_div(
            m2s, 1 - torch.pow(b2, t)))
        torch._foreach_add_(den, eps)
        torch._foreach_div_(r, den)
        decay = [i for i, p in enumerate(keys) if self._decays(p)]
        if decay:
            torch._foreach_add_([r[i] for i in decay], torch._foreach_mul(
                [pfs[i] for i in decay], self._wd))
        w_norm = torch.stack(torch._foreach_norm(pfs))
        r_norm = torch.stack(torch._foreach_norm(r))
        trust = torch.where((w_norm > 0) & (r_norm > 0),
                            w_norm / r_norm, 1.0)
        torch._foreach_mul_(r, list((lr * trust).unbind()))
        _subtract_into(ps, pfs, r)


class RMSProp(Optimizer):
    """``ms = rho * ms + (1 - rho) * g * g``; centered: ``mg = rho * mg +
    (1 - rho) * g`` and ``denom = sqrt(ms - mg * mg + eps)``, else
    ``sqrt(ms + eps)``; ``mom = momentum * mom + lr * g / denom``; ``p -
    mom``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("mean_square", p, dtype=_F32)
            self._add_accumulator("momentum_acc", p, dtype=_F32)
            if self._centered:
                self._add_accumulator("mean_grad", p, dtype=_F32)

    def _single_update(self, p, g, accs, lr, step):
        lr, _ = _scalars(p, lr, step)
        rho = self._rho
        gf = g.to(_F32)
        ms = rho * accs["mean_square"] + _f32(1 - rho) * gf * gf
        out = {"mean_square": ms}
        if self._centered:
            mg = rho * accs["mean_grad"] + _f32(1 - rho) * gf
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
            out["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * accs["momentum_acc"] + lr * gf / denom
        out["momentum_acc"] = mom
        return (p.to(_F32) - mom).to(p.dtype), out

    def _update_group(self, device, keys, ps, gs, accs):
        lr, _ = self._device_scalars(device)
        gfs = _as_dtype(gs)
        ms = accs["mean_square"]
        _ema_sq_(ms, self._rho, gfs)
        if self._centered:
            mg = accs["mean_grad"]
            _ema_(mg, self._rho, gfs)
            denom = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
            torch._foreach_add_(denom, self._epsilon)
        else:
            denom = torch._foreach_add(ms, self._epsilon)
        torch._foreach_sqrt_(denom)
        step = torch._foreach_mul(gfs, lr)
        torch._foreach_div_(step, denom)
        mom = accs["momentum_acc"]
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_add_(mom, step)
        _subtract_into(ps, _as_dtype(ps), mom)


class Adagrad(Optimizer):
    """``m = m + g * g``; ``p - lr * g / (sqrt(m) + eps)``; m starts at
    `initial_accumulator_value`."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("moment", p, fill_value=self._init_acc,
                                  dtype=_F32)

    def _single_update(self, p, g, accs, lr, step):
        lr, _ = _scalars(p, lr, step)
        gf = g.to(_F32)
        m = accs["moment"] + gf * gf
        new_p = p.to(_F32) - lr * gf / (torch.sqrt(m) + self._epsilon)
        return new_p.to(p.dtype), {"moment": m}

    def _update_group(self, device, keys, ps, gs, accs):
        lr, _ = self._device_scalars(device)
        gfs = _as_dtype(gs)
        ms = accs["moment"]
        torch._foreach_add_(ms, torch._foreach_mul(gfs, gfs))
        den = torch._foreach_sqrt(ms)
        torch._foreach_add_(den, self._epsilon)
        step = torch._foreach_mul(gfs, lr)
        torch._foreach_div_(step, den)
        _subtract_into(ps, _as_dtype(ps), step)


class Adadelta(Optimizer):
    """``asg = rho * asg + (1 - rho) * g * g``; ``u = g * sqrt(asu + eps)
    / sqrt(asg + eps)``; ``asu = rho * asu + (1 - rho) * u * u``; ``p - lr
    * u``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("avg_squared_grad", p, dtype=_F32)
            self._add_accumulator("avg_squared_update", p, dtype=_F32)

    def _single_update(self, p, g, accs, lr, step):
        lr, _ = _scalars(p, lr, step)
        rho, eps = self._rho, self._epsilon
        gf = g.to(_F32)
        asg = rho * accs["avg_squared_grad"] + _f32(1 - rho) * gf * gf
        update = gf * torch.sqrt(accs["avg_squared_update"] + eps) / \
            torch.sqrt(asg + eps)
        asu = rho * accs["avg_squared_update"] + \
            _f32(1 - rho) * update * update
        new_p = p.to(_F32) - lr * update
        return new_p.to(p.dtype), {"avg_squared_grad": asg,
                                   "avg_squared_update": asu}

    def _update_group(self, device, keys, ps, gs, accs):
        eps = self._epsilon
        lr, _ = self._device_scalars(device)
        gfs = _as_dtype(gs)
        asg, asu = accs["avg_squared_grad"], accs["avg_squared_update"]
        _ema_sq_(asg, self._rho, gfs)
        update = torch._foreach_sqrt(torch._foreach_add(asu, eps))
        torch._foreach_mul_(update, gfs)
        torch._foreach_div_(update, torch._foreach_sqrt(
            torch._foreach_add(asg, eps)))
        _ema_sq_(asu, self._rho, update)
        _subtract_into(ps, _as_dtype(ps), torch._foreach_mul(update, lr))


class Adamax(Optimizer):
    """``m = b1 * m + (1 - b1) * g``; ``u = max(b2 * u, |g|)``; ``p - lr /
    (1 - b1^t) * m / (u + eps)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("moment", p, dtype=_F32)
            self._add_accumulator("inf_norm", p, dtype=_F32)

    def _single_update(self, p, g, accs, lr, step):
        lr, t = _scalars(p, lr, step)
        b1, b2 = self._beta1, self._beta2
        gf = g.to(_F32)
        m = b1 * accs["moment"] + _f32(1 - b1) * gf
        u = torch.maximum(b2 * accs["inf_norm"], torch.abs(gf))
        lr_t = lr / (1 - torch.pow(b1, t))
        new_p = p.to(_F32) - lr_t * m / (u + self._epsilon)
        return new_p.to(p.dtype), {"moment": m, "inf_norm": u}

    def _update_group(self, device, keys, ps, gs, accs):
        lr, t = self._device_scalars(device)
        gfs = _as_dtype(gs)
        ms, us = accs["moment"], accs["inf_norm"]
        _ema_(ms, self._beta1, gfs)
        torch._foreach_mul_(us, self._beta2)
        torch._foreach_maximum_(us, torch._foreach_abs(gfs))
        step = torch._foreach_mul(ms, lr / (1 - torch.pow(self._beta1, t)))
        torch._foreach_div_(step, torch._foreach_add(us, self._epsilon))
        _subtract_into(ps, _as_dtype(ps), step)


class Lars(Optimizer):
    """LARS momentum: ``local_lr = coeff * |p| / (|g| + wd * |p| + eps)``
    (1 where either norm is 0), ``v = momentum * v + lr * local_lr * (g +
    wd * p)``, ``p - v``; ``wd`` is 0 for an excluded parameter. The
    exclusion is the reference's: a parameter whose name contains one of
    `exclude_from_weight_decay`'s tokens, and, where ``"bias"`` is one of
    them, every 0-/1-D parameter."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None, epsilon=1e-9,
                 exclude_from_weight_decay=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._momentum = momentum
        self._coeff = lars_coeff
        self._wd = lars_weight_decay
        self._epsilon = epsilon
        tokens = tuple(exclude_from_weight_decay or ())
        self._excluded = set()
        for i, p in enumerate(self._parameter_list):
            name = self._param_name(i, p)
            if any(tok in name for tok in tokens) or (
                    "bias" in tokens and p.ndim <= 1):
                self._excluded.add(p)

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("velocity", p, dtype=_F32)

    def _decay(self, p):
        return 0.0 if p in self._excluded else self._wd

    def _single_update(self, p, g, accs, lr, step):
        lr, _ = _scalars(p, lr, step)
        wd = self._decay(p)
        gf, pf = g.to(_F32), p.to(_F32)
        p_norm = torch.linalg.vector_norm(pf)
        g_norm = torch.linalg.vector_norm(gf)
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            self._coeff * p_norm / (g_norm + wd * p_norm + self._epsilon),
            1.0)
        upd = gf + wd * pf
        v_new = self._momentum * accs["velocity"] + lr * local_lr * upd
        return (pf - v_new).to(p.dtype), {"velocity": v_new}

    def _update_group(self, device, keys, ps, gs, accs):
        lr, _ = self._device_scalars(device)
        wds = [self._decay(p) for p in keys]
        gfs, pfs = _as_dtype(gs), _as_dtype(ps)
        p_norms = torch._foreach_norm(pfs)
        g_norms = torch._foreach_norm(gfs)
        den = torch._foreach_mul(p_norms, wds)
        torch._foreach_add_(den, g_norms)
        torch._foreach_add_(den, self._epsilon)
        ratio = torch._foreach_div(torch._foreach_mul(p_norms, self._coeff),
                                   den)
        p_norm, g_norm = torch.stack(p_norms), torch.stack(g_norms)
        local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                               torch.stack(ratio), 1.0)
        upd = torch._foreach_mul(pfs, wds)
        torch._foreach_add_(upd, gfs)
        torch._foreach_mul_(upd, list((lr * local_lr).unbind()))
        vs = accs["velocity"]
        torch._foreach_mul_(vs, self._momentum)
        torch._foreach_add_(vs, upd)
        _subtract_into(ps, pfs, vs)
