"""GradScaler: dynamic loss scaling.

Counterpart of `paddle_tpu/amp/grad_scaler.py` (`:115-140`). The scale
(fp32), the good-step and bad-step counts (int32) and the found-inf flag
(int32, nonzero where a gradient was not finite) are 0-d tensors on the
device of the first loss the scaler scales, made from the constructor's
numbers then:

- `scale(loss)` multiplies by the scale cast to the loss's dtype;
- `unscale_(optimizer)` sets found-inf from the gradients (any element
  not finite) and multiplies each gradient in place by ``1 / scale``
  cast to the gradient's dtype (`:106-110`), in one pass
  (`kernels.finite_check.multi_tensor_finite` with its scale: one launch
  per gradient dtype on the card);
- `step(optimizer)` unscales if that was not done. With the numeric guard
  off it reads found-inf once (the one host sync a step) and runs
  ``optimizer.step()`` only where it is clear, so a step with an inf or a
  NaN leaves parameters and accumulators as they were. With the guard on
  (``FLAGS_check_numerics``, `ops.guardian.skip_step_enabled`) it runs
  ``optimizer.step()`` unconditionally and reads nothing: the optimizer's
  guarded update skips the step on the same non-finite gradients;
- `update()` runs the transition (`ops.guardian.update_scaler_state`) on
  the device: ``decr_every_n_nan_or_inf`` bad steps in a row shrink the
  scale by ``decr_ratio`` (to no less than 1), ``incr_every_n_steps``
  good ones grow it by ``incr_ratio``; under the guard it queues the
  transition (`guardian.note_scaler`) so a backoff is counted at the next
  boundary. Nothing syncs.

An enabled scaler's `scale` and `step` mark the thread
(`guardian.mark_scaler_active`): a non-finite forward output there is
counted, not raised. None of this is an op to `auto_cast`: it runs under
`amp.suspended()`; nor, but for `scale`'s product (the reference's
``scale_loss`` op), to the per-op checks (`ops.numerics.suspended()`).
"""
from __future__ import annotations

import torch

from ..kernels.finite_check import multi_tensor_finite
from ..ops import guardian, numerics
from ..ops.guardian import update_scaler_state
from .auto_cast import suspended

__all__ = ["GradScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        # the state as numbers until a device holds it
        self._init = (float(init_loss_scaling), 0, 0)
        self._state = None          # (scale, good, bad) on the device
        self._found_inf = None
        self._unscaled = False

    def _on(self, device):
        """The state ``(scale, good, bad)`` on `device`, made there from
        the numbers at the first call."""
        if self._state is None:
            scale, good, bad = self._init
            self._state = (
                torch.tensor(scale, dtype=torch.float32, device=device),
                torch.tensor(good, dtype=torch.int32, device=device),
                torch.tensor(bad, dtype=torch.int32, device=device))
        return self._state

    # -- the loop -----------------------------------------------------------
    def scale(self, var):
        if not self._enable:
            return var
        guardian.mark_scaler_active()
        with suspended():
            return var * self._on(var.device)[0].to(var.dtype)

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Set found-inf from the gradients of `optimizer`'s parameters and
        divide them by the scale, in place (see the module docstring)."""
        if not self._enable:
            return
        if self._unscaled:
            raise RuntimeError("unscale_() has already been called on this "
                               "optimizer since the last update()")
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        with suspended(), numerics.suspended():
            if grads:
                scale = self._on(grads[0].device)[0]
                self._found_inf = torch.zeros((), dtype=torch.int32,
                                              device=scale.device)
                multi_tensor_finite(grads, self._found_inf, 1.0 / scale)
            else:
                self._found_inf = None
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        guardian.mark_scaler_active()
        if not self._unscaled:
            self.unscale_(optimizer)
        self._unscaled = False
        if guardian.skip_step_enabled() or self._found_inf is None \
                or not bool(self._found_inf):
            optimizer.step()

    @torch.no_grad()
    def update(self):
        """The loss-scale transition on the device; nothing syncs."""
        if not self._enable:
            return
        found, self._found_inf = self._found_inf, None
        self._unscaled = False
        if not self._dynamic or self._state is None:
            return
        scale, good, bad = self._state
        with suspended(), numerics.suspended():
            found = torch.zeros((), dtype=torch.bool, device=scale.device) \
                if found is None else found != 0
            new = update_scaler_state(
                scale, good, bad, found, self._incr_ratio, self._decr_ratio,
                self._incr_every_n_steps, self._decr_every_n_nan_or_inf)
            if guardian.enabled():
                guardian.note_scaler(scale, new[0])
            for old, value in zip(self._state, new):
                old.copy_(value)

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    # -- queries and state --------------------------------------------------
    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def _numbers(self):
        if self._state is None:
            return self._init
        scale, good, bad = self._state
        return float(scale), int(good), int(bad)

    def get_init_loss_scaling(self):
        return self._numbers()[0]

    def state_dict(self):
        scale, good, bad = self._numbers()
        return {"scale": scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                "good_steps": good, "bad_steps": bad}

    def load_state_dict(self, state):
        self._init = (float(state["scale"]), int(state.get("good_steps", 0)),
                      int(state.get("bad_steps", 0)))
        if self._state is not None:
            for old, value in zip(self._state, self._init):
                old.fill_(value)
        self._found_inf = None
        self._unscaled = False
