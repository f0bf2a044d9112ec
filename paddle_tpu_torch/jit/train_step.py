"""TrainStep: one training step, run eagerly.

Counterpart of `paddle_tpu/jit/train_step.py` (`TrainStep`). Each call runs
the forward ``model(*args[:-1])``, ``loss_fn(out, args[-1])``, the
backward, and the optimizer's per-parameter update rule over every
parameter of the model that requires grad (one with no gradient is updated
with a zero gradient, as the reference's traced step does), and returns the
detached loss. Gradients go straight from autograd to the update, so no
``.grad`` is left behind. With ``loss_fn=None`` the model returns the loss
from all of `args`.

The reference compiles the step with `jax.jit` and donates buffers; PyTorch
runs it eagerly and the update writes the parameters in place, so there is
no `donate` option.

The reference's step applies neither the optimizer's gradient clip nor its
regularizer, while its `Optimizer.step` applies both (ROADMAP.md Queue 3).
Until that is settled, a TrainStep over an optimizer with a gradient clip
raises NotImplementedError; the port's optimizers take no regularizer yet.
"""
from __future__ import annotations

import torch

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, model, loss_fn, optimizer):
        if optimizer._grad_clip is not None:
            raise NotImplementedError(
                "TrainStep with a gradient clip: the reference's TrainStep "
                "ignores it while its Optimizer.step applies it (ROADMAP.md "
                "Queue 3); call loss.backward() and optimizer.step() instead")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._params = [p for p in model.parameters() if p.requires_grad]

    def __call__(self, *args):
        if self.loss_fn is not None:
            loss = self.loss_fn(self.model(*args[:-1]), args[-1])
        else:
            loss = self.model(*args)
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        self.optimizer._apply_optimize(
            [(p, torch.zeros_like(p) if g is None else g)
             for p, g in zip(self._params, grads)])
        return loss.detach()
