"""TrainStep: one training step as one program.

Counterpart of `paddle_tpu/jit/train_step.py` (`TrainStep`), which compiles
forward, backward and update into one XLA executable with `jax.jit`. Each
call runs the forward ``model(*args[:-1])``, ``loss_fn(out, args[-1])``,
the backward, and the optimizer's step over every parameter of the model
that requires grad (one with no gradient is updated with a zero gradient,
as the reference's traced step does), and returns the loss as a fresh
tensor. The step is the optimizer's own, as its eager `step` runs it: the
regularizer, then the gradient clip (a global norm stays on the device),
then the multi-tensor update (`Optimizer._prepare`, `_update`), outside
any `amp.auto_cast` the call is made in (the forward runs under it). A
`distributed.DataParallel` model averages the gradients over its group
between the backward and the regularizer (its `_reduce_grads`).
Gradients go straight from autograd to the update, so no ``.grad`` is left
behind. With ``loss_fn=None`` the model returns the loss from all of
`args`.

On the card the step is one CUDA graph replay. The first call with an
input signature (shapes, dtypes, device) builds it: static input buffers,
one eager warm-up of the forward and backward on a side stream (it loads
cuBLAS and the kernels' libraries before capture; the update then runs on
one scratch element of each parameter dtype, so nothing of the model
moves; the model's floating buffers, a batch norm's running statistics,
are copied before it and back after it, so a build moves none of them),
and one capture of forward, loss, `torch.autograd.grad` and the
optimizer's update. The graph holds the buffers as it holds the
parameters: a training batch norm moves its ``_mean`` / ``_variance`` in
place on every replay, once a step, as the eager step and the
reference's step (which threads them through as ``new_b``) do. Each
call then copies the inputs into the static inputs, counts the step and
fills the optimizer's lr and step scalars by value
(`Optimizer._begin_step`), replays, and returns a clone of the static
loss, which the next replay overwrites. A new signature builds a new graph,
as the reference's `jax.jit` retraces; so does a parameter whose storage
moved since the build (``p.data = ...``, ``model.to(...)``), since the
graph holds its address (the optimizer's accumulators are made once and
updated in place, and `Optimizer.set_state_dict` copies into them, so
theirs stay). `_builds` counts builds. Values read
while capturing (flags such as ``FLAGS_use_fused_cross_entropy``) are
baked in, as the reference's trace bakes them. A failed capture raises
with its cause; there is no eager fallback. On the CPU the same step code
runs eagerly (`_step_eager`, which the card's smoke also times against the
graph).

The reference's `TrainStep` applies neither the optimizer's clip nor its
regularizer, while its `Optimizer.step` applies both; ``grad_clip=`` means
the optimizer clips wherever it updates, so the port applies both here
and is held to the reference's eager loop (ROADMAP.md Queue 3 logs the
reference's step as a fault).

The numeric flags, read at each call and part of the graph's key (so
flipping one builds the graph again, as the reference's optimizer keys its
jitted update on the guard):

- ``FLAGS_check_numerics`` (`ops.guardian.mode` "check"): the step's update is
  the optimizer's guarded one (``_update(..., guard="check")``, a bad
  step a bitwise no-op), and the step also computes the loss's
  finiteness; each call queues both (`guardian.note_step("train_step",
  ...)`) and ends at the boundary `guardian.maybe_flush()`, syncing
  nothing. A non-finite loss raises `FloatingPointError` at a later
  boundary (level 0) or warns (level 1), as the reference's eager loop
  with the flag on does for its forward outputs.
- ``FLAGS_check_nan_inf`` (mode "strict"): the update writes only where
  the loss is finite (the optimizer's flag set from the loss,
  ``guard="strict"``);
  after the step one sync reads the loss's finiteness and a non-finite
  one raises `FloatingPointError` with the parameters and the
  accumulators as they were. The reference keeps its parameters but lands
  that step's accumulators, whose buffers it donated (ROADMAP.md Queue 3).

Under either flag no op of the step is checked on its own (the capture
drops them on the card; `ops.numerics.suspended` on the CPU), as the
reference's trace drops them.

``donate`` is the reference's argument (which buffers its jitted step
donates: the accumulators by default, the parameters too with ``"all"``).
The port's step updates parameters and accumulators in place whatever it
says, which is what donation buys there, so it is taken and not read.
"""
from __future__ import annotations

import contextlib

import torch

from .. import amp
from ..kernels import capture_graph, warm_up
from ..ops import guardian, numerics

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, donate=True):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._params = [p for p in model.parameters() if p.requires_grad]
        self._builds = 0
        self._key = None
        self._graph = None

    def _loss(self, args):
        if self.loss_fn is not None:
            return self.loss_fn(self.model(*args[:-1]), args[-1])
        return self.model(*args)

    def _grads(self, loss):
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        return [(p, torch.zeros_like(p) if g is None else g)
                for p, g in zip(self._params, grads)]

    def _step_code(self, args, guard):
        """Forward, loss, gradients and the optimizer's step under the
        numeric mode `guard` (`guardian.mode`); returns the
        detached loss and the guard's bool checks (None without a guard):
        ``[step finite, loss finite]`` under "check", ``[loss finite]``
        under "strict"."""
        loss = self._loss(args)
        params_grads = self._grads(loss)
        # a data-parallel model's gradient sync, before the regularizer
        # and the clip (`distributed.DataParallel`)
        reduce_grads = getattr(self.model, "_reduce_grads", None)
        if reduce_grads is not None:
            params_grads = reduce_grads(params_grads)
        opt = self.optimizer
        with torch.no_grad(), amp.suspended():
            params_grads = opt._prepare(params_grads)
            if guard is None:
                opt._update(params_grads)
                return loss.detach(), None
            device = self._params[0].device
            fwd_finite = torch.isfinite(loss.detach()).all()
            if guard == "check":
                opt._update(params_grads, guard="check")
                return loss.detach(), torch.stack(
                    [opt._guard_flag(device).eq(0), fwd_finite])
            opt._guard_flag(device).copy_(~fwd_finite)
            opt._update(params_grads, guard="strict")
            return loss.detach(), fwd_finite.reshape(1)

    def _finish(self, guard, checks):
        """After a step: queue the guard's outcome, or raise on a
        non-finite loss in the strict mode."""
        if guard == "check":
            guardian.note_step("train_step", checks[0], checks[1],
                               step_index=self.optimizer._step_count)
            guardian.maybe_flush()
        elif guard == "strict" and not bool(checks[0]):
            raise FloatingPointError(
                "TrainStep produced a non-finite loss (FLAGS_check_nan_inf); "
                "the parameters and the optimizer's accumulators were not "
                "updated: run the step eagerly to find the op")

    def _step_eager(self, *args):
        """One step without a graph (the CPU's step)."""
        guard = guardian.mode()
        opt = self.optimizer
        with numerics.suspended():
            opt._create_accumulators(self._params)
            opt._begin_step({p.device for p in self._params})
            loss, checks = self._step_code(args, guard)
        self._finish(guard, checks)
        return loss

    def __call__(self, *args):
        if not self._params or self._params[0].device.type != "cuda":
            return self._step_eager(*args)
        device = self._params[0].device
        args = [torch.as_tensor(a, device=device) for a in args]
        opt = self.optimizer
        opt._create_accumulators(self._params)
        guard = guardian.mode()
        key = (tuple((a.shape, a.dtype) for a in args),
               tuple(p.data_ptr() for p in self._params),
               # read anew: `model.to` replaces buffer tensors
               tuple(b.data_ptr() for b in self.model.buffers()), guard)
        with numerics.suspended():
            if key != self._key:
                self._build(args, guard)
                self._key = key
            for buf, a in zip(self._static, args):
                buf.copy_(a)
            opt._begin_step((device,))
            self._graph()
            loss = self._static_loss.clone()
            checks = None if self._static_checks is None \
                else self._static_checks.clone()
        self._finish(guard, checks)
        return loss

    @contextlib.contextmanager
    def _buffers_kept(self):
        """The model's floating buffers as they were before the block:
        the warm-up's forward would move a batch norm's running statistics
        once more than the steps do."""
        saved = [(b, b.clone()) for b in self.model.buffers()
                 if b.is_floating_point()]
        try:
            yield
        finally:
            with torch.no_grad():
                for b, value in saved:
                    b.copy_(value)

    def _build(self, args, guard):
        """Capture forward, backward and update over static copies of
        `args` (see the module docstring)."""
        self._graph = self._static_loss = self._static_checks = None
        self._builds += 1
        device = self._params[0].device
        if len({p.device for p in self._params}) != 1:
            raise NotImplementedError("a TrainStep graph takes parameters on "
                                      "one device")
        opt = self.optimizer
        opt._device_scalars(device)
        opt._guard_flag(device)
        self._static = [a.clone() for a in args]

        def warm():
            self._grads(self._loss(self._static))
            # the update on one scratch element of each parameter dtype:
            # loads its library and kernels without moving the model
            scratch = [torch.zeros(1, dtype=dtype, device=device)
                       for dtype in {p.dtype for p in self._params}]
            opt._create_accumulators(scratch)
            try:
                with torch.no_grad(), amp.suspended():
                    opt._update([(s, torch.zeros_like(s)) for s in scratch],
                                guard=guard)
            finally:
                for slot in opt._accumulators.values():
                    for s in scratch:
                        slot.pop(s, None)

        with self._buffers_kept():
            warm_up(warm, device)
        torch.cuda.synchronize(device)
        try:
            self._graph, (self._static_loss, self._static_checks) = \
                capture_graph(lambda: self._step_code(self._static, guard))
        except Exception as err:
            raise RuntimeError(f"TrainStep: capturing the training step in "
                               f"a CUDA graph failed: {err}") from err

