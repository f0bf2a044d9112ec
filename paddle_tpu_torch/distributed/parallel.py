"""DataParallel, PyTorch port.

Counterpart of `paddle_tpu/distributed/parallel.py` (`DataParallel`): the
wrapped model's forward, and after each backward every gradient summed
over the data-parallel group and divided by its size, so each rank steps
with the mean of the ranks' gradients. As in the reference, a group of
one rank syncs nothing, and ``grad_sync=False`` (DGC, LocalSGD: they
communicate themselves) turns the sync off.

The sum runs over flat buckets: the gradients of one dtype and device,
in parameter order, packed into buffers of at most `comm_buffer_size` MB
(the reference's argument, which it stores; one gradient larger than
that is a bucket alone), one `all_reduce` a bucket, then the division.
Each element is summed over the same ranks as a per-tensor sum would
sum it.

Two paths sync:

- ``loss.backward(); opt.step()``: each parameter's post-accumulate hook
  marks it ready; the first one of a backward queues a callback that runs
  when the backward ends and syncs the ``.grad`` of every ready
  parameter. A gradient accumulated over several backwards is still
  right: what it held is already equal on every rank, so the mean of
  (held + new) is held + the mean of new.
- `jit.TrainStep` (``torch.autograd.grad``, no ``.grad``): the step calls
  `_reduce_grads` on its gradients after the backward and before the
  optimizer's regularizer and clip (`Optimizer._prepare`), so those see
  the averaged gradients, in the reference's eager order.

Every rank must produce gradients for the same parameters, as every rank
joins each bucket's collective.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.autograd import Variable

from .collective import ReduceOp, all_reduce
from .env import get_world_size

__all__ = ["DataParallel"]


def _buckets(grads, limit_bytes):
    """`grads` split into lists of one dtype and device, in order, each of
    at most `limit_bytes` (a larger gradient alone)."""
    out, open_ = [], {}
    for g in grads:
        key = (g.dtype, g.device)
        size = g.numel() * g.element_size()
        bucket = open_.get(key)
        if bucket is None or bucket[1] + size > limit_bytes:
            bucket = open_[key] = [[], 0]
            out.append(bucket[0])
        bucket[0].append(g)
        bucket[1] += size
    return out


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, grad_sync=True):
        super().__init__()
        self._layers = layers
        self.group = group
        self.comm_buffer_size = comm_buffer_size
        self.find_unused_parameters = find_unused_parameters
        self._world = get_world_size(group)
        self._sync = bool(grad_sync) and self._world > 1
        self._ready = []
        self._hooks = []
        if self._sync:
            for p in self._layers.parameters():
                if p.requires_grad:
                    self._hooks.append(p.register_post_accumulate_grad_hook(
                        self._grad_ready))

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def _grad_ready(self, param):
        if not self._ready:
            Variable._execution_engine.queue_callback(self._sync_ready)
        self._ready.append(param)

    def _sync_ready(self):
        ready, self._ready = {id(p) for p in self._ready}, []
        self._average([p.grad for p in self._layers.parameters()
                       if id(p) in ready])

    @torch.no_grad()
    def _average(self, grads):
        """Each of `grads` replaced, in place, by its mean over the group
        (module docstring)."""
        limit = int(self.comm_buffer_size * 2**20)
        for bucket in _buckets(grads, limit):
            flat = torch.cat([g.reshape(-1) for g in bucket])
            all_reduce(flat, op=ReduceOp.SUM, group=self.group)
            flat.div_(self._world)
            at = 0
            for g in bucket:
                g.copy_(flat[at:at + g.numel()].view_as(g))
                at += g.numel()

    def _reduce_grads(self, params_grads):
        """`jit.TrainStep`'s sync: the gradients of ``(param, grad)``
        pairs averaged over the group in place (nothing where the sync is
        off); returns the pairs."""
        if self._sync:
            self._average([g for _, g in params_grads])
        return params_grads

    def apply_collective_grads(self):
        """Average every ``.grad`` over the group now (the reference's
        manual sync)."""
        if self._world > 1:
            self._average([p.grad for p in self._layers.parameters()
                           if p.grad is not None])

    def scale_loss(self, loss):
        return loss

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_state_dict = load_state_dict
