"""Strategy-driven meta-optimizers, PyTorch port.

Counterpart of `paddle_tpu/distributed/fleet/meta_optimizers.py`: the
`DistributedStrategy` flags applied to an eager optimizer as the
reference applies them:

  lamb / lars      the base optimizer swapped (Adam/AdamW -> Lamb,
                   Momentum -> Lars) over the same parameters, lr and clip
  dgc              Momentum wrapped in `DGCMomentum`: top-k sparsified
                   gradients with momentum correction and error feedback,
                   averaged over the data-parallel group
  gradient_merge   `GradientMergeOptimizer`: k micro-steps summed (or
                   averaged), applied on the k-th
  localsgd         `LocalSGDOptimizer`: the parameters averaged over the
                   data-parallel group every k steps
  amp (O2)         the optimizer's fp32 masters (``multi_precision``)
  recompute        `apply_recompute`, on the model: the named sublayers'
                   forwards under `torch.utils.checkpoint`

Every flag acts or raises: sharding is ROADMAP item 7(b) and raises, so
does `heter_ccl_mode`. The wrappers step eagerly (``loss.backward();
opt.step()``); `jit.TrainStep`, which runs an optimizer's update itself,
refuses them.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["apply_strategy", "apply_recompute", "GradientMergeOptimizer",
           "LocalSGDOptimizer", "DGCMomentum"]


def apply_recompute(model, recompute_configs):
    """Recompute the activations of the sublayers named in
    ``recompute_configs["checkpoints"]`` (sublayer names, each also
    selecting its subtree: ``"h.1"`` selects ``h.1`` and ``h.1.attn`` but
    not ``h.10``) in the backward, through `torch.utils.checkpoint`. A
    sublayer under one already wrapped is left alone. Raises ValueError
    on an empty list or one that matches nothing."""
    checkpoints = list((recompute_configs or {}).get("checkpoints") or [])
    if not checkpoints:
        raise ValueError(
            "strategy.recompute=True requires recompute_configs"
            "['checkpoints']: a list of sublayer names to checkpoint")

    def matches(name):
        return any(name == tok or name.startswith(tok + ".")
                   for tok in checkpoints)

    wrapped = []
    for name, sub in model.named_modules():
        if not name or not matches(name) or getattr(
                sub, "_recompute_wrapped", False) or any(
                    name.startswith(w + ".") for w in wrapped):
            continue
        forward = sub.forward

        def run(*args, _forward=forward, **kwargs):
            return checkpoint(_forward, *args, use_reentrant=False, **kwargs)

        sub.forward = run
        sub._recompute_wrapped = True
        wrapped.append(name)
    if not wrapped:
        raise ValueError(
            f"no sublayer matched recompute checkpoints {checkpoints}")
    return model


class _OptWrapper:
    """An optimizer wrapper: what it does not override passes through to
    the optimizer it wraps (which may be a wrapper too)."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def step(self):
        self._inner.step()

    def clear_grad(self, set_to_zero=True):
        self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    def state_dict(self):
        return self._inner.state_dict()

    def set_state_dict(self, state):
        return self._inner.set_state_dict(state)

    def _prepare(self, params_grads):
        raise NotImplementedError(
            f"{type(self).__name__} steps eagerly (loss.backward(); "
            f"opt.step()); jit.TrainStep runs an optimizer's update itself "
            f"and would skip it")


def unwrap_optimizer(opt):
    """The innermost optimizer under any chain of wrappers (writes must
    go to it: a write on a wrapper stays there)."""
    while True:
        if isinstance(opt, _OptWrapper):
            opt = opt._inner
        elif hasattr(opt, "_inner_opt"):        # HybridParallelOptimizer
            opt = opt._inner_opt
        else:
            return opt


def _base_params(opt):
    return unwrap_optimizer(opt)._parameter_list


class GradientMergeOptimizer(_OptWrapper):
    """Gradients summed in fp32 over `k_steps` calls of `step` (averaged
    with `avg`) and applied by the wrapped optimizer on the k-th; the
    calls between drop their ``.grad`` and update nothing."""

    def __init__(self, inner, k_steps=1, avg=True):
        super().__init__(inner)
        self._k_steps = max(int(k_steps), 1)
        self._avg = bool(avg)
        self._merged = {}
        self._count = 0

    @torch.no_grad()
    def step(self):
        params = [p for p in _base_params(self) if p.grad is not None]
        if not params:
            return
        self._count += 1
        for p in params:
            g = p.grad.float()
            if id(p) in self._merged:
                self._merged[id(p)][0].add_(g)
            else:
                self._merged[id(p)] = (g.clone(), p)
        if self._count % self._k_steps:
            for p in params:
                p.grad = None
            return
        scale = 1.0 / self._k_steps if self._avg else 1.0
        # the whole buffer: a parameter without a gradient this micro-step
        # must not carry its sum into the next window
        for g, p in self._merged.values():
            p.grad = (g * scale).to(p.dtype)
        self._merged.clear()
        self._inner.step()


class LocalSGDOptimizer(_OptWrapper):
    """Local steps, and every `k_steps` from `begin_step` on the
    parameters averaged over `group` (nothing to do in a group of one)."""

    def __init__(self, inner, k_steps=1, begin_step=1, group=None):
        super().__init__(inner)
        self._k_steps = max(int(k_steps), 1)
        self._begin_step = int(begin_step)
        self._group = group
        self._local_steps = 0

    def step(self):
        self._inner.step()
        self._local_steps += 1
        if self._local_steps < self._begin_step:
            return
        if self._local_steps % self._k_steps == 0:
            self._average_params()

    @torch.no_grad()
    def _average_params(self):
        from ..collective import ReduceOp, all_reduce
        from ..env import get_world_size
        world = get_world_size(self._group)
        if world <= 1:
            return
        for p in _base_params(self):
            if not p.requires_grad:
                continue
            all_reduce(p.data, op=ReduceOp.SUM, group=self._group)
            p.data.div_(world)


def _dgc_compress(u, e, g, momentum, keep_ratio):
    """One DGC step of one tensor: momentum correction, error feedback and
    top-k selection (the reference's `_dgc_compress`). Returns ``(new_u,
    new_e, sparse)``, sparse the communicated gradient (zeros off the
    ceil(keep_ratio * numel) largest magnitudes and their ties)."""
    g = g.float()
    u = momentum * u + g
    v = e + u
    flat = v.abs().reshape(-1)
    k = max(int(math.ceil(keep_ratio * flat.numel())), 1)
    thr = torch.topk(flat, k).values[-1]
    mask = v.abs() >= thr
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    return (torch.where(mask, zero, u), torch.where(mask, zero, v),
            torch.where(mask, v, zero))


class DGCMomentum(_OptWrapper):
    """Deep Gradient Compression over a Momentum optimizer (the
    reference's): after `rampup_begin_step` plain momentum steps, each
    gradient goes through `_dgc_compress` at the sparsity of the
    schedule (`sparsity`'s entries in turn, each for ``rampup_step /
    len(sparsity)`` steps, then the last), is averaged over `group`, and
    the wrapped Momentum applies it with its momentum at 0 (the
    compressor applied the momentum)."""

    def __init__(self, inner, rampup_begin_step=0, rampup_step=1,
                 sparsity=(0.999,), group=None):
        from ...optimizer import Momentum
        if not isinstance(inner, Momentum):
            raise TypeError(f"strategy.dgc requires a Momentum optimizer; "
                            f"got {type(inner).__name__}")
        super().__init__(inner)
        self._base_momentum_opt = inner
        self._momentum = inner._momentum
        self._rampup_begin = int(rampup_begin_step)
        self._sparsity = tuple(float(s) for s in sparsity) or (0.999,)
        self._stage_len = max(int(rampup_step) // len(self._sparsity), 1)
        self._group = group
        # by the parameter's index in the optimizer's list
        self._u = {}
        self._e = {}
        self._steps = 0

    def _current_sparsity(self):
        done = self._steps - self._rampup_begin - 1
        idx = min(done // self._stage_len, len(self._sparsity) - 1)
        return self._sparsity[max(idx, 0)]

    def step(self):
        self._steps += 1
        if self._steps <= self._rampup_begin:
            self._inner.step()
            return
        self._compress()
        base = self._base_momentum_opt
        saved = base._momentum
        base._momentum = 0.0
        try:
            self._inner.step()
        finally:
            base._momentum = saved

    @torch.no_grad()
    def _compress(self):
        from ..collective import ReduceOp, all_reduce
        from ..env import get_world_size
        keep = 1.0 - self._current_sparsity()
        world = get_world_size(self._group)
        for i, p in enumerate(_base_params(self)):
            if p.grad is None:
                continue
            u = self._u.get(i)
            e = self._e.get(i)
            if u is None:
                u = torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
                e = torch.zeros_like(u)
            u, e, sparse = _dgc_compress(u, e, p.grad, self._momentum, keep)
            self._u[i], self._e[i] = u, e
            if world > 1:
                all_reduce(sparse, op=ReduceOp.SUM, group=self._group)
                sparse.div_(world)
            p.grad = sparse.to(p.grad.dtype)

    def state_dict(self):
        sd = self._inner.state_dict()
        sd["_dgc_u"] = dict(self._u)
        sd["_dgc_e"] = dict(self._e)
        sd["_dgc_steps"] = self._steps
        return sd

    def set_state_dict(self, state):
        state = dict(state)
        self._u = dict(state.pop("_dgc_u", {}))
        self._e = dict(state.pop("_dgc_e", {}))
        self._steps = int(state.pop("_dgc_steps", 0))
        return self._inner.set_state_dict(state)


def _swap_base(optimizer, new_cls, **kwargs):
    """`new_cls` over `optimizer`'s parameters (named where it had their
    names), lr and clip."""
    params = optimizer._parameter_list
    if len(optimizer._names) == len(params):
        params = [(optimizer._names[p], p) for p in params]
    return new_cls(learning_rate=optimizer._learning_rate,
                   parameters=params, grad_clip=optimizer._grad_clip,
                   **kwargs)


def apply_strategy(optimizer, strategy, hcg=None):
    """`strategy`'s flags applied to `optimizer` (module docstring);
    returns the optimizer or its wrapper, with the passes applied listed
    in ``_applied_passes``. A flag this port cannot apply raises."""
    from ...optimizer import Adam, Lamb, Lars, Momentum
    applied = []

    if getattr(strategy, "heter_ccl_mode", False):
        raise NotImplementedError(
            "strategy.heter_ccl_mode (collectives across heterogeneous "
            "devices) has no equivalent: one backend a world; unset it")

    if strategy.lamb:
        if not isinstance(optimizer, Adam):
            raise TypeError(f"strategy.lamb swaps Adam/AdamW -> Lamb; got "
                            f"{type(optimizer).__name__}")
        cfg = getattr(strategy, "lamb_configs", {}) or {}
        exclude = tuple(cfg.get("exclude_from_weight_decay") or ())
        names = optimizer._names
        optimizer = _swap_base(
            optimizer, Lamb,
            lamb_weight_decay=cfg.get("lamb_weight_decay", 0.01),
            beta1=optimizer._beta1, beta2=optimizer._beta2,
            epsilon=optimizer._epsilon,
            exclude_from_weight_decay_fn=(
                (lambda p: any(tok in names.get(p, "") for tok in exclude))
                if exclude else None))
        applied.append("lamb")

    if strategy.lars:
        if not isinstance(optimizer, Momentum):
            raise TypeError(f"strategy.lars swaps Momentum -> Lars; got "
                            f"{type(optimizer).__name__}")
        cfg = getattr(strategy, "lars_configs", {}) or {}
        optimizer = _swap_base(
            optimizer, Lars,
            momentum=optimizer._momentum,
            lars_coeff=cfg.get("lars_coeff", 0.001),
            lars_weight_decay=cfg.get("lars_weight_decay", 0.0005),
            epsilon=cfg.get("epsilon", 1e-9),
            exclude_from_weight_decay=cfg.get("exclude_from_weight_decay"))
        applied.append("lars")

    if strategy.amp:
        cfg = strategy.amp_configs or {}
        if cfg.get("level", "O1") == "O2" or cfg.get("use_pure_fp16"):
            if not hasattr(optimizer, "_multi_precision"):
                raise TypeError(
                    f"strategy.amp level O2 needs an optimizer that keeps "
                    f"fp32 masters (the Adam family); "
                    f"{type(optimizer).__name__} keeps none")
            optimizer._multi_precision = True
            applied.append("amp_o2_master_weights")
        else:
            # O1 casts the forward (amp.auto_cast); the optimizer keeps its
            # update as it is
            applied.append("amp_o1_bf16")

    if strategy.sharding:
        stage = int((strategy.sharding_configs or {}).get("stage", 1))
        raise NotImplementedError(
            f"strategy.sharding stage {stage} shards the optimizer's state"
            + ("" if stage == 1 else ", the gradients and the parameters "
               "(the reference's group_sharded_parallel)")
            + ": ROADMAP item 7(b)")

    if strategy.dgc:
        cfg = getattr(strategy, "dgc_configs", {}) or {}
        optimizer = DGCMomentum(
            optimizer,
            rampup_begin_step=cfg.get("rampup_begin_step", 0),
            rampup_step=cfg.get("rampup_step", 1),
            sparsity=cfg.get("sparsity", [0.999]),
            group=hcg.get_data_parallel_group() if hcg is not None else None)
        applied.append("dgc")

    if strategy.gradient_merge:
        cfg = strategy.gradient_merge_configs or {}
        optimizer = GradientMergeOptimizer(optimizer,
                                           k_steps=cfg.get("k_steps", 1),
                                           avg=cfg.get("avg", True))
        applied.append("gradient_merge")

    if strategy.localsgd:
        cfg = getattr(strategy, "localsgd_configs", {}) or {}
        optimizer = LocalSGDOptimizer(
            optimizer, k_steps=cfg.get("k_steps", 1),
            begin_step=cfg.get("begin_step", 1),
            group=hcg.get_data_parallel_group() if hcg is not None else None)
        applied.append("localsgd")

    optimizer._applied_passes = applied
    return optimizer
