"""Learning-rate schedulers.

Counterpart of `paddle_tpu/optimizer/lr.py`: `LRScheduler` and its fifteen
subclasses, plain Python on doubles, so a schedule gives the reference's
values bit for bit. An optimizer built with a scheduler reads
``scheduler()`` at every update (`Optimizer.get_lr`); the caller advances
it with ``scheduler.step()``. On the card the value reaches the update
kernel through a device scalar that is set before each launch or graph
replay, so a captured training step follows the schedule.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "NoamDecay", "ExponentialDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
           "PiecewiseDecay", "CosineAnnealingDecay", "MultiStepDecay",
           "StepDecay", "LambdaDecay", "ReduceOnPlateau", "MultiplicativeDecay",
           "OneCycleLR", "CyclicLR"]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: {type(self).__name__} set "
                  f"learning rate to {self.last_lr}.")

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list, tuple, dict))}

    def set_state_dict(self, state_dict):
        self.__dict__.update(state_dict)

    load_state_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        a = step ** -0.5
        b = step * (self.warmup_steps ** -1.5)
        return self.base_lr * (self.d_model ** -0.5) * min(a, b)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(step / float(self.decay_steps)) or 1
            decay_steps = self.decay_steps * div
        else:
            decay_steps = self.decay_steps
            step = min(step, self.decay_steps)
        return (self.base_lr - self.end_lr) * \
            ((1 - step / decay_steps) ** self.power) + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.inner = learning_rate if isinstance(learning_rate, LRScheduler) \
            else None
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        lr = learning_rate if not self.inner else learning_rate.base_lr
        super().__init__(lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * \
                self.last_epoch / float(self.warmup_steps)
        if self.inner is not None:
            self.inner.step(self.last_epoch - self.warmup_steps)
            return self.inner.last_lr
        return self.base_lr

    def state_dict(self):
        d = super().state_dict()
        if self.inner is not None:
            d["inner"] = self.inner.state_dict()
        return d

    def set_state_dict(self, state):
        inner = state.pop("inner", None)
        super().set_state_dict(state)
        if inner and self.inner is not None:
            self.inner.set_state_dict(inner)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * (self.gamma ** n)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** (self.last_epoch // self.step_size))


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def state_dict(self):
        d = super().state_dict()
        d.pop("lr_lambda", None)
        return d


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        self._cur = float(learning_rate)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            self._cur = self._cur * self.lr_lambda(self.last_epoch)
        return self._cur


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        current = float(metrics if not hasattr(metrics, "item")
                        else metrics.item())
        if self.best is None or self._is_better(current):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        self.last_epoch += 1

    def _is_better(self, current):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return current < self.best * (1 - self.threshold)
            return current < self.best - self.threshold
        if self.threshold_mode == "rel":
            return current > self.best * (1 + self.threshold)
        return current > self.best + self.threshold


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        self.three_phase = three_phase
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _anneal(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return (end - start) * pct + start

    def get_lr(self):
        step = min(self.last_epoch, self.total_steps)
        up_steps = int(self.phase_pct * self.total_steps)
        if step <= up_steps:
            return self._anneal(self.initial_lr, self.max_lr,
                                step / max(up_steps, 1))
        return self._anneal(self.max_lr, self.end_lr,
                            (step - up_steps) / max(self.total_steps - up_steps, 1))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.step_size_up = step_size_up
        self.step_size_down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        self.scale_fn = scale_fn
        self.scale_mode = scale_mode
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.step_size_up + self.step_size_down
        cycle = math.floor(1 + self.last_epoch / total)
        x = self.last_epoch - (cycle - 1) * total
        if x < self.step_size_up:
            pct = x / self.step_size_up
        else:
            pct = 1 - (x - self.step_size_up) / self.step_size_down
        amp = (self.max_lr - self.base_lr) * pct
        if self.mode == "triangular2":
            amp = amp / (2 ** (cycle - 1))
        elif self.mode == "exp_range":
            amp = amp * (self.exp_gamma ** self.last_epoch)
        elif self.scale_fn is not None:
            arg = cycle if self.scale_mode == "cycle" else self.last_epoch
            amp = amp * self.scale_fn(arg)
        return self.base_lr + amp
