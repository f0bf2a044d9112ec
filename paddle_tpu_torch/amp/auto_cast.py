"""AMP autocast: the reference's op-level cast policy on PyTorch.

Counterpart of `paddle_tpu/amp/auto_cast.py`. `auto_cast` pushes a policy
onto a thread-local stack; `amp_cast_inputs(op_name, tensors)` applies the
policy on top of it to one op's inputs, as the reference's
`amp_cast_inputs` does at op dispatch:

- O1: a white-list op's floating inputs are cast to the amp dtype, a
  black-list op's to fp32, every other op's are left alone;
- O2: every op's floating inputs are cast to the amp dtype, except a
  black-list op's, which go to fp32;
- O0 (or ``enable=False``): nothing is cast.

The reference applies the policy where every op is dispatched, by op name
(`paddle_tpu/ops/dispatch.py` `_amp_transform`). The port's model calls
torch's own functions (`torch.nn.functional.linear`, `layer_norm`, tensor
methods) and its own `nn.functional` routes, so the policy reaches ops
through two hooks:

- `_AmpMode`, a `torch.overrides.TorchFunctionMode` that the outermost
  `auto_cast` enters: a torch function whose name `_OP_NAMES` maps to a
  reference op name goes through `amp_cast_inputs` under that name;
  others pass untouched. It acts in the forward only: inside a backward
  pass (autograd's graph task) it passes everything through, as the
  reference's casts are taken back by autodiff;
- an explicit `amp_cast_inputs` call at the entry of the port's own
  `nn.functional.scaled_dot_product_attention` and `cross_entropy`, under
  the reference's op names, whose bodies then run under `suspended()`,
  so that each is one op to the policy as it is to the reference.

The optimizer's update, the gradient clip, the regularizer and
`GradScaler`'s arithmetic run under `suspended()`: in the reference they
are no dispatched ops. A cast inside a CUDA graph capture is captured with
it, as the reference's trace bakes its casts in.

`record_casts()` collects ``(op name, input dtypes)`` for every op the
policy sees while it is open, the record the tests compare with the
reference's.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["auto_cast", "amp_guard", "amp_cast_inputs", "decorate",
           "current_amp_state", "suspended", "record_casts", "WHITE_LIST",
           "BLACK_LIST"]

# the reference's O1 lists (paddle_tpu/amp/auto_cast.py:22-33)
WHITE_LIST = {
    "matmul", "mm", "bmm", "conv2d", "conv1d", "conv3d", "conv2d_transpose",
    "einsum", "linear", "addmm",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "softmax", "log_softmax",
    "cross_entropy", "softmax_with_cross_entropy", "mean", "sum", "norm",
    "layer_norm", "batch_norm", "group_norm", "instance_norm", "reduce_sum",
    "cumsum", "pow", "square", "sigmoid_cross_entropy_with_logits",
    "binary_cross_entropy", "nll_loss", "l1_loss", "mse_loss", "smooth_l1_loss",
}

# torch function name -> the reference's op name, for the torch functions
# the policy reaches (the lists' ops, and under O2 the elementwise ops and
# activations the reference dispatches); any other torch function passes
# through the mode untouched
_OP_NAMES = {
    **{n: n for n in WHITE_LIST | BLACK_LIST},
    "__matmul__": "matmul", "__rmatmul__": "matmul",
    "conv_transpose2d": "conv2d_transpose",
    "vector_norm": "norm", "__pow__": "pow", "__rpow__": "pow",
    "binary_cross_entropy_with_logits": "sigmoid_cross_entropy_with_logits",
    "add": "add", "__add__": "add", "__radd__": "add",
    "sub": "subtract", "subtract": "subtract", "__sub__": "subtract",
    "__rsub__": "subtract", "rsub": "subtract",
    "mul": "multiply", "multiply": "multiply", "__mul__": "multiply",
    "__rmul__": "multiply",
    "div": "divide", "divide": "divide", "true_divide": "divide",
    "__truediv__": "divide", "__rtruediv__": "divide",
    "gelu": "gelu", "relu": "relu", "silu": "silu", "tanh": "tanh",
    "sigmoid": "sigmoid", "embedding": "embedding", "dropout": "dropout",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}

_tls = threading.local()


class _AmpState:
    __slots__ = ("enabled", "dtype", "level", "white", "black")

    def __init__(self, enabled, dtype, level, white, black):
        self.enabled = enabled
        self.dtype = dtype
        self.level = level
        self.white = white
        self.black = black


_OFF = _AmpState(False, torch.float32, "O0", frozenset(), frozenset())


def _stack():
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current_amp_state():
    """The policy in force on this thread (an `_AmpState`), or None."""
    stack = _stack()
    return stack[-1] if stack else None


def _to_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"amp dtype must be bfloat16 or float16, got "
                         f"{dtype!r}") from None


@contextlib.contextmanager
def suspended():
    """No casts inside: for code that is no op to the policy (the body of
    a port route that was cast at its entry, the optimizer's update)."""
    stack = _stack()
    stack.append(_OFF)
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def record_casts():
    """Yield a list that gets ``(op name, (input dtype names))`` for each
    op the policy sees on this thread while the block runs (the dtypes as
    the op was called, before its casts)."""
    record = []
    recorders = getattr(_tls, "recorders", None)
    if recorders is None:
        recorders = _tls.recorders = []
    recorders.append(record)
    try:
        yield record
    finally:
        recorders.remove(record)


def amp_cast_inputs(op_name, tensors):
    """`tensors` (a list) cast by the policy in force for op `op_name`:
    the same list where nothing changes."""
    st = current_amp_state()
    if st is None or not st.enabled:
        return tensors
    for record in getattr(_tls, "recorders", ()):
        record.append((op_name, tuple(str(t.dtype).replace("torch.", "")
                                      for t in tensors)))
    if st.level == "O2":
        target = torch.float32 if op_name in st.black else st.dtype
    elif op_name in st.white:
        target = st.dtype
    elif op_name in st.black:
        target = torch.float32
    else:
        return tensors
    if not any(t.is_floating_point() and t.dtype != target for t in tensors):
        return tensors
    return [t.to(target) if t.is_floating_point() and t.dtype != target
            else t for t in tensors]


class _AmpMode(TorchFunctionMode):
    """The hook for torch's own functions (see the module docstring)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _OP_NAMES.get(getattr(func, "__name__", None))
        st = current_amp_state()
        if name is None or st is None or not st.enabled \
                or torch._C._current_graph_task_id() != -1:
            return func(*args, **kwargs)
        flat, spec = tree_flatten((args, kwargs))
        where = [i for i, x in enumerate(flat) if isinstance(x, torch.Tensor)]
        if where:
            cast = amp_cast_inputs(name, [flat[i] for i in where])
            for i, t in zip(where, cast):
                flat[i] = t
            args, kwargs = tree_unflatten(flat, spec)
        return func(*args, **kwargs)


class auto_cast:
    """``with auto_cast(level="O1", dtype="bfloat16"):`` runs the block
    under the policy (see the module docstring); `custom_white_list` /
    `custom_black_list` move reference op names between the lists. Every
    kernel of the port has a bf16 and a float16 instantiation, so both
    dtypes run on the card; CPU tensors take the kernels' plain twins."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        if level not in ("O0", "O1", "O2"):
            raise ValueError(f"level must be O0/O1/O2, got {level}")
        white, black = set(WHITE_LIST), set(BLACK_LIST)
        if custom_white_list:
            white |= set(custom_white_list)
            black -= set(custom_white_list)
        if custom_black_list:
            black |= set(custom_black_list)
            white -= set(custom_black_list)
        self._st = _AmpState(bool(enable) and level != "O0", _to_dtype(dtype),
                             level, frozenset(white), frozenset(black))
        self._mode = None

    def __enter__(self):
        _stack().append(self._st)
        if getattr(_tls, "mode_depth", 0) == 0:
            self._mode = _AmpMode()
            self._mode.__enter__()
        _tls.mode_depth = getattr(_tls, "mode_depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.mode_depth -= 1
        _stack().pop()
        if self._mode is not None:
            mode, self._mode = self._mode, None
            mode.__exit__(*exc)
        return False


amp_guard = auto_cast


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast every floating parameter of `models` (a module or a list)
    to `dtype` in place (``p.data``), so each parameter stays the object
    the optimizers' accumulators are keyed by; masters come from the
    optimizer (``multi_precision=True``). Returns `models`, or ``(models,
    optimizers)`` when optimizers are given."""
    target = _to_dtype(dtype)
    if level == "O2":
        for model in (models if isinstance(models, (list, tuple))
                      else [models]):
            if model is None:
                continue
            for p in model.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(target)
    if optimizers is None:
        return models
    return models, optimizers
