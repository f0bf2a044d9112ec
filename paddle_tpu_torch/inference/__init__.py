"""Inference API: serve a program saved by `jit.save` from a `Predictor`.

Counterpart of `paddle_tpu/inference/__init__.py` (`Config`, `Predictor`,
`create_predictor`, `PredictorPool`, the zero-copy-style handles,
`DataType` and the version helpers; `:45-282`), the reference's
AnalysisPredictor analog: deployment code written against
``paddle_infer`` runs unchanged. The artifact is `jit.save`'s: a program
exported by `torch.export`, which replays the port's kernels that it
reaches as `torch.library` ops (the flash forward, fused LN).

The place is the card: ``Config(path)`` runs the program on ``cuda`` (or
``cuda:<device_id>`` after ``enable_use_gpu(..., device_id)``) and raises
where no card exists, as every entry point of the port does; pass
``device="cpu"`` or call ``disable_gpu()`` for the CPU. A program exported
on another device is moved to the place
(`torch.export.passes.move_to_device_pass`) or the predictor raises; it
never runs on the save's device instead.

`run` keeps the reference's contract: numpy arrays in, numpy arrays out,
or the handle style (``copy_from_cpu`` -> ``run()`` -> ``copy_to_cpu``).
numpy has no bfloat16, so a bfloat16 program's handles raise TypeError:
run such a program through `jit.load`'s layer on device tensors.

For batched generation under live traffic use `serving.LLMEngine`, as the
reference advises: a Predictor replays one program a call with the batch
frozen for the request's lifetime.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..jit.api import TranslatedLayer, load as _jit_load

__all__ = ["Config", "Predictor", "create_predictor", "PredictorPool",
           "PrecisionType", "PlaceType", "DataType", "get_version",
           "get_num_bytes_of_data_type", "convert_to_mixed_precision",
           "get_trt_compile_version", "get_trt_runtime_version"]


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    CPU = 0
    GPU = 1
    CUSTOM = 3


class Config:
    """The artifact's path and the predictor's place. ``device=None``
    means the card (``cuda``) and raises where there is none; the IR,
    memory, thread, TensorRT and MKLDNN knobs are kept for the reference's
    call sites and change nothing (the program is what `torch.export`
    traced)."""

    def __init__(self, prog_file=None, params_file=None, device=None):
        self._model_path = prog_file
        self._params_file = params_file
        self._device = resolve_device(device)
        self._ir_optim = True
        self._memory_optim = True
        self._precision = PrecisionType.Float32
        self._threads = 1

    # --- model location
    def set_prog_file(self, path):
        self._model_path = path

    def prog_file(self):
        return self._model_path

    def set_params_file(self, path):
        self._params_file = path

    def set_model(self, prog_file, params_file=None):
        self._model_path = prog_file
        self._params_file = params_file

    # --- place
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        """Run on ``cuda:<device_id>``; raises where no card exists."""
        resolve_device(None)
        self._device = torch.device("cuda", int(device_id))

    def disable_gpu(self):
        self._device = torch.device("cpu")

    def device(self):
        """The `torch.device` the predictor runs on."""
        return self._device

    # --- the reference's knobs, kept for its call sites
    def enable_memory_optim(self, x=True):
        self._memory_optim = x

    def switch_ir_optim(self, x=True):
        self._ir_optim = x

    def set_cpu_math_library_num_threads(self, n):
        self._threads = n

    def enable_tensorrt_engine(self, **kw):
        pass

    def enable_mkldnn(self):
        pass

    def switch_use_feed_fetch_ops(self, x):
        pass

    def switch_specify_input_names(self, x=True):
        pass

    def precision_mode(self):
        return self._precision


def _refuse_bfloat16(dtype, name):
    if dtype == torch.bfloat16:
        raise TypeError(f"{name} is bfloat16, which numpy cannot hold: run "
                        "a bfloat16 program through jit.load's layer on "
                        "device tensors")


class _IOHandle:
    """A named input or output of the predictor (the reference's
    zero-copy tensor): an input holds a host array until `run`, an output
    the program's tensor on the place until `copy_to_cpu`. `dtype` is the
    program's type for it, where known."""

    def __init__(self, name, dtype=None):
        self.name = name
        self._dtype = dtype
        self._value = None      # numpy array (input) or tensor (output)

    def reshape(self, shape):
        _refuse_bfloat16(self._dtype, self.name)
        if self._value is None:
            np_dtype = (torch.empty((), dtype=self._dtype).numpy().dtype
                        if self._dtype is not None else np.float32)
            self._value = np.zeros(shape, np_dtype)
        else:
            self._value = np.resize(self._value, shape)

    def copy_from_cpu(self, arr):
        """Hold `arr` for the next `run`, which copies it to the place."""
        _refuse_bfloat16(self._dtype, self.name)
        self._value = np.asarray(arr)

    def copy_to_cpu(self):
        if isinstance(self._value, torch.Tensor):
            _refuse_bfloat16(self._value.dtype, self.name)
            return self._value.cpu().numpy()
        return np.asarray(self._value)

    def shape(self):
        return list(self._value.shape) if self._value is not None else []

    def type(self):
        if self._value is None:
            return None
        if isinstance(self._value, torch.Tensor):
            return str(self._value.dtype).replace("torch.", "")
        return str(self._value.dtype)


def _user_input_dtypes(program):
    """The dtypes of the program's user inputs, in order."""
    from torch.export.graph_signature import InputKind
    names = [spec.arg.name for spec in program.graph_signature.input_specs
             if spec.kind == InputKind.USER_INPUT]
    vals = {node.name: node.meta.get("val")
            for node in program.graph.nodes if node.op == "placeholder"}
    return [getattr(vals.get(name), "dtype", None) for name in names]


class Predictor:
    """Runs the program of a `jit.save` artifact on the config's place."""

    def __init__(self, config):
        self._config = config
        if config.prog_file() is None:
            raise ValueError("Config has no model path; call set_prog_file")
        art = _jit_load(config.prog_file())
        if not isinstance(art, TranslatedLayer):
            raise ValueError(f"{config.prog_file()} is not a "
                             "paddle_tpu_torch.jit artifact")
        if not art.has_forward:
            err = art.export_error
            raise ValueError("artifact has no compiled forward; re-save with "
                             "input_spec" + (f" (export error: {err})"
                                             if err else ""))
        self._layer = art.to(config.device())
        dtypes = _user_input_dtypes(art.program)
        self._inputs = {f"x{i}": _IOHandle(f"x{i}", dt)
                        for i, dt in enumerate(dtypes)}
        self._outputs = {}

    @property
    def device(self):
        return self._layer.device

    def get_input_names(self):
        return list(self._inputs)

    def get_input_handle(self, name):
        return self._inputs[name]

    def get_output_names(self):
        return list(self._outputs)

    def get_output_handle(self, name):
        return self._outputs[name]

    def run(self, inputs=None):
        """With `inputs` (numpy arrays, one per program input): run and
        return the outputs as numpy arrays. Without: run on the input
        handles' arrays; the outputs wait in the output handles
        (``copy_to_cpu``), and None is returned. Each array is copied to
        the place; the outputs are the program's, so an input the program
        writes in place (a decode step's caches) comes back as an output."""
        if inputs is not None:
            for handle, arr in zip(self._inputs.values(), inputs):
                handle.copy_from_cpu(arr)
        elif any(h._value is None for h in self._inputs.values()):
            raise ValueError("every input handle needs copy_from_cpu "
                             "before run()")
        args = [torch.from_numpy(np.ascontiguousarray(h._value))
                .to(self.device, copy=True) for h in self._inputs.values()]
        out = self._layer(*args)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        self._outputs = {f"out{i}": _IOHandle(f"out{i}")
                         for i in range(len(outs))}
        for handle, t in zip(self._outputs.values(), outs):
            handle._value = t
        if inputs is not None:
            return [h.copy_to_cpu() for h in self._outputs.values()]
        return None

    def clone(self):
        return Predictor(self._config)


def create_predictor(config):
    return Predictor(config)


def get_version():
    from .. import __version__
    return __version__


class DataType:
    """The reference's ``paddle_infer.DataType``."""
    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5
    BFLOAT16 = 6


_DTYPE_BYTES = {DataType.FLOAT32: 4, DataType.INT64: 8, DataType.INT32: 4,
                DataType.UINT8: 1, DataType.INT8: 1, DataType.FLOAT16: 2,
                DataType.BFLOAT16: 2}


def get_num_bytes_of_data_type(dtype):
    return _DTYPE_BYTES[dtype]


def get_trt_compile_version():
    """No TensorRT: the program runs the port's kernels and PyTorch's."""
    return (0, 0, 0)


def get_trt_runtime_version():
    return (0, 0, 0)


def convert_to_mixed_precision(model_file, params_file, mixed_model_file,
                               mixed_params_file, mixed_precision=None,
                               backend=None, keep_io_types=True,
                               black_list=None, **kwargs):
    """The reference's rewrite of a saved model to mixed precision. A
    program saved by `jit.save` fixes its types when it is traced, so
    raise, as the reference does."""
    raise NotImplementedError(
        "a jit.save program fixes its precision when it is traced: cast the "
        "layer (layer.to(torch.bfloat16) or torch.float16) before jit.save "
        "instead of converting the saved file")


class PredictorPool:
    """`size` predictors of one config (the reference's serving worker
    pool). For generation under traffic prefer `serving.LLMEngine`."""

    def __init__(self, config, size=1):
        self._predictors = [create_predictor(config)
                            for _ in range(max(int(size), 1))]

    def retrive(self, idx):
        return self._predictors[idx]

    retrieve = retrive          # the reference spells it "retrive"

    def size(self):
        return len(self._predictors)
