"""`jit.save` / `jit.load`: a layer saved as weights and, with an input
spec, as a program that runs without the Python code that built it.

Counterpart of `paddle_tpu/jit/api.py` (`InputSpec`, `save`,
`TranslatedLayer`, `load`; `:35-485`), the reference's deploy route: save a
layer, then serve it from an `inference.Predictor`. The reference exports
its forward with `jax.export` (StableHLO); the port exports it with
`torch.export` and keeps the program's own serialization
(`torch.export.save`) inside the artifact. The kernels that a traced
forward reaches are the `torch.library` ops of the port
(``paddle_tpu_torch::flash_attention_fwd`` and ``::fused_ln_fwd``), so the
saved program replays the hand-written kernels on the card. Any other
kernel wrapper raises when a trace reaches it (`device.require_hopper`),
and the save then keeps the weights and the export's error.

The artifact is one file in `framework.io.save`'s format (atomic, CRC
trailer): a dict with ``format`` and ``version`` (the reference's) and
``class_name``; where an input spec was given and the export succeeded,
``program`` (the `torch.export.save` bytes, which hold the weights),
``export_state_keys`` (the program's parameters and buffers by state-dict
key) and ``n_buffer_outputs`` (the buffers the program writes); else
``state_dict``, and ``export_error`` where the export failed. The weights
are stored once: `TranslatedLayer.state_dict` reads them from the program
where there is one.
"""
from __future__ import annotations

import io
import os
import warnings

import numpy as np
import torch
from torch import nn

from ..framework import io as _io

__all__ = ["InputSpec", "save", "load", "TranslatedLayer"]

FORMAT = "paddle_tpu_torch.jit"
VERSION = 1

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}


def _to_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise TypeError(f"InputSpec dtype {dtype!r} is none of "
                        f"{sorted(_DTYPES)}") from None


class InputSpec:
    """One input of the saved forward: a concrete `shape` (the exported
    program takes exactly it, as `jax.export` did in the reference), a
    `dtype` (a name such as ``"int64"`` or a `torch.dtype`) and an optional
    `name`."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = _to_dtype(dtype)
        self.name = name

    def example(self, device):
        """Zeros of this spec on `device`: the export's example input."""
        return torch.zeros(self.shape, dtype=self.dtype, device=device)

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"


def _layer_device(layer):
    """The device of the layer's first parameter or buffer (the CPU for a
    layer with none)."""
    for t in (*layer.parameters(), *layer.buffers()):
        return t.device
    return torch.device("cpu")


def _artifact_path(path):
    """`path`, with ``.pdmodel`` added where its last component has no
    suffix (the reference's rule)."""
    path = os.fspath(path)
    if path.endswith(".pdmodel") or "." in os.path.basename(path):
        return path
    return path + ".pdmodel"


def _export(layer, input_spec):
    """The payload entries of `layer`'s forward exported at `input_spec`:
    under `torch.no_grad()`, on the layer's device, zeros as the example
    inputs."""
    device = _layer_device(layer)
    example = tuple(spec.example(device) for spec in input_spec)
    with torch.no_grad():
        program = torch.export.export(layer, example)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    sig = program.graph_signature
    return {"program": buf.getvalue(),
            "export_state_keys": list(sig.parameters) + list(sig.buffers),
            "n_buffer_outputs": len(sig.buffers_to_mutate)}


def save(layer, path, input_spec=None):
    """Save `layer` (an `nn.Module`) to `path` (``.pdmodel`` added where
    the name has no suffix): its state dict and, with `input_spec` (a list
    of `InputSpec`, one per forward argument), its forward as a program
    exported by `torch.export` at those shapes. Returns the path written.

    The trace runs Python once, so what Python decides is fixed in the
    program: the layer's training flag, ``framework.set_flags`` routes
    (``FLAGS_use_flash_attention`` picks the flash kernel or the plain
    attention when traced), `amp.auto_cast`'s casts and the numeric checks'
    mode as they stand at the save; the devices that the forward names
    (``torch.arange(..., device=...)``) are the layer's. Cast the layer
    (``.to(torch.bfloat16)``) and set its mode before saving. As in the
    reference, an export that fails leaves the forward out: the file keeps
    the weights and the error (``export_error``, shown when the loaded
    layer is called), and a warning names it."""
    if not isinstance(layer, nn.Module):
        raise TypeError(f"jit.save takes an nn.Module, got "
                        f"{type(layer).__name__}")
    payload = {"format": FORMAT, "version": VERSION,
               "class_name": type(layer).__name__}
    if input_spec:
        try:
            payload.update(_export(layer, input_spec))
        except Exception as e:   # the reference's rule: keep the weights
            payload["export_error"] = repr(e)
            warnings.warn(f"jit.save: the forward of "
                          f"{type(layer).__name__} was not exported, only "
                          f"its weights are saved: {e!r}")
    if "program" not in payload:
        payload["state_dict"] = layer.state_dict()
    return _io.save(payload, _artifact_path(path))


def _program_device(program):
    """The one device of the program's parameters, buffers and inputs (a
    constant may be a CPU scalar, which any device's ops take)."""
    from torch.export.graph_signature import InputKind
    kinds = (InputKind.PARAMETER, InputKind.BUFFER, InputKind.USER_INPUT)
    names = {spec.arg.name for spec in program.graph_signature.input_specs
             if spec.kind in kinds}
    devices = set()
    for node in program.graph.nodes:
        val = node.meta.get("val") if node.name in names else None
        if isinstance(val, torch.Tensor):
            devices.add(val.device)
    if len(devices) > 1:
        raise RuntimeError(f"the saved program spans devices "
                           f"{sorted(map(str, devices))}")
    return devices.pop() if devices else torch.device("cpu")


class TranslatedLayer:
    """What `load` returns: the saved weights (`state_dict`) and, where the
    artifact holds a program (`has_forward`), a callable that runs it. No
    Python of the saved layer's class runs: the program alone computes the
    forward. Inference only (`train` raises)."""

    def __init__(self, payload):
        self._payload = payload
        self._program = None
        self._module = None
        self.device = None      # the program's device, once there is one
        blob = payload.get("program")
        if blob is not None:
            # the kernels' op registrations, which the program names
            from ..kernels import flash_attention, fused_ln  # noqa: F401
            self._set_program(torch.export.load(io.BytesIO(blob)))

    def _set_program(self, program):
        self._program = program
        self._module = program.module()
        self.device = _program_device(program)

    @property
    def has_forward(self):
        return self._program is not None

    @property
    def export_error(self):
        """Why the save exported no forward, or None."""
        return self._payload.get("export_error")

    @property
    def program(self):
        """The `torch.export.ExportedProgram`, or None."""
        return self._program

    def state_dict(self):
        """The weights by state-dict key: the program's parameters and
        persistent buffers where there is a program (they are what it
        runs, `set_state` included), else the saved state dict."""
        if self._program is None:
            return dict(self._payload.get("state_dict", {}))
        slots = self._slots()
        return {k: slots[k] for k in self._payload["export_state_keys"]
                if k in self._program.state_dict}

    def _slots(self):
        """The program module's parameters and buffers by state-dict key."""
        slots = dict(self._module.named_parameters(remove_duplicate=False))
        slots.update(self._module.named_buffers(remove_duplicate=False))
        return slots

    def set_state(self, state):
        """Copy `state` (``{state-dict key: tensor}``) into the program's
        parameters and buffers, by the keys the save recorded
        (``export_state_keys``): re-arms the program with other weights of
        the same shapes. KeyError where a key is missing."""
        if self._program is None:
            raise RuntimeError("this artifact holds no program to arm")
        keys = self._payload["export_state_keys"]
        missing = [k for k in keys if k not in state]
        if missing:
            raise KeyError(f"state lacks the program's slots {missing}")
        targets = self._slots()
        with torch.no_grad():
            for key in keys:
                targets[key].copy_(torch.as_tensor(state[key]))

    def to(self, device):
        """Move the program to `device`, in place
        (`torch.export.passes.move_to_device_pass`: its weights, constants
        and the devices its graph names); returns self. Raises where the
        pass cannot move it."""
        device = torch.device(device)
        if self._program is None or _same_device(self.device, device):
            return self
        from torch.export.passes import move_to_device_pass
        source = self.device
        self._set_program(move_to_device_pass(self._program, device))
        if not _same_device(self.device, device):
            raise RuntimeError(f"the saved program could not be moved from "
                               f"{source} to {device}")
        return self

    def __call__(self, *args):
        """Run the program on `args` (tensors, or arrays, which are
        copied), each moved to the program's device; returns its outputs
        there. An input the program writes in place (a decode step's
        caches) is written in the tensor it runs on: the caller's, where
        that is on the program's device already."""
        if self._program is None:
            err = self.export_error
            raise RuntimeError(
                "this artifact was saved without input_spec so no compiled "
                "forward is attached" + (f" (export error: {err})" if err
                                         else ""))
        inputs = [(a if isinstance(a, torch.Tensor)
                   else torch.tensor(np.asarray(a))).to(self.device)
                  for a in args]
        with torch.no_grad():
            return self._module(*inputs)

    def eval(self):
        return self

    def train(self):
        raise RuntimeError("TranslatedLayer is inference-only; rebuild the "
                           "layer and load_state_dict to fine-tune")


def _same_device(a, b):
    """Whether devices `a` and `b` are one (``cuda`` is ``cuda:0``)."""
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def load(path):
    """The artifact `save` wrote at `path` (or at ``path + ".pdmodel"``) as
    a `TranslatedLayer`; a file of another kind, the object it holds."""
    path = os.fspath(path)
    if not os.path.exists(path) and os.path.exists(path + ".pdmodel"):
        path += ".pdmodel"
    payload = _io.load(path)
    if isinstance(payload, dict) and payload.get("format") == FORMAT:
        return TranslatedLayer(payload)
    return payload
