"""Layer containers, PyTorch port.

Counterpart of part of `paddle_tpu/nn/layer/container.py`: `Sequential`
and `LayerList` as torch's `nn.Sequential` / `nn.ModuleList`, which name
their children ``"0"``, ``"1"``, ... as the reference's do, so state
names match. `Sequential` also takes the reference's ``(name, layer)``
pairs, as arguments or as one list of them.
"""
from __future__ import annotations

from collections import OrderedDict

from torch import nn

__all__ = ["Sequential", "LayerList"]


class Sequential(nn.Sequential):
    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], tuple):
            layers = tuple(layers[0])
        if layers and all(isinstance(item, tuple) for item in layers):
            super().__init__(OrderedDict(layers))
        else:
            super().__init__(*layers)


class LayerList(nn.ModuleList):
    pass
