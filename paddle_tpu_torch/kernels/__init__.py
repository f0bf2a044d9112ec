"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
twin (the version CPU tensors take and the card's checks compare against).

Each kernel module counts its own kernels' launches in a module-level dict
`launches` (``{kernel name: count}``); `launch_counts` /
`reset_launch_counts` read and zero them all. A CUDA graph replay runs no
Python, so no wrapper counts it: `captured_launches` records what a
capture's wrappers counted (and takes it back out, since a capture
launches nothing), and `add_launches` adds that record once per replay.
"""
from __future__ import annotations

from . import (adam_update, cross_entropy, flash_attention, fused_ln,
               keyed_draw, lora_delta, paged_attention, prefill_scatter,
               sampler_filter)

__all__ = ["adam_update", "cross_entropy", "flash_attention", "fused_ln",
           "keyed_draw", "lora_delta", "paged_attention", "prefill_scatter",
           "sampler_filter", "launch_counts",
           "reset_launch_counts", "captured_launches", "add_launches"]

_MODULES = (flash_attention, paged_attention, cross_entropy, fused_ln,
            keyed_draw, sampler_filter, adam_update, prefill_scatter,
            lora_delta)


def launch_counts():
    """``{kernel name: launches}`` for every kernel of the port."""
    return {name: n for mod in _MODULES for name, n in mod.launches.items()}


def reset_launch_counts():
    for mod in _MODULES:
        for name in mod.launches:
            mod.launches[name] = 0


def add_launches(record):
    """Add ``{kernel name: launches}`` to the counts (one graph replay of
    the capture `record` came from)."""
    for mod in _MODULES:
        for name in mod.launches:
            mod.launches[name] += record.get(name, 0)


def captured_launches(capture):
    """Run `capture()`, a CUDA graph capture, and return ``(its result,
    record)``: `record` holds the launches its wrappers counted, ``{kernel
    name: launches}``, which are taken back out of the counts here, since
    a capture only records its kernels. Each replay then runs them once:
    ``add_launches(record)``."""
    before = launch_counts()
    out = capture()
    record = {name: n - before[name] for name, n in launch_counts().items()
              if n != before[name]}
    add_launches({name: -n for name, n in record.items()})
    return out, record
