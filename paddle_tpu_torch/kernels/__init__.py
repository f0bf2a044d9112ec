"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
twin (the version CPU tensors take and the card's checks compare against).

Each kernel module counts its own kernels' launches in a module-level dict
`launches` (``{kernel name: count}``); `launch_counts` /
`reset_launch_counts` read and zero them all. A CUDA graph replay runs no
Python, so no wrapper counts it: `captured_launches` records what a
capture's wrappers counted (and takes it back out, since a capture
launches nothing), and `add_launches` adds that record once per replay.
`warm_up` and `capture_graph` are the port's one way to build a graph
program (the serving engine's decode and prefill programs, `TrainStep`,
`generate`): an eager run on a side stream, then one capture, whose
replay function adds the capture's launches each time it runs.
"""
from __future__ import annotations

import torch

from . import (adam_update, cross_entropy, finite_check, flash_attention,
               fused_ln, keyed_draw, lora_delta, paged_attention,
               prefill_scatter, sampler_filter)

__all__ = ["adam_update", "cross_entropy", "finite_check",
           "flash_attention", "fused_ln", "keyed_draw", "lora_delta",
           "paged_attention", "prefill_scatter", "sampler_filter",
           "launch_counts",
           "reset_launch_counts", "captured_launches", "add_launches",
           "warm_up", "capture_graph"]

_MODULES = (flash_attention, paged_attention, cross_entropy, fused_ln,
            keyed_draw, sampler_filter, adam_update, prefill_scatter,
            lora_delta, finite_check)


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


def warm_up(fn, device=None):
    """Run fn() once on a side stream that starts after the current
    stream's work and that the current stream then waits for: the eager
    run before a capture, which loads cuBLAS and the kernels' modules at
    the capture's shapes. Returns fn's result."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    return out


def capture_graph(fn, pool=None):
    """Capture fn() in a new CUDA graph (in memory pool `pool`, a private
    one when None) and return ``(replay, fn's result)``: each ``replay()``
    runs the graph once and adds the launches its wrappers counted while
    it was captured (`captured_launches`). The capture waits for the
    device first (``torch.cuda.graph``)."""
    graph = torch.cuda.CUDAGraph()

    def capture():
        with torch.cuda.graph(graph, pool=pool):
            return fn()

    out, record = captured_launches(capture)

    def replay():
        graph.replay()
        add_launches(record)

    return replay, out
