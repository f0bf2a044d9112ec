"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
twin (the version CPU tensors take and the card's checks compare against).

Each kernel module counts its own kernels' launches in a module-level dict
`launches` (``{kernel name: count}``); `launch_counts` /
`reset_launch_counts` read and zero them all.
"""
from __future__ import annotations

from . import cross_entropy, flash_attention, fused_ln, paged_attention

__all__ = ["cross_entropy", "flash_attention", "fused_ln", "paged_attention",
           "launch_counts", "reset_launch_counts"]

_MODULES = (flash_attention, paged_attention, cross_entropy, fused_ln)


def launch_counts():
    """``{kernel name: launches}`` for every kernel of the port."""
    return {name: n for mod in _MODULES for name, n in mod.launches.items()}


def reset_launch_counts():
    for mod in _MODULES:
        for name in mod.launches:
            mod.launches[name] = 0
