"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
twin (the version CPU tensors take and the card's checks compare against).

Each wrapper counts its own kernel launches in a module-level integer
`launches`; `launch_counts` / `reset_launch_counts` read and zero them all.
"""
from __future__ import annotations

from . import flash_attention, paged_attention

__all__ = ["flash_attention", "paged_attention", "launch_counts",
           "reset_launch_counts"]

_MODULES = {"flash_attention_fwd": flash_attention,
            "paged_decode": paged_attention}


def launch_counts():
    """``{kernel name: launches}`` for every kernel of the port."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts():
    for mod in _MODULES.values():
        mod.launches = 0
