"""The one type code every kernel's C entry takes.

Each source in ``csrc/`` instantiates its kernels per element type and
picks the instantiation by an int: 0 float32, 1 bfloat16, 2 float16 (and,
for the pools of the paged decode, 3 int8; for the numeric guard's
finite-check kernels, which also see float64 gradients and state, 4
float64). A code that a source does not
instantiate returns an error from its C entry, so a tensor never reaches
an instantiation of another type. Every wrapper takes its code from
`dtype_code`; tests/test_torch_float16_codes.py holds each wrapper to it.
"""
from __future__ import annotations

import torch

__all__ = ["CODES", "INT8", "FLOAT64", "FLOAT_DTYPES", "SHORT_NAMES",
           "dtype_code", "pool_code", "wide_code"]

CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
INT8 = 3
FLOAT64 = 4
FLOAT_DTYPES = tuple(CODES)
# the float types' short names in launch counters (``..._to_fp16``)
SHORT_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16",
               torch.float16: "fp16"}


def dtype_code(dtype):
    """The C entries' code of float type `dtype`; TypeError for another."""
    try:
        return CODES[dtype]
    except KeyError:
        raise TypeError(f"no kernel instantiation for {dtype}; the kernels "
                        f"take {FLOAT_DTYPES}") from None


def pool_code(dtype):
    """The paged decode's code of its pools' type: a float code, or INT8."""
    return INT8 if dtype == torch.int8 else dtype_code(dtype)


def wide_code(dtype):
    """The finite-check kernels' code of `dtype`: a float code, or
    FLOAT64; TypeError for another."""
    return FLOAT64 if dtype == torch.float64 else dtype_code(dtype)
