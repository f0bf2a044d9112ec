"""Flash attention forward: the Hopper kernel and its plain PyTorch twin.

Counterpart of `paddle_tpu/kernels/flash_attention.py` (`_fwd_kernel`,
`_flash_fwd`). `flash_attention_fwd` takes q, k, v in the JAX package's
``[B, N, H, D]`` layout and returns ``(out [B, N, H, D], lse [B*H, N]
float32)``. On CUDA tensors it launches ``csrc/flash_attention_fwd.cu``
(or raises on what that kernel does not take); on CPU tensors it runs
`flash_attention_reference`, the same arithmetic in plain PyTorch.

Unlike the TPU kernel, no minimum length or multiple-of-128 rule applies:
the CUDA kernel masks its own ragged edges, so every prefill bucket (8 to
1024 tokens) runs it. The causal mask is top-left aligned, as on the TPU,
so causal attention requires ``n == m``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..device import require_hopper
from . import _build

__all__ = ["flash_attention_fwd", "flash_attention_reference", "launches",
           "HEAD_DIMS", "DTYPES"]

HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
_NEG_INF = -1e30

# kernel launches since import (or the last reset by the caller)
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _check(q, k, v, causal):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash attention takes [B, N, H, D] q, k, v")
    b, n, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d) or v.shape != k.shape:
        raise ValueError(f"mismatched shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if causal and k.shape[1] != n:
        raise ValueError("causal flash attention is top-left aligned and "
                         f"needs n == m, got n={n}, m={k.shape[1]}")
    if n == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")


def flash_attention_reference(q, k, v, causal, scale=None):
    """Plain PyTorch twin of the kernel: fp32 scores, top-left causal mask,
    fp32 softmax and logsumexp; out in q's dtype."""
    _check(q, k, v, causal)
    b, n, h, d = q.shape
    m = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qt = q.transpose(1, 2).float() * scale          # [B, H, N, D]
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2).float()
    s = qt @ kt.transpose(-1, -2)                   # [B, H, N, M]
    if causal:
        keep = torch.ones(n, m, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                # [B, H, N]
    p = torch.exp(s - lse[..., None])
    out = (p @ vt).transpose(1, 2).to(q.dtype)      # [B, N, H, D]
    return out.contiguous(), lse.reshape(b * h, n)


def flash_attention_fwd(q, k, v, causal, scale=None):
    """FlashAttention-2 forward over ``[B, N, H, D]`` q, k, v. Returns
    ``(out [B, N, H, D] in q's dtype, lse [B*H, N] float32)``."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    global launches
    _check(q, k, v, causal)
    b, n, h, d = q.shape
    m = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes {DTYPES} (all alike), got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash kernel needs a contiguous head dimension")
    if b * h > 65535:
        raise ValueError(f"batch * heads = {b * h} exceeds the grid limit")
    require_hopper(q)
    lib = _build.load("flash_attention_fwd")
    fn = lib.paddle_flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
                 ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                 ctypes.c_void_p(lse.data_ptr()), b, n, m, h, d,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 float(scale), int(bool(causal)),
                 0 if q.dtype == torch.float32 else 1,
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    launches += 1
    return out, lse
