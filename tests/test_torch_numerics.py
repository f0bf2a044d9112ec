"""Port parity: the per-op checks (`ops.numerics`) of ``FLAGS_check_nan_inf``
(strict) and ``FLAGS_check_numerics`` (lazy), against the JAX package's
`_scan_nan_inf` and its guard's forward checks (the reference's
``tests/test_guardian.py::TestGuardianEager``: precedence, the raise at a
flush at level 0, the warning at level 1).

The port's op names are aten's (``mm``, ``gelu``), the reference's
Paddle's (``matmul``); each side is held to raise or warn where the other
does, and the port's message to name its op. The JAX flags are set to
their defaults around each test, and the port's four check flags
cleared.
"""
from __future__ import annotations

import threading
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework import flags as jflags
from paddle_tpu.ops import guardian as jguardian

from paddle_tpu_torch.framework import get_flags, set_flags
from paddle_tpu_torch.ops import guardian, numerics

CHECK_FLAGS = {"FLAGS_check_numerics": False,
               "FLAGS_check_numerics_level": 0,
               "FLAGS_check_nan_inf": False,
               "FLAGS_check_nan_inf_level": 0}


def _reset():
    set_flags(CHECK_FLAGS)
    for g in (guardian, jguardian):
        g.reset_guardian_stats()
        g.reset_thread_state()


@pytest.fixture(autouse=True)
def reference_flags_at_defaults():
    saved = dict(jflags._FLAGS)
    jflags.set_flags({name: default
                      for name, (default, _) in jflags._DEFS.items()})
    jflags.set_flags({"FLAGS_eager_step_fusion": False})
    _reset()
    yield
    _reset()
    jflags.set_flags(saved)


def _both(flags):
    jflags.set_flags(flags)
    set_flags(flags)


def _inputs(nan=True):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    x = np.full((4, 8), np.nan, np.float32) if nan \
        else rng.standard_normal((4, 8)).astype(np.float32)
    return x, w


def _jax_forward(x, w):
    wt = paddle.to_tensor(w, stop_gradient=False)
    JF.gelu(paddle.matmul(paddle.to_tensor(x), wt)).sum().backward()


def _port_forward(x, w):
    wt = torch.nn.Parameter(torch.from_numpy(w))
    torch.nn.functional.gelu(torch.from_numpy(x) @ wt).sum().backward()


def test_the_flags_and_their_defaults():
    assert get_flags(list(CHECK_FLAGS)) == CHECK_FLAGS
    assert {k: jflags._DEFS[k][0] for k in CHECK_FLAGS} == CHECK_FLAGS


def test_strict_mode_takes_precedence():
    for g in (guardian, jguardian):
        assert not g.enabled()
    _both({"FLAGS_check_numerics": True, "FLAGS_check_nan_inf": True})
    assert not guardian.enabled() and not jguardian.enabled()
    _both({"FLAGS_check_nan_inf": False})
    assert guardian.enabled() and jguardian.enabled()


@pytest.mark.parametrize("level", [0, 1])
def test_strict_mode_names_the_op(level):
    x, w = _inputs()
    _both({"FLAGS_check_nan_inf": True, "FLAGS_check_nan_inf_level": level})
    if level == 0:
        with pytest.raises(FloatingPointError,
                           match="Operator 'matmul' output contains"):
            _jax_forward(x, w)
        with pytest.raises(FloatingPointError,
                           match="Operator 'mm' output contains NaN/Inf"):
            _port_forward(x, w)
    else:
        for forward, op in ((_jax_forward, "matmul"), (_port_forward, "mm")):
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                forward(x, w)
            assert any(f"Operator '{op}' output contains NaN/Inf"
                       in str(r.message) for r in rec)
    # nothing is queued in the strict mode
    assert guardian.guardian_stats()["checks_enqueued"] == 0


def test_forward_nonfinite_raises_at_flush():
    x, w = _inputs()
    _both({"FLAGS_check_numerics": True})
    for forward, g in ((_jax_forward, jguardian), (_port_forward, guardian)):
        with pytest.raises(FloatingPointError, match="non-finite"):
            forward(x, w)
            g.flush()
        assert g.guardian_stats()["nonfinite_outputs"] >= 1


def test_forward_nonfinite_warns_at_level1():
    x, w = _inputs()
    _both({"FLAGS_check_numerics": True, "FLAGS_check_numerics_level": 1})
    for forward, g in ((_jax_forward, jguardian), (_port_forward, guardian)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            forward(x, w)
            g.flush()
        assert any("non-finite" in str(r.message) for r in rec)
    assert any("'mm' produced a non-finite output" in str(r.message)
               for r in rec)


def test_finite_forward_queues_and_raises_nothing():
    x, w = _inputs(nan=False)
    set_flags({"FLAGS_check_numerics": True})
    _port_forward(x, w)
    guardian.flush()
    stats = guardian.guardian_stats()
    # mm, gelu and sum at least; the backward's ops are not checked
    assert stats["checks_enqueued"] >= 3 and stats["flushes"] == 1
    assert stats["nonfinite_outputs"] == 0


def test_clearing_the_flag_turns_the_checks_off():
    x, w = _inputs()
    set_flags({"FLAGS_check_nan_inf": True})
    assert numerics.active()
    set_flags({"FLAGS_check_nan_inf": False})
    assert not numerics.active()
    _port_forward(x, w)                       # nothing raises
    assert guardian.guardian_stats()["checks_enqueued"] == 0


def test_the_checks_are_the_setting_threads():
    x, w = _inputs()
    set_flags({"FLAGS_check_nan_inf": True})
    seen = []

    def other():
        seen.append(numerics.active())
        _port_forward(x, w)                   # this thread checks nothing

    thread = threading.Thread(target=other)
    thread.start()
    thread.join()
    assert seen == [False]
    with pytest.raises(FloatingPointError):
        _port_forward(x, w)


def test_suspended_and_unwritten_outputs_are_not_checked():
    set_flags({"FLAGS_check_nan_inf": True})
    with numerics.suspended():
        torch.full((3,), float("nan")) * 2
    torch.empty(1 << 12).view(64, 64)         # unwritten memory, a view
    with pytest.raises(FloatingPointError, match="'mul'"):
        torch.full((3,), 1.0) * float("inf")


def test_kernel_wrappers_check_under_their_names():
    set_flags({"FLAGS_check_nan_inf": True})
    numerics.check("flash_attention_fwd", torch.ones(3))
    with pytest.raises(FloatingPointError, match="'flash_attention_fwd'"):
        numerics.check("flash_attention_fwd", torch.ones(3),
                       torch.tensor([float("nan")]))
    set_flags({"FLAGS_check_nan_inf": False, "FLAGS_check_numerics": True})
    numerics.check("fused_ln", torch.tensor([float("inf")]))
    with pytest.raises(FloatingPointError, match="'fused_ln'"):
        guardian.flush()


def test_a_full_queue_flushes():
    set_flags({"FLAGS_check_numerics": True})
    for _ in range(guardian._MAX_QUEUE + 5):
        guardian.enqueue_fwd("x", torch.tensor(True))
    stats = guardian.guardian_stats()
    assert stats["flushes"] == 1 and not guardian._tls.inflight
    assert len(guardian._tls.queue) == 5
