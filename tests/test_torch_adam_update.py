"""Port parity: the multi-tensor Adam / AdamW update against the reference's
jitted batch update.

The same numpy parameters and gradients (numels that are not multiples of
8, one of more than a kernel chunk) go through
`paddle_tpu`'s ``Optimizer._apply_optimize`` (one `jax.jit` over the whole
list) and the port's (one `kernels.adam_update.adam_update` call a dtype
group; the plain twin, since the tensors lie on the CPU) for 3 steps,
with lr from a scheduler stepped between them: Adam and AdamW, fp32 and
bf16 parameters, ``multi_precision`` on and off, AdamW with a decay-skip
set. The port's parameters and accumulators keep their storage from step
to step (a CUDA graph holds their addresses).

Tolerances. The port rounds every product; XLA on the CPU contracts some
into fused multiply-adds (``b1 * m1 + (1 - b1) * g``, ``base * keep -
step``), so values differ by a few fp32 ulps: moments rtol 1e-6 / atol
1e-9. An fp32 parameter or master near 0 also carries its step's
absolute error, lr_t * |dm1| / sqrt(m2): m1's few ulps (~7e-10 at m1 ~
1e-3) over sqrt(m2) ~ 5e-4, times lr_t <= 3e-3, is ~3e-9 here, so fp32
parameters and masters take rtol 1e-6 / atol 1e-8. A bf16 parameter
takes rtol 2^-8 (the fp32 value rounded once to bf16 on each side).
Beside the twin, `chunk_plan` (the kernel's split of the list into CTAs)
is checked to give every element to exactly one CTA.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor as JTensor
from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch.kernels import adam_update as au
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as tlr

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [(7, 13), (768,), (5,), (3, 4, 5), (1,), (2, 8195), (16, 8)]
# AdamW's decay-skip set: these names do not decay
SKIP = {"w1", "w4"}
STEPS = 3
FP32_TOL = dict(rtol=1e-6, atol=1e-9)
FP32_PARAM_TOL = dict(rtol=1e-6, atol=1e-8)
BF16_RTOL = 2 ** -8


def _sched(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-2, T_max=6),
                            warmup_steps=2, start_lr=1e-3, end_lr=1e-2)


def _numpy_state(seed):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * 1e-2).astype(np.float32)
              for s in SHAPES] for _ in range(STEPS)]
    return params, grads


def _pair(kind, dtype, multi_precision):
    params, grads = _numpy_state(seed=11)
    names = [f"w{i}" for i in range(len(SHAPES))]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jps = [paddle.nn.Parameter(jnp.asarray(x).astype(jdt), name=n)
           for x, n in zip(params, names)]
    # copies: the port updates in place, and JAX on the CPU may alias a
    # numpy array's memory and read it after its call has returned
    tps = [torch.nn.Parameter(torch.tensor(x, dtype=dtype)) for x in params]
    j_sched, t_sched = _sched(jlr), _sched(tlr)
    kw = dict(multi_precision=multi_precision)
    if kind == "adamw":
        jopt = paddle.optimizer.AdamW(
            learning_rate=j_sched, parameters=jps, weight_decay=0.05,
            apply_decay_param_fun=lambda n: n not in SKIP, **kw)
        topt = AdamW(learning_rate=t_sched,
                     parameters=list(zip(names, tps)), weight_decay=0.05,
                     apply_decay_param_fun=lambda n: n not in SKIP, **kw)
    else:
        jopt = paddle.optimizer.Adam(learning_rate=j_sched, parameters=jps,
                                     **kw)
        topt = Adam(learning_rate=t_sched, parameters=tps, **kw)
    return (jps, jopt, j_sched), (tps, topt, t_sched), grads, jdt


def _storage(tps, topt):
    return [p.data_ptr() for p in tps] + [
        slot[p].data_ptr() for slot in topt._accumulators.values()
        for p in tps if p in slot]


def _compare(tps, topt, jps, jopt, dtype):
    for tp, jp in zip(tps, jps):
        got = tp.detach().float().numpy()
        want = np.asarray(jp._value.astype(jnp.float32))
        if dtype == torch.bfloat16:
            np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=0,
                                       err_msg=jp.name)
        else:
            np.testing.assert_allclose(got, want, **FP32_PARAM_TOL,
                                       err_msg=jp.name)
        for name, slot in topt._accumulators.items():
            if tp not in slot:
                assert jp.name not in jopt._accumulators.get(name, {})
                continue
            assert slot[tp].dtype == torch.float32
            tol = FP32_PARAM_TOL if name == "master_weight" else FP32_TOL
            np.testing.assert_allclose(
                slot[tp].numpy(),
                np.asarray(jopt._accumulators[name][jp.name]), **tol,
                err_msg=f"{jp.name} {name}")


@pytest.mark.parametrize("multi_precision", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_update_matches_jax_batch_update(kind, dtype, multi_precision):
    (jps, jopt, j_sched), (tps, topt, t_sched), grads, jdt = _pair(
        kind, dtype, multi_precision)
    storage = None
    for step in range(STEPS):
        jopt._create_accumulators(jps)
        jopt._apply_optimize([(p, JTensor(jnp.asarray(g).astype(jdt)))
                              for p, g in zip(jps, grads[step])])
        topt._apply_optimize([(p, torch.from_numpy(g).to(dtype))
                              for p, g in zip(tps, grads[step])])
        _compare(tps, topt, jps, jopt, dtype)
        assert topt._step_count == jopt._step_count == step + 1
        if storage is None:
            storage = _storage(tps, topt)
        assert _storage(tps, topt) == storage
        j_sched.step()
        t_sched.step()
    masters = topt._accumulators.get("master_weight", {})
    assert len(masters) == (len(tps) if multi_precision
                            and dtype == torch.bfloat16 else 0)


def test_decay_skip_set_is_honoured():
    """With a large coefficient the skipped tensors move by Adam's step
    alone and the others also shrink, on both sides alike."""
    (jps, jopt, _), (tps, topt, _), grads, jdt = _pair(
        "adamw", torch.float32, False)
    jopt._coeff = topt._coeff = 5.0
    before = [p.detach().clone() for p in tps]
    jopt._create_accumulators(jps)
    jopt._apply_optimize([(p, JTensor(jnp.asarray(g)))
                          for p, g in zip(jps, grads[0])])
    topt._apply_optimize([(p, torch.from_numpy(g))
                          for p, g in zip(tps, grads[0])])
    _compare(tps, topt, jps, jopt, torch.float32)
    lr = 1e-3                                 # the warm-up's first lr
    for i, (p, b) in enumerate(zip(tps, before)):
        shrink = float((p.detach().abs().sum() / b.abs().sum()))
        if f"w{i}" in SKIP:
            assert shrink > 1 - 2 * lr, i
        else:
            assert shrink < 1 - 4 * lr, i


def test_twin_is_the_per_tensor_rule():
    """`adam_update_reference` over a list equals `_single_update` tensor
    by tensor (the readable rule), bit for bit."""
    params, grads = _numpy_state(seed=12)
    tps = [torch.from_numpy(x).to(torch.bfloat16) for x in params]
    opt = AdamW(learning_rate=3e-3, parameters=[
        (f"w{i}", p) for i, p in enumerate(tps)], weight_decay=0.1,
        apply_decay_param_fun=lambda n: n not in SKIP, multi_precision=True)
    gs = [torch.from_numpy(g).to(torch.bfloat16) for g in grads[0]]
    opt._create_accumulators(tps)
    accs = {p: {n: slot[p].clone() for n, slot in opt._accumulators.items()}
            for p in tps}
    want = [opt._single_update(p, g, accs[p], 3e-3, 1)
            for p, g in zip(tps, gs)]
    opt._apply_optimize(list(zip(tps, gs)))
    for p, (new_p, new_accs) in zip(tps, want):
        assert torch.equal(p, new_p)
        for name, value in new_accs.items():
            assert torch.equal(opt._accumulators[name][p], value)


@pytest.mark.parametrize("numels", [[1], [16384], [16385, 1, 7],
                                    [0, 5, 0, 40000, 16383]])
def test_chunk_plan_covers_every_element_once(numels):
    """Each CTA finds its tensor by the kernel's search (the last tensor
    whose first chunk is at or before it; empty tensors are dropped first,
    as the wrapper does) and takes CHUNK elements from its offset."""
    live = [n for n in numels if n]
    first = au.chunk_plan(live)
    seen = [np.zeros(n, np.int64) for n in live]
    for cta in range(first[-1]):
        i = max(k for k in range(len(live)) if first[k] <= cta)
        start = (cta - first[i]) * au.CHUNK
        seen[i][start:min(start + au.CHUNK, live[i])] += 1
    assert all((s == 1).all() for s in seen)


def test_update_bytes_counts_each_access_once():
    p32, p16 = torch.zeros(10), torch.zeros(10, dtype=torch.bfloat16)
    # g, m1, m2 in and out, the master or p as the base, p out
    assert au.update_bytes([p32], [None]) == 10 * (4 + 8 + 8 + 4 + 4)
    assert au.update_bytes([p16], [torch.zeros(10)]) == 10 * 28
    assert au.update_bytes([p16], [None]) == 10 * 22
