"""Port parity: training checkpoints (`framework.io.save` / `load`,
`incubate.StepCheckpointer`, `EpochRange`, `train_epoch_range`).

- `save` / `load` round trip nested state (fp32, bf16, int tensors and
  plain values) with every tensor as a CPU copy; a flipped byte, a
  truncated file and a JSON checkpoint read as a tensor one each raise
  `CheckpointCorruptError`.
- A run killed after step 4 of a `StepCheckpointer(save_every_n_steps=2)`
  loop and restored into fresh objects (model, optimizer with its
  schedule, GradScaler, the generator's state) finishes steps 5 to 8 bit
  for bit as the uninterrupted run, and within the usual tolerances of
  the JAX package's uninterrupted run (losses 1e-5; parameters 1e-5, a
  tenth of Adam's lr 1e-4 step, see `test_torch_train.py`).
- A corrupt newest snapshot is skipped for the older one; all corrupt
  refuses; the JAX package's `StepCheckpointer` does the same with its
  own files.
- `EpochRange` resumes after the last completed epoch and re-runs the
  epochs after a corrupt snapshot it skipped.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate import checkpoint as jck
from paddle_tpu.incubate.models import \
    GPTPretrainingCriterion as JGPTPretrainingCriterion
from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch import amp
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.incubate import (EpochRange, StepCheckpointer,
                                       train_epoch_range)
from paddle_tpu_torch.incubate.models import GPTPretrainingCriterion
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import _batch, _jax_params, _pair

LR = 1e-4


def _flip(path, offset=100):
    blob = bytearray(open(path, "rb").read())
    blob[offset] ^= 0x40
    open(path, "wb").write(bytes(blob))


def test_save_load_round_trip_and_corruption(tmp_path):
    state = {"w": torch.randn(3, 4), "h": torch.randn(5).to(torch.bfloat16),
             "ids": torch.arange(6), "nested": {"k": [1, 2.5, None, "s"],
                                                "t": (torch.ones(2),)},
             "step": 7}
    path = tmp_path / "a" / "state.pt"
    io.save(state, path)
    assert not [n for n in os.listdir(path.parent) if ".tmp." in n]
    back = io.load(path)
    assert back["step"] == 7 and back["nested"]["k"] == [1, 2.5, None, "s"]
    for key in ("w", "h", "ids"):
        assert back[key].dtype == state[key].dtype
        assert torch.equal(back[key], state[key])
    assert torch.equal(back["nested"]["t"][0], torch.ones(2))
    _flip(path)
    with pytest.raises(io.CheckpointCorruptError, match="CRC"):
        io.load(path)
    io.save(state, path)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-30])
    with pytest.raises(io.CheckpointCorruptError):
        io.load(path)
    io.save_json({"a": 1}, tmp_path / "j.json")
    with pytest.raises(io.CheckpointCorruptError, match="trailer"):
        io.load(tmp_path / "j.json")


def _objects():
    """A tiny GPT with AdamW under a schedule, its TrainStep, and a
    GradScaler (scaling an fp32 loop by 1: it only has to round trip)."""
    jm, tm = _pair(128, 4)
    sched = tlr.StepDecay(LR, step_size=3, gamma=0.5)
    opt = AdamW(learning_rate=sched, parameters=tm.parameters())
    scaler = amp.GradScaler(init_loss_scaling=1.0, incr_every_n_steps=3)
    return jm, tm, opt, sched, scaler


def _steps(tm, opt, sched, scaler, first, last, ck=None):
    """Steps first..last of an eager GradScaler loop; returns the losses."""
    ids, labels = _batch(128, seed=21)
    x, y = torch.from_numpy(ids), torch.from_numpy(labels)
    crit = GPTPretrainingCriterion()
    losses = []
    for step in range(first, last + 1):
        torch.randn(3)          # the generator moves every step
        loss = crit(tm(x), y)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss.detach()))
        if ck is not None:
            ck.tick(step, model=tm, optimizer=opt, scaler=scaler,
                    extra={"step": step})
    return losses


def test_step_checkpointer_resume_is_the_uninterrupted_run(tmp_path):
    torch.manual_seed(5)
    _, tm, opt, sched, scaler = _objects()
    whole = _steps(tm, opt, sched, scaler, 1, 8)
    after = torch.randn(3)
    # killed after step 4 (snapshots at 2 and 4), restored into fresh
    # objects
    torch.manual_seed(5)
    _, tm1, opt1, sched1, scaler1 = _objects()
    ck = StepCheckpointer(str(tmp_path), save_every_n_steps=2)
    first = _steps(tm1, opt1, sched1, scaler1, 1, 4, ck)
    assert sorted(os.listdir(tmp_path / "default_steps")) == ["step_2",
                                                              "step_4"]
    del tm1, opt1, sched1, scaler1
    torch.manual_seed(99)
    jm, tm2, opt2, sched2, scaler2 = _objects()
    ck2 = StepCheckpointer(str(tmp_path), save_every_n_steps=2)
    assert ck2.restore(model=tm2, optimizer=opt2, scaler=scaler2) == 4
    assert ck2.last_extra == {"step": 4}
    assert opt2._step_count == 4 and sched2.last_epoch == 4
    rest = _steps(tm2, opt2, sched2, scaler2, 5, 8, ck2)
    assert first + rest == whole
    assert torch.equal(torch.randn(3), after)
    for a, b in zip(tm.parameters(), tm2.parameters()):
        assert torch.equal(a, b)
    assert scaler2.state_dict() == scaler.state_dict()
    # the JAX package's uninterrupted run from the same weights and batch
    j_sched = jlr.StepDecay(LR, step_size=3, gamma=0.5)
    jopt = paddle.optimizer.AdamW(learning_rate=j_sched,
                                  parameters=jm.parameters())
    jcrit = JGPTPretrainingCriterion()
    ids, labels = _batch(128, seed=21)
    jx, jy = paddle.to_tensor(ids), paddle.to_tensor(labels)
    j_losses = []
    for _ in range(8):
        loss = jcrit(jm(jx), jy)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        j_sched.step()
        j_losses.append(float(loss))
    np.testing.assert_allclose(whole, j_losses, rtol=1e-5, atol=1e-5)
    want = _jax_params(jm, tm2)
    for name, p in tm2.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-5, err_msg=name)


def test_restore_into_a_built_train_step(tmp_path):
    """A TrainStep that already ran (built) restores its model and
    optimizer in place (the accumulators keep their storage) and goes on
    as the run the snapshot came from."""
    ids, labels = _batch(128, seed=22)
    x, y = torch.from_numpy(ids), torch.from_numpy(labels)
    _, ta, oa, _, _ = _objects()
    step_a = TrainStep(ta, GPTPretrainingCriterion(), oa)
    ck = StepCheckpointer(str(tmp_path), save_every_n_steps=1)
    for i in range(1, 4):
        step_a(x, y)
        ck.tick(i, model=ta, optimizer=oa)
    want = [float(step_a(x, y)) for _ in range(2)]
    _, tb, ob, _, _ = _objects()
    step_b = TrainStep(tb, GPTPretrainingCriterion(), ob)
    step_b(x, y)
    ptrs = [t.data_ptr() for slot in ob._accumulators.values()
            for t in slot.values()] + [p.data_ptr() for p in tb.parameters()]
    assert ck.restore(model=tb, optimizer=ob) == 3
    assert ptrs == [t.data_ptr() for slot in ob._accumulators.values()
                    for t in slot.values()] + [p.data_ptr()
                                               for p in tb.parameters()]
    assert [float(step_b(x, y)) for _ in range(2)] == want
    for a, b in zip(ta.parameters(), tb.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("side", ["torch", "jax"])
def test_restore_skips_corrupt_newest_and_refuses_all_corrupt(tmp_path,
                                                              side):
    """Snapshots at 1, 2, 3; the newest's bytes flipped: restore takes 2.
    Every one flipped: restore raises. The JAX package's checkpointer does
    the same with its own files."""
    if side == "torch":
        _, model, opt, _, _ = _objects()
        ck = StepCheckpointer(str(tmp_path), save_every_n_steps=1)
        corrupt_error = io.CheckpointCorruptError
        kw = dict(model=model, optimizer=opt)
    else:
        model, _ = _pair(128, 4)
        opt = paddle.optimizer.AdamW(learning_rate=LR,
                                     parameters=model.parameters())
        ck = jck.StepCheckpointer(str(tmp_path), save_every_n_steps=1)
        from paddle_tpu.framework.io import CheckpointCorruptError
        corrupt_error = CheckpointCorruptError
        kw = dict(model=model, optimizer=opt)
    for step in (1, 2, 3):
        ck.tick(step, extra={"at": step}, **kw)
    _flip(os.path.join(ck.checkpoint_path(3), ck.CKPT_FILE))
    assert ck.restore(**kw) == 2 and ck.last_extra == {"at": 2}
    for step in (1, 2):
        _flip(os.path.join(ck.checkpoint_path(step), ck.CKPT_FILE))
    with pytest.raises(corrupt_error, match="refusing"):
        ck.restore(**kw)


def test_epoch_range_resumes_and_reruns_after_a_corrupt_snapshot(tmp_path):
    _, model, opt, _, _ = _objects()
    er = train_epoch_range(5, save_dir=str(tmp_path), max_checkpoints=2)
    done = []
    for epoch in er:
        done.append(epoch)
        with torch.no_grad():
            model.gpt.ln_f.bias.fill_(epoch)
        er.save(epoch, model=model, optimizer=opt, extra={"epoch": epoch})
        if epoch == 2:
            break
    assert done == [0, 1, 2]
    assert sorted(os.listdir(tmp_path / "default")) == ["epoch_1",
                                                        "epoch_2"]
    _, fresh, fresh_opt, _, _ = _objects()
    er2 = EpochRange(5, save_dir=str(tmp_path), max_checkpoints=2)
    assert er2.restored_from == 2
    assert er2.restore(model=fresh, optimizer=fresh_opt) == {"epoch": 2}
    assert float(fresh.gpt.ln_f.bias[0]) == 2.0
    assert list(er2) == [3, 4]
    # snapshots of epochs 3 and 4, the newest corrupt: resume from 3 and
    # run 4 again; both corrupt: refuse
    er3 = EpochRange(5, save_dir=str(tmp_path), max_checkpoints=2)
    assert er3.restored_from == 4
    for epoch in (3, 4):
        er3.save(epoch, model=model, optimizer=opt, extra={"epoch": epoch})
    assert sorted(os.listdir(tmp_path / "default")) == ["epoch_3",
                                                        "epoch_4"]
    _flip(os.path.join(er3.checkpoint_path(4), er3.CKPT_FILE))
    er4 = EpochRange(5, save_dir=str(tmp_path), max_checkpoints=2)
    assert er4.restore(model=fresh, optimizer=fresh_opt) == {"epoch": 3}
    assert er4.restored_from == 3 and list(er4) == [4]
    _flip(os.path.join(er4.checkpoint_path(3), er4.CKPT_FILE))
    er5 = EpochRange(5, save_dir=str(tmp_path), max_checkpoints=2)
    with pytest.raises(io.CheckpointCorruptError, match="refusing"):
        er5.restore(model=fresh, optimizer=fresh_opt)
