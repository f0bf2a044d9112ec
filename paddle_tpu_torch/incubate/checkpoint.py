"""Crash-resumable training and serving state: rolling, atomic,
CRC-checked snapshots.

Counterpart of `paddle_tpu/incubate/checkpoint.py`: `EpochRange` (with
`train_epoch_range`), `StepCheckpointer` and `ServeCheckpointer` on the
shared `_RollingStore`.

Training snapshots (`EpochRange.save`, `StepCheckpointer.save`) hold the
model's state dict, the optimizer's (accumulators, step count, LR
schedule), the `amp.GradScaler`'s (loss scale, good and bad steps), the
torch generators' states (the CPU's, and each CUDA device's once CUDA is
initialised) and a caller's ``extra``; they go through `framework.io.save`
(tensors as CPU copies, atomic, CRC trailer). A restore copies the state
into the objects given, in place (`load_state_dict`, `set_state_dict`),
so a `jit.TrainStep` graph built before the restore replays from it.

The serving payload is the engine's `state_payload()` (the reference's
dict: prompts, emitted tokens, arrival order, remaining TTLs, the adapter
and sampler identity, never the KV pool, which re-prefills
token-identically on resume), so a snapshot is a few KB of host data and a
`tick()` every engine step is affordable. A killed server restarts,
`restore()`s the newest intact snapshot and feeds it to
`engine.restore_state()`; every in-flight stream finishes
byte-identically. Those files are JSON (`framework.io.save_json`).

Every restore skips a snapshot that fails its integrity check for the next
older one, and refuses (`CheckpointCorruptError`) where snapshots exist
but none is intact. These classes save synchronously, as the reference's
do; `framework.io.async_save` writes the same format on a writer thread
for a caller that overlaps the write with its next steps, and its
files load through `framework.io.load` like theirs.
"""
from __future__ import annotations

import os
import re
import shutil
import time

import torch

from ..framework import io as _io

__all__ = ["train_epoch_range", "EpochRange", "StepCheckpointer",
           "ServeCheckpointer", "CheckpointCorruptError"]

CheckpointCorruptError = _io.CheckpointCorruptError

TRAIN_FILE = "state.pt"


def _rng_state():
    state = {"cpu": torch.get_rng_state()}
    if torch.cuda.is_initialized():
        state["cuda"] = torch.cuda.get_rng_state_all()
    return state


def _set_rng_state(state):
    torch.set_rng_state(state["cpu"])
    if "cuda" in state and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(state["cuda"])


def _model_state(model):
    if model is None:
        return None
    if hasattr(model, "state_dict"):
        return model.state_dict()
    return dict(model)


@torch.no_grad()
def _load_model_state(model, state):
    if model is None or state is None:
        return
    if hasattr(model, "load_state_dict"):
        model.load_state_dict(state)
        return
    # a mapping of name -> tensor: copy into the caller's tensors
    for name, t in model.items():
        t.copy_(state[name])


def _snapshot_payload(model, optimizer, scaler, extra):
    """One resumable training snapshot, the reference's keys: the model,
    the optimizer (accumulators, step count, LR schedule), the GradScaler,
    the generators' states and `extra`."""
    return {
        "model": _model_state(model),
        "optimizer": None if optimizer is None else optimizer.state_dict(),
        "scaler": None if scaler is None else scaler.state_dict(),
        "rng": _rng_state(),
        "extra": extra,
    }


def _apply_payload(payload, model, optimizer, scaler):
    _load_model_state(model, payload.get("model"))
    if optimizer is not None and payload.get("optimizer") is not None:
        optimizer.set_state_dict(payload["optimizer"])
    if scaler is not None and payload.get("scaler") is not None:
        scaler.load_state_dict(payload["scaler"])
    if payload.get("rng") is not None:
        _set_rng_state(payload["rng"])


class _RollingStore:
    """Numbered snapshots in ``<save_dir>/<run_id>_<suffix>/<prefix>_<n>/``,
    the newest `max_checkpoints` kept, a newest-first restore scan that
    skips corrupt snapshots and refuses when none survives."""

    CKPT_FILE = "state.json"
    _DIR_SUFFIX = ""
    _ITEM_PREFIX = ""
    _REFUSAL = ""
    _write = staticmethod(_io.save_json)
    _read = staticmethod(_io.load_json)

    def __init__(self, save_dir, save_every_n_steps, run_id,
                 max_checkpoints):
        self.save_dir = save_dir
        self.save_every_n_steps = max(1, int(save_every_n_steps))
        self.max_checkpoints = max(1, int(max_checkpoints or 1))
        self.run_id = run_id or os.environ.get("PADDLE_JOB_ID", "default")

    def _base(self):
        return os.path.join(self.save_dir,
                            f"{self.run_id}_{self._DIR_SUFFIX}")

    def checkpoint_path(self, step):
        return os.path.join(self._base(), f"{self._ITEM_PREFIX}_{step}")

    def _retained(self):
        base = self._base()
        if not os.path.isdir(base):
            return []
        out = []
        for name in os.listdir(base):
            m = re.fullmatch(rf"{self._ITEM_PREFIX}_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _on_grid(self, step):
        return int(step) % self.save_every_n_steps == 0

    def _save_numbered(self, step, payload):
        """Atomic snapshot at `step`, then prune beyond the newest
        `max_checkpoints`. Returns the snapshot's directory."""
        d = self.checkpoint_path(int(step))
        self._write(payload, os.path.join(d, self.CKPT_FILE))
        for s in self._retained()[:-self.max_checkpoints]:
            shutil.rmtree(self.checkpoint_path(s), ignore_errors=True)
        return d

    def _restore_scan(self):
        """``(step, payload)`` of the newest intact snapshot, or None when
        there is none; raises `CheckpointCorruptError` when snapshots
        exist but every one fails its integrity check."""
        corrupt = []
        for s in reversed(self._retained()):
            path = os.path.join(self.checkpoint_path(s), self.CKPT_FILE)
            if not os.path.exists(path):
                continue
            try:
                return s, self._read(path)
            except CheckpointCorruptError:
                corrupt.append(path)
        if corrupt:
            raise CheckpointCorruptError(
                f"every retained {self._ITEM_PREFIX} checkpoint failed its "
                f"integrity check ({', '.join(corrupt)}); {self._REFUSAL}")
        return None


class StepCheckpointer(_RollingStore):
    """Step-granular training snapshots every `save_every_n_steps` steps.

    Usage::

        ck = StepCheckpointer(".ckpt", save_every_n_steps=200)
        start = ck.restore(model=model, optimizer=opt, scaler=scaler)
        for step in range(start + 1, total + 1):
            train_step(batch)
            ck.tick(step, model=model, optimizer=opt, scaler=scaler)

    `tick(step)` saves only on the grid (a no-op otherwise); `restore()`
    loads the newest intact snapshot into the objects given and returns
    the step it was taken at (-1 for a fresh run), the saved ``extra`` in
    `last_extra`.
    """

    CKPT_FILE = TRAIN_FILE
    _DIR_SUFFIX = "steps"
    _ITEM_PREFIX = "step"
    _REFUSAL = ("refusing to resume on uninitialised state: delete the "
                "step_* directories to restart from scratch")
    _write = staticmethod(_io.save)
    _read = staticmethod(_io.load)

    def __init__(self, save_dir, save_every_n_steps=100, run_id=None,
                 max_checkpoints=3):
        super().__init__(save_dir, save_every_n_steps, run_id,
                         max_checkpoints)
        self.last_extra = None

    def tick(self, step, model=None, optimizer=None, scaler=None,
             extra=None):
        """Save when `step` lands on the grid, else return None without
        touching the file system."""
        if not self._on_grid(step):
            return None
        return self.save(step, model=model, optimizer=optimizer,
                         scaler=scaler, extra=extra)

    def save(self, step, model=None, optimizer=None, scaler=None,
             extra=None):
        """Unconditional atomic snapshot at `step`; prunes beyond the
        newest `max_checkpoints`. Returns the snapshot's directory."""
        payload = _snapshot_payload(model, optimizer, scaler, extra)
        payload["step"] = int(step)
        return self._save_numbered(step, payload)

    def restore(self, model=None, optimizer=None, scaler=None):
        """Load the newest intact snapshot into the objects given; returns
        its step, or -1 when there is none."""
        found = self._restore_scan()
        if found is None:
            return -1
        s, payload = found
        _apply_payload(payload, model, optimizer, scaler)
        self.last_extra = payload.get("extra")
        return int(payload.get("step", s))


class EpochRange:
    """Iterate epochs ``[0, max_epoch_num)``, resuming after the last one
    completed.

    Usage::

        er = train_epoch_range(10, save_dir=".auto_ckpt")
        er.restore(model=model, optimizer=opt, scaler=scaler)
        for epoch in er:
            train_one_epoch(...)
            er.save(epoch, model=model, optimizer=opt, scaler=scaler)

    Progress is a marker file ``range_<run_id>.json`` (`framework.io`'s
    JSON with a CRC trailer; one that does not load counts as a fresh
    run, as the reference's unreadable marker does); `save()` writes one
    snapshot an epoch under ``<save_dir>/<run_id>/epoch_<n>/``, the newest
    `max_checkpoints` kept; `restore()` loads the newest intact one at or
    below the last completed epoch, falling back past corrupt ones (and
    re-running the epochs after the one it loaded), and refuses where
    every one is corrupt.
    """

    CKPT_FILE = TRAIN_FILE

    def __init__(self, max_epoch_num, save_dir=None, run_id=None,
                 save_checkpoint_inter=1, max_checkpoints=3):
        self.max_epoch_num = max_epoch_num
        self.save_checkpoint_inter = max(1, int(save_checkpoint_inter or 1))
        self.max_checkpoints = max(1, int(max_checkpoints or 1))
        self.save_dir = save_dir or os.environ.get(
            "PADDLE_TPU_AUTO_CKPT_DIR", ".auto_checkpoint")
        self.run_id = run_id or os.environ.get("PADDLE_JOB_ID", "default")
        self._meta_path = os.path.join(self.save_dir,
                                       f"range_{self.run_id}.json")
        self._completed = -1
        if os.path.exists(self._meta_path):
            try:
                meta = _io.load_json(self._meta_path)
                if meta.get("max_epoch_num") == max_epoch_num:
                    self._completed = int(meta.get("completed_epoch", -1))
            except (CheckpointCorruptError, OSError):
                pass

    @property
    def restored_from(self):
        """The last completed epoch (-1: a fresh run)."""
        return self._completed

    def _mark(self, epoch):
        _io.save_json({"run_id": self.run_id,
                       "max_epoch_num": self.max_epoch_num,
                       "completed_epoch": epoch,
                       "timestamp": time.time()}, self._meta_path)

    def __iter__(self):
        for epoch in range(self._completed + 1, self.max_epoch_num):
            yield epoch
            if epoch > self._completed:
                self._completed = epoch
            if ((epoch + 1) % self.save_checkpoint_inter == 0
                    or epoch == self.max_epoch_num - 1):
                self._mark(self._completed)

    def checkpoint_path(self, epoch=None):
        e = self._completed + 1 if epoch is None else epoch
        return os.path.join(self.save_dir, self.run_id, f"epoch_{e}")

    def save(self, epoch, model=None, optimizer=None, scaler=None,
             extra=None):
        """Atomic end-of-epoch snapshot; marks `epoch` completed and prunes
        beyond the newest `max_checkpoints`. Returns its directory."""
        payload = _snapshot_payload(model, optimizer, scaler, extra)
        payload["epoch"] = int(epoch)
        d = self.checkpoint_path(epoch)
        _io.save(payload, os.path.join(d, self.CKPT_FILE))
        if epoch > self._completed:
            self._completed = int(epoch)
        self._mark(self._completed)
        self._prune()
        return d

    def _retained_epochs(self):
        base = os.path.join(self.save_dir, self.run_id)
        if not os.path.isdir(base):
            return []
        return sorted(int(m.group(1)) for m in (
            re.fullmatch(r"epoch_(\d+)", name) for name in os.listdir(base))
            if m)

    def _prune(self):
        kept = [e for e in self._retained_epochs() if e <= self._completed]
        for e in kept[:-self.max_checkpoints]:
            shutil.rmtree(self.checkpoint_path(e), ignore_errors=True)

    def restore(self, model=None, optimizer=None, scaler=None):
        """Load the newest intact snapshot at or below the last completed
        epoch into the objects given; returns its ``extra``, or None when
        nothing was restored."""
        if self._completed < 0:
            return None
        corrupt = []
        for e in reversed([e for e in self._retained_epochs()
                           if e <= self._completed]):
            path = os.path.join(self.checkpoint_path(e), self.CKPT_FILE)
            if not os.path.exists(path):
                continue
            try:
                payload = _io.load(path)
            except CheckpointCorruptError:
                corrupt.append(path)
                continue
            _apply_payload(payload, model, optimizer, scaler)
            if e != self._completed:
                # the newer snapshots were corrupt: re-run the epochs
                # after this one
                self._completed = e
                self._mark(e)
            return payload.get("extra")
        if corrupt:
            raise CheckpointCorruptError(
                f"every retained checkpoint failed its integrity check "
                f"({', '.join(corrupt)}); refusing to resume epoch "
                f"{self._completed + 1} on uninitialised state: delete the "
                f"marker file to restart from scratch")
        return None


def train_epoch_range(max_epoch_num, save_checkpoint_inter=None,
                      save_dir=None, run_id=None, max_checkpoints=3):
    return EpochRange(max_epoch_num, save_dir=save_dir, run_id=run_id,
                      save_checkpoint_inter=save_checkpoint_inter,
                      max_checkpoints=max_checkpoints)


class ServeCheckpointer(_RollingStore):
    """Crash-resumable serving state.

    Usage::

        ck = ServeCheckpointer(".serve_ckpt", save_every_n_steps=1)
        engine.restore_state(ck.restore())
        n = 0
        while engine.step():
            n += 1
            ck.tick(n, engine.state_payload())
    """

    _DIR_SUFFIX = "serve"
    _ITEM_PREFIX = "serve"
    _REFUSAL = ("refusing to restart with silently dropped in-flight "
                "requests: delete the serve_* directories to start empty")

    def __init__(self, save_dir, save_every_n_steps=1, run_id=None,
                 max_checkpoints=3):
        super().__init__(save_dir, save_every_n_steps, run_id,
                         max_checkpoints)

    def tick(self, step, payload):
        """Save `payload` when `step` lands on the grid (else a no-op).
        Returns the snapshot's directory or None."""
        if not self._on_grid(step):
            return None
        return self.save(step, payload)

    def save(self, step, payload):
        """Unconditional atomic snapshot of the serving payload at `step`;
        prunes beyond the newest `max_checkpoints`."""
        return self._save_numbered(step, {"step": int(step),
                                          "serve": payload})

    def restore(self):
        """The newest intact serving payload (for
        `engine.restore_state()`), or None for a fresh start."""
        found = self._restore_scan()
        return None if found is None else found[1].get("serve")
