"""Crash-resumable serving state: rolling, atomic, CRC-checked snapshots.

Counterpart of `paddle_tpu/incubate/checkpoint.py` `_RollingStore` and
`ServeCheckpointer`. The payload is the engine's `state_payload()` (the
reference's dict: prompts, emitted tokens, arrival order, remaining TTLs,
the adapter and sampler identity, never the KV pool, which re-prefills
token-identically on resume), so a snapshot is a few KB of host data and a
`tick()` every engine step is affordable. A killed server restarts,
`restore()`s the newest intact snapshot and feeds it to
`engine.restore_state()`; every in-flight stream finishes
byte-identically. The files are the port's own (`framework.io`: JSON with
a CRC trailer, written atomically); the training checkpointers of the
reference (`EpochRange`, `StepCheckpointer`) are ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

import os
import re
import shutil

from ..framework import io as _io

__all__ = ["ServeCheckpointer", "CheckpointCorruptError"]

CheckpointCorruptError = _io.CheckpointCorruptError


class _RollingStore:
    """Numbered snapshots in ``<save_dir>/<run_id>_<suffix>/<prefix>_<n>/``,
    the newest `max_checkpoints` kept, a newest-first restore scan that
    skips corrupt snapshots and refuses when none survives."""

    CKPT_FILE = "state.json"
    _DIR_SUFFIX = ""
    _ITEM_PREFIX = ""
    _REFUSAL = ""

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
        _io.save_json(payload, os.path.join(d, self.CKPT_FILE))
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
                return s, _io.load_json(path)
            except CheckpointCorruptError:
                corrupt.append(path)
        if corrupt:
            raise CheckpointCorruptError(
                f"every retained {self._ITEM_PREFIX} checkpoint failed its "
                f"integrity check ({', '.join(corrupt)}); {self._REFUSAL}")
        return None


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
