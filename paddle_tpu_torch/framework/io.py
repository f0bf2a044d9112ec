"""Atomic, CRC-checked checkpoint files: tensors and state dicts (`save` /
`load`, and `async_save`, which writes on a thread) and JSON-able
payloads (`save_json` / `load_json`).

Counterpart of `paddle_tpu/framework/io.py` (`save` / `load` with an atomic
replace and a CRC trailer, `CheckpointCorruptError`; `:72-98`,
`:181-241`). The file formats are the port's own: the payload (for `save`,
`torch.save`'s bytes of the object with every tensor moved to the CPU;
for `save_json`, UTF-8 JSON), then a 24-byte trailer of three
little-endian uint64s (magic, payload length, CRC-32 of the payload), one
magic for each format. A save writes a temporary file beside the target,
flushes and fsyncs it, and renames it over the target, so a reader sees
the old file or the new one, never half of one. A load that finds a short
file, another magic, a length or CRC that does not match, or a payload
that does not parse raises `CheckpointCorruptError`. `load` unpickles
with ``weights_only=True``: tensors, numbers, strings and containers of
them, nothing that runs code.

`async_save` is the counterpart of the reference's (`:106-175`): the
calling thread makes `save`'s payload (the object's tensors copied to the
CPU, then `torch.save`'s bytes), so the object is snapshotted when the call
returns; a thread writes them with the same trailer, fsyncs and renames,
while training goes on.
`load` reads its file as it reads a `save`d one.
"""
from __future__ import annotations

import io
import itertools
import json
import os
import pickle
import struct
import threading
import zlib

import torch

__all__ = ["save", "load", "async_save", "AsyncSaveHandle", "save_json",
           "load_json", "CheckpointCorruptError"]

_MAGIC_JSON = 0x4E4F534A54505450   # "PTPTJSON"
_MAGIC_TORCH = 0x484352544F545450  # "PTTORTCH"
_TRAILER = struct.Struct("<QQQ")
_TMP_SEQ = itertools.count()


class CheckpointCorruptError(IOError):
    """A checkpoint file failed its integrity check (truncation, a CRC
    mismatch, or a payload that does not parse): restore from an earlier
    one instead of resuming on partial state."""


def _write_atomic(data, path, magic):
    """`data` and its trailer to `path` by a temporary file and a rename;
    makes the directory. Returns `path`."""
    path = os.fspath(path)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    # a number per call: writers of one path in threads of one process
    tmp = f"{path}.tmp.{os.getpid()}.{next(_TMP_SEQ)}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.write(_TRAILER.pack(magic, len(data), zlib.crc32(data)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    return path


def _read_verified(path, magic):
    """The payload of the file at `path`, its trailer checked."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < _TRAILER.size:
        raise CheckpointCorruptError(f"{path}: {len(blob)} bytes, shorter "
                                     f"than the {_TRAILER.size}-byte "
                                     "trailer")
    found, length, crc = _TRAILER.unpack(blob[-_TRAILER.size:])
    data = blob[:-_TRAILER.size]
    if found != magic or length != len(data):
        raise CheckpointCorruptError(f"{path}: trailer does not match the "
                                     "file (truncated or not a checkpoint)")
    if zlib.crc32(data) != crc:
        raise CheckpointCorruptError(f"{path}: CRC mismatch")
    return data


def save_json(payload, path):
    """Write `payload` (JSON-able) to `path` atomically with its CRC
    trailer; makes the directory. Returns `path`."""
    data = json.dumps(payload, separators=(",", ":")).encode("utf-8")
    return _write_atomic(data, path, _MAGIC_JSON)


def load_json(path):
    """The payload `save_json` wrote at `path`; `CheckpointCorruptError`
    where the file fails its integrity check."""
    data = _read_verified(path, _MAGIC_JSON)
    try:
        return json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(f"{path}: payload does not parse "
                                     f"({e})") from e


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _payload(obj):
    """`save`'s payload of `obj`: `torch.save`'s bytes of its CPU copy, in
    a `BytesIO`."""
    buf = io.BytesIO()
    torch.save(_to_cpu(obj), buf)
    return buf


def save(obj, path):
    """Write `obj` (tensors, numbers, strings, None, and dicts, lists and
    tuples of them, such as a state dict) to `path` atomically with its
    CRC trailer; every tensor is saved as a CPU copy. Returns `path`."""
    return _write_atomic(_payload(obj).getvalue(), path, _MAGIC_TORCH)


class AsyncSaveHandle:
    """An `async_save` in flight: `done()` polls, `wait()` joins the
    writer thread and raises `IOError` where the write failed. A handle
    dropped unwaited joins its writer when it is collected."""

    def __init__(self, data, path):
        self.path = path
        self._error = []
        # the thread holds the payload and the error list, not the handle,
        # so dropping the handle runs `__del__` while the write goes on
        self._thread = threading.Thread(
            target=_write_job, args=(data, path, self._error),
            name="async_save")
        self._thread.start()

    def done(self):
        """Whether the write has ended (well or not); `wait` says which."""
        return not self._thread.is_alive()

    def wait(self):
        """Block until the file is written, fsynced and renamed into
        place; `IOError` naming the step that failed (the reference's
        words), then the error itself. A second call returns at once."""
        self._thread.join()
        if self._error:
            e = self._error.pop()
            raise IOError(f"async_save to {self.path} failed: "
                          f"{_failed_step(e)} ({e})") from e

    def __del__(self):
        self._thread.join()


def _write_job(data, path, error):
    try:
        _write_atomic(data, path, _MAGIC_TORCH)
    except OSError as e:
        error.append(e)


def _failed_step(e):
    """The reference writer's name for the step of `_write_atomic` that
    raised `e`: a rename's error names two files, an open's one, a write's
    none."""
    if getattr(e, "filename2", None) is not None:
        return "rename failed"
    if getattr(e, "filename", None) is not None:
        return "cannot open file"
    return "short write"


def async_save(obj, path):
    """Write `obj` to `path` as `save` does, on a writer thread.

    The calling thread makes `save`'s payload (every tensor copied to the
    CPU, then `torch.save`'s bytes), so later changes to `obj` do not reach
    the file. A thread then runs `save`'s `_write_atomic` on it: the bytes
    and the CRC trailer to a temporary file, fsync, a rename over `path`, a
    directory fsync. The file writes, `zlib.crc32` and the fsyncs release
    the GIL, so the caller's Python runs meanwhile. Returns an
    `AsyncSaveHandle`: call ``wait()`` before relying on the file. The
    reference runs the same steps in a C++ thread (its `ckpt_writer.cc`);
    here the Python writer is the one implementation of them, shared with
    `save`."""
    return AsyncSaveHandle(_payload(obj).getbuffer(), os.fspath(path))


def load(path, map_location="cpu"):
    """The object `save` wrote at `path`, its tensors on `map_location`;
    `CheckpointCorruptError` where the file fails its integrity check."""
    data = _read_verified(path, _MAGIC_TORCH)
    try:
        return torch.load(io.BytesIO(data), map_location=map_location,
                          weights_only=True)
    except (pickle.UnpicklingError, EOFError, RuntimeError) as e:
        raise CheckpointCorruptError(f"{path}: payload does not parse "
                                     f"({e})") from e
