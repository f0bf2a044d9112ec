"""Atomic, CRC-checked files of a JSON-able payload.

Counterpart of the integrity half of `paddle_tpu/framework/io.py` (`save` /
`load` with an atomic replace and a CRC trailer, `CheckpointCorruptError`),
for what the port stores so far: crash-resume snapshots of the serving
engine (`incubate.checkpoint.ServeCheckpointer`). The file format is the
port's own: the payload as UTF-8 JSON, then a 24-byte trailer of three
little-endian uint64s (magic, payload length, CRC-32 of the payload). A
save writes a temporary file beside the target, flushes and fsyncs it, and
renames it over the target, so a reader sees the old file or the new one,
never half of one. A load that finds a short file, another magic, a length
or CRC that does not match, or bytes that are not JSON raises
`CheckpointCorruptError`.
"""
from __future__ import annotations

import json
import os
import struct
import zlib

__all__ = ["save_json", "load_json", "CheckpointCorruptError"]

_MAGIC = 0x4E4F534A54505450  # "PTPTJSON"
_TRAILER = struct.Struct("<QQQ")


class CheckpointCorruptError(IOError):
    """A checkpoint file failed its integrity check (truncation, a CRC
    mismatch, or a payload that does not parse): restore from an earlier
    one instead of resuming on partial state."""


def save_json(payload, path):
    """Write `payload` (JSON-able) to `path` atomically with its CRC
    trailer; makes the directory. Returns `path`."""
    data = json.dumps(payload, separators=(",", ":")).encode("utf-8")
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.write(_TRAILER.pack(_MAGIC, len(data), zlib.crc32(data)))
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


def load_json(path):
    """The payload `save_json` wrote at `path`; `CheckpointCorruptError`
    where the file fails its integrity check."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < _TRAILER.size:
        raise CheckpointCorruptError(f"{path}: {len(blob)} bytes, shorter "
                                     f"than the {_TRAILER.size}-byte "
                                     "trailer")
    magic, length, crc = _TRAILER.unpack(blob[-_TRAILER.size:])
    data = blob[:-_TRAILER.size]
    if magic != _MAGIC or length != len(data):
        raise CheckpointCorruptError(f"{path}: trailer does not match the "
                                     "file (truncated or not a checkpoint)")
    if zlib.crc32(data) != crc:
        raise CheckpointCorruptError(f"{path}: CRC mismatch")
    try:
        return json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(f"{path}: payload does not parse "
                                     f"({e})") from e
