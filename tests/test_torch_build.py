"""The port's kernel build: which inputs name a built library.

`paddle_tpu_torch.kernels._build` names each library by a hash of what it
is built from, so that an edited input never loads a stale build. No nvcc
is needed: these tests only compute paths, over a copy of the sources.
"""
from __future__ import annotations

import shutil

import pytest

from paddle_tpu_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources that `_build` reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, copy)
    monkeypatch.setattr(_build, "_CSRC", copy)
    return copy


def _paths():
    return {name: _build.lib_path(name) for name in _build.SOURCES}


def test_lib_path_covers_the_shared_headers(csrc):
    """A new or edited csrc/*.cuh renames every library (any source may
    include a header); the same inputs give the same names."""
    before = _paths()
    assert _paths() == before
    (csrc / "scratch_extra.cuh").write_text("#pragma once\n")
    added = _paths()
    assert all(added[name] != before[name] for name in _build.SOURCES)
    header = csrc / "hopper_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = _paths()
    assert all(edited[name] != added[name] for name in _build.SOURCES)


def test_lib_path_of_an_edited_source_alone_changes(csrc):
    before = _paths()
    src = csrc / "fused_ln.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _paths()
    assert after["fused_ln"] != before["fused_ln"]
    assert all(after[name] == before[name] for name in _build.SOURCES
               if name != "fused_ln")
