#!/usr/bin/env python3
"""Time grid variants of the sampler's two cluster kernels on one card.

    python3 tools/torch_sampler_grids.py

Builds variants of ``paddle_tpu_torch/csrc/keyed_draw.cu`` and
``csrc/sampler_filter.cu`` side by side with nvcc under
``build/sampler_grids/``, each the source with its two grid constants
(``kThreads``, the threads of a CTA, and ``kMaxCtas``, the most CTAs of a
row's cluster) changed; at V = 50304 a row takes ``min(kMaxCtas,
ceil(V / kThreads))`` CTAs:

  8x1024   the source as it is (8 CTAs of 1024 threads a row);
  4x1024   clusters of at most 4 CTAs;
  8x512    CTAs of 512 threads;
  8x256    CTAs of 256 threads (the keyed draw only);
  8x1024/d11  the filter with 11-bit digits in its radix route (3 passes,
           2048 bins, one histogram copy a CTA) in place of 8-bit digits
           in 4 passes (``kDigitBits``).

Clusters of more than 8 CTAs need the non-portable cluster attribute,
which the port does not set, and are not built.

Each variant is checked first at the serving shape (S = 8, V = 50304):
the draw's tokens equal the twin's (on the CPU, on copies), and each
filtered row is one that `sampler_filter.margin_cuts` allows. Then each
is timed with 2 and with 8 of 8 rows sampled (the filter also on
top-p-only rows, top-k 0 and top-p 0.9: its radix route), with the
launch queue filled ahead (`chip_smoke._timed`), in turns: every
variant, then every variant in reverse, in one process. The card's name
and power limit come first; the last line is one JSON object of the
times. Needs a Hopper card, nvcc and the repository's root as the
working directory.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import keyed_draw as kd  # noqa: E402
from paddle_tpu_torch.kernels import sampler_filter as sf  # noqa: E402

CSRC = ROOT / "paddle_tpu_torch" / "csrc"
OUT = ROOT / "build" / "sampler_grids"
V = 50304
S = 8
GRIDS = {"keyed_draw": ("8x1024", "4x1024", "8x512", "8x256"),
         "sampler_filter": ("8x1024", "4x1024", "8x512", "8x1024/d11")}


def _variant(src, grid):
    grid, _, digits = grid.partition("/d")
    ctas, threads = grid.split("x")
    edits = [("constexpr int kThreads = 1024;",
              f"constexpr int kThreads = {threads};"),
             ("constexpr int kMaxCtas = 8;",
              f"constexpr int kMaxCtas = {ctas};")]
    if digits:
        edits.append(("constexpr int kDigitBits = 8;",
                      f"constexpr int kDigitBits = {digits};"))
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def build():
    """Compile every variant at once; returns (kernel, grid) -> library."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, grids in GRIDS.items():
        src = (CSRC / f"{name}.cu").read_text()
        for grid in grids:
            tag = grid.replace("/", "_")
            path = OUT / f"{name}_{tag}.cu"
            path.write_text(_variant(src, grid))
            lib = OUT / f"lib{name}_{tag}.so"
            cmd = [_build._nvcc(), *_build._FLAGS, f"-I{CSRC}", "-o",
                   str(lib), str(path)]
            procs[name, grid] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key}: nvcc failed\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def draw_caller(lib):
    """A variant of the keyed draw as a function of its inputs."""
    fn = lib.paddle_keyed_draw
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(raw, filtered, temps, seeds, pos, out):
        err = fn(*map(_ptr, (raw, filtered, temps, seeds, pos, out)), None,
                 None, None, raw.shape[0], raw.shape[1], 0, _stream())
        assert err == 0, err
    return call


def filter_caller(lib):
    """A variant of the filter as a function of its inputs."""
    def call(*args):
        err = sf.run(lib, *args)
        assert err == 0, err
    return call


def check_draw(grid, call):
    for sampled in ((6, 7), range(S)):
        args = cs._keyed_state(S, V, 11, sampled)
        out = torch.full((S,), -1, dtype=torch.int32, device="cuda")
        call(*args, out)
        torch.cuda.synchronize()
        want = kd.keyed_draw_reference(*(t.cpu() for t in args))
        assert torch.equal(out.cpu(), want), (grid, out.tolist(),
                                              want.tolist())


def check_filter(grid, call):
    for rows in (cs.FILTER_MAIN, cs.FILTER_RAGGED, cs.FILTER_TOP_P):
        args = cs._filter_state(V, 13, rows)
        out = torch.full(args[0].shape, 7.0, device="cuda")
        call(*args, out)
        torch.cuda.synchronize()
        lg, cuts = sf.margin_cuts(*(t.cpu() for t in args))
        got = out.cpu()
        for r, row_cuts in enumerate(cuts):
            if not row_cuts:
                assert torch.all(got[r] == 7.0), (grid, r)
                continue
            assert any(torch.equal(got[r], lg[r].masked_fill(lg[r] < c,
                                                             -1e30))
                       for c in row_cuts), (grid, r)


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_sampler_grids.py needs a CUDA card")
    print(f"card: {cs._card()}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")
    libs = build()
    calls, states = {}, {}
    for (name, grid), lib in libs.items():
        if name == "keyed_draw":
            calls[name, grid] = draw_caller(lib)
            check_draw(grid, calls[name, grid])
        else:
            calls[name, grid] = filter_caller(lib)
            check_filter(grid, calls[name, grid])
        print(f"{name} {grid}: checked at S={S} V={V}")
    for n_sampled, sampled in ((2, (6, 7)), (8, range(S))):
        args = cs._keyed_state(S, V, 7, sampled)
        states["keyed_draw", f"{n_sampled} of 8 sampled"] = (
            *args, torch.empty(S, dtype=torch.int32, device="cuda"))
        for tag, cfgs in (("", cs.FILTER_MAIN),
                          ("top-p only, ", cs.FILTER_TOP_P)):
            rows = cfgs if n_sampled == 2 else [cfgs[-1]] * S
            args = cs._filter_state(V, 8, rows)
            states["sampler_filter", f"{tag}{n_sampled} of 8 sampled"] = (
                *args, torch.empty_like(args[0]))
    times = {}
    for (name, load), state in states.items():
        grids = GRIDS[name]
        for grid in grids + grids[::-1]:
            call = calls[name, grid]
            ms, _ = cs._timed(lambda: call(*state))
            times.setdefault(name, {}).setdefault(load, {}).setdefault(
                grid, []).append(round(ms, 5))
    for name, by_load in times.items():
        for load, by_grid in by_load.items():
            print(f"{name} {load}: " + ", ".join(
                f"{g} {' / '.join(f'{t:.5f}' for t in ts)} ms"
                for g, ts in by_grid.items()))
    print(json.dumps({"grids_ms": times}))


if __name__ == "__main__":
    main()
