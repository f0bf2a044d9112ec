#!/usr/bin/env python3
"""Build variants of the adapter delta's kernel, check them and time them
in turns on one card.

    python3 tools/torch_lora_delta_variants.py

Each variant is `paddle_tpu_torch/csrc/lora_delta.cu` with one change
made by text substitution, built by nvcc beside the port's own build:

  * ``this``: the source as it is;
  * ``kbatch8``: the tile form loads 8 k-steps of X @ A's operands at
    once instead of 6;
  * ``row512``: the row form takes 512 output columns a CTA, not 256;
  * ``no_xa``: the tile form skips X @ A (T stays at its initial zeros
    plus a constant), so the rest is timed without it;
  * ``no_tb``: the tile form skips T @ B's products;
  * ``skeleton``: both skipped: what is left is the slot, the loads of
    y and B, the barriers and the stores.

The variants that compute the delta must equal ``this`` bit for bit
(none of their changes moves a sum); the others only run. For ``this``
and the first design the line counts the elements past `lora_delta_tol`
of the twin and of the same arithmetic with fp64 sums
(`lora_delta_exact`), and the twin's own past the latter, at these
inputs (`chip_smoke.py` holds the kernel at its own cases). Beside them,
in the same turns: the first design (commit 17bc302,
`tools/torch_lora_delta_pr15.cu`) and one PyTorch read-modify-write of
y (``y.mul_(1)``, the memory floor of the delta's own traffic). Shapes:
GPT-2 124M's projections at a decode step (8 rows, the row form) and a
1024-row prefill (the tile form), bf16, rank 16. Prints the card's name
and power limit, then one JSON line of device ms a launch, by shape and
variant, each timed twice (forward and reversed order), and the counts.
Needs a CUDA card and nvcc; about a minute of command time.
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
from paddle_tpu_torch.kernels import lora_delta as ld  # noqa: E402

XA = """    if constexpr (sizeof(T) == 2) {
      if (p.fast) {
        tile_xa16<T, true>(part_w, x0, A, p, kb, nrows, warp, nw, lane, then);
      } else {
        tile_xa16<T, false>(part_w, x0, A, p, kb, nrows, warp, nw, lane, then);
      }
    } else if (p.fast) {
      tile_xa<true>(part_w, x0, A, p, kb, nrows, warp, nw, lane, then);
    } else {
      tile_xa<false>(part_w, x0, A, p, kb, nrows, warp, nw, lane, then);
    }"""
XA_SKIPPED = """    then();
    for (int o = lane; o < kTileRows * kRankBlock; o += 32) part_w[o] = 0.01;"""
TB = "      mma16<T>(c, a0, transpose8(bp[j][0]), transpose8(bp[j][1]));\n"
TB_SKIPPED = "      c[0] = a0[0]; c[1] = bp[j][0]; c[2] = a0[1]; c[3] = bp[j][1];\n"

# name -> ((old, new) substitutions, computes the delta)
VARIANTS = {
    "this": ((), True),
    "kbatch8": ((("constexpr int kKBatch = 6;",
                  "constexpr int kKBatch = 8;"),), True),
    "row512": ((("constexpr int kRowCols = 256;",
                 "constexpr int kRowCols = 512;"),), True),
    "no_xa": (((XA, XA_SKIPPED),), False),
    "no_tb": (((TB, TB_SKIPPED),), False),
    "skeleton": (((XA, XA_SKIPPED), (TB, TB_SKIPPED)), False),
}


def build():
    """Every variant's library, all nvcc processes at once."""
    src = (ROOT / "paddle_tpu_torch" / "csrc" / "lora_delta.cu").read_text()
    out = _build.BUILD_DIR / "lora_delta_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (subs, _) in VARIANTS.items():
        text = src
        for old, new in subs:
            assert old in text, (name, old)
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-o", str(out / f"lib{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name}: nvcc failed\n{log}"
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so")).paddle_lora_delta
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_lora_delta_variants.py needs a CUDA device")
    card = cs._card()
    libs = build()
    tools = cs._start_tool_builds()
    cs._finish_tool_builds(tools)
    first = cs._first_delta()
    print(card, flush=True)
    layer, times, past = 3, {}, {}
    for form in ("decode", "prefill"):
        for d_out in (2304, 768):
            n = cs.LORA_ROWS[form]
            y, x, a, b, scale = cs._lora_state(n, d_out, torch.bfloat16,
                                               seed=11)
            idx = cs._lora_idx(form, n)
            args = (x, a, b, scale, idx, layer)
            shape = f"{form} ({n}, 768 -> {d_out})"
            want = ld.lora_delta_reference(y.clone(), *args)
            exact = ld.lora_delta_exact(y, *args)
            tol = ld.lora_delta_tol(y, *args)
            outs = {}
            for name in ("this", "first design"):
                outs[name] = y.clone()
                if name == "this":
                    assert ld.run(libs[name], outs[name], *args,
                                  ld.lora_form(idx)) == 0
                else:
                    first(outs[name], *args)
            torch.cuda.synchronize()

            def n_past(v, ref, tol=tol):
                return int(((v.float() - ref.float()).abs() > tol).sum())

            past[shape] = {"twin vs fp64 sums": n_past(want, exact)}
            for name, v in outs.items():
                past[shape][name] = [n_past(v, want), n_past(v, exact)]
            calls = {}
            for name, (_, computes) in VARIANTS.items():
                fn = libs[name]
                if computes:
                    got = y.clone()
                    assert ld.run(fn, got, *args, ld.lora_form(idx)) == 0
                    torch.cuda.synchronize()
                    assert torch.equal(got, outs["this"]), (name, shape)
                yy = y.clone()
                calls[name] = (lambda fn=fn, yy=yy:
                               ld.run(fn, yy, *args, ld.lora_form(idx)))
            yy = y.clone()
            calls["first design"] = lambda yy=yy: first(yy, *args)
            calls["y.mul_(1)"] = lambda yy=yy: yy.mul_(1.0)
            order = list(calls) + list(calls)[::-1]
            times[shape] = {}
            for name in order:
                ms = cs._timed(calls[name])[0]
                times[shape].setdefault(name, []).append(round(ms, 5))
            print(shape, json.dumps(times[shape]), json.dumps(past[shape]),
                  flush=True)
    print(json.dumps({"card": card, "device_ms": times,
                      "past_lora_delta_tol (vs twin, vs fp64 sums)": past}))


if __name__ == "__main__":
    main()
