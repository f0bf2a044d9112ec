#!/usr/bin/env python3
"""Time design variants of the paged decode kernel on one card.

    python3 tools/torch_paged_decode_variants.py

Builds variants of ``paddle_tpu_torch/csrc/paged_decode.cu`` side by side
with nvcc under ``build/paged_decode_variants/`` and prints what ptxas says
of their kernels (registers, spills):

  one_cta    the design before the split (commit 3dd19f6, kept in
             ``tools/torch_paged_decode_one_cta.cu``): one CTA per (head,
             slot) walking the slot's whole context in dependent sweeps,
             8 tokens' loads in flight per lane;
  source     the file as it is, at `split_plan`'s split (4 CTAs per
             (slot, head) at M = 64, sharing the slot's positions: 256
             each of a 1024-token context): a ring of 2 stages x 2 16-byte
             copies a lane, the splits merged in a cluster;
  span_128   the same build with 8 CTAs per (slot, head);
  span_512   the same build with 2 CTAs per (slot, head);
  static     split i always takes entries [i S, (i + 1) S) of the planned
             span S, so a short context leaves the later CTAs idle;
  unstaged   each copy reads its table entry from global memory instead of
             the span's entries staged in shared memory first;
  ring_4x2   a ring of 4 stages: twice the bytes in flight a CTA;
  ring_2x1   one copy a lane per stage: half the bytes in flight a CTA.

Two probes of the source's fixed costs are timed beside them, and not
checked (their outputs are wrong by construction):

  empty        every CTA returns once it has read its length and table
               entries: a launch of the grid, its prologue and nothing else;
  copies_only  the ring's copies and waits, the softmax arithmetic replaced
               by an xor of the copied words: the memory path alone.

and, as a yardstick of streaming the same bytes in one launch on this
card, `torch.sum` over a contiguous bf16 tensor of the pools' size.

Each variant is held against the plain twin with `chip_smoke.py`'s cases
and tolerances (PAGED_TOL, PAGED_INT8_TOL), then timed with bf16 and with
int8 pools at S=8, H=12, D=64, bs=16, M=64, at full 1024-token contexts,
at the serve mix's ragged lengths and at 216-token contexts (the
profiled decode window of `chip_smoke.py`'s serve phase), in turns (each
variant, then in reverse) within one process: ptxas's schedule can move
equal arithmetic between builds, so only in-turn comparisons decide. The
card's name and power limit come first. Needs a Hopper card, nvcc and
the repository's root as the working directory.
"""
from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402

CSRC = ROOT / "paddle_tpu_torch" / "csrc"
OUT = ROOT / "build" / "paged_decode_variants"
BS = 16

_STAGE = """  for (int i = threadIdx.x; i < span_entries; i += kThreads) {
    tbl[i] = table[i];
  }
"""
_DYNAMIC = ("  const int per_split = (last_pos + a.n_split) / a.n_split;"
            "  // ceil\n"
            "  const int span_blocks = min(a.span_blocks, "
            "a.bs.div(per_split + bs - 1));\n")
_UNSTAGED = (("tbl[i] * blk_stride", "__ldg(table + i) * blk_stride"),
             ("static_cast<int64_t>(tbl[j])",
              "static_cast<int64_t>(__ldg(table + j))"))


def _sub(src, old, new):
    assert src.count(old) == 1, old
    return src.replace(old, new)


def variants():
    """name -> (source text, span tokens); None for one_cta."""
    src = (CSRC / "paged_decode.cu").read_text()
    unstaged = _sub(src, _STAGE, "")
    for old, new in _UNSTAGED:
        unstaged = _sub(unstaged, old, new)
    tokens = pa.SPAN_TOKENS
    return {"one_cta": ((ROOT / "tools" / "torch_paged_decode_one_cta.cu")
                        .read_text(), None),
            "source": (src, tokens),
            "span_128": (src, tokens // 2),
            "span_512": (src, tokens * 2),
            "static": (_sub(src, _DYNAMIC,
                            "  const int span_blocks = a.span_blocks;\n"),
                       tokens),
            "unstaged": (unstaged, tokens),
            "ring_4x2": (_sub(src, "constexpr int kStages = 2;",
                              "constexpr int kStages = 4;"), tokens),
            "ring_2x1": (_sub(src, "constexpr int kCopies = 2;",
                              "constexpr int kCopies = 1;"), tokens)}


_COMPUTE = re.compile(
    r"      float sc\[kCopies\];\n.*?      m_run = m_new;\n", re.S)
_XOR = """      uint32_t x = 0;
#pragma unroll
      for (int u = 0; u < 2 * kCopies; ++u) {
        const uint4 w = slot[u * kThreads];
        x ^= w.x ^ w.y ^ w.z ^ w.w;
      }
      acc[0] += __uint_as_float(x & 0x3fffffffu) * 1e-30f;
      l_run = 1.f;
      m_run = 0.f;
"""
_PROLOGUE_END = ("  const int64_t tok_stride = "
                 "static_cast<int64_t>(a.heads) * D;\n")


def probes():
    """name -> (source text, span tokens) of the fixed-cost probes."""
    src = (CSRC / "paged_decode.cu").read_text()
    copies_only, count = _COMPUTE.subn(lambda _: _XOR, src)
    assert count == 1, count
    return {"empty": (_sub(src, _PROLOGUE_END,
                           "  if (last_pos >= 0) return;\n" + _PROLOGUE_END),
                      pa.SPAN_TOKENS),
            "copies_only": (copies_only, pa.SPAN_TOKENS)}


def build(sources):
    """Compile every distinct source at once; returns name -> library."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs, libs, built = {}, {}, {}
    for name, (text, _) in sources.items():
        if text in built:
            continue
        built[text] = name
        src = OUT / f"{name}.cu"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build._FLAGS, "-Xptxas=-v", f"-I{CSRC}",
               "-o", str(OUT / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        kernel = None
        for line in log.splitlines():
            found = re.search(r"(paged_decode_\w*kernel)I(\w+?)EEv", line)
            if found and "Compiling entry" in line:
                kernel = f"{found.group(1)}<{found.group(2)}>"
            elif kernel and ("registers" in line or "spill" in line):
                print(f"ptxas {name}: {kernel}: "
                      f"{line.split(':', 1)[-1].strip()}")
                if "registers" in line:
                    kernel = None
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return {name: libs[built[text]] for name, (text, _) in sources.items()}


_ONE_CTA_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p])


def _one_cta(lib):
    """A caller of the one-CTA library with `paged_attention`'s
    signature."""
    fn = lib.paddle_paged_decode
    fn.argtypes = _ONE_CTA_ARGTYPES
    fn.restype = ctypes.c_int

    def call(q, k_pool, v_pool, tables, lens, bs, k_scales=None,
             v_scales=None):
        s, h, d = q.shape
        out = torch.empty_like(q)
        quant = k_scales is not None
        err = fn(*(ctypes.c_void_p(t.data_ptr() if t is not None else 0)
                   for t in (q, k_pool, v_pool, k_scales, v_scales, tables,
                             lens, out)),
                 s, h, d, tables.shape[1], bs, 1.0 / math.sqrt(d),
                 0 if q.dtype == torch.float32 else 1, int(quant),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        assert err == 0, err
        return out
    return call


def _split(lib, tokens):
    """A caller of a split-design library whose plan takes spans of
    `tokens` positions (`paged_attention.SPAN_TOKENS`)."""
    def call(*args):
        _build._LIBS["paged_decode"] = lib
        planned, pa.SPAN_TOKENS = pa.SPAN_TOKENS, tokens
        try:
            return pa.paged_attention(*args)
        finally:
            pa.SPAN_TOKENS = planned
    return call


def _check(name, call):
    for int8 in (False, True):
        for tag, heads, head_dim, dtype, lens in cs._paged_cases():
            if int8:
                q, kp, vp, ks, vs, tables, lens_t = cs._int8_state(
                    1, lens, dtype, seed=3, heads=heads, head_dim=head_dim)
                args = (q, kp[0], vp[0], tables, lens_t, BS, ks[0], vs[0])
                tol = cs.PAGED_INT8_TOL[dtype]
            else:
                q, kp, vp, tables, lens_t = cs._paged_state(
                    1, lens, dtype, seed=1, heads=heads, head_dim=head_dim)
                args = (q, kp[0], vp[0], tables, lens_t, BS)
                tol = cs.PAGED_TOL[dtype]
            tables[7] = 0
            out = call(*args)
            ref = pa.paged_decode_reference(*args)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all(), (name, tag)
            cs._close(f"{name} {'int8' if int8 else 'fp'} q={str(dtype)[6:]} "
                      f"D={head_dim} {tag}", out[:7], ref[:7], tol)


def _state(int8, lens):
    """A rotating caller's state: 4 layers of bf16 pools or 8 of int8
    (~100 MB, twice the L2), bf16 q."""
    if int8:
        q, kp, vp, ks, vs, tables, lens_t = cs._int8_state(
            8, lens, torch.bfloat16, seed=4)
        return [(q, kp[i], vp[i], tables, lens_t, BS, ks[i], vs[i])
                for i in range(8)]
    q, kp, vp, tables, lens_t = cs._paged_state(4, lens, torch.bfloat16,
                                                seed=2)
    return [(q, kp[i], vp[i], tables, lens_t, BS) for i in range(4)]


def _state_bytes(int8, slots=8, positions=1024):
    """Bytes of one layer's K and V at S=8, H=12, D=64, full contexts."""
    return 2 * slots * positions * 12 * 64 * (1 if int8 else 2)


def _summing(tensors):
    """A caller that sums the next of `tensors` whatever it is given."""
    it = iter(range(10 ** 9))

    def call(*_):
        return tensors[next(it) % len(tensors)].sum()
    return call


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(f"card: {cs._card()}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)
    sources = variants()
    checked = list(sources)
    sources.update(probes())
    libs = build(sources)
    calls = {name: (_one_cta(libs[name]) if tokens is None
                    else _split(libs[name], tokens))
             for name, (_, tokens) in sources.items()}
    for name in checked:
        _check(name, calls[name])
    bf16 = torch.bfloat16
    # ~100 MB of each, twice the L2, as the pools' rotation
    flat = {int8: [torch.empty(_state_bytes(int8) // 2, dtype=bf16,
                               device="cuda").normal_()
                   for _ in range(8 if int8 else 4)]
            for int8 in (False, True)}
    order = list(calls) + ["torch.sum"] + list(calls)[::-1] + ["torch.sum"]
    for lens_tag, lens in (("lens 1023", [1023] * 8),
                           (f"lens {cs.PAGED_RAGGED_LENS}",
                            cs.PAGED_RAGGED_LENS),
                           ("lens 215", [215] * 8)):
        for int8 in (False, True):
            layers = _state(int8, lens)
            here = dict(calls, **{"torch.sum": _summing(flat[int8])})
            times = {name: [] for name in here}
            for name in order:
                it = iter(range(10 ** 9))
                call = here[name]
                times[name].append(cs._timed(
                    lambda: call(*layers[next(it) % len(layers)]),
                    iters=50)[0])
            pools = "int8" if int8 else "bf16"
            for name, ts in times.items():
                print(f"time {name} {pools} pools, {lens_tag}: "
                      + " / ".join(f"{t:.5f}" for t in ts) + " ms",
                      flush=True)
    _build._LIBS.pop("paged_decode", None)


if __name__ == "__main__":
    main()
