#!/usr/bin/env python3
"""Time design variants of the bf16 (or f16) flash backward kernels on one
card.

    python3 tools/torch_flash_bwd_variants.py [--dtype float16]

Builds variants of ``paddle_tpu_torch/csrc/flash_attention_bwd.cu`` side by
side with nvcc under ``build/flash_bwd_variants/`` and prints what ptxas
says of their wgmma kernels (registers, spills, serialized wgmma):

  source     the file as it is: both kernels under
             ``__launch_bounds__(160, 1)`` take their tiles in sequence and
             commit the two score products apart, so that P's exponentials
             run while the second product is on the tensor cores;
  piped2     the first design: each kernel pipelined across tiles (tile j's
             score products issued with tile j-1's accumulating ones), dQ
             under (160, 2), dK/dV under (160, 2) at D = 64 and (160, 1) at
             D = 128;
  piped1     the first design under (160, 1);
  sequence   tiles in sequence, the two score products waited for
             together;
  dv_early   as source, with dV += P^T dO issued as soon as P^T is packed,
             so that dS^T is computed while it runs;
  no_fit     as source without the f16 kernels' dS row factor (`fit_f16`):
             the same code in bf16; in f16 what the factor costs (it is
             right only while no |dS| passes 65504, as at these cases).

Each variant is held against the plain twins with `chip_smoke.py`'s
criteria for the type, then dQ and dK/dV are timed at the training shape
(8, 1024, 12, 64) causal in turns (each variant, then in reverse) within one
process, and at D = 128 ((8, 1024, 6, 128)) once each. The card's name and
power limit come first. Needs a Hopper card, nvcc and the repository's
root as the working directory.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402

CSRC = ROOT / "paddle_tpu_torch" / "csrc"
OUT = ROOT / "build" / "flash_bwd_variants"
_BOUNDS = re.compile(r"__launch_bounds__\(kWgmmaThreads, [^)]*\)\n"
                     r"(flash_bwd_(dq|dkv)_kernel_wgmma)")
_DQ_LOOP = re.compile(r"  // Tile by tile: S and dP are committed apart.*?"
                      r"    release\(j\);\n  }\n", re.S)
_DKV_LOOP = re.compile(r"  // Tile by tile, as the dQ kernel:.*?"
                       r"    release\(j\);\n  }\n", re.S)


def _dq_scores(j):
    """Issue tile `j`'s S and dP (not committed)."""
    return f"""    issue_ss<T, D>(sc, q_addr, smem_u32(sm.k[({j}) % kStages][0]));
    issue_ss<T, D>(dp, g_addr, smem_u32(sm.v[({j}) % kStages][0]));
"""


def _dq_grad(j):
    """sc becomes tile `j`'s dS / scale from S and dP."""
    return f"""    {{
      const int key0 = ({j}) * kRows;
      const bool edge = key0 + kRows > m || (kCausal && key0 + kRows > q0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {{
        const int r = (i / 2) % 2;
        float p = ex2(fmaf(sc[i], scale_log2, -lse2[r]));
        if (edge) {{
          const int key = key0 + 8 * (i / 4) + col0 + (i % 2);
          if (key >= m || (kCausal && key > row0 + 8 * r)) p = 0.f;
        }}
        sc[i] = p * (dp[i] - dlt[r]);
      }}
    }}
"""


def _dkv_scores(j):
    """Issue tile `j`'s S^T and dP^T (not committed)."""
    return f"""    issue_ss<T, D>(sc, k_addr, smem_u32(sm.q[({j}) % kStages][0]));
    issue_ss<T, D>(dp, v_addr, smem_u32(sm.g[({j}) % kStages][0]));
"""


def _dkv_probs(j):
    """sc becomes tile `j`'s P^T."""
    return f"""    {{
      const int s = ({j}) % kStages;
      const int t0 = (t_begin + ({j})) * kRows;
      const bool edge = t0 + kRows > n || k0 + kRows > m ||
                        (kCausal && t0 < k0 + kRows);
#pragma unroll
      for (int i = 0; i < 32; ++i) {{
        const int col = 8 * (i / 4) + col0 + (i % 2);
        float p = ex2(fmaf(sc[i], scale_log2, -sm.lse2[s][col]));
        if (edge) {{
          const int key = row0 + 8 * ((i / 2) % 2);
          const int query = t0 + col;
          if (query >= n || key >= m || (kCausal && query < key)) p = 0.f;
        }}
        sc[i] = p;
      }}
    }}
"""


def _dkv_grads(j):
    """dp becomes tile `j`'s dS^T / scale from P^T and dP^T."""
    return f"""#pragma unroll
    for (int i = 0; i < 32; ++i) {{
      dp[i] = sc[i] * (dp[i] - sm.delta[({j}) % kStages][8 * (i / 4) + col0 +
                                                        (i % 2)]);
    }}
"""


def _pipelined(wait, scores, elementwise, pack, accumulate, fences):
    """One kernel's consumer loop pipelined across tiles."""
    return f"""  {wait}
  zero(sc);
  zero(dp);
  {scores[0]}(0);
  wgmma_fence();
{scores[1]("0")}  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
{elementwise("0")}{pack}  for (int j = 1; j < n_tiles; ++j) {{
    zero(sc);
    zero(dp);
    {scores[0]}(j);
    wgmma_fence();
{scores[1]("j")}    wgmma_commit();
    {accumulate}(j - 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    fence_regs(dp);
{elementwise("j")}    wgmma_wait<0>();
{fences}    fence_regs(sc);
    fence_regs(dp);
    release(j - 1);
{pack}  }}
  wgmma_fence();
  {accumulate}(n_tiles - 1);
  wgmma_commit();
  wgmma_wait<0>();
{fences}  release(n_tiles - 1);
"""


def _sequence(wait, scores, elementwise, pack, accumulate, fences):
    """One kernel's consumer loop, tiles in sequence, the two score
    products waited for together."""
    return f"""  {wait}
  for (int j = 0; j < n_tiles; ++j) {{
    zero(sc);
    zero(dp);
    {scores[0]}(j);
    wgmma_fence();
{scores[1]("j")}    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
{elementwise("j")}{pack}    wgmma_fence();
    {accumulate}(j);
    wgmma_commit();
    wgmma_wait<0>();
{fences}    release(j);
  }}
"""


_FIT_DQ = "    if constexpr (kIsHalf<T>) fit_f16(sc, ds_mul, dq_acc);\n"
_FIT_DKV = "    if constexpr (kIsHalf<T>) fit_f16(dp, ds_mul, dk_acc);\n"
_DQ = ("mbar_wait(&sm.qg_full, 0);", ("wait_kv", _dq_scores), _dq_grad,
       _FIT_DQ + "    pack<T>(da, sc);\n", "issue_dq",
       "    fence_regs(dq_acc);\n")
_DKV = ("mbar_wait(&sm.kv_full, 0);", ("wait_qg", _dkv_scores),
        lambda j: _dkv_probs(j) + _dkv_grads(j),
        _FIT_DKV + "    pack<T>(pa, sc);\n    pack<T>(da, dp);\n",
        "issue_dkv", "    fence_regs(dk_acc);\n    fence_regs(dv_acc);\n")
_DV_EARLY = """  mbar_wait(&sm.kv_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    zero(sc);
    zero(dp);
    wait_qg(j);
    wgmma_fence();
    issue_ss<T, D>(sc, k_addr, smem_u32(sm.q[j % kStages][0]));
    wgmma_commit();
    issue_ss<T, D>(dp, v_addr, smem_u32(sm.g[j % kStages][0]));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
""" + _dkv_probs("j") + """    pack<T>(pa, sc);
    wgmma_wait<0>();
    fence_regs(dp);
    wgmma_fence();
    issue_rs<T, D>(dv_acc, pa, smem_u32(sm.g[j % kStages][0]));
    wgmma_commit();
""" + _dkv_grads("j") + _FIT_DKV + """    pack<T>(da, dp);
    wgmma_fence();
    issue_rs<T, D>(dk_acc, da, smem_u32(sm.q[j % kStages][0]));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    release(j);
  }
"""


def _bounds(src, dq, dkv):
    def sub(match):
        blocks = dq if match.group(2) == "dq" else dkv
        return f"__launch_bounds__(kWgmmaThreads, {blocks})\n{match.group(1)}"
    out, count = _BOUNDS.subn(sub, src)
    assert count == 2, count
    return out


def _sub(pattern, src, text):
    out, count = pattern.subn(lambda _: text, src)
    assert count == 1, count
    return out


def _loops(src, kind):
    """`src` with both consumer loops written by `kind` (_pipelined or
    _sequence)."""
    return _sub(_DKV_LOOP, _sub(_DQ_LOOP, src, kind(*_DQ)), kind(*_DKV))


def variants():
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    piped1 = _loops(src, _pipelined)
    no_fit = src
    for line in (_FIT_DQ, _FIT_DKV):
        assert no_fit.count(line) == 1, line
        no_fit = no_fit.replace(line, "")
    return {"source": src,
            "piped2": _bounds(piped1, "2", "D == 64 ? 2 : 1"),
            "piped1": piped1,
            "sequence": _loops(src, _sequence),
            "dv_early": _sub(_DKV_LOOP, src, _DV_EARLY),
            "no_fit": no_fit}


def build(sources):
    """Compile every variant at once; returns name -> loaded library."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build._FLAGS, "-Xptxas=-v", f"-I{CSRC}",
               "-o", str(OUT / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        kernel = None
        for line in log.splitlines():
            found = re.search(r"flash_bwd_(dq|dkv)_kernel_wgmmaI\w*?"
                              r"(6__half|13__nv_bfloat16)Li(\d+)ELb(\d)", line)
            if found:
                what = (f"{found.group(1)} {found.group(2).lstrip('0123456789')}"
                        f" D={found.group(3)} causal={found.group(4)}")
            if found and "Compiling entry" in line:
                kernel = what
            elif found and "serialized" in line:
                print(f"ptxas {name}: {what}: wgmma serialized "
                      "(insufficient registers)")
            elif kernel and ("registers" in line or "spill" in line):
                print(f"ptxas {name}: {kernel}: {line.split(':', 1)[-1].strip()}")
                if "registers" in line:
                    kernel = None
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(f"card: {cs._card()}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)
    libs = build(variants())
    bf16 = torch.float16 if sys.argv[1:] == ["--dtype", "float16"] \
        else torch.bfloat16
    name16 = str(bf16)[6:]
    train = cs._fused_qkv(1024, bf16, seed=11, batch=8)
    wide = cs._fused_qkv(1024, bf16, seed=5, heads=6, head_dim=128, batch=8)
    for name, lib in libs.items():
        _build._LIBS["flash_attention_bwd"] = lib
        cs._check_flash_bwd_case(f"{name} n=65 causal",
                                 *cs._fused_qkv(65, bf16, seed=95), True)
        cs._check_flash_bwd_case(f"{name} D=128 n=200",
                                 *cs._fused_qkv(200, bf16, seed=32, heads=4,
                                                head_dim=128), False)
        cs._check_flash_bwd_case(f"{name} (8, 1024, 12, 64) causal", *train,
                                 True, seed=12)
    args = cs._flash_bwd_inputs(*train, True, seed=12)
    order = list(libs) + list(libs)[::-1]
    for name in order:
        _build._LIBS["flash_attention_bwd"] = libs[name]
        dq = cs._timed(lambda: fa.flash_attention_bwd_dq(*args), iters=50)[0]
        dkv = cs._timed(lambda: fa.flash_attention_bwd_dkv(*args),
                        iters=50)[0]
        print(f"time {name} (8, 1024, 12, 64) {name16} causal: dq "
              f"{dq:.5f} ms, dkv {dkv:.5f} ms", flush=True)
    args = cs._flash_bwd_inputs(*wide, True, seed=6)
    for name in libs:
        _build._LIBS["flash_attention_bwd"] = libs[name]
        dq = cs._timed(lambda: fa.flash_attention_bwd_dq(*args))[0]
        dkv = cs._timed(lambda: fa.flash_attention_bwd_dkv(*args))[0]
        print(f"time {name} (8, 1024, 6, 128) {name16} causal: dq "
              f"{dq:.5f} ms, dkv {dkv:.5f} ms", flush=True)
    _build._LIBS.pop("flash_attention_bwd")


if __name__ == "__main__":
    main()
