#!/usr/bin/env python3
"""Time design variants of the bf16 (or f16) flash backward kernels on one
card.

    python3 tools/torch_flash_bwd_variants.py [--dtype float16]
    python3 tools/torch_flash_bwd_variants.py --d128 [--parent DIR]
                                              [--extra NAME=FILE ...]

Builds variants of ``paddle_tpu_torch/csrc/flash_attention_bwd.cu`` side by
side with nvcc under ``build/flash_bwd_variants/`` and prints what ptxas
says of their wgmma kernels (registers, spills, serialized wgmma) and, for
the f16 kernels, their SASS instructions by mnemonic. Every run also builds
the parent commit's source (``parent``: `torch_flash_fwd_variants.py`'s
``--parent`` directory, filled from git where missing, with an info entry
appended where it has none) and ends with dQ and dK/dV at config 3's
shape (4, 2048, 16, 128) and at (8, 1024, 6, 128), causal, timed in turns
with SDPA's backward.

``--d128`` builds parent, source and the variants of the two D = 128
kernels. Of dK/dV: ``stages3`` (a 3-stage Q/dO ring), ``no_pingpong``
(the two consumer warpgroups without turns at the tensor cores), ``grid``
(one CTA a work item instead of one CTA an SM), ``prefetch_lse`` (the
tile's lse values loaded into registers before the turn). Of dQ:
``dq_stages3`` (a 3-stage K/V ring), ``dq_no_pingpong`` (no turns),
``dq_grid`` (one CTA an item), ``dq_interleaved`` (the items dealt with
the heads interleaved, item t of head t % (B H), instead of head by
head), ``dq_stores`` (dQ stored by 4-byte stores from the accumulator
instead of one TMA store a warpgroup). Timing-only probes, not
checked (their outputs are wrong by design): ``probe_noload`` and
``probe_dq_noload`` (the producer arrives on each streamed tile's full
barrier without a copy: dK/dV's Q/dO tiles, dQ's K/V tiles),
``probe_noelem`` and ``probe_dq_noelem`` (no elementwise work between the
products: the score products packed as they come). With ``--extra
NAME=FILE``, repeatable, another version of the source. It prints each
library's info entry (CTAs an SM, registers, local bytes) for both
kernels, checks each in a child process under a time limit at D = 128
over the 128-row and 128-key blocks' edges (bf16 and f16, the f16 dS
guard's large-dO cases, two launches bit for bit equal), prints how many
elements of source's dQ, dK and dV differ from the parent's at config
3's shape (bf16, f16, and f16 with dO times `DROP_GAIN_D128`, where rows
drop their dS factor), and times the survivors in turns at config 3's
shape and at each D = 64 main-path shape (`TIMED_D128`), whose D = 64
kernels the variants share.

The variants of the default run:

  source     the file as it is: both kernels under
             ``__launch_bounds__(160, 1)`` take their tiles in sequence and
             commit the two score products apart, so that P's exponentials
             run while the second product is on the tensor cores; in f16
             at D = 64 under (160, 3) (dQ) and (160, 2) (dK/dV), the dS
             guard keeps each thread's largest |dS| while forming it and
             takes one warp vote (any |dS| >= 32760: would round to 2^15
             or more), the fp32 row maxima only where the vote or an
             earlier drop asks for them;
  piped2     the first design: each kernel pipelined across tiles (tile j's
             score products issued with tile j-1's accumulating ones), dQ
             under (160, 2), dK/dV under (160, 2) at D = 64 and (160, 1) at
             D = 128;
  piped1     the first design under (160, 1);
  sequence   tiles in sequence, the two score products waited for
             together;
  dv_early   as source, with dV += P^T dO issued as soon as P^T is packed,
             so that dS^T is computed while it runs;
  fit_pr20   the earlier f16 dS guard (its text is held here,
             `_FIT_PR20`) under (160, 1): the fp32 row max, 4 shuffles and
             32 multiplies on every tile; the loop variants above carry it
             too;
  packed_test  as source with the vote on the packed f16 values (a packed
             max in two chains, `_F16_BIG`), the fp32 values held through
             it for the fit;
  source_free  as source under (160, 1), ptxas left free;
  no_fit     as source without the f16 dS guard, under (160, 1): the same
             code in bf16; in f16 what the guard costs (it is right only
             while no |dS| passes 65504).

bf16 builds source, the loop variants and no_fit. ``--dtype float16``
builds source, fit_pr20, packed_test, source_free and no_fit; it also holds source's outputs to fit_pr20's bit for
bit at the training shape and at a dO gain that makes rows drop their
factor (`DROP_GAIN`, where it also says how many rows pass 2^15), and
times the three variants there too.

Each variant is held against the plain twins with `chip_smoke.py`'s
criteria for the type, then dQ and dK/dV are timed at the training shape
(8, 1024, 12, 64) causal in turns (each variant, then in reverse) with
SDPA's backward of the same type (dQ, dK and dV in one call) within one
process, and at D = 128 ((8, 1024, 6, 128)) once each. The card's name and
power limit come first. Needs a Hopper card, nvcc and the repository's
root as the working directory.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import torch_flash_fwd_variants as fv  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402

CSRC = ROOT / "paddle_tpu_torch" / "csrc"
OUT = ROOT / "build" / "flash_bwd_variants"
# the dO gain of the f16 case whose rows drop their dS factor: the
# training-shape check's gain (F16_TRAIN_DO_GAIN) times 40
DROP_GAIN = cs.F16_TRAIN_DO_GAIN * 40
# the same at config 3's D = 128 shape, half of it: dP sums twice the
# products, and dO's 16.7M normal values stay below f16's largest (at
# DROP_GAIN the tail past 5.46 sigma would reach it)
DROP_GAIN_D128 = DROP_GAIN / 2
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


# the f16 dS guard before the packed test (its function and its two call
# sites, as they stood): the fp32 row max on every tile
_FIT_PR20 = """// f16 only: this thread's values of a 64 x 64 tile of dS (rows row0 and
// row0 + 8: element i is row (i / 2) % 2, the accumulator layout; the 4
// lanes of a row are adjacent) times each row's power of two mul[r],
// which drops first, with the row of the 64 x N accumulator `acc`, where
// the tile's |dS| of that row times mul[r] passes kDsMax
template <int N>
__device__ __forceinline__ void fit_f16_pr20(float (&ds)[32],
                                             float (&mul)[2],
                                             float (&acc)[N]) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], fabsf(ds[i]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float big = mx[r] * mul[r];
    if (big > kDsMax) {        // the same in the row's 4 lanes
      int e;
      frexpf(big / kDsMax, &e);            // big / kDsMax <= 2^e
      const float f = ldexpf(1.f, -e);
      mul[r] *= f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if ((i / 2) % 2 == r) acc[i] *= f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) ds[i] *= mul[(i / 2) % 2];
}

"""
_FIT_DQ = "    if constexpr (kIsHalf<T>) fit_f16_pr20(sc, ds_mul, dq_acc);\n"
_FIT_DKV = "    if constexpr (kIsHalf<T>) fit_f16_pr20(dp, ds_mul, dk_acc);\n"
_DQ_PLAIN = """#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - dlt[(i / 2) % 2];
"""
_DKV_PLAIN = """#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + col0 + (i % 2);
      dp[i] = sc[i] * (dp[i] - sm.delta[s][col]);
    }
"""
# the test on the packed values (`packed_test`): the f16 pairs'
# magnitudes by packed max in two chains, then bit 15 of each half plus
# 0x0800
_F16_BIG = """// f16 only, the guard's common path: whether any of this thread's 16
// packed f16 pairs holds a value of magnitude 2^15 or more (inf and NaN
// too). Any |dS| > kDsMax rounds to such a value, so where no lane of a
// warp finds one, no row of the warp needs a smaller factor. The pairs'
// magnitudes are reduced by packed max (HMNMX2 with |.|) in two chains
// (one register each: the words stay live as the next product's
// operand); a half of the max is >= 2^15 (bits 0x7800) when adding
// 0x0800 to it sets its bit 15 (no carry leaves a half: at most 0x7fff +
// 0x0800).
__device__ __forceinline__ bool f16_big(const uint32_t (&w)[16]) {
  const __half2* h = reinterpret_cast<const __half2*>(w);
  __half2 m0 = __habs2(h[0]);
  __half2 m1 = __habs2(h[1]);
#pragma unroll
  for (int i = 2; i < 16; i += 2) {
    m0 = __hmax2(m0, __habs2(h[i]));
    m1 = __hmax2(m1, __habs2(h[i + 1]));
  }
  const __half2 m = __hmax2(m0, m1);
  const uint32_t bits = *reinterpret_cast<const uint32_t*>(&m);
  return ((bits + 0x08000800u) & 0x80008000u) != 0u;
}

"""
# each design's code between a kernel's `fence_regs(dp);` after the score
# products and its accumulating products, by kernel
_REGIONS = {
    "fit_pr20": {"dq": _DQ_PLAIN + _FIT_DQ + "    pack<T>(da, sc);\n",
                 "dkv": _DKV_PLAIN + _FIT_DKV
                 + "    pack<T>(pa, sc);\n    pack<T>(da, dp);\n"},
    "no_fit": {"dq": _DQ_PLAIN + "    pack<T>(da, sc);\n",
               "dkv": _DKV_PLAIN + "    pack<T>(pa, sc);\n"
                      "    pack<T>(da, dp);\n"},
    "packed_test": {"dq": """    if constexpr (kIsHalf<T>) {
      // f16: each row's factor in the product that forms its dS (at
      // factor 1 the same rounding as below; a power of two is exact)
      const float ndlt[2] = {-dlt[0] * ds_mul[0], -dlt[1] * ds_mul[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        sc[i] *= fmaf(dp[i], ds_mul[r], ndlt[r]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - dlt[(i / 2) % 2];
    }
    pack<T>(da, sc);
    if constexpr (kIsHalf<T>) {
      // f16: one vote of the warp over its packed values; the fit and a
      // second packing where a value reaches 2^15, and on every tile once
      // a row of the warp is below factor 1
      if (__any_sync(0xffffffffu, scaled || f16_big(da))) {
        scaled = fit_f16(sc, ds_mul, dq_acc);
        pack<T>(da, sc);
      }
    }
""", "dkv": """#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + col0 + (i % 2);
      dp[i] = sc[i] * (dp[i] - sm.delta[s][col]);
    }
    pack<T>(pa, sc);
    pack<T>(da, dp);
    if constexpr (kIsHalf<T>) {
      // f16: the dQ kernel's guard, the rows' factors applied in it alone
      // (Delta is by column here, so in the product that forms dS^T they
      // would cost a multiply a value on every tile)
      if (__any_sync(0xffffffffu, scaled || f16_big(da))) {
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] *= ds_mul[(i / 2) % 2];
        scaled = fit_f16(dp, ds_mul, dk_acc);
        pack<T>(da, dp);
      }
    }
"""},}
_HELPERS = {"fit_pr20": _FIT_PR20, "packed_test": _F16_BIG}
# a kernel's region: from `fence_regs(dp);` (not crossing another) to its
# accumulating products
_REGION = {k: re.compile(r"(    fence_regs\(dp\);\n)((?:(?!fence_regs\(dp\)).)*?)"
                         rf"(    wgmma_fence\(\);\n    issue_{k}\(j\);)", re.S)
           for k in ("dq", "dkv")}
# where a held helper goes: before the kernels' store helper
_FIT_AT = "// rows `row0` and `row0 + 8` of a 64 x D accumulator"
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


# an info entry for the parent's kernels: the interface of the source's
# `paddle_flash_attention_bwd_info`
_PARENT_BWD_INFO = fv._INFO_HELPER + """
template <typename T, int D, bool C>
static int parent_bwd_info(int dkv, int* out) {
  if (dkv) {
    return static_cast<int>(variant_kernel_info(
        flash_bwd_dkv_kernel_wgmma<T, D, C>, kWgmmaThreads,
        static_cast<int>(sizeof(DkvSmem<D>)) + 1024, out));
  }
  return static_cast<int>(variant_kernel_info(
      flash_bwd_dq_kernel_wgmma<T, D, C>, kWgmmaThreads,
      static_cast<int>(sizeof(DqSmem<D>)) + 1024, out));
}

extern "C" int paddle_flash_attention_bwd_info(int dkv, int head_dim,
                                               int dtype, int causal,
                                               int* out) {
  if (dtype == 1) {
    if (head_dim == 64) {
      return causal ? parent_bwd_info<__nv_bfloat16, 64, true>(dkv, out)
                    : parent_bwd_info<__nv_bfloat16, 64, false>(dkv, out);
    }
    return causal ? parent_bwd_info<__nv_bfloat16, 128, true>(dkv, out)
                  : parent_bwd_info<__nv_bfloat16, 128, false>(dkv, out);
  }
  if (head_dim == 64) {
    return causal ? parent_bwd_info<__half, 64, true>(dkv, out)
                  : parent_bwd_info<__half, 64, false>(dkv, out);
  }
  return causal ? parent_bwd_info<__half, 128, true>(dkv, out)
                : parent_bwd_info<__half, 128, false>(dkv, out);
}
"""


def _parent(parent):
    """The parent commit's source, with an info entry appended where it has
    none of its own."""
    text = (parent / "flash_attention_bwd.cu").read_text()
    if "paddle_flash_attention_bwd_info" in text:
        return text
    return text + _PARENT_BWD_INFO


# timing-only probes of the D = 128 kernels (their outputs are wrong by
# design): the producer arrives on each streamed tile's full barrier
# without a copy (`probe_noload`: dK/dV's Q/dO tiles; `probe_dq_noload`:
# dQ's K/V tiles), or the consumers pack the score products as they come,
# with no exponentials, masks or dS (`probe_noelem`, `probe_dq_noelem`)
_NOLOAD_DKV = [(
    """            mbar_expect_tx(&sm.qg_full[s], 2 * kTileBytes);
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              tma_load(sm.q[s][p], &q_map, &sm.qg_full[s], p * kPanel, it.h,
                       t0, it.b);
              tma_load(sm.g[s][p], &g_map, &sm.qg_full[s], p * kPanel, it.h,
                       t0, it.b);
            }""", "            mbar_arrive(&sm.qg_full[s]);")]
_NOLOAD_DQ = [(
    """        mbar_expect_tx(&sm.kv_full[s], 2 * kTileBytes);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          tma_load(sm.k[s][p], &k_map, &sm.kv_full[s], p * kPanel, it.h,
                   j * kRows, it.b);
          tma_load(sm.v[s][p], &v_map, &sm.kv_full[s], p * kPanel, it.h,
                   j * kRows, it.b);
        }""", "        mbar_arrive(&sm.kv_full[s]);")]
# the D = 128 dK/dV kernel with the tile's 16 lse values this thread reads
# loaded into registers before its turn (`prefetch_lse`)
_PREFETCH_LSE = [(
    """        const bool edge = t0 + kRows > n || kw + kRows > m ||
                          (kCausal && t0 < kw + kRows);
""", """        const bool edge = t0 + kRows > n || kw + kRows > m ||
                          (kCausal && t0 < kw + kRows);
        float lse_t[16];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float2 v =
              *reinterpret_cast<const float2*>(&sm.lse2[s][8 * c + col0]);
          lse_t[2 * c] = v.x;
          lse_t[2 * c + 1] = v.y;
        }
"""), ("""          const int col = 8 * (i / 4) + col0 + (i % 2);
          sc[i] = ex2(fmaf(sc[i], scale_log2, -sm.lse2[s][col]));""",
       """          sc[i] = ex2(fmaf(sc[i], scale_log2, -lse_t[2 * (i / 4) + i % 2]));""")]
_ELEMENTWISE_DKV = re.compile(
    r"(        fence_regs\(sc\);\n)        if \(edge\) \{.*?"
    r"(        wgmma_wait<0>\(\);\n        fence_regs\(dp\);\n"
    r"        if \(j == it\.n_tiles - 1\) release_kv\(\);\n)"
    r"        if constexpr \(kIsHalf<T>\) \{.*?\n        \}\n"
    r"        pack<T>\(pa, sc\);", re.S)
_ELEMENTWISE_DQ = re.compile(
    r"(        fence_regs\(sc\);\n)        if \(edge\) \{.*?"
    r"(        wgmma_wait<0>\(\);\n        fence_regs\(dp\);\n"
    r"        if \(j == n_w - 1\) release_qg\(\);\n)"
    r"        if constexpr \(kIsHalf<T>\) \{.*?\n        \}\n"
    r"(        pack<T>\(da, sc\);)", re.S)
_DKV128 = "flash_bwd_dkv_kernel_wgmma_d128(const"
_DQ128 = "flash_bwd_dq_kernel_wgmma_d128(const"


def _in_kernel(src, kernel, pairs=(), pattern=None, repl=None):
    """`src` with each (old, new) text of `pairs` replaced once, or
    `pattern` substituted once by `repl`, within the definition of the
    kernel whose text starts `kernel` up to the next section rule."""
    at = src.index(kernel)
    end = src.find("\n// ----", at)
    end = len(src) if end < 0 else end
    body = src[at:end]
    for old, new in pairs:
        assert body.count(old) == 1, old
        body = body.replace(old, new)
    if pattern is not None:
        body, count = pattern.subn(repl, body)
        assert count == 1, count
    return src[:at] + body + src[end:]


def d128_variants(parent, extra=()):
    """name -> source text of the --d128 run; `extra`: (name, path) pairs
    of other versions of the source to build beside them."""
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    sub = fv._sub_const
    return {
        "parent": _parent(parent), "source": src,
        "stages3": sub(src, "kDkv128Stages", "3"),
        "no_pingpong": sub(src, "kDkv128PingPong", "false"),
        "grid": sub(src, "kDkv128Persistent", "false"),
        "prefetch_lse": _in_kernel(src, _DKV128, _PREFETCH_LSE),
        "dq_stages3": sub(src, "kDq128Stages", "3"),
        "dq_no_pingpong": sub(src, "kDq128PingPong", "false"),
        "dq_grid": sub(src, "kDq128Persistent", "false"),
        "dq_interleaved": sub(src, "kDq128HeadMajor", "false"),
        "dq_stores": sub(src, "kDq128TmaStore", "false"),
        "probe_noload": _in_kernel(src, _DKV128, _NOLOAD_DKV),
        "probe_noelem": _in_kernel(
            src, _DKV128, pattern=_ELEMENTWISE_DKV,
            repl=r"\1\2        pack<T>(pa, sc);"),
        "probe_dq_noload": _in_kernel(src, _DQ128, _NOLOAD_DQ),
        "probe_dq_noelem": _in_kernel(src, _DQ128, pattern=_ELEMENTWISE_DQ,
                                      repl=r"\1\2\3"),
        **{name: Path(path).read_text() for name, path in extra}}


def _bounds(src, dq, dkv):
    def sub(match):
        blocks = dq if match.group(2) == "dq" else dkv
        return f"__launch_bounds__(kWgmmaThreads, {blocks})\n{match.group(1)}"
    out, count = _BOUNDS.subn(sub, src)
    assert count == 2, count
    return out


def _sub(pattern, src, text, fn=None):
    out, count = pattern.subn(fn or (lambda _: text), src)
    assert count == 1, count
    return out


def _loops(src, kind):
    """`src` with both consumer loops written by `kind` (_pipelined or
    _sequence)."""
    return _sub(_DKV_LOOP, _sub(_DQ_LOOP, src, kind(*_DQ)), kind(*_DKV))


def _design(src, name):
    """`src` with both kernels' dS code written as design `name` (a key
    of _REGIONS) and the design's helper before the store helper."""
    for kernel, pattern in _REGION.items():
        src = _sub(pattern, src, None, lambda m, k=kernel: m.group(1)
                   + _REGIONS[name][k] + m.group(3))
    if name in _HELPERS:
        assert src.count(_FIT_AT) == 1
        src = src.replace(_FIT_AT, _HELPERS[name] + _FIT_AT)
    return src


def variants(half, parent):
    """name -> source text: in f16 (`half`) source, the other designs of
    the guard, source_free and no_fit; in bf16 source, the loop variants
    and no_fit; in both the parent's."""
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    pr20 = _design(src, "fit_pr20")
    out = {"source": src, "parent": _parent(parent)}
    if half:
        # the earlier designs under the bounds they were measured with
        out["fit_pr20"] = _bounds(_design(src, "fit_pr20"), "1", "1")
        out["packed_test"] = _design(src, "packed_test")
        # ptxas left free: every wgmma kernel under (160, 1)
        out["source_free"] = _bounds(src, "1", "1")
    else:
        piped1 = _loops(pr20, _pipelined)
        out.update(piped2=_bounds(piped1, "2", "D == 64 ? 2 : 1"),
                   piped1=piped1, sequence=_loops(pr20, _sequence),
                   dv_early=_sub(_DKV_LOOP, pr20, _DV_EARLY))
    out["no_fit"] = _bounds(_design(src, "no_fit"), "1", "1")
    return out


_SASS_OPS = ("HMNMX2", "VOTE", "SHFL", "FMNMX", "FMUL", "FFMA", "F2FP",
             "HGMMA", "BRA")


def _sass(name, lib):
    """Instructions of the f16 wgmma kernels of `lib` by mnemonic (those
    of _SASS_OPS), or a note where the toolkit has no cuobjdump."""
    tool = _build.toolkit_tool("cuobjdump")
    if tool is None:
        print(f"sass {name}: not available (no cuobjdump)")
        return
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    for part in sass.split("Function :")[1:]:
        head = part.splitlines()[0]
        found = re.search(r"flash_bwd_(dq|dkv)_kernel_wgmmaI6__halfLi(\d+)"
                          r"ELb(\d)", head)
        if not found:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z0-9_.]+)", part)
        counts = {op: sum(o.split(".")[0] == op for o in ops)
                  for op in _SASS_OPS}
        print(f"sass {name}: {found.group(1)} half D={found.group(2)} "
              f"causal={found.group(3)}: {len(ops)} instructions, "
              + ", ".join(f"{op} {n}" for op, n in counts.items()),
              flush=True)


def build(sources, parent):
    """Compile every variant at once (name -> text; ``parent`` against the
    parent's own header in directory `parent`); returns name -> loaded
    library."""
    paths = fv.build({name: (text, parent if name == "parent" else CSRC)
                      for name, text in sources.items()}, OUT,
                     r"(_Z\w*flash_bwd_\w*_kernel_wgmma\w*)")
    return {name: ctypes.CDLL(str(path)) for name, path in paths.items()}


def _outputs(args):
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    return dq, dk, dv


def _same_bits(libs, a, b, args, tag, strict=True):
    """Whether variants `a` and `b` give dQ, dK and dV of equal bits
    (`strict`: asserts it; else only prints how many elements differ)."""
    got = {}
    for name in (a, b):
        _build._LIBS["flash_attention_bwd"] = libs[name]
        got[name] = _outputs(args)
    differ = [int((x.view(torch.int16) != y.view(torch.int16)).sum())
              for x, y in zip(got[a], got[b])]
    print(f"bits {a} vs {b} {tag}: differing elements of dq, dk, dv "
          f"{differ} of {got[a][0].numel()} each", flush=True)
    assert not strict or differ == [0, 0, 0], (tag, differ)


def _drop_case(libs, train):
    """The training shape with dO times DROP_GAIN: how many rows pass 2^15,
    whether the twin's gradients fit in f16, source against fit_pr20 bit
    for bit (and against the twins where they fit), then the variants
    timed in turns."""
    args = cs._flash_bwd_inputs(*train, True, seed=12, gain=DROP_GAIN)
    _, _, _, _, ds = fa._bwd_probs(*args)
    big = ds.abs()
    rows_q = int((big.amax(-1) > 2.0 ** 15).sum())
    rows_k = int((big.amax(-2) > 2.0 ** 15).sum())
    ds_max = float(big.max())
    del ds, big
    refs = [fa.flash_attention_bwd_dq_reference(*args),
            *fa.flash_attention_bwd_dkv_reference(*args)]
    fits = all(float(r.float().abs().max()) < 65504.0 for r in refs)
    del refs
    tag = f"(8, 1024, 12, 64) causal, dO x {DROP_GAIN}"
    print(f"drop case {tag}: max |dS / scale| {ds_max:.1f}; rows past 2^15: "
          f"{rows_q} query rows (dQ), {rows_k} key rows (dK) of "
          f"{8 * 12 * 1024} each; the twin's dq, dk, dv "
          f"{'fit' if fits else 'do not fit'} in f16", flush=True)
    if fits:
        for name in ("source", "fit_pr20"):
            _build._LIBS["flash_attention_bwd"] = libs[name]
            cs._check_flash_bwd_case(f"{name} {tag}", *train, True, seed=12,
                                     gain=DROP_GAIN)
    _same_bits(libs, "source", "fit_pr20", args, tag)
    for name in list(libs) + list(libs)[::-1]:
        _build._LIBS["flash_attention_bwd"] = libs[name]
        dq = cs._timed(lambda: fa.flash_attention_bwd_dq(*args), iters=50)[0]
        dkv = cs._timed(lambda: fa.flash_attention_bwd_dkv(*args),
                        iters=50)[0]
        print(f"time {name} {tag}: dq {dq:.5f} ms, dkv {dkv:.5f} ms"
              + (" (outputs not finite: no guard)" if name == "no_fit"
                 else ""), flush=True)


def _sdpa_bwd(args):
    """A function that runs SDPA's backward (dQ, dK and dV in one call) on
    the case's q, k, v and dO (causal as the case's)."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in args[:3])
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=args[6])
    do = args[3].transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), do,
                                       retain_graph=True)


# the --d128 run's in-turns timings: (shape, causal, dtype). Config 3's
# shape, then every main-path shape of the D = 64 kernels (GPT-2
# training, ViT-L/16, f16 training), whose code the variants share
TIMED_D128 = ((fv.GPT3, True, torch.bfloat16),
              (fv.GPT2, True, torch.bfloat16),
              ((32, 197, 16, 64), False, torch.bfloat16),
              (fv.GPT2, True, torch.float16),
              (fv.GPT3, True, torch.float16))


def time_turns(libs, timed, iters=50):
    """dQ and dK/dV of every library at each case of `timed` ((shape,
    causal, dtype)), in turns (each, then in reverse), SDPA's backward (dQ,
    dK and dV in one call) beside each."""
    for shape, causal, dtype in timed:
        b, n, h, d = shape
        qkv = cs._fused_qkv(n, dtype, seed=n + d, heads=h, head_dim=d,
                            batch=b)
        args = cs._flash_bwd_inputs(*qkv, causal, seed=n + d + 1)
        sdpa = _sdpa_bwd(args)
        pairs = b * h * (n * (n + 1) // 2 if causal else n * n)
        bounds = [cs._flash_bwd_bound(b, n, h, d, 2, causal, dkv)[0]
                  for dkv in (False, True)]
        for name in list(libs) + list(libs)[::-1]:
            _build._LIBS["flash_attention_bwd"] = libs[name]
            dq = cs._timed(lambda: fa.flash_attention_bwd_dq(*args),
                           iters=iters)[0]
            dkv = cs._timed(lambda: fa.flash_attention_bwd_dkv(*args),
                            iters=iters)[0]
            lib = cs._timed(sdpa, iters=iters)[0]
            print(f"time {name} {shape} {str(dtype)[6:]} causal={causal}: "
                  f"dq {dq:.5f} ms "
                  f"({6 * d * pairs / (dq * 1e-3) / 1e12:.1f} TFLOP/s, "
                  f"{bounds[0] / dq:.3f} of its bound), dkv {dkv:.5f} ms "
                  f"({8 * d * pairs / (dkv * 1e-3) / 1e12:.1f} TFLOP/s, "
                  f"{bounds[1] / dkv:.3f} of its bound), pair "
                  f"{dq + dkv:.5f} ms; SDPA's backward {lib:.5f} ms: "
                  f"{(dq + dkv) / lib:.3f}x", flush=True)
        del sdpa, args


def check_d128(name):
    """dQ and dK/dV of library `name` against their fp32 twins at D = 128
    over the 128-key tiles' edges (chip_smoke.py's criteria), f16 too with
    the dS guard's large-dO cases, and twice bit for bit at config 3's
    shape."""
    _build._LIBS["flash_attention_bwd"] = ctypes.CDLL(
        str(OUT / f"lib{name}.so"))
    bf16, d = torch.bfloat16, 128
    for n in (65, 129, 200, 2047):
        for causal in (True, False):
            cs._check_flash_bwd_case(
                f"{name} n={n} causal={causal} D=128",
                *cs._fused_qkv(n, bf16, seed=500 + n, heads=4, head_dim=d),
                causal, seed=n)
    q = cs._fused_qkv(40, bf16, seed=51, heads=4, head_dim=d)[0]
    _, k, v = cs._fused_qkv(300, bf16, seed=52, heads=4, head_dim=d)
    cs._check_flash_bwd_case(f"{name} n=40 m=300 causal=False D=128", q, k,
                             v, False, seed=53)
    cs._check_flash_bwd_case(f"{name} (3, 200, 4, 128) causal=True",
                             *cs._fused_qkv(200, bf16, seed=54, heads=4,
                                            head_dim=d, batch=3), True,
                             seed=55)
    for causal in (True, False):
        cs._check_flash_bwd_case(f"{name} (8, 1000, 16, 128) causal={causal}",
                                 *cs._fused_qkv(1000, bf16, seed=58,
                                                heads=16, head_dim=d,
                                                batch=8), causal, seed=59)
    for causal in (True, False):
        cs._check_flash_bwd_case(
            f"{name} float16 n=200 causal={causal} D=128",
            *cs._fused_qkv(200, torch.float16, seed=56, heads=4, head_dim=d),
            causal, seed=57)
    cs._check_f16_large_do(head_dim=d)
    b, n, h, d = fv.GPT3
    args = cs._flash_bwd_inputs(
        *cs._fused_qkv(n, bf16, seed=2048, heads=h, head_dim=d, batch=b),
        True, seed=2049)
    cs._check_flash_bwd_case(f"{name} {fv.GPT3} causal",
                             *args[:3], True, seed=2049)
    cs._twice_equal(f"{name} {fv.GPT3} dkv",
                     lambda: fa.flash_attention_bwd_dkv(*args))
    cs._twice_equal(f"{name} {fv.GPT3} dq",
                     lambda: [fa.flash_attention_bwd_dq(*args)])


def _bits_d128(libs):
    """Source's dQ, dK and dV against the parent's, bit for bit, at config
    3's shape, causal: bf16, f16, and f16 with dO times DROP_GAIN_D128
    (rows drop their dS factor: how many is printed). Printed, not
    asserted."""
    b, n, h, d = fv.GPT3
    for dtype, gain in ((torch.bfloat16, 1.0), (torch.float16, 1.0),
                        (torch.float16, DROP_GAIN_D128)):
        qkv = cs._fused_qkv(n, dtype, seed=2048, heads=h, head_dim=d,
                            batch=b)
        args = cs._flash_bwd_inputs(*qkv, True, seed=2049, gain=gain)
        tag = f"{fv.GPT3} {str(dtype)[6:]} causal, dO x {gain}"
        if gain != 1.0:
            ds = fa._bwd_probs(*args)[4].abs()
            print(f"drop case {tag}: max |dS / scale| {float(ds.max()):.1f};"
                  f" {int((ds.amax(-1) > 2.0 ** 15).sum())} query rows of "
                  f"{b * h * n} past 2^15", flush=True)
            del ds
        _same_bits(libs, "source", "parent", args, tag, strict=False)
        del args, qkv


def main_d128(parent, extra):
    libs = build(d128_variants(parent, extra), parent)
    for name, lib in libs.items():
        fv.print_info(name, lib, "paddle_flash_attention_bwd_info",
                      [(dkv, dd, 1, 1) for dkv in (0, 1) for dd in (64, 128)]
                      + [(dkv, 128, 2, 1) for dkv in (0, 1)]
                      + [(dkv, 128, 1, 0) for dkv in (0, 1)])
    passed = fv.run_checks([k for k in libs if not k.startswith("probe_")],
                           script=__file__)
    if "source" in passed and "parent" in passed:
        _bits_d128(libs)
    time_turns({k: libs[k] for k in libs
                if k in passed or k.startswith("probe_")}, TIMED_D128)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float16"))
    parser.add_argument("--d128", action="store_true")
    parser.add_argument("--parent", default=str(fv.PARENT))
    parser.add_argument("--parent-rev", default="HEAD~1")
    parser.add_argument("--check")
    parser.add_argument("--extra", action="append", default=[])
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if opts.check:
        check_d128(opts.check)
        return
    print(f"card: {cs._card()}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)
    parent = fv.parent_dir(opts.parent, opts.parent_rev)
    if opts.d128:
        main_d128(parent, [item.split("=", 1) for item in opts.extra])
        _build._LIBS.pop("flash_attention_bwd")
        return
    half = opts.dtype == "float16"
    libs = build(variants(half, parent), parent)
    if half:
        for name in libs:
            _sass(name, OUT / f"lib{name}.so")
    dtype = torch.float16 if half else torch.bfloat16
    name16 = str(dtype)[6:]
    train = cs._fused_qkv(1024, dtype, seed=11, batch=8)
    for name, lib in libs.items():
        _build._LIBS["flash_attention_bwd"] = lib
        cs._check_flash_bwd_case(f"{name} n=65 causal",
                                 *cs._fused_qkv(65, dtype, seed=95), True)
        cs._check_flash_bwd_case(f"{name} D=128 n=200",
                                 *cs._fused_qkv(200, dtype, seed=32, heads=4,
                                                head_dim=128), False)
        cs._check_flash_bwd_case(f"{name} (8, 1024, 12, 64) causal", *train,
                                 True, seed=12)
    args = cs._flash_bwd_inputs(*train, True, seed=12)
    if half:
        _same_bits(libs, "source", "fit_pr20", args, "(8, 1024, 12, 64) "
                   "causal")
    sdpa = _sdpa_bwd(args)
    order = list(libs) + list(libs)[::-1]
    for name in order:
        _build._LIBS["flash_attention_bwd"] = libs[name]
        dq = cs._timed(lambda: fa.flash_attention_bwd_dq(*args), iters=50)[0]
        dkv = cs._timed(lambda: fa.flash_attention_bwd_dkv(*args),
                        iters=50)[0]
        lib = cs._timed(sdpa, iters=50)[0]
        print(f"time {name} (8, 1024, 12, 64) {name16} causal: dq "
              f"{dq:.5f} ms, dkv {dkv:.5f} ms, pair {dq + dkv:.5f} ms; "
              f"SDPA's backward {lib:.5f} ms: {(dq + dkv) / lib:.3f}x",
              flush=True)
    del sdpa
    if half:
        _drop_case(libs, train)
    time_turns(libs, ((fv.GPT3, True, dtype),
                      ((8, 1024, 6, 128), True, dtype)))
    _build._LIBS.pop("flash_attention_bwd")


if __name__ == "__main__":
    main()
