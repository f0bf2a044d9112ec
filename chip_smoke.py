"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. probe   — a CUDA device must exist; print its name and power limit;
  2. build   — compile every kernel of the serving and training paths with
               nvcc into build/paddle_tpu_torch/ (all sources at once,
               the earlier designs kept in tools/ beside them) and
               print the build time and ptxas' register / spill report by
               kernel entry (the paged decode kernel with and without the
               decode write),
               the flash forward's and backward's counts of HGMMA
               (wgmma) and UTMALDG (TMA load) instructions in their SASS,
               the paged decode kernels' count of LDGSTS (cp.async,
               the 16-byte copies its design keeps in flight) and the
               keyed draw's INT32 instructions where cuobjdump exists;
  3. kernels — hold each kernel against its plain PyTorch twin on the card
               at its paths' shapes (the flash forward at the serving and
               the training shape) and at ragged ones, batched and not, in
               fp32 (TF32 off) and bf16, within the tolerances stated
               below; time
               the kernel, the twin and one PyTorch library call that
               computes the same function (a yardstick the port never
               calls), beside the least time the card could take; a bf16
               flash backward whose dO TMA cannot read must raise; paged
               decode also at lengths around its split boundaries and
               timed at the serve mix's ragged lengths; the fused decode
               step (the paged kernel writing this step's K and V rows
               before it attends, fp and int8 pools) against its twin
               composition over 50 launches: pools (int8 levels and
               scales) bit for bit on every block but null block 0, block
               0 untouched, the output within PAGED_TOL and bit for bit
               the paged kernel's alone, at write offsets 0, 1, 15 and
               mid-block, the table's end, with inactive slots and reused
               blocks; timed in turns with the paged kernel alone; the
               sampler's keyed draw at S=8, V=50257 and V=50304 over
               rounds of fresh seeds and positions, greedy and sampled
               slots: random bits and noise bit for bit, and the tokens
               of a debug launch and of the decode step's launch equal
               the twin's at every slot (the twin runs on the CPU on
               copies of the inputs), timed in turns with the first
               design (commit e4c03f5,
               tools/torch_keyed_draw_one_cta.cu); the sampler's filter
               (penalty, temperature, top-k and top-p thresholds) at S=8,
               V=50257 and 50304 on the serve mix's configs, a ragged
               set and a set whose candidates overflow: greedy rows
               untouched, sampled rows bit for bit with the twin (on the
               CPU, on copies) outside the stated top-p margin, and
               inside it (the rows counted, at most an eighth) the row
               cut at a threshold the margin allows, each row's route
               (candidates, overflow, radix) the one `filter_routes`
               gives, every route reached; timed in turns with the
               first design (commit c3b6374,
               tools/torch_sampler_filter_radix.cu) at 2 and 8 of 8 rows
               sampled and on top-p-only rows;
               the multi-tensor AdamW update at GPT-2 124M's 148 tensors
               (bf16 parameters, fp32 masters and moments) and on ragged
               lists (fp32 and bf16 without masters, aligned and
               misaligned, a decay-skip set): parameters, masters and
               moments bit for bit with the twin over 3 steps, timed
               beside PyTorch's fused AdamW (another formula); the
               prompt's K/V scatter (every layer in one launch, fp and
               int8 pools) at buckets 16, 128 and 1024 with the forward's
               strided views, lengths 1, 15, 16, 17, 128, 990 and 1024, a
               block row with spare and null entries over pools that hold
               a previous tenant's bytes and scales, and int8 pools at
               head_dim 128 and 32-token blocks: pools and scales bit for
               bit on every block but 0, block 0 untouched, timed at a
               full 1024 bucket in turns with the first design (commit
               c3b6374, tools/torch_prefill_scatter_twopass.cu);
  4. serve   — GPT-2 124M (full width, random weights from a seed, bf16)
               behind `LLMEngine`, whose decode step is one CUDA graph
               replay: one build of it (decode_compiles) in the warm-up,
               none in the counted window of 19 requests (16 greedy, 2
               sampled, one 990-token prompt so the 1024 bucket runs),
               more requests than slots, then the same mix again (the
               warm pass); each prefill is one replay of its bucket's CUDA
               graph (the flash kernel 12 x, the K/V scatter once) and one
               of a sampler head's, each bucket built at its first prompt
               (prefill_compiles: one a bucket the pass reached first,
               none in the warm pass; a build's eager warm-up launches
               the bucket's kernels once more), each decode replay the
               fused paged kernel (write + attention) 12 x and the paged
               kernel alone never (counted per replay); the prefill
               graphs' reserved memory; then the decode
               graph against the eager step: a second engine stepping
               `_decode_step_eager`, both in turns for 20 steps over 8
               requests, with equal greedy tokens at every step (the
               logits' difference and both step p50s printed), and 4
               decode steps of 8 full slots of each engine under
               torch.profiler (device time by kernel group, kernels a
               step, busy share); then the prefill graphs against the
               eager prefill (`_prefill_eager`) on a second engine, in
               turns at each bucket 16-1024, 20 prompts a bucket a turn:
               sampled tokens, logprobs and pools (levels and scales)
               equal on every block but 0, the logits' difference and
               both prefill p50s printed, and 4 prefills of each engine
               at buckets 16 and 1024 under torch.profiler;
               Each decode step samples inside its graphs (the keyed draw
               once a replay and once a prefill, the filter once a
               full-head replay and once a sampled prefill): the full
               sampler head where a slot samples, the greedy head
               elsewhere, and both must run in the counted window;
  4b. serve_int8 — the same model and request mix through
               `LLMEngine(..., kv_dtype="int8")`: the fused int8 paged
               kernel 12 x per replay and the fp one never,
               the same graph-vs-eager check; prints its latencies,
               its greedy-token agreement with the bf16 run (a number, not
               a gate) and the streams each pool admits at the bf16
               engine's pool bytes;
  4c. serve_pipelined — `LLMEngine(pipeline_decode=True)` against an
               unpipelined engine on the serve mix, bf16 pools, then int8
               pools: greedy and sampled tokens bitwise equal, one decode
               build each, no rollback on a clean drain, the keyed draw
               once a replay; a cancel between launch and commit rolls
               back one token and leaks none; then both engines in turns
               (step p50/p99, decode tok/s) and the sampler's share of a
               replayed step: the full head alone timed in turns with PR
               10's (the sort-based filter and the one-CTA draw) and
               profiled, with no radix sort and no scan kernel;
  5. parity  — the same fp32 model on the card and on the CPU (the plain
               twins) must give identical greedy tokens for two prompts
               and agree on the prompts' logits; then the same with int8
               KV on both sides (tokens only);
  6. train   — GPT-2 124M (full width, random weights from seed 0, bf16,
               dropout 0) with AdamW(multi_precision) through `TrainStep`
               on a batch of 8 x 1024 tokens, FLAGS_use_fused_cross_entropy
               on: first one forward and backward with the flag off and one
               with it on must agree (loss, wte gradient); then two models
               from one seed, one replaying the step's CUDA graph, one
               stepping `_step_eager`: 3 steps each with equal losses and
               every parameter, master and moment bit for bit; 4 steps
               under LinearWarmup(CosineAnnealingDecay), lr changing every
               replay, one graph build, losses still equal; 5 measured
               graph steps asserting each kernel's launches a step (the
               update once), a finite first loss near ln(V) and a falling
               loss; then graph and eager in turns (step p50, device time
               a step, tokens/s, MFU), each one's peak memory and a
               profiled step of each (device time by kernel group, kernels
               a step);
  7. train parity — 3 fp32 `TrainStep`s of a 2-layer full-width GPT-2 on
               the card (one graph build, replayed) and on the CPU from one
               state dict must agree: losses, and parameters element by
               element;
  8. fused_ln — `incubate.nn.FusedBiasDropoutResidualLayerNorm(768)` in
               bf16 on [8, 1024, 768] activations, forward and backward
               for some iterations, one fused_ln launch per forward; then
               its fp32 output and five gradients on the card against the
               CPU's.

The kernels phase covers the serving kernels (flash forward, paged decode
with fp and with int8 pools, alone and with the decode write, the keyed
draw, the sampler's filter, the prompt's K/V scatter), the
training kernels (flash backward dQ and dK/dV, fused cross-entropy forward
and backward, the AdamW update) and the fused bias-residual LayerNorm
within FLASH_TOL / PAGED_TOL / PAGED_INT8_TOL / CE_LOSS_TOL / CE_GRAD_TOL /
LN_TOL (the decode write, the scatter and the update exactly), and the
bf16 flash forward and backward within their own
stated criteria (kept beside the kernels in
`paddle_tpu_torch/kernels/flash_attention.py`). The script then prints one
JSON line with every kernel's numbers, the card's nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import ctypes
import json
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from paddle_tpu_torch.framework import set_flags
from paddle_tpu_torch.incubate.models import (GPTForCausalLM,
                                              GPTPretrainingCriterion,
                                              gpt2_124m)
from paddle_tpu_torch.incubate.nn import FusedBiasDropoutResidualLayerNorm
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import (_build, cross_entropy as ce,
                                      flash_attention as fa, fused_ln as fln,
                                      launch_counts, paged_attention as pa,
                                      reset_launch_counts)
from paddle_tpu_torch.kernels import adam_update as au
from paddle_tpu_torch.kernels import keyed_draw as kd
from paddle_tpu_torch.kernels import kv_append as kva
from paddle_tpu_torch.kernels import prefill_scatter as ps
from paddle_tpu_torch.kernels import sampler_filter as sf
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay, LinearWarmup
from paddle_tpu_torch.serving import sampling as tsamp
from paddle_tpu_torch.serving import (LLMEngine, Request,
                                      num_blocks_for_bytes,
                                      pool_bytes_per_block)
from paddle_tpu_torch.serving.engine import _slot_views
from paddle_tpu_torch.serving.sampling import sample_tokens

# published H100 SXM peaks (NVIDIA data sheet, dense): memory rate and the
# rate of each input type (bf16 on the tensor cores; fp32 off them, TF32
# being off)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# (atol, rtol) of kernel vs plain twin on the card, same inputs.
#   fp32: both sides compute in fp32 and differ only in summation order
#         (tile-wise online softmax vs one softmax and a matmul) and in
#         exp/log rounding: ~1e-6 relative, held at 1e-4.
#   bf16: both sides compute in fp32 from the same bf16 inputs and round
#         the output to bf16 once, so one rounding flip is allowed: one
#         bf16 step, at most 2^-7 of the value (rtol 8e-3); atol 1e-3 only
#         absorbs values near 0, whose step lies far below it.
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 8e-3)}
# flash forward, bf16 (the tensor-core design): P is rounded to bf16 on
# the tensor cores, so the forward has its own bf16 criteria, kept beside
# the kernel (`fa.flash_fwd_bf16_tol`, atol 2^-8 max|v| and rtol 8e-3, and
# the relative Frobenius error at most `fa.FLASH_FWD_BF16_FRO_RTOL`, 4e-3)
# and shared with its CPU tests. fp32 inputs keep FLASH_TOL's (1e-4, 1e-4):
# that kernel rounds nothing to bf16. FLASH_TOL itself is not widened.
# The bf16 flash forward before the tensor-core design (the fp32-FMA
# kernel of commit b9d5dfc): device ms per launch at the two main-path
# shapes in three runs of this script (PERF.md section 6, row #1's figures
# in brackets; NVIDIA H100 80GB HBM3, 700 W). Written in and printed on a
# line of its own, never in the kernels line: not measured again.
FLASH_FWD_PREV_MS = {"serve (1, 1024, 12, 64)": [0.3275, 0.3262, 0.3279],
                     "train (8, 1024, 12, 64)": [1.2638, 1.2653, 1.2724],
                     "source": "fp32-FMA forward of commit b9d5dfc, PERF.md "
                               "section 6, NVIDIA H100 80GB HBM3, 700 W"}
# the training step's flash_attention_fwd group with that kernel (PERF.md
# section 5, the same card): device ms per step
TRAIN_FWD_GROUP_PREV_MS = 15.175
# The bf16 flash backward before the tensor-core design (the fp32-FMA
# kernels of commit 6391f68): device ms per launch at the training shape
# in three runs of this script, and the training step's two groups (PERF.md
# sections 5 and 6; NVIDIA H100 80GB HBM3, 700 W). Written in and printed
# on a line of their own, never in the kernels line: not measured again.
FLASH_BWD_PREV_MS = {"dq (8, 1024, 12, 64)": [1.4927, 1.5029, 1.4982],
                     "dkv (8, 1024, 12, 64)": [1.6448, 1.6379, 1.6435],
                     "source": "fp32-FMA backward of commit 6391f68, PERF.md "
                               "section 6, NVIDIA H100 80GB HBM3, 700 W"}
TRAIN_BWD_GROUPS_PREV_MS = {"flash_attention_bwd_dq": 18.115,
                            "flash_attention_bwd_dkv": 19.775}
# The paged decode kernel before the split-K design (one CTA per (head,
# slot), commit 3dd19f6): device ms per launch of rows #4 (bf16 pools) and
# #4b (int8 pools) at S=8, lens 1023, H=12, D=64, bs=16 in three runs of
# this script (PERF.md section 6; NVIDIA H100 80GB HBM3, 700 W). Written in
# and printed on a line of its own, never in the kernels line: not
# measured again here (tools/torch_paged_decode_variants.py times both
# designs in turns).
PAGED_PREV_MS = {"paged_decode": [0.02881, 0.02865, 0.02869],
                 "paged_decode_int8": [0.02966, 0.02960, 0.02961],
                 "source": "one CTA per (head, slot), commit 3dd19f6, "
                           "PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W"}
# the serve mix's ragged lengths (an empty history, one position before /
# at / after a block boundary, a long and a full context, an inactive
# slot), checked and timed beside the full 1024-token contexts
PAGED_RAGGED_LENS = [0, 15, 16, 17, 500, 1023, 700, 0]
PAGED_TOL = FLASH_TOL
# int8 pools: kernel and twin dequantize the same int8 levels under the
# same scales in fp32 (q * (scale * (1/127)), one rounding each), so the
# rest is the fp case: summation order, and one bf16 rounding of the output
PAGED_INT8_TOL = PAGED_TOL
# fused LayerNorm, kernel vs twin on the same inputs: fp32 statistics on
# both sides in another summation order, rsqrtf's 2 ulp and FMA contraction
# (~1e-6 relative of outputs up to ~10 in fp32), plus one bf16 rounding of
# the output in bf16 — the flash kernels' reasoning
LN_TOL = FLASH_TOL
# fused_ln phase, card vs CPU in fp32: the backward is the same PyTorch
# formula on both devices, so only summation order differs. Per-element
# gradients (x, residual, output) hold 1e-4; the bias, scale and shift
# gradients are sums over 8192 rows of terms ~1 (~90 in size), whose
# order-only error is ~sqrt(8192) * 2^-24 * 90 ~ 5e-4 at worst typical
LN_GRAD_TOL = (1e-4, 1e-4)
LN_PARAM_GRAD_TOL = (2e-3, 1e-4)
# serve_int8: the same pool bytes must admit at least this many times the
# bf16 engine's streams (1 byte per element against 2, less the scales)
INT8_CAPACITY_MIN = 1.8
# the keyed draw against its twin: the random bits and the noise must be
# bit-identical (both evaluate XLA's float32 log with single roundings and
# the same fused multiply-adds), so the scores are too, and every token
# must be equal (both take the first index of the largest score). The
# slots whose winning margin (best minus second-best score) is at most
# KEYED_MARGIN are counted and printed, and held all the same
KEYED_MARGIN = 1e-4
KEYED_ROUNDS = 6
KEYED_SLOTS, KEYED_VOCABS = 8, (50257, 50304)
# lse is fp32 on both sides whatever the input type
LSE_TOL = (1e-4, 1e-4)
# flash backward, fp32: the FMA kernels and the twins recompute P in fp32
# from the same lse and Delta and accumulate in fp32; they differ only in
# summation order (1e-4). bf16 (the tensor-core design): P and dS are
# rounded to bf16 as tensor-core operands, so the bf16 backward has its own
# criteria, kept beside the kernels (`fa.flash_bwd_bf16_tol`: atol twice
# the largest rounding bound of each of dQ, dK, dV, rtol 8e-3; and the
# relative Frobenius error of each at most `fa.FLASH_BWD_BF16_FRO_RTOL`,
# 5e-3) and shared with its CPU tests. FLASH_BWD_TOL is not widened; its
# bf16 entry is no longer used.
FLASH_BWD_TOL = FLASH_TOL
# cross-entropy loss and lse are fp32 on both sides whatever the input
# type: one logsumexp over up to 50304 terms summed in another order
# (~1e-6 relative of ~11)
CE_LOSS_TOL = (5e-5, 1e-5)
# dlogits from the same lse on both sides: exp rounding only (fp32), plus
# one bf16 rounding of the output (bf16)
CE_GRAD_TOL = {torch.float32: (1e-6, 1e-5), torch.bfloat16: (1e-6, 8e-3)}
# train phase, bf16: the unfused path rounds the log-softmax to bf16 per
# element (~0.04 at ln V) and the loss to one bf16 step (0.0625 at 8-16);
# the fused path keeps both in fp32
TRAIN_FLAG_LOSS_ATOL = 0.1
# relative Frobenius error of the wte gradient between the two routes:
# the unfused path's softmax comes from bf16 log-probabilities (a few %
# per element), averaged over 8192 rows and dominated by the exact
# one-hot part
TRAIN_FLAG_GRAD_RTOL = 3e-2
TRAIN_LR = 1e-4
# train parity, fp32 card vs CPU over 3 steps: the losses and parameters
# differ by summation order only (1e-5, where an AdamW step moves an
# element by about lr = 1e-4, so a skipped or mis-signed update fails).
# An element whose gradient is within rounding of 0 may still step the
# other way on one side, by at most 2 * lr per step: such elements may
# make up at most TRAIN_PARITY_FLIP_SHARE of all.
TRAIN_PARITY_LOSS_ATOL = 1e-4
TRAIN_PARITY_STEPS = 3
TRAIN_PARITY_PARAM_ATOL = 1e-5
TRAIN_PARITY_FLIP_ATOL = 2 * TRAIN_LR * TRAIN_PARITY_STEPS
TRAIN_PARITY_FLIP_SHARE = 1e-5
# the update kernel against its twin: the same fp32 operations in the same
# order, none contracted into an FMA, and powf on both sides, so parameters,
# masters and moments must be equal bit for bit
ADAM_TOL = 0.0
# the lr of the check's three steps (a warm-up ramp)
ADAM_LRS = (1e-5, 5e-5, 1e-4)
# fp32 logits of GPT-2 124M on the card (TF32 off) vs the CPU: summation
# order only, through 12 layers
LOGITS_ATOL = 5e-4
# a greedy token counts as decided when its top-2 logprob margin exceeds
# this many times LOGITS_ATOL (parity prompts are chosen so all are)
MARGIN_FACTOR = 4

HEADS, HEAD_DIM = 12, 64


def _sass_counts(name, ops):
    """Count the SASS lines of library `name` that hold each instruction in
    `ops`, to show what the binary runs on; each must be there. Prints "not
    available" where the toolkit has no cuobjdump."""
    tool = _build.toolkit_tool("cuobjdump")
    if tool is None:
        print(f"build: SASS of {name}: not available (no cuobjdump)")
        return
    sass = subprocess.run([tool, "-sass", str(_build.lib_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout.splitlines()
    counts = {op: sum(op in line for line in sass) for op in ops}
    print(f"build: SASS of {name}: " + ", ".join(
        f"{n} lines with {op}" for op, n in counts.items()))
    assert all(counts.values()), counts


def _sass_int_ops(name, entry):
    """The INT32 instructions in the SASS of kernel `entry` (a substring of
    its mangled name) of library `name`, by mnemonic, and the funnel
    shifts (SHF.L.W: one a threefry round, so their count over 20 is the
    threefry copies the code holds). Prints "not available" where the
    toolkit has no cuobjdump."""
    tool = _build.toolkit_tool("cuobjdump")
    if tool is None:
        print(f"build: SASS of {name}: not available (no cuobjdump)")
        return
    sass = subprocess.run([tool, "-sass", str(_build.lib_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    body = next(part for part in sass.split("Function :")[1:]
                if entry in part.splitlines()[0])
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     body)
    ints = {}
    for op in ops:
        base = op.split(".")[0]
        if base in ("IADD3", "LOP3", "SHF", "IMAD", "ISETP", "LEA", "SEL",
                    "IABS", "IMNMX", "PRMT", "SGXT"):
            ints[base] = ints.get(base, 0) + 1
    rounds = sum(op.startswith("SHF.L.W") for op in ops)
    print(f"build: SASS of {name} {entry}: {len(ops)} instructions, INT32 "
          f"{sum(ints.values())} ({json.dumps(ints)}), {rounds} SHF.L.W "
          f"(threefry rounds: {rounds / 20:.1f} copies of 20)")


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_SLEEP_CYCLES_PER_S = []


def _sleep_cycles_per_s():
    """Clock cycles per second of `torch.cuda._sleep`, measured once."""
    if not _SLEEP_CYCLES_PER_S:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_S.append(1e7 / (start.elapsed_time(end) / 1e3))
    return _SLEEP_CYCLES_PER_S[0]


def _timed(fn, iters=20, warmup=3):
    """``(device ms, host ms)`` per call of fn() over `iters` back-to-back
    calls. The device first spins in a sleep kernel long enough for the
    host to enqueue every call, so the time between the two events is the
    calls' device work alone, not the gaps in which a device that is
    faster than its host waits for the next launch; host ms is the time
    the host took to enqueue one call meanwhile."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_sleep_cycles_per_s() * (2 * iters * once_s
                                                    + 2e-3)))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def _cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over `iters` back-to-back calls (`_timed`)."""
    return _timed(fn, iters, warmup)[0]


def _bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_fwd_tol(v):
    """(atol, rtol) of the flash forward against its fp32 twin, for inputs
    of v's type: the bf16 kernel's own criterion, else FLASH_TOL."""
    if v.dtype == torch.bfloat16:
        return fa.flash_fwd_bf16_tol(v)
    return FLASH_TOL[v.dtype]


def _close(name, got, want, tol):
    atol, rtol = tol
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol, msg=lambda m: f"{name}: {m}")
    print(f"  {name}: max_abs_err {err:.3e} (atol {atol}, rtol {rtol})")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain twins
# ---------------------------------------------------------------------------

def _fused_qkv(n, dtype, seed, heads=HEADS, head_dim=HEAD_DIM, batch=1):
    """q, k, v as strided views of one [B, n, 3, H, D] tensor, the layout
    the model's fused projection hands the flash kernel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((batch, n, 3, heads, head_dim), generator=g,
                      device="cuda").to(dtype)
    return qkv.unbind(2)


def _check_flash_case(tag, q, k, v, causal):
    """The forward against its twin: out within `flash_fwd_tol`, in bf16
    also within fa.FLASH_FWD_BF16_FRO_RTOL, lse within LSE_TOL."""
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    err = _close(tag + " out", out, ref, flash_fwd_tol(v))
    if q.dtype == torch.bfloat16:
        fro = fa.rel_fro(out, ref)
        print(f"  {tag} out: relative Frobenius error {fro:.3e} (at most "
              f"{fa.FLASH_FWD_BF16_FRO_RTOL})")
        assert fro <= fa.FLASH_FWD_BF16_FRO_RTOL, (tag, fro)
    _close(tag + " lse", lse, ref_lse, LSE_TOL)
    return err


def _offset_qkv(n, seed, heads=HEADS, head_dim=HEAD_DIM):
    """q, k, v as views of one bf16 buffer whose rows are 3 * H * D + 16
    elements: q at offset 0, k at H * D + 8 and v at 2 * H * D + 16
    elements, so k and v start 16-byte aligned but off the buffer's own
    alignment."""
    width = heads * head_dim
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn((1, n, 3 * width + 16), generator=g,
                      device="cuda").to(torch.bfloat16)
    return tuple(buf[..., off:off + width].view(1, n, heads, head_dim)
                 for off in (0, width + 8, 2 * width + 16))


def _flash_flops(b, n):
    """4 * D FLOPs per unmasked (query, key) pair, causal, H heads."""
    return 4 * b * HEADS * HEAD_DIM * (n * (n + 1) // 2)


def _time_flash(q, k, v, err):
    """The forward's numbers at one causal bf16 shape: kernel, twin and
    SDPA times, its bound and achieved TFLOP/s."""
    b, n = q.shape[:2]
    ms, host_ms = _timed(lambda: fa.flash_attention_fwd(q, k, v, True))
    plain_ms = _cuda_ms(lambda: fa.flash_attention_reference(q, k, v, True),
                        iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = _cuda_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(qt, kt, vt,
                                                        is_causal=True))
    elem = q.element_size()
    nbytes = b * (4 * n * HEADS * HEAD_DIM * elem + HEADS * n * 4)
    flops = _flash_flops(b, n)
    bound, by = _bound_ms(nbytes, flops, q.dtype)
    return {"max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms,
            "tflops": flops / (ms * 1e-3) / 1e12,
            "tile": "64 q rows (1 consumer warpgroup) x 64-key K/V tiles",
            "shape": f"q,k,v ({b}, {n}, {HEADS}, {HEAD_DIM}) bf16 causal"}


def check_flash():
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for n in (40, 1024):
            for causal in (True, False):
                errs[dtype, n, causal] = _check_flash_case(
                    f"flash {name} n={n} causal={causal}",
                    *_fused_qkv(n, dtype, seed=n), causal)
        # the training path's batch 8 at its shape, and a ragged batch 3:
        # every block past the first batch reads at its batch stride
        errs[dtype, "train"] = _check_flash_case(
            f"flash {name} (8, 1024, {HEADS}, {HEAD_DIM}) causal=True",
            *_fused_qkv(1024, dtype, seed=11, batch=8), True)
        _check_flash_case(f"flash {name} (3, 40, {HEADS}, {HEAD_DIM}) "
                          "causal=False",
                          *_fused_qkv(40, dtype, seed=10, batch=3), False)
        # off the serving path but compiled in: head_dim 128, and
        # non-causal attention over more keys than queries
        _check_flash_case(f"flash {name} n=40 causal=True D=128",
                          *_fused_qkv(40, dtype, seed=7, heads=4,
                                      head_dim=128), True)
        q = _fused_qkv(40, dtype, seed=8)[0]
        _, k, v = _fused_qkv(100, dtype, seed=9)
        _check_flash_case(f"flash {name} n=40 m=100 causal=False", q, k, v,
                          False)
    dtype = torch.bfloat16
    # bf16 tile edges and a length that is no power of two: TMA's zero
    # fill past n and the diagonal mask at every offset within a tile (8,
    # 16: the smallest prefill buckets)
    for n in (8, 16, 17, 64, 65, 1000):
        for causal in (True, False):
            _check_flash_case(f"flash bfloat16 n={n} causal={causal}",
                              *_fused_qkv(n, dtype, seed=30 + n), causal)
    # k and v at 16-byte aligned, non-zero offsets into a wider buffer
    _check_flash_case("flash bfloat16 n=200 causal=True k, v offset views",
                      *_offset_qkv(200, seed=31), True)
    # main-path shapes, bf16 causal: the serving path's 1024 prefill bucket
    # (the row's numbers) and the training path's batch of 8 x 1024
    # (`at_train_shape`)
    row = _time_flash(*_fused_qkv(1024, dtype, seed=1024),
                      errs[dtype, 1024, True])
    row["at_train_shape"] = _time_flash(
        *_fused_qkv(1024, dtype, seed=11, batch=8), errs[dtype, "train"])
    print(f"  flash bfloat16 fwd ms: serve {row['ms']:.4f}, train "
          f"{row['at_train_shape']['ms']:.4f}; the earlier design, written "
          f"in, not measured in this run: {json.dumps(FLASH_FWD_PREV_MS)}")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "paddle_tpu/kernels/flash_attention.py:90 _fwd_kernel",
            **row}


def _paged_state(layers, lens, dtype, seed, slots=8, bs=16, m=64,
                 heads=HEADS, head_dim=HEAD_DIM):
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = 1 + slots * m
    shape = (layers, nb, bs, heads, head_dim)
    kp = torch.randn(shape, generator=g, device="cuda").to(dtype)
    vp = torch.randn(shape, generator=g, device="cuda").to(dtype)
    q = torch.randn((slots, heads, head_dim), generator=g,
                    device="cuda").to(dtype)
    tables = (1 + torch.arange(slots * m, device="cuda",
                               dtype=torch.int32)).reshape(slots, m)
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, lens


def _split_lens(bs=16, m=64):
    """Lengths around the kernel's split boundaries at these shapes. The
    n_split CTAs of a slot share its positions in whole table entries, so
    a span grows by one entry each time the length passes a multiple of
    n_split * bs: one position before, at and after the first and the
    fourth such boundary, a slot at M * bs - 1, a slot of bs + 1
    positions (two live splits, the later ones empty) and an inactive
    slot (slot 7)."""
    unit = pa.split_plan(m, bs)[1] * bs
    return [unit - 1, unit, unit + 1, 4 * unit - 1, 4 * unit, m * bs - 1,
            bs, 0]


def _paged_cases():
    """(tag, heads, head_dim, q dtype, lens) of the correctness checks:
    D = 64 (the serving path's) and 128 (compiled in as well), fp32 and
    bf16 queries, the ragged serve lengths and the split boundaries."""
    for heads, head_dim in ((HEADS, HEAD_DIM), (4, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            yield "ragged", heads, head_dim, dtype, PAGED_RAGGED_LENS
            yield "split", heads, head_dim, dtype, _split_lens()


def _paged_work(lens, q, tables, int8, bs=16):
    """``(bytes, flops)`` one call needs: the K and V rows of the positions
    the lengths attend (p <= lens, one position for an empty slot), their
    int8 scales, q, out, the tables and the lengths; 4 FLOPs per element
    of K (q.k and p.v)."""
    tokens = sum(l + 1 for l in lens)
    blocks = sum(-(-(l + 1) // bs) for l in lens)
    row = HEADS * HEAD_DIM * (1 if int8 else q.element_size())
    scales = 2 * blocks * HEADS * 4 if int8 else 0
    nbytes = (2 * tokens * row + scales + 2 * q.numel() * q.element_size()
              + tables.numel() * 4 + len(lens) * 4)
    return nbytes, 4 * tokens * HEADS * HEAD_DIM


def check_paged():
    bs = 16
    err = None
    for tag, heads, head_dim, dtype, lens in _paged_cases():
        q, kp, vp, tables, lens_t = _paged_state(
            1, lens, dtype, seed=1, heads=heads, head_dim=head_dim)
        tables[7] = 0                  # slot 7 is inactive
        out = pa.paged_attention(q, kp[0], vp[0], tables, lens_t, bs)
        ref = pa.paged_decode_reference(q, kp[0], vp[0], tables, lens_t, bs)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), "non-finite output"
        e = _close(f"paged {str(dtype)[6:]} D={head_dim} {tag} lens {lens} "
                   "active slots", out[:7], ref[:7], PAGED_TOL[dtype])
        if (head_dim, dtype, tag) == (HEAD_DIM, torch.bfloat16, "ragged"):
            err = e
    # main-path shape: 8 slots at a full 1024-token context, bf16; 4 layers'
    # pools (~100 MB, twice the L2) rotate so each launch reads cold KV, as
    # a decode step's 12 layers do; then the serve mix's ragged lengths
    dtype, layers = torch.bfloat16, 4
    row = {}
    for lens in ([1023] * 8, PAGED_RAGGED_LENS):
        q, kp, vp, tables, lens_t = _paged_state(layers, lens, dtype, seed=2)
        it = iter(range(10 ** 9))

        def rotating(fn):
            def call():
                layer = next(it) % layers
                return fn(q, kp[layer], vp[layer], tables, lens_t, bs)
            return call

        ms, host_ms = _timed(rotating(pa.paged_attention))
        plain_ms = _cuda_ms(rotating(pa.paged_decode_reference))
        t_max = tables.shape[1] * bs
        mask = (torch.arange(t_max, device="cuda")[None, :]
                <= lens_t[:, None])[:, None, None, :]

        def library(qq, kk, vv, tab, _lens, _bs):
            kg = kk[tab.long()].reshape(8, t_max, HEADS, HEAD_DIM) \
                .transpose(1, 2)
            vg = vv[tab.long()].reshape(8, t_max, HEADS, HEAD_DIM) \
                .transpose(1, 2)
            return torch.nn.functional.scaled_dot_product_attention(
                qq[:, :, None, :], kg, vg, attn_mask=mask)

        library_ms = _cuda_ms(rotating(library))
        bound, by = _bound_ms(*_paged_work(lens, q, tables, False), dtype)
        numbers = {"ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": by,
                   "library_ms": library_ms}
        if not row:
            row.update(numbers, shape="S=8 H=12 D=64 bs=16 M=64, lens 1023, "
                                      "bf16")
        else:
            row["at_ragged_lens"] = dict(numbers,
                                         shape=f"lens {lens}, otherwise "
                                               "the same")
    return {"name": "paged_decode", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": "paddle_tpu/kernels/pallas/paged_attention.py:167 "
                        "_decode_kernel",
            "max_abs_err": err, **row}


def _int8_state(layers, lens, dtype, seed, slots=8, bs=16, m=64,
                heads=HEADS, head_dim=HEAD_DIM):
    """int8 pools with per-block-per-head fp32 scales, a query in `dtype`
    and the dense-prefix tables of `_paged_state`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = 1 + slots * m
    shape = (layers, nb, bs, heads, head_dim)
    kp, vp = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((layers, nb, heads), generator=g, device="cuda")
              * 4 + 0.05 for _ in range(2))
    q = torch.randn((slots, heads, head_dim), generator=g,
                    device="cuda").to(dtype)
    tables = (1 + torch.arange(slots * m, device="cuda",
                               dtype=torch.int32)).reshape(slots, m)
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, ks, vs, tables, lens


def check_paged_int8():
    bs = 16
    err = None
    for tag, heads, head_dim, dtype, lens in _paged_cases():
        q, kp, vp, ks, vs, tables, lens_t = _int8_state(
            1, lens, dtype, seed=3, heads=heads, head_dim=head_dim)
        tables[7] = 0                  # slot 7 is inactive
        args = (q, kp[0], vp[0], tables, lens_t, bs, ks[0], vs[0])
        out = pa.paged_attention(*args)
        ref = pa.paged_decode_reference(*args)
        torch.cuda.synchronize()
        assert out.dtype == dtype and torch.isfinite(out.float()).all()
        e = _close(f"paged int8 q={str(dtype)[6:]} D={head_dim} {tag} lens "
                   f"{lens} active slots", out[:7], ref[:7],
                   PAGED_INT8_TOL[dtype])
        if (head_dim, dtype, tag) == (HEAD_DIM, torch.bfloat16, "ragged"):
            err = e
    # main-path shape: 8 slots at a full 1024-token context, bf16 queries,
    # int8 pools; 8 layers' pools (~100 MB, twice the L2) rotate so each
    # launch reads cold KV, as a decode step's 12 layers do; then the serve
    # mix's ragged lengths
    dtype, layers = torch.bfloat16, 8
    row = {}
    for lens in ([1023] * 8, PAGED_RAGGED_LENS):
        q, kp, vp, ks, vs, tables, lens_t = _int8_state(layers, lens, dtype,
                                                        seed=4)
        it = iter(range(10 ** 9))

        def rotating(fn):
            def call():
                layer = next(it) % layers
                return fn(q, kp[layer], vp[layer], tables, lens_t, bs,
                          ks[layer], vs[layer])
            return call

        ms, host_ms = _timed(rotating(pa.paged_attention))
        plain_ms = _cuda_ms(rotating(pa.paged_decode_reference))
        t_max = tables.shape[1] * bs
        mask = (torch.arange(t_max, device="cuda")[None, :]
                <= lens_t[:, None])[:, None, None, :]
        tab = tables.long()

        def library(qq, kk, vv, tab_, _lens, _bs, kss, vss):
            # yardstick: a dequantizing gather, then SDPA in q's dtype
            def deq(pool, sc):
                x = pool[tab].float() * (sc[tab] * (1.0 / 127))[..., None, :,
                                                                 None]
                return x.reshape(8, t_max, HEADS, HEAD_DIM).transpose(1, 2) \
                    .to(qq.dtype)
            return torch.nn.functional.scaled_dot_product_attention(
                qq[:, :, None, :], deq(kk, kss), deq(vv, vss), attn_mask=mask)

        library_ms = _cuda_ms(rotating(library))
        bound, by = _bound_ms(*_paged_work(lens, q, tables, True), dtype)
        numbers = {"ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": by,
                   "library_ms": library_ms}
        if not row:
            row.update(numbers, shape="S=8 H=12 D=64 bs=16 M=64, lens 1023, "
                                      "q bf16, int8 pools + fp32 scales")
        else:
            row["at_ragged_lens"] = dict(numbers,
                                         shape=f"lens {lens}, otherwise "
                                               "the same")
    return {"name": "paged_decode_int8", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": "paddle_tpu/kernels/pallas/paged_attention.py:167 "
                        "_decode_kernel (quantized=True)",
            "max_abs_err": err, **row}


def _paged_prev_line(fp_row, int8_row):
    print(f"  paged decode ms at lens 1023: bf16 pools {fp_row['ms']:.5f}, "
          f"int8 pools {int8_row['ms']:.5f}; at the ragged lens "
          f"{fp_row['at_ragged_lens']['ms']:.5f}, "
          f"{int8_row['at_ragged_lens']['ms']:.5f}; the earlier design, "
          f"written in, not measured in this run: PAGED_PREV_MS "
          f"{json.dumps(PAGED_PREV_MS)}")


# the fused decode step's cases, one step of 8 slots: write offsets 0, 1,
# 15, 0 (a new block), mid-block (8) and 15 at the table's last position
# for the active slots, whose contexts lie within one table entry (lens 0,
# 1, 15: the write is split 0's), span 2 entries (16: split 1's) or all 4
# splits (200, 1023: split 3's); an inactive slot with a live table row
# and length (the kernel must skip it), and one with a cleared row. The
# pools hold a previous tenant's data: stale levels past every offset,
# under scales that are mostly larger than the new vectors (which are
# scaled by KV_APPEND_GAIN per slot, so some blocks' scales shrink and
# some grow)
KV_APPEND_LENS = [0, 1, 15, 16, 200, 1023, 500, 37]
KV_APPEND_ACTIVE = [True, True, True, True, True, True, False, False]
KV_APPEND_GAIN = [0.01, 0.5, 1.0, 3.0, 0.1, 10.0, 1.0, 1.0]
# launches of the fused kernel held against the twin, each on fresh copies
# of the state, so that a write racing the span's reads would show
APPEND_REPEATS = 50


def _kv_append_state(layers, pool_dtype, new_dtype, seed, slots=8, bs=16,
                     m=64, heads=HEADS, head_dim=HEAD_DIM):
    """q, k_new, v_new (strided views of one [S, 3, H, D] projection, the
    fused QKV layout), pools of `layers` layers (int8 with fp32 scales, or
    `pool_dtype`), tables, lens and active of KV_APPEND_*."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = 1 + slots * m
    shape = (layers, nb, bs, heads, head_dim)
    gain = torch.tensor(KV_APPEND_GAIN, device="cuda")[:, None, None, None]
    qkv = (torch.randn((slots, 3, heads, head_dim), generator=g,
                       device="cuda") * gain).to(new_dtype)
    if pool_dtype == torch.int8:
        kp, vp = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((layers, nb, heads), generator=g, device="cuda")
                  * 4 + 0.05 for _ in range(2))
    else:
        kp, vp = (torch.randn(shape, generator=g, device="cuda")
                  .to(pool_dtype) for _ in range(2))
        ks = vs = None
    tables = (1 + torch.arange(slots * m, device="cuda",
                               dtype=torch.int32)).reshape(slots, m)
    tables[7] = 0                          # slot 7: a cleared row
    lens = torch.tensor(KV_APPEND_LENS, dtype=torch.int32, device="cuda")
    active = torch.tensor(KV_APPEND_ACTIVE, device="cuda")
    return (qkv[:, 0], qkv[:, 1], qkv[:, 2], kp, vp, ks, vs, tables, lens,
            active)


def _kv_append_work(int8, elem, bs=16, heads=HEADS, head_dim=HEAD_DIM):
    """``(bytes, flops)`` the decode write needs, for the active slots
    (inactive slots write nothing): fp pools read each new row and write
    it; int8 pools read the levels before the offset, the scale and the
    new row, and write the block's bs x D levels and its scale, per head;
    plus the lengths, the active flags and one table entry per active
    slot. About 8 fp32 operations per int8 element (dequantize, abs, max,
    multiply, round, clamp)."""
    live = [l for l, a in zip(KV_APPEND_LENS, KV_APPEND_ACTIVE) if a]
    row = heads * head_dim
    n = len(KV_APPEND_LENS)
    nbytes = n * 4 + n + 4 * len(live)
    flops = 0
    for l in live:
        off = l % bs
        if int8:
            nbytes += 2 * heads * (off * head_dim + head_dim * elem + 4
                                   + bs * head_dim + 4)
            flops += 2 * 8 * bs * row
        else:
            nbytes += 2 * 2 * row * elem
    return nbytes, flops


def _check_append_case(pool_dtype, new_dtype, bs=16):
    """`paged_decode_append` against the twin composition on copies of one
    state, APPEND_REPEATS times: pools (int8: levels and scales) equal bit
    for bit on every block but null block 0, block 0 untouched (the twin
    writes the inactive slots' rows there, the kernel skips them), the
    active slots' output within PAGED_TOL of the twin's and equal bit for
    bit to the paged kernel's alone on the twin's pools. Returns the
    output's max abs error against the twin."""
    q, k, v, kp, vp, ks, vs, tables, lens, active = _kv_append_state(
        1, pool_dtype, new_dtype, seed=5)
    int8 = ks is not None
    orig = [t[0] for t in ((kp, vp, ks, vs) if int8 else (kp, vp))]
    want = [t.clone() for t in orig]
    kva.kv_append_reference(k, v, want[0], want[1], tables, lens, active, bs,
                            *want[2:])
    eff = torch.where(active, lens, 0)
    want_out = pa.paged_decode_reference(q, want[0], want[1], tables, eff, bs,
                                         *want[2:])
    alone = pa.paged_attention(q.contiguous(), want[0], want[1], tables, eff,
                               bs, *want[2:])
    name = "paged_decode_append_int8" if int8 else "paged_decode_append"
    tag = (f"{name} pools {str(pool_dtype)[6:]}, rows {str(new_dtype)[6:]}, "
           f"lens {KV_APPEND_LENS}, active {KV_APPEND_ACTIVE}")
    act = torch.tensor(KV_APPEND_ACTIVE, device="cuda")
    atol, rtol = PAGED_TOL[new_dtype]
    before = launch_counts()
    err = 0.0
    for i in range(APPEND_REPEATS):
        got = [t.clone() for t in orig]
        out = pa.paged_decode_append(q, k, v, got[0], got[1], tables, lens,
                                     active, bs, *got[2:])
        for g_t, w_t in zip(got, want):
            assert torch.equal(g_t[1:], w_t[1:]), \
                f"{tag}, launch {i}: pools not bit-identical"
        assert all(torch.equal(g_t[0], o[0]) for g_t, o in zip(got, orig)), \
            f"{tag}, launch {i}: block 0 written"
        o, w = out[act].float(), want_out[act].float()
        torch.testing.assert_close(o, w, atol=atol, rtol=rtol,
                                   msg=lambda m: f"{tag}, launch {i}: {m}")
        assert torch.equal(out[act], alone[act]), \
            f"{tag}, launch {i}: out differs from the paged kernel alone"
        err = max(err, (o - w).abs().max().item())
    assert launch_counts()[name] == before[name] + APPEND_REPEATS, \
        launch_counts()
    print(f"  {tag}: {APPEND_REPEATS} launches, each with pools bit-identical "
          f"to the twin's on blocks 1.. and block 0 untouched; out of the "
          f"active slots max_abs_err {err:.3e} (atol {atol}, rtol {rtol}), "
          f"bit-identical to the paged kernel alone on the twin's pools")
    return err


def check_paged_append():
    """The fused decode step (`paged_decode_append`: the write, then the
    attention, one launch) against its twin composition (`_check_append_
    case`) for fp32 and bf16 pools and int8 pools with bf16 and fp32 rows.
    Returns the fp (bf16 pools) and int8 (bf16 rows) rows, timed at the
    serving path's shape in turns with the paged kernel alone on the same
    state (fused, paged, paged, fused): their difference is what the
    write adds to the launch."""
    bs = 16
    errs = {pair: _check_append_case(*pair)
            for pair in ((torch.bfloat16, torch.bfloat16),
                         (torch.float32, torch.float32),
                         (torch.int8, torch.bfloat16),
                         (torch.int8, torch.float32))}
    # main-path shape, bf16 rows: 12 layers' pools rotate, as a decode
    # step's 12 layers read and write 12 pools
    rows, layers = [], 12
    eff_lens = [l if a else 0 for l, a in zip(KV_APPEND_LENS,
                                              KV_APPEND_ACTIVE)]
    for pool_dtype in (torch.bfloat16, torch.int8):
        q, k, v, kp, vp, ks, vs, tables, lens, active = _kv_append_state(
            layers, pool_dtype, torch.bfloat16, seed=6)
        int8 = ks is not None
        eff = torch.where(active, lens, 0)
        q_alone = q.contiguous()
        it = iter(range(10 ** 9))

        def rotating(fn):
            def call():
                layer = next(it) % layers
                scales = (ks[layer], vs[layer]) if int8 else ()
                return fn(kp[layer], vp[layer], *scales)
            return call

        def fused(kpl, vpl, *scales):
            return pa.paged_decode_append(q, k, v, kpl, vpl, tables, lens,
                                          active, bs, *scales)

        def alone(kpl, vpl, *scales):
            return pa.paged_attention(q_alone, kpl, vpl, tables, eff, bs,
                                      *scales)

        def twin(kpl, vpl, *scales):
            kva.kv_append_reference(k, v, kpl, vpl, tables, lens, active, bs,
                                    *scales)
            return pa.paged_decode_reference(q, kpl, vpl, tables, eff, bs,
                                             *scales)

        f1, host_1 = _timed(rotating(fused))
        p1, _ = _timed(rotating(alone))
        p2, _ = _timed(rotating(alone))
        f2, host_2 = _timed(rotating(fused))
        plain_ms = _cuda_ms(rotating(twin))
        if int8:
            # no single PyTorch call requantizes a block
            library_ms = None
        else:
            # yardstick: the two index_put_ calls of the fp write, with the
            # write positions computed beforehand, then a gather and SDPA
            wb = torch.where(active, tables[torch.arange(8, device="cuda"),
                                            eff.long() // bs].long(), 0)
            wo = eff.long() % bs
            t_max = tables.shape[1] * bs
            mask = (torch.arange(t_max, device="cuda")[None, :]
                    <= eff[:, None])[:, None, None, :]

            def library(kpl, vpl):
                kpl.index_put_((wb, wo), k)
                vpl.index_put_((wb, wo), v)
                kg = kpl[tables.long()].reshape(8, t_max, HEADS, HEAD_DIM) \
                    .transpose(1, 2)
                vg = vpl[tables.long()].reshape(8, t_max, HEADS, HEAD_DIM) \
                    .transpose(1, 2)
                return torch.nn.functional.scaled_dot_product_attention(
                    q[:, :, None, :], kg, vg, attn_mask=mask)

            library_ms = _cuda_ms(rotating(library))
        paged_b = _paged_work(eff_lens, q, tables, int8)
        append_b = _kv_append_work(int8, 2)
        bound, by = _bound_ms(paged_b[0] + append_b[0],
                              paged_b[1] + append_b[1], torch.bfloat16)
        name = "paged_decode_append_int8" if int8 else "paged_decode_append"
        ms, alone_ms = (f1 + f2) / 2, (p1 + p2) / 2
        print(f"  {name} in turns (fused, paged alone, paged alone, fused): "
              f"{f1:.5f} / {p1:.5f} / {p2:.5f} / {f2:.5f} ms; the write adds "
              f"{ms - alone_ms:.5f} ms to the launch")
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": ("paddle_tpu/kernels/pallas/paged_attention.py:167 "
                         "_decode_kernel (quantized=True) with the decode "
                         "write before it, paddle_tpu/quantization/"
                         "kv_cache.py:62 quantize_block_write (XLA ops, no "
                         "Pallas kernel)" if int8 else
                         "paddle_tpu/kernels/pallas/paged_attention.py:167 "
                         "_decode_kernel with the decode write before it, "
                         "paddle_tpu/nn/functional/attention.py:253-271 "
                         ".at[write_block, write_off].set (XLA ops, no "
                         "Pallas kernel)"),
            "max_abs_err": errs[pool_dtype, torch.bfloat16], "ms": ms,
            "host_ms": (host_1 + host_2) / 2, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
            "alone_ms": alone_ms, "append_ms": ms - alone_ms,
            "turns_ms": [f1, p1, p2, f2],
            "shape": (f"S=8 H=12 D=64 bs=16 M=64, 513 blocks, lens "
                      f"{KV_APPEND_LENS}, active {KV_APPEND_ACTIVE}, bf16 "
                      "q and rows, " + (
                          "int8 pools + fp32 scales; library_ms null: no "
                          "one PyTorch call requantizes a block" if int8 else
                          "bf16 pools; library_ms: two index_put_, a "
                          "gather and SDPA"))})
    return rows


# the prompt's K/V scatter against its twin (bit for bit on every block but
# null block 0, block 0 untouched): buckets, and lengths of one token, a
# block less one, a block, a block and one, the serve mix's longest prompt
# and a full bucket; the bucket of 1024 is timed at a full bucket
SCATTER_CASES = ((16, (1, 15, 16)), (128, (1, 15, 16, 17, 128)),
                 (1024, (17, 990, 1024)))
SCATTER_LAYERS, SCATTER_M = 12, 64
# int8 pools of wider heads and blocks: head_dim 128, 32-token blocks, at
# a 128-token bucket (bf16 rows hold a head's block in registers, fp32
# rows read the half past them twice)
SCATTER_WIDE = (128, 32, (1, 31, 32, 33, 128))


def _scatter_state(bucket, dtype, int8, seed, bs=16, head_dim=HEAD_DIM):
    """Per-layer K/V rows as strided views of one [bucket, 3, H, D]
    projection a layer (the forward's layout), pools of 1 + 2 M blocks
    that hold a previous tenant's bytes (int8: levels and scales), and a
    block row of M shuffled block ids: the prompt's blocks, then spare
    blocks past it, the last 4 entries null where the bucket leaves them
    free."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    gain = torch.rand((bucket, 1, 1, 1), generator=g, device="cuda") * 4 \
        + 0.05
    qkv = [(torch.randn((bucket, 3, HEADS, head_dim), generator=g,
                        device="cuda") * gain).to(dtype)
           for _ in range(SCATTER_LAYERS)]
    nb = 1 + 2 * SCATTER_M
    shape = (SCATTER_LAYERS, nb, bs, HEADS, head_dim)
    if int8:
        pools = [torch.randint(-127, 128, shape, generator=g, device="cuda",
                               dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand((SCATTER_LAYERS, nb, HEADS), generator=g,
                             device="cuda") * 4 + 0.5 for _ in range(2)]
    else:
        pools = [torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for _ in range(2)]
        scales = [None, None]
    row = (1 + torch.randperm(nb - 1, generator=g, device="cuda")
           [:SCATTER_M]).to(torch.int32)
    if bucket <= (SCATTER_M - 4) * bs:
        row[-4:] = 0
    return [x[:, 1] for x in qkv], [x[:, 2] for x in qkv], pools, scales, row


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _check_scatter_case(bucket, length, dtype, int8, bs=16,
                        head_dim=HEAD_DIM):
    """One scatter against its twin on copies of one state."""
    k, v, pools, scales, row = _scatter_state(bucket, dtype, int8,
                                              seed=bucket + length, bs=bs,
                                              head_dim=head_dim)
    orig = [t for t in (*pools, *scales) if t is not None]
    want = [t.clone() for t in orig]
    got = [t.clone() for t in orig]
    n = torch.full((), length, dtype=torch.int32, device="cuda")
    ps.prefill_scatter_reference(want[0], want[1], k, v, row, n, bs,
                                 *want[2:])
    ps.prefill_scatter(got[0], got[1], k, v, row, n, bs, *got[2:])
    torch.cuda.synchronize()
    tag = (f"prefill_scatter{'_int8' if int8 else ''} {str(dtype)[6:]} "
           f"rows, bucket {bucket}, length {length}, head_dim {head_dim}, "
           f"bs {bs}")
    for g_t, w_t, o_t in zip(got, want, orig):
        assert torch.equal(_bits(g_t[:, 1:]), _bits(w_t[:, 1:])), \
            f"{tag}: not bit-identical to the twin"
        assert torch.equal(_bits(g_t[:, 0]), _bits(o_t[:, 0])), \
            f"{tag}: block 0 written"
    return tag


def check_prefill_scatter():
    """The prompt's K/V scatter (one launch for every layer, K and V)
    against its twin, bit for bit on every block but 0 and block 0
    untouched, at SCATTER_CASES for bf16 rows (the serving path's) and at
    bucket 128 for fp32 rows, fp and int8 pools, and with int8 pools at
    SCATTER_WIDE (head_dim 128, 32-token blocks; bf16 and fp32 rows).
    Returns the two rows, timed at a full 1024-token bucket with bf16
    rows, in turns with the first design (commit c3b6374,
    tools/torch_prefill_scatter_twopass.cu: int8 blocks read twice)."""
    bs = 16
    tags = []
    for int8 in (False, True):
        for bucket, lengths in SCATTER_CASES:
            for length in lengths:
                tags.append(_check_scatter_case(bucket, length,
                                                torch.bfloat16, int8))
        for length in SCATTER_CASES[1][1]:
            tags.append(_check_scatter_case(128, length, torch.float32,
                                            int8))
    wide_bucket, wide_bs, wide_lengths = SCATTER_WIDE
    for dtype in (torch.bfloat16, torch.float32):
        for length in wide_lengths:
            tags.append(_check_scatter_case(wide_bucket, length, dtype, True,
                                            bs=wide_bs, head_dim=128))
    print(f"  prefill_scatter: {len(tags)} cases bit-identical to the twin "
          f"on blocks 1.. and block 0 untouched (buckets and lengths "
          f"{json.dumps(SCATTER_CASES)} in bf16, bucket 128 in fp32, fp "
          f"and int8 pools; int8 pools at head_dim 128, bs {wide_bs}, "
          f"bucket {wide_bucket}, lengths {list(wide_lengths)}, bf16 and "
          "fp32 rows)")
    rows = []
    bucket = length = 1024
    twopass = _TOOL_LIBS["torch_prefill_scatter_twopass"] \
        .paddle_prefill_scatter
    turns = {}
    for int8 in (False, True):
        k, v, pools, scales, row = _scatter_state(bucket, torch.bfloat16,
                                                  int8, seed=7)
        n = torch.full((), length, dtype=torch.int32, device="cuda")
        args = (*pools, k, v, row, n, bs, *scales)

        def first():
            assert ps.run(twopass, *args) == 0

        times = [_timed(first if old else
                        lambda: ps.prefill_scatter(*args))
                 for old in TURNS]
        turns["int8" if int8 else "fp"] = [round(t[0], 5) for t in times]
        ms = float(np.mean([t[0] for t, old in zip(times, TURNS)
                            if not old]))
        host_ms = times[1][1]
        plain_ms = _cuda_ms(lambda: ps.prefill_scatter_reference(*args),
                            iters=5)
        if int8:
            library_ms = None
        else:
            # the nearest calls: two index_put_ a layer, the positions
            # computed beforehand
            pos = torch.arange(length, device="cuda")
            blocks, offs = row.long()[pos // bs], pos % bs

            def library():
                for layer in range(SCATTER_LAYERS):
                    pools[0][layer].index_put_((blocks, offs), k[layer])
                    pools[1][layer].index_put_((blocks, offs), v[layer])

            library_ms = _cuda_ms(library)
        used = int((row != 0).sum())        # blocks whose scales it writes
        nbytes = ps.scatter_bytes(length, SCATTER_LAYERS, HEADS, HEAD_DIM, 2,
                                  int8, used)
        # int8: about 6 fp32 operations an element (abs, max, multiply,
        # round, two clamps)
        flops = 6 * 2 * SCATTER_LAYERS * length * HEADS * HEAD_DIM if int8 \
            else 0
        bound, by = _bound_ms(nbytes, flops, torch.float32)
        name = "prefill_scatter_int8" if int8 else "prefill_scatter"
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/prefill_scatter.cu",
            "replaces": ("no Pallas counterpart: paddle_tpu/serving/cache.py"
                         ":237 scatter_prefill over paddle_tpu/quantization/"
                         "kv_cache.py:90 quantize_scatter (XLA ops)" if int8
                         else "no Pallas counterpart: paddle_tpu/serving/"
                         "cache.py:237 scatter_prefill (XLA ops)"),
            "max_abs_err": 0.0, "ms": ms, "host_ms": host_ms,
            "turns_ms": turns["int8" if int8 else "fp"],
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms, "bytes": nbytes,
            "shape": (f"12 layers of bf16 rows [1024, 12, 64] (strided views "
                      f"of [1024, 3, 12, 64]), length {length}, bs=16, a "
                      f"block row of 64, " + (
                          "int8 pools + fp32 scales; library_ms null: no one "
                          "PyTorch call quantizes a block" if int8 else
                          "bf16 pools; library_ms: two index_put_ a layer")),
            "note": "turns_ms: the first design (commit c3b6374), this, "
                    "this, the first"})
    print("PREFILL_SCATTER_TURNS_MS (first design, this, this, first design; "
          "the first design is commit c3b6374's, "
          "tools/torch_prefill_scatter_twopass.cu): " + json.dumps(turns))
    return rows


def _ln_inputs(r, d, dtype, seed, affine_dtype=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, res = (torch.randn((r, d), generator=g, device="cuda").to(dtype)
              for _ in range(2))
    bias, scale, shift = (torch.randn(d, generator=g, device="cuda")
                          .to(affine_dtype or dtype) for _ in range(3))
    return x, res, bias, scale, shift


def check_fused_ln():
    # the main-path shape in both types, a ragged R = 777, affine terms in
    # the other type (bf16 activations under fp32 parameters, and the
    # reverse), the narrowest width and one wider than 4096 (two groups of
    # 4 per thread)
    cases = [(8192, 768, torch.bfloat16, None), (8192, 768, torch.float32,
                                                 None),
             (777, 768, torch.bfloat16, None), (777, 768, torch.float32, None),
             (777, 768, torch.bfloat16, torch.float32),
             (777, 768, torch.float32, torch.bfloat16),
             (5, 128, torch.bfloat16, None), (33, 4224, torch.float32, None)]
    for i, (r, d, dtype, adt) in enumerate(cases):
        args = _ln_inputs(r, d, dtype, seed=20 + i, affine_dtype=adt)
        out = fln.fused_ln_fwd(*args)
        ref = fln.fused_ln_reference(*args)
        torch.cuda.synchronize()
        assert out.dtype == dtype and torch.isfinite(out.float()).all()
        e = _close(f"fused_ln {str(dtype)[6:]} ({r}, {d}) affine "
                   f"{str(adt or dtype)[6:]}", out, ref, LN_TOL[dtype])
        if i == 0:
            err = e
    # main-path shape [8192, 768] bf16; 4 input sets (x, residual and the
    # output: 151 MB, three times the L2) rotate so each launch reads cold
    # activations, as a layer's LayerNorm does
    r, d, dtype, sets = 8192, 768, torch.bfloat16, 4
    inputs = [_ln_inputs(r, d, dtype, seed=40 + i) for i in range(sets)]
    it = iter(range(10 ** 9))

    def rotating(fn):
        return lambda: fn(*inputs[next(it) % sets])

    ms, host_ms = _timed(rotating(fln.fused_ln_fwd))
    plain_ms = _cuda_ms(rotating(fln.fused_ln_reference))
    library_ms = _cuda_ms(rotating(
        lambda x, res, b, sc, sh: torch.nn.functional.layer_norm(
            x + b + res, (d,), sc, sh, 1e-5)))
    elem = 2
    nbytes = 3 * r * d * elem + 3 * d * elem
    # ~10 fp32 operations per element (2 adds, mean, centre, square-add,
    # scale, affine)
    bound, by = _bound_ms(nbytes, 10 * r * d, torch.float32)
    return {"name": "fused_ln", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_ln.cu",
            "replaces": "paddle_tpu/kernels/fused_ln.py:59 _kernel",
            "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms,
            "shape": f"x, residual ({r}, {d}) bf16, bias/scale/shift bf16"}


def _strided_grad(q, seed):
    """An output gradient laid out [B, H, N, D] and viewed as [B, N, H, D]:
    rows contiguous, the rest strided, as a reshaped gradient can be."""
    b, n, h, d = q.shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, h, n, d), generator=g, device="cuda") \
        .to(q.dtype).transpose(1, 2)


def _flash_bwd_inputs(q, k, v, causal, seed):
    do = _strided_grad(q, seed)
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    delta = fa.flash_attention_delta(out, do)
    return q, k, v, do, lse, delta, causal, 1.0 / (q.shape[-1] ** 0.5)


def _check_flash_bwd_case(tag, q, k, v, causal, seed=0):
    """dQ, dK, dV against their twins: fp32 within FLASH_BWD_TOL, bf16
    within `fa.flash_bwd_bf16_tol` and, each, a relative Frobenius error
    of at most fa.FLASH_BWD_BF16_FRO_RTOL."""
    args = _flash_bwd_inputs(q, k, v, causal, seed)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    rq = fa.flash_attention_bwd_dq_reference(*args)
    rk, rv = fa.flash_attention_bwd_dkv_reference(*args)
    torch.cuda.synchronize()
    bf16 = q.dtype == torch.bfloat16
    tols = (fa.flash_bwd_bf16_tol(*args) if bf16 else
            dict.fromkeys(("dq", "dk", "dv"), FLASH_BWD_TOL[q.dtype]))
    errs = {}
    for name, got, want in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        errs[name] = _close(f"{tag} {name}", got, want, tols[name])
        if bf16:
            fro = fa.rel_fro(got, want)
            print(f"  {tag} {name}: relative Frobenius error {fro:.3e} (at "
                  f"most {fa.FLASH_BWD_BF16_FRO_RTOL})")
            assert fro <= fa.FLASH_BWD_BF16_FRO_RTOL, (tag, name, fro)
    return errs["dq"], max(errs["dk"], errs["dv"])


def _check_flash_bwd_refuses_misaligned_do():
    """A bf16 dO 2 bytes off a 16-byte boundary: TMA cannot read it, so
    both backward wrappers raise, naming it, and launch nothing."""
    q, k, v = _fused_qkv(40, torch.bfloat16, seed=13)
    width = HEADS * HEAD_DIM
    buf = torch.zeros((1, 40, width + 8), dtype=torch.bfloat16, device="cuda")
    do = buf[..., 1:1 + width].view(1, 40, HEADS, HEAD_DIM)
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = fa.flash_attention_delta(out, do)
    before = launch_counts()
    for fn in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        try:
            fn(q, k, v, do, lse, delta, True, 0.125)
        except ValueError as exc:
            assert "cannot read do:" in str(exc), exc
            print(f"  flash bwd bf16 misaligned dO: {fn.__name__} raised "
                  f"ValueError ({exc})")
        else:
            raise AssertionError(f"{fn.__name__} took a misaligned dO")
    assert launch_counts() == before, (before, launch_counts())


def _flash_bwd_bound(b, n, h, d, elem, causal, dkv):
    """Least time of dQ (dkv=False) or dK/dV: each input read once (q, k,
    v, dO, lse, Delta), each output written once; 6*D (dQ) or 8*D (dK/dV)
    FLOPs per unmasked (query, key) pair at the bf16 tensor-core peak."""
    pairs = b * h * (n * (n + 1) // 2 if causal else n * n)
    io = b * n * h * d * elem
    nbytes = (6 if dkv else 5) * io + 2 * b * h * n * 4
    return _bound_ms(nbytes, (8 if dkv else 6) * d * pairs, torch.bfloat16)


def check_flash_bwd():
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for n in (40, 1024):
            for causal in (True, False):
                _check_flash_bwd_case(f"flash bwd {name} n={n} causal={causal}",
                                      *_fused_qkv(n, dtype, seed=n), causal)
        _check_flash_bwd_case(f"flash bwd {name} n=40 causal=True D=128",
                              *_fused_qkv(40, dtype, seed=7, heads=4,
                                          head_dim=128), True)
        _check_flash_bwd_case(f"flash bwd {name} (3, 40, {HEADS}, "
                              f"{HEAD_DIM}) causal=False",
                              *_fused_qkv(40, dtype, seed=10, batch=3), False)
        q = _fused_qkv(40, dtype, seed=8)[0]
        _, k, v = _fused_qkv(100, dtype, seed=9)
        _check_flash_bwd_case(f"flash bwd {name} n=40 m=100 causal=False", q,
                              k, v, False)
    dtype = torch.bfloat16
    # bf16 tile edges and a length that is no power of two: TMA's zero
    # fill past n, the masks of the diagonal and edge tiles, D = 128 at a
    # ragged length, k and v at 16-byte aligned offsets into a wider buffer
    for n in (8, 64, 65, 1000):
        for causal in (True, False):
            _check_flash_bwd_case(f"flash bwd bfloat16 n={n} causal={causal}",
                                  *_fused_qkv(n, dtype, seed=30 + n), causal)
    _check_flash_bwd_case("flash bwd bfloat16 n=200 causal=False D=128",
                          *_fused_qkv(200, dtype, seed=32, heads=4,
                                      head_dim=128), False)
    _check_flash_bwd_case("flash bwd bfloat16 n=200 causal=True k, v offset "
                          "views", *_offset_qkv(200, seed=31), True)
    _check_flash_bwd_refuses_misaligned_do()
    # main-path shape: a training step's attention, causal; fp32 here, bf16
    # below with the timings
    _check_flash_bwd_case(f"flash bwd float32 (8, 1024, {HEADS}, {HEAD_DIM}) "
                          "causal",
                          *_fused_qkv(1024, torch.float32, seed=11, batch=8),
                          True, seed=12)
    b, n, dtype = 8, 1024, torch.bfloat16
    q, k, v = _fused_qkv(n, dtype, seed=11, batch=b)
    err_dq, err_dkv = _check_flash_bwd_case(
        f"flash bwd bf16 ({b}, {n}, {HEADS}, {HEAD_DIM}) causal", q, k, v,
        True, seed=12)
    args = _flash_bwd_inputs(q, k, v, True, seed=12)
    # yardstick: SDPA's backward, one call for dQ, dK and dV together
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    lib_do = args[3].transpose(1, 2)
    library_ms = _cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), lib_do, retain_graph=True))
    shape = f"q,k,v,dO ({b}, {n}, {HEADS}, {HEAD_DIM}) bf16 causal"
    pairs = b * HEADS * (n * (n + 1) // 2)
    rows = []
    for dkv, fn, ref, err in (
            (False, fa.flash_attention_bwd_dq,
             fa.flash_attention_bwd_dq_reference, err_dq),
            (True, fa.flash_attention_bwd_dkv,
             fa.flash_attention_bwd_dkv_reference, err_dkv)):
        bound, by = _flash_bwd_bound(b, n, HEADS, HEAD_DIM, 2, True, dkv)
        kind = "dkv" if dkv else "dq"
        ms, host_ms = _timed(lambda: fn(*args))
        flops = (8 if dkv else 6) * HEAD_DIM * pairs
        rows.append({
            "name": f"flash_attention_bwd_{kind}", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": ("paddle_tpu/kernels/flash_attention.py:223 "
                         "_dkv_kernel" if dkv else
                         "paddle_tpu/kernels/flash_attention.py:184 "
                         "_dq_kernel"),
            "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": _cuda_ms(lambda: ref(*args), iters=5),
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
            "tflops": flops / (ms * 1e-3) / 1e12,
            "tile": "64 rows per CTA (1 consumer warpgroup) x 64-row "
                    "streamed tiles, 3-stage ring",
            "shape": shape})
    pair_ms = rows[0]["ms"] + rows[1]["ms"]
    print(f"  flash bwd bf16 pair at the training shape: dq "
          f"{rows[0]['ms']:.4f} + dkv {rows[1]['ms']:.4f} = {pair_ms:.4f} ms; "
          f"SDPA's backward (dQ, dK, dV in one call) {library_ms:.4f} ms: "
          f"{pair_ms / library_ms:.3f}x")
    print("  flash bwd bf16, the earlier design, written in, not measured in "
          f"this run: {json.dumps(FLASH_BWD_PREV_MS)}; per training step "
          f"{json.dumps(TRAIN_BWD_GROUPS_PREV_MS)}")
    return rows


def _ce_inputs(r, v, dtype, seed, pad_cols=0):
    """logits [r, v] (a column slice of [r, v + pad_cols] when pad_cols, so
    rows are strided and misaligned), int64 labels with some negative,
    and a per-row upstream gradient."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = (torch.randn((r, v + pad_cols), generator=g, device="cuda")
              * 2).to(dtype)[:, :v]
    labels = torch.randint(0, v, (r,), generator=g, device="cuda")
    labels[::7] = -100
    labels[3] = -1
    grad = torch.randn((r,), generator=g, device="cuda")
    return logits, labels, grad


def _check_ce_case(tag, logits, labels, grad):
    loss, lse = ce.cross_entropy_fwd(logits, labels)
    r_loss, r_lse = ce.cross_entropy_fwd_reference(logits, labels)
    dl = ce.cross_entropy_bwd(logits, labels, lse, grad)
    r_dl = ce.cross_entropy_bwd_reference(logits, labels, lse, grad)
    torch.cuda.synchronize()
    err_fwd = max(_close(tag + " loss", loss, r_loss, CE_LOSS_TOL),
                  _close(tag + " lse", lse, r_lse, CE_LOSS_TOL))
    assert dl.dtype == logits.dtype and dl.is_contiguous()
    err_bwd = _close(tag + " dlogits", dl, r_dl, CE_GRAD_TOL[logits.dtype])
    return err_fwd, err_bwd


def check_ce():
    # R = 777 rows: not a multiple of any tile; V = 3000 and 50257 leave a
    # ragged vocabulary tail, 50304 is the model's padded vocabulary
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for v in (3000, 50257, 50304):
            _check_ce_case(f"ce {name} R=777 V={v}",
                           *_ce_inputs(777, v, dtype, seed=v))
        _check_ce_case(f"ce {name} R=777 V=50257 row stride 50262",
                       *_ce_inputs(777, 50257, dtype, seed=1, pad_cols=5))
    # main-path shape: the logits of 8 x 1024 tokens, bf16
    r, v, dtype = 8192, 50304, torch.bfloat16
    logits, labels, grad = _ce_inputs(r, v, dtype, seed=2)
    err_fwd, err_bwd = _check_ce_case(f"ce bf16 R={r} V={v}", logits,
                                      labels, grad)
    _, lse = ce.cross_entropy_fwd(logits, labels)
    # yardsticks the port never calls: F.cross_entropy(reduction="none")
    # and its autograd backward (which refuse negative labels other than
    # ignore_index, so those rows are ignored there)
    lib_labels = labels.masked_fill(labels < 0, -100)
    lib_logits = logits.detach().requires_grad_(True)
    lib_loss = torch.nn.functional.cross_entropy(
        lib_logits, lib_labels, reduction="none", ignore_index=-100)
    fwd_lib = _cuda_ms(lambda: torch.nn.functional.cross_entropy(
        logits, lib_labels, reduction="none", ignore_index=-100))
    bwd_lib = _cuda_ms(lambda: torch.autograd.grad(
        lib_loss, lib_logits, grad, retain_graph=True))
    elem = logits.element_size()
    shape = f"logits ({r}, {v}) bf16"
    rows = []
    for kind, fn, ref, err, lib_ms, nbytes in (
            ("fwd", lambda: ce.cross_entropy_fwd(logits, labels),
             lambda: ce.cross_entropy_fwd_reference(logits, labels),
             err_fwd, fwd_lib, r * v * elem + r * 8 + 2 * r * 4),
            ("bwd", lambda: ce.cross_entropy_bwd(logits, labels, lse, grad),
             lambda: ce.cross_entropy_bwd_reference(logits, labels, lse,
                                                    grad),
             err_bwd, bwd_lib, 2 * r * v * elem + r * (8 + 4 + 4))):
        # about 4 fp32 operations per element (max, subtract, exp, add)
        bound, by = _bound_ms(nbytes, 4 * r * v, torch.float32)
        ms, host_ms = _timed(fn)
        rows.append({
            "name": f"cross_entropy_{kind}", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/cross_entropy.cu",
            "replaces": ("paddle_tpu/kernels/cross_entropy.py:77 _fwd_kernel"
                         if kind == "fwd" else
                         "paddle_tpu/kernels/cross_entropy.py:107 "
                         "_bwd_kernel"),
            "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": _cuda_ms(ref, iters=5), "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms, "shape": shape})
    return rows



def _adam_state(shapes, dtype, masters, seed, offset=0):
    """Parameters of `shapes` in `dtype` (each a view `offset` elements into
    its storage, so offset 1 misaligns every vector access), their grads,
    fp32 moments and, with `masters`, fp32 masters, from a seed: grads
    ~1e-2, m1 ~1e-3, m2 in [0, 1e-5) (the scale of a trained moment)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def make(shape, scale, dt, positive=False):
        n = int(np.prod(shape))
        flat = (torch.rand if positive else torch.randn)(
            n + offset, generator=g, device="cuda") * scale
        return flat.to(dt)[offset:].view(shape)

    params = [make(s, 1.0, dtype) for s in shapes]
    grads = [make(s, 1e-2, dtype) for s in shapes]
    m1 = [make(s, 1e-3, torch.float32) for s in shapes]
    m2 = [make(s, 1e-5, torch.float32, positive=True) for s in shapes]
    mw = [p.float() + make(s, 1e-3, torch.float32) if masters else None
          for p, s in zip(params, shapes)]
    return params, grads, m1, m2, mw


def _adam_steps(fn, state, decays, lr, t, lrs, coeff):
    """Three updates by fn (the kernel's wrapper or the twin) with the lr
    of each step filled into the device scalars."""
    params, grads, m1, m2, mw = state
    for step, value in enumerate(lrs, 1):
        lr.fill_(value)
        t.fill_(step)
        fn(params, grads, m1, m2, mw, decays, lr, t, 0.9, 0.999, 1e-8, coeff)


def _check_adam_case(tag, shapes, dtype, masters, decays, offset=0):
    """Kernel vs twin over 3 steps from one state: parameters, masters and
    moments bit for bit (ADAM_TOL). Returns the max error and the kernel's
    state."""
    lr, t = (torch.zeros((), device="cuda") for _ in range(2))
    kern = _adam_state(shapes, dtype, masters, seed=3, offset=offset)
    twin = [[None if x is None else x.clone() for x in xs] for xs in kern]
    _adam_steps(au.adam_update, kern, decays, lr, t, ADAM_LRS, 0.01)
    _adam_steps(au.adam_update_reference, twin, decays, lr, t, ADAM_LRS,
                0.01)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("params", "grads", "moment1", "moment2",
                           "master"), kern, twin):
        if name == "grads" or a[0] is None:
            continue
        diff = max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(a, b))
        assert diff <= ADAM_TOL, (tag, name, diff)
        err = max(err, diff)
    print(f"  adam_update {tag}: 3 steps, params, masters and moments "
          f"max_abs_err {err:.3e} (atol {ADAM_TOL})")
    return err, kern


def check_adam_update():
    """The multi-tensor AdamW update at GPT-2 124M's 148 tensors (bf16
    params with fp32 masters, every tensor decaying, as the train phase
    runs it), plus fp32 without masters and bf16 without masters on
    ragged shapes with a decay-skip set, aligned and misaligned."""
    model = GPTForCausalLM(gpt2_124m(), device="cuda", seed=0)
    shapes = [tuple(p.shape) for p in model.parameters()]
    del model
    ragged = [(7, 13), (768,), (5,), (3, 4, 5), (1,), (2, 8195)]
    skip = [i % 2 == 0 for i in range(len(ragged))]
    for dtype in (torch.float32, torch.bfloat16):
        for offset in (0, 1):
            _check_adam_case(f"{str(dtype)[6:]} no masters, ragged shapes, "
                             f"offset {offset}", ragged, dtype, False, skip,
                             offset)
    _check_adam_case("bf16 + masters, ragged shapes", ragged,
                     torch.bfloat16, True, skip)
    decays = [True] * len(shapes)
    err, state = _check_adam_case(
        f"bf16 + masters, GPT-2 124M ({len(shapes)} tensors, "
        f"{sum(int(np.prod(s)) for s in shapes)} elements)", shapes,
        torch.bfloat16, True, decays)
    params, grads, m1, m2, mw = state
    lr = torch.full((), TRAIN_LR, device="cuda")
    t = torch.full((), 4.0, device="cuda")
    args = (params, grads, m1, m2, mw, decays, lr, t, 0.9, 0.999, 1e-8,
            0.01)
    nbytes = au.update_bytes(params, mw)
    # ~15 fp32 operations an element (two moments, decay, sqrt, divide)
    bound, by = _bound_ms(nbytes, 15 * sum(p.numel() for p in params),
                          torch.float32)
    ms, host_ms = _timed(lambda: au.adam_update(*args))
    plain_ms = _cuda_ms(lambda: au.adam_update_reference(*args), iters=5)
    # a yardstick of PyTorch's own fused AdamW at the same shapes: another
    # formula (epsilon after the bias correction), so not library_ms
    steps = [torch.full((), 4.0, device="cuda") for _ in params]
    grads32 = [g.float() for g in grads]
    other_ms = _cuda_ms(lambda: torch._fused_adamw_(
        mw, grads32, m1, m2, [], steps, lr=TRAIN_LR,
        beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
        maximize=False))
    return {"name": "adam_update", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/adam_update.cu",
            "replaces": ("no Pallas counterpart: the jitted batch update of "
                         "paddle_tpu/optimizer/optimizer.py:131-197 over "
                         "the rule of paddle_tpu/optimizer/optimizers.py:"
                         "76-148 (XLA ops)"),
            "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "bytes": nbytes,
            "shape": (f"GPT-2 124M's {len(params)} tensors, bf16 params + "
                      f"fp32 masters and moments, every tensor decaying"),
            "note": ("library_ms null: no PyTorch call computes Paddle's "
                     "formula (torch._fused_adamw_ adds epsilon after the "
                     f"bias correction); that call at the same shapes, "
                     f"fp32 grads: {other_ms:.4f} ms, another formula")}

def _keyed_state(s, v, seed, sampled):
    """Raw fp32 logits [s, v] (scale of GPT-2's), a filtered copy with the
    entries below each row's 40th largest masked to -1e30 (top-k's
    threshold), temperatures (slots in `sampled` at 0.8, the rest greedy),
    uint32 seeds as int32 bits and positions in [1, 1024]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    raw = 4.0 * torch.randn(s, v, device="cuda", generator=g)
    kth = raw.topk(40, dim=-1).values[:, -1:]
    filtered = raw.masked_fill(raw < kth, -1e30)
    temps = torch.zeros(s, device="cuda")
    temps[list(sampled)] = 0.8
    seeds = torch.randint(-2 ** 31, 2 ** 31, (s,), device="cuda",
                          dtype=torch.int32, generator=g)
    positions = torch.randint(1, 1025, (s,), device="cuda",
                              dtype=torch.int32, generator=g)
    return raw, filtered, temps, seeds, positions


def check_keyed_draw():
    """The keyed draw (`csrc/keyed_draw.cu`) against its twin, which runs on
    the CPU on copies of the same inputs: KEYED_ROUNDS rounds of 8 slots
    (greedy and sampled) at each of V = 50257 and the serving model's
    padded V = 50304, fresh seeds and positions each. Each round launches
    the kernel twice on the same inputs: with the debug output (every
    index's bits and noise, which must equal the twin's bit for bit) and
    as the decode step launches it; both launches' tokens must equal the
    twin's at every slot. Then timed at the serving path's shape (8 slots,
    V = 50304: the serve mix's 2 sampled slots, and all 8 sampled) with
    the launch queue filled ahead. There is no single PyTorch call for the
    draw (library_ms null)."""
    s = KEYED_SLOTS
    noise_err, slots, near = 0.0, 0, 0
    for v in KEYED_VOCABS:
        for r in range(KEYED_ROUNDS):
            sampled = range(r % 3, s, 1 + r % 3)
            raw, filtered, temps, seeds, pos = _keyed_state(
                s, v, 100 * v + r, sampled)
            bits = torch.empty((s, v), dtype=torch.int32, device="cuda")
            noise = torch.empty((s, v), device="cuda")
            debug = kd.keyed_draw(raw, filtered, temps, seeds, pos,
                                  debug=(bits, noise))
            out = torch.full((s,), -1, dtype=torch.int32, device="cuda")
            feedback = torch.full_like(out, -1)
            kd.keyed_draw(raw, filtered, temps, seeds, pos, out=out,
                          feedback=feedback)
            torch.cuda.synchronize()
            cpu = [t.cpu() for t in (raw, filtered, temps, seeds, pos)]
            k0, k1 = kd.slot_keys(cpu[3], cpu[4])
            want_bits = kd.random_bits(k0, k1, v).to(torch.int32)
            assert torch.equal(bits.cpu(), want_bits), \
                f"V={v} round {r}: bits differ"
            want_noise = -kd.xla_log(-kd.xla_log(kd.uniform(
                want_bits.to(torch.int64) & 0xFFFFFFFF)))
            got_noise = noise.cpu()
            noise_err = max(noise_err,
                            (got_noise - want_noise).abs().max().item())
            differ = int((got_noise.view(torch.int32)
                          != want_noise.view(torch.int32)).sum())
            assert differ == 0, \
                f"V={v} round {r}: {differ} noise values differ"
            want = kd.keyed_draw_reference(*cpu)
            for name, got in (("debug", debug), ("decode", out),
                              ("feedback", feedback)):
                assert torch.equal(got.cpu(), want), \
                    (v, r, name, got.tolist(), want.tolist())
            scores = torch.where(cpu[2][:, None] > 0, want_noise + cpu[1],
                                 cpu[0])
            top2 = scores.topk(2, dim=-1).values
            near += int(((top2[:, 0] - top2[:, 1]) <= KEYED_MARGIN).sum())
            slots += s
    print(f"  keyed_draw S={s} V={'/'.join(map(str, KEYED_VOCABS))}: "
          f"{KEYED_ROUNDS} rounds x {s} slots each (greedy and sampled): "
          f"random bits and noise bit-identical to the twin (max_abs_err "
          f"{noise_err:.3e}); tokens of the debug launch and of the decode "
          f"step's launch (out and feedback) equal the twin's at all "
          f"{slots} slots ({near} with a winning margin <= {KEYED_MARGIN})")
    # main-path shape: the padded vocabulary, the serve mix's 2 sampled
    # slots of 8, then all 8 sampled, then none (the greedy head's
    # launch); each timed in turns with the first design (one CTA of 1024
    # threads a slot, commit e4c03f5): first, this, this, first
    v = 50304
    one_cta = _one_cta_draw()
    row, turns = {}, {}
    for sampled, key in (((6, 7), "ms"), (range(s), "all_sampled_ms"),
                         ((), "greedy_ms")):
        raw, filtered, temps, seeds, pos = _keyed_state(s, v, 7, sampled)
        out = torch.empty(s, dtype=torch.int32, device="cuda")
        feedback = torch.empty_like(out)
        args = (raw, filtered, temps, seeds, pos)
        times = [_timed(lambda: (one_cta if first else kd.keyed_draw)(
            *args, out=out, feedback=feedback)) for first in TURNS]
        turns[key] = [round(t[0], 5) for t in times]
        row[key] = float(np.mean([t[0] for t, first in zip(times, TURNS)
                                  if not first]))
        if key == "ms":
            row["host_ms"] = times[1][1]
            cpu = [t.cpu() for t in args]
            t0 = time.perf_counter()
            kd.keyed_draw_reference(*cpu)
            row["plain_ms"] = (time.perf_counter() - t0) * 1e3
    # bytes: each slot reads one fp32 row (raw if greedy, filtered if
    # sampled); operations: threefry's INT32 instructions at every index of
    # a sampled slot, over the card's INT32 issue rate
    int_rate = _int32_ops_per_s()
    t_bytes = s * v * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * v * THREEFRY_INT_OPS / int_rate * 1e3
    bound, by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")
    all_ops = s * v * THREEFRY_INT_OPS / int_rate * 1e3
    print(f"  keyed_draw S={s} V={v}: {row['ms']:.5f} ms (2 slots sampled), "
          f"{row['all_sampled_ms']:.5f} ms (8 sampled), "
          f"{row['greedy_ms']:.5f} ms (none sampled); bound {bound:.5f} ms "
          f"({by}; bytes {t_bytes:.5f}, INT32 issue {t_ops:.5f} at "
          f"{int_rate / 1e12:.3f} T/s; 8 sampled: {max(t_bytes, all_ops):.5f})"
          f"; twin on the CPU {row['plain_ms']:.1f} ms")
    print(f"KEYED_DRAW_TURNS_MS (first design, this, this, first design; "
          f"the first design is commit e4c03f5's, "
          f"tools/torch_keyed_draw_one_cta.cu): "
          + json.dumps(turns))
    return {"name": "keyed_draw", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/keyed_draw.cu",
            "replaces": "no Pallas counterpart: the draw of "
                        "paddle_tpu/serving/sampling.py:168-171 "
                        "(jax.random.categorical under fold_in keys, XLA "
                        "ops)",
            "max_abs_err": noise_err, **row, "turns_ms": turns,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "bytes_bound_ms": t_bytes, "int32_bound_ms": t_ops,
            "int32_bound_all_sampled_ms": all_ops,
            "shape": "S=8 V=50304 fp32 logits, 2 of 8 slots sampled "
                     "(all_sampled_ms: 8 of 8; greedy_ms: none, as the "
                     "greedy head launches it); max_abs_err: the noise, "
                     "kernel vs twin, at V=50257 and V=50304",
            "note": "plain_ms is the twin's host time on the CPU: the twin "
                    "never takes a CUDA tensor; turns_ms: the one-CTA "
                    "design (commit e4c03f5), this, this, the one-CTA"}


# INT32 instructions of one threefry2x32 (csrc/keyed_draw.cu): 20 rounds of
# add, funnel-shift rotate and xor, 5 key injections of two adds, one
# initial add; the build phase prints the kernel's SASS counts beside it
THREEFRY_INT_OPS = 72
# in turns: the earlier design (True) around this one
TURNS = (True, False, False, True)


def _int32_ops_per_s():
    """The card's INT32 issue rate: 64 lanes per SM per clock x the SMs x
    the largest SM clock nvidia-smi reports."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 64 * sms * mhz * 1e6


# earlier designs kept in tools/ with their kernels' C interfaces, built
# by `_start_tool_builds` beside the port's sources and timed in turns
TOOL_SOURCES = ("torch_keyed_draw_one_cta", "torch_sampler_filter_radix",
                "torch_prefill_scatter_twopass")
_TOOL_LIBS = {}


def _start_tool_builds():
    """One nvcc process for each of TOOL_SOURCES, all started at once
    (`_finish_tool_builds` waits for them)."""
    root = Path(__file__).resolve().parent
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in TOOL_SOURCES:
        lib = _build.BUILD_DIR / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS,
             f"-I{root / 'paddle_tpu_torch' / 'csrc'}", "-o", str(lib),
             str(root / "tools" / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    return procs


def _finish_tool_builds(procs):
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name}: nvcc failed\n{log}"
        _TOOL_LIBS[name] = ctypes.CDLL(str(lib))


_ONE_CTA = []


def _one_cta_draw():
    """The first keyed draw (commit e4c03f5;
    tools/torch_keyed_draw_one_cta.cu, the same C interface) as a function
    of the wrapper's arguments (no launch count): the yardstick the
    redesign is timed against."""
    if not _ONE_CTA:
        fn = _TOOL_LIBS["torch_keyed_draw_one_cta"].paddle_keyed_draw
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def draw(raw, filtered, temps, seeds, pos, out=None, feedback=None):
            if out is None:
                out = torch.empty(raw.shape[0], dtype=torch.int32,
                                  device=raw.device)
            ptrs = [ctypes.c_void_p(None if t is None else t.data_ptr())
                    for t in (raw, filtered, temps, seeds, pos, out,
                              feedback)]
            err = fn(*ptrs, None, None, raw.shape[0], raw.shape[1],
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            assert err == 0, err
            return out

        _ONE_CTA.append(draw)
    return _ONE_CTA[0]


# sampler_filter's row configs (temperature, top_k, top_p, penalty): the
# serve mix's sampled requests (top-k 40, top-p 0.95) with and without a
# penalty, then the ragged set: greedy rows, k = 1, k beyond V, a tiny
# top-p, top-p 1, penalties below and above 1; then the set that overflows
# the candidates over logits of few values (k = 200 and 256: ties at the
# bound), beside candidates (k = 1, 40) and radix rows (k = 0, 300)
FILTER_MAIN = [(0.0, 0, 1.0, 1.0)] * 6 + [(0.8, 40, 0.95, 1.0),
                                          (0.8, 40, 0.95, 1.3)]
FILTER_RAGGED = [(0.8, 40, 0.95, 1.0), (0.0, 40, 0.95, 1.3),
                 (1.0, 1, 1.0, 1.0), (0.9, 10 ** 6, 0.9, 0.7),
                 (1.5, 0, 1e-6, 1.0), (0.7, 5, 1.0, 2.0),
                 (1.1, 0, 0.5, 0.9), (1.0, 100, 0.99, 1.2)]
FILTER_OVERFLOW = [(1.0, 200, 0.9, 1.0), (1.0, 256, 1.0, 1.0),
                   (0.9, 200, 1.0, 1.2), (0.8, 40, 0.95, 1.0),
                   (0.0, 40, 0.95, 1.0), (1.0, 0, 0.9, 1.0),
                   (1.1, 300, 0.9, 1.0), (0.7, 1, 0.5, 1.0)]
# top-p only (top-k 0, top-p 0.9): the radix route, timed in turns
FILTER_TOP_P = [(0.0, 0, 1.0, 1.0)] * 6 + [(0.8, 0, 0.9, 1.0),
                                           (0.8, 0, 0.9, 1.3)]
FILTER_ROUNDS = 4
FILTER_CONTEXT = 1024
# the most of the sampled rows whose cut the margin leaves open (more than
# one allowed): a row falls there only when tokens of probability below
# ~2 x MARGIN sit at its top-p boundary and its top-k cut is not above
# them; the same rounds drawn on the CPU give none of 72
FILTER_MARGIN_SHARE = 0.125


def _filter_state(v, seed, rows, ties=False):
    """Raw fp32 logits [S, v] (scale of GPT-2's; rounded to integers with
    `ties`, rounded to integers of N(0, 1) with ``ties="few"``; a third
    of them masked to -1e30 in odd rounds), each row's config from `rows`,
    and a history [S, 1024] of ids with 1 to 1024 valid positions."""
    s = len(rows)
    g = torch.Generator(device="cuda").manual_seed(seed)
    raw = 4.0 * torch.randn(s, v, device="cuda", generator=g)
    if ties == "few":
        raw = (raw / 4).round()
    elif ties:
        raw = raw.round()
    if seed % 2:
        raw[:, ::3] = -1e30
    cfg = torch.tensor(rows, dtype=torch.float64, device="cuda").T
    history = torch.randint(0, v, (s, FILTER_CONTEXT), device="cuda",
                            dtype=torch.int32, generator=g)
    lens = torch.randint(1, FILTER_CONTEXT + 1, (s, 1), device="cuda",
                         generator=g)
    valid = torch.arange(FILTER_CONTEXT, device="cuda")[None, :] < lens
    return (raw, cfg[0].float(), cfg[1].to(torch.int32), cfg[2].float(),
            cfg[3].float(), history, valid)


def check_sampler_filter():
    """The filter kernel (`csrc/sampler_filter.cu`) against its twin, which
    runs on the CPU on copies of the same inputs: FILTER_ROUNDS rounds of
    the serve mix's configs (6 greedy rows, 2 sampled: top-k 40, top-p
    0.95, one with a repetition penalty), of the ragged set and of the
    overflow set (logits of few values), at V = 50257 and 50304, fresh
    logits and histories each (ties in some rounds, -1e30 entries in
    others). The output buffer is filled with a sentinel first: greedy
    rows must keep it; every sampled row must equal the twin's bit for
    bit unless some top-p mass of it lies within `sf.MARGIN` of top_p
    (`sf.margin_cuts` allows more than one cut): such a row, and the
    twin's, must be the row cut at one of the thresholds it allows, and
    those rows are counted, printed and held to at most
    FILTER_MARGIN_SHARE of the sampled rows. Each launch reports its
    rows' routes, which must be `sf.filter_routes`' (the kernel's rule on
    the CPU); the rows of each route are counted, and the candidates,
    overflow and radix routes must each be reached. Then timed at the
    serving shape with the launch queue filled ahead, 2 and 8 of 8 rows
    sampled, and on top-p-only rows, in turns with the first design
    (commit c3b6374, tools/torch_sampler_filter_radix.cu: radix select
    for every row); the twin (the sort-based filter) on the card is its
    plain time. No single PyTorch call computes the thresholds
    (library_ms null)."""
    rows_checked, inside, err, where = 0, 0, 0.0, []
    by_route = dict.fromkeys(sf.ROUTES, 0)
    for v in KEYED_VOCABS:
        for r in range(FILTER_ROUNDS):
            for name, rows, ties in (("main", FILTER_MAIN, r % 2 == 0),
                                     ("ragged", FILTER_RAGGED, r % 2 == 0),
                                     ("overflow", FILTER_OVERFLOW, "few")):
                args = _filter_state(v, 1000 * v + r, rows, ties=ties)
                out = torch.full(args[0].shape, 7.0, device="cuda")
                routes = torch.full((len(rows),), -1, dtype=torch.int32,
                                    device="cuda")
                sf.sampler_filter(*args, out=out, routes=routes)
                torch.cuda.synchronize()
                cpu = [t.cpu() for t in args]
                want = sf.sampler_filter_reference(*cpu)
                lg, cuts = sf.margin_cuts(*cpu)
                want_routes = sf.filter_routes(*cpu)
                assert torch.equal(routes.cpu(), want_routes), \
                    (v, r, name, routes.tolist(), want_routes.tolist())
                for code in want_routes.tolist():
                    by_route[sf.ROUTES[code]] += 1
                got = out.cpu()
                for row in range(len(rows)):
                    if not cpu[1][row] > 0:
                        assert torch.all(got[row] == 7.0), (v, r, name, row)
                        continue
                    rows_checked += 1
                    allowed = [lg[row].masked_fill(lg[row] < c, -1e30)
                               .view(torch.int32) for c in cuts[row]]
                    for tag, t in (("kernel", got[row]), ("twin", want[row])):
                        assert any(torch.equal(t.view(torch.int32), a)
                                   for a in allowed), \
                            (v, r, name, row, tag, cuts[row])
                    if len(cuts[row]) > 1:
                        inside += 1
                        where.append(f"V={v} round {r} {name} row {row} "
                                     f"({len(cuts[row])} cuts, route "
                                     f"{sf.ROUTES[want_routes[row]]})")
                        continue
                    same = torch.equal(got[row].view(torch.int32),
                                       want[row].view(torch.int32))
                    assert same, (v, r, name, row, int(
                        (got[row] != want[row]).sum()))
                    err = max(err, (got[row] - want[row]).abs().max().item())
    assert inside <= FILTER_MARGIN_SHARE * rows_checked, (inside,
                                                          rows_checked)
    assert all(by_route[k] > 0 for k in ("candidates", "overflow", "radix")), \
        by_route
    print(f"  sampler_filter V={'/'.join(map(str, KEYED_VOCABS))}: "
          f"{FILTER_ROUNDS} rounds of the serve mix's, the ragged and the "
          f"overflow configs: {rows_checked} sampled rows, bit for bit with "
          f"the twin outside the margin; {inside} rows with an exclusive "
          f"mass within {sf.MARGIN} of top_p (SAMPLER_FILTER_MARGIN_ROWS "
          f"{inside}), each cut at a threshold the margin allows, as the "
          f"twin's; greedy rows untouched; routes as filter_routes', rows "
          f"by route {json.dumps(by_route)}")
    print("SAMPLER_FILTER_MARGIN_WHERE: " + json.dumps(where))
    # main-path shape: 2 of 8 rows sampled, as the serve mix's full head,
    # then 8 of 8, then top-p-only rows (the radix route), each timed in
    # turns with the first design: first, this, this, first
    v = 50304
    radix = _TOOL_LIBS["torch_sampler_filter_radix"]
    sets = {"ms": FILTER_MAIN, "all_sampled_ms": [FILTER_MAIN[-1]] * 8,
            "top_p_only_ms": FILTER_TOP_P,
            "top_p_only_all_sampled_ms": [FILTER_TOP_P[-1]] * 8}
    row, turns = {}, {}
    out = torch.empty((8, v), device="cuda")
    for key, rows in sets.items():
        args = _filter_state(v, 8, rows)

        def first():
            assert sf.run(radix, *args, out) == 0

        times = [_timed(first if old else
                        lambda: sf.sampler_filter(*args, out=out))
                 for old in TURNS]
        turns[key] = [round(t[0], 5) for t in times]
        row[key] = float(np.mean([t[0] for t, old in zip(times, TURNS)
                                  if not old]))
        if key == "ms":
            row["host_ms"] = times[1][1]
            row["plain_ms"] = _cuda_ms(
                lambda: sf.sampler_filter_reference(*args), iters=5)
    # each sampled row's logits read and its output written once, its
    # history (int32) and valid flags (bool) read once
    sampled = sum(1 for cfg in FILTER_MAIN if cfg[0] > 0)
    nbytes = sampled * (v * 8 + FILTER_CONTEXT * 5)
    bound, by = _bound_ms(nbytes, 0, torch.float32)
    print(f"  sampler_filter S=8 V={v}: {row['ms']:.5f} ms (2 rows "
          f"sampled), {row['all_sampled_ms']:.5f} ms (8 sampled); top-p "
          f"only {row['top_p_only_ms']:.5f} / "
          f"{row['top_p_only_all_sampled_ms']:.5f} ms; bound {bound:.5f} ms "
          f"({by}); twin (sort, softmax, cumsum) on the card "
          f"{row['plain_ms']:.5f} ms")
    print("SAMPLER_FILTER_TURNS_MS (first design, this, this, first design; "
          "the first design is commit c3b6374's, "
          "tools/torch_sampler_filter_radix.cu): " + json.dumps(turns))
    return {"name": "sampler_filter", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/sampler_filter.cu",
            "replaces": "no Pallas counterpart: the filter of "
                        "paddle_tpu/serving/sampling.py:141-166 (sort, "
                        "softmax, cumsum, thresholds; XLA ops)",
            "max_abs_err": err, **row, "turns_ms": turns,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "margin_rows": inside, "routes": by_route,
            "shape": "S=8 V=50304 fp32 logits, 2 of 8 rows sampled (top-k "
                     "40, top-p 0.95, penalty 1 and 1.3 over 1024 history "
                     "positions; all_sampled_ms: 8 of 8; top_p_only_ms: "
                     "top-k 0, top-p 0.9, 2 and 8 of 8)",
            "note": "turns_ms: the first design (commit c3b6374, radix "
                    "select for every row), this, this, the first"}


# ---------------------------------------------------------------------------
# phase 4: the serving path at full width
# ---------------------------------------------------------------------------

def _serve_mix(rng):
    """The serve phases' requests, ``[(prompt, add_request kwargs)]``: 16
    greedy prompts of 16-960 tokens and one of 990 (so the 1024 bucket
    runs), then 2 sampled ones (temperature 0.8, top-k 40, top-p 0.95)."""
    lens = list(rng.integers(16, 961, 16)) + [990]
    mix = [(rng.integers(0, 50257, int(n)).tolist(), {}) for n in lens]
    for i in range(2):
        mix.append((rng.integers(0, 50257, 64 + 32 * i).tolist(),
                    dict(temperature=0.8, top_k=40, top_p=0.95, seed=i)))
    return mix


def _watch_heads(engine):
    """Record, on `engine`'s instance, each decode launch's head (True:
    the full sampler head) and each prefill's (True: the request samples);
    returns the two lists. `del engine._samples, engine._prefill` stops."""
    heads, prefills = [], []

    def samples(active, orig=engine._samples):
        heads.append(orig(active))
        return heads[-1]

    def prefill(ctx, bucket, row, req, orig=engine._prefill):
        prefills.append(req.temperature > 0)
        return orig(ctx, bucket, row, req)

    engine._samples = samples
    engine._prefill = prefill
    return heads, prefills


def _measure_captures(engine):
    """Record, on `engine`'s instance, the device memory each prefill graph
    capture reserves (the prefill programs' shared pool grows by it):
    returns the list of deltas in bytes."""
    deltas = []

    def captured(fn, orig=engine._captured):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        out = orig(fn)
        deltas.append(torch.cuda.memory_reserved() - before)
        return out

    engine._captured = captured
    return deltas


def _serve_window(engine, mix):
    """The mix through `engine` from zeroed counts and stats: returns the
    requests, the launch counts, the window's stats, the heads of its
    decode launches, its prefills' sampled flags and its wall time."""
    engine.reset_stats()
    heads, prefills = _watch_heads(engine)
    reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [engine.add_request(p, max_new_tokens=24, **kw) for p, kw in mix]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    del engine._samples, engine._prefill
    return reqs, counts, engine.stats(), heads, prefills, wall


def serve(kv_dtype=None):
    """The serving mix through `LLMEngine` (bf16 pools, or int8 with
    ``kv_dtype="int8"``), whose decode step is one CUDA graph replay and
    whose prefill is one replay of its bucket's graph and one of a sampler
    head's: one decode build (decode_compiles) and the first bucket's
    prefill build in the warm-up, one prefill build for each bucket the
    mix reaches first in the counted window (whose warm-ups launch the
    bucket's kernels once more), none in a second, warm pass of the mix,
    and every kernel counted once per replay. Then the decode graph
    against the eager step (`_graph_vs_eager`) and the prefill graphs
    against the eager prefill (`_prefill_vs_eager`). Returns the launch
    counts of the warm pass, the greedy requests' tokens of the first
    window and the model."""
    tag = "serve_int8" if kv_dtype else "serve"
    paged, other = (("paged_decode_append_int8", "paged_decode_append")
                    if kv_dtype else ("paged_decode_append",
                                      "paged_decode_append_int8"))
    scatter, other_scatter = (("prefill_scatter_int8", "prefill_scatter")
                              if kv_dtype else ("prefill_scatter",
                                                "prefill_scatter_int8"))
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device="cuda", seed=0).to(torch.bfloat16)
    engine = LLMEngine(model, max_batch_size=8, block_size=16,
                       max_context=1024, kv_dtype=kv_dtype)
    captures = _measure_captures(engine)
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator, the decode graph's capture, the
    # first prefill bucket's and the sampler heads'), outside the window
    engine.generate([rng.integers(0, 50257, 20).tolist()], max_new_tokens=2)
    st = engine.stats()
    assert st["decode_compiles"] == 1 and st["prefill_compiles"] == 1, st
    warm_buckets = set(engine._prefill_fns)
    mix = _serve_mix(rng)
    layers = cfg.num_hidden_layers
    passes = {}
    for name in ("first", "warm"):
        reqs, counts, st, heads, prefills, wall = _serve_window(engine, mix)
        passes[name] = counts, st
        buckets = set(st["prefill_p50_ms"])
        new = buckets - warm_buckets
        warm_buckets |= buckets
        # one build for each bucket this pass reached first: none warm
        assert st["prefill_compiles"] == len(new), (name, st, new)
        assert bool(new) == (name == "first"), (name, new)
        builds = st["prefill_compiles"]
        # the steps with a sampling slot ran the full head, the rest the
        # greedy
        assert len(heads) == st["steps"] and 0 < sum(heads) < len(heads), \
            (len(heads), sum(heads), st["steps"])
        assert all(r.state == "FINISHED" and len(r.generated) == 24
                   for r in reqs), [(r.rid, r.state) for r in reqs]
        assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated)
        assert st["decode_compiles"] == 0, st
        assert counts["flash_attention_fwd"] > 0 and counts[paged] > 0, counts
        # one launch a layer writes and attends: the paged kernel alone
        # (kAppend off) never runs on this path
        assert counts[paged] == layers * st["steps"], (counts, st)
        assert counts[other] == 0 and counts["paged_decode"] == 0 \
            and counts["paged_decode_int8"] == 0, counts
        # each prefill replays its bucket's graph: the flash kernel a layer
        # and the scatter once; each build's eager warm-up launches them
        # once more
        assert counts["flash_attention_fwd"] == layers * (
            st["prefills"] + builds), (counts, st)
        assert counts[scatter] == st["prefills"] + builds > 0, (counts, st)
        assert counts[other_scatter] == 0, counts
        # the sampler's draw: one launch in each replay and each prefill;
        # its filter: one in each full-head replay and each sampled prefill
        assert counts["keyed_draw"] == st["steps"] + st["prefills"], \
            (counts, st)
        assert counts["sampler_filter"] == sum(heads) + sum(prefills) > 0, \
            (counts, sum(heads), sum(prefills))
        assert 1024 in st["prefill_p50_ms"], st["prefill_p50_ms"]
        assert st["kv_dtype"] == ("int8" if kv_dtype else "bfloat16"), st
        print(f"{tag} ({name} pass): {len(reqs)} requests, "
              f"{st['tokens_generated']} tokens in {wall:.3f} s = "
              f"{st['tokens_generated'] / wall:.1f} tok/s; {st['steps']} "
              f"decode steps (graph replays; {st['decode_compiles']} decode "
              f"builds in the window, 1 in the warm-up; {sum(heads)} with "
              f"the full sampler head, {len(heads) - sum(heads)} with the "
              f"greedy head; sampler_filter launches "
              f"{counts['sampler_filter']} = full-head replays + "
              f"{sum(prefills)} sampled prefills), p50 "
              f"{st['p50_step_ms']:.3f} ms, p99 {st['p99_step_ms']:.3f} ms; "
              f"TTFT p50 {st['ttft_p50_ms']:.3f} ms, p99 "
              f"{st['ttft_p99_ms']:.3f} ms; {st['prefills']} prefills, "
              f"{builds} prefill builds (buckets first reached: "
              f"{sorted(new)}), {st['evictions']} evictions; "
              f"{scatter} launches {counts[scatter]} = prefills + builds; "
              f"occupancy {st['occupancy_mean']:.3f}")
        print(f"{tag} ({name} pass): prefill p50 ms by bucket (host clock, "
              f"a build included where the pass built the bucket) "
              + json.dumps({str(b): round(v, 3)
                            for b, v in st["prefill_p50_ms"].items()}))
        print(f"{tag} ({name} pass): launches {json.dumps(counts)}")
        if name == "first":
            greedy = [list(r.generated) for r in reqs if r.temperature == 0]
    print(f"{tag}: prefill graphs, {len(captures)} captures ("
          f"{len(engine._prefill_fns)} buckets and 2 sampler heads) "
          f"reserved {sum(captures) / 2**20:.1f} MiB in their shared pool "
          f"(by capture, MiB: "
          f"{json.dumps([round(d / 2**20, 1) for d in captures])})")
    _graph_vs_eager(tag, model, engine, kv_dtype, rng)
    _prefill_vs_eager(tag, model, kv_dtype, rng)
    return passes["warm"][0], greedy, model


# the decode graph against the eager step: steps of each, in turns
GRAPH_VS_EAGER_STEPS = 20


def _graph_vs_eager(tag, model, engine, kv_dtype, rng):
    """`engine` (its decode graph built) and a second engine on the same
    model whose steps run `_decode_step_eager`, stepped in turns over the
    same 8 requests of 200-token prompts: the greedy tokens must be equal
    after every step; the logits' max abs difference is reported (equal
    bit for bit is expected; cuBLAS may choose another algorithm under
    capture). Prints both engines' step p50 and the replay's device time
    (CUDA events around the replay, the sampler in it). Then 4 steps of 8
    full slots of each engine under torch.profiler: the eager engine's
    window names every kernel; the graph's names them too where the
    profiler traces graph nodes (it did on the H100 runs of PERF.md), else
    it shows one graph launch. Both steps sample inside (the graph's
    sampler is captured with it)."""
    eager = LLMEngine(model, max_batch_size=8, block_size=16,
                      max_context=1024, kv_dtype=kv_dtype)
    eager._decode_step = eager._decode_step_eager
    logits, replay_ms = {}, []

    def recording(name, fn):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            logits[name] = (out[:, -1].float().clone(), start, end)
            return out
        return call

    program = engine._decode_program
    engine._decode_program = recording("graph", program)
    eager._decode_code = recording("eager", eager._decode_code)
    engine.reset_stats()
    prompts = [rng.integers(0, 50257, 200).tolist() for _ in range(8)]
    g_reqs = [engine.add_request(p, max_new_tokens=32) for p in prompts]
    e_reqs = [eager.add_request(p, max_new_tokens=32) for p in prompts]
    err = 0.0
    for i in range(GRAPH_VS_EAGER_STEPS):
        engine.step()
        eager.step()
        g_toks = [list(r.generated) for r in g_reqs]
        e_toks = [list(r.generated) for r in e_reqs]
        assert g_toks == e_toks, (tag, i, g_toks, e_toks)
        (g_lg, start, end), (e_lg, _, _) = logits["graph"], logits["eager"]
        err = max(err, (g_lg - e_lg).abs().max().item())
        replay_ms.append(start.elapsed_time(end))
    g_st, e_st = engine.stats(), eager.stats()
    assert g_st["decode_compiles"] == 0 and e_st["decode_compiles"] == 0, \
        (g_st, e_st)
    assert all(len(r.generated) == GRAPH_VS_EAGER_STEPS + 1
               for r in g_reqs), [len(r.generated) for r in g_reqs]
    print(f"{tag}: decode graph vs eager, {GRAPH_VS_EAGER_STEPS} steps each "
          f"in turns, 8 slots of 200-token prompts: greedy tokens identical "
          f"at every step; logits max_abs_err {err:.3e} ("
          f"{'bit-identical' if err == 0 else 'not bit-identical'}; "
          f"reported, not held); step p50 graph {g_st['p50_step_ms']:.3f} ms, "
          f"eager {e_st['p50_step_ms']:.3f} ms; replay device time p50 "
          f"{float(np.median(replay_ms)):.4f} ms (min {min(replay_ms):.4f}, "
          f"CUDA events around the replay, sampler included)")
    _breakdown(f"{tag} decode, eager engine", lambda: [eager.step()
                                                       for _ in range(4)],
               per=4)
    _breakdown(f"{tag} decode, graph replay", lambda: [engine.step()
                                                       for _ in range(4)],
               per=4)
    engine.run()
    eager.run()
    engine._decode_program = program


# the prefill graphs against the eager prefill: prompts a bucket a turn,
# in turns
PREFILL_VS_EAGER = 20
PREFILL_TURNS = ("graph", "eager", "eager", "graph")
PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)


class _Recorded:
    """A model whose calls keep the logits row each prompt samples from
    while `lengths` lists the prompts' lengths, in order: the eager
    prefill's forward, read where it happens."""

    def __init__(self, model):
        self.model, self.gen_caches = model, model.gen_caches
        self.lengths, self.rows = [], []

    def __call__(self, ids, caches):
        logits, kv = self.model(ids, caches=caches)
        if self.lengths:
            self.rows.append(logits[0, self.lengths.pop(0) - 1].float())
        return logits, kv


def _prefill_vs_eager(tag, model, kv_dtype, rng):
    """The prefill program (`_prefill`: one bucket replay and one head
    replay) against `_prefill_eager` on a second engine, in turns
    (PREFILL_TURNS) at each of PREFILL_BUCKETS, PREFILL_VS_EAGER prompts a
    bucket a turn (lengths in the bucket's upper half, every fourth
    sampled), each prompt into a block row of its own: the sampled tokens
    and logprobs must be equal, and the pools (int8: levels and scales)
    equal on every block but 0, after each turn pair. Prints the last-row
    logits' max difference (reported), both engines' prefill p50 by bucket
    (host clock around `_prefill`, which ends in the wait for its outputs)
    and a profiled window of each at buckets 16 and 1024 (device time by
    kernel group, kernels a prefill)."""
    n, m = PREFILL_VS_EAGER, 64
    engines = {name: LLMEngine(model, max_batch_size=8, block_size=16,
                               max_context=1024, kv_dtype=kv_dtype,
                               num_blocks=1 + n * m)
               for name in ("graph", "eager")}
    eager = engines["eager"]
    eager._prefill = eager._prefill_eager
    recorded = eager._model = _Recorded(model)
    times = {name: {b: [] for b in PREFILL_BUCKETS} for name in engines}
    for bucket in PREFILL_BUCKETS:         # built ahead: the turns time
        engines["graph"]._build_prefill(bucket)        # replays alone
    err = 0.0
    for bucket in PREFILL_BUCKETS:
        reqs = []
        for i in range(n):
            length = int(rng.integers(bucket // 2 + 1, bucket + 1))
            kw = (dict(temperature=0.8, top_k=40, top_p=0.95, seed=i)
                  if i % 4 == 3 else {})
            req = Request(f"p{i}", rng.integers(0, 50257, length).tolist(),
                          1, **kw)
            req.slot = i % 8
            row = np.zeros(m, np.int32)
            used = -(-length // 16)
            row[:used] = 1 + i * m + np.arange(used)
            reqs.append((req, row))
        outs, logits = {}, []
        for turn, name in enumerate(PREFILL_TURNS):
            engine, got = engines[name], []
            if turn == 1:
                recorded.lengths = [len(req.prompt) for req, _ in reqs]
            for req, row in reqs:
                t0 = time.perf_counter()
                got.append(engine._prefill(req.prompt, bucket, row, req))
                times[name][bucket].append(time.perf_counter() - t0)
                if turn == 0:
                    logits.append(engine._pf_logits[0].float().clone())
            outs.setdefault(name, got)
            assert all(all(np.array_equal(a, b) for a, b in zip(g, w))
                       for g, w in zip(got, outs[name])), (tag, bucket, name)
            if turn in (1, 3):
                for (req, _), g, e in zip(reqs, outs["graph"],
                                          outs["eager"]):
                    assert all(np.array_equal(a, b) for a, b in zip(g, e)), \
                        (tag, bucket, req.rid, g, e)
                for a, b in zip(*(_cache_tensors(engines[x])
                                  for x in ("graph", "eager"))):
                    assert torch.equal(_bits(a[:, 1:]), _bits(b[:, 1:])), \
                        (tag, bucket, "pools differ")
        assert len(recorded.rows) == n, len(recorded.rows)
        for g_row, e_row in zip(logits, recorded.rows):
            err = max(err, (g_row - e_row).abs().max().item())
        del recorded.rows[:]
    assert engines["graph"].stats()["prefill_compiles"] \
        == len(PREFILL_BUCKETS) and eager.stats()["prefill_compiles"] == 0
    p50 = {name: {b: float(np.median(ts)) * 1e3 for b, ts in by.items()}
           for name, by in times.items()}
    print(f"{tag}: prefill graphs vs the eager prefill, {n} prompts a "
          f"bucket a turn in turns {'/'.join(PREFILL_TURNS)}: sampled tokens "
          f"and logprobs equal, pools equal on blocks 1.. after each turn "
          f"pair; last-row logits max_abs_err {err:.3e} ("
          f"{'bit-identical' if err == 0 else 'not bit-identical'}; "
          f"reported, not held); prefill p50 ms by bucket, graph "
          + json.dumps({str(b): round(v, 4) for b, v in p50["graph"].items()})
          + ", eager "
          + json.dumps({str(b): round(v, 4) for b, v in p50["eager"].items()})
          + "; eager / graph "
          + json.dumps({str(b): round(p50["eager"][b] / p50["graph"][b], 2)
                        for b in PREFILL_BUCKETS}))
    for bucket in (16, 1024):
        req, row = Request("q", rng.integers(0, 50257, bucket).tolist(),
                           1), np.arange(1, m + 1, dtype=np.int32)
        req.slot = 0
        for name, engine in engines.items():
            _breakdown(f"{tag} prefill bucket {bucket}, {name}",
                       lambda: [engine._prefill(req.prompt, bucket, row, req)
                                for _ in range(4)], per=4)


def _cache_tensors(engine):
    cache = engine.cache
    return [t for t in (cache.k_pools, cache.v_pools, cache.k_scales,
                        cache.v_scales) if t is not None]


# pipelined against unpipelined, in turns: steps of 8 slots of 200-token
# prompts (6 greedy, 2 sampled)
PIPELINE_TURNS = ("plain", "piped", "piped", "plain", "plain", "piped")
PIPELINE_TURN_TOKENS = 33


def serve_pipelined(model, kv_dtype=None):
    """`LLMEngine(pipeline_decode=True)` on the serve mix of `serve`
    against an unpipelined engine on the same model and requests: every
    greedy and sampled token bitwise equal, one decode build each (in the
    warm-up, none in the window), no rollback on a clean drain, the paged
    kernel 12 x and the keyed draw once a replay (and once a prefill).
    Then a cancel between launch and commit rolls back (one rollback, no
    token leaked, the other streams equal the unpipelined engine's), and
    the two engines in turns (`_pipelined_vs_plain`). Returns the
    pipelined run's launch counts."""
    tag = "serve_pipelined_int8" if kv_dtype else "serve_pipelined"
    paged = "paged_decode_append_int8" if kv_dtype else "paged_decode_append"
    layers = model.config.num_hidden_layers
    engines = {name: LLMEngine(model, max_batch_size=8, block_size=16,
                               max_context=1024, kv_dtype=kv_dtype,
                               pipeline_decode=name == "piped")
               for name in ("plain", "piped")}
    rng = np.random.default_rng(3)
    warm = rng.integers(0, 50257, 20).tolist()
    for engine in engines.values():
        engine.generate([warm], max_new_tokens=3)
        assert engine.stats()["decode_compiles"] == 1, engine.stats()
        engine.reset_stats()
    mix = _serve_mix(rng)
    streams, counts = {}, {}
    for name, engine in engines.items():
        heads, prefills = _watch_heads(engine)
        reset_launch_counts()
        t0 = time.perf_counter()
        reqs = [engine.add_request(p, max_new_tokens=24, **kw)
                for p, kw in mix]
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = launch_counts()
        del engine._samples, engine._prefill
        st = engine.stats()
        assert counts[name]["sampler_filter"] == sum(heads) + sum(prefills) \
            > 0, (counts, sum(heads), sum(prefills))
        assert all(r.state == "FINISHED" and len(r.generated) == 24
                   for r in reqs), [(r.rid, r.state) for r in reqs]
        assert st["decode_compiles"] == 0 and st["commit_rollbacks"] == 0, st
        assert counts[name][paged] == layers * st["steps"], (counts, st)
        assert counts[name]["keyed_draw"] == st["steps"] + st["prefills"], \
            (counts, st)
        streams[name] = [list(r.generated) for r in reqs]
        print(f"{tag}: {name} engine, {len(reqs)} requests, "
              f"{st['tokens_generated']} tokens in {wall:.3f} s = "
              f"{st['tokens_generated'] / wall:.1f} tok/s; {st['steps']} "
              f"decode steps, p50 {st['p50_step_ms']:.3f} ms, p99 "
              f"{st['p99_step_ms']:.3f} ms; keyed_draw launches "
              f"{counts[name]['keyed_draw']} = steps + prefills, "
              f"sampler_filter {counts[name]['sampler_filter']} = full-head "
              f"launches + sampled prefills; "
              f"{st['commit_rollbacks']} rollbacks")
    assert streams["piped"] == streams["plain"], tag
    n_sampled = sum(1 for _, kw in mix if kw)
    print(f"{tag}: greedy ({len(mix) - n_sampled} streams) and sampled "
          f"({n_sampled}) tokens of the pipelined engine bitwise equal to "
          f"the unpipelined engine's; 1 decode build each (warm-up), 0 in "
          f"the window")
    # a cancel between launch and commit
    prompts = [rng.integers(0, 50257, n).tolist() for n in (100, 80, 90)]
    cfgs = [dict(temperature=0.9, top_k=40, seed=500 + i) for i in range(3)]
    runs = {}
    for name, engine in engines.items():
        engine.reset_stats()
        runs[name] = [engine.add_request(p, max_new_tokens=16, **c)
                      for p, c in zip(prompts, cfgs)]
    engines["plain"].run()
    piped = engines["piped"]
    for _ in range(4):
        piped.step()
    assert piped._inflight is not None
    victim = runs["piped"][1]
    n_before = len(victim.generated)
    piped.cancel(victim.rid)
    piped.run()
    st = piped.stats()
    assert victim.state == "CANCELLED" and len(victim.generated) == n_before
    assert st["commit_rollbacks"] == 1 and st["decode_compiles"] == 0, st
    for i in (0, 2):
        assert runs["piped"][i].generated == runs["plain"][i].generated, i
    print(f"{tag}: a cancel between launch and commit rolled back 1 token "
          f"(none leaked: {n_before} tokens before and after); the other "
          f"streams equal the unpipelined engine's")
    _pipelined_vs_plain(tag, engines, rng)
    return counts["piped"]


def _pipelined_vs_plain(tag, engines, rng):
    """The pipelined and the unpipelined engine in turns (PIPELINE_TURNS),
    each turn 8 requests of 200-token prompts (6 greedy, 2 sampled) admitted
    in one step, then PIPELINE_TURN_TOKENS - 1 decode steps timed: step
    p50 / p99 (host clock, `stats()`) and decode tok/s (tokens over the
    wall time of the steps, to the last token); every turn's streams must
    equal. Then the sampler's share of a replayed step: `sample_tokens`
    alone at the decode shape (CUDA events, queue filled ahead) against
    the replay's device time (CUDA events around it)."""
    prompts = [rng.integers(0, 50257, 200).tolist() for _ in range(8)]
    cfgs = [{}] * 6 + [dict(temperature=0.8, top_k=40, top_p=0.95,
                            seed=900 + i) for i in range(2)]
    results = {"plain": [], "piped": []}
    streams = []
    replay_ms = []
    piped = engines["piped"]
    program = piped._decode_program

    def timed_replay(sampled):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = program(sampled)
        end.record()
        replay_ms.append((start, end))
        return out

    piped._decode_program = timed_replay
    for name in PIPELINE_TURNS:
        engine = engines[name]
        reqs = [engine.add_request(p, max_new_tokens=PIPELINE_TURN_TOKENS,
                                   **c) for p, c in zip(prompts, cfgs)]
        engine.step()                       # admission, prefill, 1st launch
        engine.reset_stats()
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = engine.stats()
        assert st["decode_compiles"] == 0 and st["commit_rollbacks"] == 0, st
        results[name].append((st["p50_step_ms"], st["p99_step_ms"],
                              st["tokens_generated"] / wall))
        streams.append([list(r.generated) for r in reqs])
    piped._decode_program = program
    assert all(s == streams[0] for s in streams), tag
    torch.cuda.synchronize()
    replay = float(np.median([a.elapsed_time(b) for a, b in replay_ms]))

    def fmt(i):
        return {n: [round(r[i], 4 if i < 2 else 1) for r in rs]
                for n, rs in results.items()}

    print(f"{tag}: in turns {'/'.join(PIPELINE_TURNS)}, 8 slots of 200-token "
          f"prompts (6 greedy, 2 sampled), {PIPELINE_TURN_TOKENS - 1} decode "
          f"steps a turn, streams equal in every turn: step p50 ms "
          f"{json.dumps(fmt(0))}, p99 ms {json.dumps(fmt(1))}, decode tok/s "
          f"{json.dumps(fmt(2))}")
    # the sampler alone at the decode shape, on the engine's own buffers
    s, v = 8, piped._model.config.vocab_size
    slots = _slot_views(piped._slots_dev, s, piped.max_blocks_per_seq)
    logits = torch.randn(s, v, device="cuda").to(torch.bfloat16)
    lens = torch.full((s,), 230, dtype=torch.int32, device="cuda")
    valid = piped._positions[None, :] <= lens[:, None]
    temps = torch.tensor([0.0] * 6 + [0.8] * 2, device="cuda")
    top_k = torch.full((s,), 40, dtype=torch.int32, device="cuda")
    top_p = torch.full((s,), 0.95, device="cuda")
    penalty = torch.ones(s, device="cuda")
    seeds = slots[8]
    out = [t.clone() for t in piped._out_views]
    feedback = piped._feedback.clone()

    def sampler(greedy_only=False):
        return sample_tokens(logits, temps, top_k, top_p, penalty, seeds,
                             lens + 1, piped._history, valid,
                             piped._logprobs_topk, out=out, feedback=feedback,
                             greedy_only=greedy_only,
                             filtered=piped._filtered)

    one_cta = _one_cta_draw()

    def first_sampler():
        """The first full head (commit e4c03f5): the sort-based filter
        (the twin) and the one-CTA draw, around the same shared ops."""
        kernels = tsamp.sampler_filter, tsamp.keyed_draw
        tsamp.sampler_filter = lambda *a, out=None: \
            sf.sampler_filter_reference(*a)
        tsamp.keyed_draw = one_cta
        try:
            return sampler()
        finally:
            tsamp.sampler_filter, tsamp.keyed_draw = kernels

    full = [_timed(first_sampler if first else sampler)[0]
            for first in TURNS]
    sampler_ms = float(np.mean([t for t, first in zip(full, TURNS)
                                if not first]))
    greedy_ms, _ = _timed(lambda: sampler(True))
    groups = _breakdown(f"{tag} sampler alone",
                        lambda: [sampler() for _ in range(4)], per=4)
    assert groups is not None, "the profiler saw no device time"
    # the full head sorts and scans nothing since the filter kernel
    assert "radix sort" not in groups and "scan" not in groups, groups
    assert "sampler_filter" in groups and "keyed_draw" in groups, groups
    _breakdown(f"{tag} the first full head alone",
               lambda: [first_sampler() for _ in range(4)], per=4)
    _breakdown(f"{tag} greedy head alone",
               lambda: [sampler(True) for _ in range(4)], per=4)
    print(f"{tag}: sampler alone {sampler_ms:.4f} ms a step at S=8 V={v} "
          f"(2 rows sampled: the filter kernel and the keyed draw; CUDA "
          f"events, launch queue filled ahead) = "
          f"{sampler_ms / replay:.3f} of the pipelined replay's device time "
          f"p50 {replay:.4f} ms (CUDA events around the replay, 2 slots "
          f"sampled: the full head); the greedy head alone (no slot "
          f"sampled) {greedy_ms:.4f} ms")
    print(f"{tag}: FULL_HEAD_TURNS_MS (the first head, commit e4c03f5: "
          f"sort-based filter and one-CTA draw; this head; this; the first) "
          + json.dumps([round(t, 5) for t in full]))


def _admitted(model, kv_dtype, num_blocks, n=64, prompt=512):
    """Streams a pool of `num_blocks` admits at once: requests of a
    `prompt`-token context, admitted until the scheduler refuses (host-side
    block accounting)."""
    engine = LLMEngine(model, max_batch_size=n, block_size=16,
                       max_context=1024, num_blocks=num_blocks,
                       kv_dtype=kv_dtype)
    rng = np.random.default_rng(5)
    for _ in range(n):
        engine.add_request(rng.integers(0, 50257, prompt).tolist(),
                           max_new_tokens=24)
    admitted = 0
    while engine.scheduler.try_admit() is not None:
        admitted += 1
    assert admitted < n, "the pool never ran dry"
    return admitted


def serve_int8(bf16_greedy):
    counts, greedy, model = serve(kv_dtype="int8")
    same = sum(a == b for ga, gb in zip(greedy, bf16_greedy)
               for a, b in zip(ga, gb))
    total = sum(len(g) for g in greedy)
    whole = sum(ga == gb for ga, gb in zip(greedy, bf16_greedy))
    print(f"serve_int8: greedy tokens equal to the bf16 run's at "
          f"{same}/{total} positions ({same / total:.4f}); {whole}/"
          f"{len(greedy)} streams identical throughout (reported, not held)")
    cfg = model.config
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    geom = (cfg.num_hidden_layers, cfg.num_attention_heads, head_dim, 16)
    # the bf16 engine's pool: its default 1 + 8 slots x 64 blocks
    nb_bf16 = 1 + 8 * 64
    pool_bytes = nb_bf16 * pool_bytes_per_block(*geom, torch.bfloat16)
    nb_int8 = num_blocks_for_bytes(pool_bytes, *geom, torch.int8)
    n_bf16 = _admitted(model, None, nb_bf16)
    n_int8 = _admitted(model, "int8", nb_int8)
    print(f"serve_int8: at {pool_bytes} pool bytes the bf16 pool holds "
          f"{nb_bf16} blocks and admits {n_bf16} streams of 512 tokens, the "
          f"int8 pool {nb_int8} blocks and {n_int8} streams "
          f"({n_int8 / n_bf16:.3f}x; at least {INT8_CAPACITY_MIN}x)")
    assert n_int8 >= INT8_CAPACITY_MIN * n_bf16, (n_int8, n_bf16)
    return counts


# ---------------------------------------------------------------------------
# phase 5: card vs CPU parity (fp32)
# ---------------------------------------------------------------------------

def _greedy(model, device, prompts, new, kv_dtype=None):
    engine = LLMEngine(model, max_batch_size=2, block_size=16,
                       max_context=64, logprobs_topk=2, device=device,
                       kv_dtype=kv_dtype)
    reqs = [engine.add_request(p, max_new_tokens=new) for p in prompts]
    engine.run()
    return reqs


def parity(kv_dtype=None):
    """fp32 GPT-2 124M on the card and on the CPU: identical greedy tokens
    for two prompts whose top-2 margins clear MARGIN_FACTOR x LOGITS_ATOL
    on the CPU, then (fp pools) the prompts' logits within LOGITS_ATOL.
    With ``kv_dtype="int8"`` both engines keep int8 pools."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cpu_model = GPTForCausalLM(cfg, device="cpu", seed=1)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(1)
    prompts, tried = [], 0
    while len(prompts) < 2:
        tried += 1
        assert tried <= 12, "no prompt with clear greedy margins"
        p = rng.integers(0, 50257, 24).tolist()
        (req,) = _greedy(cpu_model, "cpu", [p], 16, kv_dtype)
        margins = [a[0] - a[1] for a in req.alt_logprobs]
        if min(margins) > MARGIN_FACTOR * LOGITS_ATOL:
            prompts.append((p, req.generated))
    reset_launch_counts()
    gpu = _greedy(gpu_model, "cuda", [p for p, _ in prompts], 16, kv_dtype)
    for (p, cpu_tokens), r in zip(prompts, gpu):
        assert r.generated == cpu_tokens, (r.generated, cpu_tokens)
    fused = "paged_decode_append_int8" if kv_dtype else "paged_decode_append"
    assert launch_counts()[fused] > 0, launch_counts()
    if kv_dtype:
        print(f"parity int8: 2 prompts x 16 greedy tokens identical on card "
              f"and CPU with int8 KV pools ({tried} prompts tried)")
        return
    ids = torch.tensor([p for p, _ in prompts])
    with torch.no_grad():
        lc = cpu_model(ids)
        lg = gpu_model(ids.cuda()).cpu()
    assert torch.isfinite(lg).all()
    err = (lg - lc).abs().max().item()
    assert err <= LOGITS_ATOL, f"logits differ by {err} > {LOGITS_ATOL}"
    print(f"parity: 2 prompts x 16 greedy tokens identical on card and CPU "
          f"({tried} prompts tried); prompt logits max_abs_err {err:.3e} "
          f"(atol {LOGITS_ATOL})")


# ---------------------------------------------------------------------------
# phase 6: the training path at full width
# ---------------------------------------------------------------------------

TRAIN_KERNELS = {"flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
                 "flash_attention_bwd_dkv": 12, "cross_entropy_fwd": 1,
                 "cross_entropy_bwd": 1, "adam_update": 1, "paged_decode": 0,
                 "paged_decode_int8": 0, "paged_decode_append": 0,
                 "paged_decode_append_int8": 0, "fused_ln": 0}
# steps of the graph and of the eager step compared bit for bit, steps
# under the schedule, and the order of the timed turns
TRAIN_BITWISE_STEPS = 3
TRAIN_SCHED_STEPS = 4
TRAIN_TURNS = ("graph", "eager", "eager", "graph", "graph", "eager", "eager",
               "graph")


# kernel-name substrings of each group in a profiled window's breakdown
STEP_GROUPS = (("flash_attention_fwd", ("flash_fwd_kernel",)),
               ("flash_attention_bwd_dq", ("flash_bwd_dq_kernel",)),
               ("flash_attention_bwd_dkv", ("flash_bwd_dkv_kernel",)),
               ("cross_entropy", ("ce_fwd_kernel", "ce_bwd_kernel")),
               ("adam_update", ("adam_update_kernel",)),
               ("prefill_scatter", ("prefill_scatter_kernel",)),
               # the serving path's paged kernel writes this step's K and
               # V rows and attends in one launch (paged_decode_append)
               ("paged_decode_append", ("paged_decode_split_kernel",)),
               ("cuBLAS matmul", ("gemm", "Gemm", "nvjet", "cutlass",
                                  "xmma")),
               # the sampler's filter and draw; cub's radix sort (the first
               # sampler's one sort, the embedding backward's index sort)
               # and scans (the first sampler's top-p cumulative sum)
               ("sampler_filter", ("sampler_filter_kernel",)),
               ("keyed_draw", ("keyed_draw_kernel",)),
               ("radix sort", ("RadixSort",)),
               ("scan", ("scan",)))


def _breakdown(tag, fn, per=1, top=8):
    """fn() under torch.profiler: device time by kernel group and the
    device's busy share of the wall time, per one of the `per` steps fn
    runs, and the kernels (and copies) it launched per step. Returns the
    groups' ms per step (None where the profiler saw no device time)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / per
    groups, kernels = {}, []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3 / per
        kernels.append((ms, evt.count / per, evt.key))
        group = next((g for g, pats in STEP_GROUPS
                      if any(pat in evt.key for pat in pats)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    device_ms = sum(groups.values())
    n_copies = sum(count for _, count, name in kernels
                   if name.startswith(("Memcpy", "Memset")))
    n_kernels = sum(count for _, count, _ in kernels) - n_copies
    if device_ms == 0:
        print(f"{tag}: the profiler saw no device time; breakdown not "
              "measured")
        return None
    print(f"{tag}: profiled step {wall_ms:.3f} ms wall, {device_ms:.3f} ms "
          f"device time (busy {device_ms / wall_ms:.3f}); {n_kernels:.1f} "
          f"kernels and {n_copies:.1f} copies a step; by group "
          + json.dumps({g: round(ms, 3) for g, ms in
                        sorted(groups.items(), key=lambda kv: -kv[1])}))
    for ms, count, name in sorted(kernels, reverse=True)[:top]:
        print(f"  {ms:9.3f} ms  {count:7.1f} x  {name[:100]}")
    return groups


def _loss_and_wte_grad(model, crit, ids, labels, fused):
    set_flags({"FLAGS_use_fused_cross_entropy": fused})
    model.zero_grad(set_to_none=True)
    loss = crit(model(ids), labels)
    loss.backward()
    grad = model.gpt.wte.weight.grad.float()
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grad


def _train_pair(cfg):
    """Two GPT-2 124M models from seed 0 (bf16, dropout 0), each with its
    AdamW(multi_precision) and TrainStep: the first replays its graph, the
    second runs `_step_eager`."""
    out = []
    for _ in range(2):
        model = GPTForCausalLM(cfg, device="cuda", seed=0).to(torch.bfloat16)
        model.train()
        opt = AdamW(learning_rate=TRAIN_LR, weight_decay=0.01,
                    parameters=model.parameters(), multi_precision=True)
        out.append((model, opt, TrainStep(model, GPTPretrainingCriterion(),
                                          opt)))
    return out


def _differing(a, b):
    """Elements that differ between the two models' parameters, masters and
    moments, and their count."""
    (ma, oa, _), (mb, ob, _) = a, b
    n, total = 0, 0
    for pa, pb in zip(ma.parameters(), mb.parameters()):
        pairs = [(pa.detach(), pb.detach())] + [
            (oa._accumulators[k][pa], ob._accumulators[k][pb])
            for k in oa._accumulators if pa in oa._accumulators[k]]
        for x, y in pairs:
            n += int((x != y).sum())
            total += x.numel()
    return n, total


def _turn(tag, fn, steps, tokens, flops_per_token):
    """One turn of `steps` training steps: step ms p50 (host clock, each
    step ending in float(loss)), then device ms a step over as many steps
    enqueued behind a sleep (`_timed`), tokens/s and MFU from the p50."""
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    device_ms, host_ms = _timed(fn, iters=steps, warmup=0)
    p50 = float(np.median(times))
    return {"turn": tag, "p50_ms": p50, "device_ms": device_ms,
            "host_ms": host_ms, "tokens_per_s": tokens / (p50 / 1e3),
            "mfu": tokens / (p50 / 1e3) * flops_per_token
            / PEAK_FLOPS[torch.bfloat16]}


def train(batch=8, seq=1024, steps=5):
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    crit = GPTPretrainingCriterion()
    rng = np.random.default_rng(0)
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                       device="cuda")
    labels = torch.tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                          device="cuda")
    # the same weights through the unfused and the fused cross-entropy
    model = GPTForCausalLM(cfg, device="cuda", seed=0).to(torch.bfloat16)
    loss_off, grad_off = _loss_and_wte_grad(model, crit, ids, labels, False)
    loss_on, grad_on = _loss_and_wte_grad(model, crit, ids, labels, True)
    grad_rel = float((grad_on - grad_off).norm() / grad_off.norm())
    print(f"train: flag off vs on, loss {loss_off:.5f} vs {loss_on:.5f} "
          f"(atol {TRAIN_FLAG_LOSS_ATOL}); wte grad relative error "
          f"{grad_rel:.3e} (rtol {TRAIN_FLAG_GRAD_RTOL})")
    assert abs(loss_off - loss_on) <= TRAIN_FLAG_LOSS_ATOL
    assert grad_rel <= TRAIN_FLAG_GRAD_RTOL
    del model, grad_off, grad_on

    graph, eager = _train_pair(cfg)
    g_model, g_opt, g_step = graph
    e_model, e_opt, e_step = eager
    run_graph = lambda: g_step(ids, labels)            # noqa: E731
    run_eager = lambda: e_step._step_eager(ids, labels)  # noqa: E731
    # the first call builds the graph (one eager warm-up, one capture)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    first = float(run_graph())
    build_s = time.perf_counter() - t0
    build_gib = (torch.cuda.memory_reserved() - reserved) / 2**30
    first_eager = float(run_eager())
    ln_v = float(np.log(cfg.vocab_size))
    assert np.isfinite(first) and abs(first - ln_v) <= 0.5, (first, ln_v)
    losses = [(first, first_eager)] + [
        (float(run_graph()), float(run_eager()))
        for _ in range(TRAIN_BITWISE_STEPS - 1)]
    differ, total = _differing(graph, eager)
    print(f"train: graph build {build_s:.2f} s (warm-up + capture), "
          f"{build_gib:.3f} GiB more reserved (the graph's pool and the "
          f"warm-up's cached blocks); "
          f"{TRAIN_BITWISE_STEPS} steps of the graph and of the eager step "
          f"from one seed: losses " + ", ".join(
              f"{a:.6f}/{b:.6f}" for a, b in losses)
          + f"; {differ} of {total} elements of parameters, masters and "
          f"moments differ")
    assert all(a == b for a, b in losses), losses
    assert differ == 0, (differ, total)

    # the schedule through the graph: lr changes on every replay, the graph
    # is not rebuilt, and the losses stay the eager step's
    sched_losses, lrs = [], []
    for opt in (g_opt, e_opt):
        opt.set_lr_scheduler(LinearWarmup(
            CosineAnnealingDecay(TRAIN_LR, T_max=TRAIN_SCHED_STEPS),
            warmup_steps=2, start_lr=TRAIN_LR / 10, end_lr=TRAIN_LR))
    for _ in range(TRAIN_SCHED_STEPS):
        lrs.append(g_opt.get_lr())
        sched_losses.append((float(run_graph()), float(run_eager())))
        for opt in (g_opt, e_opt):
            opt._learning_rate.step()
    print(f"train: LinearWarmup(CosineAnnealingDecay) through the graph, "
          f"lr " + ", ".join(f"{x:.4e}" for x in lrs) + "; losses "
          + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in sched_losses)
          + f"; graph builds {g_step._builds}")
    assert len(set(lrs)) == len(lrs), lrs
    assert all(a == b for a, b in sched_losses), sched_losses
    assert g_step._builds == 1, g_step._builds
    for opt in (g_opt, e_opt):     # back to the constant lr
        opt._learning_rate = TRAIN_LR

    reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(run_graph()))   # float() waits for it
        times.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    for name, per_step in TRAIN_KERNELS.items():
        assert counts[name] == per_step * steps, (name, counts)
    assert g_step._builds == 1, g_step._builds
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < first, (first, losses)
    tokens = batch * seq
    flops = g_model.flops_per_token(seq)
    p50 = float(np.median(times))
    print(f"train: GPT-2 124M bf16 AdamW(multi_precision), batch {batch} x "
          f"{seq}, one graph replay a step; losses {first:.4f} (first) -> "
          + ", ".join(f"{x:.4f}" for x in losses))
    print(f"train: step ms p50 {p50:.3f} (min {min(times):.3f}, max "
          f"{max(times):.3f}); {tokens / (p50 / 1e3):.1f} tokens/s; MFU "
          f"{tokens / (p50 / 1e3) * flops / PEAK_FLOPS[torch.bfloat16]:.4f} "
          f"({flops} FLOPs/token vs 989e12 FLOP/s)")
    print(f"train: launches over {steps} steps {json.dumps(counts)}")

    # graph against eager in turns, in this process
    turns = []
    for kind in TRAIN_TURNS:
        fn = run_graph if kind == "graph" else run_eager
        turns.append(_turn(kind, fn, steps, tokens, flops))
    for kind in ("graph", "eager"):
        mine = [t for t in turns if t["turn"] == kind]
        print(f"train turns, {kind}: step p50 " + " / ".join(
            f"{t['p50_ms']:.3f}" for t in mine) + " ms; device " + " / ".join(
            f"{t['device_ms']:.3f}" for t in mine) + " ms a step; host "
            + " / ".join(f"{t['host_ms']:.3f}" for t in mine)
            + " ms to enqueue one (behind a sleep; the eager step's ~600 "
            "launches fill the launch queue, so its figure includes "
            "waits); tokens/s " + " / ".join(
                f"{t['tokens_per_s']:.1f}" for t in mine) + "; MFU "
            + " / ".join(f"{t['mfu']:.4f}" for t in mine))
    print("train turns: " + json.dumps(turns))
    for kind, fn in (("graph", run_graph), ("eager", run_eager)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        float(fn())
        peak = torch.cuda.max_memory_allocated()
        print(f"train {kind}: max_memory_allocated {peak / 2**30:.3f} GiB "
              f"over a step, {(peak - before) / 2**30:.3f} GiB above the "
              f"{before / 2**30:.3f} allocated before it; reserved "
              f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB (both models "
              f"and the graph's pool live; the graph's activations sit in "
              f"its pool, reserved at the build, not allocated a step)")
    groups = _breakdown("train graph", run_graph)
    _breakdown("train eager", run_eager)
    if groups:
        print(f"train: flash_attention_fwd group "
              f"{groups.get('flash_attention_fwd', 0.0):.3f} ms device time "
              f"per step (the fp32-FMA forward of commit b9d5dfc: "
              f"{TRAIN_FWD_GROUP_PREV_MS} ms)")
        print("train: flash backward groups " + ", ".join(
            f"{g} {groups.get(g, 0.0):.3f}" for g in TRAIN_BWD_GROUPS_PREV_MS)
            + " ms device time per step (the fp32-FMA backward of commit "
            f"6391f68, written in: {json.dumps(TRAIN_BWD_GROUPS_PREV_MS)})")
    # the loss a call returns is its own: the next replay leaves it alone
    kept = run_graph()
    value = float(kept)
    other = run_graph()
    assert float(kept) == value != float(other), (value, float(other))
    # a parameter whose storage moved, then a new input signature, each
    # build the graph again
    wpe = g_model.gpt.wpe.weight
    wpe.data = wpe.data.clone()
    moved = float(run_graph())
    half = float(g_step(ids[:batch // 2], labels[:batch // 2]))
    print(f"train: a returned loss keeps its value ({value:.6f}) after the "
          f"next replay ({float(other):.6f}); graph builds 1 -> "
          f"{g_step._builds} after a moved parameter (loss {moved:.6f}) and "
          f"a batch of {batch // 2} (loss {half:.6f})")
    assert g_step._builds == 3 and np.isfinite([moved, half]).all()
    set_flags({"FLAGS_use_fused_cross_entropy": False})
    return counts


# ---------------------------------------------------------------------------
# phase 7: training, card vs CPU parity (fp32)
# ---------------------------------------------------------------------------

def _train_steps(model, ids, labels):
    """TRAIN_PARITY_STEPS TrainStep calls (one graph on the card, eager on
    the CPU); returns the losses and the graph builds."""
    opt = AdamW(learning_rate=TRAIN_LR, weight_decay=0.01,
                parameters=model.parameters())
    step = TrainStep(model, GPTPretrainingCriterion(), opt)
    losses = [float(step(ids, labels)) for _ in range(TRAIN_PARITY_STEPS)]
    return losses, step._builds


def train_parity():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2_124m(num_hidden_layers=2, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    cpu_model = GPTForCausalLM(cfg, device="cpu", seed=2)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(2)
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 128)))
    labels = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 128)))
    labels[0, :5] = -100
    set_flags({"FLAGS_use_fused_cross_entropy": True})
    reset_launch_counts()
    gpu, builds = _train_steps(gpu_model, ids.cuda(), labels.cuda())
    counts = launch_counts()
    cpu, _ = _train_steps(cpu_model, ids, labels)
    set_flags({"FLAGS_use_fused_cross_entropy": False})
    # the build's eager warm-up launches each kernel as one step does (the
    # update on a scratch element), then each replay does
    assert builds == 1, builds
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert counts[name] == 2 * (TRAIN_PARITY_STEPS + 1), counts
    for name in ("cross_entropy_fwd", "cross_entropy_bwd", "adam_update"):
        assert counts[name] == TRAIN_PARITY_STEPS + 1, counts
    loss_err = max(abs(a - b) for a, b in zip(gpu, cpu))
    assert loss_err <= TRAIN_PARITY_LOSS_ATOL, (gpu, cpu)
    param_err, beyond, flipped = 0.0, 0, 0
    for pg, pc in zip(gpu_model.parameters(), cpu_model.parameters()):
        diff = (pg.detach().cpu() - pc.detach()).abs()
        param_err = max(param_err, float(diff.max()))
        beyond += int((diff > 1e-6).sum())
        flipped += int((diff > TRAIN_PARITY_PARAM_ATOL).sum())
    total = sum(p.numel() for p in cpu_model.parameters())
    assert param_err <= TRAIN_PARITY_FLIP_ATOL, param_err
    assert flipped <= TRAIN_PARITY_FLIP_SHARE * total, (flipped, total)
    print(f"train parity: {TRAIN_PARITY_STEPS} fp32 AdamW steps (card: "
          f"one graph build, replayed), 2-layer "
          f"GPT-2 width, batch {ids.shape[0]} x {ids.shape[1]}, fused CE; "
          f"losses card "
          + ", ".join(f"{x:.6f}" for x in gpu) + " vs CPU "
          + ", ".join(f"{x:.6f}" for x in cpu)
          + f"; max loss err {loss_err:.3e} (atol {TRAIN_PARITY_LOSS_ATOL}); "
          f"max param err {param_err:.3e}; {flipped} of {total} elements "
          f"differ by more than {TRAIN_PARITY_PARAM_ATOL:g} (at most "
          f"{TRAIN_PARITY_FLIP_SHARE:g} of them, each within "
          f"{TRAIN_PARITY_FLIP_ATOL:g}), {beyond} by more than 1e-6")


# ---------------------------------------------------------------------------
# phase 8: the fused bias-residual LayerNorm layer at GPT-2 width
# ---------------------------------------------------------------------------

LN_SHAPE = (8, 1024, 768)


def _ln_layer(device, dtype, seed):
    layer = FusedBiasDropoutResidualLayerNorm(LN_SHAPE[-1], dropout_rate=0.0,
                                              device=device)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return layer.to(dtype)


def _ln_step(layer, x, res, g):
    """One forward and backward; returns the output and the gradients of
    x, residual and the layer's three parameters."""
    layer.zero_grad(set_to_none=True)
    x, res = (t.detach().requires_grad_(True) for t in (x, res))
    out = layer(x, res)
    out.backward(g)
    return out.detach(), [x.grad, res.grad] + [p.grad for p in
                                              layer.parameters()]


def fused_ln_phase(iters=10):
    gen = torch.Generator().manual_seed(7)
    x, res, g = (torch.randn(LN_SHAPE, generator=gen) for _ in range(3))
    layer = _ln_layer("cuda", torch.bfloat16, seed=8)
    args = [t.to("cuda", torch.bfloat16) for t in (x, res, g)]
    _ln_step(layer, *args)                          # warm-up
    reset_launch_counts()
    fwd, step = [], []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xx, rr = (t.detach().requires_grad_(True) for t in args[:2])
        out = layer(xx, rr)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out.backward(args[2])
        torch.cuda.synchronize()
        fwd.append((t1 - t0) * 1e3)
        step.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    assert counts["fused_ln"] == iters, counts
    assert all(n == 0 for k, n in counts.items() if k != "fused_ln"), counts
    assert torch.isfinite(out.float()).all() and out.shape == LN_SHAPE
    assert all(torch.isfinite(p.grad.float()).all()
               for p in layer.parameters())
    print(f"fused_ln: FusedBiasDropoutResidualLayerNorm(768) bf16 on "
          f"{LN_SHAPE}, {iters} iterations: forward p50 "
          f"{float(np.median(fwd)):.4f} ms, forward + backward p50 "
          f"{float(np.median(step)):.4f} ms (host clock, synchronized); "
          f"launches {json.dumps(counts)}")
    # fp32 on the card (the kernel, then the plain formula's VJP) against
    # the CPU (twin and the same VJP), from one set of weights and inputs
    cpu = _ln_layer("cpu", torch.float32, seed=9)
    gpu = copy.deepcopy(cpu).to("cuda")
    out_c, grads_c = _ln_step(cpu, x, res, g)
    out_g, grads_g = _ln_step(gpu, x.cuda(), res.cuda(), g.cuda())
    torch.cuda.synchronize()
    _close("fused_ln fp32 card vs CPU out", out_g.cpu(), out_c, LN_GRAD_TOL)
    for name, a, b in zip(("x", "residual", "linear_bias", "ln_scale",
                           "ln_bias"), grads_g, grads_c):
        tol = LN_GRAD_TOL if name in ("x", "residual") else LN_PARAM_GRAD_TOL
        _close(f"fused_ln fp32 card vs CPU d{name}", a.cpu(), b, tol)
    return counts


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is "
                         "available")
    card = _card()
    print(f"card: {card}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")
    tools = _start_tool_builds()
    secs, logs = _build.build_all(ptxas_info=True)
    _finish_tool_builds(tools)
    print(f"build: {secs:.2f} s for {', '.join(_build.SOURCES)} (and "
          f"{', '.join(TOOL_SOURCES)} from tools/ beside them)")
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            found = re.search(r"Compiling entry function '(\w+)'", line)
            if found:
                entry = found.group(1)
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.strip()}")
    _sass_counts("flash_attention_fwd", ("HGMMA", "UTMALDG"))
    _sass_counts("flash_attention_bwd", ("HGMMA", "UTMALDG"))
    _sass_counts("paged_decode", ("LDGSTS",))
    _sass_int_ops("keyed_draw", "keyed_draw_kernel")
    print("kernels vs plain twins:")
    paged, paged_int8 = check_paged(), check_paged_int8()
    _paged_prev_line(paged, paged_int8)
    fused, fused_int8 = check_paged_append()
    scatter, scatter_int8 = check_prefill_scatter()
    for row in (paged, paged_int8):
        row["note"] = ("the serving path runs this kernel with the decode "
                       "write folded in (paged_decode_append); this row "
                       "times it alone, and its launches there are 0")
    rows = {"serve": [check_flash(), paged, fused, check_keyed_draw(),
                      check_sampler_filter(), scatter],
            "serve_int8": [paged_int8, fused_int8, scatter_int8],
            "train": check_flash_bwd() + check_ce() + [check_adam_update()],
            "fused_ln": [check_fused_ln()]}
    paths = {}
    paths["serve"], bf16_greedy, model = serve()
    paths["serve_int8"] = serve_int8(bf16_greedy)
    paths["serve_pipelined"] = serve_pipelined(model)
    paths["serve_pipelined_int8"] = serve_pipelined(model, kv_dtype="int8")
    del model
    parity()
    parity(kv_dtype="int8")
    paths["train"] = train()
    train_parity()
    paths["fused_ln"] = fused_ln_phase()
    # each row's launches come from the path it belongs to (the bf16
    # serving run for flash forward and the fp paged decode, alone and
    # fused with the write, the int8 serving run for the int8 paged decode,
    # alone and fused, the measured training steps for the training
    # kernels, the fused_ln phase for fused_ln); every path's counts are
    # listed beside
    for path, path_rows in rows.items():
        for row in path_rows:
            row["launches"] = paths[path][row["name"]]
    rows = [row for path_rows in rows.values() for row in path_rows]
    for row in rows:
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in paths.items()}
    alone = ("paged_decode", "paged_decode_int8")
    assert len(rows) == 15 and all(
        (row["launches"] == 0) == (row["name"] in alone) for row in rows), rows
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_ms",
            "alone_ms", "append_ms", "turns_ms", "all_sampled_ms",
            "greedy_ms", "bytes_bound_ms", "int32_bound_ms",
            "int32_bound_all_sampled_ms", "top_p_only_ms",
            "top_p_only_all_sampled_ms", "margin_rows", "routes", "shape",
            "launches_by_path",
            "tflops", "tile", "at_train_shape", "at_ragged_lens", "note")
    print(json.dumps({"kernels": [{k: row[k] for k in keys if k in row}
                                  for row in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
