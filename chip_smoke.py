"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. probe   — a CUDA device must exist; print its name and power limit;
  2. build   — compile every kernel of the serving and training paths with
               nvcc into build/paddle_tpu_torch/ (all sources at once) and
               print the build time and ptxas' register / spill report,
               the flash forward's and backward's counts of HGMMA
               (wgmma) and UTMALDG (TMA load) instructions in their SASS
               and the paged decode kernels' count of LDGSTS (cp.async,
               the 16-byte copies its design keeps in flight) where
               cuobjdump exists;
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
               timed at the serve mix's ragged lengths;
  4. serve   — GPT-2 124M (full width, random weights from a seed, bf16)
               behind `LLMEngine`: 19 requests (16 greedy, 2 sampled, one
               990-token prompt so the 1024 bucket runs), more requests
               than slots; both kernels must have launched (prefill 12 x
               per admission, decode 12 x per step); then 4 decode steps
               of 8 full slots under torch.profiler (device time by
               kernel group, busy share);
  4b. serve_int8 — the same model and request mix through
               `LLMEngine(..., kv_dtype="int8")`: the int8 paged kernel 12 x
               per decode step and the fp one never; prints its latencies,
               its greedy-token agreement with the bf16 run (a number, not
               a gate) and the streams each pool admits at the bf16
               engine's pool bytes;
  5. parity  — the same fp32 model on the card and on the CPU (the plain
               twins) must give identical greedy tokens for two prompts
               and agree on the prompts' logits; then the same with int8
               KV on both sides (tokens only);
  6. train   — GPT-2 124M (full width, random weights from seed 0, bf16,
               dropout 0) with AdamW(multi_precision) through `TrainStep`
               on a batch of 8 x 1024 tokens, FLAGS_use_fused_cross_entropy
               on: first one forward and backward with the flag off and one
               with it on must agree (loss, wte gradient); then 1 warm-up
               and 5 measured steps, asserting the per-step launches of the
               five training kernels, a finite first loss near ln(V) and a
               falling loss; prints step ms, tokens/s and MFU, and one
               more step's device time by kernel group (torch.profiler);
  7. train parity — 3 fp32 `TrainStep`s of a 2-layer full-width GPT-2 on
               the card and on the CPU from one state dict must agree:
               losses, and parameters element by element;
  8. fused_ln — `incubate.nn.FusedBiasDropoutResidualLayerNorm(768)` in
               bf16 on [8, 1024, 768] activations, forward and backward
               for some iterations, one fused_ln launch per forward; then
               its fp32 output and five gradients on the card against the
               CPU's.

The kernels phase covers the serving kernels (flash forward, paged decode
with fp and with int8 pools), the training kernels (flash backward dQ and
dK/dV, fused cross-entropy forward and backward) and the fused
bias-residual LayerNorm within FLASH_TOL / PAGED_TOL / PAGED_INT8_TOL /
CE_LOSS_TOL / CE_GRAD_TOL / LN_TOL, and the bf16 flash forward and
backward within their own stated criteria (kept beside the kernels in
`paddle_tpu_torch/kernels/flash_attention.py`). The script then prints one
JSON line with every kernel's numbers, the card's nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import subprocess
import time

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
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import (LLMEngine, num_blocks_for_bytes,
                                      pool_bytes_per_block)

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
    # fill past n and the diagonal mask at every offset within a tile
    for n in (8, 64, 65, 1000):
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


# ---------------------------------------------------------------------------
# phase 4: the serving path at full width
# ---------------------------------------------------------------------------

def serve(kv_dtype=None):
    """The serving mix through `LLMEngine` (bf16 pools, or int8 with
    ``kv_dtype="int8"``). Returns the launch counts of the run, the greedy
    requests' tokens and the model."""
    tag = "serve_int8" if kv_dtype else "serve"
    paged, other = (("paged_decode_int8", "paged_decode") if kv_dtype
                    else ("paged_decode", "paged_decode_int8"))
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device="cuda", seed=0).to(torch.bfloat16)
    engine = LLMEngine(model, max_batch_size=8, block_size=16,
                       max_context=1024, kv_dtype=kv_dtype)
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator), outside the counted window
    engine.generate([rng.integers(0, 50257, 20).tolist()], max_new_tokens=2)
    engine.reset_stats()
    lens = list(rng.integers(16, 961, 16)) + [990]
    prompts = [rng.integers(0, 50257, int(n)).tolist() for n in lens]
    reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [engine.add_request(p, max_new_tokens=24) for p in prompts]
    for i in range(2):
        reqs.append(engine.add_request(
            rng.integers(0, 50257, 64 + 32 * i).tolist(), max_new_tokens=24,
            temperature=0.8, top_k=40, top_p=0.95, seed=i))
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = engine.stats()
    assert all(r.state == "FINISHED" and len(r.generated) == 24
               for r in reqs), [(r.rid, r.state) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated)
    layers = cfg.num_hidden_layers
    assert counts["flash_attention_fwd"] > 0 and counts[paged] > 0, counts
    assert counts[paged] == layers * st["steps"], (counts, st)
    assert counts[other] == 0, counts
    assert counts["flash_attention_fwd"] == layers * st["prefills"], \
        (counts, st)
    assert 1024 in st["prefill_p50_ms"], st["prefill_p50_ms"]
    assert st["kv_dtype"] == ("int8" if kv_dtype else "bfloat16"), st
    print(f"{tag}: {len(reqs)} requests, {st['tokens_generated']} tokens "
          f"in {wall:.3f} s = {st['tokens_generated'] / wall:.1f} tok/s; "
          f"{st['steps']} decode steps, p50 {st['p50_step_ms']:.3f} ms, "
          f"p99 {st['p99_step_ms']:.3f} ms; TTFT p50 "
          f"{st['ttft_p50_ms']:.3f} ms; {st['prefills']} prefills, "
          f"{st['evictions']} evictions; occupancy "
          f"{st['occupancy_mean']:.3f}")
    print(f"{tag}: prefill p50 ms by bucket "
          + json.dumps({str(b): round(v, 3)
                        for b, v in st["prefill_p50_ms"].items()}))
    print(f"{tag}: launches {json.dumps(counts)}")
    # after the counted window: 8 requests admitted (with the first decode
    # step), then 4 decode steps of 8 full slots under the profiler
    for _ in range(8):
        engine.add_request(rng.integers(0, 50257, 200).tolist(),
                           max_new_tokens=16)
    engine.step()
    _breakdown(f"{tag} decode", lambda: [engine.step() for _ in range(4)],
               per=4)
    engine.run()
    greedy = [list(r.generated) for r in reqs if r.temperature == 0]
    return counts, greedy, model


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
    if kv_dtype:
        assert launch_counts()["paged_decode_int8"] > 0, launch_counts()
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
                 "cross_entropy_bwd": 1, "paged_decode": 0,
                 "paged_decode_int8": 0, "fused_ln": 0}


# kernel-name substrings of each group in a profiled window's breakdown
STEP_GROUPS = (("flash_attention_fwd", ("flash_fwd_kernel",)),
               ("flash_attention_bwd_dq", ("flash_bwd_dq_kernel",)),
               ("flash_attention_bwd_dkv", ("flash_bwd_dkv_kernel",)),
               ("cross_entropy", ("ce_fwd_kernel", "ce_bwd_kernel")),
               ("paged_decode", ("paged_decode_split_kernel",
                                 "paged_decode_combine_kernel")),
               ("cuBLAS matmul", ("gemm", "Gemm", "nvjet", "cutlass",
                                  "xmma")))


def _breakdown(tag, fn, per=1, top=8):
    """fn() under torch.profiler: device time by kernel group and the
    device's busy share of the wall time, per one of the `per` steps fn
    runs. Returns the groups' ms per step (None where the profiler saw no
    device time)."""
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
    if device_ms == 0:
        print(f"{tag}: the profiler saw no device time; breakdown not "
              "measured")
        return None
    print(f"{tag}: profiled step {wall_ms:.3f} ms wall, {device_ms:.3f} ms "
          f"device time (busy {device_ms / wall_ms:.3f}); by group "
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


def train(batch=8, seq=1024, steps=5):
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device="cuda", seed=0).to(torch.bfloat16)
    model.train()
    crit = GPTPretrainingCriterion()
    rng = np.random.default_rng(0)
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                       device="cuda")
    labels = torch.tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                          device="cuda")
    # the same weights through the unfused and the fused cross-entropy
    loss_off, grad_off = _loss_and_wte_grad(model, crit, ids, labels, False)
    loss_on, grad_on = _loss_and_wte_grad(model, crit, ids, labels, True)
    grad_rel = float((grad_on - grad_off).norm() / grad_off.norm())
    print(f"train: flag off vs on, loss {loss_off:.5f} vs {loss_on:.5f} "
          f"(atol {TRAIN_FLAG_LOSS_ATOL}); wte grad relative error "
          f"{grad_rel:.3e} (rtol {TRAIN_FLAG_GRAD_RTOL})")
    assert abs(loss_off - loss_on) <= TRAIN_FLAG_LOSS_ATOL
    assert grad_rel <= TRAIN_FLAG_GRAD_RTOL
    del grad_off, grad_on

    opt = AdamW(learning_rate=TRAIN_LR, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=True)
    step = TrainStep(model, crit, opt)
    first = float(step(ids, labels))          # warm-up: allocator, cuBLAS
    ln_v = float(np.log(cfg.vocab_size))
    assert np.isfinite(first) and abs(first - ln_v) <= 0.5, (first, ln_v)
    reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(ids, labels)))   # float() waits for it
        times.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    for name, per_step in TRAIN_KERNELS.items():
        assert counts[name] == per_step * steps, (name, counts)
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < first, (first, losses)
    p50 = float(np.median(times))
    tokens_per_s = batch * seq / (p50 / 1e3)
    mfu = tokens_per_s * model.flops_per_token(seq) / PEAK_FLOPS[
        torch.bfloat16]
    print(f"train: GPT-2 124M bf16 AdamW(multi_precision), batch {batch} x "
          f"{seq}; losses {first:.4f} (warm-up) -> "
          + ", ".join(f"{x:.4f}" for x in losses))
    print(f"train: step ms p50 {p50:.3f} (min {min(times):.3f}, max "
          f"{max(times):.3f}); {tokens_per_s:.1f} tokens/s; MFU {mfu:.4f} "
          f"({model.flops_per_token(seq)} FLOPs/token vs 989e12 FLOP/s)")
    print(f"train: launches over {steps} steps {json.dumps(counts)}")
    groups = _breakdown("train", lambda: step(ids, labels))
    if groups:
        print(f"train: flash_attention_fwd group "
              f"{groups.get('flash_attention_fwd', 0.0):.3f} ms device time "
              f"per step (the fp32-FMA forward of commit b9d5dfc: "
              f"{TRAIN_FWD_GROUP_PREV_MS} ms)")
        print("train: flash backward groups " + ", ".join(
            f"{g} {groups.get(g, 0.0):.3f}" for g in TRAIN_BWD_GROUPS_PREV_MS)
            + " ms device time per step (the fp32-FMA backward of commit "
            f"6391f68, written in: {json.dumps(TRAIN_BWD_GROUPS_PREV_MS)})")
    set_flags({"FLAGS_use_fused_cross_entropy": False})
    return counts


# ---------------------------------------------------------------------------
# phase 7: training, card vs CPU parity (fp32)
# ---------------------------------------------------------------------------

def _train_steps(model, ids, labels):
    opt = AdamW(learning_rate=TRAIN_LR, weight_decay=0.01,
                parameters=model.parameters())
    step = TrainStep(model, GPTPretrainingCriterion(), opt)
    return [float(step(ids, labels)) for _ in range(TRAIN_PARITY_STEPS)]


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
    gpu = _train_steps(gpu_model, ids.cuda(), labels.cuda())
    counts = launch_counts()
    cpu = _train_steps(cpu_model, ids, labels)
    set_flags({"FLAGS_use_fused_cross_entropy": False})
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert counts[name] == 2 * TRAIN_PARITY_STEPS, counts
    for name in ("cross_entropy_fwd", "cross_entropy_bwd"):
        assert counts[name] == TRAIN_PARITY_STEPS, counts
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
    print(f"train parity: {TRAIN_PARITY_STEPS} fp32 AdamW steps, 2-layer "
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
    secs, logs = _build.build_all(ptxas_info=True)
    print(f"build: {secs:.2f} s for {', '.join(_build.SOURCES)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    _sass_counts("flash_attention_fwd", ("HGMMA", "UTMALDG"))
    _sass_counts("flash_attention_bwd", ("HGMMA", "UTMALDG"))
    _sass_counts("paged_decode", ("LDGSTS",))
    print("kernels vs plain twins:")
    paged, paged_int8 = check_paged(), check_paged_int8()
    _paged_prev_line(paged, paged_int8)
    rows = {"serve": [check_flash(), paged],
            "serve_int8": [paged_int8],
            "train": check_flash_bwd() + check_ce(),
            "fused_ln": [check_fused_ln()]}
    paths = {}
    paths["serve"], bf16_greedy, _ = serve()
    paths["serve_int8"] = serve_int8(bf16_greedy)
    parity()
    parity(kv_dtype="int8")
    paths["train"] = train()
    train_parity()
    paths["fused_ln"] = fused_ln_phase()
    # each row's launches come from the path it belongs to (the bf16
    # serving run for flash forward and fp paged decode, the int8 serving
    # run for int8 paged decode, the measured training steps for the
    # training kernels, the fused_ln phase for fused_ln); every path's
    # counts are listed beside
    for path, path_rows in rows.items():
        for row in path_rows:
            row["launches"] = paths[path][row["name"]]
    rows = [row for path_rows in rows.values() for row in path_rows]
    for row in rows:
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in paths.items()}
    assert len(rows) == 8 and all(row["launches"] > 0 for row in rows), rows
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_ms",
            "shape", "launches_by_path", "tflops", "tile", "at_train_shape",
            "at_ragged_lens")
    print(json.dumps({"kernels": [{k: row[k] for k in keys if k in row}
                                  for row in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
