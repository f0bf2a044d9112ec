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
               the training shape; it and fused LN also through their
               `torch.ops.paddle_tpu_torch` ops, which a saved program
               calls, bit for bit with the direct calls) and at ragged ones, batched and not, in
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
               beside PyTorch's fused AdamW (another formula); its guard
               forms (the probe, the update gated on the flag) bit for
               bit with the twin's on the same lists and at GPT-2 124M,
               with finite gradients, a NaN gradient and an lr of inf;
               the guard's multi-tensor finite check (with and without
               the unscale) and guarded copy on ragged, misaligned lists
               of fp32, bf16 and f16, bit for bit with their twins, timed
               at the train_guard path's GPT-2 124M shapes; the
               prompt's K/V scatter (every layer in one launch, fp and
               int8 pools) at buckets 16, 128 and 1024 with the forward's
               strided views, lengths 1, 15, 16, 17, 128, 990 and 1024, a
               block row with spare and null entries over pools that hold
               a previous tenant's bytes and scales, and int8 pools at
               head_dim 128 and 32-token blocks: pools and scales bit for
               bit on every block but 0, block 0 untouched, timed at a
               full 1024 bucket in turns with the first design (commit
               c3b6374, tools/torch_prefill_scatter_twopass.cu);
               the batched adapter delta (one launch a projection, in
               place) in its row form at the decode shape (8 slots of
               adapters 0, 1, 2) and its tile form at the prefill shape
               (1024 rows of one slot, a base bucket, a ragged prompt),
               both projections' widths, bf16 and fp32, ranks 16 and 4,
               and on the timing data, every case within
               `lora_delta_tol` of the twin (the bound derived from both
               computations' roundings), base rows bit for bit, each
               case's distance from fp64 sums printed, timed in turns
               with the first design (commit 17bc302,
               tools/torch_lora_delta_pr15.cu) and the reference's op
               sequence;
  3b. kernels of the serving remainder — the fused paged decode over
               pools of the other float type (fp32 q over bf16 pools,
               bf16 q over fp32 pools; the write's cast bit for bit with
               the twin's, 50 launches each, outputs within PAGED_TOL),
               the prompt scatter casting into such pools (bit for bit,
               buckets 128 and 1024), the keyed draw with a row stride
               (generate's draw of [8, 50304] under one key: bits, noise
               and tokens bit for bit with the twin); each timed at the
               main path's shape beside its twin, bound and library
               yardstick;
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
  4d. serve_tenancy — GPT-2 124M bf16 behind `LLMEngine(...,
               enable_prefix_cache=True, max_adapters=2, adapter_rank=16,
               hot_swap=True)` on 16 requests sharing a 512-token system
               prompt and an identical pair (tenants base / a / b, 2
               sampled): prefills equal to the prefix misses, copy-on-write
               copies, 24 `lora_delta` launches a replay and a prefill;
               base tenants bit for bit with engines without adapters
               (with and without the prefix cache), adapter streams equal
               pipelined and unpipelined and unlike their base stream, int8
               pools, fp32 greedy streams equal with the prefix cache off;
               a mid-run hot-swap exact at the cut with no rebuild; TTFT of
               hits and misses, a replayed decode step with adapters armed
               (179 kernels) against one without (155), the copy-on-write
               copy's and the swap's time;
  4e. serve_kv_mixed — the serve mix on an fp32 GPT-2 124M with bf16
               pools and on a bf16 one with fp32 pools: the cast #4+ 12 x
               a replay, the cast scatter once a prefill, step p50 beside
               an engine with the model's own pools (greedy agreement
               printed), the streams each admits at equal pool bytes;
               greedy tokens card vs CPU (fp32 model over bf16 pools
               held; bf16 over fp32 reported);
  4f. generate — `GPTForCausalLM.generate` on 8 prompts of 128 tokens,
               64 new, fp32 and bf16: one build a signature, tokens equal
               to the engine's streams (fp32 held, bf16 reported) and to
               the eager loop's, ms per generated token of the graph
               against the eager loop in turns; sampled: the keyed draw
               with a row stride once a token;
  4g. serve_resilience — fp32 GPT-2 124M, serial then pipelined, held to
               an unfaulted engine's streams: injected hangs (rung 1 no
               rebuild; 2: one rebuild, or pipelined the active requests
               fail; 3: they fail with step_hang, a new request served),
               a real device stall (a sleep kernel ahead of a replay, the
               StepHang from the event poll within the budget plus one
               poll interval), a poisoned decode finished through
               `generate` (adapter tenants too); step p50 with the
               watchdog armed against disarmed, in turns;
  4h. serve_resume — a child process serving with a ServeCheckpointer
               tick a step is killed (SIGKILL), a fresh one restores and
               finishes: streams equal to an uninterrupted run's (fp32
               held, bf16 reported); a torn_swap refusal after a swap;
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
  7b. the training remainder, GPT-2 124M at full width, batch 8 x 1024,
               fused CE: train_amp — AdamW + ClipGradByGlobalNorm(1.0)
               under auto_cast(bf16), O1 over fp32 weights and O2 over
               `decorate`d bf16 weights with AdamW(multi_precision), the
               TrainStep graph and its eager step bit for bit after 3
               steps with the clip binding (a global norm above 1.0),
               then both in turns (step p50, device ms, MFU) and
               profiled (kernels a step), and auto_cast(float16) refused
               at the flash kernel; train_optimizers — each of SGD,
               Momentum, Lamb, RMSProp, Adagrad, Adadelta, Adamax, Lars,
               Adam + L2Decay and AdamW over bf16 weights, 3 graph steps
               bit for bit with 3 eager ones, then its update alone in a
               graph (device ms a step, kernels a replay) beside AdamW's
               kernel row; train_scaler — an eager GradScaler loop under
               O1: an inf in one gradient moves no parameter or
               accumulator, the loss scale follows the reference's
               transition at every step; train_guard — the numeric
               guard (FLAGS_check_numerics): an eager AdamW
               (multi_precision) bf16 loop and the same through
               TrainStep's graph, an inf gradient (in the graph through a
               device scalar its backward reads) and an lr of inf (finite
               gradients) each a bitwise no-op on every parameter, master
               and moment, steps_skipped counting them; the O1 GradScaler
               loop (fp32 weights, Momentum: the guard's check and copy
               kernels) whose scaler.step and scaler.update raise nothing
               under set_sync_debug_mode("error"), the scale by the
               reference's rule; one FLAGS_check_nan_inf step naming the
               op its NaN came out of; the guarded graph against the
               unguarded one in turns (step p50, device ms);
               train_resume — a child process
               trains 4 steps under a StepCheckpointer and is killed
               (SIGKILL), a fresh one restores and runs steps 5-8: losses
               and parameters bit for bit with an uninterrupted run;
  7c. the deployment tier — export: bf16 GPT-2 124M saved by `jit.save`
               at [1, 1024] (a torch.export program whose attention is the
               flash op) and `jit.load`ed: logits bit for bit with the
               eager model's, 12 flash launches a call, save and load
               seconds, first and warm call ms; predictor: `GPTDecodeStep`
               saved at B = 8, a 96-token prompt, 64 new tokens (buffers of
               160 positions), the prompt prefilled eagerly, then 63 tokens
               through `create_predictor(Config(path)).run` (fp32, numpy
               in and out), the loaded layer and the eager step in turns
               token by token (ms a token each): every fp32 loop's greedy
               tokens equal `generate`'s, the bf16 loaded layer's the eager
               step's; async_save: the bf16 TrainStep with AdamW saved by
               `io.async_save` after step 2 while steps 3-5 run, the file
               bit for bit with step 2's state (blocking, wait() and a
               plain save's ms, bytes);
  8. fused_ln — `incubate.nn.FusedBiasDropoutResidualLayerNorm(768)` in
               bf16 on [8, 1024, 768] activations, forward and backward
               for some iterations, one fused_ln launch per forward; then
               its fp32 output and five gradients on the card against the
               CPU's;
  9. float16 — every kernel's float16 instantiation against its twin at
               the main paths' shapes (run with phase 3; the flash pair
               within `flash_fwd_f16_tol` / `flash_bwd_f16_tol` and their
               Frobenius limits, also where a large dO drives |dS| past
               65504 and the fp32 gradients fit: no inf or NaN; pools,
               scatters and the update bit for bit), each timed beside
               its twin and one library call (rows `<counter>:fp16`, and
               `:fp32` / `:bf16` for the casts into f16 pools);
               serve_fp16 — `serve` and `serve_int8` on an f16 GPT-2 124M
               (graph replays counted, graph = eager tokens, int8 streams
               admitted at equal pool bytes, step, TTFT and prefill p50
               beside the bf16 runs'), f16 card vs CPU parity, two
               adapters, `generate`, an fp32 or bf16 model over f16 pools
               and the f16 model over fp32 or bf16 pools; train_fp16 —
               `train_amp` and `train_scaler` under float16 (O1 and O2
               through `TrainStep`'s graph, bit for bit with the eager
               step, MFU, peak memory; the eager O1 loop under
               GradScaler, an inf at step 3, (scale, good, bad) by the
               reference's rule, the global norms), a plain f16 model
               with the fused CE; fused_ln in f16;
 10. vit     — the reference's config 5 (bench.py:444-510): ViT-L/16
               (image 224, patch 16, E 1024, depth 24, 16 heads of 64,
               MLP 4096, 1000 classes) in bf16 with AdamW(1e-4,
               multi_precision) through `TrainStep(..., donate="all")`'s
               graph on a batch of 32, the fused model
               (`FusedTransformerEncoderLayer`) from the unfused one's
               weights (`nn.TransformerEncoderLayer`) mapped: the first
               step's losses within VIT_LOSS_ULPS bf16 steps, the fused
               graph bit for bit with `_step_eager` after 3 steps, 8
               counted steps a path (72 flash launches a step, finite
               falling losses, images/s, step p50 / p99, MFU), the paths in
               turns (the fused / unfused ratio reported), a profiled step
               each (device ms, kernels), peak memory; the eval forward at
               batch 32 (24 flash launches); card against CPU in fp32 at
               depth 2, batch 2 (logits, one step's parameters); ViT-B/16
               through jit.save / jit.load at [8, 3, 224, 224], logits bit
               for bit, 12 flash launches a call. The kernels phase holds
               the flash pair at ViT-L/16's shape (32, 197, 16, 64),
               non-causal, and times it (rows ``<counter>@vit``).
 11. resnet  — the reference's config 1 (BASELINE.json: ResNet-50
               ImageNet, single-device dygraph): `resnet50(1000)` at 224 x
               224, batch 128 from a seed, fp32 parameters under amp O1 in
               bf16 (convolutions and the head in bf16, batch norms in
               fp32), Momentum(0.1, 0.9, L2Decay(1e-4)) through
               `TrainStep`'s graph, cuDNN deterministic: the build and the
               first loss (near ln 1000), the graph bit for bit with
               `_step_eager` after 3 steps over parameters, velocities and
               every batch norm's running statistics, a counted window of
               8 steps (one build, no port kernel launched, the last loss
               below the first step's, images/s, step p50 / p99, MFU from
               the convolutions' and linears' shapes), a profiled step by
               group, graph and eager in turns, peak memory; the O1 eval
               forward at batch 128; the eval ResNet-50 through jit.save /
               jit.load, logits bit for bit; ResNet-18 card against CPU in
               fp32 (logits, one step's parameters and running
               statistics, and both fp32 updates' distances from the
               same step in float64 on the CPU); every other zoo
               constructor's eval forward at batch 2, card against CPU.
               No kernel row: the reference computes convolutions, batch
               norms and pools in XLA, and the port in cuDNN and torch's
               own kernels.
 12. gpt3_dp — the reference's config 3 (BASELINE.json: GPT-3 1.3B, Fleet
               data parallel) at world size 1. First the kernels at its
               shapes: the bf16 flash forward, dQ and dK/dV at (4, 2048,
               16, 128) causal against their twins, timed beside SDPA
               (rows ``<counter>@gpt3``), and the AdamW update at
               gpt3_1p3b's 292 tensors (1,315,819,520 elements) bit for
               bit with its twin over 3 steps, timed (``adam_update@gpt3``).
               Then `init_parallel_env()` with no arguments: NCCL; every
               primitive on CUDA tensors gives the world-1 answer; one
               all_reduce captured in a CUDA graph replays right. Then
               `gpt3_1p3b()` in bf16 (random weights from a seed, dropout
               0, the fused CE) through `fleet.init(is_collective=True)`,
               `distributed_model`, `distributed_optimizer(AdamW(1e-4,
               weight_decay=0.01, multi_precision=True))` and one
               `TrainStep` graph on batches of 4 x 2048 that
               `DistributedBatchSampler` deals from a synthetic token set
               made from a seed: the graph bit for bit with the eager
               step over 2 steps at full width and depth 4; at full depth
               2 warm-up steps (the first builds) and 5 counted ones (one
               build, 24 launches of each flash kernel a step, one of
               each CE kernel and of the update; finite losses, the first
               near ln V, falling), step p50 / p99, device ms a step,
               kernels a step, tokens/s, MFU, peak memory.

The kernels phase covers the serving kernels (flash forward, paged decode
with fp and with int8 pools, alone and with the decode write, the keyed
draw, the sampler's filter, the prompt's K/V scatter, the adapter delta),
the training kernels (flash backward dQ and dK/dV, fused cross-entropy
forward and backward, the AdamW update and its guard forms, the guard's
finite check and copy) and the fused bias-residual
LayerNorm within FLASH_TOL / PAGED_TOL / PAGED_INT8_TOL / CE_LOSS_TOL /
CE_GRAD_TOL / LN_TOL / `lora_delta_tol` (the decode write, the scatter,
the update and the guard's kernels exactly), and the
bf16 flash forward and backward within their own
stated criteria (kept beside the kernels in
`paddle_tpu_torch/kernels/flash_attention.py`). The script then prints one
JSON line with every kernel's numbers, the card's nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import ctypes
import gc
import json
import math
import os
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.framework import io, set_flags
from paddle_tpu_torch.incubate.checkpoint import (ServeCheckpointer,
                                                  StepCheckpointer)
from paddle_tpu_torch.incubate.models import (GPTForCausalLM,
                                              GPTPretrainingCriterion,
                                              gpt2_124m, gpt3_1p3b)
from paddle_tpu_torch.incubate.nn import FusedBiasDropoutResidualLayerNorm
from paddle_tpu_torch.io import DistributedBatchSampler
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import (_build, add_launches, capture_graph,
                                      cross_entropy as ce,
                                      flash_attention as fa, fused_ln as fln,
                                      launch_counts, paged_attention as pa,
                                      reset_launch_counts, warm_up)
from paddle_tpu_torch.kernels import adam_update as au
from paddle_tpu_torch.kernels import finite_check as fc
from paddle_tpu_torch.kernels._dtype import SHORT_NAMES
from paddle_tpu_torch.kernels import keyed_draw as kd
from paddle_tpu_torch.kernels import kv_append as kva
from paddle_tpu_torch.kernels import lora_delta as ld
from paddle_tpu_torch.kernels import prefill_scatter as ps
from paddle_tpu_torch.kernels import sampler_filter as sf
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import guardian, numerics
from paddle_tpu_torch.optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax,
                                        AdamW, L2Decay, Lamb, Lars, Momentum,
                                        RMSProp)
from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay, LinearWarmup
from paddle_tpu_torch.serving import sampling as tsamp
from paddle_tpu_torch.serving import (LLMEngine, Request, ServeRefusal,
                                      StepHang, num_blocks_for_bytes,
                                      pool_bytes_per_block)
from paddle_tpu_torch.serving.engine import _slot_views
from paddle_tpu_torch.serving.sampling import sample_tokens

# published H100 SXM peaks (NVIDIA data sheet, dense): memory rate and the
# rate of each input type (bf16 on the tensor cores; fp32 off them, TF32
# being off)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}

# (atol, rtol) of kernel vs plain twin on the card, same inputs.
#   fp32: both sides compute in fp32 and differ only in summation order
#         (tile-wise online softmax vs one softmax and a matmul) and in
#         exp/log rounding: ~1e-6 relative, held at 1e-4.
#   bf16: both sides compute in fp32 from the same bf16 inputs and round
#         the output to bf16 once, so one rounding flip is allowed: one
#         bf16 step, at most 2^-7 of the value (rtol 8e-3); atol 1e-3 only
#         absorbs values near 0, whose step lies far below it.
#   f16:  the same with f16's step, at most 2^-10 of the value (rtol 2e-3).
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 8e-3),
             torch.float16: (1e-3, 2e-3)}
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
CE_GRAD_TOL = {torch.float32: (1e-6, 1e-5), torch.bfloat16: (1e-6, 8e-3),
               torch.float16: (1e-6, 2e-3)}
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
# each serve run's stats of its warm pass, by tag
SERVE_STATS = {}


def _row_name(counter, dtype):
    """The kernels line's name of an instantiation added by the float16
    slice: its launch counter's name and its input type."""
    return f"{counter}:{SHORT_NAMES[dtype]}"


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


def _flash_d128_info():
    """What the D = 128 flash backward kernels take on this card, by the
    source's info entry (`paddle_flash_attention_bwd_info`): CTAs an SM at
    the launch's shared memory, registers a thread at launch (before
    setmaxnreg), local (spilled) bytes a thread, shared memory and threads
    a CTA; dQ beside dK/dV, bf16 and f16, causal and not."""
    fn = _build.load("flash_attention_bwd").paddle_flash_attention_bwd_info
    for dkv, kind in ((0, "dq"), (1, "dkv")):
        for dtype, name in ((1, "bf16"), (2, "float16")):
            for causal in (1, 0):
                out = (ctypes.c_int * 5)()
                err = fn(ctypes.c_int(dkv), ctypes.c_int(128),
                         ctypes.c_int(dtype), ctypes.c_int(causal), out)
                assert err == 0, (kind, name, causal, err)
                print(f"build: flash bwd {kind} D=128 {name} causal={causal}:"
                      f" {out[0]} CTAs an SM, {out[1]} registers at launch, "
                      f"{out[2]} local bytes, {out[3]} B of shared memory, "
                      f"{out[4]} threads")


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
    """Clock cycles per second of `torch.cuda._sleep`, measured once: the
    fastest of three timings after a warm-up sleep that lifts an idle
    card's clock, so that a sleep of n cycles, meant to outlast a budget
    (serve_resilience's stall and wedge), does not come out short when
    the card's clock is higher later than it was at the timing."""
    if not _SLEEP_CYCLES_PER_S:
        torch.cuda._sleep(10 ** 8)
        rates = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda._sleep(10 ** 7)
            end.record()
            end.synchronize()
            rates.append(1e7 / (start.elapsed_time(end) / 1e3))
        _SLEEP_CYCLES_PER_S.append(max(rates))
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
    of v's type: the bf16 or f16 kernel's own criterion, else FLASH_TOL."""
    return fa.flash_fwd_tol(v) or FLASH_TOL[v.dtype]


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
    and f16 also within their relative Frobenius limit
    (`fa.flash_fro_rtol`), lse within LSE_TOL; the same for the kernel
    called as the op ``torch.ops.paddle_tpu_torch.flash_attention_fwd``
    (what a saved program calls), whose outputs must also be the direct
    call's bit for bit."""
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    op_out, op_lse = torch.ops.paddle_tpu_torch.flash_attention_fwd(
        q, k, v, causal, scale)
    torch.cuda.synchronize()
    limit = fa.flash_fro_rtol(q.dtype)
    errs = []
    for how, (o, l) in (("", (out, lse)), (" (op)", (op_out, op_lse))):
        errs.append(_close(tag + how + " out", o, ref, flash_fwd_tol(v)))
        if limit is not None:
            fro = fa.rel_fro(o, ref)
            print(f"  {tag}{how} out: relative Frobenius error {fro:.3e} "
                  f"(at most {limit})")
            assert fro <= limit, (tag, how, fro)
        _close(tag + how + " lse", l, ref_lse, LSE_TOL)
    assert torch.equal(op_out, out) and torch.equal(op_lse, lse), tag
    return errs[0]


def _offset_qkv(n, seed, heads=HEADS, head_dim=HEAD_DIM,
                dtype=torch.bfloat16):
    """q, k, v as views of one 2-byte buffer whose rows are 3 * H * D + 16
    elements: q at offset 0, k at H * D + 8 and v at 2 * H * D + 16
    elements, so k and v start 16-byte aligned but off the buffer's own
    alignment."""
    width = heads * head_dim
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn((1, n, 3 * width + 16), generator=g,
                      device="cuda").to(dtype)
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
            "shape": f"q,k,v ({b}, {n}, {HEADS}, {HEAD_DIM}) "
                     f"{str(q.dtype)[6:]} causal"}


# the D = 128 kernels' tile edges (128 q rows a CTA forward, 128 keys a CTA
# for dK/dV, 64 a consumer warpgroup): lengths that cut a 128-row tile,
# leave the second warpgroup's rows partly or wholly past the end, or end
# one short of config 3's sequence
FLASH_D128_LENGTHS = (65, 129, 200, 2047)


def _twice_equal(tag, fn):
    """Two launches of fn on the same inputs give the same bits."""
    first = [t.clone() for t in fn()]
    second = fn()
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(a), _bits(b))
               for a, b in zip(first, second)), tag
    print(f"  {tag}: two launches bit for bit equal")


def _check_flash_d128(dtype):
    """The forward at head_dim 128 (two consumer warpgroups a CTA) against
    its twin: FLASH_D128_LENGTHS causal and not, a non-causal 40 x 300, a
    batch of 3 read through the fused qkv strides, and two launches bit
    for bit equal."""
    name = str(dtype)[6:]
    for n in FLASH_D128_LENGTHS:
        for causal in (True, False):
            qkv = _fused_qkv(n, dtype, seed=400 + n, heads=4, head_dim=128)
            _check_flash_case(f"flash {name} n={n} causal={causal} D=128",
                              *qkv, causal)
    q = _fused_qkv(40, dtype, seed=41, heads=4, head_dim=128)[0]
    _, k, v = _fused_qkv(300, dtype, seed=42, heads=4, head_dim=128)
    _check_flash_case(f"flash {name} n=40 m=300 causal=False D=128", q, k, v,
                      False)
    _check_flash_case(f"flash {name} (3, 200, 4, 128) causal=True",
                      *_fused_qkv(200, dtype, seed=43, heads=4, head_dim=128,
                                  batch=3), True)
    # more 128-row tiles than the card has SMs: a CTA walks several
    for causal in (True, False):
        _check_flash_case(f"flash {name} (8, 1000, 16, 128) causal={causal}",
                          *_fused_qkv(1000, dtype, seed=45, heads=16,
                                      head_dim=128, batch=8), causal)
    q = _fused_qkv(40, dtype, seed=46, heads=32, head_dim=128, batch=8)[0]
    _, k, v = _fused_qkv(300, dtype, seed=47, heads=32, head_dim=128,
                         batch=8)
    _check_flash_case(f"flash {name} (8, 40, 32, 128) m=300 causal=False", q,
                      k, v, False)
    _twice_equal(f"flash {name} n=2047 causal=True D=128",
                 lambda: fa.flash_attention_fwd(*qkv, True))


def check_flash(dtype=torch.bfloat16):
    """The flash forward against its fp32 twin over its cases, then timed
    at the serving and training shapes beside SDPA: bf16 (``dtype``'s
    default) with the fp32 cases first, or float16 (F16: its row is
    named by `_row_name`)."""
    f16 = dtype == F16
    errs = {}
    for dt in (dtype,) if f16 else (torch.float32, dtype):
        name = str(dt)[6:]
        for n in (8, 40, 65, 1024) if f16 else (40, 1024):
            for causal in (True, False):
                errs[dt, n, causal] = _check_flash_case(
                    f"flash {name} n={n} causal={causal}",
                    *_fused_qkv(n, dt, seed=60 + n if f16 else n), causal)
        # the training path's batch 8 at its shape, and a ragged batch 3:
        # every block past the first batch reads at its batch stride
        errs[dt, "train"] = _check_flash_case(
            f"flash {name} (8, 1024, {HEADS}, {HEAD_DIM}) causal=True",
            *_fused_qkv(1024, dt, seed=11, batch=8), True)
        if not f16:
            _check_flash_case(f"flash {name} (3, 40, {HEADS}, {HEAD_DIM}) "
                              "causal=False",
                              *_fused_qkv(40, dt, seed=10, batch=3), False)
        # off the serving path but compiled in: head_dim 128, and
        # non-causal attention over more keys than queries
        _check_flash_case(f"flash {name} n=40 causal=True D=128",
                          *_fused_qkv(40, dt, seed=7, heads=4,
                                      head_dim=128), True)
        q = _fused_qkv(40, dt, seed=8)[0]
        _, k, v = _fused_qkv(100, dt, seed=9)
        _check_flash_case(f"flash {name} n=40 m=100 causal=False", q, k, v,
                          False)
    name = str(dtype)[6:]
    if not f16:
        # bf16 tile edges and a length that is no power of two: TMA's zero
        # fill past n and the diagonal mask at every offset within a tile
        # (8, 16: the smallest prefill buckets)
        for n in (8, 16, 17, 64, 65, 1000):
            for causal in (True, False):
                _check_flash_case(f"flash bfloat16 n={n} causal={causal}",
                                  *_fused_qkv(n, dtype, seed=30 + n), causal)
    # k and v at 16-byte aligned, non-zero offsets into a wider buffer
    _check_flash_case(f"flash {name} n=200 causal=True k, v offset views",
                      *_offset_qkv(200, seed=31, dtype=dtype), True)
    _check_flash_d128(dtype)
    # main-path shapes, causal: the serving path's 1024 prefill bucket
    # (the row's numbers) and the training path's batch of 8 x 1024
    # (`at_train_shape`)
    row = _time_flash(*_fused_qkv(1024, dtype, seed=1024),
                      errs[dtype, 1024, True])
    row["at_train_shape"] = _time_flash(
        *_fused_qkv(1024, dtype, seed=11, batch=8), errs[dtype, "train"])
    row.update(route="cuda",
               source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
               replaces="paddle_tpu/kernels/flash_attention.py:90 "
                        "_fwd_kernel")
    if f16:
        row.update(name=_row_name("flash_attention_fwd", F16),
                   counter="flash_attention_fwd")
        print(f"  flash float16 fwd ms: serve {row['ms']:.4f}, train "
              f"{row['at_train_shape']['ms']:.4f}")
        return row
    print(f"  flash bfloat16 fwd ms: serve {row['ms']:.4f}, train "
          f"{row['at_train_shape']['ms']:.4f}; the earlier design, written "
          f"in, not measured in this run: {json.dumps(FLASH_FWD_PREV_MS)}")
    return {"name": "flash_attention_fwd", **row}


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


def _paged_work(lens, q, tables, int8, bs=16, elem=None):
    """``(bytes, flops)`` one call needs: the K and V rows of the positions
    the lengths attend (p <= lens, one position for an empty slot; `elem`
    bytes a value, q's when None), their int8 scales, q, out, the tables
    and the lengths; 4 FLOPs per element of K (q.k and p.v)."""
    tokens = sum(l + 1 for l in lens)
    blocks = sum(-(-(l + 1) // bs) for l in lens)
    row = HEADS * HEAD_DIM * (1 if int8 else (elem or q.element_size()))
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
    name = pa.append_name(new_dtype, pool_dtype)
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


def check_paged_append(dtype=torch.bfloat16):
    """The fused decode step (`paged_decode_append`: the write, then the
    attention, one launch) against its twin composition (`_check_append_
    case`: pools bit for bit, 50 launches each). bf16: fp32 and bf16
    pools and int8 pools with bf16 and fp32 rows; returns the fp (bf16
    pools) and int8 (bf16 rows) rows, timed at the serving path's shape
    (12 layers' pools rotating) in turns with the paged kernel alone on
    the same state (fused, paged, paged, fused): their difference is what
    the write adds to the launch. float16 (F16): f16 q over f16 pools and
    over int8 pools, timed beside the twin and the library yardstick, and
    the four cast pairs by `check_append_cast`; returns {path: rows}."""
    f16 = dtype == F16
    bs = 16
    pairs = (((F16, F16), (torch.int8, F16)) if f16 else
             ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
              (torch.int8, torch.bfloat16), (torch.int8, torch.float32)))
    errs = {pair: _check_append_case(*pair) for pair in pairs}
    # main-path shape: 12 layers' pools rotate, as a decode step's 12
    # layers read and write 12 pools
    rows, out, layers = [], {}, 12
    eff_lens = [l if a else 0 for l, a in zip(KV_APPEND_LENS,
                                              KV_APPEND_ACTIVE)]
    for pool_dtype in (dtype, torch.int8):
        q, k, v, kp, vp, ks, vs, tables, lens, active = _kv_append_state(
            layers, pool_dtype, dtype, seed=6)
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

        # int8: no single PyTorch call requantizes a block
        library = None
        if not int8:
            # yardstick: the two index_put_ calls of the fp write, with the
            # write positions computed beforehand, then a gather and SDPA
            wb = torch.where(active, tables[torch.arange(8, device="cuda"),
                                            eff.long() // bs].long(), 0)
            wo = eff.long() % bs
            t_max = tables.shape[1] * bs
            mask = (torch.arange(t_max, device="cuda")[None, :]
                    <= eff[:, None])[:, None, None, :]

            def lib(kpl, vpl):
                kpl.index_put_((wb, wo), k)
                vpl.index_put_((wb, wo), v)
                kg = kpl[tables.long()].reshape(8, t_max, HEADS, HEAD_DIM) \
                    .transpose(1, 2)
                vg = vpl[tables.long()].reshape(8, t_max, HEADS, HEAD_DIM) \
                    .transpose(1, 2)
                return torch.nn.functional.scaled_dot_product_attention(
                    q[:, :, None, :], kg, vg, attn_mask=mask)

            library = rotating(lib)
        paged_b = _paged_work(eff_lens, q, tables, int8)
        append_b = _kv_append_work(int8, 2)
        err = errs[pool_dtype, dtype]
        if f16:
            counter = pa.append_name(F16, pool_dtype)
            out["serve_int8_fp16" if int8 else "serve_fp16"] = [_f16_row(
                _row_name(counter, F16), counter,
                "paddle_tpu_torch/csrc/paged_decode.cu",
                "paddle_tpu/kernels/pallas/paged_attention.py:167 "
                "_decode_kernel" + (" (quantized=True)" if int8 else "")
                + " with the decode write before it (XLA ops, no Pallas "
                "kernel)", rotating(fused), rotating(twin), library,
                paged_b[0] + append_b[0], paged_b[1] + append_b[1], err,
                f"S=8 H=12 D=64 bs=16 M=64, 513 blocks, lens "
                f"{KV_APPEND_LENS}, active {KV_APPEND_ACTIVE}, f16 q and "
                f"rows, " + ("int8 pools + fp32 scales; library_ms null: no "
                             "one PyTorch call requantizes a block" if int8
                             else "f16 pools; library_ms: two index_put_, a "
                                  "gather and SDPA"))]
            continue
        f1, host_1 = _timed(rotating(fused))
        p1, _ = _timed(rotating(alone))
        p2, _ = _timed(rotating(alone))
        f2, host_2 = _timed(rotating(fused))
        plain_ms = _cuda_ms(rotating(twin))
        library_ms = None if int8 else _cuda_ms(library)
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
            "max_abs_err": err, "ms": ms,
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
    if f16:
        for row, (pool_dtype, q_dtype) in zip(
                check_append_cast(F16_CAST_PAIRS, suffix=True),
                F16_CAST_PAIRS):
            out.setdefault(f"serve_kv_{SHORT_NAMES[q_dtype]}_"
                           f"{SHORT_NAMES[pool_dtype]}", []).append(row)
        return out
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


def _scatter_state(bucket, dtype, int8, seed, bs=16, head_dim=HEAD_DIM,
                   pool_dtype=None):
    """Per-layer K/V rows as strided views of one [bucket, 3, H, D]
    projection a layer (the forward's layout), pools of 1 + 2 M blocks
    that hold a previous tenant's bytes (int8: levels and scales), and a
    block row of M shuffled block ids: the prompt's blocks, then spare
    blocks past it, the last 4 entries null where the bucket leaves them
    free. fp pools are of `pool_dtype` (the rows' dtype when None)."""
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
        pools = [torch.randn(shape, generator=g, device="cuda")
                 .to(pool_dtype or dtype) for _ in range(2)]
        scales = [None, None]
    row = (1 + torch.randperm(nb - 1, generator=g, device="cuda")
           [:SCATTER_M]).to(torch.int32)
    if bucket <= (SCATTER_M - 4) * bs:
        row[-4:] = 0
    return [x[:, 1] for x in qkv], [x[:, 2] for x in qkv], pools, scales, row


def _bits(t):
    return t.view(torch.int16) if t.dtype in (torch.bfloat16, torch.float16) \
        else t


def _check_scatter_case(bucket, length, dtype, int8, bs=16,
                        head_dim=HEAD_DIM, pool_dtype=None):
    """One scatter against its twin on copies of one state."""
    k, v, pools, scales, row = _scatter_state(bucket, dtype, int8,
                                              seed=bucket + length, bs=bs,
                                              head_dim=head_dim,
                                              pool_dtype=pool_dtype)
    orig = [t for t in (*pools, *scales) if t is not None]
    want = [t.clone() for t in orig]
    got = [t.clone() for t in orig]
    n = torch.full((), length, dtype=torch.int32, device="cuda")
    ps.prefill_scatter_reference(want[0], want[1], k, v, row, n, bs,
                                 *want[2:])
    ps.prefill_scatter(got[0], got[1], k, v, row, n, bs, *got[2:])
    torch.cuda.synchronize()
    tag = (f"{ps.scatter_name(dtype, pools[0].dtype)} {str(dtype)[6:]} "
           f"rows, bucket {bucket}, length {length}, head_dim {head_dim}, "
           f"bs {bs}")
    for g_t, w_t, o_t in zip(got, want, orig):
        assert torch.equal(_bits(g_t[:, 1:]), _bits(w_t[:, 1:])), \
            f"{tag}: not bit-identical to the twin"
        assert torch.equal(_bits(g_t[:, 0]), _bits(o_t[:, 0])), \
            f"{tag}: block 0 written"
    return tag


def check_prefill_scatter(dtype=torch.bfloat16):
    """The prompt's K/V scatter (one launch for every layer, K and V)
    against its twin, bit for bit on every block but 0 and block 0
    untouched. bf16 (the serving path's rows): at SCATTER_CASES, at
    bucket 128 for fp32 rows, fp and int8 pools, and with int8 pools at
    SCATTER_WIDE (head_dim 128, 32-token blocks; bf16 and fp32 rows);
    returns the two rows, timed at a full 1024-token bucket, in turns with
    the first design (commit c3b6374, tools/torch_prefill_scatter_
    twopass.cu: int8 blocks read twice). float16 (F16): SCATTER_CASES into
    f16 and int8 pools, int8 pools at SCATTER_WIDE, timed at the full
    bucket beside the twin and (f16 pools) two index_put_ a layer, and the
    four cast pairs by `check_scatter_cast`; returns {path: rows}."""
    f16 = dtype == F16
    bs = 16
    tags = []
    for int8 in (False, True):
        for bucket, lengths in SCATTER_CASES:
            for length in lengths:
                tags.append(_check_scatter_case(bucket, length, dtype, int8))
        if not f16:
            for length in SCATTER_CASES[1][1]:
                tags.append(_check_scatter_case(128, length, torch.float32,
                                                int8))
    wide_bucket, wide_bs, wide_lengths = SCATTER_WIDE
    for dt in (dtype,) if f16 else (torch.bfloat16, torch.float32):
        for length in wide_lengths:
            tags.append(_check_scatter_case(wide_bucket, length, dt, True,
                                            bs=wide_bs, head_dim=128))
    if f16:
        print(f"  prefill_scatter float16 rows: {len(tags)} cases "
              f"bit-identical to the twin on blocks 1.. and block 0 "
              f"untouched")
    else:
        print(f"  prefill_scatter: {len(tags)} cases bit-identical to the "
              f"twin on blocks 1.. and block 0 untouched (buckets and "
              f"lengths {json.dumps(SCATTER_CASES)} in bf16, bucket 128 in "
              f"fp32, fp and int8 pools; int8 pools at head_dim 128, bs "
              f"{wide_bs}, bucket {wide_bucket}, lengths "
              f"{list(wide_lengths)}, bf16 and fp32 rows)")
    rows, turns, out = [], {}, {}
    bucket = length = 1024
    for int8 in (False, True):
        k, v, pools, scales, row = _scatter_state(bucket, dtype, int8, seed=7)
        n = torch.full((), length, dtype=torch.int32, device="cuda")
        args = (*pools, k, v, row, n, bs, *scales)
        library = None
        if not int8:
            # the nearest calls: two index_put_ a layer, the positions
            # computed beforehand
            pos = torch.arange(length, device="cuda")
            blocks, offs = row.long()[pos // bs], pos % bs

            def library():
                for layer in range(SCATTER_LAYERS):
                    pools[0][layer].index_put_((blocks, offs), k[layer])
                    pools[1][layer].index_put_((blocks, offs), v[layer])

        used = int((row != 0).sum())        # blocks whose scales it writes
        nbytes = ps.scatter_bytes(length, SCATTER_LAYERS, HEADS, HEAD_DIM, 2,
                                  int8, used)
        # int8: about 6 fp32 operations an element (abs, max, multiply,
        # round, two clamps)
        flops = 6 * 2 * SCATTER_LAYERS * length * HEADS * HEAD_DIM if int8 \
            else 0
        replaces = ("no Pallas counterpart: paddle_tpu/serving/cache.py:237 "
                    "scatter_prefill" + (" over paddle_tpu/quantization/"
                                         "kv_cache.py:90 quantize_scatter"
                                         if int8 else "") + " (XLA ops)")
        if f16:
            counter = ps.scatter_name(F16, torch.int8 if int8 else F16)
            out["serve_int8_fp16" if int8 else "serve_fp16"] = [_f16_row(
                _row_name(counter, F16), counter,
                "paddle_tpu_torch/csrc/prefill_scatter.cu", replaces,
                lambda: ps.prefill_scatter(*args),
                lambda: ps.prefill_scatter_reference(*args), library,
                nbytes, flops, 0.0,
                f"12 layers of f16 rows [1024, 12, 64] (strided views of "
                f"[1024, 3, 12, 64]), length 1024, bs=16, a block row of "
                f"64, " + ("int8 pools + fp32 scales; library_ms null: no "
                           "one PyTorch call quantizes a block" if int8 else
                           "f16 pools; library_ms: two index_put_ a layer"))]
            continue
        twopass = _TOOL_LIBS["torch_prefill_scatter_twopass"] \
            .paddle_prefill_scatter

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
        library_ms = None if int8 else _cuda_ms(library)
        bound, by = _bound_ms(nbytes, flops, torch.float32)
        name = "prefill_scatter_int8" if int8 else "prefill_scatter"
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/prefill_scatter.cu",
            "replaces": replaces,
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
    if f16:
        for row, (pool_dtype, row_dtype) in zip(
                check_scatter_cast(F16_CAST_PAIRS, suffix=True),
                F16_CAST_PAIRS):
            out.setdefault(f"serve_kv_{SHORT_NAMES[row_dtype]}_"
                           f"{SHORT_NAMES[pool_dtype]}", []).append(row)
        return out
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


# fused_ln's cases (R, D, activations' type, affine terms' type or None:
# the same) and the seeds of the first case and of the timed input sets,
# by the type checked. bf16: the main-path shape in both types, a ragged
# R = 777, affine terms in the other type (bf16 activations under fp32
# parameters, and the reverse), the narrowest width and one wider than
# 4096 (two groups of 4 per thread). f16: the main-path shape, R = 777,
# fp32 affine terms, the narrowest and the widest.
LN_CASES = {
    torch.bfloat16: ([(8192, 768, torch.bfloat16, None),
                      (8192, 768, torch.float32, None),
                      (777, 768, torch.bfloat16, None),
                      (777, 768, torch.float32, None),
                      (777, 768, torch.bfloat16, torch.float32),
                      (777, 768, torch.float32, torch.bfloat16),
                      (5, 128, torch.bfloat16, None),
                      (33, 4224, torch.float32, None)], 20, 40),
    torch.float16: ([(8192, 768, torch.float16, None),
                     (777, 768, torch.float16, None),
                     (777, 768, torch.float16, torch.float32),
                     (5, 128, torch.float16, None),
                     (33, 4224, torch.float16, None)], 50, 60)}


def check_fused_ln(dtype=torch.bfloat16):
    """fused_ln against its twin over LN_CASES[dtype] (in bf16 also called
    as the op a saved program calls: the same bits), then timed at the
    main-path shape [8192, 768] in `dtype` beside the twin and
    F.layer_norm(x + bias + residual); an f16 row is named by
    `_row_name`."""
    cases, seed, timed_seed = LN_CASES[dtype]
    f16 = dtype == F16
    for i, (r, d, dt, adt) in enumerate(cases):
        args = _ln_inputs(r, d, dt, seed=seed + i, affine_dtype=adt)
        out = fln.fused_ln_fwd(*args)
        ref = fln.fused_ln_reference(*args)
        if not f16:
            # the kernel as the op a saved program calls: the same bits
            op_out = torch.ops.paddle_tpu_torch.fused_ln_fwd(*args, 1e-5)
        torch.cuda.synchronize()
        assert out.dtype == dt and torch.isfinite(out.float()).all()
        tag = f"fused_ln {str(dt)[6:]} ({r}, {d}) affine " \
              f"{str(adt or dt)[6:]}"
        e = _close(tag, out, ref, LN_TOL[dt])
        if not f16:
            _close(tag + " (op)", op_out, ref, LN_TOL[dt])
            assert torch.equal(op_out, out), tag
        if i == 0:
            err = e
    # main-path shape [8192, 768]; 4 input sets (x, residual and the
    # output: 151 MB, three times the L2) rotate so each launch reads cold
    # activations, as a layer's LayerNorm does
    r, d, sets = 8192, 768, 4
    inputs = [_ln_inputs(r, d, dtype, seed=timed_seed + i)
              for i in range(sets)]
    it = iter(range(10 ** 9))

    def rotating(fn):
        return lambda: fn(*inputs[next(it) % sets])

    library = rotating(
        lambda x, res, b, sc, sh: torch.nn.functional.layer_norm(
            x + b + res, (d,), sc, sh, 1e-5))
    elem = 2
    nbytes = 3 * r * d * elem + 3 * d * elem
    # ~10 fp32 operations per element (2 adds, mean, centre, square-add,
    # scale, affine)
    flops = 10 * r * d
    if f16:
        return _f16_row(
            _row_name("fused_ln", F16), "fused_ln",
            "paddle_tpu_torch/csrc/fused_ln.cu",
            "paddle_tpu/kernels/fused_ln.py:59 _kernel",
            rotating(fln.fused_ln_fwd), rotating(fln.fused_ln_reference),
            library, nbytes, flops, err,
            f"x, residual ({r}, {d}) float16, bias/scale/shift float16; "
            f"library_ms: F.layer_norm(x + bias + residual)")
    ms, host_ms = _timed(rotating(fln.fused_ln_fwd))
    plain_ms = _cuda_ms(rotating(fln.fused_ln_reference))
    library_ms = _cuda_ms(library)
    bound, by = _bound_ms(nbytes, flops, torch.float32)
    return {"name": "fused_ln", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_ln.cu",
            "replaces": "paddle_tpu/kernels/fused_ln.py:59 _kernel",
            "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms,
            "shape": f"x, residual ({r}, {d}) bf16, bias/scale/shift bf16"}


def _strided_grad(q, seed, gain=1.0):
    """An output gradient laid out [B, H, N, D] and viewed as [B, N, H, D]:
    rows contiguous, the rest strided, as a reshaped gradient can be;
    normal values times `gain`."""
    b, n, h, d = q.shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn((b, h, n, d), generator=g, device="cuda") * gain) \
        .to(q.dtype).transpose(1, 2)


def _flash_bwd_inputs(q, k, v, causal, seed, gain=1.0):
    do = _strided_grad(q, seed, gain)
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    delta = fa.flash_attention_delta(out, do)
    return q, k, v, do, lse, delta, causal, 1.0 / (q.shape[-1] ** 0.5)


def _check_flash_bwd_case(tag, q, k, v, causal, seed=0, gain=1.0):
    """dQ, dK, dV against their twins: fp32 within FLASH_BWD_TOL, bf16
    and f16 within `fa.flash_bwd_tol` (`flash_bwd_bf16_tol`,
    `flash_bwd_f16_tol`) and, each, a relative Frobenius error of at most
    the type's limit (`fa.flash_fro_rtol`). `gain` scales dO."""
    args = _flash_bwd_inputs(q, k, v, causal, seed, gain)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    rq = fa.flash_attention_bwd_dq_reference(*args)
    rk, rv = fa.flash_attention_bwd_dkv_reference(*args)
    torch.cuda.synchronize()
    limit = fa.flash_fro_rtol(q.dtype, backward=True)
    tols = (fa.flash_bwd_tol(*args) if limit is not None else
            dict.fromkeys(("dq", "dk", "dv"), FLASH_BWD_TOL[q.dtype]))
    errs = {}
    for name, got, want in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert bool(torch.isfinite(got.float()).all()), (tag, name)
        errs[name] = _close(f"{tag} {name}", got, want, tols[name])
        if limit is not None:
            fro = fa.rel_fro(got, want)
            print(f"  {tag} {name}: relative Frobenius error {fro:.3e} (at "
                  f"most {limit})")
            assert fro <= limit, (tag, name, fro)
    return errs["dq"], max(errs["dk"], errs["dv"])


def _check_flash_bwd_refuses_misaligned_do(dtype=torch.bfloat16):
    """A bf16 (f16) dO 2 bytes off a 16-byte boundary: TMA cannot read
    it, so both backward wrappers raise, naming it, and launch nothing."""
    q, k, v = _fused_qkv(40, dtype, seed=13)
    width = HEADS * HEAD_DIM
    buf = torch.zeros((1, 40, width + 8), dtype=dtype, device="cuda")
    do = buf[..., 1:1 + width].view(1, 40, HEADS, HEAD_DIM)
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = fa.flash_attention_delta(out, do)
    before = launch_counts()
    for fn in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        try:
            fn(q, k, v, do, lse, delta, True, 0.125)
        except ValueError as exc:
            assert "cannot read do:" in str(exc), exc
            print(f"  flash bwd {str(dtype)[6:]} misaligned dO: "
                  f"{fn.__name__} raised ValueError ({exc})")
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


def _check_f16_large_do(head_dim=HEAD_DIM):
    """The f16 backward's large-dO cases (F16_LARGE_DO) at [1, 128, 12,
    head_dim]: |dP - Delta| past 10^4 and, non-causal, |dS| past 65504
    while the fp32 twin's gradients fit in f16, so the kernels' dS factor
    has to act; the outputs must be finite and within the f16 criteria."""
    dtag = "" if head_dim == HEAD_DIM else f" D={head_dim}"
    for causal, (q_gain, k_gain, gain) in F16_LARGE_DO.items():
        shape = (1, 128, HEADS, head_dim)
        q, k, v = _f16_numpy(shape, 21, 3)
        q, k = (q.float() * q_gain).to(F16), (k.float() * k_gain).to(F16)
        (do,) = _f16_numpy(shape, 22, 1, gain)
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        delta = fa.flash_attention_delta(out, do)
        args = (q, k, v, do, lse, delta, causal, head_dim ** -0.5)
        _, _, _, p_, ds = fa._bwd_probs(*args)
        dp_delta = float((ds.abs() / p_.clamp_min(1e-30))[p_ > 1e-3].max())
        ds_max = float(ds.abs().max())
        del p_, ds
        refs = [fa.flash_attention_bwd_dq_reference(*args),
                *fa.flash_attention_bwd_dkv_reference(*args)]
        fits = all(float(r.float().abs().max()) < 65504.0 for r in refs)
        print(f"  flash bwd float16 large dO{dtag} (q x {q_gain}, k x "
              f"{k_gain}, dO x {gain}, causal={causal}): max |dP - Delta| "
              f"{dp_delta:.1f}, max |dS| {ds_max:.1f} (f16's largest "
              f"65504); the fp32 twin's dQ, dK, dV "
              f"{'fit' if fits else 'do not fit'} in f16")
        assert dp_delta >= 1e4 and fits, (dp_delta, fits)
        assert causal or ds_max > 65504.0, ds_max
        dq = fa.flash_attention_bwd_dq(*args)
        dk, dv = fa.flash_attention_bwd_dkv(*args)
        tols = fa.flash_bwd_f16_tol(*args)
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            tag = f"flash bwd float16 large dO{dtag} causal={causal} {name}"
            assert bool(torch.isfinite(got.float()).all()), tag
            _close(tag, got, want, tols[name])
            fro = fa.rel_fro(got, want)
            print(f"  {tag}: relative Frobenius error {fro:.3e} (at most "
                  f"{fa.FLASH_BWD_F16_FRO_RTOL})")
            assert fro <= fa.FLASH_BWD_F16_FRO_RTOL, (tag, fro)


def _check_flash_bwd_d128(dtype):
    """dQ and dK/dV at head_dim 128 (each kernel two consumer warpgroups a
    CTA, persistent) against their twins: FLASH_D128_LENGTHS causal and
    not, a non-causal 40 x 300 (dQ's second warpgroup without rows), a
    batch of 3 read through the fused qkv strides, (8, 1000, 16, 128)
    (1024 work items of 128 rows or keys, more than the card's SMs, the
    last of each head ragged in its second warpgroup), two launches bit
    for bit equal, and in f16 the dS guard's large-dO cases."""
    name = str(dtype)[6:]
    for n in FLASH_D128_LENGTHS:
        for causal in (True, False):
            qkv = _fused_qkv(n, dtype, seed=500 + n, heads=4, head_dim=128)
            _check_flash_bwd_case(f"flash bwd {name} n={n} causal={causal} "
                                  "D=128", *qkv, causal, seed=n)
    q = _fused_qkv(40, dtype, seed=51, heads=4, head_dim=128)[0]
    _, k, v = _fused_qkv(300, dtype, seed=52, heads=4, head_dim=128)
    _check_flash_bwd_case(f"flash bwd {name} n=40 m=300 causal=False D=128",
                          q, k, v, False, seed=53)
    _check_flash_bwd_case(f"flash bwd {name} (3, 200, 4, 128) causal=True",
                          *_fused_qkv(200, dtype, seed=54, heads=4,
                                      head_dim=128, batch=3), True, seed=55)
    # more 128-row (dQ) and 128-key (dK/dV) blocks than the card has SMs:
    # a CTA walks several
    for causal in (True, False):
        _check_flash_bwd_case(f"flash bwd {name} (8, 1000, 16, 128) "
                              f"causal={causal}",
                              *_fused_qkv(1000, dtype, seed=58, heads=16,
                                          head_dim=128, batch=8), causal,
                              seed=59)
    args = _flash_bwd_inputs(*qkv, True, seed=2047)
    _twice_equal(f"flash bwd {name} n=2047 causal=True D=128 dkv",
                 lambda: fa.flash_attention_bwd_dkv(*args))
    _twice_equal(f"flash bwd {name} n=2047 causal=True D=128 dq",
                 lambda: [fa.flash_attention_bwd_dq(*args)])
    if dtype == F16:
        _check_f16_large_do(head_dim=128)


def check_flash_bwd(dtype=torch.bfloat16):
    """dQ and dK/dV against their fp32 twins over their cases, then timed
    at the training shape beside SDPA's backward (dQ, dK and dV in one
    call): bf16 (``dtype``'s default) with the fp32 cases first, or
    float16 (F16) with the large-dO cases (the dS factor's) and a dO gain
    at the training shape; its rows are named by `_row_name`."""
    f16 = dtype == F16
    for dt in (dtype,) if f16 else (torch.float32, dtype):
        name = str(dt)[6:]
        for n in (40, 1024):
            for causal in (True, False):
                _check_flash_bwd_case(f"flash bwd {name} n={n} causal={causal}",
                                      *_fused_qkv(n, dt, seed=n), causal)
        _check_flash_bwd_case(f"flash bwd {name} n=40 causal=True D=128",
                              *_fused_qkv(40, dt, seed=7, heads=4,
                                          head_dim=128), True)
        _check_flash_bwd_case(f"flash bwd {name} (3, 40, {HEADS}, "
                              f"{HEAD_DIM}) causal=False",
                              *_fused_qkv(40, dt, seed=10, batch=3), False)
        if not f16:
            q = _fused_qkv(40, dt, seed=8)[0]
            _, k, v = _fused_qkv(100, dt, seed=9)
            _check_flash_bwd_case(f"flash bwd {name} n=40 m=100 "
                                  "causal=False", q, k, v, False)
    name = str(dtype)[6:]
    if not f16:
        # bf16 tile edges and a length that is no power of two: TMA's zero
        # fill past n, the masks of the diagonal and edge tiles, D = 128 at
        # a ragged length
        for n in (8, 64, 65, 1000):
            for causal in (True, False):
                _check_flash_bwd_case(
                    f"flash bwd bfloat16 n={n} causal={causal}",
                    *_fused_qkv(n, dtype, seed=30 + n), causal)
        _check_flash_bwd_case("flash bwd bfloat16 n=200 causal=False D=128",
                              *_fused_qkv(200, dtype, seed=32, heads=4,
                                          head_dim=128), False)
    # k and v at 16-byte aligned offsets into a wider buffer
    _check_flash_bwd_case(f"flash bwd {name} n=200 causal=True k, v offset "
                          "views", *_offset_qkv(200, seed=31, dtype=dtype),
                          True)
    _check_flash_bwd_d128(dtype)
    _check_flash_bwd_refuses_misaligned_do(dtype)
    b, n = 8, 1024
    q, k, v = _fused_qkv(n, dtype, seed=11, batch=b)
    if f16:
        _check_f16_large_do()
        _check_flash_bwd_case(f"flash bwd float16 ({b}, {n}) causal, dO "
                              f"gain {F16_TRAIN_DO_GAIN}", q, k, v, True,
                              seed=12, gain=F16_TRAIN_DO_GAIN)
    else:
        # main-path shape: a training step's attention, causal; fp32 here,
        # bf16 below with the timings
        _check_flash_bwd_case(f"flash bwd float32 ({b}, {n}, {HEADS}, "
                              f"{HEAD_DIM}) causal",
                              *_fused_qkv(n, torch.float32, seed=11,
                                          batch=b), True, seed=12)
    short = "float16" if f16 else "bf16"
    err_dq, err_dkv = _check_flash_bwd_case(
        f"flash bwd {short} ({b}, {n}, {HEADS}, {HEAD_DIM}) causal", q, k, v,
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
    shape = f"q,k,v,dO ({b}, {n}, {HEADS}, {HEAD_DIM}) {short} causal"
    pairs = b * HEADS * (n * (n + 1) // 2)
    rows = []
    for dkv, fn, ref, err in (
            (False, fa.flash_attention_bwd_dq,
             fa.flash_attention_bwd_dq_reference, err_dq),
            (True, fa.flash_attention_bwd_dkv,
             fa.flash_attention_bwd_dkv_reference, err_dkv)):
        bound = _flash_bwd_bound(b, n, HEADS, HEAD_DIM, 2, True, dkv)
        counter = f"flash_attention_bwd_{'dkv' if dkv else 'dq'}"
        replaces = "paddle_tpu/kernels/flash_attention.py:" + (
            "223 _dkv_kernel" if dkv else "184 _dq_kernel")
        if f16:
            row = _f16_row(
                _row_name(counter, F16), counter,
                "paddle_tpu_torch/csrc/flash_attention_bwd.cu", replaces,
                lambda fn=fn: fn(*args), lambda ref=ref: ref(*args), None, 0,
                0, err, shape,
                note="library_ms: SDPA's backward in f16 (dQ, dK and dV in "
                     "one call)", bound=bound)
            row["library_ms"] = library_ms
        else:
            ms, host_ms = _timed(lambda: fn(*args))
            row = {
                "name": counter, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                "replaces": replaces, "max_abs_err": err, "ms": ms,
                "host_ms": host_ms,
                "plain_ms": _cuda_ms(lambda: ref(*args), iters=5),
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms,
                "tile": "64 rows per CTA (1 consumer warpgroup) x 64-row "
                        "streamed tiles, 3-stage ring",
                "shape": shape}
        row["tflops"] = (8 if dkv else 6) * HEAD_DIM * pairs \
            / (row["ms"] * 1e-3) / 1e12
        rows.append(row)
    pair_ms = rows[0]["ms"] + rows[1]["ms"]
    print(f"  flash bwd {short} pair at the training shape: dq "
          f"{rows[0]['ms']:.4f} + dkv {rows[1]['ms']:.4f} = {pair_ms:.4f} ms; "
          f"SDPA's backward (dQ, dK, dV in one call) {library_ms:.4f} ms: "
          f"{pair_ms / library_ms:.3f}x")
    if not f16:
        print("  flash bwd bf16, the earlier design, written in, not measured "
              f"in this run: {json.dumps(FLASH_BWD_PREV_MS)}; per training "
              f"step {json.dumps(TRAIN_BWD_GROUPS_PREV_MS)}")
    return rows


# ViT-L/16's attention (the vit phase's): batch 32, 196 patches and the
# class token, 16 heads of 64, bf16, non-causal
VIT_ATTN = (32, 197, 16, 64)
# the TPU kernel each flash row at another shape replaces
FLASH_REPLACES = {
    "flash_attention_fwd": "paddle_tpu/kernels/flash_attention.py:90 "
                           "_fwd_kernel",
    "flash_attention_bwd_dq": "paddle_tpu/kernels/flash_attention.py:184 "
                              "_dq_kernel",
    "flash_attention_bwd_dkv": "paddle_tpu/kernels/flash_attention.py:223 "
                               "_dkv_kernel"}


def _flash_shape_rows(q, k, v, causal, seed, errs, suffix, where):
    """The bf16 flash forward, dQ and dK/dV at q's shape timed beside their
    twins and SDPA (the forward; the backward with dQ, dK and dV in one
    call), with their bounds (4 D FLOPs an unmasked (query, key) pair
    forward, 6 D dQ, 8 D dK/dV). `errs`: each kernel's max_abs_err from
    its check; rows ``<counter>@<suffix>``."""
    b, n, h, d = q.shape
    args = _flash_bwd_inputs(q, k, v, causal, seed=seed)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        fwd_lib = _cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal))
    lib_out = sdpa(qt, kt, vt, is_causal=causal)
    bwd_lib = _cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), args[3].transpose(1, 2), retain_graph=True))
    pairs = b * h * (n * (n + 1) // 2 if causal else n * n)
    fwd_bound = _bound_ms(b * (4 * n * h * d * 2 + h * n * 4),
                          4 * d * pairs, torch.bfloat16)
    cases = (
        ("flash_attention_fwd", lambda: fa.flash_attention_fwd(q, k, v,
                                                               causal),
         lambda: fa.flash_attention_reference(q, k, v, causal), fwd_bound,
         fwd_lib, 4, "flash_attention_fwd.cu"),
        ("flash_attention_bwd_dq",
         lambda: fa.flash_attention_bwd_dq(*args),
         lambda: fa.flash_attention_bwd_dq_reference(*args),
         _flash_bwd_bound(b, n, h, d, 2, causal, False), bwd_lib, 6,
         "flash_attention_bwd.cu"),
        ("flash_attention_bwd_dkv",
         lambda: fa.flash_attention_bwd_dkv(*args),
         lambda: fa.flash_attention_bwd_dkv_reference(*args),
         _flash_bwd_bound(b, n, h, d, 2, causal, True), bwd_lib, 8,
         "flash_attention_bwd.cu"))
    rows = []
    for (counter, kernel, twin, bound, library, per_pair, src), err in zip(
            cases, errs):
        ms, host_ms = _timed(kernel)
        row = {"name": f"{counter}@{suffix}", "counter": counter,
               "route": "cuda", "source": f"paddle_tpu_torch/csrc/{src}",
               "replaces": FLASH_REPLACES[counter], "max_abs_err": err,
               "ms": ms, "host_ms": host_ms,
               "plain_ms": _cuda_ms(twin, iters=5), "bound_ms": bound[0],
               "bound_by": bound[1], "library_ms": library,
               "tflops": per_pair * d * pairs / (ms * 1e-3) / 1e12,
               "shape": f"q,k,v ({b}, {n}, {h}, {d}) bf16 "
                        f"causal={causal}"}
        if counter != "flash_attention_fwd":
            row["note"] = ("library_ms: SDPA's backward, dQ, dK and dV in "
                           "one call")
        print(f"  {row['name']} at {where}: {ms:.5f} ms (host "
              f"{host_ms:.5f}), {row['tflops']:.1f} TFLOP/s, twin "
              f"{row['plain_ms']:.4f} ms, bound {bound[0]:.5f} ms "
              f"({bound[1]}), SDPA {library:.5f} ms")
        rows.append(row)
    pair = rows[1]["ms"] + rows[2]["ms"]
    print(f"  flash at {where}: forward {rows[0]['ms']:.5f} ms against "
          f"SDPA's {fwd_lib:.5f} ({rows[0]['ms'] / fwd_lib:.3f}x); dq + dkv "
          f"{pair:.5f} ms against SDPA's backward {bwd_lib:.5f} "
          f"({pair / bwd_lib:.3f}x)")
    return rows


def check_flash_vit():
    """The flash forward, dQ and dK/dV at ViT-L/16's shape (VIT_ATTN,
    non-causal, a length no multiple of a tile), against their twins
    within the bf16 criteria (and in fp32 at the vit phase's card-vs-CPU
    batch of 2), then timed (`_flash_shape_rows`). Rows
    ``<counter>@vit``; their launches are the vit phase's."""
    b, n, h, d = VIT_ATTN
    for dt, batch in ((torch.float32, 2), (torch.bfloat16, b)):
        q, k, v = _fused_qkv(n, dt, seed=197, heads=h, head_dim=d,
                             batch=batch)
        name = f"flash {str(dt)[6:]} ViT-L/16 ({batch}, {n}, {h}, {d})"
        err_fwd = _check_flash_case(f"{name} causal=False", q, k, v, False)
        err_dq, err_dkv = _check_flash_bwd_case(f"{name} bwd causal=False",
                                                q, k, v, False, seed=198)
    return _flash_shape_rows(q, k, v, False, 198, (err_fwd, err_dq, err_dkv),
                             "vit", "ViT-L/16's shape")


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


def check_ce(dtype=torch.bfloat16):
    """The fused cross-entropy kernels against their twins, bf16 (with the
    fp32 cases first) or float16, then timed at the main-path shape beside
    F.cross_entropy and its autograd backward; f16 rows are named by
    `_row_name`."""
    f16 = dtype == F16
    # R = 777 rows: not a multiple of any tile; V = 3000 and 50257 leave a
    # ragged vocabulary tail, 50304 is the model's padded vocabulary
    for dt in (dtype,) if f16 else (torch.float32, dtype):
        name = str(dt)[6:]
        for v in (3000, 50257, 50304):
            _check_ce_case(f"ce {name} R=777 V={v}",
                           *_ce_inputs(777, v, dt, seed=v))
        _check_ce_case(f"ce {name} R=777 V=50257 row stride 50262",
                       *_ce_inputs(777, 50257, dt, seed=1, pad_cols=5))
    # main-path shape: the logits of 8 x 1024 tokens
    r, v = 8192, 50304
    short = "float16" if f16 else "bf16"
    logits, labels, grad = _ce_inputs(r, v, dtype, seed=2)
    err_fwd, err_bwd = _check_ce_case(f"ce {short} R={r} V={v}", logits,
                                      labels, grad)
    _, lse = ce.cross_entropy_fwd(logits, labels)
    # yardsticks the port never calls: F.cross_entropy(reduction="none")
    # and its autograd backward (which refuse negative labels other than
    # ignore_index, so those rows are ignored there)
    lib_labels = labels.masked_fill(labels < 0, -100)
    lib_logits = logits.detach().requires_grad_(True)
    lib_loss = torch.nn.functional.cross_entropy(
        lib_logits, lib_labels, reduction="none", ignore_index=-100)
    fwd_lib = lambda: torch.nn.functional.cross_entropy(  # noqa: E731
        logits, lib_labels, reduction="none", ignore_index=-100)
    bwd_lib = lambda: torch.autograd.grad(  # noqa: E731
        lib_loss, lib_logits, grad, retain_graph=True)
    elem = logits.element_size()
    rows = []
    for kind, fn, ref, err, lib, nbytes in (
            ("fwd", lambda: ce.cross_entropy_fwd(logits, labels),
             lambda: ce.cross_entropy_fwd_reference(logits, labels),
             err_fwd, fwd_lib, r * v * elem + r * 8 + 2 * r * 4),
            ("bwd", lambda: ce.cross_entropy_bwd(logits, labels, lse, grad),
             lambda: ce.cross_entropy_bwd_reference(logits, labels, lse,
                                                    grad),
             err_bwd, bwd_lib, 2 * r * v * elem + r * (8 + 4 + 4))):
        counter = f"cross_entropy_{kind}"
        replaces = ("paddle_tpu/kernels/cross_entropy.py:77 _fwd_kernel"
                    if kind == "fwd" else
                    "paddle_tpu/kernels/cross_entropy.py:107 _bwd_kernel")
        # about 4 fp32 operations per element (max, subtract, exp, add)
        if f16:
            rows.append(_f16_row(
                _row_name(counter, F16), counter,
                "paddle_tpu_torch/csrc/cross_entropy.cu", replaces, fn, ref,
                lib, nbytes, 4 * r * v, err,
                f"logits ({r}, {v}) float16; library_ms: F.cross_entropy "
                f"(reduction none" + (")" if kind == "fwd" else
                                      ") and its autograd backward")))
            continue
        bound, by = _bound_ms(nbytes, 4 * r * v, torch.float32)
        ms, host_ms = _timed(fn)
        rows.append({
            "name": counter, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/cross_entropy.cu",
            "replaces": replaces,
            "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": _cuda_ms(ref, iters=5), "bound_ms": bound,
            "bound_by": by, "library_ms": _cuda_ms(lib),
            "shape": f"logits ({r}, {v}) bf16"})
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


def _int_bits(t):
    """`t`'s bits as integers of its width (NaNs compare equal)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _differ_bits(a, b):
    """Elements of the tensors of `a` whose bits differ from `b`'s (None
    entries skipped)."""
    return sum(int((_int_bits(x) != _int_bits(y)).sum())
               for x, y in zip(a, b) if x is not None)


def _check_adam_guard(tag, shapes, dtype, masters, decays, offset=0):
    """The guard's probe and gated apply, kernel against twin from one
    state, bit for bit, with finite gradients, a NaN in the last tensor's
    last gradient element and an lr of inf: the flag is set exactly where
    the step is not finite, the probe writes nothing, the apply is the
    plain update where the flag is clear and writes nothing where it is
    set. Returns the largest error against the twin (`_max_err`)."""
    lr = torch.full((), ADAM_LRS[0], device="cuda")
    t = torch.full((), 2.0, device="cuda")
    err = 0.0
    for poison in ("none", "grad", "lr"):
        kern = list(_adam_state(shapes, dtype, masters, seed=5,
                                offset=offset))
        if poison == "grad":
            kern[1][-1].view(-1)[-1] = float("nan")
        lr.fill_(float("inf") if poison == "lr" else ADAM_LRS[0])
        twin = [[None if x is None else x.clone() for x in xs]
                for xs in kern]
        before = [[None if x is None else x.clone() for x in xs]
                  for xs in kern]
        flags = [torch.zeros((), dtype=torch.int32, device="cuda")
                 for _ in range(2)]
        for guard in ("probe", "apply"):
            for fn, state, flag in ((au.adam_update, kern, flags[0]),
                                    (au.adam_update_reference, twin,
                                     flags[1])):
                fn(*state, decays, lr, t, 0.9, 0.999, 1e-8, 0.01,
                   guard=guard, flag=flag)
            if guard == "probe":
                got = [int(f) for f in flags]
                assert got == [int(poison != "none")] * 2, (tag, poison, got)
                moved = sum(_differ_bits(a, b) for a, b in zip(kern, before))
                assert moved == 0, (tag, poison, moved)
        differ = sum(_differ_bits(a, b) for a, b in zip(kern, twin))
        moved = sum(_differ_bits(a, b) for a, b in zip(kern, before))
        err = max(err, *(_max_err([x for x in a if x is not None],
                                  [y for y in b if y is not None])
                         for a, b in zip(kern, twin)))
        assert differ == 0 and err == 0.0, (tag, poison, differ, err)
        assert (moved == 0) == (poison != "none"), (tag, poison, moved)
    torch.cuda.synchronize()
    print(f"  adam_update {tag}: probe and gated apply, finite / NaN grad / "
          f"lr inf: flags and state bit for bit with the twin, skipped "
          f"steps write nothing")
    return err


def _adam_cases(dtype):
    """The plain and the guarded checks of `dtype` on the ragged shapes
    (fp32 and bf16 or f16 without masters, aligned and misaligned; with
    masters), then on GPT-2 124M's 148 tensors with masters, every tensor
    decaying; returns the last plain case's (error, state), the decays
    and the guarded checks' largest error."""
    model = GPTForCausalLM(gpt2_124m(), device="cuda", seed=0)
    shapes = [tuple(p.shape) for p in model.parameters()]
    del model
    ragged = [(7, 13), (768,), (5,), (3, 4, 5), (1,), (2, 8195)]
    skip = [i % 2 == 0 for i in range(len(ragged))]
    name = "bf16" if dtype == torch.bfloat16 else str(dtype)[6:]
    guard_err = 0.0
    for dt in ((torch.float32, dtype) if dtype == torch.bfloat16
               else (dtype,)):
        for offset in (0, 1):
            tag = (f"{str(dt)[6:]} no masters, ragged shapes, offset "
                   f"{offset}")
            _check_adam_case(tag, ragged, dt, False, skip, offset)
            guard_err = max(guard_err, _check_adam_guard(
                tag, ragged, dt, False, skip, offset))
    _check_adam_case(f"{name} + masters, ragged shapes", ragged, dtype,
                     True, skip)
    guard_err = max(guard_err, _check_adam_guard(
        f"{name} + masters, ragged shapes", ragged, dtype, True, skip))
    decays = [True] * len(shapes)
    tag = f"{name} + masters, GPT-2 124M ({len(shapes)} tensors"
    if dtype == torch.bfloat16:
        tag += f", {sum(int(np.prod(s)) for s in shapes)} elements"
    guard_err = max(guard_err, _check_adam_guard(tag + ")", shapes, dtype,
                                                 True, decays))
    return (_check_adam_case(tag + ")", shapes, dtype, True, decays),
            decays, guard_err)


ADAM_REPLACES = ("no Pallas counterpart: the jitted batch update of "
                 "paddle_tpu/optimizer/optimizer.py:131-197 over the rule "
                 "of paddle_tpu/optimizer/optimizers.py:76-148 (XLA ops)")
GUARD_REPLACES = ("no Pallas counterpart: the guard's finite_all + "
                  "where(finite, new, old) folded into the jitted update, "
                  "paddle_tpu/optimizer/optimizer.py:131-197 (XLA ops)")


def check_adam_update(dtype=torch.bfloat16):
    """The multi-tensor AdamW update and its guarded forms (`_adam_cases`)
    against the twin; timed at GPT-2 124M (148 tensors, `dtype` params
    with fp32 masters, every tensor decaying, as the train phases run it).
    bf16: returns the update's row and the probe's and the gated apply's;
    float16: the update's f16 row."""
    (err, state), decays, guard_err = _adam_cases(dtype)
    params, grads, m1, m2, mw = state
    lr = torch.full((), TRAIN_LR, device="cuda")
    t = torch.full((), 4.0, device="cuda")
    args = (params, grads, m1, m2, mw, decays, lr, t, 0.9, 0.999, 1e-8,
            0.01)
    nbytes = au.update_bytes(params, mw)
    steps = [torch.full((), 4.0, device="cuda") for _ in params]
    if dtype == F16:
        m1h, m2h = [m.half() for m in m1], [m.half() for m in m2]
        params_h = [p.clone() for p in params]
        other_ms = _cuda_ms(lambda: torch._fused_adamw_(
            params_h, grads, m1h, m2h, [], steps, lr=TRAIN_LR, beta1=0.9,
            beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
            maximize=False))
        return [_f16_row(
            _row_name("adam_update", F16), "adam_update",
            "paddle_tpu_torch/csrc/adam_update.cu",
            "no Pallas counterpart: the jitted batch update of paddle_tpu/"
            "optimizer/optimizer.py:131-197 (XLA ops)",
            lambda: au.adam_update(*args),
            lambda: au.adam_update_reference(*args), None, nbytes,
            15 * sum(p.numel() for p in params), err,
            f"GPT-2 124M's {len(params)} tensors, f16 params + fp32 masters "
            f"and moments, every tensor decaying",
            note=f"library_ms null: no PyTorch call computes Paddle's "
                 f"formula; torch._fused_adamw_ at f16 (params, grads and "
                 f"moments f16, another formula): {other_ms:.4f} ms")]
    # ~15 fp32 operations an element (two moments, decay, sqrt, divide)
    n = sum(p.numel() for p in params)
    bound, by = _bound_ms(nbytes, 15 * n, torch.float32)
    ms, host_ms = _timed(lambda: au.adam_update(*args))
    plain_ms = _cuda_ms(lambda: au.adam_update_reference(*args), iters=5)
    # a yardstick of PyTorch's own fused AdamW at the same shapes: another
    # formula (epsilon after the bias correction), so not library_ms
    grads32 = [g.float() for g in grads]
    fused = lambda **kw: torch._fused_adamw_(  # noqa: E731
        mw, grads32, m1, m2, [], steps, lr=TRAIN_LR, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False, **kw)
    other_ms = _cuda_ms(fused)
    shape = (f"GPT-2 124M's {len(params)} tensors, bf16 params + fp32 "
             f"masters and moments, every tensor decaying")
    rows = [{"name": "adam_update", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/adam_update.cu",
             "replaces": ADAM_REPLACES,
             "max_abs_err": err, "ms": ms, "host_ms": host_ms,
             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
             "library_ms": None, "bytes": nbytes, "shape": shape,
             "note": ("library_ms null: no PyTorch call computes Paddle's "
                      "formula (torch._fused_adamw_ adds epsilon after the "
                      f"bias correction); that call at the same shapes, "
                      f"fp32 grads: {other_ms:.4f} ms, another formula")}]
    # the guard's two forms, the flag clear (the apply then writes)
    flag = torch.zeros((), dtype=torch.int32, device="cuda")
    found = torch.zeros((), device="cuda")
    guarded_other = _cuda_ms(lambda: fused(found_inf=found))
    for guard, nbytes_g in (("probe", au.probe_bytes(params, mw)),
                            ("apply", nbytes + 4)):
        kern = lambda: au.adam_update(*args, guard=guard,  # noqa: E731
                                      flag=flag)
        twin = lambda: au.adam_update_reference(  # noqa: E731
            *args, guard=guard, flag=flag)
        ms, host_ms = _timed(kern)
        plain_ms = _cuda_ms(twin, iters=5)
        bound, by = _bound_ms(nbytes_g, 15 * n, torch.float32)
        rows.append({
            "name": f"adam_update_{guard}", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/adam_update.cu",
            "replaces": GUARD_REPLACES, "max_abs_err": guard_err,
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "bytes": nbytes_g,
            "shape": shape + ", flag clear",
            "note": ("library_ms null: torch._fused_adamw_'s found_inf "
                     "checks no new state and its formula is another; that "
                     f"call with found_inf at the same shapes, fp32 grads: "
                     f"{guarded_other:.4f} ms")})
        print(f"  adam_update_{guard}: {ms:.5f} ms (host {host_ms:.5f}), "
              f"twin {plain_ms:.5f} ms, bound {bound:.5f} ms ({by})")
    flag.fill_(1)
    skipped_ms = _cuda_ms(lambda: au.adam_update(*args, guard="apply",
                                                 flag=flag))
    print(f"  adam_update_apply with the flag set (every CTA returns): "
          f"{skipped_ms:.5f} ms")
    return rows


def _finite_lists(dtypes, offset, seed, gain=1.0):
    """Ragged lists of each dtype (views `offset` elements into their
    storage; the last of each dtype transposed, so dense but not
    contiguous), normal values times `gain`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = [(7, 13), (768,), (5,), (3, 4, 5), (1,), (2, 8195), (16384,),
              (16385,), (517, 33)]
    out = []
    for dt in dtypes:
        for s in shapes:
            n = int(np.prod(s))
            flat = torch.randn(n + offset, generator=g, device="cuda") * gain
            out.append(flat.to(dt)[offset:].view(s))
        out[-1] = out[-1].t()
    return out


def _check_finite_kernels():
    """multi_tensor_finite (with and without the unscale) and
    multi_tensor_copy_if against their twins, bit for bit: ragged lists
    mixing fp32, bf16, f16 and float64, aligned and misaligned, a
    transposed tensor of each dtype, all finite and with a NaN, an inf or
    a -inf in one element, the flag clear and set."""
    cases = 0
    for offset in (0, 1):
        for poison in (None, float("nan"), float("inf"), float("-inf")):
            for unscale in (False, True):
                # gain 1e3: within f16's range, and the unscale by 2^-15
                # reaches its subnormals
                kern = _finite_lists(fc.DTYPES, offset, seed=9, gain=1e3)
                if poison is not None:
                    bad = kern[cases % len(kern)]
                    bad[(-1,) * bad.dim()] = poison
                twin = [x.clone() for x in kern]
                flags = [torch.zeros((), dtype=torch.int32, device="cuda")
                         for _ in range(2)]
                inv = 1.0 / torch.full((), 2.0 ** 15, device="cuda") \
                    if unscale else None
                fc.multi_tensor_finite(kern, flags[0], inv)
                fc.multi_tensor_finite_reference(twin, flags[1], inv)
                got = [int(f) for f in flags]
                assert got == [int(poison is not None)] * 2, (offset, got)
                assert _differ_bits(kern, twin) == 0, (offset, poison)
                cases += 1
        for flag_value in (0, 1):
            dst = _finite_lists(fc.DTYPES, offset, seed=10)
            src = _finite_lists(fc.DTYPES, offset, seed=11)
            twin = [x.clone() for x in dst]
            before = [x.clone() for x in dst]
            flag = torch.full((), flag_value, dtype=torch.int32,
                              device="cuda")
            fc.multi_tensor_copy_if(dst, src, flag)
            fc.multi_tensor_copy_if_reference(twin, src, flag)
            assert _differ_bits(dst, twin) == 0, (offset, flag_value)
            assert _differ_bits(dst, before if flag_value else src) == 0
            cases += 1
    torch.cuda.synchronize()
    print(f"  finite_check: {cases} cases (fp32, bf16, f16, float64 ragged "
          f"lists with a transposed tensor each, offsets 0 and 1, finite / "
          f"NaN / inf / -inf, the unscale, the copy with the flag clear and "
          f"set) bit for bit with the twins")


def _max_err(a, b):
    """The largest |x - y| over the elements of the tensors of lists `a`
    and `b`, where their bits differ (inf where one is not finite); 0.0
    where every element has the same bits."""
    err = 0.0
    for x, y in zip(a, b):
        same = _int_bits(x) == _int_bits(y)
        if bool(same.all()):
            continue
        d = (x.double() - y.double()).abs().nan_to_num(float("inf"))
        err = max(err, float(d.masked_fill(same, 0).max()))
    return err


def _held_to_twin(tag, kern, twin, tensors, poison, want=None):
    """Run `kern` and `twin` (each ``fn(tensors, flag)``) on copies of
    `tensors`, the last element of the last tensor set to `poison` where
    it is not None, from a clear flag: the flags must be equal and say
    whether `poison` is finite, the tensors' bits equal (and equal to
    `want`'s where it is given). Returns the largest error
    (`_max_err`)."""
    sides = [[t.clone() for t in tensors] for _ in range(2)]
    flags = [torch.zeros((), dtype=torch.int32, device="cuda")
             for _ in range(2)]
    for side in sides:
        if poison is not None:
            side[-1][(-1,) * side[-1].dim()] = poison
    kern(sides[0], flags[0])
    twin(sides[1], flags[1])
    got = [int(f) for f in flags]
    want_flag = int(poison is not None and not np.isfinite(poison))
    assert got == [want_flag] * 2, (tag, poison, got)
    err = _max_err(sides[0], sides[1])
    assert err == 0.0 and _differ_bits(sides[0], sides[1]) == 0, (
        tag, poison, err)
    assert want is None or _differ_bits(sides[0], want) == 0, tag
    return err


def check_finite_check():
    """The guard's check and copy (`_check_finite_kernels`), then at the
    train_guard path's shapes (GPT-2 124M's fp32 gradients, parameters and
    Momentum velocities): each kernel against its twin on copies of the
    same lists, bit for bit, with the flag clear and set (the unscale at
    the scaler's 2^-15, the check over the gradients and the new state,
    each finite and with an inf; the copy under a clear and a set flag),
    then each timed: the O1 GradScaler's unscale, the Momentum guard's
    check over the gradients and the new parameters and velocities, and
    its copy of the new parameters and velocities."""
    _check_finite_kernels()
    model = GPTForCausalLM(gpt2_124m(), device="cuda", seed=0)
    params = [p.detach() for p in model.parameters()]
    del model
    g = torch.Generator(device="cuda").manual_seed(12)
    grads = [torch.randn(p.shape, generator=g, device="cuda") * 1e-2
             for p in params]
    velocity = [torch.randn(p.shape, generator=g, device="cuda") * 1e-3
                for p in params]
    n = sum(p.numel() for p in params)
    src = [p.clone() for p in params] + [v.clone() for v in velocity]
    dst = [p.clone() for p in params] + [v.clone() for v in velocity]
    checked = grads + src
    inv_scale = 1.0 / torch.full((), 2.0 ** 15, device="cuda")
    errs = {}
    for poison in (None, float("inf")):
        errs["multi_tensor_finite_unscale", poison] = _held_to_twin(
            "unscale", lambda ts, f: fc.multi_tensor_finite(ts, f, inv_scale),
            lambda ts, f: fc.multi_tensor_finite_reference(ts, f, inv_scale),
            grads, poison)
        errs["multi_tensor_finite", poison] = _held_to_twin(
            "check", fc.multi_tensor_finite,
            fc.multi_tensor_finite_reference, checked, poison)
    for flag_value in (0, 1):
        flag = torch.full((), flag_value, dtype=torch.int32, device="cuda")
        errs["multi_tensor_copy_if", flag_value] = _held_to_twin(
            f"copy_if, flag {flag_value}",
            lambda ts, f: fc.multi_tensor_copy_if(ts, src, flag),
            lambda ts, f: fc.multi_tensor_copy_if_reference(ts, src, flag),
            dst, None, want=dst if flag_value else src)
    torch.cuda.synchronize()
    print(f"  finite_check at GPT-2 124M ({len(grads)} gradients, "
          f"{len(checked)} checked, {len(dst)} copied; {n} elements a "
          f"list): the unscale by 2^-15 and the check, finite and with an "
          f"inf, the copy with the flag clear and set, bit for bit with "
          f"the twins")
    flag = torch.zeros((), dtype=torch.int32, device="cuda")
    found = torch.zeros((), device="cuda")
    inv = torch.ones((), device="cuda")
    # the library call nearest the plain check: it also writes each
    # element (times 1 here)
    check_write_ms = _cuda_ms(
        lambda: torch._amp_foreach_non_finite_check_and_unscale_(
            checked, found, inv))
    cases = (
        ("multi_tensor_finite_unscale", grads,
         lambda: fc.multi_tensor_finite(grads, flag, inv),
         lambda: fc.multi_tensor_finite_reference(grads, flag, inv),
         lambda: torch._amp_foreach_non_finite_check_and_unscale_(
             grads, found, inv), 8 * n,
         f"GPT-2 124M's {len(grads)} fp32 gradients (the O1 GradScaler's "
         f"unscale_), timed at scale 1, held to the twin at 2^-15", None),
        ("multi_tensor_finite", checked,
         lambda: fc.multi_tensor_finite(checked, flag),
         lambda: fc.multi_tensor_finite_reference(checked, flag), None,
         12 * n, f"GPT-2 124M's fp32 gradients, new parameters and new "
         f"velocities ({len(checked)} tensors: the guarded Momentum's "
         f"check)", f"library_ms null: no one PyTorch call checks without "
         f"writing; torch._amp_foreach_non_finite_check_and_unscale_ over "
         f"the same list (scale 1, so it also writes each element): "
         f"{check_write_ms:.4f} ms"),
        ("multi_tensor_copy_if", dst,
         lambda: fc.multi_tensor_copy_if(dst, src, flag),
         lambda: fc.multi_tensor_copy_if_reference(dst, src, flag),
         lambda: torch._foreach_copy_(dst, src), 16 * n,
         f"GPT-2 124M's new fp32 parameters and velocities ({len(dst)} "
         f"tensors: the guarded Momentum's copy), flag clear; library_ms: "
         f"torch._foreach_copy_ (unconditional)", None))
    rows = []
    for name, tensors, kern, twin, library, nbytes, shape, note in cases:
        ms, host_ms = _timed(kern)
        plain_ms = _cuda_ms(twin, iters=5)
        library_ms = _cuda_ms(library) if library is not None else None
        bound, by = _bound_ms(nbytes, 2 * n, torch.float32)
        err = max(v for k, v in errs.items() if k[0] == name)
        print(f"  {name}: {ms:.5f} ms (host {host_ms:.5f}), twin "
              f"{plain_ms:.5f} ms, library "
              f"{'null' if library_ms is None else f'{library_ms:.5f} ms'}"
              f", bound {bound:.5f} ms ({by}), max_abs_err {err}")
        row = {"name": name, "route": "cuda",
               "source": "paddle_tpu_torch/csrc/finite_check.cu",
               "replaces": GUARD_REPLACES, "max_abs_err": err, "ms": ms,
               "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": by, "library_ms": library_ms, "bytes": nbytes,
               "shape": shape}
        if note:
            row["note"] = note
        rows.append(row)
    assert int(flag) == 0 and int(found) == 0
    return rows


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
                "torch_prefill_scatter_twopass", "torch_lora_delta_pr15")
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


# the batched adapter delta at the serve_tenancy phase's shapes: GPT-2
# 124M's projections (qkv 768 -> 2304, out 768 -> 768), the base and two
# adapters (K = 3), 12 layers; decode rows are the 8 slots (the row form),
# prefill rows one request's bucket (the tile form); rank 16 (the phase's
# engine) and 4 (`LLMEngine`'s default, 8 bytes a row of A in bf16)
LORA_RANK = 16
LORA_RANKS = (16, 4)
LORA_DECODE_SLOTS = [0, 1, 2, 1, 0, 2, 2, 1]
LORA_PREFILL_ROWS = 1024
LORA_ROWS = {"decode": len(LORA_DECODE_SLOTS), "prefill": LORA_PREFILL_ROWS,
             "prefill_base": LORA_PREFILL_ROWS, "prefill_ragged": 37}
# in turns: the reference's op sequence, the first design, the form, the
# form, the first design, the op sequence
LORA_TURNS = ("ops", "first", "form", "form", "first", "ops")


def _lora_state(n, d_out, dtype, seed, d_in=768, rank=LORA_RANK):
    """y [n, out], x [n, in], A [3, 12, in, r] and B [3, 12, r, out] (slot
    0 zero, std 0.05 as the seeded adapters draw) and scale [3]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, d_in), generator=g, device="cuda").to(dtype)
    y = (torch.randn((n, d_out), generator=g, device="cuda") * 0.5).to(dtype)
    a = (torch.randn((3, 12, d_in, rank), generator=g, device="cuda")
         * 0.05).to(dtype)
    b = (torch.randn((3, 12, rank, d_out), generator=g, device="cuda")
         * 0.05).to(dtype)
    a[0] = 0
    b[0] = 0
    scale = torch.tensor([0.0, 1.0, 0.5], device="cuda")
    return y, x, a, b, scale


def _lora_idx(form, n):
    if form == "decode":
        return torch.tensor(LORA_DECODE_SLOTS, dtype=torch.int32,
                            device="cuda")
    slot = {"prefill": 2, "prefill_base": 0, "prefill_ragged": 1}[form]
    return torch.full((1,), slot, dtype=torch.int32,
                      device="cuda").expand(n)


_LORA_FIRST = []


def _first_delta():
    """The first design of the delta (commit 17bc302,
    tools/torch_lora_delta_pr15.cu: one CTA of 256 threads a row, its C
    interface without a form) as a function of the wrapper's arguments,
    counting nothing: the yardstick both forms are timed against."""
    if not _LORA_FIRST:
        fn = _TOOL_LIBS["torch_lora_delta_pr15"].paddle_lora_delta
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
            + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def delta(y, x, a, b, scale, idx, layer):
            err = fn(*(ctypes.c_void_p(t.data_ptr())
                       for t in (y, x, a, b, scale, idx)),
                     y.shape[0], a.shape[2], y.shape[1], a.shape[3], layer,
                     a.shape[1], y.stride(0), x.stride(0), idx.stride(0),
                     0 if y.dtype == torch.float32 else 1,
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            assert err == 0, err

        _LORA_FIRST.append(delta)
    return _LORA_FIRST[0]


def _check_lora_case(form, d_out, dtype, rank, layer=3, seed=None):
    """One case against the twin within `lora_delta_tol` (derived from the
    roundings both make: every element, no exception) and base rows bit
    for bit. The same arithmetic with fp64 sums (`lora_delta_exact`) is a
    second yardstick: how many elements of the kernel, the twin and the
    first design lie past the bound from it is printed. `seed` None: the
    case's own seed. Returns (max |kernel - twin|, elements past the bound
    from the fp64 sums: kernel, twin)."""
    n = LORA_ROWS[form]
    y, x, a, b, scale = _lora_state(
        n, d_out, dtype, seed=n + d_out + len(str(dtype))
        if seed is None else seed, rank=rank)
    idx = _lora_idx(form, n)
    assert ld.lora_form(idx) == ("row" if form == "decode" else "tile")
    args = (x, a, b, scale, idx, layer)
    got, want, first = y.clone(), y.clone(), y.clone()
    out = ld.lora_delta(got, *args)
    ld.lora_delta_reference(want, *args)
    # the first design has no f16 instantiation
    has_first = dtype != torch.float16
    if has_first:
        _first_delta()(first, *args)
    exact = ld.lora_delta_exact(y, *args)
    tol = ld.lora_delta_tol(y, *args)
    torch.cuda.synchronize()
    assert out is got and torch.isfinite(got.float()).all()

    def past(v, ref):
        return int(((v.float() - ref.float()).abs() > tol).sum())

    diff = (got.float() - want.float()).abs()
    over = float((diff - tol).max())
    assert over <= 0, (form, d_out, dtype, rank, seed, past(got, want), over)
    base = idx == 0
    bits = torch.int16 if y.element_size() == 2 else torch.int32
    assert torch.equal(got[base].view(bits), y[base].view(bits)), form
    if not bool(base.all()):
        assert float((got.float() - y.float())[~base].abs().max()) > 1e-3
    err = float(diff.max())
    from_exact = (past(got, exact), past(want, exact))
    print(f"  lora_delta {form} {str(dtype)[6:]} ({n}, 768 -> {d_out}) rank "
          f"{rank}{'' if seed is None else f' seed {seed}'}, "
          f"{ld.lora_form(idx)} form: within the bound of the twin "
          f"(largest |diff| - bound {over:.3e}, max_abs_err {err:.3e}); "
          f"past the bound from fp64 sums: this {from_exact[0]}, the twin "
          f"{from_exact[1]}" + (
              f", the first design {past(first, exact)}; base rows bit for "
              f"bit; vs the first design max |diff| "
              f"{float((got.float() - first.float()).abs().max()):.3e}"
              if has_first else "; base rows bit for bit"))
    return err, from_exact


def _lora_bound(idx, n, d_out, rank):
    """(bytes, bound ms, bound_by) of one delta: x read, y read and written
    for the rows whose slot is not 0 (a base row's CTAs return before they
    load them), A, B and the scale of each distinct non-zero adapter, and
    the index (one scalar when it is read with stride 0)."""
    used = sorted(set(idx.tolist()) - {0})
    nonzero = int((idx != 0).sum())
    idx_bytes = 4 * (idx.stride(0) * (n - 1) + 1)
    nbytes = 2 * (nonzero * 768 + 2 * nonzero * d_out
                  + len(used) * (768 + d_out) * rank) \
        + idx_bytes + 4 * len(used)
    flops = 2 * nonzero * (768 + d_out) * rank
    return (nbytes, *_bound_ms(nbytes, flops, torch.float32))


def _lora_ops(y, x, a, b, scale, idx, form, layer):
    """The op sequence the reference's einsums become in PyTorch, in place
    on y: the yardstick of `library_ms`."""
    if form == "decode":
        # the reference's decode form: each row gathers its factors
        sel = idx.long()
        t = torch.bmm(x[:, None, :], a[sel, layer])
        u = torch.bmm(t, b[sel, layer])[:, 0]
        y.add_(u * scale[sel].to(y.dtype)[:, None])
    else:
        # its prefill form: one slot, read on the device
        sel = idx[:1].long()
        u = (x @ a[:, layer][sel][0]) @ b[:, layer][sel][0]
        y.add_(u * scale[sel].to(y.dtype))


def _lora_f16_row(err, layer=3):
    """The f16 row: decode and prefill at the 2304 width, rank 16, timed
    beside the twin and the op sequence (`_f16_row`)."""
    rows = {}
    for form in ("decode", "prefill"):
        n = LORA_ROWS[form]
        y, x, a, b, scale = _lora_state(n, 2304, F16, seed=11)
        idx = _lora_idx(form, n)
        args = (y, x, a, b, scale, idx, layer)
        nbytes, _, _ = _lora_bound(idx, n, 2304, LORA_RANK)
        flops = 2 * int((idx != 0).sum()) * (768 + 2304) * LORA_RANK
        rows[form] = _f16_row(
            _row_name("lora_delta", F16), "lora_delta",
            "paddle_tpu_torch/csrc/lora_delta.cu",
            "no Pallas counterpart: paddle_tpu/serving/tenancy.py:526 "
            "_adapter_forward (XLA einsums)",
            lambda args=args: ld.lora_delta(*args),
            lambda args=args: ld.lora_delta_reference(*args),
            lambda args=args, form=form: _lora_ops(*args[:6], form, layer),
            nbytes, flops, err,
            f"{form} ({ld.lora_form(idx)} form): x [{n}, 768] -> y "
            f"[{n}, 2304] f16, rank {LORA_RANK}, K = 3; library_ms: the "
            f"reference's op sequence")
    row = rows["decode"]
    pre = rows["prefill"]
    row.update(prefill_ms=pre["ms"], prefill_library_ms=pre["library_ms"],
               prefill_bound_ms=pre["bound_ms"])
    return row


def check_lora_delta(dtype=torch.bfloat16):
    """The batched adapter delta (one launch a projection, in place)
    against its twin in both forms: the row form at the decode shape (8
    slots, adapters 0/1/2 mixed) and the tile form at the prefill shape
    (1024 rows of one slot, the index read with stride 0; a base-tenant
    bucket; a ragged 37-row prompt), both projections' widths, bf16 and
    fp32 (or float16 alone), ranks 16 and 4, and the timing data, within
    `lora_delta_tol` (derived from both computations' roundings) and base
    rows bit for bit (`_check_lora_case`, which prints each case's
    distance from fp64 sums and from the first design). bf16: timed
    (rank 16, both widths) in turns with the first design (commit
    17bc302, tools/torch_lora_delta_pr15.cu) and the op sequence the
    reference's einsums become in PyTorch (`_lora_ops`: gathers of A and
    B, two bmm, the scale's gather, a multiply and an add), the yardstick
    of `library_ms`; float16: `_lora_f16_row`."""
    t_check = time.perf_counter()
    err = None
    from_exact = [0, 0]
    for dt in (dtype,) if dtype == F16 else (torch.bfloat16, torch.float32):
        for rank in LORA_RANKS:
            for d_out in (2304, 768):
                for form in ("decode", "prefill", "prefill_base",
                             "prefill_ragged"):
                    e, ex = _check_lora_case(form, d_out, dt, rank)
                    from_exact = [a + b for a, b in zip(from_exact, ex)]
                    if err is None:
                        err = e
    if dtype == F16:
        return _lora_f16_row(err)
    # the timing data below (seed 11), where the earlier bound (one
    # rounding of 2^-8 a step) saw the tile form past it at 3 elements
    for form in ("decode", "prefill"):
        for d_out in (2304, 768):
            _check_lora_case(form, d_out, torch.bfloat16, LORA_RANK,
                             seed=11)
    print(f"  lora_delta: every case within lora_delta_tol of the twin; "
          f"elements past it from the fp64 sums over the cases: this "
          f"{from_exact[0]}, the twin {from_exact[1]}")
    layer = 3
    shapes = {}
    first = _first_delta()
    for d_out in (2304, 768):
        for form in ("decode", "prefill"):
            n = LORA_ROWS[form]
            y, x, a, b, scale = _lora_state(n, d_out, torch.bfloat16,
                                            seed=11)
            idx = _lora_idx(form, n)
            args = (y, x, a, b, scale, idx, layer)
            calls = {"ops": lambda args=args, form=form: _lora_ops(
                         *args[:6], form, layer),
                     "first": lambda args=args: first(*args),
                     "form": lambda args=args: ld.lora_delta(*args)}
            times = [_timed(calls[who]) for who in LORA_TURNS]

            def mean(who, times=times):
                return float(np.mean([t[0] for t, w in zip(times, LORA_TURNS)
                                      if w == who]))

            plain_ms = _cuda_ms(lambda args=args: ld.lora_delta_reference(
                *args), iters=5)
            nbytes, bound, by = _lora_bound(idx, n, d_out, LORA_RANK)
            tag = f"{form} {d_out}"
            shapes[tag] = dict(
                form=ld.lora_form(idx), ms=mean("form"),
                host_ms=times[2][1], first_ms=mean("first"),
                library_ms=mean("ops"),
                turns_ms=[round(t[0], 5) for t in times], plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, bytes=nbytes)
            row = shapes[tag]
            print(f"  lora_delta {form} ({n}, 768 -> {d_out}) bf16 rank "
                  f"{LORA_RANK}, {row['form']} form: {row['ms'] * 1e3:.2f} "
                  f"us a launch, the first design {row['first_ms'] * 1e3:.2f} "
                  f"us, op sequence {row['library_ms'] * 1e3:.2f} us, twin "
                  f"{plain_ms * 1e3:.2f} us, bound {bound * 1e3:.3f} us "
                  f"({by}); turns ({', '.join(LORA_TURNS)}) ms "
                  f"{json.dumps(row['turns_ms'])}")
    dec, pre = shapes["decode 2304"], shapes["prefill 2304"]
    print(f"  lora_delta check: {time.perf_counter() - t_check:.2f} s wall")
    return {"name": "lora_delta", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/lora_delta.cu",
            "replaces": "no Pallas counterpart: paddle_tpu/serving/"
                        "tenancy.py:526 _adapter_forward (XLA einsums)",
            "max_abs_err": err, "ms": dec["ms"], "host_ms": dec["host_ms"],
            "turns_ms": dec["turns_ms"], "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
            "library_ms": dec["library_ms"], "first_ms": dec["first_ms"],
            "prefill_ms": pre["ms"], "prefill_first_ms": pre["first_ms"],
            "prefill_library_ms": pre["library_ms"],
            "prefill_bound_ms": pre["bound_ms"],
            "by_shape": {tag: {k: v for k, v in row.items()
                               if k not in ("host_ms", "bytes")}
                         for tag, row in shapes.items()},
            "shape": f"decode (row form): 8 slots (adapters "
                     f"{LORA_DECODE_SLOTS}), x [8, 768] -> y [8, 2304] "
                     f"bf16, rank {LORA_RANK}, K = 3; prefill_* (tile "
                     f"form): {LORA_PREFILL_ROWS} rows of slot 2 (stride-0 "
                     f"index); by_shape: both widths; library_ms: the "
                     f"reference's op sequence (decode: gathers, two bmm, "
                     f"multiply, add; prefill: two matmuls, multiply, add) "
                     f"timed in turns; first_ms: the first design in the same "
                     f"turns",
            "note": "turns_ms: op sequence, the first design (commit "
                    "17bc302), this, this, the first design, op sequence"}


# ---------------------------------------------------------------------------
# phase 3b: the serving remainder's kernels: #4+ and the prompt scatter over
# pools of the other float type, the keyed draw with a row stride
# ---------------------------------------------------------------------------

# (pools, q and rows): fp32 q over bf16 pools (an fp32 model's engine with
# kv_dtype bf16), bf16 q over fp32 pools (a bf16 model's with kv_dtype fp32)
CAST_PAIRS = ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))


def _cast_tag(pool_dtype, q_dtype):
    return f"{str(q_dtype)[6:]} q over {str(pool_dtype)[6:]} pools"


def check_append_cast(pairs=CAST_PAIRS, suffix=False):
    """#4+ over pools of another float type: `_check_append_case` for
    each (pools, q) pair of `pairs` (CAST_PAIRS: both of fp32 and bf16) (pools bit for bit with the twin's cast write on every
    block but 0, block 0 untouched, the active slots' output within
    PAGED_TOL of the twin and bit-identical to the paged kernel alone on
    the twin's pools), each APPEND_REPEATS launches; then each timed at the
    serving path's shape (12 layers' pools rotating) beside its twin, the
    library yardstick (the cast write by two index_put_, then SDPA over the
    gathered pools cast to q's type) and its bound (the pools' bytes)."""
    bs, layers, rows = 16, 12, []
    eff_lens = [l if a else 0 for l, a in zip(KV_APPEND_LENS,
                                              KV_APPEND_ACTIVE)]
    for pool_dtype, q_dtype in pairs:
        err = _check_append_case(pool_dtype, q_dtype)
        q, k, v, kp, vp, _, _, tables, lens, active = _kv_append_state(
            layers, pool_dtype, q_dtype, seed=6)
        eff = torch.where(active, lens, 0)
        it = iter(range(10 ** 9))

        def rotating(fn):
            def call():
                layer = next(it) % layers
                return fn(kp[layer], vp[layer])
            return call

        def fused(kpl, vpl):
            return pa.paged_decode_append(q, k, v, kpl, vpl, tables, lens,
                                          active, bs)

        def twin(kpl, vpl):
            kva.kv_append_reference(k, v, kpl, vpl, tables, lens, active, bs)
            return pa.paged_decode_reference(q, kpl, vpl, tables, eff, bs)

        wb = torch.where(active, tables[torch.arange(8, device="cuda"),
                                        eff.long() // bs].long(), 0)
        wo = eff.long() % bs
        t_max = tables.shape[1] * bs
        mask = (torch.arange(t_max, device="cuda")[None, :]
                <= eff[:, None])[:, None, None, :]

        def library(kpl, vpl):
            kpl.index_put_((wb, wo), k.to(pool_dtype))
            vpl.index_put_((wb, wo), v.to(pool_dtype))
            kg = kpl[tables.long()].reshape(8, t_max, HEADS, HEAD_DIM) \
                .transpose(1, 2).to(q_dtype)
            vg = vpl[tables.long()].reshape(8, t_max, HEADS, HEAD_DIM) \
                .transpose(1, 2).to(q_dtype)
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None, :], kg, vg, attn_mask=mask)

        f1, host_1 = _timed(rotating(fused))
        lib_ms = _cuda_ms(rotating(library))
        f2, host_2 = _timed(rotating(fused))
        plain_ms = _cuda_ms(rotating(twin))
        p_elem = torch.empty((), dtype=pool_dtype).element_size()
        q_elem = torch.empty((), dtype=q_dtype).element_size()
        paged_b = _paged_work(eff_lens, q, tables, False, elem=p_elem)
        append_b = _kv_append_work(False, (p_elem + q_elem) / 2)
        bound, by = _bound_ms(paged_b[0] + append_b[0],
                              paged_b[1] + append_b[1], torch.float32)
        counter = pa.append_name(q_dtype, pool_dtype)
        name = _row_name(counter, q_dtype) if suffix else counter
        ms = (f1 + f2) / 2
        print(f"  {name} ({_cast_tag(pool_dtype, q_dtype)}) at the serving "
              f"shape: {f1:.5f} / {f2:.5f} ms (two runs), library "
              f"yardstick {lib_ms:.5f} ms, twin {plain_ms:.5f} ms, bound "
              f"{bound:.5f} ms ({by})")
        rows.append({
            "name": name, "counter": counter, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": "paddle_tpu/kernels/pallas/paged_attention.py:167 "
                        "_decode_kernel over pools of another float type, "
                        "with the decode write before it, paddle_tpu/nn/"
                        "functional/attention.py:268-271 .astype(k_pool."
                        "dtype) (XLA ops, no Pallas kernel)",
            "max_abs_err": err, "ms": ms, "host_ms": (host_1 + host_2) / 2,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms, "turns_ms": [f1, f2],
            "shape": (f"S=8 H=12 D=64 bs=16 M=64, 513 blocks, lens "
                      f"{KV_APPEND_LENS}, active {KV_APPEND_ACTIVE}, "
                      f"{_cast_tag(pool_dtype, q_dtype)}; library_ms: two "
                      f"index_put_ of the cast rows, a gather cast to q's "
                      f"type and SDPA")})
    return rows


def check_scatter_cast(pairs=CAST_PAIRS, suffix=False):
    """The prompt scatter into pools of another float type, each (pools,
    rows) pair of `pairs`,
    bit for bit with the twin's cast (`_check_scatter_case`) on every block
    but 0 at buckets 128 and 1024; then each timed at a full 1024-token
    bucket beside its twin and the library yardstick (two index_put_ a
    layer of the cast rows)."""
    bs, rows, tags = 16, [], []
    for pool_dtype, row_dtype in pairs:
        for bucket, lengths in SCATTER_CASES[1:]:
            for length in lengths:
                tags.append(_check_scatter_case(bucket, length, row_dtype,
                                                False,
                                                pool_dtype=pool_dtype))
        bucket = length = 1024
        k, v, pools, _, row = _scatter_state(bucket, row_dtype, False,
                                             seed=7, pool_dtype=pool_dtype)
        n = torch.full((), length, dtype=torch.int32, device="cuda")
        args = (*pools, k, v, row, n, bs)
        t1, host_1 = _timed(lambda: ps.prefill_scatter(*args))
        pos = torch.arange(length, device="cuda")
        blocks, offs = row.long()[pos // bs], pos % bs

        def library():
            for layer in range(SCATTER_LAYERS):
                pools[0][layer].index_put_((blocks, offs),
                                           k[layer].to(pool_dtype))
                pools[1][layer].index_put_((blocks, offs),
                                           v[layer].to(pool_dtype))

        lib_ms = _cuda_ms(library)
        t2, host_2 = _timed(lambda: ps.prefill_scatter(*args))
        plain_ms = _cuda_ms(lambda: ps.prefill_scatter_reference(*args),
                            iters=5)
        nbytes = ps.scatter_bytes(
            length, SCATTER_LAYERS, HEADS, HEAD_DIM,
            torch.empty((), dtype=row_dtype).element_size(), False,
            int((row != 0).sum()),
            pool_elem=torch.empty((), dtype=pool_dtype).element_size())
        bound, by = _bound_ms(nbytes, 0, torch.float32)
        counter = ps.scatter_name(row_dtype, pool_dtype)
        name = _row_name(counter, row_dtype) if suffix else counter
        print(f"  {name} ({str(row_dtype)[6:]} rows into "
              f"{str(pool_dtype)[6:]} pools), bucket 1024: {t1:.5f} / "
              f"{t2:.5f} ms (two runs), library yardstick {lib_ms:.5f} ms, "
              f"twin {plain_ms:.5f} ms, bound {bound:.5f} ms ({by})")
        rows.append({
            "name": name, "counter": counter, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/prefill_scatter.cu",
            "replaces": "no Pallas counterpart: paddle_tpu/serving/cache.py"
                        ":279-281 scatter_prefill's .astype(k_pools.dtype) "
                        "(XLA ops)",
            "max_abs_err": 0.0, "ms": (t1 + t2) / 2,
            "host_ms": (host_1 + host_2) / 2, "turns_ms": [t1, t2],
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms, "bytes": nbytes,
            "shape": (f"12 layers of {str(row_dtype)[6:]} rows [1024, 12, "
                      f"64] (strided views of [1024, 3, 12, 64]) into "
                      f"{str(pool_dtype)[6:]} pools, length 1024, bs=16, a "
                      f"block row of 64; library_ms: two index_put_ a layer "
                      f"of the cast rows")})
    print(f"  prefill_scatter cast: {len(tags)} cases bit-identical to the "
          f"twin on blocks 1.. and block 0 untouched ((pools, rows) "
          f"{[(str(a)[6:], str(b)[6:]) for a, b in pairs]}, buckets 128 and "
          f"1024)")
    return rows


# generate's draw: its batch of 8 rows, the padded vocabulary, one key
GEN_B, GEN_P, GEN_N = 8, 128, 64
KEYED_ROW_ROUNDS = 3


def check_keyed_draw_rows():
    """The keyed draw with a row stride (`generate`'s: every row under one
    key, row b at counters b V + v) against its twin on the CPU: each
    round's bits and noise bit for bit (the debug launch), and the tokens
    of the debug and the plain launch, at GEN_B rows of V = 50304; then
    timed with every row sampled, its bound the bytes of the rows and
    threefry's INT32 instructions at every index."""
    s, v = GEN_B, 50304
    noise_err = 0.0
    for r in range(KEYED_ROW_ROUNDS):
        raw, filtered, _, seeds, pos = _keyed_state(s, v, 900 + r, range(s))
        seeds.fill_(int(seeds[0]))
        pos.fill_(r + 1)
        temps = torch.ones(s, device="cuda")
        bits = torch.empty((s, v), dtype=torch.int32, device="cuda")
        noise = torch.empty((s, v), device="cuda")
        debug = kd.keyed_draw(filtered, filtered, temps, seeds, pos,
                              debug=(bits, noise), row_stride=v)
        out = kd.keyed_draw(filtered, filtered, temps, seeds, pos,
                            row_stride=v)
        torch.cuda.synchronize()
        cpu = [t.cpu() for t in (filtered, filtered, temps, seeds, pos)]
        k0, k1 = kd.slot_keys(cpu[3], cpu[4])
        want_bits = kd.random_bits(k0, k1, v, row_stride=v).to(torch.int32)
        assert torch.equal(bits.cpu(), want_bits), f"round {r}: bits differ"
        want_noise = -kd.xla_log(-kd.xla_log(kd.uniform(
            want_bits.to(torch.int64) & 0xFFFFFFFF)))
        assert torch.equal(noise.cpu().view(torch.int32),
                           want_noise.view(torch.int32)), \
            f"round {r}: noise differs"
        noise_err = max(noise_err,
                        (noise.cpu() - want_noise).abs().max().item())
        want = kd.keyed_draw_reference(*cpu, row_stride=v)
        for name, got in (("debug", debug), ("plain", out)):
            assert torch.equal(got.cpu(), want), (r, name, got.tolist(),
                                                  want.tolist())
    raw, filtered, _, seeds, pos = _keyed_state(s, v, 7, range(s))
    temps = torch.ones(s, device="cuda")
    args = (filtered, filtered, temps, seeds, pos)
    t1, host_1 = _timed(lambda: kd.keyed_draw(*args, row_stride=v))
    t2, host_2 = _timed(lambda: kd.keyed_draw(*args, row_stride=v))
    cpu = [t.cpu() for t in args]
    t0 = time.perf_counter()
    kd.keyed_draw_reference(*cpu, row_stride=v)
    plain_ms = (time.perf_counter() - t0) * 1e3
    int_rate = _int32_ops_per_s()
    t_bytes = s * v * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = s * v * THREEFRY_INT_OPS / int_rate * 1e3
    bound, by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")
    print(f"  keyed_draw_rows S={s} V={v} row_stride {v}: "
          f"{KEYED_ROW_ROUNDS} rounds of bits, noise and tokens "
          f"bit-identical to the twin; {t1:.5f} / {t2:.5f} ms (two runs, "
          f"all rows sampled), bound {bound:.5f} ms ({by}); twin on the CPU "
          f"{plain_ms:.1f} ms")
    return {"name": "keyed_draw_rows", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/keyed_draw.cu",
            "replaces": "no Pallas counterpart: generate's draw, "
                        "paddle_tpu/incubate/models/gpt.py:462-463 "
                        "jax.random.categorical(fold_in(key, i), [B, V]) "
                        "(XLA ops)",
            "max_abs_err": noise_err, "ms": (t1 + t2) / 2,
            "host_ms": (host_1 + host_2) / 2, "turns_ms": [t1, t2],
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "bytes_bound_ms": t_bytes,
            "int32_bound_ms": t_ops,
            "shape": f"S={s} rows of V={v} fp32 logits under one key "
                     f"(row_stride {v}), every row sampled",
            "note": "plain_ms is the twin's host time on the CPU; the same "
                    "kernel as keyed_draw, launched with a row stride"}


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


def serve(kv_dtype=None, dtype=torch.bfloat16, prefill_turns=True):
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
    tag = ("serve_int8" if kv_dtype else "serve") + (
        "" if dtype == torch.bfloat16 else f"_{SHORT_NAMES[dtype]}")
    paged, other = (("paged_decode_append_int8", "paged_decode_append")
                    if kv_dtype else ("paged_decode_append",
                                      "paged_decode_append_int8"))
    scatter, other_scatter = (("prefill_scatter_int8", "prefill_scatter")
                              if kv_dtype else ("prefill_scatter",
                                                "prefill_scatter_int8"))
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device="cuda", seed=0).to(dtype)
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
        assert st["kv_dtype"] == ("int8" if kv_dtype
                                  else str(dtype)[6:]), st
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
    SERVE_STATS[tag] = passes["warm"][1]
    _graph_vs_eager(tag, model, engine, kv_dtype, rng)
    if prefill_turns:
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
    groups = None
    for _ in range(2):
        # now and then the profiler hands back no device activity for a
        # window of these few short kernels; then the same window again
        groups = _breakdown(f"{tag} sampler alone",
                            lambda: [sampler() for _ in range(4)], per=4)
        if groups is not None:
            break
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


def serve_int8(bf16_greedy, dtype=torch.bfloat16, prefill_turns=True):
    """`serve` over int8 pools under a model of `dtype` (bf16 or f16):
    greedy agreement with the model's own pools' run (reported), and at
    the bytes of its own default pool the int8 pool admits at least
    INT8_CAPACITY_MIN times its streams."""
    counts, greedy, model = serve(kv_dtype="int8", dtype=dtype,
                                  prefill_turns=prefill_turns)
    tag = "serve_int8" + ("" if dtype == torch.bfloat16
                          else f"_{SHORT_NAMES[dtype]}")
    same = sum(a == b for ga, gb in zip(greedy, bf16_greedy)
               for a, b in zip(ga, gb))
    total = sum(len(g) for g in greedy)
    whole = sum(ga == gb for ga, gb in zip(greedy, bf16_greedy))
    print(f"{tag}: greedy tokens equal to the {str(dtype)[6:]} pools' run's "
          f"at {same}/{total} positions ({same / total:.4f}); {whole}/"
          f"{len(greedy)} streams identical throughout (reported, not held)")
    cfg = model.config
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    geom = (cfg.num_hidden_layers, cfg.num_attention_heads, head_dim, 16)
    # the model's own engine's pool: its default 1 + 8 slots x 64 blocks
    nb_bf16 = 1 + 8 * 64
    pool_bytes = nb_bf16 * pool_bytes_per_block(*geom, dtype)
    nb_int8 = num_blocks_for_bytes(pool_bytes, *geom, torch.int8)
    n_bf16 = _admitted(model, None, nb_bf16)
    n_int8 = _admitted(model, "int8", nb_int8)
    print(f"{tag}: at {pool_bytes} pool bytes the {str(dtype)[6:]} pool "
          f"holds {nb_bf16} blocks and admits {n_bf16} streams of 512 "
          f"tokens, the int8 pool {nb_int8} blocks and {n_int8} streams "
          f"({n_int8 / n_bf16:.3f}x; at least {INT8_CAPACITY_MIN}x)")
    assert n_int8 >= INT8_CAPACITY_MIN * n_bf16, (n_int8, n_bf16)
    return counts


# ---------------------------------------------------------------------------
# phase 4d: multi-tenant serving at full width
# ---------------------------------------------------------------------------

TENANT_PREFIX = 512        # the shared system prompt: 32 aligned blocks
TENANT_NEW = 24
TENANT_CUT = 6             # decode steps before the mid-run hot-swap
TENANT_ENGINE = dict(max_batch_size=8, block_size=16, max_context=1024)
TENANTS = (None, "a", "b")
TENANT_SAMPLED = {3: 0, 10: 1}     # request -> seed of the sampled ones
TENANT_SAMPLER = dict(temperature=0.8, top_k=40, top_p=0.95,
                      repetition_penalty=1.3)


def _tenant_mix(rng):
    """``[(prompt, add_request kwargs)]``: 16 requests sharing a 512-token
    system prompt with distinct 4-24-token tails, then two with one
    identical 300-token prompt of their own, both on adapter a (the first
    misses and publishes its blocks, tail included; the second is a full
    alias, a hit of len - 1 tokens, and both then write inside the shared
    tail block); the first 16 rotate tenants base, a, b (the prefix index
    is per adapter: each tenant's first request misses); requests 3 and 10
    sample (temperature 0.8, top-k 40, top-p 0.95, repetition penalty
    1.3), the rest are greedy."""
    system = rng.integers(0, 50257, TENANT_PREFIX).tolist()
    tails = [rng.integers(0, 50257, int(n)).tolist()
             for n in rng.integers(4, 25, 16)]
    alias = rng.integers(0, 50257, 300).tolist()
    prompts = [system + t for t in tails] + [alias, list(alias)]
    mix = []
    for i, p in enumerate(prompts):
        kw = dict(adapter=TENANTS[i % 3] if i < 16 else "a")
        if i in TENANT_SAMPLED:
            kw.update(TENANT_SAMPLER, seed=TENANT_SAMPLED[i])
        mix.append((list(p), kw))
    return mix


def _tenant_engine(model, warm, kv_dtype=None, adapters=True, prefix=True,
                   hot_swap=True, pipelined=False, logprobs_topk=0):
    """An engine with the phase's tenancy options (adapters "a" and "b"
    registered from seeds 1 and 2, scale 4), its decode graph and the
    buckets the mix reaches (512, 1024) built by warm-up requests of
    `warm` outside any counted window, so a miss's TTFT holds no build.
    The top-2
    logprobs (``logprobs_topk=2``) give a cold run's margins; they change
    no token and no chosen logprob."""
    engine = LLMEngine(model, kv_dtype=kv_dtype, pipeline_decode=pipelined,
                       logprobs_topk=logprobs_topk,
                       enable_prefix_cache=prefix,
                       max_adapters=2 if adapters else 0,
                       adapter_rank=LORA_RANK, hot_swap=hot_swap,
                       **TENANT_ENGINE)
    if adapters:
        # scale 4: the delta's rows are then about twice the projections'
        # (factors of std 0.05 against weights of std 0.02), so it bites
        engine.register_adapter("a", seed=1, scale=4.0)
        engine.register_adapter("b", seed=2, scale=4.0)
    engine.generate(warm, max_new_tokens=2)
    return engine


def _tenant_window(engine, mix):
    """The mix through `engine` from zeroed counts and stats (requests of
    an adapter tenant go to an engine without adapters as base ones):
    returns the requests, the launch counts, the stats and the wall
    time."""
    engine.reset_stats()
    reset_launch_counts()
    has_adapters = engine._adapters is not None
    t0 = time.perf_counter()
    reqs = [engine.add_request(
        p, max_new_tokens=TENANT_NEW,
        **{k: v for k, v in kw.items() if k != "adapter" or has_adapters})
        for p, kw in mix]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert all(r.state == "FINISHED" and len(r.generated) == TENANT_NEW
               for r in reqs), [(r.rid, r.state) for r in reqs]
    return reqs, launch_counts(), engine.stats(), wall


def _streams(reqs, which=None):
    return [(list(r.generated), list(r.token_logprobs))
            for i, r in enumerate(reqs) if which is None or i in which]


def _first_difference(got, cold):
    """Position of the first differing greedy token between two runs of
    one stream, with the cold run's top-two logprob (= logit) margin
    there; None when the streams agree."""
    for pos, (a, b) in enumerate(zip(got.generated, cold.generated)):
        if a != b:
            top = cold.alt_logprobs[pos]
            return pos, top[0] - top[1]
    return None


def _tenant_ttft(reqs):
    """TTFT p50 in ms of prefix hits and misses, from enqueue and from
    admission (a hit's first token comes after its chew steps)."""
    out = {}
    for name, group in (("hit", [r for r in reqs if r.prefix_hit]),
                        ("miss", [r for r in reqs if not r.prefix_hit])):
        out[name] = dict(
            n=len(group),
            from_enqueue=float(np.median([(r.first_token_ns - r.enqueue_ns)
                                          / 1e6 for r in group])),
            from_admission=float(np.median([(r.first_token_ns - r.admit_ns)
                                            / 1e6 for r in group])))
    return out


def serve_tenancy():
    """Multi-tenant serving at full width: GPT-2 124M (random weights from
    seed 0, bf16) behind `LLMEngine(max_batch_size=8, block_size=16,
    max_context=1024, enable_prefix_cache=True, max_adapters=2,
    adapter_rank=16, hot_swap=True)` on `_tenant_mix`, unpipelined (the
    counted window), pipelined and with int8 pools, then in fp32.
    Holds: base tenants bit for bit (tokens and logprobs) with an engine
    without adapters (prefix cache on, the same hits) and, with the prefix
    cache off on both, with an engine built with no tenancy options;
    adapter streams equal across the unpipelined and pipelined runs and
    different from the base stream of their prompt; prefills equal to the
    prefix misses, hit tokens, copy-on-write copies >= 1, no decode or
    bucket rebuild; `lora_delta` launched 24 times a decode replay and a
    prefill; fp32 greedy streams equal to the
    same engine with the prefix cache off; a mid-run hot-swap whose
    tokens before the cut are the old weights' and after it those of an
    engine on the new weights continuing from prompt + old tokens, the
    parameters' storage kept, the continuation on a fresh engine built on
    the new model. Reports bf16 prefix-vs-cold agreement, TTFT
    of hits and misses, a replayed decode step with adapters armed
    against one without, the copy-on-write copy's time and the swap's host
    time. Returns the counted window's launch counts."""
    tag = "serve_tenancy"
    t_phase = time.perf_counter()
    laps = {}     # part -> its wall seconds

    def lap(name):
        laps[name] = time.perf_counter() - t_phase - sum(laps.values())

    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    layers = cfg.num_hidden_layers
    model = GPTForCausalLM(cfg, device="cuda", seed=0).to(torch.bfloat16)
    rng = np.random.default_rng(3)
    mix = _tenant_mix(rng)
    warm = [rng.integers(0, 50257, n).tolist() for n in (400, 600)]
    base_ix = {i for i, (_, kw) in enumerate(mix) if kw["adapter"] is None}
    adapter_ix = set(range(len(mix))) - base_ix
    greedy_ix = set(range(len(mix))) - set(TENANT_SAMPLED)
    ptrs = [p.data_ptr() for p in model.parameters()]

    # -- the counted window: the tenancy engine, unpipelined, bf16 ---------
    tenant = _tenant_engine(model, warm)
    stacks = tenant._adapters
    stack_ptrs = [t.data_ptr() for t in (*stacks.a.values(),
                                         *stacks.b.values(), stacks.scale)]
    reqs, counts, st, wall = _tenant_window(tenant, mix)
    misses = sum(not r.prefix_hit for r in reqs)
    assert st["decode_compiles"] == st["prefill_compiles"] == 0, st
    assert st["evictions"] == 0, st
    assert st["prefills"] == misses and 0 < misses < len(mix), (st, misses)
    assert st["prefix_hit_tokens"] > 0 and st["cow_copies"] >= 1, st
    assert reqs[-1].prefix_hit == len(mix[-1][0]) - 1, reqs[-1].prefix_hit
    assert st["adapter_switches"] >= 2, st
    # one delta launch a projection (2 a layer) in every decode replay and
    # prefill replay
    assert counts["lora_delta"] == 2 * layers * (
        st["steps"] + st["prefills"]), (counts, st)
    assert counts["paged_decode_append"] == layers * st["steps"], counts
    assert counts["prefill_scatter"] == st["prefills"], counts
    assert counts["keyed_draw"] == st["steps"] + st["prefills"], counts
    ttft = _tenant_ttft(reqs)
    print(f"{tag}: {len(reqs)} requests ({len(adapter_ix)} on adapters a/b, "
          f"2 sampled), {st['tokens_generated']} tokens in {wall:.3f} s; "
          f"{st['prefills']} prefills = {misses} prefix misses, "
          f"{st['admitted'] - st['prefills']} prefix hits, "
          f"prefix_hit_tokens {st['prefix_hit_tokens']} (hit rate "
          f"{st['prefix_hit_rate']:.4f}), cow_copies {st['cow_copies']}, "
          f"prefix_evictions {st['prefix_evictions']}, adapter_switches "
          f"{st['adapter_switches']}, {st['steps']} decode steps (no decode "
          f"or bucket build in the window: the warm-up built them), step "
          f"p50 {st['p50_step_ms']:.3f} ms; lora_delta launches "
          f"{counts['lora_delta']} = 24 x (steps + prefills)")
    print(f"{tag}: TTFT p50 ms (host clock; enqueue -> first token, and "
          f"admission -> first token, a hit's chew steps included): "
          + json.dumps({k: {kk: (round(vv, 3) if isinstance(vv, float)
                                 else vv) for kk, vv in v.items()}
                        for k, v in ttft.items()}))
    print(f"{tag}: launches {json.dumps(counts)}")
    lap("counted window")

    # -- base tenants bit for bit against engines without adapters --------
    prefix_only = _tenant_engine(model, warm, adapters=False,
                                 hot_swap=False)
    p_reqs, _, _, _ = _tenant_window(prefix_only, mix)
    assert [p_reqs[i].prefix_hit for i in base_ix] == \
        [reqs[i].prefix_hit for i in base_ix]
    assert _streams(reqs, base_ix) == _streams(p_reqs, base_ix), \
        "base tenants differ from the adapter-free engine's"
    differ = [reqs[i].generated != p_reqs[i].generated
              for i in sorted(adapter_ix)]
    assert all(differ), [i for i, d in zip(sorted(adapter_ix), differ) if not d]
    no_prefix = _tenant_engine(model, warm, prefix=False, logprobs_topk=2)
    a_reqs, _, _, _ = _tenant_window(no_prefix, mix)
    plain = _tenant_engine(model, warm, adapters=False, prefix=False,
                           hot_swap=False)
    n_reqs, _, _, _ = _tenant_window(plain, mix)
    assert _streams(a_reqs, base_ix) == _streams(n_reqs, base_ix), \
        "base tenants differ from the engine with no tenancy options"
    print(f"{tag}: {len(base_ix)} base-tenant streams bit for bit (tokens "
          f"and logprobs) with an engine without adapters (prefix cache on, "
          f"the same hits) and, prefix cache off on both, with an engine "
          f"built with no tenancy options; all {len(adapter_ix)} adapter "
          f"streams differ from their prompt's base stream")
    # bf16 prefix hits against cold prefills (reported, not held)
    first = [(i, _first_difference(reqs[i], a_reqs[i]))
             for i in sorted(greedy_ix)
             if reqs[i].generated != a_reqs[i].generated]
    print(f"{tag}: bf16 prefix cache on vs off (same adapters): "
          f"{len(greedy_ix) - len(first)}/{len(greedy_ix)} greedy streams "
          f"identical; first "
          f"differences (request, (position, cold run's top-two logprob "
          f"margin there)): {json.dumps(first[:6])} (reported, not held)")
    lap("base tenants")

    # -- the same engine pipelined: every stream equal -------------------
    piped = _tenant_engine(model, warm, pipelined=True)
    q_reqs, _, q_st, _ = _tenant_window(piped, mix)
    assert _streams(q_reqs) == _streams(reqs), "pipelined streams differ"
    assert {k: q_st[k] for k in ("prefills", "prefix_hit_tokens",
                                 "cow_copies")} == \
        {k: st[k] for k in ("prefills", "prefix_hit_tokens", "cow_copies")}
    print(f"{tag} (pipelined): all {len(reqs)} streams (adapter ones "
          f"included) equal to the unpipelined run's, tokens and logprobs; "
          f"step p50 {q_st['p50_step_ms']:.3f} ms, {q_st['commit_rollbacks']} "
          f"rollbacks")
    lap("pipelined")

    # -- int8 pools ------------------------------------------------------
    quant = _tenant_engine(model, warm, kv_dtype="int8")
    i_reqs, i_counts, i_st, _ = _tenant_window(quant, mix)
    assert i_st["prefills"] == sum(not r.prefix_hit for r in i_reqs), i_st
    assert i_st["cow_copies"] >= 1 and i_st["decode_compiles"] == 0, i_st
    assert i_counts["paged_decode_append_int8"] == layers * i_st["steps"]
    agree = sum(a == b for ra, rb in zip(i_reqs, reqs)
                for a, b in zip(ra.generated, rb.generated))
    print(f"{tag} (int8 pools): prefills {i_st['prefills']}, "
          f"prefix_hit_tokens {i_st['prefix_hit_tokens']}, cow_copies "
          f"{i_st['cow_copies']}; tokens equal to the bf16 run's at "
          f"{agree}/{len(reqs) * TENANT_NEW} positions (reported)")
    lap("int8 pools")

    # -- the copy-on-write copy's time, on free blocks --------------------
    cow = {}
    for name, engine in (("bf16", plain), ("int8", quant)):
        free = list(engine.cache.allocator._free)[:2]
        cow[name] = _cuda_ms(lambda e=engine, f=free: e._copy_block(*f))
    print(f"{tag}: copy-on-write block copy, 12 layers (bf16: K and V, "
          f"2 copies; int8: K, V and the scale rows, 4 copies), device ms: "
          + json.dumps({k: round(v, 5) for k, v in cow.items()}))

    # -- a replayed decode step, adapters armed vs none ------------------
    replay = {}
    for name, engine in (("adapters armed", tenant), ("no tenancy", plain)):
        rr = [engine.add_request(
            rng.integers(0, 50257, 200).tolist(), max_new_tokens=32,
            **({"adapter": TENANTS[i % 3]} if engine._adapters else {}))
            for i in range(8)]
        for _ in range(5):
            engine.step()
        replay[name] = _whole_trace(
            f"{tag} decode replay ({name})",
            lambda e=engine: [e.step() for _ in range(4)], per=4)
        engine.run()
        assert all(r.state == "FINISHED" for r in rr)
    if replay["no tenancy"].get("device_ms"):
        # one delta launch more a projection with adapters armed (the
        # profiler files an event under kernels or copies by its name, and
        # one moved between them across processes: their sum is held)
        armed, none = (replay[k]["kernels"] + replay[k]["copies"]
                       for k in ("adapters armed", "no tenancy"))
        assert round(armed) == round(none) + 2 * layers, replay
    print(f"{tag}: replayed greedy decode step, 8 slots: "
          + json.dumps({k: {kk: round(v[kk], 4) for kk in
                            ("kernels", "copies", "device_ms")}
                        for k, v in replay.items()}))
    lap("copy and replay")

    # -- mid-run hot-swap on the tenancy engine --------------------------
    swap_prompts = [rng.integers(0, 50257, n).tolist() for n in (40, 70)]
    old = [prefix_only.add_request(p, max_new_tokens=TENANT_NEW)
           for p in swap_prompts]
    prefix_only.run()
    new_model = GPTForCausalLM(cfg, device="cuda", seed=1).to(torch.bfloat16)
    values = [p.detach() for p in new_model.parameters()]
    tenant.reset_stats()
    programs = (tenant._decode_program, dict(tenant._prefill_fns))
    live = [tenant.add_request(p, max_new_tokens=TENANT_NEW)
            for p in swap_prompts]
    for _ in range(TENANT_CUT):
        tenant.step()
    marks = [len(r.generated) for r in live]
    assert all(0 < k < TENANT_NEW for k in marks), marks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch = tenant.swap_weights(values)
    torch.cuda.synchronize()
    swap_ms = (time.perf_counter() - t0) * 1e3
    tenant.run()
    s_st = tenant.stats()
    assert epoch == tenant.weight_epoch == s_st["weight_epoch"] == 1
    assert s_st["evictions"] == 0 and s_st["decode_compiles"] == 0, s_st
    assert s_st["weight_swaps"] == 1, s_st
    assert tenant._decode_program is programs[0]
    assert all(tenant._prefill_fns[b] is fn for b, fn in programs[1].items())
    assert [p.data_ptr() for p in model.parameters()] == ptrs
    assert all(torch.equal(p, v) for p, v in zip(model.parameters(), values))
    assert [t.data_ptr() for t in (*stacks.a.values(), *stacks.b.values(),
                                   stacks.scale)] == stack_ptrs
    # the tokens after the cut against a fresh engine with no tenancy
    # options on the new model itself: its graphs are captured on the new
    # weights in their own storage, so whatever the swapped engine's graphs
    # serve is held against an independent capture
    fresh = LLMEngine(new_model, **TENANT_ENGINE)
    cont = [fresh.add_request(p + o.generated[:k],
                              max_new_tokens=TENANT_NEW - k)
            for p, o, k in zip(swap_prompts, old, marks)]
    fresh.run()
    for r, o, c, k in zip(live, old, cont, marks):
        assert r.generated[:k] == o.generated[:k], "tokens before the cut"
        assert r.generated[k:] == c.generated, "tokens after the cut"
        assert r.preemptions >= 1
    del fresh, new_model, values
    print(f"{tag}: hot-swap after {TENANT_CUT} steps ({marks} tokens "
          f"out): tokens before the cut equal the old weights' stream, "
          f"after it a fresh engine on the new model (its own graphs and "
          f"storage) continuing from prompt + old tokens; weight_epoch 1, "
          f"0 evictions, no "
          f"decode or bucket rebuild, parameters' data_ptr unchanged; "
          f"swap_weights host time {swap_ms:.3f} ms (CRC of the new set, "
          f"staging on the card, preempting 2 streams, copying "
          f"{sum(p.numel() for p in model.parameters())} parameters)")
    lap("hot-swap")

    # -- fp32: prefix hits hold the cold path's greedy tokens exactly -----
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    del tenant, prefix_only, no_prefix, plain, piped, quant, model
    fp32 = GPTForCausalLM(cfg, device="cuda", seed=0)
    f_reqs, _, f_st, _ = _tenant_window(_tenant_engine(fp32, warm), mix)
    g_reqs, _, _, _ = _tenant_window(_tenant_engine(fp32, warm, prefix=False,
                                                    logprobs_topk=2), mix)
    assert f_st["prefix_hit_tokens"] > 0 and f_st["cow_copies"] >= 1
    for i in sorted(greedy_ix):
        assert f_reqs[i].generated == g_reqs[i].generated, (
            i, _first_difference(f_reqs[i], g_reqs[i]))
    sampled_same = sum(f_reqs[i].generated == g_reqs[i].generated
                       for i in TENANT_SAMPLED)
    print(f"{tag} (fp32): all {len(greedy_ix)} greedy streams (adapter "
          f"ones included) equal to the same engine with the prefix cache "
          f"off ({f_st['prefix_hit_tokens']} hit tokens, "
          f"{f_st['cow_copies']} copies); sampled streams equal "
          f"{sampled_same}/{len(TENANT_SAMPLED)} (reported)")
    lap("fp32")
    print(f"{tag}: phase wall time {time.perf_counter() - t_phase:.2f} s, "
          f"by part (s): "
          f"{json.dumps({k: round(v, 2) for k, v in laps.items()})}")
    return counts


# ---------------------------------------------------------------------------
# phase 4e: the serving remainder at full width: pools of the other float
# type, generate, the watchdog's ladder and the eager fallback, crash-resume
# ---------------------------------------------------------------------------

# (model dtype, pools' dtype) of the mixed-pool serve runs
KV_MIXED = ((torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32))


def _gpt(dtype, seed=0):
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return GPTForCausalLM(cfg, device="cuda", seed=seed).to(dtype)


def _agreement(got, want):
    """(equal positions, positions, identical streams) of two lists of
    token streams."""
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    return (same, sum(len(w) for w in want),
            sum(g == w for g, w in zip(got, want)))


def serve_kv_mixed(pairs=KV_MIXED, keys=None, parities=True):
    """The serve mix on GPT-2 124M with pools of the other float type: an
    fp32 model over bf16 pools and a bf16 model over fp32 pools. Every
    decode replay runs the cast instantiation of #4+ once a layer and
    every prefill the cast scatter once; the same mix on an engine with
    the model's own pools gives the step p50 beside it and the streams'
    agreement (printed); at the bytes of the default same-dtype pool the
    bf16 pools hold twice the blocks and admit more streams, the fp32 pools
    half. The fp32 model's greedy tokens are held card against CPU by
    `parity(kv_dtype=bfloat16)`, the bf16 model's compared there and
    reported. `pairs`: (model, pools) dtypes (KV_MIXED by default);
    `keys`: each pair's path name (serve_kv_mixed_<pools> by default);
    `parities`: run those card-vs-CPU checks. Returns the launch counts of
    each mixed run, by path."""
    paths = {}
    rng = np.random.default_rng(0)
    mix = _serve_mix(rng)
    for model_dtype, kv in pairs:
        tag = (f"serve_kv_mixed ({str(model_dtype)[6:]} model, "
               f"{str(kv)[6:]} pools)")
        model = _gpt(model_dtype)
        cfg = model.config
        layers = cfg.num_hidden_layers
        engines = {}
        for name, kv_dtype in (("mixed", kv), ("same", None)):
            engine = LLMEngine(model, max_batch_size=8, block_size=16,
                               max_context=1024, kv_dtype=kv_dtype)
            engine.generate([rng.integers(0, 50257, 20).tolist()],
                            max_new_tokens=2)
            engines[name] = (engine, *_serve_window(engine, mix))
        engine, reqs, counts, st, heads, prefills, wall = engines["mixed"]
        fused = pa.append_name(model_dtype, kv)
        scatter = ps.scatter_name(model_dtype, kv)
        builds = st["prefill_compiles"]
        assert all(r.state == "FINISHED" and len(r.generated) == 24
                   for r in reqs), [(r.rid, r.state) for r in reqs]
        assert st["kv_dtype"] == str(kv)[6:], st
        assert engine.cache.k_pools.dtype == kv
        assert counts[fused] == layers * st["steps"] > 0, (counts, st)
        for other in ("paged_decode_append", "paged_decode_append_int8",
                      "paged_decode", "prefill_scatter"):
            assert counts[other] == 0, counts
        assert counts[scatter] == st["prefills"] + builds > 0, (counts, st)
        assert counts["keyed_draw"] == st["steps"] + st["prefills"], counts
        same = engines["same"]
        greedy = [list(r.generated) for r in reqs if r.temperature == 0]
        greedy_same = [list(r.generated) for r in same[1]
                       if r.temperature == 0]
        eq, total, whole = _agreement(greedy, greedy_same)
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        geom = (layers, cfg.num_attention_heads, head_dim, 16)
        nb_same = 1 + 8 * 64
        pool_bytes = nb_same * pool_bytes_per_block(*geom, model_dtype)
        nb_mixed = num_blocks_for_bytes(pool_bytes, *geom, kv)
        m_elem = torch.empty((), dtype=model_dtype).element_size()
        kv_elem = torch.empty((), dtype=kv).element_size()
        expect = nb_same * m_elem // kv_elem
        assert nb_mixed == expect, (nb_mixed, nb_same)
        n_same = _admitted(model, None, nb_same)
        n_mixed = _admitted(model, kv, nb_mixed)
        if kv_elem < m_elem:
            assert n_mixed >= 1.8 * n_same, (n_mixed, n_same)
        elif kv_elem > m_elem:
            assert n_mixed < n_same, (n_mixed, n_same)
        else:
            assert n_mixed == n_same, (n_mixed, n_same)
        print(f"{tag}: {len(reqs)} requests, {st['tokens_generated']} tokens "
              f"in {wall:.3f} s; {st['steps']} decode steps, p50 "
              f"{st['p50_step_ms']:.3f} ms, p99 {st['p99_step_ms']:.3f} ms "
              f"(the model's own pools: p50 {same[3]['p50_step_ms']:.3f} "
              f"ms, p99 {same[3]['p99_step_ms']:.3f} ms); {fused} launches "
              f"{counts[fused]} = 12 x steps, {scatter} launches "
              f"{counts[scatter]} = prefills + builds; greedy tokens equal "
              f"to the model's own pools' run at {eq}/{total} positions, "
              f"{whole}/{len(greedy)} streams identical (reported); at "
              f"{pool_bytes} pool bytes the {str(kv)[6:]} pools hold "
              f"{nb_mixed} blocks and admit {n_mixed} streams of 512 "
              f"tokens, the model's own {nb_same} blocks and {n_same}")
        print(f"{tag}: launches {json.dumps(counts)}")
        key = keys(model_dtype, kv) if keys else \
            f"serve_kv_mixed_{str(kv)[6:]}"
        paths[key] = counts
        del engines, engine, same, model
    if parities:
        parity(kv_dtype=torch.bfloat16)
        parity_bf16_model()
    return paths


def parity_bf16_model():
    """A bf16 GPT-2 124M over fp32 pools, card against CPU: greedy tokens
    of two prompts, their agreement reported (bf16 logits round apart on
    the two devices, so near-ties may part)."""
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cpu_model = GPTForCausalLM(cfg, device="cpu", seed=1).to(torch.bfloat16)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 50257, 24).tolist() for _ in range(2)]
    cpu = _greedy(cpu_model, "cpu", prompts, 16, torch.float32)
    reset_launch_counts()
    gpu = _greedy(gpu_model, "cuda", prompts, 16, torch.float32)
    name = pa.append_name(torch.bfloat16, torch.float32)
    assert launch_counts()[name] > 0, launch_counts()
    eq, total, whole = _agreement([r.generated for r in gpu],
                                  [r.generated for r in cpu])
    print(f"parity bf16 model, fp32 pools: greedy tokens equal on card and "
          f"CPU at {eq}/{total} positions, {whole}/2 streams identical "
          f"(reported); {name} launches {launch_counts()[name]}")


def generate_phase(dtypes=(torch.float32, torch.bfloat16)):
    """`GPTForCausalLM.generate` on GPT-2 124M, GEN_B prompts of GEN_P tokens,
    GEN_N new ones, fp32 then bf16: one program build for the signature across
    calls; greedy tokens equal to the engine's streams for the same prompts
    (fp32: held; bf16: reported) and to the eager loop's; ms per generated
    token, the graph's replays against the eager loop in turns (graph, eager,
    eager, graph), host clock around synchronized calls, then each under
    torch.profiler (device time a generated token by kernel group, the device's
    busy share); sampled (temperature 0.8, top-k 40, top-p 0.95): GEN_N
    keyed-draw launches with a row stride a call, the graph's tokens equal the
    eager loop's and repeat call to call. Returns the launch counts of one
    sampled call of the first of `dtypes` (fp32 then bf16 by default)."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 50257, (GEN_B, GEN_P))
    sampler = dict(do_sample=True, top_k=40, top_p=0.95, temperature=0.8,
                   seed=5)
    counts = None
    for dtype in dtypes:
        tag = f"generate ({str(dtype)[6:]})"
        model = _gpt(dtype)
        reset_launch_counts()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=GEN_N).cpu()
        first_s = time.perf_counter() - t0
        first_counts = launch_counts()
        assert model.gen_builds == 1 and tuple(out.shape) == (GEN_B, GEN_N)
        # the first call: one eager prefill (flash a layer), then the build's
        # warm-up step and GEN_N - 1 replays, no keyed draw (greedy)
        assert first_counts["flash_attention_fwd"] == 12, first_counts
        assert first_counts["keyed_draw_rows"] == 0, first_counts
        times = {"graph": [], "eager": []}
        for turn in ("graph", "eager", "eager", "graph"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = model._generate(ids, max_new_tokens=GEN_N,
                                    eager=turn == "eager").cpu()
            times[turn].append((time.perf_counter() - t0) * 1e3 / GEN_N)
            assert torch.equal(again, out), f"{tag}: {turn} call differs"
        assert model.gen_builds == 1, model.gen_builds
        for how in ("graph", "eager"):
            _breakdown(f"{tag}: {how}, a generated token",
                       lambda: model._generate(ids, max_new_tokens=GEN_N,
                                               eager=how == "eager"),
                       per=GEN_N)
        engine = LLMEngine(model, max_batch_size=GEN_B, block_size=16,
                           max_context=1024)
        streams = engine.generate(ids.tolist(), max_new_tokens=GEN_N)
        eq, total, whole = _agreement(out.tolist(), streams)
        if dtype == torch.float32:
            assert out.tolist() == streams, f"{tag}: differs from the engine"
        del engine
        reset_launch_counts()
        s1 = model.generate(ids, max_new_tokens=GEN_N, **sampler).cpu()
        build_counts = launch_counts()
        reset_launch_counts()
        s2 = model.generate(ids, max_new_tokens=GEN_N, **sampler).cpu()
        sampled_counts = launch_counts()
        s3 = model._generate(ids, max_new_tokens=GEN_N, eager=True,
                             **sampler).cpu()
        assert torch.equal(s1, s2) and torch.equal(s1, s3), tag
        assert model.gen_builds == 2, model.gen_builds
        assert sampled_counts["keyed_draw_rows"] == GEN_N, sampled_counts
        assert build_counts["keyed_draw_rows"] == GEN_N + 1, build_counts
        assert sampled_counts["keyed_draw"] == 0, sampled_counts
        assert bool((s1 != out).any()) and int(s1.min()) >= 0 \
            and int(s1.max()) < model.config.vocab_size
        graph_ms = float(np.mean(times["graph"]))
        eager_ms = float(np.mean(times["eager"]))
        print(f"{tag}: {GEN_B} prompts x {GEN_P} tokens, {GEN_N} new: first "
              f"call {first_s:.3f} s (one build); ms per generated token, "
              f"turns (graph, eager, eager, graph) "
              f"{json.dumps([round(t, 4) for t in times['graph'][:1] + times['eager'] + times['graph'][1:]])}"
              f": graph {graph_ms:.4f}, eager {eager_ms:.4f} "
              f"({eager_ms / graph_ms:.2f}x); greedy tokens equal to the "
              f"engine's streams at {eq}/{total} positions, {whole}/{GEN_B} "
              f"streams identical ({'held' if dtype == torch.float32 else 'reported'}); "
              f"sampled: keyed_draw_rows launches {GEN_N} a call (+1 in the "
              f"build's warm-up), graph = eager = repeat; builds "
              f"{model.gen_builds} (one a signature)")
        if counts is None:
            counts = sampled_counts
        del model
    return counts


RESILIENCE_NEW = 24
RESILIENCE_BUDGET_MS = 2000      # injected hangs raise at once
STALL_BUDGET_MS = 50             # the real stall: 80 ms of sleep
STALL_SLEEP_MS = 80
WEDGE_SLEEP_MS = 200             # past the ladder's three budgets
WATCHDOG_TURNS = ("off", "on", "on", "off")


def _resilience_mix(rng):
    """8 greedy prompts of 64-256 tokens and 2 sampled ones."""
    mix = [(rng.integers(0, 50257, int(n)).tolist(), {})
           for n in rng.integers(64, 257, 8)]
    for i in range(2):
        mix.append((rng.integers(0, 50257, 96).tolist(),
                    dict(temperature=0.8, top_k=40, top_p=0.95, seed=i)))
    return mix


def _resilience_run(engine, mix, fault=None, times=1, at=3, adapters=None):
    """The mix through `engine` with streaming callbacks; `fault` injected
    at the decode site after `at` steps. Returns (streams, streamed
    tokens, the requests, stats)."""
    streamed = {}
    reqs = [engine.add_request(
        p, max_new_tokens=RESILIENCE_NEW,
        adapter=None if adapters is None else adapters[i % len(adapters)],
        on_token=lambda r, tok, text: streamed.setdefault(r.rid,
                                                          []).append(tok),
        **kw) for i, (p, kw) in enumerate(mix)]
    for _ in range(at):
        engine.step()
    if fault is not None:
        guardian.inject_fault(fault, op="serve.decode", times=times)
    try:
        engine.run()
    finally:
        guardian.clear_faults()
    torch.cuda.synchronize()
    return ([list(r.generated) for r in reqs],
            [streamed.get(r.rid, []) for r in reqs], reqs, engine.stats())


def _stalled_once(engine, cycles):
    """Make the engine's next decode replay queue behind a sleep kernel of
    `cycles` on its stream, and time each StepHang its monitored wait
    raises (seconds from the wait's start)."""
    hangs, state = [], {"armed": True}
    program, wait = engine._decode_program, engine._monitor.wait

    def stalled(*args):
        if state["armed"]:
            state["armed"] = False
            torch.cuda._sleep(cycles)
        return program(*args)

    def timed_wait(event, phase, attempt=1):
        t0 = time.perf_counter()
        try:
            return wait(event, phase, attempt)
        except StepHang:
            hangs.append(time.perf_counter() - t0)
            raise

    engine._decode_program = stalled
    engine._monitor.wait = timed_wait
    return hangs


def _wedged(model, mix, kw, piped, want):
    """A replay queued behind a sleep of WEDGE_SLEEP_MS, past the ladder's
    budgets of STALL_BUDGET_MS: the active requests fail with step_hang
    after three StepHangs (pipelined: the commit's two), each from the
    event poll within its budget plus the poll's slack, with no rebuild
    while the sleep runs (a capture would wait for it); once it has
    ended, one rebuild and a new request with the unfaulted stream
    `want` of ``mix[0]``."""
    set_flags({"FLAGS_serve_step_timeout_ms": STALL_BUDGET_MS})
    try:
        engine = LLMEngine(model, pipeline_decode=piped, **kw)
        engine.generate([mix[0][0]], max_new_tokens=2)        # built
        hangs = _stalled_once(engine, int(_sleep_cycles_per_s()
                                          * WEDGE_SLEEP_MS / 1e3))
        _, _, reqs, st = _resilience_run(engine, mix[:4], at=0)
        rungs = 2 if piped else 3
        budget = STALL_BUDGET_MS / 1e3
        assert len(hangs) == rungs and st["hangs"] == rungs, (hangs, st)
        assert all(budget <= h <= budget + 0.005 for h in hangs), hangs
        assert all(r.state == "FAILED" and r.error == "step_hang"
                   for r in reqs), [(r.state, r.error) for r in reqs]
        assert st["decode_compiles"] == 1, st
        fresh = engine.add_request(mix[0][0], max_new_tokens=RESILIENCE_NEW)
        engine.run()
        assert fresh.state == "FINISHED" and fresh.generated == want
        assert engine.stats()["decode_compiles"] == 2, engine.stats()
    finally:
        set_flags({"FLAGS_serve_step_timeout_ms": RESILIENCE_BUDGET_MS})
    return (f"a {WEDGE_SLEEP_MS} ms wedge: {rungs} StepHangs at "
            f"{json.dumps([round(h * 1e3, 3) for h in hangs])} ms, the "
            f"{len(reqs)} active requests failed with step_hang "
            f"{sum(hangs) * 1e3:.3f} ms into the step's waits, no rebuild "
            f"during it, then one rebuild and a new request served")


def serve_resilience():
    """The watchdog's ladder and the eager fallback on fp32 GPT-2 124M, serial
    then pipelined, each held to an unfaulted engine's streams (fp32: tokens
    must be equal): an injected hang (rung 1: hangs 1, no rebuild); two
    (serial: one counted rebuild; pipelined: the commit fails the active
    requests at its second hang); three (serial: the active requests fail with
    step_hang, and a new request is served); a real device stall (a sleep
    kernel of STALL_SLEEP_MS queued ahead of a replay, the budget
    STALL_BUDGET_MS: StepHang from the event poll within the budget plus one
    poll interval, the streams equal); a wedge (a sleep of WEDGE_SLEEP_MS, past
    every rung's budget: the active requests fail with step_hang within three
    budgets serial, two pipelined, no rebuild while the sleep runs, then one
    rebuild and a new request served); a poisoned decode (the eager fallback
    through `generate`, streams and callbacks equal, an adapter tenant's
    included). Then the step p50 of the mix with the watchdog armed against
    disarmed, in turns. Returns the launch counts of the serial fallback
    run."""
    model = _gpt(torch.float32)
    rng = np.random.default_rng(11)
    mix = _resilience_mix(rng)
    kw = dict(max_batch_size=8, block_size=16, max_context=1024)
    ref, _, _, _ = _resilience_run(LLMEngine(model, **kw), mix)
    adapters = (None, "a")
    akw = dict(kw, max_adapters=2, adapter_rank=16)

    def adapter_engine(**more):
        engine = LLMEngine(model, **akw, **more)
        engine.register_adapter("a", seed=1, scale=4.0)
        return engine

    ref_a, _, _, _ = _resilience_run(adapter_engine(), mix,
                                     adapters=adapters)
    set_flags({"FLAGS_serve_step_timeout_ms": RESILIENCE_BUDGET_MS})
    counts = None
    try:
        for piped in (False, True):
            mode = "pipelined" if piped else "serial"
            # rung 1
            got, streamed, _, st = _resilience_run(
                LLMEngine(model, pipeline_decode=piped, **kw), mix,
                fault="hang")
            assert got == ref and streamed == ref, mode
            assert st["hangs"] == 1 and st["decode_compiles"] == 1, st
            line = [f"hang x1 ok (hangs 1, decode_compiles 1)"]
            # two hangs
            engine = LLMEngine(model, pipeline_decode=piped, **kw)
            got, _, reqs, st = _resilience_run(engine, mix, fault="hang",
                                               times=2)
            if piped:
                assert st["hangs"] == 2 and all(
                    r.error == "step_hang" for r in reqs
                    if r.state == "FAILED") and st["failed"] > 0, st
                line.append(f"hang x2 fails the {st['failed']} active "
                            f"requests at the commit's second hang")
            else:
                assert got == ref and st["hangs"] == 2 \
                    and st["decode_compiles"] == 2, st
                line.append("hang x2 ok (one rebuild: decode_compiles 2)")
                engine = LLMEngine(model, **kw)
                _, _, reqs, st = _resilience_run(engine, mix, fault="hang",
                                                 times=3)
                failed = [r for r in reqs if r.state == "FAILED"]
                assert st["hangs"] == 3 and failed and all(
                    r.error == "step_hang" for r in failed), st
                line.append(f"hang x3 fails the {len(failed)} active "
                            f"requests with step_hang")
            fresh = engine.add_request(mix[0][0],
                                       max_new_tokens=RESILIENCE_NEW)
            engine.run()
            assert fresh.state == "FINISHED" and fresh.generated == ref[0]
            line.append("a new request served after it")
            # the real stall
            set_flags({"FLAGS_serve_step_timeout_ms": STALL_BUDGET_MS})
            engine = LLMEngine(model, pipeline_decode=piped, **kw)
            engine.generate([mix[0][0]], max_new_tokens=2)    # built
            hangs = _stalled_once(engine, int(_sleep_cycles_per_s()
                                              * STALL_SLEEP_MS / 1e3))
            got, streamed, _, st = _resilience_run(engine, mix, at=0)
            set_flags({"FLAGS_serve_step_timeout_ms": RESILIENCE_BUDGET_MS})
            assert got == ref and streamed == ref, mode
            assert len(hangs) == 1 and st["hangs"] == 1, (hangs, st)
            budget = STALL_BUDGET_MS / 1e3
            assert budget <= hangs[0] <= budget + 0.001 + 0.004, hangs
            line.append(f"a real {STALL_SLEEP_MS} ms stall: StepHang from "
                        f"the event poll {hangs[0] * 1e3:.3f} ms into a "
                        f"{STALL_BUDGET_MS} ms budget, streams equal")
            line.append(_wedged(model, mix, kw, piped, ref[0]))
            # the poisoned decode, with an adapter tenant among the streams
            reset_launch_counts()
            engine = LLMEngine(model, pipeline_decode=piped, **kw)
            got, streamed, reqs, st = _resilience_run(engine, mix,
                                                      fault="nan_output")
            assert got == ref and streamed == ref, mode
            assert st["eager_fallbacks"] > 0 \
                and st["decode_compiles"] == 1, st
            if not piped:
                counts = launch_counts()
            got, streamed, _, st_a = _resilience_run(
                adapter_engine(pipeline_decode=piped), mix,
                fault="nan_output", adapters=adapters)
            eq, total, whole = _agreement(got, ref_a)
            assert got == ref_a and streamed == ref_a, (mode, eq, total)
            line.append(f"nan_output: {st['eager_fallbacks']} streams "
                        f"finished through generate, streams and callbacks "
                        f"equal; with adapter tenants "
                        f"{st_a['eager_fallbacks']}, equal too")
            print(f"serve_resilience ({mode}, fp32 GPT-2 124M, "
                  f"{len(mix)} requests x {RESILIENCE_NEW} tokens): "
                  + "; ".join(line))
        # the watchdog's cost: one warm engine, the mix in turns
        engine = LLMEngine(model, **kw)
        _resilience_run(engine, mix)
        p50 = {"on": [], "off": []}
        for turn in WATCHDOG_TURNS:
            set_flags({"FLAGS_serve_step_timeout_ms":
                       RESILIENCE_BUDGET_MS if turn == "on" else 0})
            engine.reset_stats()
            got, _, _, st = _resilience_run(engine, mix)
            assert got == ref and st["hangs"] == 0
            p50[turn].append(st["p50_step_ms"])
        print(f"serve_resilience: step p50 ms with the watchdog armed "
              f"(budget {RESILIENCE_BUDGET_MS} ms) against disarmed, turns "
              f"{json.dumps(list(WATCHDOG_TURNS))}: on "
              f"{json.dumps([round(x, 4) for x in p50['on']])}, off "
              f"{json.dumps([round(x, 4) for x in p50['off']])}")
    finally:
        set_flags({"FLAGS_serve_step_timeout_ms": 0})
        guardian.clear_faults()
    return counts


RESUME_KILL_STEP = 8


def _resume_mix():
    return _resilience_mix(np.random.default_rng(13))


def _resume_engine(dtype):
    return LLMEngine(_gpt(dtype), max_batch_size=8, block_size=16,
                     max_context=1024)


def resume_child(mode, directory, dtype_name):
    """A child process of `serve_resume`: ``serve`` runs the resume mix
    with a `ServeCheckpointer` tick every step and, after RESUME_KILL_STEP
    steps, prints ``KILL-ME`` and waits to be killed; ``restore`` loads
    the newest snapshot into a fresh engine, finishes it and writes the
    streams and its times to result.json."""
    dtype = getattr(torch, dtype_name)
    t_start = time.perf_counter()
    engine = _resume_engine(dtype)
    ck = ServeCheckpointer(directory, save_every_n_steps=1)
    if mode == "serve":
        for p, kw in _resume_mix():
            engine.add_request(p, max_new_tokens=RESILIENCE_NEW, **kw)
        n = 0
        while engine.step():
            n += 1
            ck.tick(n, engine.state_payload())
            if n == RESUME_KILL_STEP:
                print("KILL-ME", flush=True)
                time.sleep(600)
        raise SystemExit("the mix drained before the kill")
    t0 = time.perf_counter()
    restored = engine.restore_state(ck.restore())
    t_restored = time.perf_counter()
    first = {}
    for r in restored:
        r.on_token = (lambda req, tok, text:
                      first.setdefault(req.rid, time.perf_counter()))
    engine.run()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    with open(Path(directory) / "result.json", "w") as f:
        json.dump({"streams": {r.rid: r.generated for r in restored},
                   "states": {r.rid: r.state for r in restored},
                   "resumed": engine.stats()["resumed"],
                   "start_to_ready_s": t0 - t_start,
                   "restore_s": t_restored - t0,
                   "first_token_s": (min(first.values()) - t_restored
                                     if first else None),
                   "finish_s": t_end - t_restored}, f)


def serve_resume():
    """Crash-resume on the card: a child process serves the resume mix
    (8 greedy, 2 sampled requests) with a ServeCheckpointer tick every
    step and is killed with SIGKILL after RESUME_KILL_STEP steps; a fresh
    process restores the newest snapshot and finishes. Its streams must
    equal an uninterrupted run's (this process), fp32 exactly, bf16 with
    the agreement printed; then a snapshot taken before a weight swap is
    refused by the swapped engine (torn_swap)."""
    import shutil
    import signal
    import sys
    import tempfile
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        engine = _resume_engine(dtype)
        reqs = [engine.add_request(p, max_new_tokens=RESILIENCE_NEW, **kw)
                for p, kw in _resume_mix()]
        engine.run()
        want = {r.rid: r.generated for r in reqs}
        del engine
        directory = tempfile.mkdtemp(prefix="serve_resume_",
                                     dir=Path(__file__).resolve().parent
                                     / "build")
        try:
            cmd = [sys.executable, str(Path(__file__).resolve()),
                   "--resume-child"]
            t0 = time.perf_counter()
            child = subprocess.Popen(cmd + ["serve", directory, name],
                                     stdout=subprocess.PIPE, text=True)
            try:
                for line in child.stdout:
                    if line.strip() == "KILL-ME":
                        break
                else:
                    raise AssertionError("the serving child ended unkilled")
                child.send_signal(signal.SIGKILL)
            finally:
                child.kill()
                child.wait(timeout=60)
            killed_s = time.perf_counter() - t0
            assert child.returncode == -signal.SIGKILL, child.returncode
            t0 = time.perf_counter()
            subprocess.run(cmd + ["restore", directory, name], check=True,
                           timeout=600)
            restore_wall = time.perf_counter() - t0
            with open(Path(directory) / "result.json") as f:
                res = json.load(f)
        finally:
            shutil.rmtree(directory, ignore_errors=True)
        got = res["streams"]
        assert res["resumed"] == len(got) > 0, res
        assert all(state == "FINISHED" for state in res["states"].values())
        eq, total, whole = _agreement([got[k] for k in sorted(got)],
                                      [want[k] for k in sorted(got)])
        if dtype == torch.float32:
            assert all(got[k] == want[k] for k in got), (got, want)
        print(f"serve_resume ({name}): killed (SIGKILL) after "
              f"{RESUME_KILL_STEP} steps ({killed_s:.2f} s from spawn); "
              f"a fresh process restored {res['resumed']} requests and "
              f"finished them: streams equal to the uninterrupted run's at "
              f"{eq}/{total} positions, {whole}/{len(got)} identical "
              f"({'held' if dtype == torch.float32 else 'reported'}); "
              f"restore_state {res['restore_s'] * 1e3:.3f} ms after "
              f"{res['start_to_ready_s']:.3f} s of start-up in the child, "
              f"first token {res['first_token_s'] * 1e3:.3f} ms after the "
              f"restore, finish {res['finish_s']:.3f} s; the restoring "
              f"process {restore_wall:.2f} s wall")
    # torn swap: a snapshot of the first weights, refused after a swap
    model = _gpt(torch.float32)
    engine = LLMEngine(model, max_batch_size=8, block_size=16,
                       max_context=1024, hot_swap=True)
    for p, kw in _resume_mix()[:3]:
        engine.add_request(p, max_new_tokens=4, **kw)
    engine.step()
    payload = engine.state_payload()
    swapped = LLMEngine(_gpt(torch.float32, seed=0), max_batch_size=8,
                        block_size=16, max_context=1024, hot_swap=True)
    values = [p.detach() * 1.01 for p in swapped._model.parameters()]
    assert swapped.swap_weights(values) == 1
    try:
        swapped.restore_state(payload)
    except ServeRefusal as e:
        assert e.reason == "torn_swap", e.reason
    else:
        raise AssertionError("a torn swap was restored")
    assert swapped.requests == {}
    print("serve_resume: a snapshot taken under the first weights is "
          "refused (torn_swap) by an engine that swapped them")


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
    on the CPU, then (fp pools of the model's dtype) the prompts' logits
    within LOGITS_ATOL. With ``kv_dtype="int8"`` (or bf16) both engines
    keep int8 (bf16) pools."""
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
    pools = torch.int8 if kv_dtype == "int8" else (kv_dtype
                                                    or torch.float32)
    fused = pa.append_name(torch.float32, pools)
    assert launch_counts()[fused] > 0, launch_counts()
    if kv_dtype:
        print(f"parity {str(pools)[6:]}: 2 prompts x 16 greedy tokens "
              f"identical on card and CPU with {str(pools)[6:]} KV pools "
              f"under the fp32 model ({tried} prompts tried; {fused} "
              f"launches {launch_counts()[fused]})")
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
               # both forms and the first design's one-CTA-a-row kernel
               ("lora_delta", ("lora_delta_",)),
               # the sampler's filter and draw; cub's radix sort (the first
               # sampler's one sort, the embedding backward's index sort)
               # and scans (the first sampler's top-p cumulative sum)
               ("sampler_filter", ("sampler_filter_kernel",)),
               ("keyed_draw", ("keyed_draw_kernel",)),
               ("radix sort", ("RadixSort",)),
               ("scan", ("scan",)))


PROFILE_MARGIN_S = 0.05


def _breakdown(tag, fn, per=1, top=8, totals=None, groups=None):
    """fn() under torch.profiler: device time by kernel group (`groups`,
    STEP_GROUPS by default) and the device's busy share of the wall time,
    per one of the `per` steps fn runs, and the kernels (and copies) it
    launched per step. Returns the groups' ms per step (None where the
    profiler saw no device time); a `totals` dict gets the step's kernels
    and device ms and each group's launches in the whole window
    (`launches`)."""
    groups_of = STEP_GROUPS if groups is None else groups
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        # the profiler keeps only the device events whose times, on the
        # host's clock, fall inside its window: idle margins keep the
        # first and last kernels inside should the two clocks drift apart
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / per
        time.sleep(PROFILE_MARGIN_S)
    groups, kernels, launches = {}, [], {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3 / per
        kernels.append((ms, evt.count / per, evt.key))
        group = next((g for g, pats in groups_of
                      if any(pat in evt.key for pat in pats)), "other")
        groups[group] = groups.get(group, 0.0) + ms
        launches[group] = launches.get(group, 0) + evt.count
    device_ms = sum(groups.values())
    n_copies = sum(count for _, count, name in kernels
                   if name.startswith(("Memcpy", "Memset")))
    n_kernels = sum(count for _, count, _ in kernels) - n_copies
    if totals is not None:
        totals.update(kernels=n_kernels, copies=n_copies,
                      device_ms=device_ms, launches=launches)
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


def _whole_trace(tag, fn, per, tries=3):
    """`_breakdown(tag, fn, per)`'s totals from a trace that saw every
    launch the wrappers counted in its window: each group of STEP_GROUPS
    that names a counter as often as that counter moved. The profiler
    can drop a run of events (a decode replay once showed 2.5 of its 4
    steps), so a trace that misses any is taken again, each time on
    `fn`'s next `per` steps, at most `tries` times; the last one's
    shortfall raises."""
    for attempt in range(1, tries + 1):
        before = launch_counts()
        totals = {}
        _breakdown(tag, fn, per=per, totals=totals)
        counted = {name: n - before[name]
                   for name, n in launch_counts().items()
                   if n != before[name] and name in dict(STEP_GROUPS)}
        seen = {name: totals.get("launches", {}).get(name, 0)
                for name in counted}
        if not totals.get("device_ms") or seen == counted:
            return totals
        print(f"{tag}: trace {attempt} missed events: the profiler saw "
              f"{json.dumps(seen)} of the wrappers' {json.dumps(counted)}")
    raise AssertionError(f"{tag}: {tries} traces each missed events")


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
    return _count_differing(_state_bits(ma, oa), _state_bits(mb, ob))


def _state_bits(model, opt):
    """Every parameter, accumulator and buffer tensor of `model` under
    `opt` (the buffers: a batch norm's running statistics)."""
    return [p.detach() for p in model.parameters()] + [
        slot[p] for slot in opt._accumulators.values()
        for p in model.parameters() if p in slot] + list(model.buffers())


def _count_differing(a, b):
    """Elements that differ between the tensors of lists `a` and `b`, and
    their count."""
    n = total = 0
    for x, y in zip(a, b):
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
# phase 7b: the training remainder at full width: amp, every optimizer,
# the GradScaler, and a killed run resumed from its StepCheckpointer
# ---------------------------------------------------------------------------

# graph and eager steps compared bit for bit, steps a timed turn, the
# turns' order, and the global-norm clip the amp and resume runs take
AMP_BITWISE_STEPS = 3
AMP_TURN_STEPS = 5
AMP_TURNS = ("graph", "eager", "eager", "graph")
AMP_CLIP_NORM = 1.0
# the optimizers of train_optimizers, each over a bf16 model (Lamb and
# Lars exclude the 0-/1-D parameters from their decay)
OPTIMIZER_RUNS = (
    ("SGD", lambda ps, **kw: SGD(learning_rate=1e-2, parameters=ps, **kw)),
    ("Momentum", lambda ps, **kw: Momentum(
        learning_rate=1e-3, momentum=0.9, use_nesterov=True, parameters=ps,
        **kw)),
    ("Lamb", lambda ps, **kw: Lamb(
        learning_rate=1e-3, parameters=ps,
        exclude_from_weight_decay_fn=lambda p: p.ndim <= 1, **kw)),
    ("RMSProp", lambda ps, **kw: RMSProp(
        learning_rate=1e-4, momentum=0.9, centered=True, parameters=ps,
        **kw)),
    ("Adagrad", lambda ps, **kw: Adagrad(
        learning_rate=1e-3, parameters=ps, initial_accumulator_value=0.1,
        **kw)),
    ("Adadelta", lambda ps, **kw: Adadelta(learning_rate=1.0, parameters=ps,
                                           **kw)),
    ("Adamax", lambda ps, **kw: Adamax(learning_rate=1e-4, parameters=ps,
                                       **kw)),
    ("Lars", lambda ps, **kw: Lars(learning_rate=1.0, parameters=ps,
                                   exclude_from_weight_decay=["bias"], **kw)),
    ("Adam+L2Decay", lambda ps, **kw: Adam(
        learning_rate=1e-4, parameters=ps, weight_decay=L2Decay(1e-4),
        **kw)),
    ("AdamW(multi_precision)", lambda ps, **kw: AdamW(
        learning_rate=TRAIN_LR, weight_decay=0.01, parameters=ps,
        multi_precision=True, **kw)),
)
OPTIMIZER_STEPS = 3
SCALER_STEPS = 6
SCALER_INF_STEP = 3
SCALER_KW = dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2,
                 decr_every_n_nan_or_inf=1)
TRAIN_RESUME_STEPS = 8
TRAIN_RESUME_KILL = 4


def _train_batch(cfg, seed=0, batch=8, seq=1024):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                              device="cuda") for _ in range(2))


def _amp_pair(cfg, level, dtype="bfloat16"):
    """Two GPT-2 124M models from seed 0 (fp32 weights; O2 decorated to
    `dtype`), each with AdamW and its own ClipGradByGlobalNorm, and a
    TrainStep: the first replays its graph, the second steps eagerly."""
    out = []
    for _ in range(2):
        model = GPTForCausalLM(cfg, device="cuda", seed=0)
        if level == "O2":
            amp.decorate(model, level="O2", dtype=dtype)
        model.train()
        clip = ClipGradByGlobalNorm(AMP_CLIP_NORM)
        opt = AdamW(learning_rate=TRAIN_LR, weight_decay=0.01,
                    parameters=model.parameters(), grad_clip=clip,
                    multi_precision=level == "O2")
        out.append((model, opt, TrainStep(model, GPTPretrainingCriterion(),
                                          opt), clip))
    return out


def train_amp(batch=8, seq=1024, dtype="bfloat16"):
    """GPT-2 124M under auto_cast(`dtype`, bf16 or float16): O1 over fp32
    weights, O2 over `decorate`d weights of `dtype` with
    AdamW(multi_precision), peak memory of each; AdamW with a
    global-norm clip and the fused cross-entropy, through TrainStep's
    graph and its eager step (bit for bit after AMP_BITWISE_STEPS, the
    clip binding), then both timed in turns and profiled."""
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ids, labels = _train_batch(cfg)
    tokens = batch * seq
    set_flags({"FLAGS_use_fused_cross_entropy": True})
    counts, out = {}, {}
    tag = "train_amp" if dtype == "bfloat16" else "train_fp16"
    try:
        for level in ("O1", "O2"):
            # the phase's own peak: what earlier phases left to the cyclic
            # collector (their engines and models, patched methods) goes
            # first
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            graph, eager = _amp_pair(cfg, level, dtype)
            g_model, g_opt, g_step, g_clip = graph
            e_model, e_opt, e_step, e_clip = eager
            flops = g_model.flops_per_token(seq)
            with amp.auto_cast(level=level, dtype=dtype):
                run_graph = lambda: g_step(ids, labels)  # noqa: E731
                run_eager = lambda: e_step._step_eager(  # noqa: E731
                    ids, labels)
                losses, norms = [], []
                for _ in range(AMP_BITWISE_STEPS):
                    losses.append((float(run_graph()), float(run_eager())))
                    norms.append((float(g_clip.global_norm),
                                  float(e_clip.global_norm)))
                differ, total = _count_differing(
                    _state_bits(g_model, g_opt), _state_bits(e_model, e_opt))
                weights = ("fp32 weights" if level == "O1" else
                           f"{dtype} weights, fp32 masters")
                print(f"{tag} {level}: {AMP_BITWISE_STEPS} steps of the "
                      f"graph and of the eager step (AdamW, "
                      f"ClipGradByGlobalNorm({AMP_CLIP_NORM}), fused CE, "
                      f"{weights}): "
                      f"losses " + ", ".join(f"{a:.6f}/{b:.6f}"
                                             for a, b in losses)
                      + "; global norms before the clip " + ", ".join(
                          f"{a:.4f}/{b:.4f}" for a, b in norms)
                      + f"; {differ} of {total} elements of parameters and "
                      f"accumulators differ")
                assert all(a == b for a, b in losses), losses
                assert differ == 0, (differ, total)
                assert max(a for a, _ in norms) > AMP_CLIP_NORM, norms
                assert np.isfinite(losses).all()
                reset_launch_counts()
                for _ in range(AMP_TURN_STEPS):
                    run_graph()
                torch.cuda.synchronize()
                counts[level] = launch_counts()
                for name, per_step in TRAIN_KERNELS.items():
                    assert counts[level][name] == per_step * AMP_TURN_STEPS, \
                        (level, name, counts[level])
                turns = [_turn(kind, run_graph if kind == "graph"
                               else run_eager, AMP_TURN_STEPS, tokens, flops)
                         for kind in AMP_TURNS]
                profiled = {}
                for kind, fn in (("graph", run_graph), ("eager", run_eager)):
                    totals = {}
                    _breakdown(f"{tag} {level} {kind}", fn, top=6,
                               totals=totals)
                    profiled[kind] = totals
            peak = torch.cuda.max_memory_allocated()
            for kind in ("graph", "eager"):
                mine = [t for t in turns if t["turn"] == kind]
                print(f"{tag} {level} {kind}: step p50 " + " / ".join(
                    f"{t['p50_ms']:.3f}" for t in mine) + " ms; device "
                    + " / ".join(f"{t['device_ms']:.3f}" for t in mine)
                    + " ms a step; MFU " + " / ".join(
                        f"{t['mfu']:.4f}" for t in mine)
                    + f"; {profiled[kind].get('kernels', 0):.1f} kernels "
                    f"and {profiled[kind].get('copies', 0):.1f} copies a "
                    f"step (profiled); peak memory of the phase "
                    f"{peak / 2**30:.2f} GiB (both models)")
            out[level] = {"turns": turns, "profiled": profiled,
                          "peak_bytes": peak}
            del graph, eager, g_model, e_model, g_opt, e_opt, g_step, e_step
            torch.cuda.empty_cache()
    finally:
        set_flags({"FLAGS_use_fused_cross_entropy": False})
    print(f"{tag}: " + json.dumps(out))
    return counts


def _update_program(opt, params):
    """The optimizer's update over `params` (fixed gradients) captured
    alone in a CUDA graph: returns a function that replays it once."""
    grads = [torch.full_like(p, 1e-3) for p in params]
    pairs = list(zip(params, grads))
    opt._create_accumulators(params)
    opt._begin_step({params[0].device})

    def update():
        with torch.no_grad(), amp.suspended():
            opt._update(pairs)

    warm_up(update)
    torch.cuda.synchronize()
    return capture_graph(update)[0]


def train_optimizers(adamw_row_ms, batch=8, seq=1024):
    """Each optimizer of OPTIMIZER_RUNS (a global-norm clip on top) over
    two bf16 GPT-2 124M models from seed 0: OPTIMIZER_STEPS graph steps
    against as many eager ones, every parameter and accumulator bit for
    bit; then the update alone, captured in a graph over the real
    parameters: its device ms a step (`_timed`) and its kernels a replay
    (torch.profiler), beside AdamW's kernel row (`adamw_row_ms`, this
    run's)."""
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ids, labels = _train_batch(cfg, seed=1)
    models = [GPTForCausalLM(cfg, device="cuda", seed=0).to(torch.bfloat16)
              for _ in range(2)]
    start = [p.detach().clone() for p in models[0].parameters()]
    set_flags({"FLAGS_use_fused_cross_entropy": True})
    rows = []
    try:
        for name, make in OPTIMIZER_RUNS:
            for model in models:
                with torch.no_grad():
                    for p, s in zip(model.parameters(), start):
                        p.copy_(s)
            opts = [make(m.parameters(),
                         grad_clip=ClipGradByGlobalNorm(AMP_CLIP_NORM))
                    for m in models]
            steps = [TrainStep(m, GPTPretrainingCriterion(), o)
                     for m, o in zip(models, opts)]
            losses = [(float(steps[0](ids, labels)),
                       float(steps[1]._step_eager(ids, labels)))
                      for _ in range(OPTIMIZER_STEPS)]
            differ, total = _count_differing(_state_bits(models[0], opts[0]),
                                             _state_bits(models[1], opts[1]))
            moved = max(float((p.detach().float() - s.float()).abs().max())
                        for p, s in zip(models[0].parameters(), start))
            assert all(a == b for a, b in losses), (name, losses)
            assert differ == 0, (name, differ, total)
            assert np.isfinite(losses).all() and moved > 0, (name, losses)
            del steps
            torch.cuda.empty_cache()
            replay = _update_program(opts[0], list(models[0].parameters()))
            device_ms, host_ms = _timed(replay, iters=10, warmup=2)
            totals = {}
            _breakdown(f"train_optimizers {name} update", replay, top=3,
                       totals=totals)
            # a profiler that saw less than 90% of the events' device time
            # dropped kernels (seen late in a long run): no count then
            kernels = totals.get("kernels") if totals.get(
                "device_ms", 0.0) >= 0.9 * device_ms else None
            row = {"optimizer": name, "losses": [a for a, _ in losses],
                   "differing": differ, "elements": total,
                   "update_device_ms": device_ms,
                   "update_host_ms": host_ms,
                   "update_kernels": kernels,
                   "update_profiled_ms": totals.get("device_ms"),
                   "accumulator_bytes": sum(
                       t.numel() * t.element_size()
                       for slot in opts[0]._accumulators.values()
                       for t in slot.values())}
            rows.append(row)
            counted = (f"{kernels:.0f} kernels a replay" if kernels is not None
                       else f"kernels not counted: the profiler saw "
                       f"{totals.get('device_ms', 0.0):.4f} ms")
            print(f"train_optimizers {name}: {OPTIMIZER_STEPS} graph steps "
                  f"= eager steps bit for bit ({total} elements); losses "
                  + ", ".join(f"{x:.6f}" for x in row["losses"])
                  + f"; the update alone {device_ms:.4f} ms device a step "
                  f"({counted}, {host_ms:.4f} ms host to enqueue a "
                  f"replay), AdamW's kernel row {adamw_row_ms:.4f} ms")
            del opts, replay
            torch.cuda.empty_cache()
    finally:
        set_flags({"FLAGS_use_fused_cross_entropy": False})
    print("train_optimizers: " + json.dumps(rows))
    return rows


def _scaler_rule(state, found_inf, kw=SCALER_KW):
    """The reference's loss-scale transition
    (`paddle_tpu/ops/guardian.py` `update_scaler_state`) on Python
    numbers: ``(scale, good, bad)`` after one update."""
    scale, good, bad = state
    bad = bad + 1 if found_inf else 0
    good = 0 if found_inf else good + 1
    if found_inf and bad >= kw["decr_every_n_nan_or_inf"]:
        return max(scale * 0.5, 1.0), good, 0
    if not found_inf and good >= kw["incr_every_n_steps"]:
        return scale * 2.0, 0, bad
    return scale, good, bad


def train_scaler(batch=8, seq=1024, dtype="bfloat16"):
    """An eager GradScaler loop over fp32 GPT-2 124M under
    auto_cast(O1, `dtype`) with AdamW: an inf in one gradient at
    SCALER_INF_STEP leaves every parameter and accumulator bit for bit as
    it was and skips the step; the scale, good and bad counts follow the
    reference's transition at every step, its found-inf whatever made a
    gradient non-finite (the inf, or an f16 overflow of the scaled
    backward); the global norm of the unscaled gradients is printed."""
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ids, labels = _train_batch(cfg, seed=2)
    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=TRAIN_LR, weight_decay=0.01,
                parameters=model.parameters())
    scaler = amp.GradScaler(**SCALER_KW)
    crit = GPTPretrainingCriterion()
    want = (SCALER_KW["init_loss_scaling"], 0, 0)
    seq_got, times, norms, skipped = [], [], [], 0
    set_flags({"FLAGS_use_fused_cross_entropy": True})
    reset_launch_counts()
    try:
        for step in range(1, SCALER_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with amp.auto_cast(level="O1", dtype=dtype):
                loss = crit(model(ids), labels)
            scaler.scale(loss).backward()
            inject = step == SCALER_INF_STEP
            if inject:
                model.gpt.h[-1].mlp.fc_in.weight.grad[3, 7] = float("inf")
            scaler.unscale_(opt)
            grads = [p.grad for p in model.parameters()]
            norm = float(torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads])))
            found = not np.isfinite(norm)
            norms.append(norm)
            if found:
                skipped += 1
                before = [t.clone() for t in _state_bits(model, opt)]
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            assert found or not inject, (step, norm)
            if found:
                differ, total = _count_differing(before,
                                                 _state_bits(model, opt))
                assert differ == 0, (differ, total)
                del before
            got = scaler.state_dict()
            got = (got["scale"], got["good_steps"], got["bad_steps"])
            want = _scaler_rule(want, found)
            seq_got.append(got)
            assert got == want, (step, got, want)
            assert np.isfinite(float(loss.detach()))
    finally:
        set_flags({"FLAGS_use_fused_cross_entropy": False})
    counts = launch_counts()
    assert opt._step_count == SCALER_STEPS - skipped, opt._step_count
    assert counts["flash_attention_fwd"] == 12 * SCALER_STEPS, counts
    tag = "train_scaler" if dtype == "bfloat16" else "train_fp16 scaler"
    print(f"{tag}: eager GradScaler loop, fp32 GPT-2 124M under O1 "
          f"{dtype}, AdamW, batch {batch} x {seq}: (scale, good, bad) "
          + ", ".join(str(t) for t in seq_got) + f" = the reference's "
          f"transition at every step; global norms of the unscaled "
          f"gradients " + ", ".join(f"{n:.4f}" for n in norms)
          + f"; the inf at step {SCALER_INF_STEP} (and {skipped - 1} "
          f"overflows of its own) moved none of the parameters and "
          f"accumulators; step p50 {float(np.median(times)):.3f} ms (host "
          f"clock, each synchronized)")
    return counts


# ---------------------------------------------------------------------------
# the numeric guard at full width
# ---------------------------------------------------------------------------

# steps of the guarded loops, the step whose gradient gets an inf (through a
# device scalar in the graph) and the step whose lr is inf (finite
# gradients: the new state overflows); the turns of the guard's cost
GUARD_STEPS = 5
GUARD_INF_STEP = 2
GUARD_SPIKE_STEP = 4
GUARD_TURNS = ("plain", "guarded", "guarded", "plain")
GUARD_TURN_STEPS = 5
# the launch counters only the guarded paths reach
GUARD_KERNELS = ("adam_update_probe", "adam_update_apply",
                 "multi_tensor_finite", "multi_tensor_finite_unscale",
                 "multi_tensor_copy_if")


class _GradFactor(torch.autograd.Function):
    """The identity forward; the backward multiplies the gradient by a
    device scalar, so a NaN there poisons every gradient of a step while
    its loss stays finite (and a CUDA graph reads the scalar each
    replay)."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.save_for_backward(factor)
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        (factor,) = ctx.saved_tensors
        return grad * factor.to(grad.dtype), None


def _guarded_steps(tag, model, opt, run):
    """GUARD_STEPS steps of `run(step)` (a float loss): the inf step and
    the lr-spike step must leave every parameter, master and moment as it
    was, bit for bit; the others must move them. Returns the losses."""
    losses = []
    for step in range(1, GUARD_STEPS + 1):
        opt.set_lr(float("inf") if step == GUARD_SPIKE_STEP else TRAIN_LR)
        bad = step in (GUARD_INF_STEP, GUARD_SPIKE_STEP)
        before = [t.clone() for t in _state_bits(model, opt)]
        losses.append(run(step))
        differ, total = _count_differing(before, _state_bits(model, opt))
        assert (differ == 0) == bad, (tag, step, differ, total)
        del before
    opt.set_lr(TRAIN_LR)
    print(f"train_guard {tag}: losses " + ", ".join(
        f"{x:.5f}" for x in losses) + f"; steps {GUARD_INF_STEP} (an inf "
        f"gradient) and {GUARD_SPIKE_STEP} (lr inf, finite gradients) left "
        f"every parameter, master and moment bit for bit, the others moved "
        f"them; _step_count {opt._step_count}")
    assert opt._step_count == GUARD_STEPS, opt._step_count
    assert np.isfinite(losses).all(), losses
    return losses


def _unguarded_copy(cfg, model, opt, scaler):
    """A copy of `model` with its gradients, a Momentum of `opt`'s
    settings over it with `opt`'s state, and a GradScaler with `scaler`'s
    state: one unguarded step from where the guarded loop stands."""
    twin = GPTForCausalLM(cfg, device="cuda", seed=0)
    with torch.no_grad():
        for p, q in zip(model.parameters(), twin.parameters()):
            q.copy_(p)
            q.grad = p.grad.clone()
    twin_opt = Momentum(learning_rate=1e-3, momentum=0.9,
                        parameters=twin.parameters())
    twin_opt.set_state_dict(opt.state_dict())
    twin_scaler = amp.GradScaler(**SCALER_KW)
    twin_scaler.load_state_dict(scaler.state_dict())
    return twin, twin_opt, twin_scaler


def _guard_no_sync(cfg, ids, labels, crit):
    """The O1 GradScaler loop (fp32 GPT-2 124M, Momentum: the guard's check
    and copy kernels, the unscale kernel) with `scaler.step` and
    `scaler.update` under ``torch.cuda.set_sync_debug_mode("error")``: an
    inf in one gradient at SCALER_INF_STEP; the state bit for bit where a
    step was skipped, the scale, good and bad counts the reference's
    transition. The last (finite) step is held to an unguarded Momentum
    and GradScaler started from the same state (`_unguarded_copy`): every
    parameter and velocity bit for bit."""
    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    opt = Momentum(learning_rate=1e-3, momentum=0.9,
                   parameters=model.parameters())
    scaler = amp.GradScaler(**SCALER_KW)
    want = (SCALER_KW["init_loss_scaling"], 0, 0)
    seen, skipped = [], 0
    for step in range(1, SCALER_STEPS + 1):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = crit(model(ids), labels)
        scaler.scale(loss).backward()
        if step == SCALER_INF_STEP:
            with numerics.suspended():
                model.gpt.h[-1].mlp.fc_in.weight.grad[3, 7] = float("inf")
        before = [t.clone() for t in _state_bits(model, opt)]
        twin = _unguarded_copy(cfg, model, opt, scaler) \
            if step == SCALER_STEPS else None
        # the device is idle here, so no batch of checks in flight can
        # make a boundary wait: a sync below is the guard's own
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            scaler.step(opt)
            found_t = scaler._found_inf
            scaler.update()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        found = bool(found_t)
        opt.clear_grad()
        if twin is not None:
            twin_model, twin_opt, twin_scaler = twin
            # a comparison: its launches are taken back out of the counts
            counted = launch_counts()
            set_flags({"FLAGS_check_numerics": False})
            try:
                twin_scaler.step(twin_opt)
                twin_scaler.update()
            finally:
                set_flags({"FLAGS_check_numerics": True})
                add_launches({name: counted[name] - n
                              for name, n in launch_counts().items()})
            assert not found and twin_opt._step_count == opt._step_count
            apart = _differ_bits(_state_bits(model, opt),
                                 _state_bits(twin_model, twin_opt))
            assert apart == 0, apart
            print(f"train_guard no_sync: step {step}, guarded against an "
                  f"unguarded Momentum and GradScaler from the same state: "
                  f"every parameter and velocity bit for bit")
            del twin, twin_model, twin_opt, twin_scaler
        differ, total = _count_differing(before, _state_bits(model, opt))
        assert (differ == 0) == found, (step, found, differ, total)
        assert found or step != SCALER_INF_STEP, step
        skipped += found
        got = scaler.state_dict()
        got = (got["scale"], got["good_steps"], got["bad_steps"])
        want = _scaler_rule(want, found)
        seen.append(got)
        assert got == want, (step, got, want)
        assert np.isfinite(float(loss.detach()))
    assert opt._step_count == SCALER_STEPS, opt._step_count
    print(f"train_guard no_sync: O1 bf16 GradScaler loop over fp32 GPT-2 "
          f"124M with Momentum, scaler.step and scaler.update under "
          f"set_sync_debug_mode('error') raised nothing; (scale, good, bad) "
          + ", ".join(str(t) for t in seen) + f" = the reference's "
          f"transition; {skipped} skipped step(s) (the inf at step "
          f"{SCALER_INF_STEP}) moved nothing; _step_count {opt._step_count}")
    return skipped


def _guard_strict(model, ids, labels, crit):
    """One eager step of `model` under FLAGS_check_nan_inf with a NaN in
    its final LayerNorm's weight: raises FloatingPointError naming the
    first op whose output holds it."""
    weight = model.gpt.ln_f.weight
    good = weight.detach().clone()
    with torch.no_grad():
        weight.fill_(float("nan"))
    set_flags({"FLAGS_check_numerics": False, "FLAGS_check_nan_inf": True})
    try:
        crit(model(ids), labels).backward()
    except FloatingPointError as err:
        message = str(err)
    else:
        raise AssertionError("the strict mode let a NaN output through")
    finally:
        set_flags({"FLAGS_check_nan_inf": False})
        with torch.no_grad():
            weight.copy_(good)
        model.zero_grad(set_to_none=True)
    op = re.fullmatch(r"Operator '(\w+)' output contains NaN/Inf", message)
    assert op, message
    print(f"train_guard strict: FLAGS_check_nan_inf, a NaN in ln_f.weight: "
          f"FloatingPointError({message!r})")
    return op.group(1)


def train_guard(batch=8, seq=1024):
    """The numeric guard (FLAGS_check_numerics) at GPT-2 124M's full width,
    batch `batch` x `seq`: an eager AdamW(multi_precision) bf16 loop and
    the same through TrainStep's graph (an inf gradient through a device
    scalar the captured backward reads, an lr of inf through the lr
    scalar), each skipped step a bitwise no-op, steps_skipped counting
    them; the O1 GradScaler loop that never syncs (`_guard_no_sync`); the
    strict mode naming an op (`_guard_strict`); the guard's cost, the
    guarded TrainStep graph against the unguarded one in turns (step p50,
    device ms a step). Returns the phase's launch counts."""
    t0 = time.perf_counter()
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ids, labels = _train_batch(cfg, seed=3)
    crit = GPTPretrainingCriterion()
    reset_launch_counts()
    guardian.reset_guardian_stats()
    guardian.reset_thread_state()
    set_flags({"FLAGS_use_fused_cross_entropy": True,
               "FLAGS_check_numerics": True})
    try:
        models, opts = [], []
        for _ in range(2):
            models.append(GPTForCausalLM(cfg, device="cuda",
                                         seed=0).to(torch.bfloat16))
            models[-1].train()
            opts.append(AdamW(learning_rate=TRAIN_LR, weight_decay=0.01,
                              parameters=models[-1].parameters(),
                              multi_precision=True))
        e_model, g_model = models
        e_opt, g_opt = opts

        def eager_step(step):
            loss = crit(e_model(ids), labels)
            loss.backward()
            if step == GUARD_INF_STEP:
                with numerics.suspended():
                    e_model.gpt.h[-1].mlp.fc_in.weight.grad[3, 7] = \
                        float("inf")
            e_opt.step()
            e_opt.clear_grad()
            return float(loss.detach())

        eager = _guarded_steps("eager", e_model, e_opt, eager_step)
        factor = torch.ones((), device=ids.device)
        g_step = TrainStep(g_model, lambda out, y: _GradFactor.apply(
            crit(out, y), factor), g_opt)

        def graph_step(step):
            with numerics.suspended():
                factor.fill_(float("nan") if step == GUARD_INF_STEP else 1.0)
            return float(g_step(ids, labels))

        graph = _guarded_steps("graph", g_model, g_opt, graph_step)
        guardian.flush()
        stats = guardian.guardian_stats()
        print(f"train_guard: eager loop (backward + step) and graph losses "
              f"equal: {eager == graph}; graph builds {g_step._builds}; "
              f"guardian_stats " + json.dumps(stats))
        assert g_step._builds == 1, g_step._builds
        assert stats["steps_skipped"] == 4, stats
        assert stats["steps_guarded"] == 2 * GUARD_STEPS, stats
        assert stats["nonfinite_outputs"] == 0, stats
        skipped = _guard_no_sync(cfg, ids, labels, crit)
        guardian.flush()
        stats = guardian.guardian_stats()
        assert stats["steps_skipped"] == 4 + skipped, stats
        assert stats["scaler_backoffs"] == skipped, stats
        op = _guard_strict(e_model, ids, labels, crit)
        set_flags({"FLAGS_check_numerics": True})
        # the guard's cost: the guarded graph against an unguarded one over
        # the eager loop's model, in turns
        p_step = None
        turns = []
        tokens = batch * seq
        flops = g_model.flops_per_token(seq)
        for kind in GUARD_TURNS:
            set_flags({"FLAGS_check_numerics": kind == "guarded"})
            if kind == "plain" and p_step is None:
                p_step = TrainStep(e_model, crit, e_opt)
            fn = (lambda: g_step(ids, labels)) if kind == "guarded" \
                else (lambda: p_step(ids, labels))
            turns.append(_turn(kind, fn, GUARD_TURN_STEPS, tokens, flops))
        guardian.flush()
        for kind in ("plain", "guarded"):
            mine = [t for t in turns if t["turn"] == kind]
            print(f"train_guard turns, {kind}: step p50 " + " / ".join(
                f"{t['p50_ms']:.3f}" for t in mine) + " ms; device "
                + " / ".join(f"{t['device_ms']:.3f}" for t in mine)
                + " ms a step")
        print("train_guard turns: " + json.dumps(turns))
        assert g_step._builds == 1 and p_step._builds == 1
    finally:
        set_flags({"FLAGS_use_fused_cross_entropy": False,
                   "FLAGS_check_numerics": False,
                   "FLAGS_check_nan_inf": False})
    counts = launch_counts()
    for name in GUARD_KERNELS:
        assert counts[name] > 0, (name, counts)
    print(f"train_guard: strict mode named '{op}'; launches "
          f"{json.dumps({k: counts[k] for k in GUARD_KERNELS})}; "
          f"{time.perf_counter() - t0:.1f} s wall")
    return counts


def _resume_trainer():
    """bf16 GPT-2 124M from seed 0 with AdamW(multi_precision), a
    global-norm clip and a warm-up schedule, and its TrainStep."""
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device="cuda", seed=0).to(torch.bfloat16)
    sched = LinearWarmup(CosineAnnealingDecay(TRAIN_LR,
                                              T_max=TRAIN_RESUME_STEPS),
                         warmup_steps=2, start_lr=TRAIN_LR / 10,
                         end_lr=TRAIN_LR)
    opt = AdamW(learning_rate=sched, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=True,
                grad_clip=ClipGradByGlobalNorm(AMP_CLIP_NORM))
    return cfg, model, opt, sched, TrainStep(model,
                                             GPTPretrainingCriterion(), opt)


def _resume_steps(first, last, trainer, ck=None):
    """Steps first..last (step i on batch i); returns the losses."""
    cfg, model, opt, sched, step = trainer
    losses = []
    for i in range(first, last + 1):
        losses.append(float(step(*_train_batch(cfg, seed=100 + i))))
        sched.step()
        if ck is not None:
            ck.tick(i, model=model, optimizer=opt)
    return losses


def train_resume_child(mode, directory):
    """A child process of `train_resume`: ``train`` runs steps 1 to
    TRAIN_RESUME_KILL with a StepCheckpointer(save_every_n_steps=2), then
    prints ``KILL-ME`` and waits to be killed; ``restore`` restores into
    fresh objects, runs the steps after it and saves its losses and
    parameters into `directory`."""
    set_flags({"FLAGS_use_fused_cross_entropy": True})
    trainer = _resume_trainer()
    ck = StepCheckpointer(directory, save_every_n_steps=2)
    if mode == "train":
        _resume_steps(1, TRAIN_RESUME_KILL, trainer, ck)
        torch.cuda.synchronize()
        print("KILL-ME", flush=True)
        time.sleep(600)
        raise SystemExit("the training child was not killed")
    t0 = time.perf_counter()
    at = ck.restore(model=trainer[1], optimizer=trainer[2])
    restore_s = time.perf_counter() - t0
    losses = _resume_steps(at + 1, TRAIN_RESUME_STEPS, trainer)
    io.save({"at": at, "losses": losses, "restore_s": restore_s,
             "params": trainer[1].state_dict()},
            Path(directory) / "result.pt")


def train_resume():
    """A child process trains TRAIN_RESUME_KILL steps under a
    StepCheckpointer and is killed with SIGKILL; a fresh process restores
    the newest snapshot and runs the rest. Its losses and parameters must
    equal an uninterrupted run's (this process) bit for bit; so must this
    process's, restoring the snapshot into a TrainStep whose graph was
    built before the load."""
    import shutil
    import signal
    import sys
    import tempfile
    set_flags({"FLAGS_use_fused_cross_entropy": True})
    reset_launch_counts()
    try:
        trainer = _resume_trainer()
        want = _resume_steps(1, TRAIN_RESUME_STEPS, trainer)
    finally:
        set_flags({"FLAGS_use_fused_cross_entropy": False})
    counts = launch_counts()
    want_params = {k: v.cpu() for k, v in trainer[1].state_dict().items()}
    del trainer
    torch.cuda.empty_cache()
    directory = tempfile.mkdtemp(prefix="train_resume_",
                                 dir=Path(__file__).resolve().parent
                                 / "build")
    try:
        cmd = [sys.executable, str(Path(__file__).resolve()),
               "--train-resume-child"]
        t0 = time.perf_counter()
        child = subprocess.Popen(cmd + ["train", directory],
                                 stdout=subprocess.PIPE, text=True)
        try:
            for line in child.stdout:
                if line.strip() == "KILL-ME":
                    break
            else:
                raise AssertionError("the training child ended unkilled")
            child.send_signal(signal.SIGKILL)
        finally:
            child.kill()
            child.wait(timeout=60)
        killed_s = time.perf_counter() - t0
        assert child.returncode == -signal.SIGKILL, child.returncode
        snapshots = sorted(os.listdir(Path(directory) / "default_steps"))
        t0 = time.perf_counter()
        subprocess.run(cmd + ["restore", directory], check=True,
                       timeout=600)
        restore_wall = time.perf_counter() - t0
        res = io.load(Path(directory) / "result.pt")
        # the same snapshot into a TrainStep whose graph was built (and
        # replayed once) before the load: the graph replays from it
        set_flags({"FLAGS_use_fused_cross_entropy": True})
        try:
            trainer = _resume_trainer()
            _resume_steps(1, 1, trainer)
            at = StepCheckpointer(directory, save_every_n_steps=2).restore(
                model=trainer[1], optimizer=trainer[2])
            built = _resume_steps(at + 1, TRAIN_RESUME_STEPS, trainer)
        finally:
            set_flags({"FLAGS_use_fused_cross_entropy": False})
        built_differ, _ = _count_differing(
            [p.detach().cpu() for p in trainer[1].state_dict().values()],
            list(want_params.values()))
        builds = trainer[4]._builds
        del trainer
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    differ, total = _count_differing(
        [res["params"][k] for k in want_params], list(want_params.values()))
    print(f"train_resume: bf16 GPT-2 124M, AdamW(multi_precision) + clip + "
          f"LinearWarmup(CosineAnnealingDecay), a TrainStep graph, batch "
          f"i on step i; the child killed (SIGKILL) after step "
          f"{TRAIN_RESUME_KILL} ({killed_s:.2f} s from spawn; snapshots "
          f"{snapshots}); a fresh process restored step {res['at']} "
          f"({res['restore_s']:.3f} s) and ran steps {res['at'] + 1}-"
          f"{TRAIN_RESUME_STEPS} ({restore_wall:.2f} s wall): losses "
          + ", ".join(f"{x:.6f}" for x in res["losses"]) + " vs the "
          f"uninterrupted run's " + ", ".join(
              f"{x:.6f}" for x in want[res["at"]:])
          + f"; {differ} of {total} parameter elements differ (a "
          f"difference would name a kernel that is not deterministic "
          f"across processes: the flash pair, cross-entropy or the AdamW "
          f"update)")
    print(f"train_resume: the snapshot loaded into a TrainStep whose graph "
          f"was built before the load ({builds} build): steps "
          f"{at + 1}-{TRAIN_RESUME_STEPS} losses " + ", ".join(
              f"{x:.6f}" for x in built) + f"; {built_differ} parameter "
          f"elements differ from the uninterrupted run's")
    assert res["at"] == TRAIN_RESUME_KILL, res["at"]
    assert res["losses"] == want[TRAIN_RESUME_KILL:], (res["losses"], want)
    assert differ == 0, (differ, total)
    assert at == TRAIN_RESUME_KILL and builds == 1, (at, builds)
    assert built == want[TRAIN_RESUME_KILL:], (built, want)
    assert built_differ == 0, built_differ
    return counts


# ---------------------------------------------------------------------------
# phase 7c: the deployment tier (jit.save / jit.load, the inference
# Predictor) and async_save
# ---------------------------------------------------------------------------

EXPORT_SEQ = 1024
EXPORT_WARM_CALLS = 20
# the decode step's Predictor at the reference bench's shape (bench.py:526):
# 8 prompts of 96 tokens, 64 new ones, static buffers of 160 positions
PRED_B, PRED_P, PRED_N = 8, 96, 64
PRED_T = PRED_P + PRED_N
ASYNC_SAVE_AT, ASYNC_SAVE_STEPS = 2, 5


def _scratch_dir(prefix):
    """A fresh directory under the checkout's build/ (which .gitignore
    lists): the phases' files, removed by the caller."""
    import tempfile
    return tempfile.mkdtemp(prefix=prefix,
                            dir=Path(__file__).resolve().parent / "build")


def _p50_ms(fn, calls):
    """The median host ms of `calls` synchronized calls of fn()."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def export_phase():
    """bf16 GPT-2 124M on the card through `jit.save(model, path,
    input_spec=[InputSpec([1, EXPORT_SEQ], "int64")])` (a `torch.export`
    program whose attention is the flash op) and `jit.load`: the loaded
    layer's logits equal the eager model's bit for bit, and each call
    launches the flash forward 12 times (the hand-written kernel is in the
    saved program). Prints the save and load seconds, the first call's ms
    and the warm ms a call (p50 of EXPORT_WARM_CALLS). Returns the launch
    counts of one call of the loaded layer."""
    import shutil
    from paddle_tpu_torch import jit
    model = _gpt(torch.bfloat16).eval()
    ids = torch.tensor(np.random.default_rng(11).integers(
        0, 50257, (1, EXPORT_SEQ)), device="cuda")
    directory = _scratch_dir("export_")
    try:
        t0 = time.perf_counter()
        path = jit.save(model, os.path.join(directory, "gpt2_124m"),
                        input_spec=[jit.InputSpec([1, EXPORT_SEQ], "int64")])
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        layer = jit.load(path)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    assert layer.has_forward, layer.export_error
    nodes = [str(n.target) for n in layer.program.graph.nodes]
    flash_nodes = nodes.count("paddle_tpu_torch.flash_attention_fwd.default")
    assert flash_nodes == 12 and layer.device == torch.device("cuda", 0), \
        (flash_nodes, layer.device)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = layer(ids)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    assert counts["flash_attention_fwd"] == 12 \
        and sum(counts.values()) == 12, counts
    with torch.no_grad():
        want = model(ids)
    differ = int((got != want).sum())
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert differ == 0, (differ, float((got.float() - want.float()).abs()
                                       .max()))
    warm_ms = _p50_ms(lambda: layer(ids), EXPORT_WARM_CALLS)
    with torch.no_grad():
        eager_ms = _p50_ms(lambda: model(ids), EXPORT_WARM_CALLS)
    print(f"export: bf16 GPT-2 124M forward [1, {EXPORT_SEQ}] through "
          f"jit.save ({save_s:.2f} s, {nbytes / 2**20:.1f} MiB: weights "
          f"and the torch.export program) and jit.load ({load_s:.2f} s; "
          f"{flash_nodes} flash_attention_fwd op nodes): first call "
          f"{first_ms:.2f} ms, warm {warm_ms:.3f} ms a call (p50 of "
          f"{EXPORT_WARM_CALLS}; the eager model {eager_ms:.3f}); launches "
          f"a call {json.dumps({k: n for k, n in counts.items() if n})}; "
          f"logits equal to the eager model's bit for bit ({differ} of "
          f"{got.numel()} differ)")
    return counts


def _pack_static(caches, dtype, device):
    """The prefill's per-layer (k, v) ``[B, P, H, D]`` packed into zeroed
    static buffers ``[L, B, PRED_T, H, D]``."""
    b, p, h, d = caches[0][0].shape
    shape = (len(caches), b, PRED_T, h, d)
    kb = torch.zeros(shape, dtype=dtype, device=device)
    vb = torch.zeros(shape, dtype=dtype, device=device)
    for layer, (k, v) in enumerate(caches):
        kb[layer, :, :p] = k
        vb[layer, :, :p] = v
    return kb, vb


@torch.no_grad()
def _decode_loops(model, ids, loops):
    """Prefill `ids` eagerly through the dynamic cache (the flash kernel),
    then PRED_N - 1 greedy tokens through each of `loops` (name ->
    ``(step, host)``: ``step(tok [B, 1] int64, kb, vb, pos int32) ->
    (logits, kb, vb)`` on its own buffers, numpy arrays where `host`,
    else device tensors), in turns token by token. Returns ``({name:
    tokens [B, PRED_N]}, {name: ms a token}, launch counts of the
    prefill)``."""
    reset_launch_counts()
    logits, caches = model(ids, caches=model.gen_caches(PRED_B))
    counts = launch_counts()
    kb, vb = _pack_static(caches, model.gpt.wte.weight.dtype, "cuda")
    first = logits[:, -1, :].argmax(-1)
    first_host = first.cpu().numpy()
    state = {}
    for name, (_, host) in loops.items():
        state[name] = ((first_host, kb.cpu().numpy(), vb.cpu().numpy())
                       if host else (first, kb.clone(), vb.clone()))
    tokens = {name: [first_host] for name in loops}
    times = {name: [] for name in loops}
    for i in range(PRED_N - 1):
        for name, (step, host) in loops.items():
            tok, k, v = state[name]
            if host:
                args = (tok[:, None].astype(np.int64), k, v,
                        np.asarray(PRED_P + i, np.int32))
            else:
                args = (tok[:, None], k, v,
                        torch.tensor(PRED_P + i, dtype=torch.int32,
                                     device="cuda"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, k, v = step(*args)
            tok = lg[:, -1, :].argmax(-1)
            if not host:
                tok_host = tok.cpu()        # the loop's own sync
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            state[name] = (tok, k, v)
            tokens[name].append(tok if host else tok_host.numpy())
    return ({name: np.stack(t, 1) for name, t in tokens.items()},
            {name: float(np.median(t)) for name, t in times.items()}, counts)


def predictor_phase():
    """`GPTDecodeStep` of GPT-2 124M saved by `jit.save` ([B, 1] int64
    tokens, [12, B, 160, 12, 64] K and V buffers, a 0-d int32 position) at
    B = PRED_B, a PRED_P-token prompt and PRED_N new tokens (bench.py's
    Predictor shape). fp32: the prompt prefilled eagerly (the flash
    kernel), then PRED_N - 1 tokens through `create_predictor(Config(path))
    .run([...])` (numpy in and out, the buffers crossing the host each
    token), through `jit.load`'s layer on device tensors and through the
    eager step, in turns token by token: all three equal
    `model.generate(ids, max_new_tokens=PRED_N)`'s greedy tokens. bf16: the
    loaded layer's tokens equal the eager step's. Prints the ms a token of
    each loop. Returns the launch counts of the fp32 prefill (the decode
    step itself runs torch ops only, as the reference's XLA einsums)."""
    import shutil
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.incubate.models import GPTDecodeStep
    ids = torch.tensor(np.random.default_rng(12).integers(
        0, 50257, (PRED_B, PRED_P)), device="cuda")
    out, counts = {}, None
    directory = _scratch_dir("predictor_")
    try:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            model = _gpt(dtype).eval()
            cfg = model.config
            heads = cfg.num_attention_heads
            buf = [cfg.num_hidden_layers, PRED_B, PRED_T, heads,
                   cfg.hidden_size // heads]
            step = GPTDecodeStep(model)
            t0 = time.perf_counter()
            path = jit.save(step, os.path.join(directory, f"decode_{name}"),
                            input_spec=[jit.InputSpec([PRED_B, 1], "int64"),
                                        jit.InputSpec(buf, dtype),
                                        jit.InputSpec(buf, dtype),
                                        jit.InputSpec([], "int32")])
            save_s = time.perf_counter() - t0
            layer = jit.load(path)
            assert layer.has_forward, layer.export_error
            loops = {"eager": (step, False),
                     "loaded": (layer, False)}
            if dtype == torch.float32:
                pred = inference.create_predictor(inference.Config(path))
                loops["predictor"] = (lambda *a: pred.run(list(a)), True)
            tokens, ms, prefill = _decode_loops(model, ids, loops)
            if dtype == torch.float32:
                counts = prefill
                assert prefill["flash_attention_fwd"] == 12, prefill
                want = model.generate(ids, max_new_tokens=PRED_N).cpu()
                for loop, got in tokens.items():
                    assert np.array_equal(got, want.numpy()), \
                        (name, loop, int((got != want.numpy()).sum()))
                held = "equal generate's for every loop"
            else:
                assert np.array_equal(tokens["loaded"], tokens["eager"]), \
                    int((tokens["loaded"] != tokens["eager"]).sum())
                held = "the loaded layer's equal the eager step's"
            out[name] = ms
            print(f"predictor ({name}): GPTDecodeStep saved in {save_s:.2f}"
                  f" s; B={PRED_B}, prompt {PRED_P}, {PRED_N} new tokens, "
                  f"buffers {buf}: ms a token, in turns token by token, "
                  + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
                  + f"; {PRED_N - 1} decode tokens each, greedy tokens "
                  f"{held}")
            del model, step, layer, loops
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return counts


def _host_copy(obj):
    """`obj` with every tensor copied to the CPU (a snapshot)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _differing_leaves(got, want, where=""):
    """Where two nested objects differ: tensors by dtype, shape and bits,
    the rest by ==."""
    if isinstance(want, torch.Tensor):
        same = isinstance(got, torch.Tensor) and got.dtype == want.dtype \
            and got.shape == want.shape and torch.equal(got, want)
        return [] if same else [where]
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [where]
        return [w for k in want
                for w in _differing_leaves(got[k], want[k], f"{where}/{k}")]
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return [where]
        return [w for i, (g, x) in enumerate(zip(got, want))
                for w in _differing_leaves(g, x, f"{where}/{i}")]
    return [] if got == want else [where]


def async_save_phase(batch=8, seq=1024):
    """The bf16 GPT-2 124M TrainStep with AdamW(multi_precision) (train's
    configuration, batch 8 x 1024, fused CE): after step ASYNC_SAVE_AT,
    `io.async_save({"model": ..., "opt": ...}, path)`, then steps up to
    ASYNC_SAVE_STEPS run while the writer thread writes, then `wait()`;
    the loaded file equals the state at step ASYNC_SAVE_AT bit for bit,
    though the parameters moved on under it. Prints the caller's blocking
    ms, wait()'s ms, the bytes written and a plain `io.save` of the same
    object's blocking ms. Returns the launch counts of the steps."""
    import shutil
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device="cuda", seed=0).to(torch.bfloat16)
    model.train()
    opt = AdamW(learning_rate=TRAIN_LR, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=True)
    step = TrainStep(model, GPTPretrainingCriterion(), opt)
    set_flags({"FLAGS_use_fused_cross_entropy": True})
    directory = _scratch_dir("async_save_")
    try:
        reset_launch_counts()
        losses = [float(step(*_train_batch(cfg, seed=200 + i, batch=batch,
                                           seq=seq)))
                  for i in range(1, ASYNC_SAVE_AT + 1)]
        torch.cuda.synchronize()
        obj = {"model": model.state_dict(), "opt": opt.state_dict()}
        want = _host_copy(obj)
        path = os.path.join(directory, "step2.pdckpt")
        t0 = time.perf_counter()
        handle = io.async_save(obj, path)
        block_ms = (time.perf_counter() - t0) * 1e3
        losses += [float(step(*_train_batch(cfg, seed=200 + i, batch=batch,
                                            seq=seq)))
                   for i in range(ASYNC_SAVE_AT + 1, ASYNC_SAVE_STEPS + 1)]
        done_before = handle.done()
        t0 = time.perf_counter()
        handle.wait()
        wait_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        nbytes = os.path.getsize(path)
        moved = _differing_leaves(_host_copy(model.state_dict()),
                                  want["model"])
        differ = _differing_leaves(io.load(path), want)
        t0 = time.perf_counter()
        io.save(obj, os.path.join(directory, "plain.pdckpt"))
        plain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        set_flags({"FLAGS_use_fused_cross_entropy": False})
        shutil.rmtree(directory, ignore_errors=True)
    print(f"async_save: bf16 GPT-2 124M TrainStep + AdamW(multi_precision), "
          f"steps 1-{ASYNC_SAVE_STEPS} losses "
          + ", ".join(f"{x:.6f}" for x in losses)
          + f"; async_save after step {ASYNC_SAVE_AT}: {nbytes} bytes, the "
          f"caller blocked {block_ms:.1f} ms, steps {ASYNC_SAVE_AT + 1}-"
          f"{ASYNC_SAVE_STEPS} ran meanwhile (the write "
          f"{'had ended' if done_before else 'still ran'} after them), "
          f"wait() {wait_ms:.1f} ms; a plain io.save of the same object "
          f"blocked {plain_ms:.1f} ms; the file's tensors differ from step "
          f"{ASYNC_SAVE_AT}'s at {len(differ)} leaves ({len(moved)} of "
          f"{len(want['model'])} parameters moved on after it)")
    assert differ == [], differ[:10]
    assert len(moved) > 0 and all(np.isfinite(losses)), (moved, losses)
    return counts


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


def fused_ln_phase(iters=10, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(7)
    x, res, g = (torch.randn(LN_SHAPE, generator=gen) for _ in range(3))
    layer = _ln_layer("cuda", dtype, seed=8)
    args = [t.to("cuda", dtype) for t in (x, res, g)]
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
    print(f"fused_ln: FusedBiasDropoutResidualLayerNorm(768) "
          f"{str(dtype)[6:]} on "
          f"{LN_SHAPE}, {iters} iterations: forward p50 "
          f"{float(np.median(fwd)):.4f} ms, forward + backward p50 "
          f"{float(np.median(step)):.4f} ms (host clock, synchronized); "
          f"launches {json.dumps(counts)}")
    if dtype != torch.bfloat16:
        return counts
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


# ---------------------------------------------------------------------------
# phase 9: float16 — every kernel's f16 instantiation against its twin at
# the main paths' shapes, then serving and training in float16 at GPT-2
# 124M's full width
# ---------------------------------------------------------------------------

F16 = torch.float16
# (pools, q or rows) of the cast instantiations with f16 on one side
F16_CAST_PAIRS = ((F16, torch.float32), (F16, torch.bfloat16),
                  (torch.float32, F16), (torch.bfloat16, F16))
# (model, pools) of the float16 serve runs over pools of another type
F16_KV_MIXED = ((torch.float32, F16), (F16, torch.float32),
                (torch.bfloat16, F16), (F16, torch.bfloat16))
# the f16 backward's large-dO cases at [1, 128, 12, 64]: q, k, v from one
# numpy generator (seed 21), q and k scaled so rows peak, dO ~ N(0, 1) from
# seed 22 times the gain, by causal: (q's, k's, dO's factor). |dP - Delta|
# passes 10^4 in both; non-causal, |dS| passes 65504 (74072 in the CPU's
# fp32 arithmetic) while the fp32 gradients fit in f16 (48736 at most), so
# the kernels' dS factor has to act; causal it stays idle (|dS| 46261).
# At the training shape a dO gain that takes |dP - Delta| past 10^3
F16_LARGE_DO = {True: (2.0, 1.0, 6000.0), False: (1.5, 1.4, 11000.0)}
F16_TRAIN_DO_GAIN = 300.0
# card vs CPU, f16 GPT-2 124M: a greedy token counts as decided when its
# top-2 margin on the CPU exceeds 4 f16 steps of logits of 8-16 (2^-7)
F16_MARGIN = 4 * 2.0 ** -7
F16_OUT = dict(route="cuda")


def _f16_numpy(shape, seed, count, gain=1.0):
    """`count` f16 tensors of normal values times `gain` from one numpy
    generator, on the card."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(shape) * gain)
                             .astype(np.float32)).to(F16).cuda()
            for _ in range(count)]


def _f16_row(name, counter, source, replaces, kernel, twin, library, nbytes,
             flops, err, shape, note=None, bound=None):
    """A kernels-line row of an f16 instantiation: the kernel's device ms
    (and host ms), the twin's, the library call's (None: no one PyTorch
    call computes it) and the bound, `(ms, by)` or from `nbytes` and
    `flops` at the fp32 peak."""
    ms, host_ms = _timed(kernel)
    plain_ms = _cuda_ms(twin, iters=5)
    library_ms = _cuda_ms(library) if library is not None else None
    bound, by = bound or _bound_ms(nbytes, flops, torch.float32)
    print(f"  {name}: {ms:.5f} ms (host {host_ms:.5f}), twin {plain_ms:.5f} "
          f"ms, library "
          f"{'null' if library_ms is None else f'{library_ms:.5f} ms'}, "
          f"bound {bound:.5f} ms ({by})")
    row = {"name": name, "counter": counter, "route": "cuda",
           "source": source, "replaces": replaces, "max_abs_err": err,
           "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
           "shape": shape}
    if note:
        row["note"] = note
    return row


def check_float16():
    """Every f16 instantiation against its twin and timed (phase 9's
    kernels). Returns {path: rows}, each row's launches to be read from
    that path's run."""
    t0 = time.perf_counter()
    rows = {"serve_fp16": [check_flash(F16)],
            "train_fp16": check_flash_bwd(F16)}
    for part in (check_paged_append(F16), check_prefill_scatter(F16)):
        for path, more in part.items():
            rows.setdefault(path, []).extend(more)
    rows["train_fp16_ce"] = check_ce(F16)
    rows["train_fp16"].extend(check_adam_update(F16))
    rows["fused_ln_fp16"] = [check_fused_ln(F16)]
    rows["serve_tenancy_fp16"] = [check_lora_delta(F16)]
    print(f"  float16 kernels: {time.perf_counter() - t0:.1f} s wall")
    return rows


def _print_beside(tag, base):
    """serve_fp16's step p50, TTFT p50 and prefill p50 by bucket beside
    the bf16 run's (`base`), both warm passes of the same mix."""
    a, b = SERVE_STATS[tag], SERVE_STATS[base]
    print(f"{tag} beside {base} (warm pass of the same mix): step p50 "
          f"{a['p50_step_ms']:.3f} / {b['p50_step_ms']:.3f} ms, TTFT p50 "
          f"{a['ttft_p50_ms']:.3f} / {b['ttft_p50_ms']:.3f} ms; prefill p50 "
          f"by bucket, ms " + json.dumps(
              {str(k): [round(v, 3), round(b['prefill_p50_ms'].get(k, 0), 3)]
               for k, v in a["prefill_p50_ms"].items()}))


def parity_fp16():
    """f16 GPT-2 124M on the card and on the CPU (f16 twins there): greedy
    tokens equal for two prompts whose every top-2 margin on the CPU
    clears F16_MARGIN."""
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cpu_model = GPTForCausalLM(cfg, device="cpu", seed=1).to(F16)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(4)
    prompts, tried = [], 0
    while len(prompts) < 2:
        tried += 1
        assert tried <= 12, "no prompt with clear greedy margins"
        p = rng.integers(0, 50257, 24).tolist()
        (req,) = _greedy(cpu_model, "cpu", [p], 8)
        margins = [a[0] - a[1] for a in req.alt_logprobs]
        if min(margins) > F16_MARGIN:
            prompts.append((p, req.generated))
    reset_launch_counts()
    gpu = _greedy(gpu_model, "cuda", [p for p, _ in prompts], 8)
    for (p, cpu_tokens), r in zip(prompts, gpu):
        assert r.generated == cpu_tokens, (r.generated, cpu_tokens)
    assert launch_counts()["paged_decode_append"] > 0, launch_counts()
    print(f"parity fp16: 2 prompts x 8 greedy tokens identical on card and "
          f"CPU, f16 model and pools ({tried} prompts tried; every CPU "
          f"top-2 margin above {F16_MARGIN})")


def _tenancy_fp16(model):
    """Two adapters through the f16 model's engine (decode graph, prefix
    cache off): base tenants' streams bit for bit with an adapter-free
    engine's, each adapter's streams moved off them; lora_delta launched
    in the window. Returns the window's launch counts."""
    rng = np.random.default_rng(6)
    warm = [rng.integers(0, 50257, 20).tolist()]
    prompts = [rng.integers(0, 50257, int(n)).tolist()
               for n in rng.integers(64, 300, 6)]
    plan = [None, "a", "b", None, "a", "b"]
    engine = LLMEngine(model, max_batch_size=8, block_size=16,
                       max_context=1024, max_adapters=2, adapter_rank=16)
    engine.register_adapter("a", seed=1, scale=4.0)
    engine.register_adapter("b", seed=2, scale=4.0)
    engine.generate(warm, max_new_tokens=2)
    plain = LLMEngine(model, max_batch_size=8, block_size=16,
                      max_context=1024)
    reset_launch_counts()
    reqs = [engine.add_request(p, max_new_tokens=16, adapter=ad)
            for p, ad in zip(prompts, plan)]
    engine.run()
    torch.cuda.synchronize()
    counts = launch_counts()
    base = plain.generate(prompts, max_new_tokens=16)
    st = engine.stats()
    assert counts["lora_delta"] > 0, counts
    moved = 0
    for r, ad, want in zip(reqs, plan, base):
        assert r.state == "FINISHED" and len(r.generated) == 16, r.state
        if ad is None:
            assert list(r.generated) == want, (r.generated, want)
        else:
            moved += list(r.generated) != want
    assert moved > 0, "no adapter moved its stream"
    print(f"serve_tenancy_fp16: 6 requests (2 base, 2 of adapter a, 2 of "
          f"b) through the f16 engine: base streams equal to an "
          f"adapter-free engine's, {moved}/4 adapter streams moved off "
          f"them; step p50 {st['p50_step_ms']:.3f} ms; lora_delta launches "
          f"{counts['lora_delta']}")
    return counts


def serve_fp16():
    """Serving in float16 at GPT-2 124M's full width: the serve mix over
    f16 pools and over int8 pools (`serve` and `serve_int8` on an f16
    model: graph replays counted, graph = eager greedy tokens, int8
    admission at equal pool bytes), card vs CPU parity, two tenants'
    adapters, `generate`, and pools of another float type each way with
    fp32 and bf16 models (`serve_kv_mixed`). Returns {path: counts}."""
    t0 = time.perf_counter()
    paths = {}
    paths["serve_fp16"], greedy, model = serve(dtype=F16,
                                               prefill_turns=False)
    _print_beside("serve_fp16", "serve")
    paths["serve_int8_fp16"] = serve_int8(greedy, dtype=F16,
                                          prefill_turns=False)
    _print_beside("serve_int8_fp16", "serve_int8")
    paths["serve_tenancy_fp16"] = _tenancy_fp16(model)
    del model
    parity_fp16()
    paths["generate_fp16"] = generate_phase(dtypes=(F16,))
    paths.update(serve_kv_mixed(
        F16_KV_MIXED, keys=lambda m, kv: f"serve_kv_{SHORT_NAMES[m]}_{SHORT_NAMES[kv]}",
        parities=False))
    print(f"serve_fp16: {time.perf_counter() - t0:.1f} s wall")
    return paths


def _plain_fp16_fused_ce(batch=8, seq=1024, steps=3):
    """A plain float16 GPT-2 124M (no amp, AdamW with fp32 masters), the
    fused cross-entropy on: TrainStep's graph, f16 logits into the CE
    kernels once a step each; losses finite and falling. Returns the
    measured steps' launch counts."""
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ids, labels = _train_batch(cfg, seed=4)
    model = GPTForCausalLM(cfg, device="cuda", seed=0).to(F16)
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=True)
    step = TrainStep(model, GPTPretrainingCriterion(), opt)
    set_flags({"FLAGS_use_fused_cross_entropy": True})
    try:
        first = float(step(ids, labels))
        reset_launch_counts()
        losses = [float(step(ids, labels)) for _ in range(steps)]
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        set_flags({"FLAGS_use_fused_cross_entropy": False})
    assert np.isfinite([first] + losses).all() and losses[-1] < first, \
        (first, losses)
    for name, per in (("cross_entropy_fwd", 1), ("cross_entropy_bwd", 1),
                      ("flash_attention_fwd", 12), ("adam_update", 1)):
        assert counts[name] == per * steps, (name, counts)
    print(f"train_fp16 plain f16 model, fused CE: losses {first:.4f} then "
          + ", ".join(f"{x:.4f}" for x in losses) + f"; launches "
          f"{json.dumps(counts)}")
    return counts


def train_fp16(batch=8, seq=1024):
    """Training in float16 at GPT-2 124M's full width: O1 and O2 float16
    through TrainStep's graph and its eager step (`train_amp`: bit for
    bit, timed in turns, MFU, profiled, peak memory), the eager O1 float16
    loop under GradScaler (`train_scaler`: the reference's transition at
    every step, the global norms), and a plain f16 model with the fused
    CE. Returns {path: counts}: train_fp16 the O2 graph's measured steps
    (f16 flash, f16 update), train_fp16_ce the plain model's."""
    t0 = time.perf_counter()
    counts = train_amp(batch, seq, dtype="float16")
    train_scaler(batch, seq, dtype="float16")
    paths = {"train_fp16": counts["O2"],
             "train_fp16_ce": _plain_fp16_fused_ce(batch, seq)}
    print(f"train_fp16: {time.perf_counter() - t0:.1f} s wall")
    return paths


# ---------------------------------------------------------------------------
# phase 10: vit — the reference's config 5 (ViT-L/16 training, fused vs
# unfused: bench.py:444-510) and the ViT's inference
# ---------------------------------------------------------------------------

VIT_BATCH = 32
VIT_LR = 1e-4
# the counted window (its losses on the repeated batch must fall), the
# steps held bit for bit graph against eager, the timed turns
VIT_STEPS = 8
VIT_BITWISE_STEPS = 3
VIT_TURNS = ("fused", "unfused", "unfused", "fused")
VIT_TURN_STEPS = 4
VIT_FLASH_A_STEP = {"flash_attention_fwd": 24, "flash_attention_bwd_dq": 24,
                    "flash_attention_bwd_dkv": 24}
# the first step's loss, fused against unfused on the same weights, bf16:
# both paths compute the same function with their matmuls grouped apart
# (one qkv product against three), so activations round to bf16 apart in
# a few elements; the loss is itself a bf16 value (one step 2^-5 at 4-8,
# 2^-4 at 8-16). Held within VIT_LOSS_ULPS bf16 steps at the loss.
VIT_LOSS_ULPS = 4
# card against CPU, fp32 (TF32 off), ViT-L width at depth 2, batch 2:
# logits (about 1 in size) differ by summation order only, through two
# blocks of widths 1024 and 4096; one AdamW step's parameters as the train
# parity phase holds GPT (TRAIN_PARITY_*: 1e-5, an element whose gradient
# is within rounding of 0 may step the other way by 2 lr, at most
# TRAIN_PARITY_FLIP_SHARE of them), and the key biases, whose gradient is
# 0 but for rounding (the softmax cancels them), within one lr of where
# they started on each side
VIT_PARITY_DEPTH, VIT_PARITY_BATCH = 2, 2
VIT_LOGITS_TOL = (1e-4, 1e-4)
VIT_EXPORT_BATCH = 8


def _bf16_ulp(x):
    """bf16's step at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def _map_unfused_into_fused(fused, plain):
    """The unfused ViT's weights into the fused one (the mapping of
    tests/test_vision_models.py:86-124 in the port's layouts: q, k, v
    ``[out, in]`` stacked into ``qkv_weight [3, H, D, E]``, the other
    Linear weights transposed to ``[in, out]``)."""
    with torch.no_grad():
        for dst, src in [(fused.patch_embed.proj, plain.patch_embed.proj),
                         (fused.norm, plain.norm), (fused.head, plain.head)]:
            dst.weight.copy_(src.weight)
            dst.bias.copy_(src.bias)
        fused.cls_token.copy_(plain.cls_token)
        fused.pos_embed.copy_(plain.pos_embed)
        for fb, pb in zip(fused.blocks, plain.blocks):
            at, ff, sa = fb.fused_attn, fb.ffn, pb.self_attn
            h, d = at.num_heads, at.head_dim
            projs = (sa.q_proj, sa.k_proj, sa.v_proj)
            at.qkv_weight.copy_(torch.stack(
                [lin.weight.reshape(h, d, -1) for lin in projs]))
            at.qkv_bias.copy_(torch.stack(
                [lin.bias.reshape(h, d) for lin in projs]))
            at.linear_weight.copy_(sa.out_proj.weight.t())
            at.linear_bias.copy_(sa.out_proj.bias)
            at.pre_ln_scale.copy_(pb.norm1.weight)
            at.pre_ln_bias.copy_(pb.norm1.bias)
            ff.ln1_scale.copy_(pb.norm2.weight)
            ff.ln1_bias.copy_(pb.norm2.bias)
            ff.linear1_weight.copy_(pb.linear1.weight.t())
            ff.linear1_bias.copy_(pb.linear1.bias)
            ff.linear2_weight.copy_(pb.linear2.weight.t())
            ff.linear2_bias.copy_(pb.linear2.bias)


def _vit_trainer(model):
    """`model` with config 5's optimizer and step: AdamW(1e-4,
    multi_precision) and `TrainStep` over the port's cross-entropy."""
    from paddle_tpu_torch.nn import functional as tF
    opt = AdamW(learning_rate=VIT_LR, parameters=model.parameters(),
                multi_precision=True)
    return opt, TrainStep(model, lambda o, y: tF.cross_entropy(o, y), opt,
                          donate="all")


def _vit_batch(batch, dtype, device, seed=0, img=224, classes=1000):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((batch, 3, img, img)),
                     dtype=torch.float32).to(device, dtype)
    y = torch.tensor(rng.integers(0, classes, (batch,)), device=device)
    return x, y


def _key_bias_rows(name):
    """Where parameter `name` holds key biases (axis 0), or None."""
    if name.endswith("qkv_bias"):
        return [1]
    if name.endswith("k_proj.bias"):
        return slice(None)
    return None


def _vit_parity(fused):
    """ViT-L width at depth VIT_PARITY_DEPTH, fp32: eval logits and one
    `TrainStep` (a graph on the card, eager on the CPU) from one state,
    card against CPU."""
    from paddle_tpu_torch.vision.models import vit_l_16
    tag = "fused" if fused else "unfused"
    cpu = vit_l_16(use_fused_attn=fused, depth=VIT_PARITY_DEPTH,
                   device="cpu", seed=5)
    gpu = copy.deepcopy(cpu).to("cuda")
    x, y = _vit_batch(VIT_PARITY_BATCH, torch.float32, "cpu", seed=6)
    for m in (cpu, gpu):
        m.eval()
    with torch.no_grad():
        want, got = cpu(x), gpu(x.cuda()).cpu()
    err = _close(f"vit parity {tag} logits card vs CPU", got, want,
                 VIT_LOGITS_TOL)
    start = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    losses = []
    for m, dev in ((gpu, "cuda"), (cpu, "cpu")):
        m.train()
        _, step = _vit_trainer(m)
        losses.append(float(step(x.to(dev), y.to(dev))))
    assert abs(losses[0] - losses[1]) <= TRAIN_PARITY_LOSS_ATOL, losses
    param_err, flipped, total, key_moved = 0.0, 0, 0, 0.0
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        got, want = pg.detach().cpu(), pc.detach()
        rows = _key_bias_rows(name)
        if rows is not None:
            for side in (got, want):
                key_moved = max(key_moved, float(
                    (side[rows] - start[name][rows]).abs().max()))
            keep = torch.ones(got.shape[0], dtype=torch.bool)
            keep[rows] = False
            got, want = got[keep], want[keep]
        diff = (got - want).abs()
        if diff.numel():
            param_err = max(param_err, float(diff.max()))
        flipped += int((diff > TRAIN_PARITY_PARAM_ATOL).sum())
        total += diff.numel()
    assert key_moved <= VIT_LR * (1 + 1e-3), key_moved
    assert param_err <= 2 * VIT_LR, param_err
    assert flipped <= TRAIN_PARITY_FLIP_SHARE * total, (flipped, total)
    print(f"vit parity {tag}: ViT-L width, depth {VIT_PARITY_DEPTH}, batch "
          f"{VIT_PARITY_BATCH}, fp32: logits max_abs_err {err:.3e}; one "
          f"step's loss card {losses[0]:.6f} vs CPU {losses[1]:.6f}; max "
          f"param err {param_err:.3e}, {flipped} of {total} elements beyond "
          f"{TRAIN_PARITY_PARAM_ATOL:g} (at most "
          f"{TRAIN_PARITY_FLIP_SHARE:g} of them, each within {2 * VIT_LR:g});"
          f" key biases moved at most {key_moved:.3e} (lr {VIT_LR:g})")


def _vit_export():
    """ViT-B/16 bf16 in eval through `jit.save` at [VIT_EXPORT_BATCH, 3,
    224, 224] and `jit.load`: the loaded program's logits bit for bit with
    the eager model's, 12 flash forward launches a call. Returns the
    launch counts of one call."""
    import shutil
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.vision.models import vit_b_16
    model = vit_b_16(device="cuda", seed=7).to(torch.bfloat16).eval()
    x, _ = _vit_batch(VIT_EXPORT_BATCH, torch.bfloat16, "cuda", seed=8)
    directory = _scratch_dir("vit_export_")
    try:
        t0 = time.perf_counter()
        path = jit.save(model, os.path.join(directory, "vit_b_16"),
                        input_spec=[jit.InputSpec(tuple(x.shape),
                                                  "bfloat16")])
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        layer = jit.load(path)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    assert layer.has_forward, layer.export_error
    torch.cuda.synchronize()
    reset_launch_counts()
    got = layer(x)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["flash_attention_fwd"] == 12 \
        and sum(counts.values()) == 12, counts
    with torch.no_grad():
        want = model(x)
    differ = int((got != want).sum())
    assert differ == 0, (differ, float((got.float() - want.float()).abs()
                                       .max()))
    warm_ms = _p50_ms(lambda: layer(x), 10)
    print(f"vit export: bf16 ViT-B/16 eval [{VIT_EXPORT_BATCH}, 3, 224, 224]"
          f" through jit.save ({save_s:.2f} s) and jit.load ({load_s:.2f} "
          f"s): 12 flash launches a call, warm {warm_ms:.3f} ms a call; "
          f"logits equal to the eager model's bit for bit ({differ} of "
          f"{got.numel()} differ)")
    return counts


def vit_phase():
    """Config 5 at full width: ViT-L/16 (image 224, patch 16, E 1024,
    depth 24, 16 heads of 64, MLP 4096, 1000 classes) in bf16, the unfused
    model from seed 0 and the fused one from its weights mapped, each with
    AdamW(1e-4, multi_precision) through `TrainStep`'s graph on a batch of
    32 from a seed: the first step's losses (fused vs unfused), the fused
    graph against `_step_eager` bit for bit after 3 steps, a counted window
    of 8 steps a path (72 flash launches a step, falling losses), turns,
    profiles and peak memory; card against CPU at depth 2 in fp32; the
    eval forward at batch 32; ViT-B/16 through jit.save / jit.load.
    Returns the launch counts by path: vit (the fused window), vit_unfused,
    vit_eval (one eval forward), vit_export (one loaded call)."""
    from paddle_tpu_torch.vision.models import vit_l_16
    t0 = time.perf_counter()
    # cuDNN's patch-projection backward may add in any order otherwise;
    # the graph and the eager step are held bit for bit
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    paths = {}
    plain = vit_l_16(use_fused_attn=False, device="cuda", seed=0)
    fused = vit_l_16(use_fused_attn=True, device="cuda", seed=1)
    _map_unfused_into_fused(fused, plain)
    models = {"fused": fused.to(torch.bfloat16),
              "unfused": plain.to(torch.bfloat16)}
    eager = copy.deepcopy(models["fused"])
    x, y = _vit_batch(VIT_BATCH, torch.bfloat16, "cuda")
    flops = models["fused"].flops_per_image(training=True)
    steps = {tag: _vit_trainer(m)[1] for tag, m in models.items()}
    e_opt, e_step = _vit_trainer(eager)
    runs = {tag: (lambda s=s: s(x, y)) for tag, s in steps.items()}
    run_eager = lambda: e_step._step_eager(x, y)      # noqa: E731
    build_s, first = {}, {}
    for tag, run in runs.items():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        first[tag] = float(run())
        build_s[tag] = time.perf_counter() - t1
    ulps = VIT_LOSS_ULPS * _bf16_ulp(first["unfused"])
    print(f"vit: ViT-L/16 bf16 AdamW(multi_precision) batch {VIT_BATCH}; "
          f"graph builds {build_s['fused']:.2f} s fused, "
          f"{build_s['unfused']:.2f} s unfused (warm-up + capture + step "
          f"1); first step's loss fused {first['fused']:.5f} vs unfused "
          f"{first['unfused']:.5f} (|diff| at most {VIT_LOSS_ULPS} bf16 "
          f"steps, {ulps:g})")
    assert np.isfinite(list(first.values())).all(), first
    assert abs(first["fused"] - first["unfused"]) <= ulps, first
    pairs = [(first["fused"], float(run_eager()))] + [
        (float(runs["fused"]()), float(run_eager()))
        for _ in range(VIT_BITWISE_STEPS - 1)]
    g_opt = steps["fused"].optimizer
    differ, total = _count_differing(_state_bits(models["fused"], g_opt),
                                     _state_bits(eager, e_opt))
    print(f"vit: {VIT_BITWISE_STEPS} steps of the fused graph and of the "
          f"eager step from one state: losses " + ", ".join(
              f"{a:.6f}/{b:.6f}" for a, b in pairs) + f"; {differ} of "
          f"{total} elements of parameters, masters and moments differ")
    assert all(a == b for a, b in pairs), pairs
    assert differ == 0, (differ, total)
    del eager, e_opt, e_step, run_eager
    gc.collect()
    torch.cuda.empty_cache()

    for tag, run in runs.items():
        losses, times = [], []
        reset_launch_counts()
        for _ in range(VIT_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(float(run()))
            times.append((time.perf_counter() - t1) * 1e3)
        counts = launch_counts()
        paths["vit" if tag == "fused" else "vit_unfused"] = counts
        for name, per_step in VIT_FLASH_A_STEP.items():
            assert counts[name] == per_step * VIT_STEPS, (tag, counts)
        assert steps[tag]._builds == 1, steps[tag]._builds
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        p50 = float(np.median(times))
        print(f"vit {tag}: {VIT_STEPS} graph steps, losses "
              + ", ".join(f"{v:.4f}" for v in losses) + f"; step p50 "
              f"{p50:.3f} ms, p99 {float(np.percentile(times, 99)):.3f}; "
              f"{VIT_BATCH / (p50 / 1e3):.1f} images/s; MFU "
              f"{VIT_BATCH / (p50 / 1e3) * flops / PEAK_FLOPS[torch.bfloat16]:.4f}"
              f" ({flops} FLOPs/image vs 989e12 FLOP/s); flash launches a "
              f"step " + json.dumps({n: counts[n] / VIT_STEPS
                                     for n in VIT_FLASH_A_STEP}))
    turns = [_turn(tag, runs[tag], VIT_TURN_STEPS, VIT_BATCH, flops)
             for tag in VIT_TURNS]
    ips = {}
    for tag in ("fused", "unfused"):
        mine = [t for t in turns if t["turn"] == tag]
        ips[tag] = float(np.mean([t["tokens_per_s"] for t in mine]))
        print(f"vit turns, {tag}: step p50 " + " / ".join(
            f"{t['p50_ms']:.3f}" for t in mine) + " ms; device " + " / ".join(
            f"{t['device_ms']:.3f}" for t in mine) + " ms a step; images/s "
            + " / ".join(f"{t['tokens_per_s']:.1f}" for t in mine)
            + "; MFU " + " / ".join(f"{t['mfu']:.4f}" for t in mine))
    print(f"vit: fused / unfused images/s {ips['fused'] / ips['unfused']:.4f}"
          f" (the reference's criterion, fused >= unfused: reported, not "
          f"gated)")
    for tag, run in runs.items():
        totals = {}
        _breakdown(f"vit {tag} graph", run, totals=totals)
        print(f"vit {tag}: {totals.get('kernels', 0):.1f} kernels and "
              f"{totals.get('device_ms', 0.0):.3f} ms device time a step "
              "(profiled)")
    for tag, run in runs.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        float(run())
        peak = torch.cuda.max_memory_allocated()
        print(f"vit {tag}: max_memory_allocated {peak / 2**30:.3f} GiB over "
              f"a step in a fresh reading, {(peak - before) / 2**30:.3f} GiB "
              f"above the {before / 2**30:.3f} allocated before it (both "
              f"models, masters and moments live; the graphs' activations "
              f"sit in their pools: reserved "
              f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB)")

    for tag, model in models.items():
        model.eval()
        totals = {}
        with torch.no_grad():
            reset_launch_counts()
            logits = model(x)
            torch.cuda.synchronize()
            counts = launch_counts()
            wall_ms = _p50_ms(lambda m=model: m(x), 10)
            # device time from the profiler: the eager forward's host
            # falls behind its device, so events around queued calls
            # would count the gaps
            _breakdown(f"vit eval {tag}", lambda m=model: m(x), top=4,
                       totals=totals)
        assert counts["flash_attention_fwd"] == 24, counts
        assert tuple(logits.shape) == (VIT_BATCH, 1000) and bool(
            torch.isfinite(logits.float()).all())
        if tag == "fused":
            paths["vit_eval"] = counts
        ms = totals.get("device_ms", 0.0)
        print(f"vit eval {tag}: forward at batch {VIT_BATCH} {wall_ms:.3f} "
              f"ms a batch (p50, host clock, synchronized), "
              f"{VIT_BATCH / (wall_ms / 1e3):.1f} images/s; {ms:.3f} ms of "
              f"device time over {totals.get('kernels', 0):.0f} kernels "
              f"(profiled; busy {ms / wall_ms:.3f} of the p50); 24 flash "
              "launches a forward")
    del models, steps, runs, fused, plain, g_opt
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for fused_path in (True, False):
        _vit_parity(fused_path)
    paths["vit_export"] = _vit_export()
    print(f"vit: {time.perf_counter() - t0:.1f} s wall")
    return paths


# phase 11: resnet — the reference's config 1 (ResNet-50 ImageNet training,
# single-device dygraph: BASELINE.json) and the conv-net zoo on the card
# ---------------------------------------------------------------------------

RESNET_BATCH = 128
RESNET_IMG = 224
# config 1's optimizer: Momentum(0.1, 0.9) with L2Decay(1e-4)
RESNET_LR, RESNET_MOMENTUM, RESNET_DECAY = 0.1, 0.9, 1e-4
RESNET_STEPS = 8
RESNET_BITWISE_STEPS = 3
RESNET_TURNS = ("graph", "eager", "eager", "graph")
RESNET_TURN_STEPS = 4
RESNET_EXPORT_BATCH = 8
# card against CPU, fp32 (TF32 off): ResNet-18 at 64 x 64, batch 16 (its
# layer4 batch norms see 64 values a channel), 1000 classes. Logits within
# RESNET_LOGITS_RTOL of their largest magnitude (summation order only);
# one step's update of each parameter (lr 0.1 times a gradient of up to
# ~100 at init, whose fp32 rounding seventeen batch norms amplify on the
# way to conv1: 3.2e-3 seen there, card against CPU) within
# RESNET_UPDATE_FRO_RTOL of it by relative Frobenius norm, and each
# running statistic within RESNET_LOGITS_RTOL of its largest magnitude
RESNET_PARITY_IMG, RESNET_PARITY_BATCH = 64, 16
RESNET_LOGITS_RTOL = 1e-4
RESNET_UPDATE_FRO_RTOL = 1e-2
# every other zoo constructor: one eval forward at batch 2, card against
# CPU (fp32, TF32 off), within RESNET_LOGITS_RTOL of the logits' largest
# magnitude (deep nets at their init give logits of 1e-11 to 1)
RESNET_ZOO = {
    "resnet18": 224, "resnet34": 224, "resnet101": 224, "resnet152": 224,
    "wide_resnet50_2": 224, "wide_resnet101_2": 224,
    "resnext50_32x4d": 224, "resnext50_64x4d": 224,
    "resnext101_32x4d": 224, "resnext101_64x4d": 224,
    "resnext152_32x4d": 224, "resnext152_64x4d": 224, "LeNet": 28,
    "vgg11": 224, "vgg13": 224, "vgg16": 224, "vgg19": 224,
    "mobilenet_v1": 224, "mobilenet_v2": 224, "mobilenet_v3_small": 224,
    "mobilenet_v3_large": 224, "alexnet": 224, "densenet121": 224,
    "densenet161": 224, "densenet169": 224, "densenet201": 224,
    "densenet264": 224, "googlenet": 224, "inception_v3": 299,
    "shufflenet_v2_x0_25": 224, "shufflenet_v2_x0_33": 224,
    "shufflenet_v2_x0_5": 224, "shufflenet_v2_x1_0": 224,
    "shufflenet_v2_x1_5": 224, "shufflenet_v2_x2_0": 224,
    "shufflenet_v2_swish": 224, "squeezenet1_0": 224, "squeezenet1_1": 224}
# a ResNet step's device time by group (first match wins)
RESNET_GROUPS = (
    ("layout transforms", ("nchwToNhwc", "nhwcToNchw", "ranspose")),
    ("cuDNN convolutions, cuBLAS head", ("conv", "Conv", "xmma", "fprop",
                                         "dgrad", "wgrad", "implicit",
                                         "gemm", "Gemm", "nvjet",
                                         "cutlass")),
    ("batch norm", ("bn_", "batch_norm", "BatchNorm", "batchnorm")),
    ("Momentum update and L2Decay (multi-tensor)", ("multi_tensor_apply",)),
    ("pooling", ("pool", "Pool")),
    ("elementwise (casts, ReLU, adds)", ("elementwise", "Elementwise")),
    ("reductions", ("reduce_kernel",)))


def _resnet_flops(model, img, in_chans=3):
    """FLOPs of one image's training step from the shapes its convolutions
    and linears see: 2 · MACs forward, x3 for forward and backward."""
    from paddle_tpu_torch import nn as tnn
    macs = []

    def hook(mod, inputs, out):
        if isinstance(mod, torch.nn.Linear):
            macs.append(mod.in_features * mod.out_features)
        else:
            w = mod.weight
            macs.append(out[0].numel() * math.prod(w.shape[1:]))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (tnn.Conv2D, torch.nn.Linear))]
    training = model.training
    model.eval()                # a training forward would move the stats
    try:
        with torch.no_grad():
            model(torch.zeros(1, in_chans, img, img,
                              device=next(model.parameters()).device))
    finally:
        model.train(training)
        for h in hooks:
            h.remove()
    return 3 * 2 * sum(macs)


def _resnet_trainer(model):
    """`model` with config 1's optimizer and cross-entropy through
    `TrainStep`."""
    from paddle_tpu_torch.nn import functional as tF
    opt = Momentum(learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM,
                   parameters=model.parameters(),
                   weight_decay=L2Decay(RESNET_DECAY))
    return opt, TrainStep(model, lambda o, y: tF.cross_entropy(o, y), opt)


def _o1(fn):
    """fn() under config 1's amp: O1 in bf16."""
    def run():
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return fn()
    return run


def _resnet_parity():
    """ResNet-18 in fp32, card against CPU: eval logits, then one
    `TrainStep` (the card's graph, the CPU's eager step) from one state:
    parameters and running statistics."""
    from paddle_tpu_torch.vision.models import resnet18
    cpu = resnet18(device="cpu", seed=11)
    gpu = copy.deepcopy(cpu).to("cuda")
    x, y = _vit_batch(RESNET_PARITY_BATCH, torch.float32, "cpu", seed=12,
                      img=RESNET_PARITY_IMG)
    for m in (cpu, gpu):
        m.eval()
    with torch.no_grad():
        want, got = cpu(x), gpu(x.cuda()).cpu()
    scale = float(want.abs().max())
    err = _close("resnet parity logits card vs CPU", got, want,
                 (RESNET_LOGITS_RTOL * scale, 0.0))
    start = [p.detach().clone() for p in cpu.parameters()]
    # the same step in float64 on the CPU: the yardstick both fp32 updates
    # are measured against
    cpu64 = copy.deepcopy(cpu).double()
    losses = []
    for m, dev in ((gpu, "cuda"), (cpu, "cpu")):
        m.train()
        _, step = _resnet_trainer(m)
        losses.append(float(step(x.to(dev), y.to(dev))))
    cpu64.train()
    _, step64 = _resnet_trainer(cpu64)
    loss64 = float(step64(x.double(), y))
    _resnet_float64_distances(cpu64, cpu, gpu, start, losses, loss64)
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1]), losses
    update_err = stat_err = 0.0
    for (name, pc), pg, p0 in zip(cpu.named_parameters(), gpu.parameters(),
                                  start):
        want = pc.detach() - p0
        got = pg.detach().cpu() - p0
        err_p = float((got - want).norm() / want.norm().clamp_min(1e-30))
        assert err_p <= RESNET_UPDATE_FRO_RTOL, (name, err_p)
        update_err = max(update_err, err_p)
    for (name, bc), bg in zip(cpu.named_buffers(), gpu.buffers()):
        err_b = float((bg.cpu() - bc).abs().max() / bc.abs().max())
        assert err_b <= RESNET_LOGITS_RTOL, (name, err_b)
        stat_err = max(stat_err, err_b)
    print(f"resnet parity: ResNet-18, {RESNET_PARITY_IMG} x "
          f"{RESNET_PARITY_IMG}, batch {RESNET_PARITY_BATCH}, fp32: logits "
          f"max_abs_err {err:.3e} (largest {scale:.3e}); one step's loss "
          f"card {losses[0]:.6f} vs CPU {losses[1]:.6f}; each parameter's "
          f"update within {update_err:.3e} by relative Frobenius norm (at "
          f"most {RESNET_UPDATE_FRO_RTOL:g}); running statistics within "
          f"{stat_err:.3e} of their largest magnitude")


def _resnet_float64_distances(cpu64, cpu, gpu, start, losses, loss64):
    """Each fp32 update (the card's, the CPU's) against the float64
    step's, by relative Frobenius norm: per parameter (the worst and the
    median) and over all parameters at once; printed, not bounded (the
    step's own bound is RESNET_UPDATE_FRO_RTOL, card against CPU)."""
    per = {"card": [], "CPU": []}
    total = {"card": 0.0, "CPU": 0.0}
    norm2 = 0.0
    for (name, p64), pc, pg, p0 in zip(cpu64.named_parameters(),
                                       cpu.parameters(), gpu.parameters(),
                                       start):
        base = p0.double()
        want = p64.detach() - base
        norm = float(want.norm())
        norm2 += norm ** 2
        for side, p in (("card", pg.detach().cpu()), ("CPU", pc.detach())):
            diff = float(((p.double() - base) - want).norm())
            per[side].append((diff / max(norm, 1e-300), name))
            total[side] += diff ** 2
    parts = []
    for side in ("card", "CPU"):
        errs = sorted(per[side])
        parts.append(
            f"{side} fp32 worst {errs[-1][0]:.3e} ({errs[-1][1]}), median "
            f"{errs[len(errs) // 2][0]:.3e}, all parameters "
            f"{math.sqrt(total[side] / norm2):.3e}")
    print(f"resnet parity vs float64: one step's update of each fp32 run "
          f"against the same step in float64 on the CPU (loss {loss64:.9f}; "
          f"card {losses[0]:.9f}, CPU {losses[1]:.9f}), relative Frobenius "
          f"norm: " + "; ".join(parts))


def _resnet_zoo():
    """One eval forward of every other constructor at batch 2, card
    against CPU in fp32. Returns the worst error relative to the logits'
    largest magnitude."""
    from paddle_tpu_torch.vision import models as tmodels
    worst = 0.0
    t0 = time.perf_counter()
    for i, (name, img) in enumerate(RESNET_ZOO.items()):
        # drawn on the card (fast), copied to the CPU
        gpu = getattr(tmodels, name)(device="cuda", seed=20 + i).eval()
        cpu = copy.deepcopy(gpu).to("cpu")
        chans = 1 if name == "LeNet" else 3
        x = torch.tensor(np.random.default_rng(i).standard_normal(
            (2, chans, img, img)), dtype=torch.float32)
        with torch.no_grad():
            want, got = cpu(x), gpu(x.cuda())
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == (3 if name == "googlenet" else 1), name
        for w, g in zip(want, got):
            scale = float(w.abs().max())
            assert scale > 0 and bool(torch.isfinite(g).all()), name
            err = float((g.cpu() - w).abs().max()) / scale
            assert err <= RESNET_LOGITS_RTOL, (name, err)
            worst = max(worst, err)
        del cpu, gpu
    print(f"resnet zoo: {len(RESNET_ZOO)} constructors, one eval forward "
          f"each at batch 2 (224 x 224; Inception-v3 299, LeNet 1 x 28 x "
          f"28), card against CPU in fp32: worst error {worst:.3e} of the "
          f"logits' largest magnitude (at most {RESNET_LOGITS_RTOL:g}); "
          f"{time.perf_counter() - t0:.1f} s")
    return worst


def _resnet_export(model):
    """The evaluating ResNet-50 (fp32) through `jit.save` at
    [RESNET_EXPORT_BATCH, 3, 224, 224] and `jit.load`: the loaded
    program's logits bit for bit with the eager model's."""
    import shutil
    from paddle_tpu_torch import jit
    x, _ = _vit_batch(RESNET_EXPORT_BATCH, torch.float32, "cuda", seed=13)
    directory = _scratch_dir("resnet_export_")
    try:
        t0 = time.perf_counter()
        path = jit.save(model, os.path.join(directory, "resnet50"),
                        input_spec=[jit.InputSpec(tuple(x.shape),
                                                  "float32")])
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        layer = jit.load(path)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    assert layer.has_forward, layer.export_error
    got = layer(x)
    with torch.no_grad():
        want = model(x)
    differ = int((got != want).sum())
    assert differ == 0, (differ, float((got - want).abs().max()))
    warm_ms = _p50_ms(lambda: layer(x), 10)
    print(f"resnet export: fp32 ResNet-50 eval [{RESNET_EXPORT_BATCH}, 3, "
          f"224, 224] through jit.save ({save_s:.2f} s) and jit.load "
          f"({load_s:.2f} s): warm {warm_ms:.3f} ms a call; logits equal "
          f"to the eager model's bit for bit ({differ} of {got.numel()} "
          f"differ)")


def resnet_phase():
    """Config 1 at full width: ResNet-50 (224 x 224, 1000 classes) from
    seed 0, fp32 parameters under amp O1 in bf16, Momentum(0.1, 0.9,
    L2Decay(1e-4)) through `TrainStep`'s graph on a batch of 128 from a
    seed, cuDNN deterministic: the build and the first loss, the graph
    against `_step_eager` bit for bit after 3 steps (parameters,
    velocities and every batch norm's running statistics), a counted
    window of 8 steps (one build, its last loss below the first step's,
    images/s, step p50 / p99, MFU by the convolutions' and linears'
    shapes), a profiled step by group, graph and eager in turns, peak
    memory; the eval forward at
    batch 128; the eval ResNet-50 through jit.save / jit.load; ResNet-18
    card against CPU in fp32; every other zoo constructor's eval forward,
    card against CPU. Returns the window's launch counts (no kernel of
    the port lies on this path: all zero)."""
    from paddle_tpu_torch.vision.models import resnet50
    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    model = resnet50(device="cuda", seed=0)
    model.train()
    eager = copy.deepcopy(model)
    flops = _resnet_flops(model, RESNET_IMG)
    x, y = _vit_batch(RESNET_BATCH, torch.float32, "cuda", img=RESNET_IMG)
    g_opt, g_step = _resnet_trainer(model)
    e_opt, e_step = _resnet_trainer(eager)
    run = _o1(lambda: g_step(x, y))
    run_eager = _o1(lambda: e_step._step_eager(x, y))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_build = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    first = float(run())
    build_s = time.perf_counter() - t1
    build_peak = torch.cuda.max_memory_allocated()
    print(f"resnet: ResNet-50 fp32 under O1 bf16, Momentum({RESNET_LR}, "
          f"{RESNET_MOMENTUM}, L2Decay({RESNET_DECAY:g})), batch "
          f"{RESNET_BATCH} x 3 x {RESNET_IMG} x {RESNET_IMG}; graph build "
          f"{build_s:.2f} s (warm-up + capture + step 1); first loss "
          f"{first:.5f} (ln 1000 = {math.log(1000):.5f})")
    assert math.isfinite(first) and abs(first - math.log(1000)) < 3, first
    pairs = [(first, float(run_eager()))] + [
        (float(run()), float(run_eager()))
        for _ in range(RESNET_BITWISE_STEPS - 1)]
    differ, total = _count_differing(_state_bits(model, g_opt),
                                     _state_bits(eager, e_opt))
    n_buffers = sum(b.numel() for b in model.buffers())
    print(f"resnet: {RESNET_BITWISE_STEPS} steps of the graph and of the "
          f"eager step from one state: losses " + ", ".join(
              f"{a:.6f}/{b:.6f}" for a, b in pairs) + f"; {differ} of "
          f"{total} elements of parameters, velocities and running "
          f"statistics ({n_buffers} of them) differ")
    assert all(a == b for a, b in pairs), pairs
    assert differ == 0, (differ, total)

    losses, times = [], []
    reset_launch_counts()
    for _ in range(RESNET_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(run()))
        times.append((time.perf_counter() - t1) * 1e3)
    counts = launch_counts()
    assert g_step._builds == 1, g_step._builds
    assert not any(counts.values()), counts
    # lr 0.1 without a warm-up on one repeated batch: the loss overshoots
    # inside the window once the velocity has built up, so the window is
    # held to the first step's loss, not to its own first
    assert np.isfinite(losses).all() and losses[-1] < first, (first, losses)
    p50 = float(np.median(times))
    ips = RESNET_BATCH / (p50 / 1e3)
    print(f"resnet: {RESNET_STEPS} graph steps, losses "
          + ", ".join(f"{v:.4f}" for v in losses) + f"; step p50 "
          f"{p50:.3f} ms, p99 {float(np.percentile(times, 99)):.3f}; "
          f"{ips:.1f} images/s; MFU {ips * flops / PEAK_FLOPS[torch.bfloat16]:.4f}"
          f" ({flops} FLOPs an image a step by the convolutions' and "
          f"linears' shapes vs 989e12 FLOP/s); one build; no port kernel "
          f"on the path (launch counts all 0)")
    totals = {}
    _breakdown("resnet graph", run, top=10, totals=totals,
               groups=RESNET_GROUPS)
    print(f"resnet graph: {totals.get('kernels', 0):.1f} kernels and "
          f"{totals.get('device_ms', 0.0):.3f} ms device time a step "
          "(profiled)")
    totals = {}
    _breakdown("resnet eager", run_eager, top=4, totals=totals,
               groups=RESNET_GROUPS)
    turns = [_turn(tag, {"graph": run, "eager": run_eager}[tag],
                   RESNET_TURN_STEPS, RESNET_BATCH, flops)
             for tag in RESNET_TURNS]
    for tag in ("graph", "eager"):
        mine = [t for t in turns if t["turn"] == tag]
        print(f"resnet turns, {tag}: step p50 " + " / ".join(
            f"{t['p50_ms']:.3f}" for t in mine) + " ms; device " + " / ".join(
            f"{t['device_ms']:.3f}" for t in mine) + " ms a step; images/s "
            + " / ".join(
                f"{t['tokens_per_s']:.1f}" for t in mine) + "; MFU "
            + " / ".join(f"{t['mfu']:.4f}" for t in mine))
    del eager, e_opt, e_step, run_eager
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    float(run())
    peak = torch.cuda.max_memory_allocated()
    print(f"resnet: max_memory_allocated {build_peak / 2**30:.3f} GiB over "
          f"the build and step 1 (the eager warm-up's activations, then "
          f"the graph's pool), {(build_peak - before_build) / 2**30:.3f} GiB"
          f" above the {before_build / 2**30:.3f} allocated before it (both"
          f" models); over a later graph step "
          f"{peak / 2**30:.3f} GiB, {(peak - before) / 2**30:.3f} above the "
          f"{before / 2**30:.3f} before it (the activations sit in the "
          f"graph's pool: reserved {torch.cuda.memory_reserved() / 2**30:.3f}"
          f" GiB)")

    model.eval()
    totals = {}
    with torch.no_grad():
        evaluate = _o1(lambda: model(x))
        logits = evaluate()
        wall_ms = _p50_ms(evaluate, 10)
        _breakdown("resnet eval", evaluate, top=4, totals=totals,
                   groups=RESNET_GROUPS)
    assert tuple(logits.shape) == (RESNET_BATCH, 1000) and bool(
        torch.isfinite(logits.float()).all())
    ms = totals.get("device_ms", 0.0)
    print(f"resnet eval: O1 forward at batch {RESNET_BATCH} {wall_ms:.3f} ms "
          f"a batch (p50, host clock, synchronized), "
          f"{RESNET_BATCH / (wall_ms / 1e3):.1f} images/s; {ms:.3f} ms of "
          f"device time over {totals.get('kernels', 0):.0f} kernels "
          f"(profiled; busy {ms / wall_ms:.3f} of the p50)")
    _resnet_export(model)
    del g_opt, g_step, run, model, logits
    gc.collect()
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _resnet_parity()
    _resnet_zoo()
    torch.backends.cudnn.deterministic = deterministic
    print(f"resnet: {time.perf_counter() - t0:.1f} s wall")
    return counts


# ---------------------------------------------------------------------------
# phase 12: data-parallel training, the reference's config 3 (GPT-3 1.3B)
# ---------------------------------------------------------------------------

# config 3's attention: batch 4 x 2048 tokens, 16 heads of 128, causal
GPT3_ATTN = (4, 2048, 16, 128)
GPT3_WARMUP, GPT3_STEPS = 2, 5
# the graph against the eager step, bit for bit: steps, at full width with
# the depth cut (two full-depth sets of state beside the graph's pools
# would take ~42 GB)
GPT3_BITWISE_LAYERS, GPT3_BITWISE_STEPS = 4, 2
# the synthetic token set: sequences of 2049 ids from a seed, drawn from
# the vocabulary's first GPT3_TOKEN_IDS ids (a skewed set, so that the
# loss falls over a few steps)
GPT3_SEQUENCES, GPT3_TOKEN_IDS = 8, 4096
GPT3_KERNELS = {"flash_attention_fwd": 24, "flash_attention_bwd_dq": 24,
                "flash_attention_bwd_dkv": 24, "cross_entropy_fwd": 1,
                "cross_entropy_bwd": 1, "adam_update": 1}


def check_flash_gpt3():
    """The bf16 flash forward, dQ and dK/dV at config 3's shape
    (GPT3_ATTN, causal) against their fp32 twins within the bf16
    criteria, then timed (`_flash_shape_rows`). Rows ``<counter>@gpt3``;
    their launches are the gpt3_dp phase's."""
    b, n, h, d = GPT3_ATTN
    q, k, v = _fused_qkv(n, torch.bfloat16, seed=2048, heads=h, head_dim=d,
                         batch=b)
    name = f"flash bf16 gpt3_1p3b ({b}, {n}, {h}, {d}) causal=True"
    err_fwd = _check_flash_case(name, q, k, v, True)
    err_dq, err_dkv = _check_flash_bwd_case(f"{name} bwd", q, k, v, True,
                                            seed=2049)
    return _flash_shape_rows(q, k, v, True, 2049, (err_fwd, err_dq, err_dkv),
                             "gpt3", "config 3's shape")


def check_adam_gpt3():
    """The AdamW update at gpt3_1p3b's tensor list (bf16 parameters, fp32
    masters and moments, every tensor decaying, as the gpt3_dp phase runs
    it) against its twin bit for bit over 3 steps (`_check_adam_case`;
    both states at once, ~42 GB), then timed. Row ``adam_update@gpt3``."""
    model = GPTForCausalLM(gpt3_1p3b(), device="cuda", seed=0)
    shapes = [tuple(p.shape) for p in model.parameters()]
    del model
    torch.cuda.empty_cache()
    n = sum(int(np.prod(s)) for s in shapes)
    tag = f"bf16 + masters, gpt3_1p3b ({len(shapes)} tensors, {n} elements)"
    decays = [True] * len(shapes)
    err, state = _check_adam_case(tag, shapes, torch.bfloat16, True, decays)
    torch.cuda.empty_cache()
    params, grads, m1, m2, mw = state
    lr = torch.full((), TRAIN_LR, device="cuda")
    t = torch.full((), 4.0, device="cuda")
    args = (params, grads, m1, m2, mw, decays, lr, t, 0.9, 0.999, 1e-8,
            0.01)
    nbytes = au.update_bytes(params, mw)
    bound, by = _bound_ms(nbytes, 15 * n, torch.float32)
    ms, host_ms = _timed(lambda: au.adam_update(*args), iters=10)
    plain_ms = _cuda_ms(lambda: au.adam_update_reference(*args), iters=2,
                        warmup=1)
    row = {"name": "adam_update@gpt3", "counter": "adam_update",
           "route": "cuda", "source": "paddle_tpu_torch/csrc/adam_update.cu",
           "replaces": ADAM_REPLACES, "max_abs_err": err, "ms": ms,
           "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": by, "library_ms": None, "bytes": nbytes,
           "shape": f"gpt3_1p3b's {len(shapes)} tensors ({n} elements), "
                    f"bf16 params + fp32 masters and moments, every tensor "
                    f"decaying",
           "note": "library_ms null: no PyTorch call computes Paddle's "
                   "formula (torch._fused_adamw_ adds epsilon after the "
                   "bias correction)"}
    print(f"  adam_update at gpt3_1p3b: {ms:.4f} ms (host {host_ms:.4f}), "
          f"twin {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}, {nbytes} "
          f"bytes)")
    return [row]


def _nccl_world1():
    """`init_parallel_env()` with no arguments on the card: NCCL, one
    rank. Each primitive on CUDA tensors gives the world-1 answer; one
    all_reduce captured in a CUDA graph (with a copy before it and a
    product after it) replays to the right values."""
    env = dist.init_parallel_env()
    backend = dist.get_backend()
    print(f"gpt3_dp: init_parallel_env() -> backend {backend}, rank "
          f"{env.rank} of {env.world_size}, card {env.device_id}")
    assert backend == "nccl" and env.world_size == 1, backend
    x = torch.arange(1, 7, dtype=torch.float32, device="cuda")
    for op in ("sum", "max", "min", "prod", "avg"):
        for dtype in (torch.float32, torch.bfloat16):
            t = x.to(dtype)
            dist.all_reduce(t, op=op)
            assert torch.equal(t, x.to(dtype)), (op, dtype, t)
    t = x.clone()
    task = dist.all_reduce(t, sync_op=False)
    task.wait()
    assert torch.equal(t, x)
    t = x.clone()
    dist.broadcast(t, src=0)
    assert torch.equal(t, x)
    got, cat = [], torch.zeros_like(x)
    dist.all_gather(got, x)
    dist.all_gather(cat, x)
    assert len(got) == 1 and torch.equal(got[0], x) and torch.equal(cat, x)
    out = torch.zeros_like(x)
    dist.reduce_scatter(out, [x])
    assert torch.equal(out, x)
    dist.reduce_scatter(out, [x, 2 * x])
    assert torch.equal(out, 3 * x)
    out = torch.zeros_like(x)
    dist.scatter(out, [x], src=0)
    assert torch.equal(out, x)
    outs = []
    dist.alltoall([x], outs)
    assert torch.equal(outs[0], x)
    out = torch.zeros_like(x)
    dist.alltoall_single(x, out)
    assert torch.equal(out, x)
    objs = []
    dist.all_gather_object(objs, {"rank": 0})
    assert objs == [{"rank": 0}]
    inbox = torch.zeros_like(x)
    dist.send(x, dst=0)
    dist.recv(inbox, src=0)
    assert torch.equal(inbox, x)
    dist.barrier()

    src = torch.randn(1 << 20, device="cuda")
    buf = torch.empty_like(src)

    def program():
        buf.copy_(src)
        dist.all_reduce(buf)
        return buf.mul_(2)

    warm_up(program)
    torch.cuda.synchronize()
    replay, out = capture_graph(program)
    for _ in range(3):
        src.normal_()
        replay()
        torch.cuda.synchronize()
        assert torch.equal(out, 2 * src)
    eager_ms, graph_ms = _cuda_ms(program), _cuda_ms(replay)
    print(f"gpt3_dp: every primitive gives the world-1 answer on CUDA "
          f"tensors over NCCL (fp32 and bf16 all_reduce by sum, max, min, "
          f"prod, avg); one all_reduce of 4 MiB captured in a CUDA graph "
          f"with a copy before it and a product after it: 3 replays right, "
          f"{graph_ms:.4f} ms a replay against {eager_ms:.4f} ms eager")


def _gpt3_batches(ids, labels, steps):
    """`steps` batches of GPT3_ATTN[0] sequences, dealt by
    DistributedBatchSampler over the token set epoch after epoch."""
    sampler = DistributedBatchSampler(range(len(ids)),
                                      batch_size=GPT3_ATTN[0], shuffle=True)
    out, epoch = [], 0
    while len(out) < steps:
        sampler.set_epoch(epoch)
        epoch += 1
        for batch in sampler:
            idx = torch.tensor(batch, device=ids.device)
            out.append((ids[idx], labels[idx]))
    return out[:steps]


def _gpt3_fleet(cfg):
    """gpt3_1p3b of `cfg` in bf16 from seed 0 through fleet: the model,
    the optimizer (`distributed_optimizer` of AdamW(multi_precision)) and
    its TrainStep over `distributed_model`."""
    inner = GPTForCausalLM(cfg, device="cuda", seed=0).to(torch.bfloat16)
    inner.train()
    model = fleet.distributed_model(inner)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=TRAIN_LR, weight_decay=0.01,
        parameters=inner.parameters(), multi_precision=True))
    return inner, opt, TrainStep(model, GPTPretrainingCriterion(), opt)


def gpt3_dp_phase():
    """The reference's config 3 at world size 1: NCCL's primitives and a
    captured all_reduce, then gpt3_1p3b (bf16, batch 4 x 2048, fused CE,
    AdamW(multi_precision)) through fleet's collective mode and one
    TrainStep graph: the graph bit for bit with the eager step at depth
    GPT3_BITWISE_LAYERS, then at full depth GPT3_WARMUP steps and
    GPT3_STEPS counted ones. Returns the counted steps' launches."""
    t0 = time.perf_counter()
    _nccl_world1()
    fleet.init(is_collective=True)
    hcg = fleet.get_hybrid_communicate_group()
    assert hcg.get_data_parallel_world_size() == 1
    set_flags({"FLAGS_use_fused_cross_entropy": True})
    dropout0 = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfg = gpt3_1p3b(**dropout0)
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, GPT3_TOKEN_IDS,
                           (GPT3_SEQUENCES, cfg.max_position_embeddings + 1),
                           generator=g, device="cuda")
    ids, labels = tokens[:, :-1].contiguous(), tokens[:, 1:].contiguous()
    batches = _gpt3_batches(ids, labels, GPT3_WARMUP + GPT3_STEPS)
    b, seq = ids[:GPT3_ATTN[0]].shape

    pair = [_gpt3_fleet(gpt3_1p3b(num_hidden_layers=GPT3_BITWISE_LAYERS,
                                  **dropout0)) for _ in range(2)]
    losses = [(float(pair[0][2](*batches[i])),
               float(pair[1][2]._step_eager(*batches[i])))
              for i in range(GPT3_BITWISE_STEPS)]
    differ, total = _count_differing(_state_bits(*pair[0][:2]),
                                     _state_bits(*pair[1][:2]))
    print(f"gpt3_dp: graph vs eager at full width, {GPT3_BITWISE_LAYERS} "
          f"layers, {GPT3_BITWISE_STEPS} steps: losses " + ", ".join(
              f"{a:.6f}/{c:.6f}" for a, c in losses)
          + f"; {differ} of {total} elements of parameters, masters and "
          f"moments differ")
    assert all(a == c for a, c in losses) and differ == 0, (losses, differ)
    del pair
    gc.collect()
    torch.cuda.empty_cache()

    inner, opt, step = _gpt3_fleet(cfg)
    n_params = inner.num_params()
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    t_build = time.perf_counter()
    losses = [float(step(*batches[0]))]
    build_s = time.perf_counter() - t_build
    build_gib = (torch.cuda.memory_reserved() - reserved) / 2**30
    losses += [float(step(*x)) for x in batches[1:GPT3_WARMUP]]
    reset_launch_counts()
    times = []
    for x in batches[GPT3_WARMUP:]:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(step(*x)))
        times.append((time.perf_counter() - t1) * 1e3)
    counts = launch_counts()
    for name, per_step in GPT3_KERNELS.items():
        assert counts[name] == per_step * GPT3_STEPS, (name, counts)
    ln_v = float(np.log(cfg.vocab_size))
    assert step._builds == 1, step._builds
    assert all(np.isfinite(losses)), losses
    assert abs(losses[0] - ln_v) <= 0.5 and losses[-1] < losses[0], losses
    run = lambda: step(*batches[-1])             # noqa: E731
    device_ms, host_ms = _timed(run, iters=GPT3_STEPS, warmup=0)
    totals = {}
    _breakdown("gpt3_dp graph", run, totals=totals)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    float(run())
    peak = torch.cuda.max_memory_allocated()
    tokens_per_step = b * seq
    flops = inner.flops_per_token(seq)
    p50 = float(np.median(times))
    p99 = float(np.percentile(times, 99))
    tps = tokens_per_step / (p50 / 1e3)
    print(f"gpt3_dp: gpt3_1p3b ({n_params} parameters) bf16, fleet "
          f"collective mode, AdamW(multi_precision), batch {b} x {seq} "
          f"through DistributedBatchSampler, one TrainStep graph; build "
          f"{build_s:.2f} s (warm-up + capture, {build_gib:.3f} GiB more "
          f"reserved); losses {losses[0]:.4f} (first; ln V {ln_v:.4f}) -> "
          + ", ".join(f"{x:.4f}" for x in losses[1:]))
    print(f"gpt3_dp: step ms p50 {p50:.3f}, p99 {p99:.3f} (min "
          f"{min(times):.3f}, max {max(times):.3f}) over {GPT3_STEPS} steps; "
          f"device {device_ms:.3f} ms a step (host {host_ms:.3f} ms a call "
          f"behind the sleep: the replays fill the launch queue, so it "
          f"includes waits); {totals.get('kernels', 0):.1f} kernels a step "
          f"(profiler, {totals.get('device_ms', 0.0):.3f} ms device time); "
          f"{tps:.1f} tokens/s; MFU {tps * flops / PEAK_FLOPS[torch.bfloat16]:.4f} "
          f"({flops} FLOPs/token vs 989e12 FLOP/s)")
    print(f"gpt3_dp: max_memory_allocated {peak / 2**30:.3f} GiB over a "
          f"step ({before / 2**30:.3f} GiB allocated before it: weights, "
          f"masters, moments); reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB (the graph's "
          f"activations sit in its pool)")
    print(f"gpt3_dp: launches a step " + json.dumps(
        {k: counts[k] / GPT3_STEPS for k in GPT3_KERNELS}))
    set_flags({"FLAGS_use_fused_cross_entropy": False})
    del inner, opt, step, run
    # the fleet holds the last distributed optimizer (the reference's
    # state passthrough) and its groups: a fresh one leaves nothing behind
    fleet._get_fleet().__init__()
    dist.destroy_process_group()
    print(f"gpt3_dp: {time.perf_counter() - t0:.1f} s wall")
    return counts


def _phase_memory(phase):
    """After `phase`: the device memory still allocated once the cyclic
    collector has run (what the script or the port holds into the next
    phase), beside what was allocated before the collection."""
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"memory after {phase}: {torch.cuda.memory_allocated() / 2**30:.3f}"
          f" GiB allocated ({before / 2**30:.3f} before gc.collect)",
          flush=True)


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
    _flash_d128_info()
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
    append_cast, scatter_cast = check_append_cast(), check_scatter_cast()
    adam_rows = check_adam_update()
    rows = {"serve": [check_flash(), paged, fused, check_keyed_draw(),
                      check_sampler_filter(), scatter],
            "serve_int8": [paged_int8, fused_int8, scatter_int8],
            "train": check_flash_bwd() + check_ce() + adam_rows[:1],
            "train_guard": adam_rows[1:] + check_finite_check(),
            "fused_ln": [check_fused_ln()],
            "serve_tenancy": [check_lora_delta()],
            "serve_kv_mixed_bfloat16": [append_cast[0], scatter_cast[0]],
            "serve_kv_mixed_float32": [append_cast[1], scatter_cast[1]],
            "generate": [check_keyed_draw_rows()],
            "vit": check_flash_vit()}
    for path, more in check_float16().items():
        rows.setdefault(path, []).extend(more)
    _phase_memory("the kernels phase")
    paths = {}
    paths["serve"], bf16_greedy, model = serve()
    _phase_memory("serve")
    paths["serve_int8"] = serve_int8(bf16_greedy)
    _phase_memory("serve_int8")
    paths["serve_pipelined"] = serve_pipelined(model)
    paths["serve_pipelined_int8"] = serve_pipelined(model, kv_dtype="int8")
    del model
    _phase_memory("serve_pipelined (both)")
    paths["serve_tenancy"] = serve_tenancy()
    _phase_memory("serve_tenancy")
    paths.update(serve_kv_mixed())
    _phase_memory("serve_kv_mixed")
    paths["generate"] = generate_phase()
    _phase_memory("generate")
    paths["serve_resilience"] = serve_resilience()
    _phase_memory("serve_resilience")
    serve_resume()
    parity()
    parity(kv_dtype="int8")
    _phase_memory("serve_resume, parity")
    paths["train"] = train()
    _phase_memory("train")
    train_parity()
    _phase_memory("train_parity")
    paths["train_amp"] = train_amp()["O1"]
    _phase_memory("train_amp")
    adamw_row = next(row for row in rows["train"]
                     if row["name"] == "adam_update")
    train_optimizers(adamw_row["ms"])
    _phase_memory("train_optimizers")
    paths["train_scaler"] = train_scaler()
    paths["train_guard"] = train_guard()
    _phase_memory("train_guard")
    paths["train_resume"] = train_resume()
    _phase_memory("train_scaler, train_resume")
    paths["export"] = export_phase()
    _phase_memory("export")
    paths["predictor"] = predictor_phase()
    _phase_memory("predictor")
    paths["async_save"] = async_save_phase()
    _phase_memory("async_save")
    paths["fused_ln"] = fused_ln_phase()
    _phase_memory("fused_ln")
    paths.update(serve_fp16())
    _phase_memory("serve_fp16")
    paths.update(train_fp16())
    _phase_memory("train_fp16")
    paths["fused_ln_fp16"] = fused_ln_phase(dtype=F16)
    _phase_memory("fused_ln_fp16")
    paths.update(vit_phase())
    _phase_memory("vit")
    paths["resnet"] = resnet_phase()
    _phase_memory("resnet")
    rows["gpt3_dp"] = check_flash_gpt3() + check_adam_gpt3()
    _phase_memory("the gpt3_dp kernel checks")
    paths["gpt3_dp"] = gpt3_dp_phase()
    _phase_memory("gpt3_dp")
    # each row's launches come from the path it belongs to (the bf16
    # serving run for flash forward and the fp paged decode, alone and
    # fused with the write, the int8 serving run for the int8 paged decode,
    # alone and fused, the measured training steps for the training
    # kernels, the fused_ln phase for fused_ln; an f16 instantiation's from
    # its float16 path; a row at ViT-L/16's shape from the vit phase's fused
    # window; a row at config 3's shape from the gpt3_dp phase's counted
    # steps), read under the row's launch counter (its name, or
    # `counter` where the name adds the input type); every path's counts
    # are listed beside
    for path, path_rows in rows.items():
        for row in path_rows:
            row["launches"] = paths[path][row.get("counter", row["name"])]
    rows = [row for path_rows in rows.values() for row in path_rows]
    for row in rows:
        row["launches_by_path"] = {
            path: counts[row.get("counter", row["name"])]
            for path, counts in paths.items()}
    alone = ("paged_decode", "paged_decode_int8")
    names = [row["name"] for row in rows]
    assert len(rows) == 53 and len(set(names)) == len(names) and all(
        (row["launches"] == 0) == (row["name"] in alone) for row in rows), rows
    keys = ("name", "counter", "route", "source", "replaces", "launches",
            "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_ms",
            "alone_ms", "append_ms", "turns_ms", "all_sampled_ms",
            "greedy_ms", "bytes_bound_ms", "int32_bound_ms",
            "int32_bound_all_sampled_ms", "top_p_only_ms",
            "first_ms", "prefill_ms", "prefill_first_ms",
            "prefill_library_ms", "prefill_bound_ms", "by_shape",
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
    import sys
    if sys.argv[1:2] == ["--resume-child"]:
        resume_child(*sys.argv[2:5])
    elif sys.argv[1:2] == ["--train-resume-child"]:
        train_resume_child(*sys.argv[2:4])
    else:
        main()
