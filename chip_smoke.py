"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. probe   — a CUDA device must exist; print its name and power limit;
  2. build   — compile every kernel of the serving path with nvcc into
               build/paddle_tpu_torch/ (all sources at once) and print the
               build time and ptxas' register / spill report;
  3. kernels — hold each kernel against its plain PyTorch twin on the card
               at the serving path's shapes, in fp32 (TF32 off) and bf16,
               within the tolerances stated in FLASH_TOL / PAGED_TOL; time
               the kernel, the twin and one PyTorch library call that
               computes the same function (a yardstick the port never
               calls), beside the least time the card could take;
  4. serve   — GPT-2 124M (full width, random weights from a seed, bf16)
               behind `LLMEngine`: 19 requests (16 greedy, 2 sampled, one
               990-token prompt so the 1024 bucket runs), more requests
               than slots; both kernels must have launched (prefill 12 x
               per admission, decode 12 x per step);
  5. parity  — the same fp32 model on the card and on the CPU (the plain
               twins) must give identical greedy tokens for two prompts
               and agree on the prompts' logits.

It then prints one JSON line with every kernel's numbers, the card's
nvidia-smi line, and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import subprocess
import time

import numpy as np
import torch

from paddle_tpu_torch.incubate.models import GPTForCausalLM, gpt2_124m
from paddle_tpu_torch.kernels import (_build, flash_attention as fa,
                                      launch_counts, paged_attention as pa,
                                      reset_launch_counts)
from paddle_tpu_torch.serving import LLMEngine

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
#         the output to bf16 once; one bf16 step is 2^-8 relative, so one
#         rounding flip is allowed (8e-3 relative, 1e-2 absolute near 0).
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 8e-3)}
PAGED_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 8e-3)}
# lse is fp32 on both sides whatever the input type
LSE_TOL = (1e-4, 1e-4)
# fp32 logits of GPT-2 124M on the card (TF32 off) vs the CPU: summation
# order only, through 12 layers
LOGITS_ATOL = 5e-4
# a greedy token counts as decided when its top-2 logprob margin exceeds
# this many times LOGITS_ATOL (parity prompts are chosen so all are)
MARGIN_FACTOR = 4

HEADS, HEAD_DIM = 12, 64


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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

def _fused_qkv(n, dtype, seed, heads=HEADS, head_dim=HEAD_DIM):
    """q, k, v as strided views of one [1, n, 3, H, D] tensor, the layout
    the model's fused projection hands the flash kernel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((1, n, 3, heads, head_dim), generator=g,
                      device="cuda").to(dtype)
    return qkv.unbind(2)


def _check_flash_case(tag, q, k, v, causal):
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    err = _close(tag + " out", out, ref, FLASH_TOL[q.dtype])
    _close(tag + " lse", lse, ref_lse, LSE_TOL)
    return err


def check_flash():
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for n in (40, 1024):
            for causal in (True, False):
                errs[dtype, n, causal] = _check_flash_case(
                    f"flash {name} n={n} causal={causal}",
                    *_fused_qkv(n, dtype, seed=n), causal)
        # off the serving path but compiled in: head_dim 128, and
        # non-causal attention over more keys than queries
        _check_flash_case(f"flash {name} n=40 causal=True D=128",
                          *_fused_qkv(40, dtype, seed=7, heads=4,
                                      head_dim=128), True)
        q = _fused_qkv(40, dtype, seed=8)[0]
        _, k, v = _fused_qkv(100, dtype, seed=9)
        _check_flash_case(f"flash {name} n=40 m=100 causal=False", q, k, v,
                          False)
    # main-path shape: the 1024 prefill bucket, causal, bf16
    n, dtype = 1024, torch.bfloat16
    err = errs[dtype, n, True]
    q, k, v = _fused_qkv(n, dtype, seed=n)
    ms = _cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, True))
    plain_ms = _cuda_ms(lambda: fa.flash_attention_reference(q, k, v, True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = _cuda_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(qt, kt, vt,
                                                        is_causal=True))
    elem = q.element_size()
    nbytes = 4 * n * HEADS * HEAD_DIM * elem + HEADS * n * 4
    pairs = n * (n + 1) // 2
    flops = 4 * HEADS * HEAD_DIM * pairs
    bound, by = _bound_ms(nbytes, flops, dtype)
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "paddle_tpu/kernels/flash_attention.py:90 _fwd_kernel",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
            "shape": f"q,k,v (1, {n}, {HEADS}, {HEAD_DIM}) bf16 causal"}


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


def check_paged():
    bs = 16
    # an empty history, one position before / at / after a block boundary,
    # a long and a full context, and an inactive slot (lens 0 after the
    # where(active, ...) and a table of null block 0)
    lens = [0, 15, 16, 17, 500, 1023, 700, 0]
    # head_dim 64 is the serving path's; 128 is compiled in as well
    for heads, head_dim in ((HEADS, HEAD_DIM), (4, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tables, lens_t = _paged_state(
                1, lens, dtype, seed=1, heads=heads, head_dim=head_dim)
            tables[7] = 0                  # slot 7 is inactive
            out = pa.paged_attention(q, kp[0], vp[0], tables, lens_t, bs)
            ref = pa.paged_decode_reference(q, kp[0], vp[0], tables, lens_t,
                                            bs)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all(), "non-finite output"
            e = _close(f"paged {str(dtype)[6:]} D={head_dim} active slots",
                       out[:7], ref[:7], PAGED_TOL[dtype])
            if head_dim == HEAD_DIM and dtype == torch.bfloat16:
                err = e
    # main-path shape: 8 slots at a full 1024-token context, bf16; 4 layers'
    # pools (~100 MB, twice the L2) rotate so each launch reads cold KV, as
    # a decode step's 12 layers do
    dtype, layers = torch.bfloat16, 4
    full = [1023] * 8
    q, kp, vp, tables, lens_t = _paged_state(layers, full, dtype, seed=2)
    it = iter(range(10 ** 9))

    def rotating(fn):
        def call():
            layer = next(it) % layers
            return fn(q, kp[layer], vp[layer], tables, lens_t, bs)
        return call

    ms = _cuda_ms(rotating(pa.paged_attention))
    plain_ms = _cuda_ms(rotating(pa.paged_decode_reference))
    t_max = tables.shape[1] * bs
    mask = (torch.arange(t_max, device="cuda")[None, :]
            <= lens_t[:, None])[:, None, None, :]

    def library(qq, kk, vv, tab, _lens, _bs):
        kg = kk[tab.long()].reshape(8, t_max, HEADS, HEAD_DIM).transpose(1, 2)
        vg = vv[tab.long()].reshape(8, t_max, HEADS, HEAD_DIM).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            qq[:, :, None, :], kg, vg, attn_mask=mask)

    library_ms = _cuda_ms(rotating(library))
    elem = q.element_size()
    tokens = sum(l + 1 for l in full)
    nbytes = (2 * tokens * HEADS * HEAD_DIM * elem
              + 2 * q.numel() * elem + tables.numel() * 4 + 8 * 4)
    flops = 4 * tokens * HEADS * HEAD_DIM
    bound, by = _bound_ms(nbytes, flops, dtype)
    return {"name": "paged_decode", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": "paddle_tpu/kernels/pallas/paged_attention.py:167 "
                        "_decode_kernel",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
            "shape": "S=8 H=12 D=64 bs=16 M=64, lens 1023, bf16"}


# ---------------------------------------------------------------------------
# phase 4: the serving path at full width
# ---------------------------------------------------------------------------

def serve():
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device="cuda", seed=0).to(torch.bfloat16)
    engine = LLMEngine(model, max_batch_size=8, block_size=16,
                       max_context=1024)
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
    assert counts["flash_attention_fwd"] > 0 and counts["paged_decode"] > 0, \
        counts
    assert counts["paged_decode"] == layers * st["steps"], (counts, st)
    assert counts["flash_attention_fwd"] == layers * st["prefills"], \
        (counts, st)
    assert 1024 in st["prefill_p50_ms"], st["prefill_p50_ms"]
    print(f"serve: {len(reqs)} requests, {st['tokens_generated']} tokens "
          f"in {wall:.3f} s = {st['tokens_generated'] / wall:.1f} tok/s; "
          f"{st['steps']} decode steps, p50 {st['p50_step_ms']:.3f} ms, "
          f"p99 {st['p99_step_ms']:.3f} ms; TTFT p50 "
          f"{st['ttft_p50_ms']:.3f} ms; {st['prefills']} prefills, "
          f"{st['evictions']} evictions; occupancy "
          f"{st['occupancy_mean']:.3f}")
    print("serve: prefill p50 ms by bucket "
          + json.dumps({str(b): round(v, 3)
                        for b, v in st["prefill_p50_ms"].items()}))
    print(f"serve: launches {json.dumps(counts)}")
    return counts


# ---------------------------------------------------------------------------
# phase 5: card vs CPU parity (fp32)
# ---------------------------------------------------------------------------

def _greedy(model, device, prompts, new):
    engine = LLMEngine(model, max_batch_size=2, block_size=16,
                       max_context=64, logprobs_topk=2, device=device)
    reqs = [engine.add_request(p, max_new_tokens=new) for p in prompts]
    engine.run()
    return reqs


def parity():
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
        (req,) = _greedy(cpu_model, "cpu", [p], 16)
        margins = [a[0] - a[1] for a in req.alt_logprobs]
        if min(margins) > MARGIN_FACTOR * LOGITS_ATOL:
            prompts.append((p, req.generated))
    gpu = _greedy(gpu_model, "cuda", [p for p, _ in prompts], 16)
    for (p, cpu_tokens), r in zip(prompts, gpu):
        assert r.generated == cpu_tokens, (r.generated, cpu_tokens)
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
    print("kernels vs plain twins:")
    rows = [check_flash(), check_paged()]
    counts = serve()
    for row in rows:
        row["launches"] = counts[row["name"]]
    parity()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
