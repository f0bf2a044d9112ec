"""GPT model family (decoder-only transformer LM), PyTorch port.

Counterpart of `paddle_tpu/incubate/models/gpt.py`: the configs, the
attention with its dynamic-cache (prefill) and paged (serving decode)
paths, the MLP, the block, the model and the LM head with tied embeddings.
Parameter names match the JAX model's (``gpt.wte.weight``,
``gpt.h.0.attn.qkv_proj.weight``, ...), so `convert.load_jax_state` carries
its weights across; `nn.Linear` keeps torch's ``[out, in]`` weight layout.

Attention routes through `nn.functional.scaled_dot_product_attention` (the
flash kernels for every causal prefill and training step, forward and
backward) and `paged_decode_attention` (the paged kernel for every decode
step). `GPTPretrainingCriterion` is the training loss, over
`nn.functional.cross_entropy` (the fused cross-entropy kernels under
``FLAGS_use_fused_cross_entropy``).

The static cache (`gen_static_caches`, a layer's cache ``(k_buf, v_buf,
pos)`` with buffers ``[B, T, H, D]`` and a position scalar) is the
reference's `_decode_step`: K and V written at ``pos`` in place, each row
r of the chunk attending over positions ``<= pos + r`` with torch ops (the
reference's are XLA einsums, no Pallas kernel). `generate` runs a prompt
through the dynamic-cache path (the flash kernel on the card), fills the
static buffers, and runs the decode steps as one CUDA graph per signature
on the card (the same code eagerly on the CPU); its sampled pick draws
through the keyed-draw kernel. `GPTDecodeStep` is one static-cache decode
step as a module, which `jit.save` exports for `inference.Predictor`.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import math
import weakref

import numpy as np
import torch
from torch import nn

from ...device import resolve_device
from ...kernels import capture_graph, warm_up
from ...kernels.keyed_draw import keyed_draw
from ...nn import functional as F

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "GPTDecodeStep", "GPTPretrainingCriterion",
           "gpt2_124m", "gpt2_355m", "gpt3_1p3b", "gpt3_6p7b"]

# how many `generate` programs (signatures) a model keeps, the last used
GEN_CACHE_SIZE = 4

_FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
# the static-cache decode's mask value, the reference's -1e9 in each float
# type (-inf in float16), as host floats computed once here: a CUDA graph
# capture takes no host-to-device copy, and `torch.export` keeps them
# constants of the program
_DECODE_NEG = {dt: float(torch.tensor(-1e9).to(dt)) for dt in _FLOAT_TYPES}


@dataclass
class GPTConfig:
    vocab_size: int = 50304            # GPT-2's 50257 padded to a multiple of 128
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True


def gpt2_124m(**overrides):
    return GPTConfig(**{**dict(hidden_size=768, num_hidden_layers=12,
                               num_attention_heads=12, intermediate_size=3072),
                        **overrides})


def gpt2_355m(**overrides):
    return GPTConfig(**{**dict(hidden_size=1024, num_hidden_layers=24,
                               num_attention_heads=16, intermediate_size=4096),
                        **overrides})


def gpt3_1p3b(**overrides):
    return GPTConfig(**{**dict(hidden_size=2048, num_hidden_layers=24,
                               num_attention_heads=16, intermediate_size=8192,
                               max_position_embeddings=2048),
                        **overrides})


def gpt3_6p7b(**overrides):
    return GPTConfig(**{**dict(hidden_size=4096, num_hidden_layers=32,
                               num_attention_heads=32, intermediate_size=16384,
                               max_position_embeddings=2048),
                        **overrides})


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.hidden_size = config.hidden_size
        self.qkv_proj = nn.Linear(config.hidden_size, 3 * config.hidden_size,
                                  device=device)
        self.out_proj = nn.Linear(config.hidden_size, config.hidden_size,
                                  device=device)
        self.dropout_p = config.attention_probs_dropout_prob
        self.resid_dropout = nn.Dropout(config.hidden_dropout_prob)
        # sqrt(head_dim) rounded to each float type, as host floats (see
        # _DECODE_NEG): the static-cache decode's score divisor
        self._root = {dt: float(torch.tensor(float(self.head_dim), dtype=dt)
                                .sqrt()) for dt in _FLOAT_TYPES}

    def forward(self, x, cache=None):
        b, n = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).view(b, n, 3, self.num_heads, self.head_dim)
        # strided views of the fused projection: the flash kernel reads
        # them in place
        q, k, v = qkv.unbind(2)
        if cache is not None and hasattr(cache, "block_tables"):
            # paged serving cache (serving/cache.py PagedCacheView)
            return self._paged_decode_step(q, k, v, cache, b, n)
        if cache is not None and len(cache) == 3:
            # static cache: [B, T, H, D] buffers and a write position
            return self._decode_step(q, k, v, cache, b, n)
        if cache is not None:
            pk, pv = cache
            if pk.shape[1]:
                k = torch.cat([pk, k], dim=1)
                v = torch.cat([pv, v], dim=1)
            cache = (k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.dropout_p if self.training else 0.0,
            training=self.training)
        out = self.resid_dropout(self.out_proj(
            out.reshape(b, n, self.hidden_size)))
        return (out, cache) if cache is not None else out

    def _decode_step(self, q, k, v, cache, b, n):
        """Attention against a static cache ``(k_buf, v_buf, pos)``: write
        this chunk's K/V at positions ``pos .. pos + n - 1`` of the
        buffers (in place, cast to their dtype), then row r attends over
        positions ``<= pos + r``. As the reference's: scores in q's dtype
        over sqrt(head_dim), masked with -1e9 in q's dtype, the softmax in
        fp32, the probabilities cast back before P.V. `pos` may be a
        device scalar (a CUDA graph replay reads it there). Returns
        ``(out, (k_buf, v_buf, pos))``: the same buffers, written."""
        k_buf, v_buf, pos = cache
        pos = torch.as_tensor(pos, device=q.device).long()
        rows = pos + torch.arange(n, device=q.device)
        k_buf.index_copy_(1, rows, k.to(k_buf.dtype))
        v_buf.index_copy_(1, rows, v.to(v_buf.dtype))
        t = k_buf.shape[1]
        qh = q.transpose(1, 2)                               # [B, H, n, D]
        # sqrt(head_dim) rounded to q's dtype
        scores = (qh @ k_buf.permute(0, 2, 3, 1)) / self._root[q.dtype]
        valid = torch.arange(t, device=q.device)[None, :] <= rows[:, None]
        # -1e9 in q's dtype, as the reference's: -inf in float16
        scores = scores.masked_fill(~valid, _DECODE_NEG[scores.dtype])
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        out = probs @ v_buf.permute(0, 2, 1, 3).to(q.dtype)  # [B, H, n, D]
        out = self.out_proj(out.transpose(1, 2).reshape(b, n,
                                                        self.hidden_size))
        return out, (k_buf, v_buf, pos)

    def _paged_decode_step(self, q, k, v, cache, b, n):
        """Single-token attention against the paged block pool: write this
        step's K/V at each slot's write position (in place; requantizing
        the write block with int8 pools), attend over positions <= seq_len
        through the paged kernel."""
        if n != 1:
            raise ValueError(
                "paged decode is single-token; prefill goes through the "
                f"dynamic-cache path (got a {n}-token chunk)")
        # int8 KV: the view's scales are written in place with the pools
        # and handed back out beside them
        out, *pools = F.paged_decode_attention(
            q, k, v, cache.k_pool, cache.v_pool, cache.block_tables,
            cache.seq_lens, cache.active, cache.block_size,
            k_scales=cache.k_scales, v_scales=cache.v_scales,
            kernel=cache.kernel)
        out = self.out_proj(out.reshape(b, n, self.hidden_size))
        return out, cache.updated(*pools)


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        self.fc_in = nn.Linear(config.hidden_size, config.intermediate_size,
                               device=device)
        self.fc_out = nn.Linear(config.intermediate_size, config.hidden_size,
                                device=device)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        return self.dropout(self.fc_out(
            torch.nn.functional.gelu(self.fc_in(x), approximate="tanh")))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(config.hidden_size,
                                 eps=config.layer_norm_epsilon, device=device)
        self.attn = GPTAttention(config, device=device)
        self.ln_2 = nn.LayerNorm(config.hidden_size,
                                 eps=config.layer_norm_epsilon, device=device)
        self.mlp = GPTMLP(config, device=device)

    def forward(self, x, cache=None):
        if cache is not None:
            a, cache = self.attn(self.ln_1(x), cache)
        else:
            a = self.attn(self.ln_1(x))
        x = x + a
        x = x + self.mlp(self.ln_2(x))
        return (x, cache) if cache is not None else x


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size,
                                device=device)
        self.wpe = nn.Embedding(config.max_position_embeddings,
                                config.hidden_size, device=device)
        self.drop = nn.Dropout(config.hidden_dropout_prob)
        self.h = nn.ModuleList([GPTBlock(config, device=device)
                                for _ in range(config.num_hidden_layers)])
        self.ln_f = nn.LayerNorm(config.hidden_size,
                                 eps=config.layer_norm_epsilon, device=device)

    def forward(self, input_ids, position_ids=None, caches=None):
        n = input_ids.shape[1]
        paged = caches is not None and hasattr(caches[0], "block_tables")
        static = caches is not None and not paged and len(caches[0]) == 3
        if position_ids is None:
            steps = torch.arange(n, device=input_ids.device)
            if paged:
                # continuous batching: every slot sits at its OWN position
                position_ids = caches[0].seq_lens.long()[:, None] + steps
            elif static:
                # the static cache's shared write position
                pos = torch.as_tensor(caches[0][2],
                                      device=input_ids.device).long()
                position_ids = (pos + steps)[None, :]
            else:
                past = caches[0][0].shape[1] if caches is not None else 0
                position_ids = (steps + past)[None, :]
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        if caches is None:
            for block in self.h:
                x = block(x)
            return self.ln_f(x)
        new_caches = []
        for block, cache in zip(self.h, caches):
            x, c = block(x, cache)
            new_caches.append(c)
        return self.ln_f(x), new_caches


class GPTForCausalLM(nn.Module):
    """GPT LM. ``device=None`` means ``cuda`` (raising where there is no
    card); weights are initialised from `seed` through a `torch.Generator`
    on that device: N(0, initializer_range) for every Linear and Embedding
    weight, zeros for biases, LayerNorm at (1, 0)."""

    def __init__(self, config: GPTConfig, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.gpt = GPTModel(config, device=device)
        if config.tie_word_embeddings:
            self.lm_head = None
        else:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                     bias=False, device=device)
        # generate's programs by signature, the GEN_CACHE_SIZE last used,
        # and how many were built
        self._gen_cache = OrderedDict()
        self.gen_builds = 0
        gen = torch.Generator(device=device).manual_seed(int(seed))
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, (nn.Linear, nn.Embedding)):
                    module.weight.normal_(0.0, config.initializer_range,
                                          generator=gen)
                    if getattr(module, "bias", None) is not None:
                        module.bias.zero_()

    def gen_caches(self, batch_size):
        """Empty per-layer (k, v) caches ``[B, 0, H, D]`` in the weights'
        dtype and device, for the dynamic-cache (prefill) path."""
        cfg = self.config
        w = self.gpt.wte.weight
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        empty = torch.zeros((batch_size, 0, cfg.num_attention_heads,
                             head_dim), dtype=w.dtype, device=w.device)
        return [(empty, empty) for _ in range(cfg.num_hidden_layers)]

    def gen_static_caches(self, batch_size, max_len, dtype=None):
        """Static caches for `generate`'s decode loop: per layer ``(k_buf,
        v_buf)`` zeros ``[B, max_len, H, D]`` in `dtype` (the weights'
        when None) on the weights' device; a layer's cache is that pair
        and a position, ``(k_buf, v_buf, pos)``."""
        cfg = self.config
        w = self.gpt.wte.weight
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        shape = (batch_size, max_len, cfg.num_attention_heads, head_dim)
        return [(torch.zeros(shape, dtype=dtype or w.dtype, device=w.device),
                 torch.zeros(shape, dtype=dtype or w.dtype, device=w.device))
                for _ in range(cfg.num_hidden_layers)]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 top_k=1, top_p=1.0, temperature=1.0, seed=0):
        """Batched autoregressive decoding, the reference's: the prompt
        ``[B, P]`` through the dynamic-cache forward (the flash kernel on
        the card), its K/V into static buffers ``[B, P + N, H, D]``, then N
        tokens, each the pick over the last logits: greedy (argmax), or
        with ``do_sample`` temperature, top-k (the k-th largest of a sort;
        ties survive), top-p over what top-k left (`apply_top_p`) and the
        draw ``categorical(fold_in(PRNGKey(seed), i), logits [B, V])``
        through the keyed-draw kernel (row b at counters b V + v, as jax
        draws the batch under one key). Returns the new ids ``[B, N]``
        int32 on the model's device.

        The decode steps after the first pick are one program per
        signature ``(B, P, N, do_sample, top_k, top_p, temperature)``
        (`_gen_cache`; `gen_builds` counts the builds, the reference's
        one trace a signature): on the card one CUDA graph, captured once
        and replayed N - 1 times, the step index a device scalar it
        advances itself; on the CPU the same code eagerly. Each program
        holds its static buffers (and on the card its graph's memory
        pool), so only the `GEN_CACHE_SIZE` signatures used last keep
        theirs: a signature used again after that is built again, and
        counted."""
        return self._generate(input_ids, max_new_tokens, do_sample, top_k,
                              top_p, temperature, seed)

    def _generate(self, input_ids, max_new_tokens=32, do_sample=False,
                  top_k=1, top_p=1.0, temperature=1.0, seed=0, eager=False):
        """`generate`; ``eager=True`` runs the steps launch by launch on the
        card too (the yardstick the graph is timed against)."""
        w = self.gpt.wte.weight
        ids = torch.as_tensor(np.asarray(input_ids.cpu() if torch.is_tensor(
            input_ids) else input_ids)).to(w.device, torch.int64)
        b, p = ids.shape
        n_new = int(max_new_tokens)
        if n_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if p + n_new > self.config.max_position_embeddings:
            raise ValueError(f"prompt ({p}) + max_new_tokens ({n_new}) "
                             f"exceeds max_position_embeddings "
                             f"({self.config.max_position_embeddings})")
        sig = (b, p, n_new, bool(do_sample), int(top_k),
               float(top_p if top_p is not None else 1.0), float(temperature))
        # the weights' type and device too: buffers are made in them
        key = sig + (w.dtype, w.device)
        program = self._gen_cache.get(key)
        if program is None:
            while len(self._gen_cache) >= GEN_CACHE_SIZE:
                self._gen_cache.popitem(last=False)
            program = _Generation(self, sig)
            self._gen_cache[key] = program
            self.gen_builds += 1
        else:
            self._gen_cache.move_to_end(key)
        was_training = self.training
        self.eval()
        try:
            return program.run(ids, seed, eager)
        finally:
            if was_training:
                self.train()

    def forward(self, input_ids, position_ids=None, caches=None):
        if caches is None:
            hidden = self.gpt(input_ids, position_ids)
        else:
            hidden, caches = self.gpt(input_ids, position_ids, caches)
        if self.lm_head is not None:
            logits = self.lm_head(hidden)
        else:
            # tied: logits = hidden @ wte^T
            logits = torch.nn.functional.linear(hidden, self.gpt.wte.weight)
        return logits if caches is None else (logits, caches)

    def num_params(self, include_embeddings=True):
        """Parameter count (the tied embedding once); without the token
        embedding when ``include_embeddings=False``."""
        return sum(p.numel() for name, p in self.named_parameters()
                   if include_embeddings or "wte" not in name)

    def flops_per_token(self, seq_len, training=True):
        """Model FLOPs per token, PaLM-appendix counting: training =
        6N + 12*L*h*s (forward and backward), inference = 2N + 4*L*h*s."""
        n = self.num_params()
        cfg = self.config
        attn_fwd = 4 * cfg.num_hidden_layers * cfg.hidden_size * seq_len
        if training:
            return 6 * n + 3 * attn_fwd
        return 2 * n + attn_fwd


class _Generation:
    """`generate`'s program for one signature: the static buffers ``[L, B,
    P + N, H, D]``, the tokens ``[B, N]`` and the step index (a device
    scalar), and on the card the decode step's CUDA graph, captured at the
    first call after one eager warm-up step on a side stream."""

    def __init__(self, model, sig):
        b, p, n_new, self.sampled, self.top_k, self.top_p, self.temp = sig
        cfg = model.config
        w = model.gpt.wte.weight
        # weakly: the model's `_gen_cache` holds this program, so a strong
        # reference would make a cycle that keeps the model, its buffers
        # and its graph alive past its last user reference
        self._model = weakref.ref(model)
        self.b, self.p, self.n_new = b, p, n_new
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        shape = (cfg.num_hidden_layers, b, p + n_new,
                 cfg.num_attention_heads, head_dim)
        self.k_bufs = torch.zeros(shape, dtype=w.dtype, device=w.device)
        self.v_bufs = torch.zeros(shape, dtype=w.dtype, device=w.device)
        self.tokens = torch.zeros((b, n_new), dtype=torch.int32,
                                  device=w.device)
        self.step = torch.zeros((), dtype=torch.int64, device=w.device)
        self.seeds = torch.zeros(b, dtype=torch.int32, device=w.device)
        self.ones = torch.ones(b, dtype=torch.float32, device=w.device)
        self.graph = None       # the captured step's replay function

    @property
    def model(self):
        return self._model()

    def pick(self, logits, step):
        """Each row's next token, int32 ``[B]``, from fp32-able logits
        ``[B, V]`` at step index `step` (a device scalar). The filter is
        torch ops, as the reference's XLA ops, and not `sampler_filter`:
        generate's top-p is measured over what top-k left, the engine's
        filter over the whole row. The draw is the keyed-draw kernel."""
        if not self.sampled:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        from ...serving.sampling import apply_top_p
        lg = logits.float() / max(self.temp, 1e-6)
        if self.top_k and self.top_k > 0:
            kth = torch.sort(lg, dim=-1).values[:, -self.top_k][:, None]
            lg = lg.masked_fill(lg < kth, float("-inf"))
        if self.top_p < 1.0:
            lg = apply_top_p(lg, torch.full((self.b,), self.top_p,
                                            device=lg.device))
        lg = lg.contiguous()
        positions = step.to(torch.int32).expand(self.b).contiguous()
        return keyed_draw(lg, lg, self.ones, self.seeds, positions,
                          row_stride=lg.shape[1])

    def decode_step(self):
        """One decode step at step index i = `step` (1 .. N - 1): the token
        of step i - 1 through the static-cache forward at position P + i -
        1, its pick at fold_in index i into tokens[:, i]; then the index
        advances."""
        i = self.step
        tok = self.tokens.index_select(1, (i - 1)[None]).long()
        pos = i + (self.p - 1)
        caches = [(self.k_bufs[l], self.v_bufs[l], pos)
                  for l in range(self.k_bufs.shape[0])]
        logits, _ = self.model(tok, caches=caches)
        nxt = self.pick(logits[:, -1, :], i)
        self.tokens.index_copy_(1, i[None], nxt[:, None])
        self.step += 1

    def prefill(self, ids, seed):
        """The prompt through the dynamic-cache forward, its K/V into the
        static buffers (zeros past it), the first pick (fold_in index 0)
        into tokens[:, 0] and the step index to 1."""
        logits, kv = self.model(ids, caches=self.model.gen_caches(self.b))
        self.k_bufs.zero_()
        self.v_bufs.zero_()
        for layer, (k, v) in enumerate(kv):
            self.k_bufs[layer, :, :self.p].copy_(k)
            self.v_bufs[layer, :, :self.p].copy_(v)
        self.seeds.fill_(int(np.uint32(int(seed) & 0xFFFFFFFF)
                             .view(np.int32)))
        self.step.zero_()
        self.tokens[:, 0] = self.pick(logits[:, -1, :], self.step)
        self.step.fill_(1)

    def capture(self):
        """Warm the decode step up once on a side stream (kernels and
        cuBLAS loaded at these shapes), put the step index back, then
        capture one step."""
        warm_up(self.decode_step)
        self.step.fill_(1)
        self.graph = capture_graph(self.decode_step)[0]

    def run(self, ids, seed, eager=False):
        self.prefill(ids, seed)
        if self.n_new > 1 and ids.device.type == "cuda" and not eager:
            if self.graph is None:
                self.capture()
            for _ in range(self.n_new - 1):
                self.graph()
        else:
            for _ in range(self.n_new - 1):
                self.decode_step()
        return self.tokens.clone()


class GPTDecodeStep(nn.Module):
    """One static-cache decode step: ``(tokens [B, 1], k_bufs [L, B, T, H,
    D], v_bufs, pos) -> (logits [B, 1, V], new_k, new_v)``, the
    reference's `GPTDecodeStep`. The step writes this token's K and V into
    the buffers in place, so `new_k` / `new_v` are `k_bufs` / `v_bufs`
    (the reference returns fresh arrays). `jit.save` exports it with `pos`
    a 0-d int32 tensor (``InputSpec([], "int32")``): the program keeps the
    writes as writes into its inputs, and `inference.Predictor` serves
    it, the reference's deploy route for decoding."""

    def __init__(self, model: GPTForCausalLM):
        super().__init__()
        self.model = model

    def forward(self, tokens, k_bufs, v_bufs, pos):
        caches = [(k_bufs[l], v_bufs[l], pos)
                  for l in range(self.model.config.num_hidden_layers)]
        logits, _ = self.model(tokens, caches=caches)
        return logits, k_bufs, v_bufs


class GPTPretrainingCriterion(nn.Module):
    """Language-model loss: mean next-token cross-entropy of logits
    ``[B, N, V]`` against labels ``[B, N]``, rows labelled `ignore_index`
    left out."""

    def __init__(self, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        b, n, v = logits.shape
        return F.cross_entropy(logits.reshape(b * n, v),
                               labels.reshape(b * n),
                               ignore_index=self.ignore_index)
