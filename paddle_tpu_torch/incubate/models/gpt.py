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
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ...device import resolve_device
from ...nn import functional as F

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "GPTPretrainingCriterion", "gpt2_124m",
           "gpt2_355m", "gpt3_1p3b", "gpt3_6p7b"]


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

    def forward(self, x, cache=None):
        b, n = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).view(b, n, 3, self.num_heads, self.head_dim)
        # strided views of the fused projection: the flash kernel reads
        # them in place
        q, k, v = qkv.unbind(2)
        if cache is not None and hasattr(cache, "block_tables"):
            # paged serving cache (serving/cache.py PagedCacheView)
            return self._paged_decode_step(q, k, v, cache, b, n)
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
            k_scales=cache.k_scales, v_scales=cache.v_scales)
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
        if position_ids is None:
            steps = torch.arange(n, device=input_ids.device)
            if paged:
                # continuous batching: every slot sits at its OWN position
                position_ids = caches[0].seq_lens.long()[:, None] + steps
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
