"""Vision Transformer (ViT), PyTorch port.

Counterpart of `paddle_tpu/vision/models/vit.py` (`PatchEmbed`,
`VisionTransformer`, `flops_per_image`, `vit_b_16` / `vit_l_16` /
`vit_l_32`), the reference's BASELINE config 5: ViT training with the
encoder blocks fused (`incubate.nn.FusedTransformerEncoderLayer`, the
default) or not (`nn.TransformerEncoderLayer`), both pre-LN with exact
gelu. Parameter names and shapes are the reference's, so
`convert.load_jax_state` carries a JAX model of either path across; the
patch projection is an `nn.Conv2d`, whose ``[out, in, kh, kw]`` weight is
Paddle's layout too.

The sequence is the patches and one class token (197 at 224 / 16), so an
eligible block's attention runs the flash kernels non-causally at a length
that is no multiple of a tile (the kernels mask their ragged edges).

``device=None`` means ``cuda`` and raises where there is no card; pass
``device="cpu"`` for the plain versions. Weights draw from the reference's
initializers through a `torch.Generator` on that device seeded with
`seed`: the class token and position embedding TruncatedNormal(0.02), the
patch projection U(±1/sqrt(fan_in)) (the reference's Conv2D default), the
blocks and the head as their layers draw.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...incubate.nn.fused_transformer import FusedTransformerEncoderLayer
from ...nn import initializer as I
from ...nn.layer.transformer import TransformerEncoderLayer, linear
from ._common import device_and_generator

__all__ = ["PatchEmbed", "VisionTransformer", "vit_b_16", "vit_l_16",
           "vit_l_32"]


class PatchEmbed(nn.Module):
    """Image ``[B, C, H, W]`` -> patch embeddings ``[B, N, E]``: a Conv2d
    with stride = kernel = patch."""

    def __init__(self, img_size=224, patch_size=16, in_chans=3, embed_dim=768,
                 device=None, generator=None):
        super().__init__()
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size, device=device)
        bound = 1.0 / math.sqrt(in_chans * patch_size * patch_size)
        for p in (self.proj.weight, self.proj.bias):
            I.Uniform(-bound, bound)(p, generator)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class VisionTransformer(nn.Module):
    """ViT encoder classifier: patch embeddings, a class token, learned
    positions, `depth` pre-LN blocks (fused where `use_fused_attn`), a
    final LayerNorm and a linear head on the class token (none for
    ``num_classes=0``)."""

    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 num_classes=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, dropout=0.0, attention_dropout=0.0,
                 use_fused_attn=True, device=None, seed=0):
        super().__init__()
        kw = device_and_generator(device, seed)
        device, gen = kw["device"], kw["generator"]
        self.embed_dim = embed_dim
        self.num_classes = num_classes
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, device=device, generator=gen)
        n = self.patch_embed.num_patches
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim,
                                                  device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, n + 1, embed_dim,
                                                  device=device))
        for p in (self.cls_token, self.pos_embed):
            I.TruncatedNormal(std=0.02)(p, gen)
        self.pos_drop = nn.Dropout(dropout)
        dim_ff = int(embed_dim * mlp_ratio)
        self._dim_ff = dim_ff
        if use_fused_attn:
            blocks = [FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_ff, dropout_rate=dropout,
                activation="gelu", attn_dropout_rate=attention_dropout,
                normalize_before=True, device=device, generator=gen)
                for _ in range(depth)]
        else:
            blocks = [TransformerEncoderLayer(
                embed_dim, num_heads, dim_ff, dropout=dropout,
                activation="gelu", attn_dropout=attention_dropout,
                normalize_before=True, device=device, generator=gen)
                for _ in range(depth)]
        self.blocks = nn.ModuleList(blocks)
        self.norm = nn.LayerNorm(embed_dim, device=device)
        self.head = linear(embed_dim, num_classes, device=device,
                           generator=gen) if num_classes > 0 else None

    def forward(self, x):
        x = self.patch_embed(x)
        cls = self.cls_token.expand(x.shape[0], 1, self.embed_dim)
        x = self.pos_drop(torch.cat([cls, x], dim=1) + self.pos_embed)
        for blk in self.blocks:
            x = blk(x)
        # the reference normalizes every token and keeps the class token's
        # row; LayerNorm is row by row, so only that row is normalized
        x = self.norm(x[:, 0])
        if self.head is not None:
            x = self.head(x)
        return x

    def flops_per_image(self, training=True):
        """Analytic FLOPs (forward, x3 for forward and backward) for MFU,
        the reference's count: per block 4 E^2 N for the attention
        projections, 2 N^2 E for QK^T and AV, 2 N E F for the MLP pair (2
        FLOPs a multiply-add), plus the patch projection and the head on
        the class token."""
        n = self.patch_embed.num_patches + 1
        e = self.embed_dim
        f = self._dim_ff
        per_block = 4 * n * e * e * 2 + 2 * n * n * e * 2 + 2 * n * e * f * 2
        patch_flops = self.patch_embed.num_patches * math.prod(
            self.patch_embed.proj.weight.shape) * 2
        head_flops = e * self.num_classes * 2 if self.head is not None else 0
        total = len(self.blocks) * per_block + patch_flops + head_flops
        return total * (3 if training else 1)


def _vit(arch, pretrained=False, **kwargs):
    if pretrained:
        raise ValueError(
            "pretrained ViT weights are not bundled; construct and train "
            "or load a local state_dict")
    return VisionTransformer(**kwargs)


def vit_b_16(pretrained=False, **kwargs):
    cfg = dict(patch_size=16, embed_dim=768, depth=12, num_heads=12)
    cfg.update(kwargs)
    return _vit("vit_b_16", pretrained, **cfg)


def vit_l_16(pretrained=False, **kwargs):
    cfg = dict(patch_size=16, embed_dim=1024, depth=24, num_heads=16)
    cfg.update(kwargs)
    return _vit("vit_l_16", pretrained, **cfg)


def vit_l_32(pretrained=False, **kwargs):
    cfg = dict(patch_size=32, embed_dim=1024, depth=24, num_heads=16)
    cfg.update(kwargs)
    return _vit("vit_l_32", pretrained, **cfg)
