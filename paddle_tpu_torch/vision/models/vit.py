"""Vision Transformer (counterpart of paddle_tpu/vision/models/vit.py):
patch embedding as one strided convolution, pre-norm encoder blocks whose
attention is the port's `nn.functional.flash_attention` (non-causal; on a
CUDA tensor of S >= 128 the hand-written FlashAttention-2 forward and
backward kernels, as the language models train), a class token and a
linear head.

The layer names are the JAX model's (``patch_embed.proj.weight``,
``blocks.3.qkv.weight``, ``cls_token``, ``pos_embed`` ...), so
`convert.load_jax_state` carries a JAX state over (the Linear weights
transposed). `device`: the GPU by default (raises without one), ``"cpu"``
on request; the weights come from `generator` (default: one on the
device seeded with `seed`): Xavier-uniform Linears with zero biases, a
Kaiming-uniform patch convolution, LayerNorm 1 / 0, and `cls_token` /
`pos_embed` TruncatedNormal(0.02) (cut at two standard deviations)."""
from __future__ import annotations

import math

import torch
from torch import nn

from ...nn import Conv2D, Dropout, LayerList, LayerNorm, Linear
from ...nn import functional as F
from ._init import init_kwargs

__all__ = ["PatchEmbed", "ViTBlock", "VisionTransformer", "vit_b_16",
           "vit_l_16", "vit_s_16", "vit_tiny", "train_flops_per_image"]


class PatchEmbed(nn.Module):
    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 embed_dim=768, *, device=None, generator=None):
        super().__init__()
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = Conv2D(in_chans, embed_dim, kernel_size=patch_size,
                           stride=patch_size, device=device,
                           generator=generator)

    def forward(self, x):
        x = self.proj(x)                     # [B, D, H/p, W/p]
        b, d = x.shape[0], x.shape[1]
        return x.reshape(b, d, -1).transpose(1, 2)   # [B, N, D]


class ViTBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, dropout=0.0, *,
                 device=None, generator=None):
        super().__init__()
        init = dict(device=device, generator=generator)
        self.norm1 = LayerNorm(dim, device=device)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = Linear(dim, dim * 3, **init)
        self.proj = Linear(dim, dim, **init)
        self.norm2 = LayerNorm(dim, device=device)
        hidden = int(dim * mlp_ratio)
        self.fc1 = Linear(dim, hidden, **init)
        self.fc2 = Linear(hidden, dim, **init)
        self.drop = Dropout(dropout, generator=generator)

    def _attn(self, x):
        b, n, d = x.shape
        q, k, v = self.qkv(x).split(d, dim=-1)

        def heads(t):
            return t.reshape(b, n, self.num_heads, self.head_dim)

        out, _ = F.flash_attention(heads(q), heads(k), heads(v),
                                   causal=False, training=self.training)
        return self.proj(out.reshape(b, n, d))

    def forward(self, x):
        x = x + self.drop(self._attn(self.norm1(x)))
        h = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + self.drop(h)


class VisionTransformer(nn.Module):
    """ViT encoder + classification head (class token)."""

    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 num_classes=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, dropout=0.0, *, device=None, seed=0,
                 generator=None):
        super().__init__()
        init = init_kwargs(device, seed, generator)
        dev, generator = init["device"], init["generator"]
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, **init)
        n = self.patch_embed.num_patches
        std = 0.02
        self.cls_token = nn.Parameter(self._trunc([1, 1, embed_dim], std,
                                                  dev, generator))
        self.pos_embed = nn.Parameter(self._trunc([1, n + 1, embed_dim], std,
                                                  dev, generator))
        self.pos_drop = Dropout(dropout, generator=generator)
        self.blocks = LayerList(
            [ViTBlock(embed_dim, num_heads, mlp_ratio, dropout, **init)
             for _ in range(depth)])
        self.norm = LayerNorm(embed_dim, device=dev)
        self.head = Linear(embed_dim, num_classes, **init) \
            if num_classes > 0 else None

    @staticmethod
    def _trunc(shape, std, device, generator):
        """N(0, std) cut at +-2 std, by the inverse CDF of a uniform draw
        from `generator`."""
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
        u = torch.empty(shape, device=device).uniform_(
            2.0 * lo - 1.0, 1.0 - 2.0 * lo, generator=generator)
        return torch.erfinv(u).mul_(std * math.sqrt(2.0)).clamp_(
            -2.0 * std, 2.0 * std)

    def forward_features(self, x):
        x = self.patch_embed(x)
        b = x.shape[0]
        cls = self.cls_token.expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        x = self.pos_drop(x)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)

    def forward(self, x):
        feats = self.forward_features(x)
        cls = feats[:, 0]
        return self.head(cls) if self.head is not None else cls


def vit_b_16(num_classes=1000, **kw):
    return VisionTransformer(patch_size=16, embed_dim=768, depth=12,
                             num_heads=12, num_classes=num_classes, **kw)


def vit_l_16(num_classes=1000, **kw):
    return VisionTransformer(patch_size=16, embed_dim=1024, depth=24,
                             num_heads=16, num_classes=num_classes, **kw)


def vit_s_16(num_classes=1000, **kw):
    return VisionTransformer(patch_size=16, embed_dim=384, depth=12,
                             num_heads=6, num_classes=num_classes, **kw)


def vit_tiny(num_classes=10, img_size=32, patch_size=8, **kw):
    """Test-scale ViT."""
    return VisionTransformer(img_size=img_size, patch_size=patch_size,
                             embed_dim=64, depth=2, num_heads=4,
                             num_classes=num_classes, **kw)


def train_flops_per_image(model, image_size):
    """Training FLOPs per image of a `VisionTransformer` on square images:
    3 x the forward's products, 2 per multiply-add — the patch
    convolution, every Linear on every token (the head on the class token
    alone) and the attention's two products, 4·S²·head_dim per head and
    layer (LayerNorm, softmax, GELU and elementwise work are not
    counted)."""
    conv = model.patch_embed.proj
    p = conv._kernel_size[0]
    s = (image_size // p) ** 2 + 1
    flops = 2 * p * p * conv._in_channels * conv._out_channels * (s - 1)
    for blk in model.blocks:
        for lin in (blk.qkv, blk.proj, blk.fc1, blk.fc2):
            flops += 2 * lin.in_features * lin.out_features * s
        flops += 4 * s * s * blk.head_dim * blk.num_heads
    if model.head is not None:
        flops += 2 * model.head.in_features * model.head.out_features
    return 3 * flops
