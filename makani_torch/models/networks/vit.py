"""Vision Transformer baseline (counterpart of
``makani_tpu/models/networks/vit.py``).

Pre-norm ViT on patch tokens of the lat-lon grid: patch embed -> N x
(LayerNorm -> multi-head attention -> + skip -> LayerNorm -> MLP -> + skip)
-> LayerNorm -> linear head unfolding the tokens into patches. Attention is
computed as the JAX body computes it: one fused qkv projection, then two
``torch.matmul`` products with a softmax between them, all in the compute
dtype (the JAX package leaves them to XLA; a fused attention kernel is later
work). Parameter names and shapes follow the flax tree
(``block{i}.attn.qkv.kernel``, ``block{i}.Dense_0``, ``LayerNorm_0``,
``head``, ...). Dropout is not ported (a nonzero rate raises).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from makani_torch.device import resolve_device
from makani_torch.models.common.layer_norm import LayerNorm
from makani_torch.models.common.layers import Dense, DropPath, PatchEmbed2D, trunc_normal_02
from makani_torch.models.networks.afnonet import check_no_dropout, unpatch

__all__ = ["Attention", "ViTBlock", "VisionTransformer"]


class Attention(nn.Module):
    """Multi-head self-attention on (B, N, C) tokens."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, use_bias=qkv_bias, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)  # (3, B, heads, N, hd)
        q, k, v = qkv[0], qkv[1], qkv[2]
        # the JAX body divides by sqrt(hd) rounded to the input's dtype
        attn = torch.matmul(q, k.transpose(-2, -1)) / torch.full((), math.sqrt(hd), dtype=x.dtype, device=x.device)
        attn = torch.softmax(attn, dim=-1)
        y = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
        return self.proj(y)


class ViTBlock(nn.Module):
    """LayerNorm_0 -> attn -> drop path -> + skip -> LayerNorm_1 -> Dense_0
    -> exact GELU -> Dense_1 -> drop path -> + skip."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = False,
        drop_path: float = 0.0,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, dtype=dtype, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype=dtype, device=device)
        self.LayerNorm_1 = LayerNorm(dim, dtype=dtype, device=device)
        self.Dense_0 = Dense(dim, int(dim * mlp_ratio), dtype=dtype, device=device)
        self.Dense_1 = Dense(int(dim * mlp_ratio), dim, dtype=dtype, device=device)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.LayerNorm_0(x)))
        h = self.Dense_1(nn.functional.gelu(self.Dense_0(self.LayerNorm_1(x))))
        return x + self.drop_path(h)


class VisionTransformer(nn.Module):
    """ViT forward: (B, inp_chans, H, W) -> (B, out_chans, H, W), rows and
    columns beyond the patch multiples cropped and zero-padded back."""

    def __init__(
        self,
        inp_shape: Tuple[int, int] = (720, 1440),
        out_shape: Tuple[int, int] = (720, 1440),
        patch_size: Sequence[int] = (16, 16),
        inp_chans: int = 2,
        out_chans: int = 2,
        embed_dim: int = 768,
        num_layers: int = 12,
        depth: int | None = None,
        num_heads: int = 8,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = False,
        pos_drop_rate: float = 0.0,
        path_drop_rate: float = 0.0,
        mlp_drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        check_no_dropout(pos_drop_rate=pos_drop_rate, mlp_drop_rate=mlp_drop_rate, attn_drop_rate=attn_drop_rate)
        self.patch_size = tuple(patch_size)
        self.out_chans = out_chans
        self.depth = depth or num_layers
        device = resolve_device(device)
        ph, pw = self.patch_size
        h, w = inp_shape[0] // ph, inp_shape[1] // pw
        self.patch_embed = PatchEmbed2D(inp_chans, self.patch_size, embed_dim, flatten=True, dtype=dtype, device=device)
        self.pos_embed = nn.Parameter(torch.empty(1, h * w, embed_dim, device=device))
        dpr = np.linspace(0, path_drop_rate, self.depth)
        for i in range(self.depth):
            self.add_module(f"block{i}", ViTBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, float(dpr[i]), dtype=dtype, device=device))
        self.LayerNorm_0 = LayerNorm(embed_dim, dtype=dtype, device=device)
        self.head = Dense(embed_dim, out_chans * ph * pw, dtype=dtype, device=device)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        trunc_normal_02(self.pos_embed, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        ph, pw = self.patch_size
        Hc, Wc = (H // ph) * ph, (W // pw) * pw
        tokens = self.patch_embed(x[:, :, :Hc, :Wc])
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens)
        y = unpatch(self.head(self.LayerNorm_0(tokens)), B, Hc // ph, Wc // pw, self.patch_size, self.out_chans)
        if Hc < H or Wc < W:
            y = nn.functional.pad(y, (0, W - Wc, 0, H - Hc))
        return y
