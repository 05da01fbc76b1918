"""Pointwise building blocks (counterpart of ``Conv1x1``, ``MLP`` and
``EncoderDecoder`` in ``makani_tpu/models/common/layers.py``), channels-last.

Every "conv" here is a channel contraction of (B, H, W, C) activations. The
JAX package leaves these GEMMs to XLA, so they are plain ``torch.matmul`` in
the compute dtype here (cuBLAS on the card). Parameter names and shapes
follow the flax tree: ``kernel`` (1, fan_in, out) and ``bias`` (out,), fp32.
Grouped mixing and the NCHW layout are not ported (the SFNO and FCN3 use
neither). ``DropPath`` and ``LayerScale`` are the FCN3 block's residual-branch
layers. ``Dense`` is flax's ``nn.Dense`` as the token models (AFNO, ViT) use
it; ``PatchEmbed2D`` and ``PatchRecovery2D`` lift patches to tokens and back,
each a reshape and one GEMM. Parameters are made on the card unless
``device`` names another.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from makani_torch.device import resolve_device

__all__ = ["Conv1x1", "MLP", "EncoderDecoder", "DropPath", "LayerScale", "Dense", "PatchEmbed2D", "PatchRecovery2D", "trunc_normal_02"]


class Conv1x1(nn.Module):
    """Pointwise channel mixing (B, H, W, C) -> (B, H, W, O); the input is
    cast to the compute dtype. ``kernel_std`` defaults to He, sqrt(2/C)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        use_bias: bool = True,
        kernel_std: float | None = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.kernel_std = kernel_std if kernel_std is not None else math.sqrt(2.0 / in_features)
        self.dtype = dtype
        device = resolve_device(device)
        self.kernel = nn.Parameter(torch.empty(1, in_features, features, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(features, device=device))
        else:
            self.register_parameter("bias", None)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.kernel.normal_(0.0, self.kernel_std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.kernel[0].to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class MLP(nn.Module):
    """Two-layer pointwise feed-forward block: fc1 (He init) -> act -> fc2
    (gain/fan_in init). Dropout is a training feature and is not ported."""

    def __init__(
        self,
        in_features: int,
        hidden_features: int,
        out_features: int,
        act_layer: Callable = nn.functional.gelu,
        gain: float = 1.0,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.act_layer = act_layer
        self.fc1 = Conv1x1(in_features, hidden_features, dtype=dtype, device=device)
        self.fc2 = Conv1x1(hidden_features, out_features, kernel_std=math.sqrt(gain / hidden_features), dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act_layer(self.fc1(x)))


class EncoderDecoder(nn.Module):
    """Stack of 1x1 conv + activation pairs ending in a bias-free projection."""

    def __init__(
        self,
        num_layers: int,
        input_dim: int,
        output_dim: int,
        hidden_dim: int,
        act_layer: Callable = nn.functional.gelu,
        gain: float = 1.0,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.act_layer = act_layer
        dim = input_dim
        for i in range(num_layers):
            self.add_module(f"hidden{i}", Conv1x1(dim, hidden_dim, dtype=dtype, device=device))
            dim = hidden_dim
        self.out = Conv1x1(dim, output_dim, use_bias=False, kernel_std=math.sqrt(gain / dim), dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = self.act_layer(getattr(self, f"hidden{i}")(x))
        return self.out(x)


class DropPath(nn.Module):
    """Stochastic depth: drop the whole residual branch per sample in
    training, the identity in eval mode (``makani_tpu`` ``DropPath``)."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.drop_prob <= 0.0 or not self.training:
            return x
        keep = 1.0 - self.drop_prob
        mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device)).to(x.dtype)


class LayerScale(nn.Module):
    """Learnable per-channel scaling of a residual branch; ``gamma`` has the
    flax tree's shape (1, C, 1, 1), fp32, initialised to ``init_value``."""

    def __init__(self, num_chans: int, init_value: float = 0.1, channels_last: bool = False, device=None):
        super().__init__()
        self.init_value = init_value
        self.channels_last = channels_last
        self.gamma = nn.Parameter(torch.full((1, num_chans, 1, 1), init_value, device=resolve_device(device)))

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.gamma.fill_(self.init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gamma = self.gamma.reshape(1, 1, 1, -1) if self.channels_last else self.gamma
        return x * gamma.to(x.dtype)


def trunc_normal_02(t: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's ``truncated_normal(stddev=0.02)``: a standard normal truncated
    to [-2, 2], times 0.02 (drawn by redrawing the values outside, which is
    many times faster on the CPU than ``nn.init.trunc_normal_``'s inverse
    CDF at the recipes' 12-million-value position embeddings)."""
    with torch.no_grad():
        flat = t.view(-1)
        flat.normal_(0.0, 1.0, generator=generator)
        idx = torch.nonzero(flat.abs() > 2.0).squeeze(1)
        while idx.numel():
            v = torch.randn(idx.numel(), generator=generator, device=t.device, dtype=t.dtype)
            flat[idx] = v
            idx = idx[v.abs() > 2.0]
        return t.mul_(0.02)


class Dense(nn.Module):
    """flax's ``nn.Dense`` on the last axis: ``kernel`` (in, out) and ``bias``
    (out,) fp32, truncated-normal(0.02) kernel and zero bias (the token
    models' init); input, kernel and bias cast to the compute dtype."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        device = resolve_device(device)
        self.kernel = nn.Parameter(torch.empty(in_features, features, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features, device=device))
        else:
            self.register_parameter("bias", None)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        trunc_normal_02(self.kernel, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class PatchEmbed2D(nn.Module):
    """Non-overlapping patch embedding of NCHW input (counterpart of
    ``PatchEmbed2D`` in ``makani_tpu/models/common/layers.py``): the grid
    split into (ph, pw) patches, each lifted by one GEMM to ``embed_dim``.
    ``kernel`` (C ph pw, embed_dim), He init, and ``bias`` (embed_dim,), as in
    the flax tree. The weights are rounded to the compute dtype and the
    product runs in the wider of it and x's dtype, as the JAX einsum promotes
    (fp32 tokens from fp32 input under bf16 compute). Returns channels-last
    tokens (B, gh, gw, E), or (B, gh gw, E) with ``flatten``; the JAX module's
    unflattened output is NCHW, and the port's token models keep their tokens
    channels-last instead."""

    def __init__(self, in_chans: int, patch_size, embed_dim: int, use_bias: bool = True, flatten: bool = False, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.flatten = flatten
        self.dtype = dtype
        ph, pw = self.patch_size
        fan_in = in_chans * ph * pw
        self.kernel_std = math.sqrt(2.0 / fan_in)
        device = resolve_device(device)
        self.kernel = nn.Parameter(torch.empty(fan_in, embed_dim, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(embed_dim, device=device))
        else:
            self.register_parameter("bias", None)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.kernel.normal_(0.0, self.kernel_std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        ph, pw = self.patch_size
        if H % ph or W % pw:
            raise ValueError(f"grid ({H},{W}) not divisible by patch size ({ph},{pw})")
        gh, gw = H // ph, W // pw
        dt = torch.promote_types(x.dtype, self.dtype)
        x = x.to(dt).reshape(B, C, gh, ph, gw, pw).permute(0, 2, 4, 1, 3, 5).reshape(B, gh, gw, C * ph * pw)
        y = torch.matmul(x, self.kernel.to(self.dtype).to(dt))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).to(dt)
        return y.reshape(B, gh * gw, -1) if self.flatten else y


class PatchRecovery2D(nn.Module):
    """The inverse of ``PatchEmbed2D`` (counterpart of ``PatchRecovery2D``):
    NCHW embeddings (B, E, gh, gw) projected by one GEMM to ``out_chans``
    values of each patch pixel -> (B, out_chans, gh ph, gw pw). ``kernel`` (E,
    out_chans ph pw), normal(sqrt(1/E)), and ``bias``, zero; the dtypes as
    ``PatchEmbed2D``'s."""

    def __init__(self, embed_dim: int, patch_size, out_chans: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.out_chans = out_chans
        self.dtype = dtype
        ph, pw = self.patch_size
        device = resolve_device(device)
        self.kernel = nn.Parameter(torch.empty(embed_dim, out_chans * ph * pw, device=device))
        self.bias = nn.Parameter(torch.zeros(out_chans * ph * pw, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.kernel.normal_(0.0, math.sqrt(1.0 / self.kernel.shape[0]), generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, E, gh, gw = x.shape
        ph, pw = self.patch_size
        dt = torch.promote_types(x.dtype, self.dtype)
        y = torch.matmul(x.to(dt).permute(0, 2, 3, 1), self.kernel.to(self.dtype).to(dt)) + self.bias.to(self.dtype).to(dt)
        y = y.reshape(B, gh, gw, self.out_chans, ph, pw).permute(0, 3, 1, 4, 2, 5)
        return y.reshape(B, self.out_chans, gh * ph, gw * pw)
