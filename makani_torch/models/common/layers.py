"""Pointwise building blocks (counterpart of ``Conv1x1``, ``MLP`` and
``EncoderDecoder`` in ``makani_tpu/models/common/layers.py``), channels-last.

Every "conv" here is a channel contraction of (B, H, W, C) activations. The
JAX package leaves these GEMMs to XLA, so they are plain ``torch.matmul`` in
the compute dtype here (cuBLAS on the card). Parameter names and shapes
follow the flax tree: ``kernel`` (1, fan_in, out) and ``bias`` (out,), fp32.
Grouped mixing and the NCHW layout are not ported (the SFNO and FCN3 use
neither). ``DropPath`` and ``LayerScale`` are the FCN3 block's residual-branch
layers. Parameters are made on the card unless ``device`` names another.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from makani_torch.device import resolve_device

__all__ = ["Conv1x1", "MLP", "EncoderDecoder", "DropPath", "LayerScale"]


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
