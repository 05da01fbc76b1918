"""AFNO v2 (counterpart of ``makani_tpu/models/networks/afnonet_v2.py``).

The v1 mixer restructured: no inner bias, a cartesian complex ReLU, a
two-sided truncation of the unhalved frequency axis, a bias added after the
inverse FFT, a configurable skip around the filter (``skip_fno`` linear,
identity or none, ``nested_skip_fno``) and instance or channel layer norms.
The JAX module runs channels-first; the port keeps the tokens channels-last
(B, h, w, E) throughout, as its other models do, so that the norms (K4, K10),
the 1x1 convs and the mixer read them without a transposed copy; the
parameters keep the flax tree's names and shapes (``block{i}.filter.w1`` (nb,
bs, bs hf, 2), ``block{i}.norm1.weight``, ``block{i}.skip_layer.kernel``,
``pos_embed`` (1, E, h, w), ``head.kernel``, ...). The mixer's block-diagonal
MLP, band and soft-shrink run in kernel K18 (backward K19), which reads the
spectrum and the flax-layout weights in place through their strides.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from makani_torch.device import resolve_device
from makani_torch.models.common.layer_norm import ChannelLayerNorm, InstanceNorm2d
from makani_torch.models.common.layers import MLP, Conv1x1, DropPath, PatchEmbed2D, trunc_normal_02
from makani_torch.models.networks.afnonet import check_no_dropout, unpatch
from makani_torch.ops import fft_compat
from makani_torch.ops.afno_mixer import afno_mixer, afno_mixer_plain, band_v2

__all__ = ["AFNO2Dv2", "AFNOv2Block", "AdaptiveFourierNeuralOperatorNetV2"]


def _gelu_tanh(x):
    # jax.nn.gelu's default, the JAX MLP's activation
    return nn.functional.gelu(x, approximate="tanh")


class AFNO2Dv2(nn.Module):
    """The v2 mixer on channels-last x (B, H, W, C): fp32 rFFT, K18 (no inner
    bias, the two-sided band), inverse rFFT, cast back, plus ``b1`` and the
    input. Parameters w1 (nb, bs, bs hf, 2), b1 (1, C, 1, 1), w2 (nb, bs hf,
    bs, 2), normal(0.02), the [re, im] part last as in the flax tree."""

    def __init__(
        self,
        hidden_size: int,
        num_blocks: int = 8,
        sparsity_threshold: float = 0.0,
        hard_thresholding_fraction: float = 1.0,
        hidden_size_factor: int = 1,
        device=None,
    ):
        super().__init__()
        if hidden_size % num_blocks != 0:
            raise ValueError(f"hidden_size {hidden_size} not divisible by num_blocks {num_blocks}")
        nb, bs, hf = num_blocks, hidden_size // num_blocks, hidden_size_factor
        self.sparsity_threshold = sparsity_threshold
        self.hard_thresholding_fraction = hard_thresholding_fraction
        self.use_kernels = True
        device = resolve_device(device)
        self.w1 = nn.Parameter(torch.empty(nb, bs, bs * hf, 2, device=device))
        self.b1 = nn.Parameter(torch.empty(1, nb * bs, 1, 1, device=device))
        self.w2 = nn.Parameter(torch.empty(nb, bs * hf, bs, 2, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            for p in (self.w1, self.b1, self.w2):
                p.normal_(0.0, 0.02, generator=generator)

    def mixer_args(self, H: int, Wh: int) -> tuple:
        """(w1, None, w2, None, lambda, band) as the mixer takes them for an
        (H, Wh) spectrum: the weights as (nb, 2, ...) views, which K18 and
        K19 read and write in place."""
        w1, w2 = (p.permute(0, 3, 1, 2) for p in (self.w1, self.w2))
        return w1, None, w2, None, self.sparsity_threshold, band_v2(H, Wh, self.hard_thresholding_fraction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        xs = fft_compat.rfft2_s(x.float(), axes=(1, 2), norm="ortho")
        mix = afno_mixer if self.use_kernels else afno_mixer_plain
        ys = mix(xs, *self.mixer_args(H, W // 2 + 1))
        y = fft_compat.irfft2_s(ys, s=(H, W), axes=(1, 2), norm="ortho").to(x.dtype)
        return y + self.b1.reshape(C).to(x.dtype) + x


class AFNOv2Block(nn.Module):
    """norm1 -> filter -> skip (linear / identity / none) -> norm2 -> MLP ->
    drop path -> + residual (the block's input, or with ``nested_skip_fno``
    off and a skip, the filter's skipped output)."""

    def __init__(
        self,
        dim: int,
        mlp_ratio: float = 4.0,
        drop_path: float = 0.0,
        num_blocks: int = 8,
        sparsity_threshold: float = 0.01,
        hard_thresholding_fraction: float = 1.0,
        skip_fno: Optional[str] = "linear",
        nested_skip_fno: bool = True,
        normalization_layer: str = "instance_norm",
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.skip_fno = skip_fno
        self.nested_skip_fno = nested_skip_fno
        if normalization_layer in ("instance_norm", "instance_norm_s2"):
            norm = lambda: InstanceNorm2d(dim, eps=1e-6, affine=True, channels_last=True, device=device)  # noqa: E731
        elif normalization_layer == "layer_norm":
            norm = lambda: ChannelLayerNorm(dim, eps=1e-6, affine=True, channels_last=True, device=device)  # noqa: E731
        else:
            raise NotImplementedError(normalization_layer)
        self.norm1 = norm()
        self.filter = AFNO2Dv2(dim, num_blocks, sparsity_threshold, hard_thresholding_fraction, device=device)
        if skip_fno == "linear":
            self.skip_layer = Conv1x1(dim, dim, use_bias=True, kernel_std=0.02, dtype=dtype, device=device)
        self.norm2 = norm()
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim, act_layer=_gelu_tanh, dtype=dtype, device=device)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        x = self.filter(self.norm1(x))
        if self.skip_fno == "linear":
            x = x + self.skip_layer(residual)
        elif self.skip_fno == "identity":
            x = x + residual
        if self.skip_fno is not None and not self.nested_skip_fno:
            residual = x
        x = self.drop_path(self.mlp(self.norm2(x)))
        return x + residual


class AdaptiveFourierNeuralOperatorNetV2(nn.Module):
    """AFNOv2 forward: (B, inp_chans, H, W) -> (B, out_chans, H, W), rows
    and columns beyond the patch multiples cropped and zero-padded back."""

    def __init__(
        self,
        inp_shape: Tuple[int, int] = (720, 1440),
        out_shape: Tuple[int, int] = (720, 1440),
        patch_size: Sequence[int] = (6, 6),
        inp_chans: int = 2,
        out_chans: int = 2,
        embed_dim: int = 768,
        num_layers: int = 12,
        mlp_ratio: float = 4.0,
        pos_drop_rate: float = 0.0,
        path_drop_rate: float = 0.0,
        mlp_drop_rate: float = 0.0,
        num_blocks: int = 16,
        sparsity_threshold: float = 0.01,
        hard_thresholding_fraction: float = 1.0,
        skip_fno: Optional[str] = "linear",
        nested_skip_fno: bool = True,
        normalization_layer: str = "instance_norm",
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        check_no_dropout(pos_drop_rate=pos_drop_rate, mlp_drop_rate=mlp_drop_rate)
        self.patch_size = tuple(patch_size)
        self.out_chans = out_chans
        self.num_layers = num_layers
        device = resolve_device(device)
        ph, pw = self.patch_size
        h, w = inp_shape[0] // ph, inp_shape[1] // pw
        self.patch_embed = PatchEmbed2D(inp_chans, self.patch_size, embed_dim, dtype=dtype, device=device)
        self.pos_embed = nn.Parameter(torch.empty(1, embed_dim, h, w, device=device))
        dpr = np.linspace(0, path_drop_rate, num_layers)
        for i in range(num_layers):
            block = AFNOv2Block(
                embed_dim,
                mlp_ratio=mlp_ratio,
                drop_path=float(dpr[i]),
                num_blocks=num_blocks,
                sparsity_threshold=sparsity_threshold,
                hard_thresholding_fraction=hard_thresholding_fraction,
                skip_fno=skip_fno,
                nested_skip_fno=nested_skip_fno,
                normalization_layer=normalization_layer,
                dtype=dtype,
                device=device,
            )
            self.add_module(f"block{i}", block)
        self.head = Conv1x1(embed_dim, out_chans * ph * pw, use_bias=False, kernel_std=0.02, dtype=dtype, device=device)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        trunc_normal_02(self.pos_embed, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        ph, pw = self.patch_size
        Hc, Wc = (H // ph) * ph, (W // pw) * pw
        tokens = self.patch_embed(x[:, :, :Hc, :Wc])
        tokens = tokens + self.pos_embed.permute(0, 2, 3, 1).to(tokens.dtype)
        for i in range(self.num_layers):
            tokens = getattr(self, f"block{i}")(tokens)
        # the JAX head's channel c of patch pixel (p1, p2) is (p1 pw + p2) out_chans + c
        y = unpatch(self.head(tokens), B, Hc // ph, Wc // pw, self.patch_size, self.out_chans)
        if Hc < H or Wc < W:
            y = nn.functional.pad(y, (0, W - Wc, 0, H - Hc))
        return y
