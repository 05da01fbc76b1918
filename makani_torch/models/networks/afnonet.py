"""Adaptive Fourier Neural Operator, FourCastNet v1 (counterpart of
``makani_tpu/models/networks/afnonet.py``).

Patch embedding into a channels-last token grid (B, h, w, E), N blocks of
(LayerNorm -> AFNO2D spectral mixer -> + skip -> LayerNorm -> MLP -> + skip),
and a linear head recovering the patches. Latitude rows beyond the largest
patch multiple are cropped on input and zero-padded on output (721 -> 720 at
0.25 degrees). The mixer's FFTs run in fp32 on cuFFT, its block-diagonal
complex MLP, band and soft-shrink in kernel K18 (backward K19,
``ops/afno_mixer``); the residual stays in the compute dtype. Parameter names
and shapes follow the flax tree (``patch_embed``, ``pos_embed``,
``block{i}.LayerNorm_0``, ``block{i}.filter.w1``, ``block{i}.mlp.Dense_0``,
``head``, ...). Dropout is a training option the published recipes leave at
0 and is not ported (a nonzero rate raises); stochastic depth is.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from makani_torch.device import resolve_device
from makani_torch.models.common.layer_norm import LayerNorm
from makani_torch.models.common.layers import Dense, DropPath, PatchEmbed2D, trunc_normal_02
from makani_torch.ops import fft_compat
from makani_torch.ops.afno_mixer import afno_mixer, afno_mixer_plain, band_v1

__all__ = ["AFNO2D", "AFNOMlp", "AFNOBlock", "AdaptiveFourierNeuralOperatorNet", "check_no_dropout", "unpatch"]


def check_no_dropout(**rates):
    bad = {k: v for k, v in rates.items() if v}
    if bad:
        raise NotImplementedError(f"dropout is not ported (rates {bad}); the published recipes use none")


def unpatch(y: torch.Tensor, B: int, h: int, w: int, patch_size, out_chans: int) -> torch.Tensor:
    """Head output (B, h, w, ph pw out_chans), each token's values ordered
    (ph, pw, out_chans) -> (B, out_chans, h ph, w pw)."""
    ph, pw = patch_size
    y = y.reshape(B, h, w, ph, pw, out_chans).permute(0, 5, 1, 3, 2, 4)
    return y.reshape(B, out_chans, h * ph, w * pw)


class AFNO2D(nn.Module):
    """The spectral token mixer on channels-last x (B, H, W, C): fp32 rFFT
    over (H, W), K18, inverse rFFT, cast back, plus the input. Parameters
    w1 (2, nb, bs, bs hf), b1 (2, nb, bs hf), w2 (2, nb, bs hf, bs), b2 (2,
    nb, bs), normal(0.02), the [re, im] part first as in the flax tree."""

    def __init__(
        self,
        hidden_size: int,
        num_blocks: int = 8,
        sparsity_threshold: float = 0.01,
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
        self.w1 = nn.Parameter(torch.empty(2, nb, bs, bs * hf, device=device))
        self.b1 = nn.Parameter(torch.empty(2, nb, bs * hf, device=device))
        self.w2 = nn.Parameter(torch.empty(2, nb, bs * hf, bs, device=device))
        self.b2 = nn.Parameter(torch.empty(2, nb, bs, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            for p in (self.w1, self.b1, self.w2, self.b2):
                p.normal_(0.0, 0.02, generator=generator)

    def mixer_args(self, H: int, Wh: int) -> tuple:
        """(w1, b1, w2, b2, lambda, band) as the mixer takes them for an (H, Wh)
        spectrum: the parameters as (nb, 2, ...) views, which K18 and K19
        read and write in place."""
        w1, b1, w2, b2 = (p.transpose(0, 1) for p in (self.w1, self.b1, self.w2, self.b2))
        return w1, b1, w2, b2, self.sparsity_threshold, band_v1(H, Wh, self.hard_thresholding_fraction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        xs = fft_compat.rfft2_s(x.float(), axes=(1, 2), norm="ortho")
        mix = afno_mixer if self.use_kernels else afno_mixer_plain
        ys = mix(xs, *self.mixer_args(H, W // 2 + 1))
        return fft_compat.irfft2_s(ys, s=(H, W), axes=(1, 2), norm="ortho").to(x.dtype) + x


class AFNOMlp(nn.Module):
    """Channels-last two-layer MLP, Dense_0 -> exact GELU -> Dense_1."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.Dense_0 = Dense(in_features, hidden_features, dtype=dtype, device=device)
        self.Dense_1 = Dense(hidden_features, out_features, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(nn.functional.gelu(self.Dense_0(x)))


class AFNOBlock(nn.Module):
    """norm -> AFNO2D -> (+ skip) -> norm -> MLP -> drop path -> + skip."""

    def __init__(
        self,
        dim: int,
        mlp_ratio: float = 4.0,
        drop_path: float = 0.0,
        double_skip: bool = True,
        num_blocks: int = 8,
        sparsity_threshold: float = 0.01,
        hard_thresholding_fraction: float = 1.0,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.double_skip = double_skip
        self.LayerNorm_0 = LayerNorm(dim, dtype=dtype, device=device)
        self.filter = AFNO2D(dim, num_blocks, sparsity_threshold, hard_thresholding_fraction, device=device)
        self.LayerNorm_1 = LayerNorm(dim, dtype=dtype, device=device)
        self.mlp = AFNOMlp(dim, int(dim * mlp_ratio), dim, dtype=dtype, device=device)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        x = self.filter(self.LayerNorm_0(x))
        if self.double_skip:
            x = x + residual
            residual = x
        x = self.drop_path(self.mlp(self.LayerNorm_1(x)))
        return x + residual


class AdaptiveFourierNeuralOperatorNet(nn.Module):
    """AFNO / FourCastNet v1 forward: (B, inp_chans, H, W) -> (B, out_chans,
    H, W). Argument names mirror the JAX module's fields."""

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
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        check_no_dropout(pos_drop_rate=pos_drop_rate, mlp_drop_rate=mlp_drop_rate)
        self.patch_size = tuple(patch_size)
        self.out_chans = out_chans
        self.num_layers = num_layers
        self.dtype = dtype
        device = resolve_device(device)
        ph, pw = self.patch_size
        h, w = inp_shape[0] // ph, inp_shape[1] // pw
        self.patch_embed = PatchEmbed2D(inp_chans, self.patch_size, embed_dim, dtype=dtype, device=device)
        self.pos_embed = nn.Parameter(torch.empty(1, h, w, embed_dim, device=device))
        dpr = np.linspace(0, path_drop_rate, num_layers)
        for i in range(num_layers):
            block = AFNOBlock(
                embed_dim,
                mlp_ratio=mlp_ratio,
                drop_path=float(dpr[i]),
                num_blocks=num_blocks,
                sparsity_threshold=sparsity_threshold,
                hard_thresholding_fraction=hard_thresholding_fraction,
                dtype=dtype,
                device=device,
            )
            self.add_module(f"block{i}", block)
        self.head = Dense(embed_dim, out_chans * ph * pw, use_bias=False, dtype=dtype, device=device)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        trunc_normal_02(self.pos_embed, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        ph, pw = self.patch_size
        Hc, Wc = (H // ph) * ph, (W // pw) * pw
        tokens = self.patch_embed(x[:, :, :Hc, :Wc])
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        for i in range(self.num_layers):
            tokens = getattr(self, f"block{i}")(tokens)
        y = unpatch(self.head(tokens), B, Hc // ph, Wc // pw, self.patch_size, self.out_chans)
        if Hc < H or Wc < W:
            y = nn.functional.pad(y, (0, W - Wc, 0, H - Hc))
        return y
