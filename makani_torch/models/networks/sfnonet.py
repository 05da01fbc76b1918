"""Spherical Fourier Neural Operator (counterpart of
``makani_tpu/models/networks/sfnonet.py``), serial and channels-last.

encoder -> N neural-operator blocks (spectral filter + skips + instance norm
+ MLP) -> decoder, with a big-skip connection. The first block maps the input
grid to an internal grid coarsened by ``scale_factor``; the last maps back.
The model's I/O is NCHW; inside it is channels-last (B, H, W, C).

Ported: the linear spectral filter (dhconv or diagonal), instance norm,
``pos_embed`` none/direct and ``big_skip``. The rematerialization options
(``checkpointing_level``, ``remat_policy``) are training features of the next
slice and are accepted only at their off values.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from makani_torch.device import resolve_device
from makani_torch.models.common.layer_norm import InstanceNorm2d
from makani_torch.models.common.layers import MLP, Conv1x1, EncoderDecoder
from makani_torch.models.common.spectral_convolution import SpectralConv
from makani_torch.ops.precision import transform_io_dtype
from makani_torch.ops.sht import InverseRealSHT, RealSHT

__all__ = ["SphericalFourierNeuralOperatorNet", "NeuralOperatorBlock", "SpectralFilterLayer", "build_spectral_transforms"]


_ACTIVATIONS = {
    "relu": nn.functional.relu,
    "gelu": nn.functional.gelu,  # exact (erf) GELU, as the JAX package's approximate=False
    "silu": nn.functional.silu,
    "sin": torch.sin,
    "identity": lambda x: x,
}

# the Legendre tables of the 721x1440 grid are hundreds of MB: build each set
# of transforms once per configuration (bounded, oldest dropped first)
_TRANSFORM_CACHE: dict = {}
_TRANSFORM_CACHE_MAX = 8


def build_spectral_transforms(
    spectral_transform: str,
    inp_shape: Tuple[int, int],
    out_shape: Tuple[int, int],
    internal_shape: Tuple[int, int],
    modes: Tuple[int, int],
    model_grid_type: str = "equiangular",
    sht_grid_type: str = "legendre-gauss",
):
    """(trans_down, itrans_up, trans, itrans): the four transform handles the
    SFNO wires into its blocks. Memoized per configuration."""
    if spectral_transform != "sht":
        raise NotImplementedError(f"spectral_transform {spectral_transform!r} is not ported yet (only 'sht')")
    key = (tuple(inp_shape), tuple(out_shape), tuple(internal_shape), tuple(modes), model_grid_type, sht_grid_type)
    if key in _TRANSFORM_CACHE:
        _TRANSFORM_CACHE[key] = _TRANSFORM_CACHE.pop(key)
        return _TRANSFORM_CACHE[key]
    modes_lat, modes_lon = modes
    out = (
        RealSHT(*inp_shape, lmax=modes_lat, mmax=modes_lon, grid=model_grid_type),
        InverseRealSHT(*out_shape, lmax=modes_lat, mmax=modes_lon, grid=model_grid_type),
        RealSHT(*internal_shape, lmax=modes_lat, mmax=modes_lon, grid=sht_grid_type),
        InverseRealSHT(*internal_shape, lmax=modes_lat, mmax=modes_lon, grid=sht_grid_type),
    )
    _TRANSFORM_CACHE[key] = out
    while len(_TRANSFORM_CACHE) > _TRANSFORM_CACHE_MAX:
        _TRANSFORM_CACHE.pop(next(iter(_TRANSFORM_CACHE)))
    return out


class SpectralFilterLayer(nn.Module):
    """The linear spectral filter (the non-linear one is not ported yet)."""

    def __init__(
        self,
        forward_transform,
        inverse_transform,
        embed_dim: int,
        filter_type: str = "linear",
        operator_type: str = "diagonal",
        separable: bool = False,
        use_bias: bool = False,
        gain: float = 1.0,
        device=None,
    ):
        super().__init__()
        if filter_type != "linear":
            raise NotImplementedError(f"filter_type {filter_type!r} is not ported yet (only 'linear')")
        self.filter = SpectralConv(
            forward_transform,
            inverse_transform,
            embed_dim,
            embed_dim,
            operator_type=operator_type,
            separable=separable,
            use_bias=use_bias,
            gain=gain,
            device=device,
        )

    def forward(self, x):
        return self.filter(x)


class NeuralOperatorBlock(nn.Module):
    """One SFNO processor block as the SFNO wires it (no inner skip, linear
    outer skip, no final activation), channels-last:

        x -> filter -> norm0 -> act -> mlp -> norm1 -> + outer_skip(residual)
    """

    def __init__(
        self,
        forward_transform,
        inverse_transform,
        embed_dim: int,
        filter_type: str = "linear",
        operator_type: str = "diagonal",
        mlp_ratio: float = 2.0,
        act_layer: Callable = nn.functional.gelu,
        norm_layers: Tuple[Optional[Callable], Optional[Callable]] = (None, None),
        separable: bool = False,
        use_mlp: bool = True,
        use_bias: bool = False,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.act_layer = act_layer
        # gains as the JAX block computes them for an activation, no inner
        # skip, a linear outer skip and no final activation
        self.filter_layer = SpectralFilterLayer(
            forward_transform,
            inverse_transform,
            embed_dim,
            filter_type=filter_type,
            operator_type=operator_type,
            separable=separable,
            use_bias=use_bias,
            gain=2.0,
            device=device,
        )
        self.norm0 = norm_layers[0]() if norm_layers[0] is not None else None
        self.mlp = (
            MLP(embed_dim, int(embed_dim * mlp_ratio), embed_dim, act_layer=act_layer, gain=0.5, dtype=dtype, device=device) if use_mlp else None
        )
        self.norm1 = norm_layers[1]() if norm_layers[1] is not None else None
        self.outer_skip = Conv1x1(embed_dim, embed_dim, use_bias=False, kernel_std=math.sqrt(0.5 / embed_dim), dtype=dtype, device=device)

    def forward(self, x):
        x, residual = self.filter_layer(x)
        if self.norm0 is not None:
            x = self.norm0(x)
        x = self.act_layer(x)
        if self.mlp is not None:
            x = self.mlp(x)
        if self.norm1 is not None:
            x = self.norm1(x)
        return x + self.outer_skip(residual)


class SphericalFourierNeuralOperatorNet(nn.Module):
    """SFNO forward. Argument names mirror the JAX module's fields (and the
    reference's YAML surface); parameter names and shapes mirror its flax
    tree (``block0.filter_layer.filter.weight``, ``encoder.hidden0.kernel``,
    ...)."""

    def __init__(
        self,
        spectral_transform: str = "sht",
        model_grid_type: str = "equiangular",
        sht_grid_type: str = "legendre-gauss",
        filter_type: str = "linear",
        operator_type: str = "dhconv",
        inp_shape: Tuple[int, int] = (721, 1440),
        out_shape: Tuple[int, int] = (721, 1440),
        scale_factor: int = 8,
        inp_chans: int = 2,
        out_chans: int = 2,
        embed_dim: int = 32,
        num_layers: int = 4,
        use_mlp: bool = True,
        mlp_ratio: float = 2.0,
        encoder_ratio: int = 1,
        decoder_ratio: int = 1,
        activation_function: str = "gelu",
        encoder_layers: int = 1,
        pos_embed: str = "none",
        normalization_layer: str = "instance_norm",
        max_modes: Optional[Tuple[int, int]] = None,
        hard_thresholding_fraction: float = 1.0,
        big_skip: bool = True,
        separable: bool = False,
        use_bias: bool = False,
        checkpointing_level: int = 0,
        remat_policy: str = "none",
        channels_last: bool = True,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        if not channels_last:
            raise NotImplementedError("the port's SFNO runs channels-last only")
        if checkpointing_level != 0 or remat_policy != "none":
            raise NotImplementedError("rematerialization is a training feature and is not ported yet")
        if normalization_layer not in ("instance_norm", "none"):
            raise NotImplementedError(f"normalization {normalization_layer!r} is not ported yet")
        self.inp_shape = tuple(inp_shape)
        self.out_shape = tuple(out_shape)
        self.inp_chans = inp_chans
        self.out_chans = out_chans
        self.embed_dim = embed_dim
        self.num_layers = num_layers
        self.big_skip = big_skip
        self.pos_embed_type = pos_embed
        self.dtype = dtype
        self.use_kernels = True
        device = resolve_device(device)
        self.h = self.inp_shape[0] // scale_factor
        self.w = self.inp_shape[1] // scale_factor
        if max_modes is not None:
            modes = tuple(max_modes)
        else:
            modes = (int(self.h * hard_thresholding_fraction), int((self.w // 2 + 1) * hard_thresholding_fraction))
        self.trans_down, self.itrans_up, self.trans, self.itrans = build_spectral_transforms(
            spectral_transform, self.inp_shape, self.out_shape, (self.h, self.w), modes, model_grid_type, sht_grid_type
        )
        act = _ACTIVATIONS[activation_function]

        def norm_layer(nlat_phys):
            if normalization_layer == "none":
                return None
            return lambda: InstanceNorm2d(embed_dim, eps=1e-6, affine=True, nlat_phys=nlat_phys, channels_last=True, device=device)

        norm_inp = norm_mid = norm_layer(self.h)
        norm_out = norm_layer(self.out_shape[0])

        self.encoder = EncoderDecoder(encoder_layers, inp_chans, embed_dim, int(encoder_ratio * embed_dim), act_layer=act, dtype=dtype, device=device)
        if pos_embed == "direct":
            self.pos_embed = nn.Parameter(torch.empty(1, self.inp_shape[0], self.inp_shape[1], embed_dim, device=device))
        elif pos_embed not in ("none", "None", None):
            raise NotImplementedError(f"pos_embed {pos_embed!r} is not ported yet (none or direct)")

        for i in range(num_layers):
            first, last = i == 0, i == num_layers - 1
            norms = (norm_inp, norm_mid) if first else ((norm_out, norm_out) if last else (norm_mid, norm_mid))
            block = NeuralOperatorBlock(
                self.trans_down if first else self.trans,
                self.itrans_up if last else self.itrans,
                embed_dim,
                filter_type=filter_type,
                operator_type=operator_type,
                mlp_ratio=mlp_ratio,
                act_layer=act,
                norm_layers=norms,
                separable=separable,
                use_mlp=use_mlp,
                use_bias=use_bias,
                dtype=dtype,
                device=device,
            )
            self.add_module(f"block{i}", block)

        self.decoder = EncoderDecoder(
            encoder_layers,
            embed_dim,
            out_chans,
            int(decoder_ratio * embed_dim),
            act_layer=act,
            gain=0.5 if big_skip else 1.0,
            dtype=dtype,
            device=device,
        )
        if big_skip:
            self.residual_transform = Conv1x1(inp_chans, out_chans, use_bias=False, kernel_std=math.sqrt(0.5 / inp_chans), dtype=dtype, device=device)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        if self.pos_embed_type == "direct":
            with torch.no_grad():
                self.pos_embed.normal_(0.0, 0.02, generator=generator).clamp_(-0.04, 0.04)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, inp_chans, H, W) -> (B, out_chans, H_out, W_out)."""
        x = x.to(self.dtype).permute(0, 2, 3, 1)
        if self.big_skip:
            if self.out_shape != self.inp_shape:
                k = self.use_kernels
                spec = self.trans_down.analysis_cl(x.to(transform_io_dtype()), use_kernels=k)
                residual = self.itrans_up.synthesis_cl(spec, use_kernels=k).to(x.dtype)
            else:
                residual = x
        x = self.encoder(x)
        if self.pos_embed_type == "direct":
            x = x + self.pos_embed.to(x.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x)
        x = self.decoder(x)
        if self.big_skip:
            x = x + self.residual_transform(residual)
        return x.permute(0, 3, 1, 2)
