"""FourCastNet 3 (counterpart of ``makani_tpu/models/networks/fourcastnet3.py``),
serial and channels-last.

  * channel-grouped DISCO encoders: every pressure level runs through one
    shared atmospheric encoder, plus a surface and an auxiliary encoder;
  * a processor of blocks alternating local DISCO convolutions and global
    spectral (SHT) convolutions (``sfno_block_frequency``), with the
    auxiliary features re-concatenated before every block;
  * DISCO decoders after bilinear (or spectral) upsampling to the data grid,
    soft water-channel clamping and an optional big-skip residual.

The model's I/O is NCHW, as in the JAX package; everything between the
encoders and the decoders is channels-last (B, H, W, C). The encoders read
the NCHW input through a permuted view, and the JAX package's fold of the
pressure levels into the batch becomes a fold into the channel axis
(``DiscoConvS2.fused_cl``), so no layout copy is made for either.

Precision follows the JAX package: every DISCO contraction and its channel
mix run in fp32 (the conv's compute dtype), the decoders in fp32, and only
the MLPs (and 1x1 convs) in the compute dtype; an fp32 residual stream plus
a bf16 branch stays fp32, as in JAX's type promotion.

Training: every op of the forward is differentiable (the DISCO convs and
the resampling through their kernels' autograd functions, K12-K14 in the
backward; the processor's channel mix through ``disco_kernels.ChannelMix``).
``checkpointing_level`` 1 and 2 recompute the encoders and decoders in the
backward, 3 also the processor blocks, as the JAX package's ``nn.remat``
(``torch.utils.checkpoint`` without reentrance, only while gradients are
recorded).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from makani_torch.device import resolve_device
from makani_torch.models.common.layer_norm import InstanceNorm2d
from makani_torch.models.common.layers import MLP, Conv1x1, DropPath, EncoderDecoder, LayerScale
from makani_torch.models.common.spectral_convolution import SpectralConv
from makani_torch.models.networks.sfnonet import _ACTIVATIONS, build_spectral_transforms
from makani_torch.ops import disco_kernels
from makani_torch.ops.disco import FusedFilterCache, compute_cutoff_radius, make_disco_conv
from makani_torch.ops.precision import fp32_exact
from makani_torch.ops.resample import make_resample
from makani_torch.ops.sht import InverseRealSHT, RealSHT
from makani_torch.utils.features import get_channel_groups, get_water_channels

__all__ = ["DiscoConv", "DiscreteContinuousEncoder", "DiscreteContinuousDecoder", "FCN3Block", "AtmoSphericNeuralOperatorNet"]


def _soft_clamp(x, offset=0.0):
    """Smooth positive clamp."""
    x = x + offset
    y = torch.where(x > 0.0, torch.square(x), torch.zeros((), dtype=x.dtype, device=x.device))
    return torch.where(x >= 0.5, x - 0.25, y)


class DiscoConv(nn.Module):
    """Learnable DISCO convolution: basis responses (``ops.disco``) and
    grouped channel mixing, channels-last. ``weight`` is (g, og, ig, K) fp32
    as in the flax tree.

    The input is a (B, Hin, Win, R*in_channels) view of any strides; R > 1
    applies the conv to R stacked inputs with shared weights (the JAX
    package's batch fold). Small convs (g*og*ig <= 4096: FCN3's encoders and
    decoders) take the weight-fused path; the others (FCN3's processor,
    FCN3.1's encoders, decoders and processor) compute the basis responses
    (K5, K6) and mix them with one fp32 GEMM (K8), inserting the mixed polar
    rows with an indexed add. A grouped two-stage conv (FCN3.1's history
    encoder, groups 2) does so group by group: each group's responses are
    a buffer of their own, pixels ``RESPONSE_ALIGN`` floats apart, so K8
    reads every group's rows 16 bytes at a time, and the groups' outputs
    are concatenated on the channel axis."""

    def __init__(self, conv_op, in_channels: int, out_channels: int, groups: int = 1, use_bias: bool = False, gain: float = 1.0, device=None):
        super().__init__()
        g = groups
        if in_channels % g or out_channels % g:
            raise ValueError(f"channels ({in_channels}->{out_channels}) not divisible by groups ({g})")
        self.conv_op = conv_op
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.groups = g
        self.gain = gain
        self.use_kernels = True
        self.fused = g * (out_channels // g) * (in_channels // g) <= 4096
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(g, out_channels // g, in_channels // g, conv_op.K, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        else:
            self.register_parameter("bias", None)
        self._filters = FusedFilterCache()
        self._mix_planes = [disco_kernels.MixPlanes() for _ in range(g)]
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        # the init std compensates the per-basis L1 response mass of the psi
        # tables, as the JAX package's DiscoConv does
        mass_sq = float(np.sum(np.square(self.conv_op.init_mass)))
        std = math.sqrt(self.gain / (self.weight.shape[2] * max(mass_sq, 1e-12)))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        xf = x.float()
        op, k = self.conv_op, self.use_kernels
        if self.fused:
            y = op.fused_cl(xf, self.weight, k, self._filters)
        else:
            y = self._two_stage(xf)
        if self.bias is not None:
            y = (y.reshape(*y.shape[:-1], -1, self.out_channels) + self.bias).reshape(y.shape)
        return y.to(dtype)

    def _mix(self, t: torch.Tensor, gi: int = 0) -> torch.Tensor:
        """t (..., ig, K) fp32 -> (..., og): group gi's ``bik,oik->bo``, one
        GEMM (K8, or its plain version), reading t's rows through their pixel
        stride (no copy)."""
        og = self.out_channels // self.groups
        w = self.weight[gi].float().reshape(og, -1)
        t2 = t.reshape(-1, w.shape[1])
        y = disco_kernels.ChannelMix.apply(t2, w, self._mix_planes[gi]) if self.use_kernels else disco_kernels.channel_mix_plain(t2, w)
        return y.reshape(*t.shape[:-2], og)

    def _mix_polar(self, t_pol: torch.Tensor, gi: int = 0) -> torch.Tensor:
        """t_pol (B, P, ig, K, W) fp32 -> (B, P, W, og), a transposed view:
        group gi's ``oik,bpikw->bpow``, one batched GEMM that reads t_pol in
        the irFFT's layout (no copy); the indexed add reads the result
        through the view."""
        B, P, C, K, W = t_pol.shape
        og = self.out_channels // self.groups
        w = self.weight[gi].float().reshape(og, C * K)
        with fp32_exact():
            y = torch.bmm(w.expand(B * P, og, C * K), t_pol.reshape(B * P, C * K, W))
        return y.view(B, P, og, W).transpose(2, 3)

    def _two_stage(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"the two-stage DISCO conv takes {self.in_channels} channels, got {x.shape[-1]}")
        g = self.groups
        ig = self.in_channels // g
        ys = []
        for gi in range(g):
            xg = x if g == 1 else x[..., gi * ig : (gi + 1) * ig]
            t, t_pol = self.conv_op.responses_cl(xg, self.use_kernels)
            y = self._mix(t, gi)
            del t
            if t_pol is not None:
                _, rows = self.conv_op.polar_index(x.device)
                y.index_add_(1, rows, self._mix_polar(t_pol, gi))
            ys.append(y)
        return ys[0] if g == 1 else torch.cat(ys, dim=-1)


class DiscreteContinuousEncoder(nn.Module):
    """DISCO conv from the data grid onto the model grid: (B, Hin, Win,
    R*inp_chans) view -> (B, h, w, R*out_chans)."""

    def __init__(
        self,
        inp_shape,
        out_shape,
        inp_chans: int,
        out_chans: int,
        grid_in: str = "equiangular",
        grid_out: str = "equiangular",
        kernel_shape: Sequence[int] = (3, 3),
        basis_type: str = "piecewise linear",
        basis_norm_mode: str = "mean",
        use_mlp: bool = False,
        mlp_ratio: float = 2.0,
        act_layer: Callable = nn.functional.gelu,
        groups: int = 1,
        use_bias: bool = False,
        theta_cutoff: Optional[float] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        theta_cutoff = theta_cutoff or compute_cutoff_radius(inp_shape[0], kernel_shape, basis_type)
        conv_op = make_disco_conv(
            tuple(inp_shape), tuple(out_shape), tuple(kernel_shape), basis_type=basis_type, basis_norm_mode=basis_norm_mode,
            grid_in=grid_in, grid_out=grid_out, theta_cutoff=theta_cutoff,
        )
        self.use_mlp = use_mlp
        self.act_layer = act_layer
        self.out_chans = out_chans
        self.conv = DiscoConv(conv_op, inp_chans, out_chans, groups=groups, use_bias=use_bias, gain=2.0 if use_mlp else 1.0, device=device)
        if use_mlp:
            self.mlp = EncoderDecoder(1, out_chans, out_chans, int(mlp_ratio * out_chans), act_layer=act_layer, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.use_mlp:
            lead = x.shape[:-1]
            x = self.mlp(self.act_layer(x).reshape(*lead, -1, self.out_chans)).reshape(*lead, -1)
        return x


class DiscreteContinuousDecoder(nn.Module):
    """Upsample (bilinear, or spectral) then DISCO conv back to the data
    grid, in fp32: (B, h, w, R*inp_chans) -> (B, H, W, R*out_chans) in the
    input's dtype."""

    def __init__(
        self,
        inp_shape,
        out_shape,
        inp_chans: int,
        out_chans: int,
        grid_in: str = "legendre-gauss",
        grid_out: str = "equiangular",
        kernel_shape: Sequence[int] = (3, 3),
        basis_type: str = "piecewise linear",
        basis_norm_mode: str = "mean",
        use_mlp: bool = False,
        mlp_ratio: float = 2.0,
        act_layer: Callable = nn.functional.gelu,
        groups: int = 1,
        use_bias: bool = False,
        upsample_sht: bool = False,
        theta_cutoff: Optional[float] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.use_mlp = use_mlp
        self.act_layer = act_layer
        self.inp_chans = inp_chans
        self.upsample_sht = upsample_sht
        self.use_kernels = True
        if use_mlp:
            self.mlp = EncoderDecoder(1, inp_chans, inp_chans, int(mlp_ratio * inp_chans), act_layer=act_layer, gain=2.0, dtype=dtype, device=device)
        if upsample_sht:
            self.sht = RealSHT(*inp_shape, grid=grid_in)
            self.isht = InverseRealSHT(*out_shape, lmax=self.sht.lmax, mmax=self.sht.mmax, grid=grid_out)
        else:
            self.resample = make_resample(*inp_shape, *out_shape, grid_in=grid_in, grid_out=grid_out)
        theta_cutoff = theta_cutoff or compute_cutoff_radius(out_shape[0], kernel_shape, basis_type)
        conv_op = make_disco_conv(
            tuple(out_shape), tuple(out_shape), tuple(kernel_shape), basis_type=basis_type, basis_norm_mode=basis_norm_mode,
            grid_in=grid_out, grid_out=grid_out, theta_cutoff=theta_cutoff,
        )
        self.conv = DiscoConv(conv_op, inp_chans, out_chans, groups=groups, use_bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_mlp:
            lead = x.shape[:-1]
            x = self.mlp(self.act_layer(x).reshape(*lead, -1, self.inp_chans)).reshape(*lead, -1)
        dtype = x.dtype
        x = x.float()
        if self.upsample_sht:
            x = self.isht.synthesis_cl(self.sht.analysis_cl(x, self.use_kernels), self.use_kernels)
        else:
            x = self.resample.resample_cl(x, self.use_kernels)
        return self.conv(x).to(dtype)


class FCN3Block(nn.Module):
    """FCN3 processor block, channels-last: norm -> local DISCO / global
    spectral conv -> norm -> MLP -> layer scale, plus the identity skip."""

    def __init__(
        self,
        forward_transform,
        inverse_transform,
        inp_chans: int,
        out_chans: int,
        conv_type: str = "local",
        internal_shape: Tuple[int, int] = (None, None),
        grid_type: str = "legendre-gauss",
        mlp_ratio: float = 2.0,
        mlp_drop_rate: float = 0.0,
        path_drop_rate: float = 0.0,
        act_layer: Callable = nn.functional.gelu,
        normalization_layer: str = "none",
        num_groups: int = 1,
        skip: str = "identity",
        layer_scale: bool = True,
        use_mlp: bool = True,
        kernel_shape: Sequence[int] = (3, 3),
        basis_type: str = "piecewise linear",
        basis_norm_mode: str = "mean",
        use_bias: bool = False,
        theta_cutoff: Optional[float] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        if skip != "identity":
            raise NotImplementedError(f"skip {skip!r} is not ported yet (FCN3 uses the identity skip)")
        if normalization_layer not in ("none", "instance_norm"):
            raise NotImplementedError(f"normalization {normalization_layer!r} is not ported yet (none or instance_norm)")
        if mlp_drop_rate > 0:
            raise NotImplementedError("MLP dropout is a training feature and is not ported yet")

        def norm():
            if normalization_layer == "none":
                return None
            return InstanceNorm2d(inp_chans, eps=1e-6, affine=True, channels_last=True, device=device)

        self.out_chans = out_chans
        self.norm1 = norm()
        if conv_type == "global":
            if num_groups != 1:
                raise NotImplementedError("grouped spectral convolutions are not ported yet")
            self.global_conv = SpectralConv(forward_transform, inverse_transform, inp_chans, inp_chans, operator_type="dhconv", use_bias=use_bias, device=device)
        elif conv_type == "local":
            theta_cutoff = theta_cutoff or 2 * compute_cutoff_radius(internal_shape[0], kernel_shape, basis_type)
            conv_op = make_disco_conv(
                tuple(internal_shape), tuple(internal_shape), tuple(kernel_shape), basis_type=basis_type, basis_norm_mode=basis_norm_mode,
                grid_in=grid_type, grid_out=grid_type, theta_cutoff=theta_cutoff,
            )
            self.local_conv = DiscoConv(conv_op, inp_chans, inp_chans, groups=num_groups, device=device)
        else:
            raise ValueError(f"Unknown convolution type {conv_type}")
        self.norm2 = norm()
        self.mlp = MLP(inp_chans, int(inp_chans * mlp_ratio), out_chans, act_layer=act_layer, dtype=dtype, device=device) if use_mlp else None
        self.drop_path = DropPath(path_drop_rate) if path_drop_rate > 0 else None
        self.layer_scale = LayerScale(out_chans, channels_last=True, device=device) if layer_scale else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm1 is not None:
            x = self.norm1(x)
        if hasattr(self, "global_conv"):
            dx, _ = self.global_conv(x)
        else:
            dx = self.local_conv(x)
        if self.norm2 is not None:
            dx = self.norm2(dx)
        if self.mlp is not None:
            dx = self.mlp(dx)
        if self.drop_path is not None:
            dx = self.drop_path(dx)
        if self.layer_scale is not None:
            dx = self.layer_scale(dx)
        return x[..., : self.out_chans] + dx


class AtmoSphericNeuralOperatorNet(nn.Module):
    """FCN3 forward. Argument names mirror the JAX module's fields;
    parameter names and shapes mirror its flax tree (``atmo_encoder.conv.
    weight``, ``block1.local_conv.weight``, ``block0.global_conv.weight``,
    ``block0.layer_scale.gamma``, ...)."""

    def __init__(
        self,
        model_grid_type: str = "equiangular",
        sht_grid_type: str = "legendre-gauss",
        inp_shape: Tuple[int, int] = (721, 1440),
        out_shape: Tuple[int, int] = (721, 1440),
        kernel_shape: Sequence[int] = (3, 3),
        filter_basis_type: str = "piecewise linear",
        filter_basis_norm_mode: str = "mean",
        scale_factor: int = 8,
        encoder_mlp: bool = False,
        upsample_sht: bool = False,
        channel_names: Sequence[str] = ("u500", "v500"),
        aux_channel_names: Sequence[str] = (),
        atmo_embed_dim: int = 8,
        surf_embed_dim: int = 8,
        aux_embed_dim: int = 8,
        num_layers: int = 4,
        num_groups: int = 1,
        use_mlp: bool = True,
        mlp_ratio: float = 2.0,
        activation_function: str = "gelu",
        layer_scale: bool = True,
        pos_drop_rate: float = 0.0,
        path_drop_rate: float = 0.0,
        mlp_drop_rate: float = 0.0,
        normalization_layer: str = "none",
        max_modes: Optional[Tuple[int, int]] = None,
        hard_thresholding_fraction: float = 1.0,
        sfno_block_frequency: int = 2,
        big_skip: bool = False,
        clamp_water: bool = False,
        use_bias: bool = False,
        theta_cutoff_mode: str = "nlat",
        channels_last: bool = True,
        checkpointing_level: int = 0,
        water_means=None,
        water_stds=None,
        inp_chans: int = 0,
        out_chans: int = 0,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        if not channels_last:
            raise NotImplementedError("the port's FCN3 runs channels-last only")
        if checkpointing_level not in (0, 1, 2, 3):
            raise ValueError(f"checkpointing_level {checkpointing_level} (0 to 3)")
        if pos_drop_rate > 0:
            raise NotImplementedError("input dropout is a training feature and is not ported yet")
        device = resolve_device(device)
        self.inp_shape = tuple(inp_shape)
        self.out_shape = tuple(out_shape)
        self.channel_names = tuple(channel_names)
        self.aux_channel_names = tuple(aux_channel_names)
        self.num_layers = num_layers
        self.big_skip = big_skip
        self.clamp_water = clamp_water
        self.checkpointing_level = checkpointing_level
        self.dtype = dtype
        act = _ACTIVATIONS[activation_function]
        h = int(self.inp_shape[0] // scale_factor)
        w = int(self.inp_shape[1] // scale_factor)
        self.h, self.w = h, w
        if max_modes is not None:
            modes = tuple(max_modes)
        else:
            modes = (int(h * hard_thresholding_fraction), int((w // 2 + 1) * hard_thresholding_fraction))
        t_cut = kernel_shape[0] * math.pi / float(max(modes[0], 1)) if theta_cutoff_mode == "lmax" else None
        _, _, sht, isht = build_spectral_transforms("sht", (h, w), (h, w), (h, w), modes, sht_grid_type, sht_grid_type)

        atmo_chans, surf_chans, dyn_aux, stat_aux, plvls = get_channel_groups(list(channel_names), list(aux_channel_names))
        aux_chans = list(dyn_aux) + list(stat_aux)
        self.n_atmo_groups = len(plvls)
        self.n_atmo = len(atmo_chans) // max(self.n_atmo_groups, 1)
        self.n_surf = len(surf_chans)
        self.n_aux = len(aux_chans)
        self.n_out_chans = self.n_atmo_groups * self.n_atmo + self.n_surf
        self.atmo_embed_dim, self.surf_embed_dim, self.aux_embed_dim = atmo_embed_dim, surf_embed_dim, aux_embed_dim
        total_embed = self.n_atmo_groups * atmo_embed_dim + surf_embed_dim * (self.n_surf > 0)
        self.channel_groups = {"atmo": list(atmo_chans), "surf": list(surf_chans), "aux": aux_chans}
        for name, idx in self.channel_groups.items():
            self.register_buffer(f"{name}_idx", torch.as_tensor(idx, dtype=torch.long, device=device), persistent=False)
        water = get_water_channels(list(channel_names)) if clamp_water else []
        self.register_buffer("water_idx", torch.as_tensor(water, dtype=torch.long, device=device), persistent=False)
        offset = np.zeros(len(water), np.float32)
        if water and water_means is not None and water_stds is not None:
            offset = (np.asarray(water_means)[water] / np.asarray(water_stds)[water]).astype(np.float32)
        self.register_buffer("water_offset", torch.from_numpy(offset).reshape(1, -1, 1, 1).to(device), persistent=False)

        common = dict(
            kernel_shape=tuple(kernel_shape), basis_type=filter_basis_type, basis_norm_mode=filter_basis_norm_mode, use_mlp=encoder_mlp,
            act_layer=act, use_bias=use_bias, theta_cutoff=t_cut, dtype=dtype, device=device,
        )
        enc = dict(common, grid_in=model_grid_type, grid_out=sht_grid_type)
        if atmo_chans:
            self.atmo_encoder = DiscreteContinuousEncoder(
                self.inp_shape, (h, w), self.n_atmo, atmo_embed_dim, groups=math.gcd(self.n_atmo, atmo_embed_dim), **enc
            )
        if self.n_surf > 0:
            self.surf_encoder = DiscreteContinuousEncoder(
                self.inp_shape, (h, w), self.n_surf, surf_embed_dim, groups=math.gcd(self.n_surf, surf_embed_dim), **enc
            )
        if self.n_aux > 0:
            self.aux_encoder = DiscreteContinuousEncoder(
                self.inp_shape, (h, w), self.n_aux, aux_embed_dim, groups=math.gcd(self.n_aux, aux_embed_dim), **enc
            )

        dpr = np.linspace(0, path_drop_rate, num_layers)
        for i in range(num_layers):
            block = FCN3Block(
                sht,
                isht,
                total_embed + (aux_embed_dim if self.n_aux > 0 else 0),
                total_embed,
                conv_type="global" if i % sfno_block_frequency == 0 else "local",
                internal_shape=(h, w),
                grid_type=sht_grid_type,
                mlp_ratio=mlp_ratio,
                mlp_drop_rate=mlp_drop_rate,
                path_drop_rate=float(dpr[i]),
                act_layer=act,
                normalization_layer=normalization_layer,
                num_groups=num_groups,
                skip="identity",
                layer_scale=layer_scale,
                use_mlp=use_mlp,
                kernel_shape=tuple(kernel_shape),
                basis_type=filter_basis_type,
                basis_norm_mode=filter_basis_norm_mode,
                use_bias=use_bias,
                theta_cutoff=t_cut,
                dtype=dtype,
                device=device,
            )
            self.add_module(f"block{i}", block)

        dec = dict(common, grid_in=sht_grid_type, grid_out=model_grid_type, upsample_sht=upsample_sht)
        if atmo_chans:
            self.atmo_decoder = DiscreteContinuousDecoder((h, w), self.out_shape, atmo_embed_dim, self.n_atmo, groups=math.gcd(self.n_atmo, atmo_embed_dim), **dec)
        if self.n_surf > 0:
            self.surf_decoder = DiscreteContinuousDecoder((h, w), self.out_shape, surf_embed_dim, self.n_surf, groups=math.gcd(self.n_surf, surf_embed_dim), **dec)
        if big_skip:
            self.residual_transform = Conv1x1(
                self.n_out_chans, self.n_out_chans, use_bias=False, kernel_std=math.sqrt(0.5 / self.n_out_chans), dtype=dtype, device=device
            )

    def _channels(self, x: torch.Tensor, group: str) -> torch.Tensor:
        """The NCHW channels of ``group`` as a channels-last view: a slice
        when they are a contiguous range, else one gather."""
        idx = self.channel_groups[group]
        if idx == list(range(idx[0], idx[0] + len(idx))):
            sel = x[:, idx[0] : idx[0] + len(idx)]
        else:
            sel = x.index_select(1, getattr(self, f"{group}_idx"))
        return sel.permute(0, 2, 3, 1)

    def _run(self, module: nn.Module, x: torch.Tensor, level: int) -> torch.Tensor:
        """module(x), recomputed in the backward from x when the model's
        checkpointing level is at least ``level`` and gradients are recorded."""
        if self.checkpointing_level >= level and torch.is_grad_enabled():
            return checkpoint(module, x, use_reentrant=False)
        return module(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, n_channels + n_aux, H, W) -> (B, n_out, H, W), NCHW."""
        n_expected = len(self.channel_names) + len(self.aux_channel_names)
        if x.shape[1] != n_expected:
            raise ValueError(f"FCN3 expects a single-step input of {n_expected} channels, got {x.shape[1]}")
        pad_h = x.shape[-2] - self.inp_shape[0]
        if pad_h > 0:
            x = x[..., : self.inp_shape[0], :]
        B = x.shape[0]
        H, W = self.out_shape

        # encode; the pressure levels are stacked on the channel axis
        parts = []
        if hasattr(self, "atmo_encoder"):
            parts.append(self._run(self.atmo_encoder, self._channels(x, "atmo"), 1))
        if self.n_surf > 0:
            parts.append(self._run(self.surf_encoder, self._channels(x, "surf"), 1))
        z = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        z_aux = self._run(self.aux_encoder, self._channels(x, "aux"), 1) if self.n_aux > 0 else None

        for i in range(self.num_layers):
            if z_aux is not None:
                z = torch.cat([z, z_aux], dim=-1)
            z = self._run(getattr(self, f"block{i}"), z, 3)

        out = torch.empty(B, self.n_out_chans, H, W, dtype=x.dtype, device=x.device)
        n_atmo_embed = self.n_atmo_groups * self.atmo_embed_dim
        if hasattr(self, "atmo_decoder"):
            ya = self._run(self.atmo_decoder, z[..., :n_atmo_embed], 1)  # (B, H, W, n_groups*n_atmo)
            out.index_copy_(1, self.atmo_idx, ya.permute(0, 3, 1, 2).to(x.dtype))
        if self.n_surf > 0:
            ys = self._run(self.surf_decoder, z[..., z.shape[-1] - self.surf_embed_dim :], 1)
            out.index_copy_(1, self.surf_idx, ys.permute(0, 3, 1, 2).to(x.dtype))

        if self.big_skip:
            residual = x[:, : self.n_out_chans].permute(0, 2, 3, 1)
            out = out + self.residual_transform(residual).permute(0, 3, 1, 2)

        if self.water_idx.numel():
            off = self.water_offset
            clamped = _soft_clamp(out[:, self.water_idx], offset=off) - off
            out.index_copy_(1, self.water_idx, clamped.to(out.dtype))

        if pad_h > 0:
            out = nn.functional.pad(out, (0, 0, 0, pad_h))
        return out
