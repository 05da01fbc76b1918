"""FourCastNet 3.1 (counterpart of ``makani_tpu/models/networks/fourcastnet3_1.py``),
serial and channels-last.

A restructured FCN3, built from the port's FCN3 modules:

  * one unified DISCO encoder and decoder over every prognostic channel
    (``embed_dim`` wide, ``groups = gcd(n_in, embed_dim)``), where FCN3
    encodes each pressure level apart; at the published widths they mix
    more than 4096 channel pairs, so they take the two-stage path
    (responses K5/K6, channel mix K8; grouped for the history window);
  * a learned latitude embedding ``pos_embed`` (1, P, h, 1), broadcast along
    the longitude and concatenated with the auxiliary embedding before
    every block;
  * ``n_history``: the input holds T = n_history + 1 states, each with its
    own dynamic auxiliary channels (zenith, noise), static auxiliary
    channels once at the end (``_channel_bookkeeping``);
  * the DISCO cutoff from the spectral truncation, ``margin * k * pi /
    lmax`` (``compute_cutoff_radius_lmax``), lmax the input grid's bandlimit
    times ``hard_thresholding_fraction`` unless given;
  * the learned SST imputation (``MLPImputation``), masked by the ``xlsml``
    land-sea mask where that channel is present;
  * a plain big skip from the newest history copy, the decoded channels
    scattered back to dataset order, the soft water clamp with offsets.

The model's I/O is NCHW; the encoders read permuted views, everything
between them and the decoder is channels-last. ``checkpointing_level`` 1
recomputes the unified encoder and the decoder in the backward, 3 also the
blocks, as the JAX package's ``nn.remat``. Parameter names and shapes are
the flax tree's: ``sst_imputation.mlp.*``, ``aux_encoder.conv.weight``,
``pos_embed``, ``encoder.conv.weight``, ``block{i}.*``, ``decoder.conv.weight``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from makani_torch.device import resolve_device
from makani_torch.models.common.imputation import MLPImputation
from makani_torch.models.networks.fourcastnet3 import DiscreteContinuousDecoder, DiscreteContinuousEncoder, FCN3Block, _soft_clamp
from makani_torch.models.networks.sfnonet import _ACTIVATIONS, build_spectral_transforms
from makani_torch.ops.disco import compute_cutoff_radius_lmax
from makani_torch.utils.features import get_channel_groups, get_water_channels

__all__ = ["AtmoSphericNeuralOperatorNet31", "compute_spherical_bandlimit", "fcn31_lmax"]


def compute_spherical_bandlimit(img_shape, grid_type: str) -> int:
    """Bandlimit of a grid (the JAX package's copy of makani's
    ``utils/grids.py``)."""
    if grid_type == "equiangular":
        return min((img_shape[0] - 1) // 2, img_shape[1] // 2)
    if grid_type == "legendre-gauss":
        return min(img_shape[0] - 1, img_shape[1] // 2)
    raise NotImplementedError(f"Unknown grid type {grid_type}")


def fcn31_lmax(inp_shape, internal_shape, model_grid_type: str, sht_grid_type: str, hard_thresholding_fraction: float, lmax: Optional[int] = None) -> int:
    """FCN3.1's spectral truncation: ``lmax``, or the input grid's bandlimit
    times ``hard_thresholding_fraction``, at most the internal grid's
    bandlimit + 1 (90 at 721x1440 with 0.25 and scale 2)."""
    if lmax is None:
        lmax = int(compute_spherical_bandlimit(inp_shape, model_grid_type) * hard_thresholding_fraction)
    return min(lmax, compute_spherical_bandlimit(internal_shape, sht_grid_type) + 1)


class AtmoSphericNeuralOperatorNet31(nn.Module):
    """FCN3.1 forward. Argument names mirror the JAX module's fields."""

    def __init__(
        self,
        model_grid_type: str = "equiangular",
        sht_grid_type: str = "legendre-gauss",
        inp_shape: Tuple[int, int] = (721, 1440),
        out_shape: Tuple[int, int] = (721, 1440),
        kernel_shape: Sequence[int] = (3, 3),
        filter_basis_type: str = "harmonic",
        filter_basis_norm_mode: str = "mean",
        resample_sht: bool = False,
        channel_names: Sequence[str] = ("u500", "v500"),
        aux_channel_names: Sequence[str] = (),
        n_history: int = 0,
        embed_dim: int = 8,
        aux_embed_dim: int = 8,
        pos_embed_dim: int = 0,
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
        hard_thresholding_fraction: float = 0.25,
        scale_factor: int = 8,
        lmax: Optional[int] = None,
        sfno_block_frequency: int = 2,
        big_skip: bool = False,
        clamp_water: bool = False,
        encoder_bias: bool = False,
        use_bias: bool = False,
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
            raise NotImplementedError("the port's FCN3.1 runs channels-last only")
        if checkpointing_level not in (0, 1, 2, 3):
            raise ValueError(f"checkpointing_level {checkpointing_level} (0 to 3)")
        for name, rate in (("pos_drop_rate", pos_drop_rate), ("path_drop_rate", path_drop_rate), ("mlp_drop_rate", mlp_drop_rate)):
            if rate > 0:
                raise NotImplementedError(f"{name} {rate}: dropout is a training feature and is not ported yet")
        device = resolve_device(device)
        self.inp_shape = tuple(inp_shape)
        self.out_shape = tuple(out_shape)
        self.channel_names = tuple(channel_names)
        self.aux_channel_names = tuple(aux_channel_names)
        self.n_history = n_history
        self.num_layers = num_layers
        self.big_skip = big_skip
        self.checkpointing_level = checkpointing_level
        self.embed_dim = embed_dim
        self.dtype = dtype
        act = _ACTIVATIONS[activation_function]
        h = int(self.inp_shape[0] // scale_factor)
        w = int(self.inp_shape[1] // scale_factor)
        self.h, self.w = h, w

        self.lmax = fcn31_lmax(self.inp_shape, (h, w), model_grid_type, sht_grid_type, hard_thresholding_fraction, lmax)
        t_cut = compute_cutoff_radius_lmax(self.lmax, tuple(kernel_shape), filter_basis_type)
        _, _, sht, isht = build_spectral_transforms("sht", (h, w), (h, w), (h, w), (self.lmax, self.lmax), sht_grid_type, sht_grid_type)

        in_idx, aux_idx, pred_idx, resid_idx, sst_in, lsm_in = self._channel_bookkeeping()
        self.n_in, self.n_out, self.n_aux = len(in_idx), len(pred_idx), len(aux_idx)
        self.pos_embed_dim = pos_embed_dim
        total_aux = (aux_embed_dim if self.n_aux > 0 else 0) + pos_embed_dim
        self.has_aux = total_aux > 0
        for name, idx in (("in_idx", in_idx), ("aux_idx", aux_idx), ("pred_idx", pred_idx), ("resid_idx", resid_idx), ("lsm_idx", lsm_in)):
            self.register_buffer(name, torch.as_tensor(idx, dtype=torch.long, device=device), persistent=False)
        water = get_water_channels(list(channel_names)) if clamp_water else []
        self.register_buffer("water_idx", torch.as_tensor(water, dtype=torch.long, device=device), persistent=False)
        offset = np.zeros(len(water), np.float32)
        if water and water_means is not None and water_stds is not None:
            offset = (np.asarray(water_means)[water] / np.asarray(water_stds)[water]).astype(np.float32)
        self.register_buffer("water_offset", torch.from_numpy(offset).reshape(1, -1, 1, 1).to(device), persistent=False)

        n_total = self._n_input_channels()
        if sst_in:
            self.sst_imputation = MLPImputation(n_total, sst_in, mlp_ratio=mlp_ratio, act_layer=act, dtype=dtype, device=device)

        common = dict(kernel_shape=tuple(kernel_shape), basis_type=filter_basis_type, basis_norm_mode=filter_basis_norm_mode, theta_cutoff=t_cut, dtype=dtype, device=device)
        enc = dict(common, grid_in=model_grid_type, grid_out=sht_grid_type, use_bias=encoder_bias)
        if self.n_aux > 0:
            self.aux_encoder = DiscreteContinuousEncoder(
                self.inp_shape, (h, w), self.n_aux, aux_embed_dim, groups=math.gcd(self.n_aux, aux_embed_dim), **enc
            )
        if pos_embed_dim > 0:
            self.pos_embed = nn.Parameter(torch.zeros(1, pos_embed_dim, h, 1, device=device))
        self.encoder = DiscreteContinuousEncoder(self.inp_shape, (h, w), self.n_in, embed_dim, groups=math.gcd(self.n_in, embed_dim), **enc)

        for i in range(num_layers):
            conv_type = "global" if sfno_block_frequency > 0 and i % sfno_block_frequency == 0 else "local"
            block = FCN3Block(
                sht,
                isht,
                embed_dim + total_aux,
                embed_dim,
                conv_type=conv_type,
                internal_shape=(h, w),
                grid_type=sht_grid_type,
                mlp_ratio=mlp_ratio,
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

        self.decoder = DiscreteContinuousDecoder(
            (h, w), self.out_shape, embed_dim, self.n_out, grid_in=sht_grid_type, grid_out=model_grid_type, groups=math.gcd(self.n_out, embed_dim),
            upsample_sht=resample_sht, **common,
        )

    def _dynamic_static_aux(self):
        aux = list(self.aux_channel_names)
        dyn = [n for n in aux if n.startswith(("xzen", "xnoise"))]
        return dyn, [n for n in aux if not n.startswith(("xzen", "xnoise"))]

    def _n_input_channels(self) -> int:
        dyn, stat = self._dynamic_static_aux()
        return (self.n_history + 1) * (len(self.channel_names) + len(dyn)) + len(stat)

    def _channel_bookkeeping(self):
        """Per-history-step channel index maps, as the JAX package's: the
        input is ``[prognostic..., dynamic aux (xzen/xnoise)...] x T`` then
        the static aux once. Returns the unified encoder's input channels
        (surface then atmospheric, each over every step), the aux encoder's,
        the decoder's outputs in dataset positions, the big skip's source
        (the newest copy), every copy of sst and the land-sea mask."""
        atmo, surf, _, _, _ = get_channel_groups(list(self.channel_names), [])
        dyn, stat = self._dynamic_static_aux()
        T = self.n_history + 1
        n_prog = len(self.channel_names)
        n_dyn = n_prog + len(dyn)
        in_idx = [t * n_dyn + c for t in range(T) for c in surf] + [t * n_dyn + c for t in range(T) for c in atmo]
        aux_idx = [t * n_dyn + n_prog + j for t in range(T) for j in range(len(dyn))] + [T * n_dyn + j for j in range(len(stat))]
        pred_idx = list(surf) + list(atmo)
        resid_idx = [(T - 1) * n_dyn + c for c in pred_idx]
        sst = [i for i, n in enumerate(self.channel_names) if n == "sst"]
        sst_in = [t * n_dyn + c for t in range(T) for c in sst]
        lsm_in = [T * n_dyn + stat.index("xlsml")] if "xlsml" in stat else []
        return in_idx, aux_idx, pred_idx, resid_idx, sst_in, lsm_in

    def _run(self, module: nn.Module, x: torch.Tensor, level: int) -> torch.Tensor:
        """module(x), recomputed in the backward from x when the model's
        checkpointing level is at least ``level`` and gradients are recorded."""
        if self.checkpointing_level >= level and torch.is_grad_enabled():
            return checkpoint(module, x, use_reentrant=False)
        return module(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T*(n_prog + n_dyn_aux) + n_static, H, W) -> (B, n_prog, H, W), NCHW."""
        n_expected = self._n_input_channels()
        if x.shape[1] != n_expected:
            raise ValueError(f"FCN3.1 expects {n_expected} input channels ({self.n_history + 1} states), got {x.shape[1]}")
        pad_h = x.shape[-2] - self.inp_shape[0]
        if pad_h > 0:
            x = x[..., : self.inp_shape[0], :]
        B = x.shape[0]
        h, w = self.h, self.w

        if hasattr(self, "sst_imputation"):
            mask = None
            if self.lsm_idx.numel():
                mask = x.index_select(1, self.lsm_idx)[:, :1] > 0.5
                n_sst = len(self.sst_imputation.impute_chans)
                if n_sst > 1:
                    mask = mask.expand(B, n_sst, *x.shape[-2:])
            x = self.sst_imputation(x, mask=mask)
        residual = x.index_select(1, self.resid_idx) if self.big_skip else None

        z_aux = None
        if self.has_aux:
            parts = []
            if self.n_aux > 0:
                parts.append(self.aux_encoder(x.index_select(1, self.aux_idx).permute(0, 2, 3, 1)))
            if self.pos_embed_dim > 0:
                parts.append(self.pos_embed.to(self.dtype).permute(0, 2, 3, 1).expand(B, h, w, self.pos_embed_dim))
            z_aux = torch.cat(parts, dim=-1)  # promotes as jnp.concatenate: fp32 with a bf16 embedding is fp32

        z = self._run(self.encoder, x.index_select(1, self.in_idx).permute(0, 2, 3, 1), 1)
        for i in range(self.num_layers):
            if z_aux is not None:
                z = torch.cat([z, z_aux], dim=-1)
            z = self._run(getattr(self, f"block{i}"), z, 3)

        y = self._run(self.decoder, z[..., : self.embed_dim], 1).permute(0, 3, 1, 2)  # (B, n_out, H, W)
        if residual is not None:
            y = y + residual.to(y.dtype)
        out = torch.zeros(B, self.n_out, *self.out_shape, dtype=y.dtype, device=y.device).index_copy(1, self.pred_idx, y)

        if self.water_idx.numel():
            off = self.water_offset
            clamped = _soft_clamp(out[:, self.water_idx], offset=off) - off
            out = out.index_copy(1, self.water_idx, clamped.to(out.dtype))

        if pad_h > 0:
            out = nn.functional.pad(out, (0, 0, 0, pad_h))
        return out
