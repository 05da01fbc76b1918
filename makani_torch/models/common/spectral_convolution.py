"""Linear spectral convolution (counterpart of ``SpectralConv`` in
``makani_tpu/models/common/spectral_convolution.py``, channels-last branch).

    y = ISHT( W . SHT(x) )

with one weight per degree l ("dhconv") or per (l, m) pair ("diagonal").
The transforms take the dtype of the precision policy (fp32 under
``highest``); the contraction runs in the transform dtype, with the weight
cast to bf16 for bf16 spectra. Complex weights are a trailing re/im pair.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from makani_torch.device import resolve_device
from makani_torch.models.common.contractions import _PermutedWeight, contract_dense_s, contract_dense_s_plain
from makani_torch.ops.precision import transform_io_dtype

__all__ = ["SpectralConv"]


class SpectralConv(nn.Module):
    """Linear spectral convolution on channels-last (B, H, W, C) input;
    returns ``(y, residual)`` so callers can form skips at the output
    resolution. ``weight`` has the flax tree's shape, e.g. dhconv dense
    (1, C_in, C_out, L, 2)."""

    def __init__(
        self,
        forward_transform,
        inverse_transform,
        in_channels: int,
        out_channels: int,
        operator_type: str = "dhconv",
        separable: bool = False,
        use_bias: bool = False,
        gain: float = 1.0,
        device=None,
    ):
        super().__init__()
        if separable and in_channels != out_channels:
            raise ValueError("separable requires in_channels == out_channels")
        self.forward_transform = forward_transform
        self.inverse_transform = inverse_transform
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.operator_type = operator_type
        self.separable = separable
        self.gain = gain
        self.use_kernels = True

        modes_lat = inverse_transform.lmax
        modes_lon = inverse_transform.mmax
        self.scale_residual = (
            forward_transform.nlat != inverse_transform.nlat
            or forward_transform.nlon != inverse_transform.nlon
            or getattr(forward_transform, "grid", None) != getattr(inverse_transform, "grid", None)
        )

        # one channel group, as the SFNO uses: (1, C_in, [C_out,] L[, M])
        wshape = [1, in_channels]
        if not separable:
            wshape += [out_channels]
        if operator_type == "diagonal":
            wshape += [modes_lat, modes_lon]
            self._l_axis = len(wshape) - 2
        elif operator_type == "dhconv":
            wshape += [modes_lat]
            self._l_axis = len(wshape) - 1
        else:
            raise ValueError(f"Unsupported operator type {operator_type}")
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(*wshape, 2, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(1, out_channels, 1, 1, device=device))
        else:
            self.register_parameter("bias", None)
        self._weight_cache = _PermutedWeight()
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        # complex normal with a per-degree std; the l=0 entry is boosted by
        # sqrt(2) (m=0 coefficients are real-only)
        modes_lat = self.weight.shape[self._l_axis]
        scale = torch.full((modes_lat,), math.sqrt(self.gain / self.in_channels), device=self.weight.device)
        scale[0] *= math.sqrt(2.0)
        bshape = [1] * self.weight.dim()
        bshape[self._l_axis] = modes_lat
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)
            self.weight.mul_(scale.reshape(bshape) / math.sqrt(2.0))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor):
        dtype = x.dtype
        residual = x
        fwd, inv, k = self.forward_transform, self.inverse_transform, self.use_kernels
        # x: (B, H, W, C); spectral layout (B, L, M, C, 2)
        xc2 = fwd.analysis_cl(x.to(transform_io_dtype()), use_kernels=k)
        if self.scale_residual:
            residual = inv.synthesis_cl(xc2, use_kernels=k).to(dtype)
        B, L, M = xc2.shape[:3]
        xg2 = xc2.reshape(B, L, M, 1, self.in_channels, 2)
        if k:
            yg2 = contract_dense_s(xg2, self.weight, self.separable, self.operator_type, channels_last=True, weight_cache=self._weight_cache)
        else:
            yg2 = contract_dense_s_plain(xg2, self.weight, self.separable, self.operator_type, channels_last=True)
        y2 = yg2.reshape(B, L, M, self.out_channels, 2)
        y = inv.synthesis_cl(y2, use_kernels=k).to(dtype)
        if self.bias is not None:
            y = y + self.bias.reshape(1, 1, 1, self.out_channels).to(dtype)
        return y, residual
