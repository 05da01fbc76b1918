"""Bilinear resampling on the sphere (counterpart of ``ResampleS2`` in
``makani_tpu/ops/resample.py``, its gather method).

Separable bilinear interpolation between equiangular (or Legendre-Gauss)
lat-lon grids: a latitude lerp at precomputed (index, weight) pairs, then a
periodic longitude lerp, in the JAX package's order of operations.

Kernel K7 (Triton) replaces ``ResampleS2.__call__`` (:90-99), which XLA runs
as index gathers and elementwise passes. It is bound by memory bandwidth: at
the FCN3 decoders (B 2, 360x720 -> 721x1440, 585 channels) it writes 4.9 GB
and reads 1.2 GB. The kernel fuses the four gathers and both lerps into one
pass over the output: each output element reads its four neighbours
(channel-contiguous, so neighbouring lanes read neighbouring addresses) and
writes once; the intermediate latitude-lerped field never reaches device
memory. The matmul and ``auto`` methods serve the spatially sharded mesh and
arrive with the spatial-parallel slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from makani_torch import kernels
from makani_torch.ops.quadrature import precompute_latitudes

__all__ = ["ResampleS2", "make_resample", "resample_cl", "resample_cl_plain"]


def resample_cl_plain(x, lat_idx, lat_w, lon_idx0, lon_idx1, lon_w):
    """Plain version on channels-last x (B, Hin, Win, C) -> (B, Hout, Wout, C)."""
    lo = x[:, lat_idx]
    hi = x[:, lat_idx + 1]
    y = lo + (hi - lo) * lat_w.to(x.dtype)[None, :, None, None]
    y0 = y[:, :, lon_idx0]
    y1 = y[:, :, lon_idx1]
    return y0 + (y1 - y0) * lon_w.to(x.dtype)[None, None, :, None]


@functools.cache
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def resample(x_ptr, y_ptr, lat_idx_ptr, lat_w_ptr, lon0_ptr, lon1_ptr, lon_w_ptr, Hout, Wout, C, sB, sH, sW, sC, total, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < total
        c = offs % C
        t = offs // C
        wo = t % Wout
        t = t // Wout
        ho = t % Hout
        b = t // Hout
        li = tl.load(lat_idx_ptr + ho, mask=mask, other=0).to(tl.int64)
        lw = tl.load(lat_w_ptr + ho, mask=mask, other=0.0)
        k0 = tl.load(lon0_ptr + wo, mask=mask, other=0).to(tl.int64)
        k1 = tl.load(lon1_ptr + wo, mask=mask, other=0).to(tl.int64)
        v = tl.load(lon_w_ptr + wo, mask=mask, other=0.0)
        r0 = x_ptr + b * sB + li * sH + c * sC
        r1 = r0 + sH
        lo0 = tl.load(r0 + k0 * sW, mask=mask, other=0.0).to(tl.float32)
        hi0 = tl.load(r1 + k0 * sW, mask=mask, other=0.0).to(tl.float32)
        lo1 = tl.load(r0 + k1 * sW, mask=mask, other=0.0).to(tl.float32)
        hi1 = tl.load(r1 + k1 * sW, mask=mask, other=0.0).to(tl.float32)
        y0 = lo0 + (hi0 - lo0) * lw
        y1 = lo1 + (hi1 - lo1) * lw
        out = y0 + (y1 - y0) * v
        tl.store(y_ptr + offs, out.to(y_ptr.dtype.element_ty), mask=mask)

    return triton, resample


_BLOCK = 1024


def resample_cl(x, lat_idx, lat_w, lon_idx0, lon_idx1, lon_w):
    """Bilinear resampling of channels-last x (B, Hin, Win, C), any strides,
    to (B, Hout, Wout, C) contiguous: K7 on the card, the plain version on the
    CPU. Index tables int32, weights float32, on x's device."""
    if kernels.takes_plain("resample", x, lat_idx, lat_w, lon_idx0, lon_idx1, lon_w):
        return resample_cl_plain(x, lat_idx.long(), lat_w, lon_idx0.long(), lon_idx1.long(), lon_w)
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"resample: expected float32/bfloat16 (B, H, W, C), got {x.dtype} {tuple(x.shape)}")
    B, _, _, C = x.shape
    Hout, Wout = lat_idx.shape[0], lon_idx0.shape[0]
    y = torch.empty(B, Hout, Wout, C, dtype=x.dtype, device=x.device)
    total = y.numel()
    if total == 0:
        return y
    triton, kern = _triton_kernel()
    sB, sH, sW, sC = x.stride()
    with torch.cuda.device(x.device):
        kern[(triton.cdiv(total, _BLOCK),)](x, y, lat_idx, lat_w, lon_idx0, lon_idx1, lon_w, Hout, Wout, C, sB, sH, sW, sC, total, BLOCK=_BLOCK, num_warps=8)
    kernels.count_launch("resample")
    return y


class ResampleS2:
    """Bilinear resampling (nlat_in, nlon_in) -> (nlat_out, nlon_out); the
    tables are the JAX package's, kept as device tensors per device."""

    def __init__(self, nlat_in, nlon_in, nlat_out, nlon_out, grid_in="equiangular", grid_out="equiangular", mode="bilinear", method="gather"):
        if mode != "bilinear":
            raise NotImplementedError(f"resampling mode {mode}")
        if method != "gather":
            raise NotImplementedError(f"resampling method {method!r} is not ported yet (only 'gather')")
        self.method = method
        self.in_shape = (nlat_in, nlon_in)
        self.out_shape = (nlat_out, nlon_out)

        ti, _ = precompute_latitudes(nlat_in, grid=grid_in)
        to, _ = precompute_latitudes(nlat_out, grid=grid_out)

        j = np.clip(np.searchsorted(ti, to) - 1, 0, nlat_in - 2)
        w = (to - ti[j]) / (ti[j + 1] - ti[j])
        self.lat_idx = j.astype(np.int32)
        self.lat_w = np.clip(w, 0.0, 1.0).astype(np.float32)

        phi_out = np.arange(nlon_out) * (2 * np.pi / nlon_out)
        pos = phi_out / (2 * np.pi / nlon_in)
        k = np.floor(pos).astype(np.int64)
        v = (pos - k).astype(np.float32)
        self.lon_idx0 = (k % nlon_in).astype(np.int32)
        self.lon_idx1 = ((k + 1) % nlon_in).astype(np.int32)
        self.lon_w = v.astype(np.float32)
        self._tables = {}

    def tables(self, device):
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = tuple(
                torch.from_numpy(a).to(device) for a in (self.lat_idx, self.lat_w, self.lon_idx0, self.lon_idx1, self.lon_w)
            )
        return self._tables[device]

    def resample_cl(self, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        """Channels-last (B, Hin, Win, C) -> (B, Hout, Wout, C)."""
        tabs = self.tables(x.device)
        if use_kernels:
            return resample_cl(x, *tabs)
        li, lw, k0, k1, v = tabs
        return resample_cl_plain(x, li.long(), lw, k0.long(), k1.long(), v)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The JAX package's layout: (..., Hin, Win) -> (..., Hout, Wout)."""
        lead = x.shape[:-2]
        y = self.resample_cl(x.reshape(-1, *self.in_shape, 1))
        return y.reshape(*lead, *self.out_shape)


def make_resample(nlat_in, nlon_in, nlat_out, nlon_out, grid_in="equiangular", grid_out="equiangular", mode="bilinear") -> ResampleS2:
    """The serial resampler (counterpart of the serial branch of
    ``makani_tpu/parallel/resample.py`` ``make_resample``)."""
    return ResampleS2(nlat_in, nlon_in, nlat_out, nlon_out, grid_in=grid_in, grid_out=grid_out, mode=mode)
