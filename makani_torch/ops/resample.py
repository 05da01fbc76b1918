"""Bilinear resampling on the sphere (counterpart of ``ResampleS2`` in
``makani_tpu/ops/resample.py``, its gather method).

Separable bilinear interpolation between equiangular (or Legendre-Gauss)
lat-lon grids: a latitude lerp at precomputed (index, weight) pairs, then a
periodic longitude lerp, in the JAX package's order of operations.

Kernel K7 (CUDA, ``csrc/resample.cu``) replaces ``ResampleS2.__call__``
(:90-99), which XLA runs as index gathers and elementwise passes. It is bound
by memory bandwidth: at the FCN3 decoders (B 2, 360x720 -> 721x1440, 585
channels) it writes 4.9 GB and reads 1.2 GB. A block makes a tile of output
columns of one output row: it stages the latitude lerp of the two input rows
over the span of columns the tile needs in shared memory and writes the
tile's contiguous run of outputs 16 bytes at a time; the latitude-lerped
field never reaches device memory. The wrapper picks the tile width from the span the tables
give (``column_span``, computed once per table tensor). The matmul and
``auto`` methods serve the spatially sharded mesh and arrive with the
spatial-parallel slice.

Training: ``ResampleS2.resample_cl`` is differentiable. With the kernels it
is an autograd function whose backward is kernel K14 (CUDA,
``csrc/resample_grad.cu``), the transpose of K7 as a gather over the
inverted tables (``inverse_tables``): for each input row the output rows
that read it, for each input column the output columns, with their
weights. Its plain version ``resample_cl_grad_plain`` is the two lerps'
scatter-adds, as autograd derives them.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from makani_torch import kernels
from makani_torch.ops.quadrature import precompute_latitudes

__all__ = ["ResampleS2", "make_resample", "resample_cl", "resample_cl_plain", "resample_cl_grad", "resample_cl_grad_plain", "inverse_tables", "column_span"]


def resample_cl_plain(x, lat_idx, lat_w, lon_idx0, lon_idx1, lon_w):
    """Plain version on channels-last x (B, Hin, Win, C) -> (B, Hout, Wout, C)."""
    lo = x[:, lat_idx]
    hi = x[:, lat_idx + 1]
    y = lo + (hi - lo) * lat_w.to(x.dtype)[None, :, None, None]
    y0 = y[:, :, lon_idx0]
    y1 = y[:, :, lon_idx1]
    return y0 + (y1 - y0) * lon_w.to(x.dtype)[None, None, :, None]


def resample_cl_grad_plain(dy, in_shape, lat_idx, lat_w, lon_idx0, lon_idx1, lon_w):
    """Plain K14: the transpose of ``resample_cl_plain``, dy (B, Hout, Wout,
    C) -> dx (B, Hin, Win, C), the lerps' scatter-adds in reverse order (the
    longitude lerp, then the latitude lerp)."""
    B, Hout, Wout, C = dy.shape
    Hin, Win = in_shape
    v = lon_w.to(dy.dtype)[None, None, :, None]
    dyl = dy.new_zeros(B, Hout, Win, C)
    dyl.index_add_(2, lon_idx0, dy - dy * v)
    dyl.index_add_(2, lon_idx1, dy * v)
    u = lat_w.to(dy.dtype)[None, :, None, None]
    dx = dy.new_zeros(B, Hin, Win, C)
    dx.index_add_(1, lat_idx, dyl - dyl * u)
    dx.index_add_(1, lat_idx + 1, dyl * u)
    return dx


def inverse_tables(lat_idx, lat_w, lon_idx0, lon_idx1, lon_w, nlat_in: int, nlon_in: int):
    """K14's tables from the forward's, on the host: (row_ptr (Hin + 1,),
    row_idx, row_w, col_ptr (Win + 1,), col_idx, col_w), for each input row
    the output rows that read it with their latitude weights (1 - lat_w for
    the row below, lat_w above), for each input column the output columns
    with their longitude weights; int32 lists and float32 weights, output
    index ascending."""

    def csr(idx0, idx1, w, n):
        w = np.asarray(w, np.float32)
        dst = np.concatenate([np.asarray(idx0, np.int64), np.asarray(idx1, np.int64)])
        src = np.concatenate([np.arange(len(w)), np.arange(len(w))])
        wt = np.concatenate([np.float32(1.0) - w, w])
        order = np.lexsort((src, dst))
        ptr = np.zeros(n + 1, np.int64)
        np.add.at(ptr, dst + 1, 1)
        return np.cumsum(ptr).astype(np.int32), src[order].astype(np.int32), wt[order].astype(np.float32)

    lat_idx = np.asarray(lat_idx, np.int64)
    return (*csr(lat_idx, lat_idx + 1, lat_w, nlat_in), *csr(lon_idx0, lon_idx1, lon_w, nlon_in))


def resample_cl_grad(dy, inverse, in_shape, tables):
    """K14 on the card, the plain version on the CPU: dy (B, Hout, Wout, C)
    float32 -> dx (B, Hin, Win, C) contiguous. ``inverse``: the
    ``inverse_tables`` as tensors on dy's device; ``tables``: the forward's
    (for the plain version)."""
    if kernels.takes_plain("resample_grad", dy, *inverse):
        li, lw, k0, k1, v = tables
        return resample_cl_grad_plain(dy, in_shape, li.long(), lw, k0.long(), k1.long(), v)
    if dy.dim() != 4 or dy.dtype != torch.float32:
        raise TypeError(f"resample_grad: expected a float32 (B, H, W, C) gradient, got {dy.dtype} {tuple(dy.shape)}")
    for t, dt in zip(inverse, (torch.int32, torch.int32, torch.float32) * 2):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"resample_grad: the inverse tables must be contiguous 1-D int32 lists and float32 weights, got {t.dtype} {tuple(t.shape)}")
    Hin, Win = in_shape
    if inverse[0].numel() != Hin + 1 or inverse[3].numel() != Win + 1:
        raise ValueError(f"resample_grad: inverse tables for {(inverse[0].numel() - 1, inverse[3].numel() - 1)} input rows and columns, expected {in_shape}")
    dy = dy.contiguous()
    B, Hout, Wout, C = dy.shape
    dx = torch.empty(B, Hin, Win, C, dtype=torch.float32, device=dy.device)
    if dx.numel() == 0:
        return dx
    lib = kernels.library()
    with torch.cuda.device(dy.device):
        err = lib.mt_resample_grad(dy.data_ptr(), dx.data_ptr(), *(t.data_ptr() for t in inverse), B, Hin, Win, Hout, Wout, C, kernels.stream_ptr(dy.device))
    kernels.check_launch(err, "resample_grad")
    kernels.count_launch("resample_grad")
    return dx


class _Resample(torch.autograd.Function):
    """K7 (forward) and K14 (backward) of one ``ResampleS2``."""

    @staticmethod
    def forward(ctx, x, rs):
        ctx.rs = rs
        return resample_cl(x, *rs.tables(x.device))

    @staticmethod
    def backward(ctx, dy):
        rs = ctx.rs
        return resample_cl_grad(dy, rs.inverse_tables(dy.device), rs.in_shape, rs.tables(dy.device)), None


def column_span(lon_idx0: np.ndarray, lon_idx1: np.ndarray, nlon_in: int, tw: int) -> int:
    """The widest run of input columns that K7 stages for a tile of ``tw``
    consecutive output columns: counted from the tile's first ``lon_idx0``,
    modulo ``nlon_in`` (the wrap from the last column to column 0), up to
    the farthest ``lon_idx0`` or ``lon_idx1`` of the tile, over all tiles."""
    k0 = np.asarray(lon_idx0, np.int64)
    k1 = np.asarray(lon_idx1, np.int64)
    start = k0[np.arange(k0.size) // tw * tw]
    return int(np.maximum((k0 - start) % nlon_in, (k1 - start) % nlon_in).max()) + 1


# K7's tile widths (output columns per block): the widest whose shared
# memory fits _SMEM_BUDGET (so that several blocks share an SM), else the
# narrowest within the card's 227 KB. Measured on an H100
# (sweep_k2_k7.py): 16 columns at the atmo decoder (585 channels), 64 at
# the surface decoder (56).
_TILE_WIDTHS = (64, 32, 16, 8, 4)
_SMEM_BUDGET = 32 * 1024
_SMEM_MAX = 227 * 1024

# id(lon_idx0) -> (tag, {tw: span}); an entry leaves with its table
_SPANS: dict = {}


def _spans(lon_idx0: torch.Tensor, lon_idx1: torch.Tensor, nlon_in: int) -> dict:
    key = id(lon_idx0)
    tag = (lon_idx0._version, lon_idx1._version, id(lon_idx1), nlon_in)
    hit = _SPANS.get(key)
    if hit is None or hit[0] != tag:
        if hit is None:
            weakref.finalize(lon_idx0, _SPANS.pop, key, None)
        k0, k1 = lon_idx0.cpu().numpy(), lon_idx1.cpu().numpy()
        hit = _SPANS[key] = (tag, {tw: column_span(k0, k1, nlon_in, tw) for tw in _TILE_WIDTHS})
    return hit[1]


def resample_cl(x, lat_idx, lat_w, lon_idx0, lon_idx1, lon_w):
    """Bilinear resampling of channels-last x (B, Hin, Win, C), any strides,
    to (B, Hout, Wout, C) contiguous: K7 on the card, the plain version on the
    CPU. Index tables int32, weights float32, on x's device."""
    if kernels.takes_plain("resample", x, lat_idx, lat_w, lon_idx0, lon_idx1, lon_w):
        return resample_cl_plain(x, lat_idx.long(), lat_w, lon_idx0.long(), lon_idx1.long(), lon_w)
    return _resample_launch(x, (lat_idx, lat_w, lon_idx0, lon_idx1, lon_w))


def _resample_launch(x, tables):
    """K7 on the card, at the widest tile (output columns per block) whose
    shared memory fits _SMEM_BUDGET."""
    lat_idx, lat_w, lon_idx0, lon_idx1, lon_w = tables
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"resample: expected float32/bfloat16 (B, H, W, C), got {x.dtype} {tuple(x.shape)}")
    for t, dt in zip(tables, (torch.int32, torch.float32, torch.int32, torch.int32, torch.float32)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"resample: tables must be contiguous 1-D int32 indices and float32 weights, got {t.dtype} {tuple(t.shape)}")
    B, _, Win, C = x.shape
    Hout, Wout = lat_idx.shape[0], lon_idx0.shape[0]
    y = torch.empty(B, Hout, Wout, C, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = kernels.library()
    spans = _spans(lon_idx0, lon_idx1, Win)
    fits = [tw for tw in _TILE_WIDTHS if lib.mt_resample_smem_bytes(C, tw, spans[tw]) <= _SMEM_BUDGET]
    tile_width = fits[0] if fits else _TILE_WIDTHS[-1]
    if lib.mt_resample_smem_bytes(C, tile_width, spans[tile_width]) > _SMEM_MAX:
        raise ValueError(f"resample: {C} channels over a span of {spans[tile_width]} input columns do not fit in shared memory")
    sB, sH, sW, sC = x.stride()
    with torch.cuda.device(x.device):
        err = lib.mt_resample(
            kernels.dtype_code(x.dtype), x.data_ptr(), y.data_ptr(), lat_idx.data_ptr(), lat_w.data_ptr(), lon_idx0.data_ptr(), lon_idx1.data_ptr(),
            lon_w.data_ptr(), B, Hout, Wout, Win, C, sB, sH, sW, sC, tile_width, spans[tile_width], kernels.stream_ptr(x.device),
        )
    kernels.check_launch(err, "resample")
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

    def inverse_tables(self, device):
        """K14's ``inverse_tables`` as tensors on ``device``."""
        device = torch.device(device)
        key = ("inverse", device)
        if key not in self._tables:
            inv = inverse_tables(self.lat_idx, self.lat_w, self.lon_idx0, self.lon_idx1, self.lon_w, *self.in_shape)
            self._tables[key] = tuple(torch.from_numpy(a).to(device) for a in inv)
        return self._tables[key]

    def resample_cl(self, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        """Channels-last (B, Hin, Win, C) -> (B, Hout, Wout, C); with the
        kernels an autograd function (K7, K14), else plain PyTorch ops that
        autograd differentiates."""
        if use_kernels:
            return _Resample.apply(x, self)
        li, lw, k0, k1, v = self.tables(x.device)
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
