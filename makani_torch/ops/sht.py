"""Spherical harmonic transforms (counterpart of ``makani_tpu/ops/sht.py``).

The real SHT pair factors into a real DFT in longitude (``fft_compat``,
cuFFT) and a per-order Legendre contraction in latitude,

    coeff[l, m] = 2 pi * sum_k w_k * Pbar_l^m(cos theta_k) * rfft(x)[theta_k, m]

with the quadrature weights and 2 pi folded into the analysis table. The two
Legendre contractions are the hand-written kernels K1 (analysis) and K2
(synthesis) in ``csrc/sht_legendre.cu``; each has its plain PyTorch version
here. Tables are float64 numpy computations stored as fp32 (and cast to bf16
for bf16 input), cached per device and dtype on the transform object. The
two contractions are each other's transpose on one table, so each one's
input gradient is the other's kernel on the same table
(``torch.autograd.Function``s, counted as ``sht_analysis_grad`` and
``sht_synthesis_grad``). The
fp32 K1 runs on the tensor cores in 3xTF32 and reads the table's TF32 high
and low planes, zero-padded to its tiles (``analysis_planes``), made once
per table tensor; the plain version reads the table itself. The fp32 K2
takes one of two routes by N = 2C (``synthesis_route``): wide N the tensor
cores, on the transposed planes of the synthesis table
(``synthesis_planes``); narrow N one pass over the table itself, with no
planes made.
"""

from __future__ import annotations

import math
import weakref

import numpy as np
import torch

from makani_torch import kernels
from makani_torch.ops import fft_compat
from makani_torch.ops.legendre import precompute_legpoly
from makani_torch.ops.precision import fp32_exact, maybe_cast_table
from makani_torch.ops.quadrature import precompute_latitudes

__all__ = [
    "RealSHT",
    "InverseRealSHT",
    "analysis_contract_cl_s",
    "synthesis_contract_cl_s",
    "analysis_contract_cl_s_plain",
    "synthesis_contract_cl_s_plain",
    "analysis_planes",
    "synthesis_planes",
    "synthesis_route",
    "tf32_split",
]


def analysis_contract_cl_s_plain(xf2: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """split (..., nlat, mmax, C, 2) x (mmax, lmax, nlat) -> (..., lmax, mmax, C, 2)."""
    with fp32_exact():
        return torch.einsum("...kmcr,mlk->...lmcr", xf2, maybe_cast_table(weights, xf2))


def synthesis_contract_cl_s_plain(c2: torch.Tensor, pct: torch.Tensor) -> torch.Tensor:
    """split (..., lmax, mmax, C, 2) x (mmax, lmax, nlat) -> (..., nlat, mmax, C, 2)."""
    with fp32_exact():
        return torch.einsum("...lmcr,mlk->...kmcr", c2, maybe_cast_table(pct, c2))


# Kernel K1/K2 modes of mt_legendre_contract (csrc/sht_legendre.cu)
_ANALYSIS, _SYNTHESIS = 0, 1
# K1's and K2's tensor-core tile: rows per block (K1 l, K2 k) and depth per
# stage (K1 k, K2 l); their table planes are zero-padded to multiples of these
_TC_ROWS, _TC_DEPTH = 64, 32


def tf32_split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 t -> (hi, lo), both fp32 values with TF32's 10 mantissa bits:
    hi is t rounded to nearest with ties away from zero (``cvt.rna``), lo is
    the residual t - hi rounded the same way. hi + lo holds t to ~2**-22."""

    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(t)
    return hi, rna(t - hi)


# (id(table), kind) -> (table._version, planes); an entry leaves with its table
_PLANES: dict = {}


def _planes(table: torch.Tensor, kind: str, make) -> torch.Tensor:
    key = (id(table), kind)
    hit = _PLANES.get(key)
    if hit is None or hit[0] != table._version:
        if hit is None:
            weakref.finalize(table, _PLANES.pop, key, None)
        hit = _PLANES[key] = (table._version, make(table))
    return hit[1]


def _split_padded(t: torch.Tensor, rows: int, depth: int) -> torch.Tensor:
    """(M, R, D) -> its TF32 (hi, lo) planes zero-padded to multiples of
    rows along R and depth along D: (2, M, Rp, Dp)."""
    pad = (0, -t.shape[2] % depth, 0, -t.shape[1] % rows)
    return torch.stack([torch.nn.functional.pad(p, pad) for p in tf32_split(t)]).contiguous()


def analysis_planes(weights: torch.Tensor) -> torch.Tensor:
    """The fp32 K1's copy of an analysis table (M, L, K): its TF32 high and
    low planes, zero-padded along l and k to K1's tiles, (2, M, Lp, Kp)
    fp32. Made once per table tensor (and again if it is written to)."""
    return _planes(weights, "analysis", lambda w: _split_padded(w, _TC_ROWS, _TC_DEPTH))


def synthesis_planes(pct: torch.Tensor) -> torch.Tensor:
    """The tensor-core K2's copy of a synthesis table (M, L, K): its TF32
    high and low planes transposed to [m][k][l] (l-contiguous, the K-major
    B operand of wgmma) and zero-padded to K2's tiles, (2, M, Kp, Lp) fp32.
    Made once per table tensor (and again if it is written to)."""
    return _planes(pct, "synthesis", lambda p: _split_padded(p.transpose(1, 2), _TC_ROWS, _TC_DEPTH))


# The fp32 K2's routes, by N = 2C alone: up to _NARROW_MAX_N columns the
# kernel that streams the table once (no planes), above it the tensor cores.
# The crossover was measured on an H100 (sweep_k2_k7.py times both routes at
# N 16 and 32; PERF.md); the narrow kernel holds at most 32 columns.
_NARROW_MAX_N = 32


def synthesis_route(N: int) -> str:
    """The fp32 K2's route for N = 2C columns: "narrow" or "tc"."""
    return "narrow" if N <= _NARROW_MAX_N else "tc"


def _legendre_launch(name: str, mode: int, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    if x.dtype != table.dtype:
        raise TypeError(f"{name}: input {x.dtype} and table {table.dtype} differ; cast the table first")
    if table.dim() != 3 or x.dim() < 5 or x.shape[-1] != 2:
        raise ValueError(f"{name}: expected x (..., D, M, C, 2) and table (M, L, K), got {tuple(x.shape)} and {tuple(table.shape)}")
    M, L, K = table.shape
    rows, depth = (L, K) if mode == _ANALYSIS else (K, L)
    if x.shape[-4] != depth or x.shape[-3] != M:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match table {tuple(table.shape)}")
    if not (x.is_contiguous() and table.is_contiguous()):
        raise ValueError(f"{name}: x and table must be contiguous")
    lead = x.shape[:-4]
    B = math.prod(lead)
    N = 2 * x.shape[-2]
    out = torch.empty(*lead, rows, M, N // 2, 2, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = kernels.library()
    with torch.cuda.device(x.device):
        stream = kernels.stream_ptr(x.device)
        if mode == _ANALYSIS and x.dtype == torch.float32:
            planes = analysis_planes(table)
            Lp, Kp = planes.shape[2:]
            err = lib.mt_legendre_analysis_tc(planes.data_ptr(), x.data_ptr(), out.data_ptr(), B, M, L, K, Lp, Kp, N, stream)
        elif mode == _SYNTHESIS and x.dtype == torch.float32:
            if synthesis_route(N) == "narrow":
                err = lib.mt_legendre_synthesis_narrow(table.data_ptr(), x.data_ptr(), out.data_ptr(), B, M, L, K, N, stream)
            else:
                planes = synthesis_planes(table)
                Kp, Lp = planes.shape[2:]
                err = lib.mt_legendre_synthesis_tc(planes.data_ptr(), x.data_ptr(), out.data_ptr(), B, M, L, K, Kp, Lp, N, stream)
        else:
            err = lib.mt_legendre_contract(kernels.dtype_code(x.dtype), table.data_ptr(), x.data_ptr(), out.data_ptr(), B, M, rows, depth, N, mode, stream)
    kernels.check_launch(err, name)
    kernels.count_launch(name)
    return out


class _AnalysisContract(torch.autograd.Function):
    """K1 forward; its input gradient is the synthesis contraction on the
    same table (K2's kernels on the analysis table), counted as
    ``sht_analysis_grad``. No gradient for the table."""

    @staticmethod
    def forward(ctx, xf2, weights):
        ctx.save_for_backward(weights)
        if kernels.takes_plain("sht_analysis", xf2, weights):
            return analysis_contract_cl_s_plain(xf2, weights)
        return _legendre_launch("sht_analysis", _ANALYSIS, xf2, weights)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (weights,) = ctx.saved_tensors
        if kernels.takes_plain("sht_analysis_grad", g, weights):
            return synthesis_contract_cl_s_plain(g, weights), None
        return _legendre_launch("sht_analysis_grad", _SYNTHESIS, g.contiguous(), weights), None


class _SynthesisContract(torch.autograd.Function):
    """K2 forward; its input gradient is the analysis contraction on the
    same table (K1's kernel on the synthesis table), counted as
    ``sht_synthesis_grad``. No gradient for the table."""

    @staticmethod
    def forward(ctx, c2, pct):
        ctx.save_for_backward(pct)
        if kernels.takes_plain("sht_synthesis", c2, pct):
            return synthesis_contract_cl_s_plain(c2, pct)
        return _legendre_launch("sht_synthesis", _SYNTHESIS, c2, pct)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (pct,) = ctx.saved_tensors
        if kernels.takes_plain("sht_synthesis_grad", g, pct):
            return analysis_contract_cl_s_plain(g, pct), None
        return _legendre_launch("sht_synthesis_grad", _ANALYSIS, g.contiguous(), pct), None


def analysis_contract_cl_s(xf2: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Legendre analysis (kernel K1 on the card, the plain einsum on the CPU),
    differentiable in ``xf2``.

    Replaces ``makani_tpu/ops/sht.py`` ``_analysis_contract_cl_s``. ``weights``
    must already be in ``xf2``'s dtype on the card (``RealSHT`` caches it so).
    fp32 runs on the tensor cores (3xTF32), bf16 on the fp32 FMA kernel. The
    backward is the synthesis contraction on this table: on the card K2's
    kernel (fp32 wide N on the tensor cores, on this table's transposed
    planes ``synthesis_planes``), on the CPU the plain synthesis einsum.
    """
    return _AnalysisContract.apply(xf2, weights)


def synthesis_contract_cl_s(c2: torch.Tensor, pct: torch.Tensor) -> torch.Tensor:
    """Legendre synthesis (kernel K2 on the card, the plain einsum on the
    CPU), differentiable in ``c2``.

    Replaces ``makani_tpu/ops/sht.py`` ``_synthesis_contract_cl_s``. fp32
    takes the route ``synthesis_route(2 C)`` picks (the tensor cores, or one
    pass over the table at narrow N), bf16 the fp32 FMA kernel. The backward
    is the analysis contraction on this table: on the card K1's kernel (fp32
    on this table's TF32 planes ``analysis_planes``; K1 skips the tiles above
    the diagonal, l < m, which this table leaves zero too), on the CPU the
    plain analysis einsum.
    """
    return _SynthesisContract.apply(c2, pct)


class _TableCache:
    """fp32 numpy table -> torch tensor per (device, dtype), made once."""

    def __init__(self, table: np.ndarray):
        self.table = table
        self._tensors = {}

    def get(self, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        key = (torch.device(device), dtype)
        if key not in self._tensors:
            self._tensors[key] = torch.from_numpy(self.table).to(device=device, dtype=dtype).contiguous()
        return self._tensors[key]


class RealSHT:
    """Forward (analysis) real spherical harmonic transform.

    Maps a real field ``(..., nlat, nlon, C)`` to split-complex coefficients
    ``(..., lmax, mmax, C, 2)``; entries with ``m > l`` are zero.
    """

    def __init__(self, nlat: int, nlon: int, lmax: int | None = None, mmax: int | None = None, grid: str = "equiangular", norm: str = "ortho", csphase: bool = True):
        self.nlat = nlat
        self.nlon = nlon
        self.grid = grid
        self.norm = norm
        self.lmax = min(lmax or nlat, nlat)
        self.mmax = min(mmax or nlon // 2 + 1, nlon // 2 + 1)

        theta, w = precompute_latitudes(nlat, grid=grid)
        pct = precompute_legpoly(self.mmax, self.lmax, theta, norm=norm, csphase=csphase)
        # fold quadrature weights and the 2*pi longitude measure into the table
        self._weights = _TableCache((2.0 * np.pi * pct * w[None, None, :]).astype(np.float32))

    def weights(self, device, dtype=torch.float32) -> torch.Tensor:
        return self._weights.get(device, dtype)

    def analysis_cl(self, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        """Channels-last analysis: real (..., nlat, nlon, C) -> (..., lmax, mmax, C, 2)."""
        xf2 = fft_compat.rfft_cl_s(x, n=self.nlon, norm="forward", mout=self.mmax)
        w = self.weights(xf2.device, xf2.dtype)
        if use_kernels:
            return analysis_contract_cl_s(xf2, w)
        return analysis_contract_cl_s_plain(xf2, w)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """The JAX package's layout: real (..., nlat, nlon) -> (..., lmax,
        mmax, 2). The leading axes become the channels of one channels-last
        transform (K1 with C = their product)."""
        lead = x.shape[:-2]
        xcl = x.reshape(-1, self.nlat, self.nlon).permute(1, 2, 0)[None]
        c2 = self.analysis_cl(xcl)[0]  # (lmax, mmax, N, 2)
        return c2.permute(2, 0, 1, 3).reshape(*lead, self.lmax, self.mmax, 2)


class InverseRealSHT:
    """Inverse (synthesis) real spherical harmonic transform.

    Maps split-complex coefficients ``(..., lmax, mmax, C, 2)`` to a real field
    ``(..., nlat, nlon, C)``.
    """

    def __init__(self, nlat: int, nlon: int, lmax: int | None = None, mmax: int | None = None, grid: str = "equiangular", norm: str = "ortho", csphase: bool = True):
        self.nlat = nlat
        self.nlon = nlon
        self.grid = grid
        self.norm = norm
        self.lmax = min(lmax or nlat, nlat)
        self.mmax = min(mmax or nlon // 2 + 1, nlon // 2 + 1)

        theta, _ = precompute_latitudes(nlat, grid=grid)
        pct = precompute_legpoly(self.mmax, self.lmax, theta, norm=norm, inverse=True, csphase=csphase)
        self._pct = _TableCache(pct.astype(np.float32))

    def pct(self, device, dtype=torch.float32) -> torch.Tensor:
        return self._pct.get(device, dtype)

    def synthesis_cl(self, c2: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        """Channels-last synthesis: (..., lmax, mmax, C, 2) -> real (..., nlat, nlon, C)."""
        c2 = c2.contiguous()
        p = self.pct(c2.device, c2.dtype)
        xf2 = synthesis_contract_cl_s(c2, p) if use_kernels else synthesis_contract_cl_s_plain(c2, p)
        return fft_compat.irfft_cl_s(xf2, n=self.nlon, norm="forward")

    def synthesis(self, c2: torch.Tensor) -> torch.Tensor:
        """The JAX package's layout: (..., lmax, mmax, 2) -> real (..., nlat,
        nlon). The leading axes become the channels of one channels-last
        transform (K2 with C = their product)."""
        lead = c2.shape[:-3]
        ccl = c2.reshape(-1, self.lmax, self.mmax, 2).permute(1, 2, 0, 3)[None]
        x = self.synthesis_cl(ccl)[0]  # (nlat, nlon, N)
        return x.permute(2, 0, 1).reshape(*lead, self.nlat, self.nlon)
