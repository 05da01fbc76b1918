"""makani_torch spherical harmonic transforms against makani_tpu.

The same seeded numpy inputs go through the JAX transforms (on the CPU, where
the JAX package takes its matmul DFT) and the port's plain versions
(``torch.fft`` + the Legendre einsum). Tolerances: fp32 max|diff| <=
1e-5 * max|ref| (summation order over <= 48 longitudes and <= 25 latitudes);
bf16 relative L2 <= 2e-2 (operand rounding of both packages).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from makani_tpu.ops.sht import InverseRealSHT as JInverseRealSHT
from makani_tpu.ops.sht import RealSHT as JRealSHT

from makani_torch import kernels
from makani_torch.ops import fft_compat
from makani_torch.ops import sht as sht_mod
from makani_torch.ops.sht import (
    InverseRealSHT,
    RealSHT,
    analysis_contract_cl_s,
    analysis_contract_cl_s_plain,
    analysis_planes,
    synthesis_contract_cl_s,
    synthesis_contract_cl_s_plain,
    synthesis_planes,
    synthesis_route,
    tf32_split,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRIDS = [(25, 48, "equiangular", None, None), (12, 24, "legendre-gauss", None, None), (25, 48, "equiangular", 10, 8)]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _check(out, ref, dtype):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    if dtype == "float32":
        assert np.max(np.abs(out - ref)) <= 1e-5 * np.max(np.abs(ref))
    else:
        assert np.linalg.norm(out - ref) <= 2e-2 * np.linalg.norm(ref)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("nlat,nlon,grid,lmax,mmax", GRIDS)
def test_analysis_matches_jax(nlat, nlon, grid, lmax, mmax, dtype):
    tdt, jdt = DTYPES[dtype]
    x = np.random.default_rng(0).standard_normal((2, nlat, nlon, 3)).astype(np.float32)
    ref = JRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid).analysis_cl(jnp.asarray(x, jdt))
    out = RealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid).analysis_cl(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    _check(out, ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("nlat,nlon,grid,lmax,mmax", GRIDS)
def test_synthesis_matches_jax(nlat, nlon, grid, lmax, mmax, dtype):
    tdt, jdt = DTYPES[dtype]
    isht = InverseRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
    c = np.random.default_rng(1).standard_normal((2, isht.lmax, isht.mmax, 3, 2)).astype(np.float32)
    ref = JInverseRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid).synthesis_cl(jnp.asarray(c, jdt))
    out = isht.synthesis_cl(torch.from_numpy(c).to(tdt))
    assert out.dtype == tdt and out.shape == (2, nlat, nlon, 3)
    _check(out, ref, dtype)


def test_sht_round_trip_band_limited():
    """analysis(synthesis(c)) == c for a band-limited field on the LG grid."""
    sht, isht = RealSHT(12, 24, grid="legendre-gauss"), InverseRealSHT(12, 24, grid="legendre-gauss")
    c = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 12, 13, 2, 2)).astype(np.float32))
    l, m = torch.arange(12)[:, None], torch.arange(13)[None, :]
    c = c * (m <= l)[None, :, :, None, None]
    c[:, :, 0, :, 1] = 0.0  # m = 0 coefficients of a real field are real
    out = sht.analysis_cl(isht.synthesis_cl(c))
    assert torch.max(torch.abs(out - c)) <= 1e-5 * torch.max(torch.abs(c))


@pytest.mark.parametrize("norm", ["forward", "backward", "ortho"])
def test_rfft_pair_numpy_conventions(norm):
    x = np.random.default_rng(3).standard_normal((2, 5, 16, 3))
    out = fft_compat.rfft_cl_s(torch.from_numpy(x), norm=norm, mout=6)
    ref = np.fft.rfft(x, axis=-2, norm=norm)[..., :6, :]
    assert out.is_contiguous() and np.allclose(out.numpy(), np.stack([ref.real, ref.imag], -1))
    back = fft_compat.irfft_cl_s(out, n=16, norm=norm)
    assert np.allclose(back.numpy(), np.fft.irfft(ref, n=16, axis=-2, norm=norm))
    bf = fft_compat.rfft_cl_s(torch.from_numpy(x).to(torch.bfloat16), norm=norm)
    assert bf.dtype == torch.bfloat16


def test_kernel_wrappers_take_plain_on_cpu_without_counting():
    sht = RealSHT(12, 24, grid="legendre-gauss")
    isht = InverseRealSHT(12, 24, grid="legendre-gauss")
    rng = np.random.default_rng(4)
    xf2 = torch.from_numpy(rng.standard_normal((1, 12, 13, 4, 2)).astype(np.float32))
    kernels.reset_launch_counts()
    w, p = sht.weights("cpu"), isht.pct("cpu")
    assert torch.equal(analysis_contract_cl_s(xf2, w), analysis_contract_cl_s_plain(xf2, w))
    assert torch.equal(synthesis_contract_cl_s(xf2, p), synthesis_contract_cl_s_plain(xf2, p))
    assert kernels.LAUNCHES["sht_analysis"] == 0 and kernels.LAUNCHES["sht_synthesis"] == 0
    with pytest.raises(ValueError):
        analysis_contract_cl_s(xf2, w.to("meta"))


@pytest.mark.parametrize("nlat,nlon,grid,lmax,mmax", [GRIDS[0], GRIDS[2]])
def test_k1_table_planes_leave_the_plain_path_and_hold_the_table(nlat, nlon, grid, lmax, mmax):
    """K1's padded TF32 planes of the analysis table: building them leaves the
    table, the plain contraction and the JAX parity unchanged; they are
    zero-padded to K1's tiles, carry TF32's 10 mantissa bits, and the three
    products the kernel sums (hi.hi + hi.lo + lo.hi) give the plain result
    to 1e-6 of max|ref|."""
    sht = RealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
    w = sht.weights("cpu")
    x = np.random.default_rng(5).standard_normal((2, nlat, nlon, 3)).astype(np.float32)
    xf2 = fft_compat.rfft_cl_s(torch.from_numpy(x), n=nlon, norm="forward", mout=sht.mmax)
    before, table = analysis_contract_cl_s_plain(xf2, w), w.clone()
    planes = analysis_planes(w)
    assert analysis_planes(w) is planes
    M, L, K = w.shape
    assert planes.shape == (2, M, -(-L // 64) * 64, -(-K // 32) * 32) and planes.dtype == torch.float32
    assert not planes[:, :, L:].any() and not planes[:, :, :, K:].any()
    assert not (planes.view(torch.int32) & 0x1FFF).any()
    hi, lo = planes[0, :, :L, :K].double(), planes[1, :, :L, :K].double()
    assert torch.max(torch.abs(hi + lo - w.double())) <= 2.0**-21 * torch.max(torch.abs(w.double()))
    assert torch.equal(w, table) and torch.equal(analysis_contract_cl_s_plain(xf2, w), before)
    xh, xl = (t.double() for t in tf32_split(xf2))
    three = sum(torch.einsum("...kmcr,mlk->...lmcr", a, b) for a, b in ((xh, hi), (xh, lo), (xl, hi)))
    assert torch.max(torch.abs(three - before.double())) <= 1e-6 * torch.max(torch.abs(before.double()))
    ref = JRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid).analysis_cl(jnp.asarray(x))
    _check(sht.analysis_cl(torch.from_numpy(x)), ref, "float32")


@pytest.mark.parametrize("nlat,nlon,grid,lmax,mmax", [GRIDS[0], GRIDS[2]])
def test_k2_table_planes_leave_the_plain_path_and_hold_the_table(nlat, nlon, grid, lmax, mmax):
    """The tensor-core K2's planes of the synthesis table: transposed to
    [m][k][l], hi + lo within 2**-22 of each entry, TF32's 10 mantissa bits,
    exact zeros in the padding to K2's tiles; made once per table, leaving
    the table, the plain contraction and the JAX parity unchanged; the three
    products the kernel sums (hi.hi + hi.lo + lo.hi) give the plain result
    to 1e-6 of max|ref|."""
    isht = InverseRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
    p = isht.pct("cpu")
    c = torch.from_numpy(np.random.default_rng(6).standard_normal((2, isht.lmax, isht.mmax, 3, 2)).astype(np.float32))
    before, table = synthesis_contract_cl_s_plain(c, p), p.clone()
    planes = synthesis_planes(p)
    assert synthesis_planes(p) is planes
    M, L, K = p.shape
    assert planes.shape == (2, M, -(-K // 64) * 64, -(-L // 32) * 32) and planes.dtype == torch.float32
    assert not planes[:, :, K:].any() and not planes[:, :, :, L:].any()
    assert not (planes.view(torch.int32) & 0x1FFF).any()
    pt = p.transpose(1, 2).double()
    hi, lo = planes[0, :, :K, :L].double(), planes[1, :, :K, :L].double()
    assert bool((torch.abs(hi + lo - pt) <= 2.0**-22 * torch.abs(pt)).all())
    assert torch.equal(p, table) and torch.equal(synthesis_contract_cl_s_plain(c, p), before)
    ch, cl = (t.double() for t in tf32_split(c))
    three = sum(torch.einsum("...lmcr,mkl->...kmcr", a, b) for a, b in ((ch, hi), (ch, lo), (cl, hi)))
    assert torch.max(torch.abs(three - before.double())) <= 1e-6 * torch.max(torch.abs(before.double()))
    ref = JInverseRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid).synthesis_cl(jnp.asarray(c.numpy()))
    _check(isht.synthesis_cl(c), ref, "float32")


def test_k2_route_is_picked_from_n_before_any_planes(monkeypatch):
    """The fp32 K2 wrapper picks its route from N = 2C alone: up to N = 32
    it launches the narrow kernel on the table itself and never asks for
    planes; above, the tensor-core kernel on the planes, made once per table.
    A recording library stands in for the card."""
    calls, asked = [], []

    class Lib:
        def mt_legendre_synthesis_narrow(self, table, c, out, *args):
            calls.append(("narrow", table, args[:-1]))
            return 0

        def mt_legendre_synthesis_tc(self, planes, c, out, *args):
            calls.append(("tc", planes, args[:-1]))
            return 0

    real = sht_mod.synthesis_planes
    monkeypatch.setattr(sht_mod, "synthesis_planes", lambda t: asked.append(t) or real(t))
    monkeypatch.setattr(kernels, "takes_plain", lambda name, *tensors: False)
    monkeypatch.setattr(kernels, "library", Lib)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    isht = InverseRealSHT(25, 48, grid="equiangular")
    p = isht.pct("cpu")
    M, L, K = p.shape
    for C, route in ((1, "narrow"), (8, "narrow"), (16, "narrow"), (17, "tc"), (40, "tc")):
        assert synthesis_route(2 * C) == route
        kernels.reset_launch_counts()
        out = synthesis_contract_cl_s(torch.zeros(2, L, M, C, 2), p)
        assert out.shape == (2, K, M, C, 2) and kernels.LAUNCHES["sht_synthesis"] == 1
        name, operand, args = calls[-1]
        assert name == route
        if route == "narrow":
            assert operand == p.data_ptr() and args == (2, M, L, K, 2 * C) and not asked
        else:
            planes = real(p)
            assert operand == planes.data_ptr() and args == (2, M, L, K, *planes.shape[2:], 2 * C)
    assert len(asked) == 2 and all(t is p for t in asked)
