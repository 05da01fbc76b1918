"""makani_torch host-side tables and helpers against makani_tpu: the numpy
quadrature and Legendre tables bit-equal (including the exact zero m > l
triangle the Legendre kernels rely on), the precision policy, channel names,
zenith angle and YAML loading."""

import importlib
import os

import numpy as np
import pytest
import torch

from makani_tpu.ops import legendre as jlegendre
from makani_tpu.ops import quadrature as jquadrature
from makani_tpu.utils import features as jfeatures
from makani_tpu.utils import yparams as jyparams
from makani_tpu.utils import zenith_angle as jzenith

from makani_torch.ops import legendre, precision, quadrature
from makani_torch.ops.sht import InverseRealSHT, RealSHT
from makani_torch.utils import features, yparams, zenith_angle
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("grid", ["equiangular", "clenshaw-curtiss", "legendre-gauss", "lobatto"])
@pytest.mark.parametrize("nlat", [12, 25])
def test_latitudes_bit_equal(grid, nlat):
    theta, w = quadrature.precompute_latitudes(nlat, grid=grid)
    jtheta, jw = jquadrature.precompute_latitudes(nlat, grid=grid)
    assert np.array_equal(theta, jtheta) and np.array_equal(w, jw)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("norm", ["ortho", "schmidt"])
def test_legpoly_bit_equal(inverse, norm):
    theta, _ = quadrature.precompute_latitudes(17, grid="legendre-gauss")
    p = legendre.precompute_legpoly(9, 12, theta, norm=norm, inverse=inverse)
    jp = jlegendre.precompute_legpoly(9, 12, theta, norm=norm, inverse=inverse)
    assert np.array_equal(p, jp)
    d = legendre.precompute_dlegpoly(9, 12, theta, norm=norm, inverse=inverse)
    assert np.array_equal(d, jlegendre.precompute_dlegpoly(9, 12, theta, norm=norm, inverse=inverse))


@pytest.mark.parametrize("nlat,nlon,grid,lmax,mmax", [(25, 48, "equiangular", None, None), (12, 24, "legendre-gauss", None, None), (24, 48, "equiangular", 12, 13)])
def test_sht_tables_zero_above_diagonal(nlat, nlon, grid, lmax, mmax):
    """The K1/K2 kernels skip the m > l triangle; that is exact only because
    the tables hold exact zeros there."""
    sht = RealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
    isht = InverseRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
    for table in (sht.weights("cpu").numpy(), isht.pct("cpu").numpy()):
        m = np.arange(table.shape[0])[:, None]
        l = np.arange(table.shape[1])[None, :]
        assert np.all(table[m > l] == 0.0)
        assert np.count_nonzero(table[m <= l]) > 0


def test_precision_policy_default_and_env(monkeypatch):
    monkeypatch.delenv("MAKANI_TRANSFORM_PRECISION", raising=False)
    importlib.reload(precision)
    try:
        assert precision.transform_precision() == "highest"
        assert precision.transform_io_dtype() == torch.float32
        monkeypatch.setenv("MAKANI_TRANSFORM_PRECISION", "default")
        importlib.reload(precision)
        assert precision.transform_precision() == "default"
        assert precision.transform_io_dtype() == torch.bfloat16
        precision.set_transform_precision("high")
        assert precision.transform_io_dtype() == torch.float32
        with pytest.raises(ValueError):
            precision.set_transform_precision("tf32")
    finally:
        monkeypatch.delenv("MAKANI_TRANSFORM_PRECISION", raising=False)
        importlib.reload(precision)


def test_maybe_cast_table():
    t = torch.ones(3, 4)
    assert precision.maybe_cast_table(t, torch.zeros(2, dtype=torch.bfloat16)).dtype == torch.bfloat16
    assert precision.maybe_cast_table(t, torch.zeros(2)) is t


@pytest.mark.parametrize(
    "kw",
    [
        dict(add_zenith=True),
        dict(add_zenith=True, add_grid=True, grid_type="sinusoidal", grid_num_frequencies=2, add_orography=True, add_landmask=True),
        dict(n_noise_chan=3, add_soiltype=True, add_copernicus_emb=True, add_landmask=True, landmask_preprocessing="raw"),
    ],
)
def test_auxiliary_channels_equal(kw):
    assert features.get_auxiliary_channels(**kw) == jfeatures.get_auxiliary_channels(**kw)


def test_zenith_bit_equal():
    lat = 90.0 - 7.5 * np.arange(25)
    lon = 7.5 * np.arange(48)
    lon2d, lat2d = np.meshgrid(lon, lat)
    for t in (1.5e9, 1.6e9 + 3 * 3600.0):
        assert np.array_equal(
            zenith_angle.cos_zenith_angle_from_timestamp(t, lon2d, lat2d), jzenith.cos_zenith_angle_from_timestamp(t, lon2d, lat2d)
        )
    assert np.array_equal(zenith_angle.cos_zenith_angle(np.datetime64("2018-01-01T06:00"), lon, lat), jzenith.cos_zenith_angle(np.datetime64("2018-01-01T06:00"), lon, lat))


def test_yparams_flagship_equal():
    path = os.path.join(REPO, "config", "sfnonet.yaml")
    name = "sfno_linear_73chq_sc3_layers8_edim384"
    p = yparams.YParams(path, name)
    assert p.to_dict() == jyparams.YParams(path, name).to_dict()
    assert p.embed_dim == 384 and p.num_layers == 8 and p.scale_factor == 3 and p["compute_dtype"] == "bfloat16"
    assert len(p.channel_names) == 73 and p.lr == 1e-3
