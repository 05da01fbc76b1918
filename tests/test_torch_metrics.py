"""The port's metrics against makani_tpu's: every function of
``utils/metrics/functions.py`` on the same seeded fields (within 1e-6 of
the largest reference value), and ``MetricsHandler`` over several batches
and rollout steps, with a climatology and with padded rows weighted out:
``finalize``'s logs with the same keys, values within 1e-6 relative to
max(|ref|, 1) (the fields are of unit scale; the correlations, bounded by 1,
cancel to near 0 on random fields), and ``save`` with the same datasets and
shapes."""

import copy

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from makani_tpu.utils.grids import GridQuadrature as JGridQuadrature
from makani_tpu.utils.metric import MetricsHandler as JMetricsHandler
from makani_tpu.utils.metrics import functions as jfn
from makani_tpu.utils.yparams import ParamsBase as JParamsBase

from makani_torch.utils.grids import GridQuadrature
from makani_torch.utils.metric import MetricsHandler
from makani_torch.utils.metrics import functions as fn
from makani_torch.utils.yparams import ParamsBase
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W, B, E, C = 12, 24, 3, 4, 5
NAMES = ["u10m", "v10m", "t2m", "z500", "q700"]


def _fields(seed=0):
    r = np.random.default_rng(seed)
    ens = r.standard_normal((B, E, C, H, W)).astype(np.float32)
    ens[:, 1] = ens[:, 0]  # tied members
    obs = r.standard_normal((B, C, H, W)).astype(np.float32)
    clim = 0.3 * r.standard_normal((C, H, W)).astype(np.float32)
    mask = r.uniform(0.0, 2.0, (B, C, H, W)).astype(np.float32)
    return ens, obs, clim, mask


def _close(out, ref, tol=1e-6):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= tol * max(1.0, np.max(np.abs(ref))), np.max(np.abs(out - ref))


@pytest.mark.parametrize("grid", ["equiangular", "legendre-gauss"])
def test_functions_match_jax(grid):
    from makani_tpu.utils.grids import grid_to_quadrature_rule

    rule = grid_to_quadrature_rule(grid)
    quad, jquad = GridQuadrature(rule, (H, W), normalize=True), JGridQuadrature(rule, img_shape=(H, W), normalize=True)
    ens, obs, clim, mask = _fields()
    prd = ens[:, 2]
    t = lambda a: torch.from_numpy(a)
    j = jnp.asarray
    for m in (None, mask):
        tm, jm = (None, None) if m is None else (t(m), j(m))
        _close(fn.weighted_rmse(t(prd), t(obs), quad, mask=tm), jfn.weighted_rmse(j(prd), j(obs), jquad, mask=jm))
        _close(fn.weighted_l1(t(prd), t(obs), quad, mask=tm), jfn.weighted_l1(j(prd), j(obs), jquad, mask=jm))
        for cl in (None, clim):
            _close(fn.weighted_acc(t(prd), t(obs), quad, clim=None if cl is None else t(cl), mask=tm),
                   jfn.weighted_acc(j(prd), j(obs), jquad, clim=None if cl is None else j(cl), mask=jm))
        for fair in (True, False):
            _close(fn.ensemble_crps(t(ens), t(obs), quad, fair=fair, mask=tm), jfn.ensemble_crps(j(ens), j(obs), jquad, fair=fair, mask=jm))
        _close(fn.ensemble_spread(t(ens), quad, mask=tm), jfn.ensemble_spread(j(ens), jquad, mask=jm))
    _close(fn.weighted_mean(t(prd), quad), jfn.weighted_mean(j(prd), jquad))
    _close(fn.ensemble_rank_histogram(t(ens), t(obs), quad), jfn.ensemble_rank_histogram(j(ens), j(obs), jquad))
    _close(fn.ensemble_crps(t(ens[:, :1]), t(obs), quad), jfn.ensemble_crps(j(ens[:, :1]), j(obs), jquad))


@pytest.mark.parametrize("ensemble", [False, True], ids=["deterministic", "ensemble"])
def test_metrics_handler_matches_jax(tmp_path, ensemble):
    names = ["rmse", "acc", "l1"] + (["crps", "spread", "ssr", "rankhist"] if ensemble else [])
    cfg = dict(img_shape_x=H, img_shape_y=W, channel_names=NAMES, valid_autoreg_steps=2, metric_names=names)
    ens, obs, clim, _ = _fields(1)
    mh, jmh = MetricsHandler(ParamsBase(copy.deepcopy(cfg)), climatology=clim), JMetricsHandler(JParamsBase(copy.deepcopy(cfg)), climatology=clim)
    r = np.random.default_rng(2)
    rows = np.asarray([1.0, 1.0, 0.0], np.float32)
    for step in range(3):
        for batch in range(2):
            prd = (ens if ensemble else ens[:, 0]) + 0.1 * step + r.standard_normal(1).astype(np.float32)
            w = rows if batch == 1 else None
            mh.update(torch.from_numpy(prd), torch.from_numpy(obs), step, row_weights=None if w is None else torch.from_numpy(w))
            jmh.update(jnp.asarray(prd), jnp.asarray(obs), step, row_weights=None if w is None else jnp.asarray(w))
    logs, jlogs = mh.finalize(), jmh.finalize()
    assert sorted(logs) == sorted(jlogs)
    for k in jlogs:
        assert abs(logs[k] - jlogs[k]) <= 1e-6 * max(abs(jlogs[k]), 1.0), (k, logs[k], jlogs[k])
    mh.save(str(tmp_path / "m.h5"))
    jmh.save(str(tmp_path / "j.h5"))
    with h5py.File(tmp_path / "m.h5", "r") as f, h5py.File(tmp_path / "j.h5", "r") as g:
        assert sorted(f) == sorted(g)
        for k in g:
            assert f[k].shape == g[k].shape and f[k].dtype == g[k].dtype, k
        assert list(f["channel"][...]) == list(g["channel"][...])
