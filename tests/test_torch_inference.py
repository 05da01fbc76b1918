"""The port's ``Inferencer`` against makani_tpu's, and the inference CLI.

A tiny fp32 SFNO (16x32, 5 channels, embed 16, 2 blocks) scored over the
9 initial conditions of an ``init_hdf5_dataset`` file in batches of 8 (the
last padded), 3 lead steps each, with the raw forecasts saved: the port's
seeded weights are carried into the JAX inferencer (``params_to_jax``).
The logs with the same keys, within 1e-5 relative to max(|ref|, 1); the
temporal means and stds of the forecast and of its bias within 1e-5 of the
largest reference value; the SH and zonal spectra within 1e-4 relative;
the raw forecasts within 1e-5; and the same datasets, shapes and dtypes in
each of the four files.

The same SFNO with two centered diffusion-noise channels scored as an
ensemble of E = 2 over 3 initial conditions in batches of 2 (the last
padded), with a mask file (6-hourly masks over a day, looked up modulo
it) and a climatology file (no timestamps: 6-hourly steps), on a
one-device JAX mesh: the packages draw their noise from different RNGs,
so the JAX inferencer's noise hands out the port's draws; the logs
(rmse, acc, l1, crps, spread, ssr) and the four files within the
tolerances above.

The CLI (``python -m makani_torch.inference ... --device cpu``) after a
training run of the CLI: the weights it scores are the ones the run saved,
and it writes the four files; with ``--mask_file`` and
``--climatology_file`` it scores too."""

import copy
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from makani_tpu.parallel import mesh as pmesh
from makani_tpu.utils.inference import inferencer as jinf
from makani_tpu.utils.parse_dataset_metadata import parse_dataset_metadata as jparse
from makani_tpu.utils.yparams import ParamsBase as JParamsBase
from tests.test_torch_ensemble_trainer import one_device_mesh
from tests.test_torch_trainer import CONFIG, seeded_get_model
from tests.testutils import init_hdf5_dataset

from makani_torch import inference, train
from makani_torch.convert_jax import params_to_jax
from makani_torch.utils.inference.inferencer import Inferencer
from makani_torch.utils.parse_dataset_metadata import parse_dataset_metadata
from makani_torch.utils.yparams import ParamsBase
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FILES = ("metrics.h5", "temporal_averages.h5", "spectra.h5", "raw_forecasts.h5")


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    root = tmp_path_factory.mktemp("inference")
    files = init_hdf5_dataset(root, years=(2017,), samples_per_year=12)
    cfg = dict(CONFIG, valid_autoreg_steps=2, save_raw_forecasts=True, checkpoint_dir=str(root / "none"), **files)
    port = ParamsBase(copy.deepcopy(cfg))
    parse_dataset_metadata(files["metadata_json_path"], port)
    inf = Inferencer(port, device="cpu")
    logs = inf.score_model(str(root / "port"))

    ref = JParamsBase(copy.deepcopy(cfg))
    jparse(files["metadata_json_path"], ref)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinf, "get_model", seeded_get_model(jinf, params_to_jax(inf.model)))
        jinfer = jinf.Inferencer(ref)
    try:
        jlogs = jinfer.score_model(str(root / "jax"))
    finally:
        pmesh.cleanup()
    return root, logs, jlogs


class _Served:
    """A stand-in for the JAX inferencer's noise that serves recorded noise
    series (draw, T, Cn, H, W), one a batch of initial conditions, to its
    draw loop (``init_state``, ``sample``, ``update``)."""

    def __init__(self, series):
        self.series = list(series)

    def init_state(self, key, draw):
        seq = self.series.pop(0)
        assert seq.shape[0] == draw
        return seq, 0

    def sample(self, state):
        seq, t = state
        return jnp.asarray(seq[:, t][:, None])

    def update(self, state, key, replace_state=False):
        return state[0], state[1] + 1


def side_files(root, n_channels, H, W):
    """A mask file of 4 six-hourly masks (with timestamps) and a
    climatology file of 8 states (without), in raw units."""
    r = np.random.default_rng(11)
    masks = (r.uniform(size=(4, n_channels, H, W)) > 0.3).astype(np.float32) * r.uniform(0.5, 1.0, size=(4, n_channels, H, W)).astype(np.float32)
    t0 = np.datetime64("2017-01-01T00:00:00").astype("datetime64[s]").astype(np.int64)
    with h5py.File(root / "mask.h5", "w") as f:
        f.create_dataset("fields", data=masks)
        f.create_dataset("timestamp", data=t0 + np.arange(4) * 6 * 3600)
    with h5py.File(root / "clim.h5", "w") as f:
        f.create_dataset("fields", data=(1.0 + r.standard_normal((8, n_channels, H, W))).astype(np.float32))
    return str(root / "mask.h5"), str(root / "clim.h5")


NOISE = dict(type="diffusion", mode="concatenate", n_channels=2, centered=True, sigma=1.0, lambd=1.0)


@pytest.fixture(scope="module")
def scored_ensemble(tmp_path_factory):
    root = tmp_path_factory.mktemp("inference_ensemble")
    files = init_hdf5_dataset(root, years=(2017,), samples_per_year=6)
    mask, clim = side_files(root, 5, 16, 32)
    cfg = dict(CONFIG, valid_autoreg_steps=2, save_raw_forecasts=True, checkpoint_dir=str(root / "none"), ensemble_size=2, input_noise=NOISE, batch_size=2,
               mask_file=mask, climatology_file=clim, metric_names=["rmse", "acc", "l1", "crps", "spread", "ssr"], **files)
    port = ParamsBase(copy.deepcopy(cfg))
    parse_dataset_metadata(files["metadata_json_path"], port)
    inf = Inferencer(port, device="cpu")
    assert inf.metrics.climatology is None and inf.noise is not None
    drawn, draw = [], inf.draw_noise
    inf.draw_noise = lambda rows, steps: drawn.append(draw(rows, steps)) or drawn[-1]
    logs = inf.score_model(str(root / "port"))
    assert len(drawn) == 2 and all(torch.equal(d[1::2], -d[0::2]) for d in drawn)

    ref = JParamsBase(copy.deepcopy(cfg))
    jparse(files["metadata_json_path"], ref)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinf, "get_model", seeded_get_model(jinf, params_to_jax(inf.model)))
        mp.setattr(pmesh, "init", one_device_mesh(pmesh.init))
        jinfer = jinf.Inferencer(ref)
    try:
        jinfer.noise = _Served([d[0::2].numpy() for d in drawn])
        jlogs = jinfer.score_model(str(root / "jax"))
    finally:
        pmesh.cleanup()
    assert not jinfer.noise.series
    return root, logs, jlogs


def _read(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][...] for k in f}


def test_logs_match_jax(scored):
    _, logs, jlogs = scored
    assert sorted(logs) == sorted(jlogs)
    bad = {k: (logs[k], jlogs[k]) for k in jlogs if abs(logs[k] - jlogs[k]) > 1e-5 * max(abs(jlogs[k]), 1.0)}
    assert not bad, bad


@pytest.mark.parametrize("name", FILES)
def test_output_files_match_jax(scored, name):
    root, _, _ = scored
    got = _check_files(root, name)
    if name == "raw_forecasts.h5":
        assert got["fields"].shape == (9, 3, 5, 16, 32)


def _check_files(root, name):
    got, ref = _read(root / "port" / name), _read(root / "jax" / name)
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape and g.dtype == r.dtype, k
        if k == "channel":
            assert list(g) == list(r)
        elif "spectrum" in k:
            assert np.max(np.abs(g - r) / np.maximum(np.abs(r), 1e-30)) <= 1e-4, k
        elif name != "metrics.h5":
            assert np.max(np.abs(g - r)) <= 1e-5 * np.max(np.abs(r)), k
    return got


def test_ensemble_logs_match_jax(scored_ensemble):
    test_logs_match_jax(scored_ensemble)
    _, logs, _ = scored_ensemble
    assert all(k in logs for k in ("crps", "spread", "ssr", "acc_rollout_last"))


@pytest.mark.parametrize("name", FILES)
def test_ensemble_output_files_match_jax(scored_ensemble, name):
    root = scored_ensemble[0]
    _check_files(root, name)
    if name == "raw_forecasts.h5":
        assert _read(root / "port" / name)["fields"].shape == (3, 3, 5, 16, 32)


def test_cli_scores_the_trained_weights(tmp_path):
    files = init_hdf5_dataset(tmp_path, years=(2017,), samples_per_year=10)
    cfg = dict(CONFIG, batch_size=4, save_checkpoint="flexible", exp_dir=str(tmp_path / "runs"), **files)
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump({"tiny": cfg}, f)
    argv = ["--yaml_config", str(tmp_path / "cfg.yaml"), "--config", "tiny", "--device", "cpu", "--run_num", "0"]
    trainer = train.main(argv)
    out = tmp_path / "scores"
    inf = inference.main(argv + ["--save_raw_forecasts", "--output_dir", str(out)])
    assert inf.restored == {"epoch": 1, "iters": 2, "best_valid_loss": trainer.best_valid_loss}
    assert all(torch.equal(p, q) for p, q in zip(trainer.model.parameters(), inf.model.parameters()))
    assert sorted(os.listdir(out)) == sorted(FILES) and np.isfinite(inf.logs["rmse"])
    with h5py.File(out / "raw_forecasts.h5", "r") as f:
        assert f["fields"].shape == (8, 2, 5, 16, 32) and np.isfinite(f["fields"][...]).all()
    mask, clim = side_files(tmp_path, 5, 16, 32)
    side = inference.main(argv + ["--mask_file", mask, "--climatology_file", clim, "--output_dir", str(tmp_path / "side")])
    assert side.mask_dataset is not None and side.climatology_dataset is not None and side.metrics.climatology is None
    assert np.isfinite(side.logs["acc"]) and side.logs["rmse"] != inf.logs["rmse"]
