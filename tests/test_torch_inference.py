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

The CLI (``python -m makani_torch.inference ... --device cpu``) after a
training run of the CLI: the weights it scores are the ones the run saved,
and it writes the four files; ensembles and the side datasets raise."""

import copy
import os

import h5py
import numpy as np
import pytest
import torch
import yaml

from makani_tpu.parallel import mesh as pmesh
from makani_tpu.utils.inference import inferencer as jinf
from makani_tpu.utils.parse_dataset_metadata import parse_dataset_metadata as jparse
from makani_tpu.utils.yparams import ParamsBase as JParamsBase
from tests.test_torch_trainer import CONFIG, seeded_get_model
from tests.testutils import init_hdf5_dataset

from makani_torch import inference, train
from makani_torch.convert_jax import params_to_jax
from makani_torch.utils.inference.inferencer import Inferencer
from makani_torch.utils.parse_dataset_metadata import parse_dataset_metadata
from makani_torch.utils.yparams import ParamsBase

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
    if name == "raw_forecasts.h5":
        assert got["fields"].shape == (9, 3, 5, 16, 32)


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
    for extra in (["--mask_file", str(out / "metrics.h5")], ["--climatology_file", str(out / "metrics.h5")]):
        with pytest.raises(NotImplementedError, match="side datasets"):
            inference.main(argv + extra)
    ens = ParamsBase(dict(cfg, ensemble_size=2))
    with pytest.raises(NotImplementedError, match="ensemble"):
        Inferencer(ens, device="cpu")
