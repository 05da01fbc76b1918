"""The port's ``EnsembleTrainer`` against makani_tpu's, and the ensemble CLI.

One epoch of a tiny fp32 FCN3 (``chip_smoke.fcn3_train_config`` shrunk as
in tests/test_torch_fcn3_train.py: 33x64, 14 channels, embeds 24/16/8, 2
blocks, the zenith and 2 centered diffusion-noise channels) at E = 2 of
B = 1 on ``init_hdf5_dataset`` files: 3 steps of the skillspread CRPS with
constant channel weights and the recipe's clipped Adam on the cosine
schedule, then a validation rollout of 2 steps scored with the recipe's
metrics (rmse, acc, crps, spread, ssr). The port's seeded weights are
carried into the JAX trainer (``params_to_jax``), built on a one-device
mesh, and the packages draw their noise from different RNGs, so the JAX
trainer's ``_noise_rows`` hands out the port's draws in the order the port
made them. Per-step losses within 1e-5 relative; every parameter after the
epoch within 1e-4 of its leaf's max|p| where some step's gradient exceeds
1e-3 of the leaf's max (``test_torch_trainer.py``'s exclusion of
rounding-level gradients, which Adam scales to full steps);
``valid_loss`` and the metrics within 1e-5 relative to max(|ref|, 1).

In the port alone: ``ensemble_fold_chunk`` 1 (each member its own
recomputed chunk) takes the same epoch as 0 (losses 1e-6 relative,
parameters as above; the biases, zero at the start, are the closest); the CLI (``python -m makani_torch.ensemble
... --device cpu``) resumed for a second epoch equals the first run carried
on in memory with its generator reseeded to ``seed + 1`` at the same point,
bit for bit (the noise stream is not checkpointed, as in the JAX package);
the ``perturb`` noise mode, a missing ``input_noise``, an odd centered
ensemble and the recipe's ``ensemble_parallel_size`` 16 raise."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from makani_tpu.parallel import mesh as pmesh
from makani_tpu.utils.parse_dataset_metadata import parse_dataset_metadata as jparse
from makani_tpu.utils.training import deterministic_trainer as jdt
from makani_tpu.utils.training import ensemble_trainer as jet
from makani_tpu.utils.yparams import ParamsBase as JParamsBase
from tests.test_torch_trainer import seeded_get_model
from tests.testutils import init_hdf5_dataset

from chip_smoke import FCN3_CONFIG, REPO, fcn3_train_config
from makani_torch import ensemble
from makani_torch.convert_jax import params_from_jax, params_to_jax
from makani_torch.utils.parse_dataset_metadata import parse_dataset_metadata
from makani_torch.utils.training.ensemble_trainer import EnsembleTrainer
from makani_torch.utils.yparams import ParamsBase, YParams
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W, E = 33, 64, 2
NAMES = ["u10m", "v10m", "t2m", "tcwv", "u500", "v500", "z500", "t500", "q500", "u850", "v850", "z850", "t850", "q850"]


def tiny_fcn3(files, **over):
    """The tiny FCN3 ensemble configuration on ``files``."""
    cfg = fcn3_train_config(
        img_shape_x=H, img_shape_y=W, channel_names=NAMES, atmo_embed_dim=24, surf_embed_dim=16, aux_embed_dim=8, num_layers=2,
        input_noise=dict(fcn3_train_config()["input_noise"], n_channels=2), compute_dtype="float32", optimizer_mu_dtype="float32",
        losses=[{"type": "crps", "channel_weights": "constant", "parameters": {"crps_type": "skillspread"}}], ensemble_size=E, valid_autoreg_steps=1,
        max_epochs=1, save_checkpoint="none", **files,
    )
    cfg.update(over)
    return cfg


def one_device_mesh(init):
    return lambda **kw: init(**kw, devices=jax.devices()[:1])


def _close(a, b, tol):
    return abs(a - b) <= tol * max(abs(b), 1.0)


def _recording(trainer):
    """Record each noise draw of ``trainer`` (its noise channels) and, at
    every optimizer step, the max over steps of each gradient entry's |g| /
    max|g| of its leaf."""
    noises, gmax = [], {}
    fold, step = trainer._fold, trainer.optimizer.step
    n_zen = 1 if trainer.params.get("add_zenith", False) else 0

    def recording_fold(batch, total_steps):
        out = fold(batch, total_steps)
        noises.append(out[2][:, :, n_zen:].numpy().copy())
        return out

    def recording_step(*args, **kwargs):
        for name, p in trainer.model.named_parameters():
            g = p.grad.abs() / p.grad.abs().max().clamp_min(1e-30)
            gmax[name] = torch.maximum(gmax[name], g) if name in gmax else g
        return step(*args, **kwargs)

    trainer._fold, trainer.optimizer.step = recording_fold, recording_step
    return noises, gmax


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ensemble_trainer")
    files = init_hdf5_dataset(root, years=(2017,), samples_per_year=4, nlat=H, nlon=W, channels=NAMES)
    cfg = tiny_fcn3(files)
    port = ParamsBase(dict(copy.deepcopy(cfg), exp_dir=str(root / "port")))
    parse_dataset_metadata(files["metadata_json_path"], port)
    trainer = EnsembleTrainer(port, device="cpu")
    variables = params_to_jax(trainer.model)
    noises, gmax = _recording(trainer)
    logs = trainer.train()[0]

    chunked = EnsembleTrainer(ParamsBase(dict(port.to_dict(), ensemble_fold_chunk=1)), device="cpu")
    assert chunked.fold_chunk == 1
    clogs = chunked.train()[0]

    ref = JParamsBase(dict(copy.deepcopy(cfg), exp_dir=str(root / "jax")))
    jparse(files["metadata_json_path"], ref)
    queue = list(noises)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdt, "get_model", seeded_get_model(jdt, variables))
        mp.setattr(pmesh, "init", one_device_mesh(pmesh.init))
        t = jet.EnsembleTrainer(ref)
    try:
        t._noise_rows = lambda key, bs, es, total_steps: jnp.asarray(queue.pop(0))
        jlosses, step = [], t._ens_train_step

        def recording_step(*args):
            out = step(*args)
            jlosses.append(float(out[0]))
            return out

        t._ens_train_step = recording_step
        t.epoch = 1
        t.train_loader.set_epoch(1)
        t.train_one_epoch()
        jlogs = t.validate_one_epoch()
        jparams = params_from_jax(jax.tree.map(np.asarray, t.model_params))
    finally:
        pmesh.cleanup()
    assert not queue and len(noises) == 3 + 2
    return dict(trainer=trainer, logs=logs, chunked=chunked, clogs=clogs, jlosses=jlosses, jlogs=jlogs, jparams=jparams, gmax=gmax, noises=noises)


def _params_close(model, ref, gmax, tol):
    for name, p in model.named_parameters():
        r, mask = ref[name].numpy(), gmax[name].numpy() > 1e-3
        assert mask.any() and np.max(np.abs(p.detach().numpy() - r)[mask]) <= tol * np.max(np.abs(r)), name


def test_epoch_matches_jax(runs):
    losses = [float(v) for v in runs["trainer"].step_losses]
    jlosses = runs["jlosses"]
    assert len(losses) == len(jlosses) == 3
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(losses, jlosses)), (losses, jlosses)
    _params_close(runs["trainer"].model, runs["jparams"], runs["gmax"], 1e-4)
    # centered pairs: the second member's noise is the first's negative
    assert all(np.array_equal(n[1::2], -n[0::2]) for n in runs["noises"])


def test_validation_matches_jax(runs):
    logs, jlogs = runs["logs"], runs["jlogs"]
    keys = [k for k in jlogs if k != "valid_loss"]
    assert any(k.startswith("crps") for k in keys) and any(k.startswith("ssr") for k in keys) and all(k in logs for k in keys)
    bad = {k: (logs[k], jlogs[k]) for k in jlogs if not _close(logs[k], jlogs[k], 1e-5)}
    assert not bad, bad
    stats = runs["trainer"].host_stats
    assert stats["batches"] == 3 and stats["noise_device_ms"] == [] and logs["step_time_ms"] > 0


def test_fold_chunk_one_equals_zero(runs):
    a = [float(v) for v in runs["trainer"].step_losses]
    b = [float(v) for v in runs["chunked"].step_losses]
    assert all(abs(x - y) <= 1e-6 * abs(y) for x, y in zip(b, a)), (a, b)
    ref = {n: p.detach() for n, p in runs["trainer"].model.named_parameters()}
    _params_close(runs["chunked"].model, ref, runs["gmax"], 1e-4)
    assert _close(runs["clogs"]["valid_loss"], runs["logs"]["valid_loss"], 1e-6)


def test_cli_resume_equals_reseeded_run(tmp_path):
    files = init_hdf5_dataset(tmp_path, years=(2017,), samples_per_year=4, nlat=H, nlon=W, channels=NAMES)
    cfg = tiny_fcn3(files, ensemble_size=4, save_checkpoint="flexible", exp_dir=str(tmp_path / "runs"))
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump({"tiny": cfg}, f)

    def run(*argv):
        return ensemble.main(["--yaml_config", str(tmp_path / "cfg.yaml"), "--config", "tiny", "--device", "cpu", "--ensemble_size", "2", *argv])

    first = run("--run_num", "a", "--max_epochs", "1")
    assert first.ensemble_size == 2 and first.epoch == 1 and sorted(os.listdir(tmp_path / "runs" / "tiny" / "a" / "checkpoints")) == ["best_checkpoint.txt", "ckpt_v1"]
    resumed = run("--run_num", "a", "--max_epochs", "2")
    assert resumed.params["resuming"] and resumed.epoch == 2 and resumed.iters == 6 and len(resumed.logs) == 1
    # the first run carried on, its noise stream restarted as a resumed run's is
    first.generator.manual_seed(first.params.get("seed", 333) + 1)
    first.epoch = 2
    first.train_batches.set_epoch(2)
    logs = first.train_one_epoch()
    logs.update(first.validate_one_epoch())
    assert [v.item() for v in resumed.step_losses] == [v.item() for v in first.step_losses]
    assert all(torch.equal(p, q) for p, q in zip(resumed.model.parameters(), first.model.parameters()))
    assert resumed.optimizer.last_lr == first.optimizer.last_lr and resumed.logs[-1]["valid_loss"] == logs["valid_loss"]


def test_refusals(tmp_path):
    files = init_hdf5_dataset(tmp_path, years=(2017,), samples_per_year=3, nlat=H, nlon=W, channels=NAMES)
    cfg = tiny_fcn3(files)
    noise = cfg["input_noise"]
    cases = [
        (dict(input_noise=dict(noise, mode="perturb")), NotImplementedError, "item 10"),
        (dict(input_noise=None), ValueError, "input_noise"),
        (dict(ensemble_size=3), ValueError, "even"),
        (dict(ensemble_fold_chunk=3, ensemble_size=4), ValueError, "must divide"),
    ]
    for over, exc, match in cases:
        with pytest.raises(exc, match=match):
            EnsembleTrainer(ParamsBase(dict(copy.deepcopy(cfg), **over)), device="cpu")
    recipe = YParams(os.path.join(REPO, FCN3_CONFIG[0]), "fcn3_sc2_edim45_layers10_ensemble")
    assert recipe.ensemble_parallel_size == 16
    with pytest.raises(NotImplementedError, match="item 12"):
        EnsembleTrainer(recipe, device="cpu")
