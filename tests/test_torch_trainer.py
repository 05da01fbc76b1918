"""The port's ``Trainer`` against makani_tpu's, and the training CLI.

One epoch of a tiny fp32 SFNO (16x32, 5 channels, embed 16, 2 blocks,
instance norm) on ``init_hdf5_dataset`` files, batch 8, with the recipe's
``auto`` channel weights, clipped Adam (b2 0.95) on the cosine schedule, and
a validation rollout of 2 steps: the port's seeded weights are carried
into the JAX trainer (``params_to_jax``, its optimizer state initialised
from them), which then runs its own jitted step over its own batches in
its own epoch order. Per-step losses within 1e-5 relative; every parameter
after the epoch within 1e-4 of the leaf's max|p| where the gradient of some
step exceeds 1e-3 of the leaf's max (``test_torch_recipe.py``'s exclusion:
Adam scales a rounding-level gradient to a full step of either sign; so
the MLP's second bias, whose gradient is zero in exact arithmetic in front
of the instance norm, is left out as there); ``valid_loss`` and the metrics within 1e-5 relative to max(|ref|, 1).

The CLI (``python -m makani_torch.train ... --device cpu``): a run of one
epoch that checkpoints, the same run resumed for a second epoch from
``ckpt_v1``, and an uninterrupted run of two epochs give the same second
epoch, bit for bit (each step's loss, every parameter, the iteration
count); a parallel size raises."""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from makani_tpu.parallel import mesh as pmesh
from makani_tpu.utils.training import deterministic_trainer as jdt
from makani_tpu.utils.parse_dataset_metadata import parse_dataset_metadata as jparse
from makani_tpu.utils.yparams import ParamsBase as JParamsBase
from tests.testutils import CHANNEL_NAMES, init_hdf5_dataset

from makani_torch import train
from makani_torch.convert_jax import params_from_jax, params_to_jax
from makani_torch.utils.parse_dataset_metadata import parse_dataset_metadata
from makani_torch.utils.training.deterministic_trainer import Trainer
from makani_torch.utils.training.optimizer import get_optimizer
from makani_torch.utils.yparams import ParamsBase
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CONFIG = dict(
    nettype="SFNO", scale_factor=2, embed_dim=16, num_layers=2, channel_names=list(CHANNEL_NAMES), n_history=0, n_future=0, dt=1, dhours=6,
    add_zenith=True, batch_size=8, valid_autoreg_steps=1, normalization={"q700": "minmax"},
    losses=[{"type": "l2", "channel_weights": "auto", "parameters": {"squared": True}}], lr=2e-3, max_epochs=1, scheduler="CosineAnnealingLR",
    scheduler_T_max=2, optimizer_type="Adam", optimizer_beta2=0.95, optimizer_max_grad_norm=1.0, normalization_layer="instance_norm",
    compute_dtype="float32", metric_names=["rmse", "acc", "l1"], save_checkpoint="none", seed=333,
)


class _Seeded:
    """A JAX model whose ``init`` gives the port's weights."""

    def __init__(self, model, variables):
        self.model, self.variables = model, variables

    def init(self, *args, **kwargs):
        return self.variables

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, **kwargs)


def seeded_get_model(module, variables):
    """``module.get_model`` with ``init`` giving ``variables``."""
    orig = module.get_model

    def get_model(params, **kwargs):
        model, pre = orig(params, **kwargs)
        return _Seeded(model, variables), pre

    return get_model


def _close(a, b, tol):
    return abs(a - b) <= tol * max(abs(b), 1.0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    files = init_hdf5_dataset(root, years=(2017,), samples_per_year=18)
    cfg = dict(CONFIG, **files)
    port = ParamsBase(dict(copy.deepcopy(cfg), exp_dir=str(root / "port")))
    parse_dataset_metadata(files["metadata_json_path"], port)
    trainer = Trainer(port, device="cpu")
    variables = params_to_jax(trainer.model)
    grads = _epoch_gradients(trainer, port)
    logs = trainer.train()[0]

    ref = JParamsBase(dict(copy.deepcopy(cfg), exp_dir=str(root / "jax")))
    jparse(files["metadata_json_path"], ref)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdt, "get_model", seeded_get_model(jdt, variables))
        t = jdt.Trainer(ref)
    try:
        t.epoch = 1
        t.train_loader.set_epoch(1)
        jlosses = []
        for batch in t.train_loader:
            inp, tar, zen = t._put_batch(batch)
            loss, t.opt_state, t.model_params = t._train_step(t.model_params, t.opt_state, inp, tar, zen)
            jlosses.append(float(loss))
        jlogs = t.validate_one_epoch()
        jparams = params_from_jax(jax.tree.map(np.asarray, t.model_params))
    finally:
        pmesh.cleanup()
    return trainer, logs, jlosses, jlogs, jparams, grads


def _epoch_gradients(trainer, params):
    """max over the epoch's steps of each gradient entry's |g| / max|g| of
    its leaf, from a copy of the model and optimizer taking the trainer's
    first epoch."""
    model = copy.deepcopy(trainer.model)
    opt = get_optimizer(params, model, len(trainer.train_loader))
    trainer.train_loader.set_epoch(1)
    out = {}
    for batch in trainer.train_loader:
        inp, tar, zen = (torch.from_numpy(batch[k]) for k in ("inp", "tar", "zen"))
        trainer.loss_obj(model(inp, zen, train=True), tar, inp=inp, train=True).backward()
        for name, p in model.named_parameters():
            g = p.grad.abs() / p.grad.abs().max()
            out[name] = torch.maximum(out[name], g) if name in out else g
        opt.step()
        opt.zero_grad(set_to_none=True)
    return out


def test_trainer_epoch_matches_jax(runs):
    trainer, logs, jlosses, jlogs, jparams, grads = runs
    losses = [float(v) for v in trainer.step_losses]
    assert len(losses) == len(jlosses) == 2
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(losses, jlosses)), (losses, jlosses)
    assert abs(logs["train_loss"] - np.mean(jlosses)) <= 1e-5 * abs(np.mean(jlosses))
    for name, p in trainer.model.named_parameters():
        if name.endswith("mlp.fc2.bias"):
            continue
        ref, mask = jparams[name].numpy(), grads[name].numpy() > 1e-3
        assert mask.any() and np.max(np.abs(p.detach().numpy() - ref)[mask]) <= 1e-4 * np.max(np.abs(ref)), name


def test_validation_matches_jax(runs):
    _, logs, _, jlogs, _, _ = runs
    assert _close(logs["valid_loss"], jlogs["valid_loss"], 1e-5)
    keys = [k for k in jlogs if k != "valid_loss"]
    assert keys and all(k in logs for k in keys)
    bad = {k: (logs[k], jlogs[k]) for k in keys if not _close(logs[k], jlogs[k], 1e-5)}
    assert not bad, bad
    for key in ("train_samples_per_sec", "train_time", "step_time_ms", "effective_io_rate_gbs"):
        assert logs[key] > 0, key


def test_cli_resume_equals_uninterrupted(tmp_path):
    files = init_hdf5_dataset(tmp_path, years=(2017,), samples_per_year=10)
    cfg = dict(CONFIG, batch_size=4, save_checkpoint="flexible", exp_dir=str(tmp_path / "runs"), **files)
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump({"tiny": cfg}, f)

    def run(*argv):
        return train.main(["--yaml_config", str(tmp_path / "cfg.yaml"), "--config", "tiny", "--device", "cpu", *argv])

    first = run("--run_num", "a", "--max_epochs", "1")
    exp = tmp_path / "runs" / "tiny" / "a"
    assert sorted(os.listdir(exp / "checkpoints")) == ["best_checkpoint.txt", "ckpt_v1"]
    assert first.epoch == 1 and not first.params["resuming"]
    resumed = run("--run_num", "a", "--max_epochs", "2")
    whole = run("--run_num", "b", "--max_epochs", "2")
    assert resumed.params["resuming"] and resumed.epoch == whole.epoch == 2 and resumed.iters == whole.iters == 4
    assert [v.item() for v in resumed.step_losses] == [v.item() for v in whole.step_losses]
    assert all(torch.equal(p, q) for p, q in zip(resumed.model.parameters(), whole.model.parameters()))
    rows = [json.loads(line) for line in open(tmp_path / "runs" / "metrics.jsonl")]
    assert [r["epoch"] for r in rows] == [1, 2, 1, 2]
    assert sorted(os.listdir(exp / "checkpoints")) == ["best_checkpoint.txt", "ckpt_v1", "ckpt_v2"]
    with pytest.raises(NotImplementedError, match="slice 6"):
        run("--run_num", "c", "--h_parallel_size", "2")
    for flag in ("--pretrained_checkpoint_path", "--checkpoint_path"):
        with pytest.raises(SystemExit):
            run("--run_num", "c", flag, str(exp / "checkpoints"))
