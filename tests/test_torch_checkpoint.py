"""The port's checkpoints against makani_tpu's: the same ``ckpt_v{n}/``
versions kept (rotation by ``checkpoint_num_versions``, the best one
spared) and the same ``best_checkpoint.txt`` over one sequence of saves,
the ``model``/``opt``/``meta.json`` layout, a strict restore of the
weights, and an optimizer restored mid-run that continues with the step
counts, learning rates and parameters of an uninterrupted one, bit for bit
(the recipe's clipped Adam on the cosine schedule)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from makani_tpu.utils.checkpoint_helpers import CheckpointManager as JCheckpointManager

from makani_torch.utils.checkpoint_helpers import CheckpointManager, get_latest_checkpoint_version
from makani_torch.utils.training.optimizer import get_optimizer
from makani_torch.utils.yparams import ParamsBase
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (valid loss of the epoch) per save: is_best where it falls below the best so far
LOSSES = [3.0, 1.0, 2.0, 2.5, 0.5, 0.7]


def _model(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.GELU(), torch.nn.Linear(8, 3))


def _versions(d):
    return sorted(n for n in os.listdir(d) if n.startswith("ckpt_v"))


def test_rotation_and_best_match_jax(tmp_path):
    mgr = CheckpointManager(ParamsBase({"checkpoint_dir": str(tmp_path / "port"), "checkpoint_num_versions": 2}))
    jmgr = JCheckpointManager({"checkpoint_dir": str(tmp_path / "jax"), "checkpoint_num_versions": 2})
    model = _model()
    best = float("inf")
    for epoch, loss in enumerate(LOSSES, 1):
        is_best = loss < best
        best = min(best, loss)
        meta = {"epoch": epoch, "iters": 3 * epoch, "best_valid_loss": best}
        mgr.save(model, None, meta, is_best=is_best)
        jmgr.save({"w": jnp.full((2,), float(epoch))}, None, meta, is_best=is_best)
        assert _versions(mgr.checkpoint_dir) == _versions(jmgr.checkpoint_dir), epoch
        assert mgr.best_version() == jmgr.best_version()
    assert sorted(os.listdir(os.path.join(mgr.checkpoint_dir, "ckpt_v6"))) == ["meta.json", "model"]
    assert mgr.restore_best(_model(1)) == {"epoch": 5, "iters": 15, "best_valid_loss": 0.5}
    assert mgr.bytes_written > 0 and mgr.bytes_read > 0


def test_restore_is_strict_and_exact(tmp_path):
    mgr = CheckpointManager(ParamsBase({"experiment_dir": str(tmp_path)}))
    assert mgr.checkpoint_dir == str(tmp_path / "checkpoints") and get_latest_checkpoint_version(mgr.checkpoint_dir) is None
    assert mgr.restore_best(_model(1)) is None and not os.path.exists(mgr.checkpoint_dir)
    model = _model(0)
    mgr.save(model, None, {"epoch": 1})
    other = _model(1)
    assert mgr.restore_latest(other) == {"epoch": 1}
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), other.state_dict().values()))
    wider = torch.nn.Sequential(torch.nn.Linear(6, 9), torch.nn.GELU(), torch.nn.Linear(9, 3))
    with pytest.raises(RuntimeError):
        mgr.restore_latest(wider)


@pytest.mark.parametrize("nu_factored", [False, True], ids=["adam", "adam-factored"])
def test_optimizer_resumes_exactly(tmp_path, nu_factored):
    cfg = ParamsBase(dict(lr=1e-2, optimizer_type="Adam", optimizer_beta2=0.95, optimizer_max_grad_norm=0.5, scheduler="CosineAnnealingLR",
                          scheduler_T_max=3, optimizer_nu_factored=nu_factored, optimizer_mu_dtype="bfloat16" if nu_factored else None))
    steps_per_epoch = 2
    r = np.random.default_rng(0)
    xs = [torch.from_numpy(r.standard_normal((4, 6)).astype(np.float32)) for _ in range(6)]

    def step(model, opt, x):
        model(x).square().mean().backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return opt.last_lr

    ref = _model()
    ref_opt = get_optimizer(cfg, ref, steps_per_epoch)
    ref_lrs = [step(ref, ref_opt, x) for x in xs]

    first = _model()
    opt = get_optimizer(cfg, first, steps_per_epoch)
    lrs = [step(first, opt, x) for x in xs[:3]]
    mgr = CheckpointManager(ParamsBase({"checkpoint_dir": str(tmp_path)}))
    mgr.save(first, opt, {"epoch": 1})
    resumed = _model(5)
    ropt = get_optimizer(cfg, resumed, steps_per_epoch)
    mgr.restore_latest(resumed, ropt)
    assert all(int(s["count"]) == 3 and s["count"].device.type == "cpu" for s in ropt.state.values())
    lrs += [step(resumed, ropt, x) for x in xs[3:]]
    assert lrs == ref_lrs
    assert all(torch.equal(a, b) for a, b in zip(ref.parameters(), resumed.parameters()))
    for p, q in zip(ref.parameters(), resumed.parameters()):
        for k, v in ref_opt.state[p].items():
            assert v.dtype == ropt.state[q][k].dtype and torch.equal(v, ropt.state[q][k]), k
