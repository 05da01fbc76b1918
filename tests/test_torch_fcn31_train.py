"""One FCN3.1 ensemble-CRPS training step in makani_torch against makani_tpu's.

The configuration is ``chip_smoke.fcn31_train_config`` (the recipe
``fcn31_sc2_edim256_layers10`` with the FCN3 training step's cuts) shrunk: a
17x32 grid, scale 2, the recipe's 73 channels with ``sst`` in place of
``u100m`` (a NaN patch in the input's, which the imputation fills), embed 64 (so that the unified encoder, the decoder and the local
block take the two-stage path, as at the published widths: responses, the
channel mix K8 and its backward GEMMs), aux embed 4, pos embed 3, two blocks of which block 0 spectral, lmax from the grid at
hard_thresholding_fraction 1, the zenith and two centered diffusion-noise
channels, E = 4 members of B = 1 sample, ``checkpointing_level`` 3, the
skillspread CRPS with constant channel weights (as
tests/test_torch_fcn3_train.py; the recipe's auto weights and
temp_diff_normalization are held in tests/test_torch_recipe.py and on the
card), and the recipe's optimizer (Adam at lr 5e-4 clipped at 1.0 on the
cosine schedule), fp32 compute with mu in fp32. The bf16 step is held on
the card (``chip_smoke.py``).

Both packages' ``get_model(multistep=True)`` run the same weights (the
port's seeded ones, the layer scales, biases and latitude embedding drawn
at random, as a flax tree by ``params_to_jax`` whose names and shapes are
the JAX model's) and the same optimizer state (``opt_state_from_jax``) and
take one step on the same seeded input, target and noise: JAX's
``jax.value_and_grad`` of the forward and ``LossHandler`` on the folded
ensemble, then ``tx.update``, compiled once; the port's
``ensemble_train_step``. The pixels where the two forecasts may rank the
members differently weigh 0 in both losses (``chip_smoke.crps_order_weight``).
Tolerances, as the FCN3 step's in fp32: forecast 1e-4 of max|ref|, loss 1e-5
relative, each gradient leaf 1e-4 of its max|ref|, parameters after the step
within 1e-3 * lr where |g| > 1e-3 of the leaf's max|g|.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from makani_tpu.models.model_registry import get_model as jget_model
from makani_tpu.utils.loss import LossHandler as JLossHandler
from makani_tpu.utils.training.ensemble_trainer import fold_ensemble as jfold_ensemble
from makani_tpu.utils.training.optimizer import get_optimizer as jget_optimizer
from makani_tpu.utils.yparams import ParamsBase as JParamsBase

from chip_smoke import crps_order_weight, fcn31_train_config
from makani_torch import kernels
from makani_torch.convert_jax import opt_state_from_jax, params_to_jax
from makani_torch.models.model_registry import get_model
from makani_torch.utils.loss import LossHandler
from makani_torch.utils.training.ensemble_trainer import _forward_folded, ensemble_train_step, fold_ensemble
from makani_torch.utils.training.optimizer import Adam, get_optimizer
from makani_torch.utils.yparams import ParamsBase
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W, E, B = 17, 32, 4, 1
NAMES = ["sst" if n == "u100m" else n for n in fcn31_train_config()["channel_names"]]
NOISE = 2
LOSSES = [{"type": "crps", "channel_weights": "constant", "parameters": {"crps_type": "skillspread"}}]


def _config():
    cfg = fcn31_train_config(
        img_shape_x=H, img_shape_y=W, channel_names=NAMES, embed_dim=64, aux_embed_dim=4, pos_embed_dim=3, num_layers=2, sfno_block_frequency=2,
        hard_thresholding_fraction=1.0, input_noise=dict(fcn31_train_config()["input_noise"], n_channels=NOISE), compute_dtype="float32",
        optimizer_mu_dtype="float32", losses=LOSSES,
    )
    assert cfg["nettype"] == "FCN3.1" and cfg["filter_basis_type"] == "harmonic" and cfg["filter_basis_norm_mode"] == "nodal"
    assert cfg["ensemble_size"] == E and cfg["batch_size"] == B and cfg["checkpointing_level"] == 3 and cfg["optimizer_max_grad_norm"] == 1.0
    return cfg


def _variables(jmodel, model, *args):
    """The port model's seeded weights, with the layer scales, biases and
    the latitude embedding drawn at random, as a flax tree whose names and
    shapes are the JAX model's."""
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                p.copy_(torch.from_numpy(0.1 + 0.05 * rng.standard_normal(p.shape)))
            elif leaf in ("bias", "pos_embed"):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape)))
    variables = params_to_jax(model)
    shapes = _flatten(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args), keep=True)
    assert {k: tuple(v.shape) for k, v in shapes.items()} == {k: v.shape for k, v in _flatten(variables).items()}
    return variables


def _flatten(tree, prefix="", keep=False):
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flatten(v, key, keep) if isinstance(v, dict) else {key: v if keep else np.asarray(v, np.float32)})
    return out


@pytest.fixture(scope="module")
def step():
    """Both packages' step, as numpy by name: forecasts, loss, gradients and
    parameters after the step."""
    cfg = _config()
    r = np.random.default_rng(3)
    inp = np.repeat(r.standard_normal((B, len(NAMES), H, W)).astype(np.float32), E, axis=0)
    inp[:, NAMES.index("sst"), 5:10, 8:20] = np.nan  # land: the imputation fills it
    tar = r.standard_normal((B, len(NAMES), H, W)).astype(np.float32)
    unp = np.concatenate([r.uniform(-1.0, 1.0, (B * E, 1, 1, H, W)), r.standard_normal((B * E, 1, NOISE, H, W))], axis=2).astype(np.float32)
    unp[1::2, :, 1:] = -unp[0::2, :, 1:]
    jmodel, _ = jget_model(JParamsBase(copy.deepcopy(cfg)), multistep=True)
    model, _ = get_model(ParamsBase(copy.deepcopy(cfg)), multistep=True, device="cpu")
    variables = _variables(jmodel, model, jnp.asarray(inp), jnp.asarray(unp))
    jloss = JLossHandler(JParamsBase(copy.deepcopy(cfg)))
    tx, _ = jget_optimizer(JParamsBase(copy.deepcopy(cfg)), variables)
    opt_state = tx.init(variables)

    @jax.jit
    def jstep(p, s, x, t, z, wgt):
        def f(q):
            pred = jmodel.apply(q, x, z, train=True)
            return jloss(jfold_ensemble(pred, E), t, wgt=wgt, train=True), pred

        (loss, pred), grads = jax.value_and_grad(f, has_aux=True)(p)
        updates, s = tx.update(grads, s, p)
        return loss, pred, grads, optax.apply_updates(p, updates)

    loss_obj = LossHandler(ParamsBase(copy.deepcopy(cfg)))
    assert model.model.checkpointing_level == 3 and not model.model.encoder.conv.fused and not model.model.decoder.conv.fused
    x, t, z = map(torch.from_numpy, (inp, tar, unp))
    # the same compiled step twice: once for the JAX forecast, then with
    # the pixels whose member ranks the two forecasts may order apart out
    jpred = np.asarray(jstep(variables, opt_state, inp, tar, unp, np.ones((B, len(NAMES), H, W), np.float32))[1])
    with torch.no_grad():
        pred = model(x, z, train=True)
    wgt = crps_order_weight(fold_ensemble(torch.from_numpy(jpred), E), fold_ensemble(pred, E), t)
    assert wgt.mean() > 0.999, float(wgt.mean())
    jl, _, jg, jp = jax.tree.map(np.asarray, jstep(variables, opt_state, inp, tar, unp, wgt.numpy()))

    def adam(m):
        opt = get_optimizer(ParamsBase(copy.deepcopy(cfg)), m)
        assert isinstance(opt, Adam) and opt.max_grad_norm == 1.0
        opt.load_state_dict(opt_state_from_jax(jax.tree.map(np.asarray, opt_state), m, opt))
        return opt

    twin = copy.deepcopy(model)
    kernels.reset_launch_counts()
    loss = loss_obj(fold_ensemble(_forward_folded(model, x, z, E, 0), E), t, wgt=wgt, train=True)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    adam(model).step()
    # ensemble_train_step takes the same step, unweighted
    twin_loss = ensemble_train_step(twin, loss_obj, adam(twin), x, t, z, E)
    assert not any(kernels.LAUNCHES.values())
    params = lambda m: {n: p.detach().numpy().copy() for n, p in m.named_parameters()}
    return dict(
        jpred=jpred, pred=pred.numpy(), jl=float(jl), jg=_flatten(jg), jp=_flatten(jp), loss=loss.item(), twin_loss=float(twin_loss),
        grads={n: g.numpy() for n, g in grads.items()}, params=params(model), twin=params(twin), p0=_flatten(variables),
    )


def test_forecast_and_loss(step):
    assert np.max(np.abs(step["pred"] - step["jpred"])) <= 1e-4 * np.max(np.abs(step["jpred"]))
    assert abs(step["loss"] - step["jl"]) <= 1e-5 * abs(step["jl"])
    assert np.isfinite(step["twin_loss"]) and abs(step["twin_loss"] - step["loss"]) <= 1e-2 * abs(step["loss"])


def test_gradients(step):
    assert set(step["grads"]) == set(step["jg"])
    for n, ref in step["jg"].items():
        got = step["grads"][n]
        assert got.shape == ref.shape, n
        assert np.max(np.abs(got - ref)) <= 1e-4 * np.max(np.abs(ref)), (n, np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def test_parameters_after_the_step(step):
    lr = _config()["lr"]
    for n, ref in step["jp"].items():
        got, g = step["params"][n], np.abs(step["jg"][n])
        mask = g > 1e-3 * g.max()
        assert np.max(np.abs(got - ref)[mask]) <= 1e-3 * lr, (n, np.max(np.abs(got - ref)[mask]) / lr)
