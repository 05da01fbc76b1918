"""One FCN3 ensemble-CRPS training step in makani_torch against makani_tpu's.

The configuration is ``chip_smoke.fcn3_train_config`` (the recipe's base
config with the ensemble cuts) shrunk: a 33x64 grid, scale 2, two pressure
levels of five variables and four surface channels, embeds 24/16/8 (a
72-channel processor, so that the local blocks take the two-stage path:
responses, the channel mix K8 and its backward GEMMs), two blocks of which
block 0 spectral, the zenith and two centered diffusion-noise channels, E =
4 members of B = 1 sample, the skillspread CRPS with constant channel
weights, and the recipe's optimizer: Adam at lr 5e-4 clipped at a global
norm of 1.0 on the cosine schedule, each package's ``get_optimizer``. Both packages' ``get_model(multistep=True)``
are built from the same flax weights (``load_from_jax``) and the same
optimizer state (``opt_state_from_jax``) and take one step on the same
seeded numpy input, target and noise: JAX's ``jax.value_and_grad`` of the
forward and ``LossHandler`` on the folded ensemble, then ``tx.update``; the
port's ``ensemble_train_step``. Two configurations, each built once per
module: fp32 compute with mu in fp32 (the recipe's), and bf16 compute with a
bf16 mu, from the same flax weights (one JAX init serves both: the
parameters are fp32 in either). Both rematerialize at ``checkpointing_level``
3 (as the JAX model does).

The CRPS gradient jumps where two members swap ranks or a member crosses
the observation, and the two packages' forecasts differ by rounding: in
fp32, where the gaps between the members and the observation at a pixel
do not exceed four times the forecasts' difference there, the pixel
weighs 0 in both packages' loss (``chip_smoke.crps_order_weight``, the
loss handlers' ``wgt``; at most 0.1% of the pixels, 2 of 118272 here, and
one such near-tie moves the processor's gradients by up to 1.4e-3 of their
size). In bf16 every pixel counts: the bf16 tolerances below cover both the
bf16 rounding and those jumps (measured without them: 7.0% on the block
layer scales, 1.3% on the largest 2-D leaf).

Tolerances, fp32: loss 1e-5 relative; each gradient leaf 1e-4 of its
max|ref| (the JAX package takes its DFTs as matmuls on the CPU, the port
``torch.fft``); parameters after the step within 1e-3 * lr where |g| > 1e-3
of the leaf's max|g|, as in tests/test_torch_train_step.py (Adam's first
step is sign(g), which flips where g ~ 0). bf16: loss 2e-2 relative;
gradients relative L2 5e-2 (1e-1 for the per-channel leaves, biases and
layer scales, sums of bf16 products over the pixels, which the JAX package
takes in bf16); parameters within 1e-2 * lr where |g| > 1e-1 of its max.

In the port alone, at fp32: ``checkpointing_level`` 3 and 0 give the same
loss and gradients, and so do ``fold_chunk`` 2 and 0 (the member-chunked
forward), to 1e-6 of max|g| (the same operations, but for the order in
which autograd sums shared gradients); and ``prepare_ensemble_batch`` folds
the members sample-major and pairs the centered noise.
"""

import copy
import os
import subprocess
import sys

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

from chip_smoke import crps_order_weight, fcn3_train_config
from makani_torch import kernels
from makani_torch.convert_jax import load_from_jax, opt_state_from_jax
from makani_torch.models.model_registry import get_model
from makani_torch.models.noise import build_noise
from makani_torch.utils.loss import LossHandler
from makani_torch.utils.training.ensemble_trainer import ensemble_train_step, expand_ensemble, fold_ensemble, prepare_ensemble_batch
from makani_torch.utils.training.optimizer import Adam, get_optimizer
from makani_torch.utils.yparams import ParamsBase
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W, E, B = 33, 64, 4, 1
LR = fcn3_train_config()["lr"]
NAMES = ["u10m", "v10m", "t2m", "tcwv", "u500", "v500", "z500", "t500", "q500", "u850", "v850", "z850", "t850", "q850"]
NOISE = 2
# constant channel weights, on which the bf16 gates below were measured
# (tests/test_torch_recipe.py holds the recipe's auto weights with
# temp_diff_normalization)
LOSSES = [{"type": "crps", "channel_weights": "constant", "parameters": {"crps_type": "skillspread"}}]


def _config(compute_dtype, **over):
    cfg = fcn3_train_config(
        img_shape_x=H, img_shape_y=W, channel_names=NAMES, atmo_embed_dim=24, surf_embed_dim=16, aux_embed_dim=8, num_layers=2,
        input_noise=dict(fcn3_train_config()["input_noise"], n_channels=NOISE), compute_dtype=compute_dtype,
        optimizer_mu_dtype="bfloat16" if compute_dtype == "bfloat16" else "float32", losses=LOSSES, **over,
    )
    assert cfg["ensemble_size"] == E and cfg["batch_size"] == B and cfg["checkpointing_level"] == 3 and cfg["optimizer_max_grad_norm"] == 1.0
    return cfg


def _batch(seed=3):
    r = np.random.default_rng(seed)
    inp = r.standard_normal((B, len(NAMES), H, W)).astype(np.float32)
    tar = r.standard_normal((B, len(NAMES), H, W)).astype(np.float32)
    unp = np.concatenate([r.uniform(-1.0, 1.0, (B * E, 1, 1, H, W)), r.standard_normal((B * E, 1, NOISE, H, W))], axis=2).astype(np.float32)
    return np.repeat(inp, E, axis=0), tar, unp


def _variables(model, *args):
    """Flax variables as numpy, with the layer scales and biases drawn at
    random so that they count."""
    variables = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        name = path[-1].key
        if name == "gamma":
            return (0.1 + 0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _port(cfg, variables):
    model, _ = get_model(ParamsBase(copy.deepcopy(cfg)), multistep=True, device="cpu")
    load_from_jax(model, variables)
    return model, LossHandler(ParamsBase(copy.deepcopy(cfg)))


def _loss_and_grads(model, loss_obj, x, t, z, chunk=0, wgt=None):
    from makani_torch.utils.training.ensemble_trainer import _forward_folded

    loss = loss_obj(fold_ensemble(_forward_folded(model, x, z, E, chunk), E), t, wgt=wgt, train=True)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


@pytest.fixture(scope="module")
def jax_variables():
    """The flax variables of every configuration here, from one JAX init:
    the tree and its values depend neither on the compute dtype (the
    parameters are fp32 in both) nor on the input's values."""
    cfg = _config("float32")
    inp, _, unp = _batch()
    jmodel, _ = jget_model(JParamsBase(copy.deepcopy(cfg)), multistep=True)
    return _variables(jmodel, jnp.asarray(inp), jnp.asarray(unp))


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def step(request, jax_variables):
    """Both packages' step: loss, gradients and parameters after the step,
    by name, as numpy."""
    cfg = _config({"fp32": "float32", "bf16": "bfloat16"}[request.param])
    bf16 = request.param == "bf16"
    inp, tar, unp = _batch()
    jmodel, _ = jget_model(JParamsBase(copy.deepcopy(cfg)), multistep=True)
    variables = jax_variables
    jloss = JLossHandler(JParamsBase(copy.deepcopy(cfg)))
    tx, _ = jget_optimizer(JParamsBase(copy.deepcopy(cfg)), variables)
    opt_state = tx.init(variables)

    @jax.jit
    def jstep(p, s, x, t, z, wgt):
        loss, grads = jax.value_and_grad(lambda q: jloss(jfold_ensemble(jmodel.apply(q, x, z, train=True), E), t, wgt=wgt, train=True))(p)
        updates, s = tx.update(grads, s, p)
        return loss, grads, optax.apply_updates(p, updates)

    model, loss_obj = _port(cfg, variables)
    x, t, z = map(torch.from_numpy, (inp, tar, unp))
    # the pixels where the two forecasts may rank the members differently
    # weigh 0 in both packages' loss (chip_smoke.crps_order_weight)
    wgt = None
    if not bf16:
        jpred = jax.jit(lambda q: jmodel.apply(q, inp, unp, train=True))(variables)
        with torch.no_grad():
            pred = model(x, z, train=True)
        wgt = crps_order_weight(fold_ensemble(torch.from_numpy(np.array(jpred)), E), fold_ensemble(pred, E), t)
        assert wgt.mean() > 0.999, float(wgt.mean())
    jl, jg, jp = jax.tree.map(np.asarray, jstep(variables, opt_state, inp, tar, unp, None if wgt is None else wgt.numpy()))

    twin, ref_twin = copy.deepcopy(model), copy.deepcopy(model)

    def adam(m):
        opt = get_optimizer(ParamsBase(copy.deepcopy(cfg)), m)
        assert isinstance(opt, Adam) and opt.max_grad_norm == 1.0
        opt.load_state_dict(opt_state_from_jax(jax.tree.map(np.asarray, opt_state), m, opt))
        return opt

    def manual_step(m, wgt):
        loss, grads = _loss_and_grads(m, loss_obj, x, t, z, wgt=wgt)
        for n, p in m.named_parameters():
            p.grad = grads[n]
        adam(m).step()
        return loss, grads

    kernels.reset_launch_counts()
    loss, grads = manual_step(model, wgt)
    # ensemble_train_step takes the same step (unweighted)
    twin_loss = ensemble_train_step(twin, loss_obj, adam(twin), x, t, z, E)
    ref_twin_loss, _ = manual_step(ref_twin, None)
    assert not any(kernels.LAUNCHES.values())
    flat = lambda tree: {k.replace("/", "."): v for k, v in _flatten(tree).items()}
    params = lambda m: {n: p.detach().numpy().copy() for n, p in m.named_parameters()}
    return dict(
        bf16=bf16, jl=float(jl), jg=flat(jg), jp=flat(jp), p0=flat(variables), loss=loss, twin_loss=float(twin_loss), ref_twin_loss=ref_twin_loss,
        grads={n: g.float().numpy() for n, g in grads.items()}, params=params(model), twin=params(twin), ref_twin=params(ref_twin),
    )


def _flatten(tree, prefix=""):
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: np.asarray(v, np.float32)})
    return out


def test_loss(step):
    tol = 2e-2 if step["bf16"] else 1e-5
    assert abs(step["loss"] - step["jl"]) <= tol * abs(step["jl"])
    assert step["twin_loss"] == step["ref_twin_loss"]
    for n, p in step["ref_twin"].items():
        np.testing.assert_array_equal(step["twin"][n], p, err_msg=n)


def test_gradients(step):
    assert set(step["grads"]) == set(step["jg"])
    for n, ref in step["jg"].items():
        got = step["grads"][n]
        assert got.shape == ref.shape, n
        if step["bf16"]:
            rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert rel <= (1e-1 if max(ref.shape) == ref.size else 5e-2), (n, rel)
        else:
            assert np.max(np.abs(got - ref)) <= 1e-4 * np.max(np.abs(ref)), (n, np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def test_parameters_after_the_step(step):
    for n, ref in step["jp"].items():
        got, p0, g = step["params"][n], step["p0"][n], np.abs(step["jg"][n])
        if step["bf16"]:
            mask = g > 1e-1 * g.max()
            assert np.max(np.abs(got - ref)[mask]) <= 1e-2 * LR, n
        else:
            mask = g > 1e-3 * g.max()
            assert np.max(np.abs(got - ref)[mask]) <= 1e-3 * LR, (n, np.max(np.abs(got - ref)[mask]) / LR)


@pytest.fixture(scope="module")
def fp32_port(jax_variables):
    cfg = _config("float32")
    inp, tar, unp = _batch(seed=5)
    return cfg, jax_variables, tuple(map(torch.from_numpy, (inp, tar, unp)))


@pytest.mark.parametrize("variant", ["checkpointing_level_0", "fold_chunk_2"])
def test_remat_and_fold_chunk_equal_the_plain_step(fp32_port, variant):
    cfg, variables, batch = fp32_port
    model, loss_obj = _port(cfg, variables)
    ref_loss, ref = _loss_and_grads(model, loss_obj, *batch)
    if variant == "fold_chunk_2":
        loss, grads = _loss_and_grads(model, loss_obj, *batch, chunk=2)
    else:
        model0, loss_obj0 = _port(dict(cfg, checkpointing_level=0), variables)
        assert model0.model.checkpointing_level == 0 and model.model.checkpointing_level == 3
        loss, grads = _loss_and_grads(model0, loss_obj0, *batch)
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    for n, g in ref.items():
        assert torch.max(torch.abs(grads[n] - g)) <= 1e-6 * torch.max(torch.abs(g)), n
    with pytest.raises(ValueError, match="must divide"):
        ensemble_train_step(model, loss_obj, None, *batch, E, fold_chunk=3)


def test_prepare_ensemble_batch():
    cfg = _config("float32")
    noise = build_noise(dict(cfg["input_noise"], grid_type=cfg["model_grid_type"]), (H, W), num_time_steps=1)
    r = np.random.default_rng(6)
    inp = torch.from_numpy(r.standard_normal((2, len(NAMES), H, W)).astype(np.float32))
    zen = torch.from_numpy(r.standard_normal((2, 2, 1, H, W)).astype(np.float32))
    x, t, unp = prepare_ensemble_batch(noise, inp, inp[:, :3], zen, E, 2, torch.Generator().manual_seed(0), centered=True)
    assert x.shape == (2 * E, len(NAMES), H, W) and torch.equal(x[E + 1], inp[1]) and torch.equal(fold_ensemble(x, E)[1, 2], inp[1])
    assert torch.equal(expand_ensemble(inp, E), x) and t.shape == (2, 3, H, W)
    assert unp.shape == (2 * E, 2, 1 + NOISE, H, W)
    assert torch.equal(unp[:, :, :1], zen.repeat_interleave(E, dim=0))
    assert torch.equal(unp[1::2, :, 1:], -unp[0::2, :, 1:])
    assert not torch.equal(unp[0, :, 1:], unp[2, :, 1:]) and not torch.equal(unp[:, 0, 1:], unp[:, 1, 1:])
    with pytest.raises(ValueError, match="even"):
        prepare_ensemble_batch(noise, inp, inp, zen, 3, 1, torch.Generator().manual_seed(0), centered=True)


def test_ensemble_step_imports_no_jax():
    """An FCN3 ensemble-CRPS step (get_model, LossHandler, get_optimizer,
    prepare_ensemble_batch, ensemble_train_step) runs without jax, flax or
    makani_tpu entering the process."""
    code = (
        "import sys, torch\n"
        "from makani_torch.models.model_registry import get_model\n"
        "from makani_torch.models.noise import build_noise\n"
        "from makani_torch.utils.loss import LossHandler\n"
        "from makani_torch.utils.training.ensemble_trainer import ensemble_train_step, prepare_ensemble_batch\n"
        "from makani_torch.utils.training.optimizer import get_optimizer\n"
        "from makani_torch.utils.yparams import ParamsBase\n"
        "names = ['t2m', 'u500', 'q500']\n"
        "p = ParamsBase(dict(nettype='FCN3', img_shape_x=17, img_shape_y=32, scale_factor=2, channel_names=names, in_channels=[0, 1, 2], out_channels=[0, 1, 2], "
        "atmo_embed_dim=4, surf_embed_dim=4, aux_embed_dim=2, num_layers=2, sfno_block_frequency=2, filter_basis_type='morlet th', clamp_water=True, "
        "add_zenith=True, checkpointing_level=3, input_noise=dict(type='diffusion', mode='concatenate', n_channels=2, centered=True, sigma=1.0, lambd=1.0), "
        "losses=[{'type': 'crps', 'parameters': {'crps_type': 'skillspread'}}], optimizer_nu_factored=True, optimizer_mu_dtype='bfloat16'))\n"
        "m, _ = get_model(p, multistep=True, device='cpu')\n"
        "noise = build_noise(dict(p.input_noise, grid_type='equiangular'), (17, 32), num_time_steps=1)\n"
        "inp, tar, unp = prepare_ensemble_batch(noise, torch.randn(1, 3, 17, 32), torch.randn(1, 3, 17, 32), torch.randn(1, 1, 1, 17, 32), 4, 1, torch.Generator().manual_seed(0), centered=True)\n"
        "loss = ensemble_train_step(m, LossHandler(p), get_optimizer(p, m), inp, tar, unp, 4, fold_chunk=2)\n"
        "assert torch.isfinite(loss)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'makani_tpu'))\n"
        "assert not bad, bad\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
