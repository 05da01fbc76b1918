"""One SFNO training step in makani_torch against makani_tpu's.

A small SFNO (33x64, scale 2, 4 channels + zenith, embed 16, instance norm)
is built by both packages' ``get_model(multistep=True)`` from the same flax
weights (``load_from_jax``), and both take one step on the same seeded numpy
batch: the forward with ``train=True``, the l2 / constant / squared loss, the
gradients, and the factored Adam (``min_dim_size_to_factor`` 8, so that the
dhconv weights and 16x16 kernels factor) chained with the learning rate.
Three configurations, each built once per module: fp32 with ``n_future`` 0
(2 blocks) and with ``n_future`` 1 (1 block), mu in fp32; bf16 compute with
``n_future`` 0 (2 blocks) and a bf16 mu, the bench's recipe. (A bf16 mu
rounds 0.1 g to 8 bits: where the two packages' g straddle a rounding
boundary, the first update differs by 2**-8 of itself, so the fp32
configurations keep mu in fp32; tests/test_torch_optimizer.py holds the bf16
mu.)

Tolerances, fp32: loss 1e-5 relative; each gradient leaf 1e-4 of its
max|ref| (the JAX package takes its DFT as a matmul on the CPU, the port
``torch.fft``); parameters after the step within 1e-3 * lr, at the entries
where |g| > 1e-3 of the leaf's max|g| on the unfactored leaves (Adam's first
step there is sign(g), which flips where g ~ 0) and > 1e-4 on the factored
ones (where g is at rounding level, as at the dhconv weight's l = 0 in front
of an instance norm, which removes that mode, the update is the ratio of two
rounding errors). The MLP's second bias feeds the instance norm, which
removes any per-channel constant: its gradient is zero in exact arithmetic,
and both packages' are held to rounding level (1e-5 of the model's largest
gradient in fp32, 1e-2 in bf16, whose sums the JAX package takes in bf16),
with no update check. bf16: loss 2e-2 relative, gradients relative L2 5e-2,
except the 1-D leaves (biases and norm scales, sums of bf16 products over
(b, h, w)) at 1e-1: the JAX package sums them in bf16 (3.6% from the
float64 sum at 288 terms, tests/test_torch_grad.py; the worst such leaf here
is 6.1% from the port's fp32 sum, measured); the factored leaves' update
(p - p0) relative L2 1e-1 where |g| > 1e-2 of its max (it follows the
gradient), the unfactored leaves within 1e-2 * lr where |g| > 1e-1 of its
max (clear of the bf16 noise; the bf16 mu puts up to 2**-8 into each
package's unit first step).
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
from makani_tpu.utils.training.optimizer import scale_by_adam_factored
from makani_tpu.utils.yparams import ParamsBase

from makani_torch import kernels
from makani_torch.convert_jax import load_from_jax, opt_state_from_jax, params_from_jax
from makani_torch.models.model_registry import get_model
from makani_torch.utils.loss import LossHandler
from makani_torch.utils.training.deterministic_trainer import train_step
from makani_torch.utils.training.optimizer import AdamFactored, _factored_dims
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, W, C, B = 33, 64, 4, 2
LR = 1e-3
MIN_FACTOR = 8
CONFIGS = {
    "fp32": dict(compute_dtype="float32", n_future=0, num_layers=2),
    "fp32-nfuture1": dict(compute_dtype="float32", n_future=1, num_layers=1),
    "bf16": dict(compute_dtype="bfloat16", n_future=0, num_layers=2),
}


def _params(**over):
    base = dict(
        nettype="SFNO",
        img_shape_x=H,
        img_shape_y=W,
        scale_factor=2,
        embed_dim=16,
        operator_type="dhconv",
        normalization_layer="instance_norm",
        channel_names=[f"ch{i}" for i in range(C)],
        in_channels=list(range(C)),
        out_channels=list(range(C)),
        n_history=0,
        add_zenith=True,
        losses=[{"type": "l2", "channel_weights": "constant", "parameters": {"squared": True}}],
        lr=LR,
    )
    base.update(over)
    return ParamsBase(base)


def _variables(model, *args):
    """Flax variables as numpy (the init compiled as one program), with
    biases and norm scales drawn at random so that they count."""
    variables = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        name = path[-1].key
        if name == "bias":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "weight" and leaf.ndim == 1:
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.fixture(scope="module")
def jax_init():
    """The flax variables of a configuration, one JAX init a (depth,
    n_future): the fp32 and bf16 configurations share theirs (fp32
    parameters in both: the same tree and values)."""
    cache = {}

    def variables(params, jmodel, inp, zen):
        key = (params.num_layers, params.n_future)
        if key not in cache:
            cache[key] = _variables(jmodel, jnp.asarray(inp), jnp.asarray(zen))
        return cache[key]

    return variables


@pytest.fixture(scope="module", params=list(CONFIGS))
def step(request, jax_init):
    """Both packages' step on one configuration: loss, gradients and
    parameters after the step, by name, as numpy."""
    params = _params(**CONFIGS[request.param])
    nf = params.n_future
    r = np.random.default_rng(3)
    inp = r.standard_normal((B, C, H, W)).astype(np.float32)
    tar = r.standard_normal((B, C * (nf + 1), H, W)).astype(np.float32)
    zen = r.uniform(-1.0, 1.0, (B, 1 + nf, 1, H, W)).astype(np.float32)

    jmodel, _ = jget_model(copy.deepcopy(params), multistep=True)
    variables = jax_init(params, jmodel, inp, zen)
    jloss = JLossHandler(copy.deepcopy(params))
    bf16 = params.compute_dtype == "bfloat16"
    tx = optax.chain(scale_by_adam_factored(mu_dtype=jnp.bfloat16 if bf16 else None, min_dim_size_to_factor=MIN_FACTOR), optax.scale_by_learning_rate(LR))
    opt_state = tx.init(variables)

    @jax.jit
    def jstep(p, s, x, t, z):
        loss, grads = jax.value_and_grad(lambda q: jloss(jmodel.apply(q, x, z, train=True), t, inp=x, train=True))(p)
        updates, s = tx.update(grads, s, p)
        return loss, grads, optax.apply_updates(p, updates)

    jl, jg, jp = jax.tree.map(np.asarray, jstep(variables, opt_state, inp, tar, zen))

    model, _ = get_model(copy.deepcopy(params), multistep=True, device="cpu")
    load_from_jax(model, variables)
    twin = copy.deepcopy(model)
    loss_obj = LossHandler(copy.deepcopy(params))
    mu_dtype = torch.bfloat16 if bf16 else torch.float32
    opt = AdamFactored(model.parameters(), lr=LR, mu_dtype=mu_dtype, min_dim_size_to_factor=MIN_FACTOR)
    opt.load_state_dict(opt_state_from_jax(jax.tree.map(np.asarray, opt_state), model, opt))
    x, t, z = map(torch.from_numpy, (inp, tar, zen))
    kernels.reset_launch_counts()
    loss = loss_obj(model(x, z, train=True), t, inp=x, train=True)
    loss.backward()
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    opt.step()
    # train_step takes the same step
    twin_opt = AdamFactored(twin.parameters(), lr=LR, mu_dtype=mu_dtype, min_dim_size_to_factor=MIN_FACTOR)
    twin_loss = train_step(twin, loss_obj, twin_opt, x, t, z)
    assert not any(kernels.LAUNCHES.values())
    assert twin_loss.item() == loss.item() and all(p.grad is None for p in twin.parameters())
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), twin.parameters()))
    return dict(
        config=request.param,
        loss=(loss.item(), float(jl)),
        grads=(grads, params_from_jax(jg)),
        params=({n: p.detach().numpy() for n, p in model.named_parameters()}, params_from_jax(jp)),
        before=params_from_jax(variables),
    )


def test_step_loss_matches_jax(step):
    out, ref = step["loss"]
    tol = 2e-2 if step["config"] == "bf16" else 1e-5
    assert np.isfinite(out) and abs(out - ref) <= tol * abs(ref)


def _zero_in_exact_arithmetic(name):
    return name.endswith("mlp.fc2.bias")


def test_step_gradients_match_jax(step):
    grads, ref = step["grads"]
    assert set(grads) == set(ref)
    largest = max(np.abs(r.numpy()).max() for r in ref.values())
    for name, g in grads.items():
        r = ref[name].numpy()
        if _zero_in_exact_arithmetic(name):
            assert max(np.abs(g).max(), np.abs(r).max()) <= (1e-2 if step["config"] == "bf16" else 1e-5) * largest, name
        elif step["config"] == "bf16":
            assert np.linalg.norm(g - r) <= (1e-1 if g.ndim == 1 else 5e-2) * np.linalg.norm(r), name
        else:
            assert np.max(np.abs(g - r)) <= 1e-4 * np.max(np.abs(r)), name


def test_step_parameters_match_jax(step):
    params, ref = step["params"]
    grads, _ = step["grads"]
    bf16 = step["config"] == "bf16"
    factored = 0
    for name, p in params.items():
        r, before = ref[name].numpy(), step["before"][name].numpy()
        assert not np.array_equal(r, before), name
        if _zero_in_exact_arithmetic(name):
            continue
        g = np.abs(grads[name])
        if _factored_dims(p.shape, MIN_FACTOR) is not None:
            factored += 1
            if bf16:
                # the update follows the gradient: its relative L2
                m = g > 1e-2 * g.max()
                assert np.linalg.norm(((p - before) - (r - before))[m]) <= 1e-1 * np.linalg.norm((r - before)[m]), name
                continue
            mask = g > 1e-4 * g.max()
        else:
            # bf16: where the sign of g is clear of the gradients' bf16 noise
            mask = g > (1e-1 if bf16 else 1e-3) * g.max()
        assert np.max(np.abs(p - r)[mask]) <= (1e-2 if bf16 and not _factored_dims(p.shape, MIN_FACTOR) else 1e-3) * LR, name
    assert factored > 0


def test_rollout_checkpoint_and_push_forward():
    """The training rollout's options, in the port alone (n_future 2, one
    block): ``multistep_checkpoint`` recomputes the same forward (the same
    loss and gradients); ``push_forward`` keeps the forward and cuts the
    gradient through every step's input: the parameters' gradients are
    those of the steps run on detached inputs (each step's prediction fed
    on as a constant), and the input gets none."""
    r = np.random.default_rng(5)
    x = torch.from_numpy(r.standard_normal((B, C, H, W)).astype(np.float32))
    t = torch.from_numpy(r.standard_normal((B, 3 * C, H, W)).astype(np.float32))
    z = torch.from_numpy(r.uniform(-1.0, 1.0, (B, 3, 1, H, W)).astype(np.float32))
    runs = {}
    for push_forward, checkpoint in ((False, False), (False, True), (True, False)):
        params = _params(compute_dtype="float32", n_future=2, num_layers=1, embed_dim=8, multistep={"push_forward": push_forward}, multistep_checkpoint=checkpoint)
        model, _ = get_model(copy.deepcopy(params), multistep=True, device="cpu", seed=0)
        assert (model.push_forward, model.multistep_checkpoint) == (push_forward, checkpoint)
        loss_obj = LossHandler(copy.deepcopy(params))
        xi = x.clone().requires_grad_()
        pred = model(xi, z, train=True)
        assert pred.shape == t.shape
        loss = loss_obj(pred, t, inp=xi, train=True)
        loss.backward()
        runs[(push_forward, checkpoint)] = (loss.item(), xi.grad, {n: p.grad.clone() for n, p in model.named_parameters()})
        if push_forward:
            # the same steps by hand, each on the previous prediction detached
            model.zero_grad(set_to_none=True)
            preds, state = [], x
            for step in range(3):
                preds.append(model.model(model.preprocessor.append_unpredicted_features(state, z[:, step : step + 1])))
                state = preds[-1].detach()
            loss_obj(torch.cat(preds, dim=1), t, inp=x, train=True).backward()
            by_hand = {n: p.grad for n, p in model.named_parameters()}
    plain, ckpt, pushed = runs[(False, False)], runs[(False, True)], runs[(True, False)]
    assert ckpt[0] == plain[0] and pushed[0] == plain[0]
    assert pushed[1] is None and plain[1] is not None
    for n in plain[2]:
        torch.testing.assert_close(ckpt[2][n], plain[2][n], rtol=1e-6, atol=0)
        torch.testing.assert_close(pushed[2][n], by_hand[n], rtol=1e-6, atol=0)
    assert not all(torch.allclose(pushed[2][n], plain[2][n]) for n in plain[2])
