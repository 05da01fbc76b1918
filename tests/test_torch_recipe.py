"""The recipes' training chain in makani_torch against makani_tpu's: the
learning-rate schedules, plain Adam with global-norm clipping, AdamW's
decay mask, the freeze flags, gradient accumulation, ``opt_state_from_jax``
for those chains, ``get_time_diff_stds`` and ``temp_diff_normalization``,
and two training steps of a tiny SFNO under the SFNO recipe's loss and
optimizer (``config/sfnonet.yaml``).

The optimizer cases run both packages' ``get_optimizer`` on one config over
a small tree of mixed-rank leaves named like FCN3's (encoders, decoders,
blocks, norms, layer scales, biases), with the same seeded numpy gradients
for 3 steps (4 calls under accumulation), the JAX side jitted. Tolerances,
as ``test_adam_factored_matches_jax``'s: parameters and nu within 1e-6 of
the leaf's max|ref|, mu within one ulp of its dtype at the reference's
magnitude, but for an fp32 mu where the clip scales g, by a norm whose
sums run in another order (within 1e-6 of the reference's): there mu within
1e-6 of the leaf's max|ref|; the schedules within fp32 relative 1e-6. The port computes optax's order with the roundings XLA
compiles on the CPU: mu' = fma(1 - b1, g, b1 mu) in fp32 with b1 in bf16
where mu is bf16 (checked below against the reference's arithmetic), nu' =
fma(b2, nu, (1 - b2) g^2), u = mu' / (c1 (sqrt(nu' / c2) + eps)).

The whole-slice step: the recipe ``sfno_linear_73chq_sc3_layers8_edim384``
at 33x64 (scale 2, embed 16, 2 blocks, five of its channels, two of them
min-max normalized), fp32 compute, batch 2, with its ``l2`` squared loss,
``auto`` channel weights and ``temp_diff_normalization`` over stats files
written to ``tmp_path``, and its optimizer (Adam, b2 0.95, clipping at 32,
the cosine schedule at lr 1e-3 over 2 steps an epoch), two steps in each
package from the same weights: losses within 1e-5 relative; parameters
within 1e-3 lr where |g| of either step exceeds 1e-3 of the leaf's max (the
train-step test's fp32 gates), the MLP's second bias (a zero gradient in
exact arithmetic in front of the instance norm) excepted.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from makani_tpu.models.model_registry import get_model as jget_model
from makani_tpu.utils.dataloaders.data_helpers import get_time_diff_stds as jget_time_diff_stds
from makani_tpu.utils.loss import LossHandler as JLossHandler
from makani_tpu.utils.training.optimizer import _no_decay_mask, get_optimizer as jget_optimizer, get_schedule as jget_schedule
from makani_tpu.utils.yparams import ParamsBase as JParamsBase

from makani_torch.convert_jax import load_from_jax, opt_state_from_jax, params_from_jax
from makani_torch.models.model_registry import get_model
from makani_torch.utils.dataloaders.data_helpers import get_time_diff_stds
from makani_torch.utils.loss import LossHandler
from makani_torch.utils.training.deterministic_trainer import train_step
from makani_torch.utils.training.optimizer import Adam, decay_mask, get_optimizer, get_schedule
from makani_torch.utils.yparams import ParamsBase, YParams
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCHEDULES = {
    "cosine": dict(scheduler="CosineAnnealingLR", scheduler_T_max=10),
    "cosine-min-lr": dict(scheduler="CosineAnnealingLR", scheduler_T_max=4, scheduler_min_lr=1e-4),
    "step": dict(scheduler="StepLR", scheduler_step_size=3, scheduler_gamma=0.5),
    "constant": dict(scheduler="none"),
    "warmup-cosine": dict(scheduler="CosineAnnealingLR", scheduler_T_max=5, lr_warmup_steps=3),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedule_matches_jax(case):
    cfg = dict(lr=5e-4, **SCHEDULES[case])
    port, ref = get_schedule(cfg, 2), jax.jit(jget_schedule(cfg, 2))
    for count in range(13):
        r = float(np.asarray(ref(jnp.asarray(count, jnp.int32)), np.float32))
        assert abs(port(count) - r) <= 1e-6 * abs(r) + 1e-12, (count, port(count), r)


# a tree named like FCN3's: frozen by freeze_encoder are the encoders,
# decoders and the residual transform; not decayed are biases, norms, layer
# scales and the 1-D leaves
TREE = {
    "atmo_encoder": {"conv": {"weight": (3, 4, 5, 6), "bias": (4,)}},
    "block0": {"global_conv": {"weight": (1, 8, 8, 5, 2)}, "norm": {"weight": (8,)}},
    "block1": {"layer_scale": {"gamma": (8,)}, "mlp": {"fc1": {"weight": (16, 8)}, "fc2": {"bias": (8,)}}},
    "surf_decoder": {"conv": {"weight": (2, 3, 4)}},
    "residual_transform": {"weight": (6, 6)},
}
BASE = dict(lr=1e-2, optimizer_type="Adam", optimizer_beta2=0.95, scheduler="CosineAnnealingLR", scheduler_T_max=4, optimizer_max_grad_norm=1.0)
CASES = {
    "clip": {},
    "no-clip": dict(optimizer_max_grad_norm=1e4),
    "adamw": dict(optimizer_type="AdamW", weight_decay=0.1),
    "freeze-encoder": dict(freeze_encoder=True),
    "accumulate-2": dict(grad_accumulation_steps=2),
}


def _walk(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _walk(v, name)
        else:
            yield name, v


def _tree_values(fn, tree=TREE):
    return {k: _tree_values(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


class _Tree(torch.nn.Module):
    """A module whose parameters carry the tree's dotted names."""

    def __init__(self, values):
        super().__init__()
        for k, v in values.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(np.array(v))))


def _tree_init(seed=0):
    r = np.random.default_rng(seed)
    return _tree_values(lambda s: r.standard_normal(s).astype(np.float32))


def _tree_grads(step):
    r = np.random.default_rng(100 + step)
    return _tree_values(lambda s: (r.standard_normal(s) * (1 + step)).astype(np.float32))


def _set_grads(module, grads):
    flat = dict(_walk(grads))
    for n, p in module.named_parameters():
        p.grad = torch.from_numpy(flat[n].copy())


def _jax_steps(cfg, params, first, steps, state=None):
    tx, _ = jget_optimizer(cfg, {"params": params})
    p = jax.tree.map(jnp.asarray, {"params": params})
    s = tx.init(p) if state is None else state

    @jax.jit
    def step(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    for k in range(first, first + steps):
        p, s = step(p, s, jax.tree.map(jnp.asarray, {"params": _tree_grads(k)}))
    return jax.tree.map(np.asarray, p)["params"], jax.tree.map(np.asarray, s)


def _close(out, ref, tol=1e-6):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.all(np.abs(out - ref) <= tol * max(np.max(np.abs(ref)), 1e-30))


def _within_ulp(out, ref, bits):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - bits)
    assert np.all(np.abs(out - ref) <= ulp)


def _adam_state(s):
    return [x for x in jax.tree.leaves(s, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)) if isinstance(x, optax.ScaleByAdamState)][0]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adam_matches_optax(case, mu_dtype):
    cfg = dict(BASE, optimizer_mu_dtype=mu_dtype, **CASES[case])
    calls = 4 if case == "accumulate-2" else 3
    init = _tree_init()
    ref_p, ref_s = _jax_steps(cfg, init, 0, calls)
    module = _Tree(init)
    opt = get_optimizer(cfg, module)
    assert isinstance(opt, Adam) and opt.mu_dtype == getattr(torch, mu_dtype)
    norms = []
    for k in range(calls):
        _set_grads(module, _tree_grads(k))
        opt.step()
        opt.zero_grad(set_to_none=True)
        norms.append(opt.last_grad_norm)
    st = _adam_state(ref_s)
    applied = calls // 2 if case == "accumulate-2" else calls
    assert int(st.count) == applied
    ref_mu, ref_nu = dict(_walk(st.mu["params"])), dict(_walk(st.nu["params"]))
    ref_flat, init_flat = dict(_walk(ref_p)), dict(_walk(init))
    frozen = {n for n, _ in _walk(TREE) if case == "freeze-encoder" and n.split(".")[0] in ("atmo_encoder", "surf_decoder", "residual_transform")}
    for name, p in module.named_parameters():
        _close(p.detach().numpy(), ref_flat[name])
        if name in frozen:
            assert np.array_equal(p.detach().numpy(), init_flat[name]) and not opt.state[p], name
            continue
        state = opt.state[p]
        assert int(state["count"]) == applied
        mu, mu_ref = state["mu"].float().numpy(), np.asarray(ref_mu[name], np.float32)
        if case == "no-clip" or mu_dtype == "bfloat16":
            _within_ulp(mu, mu_ref, 7 if mu_dtype == "bfloat16" else 23)
        else:
            # the clip scales g by a norm whose sums run in another order
            _close(mu, mu_ref)
        _close(state["v"].numpy(), ref_nu[name])
    # the clip's norm counts the trainable leaves only, at the last applied step
    last = calls - 1
    g = [v for n, v in _walk(_tree_grads(last)) if n not in frozen]
    if case == "accumulate-2":
        g = [(a + b) / 2 for a, b in zip([v for n, v in _walk(_tree_grads(last - 1)) if n not in frozen], g)]
    ref_norm = float(optax.global_norm([jnp.asarray(x) for x in g]))
    assert abs(float(norms[-1]) - ref_norm) <= 1e-6 * ref_norm
    assert (ref_norm < cfg["optimizer_max_grad_norm"]) == (case == "no-clip")
    if case == "adamw":
        jmask = dict(_walk(_no_decay_mask({"params": init})["params"]))
        assert decay_mask((n, p.shape) for n, p in module.named_parameters()) == jmask
        assert sum(jmask.values()) == 5 and len(opt.param_groups) == 2


def test_bf16_mu_takes_b1_in_bf16():
    """With a bf16 mu the JAX package multiplies the weakly typed b1 into mu
    as a bf16 number (0.9 -> 0.8984375): one step's mu in JAX is the port's
    formula with that b1, not with b1 in fp32."""
    r = np.random.default_rng(4)
    g = r.standard_normal(4096).astype(np.float32)
    mu = jnp.asarray(r.standard_normal(4096) * 0.3, jnp.bfloat16)
    ref = np.asarray(jax.jit(lambda g, m: optax.tree.update_moment(g, m, 0.9, 1))(jnp.asarray(g), mu), np.float64)
    m = np.asarray(mu, np.float64)
    b1_bf16 = float(jnp.asarray(0.9, jnp.bfloat16))
    assert b1_bf16 == 0.8984375
    fma = lambda b1: (np.float32(0.1) * g.astype(np.float64) + (np.float32(b1) * m.astype(np.float32)).astype(np.float64)).astype(np.float32)
    assert np.array_equal(fma(b1_bf16), ref) and not np.array_equal(fma(0.9), ref)


ROUND_TRIP = {
    "adam": dict(optimizer_mu_dtype="bfloat16"),
    "multi-steps": dict(grad_accumulation_steps=2),
    "freeze": dict(freeze_encoder=True, optimizer_type="AdamW", weight_decay=0.1),
}


@pytest.mark.parametrize("case", list(ROUND_TRIP))
def test_opt_state_from_jax_continues_training(case):
    """A JAX run's state after its steps, carried over, and one more step in
    both packages from there: the same parameters (for multi-steps, 3 calls:
    the state mid-accumulation, then the call that applies)."""
    cfg = dict(BASE, **ROUND_TRIP[case])
    init = _tree_init(1)
    first = 3 if case == "multi-steps" else 2
    p_mid, s_mid = _jax_steps(cfg, init, 0, first)
    module = _Tree(p_mid)
    opt = get_optimizer(cfg, module)
    opt.load_state_dict(opt_state_from_jax(s_mid, module, opt))
    st = _adam_state(s_mid)
    ref_mu = dict(_walk(st.mu["params"]))
    for name, p in module.named_parameters():
        state = opt.state[p]
        if not state:
            assert case == "freeze" and name.split(".")[0] in ("atmo_encoder", "surf_decoder", "residual_transform")
            continue
        assert state["count"].dtype == torch.int32 and int(state["count"]) == int(st.count)
        np.testing.assert_array_equal(state["mu"].float().numpy(), np.asarray(ref_mu[name], np.float32))
        if case == "multi-steps":
            assert int(state["mini_step"]) == 1 and state["acc"].abs().max() > 0
    _set_grads(module, _tree_grads(first))
    opt.step()
    p_end, _ = _jax_steps(cfg, p_mid, first, 1, state=jax.tree.map(jnp.asarray, s_mid))
    ref = dict(_walk(p_end))
    for name, p in module.named_parameters():
        _close(p.detach().numpy(), ref[name])
        if case == "multi-steps":
            assert not np.array_equal(p.detach().numpy(), dict(_walk(p_mid))[name]), name


def _stats(tmp_path, n, dt_axis=False):
    r = np.random.default_rng(11)
    mins = r.uniform(-2.0, -1.0, (1, n, 1, 1))
    files = {
        "min_path": mins,
        "max_path": mins + r.uniform(1.0, 3.0, (1, n, 1, 1)),
        "global_means_path": r.standard_normal((1, n, 1, 1)),
        "global_stds_path": r.uniform(0.5, 2.0, (1, n, 1, 1)),
        "time_diff_stds_path": r.uniform(0.05, 0.2, (2, 1, n, 1, 1) if dt_axis else (1, n, 1, 1)),
    }
    out = {}
    for key, value in files.items():
        path = tmp_path / f"{key}.npy"
        np.save(path, value.astype(np.float64))
        out[key] = str(path)
    return out


def test_get_time_diff_stds_matches_jax(tmp_path):
    names = ["u10m", "t2m", "q500"]
    for cfg in (dict(channel_names=names), dict(channel_names=names, dt=2, **_stats(tmp_path, 3, dt_axis=True)), dict(channel_names=names, **_stats(tmp_path, 3))):
        out, ref = get_time_diff_stds(cfg), jget_time_diff_stds(cfg)
        assert out.dtype == np.float32 and out.shape == ref.shape and np.array_equal(out, ref)
    assert np.array_equal(get_time_diff_stds(dict(channel_names=names)), np.ones((1, 3, 1, 1), np.float32))


@pytest.mark.parametrize("weights", ["auto", "list"])
def test_temp_diff_normalization_matches_jax(tmp_path, weights):
    """The channel weights of an l2 and a CRPS loss with
    ``temp_diff_normalization`` over a dataset of five channels of which the
    loss sees four, reordered, one of them min-max normalized."""
    names = ["u10m", "t2m", "z500", "q500", "tcwv"]
    cw = "auto" if weights == "auto" else [0.5, 1.0, 2.0, 0.25]
    cfg = dict(
        channel_names=names, in_channels=[0, 1, 2, 3, 4], out_channels=[3, 0, 2, 1], normalization={"q500": "minmax"},
        img_shape_x=9, img_shape_y=16, **_stats(tmp_path, 5),
        losses=[{"type": "l2", "channel_weights": cw, "temp_diff_normalization": True},
                {"type": "crps", "channel_weights": cw, "temp_diff_normalization": True, "relative_weight": 0.5, "parameters": {"crps_type": "skillspread"}}],
    )
    out = LossHandler(ParamsBase(copy.deepcopy(cfg))).channel_weights
    ref = JLossHandler(JParamsBase(copy.deepcopy(cfg))).channel_weights
    assert out.dtype == np.float32 and out.shape == (1, 8)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    plain = dict(cfg, losses=[dict(loss, temp_diff_normalization=False) for loss in cfg["losses"]])
    assert not np.allclose(out, LossHandler(ParamsBase(plain)).channel_weights)


RECIPE_NAMES = ["u10m", "t2m", "z500", "q500", "tcwv"]
RH, RW, RB = 33, 64, 2


def _recipe(tmp_path):
    cfg = YParams("config/sfnonet.yaml", "sfno_linear_73chq_sc3_layers8_edim384").to_dict()
    cfg.update(img_shape_x=RH, img_shape_y=RW, scale_factor=2, embed_dim=16, num_layers=2, channel_names=RECIPE_NAMES,
               in_channels=list(range(5)), out_channels=list(range(5)), compute_dtype="float32", **_stats(tmp_path, 5))
    assert cfg["losses"][0]["temp_diff_normalization"] and cfg["losses"][0]["channel_weights"] == "auto"
    assert (cfg["optimizer_max_grad_norm"], cfg["optimizer_beta2"], cfg["scheduler"]) == (32, 0.95, "CosineAnnealingLR")
    return cfg


def test_recipe_sfno_two_steps_match_jax(tmp_path):
    cfg = _recipe(tmp_path)
    steps_per_epoch = cfg["n_train_samples_per_epoch"] // cfg["batch_size"]
    r = np.random.default_rng(3)
    batches = [(r.standard_normal((RB, 5, RH, RW)).astype(np.float32), r.standard_normal((RB, 5, RH, RW)).astype(np.float32),
                r.uniform(-1.0, 1.0, (RB, 1, 1, RH, RW)).astype(np.float32)) for _ in range(2)]
    jmodel, _ = jget_model(JParamsBase(copy.deepcopy(cfg)), multistep=True)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), *map(jnp.asarray, batches[0][0::2])))
    jloss = JLossHandler(JParamsBase(copy.deepcopy(cfg)))
    tx, _ = jget_optimizer(JParamsBase(copy.deepcopy(cfg)), variables, steps_per_epoch)

    @jax.jit
    def jstep(p, s, x, t, z):
        loss, grads = jax.value_and_grad(lambda q: jloss(jmodel.apply(q, x, z, train=True), t, inp=x, train=True))(p)
        updates, s = tx.update(grads, s, p)
        return loss, grads, optax.apply_updates(p, updates), s

    model, _ = get_model(ParamsBase(copy.deepcopy(cfg)), multistep=True, device="cpu")
    load_from_jax(model, variables)
    loss_obj = LossHandler(ParamsBase(copy.deepcopy(cfg)))
    opt = get_optimizer(ParamsBase(copy.deepcopy(cfg)), model, steps_per_epoch)
    p, s = variables, tx.init(variables)
    grads, lrs = [], []
    for x, t, z in batches:
        jl, jg, p, s = jstep(p, s, x, t, z)
        loss = train_step(model, loss_obj, opt, *map(torch.from_numpy, (x, t, z)))
        assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
        grads.append(params_from_jax(jax.tree.map(np.asarray, jg)))
        lrs.append(opt.last_lr)
    assert lrs == [get_schedule(cfg, steps_per_epoch)(k) for k in range(2)] and lrs[1] < lrs[0]
    ref = params_from_jax(jax.tree.map(np.asarray, p))
    lr = cfg["lr"]
    for name, q in model.named_parameters():
        if name.endswith("mlp.fc2.bias"):
            continue
        g = np.maximum(*(np.abs(gr[name].numpy()) / np.abs(gr[name].numpy()).max() for gr in grads))
        mask = g > 1e-3
        assert np.max(np.abs(q.detach().numpy() - ref[name].numpy())[mask]) <= 1e-3 * lr, name
