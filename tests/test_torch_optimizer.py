"""makani_torch's ``AdamFactored`` (K11's plain route on the CPU) against
makani_tpu's ``scale_by_adam_factored`` chained with
``scale_by_learning_rate``, and ``opt_state_from_jax``.

Both optimizers take the same seeded numpy gradient sequence for 3 steps,
with mu in bf16 and in fp32, over leaves factored (a dhconv-shaped 5-D
weight, a 2-D one whose factored axes come in the other order, d0 > d1, and
a 3-D one) and unfactored (a vector, a small kernel). Tolerances: parameters
and second-moment state within 1e-6 of the leaf's max|ref| (fp32 sums in
different orders); mu elementwise within one ulp of its dtype at the
reference's magnitude. XLA contracts the mu update into a fused multiply-add
whose operand order follows mu's dtype (fma(b1, mu, (1 - b1) g) for an fp32
mu, fma(1 - b1, g, b1 mu) for a bf16 one, checked on the CPU); the port
always takes the first, so a bf16 mu may round one ulp apart where the two
land on either side of a bf16 rounding boundary (a few in 10^5 entries a
step). With a bf16 mu each parameter may therefore also differ by 2**-7 of
the sum of its steps' updates (one ulp of mu_hat a step), beside the 1e-6.
The JAX side is jitted.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from makani_tpu.utils.training.optimizer import _factored_dims as jfactored_dims
from makani_tpu.utils.training.optimizer import scale_by_adam_factored

from makani_torch.convert_jax import opt_state_from_jax
from makani_torch.utils.training.optimizer import AdamFactored, _factored_dims, get_optimizer
from makani_torch.utils.yparams import ParamsBase

SHAPES = {"dhconv": (1, 130, 132, 6, 2), "flip": (140, 129), "mlp": (1, 128, 200), "bias": (7,), "small": (1, 20, 30)}
LR = 1e-2


class _Leaves(torch.nn.Module):
    def __init__(self, values):
        super().__init__()
        for name, v in values.items():
            self.register_parameter(name, torch.nn.Parameter(torch.from_numpy(v.copy())))


def _init(seed=0):
    r = np.random.default_rng(seed)
    return {k: r.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(step):
    r = np.random.default_rng(100 + step)
    return {k: (r.standard_normal(s) * (1 + i)).astype(np.float32) for i, (k, s) in enumerate(SHAPES.items())}


def _jax_run(params, mu_dtype, steps, first=0):
    """The JAX optimizer's steps first..first+steps-1 from params (and a
    fresh state); returns the parameters, the state and, per leaf, the sum
    of the steps' |update|."""
    tx = optax.chain(scale_by_adam_factored(mu_dtype=mu_dtype), optax.scale_by_learning_rate(LR))
    p = jax.tree.map(jnp.asarray, params)
    s = tx.init(p)

    @jax.jit
    def step(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    moved = {k: np.zeros(v.shape, np.float64) for k, v in params.items()}
    for k in range(first, first + steps):
        q, s = step(p, s, jax.tree.map(jnp.asarray, _grads(k)))
        for name in moved:
            moved[name] += np.abs(np.asarray(q[name], np.float64) - np.asarray(p[name], np.float64))
        p = q
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s), moved


def _torch_run(module, opt, steps, first=0):
    for k in range(first, first + steps):
        g = _grads(k)
        for name, p in module.named_parameters():
            p.grad = torch.from_numpy(g[name])
        opt.step()
        opt.zero_grad(set_to_none=True)


def _close(out, ref, tol=1e-6, extra=0.0):
    """max|out - ref| within tol of max|ref|, plus ``extra`` elementwise."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.all(np.abs(out - ref) <= tol * max(np.max(np.abs(ref)), 1e-30) + extra)


def _within_ulp(out, ref, bits):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - bits)
    assert np.all(np.abs(out - ref) <= ulp)


def test_factored_dims_match_jax():
    for shape in list(SHAPES.values()) + [(1, 384, 384, 120, 2), (1, 768, 384), (384,), (2, 200, 200)]:
        assert _factored_dims(shape, 128) == jfactored_dims(shape, 128)
    # numpy's argsort on the tie 384 = 384: d0 the earlier axis
    assert _factored_dims((1, 384, 384, 120, 2), 128) == (1, 2)


@pytest.mark.parametrize("mu_dtype", ["bfloat16", "float32"])
def test_adam_factored_matches_jax(mu_dtype):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if mu_dtype == "bfloat16" else (None, torch.float32)
    init = _init()
    ref_p, ref_s, moved = _jax_run(init, jdt, 3)
    module = _Leaves(init)
    opt = AdamFactored(module.parameters(), lr=LR, mu_dtype=tdt)
    _torch_run(module, opt, 3)
    factored = {k for k, s in SHAPES.items() if _factored_dims(s, 128) is not None}
    assert factored == {"dhconv", "flip", "mlp"}
    st = ref_s[0]
    assert int(st.count) == 3
    for name, p in module.named_parameters():
        _close(p.detach().numpy(), ref_p[name], extra=2.0**-7 * moved[name] if mu_dtype == "bfloat16" else 0.0)
        state = opt.state[p]
        assert int(state["count"]) == 3 and state["mu"].dtype == tdt
        _within_ulp(state["mu"].float().numpy(), np.asarray(st.mu[name], np.float32), 7 if mu_dtype == "bfloat16" else 23)
        for key in ("v_row", "v_col", "v"):
            ref = np.asarray(getattr(st.nu[name], key))
            assert tuple(state[key].shape) == ref.shape, (name, key)
            if ref.size:
                _close(state[key].numpy(), ref)


def test_opt_state_from_jax_round_trips():
    """The JAX state after 3 steps, carried over, equals the JAX arrays, and
    a 4th step from it in each package agrees."""
    init = _init(1)
    p3, s3, _ = _jax_run(init, jnp.bfloat16, 3)
    module = _Leaves(p3)
    opt = AdamFactored(module.parameters(), lr=LR, mu_dtype=torch.bfloat16)
    opt.load_state_dict(opt_state_from_jax(s3, module, opt))
    st = s3[0]
    for name, p in module.named_parameters():
        state = opt.state[p]
        assert state["count"].dtype == torch.int32 and int(state["count"]) == 3
        assert state["mu"].dtype == torch.bfloat16
        np.testing.assert_array_equal(state["mu"].float().numpy(), np.asarray(st.mu[name], np.float32))
        for key in ("v_row", "v_col", "v"):
            np.testing.assert_array_equal(state[key].numpy(), np.asarray(getattr(st.nu[name], key)))
    _torch_run(module, opt, 1, first=3)
    p4, _, _ = _jax_run(init, jnp.bfloat16, 4)
    for name, p in module.named_parameters():
        # the 4th step's update, to one ulp of its bf16 mu
        _close(p.detach().numpy(), p4[name], extra=2.0**-7 * np.abs(p4[name].astype(np.float64) - p3[name]))


def test_get_optimizer_covers_the_bench_config():
    """The bench's factored Adam, and the published recipes' optimizers
    (plain Adam with clipping and the cosine schedule; the FCN3 finetune
    stage's frozen encoders): built, not refused; the optimizer types that
    are not ported yet raise, naming the type."""
    from makani_torch.utils.training.optimizer import Adam
    from makani_torch.utils.yparams import YParams

    params = ParamsBase(dict(optimizer_type="Adam", optimizer_nu_factored=True, optimizer_mu_dtype="bfloat16", scheduler="none", lr=1e-3))
    opt = get_optimizer(params, _Leaves(_init()))
    assert isinstance(opt, AdamFactored) and opt.mu_dtype == torch.bfloat16 and math.isclose(opt.param_groups[0]["lr"], 1e-3)
    assert opt.max_grad_norm is None and opt.accumulation_steps == 1 and opt.schedule(5) == np.float32(1e-3)
    for path, name, max_norm, lr in (("config/sfnonet.yaml", "sfno_linear_73chq_sc3_layers8_edim384", 32, 1e-3),
                                     ("config/fourcastnet3.yaml", "base_config", 1.0, 5e-4),
                                     ("config/fourcastnet3.yaml", "fcn3_sc2_edim45_layers10_finetune", 1.0, 5e-4)):
        recipe = YParams(path, name)
        opt = get_optimizer(recipe, _Leaves(_init()), steps_per_epoch=2)
        assert isinstance(opt, Adam) and opt.mu_dtype == torch.float32 and opt.max_grad_norm == max_norm
        assert opt.schedule(0) == np.float32(lr) and opt.schedule(1) < opt.schedule(0)
        assert [g.get("frozen", False) for g in opt.param_groups] == [False]  # no encoder among these leaves' names
    for over, name in ((dict(optimizer_type="SGD"), "SGD"), (dict(optimizer_type="Muon"), "Muon"), (dict(optimizer_type="Shampoo"), "Shampoo"),
                       (dict(optimizer_type="SIRFShampoo"), "SIRFShampoo")):
        with pytest.raises(NotImplementedError, match=name):
            get_optimizer(ParamsBase(dict(params.to_dict(), **over)), _Leaves(_init()))


# a factored leaf, a factored leaf with d0 > d1 and an unfactored one; one
# of the first and the last sits out step 1 (no gradient in the port, a zero
# gradient in the reference, which updates every leaf under one count)
UNUSED_SHAPES = {"dhconv": (1, 130, 132, 3, 2), "flip": (140, 129), "bias": (7,)}


def _unused_grads(step, unused):
    r = np.random.default_rng(200 + step)
    g = {k: (r.standard_normal(s) * (1 + i)).astype(np.float32) for i, (k, s) in enumerate(UNUSED_SHAPES.items())}
    if step == 0:
        g[unused] = None
    return g


@pytest.mark.parametrize("unused", ["dhconv", "bias"])
@pytest.mark.parametrize("mu_dtype", ["bfloat16", "float32"])
def test_adam_factored_matches_jax_with_a_parameter_unused(mu_dtype, unused):
    """Two steps with one parameter unused in the first: the port advances
    one count for the group and updates the unused parameter as the
    reference does a zero gradient, so step 2's bias corrections are
    count 2's for every leaf."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if mu_dtype == "bfloat16" else (None, torch.float32)
    r = np.random.default_rng(3)
    init = {k: r.standard_normal(s).astype(np.float32) for k, s in UNUSED_SHAPES.items()}
    tx = optax.chain(scale_by_adam_factored(mu_dtype=jdt), optax.scale_by_learning_rate(LR))
    p = jax.tree.map(jnp.asarray, init)
    s = tx.init(p)
    step = jax.jit(lambda p, s, g: (lambda u, s: (optax.apply_updates(p, u), s))(*tx.update(g, s, p)))
    module = _Leaves(init)
    opt = AdamFactored(module.parameters(), lr=LR, mu_dtype=tdt)
    moved = {k: np.zeros(v.shape) for k, v in init.items()}
    for k in range(2):
        g = _unused_grads(k, unused)
        q, s = step(p, s, {n: jnp.zeros(UNUSED_SHAPES[n], jnp.float32) if v is None else jnp.asarray(v) for n, v in g.items()})
        for n in moved:
            moved[n] += np.abs(np.asarray(q[n], np.float64) - np.asarray(p[n], np.float64))
        p = q
        for n, param in module.named_parameters():
            param.grad = None if g[n] is None else torch.from_numpy(g[n])
        opt.step()
    assert int(s[0].count) == 2
    for n, param in module.named_parameters():
        assert int(opt.state[param]["count"]) == 2
        _close(param.detach().numpy(), np.asarray(p[n]), extra=2.0**-7 * moved[n] if mu_dtype == "bfloat16" else 0.0)
