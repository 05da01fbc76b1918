"""makani_torch's loss path (``GridQuadrature``, ``GeometricLpLoss``,
``LossHandler``) against makani_tpu's.

The same seeded numpy predictions, targets and inputs go to both handlers:
the bench's l2 / constant / squared loss, with ``n_future`` 1 (multistep
weights) and with ``tendency`` and other registry entries and channel
weightings. Tolerance: relative 1e-6 on the scalar loss and its gradient
(fp32 sums in different orders). The JAX side is jitted.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from makani_tpu.utils.grids import GridQuadrature as JGridQuadrature
from makani_tpu.utils.loss import LossHandler as JLossHandler
from makani_tpu.utils.yparams import ParamsBase

from makani_torch.utils.grids import GridQuadrature
from makani_torch.utils.loss import LossHandler

NAMES = ["u10m", "t2m", "z500", "q700"]


def _params(**over):
    base = dict(
        img_shape_x=13,
        img_shape_y=24,
        channel_names=list(NAMES),
        in_channels=list(range(4)),
        out_channels=list(range(4)),
        n_future=0,
        losses=[{"type": "l2", "channel_weights": "constant", "parameters": {"squared": True}}],
    )
    base.update(over)
    return ParamsBase(base)


@pytest.mark.parametrize("rule", ["naive", "legendre-gauss", "clenshaw-curtiss", "weatherbench2", "uniform"])
def test_quadrature_matches_jax(rule):
    x = np.random.default_rng(0).standard_normal((2, 3, 13, 24)).astype(np.float32)
    jq, tq = JGridQuadrature(rule, (13, 24), normalize=True), GridQuadrature(rule, (13, 24), normalize=True)
    np.testing.assert_array_equal(tq.quad_weight, jq.quad_weight)
    np.testing.assert_allclose(tq(torch.from_numpy(x)).numpy(), np.asarray(jq(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    # channels-last and a padded latitude row (zero weight)
    xp = np.concatenate([x, np.full((2, 3, 1, 24), 1e3, np.float32)], axis=2).transpose(0, 2, 3, 1)
    np.testing.assert_allclose(tq(torch.from_numpy(xp), channels_last=True).numpy(), np.asarray(jq(jnp.asarray(xp), channels_last=True)), rtol=1e-6, atol=1e-7)


CASES = [
    dict(),
    dict(n_future=1),
    dict(n_future=1, multistep={"weight_type": "linear"}),
    dict(losses=[{"type": "l2", "channel_weights": "auto", "tendency": True}, {"type": "relative l2", "channel_weights": [1.0, 2.0, 0.5, 1.0], "relative_weight": 0.3}]),
    dict(losses=[{"type": "l1", "channel_weights": "pangu"}, {"type": "squared l2", "channel_weights": "new auto"}], model_grid_type="legendre-gauss"),
]


@pytest.mark.parametrize("over", CASES)
def test_loss_handler_matches_jax(over):
    params = _params(**over)
    nf = params.get("n_future", 0)
    r = np.random.default_rng(1)
    prd = r.standard_normal((2, 4 * (nf + 1), 13, 24)).astype(np.float32)
    tar = r.standard_normal((2, 4 * (nf + 1), 13, 24)).astype(np.float32)
    inp = r.standard_normal((2, 4, 13, 24)).astype(np.float32)

    jl = JLossHandler(copy.deepcopy(params))
    ref, ref_g = jax.jit(jax.value_and_grad(lambda p, t, i: jl(p, t, inp=i, train=True)))(jnp.asarray(prd), jnp.asarray(tar), jnp.asarray(inp))
    tl = LossHandler(copy.deepcopy(params))
    np.testing.assert_array_equal(tl.channel_weights, jl.channel_weights)
    np.testing.assert_array_equal(tl.multistep_weight, jl.multistep_weight)
    pt = torch.from_numpy(prd).requires_grad_()
    out = tl(pt, torch.from_numpy(tar), inp=torch.from_numpy(inp), train=True)
    out.backward()
    assert out.dim() == 0
    assert abs(out.item() - float(ref)) <= 1e-6 * abs(float(ref))
    ref_g = np.asarray(ref_g)
    assert np.max(np.abs(pt.grad.numpy() - ref_g)) <= 1e-6 * np.max(np.abs(ref_g))


@pytest.mark.parametrize(
    "over,name",
    [
        (dict(losses=[{"type": "crps", "parameters": {"crps_type": "cdf"}}]), "crps"),
        (dict(losses=[{"type": "spectral l2"}]), "spectral l2"),
        (dict(uncertainty_weighting=True), "uncertainty_weighting"),
        (dict(balanced_weighting=True), "balanced_weighting"),
        (dict(random_slice_loss=True), "random_slice_loss"),
        (dict(randomized_loss_weights=True), "randomized_loss_weights"),
    ],
)
def test_unported_loss_options_raise(over, name):
    with pytest.raises(NotImplementedError, match=name):
        LossHandler(_params(**over))
