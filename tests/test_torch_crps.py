"""makani_torch's ensemble CRPS (skillspread) against makani_tpu's, on the CPU.

``crps_ensemble`` and ``CRPSLoss`` take the same seeded numpy forecasts and
observations in both packages; the port runs K15's autograd function
(``crps_skillspread``, whose CPU route is the plain forward and the plain
backward written out) and the plain forward under autograd
(``use_kernels=False``). Values and gradients are held to ``jax.grad``:
values within 1e-6 of max|ref| (fp32 sums over at most 5 members in another
order), gradients within 1e-6 of max|ref|. The ensembles include exactly
tied members and observations equal to a member, where the gradient rests
on the conventions the JAX package pins (``_abs_sym``'s 0 at a tie, the
stable sort's member order among tied members): there the gradients must
agree exactly up to that rounding. ``LossHandler`` scores (B, E, C, H, W)
predictions as the JAX handler does, with a CRPS term and an l2 term on
the ensemble mean, to 1e-6 relative.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from makani_tpu.utils.loss import LossHandler as JLossHandler
from makani_tpu.utils.losses.crps_loss import CRPSLoss as JCRPSLoss
from makani_tpu.utils.losses.crps_loss import crps_ensemble as jcrps_ensemble
from makani_tpu.utils.yparams import ParamsBase as JParamsBase

from makani_torch import kernels
from makani_torch.utils.loss import LossHandler
from makani_torch.utils.losses.crps_loss import CRPSLoss, crps_ensemble, crps_skillspread_grad_plain, crps_skillspread_plain
from makani_torch.utils.yparams import ParamsBase
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-6


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= tol * max(np.max(np.abs(ref)), 1e-30), np.max(np.abs(out - ref))


def _ensemble(E, n=64, seed=0):
    """(2, E, n) members and (2, n) observations with ties: members 0 and 1
    equal at the first 8 pixels, all members equal at the next 8, the
    observation equal to member E - 1 at the next 8, and both at once."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((2, E, n)).astype(np.float32)
    obs = rng.standard_normal((2, n)).astype(np.float32)
    if E > 1:
        f[:, 1, :8] = f[:, 0, :8]
    f[:, :, 8:16] = f[:, :1, 8:16]
    obs[:, 16:24] = f[:, E - 1, 16:24]
    f[:, :, 24:32] = f[:, :1, 24:32]
    obs[:, 24:32] = f[:, 0, 24:32]
    return f, obs


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("E", [1, 2, 4, 5])
def test_crps_value_and_gradient_match_jax(E, use_kernels):
    f, obs = _ensemble(E)
    g = np.random.default_rng(9).standard_normal(obs.shape).astype(np.float32)

    def jloss(fj):
        return jnp.sum(jcrps_ensemble(jnp.asarray(obs), fj, "skillspread", 1.0, ensemble_axis=1) * g)

    ref = jcrps_ensemble(jnp.asarray(obs), jnp.asarray(f), "skillspread", 1.0, ensemble_axis=1)
    ref_grad = jax.grad(jloss)(jnp.asarray(f))
    ft = torch.from_numpy(f).requires_grad_()
    kernels.reset_launch_counts()
    out = crps_ensemble(torch.from_numpy(obs), ft, "skillspread", 1.0, ensemble_axis=1, use_kernels=use_kernels)
    (out * torch.from_numpy(g)).sum().backward()
    assert not any(kernels.LAUNCHES.values())
    _close(out.detach(), ref)
    _close(ft.grad, ref_grad)


@pytest.mark.parametrize("alpha", [1.0, 0.95])
def test_crps_plain_gradient_is_the_autograd_of_the_plain_forward(alpha):
    """K15's written-out backward equals autograd through the sort, ties
    included (the rank of a tied member is its place in member order)."""
    f, obs = _ensemble(4, seed=1)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(obs.shape).astype(np.float32))
    ft = torch.from_numpy(f).requires_grad_()
    (crps_skillspread_plain(ft, torch.from_numpy(obs), alpha) * g).sum().backward()
    got = crps_skillspread_grad_plain(torch.from_numpy(f), torch.from_numpy(obs), g, alpha)
    _close(got, ft.grad, 1e-7)


def test_crps_ensemble_axis_last_and_unported_types():
    """The ensemble on the last axis (the JAX default) scores as on axis 1;
    the other crps_types raise, naming themselves."""
    f, obs = _ensemble(4, seed=3)
    ref = jcrps_ensemble(jnp.asarray(obs), jnp.asarray(np.moveaxis(f, 1, -1)), "skillspread")
    _close(crps_ensemble(torch.from_numpy(obs), torch.from_numpy(np.ascontiguousarray(np.moveaxis(f, 1, -1)))), ref)
    for t in ("cdf", "gauss", "probability weighted moment"):
        with pytest.raises(NotImplementedError, match=t):
            crps_ensemble(torch.from_numpy(obs), torch.from_numpy(f), t, ensemble_axis=1)
        with pytest.raises(NotImplementedError, match=t):
            CRPSLoss((4, 8), crps_type=t)


@pytest.mark.parametrize("grid", ["equiangular", "legendre-gauss"])
def test_crps_loss_matches_jax(grid):
    B, E, C, H, W = 2, 4, 3, 9, 16
    rng = np.random.default_rng(4)
    f = rng.standard_normal((B, E, C, H, W)).astype(np.float32)
    obs = rng.standard_normal((B, C, H, W)).astype(np.float32)
    f[:, 2, :, :2] = f[:, 1, :, :2]
    jl = JCRPSLoss((H, W), grid_type=grid)
    tl = CRPSLoss((H, W), grid_type=grid)

    def jfn(fj):
        return jnp.sum(jl(fj, jnp.asarray(obs)) * jnp.arange(1.0, 1.0 + B * C).reshape(B, C))

    ref, ref_grad = jax.value_and_grad(jfn)(jnp.asarray(f))
    ft = torch.from_numpy(f).requires_grad_()
    out = (tl(ft, torch.from_numpy(obs)) * torch.arange(1.0, 1.0 + B * C).reshape(B, C)).sum()
    out.backward()
    _close(out.detach(), ref)
    _close(ft.grad, ref_grad)


def test_loss_handler_scores_an_ensemble_as_jax():
    """A CRPS term on the members and an l2 term on their mean, each with
    its channel weights; the gradient with respect to every member."""
    names = ["u10m", "t2m", "z500"]
    cfg = dict(
        img_shape_x=9, img_shape_y=16, channel_names=names, in_channels=[0, 1, 2], out_channels=[0, 1, 2], n_future=0,
        losses=[{"type": "crps", "channel_weights": "constant", "parameters": {"crps_type": "skillspread"}},
                {"type": "l2", "channel_weights": [0.5, 1.0, 2.0], "relative_weight": 0.3}],
    )
    rng = np.random.default_rng(5)
    f = rng.standard_normal((2, 4, 3, 9, 16)).astype(np.float32)
    tar = rng.standard_normal((2, 3, 9, 16)).astype(np.float32)
    jh = JLossHandler(JParamsBase(copy.deepcopy(cfg)))
    th = LossHandler(ParamsBase(copy.deepcopy(cfg)))
    np.testing.assert_array_equal(th.channel_weights, jh.channel_weights)
    ref, ref_grad = jax.value_and_grad(lambda fj: jh(fj, jnp.asarray(tar), train=True))(jnp.asarray(f))
    ft = torch.from_numpy(f).requires_grad_()
    out = th(ft, torch.from_numpy(tar), train=True)
    out.backward()
    _close(out.detach(), ref)
    _close(ft.grad, ref_grad)
