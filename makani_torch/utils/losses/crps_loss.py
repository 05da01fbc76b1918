"""Ensemble CRPS (counterpart of ``crps_ensemble`` and ``CRPSLoss`` in
``makani_tpu/utils/losses/crps_loss.py``), in its ``skillspread`` form.

The fair CRPS through the sorted-rank spread identity,

    crps = mean_e |obs - f_e| - 0.5 * 2 mean_r (2r + 1 - E) fs_r (E - 1 + alpha) / (E (E - 1)),

fs the members sorted in ascending order, is kernel K15 (CUDA C++,
``csrc/crps.cu``), forward and backward, as one autograd function. Its
gradient takes each member's rank from a stable order (tied members rank in
member order, as the gradient of the JAX package's ``jnp.sort`` does) and
the symmetric subgradient of |x| (0 at x == 0, ``_abs_sym``). The plain
versions: ``crps_skillspread_plain`` (``torch.sort`` and autograd, the
JAX package's formulation) and ``crps_skillspread_grad_plain`` (the
gradient written out). The quadrature and the channel weights stay plain
PyTorch. The other ``crps_type``s and the all-to-all of the ensemble-parallel
mesh (``crps_ensemble_manual_a2a``) are not ported yet and raise.
"""

from __future__ import annotations

import torch

from makani_torch import kernels
from makani_torch.utils.losses.base_loss import GeometricBaseLoss, LossType

__all__ = ["CRPSLoss", "crps_ensemble", "crps_skillspread", "crps_skillspread_plain", "crps_skillspread_grad_plain", "crps_skillspread_grad"]

_MAX_MEMBERS = 16  # csrc/crps.cu MAX_E


def _abs_sym(x: torch.Tensor) -> torch.Tensor:
    """|x| with the symmetric subgradient, 0 at x == 0."""
    return x * torch.sign(x)


def crps_skillspread_plain(forecasts: torch.Tensor, obs: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Plain K15 forward: forecasts (B, E, N), obs (B, N) -> (B, N), as the
    JAX package writes ``_crps_skillspread`` (differentiable by autograd
    through the stable sort)."""
    E = forecasts.shape[1]
    fs = torch.sort(forecasts, dim=1, stable=True).values
    eskill = torch.mean(_abs_sym(obs[:, None] - fs), dim=1)
    if E == 1:
        return eskill
    ranks = torch.arange(1, E + 1, dtype=fs.dtype, device=fs.device)
    coeff = (2.0 * ranks - E - 1.0).view(1, E, 1)
    espread = 2.0 * torch.mean(coeff * fs, dim=1) * (E - 1.0 + alpha) / (E * (E - 1.0))
    return eskill - 0.5 * espread


def _ranks(forecasts: torch.Tensor) -> torch.Tensor:
    """Each member's rank along dim 1 in a stable ascending order."""
    order = torch.sort(forecasts, dim=1, stable=True).indices
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(forecasts.shape[1], device=order.device).view(1, -1, 1).expand_as(order))
    return ranks


def crps_skillspread_grad_plain(forecasts: torch.Tensor, obs: torch.Tensor, g: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Plain K15 backward: the gradient with respect to forecasts (B, E, N)
    of sum(g * crps), g (B, N): g * (sign(f_e - obs) / E - (2 rank_e + 1 - E)
    (E - 1 + alpha) / (E^2 (E - 1)))."""
    E = forecasts.shape[1]
    d = torch.sign(forecasts - obs[:, None]) / E
    if E > 1:
        coeff = 2.0 * _ranks(forecasts).to(forecasts.dtype) + 1.0 - E
        d = d - coeff * ((E - 1.0 + alpha) / (E * E * (E - 1.0)))
    return g[:, None] * d


def _check(forecasts, obs):
    if forecasts.dim() != 3 or obs.dim() != 2 or forecasts.shape[0] != obs.shape[0] or forecasts.shape[2] != obs.shape[1]:
        raise ValueError(f"crps: expected forecasts (B, E, N) and obs (B, N), got {tuple(forecasts.shape)} and {tuple(obs.shape)}")
    if not 1 <= forecasts.shape[1] <= _MAX_MEMBERS:
        raise ValueError(f"crps: the kernel takes 1 to {_MAX_MEMBERS} members, got {forecasts.shape[1]}")
    if forecasts.dtype != torch.float32 or obs.dtype != torch.float32:
        raise TypeError(f"crps: takes float32 forecasts and observations, got {forecasts.dtype}, {obs.dtype}")


def _launch(mode, forecasts, obs, g, out, alpha):
    B, E, N = forecasts.shape
    lib = kernels.library()
    with torch.cuda.device(forecasts.device):
        err = lib.mt_crps_skillspread(mode, forecasts.data_ptr(), obs.data_ptr(), 0 if g is None else g.data_ptr(), out.data_ptr(), B, E, N, float(alpha),
                                      kernels.stream_ptr(forecasts.device))
    kernels.check_launch(err, "crps")
    kernels.count_launch("crps")
    return out


def crps_skillspread_fwd(forecasts: torch.Tensor, obs: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """K15's forward on the card, the plain version on the CPU: forecasts
    (B, E, N), obs (B, N) -> (B, N)."""
    if kernels.takes_plain("crps", forecasts, obs):
        return crps_skillspread_plain(forecasts, obs, alpha)
    _check(forecasts, obs)
    forecasts, obs = forecasts.contiguous(), obs.contiguous()
    if obs.numel() == 0:
        return torch.empty_like(obs)
    return _launch(0, forecasts, obs, None, torch.empty_like(obs), alpha)


def crps_skillspread_grad(forecasts: torch.Tensor, obs: torch.Tensor, g: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """K15's backward on the card, the plain version on the CPU: the
    gradient (B, E, N) with respect to forecasts, for the incoming g (B, N)."""
    if kernels.takes_plain("crps", forecasts, obs, g):
        return crps_skillspread_grad_plain(forecasts, obs, g, alpha)
    _check(forecasts, obs)
    if g.shape != obs.shape or g.dtype != torch.float32:
        raise ValueError(f"crps: the gradient must be float32 {tuple(obs.shape)}, got {g.dtype} {tuple(g.shape)}")
    forecasts, obs, g = forecasts.contiguous(), obs.contiguous(), g.contiguous()
    if forecasts.numel() == 0:
        return torch.empty_like(forecasts)
    return _launch(1, forecasts, obs, g, torch.empty_like(forecasts), alpha)


class _CRPSSkillspread(torch.autograd.Function):
    @staticmethod
    def forward(ctx, forecasts, obs, alpha):
        ctx.save_for_backward(forecasts, obs)
        ctx.alpha = alpha
        return crps_skillspread_fwd(forecasts, obs, alpha)

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[1]:
            raise NotImplementedError("crps: the gradient with respect to the observations is not ported")
        forecasts, obs = ctx.saved_tensors
        return crps_skillspread_grad(forecasts, obs, g, ctx.alpha), None, None


def crps_skillspread(forecasts: torch.Tensor, obs: torch.Tensor, alpha: float = 1.0, use_kernels: bool = True) -> torch.Tensor:
    """Pointwise skillspread CRPS of forecasts (B, E, N) against obs (B, N)
    -> (B, N): K15 forward and backward as one autograd function, or the
    plain version under autograd (``use_kernels=False``)."""
    if not use_kernels:
        return crps_skillspread_plain(forecasts, obs, alpha)
    return _CRPSSkillspread.apply(forecasts, obs, alpha)


def crps_ensemble(obs, forecasts, crps_type: str = "skillspread", alpha: float = 1.0, eps: float = 1e-5, ensemble_axis: int = -1, use_kernels: bool = True):
    """Pointwise CRPS. obs (...), forecasts with the ensemble on
    ``ensemble_axis`` and obs's shape otherwise. Only ``skillspread`` is
    ported; the other types raise."""
    if crps_type != "skillspread":
        raise NotImplementedError(f"crps_type {crps_type!r} is not ported yet (only 'skillspread')")
    axis = ensemble_axis % forecasts.dim()
    if axis == 1 and obs.dim() >= 1:
        # (B, E, ...) against (B, ...): members lie N apart, as K15 reads them
        f = forecasts.reshape(forecasts.shape[0], forecasts.shape[1], -1)
        o = obs.reshape(obs.shape[0], -1)
    else:
        f = forecasts.movedim(axis, 0).reshape(1, forecasts.shape[axis], -1)
        o = obs.reshape(1, -1)
    return crps_skillspread(f, o, alpha, use_kernels).reshape(obs.shape)


class CRPSLoss(GeometricBaseLoss):
    """Quadrature-averaged pointwise CRPS of an ensemble forecast
    (B, E, C, H, W) against (B, C, H, W) observations; returns (B, C).
    ``use_kernels = False`` scores with the plain version under autograd:
    the reference path a comparison on the card runs."""

    type = LossType.Probabilistic

    def __init__(self, img_shape, crop_shape=None, crop_offset=(0, 0), channel_names=(), grid_type="equiangular", crps_type: str = "skillspread", alpha: float = 1.0, eps: float = 1e-5, **kwargs):
        super().__init__(img_shape, crop_shape, crop_offset, channel_names, grid_type)
        if crps_type != "skillspread":
            raise NotImplementedError(f"crps_type {crps_type!r} is not ported yet (only 'skillspread')")
        self.crps_type = crps_type
        self.alpha = alpha
        self.eps = eps
        self.use_kernels = True

    def __call__(self, forecasts, observations, wgt=None, **kwargs):
        if forecasts.dim() != 5:
            raise ValueError(f"forecasts must be 5D (B, E, C, H, W), got {forecasts.dim()}D")
        crps = crps_ensemble(observations, forecasts, self.crps_type, self.alpha, self.eps, ensemble_axis=1, use_kernels=self.use_kernels)
        if wgt is not None:
            crps = crps * wgt
        return self.quadrature(crps).reshape(forecasts.shape[0], -1)
