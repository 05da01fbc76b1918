"""Geometric metrics (counterpart of ``makani_tpu/utils/metrics/functions.py``).

Every metric is quadrature-weighted over the sphere (normalized weights,
``GridQuadrature(..., normalize=True)``) and returns per-(batch, channel)
values (B, C); ``MetricsHandler`` accumulates them over batches and
rollout steps. Ensembles are (B, E, C, H, W).
"""

from __future__ import annotations

import torch

__all__ = [
    "weighted_mean",
    "weighted_rmse",
    "weighted_acc",
    "weighted_l1",
    "ensemble_crps",
    "ensemble_spread",
    "ensemble_rank_histogram",
]


def weighted_mean(x, quad):
    """Normalized quadrature mean over the sphere: (B, C, H, W) -> (B, C)."""
    return quad(x)


def _mask_weight(x, mask):
    """An optional spatial mask on an integrand, normalized by the caller to
    a unit quadrature integral."""
    return x if mask is None else x * mask


def weighted_rmse(prd, tar, quad, mask=None):
    return torch.sqrt(quad(_mask_weight(torch.square(prd - tar), mask)))


def weighted_l1(prd, tar, quad, mask=None):
    return quad(_mask_weight(torch.abs(prd - tar), mask))


def weighted_acc(prd, tar, quad, clim=None, mask=None, eps: float = 1e-8):
    """Anomaly correlation coefficient against the climatology ``clim``."""
    if clim is not None:
        pa, ta = prd - clim, tar - clim
    else:
        pa, ta = prd, tar
    num = quad(_mask_weight(pa * ta, mask))
    den = torch.sqrt(quad(_mask_weight(torch.square(pa), mask)) * quad(_mask_weight(torch.square(ta), mask)))
    return num / (den + eps)


def _rank_coefficients(E: int, like: torch.Tensor, ndim: int) -> torch.Tensor:
    ranks = torch.arange(E, dtype=like.dtype, device=like.device)
    return (2.0 * ranks - E + 1.0).reshape((-1,) + (1,) * (ndim - 1))


def _crps_kernel_sorted(ens_sorted, obs):
    """CRPS by probability-weighted moments on an ensemble sorted along its
    first axis, (E, ...), against obs (...): E|X - y| - E|X - X'| / 2, the
    second term by the sorted-rank identity 2 / (E (E - 1)) sum_i (2i - E +
    1) x_(i) / 2."""
    E = ens_sorted.shape[0]
    term1 = torch.mean(torch.abs(ens_sorted - obs[None]), dim=0)
    if E > 1:
        term2 = torch.sum(_rank_coefficients(E, ens_sorted, ens_sorted.dim()) * ens_sorted, dim=0) / (E * (E - 1.0))
    else:
        term2 = torch.zeros_like(term1)
    return term1 - term2


def ensemble_crps(ens, obs, quad, fair: bool = True, mask=None):
    """CRPS of an ensemble forecast ens (B, E, C, H, W) against obs (B, C, H,
    W): the fair estimator (spread over E (E - 1)), or with ``fair=False``
    the biased one (over E^2). Returns (B, C)."""
    ens_sorted = torch.movedim(torch.sort(ens, dim=1).values, 1, 0)  # (E, B, C, H, W)
    crps = _crps_kernel_sorted(ens_sorted, obs)
    if not fair:
        E = ens.shape[1]
        if E > 1:
            coeff = _rank_coefficients(E, ens, ens_sorted.dim())
            crps = crps + torch.sum(coeff * ens_sorted, dim=0) * (1.0 / (E * (E - 1.0)) - 1.0 / (E * E))
    return quad(_mask_weight(crps, mask))


def ensemble_spread(ens, quad, mask=None, eps: float = 1e-8):
    """sqrt of the mean ensemble variance: (B, E, C, H, W) -> (B, C)."""
    var = torch.var(ens, dim=1, correction=1) if ens.shape[1] > 1 else torch.zeros_like(ens[:, 0])
    return torch.sqrt(quad(_mask_weight(var, mask)) + eps)


def ensemble_rank_histogram(ens, obs, quad):
    """Quadrature-weighted rank histogram: the area-weighted frequency of
    each rank (the count of members <= obs) the observation takes in the
    ensemble. ens (B, E, C, H, W), obs (B, C, H, W) -> (B, C, E + 1), each
    row summing to 1."""
    E = ens.shape[1]
    ranks = torch.sum(ens <= obs[:, None], dim=1)  # (B, C, H, W) in [0, E]
    rows = [quad((ranks == r).to(torch.float32)) for r in range(E + 1)]
    return torch.stack(rows, dim=-1)
