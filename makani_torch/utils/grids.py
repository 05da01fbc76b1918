"""Grid quadratures on the sphere (counterpart of ``makani_tpu/utils/grids.py``
``grid_to_quadrature_rule``, ``quadrature_weights`` and ``GridQuadrature``).

The weights are float64 numpy computations on the port's bit-equal
``ops/quadrature.py``, stored as fp32; the quadrature itself is a plain
weighted sum over the last two (lat, lon) axes, differentiable by autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from makani_torch.ops.quadrature import clenshaw_curtiss_weights, legendre_gauss_weights

__all__ = ["grid_to_quadrature_rule", "quadrature_weights", "GridQuadrature"]


def grid_to_quadrature_rule(grid_type: str) -> str:
    """Map a grid type onto its quadrature rule."""
    grid_to_quad = {
        "euclidean": "uniform",
        "equiangular": "naive",
        "legendre-gauss": "legendre-gauss",
        "clenshaw-curtiss": "clenshaw-curtiss",
        "weatherbench2": "weatherbench2",
    }
    if grid_type not in grid_to_quad:
        raise NotImplementedError(f"Grid type {grid_type} does not have a quadrature rule")
    return grid_to_quad[grid_type]


def quadrature_weights(quadrature_rule: str, img_shape, normalize: bool = False) -> np.ndarray:
    """Full-grid quadrature weight map of shape ``img_shape`` summing to 4 pi
    (to 1 with ``normalize``)."""
    nlat, nlon = img_shape
    if quadrature_rule == "naive":
        jacobian = np.clip(np.sin(np.linspace(0, np.pi, nlat)), 0.0, None)
        dtheta = np.pi / nlat
        dlambda = 2 * np.pi / nlon
        quad_weight = dlambda * dtheta * jacobian[:, None]
        quad_weight = np.tile(quad_weight, (1, nlon))
        quad_weight = quad_weight * (4.0 * np.pi) / np.sum(quad_weight)
    elif quadrature_rule == "clenshaw-curtiss":
        _, weights = clenshaw_curtiss_weights(nlat, -1, 1)
        dlambda = 2 * np.pi / nlon
        quad_weight = np.tile(dlambda * weights[:, None], (1, nlon))
    elif quadrature_rule == "legendre-gauss":
        _, weights = legendre_gauss_weights(nlat, -1, 1)
        # north-to-south, as the data
        weights = weights[::-1]
        dlambda = 2 * np.pi / nlon
        quad_weight = np.tile(dlambda * weights[:, None], (1, nlon))
    elif quadrature_rule == "weatherbench2":
        lats = np.linspace(0, np.pi, nlat)
        cell_bounds = np.concatenate([[0.0], (lats[:-1] + lats[1:]) / 2, [np.pi]])
        jacobian = np.cos(cell_bounds[:-1]) - np.cos(cell_bounds[1:])
        dlambda = 2 * np.pi / nlon
        quad_weight = np.tile(dlambda * jacobian[:, None], (1, nlon))
    elif quadrature_rule == "uniform":
        quad_weight = np.ones((nlat, nlon))
        quad_weight = 4.0 * np.pi * quad_weight / np.sum(quad_weight)
    else:
        raise ValueError(f"Unknown quadrature rule {quadrature_rule}")
    if normalize:
        quad_weight = quad_weight / (4.0 * np.pi)
    return quad_weight


class GridQuadrature:
    """Integrate fields over the last two (lat, lon) axes (or (-3, -2) with
    ``channels_last``). ``crop_shape``/``crop_offset`` select a tile of the
    global weight map; rows or columns beyond the weights (a padded grid)
    weigh zero."""

    def __init__(self, quadrature_rule: str, img_shape, crop_shape=None, crop_offset=(0, 0), normalize: bool = False):
        crop_shape = tuple(img_shape) if crop_shape is None else tuple(crop_shape)
        quad_weight = quadrature_weights(quadrature_rule, img_shape, normalize=normalize)
        quad_weight = quad_weight[crop_offset[0] : crop_offset[0] + crop_shape[0], crop_offset[1] : crop_offset[1] + crop_shape[1]]
        self.quad_weight = quad_weight.astype(np.float32)
        self._tensors = {}

    def _weight(self, shape, device, dtype) -> torch.Tensor:
        key = (tuple(shape), torch.device(device), dtype)
        if key not in self._tensors:
            w = self.quad_weight
            if shape[0] > w.shape[0] or shape[1] > w.shape[1]:
                w = np.pad(w, [(0, shape[0] - w.shape[0]), (0, shape[1] - w.shape[1])])
            self._tensors[key] = torch.from_numpy(np.ascontiguousarray(w)).to(device=device, dtype=dtype)
        return self._tensors[key]

    def __call__(self, x: torch.Tensor, channels_last: bool = False) -> torch.Tensor:
        if channels_last:
            w = self._weight(x.shape[-3:-1], x.device, x.dtype)
            return torch.sum(x * w[..., None], dim=(-3, -2))
        w = self._weight(x.shape[-2:], x.device, x.dtype)
        return torch.sum(x * w, dim=(-2, -1))
