"""Loss base classes and channel weighting (counterpart of ``LossType``,
``compute_channel_weighting`` and ``GeometricBaseLoss`` in
``makani_tpu/utils/losses/base_loss.py``).

A loss maps (prd, tar) of shape (B, C, H, W) to per-(sample, channel) values
(B, C); ``LossHandler`` weights and reduces them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from makani_torch.utils.grids import GridQuadrature, grid_to_quadrature_rule

__all__ = ["LossType", "compute_channel_weighting", "GeometricBaseLoss"]


class LossType:
    Deterministic = 1
    Probabilistic = 2


def _pangu_weight(name: str) -> float:
    """Per-variable weights of the Pangu-Weather paper (rule-based)."""
    table = {"u10m": 0.77, "v10m": 0.66, "t2m": 3.0, "msl": 1.5}
    if name in table:
        return table[name]
    rules = {"u": 0.77, "v": 0.54, "t": 1.5, "z": 3.0, "q": 0.6}
    return rules.get(name[0], 1.0)


def compute_channel_weighting(channel_names: List[str], channel_weight_type: str = "constant", time_diff_scale: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-channel weights normalized to sum to one, optionally multiplied by
    the time-difference scale; fp32."""
    w = np.ones(len(channel_names), dtype=np.float64)
    if channel_weight_type == "constant":
        pass
    elif channel_weight_type in ("auto", "new auto"):
        for c, chn in enumerate(channel_names):
            if chn in ("u10m", "v10m", "u100m", "v100m", "tp", "sp", "msl", "tcwv", "sst"):
                w[c] = 0.1
            elif chn in ("t2m", "2d"):
                w[c] = 1.0 if channel_weight_type == "auto" else 2.0
            elif chn[0] in ("z", "u", "v", "t", "r", "q"):
                plvl = float(chn[1:])
                w[c] = 0.001 * plvl if channel_weight_type == "auto" else max(0.3, 0.001 * plvl)
            else:
                w[c] = 0.01
    elif channel_weight_type == "pangu":
        for c, chn in enumerate(channel_names):
            w[c] = _pangu_weight(chn)
    else:
        raise NotImplementedError(f"Unknown channel weighting type {channel_weight_type}")
    w = w / w.sum()
    if time_diff_scale is not None:
        w = w * np.asarray(time_diff_scale, dtype=np.float64)
    return w.astype(np.float32)


class GeometricBaseLoss:
    """Quadrature-weighted loss base: the normalized (sum 1) quadrature of
    ``grid_type`` over the (lat, lon) axes."""

    type = LossType.Deterministic

    def __init__(self, img_shape, crop_shape=None, crop_offset=(0, 0), channel_names=(), grid_type="equiangular", **kwargs):
        self.img_shape = tuple(img_shape)
        self.channel_names = list(channel_names)
        self.quadrature = GridQuadrature(grid_to_quadrature_rule(grid_type), img_shape=img_shape, crop_shape=crop_shape, crop_offset=crop_offset, normalize=True)

    @property
    def n_channels(self):
        return len(self.channel_names)
