"""Geometric Lp loss on the sphere (counterpart of ``GeometricLpLoss`` in
``makani_tpu/utils/losses/lp_loss.py``)."""

from __future__ import annotations

import torch

from makani_torch.utils.losses.base_loss import GeometricBaseLoss

__all__ = ["GeometricLpLoss"]


class GeometricLpLoss(GeometricBaseLoss):
    """Quadrature-weighted Lp norm of the error per (sample, channel);
    optionally relative to the target's norm and/or without the 1/p root
    (``squared``). Multistep predictions ((n_future+1)*C channels) reduce the
    same way."""

    def __init__(self, img_shape, crop_shape=None, crop_offset=(0, 0), channel_names=(), grid_type="equiangular", p: float = 2.0, relative: bool = False, squared: bool = False, eps: float = 1e-6, **kwargs):
        super().__init__(img_shape, crop_shape, crop_offset, channel_names, grid_type)
        self.p = p
        self.relative = relative
        self.squared = squared
        self.eps = eps

    def __call__(self, prd: torch.Tensor, tar: torch.Tensor, wgt=None, **kwargs) -> torch.Tensor:
        diff = torch.abs(prd - tar) ** self.p
        if wgt is not None:
            diff = diff * wgt
        norms = self.quadrature(diff).reshape(prd.shape[0], -1)
        if self.relative:
            tarr = torch.abs(tar) ** self.p
            if wgt is not None:
                tarr = tarr * wgt
            tnorms = self.quadrature(tarr).reshape(prd.shape[0], -1)
            norms = norms / (tnorms + self.eps)
        if not self.squared:
            norms = norms ** (1.0 / self.p)
        return norms
