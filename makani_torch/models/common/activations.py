"""Split-complex activations (counterpart of ``complex_relu_s`` in
``makani_tpu/models/common/activations.py``).

Complex values are carried as a trailing [re, im] axis, as everywhere in the
port. AFNOv2's mixer applies the ``cartesian`` mode inside kernel K18; this
is the plain form for other callers.
"""

from __future__ import annotations

import math

import torch

__all__ = ["complex_relu_s"]


def complex_relu_s(z2: torch.Tensor, mode: str = "real", negative_slope: float = 0.0, bias=0.0) -> torch.Tensor:
    """Split-complex rectifier of z2 (..., 2): ``real`` rectifies the real
    part, ``cartesian`` both parts apart, ``modulus`` scales by
    relu(|z| + bias) / |z|, ``halfplane`` keeps the values whose angle (less
    ``bias``) lies in [0, pi/2) and scales the others by ``negative_slope``."""

    def act(v):
        return torch.where(v >= 0, v, negative_slope * v)

    zr, zi = z2[..., 0], z2[..., 1]
    if mode == "real":
        return torch.stack([act(zr), zi], dim=-1)
    if mode == "cartesian":
        return torch.stack([act(zr), act(zi)], dim=-1)
    if mode == "modulus":
        zabs = torch.sqrt(torch.square(zr) + torch.square(zi))
        gated = torch.where(zabs + bias > 0, (zabs + bias) / torch.clamp(zabs, min=1e-30), 0.0)
        return z2 * gated[..., None]
    if mode == "halfplane":
        angle = torch.atan2(zi, zr) - bias
        keep = (angle >= 0.0) & (angle < math.pi / 2.0)
        return torch.where(keep[..., None], z2, negative_slope * z2)
    raise NotImplementedError(f"Unknown complex ReLU mode {mode}")
