"""Physical-units model wrapper (counterpart of ``ModelWrapper`` in
``makani_tpu/models/model_package.py``).

``ModelWrapper`` maps a physical input field (plus the zenith channels) to
the physical prediction: normalize -> model -> denormalize. Loading a saved
package (the JAX package's orbax ``load_model_package``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from makani_torch.utils.zenith_angle import cos_zenith_angle_from_timestamp

__all__ = ["ModelWrapper", "rollout"]


class ModelWrapper:
    """Plain physical-units callable around a built model (a
    ``MultiStepWrapper`` from ``get_model(..., multistep=True)``). Stats are
    per-channel arrays of shape (1, C, 1, 1)."""

    def __init__(self, model: torch.nn.Module, bias=None, scale=None, out_bias=None, out_scale=None):
        self.model = model.eval()
        device = next(model.parameters()).device

        def as_tensor(a):
            return None if a is None else torch.as_tensor(a, dtype=torch.float32, device=device)

        self.bias, self.scale = as_tensor(bias), as_tensor(scale)
        self.out_bias, self.out_scale = as_tensor(out_bias), as_tensor(out_scale)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, zenith: torch.Tensor | None = None) -> torch.Tensor:
        if self.bias is not None:
            x = (x - self.bias) / self.scale
        y = self.model(x, zenith, train=False)
        if self.out_bias is not None:
            y = y * self.out_scale + self.out_bias
        elif self.bias is not None:
            # packages without out stats: the outputs are a prefix of the inputs
            nb = y.shape[1]
            y = y * self.scale[:, :nb] + self.bias[:, :nb]
        return y


def rollout(wrapper: ModelWrapper, x0: torch.Tensor, lat, lon, base_time: float, dhours: float, steps: int, needs_zenith: bool = True) -> list:
    """Autoregressive rollout in physical units, recomputing the zenith angle
    for each step (counterpart of ``rollout`` in
    ``examples/inference_model_package.py``). ``x0`` is (B, C, H, W) on the
    model's device; returns the ``steps`` predictions."""
    lon2d, lat2d = np.meshgrid(lon, lat)
    pred = x0
    frames = []
    t = float(base_time)
    for _ in range(steps):
        zen = None
        if needs_zenith:
            z = cos_zenith_angle_from_timestamp(t, lon2d, lat2d).astype(np.float32)
            zen = torch.from_numpy(z).to(x0.device)[None, None, None].expand(x0.shape[0], 1, 1, *z.shape)
        pred = wrapper(pred, zen)
        t += dhours * 3600.0
        frames.append(pred)
    return frames
