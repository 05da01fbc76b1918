"""Physical-units model wrapper (counterpart of ``ModelWrapper`` in
``makani_tpu/models/model_package.py``).

``ModelWrapper`` maps a physical input field (plus the zenith and noise
channels) to the physical prediction: normalize -> model -> denormalize.
``rollout`` runs it autoregressively, for an ensemble with a noise module. Loading a saved
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


def rollout(
    wrapper: ModelWrapper,
    x0: torch.Tensor,
    lat,
    lon,
    base_time: float,
    dhours: float,
    steps: int,
    needs_zenith: bool = True,
    noise=None,
    ensemble_size: int = 1,
    centered: bool = False,
    generator: torch.Generator | None = None,
) -> list:
    """Autoregressive rollout in physical units, recomputing the zenith angle
    for each step (counterpart of ``rollout`` in
    ``examples/inference_model_package.py``). ``x0`` is (B, C, H, W) on the
    model's device; returns the ``steps`` predictions.

    With a noise module (``models.noise``), each of the B initial conditions
    runs as ``ensemble_size`` members folded b-major into the batch, and each
    step appends the noise fields after the zenith channel, drawn as the JAX
    package's inferencer draws them (``utils/inference/inferencer.py``):
    ``init_state`` before the first step, ``update`` before each later one,
    ``sample`` every step, all from ``generator``. ``centered`` draws half the
    members and gives each pair the fields +eta and -eta."""
    lon2d, lat2d = np.meshgrid(lon, lat)
    pred = x0
    draw = state = None
    if noise is not None:
        pred = x0.repeat_interleave(ensemble_size, dim=0)
        n = pred.shape[0]
        if centered and n % 2:
            raise ValueError(f"centered noise pairs members; {n} members is odd")
        draw = n // 2 if centered else n
        generator = generator if generator is not None else torch.Generator(x0.device).manual_seed(0)
    frames = []
    t = float(base_time)
    for _ in range(steps):
        unp = None
        if needs_zenith:
            z = cos_zenith_angle_from_timestamp(t, lon2d, lat2d).astype(np.float32)
            unp = torch.from_numpy(z).to(x0.device)[None, None, None].expand(pred.shape[0], 1, 1, *z.shape)
        if noise is not None:
            state = noise.init_state(generator, draw) if state is None else noise.update(state, generator)
            eta = noise.sample(state)[:, 0]  # (draw, C_noise, H, W)
            if centered:
                eta = torch.stack([eta, -eta], dim=1).reshape(2 * draw, *eta.shape[1:])
            eta = eta[:, None].to(x0.device)
            unp = eta if unp is None else torch.cat([unp, eta], dim=2)
        pred = wrapper(pred, unp)
        t += dhours * 3600.0
        frames.append(pred)
    return frames
