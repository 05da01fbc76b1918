"""Physical-units model wrapper (counterpart of ``ModelWrapper`` in
``makani_tpu/models/model_package.py``).

``ModelWrapper`` maps a physical input field (plus the zenith and noise
channels) to the physical prediction: normalize -> model -> denormalize.
``rollout`` runs it autoregressively, for an ensemble with a noise module.
The trainer's checkpoints are saved and restored by
``utils/checkpoint_helpers.CheckpointManager`` (the ``Inferencer`` scores
them); loading a saved model package (the JAX package's
``load_model_package``) is not ported yet.
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
        """x (B, T*C, H, W): a window of T states, oldest first (T = 1 without
        history), each normalized with the per-channel stats."""
        if self.bias is not None:
            reps = x.shape[1] // self.bias.shape[1]
            x = (x - self.bias.repeat(1, reps, 1, 1)) / self.scale.repeat(1, reps, 1, 1)
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
    ``examples/inference_model_package.py``). ``x0`` is (B, T*C, H, W) on the
    model's device, T = n_history + 1 states oldest first, the newest at
    ``base_time``; returns the ``steps`` predictions (B, C, H, W).

    Each step feeds the window and, per state, its zenith angle (at its own
    time, ``dhours`` apart) and noise fields; then the window slides, the
    prediction appended and the oldest state dropped
    (``Preprocessor2D.append_history``), as the JAX package's inferencer
    steps a history window.

    With a noise module (``models.noise``), each of the B initial conditions
    runs as ``ensemble_size`` members folded b-major into the batch, and the
    noise fields are drawn as the JAX package's inferencer draws them
    (``utils/inference/inferencer.py``): a sequence of n_history + steps
    fields, ``init_state`` for the first and ``update`` for each later one,
    ``sample`` each, all from ``generator``; step s reads fields s to
    s + n_history. ``centered`` draws half the members and gives each pair
    the fields +eta and -eta."""
    pre = wrapper.model.preprocessor
    T = pre.n_history + 1
    lon2d, lat2d = np.meshgrid(lon, lat)
    window = x0
    draw = state = None
    fields: list = []
    if noise is not None:
        window = x0.repeat_interleave(ensemble_size, dim=0)
        n = window.shape[0]
        if centered and n % 2:
            raise ValueError(f"centered noise pairs members; {n} members is odd")
        draw = n // 2 if centered else n
        generator = generator if generator is not None else torch.Generator(x0.device).manual_seed(0)
    frames = []
    t = float(base_time)
    dt = dhours * 3600.0
    for step in range(steps):
        unp = None
        if needs_zenith:
            z = np.stack([cos_zenith_angle_from_timestamp(t - (T - 1 - k) * dt, lon2d, lat2d) for k in range(T)]).astype(np.float32)
            unp = torch.from_numpy(z).to(x0.device)[None, :, None].expand(window.shape[0], T, 1, *z.shape[1:])
        if noise is not None:
            while len(fields) < step + T:
                state = noise.init_state(generator, draw) if state is None else noise.update(state, generator)
                eta = noise.sample(state)[:, 0]  # (draw, C_noise, H, W)
                if centered:
                    eta = torch.stack([eta, -eta], dim=1).reshape(2 * draw, *eta.shape[1:])
                fields.append(eta.to(x0.device))
            eta = torch.stack(fields[step : step + T], dim=1)  # (members, T, C_noise, H, W)
            unp = eta if unp is None else torch.cat([unp, eta], dim=2)
        pred = wrapper(window, unp)
        window = pre.append_history(window, pred, step)
        t += dt
        frames.append(pred)
    return frames
