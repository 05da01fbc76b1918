"""Random fields on the sphere (counterpart of ``makani_tpu/models/noise.py``).

Spectrally generated noise for probabilistic (FCN3-style) ensembles:

  * ``IsotropicGaussianRandomFieldS2``: a stateless power-law field, SH
    coefficients ~ N(0, sigma_l^2) with sigma_l proportional to
    (2l+1)^(-alpha/2), normalized so the spatial variance is sigma^2;
  * ``DiffusionNoiseS2``: an Ornstein-Uhlenbeck process in time on spatially
    correlated coefficients (spectrum exp(-kT l(l+1)/2)), damping
    phi = exp(-lambd) per step, stateful across rollout steps;
  * ``DummyNoiseS2``: zeros, same interface.

The state is an explicit tensor and every draw takes a ``torch.Generator``,
so a seed fixes an ensemble; the JAX package's ``jax.random`` keys become
generators (the two give different numbers from one seed). Coefficients are
split-complex (trailing [re, im]); ``sample`` synthesizes them with the
inverse SHT (kernel K2). The state lives on the device of the generator it
is drawn from.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from makani_torch.ops.precision import fp32_exact
from makani_torch.ops.sht import InverseRealSHT

__all__ = ["IsotropicGaussianRandomFieldS2", "DiffusionNoiseS2", "DummyNoiseS2", "build_noise"]


class _BaseNoiseS2:
    def __init__(self, img_shape, num_channels, num_time_steps=1, grid_type="equiangular", lmax=None, reflect=False):
        self.img_shape = tuple(img_shape)
        self.num_channels = num_channels
        self.num_time_steps = num_time_steps
        self.reflect = reflect

        nlat, nlon = img_shape
        self.lmax = min(lmax or nlat, nlat)
        self.mmax = min(self.lmax, nlon // 2 + 1)
        self.isht = InverseRealSHT(nlat, nlon, lmax=self.lmax, mmax=self.mmax, grid=grid_type)

    @property
    def state_shape(self):
        return (self.num_time_steps, self.num_channels, self.lmax, self.mmax, 2)

    def is_stateful(self):
        return False

    def init_state(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        raise NotImplementedError

    def update(self, state: torch.Tensor, generator: torch.Generator, replace_state: bool = False) -> torch.Tensor:
        raise NotImplementedError

    def sample(self, state: torch.Tensor) -> torch.Tensor:
        """state -> noise fields (B, T, C, nlat, nlon)."""
        raise NotImplementedError

    def _on(self, name: str, device) -> torch.Tensor:
        """The host tensor ``name`` on ``device``, copied there once (a copy
        from pageable memory on every draw would wait for the card)."""
        cache = self.__dict__.setdefault("_device_tensors", {})
        key = (name, torch.device(device))
        if key not in cache:
            cache[key] = getattr(self, name).to(device)
        return cache[key]

    def _synthesis(self, c2: torch.Tensor) -> torch.Tensor:
        B = c2.shape[0]
        eta = self.isht.synthesis(c2.reshape(B, self.num_time_steps * self.num_channels, self.lmax, self.mmax, 2))
        return eta.reshape(B, self.num_time_steps, self.num_channels, *self.img_shape)


def _normal(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)


class IsotropicGaussianRandomFieldS2(_BaseNoiseS2):
    """Power-law Gaussian random field."""

    def __init__(self, img_shape, num_channels, num_time_steps=1, sigma=1.0, alpha=0.0, grid_type="equiangular", lmax=None, reflect=False, **kwargs):
        super().__init__(img_shape, num_channels, num_time_steps, grid_type, lmax, reflect)
        self.sigma = sigma
        self.alpha = float(alpha)

        ls = np.arange(self.lmax).reshape(-1, 1)
        ms = np.arange(self.mmax).reshape(1, -1)
        power = np.power(2 * ls + 1.0, -self.alpha)
        norm = np.sum((2 * ls + 1.0) * power / (4.0 * np.pi))
        sigma_l = sigma * np.sqrt(power / norm)
        sigma_l = np.where(ms <= ls, sigma_l, 0.0)
        self.sigma_l = torch.from_numpy(sigma_l.reshape(1, 1, 1, self.lmax, self.mmax, 1).astype(np.float32))

    def init_state(self, generator, batch_size: int):
        state = _normal(generator, (batch_size,) + self.state_shape)
        return -state if self.reflect else state

    def update(self, state, generator, replace_state: bool = False):
        return self.init_state(generator, state.shape[0])

    def sample(self, state):
        return self._synthesis(state / math.sqrt(2.0) * self._on("sigma_l", state.device))


def _toeplitz_discount(phi: float, n: int) -> np.ndarray:
    """Lower-triangular Toeplitz matrix of powers of phi."""
    out = np.zeros((n, n), np.float64)
    for i in range(n):
        for j in range(i + 1):
            out[i, j] = phi ** (i - j)
    return out


class DiffusionNoiseS2(_BaseNoiseS2):
    """Ornstein-Uhlenbeck in time, spatially correlated noise."""

    def __init__(self, img_shape, num_channels, num_time_steps=1, sigma=1.0, kT=0.5 * (500.0 / 6370.0) ** 2, lambd=1.0, grid_type="equiangular", lmax=None, reflect=False, **kwargs):
        super().__init__(img_shape, num_channels, num_time_steps, grid_type, lmax, reflect)
        self.sigma = sigma
        self.kT = kT
        self.lambd = lambd

        ls = np.arange(self.lmax)
        kT = np.asarray(kT if isinstance(kT, (list, tuple, np.ndarray)) else [kT] * num_channels, np.float64).reshape(num_channels, 1)
        lambd = np.asarray(lambd if isinstance(lambd, (list, tuple, np.ndarray)) else [lambd] * num_channels, np.float64).reshape(num_channels, 1)

        ektllp1 = np.exp(-kT * ls * (ls + 1.0))
        F0norm = np.sum((2 * ls[1:] + 1.0) * ektllp1[..., 1:], axis=-1, keepdims=True)
        phi = np.exp(-lambd)
        F0 = sigma * np.sqrt(0.5 * (1.0 - phi**2) / F0norm)
        sigma_l = math.sqrt(4.0 * math.pi) * F0 * np.exp(-0.5 * kT * ls * (ls + 1.0))

        self.phi = torch.from_numpy(phi.reshape(1, 1, num_channels, 1, 1, 1).astype(np.float32))
        self.sigma_l = torch.from_numpy(sigma_l.reshape(1, 1, num_channels, self.lmax, 1, 1).astype(np.float32))
        if self.num_time_steps > 1:
            disc = np.stack([_toeplitz_discount(float(p), self.num_time_steps) for p in phi.reshape(-1)])
            self.discount = torch.from_numpy(disc.astype(np.float32))  # (C, T, T)

    def is_stateful(self):
        return True

    def _innovation(self, generator, batch_size, nt):
        eta = _normal(generator, (batch_size, nt, self.num_channels, self.lmax, self.mmax, 2))
        eta = eta * self._on("sigma_l", eta.device)
        return -eta if self.reflect else eta

    def init_state(self, generator, batch_size: int):
        zeros = torch.zeros((batch_size,) + self.state_shape, dtype=torch.float32, device=generator.device)
        return self.update(zeros, generator, replace_state=True)

    def update(self, state, generator, replace_state: bool = False):
        phi = self._on("phi", state.device)
        if replace_state:
            eta = self._innovation(generator, state.shape[0], self.num_time_steps)
            # the first step from the stationary distribution
            first = eta[:, :1] / torch.sqrt(1.0 - phi**2)
            eta = torch.cat([first, eta[:, 1:]], dim=1)
            if self.num_time_steps > 1:
                with fp32_exact():
                    eta = torch.einsum("ctr,brclmu->btclmu", self._on("discount", state.device), eta)
            return eta
        # a single AR step
        eta = self._innovation(generator, state.shape[0], 1)
        if self.num_time_steps > 1:
            new = phi * state[:, -1:] + eta
            return torch.cat([state[:, 1:], new], dim=1)
        return phi * state + eta

    def sample(self, state):
        return self._synthesis(state)


class DummyNoiseS2(_BaseNoiseS2):
    """Zero noise with the same interface."""

    def __init__(self, img_shape, num_channels, num_time_steps=1, **kwargs):
        super().__init__(img_shape, num_channels, num_time_steps)

    def init_state(self, generator, batch_size: int):
        return torch.zeros((batch_size,) + self.state_shape, dtype=torch.float32, device=generator.device)

    def update(self, state, generator, replace_state: bool = False):
        return state

    def sample(self, state):
        B = state.shape[0]
        return torch.zeros((B, self.num_time_steps, self.num_channels, *self.img_shape), dtype=torch.float32, device=state.device)


def build_noise(noise_params: dict, img_shape, num_time_steps: int = 1):
    """Factory from an ``input_noise`` config dict."""
    kind = noise_params["type"]
    num_channels = noise_params.get("n_channels", 1)
    kwargs = dict(
        img_shape=img_shape,
        num_channels=num_channels,
        num_time_steps=num_time_steps,
        sigma=noise_params.get("sigma", 1.0),
        lmax=noise_params.get("lmax", None),
        reflect=noise_params.get("reflect", False),
        grid_type=noise_params.get("grid_type", "equiangular"),
    )
    if kind == "white":
        return IsotropicGaussianRandomFieldS2(alpha=noise_params.get("alpha", 0.0), **kwargs)
    if kind == "diffusion":
        return DiffusionNoiseS2(kT=noise_params.get("kT", 0.5 * (100.0 / 6370.0) ** 2), lambd=noise_params.get("lambd", 1.0), **kwargs)
    if kind == "dummy":
        return DummyNoiseS2(img_shape=img_shape, num_channels=num_channels, num_time_steps=num_time_steps)
    raise NotImplementedError(f"input noise type {kind} not supported")
