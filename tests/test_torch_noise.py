"""makani_torch's spherical noise against makani_tpu's, on the CPU.

The two draw their innovations from different generators (``jax.random``
keys, ``torch.Generator``s), so both instances are handed the same seeded
numpy innovations: the JAX instance's ``_innovation`` is replaced in the test
(the package is not edited). Everything after the draw (the stationary first
step, the AR update, the discount matrix, the synthesis through the inverse
SHT) must agree to 1e-5 * max|ref| in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from makani_tpu.models import noise as jnoise

from makani_torch import kernels
from makani_torch.models import noise
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

IMG = (17, 32)


def _close(out, ref, rel=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rel * max(np.max(np.abs(ref)), 1e-30)


def _feed(mod, draws, port):
    """Make ``mod._innovation`` return the next seeded draw, scaled and
    reflected as the module's own innovation is."""
    it = iter(draws)

    def innovation(key, batch_size, nt):
        eta = next(it)[:batch_size, :nt] * np.asarray(mod.sigma_l)
        eta = -eta if mod.reflect else eta
        return torch.from_numpy(eta) if port else jnp.asarray(eta)

    mod._innovation = innovation


@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("T", [1, 2])
def test_diffusion_noise_matches_jax(T, reflect):
    cfg = dict(img_shape=IMG, num_channels=3, num_time_steps=T, sigma=0.7, kT=0.5 * (300.0 / 6370.0) ** 2, lambd=[0.5, 1.0, 2.0], reflect=reflect)
    jm, tm = jnoise.DiffusionNoiseS2(**cfg), noise.DiffusionNoiseS2(**cfg)
    assert np.allclose(np.asarray(tm.sigma_l), jm.sigma_l) and np.allclose(np.asarray(tm.phi), jm.phi)
    rng = np.random.default_rng(3)
    draws = [rng.standard_normal((2, T, 3, jm.lmax, jm.mmax, 2)).astype(np.float32) for _ in range(4)]
    _feed(jm, draws, port=False)
    _feed(tm, draws, port=True)
    gen = torch.Generator().manual_seed(0)
    js = jm.init_state(jax.random.PRNGKey(0), 2)
    ts = tm.init_state(gen, 2)
    kernels.reset_launch_counts()
    for _ in range(3):
        _close(ts, js)
        _close(tm.sample(ts), jax.jit(jm.sample)(js))
        js = jm.update(js, jax.random.PRNGKey(1))
        ts = tm.update(ts, gen)
    assert not any(kernels.LAUNCHES.values())


def test_isotropic_and_dummy_noise_match_jax():
    jm = jnoise.IsotropicGaussianRandomFieldS2(IMG, 2, sigma=1.3, alpha=1.5)
    tm = noise.IsotropicGaussianRandomFieldS2(IMG, 2, sigma=1.3, alpha=1.5)
    state = np.random.default_rng(4).standard_normal((2,) + jm.state_shape).astype(np.float32)
    _close(tm.sample(torch.from_numpy(state)), jax.jit(jm.sample)(jnp.asarray(state)))
    gen = torch.Generator().manual_seed(1)
    assert tm.init_state(gen, 3).shape == (3,) + tm.state_shape
    dm = noise.DummyNoiseS2(IMG, 2)
    assert not dm.sample(dm.update(dm.init_state(gen, 2), gen)).any()


def test_build_noise_factory():
    cfg = {"type": "diffusion", "mode": "concatenate", "n_channels": 8, "centered": True, "sigma": 1.0, "lambd": 1.0, "grid_type": "equiangular"}
    tm, jm = noise.build_noise(cfg, IMG), jnoise.build_noise(cfg, IMG)
    assert isinstance(tm, noise.DiffusionNoiseS2) and tm.kT == jm.kT and tm.num_channels == 8
    assert (tm.lmax, tm.mmax) == (jm.lmax, jm.mmax)
    assert isinstance(noise.build_noise(dict(cfg, type="white"), IMG), noise.IsotropicGaussianRandomFieldS2)
    assert isinstance(noise.build_noise(dict(cfg, type="dummy"), IMG), noise.DummyNoiseS2)
    with pytest.raises(NotImplementedError):
        noise.build_noise(dict(cfg, type="pink"), IMG)
