"""makani_torch SFNO forecast path against makani_tpu's.

A small SFNO (24x48, scale 2, 5 channels, embed 16, 3 layers) is initialised
in JAX, its weights carried over with ``params_from_jax``, and both run the
same seeded numpy input. The whole model in fp32 agrees to 1e-4 * max|ref|
(the JAX package takes its matmul DFT on the CPU, the port ``torch.fft``);
bf16 compute to a relative L2 of 2e-2. The forecast path (``get_model`` +
``ModelWrapper``, three zenith steps) is held to the same fp32 bound.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from makani_tpu.models.model_package import ModelWrapper as JModelWrapper
from makani_tpu.models.model_registry import get_model as jget_model
from makani_tpu.models.networks.sfnonet import SphericalFourierNeuralOperatorNet as JSFNO

from makani_torch import kernels
from makani_torch.convert_jax import load_from_jax, params_from_jax
from makani_torch.models.model_package import ModelWrapper, rollout
from makani_torch.models.model_registry import get_model
from makani_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet

from testutils import get_default_parameters
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(inp_shape=(24, 48), out_shape=(24, 48), scale_factor=2, inp_chans=5, out_chans=5, embed_dim=16, num_layers=3)


def _jax_variables(model, *args):
    """Initialised flax variables as numpy (the init compiled as one
    program), with the biases and norm scales (zeros and ones at init) drawn
    at random so that they count."""
    variables = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        name = path[-1].key
        if name == "bias":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "weight" and leaf.ndim == 1:
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.fixture(scope="module")
def kw_variables():
    """The variables of ``JSFNO(**KW)``, initialised once: shared by its fp32
    and bf16 forwards (its parameters are fp32 at either compute dtype) and
    the strict-load test."""
    return _jax_variables(JSFNO(**KW), jnp.zeros((1, 5, 24, 48)))


@pytest.mark.parametrize(
    "dtype,extra",
    [
        ("float32", {}),
        ("float32", dict(operator_type="diagonal", pos_embed="direct", use_bias=True)),
        ("float32", dict(out_shape=(12, 24))),
        ("bfloat16", {}),
    ],
)
def test_sfno_forward_matches_jax(dtype, extra, request):
    kw = dict(KW, **extra)
    x = np.random.default_rng(0).standard_normal((2, 5, 24, 48)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jmodel = JSFNO(dtype=jdt, **kw)
    variables = _jax_variables(jmodel, jnp.asarray(x)) if extra else request.getfixturevalue("kw_variables")
    ref = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)), np.float32)

    model = load_from_jax(SphericalFourierNeuralOperatorNet(dtype=tdt, device="cpu", **kw), variables)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == tdt and out.shape == ref.shape
    out = out.float().numpy()
    if dtype == "float32":
        assert np.max(np.abs(out - ref)) <= 1e-4 * np.max(np.abs(ref))
    else:
        assert np.linalg.norm(out - ref) <= 2e-2 * np.linalg.norm(ref)


def test_params_from_jax_names_and_strict_load(kw_variables):
    sd = params_from_jax(kw_variables)
    assert sd["block0.filter_layer.filter.weight"].shape == (1, 16, 16, 12, 2)
    assert sd["encoder.hidden0.kernel"].shape == (1, 5, 16)
    model = SphericalFourierNeuralOperatorNet(device="cpu", **KW)
    assert set(sd) == set(model.state_dict())
    del sd["block1.norm0.bias"]
    with pytest.raises(RuntimeError):
        model.load_state_dict(sd, strict=True)


def test_forecast_rollout_matches_jax(tmp_path):
    """get_model(multistep=True) + ModelWrapper, 3 autoregressive 6-hour
    steps with the zenith angle recomputed per step, against the JAX
    package's wrapper and the example rollout."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    from inference_model_package import rollout as jrollout

    params = get_default_parameters(tmp_path, normalization_layer="instance_norm", img_shape_x=24, img_shape_y=48)
    H, W = 24, 48
    C = len(params["in_channels"])
    jmodel, _ = jget_model(copy.deepcopy(params), multistep=True)
    variables = _jax_variables(jmodel, jnp.zeros((1, C, H, W)), jnp.zeros((1, 1, 1, H, W)))

    rng = np.random.default_rng(1)
    bias = rng.standard_normal((1, C, 1, 1)).astype(np.float32)
    scale = (0.5 + rng.random((1, C, 1, 1))).astype(np.float32)
    x0 = (bias + scale * rng.standard_normal((1, C, H, W))).astype(np.float32)
    lat = 90.0 - 180.0 * np.arange(H) / (H - 1)
    lon = 360.0 * np.arange(W) / W
    t0 = 1.5e9

    ref = jrollout(JModelWrapper(jmodel, variables, bias=bias, scale=scale), x0[0], lat, lon, t0, 6, 3)

    model, pre = get_model(copy.deepcopy(params), multistep=True, device="cpu")
    assert pre.n_history == 0
    load_from_jax(model, variables)
    frames = rollout(ModelWrapper(model, bias=bias, scale=scale), torch.from_numpy(x0), lat, lon, t0, 6, 3)
    out = torch.stack(frames, 0)[:, 0].numpy()
    assert out.shape == ref.shape == (3, C, H, W) and np.isfinite(out).all()
    assert np.max(np.abs(out - ref)) <= 1e-4 * np.max(np.abs(ref))


def test_get_model_seeds_weights(tmp_path):
    params = get_default_parameters(tmp_path, normalization_layer="instance_norm")
    a, _ = get_model(copy.deepcopy(params), multistep=True, seed=3, device="cpu")
    b, _ = get_model(copy.deepcopy(params), multistep=True, seed=3, device="cpu")
    c, _ = get_model(copy.deepcopy(params), multistep=True, seed=4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["model.block0.filter_layer.filter.weight"], sc["model.block0.filter_layer.filter.weight"])
    with pytest.raises(NotImplementedError):
        get_model(get_default_parameters(tmp_path, normalization_layer="instance_norm", add_orography=True), device="cpu")


def test_plain_reference_switch_matches_kernel_route_on_cpu():
    model = SphericalFourierNeuralOperatorNet(device="cpu", **KW)
    x = torch.randn(1, 5, 24, 48)
    kernels.reset_launch_counts()
    with torch.no_grad():
        y1 = model(x)
        kernels.set_use_kernels(model, False)
        y2 = model(x)
    assert torch.equal(y1, y2)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert not any(m.use_kernels for m in model.modules() if hasattr(m, "use_kernels"))


def test_port_imports_no_jax():
    """Every makani_torch module imports (the training step's loss, optimizer
    and trainer among them), and an SFNO, an FCN3, an AFNO and a ViT forward
    and an SFNO training step run, without jax, flax or makani_tpu entering
    the process."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import makani_torch\n"
        "for m in pkgutil.walk_packages(makani_torch.__path__, 'makani_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from makani_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet\n"
        "net = SphericalFourierNeuralOperatorNet(inp_shape=(12, 24), out_shape=(12, 24), scale_factor=2, inp_chans=3, out_chans=3, embed_dim=8, num_layers=2, device='cpu')\n"
        "with torch.no_grad():\n"
        "    assert torch.isfinite(net(torch.randn(1, 3, 12, 24))).all()\n"
        "from makani_torch.models.networks.fourcastnet3 import AtmoSphericNeuralOperatorNet\n"
        "fcn3 = AtmoSphericNeuralOperatorNet(inp_shape=(17, 32), out_shape=(17, 32), scale_factor=2, channel_names=('t2m', 'u500', 'q500'), aux_channel_names=('xzen', 'xnoise0'), atmo_embed_dim=4, surf_embed_dim=4, aux_embed_dim=2, num_layers=2, sfno_block_frequency=2, filter_basis_type='morlet th', clamp_water=True, device='cpu')\n"
        "with torch.no_grad():\n"
        "    assert torch.isfinite(fcn3(torch.randn(1, 5, 17, 32))).all()\n"
        "from makani_torch.models.networks.afnonet import AdaptiveFourierNeuralOperatorNet\n"
        "from makani_torch.models.networks.vit import VisionTransformer\n"
        "afno = AdaptiveFourierNeuralOperatorNet(inp_shape=(17, 32), out_shape=(17, 32), patch_size=(4, 4), inp_chans=3, out_chans=2, embed_dim=8, num_layers=1, num_blocks=2, device='cpu')\n"
        "vit = VisionTransformer(inp_shape=(17, 32), out_shape=(17, 32), patch_size=(4, 4), inp_chans=3, out_chans=2, embed_dim=8, num_layers=1, num_heads=2, device='cpu')\n"
        "with torch.no_grad():\n"
        "    assert all(torch.isfinite(m(torch.randn(1, 3, 17, 32))).all() for m in (afno, vit))\n"
        "from makani_torch.models.model_registry import get_model\n"
        "from makani_torch.utils.loss import LossHandler\n"
        "from makani_torch.utils.training.deterministic_trainer import train_step\n"
        "from makani_torch.utils.training.optimizer import get_optimizer\n"
        "from makani_torch.utils.yparams import ParamsBase\n"
        "p = ParamsBase(dict(nettype='SFNO', img_shape_x=12, img_shape_y=24, scale_factor=2, embed_dim=8, num_layers=1, normalization_layer='instance_norm', channel_names=['a', 'b'], in_channels=[0, 1], out_channels=[0, 1], add_zenith=True, losses=[{'type': 'l2', 'parameters': {'squared': True}}], optimizer_nu_factored=True, optimizer_mu_dtype='bfloat16'))\n"
        "m, _ = get_model(p, multistep=True, device='cpu')\n"
        "loss = train_step(m, LossHandler(p), get_optimizer(p, m), torch.randn(1, 2, 12, 24), torch.randn(1, 2, 12, 24), torch.randn(1, 1, 1, 12, 24))\n"
        "assert torch.isfinite(loss)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'makani_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
