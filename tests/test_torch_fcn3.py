"""makani_torch's FCN3 forecast path against makani_tpu's, on the CPU.

A small FCN3 (16x32, scale 2, two pressure levels, zenith plus two noise
channels) is initialised in JAX, its weights carried over with
``params_from_jax`` (a strict load), and both run the same seeded numpy
input. Two widths: a narrow one whose processor convs take the weight-fused
path (g*og*ig <= 4096) and a wider one whose processor takes the two-stage
path (responses, fp32 channel-mix GEMM, polar insert); and the narrow one
with every option the flagship leaves off (encoder/decoder MLPs, spectral
upsampling, the lmax cutoff, big skip, biases, instance norm, water-clamp
offsets). The whole model in fp32 agrees to 1e-4 * max|ref|; bf16 compute to
a relative L2 of 2e-2.

The ensemble forecast (``get_model`` + ``ModelWrapper`` + ``rollout`` with a
centered pair of diffusion-noise members, three steps) is held to the JAX
wrapper stepped the way the JAX inferencer draws its noise, both fed the
same seeded innovations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from makani_tpu.models import noise as jnoise
from makani_tpu.models.model_package import ModelWrapper as JModelWrapper
from makani_tpu.models.model_registry import count_channels as jcount_channels
from makani_tpu.models.model_registry import get_model as jget_model
from makani_tpu.models.networks.fourcastnet3 import AtmoSphericNeuralOperatorNet as JFCN3
from makani_tpu.models.preprocessor import Preprocessor2D as JPreprocessor2D
from makani_tpu.utils.yparams import ParamsBase as JParamsBase
from makani_tpu.utils.zenith_angle import cos_zenith_angle_from_timestamp

from makani_torch import kernels
from makani_torch.convert_jax import load_from_jax, params_from_jax
from makani_torch.device import resolve_device
from makani_torch.models import noise
from makani_torch.models.model_package import ModelWrapper, rollout
from makani_torch.models.model_registry import count_channels, get_model
from makani_torch.models.networks.fourcastnet3 import AtmoSphericNeuralOperatorNet
from makani_torch.utils.yparams import ParamsBase
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAMES = ("u10m", "v10m", "t2m", "tcwv", "u500", "v500", "q500", "u850", "v850", "q850")
AUX = ("xzen", "xnoise0", "xnoise1")
KW = dict(
    inp_shape=(16, 32), out_shape=(16, 32), scale_factor=2, channel_names=NAMES, aux_channel_names=AUX, num_layers=3,
    sfno_block_frequency=2, kernel_shape=(3, 3), filter_basis_type="morlet th", clamp_water=True,
)
NARROW = dict(atmo_embed_dim=6, surf_embed_dim=6, aux_embed_dim=4)
WIDE = dict(atmo_embed_dim=24, surf_embed_dim=16, aux_embed_dim=8)
# the FCN3 fields the flagship leaves at their defaults, all at once
OPTIONS = dict(
    NARROW, encoder_mlp=True, upsample_sht=True, theta_cutoff_mode="lmax", big_skip=True, use_bias=True, normalization_layer="instance_norm",
    water_means=np.linspace(0.1, 1.0, len(NAMES)), water_stds=np.linspace(0.5, 2.0, len(NAMES)),
)
WIDTHS = {"narrow": NARROW, "wide": WIDE, "options": OPTIONS}


def _jax_variables(init, *args):
    """Initialised flax variables as numpy, with the layer scales, biases and
    norm scales (constants at init) drawn at random so that they count."""
    variables = jax.tree.map(np.asarray, jax.jit(init)(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        name = path[-1].key
        if name == "gamma":
            return (0.1 + 0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "weight" and leaf.ndim == 1:
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.mark.parametrize("dtype,width", [("float32", "narrow"), ("float32", "wide"), ("bfloat16", "wide"), ("float32", "options")])
def test_fcn3_forward_matches_jax(dtype, width):
    kw = dict(KW, **WIDTHS[width])
    x = np.random.default_rng(0).standard_normal((2, len(NAMES) + len(AUX), 16, 32)).astype(np.float32)
    jmodel = JFCN3(dtype=getattr(jnp, dtype), **kw)
    variables = _jax_variables(jmodel.init, jnp.asarray(x))
    ref = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)), np.float32)

    model = load_from_jax(AtmoSphericNeuralOperatorNet(dtype=getattr(torch, dtype), device="cpu", **kw), variables)
    assert model.block1.local_conv.fused == (width != "wide")
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert not any(kernels.LAUNCHES.values())
    assert out.dtype == torch.float32 and out.shape == ref.shape
    out = out.numpy()
    if dtype == "float32":
        assert np.max(np.abs(out - ref)) <= 1e-4 * np.max(np.abs(ref))
    else:
        assert np.linalg.norm(out - ref) <= 2e-2 * np.linalg.norm(ref)


def test_fcn3_parameter_names_and_strict_load():
    kw = dict(KW, **NARROW)
    jmodel = JFCN3(**kw)
    variables = _jax_variables(jmodel.init, jnp.zeros((1, len(NAMES) + len(AUX), 16, 32)))
    sd = params_from_jax(variables)
    assert sd["atmo_encoder.conv.weight"].shape == (3, 2, 1, 9)
    assert sd["block1.local_conv.weight"].shape == (1, 22, 22, 9)
    assert sd["block0.global_conv.weight"].shape[:3] == (1, 22, 22)
    assert sd["block0.layer_scale.gamma"].shape == (1, 18, 1, 1)
    model = AtmoSphericNeuralOperatorNet(device="cpu", **kw)
    assert set(sd) == set(model.state_dict())
    del sd["surf_decoder.conv.weight"]
    with pytest.raises(RuntimeError):
        model.load_state_dict(sd, strict=True)


def _params(cls):
    return cls(
        dict(
            nettype="FCN3", img_shape_x=16, img_shape_y=32, scale_factor=2, channel_names=list(NAMES), in_channels=list(range(len(NAMES))),
            out_channels=list(range(len(NAMES))), add_zenith=True, n_history=0, num_layers=2, sfno_block_frequency=2, kernel_shape=[3, 3],
            filter_basis_type="morlet th", filter_basis_norm_mode="mean", normalization_layer="none", clamp_water=True, bias=False,
            atmo_embed_dim=6, surf_embed_dim=6, aux_embed_dim=4, compute_dtype="float32", dhours=6,
            input_noise=dict(type="diffusion", mode="concatenate", n_channels=2, centered=True, sigma=1.0, lambd=1.0),
        )
    )


def test_count_channels_and_default_device():
    """The noise channels count as inputs, as in the JAX package; and with no
    device named the port builds on the card (this CPU-only torch refuses)."""
    jp = _params(JParamsBase)
    assert count_channels(_params(ParamsBase)) == jcount_channels(jp, JPreprocessor2D(jp)) == (13, 10)
    assert resolve_device(None) == torch.device("cuda") and resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            get_model(_params(ParamsBase), multistep=True)
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            AtmoSphericNeuralOperatorNet(**KW, **NARROW)


def test_ensemble_rollout_matches_jax():
    """get_model(multistep=True) + ModelWrapper + rollout of one centered
    pair, three 6-hour steps, against the JAX wrapper fed the noise the JAX
    inferencer draws (init_state, sample, update per step), both from the
    same seeded innovations."""
    H, W, E, steps = 16, 32, 2, 3
    jmodel, _ = jget_model(_params(JParamsBase), multistep=True)
    variables = _jax_variables(jmodel.init, jnp.zeros((1, len(NAMES), H, W)), jnp.zeros((1, 1, 3, H, W)))
    model, _ = get_model(_params(ParamsBase), multistep=True, device="cpu")
    load_from_jax(model, variables)

    rng = np.random.default_rng(1)
    C = len(NAMES)
    bias = rng.standard_normal((1, C, 1, 1)).astype(np.float32)
    scale = (0.5 + rng.random((1, C, 1, 1))).astype(np.float32)
    x0 = (bias + scale * rng.standard_normal((1, C, H, W))).astype(np.float32)
    lat = 90.0 - 180.0 * np.arange(H) / (H - 1)
    lon = 360.0 * np.arange(W) / W
    t0 = 1.5e9
    cfg = dict(_params(ParamsBase).get("input_noise"), grid_type="equiangular")
    jn, tn = jnoise.build_noise(cfg, (H, W)), noise.build_noise(cfg, (H, W))
    draws = [rng.standard_normal((1, 1, 2, jn.lmax, jn.mmax, 2)).astype(np.float32) for _ in range(steps)]
    for mod, port in ((jn, False), (tn, True)):
        it = iter(draws)
        mod._innovation = lambda key, b, nt, mod=mod, it=it, port=port: (torch.from_numpy if port else jnp.asarray)(next(it) * np.asarray(mod.sigma_l))

    # the JAX reference, stepped as the JAX inferencer steps an ensemble
    jwrap = JModelWrapper(jmodel, variables, bias=bias, scale=scale)
    lon2d, lat2d = np.meshgrid(lon, lat)
    pred, state, ref = np.repeat(x0, E, axis=0), None, []
    for s in range(steps):
        state = jn.init_state(jax.random.PRNGKey(0), E // 2) if state is None else jn.update(state, jax.random.PRNGKey(s))
        eta = np.asarray(jn.sample(state))[:, 0]
        eta = np.stack([eta, -eta], axis=1).reshape(E, 2, H, W)
        zen = np.broadcast_to(cos_zenith_angle_from_timestamp(t0 + s * 6 * 3600.0, lon2d, lat2d).astype(np.float32), (E, 1, 1, H, W))
        pred = np.asarray(jwrap(jnp.asarray(pred), jnp.asarray(np.concatenate([zen, eta[:, None]], axis=2))))
        ref.append(pred)

    kernels.reset_launch_counts()
    frames = rollout(ModelWrapper(model, bias=bias, scale=scale), torch.from_numpy(x0), lat, lon, t0, 6, steps, noise=tn, ensemble_size=E, centered=True)
    assert not any(kernels.LAUNCHES.values())
    out, ref = torch.stack(frames).numpy(), np.stack(ref)
    assert out.shape == ref.shape == (steps, E, C, H, W) and np.isfinite(out).all()
    assert np.max(np.abs(out[:, 0] - out[:, 1])) > 1e-3
    assert np.max(np.abs(out - ref)) <= 1e-4 * np.max(np.abs(ref))
