"""makani_torch's FCN3.1 forecast path against makani_tpu's, on the CPU.

The pieces, each against its JAX counterpart:
  * the lmax rule and the DISCO cutoff it gives (``compute_spherical_bandlimit``,
    ``fcn31_lmax``), at the published grids;
  * the DISCO tables of the ``harmonic`` and ``fourier-bessel`` bases under
    ``nodal`` normalization at that cutoff, bit-equal, on FCN3.1-like small
    grids and on one whose band is wider than 32 rows; K5's live-tap table
    held to the nonzero taps of the JAX package's psi;
  * ``MLPImputation`` with a NaN mask and with an explicit mask, and the
    constant and learned ``Imputer``;
  * a grouped two-stage ``DiscoConv`` (groups 2, g*og*ig > 4096, 23 input
    channels a group so that a group's responses are not a multiple of 4
    floats), forward and gradients, at 1e-5 of max|ref|.

And the whole model, through both packages' ``get_model(multistep=True)``:
a small FCN3.1 (16x32, scale 2, the recipe's 73 channels with ``sst`` in
place of ``u100m`` and a NaN patch in it, n_history 1, zenith plus two
centered diffusion-noise channels, 2 blocks of which block 0 spectral, the
harmonic basis under nodal normalization, sin activations, water clamping,
embed 64 so that the unified encoder is a grouped two-stage conv as at the
published history config (gcd(146, 64) = 2, 2*32*73 > 4096, 73*7 = 511
floats of responses a group) and the decoder and processor are two-stage
too, aux embed 4, pos embed 3). The port's seeded weights (layer scales,
biases and the latitude embedding drawn at random) go to the JAX model
(``params_to_jax``, its tree's names and shapes checked against the JAX
model's ``init``) and back by a strict load; fp32 agrees to 1e-4 * max|ref|,
bf16 compute to a relative L2 of 2e-2; a 3-step ensemble rollout
(``ModelWrapper`` + ``rollout`` with the 2-state window) to the JAX wrapper
stepped as the JAX inferencer steps a history window, both fed the same
seeded noise innovations. ``debug_fcn31`` raises naming ``instance_norm_s2``,
and the freeze labels of FCN3.1's tree match the JAX package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from makani_tpu.models import noise as jnoise
from makani_tpu.models.common.imputation import Imputer as JImputer
from makani_tpu.models.common.imputation import MLPImputation as JMLPImputation
from makani_tpu.models.model_package import ModelWrapper as JModelWrapper
from makani_tpu.models.model_registry import get_model as jget_model
from makani_tpu.models.networks import fourcastnet3_1 as jfcn31
from makani_tpu.models.networks.fourcastnet3 import DiscoConv as JDiscoConv
from makani_tpu.ops import disco as jdisco
from makani_tpu.utils.training.optimizer import _freeze_labels as jfreeze_labels
from makani_tpu.utils.yparams import ParamsBase as JParamsBase
from makani_tpu.utils.zenith_angle import cos_zenith_angle_from_timestamp

from makani_torch import kernels
from makani_torch.convert_jax import load_from_jax, params_from_jax, params_to_jax
from makani_torch.models import noise
from makani_torch.models.common.imputation import Imputer, MLPImputation
from makani_torch.models.model_package import ModelWrapper, rollout
from makani_torch.models.model_registry import get_model
from makani_torch.models.networks import fourcastnet3_1 as fcn31
from makani_torch.models.networks.fourcastnet3 import DiscoConv
from makani_torch.ops import disco
from makani_torch.utils.training.optimizer import freeze_labels
from makani_torch.utils.yparams import ParamsBase, YParams
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, E = 16, 32, 2
NAMES = tuple("sst" if n == "u100m" else n for n in YParams(os.path.join(REPO, "config", "fourcastnet3.yaml"), "base_config").channel_names)
C = len(NAMES)
SST = NAMES.index("sst")
T = 2  # n_history 1


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.max(np.abs(out - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("basis", ["harmonic", "fourier-bessel"])
def test_lmax_and_cutoff_match_jax(basis):
    """The published grids: lmax 90 at 0.25 degrees (scale 2), 45 at 0.5."""
    for shape, lmax in (((721, 1440), 90), ((361, 720), 45)):
        internal = (shape[0] // 2, shape[1] // 2)
        for grid in ("equiangular", "legendre-gauss"):
            assert fcn31.compute_spherical_bandlimit(shape, grid) == jfcn31.compute_spherical_bandlimit(shape, grid)
        got = fcn31.fcn31_lmax(shape, internal, "equiangular", "legendre-gauss", 0.25)
        assert got == lmax
        assert disco.compute_cutoff_radius_lmax(got, (3, 3), basis) == jdisco.compute_cutoff_radius_lmax(got, (3, 3), basis)
    assert fcn31.fcn31_lmax((16, 32), (8, 16), "equiangular", "legendre-gauss", 1.0, lmax=40) == 8


# (in, out, grids, lmax): FCN3.1's encoder, processor and decoder on a 16x32
# grid at hard_thresholding_fraction 1 (lmax 7), and a 65x128 grid whose
# band is wider than 32 rows
TABLE_CASES = {
    "encoder": ((16, 32), (8, 16), ("equiangular", "legendre-gauss"), 7),
    "processor": ((8, 16), (8, 16), ("legendre-gauss", "legendre-gauss"), 7),
    "decoder": ((16, 32), (16, 32), ("equiangular", "equiangular"), 7),
    "wide-band": ((65, 128), (65, 128), ("equiangular", "equiangular"), 10),
}


@pytest.mark.parametrize("case", list(TABLE_CASES))
@pytest.mark.parametrize("basis", ["harmonic", "fourier-bessel"])
def test_disco_tables_match_jax(basis, case):
    in_shape, out_shape, (gi, go), lmax = TABLE_CASES[case]
    ks = (3, 3)
    cut = disco.compute_cutoff_radius_lmax(lmax, ks, basis)
    args = (in_shape, out_shape, ks, gi, go, cut, "nodal", basis)
    t, j = disco._precompute_psi(*args), jdisco._precompute_psi(*args)
    assert set(t) == set(j)
    for key in t:
        assert np.array_equal(np.asarray(t[key]), np.asarray(j[key])), key
    assert t["psi_band"].shape[1] == 7 and np.all(t["init_mass"] > 0)
    if case == "wide-band":
        assert t["BL"] > 32, t["BL"]
    # K5's live taps: one run [lo, hi) per (h, j) that holds every nonzero
    # psi_k of the JAX package's table and starts and ends on one
    for p in range(j["phases"]):
        runs = disco.live_tap_runs(t["psi_band"][p])
        live = (j["psi_band"][p] != 0).any(axis=0)  # (Hout, BL, WW)
        w = np.arange(live.shape[-1])
        inside = (w >= runs[..., :1]) & (w < runs[..., 1:])
        assert not (live & ~inside).any()
        hh, jj = np.nonzero(runs[..., 1] > runs[..., 0])
        assert live[hh, jj, runs[hh, jj, 0]].all() and live[hh, jj, runs[hh, jj, 1] - 1].all()
        assert (runs[..., 1] > runs[..., 0]).sum() == live.any(axis=-1).sum()


@pytest.mark.parametrize("mask", ["nan", "explicit"])
def test_mlp_imputation_matches_jax(mask):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 8, 16)).astype(np.float32)
    x[:, 1, 2:5, 3:9] = np.nan
    x[0, 4, 6, 10] = np.nan  # a NaN outside the imputed channels
    m = (rng.random((2, 2, 8, 16)) > 0.7) if mask == "explicit" else None
    mod = MLPImputation(6, (1, 3), act_layer=torch.sin, device="cpu")
    with torch.no_grad():
        mod.mlp.hidden0.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(4)))
    jmod = JMLPImputation(inp_chans=6, impute_chans=(1, 3), act_layer=jnp.sin)
    ref = np.asarray(jax.jit(lambda v, a, b: jmod.apply(v, a, mask=b))(params_to_jax(mod), jnp.asarray(x), m))
    with torch.no_grad():
        out = mod(torch.from_numpy(x), mask=None if m is None else torch.from_numpy(m)).numpy()
    assert np.isfinite(out).all() and np.isfinite(ref).all()
    assert _rel(out, ref) <= 1e-5
    filled = np.isnan(x[:, [1, 3]]) | (m if m is not None else False)
    assert filled.sum() > 20 and np.array_equal(out[:, [1, 3]][~filled], x[:, [1, 3]][~filled])


@pytest.mark.parametrize("mode,append_mask", [("constant", False), ("learned", True)])
def test_imputer_matches_jax(mode, append_mask):
    x = np.random.default_rng(6).standard_normal((2, 3, 4, 8)).astype(np.float32)
    x[:, 1, 1:3, 2:5] = np.nan
    mod = Imputer(3, mode=mode, fill_value=0.5, append_mask=append_mask, device="cpu")
    if mode == "learned":
        with torch.no_grad():
            mod.fill.copy_(torch.tensor([0.1, -0.2, 0.3]).reshape(1, 3, 1, 1))
    jmod = JImputer(3, mode=mode, fill_value=0.5, append_mask=append_mask)
    ref = np.asarray(jmod.apply(params_to_jax(mod), jnp.asarray(x)))
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 6 if append_mask else 3, 4, 8)
    np.testing.assert_array_equal(out, ref)


def test_grouped_two_stage_disco_conv_matches_jax():
    """A stride-2 conv with polar rows, groups 2 of 23 -> 96 channels: the
    two-stage path group by group, forward and the gradients of x and w."""
    in_shape, out_shape = (17, 32), (9, 16)
    kw = dict(basis_type="harmonic", basis_norm_mode="nodal", grid_in="equiangular", grid_out="legendre-gauss", theta_cutoff=jdisco.compute_cutoff_radius_lmax(6, (3, 3), "harmonic"))
    jop = jdisco.DiscoConvS2(in_shape, out_shape, (3, 3), **kw)
    op = disco.DiscoConvS2(in_shape, out_shape, (3, 3), **kw)
    assert op.polar_rows and op.stride == 2
    g, ig, og = 2, 23, 96
    conv = DiscoConv(op, g * ig, g * og, groups=g, device="cpu")
    assert not conv.fused
    jconv = JDiscoConv(jop, g * ig, g * og, groups=g, channels_last=True)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, *in_shape, g * ig)).astype(np.float32)
    dy = rng.standard_normal((2, *out_shape, g * og)).astype(np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(jconv.init)(jax.random.PRNGKey(1), jnp.asarray(x)))

    @jax.jit
    def fwd_bwd(v, a, d):
        y, vjp = jax.vjp(jconv.apply, v, a)
        return (y, *vjp(d))

    ref, jdv, jdx = fwd_bwd(variables, jnp.asarray(x), jnp.asarray(dy))
    load_from_jax(conv, variables)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = conv(xt)
    out.backward(torch.from_numpy(dy))
    assert _rel(out.detach().numpy(), ref) <= 1e-5
    assert _rel(xt.grad.numpy(), jdx) <= 1e-5
    assert _rel(conv.weight.grad.numpy(), jdv["params"]["weight"]) <= 1e-5


def _params(cls, compute_dtype="float32", **over):
    return cls(
        dict(
            nettype="FCN3.1", img_shape_x=H, img_shape_y=W, scale_factor=2, channel_names=list(NAMES), in_channels=list(range(C)),
            out_channels=list(range(C)), add_zenith=True, n_history=1, num_layers=2, sfno_block_frequency=2, kernel_shape=[3, 3],
            filter_basis_type="harmonic", filter_basis_norm_mode="nodal", activation_function="sin", normalization_layer="none", clamp_water=True,
            bias=False, encoder_bias=False, embed_dim=64, aux_embed_dim=4, pos_embed_dim=3, hard_thresholding_fraction=1.0,
            compute_dtype=compute_dtype, dhours=6, input_noise=dict(type="diffusion", mode="concatenate", n_channels=2, centered=True, sigma=1.0, lambd=1.0),
            **over,
        )
    )


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _variables(jmodel, model):
    """The port model's seeded weights, with the layer scales, biases and
    the latitude embedding (constants at init) drawn at random, as a flax
    tree whose names and shapes are the JAX model's."""
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                p.copy_(torch.from_numpy(0.1 + 0.05 * rng.standard_normal(p.shape)))
            elif leaf in ("bias", "pos_embed"):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape)))
    variables = params_to_jax(model)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, T * C, H, W)), jnp.zeros((1, T, 3, H, W)))
    assert {k: tuple(v.shape) for k, v in _flat(shapes).items()} == {k: v.shape for k, v in _flat(variables).items()}
    return variables


def _inputs(seed):
    """A normalized window (E, T*C, H, W) with a NaN patch in both sst
    copies, and its zenith + noise channels (E, T, 3, H, W)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((E, T * C, H, W)).astype(np.float32)
    x[:, [SST, C + SST], 5:9, 10:20] = np.nan
    z = np.concatenate([r.uniform(-1.0, 1.0, (E, T, 1, H, W)), r.standard_normal((E, T, 2, H, W))], axis=2).astype(np.float32)
    return x, z


@pytest.fixture(scope="module")
def fp32_pair():
    """Both packages' fp32 model from the same weights, the JAX one behind
    its ``ModelWrapper`` (one compile, shared by the forward and the
    rollout), with seeded stats tiled over the window."""
    jmodel, _ = jget_model(_params(JParamsBase), multistep=True)
    model, _ = get_model(_params(ParamsBase), multistep=True, device="cpu")
    variables = _variables(jmodel, model)
    rng = np.random.default_rng(1)
    bias = rng.standard_normal((1, C, 1, 1)).astype(np.float32)
    scale = (0.5 + rng.random((1, C, 1, 1))).astype(np.float32)
    jwrap = JModelWrapper(jmodel, variables, bias=np.tile(bias, (1, T, 1, 1)), scale=np.tile(scale, (1, T, 1, 1)))
    return dict(jmodel=jmodel, variables=variables, model=model, jwrap=jwrap, bias=bias, scale=scale)


def test_parameter_names_and_strict_load(fp32_pair):
    sd = params_from_jax(fp32_pair["variables"])
    net = fp32_pair["model"].model
    assert sd["model.pos_embed"].shape == (1, 3, H // 2, 1)
    assert sd["model.encoder.conv.weight"].shape == (2, 32, C, 7) and not net.encoder.conv.fused
    assert sd["model.decoder.conv.weight"].shape == (1, C, 64, 7) and not net.decoder.conv.fused
    assert sd["model.block1.local_conv.weight"].shape == (1, 71, 71, 7) and not net.block1.local_conv.fused
    assert sd["model.aux_encoder.conv.weight"].shape == (2, 2, 3, 7) and net.aux_encoder.conv.fused
    assert sd["model.sst_imputation.mlp.hidden0.kernel"].shape == (1, T * C + T * 3, 2 * T)
    model, _ = get_model(_params(ParamsBase), multistep=True, device="cpu", seed=1)
    load_from_jax(model, fp32_pair["variables"])
    for n, p in model.state_dict().items():
        assert torch.equal(p, fp32_pair["model"].state_dict()[n]), n
    del sd["model.pos_embed"]
    with pytest.raises(RuntimeError):
        model.load_state_dict(sd, strict=True)


def test_forward_fp32_matches_jax(fp32_pair):
    x, z = _inputs(11)
    ref = np.asarray(fp32_pair["jwrap"]._apply(fp32_pair["variables"], jnp.asarray(x), jnp.asarray(z)))
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = fp32_pair["model"](torch.from_numpy(x), torch.from_numpy(z)).numpy()
    assert not any(kernels.LAUNCHES.values())
    assert out.shape == ref.shape == (E, C, H, W) and np.isfinite(out).all()
    assert _rel(out, ref) <= 1e-4


def test_forward_bf16_matches_jax(fp32_pair):
    x, z = _inputs(12)
    jmodel, _ = jget_model(_params(JParamsBase, "bfloat16"), multistep=True)
    ref = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(fp32_pair["variables"], jnp.asarray(x), jnp.asarray(z)), np.float32)
    model, _ = get_model(_params(ParamsBase, "bfloat16"), multistep=True, device="cpu")
    load_from_jax(model, fp32_pair["variables"])
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(z)).float().numpy()
    assert np.isfinite(out).all()
    assert np.linalg.norm(out - ref) <= 2e-2 * np.linalg.norm(ref)


def test_history_rollout_matches_jax(fp32_pair):
    """get_model + ModelWrapper + rollout of one centered pair from a
    2-state window, three 6-hour steps, against the JAX wrapper fed the
    window, each state's zenith angle and the noise sequence the JAX
    inferencer draws (init_state, then update; step s reads fields s and
    s + 1), both from the same seeded innovations."""
    steps = 3
    rng = np.random.default_rng(5)
    bias, scale = fp32_pair["bias"], fp32_pair["scale"]
    x0 = (np.tile(bias, (1, T, 1, 1)) + np.tile(scale, (1, T, 1, 1)) * rng.standard_normal((1, T * C, H, W))).astype(np.float32)
    lat = 90.0 - 180.0 * np.arange(H) / (H - 1)
    lon = 360.0 * np.arange(W) / W
    t0 = 1.5e9
    cfg = dict(_params(ParamsBase).get("input_noise"), grid_type="equiangular")
    jn, tn = jnoise.build_noise(cfg, (H, W)), noise.build_noise(cfg, (H, W))
    draws = [rng.standard_normal((1, 1, 2, jn.lmax, jn.mmax, 2)).astype(np.float32) for _ in range(steps + T - 1)]
    for mod, port in ((jn, False), (tn, True)):
        it = iter(draws)
        mod._innovation = lambda key, b, nt, mod=mod, it=it, port=port: (torch.from_numpy if port else jnp.asarray)(next(it) * np.asarray(mod.sigma_l))

    state, fields = None, []
    for k in range(steps + T - 1):
        state = jn.init_state(jax.random.PRNGKey(0), E // 2) if state is None else jn.update(state, jax.random.PRNGKey(k))
        eta = np.asarray(jn.sample(state))[:, 0]
        fields.append(np.stack([eta, -eta], axis=1).reshape(E, 2, H, W))
    lon2d, lat2d = np.meshgrid(lon, lat)
    window, ref = np.repeat(x0, E, axis=0), []
    for s in range(steps):
        t = t0 + s * 6 * 3600.0
        zen = np.stack([cos_zenith_angle_from_timestamp(t - (T - 1 - k) * 6 * 3600.0, lon2d, lat2d) for k in range(T)]).astype(np.float32)
        unp = np.concatenate([np.broadcast_to(zen[None, :, None], (E, T, 1, H, W)), np.stack(fields[s : s + T], axis=1)], axis=2)
        pred = np.asarray(fp32_pair["jwrap"](jnp.asarray(window), jnp.asarray(unp)))
        window = np.concatenate([window[:, C:], pred], axis=1)
        ref.append(pred)

    kernels.reset_launch_counts()
    wrapper = ModelWrapper(fp32_pair["model"], bias=bias, scale=scale)
    frames = rollout(wrapper, torch.from_numpy(x0), lat, lon, t0, 6, steps, noise=tn, ensemble_size=E, centered=True)
    assert not any(kernels.LAUNCHES.values())
    out, ref = torch.stack(frames).numpy(), np.stack(ref)
    assert out.shape == ref.shape == (steps, E, C, H, W) and np.isfinite(out).all()
    assert np.max(np.abs(out[:, 0] - out[:, 1])) > 1e-3
    assert _rel(out, ref) <= 1e-4


def test_freeze_labels_match_jax(fp32_pair):
    tree = fp32_pair["variables"]["params"]
    names = list(params_from_jax(tree))
    assert names == [n for n, _ in fp32_pair["model"].named_parameters()]
    for enc, proc in ((True, False), (False, True), (True, True)):
        ref = _flat(jfreeze_labels(tree, enc, proc))
        assert freeze_labels(names, enc, proc) == ref
    labels = freeze_labels(names, True, False)
    assert labels["model.pos_embed"] == labels["model.sst_imputation.mlp.out.kernel"] == "train" and labels["model.encoder.conv.weight"] == "frozen"


def test_debug_fcn31_raises_on_instance_norm_s2():
    params = YParams(os.path.join(REPO, "config", "debug.yaml"), "debug_fcn31")
    assert params.nettype == "FCN3.1" and params.normalization_layer == "instance_norm_s2"
    with pytest.raises(NotImplementedError, match="instance_norm_s2"):
        get_model(params, multistep=True, device="cpu")
