"""makani_torch's AFNO models (FourCastNet v1 and AFNOv2) against makani_tpu's,
on the CPU.

The pieces:
  * the spectral mixers ``AFNO2D`` (channels-last, biases, the centered band)
    and ``AFNO2Dv2`` (the JAX module channels-first, the port's channels-last;
    no inner bias, the two-sided band), forward and ``jax.vjp`` of their
    input and every parameter, at ``hard_thresholding_fraction`` 1.0 and 0.5
    and lambda 0.01;
  * K19's plain version (the gradient formula on K18's saved o1 and output,
    which ``chip_smoke.py`` holds the kernel to) against autograd through the
    plain forward, in both layouts, and K18's plain hidden o1 layout;
  * ``complex_relu_s``, ``PatchEmbed2D``, ``PatchRecovery2D`` and
    ``ChannelLayerNorm`` against their JAX counterparts;
  * the whole models through both packages' ``get_model(multistep=True)``,
    2 layers on a 17 x 32 grid with patch 4 (rows cropped to 16 and padded
    back), embed 16 in 4 blocks of 4, 3 channels + zenith: FourCastNet v1,
    AFNOv2 with ``skip_fno`` linear and instance norm, and AFNOv2 with
    ``skip_fno`` identity, ``nested_skip_fno`` off and the channel layer
    norm at fraction 0.5. The port's seeded weights go to JAX
    (``params_to_jax``, the tree's names and shapes checked against
    ``jax.eval_shape`` of the JAX init) and back by ``load_from_jax(strict=True)``.
    fp32: the forecast within 1e-5 of max|ref|, and one training step
    (``train=True``, the l2 squared loss) with the loss within 1e-5 relative
    and each gradient leaf within 1e-4 of its max|ref|; ``train_step`` takes
    the same step. bf16 compute: the forecast within a relative L2 of 2e-2.
  * ``get_model`` builds ``afno_26ch``, ``afno_73ch`` and ``afnov2_73ch``
    from config/afnonet.yaml at their widths (no forward).

Each JAX function is jitted once a configuration: the fp32 forecast, loss and
gradients in one program, the bf16 forecast in another. The JAX package
takes its DFT as a matmul on the CPU, the port ``torch.fft``.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from makani_tpu.models.model_registry import get_model as jget_model
from makani_tpu.models.networks import afnonet as jafno
from makani_tpu.models.networks import afnonet_v2 as jafno2
from makani_tpu.utils.loss import LossHandler as JLossHandler
from makani_tpu.utils.yparams import ParamsBase as JParamsBase

from makani_torch import kernels
from makani_torch.convert_jax import load_from_jax, params_to_jax
from makani_torch.models.model_registry import get_model
from makani_torch.models.networks.afnonet import AFNO2D
from makani_torch.models.networks.afnonet_v2 import AFNO2Dv2
from makani_torch.ops import afno_mixer as am
from makani_torch.utils.loss import LossHandler
from makani_torch.utils.training.deterministic_trainer import train_step
from makani_torch.utils.training.optimizer import get_optimizer
from makani_torch.utils.yparams import ParamsBase, YParams
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, C, B = 17, 32, 3, 2


def rel_max(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.max(np.abs(out - ref)) / np.max(np.abs(ref))


def rel_l2(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.linalg.norm(out - ref) / np.linalg.norm(ref)


def token_params(nettype: str, compute_dtype: str = "float32", **over) -> dict:
    """A small token model's config: 17 x 32, patch 4, 3 channels + zenith,
    embed 16 (4 blocks of 4, 4 heads), 2 layers, the l2 squared loss."""
    base = dict(
        nettype=nettype,
        img_shape_x=H,
        img_shape_y=W,
        patch_size=[4, 4],
        embed_dim=16,
        num_layers=2,
        num_blocks=4,
        num_heads=4,
        mlp_ratio=2.0,
        sparsity_threshold=0.01,
        hard_thresholding_fraction=1.0,
        channel_names=[f"ch{i}" for i in range(C)],
        in_channels=list(range(C)),
        out_channels=list(range(C)),
        n_history=0,
        add_zenith=True,
        compute_dtype=compute_dtype,
        losses=[{"type": "l2", "channel_weights": "constant", "parameters": {"squared": True}}],
        lr=1e-3,
    )
    base.update(over)
    return base


def batch(seed: int = 3):
    r = np.random.default_rng(seed)
    inp = r.standard_normal((B, C, H, W)).astype(np.float32)
    tar = r.standard_normal((B, C, H, W)).astype(np.float32)
    zen = r.uniform(-1.0, 1.0, (B, 1, 1, H, W)).astype(np.float32)
    return inp, tar, zen


def perturb(model, seed: int = 7):
    """Make every leaf count: the spectral weights 10 times their init (so
    that the soft-shrink keeps part of the spectrum), the biases drawn at
    random and the norms' scales about 1."""
    r = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if ".filter.w" in name:
                p.mul_(10.0)
            elif leaf in ("bias", "b1", "b2"):
                p.copy_(torch.from_numpy(0.1 * r.standard_normal(tuple(p.shape)).astype(np.float32)))
            elif leaf in ("weight", "scale") and p.dim() == 1:
                p.copy_(torch.from_numpy(1.0 + 0.1 * r.standard_normal(tuple(p.shape)).astype(np.float32)))


def tree_shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


def run_model(cfg: dict, zero_grads=()) -> dict:
    """Both packages' model on one config: the port's seeded weights carried
    to JAX; the forecast (eval) of both, and in fp32 the training step's loss
    and gradients (by name, numpy). Checks the JAX init's tree and the strict
    load on the way."""
    fp32 = cfg["compute_dtype"] == "float32"
    inp, tar, zen = batch()
    model, _ = get_model(ParamsBase(copy.deepcopy(cfg)), multistep=True, device="cpu", seed=5)
    perturb(model)
    jmodel, _ = jget_model(JParamsBase(copy.deepcopy(cfg)), multistep=True)
    variables = params_to_jax(model)
    jshapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(inp), jnp.asarray(zen))
    assert tree_shapes(jshapes) == tree_shapes(variables)
    twin, _ = get_model(ParamsBase(copy.deepcopy(cfg)), multistep=True, device="cpu", seed=6)
    load_from_jax(twin, variables)
    loaded = all(torch.equal(a, b) for a, b in zip(model.parameters(), twin.parameters()))

    x, t, z = map(torch.from_numpy, (inp, tar, zen))
    out = {"loaded": loaded, "names": [n for n, _ in model.named_parameters()]}
    if fp32:
        jloss = JLossHandler(JParamsBase(copy.deepcopy(cfg)))

        @jax.jit
        def jstep(p, x, t, z):
            def f(q):
                pred = jmodel.apply(q, x, z, train=True)
                return jloss(pred, t, inp=x, train=True), pred

            (loss, pred), grads = jax.value_and_grad(f, has_aux=True)(p)
            return pred, loss, grads

        jpred, jl, jg = jax.tree.map(np.asarray, jstep(variables, inp, tar, zen))
        loss_obj = LossHandler(ParamsBase(copy.deepcopy(cfg)))
        pred = model(x, z, train=True)
        loss = loss_obj(pred, t, inp=x, train=True)
        loss.backward()
        out.update(
            pred=(pred.detach().numpy(), jpred),
            loss=(loss.item(), float(jl)),
            grads=({n: p.grad.numpy().copy() for n, p in model.named_parameters()}, {n: np.asarray(v) for n, v in _flat(jg["params"]).items()}),
        )
        # train_step takes the same step
        opt = get_optimizer(ParamsBase(copy.deepcopy(cfg)), twin)
        out["train_step_loss"] = train_step(twin, loss_obj, opt, x, t, z).item()
    else:
        jpred = np.asarray(jax.jit(jmodel.apply)(variables, inp, zen)).astype(np.float32)
        with torch.no_grad():
            pred = model(x, z).float().numpy()
        out["pred"] = (pred, jpred)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def check_model_run(res: dict, fp32: bool, zero_grads=()):
    """The tolerances of the module docstring; ``zero_grads``: name endings
    of leaves whose gradient is zero in exact arithmetic, held to 1e-5 of
    the largest gradient instead."""
    assert res["loaded"]
    pred, jpred = res["pred"]
    assert np.isfinite(pred).all()
    assert np.all(pred[:, :, 16:] == 0) and np.all(jpred[:, :, 16:] == 0)
    if not fp32:
        assert rel_l2(pred, jpred) <= 2e-2
        return
    assert rel_max(pred, jpred) <= 1e-5
    loss, jl = res["loss"]
    assert abs(loss - jl) <= 1e-5 * abs(jl)
    assert res["train_step_loss"] == loss
    grads, ref = res["grads"]
    assert set(grads) == set(ref) == set(res["names"])
    largest = max(np.abs(r).max() for r in ref.values())
    for name, g in grads.items():
        if name.endswith(tuple(zero_grads)):
            assert max(np.abs(g).max(), np.abs(ref[name]).max()) <= 1e-5 * largest, name
        else:
            assert rel_max(g, ref[name]) <= 1e-4, name


# ---------------------------------------------------------------------------
# the mixers


@pytest.mark.parametrize("version", [1, 2])
def test_mixer_matches_jax(version):
    """``AFNO2D`` / ``AFNO2Dv2`` (8 x 12 tokens of 16 channels in 4 blocks,
    weights 10 times their init so that the soft-shrink keeps part of the
    spectrum) against the JAX module at fractions 1.0 and 0.5: the output
    within 1e-5, the input's and every parameter's VJP within 1e-4 of max|ref|."""
    Bm, Hm, Wm, Cm, nb = 2, 8, 12, 16, 4
    cls, jcls = (AFNO2D, jafno.AFNO2D) if version == 1 else (AFNO2Dv2, jafno2.AFNO2Dv2)
    # the JAX v2 module is channels-first
    to_j = (lambda a: a) if version == 1 else (lambda a: jnp.transpose(a, (0, 3, 1, 2)))
    from_j = (lambda a: a) if version == 1 else (lambda a: np.transpose(a, (0, 2, 3, 1)))
    r = np.random.default_rng(version)
    for fraction in (1.0, 0.5):
        mod = cls(Cm, nb, 0.01, fraction, device="cpu")
        mod.reset_parameters(torch.Generator().manual_seed(11))
        with torch.no_grad():
            for p in mod.parameters():
                p.mul_(10.0)
        jmod = jcls(Cm, num_blocks=nb, sparsity_threshold=0.01, hard_thresholding_fraction=fraction)
        x = r.standard_normal((Bm, Hm, Wm, Cm)).astype(np.float32)
        g = r.standard_normal((Bm, Hm, Wm, Cm)).astype(np.float32)

        @jax.jit
        def jvjp(v, x, g):
            y, f = jax.vjp(lambda v, x: jmod.apply(v, to_j(x)), v, x)
            return y, f(to_j(g))

        jy, (jgv, jgx) = jax.tree.map(np.asarray, jvjp(params_to_jax(mod), x, g))
        xt = torch.from_numpy(x).requires_grad_(True)
        y = mod(xt)
        y.backward(torch.from_numpy(g))
        assert rel_max(y.detach().numpy(), from_j(jy)) <= 1e-5, fraction
        assert rel_max(xt.grad.numpy(), jgx) <= 1e-4, fraction
        ref = _flat(jgv["params"])
        for name, p in mod.named_parameters():
            assert np.abs(ref[name]).max() > 0, (fraction, name)
            assert rel_max(p.grad.numpy(), ref[name]) <= 1e-4, (fraction, name)


def test_grad_formula_matches_autograd():
    """K19's plain version on K18's saved o1 and output equals autograd
    through the plain forward (v1's biases and band at fraction 0.5; v2's
    band at hidden factor 2), on a contiguous spectrum and on the
    channels-last view of a channels-first storage that the rFFT gives, and
    K18's plain o1 is the relu of the first product in the (B, nb, H Wh, hbs,
    2) layout."""
    gen = torch.Generator().manual_seed(2)
    Bm, Hm, Wh, nb, bs = 2, 6, 5, 3, 4
    for channels_first_storage in (False, True):
        for hf, biases, band in ((1, True, am.band_v1(Hm, Wh, 0.5)), (2, False, am.band_v2(Hm, Wh, 0.7))):
            hbs = bs * hf
            x = torch.randn(Bm, Hm, Wh, nb * bs, 2, generator=gen)
            if channels_first_storage:
                x = x.permute(0, 3, 1, 2, 4).contiguous().permute(0, 2, 3, 1, 4)
            w1, w2 = torch.randn(nb, 2, bs, hbs, generator=gen), torch.randn(nb, 2, hbs, bs, generator=gen)
            b1 = torch.randn(nb, 2, hbs, generator=gen) if biases else None
            b2 = torch.randn(nb, 2, bs, generator=gen) if biases else None
            y, h = am.afno_mixer_plain(x, w1, b1, w2, b2, 0.01, band, return_hidden=True)
            assert h.shape == (Bm, nb, Hm * Wh, hbs, 2) and (h >= 0).all()
            xr = x.reshape(Bm, Hm, Wh, nb, bs, 2)
            o1r = torch.einsum("bhwki,kio->bkhwo", xr[..., 0], w1[:, 0]) - torch.einsum("bhwki,kio->bkhwo", xr[..., 1], w1[:, 1])
            if biases:
                o1r = o1r + b1[:, 0][None, :, None, None]
            assert torch.allclose(h[..., 0], torch.relu(o1r).reshape(Bm, nb, Hm * Wh, hbs), atol=1e-5)
            dy = torch.randn(y.shape, generator=gen)
            got = am.afno_mixer_grad_plain(x, y, dy, h, w1, b1, w2, b2)
            leaves = [t.clone().requires_grad_(True) if t is not None else None for t in (x, w1, b1, w2, b2)]
            am.afno_mixer_plain(*leaves, 0.01, band).backward(dy)
            for out, leaf in zip(got, leaves):
                if leaf is None:
                    assert out is None
                else:
                    assert torch.allclose(out, leaf.grad, rtol=1e-5, atol=1e-5 * leaf.grad.abs().max().item())


def test_mixer_wrapper_routes_and_bands():
    """On CPU tensors the wrapper is the plain version and launches nothing;
    the bands are the JAX modules' index sets."""
    x = torch.randn(1, 8, 7, 8, 2)
    w1, w2 = torch.randn(2, 2, 4, 4), torch.randn(2, 2, 4, 4)
    kernels.reset_launch_counts()
    band = am.band_v2(8, 7, 0.5)
    assert torch.equal(am.afno_mixer(x, w1, None, w2, None, 0.01, band), am.afno_mixer_plain(x, w1, None, w2, None, 0.01, band))
    assert not any(kernels.LAUNCHES.values())
    assert am.band_v1(8, 7, 1.0).full(8, 7) and am.band_v2(8, 7, 1.0).full(8, 7)
    # v1: rows [total - kept, total + kept) about total = H // 2 + 1, kept columns; v2: both ends
    assert am.band_v1(8, 7, 0.5) == am.Band(3, 7, 0, 0, 2)
    assert am.band_v2(8, 7, 0.5) == am.Band(0, 2, 6, 8, 3)
    mask = am.band_v2(8, 7, 0.5).mask(8, 7, "cpu")
    assert mask.sum().item() == 4 * 3 and mask[0, 0] and mask[7, 2] and not mask[2, 0] and not mask[0, 3]


def test_common_layers_match_jax():
    """``complex_relu_s`` in its four modes, ``PatchEmbed2D`` (NCHW in JAX,
    channels-last tokens in the port; flattened too), ``PatchRecovery2D`` and
    ``ChannelLayerNorm`` (NCHW) against the JAX functions and modules, eager,
    fp32, within 1e-5 of max|ref|."""
    from makani_tpu.models.common import activations as jact
    from makani_tpu.models.common import layer_norm as jln
    from makani_tpu.models.common import layers as jlayers

    from makani_torch.models.common.activations import complex_relu_s
    from makani_torch.models.common.layer_norm import ChannelLayerNorm
    from makani_torch.models.common.layers import PatchEmbed2D, PatchRecovery2D

    r = np.random.default_rng(4)
    z = r.standard_normal((3, 5, 2)).astype(np.float32)
    for mode in ("real", "cartesian", "modulus", "halfplane"):
        ref = np.asarray(jact.complex_relu_s(jnp.asarray(z), mode=mode, negative_slope=0.1, bias=0.2))
        assert rel_max(complex_relu_s(torch.from_numpy(z), mode=mode, negative_slope=0.1, bias=0.2).numpy(), ref) <= 1e-5, mode
    x = r.standard_normal((2, 3, 8, 12)).astype(np.float32)
    for flatten in (False, True):
        mod = PatchEmbed2D(3, (4, 4), 6, flatten=flatten, device="cpu")
        with torch.no_grad():
            mod.bias.normal_()
        ref = np.asarray(jlayers.PatchEmbed2D((4, 4), 6, flatten=flatten).apply(params_to_jax(mod), jnp.asarray(x)))
        out = mod(torch.from_numpy(x)).detach().numpy()
        assert rel_max(out if flatten else out.transpose(0, 3, 1, 2), ref) <= 1e-5
    e = r.standard_normal((2, 6, 2, 3)).astype(np.float32)
    rec = PatchRecovery2D(6, (4, 4), 3, device="cpu")
    ref = np.asarray(jlayers.PatchRecovery2D((4, 4), 3).apply(params_to_jax(rec), jnp.asarray(e)))
    assert rel_max(rec(torch.from_numpy(e)).detach().numpy(), ref) <= 1e-5
    cln = ChannelLayerNorm(3, device="cpu")
    with torch.no_grad():
        cln.weight.normal_()
        cln.bias.normal_()
    ref = np.asarray(jln.ChannelLayerNorm(3).apply(params_to_jax(cln), jnp.asarray(x)))
    assert rel_max(cln(torch.from_numpy(x)).detach().numpy(), ref) <= 1e-5


# ---------------------------------------------------------------------------
# the models

MODELS = {
    "afno": dict(nettype="AFNO"),
    "afnov2": dict(nettype="AFNOv2", skip_fno="linear", nested_skip_fno=True, normalization_layer="instance_norm"),
    "afnov2-identity-layer_norm": dict(nettype="AFNOv2", skip_fno="identity", nested_skip_fno=False, normalization_layer="layer_norm", hard_thresholding_fraction=0.5),
}
# AFNOv2 with a nested skip and instance norm: the filter's bias, the linear
# skip's bias and norm1's bias (a per-channel constant reaches only the DC
# mode, whose inverse transform is a constant again) reach the loss only
# through norm2, which removes any per-channel constant
ZERO_GRADS = {"afnov2": ("filter.b1", "skip_layer.bias", "norm1.bias")}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    """The model in fp32 (forecast, loss and gradients, ``train_step``) and
    in bf16 compute (forecast) against the JAX model on the port's weights,
    and the flax tree's names."""
    for dtype in ("float32", "bfloat16"):
        res = run_model(token_params(compute_dtype=dtype, **MODELS[name]))
        check_model_run(res, dtype == "float32", ZERO_GRADS.get(name, ()))
    names = set(res["names"])
    assert {"model.patch_embed.kernel", "model.patch_embed.bias", "model.pos_embed", "model.head.kernel"} <= names
    if name == "afno":
        assert {"model.block1.LayerNorm_0.scale", "model.block1.filter.w1", "model.block1.filter.b2", "model.block1.mlp.Dense_1.kernel"} <= names
    else:
        assert {"model.block1.norm1.weight", "model.block1.filter.w1", "model.block1.filter.b1", "model.block1.mlp.fc2.kernel"} <= names
        assert ("model.block0.skip_layer.kernel" in names) == (MODELS[name]["skip_fno"] == "linear")


def check_published_config(path: str, config: str):
    """``get_model`` builds a published recipe on the CPU (no forward), the
    input and output channels filled as the training CLIs fill them (the trees'
    names against the JAX models' are checked at the small sizes above).
    Returns the parameters by name."""
    params = YParams(path, config)
    n = len(params.channel_names)
    params["in_channels"] = params["out_channels"] = list(range(n))
    model, _ = get_model(params, multistep=True, device="cpu")
    sd = dict(model.named_parameters())
    assert all(p.dtype == torch.float32 and p.device.type == "cpu" for p in sd.values())
    assert tuple(sd["model.patch_embed.kernel"].shape)[0] == (n + 1) * int(np.prod(params.patch_size))
    assert tuple(sd["model.head.kernel"].shape)[-1] == n * int(np.prod(params.patch_size))
    return sd


def test_published_configs_build_at_full_width():
    """``afno_26ch``, ``afno_73ch`` and ``afnov2_73ch``: embed 768 in 8 blocks
    of 96 on the 90 x 180 token grid of patch 8, 12 layers."""
    for config in ("afno_26ch", "afno_73ch", "afnov2_73ch"):
        sd = check_published_config(os.path.join(REPO, "config", "afnonet.yaml"), config)
        assert len([k for k in sd if k.endswith("filter.w1")]) == 12
        v1 = config.startswith("afno_")
        assert tuple(sd["model.block0.filter.w1"].shape) == ((2, 8, 96, 96) if v1 else (8, 96, 96, 2))
        assert tuple(sd["model.pos_embed"].shape) == ((1, 90, 180, 768) if v1 else (1, 768, 90, 180))
