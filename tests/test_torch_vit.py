"""makani_torch's ViT baseline against makani_tpu's, on the CPU.

A small ViT through both packages' ``get_model(multistep=True)`` (17 x 32,
patch 4, rows cropped to 16 and padded back, 3 channels + zenith, embed 16,
4 heads of 4, 2 layers; ``tests/test_torch_afno.token_params``), the port's
seeded weights carried to JAX (the tree checked against ``jax.eval_shape`` of
the JAX init, and back by ``load_from_jax(strict=True)``): fp32 forecast
within 1e-5 of max|ref|, one training step's loss within 1e-5 relative and
every gradient leaf within 1e-4 of its max|ref| (``train_step`` takes the
same step); bf16 compute forecast within a relative L2 of 2e-2.

The registry forwards the JAX package's keys, which do not include
``qkv_bias``: ``vit_73ch``'s ``qkv_bias: True`` (config/vit.yaml) reaches
neither package, and both build the attention without qkv biases. And
``get_model`` builds ``vit_73ch`` at its widths (no forward): embed 768, 12
heads on the 45 x 90 = 4050 tokens of patch 16.
"""

import copy
import os

import jax
import jax.numpy as jnp
import pytest

from makani_tpu.models.model_registry import get_model as jget_model
from makani_tpu.utils.yparams import ParamsBase as JParamsBase
from tests.test_torch_afno import REPO, batch, check_model_run, check_published_config, run_model, token_params

from makani_torch.models.model_registry import get_model
from makani_torch.utils.yparams import ParamsBase
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_matches_jax(dtype):
    res = run_model(token_params("ViT", compute_dtype=dtype))
    check_model_run(res, dtype == "float32")
    names = set(res["names"])
    assert {"model.block1.attn.qkv.kernel", "model.block1.attn.proj.bias", "model.block1.LayerNorm_1.scale", "model.block1.Dense_0.kernel",
            "model.LayerNorm_0.scale", "model.head.bias", "model.pos_embed"} <= names


def test_qkv_bias_is_not_forwarded():
    """``qkv_bias: True`` in the config builds no qkv bias in either package,
    as ``get_model`` forwards only the JAX package's keys."""
    cfg = token_params("ViT", qkv_bias=True)
    model, _ = get_model(ParamsBase(copy.deepcopy(cfg)), multistep=True, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert "model.block0.attn.qkv.kernel" in names and "model.block0.attn.qkv.bias" not in names
    inp, _, zen = batch()
    jmodel, _ = jget_model(JParamsBase(copy.deepcopy(cfg)), multistep=True)
    jshapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(inp), jnp.asarray(zen))
    assert set(jshapes["params"]["model"]["block0"]["attn"]["qkv"]) == {"kernel"}


def test_vit_73ch_builds_at_full_width():
    sd = check_published_config(os.path.join(REPO, "config", "vit.yaml"), "vit_73ch")
    assert tuple(sd["model.pos_embed"].shape) == (1, 4050, 768)
    assert tuple(sd["model.block11.attn.qkv.kernel"].shape) == (768, 2304) and "model.block11.attn.qkv.bias" not in sd
    assert "model.block12.attn.qkv.kernel" not in sd
