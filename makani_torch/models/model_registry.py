"""Model factory (counterpart of ``makani_tpu/models/model_registry.py``).

Derives the effective input/output channel counts from the config (history,
zenith), builds the core network and wraps it with its preprocessor in the
single- or multi-step wrapper. The SFNO, FCN3, FCN3.1, AFNO (FourCastNet
v1), AFNOv2 and ViT are ported so far. The model is built on the card unless
the caller names another device. The keys forwarded to a network are the
JAX package's: like it, the port does not forward ``qkv_bias``, so a ViT is
built without qkv biases whatever its YAML says.
"""

from __future__ import annotations

import inspect

import torch

from makani_torch.device import resolve_device
from makani_torch.models.preprocessor import Preprocessor2D
from makani_torch.models.stepper import MultiStepWrapper, SingleStepWrapper
from makani_torch.utils.features import get_auxiliary_channels

__all__ = ["get_model_handle", "count_channels", "get_model", "init_parameters"]


def get_model_handle(nettype: str):
    if nettype == "SFNO":
        from makani_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet

        return SphericalFourierNeuralOperatorNet
    if nettype == "FCN3":
        from makani_torch.models.networks.fourcastnet3 import AtmoSphericNeuralOperatorNet

        return AtmoSphericNeuralOperatorNet
    if nettype == "FCN3.1":
        from makani_torch.models.networks.fourcastnet3_1 import AtmoSphericNeuralOperatorNet31

        return AtmoSphericNeuralOperatorNet31
    if nettype == "AFNO":
        from makani_torch.models.networks.afnonet import AdaptiveFourierNeuralOperatorNet

        return AdaptiveFourierNeuralOperatorNet
    if nettype == "AFNOv2":
        from makani_torch.models.networks.afnonet_v2 import AdaptiveFourierNeuralOperatorNetV2

        return AdaptiveFourierNeuralOperatorNetV2
    if nettype == "ViT":
        from makani_torch.models.networks.vit import VisionTransformer

        return VisionTransformer
    raise NotImplementedError(f"nettype {nettype!r} is not ported yet (only SFNO, FCN3, FCN3.1, AFNO, AFNOv2 and ViT)")


def _noise_channels(params) -> int:
    """Input-noise channels concatenated to each step's input."""
    noise = params.get("input_noise", None) or {}
    return noise.get("n_channels", 0) if noise.get("mode", "concatenate") == "concatenate" else 0


def count_channels(params):
    """Effective (in, out) channel counts seen by the core network: the
    prognostic channels and, per history step, the zenith angle and the
    concatenated noise channels (no static features are ported, so none
    are counted)."""
    n_prog = len(params.get("in_channels", range(params.get("N_in_channels", 0)))) or params.get("n_channels", 0)
    n_hist = params.get("n_history", 0) + 1
    n_dyn_aux = len(get_auxiliary_channels(add_zenith=params.get("add_zenith", False), n_noise_chan=_noise_channels(params)))
    n_in = n_hist * (n_prog + n_dyn_aux)
    n_out = len(params.get("out_channels", range(n_prog)))
    return n_in, n_out


def init_parameters(module: torch.nn.Module, generator: torch.Generator):
    """Draw every parameter of ``module`` from ``generator``, visiting the
    submodules in registration order, so a seed fixes the weights."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


_MODEL_KEYS = (
    "spectral_transform",
    "model_grid_type",
    "sht_grid_type",
    "filter_type",
    "operator_type",
    "scale_factor",
    "embed_dim",
    "num_layers",
    "use_mlp",
    "mlp_ratio",
    "encoder_ratio",
    "decoder_ratio",
    "activation_function",
    "encoder_layers",
    "pos_embed",
    "normalization_layer",
    "max_modes",
    "hard_thresholding_fraction",
    "big_skip",
    "channels_last",
    "separable",
    "checkpointing_level",
    "remat_policy",
    "patch_size",
    "depth",
    "num_heads",
    "skip_fno",
    "nested_skip_fno",
    "num_blocks",
    "sparsity_threshold",
    "pos_drop_rate",
    "path_drop_rate",
    "mlp_drop_rate",
    "num_groups",
    "kernel_shape",
    "sfno_block_frequency",
    "atmo_embed_dim",
    "surf_embed_dim",
    "aux_embed_dim",
    "pos_embed_dim",
    "lmax",
    "n_history",
    "resample_sht",
    "encoder_bias",
    "layer_scale",
    "clamp_water",
    "filter_basis_type",
    "filter_basis_norm_mode",
)


def get_model(params, multistep: bool = False, device=None, seed: int = 0):
    """Build (wrapper_module, preprocessor) from a params object, with the
    weights drawn on ``device`` (the card when None) from a
    ``torch.Generator`` seeded with ``seed``."""
    for axis in ("x", "y"):
        rs = params.get(f"img_shape_{axis}_resampled")
        if rs is not None:
            params[f"img_shape_{axis}"] = int(rs)
    handle = get_model_handle(params.get("nettype", "SFNO"))

    preprocessor = Preprocessor2D(params)
    n_in, n_out = count_channels(params)
    params["N_in_channels"] = n_in
    params["N_out_channels"] = n_out

    inp_shape = (params.get("img_shape_x"), params.get("img_shape_y"))
    out_shape = (params.get("out_shape_x", inp_shape[0]), params.get("out_shape_y", inp_shape[1]))
    kwargs = dict(inp_shape=inp_shape, out_shape=out_shape, inp_chans=n_in, out_chans=n_out)
    fields = set(inspect.signature(handle).parameters)
    for key in _MODEL_KEYS:
        if key in fields and params.get(key, None) is not None:
            kwargs[key] = params.get(key)
    if params.get("bias", None) is not None:
        kwargs["use_bias"] = params.get("bias")
    # channel-grouped models (FCN3) take the channel name lists, the
    # auxiliary ones including the concatenated noise channels
    if "channel_names" in fields:
        kwargs["channel_names"] = tuple(params.get("channel_names"))
    if "aux_channel_names" in fields:
        kwargs["aux_channel_names"] = tuple(get_auxiliary_channels(add_zenith=params.get("add_zenith", False), n_noise_chan=_noise_channels(params)))
    if "filter_basis_type" in fields and params.get("filter_basis_table", None) is not None:
        # exact import of a foreign basis convention from an exported table
        from makani_torch.ops.disco import load_basis_table

        kwargs["filter_basis_type"] = load_basis_table(params.get("filter_basis_table"))
    compute_dtype = params.get("compute_dtype", "float32")
    if compute_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(f"compute_dtype {compute_dtype!r} is not ported yet")
    kwargs["dtype"] = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]
    if params.get("constraints", None):
        raise NotImplementedError("model constraints are not ported yet")

    device = resolve_device(device)
    model = handle(**{k: v for k, v in kwargs.items() if k in fields}, device=device)
    if multistep:
        ms = params.get("multistep", None) or {}
        wrapper = MultiStepWrapper(
            model,
            preprocessor,
            n_future=params.get("n_future", 0),
            push_forward=ms.get("push_forward", False),
            multistep_checkpoint=params.get("multistep_checkpoint", False),
        )
    else:
        wrapper = SingleStepWrapper(model, preprocessor)
    init_parameters(wrapper, torch.Generator(device).manual_seed(seed))
    return wrapper, preprocessor
