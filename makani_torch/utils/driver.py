"""Driver-level shared machinery (counterpart of ``makani_tpu/utils/driver.py``):
the parameter defaults and the derived data shapes, and the factories the
drivers share, re-exported so the surface exists in one place (the
optimizer and schedule, ``utils/training/optimizer.py``; the checkpoint
manager, ``utils/checkpoint_helpers.py``)."""

from __future__ import annotations

from makani_torch.utils.checkpoint_helpers import CheckpointManager, get_latest_checkpoint_version  # noqa: F401
from makani_torch.utils.features import get_auxiliary_channels
from makani_torch.utils.training.optimizer import get_optimizer, get_schedule  # noqa: F401

__all__ = [
    "set_default_parameters",
    "derive_data_shapes",
    "get_optimizer",
    "get_schedule",
    "CheckpointManager",
    "get_latest_checkpoint_version",
]

_DEFAULTS = {
    "n_history": 0,
    "n_future": 0,
    "dt": 1,
    "dhours": 6,
    "batch_size": 1,
    "lr": 1e-3,
    "max_epochs": 1,
    "weight_decay": 0.0,
    "optimizer_type": "Adam",
    "scheduler": "none",
    "normalization_layer": "instance_norm",
    "model_grid_type": "equiangular",
    "sht_grid_type": "legendre-gauss",
    "add_zenith": False,
    "save_checkpoint": "flexible",
    "checkpoint_num_versions": 3,
    "valid_autoreg_steps": 0,
    "seed": 333,
}

_STATIC = ("xoro", "xlsml", "xlsms", "xlsm")


def set_default_parameters(params):
    """Fill the reference's defaults where ``params`` has no value."""
    for k, v in _DEFAULTS.items():
        if params.get(k, None) is None:
            params[k] = v
    if params.get("in_channels") is None and params.get("channel_names") is not None:
        n = len(params.get("channel_names"))
        params["in_channels"] = list(range(n))
        params["out_channels"] = list(range(n))
    return params


def derive_data_shapes(params):
    """Channel counting: the prognostic channels and, per history step, the
    dynamic ones (zenith, concatenated noise), plus the static features."""
    n_prog = len(params.get("in_channels"))
    n_hist = params.get("n_history", 0) + 1
    noise_cfg = params.get("input_noise", {}) or {}
    aux = get_auxiliary_channels(
        add_zenith=params.get("add_zenith", False),
        add_grid=params.get("add_grid", False),
        grid_type=params.get("gridtype", None),
        grid_num_frequencies=params.get("grid_num_frequencies", 0),
        add_orography=params.get("add_orography", False),
        add_landmask=params.get("add_landmask", False),
        n_noise_chan=noise_cfg.get("n_channels", 0) if noise_cfg.get("mode", "concatenate") == "concatenate" else 0,
    )
    dyn_aux = [a for a in aux if a not in _STATIC]
    stat_aux = [a for a in aux if a in _STATIC]
    params["N_in_predicted_channels"] = n_prog
    params["N_in_channels"] = n_hist * (n_prog + len(dyn_aux)) + len(stat_aux)
    params["N_out_channels"] = len(params.get("out_channels"))
    return params
