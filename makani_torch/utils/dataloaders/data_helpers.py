"""Normalization statistics in the out-channel order (counterpart of
``get_data_normalization``, ``out_channel_names``, ``get_out_normalization``
and ``get_time_diff_stds`` in
``makani_tpu/utils/dataloaders/data_helpers.py``).

Statistics are ``.npy`` files of shape (1, C_data, 1, 1) over the dataset's
full channel set; these select the configured channels and honour the
per-channel normalization modes ("zscore" by default, "minmax", "none").
numpy only: the loss handler reads them on the host.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["get_data_normalization", "out_channel_names", "get_out_normalization", "get_time_diff_stds"]


def _load(path):
    if path is None or not os.path.isfile(path):
        return None
    return np.load(path)


def get_data_normalization(params):
    """(bias, scale), each (1, C_sel, 1, 1) fp32, such that normalized =
    (x - bias) / scale; identity where z-score statistics are missing."""
    channel_names = params.get("channel_names")
    in_channels = np.asarray(params.get("in_channels", range(len(channel_names))))
    normalization = params.get("normalization", {}) or {}
    if isinstance(normalization, str):
        normalization = {ch: normalization for ch in channel_names}
    mins = _load(params.get("min_path"))
    maxs = _load(params.get("max_path"))
    means = _load(params.get("global_means_path"))
    stds = _load(params.get("global_stds_path"))

    n = len(in_channels)
    bias = np.zeros((1, n, 1, 1), dtype=np.float64)
    scale = np.ones((1, n, 1, 1), dtype=np.float64)
    for i, (c, name) in enumerate(zip(in_channels, channel_names)):
        mode = normalization.get(name, "zscore")
        if mode == "minmax":
            if mins is None or maxs is None:
                raise ValueError(f"minmax normalization for {name} requires min/max stats files")
            bias[0, i] = mins[0, c]
            scale[0, i] = maxs[0, c] - mins[0, c]
        elif mode == "zscore":
            if means is None or stds is None:
                continue
            bias[0, i] = means[0, c]
            scale[0, i] = stds[0, c]
        elif mode == "none":
            continue
        else:
            raise ValueError(f"Unknown normalization mode {mode} for channel {name}")
    return bias.astype(np.float32), scale.astype(np.float32)


def out_channel_names(params):
    """Names of the out_channels selection: ``channel_names`` pairs with
    ``in_channels``; out_channels may reorder or subset it, and a dataset
    channel absent from in_channels is named ``ch<i>``."""
    names = params.get("channel_names")
    if names is None:
        return None
    in_ch = list(params.get("in_channels", range(len(names))))
    out_ch = list(params.get("out_channels", in_ch))
    pos = {int(c): i for i, c in enumerate(in_ch)}
    return [names[pos[int(c)]] if int(c) in pos else f"ch{int(c)}" for c in out_ch]


def get_out_normalization(params):
    """(bias, scale) rows in out_channels order, shape (1, C_out, 1, 1)."""
    out_ch = params.get("out_channels")
    if out_ch is None or np.array_equal(np.asarray(params.get("in_channels", out_ch)), np.asarray(out_ch)):
        return get_data_normalization(params)
    view = dict(params) if isinstance(params, dict) else dict(params.to_dict())
    view["in_channels"] = out_ch
    names = out_channel_names(params)
    if names is not None:
        view["channel_names"] = names
    return get_data_normalization(view)


def get_time_diff_stds(params):
    """Per-channel std of the time difference x(t + dt) - x(t) over the
    dataset's full channel set, fp32; ones (1, C_data, 1, 1) where the stats
    file is absent. A 5-D file holds one row of stds for each dt stride
    along its first axis and is indexed by ``dt``."""
    stds = _load(params.get("time_diff_stds_path"))
    if stds is None:
        nch = len(params.get("data_channel_names", params.get("channel_names")))
        return np.ones((1, nch, 1, 1), dtype=np.float32)
    dt = params.get("dt", 1)
    if stds.ndim == 5:
        stds = stds[min(dt, stds.shape[0]) - 1]
    return stds.astype(np.float32)
