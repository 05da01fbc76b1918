"""Dataset metadata (``data.json``) parsing (counterpart of
``makani_tpu/utils/parse_dataset_metadata.py``).

Same schema as the reference (``makani/utils/parse_dataset_metada.py:20-75``,
documented in its README): h5 path layout, dhours, grid type, lat/lon arrays,
channel names, plus in/out channel selection resolved to index lists.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["parse_dataset_metadata"]


def parse_dataset_metadata(metadata_path: str, params):
    """Read data.json and fill the derived parameters into ``params``."""
    with open(metadata_path) as f:
        metadata = json.load(f)

    params["h5_path"] = metadata.get("h5_path", "fields")
    params["dhours"] = metadata.get("dhours", 6)
    params["coord"] = metadata.get("coords", {})
    attrs = metadata.get("attrs", {})
    for k, v in attrs.items():
        params[k] = v

    data_grid_type = metadata.get("coords", {}).get("grid_type", "equiangular")
    params["data_grid_type"] = data_grid_type

    lat = np.asarray(metadata["coords"]["lat"], dtype=np.float64)
    lon = np.asarray(metadata["coords"]["lon"], dtype=np.float64)
    params["lat"] = lat
    params["lon"] = lon
    params["img_shape_x"] = lat.shape[0]
    params["img_shape_y"] = lon.shape[0]

    channel_names = metadata["coords"]["channel"]
    params["data_channel_names"] = channel_names

    # channel selection: configured names must exist in the dataset
    if params.get("channel_names") is None:
        params["channel_names"] = list(channel_names)
    for ch in params["channel_names"]:
        if ch not in channel_names:
            raise ValueError(f"channel {ch} not found in dataset metadata")

    chidx = {c: i for i, c in enumerate(channel_names)}
    params["in_channels"] = [chidx[c] for c in params["channel_names"]]
    params["out_channels"] = [chidx[c] for c in params["channel_names"]]

    return params, metadata
