"""Carry weights from the JAX package into the port.

The port keeps the flax tree's parameter names and shapes, so converting is a
rename: the nested dict ``jax.tree.map(np.asarray, variables)`` of a
``makani_tpu`` model becomes a ``state_dict`` whose keys join the path with
dots (``params/model/block0/norm0/weight`` -> ``model.block0.norm0.weight``).
The same holds for FCN3's tree: ``atmo_encoder.conv.weight`` (g, og, ig, K),
``block1.local_conv.weight``, ``block0.global_conv.weight``,
``block0.layer_scale.gamma``, ``atmo_decoder.conv.weight``, ...
This module needs numpy and torch only; the caller produces the numpy tree.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "load_from_jax"]


def params_from_jax(flax_params_as_numpy: Mapping) -> dict:
    """Nested dict of numpy arrays (a flax variables tree, with or without
    the top-level ``params`` collection) -> ``state_dict`` of fp32 tensors."""
    tree = flax_params_as_numpy
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}

    def walk(node, prefix):
        for name, value in node.items():
            key = f"{prefix}.{name}" if prefix else name
            if isinstance(value, Mapping):
                walk(value, key)
            else:
                out[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    walk(tree, "")
    return out


def load_from_jax(module: torch.nn.Module, flax_params_as_numpy: Mapping) -> torch.nn.Module:
    """Load a flax variables tree into ``module`` with ``strict=True``: every
    parameter of the port must be present with its shape, and nothing more."""
    module.load_state_dict(params_from_jax(flax_params_as_numpy), strict=True)
    return module
