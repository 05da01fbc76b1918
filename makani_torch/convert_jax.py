"""Carry weights from the JAX package into the port.

The port keeps the flax tree's parameter names and shapes, so converting is a
rename: the nested dict ``jax.tree.map(np.asarray, variables)`` of a
``makani_tpu`` model becomes a ``state_dict`` whose keys join the path with
dots (``params/model/block0/norm0/weight`` -> ``model.block0.norm0.weight``).
The same holds for FCN3's tree: ``atmo_encoder.conv.weight`` (g, og, ig, K),
``block1.local_conv.weight``, ``block0.global_conv.weight``,
``block0.layer_scale.gamma``, ``atmo_decoder.conv.weight``, ...
``opt_state_from_jax`` carries a ``ScaleByAdamFactoredState`` (the factored
Adam's count, mu and per-leaf nu) into ``AdamFactored``'s ``state_dict`` the
same way, leaf by leaf under the parameter's name.
This module needs numpy and torch only; the caller produces the numpy tree.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "load_from_jax", "opt_state_from_jax"]


def _flatten(tree: Mapping) -> dict:
    """Nested dict (with or without the top-level ``params`` collection) ->
    {dotted name: leaf}."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}

    def walk(node, prefix):
        for name, value in node.items():
            key = f"{prefix}.{name}" if prefix else name
            if isinstance(value, Mapping):
                walk(value, key)
            else:
                out[key] = value

    walk(tree, "")
    return out


def _tensor(value) -> torch.Tensor:
    """A numpy array (float32, int32 or bfloat16) as a tensor of its dtype."""
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_jax(flax_params_as_numpy: Mapping) -> dict:
    """Nested dict of numpy arrays (a flax variables tree, with or without
    the top-level ``params`` collection) -> ``state_dict`` of fp32 tensors."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in _flatten(flax_params_as_numpy).items()}


def _factored_state(tree):
    """The ``ScaleByAdamFactoredState`` (count, mu, nu) in an optax state,
    which nests it in the tuples of ``chain``."""
    if hasattr(tree, "_fields") and {"count", "mu", "nu"} <= set(tree._fields):
        return tree
    if isinstance(tree, (tuple, list)):
        for t in tree:
            hit = _factored_state(t)
            if hit is not None:
                return hit
    return None


def opt_state_from_jax(opt_state_as_numpy, module: torch.nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """The numpy tree of an optax state holding a ``ScaleByAdamFactoredState``
    (``jax.tree.map(np.asarray, opt_state)``) -> ``optimizer``'s
    ``state_dict`` (an ``AdamFactored`` over ``module``'s parameters): per
    parameter its ``count``, ``mu`` (in mu's dtype) and the ``v_row``,
    ``v_col`` and ``v`` of its ``_Nu``. Every parameter of the optimizer must
    be in the tree."""
    st = _factored_state(opt_state_as_numpy)
    if st is None:
        raise ValueError("no ScaleByAdamFactoredState (count, mu, nu) in the optimizer state")
    mu, nu = _flatten(st.mu), _flatten(st.nu)
    names = {id(p): n for n, p in module.named_parameters()}
    count = _tensor(st.count).to(torch.int32)
    state, idx = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            leaf = nu[name]
            state[idx] = {"count": count.clone(), "mu": _tensor(mu[name]), "v_row": _tensor(leaf.v_row), "v_col": _tensor(leaf.v_col), "v": _tensor(leaf.v)}
            idx += 1
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}


def load_from_jax(module: torch.nn.Module, flax_params_as_numpy: Mapping) -> torch.nn.Module:
    """Load a flax variables tree into ``module`` with ``strict=True``: every
    parameter of the port must be present with its shape, and nothing more."""
    module.load_state_dict(params_from_jax(flax_params_as_numpy), strict=True)
    return module
