"""Carry weights from the JAX package into the port.

The port keeps the flax tree's parameter names and shapes, so converting is a
rename: the nested dict ``jax.tree.map(np.asarray, variables)`` of a
``makani_tpu`` model becomes a ``state_dict`` whose keys join the path with
dots (``params/model/block0/norm0/weight`` -> ``model.block0.norm0.weight``).
The same holds for FCN3's tree: ``atmo_encoder.conv.weight`` (g, og, ig, K),
``block1.local_conv.weight``, ``block0.global_conv.weight``,
``block0.layer_scale.gamma``, ``atmo_decoder.conv.weight``, ...
``opt_state_from_jax`` carries the optax state of ``get_optimizer``'s chains
(the plain or factored Adam's count, mu and nu, the schedule's count, the
gradient accumulation's mini-step and running mean, the freeze partition)
into ``Adam``'s or ``AdamFactored``'s ``state_dict`` the same way, leaf by
leaf under the parameter's name.
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


def _find(tree, fields):
    """The first namedtuple holding ``fields`` in an optax state (which nests
    them in ``chain``'s tuples, ``multi_transform``'s ``PartitionState``
    dict and ``MaskedState``), depth first, or None."""
    if hasattr(tree, "_fields"):
        if set(fields) <= set(tree._fields):
            return tree
        tree = tuple(tree)
    children = tree.values() if isinstance(tree, Mapping) else tree if isinstance(tree, (tuple, list)) else ()
    for t in children:
        hit = _find(t, fields)
        if hit is not None:
            return hit
    return None


def _counts(tree, out):
    """Every ``count`` of the namedtuples in an optax state (the Adam
    state's and the schedule's ``ScaleByScheduleState``)."""
    if hasattr(tree, "_fields"):
        if "count" in tree._fields:
            out.append(int(np.asarray(tree.count)))
        tree = tuple(tree)
    children = tree.values() if isinstance(tree, Mapping) else tree if isinstance(tree, (tuple, list)) else ()
    for t in children:
        _counts(t, out)
    return out


def _leaves(tree) -> dict:
    """{dotted name: leaf} of a moment tree, without the leaves that
    ``multi_transform`` masked out (``MaskedNode``, an empty namedtuple)."""
    return {k: v for k, v in _flatten(tree).items() if not (hasattr(v, "_fields") and not v._fields)}


def opt_state_from_jax(opt_state_as_numpy, module: torch.nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """The numpy tree of an optax state (``jax.tree.map(np.asarray,
    opt_state)``) of the chains that ``get_optimizer`` builds -> the
    ``state_dict`` of ``optimizer`` (an ``Adam`` or ``AdamFactored`` over
    ``module``'s parameters), so that both packages continue one training:

    - ``ScaleByAdamState`` (count, mu, nu) -> each parameter's ``count``,
      ``mu`` (in mu's dtype) and ``v``; ``ScaleByAdamFactoredState`` ->
      ``count``, ``mu`` and the ``v_row``, ``v_col`` and ``v`` of its
      ``_Nu``;
    - the schedule's ``ScaleByScheduleState`` count, which must equal the
      Adam state's;
    - ``MultiStepsState`` -> ``mini_step`` and ``acc`` (``acc_grads``), the
      inner state as above (its count advances on applied steps only, as
      ``gradient_step``);
    - ``multi_transform``'s ``PartitionState``: the trainable leaves' states;
      the frozen parameters (a ``frozen`` group) have none.

    Every trainable parameter of the optimizer must be in the tree."""
    multi = _find(opt_state_as_numpy, ("mini_step", "gradient_step", "inner_opt_state", "acc_grads"))
    inner = multi.inner_opt_state if multi is not None else opt_state_as_numpy
    st = _find(inner, ("count", "mu", "nu"))
    if st is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer state")
    counts = set(_counts(inner, []))
    if len(counts) != 1:
        raise ValueError(f"the optimizer state's counts disagree: {sorted(counts)}")
    mu, nu = _leaves(st.mu), _leaves(st.nu)
    acc = _leaves(multi.acc_grads) if multi is not None else None
    names = {id(p): n for n, p in module.named_parameters()}
    count = _tensor(st.count).to(torch.int32)
    state, idx = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            if not group.get("frozen", False):
                name = names[id(p)]
                leaf = nu[name]
                entry = {"count": count.clone(), "mu": _tensor(mu[name])}
                if hasattr(leaf, "v_row"):
                    entry.update(v_row=_tensor(leaf.v_row), v_col=_tensor(leaf.v_col), v=_tensor(leaf.v))
                else:
                    entry["v"] = _tensor(leaf)
                if multi is not None:
                    entry.update(mini_step=_tensor(multi.mini_step).to(torch.int32), acc=_tensor(acc[name]))
                state[idx] = entry
            idx += 1
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}


def load_from_jax(module: torch.nn.Module, flax_params_as_numpy: Mapping) -> torch.nn.Module:
    """Load a flax variables tree into ``module`` with ``strict=True``: every
    parameter of the port must be present with its shape, and nothing more."""
    module.load_state_dict(params_from_jax(flax_params_as_numpy), strict=True)
    return module
