"""Training debug and observability helpers (counterpart of
``makani_tpu/utils/training/training_helpers.py``).

``dump_weights_and_grads`` writes a module's parameters (and gradients) to
an .npz; ``total_grad_norm`` is the global L2 norm of a list of gradients;
``memory_usage`` reports each card's allocated and peak bytes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["dump_weights_and_grads", "total_grad_norm", "memory_usage"]


def dump_weights_and_grads(path: str, model: torch.nn.Module, with_grads: bool = True, step: int = 0) -> str:
    """Save ``weights/<name>`` (and ``grads/<name>`` where a gradient is
    held) as ``weights_and_grads_step{N}.npz``; names are the module's
    dotted parameter names with "/" for ".", as the flax paths."""
    os.makedirs(path, exist_ok=True)
    payload = {}
    for name, p in model.named_parameters():
        key = name.replace(".", "/")
        payload[f"weights/{key}"] = p.detach().float().cpu().numpy()
        if with_grads and p.grad is not None:
            payload[f"grads/{key}"] = p.grad.detach().float().cpu().numpy()
    out = os.path.join(path, f"weights_and_grads_step{step}.npz")
    np.savez(out, **payload)
    return out


def total_grad_norm(grads) -> torch.Tensor:
    """Global L2 norm of a list of gradients, in fp32, on their device."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def memory_usage() -> dict:
    """{card: {"bytes_in_use", "peak_bytes_in_use"}} of every CUDA device."""
    out = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out[f"cuda:{i}"] = {"bytes_in_use": torch.cuda.memory_allocated(i), "peak_bytes_in_use": torch.cuda.max_memory_allocated(i)}
    return out
