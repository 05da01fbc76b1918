"""The deterministic training step (counterpart of ``_train_step`` in
``makani_tpu/utils/training/deterministic_trainer.py``). The ``Trainer``
class, with its data, epochs, validation and checkpoints, is not ported
yet."""

from __future__ import annotations

import torch

__all__ = ["train_step"]


def train_step(model: torch.nn.Module, loss_obj, optimizer: torch.optim.Optimizer, inp: torch.Tensor, tar: torch.Tensor, zen: torch.Tensor | None) -> torch.Tensor:
    """One step: the forward of the multistep wrapper with ``train=True``,
    the loss (with ``inp`` for the tendency losses), the backward, the
    optimizer's update, and the gradients cleared. Returns the loss,
    detached."""
    pred = model(inp, zen, train=True)
    loss = loss_obj(pred, tar, inp=inp, train=True)
    loss.backward()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss.detach()
