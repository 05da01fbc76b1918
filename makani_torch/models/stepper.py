"""Single/multi-step model wrappers (counterpart of
``makani_tpu/models/stepper.py``).

``SingleStepWrapper`` binds the core network to its preprocessor: the
per-step channels (zenith) are appended to the input, the network predicts.
``MultiStepWrapper`` in eval mode (``train=False``) runs the first step of the
window; in training it rolls the model out over ``n_future + 1`` steps,
sliding the history window (``append_history``) and feeding each step its
window of the time-major unpredicted sequence, and returns all steps
concatenated along channels. ``push_forward`` cuts the gradient through the
carried input between steps (``detach``); ``multistep_checkpoint`` recomputes
each step's forward in the backward (``torch.utils.checkpoint``, off under
``push_forward``, as in the JAX package). The JAX package's ``use_scan``
computes the same rollout as one scanned step; here it is the same loop, so
the option is not read.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from makani_torch.models.preprocessor import Preprocessor2D

__all__ = ["SingleStepWrapper", "MultiStepWrapper"]


class SingleStepWrapper(nn.Module):
    def __init__(self, model: nn.Module, preprocessor: Preprocessor2D):
        super().__init__()
        self.model = model
        self.preprocessor = preprocessor

    def forward(self, inp, unpredicted=None):
        return self.model(self.preprocessor.append_unpredicted_features(inp, unpredicted))


class MultiStepWrapper(nn.Module):
    def __init__(
        self,
        model: nn.Module,
        preprocessor: Preprocessor2D,
        n_future: int = 0,
        push_forward: bool = False,
        multistep_checkpoint: bool = False,
    ):
        super().__init__()
        self.model = model
        self.preprocessor = preprocessor
        self.n_future = n_future
        self.push_forward = push_forward
        self.multistep_checkpoint = multistep_checkpoint

    def _step(self, inpt, unp, remat: bool = False):
        x = self.preprocessor.append_unpredicted_features(inpt, unp)
        if remat:
            return checkpoint(self.model, x, use_reentrant=False)
        return self.model(x)

    def forward(self, inp, unpredicted=None, train: bool = False):
        """``inp``: (B, (n_history+1)*C, H, W); ``unpredicted``: time-major
        (B, n_history+1+n_future, Cz, H, W) or None. Eval returns the first
        step's prediction; training all n_future + 1 steps concatenated along
        channels."""
        pre = self.preprocessor
        T = pre.n_history + 1
        if not train:
            unp = None if unpredicted is None else unpredicted[:, :T]
            return self._step(inp, unp)

        remat = self.multistep_checkpoint and not self.push_forward
        results = []
        inpt = inp
        for step in range(self.n_future + 1):
            if self.push_forward:
                inpt = inpt.detach()
            unp = None if unpredicted is None else unpredicted[:, step : step + T]
            pred = self._step(inpt, unp, remat=remat)
            results.append(pred)
            if step == self.n_future:
                break
            inpt = pre.append_history(inpt, pred, step)
        return torch.cat(results, dim=1)
