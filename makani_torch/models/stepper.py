"""Single/multi-step model wrappers (counterpart of
``makani_tpu/models/stepper.py``), for forecasting.

``SingleStepWrapper`` binds the core network to its preprocessor: the
per-step channels (zenith) are appended to the input, the network predicts.
``MultiStepWrapper`` in eval mode (``train=False``) runs the first step of the
window, as the JAX wrapper does; the training rollout over ``n_future`` steps
belongs to the training slice.
"""

from __future__ import annotations

from torch import nn

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
    def __init__(self, model: nn.Module, preprocessor: Preprocessor2D, n_future: int = 0):
        super().__init__()
        self.model = model
        self.preprocessor = preprocessor
        self.n_future = n_future

    def forward(self, inp, unpredicted=None, train: bool = False):
        """``inp``: (B, (n_history+1)*C, H, W); ``unpredicted``: time-major
        (B, n_history+1+n_future, Cz, H, W) or None. Returns the first
        step's prediction."""
        if train:
            raise NotImplementedError("the training rollout is not ported yet; call with train=False")
        T = self.preprocessor.n_history + 1
        unp = None if unpredicted is None else unpredicted[:, :T]
        return self.model(self.preprocessor.append_unpredicted_features(inp, unp))
