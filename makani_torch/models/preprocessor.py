"""Input preprocessing (counterpart of ``Preprocessor2D`` in
``makani_tpu/models/preprocessor.py``), the subset the forecast path uses:

  * history window flatten/expand and sliding (``append_history``),
  * appending per-step unpredicted channels (the zenith angle and, for
    ensembles, the concatenated input-noise channels).

History normalization (mode ``none`` only), static features, bias correction
and the ``perturb`` input-noise mode are not ported yet; a configuration that
asks for them raises instead of running without them.
"""

from __future__ import annotations

import torch

__all__ = ["Preprocessor2D", "get_preprocessor"]

_UNPORTED_KEYS = ("add_grid", "add_orography", "add_landmask", "add_soiltype", "add_copernicus_emb", "bias_correction")


class Preprocessor2D:
    """Pure preprocessing helper shared by the step wrappers."""

    def __init__(self, params):
        for key in _UNPORTED_KEYS:
            if params.get(key, None):
                raise NotImplementedError(f"preprocessor option {key!r} is not ported yet")
        noise = params.get("input_noise", None) or {}
        if noise and noise.get("mode", "concatenate") != "concatenate":
            raise NotImplementedError(f"input-noise mode {noise.get('mode')!r} is not ported yet (only 'concatenate')")
        self.n_history = params.get("n_history", 0)
        self.history_normalization_mode = params.get("history_normalization_mode", "none")
        if self.history_normalization_mode != "none":
            raise NotImplementedError(f"history_normalization_mode {self.history_normalization_mode!r} is not ported yet")

    # ---- history handling -------------------------------------------------
    def flatten_history(self, x):
        if x.dim() == 5:
            b, t, c, h, w = x.shape
            return x.reshape(b, t * c, h, w)
        return x

    def expand_history(self, x, nhist):
        if x.dim() == 4:
            b, ct, h, w = x.shape
            if ct % nhist != 0:
                raise ValueError(f"channel dim {ct} not divisible by nhist {nhist}")
            return x.reshape(b, nhist, ct // nhist, h, w)
        return x

    def append_history(self, x1, x2, step):
        """Slide the history window: drop the oldest state, append the
        prediction. x1: (B, (n_history+1)*C, H, W); x2: (B, C, H, W)."""
        if self.n_history == 0:
            return x2
        xh = self.expand_history(x1, self.n_history + 1)
        return self.flatten_history(torch.cat([xh[:, 1:], x2[:, None]], dim=1))

    # ---- channel appending ------------------------------------------------
    def append_channels(self, x, xc):
        """Append per-timestep channels (zenith) to a flattened-history input.
        x: (B, T*C, H, W), xc: (B, T, Cz, H, W)."""
        if xc is None:
            return x
        xe = self.expand_history(x, self.n_history + 1)
        if xc.dim() == 4:
            xc = xc[:, None]
        return self.flatten_history(torch.cat([xe, xc.to(xe.dtype)], dim=2))

    def append_unpredicted_features(self, x, unpredicted=None):
        return self.append_channels(x, unpredicted)


def get_preprocessor(params) -> Preprocessor2D:
    return Preprocessor2D(params)
