"""Loss handler (counterpart of ``LossHandler`` in ``makani_tpu/utils/loss.py``).

Builds the configured loss terms with their static channel weights
(constant/auto/"new auto"/pangu or an explicit list, times ``relative_weight``),
the multistep lead-time weights and the ``tendency`` option, and reduces to a
scalar: ``mean_b sum_c w_c * loss[b, c]``.

Ported: the geometric Lp entries of the registry (``l1``, ``l2``,
``geometric l2``, ``relative l2``, ``squared l2``) and the ensemble CRPS
(``crps``, ``ensemble_crps``: ``CRPSLoss``, skillspread). Ensemble
predictions (B, E, C, H, W) score as in the JAX package: the probabilistic
losses see the members, the deterministic ones their mean. Every other loss type,
the running-statistics weightings (``uncertainty_weighting``,
``balanced_weighting``), ``temp_diff_normalization`` and the random options
(``random_slice_loss``, ``randomized_loss_weights``) raise
``NotImplementedError`` naming the option.
"""

from __future__ import annotations

import numpy as np
import torch

from makani_torch.utils.dataloaders.data_helpers import get_out_normalization, out_channel_names
from makani_torch.utils.losses.base_loss import LossType, compute_channel_weighting
from makani_torch.utils.losses.crps_loss import CRPSLoss
from makani_torch.utils.losses.lp_loss import GeometricLpLoss

__all__ = ["LossHandler", "LOSS_REGISTRY"]

LOSS_REGISTRY = {
    "l1": lambda **kw: GeometricLpLoss(p=1.0, **kw),
    "l2": lambda **kw: GeometricLpLoss(p=2.0, **kw),
    "geometric l2": lambda **kw: GeometricLpLoss(p=2.0, **kw),
    "relative l2": lambda **kw: GeometricLpLoss(p=2.0, relative=True, **kw),
    "squared l2": lambda **kw: GeometricLpLoss(p=2.0, squared=True, **kw),
    "crps": lambda **kw: CRPSLoss(**kw),
    "ensemble_crps": lambda **kw: CRPSLoss(**kw),
}

_UNPORTED_OPTIONS = ("uncertainty_weighting", "balanced_weighting", "random_slice_loss", "randomized_loss_weights")


def _multistep_weight(n_future: int, weight_type: str = "constant", weights=None) -> np.ndarray:
    """Lead-time weights of the n_future + 1 steps."""
    n = n_future + 1
    if weight_type == "constant":
        w = np.ones(n) / n
    elif weight_type == "balanced":
        w = 2.0 * np.arange(1, n + 1) / float((n + 1) * n)
    elif weight_type == "linear":
        w = np.arange(1, n + 1) / float(n)
    elif weight_type == "last-n-1":
        w = np.ones(n) / float(n_future)
        w[0] = 0.0
    elif weight_type == "last":
        w = np.zeros(n)
        w[-1] = 1.0
    elif weight_type == "custom":
        w = np.asarray(weights, dtype=np.float64)
        if w.shape[0] != n:
            raise ValueError(f"need {n} multistep weights, got {w.shape[0]}")
    else:
        raise ValueError(f"Unknown multistep loss weight type: {weight_type}")
    return w.astype(np.float32)


class LossHandler:
    def __init__(self, params):
        for option in _UNPORTED_OPTIONS:
            if params.get(option, False):
                raise NotImplementedError(f"loss option {option!r} is not ported yet")
        losses = params.get("losses")
        if losses is None:
            losses = [{"type": params.get("loss", "l2"), "channel_weights": "constant"}]
        if isinstance(losses, dict):
            losses = [losses]

        self.n_future = params.get("n_future", 0)
        self.img_shape = (params.get("img_shape_x"), params.get("img_shape_y"))
        channel_names = out_channel_names(params) or params.get("channel_names")
        try:
            bias, scale = get_out_normalization(params)
        except ValueError:
            # min/max files missing for a minmax channel: the geometric
            # losses do not read the statistics
            bias, scale = None, None

        self.loss_fns = []
        self.loss_requires_input = []
        channel_weights = []
        for loss in losses:
            if loss["type"] not in LOSS_REGISTRY:
                raise NotImplementedError(f"loss type {loss['type']!r} is not ported yet (ported: {sorted(LOSS_REGISTRY)})")
            if loss.get("temp_diff_normalization", False):
                raise NotImplementedError("loss option 'temp_diff_normalization' is not ported yet")
            fn = LOSS_REGISTRY[loss["type"]](
                img_shape=self.img_shape,
                channel_names=channel_names,
                grid_type=params.get("model_grid_type", "equiangular"),
                bias=bias,
                scale=scale,
                **(loss.get("parameters", {}) or {}),
            )
            self.loss_fns.append(fn)
            self.loss_requires_input.append(loss.get("tendency", False))

            cw_type = loss.get("channel_weights", "constant")
            if isinstance(cw_type, (list, tuple)):
                chw = np.asarray(cw_type, dtype=np.float32).reshape(-1)
            else:
                chw = compute_channel_weighting(channel_names, cw_type)
            chw = chw * loss.get("relative_weight", 1.0)
            channel_weights.append(chw.reshape(1, -1))

        self.channel_weights = np.concatenate(channel_weights, axis=1).astype(np.float32)
        ms = params.get("multistep", {"weight_type": "constant"}) or {}
        msw = _multistep_weight(self.n_future, ms.get("weight_type", "constant"), ms.get("weights"))
        ncw = self.channel_weights.shape[1]
        self.multistep_weight = np.repeat(msw.reshape(1, -1), ncw, axis=1).reshape(1, -1)
        self._tensors = {}

    @property
    def n_channels(self):
        return self.channel_weights.shape[1]

    def _const(self, name: str, value: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        key = (name, like.device)
        if key not in self._tensors:
            self._tensors[key] = torch.from_numpy(value).to(like.device)
        return self._tensors[key]

    def __call__(self, prd: torch.Tensor, tar: torch.Tensor, wgt=None, inp=None, train: bool = True) -> torch.Tensor:
        """prd: (B, (n_future+1)*C, H, W), or (B, E, (n_future+1)*C, H, W)
        for an ensemble; tar: (B, (n_future+1)*C, H, W); ``inp`` (B,
        (n_history+1)*C, H, W) for the tendency losses. Returns the scalar
        loss."""
        # the deterministic losses score the ensemble mean
        prdm = prd.mean(dim=1) if prd.dim() == 5 else prd
        if inp is not None and any(self.loss_requires_input):
            # tendency space: subtract the most recent input state
            n_per_step = tar.shape[1] // (self.n_future + 1)
            inp_rep = inp[:, -n_per_step:].repeat(1, tar.shape[1] // n_per_step, 1, 1)
            prdm_t, tar_t = prdm - inp_rep, tar - inp_rep
            prd_t = prd - inp_rep[:, None] if prd.dim() == 5 else prdm_t
        else:
            prdm_t, tar_t, prd_t = prdm, tar, prd

        vals = []
        for fn, req in zip(self.loss_fns, self.loss_requires_input):
            if fn.type == LossType.Deterministic:
                vals.append(fn(prdm_t if req else prdm, tar_t if req else tar, wgt))
            else:
                vals.append(fn(prd_t if req else prd, tar_t if req else tar, wgt))
        all_losses = torch.cat(vals, dim=-1)

        chw = self._const("channel_weights", self.channel_weights, all_losses)
        if train and self.n_future > 0:
            chw = chw.repeat(1, self.n_future + 1) * self._const("multistep_weight", self.multistep_weight, all_losses)
        elif all_losses.shape[-1] != chw.shape[-1]:
            # eval rollouts may score a single step
            reps = all_losses.shape[-1] // chw.shape[-1]
            chw = chw.repeat(1, reps) / reps
        return torch.mean(torch.sum(chw * all_losses, dim=1), dim=0)
