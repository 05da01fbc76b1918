"""Validation metrics handler (counterpart of ``MetricsHandler`` in
``makani_tpu/utils/metric.py``) for one process.

Tracks per-(rollout step, channel) curves of the configured metrics (L1,
RMSE, ACC against the climatology; CRPS, spread, SSR and the rank histogram
for ensembles) over validation batches. Each update reduces its batch on
the device and adds the (C,) sums to fp64 accumulators that stay there:
nothing is read back until ``finalize``, which reads every sum once. The
log keys of ``finalize`` and the datasets of ``save`` are the JAX
package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from makani_torch.utils import hdf5
from makani_torch.utils.grids import GridQuadrature, grid_to_quadrature_rule
from makani_torch.utils.metrics.functions import (
    ensemble_crps,
    ensemble_rank_histogram,
    ensemble_spread,
    weighted_acc,
    weighted_l1,
    weighted_rmse,
)

__all__ = ["MetricsHandler"]


class MetricsHandler:
    def __init__(self, params, climatology: Optional[np.ndarray] = None, num_rollout_steps: Optional[int] = None):
        self.img_shape = (params.get("img_shape_x"), params.get("img_shape_y"))
        self.channel_names = list(params.get("channel_names"))
        self.num_rollout_steps = num_rollout_steps or (params.get("valid_autoreg_steps", 0) + 1)

        grid_type = params.get("model_grid_type", "equiangular")
        quad_rule = "weatherbench2" if params.get("metrics_use_wb2_grid", False) else grid_to_quadrature_rule(grid_type)
        self.quadrature = GridQuadrature(quad_rule, img_shape=self.img_shape, normalize=True)

        self.climatology = climatology
        self._clim = {}
        self.metric_names = list(params.get("metric_names", ["rmse", "acc", "l1"]))
        self.reset()

    def reset(self):
        # allocated on the first update (the rank histogram adds an E+1 axis)
        self._sums = {}
        self._counts = None

    def _climatology(self, device) -> torch.Tensor | None:
        if self.climatology is None:
            return None
        if device not in self._clim:
            self._clim[device] = torch.as_tensor(self.climatology, device=device)
        return self._clim[device]

    def compute_batch(self, prd, tar, mask=None):
        """Per-batch metrics: prd/tar (B, C, H, W), or prd (B, E, C, H, W) ->
        {name: (B, C)}. ``mask`` is an optional quadrature-normalized spatial
        weight."""
        out = {}
        quad = self.quadrature
        prdm = torch.mean(prd, dim=1) if prd.dim() == 5 else prd
        clim = self._climatology(prd.device)
        for m in self.metric_names:
            if m == "rmse":
                out[m] = weighted_rmse(prdm, tar, quad, mask=mask)
            elif m == "l1":
                out[m] = weighted_l1(prdm, tar, quad, mask=mask)
            elif m == "acc":
                out[m] = weighted_acc(prdm, tar, quad, clim=clim, mask=mask)
            elif m == "crps" and prd.dim() == 5:
                out[m] = ensemble_crps(prd, tar, quad, mask=mask)
            elif m == "spread" and prd.dim() == 5:
                out[m] = ensemble_spread(prd, quad, mask=mask)
            elif m == "ssr" and prd.dim() == 5:
                spread = ensemble_spread(prd, quad, mask=mask)
                rmse = weighted_rmse(prdm, tar, quad, mask=mask)
                out[m] = spread / (rmse + 1e-8)
            elif m == "rankhist" and prd.dim() == 5:
                out[m] = ensemble_rank_histogram(prd, tar, quad)
        return out

    @torch.no_grad()
    def update(self, prd, tar, step: int, mask=None, row_weights=None):
        """Accumulate one batch at rollout step ``step``, on the device.
        ``row_weights`` (B,) weighs the rows (0 leaves out a row that pads
        the batch; the count shrinks to match)."""
        vals = self.compute_batch(prd, tar, mask=mask)
        dev = prd.device
        if self._counts is None:
            self._counts = torch.zeros(self.num_rollout_steps, dtype=torch.int64, device=dev)
        if row_weights is None:
            sums = {m: torch.sum(v, dim=0) for m, v in vals.items()}
            self._counts[step] += prd.shape[0]
        else:
            w = row_weights.to(device=dev, dtype=torch.float32)
            sums = {m: torch.sum(v * w.reshape((-1,) + (1,) * (v.dim() - 1)), dim=0) for m, v in vals.items()}
            self._counts[step] += torch.sum(w).to(torch.int64)
        for m, v in sums.items():
            if m not in self._sums:
                self._sums[m] = torch.zeros((self.num_rollout_steps, *v.shape), dtype=torch.float64, device=dev)
            self._sums[m][step] += v.to(torch.float64)

    def finalize(self) -> dict:
        """Averaged rollout curves and their scalar summaries: the channel
        mean of each metric at every rollout step, the per-channel values at
        step 0 and at the last step."""
        counts = np.maximum(self._counts.cpu().numpy() if self._counts is not None else np.zeros(self.num_rollout_steps, np.int64), 1)
        sums = {m: s.cpu().numpy() for m, s in self._sums.items()}
        logs = {}
        self.rollout_curves = {m: s / counts.reshape((-1,) + (1,) * (s.ndim - 1)) for m, s in sums.items()}
        for m, curve in self.rollout_curves.items():
            if m == "rankhist":
                # rms deviation of the histogram from flat (0 = calibrated)
                nbins = curve.shape[-1]
                dev = np.sqrt(np.mean(np.square(curve * nbins - 1.0), axis=(-2, -1)))
                logs["rankhist_rmsd"] = float(dev[0])
                continue
            logs[f"{m}"] = float(curve[0].mean())
            for s in range(curve.shape[0]):
                logs[f"{m}_rollout/{s}"] = float(curve[s].mean())
            for c, name in enumerate(self.channel_names):
                logs[f"{m}/{name}"] = float(curve[0, c])
                if curve.shape[0] > 1:
                    logs[f"{m}_final/{name}"] = float(curve[-1, c])
            if curve.shape[0] > 1:
                logs[f"{m}_rollout_last"] = float(curve[-1].mean())
        return logs

    def save(self, path: str):
        hdf5.write(path, {**self.rollout_curves, "channel": np.array(self.channel_names, dtype="S")})
