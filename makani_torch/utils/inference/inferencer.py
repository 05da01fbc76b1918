"""Rollout-based inference and scoring (counterpart of ``Inferencer`` and
``SideDataset`` in ``makani_tpu/utils/inference/inferencer.py``) on one
card.

Restores the run's best checkpoint (else its latest), rolls the model out
autoregressively from every initial condition of the validation (or
``inf_data_path``) files and scores every lead time with the
``MetricsHandler``; the streaming buffers write the raw forecasts, the
temporal means and stds of the forecast and of its bias, and the SH and
zonal power spectra. The initial conditions come in batches of
``batch_size``; the last is padded with the last initial condition, whose
rows the metrics weigh 0 and the buffers drop.

With ``ensemble_size`` E > 1 each initial condition is expanded b-major
into E members (row b*E + e, as the ensemble trainer folds them), told
apart by the input noise: one series of n_history + S steps a batch of
initial conditions, drawn from a ``torch.Generator`` on the card seeded
with ``seed + 99`` (centered pairs take a series and its negative). The
metrics score the (B, E, ...) forecast; the buffers and the raw forecasts
take the ensemble mean, the padding rows dropped after the mean; the
history window slides on the members' own forecasts.

``mask_file`` and ``climatology_file`` are side datasets (``SideDataset``)
looked up at each lead step's target time, relative to the start of its
year: the masks, each normalized to a unit quadrature integral, weigh the
metrics; the climatology, normalized as the targets, is subtracted from the
forecast and the target before scoring, and the metrics' static
climatology is then off.

Nothing in the lead-step loop reads a value back, but for one wait: the
metrics and the buffers accumulate on the card, and the raw forecasts
(``save_raw_forecasts``) leave it by non-blocking copies, for which the host
waits once a batch of initial conditions, at its last lead step, before it
writes them to the file (the JAX package reads at the same point). That
wait is an event's (``RolloutBuffer.waits``), which
``torch.cuda.set_sync_debug_mode`` does not see. The side fields of a batch
are read on the host and copied to the card before its rollout. Without a
checkpoint the JAX package's behaviour is kept: a warning where the
checkpoint directory exists, and the seeded weights of ``get_model``.
"""

from __future__ import annotations

import glob
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from makani_torch.device import resolve_device
from makani_torch.models.model_registry import get_model
from makani_torch.models.noise import build_noise
from makani_torch.utils import hdf5
from makani_torch.utils.checkpoint_helpers import CheckpointManager
from makani_torch.utils.dataloader import DeviceBatches, get_dataloader
from makani_torch.utils.dataloaders.data_helpers import get_climatology, get_out_normalization
from makani_torch.utils.grids import GridQuadrature, grid_to_quadrature_rule
from makani_torch.utils.inference.rollout_buffer import RolloutBuffer, SpectrumAverageBuffer, TemporalAverageBuffer, ZonalSpectrumAverageBuffer
from makani_torch.utils.metric import MetricsHandler
from makani_torch.utils.training.deterministic_trainer import check_single_card
from makani_torch.utils.training.ensemble_trainer import expand_ensemble, fold_ensemble, noise_series

logger = logging.getLogger(__name__)

__all__ = ["Inferencer", "SideDataset"]


class SideDataset:
    """Time-indexed side fields, masks or a per-date climatology: the
    ``fields`` (T, C, H, W) of an HDF5 file (a directory's first ``*.h5``),
    read through ``makani_torch.utils.hdf5`` (a layout it does not read
    raises). A time is looked up by its seconds since the start of its year,
    against the file's ``timestamp`` relative to its first (else steps of
    ``dhours``), so a one-year climatology serves any date. ``out_channels``
    select the channels; ``bias`` and ``scale``, where given, normalize the
    fields as the targets are (the climatology), and masks stay raw."""

    def __init__(self, location: str, out_channels, bias=None, scale=None, dhours: int = 6):
        paths = sorted(glob.glob(os.path.join(location, "*.h5"))) if os.path.isdir(location) else [location]
        if not paths:
            raise IOError(f"no side-dataset files under {location}")
        f = hdf5.File(paths[0])
        self._fields = f["fields"]
        self.n_samples = self._fields.shape[0]
        self.out_channels = np.asarray(out_channels)
        self.bias = None if bias is None else np.asarray(bias).reshape(-1, 1, 1)
        self.scale = None if scale is None else np.asarray(scale).reshape(-1, 1, 1)
        self.dhours = dhours
        if "timestamp" in f:
            ts = np.asarray(f["timestamp"][...], np.int64)
            self._rel_ts = ts - ts[0]
        else:
            self._rel_ts = np.arange(self.n_samples, dtype=np.int64) * dhours * 3600

    def at_time(self, timestamp: float) -> np.ndarray:
        """Fields (C, H, W) at the relative time of ``timestamp`` (epoch s)."""
        year_start = np.asarray(np.int64(timestamp), "datetime64[s]").astype("datetime64[Y]").astype("datetime64[s]").astype(np.int64)
        rel = np.int64(timestamp) - year_start
        idx = int(np.argmin(np.abs(self._rel_ts - rel % (self._rel_ts[-1] + self.dhours * 3600))))
        x = np.asarray(self._fields[idx], np.float32)[self.out_channels]
        if self.bias is not None and self.scale is not None:
            x = (x - self.bias) / self.scale
        return x


class Inferencer:
    def __init__(self, params, world_rank: int = 0, device=None):
        check_single_card(params)
        self.params = params
        self.world_rank = world_rank
        self.device = resolve_device(device)

        self.valid_loader, self.valid_dataset = get_dataloader(params, params.get("inf_data_path", params.get("valid_data_path", "")), mode="eval", final_eval=True)
        self.model, self.preprocessor = get_model(params, multistep=True, device=self.device, seed=0)
        self.model.eval()
        self.n_out = len(params.get("out_channels"))
        img_shape = (params.get("img_shape_x"), params.get("img_shape_y"))

        self.ensemble_size = params.get("ensemble_size", 1)
        self.noise = None
        if self.ensemble_size > 1 and params.get("input_noise", None):
            noise_params = params.get("input_noise")
            self.centered = noise_params.get("centered", False)
            self.noise = build_noise(dict(noise_params, grid_type=params.get("model_grid_type", "equiangular")), img_shape, num_time_steps=1)
            self.generator = torch.Generator(self.device).manual_seed(params.get("seed", 333) + 99)

        dhours = params.get("dhours", 6)
        self.mask_dataset = None
        if params.get("mask_file", None):
            self.mask_dataset = SideDataset(params.get("mask_file"), params.get("out_channels"), dhours=dhours)
            self.mask_quadrature = GridQuadrature(grid_to_quadrature_rule(params.get("model_grid_type", "equiangular")), img_shape=img_shape, normalize=True)
        self.climatology_dataset = None
        if params.get("climatology_file", None):
            bias, scale = get_out_normalization(params)
            self.climatology_dataset = SideDataset(params.get("climatology_file"), params.get("out_channels"), bias=bias, scale=scale, dhours=dhours)
        if (self.mask_dataset is not None or self.climatology_dataset is not None) and not hasattr(self.valid_dataset, "target_timestamps"):
            raise ValueError("mask_file and climatology_file need a dataset with timestamps")
        # a per-date climatology replaces the static one
        self.metrics = MetricsHandler(params, climatology=None if self.climatology_dataset is not None else get_climatology(params))

        ckpt = CheckpointManager(params)
        self.restored = ckpt.restore_best(self.model)
        if self.restored is None and params.get("checkpoint_required", True) and os.path.isdir(ckpt.checkpoint_dir):
            logger.warning("no checkpoint found in %s; using random init", ckpt.checkpoint_dir)
        self.checkpoint = ckpt
        self.timings = {}
        self._sht = None

    def _select_indices(self):
        """The initial conditions' indices after the optional date range
        (``start_date``/``end_date``) and ``n_ics``."""
        n = len(self.valid_dataset)
        indices = list(range(n))
        start = self.params.get("start_date", None)
        end = self.params.get("end_date", None)
        if (start or end) and hasattr(self.valid_dataset, "base_timestamp"):
            t0 = np.datetime64(start).astype("datetime64[s]").astype(np.int64) if start else -(2**62)
            t1 = np.datetime64(end).astype("datetime64[s]").astype(np.int64) if end else 2**62
            indices = [i for i in indices if t0 <= self.valid_dataset.base_timestamp(i) <= t1]
            if not indices:
                raise ValueError(f"no samples between {start} and {end}")
        n_ics = self.params.get("n_ics", None)
        if n_ics:
            indices = indices[: int(n_ics)]
        return indices

    def _make_buffers(self, output_dir, S, n_ic):
        params = self.params
        H, W = params.get("img_shape_x"), params.get("img_shape_y")
        self.rollout_buffer = None
        if params.get("save_raw_forecasts", False) and output_dir:
            self.rollout_buffer = RolloutBuffer(
                params.get("channel_names"), params.get("output_channels", None), (H, W), S, path=os.path.join(output_dir, "raw_forecasts.h5"), num_ics=n_ic
            )
        self.temporal_buffer = TemporalAverageBuffer(S, self.n_out, (H, W))
        # the bias buffer: Welford mean and std of (pred - target)
        self.bias_buffer = TemporalAverageBuffer(S, self.n_out, (H, W))
        t0 = time.perf_counter()
        self.spectrum_buffer = SpectrumAverageBuffer((H, W), S, self.n_out, params.get("model_grid_type", "equiangular"), device=self.device, sht=self._sht)
        self._sht = self.spectrum_buffer.sht
        self.timings["spectrum_table_s"] = time.perf_counter() - t0
        self.zonal_buffer = ZonalSpectrumAverageBuffer((H, W), S, self.n_out)

    def draw_noise(self, rows: int, total_steps: int) -> torch.Tensor:
        """One batch's noise series (rows, total_steps, Cn, H, W), from the
        Inferencer's generator."""
        return noise_series(self.noise, rows, total_steps, self.generator, self.centered)

    def _side_fields(self, batch_idx, S: int):
        """The batch's side fields at each lead step's target time, on the
        card: the normalized masks and the climatology, each (S, B, C, H, W),
        or None."""
        if self.mask_dataset is None and self.climatology_dataset is None:
            return None, None
        times = [self.valid_dataset.target_timestamps(int(i)) for i in batch_idx]

        def fields(ds):
            return torch.as_tensor(np.stack([np.stack([ds.at_time(row[step]) for row in times]) for step in range(S)]), device=self.device)

        masks = clims = None
        if self.mask_dataset is not None:
            m = fields(self.mask_dataset)
            masks = m / torch.clamp_min(self.mask_quadrature(m)[..., None, None], 1e-12)
        if self.climatology_dataset is not None:
            clims = fields(self.climatology_dataset)
        return masks, clims

    @torch.no_grad()
    def _score(self, batches, S: int, n_valid_last: int):
        """The rollouts: every batch of initial conditions stepped S times
        (as E members each where E > 1), each lead time scored and fed to
        the buffers."""
        params = self.params
        n_hist = params.get("n_history", 0)
        T = n_hist + 1
        n_out = self.n_out
        E = self.ensemble_size
        bs = params.get("batch_size", 1)
        n_batches = len(batches)
        for ic_index, batch in enumerate(batches):
            n_valid = n_valid_last if ic_index == n_batches - 1 else bs
            row_weights = None
            if n_valid < bs:
                row_weights = self._row_weights.get(n_valid)
            masks, clims = self._side_fields(self._index_batches[ic_index], S)
            inp, tar, zen = batch["inp"], batch["tar"], batch.get("zen")
            if E > 1:
                inp = expand_ensemble(inp, E)
                zen = None if zen is None else expand_ensemble(zen, E)
                if self.noise is not None:
                    seq = self.draw_noise(inp.shape[0], n_hist + S).to(inp.device)
                    zen = seq if zen is None else torch.cat([zen, seq], dim=2)
            inpt = inp
            for step in range(S):
                zwin = None if zen is None else zen[:, step : step + T]
                pred = self.model(inpt, zwin, train=False)
                pred_s = fold_ensemble(pred, E) if E > 1 else pred
                tstep = tar[:, step * n_out : (step + 1) * n_out]
                mask = None if masks is None else masks[step]
                if clims is None:
                    self.metrics.update(pred_s, tstep, step, mask=mask, row_weights=row_weights)
                else:
                    clim = clims[step]
                    self.metrics.update(pred_s - (clim[:, None] if E > 1 else clim), tstep - clim, step, mask=mask, row_weights=row_weights)
                # the padding rows leave, after the ensemble mean, before the streaming buffers
                pm = torch.mean(pred_s, dim=1) if E > 1 else pred
                pm_v, ts_v = pm[:n_valid], tstep[:n_valid]
                self.temporal_buffer.update(pm_v, step)
                self.bias_buffer.update(pm_v - ts_v, step)
                self.spectrum_buffer.update(pm_v, step, tar=ts_v)
                self.zonal_buffer.update(pm_v, step, tar=ts_v)
                if self.rollout_buffer is not None:
                    self.rollout_buffer.update(pm_v, step, ic_index)
                if step < S - 1:
                    inpt = self.preprocessor.append_history(inpt, pred, step)

    def score_model(self, output_dir: Optional[str] = None):
        """Roll out over every initial condition and score every lead time;
        returns the metrics' logs (also kept in ``logs``) and writes
        ``metrics.h5``, ``temporal_averages.h5``, ``spectra.h5`` and, with
        ``save_raw_forecasts``, ``raw_forecasts.h5`` to ``output_dir``."""
        params = self.params
        S = params.get("valid_autoreg_steps", 0) + 1
        self.metrics.reset()
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
        indices = list(self._select_indices())
        n_ic = len(indices)
        self._make_buffers(output_dir, S, n_ic)

        # whole batches: the last padded with the last initial condition
        bs = params.get("batch_size", 1)
        n_pad = (-n_ic) % bs
        if n_pad:
            indices = indices + [indices[-1]] * n_pad
        n_valid_last = bs - n_pad
        self._row_weights = {n_valid_last: torch.as_tensor((np.arange(bs) < n_valid_last).astype(np.float32), device=self.device)} if n_pad else {}
        index_batches = self._index_batches = [indices[i : i + bs] for i in range(0, len(indices), bs)]
        batches = DeviceBatches(self.valid_loader, self.device, dataset=self.valid_dataset, index_batches=index_batches)

        t0 = time.perf_counter()
        self._score(batches, S, n_valid_last)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings.update(rollout_s=time.perf_counter() - t0, lead_steps=len(index_batches) * S, loader=batches.stats())

        t0 = time.perf_counter()
        logs = self.metrics.finalize()
        if output_dir:
            self.metrics.save(os.path.join(output_dir, "metrics.h5"))
            mean, std = self.temporal_buffer.finalize()
            bias_mean, bias_std = self.bias_buffer.finalize()
            hdf5.write(os.path.join(output_dir, "temporal_averages.h5"), {"mean": mean, "std": std, "bias_mean": bias_mean, "bias_std": bias_std})
            sh_prd, sh_tar = self.spectrum_buffer.finalize()
            zn_prd, zn_tar = self.zonal_buffer.finalize()
            hdf5.write(
                os.path.join(output_dir, "spectra.h5"),
                {"sh_spectrum": sh_prd, "sh_spectrum_target": sh_tar, "zonal_spectrum": zn_prd, "zonal_spectrum_target": zn_tar},
            )
            if self.rollout_buffer is not None:
                self.rollout_buffer.finalize()
        self.timings["finalize_s"] = time.perf_counter() - t0
        self.logs = logs
        return logs

    def log_score(self, logs: dict):
        for k in sorted(logs):
            if "/" not in k:
                logger.info(f"{k}: {logs[k]:.5f}")
        return logs
