"""Rollout-based inference and scoring (counterpart of ``Inferencer`` in
``makani_tpu/utils/inference/inferencer.py``) on one card, for
deterministic forecasts (``ensemble_size`` 1).

Restores the run's best checkpoint (else its latest), rolls the model out
autoregressively from every initial condition of the validation (or
``inf_data_path``) files and scores every lead time with the
``MetricsHandler``; the streaming buffers write the raw forecasts, the
temporal means and stds of the forecast and of its bias, and the SH and
zonal power spectra. The initial conditions come in batches of
``batch_size``; the last is padded with the last initial condition, whose
rows the metrics weigh 0 and the buffers drop.

Nothing in the lead-step loop reads a value back, but for one wait: the
metrics and the buffers accumulate on the card, and the raw forecasts
(``save_raw_forecasts``) leave it by non-blocking copies, for which the host
waits once a batch of initial conditions, at its last lead step, before it
writes them to the file (the JAX package reads at the same point). That
wait is an event's (``RolloutBuffer.waits``), which
``torch.cuda.set_sync_debug_mode`` does not see. ``ensemble_size`` > 1, ``mask_file`` and ``climatology_file`` are
not ported yet and raise (ROADMAP queue 1 item 11). Without a checkpoint the
JAX package's behaviour is kept: a warning where the checkpoint directory
exists, and the seeded weights of ``get_model``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from makani_torch.device import resolve_device
from makani_torch.models.model_registry import get_model
from makani_torch.utils import hdf5
from makani_torch.utils.checkpoint_helpers import CheckpointManager
from makani_torch.utils.dataloader import DeviceBatches, get_dataloader
from makani_torch.utils.dataloaders.data_helpers import get_climatology
from makani_torch.utils.inference.rollout_buffer import RolloutBuffer, SpectrumAverageBuffer, TemporalAverageBuffer, ZonalSpectrumAverageBuffer
from makani_torch.utils.metric import MetricsHandler
from makani_torch.utils.training.deterministic_trainer import check_single_card

logger = logging.getLogger(__name__)

__all__ = ["Inferencer"]


class Inferencer:
    def __init__(self, params, world_rank: int = 0, device=None):
        check_single_card(params)
        if params.get("ensemble_size", 1) > 1:
            raise NotImplementedError("ensemble_size > 1: ensemble scoring is not ported yet (the ensemble driver, ROADMAP queue 1 item 11)")
        for key in ("mask_file", "climatology_file"):
            if params.get(key, None):
                raise NotImplementedError(f"{key}: the side datasets are not ported yet (ROADMAP queue 1 item 11)")
        self.params = params
        self.world_rank = world_rank
        self.device = resolve_device(device)

        self.valid_loader, self.valid_dataset = get_dataloader(params, params.get("inf_data_path", params.get("valid_data_path", "")), mode="eval", final_eval=True)
        self.model, self.preprocessor = get_model(params, multistep=True, device=self.device, seed=0)
        self.model.eval()
        self.n_out = len(params.get("out_channels"))
        self.metrics = MetricsHandler(params, climatology=get_climatology(params))

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

    @torch.no_grad()
    def _score(self, batches, S: int, n_valid_last: int):
        """The rollouts: every batch of initial conditions stepped S times,
        each lead time scored and fed to the buffers."""
        params = self.params
        T = params.get("n_history", 0) + 1
        n_out = self.n_out
        bs = params.get("batch_size", 1)
        n_batches = len(batches)
        for ic_index, batch in enumerate(batches):
            n_valid = n_valid_last if ic_index == n_batches - 1 else bs
            row_weights = None
            if n_valid < bs:
                row_weights = self._row_weights.get(n_valid)
            inp, tar, zen = batch["inp"], batch["tar"], batch.get("zen")
            inpt = inp
            for step in range(S):
                zwin = None if zen is None else zen[:, step : step + T]
                pred = self.model(inpt, zwin, train=False)
                tstep = tar[:, step * n_out : (step + 1) * n_out]
                self.metrics.update(pred, tstep, step, row_weights=row_weights)
                # the padding rows leave before the streaming buffers
                pm_v, ts_v = pred[:n_valid], tstep[:n_valid]
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
        index_batches = [indices[i : i + bs] for i in range(0, len(indices), bs)]
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
