"""The deterministic trainer (counterpart of
``makani_tpu/utils/training/deterministic_trainer.py``) on one card.

``train_step`` is one step: the multistep wrapper's forward with
``train=True``, the loss, the backward and the optimizer's update. The
``Trainer`` drives it over epochs: the data (``get_dataloader``, put on the
card by ``DeviceBatches``), the model from ``get_model`` on seeded weights,
the loss, the optimizer and its schedule, an autoregressive validation
rollout of ``valid_autoreg_steps`` with its metrics, best-loss tracking,
a checkpoint every epoch and the resume from the latest one.

Nothing in the step loops reads a value back: the losses, the metrics' sums
and the step events stay on the card until the epoch ends, where the JAX
package reads its losses too. ``host_stats`` holds the last epoch's account
of the host and the card: the loader's read, normalize, zenith and staging
seconds, the copies' and the steps' device milliseconds (CUDA events around
each), and the card's idle share (one minus the steps' device time over the
epoch's wall time).

A parallel size other than 1 raises (multi-GPU is slice 6), as do the
running-statistics loss weightings (``LossHandler``).
"""

from __future__ import annotations

import logging
import time

import torch

from makani_torch.device import resolve_device
from makani_torch.models.model_registry import get_model
from makani_torch.utils.checkpoint_helpers import CheckpointManager
from makani_torch.utils.dataloader import DeviceBatches, get_dataloader
from makani_torch.utils.dataloaders.data_helpers import get_climatology
from makani_torch.utils.loss import LossHandler
from makani_torch.utils.metric import MetricsHandler
from makani_torch.utils.training.optimizer import get_optimizer

logger = logging.getLogger(__name__)

__all__ = ["train_step", "Trainer", "check_single_card"]

_PARALLEL_KEYS = ("h_parallel_size", "w_parallel_size", "parameters_split_size", "matmul_parallel_size", "ensemble_parallel_size")


def check_single_card(params):
    """Raise for a parallel size other than 1: multi-GPU is not ported."""
    for key in _PARALLEL_KEYS:
        if (params.get(key, 1) or 1) != 1:
            raise NotImplementedError(f"{key}={params.get(key)}: multi-GPU runs are not ported yet (slice 6, ROADMAP queue 1 item 12)")


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


class Trainer:
    def __init__(self, params, world_rank: int = 0, device=None):
        check_single_card(params)
        self.params = params
        self.world_rank = world_rank
        self.device = resolve_device(device)

        self.train_loader, self.train_dataset = get_dataloader(params, params.get("train_data_path", ""), mode="train")
        self.valid_loader, self.valid_dataset = get_dataloader(params, params.get("valid_data_path", ""), mode="eval")
        self.train_batches = DeviceBatches(self.train_loader, self.device)
        self.valid_batches = DeviceBatches(self.valid_loader, self.device)

        self.model, self.preprocessor = get_model(params, multistep=True, device=self.device, seed=params.get("seed", 333))
        n_params = sum(p.numel() for p in self.model.parameters())
        if world_rank == 0:
            logger.info(f"model has {n_params} parameters")
        self.n_model_params = n_params

        self.loss_obj = LossHandler(params)
        self.metrics = MetricsHandler(params, climatology=get_climatology(params))

        steps_per_epoch = max(1, len(self.train_loader))
        self.optimizer = get_optimizer(params, self.model, steps_per_epoch)

        self.checkpoint = CheckpointManager(params)
        self.epoch = 0
        self.iters = 0
        self.best_valid_loss = float("inf")
        self.host_stats = {}
        if params.get("resuming", False):
            meta = self.checkpoint.restore_latest(self.model, self.optimizer)
            if meta is not None:
                self.epoch = meta.get("epoch", 0)
                self.iters = meta.get("iters", 0)
                self.best_valid_loss = meta.get("best_valid_loss", float("inf"))

    def _events(self):
        if self.device.type != "cuda":
            return None, None
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def _train_steps(self):
        """The epoch's steps: (losses, step events, samples, io bytes), the
        losses and events on the card, nothing read back."""
        n_samples, io_bytes = 0, 0
        losses, events = [], []
        for batch in self.train_batches:
            io_bytes += sum(v.numel() * 4 for v in batch.values())
            start, end = self._events()
            if start is not None:
                start.record()
            loss = train_step(self.model, self.loss_obj, self.optimizer, batch["inp"], batch["tar"], batch.get("zen"))
            if end is not None:
                end.record()
                events.append((start, end))
            losses.append(loss)
            n_samples += batch["inp"].shape[0]
            self.iters += 1
        return losses, events, n_samples, io_bytes

    def train_one_epoch(self):
        self.model.train()
        self.train_batches.reset_stats()
        t0 = time.time()
        losses, events, n_samples, io_bytes = self._train_steps()
        train_loss = torch.stack(losses).mean().item() if losses else float("nan")
        dt = time.time() - t0
        self.step_losses = losses
        self._account(self.train_batches, events, dt)
        return {
            "train_loss": train_loss,
            "train_samples_per_sec": n_samples / dt,
            "train_time": dt,
            "step_time_ms": 1000.0 * dt / max(1, len(losses)),
            # effective host->device IO rate (ref deterministic_trainer.py:465-474)
            "effective_io_rate_gbs": io_bytes / dt / 1e9,
        }

    def _account(self, batches: DeviceBatches, events, wall_s: float):
        """The epoch's host and card account (``host_stats``); reads the
        events, which the loss read above has already waited for."""
        stats = batches.stats()
        step_ms = [s.elapsed_time(e) for s, e in events]
        stats.update(wall_s=wall_s, step_device_ms=step_ms)
        if step_ms:
            stats["idle_share"] = 1.0 - sum(step_ms) / (1e3 * wall_s)
        self.host_stats = stats

    @torch.no_grad()
    def _validation_rollouts(self):
        """Each validation batch stepped ``valid_autoreg_steps`` + 1 times from
        its initial condition, the prediction appended to the history window,
        the metrics and the loss scored at every step; returns each batch's
        mean loss, on the card."""
        n_hist = self.params.get("n_history", 0)
        n_out = len(self.params.get("out_channels"))
        T = n_hist + 1
        S = self.params.get("valid_autoreg_steps", 0) + 1
        valid_losses = []
        for batch in self.valid_batches:
            inp, tar, zen = batch["inp"], batch["tar"], batch.get("zen")
            inpt = inp
            step_losses = []
            for step in range(S):
                zwin = None if zen is None else zen[:, step : step + T]
                pred = self.model(inpt, zwin, train=False)
                tstep = tar[:, step * n_out : (step + 1) * n_out]
                self.metrics.update(pred, tstep, step)
                step_losses.append(self.loss_obj(pred, tstep, train=False))
                if step < S - 1:
                    inpt = self.preprocessor.append_history(inpt, pred, step)
            valid_losses.append(torch.mean(torch.stack(step_losses)))
        return valid_losses

    def validate_one_epoch(self):
        """The autoregressive validation rollout (``_validation_rollouts``)
        and its metrics; the loss is the mean over every lead step."""
        self.model.eval()
        self.metrics.reset()
        valid_losses = self._validation_rollouts()
        logs = self.metrics.finalize()
        logs["valid_loss"] = torch.mean(torch.stack(valid_losses)).item() if valid_losses else float("nan")
        return logs

    def train(self):
        """Train up to ``max_epochs``; returns each epoch's logs (also kept in
        ``logs``)."""
        max_epochs = self.params.get("max_epochs", 1)
        all_logs = self.logs = []

        exp_logger = None
        if self.world_rank == 0 and self.params.get("exp_dir"):
            from makani_torch.utils.logging_utils import ExperimentLogger

            exp_logger = ExperimentLogger(
                self.params.get("exp_dir"),
                config=self.params.to_dict() if hasattr(self.params, "to_dict") else None,
                log_to_wandb=self.params.get("log_to_wandb", False),
                name=self.params.get("run_name"),
            )

        while self.epoch < max_epochs:
            self.epoch += 1
            # the shuffle order pinned to the global epoch: a restart
            # resumes the same batch sequence
            self.train_batches.set_epoch(self.epoch)
            train_logs = self.train_one_epoch()
            valid_logs = self.validate_one_epoch()
            logs = {**train_logs, **valid_logs, "epoch": self.epoch}
            all_logs.append(logs)
            if self.world_rank == 0:
                logger.info(
                    f"epoch {self.epoch}: train_loss={logs['train_loss']:.5f} "
                    f"valid_loss={logs['valid_loss']:.5f} "
                    f"samples/s={logs['train_samples_per_sec']:.2f}"
                )
            if exp_logger is not None:
                exp_logger.log(logs, step=self.epoch)
            is_best = logs["valid_loss"] < self.best_valid_loss
            if is_best:
                self.best_valid_loss = logs["valid_loss"]
            if self.params.get("save_checkpoint", "none") != "none":
                self.checkpoint.save(
                    self.model,
                    self.optimizer,
                    meta={"epoch": self.epoch, "iters": self.iters, "best_valid_loss": self.best_valid_loss},
                    is_best=is_best,
                )
        return all_logs
