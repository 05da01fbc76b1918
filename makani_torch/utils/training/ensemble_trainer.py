"""The ensemble trainer (counterpart of
``makani_tpu/utils/training/ensemble_trainer.py``) on one card.

The E members of each sample are folded into the batch, member-major per
sample (row b*E + e), and told apart by the input-noise channels appended
to the unpredicted input, drawn before the step. The step runs the forward
of the multistep wrapper with ``train=True`` on the folded batch, scores the
(B, E, ...) predictions with the loss handler (the probabilistic losses
couple the members), and takes the backward and the optimizer's update.
``fold_chunk`` = c < E runs the forward in E/c member chunks, each
recomputed in the backward (``torch.utils.checkpoint``), so that the
activations of one chunk exist at a time; only the predictions persist for
the joint loss.

``EnsembleTrainer`` drives that step over epochs as the deterministic
``Trainer`` drives ``train_step``: one noise draw a batch from a
``torch.Generator`` on the trainer's device seeded with ``seed + 1``, the
validation rollout scored on the folded members (CRPS, spread, SSR), and
the checkpoints and resume of ``CheckpointManager``. As in the JAX package,
the noise stream is not checkpointed: a resumed run draws again from
``seed + 1``. The ``perturb`` noise mode is not ported (the preprocessor's,
ROADMAP queue 1 item 10) and raises.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from makani_torch.models.noise import build_noise
from makani_torch.utils.training.deterministic_trainer import Trainer

__all__ = ["expand_ensemble", "fold_ensemble", "noise_series", "prepare_ensemble_batch", "ensemble_train_step", "EnsembleTrainer"]


def expand_ensemble(x: torch.Tensor, E: int) -> torch.Tensor:
    """(B, ...) -> (B*E, ...) by repetition, member-major per sample."""
    return x.repeat_interleave(E, dim=0)


def fold_ensemble(x: torch.Tensor, E: int) -> torch.Tensor:
    """(B*E, ...) -> (B, E, ...)."""
    return x.reshape(x.shape[0] // E, E, *x.shape[1:])


def noise_series(noise, rows: int, total_steps: int, generator: torch.Generator, centered: bool = False) -> torch.Tensor:
    """The noise time series (rows, total_steps, Cn, H, W) of ``rows``
    members drawn from ``generator`` (``init_state``, then ``update`` for
    each later step, ``sample`` at every step); ``centered`` draws one
    series a pair of members, the second member taking its negative."""
    if centered and rows % 2:
        raise ValueError(f"centered (antithetic) noise needs an even number of members, got {rows}")
    draw = rows // 2 if centered else rows
    state = noise.init_state(generator, draw)
    fields = [noise.sample(state)[:, 0]]
    for _ in range(1, total_steps):
        state = noise.update(state, generator)
        fields.append(noise.sample(state)[:, 0])
    seq = torch.stack(fields, dim=1)  # (draw, T, Cn, H, W)
    if centered:
        seq = torch.stack([seq, -seq], dim=1).reshape(rows, *seq.shape[1:])
    return seq


def prepare_ensemble_batch(noise, inp: torch.Tensor, tar: torch.Tensor, zen: torch.Tensor | None, ensemble_size: int, total_steps: int,
                           generator: torch.Generator, centered: bool = False):
    """Fold the ensemble into the batch and attach the noise channels.

    inp (B, C, H, W) -> (B*E, C, H, W); zen (B, T, Cz, H, W) or None; the
    noise time series of ``total_steps`` steps is drawn for every member from
    ``generator`` (``init_state``, then ``update`` for each later step,
    ``sample`` at every step); ``centered`` draws one series a pair of
    members, the second member taking its negative. Returns (inp, tar, unp),
    unp (B*E, T, Cz + Cn, H, W) with the noise after the zenith channels.
    tar is not folded."""
    if centered and ensemble_size % 2:
        raise ValueError(f"centered (antithetic) noise needs an even ensemble size, got {ensemble_size}")
    E = ensemble_size
    seq = noise_series(noise, inp.shape[0] * E, total_steps, generator, centered).to(inp.device)
    unp = seq if zen is None else torch.cat([expand_ensemble(zen, E).to(seq.dtype), seq], dim=2)
    return expand_ensemble(inp, E), tar, unp


def _forward_folded(model, inp, unp, E: int, chunk: int):
    """The folded forward, in member chunks of ``chunk`` recomputed in the
    backward when 0 < chunk < E."""
    if not chunk or chunk >= E:
        return model(inp, unp, train=True)
    if E % chunk:
        raise ValueError(f"ensemble_fold_chunk {chunk} must divide ensemble_size {E}")
    n_chunks, B = E // chunk, inp.shape[0] // E

    def part(t, c):
        return t.reshape(B, n_chunks, chunk, *t.shape[1:])[:, c].reshape(B * chunk, *t.shape[1:])

    def run(xi, zi):
        return model(xi, zi, train=True)

    preds = []
    for c in range(n_chunks):
        xi, zi = part(inp, c), None if unp is None else part(unp, c)
        preds.append(checkpoint(run, xi, zi, use_reentrant=False) if torch.is_grad_enabled() else run(xi, zi))
    preds = torch.stack([p.reshape(B, chunk, *p.shape[1:]) for p in preds], dim=1)  # (B, n_chunks, chunk, ...)
    return preds.reshape(B * E, *preds.shape[3:])


def ensemble_train_step(model: torch.nn.Module, loss_obj, optimizer: torch.optim.Optimizer, inp: torch.Tensor, tar: torch.Tensor,
                        unp: torch.Tensor | None, ensemble_size: int, fold_chunk: int = 0) -> torch.Tensor:
    """One step on a folded batch (``prepare_ensemble_batch``): the forward
    of the multistep wrapper with ``train=True`` (in member chunks under
    ``fold_chunk``), the loss of the (B, E, ...) predictions against tar,
    the backward, the optimizer's update and the gradients cleared. Returns
    the loss, detached."""
    pred = fold_ensemble(_forward_folded(model, inp, unp, ensemble_size, fold_chunk), ensemble_size)
    loss = loss_obj(pred, tar, train=True)
    loss.backward()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss.detach()


class EnsembleTrainer(Trainer):
    """The deterministic ``Trainer`` with the ensemble step: every batch
    folded into ``ensemble_size`` members with a fresh noise series
    (``prepare_ensemble_batch``), the step ``ensemble_train_step`` (in member
    chunks of ``ensemble_fold_chunk``), and the validation rollout scored on
    the (B, E, ...) forecasts. ``host_stats`` adds the noise draws' device
    milliseconds (``noise_device_ms``; device work, K2's synthesis on the
    card), which the idle share counts as busy."""

    def __init__(self, params, world_rank: int = 0, device=None):
        self.ensemble_size = params.get("ensemble_size", 1)
        noise_params = params.get("input_noise", None)
        if noise_params is None:
            raise ValueError("EnsembleTrainer requires an input_noise config")
        self.centered = noise_params.get("centered", False)
        if self.centered and self.ensemble_size % 2 != 0:
            raise ValueError("centered (antithetic) noise needs an even ensemble size")
        self.noise_mode = noise_params.get("mode", "concatenate")
        if self.noise_mode != "concatenate":
            raise NotImplementedError(f"input-noise mode {self.noise_mode!r} is not ported yet (the preprocessor's perturb mode, ROADMAP queue 1 item 10)")
        self.fold_chunk = int(params.get("ensemble_fold_chunk", 0) or 0)
        if self.fold_chunk and self.fold_chunk < self.ensemble_size and self.ensemble_size % self.fold_chunk:
            raise ValueError(f"ensemble_fold_chunk {self.fold_chunk} must divide ensemble_size {self.ensemble_size}")

        super().__init__(params, world_rank, device)

        img_shape = (params.get("img_shape_x"), params.get("img_shape_y"))
        self.noise = build_noise(dict(noise_params, grid_type=params.get("model_grid_type", "equiangular")), img_shape, num_time_steps=1)
        # one stream for every draw, not checkpointed (as the JAX package's key)
        self.generator = torch.Generator(self.device).manual_seed(params.get("seed", 333) + 1)
        self.n_future = params.get("n_future", 0)

    def _fold(self, batch, total_steps: int):
        return prepare_ensemble_batch(self.noise, batch["inp"], batch["tar"], batch.get("zen"), self.ensemble_size, total_steps, self.generator, self.centered)

    def _train_steps(self):
        """The epoch's steps, as the deterministic trainer's, each batch's
        noise drawn between its own events (kept in ``_noise_events``)."""
        n_samples, io_bytes = 0, 0
        losses, events, self._noise_events = [], [], []
        total_steps = self.params.get("n_history", 0) + 1 + self.n_future
        for batch in self.train_batches:
            io_bytes += sum(v.numel() * 4 for v in batch.values())
            drawn, (start, end) = self._events()[0], self._events()
            if start is not None:
                drawn.record()
            inp, tar, unp = self._fold(batch, total_steps)
            if start is not None:
                start.record()
            loss = ensemble_train_step(self.model, self.loss_obj, self.optimizer, inp, tar, unp, self.ensemble_size, self.fold_chunk)
            if end is not None:
                end.record()
                self._noise_events.append((drawn, start))
                events.append((start, end))
            losses.append(loss)
            n_samples += batch["inp"].shape[0]
            self.iters += 1
        return losses, events, n_samples, io_bytes

    def _account(self, batches, events, wall_s: float):
        super()._account(batches, events, wall_s)
        noise_ms = [s.elapsed_time(e) for s, e in self._noise_events]
        self.host_stats["noise_device_ms"] = noise_ms
        if "idle_share" in self.host_stats:
            self.host_stats["idle_share"] -= sum(noise_ms) / (1e3 * wall_s)

    @torch.no_grad()
    def _validation_rollouts(self):
        """Each validation batch folded with a noise series of
        max(n_history + S, n_history + 1) steps and rolled out S times: the
        metrics and the loss scored on the (B, E, ...) forecast at every
        step, the unfolded forecast appended to the history; returns each
        batch's mean loss, on the card."""
        E = self.ensemble_size
        n_hist = self.params.get("n_history", 0)
        n_out = len(self.params.get("out_channels"))
        T = n_hist + 1
        S = self.params.get("valid_autoreg_steps", 0) + 1
        valid_losses = []
        for batch in self.valid_batches:
            inp, tar, unp = self._fold(batch, max(n_hist + S, T))
            inpt = inp
            step_losses = []
            for step in range(S):
                uwin = unp[:, step : step + T] if unp.shape[1] >= step + T else unp[:, -T:]
                pred = self.model(inpt, uwin, train=False)
                pred_e = fold_ensemble(pred, E)
                tstep = tar[:, step * n_out : (step + 1) * n_out]
                self.metrics.update(pred_e, tstep, step)
                step_losses.append(self.loss_obj(pred_e, tstep, train=False))
                if step < S - 1:
                    inpt = self.preprocessor.append_history(inpt, pred, step)
            valid_losses.append(torch.mean(torch.stack(step_losses)))
        return valid_losses
