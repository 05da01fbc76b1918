"""The ensemble training step (counterpart of ``expand_ensemble``,
``fold_ensemble``, ``EnsembleTrainer._prepare_ensemble_batch`` and
``EnsembleTrainer._build_ens_train_step`` in
``makani_tpu/utils/training/ensemble_trainer.py``).

The E members of each sample are folded into the batch, member-major per
sample (row b*E + e), and told apart by the input-noise channels appended
to the unpredicted input, drawn before the step. The step runs the forward
of the multistep wrapper with ``train=True`` on the folded batch, scores the
(B, E, ...) predictions with the loss handler (the probabilistic losses
couple the members), and takes the backward and the optimizer's update.
``fold_chunk`` = c < E runs the forward in E/c member chunks, each
recomputed in the backward (``torch.utils.checkpoint``), so that the
activations of one chunk exist at a time; only the predictions persist for
the joint loss. The ``EnsembleTrainer`` class, with its data, epochs,
validation and checkpoints, is not ported yet.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["expand_ensemble", "fold_ensemble", "prepare_ensemble_batch", "ensemble_train_step"]


def expand_ensemble(x: torch.Tensor, E: int) -> torch.Tensor:
    """(B, ...) -> (B*E, ...) by repetition, member-major per sample."""
    return x.repeat_interleave(E, dim=0)


def fold_ensemble(x: torch.Tensor, E: int) -> torch.Tensor:
    """(B*E, ...) -> (B, E, ...)."""
    return x.reshape(x.shape[0] // E, E, *x.shape[1:])


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
    E = ensemble_size
    if centered and E % 2:
        raise ValueError(f"centered (antithetic) noise needs an even ensemble size, got {E}")
    rows = inp.shape[0] * E
    draw = rows // 2 if centered else rows
    state = noise.init_state(generator, draw)
    fields = [noise.sample(state)[:, 0]]
    for _ in range(1, total_steps):
        state = noise.update(state, generator)
        fields.append(noise.sample(state)[:, 0])
    seq = torch.stack(fields, dim=1)  # (draw, T, Cn, H, W)
    if centered:
        seq = torch.stack([seq, -seq], dim=1).reshape(rows, *seq.shape[1:])
    seq = seq.to(inp.device)
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
