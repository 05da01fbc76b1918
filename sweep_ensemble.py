#!/usr/bin/env python3
"""Two FCN3 recipe training steps that the port's other runs do not take,
measured on one NVIDIA GPU:

    python3 sweep_ensemble.py [e16] [quarter]     # default both

- ``e16``: the recipe's own ensemble of E = 16 members (B = 1) at 0.5
  degrees (``chip_smoke.fcn3_train_config``: 361x720, internal 180x360,
  ``checkpointing_level`` 3, bf16 compute, the skillspread CRPS with auto
  weights and temp_diff_normalization over seeded statistics, Adam clipped
  at 1.0 on the cosine schedule) with ``ensemble_fold_chunk`` 4: the
  forward in 4 member chunks, each recomputed in the backward.
- ``quarter``: the same recipe at its own 0.25-degree grid (721x1440,
  internal 360x720), E = 2 with ``fold_chunk`` 1.

Each takes 1 + 2 steps (``ensemble_train_step`` on a seeded batch folded
with its noise, ``prepare_ensemble_batch``) through the kernels and prints
each step's time (CUDA events), the loss, and the peak device memory
(``max_memory_allocated``); a step that runs out of memory prints the
error, which names the size it asked for. Each line names the card and its
power limit.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

import chip_smoke as cs

STEPS = 2


def one_config(dev, card, label, members, chunk, **overrides):
    from makani_torch import kernels
    from makani_torch.models.model_registry import get_model
    from makani_torch.models.noise import build_noise
    from makani_torch.utils.loss import LossHandler
    from makani_torch.utils.training.ensemble_trainer import ensemble_train_step, prepare_ensemble_batch
    from makani_torch.utils.training.optimizer import get_optimizer
    from makani_torch.utils.yparams import ParamsBase

    cfg = cs.fcn3_train_config(ensemble_size=members, ensemble_fold_chunk=chunk, compute_dtype="bfloat16", **overrides)
    cfg.update(cs.stats_files(len(cfg["channel_names"])))
    params = ParamsBase(dict(cfg))
    t0 = time.perf_counter()
    model, _ = get_model(params, multistep=True, device=dev, seed=cs.SEED)
    H, W, C = params.img_shape_x, params.img_shape_y, len(params.channel_names)
    print(f"{label}: built FCN3 ({sum(p.numel() for p in model.parameters())} parameters, {H}x{W} -> internal {model.model.h}x{model.model.w}, B=1 "
          f"E={members}, ensemble_fold_chunk {chunk}, checkpointing_level {model.model.checkpointing_level}, compute {params.compute_dtype}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    opt = get_optimizer(params, model, cs.FCN3_STEPS_PER_EPOCH)
    loss_obj = LossHandler(params)
    gen = torch.Generator(dev).manual_seed(cs.SEED + 9)
    inp, tar = (cs.randn((1, C, H, W), torch.float32, gen, dev) for _ in range(2))
    zen = cs.randn((1, 1, 1, H, W), torch.float32, gen, dev)
    noise = build_noise(dict(params.input_noise, grid_type=params.model_grid_type), (H, W), num_time_steps=1)
    batch = prepare_ensemble_batch(noise, inp, tar, zen, members, 1, torch.Generator(dev).manual_seed(cs.SEED + 10), centered=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, losses = [], []
    try:
        for _ in range(STEPS + 1):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            loss = ensemble_train_step(model, loss_obj, opt, *batch, members, chunk)
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
            losses.append(loss.item())
    except torch.cuda.OutOfMemoryError as err:
        print(f"{label}: out of memory after {len(times)} step(s), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB: "
              f"{' '.join(str(err).split())[:600]}  [{card}]", flush=True)
        return
    finally:
        del model, opt, batch
        torch.cuda.empty_cache()
    med = statistics.median(times[1:])
    print(f"{label}: step {med:.2f} ms (median of {STEPS} after a warm-up; all {[round(t, 2) for t in times]}), {members / med * 1e3:.3f} members/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, loss {[round(v, 6) for v in losses]}; launches {dict(kernels.LAUNCHES)}  "
          f"[{card}]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_ensemble: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from makani_torch import kernels

    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    kernels.library()
    parts = sys.argv[1:] or ["e16", "quarter"]
    if "e16" in parts:
        one_config(dev, card, "E=16, fold_chunk 4, 0.5 degrees", 16, 4)
    if "quarter" in parts:
        one_config(dev, card, "E=2, fold_chunk 1, 0.25 degrees", 2, 1, img_shape_x=721, img_shape_y=1440)
    return 0


if __name__ == "__main__":
    sys.exit(main())
