#!/usr/bin/env python3
"""Where one step of the port spends its device time, on one GPU.

    python3 profile_step.py fcn3      # the FCN3 ensemble step (E=2), kernel path
    python3 profile_step.py sfno      # the SFNO flagship step (B=1)
    python3 profile_step.py train     # the SFNO training step of bench.py (B=3)
    python3 profile_step.py fcn3-train  # the FCN3 recipe's ensemble-CRPS training step (B=1, E=4)
    python3 profile_step.py recipe    # the SFNO recipe's training step (721x1440, B=1)
    python3 profile_step.py fcn31     # the FCN3.1 forecast step (fcn31_sc2_edim256_layers10, E=2)
    python3 profile_step.py fcn31-history  # its history variant (a window of 2 states, E=2)
    python3 profile_step.py fcn31-train  # the FCN3.1 recipe's ensemble-CRPS training step (361x720, B=1, E=4)
    python3 profile_step.py afno      # FourCastNet v1 afno_73ch's forecast step (B=1); afnov2, vit alike
    python3 profile_step.py afno-train  # its training step (train_step, the recipe's Adam, B=1); afnov2-train, vit-train alike
    python3 profile_step.py fcn3 --plain --out DIR
    python3 profile_step.py --trace build/profile/profile_fcn3_kernel.json

Builds the model exactly as ``chip_smoke.py`` does (seeded weights, stats,
initial condition and noise), runs two warm-up steps, then one step under
``torch.profiler`` (CPU and CUDA activities). Prints the wall time, the device
busy time and share, and the device time by kernel, largest first, grouped
into the port's kernels (by their launch sites), cuBLAS GEMMs, cuFFT,
copies and elementwise passes, and the copy kernels' device time by the
PyTorch operator that launched them. Writes the Chrome trace to ``--out``
(default ``build/profile``, git-ignored). Needs one CUDA device, except with
``--trace``, which repeats the copy attribution on a trace written by an
earlier run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter, defaultdict

import numpy as np
import torch

import chip_smoke as cs


def group(name: str) -> str:
    n = name.lower()
    rules = [
        ("mixer_tile_kernel<0", "K18 AFNO mixer (CUDA, wgmma)"),
        ("mixer_tile_kernel<1", "K19 AFNO mixer backward (CUDA, wgmma)"),
        ("afno_grad_", "K19 AFNO mixer backward (CUDA, wgmma)"),
        ("dhconv_grad_weight", "K9 dhconv weight gradient (CUDA)"),
        ("instance_norm_grad", "K10 instance-norm backward (CUDA)"),
        ("factored_", "K11 factored Adam (CUDA)"),
        ("sumsq_kernel", "K16 global norm and clip (CUDA)"),
        ("clip_kernel", "K16 global norm and clip (CUDA)"),
        ("adam_kernel", "K17 Adam (CUDA)"),
        ("disco_band_grad", "K12 disco_band transpose (CUDA)"),
        ("first_grad", "K13 disco_polar transposes (CUDA)"),
        ("resample_grad", "K14 resample transpose (CUDA)"),
        ("crps_", "K15 CRPS forward and backward (CUDA)"),
        ("disco_band", "K5 disco_band (CUDA)"),
        ("disco_mix", "K8 disco_mix (CUDA, wgmma)"),
        ("psi_first", "K6 disco_polar psi-first (CUDA)"),
        ("mix_first", "K6 disco_polar mix-first (CUDA)"),
        ("resample", "K7 resample (CUDA)"),
        ("legendre_analysis_tc", "K1 Legendre analysis (CUDA, wgmma)"),
        ("legendre_synthesis_tc", "K2 Legendre synthesis (CUDA, wgmma)"),
        ("legendre_synthesis_narrow", "K2 Legendre synthesis (CUDA, narrow N)"),
        ("legendre", "K1/K2 Legendre bf16 (CUDA, FMA)"),
        ("dhconv", "K3 dhconv (CUDA)"),
        ("instance_norm_kernel", "K4 instance norm (CUDA)"),
        ("gemm", "GEMM (cuBLAS)"),
        ("nvjet", "GEMM (cuBLAS)"),
        ("softmax", "softmax"),
        ("sm90_xmma", "GEMM (cuBLAS)"),
        ("cutlass", "GEMM (cuBLAS)"),
        ("fft", "FFT (cuFFT)"),
        ("conv", "convolution (cuDNN)"),
        ("copy", "copies and casts"),
        ("index", "gathers, index_add, index_copy"),
        ("scatter_gather", "gathers, index_add, index_copy"),
        ("reduce", "reductions"),
        ("elementwise", "elementwise"),
        ("vectorized", "elementwise"),
    ]
    for key, label in rules:
        if key in n:
            return label
    return "other"


def copy_sources(trace_path: str, top: int = 10):
    """Device time of the copy kernels in a Chrome trace, by the chain of
    PyTorch operators around the launch that issued each one."""
    events = json.load(open(trace_path))["traceEvents"]
    launches = {e["args"].get("correlation"): e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e}
    ops = defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op":
            ops[e["tid"]].append(e)
    by_chain = Counter()
    for k in events:
        if k.get("cat") != "kernel" or ("copy" not in k["name"] and "Memcpy" not in k["name"]):
            continue
        r = launches.get(k["args"].get("correlation"))
        chain = [e["name"] for e in ops[r["tid"]] if e["ts"] <= r["ts"] <= e["ts"] + e["dur"]] if r else ["?"]
        by_chain[" > ".join(n for n in chain if not n.startswith("aten::empty"))] += k["dur"]
    print("copy kernels by launching operator chain:")
    for chain, us in by_chain.most_common(top):
        print(f"  {us / 1e3:10.2f} ms  {chain[-160:]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    tokens = {"afno": cs.AFNO_CONFIG, "afnov2": cs.AFNOV2_CONFIG, "vit": cs.VIT_CONFIG}
    models = ["fcn3", "sfno", "train", "fcn3-train", "recipe", "fcn31", "fcn31-history", "fcn31-train", *tokens, *(f"{t}-train" for t in tokens)]
    ap.add_argument("model", choices=models, nargs="?")
    ap.add_argument("--plain", action="store_true", help="profile the plain PyTorch path instead of the kernels")
    ap.add_argument("--out", default="build/profile", help="directory for the Chrome trace")
    ap.add_argument("--trace", help="only attribute the copies of an existing trace")
    args = ap.parse_args()
    if args.trace:
        copy_sources(args.trace)
        return 0
    if args.model is None:
        ap.error(f"name a model ({', '.join(models)}) or pass --trace")
    if not torch.cuda.is_available():
        print("profile_step: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from makani_torch import kernels
    from makani_torch.utils.zenith_angle import cos_zenith_angle_from_timestamp

    dev = cs.device()
    card = cs.card_line()
    kernels.library()
    if args.model == "fcn3":
        params, model, wrapper, x0, noise = cs.build_fcn3(dev)
        H, W = params.img_shape_x, params.img_shape_y
        E = cs.FCN3_ENSEMBLE
        lon2d, lat2d = np.meshgrid(360.0 * np.arange(W) / W, 90.0 - 180.0 * np.arange(H) / (H - 1))
        zen = torch.from_numpy(cos_zenith_angle_from_timestamp(1.5e9, lon2d, lat2d).astype(np.float32)).to(dev)[None, None, None]
        unp = torch.cat([zen.expand(E, 1, 1, H, W), cs.noise_fields(noise, E, dev, cs.SEED + 99)], dim=2)
        xm = x0.repeat_interleave(E, dim=0)

        def step():
            return wrapper(xm, unp)

    elif args.model in ("fcn31", "fcn31-history"):
        config = cs.FCN31_CONFIG if args.model == "fcn31" else cs.FCN31_HISTORY_CONFIG
        params, model, wrapper, x0, noise = cs.build_fcn31(dev, config)
        E = cs.FCN3_ENSEMBLE
        xm = x0.repeat_interleave(E, dim=0)
        unp = cs.first_unpredicted(params, noise, E, dev, 1.5e9, cs.SEED + 98)

        def step():
            return wrapper(xm, unp)

    elif args.model in tokens:
        params, model, wrapper, x0 = cs.build_token(dev, tokens[args.model])
        H, W = params.img_shape_x, params.img_shape_y
        lon2d, lat2d = np.meshgrid(360.0 * np.arange(W) / W, 90.0 - 180.0 * np.arange(H) / (H - 1))
        zen = torch.from_numpy(cos_zenith_angle_from_timestamp(1.5e9, lon2d, lat2d).astype(np.float32)).to(dev)[None, None, None]

        def step():
            with torch.no_grad():
                return wrapper(x0, zen)

    elif args.model.endswith("-train") and args.model[: -len("-train")] in tokens:
        from makani_torch.utils.loss import LossHandler
        from makani_torch.utils.training.deterministic_trainer import train_step
        from makani_torch.utils.training.optimizer import get_optimizer

        config = tokens[args.model[: -len("-train")]]
        params, model, _, _ = cs.build_token(dev, config)
        loss_obj = LossHandler(cs.token_params(config))
        opt = get_optimizer(cs.token_params(config), model)
        opt.use_kernels = not args.plain
        batch = cs.token_batch(params, dev)

        def step():
            return train_step(model, loss_obj, opt, *batch)

    elif args.model == "fcn31-train":
        from makani_torch.utils.training.ensemble_trainer import ensemble_train_step
        from makani_torch.utils.training.optimizer import get_optimizer

        params, model, loss_obj = cs.build_fcn31_train(dev)
        opt = get_optimizer(params, model, cs.FCN3_STEPS_PER_EPOCH)
        opt.use_kernels = loss_obj.loss_fns[0].use_kernels = not args.plain
        inp, tar, unp = cs.fcn3_train_batch(dev, params)

        def step():
            return ensemble_train_step(model, loss_obj, opt, inp, tar, unp, cs.FCN3_TRAIN_ENSEMBLE)

    elif args.model == "train":
        from makani_torch.utils.training.deterministic_trainer import train_step
        from makani_torch.utils.training.optimizer import get_optimizer

        params, model, loss_obj = cs.build_train(dev)
        opt = get_optimizer(params, model)
        opt.use_kernels = not args.plain
        inp, tar, zen = cs.train_batch(dev)

        def step():
            return train_step(model, loss_obj, opt, inp, tar, zen)

    elif args.model == "recipe":
        from makani_torch.utils.training.deterministic_trainer import train_step
        from makani_torch.utils.training.optimizer import get_optimizer

        params, model, loss_obj = cs.build_recipe(dev)
        opt = get_optimizer(params, model, cs.recipe_steps_per_epoch(params))
        opt.use_kernels = not args.plain
        batch = cs.recipe_batch(dev, params)

        def step():
            return train_step(model, loss_obj, opt, *batch)

    elif args.model == "fcn3-train":
        from makani_torch.utils.training.ensemble_trainer import ensemble_train_step
        from makani_torch.utils.training.optimizer import get_optimizer

        params, model, loss_obj = cs.build_fcn3_train(dev)
        opt = get_optimizer(params, model, cs.FCN3_STEPS_PER_EPOCH)
        opt.use_kernels = loss_obj.loss_fns[0].use_kernels = not args.plain
        inp, tar, unp = cs.fcn3_train_batch(dev, params)

        def step():
            return ensemble_train_step(model, loss_obj, opt, inp, tar, unp, cs.FCN3_TRAIN_ENSEMBLE)

    else:
        params, model, wrapper, x0 = cs.build_sfno(dev)
        H, W = params.img_shape_x, params.img_shape_y
        lon2d, lat2d = np.meshgrid(360.0 * np.arange(W) / W, 90.0 - 180.0 * np.arange(H) / (H - 1))
        zen = torch.from_numpy(cos_zenith_angle_from_timestamp(1.5e9, lon2d, lat2d).astype(np.float32)).to(dev)[None, None, None]

        def step():
            return wrapper(x0, zen)

    kernels.set_use_kernels(model, not args.plain)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    path = "plain" if args.plain else "kernel"
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, f"profile_{args.model}_{path}.json")
    prof.export_chrome_trace(trace)

    by_group = defaultdict(float)
    by_name = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        by_group[group(evt.key)] += us
        by_name[evt.key][0] += us
        by_name[evt.key][1] += evt.count
    busy = sum(by_group.values()) / 1e3
    print(card)
    print(f"{args.model} step, {path} path: wall {wall:.2f} ms, device busy {busy:.2f} ms ({100 * busy / wall:.1f}% of wall)  [{card}]")
    for label, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3:10.2f} ms  {100 * us / 1e3 / busy:5.1f}%  {label}")
    print("top device kernels:")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {us / 1e3:10.2f} ms  x{n:4d}  {name[:150]}")
    copy_sources(trace)
    print(f"trace: {trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
