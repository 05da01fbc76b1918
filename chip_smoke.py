#!/usr/bin/env python3
"""Smoke run of the PyTorch port (makani_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (CUDA toolkit) and triton; exits non-zero, with no
result line, without them or outside a checkout of the repository. Phases, in
order, each fatal on failure:

 1. print the card's name and power limit; build the CUDA kernels from
    ``makani_torch/csrc`` and print the build time;
 2. compare each hand-written kernel (K1 SHT analysis, K2 SHT synthesis,
    K3 dhconv, K4 instance norm) with its plain PyTorch version at the
    flagship's shapes, in fp32 and bf16, and time both;
 3. build ``sfno_linear_73chq_sc3_layers8_edim384`` (config/sfnonet.yaml:
    721x1440, 73 channels + zenith, embed 384, 8 blocks, bf16 compute) through
    ``get_model`` on seeded weights, wrap it in ``ModelWrapper`` with seeded
    per-channel stats, and roll it out for 4 six-hour steps from a seeded
    initial condition, recomputing the zenith angle each step;
 4. check the kernel launch counts of that rollout (per forward step K1 8,
    K2 10, K3 8, K4 16);
 5. run step 1 again through the plain PyTorch versions on the card and
    compare, in bf16 and with fp32 compute on the same weights; and run a
    small fp32 SFNO both ways;
 6. time a forecast step on both paths and report peak memory.

Prints the kernel table as one JSON line before the last line, and as the
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = ("config/sfnonet.yaml", "sfno_linear_73chq_sc3_layers8_edim384")
SEED = 0
STEPS = 4
EXPECTED_PER_STEP = {"sht_analysis": 8, "sht_synthesis": 10, "dhconv": 8, "instance_norm": 16}

# Tolerances, kernel vs its plain version on identical inputs:
#  fp32: max|diff| <= 1e-5 * max|ref|. Both sum in fp32, in different orders,
#        over at most 721 terms (the full-resolution Legendre quadrature).
#  bf16: max|diff| within one bf16 ulp of max|ref| (2**(floor(log2 max|ref|) - 7)),
#        or relative L2 <= 1e-2. Both accumulate in fp32 and round once to bf16,
#        except the plain dhconv, which rounds its four real products first.
FP32_TOL = 1e-5
BF16_REL_L2 = 1e-2
# Flagship, kernel path vs plain path on the card, same weights and input:
#  bf16 compute: relative L2 <= 3e-2. bf16 rounds every activation, and the
#        paths' fp32-level differences in the kernels flip roundings that grow
#        into bf16 noise over 8 blocks: a bf16 forward sits ~1.1% from the fp32
#        one (measured on the JAX package), so two bf16 paths with independent
#        roundings differ by ~sqrt(2) * 1.1% ~ 1.6%. A wrong kernel is O(1).
#  fp32 compute (the same weights): max|diff| <= 1e-4 * max|ref|, summation
#        order only, as the whole-model CPU tests against JAX.
MODEL_BF16_REL_L2 = 3e-2
MODEL_FP32_TOL = 1e-4


def device() -> torch.device:
    return torch.device("cuda", 0)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    out, ref = out.float(), ref.float()
    max_abs = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    return {"max_abs_err": max_abs, "max_rel": max_abs / scale, "rel_l2": ((out - ref).norm() / ref.norm()).item(), "max_ref": scale}


def within(err: dict, dtype: torch.dtype) -> bool:
    if dtype == torch.float32:
        return err["max_rel"] <= FP32_TOL
    ulp = 2.0 ** (math.floor(math.log2(err["max_ref"])) - 7)
    return err["max_abs_err"] <= ulp or err["rel_l2"] <= BF16_REL_L2


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def randn(shape, dtype, gen, device):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)


def check_kernels(dev, card, transforms, embed_dim):
    """Phase 2: every kernel against its plain version at the model's shapes;
    returns {(name, resolution, dtype): result}."""
    from makani_torch.models.common.contractions import _PermutedWeight, contract_dense_s, contract_dense_s_plain
    from makani_torch.models.common.layer_norm import instance_norm_cl, instance_norm_cl_plain
    from makani_torch.ops import sht

    trans_down, itrans_up, trans, itrans = transforms
    C = embed_dim
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, t in (("full", trans_down), ("internal", trans)):
            x = randn((1, t.nlat, t.mmax, C, 2), dtype, gen, dev)
            w = t.weights(dev, dtype)
            cases.append(("sht_analysis", label, dtype, lambda x=x, w=w: sht.analysis_contract_cl_s(x, w), lambda x=x, w=w: sht.analysis_contract_cl_s_plain(x, w)))
        for label, t in (("full", itrans_up), ("internal", itrans)):
            c = randn((1, t.lmax, t.mmax, C, 2), dtype, gen, dev)
            p = t.pct(dev, dtype)
            cases.append(("sht_synthesis", label, dtype, lambda c=c, p=p: sht.synthesis_contract_cl_s(c, p), lambda c=c, p=p: sht.synthesis_contract_cl_s_plain(c, p)))
        x = randn((1, itrans.lmax, itrans.mmax, 1, C, 2), dtype, gen, dev)
        wd = randn((1, C, C, itrans.lmax, 2), torch.float32, gen, dev) * 0.05
        cache = _PermutedWeight()
        cases.append(
            (
                "dhconv",
                "internal",
                dtype,
                lambda x=x, wd=wd, cache=cache: contract_dense_s(x, wd, False, "dhconv", True, weight_cache=cache),
                lambda x=x, wd=wd: contract_dense_s_plain(x, wd, False, "dhconv", True),
            )
        )
        for label, t, nlat_phys in (("full", itrans_up, itrans_up.nlat), ("internal", itrans, itrans.nlat), ("internal-masked", itrans, itrans.nlat - 7)):
            xn = (3.0 * randn((1, t.nlat, t.nlon, C), torch.float32, gen, dev) + 1.5).to(dtype)
            wn = 1.0 + 0.1 * randn((C,), torch.float32, gen, dev)
            bn = 0.1 * randn((C,), torch.float32, gen, dev)
            cases.append(
                (
                    "instance_norm",
                    label,
                    dtype,
                    lambda xn=xn, wn=wn, bn=bn, n=nlat_phys: instance_norm_cl(xn, wn, bn, n),
                    lambda xn=xn, wn=wn, bn=bn, n=nlat_phys: instance_norm_cl_plain(xn, wn, bn, n),
                )
            )

    results = {}
    for name, label, dtype, kern, plain in cases:
        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise RuntimeError(f"{name} {label} {dtype}: kernel gave {tuple(out.shape)} {out.dtype}, plain {tuple(ref.shape)} {ref.dtype}")
        err = errors(out, ref)
        shape = tuple(out.shape)
        del out, ref
        ms, plain_ms = time_ms(kern), time_ms(plain)
        ok = within(err, dtype)
        dt = str(dtype).replace("torch.", "")
        print(
            f"kernel {name:13s} {label:15s} {dt:8s} out {shape}: max|d| {err['max_abs_err']:.3e} "
            f"max|d|/max|ref| {err['max_rel']:.3e} relL2 {err['rel_l2']:.3e} {'ok' if ok else 'FAIL'}; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms  [{card}]",
            flush=True,
        )
        if not ok:
            raise RuntimeError(f"{name} {label} {dt}: kernel disagrees with its plain version: {err}")
        results[(name, label, dtype)] = dict(err, ms=ms, plain_ms=plain_ms, shape=shape)
    return results


def build_flagship(dev, compute_dtype=None):
    from makani_torch.models.model_package import ModelWrapper
    from makani_torch.models.model_registry import get_model
    from makani_torch.utils.yparams import YParams

    params = YParams(os.path.join(REPO, CONFIG[0]), CONFIG[1])
    if compute_dtype is not None:
        params["compute_dtype"] = compute_dtype
    n_chan = len(params.channel_names)
    params["in_channels"] = list(range(n_chan))
    params["out_channels"] = list(range(n_chan))
    model, _ = get_model(params, multistep=True, device=dev, seed=SEED)
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    bias = randn((1, n_chan, 1, 1), torch.float32, gen, dev)
    scale = 0.5 + torch.rand((1, n_chan, 1, 1), generator=gen, device=dev)
    H, W = params.img_shape_x, params.img_shape_y
    x0 = bias + scale * randn((1, n_chan, H, W), torch.float32, gen, dev)
    return params, model, ModelWrapper(model, bias=bias, scale=scale), x0


def compare_paths(model, wrapper, x, zen, kernel_out=None) -> dict:
    """One forecast step through the kernels and through the plain versions,
    compared in normalized units (the stats would otherwise dominate)."""
    from makani_torch import kernels

    if kernel_out is None:
        kernel_out = wrapper(x, zen)
    kernels.set_use_kernels(model, False)
    plain_out = wrapper(x, zen)
    kernels.set_use_kernels(model, True)
    return errors((kernel_out - wrapper.bias) / wrapper.scale, (plain_out - wrapper.bias) / wrapper.scale)


def small_model_check(dev):
    """A small fp32 SFNO (ragged shapes) through the kernels and through the
    plain versions on the card."""
    from makani_torch import kernels
    from makani_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet

    model = SphericalFourierNeuralOperatorNet(
        inp_shape=(61, 120), out_shape=(61, 120), scale_factor=2, inp_chans=7, out_chans=6, embed_dim=48, num_layers=3, device=dev
    )
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    x = randn((2, 7, 61, 120), torch.float32, gen, dev)
    with torch.no_grad():
        y = model(x)
        kernels.set_use_kernels(model, False)
        ref = model(x)
    torch.cuda.synchronize()
    err = errors(y, ref)
    ok = bool(torch.isfinite(y).all()) and err["max_rel"] <= MODEL_FP32_TOL
    print(f"small fp32 SFNO (61x120, 3 blocks) kernel vs plain path: max|d|/max|ref| {err['max_rel']:.3e} (tol {MODEL_FP32_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"small SFNO kernel path disagrees with the plain path: {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    # the port, from this checkout (an import error ends the run here)
    from makani_torch import kernels
    from makani_torch.models.model_package import rollout
    from makani_torch.ops.precision import transform_io_dtype
    from makani_torch.utils.zenith_angle import cos_zenith_angle_from_timestamp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = device()

    # ---- phase 1: card and build
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.library()
    print(f"built {os.path.relpath(so, REPO)} in {time.perf_counter() - t0:.1f} s (nvcc {' '.join(kernels.NVCC_FLAGS)})", flush=True)
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- phase 2: kernels vs plain at the flagship's shapes (the model's own transforms)
    t0 = time.perf_counter()
    params, model, wrapper, x0 = build_flagship(dev)
    net = model.model
    nparam = sum(p.numel() for p in model.parameters())
    print(f"built {CONFIG[1]} ({nparam} parameters, compute {params.compute_dtype}, {params.img_shape_x}x{params.img_shape_y} -> "
          f"internal {net.h}x{net.w}, lmax/mmax {net.trans.lmax}/{net.trans.mmax}, {params.N_in_channels} in / {params.N_out_channels} out channels) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    kres = check_kernels(dev, card, (net.trans_down, net.itrans_up, net.trans, net.itrans), net.embed_dim)
    print(f"phase 2 (kernel checks) {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # ---- phase 3: the flagship forecast through the kernels
    H, W = params.img_shape_x, params.img_shape_y
    lat = 90.0 - 180.0 * np.arange(H) / (H - 1)
    lon = 360.0 * np.arange(W) / W
    t_start = 1.5e9
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    frames = rollout(wrapper, x0, lat, lon, t_start, params.dhours, STEPS)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for i, f in enumerate(frames):
        if f.shape != x0.shape or not bool(torch.isfinite(f).all()):
            raise RuntimeError(f"rollout step {i + 1}: shape {tuple(f.shape)} or non-finite values")
        print(f"rollout step {i + 1} (+{(i + 1) * params.dhours} h): shape {tuple(f.shape)}, finite, mean {f.mean().item():.4f}, std {f.std().item():.4f}")

    # ---- phase 4: launch counts
    expected = {k: v * STEPS for k, v in EXPECTED_PER_STEP.items()}
    print(f"launches over {STEPS} steps: {launches} (per step {({k: v / STEPS for k, v in launches.items()})})")
    if launches != expected:
        raise RuntimeError(f"launch counts {launches} != expected {expected}")

    # ---- phase 5: plain path on the card, step 1 (bf16, and fp32 compute on the same weights)
    lon2d, lat2d = np.meshgrid(lon, lat)
    zen = torch.from_numpy(cos_zenith_angle_from_timestamp(t_start, lon2d, lat2d).astype(np.float32)).to(dev)[None, None, None]
    err = compare_paths(model, wrapper, x0, zen, frames[0])
    ok = err["rel_l2"] <= MODEL_BF16_REL_L2
    print(f"flagship step 1 ({params.compute_dtype}), kernel path vs plain path (normalized units): relL2 {err['rel_l2']:.3e} "
          f"(tol {MODEL_BF16_REL_L2}), max|d|/max|ref| {err['max_rel']:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"flagship kernel path disagrees with the plain path: {err}")
    del frames
    _, model32, wrapper32, _ = build_flagship(dev, compute_dtype="float32")
    err = compare_paths(model32, wrapper32, x0, zen)
    ok = err["max_rel"] <= MODEL_FP32_TOL
    print(f"flagship step 1 (float32 compute, same weights), kernel path vs plain path: max|d|/max|ref| {err['max_rel']:.3e} "
          f"(tol {MODEL_FP32_TOL}), relL2 {err['rel_l2']:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"flagship fp32 kernel path disagrees with the plain path: {err}")
    del model32, wrapper32
    torch.cuda.empty_cache()
    small_model_check(dev)

    # ---- phase 6: step latency and peak memory, in turns
    def step():
        return wrapper(x0, zen)

    times = {"kernel": [], "plain": []}
    peaks = {}
    for path in ("kernel", "plain", "kernel", "plain"):
        kernels.set_use_kernels(model, path == "kernel")
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            step()
            e.record()
            torch.cuda.synchronize()
            times[path].append(s.elapsed_time(e))
        peaks[path] = max(peaks.get(path, 0), torch.cuda.max_memory_allocated())
    kernels.set_use_kernels(model, True)
    for path in ("kernel", "plain"):
        print(f"forecast step ({path} path): median {statistics.median(times[path]):.2f} ms over {len(times[path])} steps "
              f"{[round(t, 2) for t in times[path]]}, peak memory {peaks[path] / 2**30:.2f} GiB  [{card}]")

    # ---- result
    main_path = {"sht_analysis": "full", "sht_synthesis": "full", "dhconv": "internal", "instance_norm": "full"}
    io, compute = transform_io_dtype(), net.dtype
    main_dtype = {"sht_analysis": io, "sht_synthesis": io, "dhconv": io, "instance_norm": compute}
    meta = {
        "sht_analysis": ("cuda", "makani_torch/csrc/sht_legendre.cu", "makani_tpu/ops/sht.py:54"),
        "sht_synthesis": ("cuda", "makani_torch/csrc/sht_legendre.cu", "makani_tpu/ops/sht.py:59"),
        "dhconv": ("cuda", "makani_torch/csrc/dhconv.cu", "makani_tpu/models/common/contractions.py:45"),
        "instance_norm": ("triton", "makani_torch/models/common/layer_norm.py", "makani_tpu/models/common/layer_norm.py:78"),
    }
    table = []
    for name, (route, source, replaces) in meta.items():
        r = kres[(name, main_path[name], main_dtype[name])]
        table.append(
            {"name": name, "route": route, "source": source, "replaces": replaces, "launches": launches[name],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
        )
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
