#!/usr/bin/env python3
"""Smoke run of the PyTorch port (makani_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (CUDA toolkit); exits non-zero, with no result
line, without them or outside a checkout of the repository. Phases, in order,
each fatal on failure:

 1. print the card's name and power limit; build the CUDA kernels from
    ``makani_torch/csrc`` (one nvcc a source, in parallel) and print the
    build time and every kernel's registers and spills;

 The SFNO forecast (slice 1):
 2. compare each hand-written kernel of the path (K1 SHT analysis, K2 SHT
    synthesis, K3 dhconv, K4 instance norm) with its plain PyTorch version at
    the flagship's shapes, in fp32 and bf16, and time both, with K4's bound
    and its two-read floor;
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
 6. time a forecast step on both paths and report peak memory;

 The FCN3 ensemble forecast (slice 2):
 7. build FCN3 (config/fourcastnet3.yaml ``base_config``: 721x1440, 73
    channels + zenith + 8 diffusion-noise channels, 10 blocks of which 0 and
    5 global, DISCO on a 360x720 Legendre-Gauss grid, bf16 compute) through
    ``get_model`` on seeded weights, with the ensemble cut to one centered
    pair (E=2, folded into the batch);
 8. compare the kernels of this path with their plain versions at its
    shapes: K5 banded DISCO contraction (responses mode at the processor,
    fused mode at the encoders and decoders), K6 polar rows (psi-first and
    mix-first orders), K8 the processor's fp32 channel mix (against cuBLAS),
    K7 bilinear resampling, and K1-K3 at the internal grid and the noise
    synthesis; time both and the one-call library yardsticks, and the polar
    rows' mix (a cuBLAS ``bmm``, no kernel);
 9. roll the ensemble out for 4 six-hour steps with diffusion noise drawn as
    the JAX package's inferencer draws it, and check every frame is finite
    and the two members differ;
10. check the launch counts of that rollout (per step K5 13, K6 13, K8 8,
    K7 2, K1 2, K3 2, K2 3);
11. run step 1 through the plain versions on the card and compare, in bf16
    and with fp32 compute on the same weights;
12. time an ensemble forecast step on both paths and report peak memory.

Prints the card line and the kernel table as one JSON line before the last
line, and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = ("config/sfnonet.yaml", "sfno_linear_73chq_sc3_layers8_edim384")
FCN3_CONFIG = ("config/fourcastnet3.yaml", "base_config")
FCN3_ENSEMBLE = 2
SEED = 0
STEPS = 4
EXPECTED_PER_STEP = {"sht_analysis": 8, "sht_synthesis": 10, "dhconv": 8, "instance_norm": 16}
# FCN3: 3 encoders + 8 local blocks + 2 decoders run one K5 and one K6 launch
# each, the 8 local blocks' two-stage convs one K8; the 2 global blocks one
# K1, K3 and K2 each; the noise synthesis one K2
FCN3_EXPECTED_PER_STEP = {"disco_band": 13, "disco_polar": 13, "disco_mix": 8, "resample": 2, "sht_analysis": 2, "dhconv": 2, "sht_synthesis": 3}

# Tolerances, kernel vs its plain version on identical inputs:
#  fp32: max|diff| <= 1e-5 * max|ref|. Both sum in fp32, in different orders,
#        over at most 855 terms (K5 at the decoders: 9 channels x 5 band rows
#        x 19 longitudes; 721 in the full-resolution Legendre quadrature), or
#        6093 in K8's channel mix, which sums 3xTF32 partials of 32 terms.
#  bf16: max|diff| within one bf16 ulp of max|ref| (2**(floor(log2 max|ref|) - 7)),
#        or relative L2 <= 1e-2. Both accumulate in fp32 and round once to bf16,
#        except the plain dhconv, which rounds its four real products first.
FP32_TOL = 1e-5
BF16_REL_L2 = 1e-2
# Whole model, kernel path vs plain path on the card, same weights and input:
#  bf16 compute: relative L2 <= 3e-2. bf16 rounds every activation of the
#        bf16 layers, and the paths' fp32-level differences in the kernels flip
#        roundings that grow into bf16 noise over the blocks: a bf16 SFNO
#        forward sits ~1.1% from the fp32 one (measured on the JAX package), so
#        two bf16 paths with independent roundings differ by ~sqrt(2) * 1.1% ~
#        1.6%. A wrong kernel is O(1).
#  fp32 compute (the same weights): max|diff| <= 1e-4 * max|ref|, summation
#        order only, as the whole-model CPU tests against JAX.
MODEL_BF16_REL_L2 = 3e-2
MODEL_FP32_TOL = 1e-4

# The card's peaks for the bound (NVIDIA H100 SXM data sheet, dense): fp32
# outside the tensor cores, the tensor cores in TF32 and bf16, and HBM3
# bandwidth. A product at fp32 accuracy on the tensor cores takes three TF32
# passes (3xTF32: hi.hi + hi.lo + lo.hi).
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
TF32_PASSES = 3
PEAK_HBM_BYTES = 3.35e12


def device() -> torch.device:
    return torch.device("cuda", 0)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def ptxas_lines(log: str) -> list[str]:
    """One line per kernel of nvcc's ``-Xptxas -v`` report: its name
    (demangled by c++filt where the machine has it), registers, shared
    memory and spills."""
    name, spill, out = "?", "", []
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            name = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append((name, f"{line.split(':', 1)[-1].strip()}; {spill}"))
            spill = ""
    filt = shutil.which("c++filt")
    if filt and out:
        res = subprocess.run([filt], input="\n".join(n for n, _ in out), capture_output=True, text=True)
        if res.returncode == 0 and len(res.stdout.splitlines()) == len(out):
            out = [(n.rsplit("(", 1)[0], d) for n, (_, d) in zip(res.stdout.splitlines(), out)]
    return [f"{n}: {d}" for n, d in out]


def errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    # one temporary the size of the output (the K5 responses are 12.6 GB)
    d = out.float() - ref.float()
    rel_l2 = (d.norm() / ref.float().norm()).item()
    max_abs = d.abs_().max().item()
    scale = ref.abs().max().item()
    return {"max_abs_err": max_abs, "max_rel": max_abs / scale, "rel_l2": rel_l2, "max_ref": scale}


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


def bound(flops: float, nbytes: float, tensor_cores: torch.dtype | None = None) -> dict:
    """The least time the card could take: the larger of the operations over
    their peak and the bytes (each input read once, each output written once)
    over the HBM bandwidth. ``fma_bound_ms`` counts the operations on the
    fp32 FMA pipes; for a product the tensor cores can take (``tensor_cores``
    = its IO dtype), ``tc_bound_ms`` counts them there (fp32 IO as three
    TF32 passes, bf16 IO as one bf16 pass), and ``bound_ms`` is the smaller
    of the two."""
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_fma = flops / PEAK_FP32_FLOPS
    res = {"fma_bound_ms": 1e3 * max(t_fma, t_bytes), "tc_bound_ms": None, "flops": flops, "bytes": nbytes}
    t_ops = t_fma
    if tensor_cores is not None:
        t_tc = TF32_PASSES * flops / PEAK_TF32_FLOPS if tensor_cores == torch.float32 else flops / PEAK_BF16_FLOPS
        res["tc_bound_ms"] = 1e3 * max(t_tc, t_bytes)
        t_ops = min(t_fma, t_tc)
    return dict(res, bound_ms=1e3 * max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def randn(shape, dtype, gen, device):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)


def run_cases(cases, card, results, iters=10, warmup=2):
    """Each case: (name, label, dtype, kernel fn, plain fn, extras fn or
    None). The kernel runs once and is held to its plain version on the same
    inputs; both are timed; extras(out) adds the bound and the library
    yardstick."""
    for name, label, dtype, kern, plain, extras in cases:
        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise RuntimeError(f"{name} {label} {dtype}: kernel gave {tuple(out.shape)} {out.dtype}, plain {tuple(ref.shape)} {ref.dtype}")
        err = errors(out, ref)
        shape = tuple(out.shape)
        del ref
        torch.cuda.empty_cache()
        extra = extras(out) if extras is not None else {}
        del out
        torch.cuda.empty_cache()
        ms, plain_ms = time_ms(kern, iters, warmup), time_ms(plain, iters, warmup)
        ok = within(err, dtype)
        dt = str(dtype).replace("torch.", "")
        more = "".join(f", {k} {extra[k]:.3f} ms" for k in ("bound_ms", "fma_bound_ms", "tc_bound_ms", "two_read_ms", "library_ms") if extra.get(k) is not None)
        more += "".join(f"; {extra[k]}" for k in ("route", "live", "library_note") if extra.get(k))
        print(
            f"kernel {name:13s} {label:17s} {dt:8s} out {shape}: max|d| {err['max_abs_err']:.3e} "
            f"max|d|/max|ref| {err['max_rel']:.3e} relL2 {err['rel_l2']:.3e} {'ok' if ok else 'FAIL'}; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{more}  [{card}]",
            flush=True,
        )
        if not ok:
            raise RuntimeError(f"{name} {label} {dt}: kernel disagrees with its plain version: {err}")
        results[(name, label, dtype)] = dict(err, ms=ms, plain_ms=plain_ms, shape=shape, **extra)
        torch.cuda.empty_cache()
    return results


def legendre_extras(x, table, mode, lead):
    """Bound and bmm yardstick of K1 (mode 0) / K2 (mode 1): for each order m
    one GEMM (rows x depth) . (depth x B*N). The table's zero triangle
    (m > l) is work and bytes the data does not need: the bound counts its
    m <= l entries only, and for K2 only the rows l >= m of the input c
    (the rows above meet nothing but that triangle's zeros)."""
    from makani_torch.ops import sht

    M, L, K = table.shape
    BN = x.numel() // (x.shape[-4] * M)
    if mode == 0:
        A, Xp = table, x.reshape(lead, K, M, -1).permute(2, 1, 0, 3).reshape(M, K, BN).contiguous()
    else:
        A, Xp = table.transpose(1, 2), x.reshape(lead, L, M, -1).permute(2, 1, 0, 3).reshape(M, L, BN).contiguous()

    def extras(out):
        flops = 2.0 * torch.count_nonzero(table).item() * BN
        pairs = sum(max(L - m, 0) for m in range(M))  # (m, l) with m <= l
        table_bytes = pairs * K * table.element_size()
        x_bytes = nbytes(x) if mode == 0 else pairs * BN * x.element_size()
        lib = time_ms(lambda: torch.bmm(A, Xp), 5, 1)
        res = dict(bound(flops, x_bytes + nbytes(out) + table_bytes, x.dtype), library_ms=lib)
        if mode == 0:
            # K1's 64-row l tiles: a tile whose rows all lie above the
            # diagonal (l < m) is dead and reads nothing
            n_lt = -(-L // 64)
            live = sum(1 for m in range(M) for lt in range(n_lt) if min(64 * lt + 64, L) > m)
            res["live"] = f"live (m, l-tile) pairs {live}/{M * n_lt} ({live / (M * n_lt):.1%})"
        elif x.dtype == torch.float32:
            res["route"] = f"route {sht.synthesis_route(2 * x.shape[-2])} (N {2 * x.shape[-2]})"
        return res

    return extras


def dhconv_extras(x, w):
    """Bound and library yardstick of K3: for fp32 one complex ``torch.bmm``
    per (l, g) over the B*M rows; for bf16 (no complex bf16 GEMM) the real
    bf16 ``torch.bmm`` of the interleaved input with the [[wr, wi], [-wi, wr]]
    block weight, the product K3 computes."""
    B, L, M, G, Ci, _ = x.shape
    Co = w.shape[2]
    xl = x.permute(1, 3, 0, 2, 4, 5).reshape(L * G, B * M, Ci, 2)
    wl = w.permute(3, 0, 1, 2, 4).reshape(L * G, Ci, Co, 2)
    if x.dtype == torch.float32:
        a, b = torch.view_as_complex(xl.contiguous()), torch.view_as_complex(wl.contiguous())
    else:
        wr, wi = wl[..., 0], wl[..., 1]
        blocks = torch.stack([torch.stack([wr, wi], -1), torch.stack([-wi, wr], -1)], 2)  # (LG, Ci, 2, Co, 2)
        a, b = xl.reshape(L * G, B * M, 2 * Ci).contiguous(), blocks.reshape(L * G, 2 * Ci, 2 * Co).to(x.dtype)

    def extras(out):
        flops = 8.0 * B * L * M * G * Ci * Co
        lib = time_ms(lambda: torch.bmm(a, b), 5, 1)
        return dict(bound(flops, nbytes(x, w.to(x.dtype), out), x.dtype), library_ms=lib)

    return extras


def check_sfno_kernels(dev, card, transforms, embed_dim):
    """Phase 2: every kernel of the SFNO path against its plain version at
    the model's shapes; returns {(name, resolution, dtype): result}."""
    from makani_torch.models.common.contractions import _PermutedWeight, contract_dense_s, contract_dense_s_plain
    from makani_torch.models.common.layer_norm import instance_norm_cl, instance_norm_cl_plain
    from makani_torch.ops import sht

    trans_down, itrans_up, trans, itrans = transforms
    C = embed_dim
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        main = dtype == torch.float32
        for label, t in (("full", trans_down), ("internal", trans)):
            x = randn((1, t.nlat, t.mmax, C, 2), dtype, gen, dev)
            w = t.weights(dev, dtype)
            ex = legendre_extras(x, w, 0, 1) if main else None
            cases.append(("sht_analysis", label, dtype, lambda x=x, w=w: sht.analysis_contract_cl_s(x, w), lambda x=x, w=w: sht.analysis_contract_cl_s_plain(x, w), ex))
        for label, t in (("full", itrans_up), ("internal", itrans)):
            c = randn((1, t.lmax, t.mmax, C, 2), dtype, gen, dev)
            p = t.pct(dev, dtype)
            ex = legendre_extras(c, p, 1, 1) if main else None
            cases.append(("sht_synthesis", label, dtype, lambda c=c, p=p: sht.synthesis_contract_cl_s(c, p), lambda c=c, p=p: sht.synthesis_contract_cl_s_plain(c, p), ex))
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
                dhconv_extras(x, wd),
            )
        )
        for label, t, nlat_phys in (("full", itrans_up, itrans_up.nlat), ("internal", itrans, itrans.nlat), ("internal-masked", itrans, itrans.nlat - 7)):
            xn = (3.0 * randn((1, t.nlat, t.nlon, C), torch.float32, gen, dev) + 1.5).to(dtype)
            wn = 1.0 + 0.1 * randn((C,), torch.float32, gen, dev)
            bn = 0.1 * randn((C,), torch.float32, gen, dev)

            def norm_extras(out, xn=xn, wn=wn, bn=bn):
                # the bound reads x once; a norm that reads x twice from device
                # memory cannot beat two_read_ms
                lib = time_ms(lambda: torch.nn.functional.instance_norm(xn.permute(0, 3, 1, 2), weight=wn.to(xn.dtype), bias=bn.to(xn.dtype), eps=1e-6), 5, 1)
                two_read = 1e3 * nbytes(xn, xn, wn, bn, out) / PEAK_HBM_BYTES
                return dict(bound(8.0 * xn.numel(), nbytes(xn, wn, bn, out)), library_ms=lib, two_read_ms=two_read)

            cases.append(
                (
                    "instance_norm",
                    label,
                    dtype,
                    lambda xn=xn, wn=wn, bn=bn, n=nlat_phys: instance_norm_cl(xn, wn, bn, n),
                    lambda xn=xn, wn=wn, bn=bn, n=nlat_phys: instance_norm_cl_plain(xn, wn, bn, n),
                    norm_extras if label in ("full", "internal") else None,
                )
            )
    res = run_cases(cases, card, {})
    return res


def build_sfno(dev, compute_dtype=None):
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


def time_steps(model, step, card, label):
    """Step latency of both paths, in turns (kernel, plain, kernel, plain),
    and peak memory; CUDA events around each step."""
    from makani_torch import kernels

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
        print(f"{label} step ({path} path): median {statistics.median(times[path]):.2f} ms over {len(times[path])} steps "
              f"{[round(t, 2) for t in times[path]]}, peak memory {peaks[path] / 2**30:.2f} GiB  [{card}]", flush=True)


def sfno_phases(dev, card):
    """Phases 2-6; returns (kernel results, launch counts of the rollout)."""
    from makani_torch import kernels
    from makani_torch.models.model_package import rollout
    from makani_torch.utils.zenith_angle import cos_zenith_angle_from_timestamp

    t0 = time.perf_counter()
    params, model, wrapper, x0 = build_sfno(dev)
    net = model.model
    nparam = sum(p.numel() for p in model.parameters())
    print(f"built {CONFIG[1]} ({nparam} parameters, compute {params.compute_dtype}, {params.img_shape_x}x{params.img_shape_y} -> "
          f"internal {net.h}x{net.w}, lmax/mmax {net.trans.lmax}/{net.trans.mmax}, {params.N_in_channels} in / {params.N_out_channels} out channels) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    kres = check_sfno_kernels(dev, card, (net.trans_down, net.itrans_up, net.trans, net.itrans), net.embed_dim)
    print(f"phase 2 (SFNO kernel checks) {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

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

    expected = {k: EXPECTED_PER_STEP.get(k, 0) * STEPS for k in kernels.LAUNCHES}
    print(f"SFNO launches over {STEPS} steps: {launches} (per step {({k: v / STEPS for k, v in launches.items()})})")
    if launches != expected:
        raise RuntimeError(f"launch counts {launches} != expected {expected}")

    lon2d, lat2d = np.meshgrid(lon, lat)
    zen = torch.from_numpy(cos_zenith_angle_from_timestamp(t_start, lon2d, lat2d).astype(np.float32)).to(dev)[None, None, None]
    err = compare_paths(model, wrapper, x0, zen, frames[0])
    ok = err["rel_l2"] <= MODEL_BF16_REL_L2
    print(f"SFNO step 1 ({params.compute_dtype}), kernel path vs plain path (normalized units): relL2 {err['rel_l2']:.3e} "
          f"(tol {MODEL_BF16_REL_L2}), max|d|/max|ref| {err['max_rel']:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"flagship kernel path disagrees with the plain path: {err}")
    del frames
    _, model32, wrapper32, _ = build_sfno(dev, compute_dtype="float32")
    err = compare_paths(model32, wrapper32, x0, zen)
    ok = err["max_rel"] <= MODEL_FP32_TOL
    print(f"SFNO step 1 (float32 compute, same weights), kernel path vs plain path: max|d|/max|ref| {err['max_rel']:.3e} "
          f"(tol {MODEL_FP32_TOL}), relL2 {err['rel_l2']:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"flagship fp32 kernel path disagrees with the plain path: {err}")
    del model32, wrapper32
    torch.cuda.empty_cache()
    small_model_check(dev)
    time_steps(model, lambda: wrapper(x0, zen), card, "SFNO forecast")
    return kres, launches


# ---------------------------------------------------------------------------
# FCN3


def build_fcn3(dev, compute_dtype=None, with_noise=True):
    """FCN3 through get_model on seeded weights, ModelWrapper with seeded
    per-channel stats, a seeded initial condition and the configured noise
    (its 721-degree synthesis table takes a while: made only when asked)."""
    from makani_torch.models.model_package import ModelWrapper
    from makani_torch.models.model_registry import get_model
    from makani_torch.models.noise import build_noise
    from makani_torch.utils.yparams import YParams

    params = YParams(os.path.join(REPO, FCN3_CONFIG[0]), FCN3_CONFIG[1])
    if compute_dtype is not None:
        params["compute_dtype"] = compute_dtype
    n_chan = len(params.channel_names)
    params["in_channels"] = list(range(n_chan))
    params["out_channels"] = list(range(n_chan))
    params["ensemble_size"] = FCN3_ENSEMBLE
    model, _ = get_model(params, multistep=True, device=dev, seed=SEED)
    gen = torch.Generator(dev).manual_seed(SEED + 4)
    bias = randn((1, n_chan, 1, 1), torch.float32, gen, dev)
    scale = 0.5 + torch.rand((1, n_chan, 1, 1), generator=gen, device=dev)
    H, W = params.img_shape_x, params.img_shape_y
    x0 = bias + scale * randn((1, n_chan, H, W), torch.float32, gen, dev)
    noise = build_noise(dict(params.input_noise, grid_type=params.model_grid_type), (H, W), num_time_steps=1) if with_noise else None
    return params, model, ModelWrapper(model, bias=bias, scale=scale), x0, noise


def band_case(op, x, F_, Gf, IG, OG, label, library=False, padded=False):
    """A K5 case on x with the op's tables; extras count the nonzero filter
    taps (the work this data needs) and time one grouped conv1d on the
    pre-gathered band (the library yardstick). ``padded``: the output's
    pixels lie a multiple of 4 floats apart, as the processor's responses
    (``DiscoConvS2.responses_cl``)."""
    from makani_torch.ops import disco_kernels
    from makani_torch.ops.disco import RESPONSE_ALIGN
    from makani_torch.ops.precision import fp32_exact

    dev = x.device
    B, Hin, Win, C = x.shape
    Hout, Wout = op.out_shape
    Cout = C // IG * OG
    bs = op.band_start_table(dev)
    taps = op.tap_table(0, dev)
    kw = dict(taps=taps, a=op.stride, off=int(op.bases[0]) - op.halo, n_out=Wout // op.phases, phase=0, phases=1, Gf=Gf, IG=IG, OG=OG)
    if op.phases != 1:
        raise RuntimeError(f"{label}: the flagship grids have one phase, this conv has {op.phases}")

    def run(fn):
        Cp = -(-Cout // RESPONSE_ALIGN) * RESPONSE_ALIGN if padded else Cout
        out = torch.empty(B, Hout, Wout, Cp, dtype=torch.float32, device=dev)[..., :Cout]
        return fn(x, F_, bs, out, **kw)

    def extras(out):
        nnz = torch.count_nonzero(F_[..., :OG]).item()  # summed over latitudes
        flops = 2.0 * nnz * B * (Wout // op.phases) * (C // (Gf * IG))
        runs = taps[..., 1] - taps[..., 0]
        dead = torch.nonzero((runs == 0).all(dim=1)).flatten()
        # the dead latitudes are written +0: no value, no sign bit
        if not bool((out[:, dead].view(torch.int32) == 0).all()):
            raise RuntimeError(f"{label}: K5 wrote something other than +0 at a latitude with no live tap")
        live = (f"live taps {runs.sum().item() / taps[..., 0].numel() / op.WW:.1%} of the {op.BL}x{op.WW} window, "
                f"dead latitudes {dead.numel()} of {Hout} (polar rows {len(op.polar_rows)}, equal: {dead.tolist() == list(op.polar_rows)}), +0 there")
        res = dict(bound(flops, nbytes(x, F_[..., :OG], bs, out), torch.float32), library_ms=None, nnz_fraction=nnz / F_[..., :OG].numel(), live=live)
        if library:
            # grouped conv1d over the gathered band rows, a group per output
            # latitude (and filter group): (B*R*g, Hout*IG*BL, span) in, the
            # filter (Hout*Gf*OG, IG*BL, WW) (Gf < g repeats the filters)
            BL, WW, a = op.BL, op.WW, op.stride
            rows = bs.long()[:, None] + torch.arange(BL, device=dev)
            span = (Wout - 1) * a + WW
            cols = (kw["off"] + torch.arange(span, device=dev)) % Win
            R = C // (Gf * IG)
            xb = x[:, rows.reshape(-1, 1), cols.view(1, -1)]  # (B, Hout*BL, span, C): small index tensors
            inp = xb.view(B, Hout, BL, span, R, Gf, IG).permute(0, 4, 1, 5, 6, 2, 3).reshape(B * R, Hout * Gf * IG * BL, span)
            del xb
            filt = F_[..., :OG].permute(0, 1, 5, 2, 3, 4).reshape(Hout * Gf * OG, IG * BL, WW).contiguous()
            with fp32_exact():  # cuDNN would take TF32 at torch's defaults
                res["library_ms"] = time_ms(lambda: torch.nn.functional.conv1d(inp, filt, stride=a, groups=Hout * Gf), 3, 1)
            del inp
        return res

    return ("disco_band", label, torch.float32, lambda: run(disco_kernels.band_contract), lambda: run(disco_kernels.band_contract_plain), extras)


def polar_case(src, Pt, mode, label):
    from makani_torch.ops import disco_kernels

    kern, plain = (disco_kernels.polar_psi_first, disco_kernels.polar_psi_first_plain) if mode == "psi_first" else (disco_kernels.polar_mix_first, disco_kernels.polar_mix_first_plain)

    def extras(out):
        K = Pt.shape[2]
        n_mac = src.numel() // 2 * (K if mode == "psi_first" else 1)
        # the library yardstick: one complex einsum
        Xc = torch.view_as_complex(src)
        Pc = torch.view_as_complex(Pt).conj()
        eq = "bpjcm,pjkm->bpckm" if mode == "psi_first" else "bpjckm,pjkm->bpcm"
        return dict(bound(8.0 * n_mac, nbytes(src, Pt, out)), library_ms=time_ms(lambda: torch.einsum(eq, Xc, Pc), 3, 1))

    return ("disco_polar", label, torch.float32, lambda: kern(src, Pt), lambda: plain(src, Pt), extras)


def mix_case(conv, B, card):
    """K8 at the processor: the responses of B pixels grids (R = B*H*W rows
    of C*K floats, laid out as ``responses_cl`` lays them out) mixed by the
    conv's weight. Its plain version is the library call (cuBLAS SGEMM, TF32
    off), timed again as the yardstick; the polar rows' mix (a cuBLAS bmm,
    no kernel of the port) is timed at its shape beside it."""
    from makani_torch.ops import disco_kernels
    from makani_torch.ops.disco import RESPONSE_ALIGN

    op = conv.conv_op
    dev = conv.weight.device
    H, W = op.out_shape
    C, K, N = conv.in_channels, op.K, conv.out_channels
    D = C * K
    gen = torch.Generator(dev).manual_seed(SEED + 6)
    t2 = randn((B * H * W, -(-D // RESPONSE_ALIGN) * RESPONSE_ALIGN), torch.float32, gen, dev)[:, :D]
    w = conv.weight.detach().float().reshape(N, D)
    planes = disco_kernels.MixPlanes()

    def extras(out):
        t_pol = randn((B, len(op.polar_rows), C, K, W), torch.float32, gen, dev)
        polar_ms = time_ms(lambda: conv._mix_polar(t_pol), 3, 1)
        del t_pol
        lib = time_ms(lambda: torch.matmul(t2, w.t()), 3, 1)
        return dict(bound(2.0 * t2.shape[0] * D * N, nbytes(t2, w, out), torch.float32), library_ms=lib,
                    library_note=f"polar rows' mix (cuBLAS bmm, {B}x{len(op.polar_rows)}x{W} columns) {polar_ms:.3f} ms")

    return ("disco_mix", "processor", torch.float32, lambda: disco_kernels.channel_mix(t2, w, planes), lambda: disco_kernels.channel_mix_plain(t2, w), extras)


def resample_case(rs, x, label):
    from makani_torch.ops.resample import resample_cl, resample_cl_plain

    tabs = rs.tables(x.device)
    li, lw, k0, k1, v = tabs

    def extras(out):
        res = dict(bound(6.0 * out.numel(), nbytes(x, out, *tabs)), library_ms=None)
        # grid_sample (bilinear, align_corners) on x with its first longitude
        # column appended, at (lat_idx + lat_w, longitude position) in index
        # units; it counts as the yardstick only if it computes the function
        B, Hin, Win, C = x.shape
        xin = torch.cat([x, x[:, :, :1]], dim=2).permute(0, 3, 1, 2).contiguous()
        rows = (li.double() + lw.double()) * 2.0 / (Hin - 1) - 1.0
        pos = torch.arange(rs.out_shape[1], device=x.device, dtype=torch.float64) * (Win / rs.out_shape[1])
        cols = pos * 2.0 / Win - 1.0
        grid = torch.stack(torch.broadcast_tensors(cols[None, :], rows[:, None]), dim=-1).float()[None].expand(B, -1, -1, -1).contiguous()

        def lib():
            return torch.nn.functional.grid_sample(xin, grid, mode="bilinear", padding_mode="border", align_corners=True)

        err = errors(lib().permute(0, 2, 3, 1), resample_cl_plain(x, li.long(), lw, k0.long(), k1.long(), v))
        if err["max_rel"] <= FP32_TOL:
            res["library_ms"] = time_ms(lib, 3, 1)
            res["library_note"] = f"library: grid_sample, max|d|/max|ref| {err['max_rel']:.3e}"
        else:
            res["library_note"] = (f"no library yardstick: grid_sample misses the fp32 gate (max|d|/max|ref| {err['max_rel']:.3e}): "
                                   "it rebuilds the lerp weights from normalized fp32 coordinates")
        del xin, grid
        return res

    return ("resample", label, torch.float32, lambda: resample_cl(x, *tabs), lambda: resample_cl_plain(x, li.long(), lw, k0.long(), k1.long(), v), extras)


def fused_conv_cases(conv, x, label, gen):
    """K5 and K6 of a weight-fused conv on x (B, Hin, Win, g*ig), in the
    polar order the conv takes (mix first where og*BL <= ig)."""
    from makani_torch.ops.disco import FusedFilterCache

    op, wt = conv.conv_op, conv.weight
    g, og, ig, K = wt.shape
    B, Win = x.shape[0], x.shape[2]
    cases = [band_case(op, x, FusedFilterCache().get(op, wt, 0), g, ig, og, label, library=True)]
    if og * op.BL <= ig:
        U = randn((B, len(op.polar_rows), op.BL, x.shape[-1] // ig * og, K, Win // 2 + 1, 2), torch.float32, gen, x.device)
        cases.append(polar_case(U, op.polar_table(0, x.device), "mix_first", label))
    else:
        X = torch.view_as_real(torch.fft.rfft(op.polar_bands(x), dim=-1))
        cases.append(polar_case(X, op.polar_table(0, x.device), "psi_first", label))
    return cases


def check_fcn3_kernels(dev, card, net, noise, B):
    """Phase 8: the FCN3 path's kernels at its shapes (B = the folded
    ensemble), against their plain versions."""
    from makani_torch.ops import sht
    from makani_torch.models.common.contractions import _PermutedWeight, contract_dense_s, contract_dense_s_plain

    gen = torch.Generator(dev).manual_seed(SEED + 5)
    H, W = net.inp_shape
    h, w = net.h, net.w
    C = net.block1.local_conv.in_channels
    results = {}

    # processor: responses mode and the psi-first polar rows (the main shapes)
    op = net.block1.local_conv.conv_op
    x = randn((B, h, w, C), torch.float32, gen, dev)
    run_cases([band_case(op, x, op.band_filter(0, dev), 1, 1, op.K, "processor", library=True, padded=True)], card, results, 3, 1)
    X = torch.view_as_real(torch.fft.rfft(op.polar_bands(x), dim=-1))
    run_cases([polar_case(X, op.polar_table(0, dev), "psi_first", "processor")], card, results, 3, 1)
    del x, X
    torch.cuda.empty_cache()
    run_cases([mix_case(net.block1.local_conv, B, card)], card, results, 3, 1)
    torch.cuda.empty_cache()

    # the decoders' resampling (K7), on the processor's output channels
    dec, sd = net.atmo_decoder, net.surf_decoder
    R, n_dec = net.n_atmo_groups, dec.conv.in_channels
    z = randn((B, h, w, net.block1.out_chans), torch.float32, gen, dev)
    run_cases([resample_case(dec.resample, z[..., : R * n_dec], "atmo-decoder"),
               resample_case(sd.resample, z[..., z.shape[-1] - net.surf_embed_dim :], "surf-decoder")], card, results, 3, 1)
    del z

    # the weight-fused convs: the encoders read an NCHW input view (the
    # atmo encoder's levels stacked on the channel axis), the decoders their
    # resampled input, channels-last
    for label, conv, n_in in (("atmo-encoder", net.atmo_encoder.conv, net.n_atmo_groups * net.n_atmo), ("surf-encoder", net.surf_encoder.conv, net.n_surf),
                              ("aux-encoder", net.aux_encoder.conv, net.n_aux), ("atmo-decoder", dec.conv, R * n_dec), ("surf-decoder", sd.conv, net.surf_embed_dim)):
        if label.endswith("decoder"):
            xo = randn((B, H, W, n_in), torch.float32, gen, dev)
        else:
            xo = randn((B, n_in, H, W), torch.float32, gen, dev).permute(0, 2, 3, 1)
        run_cases(fused_conv_cases(conv, xo, label, gen), card, results, 3, 1)
        del xo
        torch.cuda.empty_cache()

    # the global blocks' K1, K3, K2 at the internal grid, and the noise's K2
    blk = net.block0.global_conv
    fwd, inv = blk.forward_transform, blk.inverse_transform
    xf = randn((B, fwd.nlat, fwd.mmax, C, 2), torch.float32, gen, dev)
    wa = fwd.weights(dev)
    c2 = randn((B, inv.lmax, inv.mmax, C, 2), torch.float32, gen, dev)
    pa = inv.pct(dev)
    xs = randn((B, inv.lmax, inv.mmax, 1, C, 2), torch.float32, gen, dev)
    cache = _PermutedWeight()
    isht = noise.isht
    cn = randn((1, isht.lmax, isht.mmax, noise.num_channels, 2), torch.float32, gen, dev)
    pn = isht.pct(dev)
    cases = [
        ("sht_analysis", "fcn3-internal", torch.float32, lambda: sht.analysis_contract_cl_s(xf, wa), lambda: sht.analysis_contract_cl_s_plain(xf, wa), legendre_extras(xf, wa, 0, B)),
        ("sht_synthesis", "fcn3-internal", torch.float32, lambda: sht.synthesis_contract_cl_s(c2, pa), lambda: sht.synthesis_contract_cl_s_plain(c2, pa), legendre_extras(c2, pa, 1, B)),
        ("dhconv", "fcn3-internal", torch.float32, lambda: contract_dense_s(xs, blk.weight, False, "dhconv", True, weight_cache=cache), lambda: contract_dense_s_plain(xs, blk.weight, False, "dhconv", True), dhconv_extras(xs, blk.weight.detach())),
        ("sht_synthesis", "fcn3-noise", torch.float32, lambda: sht.synthesis_contract_cl_s(cn, pn), lambda: sht.synthesis_contract_cl_s_plain(cn, pn), legendre_extras(cn, pn, 1, 1)),
    ]
    run_cases(cases, card, results, 3, 1)
    del xf, c2, xs, cn, cases
    return results


def noise_fields(noise, members, dev, seed):
    """The first step's noise channels of a centered ensemble, drawn as
    ``rollout`` draws them: (members, 1, C, H, W)."""
    gen = torch.Generator(dev).manual_seed(seed)
    eta = noise.sample(noise.init_state(gen, members // 2))[:, 0]
    return torch.stack([eta, -eta], dim=1).reshape(members, *eta.shape[1:])[:, None]


def fcn3_phases(dev, card):
    """Phases 7-12; returns (kernel results, launch counts of the rollout)."""
    from makani_torch import kernels
    from makani_torch.models.model_package import rollout
    from makani_torch.utils.zenith_angle import cos_zenith_angle_from_timestamp

    t0 = time.perf_counter()
    params, model, wrapper, x0, noise = build_fcn3(dev)
    net = model.model
    nparam = sum(p.numel() for p in model.parameters())
    print(f"built FCN3 {FCN3_CONFIG[1]} of {FCN3_CONFIG[0]} ({nparam} parameters, compute {params.compute_dtype}, {params.img_shape_x}x{params.img_shape_y} -> "
          f"internal {net.h}x{net.w}, {net.num_layers} blocks, {params.N_in_channels} in / {params.N_out_channels} out channels, "
          f"ensemble {FCN3_ENSEMBLE} centered) in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, conv in (("atmo encoder", net.atmo_encoder.conv), ("processor", net.block1.local_conv), ("atmo decoder", net.atmo_decoder.conv)):
        op = conv.conv_op
        print(f"  DISCO {name}: {op.in_shape} -> {op.out_shape}, K {op.K}, BL {op.BL}, WW {op.WW}, stride a {op.stride}, phases b {op.phases}, "
              f"polar rows {len(op.polar_rows)}, weight {tuple(conv.weight.shape)}, {'fused' if conv.fused else 'two-stage'}")

    t0 = time.perf_counter()
    kres = check_fcn3_kernels(dev, card, net, noise, FCN3_ENSEMBLE)
    print(f"phase 8 (FCN3 kernel checks) {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    H, W = params.img_shape_x, params.img_shape_y
    lat = 90.0 - 180.0 * np.arange(H) / (H - 1)
    lon = 360.0 * np.arange(W) / W
    t_start = 1.5e9
    noise_seed = SEED + 99
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    frames = rollout(wrapper, x0, lat, lon, t_start, params.dhours, STEPS, noise=noise, ensemble_size=FCN3_ENSEMBLE, centered=True,
                     generator=torch.Generator(dev).manual_seed(noise_seed))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"FCN3 rollout: {STEPS} steps of {FCN3_ENSEMBLE} members in {time.perf_counter() - t0:.1f} s (first step includes table uploads)  [{card}]")
    for i, f in enumerate(frames):
        if f.shape != (FCN3_ENSEMBLE, *x0.shape[1:]) or not bool(torch.isfinite(f).all()):
            raise RuntimeError(f"FCN3 rollout step {i + 1}: shape {tuple(f.shape)} or non-finite values")
        spread = ((f[0] - f[1]) / wrapper.scale[0]).norm().item() / math.sqrt(f[0].numel())
        if not spread > 1e-6:
            raise RuntimeError(f"FCN3 rollout step {i + 1}: the two members do not differ (rms normalized difference {spread})")
        print(f"FCN3 rollout step {i + 1} (+{(i + 1) * params.dhours} h): shape {tuple(f.shape)}, finite, mean {f.mean().item():.4f}, "
              f"std {f.std().item():.4f}, member rms difference (normalized) {spread:.4f}")

    expected = {k: FCN3_EXPECTED_PER_STEP.get(k, 0) * STEPS for k in kernels.LAUNCHES}
    print(f"FCN3 launches over {STEPS} steps: {launches} (per step {({k: v / STEPS for k, v in launches.items()})})")
    if launches != expected:
        raise RuntimeError(f"FCN3 launch counts {launches} != expected {expected}")

    lon2d, lat2d = np.meshgrid(lon, lat)
    zen = torch.from_numpy(cos_zenith_angle_from_timestamp(t_start, lon2d, lat2d).astype(np.float32)).to(dev)[None, None, None]
    unp = torch.cat([zen.expand(FCN3_ENSEMBLE, 1, 1, H, W), noise_fields(noise, FCN3_ENSEMBLE, dev, noise_seed)], dim=2)
    xm = x0.repeat_interleave(FCN3_ENSEMBLE, dim=0)
    err = compare_paths(model, wrapper, xm, unp, frames[0])
    ok = err["rel_l2"] <= MODEL_BF16_REL_L2
    print(f"FCN3 step 1 ({params.compute_dtype}), kernel path vs plain path (normalized units): relL2 {err['rel_l2']:.3e} "
          f"(tol {MODEL_BF16_REL_L2}), max|d|/max|ref| {err['max_rel']:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"FCN3 kernel path disagrees with the plain path: {err}")
    del frames
    torch.cuda.empty_cache()
    _, model32, wrapper32, _, _ = build_fcn3(dev, compute_dtype="float32", with_noise=False)
    err = compare_paths(model32, wrapper32, xm, unp)
    ok = err["max_rel"] <= MODEL_FP32_TOL
    print(f"FCN3 step 1 (float32 compute, same weights), kernel path vs plain path: max|d|/max|ref| {err['max_rel']:.3e} "
          f"(tol {MODEL_FP32_TOL}), relL2 {err['rel_l2']:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"FCN3 fp32 kernel path disagrees with the plain path: {err}")
    del model32, wrapper32
    torch.cuda.empty_cache()
    time_steps(model, lambda: wrapper(xm, unp), card, f"FCN3 ensemble forecast (E={FCN3_ENSEMBLE})")
    return kres, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    # the port, from this checkout (an import error ends the run here)
    from makani_torch import kernels
    from makani_torch.ops.precision import transform_io_dtype

    # torch's TF32 flags stay at their defaults: the port's fp32 library
    # calls keep TF32 out themselves (makani_torch/ops/precision.py fp32_exact)
    dev = device()

    # ---- phase 1: card and build
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.library()
    print(f"built {os.path.relpath(so, REPO)} in {time.perf_counter() - t0:.1f} s (nvcc {' '.join(kernels.NVCC_FLAGS)})", flush=True)
    for line in ptxas_lines(so.with_suffix(".log").read_text()):
        print("  ptxas:", line)

    sfno_res, sfno_launches = sfno_phases(dev, card)
    torch.cuda.empty_cache()
    fcn3_res, fcn3_launches = fcn3_phases(dev, card)

    # ---- result: each kernel at its path's main shape, with that path's launches
    io = transform_io_dtype()
    f32 = torch.float32
    meta = [
        ("sht_analysis", "cuda", "makani_torch/csrc/sht_legendre.cu", "makani_tpu/ops/sht.py:54", sfno_res, ("full", io), sfno_launches),
        ("sht_synthesis", "cuda", "makani_torch/csrc/sht_legendre.cu", "makani_tpu/ops/sht.py:59", sfno_res, ("full", io), sfno_launches),
        ("dhconv", "cuda", "makani_torch/csrc/dhconv.cu", "makani_tpu/models/common/contractions.py:45", sfno_res, ("internal", io), sfno_launches),
        ("instance_norm", "cuda", "makani_torch/csrc/instance_norm.cu", "makani_tpu/models/common/layer_norm.py:78", sfno_res, ("full", torch.bfloat16), sfno_launches),
        ("disco_band", "cuda", "makani_torch/csrc/disco_band.cu", "scripts/r3/disco_pallas.py:27", fcn3_res, ("processor", f32), fcn3_launches),
        ("disco_polar", "cuda", "makani_torch/csrc/disco_polar.cu", "makani_tpu/ops/disco.py:686", fcn3_res, ("processor", f32), fcn3_launches),
        ("disco_mix", "cuda", "makani_torch/csrc/disco_mix.cu", "makani_tpu/models/networks/fourcastnet3.py:125", fcn3_res, ("processor", f32), fcn3_launches),
        ("resample", "cuda", "makani_torch/csrc/resample.cu", "makani_tpu/ops/resample.py:90", fcn3_res, ("atmo-decoder", f32), fcn3_launches),
    ]
    table = []
    for name, route, source, replaces, res, (label, dtype), launches in meta:
        r = res[(name, label, dtype)]
        table.append(
            {"name": name, "route": route, "source": source, "replaces": replaces, "launches": launches[name],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        )
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
