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

 The SFNO training step (slice 3):
13. build bench.py's training configuration (:97-123: 361x720, scale 3,
    internal 120x240, 73 channels + zenith, embed 384, 8 dhconv blocks,
    instance norm, bf16 compute, l2 / constant / squared loss, batch 3)
    through ``get_model`` on seeded weights;
14. compare each backward kernel with its plain version at its shapes: the
    Legendre gradients (K2's kernels on the analysis tables, K1's on the
    synthesis tables) at 361<->120 and 120<->120, the dhconv's dx (K3 on
    the conjugate-transposed weight) and dw (K9, fp32 and bf16, also with
    its blocks in other orders), the instance-norm
    backward (K10, bf16 at both grids, fp32 once), and the factored Adam
    (K11) on the model's parameters with its gradients; time each beside
    its bound, its plain version and the library's call where one exists;
15. take one training step through the kernels and through the plain path
    (autograd through the plain forward, the plain optimizer) from the same
    weights, batch and optimizer state, in fp32 compute (loss, every
    gradient leaf, every parameter after the step) and in bf16 compute
    (loss and every gradient leaf);
16. take 1 + 5 training steps (``train_step``, the bench's factored Adam)
    on the repeated batch through the kernels: check every kernel's
    launches per step, and that the loss is finite and falls; print ms per
    step, samples/s, peak memory and the loss per step; then 1 + 3 steps on
    the plain path, whose losses the kernel path's must match step by step
    (relative 3e-2).

 The FCN3 ensemble-CRPS training step (slice 4), the recipe's own:
17. build the recipe's base config in bench.py's FCN3 ensemble mode
    (``fcn3_train_config``: 361x720, internal 180x360, 73 channels + zenith
    + 8 centered diffusion-noise channels, embeds 45/56/36, 10 blocks of
    which 0 and 5 spectral, bf16 compute with fp32 DISCO, E = 4 members of
    B = 1 sample, checkpointing_level 3; the skillspread CRPS with auto
    channel weights and temp_diff_normalization over seeded statistics
    files, ``stats_files``; Adam at lr 5e-4 clipped at 1.0 on the cosine
    schedule) through ``get_model``, and fold a seeded batch with its noise
    (``prepare_ensemble_batch``);
18. compare each new backward kernel with its plain version at its shapes:
    K12 (K5's transpose) at the processor, reading the padded responses,
    and in fused mode at the atmo decoder and at the stride-2 atmo encoder;
    K13 (K6's transposes) psi first at the processor and mix first at the
    atmo decoder; K14 (K7's transpose) at both decoders; K15 (the CRPS,
    forward and backward) on the step's forecasts; the dhconv's dx and dw
    (K3 on the conjugate-transposed weight, K9) at the global blocks'
    internal grid; K16 (the global norm and the clip) and K17 (Adam) on the
    model's parameters with one step's gradients; time each beside its
    bound, its plain version and the library's call where one exists; and
    time K8's backward, two cuBLAS GEMMs;
19. take one bf16 training step's forward, loss and gradients through the
    kernels and through the plain path (autograd through the plain forward
    and the plain CRPS) from the same weights and batch, then the
    optimizer's step through K16 and K17 and through the plain optimizer
    from the same gradients (parameters within 1e-3 lr max(1, |u|));
20. take 1 + 5 training steps (``ensemble_train_step``, the recipe's
    optimizer, whose ``step`` runs under ``set_sync_debug_mode("error")``:
    it does not wait for the card) on the repeated batch through the
    kernels: check every kernel's launches per step, each step's learning
    rate against the schedule, and that the loss is finite and falls below
    its first value; then 1 + 5 steps on the plain path, whose losses the
    kernel path's must match step by step (relative 3e-2); print ms per
    step, samples (members) per second, peak memory, the learning rate
    and the global norm per step of both.

 The SFNO recipe's training step (slice 5):
21. build ``sfno_linear_73chq_sc3_layers8_edim384`` as config/sfnonet.yaml
    gives it (721x1440, scale 3, internal 240x480, lmax 240, embed 384, 8
    dhconv blocks, instance norm, bf16 compute; the l2 squared loss with
    auto channel weights and temp_diff_normalization over seeded statistics
    files; Adam with b2 0.95 clipped at 32 on the cosine schedule at lr
    1e-3, 2 steps an epoch), cut to B = 1 (the recipe's 64 on 64 GPUs, one
    card's share), through ``get_model`` on seeded weights;
22. compare the backward kernels with their plain versions at its shapes
    (K1/K2 on each other's tables at 721 <-> 240 and 240 <-> 240, K3's dx,
    K9, K10 at (1, 721, 1440, 384) and (1, 240, 480, 384)) and K16 and K17
    on the model's parameters with one step's gradients, each timed beside
    its bound, plain version and library call;
23. one recipe step through the kernels and the plain path, as 15 holds
    the bench's: in fp32 compute the loss, every gradient leaf and the
    parameters after the optimizer's step (K16 and K17 against the plain
    optimizer from the same gradients), in bf16 compute (the recipe's) the
    loss and every gradient leaf (a leaf that misses the bf16 gates held to
    the fp32 gradient: the kernel path no farther from it than 1.25 times
    the plain path);
24. 1 + 5 recipe steps (``train_step``) through the kernels, checked as 20
    (launches, learning rates, a falling loss, no wait for the card in the
    optimizer's step), then 1 + 3 on the plain path, step by step.

 The drivers, after the SFNO recipe's phases: ``python -m makani_torch.train``
 and ``python -m makani_torch.inference`` (their ``main(argv)``) on the
 recipe ``sfno_linear_73chq_sc3_layers8_edim384`` at its widths, B = 1:
25. write seeded HDF5 files under a temporary directory in ``build/``
    (removed at exit): a training and a validation year of 5 states of 73 x
    721 x 1440 fp32 (4 training samples, one validation rollout), the
    statistics with the time means, ``data.json``, and a YAML whose config
    inherits the recipe's and overrides only the paths, ``valid_autoreg_steps``
    (3) and ``max_epochs``;
26. train one epoch through ``train.py`` (4 steps, the validation rollout,
    checkpoint ``ckpt_v1``): every kernel's launches (the recipe step's 4
    times, the forecast step's 4 times), the epoch's logs
    (``step_time_ms``, ``train_samples_per_sec``, ``effective_io_rate_gbs``),
    the host's ms a batch (read, normalize, zenith, staging, the copy)
    against the device's ms a step and its idle share, the checkpoint's GB
    and GB/s, and peak memory;
27. the trainer's first step against chip_smoke's own ``train_step`` on the
    same sample and seeded weights, bit for bit, and the plain path's loss
    (MODEL_BF16_REL_L2);
28. ``train.py`` again with ``max_epochs`` 2, resuming from ``ckpt_v1``,
    against the first trainer carried on for epoch 2 in memory, its step and
    rollout loops under ``torch.cuda.set_sync_debug_mode`` (no sync
    allowed): each step's loss within 1e-6 relative, every parameter within
    1e-6 of its leaf's max, the learning rate equal (bit-equality printed);
29. ``inference.py`` from the run's best checkpoint on the validation file,
    with ``--save_raw_forecasts``: the restored weights equal the trained
    ones; the launches are the forecast step's and K1's two a lead step
    counted inside ``SpectrumAverageBuffer.update``; the step-0 RMSE is
    ``ModelWrapper``'s on the same initial condition (1e-6 relative); the
    four files have the JAX package's datasets and shapes; a second, warm
    scoring with its lead-step loop under the sync check (no sync allowed,
    and the raw-forecast buffer's event waits, which the check cannot see,
    counted: one a batch of initial conditions) gives the same logs; one
    lead step's parts
    timed apart; and K1 at the spectrum's shape (721 -> lmax 721, mmax 721,
    C = 73, fp32) against its plain version (``sht_analysis@spectrum``).

 The ensemble driver, after the drivers' phases: ``python -m
 makani_torch.ensemble`` and ``python -m makani_torch.inference`` (their
 ``main(argv)``) on the FCN3 recipe under ``fcn3_train_config``'s cuts, with
 the native reader (``MAKANI_NATIVE_READER=1``):
30. write seeded HDF5 files under a temporary directory in ``build/``
    (removed at exit): a training and a validation year of 4 states of 73 x
    361 x 720 fp32 (3 training samples, one validation rollout), the
    statistics with the time means, ``data.json``, a mask file of 2
    six-hourly masks and a climatology file of 4 states, and a YAML whose
    entry inherits the recipe's base config and overrides only the paths,
    the cuts (E = 4 of B = 1, ``n_future`` 0, ``checkpointing_level`` 3),
    ``valid_autoreg_steps`` (2) and ``max_epochs`` (the entry checked equal
    to ``fcn3_train_config`` beyond them);
31. train one epoch through ``ensemble.py --ensemble_size 4`` (3 steps, the
    validation rollout of 3 lead steps, checkpoint ``ckpt_v1``): every
    training step's launches equal phase 20's step's (counted inside
    ``ensemble_train_step``), the epoch's launches those steps', the noise
    draws' K2 and the rollout's forecasts and K15; ``step_time_ms``,
    members/s, the host's ms a batch by part against the device's ms a
    step, the noise draws' device ms and the idle share; CRPS, spread and
    SSR at every lead step; then the trainer's first step against
    chip_smoke's own ``ensemble_train_step`` on the same sample, noise
    (a generator seeded with ``seed + 1``) and seeded weights, bit for bit;
32. ``ensemble.py`` again with ``max_epochs`` 2, resuming from ``ckpt_v1``,
    against the first trainer carried on for epoch 2 in memory with its
    generator reseeded to ``seed + 1`` (the noise stream is not
    checkpointed, as in the JAX package): each step's loss, every
    parameter, the learning rate and the validation loss bit-equal, and no
    sync in its step and rollout loops (``set_sync_debug_mode``);
33. ``inference.py`` on the run's best checkpoint at E = 4 with the mask and
    the climatology files and ``--save_raw_forecasts``: the restored
    weights equal the trained ones; the launches are the forecasts', the
    noise series' K2 and K1's two a lead step in the spectrum buffer; CRPS,
    spread and SSR at every lead step; the four files with their datasets
    and shapes, all finite; one E-member lead step's parts timed apart;
    and every sample of both year files, in training and evaluation
    windows, read by the native reader bit-equal to the memory map's.

 FCN3.1 (slice 6), each path entered through ``get_model(multistep=True)``:
34. build ``fcn31_sc2_edim256_layers10`` (config/fourcastnet3.yaml: 721x1440,
    73 channels + zenith + 8 diffusion-noise channels, scale 2 onto a
    360x720 Legendre-Gauss grid, lmax 90 and the DISCO cutoff 3 pi / 90 from
    it, the harmonic basis under nodal normalization, embed 256, aux embed
    16, latitude embedding 8, 10 blocks of which 0 and 5 global, sin
    activations, bf16 compute with fp32 DISCO) on seeded weights, one
    centered pair (E=2); print every DISCO conv's band (BL rows of WW
    longitudes) and K5's route for it;
35. compare its kernels with their plain versions at its shapes: K5 in
    responses mode at the unified encoder (BL 48), the processor (BL 25)
    and the decoder (BL 49), in fused mode at the aux encoder, K6 at the
    same convs, K8 at the two-stage convs (D = 511, 1960, 1792), K7 at the
    decoder, K1-K3 at the internal grid; the full-resolution plain versions
    of K5 run once each (``run_cases(plain_once=True)``);
36. roll the ensemble out for 4 steps (``ModelWrapper`` + ``rollout``) and
    check the frames and the launch counts, computed from the model's convs;
37. run step 1 once through the plain path and compare (bf16), and time the
    kernel path (1 + 3 steps: ms a step, members/s, peak memory);
38-41. the same for ``fcn31_sc2_edim256_layers10_history`` (the
    fourier-bessel basis, BL 72-73 at the encoder and decoder, a window of
    2 states sliding over the rollout, the unified encoder a grouped
    two-stage conv: groups 2 of 73 -> 128, each group's responses K5, K6
    and K8 apart), its depth cut to ``FCN31_HISTORY_LAYERS`` (2: the global
    block 0 and one local block) for the time limit;
42. build the FCN3.1 recipe's training step (``fcn31_train_config``: the
    recipe at 361x720, internal 180x360, lmax 45, E = 4 of B = 1,
    checkpointing_level 3, the base config's skillspread CRPS with auto
    weights and temp_diff_normalization, clipped Adam on the cosine
    schedule);
43. compare K12 (the wide-band kernel at K 7: 3xTF32 m16n8k8 products; a
    second call held bit for bit to the first) and K13 at the processor and
    the decoder, K5 at both, K8 and its backward GEMMs, K14 at the decoder,
    K15, K9, K3's dx and K1-K3 at the global blocks, K16 and K17 with their
    plain versions;
44. one bf16 step through the kernels and the plain path: the forecast,
    loss and every gradient leaf, then the optimizer step from the same
    gradients;
45. 1 + 5 steps through the kernels: launches (computed from the model),
    the schedule's learning rates, a falling loss, ms a step, members/s and
    peak memory (the plain path is compared in 44, not timed).

 The token models (slice 9), at full width, B = 1, bf16 compute (the
 recipes'), each entered through ``get_model(multistep=True)``:
46. build ``afno_73ch`` (config/afnonet.yaml: FourCastNet v1, 721x1440
    cropped to 720 rows, patch 8, a 90 x 180 token grid, embed 768 in 8
    blocks of 96, 12 blocks, 73 channels + zenith) on seeded weights;
47. compare K18 (the AFNO mixer) with its plain version at block 0's
    mixer on the spectrum of a seeded token grid (90 x 91 modes, read in
    place from the rFFT's storage), and K19 on K18's o1 and output with a
    seeded dy, leaf by leaf, and a second K19 launch bit for bit; time both
    beside their bounds and ``bmm`` yardsticks;
48. roll the forecast out for 4 steps (``ModelWrapper`` + ``rollout``):
    frames finite, the padded row the model's zeros, K18 12 a step; step 1
    through the plain path (bf16; fp32 compute on the same weights), and
    both paths timed;
49. one training step's loss and gradients against the plain path (bf16,
    and fp32 compute), then ``train_step`` with the recipe's Adam: K18 12,
    K19 12, K17's launches, and a second step from the same weights,
    optimizer state and batch bit-equal; ms a step and peak memory;
50. ``python -m makani_torch.train`` on ``afno_73ch`` (its own YAML entry
    over seeded 0.25 degree year files of 3 states, with the min/max stats
    of its minmax channels; 2 steps, a validation rollout of 2 lead steps,
    a checkpoint), then ``python -m makani_torch.inference`` scoring that
    checkpoint at E = 1 (the trained weights, the forecast's launches, a
    warm second scoring equal to the first);
51. phases 46, 48 and 49 for ``afnov2_73ch`` (K4/K10 two a block besides
    K18/K19);
52. the same for ``vit_73ch`` (4050 tokens, 12 heads; no hand-written
    kernel: its frames, loss and launches of none, and its times).

Prints the card line and the kernel table as one JSON line before the last
line (each kernel at its path's main shape, K1 at the inference spectrum's
as ``sht_analysis@spectrum``, then FCN3.1's as ``kernel@shape`` with the
launches of that FCN3.1 path, then K18 with the AFNO rollout's launches and
K19 with the training step's), and as the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = ("config/sfnonet.yaml", "sfno_linear_73chq_sc3_layers8_edim384")
FCN3_CONFIG = ("config/fourcastnet3.yaml", "base_config")
FCN31_CONFIG = ("config/fourcastnet3.yaml", "fcn31_sc2_edim256_layers10")
FCN31_HISTORY_CONFIG = ("config/fourcastnet3.yaml", "fcn31_sc2_edim256_layers10_history")
# the history path runs at a cut depth: its global block 0 and one local
# block (every conv kind of the config; the plain path's processor blocks
# were most of its plain runs' time)
FCN31_HISTORY_LAYERS = 2
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

# The SFNO training step of bench.py (:97-123, :246-254): 361x720, scale 3
# (internal 120x240, lmax 120, mmax 121), 73 channels + zenith, embed 384, 8
# dhconv blocks, instance norm, bf16 compute, the l2 / constant / squared
# loss, batch 3, Adam with a factored nu and a bf16 mu at lr 1e-3
TRAIN_CONFIG = dict(
    nettype="SFNO",
    img_shape_x=361,
    img_shape_y=720,
    scale_factor=3,
    embed_dim=384,
    num_layers=8,
    operator_type="dhconv",
    normalization_layer="instance_norm",
    channel_names=[f"ch{i}" for i in range(73)],
    in_channels=list(range(73)),
    out_channels=list(range(73)),
    n_history=0,
    n_future=0,
    add_zenith=True,
    losses=[{"type": "l2", "channel_weights": "constant", "parameters": {"squared": True}}],
    lr=1e-3,
    optimizer_type="Adam",
    optimizer_nu_factored=True,
    optimizer_mu_dtype="bfloat16",
    scheduler="none",
)
TRAIN_BATCH = 3
TRAIN_STEPS = 5  # timed after one warm-up; the loss must fall over them
TRAIN_PLAIN_STEPS = 3
# per training step: the forward's launches and their backward's (K11's,
# three for every 40 factored leaves and one for every 64 unfactored ones, from the model)
TRAIN_EXPECTED_PER_STEP = dict(
    EXPECTED_PER_STEP, sht_analysis_grad=8, sht_synthesis_grad=10, dhconv_grad_input=8, dhconv_grad_weight=8, instance_norm_grad=16
)
# Training step, kernel path vs plain path on the card, same weights, batch
# and optimizer state:
#  fp32 compute: loss within 1e-5 relative; each gradient leaf within
#        MODEL_FP32_TOL of its max|ref|; each parameter after the step within
#        1e-3 * lr * max(1, |u|) where |g| > 1e-3 (1e-4 on a factored leaf)
#        of its max, u the plain path's update in units of lr, with mu in
#        fp32 (the CPU whole-step test's gates and exclusions, but relative to
#        |u| where it exceeds 1: at full width the factored estimate makes
#        steps of |u| up to ~54 on the dhconv weights, whose error is ~4e-5
#        of the step, measured).
#  bf16 compute: loss within MODEL_BF16_REL_L2 relative, each gradient leaf
#        within relative L2 1e-1 (the forward's bf16 paths already differ by
#        ~1.6%).
#  Both: the MLP's second bias, whose gradient is zero in exact arithmetic
#        (the instance norm after it removes any per-channel constant), is
#        held to rounding level instead.
TRAIN_LOSS_FP32_TOL = 1e-5
TRAIN_GRAD_BF16_REL_L2 = 1e-1
# The AFNO training step in fp32 compute, kernel path vs plain path: each
# gradient leaf within relative L2 1e-2, not MODEL_FP32_TOL of its max|ref|:
# the mixer's relu and soft-shrink are kinked, and where the two paths'
# forwards differ by rounding, values on either side of a kink move their
# mode's whole gradient (max|d|/max|ref| up to 1.03e-2 at a bias, relative
# L2 1.577e-3 at afno_73ch, on the card). K18's kept o1 and K19 are held to
# FP32_TOL on the same inputs (``check_mixer_kernels``).
TRAIN_GRAD_AFNO_FP32_REL_L2 = 1e-2
# The FCN3 ensemble-CRPS training step: the published recipe's base config
# (config/fourcastnet3.yaml: morlet th 3x3, embeds 45/56/36, 10 blocks of
# which 0 and 5 spectral, clamp_water, 8 centered diffusion-noise channels,
# bf16 compute with fp32 DISCO; the skillspread CRPS with auto channel
# weights and temp_diff_normalization; Adam at lr 5e-4 clipped at a global
# norm of 1.0 on the cosine schedule) in bench.py's FCN3 ensemble mode
# (BENCH_NETTYPE=FCN3 BENCH_ENSEMBLE=4 BENCH_CHECKPOINTING=3; :64-72,
# :126-146, :190-213, :218-228): cut to 0.5 degrees and E = 4 members (two
# centered pairs) of B = 1 sample, rematerializing the encoders, decoders
# and blocks (checkpointing_level 3); the statistics files are the caller's
# (chip_smoke.py writes seeded ones, ``stats_files``)
FCN3_TRAIN_ENSEMBLE = 4
FCN3_TRAIN_BATCH = 1
# the recipe names no samples an epoch: the schedule counts one step an epoch
FCN3_STEPS_PER_EPOCH = 1
# FCN3 training step, kernel path vs plain path on the card, same weights
# and batch, bf16 compute: the forecast within MODEL_BF16_REL_L2 relative
# L2, the loss within MODEL_BF16_REL_L2 relative, each gradient leaf within
# relative L2 TRAIN_GRAD_BF16_REL_L2 (the member ranks that the two paths'
# forecasts order differently are counted and covered by these gates), and
# each of 1 + 5 steps' loss within MODEL_BF16_REL_L2 of the plain path's
# per training step: the forward's launches twice (checkpointing_level 3
# recomputes every encoder, block and decoder in the backward), and the
# backward's: K12 for the inputs of the 8 local blocks and the 2 decoders
# (the encoders' input needs none), K13 at the same 10 convs, K14 at the 2
# decoders, the global blocks' K1/K2/K3 transposes, K15 forward and
# backward; K5's launches for the fused convs' weight gradients
# (``fcn3_wgrad_launches``) and K16's and K17's (``optimizer_launches``)
# are added from the model and the optimizer
FCN3_TRAIN_EXPECTED_PER_STEP = dict(
    {k: 2 * v for k, v in FCN3_EXPECTED_PER_STEP.items()},
    sht_synthesis=4, sht_analysis_grad=2, sht_synthesis_grad=2, dhconv_grad_input=2, dhconv_grad_weight=2,
    disco_band_grad=10, disco_polar_grad=10, resample_grad=2, crps=2,
)


# the statistics files a config names (the recipes' losses read them)
STATS_KEYS = ("min_path", "max_path", "time_means_path", "global_means_path", "global_stds_path", "time_diff_means_path", "time_diff_stds_path")


def stats_files(n_channels: int) -> dict:
    """Seeded per-channel statistics (1, C, 1, 1) for the recipes' losses,
    written under build/chip_smoke_stats (the repository holds no ERA5):
    mins and maxs, global means and stds, and time-difference stds at 5-30%
    of the stds (a six-hour change is a fraction of the climate's spread).
    Returns every key of ``STATS_KEYS``, None where no file is written."""
    r = np.random.default_rng(SEED + 20)
    mins = r.uniform(-2.0, -0.5, (1, n_channels, 1, 1))
    stds = r.uniform(0.5, 2.0, (1, n_channels, 1, 1))
    arrays = {"min_path": mins, "max_path": mins + r.uniform(0.5, 3.0, mins.shape), "global_means_path": r.standard_normal(mins.shape),
              "global_stds_path": stds, "time_diff_stds_path": stds * r.uniform(0.05, 0.3, mins.shape)}
    out = os.path.join(REPO, "build", "chip_smoke_stats")
    os.makedirs(out, exist_ok=True)
    paths = dict.fromkeys(STATS_KEYS)
    for key, value in arrays.items():
        paths[key] = os.path.join(out, f"{key[:-5]}_{n_channels}.npy")
        np.save(paths[key], value)
    return paths


def fcn3_train_config(**overrides) -> dict:
    """The FCN3 training configuration as a plain dict (shared with
    tests/test_torch_fcn3_train.py, which shrinks it): the recipe's base
    config with the cuts above, then ``overrides``; the in and out channels
    follow ``channel_names`` unless given."""
    from makani_torch.utils.yparams import YParams

    # the YAML's "5E-4" is read as a number, as the recipe means it
    cfg = YParams(os.path.join(REPO, FCN3_CONFIG[0]), FCN3_CONFIG[1]).to_dict()
    cfg.update(
        img_shape_x=361,
        img_shape_y=720,
        ensemble_size=FCN3_TRAIN_ENSEMBLE,
        batch_size=FCN3_TRAIN_BATCH,
        n_future=0,
        checkpointing_level=3,
        **{key: None for key in STATS_KEYS},
    )
    cfg.update(overrides)
    n = len(cfg["channel_names"])
    cfg.setdefault("in_channels", list(range(n)))
    cfg.setdefault("out_channels", list(range(n)))
    return cfg


def fcn31_train_config(**overrides) -> dict:
    """The FCN3.1 training configuration as a plain dict (shared with
    tests/test_torch_fcn31.py, which shrinks it): the recipe
    ``fcn31_sc2_edim256_layers10`` (the base config's loss, optimizer and
    schedule; its own network keys) with the FCN3 training step's cuts
    (``fcn3_train_config``: 361x720, E = 4 members of B = 1 sample,
    checkpointing_level 3), then ``overrides``."""
    from makani_torch.utils.yparams import YParams

    recipe = YParams(os.path.join(REPO, FCN31_CONFIG[0]), FCN31_CONFIG[1]).to_dict()
    own = ("nettype", "embed_dim", "aux_embed_dim", "pos_embed_dim", "filter_basis_type", "filter_basis_norm_mode", "activation_function", "encoder_bias",
           "hard_thresholding_fraction", "lmax")
    return fcn3_train_config(**{**{k: recipe[k] for k in own if k in recipe}, **overrides})


def crps_order_weight(pred_a: torch.Tensor, pred_b: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
    """Weights (B, C, H, W), 0 where two computations of one ensemble
    forecast, pred_a and pred_b (B, E, C, H, W), may order two members, or a
    member and the observation, differently, and 1 elsewhere. The CRPS
    gradient jumps where two members swap ranks or a member crosses the
    observation, so two paths whose forecasts differ by rounding are held
    to each other only where every gap between those values, in either
    forecast, exceeds four times the forecasts' largest difference at the
    pixel, or is an exact tie in both (the clamped water channels' zeros)."""
    a = torch.cat([pred_a, tar[:, None].to(pred_a.dtype)], dim=1)
    b = torch.cat([pred_b, tar[:, None].to(pred_b.dtype)], dim=1)
    margin = 4.0 * (pred_a - pred_b).abs().amax(dim=1)
    unsure = torch.zeros_like(margin, dtype=torch.bool)
    for i in range(a.shape[1]):
        for j in range(i + 1, a.shape[1]):
            da, db = a[:, i] - a[:, j], b[:, i] - b[:, j]
            unsure |= ((da.abs() <= margin) | (db.abs() <= margin)) & ~((da == 0) & (db == 0))
    return (~unsure).to(torch.float32)


# the ptxas report's lines, one a kernel (filled when the library is built)
PTXAS: list = []

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
    # one temporary the size of the output (FCN3.1's decoder responses are
    # 14.9 GB, beside the kernel's and the plain version's own)
    d = out.float() - ref.float()
    rel_l2 = (d.norm() / ref.float().norm()).item()
    max_abs = d.abs_().max().item()
    del d
    lo, hi = ref.aminmax()
    scale = max(-lo.item(), hi.item())
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


def run_cases(cases, card, results, iters=10, warmup=2, plain_once=False):
    """Each case: (name, label, dtype, kernel fn, plain fn, extras fn or
    None). The kernel runs once and is held to its plain version on the same
    inputs; both are timed (``plain_once``: the plain version by the
    comparison's own call alone, one cold sample, for plain versions that
    take seconds); extras(out) adds the bound and the library yardstick."""
    for name, label, dtype, kern, plain, extras in cases:
        out = kern()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        ref = plain()
        e.record()
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
        ms = time_ms(kern, iters, warmup)
        plain_ms = s.elapsed_time(e) if plain_once else time_ms(plain, iters, warmup)
        ok = within(err, dtype)
        dt = str(dtype).replace("torch.", "")
        more = "".join(f", {k} {extra[k]:.3f} ms" for k in ("bound_ms", "fma_bound_ms", "tc_bound_ms", "two_read_ms", "library_ms") if extra.get(k) is not None)
        more += "".join(f"; {extra[k]}" for k in ("route", "live", "plan", "library_note") if extra.get(k))
        if name == "disco_band":
            more += "; bit-equal to the plain version" if err["max_abs_err"] == 0.0 else "; NOT bit-equal to the plain version"
        print(
            f"kernel {name:13s} {label:17s} {dt:8s} out {shape}: max|d| {err['max_abs_err']:.3e} "
            f"max|d|/max|ref| {err['max_rel']:.3e} relL2 {err['rel_l2']:.3e} {'ok' if ok else 'FAIL'}; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{' (one cold call)' if plain_once else ''}{more}  [{card}]",
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


def time_steps(model, step, card, label, plain_steps=3):
    """Step latency of both paths, in turns (kernel, plain, kernel, plain),
    and peak memory; CUDA events around each step: a warm-up and 3 timed
    steps a turn of the kernel path, ``plain_steps`` of the plain path."""
    from makani_torch import kernels

    times = {"kernel": [], "plain": []}
    peaks = {}
    for path in ("kernel", "plain", "kernel", "plain"):
        kernels.set_use_kernels(model, path == "kernel")
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3 if path == "kernel" else plain_steps):
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
    (``DiscoConvS2.responses_cl``). The route the kernel takes (its shared
    memory layout, ``disco_kernels.band_route``) is reported."""
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
        route, smem = disco_kernels.band_route(C // IG, Gf, IG, OG, op.BL, op.WW, op.stride, Wout // op.phases)
        live += f"; route {route} ({smem / 1024:.1f} KB of shared memory a block)"
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


def mix_case(conv, B, card, label="processor"):
    """K8 at a two-stage conv: the responses of B pixels grids (R = B*H*W
    rows of ig*K floats, laid out as ``responses_cl`` lays them out) mixed
    by the weight of the conv's first group (every group of a grouped conv
    is one such launch). Its plain version is the library call (cuBLAS
    SGEMM, TF32 off), timed again as the yardstick; the polar rows' mix (a
    cuBLAS bmm, no kernel of the port) is timed at its shape beside it."""
    from makani_torch.ops import disco_kernels
    from makani_torch.ops.disco import RESPONSE_ALIGN

    op = conv.conv_op
    dev = conv.weight.device
    H, W = op.out_shape
    C, K, N = conv.in_channels // conv.groups, op.K, conv.out_channels // conv.groups
    D = C * K
    gen = torch.Generator(dev).manual_seed(SEED + 6)
    t2 = randn((B * H * W, -(-D // RESPONSE_ALIGN) * RESPONSE_ALIGN), torch.float32, gen, dev)[:, :D]
    w = conv.weight[0].detach().float().reshape(N, D)
    planes = disco_kernels.MixPlanes()

    def extras(out):
        t_pol = randn((B, len(op.polar_rows), C, K, W), torch.float32, gen, dev)
        polar_ms = time_ms(lambda: conv._mix_polar(t_pol), 3, 1)
        del t_pol
        lib = time_ms(lambda: torch.matmul(t2, w.t()), 3, 1)
        return dict(bound(2.0 * t2.shape[0] * D * N, nbytes(t2, w, out), torch.float32), library_ms=lib,
                    library_note=f"polar rows' mix (cuBLAS bmm, {B}x{len(op.polar_rows)}x{W} columns) {polar_ms:.3f} ms")

    return ("disco_mix", label, torch.float32, lambda: disco_kernels.channel_mix(t2, w, planes), lambda: disco_kernels.channel_mix_plain(t2, w), extras)


def resample_matrix(rs, batch: int, dev, transpose: bool = False) -> torch.Tensor:
    """The resampling as one sparse CSR matrix over ``batch`` samples, block
    diagonal: (batch Hout Wout) x (batch Hin Win), four entries a row
    (lat weight x lon weight, zeros dropped), or its transpose; the
    library yardstick of K7 and K14 (``torch.sparse.mm`` on a (pixels, C)
    view)."""
    li, lw, k0, k1, v = rs.tables(dev)
    (Hin, Win), (Hout, Wout) = rs.in_shape, rs.out_shape
    rows = li.long()[:, None] + torch.arange(2, device=dev)  # (Hout, 2)
    cols = torch.stack([k0.long(), k1.long()], dim=1)  # (Wout, 2)
    w = torch.stack([1 - lw, lw], dim=1)[:, None, :, None] * torch.stack([1 - v, v], dim=1)[None, :, None, :]
    src = (rows[:, None, :, None] * Win + cols[None, :, None, :]).expand(Hout, Wout, 2, 2)
    dst = torch.arange(Hout * Wout, device=dev).view(Hout, Wout, 1, 1).expand(Hout, Wout, 2, 2)
    keep = w != 0
    src, dst, w = src[keep], dst[keep], w[keep]
    b = torch.arange(batch, device=dev)[:, None]
    src, dst = (src + b * (Hin * Win)).reshape(-1), (dst + b * (Hout * Wout)).reshape(-1)
    idx = torch.stack([src, dst]) if transpose else torch.stack([dst, src])
    size = (batch * Hin * Win, batch * Hout * Wout) if transpose else (batch * Hout * Wout, batch * Hin * Win)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # CSR support is beta
        return torch.sparse_coo_tensor(idx, w.repeat(batch), size, check_invariants=False).coalesce().to_sparse_csr()


def sparse_yardstick(rs, src, ref_fn, transpose: bool, iters: int, warmup: int) -> dict:
    """``torch.sparse.mm`` of ``resample_matrix`` on src (B, H, W, C) as a
    (pixels, C) operand made beforehand: its time if it agrees with the
    plain version within the fp32 gate, and a note with its error."""
    B, C = src.shape[0], src.shape[-1]
    (Hin, Win), (Hout, Wout) = rs.in_shape, rs.out_shape
    mat = resample_matrix(rs, B, src.device, transpose)
    dense = src.reshape(-1, C).contiguous()
    shape = (B, Hin, Win, C) if transpose else (B, Hout, Wout, C)

    def lib():
        return torch.sparse.mm(mat, dense)

    err = errors(lib().view(shape), ref_fn())
    res = {"library_note": f"library: torch.sparse.mm (CSR, {mat.values().numel()} nonzeros), max|d|/max|ref| {err['max_rel']:.3e}"}
    if err["max_rel"] <= FP32_TOL:
        res["library_ms"] = time_ms(lib, iters, warmup)
    else:
        res["library_note"] = "no library yardstick: " + res["library_note"] + " misses the fp32 gate"
    del mat, dense
    return res


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

        plain = lambda: resample_cl_plain(x, li.long(), lw, k0.long(), k1.long(), v)
        err = errors(lib().permute(0, 2, 3, 1), plain())
        if err["max_rel"] <= FP32_TOL:
            res["library_ms"] = time_ms(lib, 3, 1)
            res["library_note"] = f"library: grid_sample, max|d|/max|ref| {err['max_rel']:.3e}"
            del xin, grid
        else:
            del xin, grid
            # grid_sample rebuilds the lerp weights from normalized fp32 coordinates
            res.update(sparse_yardstick(rs, x, plain, False, 3, 1))
            res["library_note"] += f" (grid_sample misses the fp32 gate: {err['max_rel']:.3e})"
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
    # the plain path's step takes seconds: one timed step a turn
    time_steps(model, lambda: wrapper(xm, unp), card, f"FCN3 ensemble forecast (E={FCN3_ENSEMBLE})", plain_steps=1)
    return kres, launches


# ---------------------------------------------------------------------------
# The SFNO training step (slice 3)


def kernel_regs(*patterns) -> str:
    """The ptxas report's lines of the CUDA functions whose names hold any
    of ``patterns``: registers, shared memory and spills."""
    hits = [line for line in PTXAS if any(p in line.split(": Used", 1)[0] for p in patterns)]
    return "registers: " + " | ".join(hits) if hits else ""


def train_params(compute_dtype="bfloat16"):
    from makani_torch.utils.yparams import ParamsBase

    return ParamsBase(dict(TRAIN_CONFIG, compute_dtype=compute_dtype))


def build_train(dev, compute_dtype="bfloat16"):
    from makani_torch.models.model_registry import get_model
    from makani_torch.utils.loss import LossHandler

    params = train_params(compute_dtype)
    model, _ = get_model(params, multistep=True, device=dev, seed=SEED)
    return params, model, LossHandler(train_params(compute_dtype))


def train_batch(dev):
    """The bench's batch: seeded input, target and zenith channel."""
    gen = torch.Generator(dev).manual_seed(SEED + 7)
    H, W, C = TRAIN_CONFIG["img_shape_x"], TRAIN_CONFIG["img_shape_y"], len(TRAIN_CONFIG["channel_names"])
    inp = randn((TRAIN_BATCH, C, H, W), torch.float32, gen, dev)
    tar = randn((TRAIN_BATCH, C, H, W), torch.float32, gen, dev)
    zen = randn((TRAIN_BATCH, 1, 1, H, W), torch.float32, gen, dev)
    return inp, tar, zen


def adam_launches(model) -> int:
    """K11's launches a step: three for every 40 factored leaves, one for
    every 64 unfactored ones."""
    from makani_torch.utils.training.optimizer import _MAX_FACTORED, _MAX_LEAVES, _factored_dims

    shapes = [tuple(p.shape) for p in model.parameters()]
    n_f = sum(_factored_dims(s, 128) is not None for s in shapes)
    return 3 * -(-n_f // _MAX_FACTORED) + -(-(len(shapes) - n_f) // _MAX_LEAVES)


def zero_in_exact_arithmetic(name: str) -> bool:
    """The MLP's second bias feeds the instance norm, which removes any
    per-channel constant: its gradient is zero but for rounding."""
    return name.endswith("mlp.fc2.bias")


def loss_and_grads(model, loss_obj, inp, tar, zen):
    loss = loss_obj(model(inp, zen, train=True), tar, inp=inp, train=True)
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def k9_library(x: torch.Tensor, g: torch.Tensor):
    """The one library call that computes K9's product, on operands laid out
    for it outside the timing: for fp32 a complex ``torch.bmm`` of conj(x)^T
    and g per (l, g); for bf16 (no complex bf16 GEMM) the real bf16
    ``torch.bmm`` of x^T (re, im interleaved along the depth) with gy's
    [[gr, gi], [gi, -gr]] blocks, the product K9 computes."""
    B, L, M, G, Ci, _ = x.shape
    Co = g.shape[4]
    if x.dtype == torch.float32:
        xl = torch.view_as_complex(x.permute(1, 3, 0, 2, 4, 5).reshape(L * G, B * M, Ci, 2).contiguous()).conj().transpose(1, 2).contiguous()
        gl = torch.view_as_complex(g.permute(1, 3, 0, 2, 4, 5).reshape(L * G, B * M, Co, 2).contiguous())
    else:
        xl = x.permute(1, 3, 4, 0, 2, 5).reshape(L * G, Ci, 2 * B * M).contiguous()
        gr, gi = g[..., 0], g[..., 1]
        blocks = torch.stack([torch.stack([gr, gi], -1), torch.stack([gi, -gr], -1)], -3)  # (B, L, M, G, 2, Co, 2)
        gl = blocks.permute(1, 3, 0, 2, 4, 5, 6).reshape(L * G, 2 * B * M, 2 * Co).contiguous()
    return lambda: torch.bmm(xl, gl)


def allocated_beyond(fn) -> tuple[int, int]:
    """What one call of ``fn`` leaves allocated (its output, as the caching
    allocator rounds it: large blocks in 2 MiB steps) and what it allocated
    beyond that at its peak (``torch.cuda.max_memory_allocated``): the
    temporaries."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    extra = torch.cuda.max_memory_allocated() - base - held
    del out
    return held, extra


def dhconv_grad_cases(B, L, M, w, gen, label, bf16=True):
    """K3's input-gradient mode (dx, fp32) from a forward's weight cache, as
    the training step runs it, and K9 (dw, fp32, and bf16 if ``bf16``) on
    seeded x and g (B, L, M, 1, C, 2) with the layer's weight w; K9's extras
    time the library's bmm. dx must hold nothing but its output (the
    allocator's rounding aside) and allocate at most 1 MB more while it
    runs: no weight is built in the backward."""
    from makani_torch.models.common.contractions import (
        _PermutedWeight,
        contract_dense_s,
        dhconv_grad_input,
        dhconv_grad_input_plain,
        dhconv_grad_weight,
        dhconv_grad_weight_plain,
    )

    dev = w.device
    f32 = torch.float32
    C = w.shape[1]
    x = randn((B, L, M, 1, C, 2), f32, gen, dev)
    g = randn((B, L, M, 1, C, 2), f32, gen, dev)
    # the forward fills the layer's weight cache; the backward reads it
    cache = _PermutedWeight()
    with torch.no_grad():
        contract_dense_s(x, w, False, "dhconv", True, weight_cache=cache)
    w_perm = cache.get(w, f32)
    wct = torch.stack([w[..., 0], -w[..., 1]], dim=-1).transpose(1, 2).contiguous()
    ex_dx = dhconv_extras(g, wct)
    del wct

    def dx_extras(out):
        held, extra = allocated_beyond(lambda: dhconv_grad_input(g, w_perm))
        if held > nbytes(out) + 2**21 or extra > 2**20:
            raise RuntimeError(f"dhconv_grad_input {label}: holds {held} bytes for a {nbytes(out)}-byte output and allocates {extra} more (at most 1 MB)")
        return dict(ex_dx(out), library_note=f"holds {held} B for its {nbytes(out)}-byte output, {extra} B more at its peak; "
                                             f"{kernel_regs('dhconv_kernel<float, true>')}")

    def dw_extras(x, g):
        def extras(out):
            torch.cuda.empty_cache()
            lib = time_ms(k9_library(x, g), 5, 1)
            torch.cuda.empty_cache()
            return dict(bound(8.0 * B * L * M * C * C, nbytes(x, g, out), x.dtype), library_ms=lib,
                        library_note=kernel_regs("dhconv_grad_weight_tc_kernel<" + ("float" if x.dtype == f32 else "__nv_bfloat16")))
        return extras

    cases = [
        ("dhconv_grad_input", label, f32, lambda: dhconv_grad_input(g, w_perm), lambda: dhconv_grad_input_plain(g, w), dx_extras),
        ("dhconv_grad_weight", label, f32, lambda: dhconv_grad_weight(x, g), lambda: dhconv_grad_weight_plain(x, g), dw_extras(x, g)),
    ]
    if bf16:
        xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
        cases.append(("dhconv_grad_weight", label, torch.bfloat16, lambda: dhconv_grad_weight(xb, gb),
                      lambda: dhconv_grad_weight_plain(xb, gb).float(), dw_extras(xb, gb)))
    return cases


def check_train_kernels(dev, card, model, loss_obj, batch, B=TRAIN_BATCH, adam=True):
    """The backward kernels and (``adam``) K11 against their plain versions
    at the training step's shapes, batch B; returns {(name, label, dtype):
    result}."""
    from makani_torch.models.common import layer_norm
    from makani_torch.ops import sht

    net = model.model
    trans_down, itrans_up, trans, itrans = net.trans_down, net.itrans_up, net.trans, net.itrans
    C = net.embed_dim
    gen = torch.Generator(dev).manual_seed(SEED + 8)
    f32 = torch.float32
    cases = []
    # K2's kernels on the analysis tables, K1's on the synthesis tables
    for label, t in (("full", trans_down), ("internal", trans)):
        g = randn((B, t.lmax, t.mmax, C, 2), f32, gen, dev)
        w = t.weights(dev, f32)
        ex = legendre_extras(g, w, 1, B)
        cases.append(("sht_analysis_grad", label, f32, lambda g=g, w=w: sht._legendre_launch("sht_analysis_grad", sht._SYNTHESIS, g, w),
                      lambda g=g, w=w: sht.synthesis_contract_cl_s_plain(g, w), lambda out, ex=ex: dict(ex(out), library_note=kernel_regs("legendre_synthesis_tc_kernel"))))
    for label, t in (("full", itrans_up), ("internal", itrans)):
        g = randn((B, t.nlat, t.mmax, C, 2), f32, gen, dev)
        p = t.pct(dev, f32)
        ex = legendre_extras(g, p, 0, B)
        cases.append(("sht_synthesis_grad", label, f32, lambda g=g, p=p: sht._legendre_launch("sht_synthesis_grad", sht._ANALYSIS, g, p),
                      lambda g=g, p=p: sht.analysis_contract_cl_s_plain(g, p), lambda out, ex=ex: dict(ex(out), library_note=kernel_regs("legendre_analysis_tc_kernel"))))
    res = run_cases(cases, card, {}, 5, 1)
    del cases
    torch.cuda.empty_cache()

    # dhconv: dx (K3 on the conjugate-transposed weight) and dw (K9), and K9
    # in bf16
    L, M = itrans.lmax, itrans.mmax
    w = net.block1.filter_layer.filter.weight.detach()
    run_cases(dhconv_grad_cases(B, L, M, w, gen, "internal"), card, res, 5, 1)
    torch.cuda.empty_cache()

    # K10: bf16 at both grids (the model's), fp32 once
    for label, t, dtype in (("full", itrans_up, torch.bfloat16), ("internal", itrans, torch.bfloat16), ("internal", itrans, f32)):
        xn = (3.0 * randn((B, t.nlat, t.nlon, C), f32, gen, dev) + 1.5).to(dtype)
        gn = randn((B, t.nlat, t.nlon, C), dtype, gen, dev)
        wn = (1.0 + 0.1 * randn((C,), f32, gen, dev)).to(dtype)
        mean, sd = layer_norm._norm_stats_plain(xn, None, 1e-6)
        plan = layer_norm._grad_plan(xn, gn)
        n = t.nlat * t.nlon

        def kern(xn=xn, gn=gn, wn=wn, mean=mean, sd=sd, plan=plan, n=n):
            return layer_norm.launch_instance_norm_grad(gn, xn, wn, mean, sd, n, plan)[0]

        def plain(xn=xn, gn=gn, wn=wn, mean=mean, sd=sd, n=n):
            return layer_norm.instance_norm_grad_plain(gn, xn, wn, mean, sd, n)[0]

        fn_name = "instance_norm_grad_kernel<" + ("__nv_bfloat16, 8>" if dtype == torch.bfloat16 else "float, 4>")

        def extras(out, xn=xn, gn=gn, wn=wn, mean=mean, sd=sd, plan=plan, n=n, dtype=dtype, fn_name=fn_name):
            _, dw, db = layer_norm.launch_instance_norm_grad(gn, xn, wn, mean, sd, n, plan)
            _, rw, rb = layer_norm.instance_norm_grad_plain(gn, xn, wn, mean, sd, n)
            for nm, a, b_ in (("dw", dw, rw), ("db", db, rb)):
                e = errors(a, b_)
                if not within(e, dtype):
                    raise RuntimeError(f"instance_norm_grad {nm} disagrees with its plain version: {e}")
            # the library: the autograd backward of F.instance_norm (NCHW view)
            xl_ = xn.permute(0, 3, 1, 2).detach().requires_grad_()
            wl, bl = wn.detach().clone().requires_grad_(), torch.zeros_like(wn).requires_grad_()
            yl = torch.nn.functional.instance_norm(xl_, weight=wl, bias=bl, eps=1e-6)
            gl_ = gn.permute(0, 3, 1, 2)
            lib = time_ms(lambda: torch.autograd.grad(yl, (xl_, wl, bl), gl_, retain_graph=True), 5, 1)
            del yl
            two_read = 1e3 * nbytes(xn, gn, xn, gn, out) / PEAK_HBM_BYTES
            return dict(bound(14.0 * xn.numel(), nbytes(xn, gn, wn, out)), library_ms=lib, two_read_ms=two_read,
                        library_note=f"dw, db ok; library: the autograd backward of F.instance_norm; {kernel_regs(fn_name)}")

        run_cases([("instance_norm_grad", label, dtype, kern, plain, extras)], card, res, 5, 1)
        del xn, gn
        torch.cuda.empty_cache()

    if not adam:
        return res
    # K11 on the model's parameters with the model's gradients
    model.zero_grad(set_to_none=True)
    loss_obj(model(*batch[0::2], train=True), batch[1], inp=batch[0], train=True).backward()
    grads = [p.grad.detach().clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    res[("adam_factored", "model", torch.float32)] = adam_case(card, model, grads, TRAIN_CONFIG["lr"], "model")
    del grads
    torch.cuda.empty_cache()
    return res


def adam_case(card, model, grads, lr, label) -> dict:
    """K11 on the model's parameters with the given gradients, one step from
    a fresh state with a bf16 mu, against the plain version on copies; both
    timed over the whole step (``AdamFactored.step``)."""
    from makani_torch.utils.training.optimizer import AdamFactored

    params = list(model.parameters())

    def fresh(use_kernels):
        ps = [torch.nn.Parameter(p.detach().clone()) for p in params]
        for p, g in zip(ps, grads):
            p.grad = g
        opt = AdamFactored(ps, lr=lr, mu_dtype=torch.bfloat16)
        opt.use_kernels = use_kernels
        return ps, opt

    out = []
    for use in (True, False):
        ps, opt = fresh(use)
        opt.step()
        torch.cuda.synchronize()
        out.append(torch.cat([p.detach().flatten() for p in ps]))
        del ps, opt
    err = errors(out[0], out[1])
    n_params = out[0].numel()
    del out
    torch.cuda.empty_cache()
    times = {}
    for use in (True, False):
        ps, opt = fresh(use)
        times[use] = time_ms(opt.step, 5, 1)
        del ps, opt
        torch.cuda.empty_cache()
    # bytes: g, p and the bf16 mu read, p and mu written; the unfactored
    # leaves' v read and written; the factored state is ~0.1% of that
    n_unf = sum(p.numel() for p in params if p.dim() < 2 or sorted(p.shape)[-2] < 128)
    moved = n_params * (4 + 4 + 2 + 4 + 2) + n_unf * 8
    ok = within(err, torch.float32)
    extra = dict(bound(6.0 * n_params, moved), library_ms=None)
    print(f"kernel adam_factored     {label:17s} float32  {n_params} parameters ({adam_launches(model)} launches): max|d| {err['max_abs_err']:.3e} "
          f"max|d|/max|ref| {err['max_rel']:.3e} relL2 {err['rel_l2']:.3e} {'ok' if ok else 'FAIL'}; kernel {times[True]:.3f} ms, plain {times[False]:.3f} ms, "
          f"bound_ms {extra['bound_ms']:.3f} ms ({extra['bound_by']}); no library call computes the factored update (torch's Adam keeps the full nu); "
          f"{kernel_regs('factored_', 'unfactored_')}  [{card}]", flush=True)
    if not ok:
        raise RuntimeError(f"adam_factored ({label}) disagrees with its plain version: {err}")
    return dict(err, ms=times[True], plain_ms=times[False], **extra)


def compare_train_steps(dev, card, batch):
    """One training step at full width through the kernels and through the
    plain path (PyTorch autograd through the plain forward, the plain
    optimizer), from the same weights, batch and optimizer state: fp32
    compute with the gates of the CPU whole-step test, bf16 compute with
    the bf16 gates."""
    import copy

    from makani_torch import kernels
    from makani_torch.utils.training.optimizer import AdamFactored, _factored_dims

    inp, tar, zen = batch
    # fp32 compute, fp32 mu
    _, model, loss_obj = build_train(dev, "float32")
    plain = copy.deepcopy(model)
    kernels.set_use_kernels(plain, False)
    results = []
    for m, use in ((model, True), (plain, False)):
        opt = AdamFactored(m.parameters(), lr=TRAIN_CONFIG["lr"])
        opt.use_kernels = use
        before = {n: p.detach().clone() for n, p in m.named_parameters()} if use else None
        loss, grads = loss_and_grads(m, loss_obj, inp, tar, zen)
        opt.step()
        results.append((loss, grads, {n: p.detach() for n, p in m.named_parameters()}, before))
        m.zero_grad(set_to_none=True)
        del opt
        torch.cuda.empty_cache()
    (lk, gk, pk, p0), (lp, gp, pp, _) = results
    largest = max(g.abs().max().item() for g in gp.values())
    worst = (0.0, "")
    for name in gp:
        a, b = gk[name], gp[name]
        if zero_in_exact_arithmetic(name):
            if max(a.abs().max().item(), b.abs().max().item()) > 1e-5 * largest:
                raise RuntimeError(f"fp32 step: {name}'s gradient is not at rounding level")
            continue
        rel = ((a - b).abs().max() / b.abs().max()).item()
        worst = max(worst, (rel, name))
        if rel > MODEL_FP32_TOL:
            raise RuntimeError(f"fp32 step: gradient {name} kernel vs plain max|d|/max|ref| {rel:.3e} > {MODEL_FP32_TOL}")
    lr = TRAIN_CONFIG["lr"]
    worst_p = (0.0, "")
    for name in pp:
        if zero_in_exact_arithmetic(name):
            continue
        if torch.equal(pp[name], p0[name]):
            raise RuntimeError(f"fp32 step: parameter {name} did not move")
        g = gp[name].abs()
        mask = g > (1e-4 if _factored_dims(tuple(g.shape), 128) else 1e-3) * g.max()
        # the update's error in units of lr, over max(1, |u|): u the plain
        # path's update in units of lr
        u = ((pp[name] - p0[name]) / lr).abs()
        r = ((pk[name] - pp[name]).abs() / lr / torch.clamp_min(u, 1.0))[mask].max().item()
        worst_p = max(worst_p, (r, name))
        if r > 1e-3:
            raise RuntimeError(f"fp32 step: parameter {name} after the step differs by {r:.3e} lr max(1, |u|) > 1e-3")
    ok = abs(lk - lp) <= TRAIN_LOSS_FP32_TOL * abs(lp)
    print(f"SFNO training step (float32 compute, full width, B={TRAIN_BATCH}), kernel path vs plain path: loss {lk:.7f} vs {lp:.7f} "
          f"(rel {abs(lk - lp) / abs(lp):.2e}, tol {TRAIN_LOSS_FP32_TOL}); worst gradient leaf {worst[1]} max|d|/max|ref| {worst[0]:.3e} "
          f"(tol {MODEL_FP32_TOL}); worst parameter after the step {worst_p[1]} {worst_p[0]:.3e} lr max(1, |u|) (tol 1e-3) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError("fp32 training step: the kernel path's loss disagrees with the plain path's")
    del model, plain, results, gk, gp, pk, pp, p0
    torch.cuda.empty_cache()

    # bf16 compute (the bench's), gradients only
    _, model, loss_obj = build_train(dev, "bfloat16")
    plain = copy.deepcopy(model)
    kernels.set_use_kernels(plain, False)
    lk, gk = loss_and_grads(model, loss_obj, inp, tar, zen)
    del model
    torch.cuda.empty_cache()
    lp, gp = loss_and_grads(plain, loss_obj, inp, tar, zen)
    del plain
    largest = max(g.abs().max().item() for g in gp.values())
    worst = (0.0, "")
    for name in gp:
        a, b = gk[name].float(), gp[name].float()
        if zero_in_exact_arithmetic(name):
            if max(a.abs().max().item(), b.abs().max().item()) > 1e-2 * largest:
                raise RuntimeError(f"bf16 step: {name}'s gradient is not at rounding level")
            continue
        rel = ((a - b).norm() / b.norm()).item()
        worst = max(worst, (rel, name))
    ok = abs(lk - lp) <= MODEL_BF16_REL_L2 * abs(lp) and worst[0] <= TRAIN_GRAD_BF16_REL_L2
    print(f"SFNO training step (bfloat16 compute, full width, B={TRAIN_BATCH}), kernel path vs plain path: loss {lk:.6f} vs {lp:.6f} "
          f"(rel {abs(lk - lp) / abs(lp):.2e}, tol {MODEL_BF16_REL_L2}); worst gradient leaf {worst[1]} relL2 {worst[0]:.3e} "
          f"(tol {TRAIN_GRAD_BF16_REL_L2}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError("bf16 training step: the kernel path disagrees with the plain path")
    del gk, gp
    torch.cuda.empty_cache()


def time_train(dev, card, batch, use_kernels, steps):
    """``steps`` + 1 training steps (the first a warm-up) through the bench
    config's model and optimizer on the repeated batch; returns (the losses,
    the step times in ms, the peak memory, the launch counts of all steps)."""
    from makani_torch import kernels
    from makani_torch.utils.training.deterministic_trainer import train_step
    from makani_torch.utils.training.optimizer import get_optimizer

    params, model, loss_obj = build_train(dev, "bfloat16")
    kernels.set_use_kernels(model, use_kernels)
    opt = get_optimizer(params, model)
    opt.use_kernels = use_kernels
    inp, tar, zen = batch
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for _ in range(steps + 1):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        loss = train_step(model, loss_obj, opt, inp, tar, zen)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
        losses.append(loss.item())
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_adam = adam_launches(model)
    del model, opt
    torch.cuda.empty_cache()
    return losses, times, peak, launches, n_adam


def train_phases(dev, card):
    """Phases 13-16; returns (kernel results, launch counts of the timed
    training steps)."""
    t0 = time.perf_counter()
    params, model, loss_obj = build_train(dev)
    net = model.model
    nparam = sum(p.numel() for p in model.parameters())
    print(f"built the bench's SFNO ({nparam} parameters, compute {params.compute_dtype}, {params.img_shape_x}x{params.img_shape_y} -> internal "
          f"{net.h}x{net.w}, lmax/mmax {net.trans.lmax}/{net.trans.mmax}, embed {net.embed_dim}, {net.num_layers} blocks, batch {TRAIN_BATCH}, "
          f"K11 launches a step {adam_launches(model)}) in {time.perf_counter() - t0:.1f} s", flush=True)
    batch = train_batch(dev)
    t0 = time.perf_counter()
    kres = check_train_kernels(dev, card, model, loss_obj, batch)
    print(f"phase 14 (training kernel checks) {time.perf_counter() - t0:.1f} s", flush=True)
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    compare_train_steps(dev, card, batch)
    print(f"phase 15 (training step, kernel vs plain) {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 16: the main path, timed; then the plain path
    losses, times, peak, launches, n_adam = time_train(dev, card, batch, True, TRAIN_STEPS)
    n = TRAIN_STEPS + 1
    expected = {k: TRAIN_EXPECTED_PER_STEP.get(k, 0) * n for k in launches}
    expected["adam_factored"] = n_adam * n
    print(f"SFNO training launches over {n} steps: {launches} (per step {({k: v / n for k, v in launches.items()})})")
    if launches != expected:
        raise RuntimeError(f"training launch counts {launches} != expected {expected}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"training loss not finite or not falling over {TRAIN_STEPS} steps: {losses}")
    med = statistics.median(times[1:])
    print(f"SFNO training step (kernel path, bf16, B={TRAIN_BATCH}): median {med:.2f} ms over {TRAIN_STEPS} steps after a warm-up "
          f"{[round(t, 2) for t in times]}, {TRAIN_BATCH / med * 1e3:.3f} samples/s, peak memory {peak / 2**30:.2f} GiB; "
          f"loss per step {[round(v, 6) for v in losses]}  [{card}]", flush=True)
    p_losses, p_times, p_peak, _, _ = time_train(dev, card, batch, False, TRAIN_PLAIN_STEPS)
    # step by step, the plain path's losses: each step's forward reads the
    # weights the previous step's optimizer wrote
    if not all(abs(a - b) <= MODEL_BF16_REL_L2 * abs(b) for a, b in zip(losses, p_losses)):
        raise RuntimeError(f"training losses of the kernel path {losses} and the plain path {p_losses} part")
    p_med = statistics.median(p_times[1:])
    print(f"SFNO training step (plain path, bf16, B={TRAIN_BATCH}): median {p_med:.2f} ms over {TRAIN_PLAIN_STEPS} steps after a warm-up "
          f"{[round(t, 2) for t in p_times]}, {TRAIN_BATCH / p_med * 1e3:.3f} samples/s, peak memory {p_peak / 2**30:.2f} GiB; "
          f"loss per step {[round(v, 6) for v in p_losses]}  [{card}]", flush=True)
    return kres, launches


# ---------------------------------------------------------------------------
# The FCN3 ensemble-CRPS training step (slice 4)


def build_fcn3_train(dev, compute_dtype="bfloat16"):
    from makani_torch.models.model_registry import get_model
    from makani_torch.utils.loss import LossHandler
    from makani_torch.utils.yparams import ParamsBase

    cfg = fcn3_train_config(compute_dtype=compute_dtype)
    cfg.update(stats_files(len(cfg["channel_names"])))
    params = ParamsBase(dict(cfg))
    model, _ = get_model(params, multistep=True, device=dev, seed=SEED)
    return params, model, LossHandler(ParamsBase(dict(cfg)))


def fcn3_train_batch(dev, params):
    """A seeded input, target and zenith channel, folded into the ensemble
    with the centered diffusion noise drawn before the step
    (``prepare_ensemble_batch``): (inp (B*E, C, H, W), tar (B, C, H, W),
    unp (B*E, 1, 1 + 8, H, W))."""
    from makani_torch.models.noise import build_noise
    from makani_torch.utils.training.ensemble_trainer import prepare_ensemble_batch

    gen = torch.Generator(dev).manual_seed(SEED + 9)
    H, W, C = params.img_shape_x, params.img_shape_y, len(params.channel_names)
    inp = randn((FCN3_TRAIN_BATCH, C, H, W), torch.float32, gen, dev)
    tar = randn((FCN3_TRAIN_BATCH, C, H, W), torch.float32, gen, dev)
    zen = randn((FCN3_TRAIN_BATCH, 1, 1, H, W), torch.float32, gen, dev)
    noise = build_noise(dict(params.input_noise, grid_type=params.model_grid_type), (H, W), num_time_steps=1)
    return prepare_ensemble_batch(noise, inp, tar, zen, FCN3_TRAIN_ENSEMBLE, 1, torch.Generator(dev).manual_seed(SEED + 10), centered=True)


def band_grad_case(op, dout, F_, C, Gf, IG, OG, label, library=False):
    """K12 of phase 0 on dout against its plain version; extras count the
    live filter taps, as K5's, and time the grouped conv_transpose1d on the
    band (the library yardstick, without the scatter back to the rows)."""
    from makani_torch.ops import disco_kernels
    from makani_torch.ops.precision import fp32_exact

    dev = dout.device
    B, Hout, Wout, _ = dout.shape
    if op.phases != 1:
        raise RuntimeError(f"{label}: the path's grids have one phase, this conv has {op.phases}")
    bs = op.band_start_table(dev)
    kw = dict(a=op.stride, off=int(op.bases[0]) - op.halo, n_out=Wout, phase=0, phases=1, Gf=Gf, IG=IG, OG=OG, accumulate=False)

    def run(kern):
        dx = torch.empty(B, *op.in_shape, C, dtype=torch.float32, device=dev)
        if kern:
            return disco_kernels.band_contract_grad(dout, F_, bs, dx, taps=op.tap_table(0, dev), rows=op.grad_rows(0, dev), **kw)
        return disco_kernels.band_contract_grad_plain(dout, F_, bs, dx, **kw)

    def extras(out):
        nnz = torch.count_nonzero(F_[..., :OG]).item()
        flops = 2.0 * nnz * B * Wout * (C // (Gf * IG))
        res = dict(bound(flops, B * Hout * Wout * (C // IG * OG) * 4 + nbytes(F_[..., :OG], bs, out), torch.float32), library_ms=None)
        if library:
            BL, WW = op.BL, op.WW
            R = C // (Gf * IG)
            y = dout.reshape(B, Hout, Wout, R, Gf, OG).permute(0, 3, 1, 4, 5, 2).reshape(B * R, Hout * Gf * OG, Wout)
            filt = F_[..., :OG].permute(0, 1, 5, 2, 3, 4).reshape(Hout * Gf * OG, IG * BL, WW).contiguous()
            with fp32_exact():
                res["library_ms"] = time_ms(lambda: torch.nn.functional.conv_transpose1d(y, filt, stride=op.stride, groups=Hout * Gf), 3, 1)
            del y
            res["library_note"] = f"library: grouped conv_transpose1d on the band; {kernel_regs('disco_band_grad')}"
        return res

    return ("disco_band_grad", label, torch.float32, lambda: run(True), lambda: run(False), extras)


def polar_grad_case(dY, Pt, mode, label):
    from makani_torch.ops import disco_kernels

    if mode == "psi_first":
        kern, plain, eq = disco_kernels.polar_psi_first_grad, disco_kernels.polar_psi_first_grad_plain, "bpckm,pjkm->bpjcm"
    else:
        kern, plain, eq = disco_kernels.polar_mix_first_grad, disco_kernels.polar_mix_first_grad_plain, "bpcm,pjkm->bpjckm"

    def extras(out):
        n_mac = out.numel() // 2 * (Pt.shape[2] if mode == "psi_first" else 1)
        Yc, Pc = torch.view_as_complex(dY), torch.view_as_complex(Pt)
        return dict(bound(8.0 * n_mac, nbytes(dY, Pt, out)), library_ms=time_ms(lambda: torch.einsum(eq, Yc, Pc), 3, 1),
                    library_note=f"library: one complex einsum; {kernel_regs(mode + '_grad_kernel')}")

    return ("disco_polar_grad", label, torch.float32, lambda: kern(dY, Pt), lambda: plain(dY, Pt), extras)


def resample_grad_case(rs, dy, label):
    from makani_torch.ops.resample import resample_cl_grad, resample_cl_grad_plain

    dev = dy.device
    li, lw, k0, k1, v = rs.tables(dev)
    B, Hout, Wout, C = dy.shape
    plan = rs.grad_plan(dev, C, B)

    def extras(out):
        plain = lambda: resample_cl_grad_plain(dy, rs.in_shape, li.long(), lw, k0.long(), k1.long(), v)
        res = dict(bound(6.0 * dy.numel(), nbytes(dy, out, plan.table_on(dev), li, lw)), library_ms=None, plan=plan.describe())
        res.update(sparse_yardstick(rs, dy, plain, True, 3, 1))
        res["library_note"] += f"; {kernel_regs(f'resample_grad_walk_kernel<{plan.columns}, {plan.groups}>')}"
        return res

    return ("resample_grad", label, torch.float32, lambda: resample_cl_grad(dy, rs),
            lambda: resample_cl_grad_plain(dy, rs.in_shape, li.long(), lw, k0.long(), k1.long(), v), extras)


def crps_cases(pred, tar):
    """K15's forward and backward at the step's shapes: (B, E, C*H*W)."""
    from makani_torch.utils.losses.crps_loss import crps_skillspread_fwd, crps_skillspread_grad, crps_skillspread_grad_plain, crps_skillspread_plain

    B, E = pred.shape[:2]
    f = pred.reshape(B, E, -1)
    obs = tar.reshape(B, -1)
    g = torch.full_like(obs, 1.0 / obs.numel())
    note = "no library call computes the ensemble CRPS"
    fwd_extras = lambda out: dict(bound(float(B * f.shape[-1] * (E * E + 4 * E)), nbytes(f, obs, out)), library_ms=None, library_note=note)
    bwd_extras = lambda out: dict(bound(float(B * f.shape[-1] * (E * E + 5 * E)), nbytes(f, obs, g, out)), library_ms=None,
                                  library_note=f"{note}; {kernel_regs('crps_')}")
    return [
        ("crps", "forward", torch.float32, lambda: crps_skillspread_fwd(f, obs), lambda: crps_skillspread_plain(f, obs), fwd_extras),
        ("crps", "backward", torch.float32, lambda: crps_skillspread_grad(f, obs, g), lambda: crps_skillspread_grad_plain(f, obs, g), bwd_extras),
    ]


def mix_grad_times(conv, B, card):
    """K8's backward, two cuBLAS GEMMs in full fp32 (no kernel of the port):
    dt = dy . w2 into the padded responses layout, dw2 = dy^T . t2; timed
    beside their fp32 bound."""
    from makani_torch.ops.disco import RESPONSE_ALIGN
    from makani_torch.ops.precision import fp32_exact

    op = conv.conv_op
    dev = conv.weight.device
    H, W = op.out_shape
    D, N = conv.in_channels * op.K, conv.out_channels
    R = B * H * W
    gen = torch.Generator(dev).manual_seed(SEED + 11)
    Dp = -(-D // RESPONSE_ALIGN) * RESPONSE_ALIGN
    t2 = randn((R, Dp), torch.float32, gen, dev)[:, :D]
    dy = randn((R, N), torch.float32, gen, dev)
    w2p = torch.nn.functional.pad(conv.weight.detach().float().reshape(N, D), (0, Dp - D))
    with fp32_exact():
        for name, fn, nb in (("dt = dy.w2", lambda: torch.matmul(dy, w2p), nbytes(dy, w2p) + R * Dp * 4),
                             ("dw2 = dy^T.t2", lambda: torch.matmul(dy.t(), t2), nbytes(dy) + R * D * 4 + N * D * 4)):
            ms = time_ms(fn, 3, 1)
            b = bound(2.0 * R * D * N, nb)
            print(f"K8 backward {name:14s} ({R} x {N} x {D}, cuBLAS fp32): {ms:.3f} ms, fp32 bound {b['fma_bound_ms']:.3f} ms "
                  f"({b['bound_by']}), {2.0 * R * D * N / ms / 1e9:.1f} TFLOP/s  [{card}]", flush=True)
    del t2, dy, w2p
    torch.cuda.empty_cache()


def check_fcn3_train_kernels(dev, card, params, model, loss_obj, batch):
    """Phase 18: K12-K15 against their plain versions at the training step's
    shapes (B*E members), K5 and the global blocks' K1-K3 at the shapes the
    step gives them, K8's backward GEMMs timed, and K16 and K17 on the
    model's parameters with one step's gradients."""
    from makani_torch.models.common.contractions import _PermutedWeight, contract_dense_s, contract_dense_s_plain
    from makani_torch.ops import sht
    from makani_torch.ops.disco import FusedFilterCache

    net = model.model
    BE = FCN3_TRAIN_BATCH * FCN3_TRAIN_ENSEMBLE
    gen = torch.Generator(dev).manual_seed(SEED + 12)
    results = {}
    # K12 at the processor, reading the padded responses layout
    conv = net.block1.local_conv
    op = conv.conv_op
    C, K = conv.in_channels, op.K
    dt = op.response_buffer(BE, C, dev)
    dt.copy_(randn(dt.shape, torch.float32, gen, dev))
    run_cases([band_grad_case(op, dt, op.band_filter(0, dev), C, 1, 1, K, "processor", library=True)], card, results, 3, 1)
    del dt
    torch.cuda.empty_cache()
    # K5 forward at the same shape (8 launches a step, twice under remat)
    x = randn((BE, *op.in_shape, C), torch.float32, gen, dev)
    run_cases([band_case(op, x, op.band_filter(0, dev), 1, 1, K, "train-processor", library=True, padded=True)], card, results, 3, 1)
    del x
    torch.cuda.empty_cache()
    # K13 psi-first at the processor, mix-first at the atmo decoder
    M = op.in_shape[1] // 2 + 1
    dY = randn((BE, len(op.polar_rows), C, K, M, 2), torch.float32, gen, dev)
    run_cases([polar_grad_case(dY, op.polar_table(0, dev), "psi_first", "processor")], card, results, 3, 1)
    del dY
    torch.cuda.empty_cache()
    dec = net.atmo_decoder
    dop = dec.conv.conv_op
    g, og, ig, _ = dec.conv.weight.shape
    R = net.n_atmo_groups
    H, W = dop.in_shape
    dY = randn((BE, len(dop.polar_rows), R * g * og, W // 2 + 1, 2), torch.float32, gen, dev)
    run_cases([polar_grad_case(dY, dop.polar_table(0, dev), "mix_first", "atmo-decoder")], card, results, 3, 1)
    del dY
    torch.cuda.empty_cache()
    # K12 in fused mode at the atmo decoder (on the path) and the atmo
    # encoder (stride 2; the encoders' input needs no gradient, so the path
    # does not launch it there)
    cache = FusedFilterCache()
    dout = randn((BE, H, W, R * g * og), torch.float32, gen, dev)
    run_cases([band_grad_case(dop, dout, cache.get(dop, dec.conv.weight, 0), R * g * ig, g, ig, og, "atmo-decoder", library=True)], card, results, 3, 1)
    del dout
    enc = net.atmo_encoder.conv
    eg, eog, eig, _ = enc.weight.shape
    dout = randn((BE, *enc.conv_op.out_shape, R * eg * eog), torch.float32, gen, dev)
    run_cases([band_grad_case(enc.conv_op, dout, FusedFilterCache().get(enc.conv_op, enc.weight, 0), R * eg * eig, eg, eig, eog, "atmo-encoder",
                              library=True)], card, results, 3, 1)
    del dout
    torch.cuda.empty_cache()
    # K14 at both decoders
    for label, d, n in (("atmo-decoder", dec, R * dec.conv.in_channels), ("surf-decoder", net.surf_decoder, net.surf_embed_dim)):
        dy = randn((BE, *d.resample.out_shape, n), torch.float32, gen, dev)
        run_cases([resample_grad_case(d.resample, dy, label)], card, results, 3, 1)
        del dy
        torch.cuda.empty_cache()
    # K15 on the step's predictions and target
    inp, tar, unp = batch
    with torch.no_grad():
        pred = model(inp, unp, train=True).reshape(FCN3_TRAIN_BATCH, FCN3_TRAIN_ENSEMBLE, *tar.shape[1:])
    run_cases(crps_cases(pred, tar), card, results, 5, 1)
    del pred
    torch.cuda.empty_cache()
    # K9 and K3's dx at the global blocks' internal grid (2 launches a step each)
    spec = net.block0.global_conv
    fwd = spec.forward_transform
    run_cases(dhconv_grad_cases(BE, fwd.lmax, fwd.mmax, spec.weight.detach(), gen, "fcn3-internal", bf16=False), card, results, 3, 1)
    torch.cuda.empty_cache()
    # the global blocks' forward K1, K3, K2 at the same grid (2 launches a step each, under remat)
    inv = spec.inverse_transform
    xf = randn((BE, fwd.nlat, fwd.mmax, C, 2), torch.float32, gen, dev)
    wa = fwd.weights(dev)
    c2 = randn((BE, inv.lmax, inv.mmax, C, 2), torch.float32, gen, dev)
    pa = inv.pct(dev)
    xs = randn((BE, inv.lmax, inv.mmax, 1, C, 2), torch.float32, gen, dev)
    wcache = _PermutedWeight()
    run_cases([
        ("sht_analysis", "fcn3-train", torch.float32, lambda: sht.analysis_contract_cl_s(xf, wa), lambda: sht.analysis_contract_cl_s_plain(xf, wa), legendre_extras(xf, wa, 0, BE)),
        ("sht_synthesis", "fcn3-train", torch.float32, lambda: sht.synthesis_contract_cl_s(c2, pa), lambda: sht.synthesis_contract_cl_s_plain(c2, pa), legendre_extras(c2, pa, 1, BE)),
        ("dhconv", "fcn3-train", torch.float32, lambda: contract_dense_s(xs, spec.weight, False, "dhconv", True, weight_cache=wcache),
         lambda: contract_dense_s_plain(xs, spec.weight, False, "dhconv", True), dhconv_extras(xs, spec.weight.detach())),
    ], card, results, 3, 1)
    del xf, c2, xs
    torch.cuda.empty_cache()
    mix_grad_times(conv, BE, card)
    # K16 and K17 on the model's parameters with one step's gradients
    _, grads, _ = fcn3_grads(model, loss_obj, batch)
    grads = [grads[n] for n, _ in model.named_parameters()]
    results.update(optimizer_cases(card, model, grads, params, FCN3_STEPS_PER_EPOCH, "fcn3-recipe"))
    del grads
    torch.cuda.empty_cache()
    return results


def fcn3_wgrad_launches(net, members: int) -> int:
    """K5's launches a step for the weight gradients of the fused convs (the
    encoders and decoders), one a chunk of their responses and phase."""
    n_embed = net.n_atmo_groups * net.atmo_embed_dim
    convs = ((net.atmo_encoder.conv, net.n_atmo_groups * net.n_atmo), (net.surf_encoder.conv, net.n_surf), (net.aux_encoder.conv, net.n_aux),
             (net.atmo_decoder.conv, n_embed), (net.surf_decoder.conv, net.surf_embed_dim))
    return sum(len(c.conv_op.weight_grad_chunks(members, n)) * c.conv_op.phases for c, n in convs)


def fcn3_grads(model, loss_obj, batch):
    from makani_torch.utils.training.ensemble_trainer import fold_ensemble

    inp, tar, unp = batch
    pred = model(inp, unp, train=True)
    loss = loss_obj(fold_ensemble(pred, FCN3_TRAIN_ENSEMBLE), tar, train=True)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads, pred.detach()


def compare_fcn3_train_steps(dev, card, batch):
    """Phase 19: one full-width training step's loss and gradients in bf16
    compute, through the kernels and through the plain path (autograd
    through the plain forward and the plain CRPS), from the same weights and
    batch; then the optimizer step from the same gradients
    (``compare_optimizer_step``)."""
    import copy

    from makani_torch import kernels
    from makani_torch.utils.training.ensemble_trainer import fold_ensemble

    params, model, loss_obj = build_fcn3_train(dev)
    plain, plain_loss = copy.deepcopy(model), copy.deepcopy(loss_obj)
    kernels.set_use_kernels(plain, False)
    plain_loss.loss_fns[0].use_kernels = False
    tar = batch[1]
    t0 = time.perf_counter()
    lk, gk, pk = fcn3_grads(model, loss_obj, batch)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lp, gp, pp = fcn3_grads(plain, plain_loss, batch)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # the forecasts of the gradients' own forwards
    err = errors(pk, pp)
    wgt = crps_order_weight(fold_ensemble(pk, FCN3_TRAIN_ENSEMBLE), fold_ensemble(pp, FCN3_TRAIN_ENSEMBLE), tar)
    del pk, pp
    worst = max((((gk[n].float() - gp[n].float()).norm() / gp[n].float().norm()).item(), n) for n in gp)
    ok = abs(lk - lp) <= MODEL_BF16_REL_L2 * abs(lp) and worst[0] <= TRAIN_GRAD_BF16_REL_L2 and err["rel_l2"] <= MODEL_BF16_REL_L2
    print(f"FCN3 training step (bfloat16 compute, full width, B={FCN3_TRAIN_BATCH} E={FCN3_TRAIN_ENSEMBLE}), kernel path vs plain path: forecast relL2 "
          f"{err['rel_l2']:.3e} (tol {MODEL_BF16_REL_L2}); loss {lk:.6f} vs {lp:.6f} (rel {abs(lk - lp) / abs(lp):.2e}, tol {MODEL_BF16_REL_L2}); "
          f"worst gradient leaf {worst[1]} relL2 {worst[0]:.3e} (tol {TRAIN_GRAD_BF16_REL_L2}); pixels the two forecasts may rank differently "
          f"{1.0 - wgt.mean().item():.2%} (counted, not excluded: the bf16 gates cover them); step {t_k:.1f} s vs {t_p:.1f} s (first, with "
          f"warm-up) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError("FCN3 bf16 training step: the kernel path disagrees with the plain path")
    del gp
    compare_optimizer_step(card, "FCN3 recipe", params, FCN3_STEPS_PER_EPOCH, model, plain, gk)
    del model, plain, gk
    torch.cuda.empty_cache()


def time_fcn3_train(dev, card, batch, use_kernels, steps):
    """``steps`` + 1 training steps (``ensemble_train_step`` with the
    recipe's optimizer) on the repeated batch, through the kernels or the
    plain path; returns ``timed_recipe_steps``' record, the optimizer's
    launches a step and K5's launches a step for the weight gradients."""
    from makani_torch import kernels
    from makani_torch.utils.training.ensemble_trainer import ensemble_train_step

    params, model, loss_obj = build_fcn3_train(dev)
    kernels.set_use_kernels(model, use_kernels)
    opt = recipe_optimizer(params, model, FCN3_STEPS_PER_EPOCH, use_kernels)
    loss_obj.loss_fns[0].use_kernels = use_kernels
    inp, tar, unp = batch
    out = timed_recipe_steps(lambda: ensemble_train_step(model, loss_obj, opt, inp, tar, unp, FCN3_TRAIN_ENSEMBLE), opt, steps)
    per_step, n_wgrad = optimizer_launches(opt), fcn3_wgrad_launches(model.model, FCN3_TRAIN_BATCH * FCN3_TRAIN_ENSEMBLE)
    del model, opt
    torch.cuda.empty_cache()
    return out + (per_step, n_wgrad)


def fcn3_train_phases(dev, card):
    """Phases 17-20; returns (kernel results, launch counts of the timed
    training steps)."""
    from makani_torch.utils.training.optimizer import get_schedule

    t0 = time.perf_counter()
    params, model, loss_obj = build_fcn3_train(dev)
    net = model.model
    nparam = sum(p.numel() for p in model.parameters())
    print(f"built the FCN3 training step ({nparam} parameters, compute {params.compute_dtype}, {params.img_shape_x}x{params.img_shape_y} -> internal "
          f"{net.h}x{net.w}, {net.num_layers} blocks, {params.N_in_channels} in / {params.N_out_channels} out channels, B={FCN3_TRAIN_BATCH} "
          f"E={FCN3_TRAIN_ENSEMBLE}, checkpointing_level {net.checkpointing_level}; loss {params.losses}; Adam, clip {params.optimizer_max_grad_norm}, "
          f"{params.scheduler} over {params.scheduler_T_max} epochs of {FCN3_STEPS_PER_EPOCH} steps at lr {params.lr}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    batch = fcn3_train_batch(dev, params)
    t0 = time.perf_counter()
    kres = check_fcn3_train_kernels(dev, card, params, model, loss_obj, batch)
    print(f"phase 18 (FCN3 training kernel checks) {time.perf_counter() - t0:.1f} s", flush=True)
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    compare_fcn3_train_steps(dev, card, batch)
    print(f"phase 19 (FCN3 training step, kernel vs plain) {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 20: the main path, timed
    losses, times, peak, launches, lrs, norms, per_step, n_wgrad = time_fcn3_train(dev, card, batch, True, TRAIN_STEPS)
    n = TRAIN_STEPS + 1
    expected = {k: (FCN3_TRAIN_EXPECTED_PER_STEP.get(k, 0) + per_step.get(k, 0)) * n for k in launches}
    expected["disco_band"] += n_wgrad * n
    print(f"FCN3 training launches over {n} steps: {launches} (per step {({k: v / n for k, v in launches.items()})})")
    if launches != expected:
        raise RuntimeError(f"FCN3 training launch counts {launches} != expected {expected}")
    members = FCN3_TRAIN_BATCH * FCN3_TRAIN_ENSEMBLE
    p_losses, p_times, p_peak, _, p_lrs, p_norms = time_fcn3_train(dev, card, batch, False, TRAIN_STEPS)[:6]
    for label, ls, ts, pk, lr_, nm in (("kernel", losses, times, peak, lrs, norms), ("plain", p_losses, p_times, p_peak, p_lrs, p_norms)):
        med = statistics.median(ts[1:])
        print(f"FCN3 recipe training step ({label} path, bf16, B={FCN3_TRAIN_BATCH} E={FCN3_TRAIN_ENSEMBLE}): median {med:.2f} ms over {TRAIN_STEPS} "
              f"steps after a warm-up {[round(t, 2) for t in ts]}, {members / med * 1e3:.3f} samples/s (members), peak memory {pk / 2**30:.2f} GiB; "
              f"loss per step {[round(v, 6) for v in ls]}; lr per step {[f'{v:.6e}' for v in lr_]}; grad norm per step {[round(v, 4) for v in nm]}  "
              f"[{card}]", flush=True)
    # the loss must fall below its first value, each step's learning rate be
    # the schedule's, and each step's loss the plain path's (each step's
    # forward reads the weights that the previous step's optimizer wrote)
    if not all(math.isfinite(v) for v in losses) or not min(losses[1:]) < losses[0]:
        raise RuntimeError(f"FCN3 training loss not finite or not falling over {TRAIN_STEPS} steps: {losses}")
    if lrs != p_lrs or lrs != [get_schedule(params, FCN3_STEPS_PER_EPOCH)(k) for k in range(n)]:
        raise RuntimeError(f"FCN3 recipe learning rates {lrs} (plain path {p_lrs}) are not the schedule's")
    if not all(abs(a - b) <= MODEL_BF16_REL_L2 * abs(b) for a, b in zip(losses, p_losses)):
        raise RuntimeError(f"FCN3 training losses of the kernel path {losses} and the plain path {p_losses} part")
    return kres, launches


# ---------------------------------------------------------------------------
# The recipes' optimizer: K16 (global-norm clipping) and K17 (Adam), shared
# by the FCN3 recipe step (slice 4) and the SFNO recipe step (slice 5)


def recipe_optimizer(params, model, steps_per_epoch, use_kernels=True):
    """``get_optimizer`` on the recipe's settings; on the kernel path its
    ``step`` runs under ``torch.cuda.set_sync_debug_mode("error")``: a step
    that waits for the card (a copy to the host, a synchronising call)
    raises."""
    from makani_torch.utils.training.optimizer import get_optimizer

    opt = get_optimizer(params, model, steps_per_epoch)
    opt.use_kernels = use_kernels
    if use_kernels:
        step = opt.step

        def checked(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return step(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        opt.step = checked
    return opt


def optimizer_launches(opt) -> dict:
    """K16's and K17's launches a step: two for every 128 trainable leaves
    (where the recipe clips), one for every 64."""
    from makani_torch.utils.training.optimizer import _MAX_ADAM_LEAVES, _MAX_NORM_LEAVES

    n = sum(len(g["params"]) for g in opt.param_groups if not g["frozen"])
    return {"grad_norm": 2 * -(-n // _MAX_NORM_LEAVES) if opt.max_grad_norm else 0, "adam": -(-n // _MAX_ADAM_LEAVES)}


def leaf_errors(outs, refs) -> dict:
    """``errors`` over lists of leaves, one leaf at a time (no temporary the
    size of the model)."""
    d2 = r2 = max_abs = scale = 0.0
    for o, r in zip(outs, refs):
        d = o.float() - r.float()
        d2 += float(d.square().sum())
        r2 += float(r.float().square().sum())
        max_abs = max(max_abs, float(d.abs().max()))
        scale = max(scale, float(r.abs().max()))
    return {"max_abs_err": max_abs, "max_rel": max_abs / scale, "rel_l2": math.sqrt(d2 / r2), "max_ref": scale}


def timed_restoring(fn, work, source, iters=5, warmup=1) -> float:
    """Mean ms of ``fn`` (CUDA events around each call alone), ``work``
    restored from ``source`` before each call: an in-place function sees
    the same inputs every time."""
    total = 0.0
    for i in range(warmup + iters):
        for w, g in zip(work, source):
            w.copy_(g)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        if i >= warmup:
            total += s.elapsed_time(e)
    return total / iters


def optimizer_cases(card, model, grads, params, steps_per_epoch, label) -> dict:
    """K16 and K17 on the model's parameters with one step's gradients
    (a list in ``model.parameters()`` order), each against its plain version
    on copies, timed beside its bound and the library's call; returns
    {(name, label, float32): result}."""
    from makani_torch.utils.training.optimizer import _bias_corrections, adam_update, adam_update_plain, clip_by_global_norm, get_schedule

    res = {}
    ps = [p.detach() for p in model.parameters()]
    n = sum(p.numel() for p in ps)
    max_norm = params.optimizer_max_grad_norm
    # K16: the norm and the clip
    gk, gp = [g.clone() for g in grads], [g.clone() for g in grads]
    nk, npl = clip_by_global_norm(gk, max_norm), clip_by_global_norm(gp, max_norm, use_kernels=False)
    torch.cuda.synchronize()
    nk, npl = nk.item(), npl.item()
    err = leaf_errors(gk, gp)
    clipped = not npl < max_norm
    del gp
    lib_ms = timed_restoring(lambda: torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gk))), gk, grads)
    ms = timed_restoring(lambda: clip_by_global_norm(gk, max_norm), gk, grads)
    plain_ms = timed_restoring(lambda: clip_by_global_norm(gk, max_norm, use_kernels=False), gk, grads)
    # bytes: g read once for the sum, and written once where it clips
    b = bound((4.0 if clipped else 2.0) * n, (8 if clipped else 4) * n)
    norm_rel = abs(nk - npl) / npl
    ok = norm_rel <= FP32_TOL and err["max_rel"] <= FP32_TOL
    print(f"kernel grad_norm         {label:17s} float32  {len(grads)} leaves, {n} parameters: norm {nk:.6f} vs plain {npl:.6f} (rel {norm_rel:.2e}), "
          f"{'clipped' if clipped else 'kept'} at {max_norm}; g max|d|/max|ref| {err['max_rel']:.3e} relL2 {err['rel_l2']:.3e} {'ok' if ok else 'FAIL'}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound_ms {b['bound_ms']:.3f} ms ({b['bound_by']}), library_ms {lib_ms:.3f} ms "
          f"(torch._foreach_norm + vector_norm, the norm alone); {kernel_regs('sumsq_kernel', 'clip_kernel')}  [{card}]", flush=True)
    if not ok:
        raise RuntimeError(f"grad_norm ({label}) disagrees with its plain version: norm {nk} vs {npl}, {err}")
    res[("grad_norm", label, torch.float32)] = dict(err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, norm=nk, plain_norm=npl, clipped=clipped, **b)
    if not clipped:
        # the clip pass too, on the same gradients at half their norm
        half = npl / 2
        ck, cp = [g.clone() for g in grads], [g.clone() for g in grads]
        clip_by_global_norm(ck, half)
        clip_by_global_norm(cp, half, use_kernels=False)
        cerr = leaf_errors(ck, cp)
        del cp
        c_ms = timed_restoring(lambda: clip_by_global_norm(ck, half), ck, grads)
        c_plain = timed_restoring(lambda: clip_by_global_norm(ck, half, use_kernels=False), ck, grads)
        del ck
        cb = bound(4.0 * n, 8 * n)
        print(f"kernel grad_norm         {label + ' clipping':17s} float32  max_norm {half:.6f} (half the norm): g max|d|/max|ref| {cerr['max_rel']:.3e} "
              f"relL2 {cerr['rel_l2']:.3e} {'ok' if cerr['max_rel'] <= FP32_TOL else 'FAIL'}; kernel {c_ms:.3f} ms, plain {c_plain:.3f} ms, bound_ms "
              f"{cb['bound_ms']:.3f} ms ({cb['bound_by']})  [{card}]", flush=True)
        if cerr["max_rel"] > FP32_TOL:
            raise RuntimeError(f"grad_norm ({label}, clipping) disagrees with its plain version: {cerr}")
    # K17: one step from a fresh fp32 state on the clipped gradients
    b1, b2, eps = params.get("optimizer_beta1", 0.9), params.get("optimizer_beta2", 0.999), params.get("optimizer_eps", 1e-8)
    lr = get_schedule(params, steps_per_epoch)(0)
    c1, c2 = _bias_corrections(1, b1, b2)

    def fresh():
        return [(p.clone(), g, torch.zeros_like(p), torch.zeros_like(p), 0.0) for p, g in zip(ps, gk)]

    kern = fresh()
    adam_update(kern, torch.float32, c1, c2, b1, b2, eps, lr)
    plain = fresh()
    for leaf in plain:
        adam_update_plain(*leaf[:4], c1, c2, b1, b2, eps, lr)
    torch.cuda.synchronize()
    errs = [leaf_errors([a[i] for a in kern], [b_[i] for b_ in plain]) for i in (0, 2, 3)]
    err = errs[0]
    del plain
    torch.cuda.empty_cache()
    ms = time_ms(lambda: adam_update(kern, torch.float32, c1, c2, b1, b2, eps, lr), 5, 1)
    del kern
    torch.cuda.empty_cache()
    plain = fresh()
    plain_ms = time_ms(lambda: [adam_update_plain(*leaf[:4], c1, c2, b1, b2, eps, lr) for leaf in plain], 2, 1)
    del plain
    torch.cuda.empty_cache()
    lib_ps = [torch.nn.Parameter(p.clone()) for p in ps]
    for p, g in zip(lib_ps, gk):
        p.grad = g
    lib_opt = torch.optim.Adam(lib_ps, lr=lr, betas=(b1, b2), eps=eps, fused=True)
    lib_ms = time_ms(lib_opt.step, 5, 1)
    del lib_ps, lib_opt
    torch.cuda.empty_cache()
    # bytes: p, g, mu, v read, p, mu, v written (fp32 mu); about 14
    # operations a parameter
    b = bound(14.0 * n, 28 * n)
    ok = all(e["max_rel"] <= FP32_TOL for e in errs)
    print(f"kernel adam              {label:17s} float32  {len(ps)} leaves, {n} parameters, lr {lr:.6e}: p max|d|/max|ref| {errs[0]['max_rel']:.3e}, "
          f"mu {errs[1]['max_rel']:.3e}, v {errs[2]['max_rel']:.3e} {'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound_ms {b['bound_ms']:.3f} ms ({b['bound_by']}), library_ms {lib_ms:.3f} ms (torch.optim.Adam(fused=True), fp32 state); "
          f"{kernel_regs('adam_kernel')}  [{card}]", flush=True)
    if not ok:
        raise RuntimeError(f"adam ({label}) disagrees with its plain version: {errs}")
    res[("adam", label, torch.float32)] = dict(err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b)
    del gk
    torch.cuda.empty_cache()
    return res


def compare_optimizer_step(card, label, params, steps_per_epoch, model, plain, grads):
    """The recipe's optimizer step through K16 and K17 and through its plain
    versions, on ``model`` and ``plain`` (the same weights) with the same
    gradients (by name) from a fresh state: the norms within FP32_TOL, the
    same learning rate, each parameter within 1e-3 lr max(1, |u|) of the
    plain path's where |g| > 1e-3 of its leaf's max (the fp32 step's gate)."""
    opts = []
    for m, use in ((model, True), (plain, False)):
        for name, p in m.named_parameters():
            p.grad = grads[name].clone()
        opts.append(recipe_optimizer(params, m, steps_per_epoch, use))
    p0 = {name: p.detach().clone() for name, p in plain.named_parameters()}
    for opt in opts:
        opt.step()
    torch.cuda.synchronize()
    (ok_, op_) = opts
    nk, npl = ok_.last_grad_norm.item(), op_.last_grad_norm.item()
    lr = op_.last_lr
    pk = dict(model.named_parameters())
    worst = (0.0, "")
    for name, pp in plain.named_parameters():
        g = grads[name].float().abs()
        mask = g > 1e-3 * g.max()
        u = ((pp.detach() - p0[name]) / lr).abs()
        r = ((pk[name].detach() - pp.detach()).abs() / lr / torch.clamp_min(u, 1.0))[mask]
        worst = max(worst, (r.max().item() if r.numel() else 0.0, name))
    ok = abs(nk - npl) <= FP32_TOL * npl and ok_.last_lr == lr and worst[0] <= 1e-3
    print(f"{label} optimizer step (K16 + K17 vs plain, same gradients): grad norm {nk:.6f} vs {npl:.6f} (clip at {params.optimizer_max_grad_norm}), "
          f"lr {ok_.last_lr:.6e} vs {lr:.6e}; worst parameter after the step {worst[1]} {worst[0]:.3e} lr max(1, |u|) (tol 1e-3) {'ok' if ok else 'FAIL'}",
          flush=True)
    for m in (model, plain):
        m.zero_grad(set_to_none=True)
    if not ok:
        raise RuntimeError(f"{label}: the optimizer step through the kernels disagrees with the plain path")


def timed_recipe_steps(step, opt, steps):
    """``steps`` + 1 training steps (the first a warm-up) through ``step()``;
    returns (the losses, the step times in ms, the peak memory, the launch
    counts of all steps, each step's learning rate and global norm)."""
    from makani_torch import kernels

    losses, times, lrs, norms = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for _ in range(steps + 1):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        loss = step()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
        losses.append(loss.item())
        lrs.append(opt.last_lr)
        norms.append(opt.last_grad_norm.item() if opt.last_grad_norm is not None else None)
    return losses, times, torch.cuda.max_memory_allocated(), dict(kernels.LAUNCHES), lrs, norms


# ---------------------------------------------------------------------------
# The SFNO recipe's training step (slice 5)

RECIPE_BATCH = 1  # the recipe's batch of 64 on 64 GPUs, one card's share
RECIPE_STEPS = 5
RECIPE_PLAIN_STEPS = 3


def recipe_params(compute_dtype="bfloat16"):
    """``sfno_linear_73chq_sc3_layers8_edim384`` of config/sfnonet.yaml as
    it stands, on the seeded statistics files."""
    from makani_torch.utils.yparams import YParams

    params = YParams(os.path.join(REPO, CONFIG[0]), CONFIG[1])
    n = len(params.channel_names)
    params["in_channels"] = list(range(n))
    params["out_channels"] = list(range(n))
    params["compute_dtype"] = compute_dtype
    for key, path in stats_files(n).items():
        params[key] = path
    return params


def recipe_steps_per_epoch(params) -> int:
    """The recipe's steps an epoch: its samples an epoch over its batch."""
    return params.n_train_samples_per_epoch // params.batch_size


def build_recipe(dev, compute_dtype="bfloat16"):
    from makani_torch.models.model_registry import get_model
    from makani_torch.utils.loss import LossHandler

    params = recipe_params(compute_dtype)
    model, _ = get_model(params, multistep=True, device=dev, seed=SEED)
    return params, model, LossHandler(recipe_params(compute_dtype))


def recipe_batch(dev, params):
    gen = torch.Generator(dev).manual_seed(SEED + 13)
    H, W, C = params.img_shape_x, params.img_shape_y, len(params.channel_names)
    inp = randn((RECIPE_BATCH, C, H, W), torch.float32, gen, dev)
    tar = randn((RECIPE_BATCH, C, H, W), torch.float32, gen, dev)
    zen = randn((RECIPE_BATCH, 1, 1, H, W), torch.float32, gen, dev)
    return inp, tar, zen


def compare_recipe_steps(dev, card, batch):
    """One recipe step through the kernels and through the plain path from
    the same weights and batch, as phase 15 holds the bench's step: in fp32
    compute the loss, every gradient leaf and (``compare_optimizer_step``)
    the parameters after the optimizer's step, at the fp32 gates; in bf16
    compute (the recipe's) the loss and every gradient leaf at the bf16
    gates. A bf16 leaf that misses them is held against the fp32 gradient
    of the same weights instead: the kernel path's bf16 rounding may not
    move it farther from there than 1.25 times the plain path's does. Both
    round in bf16, at other places; a leaf whose exact gradient cancels (a
    sum over every pixel of terms that nearly cancel, as in front of the
    first block's instance norm) magnifies either path's rounding alike."""
    import copy

    from makani_torch import kernels

    rel_l2 = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()
    runs = {}
    for dtype in ("float32", "bfloat16"):
        params, model, loss_obj = build_recipe(dev, dtype)
        plain = copy.deepcopy(model)
        kernels.set_use_kernels(plain, False)
        lk, gk = loss_and_grads(model, loss_obj, *batch)
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        lp, gp = loss_and_grads(plain, loss_obj, *batch)
        plain.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        largest = max(g.abs().max().item() for g in gp.values())
        worst, held = (0.0, ""), []
        for name in gp:
            a, b = gk[name], gp[name]
            if zero_in_exact_arithmetic(name):
                if max(a.abs().max().item(), b.abs().max().item()) > (1e-5 if dtype == "float32" else 1e-2) * largest:
                    raise RuntimeError(f"SFNO recipe step ({dtype}): {name}'s gradient is not at rounding level")
                continue
            if dtype == "float32":
                worst = max(worst, (((a - b).abs().max() / b.abs().max()).item(), name))
                continue
            rel = rel_l2(a, b)
            if rel > TRAIN_GRAD_BF16_REL_L2:
                ek, ep = rel_l2(a, runs["float32"][name]), rel_l2(b, runs["float32"][name])
                held.append((name, rel, ek, ep))
                if ek > 1.25 * ep:
                    raise RuntimeError(f"SFNO recipe step (bf16): gradient {name} relL2 {rel:.3e} against the plain path, {ek:.3e} from the fp32 "
                                       f"gradient against the plain path's {ep:.3e}")
                continue
            worst = max(worst, (rel, name))
        tol_l, tol_g = (TRAIN_LOSS_FP32_TOL, MODEL_FP32_TOL) if dtype == "float32" else (MODEL_BF16_REL_L2, TRAIN_GRAD_BF16_REL_L2)
        ok = abs(lk - lp) <= tol_l * abs(lp) and worst[0] <= tol_g
        print(f"SFNO recipe training step ({dtype} compute, {params.img_shape_x}x{params.img_shape_y}, B={RECIPE_BATCH}), kernel path vs plain "
              f"path: loss {lk:.7f} vs {lp:.7f} (rel {abs(lk - lp) / abs(lp):.2e}, tol {tol_l}); worst gradient leaf {worst[1]} "
              f"{'max|d|/max|ref|' if dtype == 'float32' else 'relL2'} {worst[0]:.3e} (tol {tol_g}); held to the fp32 gradient instead "
              f"(relL2 kernel-plain, kernel-fp32, plain-fp32): {[(n, f'{r:.3e}', f'{k:.3e}', f'{p:.3e}') for n, r, k, p in held]} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"SFNO recipe step ({dtype}): the kernel path disagrees with the plain path")
        if dtype == "float32":
            compare_optimizer_step(card, "SFNO recipe (float32 compute)", params, recipe_steps_per_epoch(params), model, plain, gp)
            runs[dtype] = gp
        del model, plain, gk
        torch.cuda.empty_cache()
    del runs
    torch.cuda.empty_cache()


def time_recipe(dev, card, batch, use_kernels, steps):
    """``steps`` + 1 recipe training steps (``train_step`` with the recipe's
    optimizer) on the repeated batch; ``timed_recipe_steps``' record and the
    optimizer's launches a step."""
    from makani_torch import kernels
    from makani_torch.utils.training.deterministic_trainer import train_step

    params, model, loss_obj = build_recipe(dev)
    kernels.set_use_kernels(model, use_kernels)
    opt = recipe_optimizer(params, model, recipe_steps_per_epoch(params), use_kernels)
    out = timed_recipe_steps(lambda: train_step(model, loss_obj, opt, *batch), opt, steps)
    per_step = optimizer_launches(opt)
    del model, opt
    torch.cuda.empty_cache()
    return out + (per_step,)


def recipe_phases(dev, card):
    """Phases 21-24; returns (kernel results, launch counts of the timed
    recipe steps)."""
    from makani_torch.utils.training.optimizer import get_schedule

    t0 = time.perf_counter()
    params, model, loss_obj = build_recipe(dev)
    net = model.model
    nparam = sum(p.numel() for p in model.parameters())
    print(f"built the SFNO recipe's training step ({CONFIG[1]}: {nparam} parameters in {len(list(model.parameters()))} leaves, compute "
          f"{params.compute_dtype}, {params.img_shape_x}x{params.img_shape_y} -> internal {net.h}x{net.w}, lmax/mmax {net.trans.lmax}/{net.trans.mmax}, "
          f"embed {net.embed_dim}, {net.num_layers} blocks, B={RECIPE_BATCH}; loss {params.losses}; Adam b2 {params.optimizer_beta2}, clip "
          f"{params.optimizer_max_grad_norm}, {params.scheduler} over {params.scheduler_T_max} epochs of {recipe_steps_per_epoch(params)} steps at "
          f"lr {params.lr}) in {time.perf_counter() - t0:.1f} s", flush=True)
    batch = recipe_batch(dev, params)
    t0 = time.perf_counter()
    kres = check_train_kernels(dev, card, model, loss_obj, batch, B=RECIPE_BATCH, adam=False)
    _, grads = loss_and_grads(model, loss_obj, *batch)
    model.zero_grad(set_to_none=True)
    kres.update(optimizer_cases(card, model, [grads[n] for n, _ in model.named_parameters()], params, recipe_steps_per_epoch(params), "sfno-recipe"))
    del grads
    print(f"phase 22 (SFNO recipe kernel checks) {time.perf_counter() - t0:.1f} s", flush=True)
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    compare_recipe_steps(dev, card, batch)
    print(f"phase 23 (SFNO recipe step, kernel vs plain) {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 24: the main path, timed; then the plain path
    losses, times, peak, launches, lrs, norms, per_step = time_recipe(dev, card, batch, True, RECIPE_STEPS)
    n = RECIPE_STEPS + 1
    expected = {k: (TRAIN_EXPECTED_PER_STEP.get(k, 0) + per_step.get(k, 0)) * n for k in launches}
    print(f"SFNO recipe launches over {n} steps: {launches} (per step {({k: v / n for k, v in launches.items()})})")
    if launches != expected:
        raise RuntimeError(f"SFNO recipe launch counts {launches} != expected {expected}")
    if lrs != [get_schedule(params, recipe_steps_per_epoch(params))(k) for k in range(n)]:
        raise RuntimeError(f"SFNO recipe learning rates {lrs} are not the schedule's")
    if not all(math.isfinite(v) for v in losses) or not min(losses[1:]) < losses[0]:
        raise RuntimeError(f"SFNO recipe loss not finite or not falling over {RECIPE_STEPS} steps: {losses}")
    p_losses, p_times, p_peak, _, p_lrs, p_norms, _ = time_recipe(dev, card, batch, False, RECIPE_PLAIN_STEPS)
    for label, ls, ts, pk, lr_, nm in (("kernel", losses, times, peak, lrs, norms), ("plain", p_losses, p_times, p_peak, p_lrs, p_norms)):
        med = statistics.median(ts[1:])
        print(f"SFNO recipe training step ({label} path, bf16, {params.img_shape_x}x{params.img_shape_y}, B={RECIPE_BATCH}): median {med:.2f} ms over "
              f"{len(ts) - 1} steps after a "
              f"warm-up {[round(t, 2) for t in ts]}, {RECIPE_BATCH / med * 1e3:.3f} samples/s, peak memory {pk / 2**30:.2f} GiB; loss per step "
              f"{[round(v, 6) for v in ls]}; lr per step {[f'{v:.6e}' for v in lr_]}; grad norm per step {[round(v, 4) for v in nm]}  [{card}]", flush=True)
    if not all(abs(a - b) <= MODEL_BF16_REL_L2 * abs(b) for a, b in zip(losses, p_losses)) or lrs[: len(p_lrs)] != p_lrs:
        raise RuntimeError(f"SFNO recipe losses of the kernel path {losses} and the plain path {p_losses} part, or their learning rates")
    return kres, launches


# ---------------------------------------------------------------------------
# The drivers: train.py and inference.py on the SFNO recipe (phases 25-29)

# one year file each for training and validation, 5 states: 4 training
# samples (B = 1) and one validation rollout of DRIVER_AUTOREG + 1 lead steps
DRIVER_STATES = 5
DRIVER_AUTOREG = 3
DRIVER_YEARS = {"train": 2017, "valid": 2018}
DRIVER_NAME = "sfno_driver"
# a sync that the loops under set_sync_debug_mode("warn") make is a warning with this text
SYNC_WARNING = "called a synchronizing CUDA operation"


def seeded_run_files(root: str, dev, config, name: str, shape, states: int, cuts: dict, ref: dict, ignore=()) -> tuple:
    """Seeded HDF5 year files for a driver run of ``config``'s channels at
    ``shape`` (``fields`` (states, C, H, W) fp32, six-hourly ``timestamp``),
    written through ``makani_torch.utils.hdf5`` from fields drawn on the
    card, whose normalized values are standard normal, one year each of
    ``DRIVER_YEARS``; ``data.json``; the statistics (``stats_files`` and a
    time-means file for the ACC); and a YAML whose entry ``name`` inherits
    the recipe's (the config file's text, then the entry merging its
    ``BASE_CONFIG``) and overrides the paths and ``cuts``. The entry must
    equal ``ref`` beyond the overrides and ``ignore``. Returns (yaml path,
    the overrides, the bytes written, the statistics paths, the data
    normalization (bias, scale) on the card)."""
    from makani_torch.utils import hdf5
    from makani_torch.utils.dataloaders.data_helpers import get_data_normalization
    from makani_torch.utils.yparams import YParams

    recipe = YParams(os.path.join(REPO, config[0]), config[1])
    names = list(recipe.channel_names)
    C, (H, W) = len(names), shape
    stats = stats_files(C)
    view = {"channel_names": names, "in_channels": list(range(C)), "normalization": recipe.normalization, **stats}
    bias, scale = (torch.from_numpy(a).to(dev) for a in get_data_normalization(view))
    os.makedirs(os.path.join(root, "stats"))
    gen = torch.Generator(dev).manual_seed(SEED + 30)
    tm = (bias + 0.1 * scale * torch.randn((1, C, H, W), generator=gen, device=dev)).cpu().numpy()
    stats["time_means_path"] = os.path.join(root, "stats", "time_means.npy")
    np.save(stats["time_means_path"], tm)
    nbytes_written = tm.nbytes
    for split, year in DRIVER_YEARS.items():
        os.makedirs(os.path.join(root, split))
        t0 = np.datetime64(f"{year}-01-01T00:00:00").astype("datetime64[s]").astype(np.int64)
        maps = hdf5.File.create(os.path.join(root, split, f"{year}.h5"), {"fields": ((states, C, H, W), np.float32), "timestamp": ((states,), np.int64)})
        maps["timestamp"][:] = t0 + np.arange(states) * 6 * 3600
        for t in range(states):
            maps["fields"][t] = (bias[0] + scale[0] * torch.randn((C, H, W), generator=gen, device=dev)).cpu().numpy()
        for m in maps.values():
            m.flush()
            nbytes_written += m.nbytes
        del maps
    meta = {"h5_path": "fields", "dhours": 6, "coords": {"grid_type": "equiangular", "lat": np.linspace(90.0, -90.0, H).tolist(),
                                                         "lon": np.linspace(0.0, 360.0, W, endpoint=False).tolist(), "channel": names}}
    with open(os.path.join(root, "data.json"), "w") as f:
        json.dump(meta, f)
    overrides = dict(metadata_json_path=os.path.join(root, "data.json"), train_data_path=os.path.join(root, "train"), valid_data_path=os.path.join(root, "valid"),
                     exp_dir=os.path.join(root, "runs"), **stats, **cuts)
    with open(os.path.join(REPO, config[0])) as f:
        text = f.read()
    lines = [f"{name}:", "    <<: *BASE_CONFIG"] + [f"    {k}: {json.dumps(v)}" for k, v in overrides.items()]
    path = os.path.join(root, "driver.yaml")
    with open(path, "w") as f:
        f.write(text + "\n" + "\n".join(lines) + "\n")
    mine = YParams(path, name).to_dict()
    skip = set(overrides) | {"config", "yaml_filename"} | set(ignore)
    differ = sorted(k for k in set(mine) | set(ref) if k not in skip and mine.get(k) != ref.get(k))
    if differ:
        raise RuntimeError(f"the driver config {name} differs from its reference beyond the overrides: {differ}")
    return path, overrides, nbytes_written, stats, (bias, scale)


def driver_files(root: str, dev) -> tuple:
    """Phase 25: ``seeded_run_files`` for the SFNO recipe at its own grid,
    ``DRIVER_STATES`` states a year, its config overriding only the paths,
    ``valid_autoreg_steps`` and ``max_epochs``. Returns (yaml path, the
    overrides)."""
    from makani_torch.utils.yparams import YParams

    recipe = YParams(os.path.join(REPO, CONFIG[0]), CONFIG[1])
    C, H, W = len(recipe.channel_names), recipe.img_shape_x, recipe.img_shape_y
    path, overrides, nbytes_written, _, _ = seeded_run_files(root, dev, CONFIG, DRIVER_NAME, (H, W), DRIVER_STATES,
                                                             dict(valid_autoreg_steps=DRIVER_AUTOREG, max_epochs=1), recipe.to_dict())
    print(f"phase 25: wrote {nbytes_written / 1e9:.2f} GB of seeded files ({len(DRIVER_YEARS)} year files of {DRIVER_STATES} states of {C}x{H}x{W} fp32, "
          f"time means, data.json) under {os.path.relpath(root, REPO)}; {DRIVER_NAME} = {CONFIG[1]} but for {sorted(overrides)}", flush=True)
    return path, overrides


def checking_syncs(obj, name: str, found: list):
    """Run ``obj.name`` under ``torch.cuda.set_sync_debug_mode("warn")`` from
    now on, adding each sync it makes (a warning) to ``found``."""
    fn = getattr(obj, name)

    def checked(*args, **kwargs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                found.extend(f"{name}: {w.filename}:{w.lineno}: {str(w.message)[:80]}" for w in caught if SYNC_WARNING in str(w.message))

    setattr(obj, name, checked)


def counting_launches(cls, name: str, kernel: str, launches: dict, found: dict):
    """Patch ``cls.name`` so that the launches of ``kernel`` (its count in
    ``launches``, the package's ``LAUNCHES``) made inside each call add to
    ``found[kernel]``; returns the undo."""
    fn = getattr(cls, name)

    def counted(*args, **kwargs):
        n0 = launches[kernel]
        try:
            return fn(*args, **kwargs)
        finally:
            found[kernel] += launches[kernel] - n0

    setattr(cls, name, counted)
    return lambda: setattr(cls, name, fn)


def host_line(stats: dict) -> str:
    """The loader's and the steps' account of one epoch (``Trainer.host_stats``)."""
    n = max(stats["batches"], 1)
    steps = stats.get("step_device_ms", [])
    per = {k: 1e3 * stats[f"{k}_s"] / n for k in ("read", "normalize", "zenith")}
    return (f"host ms a batch: read {per['read']:.1f}, normalize {per['normalize']:.1f}, zenith {per['zenith']:.1f}, sample fetch in all "
            f"{1e3 * stats['fetch_s'] / n:.1f}, staging into pinned memory {1e3 * stats['stage_s'] / n:.1f}; host-to-device copy {stats['copy_ms'] / n:.2f} "
            f"ms a batch (device); device ms a step {[round(v, 2) for v in steps]}; epoch wall {stats['wall_s']:.3f} s, device idle share "
            f"{stats.get('idle_share', float('nan')):.3f}")


def train_line(tag, logs, stats, card) -> str:
    return (f"{tag}: step_time_ms {logs['step_time_ms']:.2f}, train_samples_per_sec {logs['train_samples_per_sec']:.4f}, effective_io_rate_gbs "
            f"{logs['effective_io_rate_gbs']:.4f}, train_loss {logs['train_loss']:.6f}, valid_loss {logs['valid_loss']:.6f}; {host_line(stats)}  [{card}]")


def expected_driver_launches(n_steps, n_lead, per_step, keys) -> dict:
    """An epoch's launches: the recipe step's n_steps times (the forward's,
    the backward's, K16's and K17's) and the forecast step's n_lead times."""
    return {k: n_steps * (TRAIN_EXPECTED_PER_STEP.get(k, 0) + per_step.get(k, 0)) + n_lead * EXPECTED_PER_STEP.get(k, 0) for k in keys}


def check_first_step(dev, trainer) -> None:
    """Phase 27: the trainer's first step against chip_smoke's own
    ``train_step`` from the same seeded weights on the same sample (the
    first of epoch 1's order), bit for bit, and against the plain path's
    loss (MODEL_BF16_REL_L2)."""
    import copy

    from makani_torch import kernels
    from makani_torch.models.model_registry import get_model
    from makani_torch.utils.dataloader import BatchIterator, _assemble
    from makani_torch.utils.loss import LossHandler
    from makani_torch.utils.training.deterministic_trainer import train_step
    from makani_torch.utils.training.optimizer import get_optimizer

    params = trainer.params
    seed = params.get("seed", 333)
    order = BatchIterator(trainer.train_dataset, params.batch_size, seed=seed)
    order.set_epoch(1)
    batch = _assemble([trainer.train_dataset[int(i)] for i in order.index_batches()[0]])
    inp, tar, zen = (torch.from_numpy(batch[k]).to(dev) for k in ("inp", "tar", "zen"))
    model, _ = get_model(copy.deepcopy(params), multistep=True, device=dev, seed=seed)
    plain = copy.deepcopy(model)
    opt = get_optimizer(params, model, len(trainer.train_loader))
    loss_obj = LossHandler(params)
    loss = train_step(model, loss_obj, opt, inp, tar, zen)
    del model, opt
    torch.cuda.empty_cache()
    kernels.set_use_kernels(plain, False)
    with torch.no_grad():
        plain_loss = loss_obj(plain(inp, zen, train=True), tar, inp=inp, train=True).item()
    del plain
    torch.cuda.empty_cache()
    ref = trainer.step_losses[0]
    bit = torch.equal(loss, ref)
    rel = abs(loss.item() - plain_loss) / abs(plain_loss)
    print(f"phase 27: the trainer's step 1 loss {ref.item():.7f}, chip_smoke's train_step on the same sample and weights {loss.item():.7f} "
          f"({'bit-equal' if bit else 'NOT bit-equal'}), the plain path {plain_loss:.7f} (rel {rel:.2e}, tol {MODEL_BF16_REL_L2})", flush=True)
    if not bit or rel > MODEL_BF16_REL_L2:
        raise RuntimeError("the trainer's first step is not train_step's, or the kernel path's loss parts from the plain path's")


def leaf_diff(params_a, params_b) -> tuple:
    """(bit-equal, largest max|a - b| / max|b| over the leaves)."""
    worst = 0.0
    bit = True
    for a, b in zip(params_a, params_b):
        bit &= torch.equal(a, b)
        worst = max(worst, ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item())
    return bit, worst


def step0_rmse_from_wrapper(dev, inf) -> tuple:
    """The step-0 RMSE (channel mean) of the first initial condition through
    ``ModelWrapper`` in physical units: the state read from the validation
    file, normalized, stepped and denormalized by the wrapper, then
    normalized again and scored against the normalized target."""
    from makani_torch.models.model_package import ModelWrapper
    from makani_torch.utils.metrics.functions import weighted_rmse

    ds = inf.valid_dataset
    sample = ds[0]
    x = torch.from_numpy(ds._datasets[0].memmap()[0:1].copy()).to(dev)
    zen = torch.from_numpy(sample["izen"][None]).to(dev)
    wrapper = ModelWrapper(inf.model, bias=ds.in_bias, scale=ds.in_scale, out_bias=ds.out_bias, out_scale=ds.out_scale)
    out_bias, out_scale = (torch.from_numpy(a).to(dev) for a in (ds.out_bias, ds.out_scale))
    pred = (wrapper(x, zen).float() - out_bias) / out_scale
    tar = torch.from_numpy(sample["tar"][:1]).to(dev)
    return weighted_rmse(pred, tar, inf.metrics.quadrature).mean().item()


def lead_step_breakdown(dev, card, inf) -> dict:
    """Device ms of one warm lead step's parts on the first initial
    condition: the forecast step, the metrics' update, each buffer's update
    (fresh buffers, the Inferencer's transform) and the raw forecast's copy
    into page-locked memory."""
    from makani_torch.utils.dataloader import _assemble
    from makani_torch.utils.inference.rollout_buffer import SpectrumAverageBuffer, TemporalAverageBuffer, ZonalSpectrumAverageBuffer
    from makani_torch.utils.metric import MetricsHandler

    params = inf.params
    S, C = DRIVER_AUTOREG + 1, inf.n_out
    H, W = params.img_shape_x, params.img_shape_y
    batch = _assemble([inf.valid_dataset[0]])
    inp, tar, zen = (torch.from_numpy(batch[k]).to(dev) for k in ("inp", "tar", "zen"))
    tstep = tar[:, :C]
    metrics = MetricsHandler(params, climatology=inf.metrics.climatology)
    temporal, bias = TemporalAverageBuffer(S, C, (H, W)), TemporalAverageBuffer(S, C, (H, W))
    spectrum = SpectrumAverageBuffer((H, W), S, C, params.get("model_grid_type", "equiangular"), device=dev, sht=inf._sht)
    zonal = ZonalSpectrumAverageBuffer((H, W), S, C)
    host = torch.empty((1, C, H, W), dtype=torch.float32, pin_memory=dev.type == "cuda")
    with torch.no_grad():
        pred = inf.model(inp, zen[:, :1], train=False)
        parts = {
            "forecast step": lambda: inf.model(inp, zen[:, :1], train=False),
            "metrics": lambda: metrics.update(pred, tstep, 0),
            "temporal mean/std": lambda: temporal.update(pred, 0),
            "bias mean/std": lambda: bias.update(pred - tstep, 0),
            "SH spectra (K1)": lambda: spectrum.update(pred, 0, tar=tstep),
            "zonal spectra": lambda: zonal.update(pred, 0, tar=tstep),
            "raw forecast copy": lambda: host.copy_(pred, non_blocking=True),
        }
        ms = {k: time_ms(fn, 3, 1) for k, fn in parts.items()}
    total = sum(ms.values())
    buffers = total - ms["forecast step"]
    print("phase 29: one lead step's device ms, apart: " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()) +
          f"; in all {total:.2f} ms, the metrics and buffers {buffers:.2f} ms ({buffers / total:.1%})  [{card}]", flush=True)
    return dict(ms, total=total, buffers=buffers)


def driver_phases(dev, card):
    """Phases 25-29; returns (the K1 result at the spectrum's shape, its
    launches in the inference run, counted inside ``SpectrumAverageBuffer``)."""
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_drivers_", dir=os.path.join(REPO, "build"))
    try:
        return _driver_phases(dev, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()  # the trainers' sync-check cycles (ensemble_driver_phases)
        torch.cuda.empty_cache()


def _driver_phases(dev, card, root):
    from makani_torch import inference, kernels, train
    from makani_torch.utils import hdf5
    from makani_torch.utils.checkpoint_helpers import get_latest_checkpoint_version
    from makani_torch.utils.inference.rollout_buffer import SpectrumAverageBuffer

    t0 = time.perf_counter()
    yaml_path, overrides = driver_files(root, dev)
    print(f"phase 25 {time.perf_counter() - t0:.1f} s", flush=True)
    argv = ["--yaml_config", yaml_path, "--config", DRIVER_NAME, "--run_num", "0", "--batch_size", str(RECIPE_BATCH)]
    n_lead = DRIVER_AUTOREG + 1

    # ---- phase 26: one epoch through train.py
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    first = train.main(argv + ["--max_epochs", "1"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    per_step = optimizer_launches(first.optimizer)
    n_steps = len(first.step_losses)
    expected = expected_driver_launches(n_steps, n_lead, per_step, launches)
    peak = torch.cuda.max_memory_allocated()
    ck = first.checkpoint
    print(f"phase 26: python -m makani_torch.train {' '.join(argv[4:])} --max_epochs 1: {wall:.1f} s ({first.n_model_params} parameters, {n_steps} steps, "
          f"a validation rollout of {n_lead} steps, checkpoint ckpt_v1); launches {launches} (expected {expected}); peak memory {peak / 2**30:.2f} GiB; "
          f"checkpoint written {ck.bytes_written / 1e9:.3f} GB in {ck.seconds_written:.2f} s ({ck.bytes_written / 1e9 / ck.seconds_written:.3f} GB/s)  [{card}]",
          flush=True)
    print(train_line("phase 26 epoch 1 (cold)", first.logs[-1], first.host_stats, card), flush=True)
    if launches != expected:
        raise RuntimeError(f"train.py epoch launches {launches} != expected {expected}")
    if n_steps != DRIVER_STATES - 1 or not all(math.isfinite(v) for v in first.logs[-1].values() if isinstance(v, float)):
        raise RuntimeError(f"train.py epoch: {n_steps} steps, logs {first.logs[-1]}")
    epoch1 = [p.detach().clone() for p in first.model.parameters()]

    t0 = time.perf_counter()
    check_first_step(dev, first)
    print(f"phase 27 {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 28: the resumed run against the first trainer carried on in memory
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    resumed = train.main(argv + ["--max_epochs", "2"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    ck = resumed.checkpoint
    print(f"phase 28: python -m makani_torch.train ... --max_epochs 2 (resuming from ckpt_v{get_latest_checkpoint_version(ck.checkpoint_dir) - 1}): "
          f"{wall:.1f} s; launches {launches}; checkpoint read {ck.bytes_read / 1e9:.3f} GB in {ck.seconds_read:.2f} s "
          f"({ck.bytes_read / 1e9 / ck.seconds_read:.3f} GB/s), written {ck.bytes_written / 1e9:.3f} GB in {ck.seconds_written:.2f} s "
          f"({ck.bytes_written / 1e9 / ck.seconds_written:.3f} GB/s)  [{card}]", flush=True)
    print(train_line("phase 28 epoch 2 (resumed run)", resumed.logs[-1], resumed.host_stats, card), flush=True)
    if not resumed.params["resuming"] or resumed.epoch != 2 or len(resumed.logs) != 1 or launches != expected:
        raise RuntimeError(f"train.py did not resume for one epoch: resuming {resumed.params['resuming']}, epoch {resumed.epoch}, launches {launches}")
    res_losses = [v.item() for v in resumed.step_losses]
    res_lr = resumed.optimizer.last_lr
    res_valid = resumed.logs[-1]["valid_loss"]
    res_params = [p.detach().clone() for p in resumed.model.parameters()]
    del resumed
    torch.cuda.empty_cache()

    syncs: list = []
    checking_syncs(first, "_train_steps", syncs)
    checking_syncs(first, "_validation_rollouts", syncs)
    first.epoch = 2
    first.train_batches.set_epoch(2)
    logs2 = first.train_one_epoch()
    logs2.update(first.validate_one_epoch())
    losses = [v.item() for v in first.step_losses]
    print(train_line("phase 28 epoch 2 (the first trainer, in memory, warm)", logs2, first.host_stats, card), flush=True)
    bit_params, worst = leaf_diff(res_params, [p.detach() for p in first.model.parameters()])
    rel = max(abs(a - b) / abs(b) for a, b in zip(res_losses, losses))
    print(f"phase 28: epoch 2 losses, resumed {res_losses} vs uninterrupted {losses} ({'bit-equal' if res_losses == losses else 'NOT bit-equal'}, "
          f"max rel {rel:.2e}, tol 1e-6); parameters {'bit-equal' if bit_params else 'NOT bit-equal'} (max|d|/max|p| {worst:.2e}); learning rate "
          f"{res_lr:.9e} vs {first.optimizer.last_lr:.9e}; valid_loss {res_valid:.7f} vs {logs2['valid_loss']:.7f}; syncs in the step and rollout "
          f"loops {len(syncs)}", flush=True)
    if rel > 1e-6 or worst > 1e-6 or res_lr != first.optimizer.last_lr or abs(res_valid - logs2["valid_loss"]) > 1e-6 * abs(logs2["valid_loss"]):
        raise RuntimeError("the resumed epoch differs from the uninterrupted one")
    if syncs:
        raise RuntimeError(f"the training loops waited for the card: {syncs[:5]}")
    del first
    torch.cuda.empty_cache()

    # ---- phase 29: inference.py from the run's best checkpoint
    out = os.path.join(root, "scores")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    spectrum_launches = {"sht_analysis": 0}
    undo = counting_launches(SpectrumAverageBuffer, "update", "sht_analysis", kernels.LAUNCHES, spectrum_launches)
    t0 = time.perf_counter()
    try:
        inf = inference.main(argv + ["--save_raw_forecasts", "--output_dir", out])
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # the forecast's launches and, for K1, the spectrum buffer's as counted
    expected = {k: n_lead * EXPECTED_PER_STEP.get(k, 0) + spectrum_launches.get(k, 0) for k in launches}
    # the best version is epoch 1's or the resumed run's epoch 2
    version = inf.checkpoint.best_version()
    bit, _ = leaf_diff([p.detach() for p in inf.model.parameters()], {1: epoch1, 2: res_params}[version])
    del epoch1, res_params
    ck, tm = inf.checkpoint, inf.timings
    logs = inf.logs
    print(f"phase 29: python -m makani_torch.inference ... --save_raw_forecasts: {wall:.1f} s; restored ckpt_v{version} "
          f"({'bit-equal to' if bit else 'NOT equal to'} the trained weights), read {ck.bytes_read / 1e9:.3f} GB in {ck.seconds_read:.2f} s "
          f"({ck.bytes_read / 1e9 / ck.seconds_read:.3f} GB/s); the spectrum's transform ({inf._sht.nlat}x{inf._sht.nlon} -> lmax {inf._sht.lmax}, mmax "
          f"{inf._sht.mmax}) built in {tm['spectrum_table_s']:.1f} s; "
          f"{tm['lead_steps']} lead steps in {tm['rollout_s']:.3f} s ({1e3 * tm['rollout_s'] / tm['lead_steps']:.1f} ms a lead step, wall, cold); "
          f"outputs written in {tm['finalize_s']:.1f} s; launches {launches} (expected {expected}: K1 {spectrum_launches['sht_analysis']} in the "
          f"spectrum buffer, 2 a lead step wanted); peak memory {peak / 2**30:.2f} GiB; rmse {logs['rmse']:.6f} "
          f"acc {logs['acc']:.6f} l1 {logs['l1']:.6f} rmse_rollout_last {logs['rmse_rollout_last']:.6f}  [{card}]", flush=True)
    if not bit or launches != expected or spectrum_launches["sht_analysis"] != 2 * n_lead:
        raise RuntimeError("inference did not score the trained weights, or its launches are not the forecast's and the spectrum's")
    rmse0 = step0_rmse_from_wrapper(dev, inf)
    rel = abs(rmse0 - logs["rmse_rollout/0"]) / logs["rmse_rollout/0"]
    print(f"phase 29: step-0 rmse {logs['rmse_rollout/0']:.7f}, ModelWrapper's on the same initial condition {rmse0:.7f} (rel {rel:.2e}, tol 1e-6)", flush=True)
    if rel > 1e-6:
        raise RuntimeError("the Inferencer's step-0 rmse is not ModelWrapper's")
    C, H, W = inf.n_out, inf.params.img_shape_x, inf.params.img_shape_y
    want = {
        "metrics.h5": {"rmse": (n_lead, C), "acc": (n_lead, C), "l1": (n_lead, C), "channel": (C,)},
        "temporal_averages.h5": {k: (n_lead, C, H, W) for k in ("mean", "std", "bias_mean", "bias_std")},
        "spectra.h5": {"sh_spectrum": (n_lead, C, H), "sh_spectrum_target": (n_lead, C, H), "zonal_spectrum": (n_lead, C, W // 2 + 1),
                       "zonal_spectrum_target": (n_lead, C, W // 2 + 1)},
        "raw_forecasts.h5": {"fields": (1, n_lead, C, H, W), "channel": (C,)},
    }
    got = {name: {k: hdf5.File(os.path.join(out, name))[k].shape for k in hdf5.File(os.path.join(out, name)).keys()} for name in want}
    finite = all(np.isfinite(hdf5.File(os.path.join(out, n))[k][...]).all() for n in want for k in want[n] if k != "channel")
    print(f"phase 29: output files {got} ({'as' if got == want else 'NOT as'} the JAX package's; {'all finite' if finite else 'NOT finite'})", flush=True)
    if got != want or not finite:
        raise RuntimeError(f"inference outputs {got} != {want} or not finite")

    # warm, with its lead-step loop checked for syncs
    syncs = []
    checking_syncs(inf, "_score", syncs)
    out2 = os.path.join(root, "scores_warm")
    logs2 = inf.score_model(out2)
    shutil.rmtree(out2, ignore_errors=True)
    rel = max(abs(logs2[k] - v) / max(abs(v), 1.0) for k, v in logs.items())
    print(f"phase 29: a second scoring (warm): {1e3 * tm['rollout_s'] / tm['lead_steps']:.1f} ms a lead step, wall (its initial condition's read "
          f"{1e3 * tm['loader']['fetch_s']:.1f} ms, staging {1e3 * tm['loader']['stage_s']:.1f} ms, copy {tm['loader']['copy_ms']:.2f} ms); outputs in "
          f"{tm['finalize_s']:.1f} s; logs {'equal to' if logs2 == logs else f'within {rel:.1e} of'} the first's; syncs in the lead-step loop that "
          f"the sync debug mode sees {len(syncs)}; event waits of the raw-forecast buffer {inf.rollout_buffer.waits} (one a batch of initial "
          f"conditions, at its last lead step, where the JAX package reads too; the debug mode does not see event waits)  [{card}]", flush=True)
    if syncs or inf.rollout_buffer.waits != tm["lead_steps"] // n_lead or sorted(logs2) != sorted(logs) or rel > 1e-6:
        raise RuntimeError(f"the inference loop waited for the card, or a second scoring differs: syncs {syncs[:5]}, event waits {inf.rollout_buffer.waits}")
    lead_step_breakdown(dev, card, inf)

    # K1 at the spectrum's shape
    x = randn((1, H, inf._sht.mmax, C, 2), torch.float32, torch.Generator(dev).manual_seed(SEED + 31), dev)
    table = inf._sht.weights(dev)
    from makani_torch.ops import sht

    kres = run_cases([("sht_analysis", "spectrum", torch.float32, lambda: sht.analysis_contract_cl_s(x, table),
                       lambda: sht.analysis_contract_cl_s_plain(x, table), legendre_extras(x, table, 0, 1))], card, {}, iters=5, warmup=1)
    del inf, x, table
    torch.cuda.empty_cache()
    return kres, spectrum_launches


# ---------------------------------------------------------------------------
# The ensemble driver: ensemble.py and inference.py at E > 1 on the FCN3
# recipe (phases 30-33), with the native reader

# 0.5-degree year files of 4 states: 3 training steps (B = 1, E = 4) and one
# validation rollout of ENS_AUTOREG + 1 lead steps; the mask file holds
# ENS_MASKS six-hourly masks, the climatology file ENS_CLIM_STATES six-hourly
# states without timestamps
ENS_STATES = 4
ENS_AUTOREG = 2
ENS_MASKS = 2
ENS_CLIM_STATES = 4
ENS_NAME = "fcn3_ensemble_driver"


def ensemble_files(root: str, dev) -> tuple:
    """Phase 30: ``seeded_run_files`` for the FCN3 recipe under the cuts of
    ``fcn3_train_config`` (361x720, E = 4 of B = 1, ``n_future`` 0,
    ``checkpointing_level`` 3), its entry equal to that config beyond the
    paths, the cuts, ``valid_autoreg_steps`` and ``max_epochs``; and a mask
    file and a climatology file in raw units. Returns (yaml path, mask
    path, climatology path)."""
    from makani_torch.utils import hdf5

    ref = fcn3_train_config()
    names = ref["channel_names"]
    C, H, W = len(names), ref["img_shape_x"], ref["img_shape_y"]
    cuts = dict(ensemble_size=FCN3_TRAIN_ENSEMBLE, batch_size=FCN3_TRAIN_BATCH, n_future=0, checkpointing_level=3, valid_autoreg_steps=ENS_AUTOREG, max_epochs=1)
    path, overrides, nbytes, _, (bias, scale) = seeded_run_files(root, dev, FCN3_CONFIG, ENS_NAME, (H, W), ENS_STATES, cuts, ref,
                                                                 ignore=("img_shape_x", "img_shape_y", "in_channels", "out_channels"))
    gen = torch.Generator(dev).manual_seed(SEED + 32)
    t0 = np.datetime64(f"{DRIVER_YEARS['valid']}-01-01T00:00:00").astype("datetime64[s]").astype(np.int64)
    mask_path, clim_path = os.path.join(root, "mask.h5"), os.path.join(root, "climatology.h5")
    maps = hdf5.File.create(mask_path, {"fields": ((ENS_MASKS, C, H, W), np.float32), "timestamp": ((ENS_MASKS,), np.int64)})
    maps["timestamp"][:] = t0 + np.arange(ENS_MASKS) * 6 * 3600
    for t in range(ENS_MASKS):
        u = torch.rand((2, C, H, W), generator=gen, device=dev)
        maps["fields"][t] = ((u[0] > 0.3) * (0.5 + 0.5 * u[1])).cpu().numpy()
    clim = hdf5.File.create(clim_path, {"fields": ((ENS_CLIM_STATES, C, H, W), np.float32)})
    for t in range(ENS_CLIM_STATES):
        clim["fields"][t] = (bias[0] + 0.1 * scale[0] * torch.randn((C, H, W), generator=gen, device=dev)).cpu().numpy()
    for m in (*maps.values(), *clim.values()):
        m.flush()
        nbytes += m.nbytes
    del maps, clim
    print(f"phase 30: wrote {nbytes / 1e9:.2f} GB of seeded files ({len(DRIVER_YEARS)} year files of {ENS_STATES} states of {C}x{H}x{W} fp32, time "
          f"means, data.json, a mask file of {ENS_MASKS} six-hourly masks, a climatology file of {ENS_CLIM_STATES} states) under "
          f"{os.path.relpath(root, REPO)}; {ENS_NAME} = {FCN3_CONFIG[1]} under fcn3_train_config's cuts, but for {sorted(overrides)}", flush=True)
    return path, mask_path, clim_path


def ens_step_launches(trainer) -> dict:
    """One training step's launches at phase 20's configuration: the FCN3
    step's, K5's for the fused convs' weight gradients and the optimizer's."""
    per = dict(FCN3_TRAIN_EXPECTED_PER_STEP)
    for k, v in optimizer_launches(trainer.optimizer).items():
        per[k] = per.get(k, 0) + v
    per["disco_band"] += fcn3_wgrad_launches(trainer.model.model, FCN3_TRAIN_BATCH * FCN3_TRAIN_ENSEMBLE)
    return per


def ens_epoch_launches(per_step: dict, n_steps: int, n_rollouts: int, n_lead: int, keys, scored_loss: bool = True) -> dict:
    """An ensemble epoch's launches: ``n_steps`` training steps, each batch's
    noise drawn for one state (K2 once), and ``n_rollouts`` rollouts of
    ``n_lead`` forecast steps, each drawing its noise series of ``n_lead``
    states (K2 once a state) and, in validation (``scored_loss``), taking
    the CRPS loss at every lead step (K15's forward)."""
    fwd = dict(FCN3_EXPECTED_PER_STEP, sht_synthesis=FCN3_EXPECTED_PER_STEP["sht_synthesis"] - 1, crps=1 if scored_loss else 0)
    out = {k: n_steps * per_step.get(k, 0) + n_rollouts * n_lead * fwd.get(k, 0) for k in keys}
    out["sht_synthesis"] += n_steps + n_rollouts * n_lead
    return out


def check_first_ens_step(dev, trainer) -> None:
    """Phase 31: the trainer's first step against chip_smoke's own
    ``ensemble_train_step`` from the same seeded weights, on the same sample
    (the first of epoch 1's order) and the same noise (a generator seeded
    with ``seed + 1``), bit for bit."""
    import copy

    from makani_torch.models.model_registry import get_model
    from makani_torch.models.noise import build_noise
    from makani_torch.utils.dataloader import BatchIterator, _assemble
    from makani_torch.utils.loss import LossHandler
    from makani_torch.utils.training.ensemble_trainer import ensemble_train_step, prepare_ensemble_batch
    from makani_torch.utils.training.optimizer import get_optimizer

    params = trainer.params
    seed = params.get("seed", 333)
    order = BatchIterator(trainer.train_dataset, params.batch_size, seed=seed)
    order.set_epoch(1)
    batch = _assemble([trainer.train_dataset[int(i)] for i in order.index_batches()[0]])
    inp, tar, zen = (torch.from_numpy(batch[k]).to(dev) for k in ("inp", "tar", "zen"))
    model, _ = get_model(copy.deepcopy(params), multistep=True, device=dev, seed=seed)
    opt = get_optimizer(params, model, len(trainer.train_loader))
    noise = build_noise(dict(params.input_noise, grid_type=params.get("model_grid_type", "equiangular")), (params.img_shape_x, params.img_shape_y))
    E = params.ensemble_size
    x, t, u = prepare_ensemble_batch(noise, inp, tar, zen, E, 1, torch.Generator(dev).manual_seed(seed + 1), params.input_noise.get("centered", False))
    loss = ensemble_train_step(model, LossHandler(params), opt, x, t, u, E)
    del model, opt
    torch.cuda.empty_cache()
    ref = trainer.step_losses[0]
    bit = torch.equal(loss, ref)
    print(f"phase 31: the trainer's step 1 loss {ref.item():.7f}, chip_smoke's ensemble_train_step on the same sample, noise and weights "
          f"{loss.item():.7f} ({'bit-equal' if bit else 'NOT bit-equal'})", flush=True)
    if not bit:
        raise RuntimeError("the ensemble trainer's first step is not ensemble_train_step's")


def ens_train_line(tag, logs, stats, card, E) -> str:
    noise = stats.get("noise_device_ms", [])
    return (f"{tag}: step_time_ms {logs['step_time_ms']:.2f}, members/s {E * logs['train_samples_per_sec']:.4f} (train_samples_per_sec "
            f"{logs['train_samples_per_sec']:.4f}), effective_io_rate_gbs {logs['effective_io_rate_gbs']:.4f}, train_loss {logs['train_loss']:.6f}, "
            f"valid_loss {logs['valid_loss']:.6f}; noise draw device ms a batch {[round(v, 2) for v in noise]}; {host_line(stats)}  [{card}]")


def ens_lead_metrics(logs, n_lead) -> str:
    return "; ".join(f"lead {s}: crps {logs[f'crps_rollout/{s}']:.5f} spread {logs[f'spread_rollout/{s}']:.5f} ssr {logs[f'ssr_rollout/{s}']:.5f}"
                     for s in range(n_lead))


def ens_lead_step_breakdown(dev, card, inf) -> dict:
    """Phase 33: device ms of one warm E-member lead step's parts on the
    first initial condition: the forecast step of the folded members, the
    noise series' draw (a batch's, K2), the masked anomaly metrics, the
    ensemble mean, each buffer's update on the mean (fresh buffers, the
    Inferencer's transform) and the raw forecast's copy into page-locked
    memory."""
    from makani_torch.utils.dataloader import _assemble
    from makani_torch.utils.inference.rollout_buffer import SpectrumAverageBuffer, TemporalAverageBuffer, ZonalSpectrumAverageBuffer
    from makani_torch.utils.metric import MetricsHandler
    from makani_torch.utils.training.ensemble_trainer import expand_ensemble, fold_ensemble

    params = inf.params
    E, S, C = inf.ensemble_size, ENS_AUTOREG + 1, inf.n_out
    H, W = params.img_shape_x, params.img_shape_y
    batch = _assemble([inf.valid_dataset[0]])
    inp, tar, zen = (torch.from_numpy(batch[k]).to(dev) for k in ("inp", "tar", "zen"))
    inp, zen = expand_ensemble(inp, E), expand_ensemble(zen, E)
    unp = torch.cat([zen, inf.draw_noise(E, S).to(dev)], dim=2)[:, :1]
    tstep = tar[:, :C]
    masks, clims = inf._side_fields([0], S)
    mask, clim = masks[0], clims[0]
    metrics = MetricsHandler(params, climatology=None)
    temporal, bias = TemporalAverageBuffer(S, C, (H, W)), TemporalAverageBuffer(S, C, (H, W))
    spectrum = SpectrumAverageBuffer((H, W), S, C, params.get("model_grid_type", "equiangular"), device=dev, sht=inf._sht)
    zonal = ZonalSpectrumAverageBuffer((H, W), S, C)
    host = torch.empty((1, C, H, W), dtype=torch.float32, pin_memory=dev.type == "cuda")
    with torch.no_grad():
        pred_s = fold_ensemble(inf.model(inp, unp, train=False), E)
        pm = pred_s.mean(dim=1)
        parts = {
            f"forecast step ({E} members)": lambda: inf.model(inp, unp, train=False),
            f"noise series draw ({S} states, K2)": lambda: inf.draw_noise(E, S),
            "metrics (masked anomalies)": lambda: metrics.update(pred_s - clim[:, None], tstep - clim, 0, mask=mask),
            "ensemble mean": lambda: pred_s.mean(dim=1),
            "temporal mean/std": lambda: temporal.update(pm, 0),
            "bias mean/std": lambda: bias.update(pm - tstep, 0),
            "SH spectra (K1)": lambda: spectrum.update(pm, 0, tar=tstep),
            "zonal spectra": lambda: zonal.update(pm, 0, tar=tstep),
            "raw forecast copy": lambda: host.copy_(pm, non_blocking=True),
        }
        ms = {k: time_ms(fn, 3, 1) for k, fn in parts.items()}
    ms[f"noise series draw ({S} states, K2)"] /= S
    total = sum(ms.values())
    fc = ms[f"forecast step ({E} members)"]
    print("phase 33: one E-member lead step's device ms, apart (the noise draw a lead step's share): " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()) +
          f"; in all {total:.2f} ms, all but the forecast {total - fc:.2f} ms ({(total - fc) / total:.1%})  [{card}]", flush=True)
    return dict(ms, total=total)


def native_against_memmap(params, locations) -> str:
    """Phase 33: every sample of ``locations`` read by the native reader
    (``MAKANI_NATIVE_READER=1``) and by the memory map, bit for bit; returns
    the reads' host ms a sample."""
    from makani_torch.utils.dataloaders.data_loader_multifiles import MultifilesDataset

    out = []
    for loc in locations:
        for train in (True, False):
            os.environ["MAKANI_NATIVE_READER"] = "1"
            native = MultifilesDataset(params, loc, train=train)
            os.environ["MAKANI_NATIVE_READER"] = "0"
            plain = MultifilesDataset(params, loc, train=train)
            for i in range(len(plain)):
                a, b = plain[i], native[i]
                if sorted(a) != sorted(b) or not all(np.array_equal(a[k], b[k]) for k in a):
                    raise RuntimeError(f"the native reader's sample {i} of {loc} differs from the memory map's")
            n = max(len(plain), 1)
            out.append(f"{os.path.basename(loc)} ({'train' if train else 'eval'} windows, {len(plain)} samples): read ms a sample native "
                       f"{1e3 * native.timings['read'] / n:.1f}, memory map {1e3 * plain.timings['read'] / n:.1f}")
    os.environ["MAKANI_NATIVE_READER"] = "1"
    return "; ".join(out)


def ensemble_driver_phases(dev, card):
    """Phases 30-33."""
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_ensemble_", dir=os.path.join(REPO, "build"))
    before = os.environ.get("MAKANI_NATIVE_READER")
    os.environ["MAKANI_NATIVE_READER"] = "1"
    try:
        _ensemble_driver_phases(dev, card, root)
    finally:
        if before is None:
            os.environ.pop("MAKANI_NATIVE_READER", None)
        else:
            os.environ["MAKANI_NATIVE_READER"] = before
        shutil.rmtree(root, ignore_errors=True)
        # the sync checks' wrappers tie the trainers into reference cycles:
        # free their weights and optimizer state before the next phases
        gc.collect()
        torch.cuda.empty_cache()


def _ensemble_driver_phases(dev, card, root):
    from makani_torch import ensemble, inference, kernels
    from makani_torch.utils import hdf5
    from makani_torch.utils.checkpoint_helpers import get_latest_checkpoint_version
    from makani_torch.utils.inference.rollout_buffer import SpectrumAverageBuffer
    from makani_torch.utils.training import ensemble_trainer

    t0 = time.perf_counter()
    yaml_path, mask_path, clim_path = ensemble_files(root, dev)
    print(f"phase 30 {time.perf_counter() - t0:.1f} s", flush=True)
    E = FCN3_TRAIN_ENSEMBLE
    n_lead = ENS_AUTOREG + 1
    argv = ["--yaml_config", yaml_path, "--config", ENS_NAME, "--run_num", "0"]
    train_argv = argv + ["--ensemble_size", str(E)]

    # each training step's launches, counted inside ensemble_train_step
    steps: list = []
    step_fn = ensemble_trainer.ensemble_train_step

    def counted_step(*args, **kwargs):
        n0 = dict(kernels.LAUNCHES)
        try:
            return step_fn(*args, **kwargs)
        finally:
            steps.append({k: v - n0[k] for k, v in kernels.LAUNCHES.items() if v != n0[k]})

    ensemble_trainer.ensemble_train_step = counted_step
    try:
        # ---- phase 31: one epoch through ensemble.py
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        first = ensemble.main(train_argv + ["--max_epochs", "1"])
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        per_step = ens_step_launches(first)
        n_steps = len(first.step_losses)
        n_rollouts = len(first.valid_batches)
        expected = ens_epoch_launches(per_step, n_steps, n_rollouts, n_lead, launches)
        peak = torch.cuda.max_memory_allocated()
        ck = first.checkpoint
        logs = first.logs[-1]
        print(f"phase 31: python -m makani_torch.ensemble {' '.join(train_argv[4:])} --max_epochs 1 (MAKANI_NATIVE_READER=1): {wall:.1f} s "
              f"({first.n_model_params} parameters, {n_steps} steps of B={first.params.batch_size} E={first.ensemble_size}, {n_rollouts} validation "
              f"rollout(s) of {n_lead} steps, checkpoint ckpt_v1); launches {launches} (expected {expected}); peak memory {peak / 2**30:.2f} GiB; "
              f"checkpoint written {ck.bytes_written / 1e9:.3f} GB in {ck.seconds_written:.2f} s ({ck.bytes_written / 1e9 / ck.seconds_written:.3f} GB/s)  "
              f"[{card}]", flush=True)
        print(f"phase 31: launches a training step {steps} (phase 20's step at this configuration: {per_step}); K5 {per_step['disco_band']}, K12 "
              f"{per_step['disco_band_grad']}, K15 {per_step['crps']}, K16 {per_step['grad_norm']}, K17 {per_step['adam']}", flush=True)
        print(ens_train_line("phase 31 epoch 1 (cold)", logs, first.host_stats, card, E), flush=True)
        print(f"phase 31: validation, every lead step: {ens_lead_metrics(logs, n_lead)}", flush=True)
        if not all(st == {k: v for k, v in per_step.items() if v} for st in steps) or launches != expected:
            raise RuntimeError(f"ensemble.py launches {launches} != expected {expected}, or a step's {steps} != phase 20's {per_step}")
        if n_steps != ENS_STATES - 1 or not (first.train_dataset.native and first.valid_dataset.native) or not all(math.isfinite(v) for v in logs.values() if isinstance(v, float)):
            raise RuntimeError(f"ensemble.py epoch: {n_steps} steps, native reader {first.train_dataset.native}, logs {logs}")
        epoch1 = [p.detach().clone() for p in first.model.parameters()]
        t0 = time.perf_counter()
        check_first_ens_step(dev, first)
        print(f"phase 31 (first-step check) {time.perf_counter() - t0:.1f} s", flush=True)

        # ---- phase 32: the resumed run against the first trainer carried on
        # in memory, its noise stream restarted at seed + 1 as a resumed run's
        kernels.reset_launch_counts()
        steps.clear()
        t0 = time.perf_counter()
        resumed = ensemble.main(train_argv + ["--max_epochs", "2"])
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        ck = resumed.checkpoint
        print(f"phase 32: python -m makani_torch.ensemble ... --max_epochs 2 (resuming from ckpt_v{get_latest_checkpoint_version(ck.checkpoint_dir) - 1}): "
              f"{wall:.1f} s; launches {'as epoch 1' if launches == expected else launches}; checkpoint read {ck.bytes_read / 1e9:.3f} GB in "
              f"{ck.seconds_read:.2f} s ({ck.bytes_read / 1e9 / ck.seconds_read:.3f} GB/s)  [{card}]", flush=True)
        print(ens_train_line("phase 32 epoch 2 (resumed run)", resumed.logs[-1], resumed.host_stats, card, E), flush=True)
        if not resumed.params["resuming"] or resumed.epoch != 2 or len(resumed.logs) != 1 or launches != expected:
            raise RuntimeError(f"ensemble.py did not resume for one epoch: resuming {resumed.params['resuming']}, epoch {resumed.epoch}, launches {launches}")
        res_losses = [v.item() for v in resumed.step_losses]
        res_lr = resumed.optimizer.last_lr
        res_valid = resumed.logs[-1]["valid_loss"]
        res_params = [p.detach().clone() for p in resumed.model.parameters()]
        del resumed
        torch.cuda.empty_cache()

        syncs: list = []
        checking_syncs(first, "_train_steps", syncs)
        checking_syncs(first, "_validation_rollouts", syncs)
        first.generator.manual_seed(first.params.get("seed", 333) + 1)
        first.epoch = 2
        first.train_batches.set_epoch(2)
        logs2 = first.train_one_epoch()
        logs2.update(first.validate_one_epoch())
    finally:
        ensemble_trainer.ensemble_train_step = step_fn
    losses = [v.item() for v in first.step_losses]
    print(ens_train_line("phase 32 epoch 2 (the first trainer, in memory, warm)", logs2, first.host_stats, card, E), flush=True)
    bit_params, worst = leaf_diff(res_params, [p.detach() for p in first.model.parameters()])
    print(f"phase 32: epoch 2 losses, resumed {res_losses} vs carried on {losses} ({'bit-equal' if res_losses == losses else 'NOT bit-equal'}); "
          f"parameters {'bit-equal' if bit_params else 'NOT bit-equal'} (max|d|/max|p| {worst:.2e}); learning rate {res_lr:.9e} vs "
          f"{first.optimizer.last_lr:.9e}; valid_loss {res_valid:.7f} vs {logs2['valid_loss']:.7f}; syncs in the step and rollout loops {len(syncs)} "
          f"{syncs[:3]}", flush=True)
    if res_losses != losses or not bit_params or res_lr != first.optimizer.last_lr or res_valid != logs2["valid_loss"]:
        raise RuntimeError("the resumed ensemble epoch is not the carried-on one")
    if syncs:
        raise RuntimeError(f"the ensemble training loops waited for the card: {syncs[:5]}")
    del first
    torch.cuda.empty_cache()

    # ---- phase 33: inference.py at E > 1, masks and a per-date climatology
    out = os.path.join(root, "scores")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    spectrum_launches = {"sht_analysis": 0}
    undo = counting_launches(SpectrumAverageBuffer, "update", "sht_analysis", kernels.LAUNCHES, spectrum_launches)
    t0 = time.perf_counter()
    try:
        inf = inference.main(argv + ["--save_raw_forecasts", "--output_dir", out, "--mask_file", mask_path, "--climatology_file", clim_path])
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_ics = len(inf.valid_dataset)
    expected = ens_epoch_launches({}, 0, n_ics, n_lead, launches, scored_loss=False)
    expected["sht_analysis"] += spectrum_launches["sht_analysis"]
    version = inf.checkpoint.best_version()
    bit, _ = leaf_diff([p.detach() for p in inf.model.parameters()], {1: epoch1, 2: res_params}[version])
    del epoch1, res_params
    ck, tm, logs = inf.checkpoint, inf.timings, inf.logs
    print(f"phase 33: python -m makani_torch.inference ... --save_raw_forecasts --mask_file --climatology_file (E={inf.ensemble_size}): {wall:.1f} s; "
          f"restored ckpt_v{version} ({'bit-equal to' if bit else 'NOT equal to'} the trained weights), read {ck.bytes_read / 1e9:.3f} GB in "
          f"{ck.seconds_read:.2f} s; {tm['lead_steps']} lead steps in {tm['rollout_s']:.3f} s ({1e3 * tm['rollout_s'] / tm['lead_steps']:.1f} ms a lead "
          f"step, wall, cold); launches {launches} (expected {expected}: K1 {spectrum_launches['sht_analysis']} in the spectrum buffer); peak memory "
          f"{peak / 2**30:.2f} GiB; {ens_lead_metrics(logs, n_lead)}; rmse {logs['rmse']:.6f} acc {logs['acc']:.6f}  [{card}]", flush=True)
    if not bit or inf.ensemble_size != E or launches != expected or spectrum_launches["sht_analysis"] != 2 * n_lead * n_ics:
        raise RuntimeError("inference at E > 1 did not score the trained weights, or its launches are not the forecast's, the noise's and the spectrum's")
    if not all(math.isfinite(v) for v in logs.values()):
        raise RuntimeError(f"inference logs not finite: {logs}")
    C, H, W = inf.n_out, inf.params.img_shape_x, inf.params.img_shape_y
    want = {
        "metrics.h5": {**{m: (n_lead, C) for m in inf.metrics.metric_names}, "channel": (C,)},
        "temporal_averages.h5": {k: (n_lead, C, H, W) for k in ("mean", "std", "bias_mean", "bias_std")},
        "spectra.h5": {"sh_spectrum": (n_lead, C, H), "sh_spectrum_target": (n_lead, C, H), "zonal_spectrum": (n_lead, C, W // 2 + 1),
                       "zonal_spectrum_target": (n_lead, C, W // 2 + 1)},
        "raw_forecasts.h5": {"fields": (n_ics, n_lead, C, H, W), "channel": (C,)},
    }
    got = {name: {k: hdf5.File(os.path.join(out, name))[k].shape for k in hdf5.File(os.path.join(out, name)).keys()} for name in want}
    finite = all(np.isfinite(hdf5.File(os.path.join(out, n))[k][...]).all() for n in want for k in want[n] if k != "channel")
    print(f"phase 33: output files {got} ({'as' if got == want else 'NOT as'} wanted; {'all finite' if finite else 'NOT finite'})", flush=True)
    if got != want or not finite:
        raise RuntimeError(f"ensemble inference outputs {got} != {want} or not finite")
    ens_lead_step_breakdown(dev, card, inf)
    t0 = time.perf_counter()
    reads = native_against_memmap(inf.params, [inf.params.train_data_path, inf.params.valid_data_path])
    print(f"phase 33: the native reader's samples bit-equal to the memory map's, every sample of both files in training and evaluation windows "
          f"({time.perf_counter() - t0:.1f} s): {reads}  [{os.cpu_count()} CPUs]", flush=True)
    del inf
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# FCN3.1 (slice 6): both published forecasts and the recipe's training step

# the noise modules of the forecast paths, built once a configuration (the
# 721-degree synthesis table takes a while)
_NOISE: dict = {}


def forecast_noise(params):
    from makani_torch.models.noise import build_noise

    H, W = params.img_shape_x, params.img_shape_y
    key = (repr(sorted(params.input_noise.items())), params.model_grid_type, H, W)
    if key not in _NOISE:
        _NOISE[key] = build_noise(dict(params.input_noise, grid_type=params.model_grid_type), (H, W), num_time_steps=1)
    return _NOISE[key]


def fcn31_params(config, compute_dtype=None, num_layers=None):
    from makani_torch.utils.yparams import YParams

    params = YParams(os.path.join(REPO, config[0]), config[1])
    if compute_dtype is not None:
        params["compute_dtype"] = compute_dtype
    if num_layers is not None:
        params["num_layers"] = num_layers
    n_chan = len(params.channel_names)
    params["in_channels"] = list(range(n_chan))
    params["out_channels"] = list(range(n_chan))
    params["ensemble_size"] = FCN3_ENSEMBLE
    return params


def build_fcn31(dev, config, compute_dtype=None, num_layers=None):
    """An FCN3.1 forecast through get_model on seeded weights, ModelWrapper
    with seeded per-channel stats, a seeded initial window of T = n_history
    + 1 states and the configured noise (``num_layers`` cuts the depth)."""
    from makani_torch.models.model_package import ModelWrapper
    from makani_torch.models.model_registry import get_model

    params = fcn31_params(config, compute_dtype, num_layers)
    n_chan = len(params.channel_names)
    model, _ = get_model(params, multistep=True, device=dev, seed=SEED)
    gen = torch.Generator(dev).manual_seed(SEED + 14)
    bias = randn((1, n_chan, 1, 1), torch.float32, gen, dev)
    scale = 0.5 + torch.rand((1, n_chan, 1, 1), generator=gen, device=dev)
    H, W = params.img_shape_x, params.img_shape_y
    T = params.get("n_history", 0) + 1
    x0 = bias.repeat(1, T, 1, 1) + scale.repeat(1, T, 1, 1) * randn((1, T * n_chan, H, W), torch.float32, gen, dev)
    return params, model, ModelWrapper(model, bias=bias, scale=scale), x0, forecast_noise(params)


def fcn31_convs(net) -> list:
    """(label, DiscoConv, input channels) of every DISCO conv of an FCN3.1,
    one local block standing for all."""
    local = next(getattr(net, f"block{i}") for i in range(net.num_layers) if hasattr(getattr(net, f"block{i}"), "local_conv"))
    return [("encoder", net.encoder.conv, net.n_in), ("aux-encoder", net.aux_encoder.conv, net.n_aux), ("processor", local.local_conv, local.local_conv.in_channels),
            ("decoder", net.decoder.conv, net.embed_dim)]


def print_fcn31_convs(net):
    from makani_torch.ops import disco_kernels

    for name, conv, n_in in fcn31_convs(net):
        op, g = conv.conv_op, conv.groups
        ig, og = conv.in_channels // g, conv.out_channels // g
        G, Gf, IG, OG = (ig, 1, 1, op.K) if not conv.fused else (g, g, ig, og)
        route, smem = disco_kernels.band_route(G, Gf, IG, OG, op.BL, op.WW, op.stride, op.out_shape[1] // op.phases)
        print(f"  DISCO {name}: {op.in_shape} -> {op.out_shape}, cutoff {op.theta_cutoff:.4f} rad, K {op.K}, BL {op.BL}, WW {op.WW}, stride a {op.stride}, "
              f"phases b {op.phases}, polar rows {len(op.polar_rows)}, weight {tuple(conv.weight.shape)} (groups {g}), "
              f"{'fused' if conv.fused else 'two-stage'}; K5 route {route}, {smem / 1024:.1f} KB a block", flush=True)


def polar_launches(conv, B: int) -> int:
    """K6's (or K13's) launches of one DISCO conv on B samples: a phase (of
    a fused conv), or a phase, group and run of polar rows
    (``DiscoConvS2.polar_chunks``) of a two-stage conv's responses."""
    op = conv.conv_op
    if not op.polar_rows:
        return 0
    if conv.fused:
        return op.phases
    return op.phases * conv.groups * len(op.polar_chunks(B, conv.in_channels // conv.groups))


def fcn31_launches_per_step(net, B: int, noise_draws: int = 0) -> dict:
    """Kernel launches of one FCN3.1 forward on B samples: every DISCO conv
    one K5 a group and phase of its responses (two-stage) or a phase
    (fused), and its K6 launches (``polar_launches``), one K8 a group of a
    two-stage conv; the decoder one K7; each global block one K1, K3 and K2;
    plus ``noise_draws`` noise syntheses (K2)."""
    out = dict.fromkeys(("disco_band", "disco_polar", "disco_mix", "resample", "sht_analysis", "dhconv", "sht_synthesis"), 0)
    convs = [net.encoder.conv, net.decoder.conv] + ([net.aux_encoder.conv] if net.n_aux > 0 else [])
    for i in range(net.num_layers):
        blk = getattr(net, f"block{i}")
        if hasattr(blk, "local_conv"):
            convs.append(blk.local_conv)
        else:
            for k in ("sht_analysis", "dhconv", "sht_synthesis"):
                out[k] += 1
    for conv in convs:
        out["disco_band"] += conv.conv_op.phases * (1 if conv.fused else conv.groups)
        out["disco_polar"] += polar_launches(conv, B)
        out["disco_mix"] += 0 if conv.fused else conv.groups
    out["resample"] += 1
    out["sht_synthesis"] += noise_draws
    return out


def check_fcn31_kernels(dev, card, net, noise, B, tag):
    """The FCN3.1 forecast's kernels at its shapes (B = the folded
    ensemble), against their plain versions: K5 (responses mode at the
    unified encoder, each group's at the history encoder, the processor and
    the decoder; fused at the aux encoder), K6 at the same convs, K8 at the
    two-stage convs (per group), K7 at the decoder, K1-K3 at the global
    blocks' internal grid. The plain versions of the full-resolution
    convs take seconds: each runs once (its comparison) and is timed once."""
    from makani_torch.models.common.contractions import _PermutedWeight, contract_dense_s, contract_dense_s_plain
    from makani_torch.ops import sht

    gen = torch.Generator(dev).manual_seed(SEED + 15)
    H, W = net.inp_shape
    results = {}
    for name, conv, n_in in fcn31_convs(net):
        op = conv.conv_op
        label = f"{tag}-{name}"
        g = conv.groups
        if name == "decoder":
            xo = randn((B, H, W, n_in), torch.float32, gen, dev)
        elif name == "processor":
            xo = randn((B, *op.in_shape, n_in), torch.float32, gen, dev)
        else:  # the encoders read a permuted view of the NCHW input
            xo = randn((B, n_in, H, W), torch.float32, gen, dev).permute(0, 2, 3, 1)
        if conv.fused:
            run_cases(fused_conv_cases(conv, xo, label, gen), card, results, 3, 1)
        else:
            ig = conv.in_channels // g
            xg = xo[..., :ig]  # one group's channels (the history encoder's groups are alike)
            run_cases([band_case(op, xg, op.band_filter(0, dev), 1, 1, op.K, label, library=name == "processor", padded=True)], card, results,
                      3, 1, plain_once=name != "processor")
            # K6 on the first run of polar rows (the whole of them but at the decoder)
            r0, r1 = op.polar_chunks(B, ig)[0]
            X = torch.view_as_real(torch.fft.rfft(op.polar_bands(xg, r0, r1), dim=-1))
            run_cases([polar_case(X, op.polar_table(0, dev)[r0:r1], "psi_first", label)], card, results, 3, 1)
            del X, xg
            torch.cuda.empty_cache()
            run_cases([mix_case(conv, B, card, label)], card, results, 3, 1)
        del xo
        torch.cuda.empty_cache()
    # the decoder's resampling (K7) of the embedding
    dec = net.decoder
    z = randn((B, net.h, net.w, net.embed_dim), torch.float32, gen, dev)
    run_cases([resample_case(dec.resample, z, f"{tag}-decoder")], card, results, 3, 1)
    del z
    torch.cuda.empty_cache()
    # the global blocks' K1, K3, K2 at the internal grid
    blk = net.block0.global_conv
    fwd, inv = blk.forward_transform, blk.inverse_transform
    C = blk.weight.shape[2]
    xf = randn((B, fwd.nlat, fwd.mmax, C, 2), torch.float32, gen, dev)
    wa = fwd.weights(dev)
    c2 = randn((B, inv.lmax, inv.mmax, C, 2), torch.float32, gen, dev)
    pa = inv.pct(dev)
    xs = randn((B, inv.lmax, inv.mmax, 1, C, 2), torch.float32, gen, dev)
    cache = _PermutedWeight()
    run_cases([
        ("sht_analysis", f"{tag}-internal", torch.float32, lambda: sht.analysis_contract_cl_s(xf, wa), lambda: sht.analysis_contract_cl_s_plain(xf, wa), legendre_extras(xf, wa, 0, B)),
        ("sht_synthesis", f"{tag}-internal", torch.float32, lambda: sht.synthesis_contract_cl_s(c2, pa), lambda: sht.synthesis_contract_cl_s_plain(c2, pa), legendre_extras(c2, pa, 1, B)),
        ("dhconv", f"{tag}-internal", torch.float32, lambda: contract_dense_s(xs, blk.weight, False, "dhconv", True, weight_cache=cache), lambda: contract_dense_s_plain(xs, blk.weight, False, "dhconv", True), dhconv_extras(xs, blk.weight.detach())),
    ], card, results, 3, 1)
    del xf, c2, xs
    torch.cuda.empty_cache()
    return results


def first_unpredicted(params, noise, members, dev, t0, seed):
    """The first step's zenith and noise channels of a window of T states,
    (members, T, 1 + C_noise, H, W), as ``rollout`` draws them."""
    from makani_torch.utils.zenith_angle import cos_zenith_angle_from_timestamp

    H, W = params.img_shape_x, params.img_shape_y
    T = params.get("n_history", 0) + 1
    lon2d, lat2d = np.meshgrid(360.0 * np.arange(W) / W, 90.0 - 180.0 * np.arange(H) / (H - 1))
    dt = params.dhours * 3600.0
    zen = np.stack([cos_zenith_angle_from_timestamp(t0 - (T - 1 - k) * dt, lon2d, lat2d) for k in range(T)]).astype(np.float32)
    gen = torch.Generator(dev).manual_seed(seed)
    state, fields = None, []
    for _ in range(T):
        state = noise.init_state(gen, members // 2) if state is None else noise.update(state, gen)
        eta = noise.sample(state)[:, 0]
        fields.append(torch.stack([eta, -eta], dim=1).reshape(members, *eta.shape[1:]))
    zt = torch.from_numpy(zen).to(dev)[None, :, None].expand(members, T, 1, H, W)
    return torch.cat([zt, torch.stack(fields, dim=1).to(dev)], dim=2)


def time_kernel_steps(step, card, label, members, steps=3):
    """Step latency of the kernel path (the plain path is compared, not
    timed: it takes tens of seconds a step at full width): one warm-up, then
    ``steps`` steps between CUDA events; members/s and peak memory."""
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        step()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    med = statistics.median(times)
    print(f"{label} step (kernel path): median {med:.2f} ms over {steps} steps {[round(t, 2) for t in times]}, {members / med * 1e3:.3f} members/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]", flush=True)
    return med


def fcn31_phases(dev, card, config, tag, num_layers=None):
    """One FCN3.1 forecast path (phases 34-37 for ``fcn31_sc2_edim256_layers10``,
    38-41 for its history variant, whose depth ``num_layers`` cuts); returns
    (kernel results, launch counts of the rollout)."""
    from makani_torch import kernels
    from makani_torch.models.model_package import rollout

    t0 = time.perf_counter()
    params, model, wrapper, x0, noise = build_fcn31(dev, config, num_layers=num_layers)
    net = model.model
    T = params.get("n_history", 0) + 1
    nparam = sum(p.numel() for p in model.parameters())
    print(f"built FCN3.1 {config[1]} of {config[0]} ({nparam} parameters, compute {params.compute_dtype}, {params.img_shape_x}x{params.img_shape_y} -> "
          f"internal {net.h}x{net.w}, lmax {net.lmax}, {net.num_layers} blocks, window of {T} states, {params.N_in_channels} in / {params.N_out_channels} out "
          f"channels, embed {net.embed_dim}, {params.filter_basis_type} basis ({params.filter_basis_norm_mode}), ensemble {FCN3_ENSEMBLE} centered) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print_fcn31_convs(net)

    t0 = time.perf_counter()
    kres = check_fcn31_kernels(dev, card, net, noise, FCN3_ENSEMBLE, tag)
    torch.cuda.empty_cache()
    print(f"{tag} kernel checks {time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated after them", flush=True)

    H, W = params.img_shape_x, params.img_shape_y
    lat = 90.0 - 180.0 * np.arange(H) / (H - 1)
    lon = 360.0 * np.arange(W) / W
    t_start = 1.5e9
    noise_seed = SEED + 98
    steps = max(STEPS, 3)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    frames = rollout(wrapper, x0, lat, lon, t_start, params.dhours, steps, noise=noise, ensemble_size=FCN3_ENSEMBLE, centered=True,
                     generator=torch.Generator(dev).manual_seed(noise_seed))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"{tag} rollout: {steps} steps of {FCN3_ENSEMBLE} members from a window of {T} states in {time.perf_counter() - t0:.1f} s  [{card}]")
    for i, f in enumerate(frames):
        if f.shape != (FCN3_ENSEMBLE, len(params.channel_names), H, W) or not bool(torch.isfinite(f).all()):
            raise RuntimeError(f"{tag} rollout step {i + 1}: shape {tuple(f.shape)} or non-finite values")
        spread = ((f[0] - f[1]) / wrapper.scale[0]).norm().item() / math.sqrt(f[0].numel())
        if not spread > 1e-6:
            raise RuntimeError(f"{tag} rollout step {i + 1}: the two members do not differ (rms normalized difference {spread})")
        print(f"{tag} rollout step {i + 1} (+{(i + 1) * params.dhours} h): shape {tuple(f.shape)}, finite, mean {f.mean().item():.4f}, "
              f"std {f.std().item():.4f}, member rms difference (normalized) {spread:.4f}")
    per_step = fcn31_launches_per_step(net, FCN3_ENSEMBLE)
    expected = {k: per_step.get(k, 0) * steps for k in kernels.LAUNCHES}
    expected["sht_synthesis"] += steps + T - 1  # the noise sequence's syntheses
    print(f"{tag} launches over {steps} steps: {launches} (per forward {per_step}, noise syntheses {steps + T - 1})")
    if launches != expected:
        raise RuntimeError(f"{tag} launch counts {launches} != expected {expected}")
    del frames
    torch.cuda.empty_cache()

    # the whole model once against its plain path, from the first step's input
    xm = x0.repeat_interleave(FCN3_ENSEMBLE, dim=0)
    unp = first_unpredicted(params, noise, FCN3_ENSEMBLE, dev, t_start, noise_seed)
    t0 = time.perf_counter()
    err = compare_paths(model, wrapper, xm, unp)
    ok = err["rel_l2"] <= MODEL_BF16_REL_L2
    print(f"{tag} step 1 ({params.compute_dtype}), kernel path vs plain path (normalized units): relL2 {err['rel_l2']:.3e} "
          f"(tol {MODEL_BF16_REL_L2}), max|d|/max|ref| {err['max_rel']:.3e} {'ok' if ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if not ok:
        raise RuntimeError(f"{tag} kernel path disagrees with the plain path: {err}")
    torch.cuda.empty_cache()
    time_kernel_steps(lambda: wrapper(xm, unp), card, f"{tag} ensemble forecast (E={FCN3_ENSEMBLE})", FCN3_ENSEMBLE)
    del model, wrapper
    torch.cuda.empty_cache()
    return kres, launches


def build_fcn31_train(dev, compute_dtype="bfloat16"):
    from makani_torch.models.model_registry import get_model
    from makani_torch.utils.loss import LossHandler
    from makani_torch.utils.yparams import ParamsBase

    cfg = fcn31_train_config(compute_dtype=compute_dtype)
    cfg.update(stats_files(len(cfg["channel_names"])))
    params = ParamsBase(dict(cfg))
    model, _ = get_model(params, multistep=True, device=dev, seed=SEED)
    return params, model, LossHandler(ParamsBase(dict(cfg)))


def fcn31_train_launches_per_step(net, members: int) -> dict:
    """Kernel launches of one FCN3.1 training step but the optimizer's:
    the forward's twice (checkpointing_level 3 recomputes all of it but the
    aux encoder, which the JAX package does not rematerialize either), the
    backward's K12 and K13 at every conv whose input needs a gradient (the
    local blocks and the decoder: the encoders read the data), K14 at the
    decoder, the global blocks' transposes, K15 forward and backward, and
    K5 for the fused convs' weight gradients (the aux encoder), one a chunk
    of its responses and phase."""
    fwd = fcn31_launches_per_step(net, members)
    out = {k: 2 * v for k, v in fwd.items()}
    n_global = fwd["dhconv"]
    convs = [getattr(net, f"block{i}").local_conv for i in range(net.num_layers) if hasattr(getattr(net, f"block{i}"), "local_conv")] + [net.decoder.conv]
    out["disco_band_grad"] = sum(c.conv_op.phases * (1 if c.fused else c.groups) for c in convs)
    out["disco_polar_grad"] = sum(polar_launches(c, members) for c in convs)
    out.update(resample_grad=1, crps=2, sht_analysis_grad=n_global, sht_synthesis_grad=n_global, dhconv_grad_input=n_global, dhconv_grad_weight=n_global)
    aux = net.aux_encoder.conv
    out["disco_band"] -= aux.conv_op.phases
    out["disco_polar"] -= polar_launches(aux, members)
    out["disco_band"] += len(aux.conv_op.weight_grad_chunks(members, net.n_aux)) * aux.conv_op.phases
    return out


def check_fcn31_train_kernels(dev, card, params, model, loss_obj, batch):
    """The FCN3.1 training step's backward kernels at its shapes (B*E
    members): K12 (the wide-band kernel at K 7, and a second call held bit
    for bit to the first) and K13 at the processor and the decoder
    (responses mode, reading the padded responses), K5 forward
    at both, K14 at the decoder, K15 on the step's forecasts, K9 and K3's dx
    and the forward K1-K3 at the global blocks' grid, K8 and its backward
    GEMMs at the processor, and K16 and K17 on the model's parameters with
    one step's gradients."""
    from makani_torch.models.common.contractions import _PermutedWeight, contract_dense_s, contract_dense_s_plain
    from makani_torch.ops import sht

    net = model.model
    BE = FCN3_TRAIN_BATCH * FCN3_TRAIN_ENSEMBLE
    gen = torch.Generator(dev).manual_seed(SEED + 16)
    results = {}
    for name, conv, n_in in fcn31_convs(net):
        if name not in ("processor", "decoder"):
            continue
        op = conv.conv_op
        C, K = conv.in_channels, op.K
        label = f"fcn31-train-{name}"
        dt = op.response_buffer(BE, C, dev)
        dt.copy_(randn(dt.shape, torch.float32, gen, dev))
        case = band_grad_case(op, dt, op.band_filter(0, dev), C, 1, 1, K, label, library=name == "processor")
        run_cases([case], card, results, 3, 1, plain_once=True)
        first = case[3]()
        bit = torch.equal(first.view(torch.int32), case[3]().view(torch.int32))
        print(f"K12 {label} (BL {op.BL}, WW {op.WW}, K {K}): two calls {'bit-equal' if bit else 'NOT bit-equal'}; {kernel_regs('disco_band_grad_wide')}  "
              f"[{card}]", flush=True)
        if not bit:
            raise RuntimeError(f"K12 {label}: two calls on the same inputs differ")
        del dt, first, case
        torch.cuda.empty_cache()
        x = randn((BE, *op.in_shape, C), torch.float32, gen, dev)
        run_cases([band_case(op, x, op.band_filter(0, dev), 1, 1, K, label, padded=True)], card, results, 3, 1, plain_once=True)
        del x
        torch.cuda.empty_cache()
        M = op.in_shape[1] // 2 + 1
        r0, r1 = op.polar_chunks(BE, C)[0]
        dY = randn((BE, r1 - r0, C, K, M, 2), torch.float32, gen, dev)
        run_cases([polar_grad_case(dY, op.polar_table(0, dev)[r0:r1], "psi_first", label)], card, results, 3, 1)
        print(f"K13 {label} psi first (BL {op.BL}, K {K}): {kernel_regs('psi_first_grad_kernel')}", flush=True)
        del dY
        torch.cuda.empty_cache()
        if name == "processor":
            run_cases([mix_case(conv, BE, card, label)], card, results, 3, 1)
            mix_grad_times(conv, BE, card)
    dec = net.decoder
    dy = randn((BE, *dec.resample.out_shape, net.embed_dim), torch.float32, gen, dev)
    run_cases([resample_grad_case(dec.resample, dy, "fcn31-train-decoder")], card, results, 3, 1)
    del dy
    torch.cuda.empty_cache()
    inp, tar, unp = batch
    with torch.no_grad():
        pred = model(inp, unp, train=True).reshape(FCN3_TRAIN_BATCH, FCN3_TRAIN_ENSEMBLE, *tar.shape[1:])
    crps = crps_cases(pred, tar)
    run_cases([(n, f"fcn31-{lab}", *rest) for n, lab, *rest in crps], card, results, 5, 1)
    del pred
    torch.cuda.empty_cache()
    spec = net.block0.global_conv
    fwd, inv = spec.forward_transform, spec.inverse_transform
    C = spec.weight.shape[2]
    run_cases(dhconv_grad_cases(BE, fwd.lmax, fwd.mmax, spec.weight.detach(), gen, "fcn31-internal", bf16=False), card, results, 3, 1)
    torch.cuda.empty_cache()
    xf = randn((BE, fwd.nlat, fwd.mmax, C, 2), torch.float32, gen, dev)
    wa = fwd.weights(dev)
    c2 = randn((BE, inv.lmax, inv.mmax, C, 2), torch.float32, gen, dev)
    pa = inv.pct(dev)
    xs = randn((BE, inv.lmax, inv.mmax, 1, C, 2), torch.float32, gen, dev)
    wcache = _PermutedWeight()
    run_cases([
        ("sht_analysis", "fcn31-train", torch.float32, lambda: sht.analysis_contract_cl_s(xf, wa), lambda: sht.analysis_contract_cl_s_plain(xf, wa), legendre_extras(xf, wa, 0, BE)),
        ("sht_synthesis", "fcn31-train", torch.float32, lambda: sht.synthesis_contract_cl_s(c2, pa), lambda: sht.synthesis_contract_cl_s_plain(c2, pa), legendre_extras(c2, pa, 1, BE)),
        ("dhconv", "fcn31-train", torch.float32, lambda: contract_dense_s(xs, spec.weight, False, "dhconv", True, weight_cache=wcache),
         lambda: contract_dense_s_plain(xs, spec.weight, False, "dhconv", True), dhconv_extras(xs, spec.weight.detach())),
    ], card, results, 3, 1)
    del xf, c2, xs
    torch.cuda.empty_cache()
    _, grads, _ = fcn3_grads(model, loss_obj, batch)
    grads = [grads[n] for n, _ in model.named_parameters()]
    results.update(optimizer_cases(card, model, grads, params, FCN3_STEPS_PER_EPOCH, "fcn31-recipe"))
    del grads
    torch.cuda.empty_cache()
    return results


def fcn31_train_phases(dev, card):
    """Phases 38-41: the FCN3.1 recipe's ensemble-CRPS training step;
    returns (kernel results, launch counts of the timed training steps)."""
    import copy

    from makani_torch import kernels
    from makani_torch.utils.training.ensemble_trainer import ensemble_train_step, fold_ensemble
    from makani_torch.utils.training.optimizer import get_schedule

    t0 = time.perf_counter()
    params, model, loss_obj = build_fcn31_train(dev)
    net = model.model
    nparam = sum(p.numel() for p in model.parameters())
    print(f"built the FCN3.1 training step ({nparam} parameters in {len(list(model.parameters()))} leaves, compute {params.compute_dtype}, "
          f"{params.img_shape_x}x{params.img_shape_y} -> internal {net.h}x{net.w}, lmax {net.lmax}, {net.num_layers} blocks, embed {net.embed_dim}, "
          f"B={FCN3_TRAIN_BATCH} E={FCN3_TRAIN_ENSEMBLE}, checkpointing_level {net.checkpointing_level}; loss {params.losses}; Adam, clip "
          f"{params.optimizer_max_grad_norm}, {params.scheduler} at lr {params.lr}) in {time.perf_counter() - t0:.1f} s", flush=True)
    print_fcn31_convs(net)
    batch = fcn3_train_batch(dev, params)
    t0 = time.perf_counter()
    kres = check_fcn31_train_kernels(dev, card, params, model, loss_obj, batch)
    print(f"fcn31-train kernel checks {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # one step, kernel path vs plain path, from the same weights and batch
    t0 = time.perf_counter()
    plain, plain_loss = copy.deepcopy(model), copy.deepcopy(loss_obj)
    kernels.set_use_kernels(plain, False)
    plain_loss.loss_fns[0].use_kernels = False
    inp, tar, unp = batch
    lk, gk, pk = fcn3_grads(model, loss_obj, batch)
    lp, gp, pp = fcn3_grads(plain, plain_loss, batch)
    torch.cuda.synchronize()
    # the forecasts of the gradients' own forwards
    err = errors(pk, pp)
    wgt = crps_order_weight(fold_ensemble(pk, FCN3_TRAIN_ENSEMBLE), fold_ensemble(pp, FCN3_TRAIN_ENSEMBLE), tar)
    del pk, pp
    worst = max((((gk[n].float() - gp[n].float()).norm() / gp[n].float().norm().clamp_min(1e-30)).item(), n) for n in gp)
    ok = abs(lk - lp) <= MODEL_BF16_REL_L2 * abs(lp) and worst[0] <= TRAIN_GRAD_BF16_REL_L2 and err["rel_l2"] <= MODEL_BF16_REL_L2
    print(f"FCN3.1 training step (bfloat16 compute, B={FCN3_TRAIN_BATCH} E={FCN3_TRAIN_ENSEMBLE}), kernel path vs plain path: forecast relL2 "
          f"{err['rel_l2']:.3e} (tol {MODEL_BF16_REL_L2}); loss {lk:.6f} vs {lp:.6f} (rel {abs(lk - lp) / abs(lp):.2e}, tol {MODEL_BF16_REL_L2}); "
          f"worst gradient leaf {worst[1]} relL2 {worst[0]:.3e} (tol {TRAIN_GRAD_BF16_REL_L2}); pixels the two forecasts may rank differently "
          f"{1.0 - wgt.mean().item():.2%} (counted, not excluded); {time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError("FCN3.1 bf16 training step: the kernel path disagrees with the plain path")
    del gp
    compare_optimizer_step(card, "FCN3.1 recipe", params, FCN3_STEPS_PER_EPOCH, model, plain, gk)
    del model, plain, gk
    torch.cuda.empty_cache()

    # the main path, timed: 1 + TRAIN_STEPS steps through the kernels
    params, model, loss_obj = build_fcn31_train(dev)
    opt = recipe_optimizer(params, model, FCN3_STEPS_PER_EPOCH, True)
    losses, times, peak, launches, lrs, norms = timed_recipe_steps(
        lambda: ensemble_train_step(model, loss_obj, opt, inp, tar, unp, FCN3_TRAIN_ENSEMBLE), opt, TRAIN_STEPS)
    n = TRAIN_STEPS + 1
    members = FCN3_TRAIN_BATCH * FCN3_TRAIN_ENSEMBLE
    per_step = fcn31_train_launches_per_step(model.model, members)
    for k, v in optimizer_launches(opt).items():
        per_step[k] = per_step.get(k, 0) + v
    expected = {k: per_step.get(k, 0) * n for k in launches}
    print(f"FCN3.1 training launches over {n} steps: {launches} (per step {({k: v / n for k, v in launches.items()})})")
    if launches != expected:
        raise RuntimeError(f"FCN3.1 training launch counts {launches} != expected {expected}")
    med = statistics.median(times[1:])
    print(f"FCN3.1 recipe training step (kernel path, bf16, B={FCN3_TRAIN_BATCH} E={FCN3_TRAIN_ENSEMBLE}): median {med:.2f} ms over {TRAIN_STEPS} steps "
          f"after a warm-up {[round(t, 2) for t in times]}, {members / med * 1e3:.3f} samples/s (members), peak memory {peak / 2**30:.2f} GiB; loss per "
          f"step {[round(v, 6) for v in losses]}; lr per step {[f'{v:.6e}' for v in lrs]}; grad norm per step {[round(v, 4) for v in norms]}  [{card}]",
          flush=True)
    if not all(math.isfinite(v) for v in losses) or not min(losses[1:]) < losses[0]:
        raise RuntimeError(f"FCN3.1 training loss not finite or not falling over {TRAIN_STEPS} steps: {losses}")
    if lrs != [get_schedule(params, FCN3_STEPS_PER_EPOCH)(k) for k in range(n)]:
        raise RuntimeError(f"FCN3.1 recipe learning rates {lrs} are not the schedule's")
    del model, opt
    torch.cuda.empty_cache()
    return kres, launches


# ---------------------------------------------------------------------------
# The token models (slice 9): FourCastNet v1 (AFNO), AFNOv2 and the ViT, at
# full width (B = 1, bf16 compute as the recipes say)

AFNO_CONFIG = ("config/afnonet.yaml", "afno_73ch")
AFNOV2_CONFIG = ("config/afnonet.yaml", "afnov2_73ch")
VIT_CONFIG = ("config/vit.yaml", "vit_73ch")
TOKEN_BATCH = 1  # the recipes' batch of 64 on 64 GPUs, one card's share
AFNO_STATES = 3  # a year file's states for train.py: 2 training steps and one validation rollout
AFNO_AUTOREG = 1
AFNO_CLI_NAME = "afno_cli"


def token_params(config, compute_dtype=None):
    from makani_torch.utils.yparams import YParams

    params = YParams(os.path.join(REPO, config[0]), config[1])
    if compute_dtype is not None:
        params["compute_dtype"] = compute_dtype
    n_chan = len(params.channel_names)
    params["in_channels"] = list(range(n_chan))
    params["out_channels"] = list(range(n_chan))
    return params


def build_token(dev, config, compute_dtype=None):
    """A token model through get_model on seeded weights, ModelWrapper with
    seeded per-channel stats and a seeded initial condition."""
    from makani_torch.models.model_package import ModelWrapper
    from makani_torch.models.model_registry import get_model

    params = token_params(config, compute_dtype)
    n_chan = len(params.channel_names)
    model, _ = get_model(params, multistep=True, device=dev, seed=SEED)
    gen = torch.Generator(dev).manual_seed(SEED + 40)
    bias = randn((1, n_chan, 1, 1), torch.float32, gen, dev)
    scale = 0.5 + torch.rand((1, n_chan, 1, 1), generator=gen, device=dev)
    x0 = bias + scale * randn((1, n_chan, params.img_shape_x, params.img_shape_y), torch.float32, gen, dev)
    return params, model, ModelWrapper(model, bias=bias, scale=scale), x0


def token_batch(params, dev):
    """A seeded training batch (input, target, zenith) of TOKEN_BATCH samples."""
    gen = torch.Generator(dev).manual_seed(SEED + 41)
    C, H, W = len(params.channel_names), params.img_shape_x, params.img_shape_y
    return (randn((TOKEN_BATCH, C, H, W), torch.float32, gen, dev), randn((TOKEN_BATCH, C, H, W), torch.float32, gen, dev),
            randn((TOKEN_BATCH, 1, 1, H, W), torch.float32, gen, dev))


def real_block(w):
    """A complex weight (nb, 2, rows, cols) as the real block matrix [[wr,
    wi], [-wi, wr]] (nb, 2 rows, 2 cols): [re, im] . block = the complex
    product's [re, im]."""
    return torch.cat([torch.cat([w[:, 0], w[:, 1]], dim=2), torch.cat([-w[:, 1], w[:, 0]], dim=2)], dim=1)


def mixer_library(x2, w1, b1, w2, b2, lambd, band):
    """The library yardstick of K18: the same two complex products as fp32
    ``torch.bmm`` of the real block form [re, im] (BM, 2 bs) . [[wr, wi],
    [-wi, wr]] (2 bs, 2 hbs) under ``fp32_exact``, batched over the channel
    blocks, with the relu, band and soft-shrink as elementwise ops."""
    from makani_torch.ops.precision import fp32_exact

    B, H, Wh, C, _ = x2.shape
    nb, _, bs, hbs = w1.shape
    W1, W2 = real_block(w1), real_block(w2)
    bias1, bias2 = (None if b is None else b.reshape(nb, 1, -1) for b in (b1, b2))
    keep = band.mask(H, Wh, x2.device).reshape(1, H * Wh, 1).repeat(1, B, 1).reshape(1, B * H * Wh, 1)

    def run():
        a = x2.reshape(B * H * Wh, nb, bs, 2).permute(1, 0, 3, 2).reshape(nb, B * H * Wh, 2 * bs)
        with fp32_exact():
            h = torch.bmm(a, W1)
            if bias1 is not None:
                h = h + bias1
            h = torch.relu(h)
            o = torch.bmm(h, W2)
        if bias2 is not None:
            o = o + bias2
        o = torch.where(keep, o, 0.0)
        return torch.sign(o) * torch.clamp(o.abs() - lambd, min=0.0)

    return run


def mixer_grad_library(x2, y, dy, h, w1, w2, has_bias):
    """K19's library yardstick: its four complex products as fp32
    ``torch.bmm`` of the real block forms under ``fp32_exact``, batched over
    the channel blocks, with the two masks as elementwise ops."""
    from makani_torch.ops.precision import fp32_exact

    B, H, Wh, C, _ = x2.shape
    nb, _, bs, hbs = w1.shape
    M = B * H * Wh
    W1, W2 = real_block(w1), real_block(w2)

    def split(t):
        return t.reshape(M, nb, bs, 2).permute(1, 0, 3, 2).reshape(nb, M, 2 * bs)

    def run():
        a, g = split(x2), split(dy)
        g2 = torch.where(split(y) != 0, g, 0.0)
        o1 = h.permute(1, 0, 2, 4, 3).reshape(nb, M, 2 * hbs)
        with fp32_exact():
            g1 = torch.where(o1 > 0, torch.bmm(g2, W2.transpose(1, 2)), 0.0)
            dx = torch.bmm(g1, W1.transpose(1, 2))
            dw1 = torch.bmm(a.transpose(1, 2), g1)
            dw2 = torch.bmm(o1.transpose(1, 2), g2)
        out = [dx, dw1, dw2]
        if has_bias:
            out += [g1.sum(dim=1), g2.sum(dim=1)]
        return out

    return run


def check_mixer_kernels(dev, card, filt, grid, label, results):
    """K18 and K19 at a model's first mixer: the spectrum of a seeded
    (B, 90, 180, 768) token grid (fp32 rFFT, ortho, read in place), the
    module's weights (read in place in its flax layout), band and lambda;
    K18 held to its plain version (``run_cases``, FP32_TOL), and its kept o1
    (the training launch's, which K19 reads) with its output to the plain
    o1 and output; K19 on K18's o1 and output and a seeded dy held leaf by
    leaf to its plain version on the same inputs (FP32_TOL of each leaf's
    max|ref|), its weight gradients in the parameters' strides; both timed
    beside their bounds (fp32 FMA and 3xTF32) and the ``bmm`` yardsticks."""
    from makani_torch.ops import afno_mixer as am
    from makani_torch.ops.fft_compat import rfft2_s

    net_h, net_w, C = grid
    gen = torch.Generator(dev).manual_seed(SEED + 42)
    x2 = rfft2_s(randn((TOKEN_BATCH, net_h, net_w, C), torch.float32, gen, dev), axes=(1, 2), norm="ortho")
    *weights, lam, band = filt.mixer_args(net_h, net_w // 2 + 1)
    w1, b1, w2, b2 = (None if t is None else t.detach() for t in weights)
    nb, _, bs, hbs = w1.shape
    B, H, Wh = x2.shape[:3]
    flops = 8.0 * 2 * B * H * Wh * nb * bs * hbs
    wbytes = nbytes(w1, w2) + (nbytes(b1, b2) if b1 is not None else 0)

    def k18_extras(out):
        lib = mixer_library(x2, w1, b1, w2, b2, lam, band)
        return dict(bound(flops, 2 * nbytes(x2) + wbytes, torch.float32), library_ms=time_ms(lib, 5, 1))

    run_cases([("afno_mixer", label, torch.float32, lambda: am.launch_afno_mixer(x2, w1, b1, w2, b2, lam, band)[0],
                lambda: am.afno_mixer_plain(x2, w1, b1, w2, b2, lam, band), k18_extras)], card, results, 10, 2)

    y, h = am.launch_afno_mixer(x2, w1, b1, w2, b2, lam, band, keep_hidden=True)
    yref, href = am.afno_mixer_plain(x2, w1, b1, w2, b2, lam, band, return_hidden=True)
    kept = {"y": errors(y, yref), "o1": errors(h, href)}
    del yref, href
    print(f"kernel afno_mixer    {label:17s} float32  kept for training (keep_hidden): " + ", ".join(
        f"{n} max|d|/max|ref| {e['max_rel']:.3e}" for n, e in kept.items()) + f" {'ok' if max(e['max_rel'] for e in kept.values()) <= FP32_TOL else 'FAIL'}",
        flush=True)
    if max(e["max_rel"] for e in kept.values()) > FP32_TOL:
        raise RuntimeError(f"afno_mixer {label}: the training launch's output or kept o1 disagrees with the plain version: {kept}")
    # dy in the spectrum's strides, as the irFFT's backward hands it to K19 on the main path
    dy = torch.empty_like(y).copy_(randn(tuple(y.shape), torch.float32, gen, dev))
    has_bias = b1 is not None
    kern = lambda: am.launch_afno_mixer_grad(x2, y, dy, h, w1, b1, w2, b2, band)  # noqa: E731
    plain = lambda: am.afno_mixer_grad_plain(x2, y, dy, h, w1, b1, w2, b2)  # noqa: E731
    outs, refs = kern(), plain()
    again = kern()
    bit = all(torch.equal(a, b) for a, b in zip(outs, again) if a is not None)
    names = ("dx", "dw1", "db1", "dw2", "db2")
    errs = {n: errors(o, r) for n, o, r in zip(names, outs, refs) if o is not None}
    layouts = all(o.stride() == p.stride() for o, p in zip(outs, (x2, w1, b1, w2, b2)) if o is not None)
    del outs, refs, again
    ms, plain_ms = time_ms(kern, 10, 2), time_ms(plain, 5, 1)
    lib_ms = time_ms(mixer_grad_library(x2, y, dy, h, w1, w2, has_bias), 5, 1)
    ext = bound(2 * flops, 4 * nbytes(x2) + nbytes(h) + 2 * wbytes, torch.float32)
    worst = max(e["max_rel"] for e in errs.values())
    ok = worst <= FP32_TOL and bit and layouts
    print(f"kernel afno_mixer_grad {label:17s} float32  dx {tuple(x2.shape)}: " + ", ".join(f"{n} max|d|/max|ref| {e['max_rel']:.3e}" for n, e in errs.items())
          + f" {'ok' if worst <= FP32_TOL else 'FAIL'}; gradients {'in' if layouts else 'NOT in'} their parameters' strides; a second launch "
          f"{'bit-equal' if bit else 'NOT bit-equal'}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound_ms {ext['bound_ms']:.3f} ms, fma_bound_ms {ext['fma_bound_ms']:.3f} ms, tc_bound_ms {ext['tc_bound_ms']:.3f} ms"
          + f", library_ms {lib_ms:.3f} ms; mode ranges S {am.grad_splits(B, H * Wh, nb, bs, hbs, 132)}  [{card}]", flush=True)
    if not ok:
        raise RuntimeError(f"afno_mixer_grad {label}: kernel disagrees with its plain version, writes another layout or does not repeat: {errs}")
    results[("afno_mixer_grad", label, torch.float32)] = dict(max_abs_err=max(e["max_abs_err"] for e in errs.values()), max_rel=worst, ms=ms, plain_ms=plain_ms,
                                                              shape=tuple(x2.shape), library_ms=lib_ms, **ext)
    del x2, y, h, dy
    torch.cuda.empty_cache()
    return results


def token_launches(params, train: bool) -> dict:
    """A token model's launches a forward (and its backward): K18 (K19)
    one a block of the AFNOs, K4 (K10) two a block of AFNOv2 with instance
    norms; the ViT runs no hand-written kernel."""
    n = params.num_layers if params.nettype in ("AFNO", "AFNOv2") else 0
    norms = 2 * n if params.nettype == "AFNOv2" and params.normalization_layer.startswith("instance_norm") else 0
    out = {"afno_mixer": n, "instance_norm": norms}
    if train:
        out.update(afno_mixer_grad=n, instance_norm_grad=norms)
    return out


def token_grads_check(model, loss_obj, batch, tag, dtype_label, zero_grads=()):
    """One training step's loss and gradients through the kernels and
    through the plain path (autograd through the plain forward) from the
    same weights and batch: the loss within TRAIN_LOSS_FP32_TOL and each
    gradient leaf within TRAIN_GRAD_AFNO_FP32_REL_L2 relative L2 (fp32
    compute), or MODEL_BF16_REL_L2 and TRAIN_GRAD_BF16_REL_L2 (bf16). Not
    fp32's MODEL_FP32_TOL of max|ref|: the mixer's relu and soft-shrink are
    kinked, and among the ~10^7 values a block where the two paths'
    forwards differ by rounding (~6e-7), some sit on either side of a kink,
    which moves their mode's whole gradient (the biases' leaves by up to ~1%
    of max|ref| at afno_73ch). K18's kept o1 and K19 are held to FP32_TOL
    on the same inputs (``check_mixer_kernels``). ``zero_grads``: name endings of leaves whose
    gradient is zero in exact arithmetic, held at rounding level (1e-5 of
    the largest gradient in fp32, 1e-2 in bf16)."""
    import copy

    from makani_torch import kernels

    inp, tar, zen = batch
    plain = copy.deepcopy(model)
    kernels.set_use_kernels(plain, False)
    lk, gk = loss_and_grads(model, loss_obj, inp, tar, zen)
    model.zero_grad(set_to_none=True)
    lp, gp = loss_and_grads(plain, loss_obj, inp, tar, zen)
    del plain
    fp32 = dtype_label == "float32"
    largest = max(g.abs().max().item() for g in gp.values())
    worst = (0.0, "")
    for name in gp:
        a, b = gk[name].float(), gp[name].float()
        if name.endswith(zero_grads):
            if max(a.abs().max().item(), b.abs().max().item()) > (1e-5 if fp32 else 1e-2) * largest:
                raise RuntimeError(f"{tag} {dtype_label} step: {name}'s gradient is not at rounding level")
            continue
        worst = max(worst, (((a - b).norm() / b.norm()).item(), name))
    ltol, gtol = (TRAIN_LOSS_FP32_TOL, TRAIN_GRAD_AFNO_FP32_REL_L2) if fp32 else (MODEL_BF16_REL_L2, TRAIN_GRAD_BF16_REL_L2)
    ok = abs(lk - lp) <= ltol * abs(lp) and worst[0] <= gtol and math.isfinite(lk)
    print(f"{tag} training step ({dtype_label} compute, full width, B={TOKEN_BATCH}), kernel path vs plain path: loss {lk:.7f} vs {lp:.7f} "
          f"(rel {abs(lk - lp) / abs(lp):.2e}, tol {ltol}); worst gradient leaf {worst[1]} relL2 {worst[0]:.3e} "
          f"(tol {gtol}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"{tag} {dtype_label} training step: the kernel path disagrees with the plain path")
    del gk, gp
    torch.cuda.empty_cache()


def token_phases(dev, card, config, tag):
    """A token model's forecast and training step at full width (phases
    46-49 for afno_73ch, 51-52 for afnov2_73ch and vit_73ch). Returns (the
    kernel results, the forecast's launches, the training step's)."""
    import copy

    from makani_torch import kernels
    from makani_torch.models.model_package import rollout
    from makani_torch.utils.loss import LossHandler
    from makani_torch.utils.training.deterministic_trainer import train_step
    from makani_torch.utils.training.optimizer import get_optimizer
    from makani_torch.utils.zenith_angle import cos_zenith_angle_from_timestamp

    t0 = time.perf_counter()
    params, model, wrapper, x0 = build_token(dev, config)
    net = model.model
    nettype = params.nettype
    n_layers = params.num_layers
    nparam = sum(p.numel() for p in model.parameters())
    print(f"built {tag} = {config[1]} of {config[0]} ({nettype}, {nparam} parameters, compute {params.compute_dtype}, {params.img_shape_x}x{params.img_shape_y}, "
          f"patch {tuple(params.patch_size)}, embed {params.embed_dim}, {n_layers} blocks, {params.N_in_channels} in / {params.N_out_channels} out channels) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kres = {}
    H, W = params.img_shape_x, params.img_shape_y
    if nettype in ("AFNO", "AFNOv2"):
        t0 = time.perf_counter()
        ph, pw = params.patch_size
        check_mixer_kernels(dev, card, net.block0.filter, (H // ph, W // pw, params.embed_dim), tag, kres)
        print(f"{tag} kernel checks {time.perf_counter() - t0:.1f} s", flush=True)

    # the forecast: a 4-step rollout through ModelWrapper
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
            raise RuntimeError(f"{tag} rollout step {i + 1}: shape {tuple(f.shape)} or non-finite values")
        # the model's zero-padded rows, denormalized
        pad = f[:, :, H // params.patch_size[0] * params.patch_size[0]:]
        if not bool((pad == wrapper.bias).all()):
            raise RuntimeError(f"{tag} rollout step {i + 1}: the padded rows are not the model's zeros")
        print(f"{tag} rollout step {i + 1} (+{(i + 1) * params.dhours} h): shape {tuple(f.shape)}, finite, mean {f.mean().item():.4f}, std {f.std().item():.4f}, "
              f"the {pad.shape[2]} padded row(s) the model's zeros")
    per_fwd = token_launches(params, False)
    expected = {k: per_fwd.get(k, 0) * STEPS for k in kernels.LAUNCHES}
    print(f"{tag} launches over {STEPS} forecast steps: {launches} (per step {per_fwd})")
    if launches != expected:
        raise RuntimeError(f"{tag} launch counts {launches} != expected {expected}")
    lon2d, lat2d = np.meshgrid(lon, lat)
    zen = torch.from_numpy(cos_zenith_angle_from_timestamp(t_start, lon2d, lat2d).astype(np.float32)).to(dev)[None, None, None]
    if nettype != "ViT":
        err = compare_paths(model, wrapper, x0, zen, frames[0])
        ok = err["rel_l2"] <= MODEL_BF16_REL_L2
        print(f"{tag} step 1 ({params.compute_dtype}), kernel path vs plain path (normalized units): relL2 {err['rel_l2']:.3e} (tol {MODEL_BF16_REL_L2}), "
              f"max|d|/max|ref| {err['max_rel']:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"{tag} kernel path disagrees with the plain path: {err}")
    del frames
    if tag == "afno":
        _, model32, wrapper32, _ = build_token(dev, config, "float32")
        err = compare_paths(model32, wrapper32, x0, zen)
        ok = err["max_rel"] <= MODEL_FP32_TOL
        print(f"{tag} step 1 (float32 compute, same weights), kernel path vs plain path: max|d|/max|ref| {err['max_rel']:.3e} (tol {MODEL_FP32_TOL}), "
              f"relL2 {err['rel_l2']:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"{tag} fp32 kernel path disagrees with the plain path: {err}")
        del model32, wrapper32
        torch.cuda.empty_cache()
    with torch.no_grad():
        if nettype == "ViT":
            time_kernel_steps(lambda: wrapper(x0, zen), card, f"{tag} forecast", TOKEN_BATCH)
        else:
            time_steps(model, lambda: wrapper(x0, zen), card, f"{tag} forecast")
    torch.cuda.empty_cache()

    # one training step (the recipe's loss and optimizer)
    batch = token_batch(params, dev)
    loss_obj = LossHandler(token_params(config))
    # AFNOv2 with a nested skip and instance norms: the filter's bias, the
    # skip's bias and norm1's bias (a per-channel constant reaches only the
    # DC mode, whose inverse is a constant) meet the loss only through norm2,
    # which removes any per-channel constant
    nested_in = nettype == "AFNOv2" and params.get("nested_skip_fno", True) and params.normalization_layer.startswith("instance_norm")
    zero_grads = ("filter.b1", "skip_layer.bias", "norm1.bias") if nested_in else ()
    if nettype != "ViT":
        token_grads_check(model, loss_obj, batch, tag, params.compute_dtype, zero_grads)
        if tag == "afno":
            _, model32, _, _ = build_token(dev, config, "float32")
            token_grads_check(model32, LossHandler(token_params(config, "float32")), batch, tag, "float32")
            del model32
            torch.cuda.empty_cache()
    model.zero_grad(set_to_none=True)
    twin = copy.deepcopy(model)
    opt, twin_opt = get_optimizer(token_params(config), model), get_optimizer(token_params(config), twin)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    loss = train_step(model, loss_obj, opt, *batch)
    torch.cuda.synchronize()
    train_launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    twin_loss = train_step(twin, loss_obj, twin_opt, *batch)
    bit = twin_loss.item() == loss.item() and all(torch.equal(a, b) for a, b in zip(model.parameters(), twin.parameters()))
    del twin, twin_opt
    torch.cuda.empty_cache()
    expected = {k: token_launches(params, True).get(k, 0) + optimizer_launches(opt).get(k, 0) for k in kernels.LAUNCHES}
    times = []
    for i in range(4):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        train_step(model, loss_obj, opt, *batch)
        e.record()
        torch.cuda.synchronize()
        if i:
            times.append(s.elapsed_time(e))
    ok = math.isfinite(loss.item()) and bit and train_launches == expected
    print(f"{tag} training step (train_step, {params.compute_dtype}, B={TOKEN_BATCH}, {params.optimizer_type} at lr {opt.last_lr:.3e}): loss {loss.item():.6f}; "
          f"launches {train_launches} (expected {expected}); a second step from the same weights, optimizer state and batch "
          f"{'bit-equal' if bit else 'NOT bit-equal'} (loss and every parameter); ms a step (kernel path) median {statistics.median(times):.2f} over "
          f"{len(times)} {[round(t, 2) for t in times]} after a warm-up, {TOKEN_BATCH / statistics.median(times) * 1e3:.3f} samples/s; peak memory "
          f"{peak / 2**30:.2f} GiB  [{card}]", flush=True)
    if not ok:
        raise RuntimeError(f"{tag} training step: loss {loss.item()}, bit-equal {bit}, launches {train_launches} != {expected}")
    del model, wrapper, opt
    torch.cuda.empty_cache()
    return kres, launches, train_launches


def afno_cli_phases(dev, card):
    """Phase 50: train.py and inference.py on afno_73ch (its own YAML entry
    over seeded files, overriding only the paths, the rollout and the epochs)."""
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_afno_", dir=os.path.join(REPO, "build"))
    try:
        return _afno_cli_phases(dev, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def _afno_cli_phases(dev, card, root):
    from makani_torch import inference, kernels, train
    from makani_torch.utils.inference.rollout_buffer import SpectrumAverageBuffer
    from makani_torch.utils.yparams import YParams

    t0 = time.perf_counter()
    recipe = YParams(os.path.join(REPO, AFNO_CONFIG[0]), AFNO_CONFIG[1])
    C, H, W = len(recipe.channel_names), recipe.img_shape_x, recipe.img_shape_y
    yaml_path, overrides, nbytes_written, _, _ = seeded_run_files(root, dev, AFNO_CONFIG, AFNO_CLI_NAME, (H, W), AFNO_STATES,
                                                                  dict(valid_autoreg_steps=AFNO_AUTOREG, max_epochs=1), recipe.to_dict())
    print(f"phase 50: wrote {nbytes_written / 1e9:.2f} GB of seeded files ({len(DRIVER_YEARS)} year files of {AFNO_STATES} states of {C}x{H}x{W} fp32, "
          f"the statistics with min/max for the minmax channels, time means, data.json) in {time.perf_counter() - t0:.1f} s; {AFNO_CLI_NAME} = "
          f"{AFNO_CONFIG[1]} but for {sorted(overrides)}", flush=True)
    argv = ["--yaml_config", yaml_path, "--config", AFNO_CLI_NAME, "--run_num", "0", "--batch_size", str(TOKEN_BATCH)]
    n_lead = AFNO_AUTOREG + 1
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tr = train.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_steps = len(tr.step_losses)
    per_step = optimizer_launches(tr.optimizer)
    expected = {k: n_steps * (12 * (k.startswith("afno")) + per_step.get(k, 0)) + n_lead * 12 * (k == "afno_mixer") for k in launches}
    ck = tr.checkpoint
    print(f"phase 50: python -m makani_torch.train {' '.join(argv[4:])}: {wall:.1f} s ({tr.n_model_params} parameters, {n_steps} steps, a validation rollout "
          f"of {n_lead} steps, checkpoint ckpt_v1); launches {launches} (expected {expected}); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"checkpoint written {ck.bytes_written / 1e9:.3f} GB in {ck.seconds_written:.2f} s  [{card}]", flush=True)
    print(train_line("phase 50 epoch 1 (cold)", tr.logs[-1], tr.host_stats, card), flush=True)
    if launches != expected or n_steps != AFNO_STATES - 1 or not all(math.isfinite(v) for v in tr.logs[-1].values() if isinstance(v, float)):
        raise RuntimeError(f"train.py on {AFNO_CONFIG[1]}: {n_steps} steps, launches {launches} != {expected}, logs {tr.logs[-1]}")
    trained = [p.detach().clone() for p in tr.model.parameters()]
    del tr
    torch.cuda.empty_cache()

    out = os.path.join(root, "scores")
    kernels.reset_launch_counts()
    spectrum = {"sht_analysis": 0}
    undo = counting_launches(SpectrumAverageBuffer, "update", "sht_analysis", kernels.LAUNCHES, spectrum)
    t0 = time.perf_counter()
    try:
        inf = inference.main(argv + ["--output_dir", out])
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    expected = {k: n_lead * 12 * (k == "afno_mixer") + spectrum.get(k, 0) for k in launches}
    bit, _ = leaf_diff([p.detach() for p in inf.model.parameters()], trained)
    tm, logs = inf.timings, inf.logs
    finite = all(math.isfinite(v) for v in logs.values())
    print(f"phase 50: python -m makani_torch.inference ...: {wall:.1f} s; restored the trained weights {'bit for bit' if bit else 'NOT bit for bit'}; "
          f"{tm['lead_steps']} lead steps in {tm['rollout_s']:.3f} s ({1e3 * tm['rollout_s'] / tm['lead_steps']:.1f} ms a lead step, wall, cold); launches "
          f"{launches} (expected {expected}); rmse {logs['rmse']:.6f} acc {logs['acc']:.6f} l1 {logs['l1']:.6f} ({'finite' if finite else 'NOT finite'})  [{card}]",
          flush=True)
    logs2 = inf.score_model(os.path.join(root, "scores_warm"))
    print(f"phase 50: a second scoring (warm): {1e3 * tm['rollout_s'] / tm['lead_steps']:.1f} ms a lead step, wall; logs "
          f"{'equal to' if logs2 == logs else 'NOT equal to'} the first's  [{card}]", flush=True)
    if not bit or launches != expected or not finite or logs2 != logs:
        raise RuntimeError("inference.py on afno_73ch: not the trained weights, not the forecast's launches, or non-finite or unrepeatable scores")
    del inf
    torch.cuda.empty_cache()


def fcn31_rows(meta, fcn31) -> list:
    """The kernels line's FCN3.1 entries: every kernel at each of its shapes
    on FCN3.1's paths, named kernel@shape, with the launches of that path's
    run; K15's forward and backward in one entry, as its main line."""
    where = {m[0]: m[1:4] for m in meta}
    rows = []
    for tag, (res, launches) in fcn31.items():
        for (name, label, dtype), r in res.items():
            if name not in where or name == "crps" and label.endswith("backward"):
                continue
            if name == "crps":
                bwd = res[("crps", label.replace("forward", "backward"), dtype)]
                r = dict(r, max_abs_err=max(r["max_abs_err"], bwd["max_abs_err"]), **{k: r[k] + bwd[k] for k in ("ms", "plain_ms", "bound_ms")})
                label = label.replace("forward", "forward+backward")
            route, source, replaces = where[name]
            rows.append(
                {"name": f"{name}@{label}", "route": route, "source": source, "replaces": replaces, "launches": launches.get(name, 0),
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r.get("library_ms")}
            )
    return rows


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
    PTXAS[:] = ptxas_lines(so.with_suffix(".log").read_text())
    for line in PTXAS:
        print("  ptxas:", line)

    t0 = time.perf_counter()
    sfno_res, sfno_launches = sfno_phases(dev, card)
    print(f"SFNO forecast phases {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fcn3_res, fcn3_launches = fcn3_phases(dev, card)
    print(f"FCN3 forecast phases {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_res, train_launches = train_phases(dev, card)
    print(f"SFNO training phases {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fcn3_train_res, fcn3_train_launches = fcn3_train_phases(dev, card)
    print(f"FCN3 training phases {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recipe_res, recipe_launches = recipe_phases(dev, card)
    print(f"SFNO recipe training phases {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    driver_res, driver_launches = driver_phases(dev, card)
    print(f"driver phases (train.py, inference.py) {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ensemble_driver_phases(dev, card)
    print(f"ensemble driver phases (ensemble.py, inference.py at E={FCN3_TRAIN_ENSEMBLE}) {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    fcn31 = {}
    for tag, config, depth in (("fcn31", FCN31_CONFIG, None), ("fcn31h", FCN31_HISTORY_CONFIG, FCN31_HISTORY_LAYERS)):
        t0 = time.perf_counter()
        fcn31[tag] = fcn31_phases(dev, card, config, tag, depth)
        print(f"FCN3.1 forecast phases ({config[1]}) {time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fcn31["fcn31-train"] = fcn31_train_phases(dev, card)
    print(f"FCN3.1 training phases {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    tokens = {}
    for tag, config in (("afno", AFNO_CONFIG), ("afnov2", AFNOV2_CONFIG), ("vit", VIT_CONFIG)):
        t0 = time.perf_counter()
        tokens[tag] = token_phases(dev, card, config, tag)
        print(f"token model phases ({config[1]}) {time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    afno_cli_phases(dev, card)
    print(f"AFNO CLI phase (train.py, inference.py on {AFNO_CONFIG[1]}) {time.perf_counter() - t0:.1f} s", flush=True)

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
        ("sht_analysis_grad", "cuda", "makani_torch/csrc/sht_legendre.cu", "makani_tpu/ops/sht.py:54", train_res, ("full", f32), train_launches),
        ("sht_synthesis_grad", "cuda", "makani_torch/csrc/sht_legendre.cu", "makani_tpu/ops/sht.py:59", train_res, ("full", f32), train_launches),
        ("dhconv_grad_input", "cuda", "makani_torch/csrc/dhconv.cu", "makani_tpu/models/common/contractions.py:45", train_res, ("internal", f32), train_launches),
        ("dhconv_grad_weight", "cuda", "makani_torch/csrc/dhconv_grad.cu", "makani_tpu/models/common/contractions.py:45", train_res, ("internal", f32), train_launches),
        ("instance_norm_grad", "cuda", "makani_torch/csrc/instance_norm.cu", "makani_tpu/ops/norm.py:96", train_res, ("full", torch.bfloat16), train_launches),
        ("adam_factored", "cuda", "makani_torch/csrc/adam_factored.cu", "makani_tpu/utils/training/optimizer.py:93", train_res, ("model", f32), train_launches),
        ("disco_band_grad", "cuda", "makani_torch/csrc/disco_band_grad.cu", "makani_tpu/ops/disco.py:638", fcn3_train_res, ("processor", f32), fcn3_train_launches),
        ("disco_polar_grad", "cuda", "makani_torch/csrc/disco_polar.cu", "makani_tpu/ops/disco.py:638", fcn3_train_res, ("processor", f32), fcn3_train_launches),
        ("resample_grad", "cuda", "makani_torch/csrc/resample_grad.cu", "makani_tpu/ops/resample.py:81", fcn3_train_res, ("atmo-decoder", f32), fcn3_train_launches),
        ("crps", "cuda", "makani_torch/csrc/crps.cu", "makani_tpu/utils/losses/crps_loss.py:136", fcn3_train_res, ("forward+backward", f32), fcn3_train_launches),
        ("grad_norm", "cuda", "makani_torch/csrc/grad_norm.cu", "makani_tpu/utils/training/optimizer.py:410", recipe_res, ("sfno-recipe", f32), recipe_launches),
        ("adam", "cuda", "makani_torch/csrc/adam.cu", "makani_tpu/utils/training/optimizer.py:371", recipe_res, ("sfno-recipe", f32), recipe_launches),
    ]
    # K15: its forward and backward launch once each a step; the line sums them
    fwd, bwd = fcn3_train_res[("crps", "forward", f32)], fcn3_train_res[("crps", "backward", f32)]
    fcn3_train_res[("crps", "forward+backward", f32)] = dict(
        max_abs_err=max(fwd["max_abs_err"], bwd["max_abs_err"]), library_ms=None,
        bound_by="bytes" if fwd["bound_by"] == bwd["bound_by"] == "bytes" else "operations",
        **{k: fwd[k] + bwd[k] for k in ("ms", "plain_ms", "bound_ms")},
    )
    table = []
    for name, route, source, replaces, res, (label, dtype), launches in meta:
        r = res[(name, label, dtype)]
        table.append(
            {"name": name, "route": route, "source": source, "replaces": replaces, "launches": launches[name],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        )
    r = driver_res[("sht_analysis", "spectrum", f32)]
    table.append(
        {"name": "sht_analysis@spectrum", "route": "cuda", "source": "makani_torch/csrc/sht_legendre.cu", "replaces": "makani_tpu/ops/sht.py:54",
         "launches": driver_launches["sht_analysis"], "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
    )
    table += fcn31_rows(meta, fcn31)
    # K18 at each AFNO forecast's mixer (launches: the 4-step rollout's), K19 at its training step's;
    # AFNOv2's rows named kernel@afnov2
    for tag, replaces in (("afno", "makani_tpu/models/networks/afnonet.py:78"), ("afnov2", "makani_tpu/models/networks/afnonet_v2.py:77")):
        res, forecast, train = tokens[tag]
        for name, source, launches in (("afno_mixer", "afno_mixer.cu", forecast), ("afno_mixer_grad", "afno_mixer_grad.cu", train)):
            r = res[(name, tag, f32)]
            table.append(
                {"name": name if tag == "afno" else f"{name}@{tag}", "route": "cuda", "source": f"makani_torch/csrc/{source}", "replaces": replaces,
                 "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
            )
    # K10 runs at both of the SFNO training step's grids; its line holds the full one
    print("instance_norm_grad (K10), SFNO training step: " + "; ".join(
        f"{lab} bf16 {r['shape']}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, two-read floor {r['two_read_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"library {r['library_ms']:.4f} ms" for lab, r in ((lab, train_res[("instance_norm_grad", lab, torch.bfloat16)]) for lab in ("full", "internal"))))
    print("grad_norm (K16) and adam (K17), FCN3 recipe step: " + "; ".join(
        f"{nm}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms"
        for nm, r in ((nm, fcn3_train_res[(nm, "fcn3-recipe", f32)]) for nm in ("grad_norm", "adam"))))
    print("resample_grad (K14) plans, FCN3 training step: " + "; ".join(
        f"{lab}: {fcn3_train_res[('resample_grad', lab, f32)]['plan']}" for lab in ("atmo-decoder", "surf-decoder")))
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
