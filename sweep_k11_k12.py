#!/usr/bin/env python3
"""K12's tiling and K11's launches, measured on one NVIDIA GPU:

    python3 sweep_k11_k12.py          # both; or name them: k11, k12, k12fcn31, sass, k12lib

- K12 (``csrc/disco_band_grad.cu``, the transpose of the banded DISCO
  contraction) at the FCN3 training step's two main-path calls, the
  processor (responses mode, reading the padded responses in place) and the
  atmo decoder (fused, IG 9, OG 1): as built, and compiled from patched
  copies of its source (``build/sweep_k11_k12/``,
  ``sweep_k4_k8.patched_libraries``, ``K12_VARIANTS``, each named by its
  responses / fused values): row groups fastest in the grid, other input
  rows a block, other column chunks and widths (8 chunks of 6 was the first
  staged tiling), one thread for all 9 outputs of a channel in responses
  mode (in place of three threads of 3), a ring of two stages in fused mode
  (in place of 6), the generic kernel in place of the staged one (the
  design before it), and cuts: every other row's FMAs, no dout copies, no
  compute, no stores, and the skeleton without all three. Each variant is
  held to the built kernel: bit for bit where it sums in the same order,
  within the fp32 gate where it groups the outputs otherwise, not at all
  where it is cut. Beside them: K5's forward at the processor's shape
  (through its wrapper) and the grouped ``conv_transpose1d`` (the library
  yardstick, without the scatter back to the rows).
- ``k12fcn31`` (also part of ``k12``): K12's wide-band kernel at K 7 at the
  FCN3.1 training step's processor and decoder (``chip_smoke.
  build_fcn31_train``, responses mode), as built and as patched copies
  (``K12_WIDE_VARIANTS``): the parent's kernel (the generic gather), other
  pieces of taps a stage, other column tiles, a ring of three, and cuts (no
  dout copies, no MMAs (an FADD of the fragments' bits a partial in place
  of the three products, so the loads and splits stay), no stores, and all
  three).
- K11 (``csrc/adam_factored.cu``) on the factored leaves of the SFNO and
  FCN3 training steps (their models' parameter shapes) and their
  unfactored leaves: each of its three launches timed alone, and the whole
  update with every factored leaf in one table (as the optimizer launches
  it) and with one leaf a launch, each held to the plain version after one
  step from the same state.

- ``sass``: the instruction mix of the staged and wide-band K12 kernels in
  the built library's SASS.
- ``k12lib``: K12's library yardstick (the grouped ``conv_transpose1d`` on
  the band, a group an output latitude) at the FCN3.1 training step's
  decoder (4 members, 361 x 720, 256 channels, K 7), whose band does not
  fit the card in one call: over runs of output latitudes whose band and
  input take at most ``sweep_k5.LIBRARY_RUN_BYTES``, each run timed on its
  own (CUDA events, 2 after 1) and the runs summed; at the training
  processor, where one call fits, the one call beside the runs, held to
  their concatenation (the largest difference, of max|ref|).

Times: CUDA events (``chip_smoke.time_ms``), every variant timed twice in
turns (forward, then backward through the list). K11's and K12's launches
go to the libraries' entry points and count no launch. Each line names the card and
its power limit.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from chip_smoke import PEAK_FP32_FLOPS, PEAK_HBM_BYTES, PEAK_TF32_FLOPS, SEED, TF32_PASSES, card_line, errors, randn, time_ms, within
from sweep_k4_k8 import patched_libraries
from sweep_k9_k13 import in_turns

# K12's source: (the text as built, its replacement); each variant with how
# its result is held to the built kernel's: "same" bit for bit (the same sum
# in the same order), "close" within the fp32 gate (the outputs summed in
# another grouping), "cut" not at all (parts of the work left out: only the
# time means anything)
_NH = "  static constexpr int NH = OT == 9 ? 4 : 2;       // input rows a block"
_UT = "  static constexpr int UT = OT == 9 ? 12 : 30;     // columns a thread"
_OS = "  static constexpr int OS = OT == 9 ? 3 : 1;"
_CHUNKS = "  static constexpr int CHUNKS = OT == 9 ? 5 : 8;   // column chunks a block, a warp each"
_RING = "  static constexpr int RING = OT == 9 ? 2 : 6;"


def _tile(line, nine, one):
    """A patch of a Tile constant: (responses mode, fused mode) values."""
    head, tail = line.split(" = ", 1)
    return (line, f"{head} = OT == 9 ? {nine} : {one};" + tail.split(";", 1)[1])


_NO_COPIES = ("    const int ncols = hmax > lmin ? TU + hmax - lmin - 1 : 0;", "    const int ncols = 0;")
_NO_COMPUTE = ("    if (hmax <= lmin) continue;", "    if (hmax <= lmin || p.Hin > 0) continue;")
_NO_STORES = ("      *dst = p.accumulate ? *dst + acc[k][q] : acc[k][q];", "      if (acc[k][q] == 1234.5f) *dst = acc[k][q];")
_CH = lambda nine, one: _tile(_CHUNKS, nine, one)
K12_VARIANTS = {
    "row groups fastest": ("same", [("constexpr int ROWS_FASTEST = 0;", "constexpr int ROWS_FASTEST = 1;")]),
    "rows 2 / 1": ("same", [_tile(_NH, 2, 1)]),
    "rows 3 / 2": ("same", [_tile(_NH, 3, 2)]),
    "8 chunks of UT 6 / 32": ("same", [_CH(8, 8), _tile(_UT, 6, 32)]),
    "8 chunks of UT 8 / 32": ("same", [_CH(8, 8), _tile(_UT, 8, 32)]),
    "4 chunks of UT 15 / 30": ("same", [_CH(4, 8), _tile(_UT, 15, 30)]),
    "6 chunks of UT 10 / 30": ("same", [_CH(6, 8), _tile(_UT, 10, 30)]),
    "3 chunks of UT 20 / 30": ("same", [_CH(3, 8), _tile(_UT, 20, 30)]),
    "6 / 6 chunks of UT 10 / 20": ("same", [_CH(6, 6), _tile(_UT, 10, 20)]),
    "one thread a channel's 9 outputs": ("close", [_tile(_OS, 1, 1)]),
    "ring of 2 (fused)": ("same", [_tile(_RING, 2, 2)]),
    "generic kernel": ("close", [("  if (unit && OG == 9 && Gf == 1", "  if (false && unit && OG == 9 && Gf == 1"),
                                 ("  if (unit && OG == 1 && OGp == 1", "  if (false && unit && OG == 1 && OGp == 1")]),
    "every other row's FMAs": ("cut", [("            if ((unsigned)(rk[k] + t) >= (unsigned)len[k]) continue;",
                                        "            if (k % 2 || (unsigned)(rk[k] + t) >= (unsigned)len[k]) continue;")]),
    "no dout copies": ("cut", [_NO_COPIES]),
    "no compute": ("cut", [_NO_COMPUTE]),
    "no stores": ("cut", [_NO_STORES]),
    "skeleton": ("cut", [_NO_COPIES, _NO_COMPUTE, _NO_STORES]),
}

# the wide-band kernel (K 7, responses mode): its constants and cuts
_WIDE = lambda name, old, new: (f"  static constexpr int {name} = {old};", f"  static constexpr int {name} = {new};")
_WIDE_NO_COPIES = ("    const int ncols = TU + n - 1;", "    const int ncols = 0;")
_WIDE_NO_MMAS = ("            mma3(part[ci][gi], ah, al, bh[u][0], bh[u][1], bl[u][0], bl[u][1], u == 0);",
                 "            for (int r = 0; r < 4; ++r) part[ci][gi][r] = (u ? part[ci][gi][r] : 0.f) + __uint_as_float(ah[r] ^ al[r] ^ bh[u][r % 2] ^ bl[u][r / 2]);")
_WIDE_NO_STORES = ("    *dst = p.accumulate ? *dst + v : v;", "    if (v == 1234.5f) *dst = v;")
K12_WIDE_VARIANTS = {
    "parent (the generic gather)": ("close", [("  if (unit && OG == Wide::OG && Gf == 1 && IG == 1)", "  if (false && unit && OG == Wide::OG && Gf == 1 && IG == 1)")]),
    "16 taps a stage": ("same", [_WIDE("P", 48, 16)]),
    "32 taps a stage": ("same", [_WIDE("P", 48, 32)]),
    "16 taps a stage, ring of 3": ("same", [_WIDE("P", 48, 16), _WIDE("RING", 2, 3)]),
    "32 columns a block": ("same", [_WIDE("TU", 64, 32)]),
    "8 taps a partial sum": ("close", [_WIDE("TG", 4, 8)]),
    "2 taps a partial sum": ("close", [_WIDE("TG", 4, 2)]),
    "no dout copies": ("cut", [_WIDE_NO_COPIES]),
    "no MMAs": ("cut", [_WIDE_NO_MMAS]),
    "no stores": ("cut", [_WIDE_NO_STORES]),
    "skeleton": ("cut", [_WIDE_NO_COPIES, _WIDE_NO_MMAS, _WIDE_NO_STORES]),
}

# the factored and unfactored leaves of the two training steps' models
# (``chip_smoke.build_train``, ``build_fcn3_train``: the shapes of their
# parameters, counted as ``chip_smoke.adam_launches`` counts them)
K11_LEAVES = {
    "SFNO training": ([(1, 384, 384)] * 10 + [(1, 384, 384, 120, 2)] * 8 + [(1, 384, 768)] * 8 + [(1, 768, 384)] * 8, 53, 84122),
    "FCN3 training": ([(1, 677, 677, 180, 2)] * 2 + [(1, 677, 1354)] * 10 + [(1, 1354, 641)] * 10 + [(1, 677, 677, 9)] * 8, 35, 28502),
}


def k12_case(label, conv, dout, F_, C, Gf, IG, OG, libs, card, dev, with_k5=False, variants=K12_VARIANTS, plain_ms=False):
    from makani_torch import kernels
    from makani_torch.ops import disco_kernels
    from makani_torch.ops.precision import fp32_exact

    B, Hout, Wout, _ = dout.shape
    Hin, Win = conv.in_shape
    bs, taps = conv.band_start_table(dev), conv.tap_table(0, dev)
    rp, rh = conv.grad_rows(0, dev)
    dx = torch.empty(B, Hin, Win, C, device=dev)
    sO = disco_kernels.pixel_stride(dout)
    args = lambda: (dout.data_ptr(), F_.data_ptr(), bs.data_ptr(), taps.data_ptr(), rp.data_ptr(), rh.data_ptr(), dx.data_ptr(), B, Hin, Win, Hout,
                    Wout, C, Gf, IG, OG, F_.shape[-1], conv.BL, conv.WW, conv.stride, int(conv.bases[0]) - conv.halo, Wout, 0, 1, sO, 0,
                    kernels.stream_ptr(dev))

    def launch(lib):
        kernels.check_launch(lib.mt_disco_band_grad(*args()), f"disco_band_grad (sweep, {label})")

    ref = None
    for name, lib in libs.items():  # a fault names its variant
        launch(lib)
        torch.cuda.synchronize()
        check = variants[name][0] if name in variants else "built"
        if check == "built":
            ref = dx.clone()
            t_plain = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t_plain[0].record()
            plain = disco_kernels.band_contract_grad_plain(dout, F_, bs, torch.empty_like(dx), a=1, off=int(conv.bases[0]) - conv.halo, n_out=Wout,
                                                          phase=0, phases=1, Gf=Gf, IG=IG, OG=OG, accumulate=False)
            t_plain[1].record()
            err = errors(ref, plain)
            del plain
            if not within(err, torch.float32):
                raise RuntimeError(f"K12 {label} as built disagrees with its plain version: {err}")
        elif check == "same" and not torch.equal(dx.view(torch.int32), ref.view(torch.int32)):
            raise RuntimeError(f"K12 {label} variant '{name}' differs from the built kernel")
        elif check == "close" and not within(errors(dx, ref), torch.float32):
            raise RuntimeError(f"K12 {label} variant '{name}' disagrees with the built kernel")
    del ref
    torch.cuda.empty_cache()
    fns = {name: (lambda lib=lib: launch(lib)) for name, lib in libs.items()}
    if with_k5:
        out = conv.response_buffer(B, C, dev)
        x = torch.randn(B, Hin, Win, C, device=dev)
        fns["K5 forward (same shape)"] = lambda: disco_kernels.band_contract(x, conv.band_filter(0, dev), bs, out, taps=taps, a=1,
                                                                             off=int(conv.bases[0]) - conv.halo, n_out=Wout, phase=0, phases=1,
                                                                             Gf=1, IG=1, OG=OG)
    times = in_turns(fns, 3, 1)
    if plain_ms:
        times["plain version (one cold call)"] = [t_plain[0].elapsed_time(t_plain[1])] * 2
    R = C // (Gf * IG)
    y = dout.reshape(B, Hout, Wout, R, Gf, OG).permute(0, 3, 1, 4, 5, 2).reshape(B * R, Hout * Gf * OG, Wout)
    filt = F_[..., :OG].permute(0, 1, 5, 2, 3, 4).reshape(Hout * Gf * OG, IG * conv.BL, conv.WW).contiguous()
    with fp32_exact():
        lib_ms = time_ms(lambda: torch.nn.functional.conv_transpose1d(y, filt, stride=conv.stride, groups=Hout * Gf), 1, 1)
    del y
    flops = 2.0 * torch.count_nonzero(F_[..., :OG]).item() * B * Wout * R
    nbytes = B * Hout * Wout * (C // IG * OG) * 4 + (F_[..., :OG].numel() + bs.numel()) * 4 + dx.numel() * 4
    bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    by = "operations" if flops / PEAK_FP32_FLOPS > nbytes / PEAK_HBM_BYTES else "bytes"
    tc = TF32_PASSES * flops / PEAK_TF32_FLOPS * 1e3
    print(f"K12 {label} dout {tuple(dout.shape)} -> dx {tuple(dx.shape)}, bound {bound:.3f} ms ({by}; FMA {flops / PEAK_FP32_FLOPS * 1e3:.3f}, "
          f"3xTF32 {tc:.3f}, bytes {nbytes / PEAK_HBM_BYTES * 1e3:.3f}), max|d|/max|ref| {err['max_rel']:.2e}; variants held to the built kernel: "
          + "; ".join(f"{name} {t[0]:.3f} / {t[1]:.3f} ms" for name, t in times.items())
          + f"; grouped conv_transpose1d {lib_ms:.3f} ms  [{card}]", flush=True)
    del dx
    torch.cuda.empty_cache()


def k12(card: str, dev: torch.device):
    from makani_torch import kernels
    from makani_torch.ops.disco import FusedFilterCache, compute_cutoff_radius, make_disco_conv

    vp, i = ctypes.c_void_p, ctypes.c_int
    libs = {"as built": kernels.library()}
    libs.update(patched_libraries("disco_band_grad.cu", {name: patches for name, (_, patches) in K12_VARIANTS.items()}, "sweep_k11_k12"))
    for lib in libs.values():
        lib.mt_disco_band_grad.argtypes = [vp] * 7 + [i] * 17 + [ctypes.c_longlong, i, vp]
    gen = torch.Generator(dev).manual_seed(0)
    BE = 4  # the FCN3 training step's members, B 1 x E 4
    # the processor: 180 x 360 Legendre-Gauss, morlet th 3 x 3 at twice the cutoff, 677 channels
    proc = make_disco_conv((180, 360), (180, 360), (3, 3), basis_type="morlet th", basis_norm_mode="mean", grid_in="legendre-gauss",
                           grid_out="legendre-gauss", theta_cutoff=2 * compute_cutoff_radius(180, (3, 3), "morlet th"))
    C = 677
    dout = proc.response_buffer(BE, C, dev)
    dout.copy_(torch.randn(dout.shape, generator=gen, device=dev))
    k12_case("processor", proc, dout, proc.band_filter(0, dev), C, 1, 1, proc.K, libs, card, dev, with_k5=True)
    del dout
    torch.cuda.empty_cache()
    # the atmo decoder: 361 x 720 equiangular, w (5, 1, 9, 9) over 13 levels
    dec = make_disco_conv((361, 720), (361, 720), (3, 3), basis_type="morlet th", basis_norm_mode="mean",
                          theta_cutoff=compute_cutoff_radius(361, (3, 3), "morlet th"))
    g, og, ig, R = 5, 1, 9, 13
    w = 0.2 * torch.randn((g, og, ig, dec.K), generator=gen, device=dev)
    dout = torch.randn((BE, 361, 720, R * g * og), generator=gen, device=dev)
    k12_case("atmo decoder", dec, dout, FusedFilterCache().get(dec, w, 0), R * g * ig, g, ig, og, libs, card, dev)


def k12_fcn31(card: str, dev: torch.device):
    """The wide-band kernel (K 7) at the FCN3.1 training step's processor and
    decoder, on seeded responses in the layout K5 writes (``response_buffer``)."""
    import chip_smoke as cs
    from makani_torch import kernels

    vp, i = ctypes.c_void_p, ctypes.c_int
    libs = {"as built": kernels.library()}
    libs.update(patched_libraries("disco_band_grad.cu", {name: patches for name, (_, patches) in K12_WIDE_VARIANTS.items()}, "sweep_k11_k12_wide"))
    for lib in libs.values():
        lib.mt_disco_band_grad.argtypes = [vp] * 7 + [i] * 17 + [ctypes.c_longlong, i, vp]
    gen = torch.Generator(dev).manual_seed(SEED + 16)
    BE = cs.FCN3_TRAIN_BATCH * cs.FCN3_TRAIN_ENSEMBLE
    model = cs.build_fcn31_train(dev)[1]
    for name, conv, _ in cs.fcn31_convs(model.model):
        if name not in ("processor", "decoder"):
            continue
        op = conv.conv_op
        C = conv.in_channels
        dout = op.response_buffer(BE, C, dev)
        dout.copy_(randn(dout.shape, torch.float32, gen, dev))
        print(f"K12 fcn31-train-{name}: BL {op.BL}, WW {op.WW}, K {op.K}, C {C}, pixel stride {dout.stride(2)}", flush=True)
        k12_case(f"fcn31-train-{name}", op, dout, op.band_filter(0, dev), C, 1, 1, op.K, libs, card, dev, variants=K12_WIDE_VARIANTS, plain_ms=True)
        del dout
        torch.cuda.empty_cache()


def k12_sass():
    """The instruction mix of the staged K12 kernels in the built library's
    SASS (``cuobjdump -sass``): each opcode's count, largest first."""
    import collections
    import subprocess
    from pathlib import Path

    from makani_torch import kernels

    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(kernels.build())], capture_output=True, text=True, check=True).stdout
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "disco_band_grad_staged" not in name and "disco_band_grad_wide" not in name:
            continue
        ops = collections.Counter()
        for line in part.splitlines():
            words = line.split("*/", 1)[-1].split()  # after the address, past a predicate
            words = words[1:] if words and words[0].startswith("@") else words
            if "/*" in line and words and words[0][:1].isupper():
                ops[words[0].split(".")[0]] += 1
        total = sum(ops.values())
        print(f"K12 SASS {name}: {total} instructions, FFMA {ops['FFMA'] / total:.0%}: " + ", ".join(f"{op} {n}" for op, n in ops.most_common(12)), flush=True)


def k11(card: str, dev: torch.device):
    from makani_torch import kernels
    from makani_torch.utils.training import optimizer as opt

    lib = kernels.library()
    gen = torch.Generator(dev).manual_seed(2)
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, 1e-3
    for label, (shapes, n_unf, unf_numel) in K11_LEAVES.items():
        params = [torch.randn(s, generator=gen, device=dev) for s in shapes]
        grads = [torch.randn(s, generator=gen, device=dev) for s in shapes]
        unf_p = [torch.randn(unf_numel // n_unf + (k < unf_numel % n_unf), generator=gen, device=dev) for k in range(n_unf)]
        unf_g = [torch.randn_like(p) for p in unf_p]
        dims = [opt._factored_dims(s, 128) for s in shapes]

        def state():
            mus = [torch.zeros_like(p, dtype=torch.bfloat16) for p in params]
            vs = []
            for s, d in zip(shapes, dims):
                vs.append((torch.zeros([n for k, n in enumerate(s) if k != d[1]], device=dev), torch.zeros([n for k, n in enumerate(s) if k != d[0]], device=dev)))
            return [p.clone() for p in params], mus, vs, [torch.zeros_like(p, dtype=torch.bfloat16) for p in unf_p], [torch.zeros_like(p) for p in unf_p]

        c1, c2 = opt._bias_corrections(1, b1, b2)
        ps, mus, vs, umus, uvs = state()
        leaves = [(p, g, m, vr, vc, d, c1, c2, 0.0) for p, g, m, (vr, vc), d in zip(ps, grads, mus, vs, dims)]
        unf = [(p, g, m, v, 0.0) for p, g, m, v in zip(unf_p, unf_g, umus, uvs)]

        # the batched update against the plain version, one step from zero state
        opt.adam_factored_update(leaves, torch.bfloat16, b1, b2, eps, lr)
        torch.cuda.synchronize()
        worst = 0.0
        for p0, g, (p, _, m, vr, vc, d, *_) in zip(params, grads, leaves):
            rp, rm_, rvr, rvc = p0.clone(), torch.zeros_like(m), torch.zeros_like(vr), torch.zeros_like(vc)
            opt.adam_factored_update_plain(rp, g, rm_, rvr, rvc, None, d, c1, c2, b1, b2, eps, lr)
            for out, ref in ((p, rp), (vr, rvr), (vc, rvc)):
                err = errors(out, ref)
                worst = max(worst, err["max_rel"])
                if not within(err, torch.float32):
                    raise RuntimeError(f"K11 {label} leaf {tuple(p.shape)} disagrees with its plain version: {err}")
            if not within(errors(m, rm_), torch.bfloat16):
                raise RuntimeError(f"K11 {label} leaf {tuple(p.shape)}: mu disagrees with its plain version")

        # each launch kind alone, the whole update batched and one leaf a launch
        tables = opt.factored_tables(leaves, torch.bfloat16)

        def kind(k):
            def run():
                for table, corr, n, _ in tables:
                    kernels.check_launch(lib.mt_adam_factored(k, 1, table, corr, n, b1, 1 - b1, b2, 1 - b2, eps, -lr, kernels.stream_ptr(dev)), "K11 (sweep)")
            return run

        fns = {"reduce": kind(0), "combine": kind(1), "apply": kind(2),
               "batched (3 launches a 40 leaves)": lambda: opt.adam_factored_update(leaves, torch.bfloat16, b1, b2, eps, lr),
               "one leaf a launch": lambda: [opt.adam_factored_update([leaf], torch.bfloat16, b1, b2, eps, lr) for leaf in leaves],
               "unfactored leaves": lambda: opt.adam_unfactored_update(unf, torch.bfloat16, c1, c2, b1, b2, eps, lr)}
        times = in_turns(fns, 10, 2)
        n_f = sum(p.numel() for p in params)
        n_all = n_f + unf_numel
        # bound: g, p and the bf16 mu read, p and mu written (16 bytes a
        # parameter), the unfactored leaves' v read and written (8 more)
        bound = (16 * n_all + 8 * unf_numel) / PEAK_HBM_BYTES * 1e3
        print(f"K11 {label}: {len(shapes)} factored leaves ({n_f} parameters), {n_unf} unfactored ({unf_numel}); worst max|d|/max|ref| {worst:.2e}; "
              f"bound {bound:.3f} ms (bytes, 16 a parameter), 20 bytes a parameter {(20 * n_f + 24 * unf_numel) / PEAK_HBM_BYTES * 1e3:.3f} ms: "
              + "; ".join(f"{name} {t[0]:.3f} / {t[1]:.3f} ms" for name, t in times.items()) + f"  [{card}]", flush=True)
        del params, grads, ps, mus, vs, leaves, tables, fns
        torch.cuda.empty_cache()


def band_grad_library_runs(op, dout, K: int, budget: float):
    """K12's library yardstick in responses mode on dout (B, Hout, Wout,
    C*K): yields (the run's conv_transpose1d as a closure, its latitudes)
    for each run of output latitudes whose input and band output take at
    most ``budget`` bytes, the run's input made as it is yielded; its
    output is (B*C, rows*BL, span), ``chip_smoke.band_grad_case``'s rows of
    those latitudes."""
    from makani_torch.ops.precision import fp32_exact

    dev = dout.device
    B, Hout, Wout, CK = dout.shape
    C = CK // K
    BL, WW, a = op.BL, op.WW, op.stride
    F_ = op.band_filter(0, dev)[..., :K]
    span = (Wout - 1) * a + WW
    per_row = 4 * B * C * (K * Wout + BL * span)
    n = max(1, int(min(budget / per_row, Hout)))
    for h0 in range(0, Hout, n):
        h1 = min(Hout, h0 + n)
        y = dout[:, h0:h1].reshape(B, h1 - h0, Wout, C, K).permute(0, 3, 1, 4, 2).reshape(B * C, (h1 - h0) * K, Wout)
        filt = F_[h0:h1].permute(0, 1, 5, 2, 3, 4).reshape((h1 - h0) * K, BL, WW).contiguous()

        def call(y=y, filt=filt, g=h1 - h0):
            with fp32_exact():
                return torch.nn.functional.conv_transpose1d(y, filt, stride=a, groups=g)

        yield call, (h0, h1)
        del y, filt, call


def k12lib(card: str, dev: torch.device):
    import chip_smoke as cs
    from sweep_k5 import LIBRARY_RUN_BYTES

    gen = torch.Generator(dev).manual_seed(SEED + 16)
    BE = cs.FCN3_TRAIN_BATCH * cs.FCN3_TRAIN_ENSEMBLE
    model = cs.build_fcn31_train(dev)[1]
    for name, conv, _ in cs.fcn31_convs(model.model):
        if name not in ("processor", "decoder"):
            continue
        op = conv.conv_op
        C, K = conv.in_channels, op.K
        dout = randn((BE, *op.out_shape, C * K), torch.float32, gen, dev)
        ms = [time_ms(call, 2, 1) for call, _ in band_grad_library_runs(op, dout, K, LIBRARY_RUN_BYTES)]
        extra = ""
        if name == "processor":
            parts = torch.cat([call() for call, _ in band_grad_library_runs(op, dout, K, LIBRARY_RUN_BYTES)], dim=1)
            ((one, _),) = band_grad_library_runs(op, dout, K, float("inf"))
            err = ((one() - parts).abs().max() / parts.abs().max()).item()
            extra = f"; one call {time_ms(one, 2, 1):.3f} ms, its output within {err:.1e} of max|runs'|"
            del parts, one
        print(f"K12 library fcn31-train-{name}: grouped conv_transpose1d over {len(ms)} run(s) of output latitudes ({op.BL}x{op.WW} band, K {K}, "
              f"B {BE}, C {C}, {op.out_shape} -> {op.in_shape}): {sum(ms):.3f} ms summed (runs {[round(v, 3) for v in ms]}){extra}  [{card}]", flush=True)
        del dout
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_k11_k12: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from makani_torch import kernels

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    kernels.library()
    parts = sys.argv[1:] or ["k11", "k12"]
    if "sass" in parts:
        k12_sass()
    if "k11" in parts:
        k11(card, dev)
    if "k12" in parts:
        k12(card, dev)
    if "k12" in parts or "k12fcn31" in parts:
        k12_fcn31(card, dev)
    if "k12lib" in parts:
        k12lib(card, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
