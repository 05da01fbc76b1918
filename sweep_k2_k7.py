#!/usr/bin/env python3
"""The measurements behind two constants of the port, on one NVIDIA GPU:

    python3 sweep_k2_k7.py

- ``sht._NARROW_MAX_N``, K2's crossover: both fp32 routes of the Legendre
  synthesis (the narrow kernel that streams the table, the tensor cores on
  the table's TF32 planes) at N = 2C of 16 and 32, on the SFNO's
  full-resolution table and on the FCN3 noise's 721-degree table, each held
  to the plain version and timed in turns (narrow, tc, tc, narrow);
- ``resample._SMEM_BUDGET``, K7's tile width: K7 at every tile width whose
  shared memory fits the card, at the FCN3 atmo and surface decoders, held
  to the plain version and timed.

The wrappers take one route and one width; these launches go to the
library's entry points directly and count no launch. The tables and
resamplers are the models' own, built as ``chip_smoke.py`` builds them.
"""

from __future__ import annotations

import statistics
import sys

import torch

import chip_smoke
from chip_smoke import errors, randn, time_ms, within


def k2_route(c: torch.Tensor, table: torch.Tensor, route: str) -> torch.Tensor:
    """fp32 K2 on ``route`` ("narrow", N <= 32 only, or "tc") at any N."""
    from makani_torch import kernels
    from makani_torch.ops import sht

    M, L, K = table.shape
    N = 2 * c.shape[-2]
    B = c.numel() // (L * M * N)
    out = torch.empty(*c.shape[:-4], K, M, N // 2, 2, dtype=c.dtype, device=c.device)
    lib = kernels.library()
    with torch.cuda.device(c.device):
        stream = kernels.stream_ptr(c.device)
        if route == "narrow":
            err = lib.mt_legendre_synthesis_narrow(table.data_ptr(), c.data_ptr(), out.data_ptr(), B, M, L, K, N, stream)
        else:
            planes = sht.synthesis_planes(table)
            Kp, Lp = planes.shape[2:]
            err = lib.mt_legendre_synthesis_tc(planes.data_ptr(), c.data_ptr(), out.data_ptr(), B, M, L, K, Kp, Lp, N, stream)
    kernels.check_launch(err, f"sht_synthesis ({route})")
    return out


def k7_width(x: torch.Tensor, tables, tw: int) -> torch.Tensor:
    """K7 at ``tw`` output columns per block (one of ``resample._TILE_WIDTHS``)."""
    from makani_torch import kernels
    from makani_torch.ops import resample

    lat_idx, lat_w, lon_idx0, lon_idx1, lon_w = tables
    B, _, Win, C = x.shape
    Hout, Wout = lat_idx.shape[0], lon_idx0.shape[0]
    y = torch.empty(B, Hout, Wout, C, dtype=x.dtype, device=x.device)
    span = resample._spans(lon_idx0, lon_idx1, Win)[tw]
    sB, sH, sW, sC = x.stride()
    with torch.cuda.device(x.device):
        err = kernels.library().mt_resample(
            kernels.dtype_code(x.dtype), x.data_ptr(), y.data_ptr(), lat_idx.data_ptr(), lat_w.data_ptr(), lon_idx0.data_ptr(), lon_idx1.data_ptr(),
            lon_w.data_ptr(), B, Hout, Wout, Win, C, sB, sH, sW, sC, tw, span, kernels.stream_ptr(x.device),
        )
    kernels.check_launch(err, f"resample (tile width {tw})")
    return y


def sweep_k2(table, label, Ns, gen, card):
    """Both routes at each N; the tensor cores get their own copy of the
    table, so its planes leave with it."""
    from makani_torch.ops import sht

    M, L, K = table.shape
    tab = table.clone()
    for N in Ns:
        c = randn((1, L, M, N // 2, 2), torch.float32, gen, table.device)
        ref = sht.synthesis_contract_cl_s_plain(c, table)
        runs = {"narrow": lambda: k2_route(c, table, "narrow"), "tc": lambda: k2_route(c, tab, "tc")}
        ms = {r: [] for r in runs}
        for r in ("narrow", "tc", "tc", "narrow"):
            err = errors(runs[r](), ref)
            if not within(err, torch.float32):
                raise RuntimeError(f"K2 {r} route at {label}, N {N}, disagrees with the plain version: {err}")
            ms[r].append(time_ms(runs[r], 5, 1))
        print(f"K2 routes at {label} (M, L, K) {tuple(table.shape)}, N {N}: narrow {statistics.mean(ms['narrow']):.3f} ms, "
              f"tc {statistics.mean(ms['tc']):.3f} ms (each the mean of two timings; wrapper picks {sht.synthesis_route(N)})  [{card}]", flush=True)
        del c, ref
    del tab
    torch.cuda.empty_cache()


def sweep_k7(rs, x, label, card):
    from makani_torch import kernels
    from makani_torch.ops import resample

    tabs = rs.tables(x.device)
    ref = resample.resample_cl_plain(x, tabs[0].long(), tabs[1], tabs[2].long(), tabs[3].long(), tabs[4])
    spans = resample._spans(tabs[2], tabs[3], x.shape[2])
    line = []
    for tw in resample._TILE_WIDTHS:
        smem = kernels.library().mt_resample_smem_bytes(x.shape[-1], tw, spans[tw])
        if smem > resample._SMEM_MAX:
            continue
        err = errors(k7_width(x, tabs, tw), ref)
        if not within(err, x.dtype):
            raise RuntimeError(f"K7 at tile width {tw} disagrees with the plain version: {err}")
        fits = "fits" if smem <= resample._SMEM_BUDGET else "over"
        line.append(f"TW {tw} (span {spans[tw]}, {smem} B, {fits} the budget) {time_ms(lambda: k7_width(x, tabs, tw), 3, 1):.3f} ms")
    print(f"K7 tile widths at the {label} {tuple(x.shape)} -> {tuple(ref.shape)}: " + "; ".join(line) + f"  [{card}]", flush=True)
    del ref


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_k2_k7: torch.cuda.is_available() is false; this script runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    from makani_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = chip_smoke.device()
    card = chip_smoke.card_line()
    print(card, flush=True)
    kernels.library()
    gen = torch.Generator(dev).manual_seed(chip_smoke.SEED + 7)

    _, model, _, _ = chip_smoke.build_sfno(dev)
    sweep_k2(model.model.itrans_up.pct(dev), "SFNO full res", (16, 32), gen, card)
    del model
    torch.cuda.empty_cache()

    _, model, _, _, noise = chip_smoke.build_fcn3(dev)
    net = model.model
    sweep_k2(noise.isht.pct(dev), "the noise", (16, 32), gen, card)
    dec, sd = net.atmo_decoder, net.surf_decoder
    g, _, ig, _ = dec.conv.weight.shape
    z = randn((chip_smoke.FCN3_ENSEMBLE, net.h, net.w, net.block1.out_chans), torch.float32, gen, dev)
    sweep_k7(dec.resample, z[..., : net.n_atmo_groups * g * ig], "atmo decoder", card)
    sweep_k7(sd.resample, z[..., z.shape[-1] - net.surf_embed_dim :], "surface decoder", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
