#!/usr/bin/env python3
"""K14's plan and design, measured on one NVIDIA GPU:

    python3 sweep_k14.py          # both decoders; or name one: atmo, surf

K14 (``csrc/resample_grad.cu``, the plan ``ops/resample.py``
``plan_resample_grad``) at the FCN3 training step's two decoder shapes,
dy (4, 361, 720, 585) and (4, 361, 720, 56) -> dx on the 180 x 360
Legendre-Gauss grid:

- the plan's grid: tile widths (channel chunks), strip heights and ring depths, launched
  from the built library's entry point, each held bit for bit to the
  wrapper's default plan (the same sums in the same order);
- patched copies of the source (``build/sweep_k14/``,
  ``sweep_k4_k8.patched_libraries``) at the default plan: each piece copied
  by 16-byte cp.async, every thread a share, with no mbarrier, in place of
  the bulk copies (held bit for bit), and three cuts: no compute (one
  shared load a unit a row, no entries, in place of the column sums), no dy
  loads (no copies and no compute: the stores alone), no stores (copies and
  compute, nothing written);
- the yardstick: the wrapper's call over 3 launches after 1 and over 10
  after 2, right after the plain version has run, after the card has
  idled for half a second, and after ``torch.cuda.empty_cache()``, in
  turns; then ``chip_smoke.py``'s own K14 case (``run_cases``, its library
  call included) at both counts, twice.

Beside each plan: the bytes it stages (dy with the column and strip halos)
and the floor that is at HBM's rate with dx's bytes, and the bound (dy read
once, dx written once).

Times: CUDA events (``chip_smoke.time_ms``), every line timed twice in turns
(forward, then backward through the list). The launches go to the
libraries' entry points and count no launch. Each line names the card and
its power limit.
"""

from __future__ import annotations

import ctypes
import sys
import time

import torch

from chip_smoke import PEAK_HBM_BYTES, bound, card_line, errors, nbytes, randn, resample_grad_case, run_cases, time_ms, within
from sweep_k4_k8 import patched_libraries
from sweep_k9_k13 import in_turns

# K14's source, patched: (the text as built, its replacement)
_BULK = """    if (tid == 0) {
      int bytes = 0;
      for (int k = 0; k < np; ++k) bytes += 16 * (((int)((row + pieces[3 * k]) & 3) + pieces[3 * k + 1]) / 4);
      sm90::fence_proxy_async();  // the slot's earlier reads before the copy engine's writes
      sm90::mbar_arrive_expect_tx(&bars[slot], bytes);
      for (int k = 0; k < np; ++k) {
        const long long g = row + pieces[3 * k];
        const int lead = (int)(g & 3), whole = (lead + pieces[3 * k + 1]) / 4;
        if (whole > 0) sm90::bulk_copy(dst + pieces[3 * k + 2], dy + (g - lead), 16 * whole, &bars[slot]);
      }
    }
    for (int k = tid; k < np; k += THREADS) {
      const long long g = row + pieces[3 * k];
      const int lead = (int)(g & 3), whole = (lead + pieces[3 * k + 1]) / 4, rest = (lead + pieces[3 * k + 1]) % 4;
      if (rest > 0) sm90::cp_async_zfill16(dst + pieces[3 * k + 2] + 4 * whole, dy + (g - lead) + 4 * whole, 4 * rest);
    }
"""
_CP_ASYNC = """    for (int k = 0; k < np; ++k) {
      const long long g = row + pieces[3 * k];
      const int lead = (int)(g & 3), bytes = 4 * (lead + pieces[3 * k + 1]);
      const float* src = dy + (g - lead);
      float* d = dst + pieces[3 * k + 2];
      for (int q = tid; 16 * q < bytes; q += THREADS) sm90::cp_async_zfill16(d + 4 * q, src + 4 * q, min(16, bytes - 16 * q));
    }
"""
_WAIT = "    sm90::mbar_wait(&bars[slot], (n / p.ring) & 1);\n"
_ENTRY = "        const int2 e = ent[c * p.kt_max + k];"
_NO_COMPUTE = [("    for (int k = 0; k < kt; ++k) {\n#pragma unroll\n      for (int c = 0; c < NC; ++c) {",
                "    for (int k = 0; k < 1; ++k) {\n#pragma unroll\n      for (int c = 0; c < NC; ++c) {"),
               (_ENTRY, "        const int2 e = make_int2(0, 0);")]
_NO_COPIES = [
    ("      sm90::mbar_arrive_expect_tx(&bars[slot], bytes);", "      sm90::mbar_arrive_expect_tx(&bars[slot], 0);"),
    ("        if (whole > 0) sm90::bulk_copy(dst + pieces[3 * k + 2], dy + (g - lead), 16 * whole, &bars[slot]);", "        (void)whole;"),
    ("      if (rest > 0) sm90::cp_async_zfill16(dst + pieces[3 * k + 2] + 4 * whole, dy + (g - lead) + 4 * whole, 4 * rest);", "      (void)rest;"),
]
_PUT = "__device__ __forceinline__ void put(float* p, float v) { *p = v; }"
_NAN = "0x7fc00001u"  # a NaN payload no sum makes: the stores stay in the code, none runs
VARIANTS = {
    "cp.async copies": ("same", [(_BULK, _CP_ASYNC), (_WAIT, "")]),
    "no compute": ("cut", _NO_COMPUTE),
    "no dy loads (stores only)": ("cut", [*_NO_COMPUTE, *_NO_COPIES]),
    "no stores": ("cut", [(_PUT, _PUT.replace("{ *p = v; }", f"{{ if (__float_as_uint(v) == {_NAN}) *p = v; }}"))]),
}

# (label, channels, (tile width, channel chunk) pairs, strip rows, rings)
SHAPES = {"atmo": ("atmo decoder", 585, ((8, None), (8, 320), (16, 256)), (15, 30, 45), (2, 3, 4)),
          "surf": ("surface decoder", 56, ((8, None), (16, None), (32, None), (64, None)), (4, 8, 16), (2, 3, 4))}
B = 4


def staged_bytes(plan) -> int:
    """The dy bytes a launch of ``plan`` copies into shared memory (without
    the aligned floors' few extra bytes a piece)."""
    rows = int((plan.strips()[:, 3] - plan.strips()[:, 2]).sum())
    per_row = sum(4 * int(rec[8 + 3 * k + 1]) for rec in plan.records() for k in range(int(rec[4])))
    return B * rows * per_row


def sweep(name: str, card: str, dev: torch.device, libs: dict):
    from makani_torch import kernels
    from makani_torch.ops import resample

    label, C, tiles, strip_rows, rings = SHAPES[name]
    rs = resample.ResampleS2(180, 360, 361, 720, grid_in="legendre-gauss", grid_out="equiangular")
    Hin, Win = rs.in_shape
    Hout, Wout = rs.out_shape
    li, lw, k0, k1, v = rs.tables(dev)
    gen = torch.Generator(dev).manual_seed(0)
    dy = randn((B, Hout, Wout, C), torch.float32, gen, dev)
    dx = torch.empty(B, Hin, Win, C, device=dev)
    ref = resample.resample_cl_grad_plain(dy, rs.in_shape, li.long(), lw, k0.long(), k1.long(), v)
    built = resample.resample_cl_grad(dy, rs)
    err = errors(built, ref)
    if not within(err, torch.float32):
        raise RuntimeError(f"K14 {label}: the wrapper's launch disagrees with the plain version: {err}")
    del ref
    torch.cuda.empty_cache()
    yard = bound(6.0 * dy.numel(), nbytes(dy, dx))
    default = rs.grad_plan(dev, C, B)
    tables = (rs.lat_idx, rs.lat_w, rs.lon_idx0, rs.lon_idx1, rs.lon_w)

    def launch(lib, plan):
        kernels.check_launch(lib.mt_resample_grad(dy.data_ptr(), dx.data_ptr(), li.data_ptr(), lw.data_ptr(), plan.table_on(dev).data_ptr(), B, Hin, Win,
                                                  Hout, Wout, C, plan.tile_width, plan.ring, plan.columns, plan.groups, plan.kt_max, plan.pieces_max, plan.slot_floats,
                                                  plan.record_ints, plan.n_records, plan.n_strips, plan.smem_bytes, kernels.stream_ptr(dev)),
                            "resample_grad (sweep)")

    def same(lib, plan, what):
        dx.fill_(float("nan"))
        launch(lib, plan)
        torch.cuda.synchronize()
        if not torch.equal(dx, built):
            raise RuntimeError(f"K14 {label} {what}: not bit-equal to the wrapper's launch")

    plans = {"the default": default}
    for tw, chunk in tiles:
        for rows in strip_rows:
            for ring in rings:
                what = f"tile {tw}{f' x {chunk} channels' if chunk else ''}, strips of {rows}, ring {ring}"
                try:
                    plans[what] = resample.plan_resample_grad(*tables, rs.in_shape, C, B, tile_width=tw, channel_chunk=chunk, strip_rows=rows, ring=ring)
                except ValueError as e:
                    print(f"K14 {label} {what}: {e}", flush=True)
    for what, plan in plans.items():
        same(libs["as built"], plan, what)
    print(f"K14 {label} dy {tuple(dy.shape)}: the wrapper's plan {default.describe()}; max|d|/max|ref| {err['max_rel']:.2e}; bound "
          f"{yard['bound_ms']:.4f} ms ({yard['bound_by']}); every plan below bit-equal to it  [{card}]", flush=True)
    times = in_turns({what: (lambda plan=plan: launch(libs["as built"], plan)) for what, plan in plans.items()}, 5, 1)
    for what, plan in plans.items():
        staged = staged_bytes(plan)
        floor = 1e3 * (staged + nbytes(dx)) / PEAK_HBM_BYTES
        print(f"K14 {label} {what}: {plan.describe()}; {B * plan.n_records * plan.n_strips} blocks; staged {staged / 1e9:.3f} GB (floor "
              f"{floor:.4f} ms); {times[what][0]:.4f} / {times[what][1]:.4f} ms  [{card}]", flush=True)

    for what, (check, _) in VARIANTS.items():
        if check == "same":
            same(libs[what], default, what)
    fns = {"as built": lambda: launch(libs["as built"], default)}
    fns.update({what: (lambda lib=libs[what]: launch(lib, default)) for what in VARIANTS})
    times = in_turns(fns, 5, 1)
    print(f"K14 {label} at the default plan: " + "; ".join(f"{what} {t[0]:.4f} / {t[1]:.4f} ms" for what, t in times.items())
          + f"; bound {yard['bound_ms']:.4f} ms  [{card}]", flush=True)

    # the yardstick: the wrapper's call after the plain version, after the card idled, after the allocator's cache was emptied
    def plain():
        resample.resample_cl_grad_plain(dy, rs.in_shape, li.long(), lw, k0.long(), k1.long(), v)
        torch.cuda.synchronize()

    def idle():
        torch.cuda.synchronize()
        time.sleep(0.5)

    def emptied():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    kern = lambda: resample.resample_cl_grad(dy, rs)
    yards = {f"{iters} after {warmup}, {before.__name__}": (before, iters, warmup) for before in (plain, idle, emptied) for iters, warmup in ((3, 1), (10, 2))}
    got = {what: [] for what in yards}
    for _ in range(3):
        for what, (before, iters, warmup) in yards.items():
            before()
            got[what].append(time_ms(kern, iters, warmup))
    print(f"K14 {label} yardstick, the wrapper's call: " + "; ".join(f"{what} {' / '.join(f'{t:.4f}' for t in ts)} ms" for what, ts in got.items())
          + f"  [{card}]", flush=True)
    for iters, warmup in ((3, 1), (10, 2), (3, 1), (10, 2)):
        print(f"K14 {label} yardstick, chip_smoke.py's case over {iters} launches after {warmup}:", flush=True)
        run_cases([resample_grad_case(rs, dy, label)], card, {}, iters, warmup)
    del dy, dx, built
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_k14: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from makani_torch import kernels

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = {"as built": kernels.library()}
    libs.update(patched_libraries("resample_grad.cu", {name: patches for name, (_, patches) in VARIANTS.items()}, "sweep_k14"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.mt_resample_grad.argtypes = [vp] * 5 + [i] * 17 + [vp]
    for name in sys.argv[1:] or list(SHAPES):
        sweep(name, card, dev, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
