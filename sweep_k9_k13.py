#!/usr/bin/env python3
"""Where the time of K9 and K13's transposes goes, on one NVIDIA GPU:

    python3 sweep_k9_k13.py          # all; or name them: k9, k13, k13psi

- K9's tensor-core instructions: the HGMMA opcodes in the SASS of the built
  library's K9 kernels (``cuobjdump -sass``), with their counts;
- K9 (``csrc/dhconv_grad.cu``, the dhconv weight gradient) as built and
  compiled from patched copies of its source (``build/sweep_k9_k13/``,
  ``sweep_k4_k8.patched_libraries``):
  - in other block orders (``LB`` degrees a block, blocks in groups of
    ``LGROUP`` such units), each held bit for bit to the built kernel, in
    fp32 and bf16 at the SFNO training shape and fp32 at FCN3's;
  - with parts of every stage cut out: no wgmma (the staging path alone), no
    bulk copies (the shift tables and the barriers' protocol kept: each lane
    arrives with no bytes), no expansion of gy's blocks, no stores, and all
    four at once (the stage's skeleton: fragment loads and splits, wgmma
    fences, the partial sums, barriers); fp32 at both shapes. A cut
    variant's result is wrong; only its time means anything;
  beside ``torch.bmm`` (``chip_smoke.k9_library``);
- K13's mix-first transpose (``csrc/disco_polar.cu`` mode 3) at the FCN3
  training step's atmo decoder as built (16 steps a thread), with 64 and
  256 steps a thread and with plain stores in place of the streaming ones,
  beside the complex einsum; each variant's result is checked;
- ``k13psi``: K13's psi-first transpose (mode 2) at K 7 at the FCN3.1
  training step's processor and decoder (a run of polar rows, ``chip_smoke.
  check_fcn31_train_kernels``' shapes), and at the decoder's with M 364 and
  368 (dX's rows on 32-byte sectors and 128-byte lines; diagnostics of the
  stores): as built (dY's 7 values of two channels in registers, Psi staged
  by ``cp.async``, the next channels' dY loaded ahead, each channel's modes
  shifted so that dX's stores start on 32-byte sectors, streaming stores),
  and ``K13_PSI_VARIANTS``: the parent's loop (dY read again for every band
  row), the windows not shifted (with one channel a thread too: the first
  K 7 kernel but for its staging), no load ahead, one channel a thread,
  plain stores, and cuts (no Psi staging, no dY loads, no stores), each but
  the cuts held to the plain version, beside the complex einsum; the TB/s
  are dX's bytes over the time.

Times: CUDA events over 10 launches after 2 (``chip_smoke.time_ms``), every
variant timed twice in turns (forward, then backward through the list).
These launches go to the libraries' entry points and count no launch. Each
line names the card and its power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, PEAK_TF32_FLOPS, TF32_PASSES, card_line, k9_library, time_ms
from sweep_k4_k8 import patched_libraries

# K9's block order: (the source's constants, their replacement)
_LB1 = ("constexpr int LB = 2;", "constexpr int LB = 1;")
_ALL = ("constexpr int LGROUP = 4;", "constexpr int LGROUP = 1 << 16;")  # more units than any degree count: the degrees fastest
K9_ORDERS = {
    "1 degree a block, tiles fastest": [_LB1, ("constexpr int LGROUP = 4;", "constexpr int LGROUP = 1;")],
    "1 degree, groups of 8": [_LB1, ("constexpr int LGROUP = 4;", "constexpr int LGROUP = 8;")],
    "1 degree, degrees fastest": [_LB1, _ALL],
    "2 degrees, tiles fastest": [("constexpr int LGROUP = 4;", "constexpr int LGROUP = 1;")],
    "2 degrees, degrees fastest": [_ALL],
}
_K9_CUTS = {
    "mma": ("        wgmma_tf32(part, al[ks], bh, ks > 0);\n        wgmma_tf32(part, ah[ks], bl, 1);\n        wgmma_tf32(part, ah[ks], bh, 1);",
            "        if (B < 0) {\n          wgmma_tf32(part, al[ks], bh, ks > 0);\n          wgmma_tf32(part, ah[ks], bl, 1);\n          wgmma_tf32(part, ah[ks], bh, 1);\n        }"),
    "copy": ("    mbar_arrive_expect_tx(&ready[q], bytes);\n    if (bytes) bulk_copy(dst, src, bytes, &ready[q]);",
             "    mbar_arrive_expect_tx(&ready[q], B < 0 ? bytes : 0);\n    if (bytes && B < 0) bulk_copy(dst, src, bytes, &ready[q]);"),
    "expand": ("      expand(kt + 1);\n", "      if (B < 0) expand(kt + 1);\n"),
    "store": ("    if (i >= Ci) continue;", "    if (i >= Ci || acc[0] != 1234.5f) continue;"),
}
K9_CUTS = {
    "no wgmma": ["mma"],
    "no copies": ["copy"],
    "no expansion": ["expand"],
    "no stores": ["store"],
    "skeleton": ["mma", "copy", "expand", "store"],
}
K13_VARIANTS = {
    "64 steps a thread": [("constexpr int STREAM_STEPS = 16;", "constexpr int STREAM_STEPS = 64;")],
    "256 steps a thread": [("constexpr int STREAM_STEPS = 16;", "constexpr int STREAM_STEPS = 256;")],
    "plain stores": [("      __stcs(reinterpret_cast<float4*>(dU + e), make_float4(a.x, a.y, b.x, b.y));",
                      "      *reinterpret_cast<float4*>(dU + e) = make_float4(a.x, a.y, b.x, b.y);")],
}


# K13's psi-first transpose at K 7: (B, P, BL, C, K, M) of the FCN3.1
# training step's processor and of a run of its decoder's polar rows, and the
# decoder's at Ms whose dX rows start on 32-byte sectors and 128-byte lines
K13_PSI_SHAPES = (("processor", (4, 44, 25, 280, 7, 181)), ("decoder run", (4, 23, 49, 256, 7, 361)),
                  ("decoder run at M 364, dX's rows on 32-byte sectors (a diagnostic)", (4, 23, 49, 256, 7, 364)),
                  ("decoder run at M 368, dX's rows on 128-byte lines (a diagnostic)", (4, 23, 49, 256, 7, 368)))
# the variants; the cuts are timed, not checked
_PSI_STAGE = "    stage_psi_rows(ps, Pt, p, BL * KT, M, m0, pad);"
_PSI_AHEAD = "        if (m >= 0 && m < M) load_dy<KT>(v, dY, bp, c + GRAD_CH * ROWS, c_hi, C, M, m);"
_PSI_STORE = "          if (c + i * ROWS < c_hi) __stcs(x + j * j_stride + (long long)i * ROWS * M, make_float2(re[i], im[i]));"
_PSI_UNSHIFTED = ("return (long long)C * M % 4 == 0 ? GRAD_PAD : 0;", "return 0;")
K13_PSI_VARIANTS = {
    "parent (dY read for every row)": [("    if (K == 7) return launch(psi_first_grad_kernel<7>", "    if (false) return launch(psi_first_grad_kernel<7>")],
    "windows not shifted": [_PSI_UNSHIFTED],
    "windows not shifted, one channel a thread": [_PSI_UNSHIFTED, ("constexpr int GRAD_CH = 2;", "constexpr int GRAD_CH = 1;")],
    "no load ahead": [(_PSI_AHEAD, "        (void)0;"),
                      ("      if (mc < 0 || mc >= M) continue;", "      if (mc < 0 || mc >= M) continue;\n      load_dy<KT>(cur, dY, bp, c, c_hi, C, M, mc);")],
    "one channel a thread": [("constexpr int GRAD_CH = 2;", "constexpr int GRAD_CH = 1;")],
    "plain stores": [(_PSI_STORE, _PSI_STORE.replace("__stcs(x + j * j_stride + (long long)i * ROWS * M, ", "x[j * j_stride + (long long)i * ROWS * M] = ("))],
    "no Psi staging (cut)": [(_PSI_STAGE, "    sm90::cp_async_commit();")],
    "no dY loads (cut)": [("v[i][k] = c + i * ROWS < c_hi ? y[(long long)k * M] : make_float2(0.f, 0.f);", "v[i][k] = make_float2(c + i, k * m);")],
    "no stores (cut)": [(_PSI_STORE, _PSI_STORE.replace("if (c + i * ROWS < c_hi)", "if (re[i] == 1.2345f && c + i * ROWS < c_hi)"))],
}


def k9_sass():
    """Print the distinct HGMMA (wgmma) instructions of each K9 kernel in the
    built library's SASS, with their counts."""
    from makani_torch import kernels

    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(kernels.build())], capture_output=True, text=True, check=True).stdout
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "dhconv_grad_weight" not in name:
            continue
        ops = {}
        for line in part.splitlines():
            words = line.split("*/", 1)[-1].split()  # after the address, past a predicate
            words = words[1:] if words and words[0].startswith("@") else words
            if words and words[0].startswith("HGMMA"):
                ops[words[0]] = ops.get(words[0], 0) + 1
        print(f"K9 SASS {name}: " + (", ".join(f"{op} x {n}" for op, n in sorted(ops.items())) or "no HGMMA"), flush=True)


def in_turns(fns: dict, iters: int = 10, warmup: int = 2) -> dict[str, list[float]]:
    """Each function timed twice, in turns: forward, then backward through
    the list (``chip_smoke.time_ms``)."""
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name].append(time_ms(fns[name], iters, warmup))
    return times


def k9(card: str, dev: torch.device):
    from makani_torch import kernels

    vp, i = ctypes.c_void_p, ctypes.c_int
    libs = {"as built": kernels.library()}
    libs.update(patched_libraries("dhconv_grad.cu", {**K9_ORDERS, **{name: [_K9_CUTS[c] for c in cuts] for name, cuts in K9_CUTS.items()}},
                                  "sweep_k9_k13"))
    for lib in libs.values():
        lib.mt_dhconv_grad_weight.argtypes = [i, vp, vp, vp, i, i, i, i, i, i, vp]
    gen = torch.Generator(dev).manual_seed(0)
    runs = (("SFNO training", (3, 120, 121, 384), torch.float32), ("SFNO training", (3, 120, 121, 384), torch.bfloat16),
            ("FCN3 training", (4, 180, 181, 677), torch.float32))
    for label, (B, L, M, C), dtype in runs:
        x = torch.randn((B, L, M, 1, C, 2), generator=gen, device=dev).to(dtype)
        g = torch.randn((B, L, M, 1, C, 2), generator=gen, device=dev).to(dtype)
        out = torch.empty(1, C, C, L, 2, device=dev)
        names = ["as built", *K9_ORDERS] + (list(K9_CUTS) if dtype == torch.float32 else [])

        def launch(lib):
            err = lib.mt_dhconv_grad_weight(kernels.dtype_code(dtype), x.data_ptr(), g.data_ptr(), out.data_ptr(), B, L, M, 1, C, C, kernels.stream_ptr(dev))
            kernels.check_launch(err, "dhconv_grad_weight (sweep)")

        ref = None
        for name in names:  # a fault names its variant
            print(f"  {label} {dtype}: {name} launches", flush=True)
            launch(libs[name])
            torch.cuda.synchronize()
            if name == "as built":
                ref = out.clone()
            elif name in K9_ORDERS and not torch.equal(out, ref):
                raise RuntimeError(f"K9 in block order '{name}' differs from the built kernel")
        del ref
        fns = {name: (lambda lib=libs[name]: launch(lib)) for name in names}
        fns["torch.bmm"] = k9_library(x, g)
        times = in_turns(fns)
        passes, peak = (TF32_PASSES, PEAK_TF32_FLOPS) if dtype == torch.float32 else (1, PEAK_BF16_FLOPS)
        tc = passes * 8.0 * B * L * M * C * C / peak * 1e3
        print(f"K9 {dtype} at the {label} shape {(B, L, M, 1, C, 2)}, tensor-core operations {tc:.3f} ms (block orders bit-equal): "
              + "; ".join(f"{name} {t[0]:.3f} / {t[1]:.3f} ms" for name, t in times.items()) + f"  [{card}]", flush=True)
        del x, g, out, fns
        torch.cuda.empty_cache()


def k13(card: str, dev: torch.device):
    from makani_torch import kernels
    from makani_torch.ops import disco_kernels

    vp, i = ctypes.c_void_p, ctypes.c_int
    libs = {"as built (16 steps a thread)": kernels.library()}
    libs.update(patched_libraries("disco_polar.cu", K13_VARIANTS, "sweep_k9_k13"))
    for lib in libs.values():
        lib.mt_disco_polar.argtypes = [i, vp, vp, vp, i, i, i, i, i, i, vp]
    B, P, BL, C, K, M = 4, 58, 5, 65, 9, 361
    gen = torch.Generator(dev).manual_seed(1)
    dY = torch.randn((B, P, C, M, 2), generator=gen, device=dev)
    Pt = torch.randn((P, BL, K, M, 2), generator=gen, device=dev)
    out = torch.empty(B, P, BL, C, K, M, 2, device=dev)
    ref = disco_kernels.polar_mix_first_grad_plain(dY, Pt)

    def launch(lib):
        err = lib.mt_disco_polar(3, dY.data_ptr(), Pt.data_ptr(), out.data_ptr(), B, P, BL, C, K, M, kernels.stream_ptr(dev))
        kernels.check_launch(err, "disco_polar_grad (sweep)")

    for name, lib in libs.items():
        launch(lib)
        torch.cuda.synchronize()
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        if not err <= 1e-5:
            raise RuntimeError(f"K13 mix first ({name}) differs from its plain version: {err:.3e} of max|ref|")
    del ref
    torch.cuda.empty_cache()
    Yc, Pc = torch.view_as_complex(dY), torch.view_as_complex(Pt)
    fns = {name: (lambda lib=lib: launch(lib)) for name, lib in libs.items()}
    fns["complex einsum"] = lambda: torch.einsum("bpcm,pjkm->bpjckm", Yc, Pc)
    times = in_turns(fns)
    bound = (dY.numel() + Pt.numel() + out.numel()) * 4 / PEAK_HBM_BYTES * 1e3
    print(f"K13 mix first at the FCN3 training atmo decoder {(B, P, BL, C, K, M)}, bound {bound:.3f} ms (bytes): "
          + "; ".join(f"{name} {t[0]:.3f} / {t[1]:.3f} ms" for name, t in times.items()) + f"  [{card}]", flush=True)


def k13_psi(card: str, dev: torch.device):
    from makani_torch import kernels
    from makani_torch.ops import disco_kernels

    vp, i = ctypes.c_void_p, ctypes.c_int
    libs = {"as built": kernels.library()}
    libs.update(patched_libraries("disco_polar.cu", K13_PSI_VARIANTS, "sweep_k9_k13_psi"))
    for lib in libs.values():
        lib.mt_disco_polar.argtypes = [i, vp, vp, vp, i, i, i, i, i, i, vp]
    gen = torch.Generator(dev).manual_seed(3)
    for label, (B, P, BL, C, K, M) in K13_PSI_SHAPES:
        dY = torch.randn((B, P, C, K, M, 2), generator=gen, device=dev)
        Pt = torch.randn((P, BL, K, M, 2), generator=gen, device=dev)
        out = torch.empty(B, P, BL, C, M, 2, device=dev)
        ref = disco_kernels.polar_psi_first_grad_plain(dY, Pt)

        def launch(lib):
            err = lib.mt_disco_polar(2, dY.data_ptr(), Pt.data_ptr(), out.data_ptr(), B, P, BL, C, K, M, kernels.stream_ptr(dev))
            kernels.check_launch(err, "disco_polar_grad (sweep)")

        for name, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            err = ((out - ref).abs().max() / ref.abs().max()).item()
            if not err <= 1e-5 and not name.endswith("(cut)"):
                raise RuntimeError(f"K13 psi first ({name}) at the {label} differs from its plain version: {err:.3e} of max|ref|")
        del ref
        torch.cuda.empty_cache()
        Yc, Pc = torch.view_as_complex(dY), torch.view_as_complex(Pt)
        fns = {name: (lambda lib=lib: launch(lib)) for name, lib in libs.items()}
        fns["complex einsum"] = lambda: torch.einsum("bpckm,pjkm->bpjcm", Yc, Pc)
        times = in_turns(fns)
        bound = (dY.numel() + Pt.numel() + out.numel()) * 4 / PEAK_HBM_BYTES * 1e3
        print(f"K13 psi first, K 7, at the FCN3.1 training {label} {(B, P, BL, C, K, M)}, bound {bound:.3f} ms (bytes): "
              + "; ".join(f"{name} {t[0]:.3f} / {t[1]:.3f} ms ({out.numel() * 4 / min(t) / 1e9:.3f} TB/s of dX)" for name, t in times.items())
              + f"  [{card}]", flush=True)
        del dY, Pt, out, fns
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_k9_k13: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from makani_torch import kernels

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    kernels.library()
    parts = sys.argv[1:] or ["k9", "k13", "k13psi"]
    if "k9" in parts:
        k9_sass()
        k9(card, dev)
    if "k13" in parts:
        k13(card, dev)
    if "k13psi" in parts:
        k13_psi(card, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
