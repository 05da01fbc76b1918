#!/usr/bin/env python3
"""What bounds K18 and K19 (the AFNO spectral mixer, forward and backward),
on one NVIDIA GPU:

    python3 sweep_k18_k19.py            # the card: SASS, then K18 and K19
    python3 sweep_k18_k19.py k19        # the card: SASS, then K19 alone
    python3 sweep_k18_k19.py parent     # in a git checkout: extract the parent's sources

- the tensor-core instructions: the HGMMA opcodes, with their counts, in the
  SASS of the built library's mode-tile kernels (``afno.cuh``
  ``mixer_tile_kernel``: K18's forward and K19's data pass) and K19's weight
  pass (``afno_grad_weight_kernel``), by ``cuobjdump -sass``;
- the parent's FMA kernels against the new ones, in turns on the same card, at
  ``afno_73ch``'s first mixer (a seeded (1, 90, 180, 768) token grid's rFFT,
  read in place; v1's weights and biases in their flax layout): the parent's
  ``afno_mixer.cu``, ``afno_mixer_grad.cu`` and ``afno.cuh`` as of
  ``PARENT`` (``git show``, written to ``build/sweep_k18_k19/parent/`` by
  the ``parent`` step, which needs the repository's history: run it in a
  checkout before the files go to the card) built into one library there,
  each held to the plain version (FP32_TOL) before it is timed;
- the new kernels compiled from patched copies of their sources
  (``sweep_k4_k8.patched_libraries``, ``build/sweep_k18_k19/``) with parts
  cut out: the wgmmas, the weights' staging (loads and expansion), the A
  operand's loads, the epilogue's stores; K19's data pass or weight pass
  alone, and in the weight pass its copies or g's expansion; and K18 with
  one-warpgroup blocks (64 modes). A cut variant's result is wrong; only its
  time means anything;
  beside the ``torch.bmm`` yardsticks (``chip_smoke.mixer_library``,
  ``mixer_grad_library``) and the bounds.

Times: CUDA events over 10 launches after 2 (``chip_smoke.time_ms``), each
variant timed twice in turns (``sweep_k9_k13.in_turns``: forward, then
backward through the list). These launches go to the libraries' entry
points and count no launch. Each line names the card and its power limit.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import FP32_TOL, PEAK_FP32_FLOPS, PEAK_TF32_FLOPS, TF32_PASSES, card_line, errors, mixer_grad_library, mixer_library
from sweep_k4_k8 import patched_libraries
from sweep_k9_k13 import in_turns

REPO = Path(__file__).resolve().parent
PARENT = "9bed14e7996e33d989046c8d61786ad3f0ab88ae"  # the FMA kernels' last commit
PARENT_DIR = REPO / "build" / "sweep_k18_k19" / "parent"
PARENT_FILES = ("afno_mixer.cu", "afno_mixer_grad.cu", "afno.cuh")

# cuts of the mode-tile kernel (afno.cuh): (file, the text as built, its replacement)
_TILE = {
    "mma": ("afno.cuh", "      wgmma_n96(part, al[ks], bh, ks > 0);\n      wgmma_n96(part, ah[ks], bl, 1);\n      wgmma_n96(part, ah[ks], bh, 1);",
            "      if (M < 0) {\n        wgmma_n96(part, al[ks], bh, ks > 0);\n        wgmma_n96(part, ah[ks], bl, 1);\n        wgmma_n96(part, ah[ks], bh, 1);\n      }"),
    "stage": ("afno.cuh", "    if (more) stage_w(kt + 1);", "    if (more && M < 0) stage_w(kt + 1);"),
    "copy_w": ("afno.cuh", "          const bool ok = n < width && d < depth;", "          const bool ok = n < width && d < depth && M < 0;"),
    "fetch_a": ("afno.cuh", "    if (more && kt + 1 < n1) fetch_a(st + 1 < S1 ? st + 1 : 0);", "    if (more && kt + 1 < n1 && M < 0) fetch_a(st + 1 < S1 ? st + 1 : 0);"),
    "store": ("afno.cuh", "        *reinterpret_cast<float2*>(t.out + b * t.lo.sB", "        if (M < 0) *reinterpret_cast<float2*>(t.out + b * t.lo.sB"),
    "store_h": ("afno.cuh", "          if (t.hout != nullptr && ok) *reinterpret_cast", "          if (t.hout != nullptr && ok && M < 0) *reinterpret_cast"),
    "one_wg": ("afno.cuh", "return tile_smem_bytes(bs, hbs, 2) <= SMEM_MAX ? 2 :", "return false ? 2 :"),
}
K18_VARIANTS = {
    "no wgmma": [_TILE["mma"]],
    "no weight copies": [_TILE["copy_w"]],
    "no weight expansion": [_TILE["stage"]],
    "no x loads": [_TILE["fetch_a"]],
    "no stores": [_TILE["store"], _TILE["store_h"]],
    "one warpgroup a block": [_TILE["one_wg"]],
}
# cuts of K19 (afno_mixer_grad.cu) and of its data pass (afno.cuh)
_GRAD = {
    "data_only": [("  afno_grad_weight_kernel<<<dim3(", "  if (M < 0) afno_grad_weight_kernel<<<dim3("),
                  ("  afno_grad_reduce_kernel<<<", "  if (M < 0) afno_grad_reduce_kernel<<<")],
    "weight_only": [("  int err = afno::launch_tile<afno::DATA_GRAD>(t,", "  int err = 0;\n  if (M < 0) err = afno::launch_tile<afno::DATA_GRAD>(t,")],
    "w_mma": [("      afno::wgmma_n96(part, al[ks], bh, ks > 0);\n      afno::wgmma_n96(part, ah[ks], bl, 1);\n      afno::wgmma_n96(part, ah[ks], bh, 1);",
               "      if (M < 0) {\n        afno::wgmma_n96(part, al[ks], bh, ks > 0);\n        afno::wgmma_n96(part, ah[ks], bl, 1);\n        afno::wgmma_n96(part, ah[ks], bh, 1);\n      }")],
    "w_copy": [("    const bool ok = q < q_hi;", "    const bool ok = q < q_hi && M < 0;")],
    "w_expand": [("      expand(kt + 1);\n", "      if (M < 0) expand(kt + 1);\n")],
}
K19_VARIANTS = {
    "data pass alone": _GRAD["data_only"],
    "data pass alone, no wgmma": _GRAD["data_only"] + [_TILE["mma"]],
    "data pass alone, no weight copies or expansion": _GRAD["data_only"] + [_TILE["copy_w"], _TILE["stage"]],
    "weight pass alone (and its sum)": _GRAD["weight_only"],
    "weight pass alone, no wgmma": _GRAD["weight_only"] + _GRAD["w_mma"],
    "weight pass alone, no copies": _GRAD["weight_only"] + _GRAD["w_copy"],
    "weight pass alone, no expansion": _GRAD["weight_only"] + _GRAD["w_expand"],
    "weight pass skeleton (no wgmma, copies, expansion)": _GRAD["weight_only"] + _GRAD["w_mma"] + _GRAD["w_copy"] + _GRAD["w_expand"],
}


def extract_parent():
    """Write the parent's mixer sources to PARENT_DIR (``git show``)."""
    PARENT_DIR.mkdir(parents=True, exist_ok=True)
    for name in PARENT_FILES:
        text = subprocess.run(["git", "show", f"{PARENT}:makani_torch/csrc/{name}"], cwd=REPO, capture_output=True, text=True, check=True).stdout
        (PARENT_DIR / name).write_text(text)
    print(f"the parent's sources ({PARENT[:7]}) in {PARENT_DIR}", flush=True)


def parent_library() -> ctypes.CDLL:
    """The parent's K18 and K19, built into one library in PARENT_DIR."""
    from makani_torch import kernels

    if not all((PARENT_DIR / name).exists() for name in PARENT_FILES):
        raise RuntimeError(f"no parent sources in {PARENT_DIR}: run `python3 sweep_k18_k19.py parent` in a checkout first")
    so = PARENT_DIR / "parent.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", str(REPO / "makani_torch" / "csrc"), "-o", str(so),
           str(PARENT_DIR / "afno_mixer.cu"), str(PARENT_DIR / "afno_mixer_grad.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"the parent's kernels: nvcc failed\n{res.stderr[-3000:]}")
    regs = [line.split(":", 1)[-1].strip() for line in (res.stdout + res.stderr).splitlines() if "registers" in line or "spill" in line]
    print(f"parent's K18/K19: {'; '.join(regs)}", flush=True)
    lib = ctypes.CDLL(str(so))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mt_afno_mixer.argtypes = [vp] * 7 + [ctypes.POINTER(ll)] + [i] * 6 + [ll] * 3 + [i] * 5 + [ctypes.c_float, vp]
    lib.mt_afno_mixer_grad.argtypes = [vp] * 6 + [ctypes.POINTER(ll)] + [vp] * 7 + [i] * 7 + [ll] * 3 + [i] * 5 + [vp]
    lib.mt_afno_grad_scratch.argtypes = [i] * 5
    lib.mt_afno_grad_scratch.restype = ll
    return lib


def sass():
    """Print the distinct HGMMA instructions, with their counts, of each AFNO
    kernel in the built library's SASS."""
    from makani_torch import kernels

    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(kernels.build())], capture_output=True, text=True, check=True).stdout
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "mixer_tile_kernel" not in name and "afno_grad" not in name:
            continue
        ops, mix = {}, {}
        for line in part.splitlines():
            words = line.split("*/", 1)[-1].split()
            words = words[1:] if words and words[0].startswith("@") else words
            if not words or not words[0][:1].isupper():
                continue
            if words[0].startswith("HGMMA"):
                ops[words[0]] = ops.get(words[0], 0) + 1
            op = words[0].split(".")[0]
            mix[op] = mix.get(op, 0) + 1
        print(f"SASS {name}: " + (", ".join(f"{op} x {n}" for op, n in sorted(ops.items())) or "no HGMMA"), flush=True)
        top = sorted(mix.items(), key=lambda kv: -kv[1])[:24]
        print(f"  instructions {sum(mix.values())}: " + ", ".join(f"{op} {n}" for op, n in top), flush=True)


def inputs(dev):
    """afno_73ch's first mixer: the rFFT of a seeded token grid (read in
    place), v1's weights and biases as (nb, 2, ...) views of the flax layout."""
    from makani_torch.ops import afno_mixer as am
    from makani_torch.ops.fft_compat import rfft2_s

    gen = torch.Generator(dev).manual_seed(18)
    x2 = rfft2_s(torch.randn((1, 90, 180, 768), generator=gen, device=dev), axes=(1, 2), norm="ortho")
    w1, w2 = (0.02 * torch.randn((2, 8, 96, 96), generator=gen, device=dev)).transpose(0, 1), (0.02 * torch.randn((2, 8, 96, 96), generator=gen, device=dev)).transpose(0, 1)
    b1, b2 = (0.02 * torch.randn((2, 8, 96), generator=gen, device=dev)).transpose(0, 1), (0.02 * torch.randn((2, 8, 96), generator=gen, device=dev)).transpose(0, 1)
    return x2, w1, b1, w2, b2, 0.01, am.band_v1(90, 91, 1.0)


def k18(card: str, dev, parent):
    from makani_torch import kernels
    from makani_torch.ops import afno_mixer as am

    x2, w1, b1, w2, b2, lam, band = inputs(dev)
    (sB, sM, sC), (B, H, Wh, C, nb, bs, hbs) = am._check(x2, w1, b1, w2, b2)
    strides = am._param_strides(w1, b1, w2, b2)
    y = torch.empty_like(x2)
    ref = am.afno_mixer_plain(x2, w1, b1, w2, b2, lam, band)
    libs = {"as built": kernels.library()}
    libs.update(patched_libraries("afno_mixer.cu", K18_VARIANTS, "sweep_k18_k19"))
    for lib in list(libs.values())[1:]:
        lib.mt_afno_mixer.argtypes = kernels.library().mt_afno_mixer.argtypes

    def launch(lib):
        err = lib.mt_afno_mixer(x2.data_ptr(), y.data_ptr(), None, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), strides, B, H * Wh, Wh, nb, bs, hbs,
                                sB, sM, sC, *band.args(), lam, kernels.stream_ptr(dev))
        kernels.check_launch(err, "afno_mixer (sweep)")

    fns = {}
    for name, lib in [("parent (FMA)", parent)] + list(libs.items()):
        launch(lib)
        torch.cuda.synchronize()
        if name in ("parent (FMA)", "as built", "one warpgroup a block"):
            err = errors(y, ref)["max_rel"]
            print(f"K18 {name}: max|d|/max|ref| {err:.3e}", flush=True)
            if not err <= FP32_TOL:
                raise RuntimeError(f"K18 {name} disagrees with the plain version: {err:.3e}")
        fns[name] = lambda lib=lib: launch(lib)
    fns["torch.bmm"] = mixer_library(x2, w1, b1, w2, b2, lam, band)
    times = in_turns(fns)
    flops = 8.0 * 2 * B * H * Wh * nb * bs * hbs
    tc, fma = TF32_PASSES * flops / PEAK_TF32_FLOPS * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    print(f"K18 at afno_73ch {tuple(x2.shape)}, tensor-core bound {tc:.3f} ms, FMA {fma:.3f} ms: "
          + "; ".join(f"{name} {t[0]:.4f} / {t[1]:.4f} ms" for name, t in times.items()) + f"  [{card}]", flush=True)


def k19(card: str, dev, parent):
    from makani_torch import kernels
    from makani_torch.ops import afno_mixer as am

    x2, w1, b1, w2, b2, lam, band = inputs(dev)
    (sB, sM, sC), (B, H, Wh, C, nb, bs, hbs) = am._check(x2, w1, b1, w2, b2)
    M = H * Wh
    strides = am._param_strides(w1, b1, w2, b2)
    y, h = am.launch_afno_mixer(x2, w1, b1, w2, b2, lam, band, keep_hidden=True)
    h_old = h.contiguous()  # the parent's (B, nb, M, hbs, 2)
    # dy as the model's backward gives it: in the rFFT's strides (the parent's
    # kernels take no others)
    dy = torch.empty_like(x2).copy_(torch.randn(tuple(y.shape), generator=torch.Generator(dev).manual_seed(19), device=dev))
    refs = am.afno_mixer_grad_plain(x2, y, dy, h, w1, b1, w2, b2)
    dx, g1 = torch.empty_like(x2), am.hidden_like(B, nb, M, hbs, dev)
    dws = [torch.empty_strided(t.shape, t.stride(), device=dev) for t in (w1, b1, w2, b2)]
    S_new = am.grad_splits(B, M, nb, bs, hbs, am._sms(dev.index or 0))
    tiles = math.ceil(bs / 32) * math.ceil(hbs / 32) * nb * 2
    S_old = max(1, min(math.ceil(B * M / 32), math.ceil(8 * am._sms(dev.index or 0) / tiles), 32767))
    scratch = torch.empty(max(kernels.library().mt_afno_grad_scratch(S, nb, bs, hbs, 1) for S in (S_new, S_old)), device=dev)
    libs = {"as built": kernels.library()}
    libs.update(patched_libraries("afno_mixer_grad.cu", K19_VARIANTS, "sweep_k18_k19"))
    for lib in list(libs.values())[1:]:
        lib.mt_afno_mixer_grad.argtypes = kernels.library().mt_afno_mixer_grad.argtypes

    def launch(lib, old=False):
        args = [x2.data_ptr(), y.data_ptr(), dy.data_ptr(), (h_old if old else h).data_ptr(), w1.data_ptr(), w2.data_ptr(), strides, dx.data_ptr(), g1.data_ptr(),
                dws[0].data_ptr(), dws[1].data_ptr(), dws[2].data_ptr(), dws[3].data_ptr(), scratch.data_ptr(), S_old if old else S_new, B, M, Wh, nb, bs, hbs,
                sB, sM, sC] + ([] if old else list(dy.stride()[i] for i in (0, 2, 3))) + [*band.args(), kernels.stream_ptr(dev)]
        kernels.check_launch(lib.mt_afno_mixer_grad(*args), "afno_mixer_grad (sweep)")

    fns = {}
    for name, lib, old in [("parent (FMA)", parent, True)] + [(n, lib, False) for n, lib in libs.items()]:
        launch(lib, old)
        torch.cuda.synchronize()
        if name in ("parent (FMA)", "as built"):
            errs = {n: errors(o, r)["max_rel"] for n, o, r in zip(("dx", "dw1", "db1", "dw2", "db2"), [dx] + dws, refs)}
            print(f"K19 {name} (S {S_old if old else S_new}): " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()), flush=True)
            if not max(errs.values()) <= FP32_TOL:
                raise RuntimeError(f"K19 {name} disagrees with the plain version: {errs}")
        fns[name] = lambda lib=lib, old=old: launch(lib, old)
    fns["torch.bmm"] = mixer_grad_library(x2, y, dy, h, w1, w2, True)
    times = in_turns(fns)
    flops = 2 * 8.0 * 2 * B * M * nb * bs * hbs
    tc, fma = TF32_PASSES * flops / PEAK_TF32_FLOPS * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    print(f"K19 at afno_73ch {tuple(x2.shape)}, tensor-core bound {tc:.3f} ms, FMA {fma:.3f} ms: "
          + "; ".join(f"{name} {t[0]:.4f} / {t[1]:.4f} ms" for name, t in times.items()) + f"  [{card}]", flush=True)


def main() -> int:
    if sys.argv[1:] == ["parent"]:
        extract_parent()
        return 0
    if not torch.cuda.is_available():
        print("sweep_k18_k19: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from makani_torch import kernels

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    kernels.library()
    sass()
    parent = parent_library()
    if sys.argv[1:] != ["k19"]:
        k18(card, dev, parent)
    k19(card, dev, parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
