#!/usr/bin/env python3
"""The measurements behind K4's channel group and K8's weight layout, on one
NVIDIA GPU:

    python3 sweep_k4_k8.py

- K4 (``models/common/layer_norm.py`` ``plan_instance_norm``): the norm at
  every whole-sector channel group from 16 channels to all 384, at the SFNO
  flagship's two bf16 shapes (721x1440 and 240x480), each held to the plain
  version and timed: the plan takes all C channels;
- K8 (``csrc/disco_mix.cu``): the kernel as built, and the same source with
  the weight tiles in the unswizzled core-matrix layout K1 and K3 use, and
  with a three-stage ring, compiled here from patched copies of the source
  (``build/sweep_k4_k8/``, ``patched_libraries``, which ``sweep_k9_k13.py``
  shares), held to cuBLAS and timed in turns at FCN3's
  processor shape, 518400 x 6093 x 677.

Each line names the card and its power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import card_line, errors, randn, time_ms, within

REPO = Path(__file__).resolve().parent

# K8's source, patched: (the text as built, its replacement)
K8_UNSWIZZLED = [
    ("constexpr int SBO = 8 * ROW;", "constexpr int SBO = (BK / 4) * CORE + 16;"),
    ("constexpr int PLANE = BN * ROW;", "constexpr int PLANE = (BN / 8) * SBO;"),
    ("static_assert(A_BYTES % 1024 == 0 && PLANE % 1024 == 0,", "static_assert(true,"),
    ("o * ROW + ((kc ^ o8) << 4)", "(o / 8) * SBO + kc * CORE + o8 * 16"),
    ("descriptor(b_base + ks * 32, 16, SBO) | SWIZZLE_128B", "descriptor(b_base + ks * 2 * CORE, CORE, SBO)"),
    ("descriptor(b_base + PLANE + ks * 32, 16, SBO) | SWIZZLE_128B", "descriptor(b_base + PLANE + ks * 2 * CORE, CORE, SBO)"),
]
K8_STAGES3 = [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")]


def k4_groups(card: str, dev: torch.device):
    from makani_torch.models.common import layer_norm as ln

    gen = torch.Generator(dev).manual_seed(0)
    sms = ln._card(dev.index or 0)["sms"]
    for label, H, W in (("full", 721, 1440), ("internal", 240, 480)):
        C = 384
        x = (3.0 * randn((1, H, W, C), torch.float32, gen, dev) + 1.5).to(torch.bfloat16)
        w = (1.0 + 0.1 * randn((C,), torch.float32, gen, dev)).to(x.dtype)
        b = (0.1 * randn((C,), torch.float32, gen, dev)).to(x.dtype)
        ref = ln.instance_norm_cl_plain(x, w, b)
        chosen = ln.plan_instance_norm(H * W, C, x.element_size(), sms=sms).group
        for group in (16, 32, 64, 128, 192, 384):
            plan = ln.plan_instance_norm(H * W, C, x.element_size(), sms=sms, group=group)
            err = errors(ln.launch_instance_norm(x, w, b, H * W, 1e-6, plan)[0], ref)
            if not within(err, x.dtype):
                raise RuntimeError(f"K4 {label} group {group} disagrees with the plain version: {err}")
            ms = time_ms(lambda: ln.launch_instance_norm(x, w, b, H * W, 1e-6, plan), 20, 3)
            mark = " (the plan's)" if group == chosen else ""
            print(f"K4 {label} bf16 {tuple(x.shape)} group {group:3d}{mark}: {ms:.4f} ms  [{card}]", flush=True)
        del x, ref
        torch.cuda.empty_cache()


def patched_libraries(source: str, variants: dict[str, list[tuple]], out: str) -> dict[str, ctypes.CDLL]:
    """One shared library a patched copy of ``makani_torch/csrc/<source>``
    (``variants``: name -> [(the text as built, its replacement)], or
    [(a header the source includes, the text, its replacement)] for that
    header), built in its own directory under ``build/<out>/`` (the patched
    headers beside the source, found before ``csrc``'s) by one nvcc a
    variant, all started together; prints each one's registers and spills.
    Raises if a patch's text is not in its file or nvcc fails."""
    from makani_torch import kernels

    csrc = REPO / "makani_torch" / "csrc"
    dest = REPO / "build" / out
    procs = {}
    for k, (name, patches) in enumerate(variants.items()):
        vdir = dest / f"{Path(source).stem}_{k}"
        vdir.mkdir(parents=True, exist_ok=True)
        files = {}
        for patch in patches:
            file, old, new = patch if len(patch) == 3 else (source, *patch)
            text = files.get(file, (csrc / file).read_text())
            if old not in text:
                raise RuntimeError(f"{source} variant {name}: {old!r} is not in {file}")
            files[file] = text.replace(old, new)
        files.setdefault(source, (csrc / source).read_text())
        for file, text in files.items():
            (vdir / file).write_text(text)
        cu, so = vdir / source, vdir / f"{Path(source).stem}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", str(csrc), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{source} variant {name}: nvcc failed\n{stderr[-3000:]}")
        regs = [line.split(":", 1)[-1].strip() for line in (stdout + stderr).splitlines() if "registers" in line or "spill" in line]
        print(f"{source} variant {name}: {'; '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def k8_layouts(card: str, dev: torch.device):
    from makani_torch.ops import disco_kernels as dk

    libs = patched_libraries("disco_mix.cu", {"built": [], "unswizzled": K8_UNSWIZZLED, "stages3": K8_STAGES3}, "sweep_k4_k8")
    for lib in libs.values():
        lib.mt_disco_mix.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    R, D, N = 518400, 6093, 677
    gen = torch.Generator(dev).manual_seed(1)
    t2 = randn((R, 6096), torch.float32, gen, dev)[:, :D]
    w = 0.02 * randn((N, D), torch.float32, gen, dev)
    planes = dk.mix_planes(w)
    ref = dk.channel_mix_plain(t2, w)
    out = torch.empty(R, N, device=dev)
    print(f"K8 cuBLAS fp32 {time_ms(lambda: dk.channel_mix_plain(t2, w), 3, 1):.3f} ms  [{card}]", flush=True)
    for name in list(libs) + list(reversed(libs)):
        lib = libs[name]

        def run():
            err = lib.mt_disco_mix(t2.data_ptr(), t2.stride(0), planes.data_ptr(), out.data_ptr(), R, D, N, planes.shape[1], planes.shape[2],
                                   torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"K8 variant {name}: launch failed ({err})")

        run()
        torch.cuda.synchronize()
        err = errors(out, ref)
        if not within(err, torch.float32):
            raise RuntimeError(f"K8 variant {name} disagrees with cuBLAS: {err}")
        print(f"K8 {name:10s} {time_ms(run, 3, 1):.3f} ms, max|d|/max|ref| {err['max_rel']:.2e}  [{card}]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_k4_k8: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from makani_torch import kernels

    card = card_line()
    print(card, flush=True)
    kernels.library()
    dev = torch.device("cuda", 0)
    k4_groups(card, dev)
    k8_layouts(card, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
