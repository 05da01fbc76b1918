#!/usr/bin/env python3
"""K3's input gradient and K10's two designs, measured on one NVIDIA GPU:

    python3 sweep_k3dx_k10.py          # both; or name one: k3dx, k10

- K3's dx (``csrc/dhconv.cu`` in its input-gradient mode,
  ``contractions.dhconv_grad_input``) at the SFNO and FCN3 training steps'
  shapes, fp32 (and bf16 at the SFNO's): as built, reading the forward's
  cached weight (``_PermutedWeight``), its weight loads 4 lanes along a
  column (32-byte runs in fp32); a patched copy of ``dhconv.cu``
  (``K3_VARIANTS``) whose loads run 8 lanes along a column (64-byte runs)
  into core matrices 144 bytes apart (so that the stores keep to two lanes
  a bank); the parent's way, the conjugate-transposed weight built on every
  call and K3's forward mode run on it; that build alone; K3's forward at
  the same shape; and the complex ``torch.bmm`` on prebuilt operands
  (``chip_smoke.dhconv_extras``). The built kernel is held to the plain
  version, the variant and the parent's way to it bit for bit (the same
  sums in the same order).
- K10 (``csrc/instance_norm.cu``, ``layer_norm.plan_instance_norm_grad``) at
  the SFNO training step's two bf16 shapes, (3, 361, 720, 384) and (3, 120,
  240, 384): every sample in one round (two grid barriers a launch, the
  plan's) and the samples walked one a round (the first design); and
  patched copies of the source (``build/sweep_k3dx_k10/``,
  ``sweep_k4_k8.patched_libraries``): rings of 4, 6 and 10 slots a thread
  (8 built: 7 pixels of x and g in flight), a launch bound of 480 threads
  in place of 512 (136 registers a thread in place of 128: the plan's 480
  threads fit it at these shapes), and two cuts, no compute (no
  division or bf16 rounding: the copies, sums and stores kept) and no
  second read (pass 2 starts no copies and reads stale slots). A depth is
  held bit for bit to the plan's launch (the same sums in the same order);
  the walk (other slices, so other partials) to the plain version; a cut
  to nothing. Beside them: the one-read bound and the two-read floor at
  HBM's rate, and the loads in flight a block.

Times: CUDA events (``chip_smoke.time_ms``), every variant timed twice in
turns (forward, then backward through the list). The launches go to the
libraries' entry points and count no launch. Each line names the card and
its power limit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import sys

import torch

from chip_smoke import PEAK_HBM_BYTES, bound, card_line, dhconv_extras, errors, nbytes, randn, within
from sweep_k4_k8 import patched_libraries
from sweep_k9_k13 import in_turns

# K3's source, patched
K3_VARIANTS = {
    "64-byte runs": [
        ("  auto w_o = [&](int e) { return warp * 8 + (GRAD_INPUT ? lane / 4 : lane % 8); };",
         "  auto w_o = [&](int e) { return warp * 8 + (GRAD_INPUT ? lane / 8 + 4 * (e / 2) : lane % 8); };"),
        ("  auto w_i = [&](int e) { return (GRAD_INPUT ? lane % 4 : lane / 8) + 4 * e; };",
         "  auto w_i = [&](int e) { return GRAD_INPUT ? lane % 8 + 8 * (e % 2) : lane / 8 + 4 * e; };"),
        ("static constexpr int LBO = CORE;", "static constexpr int LBO = CORE + 16;"),  # (the forward's too: not timed here)
    ],
}

# K10's source, patched: (the text as built, its replacement)
_RING = "constexpr int RING = 8;"
K10_VARIANTS = {
    "ring of 4": ("same", [(_RING, "constexpr int RING = 4;")]),
    "ring of 6": ("same", [(_RING, "constexpr int RING = 6;")]),
    "ring of 10": ("same", [(_RING, "constexpr int RING = 10;")]),
    "480 threads at most (136 registers)": ("same", [("__launch_bounds__(MAX_THREADS, 1)\n    instance_norm_grad_kernel(",
                                                      "__launch_bounds__(480, 1)\n    instance_norm_grad_kernel(")]),
    "no compute": ("cut", [("      z = __fdiv_rn(__fsub_rn(xv, mu[v]), sd[v]);", "      z = __fsub_rn(xv, mu[v]);"),
                           ("      if constexpr (sizeof(T) == 2) {\n        dz = ", "      if constexpr (false) {\n        dz = "),
                           ("        out[v] = __fdiv_rn(__fsub_rn(__fsub_rn(dz, av), __fmul_rn(z, cv_)), sd[v]);",
                            "        out[v] = __fsub_rn(__fsub_rn(dz, av), __fmul_rn(z, cv_));")]),
    "no second read": ("cut", [("    for (int k = nk - 1; k > nk - RING; --k) copy_pixel(k);", "    for (int k = nk - 1; k > nk - RING; --k) sm90::cp_async_commit();"),
                               ("      copy_pixel(k - RING + 1);", "      sm90::cp_async_commit();")]),
}


def k3dx(card: str, dev: torch.device):
    from makani_torch import kernels
    from makani_torch.models.common.contractions import _PermutedWeight, dhconv_contract_cl_s, dhconv_grad_input, dhconv_grad_input_plain

    lib = kernels.library()
    wide = patched_libraries("dhconv.cu", K3_VARIANTS, "sweep_k3dx_k10")["64-byte runs"]
    wide.mt_dhconv_grad_input.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    gen = torch.Generator(dev).manual_seed(0)
    runs = (("SFNO training", (3, 120, 121, 384), torch.float32), ("SFNO training", (3, 120, 121, 384), torch.bfloat16),
            ("FCN3 training", (4, 180, 181, 677), torch.float32))
    for label, (B, L, M, C), dtype in runs:
        w = randn((1, C, C, L, 2), torch.float32, gen, dev) / C**0.5
        g = randn((B, L, M, 1, C, 2), dtype, gen, dev)
        x = randn((B, L, M, 1, C, 2), dtype, gen, dev)
        w_perm = _PermutedWeight().get(w, dtype)

        def build():
            # the parent's conjugate-transposed weight (L, G, Co, Ci, 2)
            wt = w.permute(3, 0, 2, 1, 4).to(dtype)
            return torch.stack([wt[..., 0], -wt[..., 1]], dim=-1).contiguous()

        def parent():
            wct = build()
            out = torch.empty(B, L, M, 1, C, 2, dtype=dtype, device=dev)
            kernels.check_launch(lib.mt_dhconv_contract(kernels.dtype_code(dtype), g.data_ptr(), wct.data_ptr(), out.data_ptr(), B, L, M, 1, C, C,
                                                        kernels.stream_ptr(dev)), "dhconv (sweep)")
            return out

        def wide_runs():
            out = torch.empty(B, L, M, 1, C, 2, dtype=dtype, device=dev)
            kernels.check_launch(wide.mt_dhconv_grad_input(kernels.dtype_code(dtype), g.data_ptr(), w_perm.data_ptr(), out.data_ptr(), B, L, M, 1, C,
                                                            C, kernels.stream_ptr(dev)), "dhconv_grad_input (sweep)")
            return out

        out = dhconv_grad_input(g, w_perm)
        err = errors(out, dhconv_grad_input_plain(g, w))
        if not within(err, dtype):
            raise RuntimeError(f"K3 dx {label} {dtype} disagrees with its plain version: {err}")
        same = torch.equal(out, parent()) and torch.equal(out, wide_runs())
        if not same:
            raise RuntimeError(f"K3 dx {label} {dtype} differs from the parent's way (built weight) or the 64-byte runs")
        del out
        fns = {"as built (the forward's cache)": lambda: dhconv_grad_input(g, w_perm), "64-byte runs": wide_runs,
               "build + K3 (the parent's)": parent,
               "the build alone": build, "K3 forward, same shape": lambda: dhconv_contract_cl_s(x, w_perm)}
        times = in_turns(fns, 5, 1)
        torch.cuda.empty_cache()
        # the bmm on prebuilt operands, as chip_smoke times it: g times the
        # conjugate-transposed weight in the parameter's layout
        wct = torch.stack([w[..., 0], -w[..., 1]], dim=-1).transpose(1, 2).contiguous()
        extra = dhconv_extras(g, wct)(torch.empty(B, L, M, 1, C, 2, dtype=dtype, device=dev))
        del wct
        torch.cuda.empty_cache()
        print(f"K3 dx {label} {str(dtype).replace('torch.', '')} g {tuple(g.shape)}: max|d|/max|ref| {err['max_rel']:.2e}, bit-equal to the variant and "
              f"the parent's way {same}; bound {extra['bound_ms']:.3f} ms ({extra['bound_by']}); "
              + "; ".join(f"{name} {t[0]:.3f} / {t[1]:.3f} ms" for name, t in times.items())
              + f"; bmm (prebuilt operands) {extra['library_ms']:.3f} ms  [{card}]", flush=True)
        del g, x, w, w_perm
        torch.cuda.empty_cache()


def k10(card: str, dev: torch.device):
    from makani_torch import kernels
    from makani_torch.models.common import layer_norm as ln

    vp, i = ctypes.c_void_p, ctypes.c_int
    libs = {"as built": kernels.library()}
    libs.update(patched_libraries("instance_norm.cu", {name: patches for name, (_, patches) in K10_VARIANTS.items()}, "sweep_k3dx_k10"))
    for lib in libs.values():
        lib.mt_instance_norm_grad.argtypes = [i, i] + [vp] * 8 + [i] * 9 + [vp]
    gen = torch.Generator(dev).manual_seed(1)
    sms = ln._card(dev.index or 0)["sms"]
    B, C = 3, 384
    for label, H, W in (("full", 361, 720), ("internal", 120, 240)):
        x = (3.0 * randn((B, H, W, C), torch.float32, gen, dev) + 1.5).to(torch.bfloat16)
        g = randn((B, H, W, C), torch.bfloat16, gen, dev)
        w = (1.0 + 0.1 * randn((C,), torch.float32, gen, dev)).to(torch.bfloat16)
        mean, sd = ln._norm_stats_plain(x, None, 1e-6)
        n = H * W
        stats = torch.stack([mean.reshape(B, C), sd.reshape(B, C)], dim=1).contiguous()
        dx = torch.empty_like(x)
        dwdb = torch.empty(2, C, device=dev)
        sums = torch.empty(B, 4, C, device=dev)
        chosen = ln._grad_plan(x, g)
        # a plan for one sample, launched on B, walks them one a round
        plans = {f"{s} sample{'s' if s > 1 else ''} a round": ln.plan_instance_norm_grad(s, H * W, C, 2, sms=sms) for s in (B, 1)}
        part = torch.empty(max(p.blocks for p in plans.values()), 4, C, device=dev)

        def launch(lib, plan):
            kernels.check_launch(lib.mt_instance_norm_grad(1, plan.vec, g.data_ptr(), x.data_ptr(), w.data_ptr(), stats.data_ptr(), dx.data_ptr(),
                                                           dwdb.data_ptr(), part.data_ptr(), sums.data_ptr(), B, H * W, C, n, plan.group, plan.ppi,
                                                           plan.samples, plan.chunk, plan.blocks, kernels.stream_ptr(dev)),
                                 "instance_norm_grad (sweep)")

        fns = {}
        for name, plan in plans.items():
            fns[name + (" (the plan's)" if plan == chosen else "")] = (libs["as built"], plan)
        for name, lib in libs.items():
            if name != "as built":
                fns[name] = (lib, chosen)
        ref = ln.instance_norm_grad_plain(g, x, w, mean, sd, n)
        launch(libs["as built"], chosen)
        torch.cuda.synchronize()
        built = (dx.clone(), dwdb.clone())
        for k, (out, r) in enumerate(zip((dx, dwdb[0], dwdb[1]), ref)):
            if not within(errors(out, r), torch.bfloat16):
                raise RuntimeError(f"K10 {label} as built: output {k} disagrees with its plain version")
        notes = []
        for name, (lib, plan) in fns.items():
            check = K10_VARIANTS[name][0] if name in K10_VARIANTS else "same"
            launch(lib, plan)
            torch.cuda.synchronize()
            if check == "cut":
                continue
            if torch.equal(dx, built[0]) and torch.equal(dwdb, built[1]):
                continue
            # other slices: other partials; held to the plain version
            for k, (out, r) in enumerate(zip((dx, dwdb[0], dwdb[1]), ref)):
                if not within(errors(out, r), torch.bfloat16):
                    raise RuntimeError(f"K10 {label} variant '{name}': output {k} disagrees with its plain version")
            notes.append(name)
        del ref, built
        torch.cuda.empty_cache()
        times = in_turns({name: (lambda lib=lib, plan=plan: launch(lib, plan)) for name, (lib, plan) in fns.items()}, 10, 2)
        one = bound(14.0 * x.numel(), nbytes(x, g, w, dx))
        two_read = 1e3 * nbytes(x, g, x, g, dx) / PEAK_HBM_BYTES
        print(f"K10 {label} bf16 {tuple(x.shape)}: plan {dataclasses.asdict(chosen)} ({chosen.threads * 7 * 2 * 16 / 1024:.0f} KB of copies in flight "
              f"a block at a ring of 8); bound {one['bound_ms']:.4f} ms (bytes), two-read floor {two_read:.4f} ms; "
              f"held to the plain version, not bit-equal to the plan's: {notes or 'none'}; "
              + "; ".join(f"{name} {t[0]:.4f} / {t[1]:.4f} ms" for name, t in times.items()) + f"  [{card}]", flush=True)
        del x, g, dx, part
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_k3dx_k10: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from makani_torch import kernels

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    kernels.library()
    parts = sys.argv[1:] or ["k3dx", "k10"]
    if "k3dx" in parts:
        k3dx(card, dev)
    if "k10" in parts:
        k10(card, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
