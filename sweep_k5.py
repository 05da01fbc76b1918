#!/usr/bin/env python3
"""K5's two shared-memory layouts (routes), measured on one NVIDIA GPU:

    python3 sweep_k5.py          # the routes
    python3 sweep_k5.py fcn3     # the built kernel at every K5 call of FCN3
    python3 sweep_k5.py library  # the library yardstick at FCN3.1's K5 calls

K5 (``csrc/disco_band.cu``, the banded DISCO contraction) takes route 1 (a
latitude's whole filter staged once) where BL <= 32 and two blocks of it fit
on an SM, else route 2 (each stage's rows' live filter spans staged beside
them); ``disco_kernels.band_route`` reports the route and its shared memory.
Here each route is compiled from a patched copy of the source that takes it
whatever the sizes (``build/sweep_k5/``, ``sweep_k4_k8.patched_libraries``)
and launched at the responses-mode processor calls of the main paths, where
both layouts fit: FCN3's forecast (BL 9, 677 channels), FCN3.1's forecast
(BL 25, 280 channels) and FCN3.1's training step (BL 25, 4 members at 180 x
360). Beside them the built kernel through its wrapper. Both routes keep the
dense (i, j, w) order of the sums, so each is held bit for bit to the built
kernel.

``fcn3``: the built kernel through its wrapper at every K5 shape of the
FCN3 forecast (the processor in responses mode, the five weight-fused
encoders and decoders) and of its training step (the processor), made as
``chip_smoke.band_case`` makes them, without the plain versions. It runs
unchanged in an older checkout (copied beside its ``chip_smoke.py``), so
that one call can time two commits' kernels in turns.

``library``: the library yardstick of ``chip_smoke.band_case`` (one grouped
``conv1d`` on the gathered band, a group an output latitude) at FCN3.1's
responses-mode K5 calls whose gathered band does not fit the card in one
piece: the forecast's encoder and decoder, the history forecast's encoder
(one group of 73) and decoder, and the training step's processor and
decoder, on the inputs ``chip_smoke.check_fcn31_kernels`` and
``check_fcn31_train_kernels`` give them (seeded anew). The output latitudes
are split into runs whose gathered band and output take at most
``LIBRARY_RUN_BYTES``; each run's call is timed on its own (CUDA events, 2
after 1, the gather outside) and the runs' times are summed. At the
forecast's processor, where one call fits, the one call is timed beside the
runs and held to their concatenation (the largest difference, of max|ref|).

Times: CUDA events over 10 launches after 2 (``chip_smoke.time_ms``), every
variant timed twice in turns (``sweep_k9_k13.in_turns``). The patched
libraries' launches go to their entry points and count no launch. Each line
names the card and its power limit.
"""

from __future__ import annotations

import ctypes
import statistics
import sys

import torch

from chip_smoke import SEED, card_line, randn
from sweep_k4_k8 import patched_libraries
from sweep_k9_k13 import in_turns

_CHOICE = "  return p.BL <= 32 && s1 <= SMEM_TWO_BLOCKS ? 1 : 2;"
ROUTES = {f"route {r}": [(_CHOICE, f"  (void)s1;\n  return {r};")] for r in (1, 2)}


def processor_convs(dev):
    """(label, DiscoConvS2 of the processor, channels, members) of the main
    paths' processors, from the models that ``chip_smoke.py`` builds."""
    from chip_smoke import FCN31_CONFIG, FCN3_ENSEMBLE, FCN3_TRAIN_BATCH, FCN3_TRAIN_ENSEMBLE, build_fcn3, fcn31_params, fcn31_train_config
    from makani_torch.models.model_registry import get_model
    from makani_torch.utils.yparams import ParamsBase

    out = []
    model = build_fcn3(dev, with_noise=False)[1]
    conv = model.model.block1.local_conv
    out.append(("FCN3 processor", conv.conv_op, conv.in_channels, FCN3_ENSEMBLE))
    del model
    for label, params, members in (("FCN3.1 processor", fcn31_params(FCN31_CONFIG), FCN3_ENSEMBLE),
                                   ("FCN3.1 training processor", ParamsBase(fcn31_train_config()), FCN3_TRAIN_BATCH * FCN3_TRAIN_ENSEMBLE)):
        model, _ = get_model(params, multistep=True, device=dev, seed=SEED)
        net = model.model
        conv = next(getattr(net, f"block{i}").local_conv for i in range(net.num_layers) if hasattr(getattr(net, f"block{i}"), "local_conv"))
        out.append((label, conv.conv_op, conv.in_channels, members))
        del model
    torch.cuda.empty_cache()
    return out


def fcn3_calls(dev) -> dict:
    """{label: the built K5 through its wrapper} at FCN3's K5 calls, on the
    inputs ``chip_smoke.check_fcn3_kernels`` and ``check_fcn3_train_kernels``
    give them (seeded anew)."""
    import chip_smoke as cs
    from makani_torch.ops.disco import FusedFilterCache

    gen = torch.Generator(dev).manual_seed(SEED + 5)
    net = cs.build_fcn3(dev, with_noise=False)[1].model
    B, (H, W) = cs.FCN3_ENSEMBLE, net.inp_shape
    conv = net.block1.local_conv
    op = conv.conv_op
    x = randn((B, net.h, net.w, conv.in_channels), torch.float32, gen, dev)
    calls = {"processor": cs.band_case(op, x, op.band_filter(0, dev), 1, 1, op.K, "processor", padded=True)[3]}
    dec, sd = net.atmo_decoder, net.surf_decoder
    R, n_dec = net.n_atmo_groups, dec.conv.in_channels
    for label, conv, n_in in (("atmo-encoder", net.atmo_encoder.conv, net.n_atmo_groups * net.n_atmo), ("surf-encoder", net.surf_encoder.conv, net.n_surf),
                              ("aux-encoder", net.aux_encoder.conv, net.n_aux), ("atmo-decoder", dec.conv, R * n_dec), ("surf-decoder", sd.conv, net.surf_embed_dim)):
        if label.endswith("decoder"):
            xo = randn((B, H, W, n_in), torch.float32, gen, dev)
        else:
            xo = randn((B, n_in, H, W), torch.float32, gen, dev).permute(0, 2, 3, 1)
        g, og, ig, _ = conv.weight.shape
        calls[label] = cs.band_case(conv.conv_op, xo, FusedFilterCache().get(conv.conv_op, conv.weight, 0), g, ig, og, label)[3]
    del net
    model = cs.build_fcn3_train(dev)[1]
    conv = model.model.block1.local_conv
    op = conv.conv_op
    x = randn((cs.FCN3_TRAIN_BATCH * cs.FCN3_TRAIN_ENSEMBLE, *op.in_shape, conv.in_channels), torch.float32, gen, dev)
    calls["train-processor"] = cs.band_case(op, x, op.band_filter(0, dev), 1, 1, op.K, "train-processor", padded=True)[3]
    return calls


def fcn3(card: str, dev: torch.device):
    times = in_turns(fcn3_calls(dev))
    for label, ts in times.items():
        print(f"K5 FCN3 {label:16s} {statistics.median(ts):9.3f} ms (turns {[round(t, 3) for t in ts]})  [{card}]", flush=True)


# the most that one run of the library yardstick's gathered band and output may take
LIBRARY_RUN_BYTES = 8e9


def band_library_runs(op, x, K: int, budget: float = LIBRARY_RUN_BYTES):
    """The library yardstick of K5 in responses mode (Gf = IG = 1, OG = K)
    on x (B, Hin, Win, C): yields (the run's conv1d as a closure, its
    latitudes) for each run of output latitudes that fits ``budget`` bytes,
    the run's band gathered as it is yielded. The run's output is (B*C,
    rows*K, Wout), ``chip_smoke.band_case``'s call's rows of those
    latitudes."""
    from makani_torch.ops.precision import fp32_exact

    dev = x.device
    B, Hin, Win, C = x.shape
    Hout, Wout = op.out_shape
    BL, WW, a = op.BL, op.WW, op.stride
    bs = op.band_start_table(dev).long()
    F_ = op.band_filter(0, dev)[..., :K]
    span = (Wout - 1) * a + WW
    cols = (int(op.bases[0]) - op.halo + torch.arange(span, device=dev)) % Win
    per_row = 4 * B * C * (BL * span + K * Wout)
    n = max(1, int(min(budget / per_row, Hout)))
    for h0 in range(0, Hout, n):
        h1 = min(Hout, h0 + n)
        rows = bs[h0:h1, None] + torch.arange(BL, device=dev)
        inp = x[:, rows.reshape(-1, 1), cols.view(1, -1)].permute(0, 3, 1, 2).reshape(B * C, (h1 - h0) * BL, span)
        filt = F_[h0:h1].permute(0, 1, 5, 2, 3, 4).reshape((h1 - h0) * K, BL, WW).contiguous()

        def call(inp=inp, filt=filt, g=h1 - h0):
            with fp32_exact():
                return torch.nn.functional.conv1d(inp, filt, stride=a, groups=g)

        yield call, (h0, h1)
        del inp, filt, call


def library(card: str, dev: torch.device):
    import chip_smoke as cs

    gen = torch.Generator(dev).manual_seed(SEED + 15)
    B = cs.FCN3_ENSEMBLE
    for tag, config in (("fcn31", cs.FCN31_CONFIG), ("fcn31h", cs.FCN31_HISTORY_CONFIG)):
        net = cs.build_fcn31(dev, config)[1].model
        H, W = net.inp_shape
        for name, conv, n_in in cs.fcn31_convs(net):
            if conv.fused or (name == "processor" and tag == "fcn31h"):
                continue
            op = conv.conv_op
            ig = conv.in_channels // conv.groups
            if name == "decoder":
                x = randn((B, H, W, ig), torch.float32, gen, dev)
            elif name == "processor":
                x = randn((B, *op.in_shape, ig), torch.float32, gen, dev)
            else:
                x = randn((B, ig, H, W), torch.float32, gen, dev).permute(0, 2, 3, 1)
            library_line(card, f"{tag}-{name}", op, x, check_one=name == "processor")
            del x
            torch.cuda.empty_cache()
        del net
        torch.cuda.empty_cache()
    model = cs.build_fcn31_train(dev)[1]
    for name, conv, _ in cs.fcn31_convs(model.model):
        if name in ("processor", "decoder"):
            op = conv.conv_op
            x = randn((cs.FCN3_TRAIN_BATCH * cs.FCN3_TRAIN_ENSEMBLE, *op.in_shape, conv.in_channels), torch.float32, gen, dev)
            library_line(card, f"fcn31-train-{name}", op, x)
            del x
            torch.cuda.empty_cache()


def library_line(card, label, op, x, check_one=False):
    ms = [cs_time_ms(call) for call, _ in band_library_runs(op, x, op.K)]
    extra = ""
    if check_one:
        parts = torch.cat([call() for call, _ in band_library_runs(op, x, op.K)], dim=1)
        ((one, _),) = band_library_runs(op, x, op.K, budget=float("inf"))
        err = ((one() - parts).abs().max() / parts.abs().max()).item()
        extra = f"; one call {cs_time_ms(one):.3f} ms, its output within {err:.1e} of max|runs'|"
        del parts, one
    print(f"K5 library {label}: grouped conv1d over {len(ms)} run(s) of output latitudes ({op.BL}x{op.WW} band, K {op.K}, B {x.shape[0]}, C "
          f"{x.shape[3]}, {op.in_shape} -> {op.out_shape}): {sum(ms):.3f} ms summed (runs {[round(v, 3) for v in ms]}){extra}  [{card}]", flush=True)


def cs_time_ms(fn) -> float:
    from chip_smoke import time_ms

    return time_ms(fn, 2, 1)


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_k5: no GPU", flush=True)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    if sys.argv[1:] == ["fcn3"]:
        fcn3(card, dev)
        return 0
    if sys.argv[1:] == ["library"]:
        library(card, dev)
        return 0
    return routes(card, dev)


def routes(card: str, dev: torch.device) -> int:
    from makani_torch.ops import disco_kernels as dk
    from makani_torch.ops.disco import RESPONSE_ALIGN

    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = patched_libraries("disco_band.cu", ROUTES, "sweep_k5")
    for lib in libs.values():
        lib.mt_disco_band_contract.argtypes = [vp, vp, vp, vp, vp, i, i, i, ll, ll, ll, ll] + [i] * 14 + [ll, vp]
        lib.mt_disco_band_route.argtypes = [i] * 8 + [ctypes.POINTER(ll)]
    gen = torch.Generator(dev).manual_seed(SEED + 20)
    for label, op, C, B in processor_convs(dev):
        Hout, Wout = op.out_shape
        K = op.K
        x = randn((B, *op.in_shape, C), torch.float32, gen, dev)
        F_ = op.band_filter(0, dev)
        bs, taps = op.band_start_table(dev), op.tap_table(0, dev)
        kw = dict(taps=taps, a=op.stride, off=int(op.bases[0]) - op.halo, n_out=Wout, phase=0, phases=1, Gf=1, IG=1, OG=K)
        Cout = C * K
        out = torch.empty(B, Hout, Wout, -(-Cout // RESPONSE_ALIGN) * RESPONSE_ALIGN, device=dev)[..., :Cout]
        built = lambda: dk.band_contract(x, F_, bs, out, **kw)
        ref = built().clone()
        own, smem = dk.band_route(C, 1, 1, K, op.BL, op.WW, op.stride, Wout)
        fns, notes = {f"built (route {own})": built}, {f"built (route {own})": f"{smem / 1024:.1f} KB a block"}
        for name, lib in libs.items():
            s = ll(0)
            got = lib.mt_disco_band_route(C, 1, 1, K, op.BL, op.WW, op.stride, Wout, ctypes.byref(s))
            if s.value > 227 * 1024:
                notes[name] = f"needs {s.value / 1024:.1f} KB: does not fit"
                continue

            def launch(lib=lib, name=name):
                err = lib.mt_disco_band_contract(
                    x.data_ptr(), F_.data_ptr(), bs.data_ptr(), taps.data_ptr(), out.data_ptr(), B, *op.in_shape, *x.stride(), Hout, Wout,
                    C, 1, 1, K, F_.shape[-1], op.BL, op.WW, op.stride, kw["off"], Wout, 0, 1, out.stride(2), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{label} {name}: launch error {err}")
                return out

            out.fill_(float("nan"))
            same = torch.equal(launch(), ref)
            if got != int(name[-1]) or not same:
                raise RuntimeError(f"{label} {name}: took route {got}, {'bit-equal' if same else 'differs from'} the built kernel")
            fns[name], notes[name] = launch, f"{s.value / 1024:.1f} KB a block, bit-equal to the built kernel"
        times = in_turns(fns)
        print(f"K5 {label}: x {tuple(x.shape)}, BL {op.BL}, WW {op.WW}, K {K}  [{card}]", flush=True)
        for name, ts in times.items():
            print(f"  {name:16s} {statistics.median(ts):9.3f} ms (turns {[round(t, 3) for t in ts]}); {notes[name]}", flush=True)
        for name in set(notes) - set(times):
            print(f"  {name:16s} {notes[name]}", flush=True)
        del x, out, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
