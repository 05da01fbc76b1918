"""The DISCO convolution's kernels and their plain PyTorch versions.

K5 (``band_contract``, CUDA C++ in ``csrc/disco_band.cu``): the banded
contraction

    out[b, h, p + phases*u, g, o] = sum_{i, j, w} F[h, g % Gf, i, j, w, o]
        * x[b, band_start[h] + j, (off + u*a + w) mod Win, g*IG + i]

It replaces ``scripts/r3/disco_pallas.py`` ``pallas_band_contract`` and the
grouped convolution of ``makani_tpu/ops/disco.py`` (``DiscoConvS2.__call__``
:663-674 and the weight-fused ``_fused_window`` :804-817, whose default
``_fused_dense`` computes the same function). Its plain version is the JAX
package's own formulation: the band rows gathered (BL times the input, never
the WW-fold window), then one grouped ``conv1d`` with a group per output
latitude, chunked over the channel axis to bound memory. The kernel sums
only the filter's live taps: ``taps`` (Hout, BL, 2) int32 holds, for each
output latitude h and band row j, the one run [lo, hi) of w outside which
F is zero (``ops.disco.live_tap_runs``); the plain version sums the dense
window.

K6 (``polar_psi_first`` / ``polar_mix_first``, CUDA C++ in
``csrc/disco_polar.cu``): the polar rows' conjugate multiply-sum between
cuFFTs, ``Y = sum_j X conj(Psi)`` per basis function, or ``sum_{k, j}`` on
the channel-mixed field (``makani_tpu/ops/disco.py`` :676-692, :856-864,
:886-909), in cuFFT's layout with the longitude modes last, as the JAX
package keeps them: X (B, P, BL, C, M), U (B, P, BL, C, K, M), Psi
(P, BL, K, M), Y (B, P, C, K, M) or (B, P, C, M), complex as a trailing
(re, im) pair. It is bound by memory bandwidth: it reads every X (or U)
element once and writes every Y element once, coalesced along the modes.

K8 (``channel_mix``, CUDA C++ in ``csrc/disco_mix.cu``): the processor's
channel mix of the two-stage conv, ``y[r, o] = sum_j t[r, j] w[o, j]`` over
the responses t (B*H*W, C*K) and the weight (Cout, C*K), in fp32 as 3xTF32
on the tensor cores (``makani_tpu/models/networks/fourcastnet3.py:125``,
einsum ``bgikhw,goik->bhwgo``). It reads the weight's TF32 planes
(``mix_planes``), made once per weight version, and t's rows in 16-byte
pieces: K5 writes them ``RESPONSE_ALIGN`` floats apart (``ops/disco.py``).
Its plain version is one ``torch.matmul``.

K12 (``band_contract_grad``, CUDA C++ in ``csrc/disco_band_grad.cu``): the
transpose of K5 with respect to x, for one phase, added into dx (the VJP
that JAX derives for ``DiscoConvS2.__call__`` and ``.fused``). It gathers:
``band_grad_rows`` lists, for each input row, the output latitudes whose
band reads it through a live tap. Its plain version is the transposed
grouped convolution (``conv_transpose1d``) on the band, a run of output
latitudes at a time, scattered back to the input rows and columns with an
indexed add of whole channel rows.

K13 (``polar_psi_first_grad`` / ``polar_mix_first_grad``, modes 2 and 3 of
``csrc/disco_polar.cu``): the transposes of K6, ``dX = sum_k dY Psi`` and
``dU = dY Psi``, complex products without the forward's conjugate.
``PolarPsiFirst`` and ``PolarMixFirst`` are K6 and K13 as one autograd
function; ``ChannelMix`` is K8 with its backward, the two GEMMs
``dt = dy w2`` (written in the padded layout of the responses, which K12
reads in place) and ``dw2 = dy^T t``, cuBLAS in full fp32, as the JAX
package leaves the transpose of its einsum to XLA.

The plain versions' cuDNN and cuBLAS calls run in full fp32 whatever the
global TF32 flags say (``precision.fp32_exact``). On a CPU tensor a wrapper
runs the plain version; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from makani_torch import kernels
from makani_torch.ops.precision import fp32_exact
from makani_torch.ops.sht import tf32_split

__all__ = [
    "band_route",
    "band_contract",
    "band_contract_plain",
    "band_contract_grad",
    "band_contract_grad_plain",
    "band_grad_rows",
    "polar_psi_first_grad",
    "polar_psi_first_grad_plain",
    "polar_mix_first_grad",
    "polar_mix_first_grad_plain",
    "PolarPsiFirst",
    "PolarMixFirst",
    "ChannelMix",
    "polar_psi_first",
    "polar_psi_first_plain",
    "polar_mix_first",
    "polar_mix_first_plain",
    "channel_mix",
    "channel_mix_plain",
    "mix_planes",
    "MixPlanes",
    "pixel_stride",
]

# the plain K5 gathers the band rows of this many bytes of input per chunk
_PLAIN_CHUNK_BYTES = 1 << 30


def _check_band_args(x, F_, out, Gf, IG, OG, taps=None):
    if taps is not None and (taps.dtype != torch.int32 or tuple(taps.shape) != (F_.shape[0], F_.shape[3], 2) or not taps.is_contiguous()):
        raise ValueError(f"disco_band: taps must be a contiguous int32 (Hout, BL, 2) = {(F_.shape[0], F_.shape[3], 2)} table, got {taps.dtype} {tuple(taps.shape)}")
    if x.dim() != 4 or F_.dim() != 6 or out.dim() != 4:
        raise ValueError(f"disco_band: expected x (B,H,W,C), F (Hout,Gf,IG,BL,WW,OGp), out (B,Hout,Wout,Cout); got {tuple(x.shape)}, {tuple(F_.shape)}, {tuple(out.shape)}")
    C = x.shape[-1]
    if C % (Gf * IG) or tuple(F_.shape[1:3]) != (Gf, IG) or F_.shape[-1] < OG:
        raise ValueError(f"disco_band: x channels {C}, F {tuple(F_.shape)} and (Gf, IG, OG) = {(Gf, IG, OG)} do not match")
    if out.shape[-1] != C // IG * OG or out.shape[0] != x.shape[0] or out.shape[1] != F_.shape[0]:
        raise ValueError(f"disco_band: out {tuple(out.shape)} does not match x {tuple(x.shape)} and F {tuple(F_.shape)}")


class _ExactConv1d(torch.autograd.Function):
    """The plain K5's grouped conv1d, its forward and its backward (for
    autograd through the plain forward) in full fp32: cuDNN would run an
    fp32 convolution, and the convolutions of its backward, in TF32 by
    default."""

    @staticmethod
    def forward(ctx, inp, filt, stride, groups):
        ctx.save_for_backward(inp, filt)
        ctx.stride, ctx.groups = stride, groups
        with fp32_exact():
            return F.conv1d(inp, filt, stride=stride, groups=groups)

    @staticmethod
    def backward(ctx, g):
        inp, filt = ctx.saved_tensors
        d_inp = d_filt = None
        with fp32_exact():
            if ctx.needs_input_grad[0]:
                d_inp = torch.nn.grad.conv1d_input(inp.shape, filt, g, stride=ctx.stride, groups=ctx.groups)
            if ctx.needs_input_grad[1]:
                d_filt = torch.nn.grad.conv1d_weight(inp, filt.shape, g, stride=ctx.stride, groups=ctx.groups)
        return d_inp, d_filt, None, None


def band_contract_plain(x, F_, band_start, out, *, a, off, n_out, phase, phases, Gf, IG, OG, taps=None):
    """Plain K5: writes ``out[:, :, phase::phases]`` (see the module
    docstring). x is a (B, Hin, Win, C) view of any strides. It sums the
    dense window; ``taps``, where given, is only checked."""
    _check_band_args(x, F_, out, Gf, IG, OG, taps)
    B, Hin, Win, C = x.shape
    Hout, _, _, BL, WW, _ = F_.shape
    R = C // (Gf * IG)
    dev = x.device
    rows = (band_start.long()[:, None] + torch.arange(BL, device=dev)[None, :]).reshape(-1)  # (Hout*BL,)
    span = (n_out - 1) * a + WW
    cols = (off + torch.arange(span, device=dev)) % Win
    filt = F_[..., :OG].permute(0, 1, 5, 2, 3, 4).reshape(Hout * Gf * OG, IG * BL, WW)
    step = max(1, _PLAIN_CHUNK_BYTES // (B * Hout * BL * span * Gf * IG * 4))
    dst = out[:, :, phase::phases]
    for r0 in range(0, R, step):
        r1 = min(R, r0 + step)
        Rc = r1 - r0
        xb = x[..., r0 * Gf * IG : r1 * Gf * IG][:, rows[:, None], cols[None, :]]  # (B, Hout*BL, span, Rc*Gf*IG)
        inp = xb.reshape(B, Hout, BL, span, Rc, Gf, IG).permute(0, 4, 1, 5, 6, 2, 3).reshape(B * Rc, Hout * Gf * IG * BL, span)
        y = _ExactConv1d.apply(inp, filt, a, Hout * Gf)  # (B*Rc, Hout*Gf*OG, n_out)
        y = y.reshape(B, Rc, Hout, Gf, OG, n_out).permute(0, 2, 5, 1, 3, 4).reshape(B, Hout, n_out, Rc * Gf * OG)
        dst[..., r0 * Gf * OG : r1 * Gf * OG] = y
    return out


def pixel_stride(out: torch.Tensor) -> int:
    """The floats between pixels of a (B, H, W, C) tensor that is contiguous
    but for its pixel stride (at least C), as K5 writes its output; raises
    for any other layout."""
    B, H, W, C = out.shape
    sO = out.stride(2)
    if out.stride() != (H * W * sO, W * sO, sO, 1) or sO < C:
        raise ValueError(f"disco_band: out {tuple(out.shape)} with strides {out.stride()} is not contiguous but for its pixel stride")
    return sO


def band_route(G: int, Gf: int, IG: int, OG: int, BL: int, WW: int, a: int, n_out: int) -> tuple[int, int]:
    """The layout K5 takes for these sizes, (route, shared-memory bytes a
    block): route 1 stages a latitude's whole filter once (BL <= 32 where two
    blocks of it fit on an SM: every FCN3 conv), route 2 stages the filter
    with each stage's band rows (FCN3.1's bands)."""
    smem = ctypes.c_longlong(0)
    got = kernels.library().mt_disco_band_route(G, Gf, IG, OG, BL, WW, a, n_out, ctypes.byref(smem))
    if got < 0:
        raise ValueError(f"disco_band: no route for G {G}, Gf {Gf}, IG {IG}, OG {OG}, BL {BL}, WW {WW}, a {a}, n_out {n_out}")
    return got, smem.value


def band_contract(x, F_, band_start, out, *, taps, a, off, n_out, phase, phases, Gf, IG, OG):
    """K5 on the card, the plain version on the CPU; writes
    ``out[:, :, phase::phases]`` and returns out.

    x: float32 (B, Hin, Win, G*IG) view of any strides; F_: float32
    (Hout, Gf, IG, BL, WW, OGp) contiguous, zero-padded on the outputs to
    OGp (1 for OG == 1, else a multiple of 9); band_start: int32 (Hout,);
    taps: int32 (Hout, BL, 2), the live run [lo, hi) of w of each (h, j),
    F zero outside it; out: float32 (B, Hout, Wout, G*OG), contiguous but
    for its pixel stride (``pixel_stride``). Any BL: a band wider than 32
    rows takes route 2 (``band_route``)."""
    if kernels.takes_plain("disco_band", x, F_, band_start, taps, out):
        return band_contract_plain(x, F_, band_start, out, taps=taps, a=a, off=off, n_out=n_out, phase=phase, phases=phases, Gf=Gf, IG=IG, OG=OG)
    _check_band_args(x, F_, out, Gf, IG, OG, taps)
    if x.dtype != torch.float32 or F_.dtype != torch.float32 or out.dtype != torch.float32 or band_start.dtype != torch.int32:
        raise TypeError(f"disco_band: takes float32 x, F and out and int32 band_start, got {x.dtype}, {F_.dtype}, {out.dtype}, {band_start.dtype}")
    if not (F_.is_contiguous() and band_start.is_contiguous()):
        raise ValueError("disco_band: F and band_start must be contiguous")
    sO = pixel_stride(out)
    B, Hin, Win, C = x.shape
    Hout, Gf_, IG_, BL, WW, OGp = F_.shape
    Wout = out.shape[2]
    if out.numel() == 0:
        return out
    lib = kernels.library()
    sB, sH, sW, sC = x.stride()
    with torch.cuda.device(x.device):
        err = lib.mt_disco_band_contract(
            x.data_ptr(), F_.data_ptr(), band_start.data_ptr(), taps.data_ptr(), out.data_ptr(), B, Hin, Win, sB, sH, sW, sC, Hout, Wout,
            C // IG, Gf, IG, OG, OGp, BL, WW, a, off, n_out, phase, phases, sO, kernels.stream_ptr(x.device),
        )
    kernels.check_launch(err, "disco_band")
    kernels.count_launch("disco_band")
    return out


def band_grad_rows(band_start, taps, Hin: int):
    """K12's row lists of one phase, from K5's tables on the host: for each
    input row hi, the output latitudes h whose band covers hi with a live
    tap there (``band_start[h] <= hi < band_start[h] + BL``), as a CSR pair
    (row_ptr (Hin + 1,), row_h) of int32, h ascending."""
    band_start = np.asarray(band_start, np.int64)
    taps = np.asarray(taps)
    Hout, BL = taps.shape[:2]
    h, j = np.nonzero(taps[..., 1] > taps[..., 0])
    hi = band_start[h] + j
    order = np.lexsort((h, hi))
    row_ptr = np.zeros(Hin + 1, np.int64)
    np.add.at(row_ptr, hi + 1, 1)
    return np.cumsum(row_ptr).astype(np.int32), h[order].astype(np.int32)


def band_contract_grad_plain(dout, F_, band_start, dx, *, a, off, n_out, phase, phases, Gf, IG, OG, accumulate, taps=None, rows=None):
    """Plain K12: the transpose of ``band_contract_plain`` with respect to x
    for ``out[:, :, phase::phases] = dout[:, :, phase::phases]``, written
    (or, with ``accumulate``, added) into dx (B, Hin, Win, C) contiguous: a
    grouped ``conv_transpose1d`` on the band, chunked over the output
    latitudes, scattered back to the band's rows and window columns with an
    indexed add of whole channel rows. ``taps`` and ``rows`` are not read."""
    _check_band_args(dx, F_, dout, Gf, IG, OG)
    if not accumulate:
        dx.zero_()
    B, Hin, Win, C = dx.shape
    Hout, _, _, BL, WW, _ = F_.shape
    R = C // (Gf * IG)
    dev = dx.device
    rows_ = (band_start.long()[:, None] + torch.arange(BL, device=dev)[None, :]).reshape(-1)  # (Hout*BL,)
    span = (n_out - 1) * a + WW
    cols = (off + torch.arange(span, device=dev)) % Win
    filt = F_[..., :OG].permute(0, 1, 5, 2, 3, 4).reshape(Hout * Gf * OG, IG * BL, WW)
    step = max(1, _PLAIN_CHUNK_BYTES // (B * C * BL * span * 4))
    src = dout[:, :, phase::phases][:, :, :n_out]
    dxf = dx.view(B, Hin * Win, C)
    for h0 in range(0, Hout, step):
        h1 = min(Hout, h0 + step)
        hc = h1 - h0
        y = src[:, h0:h1].reshape(B, hc, n_out, R, Gf, OG).permute(0, 3, 1, 4, 5, 2).reshape(B * R, hc * Gf * OG, n_out)
        with fp32_exact():
            gb = F.conv_transpose1d(y, filt[h0 * Gf * OG : h1 * Gf * OG], stride=a, groups=hc * Gf)  # (B*R, hc*Gf*IG*BL, span)
        gb = gb.reshape(B, R, hc, Gf, IG, BL, span).permute(0, 2, 5, 6, 1, 3, 4).reshape(B, hc * BL * span, C)
        flat = (rows_[h0 * BL : h1 * BL, None] * Win + cols[None, :]).reshape(-1)  # input pixels, with repeats
        dxf.index_add_(1, flat, gb)
    return dx


def band_contract_grad(dout, F_, band_start, dx, *, taps, rows, a, off, n_out, phase, phases, Gf, IG, OG, accumulate):
    """K12 on the card, the plain version on the CPU: dx (+)= the transpose
    of K5 (same filter, tables and phase arguments) applied to dout; returns
    dx.

    dout: float32 (B, Hout, Wout, G*OG), contiguous but for its pixel stride
    (``pixel_stride``), as K5 writes; F_, band_start, taps: K5's; rows: the
    phase's ``band_grad_rows`` (row_ptr, row_h) int32 tensors; dx: float32
    (B, Hin, Win, G*IG) contiguous, written (or added to, ``accumulate``)."""
    row_ptr, row_h = rows
    if kernels.takes_plain("disco_band_grad", dout, F_, band_start, taps, row_ptr, row_h, dx):
        return band_contract_grad_plain(dout, F_, band_start, dx, a=a, off=off, n_out=n_out, phase=phase, phases=phases, Gf=Gf, IG=IG, OG=OG, accumulate=accumulate)
    _check_band_args(dx, F_, dout, Gf, IG, OG, taps)
    for t in (dout, F_, dx):
        if t.dtype != torch.float32:
            raise TypeError(f"disco_band_grad: takes float32 dout, F and dx, got {dout.dtype}, {F_.dtype}, {dx.dtype}")
    if not (F_.is_contiguous() and dx.is_contiguous() and band_start.is_contiguous() and row_ptr.is_contiguous() and row_h.is_contiguous()):
        raise ValueError("disco_band_grad: F, dx and the tables must be contiguous")
    if row_ptr.dtype != torch.int32 or row_h.dtype != torch.int32 or band_start.dtype != torch.int32 or row_ptr.numel() != dx.shape[1] + 1:
        raise ValueError(f"disco_band_grad: row_ptr must be int32 (Hin + 1,) and row_h and band_start int32, got {row_ptr.dtype} {tuple(row_ptr.shape)}, {row_h.dtype}")
    sO = pixel_stride(dout)
    B, Hin, Win, C = dx.shape
    Hout, _, _, BL, WW, OGp = F_.shape
    if dx.numel() == 0:
        return dx
    lib = kernels.library()
    with torch.cuda.device(dx.device):
        err = lib.mt_disco_band_grad(
            dout.data_ptr(), F_.data_ptr(), band_start.data_ptr(), taps.data_ptr(), row_ptr.data_ptr(), row_h.data_ptr(), dx.data_ptr(),
            B, Hin, Win, Hout, dout.shape[2], C, Gf, IG, OG, OGp, BL, WW, a, off, n_out, phase, phases, sO, int(accumulate), kernels.stream_ptr(dx.device),
        )
    kernels.check_launch(err, "disco_band_grad")
    kernels.count_launch("disco_band_grad")
    return dx


def polar_psi_first_plain(X: torch.Tensor, Pt: torch.Tensor) -> torch.Tensor:
    """X (B, P, BL, C, M, 2), Pt (P, BL, K, M, 2) ->
    Y (B, P, C, K, M, 2) = sum_j X . conj(Psi)."""
    Xr, Xi, Pr, Pi = X[..., 0], X[..., 1], Pt[..., 0], Pt[..., 1]
    eq = "bpjcm,pjkm->bpckm"
    with fp32_exact():
        re = torch.einsum(eq, Xr, Pr) + torch.einsum(eq, Xi, Pi)
        im = torch.einsum(eq, Xi, Pr) - torch.einsum(eq, Xr, Pi)
    return torch.stack([re, im], dim=-1)


def polar_mix_first_plain(U: torch.Tensor, Pt: torch.Tensor) -> torch.Tensor:
    """U (B, P, BL, C, K, M, 2), Pt (P, BL, K, M, 2) ->
    Y (B, P, C, M, 2) = sum_{j, k} U . conj(Psi)."""
    Ur, Ui, Pr, Pi = U[..., 0], U[..., 1], Pt[..., 0], Pt[..., 1]
    eq = "bpjckm,pjkm->bpcm"
    with fp32_exact():
        re = torch.einsum(eq, Ur, Pr) + torch.einsum(eq, Ui, Pi)
        im = torch.einsum(eq, Ui, Pr) - torch.einsum(eq, Ur, Pi)
    return torch.stack([re, im], dim=-1)


def _polar_launch(mode: int, src: torch.Tensor, Pt: torch.Tensor, out_shape) -> torch.Tensor:
    for t in (src, Pt):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"disco_polar: takes contiguous float32 tensors, got {t.dtype} contiguous={t.is_contiguous()}")
    B, P, BL, C = src.shape[:4]
    K, M = Pt.shape[2], Pt.shape[3]
    if tuple(Pt.shape) != (P, BL, K, M, 2) or src.shape[-2:] != (M, 2):
        raise ValueError(f"disco_polar: input {tuple(src.shape)} and table {tuple(Pt.shape)} do not match")
    y = torch.empty(out_shape, dtype=torch.float32, device=src.device)
    if y.numel() == 0:
        return y
    lib = kernels.library()
    with torch.cuda.device(src.device):
        err = lib.mt_disco_polar(mode, src.data_ptr(), Pt.data_ptr(), y.data_ptr(), B, P, BL, C, K, M, kernels.stream_ptr(src.device))
    kernels.check_launch(err, "disco_polar")
    kernels.count_launch("disco_polar")
    return y


def polar_psi_first(X: torch.Tensor, Pt: torch.Tensor) -> torch.Tensor:
    """K6, responses and psi-first order: X (B, P, BL, C, M, 2), Pt
    (P, BL, K, M, 2) -> Y (B, P, C, K, M, 2); plain version on the CPU."""
    if kernels.takes_plain("disco_polar", X, Pt):
        return polar_psi_first_plain(X, Pt)
    B, P, BL, C, M, _ = X.shape
    return _polar_launch(0, X, Pt, (B, P, C, Pt.shape[2], M, 2))


def polar_mix_first(U: torch.Tensor, Pt: torch.Tensor) -> torch.Tensor:
    """K6, mix-first order: U (B, P, BL, C, K, M, 2), Pt (P, BL, K, M, 2) ->
    Y (B, P, C, M, 2); plain version on the CPU."""
    if kernels.takes_plain("disco_polar", U, Pt):
        return polar_mix_first_plain(U, Pt)
    B, P, BL, C, K, M, _ = U.shape
    if K != Pt.shape[2]:
        raise ValueError(f"disco_polar: U has {K} basis functions, the table {Pt.shape[2]}")
    return _polar_launch(1, U, Pt, (B, P, C, M, 2))


def polar_psi_first_grad_plain(dY: torch.Tensor, Pt: torch.Tensor) -> torch.Tensor:
    """dY (B, P, C, K, M, 2), Pt (P, BL, K, M, 2) ->
    dX (B, P, BL, C, M, 2) = sum_k dY . Psi."""
    Yr, Yi, Pr, Pi = dY[..., 0], dY[..., 1], Pt[..., 0], Pt[..., 1]
    eq = "bpckm,pjkm->bpjcm"
    with fp32_exact():
        re = torch.einsum(eq, Yr, Pr) - torch.einsum(eq, Yi, Pi)
        im = torch.einsum(eq, Yr, Pi) + torch.einsum(eq, Yi, Pr)
    return torch.stack([re, im], dim=-1)


def polar_mix_first_grad_plain(dY: torch.Tensor, Pt: torch.Tensor) -> torch.Tensor:
    """dY (B, P, C, M, 2), Pt (P, BL, K, M, 2) ->
    dU (B, P, BL, C, K, M, 2) = dY . Psi."""
    Yr, Yi = dY[..., 0][:, :, None, :, None], dY[..., 1][:, :, None, :, None]
    Pr, Pi = Pt[..., 0][None, :, :, None], Pt[..., 1][None, :, :, None]
    return torch.stack([Yr * Pr - Yi * Pi, Yr * Pi + Yi * Pr], dim=-1)


def _polar_grad_launch(mode: int, dY: torch.Tensor, Pt: torch.Tensor, BL: int, C: int, out_shape) -> torch.Tensor:
    for t in (dY, Pt):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"disco_polar_grad: takes contiguous float32 tensors, got {t.dtype} contiguous={t.is_contiguous()}")
    B, P = dY.shape[:2]
    K, M = Pt.shape[2], Pt.shape[3]
    if tuple(Pt.shape) != (P, BL, K, M, 2) or dY.shape[-2:] != (M, 2):
        raise ValueError(f"disco_polar_grad: gradient {tuple(dY.shape)} and table {tuple(Pt.shape)} do not match")
    dx = torch.empty(out_shape, dtype=torch.float32, device=dY.device)
    if dx.numel() == 0:
        return dx
    lib = kernels.library()
    with torch.cuda.device(dY.device):
        err = lib.mt_disco_polar(mode, dY.data_ptr(), Pt.data_ptr(), dx.data_ptr(), B, P, BL, C, K, M, kernels.stream_ptr(dY.device))
    kernels.check_launch(err, "disco_polar_grad")
    kernels.count_launch("disco_polar_grad")
    return dx


def polar_psi_first_grad(dY: torch.Tensor, Pt: torch.Tensor) -> torch.Tensor:
    """K13, the psi-first transpose: dY (B, P, C, K, M, 2), Pt
    (P, BL, K, M, 2) -> dX (B, P, BL, C, M, 2); plain version on the CPU."""
    if kernels.takes_plain("disco_polar_grad", dY, Pt):
        return polar_psi_first_grad_plain(dY, Pt)
    B, P, C, K, M, _ = dY.shape
    if K != Pt.shape[2]:
        raise ValueError(f"disco_polar_grad: dY has {K} basis functions, the table {Pt.shape[2]}")
    return _polar_grad_launch(2, dY, Pt, Pt.shape[1], C, (B, P, Pt.shape[1], C, M, 2))


def polar_mix_first_grad(dY: torch.Tensor, Pt: torch.Tensor) -> torch.Tensor:
    """K13, the mix-first transpose: dY (B, P, C, M, 2), Pt (P, BL, K, M, 2)
    -> dU (B, P, BL, C, K, M, 2); plain version on the CPU."""
    if kernels.takes_plain("disco_polar_grad", dY, Pt):
        return polar_mix_first_grad_plain(dY, Pt)
    B, P, C, M, _ = dY.shape
    BL, K = Pt.shape[1], Pt.shape[2]
    return _polar_grad_launch(3, dY, Pt, BL, C, (B, P, BL, C, K, M, 2))


class PolarPsiFirst(torch.autograd.Function):
    """K6 psi-first (forward) and K13 (backward, with respect to X; the
    table is a constant)."""

    @staticmethod
    def forward(ctx, X, Pt):
        ctx.save_for_backward(Pt)
        return polar_psi_first(X, Pt)

    @staticmethod
    def backward(ctx, dY):
        (Pt,) = ctx.saved_tensors
        return polar_psi_first_grad(dY.contiguous(), Pt), None


class PolarMixFirst(torch.autograd.Function):
    """K6 mix-first (forward) and K13 (backward, with respect to U)."""

    @staticmethod
    def forward(ctx, U, Pt):
        ctx.save_for_backward(Pt)
        return polar_mix_first(U, Pt)

    @staticmethod
    def backward(ctx, dY):
        (Pt,) = ctx.saved_tensors
        return polar_mix_first_grad(dY.contiguous(), Pt), None


# K8's tiles (csrc/disco_mix.cu BN, BK): the weight planes are padded to them
_MIX_COLS, _MIX_DEPTH = 136, 32


def mix_planes(w2: torch.Tensor) -> torch.Tensor:
    """K8's copy of the weight (N, D): its TF32 high and low planes,
    zero-padded to K8's column tile and depth stage, (2, Np, Dp) fp32."""
    N, D = w2.shape
    pad = (0, -D % _MIX_DEPTH, 0, -N % _MIX_COLS)
    return torch.stack([F.pad(p, pad) for p in tf32_split(w2.detach().float())]).contiguous()


class MixPlanes:
    """``mix_planes`` of one weight, made once per weight version (its data
    pointer and version are the key), not per call."""

    def __init__(self):
        self._key = None
        self._value = None

    def get(self, w2: torch.Tensor) -> torch.Tensor:
        key = (w2.data_ptr(), w2._version, w2.device, tuple(w2.shape))
        if key != self._key:
            self._value, self._key = mix_planes(w2), key
        return self._value


def channel_mix_plain(t2: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Plain K8: t2 (R, D) . w2 (N, D)^T -> (R, N) in fp32."""
    with fp32_exact():
        return torch.matmul(t2, w2.t())


def channel_mix(t2: torch.Tensor, w2: torch.Tensor, cache: MixPlanes | None = None) -> torch.Tensor:
    """K8 on the card, the plain version on the CPU: t2 (R, D) . w2 (N, D)^T
    -> (R, N) fp32. t2 is a float32 view with unit stride along D and rows a
    multiple of 4 floats apart, 16-byte aligned (the responses as
    ``ops.disco.responses_cl`` lays them out); ``cache`` keeps the weight's
    planes between calls."""
    if kernels.takes_plain("disco_mix", t2, w2):
        return channel_mix_plain(t2, w2)
    if t2.dtype != torch.float32 or w2.dtype != torch.float32 or t2.dim() != 2 or w2.dim() != 2 or t2.shape[1] != w2.shape[1]:
        raise ValueError(f"disco_mix: expected float32 t (R, D) and w (N, D), got {t2.dtype} {tuple(t2.shape)} and {w2.dtype} {tuple(w2.shape)}")
    R, D = t2.shape
    lda = t2.stride(0) if R > 1 else -(-D // 4) * 4
    if t2.stride(1) != 1 or lda % 4 or lda < D or t2.data_ptr() % 16:
        raise ValueError(f"disco_mix: t's rows must be contiguous, 16-byte aligned and a multiple of 4 floats apart, got strides {t2.stride()}")
    planes = (cache if cache is not None else MixPlanes()).get(w2)
    N = w2.shape[0]
    out = torch.empty(R, N, dtype=torch.float32, device=t2.device)
    if R == 0:
        return out
    lib = kernels.library()
    with torch.cuda.device(t2.device):
        err = lib.mt_disco_mix(t2.data_ptr(), lda, planes.data_ptr(), out.data_ptr(), R, D, N, planes.shape[1], planes.shape[2], kernels.stream_ptr(t2.device))
    kernels.check_launch(err, "disco_mix")
    kernels.count_launch("disco_mix")
    return out


class ChannelMix(torch.autograd.Function):
    """K8 (forward) with its backward, two cuBLAS GEMMs in full fp32:
    ``dt = dy . w2``, written with rows of ``t2``'s pixel stride (the
    responses' padded layout, which K12 reads in place; the pad columns of
    the product are the zero columns of the padded w2), and
    ``dw2 = dy^T . t2``. ``cache`` keeps w2's K8 planes between calls."""

    @staticmethod
    def forward(ctx, t2, w2, cache):
        ctx.save_for_backward(t2, w2)
        return channel_mix(t2, w2, cache)

    @staticmethod
    def backward(ctx, dy):
        t2, w2 = ctx.saved_tensors
        dt = dw = None
        with fp32_exact():
            if ctx.needs_input_grad[0]:
                R, D = t2.shape
                ld = t2.stride(0) if R > 1 and t2.stride(0) >= D else D
                dt = torch.matmul(dy, F.pad(w2, (0, ld - D)))[:, :D]
            if ctx.needs_input_grad[1]:
                dw = torch.matmul(dy.t(), t2)
        return dt, dw, None
