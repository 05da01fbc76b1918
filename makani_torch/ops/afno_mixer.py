"""The AFNO spectral mixer: kernels K18 (forward) and K19 (backward).

The mixer of FourCastNet v1 and AFNOv2 is a block-diagonal complex two-layer
MLP over the 2-D spectrum of the token grid, followed by a band of kept modes
and a soft-shrink. The JAX package writes it as split re/im einsums
(``makani_tpu/models/networks/afnonet.py:78-97`` for v1,
``afnonet_v2.py:33-39`` ``_compl_mul_add_s`` and ``:77-92`` for v2). Per
spectral mode and channel block k, with x the block's complex bs-vector:

    o1 = relu(W1[k]^T x + b1[k])      relu on re and im apart ("cartesian")
    o2 = W2[k]^T o1 + b2[k]
    y  = softshrink(band ? o2 : 0, lambda)   on re and im apart

v1 carries the biases b1, b2 and keeps the reference's centered rows
(``band_v1``); v2 has no inner bias and keeps both ends of the unhalved axis
(``band_v2``). ``afno_mixer_plain`` is the einsums in plain PyTorch, the
kernels' plain version; ``afno_mixer`` takes K18 (``csrc/afno_mixer.cu``) on
a CUDA tensor, inside a ``torch.autograd.Function`` whose backward is K19
(``csrc/afno_mixer_grad.cu``), and the plain version on a CPU tensor. K18
keeps o1 for K19 when the call is differentiated (in inference o1 never goes
to device memory), mode-contiguous: a (B, nb, hbs, H Wh, 2) storage behind
the (B, nb, H Wh, hbs, 2) view that ``afno_mixer_plain(return_hidden=True)``
returns (``hidden_like``). K19's mode sums are fixed-order partials and a
second pass, so a step repeats bit for bit.

Both kernels are bound by operations: at ``afno_73ch`` (90 x 91 modes, C 768,
8 blocks of 96) K18 does 9.66 GFLOP on 100.6 MB, K19 twice the products. Both
run their complex products on the tensor cores (wgmma, 3xTF32; ``csrc/afno.cuh``).
The spectra are fp32 (the JAX mixer upcasts around its FFT) in the
channels-last (B, H, Wh, C, 2) shape, in any storage whose rows and columns
flatten into one mode index: the kernels read it through strides, in place
(the rFFT's output is such a view, over a channels-first storage). The
weights are taken as (nb, 2, rows, cols) and the biases as (nb, 2, cols), the
[re, im] part second: views of either flax layout, which the kernels read in
place through their strides and in whose layouts K19 writes the gradients.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from makani_torch import kernels
from makani_torch.ops.precision import fp32_exact

__all__ = [
    "Band", "band_v1", "band_v2", "afno_mixer", "afno_mixer_plain", "afno_mixer_grad_plain", "launch_afno_mixer", "launch_afno_mixer_grad", "grad_splits",
    "grad_ranges", "hidden_like", "spectrum_strides",
]


@dataclasses.dataclass(frozen=True)
class Band:
    """The kept modes of an (H, Wh) spectrum: rows [ra0, ra1) and [rb0, rb1)
    of the unhalved axis, columns [0, kc) of the halved one."""

    ra0: int
    ra1: int
    rb0: int
    rb1: int
    kc: int

    def full(self, H: int, Wh: int) -> bool:
        return self.ra0 <= 0 and self.ra1 >= H and self.kc >= Wh

    def mask(self, H: int, Wh: int, device) -> torch.Tensor:
        r = torch.arange(H, device=device)[:, None]
        c = torch.arange(Wh, device=device)[None, :]
        return (c < self.kc) & (((r >= self.ra0) & (r < self.ra1)) | ((r >= self.rb0) & (r < self.rb1)))

    def args(self) -> tuple:
        return (self.ra0, self.ra1, self.rb0, self.rb1, self.kc)


def band_v1(H: int, Wh: int, fraction: float) -> Band:
    """FourCastNet v1's band (``afnonet.py:84-94``): below fraction 1 the
    ``kept = int((H // 2 + 1) fraction)`` rows about row H // 2 + 1 (the
    reference's centered convention) and the first ``kept`` columns; all
    modes otherwise."""
    total = H // 2 + 1
    kept = int(total * fraction)
    if kept >= total:
        return Band(0, H, 0, 0, Wh)
    return Band(max(0, total - kept), min(H, total + kept), 0, 0, kept)


def band_v2(H: int, Wh: int, fraction: float) -> Band:
    """AFNOv2's band (``afnonet_v2.py:81-90``): the first and last ``kH =
    int((H // 2 + 1) fraction)`` rows and the first ``int(Wh fraction)``
    columns, or all modes where both keep everything."""
    kH, kW = int((H // 2 + 1) * fraction), int(Wh * fraction)
    if kH == H // 2 + 1 and kW == Wh:
        return Band(0, H, 0, 0, Wh)
    return Band(0, kH, H - kH, H, kW)


def _softshrink(v: torch.Tensor, lambd: float) -> torch.Tensor:
    return torch.sign(v) * torch.clamp(torch.abs(v) - lambd, min=0.0)


def _blocks(x2, nb: int):
    """(re, im) of a spectrum as (B, H, Wh, nb, bs) each."""
    B, H, Wh, C, _ = x2.shape
    return x2[..., 0].reshape(B, H, Wh, nb, C // nb), x2[..., 1].reshape(B, H, Wh, nb, C // nb)


def _spectrum(re, im):
    """The inverse of ``_blocks``."""
    B, H, Wh = re.shape[:3]
    return torch.stack([re.reshape(B, H, Wh, -1), im.reshape(B, H, Wh, -1)], dim=-1)


def _cmul(ar, ai, wr, wi, conj: bool = False):
    """(ar + i ai) times (wr + i wi), or its conjugate weight, summed over
    the blocks' input index: the split re/im einsums of the JAX package."""

    def ein(a, w):
        return torch.einsum("...ki,kio->...ko", a, w)

    if conj:
        return ein(ar, wr) + ein(ai, wi), ein(ai, wr) - ein(ar, wi)
    return ein(ar, wr) - ein(ai, wi), ein(ai, wr) + ein(ar, wi)


def afno_mixer_plain(x2, w1, b1, w2, b2, lambd: float, band: Band, return_hidden: bool = False):
    """The mixer as the JAX package's split re/im einsums, the kernels'
    plain version: x2 fp32 (B, H, Wh, C, 2), w1 (nb, 2, bs, hbs), w2 (nb, 2,
    hbs, bs), b1 (nb, 2, hbs) and b2 (nb, 2, bs) or None. Returns y (B, H,
    Wh, C, 2) (and with ``return_hidden`` the hidden o1 after the relu as K18
    keeps it, (B, nb, H Wh, hbs, 2) in K18's mode-contiguous storage,
    ``hidden_like``)."""
    nb = w1.shape[0]
    xr, xi = _blocks(x2, nb)
    B, H, Wh = xr.shape[:3]
    with fp32_exact():
        o1r, o1i = _cmul(xr, xi, w1[:, 0], w1[:, 1])
        if b1 is not None:
            o1r, o1i = o1r + b1[:, 0], o1i + b1[:, 1]
        o1r, o1i = torch.relu(o1r), torch.relu(o1i)
        o2r, o2i = _cmul(o1r, o1i, w2[:, 0], w2[:, 1])
    if b2 is not None:
        o2r, o2i = o2r + b2[:, 0], o2i + b2[:, 1]
    if not band.full(H, Wh):
        keep = band.mask(H, Wh, x2.device)[:, :, None, None]
        o2r = torch.where(keep, o2r, 0.0)
        o2i = torch.where(keep, o2i, 0.0)
    y = _spectrum(_softshrink(o2r, lambd), _softshrink(o2i, lambd))
    if not return_hidden:
        return y
    h = torch.stack([o1r, o1i], dim=-1).permute(0, 3, 4, 1, 2, 5).reshape(B, nb, -1, H * Wh, 2).contiguous()
    return y, h.transpose(2, 3)


def afno_mixer_grad_plain(x2, y, dy, h, w1, b1, w2, b2):
    """K19's plain version, on K19's inputs: the spectrum x2, K18's output y
    and hidden o1 ``h``, the output gradient dy, the weights. The
    soft-shrink's and the band's slope is (y != 0), the relu's (o1 > 0), as
    in the kernel; everything else is the split re/im einsums. Returns (dx,
    dw1, db1, dw2, db2) in K18's shapes, the biases' None without biases (the
    biases are taken for that alone).
    (Autograd through ``afno_mixer_plain`` gives the same where no
    pre-activation sits within rounding of a slope's edge.)"""
    nb, has_bias = w1.shape[0], b1 is not None
    B, _, HW, hbs, _ = h.shape
    gr, gi = _blocks(dy, nb)
    yr, yi = _blocks(y, nb)
    xr, xi = _blocks(x2, nb)
    H, Wh = xr.shape[1:3]
    hv = h.reshape(B, nb, H, Wh, hbs, 2).permute(0, 2, 3, 1, 4, 5)
    g2r, g2i = torch.where(yr != 0, gr, 0.0), torch.where(yi != 0, gi, 0.0)
    with fp32_exact():
        d1r, d1i = _cmul(g2r, g2i, w2[:, 0].transpose(1, 2), w2[:, 1].transpose(1, 2), conj=True)
        g1r, g1i = torch.where(hv[..., 0] > 0, d1r, 0.0), torch.where(hv[..., 1] > 0, d1i, 0.0)
        dxr, dxi = _cmul(g1r, g1i, w1[:, 0].transpose(1, 2), w1[:, 1].transpose(1, 2), conj=True)

        def wgrad(ar, ai, br, bi):
            # sum over modes of conj(a) (x) b
            def ein(u, v):
                return torch.einsum("bhwki,bhwko->kio", u, v)

            return torch.stack([ein(ar, br) + ein(ai, bi), ein(ar, bi) - ein(ai, br)], dim=1)

        dw1 = wgrad(xr, xi, g1r, g1i)
        dw2 = wgrad(hv[..., 0], hv[..., 1], g2r, g2i)
    db1 = torch.stack([g1r.sum(dim=(0, 1, 2)), g1i.sum(dim=(0, 1, 2))], dim=1) if has_bias else None
    db2 = torch.stack([g2r.sum(dim=(0, 1, 2)), g2i.sum(dim=(0, 1, 2))], dim=1) if has_bias else None
    return _spectrum(dxr, dxi), dw1, db1, dw2, db2


def spectrum_strides(x2: torch.Tensor):
    """(sB, sM, sC) in floats of a (B, H, Wh, C, 2) spectrum whose rows and
    columns flatten into one mode index (stride of a row = Wh strides of a
    column) with [re, im] adjacent, or None; and its (B, H, Wh, C).
    ``torch.fft.rfft2`` over (1, 2) of a channels-last tensor gives the (B,
    C, H, Wh) storage behind a (B, H, Wh, C) view: the kernels read it in
    place."""
    B, H, Wh, C, _ = x2.shape
    sB, sH, sW, sC, s2 = x2.stride()
    ok = s2 == 1 and (H == 1 or sH == Wh * sW) and sB % 2 == 0 and sW % 2 == 0 and sC % 2 == 0 and x2.storage_offset() % 2 == 0
    return ((sB, sW, sC) if ok else None), (B, H, Wh, C)


def hidden_like(B: int, nb: int, M: int, hbs: int, device) -> torch.Tensor:
    """An fp32 (B, nb, M, hbs, 2) buffer for o1 or g1 in the kernels'
    mode-contiguous storage (B, nb, hbs, M, 2): each channel's modes one run,
    as in the rFFT's storage, so that K19's weight pass reads every operand's
    depth (the modes) contiguously."""
    return torch.empty(B, nb, hbs, M, 2, dtype=torch.float32, device=device).transpose(2, 3)


def _is_hidden(h: torch.Tensor) -> bool:
    B, nb, M, hbs, _ = h.shape
    return h.stride() == hidden_like(B, nb, M, hbs, "meta").stride() and h.storage_offset() == 0


def _flat_modes(x2: torch.Tensor) -> torch.Tensor:
    """x2 itself where the kernels can read it, else a contiguous copy."""
    return x2 if spectrum_strides(x2)[0] is not None else x2.contiguous()


def _dense(t: torch.Tensor) -> bool:
    """Whether t's elements tile its storage span once (a permutation of a
    contiguous tensor): K19 writes a gradient in such a layout."""
    span = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda p: p[1]):
        if size != 1:
            if stride != span:
                return False
            span *= size
    return True


def _dense_or_copy(t):
    return t if t is None or _dense(t) else t.contiguous()


def _param_strides(w1, b1, w2, b2):
    """The 16 strides (in floats) through which the kernels read the weights
    and biases in place, as ``afno.cuh`` Params: each weight's (block, part,
    row, column), each bias's (block, part, 0, column), zeros for a missing
    bias."""

    def four(t, bias):
        if t is None:
            return (0, 0, 0, 0)
        s = t.stride()
        return (s[0], s[1], 0, s[2]) if bias else s

    return (ctypes.c_longlong * 16)(*four(w1, False), *four(w2, False), *four(b1, True), *four(b2, True))


def _check(x2, w1, b1, w2, b2):
    if x2.dtype != torch.float32 or w1.dtype != torch.float32 or w2.dtype != torch.float32:
        raise TypeError(f"afno_mixer: the kernels take fp32 spectra and weights, got {x2.dtype}, {w1.dtype}, {w2.dtype}")
    if x2.dim() != 5 or x2.shape[-1] != 2:
        raise ValueError(f"afno_mixer: expected a split spectrum (..., 2) of 5 dimensions, got {tuple(x2.shape)}")
    strides, (B, H, Wh, C) = spectrum_strides(x2)
    if strides is None:
        raise ValueError(f"afno_mixer: the spectrum's modes do not flatten (strides {x2.stride()})")
    nb, two, bs, hbs = w1.shape
    if two != 2 or nb * bs != C or tuple(w2.shape) != (nb, 2, hbs, bs) or not (_dense(w1) and _dense(w2)):
        raise ValueError(f"afno_mixer: spectrum {tuple(x2.shape)} and weights {tuple(w1.shape)}, {tuple(w2.shape)} do not fit")
    for b, n in ((b1, hbs), (b2, bs)):
        if b is not None and (tuple(b.shape) != (nb, 2, n) or b.dtype != torch.float32 or not _dense(b)):
            raise ValueError(f"afno_mixer: bias {tuple(b.shape)} {b.dtype} does not fit ({nb}, 2, {n}) fp32")
    return strides, (B, H, Wh, C, nb, bs, hbs)


def launch_afno_mixer(x2, w1, b1, w2, b2, lambd: float, band: Band, keep_hidden: bool = False):
    """Launch K18 on fp32 tensors on one CUDA device: x2 a spectrum the
    kernels can read (``spectrum_strides``), the weights and biases in any
    dense layout (read in place). Returns y (x2's strides) and o1 (B, nb, H
    Wh, hbs, 2) (``hidden_like``'s storage) when ``keep_hidden``, else None."""
    (sB, sM, sC), (B, H, Wh, C, nb, bs, hbs) = _check(x2, w1, b1, w2, b2)
    y = torch.empty_like(x2)
    h = hidden_like(B, nb, H * Wh, hbs, x2.device) if keep_hidden else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = kernels.library()
    with torch.cuda.device(x2.device):
        err = lib.mt_afno_mixer(
            x2.data_ptr(), y.data_ptr(), ptr(h), w1.data_ptr(), ptr(b1), w2.data_ptr(), ptr(b2), _param_strides(w1, b1, w2, b2), B, H * Wh, Wh, nb, bs, hbs,
            sB, sM, sC, *band.args(),
            float(lambd), kernels.stream_ptr(x2.device),
        )
    kernels.check_launch(err, "afno_mixer")
    kernels.count_launch("afno_mixer")
    return y, h


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_WROWS, _WCH, _NS = 128, 48, 16  # K19's weight-pass tile: rows, output channels, modes a stage


def grad_splits(B: int, M: int, nb: int, bs: int, hbs: int, sms: int = 132) -> int:
    """K19's mode ranges S: the weight pass runs one block (128 rows of dW1
    or dW2 by 48 output channels, of one channel block, over one range) on
    each streaming multiprocessor at a time, so S takes the most ranges whose
    blocks fill the card once, at least one and at most one a 16 modes."""
    tiles = max(math.ceil(bs / _WROWS) * math.ceil(hbs / _WCH), math.ceil(hbs / _WROWS) * math.ceil(bs / _WCH)) * nb * 2
    return max(1, min(math.ceil(B * M / _NS), sms // tiles, 32767))


def grad_ranges(B: int, M: int, S: int) -> list:
    """The S mode ranges [lo, hi) of the B M modes (sample-major) over which
    K19's weight pass sums, as the kernel cuts them: range s is [B M s / S,
    B M (s + 1) / S)."""
    R = B * M
    return [(R * s // S, R * (s + 1) // S) for s in range(S)]


def launch_afno_mixer_grad(x2, y, dy, h, w1, b1, w2, b2, band: Band):
    """Launch K19 (three kernels: the data gradients, the weight gradients'
    partials over S mode ranges, their fixed-order sum) on fp32 tensors: x2
    and y as K18 took and gave them, h K18's o1, dy, the weights and biases
    as K18 took them (the biases only for their layouts). dy is read through
    its own strides where its modes flatten (``spectrum_strides``), else
    copied. Returns (dx (x2's strides), dw1, db1, dw2, db2), each in its
    parameter's shape and strides (db1, db2 None without biases)."""
    (sB, sM, sC), (B, H, Wh, C, nb, bs, hbs) = _check(x2, w1, b1, w2, b2)
    has_bias = b1 is not None
    if y.stride() != x2.stride() or tuple(h.shape) != (B, nb, H * Wh, hbs, 2) or not _is_hidden(h):
        raise ValueError("afno_mixer_grad: y and o1 must be K18's")
    if dy.shape != x2.shape or dy.dtype != torch.float32:
        raise ValueError(f"afno_mixer_grad: dy {tuple(dy.shape)} {dy.dtype} does not match the spectrum {tuple(x2.shape)}")
    dy = _flat_modes(dy)
    dB, dM, dC = spectrum_strides(dy)[0]
    M = H * Wh
    S = grad_splits(B, M, nb, bs, hbs, _sms(x2.device.index or 0))
    lib = kernels.library()
    dev = x2.device
    dx = torch.empty_like(x2)
    g1 = hidden_like(B, nb, M, hbs, dev)
    like = lambda t: None if t is None else torch.empty_strided(t.shape, t.stride(), dtype=torch.float32, device=dev)  # noqa: E731
    dw1, db1, dw2, db2 = like(w1), like(b1), like(w2), like(b2)
    scratch = torch.empty(lib.mt_afno_grad_scratch(S, nb, bs, hbs, int(has_bias)), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = lib.mt_afno_mixer_grad(
            x2.data_ptr(), y.data_ptr(), dy.data_ptr(), h.data_ptr(), w1.data_ptr(), w2.data_ptr(), _param_strides(w1, b1, w2, b2), dx.data_ptr(), g1.data_ptr(),
            dw1.data_ptr(),
            ptr(db1), dw2.data_ptr(), ptr(db2), scratch.data_ptr(), S, B, M, Wh, nb, bs, hbs, sB, sM, sC, dB, dM, dC, *band.args(), kernels.stream_ptr(dev),
        )
    kernels.check_launch(err, "afno_mixer_grad")
    kernels.count_launch("afno_mixer_grad")
    return dx, dw1, db1, dw2, db2


class _Mixer(torch.autograd.Function):
    """K18 forward (keeping o1 and y when differentiated), K19 backward."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, lambd, band):
        x2 = _flat_modes(x2)
        w1, b1, w2, b2 = (_dense_or_copy(t) for t in (w1, b1, w2, b2))
        train = any(ctx.needs_input_grad[:5])
        y, h = launch_afno_mixer(x2, w1, b1, w2, b2, lambd, band, keep_hidden=train)
        ctx.band = band
        if train:
            ctx.save_for_backward(x2, y, h, w1, b1, w2, b2)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, y, h, w1, b1, w2, b2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = launch_afno_mixer_grad(x2, y, dy, h, w1, b1, w2, b2, ctx.band)
        return dx, dw1, db1, dw2, db2, None, None


def afno_mixer(x2, w1, b1, w2, b2, lambd: float, band: Band) -> torch.Tensor:
    """The mixer: K18 (differentiable through K19) on a CUDA tensor,
    ``afno_mixer_plain`` on a CPU one. Arguments as ``afno_mixer_plain``."""
    params = [t for t in (w1, b1, w2, b2) if t is not None]
    if kernels.takes_plain("afno_mixer", x2, *params):
        return afno_mixer_plain(x2, w1, b1, w2, b2, lambd, band)
    if (b1 is None) != (b2 is None):
        raise ValueError("afno_mixer: the kernels take both biases or neither")
    return _Mixer.apply(x2, w1, b1, w2, b2, lambd, band)
