"""Bilinear resampling on the sphere (counterpart of ``ResampleS2`` in
``makani_tpu/ops/resample.py``, its gather method).

Separable bilinear interpolation between equiangular (or Legendre-Gauss)
lat-lon grids: a latitude lerp at precomputed (index, weight) pairs, then a
periodic longitude lerp, in the JAX package's order of operations.

Kernel K7 (CUDA, ``csrc/resample.cu``) replaces ``ResampleS2.__call__``
(:90-99), which XLA runs as index gathers and elementwise passes. It is bound
by memory bandwidth: at the FCN3 decoders (B 2, 360x720 -> 721x1440, 585
channels) it writes 4.9 GB and reads 1.2 GB. A block makes a tile of output
columns of one output row: it stages the latitude lerp of the two input rows
over the span of columns the tile needs in shared memory and writes the
tile's contiguous run of outputs 16 bytes at a time; the latitude-lerped
field never reaches device memory. The wrapper picks the tile width from the span the tables
give (``column_span``, computed once per table tensor). The matmul and
``auto`` methods serve the spatially sharded mesh and arrive with the
spatial-parallel slice.

Training: ``ResampleS2.resample_cl`` is differentiable. With the kernels it
is an autograd function whose backward is kernel K14 (CUDA,
``csrc/resample_grad.cu``), the transpose of K7 as a streamed walk down the
output rows: a block owns a tile of input columns and a strip of input
rows, stages each output row's segment of dy that the tile reads in a ring
of shared-memory slots, folds it along the longitude over the inverted
column lists (``column_lists``, zero weights dropped) and along the
latitude into a window of two row accumulators. Its launch plan
(``plan_resample_grad``) is made on the host once per resampler, device,
channel count and batch. Its plain version ``resample_cl_grad_plain`` is
the two lerps' scatter-adds, as autograd derives them.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from makani_torch import kernels
from makani_torch.ops.quadrature import precompute_latitudes

__all__ = [
    "ResampleS2",
    "ResampleGradPlan",
    "make_resample",
    "resample_cl",
    "resample_cl_plain",
    "resample_cl_grad",
    "resample_cl_grad_plain",
    "column_lists",
    "plan_resample_grad",
    "column_span",
]


def resample_cl_plain(x, lat_idx, lat_w, lon_idx0, lon_idx1, lon_w):
    """Plain version on channels-last x (B, Hin, Win, C) -> (B, Hout, Wout, C)."""
    lo = x[:, lat_idx]
    hi = x[:, lat_idx + 1]
    y = lo + (hi - lo) * lat_w.to(x.dtype)[None, :, None, None]
    y0 = y[:, :, lon_idx0]
    y1 = y[:, :, lon_idx1]
    return y0 + (y1 - y0) * lon_w.to(x.dtype)[None, None, :, None]


def resample_cl_grad_plain(dy, in_shape, lat_idx, lat_w, lon_idx0, lon_idx1, lon_w):
    """Plain K14: the transpose of ``resample_cl_plain``, dy (B, Hout, Wout,
    C) -> dx (B, Hin, Win, C), the lerps' scatter-adds in reverse order (the
    longitude lerp, then the latitude lerp)."""
    B, Hout, Wout, C = dy.shape
    Hin, Win = in_shape
    v = lon_w.to(dy.dtype)[None, None, :, None]
    dyl = dy.new_zeros(B, Hout, Win, C)
    dyl.index_add_(2, lon_idx0, dy - dy * v)
    dyl.index_add_(2, lon_idx1, dy * v)
    u = lat_w.to(dy.dtype)[None, :, None, None]
    dx = dy.new_zeros(B, Hin, Win, C)
    dx.index_add_(1, lat_idx, dyl - dyl * u)
    dx.index_add_(1, lat_idx + 1, dyl * u)
    return dx


def column_lists(lon_idx0, lon_idx1, lon_w, nlon_in: int):
    """K14's longitude lists from the forward's tables, on the host: (ptr
    (Win + 1,), idx, w), for each input column wi the output columns
    idx[ptr[wi] : ptr[wi + 1]] that read it, ascending, with their weights
    (1 - lon_w through lon_idx0, lon_w through lon_idx1); int64 lists,
    float32 weights. Zero weights are dropped: for finite dy they add
    exactly 0 (at a 2x upsampling the even output columns read the next
    input column with weight 0)."""
    w = np.asarray(lon_w, np.float32)
    dst = np.concatenate([np.asarray(lon_idx0, np.int64), np.asarray(lon_idx1, np.int64)])
    src = np.concatenate([np.arange(len(w)), np.arange(len(w))])
    wt = np.concatenate([np.float32(1.0) - w, w])
    keep = wt != 0
    dst, src, wt = dst[keep], src[keep], wt[keep]
    order = np.lexsort((src, dst))
    ptr = np.zeros(nlon_in + 1, np.int64)
    np.add.at(ptr, dst + 1, 1)
    return np.cumsum(ptr), src[order], wt[order]


def _column_run(wos: np.ndarray, nlon_out: int) -> tuple[int, int]:
    """The shortest run of output columns (start, length), modulo nlon_out,
    that holds every column of ``wos`` (not empty): it leaves out the widest
    gap between them."""
    u = np.unique(wos)
    gaps = np.diff(np.append(u, u[0] + nlon_out))
    i = int(np.argmax(gaps))
    return int(u[(i + 1) % len(u)]), nlon_out - int(gaps[i]) + 1


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


# K14's plan: the slot budget the default tile keeps to, the ring's depth,
# the blocks a launch aims for (per SM), the shortest strip, and the
# kernel's fixed shape (csrc/resample_grad.cu: THREADS / 32 warps, a warp's
# columns NC, widest first, and a lane's 32-channel groups GU as
# instantiated, NC x GU <= MAX_UNITS, MAX_RING, the record's header; the
# launch refuses a plan whose shape or shared memory is not the kernel's).
# Measured on an H100 (sweep_k14.py; PERF.md).
_GRAD_SLOT_BUDGET = 16 * 1024
_GRAD_RING = 3
_GRAD_BLOCKS_PER_SM = 8
_GRAD_MIN_STRIP = 16
_GRAD_SMS = 132  # an H100 SXM's SMs: the plan's default off the card
_GRAD_WARPS = 8
_GRAD_COLUMNS = (8, 4, 2, 1)
_GRAD_GROUPS = (1, 2, 4, 8, 12, 16, 20)
_GRAD_MAX_UNITS = 20
_GRAD_MAX_RING = 8
_GRAD_HEADER = 8


def _grad_smem_bytes(ring: int, slot_floats: int, tile_width: int, kt_max: int, groups: int) -> int:
    """K14's shared memory: the ring's mbarriers, slots and tables, and 32
    ``groups`` floats behind them that a lane past a pixel's channels may
    read. The plan passes it to the launch, which refuses a size that is
    not its layout's."""
    return (8 * ring + 15) // 16 * 16 + 4 * ring * slot_floats + 4 * ring * (4 + 2 * tile_width * kt_max) + 128 * groups


@dataclasses.dataclass(eq=False)
class ResampleGradPlan:
    """K14's launch plan (``csrc/resample_grad.cu``), made on the host by
    ``plan_resample_grad``. ``table`` (int32): ``n_records`` records of
    ``record_ints``, one per tile of ``tile_width`` input columns and
    channel chunk of ``channel_chunk`` channels (tile-major): a header
    {first column, width, first channel, channels, pieces, entries a column
    at most, 0, 0}, ``pieces_max`` pieces {start in a dy row (floats),
    floats, place in the slot}, and ``tile_width`` x ``kt_max`` column
    entries {offset in the slot, the piece's start mod 4, weight bits}, a
    column's list padded with zero weights; then ``n_strips`` strips {j0,
    j1, ho0, ho1}: the input rows [j0, j1) and the output rows [ho0, ho1)
    that reach them. A warp takes ``columns`` of a tile's columns
    (``tile_width`` = 8 ``columns``), a lane ``groups`` 32-channel groups of
    each."""

    in_shape: tuple
    out_shape: tuple
    channels: int
    tile_width: int
    channel_chunk: int
    strip_rows: int
    ring: int
    columns: int
    groups: int
    kt_max: int
    pieces_max: int
    slot_floats: int
    record_ints: int
    n_records: int
    n_strips: int
    smem_bytes: int
    table: np.ndarray
    _on: dict = dataclasses.field(default_factory=dict, repr=False)

    def records(self) -> np.ndarray:
        return self.table[: self.n_records * self.record_ints].reshape(self.n_records, self.record_ints)

    def strips(self) -> np.ndarray:
        return self.table[self.n_records * self.record_ints :].reshape(self.n_strips, 4)

    def table_on(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = torch.from_numpy(self.table).to(device)
        return self._on[device]

    def describe(self) -> str:
        return (
            f"tiles of {self.tile_width} input columns x {self.channel_chunk} of {self.channels} channels ({self.n_records} records), "
            f"{self.n_strips} strips of {self.strip_rows} rows, ring of {self.ring} slots of {4 * self.slot_floats / 1024:.1f} KB, "
            f"{self.columns} columns x {self.groups} channel groups a warp, {self.kt_max} entries a column at most, "
            f"{self.smem_bytes / 1024:.1f} KB of shared memory"
        )


def plan_resample_grad(lat_idx, lat_w, lon_idx0, lon_idx1, lon_w, in_shape, channels: int, batch: int, *, tile_width=None, channel_chunk=None,
                       strip_rows=None, ring=None, sms: int = _GRAD_SMS) -> ResampleGradPlan:
    """K14's launch plan for a (batch, Hout, Wout, channels) gradient of the
    resampling with the forward's tables, on the host. By default: the
    widest tile (8 input columns for each column a warp owns; all channels,
    else the widest 32-channel chunk) whose (column, group) pairs fit the
    kernel and whose slot fits ``_GRAD_SLOT_BUDGET`` (the narrowest such
    tile whatever its slot), strips that give
    ``_GRAD_BLOCKS_PER_SM`` blocks an SM (no shorter than
    ``_GRAD_MIN_STRIP`` rows), a ring of ``_GRAD_RING``; any of them can be
    given (a tile width a multiple of 8). Raises if lat_idx is not
    nondecreasing in [0, Hin - 2] or nothing fits in shared memory."""
    Hin, Win = in_shape
    li = np.asarray(lat_idx, np.int64)
    Hout, Wout, C = li.size, len(lon_idx0), int(channels)
    if Hin < 2 or li.min() < 0 or li.max() > Hin - 2:
        raise ValueError(f"resample_grad: lat_idx must lie in [0, {Hin - 2}]")
    if np.any(np.diff(li) < 0):
        raise ValueError("resample_grad: lat_idx must be nondecreasing (the kernel walks the output rows in order)")
    ring = _GRAD_RING if ring is None else int(ring)
    if not 2 <= ring <= _GRAD_MAX_RING:
        raise ValueError(f"resample_grad: a ring of {ring} slots (2 to {_GRAD_MAX_RING})")
    ptr, idx, w = column_lists(lon_idx0, lon_idx1, lon_w, Win)
    counts = np.diff(ptr)
    kt_max = max(1, int(counts.max()))

    tiles_of = {}

    def tiles(tw):
        if tw not in tiles_of:
            tl = []
            for wi0 in range(0, Win, tw):
                wi1 = min(wi0 + tw, Win)
                wos = idx[ptr[wi0] : ptr[wi1]]
                tl.append((wi0, wi1 - wi0, *(_column_run(wos, Wout) if wos.size else (0, 0))))
            tiles_of[tw] = tl
        return tiles_of[tw]

    def slot_floats(tw, cc):
        if cc == C:
            spans = [(min(n, Wout - s), n - min(n, Wout - s)) for _, _, s, n in tiles(tw)]
            need = max(_round4(na * C + 3) + (_round4(nb * C + 3) if nb else 0) for na, nb in spans)
        else:
            need = max(n for *_, n in tiles(tw)) * _round4(cc + 3)
        return max(4, need)

    chunks = [C] + [32 * k for k in range(min((C - 1) // 32, _GRAD_GROUPS[-1]), 0, -1)] if channel_chunk is None else [int(channel_chunk)]
    chosen = None
    for cc in chunks:
        gu = next((g for g in _GRAD_GROUPS if 32 * g >= cc), None)
        # a thread holds one entry of the tile's lists: tile_width * kt_max <= the block's threads
        ncs = [nc for nc in _GRAD_COLUMNS if gu and nc * gu <= _GRAD_MAX_UNITS and 8 * nc * kt_max <= 32 * _GRAD_WARPS]
        if tile_width is not None:
            ncs = [nc for nc in ncs if 8 * nc == tile_width]
        for nc in ncs:
            tw = 8 * nc
            sf = slot_floats(tw, cc)
            if tile_width is None and 4 * sf > _GRAD_SLOT_BUDGET and nc > ncs[-1]:
                continue
            smem = _grad_smem_bytes(ring, sf, tw, kt_max, gu)
            if smem <= _SMEM_MAX:
                chosen = (tw, cc, nc, gu, sf, smem)
                break
        if chosen:
            break
    if chosen is None:
        raise ValueError(f"resample_grad: no tile of {C} channels fits the kernel (tile width {tile_width}, chunk {channel_chunk}, ring {ring})")
    tw, cc, nc, gu, sf, smem = chosen

    tl = tiles(tw)
    n_chunks = -(-C // cc)
    n_records = len(tl) * n_chunks
    if strip_rows is None:
        n_strips = -(-_GRAD_BLOCKS_PER_SM * sms // (max(1, batch) * n_records))
        strip_rows = max(_GRAD_MIN_STRIP, -(-Hin // n_strips))
    strip_rows = min(max(1, int(strip_rows)), Hin)
    n_strips = -(-Hin // strip_rows)

    pieces_max = 2 if cc == C else max(1, max(n for *_, n in tl))
    record_ints = _GRAD_HEADER + 3 * pieces_max + 3 * tw * kt_max
    table = np.zeros(n_records * record_ints + 4 * n_strips, np.int32)
    wbits = w.view(np.int32)
    for t, (wi0, width, start, span) in enumerate(tl):
        na = min(span, Wout - start)
        for ci in range(n_chunks):
            c0 = ci * cc
            rec = table[(t * n_chunks + ci) * record_ints : (t * n_chunks + ci + 1) * record_ints]
            if cc == C:
                pcs = [(start * C, na * C, 0)] + ([(0, (span - na) * C, _round4(na * C + 3))] if span > na else []) if span else []
            else:
                stride = _round4(cc + 3)
                pcs = [(((start + q) % Wout) * C + c0, min(cc, C - c0), q * stride) for q in range(span)]
            rec[:6] = (wi0, width, c0, min(cc, C - c0), len(pcs), int(counts[wi0 : wi0 + width].max()))
            rec[_GRAD_HEADER : _GRAD_HEADER + 3 * len(pcs)] = np.asarray(pcs, np.int64).reshape(-1)
            ents = rec[_GRAD_HEADER + 3 * pieces_max :].reshape(tw, kt_max, 3)
            if pcs:
                ents[:, :, 1] = pcs[0][0] & 3
            for wl in range(width):
                for k, e in enumerate(range(ptr[wi0 + wl], ptr[wi0 + wl + 1])):
                    q = (int(idx[e]) - start) % Wout
                    if cc != C:
                        ents[wl, k, :2] = (q * stride, (int(idx[e]) * C + c0) & 3)
                    elif q < na:
                        ents[wl, k, :2] = (q * C, (start * C) & 3)
                    else:
                        ents[wl, k, :2] = (_round4(na * C + 3) + (q - na) * C, 0)
                    ents[wl, k, 2] = wbits[e]
    strips = table[n_records * record_ints :].reshape(n_strips, 4)
    j0 = np.arange(n_strips) * strip_rows
    j1 = np.minimum(j0 + strip_rows, Hin)
    strips[:] = np.stack([j0, j1, np.searchsorted(li, j0 - 1, "left"), np.searchsorted(li, j1 - 1, "right")], axis=1)
    return ResampleGradPlan(
        in_shape=(Hin, Win), out_shape=(Hout, Wout), channels=C, tile_width=tw, channel_chunk=cc, strip_rows=strip_rows, ring=ring, columns=nc, groups=gu,
        kt_max=kt_max, pieces_max=pieces_max, slot_floats=sf, record_ints=record_ints, n_records=n_records, n_strips=n_strips, smem_bytes=smem,
        table=table,
    )


def resample_cl_grad(dy, rs):
    """K14 on the card, the plain version on the CPU: dy (B, Hout, Wout, C)
    float32 -> dx (B, Hin, Win, C) contiguous, the transpose of the
    resampler ``rs``, on its plan for dy's shape (``ResampleS2.grad_plan``)."""
    tables = rs.tables(dy.device)
    if kernels.takes_plain("resample_grad", dy, *tables):
        li, lw, k0, k1, v = tables
        return resample_cl_grad_plain(dy, rs.in_shape, li.long(), lw, k0.long(), k1.long(), v)
    if dy.dim() != 4 or dy.dtype != torch.float32 or tuple(dy.shape[1:3]) != rs.out_shape:
        raise TypeError(f"resample_grad: expected a float32 (B, {rs.out_shape[0]}, {rs.out_shape[1]}, C) gradient, got {dy.dtype} {tuple(dy.shape)}")
    return _resample_grad_launch(dy, rs, rs.grad_plan(dy.device, dy.shape[3], dy.shape[0]))


def _resample_grad_launch(dy, rs, plan):
    """K14 on the card on ``plan`` (``plan_resample_grad`` for dy's shape)."""
    B, Hout, Wout, C = dy.shape
    Hin, Win = rs.in_shape
    tables = rs.tables(dy.device)
    dx = torch.empty(B, Hin, Win, C, dtype=torch.float32, device=dy.device)
    if dx.numel() == 0:
        return dx
    if plan.channels != C or plan.in_shape != rs.in_shape or plan.out_shape != rs.out_shape:
        raise ValueError(f"resample_grad: a plan for {plan.channels} channels {plan.out_shape} -> {plan.in_shape}, got {C} channels {rs.out_shape} -> {rs.in_shape}")
    # the kernel copies dy's rows from their 16-byte aligned floors
    dy = dy.contiguous()
    dy = dy if dy.data_ptr() % 16 == 0 else dy.clone()
    lib = kernels.library()
    with torch.cuda.device(dy.device):
        err = lib.mt_resample_grad(
            dy.data_ptr(), dx.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(), plan.table_on(dy.device).data_ptr(), B, Hin, Win, Hout, Wout, C,
            plan.tile_width, plan.ring, plan.columns, plan.groups, plan.kt_max, plan.pieces_max, plan.slot_floats, plan.record_ints, plan.n_records,
            plan.n_strips, plan.smem_bytes, kernels.stream_ptr(dy.device),
        )
    kernels.check_launch(err, "resample_grad")
    kernels.count_launch("resample_grad")
    return dx


class _Resample(torch.autograd.Function):
    """K7 (forward) and K14 (backward) of one ``ResampleS2``."""

    @staticmethod
    def forward(ctx, x, rs):
        ctx.rs = rs
        return resample_cl(x, *rs.tables(x.device))

    @staticmethod
    def backward(ctx, dy):
        return resample_cl_grad(dy, ctx.rs), None


def column_span(lon_idx0: np.ndarray, lon_idx1: np.ndarray, nlon_in: int, tw: int) -> int:
    """The widest run of input columns that K7 stages for a tile of ``tw``
    consecutive output columns: counted from the tile's first ``lon_idx0``,
    modulo ``nlon_in`` (the wrap from the last column to column 0), up to
    the farthest ``lon_idx0`` or ``lon_idx1`` of the tile, over all tiles."""
    k0 = np.asarray(lon_idx0, np.int64)
    k1 = np.asarray(lon_idx1, np.int64)
    start = k0[np.arange(k0.size) // tw * tw]
    return int(np.maximum((k0 - start) % nlon_in, (k1 - start) % nlon_in).max()) + 1


# K7's tile widths (output columns per block): the widest whose shared
# memory fits _SMEM_BUDGET (so that several blocks share an SM), else the
# narrowest within the card's 227 KB. Measured on an H100
# (sweep_k2_k7.py): 16 columns at the atmo decoder (585 channels), 64 at
# the surface decoder (56).
_TILE_WIDTHS = (64, 32, 16, 8, 4)
_SMEM_BUDGET = 32 * 1024
_SMEM_MAX = 227 * 1024

# id(lon_idx0) -> (tag, {tw: span}); an entry leaves with its table
_SPANS: dict = {}


def _spans(lon_idx0: torch.Tensor, lon_idx1: torch.Tensor, nlon_in: int) -> dict:
    key = id(lon_idx0)
    tag = (lon_idx0._version, lon_idx1._version, id(lon_idx1), nlon_in)
    hit = _SPANS.get(key)
    if hit is None or hit[0] != tag:
        if hit is None:
            weakref.finalize(lon_idx0, _SPANS.pop, key, None)
        k0, k1 = lon_idx0.cpu().numpy(), lon_idx1.cpu().numpy()
        hit = _SPANS[key] = (tag, {tw: column_span(k0, k1, nlon_in, tw) for tw in _TILE_WIDTHS})
    return hit[1]


def resample_cl(x, lat_idx, lat_w, lon_idx0, lon_idx1, lon_w):
    """Bilinear resampling of channels-last x (B, Hin, Win, C), any strides,
    to (B, Hout, Wout, C) contiguous: K7 on the card, the plain version on the
    CPU. Index tables int32, weights float32, on x's device."""
    if kernels.takes_plain("resample", x, lat_idx, lat_w, lon_idx0, lon_idx1, lon_w):
        return resample_cl_plain(x, lat_idx.long(), lat_w, lon_idx0.long(), lon_idx1.long(), lon_w)
    return _resample_launch(x, (lat_idx, lat_w, lon_idx0, lon_idx1, lon_w))


def _resample_launch(x, tables):
    """K7 on the card, at the widest tile (output columns per block) whose
    shared memory fits _SMEM_BUDGET."""
    lat_idx, lat_w, lon_idx0, lon_idx1, lon_w = tables
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"resample: expected float32/bfloat16 (B, H, W, C), got {x.dtype} {tuple(x.shape)}")
    for t, dt in zip(tables, (torch.int32, torch.float32, torch.int32, torch.int32, torch.float32)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"resample: tables must be contiguous 1-D int32 indices and float32 weights, got {t.dtype} {tuple(t.shape)}")
    B, _, Win, C = x.shape
    Hout, Wout = lat_idx.shape[0], lon_idx0.shape[0]
    y = torch.empty(B, Hout, Wout, C, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = kernels.library()
    spans = _spans(lon_idx0, lon_idx1, Win)
    fits = [tw for tw in _TILE_WIDTHS if lib.mt_resample_smem_bytes(C, tw, spans[tw]) <= _SMEM_BUDGET]
    tile_width = fits[0] if fits else _TILE_WIDTHS[-1]
    if lib.mt_resample_smem_bytes(C, tile_width, spans[tile_width]) > _SMEM_MAX:
        raise ValueError(f"resample: {C} channels over a span of {spans[tile_width]} input columns do not fit in shared memory")
    sB, sH, sW, sC = x.stride()
    with torch.cuda.device(x.device):
        err = lib.mt_resample(
            kernels.dtype_code(x.dtype), x.data_ptr(), y.data_ptr(), lat_idx.data_ptr(), lat_w.data_ptr(), lon_idx0.data_ptr(), lon_idx1.data_ptr(),
            lon_w.data_ptr(), B, Hout, Wout, Win, C, sB, sH, sW, sC, tile_width, spans[tile_width], kernels.stream_ptr(x.device),
        )
    kernels.check_launch(err, "resample")
    kernels.count_launch("resample")
    return y


class ResampleS2:
    """Bilinear resampling (nlat_in, nlon_in) -> (nlat_out, nlon_out); the
    tables are the JAX package's, kept as device tensors per device."""

    def __init__(self, nlat_in, nlon_in, nlat_out, nlon_out, grid_in="equiangular", grid_out="equiangular", mode="bilinear", method="gather"):
        if mode != "bilinear":
            raise NotImplementedError(f"resampling mode {mode}")
        if method != "gather":
            raise NotImplementedError(f"resampling method {method!r} is not ported yet (only 'gather')")
        self.method = method
        self.in_shape = (nlat_in, nlon_in)
        self.out_shape = (nlat_out, nlon_out)

        ti, _ = precompute_latitudes(nlat_in, grid=grid_in)
        to, _ = precompute_latitudes(nlat_out, grid=grid_out)

        j = np.clip(np.searchsorted(ti, to) - 1, 0, nlat_in - 2)
        w = (to - ti[j]) / (ti[j + 1] - ti[j])
        self.lat_idx = j.astype(np.int32)
        self.lat_w = np.clip(w, 0.0, 1.0).astype(np.float32)

        phi_out = np.arange(nlon_out) * (2 * np.pi / nlon_out)
        pos = phi_out / (2 * np.pi / nlon_in)
        k = np.floor(pos).astype(np.int64)
        v = (pos - k).astype(np.float32)
        self.lon_idx0 = (k % nlon_in).astype(np.int32)
        self.lon_idx1 = ((k + 1) % nlon_in).astype(np.int32)
        self.lon_w = v.astype(np.float32)
        self._tables = {}

    def tables(self, device):
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = tuple(
                torch.from_numpy(a).to(device) for a in (self.lat_idx, self.lat_w, self.lon_idx0, self.lon_idx1, self.lon_w)
            )
        return self._tables[device]

    def grad_plan(self, device, channels: int, batch: int) -> ResampleGradPlan:
        """K14's launch plan for a (batch, Hout, Wout, channels) gradient on
        ``device`` (``plan_resample_grad`` for its SMs), made once."""
        device = torch.device(device)
        key = ("grad", device, channels, batch)
        if key not in self._tables:
            sms = torch.cuda.get_device_properties(device).multi_processor_count if device.type == "cuda" else _GRAD_SMS
            self._tables[key] = plan_resample_grad(
                self.lat_idx, self.lat_w, self.lon_idx0, self.lon_idx1, self.lon_w, self.in_shape, channels, batch, sms=sms
            )
        return self._tables[key]

    def resample_cl(self, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        """Channels-last (B, Hin, Win, C) -> (B, Hout, Wout, C); with the
        kernels an autograd function (K7, K14), else plain PyTorch ops that
        autograd differentiates."""
        if use_kernels:
            return _Resample.apply(x, self)
        li, lw, k0, k1, v = self.tables(x.device)
        return resample_cl_plain(x, li.long(), lw, k0.long(), k1.long(), v)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The JAX package's layout: (..., Hin, Win) -> (..., Hout, Wout)."""
        lead = x.shape[:-2]
        y = self.resample_cl(x.reshape(-1, *self.in_shape, 1))
        return y.reshape(*lead, *self.out_shape)


def make_resample(nlat_in, nlon_in, nlat_out, nlon_out, grid_in="equiangular", grid_out="equiangular", mode="bilinear") -> ResampleS2:
    """The serial resampler (counterpart of the serial branch of
    ``makani_tpu/parallel/resample.py`` ``make_resample``)."""
    return ResampleS2(nlat_in, nlon_in, nlat_out, nlon_out, grid_in=grid_in, grid_out=grid_out, mode=mode)
