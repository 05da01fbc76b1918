"""The gradients of makani_torch's DISCO convolution and resampling against
makani_tpu's ``jax.vjp``, on the CPU.

``responses_cl`` (the JAX package's ``DiscoConvS2.__call__``, polar rows
inserted), ``fused_cl`` (``.fused``, both polar contraction orders: og*BL >
ig contracts psi first, og*BL <= ig mixes first) and ``ResampleS2.
resample_cl`` (``ResampleS2.__call__``) take the same seeded numpy input and
cotangent in both packages. Three DISCO grids with polar rows: input stride
a = 2 with one phase (an encoder-like downsampling), a = 1, and b = 3
phases (a = 4). The port runs its kernels' autograd functions (K12 for the
banded part, K13 for the polar rows, K14 for the resampling; on the CPU
their plain versions) and, with ``use_kernels=False``, autograd through the
plain forward. The gradients are held to 1e-5 of max|ref| in fp32: sums of
at most a few hundred products in other orders (the JAX package takes its
DFTs as matmuls on the CPU, the port ``torch.fft``).

Two checks hold the index arithmetic that the CUDA kernels do on the host's
tables, replayed here in numpy: K12's gather (for each input row the output
latitudes of ``band_grad_rows``, their live taps, and the output column u
with u*a = (win - off - w) mod Win) and K14's walk over its plan
(``plan_resample_grad``: tiles, strips, the staged pieces with their
aligned floors, the pruned column lists and the two-row window), each
against its plain version; and K14's plan itself against loops over the
forward's tables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from makani_tpu.ops import disco as jdisco
from makani_tpu.ops.resample import ResampleS2 as JResampleS2

from makani_torch import kernels
from makani_torch.ops import disco, disco_kernels, resample
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [((17, 32), (9, 16)), ((16, 32), (16, 32)), ((13, 32), (11, 24))]
TOL = 1e-5


def _tol(out, ref, rel=TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rel * np.max(np.abs(ref)), np.max(np.abs(out - ref)) / np.max(np.abs(ref))


def _pair(in_shape, out_shape, basis_type="morlet th"):
    kw = dict(basis_type=basis_type, basis_norm_mode="mean")
    return jdisco.DiscoConvS2(in_shape, out_shape, (3, 3), **kw), disco.DiscoConvS2(in_shape, out_shape, (3, 3), **kw)


def _call(tc, x, use_kernels):
    """The port's ``__call__`` on x (B, C, H, W), through either route."""
    t, t_pol = tc.responses_cl(x.permute(0, 2, 3, 1), use_kernels)
    if t_pol is not None:
        t = t.index_add(1, tc.polar_index(x.device)[1], t_pol.permute(0, 1, 4, 2, 3))
    return t.permute(0, 3, 4, 1, 2)


# FCN3.1's K 7 (piecewise linear 3 x 3) at a small grid, stride 1
K7_SHAPES = [((17, 32), (17, 32))]


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("in_shape,out_shape", SHAPES + K7_SHAPES)
def test_responses_gradient_matches_jax(in_shape, out_shape, use_kernels):
    jc, tc = _pair(in_shape, out_shape, "piecewise linear" if (in_shape, out_shape) in K7_SHAPES else "morlet th")
    assert tc.polar_rows and tc.K == (7 if (in_shape, out_shape) in K7_SHAPES else 9)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, *in_shape)).astype(np.float32)
    y, vjp = jax.vjp(jax.jit(jc.__call__), jnp.asarray(x))
    ct = rng.standard_normal(y.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    kernels.reset_launch_counts()
    out = _call(tc, xt, use_kernels)
    _tol(out.detach(), y)
    (out * torch.from_numpy(ct)).sum().backward()
    assert not any(kernels.LAUNCHES.values())
    _tol(xt.grad, ref)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("channels", [(3, 2, 4), (2, 1, 8)])
@pytest.mark.parametrize("in_shape,out_shape", SHAPES)
def test_fused_gradients_match_jax(in_shape, out_shape, channels, use_kernels):
    """(3, 2, 4) contracts the polar rows psi first, (2, 1, 8) mixes first;
    the gradients with respect to x and to the weight."""
    jc, tc = _pair(in_shape, out_shape)
    g, og, ig = channels
    assert (og * tc.BL <= ig) == (channels == (2, 1, 8))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, g * ig, *in_shape)).astype(np.float32)
    w = (0.2 * rng.standard_normal((g, og, ig, tc.K))).astype(np.float32)
    y, vjp = jax.vjp(jax.jit(jc.fused), jnp.asarray(x), jnp.asarray(w))
    ct = rng.standard_normal(y.shape).astype(np.float32)
    rx, rw = vjp(jnp.asarray(ct))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    out = tc.fused_cl(xt.permute(0, 2, 3, 1), wt, use_kernels).permute(0, 3, 1, 2)
    _tol(out.detach(), y)
    (out * torch.from_numpy(ct)).sum().backward()
    _tol(xt.grad, rx)
    _tol(wt.grad, rw)


def test_fused_weight_gradient_in_chunks(monkeypatch):
    """The weight gradient's responses made a few output rows (and one
    sample) at a time equal the gradient made at once."""
    tc = disco.DiscoConvS2((13, 32), (11, 24), (3, 3), basis_type="morlet th")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 13, 32, 2 * 3 * 4)).astype(np.float32))
    w = torch.from_numpy((0.2 * rng.standard_normal((3, 2, 4, tc.K))).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 11, 24, 2 * 3 * 2)).astype(np.float32))
    whole = tc._fused_weight_grad(x, dy, w.shape)
    per_row = (24 // tc.phases) * x.shape[-1] * tc.K * 4
    monkeypatch.setattr(disco, "_WGRAD_CHUNK_BYTES", 4 * per_row)
    _tol(tc._fused_weight_grad(x, dy, w.shape), whole, 1e-6)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("shapes", [((9, 16, "legendre-gauss"), (17, 32, "equiangular")), ((17, 32, "equiangular"), (9, 20, "legendre-gauss"))])
def test_resample_gradient_matches_jax(shapes, use_kernels):
    """Upsampling onto a grid with pole rows (the decoders' direction) and
    downsampling (the output rows that clamp at the poles)."""
    (hi, wi, gi), (ho, wo, go) = shapes
    jr = JResampleS2(hi, wi, ho, wo, grid_in=gi, grid_out=go)
    tr = resample.ResampleS2(hi, wi, ho, wo, grid_in=gi, grid_out=go)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, hi, wi)).astype(np.float32)
    y, vjp = jax.vjp(jax.jit(jr.__call__), jnp.asarray(x))
    ct = rng.standard_normal(y.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    out = tr.resample_cl(xt.permute(0, 2, 3, 1), use_kernels).permute(0, 3, 1, 2)
    _tol(out.detach(), y)
    (out * torch.from_numpy(ct)).sum().backward()
    _tol(xt.grad, ref)


def _k12_gather(conv, dout, F_, p, C, IG, Gf, OG):
    """K12's loops (csrc/disco_band_grad.cu), vectorised over the channels:
    for each input pixel, the output latitudes of its row list, their live
    taps, and the output column each tap lands on."""
    Hin, Win = conv.in_shape
    Wout = conv.out_shape[1]
    b, a = conv.phases, conv.stride
    n_out, off = Wout // b, int(conv.bases[p]) - conv.halo
    taps = conv.tap_table(p, "cpu").numpy()
    row_ptr, row_h = (t.numpy() for t in conv.grad_rows(p, "cpu"))
    F_ = F_.numpy()
    dout = dout.numpy()
    ch = np.arange(C)
    g, i = ch // IG, ch % IG
    dx = np.zeros((dout.shape[0], Hin, Win, C), np.float64)
    for hi in range(Hin):
        for h in row_h[row_ptr[hi] : row_ptr[hi + 1]]:
            j = hi - conv.band_start[h]
            lo, hw = taps[h, j]
            assert hw > lo
            for w in range(lo, hw):
                for wi in range(Win):
                    d = (wi - off - w) % Win
                    u = d // a
                    if u * a != d or u >= n_out:
                        continue
                    src = dout[:, h, p + b * u].reshape(dout.shape[0], -1, OG)[:, g]  # (B, C, OG)
                    dx[:, hi, wi] += np.einsum("bco,co->bc", src, F_[h, g % Gf, i, j, w, :OG])
    return dx


@pytest.mark.parametrize("in_shape,out_shape", SHAPES)
def test_k12_gather_replays_the_plain_transpose(in_shape, out_shape):
    """K12's row lists and column arithmetic on the host's tables, in both
    modes (responses, and fused with Gf < G and IG > 1), against its plain
    version, phase by phase."""
    conv = disco.DiscoConvS2(in_shape, out_shape, (3, 3), basis_type="morlet th")
    rng = np.random.default_rng(4)
    B, (Hout, Wout) = 1, out_shape
    w = torch.from_numpy((0.2 * rng.standard_normal((2, 1, 3, conv.K))).astype(np.float32))
    cache = disco.FusedFilterCache()
    for mode, C, IG, Gf, OG in (("responses", 2, 1, 1, conv.K), ("fused", 2 * 2 * 3, 3, 2, 1)):
        for p in range(conv.phases):
            F_ = conv.band_filter(p, "cpu") if mode == "responses" else cache.get(conv, w, p)
            dout = torch.from_numpy(rng.standard_normal((B, Hout, Wout, C // IG * OG)).astype(np.float32))
            dx = torch.empty(B, *in_shape, C)
            disco_kernels.band_contract_grad_plain(
                dout, F_, conv.band_start_table("cpu"), dx, a=conv.stride, off=int(conv.bases[p]) - conv.halo, n_out=Wout // conv.phases,
                phase=p, phases=conv.phases, Gf=Gf, IG=IG, OG=OG, accumulate=False,
            )
            _tol(_k12_gather(conv, dout, F_, p, C, IG, Gf, OG), dx)


def test_band_grad_rows_are_the_live_band_rows():
    conv = disco.DiscoConvS2((17, 32), (9, 16), (3, 3), basis_type="morlet th")
    row_ptr, row_h = (t.numpy() for t in conv.grad_rows(0, "cpu"))
    taps = conv.tap_table(0, "cpu").numpy()
    assert row_ptr[0] == 0 and row_ptr[-1] == len(row_h) == int((taps[..., 1] > taps[..., 0]).sum())
    for hi in range(conv.in_shape[0]):
        hs = row_h[row_ptr[hi] : row_ptr[hi + 1]]
        want = [h for h in range(conv.out_shape[0]) if 0 <= hi - conv.band_start[h] < conv.BL and np.diff(taps[h, hi - conv.band_start[h]])[0] > 0]
        assert hs.tolist() == want
    assert not set(conv.polar_rows) & set(row_h.tolist())


def _k14_walk(plan, dy, rs):
    """csrc/resample_grad.cu's walk, block by block, in numpy: each output
    row of a strip staged from its pieces' 16-byte aligned floors (a piece
    lands lead floats in; zeros past its end), folded over the tile's column
    entries at the row's offsets, and into the two-row window; a completed
    row stored once, unread rows as zeros. Returns dx and the number of
    times each element was stored."""
    B, Hout, Wout, C = dy.shape
    Hin, Win = plan.in_shape
    flat = dy.reshape(-1)
    dx = np.zeros((B, Hin, Win, C), np.float32)
    stored = np.zeros(dx.shape, np.int64)
    for b in range(B):
        for rec in plan.records():
            wi0, tw, c0, cc, n_pieces, kt = (int(v) for v in rec[:6])
            pieces = rec[8 : 8 + 3 * plan.pieces_max].reshape(-1, 3)[:n_pieces]
            ents = rec[8 + 3 * plan.pieces_max :].reshape(plan.tile_width, plan.kt_max, 3)
            for j0, j1, ho0, ho1 in plan.strips():
                nxt = j0

                def store(q, acc):
                    dx[b, q, wi0 : wi0 + tw, c0 : c0 + cc] = acc
                    stored[b, q, wi0 : wi0 + tw, c0 : c0 + cc] += 1

                def flush(q, acc):
                    nonlocal nxt
                    if q < j0:
                        return
                    for z in range(nxt, q):
                        store(z, 0.0)
                    store(q, acc)
                    nxt = q + 1

                a0, a1, r = np.zeros((tw, cc), np.float32), np.zeros((tw, cc), np.float32), None
                for ho in range(ho0, ho1):
                    row = ((b * Hout + ho) * Wout) * C
                    slot = np.full(plan.slot_floats, np.nan, np.float32)
                    for gs, length, sb in pieces:
                        lead = (row + gs) % 4
                        n16 = (lead + length + 3) // 4
                        slot[sb : sb + 4 * n16] = 0.0
                        slot[sb : sb + lead + length] = flat[row + gs - lead : row + gs + length]
                    i, u = int(rs.lat_idx[ho]), np.float32(rs.lat_w[ho])
                    if r is None:
                        r = i
                    elif i != r:
                        flush(r, a0)
                        if i == r + 1:
                            a0, a1 = a1, np.zeros_like(a1)
                        else:
                            flush(r + 1, a1)
                            a0, a1 = np.zeros_like(a0), np.zeros_like(a1)
                        r = i
                    for wl in range(tw):
                        for k in range(kt):
                            off, m, wb = ents[wl, k]
                            o = off + (row % 4 + m) % 4
                            assert o + cc <= plan.slot_floats
                            v = np.int32(wb).view(np.float32)
                            a0[wl] += (np.float32(1) - u) * v * slot[o : o + cc]
                            a1[wl] += u * v * slot[o : o + cc]
                if r is not None:
                    flush(r, a0)
                    if r + 1 < j1:
                        flush(r + 1, a1)
                for z in range(nxt, j1):
                    store(z, 0.0)
    return dx, stored


# (input grid, output grid, channels, the plan's tile width, channel chunk,
# strip rows and ring; None: the plan's default)
K14_WALKS = [
    # upsampling onto pole rows, the wrap column, tiles of 8 columns into 15, dy rows not 16-byte multiples (30 x 3 floats)
    ((9, 15, "legendre-gauss"), (17, 30, "equiangular"), 3, dict(tile_width=8, strip_rows=2, ring=2)),
    # downsampling: output rows clamped at the poles, input columns no output column reads
    ((17, 36, "equiangular"), (9, 20, "legendre-gauss"), 3, dict(tile_width=16, strip_rows=3, ring=3)),
    # channel chunks: one piece a pixel
    ((9, 20, "legendre-gauss"), (17, 40, "equiangular"), 37, dict(tile_width=8, channel_chunk=16, strip_rows=4)),
    # the default plan
    ((18, 36, "legendre-gauss"), (37, 72, "equiangular"), 3, {}),
]


@pytest.mark.parametrize("grid_in,grid_out,C,choice", K14_WALKS)
def test_k14_gather_replays_the_plain_transpose(grid_in, grid_out, C, choice):
    """K14's walk over its plan (csrc/resample_grad.cu's loops, in numpy)
    against the plain scatter-adds: every dx element stored once."""
    (hi, wi, gi), (ho, wo, go) = grid_in, grid_out
    rs = resample.ResampleS2(hi, wi, ho, wo, grid_in=gi, grid_out=go)
    plan = resample.plan_resample_grad(rs.lat_idx, rs.lat_w, rs.lon_idx0, rs.lon_idx1, rs.lon_w, rs.in_shape, C, 2, **choice)
    for key, value in choice.items():
        assert getattr(plan, key) == value
    rng = np.random.default_rng(5)
    dy = rng.standard_normal((2, ho, wo, C)).astype(np.float32)
    ref = resample.resample_cl_grad(torch.from_numpy(dy), rs)
    dx, stored = _k14_walk(plan, dy, rs)
    assert (stored == 1).all()
    _tol(dx, ref)


def test_k14_plan_covers_the_grid_once():
    """K14's plan against loops over the forward's tables: the records
    cover every (input column, channel) once and the strips every input
    row; each tile's pieces hold exactly the shortest run of output columns
    that read it with a nonzero weight; each strip's output rows are those
    whose lat_idx lies in [j0 - 1, j1 - 1]. A lat_idx that decreases
    raises."""
    for (hi, wi, gi), (ho, wo, go), C, choice in K14_WALKS:
        rs = resample.ResampleS2(hi, wi, ho, wo, grid_in=gi, grid_out=go)
        plan = resample.plan_resample_grad(rs.lat_idx, rs.lat_w, rs.lon_idx0, rs.lon_idx1, rs.lon_w, rs.in_shape, C, 2, **choice)
        cover = np.zeros((wi, C), np.int64)
        for rec in plan.records():
            wi0, tw, c0, cc, n_pieces, kt = (int(v) for v in rec[:6])
            cover[wi0 : wi0 + tw, c0 : c0 + cc] += 1
            need = sorted({o for o in range(wo) for k, w in ((rs.lon_idx0[o], 1 - rs.lon_w[o]), (rs.lon_idx1[o], rs.lon_w[o])) if wi0 <= k < wi0 + tw and w != 0})
            pieces = rec[8 : 8 + 3 * plan.pieces_max].reshape(-1, 3)[:n_pieces]
            pixels = [(int(gs) - c0) // C + q for gs, length, _ in pieces for q in range(int(length) // min(cc, C))]
            if not need:
                assert n_pieces == 0 and kt == 0
                continue
            shortest = min(max((o - s) % wo for o in need) + 1 for s in need)
            assert set(need) <= set(pixels) and len(pixels) == len(set(pixels)) == shortest
            assert kt == max(sum(1 for o in range(wo) for k, w in ((rs.lon_idx0[o], 1 - rs.lon_w[o]), (rs.lon_idx1[o], rs.lon_w[o])) if k == c and w != 0)
                             for c in range(wi0, wi0 + tw))
        assert (cover == 1).all()
        rows = np.zeros(hi, np.int64)
        for j0, j1, ho0, ho1 in plan.strips():
            rows[j0:j1] += 1
            assert list(range(ho0, ho1)) == [h for h in range(ho) if j0 - 1 <= rs.lat_idx[h] <= j1 - 1]
        assert (rows == 1).all()
    li = rs.lat_idx.copy()
    li[[3, 4]] = li[[4, 3]] if li[3] != li[4] else (li[3] + 1, li[3])
    with pytest.raises(ValueError, match="nondecreasing"):
        resample.plan_resample_grad(li, rs.lat_w, rs.lon_idx0, rs.lon_idx1, rs.lon_w, rs.in_shape, 3, 2)
