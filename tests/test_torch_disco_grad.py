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
with u*a = (win - off - w) mod Win) and K14's gather over
``inverse_tables``, each against its plain version.
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

SHAPES = [((17, 32), (9, 16)), ((16, 32), (16, 32)), ((13, 32), (11, 24))]
TOL = 1e-5


def _tol(out, ref, rel=TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rel * np.max(np.abs(ref)), np.max(np.abs(out - ref)) / np.max(np.abs(ref))


def _pair(in_shape, out_shape):
    kw = dict(basis_type="morlet th", basis_norm_mode="mean")
    return jdisco.DiscoConvS2(in_shape, out_shape, (3, 3), **kw), disco.DiscoConvS2(in_shape, out_shape, (3, 3), **kw)


def _call(tc, x, use_kernels):
    """The port's ``__call__`` on x (B, C, H, W), through either route."""
    t, t_pol = tc.responses_cl(x.permute(0, 2, 3, 1), use_kernels)
    if t_pol is not None:
        t = t.index_add(1, tc.polar_index(x.device)[1], t_pol.permute(0, 1, 4, 2, 3))
    return t.permute(0, 3, 4, 1, 2)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("in_shape,out_shape", SHAPES)
def test_responses_gradient_matches_jax(in_shape, out_shape, use_kernels):
    jc, tc = _pair(in_shape, out_shape)
    assert tc.polar_rows
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


def test_k14_gather_replays_the_plain_transpose():
    """K14's inverted tables (csrc/resample_grad.cu's loops, in numpy)
    against the plain scatter-adds, at a downsampling whose last output rows
    clamp at the poles."""
    rs = resample.ResampleS2(17, 32, 9, 20, grid_in="equiangular", grid_out="legendre-gauss")
    rng = np.random.default_rng(5)
    dy = rng.standard_normal((2, 9, 20, 3)).astype(np.float32)
    tabs = rs.tables("cpu")
    ref = resample.resample_cl_grad(torch.from_numpy(dy), rs.inverse_tables("cpu"), rs.in_shape, tabs)
    rp, ri, rw, cp, ci, cw = (t.numpy() for t in rs.inverse_tables("cpu"))
    dx = np.zeros((2, 17, 32, 3))
    for hi in range(17):
        for r in range(rp[hi], rp[hi + 1]):
            for wi in range(32):
                s = sum(cw[k] * dy[:, ri[r], ci[k]] for k in range(cp[wi], cp[wi + 1]))
                dx[:, hi, wi] += rw[r] * s
    _tol(dx, ref)
