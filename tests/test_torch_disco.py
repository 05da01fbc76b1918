"""makani_torch's DISCO convolution against makani_tpu's, on the CPU.

The host tables (cutoffs, basis counts, psi) are float64 numpy copied from
the JAX package and must be bit-equal. The device side (the banded part and
the polar rows, here through the kernels' plain versions) is held to
1e-5 * max|ref| in fp32 against the JAX package's jitted functions, on three
grids with polar rows: input stride a = 2 with one phase (an encoder-like
downsampling), a = 1 with one phase, and b = 3 phases. The fused conv is
checked in both polar contraction orders (og*BL <= ig mixes first) against
the JAX package's default ``_fused_dense`` and its ``_fused_window``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from makani_tpu.ops import disco as jdisco

from makani_torch import kernels
from makani_torch.ops import disco
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [((17, 32), (9, 16)), ((16, 32), (16, 32)), ((13, 32), (11, 24))]
BASES = ["morlet th", "piecewise linear", "harmonic"]


def _tol(out, ref, rel=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rel * np.max(np.abs(ref))


@pytest.mark.parametrize("basis", BASES + ["piecewise linear th", "tabulated"])
@pytest.mark.parametrize("shapes", [SHAPES[0], SHAPES[2]])
def test_psi_tables_and_cutoffs_bit_equal(shapes, basis):
    in_shape, out_shape = shapes
    ks = (3, 3)
    if basis == "tabulated":
        rng = np.random.default_rng(5)
        table = dict(vals=rng.standard_normal((4, 9, 16)), r=np.linspace(0.0, 0.4, 9), alpha=np.arange(16) * 2 * np.pi / 16, r_cutoff=0.35)
        basis = disco.register_basis_table("t5", table)
        assert jdisco.register_basis_table("t5", table) == basis
    assert disco.num_basis_functions(ks, basis) == jdisco.num_basis_functions(ks, basis)
    cut = disco.compute_cutoff_radius(in_shape[0], ks, basis)
    assert cut == jdisco.compute_cutoff_radius(in_shape[0], ks, basis)
    assert disco.compute_cutoff_radius_lmax(12, ks, basis) == jdisco.compute_cutoff_radius_lmax(12, ks, basis)
    args = (in_shape, out_shape, ks, "equiangular", "legendre-gauss", cut, "mean", basis)
    t, j = disco._precompute_psi(*args), jdisco._precompute_psi(*args)
    assert set(t) == set(j)
    for key in t:
        assert np.array_equal(np.asarray(t[key]), np.asarray(j[key])), key


# points a run: 200 puts 2 rows in each run of the band tables and 1 in
# each of the full-longitude ones and the sums; 2500, 2 in each of the sums
@pytest.mark.parametrize("points", [200, 2500])
@pytest.mark.parametrize("norm", ["mean", "nodal", "support"])
@pytest.mark.parametrize("shapes", [SHAPES[0], SHAPES[2]])
def test_psi_tables_bit_equal_in_runs_of_rows(shapes, norm, points, monkeypatch):
    """The tables evaluated a few rows a run on host threads (as at the
    full grids) keep the JAX package's bits: points, polar rows and the
    normalization's sums alike."""
    in_shape, out_shape = shapes
    ks = (3, 3)
    cut = disco.compute_cutoff_radius(in_shape[0], ks, "harmonic")
    args = (in_shape, out_shape, ks, "equiangular", "legendre-gauss", cut, norm, "harmonic")
    monkeypatch.setattr(disco, "_PSI_CHUNK_POINTS", points)
    t, j = disco._precompute_psi.__wrapped__(*args), jdisco._precompute_psi(*args)
    assert t["polar_rows"] and set(t) == set(j)
    for key in t:
        assert np.array_equal(np.asarray(t[key]), np.asarray(j[key])), key


def _pair(in_shape, out_shape):
    kw = dict(basis_type="morlet th", basis_norm_mode="mean")
    return jdisco.DiscoConvS2(in_shape, out_shape, (3, 3), **kw), disco.DiscoConvS2(in_shape, out_shape, (3, 3), **kw)


@pytest.mark.parametrize("in_shape,out_shape", SHAPES)
def test_call_and_call_split_match_jax(in_shape, out_shape):
    jc, tc = _pair(in_shape, out_shape)
    assert tc.polar_rows and (tc.stride, tc.phases) == (jc.stride, jc.phases)
    x = np.random.default_rng(0).standard_normal((2, 3, *in_shape)).astype(np.float32)
    ref = jax.jit(jc.__call__)(jnp.asarray(x))
    t_ref, tp_ref = jax.jit(jc.call_split)(jnp.asarray(x))
    kernels.reset_launch_counts()
    _tol(tc(torch.from_numpy(x)), ref)
    t, tp = tc.call_split(torch.from_numpy(x))
    assert not any(kernels.LAUNCHES.values())
    assert np.array_equal(np.asarray(t)[:, :, :, tc.polar_rows], np.zeros_like(np.asarray(t)[:, :, :, tc.polar_rows]))
    _tol(t, t_ref)
    _tol(tp, tp_ref)


@pytest.mark.parametrize("mode", ["dense", "window"])
@pytest.mark.parametrize("channels", [(3, 2, 4), (2, 1, 8)])
@pytest.mark.parametrize("in_shape,out_shape", SHAPES)
def test_fused_matches_jax(in_shape, out_shape, channels, mode, monkeypatch):
    """(3, 2, 4) contracts psi first (og*BL > ig), (2, 1, 8) mixes first."""
    monkeypatch.setenv("MAKANI_DISCO_FUSED", mode)
    jc, tc = _pair(in_shape, out_shape)
    g, og, ig = channels
    assert (og * tc.BL <= ig) == (channels == (2, 1, 8))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, g * ig, *in_shape)).astype(np.float32)
    w = (0.2 * rng.standard_normal((g, og, ig, tc.K))).astype(np.float32)
    ref = jax.jit(jc.fused)(jnp.asarray(x), jnp.asarray(w))
    _tol(tc.fused(torch.from_numpy(x), torch.from_numpy(w)), ref)


def test_fused_stacked_inputs_and_filter_cache():
    """R stacked inputs on the channel axis equal R separate convs (the JAX
    package's batch fold; the CPU convolution blocks a larger batch in
    another order, hence 1e-6), and the fused filter is rebuilt only when the
    weight changes."""
    tc = disco.DiscoConvS2((16, 32), (16, 32), (3, 3), basis_type="morlet th")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 3 * 2 * 4, 16, 32)).astype(np.float32))
    w = torch.from_numpy((0.2 * rng.standard_normal((2, 3, 4, tc.K))).astype(np.float32))
    cache = disco.FusedFilterCache()
    y = tc.fused(x, w, cache=cache)
    f0 = cache.get(tc, w, 0)
    assert cache.get(tc, w, 0) is f0
    for r in range(3):
        _tol(y[:, r * 6 : (r + 1) * 6], tc.fused(x[:, r * 8 : (r + 1) * 8], w), rel=1e-6)
    with torch.no_grad():
        w.mul_(2.0)
    assert cache.get(tc, w, 0) is not f0


def test_make_disco_conv_is_the_serial_conv():
    from makani_tpu.parallel.disco import make_disco_conv as jmake

    conv = disco.make_disco_conv((16, 32), (16, 32), (3, 3), basis_type="morlet th", grid_in="legendre-gauss", grid_out="legendre-gauss")
    ref = jmake((16, 32), (16, 32), (3, 3), basis_type="morlet th", grid_in="legendre-gauss", grid_out="legendre-gauss")
    assert isinstance(conv, disco.DiscoConvS2)
    assert np.array_equal(conv.psi_band, ref.psi_band) and conv.polar_rows == ref.polar_rows


@pytest.mark.parametrize("K", [9, 7])
@pytest.mark.parametrize("order", ["psi_first", "mix_first"])
def test_polar_plain_matches_jax_formulation(order, K, monkeypatch):
    """K6's plain versions, in cuFFT's layout (modes last), against the JAX
    package's polar rows at K = 9 (morlet th) and K = 7 (piecewise linear),
    3 phases, 5 channels: psi first through ``call_split`` (the ``__call__``
    einsum ``bcpjm,kpjm->bckpm``), mix first through ``fused``
    (``_polar_fused_phase``)."""
    from makani_torch.ops import disco_kernels

    calls = []
    plain = getattr(disco_kernels, f"polar_{order}_plain")
    monkeypatch.setattr(disco_kernels, f"polar_{order}_plain", lambda *a: calls.append(a[0].shape) or plain(*a))
    in_shape, out_shape = SHAPES[2]
    kw = dict(basis_type={9: "morlet th", 7: "piecewise linear"}[K], basis_norm_mode="mean")
    jc, tc = jdisco.DiscoConvS2(in_shape, out_shape, (3, 3), **kw), disco.DiscoConvS2(in_shape, out_shape, (3, 3), **kw)
    assert (tc.K, tc.phases) == (K, 3)
    rng = np.random.default_rng(3)
    if order == "psi_first":
        x = rng.standard_normal((2, 5, *in_shape)).astype(np.float32)
        _, ref = jax.jit(jc.call_split)(jnp.asarray(x))
        out = tc.call_split(torch.from_numpy(x))[1]
    else:
        g, og, ig = 1, 5, 5 * tc.BL
        x = rng.standard_normal((2, g * ig, *in_shape)).astype(np.float32)
        w = (0.2 * rng.standard_normal((g, og, ig, K))).astype(np.float32)
        ref = jax.jit(jc.fused)(jnp.asarray(x), jnp.asarray(w))
        out = tc.fused(torch.from_numpy(x), torch.from_numpy(w))
    assert len(calls) == tc.phases
    _tol(out, ref)


@pytest.mark.parametrize("path", ["responses", "fused_psi_first", "fused_mix_first"])
def test_polar_ffts_transform_the_last_axis(path, monkeypatch):
    """The polar rows' rFFT and irFFT run on the last axis of a contiguous
    operand (cuFFT's own layout: no clone, no transposing copy)."""
    calls = []
    for name in ("rfft", "irfft"):
        fn = getattr(torch.fft, name)

        def rec(inp, *args, fn=fn, name=name, **kw):
            calls.append((name, kw.get("dim"), inp.dim(), inp.is_contiguous()))
            return fn(inp, *args, **kw)

        monkeypatch.setattr(torch.fft, name, rec)
    tc = disco.DiscoConvS2((13, 32), (11, 24), (3, 3), basis_type="morlet th")
    rng = np.random.default_rng(4)
    if path == "responses":
        tc.responses_cl(torch.from_numpy(rng.standard_normal((1, 13, 32, 3)).astype(np.float32)))
    else:
        g, og, ig = (3, 2, 4) if path == "fused_psi_first" else (2, 1, 8)
        x = torch.from_numpy(rng.standard_normal((1, g * ig, 13, 32)).astype(np.float32)).permute(0, 2, 3, 1)
        tc.fused_cl(x, torch.from_numpy(rng.standard_normal((g, og, ig, tc.K)).astype(np.float32)))
    assert [c[0] for c in calls] == ["rfft"] + ["irfft"] * tc.phases
    assert all(d in (-1, n - 1) and contiguous for _, d, n, contiguous in calls), calls


# the GPU tests' DISCO shapes (stride 2; stride 1; 3 phases) and an encoder-
# like stride-2 shape
TAP_SHAPES = [((33, 64), (17, 32)), ((24, 48), (24, 48)), ((13, 32), (11, 24)), SHAPES[0]]


@pytest.mark.parametrize("in_shape,out_shape", TAP_SHAPES)
def test_live_tap_table(in_shape, out_shape):
    """K5's tap table, scattered back into a (Hout, BL, WW) mask, is exactly
    where some psi_k is nonzero; its dead latitudes are exactly the polar
    rows; a fused filter w (x) psi is zero outside its runs."""
    conv = disco.DiscoConvS2(in_shape, out_shape, (3, 3), basis_type="morlet th", basis_norm_mode="mean")
    w = torch.from_numpy((0.2 * np.random.default_rng(6).standard_normal((3, 2, 4, conv.K))).astype(np.float32))
    cache = disco.FusedFilterCache()
    for p in range(conv.phases):
        taps = conv.tap_table(p, "cpu")
        assert taps.dtype == torch.int32 and taps.shape == (conv.out_shape[0], conv.BL, 2)
        lo, hi = taps[..., :1], taps[..., 1:]
        wv = torch.arange(conv.WW)
        mask = (wv >= lo) & (wv < hi)
        assert torch.equal(mask, torch.from_numpy((conv.psi_band[p] != 0).any(axis=0)))
        dead = torch.nonzero(~mask.any(dim=(1, 2))).flatten().tolist()
        assert dead == conv.polar_rows
        F_ = cache.get(conv, w, p)  # (Hout, Gf, IG, BL, WW, OGp)
        assert not F_.permute(0, 3, 4, 1, 2, 5)[~mask].any()


def test_live_tap_table_refuses_split_rows():
    psi = np.zeros((2, 3, 2, 7), np.float32)
    psi[0, 1, 0, 1:3] = 1.0
    psi[1, 2, 1, 4] = -1.0
    runs = disco.live_tap_runs(psi)
    assert runs.tolist() == [[[0, 0], [0, 0]], [[1, 3], [0, 0]], [[0, 0], [4, 5]]]
    psi[1, 1, 0, 5] = 2.0  # a second run in latitude 1, band row 0
    with pytest.raises(ValueError, match="latitude 1, band row 0"):
        disco.live_tap_runs(psi)


def test_plain_band_contract_guards_tf32(monkeypatch):
    """The plain K5's cuDNN conv runs with TF32 off whatever the global flags
    say, and the flags found are restored afterwards (here set to TF32 for
    both cuDNN and cuBLAS, as a user may set them)."""
    from makani_torch.ops import disco_kernels

    seen = []
    conv1d = torch.nn.functional.conv1d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()))
        return conv1d(*args, **kwargs)

    monkeypatch.setattr(disco_kernels.F, "conv1d", spy)
    tc = disco.DiscoConvS2((16, 32), (16, 32), (3, 3), basis_type="morlet th", basis_norm_mode="mean")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 16, 32, 3)).astype(np.float32))
    found = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        ref, _ = tc.responses_cl(x)
        assert seen and all(s == (False, False, "highest") for s in seen)
        assert torch.backends.cudnn.allow_tf32 and torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cudnn.allow_tf32 = found[0]
        torch.set_float32_matmul_precision(found[1])
    t, _ = tc.responses_cl(x)
    assert torch.equal(t, ref)
