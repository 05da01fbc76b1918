"""makani_torch's hand-written kernels against their plain PyTorch versions,
on the card. The kernels have no CPU mode, so these tests carry the ``gpu``
marker and skip without a CUDA device; run them on a GPU machine with

    python -m pytest tests/test_torch_kernels.py -m gpu -q

Shapes are small and ragged (not multiples of the kernels' tiles).
Tolerances: fp32 max|diff| <= 1e-5 * max|ref| (summation order); bf16
max|diff| within one bf16 ulp of max|ref|, or relative L2 <= 1e-2.
"""

import dataclasses
import math
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from makani_torch import kernels
from makani_torch.models.common.contractions import _PermutedWeight, contract_dense_s, contract_dense_s_plain
from makani_torch.models.common import layer_norm
from makani_torch.models.common.layer_norm import instance_norm_cl, instance_norm_cl_plain
from makani_torch.models.networks.fourcastnet3 import AtmoSphericNeuralOperatorNet
from makani_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet
from makani_torch.ops import disco_kernels, resample, sht
from makani_torch.ops.disco import DiscoConvS2, FusedFilterCache, compute_cutoff_radius
from makani_torch.ops.resample import ResampleS2
from makani_torch.ops.sht import (
    InverseRealSHT,
    RealSHT,
    analysis_contract_cl_s,
    analysis_contract_cl_s_plain,
    synthesis_contract_cl_s,
    synthesis_contract_cl_s_plain,
)
from sweep_k2_k7 import k2_route, k7_width

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _agree(out, ref, dtype):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    if dtype == torch.float32:
        return err <= 1e-5 * scale
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    return err <= ulp or (out - ref).norm().item() <= 1e-2 * ref.norm().item()


def _randn(shape, dtype, device, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(device=device, dtype=dtype)


# (721, 1440, ..., 8): K1's full 721-deep sum, where the tensor cores'
# truncating accumulation would show; C 37: rows of 74 floats, not 16-byte
# aligned (K1 then copies and stores 8 bytes at a time)
SHT_CASES = [
    (25, 48, "equiangular", None, None, 5),
    (13, 24, "legendre-gauss", 10, 9, 3),
    (91, 180, "equiangular", 70, 71, 40),
    (91, 180, "equiangular", 70, 71, 37),
    (721, 1440, "equiangular", 240, 241, 8),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nlat,nlon,grid,lmax,mmax,C", SHT_CASES)
def test_legendre_kernels_match_plain(cuda, nlat, nlon, grid, lmax, mmax, C, dtype):
    sht = RealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
    isht = InverseRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
    x = _randn((2, nlat, sht.mmax, C, 2), dtype, cuda)
    c = _randn((2, isht.lmax, isht.mmax, C, 2), dtype, cuda, seed=1)
    w, p = sht.weights(cuda, dtype), isht.pct(cuda, dtype)
    kernels.reset_launch_counts()
    a = analysis_contract_cl_s(x, w)
    s = synthesis_contract_cl_s(c, p)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sht_analysis"] == 1 and kernels.LAUNCHES["sht_synthesis"] == 1
    assert a.dtype == dtype and _agree(a, analysis_contract_cl_s_plain(x, w), dtype)
    assert s.dtype == dtype and _agree(s, synthesis_contract_cl_s_plain(c, p), dtype)


# K2's fp32 routes (sht.synthesis_route: the narrow kernel up to N = 32, the
# tensor cores above). lmax = mmax = nlat: the whole triangle, as the noise's
# 721-degree table; C 8 and 1: the noise's N 16 and the smallest N; C 16 and
# 17: N 32 and 34, either side of the crossover; C 677: FCN3's 1354-float
# rows (8-byte copies and stores); (360, 720, legendre-gauss, 360, 361):
# FCN3's 360-deep sum, where the tensor cores' truncating accumulation would
# show, and an order m = 360 with no degree l >= m.
K2_CASES = [
    (181, 362, "equiangular", 181, 181, 8, 1),
    (181, 362, "equiangular", 181, 181, 1, 2),
    (91, 180, "equiangular", 91, 91, 16, 2),
    (91, 180, "equiangular", 91, 91, 17, 2),
    (33, 64, "legendre-gauss", 32, 33, 677, 2),
    (360, 720, "legendre-gauss", 360, 361, 64, 2),
    (360, 720, "legendre-gauss", 360, 361, 8, 1),
]


@pytest.mark.parametrize("nlat,nlon,grid,lmax,mmax,C,B", K2_CASES)
def test_k2_routes_match_plain(cuda, nlat, nlon, grid, lmax, mmax, C, B):
    isht = InverseRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
    c = _randn((B, isht.lmax, isht.mmax, C, 2), torch.float32, cuda, seed=2)
    p = isht.pct(cuda)
    ref = synthesis_contract_cl_s_plain(c, p)
    kernels.reset_launch_counts()
    out = synthesis_contract_cl_s(c, p)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sht_synthesis"] == 1 and _agree(out, ref, torch.float32)
    narrow = sht.synthesis_route(2 * C) == "narrow"
    assert narrow == (2 * C <= 32)
    # the narrow route makes no planes of the table
    assert ((id(p), "synthesis") in sht._PLANES) != narrow
    # both routes where both hold N, straight from the library
    for route in ("tc", "narrow") if narrow else ("tc",):
        assert _agree(k2_route(c, p, route), ref, torch.float32), route


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# (1, 9, 10, 1, 37, 45): FCN3-like odd widths whose rows are not 16-byte
# aligned; (1, 3, 300, 2, 40, 70): more rows than one 128-row tile
@pytest.mark.parametrize(
    "B,L,M,G,Ci,Co", [(2, 7, 6, 1, 5, 3), (1, 70, 71, 2, 20, 36), (1, 12, 13, 1, 48, 48), (1, 9, 10, 1, 37, 45), (1, 3, 300, 2, 40, 70)]
)
def test_dhconv_kernel_matches_plain(cuda, B, L, M, G, Ci, Co, dtype):
    x = _randn((B, L, M, G, Ci, 2), dtype, cuda)
    w = _randn((G, Ci, Co, L, 2), torch.float32, cuda, seed=1)
    kernels.reset_launch_counts()
    out = contract_dense_s(x, w, False, "dhconv", True, weight_cache=_PermutedWeight())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dhconv"] == 1
    assert out.dtype == dtype and _agree(out, contract_dense_s_plain(x, w, False, "dhconv", True), dtype)


# (2, 37, 50, 70): C not a multiple of the 16-byte loads (one channel a
# load), B = 2; nlat_phys 30 < H; (1, 64, 128, 384) and (2, 45, 90, 384):
# 16-byte loads, one and several channel groups
NORM_CASES = [((2, 37, 50, 70), None), ((2, 37, 50, 70), 30), ((1, 64, 128, 384), None), ((2, 45, 90, 384), 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,nlat_phys", NORM_CASES)
def test_instance_norm_kernel_matches_plain(cuda, shape, nlat_phys, dtype):
    x = 3.0 * _randn(shape, dtype, cuda) + 1.5
    x[..., 5] = 2.5  # a constant channel: variance 0
    w = _randn(shape[-1:], torch.float32, cuda, seed=1)
    b = _randn(shape[-1:], torch.float32, cuda, seed=2)
    kernels.reset_launch_counts()
    out = instance_norm_cl(x, w, b, nlat_phys)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["instance_norm"] == 1
    ref = instance_norm_cl_plain(x, w, b, nlat_phys)
    assert out.dtype == dtype and _agree(out, ref, dtype)
    assert torch.isfinite(out).all() and _agree(out[..., 5], ref[..., 5], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,nlat_phys", [((2, 45, 90, 384), 40), ((2, 37, 50, 70), 30)])
def test_instance_norm_kernel_groups(cuda, shape, nlat_phys, dtype):
    """Several channel groups (two grid barriers each, per sample) and one,
    on a full card's grid and on a grid of two blocks (long slices)."""
    x = 3.0 * _randn(shape, dtype, cuda) + 1.5
    w = _randn(shape[-1:], dtype, cuda, seed=1)
    b = _randn(shape[-1:], dtype, cuda, seed=2)
    B, H, W, C = shape
    ref = instance_norm_cl_plain(x, w, b, nlat_phys)
    ref_mean, ref_sd = layer_norm._norm_stats_plain(x, nlat_phys, 1e-6)
    sms = layer_norm._card(0)["sms"]
    for g in sorted({g for g in (8, 14, 16, 48, 192, C) if C % g == 0}):
        for n_sm in (sms, 1):
            try:
                p = layer_norm.plan_instance_norm(H * W, C, x.element_size(), sms=n_sm, group=g)
            except ValueError:
                continue
            out, mean, sd = layer_norm.launch_instance_norm(x, w, b, (nlat_phys or H) * W, 1e-6, p)
            torch.cuda.synchronize()
            assert _agree(out, ref, dtype), (g, n_sm)
            assert _agree(mean, ref_mean, torch.float32) and _agree(sd, ref_sd, torch.float32), (g, n_sm)


def test_small_sfno_kernel_path_matches_plain(cuda):
    model = SphericalFourierNeuralOperatorNet(
        inp_shape=(61, 120), out_shape=(61, 120), scale_factor=2, inp_chans=7, out_chans=6, embed_dim=48, num_layers=3, device=cuda
    )
    x = _randn((2, 7, 61, 120), torch.float32, cuda)
    kernels.reset_launch_counts()
    with torch.no_grad():
        y = model(x)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        kernels.set_use_kernels(model, False)
        ref = model(x)
    assert counts == dict(dict.fromkeys(kernels.LAUNCHES, 0), sht_analysis=3, sht_synthesis=5, dhconv=3, instance_norm=6)
    assert torch.isfinite(y).all()
    assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_wrappers_refuse_mixed_devices(cuda):
    x = _randn((1, 13, 9, 3, 2), torch.float32, cuda)
    sht = RealSHT(13, 24, lmax=10, mmax=9, grid="legendre-gauss")
    with pytest.raises(ValueError):
        analysis_contract_cl_s(x, sht.weights("cpu"))
    with pytest.raises(TypeError):
        analysis_contract_cl_s(x.to(torch.bfloat16), sht.weights(cuda))


DISCO_SHAPES = [((33, 64), (17, 32)), ((24, 48), (24, 48)), ((13, 32), (11, 24))]


@pytest.mark.parametrize("C", [37, 130])
@pytest.mark.parametrize("in_shape,out_shape", DISCO_SHAPES)
def test_disco_band_and_polar_kernels_match_plain(cuda, in_shape, out_shape, C):
    """K5 in responses mode on a channels-last and an NCHW input, and K6 in
    the responses order, through DiscoConvS2.responses_cl (stride 2 in the
    first shape, phases b > 1 in the last; C 130 takes K5's 32-channel
    tiles, C 37 its 8-channel ones). The latitudes with no live tap (the
    polar rows) hold +0 in t. The plain version sums in cuDNN's order, so
    bit equality is not asserted."""
    conv = DiscoConvS2(in_shape, out_shape, (3, 3), basis_type="morlet th", basis_norm_mode="mean")
    x = _randn((2, C, *in_shape), torch.float32, cuda)
    for view in (x.permute(0, 2, 3, 1), x.permute(0, 2, 3, 1).contiguous()):
        kernels.reset_launch_counts()
        t, tp = conv.responses_cl(view)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["disco_band"] == conv.phases and kernels.LAUNCHES["disco_polar"] == conv.phases
        rt, rtp = conv.responses_cl(view, use_kernels=False)
        assert _agree(t, rt, torch.float32) and _agree(tp, rtp, torch.float32)
        dead = t[:, conv.polar_rows]
        assert torch.equal(dead, torch.zeros_like(dead)) and bool((dead.view(torch.int32) == 0).all())


@pytest.mark.parametrize("in_shape,out_shape", DISCO_SHAPES)
@pytest.mark.parametrize("g,og,ig,R", [(3, 2, 4, 1), (2, 1, 8, 3), (5, 9, 1, 2), (8, 7, 1, 1)])
def test_disco_fused_kernels_match_plain(cuda, in_shape, out_shape, g, og, ig, R):
    """K5 in fused mode (F = w x psi, R stacked inputs sharing the filters)
    and K6 in both polar orders (og*BL <= ig mixes first)."""
    conv = DiscoConvS2(in_shape, out_shape, (3, 3), basis_type="morlet th", basis_norm_mode="mean")
    x = _randn((2, R * g * ig, *in_shape), torch.float32, cuda).permute(0, 2, 3, 1)
    w = 0.2 * _randn((g, og, ig, conv.K), torch.float32, cuda, seed=1)
    kernels.reset_launch_counts()
    y = conv.fused_cl(x, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["disco_band"] == conv.phases and kernels.LAUNCHES["disco_polar"] == conv.phases
    assert y.shape == (2, *out_shape, R * g * og)
    assert _agree(y, conv.fused_cl(x, w, use_kernels=False), torch.float32)


@pytest.mark.parametrize("K", [9, 7])
@pytest.mark.parametrize("order", ["psi_first", "mix_first"])
@pytest.mark.parametrize("in_shape,out_shape", [DISCO_SHAPES[0], DISCO_SHAPES[2]])
def test_disco_polar_kernel_matches_plain(cuda, in_shape, out_shape, order, K):
    """K6 on its own, in both orders, with K = 9 (the templated pass) and
    K = 7 (the chunked fallback), 77 channels (not a multiple of the 64 a
    block takes), on the psi tables of every phase (b = 3 in the last
    shape)."""
    conv = DiscoConvS2(in_shape, out_shape, (3, 3), basis_type="morlet th", basis_norm_mode="mean")
    P, BL, M, C = len(conv.polar_rows), conv.BL, in_shape[1] // 2 + 1, 77
    for p in range(conv.phases):
        Pt = conv.polar_table(p, cuda)
        if K != conv.K:
            Pt = _randn((P, BL, K, M, 2), torch.float32, cuda, seed=p + 3)
        kernels.reset_launch_counts()
        if order == "psi_first":
            src = _randn((2, P, BL, C, M, 2), torch.float32, cuda, seed=p)
            out, ref = disco_kernels.polar_psi_first(src, Pt), disco_kernels.polar_psi_first_plain(src, Pt)
        else:
            src = _randn((2, P, BL, C, K, M, 2), torch.float32, cuda, seed=p)
            out, ref = disco_kernels.polar_mix_first(src, Pt), disco_kernels.polar_mix_first_plain(src, Pt)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["disco_polar"] == 1
        assert out.shape == ref.shape and _agree(out, ref, torch.float32)


def test_disco_band_refuses_wrong_inputs(cuda):
    conv = DiscoConvS2((24, 48), (24, 48), (3, 3), basis_type="morlet th")
    x = _randn((1, 24, 48, 3), torch.bfloat16, cuda)
    out = torch.empty(1, 24, 48, 3 * conv.K, device=cuda)
    taps = conv.tap_table(0, cuda)
    kw = dict(a=1, off=0, n_out=48, phase=0, phases=1, Gf=1, IG=1, OG=conv.K)
    F_, bs = conv.band_filter(0, cuda), conv.band_start_table(cuda)
    with pytest.raises(TypeError):
        disco_kernels.band_contract(x, F_, bs, out, taps=taps, **kw)
    with pytest.raises(ValueError):
        disco_kernels.band_contract(x.float(), conv.band_filter(0, "cpu"), bs, out, taps=taps, **kw)
    # malformed tap tables: wrong dtype, wrong shape, not contiguous, on the CPU
    for bad in (taps.long(), taps[:, :-1].contiguous(), taps.transpose(0, 1).contiguous().transpose(0, 1), taps.cpu()):
        with pytest.raises(ValueError):
            disco_kernels.band_contract(x.float(), F_, bs, out, taps=bad, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes", [((18, 36, "legendre-gauss"), (37, 72, "equiangular")), ((37, 72, "equiangular"), (18, 36, "legendre-gauss"))])
def test_resample_kernel_matches_plain(cuda, shapes, dtype):
    (hi, wi, gi), (ho, wo, go) = shapes
    rs = ResampleS2(hi, wi, ho, wo, grid_in=gi, grid_out=go)
    x = _randn((2, hi, wi, 45), dtype, cuda)
    kernels.reset_launch_counts()
    y = rs.resample_cl(x[..., 3:40])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["resample"] == 1 and y.dtype == dtype
    assert _agree(y, rs.resample_cl(x[..., 3:40], use_kernels=False), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,C,used", [(((45, 90), (91, 180)), 677, 585), (((18, 36), (19, 37)), 7, 5)])
def test_resample_kernel_on_a_channel_slice(cuda, shapes, C, used, dtype):
    """K7 on the first channels of a wider tensor, as at the FCN3 atmo
    decoder (585 of 677: pixels 2708 bytes apart, 4-byte aligned), up from
    a Legendre-Gauss grid to an equiangular one with poles (lat_w clamped to
    0 and 1) and a wrap column (lon_idx1 = 0); the second shape has output
    rows that are not 16-byte aligned. The wrap column and the polar rows are
    held on their own; fp32 is equal to the plain version (the same three
    roundings in the same order)."""
    (hi, wi), (ho, wo) = shapes
    rs = ResampleS2(hi, wi, ho, wo, grid_in="legendre-gauss", grid_out="equiangular")
    assert rs.lon_idx1[-1] == 0 and rs.lat_w[0] == 0.0 and rs.lat_w[-1] == 1.0
    x = _randn((2, hi, wi, C), dtype, cuda)[..., :used]
    kernels.reset_launch_counts()
    y = rs.resample_cl(x)
    torch.cuda.synchronize()
    ref = rs.resample_cl(x, use_kernels=False)
    assert kernels.LAUNCHES["resample"] == 1 and y.dtype == dtype and y.shape == ref.shape == (2, ho, wo, used)
    for part in (slice(None), (slice(None), slice(None), -1), (slice(None), 0), (slice(None), -1)):
        assert _agree(y[part], ref[part], dtype), part
    if dtype == torch.float32:
        assert torch.equal(y, ref)
    # every tile width the wrapper could pick
    tabs = rs.tables(cuda)
    spans = resample._spans(tabs[2], tabs[3], wi)
    for tw in resample._TILE_WIDTHS:
        if kernels.library().mt_resample_smem_bytes(used, tw, spans[tw]) <= resample._SMEM_MAX:
            yt = k7_width(x, tabs, tw)
            assert torch.equal(yt, y) if dtype == torch.float32 else _agree(yt, ref, dtype), tw


def test_small_fcn3_kernel_path_matches_plain(cuda):
    names = ["u10m", "v10m", "t2m", "tcwv", "u500", "v500", "q500", "u850", "v850", "q850"]
    model = AtmoSphericNeuralOperatorNet(
        inp_shape=(33, 64), out_shape=(33, 64), scale_factor=2, channel_names=tuple(names), aux_channel_names=("xzen", "xnoise0", "xnoise1"),
        atmo_embed_dim=24, surf_embed_dim=16, aux_embed_dim=8, num_layers=4, sfno_block_frequency=2, kernel_shape=(3, 3),
        filter_basis_type="morlet th", clamp_water=True, device=cuda,
    )
    x = _randn((2, len(names) + 3, 33, 64), torch.float32, cuda)
    kernels.reset_launch_counts()
    with torch.no_grad():
        y = model(x)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        kernels.set_use_kernels(model, False)
        ref = model(x)
    # 3 encoders (fused), 2 local blocks (two-stage: 72 channels, one K8
    # mix each), 2 decoders (fused): one band and one polar launch each
    assert counts == dict(dict.fromkeys(kernels.LAUNCHES, 0), sht_analysis=2, sht_synthesis=2, dhconv=2, disco_band=7, disco_polar=7, disco_mix=2, resample=2)
    assert torch.isfinite(y).all()
    assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()


# (1000, 6093, 677): FCN3's processor depth (tail 6093 % 8 = 5, 13 past the
# last 32-deep stage) and width (five 136-column tiles); (777, 45, 13) and
# (130, 37, 5): a small odd width in one tile; no R is a multiple of 128
MIX_CASES = [(1000, 6093, 677), (777, 45, 13), (130, 37, 5)]


@pytest.mark.parametrize("R,D,N", MIX_CASES)
def test_disco_mix_kernel_matches_plain(cuda, R, D, N):
    """K8 on a responses-like view (rows a multiple of 4 floats apart; the
    pad holds NaN, which must never be read) against its plain version."""
    Dp = -(-D // 4) * 4
    buf = _randn((R, Dp), torch.float32, cuda)
    buf[:, D:] = float("nan")
    t2 = buf[:, :D]
    w = 0.05 * _randn((N, D), torch.float32, cuda, seed=1)
    kernels.reset_launch_counts()
    y = disco_kernels.channel_mix(t2, w, disco_kernels.MixPlanes())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["disco_mix"] == 1
    assert y.shape == (R, N) and torch.isfinite(y).all()
    assert _agree(y, disco_kernels.channel_mix_plain(t2, w), torch.float32)


def test_disco_mix_refuses_unaligned_rows(cuda):
    t = _randn((64, 45), torch.float32, cuda)
    w = _randn((13, 45), torch.float32, cuda, seed=1)
    with pytest.raises(ValueError):
        disco_kernels.channel_mix(t, w)  # rows 45 floats apart
    with pytest.raises(ValueError):
        disco_kernels.channel_mix(_randn((64, 48), torch.float32, cuda)[:, 1:46], w)  # not 16-byte aligned


def test_plain_paths_are_fp32_at_torch_defaults():
    """The plain K5 (cuDNN conv1d) and K8 (cuBLAS) on the card, with the
    global TF32 flags at torch's defaults (cuDNN's allow_tf32 is True), agree
    with a float64 reference within the fp32 gate: their local guard keeps
    TF32 out. Run in a fresh process, so that no flag set by another test
    is in force."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    code = textwrap.dedent(
        """
        import numpy as np, torch
        from makani_torch.ops import disco, disco_kernels
        assert torch.backends.cudnn.allow_tf32, "not at torch's defaults"
        def rel(a, ref):
            return ((a.double().cpu() - ref).abs().max() / ref.abs().max()).item()
        rng = np.random.default_rng(0)
        op = disco.DiscoConvS2((33, 64), (33, 64), (3, 3), basis_type="morlet th", basis_norm_mode="mean")
        x = torch.from_numpy(rng.standard_normal((2, 33, 64, 37)).astype(np.float32))
        kw = dict(a=op.stride, off=int(op.bases[0]) - op.halo, n_out=64, phase=0, phases=1, Gf=1, IG=1, OG=op.K)
        out = torch.empty(2, 33, 64, 37 * op.K, device="cuda")
        disco_kernels.band_contract_plain(x.cuda(), op.band_filter(0, "cuda"), op.band_start_table("cuda"), out, **kw)
        ref = torch.zeros(2, 33, 64, 37 * op.K, dtype=torch.float64)
        disco_kernels.band_contract_plain(x.double(), op.band_filter(0, "cpu").double(), op.band_start_table("cpu"), ref, **kw)
        t2 = torch.from_numpy(rng.standard_normal((3000, 6093)).astype(np.float32))
        w = torch.from_numpy(0.05 * rng.standard_normal((677, 6093)).astype(np.float32))
        y = disco_kernels.channel_mix_plain(t2.cuda(), w.cuda())
        print(rel(out, ref), rel(y, t2.double() @ w.double().t()))
        """
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert res.returncode == 0, res.stderr[-3000:]
    band, mix = map(float, res.stdout.split()[-2:])
    assert band <= 1e-5 and mix <= 1e-5, (band, mix)


# ---------------------------------------------------------------------------
# The training step's kernels: the backward of K1-K4 (K1 and K2 on each
# other's table, K3 on the conjugate-transposed weight, K9, K10) and K11.


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nlat,nlon,grid,lmax,mmax,C", SHT_CASES[:4] + [(361, 720, "equiangular", 120, 121, 8), (120, 240, "legendre-gauss", 120, 121, 20)])
def test_legendre_grads_match_plain(cuda, nlat, nlon, grid, lmax, mmax, C, dtype):
    fwd = RealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
    inv = InverseRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
    w, p = fwd.weights(cuda, dtype), inv.pct(cuda, dtype)
    x = _randn((2, nlat, fwd.mmax, C, 2), dtype, cuda).requires_grad_()
    c = _randn((2, inv.lmax, inv.mmax, C, 2), dtype, cuda, seed=1).requires_grad_()
    ga = _randn((2, fwd.lmax, fwd.mmax, C, 2), dtype, cuda, seed=2)
    gs = _randn((2, nlat, inv.mmax, C, 2), dtype, cuda, seed=3)
    kernels.reset_launch_counts()
    analysis_contract_cl_s(x, w).backward(ga)
    synthesis_contract_cl_s(c, p).backward(gs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sht_analysis_grad"] == 1 and kernels.LAUNCHES["sht_synthesis_grad"] == 1
    assert x.grad.dtype == dtype and _agree(x.grad, synthesis_contract_cl_s_plain(ga, w), dtype)
    assert c.grad.dtype == dtype and _agree(c.grad, analysis_contract_cl_s_plain(gs, p), dtype)


# K9's edges: depth B*M not a multiple of its 16-row stage (21, 35, 42), one
# stage exactly (16), channels not multiples of its 128 x 64 tile or of 4
# (77 x 69: pair copies of x), two groups, several row and column tiles
# (130 x 200), M below the stage (6, 7: a stage spans several b), odd L (a
# block of one degree at the end), a deep depth (B*M 6050)
DHCONV_GRAD_CASES = [
    (2, 7, 6, 1, 5, 3),
    (1, 9, 10, 1, 37, 45),
    (3, 12, 13, 2, 48, 70),
    (3, 20, 21, 1, 130, 64),
    (3, 5, 7, 2, 77, 69),
    (1, 4, 16, 1, 64, 64),
    (5, 3, 7, 1, 130, 200),
    (2, 6, 21, 2, 256, 131),
    (50, 3, 121, 1, 20, 12),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,M,G,Ci,Co", DHCONV_GRAD_CASES)
def test_dhconv_grads_match_plain(cuda, B, L, M, G, Ci, Co, dtype):
    from makani_torch.models.common.contractions import dhconv_grad_input, dhconv_grad_input_plain, dhconv_grad_weight, dhconv_grad_weight_plain

    x = _randn((B, L, M, G, Ci, 2), dtype, cuda)
    g = _randn((B, L, M, G, Co, 2), dtype, cuda, seed=1)
    w = _randn((G, Ci, Co, L, 2), torch.float32, cuda, seed=2)
    w_perm = _PermutedWeight().get(w, dtype)
    kernels.reset_launch_counts()
    dx = dhconv_grad_input(g, w_perm)
    dw = dhconv_grad_weight(x, g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dhconv_grad_input"] == 1 and kernels.LAUNCHES["dhconv_grad_weight"] == 1
    assert dx.dtype == dtype and _agree(dx, dhconv_grad_input_plain(g, w), dtype)
    assert dw.dtype == torch.float32 and _agree(dw, dhconv_grad_weight_plain(x, g), dtype)
    # through autograd: the weight's gradient reaches the parameter
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    contract_dense_s(xr, wr, False, "dhconv", True, weight_cache=_PermutedWeight()).backward(g)
    assert torch.equal(xr.grad, dx) and wr.grad.shape == w.shape
    assert torch.equal(wr.grad, dw if dtype == torch.float32 else dw.to(dtype).float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dhconv_grad_input_reads_the_forward_cache(cuda, dtype):
    """K3's dx reads the forward's cached weight: Ci 37 and Co 45 (a slip
    between the two axes shows), 300 orders (three 128-row tiles), against
    the plain version; the backward builds no weight (the cache's tensor is
    the forward's); after an in-place update of the weight (a new version)
    the next forward refreshes the cache and dx follows the new weight."""
    from makani_torch.models.common.contractions import dhconv_grad_input, dhconv_grad_input_plain

    B, L, M, G, Ci, Co = 2, 3, 300, 1, 37, 45
    x = _randn((B, L, M, G, Ci, 2), dtype, cuda).requires_grad_()
    g = _randn((B, L, M, G, Co, 2), dtype, cuda, seed=1)
    w = _randn((G, Ci, Co, L, 2), torch.float32, cuda, seed=2).requires_grad_()
    cache = _PermutedWeight()
    for update in range(2):
        y = contract_dense_s(x, w, False, "dhconv", True, weight_cache=cache)
        w_perm = cache._value
        kernels.reset_launch_counts()
        dx, = torch.autograd.grad(y, x, g)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["dhconv_grad_input"] == 1 and cache._value is w_perm
        ref = dhconv_grad_input_plain(g, w.detach())
        assert dx.dtype == dtype and _agree(dx, ref, dtype)
        assert torch.equal(dhconv_grad_input(g, w_perm), dx)
        with torch.no_grad():
            w.mul_(-0.5).add_(0.25)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dhconv_grad_weight_takes_unaligned_views(cuda, dtype):
    """K9 copies each row from its 16-byte aligned start: contiguous views
    one element past an aligned start give the aligned inputs' result."""
    from makani_torch.models.common.contractions import dhconv_grad_weight

    shape_x, shape_g = (2, 5, 7, 1, 77, 2), (2, 5, 7, 1, 69, 2)
    x = _randn(shape_x, dtype, cuda)
    g = _randn(shape_g, dtype, cuda, seed=1)
    xv = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:].view(shape_x)
    gv = torch.empty(g.numel() + 1, dtype=dtype, device=cuda)[1:].view(shape_g)
    xv.copy_(x)
    gv.copy_(g)
    assert xv.data_ptr() % 16 and gv.data_ptr() % 16
    assert torch.equal(dhconv_grad_weight(xv, gv), dhconv_grad_weight(x, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,nlat_phys", NORM_CASES)
def test_instance_norm_grad_matches_plain(cuda, shape, nlat_phys, dtype):
    x = (3.0 * _randn(shape, dtype, cuda) + 1.5).requires_grad_()
    w = (1.0 + 0.1 * _randn(shape[-1:], torch.float32, cuda, seed=1)).requires_grad_()
    b = _randn(shape[-1:], torch.float32, cuda, seed=2).requires_grad_()
    g = _randn(shape, dtype, cuda, seed=3)
    kernels.reset_launch_counts()
    instance_norm_cl(x, w, b, nlat_phys).backward(g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["instance_norm"] == 1 and kernels.LAUNCHES["instance_norm_grad"] == 1
    H, W = shape[1], shape[2]
    mean, sd = layer_norm._norm_stats_plain(x.detach(), nlat_phys, 1e-6)
    dx, dw, db = layer_norm.instance_norm_grad_plain(g, x.detach(), w.detach(), mean, sd, (nlat_phys or H) * W)
    assert x.grad.dtype == dtype and _agree(x.grad, dx, dtype)
    assert _agree(w.grad, dw, dtype) and _agree(b.grad, db, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("H,W,C,nlat_phys", [(45, 90, 384, 40), (20, 30, 37, 17)])
def test_instance_norm_grad_designs_match_plain(cuda, B, H, W, C, nlat_phys, dtype):
    """K10 with every sample in one round (the plan) and walking the samples
    one a round (a plan for one sample: the rounds a batch of more samples
    than SMs takes): dx, dw and db against the plain version, with masked
    rows and an odd C (one channel a load), and two launches bit-equal."""
    x = 3.0 * _randn((B, H, W, C), dtype, cuda) + 1.5
    g = _randn((B, H, W, C), dtype, cuda, seed=3)
    w = (1.0 + 0.1 * _randn((C,), torch.float32, cuda, seed=1)).to(dtype)
    mean, sd = layer_norm._norm_stats_plain(x, nlat_phys, 1e-6)
    n = nlat_phys * W
    ref = layer_norm.instance_norm_grad_plain(g, x, w, mean, sd, n)
    default = layer_norm._grad_plan(x, g)
    assert default.samples == B and (default.vec == 1) == (C == 37)
    sms = layer_norm._card(0)["sms"]
    for samples in (B, 1):
        plan = layer_norm.plan_instance_norm_grad(samples, H * W, C, x.element_size(), sms=sms)
        runs = [layer_norm.launch_instance_norm_grad(g, x, w, mean, sd, n, plan) for _ in range(2)]
        torch.cuda.synchronize()
        for out, again, r in zip(runs[0], runs[1], ref):
            assert torch.equal(out, again), samples
            assert _agree(out, r, dtype), samples


# K11's factored leaves: d0 < d1 (a dhconv-shaped 5-D weight with R 130 and
# S 140 not multiples of the 32 of a reduce tile and Q 80 not a multiple of
# 32 lanes, 2-D weights with Q 1) and d0 > d1, P 2 and Mi 3 with Q 5, Q 9
# (FCN3's (677, 677, 9)); Q 1 and a run S*Q of 129 floats take the apply's
# 4-byte path; and unfactored leaves
ADAM_SHAPES = [(1, 130, 140, 40, 2), (1, 200, 300), (1, 300, 200), (130, 129), (2, 150, 3, 140, 5), (1, 141, 137, 9), (1, 74, 96), (96,), (7, 3)]


def _adam_steps(cuda, shapes, mu_dtype, steps):
    """``steps`` steps of the plain update (CPU) and of K11 (card) from the
    same parameters and gradients; returns both parameter lists, optimizers
    and the kernel launches of each step."""
    from makani_torch.utils.training.optimizer import AdamFactored

    ref = [torch.nn.Parameter(_randn(s, torch.float32, "cpu", seed=k)) for k, s in enumerate(shapes)]
    dev = [torch.nn.Parameter(p.detach().to(cuda)) for p in ref]
    opt_ref, opt_dev = AdamFactored(ref, lr=1e-2, mu_dtype=mu_dtype), AdamFactored(dev, lr=1e-2, mu_dtype=mu_dtype)
    launches = []
    for step in range(steps):
        for k, (a, b) in enumerate(zip(ref, dev)):
            grad = _randn(a.shape, torch.float32, "cpu", seed=100 * step + k) * (1.0 + k % 7)
            a.grad, b.grad = grad, grad.to(cuda)
        opt_ref.step()
        kernels.reset_launch_counts()
        opt_dev.step()
        torch.cuda.synchronize()
        launches.append(kernels.LAUNCHES["adam_factored"])
    return ref, dev, opt_ref, opt_dev, launches


def _adam_agree(ref, dev, opt_ref, opt_dev, mu_dtype, steps):
    for a, b in zip(ref, dev):
        assert _agree(b.detach(), a.detach().to(b.device), torch.float32)
        sa, sb = opt_ref.state[a], opt_dev.state[b]
        assert int(sa["count"]) == int(sb["count"]) == steps
        for key in ("v_row", "v_col", "v"):
            if sa[key].numel():
                assert _agree(sb[key], sa[key].to(b.device), torch.float32), key
        assert sb["mu"].dtype == mu_dtype and _agree(sb["mu"], sa["mu"].to(b.device), mu_dtype)


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_adam_factored_kernel_matches_plain(cuda, mu_dtype):
    """Three steps of K11 against the plain update on the same gradients, on
    ADAM_SHAPES: three launches for the factored leaves and one for the
    unfactored ones a step."""
    ref, dev, opt_ref, opt_dev, launches = _adam_steps(cuda, ADAM_SHAPES, mu_dtype, 3)
    assert launches == [3 + 1] * 3
    _adam_agree(ref, dev, opt_ref, opt_dev, mu_dtype, 3)


def test_adam_factored_kernel_takes_more_leaves_than_a_table(cuda):
    """45 factored leaves (a launch's table holds 40) and 2 unfactored ones:
    two rounds of three launches and one."""
    shapes = [(130 + k % 5, 129 + k % 3) for k in range(45)] + [(96,), (7, 3)]
    ref, dev, opt_ref, opt_dev, launches = _adam_steps(cuda, shapes, torch.bfloat16, 2)
    assert launches == [2 * 3 + 1] * 2
    _adam_agree(ref, dev, opt_ref, opt_dev, torch.bfloat16, 2)


def test_adam_factored_kernel_is_deterministic(cuda):
    """Two runs of K11 from the same state and gradients give bit-equal
    parameters and state: the partial sums are added in a fixed order."""
    runs = []
    for _ in range(2):
        _, dev, _, opt_dev, _ = _adam_steps(cuda, ADAM_SHAPES, torch.bfloat16, 2)
        runs.append([t.detach().clone() for b in dev for t in (b, *[opt_dev.state[b][k] for k in ("mu", "v_row", "v_col", "v")])])
    for x, y in zip(*runs):
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x.view(torch.int32), y.view(torch.int16) if y.dtype == torch.bfloat16 else y.view(torch.int32))


def test_adam_factored_kernel_counts_a_group(cuda):
    """One count for the group on the card: a parameter without a gradient
    in the first step is updated as with a zero gradient (K11's tables take
    a zero tensor), and two steps agree with the plain update on the CPU,
    every parameter's count 2."""
    from makani_torch.utils.training.optimizer import AdamFactored

    shapes = [(1, 130, 140, 4, 2), (96,), (7, 3), (130, 129)]
    ref = [torch.nn.Parameter(_randn(s, torch.float32, "cpu", seed=k)) for k, s in enumerate(shapes)]
    dev = [torch.nn.Parameter(p.detach().to(cuda)) for p in ref]
    opt_ref, opt_dev = AdamFactored(ref, lr=1e-2, mu_dtype=torch.bfloat16), AdamFactored(dev, lr=1e-2, mu_dtype=torch.bfloat16)
    for step in range(2):
        for k, (a, b) in enumerate(zip(ref, dev)):
            grad = None if step == 0 and k in (0, 1) else _randn(a.shape, torch.float32, "cpu", seed=10 * step + k)
            a.grad, b.grad = grad, None if grad is None else grad.to(cuda)
        opt_ref.step()
        kernels.reset_launch_counts()
        opt_dev.step()
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["adam_factored"] == 3 + 1
    _adam_agree(ref, dev, opt_ref, opt_dev, torch.bfloat16, 2)


# K16 and K17's leaves: ragged sizes (not multiples of a block's chunk or of
# 4), a leaf not 16-byte aligned (a view one float in), and 1-element leaves
GRAD_NORM_SIZES = [1, 3, 4097, 16384, 16385, 70001, 5, 130 * 129]


def _leaves(cuda, sizes, seed=0, scale=1.0):
    """fp32 leaves of the given sizes on the card, the second a view one
    float into a larger buffer (4-byte aligned only)."""
    out = []
    for k, n in enumerate(sizes):
        t = _randn((n + (k == 1),), torch.float32, cuda, seed=seed + k) * scale * (1 + k % 5)
        out.append(t[1:] if k == 1 else t)
    return out


@pytest.mark.parametrize("max_norm", [1.0, 1e6])
def test_grad_norm_kernel_matches_plain(cuda, max_norm):
    """K16 against the plain norm and clip on ragged leaves, clipping (norm
    above max_norm) and keeping: the norm within 1e-6, the clipped leaves
    within the fp32 tolerance, kept leaves bit-equal; two launches."""
    from makani_torch.utils.training.optimizer import clip_by_global_norm

    src = _leaves(cuda, GRAD_NORM_SIZES)
    gk, gp = [g.clone() for g in src], [g.clone() for g in src]
    kernels.reset_launch_counts()
    nk = clip_by_global_norm(gk, max_norm)
    assert kernels.LAUNCHES["grad_norm"] == 2
    npl = clip_by_global_norm(gp, max_norm, use_kernels=False)
    assert nk.device == src[0].device and abs(nk.item() - npl.item()) <= 1e-6 * npl.item()
    for a, b, g in zip(gk, gp, src):
        if max_norm < npl.item():
            assert _agree(a, b, torch.float32)
        else:
            assert torch.equal(a, g)


def test_grad_norm_kernel_takes_more_leaves_than_a_table(cuda):
    """300 leaves (a launch's table holds 128): three launches of each kind,
    the norm summed over all of them, deterministic from run to run."""
    from makani_torch.utils.training.optimizer import clip_by_global_norm, global_norm_plain

    src = _leaves(cuda, [100 + 37 * k for k in range(300)], seed=5)
    norms = []
    for _ in range(2):
        g = [t.clone() for t in src]
        kernels.reset_launch_counts()
        norms.append(clip_by_global_norm(g, 1.0).item())
        assert kernels.LAUNCHES["grad_norm"] == 6
    ref = global_norm_plain(src).item()
    assert norms[0] == norms[1] and abs(norms[0] - ref) <= 1e-6 * ref
    assert _agree(g[-1], src[-1] / ref, torch.float32)


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_adam_kernel_matches_plain(cuda, mu_dtype):
    """Three steps of K17 against the plain update on the same gradients,
    70 leaves (a launch's table holds 64: two launches a step), ragged and
    4-byte aligned, half of them decayed: parameters, mu and v within the
    fp32 tolerance (mu within one bf16 ulp for a bf16 mu)."""
    from makani_torch.utils.training.optimizer import _bias_corrections, adam_update, adam_update_plain

    sizes = [GRAD_NORM_SIZES[k % len(GRAD_NORM_SIZES)] + k for k in range(70)]
    ps = _leaves(cuda, sizes, seed=1)
    ref = [(p.clone(), torch.zeros_like(p, dtype=mu_dtype), torch.zeros_like(p)) for p in ps]
    dev = [(p, torch.zeros_like(p, dtype=mu_dtype), torch.zeros_like(p)) for p in ps]
    wds = [0.1 * (k % 2) for k in range(len(ps))]
    b1, b2, eps, lr = 0.9, 0.95, 1e-8, 1e-2
    for step in range(1, 4):
        grads = _leaves(cuda, sizes, seed=100 * step)
        c1, c2 = _bias_corrections(step, b1, b2)
        for (p, mu, v), g, wd in zip(ref, grads, wds):
            adam_update_plain(p, g, mu, v, c1, c2, b1, b2, eps, lr, wd)
        kernels.reset_launch_counts()
        adam_update([(p, g.contiguous(), mu, v, wd) for (p, mu, v), g, wd in zip(dev, grads, wds)], mu_dtype, c1, c2, b1, b2, eps, lr)
        assert kernels.LAUNCHES["adam"] == 2
    torch.cuda.synchronize()
    for (p, mu, v), (rp, rmu, rv) in zip(dev, ref):
        assert _agree(p, rp, torch.float32) and _agree(v, rv, torch.float32) and _agree(mu, rmu, mu_dtype)


def test_recipe_optimizer_step_does_not_wait_for_the_card(cuda):
    """``get_optimizer``'s recipe chain (K16 clipping, K17 with decay, the
    cosine schedule) steps under ``set_sync_debug_mode("error")``: nothing
    of the step is read back; and it agrees with the plain path."""
    from makani_torch.utils.training.optimizer import get_optimizer

    cfg = dict(optimizer_type="AdamW", weight_decay=0.1, optimizer_max_grad_norm=1.0, scheduler="CosineAnnealingLR", scheduler_T_max=3, lr=1e-2)
    mods = [torch.nn.Sequential(torch.nn.Linear(33, 70), torch.nn.LayerNorm(70), torch.nn.Linear(70, 5)).to(cuda) for _ in range(2)]
    mods[1].load_state_dict(mods[0].state_dict())
    opts = [get_optimizer(cfg, m) for m in mods]
    opts[1].use_kernels = False
    x = _randn((8, 33), torch.float32, cuda)
    for _ in range(2):
        for m, opt in zip(mods, opts):
            m(x).square().sum().backward()
        kernels.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opts[0].step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert kernels.LAUNCHES["grad_norm"] == 2 and kernels.LAUNCHES["adam"] == 1
        opts[1].step()
        for opt in opts:
            opt.zero_grad(set_to_none=True)
    assert opts[0].last_grad_norm.item() > 1.0 and opts[0].last_lr == opts[1].last_lr
    for a, b in zip(mods[0].parameters(), mods[1].parameters()):
        assert _agree(a.detach(), b.detach(), torch.float32)


def test_adam_factored_kernel_takes_the_decay(cuda):
    """K11 with a weight decay on some leaves (the factored path of AdamW):
    two steps against the plain update on the CPU."""
    from makani_torch.utils.training.optimizer import AdamFactored

    shapes = [(1, 130, 140, 4, 2), (96,), (7, 3), (130, 129)]
    ref = [torch.nn.Parameter(_randn(s, torch.float32, "cpu", seed=k)) for k, s in enumerate(shapes)]
    dev = [torch.nn.Parameter(p.detach().to(cuda)) for p in ref]
    groups = lambda ps: [{"params": [ps[0], ps[3]], "weight_decay": 0.1}, {"params": [ps[1], ps[2]]}]
    opt_ref, opt_dev = AdamFactored(groups(ref), lr=1e-2, mu_dtype=torch.bfloat16), AdamFactored(groups(dev), lr=1e-2, mu_dtype=torch.bfloat16)
    for step in range(2):
        for k, (a, b) in enumerate(zip(ref, dev)):
            grad = _randn(a.shape, torch.float32, "cpu", seed=10 * step + k)
            a.grad, b.grad = grad, grad.to(cuda)
        opt_ref.step()
        opt_dev.step()
    _adam_agree(ref, dev, opt_ref, opt_dev, torch.bfloat16, 2)


def test_small_sfno_train_step_kernel_path_matches_plain(cuda):
    """One fp32 training step of a small SFNO, kernels against the plain
    path (PyTorch autograd through the plain forward, the plain optimizer),
    from the same weights and optimizer state: the gradients within 1e-4 of
    each leaf's max|ref| (the MLP's second bias, zero but for rounding, at
    rounding level), the loss of three steps within 1e-5."""
    import copy

    from makani_torch.models.model_registry import get_model
    from makani_torch.utils.loss import LossHandler
    from makani_torch.utils.training.deterministic_trainer import train_step
    from makani_torch.utils.training.optimizer import AdamFactored
    from makani_torch.utils.yparams import ParamsBase

    params = ParamsBase(dict(nettype="SFNO", img_shape_x=61, img_shape_y=120, scale_factor=2, embed_dim=48, num_layers=3, operator_type="dhconv",
                             normalization_layer="instance_norm", channel_names=[f"ch{i}" for i in range(6)], in_channels=list(range(6)),
                             out_channels=list(range(6)), n_history=0, n_future=0, add_zenith=True,
                             losses=[{"type": "l2", "channel_weights": "constant", "parameters": {"squared": True}}]))
    model, _ = get_model(copy.deepcopy(params), multistep=True, device=cuda, seed=1)
    plain = copy.deepcopy(model)
    kernels.set_use_kernels(plain, False)
    loss_obj = LossHandler(params)
    inp, tar = _randn((2, 6, 61, 120), torch.float32, cuda), _randn((2, 6, 61, 120), torch.float32, cuda, seed=1)
    zen = _randn((2, 1, 1, 61, 120), torch.float32, cuda, seed=2)
    grads = []
    for m in (model, plain):
        m(inp, zen, train=True).sub(tar).square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in m.named_parameters()})
        m.zero_grad(set_to_none=True)
    largest = max(g.abs().max() for g in grads[1].values())
    for n in grads[1]:
        if n.endswith("mlp.fc2.bias"):
            # the instance norm after it removes any per-channel constant:
            # zero in exact arithmetic, rounding level in both paths
            assert max(grads[0][n].abs().max(), grads[1][n].abs().max()) <= 1e-5 * largest, n
        else:
            assert (grads[0][n] - grads[1][n]).abs().max() <= 1e-4 * grads[1][n].abs().max(), n
    kernels.reset_launch_counts()
    opt_k, opt_p = AdamFactored(model.parameters(), min_dim_size_to_factor=32), AdamFactored(plain.parameters(), min_dim_size_to_factor=32)
    opt_p.use_kernels = False
    # three steps: each step's forward must see the weights K11 wrote (K3's
    # permuted weight is cached per weight version)
    for step in range(3):
        lk = train_step(model, loss_obj, opt_k, inp, tar, zen).item()
        lp = train_step(plain, loss_obj, opt_p, inp, tar, zen).item()
        assert abs(lk - lp) <= 1e-5 * abs(lp), (step, lk, lp)
    torch.cuda.synchronize()
    for name in ("sht_analysis_grad", "dhconv_grad_input", "dhconv_grad_weight", "instance_norm_grad", "adam_factored"):
        assert kernels.LAUNCHES[name] > 0, name


# ---------------------------------------------------------------------------
# The FCN3 training step's kernels: K12 (K5's transpose), K13 (K6's
# transposes), K14 (K7's transpose), K15 (the CRPS)


def _band_grad_both(conv, dout, F_, C, Gf, IG, OG, dev):
    """K12 and its plain version over every phase (the first written, the
    rest added), from the same dout."""
    Wout = conv.out_shape[1]
    outs = []
    for route in (disco_kernels.band_contract_grad, disco_kernels.band_contract_grad_plain):
        dx = torch.full((dout.shape[0], *conv.in_shape, C), float("nan"), device=dev)
        for p in range(conv.phases):
            kw = dict(a=conv.stride, off=int(conv.bases[p]) - conv.halo, n_out=Wout // conv.phases, phase=p, phases=conv.phases, Gf=Gf, IG=IG, OG=OG,
                      accumulate=p > 0)
            if route is disco_kernels.band_contract_grad:
                kw.update(taps=conv.tap_table(p, dev), rows=conv.grad_rows(p, dev))
            route(dout, F_(p), conv.band_start_table(dev), dx, **kw)
        outs.append(dx)
    return outs


# K12's cases: DISCO_SHAPES (stride 2; stride 4 in three phases, the later
# ones added), and stride 1 in one phase (the staged kernel) at its tiles'
# edges: Win 40 and 100, not multiples of the 48 or 64 columns of a block,
# live runs of up to 23 taps (a thread's window holds 6 or 8 columns); the
# cutoff tripled (runs of 17 in a band of 13 rows, so a block stages more
# columns than Win: they wrap); each has input rows that no output row
# reaches with a live tap; and a cutoff at which no tap is live (dx is 0)
BAND_GRAD_SHAPES = [(i, o, 1) for i, o in DISCO_SHAPES] + [((20, 40), (20, 40), 1), ((30, 100), (30, 100), 1), ((24, 48), (24, 48), 3), ((16, 30), (16, 30), 4)]


def _band_grad_conv(in_shape, out_shape, cutoff_scale):
    return DiscoConvS2(in_shape, out_shape, (3, 3), basis_type="morlet th", basis_norm_mode="mean",
                       theta_cutoff=cutoff_scale * compute_cutoff_radius(in_shape[0], (3, 3), "morlet th"))


def _padded_responses(conv, C, dev, seed=0):
    """dout in the processor's padded responses layout, NaN in the pad."""
    CK = C * conv.K
    buf = _randn((2, *conv.out_shape, -(-CK // 4) * 4), torch.float32, dev, seed)
    buf[..., CK:] = float("nan")
    return buf[..., :CK]


@pytest.mark.parametrize("C", [37, 101, 130])
@pytest.mark.parametrize("in_shape,out_shape,cutoff_scale", BAND_GRAD_SHAPES)
def test_disco_band_grad_kernel_matches_plain(cuda, in_shape, out_shape, cutoff_scale, C):
    """K12 in responses mode, reading the padded responses layout in place
    (the pad holds NaN, which must never be read), on BAND_GRAD_SHAPES; C
    37, 101 and 130 are not multiples of the 32 channels of a block."""
    conv = _band_grad_conv(in_shape, out_shape, cutoff_scale)
    kernels.reset_launch_counts()
    dx, ref = _band_grad_both(conv, _padded_responses(conv, C, cuda), lambda p: conv.band_filter(p, cuda), C, 1, 1, conv.K, cuda)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["disco_band_grad"] == conv.phases
    assert torch.isfinite(dx).all() and _agree(dx, ref, torch.float32)


@pytest.mark.parametrize("in_shape,out_shape,cutoff_scale", BAND_GRAD_SHAPES)
@pytest.mark.parametrize("g,og,ig,R", [(3, 2, 4, 1), (5, 1, 9, 3), (5, 9, 1, 2), (8, 7, 1, 1), (9, 4, 1, 1)])
def test_disco_band_grad_fused_kernel_matches_plain(cuda, in_shape, out_shape, cutoff_scale, g, og, ig, R):
    """K12 in fused mode (the decoders' og 1 and ig 9 over R stacked inputs,
    the encoders' og 9, 7 and 4) against its plain version."""
    conv = _band_grad_conv(in_shape, out_shape, cutoff_scale)
    w = 0.2 * _randn((g, og, ig, conv.K), torch.float32, cuda, seed=1)
    cache = FusedFilterCache()
    dout = _randn((2, *out_shape, R * g * og), torch.float32, cuda)
    dx, ref = _band_grad_both(conv, dout, lambda p: cache.get(conv, w, p), R * g * ig, g, ig, og, cuda)
    torch.cuda.synchronize()
    assert torch.isfinite(dx).all() and _agree(dx, ref, torch.float32)


@pytest.mark.parametrize("mode", ["responses", "fused"])
def test_disco_band_grad_kernel_is_deterministic(cuda, mode):
    """The same K12 call twice gives bit-equal results: a gather in a fixed
    order, no atomics."""
    conv = _band_grad_conv((30, 100), (30, 100), 1)
    if mode == "responses":
        C, Gf, IG, OG = 101, 1, 1, conv.K
        dout, F_ = _padded_responses(conv, C, cuda), lambda p: conv.band_filter(p, cuda)
    else:
        g, og, ig, R = 5, 1, 9, 3
        C, Gf, IG, OG = R * g * ig, g, ig, og
        cache, w = FusedFilterCache(), 0.2 * _randn((g, og, ig, conv.K), torch.float32, cuda, seed=1)
        dout, F_ = _randn((2, *conv.out_shape, R * g * og), torch.float32, cuda), lambda p: cache.get(conv, w, p)
    first, _ = _band_grad_both(conv, dout, F_, C, Gf, IG, OG, cuda)
    second, _ = _band_grad_both(conv, dout, F_, C, Gf, IG, OG, cuda)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.parametrize("K", [9, 7])
@pytest.mark.parametrize("order,C,BL,M", [("psi_first", 37, 7, 25), ("mix_first", 70, 7, 25), ("mix_first", 65, 5, 361), ("mix_first", 3, 1, 1)])
def test_disco_polar_grad_kernels_match_plain(cuda, order, C, BL, M, K):
    """K13 against its plain version at odd widths (C 37, 70 and 65, M 25
    and 361: the FCN3 training step's atmo decoder, odd rows of dU that
    start at either 16-byte parity; M 1), K 9 and 7; psi first the one-pass
    and the generic loop."""
    Pt = _randn((5, BL, K, M, 2), torch.float32, cuda, seed=1)
    if order == "psi_first":
        dY = _randn((2, 5, C, K, M, 2), torch.float32, cuda)
        kern, plain = disco_kernels.polar_psi_first_grad, disco_kernels.polar_psi_first_grad_plain
    else:
        dY = _randn((2, 5, C, M, 2), torch.float32, cuda)
        kern, plain = disco_kernels.polar_mix_first_grad, disco_kernels.polar_mix_first_grad_plain
    kernels.reset_launch_counts()
    out = kern(dY, Pt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["disco_polar_grad"] == 1
    assert _agree(out, plain(dY, Pt), torch.float32)


@pytest.mark.parametrize("in_shape,out_shape", DISCO_SHAPES)
def test_disco_autograd_kernel_path_matches_plain(cuda, in_shape, out_shape):
    """The gradients of responses_cl (x) and fused_cl (x and the weight, in
    both polar orders) through K5, K6, K12, K13 against autograd through the
    plain forward."""
    conv = DiscoConvS2(in_shape, out_shape, (3, 3), basis_type="morlet th", basis_norm_mode="mean")
    x0 = _randn((2, *in_shape, 37), torch.float32, cuda)
    grads = []
    for use in (True, False):
        x = x0.clone().requires_grad_()
        t, tp = conv.responses_cl(x, use)
        ((t * t.detach().sin()).sum() + (tp * tp.detach().cos()).sum()).backward()
        grads.append(x.grad)
    assert _agree(*grads, torch.float32)
    for g, og, ig in ((3, 2, 4), (2, 1, 8)):
        x0 = _randn((2, *in_shape, 2 * g * ig), torch.float32, cuda, seed=2)
        w0 = 0.2 * _randn((g, og, ig, conv.K), torch.float32, cuda, seed=3)
        out = []
        for use in (True, False):
            x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
            y = conv.fused_cl(x, w, use)
            (y * y.detach().sin()).sum().backward()
            out.append((x.grad, w.grad))
        assert _agree(out[0][0], out[1][0], torch.float32) and _agree(out[0][1], out[1][1], torch.float32)


@pytest.mark.parametrize("C", [37, 56, 585])
@pytest.mark.parametrize("shapes", [((18, 36, "legendre-gauss"), (37, 72, "equiangular")), ((37, 72, "equiangular"), (18, 36, "legendre-gauss"))])
def test_resample_grad_kernel_matches_plain(cuda, shapes, C):
    """K14 up onto a grid with pole rows (lat_w clamped) and a wrap column,
    and down (output rows that clamp at the poles), against the plain
    scatter-adds on its default plan; two launches bit-equal; plans with
    other tiles (a ragged last one), strips, rings and channel chunks, and
    a dy that is not 16-byte aligned, bit-equal to it (the same sums in the
    same order); a plan whose shared memory is not the kernel's layout is
    refused; and through autograd of ResampleS2.resample_cl."""
    (hi, wi, gi), (ho, wo, go) = shapes
    rs = ResampleS2(hi, wi, ho, wo, grid_in=gi, grid_out=go)
    dy = _randn((2, ho, wo, C), torch.float32, cuda)
    kernels.reset_launch_counts()
    dx = resample.resample_cl_grad(dy, rs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["resample_grad"] == 1
    li, lw, k0, k1, v = rs.tables(cuda)
    assert _agree(dx, resample.resample_cl_grad_plain(dy, rs.in_shape, li.long(), lw, k0.long(), k1.long(), v), torch.float32)
    assert torch.equal(resample.resample_cl_grad(dy, rs), dx)
    tables = (rs.lat_idx, rs.lat_w, rs.lon_idx0, rs.lon_idx1, rs.lon_w)
    choices = (dict(tile_width=8, strip_rows=3, ring=2), dict(tile_width=8, channel_chunk=32, strip_rows=5, ring=4), dict(channel_chunk=64, strip_rows=1, ring=6))
    for plan in [rs.grad_plan(cuda, C, 2)] + [resample.plan_resample_grad(*tables, rs.in_shape, C, 2, **c) for c in choices]:
        assert torch.equal(resample._resample_grad_launch(dy, rs, plan), dx), plan.describe()
    with pytest.raises(RuntimeError, match="resample_grad"):
        resample._resample_grad_launch(dy, rs, dataclasses.replace(plan, smem_bytes=plan.smem_bytes + 16))
    shifted = torch.empty(dy.numel() + 1, device=cuda)[1:].view(dy.shape).copy_(dy)
    assert shifted.data_ptr() % 16 != 0 and torch.equal(resample.resample_cl_grad(shifted, rs), dx)
    x = _randn((2, hi, wi, C + 4), torch.float32, cuda, seed=1)[..., 2 : C + 2].requires_grad_()
    (rs.resample_cl(x) * dy).sum().backward()
    ref = x.detach().clone().requires_grad_()
    (rs.resample_cl(ref, use_kernels=False) * dy).sum().backward()
    assert _agree(x.grad, ref.grad, torch.float32)


@pytest.mark.parametrize("E", [1, 2, 4, 5, 16])
def test_crps_kernel_matches_plain(cuda, E):
    """K15's forward and backward against the plain versions, with tied
    members and observations equal to a member: the backward's ranks break
    ties by member index, so it equals the plain gradient to rounding."""
    from makani_torch.utils.losses.crps_loss import crps_skillspread, crps_skillspread_fwd, crps_skillspread_grad, crps_skillspread_grad_plain, crps_skillspread_plain

    f = _randn((2, E, 3 * 1000 + 7), torch.float32, cuda)
    obs = _randn((2, f.shape[-1]), torch.float32, cuda, seed=1)
    f[:, :, :100] = f[:, :1, :100]
    if E > 1:
        f[:, 1, 100:200] = f[:, 0, 100:200]
    obs[:, 200:300] = f[:, E - 1, 200:300]
    g = _randn(obs.shape, torch.float32, cuda, seed=2)
    kernels.reset_launch_counts()
    y, dF = crps_skillspread_fwd(f, obs, 0.95), crps_skillspread_grad(f, obs, g, 0.95)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["crps"] == 2
    assert _agree(y, crps_skillspread_plain(f, obs, 0.95), torch.float32)
    assert _agree(dF, crps_skillspread_grad_plain(f, obs, g, 0.95), torch.float32)
    fk = f.clone().requires_grad_()
    fp = f.clone().requires_grad_()
    (crps_skillspread(fk, obs, 0.95) * g).sum().backward()
    (crps_skillspread(fp, obs, 0.95, use_kernels=False) * g).sum().backward()
    assert _agree(fk.grad, fp.grad, torch.float32)


def test_small_fcn3_train_step_kernel_path_matches_plain(cuda):
    """One fp32 ensemble-CRPS step of a small FCN3 (the shrunk configuration
    of tests/test_torch_fcn3_train.py, on the card), kernels against the
    plain path from the same weights: the gradients within 1e-4 of each
    leaf's max|ref| where the two forecasts rank the members alike
    (chip_smoke.crps_order_weight), and every training kernel launched."""
    import copy

    from chip_smoke import crps_order_weight, fcn3_train_config
    from makani_torch.models.model_registry import get_model
    from makani_torch.utils.loss import LossHandler
    from makani_torch.utils.training.ensemble_trainer import fold_ensemble
    from makani_torch.utils.yparams import ParamsBase

    names = ["u10m", "v10m", "t2m", "tcwv", "u500", "v500", "z500", "t500", "q500", "u850", "v850", "z850", "t850", "q850"]
    cfg = fcn3_train_config(img_shape_x=33, img_shape_y=64, channel_names=names, atmo_embed_dim=24, surf_embed_dim=16, aux_embed_dim=8,
                            num_layers=2, compute_dtype="float32", input_noise=dict(fcn3_train_config()["input_noise"], n_channels=2))
    model, _ = get_model(ParamsBase(copy.deepcopy(cfg)), multistep=True, device=cuda, seed=1)
    plain = copy.deepcopy(model)
    kernels.set_use_kernels(plain, False)
    loss_k, loss_p = LossHandler(ParamsBase(copy.deepcopy(cfg))), LossHandler(ParamsBase(copy.deepcopy(cfg)))
    loss_p.loss_fns[0].use_kernels = False
    E = cfg["ensemble_size"]
    inp = _randn((1, len(names), 33, 64), torch.float32, cuda).repeat_interleave(E, dim=0)
    tar = _randn((1, len(names), 33, 64), torch.float32, cuda, seed=1)
    unp = _randn((E, 1, 3, 33, 64), torch.float32, cuda, seed=2)
    with torch.no_grad():
        wgt = crps_order_weight(fold_ensemble(model(inp, unp, train=True), E), fold_ensemble(plain(inp, unp, train=True), E), tar)
    assert wgt.mean() > 0.999
    kernels.reset_launch_counts()
    grads = []
    for m, lo in ((model, loss_k), (plain, loss_p)):
        lo(fold_ensemble(m(inp, unp, train=True), E), tar, wgt=wgt, train=True).backward()
        grads.append({n: p.grad.clone() for n, p in m.named_parameters()})
    torch.cuda.synchronize()
    for n in grads[1]:
        assert (grads[0][n] - grads[1][n]).abs().max() <= 1e-4 * grads[1][n].abs().max(), n
    for name in ("disco_band_grad", "disco_polar_grad", "resample_grad", "crps", "disco_mix"):
        assert kernels.LAUNCHES[name] > 0, name
