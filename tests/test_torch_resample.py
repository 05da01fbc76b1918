"""makani_torch's bilinear ResampleS2 against makani_tpu's gather method, on
the CPU (the kernel K7's plain version), up and down between equiangular and
Legendre-Gauss grids. fp32, max|diff| <= 1e-5 * max|ref| (the same lerps in
the same order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from makani_tpu.ops.resample import ResampleS2 as JResampleS2

from makani_torch import kernels
from makani_torch.ops.resample import ResampleS2, column_span, make_resample
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRIDS = ["equiangular", "legendre-gauss"]


@pytest.mark.parametrize("direction", ["up", "down"])
@pytest.mark.parametrize("grid_out", GRIDS)
@pytest.mark.parametrize("grid_in", GRIDS)
def test_resample_matches_jax(grid_in, grid_out, direction):
    small, large = (18, 36), (37, 72)
    (hi, wi), (ho, wo) = (small, large) if direction == "up" else (large, small)
    ref_op = JResampleS2(hi, wi, ho, wo, grid_in=grid_in, grid_out=grid_out, method="gather")
    op = ResampleS2(hi, wi, ho, wo, grid_in=grid_in, grid_out=grid_out)
    for name in ("lat_idx", "lon_idx0", "lon_idx1", "lon_w"):
        assert np.array_equal(getattr(op, name), getattr(ref_op, name)), name
    assert np.array_equal(op.lat_w, ref_op.lat_w[:, 0])

    x = np.random.default_rng(0).standard_normal((2, 5, hi, wi)).astype(np.float32)
    ref = np.asarray(jax.jit(ref_op.__call__)(jnp.asarray(x)))
    kernels.reset_launch_counts()
    out = op(torch.from_numpy(x)).numpy()
    out_cl = op.resample_cl(torch.from_numpy(x).permute(0, 2, 3, 1)).permute(0, 3, 1, 2).numpy()
    assert not any(kernels.LAUNCHES.values())
    for o in (out, out_cl):
        assert o.shape == ref.shape == (2, 5, ho, wo)
        assert np.max(np.abs(o - ref)) <= 1e-5 * np.max(np.abs(ref))


def test_make_resample_is_the_serial_gather():
    op = make_resample(18, 36, 37, 72, grid_in="legendre-gauss", grid_out="equiangular")
    assert isinstance(op, ResampleS2) and op.method == "gather"
    with pytest.raises(NotImplementedError):
        ResampleS2(18, 36, 37, 72, method="matmul")


@pytest.mark.parametrize("tw", [4, 16, 64])
@pytest.mark.parametrize("wi,wo", [(720, 1440), (36, 72), (72, 36), (90, 180), (36, 37), (37, 36)])
def test_column_span_covers_every_tile(wi, wo, tw):
    """K7 stages, for each tile of tw output columns, the input columns from
    the tile's first lon_idx0 onward (modulo wi); column_span is the widest
    such run over the tiles, here against a loop over every column read."""
    op = ResampleS2(18, wi, 19, wo)
    need = 0
    for t0 in range(0, wo, tw):
        start = int(op.lon_idx0[t0])
        for w in range(t0, min(t0 + tw, wo)):
            for k in (int(op.lon_idx0[w]), int(op.lon_idx1[w])):
                need = max(need, (k - start) % wi + 1)
    assert column_span(op.lon_idx0, op.lon_idx1, wi, tw) == need <= wi

