"""makani_torch InstanceNorm2d against makani_tpu's (default two-pass path),
with and without nlat_phys latitude padding, NCHW and channels-last.

Tolerances: fp32 max|diff| <= 1e-5 * max|ref|; bf16 relative L2 <= 2e-2.
K4's and K10's launch plans (``plan_instance_norm``,
``plan_instance_norm_grad``) are checked without a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from makani_tpu.models.common.layer_norm import InstanceNorm2d as JInstanceNorm2d

from makani_torch import kernels
from makani_torch.convert_jax import load_from_jax
from makani_torch.models.common.layer_norm import InstanceNorm2d, instance_norm_cl, instance_norm_cl_plain, plan_instance_norm, plan_instance_norm_grad
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

C = 6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("nlat_phys", [None, 7])
def test_instance_norm_matches_jax(nlat_phys, channels_last, dtype):
    rng = np.random.default_rng(0)
    shape = (2, 9, 16, C) if channels_last else (2, C, 9, 16)
    x = (3.0 * rng.standard_normal(shape) + 1.5).astype(np.float32)
    params = {"params": {"weight": rng.standard_normal(C).astype(np.float32), "bias": rng.standard_normal(C).astype(np.float32)}}
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jmod = JInstanceNorm2d(num_features=C, nlat_phys=nlat_phys, channels_last=channels_last)
    ref = np.asarray(jmod.apply(params, jnp.asarray(x, jdt)), np.float32)
    mod = load_from_jax(InstanceNorm2d(C, nlat_phys=nlat_phys, channels_last=channels_last, device="cpu"), params)
    with torch.no_grad():
        out = mod(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt and out.shape == ref.shape
    out = out.float().numpy()
    if dtype == "float32":
        assert np.max(np.abs(out - ref)) <= 1e-5 * np.max(np.abs(ref))
    else:
        assert np.linalg.norm(out - ref) <= 2e-2 * np.linalg.norm(ref)


def test_padded_rows_do_not_move_statistics():
    """Rows at or beyond nlat_phys carry no weight: changing them leaves the
    physical rows' output unchanged."""
    x = torch.randn(1, 9, 8, C)
    y1 = instance_norm_cl_plain(x, None, None, nlat_phys=6)
    x2 = x.clone()
    x2[:, 6:] = 1e3
    y2 = instance_norm_cl_plain(x2, None, None, nlat_phys=6)
    assert torch.allclose(y1[:, :6], y2[:, :6], atol=1e-6)
    assert torch.allclose(y1[:, :6].mean(dim=(1, 2)), torch.zeros(1, C), atol=1e-5)


def test_norm_wrapper_takes_plain_on_cpu_without_counting():
    x, w, b = torch.randn(2, 5, 8, C), torch.randn(C), torch.randn(C)
    kernels.reset_launch_counts()
    assert torch.equal(instance_norm_cl(x, w, b, 4), instance_norm_cl_plain(x, w, b, 4))
    assert kernels.LAUNCHES["instance_norm"] == 0
    mod = InstanceNorm2d(C, affine=False, channels_last=True, device="cpu")
    assert torch.equal(mod(x), instance_norm_cl_plain(x, None, None))


@pytest.mark.parametrize(
    "HW,C,itemsize,aligned,vec",
    [(721 * 1440, 384, 2, True, 8), (240 * 480, 384, 2, True, 8), (240 * 480, 384, 4, True, 4), (721 * 1440, 384, 4, True, 4),
     (37 * 50, 70, 2, True, 1), (37 * 50, 70, 4, True, 1), (64 * 128, 384, 2, False, 1), (3, 5, 4, True, 1)],
)
def test_instance_norm_plan(HW, C, itemsize, aligned, vec):
    """Every plan is a launch the kernel takes: whole warps of at most 512
    threads, a group that divides C into vec-wide loads, and a grid of one
    block an SM that covers every pixel."""
    p = plan_instance_norm(HW, C, itemsize, aligned=aligned)
    assert p.vec == vec and C % p.group == 0 and p.group % p.vec == 0
    assert p.threads == p.ppi * p.group // p.vec and p.threads % 32 == 0 and p.threads <= 512
    assert p.blocks == 132 and p.chunk == -(-HW // p.blocks)


def test_instance_norm_plan_groups():
    """The widest channel group a block can take: all 384 channels at the
    flagship's shapes, in one group; a C whose one-group block would exceed
    512 threads in whole warps takes the widest group that fits; ``group``
    picks one."""
    for HW, itemsize in ((721 * 1440, 2), (240 * 480, 2), (721 * 1440, 4), (240 * 480, 4)):
        assert plan_instance_norm(HW, 384, itemsize).group == 384
    assert plan_instance_norm(37 * 50, 70, 2).group == 14  # one channel a load: no whole-warp block of 70 or 35 threads a pixel
    assert plan_instance_norm(240 * 480, 384, 2, group=64).group == 64
    assert plan_instance_norm(240 * 480, 384, 2, sms=7).blocks == 7
    with pytest.raises(ValueError):
        plan_instance_norm(240 * 480, 384, 2, group=100)


@pytest.mark.parametrize(
    "B,HW,C,itemsize,aligned",
    [(3, 361 * 720, 384, 2, True), (3, 120 * 240, 384, 2, True), (3, 120 * 240, 384, 4, True), (1, 120 * 240, 384, 2, True),
     (1, 37 * 50, 37, 2, True), (5, 37 * 50, 70, 4, True), (200, 8 * 16, 64, 2, True), (2, 3, 5, 4, False)],
)
def test_instance_norm_grad_plan(B, HW, C, itemsize, aligned):
    """Every K10 plan is a launch the kernel takes: K4's threads and a grid
    of whole parts of blocks, one part a sample of the round (all B, at
    most one a block), whose chunks cover every pixel."""
    k4 = plan_instance_norm(HW, C, itemsize, aligned=aligned)
    p = plan_instance_norm_grad(B, HW, C, itemsize, aligned=aligned)
    assert (p.vec, p.group, p.ppi, p.threads) == (k4.vec, k4.group, k4.ppi, k4.threads)
    assert p.samples == min(B, 132) and p.blocks % p.samples == 0 and p.blocks > 132 - p.samples
    assert (p.blocks // p.samples) * p.chunk >= HW and p.chunk == -(-HW // (p.blocks // p.samples))
    with pytest.raises(ValueError):
        plan_instance_norm_grad(0, HW, C, itemsize)
