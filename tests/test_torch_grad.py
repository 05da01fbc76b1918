"""The backward of makani_torch's kernel Functions (K1-K4) on their plain
route, against ``jax.vjp`` of the JAX package's functions, and
``torch.autograd.gradcheck`` in float64.

The Legendre analysis and synthesis contractions (``ops/sht.py``), the dense
channels-last dhconv (``contract_dense_s``, input and weight gradients) and
``InstanceNorm2d`` (default two-pass path, with and without ``nlat_phys`` <
H) get the same seeded numpy inputs and output cotangent in both packages.
Tolerances: fp32 max|diff| <= 1e-5 * max|ref| (summation order); the bf16
instance norm's dx relative L2 <= 2e-2 (bf16 rounds the normalized value, the
affine products and dx; the JAX package's bf16 products may round in other
places). Its bf16 dw and db are sums of bf16 products over (b, h, w): XLA on
the CPU accumulates them in bf16 (3.6% relative L2 from the float64 sum of
the same products at this shape, measured), the port in fp32 with one
rounding at the end; they are held to that float64 sum (relative L2 <= 1e-2)
and to JAX's within its error (5e-2). The JAX side is jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from makani_tpu.models.common.contractions import contract_dense_s as jcontract_dense_s
from makani_tpu.models.common.layer_norm import InstanceNorm2d as JInstanceNorm2d
from makani_tpu.ops.sht import _analysis_contract_cl_s as janalysis
from makani_tpu.ops.sht import _synthesis_contract_cl_s as jsynthesis

from makani_torch import kernels
from makani_torch.models.common import layer_norm
from makani_torch.models.common.contractions import _PermutedWeight, contract_dense_s
from makani_torch.models.common.layer_norm import InstanceNorm2d
from makani_torch.ops.sht import InverseRealSHT, RealSHT, analysis_contract_cl_s, synthesis_contract_cl_s
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _rng(seed):
    return np.random.default_rng(seed)


def _close32(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= 1e-5 * np.max(np.abs(ref))


def _vjp(fn, *args, cot):
    """jax.vjp of a jitted fn at args, pulled back from cot; numpy."""
    _, pull = jax.vjp(jax.jit(fn), *map(jnp.asarray, args))
    return [np.asarray(g, np.float32) for g in pull(jnp.asarray(cot))]


@pytest.mark.parametrize("nlat,nlon,grid,lmax,mmax", [(13, 24, "legendre-gauss", 10, 9), (19, 36, "equiangular", None, None)])
def test_legendre_grads_match_jax(nlat, nlon, grid, lmax, mmax):
    fwd = RealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
    inv = InverseRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
    w, p = fwd.weights("cpu"), inv.pct("cpu")
    r = _rng(0)
    x = r.standard_normal((2, nlat, fwd.mmax, 3, 2)).astype(np.float32)
    ga = r.standard_normal((2, fwd.lmax, fwd.mmax, 3, 2)).astype(np.float32)
    c = r.standard_normal((2, inv.lmax, inv.mmax, 3, 2)).astype(np.float32)
    gs = r.standard_normal((2, nlat, inv.mmax, 3, 2)).astype(np.float32)

    (ref_x,) = _vjp(lambda v: janalysis(v, jnp.asarray(w.numpy())), x, cot=ga)
    (ref_c,) = _vjp(lambda v: jsynthesis(v, jnp.asarray(p.numpy())), c, cot=gs)
    xt, ct = torch.from_numpy(x).requires_grad_(), torch.from_numpy(c).requires_grad_()
    kernels.reset_launch_counts()
    analysis_contract_cl_s(xt, w).backward(torch.from_numpy(ga))
    synthesis_contract_cl_s(ct, p).backward(torch.from_numpy(gs))
    assert not any(kernels.LAUNCHES.values())
    _close32(xt.grad.numpy(), ref_x)
    _close32(ct.grad.numpy(), ref_c)


@pytest.mark.parametrize("G,Ci,Co", [(1, 6, 5), (2, 3, 4)])
def test_dhconv_grads_match_jax(G, Ci, Co):
    B, L, M = 2, 7, 6
    r = _rng(1)
    x = r.standard_normal((B, L, M, G, Ci, 2)).astype(np.float32)
    w = r.standard_normal((G, Ci, Co, L, 2)).astype(np.float32)
    g = r.standard_normal((B, L, M, G, Co, 2)).astype(np.float32)
    ref_x, ref_w = _vjp(lambda a, b: jcontract_dense_s(a, b, False, "dhconv", True), x, w, cot=g)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    contract_dense_s(xt, wt, False, "dhconv", True, weight_cache=_PermutedWeight()).backward(torch.from_numpy(g))
    _close32(xt.grad.numpy(), ref_x)
    _close32(wt.grad.numpy(), ref_w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nlat_phys", [None, 7])
def test_instance_norm_grads_match_jax(nlat_phys, dtype):
    C = 6
    r = _rng(2)
    x = (3.0 * r.standard_normal((2, 9, 16, C)) + 1.5).astype(np.float32)
    g = r.standard_normal((2, 9, 16, C)).astype(np.float32)
    wb = {"weight": (1.0 + 0.1 * r.standard_normal(C)).astype(np.float32), "bias": r.standard_normal(C).astype(np.float32)}
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jmod = JInstanceNorm2d(num_features=C, nlat_phys=nlat_phys, channels_last=True)

    def f(v, wt, bs):
        return jmod.apply({"params": {"weight": wt, "bias": bs}}, v.astype(jdt))

    ref_x, ref_w, ref_b = _vjp(f, x, wb["weight"], wb["bias"], cot=jnp.asarray(g, jdt))
    mod = InstanceNorm2d(C, nlat_phys=nlat_phys, channels_last=True, device="cpu")
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(wb["weight"]))
        mod.bias.copy_(torch.from_numpy(wb["bias"]))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    mod(xt).backward(torch.from_numpy(g).to(tdt))
    assert xt.grad.dtype == tdt and mod.weight.grad.dtype == torch.float32
    if dtype == "float32":
        for out, ref in ((xt.grad, ref_x), (mod.weight.grad, ref_w), (mod.bias.grad, ref_b)):
            _close32(out.numpy(), ref)
        return

    def rel(out, ref):
        return np.linalg.norm(out - ref) / np.linalg.norm(ref)

    assert rel(xt.grad.float().numpy(), ref_x) <= 2e-2
    # float64 sums of the bf16 products the affine step's gradient is made of
    xb, gb = xt.detach().double(), torch.from_numpy(g).to(tdt).double()
    mean, sd = layer_norm._norm_stats_plain(xb, nlat_phys, 1e-6)
    zr = ((xb - mean) / sd).to(tdt)
    exact_w = (gb * zr).to(tdt).double().sum(dim=(0, 1, 2)).numpy()
    exact_b = gb.sum(dim=(0, 1, 2)).numpy()
    for out, exact, ref in ((mod.weight.grad, exact_w, ref_w), (mod.bias.grad, exact_b, ref_b)):
        assert rel(out.numpy(), exact) <= 1e-2 and rel(out.numpy(), ref) <= 5e-2


def test_instance_norm_padded_rows_get_the_elementwise_gradient():
    """Rows at or beyond nlat_phys carry no statistics weight: their dx is
    w * g / sd alone, as the closed form (ops/norm.py) says."""
    x, g, w = torch.randn(1, 9, 8, 4, dtype=torch.float64), torch.randn(1, 9, 8, 4, dtype=torch.float64), torch.randn(4, dtype=torch.float64)
    mean, sd = layer_norm._norm_stats_plain(x, 6, 1e-6)
    dx, _, _ = layer_norm.instance_norm_grad_plain(g, x, w, mean, sd, 6 * 8)
    assert torch.allclose(dx[:, 6:], (g * w / sd)[:, 6:], rtol=1e-12, atol=0)


def test_functions_pass_gradcheck_in_float64():
    r = torch.Generator().manual_seed(3)
    fwd = RealSHT(7, 12, grid="legendre-gauss")
    inv = InverseRealSHT(7, 12, grid="legendre-gauss")
    w, p = fwd.weights("cpu", torch.float64), inv.pct("cpu", torch.float64)
    x = torch.randn(1, 7, fwd.mmax, 2, 2, dtype=torch.float64, generator=r, requires_grad=True)
    c = torch.randn(1, inv.lmax, inv.mmax, 2, 2, dtype=torch.float64, generator=r, requires_grad=True)
    assert torch.autograd.gradcheck(lambda v: analysis_contract_cl_s(v, w), (x,))
    assert torch.autograd.gradcheck(lambda v: synthesis_contract_cl_s(v, p), (c,))
    xd = torch.randn(2, 3, 4, 1, 3, 2, dtype=torch.float64, generator=r, requires_grad=True)
    wd = torch.randn(1, 3, 2, 3, 2, dtype=torch.float64, generator=r, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: contract_dense_s(a, b, False, "dhconv", True, weight_cache=_PermutedWeight()), (xd, wd))
    xn = torch.randn(2, 5, 6, 3, dtype=torch.float64, generator=r, requires_grad=True)
    wn = torch.randn(3, dtype=torch.float64, generator=r, requires_grad=True)
    bn = torch.randn(3, dtype=torch.float64, generator=r, requires_grad=True)
    for nlat_phys in (None, 4):
        assert torch.autograd.gradcheck(lambda a, b, c_: layer_norm.instance_norm_cl(a, b, c_, nlat_phys), (xn, wn, bn))
