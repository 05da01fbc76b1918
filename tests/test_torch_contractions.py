"""makani_torch spectral contractions against makani_tpu.

Seeded numpy inputs through the JAX einsums (CPU) and the port's plain
versions. Tolerances: fp32 max|diff| <= 1e-5 * max|ref|; bf16 relative L2
<= 2e-2 (both packages round operands and the four partial products).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from makani_tpu.models.common.contractions import contract_dense_s as jcontract_dense_s

from makani_torch import kernels
from makani_torch.models.common.contractions import _PermutedWeight, cmul_einsum_s, contract_dense_s, contract_dense_s_plain
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, L, M, CI, CO = 2, 6, 5, 4, 6


def _shapes(groups, separable, operator_type, channels_last):
    ci, co = CI // groups, (CI if separable else CO) // groups
    x = (B, L, M, groups, ci, 2) if channels_last else (B, groups, ci, L, M, 2)
    w = [groups, ci] + ([] if separable else [co]) + ([L, M] if operator_type == "diagonal" else [L]) + [2]
    return x, tuple(w)


CASES = [
    (1, False, "dhconv", True),
    (2, False, "dhconv", True),
    (1, False, "diagonal", True),
    (1, True, "dhconv", True),
    (2, False, "dhconv", False),
    (1, True, "diagonal", False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups,separable,operator_type,channels_last", CASES)
def test_contract_dense_matches_jax(groups, separable, operator_type, channels_last, dtype):
    xs, ws = _shapes(groups, separable, operator_type, channels_last)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    ref = np.asarray(jcontract_dense_s(jnp.asarray(x, jdt), jnp.asarray(w), separable, operator_type, channels_last), np.float32)
    out = contract_dense_s(torch.from_numpy(x).to(tdt), torch.from_numpy(w), separable, operator_type, channels_last)
    assert out.dtype == tdt and out.shape == ref.shape
    out = out.float().numpy()
    if dtype == "float32":
        assert np.max(np.abs(out - ref)) <= 1e-5 * np.max(np.abs(ref))
    else:
        assert np.linalg.norm(out - ref) <= 2e-2 * np.linalg.norm(ref)


def test_cmul_einsum_is_complex_product():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 4, 2))
    b = rng.standard_normal((4, 5, 2))
    out = cmul_einsum_s("ij,jk->ik", torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = (a[..., 0] + 1j * a[..., 1]) @ (b[..., 0] + 1j * b[..., 1])
    assert np.allclose(out[..., 0], ref.real) and np.allclose(out[..., 1], ref.imag)


def test_permuted_weight_made_once_per_version():
    w = torch.randn(2, 3, 4, 5, 2)
    cache = _PermutedWeight()
    p1 = cache.get(w, torch.float32)
    assert p1.shape == (5, 2, 3, 4, 2) and p1.is_contiguous()
    assert torch.equal(p1, w.permute(3, 0, 1, 2, 4))
    assert cache.get(w, torch.float32) is p1
    with torch.no_grad():
        w.mul_(2.0)
    p2 = cache.get(w, torch.float32)
    assert p2 is not p1 and torch.equal(p2, 2.0 * p1)
    assert cache.get(w, torch.bfloat16).dtype == torch.bfloat16


def test_contract_wrapper_takes_plain_on_cpu_without_counting():
    xs, ws = _shapes(1, False, "dhconv", True)
    x, w = torch.randn(xs), torch.randn(ws)
    kernels.reset_launch_counts()
    assert torch.equal(contract_dense_s(x, w, False, "dhconv", True), contract_dense_s_plain(x, w, False, "dhconv", True))
    assert kernels.LAUNCHES["dhconv"] == 0
