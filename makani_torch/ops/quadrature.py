"""Quadrature rules on the sphere.

Numpy (float64) precomputation of the quadrature nodes/weights used by the
spherical harmonic transform and the geometric quadrature utilities.

Provides the same rule set as the reference stack (torch-harmonics
``quadrature.py``, consumed by makani at ``makani/utils/grids.py:20,111-142``):
Legendre-Gauss, Lobatto, Clenshaw-Curtiss (equiangular incl. poles), plus the
"naive" sin(theta) rule and WeatherBench2 cell-area weights used by the metric
stack.

Conventions:
  * nodes are returned as ``x = cos(theta)`` together with weights for
    integration over ``x`` in ``[a, b]`` (default ``[-1, 1]``),
  * latitude helpers return colatitude ``theta`` ascending in ``[0, pi]``
    (north pole first), matching the ERA5 721x1440 data layout.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "legendre_gauss_weights",
    "lobatto_weights",
    "clenshaw_curtiss_weights",
    "precompute_latitudes",
]


def legendre_gauss_weights(n: int, a: float = -1.0, b: float = 1.0):
    """Legendre-Gauss nodes and weights on [a, b].

    Exact for polynomials up to degree 2n - 1.
    """
    xlg, wlg = np.polynomial.legendre.leggauss(n)
    # affine map onto [a, b]
    xlg = (b - a) * 0.5 * xlg + (b + a) * 0.5
    wlg = wlg * (b - a) * 0.5
    return xlg, wlg


def lobatto_weights(n: int, a: float = -1.0, b: float = 1.0, tol: float = 1e-16, maxiter: int = 100):
    """Gauss-Lobatto-Legendre nodes and weights on [a, b] (endpoints included).

    Exact for polynomials up to degree 2n - 3. Computed by Newton iteration on
    the derivative of the Legendre polynomial, started from the Chebyshev-
    Gauss-Lobatto nodes.
    """
    if n < 2:
        raise ValueError("Lobatto rule needs at least 2 nodes")

    # initial guess: Chebyshev-Gauss-Lobatto nodes
    x = np.cos(np.pi * np.arange(n) / (n - 1))

    # Newton iteration on (1-x^2) P'_{n-1}(x) = 0 via the recurrence for P_{n-1}
    p_old = np.zeros_like(x)
    for _ in range(maxiter):
        p_old[:] = x
        # evaluate P_{n-1} via three-term recurrence, building the Vandermonde column
        vm_prev = np.ones_like(x)  # P_0
        vm = x.copy()  # P_1
        for k in range(2, n):
            vm_prev, vm = vm, ((2 * k - 1) * x * vm - (k - 1) * vm_prev) / k
        # vm = P_{n-1}, vm_prev = P_{n-2}
        x = p_old - (x * vm - vm_prev) / (n * vm)
        if np.max(np.abs(x - p_old)) < tol:
            break

    # recompute P_{n-1} at the converged nodes
    vm_prev = np.ones_like(x)
    vm = x.copy()
    for k in range(2, n):
        vm_prev, vm = vm, ((2 * k - 1) * x * vm - (k - 1) * vm_prev) / k

    w = 2.0 / ((n - 1) * n * vm**2)

    # nodes came out descending; return ascending like the other rules
    x = x[::-1].copy()
    w = w[::-1].copy()

    # affine map onto [a, b]
    x = (b - a) * 0.5 * x + (b + a) * 0.5
    w = w * (b - a) * 0.5
    return x, w


def clenshaw_curtiss_weights(n: int, a: float = -1.0, b: float = 1.0):
    """Clenshaw-Curtis nodes and weights on [a, b] (endpoints included).

    Nodes are ``x_j = cos(j pi / (n-1))`` for ``j = 0..n-1`` (descending in x,
    i.e. equiangular ascending in theta). Exact for polynomials up to degree
    n - 1.
    """
    if n < 2:
        raise ValueError("Clenshaw-Curtis rule needs at least 2 nodes")

    N = n - 1
    tj = np.pi * np.arange(n) / N
    xj = np.cos(tj)

    # classic cosine-sum formula
    kmax = N // 2
    k = np.arange(1, kmax + 1)
    bk = np.full(kmax, 2.0)
    if N % 2 == 0:
        bk[-1] = 1.0
    # sum_k b_k cos(2 k t_j) / (4k^2 - 1)
    s = np.cos(2.0 * np.outer(tj, k)) @ (bk / (4.0 * k**2 - 1.0))
    cj = np.full(n, 2.0)
    cj[0] = 1.0
    cj[-1] = 1.0
    w = (cj / N) * (1.0 - s)

    # affine map onto [a, b]
    xj = (b - a) * 0.5 * xj + (b + a) * 0.5
    w = w * (b - a) * 0.5
    return xj, w


_GRID_RULES = {
    "equiangular": clenshaw_curtiss_weights,
    "clenshaw-curtiss": clenshaw_curtiss_weights,
    "legendre-gauss": legendre_gauss_weights,
    "lobatto": lobatto_weights,
}


def precompute_latitudes(nlat: int, grid: str = "equiangular"):
    """Colatitudes ``theta`` (ascending in [0, pi], north pole first) and the
    matching quadrature weights for integration over ``cos(theta)``.

    Mirrors torch-harmonics ``precompute_latitudes`` as used by makani at
    ``makani/utils/grids.py:20`` and the SHT constructors.
    """
    try:
        rule = _GRID_RULES[grid]
    except KeyError:
        raise ValueError(f"Unknown grid type {grid}") from None
    cost, w = rule(nlat, -1.0, 1.0)
    # order by ascending theta == descending cos(theta)
    order = np.argsort(-cost, kind="stable")
    cost = cost[order]
    w = w[order]
    theta = np.arccos(np.clip(cost, -1.0, 1.0))
    return theta, w
