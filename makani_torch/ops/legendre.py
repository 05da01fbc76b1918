"""Normalized associated Legendre polynomials.

Float64 numpy precomputation of the tables that drive the spherical harmonic
transform. Follows the orthonormal spherical-harmonic convention

    Y_l^m(theta, phi) = Pbar_l^m(cos theta) * exp(i m phi)

with ``Pbar_l^m = sqrt((2l+1)/(4 pi) * (l-m)!/(l+m)!) * P_l^m`` so that
``integral |Y_l^m|^2 dOmega = 1``. The Condon-Shortley phase ``(-1)^m`` is
included when ``csphase=True`` (the default, matching the convention the
reference stack uses via torch-harmonics; consumed by makani's SHT-bound
layers, e.g. ``makani/models/networks/sfnonet.py:792-805``).

Computed with the stable l-upward recurrence:

    Pbar_m^m     = sqrt((2m+1)/(2m)) * sin(theta) * Pbar_{m-1}^{m-1}
    Pbar_{m+1}^m = sqrt(2m+3) * cos(theta) * Pbar_m^m
    Pbar_l^m     = a_l^m * (cos(theta) * Pbar_{l-1}^m - b_l^m * Pbar_{l-2}^m)

    a_l^m = sqrt((4 l^2 - 1) / (l^2 - m^2))
    b_l^m = sqrt(((l-1)^2 - m^2) / (4 (l-1)^2 - 1))
"""

from __future__ import annotations

import numpy as np

__all__ = ["precompute_legpoly", "precompute_dlegpoly"]


def _legpoly(mmax: int, lmax: int, x: np.ndarray, norm: str = "ortho", inverse: bool = False, csphase: bool = True) -> np.ndarray:
    """Evaluate ``Pbar_l^m(x)`` for ``0 <= m < mmax``, ``0 <= l < lmax``.

    Returns an array of shape ``(mmax, lmax, len(x))``; entries with ``m > l``
    are zero.
    """
    nmax = max(mmax, lmax)
    x = np.asarray(x, dtype=np.float64)
    vdm = np.zeros((nmax, nmax, len(x)), dtype=np.float64)

    norm_factor = 1.0 if norm == "ortho" else np.sqrt(4.0 * np.pi)
    norm_factor = 1.0 / norm_factor if inverse else norm_factor

    sinsq = np.clip(1.0 - x * x, 0.0, None)
    sint = np.sqrt(sinsq)

    # seed
    vdm[0, 0] = norm_factor / np.sqrt(4.0 * np.pi)

    # diagonal and first sub-diagonal
    for l in range(1, nmax):
        vdm[l - 1, l] = np.sqrt(2.0 * l + 1.0) * x * vdm[l - 1, l - 1]
        vdm[l, l] = np.sqrt((2.0 * l + 1.0) / (2.0 * l)) * sint * vdm[l - 1, l - 1]

    # interior: l-upward recurrence for each m
    for l in range(2, nmax):
        for m in range(0, l - 1):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            vdm[m, l] = a * (x * vdm[m, l - 1] - b * vdm[m, l - 2])

    if norm == "schmidt":
        for l in range(nmax):
            if inverse:
                vdm[:, l] = vdm[:, l] * np.sqrt(2.0 * l + 1.0)
            else:
                vdm[:, l] = vdm[:, l] / np.sqrt(2.0 * l + 1.0)

    vdm = vdm[:mmax, :lmax]

    if csphase:
        for m in range(1, mmax, 2):
            vdm[m] = -vdm[m]

    return vdm


def precompute_legpoly(mmax: int, lmax: int, theta: np.ndarray, norm: str = "ortho", inverse: bool = False, csphase: bool = True) -> np.ndarray:
    """``Pbar_l^m(cos(theta))`` of shape ``(mmax, lmax, len(theta))``."""
    return _legpoly(mmax, lmax, np.cos(np.asarray(theta, dtype=np.float64)), norm=norm, inverse=inverse, csphase=csphase)


def precompute_dlegpoly(mmax: int, lmax: int, theta: np.ndarray, norm: str = "ortho", inverse: bool = False, csphase: bool = True) -> np.ndarray:
    """Tables for the vector spherical harmonics (tangent basis on S^2).

    Returns shape ``(2, mmax, lmax, len(theta))``:

      * ``[0]`` — ``d Pbar_l^m / d theta``
      * ``[1]`` — ``m Pbar_l^m / sin(theta)``

    both divided by ``sqrt(l (l+1))`` so that the vector harmonics

        Psi_lm = grad Y_lm / sqrt(l(l+1)),   Phi_lm = r x grad Y_lm / sqrt(l(l+1))

    are orthonormal. The l=0 row is zero (no tangent component).

    Pole-safe construction: both tables satisfy the same l-upward recurrence as
    ``Pbar`` itself, obtained by differentiating it in theta (for [0]) and by
    the closed seeds ``Q_l^l = l c_l Pbar_{l-1}^{l-1}`` (for [1], where
    ``Q = m Pbar / sin`` and ``c_l = sqrt((2l+1)/2l)``), so no division by
    ``sin(theta)`` ever occurs and the poles of equiangular grids are exact.
    """
    theta = np.asarray(theta, dtype=np.float64)
    x = np.cos(theta)
    s = np.sin(theta)
    nmax = max(mmax, lmax)

    norm_factor = 1.0 if norm == "ortho" else np.sqrt(4.0 * np.pi)
    norm_factor = 1.0 / norm_factor if inverse else norm_factor

    p = np.zeros((nmax, nmax, len(theta)), dtype=np.float64)  # Pbar[m, l]
    d = np.zeros_like(p)  # dPbar/dtheta
    q = np.zeros_like(p)  # m Pbar / sin

    p[0, 0] = norm_factor / np.sqrt(4.0 * np.pi)

    for l in range(1, nmax):
        c = np.sqrt((2.0 * l + 1.0) / (2.0 * l))
        e = np.sqrt(2.0 * l + 1.0)
        # diagonal: P[l,l] = c s P[l-1,l-1]
        p[l, l] = c * s * p[l - 1, l - 1]
        d[l, l] = c * (x * p[l - 1, l - 1] + s * d[l - 1, l - 1])
        q[l, l] = l * c * p[l - 1, l - 1]
        # first sub-diagonal: P[l-1,l] = e x P[l-1,l-1]
        p[l - 1, l] = e * x * p[l - 1, l - 1]
        d[l - 1, l] = e * (-s * p[l - 1, l - 1] + x * d[l - 1, l - 1])
        q[l - 1, l] = e * x * q[l - 1, l - 1]

    for l in range(2, nmax):
        for m in range(0, l - 1):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            p[m, l] = a * (x * p[m, l - 1] - b * p[m, l - 2])
            d[m, l] = a * (-s * p[m, l - 1] + x * d[m, l - 1] - b * d[m, l - 2])
            q[m, l] = a * (x * q[m, l - 1] - b * q[m, l - 2])

    out = np.stack([d[:mmax, :lmax], q[:mmax, :lmax]], axis=0)

    # orthonormalize the tangent basis; l = 0 carries no tangent field
    ll = np.arange(lmax, dtype=np.float64)
    scale = np.zeros(lmax)
    scale[1:] = 1.0 / np.sqrt(ll[1:] * (ll[1:] + 1.0))
    out = out * scale.reshape(1, 1, -1, 1)

    if norm == "schmidt":
        sch = np.sqrt(2.0 * ll + 1.0) if inverse else 1.0 / np.sqrt(2.0 * ll + 1.0)
        out = out * sch.reshape(1, 1, -1, 1)

    if csphase:
        for m in range(1, mmax, 2):
            out[:, m] = -out[:, m]

    return out
