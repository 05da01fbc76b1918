"""Split-complex real DFTs (counterparts of the ``rfft_cl_s`` / ``irfft_cl_s``
and ``rfft2_s`` / ``irfft2_s`` pairs in ``makani_tpu/ops/fft_compat.py``).

Conventions follow ``numpy.fft`` (norm in {"backward", "ortho", "forward"}).
Complex values are carried as a trailing [re, im] axis: ``torch.view_as_real``
of a channels-last ``rfft`` is already the ``(..., M, C, 2)`` layout.

These run on ``torch.fft`` (cuFFT on the card), the counterpart of the XLA FFT
the JAX package takes on a GPU; the JAX package's matmul DFT is a workaround
for backends without an FFT and is not ported. cuFFT has no bf16, so bf16
input is transformed in fp32 and the result cast back to bf16.
"""

from __future__ import annotations

import torch

__all__ = ["rfft_cl_s", "irfft_cl_s", "rfft2_s", "irfft2_s"]


def _upcast_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype == torch.bfloat16 else x


def rfft_cl_s(x: torch.Tensor, n: int | None = None, norm: str | None = None, mout: int | None = None) -> torch.Tensor:
    """real (..., W, C) -> split (..., M, C, 2); DFT over the -2 axis, keeping
    the first ``mout`` modes. The result is contiguous."""
    n = n or x.shape[-2]
    m_full = n // 2 + 1
    mout = min(mout or m_full, m_full)
    xf = torch.fft.rfft(_upcast_bf16(x), n=n, dim=-2, norm=norm)
    out = torch.view_as_real(xf[..., :mout, :])
    return out.to(x.dtype).contiguous()


def irfft_cl_s(x2: torch.Tensor, n: int | None = None, norm: str | None = None) -> torch.Tensor:
    """split (..., M, C, 2) -> real (..., W, C); inverse DFT over the -3 axis.
    Missing modes (M < n//2+1) count as zero, as in ``numpy.fft.irfft``."""
    m = x2.shape[-3]
    n = n or 2 * (m - 1)
    xc = torch.view_as_complex(_upcast_bf16(x2).contiguous())
    return torch.fft.irfft(xc, n=n, dim=-2, norm=norm).to(x2.dtype)


def rfft2_s(x: torch.Tensor, s=None, axes=(-2, -1), norm: str | None = None) -> torch.Tensor:
    """real x -> split (..., 2): the 2-D real DFT over ``axes`` (the halved
    axis last), as ``numpy.fft.rfft2``, with the [re, im] pair as a new
    trailing axis. ``s`` pads or crops the transformed axes. The result is
    ``torch.fft``'s storage viewed as pairs (over (1, 2) of a channels-last
    tensor a channels-first storage), in x's dtype (bf16 transformed in
    fp32)."""
    xf = torch.fft.rfft2(_upcast_bf16(x), s=s, dim=tuple(axes), norm=norm)
    return torch.view_as_real(xf).to(x.dtype)


def irfft2_s(x2: torch.Tensor, s=None, axes=(-2, -1), norm: str | None = None) -> torch.Tensor:
    """split (..., 2) -> real: the inverse of ``rfft2_s`` over the logical
    ``axes`` (those of the array without its pair axis), to the lengths ``s``
    (default: the first axis's length and 2 (m - 1) for the halved one), as
    ``numpy.fft.irfft2``. The imaginary parts of the halved axis's zero and
    Nyquist columns are ignored. x2 is read in place where its pairs are
    adjacent."""
    xs = _upcast_bf16(x2)
    if xs.stride(-1) != 1 or xs.storage_offset() % 2 or any(st % 2 for st in xs.stride()[:-1]):
        xs = xs.contiguous()
    return torch.fft.irfft2(torch.view_as_complex(xs), s=s, dim=tuple(axes), norm=norm).to(x2.dtype)
