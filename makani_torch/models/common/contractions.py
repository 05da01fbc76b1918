"""Spectral-space contractions on split-complex tensors (counterpart of
``makani_tpu/models/common/contractions.py``).

Complex values are carried as a trailing [re, im] axis. The dense
channels-last dhconv contraction ``bxygi,giox->bxygo`` is the hand-written
kernel K3 (``csrc/dhconv.cu``) on the card; ``cmul_einsum_s`` is its plain
version (the JAX package's four real einsums).
"""

from __future__ import annotations

import torch

from makani_torch import kernels
from makani_torch.ops.precision import fp32_exact

__all__ = ["cmul_einsum_s", "contract_dense_s", "contract_dense_s_plain", "dhconv_contract_cl_s"]


def cmul_einsum_s(eq: str, a2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Complex einsum on split tensors: (ar + i ai)(br + i bi) via 4 real
    einsums. ``eq`` is the einsum over the logical (pair-less) axes."""
    # keep bf16 activations bf16 through the contraction: fp32 weights would
    # promote the whole spectral tensor to fp32
    if a2.dtype == torch.bfloat16 and b2.dtype != torch.bfloat16:
        b2 = b2.to(torch.bfloat16)
    ar, ai = a2[..., 0], a2[..., 1]
    br, bi = b2[..., 0], b2[..., 1]
    with fp32_exact():
        rr = torch.einsum(eq, ar, br)
        ii = torch.einsum(eq, ai, bi)
        ri = torch.einsum(eq, ar, bi)
        ir = torch.einsum(eq, ai, br)
    return torch.stack([rr - ii, ri + ir], dim=-1)


def _equation(separable: bool, operator_type: str, channels_last: bool) -> str:
    if operator_type not in ("diagonal", "dhconv"):
        raise ValueError(f"Unknown operator type {operator_type}")
    if channels_last:
        if separable:
            return "bxygi,gixy->bxygi" if operator_type == "diagonal" else "bxygi,gix->bxygi"
        return "bxygi,gioxy->bxygo" if operator_type == "diagonal" else "bxygi,giox->bxygo"
    if separable:
        return "bgixy,gixy->bgixy" if operator_type == "diagonal" else "bgixy,gix->bgixy"
    return "bgixy,gioxy->bgoxy" if operator_type == "diagonal" else "bgixy,giox->bgoxy"


def contract_dense_s_plain(
    x2: torch.Tensor, w2: torch.Tensor, separable: bool = False, operator_type: str = "diagonal", channels_last: bool = False
) -> torch.Tensor:
    """Grouped spectral contraction on split tensors, in plain PyTorch.

    x2: (B, G, C_in/G, L, M, 2), or (B, L, M, G, C_in/G, 2) channels-last.
    Weights (trailing pair axis):
      * diagonal, dense:    (G, C_in/G, C_out/G, L, M, 2)
      * dhconv, dense:      (G, C_in/G, C_out/G, L, 2)
      * diagonal, separable:(G, C_in/G, L, M, 2)
      * dhconv, separable:  (G, C_in/G, L, 2)
    """
    return cmul_einsum_s(_equation(separable, operator_type, channels_last), x2, w2)


class _PermutedWeight:
    """The dhconv weight (G, Ci, Co, L, 2) permuted to (L, G, Ci, Co, 2) in
    the activation dtype, the layout K3 reads. Made once per weight version,
    not per call."""

    def __init__(self):
        self._key = None
        self._value = None

    def get(self, w2: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        key = (w2.data_ptr(), w2._version, w2.device, dtype)
        if key != self._key:
            self._value = w2.detach().permute(3, 0, 1, 2, 4).to(dtype).contiguous()
            self._key = key
        return self._value


def dhconv_contract_cl_s(x2: torch.Tensor, w_perm: torch.Tensor) -> torch.Tensor:
    """Launch K3: channels-last dense dhconv ``bxygi,giox->bxygo`` on split
    tensors. x2 (B, L, M, G, Ci, 2) and ``w_perm`` (L, G, Ci, Co, 2) in one
    dtype (float32 or bfloat16), both contiguous on one CUDA device; returns
    (B, L, M, G, Co, 2) in that dtype, accumulated in fp32."""
    if x2.dtype != w_perm.dtype:
        raise TypeError(f"dhconv: input {x2.dtype} and weight {w_perm.dtype} differ")
    if x2.dim() != 6 or w_perm.dim() != 5 or x2.shape[-1] != 2 or w_perm.shape[-1] != 2:
        raise ValueError(f"dhconv: expected x (B,L,M,G,Ci,2) and w (L,G,Ci,Co,2), got {tuple(x2.shape)} and {tuple(w_perm.shape)}")
    B, L, M, G, Ci, _ = x2.shape
    if tuple(w_perm.shape[:3]) != (L, G, Ci):
        raise ValueError(f"dhconv: x {tuple(x2.shape)} does not match w {tuple(w_perm.shape)}")
    if not (x2.is_contiguous() and w_perm.is_contiguous()):
        raise ValueError("dhconv: x and w must be contiguous")
    Co = w_perm.shape[3]
    out = torch.empty(B, L, M, G, Co, 2, dtype=x2.dtype, device=x2.device)
    if out.numel() == 0:
        return out
    lib = kernels.library()
    with torch.cuda.device(x2.device):
        err = lib.mt_dhconv_contract(
            kernels.dtype_code(x2.dtype), x2.data_ptr(), w_perm.data_ptr(), out.data_ptr(), B, L, M, G, Ci, Co, kernels.stream_ptr(x2.device)
        )
    kernels.check_launch(err, "dhconv")
    kernels.count_launch("dhconv")
    return out


def contract_dense_s(
    x2: torch.Tensor,
    w2: torch.Tensor,
    separable: bool = False,
    operator_type: str = "diagonal",
    channels_last: bool = False,
    weight_cache: _PermutedWeight | None = None,
) -> torch.Tensor:
    """Grouped spectral contraction; see ``contract_dense_s_plain``.

    The dense channels-last dhconv case (the SFNO's) is kernel K3 on the card,
    replacing ``makani_tpu/models/common/contractions.py`` ``contract_dense_s``
    + ``cmul_einsum_s``. The other cases have no kernel yet: on the card they
    raise rather than run unported code. ``weight_cache`` keeps K3's permuted
    weight between calls (``SpectralConv`` owns one per weight).
    """
    if kernels.takes_plain("dhconv", x2, w2):
        return contract_dense_s_plain(x2, w2, separable, operator_type, channels_last)
    if separable or operator_type != "dhconv" or not channels_last:
        raise NotImplementedError(
            f"no kernel for the {'separable' if separable else 'dense'} {operator_type} contraction "
            f"({'channels-last' if channels_last else 'NCHW'}); only dense channels-last dhconv is ported"
        )
    dtype = torch.bfloat16 if x2.dtype == torch.bfloat16 else w2.dtype
    cache = weight_cache if weight_cache is not None else _PermutedWeight()
    return dhconv_contract_cl_s(x2.to(dtype).contiguous(), cache.get(w2, dtype))
