"""Spectral-space contractions on split-complex tensors (counterpart of
``makani_tpu/models/common/contractions.py``).

Complex values are carried as a trailing [re, im] axis. The dense
channels-last dhconv contraction ``bxygi,giox->bxygo`` is the hand-written
kernel K3 (``csrc/dhconv.cu``) on the card; ``cmul_einsum_s`` is its plain
version (the JAX package's four real einsums). It is a
``torch.autograd.Function`` whose backward is

  dx[b,l,m,g,i] = sum_o  g[b,l,m,g,o] * conj(w[g,i,o,l])   K3 again, in its
                  input-gradient mode: it reads the forward's cached weight
                  (L, G, Ci, Co, 2) and conjugates it as it stages it
                  (``dhconv_grad_input``);
  dw[g,i,o,l]   = sum_bm conj(x[b,l,m,g,i]) * g[b,l,m,g,o] kernel K9
                  (``csrc/dhconv_grad.cu``, ``dhconv_grad_weight``), written
                  in the parameter's own layout (G, Ci, Co, L, 2);

with the same two formulas as einsums for its plain version.
"""

from __future__ import annotations

import torch

from makani_torch import kernels
from makani_torch.ops.precision import fp32_exact

__all__ = [
    "cmul_einsum_s",
    "contract_dense_s",
    "contract_dense_s_plain",
    "dhconv_contract_cl_s",
    "dhconv_grad_input",
    "dhconv_grad_input_plain",
    "dhconv_grad_weight",
    "dhconv_grad_weight_plain",
]


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


def dhconv_grad_input_plain(g2: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """dx of the channels-last dense dhconv: g2 (B, L, M, G, Co, 2) times the
    conjugate of w2 (G, Ci, Co, L, 2) summed over Co, in plain PyTorch."""
    wc = torch.stack([w2[..., 0], -w2[..., 1]], dim=-1)
    return cmul_einsum_s("bxygo,giox->bxygi", g2, wc)


def dhconv_grad_weight_plain(x2: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """dw of the channels-last dense dhconv: conj(x2) (B, L, M, G, Ci, 2)
    times g2 (B, L, M, G, Co, 2) summed over (B, M), as (G, Ci, Co, L, 2) in
    the input dtype, in plain PyTorch."""
    xc = torch.stack([x2[..., 0], -x2[..., 1]], dim=-1)
    return cmul_einsum_s("bxygi,bxygo->giox", xc, g2)


def _k3_launch(x2: torch.Tensor, w_perm: torch.Tensor, grad_input: bool) -> torch.Tensor:
    """K3 on x2 (B, L, M, G, Ci, 2) and w_perm (L, G, Ci, Co, 2): the forward
    gives (B, L, M, G, Co, 2); the input gradient takes x2 as g (B, L, M, G,
    Co, 2) and gives (B, L, M, G, Ci, 2)."""
    name = "dhconv_grad_input" if grad_input else "dhconv"
    if x2.dtype != w_perm.dtype:
        raise TypeError(f"{name}: input {x2.dtype} and weight {w_perm.dtype} differ")
    if x2.dim() != 6 or w_perm.dim() != 5 or x2.shape[-1] != 2 or w_perm.shape[-1] != 2:
        raise ValueError(f"{name}: expected x (B,L,M,G,C,2) and w (L,G,Ci,Co,2), got {tuple(x2.shape)} and {tuple(w_perm.shape)}")
    B, L, M, G, K, _ = x2.shape
    Ci, Co = w_perm.shape[2], w_perm.shape[3]
    if tuple(w_perm.shape[:2]) != (L, G) or K != (Co if grad_input else Ci):
        raise ValueError(f"{name}: x {tuple(x2.shape)} does not match w {tuple(w_perm.shape)}")
    if not (x2.is_contiguous() and w_perm.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous")
    out = torch.empty(B, L, M, G, Ci if grad_input else Co, 2, dtype=x2.dtype, device=x2.device)
    if out.numel() == 0:
        return out
    lib = kernels.library()
    launch = lib.mt_dhconv_grad_input if grad_input else lib.mt_dhconv_contract
    with torch.cuda.device(x2.device):
        err = launch(kernels.dtype_code(x2.dtype), x2.data_ptr(), w_perm.data_ptr(), out.data_ptr(), B, L, M, G, Ci, Co, kernels.stream_ptr(x2.device))
    kernels.check_launch(err, name)
    kernels.count_launch(name)
    return out


def dhconv_contract_cl_s(x2: torch.Tensor, w_perm: torch.Tensor) -> torch.Tensor:
    """Launch K3: channels-last dense dhconv ``bxygi,giox->bxygo`` on split
    tensors. x2 (B, L, M, G, Ci, 2) and ``w_perm`` (L, G, Ci, Co, 2) in one
    dtype (float32 or bfloat16), both contiguous on one CUDA device; returns
    (B, L, M, G, Co, 2) in that dtype, accumulated in fp32."""
    return _k3_launch(x2, w_perm, grad_input=False)


def dhconv_grad_input(g2: torch.Tensor, w_perm: torch.Tensor) -> torch.Tensor:
    """dx of the dense channels-last dhconv on the card: K3 in its
    input-gradient mode, counted as ``dhconv_grad_input``. g2 (B, L, M, G,
    Co, 2) and the forward's permuted weight ``w_perm`` (L, G, Ci, Co, 2,
    ``_PermutedWeight``) in one dtype (float32 or bfloat16), contiguous on
    one CUDA device; returns (B, L, M, G, Ci, 2) in that dtype. K3 conjugates
    the weight as it stages it: nothing but the output is allocated."""
    return _k3_launch(g2, w_perm, grad_input=True)


def dhconv_grad_weight(x2: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """Launch K9: dw[g,i,o,l] = sum_{b,m} conj(x2[b,l,m,g,i]) g2[b,l,m,g,o]
    on split tensors, x2 (B, L, M, G, Ci, 2) and g2 (B, L, M, G, Co, 2) in
    one dtype (float32 or bfloat16), contiguous on one CUDA device. Returns
    float32 (G, Ci, Co, L, 2), the parameter's layout, accumulated in fp32
    (for bf16 input rounded once to bf16, as the plain einsum's output)."""
    if x2.dtype != g2.dtype:
        raise TypeError(f"dhconv_grad_weight: x {x2.dtype} and g {g2.dtype} differ")
    if x2.dim() != 6 or g2.dim() != 6 or x2.shape[-1] != 2 or g2.shape[-1] != 2 or x2.shape[:4] != g2.shape[:4]:
        raise ValueError(f"dhconv_grad_weight: expected x (B,L,M,G,Ci,2) and g (B,L,M,G,Co,2), got {tuple(x2.shape)} and {tuple(g2.shape)}")
    if not (x2.is_contiguous() and g2.is_contiguous()):
        raise ValueError("dhconv_grad_weight: x and g must be contiguous")
    B, L, M, G, Ci, _ = x2.shape
    Co = g2.shape[4]
    out = torch.empty(G, Ci, Co, L, 2, dtype=torch.float32, device=x2.device)
    if out.numel() == 0:
        return out
    # K9 copies each row from its 16-byte aligned start: a view at an odd
    # offset goes in as an aligned copy
    x2, g2 = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x2, g2))
    lib = kernels.library()
    with torch.cuda.device(x2.device):
        err = lib.mt_dhconv_grad_weight(
            kernels.dtype_code(x2.dtype), x2.data_ptr(), g2.data_ptr(), out.data_ptr(), B, L, M, G, Ci, Co, kernels.stream_ptr(x2.device)
        )
    kernels.check_launch(err, "dhconv_grad_weight")
    kernels.count_launch("dhconv_grad_weight")
    return out


class _DhconvContract(torch.autograd.Function):
    """The dense channels-last dhconv with its hand-written backward: K3
    forward, K3's input-gradient mode on the forward's cached weight for dx
    and K9 for dw on the card; the plain einsums of the same formulas on the
    CPU. The weight is an input (the gradient flows to the parameter); the
    weight cache rides on ``ctx`` (not a saved tensor), and the backward asks
    it for the forward's key, so nothing is built there."""

    @staticmethod
    def forward(ctx, x2, w2, cache):
        ctx.save_for_backward(x2, w2)
        ctx.cache = cache
        if kernels.takes_plain("dhconv", x2, w2):
            return contract_dense_s_plain(x2, w2, False, "dhconv", True)
        dtype = torch.bfloat16 if x2.dtype == torch.bfloat16 else w2.dtype
        return dhconv_contract_cl_s(x2.to(dtype).contiguous(), cache.get(w2, dtype))

    @staticmethod
    def backward(ctx, g2):
        x2, w2 = ctx.saved_tensors
        dx = dw = None
        if kernels.takes_plain("dhconv_grad_input", g2, x2, w2):
            if ctx.needs_input_grad[0]:
                dx = dhconv_grad_input_plain(g2, w2)
            if ctx.needs_input_grad[1]:
                dw = dhconv_grad_weight_plain(x2.to(g2.dtype), g2)
            return dx, dw, None
        dtype = torch.bfloat16 if x2.dtype == torch.bfloat16 else w2.dtype
        g2 = g2.to(dtype).contiguous()
        if ctx.needs_input_grad[0]:
            dx = dhconv_grad_input(g2, ctx.cache.get(w2, dtype))
        if ctx.needs_input_grad[1]:
            dw = dhconv_grad_weight(x2.to(dtype).contiguous(), g2)
            if dtype == torch.bfloat16:
                dw = dw.to(torch.bfloat16)
        return dx, dw, None


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
    + ``cmul_einsum_s``, with its backward (K3's input-gradient mode on the
    cached weight for dx, K9 for dw); on the CPU the same ``autograd.Function`` runs
    the plain einsums. The other cases have no kernel yet: on the CPU they
    run the plain version under autograd, on the card they raise rather than
    run unported code. ``weight_cache`` keeps K3's permuted weight between
    calls of one weight version (``SpectralConv`` owns one per weight).
    """
    dense_cl_dhconv = not separable and operator_type == "dhconv" and channels_last
    if dense_cl_dhconv:
        return _DhconvContract.apply(x2, w2, weight_cache if weight_cache is not None else _PermutedWeight())
    if kernels.takes_plain("dhconv", x2, w2):
        return contract_dense_s_plain(x2, w2, separable, operator_type, channels_last)
    raise NotImplementedError(
        f"no kernel for the {'separable' if separable else 'dense'} {operator_type} contraction "
        f"({'channels-last' if channels_last else 'NCHW'}); only dense channels-last dhconv is ported"
    )
