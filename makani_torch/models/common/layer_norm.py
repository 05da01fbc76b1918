"""Instance normalization (counterpart of ``InstanceNorm2d`` in
``makani_tpu/models/common/layer_norm.py``, default two-pass path).

Per (sample, channel): fp32 mean and variance over the spatial dims, ignoring
latitude rows at or beyond ``nlat_phys`` when the grid is padded; normalize;
round to the input dtype; then the affine step in the input dtype.

Kernel K4 (CUDA C++, ``csrc/instance_norm.cu``) replaces the JAX package's
XLA reduction (``layer_norm.py:78-122``; the same math as ``ops/norm.py``
``_fwd_impl``) in one cooperative launch: a persistent grid reduces each
channel group with Welford's update and Chan's merge (no E[x^2]-E[x]^2),
meets at a grid barrier, merges the blocks' partials, and normalizes,
reading each block's slice again, the last pixel read first (the likeliest
to be in L2 still). It is bound by memory bandwidth.
``plan_instance_norm`` is its launch shape, made on the host. The division,
the square root and every rounding are IEEE round-to-nearest-even, as in the
plain version.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn

from makani_torch import kernels
from makani_torch.device import resolve_device

__all__ = ["InstanceNorm2d", "instance_norm_cl", "instance_norm_cl_plain", "plan_instance_norm", "launch_instance_norm", "NormPlan"]


def instance_norm_cl_plain(
    x: torch.Tensor, weight: torch.Tensor | None, bias: torch.Tensor | None, nlat_phys: int | None = None, eps: float = 1e-6
) -> torch.Tensor:
    """Plain PyTorch instance norm on channels-last x (B, H, W, C)."""
    xs = x.float()
    sp = (-3, -2)
    H, W = x.shape[-3], x.shape[-2]
    if nlat_phys is not None and nlat_phys < H:
        mask = (torch.arange(H, device=x.device) < nlat_phys).float()[:, None, None]
        count = nlat_phys * W
        mean = torch.sum(xs * mask, dim=sp, keepdim=True) / count
        var = torch.sum(torch.square(xs - mean) * mask, dim=sp, keepdim=True) / count
    else:
        mean = torch.mean(xs, dim=sp, keepdim=True)
        var = torch.var(xs, dim=sp, keepdim=True, correction=0)
    y = ((xs - mean) / torch.sqrt(var + eps)).to(x.dtype)
    if weight is not None:
        y = y * weight.to(x.dtype) + bias.to(x.dtype)
    return y


# K4's launch: threads a block (at most; csrc/instance_norm.cu MAX_THREADS),
# one block an SM, and the card's SMs where not known
_THREADS = 512
_SMS = 132


@dataclasses.dataclass(frozen=True)
class NormPlan:
    """A K4 launch: ``vec`` channels a load (16 bytes, or 1), ``group``
    channels a group, ``ppi`` pixels a block takes at a time, ``threads``
    (ppi * group / vec) a block, ``blocks`` (the grid: one an SM, all
    resident at once) of ``chunk`` pixels each."""

    vec: int
    group: int
    ppi: int
    threads: int
    blocks: int
    chunk: int


def plan_instance_norm(HW: int, C: int, itemsize: int, aligned: bool = True, sms: int = _SMS, group: int | None = None) -> NormPlan:
    """K4's launch for HW pixels of C channels: 16-byte loads where C and the
    pointers allow, and the widest channel group whose block of whole warps
    holds at most 512 threads (all C where C / vec <= 512), or ``group``.
    Narrower groups were measured slower at every flagship shape (PERF.md):
    they read each pixel row in short strided pieces."""
    vec = 16 // itemsize if aligned and C % (16 // itemsize) == 0 else 1
    plans = []
    for d in range(1, min(C // vec, _THREADS) + 1):
        if (C // vec) % d == 0:
            ppi = next((p for p in range(_THREADS // d, 0, -1) if p * d % 32 == 0), None)
            if ppi is not None:
                plans.append(NormPlan(vec, d * vec, ppi, ppi * d, sms, -(-HW // sms)))
    if not plans:
        raise ValueError(f"instance_norm: no launch shape for {C} channels")
    if group is None:
        return plans[-1]
    hit = [q for q in plans if q.group == group]
    if not hit:
        raise ValueError(f"instance_norm: no launch shape with a group of {group} of {C} channels; groups {[q.group for q in plans]}")
    return hit[0]


@functools.cache
def _card(index: int) -> dict:
    return {"sms": torch.cuda.get_device_properties(index).multi_processor_count}


def launch_instance_norm(x, w, b, n_valid: int, eps: float, plan: NormPlan) -> torch.Tensor:
    """Launch K4 with a given plan: x (B, H, W, C) contiguous, w and b (C,)
    in x's dtype, all on one CUDA device."""
    B, H, W, C = x.shape
    y = torch.empty_like(x)
    part = torch.empty(plan.blocks, 3, plan.group, dtype=torch.float32, device=x.device)
    stats = torch.empty(2, plan.group, dtype=torch.float32, device=x.device)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        err = lib.mt_instance_norm(
            kernels.dtype_code(x.dtype), plan.vec, x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), part.data_ptr(), stats.data_ptr(),
            B, H * W, C, n_valid, plan.group, plan.ppi, plan.chunk, plan.blocks, eps, kernels.stream_ptr(x.device),
        )
    kernels.check_launch(err, "instance_norm")
    kernels.count_launch("instance_norm")
    return y


def instance_norm_cl(
    x: torch.Tensor, weight: torch.Tensor | None, bias: torch.Tensor | None, nlat_phys: int | None = None, eps: float = 1e-6
) -> torch.Tensor:
    """Instance norm on channels-last x (B, H, W, C): kernel K4 on the card,
    ``instance_norm_cl_plain`` on the CPU."""
    params = () if weight is None else (weight, bias)
    if kernels.takes_plain("instance_norm", x, *params):
        return instance_norm_cl_plain(x, weight, bias, nlat_phys, eps)
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise TypeError(f"instance_norm: expected float32/bfloat16 (B, H, W, C), got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    B, H, W, C = x.shape
    n_valid = (min(nlat_phys, H) if nlat_phys is not None else H) * W
    if weight is None:
        w = torch.ones(C, dtype=x.dtype, device=x.device)
        b = torch.zeros(C, dtype=x.dtype, device=x.device)
    else:
        w, b = weight.to(x.dtype).contiguous(), bias.to(x.dtype).contiguous()
    plan = plan_instance_norm(H * W, C, x.element_size(), aligned=x.data_ptr() % 16 == 0, **_card(x.device.index or 0))
    return launch_instance_norm(x, w, b, n_valid, eps, plan)


class InstanceNorm2d(nn.Module):
    """Per-sample, per-channel normalization over the spatial dims.

    Matches ``makani_tpu`` ``InstanceNorm2d`` (NCHW, or (B, H, W, C) with
    ``channels_last``). With ``nlat_phys`` set, statistics ignore padded
    latitude rows beyond it. Parameters ``weight`` and ``bias`` are fp32,
    shape (num_features,), as in the flax tree.
    """

    def __init__(self, num_features: int, eps: float = 1e-6, affine: bool = True, nlat_phys: int | None = None, channels_last: bool = False, device=None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.affine = affine
        self.nlat_phys = nlat_phys
        self.channels_last = channels_last
        self.use_kernels = True
        device = resolve_device(device)
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features, device=device))
            self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def reset_parameters(self, generator: torch.Generator | None = None):
        if self.affine:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xcl = x if self.channels_last else x.movedim(1, -1)
        norm = instance_norm_cl if self.use_kernels else instance_norm_cl_plain
        y = norm(xcl, self.weight, self.bias, self.nlat_phys, self.eps)
        return y if self.channels_last else y.movedim(-1, 1)
