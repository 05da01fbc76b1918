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
plain version. K4 also writes each (sample, channel)'s mean and
sqrt(var + eps) (B·C·2 floats), which the backward keeps.

The backward is kernel K10 (same source, ``launch_instance_norm_grad``):
the closed form of ``makani_tpu/ops/norm.py`` ``_bwd`` in one cooperative
launch, ``instance_norm_grad_plain`` its plain version. Its launch shape,
``plan_instance_norm_grad``, takes K4's threads and adds how many samples a
round the grid takes (all of them: two grid barriers a launch). Both
sit in a ``torch.autograd.Function`` (``instance_norm_cl``) that takes the
kernels for a CUDA tensor and the plain versions for a CPU one.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn

from makani_torch import kernels
from makani_torch.device import resolve_device

__all__ = [
    "InstanceNorm2d",
    "instance_norm_cl",
    "instance_norm_cl_plain",
    "instance_norm_grad_plain",
    "plan_instance_norm",
    "launch_instance_norm",
    "launch_instance_norm_grad",
    "NormPlan",
    "GradPlan",
    "plan_instance_norm_grad",
    "LayerNorm",
    "ChannelLayerNorm",
]


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in the statistics' type: fp32 (float64 for float64 input)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _norm_stats_plain(x: torch.Tensor, nlat_phys: int | None, eps: float):
    """fp32 per-(b, c) mean and sqrt(var + eps) of channels-last x (B, H, W,
    C) over the valid latitude rows, each (B, 1, 1, C)."""
    xs = _acc(x)
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
    return mean, torch.sqrt(var + eps)


def _normalize_affine(x, mean, sd, weight, bias):
    y = ((_acc(x) - mean) / sd).to(x.dtype)
    if weight is not None:
        y = y * weight.to(x.dtype) + bias.to(x.dtype)
    return y


def instance_norm_cl_plain(
    x: torch.Tensor, weight: torch.Tensor | None, bias: torch.Tensor | None, nlat_phys: int | None = None, eps: float = 1e-6
) -> torch.Tensor:
    """Plain PyTorch instance norm on channels-last x (B, H, W, C)."""
    mean, sd = _norm_stats_plain(x, nlat_phys, eps)
    return _normalize_affine(x, mean, sd, weight, bias)


def instance_norm_grad_plain(g, x, weight, mean, sd, n_valid: int):
    """The closed-form instance-norm backward in plain PyTorch, K10's plain
    version; the gradient of the default two-pass ``InstanceNorm2d`` path.

    g, x (B, H, W, C) in x's dtype, ``weight`` (C,) or None, mean and sd
    (B, 1, 1, C) fp32 (sd = sqrt(var + eps)); statistics over the first
    ``n_valid`` pixels of each sample. With z = (x - mean) / sd and the
    affine step's gradient dz = g * w (for bf16 rounded to bf16, as the
    bf16 product is):

        dx = (dz - S1 / n - z * S2 / n) / sd    on the valid rows,
        dx = dz / sd                            on the padded rows,
        S1 = sum dz,  S2 = sum dz * z           over all pixels of (b, c),
        dw = sum_{b,h,w} g * zr,  db = sum_{b,h,w} g,

    zr being z rounded to x's dtype; for bf16, g * zr is rounded to bf16 and
    dw and db once more after the fp32 sum, as the bf16 autograd gives them.
    Returns dx in x's dtype and (dw, db) fp32, or (dx, None, None) without
    a weight."""
    z = (_acc(x) - mean) / sd
    if weight is None:
        dz = _acc(g)
    else:
        dz = _acc(g * weight.to(x.dtype))
    s1 = dz.sum(dim=(1, 2), keepdim=True)
    s2 = (dz * z).sum(dim=(1, 2), keepdim=True)
    W = x.shape[2]
    rows = (torch.arange(x.shape[1], device=x.device) * W < n_valid)[:, None, None]
    a = torch.where(rows, s1 / n_valid, 0.0)
    c = torch.where(rows, s2 / n_valid, 0.0)
    dx = ((dz - a - z * c) / sd).to(x.dtype)
    if weight is None:
        return dx, None, None
    zr = z.to(x.dtype)
    dw = _acc(_acc(g * zr).sum(dim=(0, 1, 2)).to(x.dtype))
    db = _acc(_acc(g).sum(dim=(0, 1, 2)).to(x.dtype))
    return dx, dw, db


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


@dataclasses.dataclass(frozen=True)
class GradPlan(NormPlan):
    """A K10 launch: K4's threads (``vec``, ``group``, ``ppi``, ``threads``)
    and ``samples`` a round, each on ``blocks / samples`` blocks of
    ``chunk`` pixels."""

    samples: int


def plan_instance_norm_grad(B: int, HW: int, C: int, itemsize: int, aligned: bool = True, sms: int = _SMS) -> GradPlan:
    """K10's launch for B samples of HW pixels of C channels: K4's threads
    a block and all B samples a round (at most one a block: two grid
    barriers a launch), the grid split evenly between them. A plan for one
    sample, launched on B, walks the samples one a round, which was slower
    at both of the SFNO training step's grids (PERF.md)."""
    base = plan_instance_norm(HW, C, itemsize, aligned=aligned, sms=sms)
    if B < 1:
        raise ValueError(f"instance_norm_grad: {B} samples")
    S = min(B, sms)
    bps = sms // S
    return GradPlan(base.vec, base.group, base.ppi, base.threads, S * bps, -(-HW // bps), S)


@functools.cache
def _card(index: int) -> dict:
    return {"sms": torch.cuda.get_device_properties(index).multi_processor_count}


def launch_instance_norm(x, w, b, n_valid: int, eps: float, plan: NormPlan):
    """Launch K4 with a given plan: x (B, H, W, C) contiguous, w and b (C,)
    in x's dtype, all on one CUDA device. Returns y and the per-(b, c)
    statistics (B, 1, 1, C) fp32 mean and sqrt(var + eps), which K4 keeps
    for the backward."""
    B, H, W, C = x.shape
    y = torch.empty_like(x)
    part = torch.empty(plan.blocks, 3, plan.group, dtype=torch.float32, device=x.device)
    stats = torch.empty(B, C // plan.group, 2, plan.group, dtype=torch.float32, device=x.device)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        err = lib.mt_instance_norm(
            kernels.dtype_code(x.dtype), plan.vec, x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), part.data_ptr(), stats.data_ptr(),
            B, H * W, C, n_valid, plan.group, plan.ppi, plan.chunk, plan.blocks, eps, kernels.stream_ptr(x.device),
        )
    kernels.check_launch(err, "instance_norm")
    kernels.count_launch("instance_norm")
    stats = stats.transpose(1, 2).reshape(B, 2, 1, 1, C)
    return y, stats[:, 0], stats[:, 1]


def launch_instance_norm_grad(g, x, w, mean, sd, n_valid: int, plan: GradPlan):
    """Launch K10 with a given plan (``plan_instance_norm_grad``): g and x
    (B, H, W, C) contiguous in one dtype, w (C,) in that dtype, mean and sd
    (B, 1, 1, C) fp32 from K4. Returns dx in x's dtype and dw, db (C,)
    fp32."""
    B, H, W, C = x.shape
    dx = torch.empty_like(x)
    part = torch.empty(plan.blocks, 4, plan.group, dtype=torch.float32, device=x.device)
    sums = torch.empty(B, 4, C, dtype=torch.float32, device=x.device)
    dwdb = torch.empty(2, C, dtype=torch.float32, device=x.device)
    stats = torch.stack([mean.reshape(B, C), sd.reshape(B, C)], dim=1).contiguous()
    lib = kernels.library()
    with torch.cuda.device(x.device):
        err = lib.mt_instance_norm_grad(
            kernels.dtype_code(x.dtype), plan.vec, g.data_ptr(), x.data_ptr(), w.data_ptr(), stats.data_ptr(), dx.data_ptr(), dwdb.data_ptr(),
            part.data_ptr(), sums.data_ptr(), B, H * W, C, n_valid, plan.group, plan.ppi, plan.samples, plan.chunk, plan.blocks,
            kernels.stream_ptr(x.device),
        )
    kernels.check_launch(err, "instance_norm_grad")
    kernels.count_launch("instance_norm_grad")
    return dx, dwdb[0], dwdb[1]


def _affine(x, weight, bias):
    C = x.shape[-1]
    if weight is None:
        return torch.ones(C, dtype=x.dtype, device=x.device), torch.zeros(C, dtype=x.dtype, device=x.device)
    return weight.to(x.dtype).contiguous(), bias.to(x.dtype).contiguous()


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _plan(x):
    """K4's launch for x; 16-byte loads only where x is 16-byte aligned."""
    B, H, W, C = x.shape
    return plan_instance_norm(H * W, C, x.element_size(), aligned=_aligned(x), **_card(x.device.index or 0))


def _grad_plan(x, g):
    """K10's launch for x and g (16-byte loads where both are 16-byte
    aligned; dx is a new tensor)."""
    B, H, W, C = x.shape
    return plan_instance_norm_grad(B, H * W, C, x.element_size(), aligned=_aligned(x, g), **_card(x.device.index or 0))


class _InstanceNorm(torch.autograd.Function):
    """Instance norm with its closed-form backward: K4 forward (keeping the
    per-(b, c) statistics) and K10 backward on the card, the plain versions
    of both on the CPU."""

    @staticmethod
    def forward(ctx, x, weight, bias, nlat_phys, eps):
        params = () if weight is None else (weight, bias)
        B, H, W, C = x.shape
        n_valid = (min(nlat_phys, H) if nlat_phys is not None else H) * W
        ctx.n_valid = n_valid
        if kernels.takes_plain("instance_norm", x, *params):
            mean, sd = _norm_stats_plain(x, nlat_phys, eps)
            y = _normalize_affine(x, mean, sd, weight, bias)
        else:
            if x.dtype not in (torch.float32, torch.bfloat16):
                raise TypeError(f"instance_norm: expected float32/bfloat16 (B, H, W, C), got {x.dtype} {tuple(x.shape)}")
            x = x.contiguous()
            w, b = _affine(x, weight, bias)
            y, mean, sd = launch_instance_norm(x, w, b, n_valid, eps, _plan(x))
        ctx.save_for_backward(x, weight, mean, sd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, sd = ctx.saved_tensors
        if kernels.takes_plain("instance_norm_grad", g, x):
            dx, dw, db = instance_norm_grad_plain(g, x, weight, mean, sd, ctx.n_valid)
        else:
            g = g.to(x.dtype).contiguous()
            w, _ = _affine(x, weight, weight)
            dx, dw, db = launch_instance_norm_grad(g, x, w, mean, sd, ctx.n_valid, _grad_plan(x, g))
        if weight is None:
            dw = db = None
        return (dx if ctx.needs_input_grad[0] else None), dw, db, None, None


def instance_norm_cl(
    x: torch.Tensor, weight: torch.Tensor | None, bias: torch.Tensor | None, nlat_phys: int | None = None, eps: float = 1e-6
) -> torch.Tensor:
    """Instance norm on channels-last x (B, H, W, C): kernel K4 on the card,
    ``instance_norm_cl_plain`` on the CPU; differentiable, with K10 (on the
    CPU ``instance_norm_grad_plain``) as its backward."""
    if x.dim() != 4:
        raise TypeError(f"instance_norm: expected (B, H, W, C), got {tuple(x.shape)}")
    return _InstanceNorm.apply(x, weight, bias, nlat_phys, eps)


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


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last axis, as the token models use it
    (``epsilon`` 1e-6): fp32 statistics by the fast variance (E[x^2] - E[x]^2,
    clipped at 0), ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in fp32,
    one rounding to the compute dtype. Parameters ``scale`` and ``bias``
    (num_features,) fp32, as in the flax tree. The JAX package leaves it to
    XLA, so it is plain PyTorch here."""

    def __init__(self, num_features: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        device = resolve_device(device)
        self.scale = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))

    def reset_parameters(self, generator: torch.Generator | None = None):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = _acc(x)
        mean = xs.mean(dim=-1, keepdim=True)
        var = torch.clamp(torch.square(xs).mean(dim=-1, keepdim=True) - torch.square(mean), min=0.0)
        y = (xs - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(self.dtype)


class ChannelLayerNorm(nn.Module):
    """Layer norm over the channel axis (counterpart of ``ChannelLayerNorm``
    in ``makani_tpu/models/common/layer_norm.py``): NCHW, or (B, H, W, C)
    with ``channels_last``. fp32 statistics (two-pass variance), the
    normalized value rounded to the input dtype, then the affine step in the
    input dtype. Parameters ``weight`` and ``bias`` (num_features,) fp32.
    Plain PyTorch, as the JAX package leaves it to XLA."""

    def __init__(self, num_features: int, eps: float = 1e-6, affine: bool = True, channels_last: bool = False, device=None):
        super().__init__()
        self.eps = eps
        self.affine = affine
        self.channels_last = channels_last
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
        ax = -1 if self.channels_last else 1
        xs = _acc(x)
        mean = xs.mean(dim=ax, keepdim=True)
        var = torch.var(xs, dim=ax, keepdim=True, correction=0)
        y = ((xs - mean) / torch.sqrt(var + self.eps)).to(x.dtype)
        if self.affine:
            shape = (-1,) if self.channels_last else (-1, 1, 1)
            y = y * self.weight.to(x.dtype).reshape(shape) + self.bias.to(x.dtype).reshape(shape)
        return y
