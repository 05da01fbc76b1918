"""Instance normalization (counterpart of ``InstanceNorm2d`` in
``makani_tpu/models/common/layer_norm.py``, default two-pass path).

Per (sample, channel): fp32 mean and variance over the spatial dims, ignoring
latitude rows at or beyond ``nlat_phys`` when the grid is padded; normalize;
round to the input dtype; then the affine step in the input dtype.

Kernel K4 (Triton) replaces the JAX package's XLA reduction
(``layer_norm.py:78-122``; the same math as ``ops/norm.py`` ``_fwd_impl``).
It is bound by memory bandwidth: at 721x1440x384 bf16 the tensor is 797 MB
and the reduction has no arithmetic to speak of. The design reads x twice and
writes y once, the least a two-pass-exact norm can do without keeping x on
chip: (1) each program reduces a chunk of pixels for a tile of channels to
(count, mean, M2) with Chan's merge, so no E[x^2]-E[x]^2 cancellation; (2) one
program per channel tile merges the chunks into mean and sqrt(var + eps);
(3) one pass normalizes, rounds to the input dtype, and applies the affine
step with the input dtype's rounding after each operation, as the JAX path
does. The normalizing division, the square root and every rounding are
IEEE round-to-nearest-even (Triton's `/` and `tl.sqrt` are the approximate
forms), so the kernel matches the plain version to the last bit almost
everywhere. Channels-last tiles load 64 contiguous channels per pixel row.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from makani_torch import kernels
from makani_torch.device import resolve_device

__all__ = ["InstanceNorm2d", "instance_norm_cl", "instance_norm_cl_plain"]


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


@functools.cache
def _triton_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def stats_partial(x_ptr, part_ptr, HW, C, n_valid, chunk, num_chunks, BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        # (count, mean, M2) of pixels [k*chunk, min((k+1)*chunk, n_valid)) for one channel tile
        k = tl.program_id(0)
        ct = tl.program_id(1)
        b = tl.program_id(2)
        cols = ct * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        x_base = x_ptr + b.to(tl.int64) * HW * C
        p_start = k * chunk
        p_end = tl.minimum(p_start + chunk, n_valid)
        cnt = tl.zeros([BLOCK_C], dtype=tl.float32)
        mean = tl.zeros([BLOCK_C], dtype=tl.float32)
        m2 = tl.zeros([BLOCK_C], dtype=tl.float32)
        for p0 in range(p_start, p_end, BLOCK_P):
            rows = p0 + tl.arange(0, BLOCK_P)
            m = (rows < p_end)[:, None] & cmask[None, :]
            xt = tl.load(x_base + rows[:, None].to(tl.int64) * C + cols[None, :], mask=m, other=0.0).to(tl.float32)
            n_t = tl.sum(m.to(tl.float32), axis=0)
            mean_t = tl.sum(xt, axis=0) / tl.maximum(n_t, 1.0)
            d = tl.where(m, xt - mean_t[None, :], 0.0)
            m2_t = tl.sum(d * d, axis=0)
            n_new = cnt + n_t
            delta = mean_t - mean
            inv = 1.0 / tl.maximum(n_new, 1.0)
            mean = mean + delta * (n_t * inv)
            m2 = m2 + m2_t + delta * delta * (cnt * n_t * inv)
            cnt = n_new
        out = part_ptr + ((b * num_chunks + k) * 3) * C + cols
        tl.store(out, cnt, mask=cmask)
        tl.store(out + C, mean, mask=cmask)
        tl.store(out + 2 * C, m2, mask=cmask)

    @triton.jit
    def stats_finalize(part_ptr, stats_ptr, C, num_chunks, eps, BLOCK_C: tl.constexpr):
        # Chan-merge the chunk partials into mean and sqrt(var + eps)
        ct = tl.program_id(0)
        b = tl.program_id(1)
        cols = ct * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        cnt = tl.zeros([BLOCK_C], dtype=tl.float32)
        mean = tl.zeros([BLOCK_C], dtype=tl.float32)
        m2 = tl.zeros([BLOCK_C], dtype=tl.float32)
        for k in range(0, num_chunks):
            src = part_ptr + ((b * num_chunks + k) * 3) * C + cols
            n_k = tl.load(src, mask=cmask, other=0.0)
            mean_k = tl.load(src + C, mask=cmask, other=0.0)
            m2_k = tl.load(src + 2 * C, mask=cmask, other=0.0)
            n_new = cnt + n_k
            delta = mean_k - mean
            inv = 1.0 / tl.maximum(n_new, 1.0)
            mean = mean + delta * (n_k * inv)
            m2 = m2 + m2_k + delta * delta * (cnt * n_k * inv)
            cnt = n_new
        var = m2 / tl.maximum(cnt, 1.0)
        dst = stats_ptr + b * 2 * C + cols
        tl.store(dst, mean, mask=cmask)
        tl.store(dst + C, tl.sqrt_rn(var + eps), mask=cmask)

    @triton.jit
    def round_bf16(v):
        # fp32 -> the nearest bf16 value (ties to even), kept in fp32. Written
        # with integer ops: the compiler folds a .to(bf16).to(fp32) round trip
        # away, which drops the JAX path's intermediate rounding (measured: a
        # one-ulp difference at ~half the elements).
        u = v.to(tl.uint32, bitcast=True)
        u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
        return u.to(tl.float32, bitcast=True)

    @triton.jit
    def normalize(x_ptr, y_ptr, stats_ptr, w_ptr, b_ptr, HW, C, ROUND_BF16: tl.constexpr, BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        pt = tl.program_id(0)
        ct = tl.program_id(1)
        b = tl.program_id(2)
        cols = ct * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        rows = pt * BLOCK_P + tl.arange(0, BLOCK_P)
        m = (rows < HW)[:, None] & cmask[None, :]
        mean = tl.load(stats_ptr + b * 2 * C + cols, mask=cmask, other=0.0)
        std = tl.load(stats_ptr + b * 2 * C + C + cols, mask=cmask, other=1.0)
        w = tl.load(w_ptr + cols, mask=cmask, other=1.0).to(tl.float32)
        bb = tl.load(b_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        offs = b.to(tl.int64) * HW * C + rows[:, None].to(tl.int64) * C + cols[None, :]
        xt = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        y = tl.div_rn(xt - mean[None, :], std[None, :])
        if ROUND_BF16:
            # bf16 input: round to bf16 after the normalization and after each
            # affine operation, as the JAX path's dtype sequence does
            y = round_bf16(round_bf16(round_bf16(y) * w[None, :]) + bb[None, :]).to(tl.bfloat16)
        else:
            y = y * w[None, :] + bb[None, :]
        tl.store(y_ptr + offs, y, mask=m)

    return triton, stats_partial, stats_finalize, normalize


_BLOCK_P = 64
_BLOCK_C = 64
# target number of partial-statistics programs, so the reduction fills the
# card's 132 SMs several times over at every resolution
_TARGET_PROGRAMS = 1024


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
    triton, stats_partial, stats_finalize, normalize = _triton_kernels()
    x = x.contiguous()
    B, H, W, C = x.shape
    HW = H * W
    n_valid = (min(nlat_phys, H) if nlat_phys is not None else H) * W
    if weight is None:
        w = torch.ones(C, dtype=x.dtype, device=x.device)
        b = torch.zeros(C, dtype=x.dtype, device=x.device)
    else:
        w, b = weight.to(x.dtype).contiguous(), bias.to(x.dtype).contiguous()
    n_ct = triton.cdiv(C, _BLOCK_C)
    num_chunks = max(1, min(triton.cdiv(_TARGET_PROGRAMS, n_ct * B), triton.cdiv(n_valid, _BLOCK_P)))
    chunk = triton.cdiv(triton.cdiv(n_valid, num_chunks), _BLOCK_P) * _BLOCK_P
    num_chunks = triton.cdiv(n_valid, chunk)
    part = torch.empty(B, num_chunks, 3, C, dtype=torch.float32, device=x.device)
    stats = torch.empty(B, 2, C, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stats_partial[(num_chunks, n_ct, B)](x, part, HW, C, n_valid, chunk, num_chunks, BLOCK_P=_BLOCK_P, BLOCK_C=_BLOCK_C)
        stats_finalize[(n_ct, B)](part, stats, C, num_chunks, eps, BLOCK_C=_BLOCK_C)
        normalize[(triton.cdiv(HW, _BLOCK_P), n_ct, B)](
            x, y, stats, w, b, HW, C, ROUND_BF16=x.dtype == torch.bfloat16, BLOCK_P=_BLOCK_P, BLOCK_C=_BLOCK_C
        )
    kernels.count_launch("instance_norm")
    return y


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
