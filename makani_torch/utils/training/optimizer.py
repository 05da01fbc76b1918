"""The recipes' optimizers: Adam, plain (``Adam``) or with a factored second
moment (``AdamFactored``), in the chain that ``get_optimizer`` builds
(counterpart of ``get_optimizer``, ``get_schedule``,
``scale_by_adam_factored``, ``apply_freeze_flags`` and ``_no_decay_mask``
in ``makani_tpu/utils/training/optimizer.py``, and of the optax
transformations it chains: ``MultiSteps(multi_transform(chain(
clip_by_global_norm, adam, add_decayed_weights, scale_by_learning_rate)))``).

A step of either optimizer, in the reference's order:
 1. gradient accumulation (``accumulation_steps`` k > 1, ``optax.MultiSteps``):
    each call folds the gradients into their running mean, acc + (g - acc) /
    (n + 1), and every k-th call applies the mean and zeroes it; the others
    leave the parameters and the count untouched (plain PyTorch ops);
 2. global-norm clipping (``max_grad_norm``, ``optax.clip_by_global_norm``):
    g is kept where sqrt(sum over the trainable leaves of sum g^2) <
    max_norm, else replaced by (g / norm) * max_norm, chosen on the device
    (kernel K16, ``csrc/grad_norm.cu``: two launches for up to 128 leaves);
 3. the update at the learning rate ``schedule(count - 1)``, evaluated in
    fp32 on the host at the optimizer's own count before its increment (as
    ``scale_by_schedule``), with the weight decay ``u += wd * p`` of a
    group's ``weight_decay`` between the Adam scaling and the learning rate.
A group with ``frozen=True`` (``multi_transform`` with ``set_to_zero``) gets
no update and no state, and its gradients count in no norm; gradients still
flow through its parameters. One count serves every trainable group, as the
reference's one count for the tree, kept equal in every parameter's
``count``; every trainable parameter is updated, a missing ``grad`` taken as
zeros. Nothing of a step is read back from the device.

``Adam`` is ``optax.scale_by_adam`` (K17, ``csrc/adam.cu``: one launch for up
to 64 leaves): mu' = (1 - b1) g + b1 mu in fp32 and nu' = b2 nu + (1 - b2)
g^2; u = mu' / (c1 (sqrt(nu' / c2) + eps)), mu_hat taken from the fp32 mu'
before it is cast to ``mu_dtype``; with a bfloat16 mu, b1 multiplies mu as a
bfloat16 number, as the JAX package's weakly typed b1 does.

``AdamFactored`` is ``scale_by_adam_factored``: for a leaf of at least two
axes whose second-largest is at least ``min_dim_size_to_factor`` long, the
second moment is kept as two EMAs of mean(g^2), one over each of its two
largest axes (d0, d1) (Adafactor), and rebuilt as the rank-1 ``vhat =
(v_row / mean_d0(v_row)) (x) v_col``; other leaves keep Adam's full nu. mu is
Adam's first moment, in fp32 or bf16, rounded to its dtype before mu_hat.
The update is ``mu_hat / (sqrt(nu_hat) + eps)``.

Both compute the bias corrections ``1 - b^count`` in fp32. The multiply-adds
are fused multiply-adds, one rounding each, as XLA compiles the JAX step (on
the CPU its results are bit-equal to those FMAs; the bracketed products are
rounded first): ``b1 * mu + [(1 - b1) * g]``, ``b2 * v + [(1 - b2) * g^2]``
(and its factored forms) in the factored Adam, ``(1 - b1) * g + [b1 * mu]``
and ``b2 * v + [(1 - b2) * [g * g]]`` in the plain one, and in both ``u +
wd * p`` and ``p + u * (-lr)``. Every other operation rounds once. The
update is in place on parameters and state.

The factored step is kernel K11 (``csrc/adam_factored.cu``) on the card:
three launches for all factored leaves (up to 40 a launch: one read of g for
both reductions of g^2 into tile partials; the partials summed with the
EMAs and the row mean of the new v_row; the elementwise update), and one
launch for all unfactored leaves (up to 64 a launch); they count as
``adam_factored``. On the CPU every kernel's plain version runs, written as
the optax ``update_fn`` is; ``use_kernels = False`` runs the plain versions
on any device: the reference path a comparison on the card runs.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable

import numpy as np
import torch

from makani_torch import kernels

__all__ = [
    "Adam",
    "AdamFactored",
    "get_optimizer",
    "get_schedule",
    "clip_by_global_norm",
    "global_norm_plain",
    "adam_update_plain",
    "adam_factored_update_plain",
    "decay_mask",
    "freeze_labels",
    "factored_layout",
    "factored_tables",
]

# leaves a launch: K11's unfactored and factored (csrc/adam_factored.cu
# MAX_LEAVES, MAX_FLEAVES), K16's (csrc/grad_norm.cu) and K17's
# (csrc/adam.cu); each launch's leaf table is a kernel argument
_MAX_LEAVES = 64
_MAX_FACTORED = 40
_MAX_NORM_LEAVES = 128
_MAX_ADAM_LEAVES = 64


def _f32(x) -> float:
    """x rounded to fp32, as a Python float."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# learning-rate schedules (optax's, evaluated in fp32 on the host)


def _constant(lr):
    value = _f32(lr)
    return lambda count: value


def _cosine(lr, decay_steps, alpha):
    """``optax.cosine_decay_schedule(lr, decay_steps, alpha)``; the angle
    pi count / decay_steps as count (pi / decay_steps), the product XLA
    folds it into."""
    lr32, a, oma = np.float32(lr), np.float32(alpha), np.float32(1.0 - alpha)
    step = np.float32(np.float32(np.pi) / np.float32(decay_steps))

    def schedule(count):
        c = np.float32(min(float(count), float(decay_steps)))
        cosine = np.float32(0.5) * (np.float32(1.0) + np.cos(c * step))
        return float(lr32 * (oma * cosine + a))

    return schedule


def _staircase(lr, transition_steps, rate):
    """``optax.exponential_decay(lr, transition_steps, rate, staircase=True)``."""
    if transition_steps <= 0 or rate == 0:
        return _constant(lr)
    lr32, r = np.float32(lr), np.float32(rate)

    def schedule(count):
        if count <= 0:
            return float(lr32)
        return float(lr32 * np.power(r, np.floor(np.float32(count) / np.float32(transition_steps))))

    return schedule


def _linear(start, end, steps):
    """``optax.linear_schedule(start, end, steps)``."""
    span, end32, inv = np.float32(start - end), np.float32(end), np.float32(np.float32(1.0) / np.float32(steps))

    def schedule(count):
        frac = np.float32(1.0) - np.float32(min(max(count, 0), steps)) * inv
        return float(span * frac + end32)

    return schedule


def get_schedule(params, steps_per_epoch: int = 1) -> Callable[[int], float]:
    """The learning rate as a function of the step count (0 for the first
    step), as ``get_schedule`` builds it: ``CosineAnnealingLR`` (a cosine
    decay over ``scheduler_T_max`` epochs to ``scheduler_min_lr``),
    ``StepLR`` (a staircase decay by ``scheduler_gamma`` every
    ``scheduler_step_size`` epochs), a constant for ``none`` and
    ``ReduceLROnPlateau`` (whose plateau part is the trainer's), and
    ``lr_warmup_steps`` of a linear ramp from 0 in front. fp32 values as
    Python floats."""
    lr = params.get("lr", 1e-3)
    sched_type = params.get("scheduler", "none")
    warmup = params.get("lr_warmup_steps", 0) or 0
    if sched_type == "CosineAnnealingLR":
        t_max = params.get("scheduler_T_max", 100) * steps_per_epoch
        main = _cosine(lr, max(t_max, 1), params.get("scheduler_min_lr", 0.0) / lr if lr else 0.0)
    elif sched_type == "StepLR":
        main = _staircase(lr, params.get("scheduler_step_size", 20) * steps_per_epoch, params.get("scheduler_gamma", 0.5))
    elif sched_type in ("ReduceLROnPlateau", "none", None):
        main = _constant(lr)
    else:
        raise ValueError(f"scheduler {sched_type} not supported")
    if warmup <= 0:
        return main
    ramp = _linear(0.0, lr, warmup)
    return lambda count: ramp(count) if count < warmup else main(count - warmup)


# ---------------------------------------------------------------------------
# K16: the global norm and the clip


def global_norm_plain(grads) -> torch.Tensor:
    """sqrt of the sum over the leaves (in order) of each leaf's sum of g^2,
    fp32, as ``optax.global_norm``."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_plain(grads, norm: torch.Tensor, max_norm: float):
    """K16's clip, plain: g kept where norm < max_norm, else (g / norm) *
    max_norm; in place, the choice made on the tensors' device."""
    keep, m = norm < _f32(max_norm), _f32(max_norm)
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * m))


def _check_grad(g):
    if g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"grad_norm: expects contiguous float32 gradients, got {g.dtype} {tuple(g.shape)} (contiguous: {g.is_contiguous()})")


def _grad_norm_launch(grads, max_norm: float) -> torch.Tensor:
    """K16 on the card: the sums of squares of every chunk of 128 leaves into
    block partials, the last launch's last block adding them all and writing
    the norm and the keep flag, then the clip over every chunk; in place.
    Returns the norm (0-d, on the device)."""
    lib = kernels.library()
    dev = grads[0].device
    chunks, blocks = [], []
    for k in range(0, len(grads), _MAX_NORM_LEAVES):
        chunk = [g for g in grads[k : k + _MAX_NORM_LEAVES] if g.numel()]
        if not chunk:
            continue
        table = (ctypes.c_longlong * (2 * len(chunk)))()
        for j, g in enumerate(chunk):
            _check_grad(g)
            table[2 * j : 2 * j + 2] = [g.data_ptr(), g.numel()]
        chunks.append((table, len(chunk)))
        blocks.append(sum(lib.mt_grad_norm_blocks(g.numel()) for g in chunk))
    total = sum(blocks)
    # the partials, then the norm, then the counter and the keep flag (zero)
    buf = torch.zeros(total + 3, dtype=torch.float32, device=dev)
    base = buf.data_ptr()
    out, state = base + 4 * total, base + 4 * (total + 1)
    with torch.cuda.device(dev):
        stream = kernels.stream_ptr(dev)
        for kind in (0, 1):
            offset = 0
            for j, ((table, n), nb) in enumerate(zip(chunks, blocks)):
                err = lib.mt_grad_norm(kind, table, n, base, offset, total, int(j == len(chunks) - 1), state, out, max_norm, stream)
                kernels.check_launch(err, "grad_norm")
                kernels.count_launch("grad_norm")
                offset += nb
    torch.autograd.graph.increment_version(grads)
    return buf[total]


def clip_by_global_norm(grads, max_norm: float, use_kernels: bool = True) -> torch.Tensor:
    """``optax.clip_by_global_norm(max_norm)`` on the gradient leaves, in
    place: K16 on the card, its plain version on the CPU (or with
    ``use_kernels`` False). Returns the global norm before the clip, a 0-d
    fp32 tensor on the gradients' device."""
    if not use_kernels or kernels.takes_plain("grad_norm", *grads):
        norm = global_norm_plain(grads)
        clip_plain(grads, norm, max_norm)
        return norm
    return _grad_norm_launch(grads, max_norm)


# ---------------------------------------------------------------------------
# K17: plain Adam


def _fma(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in fp32 with one rounding (the product and the sum exact in
    float64, then rounded); a an fp32 number or tensor."""
    a = a.double() if isinstance(a, torch.Tensor) else _f32(a)
    return (a * b.double() + c.double()).float()


def _b1_for(b1: float, mu_dtype: torch.dtype) -> float:
    """The factor that multiplies mu in the plain Adam: b1, rounded to
    bfloat16 with a bfloat16 mu (the JAX package's weakly typed b1 takes
    mu's dtype), as an fp32 number."""
    if mu_dtype == torch.bfloat16:
        return float(torch.tensor(b1, dtype=torch.bfloat16))
    return _f32(b1)


def adam_update_plain(p, g, mu, v, c1, c2, b1, b2, eps, lr, wd=0.0):
    """K17's plain version: one leaf's update, written as ``scale_by_adam``'s
    ``update_fn``, then ``add_decayed_weights`` (wd), ``scale_by_learning_rate``
    and ``apply_updates``, in place on p, mu and v. c1, c2: the fp32 bias
    corrections."""
    g32 = g.float()
    m = _fma(1.0 - b1, g32, _b1_for(b1, mu.dtype) * mu.float())
    new_v = _fma(b2, v, _f32(1.0 - b2) * (g32 * g32))
    u = m / (_f32(c1) * (torch.sqrt(new_v / _f32(c2)) + _f32(eps)))
    if wd:
        u = _fma(wd, p, u)
    p.copy_(_fma(-lr, u, p))
    mu.copy_(m.to(mu.dtype))
    v.copy_(new_v)


def _check_leaf(name, p, g, mu):
    if p.dtype != torch.float32 or g.dtype != torch.float32 or mu.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: expects float32 parameters and gradients and a float32/bfloat16 mu, got {p.dtype}, {g.dtype}, {mu.dtype}")
    if not (p.is_contiguous() and g.is_contiguous() and mu.is_contiguous()) or g.shape != p.shape or mu.shape != p.shape:
        raise ValueError(f"{name}: parameter, gradient and mu must be contiguous and of one shape, got {tuple(p.shape)}, {tuple(g.shape)}, {tuple(mu.shape)}")


def adam_update(leaves, mu_dtype, c1, c2, b1, b2, eps, lr):
    """K17 on the card, each leaf (p, g, mu, v, wd): one launch for every 64
    leaves, in place. All leaves share the bias corrections (one count)."""
    if not leaves:
        return
    lib = kernels.library()
    dev = leaves[0][0].device
    b1m = _b1_for(b1, mu_dtype)
    for k in range(0, len(leaves), _MAX_ADAM_LEAVES):
        chunk = leaves[k : k + _MAX_ADAM_LEAVES]
        table = (ctypes.c_longlong * (5 * len(chunk)))()
        decay = (ctypes.c_float * len(chunk))()
        for j, (p, g, mu, v, wd) in enumerate(chunk):
            _check_leaf("adam", p, g, mu)
            if mu.dtype != mu_dtype or not v.is_contiguous() or v.shape != p.shape or v.dtype != torch.float32:
                raise ValueError(f"adam: leaf {tuple(p.shape)} has mu {mu.dtype} (expected {mu_dtype}) or second moment {tuple(v.shape)} {v.dtype}")
            table[5 * j : 5 * j + 5] = [p.data_ptr(), g.data_ptr(), mu.data_ptr(), v.data_ptr(), p.numel()]
            decay[j] = wd
        with torch.cuda.device(dev):
            err = lib.mt_adam(kernels.dtype_code(mu_dtype), table, decay, len(chunk), b1m, 1.0 - b1, b2, 1.0 - b2, c1, c2, eps, -lr, kernels.stream_ptr(dev))
        kernels.check_launch(err, "adam")
        kernels.count_launch("adam")
        # written through raw pointers: mark the tensors changed, as an
        # in-place op would (K3 caches its permuted weight per version)
        torch.autograd.graph.increment_version([t for leaf in chunk for t in leaf[:4] if t is not leaf[1]])


# ---------------------------------------------------------------------------
# K11: Adam with a factored second moment


def _factored_dims(shape, min_dim_size_to_factor: int):
    """Two largest axes to factor the second moment over, or None."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def factored_layout(shape, dims):
    """A factored leaf as K11 sees it: (P, R, Mi, S, Q), the axes before, at,
    between, at and after the two factored axes (R the first of them, S the
    second), and whether v_row is the EMA over S (d0 < d1: v_row keeps R) or
    over R."""
    a, b = sorted(dims)
    P, Mi, Q = math.prod(shape[:a]), math.prod(shape[a + 1 : b]), math.prod(shape[b + 1 :])
    return P, shape[a], Mi, shape[b], Q, dims[0] < dims[1]


def adam_factored_update_plain(p, g, mu, v_row, v_col, v, dims, c1, c2, b1, b2, eps, lr, wd=0.0):
    """K11's plain version: one leaf's update, written as ``update_fn`` then
    ``add_decayed_weights`` (wd), ``scale_by_learning_rate`` and
    ``apply_updates``, in place on p, mu and the second-moment state (v for
    an unfactored leaf, v_row and v_col for a factored one). c1, c2: the
    fp32 bias corrections."""
    g32 = g.float()
    new_mu = _fma(b1, mu.float(), (1.0 - b1) * g32).to(mu.dtype)
    g2 = g32 * g32
    if dims is None:
        new_v = _fma(b2, v, (1.0 - b2) * g2)
        vhat = new_v / c2
        v.copy_(new_v)
    else:
        d0, d1 = dims
        new_vr = _fma(b2, v_row, (1.0 - b2) * torch.mean(g2, dim=d1))
        new_vc = _fma(b2, v_col, (1.0 - b2) * torch.mean(g2, dim=d0))
        # axis d0 of v_row, which lost d1
        d0r = d0 - 1 if d1 < d0 else d0
        row_mean = torch.mean(new_vr, dim=d0r, keepdim=True)
        vr_n = new_vr / torch.clamp_min(row_mean, 1e-30)
        vhat = vr_n.unsqueeze(d1) * new_vc.unsqueeze(d0) / c2
        v_row.copy_(new_vr)
        v_col.copy_(new_vc)
    mu_hat = new_mu.float() / c1
    u = (mu_hat / (torch.sqrt(vhat) + eps)).to(g.dtype)
    if wd:
        u = _fma(wd, p, u)
    mu.copy_(new_mu)
    p.copy_(_fma(-lr, u, p))


def factored_tables(leaves, mu_dtype):
    """K11's launch tables for factored leaves (p, g, mu, v_row, v_col, dims,
    c1, c2, wd), one for every 40: (table, corrections, leaf count,
    scratch), the table's rows (p, g, mu, vA, vB, scratch, P, R, Mi, S, Q,
    row_keeps_r) as 64-bit integers, the corrections (c1, c2, wd) a leaf,
    and one scratch buffer for the chunk's partial sums and row means (each
    leaf's part 16-byte aligned: the sizes are multiples of 4 floats)."""
    lib = kernels.library()
    out = []
    for k in range(0, len(leaves), _MAX_FACTORED):
        chunk = leaves[k : k + _MAX_FACTORED]
        table = (ctypes.c_longlong * (12 * len(chunk)))()
        corrections = (ctypes.c_float * (3 * len(chunk)))()
        sizes, rows = [], []
        for p, g, mu, v_row, v_col, dims, *_ in chunk:
            _check_leaf("adam_factored", p, g, mu)
            if mu.dtype != mu_dtype:
                raise ValueError(f"adam_factored: leaf {tuple(p.shape)} has mu {mu.dtype}, expected {mu_dtype}")
            P, R, Mi, S, Q, row_keeps_r = factored_layout(tuple(p.shape), dims)
            vA, vB = (v_row, v_col) if row_keeps_r else (v_col, v_row)
            if not (vA.is_contiguous() and vB.is_contiguous()) or vA.numel() != P * R * Mi * Q or vB.numel() != P * Mi * S * Q:
                raise ValueError(f"adam_factored: second-moment state {tuple(v_row.shape)}, {tuple(v_col.shape)} does not match {tuple(p.shape)}")
            sizes.append(lib.mt_adam_factored_scratch(P, R, Mi, S, Q))
            rows.append([p.data_ptr(), g.data_ptr(), mu.data_ptr(), vA.data_ptr(), vB.data_ptr(), 0, P, R, Mi, S, Q, int(row_keeps_r)])
        scratch = torch.empty(sum(sizes), dtype=torch.float32, device=chunk[0][0].device)
        offset = 0
        for j, (row, n) in enumerate(zip(rows, sizes)):
            row[5] = scratch.data_ptr() + 4 * offset
            offset += n
            table[12 * j : 12 * j + 12] = row
            corrections[3 * j : 3 * j + 3] = chunk[j][6:9]
        out.append((table, corrections, len(chunk), scratch))
    return out


def adam_factored_update(leaves, mu_dtype, b1, b2, eps, lr):
    """K11 on factored leaves on the card, each leaf (p, g, mu, v_row, v_col,
    dims, c1, c2, wd): three launches for every 40 leaves (the reductions
    of g^2 into tile partials; the partials summed with the EMAs and the row
    mean; the elementwise update), in place."""
    if not leaves:
        return
    lib = kernels.library()
    dev = leaves[0][0].device
    for table, corrections, n, _scratch in factored_tables(leaves, mu_dtype):
        with torch.cuda.device(dev):
            stream = kernels.stream_ptr(dev)
            for kind in range(3):
                err = lib.mt_adam_factored(kind, kernels.dtype_code(mu_dtype), table, corrections, n, b1, 1.0 - b1, b2, 1.0 - b2, eps, -lr, stream)
                kernels.check_launch(err, "adam_factored")
                kernels.count_launch("adam_factored")
    # the kernels wrote through raw pointers: mark the tensors changed, as an
    # in-place op would, so that caches keyed on a tensor's version (K3's
    # permuted weight) see the new values
    torch.autograd.graph.increment_version([t for leaf in leaves for t in (leaf[0], leaf[2], leaf[3], leaf[4])])


def adam_unfactored_update(leaves, mu_dtype, c1, c2, b1, b2, eps, lr):
    """K11 on unfactored leaves on the card, each leaf (p, g, mu, v, wd);
    one launch for every 64 leaves, in place. All leaves share the bias
    corrections (one count)."""
    if not leaves:
        return
    lib = kernels.library()
    dev = leaves[0][0].device
    for k in range(0, len(leaves), _MAX_LEAVES):
        chunk = leaves[k : k + _MAX_LEAVES]
        table = (ctypes.c_longlong * (5 * len(chunk)))()
        decay = (ctypes.c_float * len(chunk))()
        for j, (p, g, mu, v, wd) in enumerate(chunk):
            _check_leaf("adam_factored", p, g, mu)
            if mu.dtype != mu_dtype or not v.is_contiguous() or v.shape != p.shape or v.dtype != torch.float32:
                raise ValueError(f"adam_factored: leaf {tuple(p.shape)} has mu {mu.dtype} (expected {mu_dtype}) or second moment {tuple(v.shape)} {v.dtype}")
            table[5 * j : 5 * j + 5] = [p.data_ptr(), g.data_ptr(), mu.data_ptr(), v.data_ptr(), p.numel()]
            decay[j] = wd
        with torch.cuda.device(dev):
            err = lib.mt_adam_unfactored(kernels.dtype_code(mu_dtype), table, decay, len(chunk), b1, 1.0 - b1, b2, 1.0 - b2, c1, c2, eps, -lr,
                                         kernels.stream_ptr(dev))
        kernels.check_launch(err, "adam_factored")
        kernels.count_launch("adam_factored")
        torch.autograd.graph.increment_version([t for leaf in chunk for t in (leaf[0], leaf[2], leaf[3])])


def _bias_corrections(count: int, b1: float, b2: float) -> tuple[float, float]:
    """1 - b1**count and 1 - b2**count in fp32."""
    c = np.float32(count)
    one = np.float32(1.0)
    return float(one - np.float32(b1) ** c), float(one - np.float32(b2) ** c)


# ---------------------------------------------------------------------------
# the chain around either Adam


class _RecipeOptimizer(torch.optim.Optimizer):
    """The step both Adams share: accumulation, clipping, the schedule, the
    decay and the freeze groups (module docstring); ``_update`` is the Adam
    scaling and the parameters' update. After a step that updated,
    ``last_lr`` holds the learning rate it took and ``last_grad_norm`` the
    global norm before the clip (a 0-d tensor on the device, or None)."""

    def __init__(self, params, defaults, mu_dtype, schedule, max_grad_norm, accumulation_steps):
        self.mu_dtype = mu_dtype or torch.float32
        if self.mu_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"mu_dtype must be float32 or bfloat16, got {mu_dtype}")
        super().__init__(params, dict(defaults, weight_decay=defaults.get("weight_decay", 0.0), frozen=False))
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm or None
        self.accumulation_steps = int(accumulation_steps or 1)
        self.use_kernels = True
        self.last_lr = None
        self.last_grad_norm = None

    def _new_state(self, p, group, state):
        raise NotImplementedError

    def _update(self, entries, count: int, lr: float):
        """entries: (p, g, state, group) of every trainable parameter."""
        raise NotImplementedError

    def _state(self, p, group) -> dict:
        state = self.state[p]
        if not state:
            state["count"] = torch.zeros((), dtype=torch.int32)
            state["mu"] = torch.zeros_like(p, dtype=self.mu_dtype, memory_format=torch.contiguous_format)
            self._new_state(p, group, state)
            if self.accumulation_steps > 1:
                state["mini_step"] = torch.zeros((), dtype=torch.int32)
                state["acc"] = torch.zeros_like(p, memory_format=torch.contiguous_format)
        return state

    def load_state_dict(self, state_dict):
        # torch casts floating state to the parameter's dtype and moves the
        # rest to its device: restore mu's dtype and the host counters
        super().load_state_dict(state_dict)
        for state in self.state.values():
            state["mu"] = state["mu"].to(self.mu_dtype)
            for key in ("count", "mini_step"):
                if key in state:
                    state[key] = state[key].to(device="cpu", dtype=torch.int32)

    def _trainable(self):
        entries = [(p, group) for group in self.param_groups if not group["frozen"] for p in group["params"] if p.requires_grad]
        keys = ("lr", "b1", "b2", "eps") + (("min_dim_size_to_factor",) if "min_dim_size_to_factor" in self.defaults else ())
        if len({tuple(group[k] for k in keys) for _, group in entries}) > 1:
            raise ValueError(f"the trainable parameter groups must share {keys}: one update serves them all")
        return entries

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        entries = self._trainable()
        if not entries:
            return loss
        states = [self._state(p, group) for p, group in entries]
        # the reference updates every leaf: an unused one with a zero gradient
        grads = [torch.zeros_like(p, memory_format=torch.contiguous_format) if p.grad is None else p.grad.contiguous() for p, _ in entries]
        k = self.accumulation_steps
        if k > 1:
            # optax.MultiSteps: the running mean; every k-th call applies it
            n = max(int(s["mini_step"]) for s in states)
            for st, g in zip(states, grads):
                acc = st["acc"]
                acc.add_((g - acc) / float(n + 1))
            if n + 1 < k:
                for st in states:
                    st["mini_step"].fill_(n + 1)
                return loss
            grads = [st["acc"] for st in states]
        if self.max_grad_norm:
            self.last_grad_norm = clip_by_global_norm(grads, self.max_grad_norm, self.use_kernels)
        # one count for every trainable parameter, as the reference's one
        # count for the tree; the schedule at the count before the increment
        count = min(max(int(s["count"]) for s in states) + 1, np.iinfo(np.int32).max)
        group = entries[0][1]
        lr = self.schedule(count - 1) if self.schedule is not None else group["lr"]
        self.last_lr = lr
        for st in states:
            st["count"].fill_(count)
        self._update([(p, g, st, grp) for (p, grp), g, st in zip(entries, grads, states)], count, lr)
        if k > 1:
            for st in states:
                st["acc"].zero_()
                st["mini_step"].fill_(0)
        return loss


class Adam(_RecipeOptimizer):
    """``optax.scale_by_adam`` (with ``add_decayed_weights`` for a group's
    ``weight_decay`` and the learning rate, optionally scheduled) as a
    ``torch.optim.Optimizer``. Per parameter its state holds ``count``
    (int32), ``mu`` (``mu_dtype``) and ``v`` (fp32), as ``ScaleByAdamState``,
    and ``mini_step`` and ``acc`` under accumulation. The step is K17 on the
    card (``use_kernels``), its plain version elsewhere."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, mu_dtype: torch.dtype | None = None,
                 weight_decay: float = 0.0, schedule=None, max_grad_norm: float | None = None, accumulation_steps: int = 1):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay), mu_dtype, schedule, max_grad_norm, accumulation_steps)

    def _new_state(self, p, group, state):
        state["v"] = torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)

    def _update(self, entries, count, lr):
        group = entries[0][3]
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        c1, c2 = _bias_corrections(count, b1, b2)
        leaves = []
        for p, g, state, grp in entries:
            if not self.use_kernels or kernels.takes_plain("adam", p, g, state["mu"]):
                adam_update_plain(p, g, state["mu"], state["v"], c1, c2, b1, b2, eps, lr, grp["weight_decay"])
            else:
                leaves.append((p, g, state["mu"], state["v"], grp["weight_decay"]))
        adam_update(leaves, self.mu_dtype, c1, c2, b1, b2, eps, lr)


class AdamFactored(_RecipeOptimizer):
    """``scale_by_adam_factored`` chained with the learning rate (and the
    rest of the chain, module docstring) as a ``torch.optim.Optimizer``. Per
    parameter its state holds ``count`` (int32), ``mu`` (``mu_dtype``), and
    ``v_row``/``v_col`` for a factored leaf or ``v`` for an unfactored one
    (the other entries empty), with the shapes of
    ``ScaleByAdamFactoredState``, and ``mini_step`` and ``acc`` under
    accumulation. The step is K11 on the card (``use_kernels``), its plain
    version elsewhere."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, mu_dtype: torch.dtype | None = None,
                 min_dim_size_to_factor: int = 128, weight_decay: float = 0.0, schedule=None, max_grad_norm: float | None = None,
                 accumulation_steps: int = 1):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, min_dim_size_to_factor=min_dim_size_to_factor), mu_dtype,
                         schedule, max_grad_norm, accumulation_steps)

    def _new_state(self, p, group, state):
        dims = _factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
        empty = torch.zeros(0, dtype=torch.float32, device=p.device)
        if dims is None:
            state["v_row"], state["v_col"], state["v"] = empty, empty.clone(), torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
        else:
            d0, d1 = dims
            state["v_row"] = torch.zeros([s for i, s in enumerate(p.shape) if i != d1], dtype=torch.float32, device=p.device)
            state["v_col"] = torch.zeros([s for i, s in enumerate(p.shape) if i != d0], dtype=torch.float32, device=p.device)
            state["v"] = empty

    def _update(self, entries, count, lr):
        group = entries[0][3]
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        c1, c2 = _bias_corrections(count, b1, b2)
        unfactored, factored = [], []
        for p, g, state, grp in entries:
            dims = _factored_dims(tuple(p.shape), grp["min_dim_size_to_factor"])
            mu, wd = state["mu"], grp["weight_decay"]
            if not self.use_kernels or kernels.takes_plain("adam_factored", p, g, mu):
                adam_factored_update_plain(p, g, mu, state["v_row"], state["v_col"], state["v"], dims, c1, c2, b1, b2, eps, lr, wd)
            elif dims is None:
                unfactored.append((p, g, mu, state["v"], wd))
            else:
                factored.append((p, g, mu, state["v_row"], state["v_col"], dims, c1, c2, wd))
        adam_factored_update(factored, self.mu_dtype, b1, b2, eps, lr)
        adam_unfactored_update(unfactored, self.mu_dtype, c1, c2, b1, b2, eps, lr)


# ---------------------------------------------------------------------------
# get_optimizer

# FCN3's staged-training freeze groups (the JAX package's
# _FREEZE_ENCODER_PREFIXES and _FREEZE_PROCESSOR_PREFIXES)
_FREEZE_ENCODER_PREFIXES = ("atmo_encoder", "surf_encoder", "aux_encoder", "atmo_decoder", "surf_decoder", "encoder", "decoder", "residual_transform")
_FREEZE_PROCESSOR_PREFIXES = ("block",)


def freeze_labels(names, freeze_encoder: bool, freeze_processor: bool) -> dict:
    """{name: "frozen" or "train"} for dotted parameter names, by the module
    path's components, as ``_freeze_labels`` labels the flax tree."""

    def label(name):
        for c in name.split("."):
            if freeze_encoder and any(c == p or c.startswith(p) for p in _FREEZE_ENCODER_PREFIXES):
                return "frozen"
            if freeze_processor and any(c.startswith(p) for p in _FREEZE_PROCESSOR_PREFIXES):
                return "frozen"
        return "train"

    return {n: label(n) for n in names}


def decay_mask(named_shapes) -> dict:
    """{name: bool} from (dotted name, shape) pairs: True where weight decay
    applies, as ``_no_decay_mask`` decides from the flax path and the leaf's
    rank: not biases, norm parameters, layer scales (gamma) or position
    embeddings, and only leaves of more than one axis. The port's
    parameters keep the flax leaves' names and shapes (``convert_jax``), so
    the rank is the JAX leaf's."""
    out = {}
    for name, shape in named_shapes:
        low = name.replace(".", "/").lower()
        out[name] = not ("bias" in low or "pos_embed" in low or "norm" in low or "gamma" in low) and len(shape) > 1
    return out


_UNPORTED_TYPES = ("SGD", "Muon", "Shampoo", "SIRFShampoo")


def get_optimizer(params, model: torch.nn.Module, steps_per_epoch: int = 1) -> Adam | AdamFactored:
    """The optimizer a config asks for, as ``get_optimizer`` chains it:
    ``optimizer_type`` Adam, FusedAdam or AdamW, plain or with
    ``optimizer_nu_factored``, ``optimizer_mu_dtype`` float32 or bfloat16,
    clipped at ``optimizer_max_grad_norm`` (or ``max_grad_norm``), on the
    ``get_schedule`` learning rate over ``steps_per_epoch``, with
    ``weight_decay`` on the ``decay_mask`` leaves (AdamW, or Adam with a
    positive weight decay), the ``freeze_encoder``/``freeze_processor``
    groups frozen, and ``grad_accumulation_steps``. SGD, Muon and
    Shampoo/SIRFShampoo are not ported yet and raise, naming the type;
    another type raises as the reference does."""
    opt_type = params.get("optimizer_type", "Adam")
    if opt_type in _UNPORTED_TYPES:
        raise NotImplementedError(f"optimizer_type {opt_type!r} is not ported yet (ported: Adam, FusedAdam, AdamW)")
    if opt_type not in ("Adam", "FusedAdam", "AdamW"):
        raise ValueError(f"optimizer {opt_type} not supported")
    schedule = get_schedule(params, steps_per_epoch)
    wd = params.get("weight_decay", 0.0) or 0.0
    mu_name = params.get("optimizer_mu_dtype", None)
    mu_dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32, None: torch.float32}[mu_name]
    named = list(model.named_parameters())
    labels = freeze_labels([n for n, _ in named], bool(params.get("freeze_encoder", False)), bool(params.get("freeze_processor", False)))
    mask = decay_mask((n, p.shape) for n, p in named)
    train = [(n, p) for n, p in named if labels[n] == "train"]
    groups = [
        {"params": [p for n, p in train if wd > 0 and mask[n]], "weight_decay": wd},
        {"params": [p for n, p in train if not (wd > 0 and mask[n])], "weight_decay": 0.0},
        {"params": [p for n, p in named if labels[n] == "frozen"], "frozen": True},
    ]
    groups = [g for g in groups if g["params"]]
    kw = dict(
        lr=params.get("lr", 1e-3),
        b1=params.get("optimizer_beta1", 0.9),
        b2=params.get("optimizer_beta2", 0.999),
        eps=params.get("optimizer_eps", 1e-8),
        mu_dtype=mu_dtype,
        schedule=schedule,
        max_grad_norm=params.get("optimizer_max_grad_norm", params.get("max_grad_norm", None)),
        accumulation_steps=params.get("grad_accumulation_steps", 1) or 1,
    )
    if params.get("optimizer_nu_factored", False):
        return AdamFactored(groups, **kw)
    return Adam(groups, **kw)
