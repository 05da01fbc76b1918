"""Adam with a factored second moment (counterpart of
``scale_by_adam_factored`` and ``get_optimizer`` in
``makani_tpu/utils/training/optimizer.py``).

For a leaf of at least two axes whose second-largest is at least
``min_dim_size_to_factor`` long, the second moment is kept as two EMAs of
mean(g^2), one over each of its two largest axes (d0, d1) (Adafactor), and
rebuilt as the rank-1 ``vhat = (v_row / mean_d0(v_row)) (x) v_col``; other
leaves keep Adam's full nu. mu is Adam's first moment, in fp32 or bf16. The
update is ``mu_hat / (sqrt(nu_hat) + eps)`` with the bias corrections
``1 - b^count`` computed in fp32, then ``p += -lr * u``. The three
multiply-adds, ``b1 * mu + [(1 - b1) * g]``, ``b2 * v + [(1 - b2) * g^2]``
(and its factored forms) and ``p + u * (-lr)``, are fused multiply-adds,
one rounding each, as XLA compiles the JAX step (on the CPU its results are
bit-equal to those FMAs; the bracketed products are rounded first); every
other operation rounds once. The port updates parameters and state in place.

The step is kernel K11 (``csrc/adam_factored.cu``) on the card: three
launches for all factored leaves of a parameter group (up to 40 a launch:
one read of g for both reductions of g^2 into tile partials; the partials
summed with the EMAs and the row mean of the new v_row; the elementwise
update), and one launch for all unfactored leaves (up to 64 a launch); on
the CPU the plain version, written as ``update_fn`` is. All count as
``adam_factored``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from makani_torch import kernels

__all__ = ["AdamFactored", "get_optimizer", "adam_factored_update_plain", "factored_layout", "factored_tables"]

# unfactored and factored leaves a K11 launch takes (the leaf table is a
# kernel argument; csrc/adam_factored.cu MAX_LEAVES, MAX_FLEAVES)
_MAX_LEAVES = 64
_MAX_FACTORED = 40


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


def _fma(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in fp32 with one rounding (the product and the sum exact in
    float64, then rounded); a an fp32 number or tensor."""
    a = a.double() if isinstance(a, torch.Tensor) else float(np.float32(a))
    return (a * b.double() + c.double()).float()


def adam_factored_update_plain(p, g, mu, v_row, v_col, v, dims, c1, c2, b1, b2, eps, lr):
    """K11's plain version: one leaf's update, written as ``update_fn`` then
    ``scale_by_learning_rate`` and ``apply_updates``, in place on p, mu and
    the second-moment state (v for an unfactored leaf, v_row and v_col for a
    factored one). c1, c2: the fp32 bias corrections."""
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
    mu.copy_(new_mu)
    p.copy_(_fma(-lr, u, p))


def _check_leaf(p, g, mu):
    if p.dtype != torch.float32 or g.dtype != torch.float32 or mu.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"adam_factored: expects float32 parameters and gradients and a float32/bfloat16 mu, got {p.dtype}, {g.dtype}, {mu.dtype}")
    if not (p.is_contiguous() and g.is_contiguous() and mu.is_contiguous()) or g.shape != p.shape or mu.shape != p.shape:
        raise ValueError(f"adam_factored: parameter, gradient and mu must be contiguous and of one shape, got {tuple(p.shape)}, {tuple(g.shape)}, {tuple(mu.shape)}")


def factored_tables(leaves, mu_dtype):
    """K11's launch tables for factored leaves (p, g, mu, v_row, v_col, dims,
    c1, c2), one for every 40: (table, corrections, leaf count, scratch), the
    table's rows (p, g, mu, vA, vB, scratch, P, R, Mi, S, Q, row_keeps_r) as
    64-bit integers, the corrections (c1, c2) a leaf, and one scratch buffer
    for the chunk's partial sums and row means (each leaf's part 16-byte
    aligned: the sizes are multiples of 4 floats)."""
    lib = kernels.library()
    out = []
    for k in range(0, len(leaves), _MAX_FACTORED):
        chunk = leaves[k : k + _MAX_FACTORED]
        table = (ctypes.c_longlong * (12 * len(chunk)))()
        corrections = (ctypes.c_float * (2 * len(chunk)))()
        sizes, rows = [], []
        for p, g, mu, v_row, v_col, dims, c1, c2 in chunk:
            _check_leaf(p, g, mu)
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
            corrections[2 * j : 2 * j + 2] = [chunk[j][6], chunk[j][7]]
        out.append((table, corrections, len(chunk), scratch))
    return out


def adam_factored_update(leaves, mu_dtype, b1, b2, eps, lr):
    """K11 on factored leaves on the card, each leaf (p, g, mu, v_row, v_col,
    dims, c1, c2): three launches for every 40 leaves (the reductions of g^2
    into tile partials; the partials summed with the EMAs and the row mean;
    the elementwise update), in place."""
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
    """K11 on unfactored leaves on the card, each leaf (p, g, mu, v); one
    launch for every 64 leaves, in place. All leaves share the bias
    corrections (one count)."""
    if not leaves:
        return
    lib = kernels.library()
    dev = leaves[0][0].device
    for k in range(0, len(leaves), _MAX_LEAVES):
        chunk = leaves[k : k + _MAX_LEAVES]
        table = (ctypes.c_longlong * (5 * len(chunk)))()
        for j, (p, g, mu, v) in enumerate(chunk):
            _check_leaf(p, g, mu)
            if mu.dtype != mu_dtype or not v.is_contiguous() or v.shape != p.shape or v.dtype != torch.float32:
                raise ValueError(f"adam_factored: leaf {tuple(p.shape)} has mu {mu.dtype} (expected {mu_dtype}) or second moment {tuple(v.shape)} {v.dtype}")
            table[5 * j : 5 * j + 5] = [p.data_ptr(), g.data_ptr(), mu.data_ptr(), v.data_ptr(), p.numel()]
        with torch.cuda.device(dev):
            err = lib.mt_adam_unfactored(kernels.dtype_code(mu_dtype), table, len(chunk), b1, 1.0 - b1, b2, 1.0 - b2, c1, c2, eps, -lr, kernels.stream_ptr(dev))
        kernels.check_launch(err, "adam_factored")
        kernels.count_launch("adam_factored")
        torch.autograd.graph.increment_version([t for leaf in chunk for t in (leaf[0], leaf[2], leaf[3])])


def _bias_corrections(count: int, b1: float, b2: float) -> tuple[float, float]:
    """1 - b1**count and 1 - b2**count in fp32."""
    c = np.float32(count)
    one = np.float32(1.0)
    return float(one - np.float32(b1) ** c), float(one - np.float32(b2) ** c)


class AdamFactored(torch.optim.Optimizer):
    """``scale_by_adam_factored`` chained with ``scale_by_learning_rate(lr)``
    as a ``torch.optim.Optimizer``. Per parameter its state holds ``count``
    (int32), ``mu`` (``mu_dtype``), and ``v_row``/``v_col`` for a factored
    leaf or ``v`` for an unfactored one (the other entries empty), with the
    shapes of ``ScaleByAdamFactoredState``. As in the reference, a group
    advances one count a step, kept equal in every parameter's ``count``,
    and every parameter that requires a gradient is updated, a missing
    ``grad`` taken as zeros. ``use_kernels = False`` runs the plain version
    on any device: the reference path a comparison on the card runs."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, mu_dtype: torch.dtype | None = None, min_dim_size_to_factor: int = 128):
        self.mu_dtype = mu_dtype or torch.float32
        if self.mu_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"mu_dtype must be float32 or bfloat16, got {mu_dtype}")
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, min_dim_size_to_factor=min_dim_size_to_factor))
        self.use_kernels = True

    def _state(self, p, group) -> dict:
        state = self.state[p]
        if not state:
            dims = _factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
            empty = torch.zeros(0, dtype=torch.float32, device=p.device)
            state["count"] = torch.zeros((), dtype=torch.int32)
            state["mu"] = torch.zeros_like(p, dtype=self.mu_dtype, memory_format=torch.contiguous_format)
            if dims is None:
                state["v_row"], state["v_col"], state["v"] = empty, empty.clone(), torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
            else:
                d0, d1 = dims
                vr = [s for i, s in enumerate(p.shape) if i != d1]
                vc = [s for i, s in enumerate(p.shape) if i != d0]
                state["v_row"] = torch.zeros(vr, dtype=torch.float32, device=p.device)
                state["v_col"] = torch.zeros(vc, dtype=torch.float32, device=p.device)
                state["v"] = empty
        return state

    def load_state_dict(self, state_dict):
        # torch casts floating state to the parameter's dtype: restore mu's
        # dtype and the integer count
        super().load_state_dict(state_dict)
        for state in self.state.values():
            state["mu"] = state["mu"].to(self.mu_dtype)
            state["count"] = state["count"].to(device="cpu", dtype=torch.int32)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2, eps, lr = group["b1"], group["b2"], group["eps"], group["lr"]
            params = [p for p in group["params"] if p.requires_grad]
            if not params:
                continue
            # one count for the group, as the reference's one count for the tree
            states = [self._state(p, group) for p in params]
            count = min(max(int(s["count"]) for s in states) + 1, np.iinfo(np.int32).max)
            c1, c2 = _bias_corrections(count, b1, b2)
            unfactored, factored = [], []
            for p, state in zip(params, states):
                state["count"].fill_(count)
                dims = _factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
                # the reference updates every leaf: an unused one with a zero gradient
                g = p.grad if p.grad is not None else torch.zeros_like(p, memory_format=torch.contiguous_format)
                mu = state["mu"]
                if not self.use_kernels or kernels.takes_plain("adam_factored", p, g, mu):
                    adam_factored_update_plain(p, g, mu, state["v_row"], state["v_col"], state["v"], dims, c1, c2, b1, b2, eps, lr)
                elif dims is None:
                    unfactored.append((p, g.contiguous(), mu, state["v"]))
                else:
                    factored.append((p, g.contiguous(), mu, state["v_row"], state["v_col"], dims, c1, c2))
            adam_factored_update(factored, self.mu_dtype, b1, b2, eps, lr)
            adam_unfactored_update(unfactored, self.mu_dtype, c1, c2, b1, b2, eps, lr)
        return loss


_UNPORTED_OPTIONS = {
    "weight_decay": 0.0,
    "optimizer_max_grad_norm": None,
    "max_grad_norm": None,
    "freeze_encoder": False,
    "freeze_processor": False,
    "grad_accumulation_steps": 1,
    "lr_warmup_steps": 0,
}


def get_optimizer(params, model: torch.nn.Module) -> AdamFactored:
    """The optimizer a config asks for. Ported: ``optimizer_type`` Adam (or
    FusedAdam, AdamW without weight decay) with ``optimizer_nu_factored``,
    ``optimizer_mu_dtype`` float32 or bfloat16 and a constant learning rate
    (``scheduler`` none, no warmup). Every other optimizer, schedule, weight
    decay, clipping, freeze flag or gradient accumulation raises."""
    opt_type = params.get("optimizer_type", "Adam")
    if opt_type not in ("Adam", "FusedAdam", "AdamW"):
        raise NotImplementedError(f"optimizer_type {opt_type!r} is not ported yet (only Adam with optimizer_nu_factored)")
    if not params.get("optimizer_nu_factored", False):
        raise NotImplementedError("only the factored Adam (optimizer_nu_factored: True) is ported yet")
    sched = params.get("scheduler", "none")
    if sched not in ("none", None):
        raise NotImplementedError(f"scheduler {sched!r} is not ported yet (only a constant learning rate)")
    for key, off in _UNPORTED_OPTIONS.items():
        value = params.get(key, off)
        if value not in (off, None, 0, False) and not (key == "grad_accumulation_steps" and value == 1):
            raise NotImplementedError(f"optimizer option {key!r} = {value!r} is not ported yet")
    mu_name = params.get("optimizer_mu_dtype", None)
    mu_dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32, None: torch.float32}[mu_name]
    return AdamFactored(
        model.parameters(),
        lr=params.get("lr", 1e-3),
        b1=params.get("optimizer_beta1", 0.9),
        b2=params.get("optimizer_beta2", 0.999),
        eps=params.get("optimizer_eps", 1e-8),
        mu_dtype=mu_dtype,
    )
