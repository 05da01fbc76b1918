"""NaN imputation (counterpart of ``makani_tpu/models/common/imputation.py``).

Datasets with masked regions (SST over land) carry NaNs. ``MLPImputation``
fills the masked positions of some channels with a pointwise MLP conditioned
on every input channel (FCN3.1's SST imputation); ``Imputer`` fills every
NaN with a constant or a learned per-channel value, optionally appending the
mask as channels. Both take and return NCHW tensors; the MLP runs
channels-last (the port's ``EncoderDecoder``), its parameter names and
shapes those of the flax tree (``mlp.hidden0.kernel``, ``mlp.out.kernel``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from makani_torch.device import resolve_device
from makani_torch.models.common.layers import EncoderDecoder

__all__ = ["MLPImputation", "Imputer"]


class MLPImputation(nn.Module):
    """Learned imputation of ``impute_chans`` from all ``inp_chans`` input
    channels: positions that are NaN, or set in ``mask``, take the MLP's
    value; the MLP sees the input with every NaN set to 0, and so does the
    output everywhere else."""

    def __init__(
        self,
        inp_chans: int,
        impute_chans: Sequence[int],
        mlp_ratio: float = 2.0,
        act_layer: Optional[Callable] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.impute_chans = tuple(int(c) for c in impute_chans)
        n = len(self.impute_chans)
        self.mlp = EncoderDecoder(1, inp_chans, n, int(mlp_ratio * n), act_layer=act_layer or nn.functional.gelu, dtype=dtype, device=device)
        self.register_buffer("idx", torch.as_tensor(self.impute_chans, dtype=torch.long, device=device), persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, C, H, W); mask broadcastable to (B, n_impute, H, W), or
        (B, H, W) for every imputed channel alike."""
        sub = x.index_select(1, self.idx)
        nan = torch.isnan(sub)
        missing = nan
        if mask is not None:
            missing = missing | (mask.bool() if mask.dim() == sub.dim() else mask[:, None].bool())
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        x_clean = torch.where(torch.isnan(x), zero, x)
        vals = self.mlp(x_clean.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        filled = torch.where(missing, vals.to(x.dtype), torch.where(nan, zero, sub))
        return x_clean.index_copy(1, self.idx, filled)


class Imputer(nn.Module):
    """Fill NaNs with ``fill_value`` (mode ``constant``) or a learned
    per-channel value ``fill`` (1, C, 1, 1) (mode ``learned``); with
    ``append_mask``, append the 0/1 mask of valid values as C channels."""

    def __init__(self, num_chans: int, mode: str = "constant", fill_value: float = 0.0, append_mask: bool = False, device=None):
        super().__init__()
        if mode not in ("constant", "learned"):
            raise ValueError(f"imputer mode {mode!r} (constant or learned)")
        self.mode, self.fill_value, self.append_mask = mode, float(fill_value), append_mask
        if mode == "learned":
            self.fill = nn.Parameter(torch.zeros(1, num_chans, 1, 1, device=resolve_device(device)))

    def reset_parameters(self, generator: torch.Generator | None = None):
        if self.mode == "learned":
            with torch.no_grad():
                self.fill.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mask = torch.isnan(x)
        fill = self.fill.to(x.dtype) if self.mode == "learned" else torch.tensor(self.fill_value, dtype=x.dtype, device=x.device)
        filled = torch.where(mask, fill, x)
        if self.append_mask:
            return torch.cat([filled, (~mask).to(x.dtype)], dim=1)
        return filled
