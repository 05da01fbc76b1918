"""Streaming rollout analysis buffers (counterpart of
``makani_tpu/utils/inference/rollout_buffer.py``), fed by the ``Inferencer``
at every lead time of every rollout:

  * ``RolloutBuffer`` writes the selected channels of every step to HDF5
    (``fields`` (n_ic, n_steps, C_sel, H, W) and ``channel``);
  * ``TemporalAverageBuffer`` keeps a Welford mean and std map per lead time;
  * ``SpectrumAverageBuffer`` the mean SH power spectra of the prediction and
    the target per lead time (``RealSHT.analysis``: K1 on the card);
  * ``ZonalSpectrumAverageBuffer`` the mean zonal (longitude rFFT, cuFFT)
    power spectra.

The accumulators live on the prediction's device, in fp64 as the JAX
package's host arrays, and are read once, in ``finalize``. The raw
forecasts go to the host by non-blocking copies into page-locked memory,
and each batch of initial conditions is written when its last step has been
copied (the JAX package writes there too): there the host waits for the
card, once a batch, on an event (``RolloutBuffer.waits`` counts these waits,
which ``torch.cuda.set_sync_debug_mode`` does not see).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from makani_torch.ops.sht import RealSHT
from makani_torch.utils import hdf5

__all__ = ["RolloutBuffer", "TemporalAverageBuffer", "SpectrumAverageBuffer", "ZonalSpectrumAverageBuffer"]


class RolloutBuffer:
    """Collect the selected output channels per rollout step and write them
    to HDF5 at ``path``. The file's datasets are contiguous, so the number of
    initial conditions, ``num_ics``, is given up front. ``waits`` counts the
    times the host waited for the card's copies (once a batch of initial
    conditions, at its last step, on the card)."""

    def __init__(self, channel_names: Sequence[str], output_channels: Optional[Sequence[str]], img_shape, num_steps: int, path: Optional[str] = None,
                 num_ics: Optional[int] = None):
        self.channel_names = list(channel_names)
        out = output_channels if output_channels else self.channel_names
        self.out_names = list(out)
        self.out_idx = np.asarray([self.channel_names.index(c) for c in self.out_names])
        self.img_shape = tuple(img_shape)
        self.num_steps = num_steps
        self.path = path
        self.num_ics = num_ics
        self._fields = None
        self._n_ic = 0
        self._pending = {}
        self._identity = list(self.out_idx) == list(range(len(self.channel_names)))
        self._sel = {}
        self.waits = 0

    def _ensure_file(self):
        if self.path is None or self._fields is not None:
            return
        if self.num_ics is None:
            raise ValueError("RolloutBuffer writes a contiguous dataset: give num_ics")
        shape = (self.num_ics, self.num_steps, len(self.out_names), *self.img_shape)
        names = np.array(self.out_names, dtype="S")
        maps = hdf5.File.create(self.path, {"fields": (shape, np.float32), "channel": (names.shape, names.dtype)})
        maps["channel"][:] = names
        maps["channel"].flush()
        self._fields = maps["fields"]

    def update(self, pred: torch.Tensor, idt: int, ic_index: int = 0):
        """pred: (B, C, H, W) at lead-time index ``idt``."""
        if self._identity:
            sel = pred[:, : len(self.out_names)]
        else:
            if pred.device not in self._sel:
                self._sel[pred.device] = torch.as_tensor(self.out_idx, device=pred.device)
            sel = pred[:, self._sel[pred.device]]
        sel = sel[..., : self.img_shape[0], : self.img_shape[1]]
        self._ensure_file()
        block = self._pending.get(ic_index)
        if block is None:
            shape = (self.num_steps, sel.shape[0], len(self.out_names), *self.img_shape)
            block = self._pending[ic_index] = torch.empty(shape, dtype=torch.float32, pin_memory=pred.is_cuda)
        block[idt].copy_(sel, non_blocking=True)
        if idt == self.num_steps - 1:
            block = self._pending.pop(ic_index)
            if pred.is_cuda:
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
                self.waits += 1
            if self._fields is not None:
                n0 = self._n_ic
                self._fields[n0 : n0 + block.shape[1]] = np.moveaxis(block.numpy(), 0, 1)
                self._n_ic += block.shape[1]

    def finalize(self):
        if self._fields is not None:
            self._fields.flush()
            self._fields = None


class TemporalAverageBuffer:
    """Welford online mean and std of a map per lead time, in fp64 on the
    device of the first update."""

    def __init__(self, num_steps: int, num_channels: int, img_shape):
        self.shape = (num_steps, num_channels, *img_shape)
        self.count = np.zeros(num_steps, np.int64)
        self.mean = self.m2 = None

    def update(self, pred: torch.Tensor, idt: int):
        if self.mean is None:
            self.mean = torch.zeros(self.shape, dtype=torch.float64, device=pred.device)
            self.m2 = torch.zeros_like(self.mean)
        H, W = self.shape[-2:]
        x = pred[..., :H, :W].to(torch.float64)
        for b in range(x.shape[0]):
            self.count[idt] += 1
            delta = x[b] - self.mean[idt]
            self.mean[idt] += delta / int(self.count[idt])
            delta2 = x[b] - self.mean[idt]
            self.m2[idt] += delta * delta2

    def finalize(self):
        """(mean, std) maps (S, C, H, W) fp32 as numpy arrays."""
        if self.mean is None:
            return np.zeros(self.shape, np.float32), np.zeros(self.shape, np.float32)
        c = torch.as_tensor(np.maximum(self.count - 1, 1), device=self.m2.device).reshape(-1, 1, 1, 1)
        return self.mean.to(torch.float32).cpu().numpy(), torch.sqrt(self.m2 / c).to(torch.float32).cpu().numpy()


class SpectrumAverageBuffer:
    """Mean SH power spectrum per (lead time, channel, degree l) of the
    prediction and of the target: the power of each (l, m), the m > 0 modes
    counted twice, summed over m. ``sht`` reuses a transform made before
    (its table takes tens of seconds to build at 0.25 degrees); with a
    ``device``, its table and the weights go there when the buffer is made,
    not in the first update."""

    def __init__(self, img_shape, num_steps: int, num_channels: int, grid_type: str = "equiangular", device=None, sht: RealSHT | None = None):
        self.sht = sht if sht is not None else RealSHT(img_shape[0], img_shape[1], grid=grid_type)
        mw = np.full((self.sht.mmax,), 2.0, np.float32)
        mw[0] = 1.0
        self._mode_weights = torch.from_numpy(mw)
        if device is not None:
            self.sht.weights(device)
            self._mode_weights = self._mode_weights.to(device)
        self.shape = (num_steps, num_channels, self.sht.lmax)
        self.sum = self.sum_tar = None
        self.count = np.zeros(num_steps, np.int64)
        self.img_shape = tuple(img_shape)

    def _spectrum(self, x: torch.Tensor) -> torch.Tensor:
        c2 = self.sht.analysis(x[..., : self.img_shape[0], : self.img_shape[1]].to(torch.float32))
        if self._mode_weights.device != x.device:
            self._mode_weights = self._mode_weights.to(x.device)
        power = (torch.square(c2[..., 0]) + torch.square(c2[..., 1])) * self._mode_weights
        return torch.sum(power, dim=-1)  # (B, C, L)

    def update(self, pred: torch.Tensor, idt: int, tar: Optional[torch.Tensor] = None):
        if self.sum is None:
            self.sum = torch.zeros(self.shape, dtype=torch.float64, device=pred.device)
            self.sum_tar = torch.zeros_like(self.sum)
        spec = self._spectrum(pred)
        self.sum[idt] += spec.sum(dim=0).to(torch.float64)
        self.count[idt] += spec.shape[0]
        if tar is not None:
            self.sum_tar[idt] += self._spectrum(tar).sum(dim=0).to(torch.float64)

    def finalize(self):
        """(pred_spectrum, target_spectrum), each (S, C, L) fp32 numpy."""
        if self.sum is None:
            return np.zeros(self.shape, np.float32), np.zeros(self.shape, np.float32)
        c = np.maximum(self.count[:, None, None], 1)
        return (self.sum.cpu().numpy() / c).astype(np.float32), (self.sum_tar.cpu().numpy() / c).astype(np.float32)


class ZonalSpectrumAverageBuffer:
    """Mean zonal (per-latitude longitude rFFT) power spectrum of the
    prediction and of the target, averaged over latitude."""

    def __init__(self, img_shape, num_steps: int, num_channels: int):
        self.img_shape = tuple(img_shape)
        self.shape = (num_steps, num_channels, img_shape[1] // 2 + 1)
        self.sum = self.sum_tar = None
        self.count = np.zeros(num_steps, np.int64)

    def _spectrum(self, x: torch.Tensor) -> torch.Tensor:
        f = torch.fft.rfft(x[..., : self.img_shape[0], : self.img_shape[1]].to(torch.float32), dim=-1, norm="forward")
        power = torch.square(f.real) + torch.square(f.imag)
        return torch.mean(power, dim=-2)  # (B, C, M)

    def update(self, pred: torch.Tensor, idt: int, tar: Optional[torch.Tensor] = None):
        if self.sum is None:
            self.sum = torch.zeros(self.shape, dtype=torch.float64, device=pred.device)
            self.sum_tar = torch.zeros_like(self.sum)
        spec = self._spectrum(pred)
        self.sum[idt] += spec.sum(dim=0).to(torch.float64)
        self.count[idt] += spec.shape[0]
        if tar is not None:
            self.sum_tar[idt] += self._spectrum(tar).sum(dim=0).to(torch.float64)

    def finalize(self):
        """(pred_spectrum, target_spectrum), each (S, C, M) fp32 numpy."""
        if self.sum is None:
            return np.zeros(self.shape, np.float32), np.zeros(self.shape, np.float32)
        c = np.maximum(self.count[:, None, None], 1)
        return (self.sum.cpu().numpy() / c).astype(np.float32), (self.sum_tar.cpu().numpy() / c).astype(np.float32)
