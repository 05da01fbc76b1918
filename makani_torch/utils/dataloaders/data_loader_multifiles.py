"""Multi-file HDF5 dataset (counterpart of ``MultifilesDataset`` in
``makani_tpu/utils/dataloaders/data_loader_multifiles.py``).

Host-side numpy over yearly HDF5 files, each holding a ``fields`` dataset
(T, C, H, W) and optionally ``timestamp`` (epoch seconds). A global sample
index maps onto (file, offset); a sample is an ``n_history + 1`` input
window and an ``n_future + 1`` target window with stride ``dt`` (in
validation ``valid_autoreg_steps + 1`` targets), z-score or min-max
normalized in place, with the cosine of the solar zenith angle of every
state when ``add_zenith`` is set.

The files are read through ``makani_torch.utils.hdf5`` (the card's Python
has no h5py): each dataset is memory-mapped at its offset, the JAX
package's fast path. A full-grid fp32 window is copied slab by slab from
the map; a crop, a subsampling or an io tile slices the map; data of
another dtype is converted to fp32 as it is read. Chunked or compressed
files raise.

``MAKANI_NATIVE_READER=1`` reads the windows with the native pread reader
(``makani_torch.native``, ``MAKANI_NATIVE_THREADS`` threads, default 4)
into the window's buffer: one block a (time step, channel) where the
window spans the grid's width (its rows lie together in the file), else one
block a row of each channel. It needs fp32 files and stride-1 windows;
another dtype, a subsampled window, a failed build or a failed read raises
(the JAX package falls back to the memory map instead).

``timings`` sums the seconds spent reading, normalizing and computing the
zenith angle, for the drivers' account of the host.
"""

from __future__ import annotations

import glob
import os
import time
from bisect import bisect_right

import numpy as np

from makani_torch.utils import hdf5
from makani_torch.utils.dataloaders.data_helpers import get_data_normalization, get_out_normalization
from makani_torch.utils.zenith_angle import cos_zenith_angle_from_timestamp

__all__ = ["MultifilesDataset"]


class MultifilesDataset:
    def __init__(self, params, location: str, train: bool = True, final_eval: bool = False):
        self.location = location
        self.train = train
        self.params = params

        self.n_history = params.get("n_history", 0)
        self.n_future = params.get("n_future", 0) if train else params.get("valid_autoreg_steps", 0)
        self.dt = params.get("dt", 1)
        self.dhours = params.get("dhours", 6)
        self.add_zenith = params.get("add_zenith", False)
        self.h5_path = params.get("h5_path", "fields")

        self.in_channels = np.asarray(params.get("in_channels"))
        self.out_channels = np.asarray(params.get("out_channels"))

        self.crop_size = (params.get("crop_size_x", None), params.get("crop_size_y", None))
        self.crop_anchor = (params.get("crop_anchor_x", 0), params.get("crop_anchor_y", 0))
        self.subsampling_factor = params.get("subsampling_factor", 1)

        self.files = sorted(glob.glob(os.path.join(location, "*.h5")))
        if not self.files:
            raise IOError(f"no HDF5 files found under {location}")

        self._datasets = []
        self.n_samples_per_file = []
        self.timestamps = []
        for path in self.files:
            f = hdf5.File(path)
            ds = f[self.h5_path]
            n, shape = ds.shape[0], ds.shape
            if "timestamp" in f:
                ts = np.asarray(f["timestamp"][...])
            else:
                # 6-hourly timestamps from the file name (the year)
                year = int(os.path.splitext(os.path.basename(path))[0])
                t0 = np.datetime64(f"{year}-01-01T00:00:00").astype("datetime64[s]").astype(np.int64)
                ts = t0 + np.arange(n) * self.dhours * 3600
            self._datasets.append(ds)
            self.n_samples_per_file.append(n)
            self.timestamps.append(ts)

        self.file_shape = shape[2:]
        cx = self.crop_size[0] or self.file_shape[0]
        cy = self.crop_size[1] or self.file_shape[1]
        if self.crop_anchor[0] + cx > self.file_shape[0] or self.crop_anchor[1] + cy > self.file_shape[1]:
            raise ValueError(f"crop (anchor {self.crop_anchor}, size {(cx, cy)}) exceeds file shape {self.file_shape}")
        self.crop_size = (cx, cy)
        ss = self.subsampling_factor
        self.img_shape = (int(np.ceil(cx / ss)), int(np.ceil(cy / ss)))
        params["img_shape_x"], params["img_shape_y"] = self.img_shape
        params["img_crop_offset_x"], params["img_crop_offset_y"] = self.crop_anchor

        # margins: n_history * dt before and (n_future + 1) * dt after each index
        self.margin_front = self.n_history * self.dt
        self.margin_back = (self.n_future + 1) * self.dt
        self.valid_per_file = [max(0, n - self.margin_front - self.margin_back) for n in self.n_samples_per_file]
        self.cum = np.cumsum([0] + self.valid_per_file)
        self.n_samples = int(self.cum[-1])

        self.in_bias, self.in_scale = get_data_normalization(params)
        self._inv_scale = 1.0 / np.asarray(self.in_scale, dtype=np.float32)
        # the targets follow out_channels' rows, which may differ from in_channels'
        self.out_bias, self.out_scale = get_out_normalization(params)
        self._out_inv_scale = 1.0 / np.asarray(self.out_scale, dtype=np.float32)
        self._norm_identity = bool(
            np.all(np.asarray(self.in_bias) == 0) and np.all(np.asarray(self.in_scale) == 1)
            and np.all(np.asarray(self.out_bias) == 0) and np.all(np.asarray(self.out_scale) == 1)
        )

        # the (h, w) tile this process reads, in the cropped and subsampled
        # grid (one process reads all of it), composed into file-space slices
        tx = tuple(params.get("io_tile_x", (0, self.img_shape[0])) or (0, self.img_shape[0]))
        ty = tuple(params.get("io_tile_y", (0, self.img_shape[1])) or (0, self.img_shape[1]))
        self.io_tile = (tx, ty)
        self.tile_shape = (tx[1] - tx[0], ty[1] - ty[0])
        self._sx = slice(self.crop_anchor[0] + tx[0] * ss, self.crop_anchor[0] + tx[1] * ss, ss)
        self._sy = slice(self.crop_anchor[1] + ty[0] * ss, self.crop_anchor[1] + ty[1] * ss, ss)

        lat = params.get("lat")
        lon = params.get("lon")
        if lat is None:
            lat = np.linspace(90.0, -90.0, self.file_shape[0])
            lon = np.linspace(0.0, 360.0, self.file_shape[1], endpoint=False)
        self.lat_deg = np.asarray(lat, dtype=np.float64)[self._sx]
        self.lon_deg = np.asarray(lon, dtype=np.float64)[self._sy]
        self._lon_grid, self._lat_grid = np.meshgrid(self.lon_deg, self.lat_deg)
        self.timings = {"read": 0.0, "normalize": 0.0, "zenith": 0.0}

        self.native = os.environ.get("MAKANI_NATIVE_READER", "0") == "1"
        if self.native:
            self._check_native()

    def _check_native(self):
        """Refuse what the native reader cannot read, and build it."""
        from makani_torch import native

        for path, ds in zip(self.files, self._datasets):
            if ds.dtype != np.float32:
                raise TypeError(f"the native reader reads fp32 files; {path}:{self.h5_path} is {ds.dtype}")
            if ds.offset is None:
                raise ValueError(f"{path}:{self.h5_path} has no storage")
        if self._sx.step != 1 or self._sy.step != 1:
            raise NotImplementedError(f"the native reader reads stride-1 windows; subsampling_factor {self.subsampling_factor} is not one")
        self._native_threads = int(os.environ.get("MAKANI_NATIVE_THREADS", "4"))
        native.library()

    def __len__(self):
        return self.n_samples

    def get_normalization(self):
        return self.in_bias, self.in_scale

    def _zenith(self, ts_list):
        return np.stack([cos_zenith_angle_from_timestamp(float(t), self._lon_grid, self._lat_grid) for t in ts_list]).astype(np.float32)[:, None]

    def _read_window(self, fidx, indices, channels):
        """Time steps ``indices`` x ``channels`` at the tile's slices, fp32:
        each step copied from the memory map into one buffer, converted to
        fp32 as it is copied (or read by the native reader); the channel
        selection is skipped when it is the identity."""
        ds = self._datasets[fidx]
        identity_ch = len(channels) == ds.shape[1] and list(channels) == list(range(ds.shape[1]))
        if self.native:
            out = self._read_window_native(ds, indices)
            return out if identity_ch else out[:, channels]
        mm = ds.memmap()
        views = [mm[i, :, self._sx, self._sy] for i in indices]
        out = np.empty((len(views),) + views[0].shape, np.float32)
        for k, view in enumerate(views):
            out[k] = view
        return out if identity_ch else out[:, channels]

    def _read_window_native(self, ds, indices):
        """Time steps ``indices``, every channel, at the tile's rows and
        columns, read by ``native.read_blocks`` straight into the window's
        buffer: one block a (step, channel) where the tile spans the width,
        so that the threads share even one time step, else one block a
        (step, channel, row)."""
        from makani_torch import native

        C, H, W = ds.shape[1:]
        x0, x1 = self._sx.start, min(self._sx.stop, H)
        y0, y1 = self._sy.start, min(self._sy.stop, W)
        T, th, tw = len(indices), x1 - x0, y1 - y0
        out = np.empty((T, C, th, tw), np.float32)
        u = np.uint64
        runs = 1 if tw == W else th  # the blocks of a (step, channel)
        t, c, r = np.meshgrid(np.arange(T, dtype=u), np.arange(C, dtype=u), np.arange(runs, dtype=u), indexing="ij")
        idx = np.asarray(indices, u)[t]
        offsets = (u(ds.offset) + (((idx * u(C) + c) * u(H) + u(x0) + r) * u(W) + u(y0)) * u(4)).ravel()
        dest = (((t * u(C) + c) * u(th) + r) * u(tw * 4)).ravel()
        sizes = np.full(offsets.size, th * tw * 4 // runs, u)
        native.read_blocks(ds.path, offsets, sizes, out, dest, nthreads=self._native_threads)
        return out

    def _locate(self, idx: int):
        fidx = bisect_right(self.cum, idx) - 1
        return fidx, idx - self.cum[fidx] + self.margin_front

    def __getitem__(self, idx: int):
        fidx, local = self._locate(idx)
        ts = self.timestamps[fidx]
        inp_idx = [local - (self.n_history - i) * self.dt for i in range(self.n_history + 1)]
        tar_idx = [local + (i + 1) * self.dt for i in range(self.n_future + 1)]

        t0 = time.perf_counter()
        inp = self._read_window(fidx, inp_idx, self.in_channels)
        tar = self._read_window(fidx, tar_idx, self.out_channels)
        t1 = time.perf_counter()
        # in place, by the reciprocal (two temporaries would be ~600 MB a
        # sample at 0.25 degrees); skipped for identity statistics
        if not self._norm_identity:
            np.subtract(inp, self.in_bias, out=inp)
            np.multiply(inp, self._inv_scale, out=inp)
            np.subtract(tar, self.out_bias, out=tar)
            np.multiply(tar, self._out_inv_scale, out=tar)
        t2 = time.perf_counter()
        sample = {"inp": inp, "tar": tar}
        if self.add_zenith:
            sample["izen"] = self._zenith([ts[i] for i in inp_idx])
            sample["tzen"] = self._zenith([ts[i] for i in tar_idx])
        t3 = time.perf_counter()
        self.timings["read"] += t1 - t0
        self.timings["normalize"] += t2 - t1
        self.timings["zenith"] += t3 - t2
        return sample

    def base_timestamp(self, idx: int) -> int:
        """Epoch seconds of the sample's base (initial-condition) time."""
        fidx, local = self._locate(idx)
        return int(self.timestamps[fidx][local])

    def target_timestamps(self, idx: int):
        """Epoch seconds of each target (lead-time) step of sample ``idx``."""
        fidx, local = self._locate(idx)
        ts = self.timestamps[fidx]
        return [int(ts[local + (i + 1) * self.dt]) for i in range(self.n_future + 1)]

    def get_sample_at_time(self, when: np.datetime64):
        """The sample whose base index falls at a timestamp (inference)."""
        target = when.astype("datetime64[s]").astype(np.int64)
        for fidx, ts in enumerate(self.timestamps):
            pos = np.searchsorted(ts, target)
            if pos < len(ts) and ts[pos] == target:
                local = pos - self.margin_front
                if 0 <= local < self.valid_per_file[fidx]:
                    return int(self.cum[fidx] + local)
        raise ValueError(f"timestamp {when} not found in dataset")
