"""The port's native pread reader (``makani_torch/native``): ``read_blocks``
against numpy, its errors (a missing file, a short file, a missing
compiler), and ``MultifilesDataset`` under ``MAKANI_NATIVE_READER=1``
against its memory-map path, bit for bit, at the full grid and at an io
tile; a file that is not fp32 and a subsampled window raise. The reader is
built with the host's C++ compiler into a hashed library under ``build/``.
Counterpart of tests/test_native_reader.py."""

import os

import h5py
import numpy as np
import pytest

from makani_torch import native
from makani_torch.utils.dataloaders.data_loader_multifiles import MultifilesDataset
from makani_torch.utils.yparams import ParamsBase
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _blob(tmp_path):
    data = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    path = str(tmp_path / "blob.bin")
    data.tofile(path)
    return data, path


def test_read_blocks_matches_numpy(tmp_path):
    data, path = _blob(tmp_path)
    # three blocks, out of order, at interleaved destinations
    offsets = np.asarray([1024 * 4, 0, 2048 * 4], np.uint64)
    sizes = np.asarray([512 * 4, 256 * 4, 1024 * 4], np.uint64)
    dest = np.asarray([0, 512 * 4, (512 + 256) * 4], np.uint64)
    out = np.empty(512 + 256 + 1024, np.float32)
    native.read_blocks(path, offsets, sizes, out, dest, nthreads=3)
    assert np.array_equal(out, np.concatenate([data[1024:1536], data[:256], data[2048:3072]]))
    assert native.build().parent == native.build_dir() and native.build().name.startswith("libreader_")


@pytest.mark.parametrize("case", ["missing file", "short file", "past the destination"])
def test_read_blocks_raises(tmp_path, case):
    _, path = _blob(tmp_path)
    one = np.zeros(1, np.uint64)
    if case == "missing file":
        with pytest.raises(FileNotFoundError):
            native.read_blocks(str(tmp_path / "nope.bin"), one, one + 4, np.empty(1, np.float32), one)
    elif case == "short file":
        with pytest.raises(OSError, match="Input/output error"):
            native.read_blocks(path, one + 4000 * 4, one + 1024, np.empty(256, np.float32), one)
    else:
        with pytest.raises(ValueError, match="past the destination"):
            native.read_blocks(path, one, one + 8, np.empty(1, np.float32), one)


def test_build_without_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "native")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        native.library()
    assert not (tmp_path / "native").exists()


def _files(tmp_path, dtype=np.float32):
    T, C, H, W = 6, 3, 16, 32
    arr = np.random.default_rng(1).standard_normal((T, C, H, W)).astype(dtype)
    d = tmp_path / "train"
    d.mkdir()
    with h5py.File(str(d / "2001.h5"), "w") as f:
        f.create_dataset("fields", data=arr)
    params = dict(channel_names=[f"c{i}" for i in range(C)], in_channels=[0, 1, 2], out_channels=[2, 0], img_shape_x=H, img_shape_y=W, dt=1,
                  n_history=1, n_future=1, dhours=6, add_zenith=False, normalization="none")
    return params, str(d)


@pytest.mark.parametrize("tile", [None, ((4, 12), (8, 24))])
def test_loader_native_matches_memmap(tmp_path, monkeypatch, tile):
    params, loc = _files(tmp_path)
    if tile is not None:
        params.update(io_tile_x=tile[0], io_tile_y=tile[1])
    ref = MultifilesDataset(ParamsBase(dict(params)), loc)
    monkeypatch.setenv("MAKANI_NATIVE_READER", "1")
    monkeypatch.setenv("MAKANI_NATIVE_THREADS", "3")
    got = MultifilesDataset(ParamsBase(dict(params)), loc)
    assert got.native and not ref.native
    for i in range(len(ref)):
        a, b = ref[i], got[i]
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", ["float64 file", "subsampled window"])
def test_loader_native_refuses(tmp_path, monkeypatch, case):
    params, loc = _files(tmp_path, np.float64 if case == "float64 file" else np.float32)
    if case == "subsampled window":
        params["subsampling_factor"] = 2
    MultifilesDataset(ParamsBase(dict(params)), loc)  # the memory map reads both
    monkeypatch.setenv("MAKANI_NATIVE_READER", "1")
    with pytest.raises(TypeError if case == "float64 file" else NotImplementedError, match="fp32" if case == "float64 file" else "stride-1"):
        MultifilesDataset(ParamsBase(dict(params)), loc)
