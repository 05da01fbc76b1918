"""The port's host pipeline against makani_tpu's: the HDF5 module against
h5py in both directions, ``MultifilesDataset`` (samples, zenith fields and
timestamps bit-equal, with a history window and a future window too, and
through a crop), ``BatchIterator`` (the same batches in the same order,
epoch after epoch, and under ``set_epoch``), the synthetic dataset,
``DeviceBatches`` on the CPU, the metadata parser, the driver's defaults
and shapes, and the climatology. The files are ``init_hdf5_dataset``'s
(16x32, 5 channels)."""

import copy
import os

import h5py
import numpy as np
import pytest
import torch

from makani_tpu.utils import driver as jdriver
from makani_tpu.utils.dataloader import BatchIterator as JBatchIterator
from makani_tpu.utils.dataloaders import data_helpers as jhelpers
from makani_tpu.utils.dataloaders.data_loader_dummy import DummyDataset as JDummyDataset
from makani_tpu.utils.dataloaders.data_loader_multifiles import MultifilesDataset as JMultifilesDataset
from makani_tpu.utils.parse_dataset_metadata import parse_dataset_metadata as jparse
from makani_tpu.utils.yparams import ParamsBase as JParamsBase
from tests.testutils import CHANNEL_NAMES, init_hdf5_dataset

from makani_torch.utils import driver, hdf5
from makani_torch.utils.dataloader import BatchIterator, DeviceBatches, _assemble, get_dataloader
from makani_torch.utils.dataloaders import data_helpers
from makani_torch.utils.dataloaders.data_loader_dummy import DummyDataset
from makani_torch.utils.dataloaders.data_loader_multifiles import MultifilesDataset
from makani_torch.utils.parse_dataset_metadata import parse_dataset_metadata
from makani_torch.utils.yparams import ParamsBase
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return init_hdf5_dataset(root, years=(2017, 2018), samples_per_year=12)


@pytest.fixture(scope="module")
def half_files(files, tmp_path_factory):
    """``files`` with the fields stored as float16 (read converted to fp32)."""
    root = tmp_path_factory.mktemp("half")
    for name in os.listdir(files["train_data_path"]):
        with h5py.File(os.path.join(files["train_data_path"], name), "r") as src, h5py.File(root / name, "w") as dst:
            dst.create_dataset("fields", data=src["fields"][...].astype(np.float16))
            dst.create_dataset("timestamp", data=src["timestamp"][...])
    return dict(files, train_data_path=str(root))


def _params(files, **overrides):
    base = dict(
        channel_names=list(CHANNEL_NAMES), n_history=0, n_future=0, dt=1, dhours=6, add_zenith=True, valid_autoreg_steps=1, batch_size=3, seed=7,
        normalization={"q700": "minmax"}, **files,
    )
    base.update(overrides)
    port, ref = ParamsBase(copy.deepcopy(base)), JParamsBase(copy.deepcopy(base))
    parse_dataset_metadata(files["metadata_json_path"], port)
    jparse(files["metadata_json_path"], ref)
    return port, ref


def test_hdf5_reads_what_h5py_writes(tmp_path):
    r = np.random.default_rng(0)
    arrays = {"fields": r.standard_normal((3, 2, 4, 5)).astype(np.float32), "timestamp": np.arange(3, dtype=np.int64) * 21600,
              "half": r.standard_normal(6).astype(np.float16), "counts": np.arange(4, dtype=np.uint16), "channel": np.array(["u10m", "t2m"], dtype="S")}
    path = str(tmp_path / "a.h5")
    with h5py.File(path, "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
        f["fields"].attrs["units"] = "K"
        f.create_group("sub").create_dataset("x", data=np.arange(5.0))
    got = hdf5.File(path)
    assert sorted(got.keys()) == sorted([*arrays, "sub/x"])
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and np.array_equal(got[k][...], v), k
    assert np.array_equal(got["sub/x"][...], np.arange(5.0))
    with h5py.File(path, "r") as f:
        assert got["fields"].offset == f["fields"].id.get_offset()


def test_hdf5_h5py_reads_what_it_writes(tmp_path):
    r = np.random.default_rng(1)
    # 20 datasets: more than one symbol-table node
    arrays = {f"d{i:02d}": r.standard_normal((2, 3)).astype(np.float32) for i in range(20)}
    arrays.update(mean=r.standard_normal((2, 5, 4, 8)), ts=np.arange(7, dtype=np.int64), channel=np.array(["u10m", "z500", "q700"], dtype="S"))
    path = str(tmp_path / "b.h5")
    hdf5.write(path, arrays)
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(arrays)
        for k, v in arrays.items():
            assert f[k].dtype == v.dtype and np.array_equal(f[k][...], v), k
    maps = hdf5.File.create(str(tmp_path / "c.h5"), {"fields": ((2, 3, 4), np.float32), "channel": ((2,), "S4")})
    maps["fields"][1] = 2.5
    maps["channel"][:] = np.array([b"ab", b"cdef"])
    for m in maps.values():
        m.flush()
    with h5py.File(str(tmp_path / "c.h5"), "r") as f:
        assert f["fields"][...].sum() == 2.5 * 12 and list(f["channel"][...]) == [b"ab", b"cdef"]


def test_hdf5_raises_on_chunked_and_compressed(tmp_path):
    for kw in (dict(chunks=(1, 4)), dict(compression="gzip")):
        path = str(tmp_path / "z.h5")
        with h5py.File(path, "w") as f:
            f.create_dataset("fields", data=np.zeros((3, 4), np.float32), **kw)
        with pytest.raises(NotImplementedError):
            hdf5.File(path)


def test_metadata_defaults_and_shapes_match_jax(files):
    port, ref = _params(files)
    for key in ("h5_path", "dhours", "img_shape_x", "img_shape_y", "data_channel_names", "in_channels", "out_channels", "data_grid_type"):
        assert port[key] == ref[key], key
    assert np.array_equal(port["lat"], ref["lat"]) and np.array_equal(port["lon"], ref["lon"])
    d, jd = driver.set_default_parameters(ParamsBase({"channel_names": ["a", "b"]})), jdriver.set_default_parameters(JParamsBase({"channel_names": ["a", "b"]}))
    assert d.to_dict() == jd.to_dict()
    for extra in ({}, {"n_history": 1, "input_noise": {"n_channels": 8}}, {"add_landmask": True, "add_orography": True}):
        p, jp = _params(files, **extra)
        assert {k: driver.derive_data_shapes(p)[k] for k in ("N_in_channels", "N_out_channels")} == {k: jdriver.derive_data_shapes(jp)[k] for k in ("N_in_channels", "N_out_channels")}


def test_climatology_matches_jax(files):
    port, ref = _params(files, out_channels=[3, 0, 4])
    assert np.array_equal(data_helpers.get_time_means(port), jhelpers.get_time_means(ref))
    assert np.array_equal(data_helpers.get_climatology(port), jhelpers.get_climatology(ref))
    none, jnone = _params(files, time_means_path=None)
    assert data_helpers.get_climatology(none) is None and jhelpers.get_climatology(jnone) is None


@pytest.mark.parametrize(
    "case",
    [dict(), dict(n_history=1, n_future=1), dict(add_zenith=False, crop_size_x=8, crop_anchor_x=4, crop_size_y=24, crop_anchor_y=2)],
    ids=["plain", "history-future", "crop"],
)
@pytest.mark.parametrize("train", [True, False], ids=["train", "valid"])
@pytest.mark.parametrize("stored", ["files", "half_files"], ids=["fp32", "fp16"])
def test_multifiles_samples_bit_equal_to_jax(request, stored, case, train):
    files = request.getfixturevalue(stored)
    port, ref = _params(files, **case)
    ds, jds = MultifilesDataset(port, files["train_data_path"], train=train), JMultifilesDataset(ref, files["train_data_path"], train=train)
    assert len(ds) == len(jds) and ds.img_shape == jds.img_shape
    for idx in range(len(ds)):
        s, js = ds[idx], jds[idx]
        assert sorted(s) == sorted(js)
        for k in s:
            assert s[k].dtype == js[k].dtype and np.array_equal(s[k], js[k]), (idx, k)
        assert ds.base_timestamp(idx) == jds.base_timestamp(idx) and ds.target_timestamps(idx) == jds.target_timestamps(idx)
    when = np.datetime64(ds.base_timestamp(len(ds) - 1), "s")
    assert ds.get_sample_at_time(when) == jds.get_sample_at_time(when) == len(ds) - 1
    assert set(ds.timings) == {"read", "normalize", "zenith"} and ds.timings["read"] > 0


def test_batches_and_order_bit_equal_to_jax(files):
    port, ref = _params(files, n_future=1)
    ds, jds = MultifilesDataset(port, files["train_data_path"]), JMultifilesDataset(ref, files["train_data_path"])
    it, jit = BatchIterator(ds, 3, seed=7), JBatchIterator(jds, 3, seed=7)
    # two passes (the epoch advances), then pinned back to epoch 1
    for epoch in (None, None, 1):
        if epoch is not None:
            it.set_epoch(epoch)
            jit.set_epoch(epoch)
        got, ref_batches = list(it), list(jit)
        assert len(got) == len(ref_batches) == len(it) == len(jit)
        for b, jb in zip(got, ref_batches):
            assert sorted(b) == sorted(jb) and all(np.array_equal(b[k], jb[k]) for k in b)
    assert it.epoch == jit.epoch == 2
    # stacked into given buffers: the same batch
    samples = [ds[i] for i in (0, 5, 2)]
    bufs = {}
    staged = _assemble(samples, lambda key, shape: bufs.setdefault(key, np.empty(shape, np.float32)))
    plain = _assemble(samples)
    assert all(np.array_equal(staged[k], plain[k]) for k in plain) and staged["inp"].base is bufs["inp"]


def test_device_batches_on_cpu_and_loader_options(files):
    port, _ = _params(files)
    loader, ds = get_dataloader(port, files["train_data_path"])
    loader.set_epoch(3)
    ref = list(loader)
    batches = DeviceBatches(loader, "cpu")
    batches.set_epoch(3)
    got = list(batches)
    assert len(got) == len(ref)
    for b, rb in zip(got, ref):
        assert all(isinstance(v, torch.Tensor) and np.array_equal(v.numpy(), rb[k]) for k, v in b.items())
    stats = batches.stats()
    assert stats["batches"] == len(ref) and stats["read_s"] > 0 and stats["copy_ms"] == 0
    grain, _ = _params(files, data_loader_config="grain")
    with pytest.raises(NotImplementedError, match="grain"):
        get_dataloader(grain, files["train_data_path"])
    # the native reader (tests/test_torch_native_reader.py) gives the same batches
    os.environ["MAKANI_NATIVE_READER"] = "1"
    try:
        native, nds = get_dataloader(port, files["train_data_path"])
    finally:
        del os.environ["MAKANI_NATIVE_READER"]
    native.set_epoch(3)
    assert nds.native and all(all(np.array_equal(b[k], rb[k]) for k in rb) for b, rb in zip(native, ref))


def test_synthetic_dataset_bit_equal_to_jax():
    cfg = dict(img_shape_x=8, img_shape_y=16, in_channels=[0, 1, 2], out_channels=[0, 1, 2], n_future=1, add_zenith=True, n_train_samples_per_epoch=4, seed=5)
    ds, jds = DummyDataset(ParamsBase(dict(cfg))), JDummyDataset(JParamsBase(dict(cfg)))
    assert len(ds) == len(jds) == 4
    for i in range(4):
        s, js = ds[i], jds[i]
        assert all(np.array_equal(s[k], js[k]) for k in js)
