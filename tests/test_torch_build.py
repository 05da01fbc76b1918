"""makani_torch.kernels on the CPU: where the library is built, how its name
follows the sources, and how a wrapper picks its route."""

import os
import shutil

import pytest
import torch

from makani_torch import kernels
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _has_nvcc():
    return shutil.which("nvcc") is not None or os.path.isfile(os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"))


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources in a scratch checkout."""
    path = tmp_path / "makani_torch" / "csrc"
    shutil.copytree(kernels._CSRC, path)
    monkeypatch.setattr(kernels, "_CSRC", path)
    return path


def test_build_without_nvcc_raises(csrc):
    if _has_nvcc():
        pytest.skip("nvcc is installed here; the build would run")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def test_library_name_follows_sources(csrc, tmp_path):
    h0 = kernels._source_hash()
    assert h0 == kernels._source_hash()
    assert kernels.build_dir() == tmp_path / "build" / "makani_torch_kernels"
    (csrc / "convert.cuh").write_text((csrc / "convert.cuh").read_text() + "\n// edited\n")
    assert kernels._source_hash() != h0


def test_route_follows_device():
    cpu = torch.zeros(2)
    assert kernels.takes_plain("k", cpu, cpu)
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.takes_plain("k", cpu.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        kernels.takes_plain("k", cpu, cpu.to("meta"))
    assert kernels.dtype_code(torch.float32) == 0 and kernels.dtype_code(torch.bfloat16) == 1
    with pytest.raises(TypeError):
        kernels.dtype_code(torch.float16)


def test_launch_counts_reset():
    kernels.count_launch("dhconv")
    assert kernels.LAUNCHES["dhconv"] >= 1
    kernels.reset_launch_counts()
    assert set(kernels.LAUNCHES) == {
        "sht_analysis",
        "sht_synthesis",
        "dhconv",
        "instance_norm",
        "disco_band",
        "disco_polar",
        "disco_mix",
        "resample",
        "sht_analysis_grad",
        "sht_synthesis_grad",
        "dhconv_grad_input",
        "dhconv_grad_weight",
        "instance_norm_grad",
        "adam_factored",
        "disco_band_grad",
        "disco_polar_grad",
        "resample_grad",
        "crps",
        "grad_norm",
        "adam",
        "afno_mixer",
        "afno_mixer_grad",
    }
    assert not any(kernels.LAUNCHES.values())
