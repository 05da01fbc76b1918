"""Build, load and count the port's hand-written CUDA kernels.

The CUDA C++ sources under ``csrc/`` have a plain C interface. They are
compiled at first use with ``nvcc`` for ``sm_90a``, one compiler process a
source, all started together, and linked into one shared library under
``<checkout>/build/makani_torch_kernels/``, loaded with ``ctypes``.
The library's file name carries a hash of the sources and flags, so an edited
source is rebuilt and a fresh checkout builds on its first call.

Every kernel wrapper in the package adds one to its entry in ``LAUNCHES``
where it launches its kernel, and nowhere else, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "reset_launch_counts", "count_launch", "build", "library", "check_launch", "dtype_code", "stream_ptr", "takes_plain", "set_use_kernels"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = (
    "sht_legendre.cu",
    "dhconv.cu",
    "dhconv_grad.cu",
    "instance_norm.cu",
    "adam_factored.cu",
    "adam.cu",
    "grad_norm.cu",
    "disco_band.cu",
    "disco_band_grad.cu",
    "disco_polar.cu",
    "disco_mix.cu",
    "resample.cu",
    "resample_grad.cu",
    "crps.cu",
    "afno_mixer.cu",
    "afno_mixer_grad.cu",
)
_HEADERS = ("convert.cuh", "sm90.cuh", "afno.cuh")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

LAUNCHES = {
    "sht_analysis": 0,
    "sht_synthesis": 0,
    "dhconv": 0,
    "instance_norm": 0,
    "disco_band": 0,
    "disco_polar": 0,
    "disco_mix": 0,
    "resample": 0,
    "sht_analysis_grad": 0,
    "sht_synthesis_grad": 0,
    "dhconv_grad_input": 0,
    "dhconv_grad_weight": 0,
    "instance_norm_grad": 0,
    "adam_factored": 0,
    "disco_band_grad": 0,
    "disco_polar_grad": 0,
    "resample_grad": 0,
    "crps": 0,
    "grad_norm": 0,
    "adam": 0,
    "afno_mixer": 0,
    "afno_mixer_grad": 0,
}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str):
    LAUNCHES[name] += 1


def build_dir() -> Path:
    return _CSRC.parents[1] / "build" / "makani_torch_kernels"


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path}); the CUDA kernels cannot be built")
    return path


def build() -> Path:
    """Compile ``csrc/*.cu`` into the hashed shared library unless it exists;
    returns its path. The sources compile in parallel, one ``nvcc`` each; the
    compilers' output (``-Xptxas -v``: registers, shared memory, spills per
    kernel) is kept beside the library in a ``.log`` file."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libmakani_torch_{_source_hash()}.so"
    if so.exists():
        return so
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    jobs = []
    for src in _SOURCES:
        obj = out_dir / f"{tag}.{Path(src).stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(_CSRC / src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, obj, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]}: exit code {proc.returncode}\n{err[-3000:]}")
    tmp = out_dir / f"{tag}.so.tmp"
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link: exit code {res.returncode}\n{res.stderr[-3000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, so)
    return so


_LIB = None
_LIB_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.mt_legendre_contract.argtypes = [i, vp, vp, vp, i, i, i, i, i, i, vp]
            lib.mt_legendre_contract.restype = i
            lib.mt_legendre_analysis_tc.argtypes = [vp, vp, vp] + [i] * 7 + [vp]
            lib.mt_legendre_analysis_tc.restype = i
            lib.mt_legendre_synthesis_tc.argtypes = [vp, vp, vp] + [i] * 7 + [vp]
            lib.mt_legendre_synthesis_tc.restype = i
            lib.mt_legendre_synthesis_narrow.argtypes = [vp, vp, vp] + [i] * 5 + [vp]
            lib.mt_legendre_synthesis_narrow.restype = i
            lib.mt_dhconv_contract.argtypes = [i, vp, vp, vp, i, i, i, i, i, i, vp]
            lib.mt_dhconv_contract.restype = i
            lib.mt_dhconv_grad_input.argtypes = [i, vp, vp, vp, i, i, i, i, i, i, vp]
            lib.mt_dhconv_grad_input.restype = i
            lib.mt_disco_band_contract.argtypes = [vp, vp, vp, vp, vp, i, i, i, ll, ll, ll, ll] + [i] * 14 + [ll, vp]
            lib.mt_disco_band_contract.restype = i
            lib.mt_disco_band_route.argtypes = [i] * 8 + [ctypes.POINTER(ll)]
            lib.mt_disco_band_route.restype = i
            lib.mt_instance_norm.argtypes = [i, i] + [vp] * 6 + [i] * 8 + [ctypes.c_float, vp]
            lib.mt_instance_norm.restype = i
            lib.mt_instance_norm_grad.argtypes = [i, i] + [vp] * 8 + [i] * 9 + [vp]
            lib.mt_instance_norm_grad.restype = i
            lib.mt_dhconv_grad_weight.argtypes = [i, vp, vp, vp, i, i, i, i, i, i, vp]
            lib.mt_dhconv_grad_weight.restype = i
            f = ctypes.c_float
            lib.mt_adam_factored_scratch.argtypes = [i] * 5
            lib.mt_adam_factored_scratch.restype = ll
            lib.mt_adam_factored.argtypes = [i, i, ctypes.POINTER(ll), ctypes.POINTER(f), i] + [f] * 6 + [vp]
            lib.mt_adam_factored.restype = i
            lib.mt_adam_unfactored.argtypes = [i, ctypes.POINTER(ll), ctypes.POINTER(f), i] + [f] * 8 + [vp]
            lib.mt_adam_unfactored.restype = i
            lib.mt_adam.argtypes = [i, ctypes.POINTER(ll), ctypes.POINTER(f), i] + [f] * 8 + [vp]
            lib.mt_adam.restype = i
            lib.mt_grad_norm_blocks.argtypes = [ll]
            lib.mt_grad_norm_blocks.restype = ll
            lib.mt_grad_norm.argtypes = [i, ctypes.POINTER(ll), i, vp, i, i, i, vp, vp, f, vp]
            lib.mt_grad_norm.restype = i
            lib.mt_disco_mix.argtypes = [vp, ll, vp, vp] + [i] * 5 + [vp]
            lib.mt_disco_mix.restype = i
            lib.mt_disco_polar.argtypes = [i, vp, vp, vp, i, i, i, i, i, i, vp]
            lib.mt_disco_polar.restype = i
            lib.mt_resample.argtypes = [i] + [vp] * 7 + [i] * 5 + [ll] * 4 + [i, i, vp]
            lib.mt_resample.restype = i
            lib.mt_disco_band_grad.argtypes = [vp] * 7 + [i] * 17 + [ll, i, vp]
            lib.mt_disco_band_grad.restype = i
            lib.mt_resample_grad.argtypes = [vp] * 5 + [i] * 17 + [vp]
            lib.mt_resample_grad.restype = i
            lib.mt_crps_skillspread.argtypes = [i, vp, vp, vp, vp, i, i, ll, f, vp]
            lib.mt_crps_skillspread.restype = i
            lib.mt_afno_mixer.argtypes = [vp] * 7 + [ctypes.POINTER(ll)] + [i] * 6 + [ll] * 3 + [i] * 5 + [f, vp]
            lib.mt_afno_mixer.restype = i
            lib.mt_afno_mixer_grad.argtypes = [vp] * 6 + [ctypes.POINTER(ll)] + [vp] * 7 + [i] * 7 + [ll] * 6 + [i] * 5 + [vp]
            lib.mt_afno_mixer_grad.restype = i
            lib.mt_afno_grad_scratch.argtypes = [i] * 5
            lib.mt_afno_grad_scratch.restype = ll
            lib.mt_resample_smem_bytes.argtypes = [i] * 3
            lib.mt_resample_smem_bytes.restype = i
            lib.mt_error_string.argtypes = [i]
            lib.mt_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def check_launch(err: int, name: str):
    """Raise if a kernel's C entry point returned a CUDA error (its
    ``cudaGetLastError()`` right after the launch, or an argument error)."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: {library().mt_error_string(err).decode()} (code {err})")


def dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16 tensors, got {dtype}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def takes_plain(name: str, *tensors: torch.Tensor) -> bool:
    """Decide a wrapper's route from where its tensors lie: True for the plain
    version (all on the CPU), False for the kernel (all on one CUDA device).
    Anything else raises; a CUDA tensor never takes the plain version."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors lie on different devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel for device {dev}")


def set_use_kernels(module: torch.nn.Module, flag: bool):
    """Route every kernel-holding submodule of ``module`` through its kernel
    wrappers (True, the default) or straight through the plain PyTorch
    versions (False): the reference path a comparison on the card runs."""
    for m in module.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = flag
