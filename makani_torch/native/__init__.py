"""The native pread block reader (``reader.cpp``), bound with ctypes
(counterpart of ``makani_tpu/native``).

``read_blocks`` reads byte blocks of a file into a numpy buffer with POSIX
``pread`` on a pool of threads, outside the GIL. The source is compiled at
first use with ``g++ -O3 -shared -fPIC -pthread`` into
``<checkout>/build/makani_torch_native/libreader_<hash>.so``, the hash taken over the source and the flags, so an
edited source is rebuilt. Unlike the JAX package, nothing here falls back:
a missing compiler, a failed build and a failed read raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["build", "library", "read_blocks"]

_SRC = Path(__file__).resolve().parent / "reader.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None


def build_dir() -> Path:
    return _SRC.parents[2] / "build" / "makani_torch_native"


def _compiler() -> str:
    path = shutil.which(CXX)
    if path is None:
        raise RuntimeError(f"C++ compiler {CXX!r} not found; the native reader cannot be built")
    return path


def build() -> Path:
    """Compile ``reader.cpp`` into the hashed shared library unless it
    exists; returns its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    out_dir = build_dir()
    so = out_dir / f"libreader_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = _compiler()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{so.name}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp)], capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native reader failed (exit code {res.returncode}):\n{res.stderr[-3000:]}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded reader, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u64p = ctypes.POINTER(ctypes.c_uint64)
            lib.mk_read_blocks.restype = ctypes.c_int
            lib.mk_read_blocks.argtypes = [ctypes.c_char_p, u64p, u64p, ctypes.c_void_p, u64p, ctypes.c_int64, ctypes.c_int]
            _lib = lib
    return _lib


def read_blocks(path: str, offsets, sizes, out: np.ndarray, dest_offsets, nthreads: int = 0) -> None:
    """Read ``len(offsets)`` blocks from ``path`` into ``out``: block i is
    ``sizes[i]`` bytes at file offset ``offsets[i]``, written at byte
    ``dest_offsets[i]`` of ``out`` (uint64 arrays). ``out`` must be a
    writable C-contiguous array that holds every block. Raises OSError on a
    failed read, a missing file or a file shorter than a block."""
    offsets = np.ascontiguousarray(offsets, np.uint64)
    sizes = np.ascontiguousarray(sizes, np.uint64)
    dest_offsets = np.ascontiguousarray(dest_offsets, np.uint64)
    if not (out.flags["C_CONTIGUOUS"] and out.flags["WRITEABLE"]):
        raise ValueError("read_blocks needs a writable C-contiguous destination")
    if not len(offsets) == len(sizes) == len(dest_offsets):
        raise ValueError("offsets, sizes and dest_offsets differ in length")
    if len(offsets) and int((dest_offsets + sizes).max()) > out.nbytes:
        raise ValueError(f"the blocks reach past the destination's {out.nbytes} bytes")
    lib = library()
    u64p = ctypes.POINTER(ctypes.c_uint64)
    rc = lib.mk_read_blocks(
        os.fsencode(path), offsets.ctypes.data_as(u64p), sizes.ctypes.data_as(u64p), out.ctypes.data, dest_offsets.ctypes.data_as(u64p), len(offsets), nthreads
    )
    if rc != 0:
        raise OSError(rc, f"native read failed: {os.strerror(rc)}", path)
