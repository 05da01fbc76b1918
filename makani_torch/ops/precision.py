"""Transform precision policy (counterpart of ``makani_tpu/ops/precision.py``).

The same policy names, environment variable and default as the JAX package:
``MAKANI_TRANSFORM_PRECISION`` in {highest, high, default}, default
``highest``, or ``set_transform_precision``.

What the policy selects here is the dtype the model feeds the spectral
transforms: fp32 under ``highest`` and ``high``, bf16 under ``default``. The
Legendre and dhconv kernels accumulate in fp32 for either input dtype, so the
fp32 contractions compute at least what ``high`` (bf16x3 on the TPU) asks for.

``fp32_exact`` is the port's local guard for fp32 library calls: cuDNN
convolutions run in TF32 by default and cuBLAS GEMMs do where a caller set
``torch.backends.cuda.matmul.allow_tf32``, while the JAX package's fp32
contractions (and the kernels' fp32 gates) are exact fp32.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["set_transform_precision", "transform_precision", "transform_io_dtype", "maybe_cast_table", "fp32_exact"]

_PRECISIONS = ("highest", "high", "default")

_current = os.environ.get("MAKANI_TRANSFORM_PRECISION", "highest").lower()


def set_transform_precision(name: str):
    global _current
    if name.lower() not in _PRECISIONS:
        raise ValueError(f"unknown precision {name}; options: {list(_PRECISIONS)}")
    _current = name.lower()


def transform_precision() -> str:
    return _current


def transform_io_dtype() -> torch.dtype:
    """Dtype the model should feed the spectral transforms: bf16 under
    ``default``, fp32 otherwise (as in the JAX package)."""
    return torch.bfloat16 if _current == "default" else torch.float32


def maybe_cast_table(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cast an fp32 transform table to bf16 for bf16 input, so the
    contraction stays bf16-in/bf16-out with fp32 accumulation."""
    if x.dtype == torch.bfloat16:
        return table.to(torch.bfloat16)
    return table


@contextlib.contextmanager
def fp32_exact():
    """Run the enclosed cuBLAS and cuDNN calls in full fp32 (no TF32),
    whatever the global flags say, and restore the flags found on exit."""
    matmul, cudnn = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = cudnn
