"""makani_torch: the PyTorch/CUDA port of makani_tpu for NVIDIA Hopper.

The package mirrors ``makani_tpu``'s module paths and class names so each
counterpart is easy to find, and keeps the JAX package's parameter names and
shapes so ``convert_jax.params_from_jax`` is a rename. It imports ``torch``
and never ``jax``.

Every op that ``makani_tpu`` shaped by hand for the TPU is a hand-written
Hopper kernel here (CUDA C++, ``csrc/*.cu``, built by ``kernels.py``), with a
plain PyTorch version of the same function beside it. A kernel wrapper takes
the plain version only for a CPU tensor; on a CUDA tensor it launches its
kernel or raises.
"""

__version__ = "0.1.0"
