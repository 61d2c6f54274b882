"""Hand-written CUDA kernels with their plain PyTorch versions.

Importing the package registers the serving kernels' operators (``mvt::``,
``_custom.py``), which the wrappers of kernels A, B, L and M call."""

from . import _custom  # noqa: F401
