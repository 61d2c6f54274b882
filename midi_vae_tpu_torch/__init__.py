"""PyTorch + CUDA port of midi_vae_tpu, for one NVIDIA H100.

The layout follows ``midi_vae_tpu``: ``config.py``, ``data/`` and ``utils/``
(copies of the JAX package's numpy-only modules), ``models/`` (cells, RNN
scans, the VAE and its loss, the style judges), ``ops/`` (the hand-written
CUDA kernels in ``csrc/`` with their plain PyTorch versions and autograd
Functions), ``evaluation/`` (generation and post-processing), ``training/``
(trainer, optimizers, checkpoints), ``cli/transfer.py``, ``cli/train.py`` and
``tools/`` (card profilers). This package imports neither jax nor anything of
``midi_vae_tpu`` (``tests/test_torch_isolation.py``); its functions that take a
``Config`` also accept the JAX package's, which is field-equal.
"""

import torch


def use_exact_f32() -> None:
    """Full-f32 matmuls: the port runs in float32 only, with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
