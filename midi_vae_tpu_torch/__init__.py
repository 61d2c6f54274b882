"""PyTorch + CUDA port of midi_vae_tpu, for one NVIDIA H100.

The layout follows ``midi_vae_tpu``: ``models/`` (cells, RNN scans, the VAE
and its loss), ``ops/`` (the hand-written CUDA kernels in ``csrc/`` with their
plain PyTorch versions and autograd Functions), ``evaluation/`` (generation
and post-processing), ``training/`` (trainer, optimizers, checkpoints),
``cli/transfer.py``, ``cli/train.py`` and ``tools/`` (card profilers). The
numpy-only modules of the JAX package (config, data, utils.music) are
imported, not copied; this package never imports jax.
"""

import torch


def use_exact_f32() -> None:
    """Full-f32 matmuls: the port runs in float32 only, with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
