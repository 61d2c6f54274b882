"""The serving kernels as registered PyTorch operators, namespace ``mvt``.

``torch.export`` traces a model with fake tensors, which have no data
pointer, so a kernel launched through ctypes from the traced Python cannot
be exported. Each serving wrapper therefore calls an operator registered
here, and the operator holds the launch code:

  * ``mvt::gru_layer``   kernel A (``ops/gru_layer.py``: its pre-pass and
                         chain, or its per-block route);
  * ``mvt::gru_decode``  kernel B (``ops/gru_decode.py``);
  * ``mvt::lstm_layer``  kernel L (``ops/lstm_layer.py``), returning [h] or,
                         with ``with_c``, [h sequence, c sequence];
  * ``mvt::lstm_decode`` kernel M (``ops/lstm_decode.py``).

Each has three implementations, kept in its kernel's module: the CPU one
(the plain version), the CUDA one (the launch code: everything that reads a
data pointer, packs a weight slice or asks the card for its limits runs
there, never in traced code) and the fake one (the outputs' shapes and
dtypes, after the same checks). The live path, an exported program
(``serving.py``) and the CPU tests thus run one operator. A decode head's
list of layer dicts is flattened into tensors (``decode_operands``): a
1-layer head passes None for layer 2, and a chain plan travels as its
fields or None. No operator mutates an input, and no output aliases an
input or another output. No autograd formula is registered: the training
path differentiates through its own ``torch.autograd.Function``s, whose
forwards call these operators with grad off.

Importing ``midi_vae_tpu_torch.ops`` imports this module, which registers
the operators; the kernels build at first use on the card, as before.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from . import gru_decode as _gd
from . import gru_layer as _gl
from . import lstm_decode as _ld
from . import lstm_layer as _ll

NAMESPACE = "mvt"


@torch.library.custom_op(f"{NAMESPACE}::gru_layer", mutates_args=(), device_types="cpu")
def gru_layer(x: Tensor, h0: Tensor, w: Tensor, b: Tensor, u: Tensor, activation: str,
              return_sequences: bool) -> Tensor:
    return _gl.gru_layer_cpu(x, h0, w, b, u, activation, return_sequences)


@torch.library.custom_op(f"{NAMESPACE}::lstm_layer", mutates_args=(), device_types="cpu")
def lstm_layer(x: Tensor, h0: Tensor, c0: Tensor, w: Tensor, b: Tensor, u: Tensor,
               activation: str, return_sequences: bool, with_c: bool) -> list[Tensor]:
    return _ll.lstm_layer_cpu(x, h0, c0, w, b, u, activation, return_sequences, with_c)


@torch.library.custom_op(f"{NAMESPACE}::gru_decode", mutates_args=(), device_types="cpu")
def gru_decode(start: Tensor, h1: Tensor, w1: Tensor, u1: Tensor, b1: Tensor,
               h2: Optional[Tensor], w2: Optional[Tensor], u2: Optional[Tensor],
               b2: Optional[Tensor], wo: Tensor, bo: Tensor, T: int, activation: str,
               out_activation: str, plan: Optional[list[int]]) -> tuple[Tensor, Tensor]:
    return _gd.gru_decode_cpu(start, h1, w1, u1, b1, h2, w2, u2, b2, wo, bo, T, activation,
                              out_activation, plan)


@torch.library.custom_op(f"{NAMESPACE}::lstm_decode", mutates_args=(), device_types="cpu")
def lstm_decode(start: Tensor, h1: Tensor, c1: Tensor, w1: Tensor, u1: Tensor, b1: Tensor,
                h2: Optional[Tensor], c2: Optional[Tensor], w2: Optional[Tensor],
                u2: Optional[Tensor], b2: Optional[Tensor], wo: Tensor, bo: Tensor, T: int,
                activation: str, out_activation: str,
                plan: Optional[list[int]]) -> tuple[Tensor, Tensor]:
    return _ld.lstm_decode_cpu(start, h1, c1, w1, u1, b1, h2, c2, w2, u2, b2, wo, bo, T,
                               activation, out_activation, plan)


# op -> (its CUDA implementation, its fake implementation)
OPS = {gru_layer: (_gl.gru_layer_cuda, _gl.gru_layer_fake),
       lstm_layer: (_ll.lstm_layer_cuda, _ll.lstm_layer_fake),
       gru_decode: (_gd.gru_decode_cuda, _gd.gru_decode_fake),
       lstm_decode: (_ld.lstm_decode_cuda, _ld.lstm_decode_fake)}
for _op, (_cuda, _fake) in OPS.items():
    _op.register_kernel("cuda")(_cuda)
    _op.register_fake(_fake)
