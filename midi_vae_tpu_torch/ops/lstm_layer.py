"""Kernel L: one whole LSTM layer forward with the x-projection in the kernel.

Counterpart of ``midi_vae_tpu/ops/fused_train.py::lstm_layer_infer_x``, whose
Pallas kernels ``_lstm_fwdx_kernel`` (the h sequence) and
``_lstm_fwdx_last_kernel`` (the final h) the CUDA kernel
``csrc/lstm_layer_fwd.cu`` replaces; its source note gives the layout and
what bounds it. ``lstm_layer_reference`` is the plain PyTorch version
(``_lstm_layer_reference_x``): the CPU path and the kernel's oracle. Gate
order i, f, g, o; ``activation`` acts on g and on c
(``midi_vae_tpu/ops/fused_lstm.py::_lstm_gates``).

``lstm_layer`` takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises. As in the JAX package (``_lstm_x_use_pallas``),
the model sends cells other than tanh to the plain scan on any device
(``models/rnn.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, _layout
from .gru_layer import CELL_ACTIVATIONS, _ptr, cell_activation, check_operands


def lstm_step(xp, h, c, u, act):
    """One LSTM step over its x-projection xp = x @ W + b (B, 4H): returns
    (h', c')."""
    H = h.shape[-1]
    gates = xp + h @ u
    i = torch.sigmoid(gates[:, :H])
    f = torch.sigmoid(gates[:, H : 2 * H])
    g = act(gates[:, 2 * H : 3 * H])
    o = torch.sigmoid(gates[:, 3 * H :])
    c = f * c + i * g
    return o * act(c), c


def lstm_layer_reference(x, h0, c0, w, b, u, activation="tanh", return_sequences=False):
    """Plain version: x (T, B, D) -> (T, B, H) h sequence or final h (B, H)."""
    T, B, D = x.shape
    act = cell_activation(activation)
    xp = (x.reshape(T * B, D) @ w + b).reshape(T, B, -1)
    h, c = h0, c0
    seq = []
    for t in range(T):
        h, c = lstm_step(xp[t], h, c, u, act)
        if return_sequences:
            seq.append(h)
    return torch.stack(seq) if return_sequences else h


@functools.cache
def _kernel():
    lib = _build.load("lstm_layer_fwd")
    fn = lib.mvt_lstm_layer_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def lstm_layer(x, h0, c0, w, b, u, activation="tanh", return_sequences=False):
    """LSTM layer forward, x (T, B, D) time-major.

    Returns the (T, B, H) h sequence when ``return_sequences`` else the final
    h (B, H). CPU tensors run ``lstm_layer_reference``; CUDA tensors launch
    kernel L."""
    if activation not in CELL_ACTIVATIONS:
        raise ValueError(f"unsupported LSTM kernel activation {activation!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be (T, B, D), got {tuple(x.shape)}")
    T, B, D = x.shape
    H = u.shape[0]
    named = {"x": x, "h0": h0, "c0": c0, "w": w, "b": b, "u": u}
    expected = {"h0": (B, H), "c0": (B, H), "w": (D, 4 * H), "b": (4 * H,), "u": (H, 4 * H)}
    for name, shape in expected.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, expected {shape}")
    if x.device.type == "cpu":
        return lstm_layer_reference(x, h0, c0, w, b, u, activation, return_sequences)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_layer runs on cpu or cuda tensors, not {x.device}")
    check_operands(named, x.device)
    if T < 1 or B < 1:
        raise ValueError(f"kernel L takes T >= 1 and B >= 1; got T={T} B={B}")
    _layout.require("L", H, _layout.smem_bytes("L", H, D))
    out = torch.empty((T, B, H) if return_sequences else (B, H), device=x.device,
                      dtype=torch.float32)
    lib, fn = _kernel()
    rc = fn(
        _ptr(x), _ptr(h0), _ptr(c0), _ptr(w), _ptr(b), _ptr(u), _ptr(out),
        T, B, D, H, CELL_ACTIVATIONS[activation], int(return_sequences),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _build.check(lib, rc, "lstm_layer_fwd launch")
    lstm_layer.launches += 1
    return out


lstm_layer.launches = 0
