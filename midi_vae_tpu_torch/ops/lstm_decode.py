"""Kernel M: a whole autoregressive LSTM decode head in one kernel.

Counterpart of ``midi_vae_tpu/ops/fused_lstm.py::fused_lstm_decode_scan``,
whose Pallas kernels ``_decode_kernel_2layer`` and ``_decode_kernel_1layer``
the CUDA kernel ``csrc/lstm_decode.cu`` replaces; its source note gives the
layout and what bounds it. ``lstm_decode_reference`` is the plain PyTorch
version (``_decode_scan_reference``): the CPU path and the kernel's oracle.

``lstm_decode`` takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, _layout
from .gru_decode import OUT_ACTIVATIONS, out_activation_fn
from .gru_layer import CELL_ACTIVATIONS, _ptr, cell_activation, check_operands
from .lstm_layer import lstm_step


def lstm_decode_reference(cell_params, out_dense, init_states, start, T, activation="tanh",
                          out_activation="softmax"):
    """Plain version: ``init_states`` one (h, c) per layer. Returns (probs,
    logits), each (T, B, D) time-major."""
    act = cell_activation(activation)
    out_act = out_activation_fn(out_activation)
    states = list(init_states)
    x = start
    probs, logits = [], []
    for _ in range(T):
        for i, p in enumerate(cell_params):
            h, c = states[i]
            x, c = lstm_step(x @ p["w"] + p["b"], h, c, p["u"], act)
            states[i] = (x, c)
        lg = x @ out_dense["w"] + out_dense["b"]
        x = out_act(lg)
        probs.append(x)
        logits.append(lg)
    return torch.stack(probs), torch.stack(logits)


@functools.cache
def _kernel():
    lib = _build.load("lstm_decode")
    fn = lib.mvt_lstm_decode
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def lstm_decode(cell_params, out_dense, init_states, start, T, activation="tanh",
                out_activation="softmax"):
    """Readout decode of one head: ``cell_params`` a list of 1 or 2 LSTM
    layer params {w, u, b}, ``out_dense`` {w, b}, ``init_states`` one (h, c)
    pair of (B, H) per layer, ``start`` (B, D) the input of step 0. Returns
    (probs, logits), each (T, B, D). CPU tensors run
    ``lstm_decode_reference``; CUDA tensors launch kernel M."""
    n_layers = len(cell_params)
    if n_layers not in (1, 2) or len(init_states) != n_layers:
        raise ValueError(f"kernel M decodes 1- or 2-layer heads with one (h, c) per layer, got "
                         f"{n_layers} layers and {len(init_states)} states")
    if activation not in CELL_ACTIVATIONS:
        raise ValueError(f"unsupported LSTM kernel activation {activation!r}")
    if out_activation not in OUT_ACTIVATIONS:
        raise ValueError(f"unsupported decode output activation {out_activation!r}")
    B, D = start.shape
    H = init_states[0][0].shape[-1]
    named = {"start": start, "wo": out_dense["w"], "bo": out_dense["b"]}
    expected = {"start": (B, D), "wo": (H, D), "bo": (D,)}
    for i, (p, (h, c)) in enumerate(zip(cell_params, init_states)):
        d_in = D if i == 0 else H
        k = i + 1
        named.update({f"w{k}": p["w"], f"u{k}": p["u"], f"b{k}": p["b"], f"h{k}": h, f"c{k}": c})
        expected.update({f"w{k}": (d_in, 4 * H), f"u{k}": (H, 4 * H), f"b{k}": (4 * H,),
                         f"h{k}": (B, H), f"c{k}": (B, H)})
    for name, t in named.items():
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expected[name]}")
    if start.device.type == "cpu":
        return lstm_decode_reference(cell_params, out_dense, init_states, start, T, activation,
                                     out_activation)
    if start.device.type != "cuda":
        raise ValueError(f"lstm_decode runs on cpu or cuda tensors, not {start.device}")
    check_operands(named, start.device)
    if T < 1:
        raise ValueError(f"kernel M takes T >= 1; got T={T}")
    _layout.require("M", H, _layout.smem_bytes("M", H, D, n_layers))
    probs = torch.empty((T, B, D), device=start.device, dtype=torch.float32)
    logits = torch.empty_like(probs)
    null = ctypes.c_void_p(None)
    opt = lambda name: _ptr(named[name]) if name in named else null  # noqa: E731
    lib, fn = _kernel()
    rc = fn(
        _ptr(start), opt("h1"), opt("c1"), opt("h2"), opt("c2"),
        opt("w1"), opt("u1"), opt("b1"), opt("w2"), opt("u2"), opt("b2"),
        _ptr(out_dense["w"]), _ptr(out_dense["b"]), _ptr(probs), _ptr(logits),
        T, B, D, H, n_layers, CELL_ACTIVATIONS[activation], OUT_ACTIVATIONS[out_activation],
        ctypes.c_void_p(torch.cuda.current_stream(start.device).cuda_stream),
    )
    _build.check(lib, rc, "lstm_decode launch")
    lstm_decode.launches += 1
    return probs, logits


lstm_decode.launches = 0
