"""Kernel B: a whole autoregressive GRU decode head in one kernel.

Counterpart of ``midi_vae_tpu/ops/fused_decoder.py::fused_decode_scan``,
whose Pallas kernels ``_decode_kernel_2layer`` and ``_decode_kernel_1layer``
the CUDA kernel ``csrc/gru_decode.cu`` replaces; its source note gives the
layout and what bounds it. ``gru_decode_reference`` is the plain PyTorch
version (``_decode_scan_reference``): the CPU path and the kernel's oracle.

``gru_decode`` takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .gru_layer import CELL_ACTIVATIONS, _ptr, cell_activation, check_operands, gru_step

# output activations the kernel implements, with their codes in gru_common.cuh
OUT_ACTIVATIONS = {"sigmoid": 1, "linear": 3, "softmax": 4}


def out_activation_fn(name: str):
    if name == "softmax":
        return lambda x: torch.softmax(x, dim=-1)
    if name == "sigmoid":
        return torch.sigmoid
    if name == "linear":
        return lambda x: x
    raise ValueError(f"unsupported decode output activation {name!r}")


def gru_decode_reference(cells, out_dense, init_states, start, T, activation="tanh",
                         out_activation="softmax"):
    """Plain version. Returns (probs, logits), each (T, B, D) time-major."""
    act = cell_activation(activation)
    out_act = out_activation_fn(out_activation)
    states = list(init_states)
    x = start
    probs, logits = [], []
    for _ in range(T):
        for i, p in enumerate(cells):
            x = states[i] = gru_step(x, states[i], p["w"], p["u"], p["b"], act)
        lg = x @ out_dense["w"] + out_dense["b"]
        x = out_act(lg)
        probs.append(x)
        logits.append(lg)
    return torch.stack(probs), torch.stack(logits)


@functools.cache
def _kernel():
    lib = _build.load("gru_decode")
    fn = lib.mvt_gru_decode
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def gru_decode(cells, out_dense, init_states, start, T, activation="tanh",
               out_activation="softmax"):
    """Readout decode of one head: ``cells`` is a list of 1 or 2 GRU layer
    params {w, u, b}, ``out_dense`` {w, b}, ``init_states`` one (B, H) state
    per layer, ``start`` (B, D) the input of step 0. Returns (probs, logits),
    each (T, B, D). CPU tensors run ``gru_decode_reference``; CUDA tensors
    launch kernel B."""
    n_layers = len(cells)
    if n_layers not in (1, 2) or len(init_states) != n_layers:
        raise ValueError(f"kernel B decodes 1- or 2-layer heads with one state per layer, got {n_layers} layers and {len(init_states)} states")
    if activation not in CELL_ACTIVATIONS:
        raise ValueError(f"unsupported GRU kernel activation {activation!r}")
    if out_activation not in OUT_ACTIVATIONS:
        raise ValueError(f"unsupported decode output activation {out_activation!r}")
    B, D = start.shape
    H = init_states[0].shape[-1]
    named = {"start": start, "wo": out_dense["w"], "bo": out_dense["b"]}
    expected = {"start": (B, D), "wo": (H, D), "bo": (D,)}
    for i, (p, h) in enumerate(zip(cells, init_states)):
        d_in = D if i == 0 else H
        named.update({f"w{i + 1}": p["w"], f"u{i + 1}": p["u"], f"b{i + 1}": p["b"], f"h{i + 1}": h})
        expected.update({f"w{i + 1}": (d_in, 3 * H), f"u{i + 1}": (H, 3 * H),
                         f"b{i + 1}": (3 * H,), f"h{i + 1}": (B, H)})
    for name, t in named.items():
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expected[name]}")
    if start.device.type == "cpu":
        return gru_decode_reference(cells, out_dense, init_states, start, T, activation,
                                    out_activation)
    if start.device.type != "cuda":
        raise ValueError(f"gru_decode runs on cpu or cuda tensors, not {start.device}")
    check_operands(named, start.device)
    if T < 1 or H % 32 or not 32 <= H <= 1024:
        raise ValueError(f"kernel B takes T >= 1 and H a multiple of 32 in [32, 1024]; got T={T} H={H}")
    probs = torch.empty((T, B, D), device=start.device, dtype=torch.float32)
    logits = torch.empty_like(probs)
    two = n_layers == 2
    null = ctypes.c_void_p(None)
    lib, fn = _kernel()
    rc = fn(
        _ptr(start), _ptr(init_states[0]), _ptr(init_states[1]) if two else null,
        _ptr(cells[0]["w"]), _ptr(cells[0]["u"]), _ptr(cells[0]["b"]),
        _ptr(cells[1]["w"]) if two else null, _ptr(cells[1]["u"]) if two else null,
        _ptr(cells[1]["b"]) if two else null,
        _ptr(out_dense["w"]), _ptr(out_dense["b"]), _ptr(probs), _ptr(logits),
        T, B, D, H, n_layers, CELL_ACTIVATIONS[activation], OUT_ACTIVATIONS[out_activation],
        ctypes.c_void_p(torch.cuda.current_stream(start.device).cuda_stream),
    )
    _build.check(lib, rc, "gru_decode launch")
    gru_decode.launches += 1
    return probs, logits


gru_decode.launches = 0
