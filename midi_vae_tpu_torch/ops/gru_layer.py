"""Kernel A: one whole GRU layer forward with the x-projection in the kernel.

Counterpart of ``midi_vae_tpu/ops/fused_train.py::gru_layer_infer_x``, whose
Pallas kernels ``_fwdx_kernel`` (emits the h sequence) and
``_fwdx_last_kernel`` (emits the final h) the CUDA kernel
``csrc/gru_layer_fwd.cu`` replaces; its source note gives the layout and what
bounds it. ``gru_layer_reference`` is the plain PyTorch version
(``_gru_layer_reference_x``): the CPU path and the kernel's oracle.

``gru_layer`` takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# cell activations the kernels implement, with their codes in gru_common.cuh
CELL_ACTIVATIONS = {"tanh": 0, "sigmoid": 1, "relu": 2}
_PLAIN_ACTIVATIONS = {"tanh": torch.tanh, "sigmoid": torch.sigmoid, "relu": torch.relu}


def cell_activation(name: str):
    try:
        return _PLAIN_ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unsupported GRU kernel activation {name!r}") from None


def gru_step(x, h, w, u, b, act):
    """One reset-before GRU step: (B, D), (B, H) -> (B, H)."""
    H = h.shape[-1]
    xp = x @ w + b
    hu_zr = h @ u[:, : 2 * H]
    z = torch.sigmoid(xp[:, :H] + hu_zr[:, :H])
    r = torch.sigmoid(xp[:, H : 2 * H] + hu_zr[:, H:])
    hh = act(xp[:, 2 * H :] + (r * h) @ u[:, 2 * H :])
    return z * h + (1.0 - z) * hh


def gru_layer_reference(x, h0, w, b, u, activation="tanh", return_sequences=False):
    """Plain version: x (T, B, D) -> (T, B, H) sequence or final h (B, H)."""
    act = cell_activation(activation)
    T, B, D = x.shape
    xp = (x.reshape(T * B, D) @ w + b).reshape(T, B, -1)
    H = h0.shape[-1]
    h = h0
    seq = []
    for t in range(T):
        hu_zr = h @ u[:, : 2 * H]
        z = torch.sigmoid(xp[t, :, :H] + hu_zr[:, :H])
        r = torch.sigmoid(xp[t, :, H : 2 * H] + hu_zr[:, H:])
        hh = act(xp[t, :, 2 * H :] + (r * h) @ u[:, 2 * H :])
        h = z * h + (1.0 - z) * hh
        if return_sequences:
            seq.append(h)
    return torch.stack(seq) if return_sequences else h


def check_operands(named: dict, device: torch.device) -> None:
    """Device, dtype and contiguity checks shared by the kernel wrappers."""
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}; the kernels take float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


@functools.cache
def _kernel():
    lib = _build.load("gru_layer_fwd")
    fn = lib.mvt_gru_layer_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def gru_layer(x, h0, w, b, u, activation="tanh", return_sequences=False):
    """GRU layer forward, x (T, B, D) time-major.

    Returns the (T, B, H) h sequence when ``return_sequences`` else the final
    h (B, H). CPU tensors run ``gru_layer_reference``; CUDA tensors launch
    kernel A."""
    if activation not in CELL_ACTIVATIONS:
        raise ValueError(f"unsupported GRU kernel activation {activation!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be (T, B, D), got {tuple(x.shape)}")
    T, B, D = x.shape
    H = u.shape[0]
    expected = {"h0": (B, H), "w": (D, 3 * H), "b": (3 * H,), "u": (H, 3 * H)}
    for name, t in (("h0", h0), ("w", w), ("b", b), ("u", u)):
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expected[name]}")
    if x.device.type == "cpu":
        return gru_layer_reference(x, h0, w, b, u, activation, return_sequences)
    if x.device.type != "cuda":
        raise ValueError(f"gru_layer runs on cpu or cuda tensors, not {x.device}")
    check_operands({"x": x, "h0": h0, "w": w, "b": b, "u": u}, x.device)
    if T < 1 or B < 1 or H % 32 or not 32 <= H <= 1024:
        raise ValueError(f"kernel A takes T >= 1, B >= 1 and H a multiple of 32 in [32, 1024]; got T={T} B={B} H={H}")
    out = torch.empty((T, B, H) if return_sequences else (B, H), device=x.device, dtype=torch.float32)
    lib, fn = _kernel()
    rc = fn(
        _ptr(x), _ptr(h0), _ptr(w), _ptr(b), _ptr(u), _ptr(out),
        T, B, D, H, CELL_ACTIVATIONS[activation], int(return_sequences),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _build.check(lib, rc, "gru_layer_fwd launch")
    gru_layer.launches += 1
    return out


gru_layer.launches = 0
