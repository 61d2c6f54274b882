"""Kernel S: one whole LSTM cell step, the per-step cell of the decode heads.

Counterpart of ``midi_vae_tpu/ops/fused_lstm.py::lstm_step``, whose Pallas
kernel ``_lstm_full_kernel`` (through ``_lstm_step_pallas``) the CUDA kernel
``csrc/lstm_step.cu`` replaces; its source note gives the layout and what
bounds it. ``lstm_cell_step_reference`` is the plain PyTorch version
(``_lstm_step_reference``): the CPU path, the kernel's oracle and the
backward.

``lstm_cell_step`` is a ``torch.autograd.Function`` whose forward launches S
on CUDA tensors (``lstm_cell_step_fwd``; the plain version on CPU tensors)
and whose backward recomputes the step through the plain version under
autograd. That is the JAX package's own design, not a fallback: its
``lstm_step`` custom VJP re-runs ``_lstm_step_reference`` under ``jax.vjp``
(``_lstm_step_bwd``, :168-174), and XLA computes that backward.
``make_decoder_step`` adapts it to ``models/rnn.py::decode_autoregressive``
(``make_fused_decoder_step``). The cell activation (on g and on c) is tanh,
sigmoid or relu, as ``_lstm_step_pallas`` takes through
``fused_gru._activation``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, _layout
from .gru_layer import CELL_ACTIVATIONS, _ptr, cell_activation, check_operands
from .lstm_layer import _check_shapes, _on, _stream, lstm_step


def lstm_cell_step_reference(x, h, c, w, b, u, activation="tanh"):
    """Plain version: x (B, D), h, c (B, H) -> (h', c')."""
    return lstm_step(x @ w + b, h, c, u, cell_activation(activation))


@functools.cache
def _kernel():
    lib = _build.load("lstm_step")
    fn = lib.mvt_lstm_step
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def lstm_cell_step_fwd(x, h, c, w, b, u, activation="tanh"):
    """One LSTM step, x (B, D), h, c (B, H), w (D, 4H), b (4H,), u (H, 4H):
    returns (h', c'). CPU tensors run ``lstm_cell_step_reference``; CUDA
    tensors launch kernel S."""
    if activation not in CELL_ACTIVATIONS:
        raise ValueError(f"unsupported LSTM kernel activation {activation!r}")
    if x.dim() != 2:
        raise ValueError(f"x must be (B, D), got {tuple(x.shape)}")
    B, D = x.shape
    H = u.shape[0]
    named = {"x": x, "h": h, "c": c, "w": w, "b": b, "u": u}
    _check_shapes(named, {"x": (B, D), "h": (B, H), "c": (B, H), "w": (D, 4 * H),
                          "b": (4 * H,), "u": (H, 4 * H)})
    if not _on(x, "lstm_cell_step"):
        return lstm_cell_step_reference(x, h, c, w, b, u, activation)
    check_operands(named, x.device)
    if B < 1:
        raise ValueError(f"kernel S takes B >= 1; got B={B}")
    _layout.require("S", H, _layout.smem_bytes("S", H, D))
    h_out = torch.empty(B, H, device=x.device, dtype=torch.float32)
    c_out = torch.empty_like(h_out)
    lib, fn = _kernel()
    rc = fn(_ptr(x), _ptr(h), _ptr(c), _ptr(w), _ptr(b), _ptr(u), _ptr(h_out), _ptr(c_out),
            B, D, H, CELL_ACTIVATIONS[activation], _stream(x))
    _build.check(lib, rc, "lstm_step launch")
    lstm_cell_step_fwd.launches += 1
    return h_out, c_out


lstm_cell_step_fwd.launches = 0


class _LstmCellStep(torch.autograd.Function):
    """Forward: kernel S. Backward: the plain version recomputed under
    autograd, as ``_lstm_step_bwd`` does with ``jax.vjp``."""

    @staticmethod
    def forward(ctx, x, h, c, w, b, u, activation):
        ctx.set_materialize_grads(True)
        ctx.save_for_backward(x, h, c, w, b, u)
        ctx.activation = activation
        return lstm_cell_step_fwd(x, h, c, w, b, u, activation)

    @staticmethod
    def backward(ctx, gh, gc):
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = lstm_cell_step_reference(*leaves, ctx.activation)
            wanted = [t for t, n in zip(leaves, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, (gh, gc), allow_unused=True)
                         if wanted else ())
        return (*(next(grads) if n else None for n in needs), None)


def lstm_cell_step(x, h, c, w, b, u, activation="tanh"):
    """Differentiable LSTM step x (B, D), h, c (B, H) -> (h', c'), with x @ W
    + b and h @ U inside: kernel S forward on CUDA tensors, the plain
    version's backward."""
    return _LstmCellStep.apply(x, h, c, w, b, u, activation)


def make_decoder_step(activation="tanh"):
    """The step of ``decode_autoregressive`` (``step=``): (params, x, (h, c))
    -> (h', (h', c')) through ``lstm_cell_step``
    (``fused_lstm.make_fused_decoder_step``)."""

    def step(p, x, states):
        h, c = states
        h, c = lstm_cell_step(x, h, c, p["w"], p["b"], p["u"], activation)
        return h, (h, c)

    return step
