"""Kernels S and S xp: one LSTM cell step, the per-step cell of the decode
heads (S) and of the encoder layers that no whole-layer kernel runs (S xp).

Counterpart of ``midi_vae_tpu/ops/fused_lstm.py``: ``lstm_cell_step`` is its
``lstm_step`` (:155), whose Pallas kernel ``_lstm_full_kernel`` (through
``_lstm_step_pallas``) kernel S replaces; ``lstm_recurrent_step`` is its
``lstm_recurrent_step`` (:181) over a precomputed x-projection, whose
``_lstm_recurrent_kernel`` (through ``_lstm_recurrent_pallas``) kernel S xp
replaces. Both live in ``csrc/lstm_step.cu``, whose source note gives the
design (one product on the tensor cores a launch, the cell math in its
epilogue) and what bounds them; the tile plan is ``_layout.step_plan``,
cached per shape (``_tile``), so that a step adds no host work beyond the
launch. ``lstm_cell_step_reference`` and
``lstm_recurrent_step_reference`` are the plain PyTorch versions, computed
as the Pallas kernels compute: the CPU path and the kernels' oracles.

Each differentiable step is a ``gru_step.RematStep`` whose forward launches
the kernel on CUDA tensors (the plain version on CPU tensors) and whose
backward recomputes the step under autograd through the JAX reference it
mirrors: ``lstm_cell_step_vjp_reference`` (``_lstm_step_reference``) or
``lstm_recurrent_step_reference`` (``_lstm_recurrent_reference``). That is
the JAX package's own design, not a fallback: its custom VJPs re-run the
plain step under ``jax.vjp`` (``_lstm_step_bwd`` :168-174,
``_lstm_recurrent_bwd`` :194-200), and XLA computes that backward.
``make_decoder_step`` adapts S to ``models/rnn.py::decode_autoregressive``
(``make_fused_decoder_step``). The cell activation (on g and on c) is tanh,
sigmoid or relu, as ``fused_gru._activation`` gives it.

S has a float32 and a bfloat16 build (``mvt_lstm_step``,
``mvt_lstm_step_bf16``), picked by the operands' dtype: every head cell of a
bf16 LSTM model runs ``_lstm_full_kernel`` in bf16, x @ W + b, h @ U and the
gates in float32, h' and c' stored in bf16; the plain versions compute the
same way (``lstm_layer.lstm_step``). The backward's reference rounds x @ W +
b to bf16 before the gates, as ``_lstm_step_reference`` does (:85-90); its
h @ U is ``_lstm_gates``' float32 product of the bf16 operands, as in the
kernel. Launches are counted per build:
``lstm_cell_step_fwd.launches`` (float32) and ``.launches_bf16``. S xp has
the float32 build only: the bf16 encoder with ``fused_train_encoder=False``
is the whole-scan kernel Y (``ops/encoder_scan.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, _layout
from .gru_layer import CELL_ACTIVATIONS, cell_activation, check_operands
from .gru_step import RematStep, _raw_stream
from .lstm_layer import _check_shapes, _on, lstm_step


def lstm_cell_step_reference(x, h, c, w, b, u, activation="tanh"):
    """Plain version of S: x (B, D), h, c (B, H) -> (h', c'); x @ W + b in
    float32, as ``lstm_step`` computes the rest."""
    return lstm_step(x.float() @ w.float() + b.float(), h, c, u, cell_activation(activation))


def lstm_cell_step_vjp_reference(x, h, c, w, b, u, activation="tanh"):
    """What S's backward differentiates: ``_lstm_step_reference``, x @ W + b
    in the operands' dtype, then ``lstm_step``."""
    return lstm_step(x @ w + b, h, c, u, cell_activation(activation))


def lstm_recurrent_step_reference(xp, h, c, u, activation="tanh"):
    """Plain version of S xp: xp = x @ W + b (B, 4H), h, c (B, H) -> (h',
    c')."""
    return lstm_step(xp, h, c, u, cell_activation(activation))


@functools.cache
def _kernels():
    lib = _build.load("lstm_step")
    step, step_bf16, step_xp = lib.mvt_lstm_step, lib.mvt_lstm_step_bf16, lib.mvt_lstm_step_xp
    step.argtypes = step_bf16.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    step_xp.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    step.restype = step_bf16.restype = step_xp.restype = ctypes.c_int
    return lib, {torch.float32: step, torch.bfloat16: step_bf16}, step_xp


@functools.cache
def _tile(B, D, H, elem):
    """The kernel's tile index of ``_layout.step_plan`` at (B, D, H) (D = 0:
    S xp) for operands of ``elem`` bytes; raises LaunchLimitError where S
    does not launch."""
    return _layout.step_plan(B, D, H, elem).tile


def lstm_cell_step_fwd(x, h, c, w, b, u, activation="tanh"):
    """One LSTM step, x (B, D), h, c (B, H), w (D, 4H), b (4H,), u (H, 4H),
    all float32 or all bfloat16: returns (h', c') of their dtype. CPU
    tensors run ``lstm_cell_step_reference``; CUDA tensors launch kernel S's
    build of their dtype."""
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
    dtype = check_operands(named, x.device, (torch.float32, torch.bfloat16))
    if B < 1:
        raise ValueError(f"kernel S takes B >= 1; got B={B}")
    tile = _tile(B, D, H, x.element_size())
    h_out, c_out = torch.empty_like(h), torch.empty_like(h)
    lib, steps, _ = _kernels()
    rc = steps[dtype](x.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(), b.data_ptr(),
                      u.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), B, D, H,
                      CELL_ACTIVATIONS[activation], tile, _raw_stream(x))
    _build.check(lib, rc, "lstm_step launch")
    _build.count_launch(lstm_cell_step_fwd, dtype)
    return h_out, c_out


lstm_cell_step_fwd.launches = 0
lstm_cell_step_fwd.launches_bf16 = 0


def lstm_recurrent_step_fwd(xp, h, c, u, activation="tanh"):
    """One LSTM step over xp (B, 4H), h, c (B, H), u (H, 4H): returns (h',
    c'). CPU tensors run ``lstm_recurrent_step_reference``; CUDA tensors
    launch kernel S xp."""
    if activation not in CELL_ACTIVATIONS:
        raise ValueError(f"unsupported LSTM kernel activation {activation!r}")
    if h.dim() != 2:
        raise ValueError(f"h must be (B, H), got {tuple(h.shape)}")
    B, H = h.shape
    named = {"xp": xp, "h": h, "c": c, "u": u}
    _check_shapes(named, {"xp": (B, 4 * H), "h": (B, H), "c": (B, H), "u": (H, 4 * H)})
    if not _on(xp, "lstm_recurrent_step"):
        return lstm_recurrent_step_reference(xp, h, c, u, activation)
    check_operands(named, xp.device)
    if B < 1:
        raise ValueError(f"kernel S xp takes B >= 1; got B={B}")
    tile = _tile(B, 0, H, 4)
    h_out, c_out = torch.empty_like(h), torch.empty_like(h)
    lib, _, fn = _kernels()
    rc = fn(xp.data_ptr(), h.data_ptr(), c.data_ptr(), u.data_ptr(), h_out.data_ptr(),
            c_out.data_ptr(), B, H, CELL_ACTIVATIONS[activation], tile, _raw_stream(xp))
    _build.check(lib, rc, "lstm_step_xp launch")
    lstm_recurrent_step_fwd.launches += 1
    return h_out, c_out


lstm_recurrent_step_fwd.launches = 0


def lstm_cell_step(x, h, c, w, b, u, activation="tanh"):
    """Differentiable LSTM step x (B, D), h, c (B, H) -> (h', c'), with x @ W
    + b and h @ U inside: kernel S forward on CUDA tensors, the backward
    through ``lstm_cell_step_vjp_reference``."""
    return RematStep.apply(lstm_cell_step_fwd, lstm_cell_step_vjp_reference, activation,
                           x, h, c, w, b, u)


def lstm_recurrent_step(xp, h, c, u, activation="tanh"):
    """Differentiable LSTM step over xp (B, 4H), h, c (B, H) -> (h', c'):
    kernel S xp forward on CUDA tensors, the plain version's backward."""
    return RematStep.apply(lstm_recurrent_step_fwd, lstm_recurrent_step_reference, activation,
                           xp, h, c, u)


def make_decoder_step(activation="tanh"):
    """The step of ``decode_autoregressive`` (``step=``): (params, x, (h, c))
    -> (h', (h', c')) through ``lstm_cell_step``
    (``fused_lstm.make_fused_decoder_step``)."""

    def step(p, x, states):
        h, c = states
        h, c = lstm_cell_step(x, h, c, p["w"], p["b"], p["u"], activation)
        return h, (h, c)

    return step
