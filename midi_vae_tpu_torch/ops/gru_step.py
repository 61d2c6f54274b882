"""Kernels T and T xp: one reset-before GRU cell step, the per-step cells of
the decode heads and of the encoder layers that no whole-layer kernel runs.

Counterpart of ``midi_vae_tpu/ops/fused_gru.py``: ``gru_cell_step`` is its
``gru_step`` (:143), whose Pallas kernel ``_gru_full_kernel`` (through
``_gru_step_pallas``) kernel T replaces; ``gru_recurrent_step`` is its
``gru_recurrent_step`` (:164) over a precomputed x-projection, whose
``_gru_recurrent_kernel`` (through ``_gru_recurrent_pallas``) kernel T xp
replaces. Both live in ``csrc/gru_step.cu``, whose source note gives the
layout and what bounds them. The plain versions ``gru_cell_step_reference``
and ``gru_recurrent_step_reference`` compute as the Pallas kernels do: the
CPU path and the kernels' oracles.

Each differentiable step is a ``RematStep``: its forward launches the kernel
on CUDA tensors (the plain version on CPU tensors) and its backward
recomputes the step under autograd through ``gru_cell_step_vjp_reference``
or ``gru_recurrent_step_vjp_reference``, the JAX references
``_gru_step_reference`` and ``_gru_recurrent_reference`` (every op in the
operands' dtype), as the JAX package's custom VJPs do with ``jax.vjp``
(``_gru_step_bwd`` :153, ``_gru_recurrent_bwd`` :174). In float32 both
plain versions compute the same. ``make_decoder_step`` adapts T to
``models/rnn.py::decode_autoregressive`` (``make_fused_decoder_step``).
The cell activation is tanh, sigmoid or relu (``fused_gru._activation``).
Neither ``torch.nn.GRUCell`` nor ``torch.gru_cell`` computes this cell: both
are reset-after.

T has a float32 and a bfloat16 build (``mvt_gru_step``,
``mvt_gru_step_bf16``), picked by the operands' dtype: a bf16 model
(``compute_dtype="bfloat16"``) runs ``_gru_full_kernel`` in bf16, with the
products and gates in float32 and h' stored in bf16; the plain versions
compute the same way (``gru_layer.gru_step_xp``), while the backward rounds
every op to bf16, as ``_gru_step_reference`` and the plain cell do.
Launches are counted per build: ``gru_cell_step_fwd.launches`` (float32)
and ``.launches_bf16``.
T xp has the float32 build only: the bf16 encoder with
``fused_train_encoder=False`` is the whole-scan kernel X
(``ops/encoder_scan.py``), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.cells import GRUCell
from . import _build, _layout
from .gru_layer import (
    CELL_ACTIVATIONS,
    _ptr,
    cell_activation,
    check_operands,
    gru_step,
    gru_step_xp,
)
from .lstm_layer import _check_shapes, _on, _stream


class RematStep(torch.autograd.Function):
    """A per-step cell: the forward is ``fwd`` (a kernel wrapper), the
    backward recomputes ``plain`` under autograd (the JAX package's
    ``jax.vjp`` remat of its per-step cells, ``plain`` the JAX reference it
    differentiates). ``apply(fwd, plain, activation, *tensors)``; the
    outputs are one tensor or a tuple."""

    @staticmethod
    def forward(ctx, fwd, plain, activation, *tensors):
        ctx.set_materialize_grads(True)
        ctx.save_for_backward(*tensors)
        ctx.plain, ctx.activation = plain, activation
        return fwd(*tensors, activation)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*leaves, ctx.activation)
            wanted = [t for t, n in zip(leaves, needs) if n]
            found = iter(torch.autograd.grad(out, wanted, grads, allow_unused=True)
                         if wanted else ())
        return (None, None, None, *(next(found) if n else None for n in needs))


def gru_cell_step_reference(x, h, w, b, u, activation="tanh"):
    """Plain version of T: x (B, D), h (B, H) -> h' (B, H)."""
    return gru_step(x, h, w, u, b, cell_activation(activation))


def gru_recurrent_step_reference(xp, h, u, activation="tanh"):
    """Plain version of T xp: xp = x @ W + b (B, 3H), h (B, H) -> h'."""
    return gru_step_xp(xp, h, u, cell_activation(activation))


def gru_cell_step_vjp_reference(x, h, w, b, u, activation="tanh"):
    """What T's backward differentiates: ``_gru_step_reference``, x @ W + b
    and every op after it in the operands' dtype, as the plain cell
    (``models/cells.py::GRUCell.step``) computes."""
    return gru_recurrent_step_vjp_reference(x @ w + b, h, u, activation)


def gru_recurrent_step_vjp_reference(xp, h, u, activation="tanh"):
    """What T xp's backward differentiates: ``_gru_recurrent_reference``."""
    return GRUCell.step({"u": u}, xp, (h,), cell_activation(activation))[0]


@functools.cache
def _kernels():
    lib = _build.load("gru_step")
    step, step_bf16, step_xp = lib.mvt_gru_step, lib.mvt_gru_step_bf16, lib.mvt_gru_step_xp
    step.argtypes = step_bf16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    step_xp.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    step.restype = step_bf16.restype = step_xp.restype = ctypes.c_int
    return lib, {torch.float32: step, torch.bfloat16: step_bf16}, step_xp


def gru_cell_step_fwd(x, h, w, b, u, activation="tanh"):
    """One GRU step, x (B, D), h (B, H), w (D, 3H), b (3H,), u (H, 3H), all
    float32 or all bfloat16: returns h' of their dtype. CPU tensors run
    ``gru_cell_step_reference``; CUDA tensors launch kernel T's build of
    their dtype."""
    if activation not in CELL_ACTIVATIONS:
        raise ValueError(f"unsupported GRU kernel activation {activation!r}")
    if x.dim() != 2:
        raise ValueError(f"x must be (B, D), got {tuple(x.shape)}")
    B, D = x.shape
    H = u.shape[0]
    named = {"x": x, "h": h, "w": w, "b": b, "u": u}
    _check_shapes(named, {"x": (B, D), "h": (B, H), "w": (D, 3 * H), "b": (3 * H,),
                          "u": (H, 3 * H)})
    if not _on(x, "gru_cell_step"):
        return gru_cell_step_reference(x, h, w, b, u, activation)
    dtype = check_operands(named, x.device, (torch.float32, torch.bfloat16))
    if B < 1:
        raise ValueError(f"kernel T takes B >= 1; got B={B}")
    _layout.require("T", H, _layout.smem_bytes("T", H, D))
    h_out = torch.empty(B, H, device=x.device, dtype=dtype)
    lib, steps, _ = _kernels()
    rc = steps[dtype](_ptr(x), _ptr(h), _ptr(w), _ptr(b), _ptr(u), _ptr(h_out), B, D, H,
                      CELL_ACTIVATIONS[activation], _stream(x))
    _build.check(lib, rc, "gru_step launch")
    _build.count_launch(gru_cell_step_fwd, dtype)
    return h_out


gru_cell_step_fwd.launches = 0
gru_cell_step_fwd.launches_bf16 = 0


def gru_recurrent_step_fwd(xp, h, u, activation="tanh"):
    """One GRU step over xp (B, 3H), h (B, H), u (H, 3H): returns h'. CPU
    tensors run ``gru_recurrent_step_reference``; CUDA tensors launch kernel
    T xp."""
    if activation not in CELL_ACTIVATIONS:
        raise ValueError(f"unsupported GRU kernel activation {activation!r}")
    if h.dim() != 2:
        raise ValueError(f"h must be (B, H), got {tuple(h.shape)}")
    B, H = h.shape
    named = {"xp": xp, "h": h, "u": u}
    _check_shapes(named, {"xp": (B, 3 * H), "h": (B, H), "u": (H, 3 * H)})
    if not _on(xp, "gru_recurrent_step"):
        return gru_recurrent_step_reference(xp, h, u, activation)
    check_operands(named, xp.device)
    if B < 1:
        raise ValueError(f"kernel T xp takes B >= 1; got B={B}")
    _layout.require("T_xp", H, _layout.smem_bytes("T_xp", H))
    h_out = torch.empty(B, H, device=xp.device, dtype=torch.float32)
    lib, _, step_xp = _kernels()
    rc = step_xp(_ptr(xp), _ptr(h), _ptr(u), _ptr(h_out), B, H, CELL_ACTIVATIONS[activation],
                 _stream(xp))
    _build.check(lib, rc, "gru_step_xp launch")
    gru_recurrent_step_fwd.launches += 1
    return h_out


gru_recurrent_step_fwd.launches = 0


def gru_cell_step(x, h, w, b, u, activation="tanh"):
    """Differentiable GRU step x (B, D), h (B, H) -> h', with x @ W + b and
    h @ U inside: kernel T forward on CUDA tensors, the backward through
    ``gru_cell_step_vjp_reference``."""
    return RematStep.apply(gru_cell_step_fwd, gru_cell_step_vjp_reference, activation,
                           x, h, w, b, u)


def gru_recurrent_step(xp, h, u, activation="tanh"):
    """Differentiable GRU step over xp (B, 3H), h (B, H) -> h': kernel T xp
    forward on CUDA tensors, the backward through
    ``gru_recurrent_step_vjp_reference``."""
    return RematStep.apply(gru_recurrent_step_fwd, gru_recurrent_step_vjp_reference, activation,
                           xp, h, u)


def make_decoder_step(activation="tanh"):
    """The step of ``decode_autoregressive`` (``step=``): (params, x, (h,))
    -> (h', (h',)) through ``gru_cell_step``
    (``fused_gru.make_fused_decoder_step``)."""

    def step(p, x, states):
        (h,) = states
        h = gru_cell_step(x, h, p["w"], p["b"], p["u"], activation)
        return h, (h,)

    return step
