"""Kernels T and T xp: one reset-before GRU cell step, the per-step cells of
the decode heads and of the encoder layers that no whole-layer kernel runs.

Counterpart of ``midi_vae_tpu/ops/fused_gru.py``: ``gru_cell_step`` is its
``gru_step`` (:143), whose Pallas kernel ``_gru_full_kernel`` (through
``_gru_step_pallas``) kernel T replaces; ``gru_recurrent_step`` is its
``gru_recurrent_step`` (:164) over a precomputed x-projection, whose
``_gru_recurrent_kernel`` (through ``_gru_recurrent_pallas``) kernel T xp
replaces. Both live in ``csrc/gru_step.cu``, whose source note gives the
design (one launch on thread-block clusters, both products on the tensor
cores) and what bounds it; the plan (rows a cluster, units a CTA) is
``_layout.gru_step_plan``'s, cached per shape with the wrapper's other
per-shape work. The plain versions ``gru_cell_step_reference``
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
and ``.launches_bf16``, two for a call on T's two-launch route (the plan's
``split``: P1 and P2 as two launches where its clusters outnumber the
card's).
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
    cell_activation,
    check_operands,
    gru_step,
    gru_step_xp,
)
from .lstm_layer import _check_shapes, _on


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


def gru_step_p1_reference(x, h, w, b, u, xp=None):
    """Plain version of T's first phase, P1 = [x | h] . [W ; U_zr] (T xp:
    h . U_zr, ``xp`` in place of x @ W + b; x, w, b are then ignored), in
    float32 over the operands widened: returns (z, r * h, the candidate's
    x part x W_h + b_h), each (B, H) float32. r * h is what the kernel's
    exchange carries to every CTA of the cluster."""
    H = h.shape[-1]
    hf, uf = h.float(), u.float()
    xw = x.float() @ w.float() + b.float() if xp is None else xp.float()
    hu = hf @ uf[:, :2 * H]
    z = torch.sigmoid(xw[:, :H] + hu[:, :H])
    r = torch.sigmoid(xw[:, H:2 * H] + hu[:, H:])
    return z, r * hf, xw[:, 2 * H:]


def gru_step_p2_reference(z, rh, cand, h, u, activation="tanh"):
    """Plain version of T's second phase: P2 = (r h) . U_h over the
    candidate columns, then hh = act(P2 + cand) and h' = z h + (1 - z) hh,
    rounded once to h's dtype."""
    H = h.shape[-1]
    hh = cell_activation(activation)(cand + rh @ u.float()[:, 2 * H:])
    return (z * h.float() + (1.0 - z) * hh).to(h.dtype)


def gru_cell_step_vjp_reference(x, h, w, b, u, activation="tanh"):
    """What T's backward differentiates: ``_gru_step_reference``, x @ W + b
    and every op after it in the operands' dtype, as the plain cell
    (``models/cells.py::GRUCell.step``) computes."""
    return gru_recurrent_step_vjp_reference(x @ w + b, h, u, activation)


def gru_recurrent_step_vjp_reference(xp, h, u, activation="tanh"):
    """What T xp's backward differentiates: ``_gru_recurrent_reference``."""
    return GRUCell.step({"u": u}, xp, (h,), cell_activation(activation))[0]


def _raw_stream(t):
    """The handle of the current CUDA stream of t's device, as an int,
    without building a torch.cuda.Stream object: a training step launches S
    196 times on a host-bound path (on the H100's host the Stream object
    took 12 us a call, the raw handle 0.2: PERF.md, Findings)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


@functools.cache
def _kernels():
    lib = _build.load("gru_step")
    step, step_bf16, step_xp = lib.mvt_gru_step, lib.mvt_gru_step_bf16, lib.mvt_gru_step_xp
    step.argtypes = step_bf16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    step_xp.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    split, split_bf16 = lib.mvt_gru_step_split, lib.mvt_gru_step_split_bf16
    split.argtypes = split_bf16.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    for fn in (step, step_bf16, step_xp, split, split_bf16):
        fn.restype = ctypes.c_int
    return (lib, {torch.float32: step, torch.bfloat16: step_bf16}, step_xp,
            {torch.float32: split, torch.bfloat16: split_bf16})


@functools.cache
def _plan(B, D, H, elem, xp):
    """(the kernel's plan index, whether it takes the two-launch route) of
    ``_layout.gru_step_plan`` at (B, D, H) (``xp``: T xp) for operands of
    ``elem`` bytes; raises LaunchLimitError where T does not launch."""
    p = _layout.gru_step_plan(B, D, H, elem, xp)
    return p.plan, p.split


def _aligned(named, keys):
    """T's ring copies 16 bytes at a time from the weights: W and U must
    start on a 16-byte boundary (a fresh tensor always does)."""
    for k in keys:
        if named[k].data_ptr() % 16:
            raise ValueError(f"kernel T reads {k} in 16-byte copies; its storage must start on a "
                             "16-byte boundary")


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
    _aligned(named, ("w", "u"))
    plan, split = _plan(B, D, H, x.element_size(), False)
    h_out = torch.empty_like(h)
    lib, steps, _, splits = _kernels()
    ptrs = (x.data_ptr(), h.data_ptr(), w.data_ptr(), b.data_ptr(), u.data_ptr(),
            h_out.data_ptr())
    if split:  # the two-launch route: P1's gates and r * h through scratch
        scratch = torch.empty(3 * B * H, device=x.device, dtype=torch.float32)
        rc = splits[dtype](*ptrs, scratch.data_ptr(), B, D, H, CELL_ACTIVATIONS[activation],
                           _raw_stream(x))
    else:
        rc = steps[dtype](*ptrs, B, D, H, CELL_ACTIVATIONS[activation], plan, _raw_stream(x))
    _build.check(lib, rc, "gru_step launch")
    _build.count_launch(gru_cell_step_fwd, dtype, 2 if split else 1)
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
    _aligned(named, ("u",))
    plan, _ = _plan(B, 0, H, 4, True)
    h_out = torch.empty_like(h)
    lib, _, step_xp, _ = _kernels()
    rc = step_xp(xp.data_ptr(), h.data_ptr(), u.data_ptr(), h_out.data_ptr(), B, H,
                 CELL_ACTIVATIONS[activation], plan, _raw_stream(xp))
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
