"""Kernels X and Y: a whole GRU or LSTM encoder layer in bfloat16 over its
precomputed x-projection, the encoder of bf16 training with
``fused_train_encoder=False``.

Counterpart of ``midi_vae_tpu/ops/fused_decoder.py::fused_encoder_scan``
(:457) and ``midi_vae_tpu/ops/fused_lstm.py::fused_lstm_encoder_scan``
(:387), whose Pallas kernels ``_encoder_kernel`` (through
``_encoder_scan_pallas`` and, batch-tiled, ``_encoder_scan_wide_pallas``:
rows 26, 27, 32 and 33 of the kernel table) kernels X
(``csrc/gru_encoder_scan.cu``) and Y (``csrc/lstm_encoder_scan.cu``)
replace; their source notes give the layout and what bounds them. The JAX
package takes them only where ``models/vae.py:255-260`` sets
``whole_scan``: training, the kernels on, ``fused_train_encoder=False`` and
``compute_dtype="bfloat16"``.

``gru_encoder_scan_reference`` and ``lstm_encoder_scan_reference`` are the
plain versions: the CPU path and the kernels' oracles. They compute as the
Pallas kernels do: the products and the gate math in float32, the carried
state (h; h and c) rounded to the compute dtype after every step
(``gru_layer.gru_step_xp``, ``lstm_layer.lstm_step``); in float32 they are
the JAX references exactly.

Y is the bf16 build of kernel Q's forward chain on thread-block clusters
(``csrc/lstm_cell_fwd.cuh``; its plan ``lstm_layer.fwd_chain_plan``). X is
kernel A's bf16 GRU chain (``csrc/gru_cell_fwd.cuh``) in its instance that
reads a bf16 xp, at X's own plan (``scan_chain_plan``); at H = 1024, where
no cluster holds the bf16 slice, F's tensor-core instance in its bf16 build
(the slice packed by ``gru_layer.pack_tc_slices`` and streamed); where
neither launches (``_layout.gru_scan_route``), X's first, per-block design
takes the layer. ``gru_encoder_scan_fwd`` counts every launch of X on
``.launches``, and each also on ``.launches_chain`` or ``.launches_block``.

``gru_encoder_scan`` and ``lstm_encoder_scan`` are whole-layer
``RematStep``s: the forward launches the kernel on CUDA tensors (bfloat16
only, the one dtype the JAX package runs them in) and the plain version on
CPU tensors, and the backward recomputes the JAX reference scan under
autograd, as ``_fes_bwd`` (:492) and ``_fles_bwd`` (:430) do with
``jax.vjp``: for the GRU ``gru_encoder_scan_vjp_reference``, every op in
bf16 as ``fused_decoder._encoder_scan_reference`` (:333) rounds; for the
LSTM ``lstm_encoder_scan_reference`` itself, which is
``fused_lstm._encoder_scan_reference`` (:290: ``_lstm_gates``' float32
product of the bf16 operands, the state rounded each step). The cell
activation is tanh, sigmoid or relu (``_activation``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, _layout
from . import gru_layer, lstm_layer
from .gru_layer import CELL_ACTIVATIONS, _ptr, cell_activation, check_operands
from .gru_step import RematStep, gru_recurrent_step_vjp_reference
from .lstm_layer import _check_shapes, _on, _stream


def gru_encoder_scan_reference(xp, h0, u, activation="tanh", return_sequences=False):
    """Plain version of X: xp (T, B, 3H), h0 (B, H), u (H, 3H) -> the (T, B,
    H) h sequence or the final h (B, H)."""
    return gru_layer._scan_xp(xp, h0, u, cell_activation(activation), return_sequences)


def gru_encoder_scan_vjp_reference(xp, h0, u, activation="tanh", return_sequences=False):
    """What X's backward differentiates: ``_encoder_scan_reference``, every
    op in the operands' dtype, T xp's backward reference scanned
    (``gru_encoder_scan_reference`` in float32)."""
    h, seq = h0, []
    for t in range(xp.shape[0]):
        h = gru_recurrent_step_vjp_reference(xp[t], h, u, activation)
        seq.append(h)
    return torch.stack(seq) if return_sequences else h


def lstm_encoder_scan_reference(xp, h0, c0, u, activation="tanh", return_sequences=False):
    """Plain version of Y: xp (T, B, 4H), h0, c0 (B, H), u (H, 4H) -> the
    (T, B, H) h sequence or the final h (B, H)."""
    hseq, _ = lstm_layer._scan_xp(xp, h0, c0, u, cell_activation(activation))
    return hseq if return_sequences else hseq[-1]


@functools.cache
def _kernel(entry):
    """(library, entry point) of X's chain (``gru_encoder_scan``) or its
    per-block route (``gru_encoder_scan_block``), or of Y
    (``lstm_encoder_scan``)."""
    lib_name = entry.removesuffix("_block").removesuffix("_tc")
    # X: xp, h0, u, out, then T, B, H, act, return_sequences and the chain's
    # plan (cluster, rows, splits, stages); Y: xp, h0, c0, u, out and its
    # plan's cluster, rows
    n_ptrs, n_ints = {"gru_encoder_scan": (4, 9), "gru_encoder_scan_block": (4, 5),
                      "gru_encoder_scan_tc": (5, 8), "lstm_encoder_scan": (5, 7)}[entry]
    return _build.load_entry(lib_name, f"mvt_{entry}", [ctypes.c_void_p] * n_ptrs
                             + [ctypes.c_int] * n_ints + [ctypes.c_void_p])


@functools.cache
def _tc_max_clusters(cluster):
    """The card's cudaOccupancyMaxActiveClusters of X's streamed instance
    at ``cluster`` CTAs a cluster."""
    lib, fn = _build.load_entry("gru_encoder_scan", "mvt_gru_encoder_scan_tc_max_clusters",
                                [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    _build.check(lib, fn(cluster, ctypes.byref(out)),
                 "gru_encoder_scan cudaOccupancyMaxActiveClusters")
    return out.value


@functools.cache
def scan_chain_plan(H, B):
    """X's chain plan at (H, B) at the card's active clusters of the
    instance it runs: where a cluster holds the bf16 slice, A bf16's chain
    in its bf16-xp instance (``_layout.gru_fwd_plan`` of
    ``_layout.X_CHAIN_BUILD``), else (H = 1024) the tensor-core instance
    with the bf16 slice streamed (``_layout.gru_tc_plan(..., elem=2)``,
    ``chunk`` > 0); raises LaunchLimitError where neither launches."""
    C, stream_slice = _layout.gru_fwd_cluster(_layout.X_CHAIN_BUILD, H)
    if stream_slice:
        plan = _layout.gru_tc_plan(H, B, _tc_max_clusters, elem=2)
        if plan is None:
            raise _layout.LaunchLimitError(f"kernel X's streamed instance has no plan at H={H}, "
                                           f"B={B}")
        return plan
    return _layout.gru_fwd_plan(_layout.X_CHAIN_BUILD, H, B,
                                gru_layer._max_clusters("gru_encoder_scan", True, C))


def _launch(name, letter, xp, states, u, activation, return_sequences, route="chain"):
    """Checks and launches kernel X or Y over xp (T, B, G) with the initial
    ``states`` (h0, or h0 and c0); X on ``route`` ("chain" or "block")."""
    T, B = xp.shape[:2]
    H = u.shape[0]
    check_operands({"xp": xp, **{f"state{i}": s for i, s in enumerate(states)}, "u": u},
                   xp.device, (torch.bfloat16,))
    if T < 1 or B < 1:
        raise ValueError(f"kernel {letter} takes T >= 1 and B >= 1; got T={T} B={B}")
    entry = name
    if letter == "Y":
        plan = lstm_layer.fwd_chain_plan("Y", H, B)
        extra = (plan.cluster, plan.rows)
    elif route == "chain":
        plan = scan_chain_plan(H, B)
        if plan.chunk:  # the streamed instance over U's packed bf16 slices
            entry, extra = f"{name}_tc", (plan.cluster, plan.rows, plan.stages, plan.chunk)
            states = (*states, *gru_layer._tc_slices(u, plan.cluster))
        else:
            extra = (plan.cluster, plan.rows, plan.splits, plan.stages)
    else:
        _layout.require(letter, H, _layout.smem_bytes(letter, H))
        entry, extra = f"{name}_block", ()
    lib, fn = _kernel(entry)
    if entry.endswith("_tc"):
        # the streamed instance reads the packed slices (after h0) in U's
        # place and stores the sequence, whose last step is the final h
        seq = torch.empty((T, B, H), device=xp.device, dtype=torch.bfloat16)
        rc = fn(_ptr(xp), *map(_ptr, states), _ptr(seq), T, B, H, CELL_ACTIVATIONS[activation],
                *extra, _stream(xp))
        _build.check(lib, rc, f"{entry} launch")
        return seq if return_sequences else seq[-1]
    out = torch.empty((T, B, H) if return_sequences else (B, H), device=xp.device,
                      dtype=torch.bfloat16)
    rc = fn(_ptr(xp), *map(_ptr, states), _ptr(u), _ptr(out), T, B, H,
            CELL_ACTIVATIONS[activation], int(return_sequences), *extra, _stream(xp))
    _build.check(lib, rc, f"{entry} launch")
    return out


def _check_activation(activation):
    if activation not in CELL_ACTIVATIONS:
        raise ValueError(f"unsupported encoder scan activation {activation!r}")


def _check_gru_scan(xp, h0, u, activation):
    _check_activation(activation)
    if xp.dim() != 3:
        raise ValueError(f"xp must be (T, B, 3H), got {tuple(xp.shape)}")
    T, B = xp.shape[:2]
    H = u.shape[0]
    _check_shapes({"xp": xp, "h0": h0, "u": u},
                  {"xp": (T, B, 3 * H), "h0": (B, H), "u": (H, 3 * H)})
    return H


def gru_encoder_scan_fwd(xp, h0, u, activation="tanh", return_sequences=False):
    """The GRU layer over xp (T, B, 3H) time-major: the (T, B, H) h sequence
    or the final h (B, H). CPU tensors run ``gru_encoder_scan_reference``;
    CUDA tensors (bfloat16) launch kernel X: its chain (also counted on
    ``.launches_chain``) or, at widths the chain does not take, its
    per-block route (``.launches_block``)."""
    H = _check_gru_scan(xp, h0, u, activation)
    if not _on(xp, "gru_encoder_scan"):
        return gru_encoder_scan_reference(xp, h0, u, activation, return_sequences)
    if _layout.gru_scan_route(H) == "block":
        return gru_encoder_scan_block(xp, h0, u, activation, return_sequences)
    out = _launch("gru_encoder_scan", "X", xp, (h0,), u, activation, return_sequences)
    gru_encoder_scan_fwd.launches += 1
    gru_encoder_scan_fwd.launches_chain += 1
    return out


def gru_encoder_scan_block(xp, h0, u, activation="tanh", return_sequences=False):
    """Kernel X's per-block route (its first design), as
    ``gru_encoder_scan_fwd``: CPU tensors run ``gru_encoder_scan_reference``;
    CUDA tensors launch it where ``_layout`` lets it launch (H a multiple of
    32 up to 512), counted on ``gru_encoder_scan_fwd``'s ``.launches`` and
    ``.launches_block``."""
    _check_gru_scan(xp, h0, u, activation)
    if not _on(xp, "gru_encoder_scan"):
        return gru_encoder_scan_reference(xp, h0, u, activation, return_sequences)
    out = _launch("gru_encoder_scan", "X", xp, (h0,), u, activation, return_sequences, "block")
    gru_encoder_scan_fwd.launches += 1
    gru_encoder_scan_fwd.launches_block += 1
    return out


gru_encoder_scan_fwd.launches = 0
gru_encoder_scan_fwd.launches_chain = gru_encoder_scan_fwd.launches_block = 0


def lstm_encoder_scan_fwd(xp, h0, c0, u, activation="tanh", return_sequences=False):
    """The LSTM layer over xp (T, B, 4H) time-major: the (T, B, H) h
    sequence or the final h (B, H). CPU tensors run
    ``lstm_encoder_scan_reference``; CUDA tensors (bfloat16) launch kernel
    Y."""
    _check_activation(activation)
    if xp.dim() != 3:
        raise ValueError(f"xp must be (T, B, 4H), got {tuple(xp.shape)}")
    T, B = xp.shape[:2]
    H = u.shape[0]
    _check_shapes({"xp": xp, "h0": h0, "c0": c0, "u": u},
                  {"xp": (T, B, 4 * H), "h0": (B, H), "c0": (B, H), "u": (H, 4 * H)})
    if not _on(xp, "lstm_encoder_scan"):
        return lstm_encoder_scan_reference(xp, h0, c0, u, activation, return_sequences)
    out = _launch("lstm_encoder_scan", "Y", xp, (h0, c0), u, activation, return_sequences)
    lstm_encoder_scan_fwd.launches += 1
    return out


lstm_encoder_scan_fwd.launches = 0


def gru_encoder_scan(xp, h0, u, activation="tanh", return_sequences=False):
    """Differentiable GRU layer over xp (T, B, 3H): kernel X forward on CUDA
    tensors, ``gru_encoder_scan_vjp_reference`` recomputed under autograd
    as its backward."""
    return RematStep.apply(functools.partial(gru_encoder_scan_fwd,
                                             return_sequences=return_sequences),
                           functools.partial(gru_encoder_scan_vjp_reference,
                                             return_sequences=return_sequences),
                           activation, xp, h0, u)


def lstm_encoder_scan(xp, h0, c0, u, activation="tanh", return_sequences=False):
    """Differentiable LSTM layer over xp (T, B, 4H): kernel Y forward on
    CUDA tensors, the plain scan (the JAX reference's rounding) recomputed
    under autograd as its backward."""
    return RematStep.apply(functools.partial(lstm_encoder_scan_fwd,
                                             return_sequences=return_sequences),
                           functools.partial(lstm_encoder_scan_reference,
                                             return_sequences=return_sequences),
                           activation, xp, h0, c0, u)
