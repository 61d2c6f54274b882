"""Kernel M: a whole autoregressive LSTM decode head in one kernel.

Counterpart of ``midi_vae_tpu/ops/fused_lstm.py::fused_lstm_decode_scan``,
whose Pallas kernels ``_decode_kernel_2layer`` and ``_decode_kernel_1layer``
the CUDA kernel ``csrc/lstm_decode.cu`` replaces; its source note gives the
layout and what bounds it. ``lstm_decode_reference`` is the plain PyTorch
version (``_decode_scan_reference``): the CPU path and the kernel's oracle.

``lstm_decode`` takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises. Kernel M has two designs, one a route chosen
from the shape before any launch (``_layout.lstm_decode_route``): the decode
chain on thread-block clusters (``csrc/lstm_decode_chain.cuh``; its plan
``decode_plan``), which every serving head at H <= 512 takes, and the first,
per-block design for shapes the chain's plan refuses. The chain's plain
version phase by phase: ``lstm_decode_layer_reference`` (a layer's product
over [x | h] and its cell), B's ``decode_readout_partials_reference`` and
``decode_readout_reference``, composed by ``lstm_decode_chain_reference``.
Launches: ``lstm_decode.launches`` (either route), ``.launches_chain``,
``.launches_block``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, _layout
from .gru_decode import (OUT_ACTIVATIONS, decode_call, decode_operands,
                         decode_readout_partials_reference, decode_readout_reference,
                         out_activation_fn, packed)
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


def lstm_decode_layer_reference(x, h, c, p, act):
    """Plain version of a layer's step on M's chain: the one product [x | h]
    . [W ; U] + b, then the cell (i, f, g, o; c' = f c + i act(g), h' = o
    act(c')). Returns (h', c'), float32 (B, H) each."""
    H = h.shape[-1]
    gates = torch.cat([x, h], -1) @ torch.cat([p["w"], p["u"]]) + p["b"]
    i, f = torch.sigmoid(gates[:, :H]), torch.sigmoid(gates[:, H:2 * H])
    g, o = act(gates[:, 2 * H:3 * H]), torch.sigmoid(gates[:, 3 * H:])
    c = f * c + i * g
    return o * act(c), c


def lstm_decode_chain_reference(cell_params, out_dense, init_states, start, T, activation="tanh",
                                out_activation="softmax", cluster=8):
    """M's chain composed from its phases' plain versions: per step each
    layer's product and cell, then the readout's partials over ``cluster``
    slices of the units and their rank-order sum. Returns (probs, logits),
    (T, B, D)."""
    act = cell_activation(activation)
    states = list(init_states)
    x = start
    probs, logits = [], []
    for _ in range(T):
        for i, p in enumerate(cell_params):
            x, c = lstm_decode_layer_reference(x, *states[i], p, act)
            states[i] = (x, c)
        parts = decode_readout_partials_reference(x, out_dense["w"], cluster)
        x, lg = decode_readout_reference(parts, out_dense["b"], out_activation)
        probs.append(x)
        logits.append(lg)
    return torch.stack(probs), torch.stack(logits)


def pack_lstm_slices(cell_params, cluster, chunk):
    """The weights of an LSTM decode head's layers as M's chain reads them
    (``csrc/lstm_decode_chain.cuh``, ``LstmDecodeChainArgs::slices``): per
    layer [W ; U] as (cluster, depth, 4, H / cluster), each CTA's i, f, g and
    o columns of its units over the depth rows (layer 1's D zero-padded to
    whole chunks of ``chunk`` rows), so that every chunk of a CTA is one
    block of memory. One tensor copy a layer."""
    out = []
    for p in cell_params:
        w, u = p["w"], p["u"]
        H = u.shape[0]
        depth = -(-w.shape[0] // chunk) * chunk
        if depth != w.shape[0]:
            w = torch.cat([w, w.new_zeros(depth - w.shape[0], 4 * H)])
        wu = torch.cat([w, u])
        out.append(wu.reshape(depth + H, 4, cluster, H // cluster).permute(2, 0, 1, 3)
                   .contiguous())
    return out


@functools.cache
def _kernel():
    lib = _build.load("lstm_decode")
    fn = lib.mvt_lstm_decode
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    chain = lib.mvt_lstm_decode_chain
    chain.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    chain.restype = ctypes.c_int
    return lib, fn, chain


@functools.cache
def chain_max_clusters(cluster):
    """The card's cudaOccupancyMaxActiveClusters of M's chain at
    ``cluster`` CTAs a cluster (one CTA an SM)."""
    lib, fn = _build.load_entry("lstm_decode", "mvt_lstm_decode_max_clusters",
                                [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    _build.check(lib, fn(cluster, ctypes.byref(out)), "lstm_decode cudaOccupancyMaxActiveClusters")
    return out.value


@functools.cache
def decode_plan(H, D, n_layers, B, T=64):
    """M's chain plan (``_layout.lstm_decode_plan``) for a head of width D,
    ``n_layers`` and T steps at (H, B), at the card's active clusters where
    the plan is not a measured one; raises LaunchLimitError where the chain
    does not launch."""
    p = _layout.lstm_decode_plan(H, D, n_layers, B, T=T)
    if (H, D, n_layers, T, B) in _layout.LSTM_DEC_MEASURED:
        return p
    return _layout.lstm_decode_plan(H, D, n_layers, B, p.cluster, T=T,
                                    max_clusters=chain_max_clusters(p.cluster), nb=p.nb)


def lstm_decode(cell_params, out_dense, init_states, start, T, activation="tanh",
                out_activation="softmax", plan=None):
    """Readout decode of one head: ``cell_params`` a list of 1 or 2 LSTM
    layer params {w, u, b}, ``out_dense`` {w, b}, ``init_states`` one (h, c)
    pair of (B, H) per layer, ``start`` (B, D) the input of step 0. Returns
    (probs, logits), each (T, B, D). The call goes through the registered
    operator ``mvt::lstm_decode`` (``ops/_custom.py``; the head flattened by
    ``decode_operands``) on either device: CPU tensors run
    ``lstm_decode_reference``; CUDA tensors launch kernel M
    (``lstm_decode_cuda``): its chain on clusters at ``plan`` (a
    ``_layout.LstmDecodePlan``; default ``decode_plan``'s) where
    ``_layout.lstm_decode_route`` says "chain", else its per-block build."""
    return torch.ops.mvt.lstm_decode(*decode_operands(cell_params, out_dense, init_states, start,
                                                      "M"),
                                     T, activation, out_activation,
                                     None if plan is None else [int(v) for v in plan])


def _check_decode(cell_params, out_dense, init_states, start, activation, out_activation):
    """Shapes of kernel M's operands and, on the card, their device, dtype
    and contiguity. Returns (B, D, H, the operands by name)."""
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
    if start.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_decode runs on cpu or cuda tensors, not {start.device}")
    if start.device.type == "cuda":
        check_operands(named, start.device)
    return B, D, H, named


def lstm_decode_cpu(*args):
    """``mvt::lstm_decode``'s CPU implementation: the plain version."""
    cells, out_dense, init_states, start, T, activation, out_activation, _ = decode_call(args, "M")
    _check_decode(cells, out_dense, init_states, start, activation, out_activation)
    return lstm_decode_reference(cells, out_dense, init_states, start, T, activation,
                                 out_activation)


def lstm_decode_fake(*args):
    """``mvt::lstm_decode``'s fake implementation: (probs, logits), float32
    (T, B, D), after the real ones' checks."""
    cells, out_dense, init_states, start, T, activation, out_activation, _ = decode_call(args, "M")
    B, D, _, _ = _check_decode(cells, out_dense, init_states, start, activation, out_activation)
    return start.new_empty(T, B, D), start.new_empty(T, B, D)


def lstm_decode_cuda(*args):
    """``mvt::lstm_decode``'s CUDA implementation: kernel M, its chain at
    the plan (its fields as ints; default ``decode_plan``'s) or its
    per-block route."""
    cell_params, out_dense, init_states, start, T, activation, out_activation, plan = decode_call(
        args, "M")
    n_layers = len(cell_params)
    B, D, H, named = _check_decode(cell_params, out_dense, init_states, start, activation,
                                   out_activation)
    if start.device.type != "cuda":
        raise ValueError(f"lstm_decode: start is on {start.device}, the other operands on the card")
    if T < 1:
        raise ValueError(f"kernel M takes T >= 1; got T={T}")
    route = _layout.lstm_decode_route(H, D, n_layers)
    if route == "block" and plan is not None:
        raise ValueError(f"kernel M takes its per-block route at H={H}: no chain plan applies")
    probs = torch.empty((T, B, D), device=start.device, dtype=torch.float32)
    logits = torch.empty_like(probs)
    null = ctypes.c_void_p(None)
    opt = lambda name: _ptr(named[name]) if name in named else null  # noqa: E731
    tail = (_ptr(out_dense["w"]), _ptr(out_dense["b"]), _ptr(probs), _ptr(logits),
            T, B, D, H, n_layers, CELL_ACTIVATIONS[activation], OUT_ACTIVATIONS[out_activation])
    stream = ctypes.c_void_p(torch.cuda.current_stream(start.device).cuda_stream)
    lib, fn, chain_fn = _kernel()
    if route == "block":
        _layout.require("M", H, _layout.smem_bytes("M", H, D, n_layers))
        rc = fn(_ptr(start), opt("h1"), opt("c1"), opt("h2"), opt("c2"),
                opt("w1"), opt("u1"), opt("b1"), opt("w2"), opt("u2"), opt("b2"), *tail, stream)
        _build.check(lib, rc, "lstm_decode launch")
        lstm_decode.launches_block += 1
    else:
        plan = (decode_plan(H, D, n_layers, B, T) if plan is None
                else _layout.LstmDecodePlan(*plan))
        slices = packed(cell_params, pack_lstm_slices, plan.cluster, plan.chunk)
        rc = chain_fn(_ptr(start), opt("h1"), opt("c1"), opt("h2"), opt("c2"),
                      *(_ptr(t) for t in slices), *([null] * (2 - len(slices))),
                      opt("b1"), opt("b2"), *tail, plan.cluster, plan.rows, plan.splits,
                      plan.stages, plan.chunk, plan.nb, stream)
        _build.check(lib, rc, "lstm_decode chain launch")
        lstm_decode.launches_chain += 1
    lstm_decode.launches += 1
    return probs, logits


lstm_decode.launches = 0  # every launch of kernel M, either route
lstm_decode.launches_chain = 0  # the launches of its chain
lstm_decode.launches_block = 0  # the launches of its per-block route
