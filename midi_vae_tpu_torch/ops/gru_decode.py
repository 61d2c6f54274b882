"""Kernel B: a whole autoregressive GRU decode head in one kernel.

Counterpart of ``midi_vae_tpu/ops/fused_decoder.py::fused_decode_scan``,
whose Pallas kernels ``_decode_kernel_2layer`` and ``_decode_kernel_1layer``
the CUDA kernel ``csrc/gru_decode.cu`` replaces; its source note gives the
layout and what bounds it. ``gru_decode_reference`` is the plain PyTorch
version (``_decode_scan_reference``): the CPU path and the kernel's oracle.

``gru_decode`` takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises. Kernel B has two designs, one a route chosen
from the shape before any launch (``_layout.gru_decode_route``): the decode
chain on thread-block clusters (``csrc/gru_decode_chain.cuh``; its plan
``decode_plan``), which every serving head at H <= 512 takes, and the first,
per-block design for shapes the chain's plan refuses. The chain's plain
version phase by phase: ``decode_layer_p1_reference``,
``decode_layer_p2_reference``, ``decode_readout_partials_reference``,
``decode_readout_reference``, composed by ``gru_decode_chain_reference``.

Training: ``gru_decode_train`` (one head, counterpart of
``midi_vae_tpu/ops/fused_train.py::gru_decode_train``) and
``gru_decode_multihead_train`` (a 2-layer primary head plus 1-layer side
heads, counterpart of ``::gru_decode_multihead_train``) are one
``torch.autograd.Function``. Its forward is kernel D
(``csrc/gru_decode_train.cu``, replacing ``_dec_fwd1/2_kernel`` and
``_mh_fwd_kernel``): each head emitting its layers' h sequences beside its
probs and logits. Its backward is kernel E
(``csrc/gru_decode_bwd.cu``, replacing ``_dec_bwd1/2_kernel`` and
``_mh_bwd_kernel``) for the gate grads, d_init and d_start, then kernel W
(``ops/grad_reduce.py``) for every weight grad. The plain versions are
``gru_decode_train_reference`` and ``gru_decode_bwd_reference``. On the
card E runs as two phases (``csrc/gru_cell_bwd_chain.cuh``), each with its
plain version and its launch counts (``E_PHASES``): C's gate pre-pass for
every layer of the call's heads (``gru_decode_bwd_gates``, from each
layer's stored inputs, ``_layer_inputs``; two launches a layer), then one
chain on thread-block clusters through every head (``gru_decode_bwd_chain``,
``gru_decode_bwd_chain_reference``; its plan ``gru_bptt_plan``; one launch
a call); the build (``_BUILDS``) picks the chain's entry point, and the
chain's launch also counts on the build's counter.

Every build of D runs one head a launch on kernel B's decode chain in its
training instance (``csrc/gru_decode_chain.cuh``: each layer's h sequence
stored from the X2 exchange; in bf16 the slices streamed in bf16 and the
roundings below; D resid's h sequences stored in bf16), at ``dec_plan``'s
plan (``_layout.dec_train_plan``: ``DEC_TRAIN_MEASURED`` at the paths'
heads), the weights' slices packed once a step (``_packed_slices``: the
optimizer's in-place update repacks, in the step's time); the heads of a
call are launches in turn on the current stream (``_launch_heads``). The
first, per-block designs stay the route of shapes the chain's plan refuses
(``_layout.dec_train_route``): 8 batch rows a block for D, D bf16 and D
resid, 2 rows under ``__launch_bounds__(512)`` for the wide builds, the
per-block heads of a call in one launch. A tensor-core instance of the same
chain (``pack_tc_slices``, ``GruDecodePlan.tc``) is built and timed, and no
shape takes it: it lost to the FFMA chain everywhere the H100 ran it.
``gru_decode_train_chain_reference`` is the chain's plain version phase by
phase. The builds keep their names ("D", "D_bf16", "D_resid" for the
narrow route, "D_wide", "D_wide_bf16" for the wide one; ``ops/_layout.py``
reads them as their per-block designs' launch limits), and the wrappers
``gru_decode_fwd_train`` and ``gru_decode_fwd_train_wide`` count each
launch on the build's counter (``.launches``, ``.launches_bf16``,
``.launches_resid``) and on its route's (``.launches_chain``,
``.launches_block`` with the same suffixes). E's wide builds replace
``_dec_bwd_wide_pallas`` on E's chain. Every build has a name
(``ops/_layout.py``: "D", "E_wide_bf16", ...); the wrappers and
``gru_decode_train`` take it as ``build`` / ``builds``, and ``_BUILDS``
gives each its entry points and its counter.

The narrow D and E also have a bfloat16 build (``mvt_gru_decode_train_bf16``,
``mvt_gru_decode_bwd_bf16``), picked by the operands' dtype: a bf16 model
(``compute_dtype="bfloat16"``) decodes each head alone through
``gru_decode_train`` (the multi-head call is float32 only), as the JAX
package runs ``_dec_fwd1/2_kernel`` and ``_dec_bwd1/2_kernel`` in bf16. The
forward takes its products in float32 and rounds only what the Pallas kernel
stores: the carried states, the h sequences, probs and logits, and the probs
fed back as the next input; layer 2 takes layer 1's float32 h of the same
step and the readout the float32 top h. The backward widens the stored
sequences and probs to float32 and runs in float32 (it recomputes layer 2
from the stored bf16 h1: the pre-pass takes the bf16 products exactly, the
chain's products run on the tensor cores with the float da in three bf16
terms); d_init and d_start leave in bf16, the gate grads
and dlogits in float32 for W, and the weight grads are rounded to the params'
dtype at the end (``_gdt_bwd``). A head narrower than 8 (velocity, held
notes) is promoted whole to float32 and takes the float32 builds, as
``gru_decode_train`` does on the TPU (``fused_train.py:813-825``).

The wide builds have bfloat16 builds too (``D_wide_bf16``,
``mvt_gru_decode_bwd_wide_bf16``): a bf16 model at H = 512 runs
``_dec_fwd1/2_kernel`` and ``_dec_bwd1/2_wide_kernel`` in bf16 on the
batch-tiled grid, then ``_dec_wide_weight_grads``. The forward rounds as the
narrow bf16 build does (one chain instance for both). The backward differs
in what it emits: the TPU
stores dlogits and the gate grads for its second pass rounded to bf16
(``fused_train.py:1214-1244``) and sums the weight grads from those, so E
wide's bf16 build emits them as bf16 values (in float32 tensors), and W sums
them; the narrow route's bf16 E keeps them unrounded, as ``_dec_bwd1/2_kernel``
sums its weight grads from the float32 values in VMEM. The carries, r * h,
d_init and d_start are as in the narrow bf16 build. E's wide build has a
second bf16 build with that narrow rounding (build "E_wide_row8_bf16", the
narrow bf16 build's chain ``mvt_gru_decode_bwd_bf16``): where the TPU runs a
bf16 head through rows 7 and 8 at a width the 8-row builds do not launch at
(``ops/_layout.py``, ``head_builds``: D's narrow build), the head takes D's
wide bf16 build (rows 7 and 13 share ``_dec_fwd1/2_kernel``) and this one
(``.launches_row8_bf16``).

A float32 model with ``decode_residual_bf16`` stores the multi-head call's
h sequences in bfloat16 (``residual_dtype``, ``_mh_fwd_kernel``'s
``residual_dtype``): D's bf16-residual build ("D_resid",
``mvt_gru_decode_train_resid``) computes the float32 build's carries, probs
and logits bit for bit (the same chain arithmetic at the same plan) and
stores the sequences rounded; E's ("E_resid",
the float32 chain ``mvt_gru_decode_bwd``) reads them and recomputes the
gates from the rounded h, as ``_mh_bwd_kernel`` does (the initial states
unrounded at t = 0, layer 1's x the float32 probs); W sums
dWo and layer 2's dW over the rounded sequences (its bf16 build) and every
dU over h_{t-1} widened beside the unrounded initial state (its float32
build). Launches: ``.launches_resid``.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from . import _build, _layout
from .grad_reduce import grad_reduce, gru_weight_grads
from .gru_layer import (CELL_ACTIVATIONS, _ptr, _stream, bwd_gates,
                        cell_activation, check_operands, gru_bptt_plan, gru_bwd_cell_reference,
                        gru_bwd_gates_reference, gru_cell_bwd_core, gru_step)

_BF16 = torch.bfloat16

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


def decode_layer_p1_reference(x, h, p):
    """Plain version of a layer's P1 in B's chain: x . W (z, r and the
    candidate's x part) + h . U_zr, then z and r: returns (z, r * h, the
    candidate's x W_h + b_h), float32 (B, H) each."""
    H = h.shape[-1]
    xw = x @ p["w"] + p["b"]
    hu = h @ p["u"][:, :2 * H]
    z = torch.sigmoid(xw[:, :H] + hu[:, :H])
    r = torch.sigmoid(xw[:, H:2 * H] + hu[:, H:])
    return z, r * h, xw[:, 2 * H:]


def decode_layer_p2_reference(z, rh, cand, h, u, act):
    """Plain version of a layer's P2 in B's chain: hh = act((r h) . U_h +
    cand), h' = z h + (1 - z) hh."""
    H = h.shape[-1]
    return z * h + (1.0 - z) * act(cand + rh @ u[:, 2 * H:])


def decode_readout_partials_reference(h, wo, cluster):
    """Plain version of the chain's readout partials: CTA c's logits over its
    own H / cluster units of h, (cluster, B, D)."""
    return torch.stack([hc @ wc for hc, wc in zip(h.chunk(cluster, -1), wo.chunk(cluster, 0))])


def decode_readout_reference(partials, bo, out_activation):
    """Plain version of the readout's sum: the partials in cluster-rank
    order, then bo; returns (probs, logits)."""
    logits = partials[0]
    for part in partials[1:]:
        logits = logits + part
    logits = logits + bo
    return out_activation_fn(out_activation)(logits), logits


def gru_decode_chain_reference(cells, out_dense, init_states, start, T, activation="tanh",
                               out_activation="softmax", cluster=8):
    """B's chain composed from its phases' plain versions: per step each
    layer's P1 and P2, then the readout's partials over ``cluster`` slices
    of the units and their sum. Returns (probs, logits), (T, B, D)."""
    act = cell_activation(activation)
    states = list(init_states)
    x = start
    probs, logits = [], []
    for _ in range(T):
        for i, p in enumerate(cells):
            z, rh, cand = decode_layer_p1_reference(x, states[i], p)
            x = states[i] = decode_layer_p2_reference(z, rh, cand, states[i], p["u"], act)
        parts = decode_readout_partials_reference(x, out_dense["w"], cluster)
        x, lg = decode_readout_reference(parts, out_dense["b"], out_activation)
        probs.append(x)
        logits.append(lg)
    return torch.stack(probs), torch.stack(logits)


@functools.cache
def _kernel():
    lib = _build.load("gru_decode")
    fn = lib.mvt_gru_decode
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    chain = lib.mvt_gru_decode_chain
    chain.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    chain.restype = ctypes.c_int
    return lib, fn, chain


def pack_slices(cells, cluster, chunk):
    """The weights of a decode head's layers as B's chain reads them
    (``csrc/gru_decode_chain.cuh``, ``GruDecodeChainArgs::slices``): per
    layer its x segment (cluster, depth, 3, H / cluster: W's z, r and
    candidate columns of each CTA's units; layer 1's depth D zero-padded to
    whole chunks of ``chunk`` rows), its h segment (cluster, H,
    2, H / cluster: U's z and r columns) and P2's (cluster, H, 1, H /
    cluster: U's candidate columns), each contiguous, so that every chunk of
    a CTA is one block of memory. Three tensor copies a layer, in the
    weights' dtype."""
    out = []
    for p in cells:
        w, u = p["w"], p["u"]
        H = u.shape[0]
        Hc, depth = H // cluster, -(-w.shape[0] // chunk) * chunk
        if depth != w.shape[0]:
            w = torch.cat([w, w.new_zeros(depth - w.shape[0], 3 * H)])
        out.append(w.reshape(depth, 3, cluster, Hc).permute(2, 0, 1, 3).contiguous())
        out.append(u[:, :2 * H].reshape(H, 2, cluster, Hc).permute(2, 0, 1, 3).contiguous())
        out.append(u[:, 2 * H:].reshape(H, 1, cluster, Hc).permute(2, 0, 1, 3).contiguous())
    return out


def pack_tc_slices(cells, cluster, chunk):
    """``pack_slices`` in the order D wide's tensor-core instance reads
    them (``csrc/gru_decode_chain.cuh``): each segment (cluster, depth,
    width) as B fragments (cluster, depth / 8, width / 8, 8, 4, 2), entry
    (c, k, n, g, t, j) its depth row 8 k + 4 j + t of column 8 n + g; a
    chunk of depth rows stays one contiguous block."""
    out = []
    for t in pack_slices(cells, cluster, chunk):
        C, depth = t.shape[:2]
        width = t.shape[2] * t.shape[3]
        out.append(t.reshape(C, depth // 8, 2, 4, width // 8, 8).permute(0, 1, 4, 5, 3, 2)
                   .contiguous())
    return out


# packed slices of recent heads: (the weights' weak references, their version
# counters, the packed tensors) by (the packing function, the weights' ids,
# its arguments)
_PACKED: dict = {}


def packed(cells, pack, *args):
    """``pack(cells, *args)`` (``pack_slices``, ``pack_tc_slices`` or kernel
    M's ``pack_lstm_slices``), kept while the weights are the same tensors
    and unchanged (their version counters: an in-place update, as the
    optimizer's at every step, repacks), so that serving the same heads
    again packs nothing; inference tensors (no version counter) are packed
    every call. ``packed.packs`` counts the calls that pack."""
    ts = [p[k] for p in cells for k in ("w", "u")]
    try:
        versions = tuple(t._version for t in ts)
    except RuntimeError:
        packed.packs += 1
        return pack(cells, *args)
    key = (pack.__name__, tuple(id(t) for t in ts), *args)
    hit = _PACKED.get(key)
    if hit and hit[1] == versions and all(r() is t for r, t in zip(hit[0], ts)):
        return hit[2]
    packed.packs += 1
    out = pack(cells, *args)
    if len(_PACKED) >= 16:
        _PACKED.clear()
    _PACKED[key] = ([weakref.ref(t) for t in ts], versions, out)
    return out


packed.packs = 0


def _packed_slices(cells, cluster, chunk, tc=False):
    """``packed`` ``pack_slices`` (``tc``: ``pack_tc_slices``) of ``cells``."""
    return packed(cells, pack_tc_slices if tc else pack_slices, cluster, chunk)


@functools.cache
def chain_max_clusters(cluster):
    """The card's cudaOccupancyMaxActiveClusters of B's chain at ``cluster``
    CTAs a cluster (one CTA an SM)."""
    lib, fn = _build.load_entry("gru_decode", "mvt_gru_decode_max_clusters",
                                [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    _build.check(lib, fn(cluster, ctypes.byref(out)), "gru_decode cudaOccupancyMaxActiveClusters")
    return out.value


@functools.cache
def decode_plan(H, D, n_layers, B, T=64):
    """B's chain plan (``_layout.gru_decode_plan``) for a head of width D,
    ``n_layers`` and T steps at (H, B), at the card's active clusters;
    raises LaunchLimitError where the chain does not launch."""
    p = _layout.gru_decode_plan(H, D, n_layers, B, T=T)
    if (H, D, n_layers, T, B) in _layout.DEC_MEASURED:
        return p
    return _layout.gru_decode_plan(H, D, n_layers, B, p.cluster, T=T,
                                   max_clusters=chain_max_clusters(p.cluster))


def gru_decode(cells, out_dense, init_states, start, T, activation="tanh",
               out_activation="softmax", plan=None):
    """Readout decode of one head: ``cells`` is a list of 1 or 2 GRU layer
    params {w, u, b}, ``out_dense`` {w, b}, ``init_states`` one (B, H) state
    per layer, ``start`` (B, D) the input of step 0. Returns (probs, logits),
    each (T, B, D). The call goes through the registered operator
    ``mvt::gru_decode`` (``ops/_custom.py``; the head flattened by
    ``decode_operands``) on either device: CPU tensors run
    ``gru_decode_reference``; CUDA tensors launch kernel B
    (``gru_decode_cuda``): its chain on clusters at ``plan`` (a
    ``_layout.GruDecodePlan``; default ``decode_plan``'s) where
    ``_layout.gru_decode_route`` says "chain", else its per-block build."""
    return torch.ops.mvt.gru_decode(*decode_operands(cells, out_dense, init_states, start, "B"),
                                    T, activation, out_activation,
                                    None if plan is None else [int(v) for v in plan])


def decode_operands(cells, out_dense, init_states, start, letter):
    """A 1- or 2-layer head flattened into the operands of ``mvt::gru_decode``
    (``letter`` "B": h a layer) or ``mvt::lstm_decode`` ("M": h and c):
    start, layer 1's state, w, u and b, layer 2's (None for a 1-layer head),
    wo, bo."""
    n_layers = len(cells)
    if n_layers not in (1, 2) or len(init_states) != n_layers:
        raise ValueError(f"kernel {letter} decodes 1- or 2-layer heads with one state per "
                         f"layer, got {n_layers} layers and {len(init_states)} states")
    ops = [start]
    for i in range(2):
        if i < n_layers:
            state = list(init_states[i]) if letter == "M" else [init_states[i]]
            ops += [*state, cells[i]["w"], cells[i]["u"], cells[i]["b"]]
        else:
            ops += [None] * (5 if letter == "M" else 4)
    return (*ops, out_dense["w"], out_dense["b"])


def decode_call(args, letter):
    """The operator's arguments (``decode_operands``, then T, activation,
    out_activation and the plan's fields or None) back as (cells,
    out_dense, init_states, start, T, activation, out_activation, plan)."""
    ops, (T, activation, out_activation, plan) = args[:-4], args[-4:]
    start, rest, (wo, bo) = ops[0], ops[1:-2], ops[-2:]
    per = len(rest) // 2
    cells, states = [], []
    for layer in (rest[:per], rest[per:]):
        if layer[-1] is None:
            continue
        state, (w, u, b) = layer[:-3], layer[-3:]
        cells.append({"w": w, "u": u, "b": b})
        states.append(tuple(state) if letter == "M" else state[0])
    return cells, {"w": wo, "b": bo}, states, start, T, activation, out_activation, plan


def _check_decode(cells, out_dense, init_states, start, activation, out_activation):
    """Shapes of kernel B's operands and, on the card, their device, dtype
    and contiguity. Returns (B, D, H)."""
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
    if start.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gru_decode runs on cpu or cuda tensors, not {start.device}")
    if start.device.type == "cuda":
        check_operands(named, start.device)
    return B, D, H


def gru_decode_cpu(*args):
    """``mvt::gru_decode``'s CPU implementation: the plain version."""
    cells, out_dense, init_states, start, T, activation, out_activation, _ = decode_call(args, "B")
    _check_decode(cells, out_dense, init_states, start, activation, out_activation)
    return gru_decode_reference(cells, out_dense, init_states, start, T, activation,
                                out_activation)


def gru_decode_fake(*args):
    """``mvt::gru_decode``'s fake implementation: (probs, logits), float32
    (T, B, D), after the real ones' checks."""
    cells, out_dense, init_states, start, T, activation, out_activation, _ = decode_call(args, "B")
    B, D, _ = _check_decode(cells, out_dense, init_states, start, activation, out_activation)
    return start.new_empty(T, B, D), start.new_empty(T, B, D)


def gru_decode_cuda(*args):
    """``mvt::gru_decode``'s CUDA implementation: kernel B, its chain at the
    plan (its fields as ints; default ``decode_plan``'s) or its per-block
    route."""
    cells, out_dense, init_states, start, T, activation, out_activation, plan = decode_call(
        args, "B")
    n_layers = len(cells)
    B, D, H = _check_decode(cells, out_dense, init_states, start, activation, out_activation)
    if start.device.type != "cuda":
        raise ValueError(f"gru_decode: start is on {start.device}, the other operands on the card")
    if T < 1:
        raise ValueError(f"kernel B takes T >= 1; got T={T}")
    if _layout.gru_decode_route(H, D, n_layers) == "block":
        if plan is not None:
            raise ValueError(f"kernel B takes its per-block route at H={H}: no chain plan applies")
        return _decode_per_block(cells, out_dense, init_states, start, T, activation,
                                 out_activation)
    plan = (decode_plan(H, D, n_layers, B, T) if plan is None
            else _layout.GruDecodePlan(*plan[:-1], bool(plan[-1])))
    probs, logits, states, tail, stream = _launch_operands(cells, out_dense, init_states, start,
                                                           T, activation, out_activation)
    two = n_layers == 2
    null = ctypes.c_void_p(None)
    lib, _, chain_fn = _kernel()
    slices = list(_packed_slices(cells, plan.cluster, plan.chunk))
    slices += [None] * (6 - len(slices))
    rc = chain_fn(*states, *(_ptr(t) if t is not None else null for t in slices),
                  _ptr(cells[0]["b"]), _ptr(cells[1]["b"]) if two else null, *tail,
                  plan.cluster, plan.rows, plan.splits, plan.stages, plan.chunk, stream)
    _build.check(lib, rc, "gru_decode chain launch")
    gru_decode.launches += 1
    gru_decode.launches_chain += 1
    return probs, logits


def _launch_operands(cells, out_dense, init_states, start, T, activation, out_activation):
    """The outputs (probs, logits) of either route's launch, its first
    pointers (start and the initial states), its tail (Wo, bo, the outputs,
    the sizes and codes) and the caller's stream."""
    B, D = start.shape
    H = init_states[0].shape[-1]
    probs = torch.empty((T, B, D), device=start.device, dtype=torch.float32)
    logits = torch.empty_like(probs)
    two = len(cells) == 2
    states = (_ptr(start), _ptr(init_states[0]),
              _ptr(init_states[1]) if two else ctypes.c_void_p(None))
    tail = (_ptr(out_dense["w"]), _ptr(out_dense["b"]), _ptr(probs), _ptr(logits),
            T, B, D, H, len(cells), CELL_ACTIVATIONS[activation], OUT_ACTIVATIONS[out_activation])
    stream = ctypes.c_void_p(torch.cuda.current_stream(start.device).cuda_stream)
    return probs, logits, states, tail, stream


def _decode_per_block(cells, out_dense, init_states, start, T, activation="tanh",
                      out_activation="softmax"):
    """Kernel B's first, per-block design on operands ``gru_decode`` has
    checked: its route for shapes the chain's plan refuses (chip_smoke.py
    also holds kernel D, which keeps this design's body, bit-equal to it)."""
    H, D = init_states[0].shape[-1], start.shape[1]
    _layout.require("B", H, _layout.smem_bytes("B", H, D, len(cells)))
    probs, logits, states, tail, stream = _launch_operands(cells, out_dense, init_states, start,
                                                           T, activation, out_activation)
    two = len(cells) == 2
    null = ctypes.c_void_p(None)
    lib, fn, _ = _kernel()
    rc = fn(*states, _ptr(cells[0]["w"]), _ptr(cells[0]["u"]), _ptr(cells[0]["b"]),
            _ptr(cells[1]["w"]) if two else null, _ptr(cells[1]["u"]) if two else null,
            _ptr(cells[1]["b"]) if two else null, *tail, stream)
    _build.check(lib, rc, "gru_decode launch")
    gru_decode.launches += 1
    return probs, logits


gru_decode.launches = 0  # every launch of kernel B, either route
gru_decode.launches_chain = 0  # the launches of its chain


# ---------------------------------------------------------------------------
# Training: kernel D (forward with residuals), kernel E + W (backward)
# ---------------------------------------------------------------------------

MAX_HEADS = 4  # heads per launch of kernels D and E (kMaxHeads)


def dlogits_from(probs, gp_total, g_logits, out_activation):
    """Grad of the logits from the grads of probs (its loss grad plus the
    feedback into the next step) and of the logits (``_dlogits_from``)."""
    if out_activation == "softmax":
        return probs * (gp_total - (gp_total * probs).sum(-1, keepdim=True)) + g_logits
    if out_activation == "sigmoid":
        return gp_total * probs * (1.0 - probs) + g_logits
    return gp_total + g_logits


def gru_decode_train_reference(cells, out_dense, init_states, start, T, out_activation="softmax",
                               residual_dtype=None):
    """Plain version of kernel D for one head (tanh cells): (probs, logits,
    [h sequence of each layer]), all (T, B, .) time-major in start's dtype,
    the h sequences in ``residual_dtype`` when given. Each layer's h is
    float32 within the step (the next layer's input, the readout's); the
    carried states, the outputs and the fed-back probs are rounded to
    start's dtype (``_dec_fwd1/2_kernel``: no-ops in float32), the stored
    sequences to ``residual_dtype`` (``_mh_fwd_kernel``)."""
    out_act = out_activation_fn(out_activation)
    dtype = start.dtype
    rdt = residual_dtype or dtype
    states = list(init_states)
    x = start
    probs, logits, hs = [], [], [[] for _ in cells]
    for _ in range(T):
        for i, p in enumerate(cells):
            x = gru_step(x, states[i], p["w"], p["u"], p["b"], torch.tanh, torch.float32)
            states[i] = x.to(dtype)
            hs[i].append(x.to(rdt))
        lg = x @ out_dense["w"].float() + out_dense["b"].float()
        x = out_act(lg).to(dtype)
        probs.append(x)
        logits.append(lg.to(dtype))
    return torch.stack(probs), torch.stack(logits), [torch.stack(h) for h in hs]


def gru_decode_train_chain_reference(cells, out_dense, init_states, start, T,
                                     out_activation="softmax", cluster=8, residual_dtype=None):
    """D's chain (B's decode chain in its training instance) composed from
    the phases' plain versions: per step each layer's P1 and P2 in float32
    over the widened operands, the readout's partials over ``cluster``
    slices of the units summed in rank order, then the roundings of a bf16
    head (``csrc/gru_decode_body.cuh``): the carries after the readout has
    read them, the fed-back probs, and probs, logits and the h sequences as
    stored (in ``residual_dtype`` where given: D resid's instance). Returns
    (probs, logits, [h sequence of each layer]) in start's dtype, (T, B, .)
    each."""
    dtype = start.dtype
    rdt = residual_dtype or dtype
    cells = [{k: c[k].float() for k in ("w", "u", "b")} for c in cells]
    out_dense = {k: out_dense[k].float() for k in ("w", "b")}
    states = [s.float() for s in init_states]
    x = start.float()
    probs, logits, hs = [], [], [[] for _ in cells]
    for _ in range(T):
        for i, p in enumerate(cells):
            z, rh, cand = decode_layer_p1_reference(x, states[i], p)
            x = decode_layer_p2_reference(z, rh, cand, states[i], p["u"], torch.tanh)
            hs[i].append(x.to(rdt))
            states[i] = x  # layer i + 1 and the readout read it float
        parts = decode_readout_partials_reference(x, out_dense["w"], cluster)
        pr, lg = decode_readout_reference(parts, out_dense["b"], out_activation)
        states = [s.to(dtype).float() for s in states]
        x = pr.to(dtype).float()
        probs.append(x.to(dtype))
        logits.append(lg.to(dtype))
    return torch.stack(probs), torch.stack(logits), [torch.stack(h) for h in hs]


def gru_decode_bwd_reference(cells, out_dense, init_states, start, probs, h_seqs, g_probs,
                             g_logits, out_activation="softmax", wide=False):
    """Plain version of kernel E for one head: the reverse-time transpose of
    the decode (``_dec_bwd1/2_kernel``), emitting the gate grads instead of
    summing the weight grads. Returns {dlogits (T, B, D), da [per layer
    (T, B, 3H)], rh [per layer (T, B, H)], d_init [per layer (B, H)],
    d_start (B, D)}. Every operand is widened to float32 and the transpose
    runs in float32; d_init and d_start leave in start's dtype, the rest in
    float32. ``wide``: E's wide build (``_dec_bwd1/2_wide_kernel``), which
    emits dlogits and the gate grads rounded to start's dtype (still float32
    tensors; the carries read them unrounded); a no-op in float32. h_seqs
    stored in bfloat16 beside a float32 head (``decode_residual_bf16``) are
    read as stored: the gates are recomputed from the rounded h, h_{t-1} at
    t = 0 is the unrounded initial state (``_mh_bwd_kernel``)."""
    dtype = start.dtype
    cells = [{k: c[k].float() for k in ("w", "u", "b")} for c in cells]
    out_dense = {k: out_dense[k].float() for k in ("w", "b")}
    init_states, h_seqs = [s.float() for s in init_states], [h.float() for h in h_seqs]
    start, probs, g_probs, g_logits = (t.float() for t in (start, probs, g_probs, g_logits))
    T = probs.shape[0]
    n = len(cells)
    dh = [torch.zeros_like(s) for s in init_states]
    dx_fed = torch.zeros_like(start)
    dlog = [None] * T
    da = [[None] * T for _ in range(n)]
    rh = [[None] * T for _ in range(n)]
    for t in reversed(range(T)):
        dlog[t] = dlogits_from(probs[t], g_probs[t] + dx_fed, g_logits[t], out_activation)
        d = dlog[t] @ out_dense["w"].t() + dh[n - 1]
        for i in reversed(range(n)):
            x = h_seqs[i - 1][t] if i > 0 else (probs[t - 1] if t > 0 else start)
            hp = h_seqs[i][t - 1] if t > 0 else init_states[i]
            p = cells[i]
            dx, dh[i], da[i][t], rh[i][t] = gru_cell_bwd_core(x, hp, p["w"], p["u"], p["b"], d)
            if i > 0:
                d = dx + dh[i - 1]
            else:
                dx_fed = dx
    stream = (lambda a: torch.stack(a).to(dtype).float()) if wide else torch.stack
    return {"dlogits": stream(dlog), "da": [stream(a) for a in da],
            "rh": [torch.stack(a) for a in rh], "d_init": [d.to(dtype) for d in dh],
            "d_start": dx_fed.to(dtype)}


_DECODE_PTRS = ("start", "h1_0", "h2_0", "w1", "u1", "b1", "w2", "u2", "b2", "wo", "bo",
                "probs", "logits", "h1seq", "h2seq")
_INTS = ("D", "n_layers", "out_act", "T")
_CHAIN_PTRS = ("gates1", "gates2", "hprev1", "hprev2", "probs", "g_probs", "g_logits",
               "u1t", "w1t", "u2t", "w2t", "wo", "dlogits", "da1", "da2", "d_h1_0", "d_h2_0",
               "d_start")
_CHAIN_INTS = ("D", "Dp", "n_layers", "out_act", "T", "rows", "clusters")


class _DecodeHead(ctypes.Structure):
    """struct DecodeHead of csrc/gru_decode_train.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in _DECODE_PTRS] + [(n, ctypes.c_int) for n in _INTS]


class _HeadBwdChain(ctypes.Structure):
    """struct HeadBwdChain of csrc/gru_cell_bwd_chain.cuh."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _CHAIN_PTRS]
                + [(n, ctypes.c_int) for n in _CHAIN_INTS])


def _check_heads(heads, build: str) -> tuple[int, int, torch.device, torch.dtype]:
    """Shapes of a list of training heads, and on the card their dtype (one
    for all: bfloat16 for a ``_bf16`` build, else float32) and whether
    ``build`` (a name of ``_BUILDS``) launches; returns (B, H, device,
    dtype)."""
    if build not in _BUILDS:
        raise ValueError(f"kernels D and E have the builds {', '.join(_BUILDS)}, not {build!r}")
    if not 1 <= len(heads) <= MAX_HEADS:
        raise ValueError(f"kernels D and E take 1 to {MAX_HEADS} heads per call, got {len(heads)}")
    B, H = heads[0]["start"].shape[0], heads[0]["init"][0].shape[-1]
    for k, h in enumerate(heads):
        n_layers = len(h["cells"])
        if n_layers not in (1, 2) or len(h["init"]) != n_layers:
            raise ValueError(f"head {k}: 1- or 2-layer heads with one state per layer, got "
                             f"{n_layers} layers and {len(h['init'])} states")
        if h["out_activation"] not in OUT_ACTIVATIONS:
            raise ValueError(f"head {k}: unsupported decode output activation {h['out_activation']!r}")
        if h["T"] < 1:
            raise ValueError(f"head {k}: T must be >= 1, got {h['T']}")
        D = h["start"].shape[-1]
        named = {"start": h["start"], "wo": h["out"]["w"], "bo": h["out"]["b"]}
        expected = {"start": (B, D), "wo": (H, D), "bo": (D,)}
        for i, (p, s0) in enumerate(zip(h["cells"], h["init"])):
            d_in = D if i == 0 else H
            named.update({f"w{i + 1}": p["w"], f"u{i + 1}": p["u"], f"b{i + 1}": p["b"],
                          f"h{i + 1}": s0})
            expected.update({f"w{i + 1}": (d_in, 3 * H), f"u{i + 1}": (H, 3 * H),
                             f"b{i + 1}": (3 * H,), f"h{i + 1}": (B, H)})
        for name, t in named.items():
            if tuple(t.shape) != expected[name]:
                raise ValueError(f"head {k}: {name} has shape {tuple(t.shape)}, expected {expected[name]}")
    device, dtype = heads[0]["start"].device, heads[0]["start"].dtype
    if device.type == "cuda":
        # the operands' checks hold every head of a call to head 0's dtype
        want = torch.bfloat16 if build.endswith("_bf16") else torch.float32
        if dtype != want:
            raise ValueError(f"build {build} of kernel {build[0]} takes {want} heads, not {dtype}")
        for h in heads:
            D, n_layers = h["start"].shape[-1], len(h["cells"])
            why = (_layout.dec_train_limit(build, H, D, n_layers) if build in _layout.D_BUILDS
                   else _layout._part_limit(build, H, D, n_layers))
            if why is not None:
                raise _layout.LaunchLimitError(why)
    return B, H, device, dtype


def _named(build: str, heads) -> str:
    """``build`` ("D", "E", "D_wide" or "E_wide") for the heads' dtype."""
    return build + ("_bf16" if heads[0]["start"].dtype == torch.bfloat16 else "")


def gru_decode_fwd_train(heads, build=None):
    """Training forward of 1 to 4 heads, each a dict {cells, out, init,
    start, T, out_activation} (tanh cells). Returns per head (probs, logits,
    [h sequence per layer]), all (T, B, .). ``build``: kernel D's build by
    its name in ``ops/_layout.py`` (default "D", or "D_bf16" for bf16
    heads; "D_resid": float32 heads whose h sequences are stored in
    bfloat16). CPU tensors run ``gru_decode_train_reference``; CUDA tensors
    launch kernel D on each head's route (``_launch_heads``): the decode
    chain once a head, or the per-block route (8 rows a block) once for the
    call's per-block heads. Every launch counts on the build's counter
    (``.launches``, ``.launches_bf16``, ``.launches_resid``) and on its
    route's (``.launches_chain``, ``.launches_block``, with the build's
    suffix)."""
    return _decode_fwd(heads, build or _named("D", heads))


def gru_decode_fwd_train_wide(heads, build=None):
    """``gru_decode_fwd_train`` through kernel D's wide build, "D_wide" or
    "D_wide_bf16": each head on the route ``_layout.dec_train_route`` picks,
    the same decode chain as the narrow builds' or the wide per-block route
    (2 rows a block). Counted as ``gru_decode_fwd_train`` counts, on this
    wrapper."""
    return _decode_fwd(heads, build or _named("D_wide", heads))


for _fn, _sfxs in ((gru_decode_fwd_train, ("", "_bf16", "_resid")),
                   (gru_decode_fwd_train_wide, ("", "_bf16"))):
    for _attr in ("launches", "launches_chain", "launches_block"):
        for _sfx in _sfxs:
            setattr(_fn, _attr + _sfx, 0)


@functools.cache
def dec_max_clusters(bf16, tc, cluster):
    """The card's cudaOccupancyMaxActiveClusters of D's chain instance
    (``bf16``: its bf16 one; ``tc``: the tensor-core one) at ``cluster``
    CTAs a cluster."""
    lib, fn = _build.load_entry("gru_decode_train", "mvt_gru_decode_train_max_clusters",
                                [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    _build.check(lib, fn(int(bf16), int(tc), cluster, ctypes.byref(out)),
                 "gru_decode_train cudaOccupancyMaxActiveClusters")
    return out.value


@functools.cache
def dec_plan(H, D, n_layers, B, T=64, bf16=False):
    """D's chain plan (``_layout.dec_train_plan``) for a head at (H, B), at
    the card's active clusters where the plan is not a measured one (D
    resid takes D's float32 plan); raises LaunchLimitError where the chain
    does not launch."""
    p = _layout.dec_train_plan(H, D, n_layers, B, T, bf16)
    if (H, D, n_layers, T, B, bf16) in _layout.DEC_TRAIN_MEASURED:
        return p
    return _layout.dec_train_plan(H, D, n_layers, B, T, bf16, p.cluster,
                                  max_clusters=dec_max_clusters(bf16, False, p.cluster))


def _decode_fwd(heads, build: str):
    B, H, device, dtype = _check_heads(heads, build)
    rdt = torch.bfloat16 if build == "D_resid" else dtype
    if device.type == "cpu":
        return [gru_decode_train_reference(h["cells"], h["out"], h["init"], h["start"], h["T"],
                                           h["out_activation"], rdt) for h in heads]
    if device.type != "cuda":
        raise ValueError(f"gru_decode_fwd_train runs on cpu or cuda tensors, not {device}")
    kw = {"device": device, "dtype": dtype}
    null = ctypes.c_void_p(None)
    structs = (_DecodeHead * len(heads))()
    outs = []
    for h, st in zip(heads, structs):
        T, D, n_layers = h["T"], h["start"].shape[-1], len(h["cells"])
        probs, logits = torch.empty(T, B, D, **kw), torch.empty(T, B, D, **kw)
        h_seqs = [torch.empty(T, B, H, device=device, dtype=rdt) for _ in range(n_layers)]
        named = {"start": h["start"], "h1_0": h["init"][0], "wo": h["out"]["w"], "bo": h["out"]["b"],
                 "probs": probs, "logits": logits}
        for i, p in enumerate(h["cells"]):
            named.update({f"w{i + 1}": p["w"], f"u{i + 1}": p["u"], f"b{i + 1}": p["b"]})
        if n_layers == 2:
            named["h2_0"] = h["init"][1]
        check_operands(named, device, (dtype,))
        named.update({f"h{i + 1}seq": t for i, t in enumerate(h_seqs)})
        for name in _DECODE_PTRS:
            setattr(st, name, named[name].data_ptr() if name in named else null.value)
        st.D, st.n_layers, st.out_act, st.T = D, n_layers, OUT_ACTIVATIONS[h["out_activation"]], T
        outs.append((probs, logits, h_seqs))
    _launch_heads(build, heads, structs, B, H, device)
    return outs


@functools.cache
def _d_entries(build: str) -> tuple:
    """(library, chain entry, per-block entry) of D's ``build``."""
    name, (chain_entry, block_entry), _fn, _counter = _BUILDS[build]
    lib, chain = _build.load_entry(name, chain_entry, [ctypes.POINTER(_DecodeHead),
                                                       ctypes.POINTER(ctypes.c_void_p)]
                                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    block = _build.load_entry(name, block_entry, [ctypes.POINTER(_DecodeHead)]
                              + [ctypes.c_int] * 3 + [ctypes.c_void_p])[1]
    return lib, chain, block


def _launch_heads(build: str, heads, structs, B: int, H: int, device) -> None:
    """Launch D's ``build`` on each head's route (``_layout.dec_train_route``):
    the chain once a head, in the call's order on the current stream, at
    ``dec_plan``'s plan (D resid at D's float32 plan) with the weights'
    slices packed for it; the per-block heads in one launch. Every launch
    counts on the build's counter and on its route's."""
    lib, chain, block = _d_entries(build)
    bf16 = build.endswith("_bf16")
    _name, _entries, wrapper, counter = _BUILDS[build]
    sfx = counter.removeprefix("launches")
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    per_block = []
    for h, st in zip(heads, structs):
        D, n_layers = h["start"].shape[-1], len(h["cells"])
        if _layout.dec_train_route(build, H, D, n_layers) == "block":
            per_block.append(st)
            continue
        plan = dec_plan(H, D, n_layers, B, h["T"], bf16)
        slices = list(_packed_slices(h["cells"], plan.cluster, plan.chunk, plan.tc))
        ptrs = (ctypes.c_void_p * 6)(*(t.data_ptr() for t in slices), *([None] * (6 - len(slices))))
        rc = chain(ctypes.byref(st), ptrs, B, H, plan.cluster, plan.rows, plan.splits,
                   plan.stages, plan.chunk, int(plan.tc), stream)
        _build.check(lib, rc, f"{_BUILDS[build][1][0]} chain launch")
        _count(build)
        setattr(wrapper, "launches_chain" + sfx, getattr(wrapper, "launches_chain" + sfx) + 1)
    if per_block:
        arr = (_DecodeHead * len(per_block))(*per_block)
        rc = block(arr, len(per_block), B, H, stream)
        _build.check(lib, rc, f"{_BUILDS[build][1][1]} per-block launch")
        _count(build)
        setattr(wrapper, "launches_block" + sfx, getattr(wrapper, "launches_block" + sfx) + 1)


def gru_decode_bwd(heads, build=None):
    """Backward of ``gru_decode_fwd_train``: each head dict also carries the
    forward's ``probs`` and ``h_seqs`` and the incoming ``g_probs`` and
    ``g_logits`` (T, B, D). Returns per head the dict of
    ``gru_decode_bwd_reference``. ``build``: kernel E's build (default "E",
    or "E_bf16" for bf16 heads; "E_resid": float32 heads reading bf16 h
    sequences). CPU tensors run that plain version; CUDA tensors run kernel
    E's phases (``gru_decode_bwd_gates``, ``gru_decode_bwd_chain``)."""
    return _decode_bwd(heads, build or _named("E", heads))


gru_decode_bwd.launches = 0
gru_decode_bwd.launches_bf16 = 0
gru_decode_bwd.launches_resid = 0


def gru_decode_bwd_wide(heads, build=None):
    """``gru_decode_bwd`` through kernel E's wide build (2 rows per block, up
    to H = 512 threads): "E_wide", "E_wide_bf16" (rows 13 and 14: dlogits
    and the gate grads W sums rounded to bf16) or "E_wide_row8_bf16" (rows
    7 and 8: unrounded, as the narrow build emits them)."""
    return _decode_bwd(heads, build or _named("E_wide", heads))


gru_decode_bwd_wide.launches = 0
gru_decode_bwd_wide.launches_bf16 = 0
gru_decode_bwd_wide.launches_row8_bf16 = 0

# kernel D's and E's builds by their names in ops/_layout.py: (library, entry
# point (D: its chain's and its per-block route's), the wrapper whose counter
# a launch adds to, that counter)
_BUILDS = {
    "D": ("gru_decode_train", ("mvt_gru_decode_train", "mvt_gru_decode_train_block"),
          gru_decode_fwd_train, "launches"),
    "D_bf16": ("gru_decode_train", ("mvt_gru_decode_train_bf16",
                                    "mvt_gru_decode_train_block_bf16"),
               gru_decode_fwd_train, "launches_bf16"),
    "D_resid": ("gru_decode_train", ("mvt_gru_decode_train_resid",
                                     "mvt_gru_decode_train_block_resid"),
                gru_decode_fwd_train, "launches_resid"),
    # the wide builds: the narrow builds' chain instances, their own
    # per-block design (2 rows a block)
    "D_wide": ("gru_decode_train", ("mvt_gru_decode_train", "mvt_gru_decode_train_wide_block"),
               gru_decode_fwd_train_wide, "launches"),
    "D_wide_bf16": ("gru_decode_train", ("mvt_gru_decode_train_bf16",
                                         "mvt_gru_decode_train_wide_block_bf16"),
                    gru_decode_fwd_train_wide, "launches_bf16"),
    # E's six builds run three chain instances: float (the residual build's
    # pre-pass reads the rounded h widened), bf16 with the streams
    # unrounded, bf16 with them rounded (E wide bf16)
    "E": ("gru_decode_bwd", "mvt_gru_decode_bwd", gru_decode_bwd, "launches"),
    "E_resid": ("gru_decode_bwd", "mvt_gru_decode_bwd", gru_decode_bwd, "launches_resid"),
    "E_wide": ("gru_decode_bwd", "mvt_gru_decode_bwd", gru_decode_bwd_wide, "launches"),
    "E_bf16": ("gru_decode_bwd", "mvt_gru_decode_bwd_bf16", gru_decode_bwd, "launches_bf16"),
    "E_wide_row8_bf16": ("gru_decode_bwd", "mvt_gru_decode_bwd_bf16", gru_decode_bwd_wide,
                         "launches_row8_bf16"),
    "E_wide_bf16": ("gru_decode_bwd", "mvt_gru_decode_bwd_wide_bf16", gru_decode_bwd_wide,
                    "launches_bf16"),
}


@functools.cache
def _entry(build: str) -> tuple:
    """(library, entry point) of E's ``build``, which takes its heads'
    chain structs and the plan (D's are ``_d_entries``')."""
    name, entry, _fn, _counter = _BUILDS[build]
    args = [ctypes.POINTER(_HeadBwdChain)] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return _build.load_entry(name, entry, args)


def _count(build: str) -> None:
    """One more launch of ``build`` on its wrapper's counter."""
    _name, _e, wrapper, counter = _BUILDS[build]
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)


# ---------------------------------------------------------------------------
# E's phases (csrc/gru_cell_bwd_chain.cuh): the gate pre-pass of every layer
# of the call's heads, then one chain on thread-block clusters through the
# whole of each head; each has its plain version and its launch counts
# (``.launches``, ``.launches_bf16``)
# ---------------------------------------------------------------------------

def _layer_inputs(head) -> list[tuple]:
    """(x, hprev) of each layer of a head, time-major: layer 1's x the probs
    fed back ([start, probs[:-1]]), layer 2's h1; hprev = [h_0, h[:-1]]. The
    h sequences stored in bfloat16 beside float32 heads are widened beside
    the unrounded initial states (torch.cat promotes; ``_mh_bwd_kernel``
    recomputes the gates from the rounded h)."""
    dtype = head["start"].dtype
    out = []
    for i, seq in enumerate(head["h_seqs"]):
        x = (torch.cat([head["start"][None], head["probs"][:-1]]) if i == 0
             else head["h_seqs"][i - 1].to(dtype))
        out.append((x, torch.cat([head["init"][i][None], seq[:-1]]).to(dtype)))
    return out


def gru_decode_bwd_gates(heads, inputs=None):
    """E's gate pre-pass for every layer of ``heads`` (the dicts of
    ``gru_decode_bwd``): per head, per layer, (gates (T, B, 3H) = [z, r,
    hh], rh (T, B, H)) float32, ``gru_bwd_gates_reference`` of the layer's
    stored inputs (``inputs``: ``_layer_inputs`` of each head, where the
    caller has them). CPU tensors run the plain version; CUDA tensors launch
    its build of the heads' dtype, two products a layer (two launches, each
    counted)."""
    inputs = inputs or [_layer_inputs(h) for h in heads]
    out = []
    for h, ins in zip(heads, inputs):
        cells = h["cells"]
        if ins[0][0].device.type == "cpu":
            out.append([gru_bwd_gates_reference(x, hp, c["w"], c["b"], c["u"])
                        for (x, hp), c in zip(ins, cells)])
            continue
        layers = []
        for (x, hp), c in zip(ins, cells):
            check_operands({"x": x, "hprev": hp, "w": c["w"], "b": c["b"], "u": c["u"]}, x.device,
                           _build.DTYPES)
            layers.append(bwd_gates("gru_decode_bwd", gru_decode_bwd_gates, x, hp, c["w"], c["b"],
                                    c["u"]))
        out.append(layers)
    return out


def gru_decode_bwd_chain_reference(head, gates, hprevs, wide=False):
    """Plain version of E's chain for one head: the reverse loop over the
    pre-pass's gates of each layer and the layers' hprev, with the readout,
    the fed-back probs and the layers' dx (``_dec_bwd1/2_kernel``,
    ``_mh_bwd_kernel``). Returns {dlogits, da [per layer], d_init [per
    layer], d_start}: float32, d_init and d_start in start's dtype; ``wide``
    rounds dlogits and the gate grads to start's dtype (rows 13 and 14)."""
    dtype = head["start"].dtype
    cells = [{k: c[k].float() for k in ("w", "u")} for c in head["cells"]]
    wo = head["out"]["w"].float()
    probs, g_probs, g_logits = (head[k].float() for k in ("probs", "g_probs", "g_logits"))
    hprevs = [h.float() for h in hprevs]
    T, n = probs.shape[0], len(cells)
    dh = [torch.zeros_like(h[0]) for h in hprevs]
    dx_fed = torch.zeros_like(probs[0])
    dlog, da = [None] * T, [[None] * T for _ in range(n)]
    for t in reversed(range(T)):
        dlog[t] = dlogits_from(probs[t], g_probs[t] + dx_fed, g_logits[t], head["out_activation"])
        d = dlog[t] @ wo.t() + dh[n - 1]
        for i in reversed(range(n)):
            da[i][t], dh[i] = gru_bwd_cell_reference(gates[i][t], hprevs[i][t], cells[i]["u"], d)
            dx = da[i][t] @ cells[i]["w"].t()
            if i > 0:
                d = dx + dh[i - 1]
            else:
                dx_fed = dx
    stream = (lambda a: torch.stack(a).to(dtype).float()) if wide else torch.stack
    return {"dlogits": stream(dlog), "da": [stream(a) for a in da],
            "d_init": [d.to(dtype) for d in dh], "d_start": dx_fed.to(dtype)}


def _chain_heads(heads) -> tuple:
    """The plan's heads: (D, n_layers, T) each."""
    return tuple((h["start"].shape[-1], len(h["cells"]), h["T"]) for h in heads)


def gru_decode_bwd_chain(heads, gates, build=None, hprevs=None):
    """E's chain over the pre-pass's ``gates`` (per head, per layer) of
    ``heads`` (the dicts of ``gru_decode_bwd``), in one launch of
    ``build`` (default "E", or "E_bf16" for bf16 heads): per head {dlogits,
    da [per layer], d_init, d_start}, as ``gru_decode_bwd_chain_reference``
    (``hprevs``: per head, per layer, where the caller has them). CPU
    tensors run the plain version; CUDA tensors launch the build on clusters
    (``gru_bptt_plan``), counted on this wrapper and, as one call of E, on
    the build's counter (``_BUILDS``)."""
    build = build or _named("E", heads)
    wide = build in ("E_wide", "E_wide_bf16")
    hprevs = hprevs or [[hp for _x, hp in _layer_inputs(h)] for h in heads]
    if heads[0]["start"].device.type == "cpu":
        return [gru_decode_bwd_chain_reference(h, [g for g, _rh in gs], hp, wide)
                for h, gs, hp in zip(heads, gates, hprevs)]
    B, H = heads[0]["start"].shape[0], heads[0]["init"][0].shape[-1]
    device, dtype = heads[0]["start"].device, heads[0]["start"].dtype
    chain = "E_chain_bf16" if dtype == _BF16 else "E_chain"
    plan = gru_bptt_plan(chain, H, B, _chain_heads(heads))
    kw = {"device": device, "dtype": torch.float32}
    null = ctypes.c_void_p(None)
    structs = (_HeadBwdChain * len(heads))()
    outs, keep = [], []
    for k, (h, gs, hps, st) in enumerate(zip(heads, gates, hprevs, structs)):
        T, D, n_layers = h["T"], h["start"].shape[-1], len(h["cells"])
        Dp = -(-D // 64) * 64
        w1t = torch.zeros(3 * H, Dp, device=device, dtype=dtype)
        w1t[:, :D] = h["cells"][0]["w"].t()
        named = {"probs": h["probs"], "g_probs": h["g_probs"], "g_logits": h["g_logits"],
                 "wo": h["out"]["w"], "u1t": h["cells"][0]["u"].t().contiguous(), "w1t": w1t,
                 "hprev1": hps[0]}
        if n_layers == 2:
            named.update({"u2t": h["cells"][1]["u"].t().contiguous(),
                          "w2t": h["cells"][1]["w"].t().contiguous(), "hprev2": hps[1]})
        check_operands(named, device, (dtype,))
        g = {"dlogits": torch.empty(T, B, D, **kw),
             "da": [torch.empty(T, B, 3 * H, **kw) for _ in range(n_layers)],
             "d_init": [torch.empty(B, H, device=device, dtype=dtype) for _ in range(n_layers)],
             "d_start": torch.empty(B, D, device=device, dtype=dtype)}
        named.update({"dlogits": g["dlogits"], "d_start": g["d_start"]})
        for i in range(n_layers):
            named.update({f"gates{i + 1}": gs[i][0], f"da{i + 1}": g["da"][i],
                          f"d_h{i + 1}_0": g["d_init"][i]})
        keep.append(named)  # the transposes must outlive the launch
        for name in _CHAIN_PTRS:
            setattr(st, name, named[name].data_ptr() if name in named else null.value)
        st.D, st.Dp, st.n_layers, st.T = D, Dp, n_layers, T
        st.out_act = OUT_ACTIVATIONS[h["out_activation"]]
        st.rows, st.clusters = plan.rows[k], plan.clusters[k]
        outs.append(g)
    lib, fn = _entry(build)
    rc = fn(structs, len(heads), B, H, plan.cluster, plan.nbuf, plan.stages, _stream(heads[0]["start"]))
    _build.check(lib, rc, f"{_BUILDS[build][1]} launch")
    _build.count_launch(gru_decode_bwd_chain, dtype)
    _count(build)
    return outs


# the wrappers that launch E's phases, each counting its launches on
# ``.launches`` and ``.launches_bf16``
E_PHASES = ("gru_decode_bwd_gates", "gru_decode_bwd_chain")
for _fn in (gru_decode_bwd_gates, gru_decode_bwd_chain):
    _fn.launches = _fn.launches_bf16 = 0


def _decode_bwd(heads, build: str):
    B, H, device, dtype = _check_heads(heads, build)
    for k, h in enumerate(heads):
        want = (h["T"], B, h["start"].shape[-1])
        for name in ("probs", "g_probs", "g_logits"):
            if tuple(h[name].shape) != want:
                raise ValueError(f"head {k}: {name} has shape {tuple(h[name].shape)}, expected {want}")
    if device.type == "cpu":
        # rows 13 and 14 round the streams W sums to the heads' dtype
        return [gru_decode_bwd_reference(h["cells"], h["out"], h["init"], h["start"], h["probs"],
                                         h["h_seqs"], h["g_probs"], h["g_logits"],
                                         h["out_activation"], build in ("E_wide", "E_wide_bf16"))
                for h in heads]
    if device.type != "cuda":
        raise ValueError(f"gru_decode_bwd runs on cpu or cuda tensors, not {device}")
    for k, h in enumerate(heads):
        seqs = {f"h{i + 1}seq": t for i, t in enumerate(h["h_seqs"])}
        check_operands(seqs, device, (torch.bfloat16 if build == "E_resid" else dtype,))
    chain = "E_chain_bf16" if dtype == _BF16 else "E_chain"
    gru_bptt_plan(chain, H, B, _chain_heads(heads))  # raises LaunchLimitError before any launch
    inputs = [_layer_inputs(h) for h in heads]
    gates = gru_decode_bwd_gates(heads, inputs)
    outs = gru_decode_bwd_chain(heads, gates, build, [[hp for _x, hp in ins] for ins in inputs])
    for g, gs in zip(outs, gates):
        g["rh"] = [rh for _g, rh in gs]
    return outs


def _flatten_head(h) -> list:
    """start, init states, then w, u, b of each cell, then wo, bo."""
    flat = [h["start"], *h["init"]]
    for c in h["cells"]:
        flat += [c["w"], c["u"], c["b"]]
    return flat + [h["out"]["w"], h["out"]["b"]]


def _unflatten_heads(layout, flat) -> list[dict]:
    heads, i = [], 0
    for n_layers, out_activation, T in layout:
        start, init = flat[i], list(flat[i + 1 : i + 1 + n_layers])
        i += 1 + n_layers
        cells = []
        for _ in range(n_layers):
            cells.append({"w": flat[i], "u": flat[i + 1], "b": flat[i + 2]})
            i += 3
        heads.append({"start": start, "init": init, "cells": cells,
                      "out": {"w": flat[i], "b": flat[i + 1]}, "T": T,
                      "out_activation": out_activation})
        i += 2
    return heads


class _DecodeTrain(torch.autograd.Function):
    """Training decode of 1 to 4 heads: forward kernel D, backward kernel E
    then kernel W. ``layout`` is one (n_layers, out_activation, T) per head;
    ``builds`` the names of D's and E's builds (``_BUILDS``); ``flat`` holds
    each head's tensors in ``_flatten_head`` order. Returns (probs, logits)
    of every head, flattened. The weight grads are float32 sums, rounded to
    the params' dtype."""

    @staticmethod
    def forward(ctx, layout, builds, *flat):
        # the notes accuracy and some heads' probs or logits have no grad
        ctx.set_materialize_grads(True)
        heads = _unflatten_heads(layout, flat)
        fwd = gru_decode_fwd_train_wide if builds[0].startswith("D_wide") else gru_decode_fwd_train
        outs = fwd(heads, builds[0])
        residuals = [t for probs, _logits, h_seqs in outs for t in (probs, *h_seqs)]
        ctx.save_for_backward(*flat, *residuals)
        ctx.layout, ctx.builds, ctx.n_flat = layout, builds, len(flat)
        return tuple(t for probs, logits, _h in outs for t in (probs, logits))

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        heads = _unflatten_heads(ctx.layout, saved[: ctx.n_flat])
        residuals = iter(saved[ctx.n_flat :])
        for k, h in enumerate(heads):
            h["probs"] = next(residuals)
            h["h_seqs"] = [next(residuals) for _ in h["cells"]]
            h["g_probs"], h["g_logits"] = grads[2 * k].contiguous(), grads[2 * k + 1].contiguous()
        flat_grads = []
        build = ctx.builds[1]
        gs = (gru_decode_bwd_wide if build.startswith("E_wide") else gru_decode_bwd)(heads, build)
        # dWo and layer 2's dW sum over the h sequences as stored; with bf16
        # residuals beside float32 heads, h_{t-1} is widened beside the
        # unrounded initial state (torch.cat promotes), so its dU sums over
        # float32 operands
        for h, g in zip(heads, gs):
            T, (B, D), H = h["T"], h["start"].shape, h["init"][0].shape[-1]
            kw = {"device": h["start"].device, "dtype": torch.float32}
            dwo, dbo = torch.empty(H, D, **kw), torch.empty(D, **kw)
            grad_reduce(h["h_seqs"][-1].reshape(T * B, H), g["dlogits"].reshape(T * B, D), dwo, dbo)
            cell_grads = []
            for i in range(len(h["cells"])):
                x = h["h_seqs"][i - 1] if i > 0 else torch.cat([h["start"][None], h["probs"][:-1]])
                hprev = torch.cat([h["init"][i][None], h["h_seqs"][i][:-1]])
                dw, db, du = gru_weight_grads(x, hprev, g["rh"][i], g["da"][i])
                cell_grads += [dw, du, db]
            flat_grads += [g["d_start"], *g["d_init"], *cell_grads, dwo, dbo]
        return (None, None, *(g.to(p.dtype) for g, p in zip(flat_grads, saved)))


def _decode_heads_train(heads, builds=None):
    """``_DecodeTrain`` of ``heads``; ``builds`` default to the narrow D and
    E of the heads' dtype."""
    layout = tuple((len(h["cells"]), h["out_activation"], h["T"]) for h in heads)
    flat = [t for h in heads for t in _flatten_head(h)]
    outs = _DecodeTrain.apply(layout, builds or (_named("D", heads), _named("E", heads)), *flat)
    return [(outs[2 * k], outs[2 * k + 1]) for k in range(len(heads))]


def gru_decode_train(cells, out_dense, init_states, start, T, activation="tanh",
                     out_activation="softmax", builds=None):
    """Differentiable readout decode of one head (1 or 2 GRU layers, tanh):
    (probs, logits), each (T, B, D) time-major in start's dtype. CPU tensors
    run the plain versions of kernels D, E and W; CUDA tensors launch them.
    ``builds``: the names of D's and E's builds (``ops/_layout.py``: the
    float32 route's ("D", "E") or ("D_wide", "E_wide"), a bf16 head's
    ``head_builds``); default the narrow ones of the head's dtype. A head
    narrower than 8 that is not float32 is promoted whole to float32 and
    its outputs cast back (``fused_train.py:813-825``); ``builds`` then name
    float32 builds."""
    if activation != "tanh":
        raise ValueError(f"the decode training kernels implement tanh cells, not {activation!r}")
    if start.shape[-1] < 8 and start.dtype != torch.float32:
        probs, logits = gru_decode_train(
            [{k: c[k].float() for k in ("w", "u", "b")} for c in cells],
            {k: out_dense[k].float() for k in ("w", "b")}, [s.float() for s in init_states],
            start.float(), T, activation, out_activation, builds)
        return probs.to(start.dtype), logits.to(start.dtype)
    head = {"cells": list(cells), "out": out_dense, "init": list(init_states), "start": start,
            "T": T, "out_activation": out_activation}
    return _decode_heads_train([head], builds)[0]


def gru_decode_multihead_train(primary, heads, T, activation, out_acts, residual_dtype=None):
    """Differentiable decode of a 2-layer primary head and 1-layer side
    heads over the same T, in one launch each way. ``primary`` and each of
    ``heads`` are {cells, out, init, start}; ``out_acts`` one output
    activation per head, primary first; ``residual_dtype``: the dtype the h
    sequences are stored in for the backward (bfloat16 beside float32
    heads: ``decode_residual_bf16``, D's and E's bf16-residual builds; probs
    and logits do not change). Returns a tuple of (probs, logits) per head,
    each (T, B, D) time-major."""
    if activation != "tanh":
        raise ValueError(f"the decode training kernels implement tanh cells, not {activation!r}")
    specs = [primary, *heads]
    if len(out_acts) != len(specs) or len(primary["cells"]) != 2 or any(
            len(h["cells"]) != 1 for h in heads):
        raise ValueError("the multi-head decode takes a 2-layer primary head, 1-layer side "
                         "heads and one output activation per head")
    dtype = primary["start"].dtype
    if residual_dtype in (None, dtype):
        builds = None
    elif residual_dtype == torch.bfloat16 and dtype == torch.float32:
        builds = ("D_resid", "E_resid")
    else:
        raise ValueError(f"the multi-head decode stores {dtype} heads' h sequences in their own "
                         f"dtype, or float32 heads' in bfloat16; got {residual_dtype}")
    return tuple(_decode_heads_train([
        {"cells": list(h["cells"]), "out": h["out"], "init": list(h["init"]), "start": h["start"],
         "T": T, "out_activation": oa} for h, oa in zip(specs, out_acts)], builds))
