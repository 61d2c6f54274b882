"""Kernel L: one whole LSTM layer forward with the x-projection in the kernel;
kernels N, Q and R: the LSTM layer's training backward and its wide route.

Serving: counterpart of ``midi_vae_tpu/ops/fused_train.py::lstm_layer_infer_x``,
whose Pallas kernels ``_lstm_fwdx_kernel`` (the h sequence) and
``_lstm_fwdx_last_kernel`` (the final h) the CUDA kernel
``csrc/lstm_layer_fwd.cu`` replaces; its source note gives the layout and
what bounds it. ``lstm_layer_reference`` is the plain PyTorch version
(``_lstm_layer_reference_x``): the CPU path and the kernel's oracle. Gate
order i, f, g, o; ``activation`` acts on g and on c
(``midi_vae_tpu/ops/fused_lstm.py::_lstm_gates``). On the card L runs as
two phases, each with its plain version and its launch counts: the x @ W
pre-pass (``lstm_layer_xproj``: xp = x @ W + b in float32 on the tensor
cores, ``lstm_xproj_reference``) and the chain over that xp
(``lstm_layer_fwd_chain``: Q's and Y's forward chain on thread-block
clusters, ``lstm_fwd_chain_reference``); where the chain does not launch,
``ops/_layout.py::lstm_fwd_route`` picks L's first, per-block design
(``lstm_layer_block``).

Training, the narrow route (``ops/_layout.py``, H <= 256):
``lstm_layer_train_x``, counterpart of ``fused_train.py::lstm_layer_train_x``
(:2574-2621), is a ``torch.autograd.Function``: its forward is kernel L
emitting the h and c sequences (``_lstm_fwdx_pallas`` returns both; c is the
backward's residual), its backward is kernel N (``csrc/lstm_layer_bwd.cu``,
replacing ``_lstm_bwdx_kernel``) followed by kernel W (``ops/grad_reduce.py``)
for dW, db and dU. The wide route (above 256) trains a layer over a
precomputed x-projection instead: ``lstm_layer_train(xp, h0, c0, u)``,
counterpart of ``fused_train.py::lstm_layer_train`` (:1505-1578), whose
forward is kernel Q (``csrc/lstm_layer_xp_fwd.cu``, replacing
``_lstm_fwd_kernel`` in ``_lstm_fwd_pallas`` and ``_lstm_fwd_wide_pallas``;
a serial chain on thread-block clusters, ``csrc/lstm_cell_fwd.cuh``, its
plan ``fwd_chain_plan``) and whose backward is kernel R
(``csrc/lstm_layer_xp_bwd.cu``, replacing ``_lstm_bwd_kernel`` and
``_lstm_bwd_wide_kernel``) then kernel W for dU, as
``_lstm_wide_weight_grads`` does in XLA. The caller computes xp = x @ W + b
with torch.matmul, so dx, dW and db come from autograd. The backward
kernels hard-code tanh's derivative, as the TPU kernels do
(``_lstm_x_use_pallas`` :2546, ``_lstm_mode`` :1874); the model sends other
cell activations to the plain scan on any device (``models/rnn.py``).

N and R each run as phases on the card (``csrc/lstm_cell_bwd.cuh`` has the
design): the gate pre-pass (``lstm_layer_bwd_gates``,
``lstm_layer_xp_bwd_gates``: the gates' activations of every step at once),
the chain on thread-block clusters (``lstm_layer_bwd_chain``,
``lstm_layer_xp_bwd_chain``; its plan ``chain_plan``) and N's dx pass
(``lstm_layer_bwd_dx``). Each phase has its plain version
(``lstm_bwd_gates_reference``, ``lstm_bwd_chain_reference``,
``lstm_bwd_dx_reference``) and its launch counts; the ops count one launch
of N or R a call.

In a bf16 model (``compute_dtype="bfloat16"``) each of L, N, Q and R runs
its bfloat16 build (``mvt_*_bf16``), picked by the operands' dtype, as the
JAX package runs rows 15-20 in bf16 (which pair a layer takes is decided per
layer from (B, D, H), ``ops/_layout.py::bf16_layer_mode``). The forwards
take every product as bf16 values summed in float32 (L: x @ W + b in
float32 inside the kernel, ``_lstm_fwdx_kernel``; Q: over xp that the caller
has rounded to bf16 as XLA does, ``_lstm_layer_fallback_x``), carry h and c
rounded to bf16 (h' from the unrounded c') and store both sequences in bf16.
The backwards are the float32 transposition over the stored bf16 sequences
(the dh and dc carries in float32), not autograd through a bf16 forward:
N rounds dx, dh0 and dc0 to bf16 and hands W the unrounded gate grads, from
which ``_lstm_bwdx_kernel`` sums dW, db and dU (:2458-2460); R rounds dxp,
dh0 and dc0 and can also hand over the unrounded gate grads. Which of R's
two streams W sums dU from depends on the row: the in-place row 16 sums
the unrounded da (:1436), the wide row 18 the stored bf16 stream
(``_lstm_wide_weight_grads``, :2032-2043); ``lstm_layer_train``'s ``mode``
names the row. The weight grads leave in float32 and are rounded to the
params' dtype at the end, as ``_llx_bwd`` and ``_llt_bwd`` cast them. The
velocity layer (D < 8) is the ``cast_x`` case: x and W enter the products
widened to float32, the same products as the bf16 build's widening loads,
so it takes the same builds (W's bf16 build for its dW too: the widened x
sums the same numbers). Launches are counted per build: ``.launches``
(float32) and ``.launches_bf16``.

Every wrapper takes its plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, _layout
from .grad_reduce import lstm_u_grad, lstm_weight_grads
from .gru_layer import CELL_ACTIVATIONS, _max_clusters, _ptr, cell_activation, check_operands


def lstm_step(xp, h, c, u, act):
    """One LSTM step over its x-projection xp = x @ W + b (B, 4H): returns
    (h', c'). h @ U and the gate math run in float32, h' comes from the
    unrounded c', and both are rounded to the state's dtype once, as the
    Pallas kernels do in a bfloat16 model (``_lstm_gates``'s
    ``preferred_element_type=float32``, then ``astype``:
    ``fused_lstm.py:54-95``, ``:241-243``); in float32 the casts are
    no-ops."""
    H = h.shape[-1]
    gates = xp.float() + h.float() @ u.float()
    i = torch.sigmoid(gates[:, :H])
    f = torch.sigmoid(gates[:, H : 2 * H])
    g = act(gates[:, 2 * H : 3 * H])
    o = torch.sigmoid(gates[:, 3 * H :])
    c_new = f * c.float() + i * g
    return (o * act(c_new)).to(h.dtype), c_new.to(c.dtype)


def _scan_xp(xp, h0, c0, u, act):
    """The LSTM recurrence over xp (T, B, 4H): the (T, B, H) h and c
    sequences (``_encoder_scan_reference``)."""
    h, c = h0, c0
    hs, cs = [], []
    for t in range(xp.shape[0]):
        h, c = lstm_step(xp[t], h, c, u, act)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_layer_reference(x, h0, c0, w, b, u, activation="tanh", return_sequences=False,
                         with_c=False):
    """Plain version: x (T, B, D) -> (T, B, H) h sequence or final h (B, H);
    with ``with_c`` (h sequence, c sequence), in h0's dtype; x @ W + b in
    float32 (``_lstm_fwdx_kernel``)."""
    T, B, D = x.shape
    xp = (x.reshape(T * B, D).float() @ w.float() + b.float()).reshape(T, B, -1)
    hseq, cseq = _scan_xp(xp, h0, c0, u, cell_activation(activation))
    if with_c:
        return hseq, cseq
    return hseq if return_sequences else hseq[-1]


def lstm_xproj_reference(x, w, b):
    """Plain version of L's pre-pass: xp (T, B, 4H) = x (T, B, D) @ W + b in
    float32, every operand widened (in bf16 the products of bf16 values
    summed in float32, ``_lstm_fwdx_kernel`` :2368)."""
    T, B, D = x.shape
    return (x.reshape(T * B, D).float() @ w.float() + b.float()).reshape(T, B, -1)


def lstm_fwd_chain_reference(xp, h0, c0, u, activation="tanh", return_sequences=False,
                             with_c=False):
    """Plain version of L's chain over a float32 xp (T, B, 4H): the h
    sequence or the final h, with ``with_c`` (h sequence, c sequence), in
    h0's dtype (``_lstm_fwdx_kernel``'s recurrence: xp enters the gates
    unrounded)."""
    hseq, cseq = _scan_xp(xp, h0, c0, u, cell_activation(activation))
    if with_c:
        return hseq, cseq
    return hseq if return_sequences else hseq[-1]


@functools.cache
def _kernel():
    """(library, {"block" | "xproj" | "chain": {dtype: entry}}) of kernel L."""
    lib, block = _build.load_builds("lstm_layer_fwd", "mvt_lstm_layer_fwd",
                                    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                                    + [ctypes.c_void_p])
    xproj = _build.load_builds("lstm_layer_fwd", "mvt_lstm_layer_xproj",
                               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])[1]
    chain = _build.load_builds("lstm_layer_fwd", "mvt_lstm_layer_fwd_chain",
                               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p])[1]
    return lib, {"block": block, "xproj": xproj, "chain": chain}


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _opt(t):
    return _ptr(t) if t is not None else ctypes.c_void_p(None)


def _check_shapes(named: dict, expected: dict) -> None:
    for name, t in named.items():
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expected[name]}")


def _bf16_build(letter: str, dtype: torch.dtype) -> str:
    """The route chooser's name of kernel ``letter``'s build of ``dtype``."""
    return f"{letter}_bf16" if dtype == torch.bfloat16 else letter


def _on(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {t.device}")
    return t.device.type == "cuda"


def _check_layer(x, h0, c0, w, b, u, activation, what):
    """Shapes of kernel L's operands and, on the card, their device, dtype
    and contiguity. Returns (T, B, D, H, dtype or None off the card)."""
    if activation not in CELL_ACTIVATIONS:
        raise ValueError(f"unsupported LSTM kernel activation {activation!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be (T, B, D), got {tuple(x.shape)}")
    T, B, D = x.shape
    H = u.shape[0]
    named = {"x": x, "h0": h0, "c0": c0, "w": w, "b": b, "u": u}
    _check_shapes(named, {"x": (T, B, D), "h0": (B, H), "c0": (B, H), "w": (D, 4 * H),
                          "b": (4 * H,), "u": (H, 4 * H)})
    if not _on(x, what):
        return T, B, D, H, None
    dtype = check_operands(named, x.device, _build.DTYPES)
    if T < 1 or B < 1:
        raise ValueError(f"kernel L takes T >= 1 and B >= 1; got T={T} B={B}")
    return T, B, D, H, dtype


def _outputs(T, B, H, emit_seq, with_c, kw):
    out = torch.empty((T, B, H) if emit_seq else (B, H), **kw)
    return out, (torch.empty(T, B, H, **kw) if with_c else None)


def lstm_layer_xproj(x, w, b):
    """Kernel L's pre-pass: ``lstm_xproj_reference``, xp (T, B, 4H) float32.
    CPU tensors run the plain version; CUDA tensors (every operand float32
    or every one bfloat16) launch its build of their dtype."""
    if x.dim() != 3:
        raise ValueError(f"x must be (T, B, D), got {tuple(x.shape)}")
    T, B, D = x.shape
    G = w.shape[-1]
    _check_shapes({"w": w, "b": b}, {"w": (D, G), "b": (G,)})
    if not _on(x, "lstm_layer_xproj"):
        return lstm_xproj_reference(x, w, b)
    dtype = check_operands({"x": x, "w": w, "b": b}, x.device, _build.DTYPES)
    xp = torch.empty(T, B, G, device=x.device, dtype=torch.float32)
    lib, fns = _kernel()
    rc = fns["xproj"][dtype](_ptr(x), _ptr(w), _ptr(b), _ptr(xp), T * B, D, G, _stream(x))
    _build.check(lib, rc, "lstm_layer_fwd pre-pass launch")
    _build.count_launch(lstm_layer_xproj, dtype)
    return xp


def lstm_layer_fwd_chain(xp, h0, c0, u, activation="tanh", return_sequences=False,
                         with_c=False):
    """Kernel L's chain over a float32 xp (T, B, 4H), h0, c0 and U float32
    or all three bfloat16: ``lstm_fwd_chain_reference``. CPU tensors run
    the plain version; CUDA tensors launch its build of h0's dtype on
    clusters (``fwd_chain_plan``)."""
    if activation not in CELL_ACTIVATIONS:
        raise ValueError(f"unsupported LSTM kernel activation {activation!r}")
    if xp.dim() != 3:
        raise ValueError(f"xp must be (T, B, 4H), got {tuple(xp.shape)}")
    T, B = xp.shape[:2]
    H = u.shape[0]
    _check_shapes({"xp": xp, "h0": h0, "c0": c0, "u": u},
                  {"xp": (T, B, 4 * H), "h0": (B, H), "c0": (B, H), "u": (H, 4 * H)})
    if not _on(xp, "lstm_layer_fwd_chain"):
        return lstm_fwd_chain_reference(xp, h0, c0, u, activation, return_sequences, with_c)
    dtype = check_operands({"h0": h0, "c0": c0, "u": u}, xp.device, _build.DTYPES)
    check_operands({"xp": xp}, xp.device, (torch.float32,))
    if T < 1 or B < 1:
        raise ValueError(f"kernel L takes T >= 1 and B >= 1; got T={T} B={B}")
    plan = fwd_chain_plan(_bf16_build("L_chain", dtype), H, B)
    emit_seq = return_sequences or with_c
    out, cseq = _outputs(T, B, H, emit_seq, with_c, {"device": xp.device, "dtype": dtype})
    null = ctypes.c_void_p(None)
    lib, fns = _kernel()
    rc = fns["chain"][dtype](
        _ptr(xp), _ptr(h0), _ptr(c0), _ptr(u), _ptr(out) if emit_seq else null, _opt(cseq),
        null if emit_seq else _ptr(out), T, B, H, CELL_ACTIVATIONS[activation], plan.cluster,
        plan.rows, plan.splits, plan.stages, _stream(xp))
    _build.check(lib, rc, "lstm_layer_fwd chain launch")
    _build.count_launch(lstm_layer_fwd_chain, dtype)
    return (out, cseq) if with_c else out


def lstm_layer_block(x, h0, c0, w, b, u, activation="tanh", return_sequences=False,
                     with_c=False):
    """Kernel L's per-block route (its first design), as ``lstm_layer``:
    CPU tensors run ``lstm_layer_reference``; CUDA tensors launch its build
    of their dtype where ``_layout`` lets it launch."""
    T, B, D, H, dtype = _check_layer(x, h0, c0, w, b, u, activation, "lstm_layer_block")
    if dtype is None:
        return lstm_layer_reference(x, h0, c0, w, b, u, activation, return_sequences, with_c)
    build = _bf16_build("L", dtype)
    _layout.require(build, H, _layout.smem_bytes(build, H, D))
    emit_seq = return_sequences or with_c
    out, cseq = _outputs(T, B, H, emit_seq, with_c, {"device": x.device, "dtype": dtype})
    lib, fns = _kernel()
    rc = fns["block"][dtype](
        _ptr(x), _ptr(h0), _ptr(c0), _ptr(w), _ptr(b), _ptr(u), _ptr(out), _opt(cseq),
        T, B, D, H, CELL_ACTIVATIONS[activation], int(emit_seq), _stream(x),
    )
    _build.check(lib, rc, "lstm_layer_fwd launch")
    _build.count_launch(lstm_layer_block, dtype)
    return (out, cseq) if with_c else out


def lstm_layer(x, h0, c0, w, b, u, activation="tanh", return_sequences=False, with_c=False):
    """LSTM layer forward, x (T, B, D) time-major, every operand float32 or
    every one bfloat16.

    Returns the (T, B, H) h sequence when ``return_sequences`` else the final
    h (B, H); with ``with_c`` the (h sequence, c sequence) pair, the
    training forward's residual; in the operands' dtype. The call goes
    through the registered operator ``mvt::lstm_layer`` (``ops/_custom.py``)
    on either device: CPU tensors run ``lstm_layer_reference``; CUDA
    tensors run ``lstm_layer_cuda``."""
    out = torch.ops.mvt.lstm_layer(x, h0, c0, w, b, u, activation, return_sequences, with_c)
    return tuple(out) if with_c else out[0]


def _as_list(out, with_c):
    """An implementation's outputs as the operator returns them: [h] or [h
    sequence, c sequence]."""
    return list(out) if with_c else [out]


def lstm_layer_cpu(x, h0, c0, w, b, u, activation, return_sequences, with_c):
    """``mvt::lstm_layer``'s CPU implementation: the plain version."""
    _check_layer(x, h0, c0, w, b, u, activation, "lstm_layer")
    return _as_list(lstm_layer_reference(x, h0, c0, w, b, u, activation, return_sequences,
                                         with_c), with_c)


def lstm_layer_cuda(x, h0, c0, w, b, u, activation, return_sequences, with_c):
    """``mvt::lstm_layer``'s CUDA implementation: kernel L's build of the
    operands' dtype on the route ``_layout.lstm_fwd_route`` picks, the
    pre-pass and the chain, or the per-block route (``lstm_layer_block``).
    Each of those wrappers counts its own launches (``L_PHASES``); this one
    launches nothing itself."""
    T, B, D, H, dtype = _check_layer(x, h0, c0, w, b, u, activation, "lstm_layer")
    if dtype is None:
        raise ValueError(f"lstm_layer: x is on {x.device}, the other operands on the card")
    if _layout.lstm_fwd_route(H, D, dtype == torch.bfloat16) == "block":
        out = lstm_layer_block(x, h0, c0, w, b, u, activation, return_sequences, with_c)
    else:
        fwd_chain_plan(_bf16_build("L_chain", dtype), H, B)  # raises before any launch
        xp = lstm_layer_xproj(x, w, b)
        out = lstm_layer_fwd_chain(xp, h0, c0, u, activation, return_sequences, with_c)
    return _as_list(out, with_c)


def lstm_layer_fake(x, h0, c0, w, b, u, activation, return_sequences, with_c):
    """``mvt::lstm_layer``'s fake implementation: the outputs' shapes and
    dtype, after the real ones' checks."""
    T, B, _, H, _ = _check_layer(x, h0, c0, w, b, u, activation, "lstm_layer")
    if with_c:
        return [h0.new_empty(T, B, H), c0.new_empty(T, B, H)]
    return [h0.new_empty((T, B, H) if return_sequences else (B, H))]


# the wrappers that launch L's kernels, each counting on ``.launches`` and
# ``.launches_bf16``
L_PHASES = ("lstm_layer_xproj", "lstm_layer_fwd_chain", "lstm_layer_block")
for _fn in (lstm_layer_xproj, lstm_layer_fwd_chain, lstm_layer_block):
    _fn.launches = _fn.launches_bf16 = 0


# ---------------------------------------------------------------------------
# Training, the narrow route: the backward (kernel N + kernel W) and the
# autograd Function
# ---------------------------------------------------------------------------

def _gate_acts(gates):
    """[sigmoid(i), sigmoid(f), tanh(g), sigmoid(o)] of pre-activations (...,
    4H), gate order i, f, g, o."""
    H = gates.shape[-1] // 4
    return torch.cat([torch.sigmoid(gates[..., : 2 * H]), torch.tanh(gates[..., 2 * H : 3 * H]),
                      torch.sigmoid(gates[..., 3 * H :])], dim=-1)


def lstm_cell_bwd_act(act, cp, ct, u, dh, dc):
    """Backward through one tanh LSTM step from its gates' activations act =
    [i, f, g, o] (B, 4H), c_{t-1}, the forward's c_t, dL/dh_t and the
    carried dL/dc (``_lstm_bwdx_kernel`` :2443-2462). Returns (da (B, 4H) =
    dL/dxp in gate order i, f, g, o, dL/dh_{t-1}, dL/dc_{t-1})."""
    H = cp.shape[-1]
    i, f, g, o = act[:, :H], act[:, H : 2 * H], act[:, 2 * H : 3 * H], act[:, 3 * H :]
    tc = torch.tanh(ct)
    dc = dc + dh * o * (1.0 - tc * tc)
    da = torch.cat([dc * g * i * (1.0 - i), dc * cp * f * (1.0 - f), dc * i * (1.0 - g * g),
                    dh * tc * o * (1.0 - o)], dim=-1)
    return da, da @ u.t(), dc * f


def lstm_cell_bwd_xp(xp, hp, cp, ct, u, dh, dc):
    """Backward through one tanh LSTM step from its x-projection xp = x_t @
    W + b, h_{t-1}, c_{t-1}, the forward's c_t, dL/dh_t and the carried
    dL/dc (``_lstm_bwdx_kernel`` :2436-2462): ``lstm_cell_bwd_act`` of the
    gates recomputed from xp + h_{t-1} @ U."""
    return lstm_cell_bwd_act(_gate_acts(xp + hp @ u), cp, ct, u, dh, dc)


def _bptt(xps, hseq, cseq, h0, c0, d_seq, d_final, u):
    """Reverse-time loop shared by the plain versions of N and R: ``xps(t)``
    gives step t's x-projection. Returns (da (T, B, 4H), dh0, dc0)."""
    T = hseq.shape[0]
    dh = d_final if d_final is not None else torch.zeros_like(h0)
    dc = torch.zeros_like(c0)
    da = [None] * T
    for t in reversed(range(T)):
        if d_seq is not None:
            dh = dh + d_seq[t]
        hp, cp = (hseq[t - 1], cseq[t - 1]) if t > 0 else (h0, c0)
        da[t], dh, dc = lstm_cell_bwd_xp(xps(t), hp, cp, cseq[t], u, dh, dc)
    return torch.stack(da), dh, dc


def _widened(*ts):
    """Each tensor (None stays None) widened to float32: a no-op in a
    float32 layer."""
    return tuple(t.float() if t is not None else None for t in ts)


def lstm_layer_bwd_reference(x, hseq, cseq, h0, c0, d_seq, d_final, w, b, u, need_dx=True):
    """Plain version of kernel N: reverse-time BPTT of one layer over the
    forward's h and c sequences (T, B, H). ``d_seq`` (T, B, H) and
    ``d_final`` (B, H) are the incoming grads (either may be None). Returns
    (dx or None, dh0, dc0, da (T, B, 4H)). Every operand is widened to
    float32 and the transposition runs in float32, the dh and dc carries
    too; dx, dh0 and dc0 leave in x's dtype, da in float32
    (``_lstm_bwdx_kernel``: a no-op in a float32 layer)."""
    dtype = x.dtype
    x, hseq, cseq, h0, c0, d_seq, d_final, w, b, u = _widened(x, hseq, cseq, h0, c0, d_seq,
                                                              d_final, w, b, u)
    da, dh0, dc0 = _bptt(lambda t: x[t] @ w + b, hseq, cseq, h0, c0, d_seq, d_final, u)
    dx = (da @ w.t()).to(dtype) if need_dx else None
    return dx, dh0.to(dtype), dc0.to(dtype), da


# ---------------------------------------------------------------------------
# N's and R's phases (csrc/lstm_cell_bwd.cuh): the gate pre-pass, the chain
# over its activations on thread-block clusters, N's dx pass; each has its
# plain version and its launch counts (``.launches``, ``.launches_bf16``)
# ---------------------------------------------------------------------------

def lstm_bwd_gates_reference(x, hseq, h0, u, w=None, b=None):
    """Plain version of the gate pre-pass: act (T, B, 4H) float32 = the
    gates' activations [i, f, g, o] of x @ W + b + h_prev @ U (N's, with w
    and b) or of xp + h_prev @ U (R's: x is xp), h_prev = [h0, hseq[:-1]];
    every operand widened to float32 (in bf16 the products of bf16 values,
    summed in float32: ``_dot``'s ``preferred_element_type``)."""
    T, B = x.shape[:2]
    x, hseq, h0, u, w, b = _widened(x, hseq, h0, u, w, b)
    pre = x if w is None else (x.reshape(T * B, -1) @ w + b).reshape(T, B, -1)
    hprev = torch.cat([h0[None], hseq[:-1]]).reshape(T * B, -1)
    return _gate_acts(pre + (hprev @ u).reshape(T, B, -1))


def lstm_bwd_chain_reference(act, cseq, c0, d_seq, d_final, u):
    """Plain version of the chain: the reverse loop over the pre-pass's
    activations act (T, B, 4H). Returns (da (T, B, 4H), dh0, dc0), all
    float32, every operand widened: da @ U^T takes the float32 da."""
    cseq, c0, d_seq, d_final, u = _widened(cseq, c0, d_seq, d_final, u)
    T = act.shape[0]
    dh = d_final if d_final is not None else torch.zeros_like(c0)
    dc = torch.zeros_like(c0)
    da = [None] * T
    for t in reversed(range(T)):
        if d_seq is not None:
            dh = dh + d_seq[t]
        da[t], dh, dc = lstm_cell_bwd_act(act[t], cseq[t - 1] if t > 0 else c0, cseq[t], u, dh,
                                          dc)
    return torch.stack(da), dh, dc


def lstm_bwd_dx_reference(da, w):
    """Plain version of N's dx pass: da (T, B, 4H) float32 @ W^T with W
    widened, rounded once to W's dtype."""
    return (da @ w.float().t()).to(w.dtype)


_GATES_ARGS = {"lstm_layer_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
               "lstm_layer_xp_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
               + [ctypes.c_void_p]}
_CHAIN_INTS = [ctypes.c_int] * 9 + [ctypes.c_void_p]  # T, B, H, the plan, the stream


@functools.cache
def _phases(lib_name):
    """(library, {"gates" | "chain" | "dx": {dtype: entry}}) of kernel N's
    library ("lstm_layer_bwd") or R's ("lstm_layer_xp_bwd")."""
    entry = f"mvt_{lib_name}"
    lib, gates = _build.load_builds(lib_name, f"{entry}_gates", _GATES_ARGS[lib_name])
    chain = _build.load_builds(lib_name, f"{entry}_chain", [ctypes.c_void_p] * 9 + _CHAIN_INTS)[1]
    fns = {"gates": gates, "chain": chain}
    if lib_name == "lstm_layer_bwd":
        fns["dx"] = _build.load_builds(lib_name, f"{entry}_dx", [ctypes.c_void_p] * 3
                                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])[1]
    else:  # R's bf16 chain also writes the rounded dxp
        chain[torch.bfloat16].argtypes = [ctypes.c_void_p] * 10 + _CHAIN_INTS
    return lib, fns


def chain_plan(letter, H, B, dtype):
    """The chain's cluster plan (``_layout.bptt_plan``) of kernel ``letter``
    ("N" or "R") at (H, B) in ``dtype``, at the card's active clusters;
    raises LaunchLimitError where it does not launch."""
    build = _bf16_build(letter, dtype)
    C, stream = _layout.bptt_cluster(build, H)
    lib_name = "lstm_layer_bwd" if letter == "N" else "lstm_layer_xp_bwd"
    return _layout.bptt_plan(build, H, B,
                             _max_clusters(lib_name, dtype == torch.bfloat16, C, stream))


def _gates(lib_name, fn, x, hseq, h0, u, w=None, b=None, ut=None):
    """The pre-pass's build of x's dtype: the float32 build (FFMA) takes W
    and U as they are, the bf16 one (tensor cores) W^T and U^T (``ut``, when
    the caller has it)."""
    T, B = x.shape[:2]
    H = u.shape[0]
    act = torch.empty(T, B, 4 * H, device=x.device, dtype=torch.float32)
    if x.dtype == torch.bfloat16:
        u = u.t().contiguous() if ut is None else ut
        w = w.t().contiguous() if w is not None else None
    lib, fns = _phases(lib_name)
    if w is None:
        rc = fns["gates"][x.dtype](_ptr(x), _ptr(hseq), _ptr(h0), _ptr(u), _ptr(act), T, B, H,
                                   _stream(x))
    else:
        rc = fns["gates"][x.dtype](_ptr(x), _ptr(w), _ptr(b), _ptr(hseq), _ptr(h0), _ptr(u),
                                   _ptr(act), T, B, x.shape[2], H, _stream(x))
    _build.check(lib, rc, f"{lib_name} gates launch")
    _build.count_launch(fn, x.dtype)
    return act


def _chain(letter, fn, act, cseq, c0, d_seq, d_final, u, need_da=True, ut=None):
    """(da or None, dxp or None, dh0, dc0) of the chain's build of cseq's
    dtype: da float32, dxp the gate grads rounded (R's bf16 build); ``ut``
    is U^T where the caller has it."""
    T, B, H = cseq.shape
    dtype = cseq.dtype
    plan = chain_plan(letter, H, B, dtype)
    kw = {"device": cseq.device, "dtype": dtype}
    dh0, dc0 = torch.empty(B, H, **kw), torch.empty(B, H, **kw)
    rounded = letter == "R" and dtype == torch.bfloat16
    da = (torch.empty(T, B, 4 * H, device=cseq.device, dtype=torch.float32)
          if need_da or not rounded else None)
    dxp = torch.empty(T, B, 4 * H, **kw) if rounded else None
    if dtype == torch.bfloat16:
        ut = u  # the bf16 build's CTAs copy their columns of U
    elif ut is None:
        ut = u.t().contiguous()  # the float32 build's copy their rows of U^T
    lib_name = "lstm_layer_bwd" if letter == "N" else "lstm_layer_xp_bwd"
    lib, fns = _phases(lib_name)
    outs = (_opt(da), _ptr(dxp)) if rounded else (_ptr(da),)
    rc = fns["chain"][dtype](_ptr(act), _ptr(cseq), _ptr(c0), _opt(d_seq), _opt(d_final),
                             _ptr(ut), *outs, _ptr(dh0), _ptr(dc0), T, B, H, plan.cluster,
                             plan.rows, plan.splits, plan.nbuf, plan.stages, int(plan.stages > 0),
                             _stream(cseq))
    _build.check(lib, rc, f"{lib_name} chain launch")
    _build.count_launch(fn, dtype)
    return da, dxp, dh0, dc0


def _check_phase(what, named, expected, dtype=None):
    """Shapes, and on the card device, dtype and contiguity; True on the
    card."""
    _check_shapes(named, expected)
    first = next(iter(named.values()))
    if not _on(first, what):
        return False
    ops = {k: v for k, v in named.items() if k not in ("act", "da")}
    check_operands(ops, first.device, _build.DTYPES)
    for k in ("act", "da"):
        if k in named:
            check_operands({k: named[k]}, first.device, (torch.float32,))
    return True


def _bwd_expected(T, B, D, H):
    return {"x": (T, B, D), "xp": (T, B, 4 * H), "hseq": (T, B, H), "cseq": (T, B, H),
            "h0": (B, H), "c0": (B, H), "w": (D, 4 * H), "b": (4 * H,), "u": (H, 4 * H),
            "d_seq": (T, B, H), "d_final": (B, H), "act": (T, B, 4 * H), "da": (T, B, 4 * H)}


def _present(**ts):
    return {k: v for k, v in ts.items() if v is not None}


def lstm_layer_bwd_gates(x, hseq, h0, w, b, u):
    """Kernel N's gate pre-pass: ``lstm_bwd_gates_reference`` with W and b.
    CPU tensors run the plain version; CUDA tensors (every operand float32
    or every one bfloat16) launch its build of their dtype."""
    T, B, D = x.shape
    H = u.shape[0]
    if not _check_phase("lstm_layer_bwd_gates", _present(x=x, hseq=hseq, h0=h0, w=w, b=b, u=u),
                        _bwd_expected(T, B, D, H)):
        return lstm_bwd_gates_reference(x, hseq, h0, u, w, b)
    return _gates("lstm_layer_bwd", lstm_layer_bwd_gates, x, hseq, h0, u, w, b)


def lstm_layer_bwd_chain(act, cseq, c0, d_seq, d_final, u):
    """Kernel N's chain over the pre-pass's act: (da float32, dh0, dc0 in
    cseq's dtype). CPU tensors run ``lstm_bwd_chain_reference`` (dh0, dc0
    rounded to cseq's dtype); CUDA tensors launch its build of cseq's
    dtype on clusters (``chain_plan``)."""
    T, B, H = cseq.shape
    if not _check_phase("lstm_layer_bwd_chain",
                        _present(act=act, cseq=cseq, c0=c0, d_seq=d_seq, d_final=d_final, u=u),
                        _bwd_expected(T, B, 0, H)):
        da, dh0, dc0 = lstm_bwd_chain_reference(act, cseq, c0, d_seq, d_final, u)
        return da, dh0.to(cseq.dtype), dc0.to(cseq.dtype)
    da, _, dh0, dc0 = _chain("N", lstm_layer_bwd_chain, act, cseq, c0, d_seq, d_final, u)
    return da, dh0, dc0


def lstm_layer_bwd_dx(da, w):
    """Kernel N's dx pass: ``lstm_bwd_dx_reference``. CPU tensors run the
    plain version; CUDA tensors launch its build of W's dtype."""
    T, B, G = da.shape
    D = w.shape[0]
    if not _check_phase("lstm_layer_bwd_dx", {"da": da, "w": w},
                        {"da": (T, B, G), "w": (D, G)}):
        return lstm_bwd_dx_reference(da, w)
    dx = torch.empty(T, B, D, device=da.device, dtype=w.dtype)
    wt = w.t().contiguous()  # (4H, D): the product's B operand row by row
    lib, fns = _phases("lstm_layer_bwd")
    rc = fns["dx"][w.dtype](_ptr(da), _ptr(wt), _ptr(dx), T, B, D, G // 4, _stream(da))
    _build.check(lib, rc, "lstm_layer_bwd dx launch")
    _build.count_launch(lstm_layer_bwd_dx, w.dtype)
    return dx


for _fn in (lstm_layer_bwd_gates, lstm_layer_bwd_chain, lstm_layer_bwd_dx):
    _fn.launches = _fn.launches_bf16 = 0


def lstm_layer_bwd(x, hseq, cseq, h0, c0, d_seq, d_final, w, b, u, need_dx=True):
    """Backward of one tanh LSTM layer: see ``lstm_layer_bwd_reference``. CPU
    tensors run the plain version; CUDA tensors (every operand float32 or
    every one bfloat16) run kernel N's build of their dtype: its gate
    pre-pass, its chain and, with ``need_dx``, its dx pass (one launch of
    N counted on ``.launches`` or ``.launches_bf16``, each phase's on its
    own wrapper)."""
    T, B, D = x.shape
    H = u.shape[0]
    named = _present(x=x, hseq=hseq, cseq=cseq, h0=h0, c0=c0, w=w, b=b, u=u, d_seq=d_seq,
                     d_final=d_final)
    _check_shapes(named, _bwd_expected(T, B, D, H))
    if not _on(x, "lstm_layer_bwd"):
        return lstm_layer_bwd_reference(x, hseq, cseq, h0, c0, d_seq, d_final, w, b, u, need_dx)
    dtype = check_operands(named, x.device, _build.DTYPES)
    if T < 1 or B < 1:
        raise ValueError(f"kernel N takes T >= 1 and B >= 1; got T={T} B={B}")
    chain_plan("N", H, B, dtype)  # raises LaunchLimitError before any launch
    ut = u.t().contiguous()
    act = _gates("lstm_layer_bwd", lstm_layer_bwd_gates, x, hseq, h0, u, w, b, ut)
    da, _, dh0, dc0 = _chain("N", lstm_layer_bwd_chain, act, cseq, c0, d_seq, d_final, u,
                             ut=ut)
    dx = lstm_layer_bwd_dx(da, w) if need_dx else None
    _build.count_launch(lstm_layer_bwd, dtype)
    return dx, dh0, dc0, da


lstm_layer_bwd.launches = 0
lstm_layer_bwd.launches_bf16 = 0


def _grads_in(ctx, g):
    """(d_seq, d_final) of the layer's output grad g."""
    g = g.contiguous()
    return (g, None) if ctx.return_sequences else (None, g)


def _out(ctx, hseq, return_sequences):
    ctx.return_sequences = return_sequences
    return hseq if return_sequences else hseq[-1].clone()


class _LstmLayerTrainX(torch.autograd.Function):
    """Forward: kernel L with the h and c sequences as residuals. Backward:
    kernel N for dx, dh0, dc0 and the gate grads, then kernel W for dW, db,
    dU from the unrounded gate grads (float32 sums, rounded to the params'
    dtype)."""

    @staticmethod
    def forward(ctx, x, h0, c0, w, b, u, return_sequences):
        ctx.set_materialize_grads(True)
        hseq, cseq = lstm_layer(x, h0, c0, w, b, u, "tanh", True, with_c=True)
        ctx.save_for_backward(x, h0, c0, w, b, u, hseq, cseq)
        return _out(ctx, hseq, return_sequences)

    @staticmethod
    def backward(ctx, g):
        x, h0, c0, w, b, u, hseq, cseq = ctx.saved_tensors
        d_seq, d_final = _grads_in(ctx, g)
        dx, dh0, dc0, da = lstm_layer_bwd(x, hseq, cseq, h0, c0, d_seq, d_final, w, b, u,
                                          need_dx=ctx.needs_input_grad[0])
        dw, db, du = lstm_weight_grads(x, torch.cat([h0[None], hseq[:-1]]), da)
        return dx, dh0, dc0, dw.to(w.dtype), db.to(b.dtype), du.to(u.dtype), None


def lstm_layer_train_x(x, h0, c0, w, b, u, return_sequences=False):
    """Differentiable LSTM layer (tanh) over x (T, B, D) time-major, float32
    or bfloat16: the (T, B, H) sequence or the final h (B, H). CPU tensors
    run the plain versions of kernels L, N and W; CUDA tensors launch the
    builds of their dtype."""
    return _LstmLayerTrainX.apply(x, h0, c0, w, b, u, return_sequences)


# ---------------------------------------------------------------------------
# The wide route: the layer over a precomputed x-projection (kernels Q, R, W)
# ---------------------------------------------------------------------------

def lstm_layer_xp_reference(xp, h0, c0, u):
    """Plain version of kernel Q: the tanh LSTM layer over xp (T, B, 4H),
    returning the (T, B, H) h and c sequences in h0's and c0's dtype."""
    return _scan_xp(xp, h0, c0, u, torch.tanh)


def _check_xp(xp, h0, c0, u, what, **opt) -> tuple[int, int, int, bool]:
    """Shapes of the operands of kernels Q and R (``opt``: the optional ones,
    None when absent) and, on the card, their device, dtype and contiguity.
    Returns (T, B, H, on the card)."""
    if xp.dim() != 3:
        raise ValueError(f"xp must be (T, B, 4H), got {tuple(xp.shape)}")
    T, B = xp.shape[:2]
    H = u.shape[0]
    named = {"xp": xp, "h0": h0, "c0": c0, "u": u}
    named.update({k: v for k, v in opt.items() if v is not None})
    _check_shapes(named, {"xp": (T, B, 4 * H), "h0": (B, H), "c0": (B, H), "u": (H, 4 * H),
                          "hseq": (T, B, H), "cseq": (T, B, H), "d_seq": (T, B, H),
                          "d_final": (B, H)})
    on_card = _on(xp, what)
    if on_card:
        check_operands(named, xp.device, _build.DTYPES)
        if T < 1 or B < 1:
            raise ValueError(f"kernels Q and R take T >= 1 and B >= 1; got T={T} B={B}")
    return T, B, H, on_card


_FWD_LIBRARIES = {"Q": "lstm_layer_xp_fwd", "Q_bf16": "lstm_layer_xp_fwd",
                  "Y": "lstm_encoder_scan", "L_chain": "lstm_layer_fwd",
                  "L_chain_bf16": "lstm_layer_fwd"}


@functools.cache
def fwd_chain_plan(build, H, B):
    """The forward chain's cluster plan (``_layout.fwd_plan``) of build
    ``build`` (``_layout.FWD_BUILDS``: Q's, Y's, L's) at (H, B), at the
    card's active clusters; raises LaunchLimitError where it does not
    launch."""
    C, stream = _layout.fwd_cluster(build, H)
    bf16 = build in ("Q_bf16", "Y", "L_chain_bf16")
    return _layout.fwd_plan(build, H, B, _max_clusters(_FWD_LIBRARIES[build], bf16, C, stream))


@functools.cache
def _xp_fwd_kernel():
    return _build.load_builds("lstm_layer_xp_fwd", "mvt_lstm_layer_xp_fwd",
                              [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def lstm_layer_xp(xp, h0, c0, u):
    """The tanh LSTM layer forward over xp (T, B, 4H) time-major, every
    operand float32 or every one bfloat16: the (T, B, H) h and c sequences
    in their dtype. CPU tensors run ``lstm_layer_xp_reference``; CUDA
    tensors launch kernel Q's build of their dtype on clusters
    (``fwd_chain_plan``)."""
    T, B, H, on_card = _check_xp(xp, h0, c0, u, "lstm_layer_xp")
    if not on_card:
        return lstm_layer_xp_reference(xp, h0, c0, u)
    plan = fwd_chain_plan(_bf16_build("Q", xp.dtype), H, B)
    kw = {"device": xp.device, "dtype": xp.dtype}
    hseq, cseq = torch.empty(T, B, H, **kw), torch.empty(T, B, H, **kw)
    lib, fns = _xp_fwd_kernel()
    rc = fns[xp.dtype](_ptr(xp), _ptr(h0), _ptr(c0), _ptr(u), _ptr(hseq), _ptr(cseq), T, B, H,
                       plan.cluster, plan.rows, plan.splits, plan.stages, _stream(xp))
    _build.check(lib, rc, "lstm_layer_xp_fwd launch")
    _build.count_launch(lstm_layer_xp, xp.dtype)
    return hseq, cseq


lstm_layer_xp.launches = 0
lstm_layer_xp.launches_bf16 = 0


def lstm_layer_xp_bwd_reference(xp, hseq, cseq, h0, c0, d_seq, d_final, u):
    """Plain version of kernel R: reverse-time BPTT of the layer over xp.
    ``d_seq`` (T, B, H) and ``d_final`` (B, H) are the incoming grads (either
    may be None). Returns (dxp (T, B, 4H), dh0, dc0, da (T, B, 4H)). Every
    operand is widened to float32 and the transposition runs in float32, the
    dh and dc carries too; dxp (the gate grads), dh0 and dc0 leave in xp's
    dtype, da (the same gate grads) in float32 (``_lstm_bwd_kernel``,
    ``_lstm_bwd_wide_kernel``; in a float32 layer dxp is da)."""
    dtype = xp.dtype
    xp, hseq, cseq, h0, c0, d_seq, d_final, u = _widened(xp, hseq, cseq, h0, c0, d_seq, d_final,
                                                         u)
    da, dh0, dc0 = _bptt(lambda t: xp[t], hseq, cseq, h0, c0, d_seq, d_final, u)
    return da.to(dtype), dh0.to(dtype), dc0.to(dtype), da


def lstm_layer_xp_bwd_gates(xp, hseq, h0, u):
    """Kernel R's gate pre-pass: ``lstm_bwd_gates_reference`` over xp. CPU
    tensors run the plain version; CUDA tensors (every operand float32 or
    every one bfloat16) launch its build of their dtype."""
    T, B, G = xp.shape
    H = u.shape[0]
    if not _check_phase("lstm_layer_xp_bwd_gates", {"xp": xp, "hseq": hseq, "h0": h0, "u": u},
                        _bwd_expected(T, B, 0, H)):
        return lstm_bwd_gates_reference(xp, hseq, h0, u)
    return _gates("lstm_layer_xp_bwd", lstm_layer_xp_bwd_gates, xp, hseq, h0, u)


def lstm_layer_xp_bwd_chain(act, cseq, c0, d_seq, d_final, u, need_da=True):
    """Kernel R's chain over the pre-pass's act: (dxp, dh0, dc0, da) as
    ``lstm_layer_xp_bwd`` returns them. CPU tensors run
    ``lstm_bwd_chain_reference`` (dxp, dh0, dc0 rounded to cseq's dtype);
    CUDA tensors launch its build of cseq's dtype on clusters
    (``chain_plan``); in bfloat16 without ``need_da`` da is None."""
    T, B, H = cseq.shape
    if not _check_phase("lstm_layer_xp_bwd_chain",
                        _present(act=act, cseq=cseq, c0=c0, d_seq=d_seq, d_final=d_final, u=u),
                        _bwd_expected(T, B, 0, H)):
        da, dh0, dc0 = lstm_bwd_chain_reference(act, cseq, c0, d_seq, d_final, u)
        dtype = cseq.dtype
        return da.to(dtype), dh0.to(dtype), dc0.to(dtype), da
    da, dxp, dh0, dc0 = _chain("R", lstm_layer_xp_bwd_chain, act, cseq, c0, d_seq, d_final, u,
                               need_da)
    return (da if dxp is None else dxp), dh0, dc0, da


lstm_layer_xp_bwd_gates.launches = lstm_layer_xp_bwd_gates.launches_bf16 = 0
lstm_layer_xp_bwd_chain.launches = lstm_layer_xp_bwd_chain.launches_bf16 = 0


def lstm_layer_xp_bwd(xp, hseq, cseq, h0, c0, d_seq, d_final, u, need_da=True):
    """Backward of ``lstm_layer_xp``: see ``lstm_layer_xp_bwd_reference``.
    CPU tensors run the plain version; CUDA tensors (every operand float32
    or every one bfloat16) run kernel R's build of their dtype: its gate
    pre-pass and its chain (one launch of R counted, each phase's on its
    own wrapper). In bfloat16 without ``need_da`` the chain emits no
    float32 gate grads and da is None (the plain version computes it all
    the same)."""
    T, B, H, on_card = _check_xp(xp, h0, c0, u, "lstm_layer_xp_bwd", hseq=hseq, cseq=cseq,
                                 d_seq=d_seq, d_final=d_final)
    if not on_card:
        return lstm_layer_xp_bwd_reference(xp, hseq, cseq, h0, c0, d_seq, d_final, u)
    chain_plan("R", H, B, xp.dtype)  # raises LaunchLimitError before any launch
    ut = u.t().contiguous()
    act = _gates("lstm_layer_xp_bwd", lstm_layer_xp_bwd_gates, xp, hseq, h0, u, ut=ut)
    da, dxp, dh0, dc0 = _chain("R", lstm_layer_xp_bwd_chain, act, cseq, c0, d_seq, d_final, u,
                               need_da, ut)
    _build.count_launch(lstm_layer_xp_bwd, xp.dtype)
    return (da if dxp is None else dxp), dh0, dc0, da


lstm_layer_xp_bwd.launches = 0
lstm_layer_xp_bwd.launches_bf16 = 0


class _LstmLayerTrain(torch.autograd.Function):
    """Forward: kernel Q, the h and c sequences as residuals. Backward: kernel
    R for dxp, dh0 and dc0, then kernel W for dU, from R's float32 gate
    grads (``mode`` "inplace", row 16) or from the rounded dxp ("wide", row
    18), float32 sums rounded to U's dtype."""

    @staticmethod
    def forward(ctx, xp, h0, c0, u, return_sequences, mode):
        ctx.set_materialize_grads(True)
        hseq, cseq = lstm_layer_xp(xp, h0, c0, u)
        ctx.save_for_backward(xp, h0, c0, u, hseq, cseq)
        ctx.mode = mode
        return _out(ctx, hseq, return_sequences)

    @staticmethod
    def backward(ctx, g):
        xp, h0, c0, u, hseq, cseq = ctx.saved_tensors
        d_seq, d_final = _grads_in(ctx, g)
        dxp, dh0, dc0, da = lstm_layer_xp_bwd(xp, hseq, cseq, h0, c0, d_seq, d_final, u,
                                              need_da=ctx.mode == "inplace")
        du = lstm_u_grad(torch.cat([h0[None], hseq[:-1]]),
                         da if ctx.mode == "inplace" else dxp.float())
        return dxp, dh0, dc0, du.to(u.dtype), None, None


def lstm_layer_train(xp, h0, c0, u, return_sequences=False, mode="inplace"):
    """Differentiable tanh LSTM layer over a precomputed x-projection xp (T,
    B, 4H) time-major, float32 or bfloat16: the (T, B, H) sequence or the
    final h (B, H). ``mode`` ("inplace" or "wide", ``_layout.XP_MODES``) picks the
    row whose dU rounding the backward takes. CPU tensors run the plain
    versions of kernels Q, R and W; CUDA tensors launch the builds of their
    dtype."""
    if mode not in _layout.XP_MODES:
        raise ValueError(f"mode must be one of {_layout.XP_MODES}, got {mode!r}")
    return _LstmLayerTrain.apply(xp, h0, c0, u, return_sequences, mode)
