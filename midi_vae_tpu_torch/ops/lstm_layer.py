"""Kernel L: one whole LSTM layer forward with the x-projection in the kernel;
kernels N, Q and R: the LSTM layer's training backward and its wide route.

Serving: counterpart of ``midi_vae_tpu/ops/fused_train.py::lstm_layer_infer_x``,
whose Pallas kernels ``_lstm_fwdx_kernel`` (the h sequence) and
``_lstm_fwdx_last_kernel`` (the final h) the CUDA kernel
``csrc/lstm_layer_fwd.cu`` replaces; its source note gives the layout and
what bounds it. ``lstm_layer_reference`` is the plain PyTorch version
(``_lstm_layer_reference_x``): the CPU path and the kernel's oracle. Gate
order i, f, g, o; ``activation`` acts on g and on c
(``midi_vae_tpu/ops/fused_lstm.py::_lstm_gates``).

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
``_lstm_fwd_kernel`` in ``_lstm_fwd_pallas`` and ``_lstm_fwd_wide_pallas``)
and whose backward is kernel R (``csrc/lstm_layer_xp_bwd.cu``, replacing
``_lstm_bwd_kernel`` and ``_lstm_bwd_wide_kernel``) then kernel W for dU, as
``_lstm_wide_weight_grads`` does in XLA. The caller computes xp = x @ W + b
with torch.matmul, so dx, dW and db come from autograd. The backward
kernels hard-code tanh's derivative, as the TPU kernels do
(``_lstm_x_use_pallas`` :2546, ``_lstm_mode`` :1874); the model sends other
cell activations to the plain scan on any device (``models/rnn.py``).

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
from .gru_layer import CELL_ACTIVATIONS, _ptr, cell_activation, check_operands


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


@functools.cache
def _kernel():
    return _build.load_builds("lstm_layer_fwd", "mvt_lstm_layer_fwd",
                              [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


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


def lstm_layer(x, h0, c0, w, b, u, activation="tanh", return_sequences=False, with_c=False):
    """LSTM layer forward, x (T, B, D) time-major, every operand float32 or
    every one bfloat16.

    Returns the (T, B, H) h sequence when ``return_sequences`` else the final
    h (B, H); with ``with_c`` the (h sequence, c sequence) pair, the
    training forward's residual; in the operands' dtype. CPU tensors run
    ``lstm_layer_reference``; CUDA tensors launch kernel L's build of their
    dtype."""
    if activation not in CELL_ACTIVATIONS:
        raise ValueError(f"unsupported LSTM kernel activation {activation!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be (T, B, D), got {tuple(x.shape)}")
    T, B, D = x.shape
    H = u.shape[0]
    named = {"x": x, "h0": h0, "c0": c0, "w": w, "b": b, "u": u}
    _check_shapes(named, {"x": (T, B, D), "h0": (B, H), "c0": (B, H), "w": (D, 4 * H),
                          "b": (4 * H,), "u": (H, 4 * H)})
    if not _on(x, "lstm_layer"):
        return lstm_layer_reference(x, h0, c0, w, b, u, activation, return_sequences, with_c)
    dtype = check_operands(named, x.device, _build.DTYPES)
    if T < 1 or B < 1:
        raise ValueError(f"kernel L takes T >= 1 and B >= 1; got T={T} B={B}")
    build = _bf16_build("L", dtype)
    _layout.require(build, H, _layout.smem_bytes(build, H, D))
    emit_seq = return_sequences or with_c
    kw = {"device": x.device, "dtype": dtype}
    out = torch.empty((T, B, H) if emit_seq else (B, H), **kw)
    cseq = torch.empty(T, B, H, **kw) if with_c else None
    lib, fns = _kernel()
    rc = fns[dtype](
        _ptr(x), _ptr(h0), _ptr(c0), _ptr(w), _ptr(b), _ptr(u), _ptr(out), _opt(cseq),
        T, B, D, H, CELL_ACTIVATIONS[activation], int(emit_seq), _stream(x),
    )
    _build.check(lib, rc, "lstm_layer_fwd launch")
    _build.count_launch(lstm_layer, dtype)
    return (out, cseq) if with_c else out


lstm_layer.launches = 0
lstm_layer.launches_bf16 = 0


# ---------------------------------------------------------------------------
# Training, the narrow route: the backward (kernel N + kernel W) and the
# autograd Function
# ---------------------------------------------------------------------------

def lstm_cell_bwd_xp(xp, hp, cp, ct, u, dh, dc):
    """Backward through one tanh LSTM step from its x-projection xp = x_t @
    W + b, h_{t-1}, c_{t-1}, the forward's c_t, dL/dh_t and the carried
    dL/dc (``_lstm_bwdx_kernel`` :2436-2462). Returns (da (B, 4H) = dL/dxp
    in gate order i, f, g, o, dL/dh_{t-1}, dL/dc_{t-1})."""
    H = hp.shape[-1]
    gates = xp + hp @ u
    i = torch.sigmoid(gates[:, :H])
    f = torch.sigmoid(gates[:, H : 2 * H])
    g = torch.tanh(gates[:, 2 * H : 3 * H])
    o = torch.sigmoid(gates[:, 3 * H :])
    tc = torch.tanh(ct)
    dc = dc + dh * o * (1.0 - tc * tc)
    da = torch.cat([dc * g * i * (1.0 - i), dc * cp * f * (1.0 - f), dc * i * (1.0 - g * g),
                    dh * tc * o * (1.0 - o)], dim=-1)
    return da, da @ u.t(), dc * f


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


@functools.cache
def _bwd_kernel():
    return _build.load_builds("lstm_layer_bwd", "mvt_lstm_layer_bwd",
                              [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def lstm_layer_bwd(x, hseq, cseq, h0, c0, d_seq, d_final, w, b, u, need_dx=True):
    """Backward of one tanh LSTM layer: see ``lstm_layer_bwd_reference``. CPU
    tensors run the plain version; CUDA tensors (every operand float32 or
    every one bfloat16) launch kernel N's build of their dtype."""
    T, B, D = x.shape
    H = u.shape[0]
    named = {"x": x, "hseq": hseq, "cseq": cseq, "h0": h0, "c0": c0, "w": w, "b": b, "u": u}
    expected = {"x": (T, B, D), "hseq": (T, B, H), "cseq": (T, B, H), "h0": (B, H),
                "c0": (B, H), "w": (D, 4 * H), "b": (4 * H,), "u": (H, 4 * H),
                "d_seq": (T, B, H), "d_final": (B, H)}
    for name, t in (("d_seq", d_seq), ("d_final", d_final)):
        if t is not None:
            named[name] = t
    _check_shapes(named, expected)
    if not _on(x, "lstm_layer_bwd"):
        return lstm_layer_bwd_reference(x, hseq, cseq, h0, c0, d_seq, d_final, w, b, u, need_dx)
    dtype = check_operands(named, x.device, _build.DTYPES)
    if T < 1 or B < 1:
        raise ValueError(f"kernel N takes T >= 1 and B >= 1; got T={T} B={B}")
    build = _bf16_build("N", dtype)
    _layout.require(build, H, _layout.smem_bytes(build, H, D))
    kw = {"device": x.device, "dtype": dtype}
    dx = torch.empty(T, B, D, **kw) if need_dx else None
    dh0, dc0 = torch.empty(B, H, **kw), torch.empty(B, H, **kw)
    da = torch.empty(T, B, 4 * H, device=x.device, dtype=torch.float32)
    # the transposed products read U^T and W^T row by row (see the source)
    ut, wt = u.t().contiguous(), w.t().contiguous()
    lib, fns = _bwd_kernel()
    rc = fns[dtype](
        _ptr(x), _ptr(hseq), _ptr(cseq), _ptr(h0), _ptr(c0), _opt(d_seq), _opt(d_final),
        _ptr(w), _ptr(b), _ptr(u), _ptr(ut), _ptr(wt), _opt(dx), _ptr(dh0), _ptr(dc0), _ptr(da),
        T, B, D, H, _stream(x),
    )
    _build.check(lib, rc, "lstm_layer_bwd launch")
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


@functools.cache
def _xp_fwd_kernel():
    return _build.load_builds("lstm_layer_xp_fwd", "mvt_lstm_layer_xp_fwd",
                              [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def lstm_layer_xp(xp, h0, c0, u):
    """The tanh LSTM layer forward over xp (T, B, 4H) time-major, every
    operand float32 or every one bfloat16: the (T, B, H) h and c sequences
    in their dtype. CPU tensors run ``lstm_layer_xp_reference``; CUDA
    tensors launch kernel Q's build of their dtype."""
    T, B, H, on_card = _check_xp(xp, h0, c0, u, "lstm_layer_xp")
    if not on_card:
        return lstm_layer_xp_reference(xp, h0, c0, u)
    build = _bf16_build("Q", xp.dtype)
    _layout.require(build, H, _layout.smem_bytes(build, H))
    kw = {"device": xp.device, "dtype": xp.dtype}
    hseq, cseq = torch.empty(T, B, H, **kw), torch.empty(T, B, H, **kw)
    lib, fns = _xp_fwd_kernel()
    rc = fns[xp.dtype](_ptr(xp), _ptr(h0), _ptr(c0), _ptr(u), _ptr(hseq), _ptr(cseq), T, B, H,
                       _stream(xp))
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


@functools.cache
def _xp_bwd_kernel():
    lib, fns = _build.load_builds("lstm_layer_xp_bwd", "mvt_lstm_layer_xp_bwd",
                                  [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    # the float32 build has no dxp pointer: its dacat is its dxp
    fns[torch.float32].argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib, fns


def lstm_layer_xp_bwd(xp, hseq, cseq, h0, c0, d_seq, d_final, u, need_da=True):
    """Backward of ``lstm_layer_xp``: see ``lstm_layer_xp_bwd_reference``.
    CPU tensors run the plain version; CUDA tensors (every operand float32
    or every one bfloat16) launch kernel R's build of their dtype. In
    bfloat16 without ``need_da`` the kernel emits no float32 gate grads and
    da is None (the plain version computes it all the same)."""
    T, B, H, on_card = _check_xp(xp, h0, c0, u, "lstm_layer_xp_bwd", hseq=hseq, cseq=cseq,
                                 d_seq=d_seq, d_final=d_final)
    if not on_card:
        return lstm_layer_xp_bwd_reference(xp, hseq, cseq, h0, c0, d_seq, d_final, u)
    dtype = xp.dtype
    build = _bf16_build("R", dtype)
    _layout.require(build, H, _layout.smem_bytes(build, H))
    kw = {"device": xp.device, "dtype": dtype}
    dh0, dc0 = torch.empty(B, H, **kw), torch.empty(B, H, **kw)
    bf16 = dtype == torch.bfloat16
    da = (torch.empty(T, B, 4 * H, device=xp.device, dtype=torch.float32)
          if need_da or not bf16 else None)
    # the float32 build's dxp is its da; the bf16 build also rounds it
    dxp = torch.empty(T, B, 4 * H, **kw) if bf16 else da
    ut = u.t().contiguous()  # the transposed product reads U^T row by row
    lib, fns = _xp_bwd_kernel()
    outs = (_opt(da), _ptr(dxp)) if bf16 else (_ptr(da),)
    rc = fns[dtype](_ptr(xp), _ptr(hseq), _ptr(cseq), _ptr(h0), _ptr(c0), _opt(d_seq),
                    _opt(d_final), _ptr(u), _ptr(ut), *outs, _ptr(dh0), _ptr(dc0), T, B, H,
                    _stream(xp))
    _build.check(lib, rc, "lstm_layer_xp_bwd launch")
    _build.count_launch(lstm_layer_xp_bwd, dtype)
    return dxp, dh0, dc0, da


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
