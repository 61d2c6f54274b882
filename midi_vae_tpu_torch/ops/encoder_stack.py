"""Kernels U and V: the fused GRU encoder stacks, a 2-layer reset-before GRU
stack with x @ W inside the kernel and, beside it, 1-layer branches.

Counterpart of ``midi_vae_tpu/ops/fused_train.py::gru_stack2_train_x``
(:2849) and ``::gru_encode_multibranch_train`` (:3960), whose Pallas kernels
``_stack2_fwd_kernel`` (row 22 of the kernel table), ``_stack2_bwd_kernel``
(row 23), ``_encmb_fwd_kernel`` (row 24) and ``_encmb_bwd_kernel`` (row 25)
kernel U (``csrc/gru_encoder_stack_fwd.cu``: the forwards) and kernel V
(``csrc/gru_encoder_stack_bwd.cu``: the backwards) replace; their source
notes give the layout and what bounds them. The JAX model does not call these
ops (it keeps the per-layer dispatch, ``midi_vae_tpu/models/vae.py:266-273``),
and neither does the port's: they are entry points of their own, at the
default ``Config()`` encoder's shapes (the notes stack, the velocity and
instrument branches).

The plain versions compute what the kernels compute, rounding included, and
are the CPU path and the kernels' oracles:
- ``stack2_fwd_reference`` (row 22): layer 2 takes layer 1's unrounded
  float32 h of the same step, and only the carried states and the emitted
  sequences are rounded to x's dtype (``_stack2_fwd_kernel`` :2659-2668);
- ``stack2_bwd_reference`` (row 23): per reverse step layer 2's cell
  backward on the stored h1_t and h2_{t-1}, whose dx feeds layer 1's dh
  carry; the carries stay in float32 (:2722-2746);
- ``multibranch_fwd_reference`` (row 24) and ``multibranch_bwd_reference``
  (row 25): the stack and each branch from zero states; a branch of Tk < T
  steps stops at Tk, and its backward starts at Tk - 1 from its final grad.
In float32 they equal the JAX references; in bfloat16 the stack does not:
the JAX reference ``_stack2_reference`` feeds layer 2 the rounded h1
sequence, and rounds every op. ``stack2_reference`` and
``multibranch_reference`` are that reference's twins, taken where the JAX
package takes it.

``gru_stack2_train_x`` and ``gru_encode_multibranch_train`` are
``torch.autograd.Function``s: the forward is U (emitting the sequences the
backward needs), the backward V then kernel W (``ops/grad_reduce.py``) for
each layer's dW, db and dU, in float32 and cast to the parameters' dtype.
The dispatch mirrors ``_stack2_use_pallas`` and ``_encmb_use_pallas`` but
their VMEM estimates: the JAX reference runs for a non-tanh cell (the
backward hard-codes tanh's derivative), for the stack in bfloat16 with
D < 8, for the multi-branch op in bfloat16, and for a branch longer than
the stack. In place of the VMEM estimates, each launch checks the card's
limits (``ops/_layout.py``: registers and shared memory) and raises
``LaunchLimitError`` where a build cannot launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, _layout
from .encoder_scan import gru_encoder_scan_vjp_reference
from .grad_reduce import gru_weight_grads
from .gru_layer import check_operands, gru_cell_bwd_core, gru_layer_bwd_reference, gru_step
from .lstm_layer import _check_shapes, _on, _stream

MAX_BRANCHES = 3  # kMaxBranches of the kernels: instrument, velocity, held notes


# ---------------------------------------------------------------------------
# The JAX references' twins (the paths where the JAX package takes them)
# ---------------------------------------------------------------------------

def _layer_reference(x, h0, p, activation, return_sequences):
    """``_gru_layer_reference_x``: xp = x @ W + b, then
    ``_encoder_scan_reference``, every op in the operands' dtype."""
    T, B, D = x.shape
    xp = (x.reshape(T * B, D) @ p["w"] + p["b"]).reshape(T, B, -1)
    return gru_encoder_scan_vjp_reference(xp, h0, p["u"], activation, return_sequences)


def stack2_reference(x, h01, h02, p1, p2, activation="tanh", return_sequences=False):
    """``_stack2_reference``: layer 1's sequence, then layer 2 over it."""
    seq1 = _layer_reference(x, h01, p1, activation, True)
    return _layer_reference(seq1, h02, p2, activation, return_sequences)


def multibranch_reference(stack, branches, activation="tanh"):
    """``_encmb_reference``: (layer 2's final h, (each branch's final h)),
    every initial state zero."""
    x = stack["x"]
    zero = x.new_zeros(x.shape[1], stack["p1"]["u"].shape[0])
    h1 = _layer_reference(x, zero, stack["p1"], activation, True)
    h2 = _layer_reference(h1, zero, stack["p2"], activation, False)
    return h2, tuple(_layer_reference(br["x"], zero, br["p"], activation, False)
                     for br in branches)


# ---------------------------------------------------------------------------
# Plain versions of the kernels
# ---------------------------------------------------------------------------

def stack2_fwd_reference(x, h01, h02, p1, p2):
    """Plain version of U's stack (row 22): x (T, B, D), h01, h02 (B, H) ->
    the (T, B, H) h1 and h2 sequences in x's dtype."""
    h1, h2, seq1, seq2 = h01, h02, [], []
    for t in range(x.shape[0]):
        h1f = gru_step(x[t], h1.float(), p1["w"], p1["u"], p1["b"], torch.tanh)
        h2 = gru_step(h1f, h2, p2["w"], p2["u"], p2["b"], torch.tanh)
        h1 = h1f.to(x.dtype)
        seq1.append(h1)
        seq2.append(h2)
    return torch.stack(seq1), torch.stack(seq2)


def stack2_bwd_reference(x, h1_seq, h2_seq, h01, h02, d_seq, d_final, p1, p2, need_dx=True):
    """Plain version of V's stack (row 23): reverse-time BPTT of both layers
    over the forward's sequences. ``d_seq`` (T, B, H) and ``d_final`` (B, H)
    are layer 2's incoming grads (either may be None). Returns (dx or None,
    dh01, dh02, (da_cat, r*h) of layer 1, of layer 2): dx and the dh0s in
    x's dtype, the gate grads da_cat (T, B, 3H) and r*h (T, B, H) in
    float32."""
    w1, b1, u1 = (p1[k].float() for k in "wbu")
    w2, b2, u2 = (p2[k].float() for k in "wbu")
    T = x.shape[0]
    dh1 = torch.zeros(h01.shape, dtype=torch.float32, device=x.device)
    dh2 = d_final.float() if d_final is not None else dh1
    dx, da1, rh1, da2, rh2 = ([None] * T for _ in range(5))
    for t in reversed(range(T)):
        if d_seq is not None:
            dh2 = dh2 + d_seq[t].float()
        h1p, h2p = (h1_seq[t - 1], h2_seq[t - 1]) if t > 0 else (h01, h02)
        dx2, dh2, da2[t], rh2[t] = gru_cell_bwd_core(h1_seq[t].float(), h2p.float(), w2, u2, b2,
                                                     dh2)
        dh1 = dh1 + dx2
        dx[t], dh1, da1[t], rh1[t] = gru_cell_bwd_core(x[t].float(), h1p.float(), w1, u1, b1, dh1)
    return ((torch.stack(dx).to(x.dtype) if need_dx else None), dh1.to(x.dtype),
            dh2.to(x.dtype), (torch.stack(da1), torch.stack(rh1)),
            (torch.stack(da2), torch.stack(rh2)))


def _branch_fwd_reference(x, h0, p):
    h, seq = h0, []
    for t in range(x.shape[0]):
        h = gru_step(x[t], h, p["w"], p["u"], p["b"], torch.tanh)
        seq.append(h)
    return torch.stack(seq)


def multibranch_fwd_reference(x, p1, p2, branches):
    """Plain version of U with branches (row 24), every initial state zero:
    ``branches`` is a list of (x_k (T_k, B, D_k), p_k). Returns (h1 sequence,
    h2 sequence, [h_k sequence (T_k, B, H)])."""
    zero = x.new_zeros(x.shape[1], p1["u"].shape[0])
    h1, h2 = stack2_fwd_reference(x, zero, zero, p1, p2)
    return h1, h2, [_branch_fwd_reference(xk, zero, pk) for xk, pk in branches]


def multibranch_bwd_reference(x, h1_seq, h2_seq, p1, p2, d_final, branches, need_dx=True):
    """Plain version of V with branches (row 25): the stack from layer 2's
    final grad, each branch from its own (``branches``: (x_k, h_k sequence,
    d_final_k, p_k, dx_k wanted)). Returns (dx or None, (da_cat, r*h) of
    layer 1, of layer 2, [(dx_k or None, da_cat_k, r*h_k)])."""
    zero = x.new_zeros(x.shape[1], p1["u"].shape[0])
    dx, _, _, g1, g2 = stack2_bwd_reference(x, h1_seq, h2_seq, zero, zero, None, d_final, p1, p2,
                                            need_dx)
    out = []
    for xk, hk, dk, pk, need_dxk in branches:
        dxk, _, dak, rhk = gru_layer_bwd_reference(xk, hk, zero, None, dk, pk["w"], pk["b"],
                                                   pk["u"], need_dxk)
        out.append((dxk, dak, rhk))
    return dx, g1, g2, out


# ---------------------------------------------------------------------------
# The kernel wrappers
# ---------------------------------------------------------------------------

_STACK_FWD_PTRS = ("x", "h01", "h02", "w1", "b1", "u1", "w2", "b2", "u2", "h1seq", "h2seq")
_BRANCH_FWD_PTRS = ("x", "w", "b", "u", "hseq")
_STACK_BWD_PTRS = ("x", "h1seq", "h2seq", "h01", "h02", "d_seq", "d_final", "w1", "b1", "u1",
                   "u1t", "w1t", "w2", "b2", "u2", "u2t", "w2t", "dx", "dh01", "dh02", "da1",
                   "rh1", "da2", "rh2")
_BRANCH_BWD_PTRS = ("x", "hseq", "d_final", "w", "b", "u", "ut", "wt", "dx", "da", "rh")


def _struct(name, ptrs):
    return type(name, (ctypes.Structure,), {
        "_fields_": ([(n, ctypes.c_void_p) for n in ptrs]
                     + [("T", ctypes.c_int), ("D", ctypes.c_int)]),
        "__doc__": f"struct {name.lstrip('_')} of the kernel sources."})


_StackFwd = _struct("_StackFwd", _STACK_FWD_PTRS)
_BranchFwd = _struct("_BranchFwd", _BRANCH_FWD_PTRS)
_StackBwd = _struct("_StackBwd", _STACK_BWD_PTRS)
_BranchBwd = _struct("_BranchBwd", _BRANCH_BWD_PTRS)


def _fill(struct, named: dict, T: int, D: int) -> None:
    """Sets a struct's pointers from ``named`` (absent or None: null)."""
    for name, _ in struct._fields_[:-2]:
        t = named.get(name)
        setattr(struct, name, t.data_ptr() if t is not None else None)
    struct.T, struct.D = T, D


@functools.cache
def _kernels(name):
    """(library, stack2 entry point, multi-branch entry point) of U or V."""
    lib = _build.load(name)
    stack, branch = (_StackFwd, _BranchFwd) if name.endswith("fwd") else (_StackBwd, _BranchBwd)
    op = name.removeprefix("gru_encoder_stack_")
    stack2 = getattr(lib, f"mvt_gru_stack2_{op}")
    multi = getattr(lib, f"mvt_gru_encode_multibranch_{op}")
    stack2.argtypes = [ctypes.POINTER(stack), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
    multi.argtypes = [ctypes.POINTER(stack), ctypes.POINTER(branch), ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p]
    stack2.restype = multi.restype = ctypes.c_int
    return lib, stack2, multi


def require_launch(kernel: str, H: int, D: int, branch_dims=(), dx: bool = False,
                   branch_dx=()) -> None:
    """Raise LaunchLimitError where kernel U or V (``kernel``) cannot launch
    a block of H threads with the tile of the stack over D inputs and of
    each branch over its own (``branch_dims``; dx wanted: ``dx``,
    ``branch_dx``)."""
    branch_dx = tuple(branch_dx) or (False,) * len(branch_dims)
    smem = max([_layout.smem_bytes(kernel, H, D, 2, dx)]
               + [_layout.smem_bytes(kernel, H, d, 1, e) for d, e in zip(branch_dims, branch_dx)])
    _layout.require(kernel, H, smem)


def _check_stack(x, p1, p2, named: dict):
    """Shapes of x and the stack's weights, which join ``named`` (the
    operands of a launch); returns (T, B, D, H)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (T, B, D), got {tuple(x.shape)}")
    T, B, D = x.shape
    if T < 1 or B < 1:
        raise ValueError(f"kernels U and V take T >= 1 and B >= 1; got T={T} B={B}")
    H = p1["u"].shape[0]
    for i, (p, d) in enumerate(((p1, D), (p2, H)), start=1):
        weights = {f"w{i}": p["w"], f"b{i}": p["b"], f"u{i}": p["u"]}
        _check_shapes(weights, {f"w{i}": (d, 3 * H), f"b{i}": (3 * H,), f"u{i}": (H, 3 * H)})
        named.update(weights)
    named["x"] = x
    return T, B, D, H


def _check_branches(branches, B: int, H: int, T: int) -> None:
    if len(branches) > MAX_BRANCHES:
        raise ValueError(f"kernels U and V take at most {MAX_BRANCHES} branches, got "
                         f"{len(branches)}")
    for k, (xk, pk) in enumerate(branches):
        if xk.dim() != 3 or xk.shape[1] != B or not 1 <= xk.shape[0] <= T:
            raise ValueError(f"branch {k}: x must be (T_k, {B}, D_k) with 1 <= T_k <= T = {T}, got "
                             f"{tuple(xk.shape)}")
        d = xk.shape[2]
        _check_shapes({"w": pk["w"], "b": pk["b"], "u": pk["u"]},
                      {"w": (d, 3 * H), "b": (3 * H,), "u": (H, 3 * H)})


def gru_encoder_stack_fwd(x, h01, h02, p1, p2, branches=()):
    """The stack's forward over x (T, B, D) time-major from h01 and h02
    (both None: zeros, the multi-branch op) and each branch's (x_k, p_k)
    from zero: returns (h1 sequence, h2 sequence, [h_k sequence]). CPU
    tensors run the plain versions; CUDA tensors launch kernel U: its
    stack2 entry (float32 or bfloat16) where h01 and h02 are given, else its
    multi-branch entry (float32)."""
    multi = h01 is None
    if multi != (h02 is None):
        raise ValueError("give both h01 and h02, or neither (zero states)")
    named = {}
    T, B, D, H = _check_stack(x, p1, p2, named)
    if not multi:
        if branches:
            raise ValueError("the branches run from zero states: give no h01 and h02 with them")
        _check_shapes({"h01": h01, "h02": h02}, {"h01": (B, H), "h02": (B, H)})
        named.update({"h01": h01, "h02": h02})
    else:
        _check_branches(branches, B, H, T)
    if not _on(x, "gru_encoder_stack_fwd"):
        if multi:
            return multibranch_fwd_reference(x, p1, p2, branches)
        return (*stack2_fwd_reference(x, h01, h02, p1, p2), [])
    dtype = check_operands(named, x.device,
                           (torch.float32,) if multi else (torch.float32, torch.bfloat16))
    require_launch("U", H, D, [xk.shape[2] for xk, _ in branches])
    kw = {"device": x.device, "dtype": dtype}
    named["h1seq"], named["h2seq"] = torch.empty(T, B, H, **kw), torch.empty(T, B, H, **kw)
    stack = _StackFwd()
    _fill(stack, named, T, D)
    lib, stack2, multibranch = _kernels("gru_encoder_stack_fwd")
    hk = []
    if multi:
        structs = (_BranchFwd * max(1, len(branches)))()
        for (xk, pk), st in zip(branches, structs):
            hk.append(torch.empty(xk.shape[0], B, H, **kw))
            bnamed = {"x": xk, "w": pk["w"], "b": pk["b"], "u": pk["u"], "hseq": hk[-1]}
            check_operands(bnamed, x.device)
            _fill(st, bnamed, xk.shape[0], xk.shape[2])
        rc = multibranch(ctypes.byref(stack), structs, len(branches), B, H, _stream(x))
    else:
        rc = stack2(ctypes.byref(stack), B, H, int(dtype == torch.bfloat16), _stream(x))
    _build.check(lib, rc, "gru_encoder_stack_fwd launch")
    gru_encoder_stack_fwd.launches += 1
    return named["h1seq"], named["h2seq"], hk


gru_encoder_stack_fwd.launches = 0


def gru_encoder_stack_bwd(x, h1_seq, h2_seq, h01, h02, d_seq, d_final, p1, p2, branches=(),
                          need_dx=True):
    """Backward of ``gru_encoder_stack_fwd``: layer 2's incoming grads
    ``d_seq`` (T, B, H) or ``d_final`` (B, H) (either may be None; the
    multi-branch op takes d_final only), and per branch (x_k, h_k sequence,
    d_final_k, p_k, dx_k wanted). Returns (dx or None, dh01, dh02 (None for
    the multi-branch op), (da_cat, r*h) of layer 1, of layer 2,
    [(dx_k or None, da_cat_k, r*h_k)]): the gate grads in float32 for
    kernel W, dx and the dh0s in x's dtype. CPU tensors run the plain
    versions; CUDA tensors launch kernel V."""
    multi = h01 is None
    if multi != (h02 is None):
        raise ValueError("give both h01 and h02, or neither (zero states)")
    named = {}
    T, B, D, H = _check_stack(x, p1, p2, named)
    given = {name: (t, shape) for name, t, shape in (
        ("h1seq", h1_seq, (T, B, H)), ("h2seq", h2_seq, (T, B, H)), ("h01", h01, (B, H)),
        ("h02", h02, (B, H)), ("d_seq", d_seq, (T, B, H)), ("d_final", d_final, (B, H)))
        if t is not None}
    _check_shapes({k: t for k, (t, _) in given.items()}, {k: s for k, (_, s) in given.items()})
    named.update({k: t for k, (t, _) in given.items()})
    if not multi and branches:
        raise ValueError("the branches run from zero states: give no h01 and h02 with them")
    if multi:
        if d_seq is not None:
            raise ValueError("the multi-branch backward takes layer 2's d_final only")
        _check_branches([(xk, pk) for xk, _, _, pk, _ in branches], B, H, T)
        for xk, hk, dk, _, _ in branches:
            _check_shapes({"h": hk, "d_final": dk}, {"h": (xk.shape[0], B, H), "d_final": (B, H)})
    if not _on(x, "gru_encoder_stack_bwd"):
        if multi:
            dx, g1, g2, out = multibranch_bwd_reference(x, h1_seq, h2_seq, p1, p2, d_final,
                                                        branches, need_dx)
            return dx, None, None, g1, g2, out
        return (*stack2_bwd_reference(x, h1_seq, h2_seq, h01, h02, d_seq, d_final, p1, p2,
                                      need_dx), [])
    dtype = check_operands(named, x.device,
                           (torch.float32,) if multi else (torch.float32, torch.bfloat16))
    require_launch("V", H, D, [xk.shape[2] for xk, *_ in branches], need_dx,
                   [b[4] for b in branches])
    f32 = {"device": x.device, "dtype": torch.float32}
    # weights in float32 (a bf16 model's widened exactly), with the
    # transposes the transposed products read row by row
    for i in (1, 2):
        w, u = named[f"w{i}"].float(), named[f"u{i}"].float()
        named.update({f"w{i}": w, f"b{i}": named[f"b{i}"].float(), f"u{i}": u,
                      f"u{i}t": u.t().contiguous(), f"w{i}t": w.t().contiguous()})
    out = {"dx": torch.empty(T, B, D, device=x.device, dtype=dtype) if need_dx else None,
           "da1": torch.empty(T, B, 3 * H, **f32), "rh1": torch.empty(T, B, H, **f32),
           "da2": torch.empty(T, B, 3 * H, **f32), "rh2": torch.empty(T, B, H, **f32)}
    if not multi:
        out["dh01"] = torch.empty(B, H, device=x.device, dtype=dtype)
        out["dh02"] = torch.empty(B, H, device=x.device, dtype=dtype)
    stack = _StackBwd()
    _fill(stack, {**named, **out}, T, D)
    lib, stack2, multibranch = _kernels("gru_encoder_stack_bwd")
    branch_out, transposes = [], []
    if multi:
        structs = (_BranchBwd * max(1, len(branches)))()
        for (xk, hk, dk, pk, need_dxk), st in zip(branches, structs):
            Tk, Dk = xk.shape[0], xk.shape[2]
            bnamed = {"x": xk, "hseq": hk, "d_final": dk, "w": pk["w"], "b": pk["b"], "u": pk["u"]}
            check_operands(bnamed, x.device)
            o = (torch.empty(Tk, B, Dk, **f32) if need_dxk else None,
                 torch.empty(Tk, B, 3 * H, **f32), torch.empty(Tk, B, H, **f32))
            branch_out.append(o)
            # held until the launch is queued: freed earlier, the allocator
            # would hand their memory to the next branch's tensors
            transposes.append((pk["u"].t().contiguous(), pk["w"].t().contiguous()))
            _fill(st, {**bnamed, "ut": transposes[-1][0], "wt": transposes[-1][1], "dx": o[0],
                       "da": o[1], "rh": o[2]}, Tk, Dk)
        rc = multibranch(ctypes.byref(stack), structs, len(branches), B, H, _stream(x))
    else:
        rc = stack2(ctypes.byref(stack), B, H, int(dtype == torch.bfloat16), _stream(x))
    _build.check(lib, rc, "gru_encoder_stack_bwd launch")
    gru_encoder_stack_bwd.launches += 1
    return (out["dx"], out.get("dh01"), out.get("dh02"), (out["da1"], out["rh1"]),
            (out["da2"], out["rh2"]), branch_out)


gru_encoder_stack_bwd.launches = 0


# ---------------------------------------------------------------------------
# The ops: autograd Functions and dispatch
# ---------------------------------------------------------------------------

def _params(w, b, u):
    return {"w": w, "b": b, "u": u}


def _weight_grads(x, h0, seq, rh, da, params):
    """dW, db, dU of one layer (kernel W, three reductions in float32) from
    its gate grads, cast to the parameters' dtype; h0 None: zeros."""
    first = h0[None] if h0 is not None else seq.new_zeros((1, *seq.shape[1:]))
    hprev = torch.cat([first, seq[:-1]]).float()
    grads = gru_weight_grads(x.float(), hprev, rh, da)
    return tuple(g.to(p.dtype) for g, p in zip(grads, params))


class _Stack2Train(torch.autograd.Function):
    """Forward: kernel U (stack2) with both h sequences as residuals.
    Backward: kernel V for dx, dh01, dh02 and each layer's gate grads, then
    kernel W for each layer's dW, db, dU."""

    @staticmethod
    def forward(ctx, x, h01, h02, w1, b1, u1, w2, b2, u2, return_sequences):
        ctx.set_materialize_grads(True)
        h1_seq, h2_seq, _ = gru_encoder_stack_fwd(x, h01, h02, _params(w1, b1, u1),
                                                  _params(w2, b2, u2))
        ctx.save_for_backward(x, h01, h02, w1, b1, u1, w2, b2, u2, h1_seq, h2_seq)
        ctx.return_sequences = return_sequences
        return h2_seq if return_sequences else h2_seq[-1].clone()

    @staticmethod
    def backward(ctx, g):
        x, h01, h02, w1, b1, u1, w2, b2, u2, h1_seq, h2_seq = ctx.saved_tensors
        g = g.contiguous()
        d_seq, d_final = (g, None) if ctx.return_sequences else (None, g)
        dx, dh01, dh02, (da1, rh1), (da2, rh2), _ = gru_encoder_stack_bwd(
            x, h1_seq, h2_seq, h01, h02, d_seq, d_final, _params(w1, b1, u1), _params(w2, b2, u2),
            need_dx=ctx.needs_input_grad[0])
        g1 = _weight_grads(x, h01, h1_seq, rh1, da1, (w1, b1, u1))
        g2 = _weight_grads(h1_seq, h02, h2_seq, rh2, da2, (w2, b2, u2))
        return dx, dh01, dh02, *g1, *g2, None


class _MultibranchTrain(torch.autograd.Function):
    """Forward: kernel U (multi-branch) with every h sequence as residual.
    Backward: kernel V from the final grads, then kernel W per layer and
    branch. ``apply(K, x, w1, b1, u1, w2, b2, u2, *(x_k, w_k, b_k, u_k) * K)``
    returns (layer 2's final h, each branch's final h)."""

    @staticmethod
    def forward(ctx, K, x, w1, b1, u1, w2, b2, u2, *flat):
        ctx.set_materialize_grads(True)
        branches = [(flat[4 * k], _params(*flat[4 * k + 1:4 * k + 4])) for k in range(K)]
        h1_seq, h2_seq, hk = gru_encoder_stack_fwd(x, None, None, _params(w1, b1, u1),
                                                   _params(w2, b2, u2), branches)
        ctx.save_for_backward(x, w1, b1, u1, w2, b2, u2, *flat, h1_seq, h2_seq, *hk)
        ctx.K = K
        return (h2_seq[-1].clone(), *(h[-1].clone() for h in hk))

    @staticmethod
    def backward(ctx, g2, *gk):
        K = ctx.K
        saved = ctx.saved_tensors
        x, w1, b1, u1, w2, b2, u2 = saved[:7]
        flat = saved[7:7 + 4 * K]
        h1_seq, h2_seq = saved[7 + 4 * K:9 + 4 * K]
        hk = saved[9 + 4 * K:]
        needs = ctx.needs_input_grad
        branches = [(flat[4 * k], hk[k], gk[k].contiguous(), _params(*flat[4 * k + 1:4 * k + 4]),
                     needs[8 + 4 * k]) for k in range(K)]
        dx, _, _, (da1, rh1), (da2, rh2), outs = gru_encoder_stack_bwd(
            x, h1_seq, h2_seq, None, None, None, g2.contiguous(), _params(w1, b1, u1),
            _params(w2, b2, u2), branches, need_dx=needs[1])
        grads = [*_weight_grads(x, None, h1_seq, rh1, da1, (w1, b1, u1)),
                 *_weight_grads(h1_seq, None, h2_seq, rh2, da2, (w2, b2, u2))]
        for k, (dxk, dak, rhk) in enumerate(outs):
            xk, wk, bk, uk = flat[4 * k:4 * k + 4]
            grads += [dxk.to(xk.dtype) if dxk is not None else None,
                      *_weight_grads(xk, None, hk[k], rhk, dak, (wk, bk, uk))]
        return None, dx, *grads


def stack2_use_kernels(x, activation) -> bool:
    """``_stack2_use_pallas`` but its VMEM estimate (the launch checks the
    card's limits instead): a tanh cell, float32, or bfloat16 with D >= 8."""
    return activation == "tanh" and (x.dtype == torch.float32 or x.shape[2] >= 8)


def multibranch_use_kernels(stack, branches, activation) -> bool:
    """``_encmb_use_pallas`` but its VMEM estimate: a tanh cell, float32,
    and no branch longer than the stack."""
    T = stack["x"].shape[0]
    return (activation == "tanh" and stack["x"].dtype == torch.float32
            and all(br["x"].shape[0] <= T for br in branches))


def gru_stack2_train_x(x, h01, h02, p1, p2, activation="tanh", return_sequences=False):
    """Two stacked GRU layers over x (T, B, D) time-major, from h01 and h02
    (B, H); ``p1``, ``p2`` are {"w", "b", "u"}. Returns layer 2's (T, B, H)
    sequence or its final h (B, H). Differentiable: kernels U, V and W on
    CUDA tensors, their plain versions on CPU tensors; the JAX reference
    where ``stack2_use_kernels`` says the JAX package takes it."""
    if not stack2_use_kernels(x, activation):
        return stack2_reference(x, h01, h02, p1, p2, activation, return_sequences)
    return _Stack2Train.apply(x, h01, h02, p1["w"], p1["b"], p1["u"], p2["w"], p2["b"], p2["u"],
                              return_sequences)


def gru_encode_multibranch_train(stack, branches, activation="tanh"):
    """The 2-layer stack {"x": (T, B, D), "p1", "p2"} and K 1-layer branches
    ({"x": (T_k, B, D_k), "p"}), every initial state zero. Returns (layer
    2's final h, (each branch's final h)), each (B, H). Differentiable:
    kernels U, V and W on CUDA tensors, their plain versions on CPU tensors;
    the JAX reference where ``multibranch_use_kernels`` says the JAX package
    takes it."""
    if not multibranch_use_kernels(stack, branches, activation):
        return multibranch_reference(stack, branches, activation)
    flat = [t for br in branches for t in (br["x"], br["p"]["w"], br["p"]["b"], br["p"]["u"])]
    p1, p2 = stack["p1"], stack["p2"]
    outs = _MultibranchTrain.apply(len(branches), stack["x"], p1["w"], p1["b"], p1["u"], p2["w"],
                                   p2["b"], p2["u"], *flat)
    return outs[0], tuple(outs[1:])
