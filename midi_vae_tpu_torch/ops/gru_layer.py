"""Kernel A: one whole GRU layer forward with the x-projection.

Counterpart of ``midi_vae_tpu/ops/fused_train.py::gru_layer_infer_x``, whose
Pallas kernels ``_fwdx_kernel`` (emits the h sequence) and
``_fwdx_last_kernel`` (emits the final h) the CUDA kernel
``csrc/gru_layer_fwd.cu`` replaces; its source note gives the design and
what bounds it. ``gru_layer_reference`` is the plain PyTorch version
(``_gru_layer_reference_x``): the CPU path and the kernel's oracle. On the
card A runs as two phases, each with its plain version and its launch
counts: the x @ W pre-pass (``gru_layer_xproj``: xp = x @ W + b in float32
on the tensor cores, kernel L's pre-pass, ``gru_xproj_reference``) and the
GRU forward chain over that xp on thread-block clusters
(``gru_layer_fwd_chain``, ``gru_fwd_chain_reference``; its plan
``gru_chain_plan``); where the chain does not launch,
``ops/_layout.py::gru_fwd_route`` picks A's first, per-block design
(``gru_layer_block``). Each phase counts its own launches (``A_PHASES``);
``gru_layer`` launches nothing itself.

``gru_layer`` takes the plain version only for CPU tensors; a CUDA tensor
launches the kernels or raises.

Training (``gru_layer_train_x``, counterpart of
``midi_vae_tpu/ops/fused_train.py::gru_layer_train_x``) is a
``torch.autograd.Function``: its forward is kernel A emitting the whole h
sequence (the backward's residual, also for layers that return only the
final h, as ``_glx_fwd`` does), its backward is kernel C
(``csrc/gru_layer_bwd.cu``, replacing ``_bwdx_kernel``) followed by kernel W
(``ops/grad_reduce.py``) for dW, db and dU. ``gru_cell_bwd_core`` and
``gru_layer_bwd_reference`` are the plain versions of the backward: the
CPU path and kernel C's oracle. The backward hard-codes tanh's derivative,
as the TPU kernels do (:2269). On the card C runs as three phases
(``csrc/gru_cell_bwd_chain.cuh``), each with its plain version and its
launch counts (``C_PHASES``): the gate pre-pass (``gru_layer_bwd_gates``,
``gru_bwd_gates_reference``: z, r, hh and r * h of every step from x and
hprev = [h0, seq[:-1]] on the tensor cores), the chain on thread-block
clusters (``gru_layer_bwd_chain``, ``gru_bwd_chain_reference``; its plan
``gru_bptt_plan``, ``ops/_layout.py``) and the dx pass
(``gru_layer_bwd_dx``, ``gru_bwd_dx_reference``); the chain's launch, one
a call of C, also counts on ``gru_layer_bwd``. Kernel E (``ops/gru_decode.py``) runs the same
pre-pass and cell stages.

The wide route (``ops/_layout.py``, H = 512) trains a layer over a
precomputed x-projection instead: ``gru_layer_train(xp, h0, u)``,
counterpart of ``midi_vae_tpu/ops/fused_train.py::gru_layer_train``, whose
forward is kernel F (``csrc/gru_layer_xp_fwd.cu``, replacing ``_fwd_kernel``
in ``_fwd_pallas`` and ``_fwd_wide_pallas``: A's float32 chain over the
given xp, ``gru_layer_xp_fwd_chain``, its plan ``xp_fwd_plan``, where the
slice of U streams its tensor-core instance over U packed by
``pack_tc_slices``; its first design ``gru_layer_xp_fwd_block`` the route of
the widths the chain refuses, ``_layout.gru_xp_fwd_route``) and whose
backward is kernel G
(``csrc/gru_layer_xp_bwd.cu``, replacing ``_bwd_kernel`` and
``_bwd_wide_kernel``) then kernel W for dU, as ``_gru_wide_weight_grads``
does in XLA. The caller computes xp = x @ W + b with torch.matmul, so dx, dW
and db come from autograd, as the JAX package leaves them to XLA (:2287).
Plain versions: ``gru_layer_xp_reference`` and ``gru_layer_xp_bwd_reference``.
On the card G runs as C's phases without the x segment and the dx pass
(``G_PHASES``): an xp gate pre-pass (``gru_layer_xp_bwd_gates``,
``gru_bwd_gates_xp_reference``: z, r, hh and r * h of every step from xp
and hprev on the tensor cores) and C's chain over those gates
(``gru_layer_xp_bwd_chain``, ``gru_bwd_chain_reference``; its plan
``xp_bwd_plan``: C's cost model among the fewest waves, ``G_chain``); where
C's chain does not launch
(``_layout.gru_xp_bwd_route``), G's first, per-block design
(``gru_layer_xp_bwd_block``). Each phase counts its own launches; the
chain's launch and the per-block route's, one a call of G, also count on
``gru_layer_xp_bwd``, never on C's counters.

In a bf16 model the wide route runs the JAX package's ``_fwd_kernel`` and
``_bwd_kernel`` in bf16 (GRU(512) at B = 256: ``_train_vmem_ok`` admits the
in-place pair in bf16, :220-237). The forward there is the whole-scan
encoder's function with the sequence emitted (``fused_decoder.py:288-318``:
products in float32, the carried h and the stored sequence rounded), so
``gru_layer_xp`` launches kernel X (``csrc/gru_encoder_scan.cu``,
``encoder_scan.gru_encoder_scan_fwd``, which counts it) over bf16 operands;
F has no bf16 build. The backward is G's bf16 build
(``mvt_gru_layer_xp_bwd_bf16``): the float32 transposition over the bf16
operands, emitting dxp and dh0 rounded to bf16 (:165, :186) and the same
gate grads unrounded, from which W sums dU in float32 as ``_bwd_kernel``
does (:166-167). ``_GruLayerTrain`` hands autograd the rounded dxp and W
the float32 gate grads; in float32 the two are one tensor. Where the JAX
package takes the batch-tiled rows 11 and 12 instead (a bf16 layer whose
in-place pair does not fit its VMEM, ``_train_vmem_ok``: B = 1024 at
H = 256, B >= 512 at H = 512), the forward and dxp are the same and dU is
summed from the stored bf16 stream (``_gru_wide_weight_grads``,
:1813-1835): ``gru_layer_train``'s ``mode`` "wide" hands W the rounded dxp.

A and C have a bfloat16 build beside the float32 one (``mvt_gru_layer_fwd_bf16``,
``mvt_gru_layer_bwd_bf16``), picked by the operands' dtype: a bf16 model
(``compute_dtype="bfloat16"``) trains its encoder layers through
``gru_layer_train_x`` in bf16, as the JAX package runs ``_fwdx_kernel`` and
``_bwdx_kernel`` there. A takes x @ W and h @ U as bf16 products summed in
float32, keeps r * h in float32 and rounds only the carried state and the
stored sequence to bf16. C takes the bf16 products exactly and runs the
whole transposition in float32 (the dh carry too; the chain's da @ U^T on
the tensor cores with da in three bf16 terms); dx and dh0 leave in bf16, the gate grads and r * h in float32,
and W sums the weight grads in float32 (its bf16 build reads the bf16
activations); the layer's
weight grads are rounded to the params' dtype at the end, as ``_glx_bwd``
casts them. The velocity layer (D < 8) is the JAX package's ``cast_x`` case:
there x and W enter the products widened to float32, which gives the same
products as the bf16 build's widening loads, so it takes the same build.
The plain versions compute the same way, so the CPU path is this explicit
float32 transposition, not autograd through a bf16 forward. Launches are
counted per build: ``.launches`` (float32) and ``.launches_bf16``.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from . import _build, _layout
from .grad_reduce import gru_u_grad, gru_weight_grads

# cell activations the kernels implement, with their codes in gru_common.cuh
CELL_ACTIVATIONS = {"tanh": 0, "sigmoid": 1, "relu": 2}
_PLAIN_ACTIVATIONS = {"tanh": torch.tanh, "sigmoid": torch.sigmoid, "relu": torch.relu}


def cell_activation(name: str):
    try:
        return _PLAIN_ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unsupported GRU kernel activation {name!r}") from None


def gru_step(x, h, w, u, b, act, dtype=None):
    """One reset-before GRU step: (B, D), (B, H) -> (B, H); x @ W + b in
    float32, as ``gru_step_xp`` computes the rest."""
    return gru_step_xp(x.float() @ w.float() + b.float(), h, u, act, dtype)


def gru_step_xp(xp, h, u, act, dtype=None):
    """One reset-before GRU step over its x-projection xp = x @ W + b
    (B, 3H): (B, H) -> (B, H). The products and the gate math run in
    float32 (r * h too) and h' is rounded once to ``dtype`` (h's by
    default), as the Pallas kernels do in a bfloat16 model
    (``preferred_element_type=float32``, then ``astype``:
    ``fused_gru.py:54-82``, ``fused_decoder.py:300-311``); in float32 the
    casts are no-ops."""
    H = h.shape[-1]
    xp, hf, u = xp.float(), h.float(), u.float()
    hu_zr = hf @ u[:, : 2 * H]
    z = torch.sigmoid(xp[:, :H] + hu_zr[:, :H])
    r = torch.sigmoid(xp[:, H : 2 * H] + hu_zr[:, H:])
    hh = act(xp[:, 2 * H :] + (r * hf) @ u[:, 2 * H :])
    return (z * hf + (1.0 - z) * hh).to(h.dtype if dtype is None else dtype)


def gru_layer_reference(x, h0, w, b, u, activation="tanh", return_sequences=False):
    """Plain version: x (T, B, D) -> (T, B, H) sequence or final h (B, H),
    in h0's dtype; x @ W + b in float32 (``_fwdx_kernel``)."""
    T, B, D = x.shape
    xp = (x.reshape(T * B, D).float() @ w.float() + b.float()).reshape(T, B, -1)
    return _scan_xp(xp, h0, u, cell_activation(activation), return_sequences)


def _scan_xp(xp, h0, u, act, return_sequences):
    """The GRU recurrence over a precomputed x-projection xp (T, B, 3H)
    (``_encoder_scan_reference``)."""
    h = h0
    seq = []
    for t in range(xp.shape[0]):
        h = gru_step_xp(xp[t], h, u, act)
        if return_sequences:
            seq.append(h)
    return torch.stack(seq) if return_sequences else h


def check_operands(named: dict, device: torch.device,
                   dtypes: tuple = (torch.float32,)) -> torch.dtype:
    """Device, dtype and contiguity checks shared by the kernel wrappers:
    every operand on ``device``, contiguous, and of one dtype among
    ``dtypes`` (those the kernel has builds for). Returns that dtype."""
    dtype = next(iter(named.values())).dtype
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype not in dtypes or t.dtype != dtype:
            names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes {names}, every "
                             "operand alike")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dtype


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


_BF16 = torch.bfloat16


def gru_xproj_reference(x, w, b):
    """Plain version of A's pre-pass: xp (T, B, 3H) = x (T, B, D) @ W + b in
    float32, every operand widened (in bf16 the products of bf16 values
    summed in float32, ``_fwdx_kernel`` :2071; D < 8 is its cast_x case, the
    same products)."""
    T, B, D = x.shape
    return (x.reshape(T * B, D).float() @ w.float() + b.float()).reshape(T, B, -1)


def gru_fwd_chain_reference(xp, h0, u, activation="tanh", return_sequences=False):
    """Plain version of A's chain over a float32 xp (T, B, 3H): the h
    sequence or the final h in h0's dtype (``_fwdx_kernel``'s recurrence: xp
    enters the gates unrounded, r * h in float32, h rounded once a step)."""
    return _scan_xp(xp, h0, u, cell_activation(activation), return_sequences)


@functools.cache
def _kernel():
    """(library, {"block" | "xproj" | "chain": {dtype: entry}}) of kernel A."""
    lib, block = _build.load_builds("gru_layer_fwd", "mvt_gru_layer_fwd",
                                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                                    + [ctypes.c_void_p])
    xproj = _build.load_builds("gru_layer_fwd", "mvt_gru_layer_xproj",
                               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])[1]
    chain = _build.load_builds("gru_layer_fwd", "mvt_gru_layer_fwd_chain",
                               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])[1]
    return lib, {"block": block, "xproj": xproj, "chain": chain}


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


@functools.cache
def _max_clusters(lib_name, bf16, cluster, stream=None):
    """The card's cudaOccupancyMaxActiveClusters of the chain in library
    ``lib_name`` (A's forward chain; N's and R's backward chains, Q's and
    Y's forward chain, whose entries also take ``stream``, the streamed
    instance; C's and E's chains, one instance a dtype; one CTA an SM) at
    ``cluster`` CTAs a cluster."""
    flags = [int(bf16), cluster] + ([] if stream is None else [int(stream)])
    lib, fn = _build.load_entry(lib_name, f"mvt_{lib_name}_max_clusters",
                                [ctypes.c_int] * len(flags) + [ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    _build.check(lib, fn(*flags, ctypes.byref(out)), f"{lib_name} cudaOccupancyMaxActiveClusters")
    return out.value


@functools.cache
def gru_chain_plan(build, H, B):
    """A's chain plan (``_layout.gru_fwd_plan``) of build ``build``
    (``_layout.GRU_FWD_BUILDS``) at (H, B), at the card's active clusters;
    raises LaunchLimitError where it does not launch."""
    C, stream = _layout.gru_fwd_cluster(build, H)
    return _layout.gru_fwd_plan(build, H, B, _max_clusters(
        "gru_layer_fwd", build.endswith("_bf16"), C, stream))


def _check_layer(x, h0, w, b, u, activation, what):
    """Shapes of kernel A's operands and, on the card, their device, dtype
    and contiguity. Returns (T, B, D, H, dtype or None off the card)."""
    if activation not in CELL_ACTIVATIONS:
        raise ValueError(f"unsupported GRU kernel activation {activation!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be (T, B, D), got {tuple(x.shape)}")
    T, B, D = x.shape
    H = u.shape[0]
    expected = {"h0": (B, H), "w": (D, 3 * H), "b": (3 * H,), "u": (H, 3 * H)}
    for name, t in (("h0", h0), ("w", w), ("b", b), ("u", u)):
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expected[name]}")
    if x.device.type == "cpu":
        return T, B, D, H, None
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {x.device}")
    dtype = check_operands({"x": x, "h0": h0, "w": w, "b": b, "u": u}, x.device, _build.DTYPES)
    if T < 1 or B < 1:
        raise ValueError(f"kernel A takes T >= 1 and B >= 1; got T={T} B={B}")
    return T, B, D, H, dtype


def gru_layer_xproj(x, w, b):
    """Kernel A's pre-pass: ``gru_xproj_reference``, xp (T, B, 3H) float32.
    CPU tensors run the plain version; CUDA tensors (every operand float32
    or every one bfloat16) launch its build of their dtype."""
    if x.dim() != 3:
        raise ValueError(f"x must be (T, B, D), got {tuple(x.shape)}")
    T, B, D = x.shape
    G = w.shape[-1]
    for name, t, shape in (("w", w, (D, G)), ("b", b, (G,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if x.device.type == "cpu":
        return gru_xproj_reference(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"gru_layer_xproj runs on cpu or cuda tensors, not {x.device}")
    dtype = check_operands({"x": x, "w": w, "b": b}, x.device, _build.DTYPES)
    xp = torch.empty(T, B, G, device=x.device, dtype=torch.float32)
    lib, fns = _kernel()
    rc = fns["xproj"][dtype](_ptr(x), _ptr(w), _ptr(b), _ptr(xp), T * B, D, G, _stream(x))
    _build.check(lib, rc, "gru_layer_fwd pre-pass launch")
    _build.count_launch(gru_layer_xproj, dtype)
    return xp


def gru_layer_fwd_chain(xp, h0, u, activation="tanh", return_sequences=False):
    """Kernel A's chain over a float32 xp (T, B, 3H), h0 and U float32 or
    both bfloat16: ``gru_fwd_chain_reference``. CPU tensors run the plain
    version; CUDA tensors launch its build of h0's dtype on clusters
    (``gru_chain_plan``)."""
    if activation not in CELL_ACTIVATIONS:
        raise ValueError(f"unsupported GRU kernel activation {activation!r}")
    if xp.dim() != 3:
        raise ValueError(f"xp must be (T, B, 3H), got {tuple(xp.shape)}")
    T, B = xp.shape[:2]
    H = u.shape[0]
    for name, t, shape in (("xp", xp, (T, B, 3 * H)), ("h0", h0, (B, H)), ("u", u, (H, 3 * H))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if xp.device.type == "cpu":
        return gru_fwd_chain_reference(xp, h0, u, activation, return_sequences)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_layer_fwd_chain runs on cpu or cuda tensors, not {xp.device}")
    dtype = check_operands({"h0": h0, "u": u}, xp.device, _build.DTYPES)
    check_operands({"xp": xp}, xp.device, (torch.float32,))
    if T < 1 or B < 1:
        raise ValueError(f"kernel A takes T >= 1 and B >= 1; got T={T} B={B}")
    plan = gru_chain_plan("A_chain_bf16" if dtype == _BF16 else "A_chain", H, B)
    out = torch.empty((T, B, H) if return_sequences else (B, H), device=xp.device, dtype=dtype)
    null = ctypes.c_void_p(None)
    lib, fns = _kernel()
    rc = fns["chain"][dtype](
        _ptr(xp), _ptr(h0), _ptr(u), _ptr(out) if return_sequences else null,
        null if return_sequences else _ptr(out), T, B, H, CELL_ACTIVATIONS[activation],
        plan.cluster, plan.rows, plan.splits, plan.stages, _stream(xp))
    _build.check(lib, rc, "gru_layer_fwd chain launch")
    _build.count_launch(gru_layer_fwd_chain, dtype)
    return out


def gru_layer_block(x, h0, w, b, u, activation="tanh", return_sequences=False):
    """Kernel A's per-block route (its first design), as ``gru_layer``: CPU
    tensors run ``gru_layer_reference``; CUDA tensors launch its build of
    their dtype where ``_layout`` lets it launch."""
    T, B, D, H, dtype = _check_layer(x, h0, w, b, u, activation, "gru_layer_block")
    if dtype is None:
        return gru_layer_reference(x, h0, w, b, u, activation, return_sequences)
    build = "A_bf16" if dtype == _BF16 else "A"
    _layout.require(build, H, _layout.smem_bytes(build, H, D))
    out = torch.empty((T, B, H) if return_sequences else (B, H), device=x.device, dtype=dtype)
    lib, fns = _kernel()
    rc = fns["block"][dtype](
        _ptr(x), _ptr(h0), _ptr(w), _ptr(b), _ptr(u), _ptr(out),
        T, B, D, H, CELL_ACTIVATIONS[activation], int(return_sequences), _stream(x),
    )
    _build.check(lib, rc, "gru_layer_fwd launch")
    _build.count_launch(gru_layer_block, dtype)
    return out


def gru_layer(x, h0, w, b, u, activation="tanh", return_sequences=False):
    """GRU layer forward, x (T, B, D) time-major, every operand float32 or
    every one bfloat16.

    Returns the (T, B, H) h sequence when ``return_sequences`` else the final
    h (B, H), in the operands' dtype. The call goes through the registered
    operator ``mvt::gru_layer`` (``ops/_custom.py``) on either device, so an
    exported program runs the same operator: CPU tensors run
    ``gru_layer_reference``; CUDA tensors run ``gru_layer_cuda``."""
    return torch.ops.mvt.gru_layer(x, h0, w, b, u, activation, return_sequences)


def gru_layer_cpu(x, h0, w, b, u, activation, return_sequences):
    """``mvt::gru_layer``'s CPU implementation: the plain version."""
    _check_layer(x, h0, w, b, u, activation, "gru_layer")
    return gru_layer_reference(x, h0, w, b, u, activation, return_sequences)


def gru_layer_cuda(x, h0, w, b, u, activation, return_sequences):
    """``mvt::gru_layer``'s CUDA implementation: kernel A's build of the
    operands' dtype on the route ``_layout.gru_fwd_route`` picks, the
    pre-pass and the chain, or the per-block route (``gru_layer_block``).
    Each of those wrappers counts its own launches (``A_PHASES``); this one
    launches nothing itself."""
    T, B, D, H, dtype = _check_layer(x, h0, w, b, u, activation, "gru_layer")
    if dtype is None:
        raise ValueError(f"gru_layer: x is on {x.device}, the other operands on the card")
    if _layout.gru_fwd_route(H, D, dtype == _BF16) == "block":
        return gru_layer_block(x, h0, w, b, u, activation, return_sequences)
    gru_chain_plan("A_chain_bf16" if dtype == _BF16 else "A_chain", H, B)  # raises first
    return gru_layer_fwd_chain(gru_layer_xproj(x, w, b), h0, u, activation, return_sequences)


def gru_layer_fake(x, h0, w, b, u, activation, return_sequences):
    """``mvt::gru_layer``'s fake implementation: the output's shape and
    dtype, after the shape checks (and on the card the device, dtype and
    contiguity checks) of the real ones."""
    T, B, _, H, _ = _check_layer(x, h0, w, b, u, activation, "gru_layer")
    return h0.new_empty((T, B, H) if return_sequences else (B, H))


# the wrappers that launch A's kernels, each counting on ``.launches`` and
# ``.launches_bf16``
A_PHASES = ("gru_layer_xproj", "gru_layer_fwd_chain", "gru_layer_block")
for _fn in (gru_layer_xproj, gru_layer_fwd_chain, gru_layer_block):
    _fn.launches = _fn.launches_bf16 = 0


# ---------------------------------------------------------------------------
# Training: the backward (kernel C + kernel W) and the autograd Function
# ---------------------------------------------------------------------------

def gru_cell_bwd_core(x, hp, w, u, b, dh):
    """Backward through one GRU step with a tanh candidate, given x_t, h_{t-1}
    and dL/dh_t (``_gru_cell_bwd_core``). Returns (dx, dh_prev, da_cat, rh):
    da_cat = [da_z, da_r, da] are the pre-activation gate grads the weight
    grads reduce over, rh = r * h_{t-1}."""
    da_cat, dhp, rh = gru_cell_bwd_xp(x @ w + b, hp, u, dh)
    return da_cat @ w.t(), dhp, da_cat, rh


def gru_cell_bwd_xp(xp, hp, u, dh):
    """``gru_cell_bwd_core`` from the step's x-projection xp = x_t @ W + b:
    returns (da_cat, dh_prev, rh); da_cat is dL/dxp."""
    H = hp.shape[-1]
    hu = hp @ u[:, : 2 * H]
    z = torch.sigmoid(xp[:, :H] + hu[:, :H])
    r = torch.sigmoid(xp[:, H : 2 * H] + hu[:, H:])
    rh = r * hp
    hh = torch.tanh(xp[:, 2 * H :] + rh @ u[:, 2 * H :])
    dz = dh * (hp - hh)
    da = dh * (1.0 - z) * (1.0 - hh * hh)
    drh = da @ u[:, 2 * H :].t()
    da_zr = torch.cat([dz * z * (1.0 - z), drh * hp * r * (1.0 - r)], dim=-1)
    da_cat = torch.cat([da_zr, da], dim=-1)
    dhp = dh * z + drh * r + da_zr @ u[:, : 2 * H].t()
    return da_cat, dhp, rh


def gru_layer_bwd_reference(x, seq, h0, d_seq, d_final, w, b, u, need_dx=True):
    """Plain version of kernel C: reverse-time BPTT of one layer over the
    forward's h sequence ``seq`` (T, B, H). ``d_seq`` (T, B, H) and
    ``d_final`` (B, H) are the incoming grads (either may be None). Returns
    (dx or None, dh0, da_cat (T, B, 3H), rh (T, B, H)). Every operand is
    widened to float32 and the transposition runs in float32, the dh carry
    too; dx and dh0 leave in x's dtype, da_cat and rh in float32
    (``_bwdx_kernel``: a no-op in a float32 layer)."""
    dtype = x.dtype
    x, seq, h0, w, b, u = (t.float() for t in (x, seq, h0, w, b, u))
    T = x.shape[0]
    dh = d_final.float() if d_final is not None else torch.zeros_like(h0)
    dx, da, rh = [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        if d_seq is not None:
            dh = dh + d_seq[t].float()
        hp = seq[t - 1] if t > 0 else h0
        dx[t], dh, da[t], rh[t] = gru_cell_bwd_core(x[t], hp, w, u, b, dh)
    return ((torch.stack(dx).to(dtype) if need_dx else None), dh.to(dtype), torch.stack(da),
            torch.stack(rh))


# ---------------------------------------------------------------------------
# C's phases (csrc/gru_cell_bwd_chain.cuh): the gate pre-pass, the chain over
# its gates on thread-block clusters, the dx pass; each has its plain version
# and its launch counts (``.launches``, ``.launches_bf16``). E runs the same
# pre-pass and cell stages (ops/gru_decode.py).
# ---------------------------------------------------------------------------

def _widened(*ts):
    """Each tensor (None stays None) widened to float32: a no-op in a
    float32 layer."""
    return tuple(t.float() if t is not None else None for t in ts)


def gru_bwd_gates_reference(x, hprev, w, b, u):
    """Plain version of the gate pre-pass: (gates (T, B, 3H) = [z, r, hh],
    rh (T, B, H) = r * h_{t-1}), both float32, from x (T, B, D), hprev =
    [h0, hseq[:-1]] (T, B, H) and the weights, every operand widened to
    float32 (``_bwdx_kernel`` :2154-2159: in bf16 the products of bf16
    values summed in float32, r * h in float32)."""
    T, B, D = x.shape
    x, w, b = _widened(x, w, b)
    return gru_bwd_gates_xp_reference((x.reshape(T * B, D) @ w + b).reshape(T, B, -1), hprev, u)


def gru_bwd_cell_reference(gates, hp, u, dh):
    """One reverse step from the pre-pass's gates (B, 3H), h_{t-1} and
    dL/dh_t (float32): (da_cat (B, 3H), dL/dh_{t-1}), as ``gru_cell_bwd_xp``
    (``_bwdx_kernel`` :2166-2182)."""
    H = hp.shape[-1]
    z, r, hh = gates[:, :H], gates[:, H : 2 * H], gates[:, 2 * H :]
    da = dh * (1.0 - z) * (1.0 - hh * hh)
    drh = da @ u[:, 2 * H :].t()
    da_zr = torch.cat([dh * (hp - hh) * z * (1.0 - z), drh * hp * r * (1.0 - r)], dim=-1)
    return torch.cat([da_zr, da], dim=-1), dh * z + drh * r + da_zr @ u[:, : 2 * H].t()


def gru_bwd_chain_reference(gates, hprev, d_seq, d_final, u):
    """Plain version of C's chain: the reverse loop over the pre-pass's
    gates (T, B, 3H). Returns (da_cat (T, B, 3H), dh0), float32, every
    operand widened: da @ U^T takes the float32 da."""
    hprev, d_seq, d_final, u = _widened(hprev, d_seq, d_final, u)
    T = gates.shape[0]
    dh = d_final if d_final is not None else torch.zeros_like(hprev[0])
    da = [None] * T
    for t in reversed(range(T)):
        if d_seq is not None:
            dh = dh + d_seq[t]
        da[t], dh = gru_bwd_cell_reference(gates[t], hprev[t], u, dh)
    return torch.stack(da), dh


def gru_bwd_dx_reference(da, w):
    """Plain version of C's dx pass: da (T, B, 3H) float32 @ W^T with W
    widened, rounded once to W's dtype."""
    return (da @ w.float().t()).to(w.dtype)


@functools.cache
def _bwd_phases(lib_name="gru_layer_bwd"):
    """(library, {"gates" | "chain" | "dx": {dtype: entry}}) of kernel C's
    library, or the gates of E's ("gru_decode_bwd")."""
    entry = f"mvt_{lib_name}"
    lib, gates = _build.load_builds(lib_name, f"{entry}_gates", [ctypes.c_void_p] * 7
                                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fns = {"gates": gates}
    if lib_name == "gru_layer_bwd":
        fns["chain"] = _build.load_builds(lib_name, f"{entry}_chain", [ctypes.c_void_p] * 7
                                          + [ctypes.c_int] * 7 + [ctypes.c_void_p])[1]
        fns["dx"] = _build.load_builds(lib_name, f"{entry}_dx", [ctypes.c_void_p] * 3
                                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])[1]
    return lib, fns


@functools.cache
def gru_bptt_plan(build, H, B, heads=((61, 2),)):
    """The chain's plan (``_layout.gru_bptt_plan``) of build ``build``
    (``_layout.GRU_BPTT_BUILDS``) at (H, B) (E: its heads), at the card's
    active clusters; raises LaunchLimitError where it does not launch."""
    lib = "gru_layer_bwd" if build.startswith("C") else "gru_decode_bwd"
    bf16 = build.endswith("_bf16")
    return _layout.gru_bptt_plan(build, H, B, heads,
                                 lambda C: _max_clusters(lib, bf16, C))


def _check_bwd_phase(what, named, expected, floats=()):
    """Shapes, and on the card device, dtype and contiguity (``floats``:
    the float32 scratch among them); True on the card."""
    for name, t in named.items():
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expected[name]}")
    first = next(iter(named.values()))
    if first.device.type == "cpu":
        return False
    if first.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {first.device}")
    check_operands({k: v for k, v in named.items() if k not in floats}, first.device,
                   _build.DTYPES)
    for k in floats:
        if k in named:
            check_operands({k: named[k]}, first.device, (torch.float32,))
    return True


def bwd_gates(lib_name, fn, x, hprev, w, b, u):
    """The pre-pass of C's library or E's on the card: (gates, rh) float32;
    counts its two launches (P1, P2) on ``fn``."""
    T, B, D = x.shape
    H = u.shape[0]
    kw = {"device": x.device, "dtype": torch.float32}
    gates, rh = torch.empty(T, B, 3 * H, **kw), torch.empty(T, B, H, **kw)
    lib, fns = _bwd_phases(lib_name)
    rc = fns["gates"][x.dtype](_ptr(x), _ptr(w), _ptr(b), _ptr(hprev), _ptr(u), _ptr(gates),
                               _ptr(rh), T * B, D, H, _stream(x))
    _build.check(lib, rc, f"{lib_name} gates launch")
    _build.count_launch(fn, x.dtype, 2)
    return gates, rh


def _gates_expected(T, B, D, H):
    return {"x": (T, B, D), "hprev": (T, B, H), "w": (D, 3 * H), "b": (3 * H,),
            "u": (H, 3 * H)}


def gru_layer_bwd_gates(x, hprev, w, b, u):
    """Kernel C's gate pre-pass: ``gru_bwd_gates_reference``. CPU tensors run
    the plain version; CUDA tensors (every operand float32 or every one
    bfloat16) launch its build of their dtype."""
    T, B, D = x.shape
    H = u.shape[0]
    if not _check_bwd_phase("gru_layer_bwd_gates", {"x": x, "hprev": hprev, "w": w, "b": b,
                                                    "u": u}, _gates_expected(T, B, D, H)):
        return gru_bwd_gates_reference(x, hprev, w, b, u)
    return bwd_gates("gru_layer_bwd", gru_layer_bwd_gates, x, hprev, w, b, u)


def gru_layer_bwd_chain(gates, hprev, d_seq, d_final, u, ut=None):
    """Kernel C's chain over the pre-pass's gates: (da_cat float32, dh0 in
    hprev's dtype). CPU tensors run ``gru_bwd_chain_reference`` (dh0
    rounded to hprev's dtype); CUDA tensors launch its build of hprev's
    dtype on clusters (``gru_bptt_plan``), counted on this wrapper and, as
    one call of C, on ``gru_layer_bwd``; ``ut`` is U^T where the caller has
    it."""
    T, B, H = hprev.shape
    named = {"gates": gates, "hprev": hprev, "u": u}
    expected = {"gates": (T, B, 3 * H), "hprev": (T, B, H), "u": (H, 3 * H),
                "d_seq": (T, B, H), "d_final": (B, H)}
    for k, v in (("d_seq", d_seq), ("d_final", d_final)):
        if v is not None:
            named[k] = v
    if not _check_bwd_phase("gru_layer_bwd_chain", named, expected, ("gates",)):
        da, dh0 = gru_bwd_chain_reference(gates, hprev, d_seq, d_final, u)
        return da, dh0.to(hprev.dtype)
    dtype = hprev.dtype
    plan = gru_bptt_plan("C_chain_bf16" if dtype == _BF16 else "C_chain", H, B, None)
    da = torch.empty(T, B, 3 * H, device=hprev.device, dtype=torch.float32)
    dh0 = torch.empty(B, H, device=hprev.device, dtype=dtype)
    ut = u.t().contiguous() if ut is None else ut  # the CTAs copy their rows of U^T
    null = ctypes.c_void_p(None)
    opt = lambda t: _ptr(t) if t is not None else null  # noqa: E731
    lib, fns = _bwd_phases()
    rc = fns["chain"][dtype](_ptr(gates), _ptr(hprev), opt(d_seq), opt(d_final), _ptr(ut),
                             _ptr(da), _ptr(dh0), T, B, H, plan.cluster, plan.rows[0],
                             plan.nbuf, plan.stages, _stream(hprev))
    _build.check(lib, rc, "gru_layer_bwd chain launch")
    _build.count_launch(gru_layer_bwd_chain, dtype)
    _build.count_launch(gru_layer_bwd, dtype)
    return da, dh0


def gru_layer_bwd_dx(da, w):
    """Kernel C's dx pass: ``gru_bwd_dx_reference``. CPU tensors run the
    plain version; CUDA tensors launch its build of W's dtype."""
    T, B, G = da.shape
    D = w.shape[0]
    if not _check_bwd_phase("gru_layer_bwd_dx", {"da": da, "w": w},
                            {"da": (T, B, G), "w": (D, G)}, ("da",)):
        return gru_bwd_dx_reference(da, w)
    dx = torch.empty(T, B, D, device=da.device, dtype=w.dtype)
    wt = w.t().contiguous()  # (3H, D): the product's B operand row by row
    lib, fns = _bwd_phases()
    rc = fns["dx"][w.dtype](_ptr(da), _ptr(wt), _ptr(dx), T * B, D, G // 3, _stream(da))
    _build.check(lib, rc, "gru_layer_bwd dx launch")
    _build.count_launch(gru_layer_bwd_dx, w.dtype)
    return dx


# the wrappers that launch C's phases, each counting its launches on
# ``.launches`` and ``.launches_bf16`` (the pre-pass two a call: P1, P2)
C_PHASES = ("gru_layer_bwd_gates", "gru_layer_bwd_chain", "gru_layer_bwd_dx")
for _fn in (gru_layer_bwd_gates, gru_layer_bwd_chain, gru_layer_bwd_dx):
    _fn.launches = _fn.launches_bf16 = 0


def gru_layer_bwd(x, seq, h0, d_seq, d_final, w, b, u, need_dx=True):
    """Backward of one GRU layer (tanh): see ``gru_layer_bwd_reference``.
    CPU tensors run the plain version; CUDA tensors (every operand float32
    or every one bfloat16) run kernel C's build of their dtype: its gate
    pre-pass, its chain and, with ``need_dx``, its dx pass. It launches
    nothing itself: each phase counts its launches on its own wrapper, and
    the chain's launch, one a call, also on ``.launches`` or
    ``.launches_bf16`` here."""
    T, B, D = x.shape
    H = u.shape[0]
    named = {"x": x, "seq": seq, "h0": h0, "w": w, "b": b, "u": u}
    expected = {"x": (T, B, D), "seq": (T, B, H), "h0": (B, H), "w": (D, 3 * H),
                "b": (3 * H,), "u": (H, 3 * H)}
    if d_seq is not None:
        named["d_seq"], expected["d_seq"] = d_seq, (T, B, H)
    if d_final is not None:
        named["d_final"], expected["d_final"] = d_final, (B, H)
    for name, t in named.items():
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expected[name]}")
    if x.device.type == "cpu":
        return gru_layer_bwd_reference(x, seq, h0, d_seq, d_final, w, b, u, need_dx)
    if x.device.type != "cuda":
        raise ValueError(f"gru_layer_bwd runs on cpu or cuda tensors, not {x.device}")
    dtype = check_operands(named, x.device, _build.DTYPES)
    if T < 1 or B < 1:
        raise ValueError(f"kernel C takes T >= 1 and B >= 1; got T={T} B={B}")
    gru_bptt_plan("C_chain_bf16" if dtype == _BF16 else "C_chain", H, B, None)  # raises first
    hprev = torch.cat([h0[None], seq[:-1]])
    gates, rh = gru_layer_bwd_gates(x, hprev, w, b, u)
    da_cat, dh0 = gru_layer_bwd_chain(gates, hprev, d_seq, d_final, u)
    dx = gru_layer_bwd_dx(da_cat, w) if need_dx else None
    return dx, dh0, da_cat, rh


gru_layer_bwd.launches = 0
gru_layer_bwd.launches_bf16 = 0


class _GruLayerTrainX(torch.autograd.Function):
    """Forward: kernel A with the h sequence as residual. Backward: kernel C
    for dx, dh0 and the gate grads, then kernel W for dW, db, dU (float32
    sums, rounded to the params' dtype)."""

    @staticmethod
    def forward(ctx, x, h0, w, b, u, return_sequences):
        ctx.set_materialize_grads(True)
        seq = gru_layer(x, h0, w, b, u, "tanh", True)
        ctx.save_for_backward(x, h0, w, b, u, seq)
        ctx.return_sequences = return_sequences
        return seq if return_sequences else seq[-1].clone()

    @staticmethod
    def backward(ctx, g):
        x, h0, w, b, u, seq = ctx.saved_tensors
        g = g.contiguous()
        d_seq, d_final = (g, None) if ctx.return_sequences else (None, g)
        dx, dh0, da_cat, rh = gru_layer_bwd(x, seq, h0, d_seq, d_final, w, b, u,
                                            need_dx=ctx.needs_input_grad[0])
        hprev = torch.cat([h0[None], seq[:-1]])
        dw, db, du = gru_weight_grads(x, hprev, rh, da_cat)
        return dx, dh0, dw.to(w.dtype), db.to(b.dtype), du.to(u.dtype), None


def gru_layer_train_x(x, h0, w, b, u, return_sequences=False):
    """Differentiable GRU layer (tanh) over x (T, B, D) time-major, float32
    or bfloat16: the (T, B, H) sequence or the final h (B, H). CPU tensors
    run the plain versions of kernels A, C and W; CUDA tensors launch the
    builds of their dtype."""
    return _GruLayerTrainX.apply(x, h0, w, b, u, return_sequences)


# ---------------------------------------------------------------------------
# The wide route: the layer over a precomputed x-projection (kernels F, G, W)
# ---------------------------------------------------------------------------

def gru_layer_xp_reference(xp, h0, u):
    """Plain version of kernel F: the tanh GRU layer over xp (T, B, 3H),
    returning the (T, B, H) h sequence."""
    return _scan_xp(xp, h0, u, torch.tanh, True)


def _check_xp(xp, h0, u, seq=None, d_seq=None, d_final=None) -> tuple[int, int, int]:
    """Shapes of the operands of kernels F and G (the optional ones may be
    None) and, on the card, their device, dtype and contiguity. Returns
    (T, B, H)."""
    if xp.dim() != 3:
        raise ValueError(f"xp must be (T, B, 3H), got {tuple(xp.shape)}")
    T, B = xp.shape[:2]
    H = u.shape[0]
    named = {"xp": (xp, (T, B, 3 * H)), "h0": (h0, (B, H)), "u": (u, (H, 3 * H)),
             "seq": (seq, (T, B, H)), "d_seq": (d_seq, (T, B, H)), "d_final": (d_final, (B, H))}
    named = {k: v for k, v in named.items() if v[0] is not None}
    for name, (t, shape) in named.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the GRU layer kernels run on cpu or cuda tensors, not {xp.device}")
    if xp.device.type == "cuda":
        check_operands({k: t for k, (t, _) in named.items()}, xp.device, _build.DTYPES)
        if T < 1 or B < 1:
            raise ValueError(f"kernels F and G take T >= 1 and B >= 1; got T={T} B={B}")
    return T, B, H


@functools.cache
def _xp_fwd_kernel():
    """(library, {"chain" | "tc" | "block": entry}) of kernel F."""
    lib, chain = _build.load_entry("gru_layer_xp_fwd", "mvt_gru_layer_xp_fwd",
                                   [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    tc = _build.load_entry("gru_layer_xp_fwd", "mvt_gru_layer_xp_fwd_tc",
                           [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])[1]
    block = _build.load_entry("gru_layer_xp_fwd", "mvt_gru_layer_xp_fwd_block",
                              [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])[1]
    return lib, {"chain": chain, "tc": tc, "block": block}


@functools.cache
def _tc_max_clusters(cluster):
    """The card's cudaOccupancyMaxActiveClusters of F's tensor-core
    instance at ``cluster`` CTAs a cluster."""
    lib, fn = _build.load_entry("gru_layer_xp_fwd", "mvt_gru_layer_xp_fwd_tc_max_clusters",
                                [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    _build.check(lib, fn(cluster, ctypes.byref(out)), "gru_layer_xp_fwd cudaOccupancyMaxActiveClusters")
    return out.value


@functools.cache
def xp_fwd_plan(H, B):
    """F's chain plan at (H, B), at the card's active clusters of the
    instance it runs: where the slice of U streams (``_layout.
    gru_fwd_cluster``), the tensor-core instance's (``_layout.gru_tc_plan``,
    ``chunk`` > 0; it ran faster than A's streamed instance at every F shape
    on the H100, PERF.md, Findings), else A's resident float32
    instance's (``_layout.gru_fwd_plan("F_chain", ...)``, also A's streamed
    one where the tensor-core instance has no plan); raises
    LaunchLimitError where none launches."""
    C, stream = _layout.gru_fwd_cluster("F_chain", H)
    if stream:
        plan = _layout.gru_tc_plan(H, B, _tc_max_clusters)
        if plan is not None:
            return plan
    return _layout.gru_fwd_plan("F_chain", H, B, _max_clusters("gru_layer_xp_fwd", stream, C))


def pack_tc_slices(u, cluster):
    """U (H, 3H) as F's tensor-core instance reads it
    (``csrc/gru_cell_fwd.cuh``, ``GruFwdTcArgs``): per CTA c of the cluster
    its P1 slice (H, 2 Hc: the z and r columns of units [c Hc, (c+1) Hc))
    and its P2 slice (H, Hc: their candidate columns), each in B-fragment
    order (H / 8, columns / 8, 8, 4, 2): entry (k, n, g, t, j) is depth row
    8 k + 4 j + t of column 8 n + g. Returns (pzr, ph), contiguous."""
    H = u.shape[0]
    Hc = H // cluster
    by_cta = u.reshape(H, 3, cluster, Hc).permute(2, 0, 1, 3)  # (C, H, 3, Hc)

    def frag(x):  # (C, H, W) -> (C, H / 8, W / 8, 8, 4, 2)
        W = x.shape[-1]
        return x.reshape(cluster, H // 8, 2, 4, W // 8, 8).permute(0, 1, 4, 5, 3, 2).contiguous()

    return frag(by_cta[:, :, :2].reshape(cluster, H, 2 * Hc)), frag(by_cta[:, :, 2])


# pack_tc_slices' outputs of recent weights: (a weak reference to U, its
# version counter, the packed pair) by (id, cluster size)
_TC_PACKED: dict = {}


def _tc_slices(u, cluster):
    """``pack_tc_slices``, kept while U is the same tensor and unchanged
    (its version counter: an optimizer's in-place update repacks)."""
    try:
        version = u._version
    except RuntimeError:  # an inference tensor
        return pack_tc_slices(u, cluster)
    key = (id(u), cluster)
    hit = _TC_PACKED.get(key)
    if hit and hit[0]() is u and hit[1] == version:
        return hit[2]
    packed = pack_tc_slices(u, cluster)
    if len(_TC_PACKED) >= 16:
        _TC_PACKED.clear()
    _TC_PACKED[key] = (weakref.ref(u), version, packed)
    return packed


def _check_f(xp, h0, u, what):
    """F's operands: (T, B, H), or None off the card (CPU tensors)."""
    T, B, H = _check_xp(xp, h0, u)
    if xp.device.type == "cpu":
        return None
    if xp.dtype != torch.float32:
        raise ValueError(f"{what} takes float32 operands (a bf16 layer runs kernel X), not "
                         f"{xp.dtype}")
    return T, B, H


def gru_layer_xp_fwd_chain(xp, h0, u):
    """Kernel F's chain: A's float32 chain (``csrc/gru_cell_fwd.cuh``) over
    the given xp (T, B, 3H), emitting the (T, B, H) sequence
    (``gru_layer_xp_reference``). CPU tensors run the plain version; CUDA
    tensors (float32) launch it on clusters at ``xp_fwd_plan``'s plan (the
    resident slice, or F's tensor-core instance over U packed by
    ``pack_tc_slices``), counted on this wrapper and, as one call of F, on
    ``gru_layer_xp`` (``.launches`` and ``.launches_chain``)."""
    shape = _check_f(xp, h0, u, "gru_layer_xp_fwd_chain")
    if shape is None:
        return gru_layer_xp_reference(xp, h0, u)
    T, B, H = shape
    plan = xp_fwd_plan(H, B)
    seq = torch.empty(T, B, H, device=xp.device, dtype=torch.float32)
    lib, fns = _xp_fwd_kernel()
    if plan.chunk:
        pzr, ph = _tc_slices(u, plan.cluster)
        rc = fns["tc"](_ptr(xp), _ptr(h0), _ptr(pzr), _ptr(ph), _ptr(seq), T, B, H,
                       plan.cluster, plan.rows, plan.stages, plan.chunk, _stream(xp))
    else:
        rc = fns["chain"](_ptr(xp), _ptr(h0), _ptr(u), _ptr(seq), T, B, H, plan.cluster,
                          plan.rows, plan.splits, plan.stages, _stream(xp))
    _build.check(lib, rc, "gru_layer_xp_fwd chain launch")
    gru_layer_xp_fwd_chain.launches += 1
    gru_layer_xp.launches += 1
    gru_layer_xp.launches_chain += 1
    return seq


def gru_layer_xp_fwd_block(xp, h0, u):
    """Kernel F's per-block route (its first design: one block of H threads
    per 8 batch rows, U read from L2 at every step), as
    ``gru_layer_xp_fwd_chain``: counted on this wrapper and, as one call of
    F, on ``gru_layer_xp`` (``.launches`` and ``.launches_block``)."""
    shape = _check_f(xp, h0, u, "gru_layer_xp_fwd_block")
    if shape is None:
        return gru_layer_xp_reference(xp, h0, u)
    T, B, H = shape
    _layout.require("F", H, _layout.smem_bytes("F", H))
    seq = torch.empty(T, B, H, device=xp.device, dtype=torch.float32)
    lib, fns = _xp_fwd_kernel()
    rc = fns["block"](_ptr(xp), _ptr(h0), _ptr(u), _ptr(seq), T, B, H, _stream(xp))
    _build.check(lib, rc, "gru_layer_xp_fwd per-block launch")
    gru_layer_xp_fwd_block.launches += 1
    gru_layer_xp.launches += 1
    gru_layer_xp.launches_block += 1
    return seq


def gru_layer_xp(xp, h0, u):
    """The tanh GRU layer forward over xp (T, B, 3H) time-major, every
    operand float32 or every one bfloat16: the (T, B, H) h sequence in their
    dtype. CPU tensors run ``gru_layer_xp_reference``; CUDA tensors launch
    kernel F (float32) on the route ``_layout.gru_xp_fwd_route`` picks
    (``gru_layer_xp_fwd_chain`` or ``gru_layer_xp_fwd_block``) or kernel X
    (bfloat16, see the module note). Every launch of F counts on
    ``.launches``, its chain's also on ``.launches_chain``, its per-block
    route's on ``.launches_block``."""
    T, B, H = _check_xp(xp, h0, u)
    if xp.device.type == "cpu":
        return gru_layer_xp_reference(xp, h0, u)
    if xp.dtype == _BF16:
        from . import encoder_scan  # it imports this module

        return encoder_scan.gru_encoder_scan_fwd(xp, h0, u, "tanh", True)
    if _layout.gru_xp_fwd_route(H) == "block":
        return gru_layer_xp_fwd_block(xp, h0, u)
    return gru_layer_xp_fwd_chain(xp, h0, u)


gru_layer_xp.launches = gru_layer_xp.launches_chain = gru_layer_xp.launches_block = 0
# F's two routes, each counting its launches on ``.launches``
F_ROUTES = ("gru_layer_xp_fwd_chain", "gru_layer_xp_fwd_block")
for _fn in (gru_layer_xp_fwd_chain, gru_layer_xp_fwd_block):
    _fn.launches = 0


def gru_layer_xp_bwd_reference(xp, seq, h0, d_seq, d_final, u):
    """Plain version of kernel G: reverse-time BPTT of the layer over xp.
    ``d_seq`` (T, B, H) and ``d_final`` (B, H) are the incoming grads (either
    may be None). Returns (dxp (T, B, 3H), dh0, da_cat (T, B, 3H), rh (T, B,
    H)). Every operand is widened to float32 and the transposition runs in
    float32, the dh carry too; dxp (the gate grads) and dh0 leave in xp's
    dtype, da_cat (the same gate grads) and rh in float32 (``_bwd_kernel``;
    in a float32 layer dxp is da_cat)."""
    dtype = xp.dtype
    xp, seq, h0, u = (t.float() for t in (xp, seq, h0, u))
    T = xp.shape[0]
    dh = d_final.float() if d_final is not None else torch.zeros_like(h0)
    da, rh = [None] * T, [None] * T
    for t in reversed(range(T)):
        if d_seq is not None:
            dh = dh + d_seq[t].float()
        hp = seq[t - 1] if t > 0 else h0
        da[t], dh, rh[t] = gru_cell_bwd_xp(xp[t], hp, u, dh)
    da = torch.stack(da)
    return da.to(dtype), dh.to(dtype), da, torch.stack(rh)


def gru_bwd_gates_xp_reference(xp, hprev, u):
    """Plain version of G's xp gate pre-pass: (gates (T, B, 3H) = [z, r,
    hh], rh (T, B, H) = r * h_{t-1}), both float32, from xp (T, B, 3H),
    hprev = [h0, hseq[:-1]] (T, B, H) and U, every operand widened to
    float32 (``_bwd_kernel``'s recompute: in bf16 the products of bf16
    values summed in float32, r * h in float32)."""
    T, B, G3 = xp.shape
    H = u.shape[0]
    xp, hprev, u = _widened(xp, hprev, u)
    hp, xp = hprev.reshape(T * B, H), xp.reshape(T * B, G3)
    hu = hp @ u[:, : 2 * H]
    z = torch.sigmoid(xp[:, :H] + hu[:, :H])
    r = torch.sigmoid(xp[:, H : 2 * H] + hu[:, H:])
    rh = r * hp
    hh = torch.tanh(xp[:, 2 * H :] + rh @ u[:, 2 * H :])
    return torch.cat([z, r, hh], dim=-1).reshape(T, B, 3 * H), rh.reshape(T, B, H)


@functools.cache
def _xp_bwd_phases():
    """(library, {"gates" | "chain" | "block": {dtype: entry}}) of kernel G."""
    lib, gates = _build.load_builds("gru_layer_xp_bwd", "mvt_gru_layer_xp_bwd_gates",
                                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                                    + [ctypes.c_void_p])
    chain = _build.load_builds("gru_layer_xp_bwd", "mvt_gru_layer_xp_bwd_chain",
                               [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])[1]
    block = _build.load_builds("gru_layer_xp_bwd", "mvt_gru_layer_xp_bwd_block",
                               [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p])[1]
    # the float32 builds have no dxp pointer: their dacat is their dxp
    chain[torch.float32].argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                                     + [ctypes.c_void_p])
    block[torch.float32].argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                                     + [ctypes.c_void_p])
    return lib, {"gates": gates, "chain": chain, "block": block}


@functools.cache
def xp_bwd_plan(bf16, H, B):
    """G's chain plan at (H, B) (``_layout.gru_bptt_plan`` of
    ``_layout.G_CHAIN_BUILDS[bf16]``) at the card's active clusters of G's
    instance; raises LaunchLimitError where it does not launch."""
    return _layout.gru_bptt_plan(_layout.G_CHAIN_BUILDS[bf16], H, B, None,
                                 lambda C: _max_clusters("gru_layer_xp_bwd", bf16, C))


def gru_layer_xp_bwd_gates(xp, hprev, u):
    """Kernel G's xp gate pre-pass: ``gru_bwd_gates_xp_reference``. CPU
    tensors run the plain version; CUDA tensors (every operand float32 or
    every one bfloat16) launch its build of their dtype (two launches: P1,
    P2)."""
    T, B, G3 = xp.shape
    H = u.shape[0]
    if not _check_bwd_phase("gru_layer_xp_bwd_gates", {"xp": xp, "hprev": hprev, "u": u},
                            {"xp": (T, B, 3 * H), "hprev": (T, B, H), "u": (H, 3 * H)}):
        return gru_bwd_gates_xp_reference(xp, hprev, u)
    kw = {"device": xp.device, "dtype": torch.float32}
    gates, rh = torch.empty(T, B, 3 * H, **kw), torch.empty(T, B, H, **kw)
    lib, fns = _xp_bwd_phases()
    rc = fns["gates"][xp.dtype](_ptr(xp), _ptr(hprev), _ptr(u), _ptr(gates), _ptr(rh), T * B, H,
                                _stream(xp))
    _build.check(lib, rc, "gru_layer_xp_bwd gates launch")
    _build.count_launch(gru_layer_xp_bwd_gates, xp.dtype, 2)
    return gates, rh


def gru_layer_xp_bwd_chain(gates, hprev, d_seq, d_final, u):
    """Kernel G's chain (C's) over the pre-pass's gates: (dxp in hprev's
    dtype, dh0 in hprev's dtype, da_cat float32); in float32 dxp is da_cat.
    CPU tensors run ``gru_bwd_chain_reference`` (dxp and dh0 rounded to
    hprev's dtype); CUDA tensors launch its build of hprev's dtype on
    clusters (``xp_bwd_plan``), the bf16 build rounding dxp from the chain's
    own stores of da_cat; counted on this wrapper and, as one call of G, on
    ``gru_layer_xp_bwd``."""
    T, B, H = hprev.shape
    named = {"gates": gates, "hprev": hprev, "u": u}
    expected = {"gates": (T, B, 3 * H), "hprev": (T, B, H), "u": (H, 3 * H),
                "d_seq": (T, B, H), "d_final": (B, H)}
    for k, v in (("d_seq", d_seq), ("d_final", d_final)):
        if v is not None:
            named[k] = v
    dtype = hprev.dtype
    if not _check_bwd_phase("gru_layer_xp_bwd_chain", named, expected, ("gates",)):
        da, dh0 = gru_bwd_chain_reference(gates, hprev, d_seq, d_final, u)
        return da.to(dtype), dh0.to(dtype), da
    plan = xp_bwd_plan(dtype == _BF16, H, B)
    da = torch.empty(T, B, 3 * H, device=hprev.device, dtype=torch.float32)
    dxp = torch.empty(T, B, 3 * H, device=hprev.device, dtype=dtype) if dtype == _BF16 else da
    dh0 = torch.empty(B, H, device=hprev.device, dtype=dtype)
    ut = u.t().contiguous()  # the CTAs copy their rows of U^T
    null = ctypes.c_void_p(None)
    opt = lambda t: _ptr(t) if t is not None else null  # noqa: E731
    outs = (_ptr(da), _ptr(dxp), _ptr(dh0)) if dtype == _BF16 else (_ptr(da), _ptr(dh0))
    lib, fns = _xp_bwd_phases()
    rc = fns["chain"][dtype](_ptr(gates), _ptr(hprev), opt(d_seq), opt(d_final), _ptr(ut), *outs,
                             T, B, H, plan.cluster, plan.rows[0], plan.nbuf, plan.stages,
                             _stream(hprev))
    _build.check(lib, rc, "gru_layer_xp_bwd chain launch")
    _build.count_launch(gru_layer_xp_bwd_chain, dtype)
    _build.count_launch(gru_layer_xp_bwd, dtype)
    return dxp, dh0, da


def gru_layer_xp_bwd_block(xp, seq, h0, d_seq, d_final, u):
    """Kernel G's per-block route (its first design), as
    ``gru_layer_xp_bwd``: CPU tensors run ``gru_layer_xp_bwd_reference``;
    CUDA tensors launch its build of their dtype where ``_layout`` lets it
    launch, counted on this wrapper and, as one call of G, on
    ``gru_layer_xp_bwd``."""
    T, B, H = _check_xp(xp, h0, u, seq, d_seq, d_final)
    if xp.device.type == "cpu":
        return gru_layer_xp_bwd_reference(xp, seq, h0, d_seq, d_final, u)
    dtype = xp.dtype
    build = "G_bf16" if dtype == _BF16 else "G"
    _layout.require(build, H, _layout.smem_bytes(build, H))
    kw = {"device": xp.device, "dtype": torch.float32}
    dacat, rh = torch.empty(T, B, 3 * H, **kw), torch.empty(T, B, H, **kw)
    dh0 = torch.empty(B, H, device=xp.device, dtype=dtype)
    # the float32 build's dxp is its dacat; the bf16 build also rounds it
    dxp = torch.empty(T, B, 3 * H, device=xp.device, dtype=dtype) if dtype == _BF16 else dacat
    ut = u.t().contiguous()  # the transposed products read U^T row by row
    null = ctypes.c_void_p(None)
    opt = lambda t: _ptr(t) if t is not None else null  # noqa: E731
    lib, fns = _xp_bwd_phases()
    outs = (_ptr(dacat), _ptr(dxp), _ptr(dh0)) if dtype == _BF16 else (_ptr(dacat), _ptr(dh0))
    rc = fns["block"][dtype](_ptr(xp), _ptr(seq), _ptr(h0), opt(d_seq), opt(d_final), _ptr(u),
                             _ptr(ut), *outs, _ptr(rh), T, B, H, _stream(xp))
    _build.check(lib, rc, "gru_layer_xp_bwd per-block launch")
    _build.count_launch(gru_layer_xp_bwd_block, dtype)
    _build.count_launch(gru_layer_xp_bwd, dtype)
    return dxp, dh0, dacat, rh


def gru_layer_xp_bwd(xp, seq, h0, d_seq, d_final, u):
    """Backward of ``gru_layer_xp``: see ``gru_layer_xp_bwd_reference``. CPU
    tensors run the plain version; CUDA tensors (every operand float32 or
    every one bfloat16) run kernel G's build of their dtype on the route
    ``_layout.gru_xp_bwd_route`` picks: the xp gate pre-pass and C's chain,
    or the per-block route. It launches nothing itself: each phase counts
    its launches on its own wrapper, and the chain's launch (or the
    per-block route's), one a call, also on ``.launches`` or
    ``.launches_bf16`` here."""
    T, B, H = _check_xp(xp, h0, u, seq, d_seq, d_final)
    if xp.device.type == "cpu":
        return gru_layer_xp_bwd_reference(xp, seq, h0, d_seq, d_final, u)
    bf16 = xp.dtype == _BF16
    if _layout.gru_xp_bwd_route(H, bf16) == "block":
        return gru_layer_xp_bwd_block(xp, seq, h0, d_seq, d_final, u)
    xp_bwd_plan(bf16, H, B)  # raises first
    hprev = torch.cat([h0[None], seq[:-1]])
    gates, rh = gru_layer_xp_bwd_gates(xp, hprev, u)
    dxp, dh0, da_cat = gru_layer_xp_bwd_chain(gates, hprev, d_seq, d_final, u)
    return dxp, dh0, da_cat, rh


gru_layer_xp_bwd.launches = 0
gru_layer_xp_bwd.launches_bf16 = 0
# the wrappers that launch G's kernels, each counting its launches on
# ``.launches`` and ``.launches_bf16`` (the pre-pass two a call: P1, P2)
G_PHASES = ("gru_layer_xp_bwd_gates", "gru_layer_xp_bwd_chain", "gru_layer_xp_bwd_block")
for _fn in (gru_layer_xp_bwd_gates, gru_layer_xp_bwd_chain, gru_layer_xp_bwd_block):
    _fn.launches = _fn.launches_bf16 = 0


class _GruLayerTrain(torch.autograd.Function):
    """Forward: kernel F (bf16: X), the h sequence as residual. Backward:
    kernel G for dxp and dh0, then kernel W for dU from G's float32 gate
    grads (``mode`` "inplace", row 10) or from the rounded dxp ("wide", row
    12), float32 sums rounded to U's dtype."""

    @staticmethod
    def forward(ctx, xp, h0, u, return_sequences, mode):
        ctx.set_materialize_grads(True)
        seq = gru_layer_xp(xp, h0, u)
        ctx.save_for_backward(xp, h0, u, seq)
        ctx.return_sequences = return_sequences
        ctx.mode = mode
        return seq if return_sequences else seq[-1].clone()

    @staticmethod
    def backward(ctx, g):
        xp, h0, u, seq = ctx.saved_tensors
        g = g.contiguous()
        d_seq, d_final = (g, None) if ctx.return_sequences else (None, g)
        dxp, dh0, da_cat, rh = gru_layer_xp_bwd(xp, seq, h0, d_seq, d_final, u)
        du = gru_u_grad(torch.cat([h0[None], seq[:-1]]), rh,
                        da_cat if ctx.mode == "inplace" else dxp.float())
        return dxp, dh0, du.to(u.dtype), None, None


def gru_layer_train(xp, h0, u, return_sequences=False, mode="inplace"):
    """Differentiable tanh GRU layer over a precomputed x-projection xp (T,
    B, 3H) time-major, float32 or bfloat16: the (T, B, H) sequence or the
    final h (B, H). ``mode`` ("inplace" or "wide", ``_layout.XP_MODES``)
    picks the row whose dU rounding the backward takes. CPU tensors run the
    plain versions of kernels F (X), G and W; CUDA tensors launch the builds
    of their dtype."""
    if mode not in _layout.XP_MODES:
        raise ValueError(f"mode must be one of {_layout.XP_MODES}, got {mode!r}")
    return _GruLayerTrain.apply(xp, h0, u, return_sequences, mode)
