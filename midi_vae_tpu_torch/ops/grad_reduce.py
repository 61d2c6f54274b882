"""Kernel W: the weight-gradient reduction C = A^T B (+ column sums of B).

The TPU backward kernels accumulate dW, dU, dWo and the bias grads over all
T*B rows inside themselves (``midi_vae_tpu/ops/fused_train.py::_bwdx_kernel``
:2175-2178, ``_lstm_bwdx_kernel`` :2458-2460, ``_lstm_bwd_kernel`` :1436,
``_dec_bwd*_kernel``, ``_mh_bwd_kernel``). On the H100 that sum is a second
pass after the serial kernels C, E, G, N and R, as in the JAX package's wide
scheme (``_gru_wide_weight_grads``, ``_lstm_wide_weight_grads``,
``_dec_wide_weight_grads``): the CUDA kernel ``csrc/grad_reduce.cu``, whose
source note gives the layout: the product on the tensor cores at float32
accuracy (``csrc/gemm_tc.cuh``: three TF32 products of split operands, two
for a bf16 A), the rows split over blocks (``splits``) and the partial sums
added in a fixed order, so two runs give the same bits; A narrower than 17
columns takes an instance that streams B.
``grad_reduce_reference`` is the plain PyTorch version: the CPU path and the
kernel's oracle.

Operands are 2-D with unit column stride and any row stride, so column
slices of a gate-grad matrix (``da[:, :2H]``) and of an output
(``du[:, 2H:]``) go in without copies.

W has a second build for a bfloat16 model (``mvt_grad_reduce_bf16``): its
activations A (x, h_{t-1}, a decode head's fed-back probs and h sequences)
are the stored bf16 values, the gate grads B are float32, and the sums are
float32, as the TPU kernels accumulate ``_outer_acc(x, da_cat)`` with x
widened (``_bwdx_kernel``, ``_bwd_kernel``, ``_dec_bwd*_kernel``). B is what
the serial kernel hands over: the unrounded gate grads of C, G and the
narrow E, as those TPU kernels sum from the float32 values in VMEM; on the
wide route's decode heads E's bf16 build hands over dlogits and gate grads
rounded to bf16 (held in float32), the streams ``_dec_wide_weight_grads``
sums on the TPU. The float32 build serves r * h, which stays float32 in a
bf16 model. The wrapper picks the build from A's dtype; launches are counted
per build (``grad_reduce.launches``, ``.launches_bf16``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# the small instance (I <= SMALL_I, csrc/grad_reduce.cu) streams B, 1,024
# columns a block, in one wave of blocks on the H100's 132 SMs; the tiled
# instance runs tiles of 64 (I <= 64) or 128 rows by 128 columns, one block
# an SM (its registers), over whole stages of 16 rows
SMALL_I = 16
_SMS = 132
_SMALL_BLOCKS = _SMS
_SMALL_COLS = 1024
_TILE_N = 128
# the fewest rows a chunk of the depth takes: the small instance's (below
# 32 the partial sums cost more than the rows: the instrument layer's dW
# and db over 1,024 rows took 0.042 ms in 64 chunks, 0.030 in 32, on the
# H100, tools/time_w_splits.py), the tiled instance's (16 stages of its
# ring)
_MIN_ROWS_SMALL = 32
_MIN_ROWS_TILED = 256
# the tiled instance's cost model: seconds a block takes per row of its
# chunk (NVIDIA H100 80GB HBM3: a 128 x 128 tile's three TF32 products,
# about 1.6 us a stage of 16 rows), and the bytes a second the partial sums
# are written and read back at
_ROW_S = 1e-7
_BYTES_PER_S = 3e12


@functools.lru_cache(maxsize=None)
def splits(N: int, I: int, J: int, with_bias: bool = False) -> int:
    """The chunks the N rows of a reduction C (I, J) = A^T B are split into
    (grid z of the instance that I selects), each at least the instance's
    fewest rows. The small instance takes one wave of blocks; the tiled one
    the count that costs least: its waves of one block an SM times the rows
    of a chunk, plus the partial sums it writes and adds."""
    if I <= SMALL_I:
        tiles = -(-J // _SMALL_COLS)
        return max(1, min(-(-_SMALL_BLOCKS // tiles), N // _MIN_ROWS_SMALL))
    bm = 64 if I <= 64 else 128
    tiles = -(-I // bm) * -(-J // _TILE_N)
    partial = 8 * (I + with_bias) * J / _BYTES_PER_S

    def cost(s):
        return -(-tiles * s // _SMS) * -(-N // s) * _ROW_S + (s > 1) * s * partial

    return min(range(1, max(1, N // _MIN_ROWS_TILED) + 1), key=lambda s: (cost(s), s))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def grad_reduce_reference(a, b, with_bias=False):
    """Plain version: (a^T b, b.sum(0) or None), in float32 (a bf16 ``a``
    widened)."""
    b = b.float()
    return a.float().t() @ b, (b.sum(0) if with_bias else None)


@functools.cache
def _kernel():
    return _build.load_builds("grad_reduce", "mvt_grad_reduce",
                              [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                              + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _check_matrix(name: str, t: torch.Tensor, device, dtypes=(torch.float32,)) -> None:
    if t.dim() != 2 or t.stride(1) != 1 or t.stride(0) < t.shape[1]:
        raise ValueError(f"{name} must be 2-D with unit column stride, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")
    if t.device != device or t.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{name} is {t.dtype} on {t.device}; expected {names} on {device}")


def grad_reduce(a, b, out, bias_out=None) -> None:
    """out (I, J) = a^T b for a (N, I), b (N, J); bias_out (J,) = b.sum(0)
    when given. Writes in place. ``a`` is float32 or bfloat16, the others
    float32. CPU tensors run the plain version; CUDA tensors launch kernel
    W's build of a's dtype."""
    N, I = a.shape
    J = b.shape[1]
    if b.shape[0] != N or tuple(out.shape) != (I, J):
        raise ValueError(f"grad_reduce: a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"out {tuple(out.shape)} do not fit (N, I), (N, J), (I, J)")
    if bias_out is not None and tuple(bias_out.shape) != (J,):
        raise ValueError(f"bias_out has shape {tuple(bias_out.shape)}, expected ({J},)")
    if a.device.type == "cpu":
        c, bias = grad_reduce_reference(a, b, bias_out is not None)
        out.copy_(c)
        if bias_out is not None:
            bias_out.copy_(bias)
        return
    if a.device.type != "cuda":
        raise ValueError(f"grad_reduce runs on cpu or cuda tensors, not {a.device}")
    _check_matrix("a", a, a.device, _build.DTYPES)
    for name, t in (("b", b), ("out", out)):
        _check_matrix(name, t, a.device)
    if bias_out is not None:
        _check_matrix("bias_out", bias_out[None], a.device)
    ie = I + (bias_out is not None)
    s = splits(N, I, J, bias_out is not None)
    part = torch.empty(s * ie * J, device=a.device, dtype=torch.float32) if s > 1 else None
    null = ctypes.c_void_p(None)
    lib, fns = _kernel()
    rc = fns[a.dtype](
        _ptr(a), a.stride(0), _ptr(b), b.stride(0), _ptr(out), out.stride(0),
        _ptr(bias_out) if bias_out is not None else null,
        _ptr(part) if part is not None else null,
        N, I, J, s,
        ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream),
    )
    _build.check(lib, rc, "grad_reduce launch")
    _build.count_launch(grad_reduce, a.dtype)


grad_reduce.launches = 0
grad_reduce.launches_bf16 = 0


def gru_weight_grads(x, hprev, rh, da_cat):
    """dW (D, 3H), db (3H,), dU (H, 3H) of one GRU cell over a whole sequence
    from its gate grads: x, h_{t-1}, r*h_{t-1} and da_cat are (T, B, .),
    time-major (``_gru_cell_bwd``'s sums, :373-378). Three reductions, in
    float32; x and h_{t-1} may be bf16 (W's bf16 build), rh and da_cat are
    float32 (da_cat holding bf16 values on the wide route's bf16 heads)."""
    T, B, D = x.shape
    H = hprev.shape[-1]
    n = T * B
    da = da_cat.reshape(n, 3 * H)
    kw = {"device": x.device, "dtype": torch.float32}
    dw, db, du = torch.empty(D, 3 * H, **kw), torch.empty(3 * H, **kw), torch.empty(H, 3 * H, **kw)
    grad_reduce(x.reshape(n, D), da, dw, db)
    gru_u_grad(hprev, rh, da_cat, du)
    return dw, db, du


def lstm_weight_grads(x, hprev, da):
    """dW (D, 4H), db (4H,), dU (H, 4H) of one LSTM cell over a whole
    sequence from its gate grads: x, h_{t-1} and da are (T, B, .),
    time-major (the sums of ``_lstm_bwdx_kernel`` :2458-2460). Two
    reductions."""
    T, B, D = x.shape
    G = da.shape[-1]
    kw = {"device": x.device, "dtype": torch.float32}
    dw, db = torch.empty(D, G, **kw), torch.empty(G, **kw)
    grad_reduce(x.reshape(T * B, D), da.reshape(T * B, G), dw, db)
    return dw, db, lstm_u_grad(hprev, da)


def lstm_u_grad(hprev, da):
    """dU = h_{t-1}^T da (H, 4H) of one LSTM cell over a whole sequence, both
    (T, B, .) time-major (``_lstm_wide_weight_grads``, :2032-2043). One
    reduction."""
    T, B, H = hprev.shape
    G = da.shape[-1]
    du = torch.empty(H, G, device=hprev.device, dtype=torch.float32)
    grad_reduce(hprev.reshape(T * B, H), da.reshape(T * B, G), du)
    return du


def gru_u_grad(hprev, rh, da_cat, out=None):
    """dU (H, 3H) of one GRU cell over a whole sequence (into ``out`` when
    given): [h_{t-1}^T da_zr, (r*h_{t-1})^T da], all (T, B, .) time-major
    (``_gru_wide_weight_grads``, :1813-1835; ``_bwd_kernel``'s dU,
    :166-167). Two reductions; h_{t-1} may be bf16, rh and da_cat are
    float32."""
    H = hprev.shape[-1]
    n = hprev.shape[0] * hprev.shape[1]
    da = da_cat.reshape(n, 3 * H)
    du = out if out is not None else torch.empty(H, 3 * H, device=hprev.device,
                                                 dtype=torch.float32)
    grad_reduce(hprev.reshape(n, H), da[:, : 2 * H], du[:, : 2 * H])
    grad_reduce(rh.reshape(n, H), da[:, 2 * H :], du[:, 2 * H :])
    return du
