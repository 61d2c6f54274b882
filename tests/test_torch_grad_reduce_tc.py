"""CPU tests of kernel W's arithmetic on the tensor cores
(``midi_vae_tpu_torch/csrc/grad_reduce.cu``, ``csrc/gemm_tc.cuh``): the
weight-gradient reduction C = A^T B taken as TF32 products, emulated in
torch, against a float64 sum; the split plan of the wrapper
(``ops/grad_reduce.py::splits``); and the wrapper's plain version against the
JAX package's in-kernel sum (``fused_train._outer_acc``).

The kernel runs only on the card, where ``chip_smoke.py`` (phase 2b) holds it
against a float64 sum at the paths' shapes. Here its arithmetic is emulated:
an operand rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties
away from zero, 10 mantissa bits), its remainder x - hi read as the tensor
cores read a float32 register (the low 13 mantissa bits dropped), each
stage of 16 rows summed in float32 and added into the running sums.
Tolerances: the float32 build's three products (a_lo b_hi + a_hi b_lo +
a_hi b_hi) and the bf16 build's two (a b_lo + a b_hi, a bf16 A being exact
in TF32) land within W_REL_L2 = 1e-5 relative L2 of the float64 sum
(``chip_smoke.py``'s W_REL_L2); one TF32 product of the rounded operands,
the control, must land over it. The plain version against ``_outer_acc``:
float32 sums in another order, relative L2 <= 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.ops import fused_train as ft
from midi_vae_tpu_torch.ops import grad_reduce as port_gr

W_REL_L2 = 1e-5
PLAIN_REL_L2 = 1e-6
STAGE = 16  # rows a stage of the kernel's ring


def _tf32_rna(x):
    """x (float32) rounded to TF32 as cvt.rna does: ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """x (float32) as the tensor cores read it: the low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _staged_sum(pairs):
    """sum over the (a, b) pairs of a^T b, rows taken STAGE at a time: each
    stage's products summed in float32, then added into the running sums."""
    N = pairs[0][0].shape[0]
    acc = torch.zeros(pairs[0][0].shape[1], pairs[0][1].shape[1])
    for n in range(0, N, STAGE):
        acc += sum(a[n:n + STAGE].t() @ b[n:n + STAGE] for a, b in pairs)
    return acc


def _products(a, b, products):
    """W's arithmetic on float32 a (N, I), b (N, J): the three-product split,
    the bf16 build's two (a exact in TF32) or one product of the rounded
    operands."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    a_lo, b_lo = _tf32_trunc(a - a_hi), _tf32_trunc(b - b_hi)
    if products == 3:
        return _staged_sum([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)])
    if products == 2:
        assert torch.equal(a_hi, a), "the two-product form takes an A exact in TF32"
        return _staged_sum([(a, b_lo), (a, b_hi)])
    return _staged_sum([(a_hi, b_hi)])


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _operands(kind, N, I, J, seed):
    """A like the paths' activations (a one-hot x, a tanh h, a velocity in
    [0, 1)), B like gate grads; numpy float32."""
    rng = np.random.RandomState(seed)
    if kind == "one-hot":
        a = np.eye(I, dtype=np.float32)[rng.randint(0, I, N)]
    elif kind == "tanh":
        a = np.tanh(rng.randn(N, I)).astype(np.float32)
    else:
        a = rng.rand(N, I).astype(np.float32)
    return a, (1e-2 * rng.randn(N, J)).astype(np.float32)


# (A's values, N = T B rows at T 8 and B 16, I, J = 4H at H 32 or 64)
CASES = [("one-hot", 128, 61, 128), ("tanh", 128, 32, 128), ("tanh", 128, 64, 256),
         ("uniform", 128, 1, 256), ("one-hot", 64, 16, 128), ("tanh", 1024, 64, 256)]
IDS = [f"{k}-N{n}-I{i}-J{j}" for k, n, i, j in CASES]


@pytest.mark.parametrize("kind, N, I, J", CASES, ids=IDS)
def test_three_tf32_products_reach_float32_accuracy(kind, N, I, J):
    """The float32 build's three TF32 products land within W_REL_L2 of the
    float64 sum; one product of the rounded operands lands over it."""
    a, b = _operands(kind, N, I, J, N + I + J)
    want = a.astype(np.float64).T @ b.astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    three = _rel_l2(_products(ta, tb, 3), want)
    one = _rel_l2(_products(ta, tb, 1), want)
    assert three <= W_REL_L2, f"three products: {three:.3e}"
    assert one > W_REL_L2, f"the one-product control lands inside: {one:.3e}"


@pytest.mark.parametrize("kind, N, I, J", CASES, ids=IDS)
def test_bf16_a_takes_two_tf32_products(kind, N, I, J):
    """A bf16 A is exact in TF32: the bf16 build's two products (B split)
    land within W_REL_L2 of the float64 sum of the widened A and float32
    B; one product (B rounded to TF32) lands over it."""
    a, b = _operands(kind, N, I, J, 7 * N + I)
    ta = torch.from_numpy(a).to(torch.bfloat16).float()
    tb = torch.from_numpy(b)
    want = ta.double().t().numpy() @ b.astype(np.float64)
    two = _rel_l2(_products(ta, tb, 2), want)
    one = _rel_l2(_products(ta, tb, 1), want)
    assert two <= W_REL_L2, f"two products: {two:.3e}"
    assert one > W_REL_L2, f"the one-product control lands inside: {one:.3e}"


def test_tf32_rounding_emulation():
    """The emulated cvt.rna keeps 10 mantissa bits, rounds to nearest with
    ties away from zero, and leaves bf16 values alone."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4,
                      1.0 + 0.75 * one_ulp], dtype=torch.float32)
    assert _tf32_rna(x).tolist() == [1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + one_ulp]
    r = torch.randn(1000).to(torch.bfloat16).float()
    assert torch.equal(_tf32_rna(r), r) and torch.equal(_tf32_trunc(r), r)
    y = torch.randn(1000)
    assert (torch.abs(_tf32_rna(y) - y) <= 2.0 ** -11 * torch.abs(y)).all()


# the paths' reductions (N, I, J, with the bias row) -> the split counts
# whose time was within 10 % of the fastest count's on the card
# (midi_vae_tpu_torch/tools/time_w_splits.py on an NVIDIA H100 80GB HBM3 at
# 700.00 W: the median of 20 windows of 10 back-to-back calls, every count
# it allows from 1 to 16 and 18 to 132 in steps): the dW and db of notes
# layer 1, GRU(256)'s two dU parts, the notes head's dWo and db, the
# velocity and instrument layers' dW and db, LSTM(512)'s dU, an LSTM
# judge's dU at B = 512, an LSTM(256) dU over 4 steps, a GRU(256) dU at
# B = 5, a dW and db over 5 rows
NEAR_BEST_SPLITS = {
    (16384, 61, 768, True): {20, 22, 44},
    (16384, 256, 512, False): {14, 15, 16, 32, 33},
    (16384, 256, 256, False): {28, 30, 32, 33},
    (16384, 256, 61, True): {48, 56, 64},
    (16384, 1, 768, True): {128, 132},
    (1024, 16, 768, True): {10, 11, 12, 24, 26, 30, 32, 33},
    (16384, 512, 2048, False): {2, 4, 6, 8, 10, 12, 14, 16, 18},
    (32768, 256, 1024, False): {8, 15, 16, 24, 32, 33},
    (1024, 256, 1024, False): {3, 4},
    (320, 256, 768, False): {1},
    (5, 61, 768, True): {1},
}


@pytest.mark.parametrize("N, I, J, with_bias", list(NEAR_BEST_SPLITS),
                         ids=[f"N{n}-I{i}-J{j}{'-bias' if b else ''}"
                              for n, i, j, b in NEAR_BEST_SPLITS])
def test_split_plan(N, I, J, with_bias):
    """The split count ``splits`` picks for each of the paths' reductions
    is one the card ran within 10 % of the fastest count's time, and every
    chunk holds at least the instance's fewest rows."""
    s = port_gr.splits(N, I, J, with_bias)
    assert s in NEAR_BEST_SPLITS[N, I, J, with_bias]
    least = port_gr._MIN_ROWS_SMALL if I <= port_gr.SMALL_I else port_gr._MIN_ROWS_TILED
    assert 1 <= s <= max(1, N // least)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no-bias", "bias"])
def test_plain_version_against_outer_acc(bf16, with_bias):
    """grad_reduce on CPU tensors runs its plain version (no launch counted)
    and sums what the JAX kernels' _outer_acc sums: x^T da with x float32 or
    bf16 (widened), the gate grads float32; the bias b.sum(0)."""
    a, b = _operands("tanh", 128, 61, 256, 3 + bf16)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    ta = torch.from_numpy(a).to(tdt)
    tb = torch.from_numpy(b)
    out = torch.empty(61, 256)
    bias = torch.empty(256) if with_bias else None
    before = (port_gr.grad_reduce.launches, port_gr.grad_reduce.launches_bf16)
    port_gr.grad_reduce(ta, tb, out, bias)
    assert before == (port_gr.grad_reduce.launches, port_gr.grad_reduce.launches_bf16)
    want = ft._outer_acc(jnp.asarray(a, jdt), jnp.asarray(b))
    assert _rel_l2(out, want) <= PLAIN_REL_L2
    if with_bias:
        assert _rel_l2(bias, b.astype(np.float64).sum(0)) <= PLAIN_REL_L2
