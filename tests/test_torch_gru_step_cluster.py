"""CPU tests of kernel T's design (``midi_vae_tpu_torch/csrc/gru_step.cu``:
T, T bf16, T xp): one reset-before GRU step on thread-block clusters and the
tensor cores, as two products, P1 = [x | h] . [W ; U_zr] (z, r and the
candidate's x W_h) and, after the cluster's exchange of r * h, P2 =
(r h) . U_h. The kernel runs only on the card; here:

- its phases' plain versions (``gru_step_p1_reference``,
  ``gru_step_p2_reference``) composed, against the JAX package's
  ``_gru_full_kernel`` and ``_gru_recurrent_kernel`` in interpret mode
  (through ``_gru_step_pallas``, ``_gru_recurrent_pallas``), for the three
  cell activations, D 61, 16, 1 and H, B 16 and a ragged 5: float32 atol
  1e-5 + rtol 1e-4; bf16 (operands bf16, products and gates in float32, h'
  rounded once) within one bf16 step at the largest entry, and relative L2
  BF16_STEP_REL_L2 = 1e-4 (``chip_smoke.py``'s: a rounding flip where
  float32 sums taken in another order straddle a bf16 boundary);
- its arithmetic emulated in torch as the kernel takes it (TF32 split,
  cvt.rna high parts and truncated remainders, three products a pair in
  float32; bf16 one exact product for P1 and two for P2, r * h split beside
  the exact U_h; stages of 32 depth rows into zeroed accumulators) against a
  float64 step within T_ATOL = 1e-5 (``chip_smoke.py``'s H_ATOL), with two
  controls that must land outside: one TF32 product in float32, and P2 in
  bf16 over r * h rounded to bf16 (one product);
- the plans (``ops/_layout.py::gru_step_plan``) at the paths' shapes: each
  pick one of the plans the H100 ran within 10 % of the fastest there
  (``NEAR_BEST_T``, from ``python -m midi_vae_tpu_torch.tools.time_t_and_b
  --only tplans``), the launch limits, the wrappers' CPU paths.

Sizes: B 16 (and 5), H 32 or 64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from midi_vae_tpu.ops import fused_gru
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import gru_step as port_step

BF = torch.bfloat16
ATOL, RTOL = 1e-5, 1e-4
T_ATOL = 1e-5
BF16_STEP_REL_L2 = 1e-4
STAGE = 32  # depth rows of a stage of the kernel's ring
ACTS = {"tanh": torch.tanh, "sigmoid": torch.sigmoid, "relu": torch.relu}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's products are tiny: one torch thread and one BLAS
    thread, so that beside the suite's other busy workers its threads do
    not wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel_l2(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _inputs(B, D, H, seed):
    """x (B, D) softmax-like (D = H: a tanh state, as a head's second cell
    takes), h (B, H) in (-0.5, 0.5), W, b, U; numpy float32."""
    rng = np.random.RandomState(seed)
    if D == H:
        x = 0.5 * np.tanh(rng.randn(B, D))
    else:
        x = np.exp(rng.randn(B, D))
        x = x / x.sum(-1, keepdims=True)
    return [x.astype(np.float32), (0.5 * np.tanh(rng.randn(B, H))).astype(np.float32),
            (rng.randn(D, 3 * H) / np.sqrt(D)).astype(np.float32),
            (0.1 * rng.randn(3 * H)).astype(np.float32),
            (rng.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32)]


def _port(args, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in args]


def _phases(x, h, w, b, u, activation, xp=None):
    z, rh, cand = port_step.gru_step_p1_reference(x, h, w, b, u, xp)
    return port_step.gru_step_p2_reference(z, rh, cand, h, u, activation)


CASES = [(B, D, H, act) for B, D, H in ((16, 61, 64), (5, 61, 64), (16, 16, 32), (16, 1, 64),
                                        (5, 64, 64))
         for act in ("tanh", "sigmoid", "relu")]


@pytest.mark.parametrize("B, D, H, activation", CASES)
def test_phases_compose_to_gru_full_kernel(B, D, H, activation):
    x, h, w, b, u = _inputs(B, D, H, B + D + H)
    want = fused_gru._gru_step_pallas(*map(jnp.asarray, (x, h, w, u, b)), activation, True)
    got = _phases(*_port([x, h, w, b, u]), activation)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=RTOL)
    # the plain version the CPU path runs computes the same
    plain = port_step.gru_cell_step_fwd(*_port([x, h, w, b, u]), activation)
    np.testing.assert_allclose(_np(plain), _np(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("B", [16, 5])
@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "relu"])
def test_phases_compose_to_gru_recurrent_kernel(B, activation):
    H = 64
    rng = np.random.RandomState(B)
    xp = rng.randn(B, 3 * H).astype(np.float32)
    _x, h, _w, _b, u = _inputs(B, 8, H, 3 * B)
    want = fused_gru._gru_recurrent_pallas(*map(jnp.asarray, (xp, h, u)), activation, True)
    th, tu, txp = _port([h, u, xp])
    got = _phases(None, th, None, None, tu, activation, xp=txp)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_np(port_step.gru_recurrent_step_fwd(txp, th, tu, activation)),
                               _np(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("D", [61, 16, 64])
@pytest.mark.parametrize("B", [16, 5])
def test_bf16_phases_against_gru_full_kernel(B, D):
    """bf16 operands: the products and gates in float32, r * h float, h'
    rounded once, as ``_gru_full_kernel`` computes in a bf16 model."""
    H = 64
    args = _inputs(B, D, H, 7 * B + D)
    want = fused_gru._gru_step_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in (args[0], args[1], args[2], args[4], args[3])),
        "tanh", True)
    got = _phases(*_port(args, BF), "tanh")
    assert got.dtype == BF
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, atol=2.0 ** -8 * np.abs(w).max(), rtol=0)
    assert _rel_l2(got, want) <= BF16_STEP_REL_L2


# --- the kernel's arithmetic, emulated ---------------------------------------


def _tf32(x, nearest=True):
    """x's TF32 value: 10 mantissa bits, rounded to nearest with ties away
    from zero (cvt.rna.tf32.f32) or truncated (what the tensor cores read
    from a float32 register)."""
    bits = x.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _emulated(segments, split_a, split_b):
    """sum over segments (a (B, K), b (K, N)) of a @ b as the kernel sums
    it: each stage of 32 depth rows (a segment's last one zero-padded) into
    zeroed accumulators (the stage's exact products summed in float64, then
    rounded to float32), added into the float32 running sums; a split
    operand is hi + lo, the products a_lo b_hi + a_hi b_lo + a_hi b_hi of
    the parts there are."""
    acc = None
    for a, b in segments:
        a, b = a.float(), b.float()
        for k0 in range(0, a.shape[1], STAGE):
            sa, sb = a[:, k0:k0 + STAGE], b[k0:k0 + STAGE]
            ah, bh = _tf32(sa), _tf32(sb)
            t = ah.double() @ bh.double()
            if split_a:
                t = t + _tf32(sa - ah, False).double() @ bh.double()
            if split_b:
                t = t + ah.double() @ _tf32(sb - bh, False).double()
            t = t.float()
            acc = t if acc is None else acc + t
    return acc


def emulated_step(x, h, w, b, u, activation="tanh", one_product=False, round_rh=False):
    """Kernel T's arithmetic: P1 over [x | h] (x against W's three gate
    columns, then h against U's z and r columns), b added in the epilogue;
    P2 over r * h against U_h. float32: three TF32 products a pair (the
    control ``one_product``: one); bf16: P1 one exact product, P2 two
    (r * h split; the control ``round_rh``: r * h rounded to bf16, one
    product)."""
    H = h.shape[-1]
    f32 = x.dtype == torch.float32
    split = f32 and not one_product
    zr = _emulated([(x, w[:, :2 * H]), (h, u[:, :2 * H])], split, split) + b.float()[:2 * H]
    cx = _emulated([(x, w[:, 2 * H:])], split, split) + b.float()[2 * H:]
    z, r = torch.sigmoid(zr[:, :H]), torch.sigmoid(zr[:, H:])
    rh = r * h.float()
    if round_rh:
        p2 = _emulated([(rh.to(BF), u[:, 2 * H:])], False, False)
    else:
        p2 = _emulated([(rh, u[:, 2 * H:])], split or not f32, split)
    hh = ACTS[activation](cx + p2)
    return (z * h.float() + (1.0 - z) * hh).to(x.dtype)


def _float64_step(x, h, w, b, u, activation="tanh"):
    return port_step.gru_cell_step_reference(*(t.double() for t in (x, h, w, b, u)), activation)


@pytest.mark.parametrize("D", [61, 1, 64])
@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "relu"])
def test_emulated_float32_arithmetic_within_the_limit(D, activation):
    args = _port(_inputs(16, D, 64, D + 11))
    want = _float64_step(*args, activation)
    err = (emulated_step(*args, activation).double() - want).abs().max().item()
    assert err <= T_ATOL, err
    # the control: one TF32 product a pair lands outside the limit
    err1 = (emulated_step(*args, activation, one_product=True).double() - want).abs().max().item()
    assert err1 > T_ATOL, err1


@pytest.mark.parametrize("D", [61, 16, 64])
def test_emulated_bf16_arithmetic_and_its_control(D):
    """bf16: P1's products exact, P2's r * h split in two; against the
    float64 step over the same bf16 operands, rounded to bf16 once: within
    one bf16 step at the largest entry and BF16_STEP_REL_L2; r * h rounded
    to bf16 before P2 (one product), held the same way, lands over
    BF16_STEP_REL_L2."""
    args = _port(_inputs(16, D, 64, 3 * D), BF)
    want = _float64_step(*args).to(BF)
    got = emulated_step(*args)
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, atol=2.0 ** -8 * np.abs(w).max(), rtol=0)
    assert _rel_l2(got, want) <= BF16_STEP_REL_L2
    # the control, held as the arithmetic is, lands over the limit
    assert _rel_l2(emulated_step(*args, round_rh=True), want) > BF16_STEP_REL_L2


# --- the plans -----------------------------------------------------------------

# The plans (indices of _layout.STEP_T_PLANS, or "split": the two-launch
# route) the H100 ran within 10 % of the fastest at each path shape (B, D,
# H, dtype; D = 0: T xp), from python -m
# midi_vae_tpu_torch.tools.time_t_and_b --only talt tplans (PERF.md,
# Findings; NVIDIA H100 80GB HBM3, 700 W); rerun it and update this
# table when T's kernel changes.
NEAR_BEST_T = {
    (5, 0, 256, 'float32'): (0,), (5, 0, 512, 'float32'): (0,),
    (5, 1, 256, 'float32'): (0, 2), (5, 1, 512, 'float32'): (0,),
    (5, 16, 256, 'bfloat16'): (0, 1, 2, 'split'), (5, 16, 256, 'float32'): (0, 2),
    (5, 16, 512, 'bfloat16'): (0, 1, 2, 'split'), (5, 16, 512, 'float32'): (0,),
    (5, 61, 256, 'bfloat16'): (0, 1, 2, 'split'), (5, 61, 256, 'float32'): (0, 2),
    (5, 61, 512, 'bfloat16'): (0, 1, 2, 'split'), (5, 61, 512, 'float32'): (0,),
    (5, 256, 256, 'bfloat16'): (0, 1, 2, 'split'), (5, 256, 256, 'float32'): (0, 2),
    (5, 512, 512, 'bfloat16'): (0, 1, 2, 'split'), (5, 512, 512, 'float32'): (0,),
    (16, 0, 256, 'float32'): (0,), (16, 0, 512, 'float32'): (0,),
    (16, 1, 256, 'float32'): (0, 2), (16, 1, 512, 'float32'): (0,),
    (16, 16, 256, 'bfloat16'): (1, 2, 'split'), (16, 16, 256, 'float32'): (0, 2),
    (16, 16, 512, 'bfloat16'): (1, 2, 'split'), (16, 16, 512, 'float32'): (0,),
    (16, 61, 256, 'bfloat16'): (1, 2, 'split'), (16, 61, 256, 'float32'): (0, 2),
    (16, 61, 512, 'bfloat16'): (1, 2, 'split'), (16, 61, 512, 'float32'): (0,),
    (16, 256, 256, 'bfloat16'): (1, 2, 3, 'split'), (16, 256, 256, 'float32'): (0, 2),
    (16, 512, 512, 'bfloat16'): (1, 2, 'split'), (16, 512, 512, 'float32'): (0,),
    (256, 0, 256, 'float32'): (0, 1, 2), (256, 0, 512, 'float32'): (3,),
    (256, 1, 256, 'float32'): (2,), (256, 1, 512, 'float32'): ('split',),
    (256, 16, 256, 'bfloat16'): (1, 'split'), (256, 16, 256, 'float32'): (2,),
    (256, 16, 512, 'bfloat16'): ('split',), (256, 16, 512, 'float32'): ('split',),
    (256, 61, 256, 'bfloat16'): (1, 'split'), (256, 61, 256, 'float32'): (2,),
    (256, 61, 512, 'bfloat16'): ('split',), (256, 61, 512, 'float32'): ('split',),
    (256, 256, 256, 'bfloat16'): (1, 'split'), (256, 256, 256, 'float32'): (2,),
    (256, 512, 512, 'bfloat16'): ('split',), (256, 512, 512, 'float32'): ('split',),
}


@pytest.mark.parametrize("key", sorted(NEAR_BEST_T), ids=str)
def test_plan_picks_a_near_best_plan(key):
    B, D, H, dtype = key
    elem = 2 if dtype == "bfloat16" else 4
    p = _layout.gru_step_plan(B, D, H, elem, not D)
    assert ("split" if p.split else p.plan) in NEAR_BEST_T[key]


@pytest.mark.parametrize("B", [256, 16, 5])
@pytest.mark.parametrize("D, H", [(61, 256), (256, 256), (1, 256), (16, 256), (61, 512),
                                  (512, 512), (1, 512), (16, 512), (61, 192), (192, 192),
                                  (61, 320), (61, 384), (384, 384), (61, 448)])
@pytest.mark.parametrize("elem", [4, 2])
def test_plans_fit_the_card(B, D, H, elem):
    """Every plan the chooser may take launches: at most 16 CTAs a cluster,
    threads within 512, the shared memory within a CTA's 227 KB, and the
    pick among them."""
    plans = _layout.gru_step_plans(B, D, H, elem)
    assert plans
    for p in plans:
        assert p.cluster * p.units == H and p.cluster <= 16
        assert p.threads == 32 * (p.rows // 16) * (p.units // 8) <= 512
        assert p.smem == _layout.gru_step_smem(D, H, p.rows, p.units, elem, False)
        assert p.smem <= _layout.SMEM_PER_BLOCK
        assert p.clusters == -(-B // p.rows)
    assert _layout.gru_step_plan(B, D, H, elem)._replace(split=False) in plans
    assert _layout.gru_step_plan(B, 0, H, 4, True) in _layout.gru_step_plans(B, 0, H, 4, True)


@pytest.mark.parametrize("B", [256, 16, 5])
@pytest.mark.parametrize("D, H", [(61, 256), (256, 256), (61, 512), (512, 512), (1, 512)])
@pytest.mark.parametrize("elem", [4, 2])
def test_two_launch_route_where_clusters_outnumber_the_card(B, D, H, elem):
    """T takes its two-launch route exactly where its pick (16 rows x 64
    units) needs more clusters than the H100 runs at once: at B = 256, H =
    512 (16 clusters of 8 against 15), where the route beat every cluster
    plan (PERF.md, Findings); T xp never."""
    p = _layout.gru_step_plan(B, D, H, elem)
    assert p.split == ((p.rows, p.units) == (16, 64)
                       and p.clusters > _layout.MAX_CLUSTERS_H100[p.cluster])
    assert p.split == (B == 256 and H == 512)
    assert not _layout.gru_step_plan(B, 0, H, 4, True).split


@pytest.mark.parametrize("B", [256, 16, 5])
@pytest.mark.parametrize("elem", [4, 2])
def test_every_width_t_takes_has_a_plan(B, elem):
    """T launches at every multiple of 32 up to 512 (its limits): a plan at
    each, one launch where the H100's active clusters of its size were not
    measured (clusters of 3, 5, 6, 7, 9, ... CTAs), T xp too."""
    for H in range(32, 513, 32):
        assert _layout.gru_step_limit("T", H) is None
        p = _layout.gru_step_plan(B, 61, H, elem)
        assert p.cluster * p.units == H
        if p.cluster not in _layout.MAX_CLUSTERS_H100:
            assert not p.split
        q = _layout.gru_step_plan(B, 0, H, 4, True)
        assert q.cluster * q.units == H and not q.split


def test_smem_formula():
    # [x | h] (16 rows of 64 + 256 + 4 floats), r * h (16 x 260), a ring of 3
    # stages of 32 depth rows x (3 x 32 + 8) floats
    assert _layout.gru_step_smem(61, 256, 16, 32, 4, False) == (
        16 * 324 * 4 + 16 * 260 * 4 + 3 * 32 * 104 * 4)
    assert _layout.gru_step_smem(0, 256, 16, 32, 4, True) == (
        16 * 260 * 4 + 16 * 260 * 4 + 3 * 32 * 72 * 4)


@pytest.mark.parametrize("build", _layout.T_BUILDS)
def test_launch_limits(build):
    for H in (32, 64, 256, 512):
        assert _layout.launch_limit(build, H, 0) is None
        assert _layout.smem_bytes(build, H, 61) == 0  # the plan's, not a per-block tile
    for H in (48, 1024):
        why = _layout.launch_limit(build, H, 0)
        assert "multiple of 32" in why and "up to 512" in why
        with pytest.raises(_layout.LaunchLimitError):
            _layout.require(build, H, 0)
    with pytest.raises(_layout.LaunchLimitError, match="up to 512"):
        _layout.gru_step_plan(256, 61, 1024)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_wrappers_run_their_plain_versions_on_cpu(bf16):
    dt = BF if bf16 else torch.float32
    x, h, w, b, u = _port(_inputs(5, 16, 32, 1), dt)
    before = (port_step.gru_cell_step_fwd.launches, port_step.gru_cell_step_fwd.launches_bf16,
              port_step.gru_recurrent_step_fwd.launches)
    got = port_step.gru_cell_step_fwd(x, h, w, b, u, "sigmoid")
    assert got.dtype == dt
    assert torch.equal(got, port_step.gru_cell_step_reference(x, h, w, b, u, "sigmoid"))
    xp = torch.randn(5, 96)
    hf, uf = h.float(), u.float()
    assert torch.equal(port_step.gru_recurrent_step_fwd(xp, hf, uf),
                       port_step.gru_recurrent_step_reference(xp, hf, uf))
    assert (port_step.gru_cell_step_fwd.launches, port_step.gru_cell_step_fwd.launches_bf16,
            port_step.gru_recurrent_step_fwd.launches) == before
