"""CPU tests of kernel S's design (``midi_vae_tpu_torch/csrc/lstm_step.cu``):
one LSTM step as one product [x | h] . [W ; U] on the tensor cores with the
cell math in its epilogue. The kernel runs only on the card; here its
arithmetic is emulated in torch as the kernel takes it (float32 operands
split into a TF32 high part, rounded cvt.rna-style, and a remainder whose
TF32 bits the tensor cores read, three products a pair; bf16 operands
exact, one product; every stage of 16 depth rows summed into zeroed
accumulators and added into the running sums by one rounded float add;
x against W, then h against U) and held against a float64 step and against
the JAX package's ``_lstm_full_kernel`` and ``_lstm_recurrent_kernel`` in
interpret mode (module-scoped fixtures), at ``chip_smoke.py``'s limits:
L_H_ATOL = 1e-5 for h, C_ATOL = 5e-5 for c; a one-TF32-product control
must land over L_H_ATOL. The bf16 build is held one step from a random
state to one bf16 step at the largest entry and BF16_STEP_REL_L2 = 1e-4
relative L2, and two wrong roundings must land over the latter: x @ W + b
rounded to bf16 before the gates, and h' taken from the rounded c'. The
gathered gate-column layout (four gate blocks interleaved 8 units at a
time) is checked against the plain step, and the tile plan
(``ops/_layout.py::step_plan``) at the paths' shapes against the tiles the
card ran fastest there. Sizes: B 16, H 32 or
64, D 1, 5, 13 and 61.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from midi_vae_tpu.ops import fused_lstm
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import lstm_step as port_step

BF = torch.bfloat16
L_H_ATOL, C_ATOL = 1e-5, 5e-5
BF16_STEP_REL_L2 = 1e-4
B = 16
STAGE = 16  # depth rows a stage of gemm_tc.cuh's ring
ACTS = {"tanh": torch.tanh, "sigmoid": torch.sigmoid, "relu": torch.relu}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's products are tiny: one torch thread and one BLAS thread,
    so that beside the suite's other busy workers its threads do not wait on
    each other (this file and its S or A twin took 114 s beside five busy
    processes on eight cores, 32 s there on one thread, 6 s alone)."""
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


def _inputs(D, H, seed):
    """x (B, D) softmax-like, h (B, H) in (-0.5, 0.5), c (B, H), W, b, U;
    numpy float32."""
    rng = np.random.RandomState(seed)
    x = np.exp(rng.randn(B, D))
    return [(x / x.sum(-1, keepdims=True)).astype(np.float32),
            (0.5 * np.tanh(rng.randn(B, H))).astype(np.float32),
            rng.randn(B, H).astype(np.float32),
            (rng.randn(D, 4 * H) / np.sqrt(D)).astype(np.float32),
            (0.1 * rng.randn(4 * H)).astype(np.float32),
            (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)]


def _tf32(x, nearest=True):
    """x's TF32 value: 10 mantissa bits, rounded to nearest with ties away
    from zero (cvt.rna.tf32.f32) or truncated (what the tensor cores read
    from a float32 register)."""
    bits = x.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _emulated_product(segments, products):
    """sum over segments (a (B, K), b (K, N)) of a @ b as the kernel sums it:
    each stage of 16 depth rows (a segment's last one zero-padded) into
    zeroed accumulators (the stage's exact products summed in float64, then
    rounded to float32), added into the float32 running sums; ``products``
    3: a = hi + lo, a lo b hi + a hi b lo + a hi b hi; 1: a hi b hi."""
    acc = None
    for a, b in segments:
        a, b = a.float(), b.float()
        for k0 in range(0, a.shape[1], STAGE):
            sa, sb = a[:, k0:k0 + STAGE], b[k0:k0 + STAGE]
            ah, bh = _tf32(sa), _tf32(sb)
            t = ah.double() @ bh.double()
            if products == 3:
                al, bl = _tf32(sa - ah, False), _tf32(sb - bh, False)
                t = t + al.double() @ bh.double() + ah.double() @ bl.double()
            t = t.float()
            acc = t if acc is None else acc + t
    return acc


def _cell(gates, c, act, dtype, round_c_first=False):
    """The epilogue: c' = sig(f) c + sig(i) act(g), h' = sig(o) act(c') from
    the unrounded c' (``round_c_first``: from the rounded one, a control),
    both stored as ``dtype``."""
    H = c.shape[-1]
    f = ACTS[act]
    i, fg, g, o = (gates[:, q * H:(q + 1) * H] for q in range(4))
    cn = torch.sigmoid(fg) * c.float() + torch.sigmoid(i) * f(g)
    src = cn.to(dtype).float() if round_c_first else cn
    return (torch.sigmoid(o) * f(src)).to(dtype), cn.to(dtype)


def emulated_step(x, h, c, w, b, u, act="tanh", products=None, round_xw=False,
                  round_c_first=False):
    """Kernel S's arithmetic: float32 operands three TF32 products a pair,
    bf16 one; x against W, then h against U, in stages; b added in float in
    the epilogue. ``round_xw``: x @ W + b rounded to bf16 before the gates
    (a control)."""
    dtype = x.dtype
    products = products or (1 if dtype == BF else 3)
    if round_xw:
        xw = (_emulated_product([(x, w)], products) + b.float()).to(dtype).float()
        gates = xw + _emulated_product([(h, u)], products)
    else:
        gates = _emulated_product([(x, w), (h, u)], products) + b.float()
    return _cell(gates, c, act, dtype, round_c_first)


def emulated_step_xp(xp, h, c, u, act="tanh"):
    """Kernel S xp's arithmetic: h against U alone, xp added in the
    epilogue."""
    return _cell(_emulated_product([(h, u)], 3) + xp.float(), c, act, torch.float32)


def float64_step(x, h, c, w, b, u, act="tanh"):
    x, h, c, w, b, u = (t.double() for t in (x, h, c, w, b, u))
    gates = x @ w + b + h @ u
    H = h.shape[-1]
    f = {"tanh": torch.tanh, "sigmoid": torch.sigmoid, "relu": torch.relu}[act]
    i, fg, g, o = (gates[:, q * H:(q + 1) * H] for q in range(4))
    cn = torch.sigmoid(fg) * c + torch.sigmoid(i) * f(g)
    return torch.sigmoid(o) * f(cn), cn


CASES = [(61, 64), (13, 32), (5, 64), (1, 32)]  # (D, H)


@pytest.fixture(scope="module")
def full_refs():
    """{(D, H): (torch float32 inputs, _lstm_full_kernel's (h', c') per
    activation, torch bf16 inputs, its bf16 (h', c'))}, interpret mode."""
    out = {}
    for D, H in CASES:
        arrays = _inputs(D, H, 10 * D + H)
        t32 = [torch.from_numpy(a.copy()) for a in arrays]
        j = [jnp.asarray(a) for a in arrays]
        f32 = {act: fused_lstm._lstm_step_pallas(j[0], j[1], j[2], j[3], j[5], j[4], act, True)
               for act in ("tanh", "sigmoid", "relu")}
        jb = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
        tb = [t.to(BF) for t in t32]
        bf = fused_lstm._lstm_step_pallas(jb[0], jb[1], jb[2], jb[3], jb[5], jb[4], "tanh", True)
        out[D, H] = (t32, f32, tb, bf)
    return out


def test_emulated_float32_step_matches_float64_and_row_30(full_refs):
    """At each of CASES and each activation, the three-product emulation
    lands within L_H_ATOL (h) and C_ATOL (c) of a float64 step and of
    _lstm_full_kernel (interpret mode); the plain version too; a
    one-TF32-product control lands over L_H_ATOL from the float64 step."""
    for (D, H), (args, refs, _, _) in full_refs.items():
        for act in ("tanh", "sigmoid", "relu"):
            got = emulated_step(*args, act)
            for want, what in ((float64_step(*args, act), "float64"),
                               (refs[act], "_lstm_full_kernel"),
                               (port_step.lstm_cell_step_reference(*args, act), "plain")):
                for g, w, tol in zip(got, want, (L_H_ATOL, C_ATOL)):
                    assert np.abs(_np(g) - _np(w)).max() <= tol, (D, H, act, what)
        one = emulated_step(*args, "tanh", products=1)
        err = np.abs(_np(one[0]) - _np(float64_step(*args, "tanh")[0])).max()
        assert err > L_H_ATOL, f"D{D}-H{H}: the one-product control lands inside: {err:.3e}"


def test_emulated_bf16_step_matches_row_30_in_bf16(full_refs):
    """At each of CASES, one bf16 step from a random state: the emulation
    (exact products, h' from the unrounded c', both rounded to nearest even)
    within one bf16 step at the largest entry and BF16_STEP_REL_L2 of
    _lstm_full_kernel in bf16, as is the plain version; the two wrong
    roundings land over the relative limit."""
    for (D, H), (_, _, args, want) in full_refs.items():
        got = emulated_step(*args)
        plain = port_step.lstm_cell_step_reference(*args)
        for outs in (got, plain):
            for g, w in zip(outs, want):
                assert g.dtype == BF
                assert np.abs(_np(g) - _np(w)).max() <= 2.0 ** -7 * np.abs(_np(w)).max(), (D, H)
                assert _rel_l2(g, w) <= BF16_STEP_REL_L2, (D, H)
        controls = {"x @ W + b rounded": emulated_step(*args, round_xw=True),
                    "h' from the rounded c'": emulated_step(*args, round_c_first=True)}
        for what, outs in controls.items():
            err = max(_rel_l2(g, w) for g, w in zip(outs, want))
            assert err > BF16_STEP_REL_L2, f"D{D}-H{H}: the {what} control lands inside: {err:.3e}"


def test_emulated_xp_step_matches_row_31():
    """At H 32 and 64, S xp (no x segment, xp added in the epilogue) within
    L_H_ATOL and C_ATOL of _lstm_recurrent_kernel (interpret mode) and of
    its plain version."""
    for H in (32, 64):
        rng = np.random.RandomState(H)
        arrays = [rng.randn(B, 4 * H).astype(np.float32),
                  (0.5 * np.tanh(rng.randn(B, H))).astype(np.float32),
                  rng.randn(B, H).astype(np.float32),
                  (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)]
        args = [torch.from_numpy(a.copy()) for a in arrays]
        want = fused_lstm._lstm_recurrent_pallas(*(jnp.asarray(a) for a in arrays), "tanh", True)
        got = emulated_step_xp(*args)
        for ref in (want, port_step.lstm_recurrent_step_reference(*args)):
            for g, w, tol in zip(got, ref, (L_H_ATOL, C_ATOL)):
                assert np.abs(_np(g) - _np(w)).max() <= tol, H


def gather_unit(cl):
    """csrc/gemm_tc.cuh::gather_unit: tile column cl's unit from the
    tile's first."""
    return (cl >> 5) * 8 + (cl & 7)


def gather_gate(cl):
    return (cl >> 3) & 3


def test_gathered_gate_columns():
    """For each tile of STEP_TILES: its 4 units columns are the four gate
    columns of its own units, each once; a warp's four n-tiles of 8 columns
    are gates i, f, g, o of the same 8 units (so each thread's fragments hold
    one (row, unit) pair's four gates); the step computed tile by tile
    through that gather, then the epilogue on each pair, equals the plain
    step."""
    H, D = 64, 13
    x, h, c, w_, b, u = (torch.from_numpy(a.copy()).double() for a in _inputs(D, H, 3))
    xh, wu = torch.cat([x, h], 1), torch.cat([w_, u], 0)
    want_h, want_c = float64_step(x, h, c, w_, b, u)
    for rows, units in _layout.STEP_TILES:
        n = 4 * units
        cols = [(gather_unit(cl), gather_gate(cl)) for cl in range(n)]
        assert sorted(cols) == [(u, q) for u in range(units) for q in range(4)]
        for w in range(n // 32):
            for nt in range(4):
                block = cols[32 * w + 8 * nt:32 * w + 8 * nt + 8]
                assert [q for _, q in block] == [nt] * 8
                assert [u for u, _ in block] == list(range(8 * w, 8 * w + 8))
        gates = torch.full((B, 4 * H), float("nan"), dtype=torch.float64)
        for m0 in range(0, B, rows):
            for u0 in range(0, H, units):
                idx = [q * H + u0 + uo for uo, q in cols]
                gates[m0:m0 + rows, idx] = xh[m0:m0 + rows] @ wu[:, idx]
        got = _cell((gates + b).float(), c.float(), "tanh", torch.float32)
        assert np.abs(_np(got[0]) - _np(want_h)).max() <= 1e-6, (rows, units)
        assert np.abs(_np(got[1]) - _np(want_c)).max() <= 1e-6, (rows, units)


# the paths' shapes: the notes head's cells (D = 61, D = H), the velocity
# (D = 1) and instrument (D = 16) heads, S xp (D = 0); B = 256, one song's
# 16 and a ragged 5; H = 256 and 512
PLAN_CASES = [(Bn, D, H) for H in (256, 512) for Bn in (256, 16, 5) for D in (61, H, 1, 16, 0)]
# (B, D, H, operand bytes) -> the tiles (rows, units) the H100 ran within
# 10 % of the faster tile's device time (CUDA-graph replay of 64 launches):
# python -m midi_vae_tpu_torch.tools.time_s_and_a --only tiles
NEAR_BEST_TILES = {
    (256, 61, 256, 4): {(32, 8)},
    (256, 256, 256, 4): {(32, 8)},
    (256, 1, 256, 4): {(32, 8)},
    (256, 16, 256, 4): {(32, 8)},
    (256, 61, 256, 2): {(32, 8), (64, 16)},
    (256, 256, 256, 2): {(32, 8), (64, 16)},
    (256, 1, 256, 2): {(32, 8), (64, 16)},
    (256, 16, 256, 2): {(32, 8), (64, 16)},
    (256, 0, 256, 4): {(32, 8)},
    (256, 61, 512, 4): {(32, 8), (64, 16)},
    (256, 512, 512, 4): {(32, 8), (64, 16)},
    (256, 1, 512, 4): {(32, 8), (64, 16)},
    (256, 16, 512, 4): {(32, 8), (64, 16)},
    (256, 61, 512, 2): {(64, 16)},
    (256, 512, 512, 2): {(64, 16)},
    (256, 1, 512, 2): {(64, 16)},
    (256, 16, 512, 2): {(64, 16)},
    (256, 0, 512, 4): {(32, 8)},
    (16, 61, 256, 4): {(32, 8)},
    (16, 256, 256, 4): {(32, 8)},
    (16, 1, 256, 4): {(32, 8)},
    (16, 16, 256, 4): {(32, 8)},
    (16, 61, 256, 2): {(32, 8), (64, 16)},
    (16, 256, 256, 2): {(32, 8), (64, 16)},
    (16, 1, 256, 2): {(32, 8), (64, 16)},
    (16, 16, 256, 2): {(32, 8), (64, 16)},
    (16, 0, 256, 4): {(32, 8)},
    (16, 61, 512, 4): {(32, 8)},
    (16, 512, 512, 4): {(32, 8)},
    (16, 1, 512, 4): {(32, 8)},
    (16, 16, 512, 4): {(32, 8)},
    (16, 61, 512, 2): {(32, 8), (64, 16)},
    (16, 512, 512, 2): {(32, 8)},
    (16, 1, 512, 2): {(32, 8)},
    (16, 16, 512, 2): {(32, 8)},
    (16, 0, 512, 4): {(32, 8)},
    (5, 61, 256, 4): {(32, 8)},
    (5, 256, 256, 4): {(32, 8)},
    (5, 1, 256, 4): {(32, 8)},
    (5, 16, 256, 4): {(32, 8)},
    (5, 61, 256, 2): {(32, 8), (64, 16)},
    (5, 256, 256, 2): {(32, 8), (64, 16)},
    (5, 1, 256, 2): {(32, 8), (64, 16)},
    (5, 16, 256, 2): {(32, 8), (64, 16)},
    (5, 0, 256, 4): {(32, 8)},
    (5, 61, 512, 4): {(32, 8)},
    (5, 512, 512, 4): {(32, 8)},
    (5, 1, 512, 4): {(32, 8)},
    (5, 16, 512, 4): {(32, 8)},
    (5, 61, 512, 2): {(32, 8)},
    (5, 512, 512, 2): {(32, 8)},
    (5, 1, 512, 2): {(32, 8)},
    (5, 16, 512, 2): {(32, 8)},
    (5, 0, 512, 4): {(32, 8)},
}


@pytest.mark.parametrize("Bn, D, H", PLAN_CASES, ids=[f"B{c[0]}-D{c[1]}-H{c[2]}" for c in PLAN_CASES])
def test_step_plan_at_the_paths_shapes(Bn, D, H):
    """The plan (float32 operands, and bf16 for S) is a tile the card ran
    within 10 % of the faster tile's time at this shape; the plan's tile is
    one of the kernel's, its ring what the kernel allocates (under the 48
    KiB a launch takes unasked), its grid H / units x ceil(B / rows); the
    wrapper's cached pick is the plan's."""
    for elem in (4, 2) if D else (4,):
        plan = _layout.step_plan(Bn, D, H, elem)
        assert (plan.rows, plan.units) in NEAR_BEST_TILES[Bn, D, H, elem], elem
        assert _layout.STEP_TILES[plan.tile] == (plan.rows, plan.units)
        assert plan.smem == _layout.step_smem(plan.rows, plan.units) <= 48 * 1024
        assert plan.threads == 8 * plan.units
        assert plan.blocks == -(-Bn // plan.rows) * (H // plan.units)
        assert port_step._tile(Bn, D, H, elem) == plan.tile


def test_step_limits():
    """S takes H a multiple of 32 up to STEP_MAX_H; S xp the same."""
    for build in _layout.STEP_BUILDS:
        assert _layout.launch_limit(build, 256, 0) is None
        assert "multiple of 32" in _layout.launch_limit(build, 48, 0)
        assert "up to 512" in _layout.launch_limit(build, 1024, 0)
    with pytest.raises(_layout.LaunchLimitError):
        _layout.step_plan(16, 61, 1024)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_wrappers_run_their_plain_versions_on_cpu(bf16):
    """lstm_cell_step_fwd and lstm_recurrent_step_fwd take their plain
    versions for CPU tensors, count no launch and check their operands."""
    dt = BF if bf16 else torch.float32
    x, h, c, w, b, u = (torch.from_numpy(a.copy()).to(dt) for a in _inputs(13, 32, 5))
    before = (port_step.lstm_cell_step_fwd.launches, port_step.lstm_cell_step_fwd.launches_bf16,
              port_step.lstm_recurrent_step_fwd.launches)
    got = port_step.lstm_cell_step_fwd(x, h, c, w, b, u)
    for g, want in zip(got, port_step.lstm_cell_step_reference(x, h, c, w, b, u)):
        assert g.dtype == dt and torch.equal(g, want)
    xp = torch.randn(B, 128)
    got = port_step.lstm_recurrent_step_fwd(xp, h.float(), c.float(), u.float())
    for g, want in zip(got, port_step.lstm_recurrent_step_reference(xp, h.float(), c.float(),
                                                                    u.float())):
        assert torch.equal(g, want)
    assert before == (port_step.lstm_cell_step_fwd.launches,
                      port_step.lstm_cell_step_fwd.launches_bf16,
                      port_step.lstm_recurrent_step_fwd.launches)
    with pytest.raises(ValueError, match="u has shape"):
        port_step.lstm_cell_step_fwd(x, h, c, w, b, u[:, :64])
    with pytest.raises(ValueError, match="unsupported LSTM kernel activation"):
        port_step.lstm_cell_step_fwd(x, h, c, w, b, u, "elu")
