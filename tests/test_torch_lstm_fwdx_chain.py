"""CPU tests of kernel L's two phases (``midi_vae_tpu_torch/csrc/
lstm_layer_fwd.cu``): the x @ W pre-pass (``lstm_xproj_reference``: xp in
float32) followed by the forward chain over that xp
(``lstm_fwd_chain_reference``; on the card the chain of
``csrc/lstm_cell_fwd.cuh``), composed, against the JAX package's
``_lstm_fwdx_pallas`` (the h and c sequences, rows 19) and
``_lstm_fwdx_last_pallas`` (the final h, row 21) in interpret mode; the
chain's cluster plans for L's builds and L's route
(``ops/_layout.py::lstm_fwd_route``); the phase wrappers' CPU paths.

Sizes: T 8, B 16, H 32 or 64, D 1, 5, 13 (and 61). Tolerances:
- float32: atol 1e-5 + rtol 1e-4 (``tests/test_torch_lstm_train.py``);
- bf16 over T steps: one bf16 step at the largest entry and FLIP_REL_L2 =
  1.7e-3 relative L2 (``tests/test_torch_bf16_wide.py``: a rounding flip of
  an early h carries on); over two steps from a random state REL_L2 = 3e-4
  (what is left is a flip where float32 sums taken in another order
  straddle a bf16 boundary);
- the control: the chain over xp rounded to bf16 (Q's input, not L's:
  ``_lstm_fwdx_kernel`` adds x @ W + b to h @ U unrounded) must land over
  REL_L2 on those two steps;
- the pre-pass against a float64 x @ W + b: float32 sums, atol 1e-6 of
  the largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.ops import fused_train as ft
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import lstm_layer as port_layer

BF = torch.bfloat16
ATOL, RTOL = 1e-5, 1e-4
REL_L2 = 3e-4
FLIP_REL_L2 = 1.7e-3
T, B = 8, 16


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel_l2(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _inputs(D, H, seed, steps=T, state=0.0):
    """x (steps, B, D) in [0, 1), h0, c0 (zero, or random at ``state``), W,
    b, U; numpy float32."""
    rng = np.random.RandomState(seed)
    return [rng.rand(steps, B, D).astype(np.float32),
            (state * np.tanh(rng.randn(B, H))).astype(np.float32),
            (state * rng.randn(B, H)).astype(np.float32),
            (rng.randn(D, 4 * H) / np.sqrt(D)).astype(np.float32),
            (0.1 * rng.randn(4 * H)).astype(np.float32),
            (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)]


def _pairs(arrays, bf16):
    """numpy arrays -> (jnp arrays, torch tensors), bf16 rounded alike."""
    jdt, tdt = (jnp.bfloat16, BF) if bf16 else (jnp.float32, torch.float32)
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a.copy()).to(tdt) for a in arrays])


def _composed(x, h0, c0, w, b, u, act, rs, with_c=False):
    """The pre-pass's plain version, then the chain's."""
    xp = port_layer.lstm_xproj_reference(x, w, b)
    assert xp.dtype == torch.float32 and xp.shape == (x.shape[0], x.shape[1], u.shape[1])
    return port_layer.lstm_fwd_chain_reference(xp, h0, c0, u, act, rs, with_c)


def _assert_layer(got, want, bf16, what):
    if bf16:
        g, w = _np(got), _np(want)
        assert np.abs(g - w).max() <= 2.0 ** -7 * max(np.abs(w).max(), 1e-30), what
        err = _rel_l2(got, want)
        assert err <= FLIP_REL_L2, f"{what}: relative L2 {err:.3e}"
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL, err_msg=what)


CASES = [(bf16, D, H) for bf16 in (False, True) for D, H in ((13, 32), (5, 64), (1, 32), (61, 64))]
IDS = [f"{'bf16' if c[0] else 'f32'}-D{c[1]}-H{c[2]}" for c in CASES]


@pytest.mark.parametrize("bf16, D, H", CASES, ids=IDS)
def test_phases_compose_to_row_19(bf16, D, H):
    """Pre-pass + chain with the h and c sequences (the training forward's
    residuals) against _lstm_fwdx_pallas in interpret mode; D = 5 and 1 in
    bf16 are its cast_x case (D < 8: x and W widened, the same products)."""
    (jx, jh0, jc0, jw, jb, ju), targs = _pairs(_inputs(D, H, 10 * D + H), bf16)
    jh, jc = ft._lstm_fwdx_pallas(jx, jh0, jc0, jw, jb, ju, "tanh", True)
    hseq, cseq = _composed(*targs, "tanh", True, True)
    assert hseq.dtype == cseq.dtype == targs[0].dtype and hseq.shape == (T, B, H)
    _assert_layer(hseq, jh, bf16, "h sequence")
    _assert_layer(cseq, jc, bf16, "c sequence")
    assert torch.equal(hseq, port_layer.lstm_layer_reference(*targs, "tanh", True))


@pytest.mark.parametrize("bf16, D, H", CASES, ids=IDS)
def test_phases_compose_to_row_21(bf16, D, H):
    """Pre-pass + chain emitting only the final h (emit_seq = 0: serving,
    row 21) against _lstm_fwdx_last_pallas in interpret mode."""
    (jx, jh0, jc0, jw, jb, ju), targs = _pairs(_inputs(D, H, 7 * D + H, state=0.5), bf16)
    want = ft._lstm_fwdx_last_pallas(jx, jh0, jc0, jw, jb, ju, "tanh", True)
    got = _composed(*targs, "tanh", False)
    assert got.shape == (B, H) and got.dtype == targs[0].dtype
    _assert_layer(got, want, bf16, "final h")


@pytest.mark.parametrize("activation", ["sigmoid", "relu"])
def test_phases_compose_for_other_activations(activation):
    """The chain's float32 build takes lstm_layer's three cell activations:
    the composition against the plain layer and against the JAX scan
    (_lstm_layer_reference_x) with that activation."""
    targs = [torch.from_numpy(a) for a in _inputs(13, 32, 3)]
    got = _composed(*targs, activation, True)
    assert torch.equal(got, port_layer.lstm_layer_reference(*targs, activation, True))
    jargs = [jnp.asarray(_np(t)) for t in targs]
    want = ft._lstm_layer_reference_x(*jargs, ft._activation(activation), True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("D", [61, 13, 5, 1])
def test_bf16_chain_reads_float_xp(D):
    """On two steps from a random bf16 state, the composition lands within
    REL_L2 of _lstm_fwdx_pallas (h and c); the control, the chain over xp
    rounded to bf16 first, lands over it."""
    H = 64
    (jx, jh0, jc0, jw, jb, ju), (x, h0, c0, w, b, u) = _pairs(
        _inputs(D, H, 20 + D, steps=2, state=0.5), True)
    jh, jc = ft._lstm_fwdx_pallas(jx, jh0, jc0, jw, jb, ju, "tanh", True)
    xp = port_layer.lstm_xproj_reference(x, w, b)
    hs, cs = port_layer.lstm_fwd_chain_reference(xp, h0, c0, u, "tanh", True, True)
    err = max(_rel_l2(hs, jh), _rel_l2(cs, jc))
    assert err <= REL_L2, f"the chain over the float32 xp: {err:.3e}"
    hr, cr = port_layer.lstm_fwd_chain_reference(xp.to(BF).float(), h0, c0, u, "tanh", True, True)
    control = max(_rel_l2(hr, jh), _rel_l2(cr, jc))
    assert control > REL_L2, f"the xp-rounded control lands inside: {control:.3e}"


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_pre_pass_plain_version(bf16):
    """xp = x @ W + b in float32 from the operands widened, against float64."""
    x, _, _, w, b, _ = _pairs(_inputs(61, 32, 5), bf16)[1]
    xp = port_layer.lstm_xproj_reference(x, w, b)
    want = (x.double().reshape(-1, 61) @ w.double() + b.double()).reshape(T, B, -1)
    assert xp.dtype == torch.float32
    assert (xp.double() - want).abs().max() <= 1e-6 * want.abs().max()


# (build, H): the cluster sizes, as Q's and Q bf16's (the xp tile of L's
# bf16 chain fits beside the slice)
L_CLUSTERS = {("L_chain", 256): (8, False), ("L_chain", 512): (16, True),
              ("L_chain_bf16", 256): (4, False), ("L_chain_bf16", 512): (16, False)}
PLAN_CASES = [(build, H, Bn) for build, H in L_CLUSTERS for Bn in (5, 256, 512)]


@pytest.mark.parametrize("build, H, Bn", PLAN_CASES,
                         ids=[f"{c[0]}-H{c[1]}-B{c[2]}" for c in PLAN_CASES])
def test_l_chain_plans(build, H, Bn):
    """L's float32 chain takes Q's plan; its bf16 chain Q bf16's cluster
    with the float xp tile (rows x (4 Hc + XS_PAD) floats) counted in its
    shared memory, which caps its rows at what fits."""
    plan = _layout.fwd_plan(build, H, Bn)
    assert (plan.cluster, plan.stages > 0) == L_CLUSTERS[(build, H)]
    assert plan.smem <= _layout.SMEM_PER_BLOCK and plan.clusters == -(-Bn // plan.rows)
    if build == "L_chain":
        assert plan == _layout.fwd_plan("Q", H, Bn)
        return
    q = _layout.fwd_plan("Q_bf16", H, Bn)
    Hc = H // plan.cluster
    assert plan.cluster == q.cluster and plan.rows <= q.rows and plan.splits == 1
    assert plan.smem == (_layout.fwd_chain_smem(H, plan.cluster, plan.rows, 1, 0, 2)
                         + plan.rows * (4 * Hc + _layout.XS_PAD) * 4)
    assert _layout.fwd_chain_smem(H, plan.cluster, plan.rows + 1, 1, 0, 2, True) > \
        _layout.SMEM_PER_BLOCK or plan.rows == min(-(-Bn // _layout.MAX_CLUSTERS_H100[q.cluster]),
                                                   _layout.FWD_MAX_ROWS_MMA)


@pytest.mark.parametrize("H, D, bf16, route", [(256, 61, False, "chain"), (512, 1, False, "chain"),
                                               (256, 16, True, "chain"), (512, 61, True, "chain"),
                                               (96, 61, False, "block"), (192, 13, True, "block"),
                                               (320, 5, True, "block")])
def test_l_route(H, D, bf16, route):
    """The chain where it launches (H a multiple of 64 in float32, of 128 in
    bf16); else, picked before any launch, L's per-block route where its
    block launches; neither: LaunchLimitError naming both limits."""
    assert _layout.lstm_fwd_route(H, D, bf16) == route
    assert _layout.l_limit(H, D, bf16) is None
    assert (_layout.fwd_limit("L_chain_bf16" if bf16 else "L_chain", H) is None) == (route == "chain")


def test_l_launches_on_no_route():
    """H = 1056: not a multiple of 64 (no chain) and 1056 threads of 88
    registers do not fit an SM (no block): the limit names both."""
    with pytest.raises(_layout.LaunchLimitError, match="neither on its chain"):
        _layout.lstm_fwd_route(1056, 61)
    why = _layout.l_limit(1056, 61)
    assert "multiple of 64" in why and "registers" in why
    assert any("neither on its chain" in w
               for w in _layout._route_limits("narrow", 1056, [(61, False)], [], "LSTM"))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_phase_wrappers_run_their_plain_versions_on_cpu(bf16):
    """lstm_layer_xproj, lstm_layer_fwd_chain and lstm_layer_block take
    their plain versions for CPU tensors (no launch counted) and check
    shapes and activations."""
    x, h0, c0, w, b, u = _pairs(_inputs(13, 32, 9, state=0.5), bf16)[1]
    counters = [(getattr(port_layer, f), a) for f in port_layer.L_PHASES
                for a in ("launches", "launches_bf16")]
    before = [getattr(f, a) for f, a in counters]
    xp = port_layer.lstm_layer_xproj(x, w, b)
    assert torch.equal(xp, port_layer.lstm_xproj_reference(x, w, b))
    for rs, with_c in ((True, True), (True, False), (False, False)):
        got = port_layer.lstm_layer_fwd_chain(xp, h0, c0, u, "tanh", rs, with_c)
        want = port_layer.lstm_fwd_chain_reference(xp, h0, c0, u, "tanh", rs, with_c)
        blk = port_layer.lstm_layer_block(x, h0, c0, w, b, u, "tanh", rs, with_c)
        for g, wt, k in zip(*((t if with_c else (t,)) for t in (got, want, blk))):
            assert torch.equal(g, wt) and torch.equal(k, wt)
    assert before == [getattr(f, a) for f, a in counters]
    with pytest.raises(ValueError, match="u has shape"):
        port_layer.lstm_layer_fwd_chain(xp, h0, c0, u[:, :64])
    with pytest.raises(ValueError, match="unsupported LSTM kernel activation"):
        port_layer.lstm_layer_fwd_chain(xp, h0, c0, u, "softmax")
    with pytest.raises(ValueError, match="b has shape"):
        port_layer.lstm_layer_xproj(x, w, b[:8])
