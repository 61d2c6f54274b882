"""CPU tests of kernel A's two phases (``midi_vae_tpu_torch/csrc/
gru_layer_fwd.cu``): the x @ W pre-pass (``gru_xproj_reference``: xp in
float32, L's pre-pass, ``csrc/xproj.cuh``) followed by the GRU forward chain
over that xp (``gru_fwd_chain_reference``; on the card the chain of
``csrc/gru_cell_fwd.cuh``), composed, against the JAX package's
``_fwdx_pallas`` (the h sequence, row 1) and ``_fwdx_last_pallas`` (the
final h, row 2) in interpret mode; the chain's cluster plans
(``ops/_layout.py::gru_fwd_plan``) and A's route (``gru_fwd_route``); the
phase wrappers' CPU paths.

Sizes: T 8, B 16, H 32 or 64, D 1, 5, 13 and 61; the JAX references run once
per case in module-scoped fixtures. Tolerances:
- float32: atol 1e-5 + rtol 1e-4 (``tests/test_torch_lstm_fwdx_chain.py``);
- bf16 over T steps: one bf16 step at the largest entry and FLIP_REL_L2 =
  1.7e-3 relative L2 (a rounding flip of an early h carries on); one step
  from a random state STEP_REL_L2 = 1e-4 (``chip_smoke.py``'s
  BF16_STEP_REL_L2: what is left is a flip where float32 sums taken in
  another order straddle a bf16 boundary; a flip of the first of two steps
  spreads through U into the second's row, 3.7e-4 on one seed);
- the controls, each over STEP_REL_L2 on that step: the chain over xp
  rounded to bf16 (``_fwdx_kernel`` adds x @ W + b unrounded), and the
  chain with P2 over r * h rounded to bf16 (r * h is float there: a bf16
  product of it would change the numbers);
- the pre-pass against a float64 x @ W + b: float32 sums, atol 1e-6 of the
  largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from midi_vae_tpu.ops import fused_train as ft
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import gru_layer as port_layer

BF = torch.bfloat16
ATOL, RTOL = 1e-5, 1e-4
STEP_REL_L2 = 1e-4
FLIP_REL_L2 = 1.7e-3
T, B = 8, 16


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


def _inputs(D, H, seed, steps=T, state=0.0):
    """x (steps, B, D) in [0, 1), h0 (zero, or random at ``state``), W, b, U;
    numpy float32."""
    rng = np.random.RandomState(seed)
    return [rng.rand(steps, B, D).astype(np.float32),
            (state * np.tanh(rng.randn(B, H))).astype(np.float32),
            (rng.randn(D, 3 * H) / np.sqrt(D)).astype(np.float32),
            (0.1 * rng.randn(3 * H)).astype(np.float32),
            (rng.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32)]


def _pairs(arrays, bf16):
    """numpy arrays -> (jnp arrays, torch tensors), bf16 rounded alike."""
    jdt, tdt = (jnp.bfloat16, BF) if bf16 else (jnp.float32, torch.float32)
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a.copy()).to(tdt) for a in arrays])


def _composed(x, h0, w, b, u, act, rs):
    """The pre-pass's plain version, then the chain's."""
    xp = port_layer.gru_xproj_reference(x, w, b)
    assert xp.dtype == torch.float32 and xp.shape == (x.shape[0], x.shape[1], u.shape[1])
    return port_layer.gru_fwd_chain_reference(xp, h0, u, act, rs)


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


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def row_refs(request):
    """(bf16, torch inputs of the sequence case, _fwdx_pallas's sequence,
    torch inputs of the final-h case, _fwdx_last_pallas's h) in interpret
    mode; D = 5 and 1 in bf16 are the JAX wrapper's cast_x case."""
    bf16, D, H = request.param
    (jx, jh0, jw, jb, ju), seq_args = _pairs(_inputs(D, H, 10 * D + H), bf16)
    seq = ft._fwdx_pallas(jx, jh0, jw, jb, ju, "tanh", True)
    (jx, jh0, jw, jb, ju), last_args = _pairs(_inputs(D, H, 7 * D + H, state=0.5), bf16)
    last = ft._fwdx_last_pallas(jx, jh0, jw, jb, ju, "tanh", True)
    return bf16, seq_args, seq, last_args, last


def test_phases_compose_to_row_1(row_refs):
    """Pre-pass + chain with the h sequence (the training forward's
    residual) against _fwdx_pallas in interpret mode."""
    bf16, targs, want, _, _ = row_refs
    got = _composed(*targs, "tanh", True)
    assert got.dtype == targs[0].dtype and got.shape == (T, B, targs[4].shape[0])
    _assert_layer(got, want, bf16, "h sequence")
    assert torch.equal(got, port_layer.gru_layer_reference(*targs, "tanh", True))


def test_phases_compose_to_row_2(row_refs):
    """Pre-pass + chain emitting only the final h (emit_seq = 0: serving,
    the branches, the judges) against _fwdx_last_pallas in interpret mode."""
    bf16, _, _, targs, want = row_refs
    got = _composed(*targs, "tanh", False)
    assert got.shape == (B, targs[4].shape[0]) and got.dtype == targs[0].dtype
    _assert_layer(got, want, bf16, "final h")


@pytest.mark.parametrize("activation", ["sigmoid", "relu"])
def test_phases_compose_for_other_activations(activation):
    """The chain takes gru_layer's three cell activations: the composition
    against the plain layer and against the JAX scan
    (_gru_layer_reference_x) with that activation."""
    targs = [torch.from_numpy(a) for a in _inputs(13, 32, 3, state=0.5)]
    got = _composed(*targs, activation, True)
    assert torch.equal(got, port_layer.gru_layer_reference(*targs, activation, True))
    jargs = [jnp.asarray(_np(t)) for t in targs]
    want = ft._gru_layer_reference_x(*jargs, ft._activation(activation), True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def _chain_rh_rounded(xp, h0, u):
    """The chain with P2 over r * h rounded to bf16 (the control): as
    ``gru_step_xp`` but (r * h) enters (r * h) @ U[:, 2H:] rounded."""
    H = h0.shape[-1]
    h, seq = h0, []
    u = u.float()
    for x_t in xp:
        hf = h.float()
        hu = hf @ u[:, : 2 * H]
        z = torch.sigmoid(x_t[:, :H] + hu[:, :H])
        r = torch.sigmoid(x_t[:, H : 2 * H] + hu[:, H:])
        hh = torch.tanh(x_t[:, 2 * H :] + (r * hf).to(BF).float() @ u[:, 2 * H :])
        h = (z * hf + (1.0 - z) * hh).to(h0.dtype)
        seq.append(h)
    return torch.stack(seq)


@pytest.fixture(scope="module")
def one_step_refs():
    """{D: (torch bf16 inputs, _fwdx_pallas's step from a random bf16
    state)}, interpret mode."""
    out = {}
    for D in (61, 13, 5, 1):
        (jx, jh0, jw, jb, ju), targs = _pairs(_inputs(D, 64, 20 + D, steps=1, state=0.5), True)
        out[D] = targs, ft._fwdx_pallas(jx, jh0, jw, jb, ju, "tanh", True)
    return out


@pytest.mark.parametrize("D", [61, 13, 5, 1])
def test_bf16_chain_reads_float_xp_and_float_rh(D, one_step_refs):
    """On one step from a random bf16 state the composition lands within
    STEP_REL_L2 of _fwdx_pallas; the two controls, the chain over xp
    rounded to bf16 and the chain with r * h rounded before P2, land over
    it."""
    (x, h0, w, b, u), want = one_step_refs[D]
    xp = port_layer.gru_xproj_reference(x, w, b)
    got = port_layer.gru_fwd_chain_reference(xp, h0, u, "tanh", True)
    err = _rel_l2(got, want)
    assert err <= STEP_REL_L2, f"the chain over the float32 xp: {err:.3e}"
    controls = {"xp rounded": port_layer.gru_fwd_chain_reference(xp.to(BF).float(), h0, u, "tanh",
                                                                 True),
                "r*h rounded": _chain_rh_rounded(xp, h0, u)}
    for what, seq in controls.items():
        control = _rel_l2(seq, want)
        assert control > STEP_REL_L2, f"the {what} control lands inside: {control:.3e}"


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_pre_pass_plain_version(bf16):
    """xp = x @ W + b in float32 from the operands widened, against float64."""
    x, _, w, b, _ = _pairs(_inputs(61, 32, 5), bf16)[1]
    xp = port_layer.gru_xproj_reference(x, w, b)
    want = (x.double().reshape(-1, 61) @ w.double() + b.double()).reshape(T, B, -1)
    assert xp.dtype == torch.float32
    assert (xp.double() - want).abs().max() <= 1e-6 * want.abs().max()


# (build, H): the cluster size and whether the slice streams: the smallest
# cluster whose resident slice takes at most half of a block's shared memory
# (float32 at 256: 96 KiB in 8; bf16: 96 KiB in 4 at 256, in 16 at 512);
# float32 at 512 streams its 192 KiB slice in clusters of 16
A_CLUSTERS = {("A_chain", 256): (8, False), ("A_chain", 512): (16, True),
              ("A_chain_bf16", 256): (4, False), ("A_chain_bf16", 512): (16, False)}
PLAN_CASES = [(build, H, Bn) for build, H in A_CLUSTERS for Bn in (5, 16, 128, 256, 512)]


@pytest.mark.parametrize("build, H, Bn", PLAN_CASES,
                         ids=[f"{c[0]}-H{c[1]}-B{c[2]}" for c in PLAN_CASES])
def test_a_chain_plans(build, H, Bn):
    """A's chain plan at the paths' shapes: the cluster; rows from B over
    the card's active clusters, bounded by what fits (in bf16 also by P1's
    items a warp); the splits share the depth (a power of two, at most 512
    threads, dividing H or the streamed chunk); the ring takes 2 to 8
    chunks, no more than a phase's; the whole fits a block's 227 KB."""
    plan = _layout.gru_fwd_plan(build, H, Bn)
    C, stream = A_CLUSTERS[(build, H)]
    assert (plan.cluster, plan.stages > 0) == (C, stream)
    elem, Hc = (2 if build.endswith("_bf16") else 4), H // C
    assert plan.smem == _layout.gru_chain_smem(H, C, plan.rows, plan.splits, plan.stages, elem)
    assert plan.smem <= _layout.SMEM_PER_BLOCK
    assert plan.clusters == -(-Bn // plan.rows)
    tiles = Hc * -(-plan.rows // 8)
    S = plan.splits
    assert S & (S - 1) == 0 and tiles * S <= _layout.CHAIN_THREADS
    assert (_layout.GRU_CHUNK if stream else H) % S == 0
    if stream:
        assert 3 * Hc * H * 4 > _layout.SMEM_PER_BLOCK // 2
        assert 2 <= plan.stages <= min(8, H // _layout.GRU_CHUNK)
    else:
        assert 3 * Hc * H * elem <= _layout.SMEM_PER_BLOCK // 2
    if elem == 2:  # P1 on the tensor cores: (m-tile, 8 units) items, 32 units a CTA at least
        assert Hc % 32 == 0
        assert -(-plan.rows // 16) * (Hc // 8) <= _layout.FWD_MAX_ITEMS * _layout.CHAIN_WARPS
    want_rows = -(-Bn // _layout.MAX_CLUSTERS_H100[C])
    assert plan.rows == want_rows or _layout.gru_chain_smem(
        H, C, plan.rows + 1, 1, 2 if stream else 0, elem) > _layout.SMEM_PER_BLOCK


def test_a_chain_plan_at_the_default_width():
    """Config()'s encoder at B = 256 (float32, H = 256): 15 clusters of 8
    CTAs, 18 rows each, their 96 tiles of 8 rows in 4 depth splits."""
    plan = _layout.gru_fwd_plan("A_chain", 256, 256)
    assert (plan.cluster, plan.rows, plan.clusters, plan.splits, plan.stages) == (8, 18, 15, 4, 0)


@pytest.mark.parametrize("H, D, bf16, route", [(256, 61, False, "chain"), (512, 1, False, "chain"),
                                               (256, 16, True, "chain"), (512, 61, True, "chain"),
                                               (96, 61, False, "chain"), (544, 61, False, "block"),
                                               (544, 13, True, "block")])
def test_a_route(H, D, bf16, route):
    """The chain where its slice fits a cluster (or, float32, streams);
    else, picked before any launch, A's per-block route where its block
    launches (H = 544: 17 x 32 units, no 16-byte copies at 16 CTAs, too
    wide a slice below); neither: LaunchLimitError naming both limits."""
    assert _layout.gru_fwd_route(H, D, bf16) == route
    assert _layout.a_limit(H, D, bf16) is None
    build = "A_chain_bf16" if bf16 else "A_chain"
    assert (_layout.gru_fwd_limit(build, H) is None) == (route == "chain")
    assert (_layout.launch_limit(build, H, 0) is None) == (route == "chain")


def test_a_launches_on_no_route():
    """H = 1056: no cluster holds its slice (33 x 32 units) and 1056 threads
    of 90 registers do not fit an SM (no block): the limit names both, and
    the training step's chooser finds no route there."""
    with pytest.raises(_layout.LaunchLimitError, match="neither on its chain"):
        _layout.gru_fwd_route(1056, 61)
    why = _layout.a_limit(1056, 61)
    assert "slice of U" in why and "registers" in why
    assert any("neither on its chain" in w
               for w in _layout._route_limits("narrow", 1056, [(61, False)], [], "GRU"))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_phase_wrappers_run_their_plain_versions_on_cpu(bf16):
    """gru_layer_xproj, gru_layer_fwd_chain and gru_layer_block (and
    gru_layer, through them) take their plain versions for CPU tensors (no
    launch counted) and check shapes and activations."""
    x, h0, w, b, u = _pairs(_inputs(13, 32, 9, state=0.5), bf16)[1]
    counters = [(getattr(port_layer, f), a) for f in port_layer.A_PHASES
                for a in ("launches", "launches_bf16")]
    before = [getattr(f, a) for f, a in counters]
    xp = port_layer.gru_layer_xproj(x, w, b)
    assert torch.equal(xp, port_layer.gru_xproj_reference(x, w, b))
    for rs in (True, False):
        want = port_layer.gru_fwd_chain_reference(xp, h0, u, "tanh", rs)
        for got in (port_layer.gru_layer_fwd_chain(xp, h0, u, "tanh", rs),
                    port_layer.gru_layer_block(x, h0, w, b, u, "tanh", rs),
                    port_layer.gru_layer(x, h0, w, b, u, "tanh", rs)):
            assert torch.equal(got, want)
    assert before == [getattr(f, a) for f, a in counters]
    with pytest.raises(ValueError, match="u has shape"):
        port_layer.gru_layer_fwd_chain(xp, h0, u[:, :64])
    with pytest.raises(ValueError, match="unsupported GRU kernel activation"):
        port_layer.gru_layer_fwd_chain(xp, h0, u, "softmax")
    with pytest.raises(ValueError, match="b has shape"):
        port_layer.gru_layer_xproj(x, w, b[:8])
    with pytest.raises(ValueError, match="xp has shape"):
        port_layer.gru_layer_fwd_chain(xp[..., :-3], h0, u)
