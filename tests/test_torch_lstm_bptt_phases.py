"""CPU tests of the LSTM backward's three phases (kernels N and R,
``midi_vae_tpu_torch/csrc/lstm_cell_bwd.cuh``): the plain versions of the
gate pre-pass (``lstm_bwd_gates_reference``), of the chain over its
activations (``lstm_bwd_chain_reference``) and of N's dx pass
(``lstm_bwd_dx_reference``), composed, against the ops' plain versions
(``lstm_layer_bwd_reference``, ``lstm_layer_xp_bwd_reference``) and against
the JAX pairs in interpret mode (``_lstm_bwdx_pallas``, ``_lstm_bwd_pallas``,
``_lstm_bwd_wide_pallas``), in float32 and bf16; the phase wrappers' CPU
paths; and the chain's cluster plan (``ops/_layout.py::bptt_plan``).

Both sides read the same forward sequences (JAX's own, from
``_lstm_fwdx_pallas`` / ``_lstm_fwd_pallas`` in interpret mode), so nothing
the forward rounds differs. Tolerances:
- the composition against the ops' plain versions: the same arithmetic,
  but the pre-pass takes h_prev @ U over all T*B rows in one product where
  the op's plain version takes it step by step, so the CPU may sum in
  another order: float32 max|diff| <= COMPOSE_RTOL = 1e-6 of the largest
  entry; in bf16 the float32 gate grads the same, the outputs rounded to
  bf16 (dx, dxp, dh0, dc0) at relative L2 REL_L2 = 3e-4 (a rounding flip
  where two float32 sums straddle a bf16 boundary);
- against the JAX pairs in float32: atol 1e-5 + rtol 1e-4
  (``tests/test_torch_lstm_train.py``); in bf16 the rounded outputs at
  REL_L2 and the weight grads W sums from the composed gate grads, before
  their final bf16 cast, at W_RTOL = 1e-5 (``tests/test_torch_bf16_lstm.py``);
- the control: the chain with da rounded to bf16 before the dh product (a
  bf16 tensor-core product would take it so) lands over REL_L2 from JAX's
  dh0 and dc0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.ops import fused_train as ft
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import grad_reduce as port_gr
from midi_vae_tpu_torch.ops import lstm_layer as port_layer

BF = torch.bfloat16
COMPOSE_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
REL_L2 = 3e-4
W_RTOL = 1e-5
T = 12
H = 32


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _composed_close(got, want, what):
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max()
    assert err <= COMPOSE_RTOL * max(np.abs(want).max(), 1e-30), f"{what}: {err:.3e}"


def _pairs(arrays, bf16):
    """numpy arrays -> (jnp arrays, torch tensors), in bf16 rounded alike."""
    jdt, tdt = (jnp.bfloat16, BF) if bf16 else (jnp.float32, torch.float32)
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(np.asarray(a, np.float32).copy()).to(tdt) for a in arrays])


def _t(a, like):
    """A jnp array as a torch tensor of ``like``'s dtype."""
    return torch.from_numpy(_np(a).copy()).to(like.dtype)


def _inputs(Bn, D, seed):
    rng = np.random.RandomState(seed)
    return [(0.5 * rng.randn(T, Bn, D)).astype(np.float32),
            (0.3 * rng.randn(Bn, H)).astype(np.float32),
            (0.3 * rng.randn(Bn, H)).astype(np.float32),
            (rng.randn(D, 4 * H) / np.sqrt(D)).astype(np.float32),
            (0.1 * rng.randn(4 * H)).astype(np.float32),
            (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)]


def _grads_in(rng, Bn, rs):
    return (rng.randn(T, Bn, H) if rs else rng.randn(Bn, H)).astype(np.float32)


def _out_close(got, want, bf16, what):
    if bf16:
        err = _rel_l2(got, want)
        assert err <= REL_L2, f"{what}: relative L2 {err:.3e} > {REL_L2:.1e}"
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=what)


N_CASES = [(bf16, rs, D, Bn) for bf16 in (False, True) for rs in (True, False)
           for D, Bn in ((61, 8), (5, 5), (16, 5))]


@pytest.mark.parametrize("bf16, rs, D, Bn", N_CASES,
                         ids=[f"{'bf16' if c[0] else 'f32'}-{'seq' if c[1] else 'last'}-D{c[2]}"
                              f"-B{c[3]}" for c in N_CASES])
def test_n_phases_compose_to_row_20(bf16, rs, D, Bn):
    """N's pre-pass (x @ W + b + h_prev @ U), chain and dx pass, composed,
    give lstm_layer_bwd_reference's dx, dh0, dc0 and gate grads, and what
    _lstm_bwdx_pallas emits (its dW, db and dU as W sums them from the
    gate grads); D = 5 is the bf16 cast_x case (D < 8: W in float32)."""
    (jx, jh0, jc0, jw, jb, ju), (x, h0, c0, w, b, u) = _pairs(_inputs(Bn, D, D + Bn), bf16)
    jh, jc = ft._lstm_fwdx_pallas(jx, jh0, jc0, jw, jb, ju, "tanh", True)
    hseq, cseq = _t(jh, x), _t(jc, x)
    g = _grads_in(np.random.RandomState(7), Bn, rs)
    (jg,), (tg,) = _pairs([g], bf16)
    d_seq, d_final = (tg, None) if rs else (None, tg)

    act = port_layer.lstm_bwd_gates_reference(x, hseq, h0, u, w, b)
    assert act.dtype == torch.float32 and act.shape == (T, Bn, 4 * H)
    da, dh0, dc0 = port_layer.lstm_bwd_chain_reference(act, cseq, c0, d_seq, d_final, u)
    dx = port_layer.lstm_bwd_dx_reference(da, w)
    assert dx.dtype == x.dtype and da.dtype == dh0.dtype == torch.float32
    dh0, dc0 = dh0.to(x.dtype), dc0.to(x.dtype)

    ref = port_layer.lstm_layer_bwd_reference(x, hseq, cseq, h0, c0, d_seq, d_final, w, b, u)
    _composed_close(da, ref[3], "da")
    for name, got, want in zip(("dx", "dh0", "dc0"), (dx, dh0, dc0), ref[:3]):
        if bf16:
            _out_close(got, want, True, f"{name} against the op's plain version")
        else:
            _composed_close(got, want, name)

    zeros = jnp.zeros_like(jh)
    want = ft._lstm_bwdx_pallas(jx, jh, jc, jh0, jc0, jg if rs else zeros,
                                jnp.zeros_like(jh0) if rs else jg, jw, jb, ju, rs, True)
    for name, got, wnt in zip(("dx", "dh0", "dc0"), (dx, dh0, dc0), want[:3]):
        _out_close(got, wnt, bf16, f"{name} against _lstm_bwdx_pallas")
    dw, db, du = port_gr.lstm_weight_grads(x, torch.cat([h0[None], hseq[:-1]]), da)
    for name, got, wnt in zip(("dW", "db", "dU"), (dw, db, du), (want[3], want[4][0], want[5])):
        if bf16:
            assert _rel_l2(got, wnt) <= W_RTOL, name
        else:
            _out_close(got, wnt, False, name)


R_CASES = [(bf16, rs, mode, Bn) for bf16 in (False, True) for rs in (True, False)
           for mode, Bn in (("inplace", 5), ("wide", 8))]


@pytest.mark.parametrize("bf16, rs, mode, Bn", R_CASES,
                         ids=[f"{'bf16' if c[0] else 'f32'}-{'seq' if c[1] else 'last'}-{c[2]}"
                              f"-B{c[3]}" for c in R_CASES])
def test_r_phases_compose_to_rows_16_and_18(bf16, rs, mode, Bn):
    """R's pre-pass (xp + h_prev @ U) and chain, composed, give
    lstm_layer_xp_bwd_reference's dxp, dh0, dc0 and gate grads, and what
    _lstm_bwd_pallas (row 16, its dU from the unrounded gate grads) or
    _lstm_bwd_wide_pallas (row 18, its gate grads stored in xp's dtype)
    emits."""
    rng = np.random.RandomState(40 + Bn)
    arrays = [(0.5 * rng.randn(T, Bn, 4 * H)).astype(np.float32),
              (0.3 * rng.randn(Bn, H)).astype(np.float32),
              (0.3 * rng.randn(Bn, H)).astype(np.float32),
              (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)]
    (jxp, jh0, jc0, ju), (xp, h0, c0, u) = _pairs(arrays, bf16)
    jh, jc = ft._lstm_fwd_pallas(jxp, jh0, jc0, ju, "tanh", True)
    hseq, cseq = _t(jh, xp), _t(jc, xp)
    g = _grads_in(rng, Bn, rs)
    (jg,), (tg,) = _pairs([g], bf16)
    d_seq, d_final = (tg, None) if rs else (None, tg)

    act = port_layer.lstm_bwd_gates_reference(xp, hseq, h0, u)
    da, dh0, dc0 = port_layer.lstm_bwd_chain_reference(act, cseq, c0, d_seq, d_final, u)
    dxp, dh0, dc0 = da.to(xp.dtype), dh0.to(xp.dtype), dc0.to(xp.dtype)

    ref = port_layer.lstm_layer_xp_bwd_reference(xp, hseq, cseq, h0, c0, d_seq, d_final, u)
    _composed_close(da, ref[3], "da")
    for name, got, want in zip(("dxp", "dh0", "dc0"), (dxp, dh0, dc0), ref[:3]):
        if bf16:
            _out_close(got, want, True, f"{name} against the op's plain version")
        else:
            _composed_close(got, want, name)

    dseq_j = jg if rs else jnp.zeros_like(jh)
    dfin_j = jnp.zeros_like(jh0) if rs else jg
    hprev = torch.cat([h0[None], hseq[:-1]])
    if mode == "inplace":
        jdxp, jdh0, jdc0, jdu = ft._lstm_bwd_pallas(jxp, jh, jc, jh0, jc0, dseq_j, dfin_j, ju, rs,
                                                    True)
        du = port_gr.lstm_u_grad(hprev, da)
    else:
        jdxp, jdh0, jdc0 = ft._lstm_bwd_wide_pallas(jxp, jh, jc, jh0, jc0, dseq_j, dfin_j, ju, rs,
                                                    True, 8)
        jdu = ft._lstm_wide_weight_grads(jh, jh0, jdxp)
        du = port_gr.lstm_u_grad(hprev, dxp.float())
    for name, got, wnt in zip(("dxp", "dh0", "dc0"), (dxp, dh0, dc0), (jdxp, jdh0, jdc0)):
        _out_close(got, wnt, bf16, f"{name} against the {mode} pair")
    if bf16:
        assert _rel_l2(du, jdu) <= W_RTOL
    else:
        _out_close(du, jdu, False, "dU")


def _chain_rounding_da(act, cseq, c0, d_final, u):
    """The chain's plain version with da rounded to bf16 before the dh
    product: the control."""
    cseq, c0, d_final, u = (t.float() for t in (cseq, c0, d_final, u))
    dh, dc = d_final, torch.zeros_like(c0)
    for t in reversed(range(act.shape[0])):
        da, _, dc = port_layer.lstm_cell_bwd_act(act[t], cseq[t - 1] if t > 0 else c0, cseq[t],
                                                 u, dh, dc)
        dh = da.to(BF).float() @ u.t()
    return dh, dc


def test_the_chain_with_da_rounded_to_bf16_lands_outside():
    """In bf16 the chain's da stays float32 for the dh product: the plain
    chain meets _lstm_bwd_wide_pallas's dh0 and dc0 at REL_L2, the chain
    with da rounded to bf16 before da @ U^T lands over it."""
    rng = np.random.RandomState(3)
    Bn = 8
    arrays = [(0.5 * rng.randn(T, Bn, 4 * H)).astype(np.float32),
              (0.3 * rng.randn(Bn, H)).astype(np.float32),
              (0.3 * rng.randn(Bn, H)).astype(np.float32),
              (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
              rng.randn(Bn, H).astype(np.float32)]
    (jxp, jh0, jc0, ju, jg), (xp, h0, c0, u, g) = _pairs(arrays, True)
    jh, jc = ft._lstm_fwd_pallas(jxp, jh0, jc0, ju, "tanh", True)
    hseq, cseq = _t(jh, xp), _t(jc, xp)
    _, jdh0, jdc0 = ft._lstm_bwd_wide_pallas(jxp, jh, jc, jh0, jc0, jnp.zeros_like(jh), jg, ju,
                                             False, True, 8)
    act = port_layer.lstm_bwd_gates_reference(xp, hseq, h0, u)
    _, dh0, dc0 = port_layer.lstm_bwd_chain_reference(act, cseq, c0, None, g, u)
    assert max(_rel_l2(dh0.to(BF), jdh0), _rel_l2(dc0.to(BF), jdc0)) <= REL_L2
    wdh0, wdc0 = _chain_rounding_da(act, cseq, c0, g, u)
    err = max(_rel_l2(wdh0.to(BF), jdh0), _rel_l2(wdc0.to(BF), jdc0))
    assert err > REL_L2, f"the control lands {err:.3e} from JAX, inside {REL_L2:.1e}"


@pytest.mark.parametrize("bf16", [False, True])
def test_phase_wrappers_run_their_plain_versions_on_cpu(bf16):
    """Each phase's wrapper takes its plain version for CPU tensors and
    counts no launch; the op wrappers give what the phases compose to."""
    dt = BF if bf16 else torch.float32
    x, h0, c0, w, b, u = (torch.from_numpy(a).to(dt) for a in _inputs(5, 7, 1))
    hseq, cseq = port_layer.lstm_layer_reference(x, h0, c0, w, b, u, "tanh", True, True)
    d_seq = torch.cos(hseq.float()).to(dt)
    act = port_layer.lstm_layer_bwd_gates(x, hseq, h0, w, b, u)
    assert torch.equal(act, port_layer.lstm_bwd_gates_reference(x, hseq, h0, u, w, b))
    da, dh0, dc0 = port_layer.lstm_layer_bwd_chain(act, cseq, c0, d_seq, None, u)
    assert dh0.dtype == dc0.dtype == dt and da.dtype == torch.float32
    dx = port_layer.lstm_layer_bwd_dx(da, w)
    ref = port_layer.lstm_layer_bwd(x, hseq, cseq, h0, c0, d_seq, None, w, b, u)
    for got, want in zip((dx, dh0, dc0, da), ref):
        _composed_close(got.float(), want.float(), "N")
    xp = (x.float().reshape(T * 5, 7) @ w.float() + b.float()).reshape(T, 5, -1).to(dt)
    hs, cs = port_layer.lstm_layer_xp_reference(xp, h0, c0, u)
    act = port_layer.lstm_layer_xp_bwd_gates(xp, hs, h0, u)
    got = port_layer.lstm_layer_xp_bwd_chain(act, cs, c0, None, d_seq[0], u)
    ref = port_layer.lstm_layer_xp_bwd(xp, hs, cs, h0, c0, None, d_seq[0], u)
    for a, want in zip(got, ref):
        _composed_close(a.float(), want.float(), "R")
    for fn in (port_layer.lstm_layer_bwd_gates, port_layer.lstm_layer_bwd_chain,
               port_layer.lstm_layer_bwd_dx, port_layer.lstm_layer_xp_bwd_gates,
               port_layer.lstm_layer_xp_bwd_chain):
        assert fn.launches == fn.launches_bf16 == 0, fn.__name__


def test_phase_wrappers_check_shapes():
    act = torch.zeros(2, 4, 128)
    with pytest.raises(ValueError, match="c0 has shape"):
        port_layer.lstm_layer_bwd_chain(act, torch.zeros(2, 4, 32), torch.zeros(3, 32), None,
                                        None, torch.zeros(32, 128))
    with pytest.raises(ValueError, match="act has shape"):
        port_layer.lstm_layer_xp_bwd_chain(act[:, :3], torch.zeros(2, 4, 32), torch.zeros(4, 32),
                                           None, None, torch.zeros(32, 128))
    with pytest.raises(ValueError, match="w has shape"):
        port_layer.lstm_layer_bwd_dx(act, torch.zeros(5, 96))


# the cluster sizes of the chain (the slice of U^T a CTA keeps: 128 KiB at
# each of these; float32 at 512 streams its slice)
CLUSTERS = {("N", 256): (8, False), ("N_bf16", 256): (4, False), ("N", 384): (16, False),
            ("N_bf16", 384): (8, False), ("N", 512): (16, True), ("N_bf16", 512): (16, False)}
LAYOUT_CASES = [(H_, bf16, B_) for H_ in (256, 384, 512) for bf16 in (False, True)
                for B_ in (5, 128, 256, 512)]


@pytest.mark.parametrize("H_, bf16, B_", LAYOUT_CASES,
                         ids=[f"H{c[0]}-{'bf16' if c[1] else 'f32'}-B{c[2]}" for c in LAYOUT_CASES])
def test_chain_plan(H_, bf16, B_):
    """The chain's plan at (H, dtype, B) on the H100: the cluster size; rows
    from B, so that the clusters fit the card's active clusters where the
    buffers allow; the slice (or the streamed ring) plus the exchange
    buffers (the da tile and the partials) fit a block's 227 KB; each
    thread owns at most three (unit, row) pairs; N and R share it."""
    sfx = "_bf16" if bf16 else ""
    plan = _layout.bptt_plan("N" + sfx, H_, B_)
    assert plan == _layout.bptt_plan("R" + sfx, H_, B_)
    C, stream = CLUSTERS[("N" + sfx, H_)]
    assert (plan.cluster, plan.stages > 0) == (C, stream)
    Hc = H_ // C
    elem = 2 if bf16 else 4
    if stream:
        assert 4 * Hc * H_ * 4 + 8 * 4 * Hc * 4 > _layout.SMEM_PER_BLOCK  # no resident fit
        assert 2 <= plan.stages <= 8
        slice_ = plan.stages * 16 * H_ * 4
    else:
        slice_ = 4 * Hc * H_ * elem
        assert slice_ == 128 * 1024 or (H_ == 384 and slice_ == 144 * 1024)
    # the da tile (rows rounded up to 8, 4 Hc + 8 floats) and the partials
    exchange = (-(-plan.rows // 8) * 8 * (4 * Hc + 8) * 4
                + plan.nbuf * plan.splits * plan.rows * H_ * 4)
    assert plan.smem == slice_ + exchange <= _layout.SMEM_PER_BLOCK
    assert Hc * plan.rows <= 3 * 512
    assert plan.clusters == -(-B_ // plan.rows)
    if bf16:  # one split; three m-tiles of 16 rows on the tensor cores
        assert plan.splits == 1 and plan.rows <= 48
    active = _layout.MAX_CLUSTERS_H100[C]
    most = max(r for r in range(1, min(3 * 512 // Hc, 48 if bf16 else 512) + 1)
               if _layout.chain_smem(H_, C, r, 1, 1, 2 if stream else 0, elem)
               <= _layout.SMEM_PER_BLOCK)
    assert plan.rows == min(-(-B_ // active), most)
    if plan.rows < most:
        assert plan.clusters <= active
    # more clusters active at once than the H100's take fewer rows each
    assert _layout.bptt_plan("N" + sfx, H_, B_, 2 * active).rows <= plan.rows


def test_chain_launch_limits():
    """Where the chain does not launch, the route chooser's limit says why."""
    why = _layout.launch_limit("R_bf16", 1024, 0)
    assert "shared memory" in why and "clusters of 16" in why
    assert _layout.launch_limit("R", 1024, 0) is None  # float32 streams its slice
    assert "multiple of 64" in _layout.launch_limit("N", 96, 0)
    assert "multiple of 128" in _layout.launch_limit("N_bf16", 192, 0)
    with pytest.raises(_layout.LaunchLimitError, match="shared memory"):
        _layout.bptt_plan("N_bf16", 1024, 256)
    for build in _layout.BPTT_BUILDS:
        assert _layout.launch_limit(build, 512, 0) is None
