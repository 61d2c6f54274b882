"""CPU tests of kernels X and G on their chains, the GRU layer over a given
xp = x @ W + b (``midi_vae_tpu_torch/csrc/gru_encoder_scan.cu``,
``csrc/gru_layer_xp_bwd.cu``): X runs kernel A's bf16 chain
(``csrc/gru_cell_fwd.cuh``) over a bf16 xp; G runs an xp gate pre-pass
(``gru_bwd_gates_xp_reference``) and kernel C's chain
(``gru_bwd_chain_reference``), the bf16 build also rounding dxp from the
chain's stores of da. The chains run only on the card (``chip_smoke.py``
holds them against these plain versions there); here:

- X's plain chain (``gru_fwd_chain_reference`` over the bf16 xp, the CPU
  path of ``gru_encoder_scan_fwd``) against ``_encoder_scan_pallas`` and
  ``_encoder_scan_wide_pallas`` in interpret mode (rows 26 and 27): tanh,
  sigmoid and relu cells, the sequence and the final h, B 16 and 5;
- G's pre-pass and chain composed, with kernel W's plain version for dU,
  against ``_bwd_pallas`` (row 10: dxp, dh0, dU from the float gate grads)
  and ``_bwd_wide_pallas`` (row 12: the rounded gate grads and dh0), float32
  and bf16, both ``return_sequences``, B 16 and 5;
- the control: bf16 G with da rounded to bf16 before the carry's products
  lands over the limit from ``_bwd_pallas``'s dh0;
- the routes (chain or per-block) at every multiple of 32 up to 512, and
  ``config_route``'s answers for today's configs (the table
  ``tests/data/gru_bwd_routes.json`` pins);
- the plans: X's pick (``X_chain``: the largest cluster, the most depth
  splits) and G's (``G_chain``, ``G_chain_bf16``: C's cost model among the
  fewest waves) among those the H100 ran within 10 % of the fastest at X's
  and G's shapes (``python -m midi_vae_tpu_torch.tools.time_x_and_g --only
  xplans gplans``; A bf16's and C's own picks were not, at B 5 and 1024);
- the launch counts: G's phases count on G's counters and never on C's.

Sizes: T 6, H 64 (the chains' widths are multiples of 64 for G, of 32
for X), B 16 or 5. Tolerances:
- float32 against the JAX kernels: atol 1e-5 + rtol 1e-4 (the pre-pass
  sums its products over all T B rows at once, in another order);
- bf16: relative L2 REL_L2 = 3e-4 per output (a rounding flip where float32
  sums taken in another order straddle a bf16 boundary;
  ``tests/test_torch_gru_bwd_chain.py``), and X's h also within one bf16
  step of the state's range (BF16_ATOL 4e-3, ``tests/test_torch_bf16.py``);
- the composition against the op's plain version: rtol 1e-5, atol 1e-6.
"""

import importlib.util
import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from midi_vae_tpu.ops import fused_decoder as fd
from midi_vae_tpu.ops import fused_train as ft
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import encoder_scan as port_scan
from midi_vae_tpu_torch.ops import grad_reduce as port_gr
from midi_vae_tpu_torch.ops import gru_layer as port_layer

BF = torch.bfloat16
ATOL, RTOL = 1e-5, 1e-4
REL_L2 = 3e-4
BF16_ATOL = 4e-3
T, H = 6, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's products are tiny: one torch thread and one BLAS
    thread, so that beside the suite's other busy workers its threads do not
    wait on each other."""
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


def _close(got, want, bf16, what, rtol=RTOL, atol=ATOL):
    assert tuple(_np(got).shape) == tuple(_np(want).shape), what
    if bf16:
        err = _rel_l2(got, want)
        assert err <= REL_L2, f"{what}: relative L2 {err:.3e} > {REL_L2:.1e}"
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _pair(a, bf16):
    """numpy a -> (jnp, torch), bf16 rounded alike."""
    a = np.asarray(a, np.float32)
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a.copy()).to(BF)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _t(a, like):
    return torch.from_numpy(_np(a).copy()).to(like.dtype)


def _inputs(Bn, seed):
    """xp (T, B, 3H), h0 (B, H), U (H, 3H) of one layer."""
    rng = np.random.RandomState(seed)
    return [rng.randn(T, Bn, 3 * H).astype(np.float32),
            (0.5 * np.tanh(rng.randn(Bn, H))).astype(np.float32),
            (rng.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32)]


# ---------------------------------------------------------------------------
# X: A's bf16 chain over the bf16 xp against rows 26 and 27
# ---------------------------------------------------------------------------

X_CASES = [(act, rs, Bn, grid) for act in ("tanh", "sigmoid", "relu") for rs in (True, False)
           for Bn, grid in ((16, "untiled"), (5, "untiled"))]
X_CASES += [("tanh", rs, 16, "wide") for rs in (True, False)]


@pytest.mark.parametrize("act, rs, Bn, grid", X_CASES,
                         ids=[f"{a}-{'seq' if r else 'last'}-B{b}-{g}" for a, r, b, g in X_CASES])
def test_x_chain_plain_version_matches_rows_26_and_27(act, rs, Bn, grid):
    """A's chain's plain version over a bf16 xp (the chain reads it widened,
    r * h in float32, h rounded once a step) and X's CPU path both meet
    ``_encoder_scan_pallas`` (``_encoder_scan_wide_pallas``, two batch
    tiles) in interpret mode."""
    (jxp, jh0, ju), (xp, h0, u) = zip(*(_pair(a, True) for a in _inputs(Bn, 3 + Bn)))
    if grid == "wide":
        want = fd._encoder_scan_wide_pallas(jxp, jh0, ju, act, rs, True, Bn // 2)
    else:
        want = fd._encoder_scan_pallas(jxp, jh0, ju, act, rs, True)
    chain = port_layer.gru_fwd_chain_reference(xp, h0, u, act, rs)
    got = port_scan.gru_encoder_scan_fwd(xp, h0, u, act, rs)
    assert chain.dtype == got.dtype == BF and torch.equal(chain, got)
    _close(chain, want, True, f"X chain {act} rs={rs} B={Bn}")
    np.testing.assert_allclose(_np(chain), _np(want), rtol=0, atol=BF16_ATOL)
    assert port_scan.gru_encoder_scan_fwd.launches == port_scan.gru_encoder_scan_fwd.launches_chain == 0


def test_x_chain_with_the_state_in_float32_lands_outside():
    """The control: the chain carrying h in float32 (only the output rounded)
    computes another function: it lands over REL_L2 from row 26, where the
    chain that rounds h once a step meets it."""
    (jxp, jh0, ju), (xp, h0, u) = zip(*(_pair(a, True) for a in _inputs(16, 8)))
    want = fd._encoder_scan_pallas(jxp, jh0, ju, "tanh", True, True)
    assert _rel_l2(port_layer.gru_fwd_chain_reference(xp, h0, u, "tanh", True), want) <= REL_L2
    wrong = port_layer.gru_fwd_chain_reference(xp.float(), h0.float(), u.float(), "tanh", True)
    err = _rel_l2(wrong.to(BF), want)
    assert err > REL_L2, f"the control lands {err:.3e} from row 26, inside {REL_L2:.1e}"


# ---------------------------------------------------------------------------
# G: the xp gate pre-pass and C's chain against rows 10 and 12
# ---------------------------------------------------------------------------

G_CASES = [(bf16, rs, Bn) for bf16 in (False, True) for rs in (True, False) for Bn in (16, 5)]
G_IDS = [f"{'bf16' if b else 'f32'}-{'seq' if r else 'last'}-B{n}" for b, r, n in G_CASES]


@pytest.fixture(scope="module", params=G_CASES, ids=G_IDS)
def g_case(request):
    """(case, torch (xp, h0, u), the forward's sequence, the incoming grad,
    JAX's row 10 (dxp, dh0, dU) and row 12 (dacat, dh0) in interpret mode)."""
    bf16, rs, Bn = request.param
    jargs, targs = zip(*(_pair(a, bf16) for a in _inputs(Bn, 11 + Bn + rs)))
    jxp, jh0, ju = jargs
    jseq = ft._fwd_pallas(jxp, jh0, ju, "tanh", True)
    rng = np.random.RandomState(7)
    g = (rng.randn(T, Bn, H) if rs else rng.randn(Bn, H)).astype(np.float32)
    jg, tg = _pair(g, bf16)
    d_seq, d_final = (jg, jnp.zeros_like(jh0)) if rs else (jnp.zeros_like(jseq), jg)
    row10 = ft._bwd_pallas(jxp, jseq, jh0, d_seq, d_final, ju, rs, True)
    bt = Bn if Bn % 2 else Bn // 2  # B 16: two batch tiles
    row12 = ft._bwd_wide_pallas(jxp, jseq, jh0, d_seq, d_final, ju, rs, True, bt)
    return request.param, targs, _t(jseq, targs[0]), tg, row10, row12


def test_g_phases_compose_to_rows_10_and_12(g_case):
    """G's xp gate pre-pass (gates and r * h from xp and hprev = [h0,
    hseq[:-1]]) and C's chain over them, composed, with W's plain version
    for dU from the float32 gate grads, give what ``_bwd_pallas`` emits, and
    the rounded gate grads and dh0 ``_bwd_wide_pallas`` emits; and the op's
    plain version's outputs."""
    (bf16, rs, Bn), (xp, h0, u), seq, g, row10, row12 = g_case
    d_seq, d_final = (g, None) if rs else (None, g)
    hprev = torch.cat([h0[None], seq[:-1]])
    gates, rh = port_layer.gru_bwd_gates_xp_reference(xp, hprev, u)
    assert gates.dtype == rh.dtype == torch.float32
    assert gates.shape == (T, Bn, 3 * H) and rh.shape == (T, Bn, H)
    da, dh0 = port_layer.gru_bwd_chain_reference(gates, hprev, d_seq, d_final, u)
    dxp, dh0 = da.to(xp.dtype), dh0.to(xp.dtype)
    du = port_gr.gru_u_grad(hprev, rh, da)
    for name, gv, wv in zip(("dxp", "dh0", "dU"), (dxp, dh0, du), row10):
        _close(gv, wv, bf16, f"{name} against _bwd_pallas")
    for name, gv, wv in zip(("dacat", "dh0"), (dxp, dh0), row12):
        _close(gv, wv, bf16, f"{name} against _bwd_wide_pallas")
    ref = port_layer.gru_layer_xp_bwd_reference(xp, seq, h0, d_seq, d_final, u)
    for name, gv, rv in zip(("dxp", "dh0", "da_cat", "rh"), (dxp, dh0, da, rh), ref):
        _close(gv, rv, bf16 and name in ("dxp", "dh0"), f"{name} against the plain op",
               rtol=1e-5, atol=1e-6)
    # the phase wrappers' CPU paths are the plain versions, and the op's
    got = port_layer.gru_layer_xp_bwd_chain(gates, hprev, d_seq, d_final, u)
    assert torch.equal(got[0], dxp) and torch.equal(got[1], dh0) and torch.equal(got[2], da)
    assert got[0].dtype == xp.dtype and got[2].dtype == torch.float32
    wg, wrh = port_layer.gru_layer_xp_bwd_gates(xp, hprev, u)
    assert torch.equal(wg, gates) and torch.equal(wrh, rh)
    op = port_layer.gru_layer_xp_bwd(xp, seq, h0, d_seq, d_final, u)
    assert all(torch.equal(a, b) for a, b in zip(op, ref))


def test_bf16_g_with_da_rounded_before_the_carry_lands_outside():
    """The control: bf16 G with da rounded to bf16 before the carry's
    products (dxp's rounding taken into the chain) lands over REL_L2 from
    ``_bwd_pallas``'s dh0, where the chain's float da meets it; so the limit
    tells the chain's float carry from the rounded one."""
    Bn = 16
    (jxp, jh0, ju), (xp, h0, u) = zip(*(_pair(a, True) for a in _inputs(Bn, 5)))
    jseq = ft._fwd_pallas(jxp, jh0, ju, "tanh", True)
    g = np.random.RandomState(5).randn(T, Bn, H).astype(np.float32)
    jg, tg = _pair(g, True)
    want = ft._bwd_pallas(jxp, jseq, jh0, jg, jnp.zeros_like(jh0), ju, True, True)[1]
    seq = _t(jseq, xp)
    hprev = torch.cat([h0[None], seq[:-1]])
    gates, _rh = port_layer.gru_bwd_gates_xp_reference(xp, hprev, u)
    _da, dh0 = port_layer.gru_bwd_chain_reference(gates, hprev, tg, None, u)
    assert _rel_l2(dh0.to(BF), want) <= REL_L2
    uf, hp = u.float(), hprev.float()
    dh = torch.zeros(Bn, H)
    for t in reversed(range(T)):
        dh = dh + tg[t].float()
        z, r, hh = gates[t, :, :H], gates[t, :, H : 2 * H], gates[t, :, 2 * H :]
        da = (dh * (1.0 - z) * (1.0 - hh * hh)).to(BF).float()
        drh = da @ uf[:, 2 * H :].t()
        da_zr = torch.cat([dh * (hp[t] - hh) * z * (1.0 - z), drh * hp[t] * r * (1.0 - r)], -1)
        dh = dh * z + drh * r + da_zr.to(BF).float() @ uf[:, : 2 * H].t()
    err = _rel_l2(dh.to(BF), want)
    assert err > REL_L2, f"the control lands {err:.3e} from _bwd_pallas, inside {REL_L2:.1e}"


def test_g_phase_wrappers_check_shapes():
    xp, h0, u = (torch.from_numpy(a) for a in _inputs(9, 1))
    hprev = torch.zeros(T, 9, H)
    with pytest.raises(ValueError, match="hprev has shape"):
        port_layer.gru_layer_xp_bwd_gates(xp, hprev[:, :4], u)
    gates, _rh = port_layer.gru_layer_xp_bwd_gates(xp, hprev, u)
    with pytest.raises(ValueError, match="gates has shape"):
        port_layer.gru_layer_xp_bwd_chain(gates[..., :-1], hprev, None, None, u)


# ---------------------------------------------------------------------------
# the routes, the plans and the launch counts
# ---------------------------------------------------------------------------

# X's and G's routes at every multiple of 32 up to 512: X's chain takes H
# whose CTA slice of U (H / C a multiple of 32) fits half a block's shared
# memory, G's (C's chain) H a multiple of 64; the per-block routes the rest
X_CHAIN_WIDTHS = {32, 64, 96, 128, 192, 256, 512}
G_CHAIN_WIDTHS = set(range(64, 513, 64))


@pytest.mark.parametrize("H_", range(32, 513, 32))
def test_routes_at_every_width_x_and_g_launched_at_before(H_):
    assert _layout.gru_scan_route(H_) == ("chain" if H_ in X_CHAIN_WIDTHS else "block")
    for bf16 in (False, True):
        assert _layout.gru_xp_bwd_route(H_, bf16) == ("chain" if H_ in G_CHAIN_WIDTHS else "block")
    for build in _layout.XP_LAYER_BUILDS:
        assert _layout.xp_layer_limit(build, H_) is None


def test_routes_off_the_widths():
    """No route launches off the multiples of 32 or (X's and G's per-block
    routes) above 512 threads; G's chain has plans at H = 1024, and so does
    X's, whose CTA slice of U does not fit a CTA there: its bf16 slice
    streams through F's tensor-core instance (``gru_tc_plan(..., elem=2)``),
    not through A bf16's resident chain, and its per-block route does not
    launch."""
    for H_ in (48, 200):
        assert "multiple of 32" in _layout.xp_layer_limit("X", H_)
        assert "multiple of 32" in _layout.xp_layer_limit("G_bf16", H_)
    assert _layout.gru_scan_route(1024) == "chain"
    assert _layout.gru_fwd_cluster(_layout.X_CHAIN_BUILD, 1024) == (16, True)
    assert _layout.gru_fwd_plan(_layout.X_CHAIN_BUILD, 1024, 256).chunk > 0
    assert _layout.xp_layer_limit("X", 1024) is None
    assert "__launch_bounds__" in _layout.launch_limit("X", 1024, _layout.smem_bytes("X", 1024))
    assert _layout.gru_xp_bwd_route(1024) == _layout.gru_xp_bwd_route(1024, True) == "chain"


def _bwd_chain_test_module():
    path = os.path.join(os.path.dirname(__file__), "test_torch_gru_bwd_chain.py")
    spec = importlib.util.spec_from_file_location("_gru_bwd_chain_answers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config_routes_keep_their_answers():
    """``train_route``, ``config_route``, ``bf16_layer_mode``,
    ``bf16_head_mode`` and ``head_builds`` give the answers recorded before
    X and G ran on chains, for today's configs (the soak's, configs/*.json,
    Config() variants at 256 and 512): X's and G's launch limits now come
    from their routes."""
    mod = _bwd_chain_test_module()
    with open(mod.ROUTES) as f:
        want = json.load(f)
    configs = mod._route_configs()
    assert set(configs) == set(want)
    for name, cfg in configs.items():
        assert mod._route_answers(_layout, cfg) == want[name], name


# the plans whose chain ran within 10 % of the fastest plan's time at X's
# and G's shapes, timed on the card (python -m
# midi_vae_tpu_torch.tools.time_x_and_g --only xplans gplans; NVIDIA H100
# 80GB HBM3, 700.00 W): X as (cluster, rows, splits), G as the cluster size.
# The picks must be among them
NEAR_BEST_X = {
    (256, 256): {(4, 9, 2), (4, 9, 4), (8, 18, 2), (8, 18, 4)},
    (256, 5): {(4, 1, 4), (4, 1, 8), (8, 1, 4), (8, 1, 8), (8, 1, 16)},
    (256, 1024): {(8, 69, 1)},
    (512, 256): {(16, 19, 2)},
    (512, 128): {(16, 19, 2)},
    (512, 512): {(16, 32, 1), (16, 25, 1)},
}
NEAR_BEST_G = {
    (False, 256, 256): {8, 16},
    (False, 512, 256): {8},
    (False, 512, 5): {16},
    (True, 512, 256): {8},
    (True, 512, 128): {8, 16},
    (True, 256, 1024): {4, 8},
    (True, 512, 5): {16},
}


@pytest.mark.parametrize("H_, Bn", sorted(NEAR_BEST_X))
def test_x_plan_picks_are_near_the_fastest(H_, Bn):
    plan = _layout.gru_fwd_plan(_layout.X_CHAIN_BUILD, H_, Bn)
    assert plan in _layout.gru_fwd_plans(_layout.X_CHAIN_BUILD, H_, Bn)
    assert (plan.cluster, plan.rows, plan.splits) in NEAR_BEST_X[(H_, Bn)]
    assert plan.rows * plan.clusters >= Bn and plan.smem <= _layout.SMEM_PER_BLOCK
    # X's rows: the fewest that keep its waves of the card's active clusters
    # (one row fewer a cluster would take another wave)
    M = _layout.MAX_CLUSTERS_H100[plan.cluster]
    waves = -(-plan.clusters // M)
    assert plan.rows == 1 or -(-Bn // (plan.rows - 1)) > M * waves


@pytest.mark.parametrize("bf16, H_, Bn", sorted(NEAR_BEST_G))
def test_g_plan_picks_are_near_the_fastest(bf16, H_, Bn):
    plan = _layout.gru_bptt_plan(_layout.G_CHAIN_BUILDS[bf16], H_, Bn, None)
    assert plan.cluster in NEAR_BEST_G[(bf16, H_, Bn)]
    assert plan.rows[0] * plan.clusters[0] >= Bn and plan.smem <= _layout.GRU_BWD_SMEM


def test_plan_rules_name_chain_builds():
    """X's and G's plan rules come from one table of chain builds; A's and
    C's builds (and E's) keep the default rule."""
    chains = set(_layout.GRU_FWD_BUILDS) | set(_layout.GRU_BPTT_BUILDS)
    assert set(_layout.PLAN_RULES) <= chains
    assert _layout.plan_rule(_layout.X_CHAIN_BUILD).largest_cluster
    assert _layout.plan_rule(_layout.X_CHAIN_BUILD).balanced_rows
    assert all(_layout.plan_rule(b).fewest_waves for b in _layout.G_CHAIN_BUILDS.values())
    for build in chains - set(_layout.PLAN_RULES):
        assert _layout.plan_rule(build) == _layout.PlanRule()


def test_g_phases_count_on_gs_counters_not_cs(monkeypatch):
    """G's phases, launched as on the card (the entry points stubbed to
    return success, the plan the H100's), count on their own wrappers and
    on ``gru_layer_xp_bwd`` (the chain, one a call of G), and leave C's
    counters unchanged."""
    calls = []
    fake = SimpleNamespace(mvt_error_string=lambda rc: b"")
    entry = lambda *a: calls.append(len(a)) or 0  # noqa: E731
    monkeypatch.setattr(port_layer, "_xp_bwd_phases", lambda: (fake, {
        k: {torch.float32: entry, BF: entry} for k in ("gates", "chain", "block")}))
    monkeypatch.setattr(port_layer, "_check_bwd_phase", lambda *a, **k: True)
    monkeypatch.setattr(port_layer, "_stream", lambda t: None)
    monkeypatch.setattr(port_layer, "xp_bwd_plan", lambda bf16, H_, B_: _layout.gru_bptt_plan(
        _layout.G_CHAIN_BUILDS[bf16], H_, B_, None))
    counted = (port_layer.gru_layer_xp_bwd, port_layer.gru_layer_bwd,
               *(getattr(port_layer, n) for n in (*port_layer.G_PHASES, *port_layer.C_PHASES)))
    for fn in counted:
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_bf16", 0)
    for dt in (torch.float32, BF):
        xp, h0, u = (torch.from_numpy(a).to(dt) for a in _inputs(5, 2))
        hprev = torch.cat([h0[None], torch.zeros(T - 1, 5, H, dtype=dt)])
        gates, _rh = port_layer.gru_layer_xp_bwd_gates(xp, hprev, u)
        port_layer.gru_layer_xp_bwd_chain(gates, hprev, None, h0, u)
    assert calls == [8, 15, 8, 16]  # the bf16 chain also takes dxp
    for fn in (port_layer.gru_layer_xp_bwd_chain, port_layer.gru_layer_xp_bwd):
        assert fn.launches == fn.launches_bf16 == 1
    assert port_layer.gru_layer_xp_bwd_gates.launches == 2
    assert port_layer.gru_layer_xp_bwd_gates.launches_bf16 == 2
    assert port_layer.gru_layer_xp_bwd_block.launches == 0
    for fn in (port_layer.gru_layer_bwd, *(getattr(port_layer, n) for n in port_layer.C_PHASES)):
        assert fn.launches == fn.launches_bf16 == 0, fn.__name__
