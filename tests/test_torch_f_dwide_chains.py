"""CPU tests of kernels F and D wide on their chains: F, the float32 GRU
layer over a given xp = x @ W + b (``midi_vae_tpu_torch/csrc/
gru_layer_xp_fwd.cu``: A's chain of ``csrc/gru_cell_fwd.cuh`` with the
slice resident at H = 256, its tensor-core instance with the slice streamed
by the TMA at 512), and D wide, the decode heads' training forward at H =
512 (``csrc/gru_decode_train.cu``: B's decode chain of
``csrc/gru_decode_chain.cuh`` in its training instance, float32 and bf16).
The chains run only on the card (``chip_smoke.py`` holds them against these
plain versions there); here:

- F's plain chain (``gru_layer_xp_reference``, the CPU path of both
  routes) against ``_fwd_pallas`` and ``_fwd_wide_pallas`` in interpret
  mode (rows 9 and 11), B 16 and 5;
- F's tensor-core arithmetic emulated in torch (each product as three
  TF32 products, chunk by chunk into zeroed sums joined by one float add)
  against a float64 recurrence and row 9, a one-TF32-product control over
  the limit; the packed slices' order (``pack_tc_slices``);
- D wide's plain chain (``gru_decode_train_chain_reference``: B's phases
  composed over 2 and 4 CTAs' unit slices, the bf16 roundings) and the CPU
  path of ``gru_decode_fwd_train_wide`` against ``_dec_fwd_pallas`` and
  ``_dec_fwd_wide_pallas`` (rows 7 and 13): probs, logits and the h
  sequences, 1- and 2-layer heads, softmax, sigmoid and linear, B 16 and
  5, float32 and bf16; layer 2 fed the rounded h1 as the control;
- D wide's stored h sequences fed to E wide's plain backward give E's
  outputs;
- the routes (chain or per-block) at every multiple of 32 up to 512,
  ``config_route``'s and ``head_builds``'s answers
  (``tests/data/gru_bwd_routes.json``);
- the plan picks against the plans the H100 ran within 10 % of the fastest
  (``tests/data/f_dwide_near_best.json``, from ``python -m
  midi_vae_tpu_torch.tools.time_f_and_d --only fplans dplans``);
- the launch counts by route.

Sizes: T 6, H 64, B 16 or 5. Tolerances: float32 atol 1e-5 + rtol 1e-4
(the chains sum in another order); bf16 relative L2 REL_L2 = 3e-4 per output
and, for the h sequences, BF16_ATOL 4e-3 (one bf16 step of the state's
range), as ``tests/test_torch_gru_xp_chains.py`` states them; F's emulated
tensor-core products within TC_REL_L2 = 1e-6 of the float64 recurrence.
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

from midi_vae_tpu.ops import fused_train as ft
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import gru_decode as port_dec
from midi_vae_tpu_torch.ops import gru_layer as port_layer

BF = torch.bfloat16
ATOL, RTOL = 1e-5, 1e-4
REL_L2 = 3e-4
BF16_ATOL = 4e-3
TC_REL_L2 = 1e-6
T, H = 6, 64
NEAR_BEST = os.path.join(os.path.dirname(__file__), "data", "f_dwide_near_best.json")


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


def _close(got, want, bf16, what, atol=ATOL):
    assert tuple(_np(got).shape) == tuple(_np(want).shape), what
    if bf16:
        err = _rel_l2(got, want)
        assert err <= REL_L2, f"{what}: relative L2 {err:.3e} > {REL_L2:.1e}"
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=atol, err_msg=what)


def _pair(a, bf16=False):
    """numpy a -> (jnp, torch), bf16 rounded alike."""
    a = np.asarray(a, np.float32)
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a.copy()).to(BF)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _layer_inputs(Bn, seed):
    """xp (T, B, 3H), h0 (B, H), U (H, 3H) of one layer."""
    rng = np.random.RandomState(seed)
    return [rng.randn(T, Bn, 3 * H).astype(np.float32),
            (0.5 * np.tanh(rng.randn(Bn, H))).astype(np.float32),
            (rng.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32)]


# ---------------------------------------------------------------------------
# F: the chain's plain version against rows 9 and 11
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Bn", (16, 5))
@pytest.mark.parametrize("grid", ("untiled", "wide"))
def test_f_chain_plain_version_matches_rows_9_and_11(Bn, grid):
    """F's chain computes ``gru_layer_xp_reference`` (xp entering the gates
    unrounded, r * h in float32): its CPU path, and both routes' wrappers on
    CPU tensors, meet ``_fwd_pallas`` (``_fwd_wide_pallas``, batch tiles of
    8 rows, or the whole of a ragged batch) in interpret mode."""
    (jxp, jh0, ju), (xp, h0, u) = zip(*(_pair(a) for a in _layer_inputs(Bn, 3 + Bn)))
    if grid == "wide":
        want = ft._fwd_wide_pallas(jxp, jh0, ju, "tanh", True, 8 if Bn % 8 == 0 else Bn)
    else:
        want = ft._fwd_pallas(jxp, jh0, ju, "tanh", True)
    plain = port_layer.gru_layer_xp_reference(xp, h0, u)
    _close(plain, want, False, f"F chain B={Bn} {grid}")
    for fn in (port_layer.gru_layer_xp, port_layer.gru_layer_xp_fwd_chain,
               port_layer.gru_layer_xp_fwd_block):
        assert torch.equal(fn(xp, h0, u), plain), fn.__name__
    assert torch.equal(port_layer.gru_fwd_chain_reference(xp, h0, u, "tanh", True), plain)


def _tf32_rna(x):
    """x (float32) rounded to TF32 as cvt.rna does: ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """x (float32) as the tensor cores read it: the low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tc_product(a, b, chunk, products=3):
    """F's tensor-core product a (B, K) @ b (K, N): every operand split into
    a TF32 part and its remainder (a_lo b_hi + a_hi b_lo + a_hi b_hi, or the
    one product of the rounded operands as the control), each chunk of
    depth rows summed into zeroed sums, then added into the running sums."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    a_lo, b_lo = _tf32_trunc(a - a_hi), _tf32_trunc(b - b_hi)
    pairs = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if products == 3 else [(a_hi, b_hi)]
    run = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], chunk):
        run += sum(x[:, k:k + chunk] @ y[k:k + chunk] for x, y in pairs)
    return run


def _tc_layer(xp, h0, u, chunk, products=3):
    """F's tensor-core chain over xp with its products emulated."""
    h, out = h0, []
    for t in range(xp.shape[0]):
        p1 = _tc_product(h, u[:, : 2 * H], chunk, products)
        z = torch.sigmoid(xp[t, :, :H] + p1[:, :H])
        r = torch.sigmoid(xp[t, :, H : 2 * H] + p1[:, H:])
        hh = torch.tanh(xp[t, :, 2 * H :] + _tc_product(r * h, u[:, 2 * H :], chunk, products))
        h = z * h + (1.0 - z) * hh
        out.append(h)
    return torch.stack(out)


@pytest.mark.parametrize("chunk", (32, 64))
def test_f_tensor_core_arithmetic_reaches_float32_accuracy(chunk):
    """Three TF32 products, chunk by chunk, land within TC_REL_L2 of the
    float64 recurrence and within float32's tolerance of row 9; one TF32
    product (the control) lands over TC_REL_L2."""
    (jxp, jh0, ju), (xp, h0, u) = zip(*(_pair(a) for a in _layer_inputs(16, 21)))
    exact = port_layer.gru_layer_xp_reference(xp.double(), h0.double(), u.double())
    got = _tc_layer(xp, h0, u, chunk)
    err = _rel_l2(got, exact)
    assert err <= TC_REL_L2, f"three TF32 products: {err:.3e} > {TC_REL_L2:.1e}"
    _close(got, ft._fwd_pallas(jxp, jh0, ju, "tanh", True), False, "F tensor cores vs row 9")
    wrong = _rel_l2(_tc_layer(xp, h0, u, chunk, products=1), exact)
    assert wrong > TC_REL_L2, f"the one-product control lands {wrong:.3e}, inside {TC_REL_L2:.1e}"


def test_f_packed_slices_are_b_fragments():
    """``pack_tc_slices``: entry (c, k, n, g, t, j) of CTA c's P1 slice is
    depth row 8 k + 4 j + t of its column 8 n + g (z and r of its units),
    of the P2 slice the candidate column; a chunk of depth rows is one
    contiguous block."""
    u = torch.from_numpy(_layer_inputs(5, 2)[2])
    for C in (2, 4):
        Hc = H // C
        pzr, ph = port_layer.pack_tc_slices(u, C)
        assert pzr.shape == (C, H // 8, 2 * Hc // 8, 8, 4, 2) and pzr.is_contiguous()
        assert ph.shape == (C, H // 8, Hc // 8, 8, 4, 2) and ph.is_contiguous()
        for c in range(C):
            zr = torch.cat([u[:, c * Hc:(c + 1) * Hc], u[:, H + c * Hc:H + (c + 1) * Hc]], 1)
            hh = u[:, 2 * H + c * Hc:2 * H + (c + 1) * Hc]
            for slice_, cols in ((pzr[c], zr), (ph[c], hh)):
                want = cols.reshape(H // 8, 2, 4, -1, 8).permute(0, 3, 4, 2, 1)
                assert torch.equal(slice_, want)


# ---------------------------------------------------------------------------
# D wide: the chain's plain version against rows 7 and 13
# ---------------------------------------------------------------------------

def _head_inputs(n_layers, D, Bn, seed):
    """cells, out dense, initial states and start of one decode head."""
    rng = np.random.RandomState(seed)
    cells = [{"w": rng.randn(d, 3 * H) / np.sqrt(d), "u": rng.randn(H, 3 * H) / np.sqrt(H),
              "b": 0.1 * rng.randn(3 * H)} for d in (D, H)[:n_layers]]
    out = {"w": rng.randn(H, D) / np.sqrt(H), "b": 0.1 * rng.randn(D)}
    init = [0.5 * np.tanh(rng.randn(Bn, H)) for _ in range(n_layers)]
    start = np.abs(rng.randn(Bn, D))
    return cells, out, init, start / start.sum(-1, keepdims=True)


def _head_pairs(n_layers, D, Bn, seed, bf16):
    """The head's operands as (jax, torch) trees."""
    cells, out, init, start = _head_inputs(n_layers, D, Bn, seed)
    jt = lambda a: _pair(a, bf16)  # noqa: E731
    jcells = [{k: jt(v)[0] for k, v in c.items()} for c in cells]
    tcells = [{k: jt(v)[1] for k, v in c.items()} for c in cells]
    jout, tout = ({k: jt(v)[i] for k, v in out.items()} for i in (0, 1))
    jinit, tinit = ([jt(a)[i] for a in init] for i in (0, 1))
    jstart, tstart = jt(start)
    return (jcells, jout, jinit, jstart), (tcells, tout, tinit, tstart)


D_CASES = [(bf16, n, D, act, Bn) for bf16 in (False, True)
           for n, D, act in ((2, 16, "softmax"), (1, 8, "sigmoid"), (1, 16, "linear"))
           for Bn in (16, 5)]
D_IDS = [f"{'bf16' if b else 'f32'}-{n}L-D{d}-{a}-B{bn}" for b, n, d, a, bn in D_CASES]


@pytest.mark.parametrize("bf16, n_layers, D, act, Bn", D_CASES, ids=D_IDS)
def test_d_wide_chain_plain_version_matches_rows_7_and_13(bf16, n_layers, D, act, Bn):
    """B's chain phases composed over 2 and 4 CTAs' unit slices, with the h
    sequences stored and a bf16 head's roundings, and D wide's CPU path meet
    ``_dec_fwd_pallas`` and ``_dec_fwd_wide_pallas`` (batch tiles of 8 rows
    or the whole ragged batch) in interpret mode: probs, logits, h1seq
    (h2seq)."""
    (jc, jo, ji, js), (tc, to, ti, ts) = _head_pairs(n_layers, D, Bn, 31 + D + Bn, bf16)
    rows7 = ft._dec_fwd_pallas(jc, jo, ji, js, T, "tanh", act, True)
    rows13 = ft._dec_fwd_wide_pallas(jc, jo, ji, js, T, "tanh", act, True,
                                     8 if Bn % 8 == 0 else Bn)
    head = {"cells": tc, "out": to, "init": ti, "start": ts, "T": T, "out_activation": act}
    probs, logits, h_seqs = port_dec.gru_decode_fwd_train_wide([head])[0]
    for cluster in (2, 4):
        chain = port_dec.gru_decode_train_chain_reference(tc, to, ti, ts, T, act, cluster)
        got = (chain[0], chain[1], *chain[2])
        for want, row in ((rows7, "row 7"), (rows13, "row 13")):
            for name, g, w in zip(("probs", "logits", "h1seq", "h2seq"), got, want):
                assert g.dtype == ts.dtype, name
                _close(g, w, bf16, f"{name} C={cluster} against {row}")
                if bf16 and name.startswith("h"):
                    np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=BF16_ATOL)
    for name, g, w in zip(("probs", "logits", "h1seq", "h2seq"), (probs, logits, *h_seqs), rows13):
        _close(g, w, bf16, f"the CPU path's {name} against row 13")


def test_d_wide_bf16_with_layer_2_fed_the_rounded_h1_lands_outside():
    """The control: a bf16 chain whose layer 2 reads layer 1's h rounded to
    bf16 (the carry, not the float h of the step) lands over REL_L2 from
    row 13's h2seq, where the chain's float h meets it."""
    (jc, jo, ji, js), (tc, to, ti, ts) = _head_pairs(2, 16, 16, 8, True)
    want = ft._dec_fwd_wide_pallas(jc, jo, ji, js, T, "tanh", "softmax", True, 8)
    chain = port_dec.gru_decode_train_chain_reference(tc, to, ti, ts, T, "softmax", 4)
    assert _rel_l2(chain[2][1], want[3]) <= REL_L2
    cells = [{k: c[k].float() for k in ("w", "u", "b")} for c in tc]
    states, x, h2 = [s.float() for s in ti], ts.float(), []
    for _ in range(T):
        for i, p in enumerate(cells):
            z, rh, cand = port_dec.decode_layer_p1_reference(x, states[i], p)
            states[i] = port_dec.decode_layer_p2_reference(z, rh, cand, states[i], p["u"],
                                                           torch.tanh).to(BF).float()
            x = states[i]
        h2.append(x.to(BF))
        logits = x @ to["w"].float() + to["b"].float()
        x = torch.softmax(logits, -1).to(BF).float()
    err = _rel_l2(torch.stack(h2), want[3])
    assert err > REL_L2, f"the control lands {err:.3e} from row 13, inside {REL_L2:.1e}"


@pytest.mark.parametrize("bf16", (False, True))
def test_d_wide_stored_sequences_give_e_its_outputs(bf16):
    """E wide's plain backward fed the chain's stored h sequences (and its
    probs) gives the outputs it gives fed the plain forward's: bit for bit
    in bf16 (the stored values are equal), within float32's tolerance in
    float32 (the readout's partials sum in another order)."""
    (_j, (tc, to, ti, ts)) = _head_pairs(2, 16, 5, 12, bf16)
    chain = port_dec.gru_decode_train_chain_reference(tc, to, ti, ts, T, "softmax", 4)
    plain = port_dec.gru_decode_train_reference(tc, to, ti, ts, T, "softmax")
    rng = np.random.RandomState(4)
    g_probs, g_logits = (torch.from_numpy(0.1 * rng.randn(T, 5, 16).astype(np.float32))
                         for _ in range(2))
    outs = [port_dec.gru_decode_bwd_reference(tc, to, ti, ts, f[0], f[2], g_probs, g_logits,
                                              "softmax", wide=True) for f in (chain, plain)]
    for key in ("dlogits", "da", "rh", "d_init", "d_start"):
        got, want = outs[0][key], outs[1][key]
        for g, w in zip(got if isinstance(got, list) else [got], want if isinstance(want, list)
                        else [want]):
            if bf16:
                assert torch.equal(g, w), key
            else:
                _close(g, w, False, key)


def test_pack_slices_keep_the_weights_dtype():
    """D's bf16 chain streams the bf16 weights' slices as they are (the
    products widen them as they read them); each chunk of a CTA's segment
    is one contiguous block."""
    (_j, (tc, _o, _i, _s)) = _head_pairs(2, 16, 5, 3, True)
    packed = port_dec.pack_slices(tc, 4, 32)
    assert [t.dtype for t in packed] == [BF] * 6
    widened = port_dec.pack_slices([{k: c[k].float() for k in ("w", "u")} for c in tc], 4, 32)
    for got, want in zip(packed, widened):
        assert got.is_contiguous() and torch.equal(got.float(), want)
    Hc = H // 4
    # layer 1's x segment: D = 16 zero-padded to a chunk of 32 depth rows
    assert packed[0].shape == (4, 32, 3, Hc) and not packed[0][:, 16:].any()
    assert torch.equal(packed[0][1, :16, 2], tc[0]["w"][:, 2 * H + Hc:2 * H + 2 * Hc])


# ---------------------------------------------------------------------------
# the routes, the plans and the launch counts
# ---------------------------------------------------------------------------

# F's chain takes H whose CTA slice of U (H / C a multiple of 4) fits half a
# block's shared memory, or streams it (H a multiple of 64); the per-block
# route the rest
F_BLOCK_WIDTHS = {288, 352, 416, 480}


@pytest.mark.parametrize("H_", range(32, 513, 32))
def test_routes_at_every_width_f_and_d_launched_at_before(H_):
    assert _layout.gru_xp_fwd_route(H_) == ("block" if H_ in F_BLOCK_WIDTHS else "chain")
    assert _layout.xp_layer_limit("F", H_) is None
    for D, n in ((61, 2), (1, 1), (16, 1)):
        assert _layout.dec_train_route("D_wide", H_, D, n) == "chain"
        assert _layout._part_limit("D_wide", H_, D, n) is None
        if D >= 8:
            assert _layout._part_limit("D_wide_bf16", H_, D, n) is None


def test_routes_off_the_widths():
    """Off the multiples of 32 only F's chain launches, where one CTA holds
    the slice (H = 48); at H = 1024 F's streamed
    chain and D wide's chain have plans where their per-block designs do
    not launch (H threads over 512), and the route chooser holds the wide
    route to the chains' limits, so a step at 1024 takes it (on the card:
    ``chip_smoke.py``'s GRU(1024) phases)."""
    assert "multiple of 32" in _layout.xp_layer_limit("F", 200)
    assert _layout.gru_xp_fwd_route(48) == "chain"  # A's chain: the whole slice in one CTA
    for H_ in (48, 200):
        assert _layout._part_limit("D_wide", H_, 61, 2) is not None
    assert _layout.gru_xp_fwd_route(1024) == "chain"
    assert _layout.gru_fwd_cluster("F_chain", 1024) == (16, True)
    assert _layout.gru_tc_plan(1024, 256) is not None
    assert "__launch_bounds__" in _layout.launch_limit("F", 1024, _layout.smem_bytes("F", 1024))
    assert _layout.dec_train_route("D_wide", 1024, 61, 2) == "chain"
    assert _layout.dec_train_plan(1024, 61, 2, 256).rows >= 1
    # the first designs' limits stay the per-block routes' (``_part_limit``),
    # and the route chooser reads the chains' (``dec_train_limit``)
    assert "__launch_bounds__" in _layout._part_limit("D_wide", 1024, 61, 2)
    assert _layout.dec_train_limit("D_wide", 1024, 61, 2) is None
    assert _layout.train_route(1024, [(61, False)], [(61, 2)]) == "wide"


def _bwd_chain_test_module():
    path = os.path.join(os.path.dirname(__file__), "test_torch_gru_bwd_chain.py")
    spec = importlib.util.spec_from_file_location("_gru_bwd_chain_answers_fd", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config_routes_and_head_builds_keep_their_answers():
    """``train_route``, ``config_route``, ``bf16_layer_mode``,
    ``bf16_head_mode`` and ``head_builds`` give the answers recorded before
    F and D wide ran on chains (F's and D wide's launch limits now come from
    their routes)."""
    mod = _bwd_chain_test_module()
    with open(mod.ROUTES) as f:
        want = json.load(f)
    configs = mod._route_configs()
    for name, cfg in configs.items():
        assert mod._route_answers(_layout, cfg) == want[name], name


def _near_best():
    with open(NEAR_BEST) as f:
        return json.load(f)


def test_f_plan_picks_are_near_the_fastest():
    """F's chain plan at each of its timed shapes is among the plans the
    H100 ran within 10 % of the fastest (cluster x rows / splits / stages,
    or its tensor-core instance's cluster x rows / chunk / stages)."""
    table = _near_best()["F"]
    assert table
    for case, near in table.items():
        H_, Bn = (int(v) for v in case.split(","))
        _C, stream = _layout.gru_fwd_cluster("F_chain", H_)
        if stream:
            p = _layout.gru_tc_plan(H_, Bn)
            key = f"tc {p.cluster}x{p.rows}/{p.chunk}/st{p.stages}"
        else:
            p = _layout.gru_fwd_plan("F_chain", H_, Bn)
            key = f"{p.cluster}x{p.rows}/s{p.splits}/st{p.stages}"
        assert key in near, (case, key, near)
        assert p.rows * p.clusters >= Bn and p.smem <= _layout.SMEM_PER_BLOCK


def test_d_wide_plan_picks_are_near_the_fastest():
    """D wide's chain plan for each head of the wide paths is among the
    plans the H100 ran within 10 % of the fastest (cluster x rows / chunk,
    "tc" for the tensor-core instance)."""
    table = _near_best()["D"]
    assert table
    for case, near in table.items():
        bf16, D, n, steps, Bn = case.split(",")
        p = _layout.dec_train_plan(512, int(D), int(n), int(Bn), int(steps), bf16 == "bf16")
        assert f"{'tc ' if p.tc else ''}{p.cluster}x{p.rows}/{p.chunk}" in near, (case, p, near)
        assert p.rows * p.clusters >= int(Bn) and p.smem <= _layout.DEC_SMEM


def test_tc_plans_fit_and_take_their_shared_memory():
    """Every plan of F's tensor-core instance fits a block's shared memory
    beside the ring's mbarriers, its owners within a CTA's threads and its
    warps' items within GRU_TC_MAX_ITEMS; the formula counts the ring, the
    tiles, the gate sums and the owners' xp."""
    for Bn in (256, 16, 5):
        plans = _layout.gru_tc_plans(512, Bn)
        assert plans
        for p in plans:
            assert 2 <= p.stages <= 8 and p.smem <= _layout.GRU_TC_SMEM
            Hc = 512 // p.cluster
            assert Hc * -(-p.rows // 8) <= _layout.CHAIN_THREADS
            assert p.smem == _layout.gru_tc_smem(512, p.cluster, p.rows, p.stages, p.chunk)
    assert _layout.gru_tc_stride(18) == 24 and _layout.gru_tc_stride(16) == 24
    assert _layout.gru_tc_stride(32) == 40 and _layout.gru_tc_stride(5) == 8
    assert _layout.gru_tc_splits(8, 8) == 2 and _layout.gru_tc_splits(16, 8) == 1
    assert _layout.gru_tc_stages(512, 8, 200, 32) == 0  # its owners would outnumber its threads


def _fake_lib():
    return SimpleNamespace(mvt_error_string=lambda rc: b"")


def test_f_launches_count_by_route(monkeypatch):
    """F's chain and per-block route, launched as on the card (the entry
    points stubbed to return success), each count on their own wrapper and,
    as one call of F, on ``gru_layer_xp`` (``.launches`` and the route's
    counter)."""
    calls = []
    entry = lambda *a: calls.append(len(a)) or 0  # noqa: E731
    monkeypatch.setattr(port_layer, "_xp_fwd_kernel", lambda: (_fake_lib(), {
        "chain": entry, "tc": entry, "block": entry}))
    monkeypatch.setattr(port_layer, "_stream", lambda t: None)
    monkeypatch.setattr(port_layer, "_check_f", lambda xp, h0, u, what: tuple(
        xp.shape[:2]) + (u.shape[0],))
    monkeypatch.setattr(port_layer, "xp_fwd_plan", lambda H_, B_: _layout.gru_fwd_plan(
        "F_chain", H_, B_))
    for fn in (port_layer.gru_layer_xp, port_layer.gru_layer_xp_fwd_chain,
               port_layer.gru_layer_xp_fwd_block):
        for attr in ("launches", "launches_chain", "launches_block"):
            monkeypatch.setattr(fn, attr, 0, raising=False)
    xp, h0, u = (torch.from_numpy(a) for a in _layer_inputs(5, 2))
    port_layer.gru_layer_xp_fwd_chain(xp, h0, u)
    port_layer.gru_layer_xp_fwd_chain(xp, h0, u)
    port_layer.gru_layer_xp_fwd_block(xp, h0, u)
    assert calls == [12, 12, 8]
    assert port_layer.gru_layer_xp_fwd_chain.launches == 2
    assert port_layer.gru_layer_xp_fwd_block.launches == 1
    f = port_layer.gru_layer_xp
    assert (f.launches, f.launches_chain, f.launches_block) == (3, 2, 1)


def test_d_wide_launches_count_by_route_and_build(monkeypatch):
    """D wide's chain (one launch a head) and per-block route (the call's
    per-block heads in one launch), launched as on the card by D's one
    launch function (the entries stubbed), count on the build's counter and
    on the route's."""
    calls = []
    monkeypatch.setattr(port_dec, "_d_entries", lambda build: (
        _fake_lib(), lambda *a: calls.append(("chain", build)) or 0,
        lambda *a: calls.append(("block", build)) or 0))
    monkeypatch.setattr(port_dec, "dec_plan", lambda H_, D, n, B_, T_, bf16: (
        _layout.dec_train_plan(H_, D, n, B_, T_, bf16)))
    monkeypatch.setattr(port_dec, "_packed_slices", lambda cells, C, K, tc: [
        torch.zeros(1)] * 3 * len(cells))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(
        cuda_stream=0))
    fn = port_dec.gru_decode_fwd_train_wide
    for attr in ("launches", "launches_chain", "launches_block"):
        for sfx in ("", "_bf16"):
            monkeypatch.setattr(fn, attr + sfx, 0)
    heads = []
    for bf16 in (False, True):
        (_j, (tc, to, ti, ts)) = _head_pairs(2, 16, 5, 1, bf16)
        head = {"cells": tc, "out": to, "init": ti, "start": ts, "T": T, "out_activation": "softmax"}
        heads.append(head)
    structs = [port_dec._DecodeHead(), port_dec._DecodeHead()]
    port_dec._launch_heads("D_wide", [heads[0], heads[0]], structs, 5, H, "cuda")
    port_dec._launch_heads("D_wide_bf16", [heads[1]], structs[:1], 5, H, "cuda")
    monkeypatch.setattr(_layout, "dec_train_route", lambda *a: "block")
    port_dec._launch_heads("D_wide", [heads[0], heads[0]], structs, 5, H, "cuda")
    assert calls == [("chain", "D_wide")] * 2 + [("chain", "D_wide_bf16"), ("block", "D_wide")]
    assert (fn.launches, fn.launches_chain, fn.launches_block) == (3, 2, 1)
    assert (fn.launches_bf16, fn.launches_chain_bf16, fn.launches_block_bf16) == (1, 1, 0)
