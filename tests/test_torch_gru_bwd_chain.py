"""CPU tests of the GRU backward's phases (kernels C and E,
``midi_vae_tpu_torch/csrc/gru_cell_bwd_chain.cuh``): the plain versions of
the gate pre-pass (``gru_bwd_gates_reference``), of C's chain
(``gru_bwd_chain_reference``) and dx pass (``gru_bwd_dx_reference``), and of
E's chain through a whole head (``gru_decode_bwd_chain_reference``),
composed with kernel W's plain version, against the JAX package's kernels in
interpret mode: ``_bwdx_pallas`` (rows 1 and 4, f32 and bf16), and for the
heads ``_dec_bwd_pallas`` (rows 7 and 8), ``_dec_bwd_wide_pallas`` (rows 13
and 14, whose streams are rounded) and ``multihead_decode_train_bwd``
(rows 5 and 6, with float32 and bf16 residuals). Then a torch emulation of
the chain's partition (each CTA's partials over its own gate rows, taken in
chunks of 16 rows, summed in peer order), the bf16 control, the phase
wrappers' CPU paths, the chain's plans (``ops/_layout.py::gru_bptt_plan``)
and the route chooser's answers, pinned to those of the per-block C and E.

Sizes: T 6, B 9 or 16, H 32 or 64, D 1, 5, 16 and 61; the JAX references run
once per case in module-scoped fixtures. Tolerances:
- float32 against the JAX kernels: atol 1e-5 + rtol 1e-4
  (``tests/test_torch_lstm_bptt_phases.py``); the pre-pass takes its
  products over all T B rows at once, so the CPU sums in another order;
- bf16: relative L2 REL_L2 = 3e-4 per output (``tests/test_torch_bf16_fused.py``:
  a rounding flip where float32 sums taken in another order straddle a bf16
  boundary);
- the multi-head call: rtol 3e-4, atol 2e-6 (``tests/test_torch_residual_bf16.py``,
  the JAX package's own tolerance of its kernel);
- the partition's emulation against the plain chain: float32 sums in
  another order, max|diff| <= 1e-5 of the largest entry;
- the control: the chain with da rounded once to bf16 before the products
  (a bf16 tensor-core product of it would take it so) lands over REL_L2
  from ``_bwdx_pallas``'s dh0.
"""

import glob
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from midi_vae_tpu.ops import fused_train as ft
from midi_vae_tpu_torch.config import Config
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import grad_reduce as port_gr
from midi_vae_tpu_torch.ops import gru_decode as port_decode
from midi_vae_tpu_torch.ops import gru_layer as port_layer

BF = torch.bfloat16
ATOL, RTOL = 1e-5, 1e-4
REL_L2 = 3e-4
MH_RTOL, MH_ATOL = 3e-4, 2e-6
EMU_RTOL = 1e-5
T = 6


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
    """A jnp array as a torch tensor of ``like``'s dtype."""
    return torch.from_numpy(_np(a).copy()).to(like.dtype)


# ---------------------------------------------------------------------------
# C: the pre-pass, the chain and the dx pass against _bwdx_pallas
# ---------------------------------------------------------------------------

def _layer_inputs(Bn, D, H, seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(T, Bn, D).astype(np.float32),
            (0.5 * np.tanh(rng.randn(Bn, H))).astype(np.float32),
            (rng.randn(D, 3 * H) / np.sqrt(D)).astype(np.float32),
            (0.1 * rng.randn(3 * H)).astype(np.float32),
            (rng.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32)]


C_CASES = [(False, True, True, 61, 32, 9), (False, False, False, 5, 64, 16),
           (False, True, False, 1, 32, 16), (True, True, True, 61, 64, 9),
           (True, False, True, 5, 32, 16), (True, True, False, 16, 64, 9)]
C_IDS = [f"{'bf16' if c[0] else 'f32'}-{'seq' if c[1] else 'last'}-{'dx' if c[2] else 'nodx'}"
         f"-D{c[3]}-H{c[4]}-B{c[5]}" for c in C_CASES]


@pytest.fixture(scope="module", params=C_CASES, ids=C_IDS)
def c_case(request):
    """(case, torch inputs, the forward's sequence, the incoming grad, JAX's
    (dx, dh0, dW, db, dU) from _bwdx_pallas in interpret mode)."""
    bf16, rs, need_dx, D, H, Bn = request.param
    jargs, targs = zip(*(_pair(a, bf16) for a in _layer_inputs(Bn, D, H, D + H + Bn)))
    jx, jh0, jw, jb, ju = jargs
    jseq = ft._fwdx_pallas(jx, jh0, jw, jb, ju, "tanh", True)
    rng = np.random.RandomState(7)
    g = (rng.randn(T, Bn, H) if rs else rng.randn(Bn, H)).astype(np.float32)
    jg, tg = _pair(g, bf16)
    zeros = jnp.zeros_like(jseq)
    want = ft._bwdx_pallas(jx, jseq, jh0, jg if rs else zeros,
                           jnp.zeros_like(jh0) if rs else jg, jw, jb, ju, rs, True)
    return request.param, targs, _t(jseq, targs[0]), tg, want


def test_c_phases_compose_to_rows_1_and_4(c_case):
    """C's pre-pass (gates and r * h from x and hprev = [h0, hseq[:-1]]),
    chain and dx pass, composed, with kernel W's plain version for dW, db
    and dU, give what _bwdx_pallas emits, and the op's plain version's
    outputs (D = 5 in bf16 is the cast_x case: W widened, the same
    products)."""
    (bf16, rs, need_dx, D, H, Bn), (x, h0, w, b, u), seq, g, want = c_case
    d_seq, d_final = (g, None) if rs else (None, g)
    hprev = torch.cat([h0[None], seq[:-1]])
    gates, rh = port_layer.gru_bwd_gates_reference(x, hprev, w, b, u)
    assert gates.dtype == rh.dtype == torch.float32
    assert gates.shape == (T, Bn, 3 * H) and rh.shape == (T, Bn, H)
    da, dh0 = port_layer.gru_bwd_chain_reference(gates, hprev, d_seq, d_final, u)
    assert da.dtype == dh0.dtype == torch.float32
    dh0 = dh0.to(x.dtype)
    dx = port_layer.gru_bwd_dx_reference(da, w) if need_dx else None
    dw, db, du = port_gr.gru_weight_grads(x, hprev, rh, da)
    got = (dx, dh0, dw, db, du)
    for name, gv, wv in zip(("dx", "dh0", "dW", "db", "dU"), got, want):
        if gv is None:
            continue
        _close(gv, wv.reshape(gv.shape) if name == "db" else wv, bf16,
               f"{name} against _bwdx_pallas")
    ref = port_layer.gru_layer_bwd_reference(x, seq, h0, d_seq, d_final, w, b, u, need_dx)
    for name, gv, rv in zip(("dx", "dh0", "da_cat", "rh"), (dx, dh0, da, rh), ref):
        if gv is not None:
            _close(gv, rv, bf16 and name in ("dx", "dh0"), f"{name} against the plain op",
                   rtol=1e-5, atol=1e-6)


def test_the_chain_with_da_rounded_to_bf16_lands_outside():
    """The control: one bf16 rounding of da before the chain's products (a
    bf16 tensor-core product of it would take it so) computes another
    function: dh0 lands over REL_L2 from _bwdx_pallas's, where the chain's
    float da meets it."""
    D, H, Bn = 61, 64, 16
    jargs, (x, h0, w, b, u) = zip(*(_pair(a, True) for a in _layer_inputs(Bn, D, H, 3)))
    jx, jh0, jw, jb, ju = jargs
    jseq = ft._fwdx_pallas(jx, jh0, jw, jb, ju, "tanh", True)
    g = np.random.RandomState(5).randn(T, Bn, H).astype(np.float32)
    jg, tg = _pair(g, True)
    want = ft._bwdx_pallas(jx, jseq, jh0, jg, jnp.zeros_like(jh0), jw, jb, ju, True, True)[1]
    seq = _t(jseq, x)
    hprev = torch.cat([h0[None], seq[:-1]])
    gates, _rh = port_layer.gru_bwd_gates_reference(x, hprev, w, b, u)
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
    assert err > REL_L2, f"the control lands {err:.3e} from _bwdx_pallas, inside {REL_L2:.1e}"


def test_bf16_chain_products_take_da_in_three_terms():
    """The bf16 chain's products on the tensor cores: da (float32) split
    into three bf16 terms (each difference exact in float32), each term
    times the exact bf16 weights, the chunk of 16 gate rows summed and added
    into the running float32 sum, land within 1e-6 relative L2 of a float64
    product; one bf16 rounding of da (one product) lands over 1e-3: another
    function."""
    rng = np.random.RandomState(11)
    rows, K, N = 16, 96, 256
    da = torch.from_numpy((rng.randn(rows, K) * np.exp(rng.randn(rows, K))).astype(np.float32))
    w = torch.from_numpy(rng.randn(K, N).astype(np.float32)).to(BF).float()
    want = da.double() @ w.double()
    terms, rest = [], da
    for _ in range(3):
        t = rest.to(BF).float()
        terms.append(t)
        rest = rest - t
    got = torch.zeros(rows, N)
    for k0 in range(0, K, CHUNK):
        chunk = sum((t[:, k0 : k0 + CHUNK] @ w[k0 : k0 + CHUNK] for t in reversed(terms)),
                    torch.zeros(rows, N))
        got = got + chunk
    assert _rel_l2(got, want) <= 1e-6
    assert _rel_l2(da.to(BF).float() @ w, want) > 1e-3


# ---------------------------------------------------------------------------
# E: the pre-pass per layer and the chain through the head against the
# decode kernels
# ---------------------------------------------------------------------------

def _head_inputs(n_layers, D, H, Bn, seed):
    rng = np.random.RandomState(seed)
    cells, d = [], D
    for _ in range(n_layers):
        cells.append({"w": (rng.randn(d, 3 * H) / np.sqrt(d)).astype(np.float32),
                      "u": (rng.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32),
                      "b": (0.1 * rng.randn(3 * H)).astype(np.float32)})
        d = H
    out = {"w": (rng.randn(H, D) / np.sqrt(H)).astype(np.float32),
           "b": (0.1 * rng.randn(D)).astype(np.float32)}
    init = [(0.5 * np.tanh(rng.randn(Bn, H))).astype(np.float32) for _ in range(n_layers)]
    start = (rng.rand(Bn, D) / D).astype(np.float32)
    return cells, out, init, start


def _j(tree, bf16):
    return jax.tree_util.tree_map(lambda a: _pair(a, bf16)[0], tree)


def _tt(tree, bf16):
    return jax.tree_util.tree_map(lambda a: _pair(a, bf16)[1], tree)


def _port_head(cells, out, init, start, probs, h_seqs, g_probs, g_logits, out_act):
    return {"cells": cells, "out": out, "init": init, "start": start, "probs": probs,
            "h_seqs": h_seqs, "g_probs": g_probs, "g_logits": g_logits,
            "out_activation": out_act, "T": probs.shape[0]}


def _composed_head(head, wide=False):
    """E's phases' plain versions (the pre-pass of each layer, the chain)
    and W's: {dlogits, da, rh, d_init, d_start, weight grads per layer (dW,
    dU, db), dWo, dbo}."""
    gates = port_decode.gru_decode_bwd_gates([head])[0]
    hprevs = [hp for _x, hp in port_decode._layer_inputs(head)]
    g = port_decode.gru_decode_bwd_chain_reference(head, [gt for gt, _rh in gates], hprevs, wide)
    g["rh"] = [rh for _gt, rh in gates]
    T_, (Bn, D), H = head["T"], head["start"].shape, head["init"][0].shape[-1]
    dwo, dbo = torch.empty(H, D), torch.empty(D)
    port_gr.grad_reduce(head["h_seqs"][-1].reshape(T_ * Bn, H), g["dlogits"].reshape(T_ * Bn, D),
                        dwo, dbo)
    g["cells"] = []
    for i, (x, hp) in enumerate(port_decode._layer_inputs(head)):
        x = head["h_seqs"][i - 1] if i > 0 else x
        hp = torch.cat([head["init"][i][None], head["h_seqs"][i][:-1]])
        g["cells"].append(port_gr.gru_weight_grads(x, hp, g["rh"][i], g["da"][i]))
    g["dwo"], g["dbo"] = dwo, dbo
    return g


HEAD_CASES = [(False, 2, 61, "softmax", 32, 9), (False, 1, 1, "sigmoid", 64, 16),
              (False, 1, 16, "linear", 32, 16), (True, 2, 61, "softmax", 64, 16),
              (True, 1, 16, "softmax", 32, 16), (True, 2, 16, "sigmoid", 32, 16),
              (True, 1, 5, "linear", 64, 16)]
HEAD_IDS = [f"{'bf16' if c[0] else 'f32'}-{c[1]}L-D{c[2]}-{c[3]}-H{c[4]}-B{c[5]}"
            for c in HEAD_CASES]


@pytest.fixture(scope="module", params=HEAD_CASES, ids=HEAD_IDS)
def head_case(request):
    """(case, the port's head dict, JAX's forward (probs, h_seqs), its
    in-place backward (rows 7 and 8) and its wide backward (rows 13 and
    14), both in interpret mode)."""
    bf16, n_layers, D, out_act, H, Bn = request.param
    cells, out, init, start = _head_inputs(n_layers, D, H, Bn, 10 * D + H)
    jc, jo, ji, js = (_j(a, bf16) for a in (cells, out, init, start))
    probs, logits, *h_seqs = ft._dec_fwd_pallas(jc, jo, ji, js, T, "tanh", out_act, True)
    rng = np.random.RandomState(D + n_layers)
    jgp, tgp = _pair(0.3 * rng.randn(*probs.shape), bf16)
    jgl, tgl = _pair(0.3 * rng.randn(*probs.shape), bf16)
    inplace = ft._dec_bwd_pallas(jc, jo, ji, js, probs, h_seqs, jgp, jgl, out_act, True)
    wide = ft._dec_bwd_wide_pallas(jc, jo, ji, js, probs, h_seqs, jgp, jgl, out_act, True, Bn)
    tc, to, ti, ts = (_tt(a, bf16) for a in (cells, out, init, start))
    tp = _t(probs, ts)
    th = [_t(h, ts) for h in h_seqs]
    head = _port_head(tc, to, ti, ts, tp, th, tgp, tgl, out_act)
    return request.param, head, inplace, wide


def test_e_phases_compose_to_rows_7_and_8(head_case):
    """E's pre-pass and chain (the narrow builds' unrounded streams) and W,
    composed, give _dec_bwd_pallas's weight grads, d_init and d_start, and
    the op's plain version's outputs."""
    (bf16, n_layers, D, out_act, H, Bn), head, inplace, _wide = head_case
    g = _composed_head(head)
    want = list(inplace)
    got = []
    for dw, db, du in g["cells"]:
        got += [dw, du, db]
    got += [g["dwo"], g["dbo"], *g["d_init"], g["d_start"]]
    assert len(got) == len(want)
    for i, (gv, wv) in enumerate(zip(got, want)):
        _close(gv, _np(wv).reshape(gv.shape), bf16, f"output {i} against _dec_bwd_pallas")
    ref = port_decode.gru_decode_bwd_reference(head["cells"], head["out"], head["init"],
                                               head["start"], head["probs"], head["h_seqs"],
                                               head["g_probs"], head["g_logits"], out_act)
    for k in ("dlogits", "d_start"):
        _close(g[k], ref[k], bf16 and k == "d_start", f"{k} against the plain op", 1e-5, 1e-6)
    for k in ("da", "rh", "d_init"):
        for i, (gv, rv) in enumerate(zip(g[k], ref[k])):
            _close(gv, rv, bf16 and k == "d_init", f"{k}[{i}] against the plain op", 1e-5, 1e-6)


def test_e_wide_rounding_matches_rows_13_and_14(head_case):
    """E wide's build (rows 13 and 14): dlogits and the gate grads leave
    rounded to the heads' dtype (bf16 values in float32 tensors), the
    carries read the unrounded values: the chain's plain version with
    ``wide`` against _dec_bwd_wide_pallas's streams, d_init and d_start."""
    (bf16, n_layers, D, out_act, H, Bn), head, _inplace, wide = head_case
    g = _composed_head(head, wide=True)
    got = [g["dlogits"], *g["da"], *g["d_init"], g["d_start"]]
    assert len(got) == len(wide)
    for i, (gv, wv) in enumerate(zip(got, wide)):
        _close(gv, wv, bf16, f"output {i} against _dec_bwd_wide_pallas")
    if bf16:  # the streams hold bf16 values
        for s in (g["dlogits"], *g["da"]):
            assert s.dtype == torch.float32 and torch.equal(s, s.to(BF).float())


MH_CASES = [(None, ("softmax", "sigmoid")), (BF, ("softmax", "sigmoid", "sigmoid")),
            (BF, ("linear", "softmax"))]


@pytest.mark.parametrize("residual, out_acts", MH_CASES,
                         ids=[f"{'bf16' if r else 'f32'}-residuals-{'-'.join(a)}"
                              for r, a in MH_CASES])
def test_e_phases_compose_to_rows_5_and_6(residual, out_acts):
    """The multi-head call (rows 5 and 6, a 2-layer primary head and 1-layer
    side heads), with float32 or bf16 residuals (E_resid: the gates from
    the rounded h, the unrounded initial states at t = 0, layer 2's dW and
    dWo over the rounded sequences): E's phases and W, composed, give
    multihead_decode_train_bwd's gradients (through the JAX op's VJP)."""
    H, Bn = 32, 9
    dims = (7, 1, 2)[: len(out_acts)]
    specs = [_head_inputs(2 if k == 0 else 1, d, H, Bn, 20 + k) for k, d in enumerate(dims)]
    trees = [{"cells": c, "out": o, "init": i, "start": s} for c, o, i, s in specs]
    jt = [_j(t, False) for t in trees]
    rdt = jnp.bfloat16 if residual is not None else None
    fwd = ft.multihead_decode_train_fwd(jt[0], jt[1:], T, "tanh", out_acts, True, rdt)
    outs, vjp = jax.vjp(lambda p, hs: ft.gru_decode_multihead_train(
        p, hs, T, "tanh", out_acts, True, rdt), jt[0], tuple(jt[1:]))
    rng = np.random.RandomState(3)
    cots = [tuple(jnp.asarray(0.3 * rng.randn(*a.shape), jnp.float32) for a in pl) for pl in outs]
    gp, gh = vjp(tuple(cots))
    heads = []
    seqs = [(fwd[2], fwd[3])] + [(fwd[4 + 3 * k + 2],) for k in range(len(dims) - 1)]
    probs = [fwd[0]] + [fwd[4 + 3 * k] for k in range(len(dims) - 1)]
    for k, (tree, oa) in enumerate(zip(trees, out_acts)):
        tc, to, ti, ts = (_tt(tree[n], False) for n in ("cells", "out", "init", "start"))
        th = [torch.from_numpy(_np(h).copy()).to(residual or torch.float32) for h in seqs[k]]
        heads.append(_port_head(tc, to, ti, ts, _t(probs[k], ts), th,
                                *(torch.from_numpy(_np(c).copy()) for c in cots[k]), oa))
    for k, (head, jg) in enumerate(zip(heads, [gp, *gh])):
        g = _composed_head(head)
        want = [jg["start"], *jg["init"]]
        for c in jg["cells"]:
            want += [c["w"], c["u"], c["b"]]
        want += [jg["out"]["w"], jg["out"]["b"]]
        got = [g["d_start"], *g["d_init"]]
        for dw, db, du in g["cells"]:
            got += [dw, du, db]
        got += [g["dwo"], g["dbo"]]
        for i, (gv, wv) in enumerate(zip(got, want)):
            np.testing.assert_allclose(_np(gv), _np(wv).reshape(_np(gv).shape), rtol=MH_RTOL,
                                       atol=MH_ATOL, err_msg=f"head {k} leaf {i}")


# ---------------------------------------------------------------------------
# the partition: the chain's reduce-scatter over C CTAs, emulated
# ---------------------------------------------------------------------------

CHUNK = _layout.GRU_BWD_CHUNK


def _own(q, H, Hc, c):
    """Gate q's columns of CTA c's units."""
    return [q * H + c * Hc + u for u in range(Hc)]


def _partial(da_tile, src, gates_local, H, Hc, c):
    """A CTA's partial: its da tile's local gate rows . the source's rows
    of those gates, in chunks of CHUNK rows as the ring serves them."""
    out = torch.zeros(da_tile.shape[0], src.shape[1])
    for g0 in range(gates_local[0], gates_local[1], CHUNK):
        rows = [(gl // Hc) * H + c * Hc + gl % Hc for gl in range(g0, g0 + CHUNK)]
        out += da_tile[:, g0 : g0 + CHUNK] @ src[rows]
    return out


def _emulated_step(gates_t, hp_t, dh, ut, wt, C, H):
    """One layer's reverse step as the chain runs it over C CTAs: E1 into
    each CTA's da tile (rows, 3 Hc: [da_z, da_r, da] of its units), S1 over
    the candidate rows, R1 (its units' columns summed in peer order), S2
    over the z and r rows (and all three of W^T where given), R2. Returns
    (da_cat, dh_{t-1}, dx or None)."""
    Hc = H // C
    z, r, hh = gates_t[:, :H], gates_t[:, H : 2 * H], gates_t[:, 2 * H :]
    tiles = []
    for c in range(C):
        own = slice(c * Hc, (c + 1) * Hc)
        tile = torch.zeros(gates_t.shape[0], 3 * Hc)
        tile[:, :Hc] = dh[:, own] * (hp_t[:, own] - hh[:, own]) * z[:, own] * (1 - z[:, own])
        tile[:, 2 * Hc :] = dh[:, own] * (1 - z[:, own]) * (1 - hh[:, own] ** 2)
        tiles.append(tile)
    parts = [_partial(tiles[c], ut, (2 * Hc, 3 * Hc), H, Hc, c) for c in range(C)]
    drh = torch.zeros_like(dh)
    for c in range(C):
        own = slice(c * Hc, (c + 1) * Hc)
        for p in parts:  # rank order
            drh[:, own] += p[:, own]
        tiles[c][:, Hc : 2 * Hc] = drh[:, own] * hp_t[:, own] * r[:, own] * (1 - r[:, own])
    parts = [_partial(tiles[c], ut, (0, 2 * Hc), H, Hc, c) for c in range(C)]
    dx_parts = ([_partial(tiles[c], wt, (0, 3 * Hc), H, Hc, c) for c in range(C)]
                if wt is not None else None)
    new = dh * z + drh * r
    for c in range(C):
        own = slice(c * Hc, (c + 1) * Hc)
        for p in parts:
            new[:, own] += p[:, own]
    dx = None
    if dx_parts is not None:
        dx = torch.zeros(gates_t.shape[0], wt.shape[1])
        for p in dx_parts:
            dx += p
    da_cat = torch.cat([torch.cat([t[:, q * Hc : (q + 1) * Hc] for t in tiles], -1)
                        for q in range(3)], -1)
    return da_cat, new, dx


@pytest.mark.parametrize("C", [2, 4])
def test_the_partition_of_cs_chain(C):
    """C's chain over C CTAs of 16 units (H 32 at C = 2, 64 at C = 4): the
    index maps of the local gate rows (q Hc + u is gate q H + c Hc + u),
    the chunks of 16 rows, the reductions over the own units in peer order
    give the plain chain's da_cat and dh0."""
    H, D, Bn = 16 * C, 5, 9
    x, h0, w, b, u = (torch.from_numpy(a) for a in _layer_inputs(Bn, D, H, C))
    seq = port_layer.gru_layer_reference(x, h0, w, b, u, "tanh", True)
    hprev = torch.cat([h0[None], seq[:-1]])
    d_seq = torch.from_numpy(np.random.RandomState(C).randn(T, Bn, H).astype(np.float32))
    gates, _rh = port_layer.gru_bwd_gates_reference(x, hprev, w, b, u)
    want_da, want_dh0 = port_layer.gru_bwd_chain_reference(gates, hprev, d_seq, None, u)
    ut = u.t().contiguous()
    dh = torch.zeros(Bn, H)
    da = [None] * T
    for t in reversed(range(T)):
        dh = dh + d_seq[t]
        da[t], dh, _ = _emulated_step(gates[t], hprev[t], dh, ut, None, C, H)
    for name, g, wv in (("da_cat", torch.stack(da), want_da), ("dh0", dh, want_dh0)):
        assert (g - wv).abs().max() <= EMU_RTOL * wv.abs().max(), name


@pytest.mark.parametrize("C", [2, 4])
def test_the_partition_of_es_chain(C):
    """E's chain over C CTAs for a 2-layer head: every CTA computes dlogits
    of its rows' D columns and dlogits . Wo^T over its own units, layer 2's
    dx (W2^T's rows in S2) summed over the own units into layer 1's dh,
    layer 1's dx (W1^T's rows, D columns) summed whole: the plain chain's
    dlogits, gate grads, d_init and d_start."""
    H, D, Bn = 16 * C, 5, 9
    cells, out, init, start = (_tt(a, False) for a in _head_inputs(2, D, H, Bn, C))
    fwd = port_decode.gru_decode_fwd_train([{"cells": cells, "out": out, "init": init,
                                             "start": start, "T": T, "out_activation": "softmax"}])
    probs, _logits, h_seqs = fwd[0]
    rng = np.random.RandomState(C)
    head = _port_head(cells, out, init, start, probs, h_seqs,
                      torch.from_numpy(0.3 * rng.randn(T, Bn, D).astype(np.float32)),
                      torch.from_numpy(0.3 * rng.randn(T, Bn, D).astype(np.float32)), "softmax")
    gates = [gt for gt, _rh in port_decode.gru_decode_bwd_gates([head])[0]]
    hprevs = [hp for _x, hp in port_decode._layer_inputs(head)]
    want = port_decode.gru_decode_bwd_chain_reference(head, gates, hprevs)
    uts = [c["u"].t().contiguous() for c in cells]
    wts = [c["w"].t().contiguous() for c in cells]
    dh = [torch.zeros(Bn, H), torch.zeros(Bn, H)]
    dx_fed = torch.zeros(Bn, D)
    dlog, da = [None] * T, [[None] * T, [None] * T]
    for t in reversed(range(T)):
        dlog[t] = port_decode.dlogits_from(probs[t], head["g_probs"][t] + dx_fed,
                                           head["g_logits"][t], "softmax")
        top = torch.zeros(Bn, H)
        for c in range(C):  # each CTA over its own units: Wo's own rows
            own = slice(c * H // C, (c + 1) * H // C)
            top[:, own] = dlog[t] @ out["w"][own].t()
        dh[1] = dh[1] + top
        da[1][t], dh[1], dx2 = _emulated_step(gates[1][t], hprevs[1][t], dh[1], uts[1], wts[1],
                                              C, H)
        dh[0] = dh[0] + dx2
        da[0][t], dh[0], dx_fed = _emulated_step(gates[0][t], hprevs[0][t], dh[0], uts[0],
                                                 wts[0], C, H)
    got = {"dlogits": torch.stack(dlog), "da": [torch.stack(a) for a in da], "d_init": dh,
           "d_start": dx_fed}
    for k in ("dlogits", "d_start"):
        assert (got[k] - want[k]).abs().max() <= EMU_RTOL * want[k].abs().max(), k
    for k in ("da", "d_init"):
        for i, (g, wv) in enumerate(zip(got[k], want[k])):
            assert (g - wv).abs().max() <= EMU_RTOL * wv.abs().max(), f"{k}[{i}]"


# ---------------------------------------------------------------------------
# the phase wrappers on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_phase_wrappers_run_their_plain_versions_on_cpu(bf16):
    """C's and E's phase wrappers on CPU tensors return their plain versions
    and launch nothing; the ops compose their phases only on the card."""
    dt = BF if bf16 else torch.float32
    x, h0, w, b, u = (torch.from_numpy(a).to(dt) for a in _layer_inputs(9, 5, 32, 1))
    seq = port_layer.gru_layer_reference(x, h0, w, b, u, "tanh", True)
    hprev = torch.cat([h0[None], seq[:-1]])
    gates, rh = port_layer.gru_layer_bwd_gates(x, hprev, w, b, u)
    want = port_layer.gru_bwd_gates_reference(x, hprev, w, b, u)
    assert torch.equal(gates, want[0]) and torch.equal(rh, want[1])
    da, dh0 = port_layer.gru_layer_bwd_chain(gates, hprev, seq, None, u)
    wda, wdh0 = port_layer.gru_bwd_chain_reference(gates, hprev, seq, None, u)
    assert torch.equal(da, wda) and torch.equal(dh0, wdh0.to(dt)) and dh0.dtype == dt
    dx = port_layer.gru_layer_bwd_dx(da, w)
    assert torch.equal(dx, port_layer.gru_bwd_dx_reference(da, w)) and dx.dtype == dt
    cells, out, init, start = (_tt(a, bf16) for a in _head_inputs(1, 16, 32, 9, 2))
    probs, _l, h_seqs = port_decode.gru_decode_fwd_train(
        [{"cells": cells, "out": out, "init": init, "start": start, "T": T,
          "out_activation": "softmax"}])[0]
    head = _port_head(cells, out, init, start, probs, h_seqs, probs, probs, "softmax")
    g = port_decode.gru_decode_bwd_gates([head])
    assert len(g) == 1 and len(g[0]) == 1
    outs = port_decode.gru_decode_bwd_chain([head], g)
    assert outs[0]["d_start"].dtype == dt and outs[0]["da"][0].dtype == torch.float32
    for fn in (*port_layer.C_PHASES, *port_decode.E_PHASES):
        owner = port_layer if fn in port_layer.C_PHASES else port_decode
        assert getattr(owner, fn).launches == getattr(owner, fn).launches_bf16 == 0, fn


def test_phase_wrappers_check_shapes():
    x, h0, w, b, u = (torch.from_numpy(a) for a in _layer_inputs(9, 5, 32, 1))
    hprev = torch.zeros(T, 9, 32)
    with pytest.raises(ValueError, match="hprev has shape"):
        port_layer.gru_layer_bwd_gates(x, hprev[:, :4], w, b, u)
    gates, _rh = port_layer.gru_layer_bwd_gates(x, hprev, w, b, u)
    with pytest.raises(ValueError, match="gates has shape"):
        port_layer.gru_layer_bwd_chain(gates[..., :-1], hprev, None, None, u)
    with pytest.raises(ValueError, match="w has shape"):
        port_layer.gru_layer_bwd_dx(gates, w[:, :-3])


# ---------------------------------------------------------------------------
# the plans and the routes
# ---------------------------------------------------------------------------

# (build, H, B, heads) at the paths' shapes: C's encoder layers (GRU(256)
# at B 256, the judges at 512, the bf16 GRU(512) at 128, the velocity
# branch's ragged B 5) and E's head groups (the narrow route's notes +
# velocity, held notes, the wide route's heads alone, bf16 notes and
# instrument, rows 7 and 8 at H 512, B 128)
PLAN_CASES = [("C_chain", 256, 256, None), ("C_chain", 256, 512, None),
              ("C_chain", 512, 256, None), ("C_chain", 256, 5, None),
              ("C_chain_bf16", 256, 256, None), ("C_chain_bf16", 512, 128, None),
              ("E_chain", 256, 256, ((61, 2, 64), (1, 1, 64))),
              ("E_chain", 256, 256, ((61, 2, 64), (1, 1, 64), (2, 1, 64))),
              ("E_chain", 256, 256, ((16, 1, 4),)), ("E_chain", 512, 256, ((61, 2, 64),)),
              ("E_chain", 512, 256, ((1, 1, 64),)), ("E_chain", 256, 5, ((61, 2, 64),)),
              ("E_chain_bf16", 256, 256, ((61, 2, 64),)),
              ("E_chain_bf16", 512, 256, ((61, 2, 64),)),
              ("E_chain_bf16", 512, 256, ((16, 1, 4),)),
              ("E_chain_bf16", 512, 128, ((16, 1, 4),))]


# the cluster sizes whose chain ran within 10 % of the fastest size's at
# each plan case, timed on the card (tools/time_gru_bptt.py; NVIDIA H100
# 80GB HBM3, 700.00 W): the plan's pick must be one of them
NEAR_BEST_CLUSTERS = {
    ('C_chain', 256, 256, None): {8, 16},
    ('C_chain', 256, 512, None): {8},
    ('C_chain', 512, 256, None): {8},
    ('C_chain', 256, 5, None): {16},
    ('C_chain_bf16', 256, 256, None): {4, 8, 16},
    ('C_chain_bf16', 512, 128, None): {8, 16},
    ('E_chain', 256, 256, ((61, 2, 64), (1, 1, 64))): {8},
    ('E_chain', 256, 256, ((61, 2, 64), (1, 1, 64), (2, 1, 64))): {8},
    ('E_chain', 256, 256, ((16, 1, 4),)): {8, 16},
    ('E_chain', 512, 256, ((61, 2, 64),)): {4, 16},
    ('E_chain', 512, 256, ((1, 1, 64),)): {8},
    ('E_chain', 256, 5, ((61, 2, 64),)): {16},
    ('E_chain_bf16', 256, 256, ((61, 2, 64),)): {8},
    ('E_chain_bf16', 512, 256, ((61, 2, 64),)): {4, 16},
    ('E_chain_bf16', 512, 256, ((16, 1, 4),)): {4, 16},
    ('E_chain_bf16', 512, 128, ((16, 1, 4),)): {8},
}


@pytest.mark.parametrize("build, H, Bn, heads", PLAN_CASES,
                         ids=[f"{c[0]}-H{c[1]}-B{c[2]}-{len(c[3] or (0,))}" for c in PLAN_CASES])
def test_gru_bptt_plan(build, H, Bn, heads):
    """Each part's rows cover B, a thread's pairs and a warp's product tiles
    bound them, the shared memory is the kernel's formula within the block's
    budget less its static part, a resident ring holds a step's chunks, a
    streamed one 2 to 8, no other cluster size's plan costs less, and the
    size is one the card ran within 10 % of the fastest."""
    plan = _layout.gru_bptt_plan(build, H, Bn, heads or ((61, 2),))
    parts = _layout._bptt_parts(build, H, heads)
    C, Hc = plan.cluster, H // plan.cluster
    assert H % C == 0 and Hc % CHUNK == 0 and len(plan.rows) == len(parts)
    elem = 2 if build.endswith("_bf16") else 4
    for rows, clusters, part in zip(plan.rows, plan.clusters, parts):
        assert clusters == -(-Bn // rows) and rows * clusters >= Bn
        assert rows * Hc <= _layout.GRU_BWD_MAX_PAIRS * 512
        # product tiles: 8 rows x 64 units (FFMA) in float32, 16 x 32 on the
        # tensor cores in bf16, at most 2 a warp
        tiles = (-(-rows // 16) * (part.pw // 32) if elem == 2
                 else -(-rows // 8) * (part.pw // 64))
        assert tiles <= _layout.GRU_BWD_MAX_ITEMS * 16
    n_max = max(p.chunks(Hc) for p in parts)
    if plan.resident:
        assert plan.stages == n_max
    else:
        assert 2 <= plan.stages <= 8 and plan.stages < n_max
    assert plan.nbuf in (1, 2)
    part_floats = max(r * p.pw for r, p in zip(plan.rows, parts))
    D_max = max(p.D for p in parts)
    rows_max = max(plan.rows)
    smem = (plan.stages * CHUNK * (H + (8 if elem == 2 else 0)) * elem
            + plan.nbuf * part_floats * 4 + -(-rows_max // 16) * 16 * 3 * Hc * 4
            + ((Hc * D_max + 2 * rows_max * D_max) * 4 if D_max else 0))
    assert plan.smem == smem <= _layout.SMEM_PER_BLOCK - 1024
    assert plan.waves == -(-sum(plan.clusters) // _layout.MAX_CLUSTERS_H100[C])
    costs = {}
    for c in _layout.CLUSTER_SIZES:
        if _layout._bptt_cluster_ok(H, c):
            got = _layout._bptt_candidate(H, Bn, c, parts, _layout.MAX_CLUSTERS_H100[c], elem)
            if got is not None:
                costs[c] = got[1]
    assert costs[C] == min(costs.values())
    assert C in NEAR_BEST_CLUSTERS[(build, H, Bn, heads)]


def test_plans_at_the_default_widths():
    """C at GRU(256), B 256 in float32 keeps U^T's 96 KiB slice resident in
    clusters of 8, one wave; E wide's notes head at H 512 streams its
    slices (576 KiB of U1^T, U2^T and W2^T a CTA would not fit)."""
    plan = _layout.gru_bptt_plan("C_chain", 256, 256)
    assert (plan.cluster, plan.resident, plan.waves) == (8, True, 1)
    assert plan.stages * CHUNK * 256 * 4 == 96 * 1024
    wide = _layout.gru_bptt_plan("E_chain", 512, 256, ((61, 2),))
    assert not wide.resident
    Hc = 512 // wide.cluster
    assert 3 * 3 * Hc * 512 * 4 > _layout.SMEM_PER_BLOCK


def test_chain_launch_limits():
    """C's and E's builds launch wherever their chain has a plan: every
    width a multiple of 64 up to 512, and at 1024, E's bf16 builds there
    through the chain's per-segment instance (their tiles of 16 rows x 32
    units on the tensor cores, 2 a warp, do not cover a head's whole H + 64
    or 2H wide partial, but do each segment's); none off the multiples of 64
    or with a head wider than H."""
    for H in (64, 128, 256, 384, 512, 1024):
        for build in (*_layout.C_BUILDS, *_layout.E_BUILDS):
            assert _layout.launch_limit(build, H, 0) is None, (build, H)
    for H in (32, 96, 200):
        assert "multiple of 64" in _layout.gru_bptt_limit("C", H)
    assert "heads" in _layout.gru_bptt_limit("E", 64, 65, 1)
    assert _layout.smem_bytes("C", 256, 61) == _layout.smem_bytes("E_wide", 512, 61, 2) == 0


# the route chooser's answers while C and E were per-block kernels, for the
# configs of configs/*.json, the soak's (tools/tpu_soak.py) and Config()
# variants at 256 and 512: tests/data/gru_bwd_routes.json (recorded with
# that ops/_layout.py by this module's ``_route_answers``)
ROUTES = os.path.join(os.path.dirname(__file__), "data", "gru_bwd_routes.json")


def _route_configs():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
    spec = importlib.util.spec_from_file_location(
        "tpu_soak", os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools",
                                 "tpu_soak.py"))
    soak = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soak)
    out = {}
    for p in sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                           "configs", "*.json"))):
        out["json:" + os.path.basename(p)] = Config.load(p)
    for k, v in soak.CONFIGS.items():
        out["soak:" + k] = Config(**v)
    for H in (256, 512):
        for dt in ("float32", "bfloat16"):
            for extra in ({}, {"meta_held_notes": True}, {"decode_residual_bf16": True},
                          {"batch_size": 128}, {"batch_size": 512}, {"cell_type": "LSTM"}):
                out[f"Config(lstm_size={H}, compute_dtype={dt}, {extra})"] = Config(
                    lstm_size=H, compute_dtype=dt, **extra)
    return out


def _route_answers(L, cfg):
    """``config_route`` on and off the card, ``train_route``, and per part at
    the config's batch and 32 to 1024: ``bf16_layer_mode``,
    ``bf16_head_mode`` and ``head_builds`` (the error's type where one is
    raised)."""
    res = {}
    for on_card in (True, False):
        try:
            res[f"config_route on_card={on_card}"] = L.config_route(cfg, on_card=on_card)
        except Exception as e:  # noqa: BLE001 -- the answer is the error's type
            res[f"config_route on_card={on_card}"] = type(e).__name__
    layers, heads = L.config_shapes(cfg)
    H = cfg.lstm_size
    res["train_route"] = L.train_route(H, layers, heads, on_card=False, cell_type=cfg.cell_type)
    for Bn in sorted({cfg.batch_size, 32, 128, 256, 512, 1024}):
        for d, dx in layers:
            try:
                res[f"layer B={Bn} D={d}"] = L.bf16_layer_mode(cfg.cell_type, Bn, d, H, True, dx)
            except Exception as e:  # noqa: BLE001
                res[f"layer B={Bn} D={d}"] = type(e).__name__
        if cfg.cell_type == "GRU":
            for d, n in heads:
                try:
                    mode = L.bf16_head_mode(Bn, d, H, n, True)
                except Exception as e:  # noqa: BLE001
                    mode = type(e).__name__
                res[f"head B={Bn} D={d} n={n}"] = mode
                if mode in ("inplace", "wide"):
                    res[f"head_builds B={Bn} D={d} n={n}"] = list(L.head_builds(mode, d, H, n))
    return res


def test_routes_keep_their_answers():
    """``train_route``, ``config_route``, ``bf16_layer_mode``,
    ``bf16_head_mode`` and ``head_builds`` give the answers they gave before
    C and E became chains, for every config named: C's and E's launch
    limits now come from their chains' plans, and D's registers still send
    H = 512 wide."""
    with open(ROUTES) as f:
        want = json.load(f)
    configs = _route_configs()
    assert set(configs) == set(want)
    for name, cfg in configs.items():
        assert _route_answers(_layout, cfg) == want[name], name
