"""CPU tests of kernel D on the decode chain, every build: the decode heads'
training forward (``midi_vae_tpu_torch/csrc/gru_decode_train.cu``) runs one
head a launch on kernel B's decode chain of ``csrc/gru_decode_chain.cuh`` in
its training instances (D and D wide: float32; D bf16 and D wide bf16: the
slices streamed in bf16, the Pallas kernel's roundings; D resid: float32
with the h sequences stored in bf16). The chain runs only on the card
(``chip_smoke.py`` holds each instance against its plain version there);
here:

- the chain's plain version (``gru_decode_train_chain_reference``: B's
  phases composed over 1, 2 and 4 CTAs' unit slices, with D resid's and
  D bf16's roundings) against the JAX package's Pallas kernels in interpret
  mode: ``multihead_decode_train_fwd`` (rows 5 and 6's forward: a 2-layer
  primary head and 1-layer side heads, with and without
  ``residual_dtype=bf16``) and ``_dec_fwd_pallas`` (row 7) in float32 and
  bf16; 1- and 2-layer heads, softmax, sigmoid and linear, B 16 and 5;
- D resid's probs and logits bit-equal to D's (the plain chain and the CPU
  path of ``gru_decode_fwd_train``), its h sequences D's rounded to bf16;
- the route function (``_layout.dec_train_route``): the chain at every D
  build and every multiple of 32 up to 512 the paths reach, the per-block
  route where the chain refuses, an error where neither launches;
- the launch counts by route and build, with the entry points stubbed;
- ``config_route``'s, ``train_route``'s, ``bf16_head_mode``'s and
  ``head_builds``' answers unchanged (``tests/data/gru_bwd_routes.json``),
  and ``_multihead``'s, but at H = 448 with bf16 residuals on the card;
- the plan picks at H = 256 against the plans the H100 ran within 10 % of
  the fastest (``tests/data/d_m_near_best.json``, from ``python -m
  midi_vae_tpu_torch.tools.time_d_and_m --only dplans mplans``).

Sizes: T 6, H 64. Tolerances, as ``tests/test_torch_f_dwide_chains.py``
states them for the same chain: float32 atol 1e-5 + rtol 1e-4 (the readout's
partials sum in another order); bf16 relative L2 REL_L2 = 3e-4 per output
and BF16_ATOL 4e-3 on the h sequences (one bf16 step of the state's range).
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
from midi_vae_tpu_torch.config import Config
from midi_vae_tpu_torch.models import vae as port_vae
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import gru_decode as port_dec

BF = torch.bfloat16
ATOL, RTOL = 1e-5, 1e-4
REL_L2 = 3e-4
BF16_ATOL = 4e-3
T, H = 6, 64
NEAR_BEST = os.path.join(os.path.dirname(__file__), "data", "d_m_near_best.json")


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


def _close(got, want, bf16, what):
    assert tuple(_np(got).shape) == tuple(_np(want).shape), what
    if bf16:
        err = _rel_l2(got, want)
        assert err <= REL_L2, f"{what}: relative L2 {err:.3e} > {REL_L2:.1e}"
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL, err_msg=what)


def _pair(a, bf16=False):
    """numpy a -> (jnp, torch), bf16 rounded alike."""
    a = np.asarray(a, np.float32)
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a.copy()).to(BF)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _head_inputs(n_layers, D, Bn, seed):
    """cells, out dense, initial states and start of one decode head."""
    rng = np.random.RandomState(seed)
    cells = [{"w": rng.randn(d, 3 * H) / np.sqrt(d), "u": rng.randn(H, 3 * H) / np.sqrt(H),
              "b": 0.1 * rng.randn(3 * H)} for d in (D, H)[:n_layers]]
    out = {"w": rng.randn(H, D) / np.sqrt(H), "b": 0.1 * rng.randn(D)}
    init = [0.5 * np.tanh(rng.randn(Bn, H)) for _ in range(n_layers)]
    start = np.abs(rng.randn(Bn, D))
    return cells, out, init, start / start.sum(-1, keepdims=True)


def _trees(n_layers, D, Bn, seed, bf16):
    """The head's operands as a jax tree and a torch head dict (no T or
    output activation yet)."""
    cells, out, init, start = _head_inputs(n_layers, D, Bn, seed)
    pair = lambda a, i: _pair(a, bf16)[i]  # noqa: E731
    trees = []
    for i in (0, 1):
        trees.append({"cells": [{k: pair(v, i) for k, v in c.items()} for c in cells],
                      "out": {k: pair(v, i) for k, v in out.items()},
                      "init": [pair(a, i) for a in init], "start": pair(start, i)})
    return trees


def _chain(head, cluster, residual_dtype=None):
    return port_dec.gru_decode_train_chain_reference(
        head["cells"], head["out"], head["init"], head["start"], T, head["out_activation"],
        cluster, residual_dtype)


# ---------------------------------------------------------------------------
# the chain's plain version against rows 5 and 6 (the multi-head call), with
# and without bf16 residuals
# ---------------------------------------------------------------------------

MH_CASES = [(None, ("softmax", "sigmoid"), 16), (BF, ("softmax", "sigmoid", "sigmoid"), 5),
            (BF, ("linear", "softmax"), 16), (None, ("sigmoid", "linear"), 5)]


@pytest.fixture(scope="module")
def mh_rows():
    """{case index: (the multi-head call's torch heads, its rows 5 and 6
    forward in interpret mode)}, shared by the tests below."""
    out = {}
    for n, (residual, out_acts, Bn) in enumerate(MH_CASES):
        dims = (12, 1, 2)[: len(out_acts)]
        pairs = [_trees(2 if k == 0 else 1, d, Bn, 40 + 3 * k + n, False)
                 for k, d in enumerate(dims)]
        rdt = jnp.bfloat16 if residual is not None else None
        fwd = ft.multihead_decode_train_fwd(pairs[0][0], [p[0] for p in pairs[1:]], T, "tanh",
                                            out_acts, True, rdt)
        heads = [dict(p[1], T=T, out_activation=a) for p, a in zip(pairs, out_acts)]
        # rows per head: (probs, logits, h sequences)
        rows = [(fwd[0], fwd[1], [fwd[2], fwd[3]])]
        rows += [(fwd[4 + 3 * k], fwd[5 + 3 * k], [fwd[6 + 3 * k]]) for k in range(len(dims) - 1)]
        out[n] = (heads, rows)
    return out


@pytest.mark.parametrize("case", range(len(MH_CASES)),
                         ids=[f"{'bf16' if r else 'f32'}-residuals-{'-'.join(a)}-B{b}"
                              for r, a, b in MH_CASES])
def test_chain_matches_rows_5_and_6(mh_rows, case):
    """D's (``residual`` None) and D resid's chain instances, over 1, 2 and
    4 CTAs' unit slices, meet ``multihead_decode_train_fwd``: probs and
    logits in float32, the h sequences in the residuals' dtype (bf16: the
    same float h rounded, within one bf16 step)."""
    residual = MH_CASES[case][0]
    heads, rows = mh_rows[case]
    for cluster in (1, 2, 4):
        for head, (w_probs, w_logits, w_seqs) in zip(heads, rows):
            probs, logits, seqs = _chain(head, cluster, residual)
            _close(probs, w_probs, False, f"probs C={cluster}")
            _close(logits, w_logits, False, f"logits C={cluster}")
            for g, w in zip(seqs, w_seqs):
                assert g.dtype == (residual or torch.float32)
                if residual is None:
                    _close(g, w, False, f"h sequence C={cluster}")
                else:
                    np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=BF16_ATOL)
                    _close(g, w, True, f"bf16 h sequence C={cluster}")
    # the CPU path of the multi-head call's build on the same heads
    build = "D_resid" if residual is not None else "D"
    for got, (w_probs, w_logits, w_seqs) in zip(port_dec.gru_decode_fwd_train(heads, build), rows):
        _close(got[0], w_probs, False, f"{build} CPU path probs")
        _close(got[1], w_logits, False, f"{build} CPU path logits")


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_resid_probs_and_logits_bit_equal_to_d(mh_rows, cluster):
    """D resid's chain is D's with its h sequences stored in bf16: probs and
    logits bit for bit, each h sequence D's rounded to nearest even."""
    heads, _rows = mh_rows[1]
    for head in heads:
        exact, resid = _chain(head, cluster), _chain(head, cluster, BF)
        assert torch.equal(exact[0], resid[0]) and torch.equal(exact[1], resid[1])
        for e, r in zip(exact[2], resid[2]):
            assert r.dtype == BF and torch.equal(e.to(BF), r)
    exact = port_dec.gru_decode_fwd_train(heads, "D")
    resid = port_dec.gru_decode_fwd_train(heads, "D_resid")
    for e, r in zip(exact, resid):
        assert torch.equal(e[0], r[0]) and torch.equal(e[1], r[1])
        assert all(torch.equal(a.to(BF), b) for a, b in zip(e[2], r[2]))


# ---------------------------------------------------------------------------
# the chain's plain version against row 7 (one head), float32 and bf16
# ---------------------------------------------------------------------------

ROW7_CASES = [(bf16, n, D, act, Bn) for bf16 in (False, True)
              for n, D, act in ((2, 12, "softmax"), (1, 8, "sigmoid"), (1, 16, "linear"))
              for Bn in (16, 5)]


@pytest.mark.parametrize("bf16, n_layers, D, act, Bn", ROW7_CASES,
                         ids=[f"{'bf16' if b else 'f32'}-{n}L-D{d}-{a}-B{bn}"
                              for b, n, d, a, bn in ROW7_CASES])
def test_chain_matches_row_7(bf16, n_layers, D, act, Bn):
    """D's and D bf16's chain instances, over 1, 2 and 4 CTAs, and the CPU
    path of ``gru_decode_fwd_train`` meet ``_dec_fwd_pallas`` in interpret
    mode: probs, logits and the h sequences in the head's dtype."""
    jt, head = _trees(n_layers, D, Bn, 60 + D + Bn, bf16)
    head = dict(head, T=T, out_activation=act)
    want = ft._dec_fwd_pallas(jt["cells"], jt["out"], jt["init"], jt["start"], T, "tanh", act,
                              True)
    names = ("probs", "logits", "h1seq", "h2seq")
    for cluster in (1, 2, 4):
        probs, logits, seqs = _chain(head, cluster)
        for name, g, w in zip(names, (probs, logits, *seqs), want):
            assert g.dtype == head["start"].dtype, name
            _close(g, w, bf16, f"{name} C={cluster}")
            if bf16 and name.startswith("h"):
                np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=BF16_ATOL)
    build = "D_bf16" if bf16 else "D"
    probs, logits, seqs = port_dec.gru_decode_fwd_train([head], build)[0]
    for name, g, w in zip(names, (probs, logits, *seqs), want):
        _close(g, w, bf16, f"the CPU path's {name}")


# ---------------------------------------------------------------------------
# the route, the plans, the launch counts
# ---------------------------------------------------------------------------

HEADS = ((61, 2), (1, 1), (16, 1), (2, 1))


@pytest.mark.parametrize("build", _layout.D_BUILDS)
def test_every_build_takes_the_chain_at_the_paths_widths(build):
    """The chain has a plan at every multiple of 32 up to 512 for every head
    a path decodes, so every D build takes it there; the launch limit of a
    build's two routes together is None."""
    for H_ in range(32, 513, 32):
        for D, n in HEADS:
            if build.endswith("_bf16") and D < 8:
                continue  # promoted to float32
            assert _layout.dec_train_route(build, H_, D, n) == "chain", (H_, D, n)
            assert _layout.dec_train_limit(build, H_, D, n) is None


def test_block_route_where_the_chain_refuses():
    """A head far wider than the model's: every CTA's partial logits no
    longer fit beside the tiles, so the build's per-block design takes it
    (8 rows a block, or 2 for the wide builds); off the multiples of 32
    neither launches, and the error names both."""
    for build in _layout.D_BUILDS:
        assert _layout.dec_train_route(build, 256, 1000, 2) == "block"
    with pytest.raises(_layout.LaunchLimitError, match="neither on the decode chain"):
        _layout.dec_train_route("D", 48, 16, 1)
    assert "neither" in _layout.dec_train_limit("D_resid", 48, 16, 1)
    with pytest.raises(ValueError, match="builds"):
        _layout.dec_train_route("E", 256, 61, 2)
    # the narrow builds' per-block limit stays what the route chooser reads
    assert "registers" in _layout._part_limit("D_resid", 448, 61, 2)
    assert _layout.dec_train_route("D_resid", 448, 61, 2) == "chain"


def _fake_lib():
    return SimpleNamespace(mvt_error_string=lambda rc: b"")


def test_launches_count_by_route_and_build(monkeypatch):
    """Each D build launched as on the card (the entries stubbed): the chain
    once a head, the per-block heads of a call in one launch; each launch
    counts on the build's counter and on its route's."""
    calls = []
    monkeypatch.setattr(port_dec, "_d_entries", lambda build: (
        _fake_lib(), lambda *a: calls.append(("chain", build)) or 0,
        lambda *a: calls.append(("block", build, a[1])) or 0))
    monkeypatch.setattr(port_dec, "dec_plan", lambda H_, D, n, B_, T_, bf16: (
        _layout.dec_train_plan(H_, D, n, B_, T_, bf16)))
    monkeypatch.setattr(port_dec, "_packed_slices", lambda cells, C, K, tc: [
        torch.zeros(1)] * 3 * len(cells))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(
        cuda_stream=0))
    fn = port_dec.gru_decode_fwd_train
    for attr in ("launches", "launches_chain", "launches_block"):
        for sfx in ("", "_bf16", "_resid"):
            monkeypatch.setattr(fn, attr + sfx, 0)
    head = lambda bf16: dict(_trees(2, 16, 5, 3, bf16)[1], T=T,  # noqa: E731
                             out_activation="softmax")
    structs = [port_dec._DecodeHead(), port_dec._DecodeHead()]
    port_dec._launch_heads("D", [head(False)] * 2, structs, 5, H, "cuda")
    port_dec._launch_heads("D_resid", [head(False)] * 2, structs, 5, H, "cuda")
    port_dec._launch_heads("D_bf16", [head(True)], structs[:1], 5, H, "cuda")
    monkeypatch.setattr(_layout, "dec_train_route", lambda *a: "block")
    port_dec._launch_heads("D_resid", [head(False)] * 2, structs, 5, H, "cuda")
    assert calls == ([("chain", "D")] * 2 + [("chain", "D_resid")] * 2 + [("chain", "D_bf16"),
                     ("block", "D_resid", 2)])
    assert (fn.launches, fn.launches_chain, fn.launches_block) == (2, 2, 0)
    assert (fn.launches_resid, fn.launches_chain_resid, fn.launches_block_resid) == (3, 2, 1)
    assert (fn.launches_bf16, fn.launches_chain_bf16, fn.launches_block_bf16) == (1, 1, 0)


def test_wrappers_run_the_plain_version_on_cpu():
    """On CPU tensors no build launches and no counter moves."""
    head = dict(_trees(1, 8, 5, 2, False)[1], T=T, out_activation="sigmoid")
    fn = port_dec.gru_decode_fwd_train
    counters = [(a, getattr(fn, a)) for a in dir(fn) if a.startswith("launches")]
    got = port_dec.gru_decode_fwd_train([head], "D_resid")[0]
    want = port_dec.gru_decode_train_reference(head["cells"], head["out"], head["init"],
                                               head["start"], T, "sigmoid", BF)
    assert all(torch.equal(g, w) for g, w in zip(got[:2], want[:2]))
    assert torch.equal(got[2][0], want[2][0])
    assert counters == [(a, getattr(fn, a)) for a, _ in counters]


def _bwd_chain_test_module():
    path = os.path.join(os.path.dirname(__file__), "test_torch_gru_bwd_chain.py")
    spec = importlib.util.spec_from_file_location("_gru_bwd_chain_answers_d", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config_routes_and_head_builds_keep_their_answers():
    """``train_route``, ``config_route``, ``bf16_layer_mode``,
    ``bf16_head_mode`` and ``head_builds`` give the answers recorded before
    D moved onto the chain: the builds keep their names and their per-block
    launch limits, only the design that runs them changed."""
    mod = _bwd_chain_test_module()
    with open(mod.ROUTES) as f:
        want = json.load(f)
    for name, cfg in mod._route_configs().items():
        assert mod._route_answers(_layout, cfg) == want[name], name


@pytest.mark.parametrize("H_", [256, 448, 512])
def test_multihead_answers(H_):
    """``_multihead`` keeps its answers off the card and on it, but at H =
    448 with bf16 residuals, where D resid's chain and E resid's chain both
    launch and the call runs on the card."""
    for held in (False, True):
        for resid in (False, True):
            cfg = Config(lstm_size=H_, decode_residual_bf16=resid, meta_held_notes=held)
            route = _layout.config_route(cfg, on_card=False)
            for Bn in (32, 256, 512):
                cpu = port_vae._multihead(cfg, route, Bn)
                assert port_vae._multihead(cfg, route, Bn, on_card=True) == cpu
                assert cpu == (_layout.mh_vmem_ok(Bn, 61, [1, 2] if held else [1], H_)
                               and (route == "narrow" or resid))


def _near_best():
    with open(NEAR_BEST) as f:
        return json.load(f)


def test_plan_picks_are_near_the_fastest():
    """D's chain plan for each head at H = 256 (f32: notes, velocity,
    instrument and held; bf16: notes and instrument; B 256, 16 and 5) is
    among the plans the H100 ran within 10 % of the fastest, and fits."""
    table = _near_best()["D"]
    assert len(table) == 18
    for case, near in table.items():
        bf16, D, n, steps, Bn = case.split(",")
        p = _layout.dec_train_plan(256, int(D), int(n), int(Bn), int(steps), bf16 == "bf16")
        assert not p.tc
        assert f"{p.cluster}x{p.rows}/{p.chunk}" in near, (case, p, near)
        assert p.rows * p.clusters >= int(Bn) and p.smem <= _layout.DEC_SMEM
