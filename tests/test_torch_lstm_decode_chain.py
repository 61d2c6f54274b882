"""CPU tests of kernel M's decode chain (``midi_vae_tpu_torch/csrc/
lstm_decode_chain.cuh``, launched by ``csrc/lstm_decode.cu``): one 1- or
2-layer LSTM serving head decoded on thread-block clusters, each CTA a slice
of every layer's units (their four gate columns of [W ; U]), one product
and one cluster barrier a layer-step, its readout's partial logits carried
in the last layer's exchange and summed in cluster-rank order. The chain
runs only on the card (``chip_smoke.py`` holds it against its plain version
there); here:

- its phases' plain versions (``lstm_decode_layer_reference``: a layer's
  product over [x | h] and its cell; B's ``decode_readout_partials_reference``
  and ``decode_readout_reference``) composed by
  ``lstm_decode_chain_reference`` at 1, 2 and 4 CTAs a cluster, against the
  JAX package's ``fused_lstm_decode_scan`` (``_decode_kernel_2layer``,
  ``_decode_kernel_1layer`` in interpret mode): 1 and 2 layers, softmax,
  sigmoid and linear outputs, tanh, sigmoid and relu cells, B 16 and a
  ragged 5, T 6, H 32 and 64;
- each layer's phases against the JAX package's ``_lstm_gates``;
- the packed slices (``pack_lstm_slices``) read back to W, U;
- the plans (``ops/_layout.py::lstm_decode_plan``): every LSTM serving head
  at H 256 and 512 and B 256, 16, 5 takes the chain, its shared memory
  within a CTA's 227 KB (the formula's terms counted), the pick within 10 %
  of the fastest plan the H100 ran (``tests/data/d_m_near_best.json``, from
  ``python -m midi_vae_tpu_torch.tools.time_d_and_m --only mplans``), and
  the route (``lstm_decode_route``);
- the wrapper's CPU path and its launch counts by route (entries stubbed).

Tolerance: float32 atol 2e-6 + rtol 2e-5 (``tests/test_torch_ops.py``'s
limits for B and M).
"""

import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from midi_vae_tpu.models.cells import LSTMCell, dense_init
from midi_vae_tpu.ops import fused_gru, fused_lstm
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import lstm_decode as port_lstm
from midi_vae_tpu_torch.ops.gru_decode import decode_operands

RTOL, ATOL = 2e-5, 2e-6
T = 6
NEAR_BEST = os.path.join(os.path.dirname(__file__), "data", "d_m_near_best.json")


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


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_t(v) for v in tree]
    return torch.from_numpy(np.asarray(tree, np.float32).copy())


def _head(n_layers, D, H, B, seed):
    rng = np.random.RandomState(seed)
    keys = [np.array([7, seed + i], np.uint32) for i in range(3)]
    cells = [LSTMCell.init(keys[0], D, H)] + ([LSTMCell.init(keys[1], H, H)]
                                              if n_layers == 2 else [])
    for c in cells:
        c["b"] = (0.1 * rng.randn(4 * H)).astype(np.float32)
    out = dense_init(keys[2], H, D)
    out["b"] = (0.1 * rng.randn(D)).astype(np.float32)
    states = [((0.3 * rng.randn(B, H)).astype(np.float32),
               (0.5 * rng.randn(B, H)).astype(np.float32)) for _ in range(n_layers)]
    start = (0.2 * rng.rand(B, D)).astype(np.float32)
    return cells, out, states, start


CASES = [(n, D, out_act, act, B, H)
         for n, D in ((2, 12), (1, 1), (1, 16))
         for out_act in ("softmax", "sigmoid", "linear")
         for act, B, H in (("tanh", 16, 32), ("sigmoid", 5, 64), ("relu", 16, 32))]
IDS = [f"{n}L-D{d}-{o}-{a}-B{b}-H{h}" for n, d, o, a, b, h in CASES]


@pytest.fixture(scope="module")
def jax_decodes():
    """{case: (the head's numpy operands, fused_lstm_decode_scan's (probs,
    logits) in interpret mode)}, computed once a case."""
    cache = {}

    def get(case):
        if case not in cache:
            n_layers, D, out_activation, activation, B, H = case
            cells, out, states, start = _head(n_layers, D, H, B, 10 * n_layers + D + H)
            want = fused_lstm.fused_lstm_decode_scan(
                cells, out, tuple((jnp.asarray(h), jnp.asarray(c)) for h, c in states),
                jnp.asarray(start), T, activation, out_activation, True)
            cache[case] = ((cells, out, states, start), want)
        return cache[case]

    return get


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_chain_phases_compose_to_fused_lstm_decode_scan(jax_decodes, case):
    n_layers, D, out_activation, activation, B, H = case
    (cells, out, states, start), want = jax_decodes(case)
    for cluster in (1, 2, 4):
        got = port_lstm.lstm_decode_chain_reference(_t(cells), _t(out), _t(states), _t(start), T,
                                                    activation, out_activation, cluster)
        for g, w in zip(got, want):
            assert tuple(g.shape) == (T, B, D)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES[::4], ids=IDS[::4])
def test_cpu_path_matches_fused_lstm_decode_scan(jax_decodes, case):
    """The wrapper on CPU tensors (the plain version) meets the same rows,
    and no launch counter moves."""
    _n, _D, out_activation, activation, _B, _H = case
    (cells, out, states, start), want = jax_decodes(case)
    before = (port_lstm.lstm_decode.launches, port_lstm.lstm_decode.launches_chain,
              port_lstm.lstm_decode.launches_block)
    got = port_lstm.lstm_decode(_t(cells), _t(out), _t(states), _t(start), T, activation,
                                out_activation)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    assert before == (port_lstm.lstm_decode.launches, port_lstm.lstm_decode.launches_chain,
                      port_lstm.lstm_decode.launches_block)


@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "relu"])
def test_layer_phases_against_lstm_gates(activation):
    B, D, H = 5, 61, 64
    cells, _out, states, _start = _head(1, D, H, B, 3)
    x = np.random.RandomState(4).rand(B, D).astype(np.float32)
    p = cells[0]
    h, c = states[0]
    want = fused_lstm._cell_gates(jnp.asarray(x), jnp.asarray(h), jnp.asarray(c), p["w"], p["u"],
                                  p["b"], fused_gru._activation(activation))
    got = port_lstm.lstm_decode_layer_reference(_t(x), _t(h), _t(c), _t(p),
                                                port_lstm.cell_activation(activation))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_layers, D", [(2, 61), (1, 1), (1, 16)])
@pytest.mark.parametrize("cluster, chunk", [(1, 32), (2, 32), (4, 64)])
def test_packed_slices_read_back_to_w_and_u(n_layers, D, cluster, chunk):
    """Each layer's packed slice (cluster, depth, 4, H / cluster) holds,
    for CTA c, row k of [W ; U] at its units' i, f, g and o columns (layer
    1's W zero-padded to whole chunks); every chunk of a CTA is contiguous."""
    H = 64
    cells = _t(_head(n_layers, D, H, 5, 1)[0])
    packed = port_lstm.pack_lstm_slices(cells, cluster, chunk)
    assert len(packed) == n_layers
    Hc = H // cluster
    for layer, (p, s) in enumerate(zip(cells, packed)):
        d_in = p["w"].shape[0]
        depth = -(-d_in // chunk) * chunk if layer == 0 else H
        assert s.shape == (cluster, depth + H, 4, Hc) and s.is_contiguous()
        for c in range(cluster):
            cols = [q * H + c * Hc + u for q in range(4) for u in range(Hc)]
            assert torch.equal(s[c, :d_in].reshape(d_in, 4 * Hc), p["w"][:, cols])
            assert not s[c, d_in:depth].any()
            assert torch.equal(s[c, depth:].reshape(H, 4 * Hc), p["u"][:, cols])


# --- the plans ------------------------------------------------------------------

# (name, D, layers, T) of the LSTM serving heads
HEADS = (("notes", 61, 2, 64), ("velocity", 1, 1, 64), ("instrument", 16, 1, 4),
         ("held", 2, 1, 64))


@pytest.mark.parametrize("H", [256, 512])
@pytest.mark.parametrize("B", [256, 16, 5])
@pytest.mark.parametrize("head", HEADS, ids=[h[0] for h in HEADS])
def test_every_serving_head_takes_the_chain(head, B, H):
    _name, D, n_layers, T_ = head
    assert _layout.lstm_decode_route(H, D, n_layers) == "chain"
    p = _layout.lstm_decode_plan(H, D, n_layers, B, T=T_)
    Hc, R8, Dq, Dp = H // p.cluster, -(-p.rows // 8) * 8, -(-D // 4) * 4, -(-D // p.chunk) * p.chunk
    pbufs = 2 if n_layers == 1 and p.nb == 2 else 1
    floats = (p.stages * p.chunk * 4 * Hc + Dp * R8 + Dq * R8 + n_layers * p.nb * H * R8
              + pbufs * p.cluster * R8 * Dq + Hc * Dq + n_layers * Hc * R8
              + (p.splits - 1) * Hc * (R8 // 8) * _layout.TILE_STRIDE)
    assert p.smem == 4 * floats == _layout.lstm_decode_smem(
        n_layers, D, H, p.cluster, p.rows, p.splits, p.stages, p.chunk, p.nb)
    assert p.smem <= _layout.DEC_SMEM < _layout.SMEM_PER_BLOCK
    assert Hc * R8 // 8 * p.splits <= 512 and Hc % 4 == 0
    assert p.splits & (p.splits - 1) == 0 and p.chunk % p.splits == 0 and H % p.chunk == 0
    assert 2 <= p.stages <= 8 and p.clusters * p.rows >= B and p.nb in (1, 2)


def _near_best():
    with open(NEAR_BEST) as f:
        return json.load(f)["M"]


def test_plan_picks_are_near_the_fastest():
    """M's plan at each serving head (H 256 and 512; B 256, 16, 5) is among
    the plans the H100 ran within 10 % of the fastest
    ("cluster x rows / chunk / nb h tiles")."""
    table = _near_best()
    assert len(table) == 24
    for case, near in table.items():
        name, H, B = case.split(",")
        _n, D, n_layers, T_ = next(h for h in HEADS if h[0] == name)
        p = _layout.lstm_decode_plan(int(H), D, n_layers, int(B), T=T_)
        assert f"{p.cluster}x{p.rows}/{p.chunk}/nb{p.nb}" in near, (case, p, near)


def test_route_and_limits():
    # a head far wider than the model's: every CTA's partial logits no longer
    # fit beside the tiles; the per-block build takes it
    assert _layout.lstm_decode_route(256, 1000, 2) == "block"
    assert _layout.lstm_decode_route(96, 61, 2) == "chain"
    with pytest.raises(_layout.LaunchLimitError, match="1- or 2-layer"):
        _layout.lstm_decode_plan(256, 61, 3, 16)
    with pytest.raises(_layout.LaunchLimitError, match="neither on its chain"):
        _layout.lstm_decode_route(48, 16, 1)
    # one h tile a layer (the second-barrier build) frees the second tile's
    # shared memory
    assert (_layout.lstm_decode_smem(2, 61, 256, 8, 18, 2, 2, 32, 1)
            == _layout.lstm_decode_smem(2, 61, 256, 8, 18, 2, 2, 32, 2) - 4 * 2 * 256 * 24)
    # where no plan was measured: one tile (the second barrier) for a
    # 2-layer head, two for a 1-layer one
    assert _layout.lstm_decode_plan(256, 61, 2, 100).nb == 1
    assert _layout.lstm_decode_plan(256, 16, 1, 100).nb == 2
    assert _layout.lstm_decode_plan(256, 61, 2, 100, nb=2).nb == 2


def _fake_lib():
    return SimpleNamespace(mvt_error_string=lambda rc: b"")


def test_launches_count_by_route(monkeypatch):
    """M's chain and per-block route, launched as on the card (the entries
    stubbed to return success): each launch counts on ``.launches`` and on
    its route's counter; the chain gets the plan and the packed slices."""
    calls = []
    monkeypatch.setattr(port_lstm, "_kernel", lambda: (
        _fake_lib(), lambda *a: calls.append(("block", len(a))) or 0,
        lambda *a: calls.append(("chain", len(a), a[-7:-1])) or 0))
    monkeypatch.setattr(port_lstm, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(port_lstm, "_ptr", lambda t: None)
    monkeypatch.setattr(port_lstm, "decode_plan", lambda H, D, n, B, T_: _layout.lstm_decode_plan(
        H, D, n, B, T=T_))
    fake = SimpleNamespace(type="cuda")
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(
        cuda_stream=0))
    for attr in ("launches", "launches_chain", "launches_block"):
        monkeypatch.setattr(port_lstm.lstm_decode, attr, 0)
    cells, out, states, start = (_t(a) for a in _head(2, 16, 64, 5, 2))

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return fake

    start = start.as_subclass(OnCard)
    monkeypatch.setattr(torch, "empty", lambda *a, **k: torch.zeros(1))
    monkeypatch.setattr(torch, "empty_like", lambda *a, **k: torch.zeros(1))
    # the operator dispatches on the tensors' real device: call its CUDA
    # implementation, as the dispatcher does for tensors on the card
    args = (*decode_operands(cells, out, states, start, "M"), T, "tanh", "softmax", None)
    port_lstm.lstm_decode_cuda(*args)
    monkeypatch.setattr(_layout, "lstm_decode_route", lambda *a: "block")
    port_lstm.lstm_decode_cuda(*args)
    p = _layout.lstm_decode_plan(64, 16, 2, 5, T=T)
    assert calls == [("chain", 27, (p.cluster, p.rows, p.splits, p.stages, p.chunk, p.nb)),
                     ("block", 23)]
    f = port_lstm.lstm_decode
    assert (f.launches, f.launches_chain, f.launches_block) == (2, 1, 1)
