"""CPU tests of kernel B's decode chain (``midi_vae_tpu_torch/csrc/
gru_decode_chain.cuh``, launched by ``csrc/gru_decode.cu``): one 1- or
2-layer GRU serving head decoded on thread-block clusters, each CTA a slice
of every layer's units, its readout's partial logits carried in layer 2's
exchange and summed in cluster-rank order. The chain runs only on the card
(``chip_smoke.py`` holds it against its plain version); here:

- its phases' plain versions (``decode_layer_p1_reference``,
  ``decode_layer_p2_reference``, ``decode_readout_partials_reference``,
  ``decode_readout_reference``) composed by ``gru_decode_chain_reference``
  at 1, 2 and 4 CTAs a cluster, against the JAX package's
  ``fused_decode_scan`` (``_decode_kernel_2layer``, ``_decode_kernel_1layer``
  in interpret mode): 1 and 2 layers, softmax, sigmoid and linear outputs,
  tanh, sigmoid and relu cells, B 16 and a ragged 5, T 6, H 32 or 64; float32
  atol 2e-6 + rtol 2e-5 (``tests/test_torch_ops.py``'s limits for B);
- each layer's phases against the JAX package's ``_gru_gates``;
- kernel D's outputs unchanged: D's plain forward (the CPU path of
  ``gru_decode_train``) is bit-equal to B's plain decode, which D's and B's
  per-block route share the body of (``gru_decode_body.cuh``);
- the plans (``ops/_layout.py::gru_decode_plan``): every serving head at
  H 256 and 512 and B 256, 16, 5 takes the chain, the pick one of the plans
  the H100 ran within 10 % of the fastest (``NEAR_BEST_B``, from ``python -m
  midi_vae_tpu_torch.tools.time_t_and_b --only bplans``), the shared memory
  within a CTA's 227 KB, and the route (``gru_decode_route``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from midi_vae_tpu.models.cells import GRUCell, dense_init
from midi_vae_tpu.ops import fused_decoder, fused_gru
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import gru_decode as port_decode

RTOL, ATOL = 2e-5, 2e-6
T = 6


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
    if isinstance(tree, list):
        return [_t(v) for v in tree]
    return torch.from_numpy(np.asarray(tree, np.float32).copy())


def _head(n_layers, D, H, B, seed):
    rng = np.random.RandomState(seed)
    keys = [np.array([5, seed + i], np.uint32) for i in range(3)]
    cells = [GRUCell.init(keys[0], D, H)] + ([GRUCell.init(keys[1], H, H)] if n_layers == 2 else [])
    for c in cells:
        c["b"] = (0.1 * rng.randn(3 * H)).astype(np.float32)
    out = dense_init(keys[2], H, D)
    out["b"] = (0.1 * rng.randn(D)).astype(np.float32)
    states = [(0.3 * rng.randn(B, H)).astype(np.float32) for _ in range(n_layers)]
    start = (0.2 * rng.rand(B, D)).astype(np.float32)
    return cells, out, states, start


CASES = [(n, D, out_act, act, B)
         for n, D in ((2, 12), (1, 1), (1, 16))
         for out_act in ("softmax", "sigmoid", "linear")
         for act, B in (("tanh", 16), ("sigmoid", 5), ("relu", 16))]


@pytest.mark.parametrize("n_layers, D, out_activation, activation, B", CASES)
def test_chain_phases_compose_to_fused_decode_scan(n_layers, D, out_activation, activation, B):
    H = 32
    cells, out, states, start = _head(n_layers, D, H, B, 10 * n_layers + D)
    want = fused_decoder.fused_decode_scan(cells, out, [jnp.asarray(s) for s in states],
                                           jnp.asarray(start), T, activation, out_activation,
                                           True)
    for cluster in (1, 2, 4):
        got = port_decode.gru_decode_chain_reference(_t(cells), _t(out), _t(states), _t(start),
                                                     T, activation, out_activation, cluster)
        for g, w in zip(got, want):
            assert tuple(g.shape) == (T, B, D)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "relu"])
def test_layer_phases_against_gru_gates(activation):
    B, D, H = 5, 61, 64
    cells, _out, states, _start = _head(1, D, H, B, 3)
    x = np.random.RandomState(4).rand(B, D).astype(np.float32)
    p = cells[0]
    want = fused_decoder._gru_gates(jnp.asarray(x), jnp.asarray(states[0]), p["w"], p["u"], p["b"],
                                    fused_gru._activation(activation))
    tp = _t(p)
    z, rh, cand = port_decode.decode_layer_p1_reference(_t(x), _t(states[0]), tp)
    got = port_decode.decode_layer_p2_reference(z, rh, cand, _t(states[0]), tp["u"],
                                                port_decode.cell_activation(activation))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cluster", [1, 2, 8])
def test_readout_sums_the_partials_in_rank_order(cluster):
    """The partials over the unit slices sum, in rank order, to h Wo + bo
    within float32 rounding; the sum is the same in every CTA (one function
    of the partials)."""
    rng = np.random.RandomState(cluster)
    h = torch.from_numpy(np.tanh(rng.randn(5, 64)).astype(np.float32))
    wo = torch.from_numpy((rng.randn(64, 16) / 8).astype(np.float32))
    bo = torch.from_numpy((0.1 * rng.randn(16)).astype(np.float32))
    parts = port_decode.decode_readout_partials_reference(h, wo, cluster)
    assert tuple(parts.shape) == (cluster, 5, 16)
    probs, logits = port_decode.decode_readout_reference(parts, bo, "softmax")
    want = h.double() @ wo.double() + bo.double()
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(logits, port_decode.decode_readout_reference(parts, bo, "linear")[1])
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("out_activation", ["softmax", "sigmoid", "linear"])
def test_d_outputs_unchanged(n_layers, out_activation):
    """Kernel D (the training forward) keeps its design: its plain forward's
    probs and logits are bit-equal to B's plain decode on the same head."""
    B, D, H = 5, 16, 32
    cells, out, states, start = _head(n_layers, D, H, B, 20 + n_layers)
    tc, to, ts, tst = _t(cells), _t(out), _t(states), _t(start)
    want = port_decode.gru_decode_reference(tc, to, ts, tst, T, "tanh", out_activation)
    got = port_decode.gru_decode_train_reference(tc, to, ts, tst, T, out_activation)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wrapper_runs_the_plain_version_on_cpu():
    cells, out, states, start = _head(2, 12, 32, 5, 1)
    before = (port_decode.gru_decode.launches, port_decode.gru_decode.launches_chain)
    got = port_decode.gru_decode(_t(cells), _t(out), _t(states), _t(start), T)
    want = port_decode.gru_decode_reference(_t(cells), _t(out), _t(states), _t(start), T)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (port_decode.gru_decode.launches, port_decode.gru_decode.launches_chain) == before


# --- the plans -----------------------------------------------------------------

# (name, D, layers, T) of the serving heads
HEADS = (("notes", 61, 2, 64), ("velocity", 1, 1, 64), ("instrument", 16, 1, 4),
         ("held", 2, 1, 64))

# The plans ("cluster x rows / chunk") the H100 ran within 10 % of the
# fastest on each serving head at (H, B), from python -m
# midi_vae_tpu_torch.tools.time_t_and_b --only bplans (PERF.md,
# Findings; NVIDIA H100 80GB HBM3, 700 W); rerun it and update this table when
# B's chain changes.
NEAR_BEST_B = {
    ('held', 256, 5): ('8x4/128', '8x5/128'), ('held', 256, 16): ('16x4/128', '16x4/64'),
    ('held', 256, 256): ('16x37/128', '4x16/64', '4x9/64', '8x18/128'),
    ('held', 512, 5): ('16x1/128', '16x4/128', '16x5/128'),
    ('held', 512, 16): ('16x3/128', '16x4/128', '16x8/128'),
    ('held', 512, 256): ('16x37/32', '8x18/32', '8x18/64'),
    ('instrument', 256, 5): ('16x1/32', '16x4/128', '4x4/32', '4x4/64', '4x5/64', '8x4/128', '8x4/32', '8x4/64', '8x5/128'),
    ('instrument', 256, 16): ('16x16/32', '16x16/64', '16x3/128', '16x3/32', '16x3/64', '16x4/128', '16x4/32', '4x1/128', '4x1/32', '4x1/64', '4x4/128', '4x4/32', '4x4/64', '4x8/128', '4x8/32', '4x8/64', '8x16/128', '8x2/64', '8x4/128', '8x4/64'),
    ('instrument', 256, 256): ('16x37/128', '8x16/128', '8x16/64', '8x32/128', '8x32/32', '8x32/64'),
    ('instrument', 512, 5): ('16x4/128', '16x4/32', '16x4/64', '16x5/128'),
    ('instrument', 512, 16): ('16x3/128',),
    ('instrument', 512, 256): ('4x9/32', '8x18/32', '8x8/64'),
    ('notes', 256, 5): ('16x1/128', '16x4/128', '16x5/128', '8x1/128', '8x5/128'),
    ('notes', 256, 16): ('16x3/128', '16x8/128', '8x2/128'),
    ('notes', 256, 256): ('4x16/64', '4x9/64', '8x18/64'),
    ('notes', 512, 5): ('16x1/128', '16x4/128', '16x5/128'),
    ('notes', 512, 16): ('16x3/128', '16x4/128', '16x8/128'),
    ('notes', 512, 256): ('16x8/128', '8x8/64'),
    ('velocity', 256, 5): ('16x1/128', '16x4/128', '16x5/128', '8x1/128', '8x4/128', '8x4/64', '8x5/128'),
    ('velocity', 256, 16): ('8x8/128',),
    ('velocity', 256, 256): ('16x37/128', '16x37/64', '4x16/64', '8x18/128', '8x32/128', '8x32/64'),
    ('velocity', 512, 5): ('16x1/128', '16x4/128', '16x5/128'),
    ('velocity', 512, 16): ('16x3/128', '16x4/128', '16x8/128'),
    ('velocity', 512, 256): ('16x37/32', '16x40/32', '8x18/32', '8x18/64'),
}


@pytest.mark.parametrize("key", sorted(NEAR_BEST_B), ids=str)
def test_plan_picks_a_near_best_plan(key):
    name, H, B = key
    _name, D, n_layers, T = next(h for h in HEADS if h[0] == name)
    p = _layout.gru_decode_plan(H, D, n_layers, B, T=T)
    assert f"{p.cluster}x{p.rows}/{p.chunk}" in NEAR_BEST_B[key]


@pytest.mark.parametrize("H", [256, 512])
@pytest.mark.parametrize("B", [256, 16, 5])
@pytest.mark.parametrize("head", HEADS, ids=[h[0] for h in HEADS])
def test_every_serving_head_takes_the_chain(head, B, H):
    _name, D, n_layers, T = head
    assert _layout.gru_decode_route(H, D, n_layers) == "chain"
    p = _layout.gru_decode_plan(H, D, n_layers, B, T=T)
    assert p.smem == _layout.gru_decode_smem(n_layers, D, H, p.cluster, p.rows, p.splits,
                                             p.stages, p.chunk) <= _layout.DEC_SMEM
    assert H // p.cluster * -(-p.rows // 8) * p.splits <= 512
    assert p.splits & (p.splits - 1) == 0 and p.chunk % p.splits == 0 and H % p.chunk == 0
    assert 2 <= p.stages <= 8 and p.clusters * p.rows >= B


def test_route_and_limits():
    # H = 1024: the per-block build's 94 registers a thread do not fit 1024
    # threads; the chain's slices stream, clusters of 16 take it
    assert _layout.gru_decode_route(1024, 61, 2) == "chain"
    assert _layout.gru_decode_route(96, 61, 2) == "chain"
    # a head far wider than the model's: every CTA's partial logits of
    # every peer no longer fit beside the tiles; the per-block build takes it
    assert _layout.gru_decode_route(256, 1000, 2) == "block"
    with pytest.raises(_layout.LaunchLimitError, match="1- or 2-layer"):
        _layout.gru_decode_plan(256, 61, 3, 16)
    with pytest.raises(_layout.LaunchLimitError, match="neither on its chain"):
        _layout.gru_decode_route(48, 16, 1)
