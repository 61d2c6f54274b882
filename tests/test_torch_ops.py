"""CPU parity of the port's kernel modules against the JAX package.

Each test feeds the same numpy inputs to the JAX op (its Pallas kernel in
interpret mode) and to the port's wrapper, which on CPU tensors runs the
kernel's plain PyTorch version. Tolerance rtol 2e-5, atol 2e-6 on forward
values (float32, as tests/test_ops.py uses for the JAX kernels against their
references). The training ops (gru_layer_train_x, gru_decode_train,
gru_decode_multihead_train) are also held on the gradient of a random
functional of their outputs: atol 1e-5 + rtol 1e-4, for f32 sums taken in
another order through a chain of up to 6 steps.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.models.cells import GRUCell, dense_init
from midi_vae_tpu.ops.fused_decoder import fused_decode_scan
from midi_vae_tpu.ops import fused_train as ft
from midi_vae_tpu.ops.fused_train import gru_layer_infer_x
from midi_vae_tpu_torch.ops import gru_decode as port_decode
from midi_vae_tpu_torch.ops.grad_reduce import grad_reduce
from midi_vae_tpu_torch.ops.gru_decode import gru_decode
from midi_vae_tpu_torch.ops.gru_layer import gru_layer, gru_layer_train_x
from midi_vae_tpu_torch.ops import gru_layer as port_gru_layer

RTOL, ATOL = 2e-5, 2e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v) for v in tree]
    return torch.from_numpy(np.asarray(tree, np.float32).copy())


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _grads_close(got, want):
    for g, w in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("D", [1, 16, 61])
@pytest.mark.parametrize("return_sequences", [True, False])
def test_gru_layer_matches_jax(D, return_sequences):
    T, B, H = 6, 4, 16
    rng = np.random.RandomState(D)
    x = rng.randn(T, B, D).astype(np.float32)
    h0 = (0.3 * rng.randn(B, H)).astype(np.float32)
    p = GRUCell.init(np.array([0, D], np.uint32), D, H)
    p["b"] = (0.1 * rng.randn(3 * H)).astype(np.float32)
    want = gru_layer_infer_x(jnp.asarray(x), jnp.asarray(h0), p["w"], p["b"], p["u"],
                             "tanh", return_sequences, True)
    pt = _t(p)
    got = gru_layer(_t(x), _t(h0), pt["w"], pt["b"], pt["u"], "tanh", return_sequences)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)
    assert all(getattr(port_gru_layer, f).launches == 0 for f in port_gru_layer.A_PHASES)


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("out_activation", ["softmax", "sigmoid", "linear"])
def test_gru_decode_matches_jax(n_layers, out_activation):
    T, B, D, H = 6, 4, 12, 16
    rng = np.random.RandomState(n_layers)
    keys = [np.array([1, i], np.uint32) for i in range(3)]
    cells = [GRUCell.init(keys[0], D, H)] + (
        [GRUCell.init(keys[1], H, H)] if n_layers == 2 else [])
    out_dense = dense_init(keys[2], H, D)
    out_dense["b"] = (0.1 * rng.randn(D)).astype(np.float32)
    states = [(0.1 * rng.randn(B, H)).astype(np.float32) for _ in range(n_layers)]
    start = (0.2 * rng.rand(B, D)).astype(np.float32)
    want = fused_decode_scan(cells, out_dense, [jnp.asarray(s) for s in states],
                             jnp.asarray(start), T, "tanh", out_activation, True)
    got = gru_decode(_t(cells), _t(out_dense), [_t(s) for s in states], _t(start), T,
                     "tanh", out_activation)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (T, B, D)
        _close(g, w)
    assert gru_decode.launches == 0


def test_wrappers_check_their_operands():
    x = torch.zeros(3, 2, 5)
    p = _t(GRUCell.init(np.array([0, 1], np.uint32), 5, 16))
    with pytest.raises(ValueError, match="w has shape"):
        gru_layer(x, torch.zeros(2, 16), p["w"][:4], p["b"], p["u"])
    with pytest.raises(ValueError, match="activation"):
        gru_layer(x, torch.zeros(2, 16), p["w"], p["b"], p["u"], "elu")
    with pytest.raises(ValueError, match="1- or 2-layer"):
        gru_decode([p] * 3, {"w": torch.zeros(16, 5), "b": torch.zeros(5)},
                   [torch.zeros(2, 16)] * 3, torch.zeros(2, 5), 4)
    with pytest.raises(ValueError, match="output activation"):
        gru_decode([p], {"w": torch.zeros(16, 5), "b": torch.zeros(5)},
                   [torch.zeros(2, 16)], torch.zeros(2, 5), 4, "tanh", "tanh")


def test_kernel_modules_import_without_nvcc_or_triton(tmp_path):
    """The CPU path, the training ops' forward and backward included,
    imports and runs with no nvcc and no triton, and builds nothing."""
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import torch\n"
        "from midi_vae_tpu_torch.ops import _build, gru_layer as gl, gru_decode as gd, grad_reduce as gr\n"
        "x = torch.zeros(2, 3, 4); h = torch.zeros(3, 32)\n"
        "gl.gru_layer(x, h, torch.zeros(4, 96), torch.zeros(96), torch.zeros(32, 96))\n"
        "c = {'w': torch.zeros(4, 96), 'u': torch.zeros(32, 96), 'b': torch.zeros(96)}\n"
        "gd.gru_decode([c], {'w': torch.zeros(32, 4), 'b': torch.zeros(4)}, [h], torch.zeros(3, 4), 2)\n"
        "w = torch.zeros(4, 96, requires_grad=True)\n"
        "gl.gru_layer_train_x(x, h, w, torch.zeros(96), torch.zeros(32, 96)).sum().backward()\n"
        "cw = dict(c, w=w)\n"
        "p, l = gd.gru_decode_train([cw], {'w': torch.zeros(32, 4), 'b': torch.zeros(4)}, [h], torch.zeros(3, 4), 2)\n"
        "(p.sum() + l.sum()).backward()\n"
        "assert w.grad is not None\n"
        "assert _build.load.cache_info().currsize == 0 and not _build.build_seconds\n"
        "assert all(getattr(gl, f).launches == 0 for f in gl.A_PHASES) and gd.gru_decode.launches == 0\n"
        "assert gl.gru_layer_bwd.launches == gd.gru_decode_fwd_train.launches == 0\n"
        "assert gd.gru_decode_bwd.launches == gr.grad_reduce.launches == 0\n"
        "assert all(getattr(gl, f).launches == 0 for f in gl.C_PHASES)\n"
        "assert all(getattr(gd, f).launches == 0 for f in gd.E_PHASES)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path), PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("D", [1, 5])
@pytest.mark.parametrize("T", [1, 2, 6])
@pytest.mark.parametrize("return_sequences", [True, False])
def test_gru_layer_train_x_matches_jax(D, T, return_sequences):
    """Forward and the grads of a random linear functional for x, h0, w, b
    and u; T = 1 and 2 pin the h0 substitution at t = 0."""
    B, H = 3, 16
    rng = np.random.RandomState(10 * T + D)
    x = rng.randn(T, B, D).astype(np.float32)
    h0 = (0.3 * rng.randn(B, H)).astype(np.float32)
    p = GRUCell.init(np.array([2, D], np.uint32), D, H)
    p["b"] = (0.1 * rng.randn(3 * H)).astype(np.float32)
    args = [x, h0, p["w"], p["b"], p["u"]]
    shape = (T, B, H) if return_sequences else (B, H)
    c = rng.randn(*shape).astype(np.float32)

    want_out, vjp = jax.vjp(
        lambda *a: ft.gru_layer_train_x(*a, "tanh", return_sequences, True), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(c))
    leaves = [_t(a).requires_grad_() for a in args]
    out = gru_layer_train_x(*leaves, return_sequences)
    _close(out.detach(), want_out)
    _grads_close(torch.autograd.grad((out * _t(c)).sum(), leaves), want)


def _decode_case(n_layers, D, H, B, seed):
    rng = np.random.RandomState(seed)
    keys = [np.array([3, seed + i], np.uint32) for i in range(3)]
    cells = [GRUCell.init(keys[0], D, H)] + ([GRUCell.init(keys[1], H, H)] if n_layers == 2 else [])
    out_dense = dense_init(keys[2], H, D)
    out_dense["b"] = (0.1 * rng.randn(D)).astype(np.float32)
    states = [(0.3 * rng.randn(B, H)).astype(np.float32) for _ in range(n_layers)]
    return {"cells": cells, "out": out_dense, "init": states,
            "start": (0.2 * rng.rand(B, D)).astype(np.float32)}


def _port_head(spec):
    """The spec as torch leaves (in _flatten_head order) and a head dict."""
    leaves = [_t(a).requires_grad_() for a in port_decode._flatten_head(spec)]
    n = len(spec["cells"])
    head = port_decode._unflatten_heads([(n, None, None)], leaves)[0]
    return leaves, head


def _sin_cos_cotangent(outs):
    """The cotangents of sum(sin(probs)) + 0.3 * sum(cos(logits))."""
    return type(outs)((jnp.cos(p), -0.3 * jnp.sin(lg)) for p, lg in outs)


def _sin_cos_t(outs):
    return sum(torch.sin(p).sum() + 0.3 * torch.cos(lg).sum() for p, lg in outs)


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("out_activation", ["softmax", "sigmoid", "linear"])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_gru_decode_train_matches_jax(n_layers, out_activation, T):
    """probs, logits and the grads of a functional of BOTH (so the fed-back
    probs carry a gradient) for every cell, the out dense, the init states
    and the start symbol."""
    spec = _decode_case(n_layers, 6, 16, 3, n_layers * 10 + T)

    jspec = jax.tree_util.tree_map(jnp.asarray, spec)
    (want_p, want_l), vjp = jax.vjp(lambda s: ft.gru_decode_train(
        s["cells"], s["out"], s["init"], s["start"], T, "tanh", out_activation, True), jspec)
    (want,) = vjp(_sin_cos_cotangent([(want_p, want_l)])[0])
    leaves, h = _port_head(spec)
    probs, logits = port_decode.gru_decode_train(h["cells"], h["out"], h["init"], h["start"], T,
                                                 "tanh", out_activation)
    _close(probs.detach(), want_p)
    _close(logits.detach(), want_l)
    got = torch.autograd.grad(_sin_cos_t([(probs, logits)]), leaves)
    order = [want["start"], *want["init"], *[c[k] for c in want["cells"] for k in ("w", "u", "b")],
             want["out"]["w"], want["out"]["b"]]
    _grads_close(got, order)


@pytest.mark.parametrize("n_side", [1, 2])
def test_gru_decode_multihead_train_matches_jax(n_side):
    """notes (2 layers, softmax) + velocity (D = 1, sigmoid) [+ held (D = 2,
    softmax)] in one call, against the JAX multi-head kernel pair."""
    T, B, H = 5, 3, 16
    primary = _decode_case(2, 7, H, B, 1)
    side = [_decode_case(1, 1, H, B, 2), _decode_case(1, 2, H, B, 3)][:n_side]
    out_acts = ("softmax", "sigmoid", "softmax")[: 1 + n_side]

    jp = jax.tree_util.tree_map(jnp.asarray, primary)
    jh = tuple(jax.tree_util.tree_map(jnp.asarray, s) for s in side)
    want_outs, vjp = jax.vjp(
        lambda p, hs: ft.gru_decode_multihead_train(p, hs, T, "tanh", out_acts, True), jp, jh)
    gp, gh = vjp(_sin_cos_cotangent(want_outs))
    port = [_port_head(s) for s in [primary, *side]]
    outs = port_decode.gru_decode_multihead_train(port[0][1], [h for _, h in port[1:]], T, "tanh",
                                                  out_acts)
    for (p, lg), (wp, wl) in zip(outs, want_outs):
        _close(p.detach(), wp)
        _close(lg.detach(), wl)
    got = torch.autograd.grad(_sin_cos_t(outs), [t for leaves, _ in port for t in leaves])
    want = []
    for g in [gp, *gh]:
        want += [g["start"], *g["init"], *[c[k] for c in g["cells"] for k in ("w", "u", "b")],
                 g["out"]["w"], g["out"]["b"]]
    _grads_close(got, want)


def test_grad_reduce_takes_column_slices():
    """Kernel W's plain version writes a^T b into a column slice of its
    output and the column sums into the bias; nothing counts as a launch."""
    rng = np.random.RandomState(0)
    a, b = _t(rng.randn(7, 3)), _t(rng.randn(7, 10))
    out = torch.zeros(3, 12)
    bias = torch.zeros(4)
    grad_reduce(a, b[:, 6:], out[:, 8:], bias)
    np.testing.assert_allclose(out[:, 8:].numpy(), a.numpy().T @ b.numpy()[:, 6:], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bias.numpy(), b.numpy()[:, 6:].sum(0), rtol=RTOL, atol=ATOL)
    assert not out[:, :8].any()
    with pytest.raises(ValueError, match="do not fit"):
        grad_reduce(a, b, out)
    assert grad_reduce.launches == 0
