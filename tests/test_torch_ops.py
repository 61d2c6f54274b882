"""CPU parity of the port's kernel modules against the JAX package.

Each test feeds the same numpy inputs to the JAX op (its Pallas kernel in
interpret mode) and to the port's wrapper, which on CPU tensors runs the
kernel's plain PyTorch version. Tolerance rtol 2e-5, atol 2e-6 (float32, as
tests/test_ops.py uses for the JAX kernels against their references).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.models.cells import GRUCell, dense_init
from midi_vae_tpu.ops.fused_decoder import fused_decode_scan
from midi_vae_tpu.ops.fused_train import gru_layer_infer_x
from midi_vae_tpu_torch.ops.gru_decode import gru_decode
from midi_vae_tpu_torch.ops.gru_layer import gru_layer

RTOL, ATOL = 2e-5, 2e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v) for v in tree]
    return torch.from_numpy(np.asarray(tree, np.float32).copy())


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


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
    assert gru_layer.launches == 0


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
    """The CPU path imports and runs with no nvcc and no triton, and
    builds nothing."""
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import torch\n"
        "from midi_vae_tpu_torch.ops import _build, gru_layer as gl, gru_decode as gd\n"
        "x = torch.zeros(2, 3, 4); h = torch.zeros(3, 32)\n"
        "gl.gru_layer(x, h, torch.zeros(4, 96), torch.zeros(96), torch.zeros(32, 96))\n"
        "c = {'w': torch.zeros(4, 96), 'u': torch.zeros(32, 96), 'b': torch.zeros(96)}\n"
        "gd.gru_decode([c], {'w': torch.zeros(32, 4), 'b': torch.zeros(4)}, [h], torch.zeros(3, 4), 2)\n"
        "assert _build.load.cache_info().currsize == 0 and not _build.build_seconds\n"
        "assert gl.gru_layer.launches == 0 and gd.gru_decode.launches == 0\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path), PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
