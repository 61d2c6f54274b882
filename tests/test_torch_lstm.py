"""CPU parity of the port's LSTM serving path against the JAX package.

Kernel L (``ops/lstm_layer.py``) and kernel M (``ops/lstm_decode.py``) run
their plain PyTorch versions on CPU tensors; the JAX side runs its Pallas
kernels in interpret mode (``lstm_layer_infer_x`` / ``fused_lstm_decode_scan``
with ``interpret=True``, ``MidiVAE._interpret``). Same numpy inputs and
parameters. Tolerance f32 atol 1e-5; argmax equal. Also the LSTM model's
device dispatch (decided from the device type, so no card is needed), the
transfer CLI of an LSTM run against the JAX CLI, and the launch limits of L
and M.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tools_module
from midi_vae_tpu.cli import transfer as jax_transfer_cli
from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.data import smf as jax_smf
from midi_vae_tpu.data.tensorize import load_rolls_from_path
from midi_vae_tpu.evaluation.generation import GenerationContext as JaxContext
from midi_vae_tpu.models.cells import LSTMCell, dense_init
from midi_vae_tpu.models.vae import MidiVAE as JaxVAE
from midi_vae_tpu.ops.fused_lstm import fused_lstm_decode_scan
from midi_vae_tpu.ops.fused_train import lstm_layer_infer_x
from midi_vae_tpu_torch.cli import transfer as transfer_cli
from midi_vae_tpu_torch.evaluation.generation import GenerationContext
from midi_vae_tpu_torch.models import rnn as port_rnn
from midi_vae_tpu_torch.models import vae as port_vae
from midi_vae_tpu_torch.models.vae import MidiVAE
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops.lstm_decode import lstm_decode, lstm_decode_reference
from midi_vae_tpu_torch.ops import lstm_layer as port_layer
from midi_vae_tpu_torch.ops.lstm_layer import lstm_layer, lstm_layer_reference
from midi_vae_tpu_torch.training import checkpoint as port_ckpt

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v) for v in tree]
    return _t(tree)


@pytest.mark.parametrize("D", [1, 16, 61])
@pytest.mark.parametrize("return_sequences", [True, False])
def test_lstm_layer_matches_jax(D, return_sequences):
    T, B, H = 6, 4, 16
    rng = np.random.RandomState(D)
    x = rng.randn(T, B, D).astype(np.float32)
    h0, c0 = (0.3 * rng.randn(2, B, H)).astype(np.float32)
    p = LSTMCell.init(np.array([0, D], np.uint32), D, H)
    p["b"] = p["b"] + (0.1 * rng.randn(4 * H)).astype(np.float32)
    want = lstm_layer_infer_x(jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0), p["w"], p["b"],
                              p["u"], "tanh", return_sequences, True)
    got = lstm_layer(_t(x), _t(h0), _t(c0), _t(p["w"]), _t(p["b"]), _t(p["u"]), "tanh",
                     return_sequences)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    got = lstm_layer_reference(_t(x), _t(h0), _t(c0), _t(p["w"]), _t(p["b"]), _t(p["u"]),
                               "tanh", return_sequences)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert all(getattr(port_layer, f).launches == 0 for f in port_layer.L_PHASES)


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("out_activation", ["softmax", "sigmoid", "linear"])
@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_lstm_decode_matches_jax(n_layers, out_activation, activation):
    T, B, D, H = 6, 4, 12, 16
    rng = np.random.RandomState(n_layers)
    cells = [LSTMCell.init(np.array([1, i], np.uint32), D if i == 0 else H, H)
             for i in range(n_layers)]
    out_dense = dense_init(np.array([1, 9], np.uint32), H, D)
    states = [tuple((0.3 * rng.randn(2, B, H)).astype(np.float32)) for _ in range(n_layers)]
    start = np.zeros((B, D), np.float32)
    want = fused_lstm_decode_scan(cells, out_dense, tuple(states), jnp.asarray(start), T,
                                  activation, out_activation, True)
    args = (_tree(cells), _tree(out_dense), [tuple(_t(s) for s in st) for st in states], _t(start),
            T, activation, out_activation)
    for fn in (lstm_decode, lstm_decode_reference):
        for g, w in zip(fn(*args), want):
            assert tuple(g.shape) == (T, B, D)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    assert lstm_decode.launches == 0


def test_lstm_ops_refuse_what_the_kernels_do_not_take():
    x, h = torch.zeros(3, 2, 4), torch.zeros(2, 32)
    w, b, u = torch.zeros(4, 128), torch.zeros(128), torch.zeros(32, 128)
    with pytest.raises(ValueError, match="activation"):
        lstm_layer(x, h, h, w, b, u, "elu")
    with pytest.raises(ValueError, match="w has shape"):
        lstm_layer(x, h, h, torch.zeros(5, 128), b, u)
    cell = {"w": torch.zeros(4, 128), "u": u, "b": b}
    out = {"w": torch.zeros(32, 4), "b": torch.zeros(4)}
    with pytest.raises(ValueError, match="1- or 2-layer"):
        lstm_decode([cell] * 3, out, [(h, h)] * 3, torch.zeros(2, 4), 5)
    with pytest.raises(ValueError, match="output activation"):
        lstm_decode([cell], out, [(h, h)], torch.zeros(2, 4), 5, "tanh", "softplus")


def make_batch(cfg, B, seed=0):
    rng = np.random.RandomState(seed)
    eye = lambda d, idx: np.eye(d, dtype=np.float32)[idx]  # noqa: E731
    return {
        "X": eye(cfg.input_dim, rng.randint(0, cfg.input_dim, (B, cfg.input_length))),
        "I": eye(cfg.instrument_dim, rng.randint(0, cfg.instrument_dim, (B, cfg.max_voices))),
        "V": rng.rand(B, cfg.output_length, 1).astype(np.float32),
        "D": eye(2, rng.randint(0, 2, (B, cfg.output_length))),
    }


LSTM_CONFIGS = {
    "default": {"cell_type": "LSTM"},
    "held_next_composer": {"cell_type": "LSTM", "meta_held_notes": True, "meta_next_notes": True,
                           "decoder_input_composer": True},
    # relu cells: the encoder takes the plain scan, the heads kernel M
    "relu_cells": {"cell_type": "LSTM", "lstm_activation": "relu"},
}


@pytest.mark.parametrize("name", sorted(LSTM_CONFIGS))
def test_lstm_model_matches_jax(name):
    """encode_stats and decode(inference=True) of the LSTM MidiVAE against
    the JAX model with its kernel tier in interpret mode."""
    cfg = small_test_config(**LSTM_CONFIGS[name])
    jm = JaxVAE(cfg)
    jm._interpret = True
    params = jm.init_params(jax.random.PRNGKey(4))
    batch = make_batch(cfg, 5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mean, logvar = jm.encode_stats(params, jb, inference=True)
    rng = np.random.RandomState(1)
    H = rng.randn(5, cfg.latent_dim).astype(np.float32) * 0.5
    A = (np.eye(cfg.decoder_additional_input_dim, dtype=np.float32)[[0, 1, 0, 1, 1]]
         if cfg.decoder_additional_input else None)
    heads = jm.decode(params, mean, history=jnp.asarray(H),
                      additional=None if A is None else jnp.asarray(A), inference=True)
    model = MidiVAE(cfg, jax.tree_util.tree_map(np.asarray, params))
    with torch.inference_mode():
        got_mean, got_logvar = model.encode_stats({k: _t(v) for k, v in batch.items()})
        got_heads = model.decode(got_mean, _t(H), None if A is None else _t(A))
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(mean), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_logvar.numpy(), np.asarray(logvar), rtol=0, atol=ATOL)
    assert sorted(got_heads) == sorted(heads)
    for head, (probs, logits) in got_heads.items():
        wp, wl = (np.asarray(a) for a in heads[head])
        np.testing.assert_allclose(probs.numpy(), wp, rtol=0, atol=ATOL, err_msg=head)
        np.testing.assert_allclose(logits.numpy(), wl, rtol=0, atol=ATOL, err_msg=head)
        if head != "velocity":
            np.testing.assert_array_equal(probs.numpy().argmax(-1), wp.argmax(-1), err_msg=head)


def write_songs(folder, n, seed=0):
    corpus = tools_module("make_demo_corpus")
    rng = np.random.RandomState(seed)
    d = os.path.join(folder, "style1")
    os.makedirs(d, exist_ok=True)
    paths = []
    for i in range(n):
        paths.append(os.path.join(d, f"song{i}.mid"))
        corpus.make_song(corpus.STYLES["style1"], rng, bars=6).write(paths[-1])
    return paths


def test_lstm_style_transfer_song_matches_jax(tmp_path):
    cfg = small_test_config(cell_type="LSTM")
    params = JaxVAE(cfg).init_params(jax.random.PRNGKey(2))
    song = load_rolls_from_path(write_songs(str(tmp_path), 1)[0], cfg)
    jm = JaxVAE(cfg)
    jm._interpret = True
    want, want_z = JaxContext(cfg, jm, params).style_transfer_song(
        song.X, song.I, song.V, song.D, C=0, C_switch=1)
    port = GenerationContext(cfg, MidiVAE(cfg, jax.tree_util.tree_map(np.asarray, params)), "cpu")
    got, got_z = port.style_transfer_song(song.X, song.I, song.V, song.D, C=0, C_switch=1)
    np.testing.assert_allclose(got_z, want_z, rtol=0, atol=ATOL)
    for name, g, w in zip("YIVDN", got, want):
        assert g.shape == w.shape, name
        if name == "V":
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _notes(path):
    mid = jax_smf.read_midi(path)
    return [(inst.program, [(n.pitch, round(n.start, 6), round(n.end, 6), n.velocity)
                            for n in inst.notes]) for inst in mid.instruments]


def test_lstm_transfer_cli_matches_jax_cli(tmp_path):
    """The port's transfer CLI on a converted LSTM run writes the same songs
    as the JAX CLI on the run itself: the same notes, instruments and
    velocities."""
    from midi_vae_tpu.training import checkpoint as jax_ckpt
    from midi_vae_tpu.training.trainer import make_optimizer

    cfg = small_test_config(cell_type="LSTM")
    params = JaxVAE(cfg).init_params(jax.random.PRNGKey(8))
    run, port_run = str(tmp_path / "jax_run"), str(tmp_path / "port_run")
    jax_ckpt.save_checkpoint(run, 1, params, make_optimizer(cfg).init(params),
                             jax.random.PRNGKey(0), cfg)
    assert tools_module("jax_run_to_torch").main([run, port_run]) == 0
    inputs = write_songs(str(tmp_path / "songs"), 2, seed=4)
    common = ["--input", *inputs, "--to-class", "style2", "--write-reconstruction"]
    assert jax_transfer_cli.main(["--model", run, "--output", str(tmp_path / "jax"), "--cpu",
                                  *common]) == 0
    assert transfer_cli.main(["--model", port_run, "--output", str(tmp_path / "port"),
                              "--device", "cpu", *common]) == 0
    written = sorted(os.listdir(tmp_path / "jax"))
    assert written == sorted(os.listdir(tmp_path / "port")) and len(written) == 4
    for name in written:
        assert _notes(str(tmp_path / "port" / name)) == _notes(str(tmp_path / "jax" / name)), name


def test_lstm_serving_dispatch_on_cuda():
    """The dispatch decides from the device type, so it is tested without a
    card: LSTM serving takes kernels L and M on CUDA; LSTM training takes
    its kernels too (no raise); a head the JAX package decodes step by step
    (3 layers, or another output activation) takes kernel S, step by step,
    instead of M; a GRU head of that kind takes kernel T."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    model = MidiVAE(small_test_config(cell_type="LSTM"))
    assert model.kernels_enabled(cuda) and model.kernels_enabled(cpu)
    for n_layers, out_act in ((2, "softmax"), (1, "sigmoid"), (1, "linear")):
        assert model.serving_head_kernel("notes", n_layers, out_act, cuda)
    assert model.train_kernels_enabled(cuda) is True
    assert model.train_kernels_enabled(cpu) is True
    assert model.serving_head_kernel("notes", 3, "softmax", cuda) is False
    assert model.serving_head_kernel("velocity", 1, "relu", cuda) is False
    assert model.decode_step(model.kernels_enabled(cuda)) is not None
    assert not model.serving_head_kernel("notes", 3, "softmax", cpu)
    # a GRU head of that kind takes its own per-step cell, kernel T (row 28)
    gru = MidiVAE(small_test_config())
    assert gru.serving_head_kernel("notes", 3, "softmax", cuda) is False
    assert gru.decode_step(gru.kernels_enabled(cuda)).__module__.endswith("gru_step")


def test_three_layer_lstm_head_takes_the_plain_scan_on_the_cpu(monkeypatch):
    """On the CPU a 3-layer LSTM notes head decodes through the plain scan,
    as the JAX package's interpret tier runs it step by step, and matches."""
    cfg = small_test_config(cell_type="LSTM", num_layers_decoder=3)
    jm = JaxVAE(cfg)
    jm._interpret = True
    params = jm.init_params(jax.random.PRNGKey(6))
    z = np.random.RandomState(0).randn(3, cfg.latent_dim).astype(np.float32)
    want = jm.decode(params, jnp.asarray(z), inference=True)
    calls = []
    monkeypatch.setattr(port_vae, "lstm_decode",
                        lambda *a: calls.append(len(a[0])) or lstm_decode(*a))
    with torch.inference_mode():
        got = MidiVAE(cfg, jax.tree_util.tree_map(np.asarray, params)).decode(_t(z))
    assert sorted(calls) == [1, 1]  # velocity and instrument; not the notes head
    for head, (probs, _logits) in got.items():
        np.testing.assert_allclose(probs.numpy(), np.asarray(want[head][0]), rtol=0, atol=ATOL,
                                   err_msg=head)


@pytest.mark.parametrize("activation, encoder_calls", [("tanh", 4), ("relu", 0)])
def test_lstm_encoder_kernel_only_for_tanh_cells(monkeypatch, activation, encoder_calls):
    """``lstm_activation != 'tanh'`` encoders take the plain scan on any
    device (the JAX package's ``_lstm_x_use_pallas``); tanh ones go through
    kernel L's wrapper, one call per layer (notes x 2, instrument, velocity)."""
    calls = []
    monkeypatch.setattr(port_rnn, "lstm_layer", lambda *a: calls.append(1) or lstm_layer(*a))
    cfg = small_test_config(cell_type="LSTM", lstm_activation=activation)
    with torch.inference_mode():
        MidiVAE(cfg).encode_stats({k: _t(v) for k, v in make_batch(cfg, 2).items()})
    assert len(calls) == encoder_calls


@pytest.mark.parametrize("H", [256, 512])
def test_layout_of_l_and_m(H):
    """Kernels L and M launch at the LSTM model's widths (H = 256 and 512):
    their registers a thread times H threads fit an SM, their tiles fit a
    block's shared memory; H = 1024 threads do not fit either's registers."""
    for D in (1, 16, 61, H):
        assert _layout.launch_limit("L", H, _layout.smem_bytes("L", H, D)) is None
        assert _layout.smem_bytes("L", H, D) == 4 * 8 * (D + 3 * H)
    for D, n_layers in ((61, 2), (1, 1), (16, 1)):
        smem = _layout.smem_bytes("M", H, D, n_layers)
        assert smem == 4 * 8 * (2 * D + (2 * n_layers + 1) * H)
        assert _layout.launch_limit("M", H, smem) is None
    for kernel in ("L", "M"):
        why = _layout.launch_limit(kernel, 1024, _layout.smem_bytes(kernel, 1024, 61, 2))
        assert why is not None and "registers" in why


def test_lstm_run_round_trips_through_the_bridge(tmp_path):
    """LSTM parameters (w (D, 4H), u (H, 4H), b (4H,), init dense layers
    num_layers x 2 per head) cross the bridge under the JAX key paths."""
    cfg = small_test_config(cell_type="LSTM")
    params = jax.tree_util.tree_map(np.asarray, JaxVAE(cfg).init_params(jax.random.PRNGKey(1)))
    port_ckpt.save_run(str(tmp_path), cfg, params)
    back = port_ckpt.load_params(str(tmp_path))
    H = cfg.lstm_size
    assert back["encoder"]["notes_rnn"][0]["w"].shape == (cfg.input_dim, 4 * H)
    assert back["encoder"]["notes_rnn"][1]["u"].shape == (H, 4 * H)
    assert back["decoder"]["notes"]["cells"][0]["b"].shape == (4 * H,)
    assert len(back["decoder"]["notes"]["init"]) == 2 * cfg.num_layers_decoder
    assert len(back["decoder"]["velocity"]["init"]) == 2
    model = MidiVAE(port_ckpt.load_config(str(tmp_path)), back)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    assert len(list(model.params.parameters())) == len(flat_want)
