"""CPU parity of the port's style judges against the JAX package.

``StyleClassifier.predict`` of both packages on the same numpy parameters
(bit-equal init from the same key) and inputs, for the three input kinds and
both cell types: the JAX judge runs its plain scan on the CPU, the port's
the plain versions of kernels A and L (CPU tensors). Tolerance f32 atol
1e-5. Also the velocity preprocessing, the ensemble, ``make_judge``'s
padding, a JAX-trained judge directory converted with
``tools/jax_run_to_torch.py --classifiers``, and the transfer CLI's judge
report against the JAX CLI's, to the 3 decimals both print.
"""

import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tools_module
from midi_vae_tpu.cli import transfer as jax_transfer_cli
from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.models import classifier as jax_clf
from midi_vae_tpu.training.classifier_trainer import ClassifierTrainer, load_classifier
from midi_vae_tpu_torch import bridge
from midi_vae_tpu_torch.cli import transfer as transfer_cli
from midi_vae_tpu_torch.models import classifier as port_clf
from midi_vae_tpu_torch.ops import gru_layer as port_gru_layer
from midi_vae_tpu_torch.ops import lstm_layer as port_lstm_layer
from midi_vae_tpu_torch.training import checkpoint as port_ckpt

ATOL = 1e-5
KIND_SHAPES = {"pitch": (64, 61), "velocity": (64, 1), "instrument": (4, 16)}


def kind_inputs(kind, n, seed=0):
    rng = np.random.RandomState(seed)
    T, D = KIND_SHAPES[kind]
    if kind == "velocity":
        return (rng.rand(n, T, D) * (rng.rand(n, T, D) > 0.4)).astype(np.float32)
    return np.eye(D, dtype=np.float32)[rng.randint(0, D, (n, T))]


def spec_pair(kind, cell_type, **kw):
    cfg = small_test_config(cell_type=cell_type)
    return (jax_clf.ClassifierSpec.for_kind(kind, cfg, lstm_size=16, **kw),
            port_clf.ClassifierSpec.for_kind(kind, cfg, lstm_size=16, **kw))


@pytest.mark.parametrize("cell_type", ["GRU", "LSTM"])
@pytest.mark.parametrize("kind", sorted(KIND_SHAPES))
def test_predict_matches_jax(kind, cell_type):
    jspec, pspec = spec_pair(kind, cell_type)
    assert jspec.__dict__ == pspec.__dict__
    jm = jax_clf.StyleClassifier(jspec)
    params = jm.init_params(jax.random.PRNGKey(3))
    port = port_clf.StyleClassifier(pspec, jax.tree_util.tree_map(np.asarray, params))
    x = kind_inputs(kind, 5)
    want = np.asarray(jm.predict(params, jnp.asarray(x)))
    layer, phases = ((port_lstm_layer, port_lstm_layer.L_PHASES) if cell_type == "LSTM"
                     else (port_gru_layer, port_gru_layer.A_PHASES))
    counters = [getattr(layer, f) for f in phases]
    with torch.inference_mode():
        got = port.predict(torch.from_numpy(x)).numpy()
    assert got.shape == (5, pspec.num_classes)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-6)
    assert all(c.launches == 0 for c in counters)  # CPU tensors: the plain versions


def test_init_params_bit_equal():
    for cell_type in ("GRU", "LSTM"):
        jspec, pspec = spec_pair("pitch", cell_type)
        want = bridge.flatten(jax_clf.StyleClassifier(jspec).init_params(jax.random.PRNGKey(9)))
        got = bridge.flatten(port_clf.StyleClassifier(pspec).init_params(np.array([0, 9], np.uint32)))
        assert sorted(got) == sorted(want)
        assert all(np.array_equal(got[k], want[k]) for k in want), cell_type


@pytest.mark.parametrize("flags", [{}, {"scale_velocity_between_0_and_1": True},
                                   {"only_train_note_starts": True},
                                   {"scale_velocity_between_0_and_1": True,
                                    "only_train_note_starts": True}],
                         ids=["none", "scale", "note_starts", "both"])
def test_velocity_preprocessing_matches_jax(flags):
    x = kind_inputs("velocity", 4, seed=2)
    for kind in ("velocity", "pitch"):
        jspec, pspec = spec_pair(kind, "GRU", **flags)
        xin = x if kind == "velocity" else kind_inputs("pitch", 4)
        np.testing.assert_array_equal(pspec.preprocess_inputs(xin), jspec.preprocess_inputs(xin))
    assert np.array_equal(x, kind_inputs("velocity", 4, seed=2))  # the input is not modified


def test_ensemble_and_kind_inputs_match_jax():
    rng = np.random.RandomState(0)
    p, i, v = (rng.dirichlet(np.ones(3), size=4) for _ in range(3))
    for weights in (None, (1.0, 0.0, 0.0), (0.2, 0.3, 0.5)):
        kw = {} if weights is None else {"weights": weights}
        np.testing.assert_allclose(port_clf.ensemble_prediction(p, i, v, **kw),
                                   np.asarray(jax_clf.ensemble_prediction(p, i, v, **kw)),
                                   rtol=1e-6)
    X, V, I = object(), object(), object()
    for kind, want in (("pitch", X), ("velocity", V), ("instrument", I)):
        assert port_clf.classifier_inputs_for_kind(kind, X, V, I) is want
    with pytest.raises(ValueError):
        port_clf.classifier_inputs_for_kind("tempo", X, V, I)
    with pytest.raises(ValueError):
        port_clf.ClassifierSpec.for_kind("tempo", small_test_config())


@pytest.mark.parametrize("n", [1, 3, 5, 8])
def test_make_judge_pads_and_trims(n, monkeypatch):
    """The judge pads a call to the next power of two (the JAX package's
    static shapes), preprocesses per its spec, and returns n rows equal to
    an unpadded predict."""
    _, pspec = spec_pair("velocity", "LSTM", only_train_note_starts=True)
    model = port_clf.StyleClassifier(pspec, seed=1)
    seen = []
    real = model.predict
    monkeypatch.setattr(model, "predict", lambda x: seen.append(tuple(x.shape)) or real(x))
    x = kind_inputs("velocity", n, seed=n)
    got = port_clf.make_judge(model)(x)
    assert got.shape == (n, pspec.num_classes)
    assert seen == [(1 << (n - 1).bit_length(), 64, 1)]
    with torch.inference_mode():
        want = real(torch.from_numpy(pspec.preprocess_inputs(x))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def train_jax_judges(out, cell_type):
    """Two epochs of the JAX ClassifierTrainer per kind, at a tiny width."""
    cfg = small_test_config(cell_type=cell_type)
    for kind in ("pitch", "velocity", "instrument"):
        spec = jax_clf.ClassifierSpec.for_kind(kind, cfg, lstm_size=16, batch_size=8,
                                               learning_rate=3e-3)
        x = kind_inputs(kind, 16, seed=len(kind))
        c = np.random.RandomState(1).randint(0, spec.num_classes, 16)
        trainer = ClassifierTrainer(spec)
        state = trainer.init_state()
        trainer.fit(state, x, c, epochs=2, output_dir=os.path.join(out, kind),
                    log_fn=lambda s: None)
    return cfg


@pytest.mark.parametrize("cell_type", ["GRU", "LSTM"])
def test_converted_jax_judges_give_the_same_probs(tmp_path, cell_type):
    jax_dir, port_dir = str(tmp_path / "jax_judges"), str(tmp_path / "port_judges")
    train_jax_judges(jax_dir, cell_type)
    assert tools_module("jax_run_to_torch").main(["--classifiers", jax_dir, port_dir]) == 0
    for kind in ("pitch", "velocity", "instrument"):
        jm, params = load_classifier(os.path.join(jax_dir, kind))
        port = port_ckpt.load_classifier(os.path.join(port_dir, kind))
        assert port.spec.__dict__ == jm.spec.__dict__
        x = kind_inputs(kind, 6, seed=7)
        want = jax_clf.make_judge(jm, params)(x)
        got = port_clf.make_judge(port)(x)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=kind)


def test_save_and_load_classifier_round_trip(tmp_path):
    _, pspec = spec_pair("instrument", "LSTM")
    model = port_clf.StyleClassifier(pspec, seed=4)
    port_ckpt.save_classifier(str(tmp_path / "instrument"), pspec, bridge.to_tree(model.params))
    back = port_ckpt.load_classifier(str(tmp_path / "instrument"))
    assert back.spec == pspec
    x = torch.from_numpy(kind_inputs("instrument", 3))
    with torch.inference_mode():
        assert torch.equal(back.predict(x), model.predict(x))
    with pytest.raises(FileNotFoundError, match="judge directory"):
        port_ckpt.load_classifier(str(tmp_path))


def _judge_lines(text):
    return [line.strip() for line in text.splitlines() if "judge confidence" in line]


@pytest.mark.parametrize("cell_type", ["GRU", "LSTM"])
def test_transfer_cli_judges_match_jax_cli(tmp_path, cell_type):
    """``--classifiers`` prints, per song, the judges' mean confidence in the
    target class for the original and the transferred song, as the JAX CLI
    does, to the same 3 decimals."""
    from midi_vae_tpu.models.vae import MidiVAE as JaxVAE
    from midi_vae_tpu.training import checkpoint as jax_ckpt
    from midi_vae_tpu.training.trainer import make_optimizer

    jax_dir, port_dir = str(tmp_path / "jax_judges"), str(tmp_path / "port_judges")
    cfg = train_jax_judges(jax_dir, cell_type)
    assert tools_module("jax_run_to_torch").main(["--classifiers", jax_dir, port_dir]) == 0
    params = JaxVAE(cfg).init_params(jax.random.PRNGKey(5))
    run, port_run = str(tmp_path / "jax_run"), str(tmp_path / "port_run")
    jax_ckpt.save_checkpoint(run, 1, params, make_optimizer(cfg).init(params),
                             jax.random.PRNGKey(0), cfg)
    assert tools_module("jax_run_to_torch").main([run, port_run]) == 0
    corpus = tools_module("make_demo_corpus")
    song_dir = tmp_path / "songs" / "style1"
    os.makedirs(song_dir)
    rng = np.random.RandomState(3)
    inputs = []
    for i in range(2):
        inputs.append(str(song_dir / f"s{i}.mid"))
        corpus.make_song(corpus.STYLES["style1"], rng, bars=6).write(inputs[-1])
    common = ["--input", *inputs, "--to-class", "style2"]
    outs = {}
    for name, main, args in (
            ("jax", jax_transfer_cli.main, ["--model", run, "--classifiers", jax_dir, "--cpu"]),
            ("port", transfer_cli.main, ["--model", port_run, "--classifiers", port_dir,
                                         "--device", "cpu"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main([*args, *common, "--output", str(tmp_path / name)]) == 0
        outs[name] = _judge_lines(buf.getvalue())
    assert len(outs["port"]) == 4  # original and transferred, per song
    assert all("pitch" in line and "velocity" in line and "instrument" in line
               for line in outs["port"])
    assert outs["port"] == outs["jax"]
