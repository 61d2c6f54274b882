"""CPU parity of the port's judge training against the JAX package.

``classifier_loss`` and every gradient, three ``ClassifierTrainer`` steps and
``evaluate``'s confusion matrix, for the three input kinds and both cell
types, on the same numpy parameters, batches and masks: the JAX
``StyleClassifier`` has no interpret hook, so on the CPU it runs its plain
scan; the port runs the plain versions of its training kernels (A + C + W
for GRU judges, L + N + W for LSTM ones; CPU tensors). Tolerances (float32,
sums in another order): the loss and the accuracy atol 1e-5; gradients atol
1e-5 + rtol 1e-4; parameters after three Adam steps atol 1e-5 + rtol 1e-4
(as tests/test_torch_train_loop.py); the confusion matrix exactly. Also the
port's ``cli.classify --device cpu`` on a tiny authored corpus: the judge
directories it writes, an exact resume, and the judges served by
``cli.transfer --classifiers``.
"""

import io
import json
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tools_module
from midi_vae_tpu.models import classifier as jax_clf
from midi_vae_tpu.parallel import make_mesh
from midi_vae_tpu.training import classifier_trainer as jax_ct
from midi_vae_tpu_torch import bridge
from midi_vae_tpu_torch.cli import classify as classify_cli
from midi_vae_tpu_torch.cli import transfer as transfer_cli
from midi_vae_tpu_torch.config import Config
from midi_vae_tpu_torch.models import classifier as port_clf
from midi_vae_tpu_torch.models.vae import MidiVAE
from midi_vae_tpu_torch.ops import gru_layer as port_gru
from midi_vae_tpu_torch.ops import lstm_layer as port_lstm
from midi_vae_tpu_torch.training import checkpoint as port_ckpt
from midi_vae_tpu_torch.training import classifier_trainer as port_ct
from test_torch_judges import KIND_SHAPES, kind_inputs, spec_pair

LOSS_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
KINDS = sorted(KIND_SHAPES)
CELLS = ["GRU", "LSTM"]


def _labels(n, seed):
    return np.random.RandomState(seed).randint(0, 2, n)


def _onehot(labels):
    return np.eye(2, dtype=np.float32)[labels]


@pytest.mark.parametrize("cell_type", CELLS)
@pytest.mark.parametrize("kind", KINDS)
def test_classifier_loss_and_every_gradient_match_jax(kind, cell_type, monkeypatch):
    """Masked crossentropy, accuracy and every parameter gradient of one
    judge batch with 2 padding rows (their inputs nonzero: the mask alone
    keeps them out), through the port's training layers."""
    jspec, pspec = spec_pair(kind, cell_type)
    jm = jax_clf.StyleClassifier(jspec, platform="cpu")
    params = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(5)))
    x, c = kind_inputs(kind, 6, seed=2), _onehot(_labels(6, 3))
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    (want_loss, want_m), want = jax.value_and_grad(
        lambda p: jax_clf.classifier_loss(jm, p, jnp.asarray(x), jnp.asarray(c),
                                          jnp.asarray(mask)), has_aux=True)(params)
    calls = []
    train_x = port_lstm.lstm_layer_train_x if cell_type == "LSTM" else port_gru.gru_layer_train_x
    module = "lstm_layer_train_x" if cell_type == "LSTM" else "gru_layer_train_x"
    from midi_vae_tpu_torch.models import rnn as port_rnn

    monkeypatch.setattr(port_rnn, module, lambda *a: calls.append(1) or train_x(*a))
    model = port_clf.StyleClassifier(pspec, params, trainable=True)
    loss, metrics = port_clf.classifier_loss(model, torch.from_numpy(x), torch.from_numpy(c),
                                             torch.from_numpy(mask))
    assert len(calls) == 2  # both layers on the training path
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(metrics["acc"].item(), float(want_m["acc"]), rtol=0, atol=LOSS_ATOL)
    named = list(model.params.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    want = bridge.flatten(jax.tree_util.tree_map(np.asarray, want))
    got = {k.replace(".", "/"): g.numpy() for (k, _), g in zip(named, grads)}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("cell_type", CELLS)
@pytest.mark.parametrize("kind", KINDS)
def test_three_trainer_steps_and_evaluate_match_jax(kind, cell_type):
    """Three Adam steps of ClassifierTrainer on shared parameters and the
    same padded batches as the JAX trainer's train_step: the losses, the
    parameters; then evaluate's loss, accuracy and confusion matrix."""
    jspec, pspec = spec_pair(kind, cell_type, batch_size=4)
    jt = jax_ct.ClassifierTrainer(jspec, mesh=make_mesh(devices=[jax.devices()[0]]))
    jstate = jt.init_state(seed=1)
    port = port_ct.ClassifierTrainer(pspec, "cpu")
    state = port.new_state(jax.tree_util.tree_map(np.asarray, jstate.params))
    x, labels = kind_inputs(kind, 10, seed=4), _labels(10, 5)
    grid, masks = port_ct.padded_batch_order(np.random.RandomState(6).permutation(10), 4)
    p, o = jstate.params, jstate.opt_state
    for step, (idx, m) in enumerate(zip(grid, masks)):
        safe = np.maximum(idx, 0)
        xb, cb = x[safe], _onehot(labels[safe])
        p, o, jm = jt.train_step(p, o, jnp.asarray(xb), jnp.asarray(cb), jnp.asarray(m))
        pm = port.train_step(state, *(torch.from_numpy(a) for a in (xb, cb, m)))
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=0,
                                   atol=LOSS_ATOL, err_msg=f"step {step}")
    assert step == 2 and masks[-1].sum() == 2  # the last batch half padding
    want = bridge.flatten(jax.tree_util.tree_map(np.asarray, p))
    got = bridge.flatten(bridge.to_tree(state.model.params))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    jstate.params, jstate.opt_state = p, o
    xt, lt = kind_inputs(kind, 7, seed=8), _labels(7, 9)
    jev, pev = jt.evaluate(jstate, xt, lt), port.evaluate(state, xt, lt)
    np.testing.assert_array_equal(pev["confusion"], jev["confusion"])
    assert pev["accuracy"] == jev["accuracy"]
    for k in ("loss", "acc"):
        np.testing.assert_allclose(pev[k], jev[k], rtol=0, atol=LOSS_ATOL, err_msg=k)


def test_classifier_arrays_match_jax(tmp_path):
    from midi_vae_tpu.data.batching import flatten_dataset as jax_flatten
    from midi_vae_tpu.data.dataset import import_midi_from_folder as jax_import
    from midi_vae_tpu_torch.data.batching import flatten_dataset
    from midi_vae_tpu_torch.data.dataset import import_midi_from_folder

    cfg = Config(classes=("style1", "style2"))
    corpus = _corpus(str(tmp_path / "corpus"))
    jtrain = jax_flatten(jax_import(corpus, cfg), cfg)[0]
    train = flatten_dataset(import_midi_from_folder(corpus, cfg), cfg)[0]
    for kind in KINDS:
        for got, want in zip(port_ct.classifier_arrays(train, kind),
                             jax_ct.classifier_arrays(jtrain, kind)):
            np.testing.assert_array_equal(got, want, err_msg=kind)


def _corpus(folder, songs=3):
    corpus = tools_module("make_demo_corpus")
    rng = np.random.RandomState(0)
    for style in ("style1", "style2"):
        os.makedirs(os.path.join(folder, style), exist_ok=True)
        for i in range(songs):
            corpus.make_song(corpus.STYLES[style], rng, bars=6).write(
                os.path.join(folder, style, f"{style}_{i}.mid"))
    return folder


def test_resume_is_exact(tmp_path):
    """fit 2 epochs == fit 1 epoch, restore, fit 1 more: parameters, Adam
    state and generator bit-equal (shuffled order, test evaluation, save)."""
    pspec = spec_pair("pitch", "LSTM", batch_size=4)[1]
    trainer = port_ct.ClassifierTrainer(pspec, "cpu")
    x, labels = kind_inputs("pitch", 10, seed=1), _labels(10, 2)
    xt, lt = kind_inputs("pitch", 3, seed=3), _labels(3, 4)
    logs = []
    full = trainer.init_state(seed=3)
    trainer.fit(full, x, labels, xt, lt, epochs=2, output_dir=str(tmp_path / "full"),
                save_step=1, log_fn=logs.append)
    half = trainer.init_state(seed=3)
    run = str(tmp_path / "half")
    trainer.fit(half, x, labels, xt, lt, epochs=1, output_dir=run, save_step=1,
                log_fn=logs.append)
    assert port_ckpt.latest_epoch(run) == 0
    resumed = trainer.restore(run)
    assert resumed.epoch == 1
    hist = trainer.fit(resumed, x, labels, xt, lt, epochs=2, output_dir=run, save_step=1,
                       log_fn=logs.append)
    assert hist["epoch"] == [1] and len(hist["test"]) == 1
    for a, b in zip(full.model.params.parameters(), resumed.model.params.parameters()):
        assert torch.equal(a, b)
    assert full.opt_state.count == resumed.opt_state.count == 6
    for slot in full.opt_state.state:
        assert all(torch.equal(a, b) for a, b in
                   zip(full.opt_state.state[slot], resumed.opt_state.state[slot]))
    assert torch.equal(full.rng.get_state(), resumed.rng.get_state())
    loaded = port_ct.load_classifier(run)
    assert all(torch.equal(a, b) for a, b in zip(loaded.parameters(),
                                                 resumed.model.params.parameters()))


def test_classify_cli_writes_judges_the_transfer_cli_serves(tmp_path):
    corpus = _corpus(str(tmp_path / "corpus"))
    out = str(tmp_path / "judges")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = classify_cli.main(["--source", corpus, "--output", out, "--classes",
                                "style1,style2", "--epochs", "2", "--lstm-size", "16",
                                "--batch-size", "8", "--device", "cpu",
                                "--cache", str(tmp_path / "cache")])
    assert rc == 0, buf.getvalue()
    for kind in KINDS:
        kdir = os.path.join(out, kind)
        assert {"spec.json", "params.npz", "history.json", "epoch_0", "epoch_1"} <= set(
            os.listdir(kdir)), kind
        with open(os.path.join(kdir, "history.json")) as f:
            hist = json.load(f)
        assert hist["epoch"] == [0, 1] and len(hist["test"]) == 2
        assert all(np.isfinite(e["loss"]) for e in hist["train"])
        judge = port_ckpt.load_classifier(kdir)
        assert judge.spec.kind == kind and judge.spec.lstm_size == 16
        assert judge.spec.cell_type == "GRU" and judge.spec.batch_size == 8
    # a VAE run of the same window shapes, served with the trained judges
    cfg = Config(classes=("style1", "style2"), lstm_size=16, latent_dim=16)
    run = str(tmp_path / "run")
    port_ckpt.save_run(run, cfg, bridge.to_tree(MidiVAE(cfg).params))
    song = os.path.join(corpus, "style1", "style1_0.mid")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = transfer_cli.main(["--model", run, "--input", song, "--to-class", "style2",
                                "--output", str(tmp_path / "out"), "--classifiers", out,
                                "--device", "cpu"])
    assert rc == 0
    judged = [line for line in buf.getvalue().splitlines() if "judge confidence" in line]
    assert len(judged) == 2 and all(k in judged[0] for k in KINDS), buf.getvalue()


def test_classify_cli_cuda_without_a_card_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        classify_cli.main(["--source", str(tmp_path), "--output", str(tmp_path / "judges")])


def test_judge_route_and_layers():
    """The judges' layers take the route chooser at their width: narrow
    (A + C or L + N) at 256 for both cell types; the first layer's dx is not
    wanted."""
    for cell in CELLS:
        spec = port_clf.ClassifierSpec.for_kind("pitch", Config(cell_type=cell))
        model = port_clf.StyleClassifier(spec)
        assert model.train_route(torch.device("cuda")) == "narrow"
        wide = port_clf.StyleClassifier(port_clf.ClassifierSpec.for_kind(
            "pitch", Config(cell_type=cell), lstm_size=512))
        assert wide.train_route(torch.device("cuda")) == ("wide" if cell == "LSTM" else "narrow")
