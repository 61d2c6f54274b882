"""CPU tests of the port's training loop: three trainer steps against the JAX
package's trainer, an exact checkpoint resume, and the train CLI writing a
run that the transfer CLI serves.

The JAX trainer runs its Pallas kernels in interpret mode; both trainers take
the same batches and the same noise (the JAX trainer's own draws, computed
from its key chain and handed to the port). Parameters after three Adam
steps: atol 1e-5 + rtol 1e-4 (f32 gradients summed in another order; Adam
divides each update by the gradient's own magnitude, so gradients near zero
move the parameter by up to lr whatever their size). Resume: bit-equal.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.data import smf
from midi_vae_tpu.data.batching import flatten_split
from midi_vae_tpu.parallel import make_mesh
from midi_vae_tpu.training.trainer import VAETrainer as JaxTrainer
from midi_vae_tpu_torch import bridge
from midi_vae_tpu_torch.cli import train as train_cli
from midi_vae_tpu_torch.cli import transfer as transfer_cli
from midi_vae_tpu_torch.data.dataset import import_midi_from_folder
from midi_vae_tpu_torch.training import checkpoint as ckpt
from midi_vae_tpu_torch.training.trainer import VAETrainer, _slice_batch, pad_batch_to
from conftest import tools_module
from test_torch_transfer import write_songs

RTOL, ATOL = 1e-4, 1e-5


def make_flat(cfg, windows=(4, 3, 3), seed=0):
    """A FlatSplit of random songs with the given window counts."""
    rng = np.random.RandomState(seed)
    eye = lambda d, idx: np.eye(d, dtype=np.float32)[idx]  # noqa: E731
    songs = [
        (eye(cfg.input_dim, rng.randint(0, cfg.input_dim, (n, cfg.input_length))),
         eye(cfg.output_dim, rng.randint(0, cfg.output_dim, (n, cfg.output_length))),
         eye(cfg.instrument_dim, rng.randint(0, cfg.instrument_dim, cfg.max_voices)),
         rng.rand(n, cfg.output_length).astype(np.float32),
         rng.randint(0, 2, (n, cfg.output_length)),
         i % cfg.num_classes)
        for i, n in enumerate(windows)
    ]
    X, Y, I, V, D, C = (list(x) for x in zip(*songs))
    return flatten_split(X, Y, I, V, D, C, None, cfg)


def test_three_train_steps_match_jax():
    cfg = small_test_config(batch_size=4)
    flat = make_flat(cfg)
    jt = JaxTrainer(cfg, mesh=make_mesh(devices=[jax.devices()[0]]))
    jt.model._interpret = True
    jstate = jt.init_state()
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    port = VAETrainer(cfg, "cpu")
    state = port.new_state(params)
    rng = jstate.rng
    p, o = jstate.params, jstate.opt_state
    H = np.random.RandomState(1).randn(flat.num_windows, cfg.latent_dim).astype(np.float32)
    for step, idx in enumerate(([0, 5, 2, 7], [1, 3, 8, 9], [4, 6])):
        batch, mask = pad_batch_to(_slice_batch(flat, np.array(idx), cfg, H), cfg.batch_size)
        batch["M"] = mask
        # the noise the JAX step draws: its key chain, then sample_z's draw
        _next, sample_key = jax.random.split(rng)
        noise = cfg.epsilon_std * jax.random.normal(sample_key, (cfg.batch_size, cfg.latent_dim))
        p, o, rng, jm = jt.train_step(p, o, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        pm = port.train_step(state, {k: torch.from_numpy(v.copy()) for k, v in batch.items()},
                             torch.from_numpy(np.asarray(noise).copy()))
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=0, atol=1e-5,
                                   err_msg=f"step {step}")
    want = bridge.flatten(jax.tree_util.tree_map(np.asarray, p))
    got = bridge.flatten(bridge.to_tree(state.model.params))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_resume_is_bit_exact(tmp_path):
    """fit 2 epochs == fit 1 epoch, restore, fit 1 more: params, optimizer
    state and generator bit-equal (shuffled order, noise, history, test).
    With the encode-pass history (``history_from_train_z=False``): the z
    cache of the default is derived and not checkpointed, so a resumed run
    seeds it by an encode pass, as the JAX package does
    (tests/test_torch_history.py holds that against the JAX fit)."""
    cfg = small_test_config(batch_size=4, save_step=1, history_from_train_z=False)
    train, test = make_flat(cfg), make_flat(cfg, (3,), seed=1)
    trainer = VAETrainer(cfg, "cpu")
    logs = []
    full = trainer.init_state()
    trainer.fit(full, train, test, epochs=2, output_dir=str(tmp_path / "full"), log_fn=logs.append,
                plot=False)
    half = trainer.init_state()
    run = str(tmp_path / "half")
    trainer.fit(half, train, test, epochs=1, output_dir=run, log_fn=logs.append, plot=False)
    assert ckpt.latest_epoch(run) == 0
    resumed = trainer.restore(run)
    assert resumed.epoch == 1
    hist = trainer.fit(resumed, train, test, epochs=2, output_dir=run, log_fn=logs.append,
                       plot=False)
    assert hist["epoch"] == [0, 1] and len(hist["test"]) == 2
    for a, b in zip(full.model.params.parameters(), resumed.model.params.parameters()):
        assert torch.equal(a, b)
    assert full.opt_state.count == resumed.opt_state.count == 6
    for slot in full.opt_state.state:
        assert all(torch.equal(a, b) for a, b in
                   zip(full.opt_state.state[slot], resumed.opt_state.state[slot]))
    assert torch.equal(full.rng.get_state(), resumed.rng.get_state())
    # the run directory serves: its top-level params are the last epoch's
    served = bridge.flatten(ckpt.load_params(run))
    trained = bridge.flatten(bridge.to_tree(resumed.model.params))
    assert all(np.array_equal(served[k], trained[k]) for k in trained)


def test_train_cli_writes_a_run_the_transfer_cli_serves(tmp_path):
    corpus = str(tmp_path / "corpus")
    write_songs(corpus, 2, seed=4)
    write_songs(os.path.join(corpus, "x"), 1, seed=5)  # a second folder: style1 again
    run = str(tmp_path / "run")
    small = ["--set", "bars_input_length=2", "--set", "bars_output_length=2", "--set",
             "lstm_size=16", "--set", "latent_dim=16", "--set", "max_voices=2", "--set",
             "batch_size=64"]
    rc = train_cli.main(["--source", corpus, "--output", run, "--epochs", "1", "--device", "cpu",
                         "--cache", str(tmp_path / "cache"), *small])
    assert rc == 0
    assert ckpt.latest_epoch(run) == 0
    assert os.path.exists(os.path.join(run, "params.npz"))
    assert ckpt.load_config(run).lstm_size == 16
    rc = train_cli.main(["--source", corpus, "--output", run, "--epochs", "2", "--device", "cpu",
                         "--cache", str(tmp_path / "cache"), "--resume"])
    assert rc == 0 and ckpt.latest_epoch(run) == 1
    out = str(tmp_path / "out")
    song = os.path.join(corpus, "style1", "song0.mid")
    assert transfer_cli.main(["--model", run, "--input", song, "--to-class", "style2",
                              "--output", out, "--device", "cpu"]) == 0
    assert smf.read_midi(os.path.join(out, "song0_style1_to_style2.mid")).instruments


def test_train_cli_cuda_without_a_card_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--source", str(tmp_path), "--output", str(tmp_path / "run")])


def test_import_corpus_without_sklearn_takes_the_seeded_split(tmp_path, monkeypatch):
    """Where scikit-learn is missing, the port's corpus import
    (``data/dataset.py``) takes the package's seeded shuffle split instead of
    failing."""
    corpus_tool = tools_module("make_demo_corpus")
    rng = np.random.RandomState(0)
    corpus = tmp_path / "corpus"
    for style in ("style1", "style2"):
        (corpus / style).mkdir(parents=True)
        for i in range(3):
            corpus_tool.make_song(corpus_tool.STYLES[style], rng, bars=6).write(
                str(corpus / style / f"s{i}.mid"))
    for name in ("sklearn", "sklearn.model_selection"):  # importing them now fails
        monkeypatch.setitem(sys.modules, name, None)
    cfg = small_test_config()
    ds = import_midi_from_folder(str(corpus), cfg)
    assert sys.modules.get("sklearn.model_selection") is None
    assert sorted(set(ds.C_train + ds.C_test)) == [0, 1]
    assert ds.train_set_size == 5 and ds.test_set_size == 1
