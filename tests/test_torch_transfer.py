"""CPU tests of the port's serving path: style transfer against the JAX
GenerationContext, the transfer CLI, a jax-free process, and a JAX run
converted with tools/jax_run_to_torch.py.

The JAX side runs its Pallas kernels in interpret mode
(``MidiVAE._interpret = True``); the rolls must be equal and the switched
latents within atol 1e-5.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from conftest import tools_module
from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.data import smf
from midi_vae_tpu.data.tensorize import load_rolls_from_path
from midi_vae_tpu.evaluation.generation import GenerationContext as JaxContext
from midi_vae_tpu.models.vae import MidiVAE as JaxVAE
from midi_vae_tpu_torch import bridge
from midi_vae_tpu_torch.cli import transfer as transfer_cli
from midi_vae_tpu_torch.evaluation.generation import GenerationContext
from midi_vae_tpu_torch.models.vae import MidiVAE
from midi_vae_tpu_torch.training import checkpoint as port_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


def write_songs(folder, n, seed=0):
    """n short demo songs under folder/style1/, via tools/make_demo_corpus."""
    corpus = tools_module("make_demo_corpus")
    rng = np.random.RandomState(seed)
    d = os.path.join(folder, "style1")
    os.makedirs(d, exist_ok=True)
    paths = []
    for i in range(n):
        path = os.path.join(d, f"song{i}.mid")
        corpus.make_song(corpus.STYLES["style1"], rng, bars=6).write(path)
        paths.append(path)
    return paths


def jax_context(cfg, params):
    jm = JaxVAE(cfg)
    jm._interpret = True
    return JaxContext(cfg, jm, params)


def assert_same_transfer(cfg, jax_ctx, port_ctx, song):
    want, want_z = jax_ctx.style_transfer_song(song.X, song.I, song.V, song.D, C=0, C_switch=1)
    got, got_z = port_ctx.style_transfer_song(song.X, song.I, song.V, song.D, C=0, C_switch=1)
    np.testing.assert_allclose(got_z, want_z, rtol=0, atol=ATOL)
    for name, g, w in zip("YIVDN", got, want):
        assert g.shape == w.shape, name
        if name == "V":
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("overrides", [{}, {"decoder_input_composer": True}], ids=["default", "composer_input"])
def test_style_transfer_song_matches_jax(tmp_path, overrides):
    cfg = small_test_config(**overrides)
    params = JaxVAE(cfg).init_params(jax.random.PRNGKey(2))
    song = load_rolls_from_path(write_songs(str(tmp_path), 1)[0], cfg)
    assert song is not None and song.X.shape[0] >= 2
    port = GenerationContext(cfg, MidiVAE(cfg, jax.tree_util.tree_map(np.asarray, params)), "cpu")
    assert_same_transfer(cfg, jax_context(cfg, params), port, song)


def test_encode_song_and_decode_batch_match_jax(tmp_path):
    cfg = small_test_config()
    params = JaxVAE(cfg).init_params(jax.random.PRNGKey(6))
    song = load_rolls_from_path(write_songs(str(tmp_path), 1, seed=5)[0], cfg)
    jctx = jax_context(cfg, params)
    port = GenerationContext(cfg, MidiVAE(cfg, jax.tree_util.tree_map(np.asarray, params)), "cpu")
    z = port.encode_song(song.X, song.I, song.V, song.D)
    np.testing.assert_allclose(z, jctx.encode_song(song.X, song.I, song.V, song.D), rtol=0, atol=ATOL)
    want, got = jctx.decode_batch(z, history=z), port.decode_batch(z, history=z)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)
    for g, w in zip(port.decode_and_process(z, history=z), jctx.decode_and_process(z, history=z)):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_cli_writes_readable_midi(tmp_path):
    cfg = small_test_config()
    run = str(tmp_path / "run")
    port_ckpt.save_run(run, cfg, MidiVAE(cfg).init_params(np.array([0, 4], np.uint32)))
    inputs = write_songs(str(tmp_path / "corpus"), 2, seed=1)
    out = str(tmp_path / "out")
    rc = transfer_cli.main(["--model", run, "--input", *inputs, "--to-class", "style2",
                            "--output", out, "--device", "cpu", "--write-reconstruction"])
    assert rc == 0
    written = sorted(os.listdir(out))
    assert written == ["song0_reconstruction.mid", "song0_style1_to_style2.mid",
                       "song1_reconstruction.mid", "song1_style1_to_style2.mid"]
    for name in written:
        mid = smf.read_midi(os.path.join(out, name))
        assert mid.instruments


def test_cli_cuda_without_a_card_is_an_error(tmp_path, monkeypatch):
    import torch

    cfg = small_test_config()
    run = str(tmp_path / "run")
    port_ckpt.save_run(run, cfg, MidiVAE(cfg).init_params(np.array([0, 4], np.uint32)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        transfer_cli.main(["--model", run, "--input", "a.mid", "--to-class", "style2",
                           "--output", str(tmp_path / "out")])


def test_cli_refuses_unported_options(tmp_path):
    # --classifiers is ported (tests/test_torch_judges.py); bundles are not
    with pytest.raises(SystemExit, match="not yet ported"):
        transfer_cli.main(["--model", "m", "--bundle", "x", "--input", "a.mid",
                           "--to-class", "1", "--output", str(tmp_path)])


def test_transfer_runs_without_jax(tmp_path):
    """The port trains (the train CLI, also the wide model at lstm_size=512,
    whose training step takes the wide route) and serves in a process that
    never imports jax. The child runs torch on one intra-op thread: beside
    the suite's other workers (pytest -n 6 on 8 cores) its default of one
    thread a core oversubscribed the machine and ran past the timeout."""
    code = (
        "import sys, os, numpy as np\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tools')!r})\n"
        "import make_demo_corpus as corpus\n"
        "from midi_vae_tpu.config import small_test_config\n"
        "from midi_vae_tpu.data.tensorize import load_rolls_from_path\n"
        "from midi_vae_tpu_torch.cli import train as train_cli\n"
        "from midi_vae_tpu_torch.evaluation.generation import GenerationContext\n"
        "from midi_vae_tpu_torch.models.vae import MidiVAE\n"
        "from midi_vae_tpu_torch.training import checkpoint as ckpt\n"
        "os.makedirs('c/style2')\n"
        "corpus.make_song(corpus.STYLES['style2'], np.random.RandomState(0), bars=6).write('c/style2/s.mid')\n"
        "small = ['--set', 'bars_input_length=2', '--set', 'bars_output_length=2', '--set', 'lstm_size=16',"
        " '--set', 'latent_dim=16', '--set', 'max_voices=2', '--set', 'batch_size=64']\n"
        "assert train_cli.main(['--source', 'c', '--output', 'run', '--epochs', '1', '--device', 'cpu', *small]) == 0\n"
        "assert train_cli.main(['--source', 'c', '--output', 'wide', '--epochs', '1', '--device', 'cpu', *small,"
        " '--set', 'lstm_size=512']) == 0\n"
        "from midi_vae_tpu_torch.ops import _layout\n"
        "assert _layout.config_route(ckpt.load_config('wide'), on_card=False) == 'wide'\n"
        "assert ckpt.load_params('wide')['encoder']['notes_rnn'][1]['u'].shape == (512, 1536)\n"
        "cfg = ckpt.load_config('run')\n"
        "song = load_rolls_from_path('c/style2/s.mid', cfg)\n"
        "ctx = GenerationContext(cfg, MidiVAE(cfg, ckpt.load_params('run')), 'cpu')\n"
        "(Y, I, V, D, N), z = ctx.style_transfer_song(song.X, song.I, song.V, song.D, C=1, C_switch=0)\n"
        "assert Y.shape == (song.X.shape[0] * cfg.output_length, cfg.new_num_notes)\n"
        "assert np.isfinite(z).all() and np.isfinite(V).all()\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")


def test_converted_jax_run_serves_like_jax(tmp_path):
    from midi_vae_tpu.training import checkpoint as jax_ckpt
    from midi_vae_tpu.training.trainer import make_optimizer

    cfg = small_test_config()
    params = JaxVAE(cfg).init_params(jax.random.PRNGKey(11))
    run, out = str(tmp_path / "jax_run"), str(tmp_path / "port_run")
    jax_ckpt.save_checkpoint(run, 3, params, make_optimizer(cfg).init(params),
                             jax.random.PRNGKey(0), cfg)
    assert tools_module("jax_run_to_torch").main([run, out]) == 0

    # the port's Config is a copy of the JAX one: field-equal, not the same class
    assert port_ckpt.load_config(out).to_dict() == cfg.to_dict()
    got = bridge.flatten(port_ckpt.load_params(out))
    want = bridge.flatten(jax.tree_util.tree_map(np.asarray, params))
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)

    restored = jax_ckpt.restore_vae_state(run)["params"]
    song = load_rolls_from_path(write_songs(str(tmp_path), 1, seed=3)[0], cfg)
    port = GenerationContext(cfg, MidiVAE(cfg, port_ckpt.load_params(out)), "cpu")
    assert_same_transfer(cfg, jax_context(cfg, restored), port, song)


def test_cli_epoch_serves_that_checkpoint(tmp_path):
    """``--epoch N`` serves ``epoch_N/``'s params (``restore_checkpoint``),
    the default the run's ``params.npz``: a run whose epoch 0 holds one
    model and whose ``params.npz`` another transfers a song as a run of
    each model alone does."""
    import torch

    cfg = small_test_config()
    early = MidiVAE(cfg).init_params(np.array([0, 4], np.uint32))
    late = MidiVAE(cfg).init_params(np.array([0, 9], np.uint32))
    run = str(tmp_path / "run")
    port_ckpt.save_checkpoint(run, 0, early, {}, torch.Generator(), cfg)
    port_ckpt.save_run(run, cfg, late)
    refs = {}
    for tag, params in (("early", early), ("late", late)):
        refs[tag] = str(tmp_path / f"ref_{tag}")
        port_ckpt.save_run(refs[tag], cfg, params)
    song = write_songs(str(tmp_path / "corpus"), 1, seed=2)[0]

    def transfer(model, out, *extra):
        out = str(tmp_path / out)
        assert transfer_cli.main(["--model", model, "--input", song, "--to-class", "style2",
                                  "--output", out, "--device", "cpu", *extra]) == 0
        with open(os.path.join(out, "song0_style1_to_style2.mid"), "rb") as f:
            return f.read()

    assert transfer(run, "epoch0", "--epoch", "0") == transfer(refs["early"], "want_early")
    assert transfer(run, "latest") == transfer(refs["late"], "want_late")
    assert transfer(refs["early"], "early_again") != transfer(refs["late"], "late_again")
