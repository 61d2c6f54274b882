"""CPU parity of the port's generation (``midi_vae_tpu_torch/evaluation/
generation.py``, ``midi_vae_tpu_torch/cli/generate.py``) against the JAX
package's.

The JAX side runs its Pallas kernels in interpret mode (``MidiVAE._interpret
= True``) on the same numpy parameters (``small_test_config``, bit-equal
init from one key), the port its kernels' plain versions on CPU tensors.

- ``decode_batch``'s probabilities of every head at bucket sizes 1 to 16,
  with and without history and additional input: atol 1e-5.
- Each song generator (random, with the composer knob, interpolation,
  medley, long) and ``decode_and_process`` in argmax mode: the rolls Y, I, D
  equal, V within atol 1e-5 (a float output of the velocity head).
- ``choice`` mode (random, interpolate, long, ``decode_and_process``): the
  same ``RandomState`` seed on both sides and the rolls equal; where a draw
  differs, the test shows that the uniform it consumed sits within 1e-5 of
  a cumulative boundary of the JAX probabilities (the port's differ from
  them by about 1e-6), and prints the margin.
- The helpers (``linear_interpolation``, ``slerp``, ``prepare_for_drawing``,
  ``restructure_song_to_fit_more_instruments``): equal.
- ``cli.generate --device cpu`` in each mode against the JAX CLI (``--cpu``
  on a JAX run, converted with ``tools/jax_run_to_torch.py``) in argmax
  mode: the same MIDI notes; ``--device cuda`` without a card is an error.
"""

import io
import os
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import threadpoolctl
import torch

from conftest import tools_module
from midi_vae_tpu.cli import generate as jax_generate_cli
from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.evaluation import generation as jax_gen
from midi_vae_tpu.models.vae import MidiVAE as JaxVAE
from midi_vae_tpu_torch.cli import generate as generate_cli
from midi_vae_tpu_torch.config import Config as PortConfig
from midi_vae_tpu_torch.data import smf
from midi_vae_tpu_torch.evaluation import generation as port_gen
from midi_vae_tpu_torch.models.vae import MidiVAE
from midi_vae_tpu_torch.training import checkpoint as port_ckpt

ATOL = 1e-5
NEAR_TIE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products: one torch thread and one BLAS thread, so that beside
    the suite's other busy workers its threads do not wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX context in interpret mode, port context on the CPU) on one
    set of parameters."""
    cfg = small_test_config()
    params = JaxVAE(cfg).init_params(jax.random.PRNGKey(0))
    jm = JaxVAE(cfg)
    jm._interpret = True
    port_cfg = PortConfig(**cfg.to_dict())
    port = port_gen.GenerationContext(
        port_cfg, MidiVAE(port_cfg, jax.tree_util.tree_map(np.asarray, params)), "cpu")
    return cfg, jax_gen.GenerationContext(cfg, jm, params), port


@pytest.fixture(scope="module")
def song_windows(pair):
    """Three songs' windows (X, I, V, D), numpy-random one-hot notes."""
    cfg = pair[0]
    rng = np.random.RandomState(3)
    songs = []
    for n in (3, 5, 2):
        X = np.eye(cfg.input_dim, dtype=np.float32)[rng.randint(0, cfg.input_dim, (n, cfg.input_length))]
        I = np.eye(cfg.instrument_dim, dtype=np.float32)[rng.randint(0, cfg.instrument_dim, cfg.max_voices)]
        V = (rng.rand(n, cfg.output_length) > 0.5).astype(np.float32)
        D = (rng.rand(n, cfg.output_length) > 0.5).astype(np.float32)
        songs.append({"X": X, "I": I, "V": V, "D": D})
    return songs


class Recorder(np.random.RandomState):
    """A RandomState that records each weighted draw of ``choice``: its
    probabilities, the uniform it consumed and the index it drew."""

    def __init__(self, seed):
        super().__init__(seed)
        self.draws = []

    def choice(self, a, size=None, replace=True, p=None):
        if p is None or size is not None:
            return super().choice(a, size, replace, p)
        probe = np.random.RandomState()
        probe.set_state(self.get_state())
        u = probe.random_sample()
        idx = super().choice(a, size, replace, p)
        self.draws.append((np.asarray(p, np.float64), u, int(idx)))
        return idx


def assert_rolls_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, dict):
            assert g == w
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, i
        if i == 2:  # V: the velocity head's float output
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"output {i}")


def assert_choice_matches(run, seed):
    """``run(ctx, rng)`` on both sides with ``Recorder(seed)``: the rolls
    equal, or the first draw that differs is a near-tie of the JAX
    probabilities."""
    jr, pr = Recorder(seed), Recorder(seed)
    want, got = run("jax", jr), run("port", pr)
    assert jr.draws, "no weighted draw was made"
    try:
        assert_rolls_equal(got, want)
        return
    except AssertionError:
        pass
    for k, ((pj, uj, ij), (_, up, ip)) in enumerate(zip(jr.draws, pr.draws)):
        if ij != ip:
            break
    else:
        raise AssertionError("the rolls differ though every draw agrees")
    assert uj == up  # the same stream up to the flip
    cdf = np.cumsum(pj)
    cdf /= cdf[-1]
    margin = float(np.min(np.abs(cdf - uj)))
    print(f"draw {k} of {len(jr.draws)}: JAX {ij}, port {ip}; uniform {uj!r} within "
          f"{margin:.3e} of a cumulative boundary")
    assert margin <= NEAR_TIE


@pytest.mark.parametrize("n", [1, 3, 5, 9, 16])
def test_decode_batch_probs_match(pair, n):
    cfg, jctx, port = pair
    rng = np.random.RandomState(n)
    z = rng.randn(n, cfg.latent_dim).astype(np.float32)
    H = rng.randn(n, cfg.latent_dim).astype(np.float32) if n % 2 else None
    want, got = jctx.decode_batch(z, history=H), port.decode_batch(z, history=H)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("independent", [False, True])
@pytest.mark.parametrize("method", ["argmax", "choice"])
def test_decode_and_process(pair, method, independent):
    cfg, jctx, port = pair
    z = np.random.RandomState(5).randn(3, cfg.latent_dim).astype(np.float32)

    def run(side, rng):
        ctx = jctx if side == "jax" else port
        return ctx.decode_and_process(z, history=z, sample_method=method, rng=rng,
                                      independent_windows=independent)

    if method == "argmax":
        assert_rolls_equal(run("port", None), run("jax", None))
    else:
        assert_choice_matches(run, seed=21)


@pytest.mark.parametrize("style_class", [None, 0, 1])
@pytest.mark.parametrize("method", ["argmax", "choice"])
def test_generate_random_song(pair, method, style_class):
    cfg, jctx, port = pair

    def run(side, rng):
        gen, ctx = (jax_gen, jctx) if side == "jax" else (port_gen, port)
        return gen.generate_random_song(ctx, 0.5, rng, method, style_class=style_class)

    if method == "argmax":
        assert_rolls_equal(run("port", np.random.RandomState(4)), run("jax", np.random.RandomState(4)))
    else:
        assert_choice_matches(run, seed=4)


def test_generate_random_song_shared_z(pair):
    cfg, jctx, port = pair
    z = np.random.RandomState(9).normal(0.0, 0.3, (1, cfg.latent_dim)).astype(np.float32)
    for C in range(cfg.num_classes):
        want = jax_gen.generate_random_song(jctx, 0.3, np.random.RandomState(1), "argmax", C, z)
        got = port_gen.generate_random_song(port, 0.3, np.random.RandomState(1), "argmax", C, z)
        assert_rolls_equal(got, want)


@pytest.mark.parametrize("method", ["argmax", "choice"])
def test_generate_interpolation_song(pair, method):
    cfg, jctx, port = pair
    rng = np.random.RandomState(6)
    z_a, z_b = (rng.normal(0, 0.5, cfg.latent_dim).astype(np.float32) for _ in range(2))

    def run(side, rng):
        gen, ctx = (jax_gen, jctx) if side == "jax" else (port_gen, port)
        return gen.generate_interpolation_song(ctx, z_a, z_b, 4, method, rng)

    if method == "argmax":
        assert_rolls_equal(run("port", None), run("jax", None))
    else:
        assert_choice_matches(run, seed=6)


def test_generate_medley(pair, song_windows):
    cfg, jctx, port = pair
    want = jax_gen.generate_medley(jctx, song_windows, 2, 3, rng=np.random.RandomState(8))
    got = port_gen.generate_medley(port, song_windows, 2, 3, rng=np.random.RandomState(8))
    assert_rolls_equal(got, want)
    assert len(got[1]) == 2 * 2 + 3 + 3 + 2  # bridges and the windows taken per song


@pytest.mark.parametrize("method", ["argmax", "choice"])
def test_generate_long_song(pair, song_windows, method):
    cfg, jctx, port = pair
    all_z = np.concatenate([port.encode_song(s["X"], s["I"], s["V"], s["D"]) for s in song_windows])
    np.testing.assert_allclose(
        all_z, np.concatenate([jctx.encode_song(s["X"], s["I"], s["V"], s["D"]) for s in song_windows]),
        rtol=0, atol=ATOL)

    def run(side, rng):
        gen, ctx = (jax_gen, jctx) if side == "jax" else (port_gen, port)
        return gen.generate_long_song(ctx, all_z, 0.2, 4, rng, method)

    if method == "argmax":
        assert_rolls_equal(run("port", np.random.RandomState(2)), run("jax", np.random.RandomState(2)))
    else:
        assert_choice_matches(run, seed=2)


def test_latent_helpers():
    rng = np.random.RandomState(0)
    a, b = rng.randn(8), rng.randn(8)
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(port_gen.linear_interpolation(a, b, t),
                                      jax_gen.linear_interpolation(a, b, t))
        np.testing.assert_array_equal(port_gen.slerp(a, b, t), jax_gen.slerp(a, b, t))
        np.testing.assert_array_equal(port_gen.slerp(a, 2 * a, t), jax_gen.slerp(a, 2 * a, t))


@pytest.mark.parametrize("with_velocity", [False, True])
def test_prepare_for_drawing_and_restructure(pair, with_velocity):
    cfg = pair[0]
    port_cfg = PortConfig(**cfg.to_dict())
    rng = np.random.RandomState(1)
    n = 3
    Y = np.zeros((n * cfg.output_length, cfg.new_num_notes), np.float32)
    Y[np.arange(len(Y)), rng.randint(0, cfg.new_num_notes, len(Y))] = rng.rand(len(Y)) > 0.3
    V = rng.rand(len(Y))
    D = (rng.rand(len(Y)) > 0.5).astype(np.float64)
    np.testing.assert_array_equal(
        port_gen.prepare_for_drawing(Y, port_cfg, V if with_velocity else None),
        jax_gen.prepare_for_drawing(Y, cfg, V if with_velocity else None))
    I_list = np.eye(cfg.instrument_dim, dtype=np.float32)[rng.randint(0, cfg.instrument_dim,
                                                                      (n, cfg.max_voices))]
    got = port_gen.restructure_song_to_fit_more_instruments(Y, I_list, V, D, port_cfg)
    want = jax_gen.restructure_song_to_fit_more_instruments(Y, I_list, V, D, cfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A JAX run (an orbax checkpoint), its port conversion, and a
    two-style corpus."""
    from midi_vae_tpu.training import checkpoint as jax_ckpt
    from midi_vae_tpu.training.trainer import make_optimizer
    from midi_vae_tpu_torch.tools import make_demo_corpus as corpus

    root = tmp_path_factory.mktemp("generate_cli")
    cfg = small_test_config(sample_method="argmax")
    params = JaxVAE(cfg).init_params(jax.random.PRNGKey(7))
    jax_run, port_run = str(root / "jax_run"), str(root / "port_run")
    jax_ckpt.save_checkpoint(jax_run, 1, params, make_optimizer(cfg).init(params),
                             jax.random.PRNGKey(0), cfg)
    assert tools_module("jax_run_to_torch").main([jax_run, port_run]) == 0
    source = root / "corpus"
    rng = np.random.RandomState(5)
    for style in ("style1", "style2"):
        os.makedirs(source / style)
        for i in range(3):
            corpus.make_song(corpus.STYLES[style], rng, bars=6).write(str(source / style / f"{i}.mid"))
    return root, jax_run, port_run, str(source)


def midi_notes(path):
    mid = smf.read_midi(path)
    return [(inst.program, [(n.pitch, round(n.start, 6), round(n.end, 6), n.velocity)
                            for n in inst.notes]) for inst in mid.instruments]


def assert_same_midi(got_path, want_path):
    got, want = midi_notes(got_path), midi_notes(want_path)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert [x[:3] for x in g] == [x[:3] for x in w]
        # a velocity is V's int rounding: V agrees to 1e-5
        assert all(abs(a[3] - b[3]) <= 1 for a, b in zip(g, w))


@pytest.mark.parametrize("mode", ["random", "style", "interpolate", "long"])
def test_cli_matches_jax_cli(runs, mode):
    root, jax_run, port_run, source = runs
    common = ["--mode", mode, "--count", "2", "--length", "3", "--source", source, "--seed", "3"]
    jax_out, port_out = str(root / f"jax_{mode}"), str(root / f"port_{mode}")
    with redirect_stdout(io.StringIO()):
        assert jax_generate_cli.main(["--model", jax_run, "--output", jax_out, "--cpu", *common]) == 0
        assert generate_cli.main(["--model", port_run, "--output", port_out, "--device", "cpu",
                                  *common]) == 0
    names = sorted(os.listdir(jax_out))
    assert names and sorted(os.listdir(port_out)) == names
    for name in names:
        assert_same_midi(os.path.join(port_out, name), os.path.join(jax_out, name))


def test_cli_choice_writes_readable_midi(runs):
    root, _, port_run, _ = runs
    out = str(root / "choice")
    with redirect_stdout(io.StringIO()):
        assert generate_cli.main(["--model", port_run, "--output", out, "--device", "cpu",
                                  "--sample-method", "choice", "--temperature", "0.7",
                                  "--count", "2"]) == 0
    assert sorted(os.listdir(out)) == ["random_0.mid", "random_1.mid"]
    for name in os.listdir(out):
        smf.read_midi(os.path.join(out, name))  # parses; a seeded init may play no note


def test_cli_epoch_serves_that_checkpoint(runs, tmp_path):
    """``--epoch N`` takes ``epoch_N/``'s params (restore_checkpoint)."""
    _, _, port_run, _ = runs
    cfg = port_ckpt.load_config(port_run)
    params = port_ckpt.load_params(port_run)
    run = str(tmp_path / "run")
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    port_ckpt.save_checkpoint(run, 0, params, {}, torch.Generator(), cfg)
    port_ckpt.save_run(run, cfg, zeros)  # the run's params.npz: another model
    outs = {}
    for tag, extra in (("epoch0", ["--epoch", "0"]), ("latest", [])):
        outs[tag] = str(tmp_path / tag)
        with redirect_stdout(io.StringIO()):
            assert generate_cli.main(["--model", run, "--output", outs[tag], "--device", "cpu",
                                      "--count", "1", "--z-std", "0.5", *extra]) == 0
    ref = str(tmp_path / "ref")
    with redirect_stdout(io.StringIO()):
        assert generate_cli.main(["--model", port_run, "--output", ref, "--device", "cpu",
                                  "--count", "1", "--z-std", "0.5"]) == 0
    assert_same_midi(os.path.join(outs["epoch0"], "random_0.mid"), os.path.join(ref, "random_0.mid"))
    assert midi_notes(os.path.join(outs["latest"], "random_0.mid")) != midi_notes(
        os.path.join(ref, "random_0.mid"))


def test_cli_cuda_without_a_card_is_an_error(runs, monkeypatch):
    _, _, port_run, _ = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        generate_cli.main(["--model", port_run, "--output", "unused"])
