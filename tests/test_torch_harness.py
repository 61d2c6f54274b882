"""CPU parity of the port's evaluation harness (``midi_vae_tpu_torch/
evaluation/harness.py`` with ``stats``, ``sweep`` and ``probes``, and
``midi_vae_tpu_torch/cli/evaluate.py``) against the JAX package's.

- Every one of the eleven sections, in argmax mode, on one model and one
  dataset built as ``tests/test_evaluation.py`` builds it (synthetic songs,
  ``small_test_config``), with judges of all three kinds: the JAX
  ``Evaluator`` (its plain path on the CPU, as the JAX package's own
  harness tests run it) and the port's (``device="cpu"``: the kernels'
  plain versions) write the same artifacts. Numbers of ``results.json``,
  the CSV and the saved latents agree within 1e-5 (absolute and relative;
  counts, names and best dimensions equal), every MIDI file holds the same
  notes (a velocity is the int rounding of V, which agrees to 1e-5: within
  1). matplotlib is blocked in both runs, as on the card's machine: every
  plot fails inside ``_plot_safely`` and the run goes on.
- ``cli.evaluate --device cpu`` against the JAX CLI (``--cpu``, a JAX run and
  JAX judges converted with ``tools/jax_run_to_torch.py``) on an authored
  corpus; the port's CLI over all eleven sections, its plots where
  matplotlib is installed; ``--device cuda`` without a card is an error.
- The embeddings of the chord and pitch probes: ``embed_2d`` against the
  JAX package's; made inside the plot callbacks, so that without
  scikit-learn (as on the card's machine) those plots fail and the chords
  and pitches sections still write their latents.
"""

import csv
import io
import json
import os
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import threadpoolctl
import torch

from conftest import tools_module
from midi_vae_tpu.cli import evaluate as jax_evaluate_cli
from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.data.dataset import Dataset as JaxDataset
from midi_vae_tpu.evaluation import EvalSections as JaxSections
from midi_vae_tpu.evaluation import Evaluator as JaxEvaluator
from midi_vae_tpu.models import classifier as jax_clf
from midi_vae_tpu.models.vae import MidiVAE as JaxVAE
from midi_vae_tpu_torch.cli import evaluate as evaluate_cli
from midi_vae_tpu_torch.config import Config as PortConfig
from midi_vae_tpu_torch.data import smf
from midi_vae_tpu_torch.data.dataset import Dataset as PortDataset
from midi_vae_tpu_torch.evaluation import EvalSections, Evaluator, probes
from midi_vae_tpu_torch.models import classifier as port_clf

TOL = 1e-5
KINDS = ("pitch", "velocity", "instrument")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products: one torch thread and one BLAS thread, so that beside
    the suite's other busy workers its threads do not wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def assert_close(got, want, where=""):
    """JSON-like trees: the same keys and lengths, strings, bools, ints and
    None equal, floats within TOL (absolute and relative)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            assert_close(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and isinstance(got, (int, float)):
        assert abs(got - want) <= TOL + TOL * abs(want), f"{where}: {got!r} vs {want!r}"
    else:
        assert got == want, f"{where}: {got!r} vs {want!r}"


def midi_notes(path):
    mid = smf.read_midi(path)
    return [(inst.program, [(n.pitch, round(n.start, 6), round(n.end, 6), n.velocity)
                            for n in inst.notes]) for inst in mid.instruments]


def assert_same_midi(got_path, want_path):
    got, want = midi_notes(got_path), midi_notes(want_path)
    assert [p for p, _ in got] == [p for p, _ in want], got_path
    for (_, g), (_, w) in zip(got, want):
        assert [x[:3] for x in g] == [x[:3] for x in w], got_path
        assert all(abs(a[3] - b[3]) <= 1 for a, b in zip(g, w)), got_path


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))

    def value(cell):
        try:
            return float(cell)
        except ValueError:
            return cell

    return [rows[0]] + [[value(c) for c in row] for row in rows[1:]]


def block_matplotlib(monkeypatch):
    """As on the card's machine: ``import matplotlib`` fails."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def small_dataset(cfg, dataset_cls):
    """Synthetic windows as ``tests/test_evaluation.py::tiny_setup`` builds
    them: 3 train songs, 2 test songs, 3 windows each."""
    from midi_vae_tpu.utils.synthetic import synthetic_flat

    ds = dataset_cls(cfg=cfg)
    for split, n_songs in (("train", 3), ("test", 2)):
        for s in range(n_songs):
            flat = synthetic_flat(cfg, n_songs=1, windows_per_song=3, seed=s)
            getattr(ds, f"X_{split}").append(flat.X)
            getattr(ds, f"Y_{split}").append(flat.Y)
            getattr(ds, f"I_{split}").append(flat.I[0])
            getattr(ds, f"V_{split}").append(flat.V[..., 0])
            getattr(ds, f"D_{split}").append((flat.D[..., 1] > 0).astype(np.float32))
            getattr(ds, f"T_{split}").append(100.0)
            getattr(ds, f"C_{split}").append(s % cfg.num_classes)
            getattr(ds, f"{split}_paths").append(f"/data/{split}_{s}.mid")
    return ds


SECTIONS = dict(
    harmonicity_evaluations=True, frankenstein_harmonicity_evaluations=True,
    frankenstein_evaluations=40, max_new_chosen_interpolation_songs=1, interpolation_length=2,
    how_many_songs_in_one_medley=2, noninterpolated_samples_between_interpolation=2,
    max_new_sampled_interpolation_songs=1, interpolation_song_length=3, latent_sweep=True,
    num_latent_sweep_samples=2, num_latent_sweep_evaluation_songs=1, chord_evaluation=True,
    evaluate_different_sampling_regions=True, pitch_evaluation=True, max_new_sampled_songs=1,
    max_new_sampled_long_songs=1, long_song_length=3, evaluate_autoencoding_and_stuff=True,
)


@pytest.fixture(scope="module")
def harness_runs(tmp_path_factory):
    """Every section through both harnesses: (JAX output dir, port output
    dir, the two results dicts)."""
    root = tmp_path_factory.mktemp("harness")
    cfg = small_test_config(sample_method="argmax")
    port_cfg = PortConfig(**cfg.to_dict())
    params = JaxVAE(cfg).init_params(jax.random.PRNGKey(0))
    jax_judges, port_judges = {}, {}
    for seed, kind in enumerate(KINDS):
        spec = jax_clf.ClassifierSpec.for_kind(kind, cfg, lstm_size=16)
        jm = jax_clf.StyleClassifier(spec)
        jp = jm.init_params(jax.random.PRNGKey(10 + seed))
        jax_judges[kind] = (jm, jp)
        port_judges[kind] = port_clf.StyleClassifier(
            port_clf.ClassifierSpec(**spec.__dict__), jax.tree_util.tree_map(np.asarray, jp))
    out = {"jax": str(root / "jax"), "port": str(root / "port")}
    with pytest.MonkeyPatch.context() as mp, redirect_stdout(io.StringIO()) as log:
        block_matplotlib(mp)
        want = JaxEvaluator(cfg, params, small_dataset(cfg, JaxDataset), out["jax"],
                            classifiers=jax_judges, seed=3).run(JaxSections(**SECTIONS))
        got = Evaluator(port_cfg, jax.tree_util.tree_map(np.asarray, params),
                        small_dataset(port_cfg, PortDataset), out["port"], classifiers=port_judges,
                        seed=3, device="cpu").run(EvalSections(**SECTIONS))
    assert "plot failed" in log.getvalue()
    return out["jax"], out["port"], want, got


# section -> (its keys in results.json, the prefixes of its files)
SECTION_OUTPUTS = {
    "stats": (("dataset_counts", "program_switch_percentage", "z_mean_train", "z_std_train"), ()),
    "harmonicity": (("harmonicity",), ()),
    "medleys": ((), ("medley_",)),
    "random_interpolations": ((), ("random_interpolation_",)),
    "latent_sweep": (("latent_sweep_best_dims", "latent_sweep_best_peaks"), ("sweep_",)),
    "chords": (("chord_latents",), ()),
    "sampling_regions": (("sampling_region_scales", "sampling_region_locs"), ()),
    "pitches": (("pitch_latents",), ()),
    "random_songs": ((), ("random_0.mid", "random_0_")),
    "long_songs": ((), ("random_long_",)),
    "autoencoding": (("harmonicity_autoencoded", "mean_reconstruction_accuracy",
                      "autoencoding_metrics", "switch_matrix", "signature_mahalanobis"),
                     ("test_", "z_test_", "evaluation_metrics.csv")),
}


def _files(folder, prefixes):
    names = []
    for dirpath, _, files in os.walk(folder):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), folder)
            if any(os.path.basename(rel).startswith(p) for p in prefixes):
                names.append(rel)
    return sorted(names)


@pytest.mark.parametrize("section", sorted(SECTION_OUTPUTS))
def test_section_matches_jax(harness_runs, section):
    jax_dir, port_dir, _, _ = harness_runs
    keys, prefixes = SECTION_OUTPUTS[section]
    with open(os.path.join(jax_dir, "results.json")) as f:
        want = json.load(f)
    with open(os.path.join(port_dir, "results.json")) as f:
        got = json.load(f)
    for key in keys:
        assert key in want and key in got, key
        assert_close(got[key], want[key], key)
    names = _files(jax_dir, prefixes)
    assert bool(names) == bool(prefixes)
    assert _files(port_dir, prefixes) == names
    for name in names:
        g, w = os.path.join(port_dir, name), os.path.join(jax_dir, name)
        if name.endswith(".mid"):
            assert_same_midi(g, w)
        elif name.endswith(".csv"):
            assert_close(read_csv(g), read_csv(w), name)
        elif name.endswith(".npy"):
            np.testing.assert_allclose(np.load(g), np.load(w), rtol=TOL, atol=TOL)
        else:
            assert open(g).read() == open(w).read(), name


def test_results_cover_every_section_and_nothing_else(harness_runs):
    _, _, want, got = harness_runs
    assert sorted(got) == sorted(want)
    assert set(got) == {k for keys, _ in SECTION_OUTPUTS.values() for k in keys}
    # the autoencoding rows: one per evaluated song and the mean row, each
    # song with its switch pair's columns
    rows = got["autoencoding_metrics"]
    assert [r["song_name"] for r in rows] == ["test_0", "test_1", "Mean"]
    for row in rows[:-1]:
        C = ["style1", "style2"].index(row["class"])
        assert f"switched_pitch_classifier_accuracy_{C}to{1 - C}" in row


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """A JAX run and JAX judges (orbax checkpoints), their port conversions,
    and a two-style corpus authored with the port's corpus tool."""
    from midi_vae_tpu.training import checkpoint as jax_ckpt
    from midi_vae_tpu.training.classifier_trainer import ClassifierTrainer
    from midi_vae_tpu.training.trainer import make_optimizer
    from midi_vae_tpu_torch.tools import make_demo_corpus as corpus

    root = tmp_path_factory.mktemp("evaluate_cli")
    cfg = small_test_config(sample_method="argmax")
    params = JaxVAE(cfg).init_params(jax.random.PRNGKey(4))
    jax_run, port_run = str(root / "jax_run"), str(root / "port_run")
    jax_ckpt.save_checkpoint(jax_run, 1, params, make_optimizer(cfg).init(params),
                             jax.random.PRNGKey(0), cfg)
    jax_judges, port_judges = str(root / "jax_judges"), str(root / "port_judges")
    for seed, kind in enumerate(KINDS):
        trainer = ClassifierTrainer(jax_clf.ClassifierSpec.for_kind(kind, cfg, lstm_size=16))
        state = trainer.init_state(seed)
        state.epoch = 1
        trainer.save(os.path.join(jax_judges, kind), state)
    convert = tools_module("jax_run_to_torch")
    with redirect_stdout(io.StringIO()):
        assert convert.main([jax_run, port_run]) == 0
        assert convert.main(["--classifiers", jax_judges, port_judges]) == 0
    source = root / "corpus"
    rng = np.random.RandomState(2)
    for style in ("style1", "style2"):
        os.makedirs(source / style)
        for i in range(5):
            corpus.make_song(corpus.STYLES[style], rng, bars=6).write(str(source / style / f"{style}_{i}.mid"))
    return root, jax_run, port_run, jax_judges, port_judges, str(source)


def test_cli_matches_jax_cli(cli_runs):
    root, jax_run, port_run, jax_judges, port_judges, source = cli_runs
    common = ["--source", source, "--sections", "stats,autoencoding,random_songs", "--num-songs", "1",
              "--seed", "5"]
    jax_out, port_out = str(root / "jax_eval"), str(root / "port_eval")
    with redirect_stdout(io.StringIO()):
        assert jax_evaluate_cli.main(["--model", jax_run, "--classifiers", jax_judges,
                                      "--output", jax_out, "--cpu", *common]) == 0
        assert evaluate_cli.main(["--model", port_run, "--classifiers", port_judges,
                                  "--output", port_out, "--device", "cpu", *common]) == 0
    with open(os.path.join(jax_out, "results.json")) as f:
        want = json.load(f)
    with open(os.path.join(port_out, "results.json")) as f:
        got = json.load(f)
    assert_close(got, want)
    assert any("original_pitch_classifier_accuracy" in r for r in got["autoencoding_metrics"])
    assert_close(read_csv(os.path.join(port_out, "evaluation_metrics.csv")),
                 read_csv(os.path.join(jax_out, "evaluation_metrics.csv")))
    mids = sorted(f for f in os.listdir(jax_out) if f.endswith(".mid"))
    assert mids and sorted(f for f in os.listdir(port_out) if f.endswith(".mid")) == mids
    for name in mids:
        assert_same_midi(os.path.join(port_out, name), os.path.join(jax_out, name))


def _finite_or_null(tree):
    if isinstance(tree, dict):
        return all(_finite_or_null(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite_or_null(v) for v in tree)
    return tree is None or not isinstance(tree, float) or np.isfinite(tree)


def test_cli_every_section(cli_runs, monkeypatch):
    root, _, port_run, _, port_judges, source = cli_runs
    out = str(root / "all_sections")
    block_matplotlib(monkeypatch)
    with redirect_stdout(io.StringIO()) as log:
        assert evaluate_cli.main(["--model", port_run, "--classifiers", port_judges, "--source",
                                  source, "--output", out, "--sections", ",".join(evaluate_cli.SECTIONS),
                                  "--num-songs", "1", "--device", "cpu"]) == 0
    assert "plot failed" in log.getvalue()
    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)
    assert set(results) == {k for keys, _ in SECTION_OUTPUTS.values() for k in keys}
    assert _finite_or_null(results)
    for prefix in ("medley_0", "random_interpolation_0", "sweep_", "random_0", "random_long_0"):
        assert any(f.startswith(prefix) for f in os.listdir(out)), prefix
    for dirpath, _, files in os.walk(out):
        for f in files:
            if f.endswith(".mid"):
                smf.read_midi(os.path.join(dirpath, f))


def test_cli_writes_plots_with_matplotlib(cli_runs):
    pytest.importorskip("matplotlib")
    pytest.importorskip("sklearn")
    root, _, port_run, _, _, source = cli_runs
    out = str(root / "plots")
    with redirect_stdout(io.StringIO()):
        assert evaluate_cli.main(["--model", port_run, "--source", source, "--output", out,
                                  "--sections", "chords,pitches", "--device", "cpu"]) == 0
    for name in ("aaa_pca_maj_min_chords.png", "aaa_tsne_maj_min_chords.png",
                 "aaa_pca_pitches.png", "aaa_tsne_octaves.png"):
        assert os.path.exists(os.path.join(out, name)), name


def test_cli_rejects_unknown_sections_and_missing_card(cli_runs, monkeypatch):
    _, _, port_run, _, _, source = cli_runs
    with pytest.raises(SystemExit, match="unknown --sections"):
        evaluate_cli.main(["--model", port_run, "--source", source, "--output", "x",
                           "--sections", "autoencoding,vibes"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with redirect_stdout(io.StringIO()), pytest.raises(RuntimeError, match="cuda"):
        evaluate_cli.main(["--model", port_run, "--source", source, "--output", "x"])


@pytest.mark.parametrize("shape", [(24, 16), (60, 16), (24, 256), (200, 8)])
@pytest.mark.parametrize("n_components", [1, 2])
def test_pca_matches_jax(shape, n_components):
    from midi_vae_tpu.evaluation import probes as jax_probes

    x = np.random.RandomState(shape[0]).randn(*shape)
    np.testing.assert_allclose(probes.embed_2d(x, "pca", n_components),
                               jax_probes.embed_2d(x, "pca", n_components), rtol=0, atol=TOL)


def test_embeddings_skip_without_sklearn(tmp_path, monkeypatch):
    """scikit-learn missing: the four embedding plots fail inside
    ``_plot_safely`` and the chords and pitches sections keep their
    latents."""
    from midi_vae_tpu_torch import bridge
    from midi_vae_tpu_torch.models.vae import MidiVAE

    cfg = PortConfig(**small_test_config(sample_method="argmax").to_dict())
    for name in ("sklearn", "sklearn.decomposition", "sklearn.manifold"):
        monkeypatch.setitem(sys.modules, name, None)
    sections = EvalSections(chord_evaluation=True, pitch_evaluation=True,
                            evaluate_autoencoding_and_stuff=False)
    with redirect_stdout(io.StringIO()) as log:
        results = Evaluator(cfg, bridge.to_tree(MidiVAE(cfg).params), small_dataset(cfg, PortDataset),
                            str(tmp_path), device="cpu").run(sections, log_fn=lambda s: None)
    assert log.getvalue().count("plot failed (_plot_embedding)") == 4
    assert len(results["chord_latents"]["z"]) == len(probes.MAJ_MIN_CHORDS)
    assert len(results["pitch_latents"]["z"]) == cfg.high_crop - cfg.low_crop
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".png")]
