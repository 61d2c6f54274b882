"""The port stands alone: it imports neither jax nor anything of the JAX
package, and its own copies of the JAX package's numpy-only layers
(``config.py``, ``data/``) agree with the originals bit for bit.

- A subprocess imports every module under ``midi_vae_tpu_torch``
  (``pkgutil.walk_packages``), ``chip_smoke.py`` and
  ``tools/profile_transfer_torch.py`` behind a ``sys.meta_path`` finder that
  refuses ``jax`` and ``midi_vae_tpu``; neither may be in ``sys.modules``.
  It then walks every ``import`` statement of the two scripts, of
  ``midi_vae_tpu_torch/serving.py`` and of
  ``midi_vae_tpu_torch/tools/export_serving.py`` with ``ast``, at top level
  and inside function bodies (the imports a phase or a bundle's loader
  makes when it runs; relative ones resolved in their package), and
  imports each module behind the same finder, with the repo's ``tools/`` on
  ``sys.path`` as the scripts put it there.
- ``midi_vae_tpu_torch/tools/make_demo_corpus.py`` writes the same bytes as
  ``tools/make_demo_corpus.py`` for the same seed and options.
- The port's ``Config`` against the JAX one: every field and every derived
  property, for the default, ``small_test_config``, each ``configs/*.json``
  and a few ``--set`` strings.
- Tensorization: songs authored with the port's ``smf`` give bit-equal
  X, I, V, D, Y through both packages' ``load_rolls_from_path`` (the JAX one
  may parse with its native C++ fast path), and a tiny two-class corpus the
  same splits through both ``import_midi_from_folder``.
"""

import dataclasses
import filecmp
import glob
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import tools_module
from midi_vae_tpu import config as jax_config
from midi_vae_tpu.data import dataset as jax_dataset
from midi_vae_tpu.data import tensorize as jax_tensorize
from midi_vae_tpu_torch import config as port_config
from midi_vae_tpu_torch.data import dataset as port_dataset
from midi_vae_tpu_torch.data import smf as port_smf
from midi_vae_tpu_torch.data import tensorize as port_tensorize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = f"""
import importlib, importlib.abc, importlib.util, pkgutil, sys
sys.path.insert(0, {REPO!r})
sys.path.insert(0, {os.path.join(REPO, 'tools')!r})

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'midi_vae_tpu'):
            raise ImportError(f'the port imported {{name}}')
        return None

sys.meta_path.insert(0, Refuse())
import midi_vae_tpu_torch
names = ['midi_vae_tpu_torch']
for info in pkgutil.walk_packages(midi_vae_tpu_torch.__path__, 'midi_vae_tpu_torch.'):
    importlib.import_module(info.name)
    names.append(info.name)
scripts = (('chip_smoke', {os.path.join(REPO, 'chip_smoke.py')!r}),
           ('profile_transfer_torch', {os.path.join(REPO, 'tools', 'profile_transfer_torch.py')!r}))
for name, path in scripts:
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(name)
import ast
walked = set()
port = {os.path.join(REPO, 'midi_vae_tpu_torch')!r}
modules = (({os.path.join(REPO, 'chip_smoke.py')!r}, None),
           ({os.path.join(REPO, 'tools', 'profile_transfer_torch.py')!r}, None),
           (port + '/serving.py', 'midi_vae_tpu_torch'),
           (port + '/tools/export_serving.py', 'midi_vae_tpu_torch.tools'))
for path, package in modules:
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                importlib.import_module(alias.name)
                walked.add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0 or package, (path, node.module)
            name = importlib.util.resolve_name('.' * node.level + (node.module or ''), package)
            module = importlib.import_module(name)
            walked.add(name)
            for alias in node.names:
                if alias.name != '*' and not hasattr(module, alias.name):
                    importlib.import_module(name + '.' + alias.name)
                    walked.add(name + '.' + alias.name)
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'midi_vae_tpu'))
assert not bad, bad
print(len(walked), 'imports walked')
print(len(names), 'modules')
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    count = int(res.stdout.split()[-2])
    assert count >= 30  # every module of the package, the two scripts
    walked = int(res.stdout.splitlines()[-2].split()[0])
    assert walked >= 20  # the walked files' imports, top level and lazy


def _config_view(cfg) -> dict:
    props = sorted(n for n, v in inspect.getmembers(type(cfg)) if isinstance(v, property))
    return {"fields": dataclasses.asdict(cfg), **{p: getattr(cfg, p) for p in props}}


CONFIG_CASES = {
    "default": lambda m: m.Config(),
    "small_test_config": lambda m: m.small_test_config(),
    "small_lstm": lambda m: m.small_test_config(cell_type="LSTM", meta_held_notes=True),
    "set_strings": lambda m: m.Config(**m.parse_overrides(
        ["lstm_size=512", "cell_type=LSTM", "classes=('Jazz','Pop','Rock')",
         "compute_dtype=bfloat16", "decoder_input_composer=True",
         "append_signature_vector_to_latent=True", "beta=0.25"])),
}
CONFIG_CASES.update({
    f"json_{os.path.basename(p)}": (lambda path: lambda m: m.Config.load(path))(p)
    for p in sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))
})


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_port_config_equals_jax_config(case):
    make = CONFIG_CASES[case]
    port, ref = make(port_config), make(jax_config)
    assert type(port).__module__ == "midi_vae_tpu_torch.config"
    assert _config_view(port) == _config_view(ref)
    assert port.to_dict() == ref.to_dict()
    # each loads the other's JSON into an equal config
    assert port_config.Config.from_dict(ref.to_dict()) == port


def test_parse_overrides_refuses_what_the_jax_one_refuses():
    for bad in (["lstm_size"], ["no_such_field=1"]):
        for module in (port_config, jax_config):
            with pytest.raises(SystemExit):
                module.parse_overrides(bad)


def _author_songs(folder, n, seed):
    """n small songs written with the port's smf: two instruments, notes on
    and off the grid, two tempi."""
    rng = np.random.RandomState(seed)
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i in range(n):
        mid = port_smf.MidiFile(resolution=220)
        mid.set_tempo_changes([0.0, 4.0], [float(rng.choice([96, 120])), 100.0])
        for program in (0, 33):
            inst = port_smf.Instrument(program=program)
            t = 0.0
            while t < 12.0:
                dur = float(rng.choice([0.125, 0.25, 0.5, 0.37]))
                inst.notes.append(port_smf.Note(int(rng.randint(40, 80)), int(rng.randint(40, 127)),
                                                t, t + dur))
                t += dur + float(rng.choice([0.0, 0.125]))
            mid.instruments.append(inst)
        paths.append(os.path.join(folder, f"song{i}.mid"))
        mid.write(paths[-1])
    return paths


@pytest.mark.parametrize("cell", ["default", "small"])
def test_tensorization_is_bit_equal(tmp_path, cell):
    make = CONFIG_CASES["default" if cell == "default" else "small_test_config"]
    cfg_port, cfg_jax = make(port_config), make(jax_config)
    paths = _author_songs(str(tmp_path), 3, seed=len(cell))
    for path in paths:
        got = port_tensorize.load_rolls_from_path(path, cfg_port)
        want = jax_tensorize.load_rolls_from_path(path, cfg_jax)
        assert got is not None and want is not None, path
        for name in ("X", "I", "V", "D", "Y"):
            g, w = getattr(got, name), getattr(want, name)
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert np.array_equal(g, w), name
        assert got.tempo == want.tempo


def test_corpus_import_gives_the_same_splits(tmp_path):
    corpus = tools_module("make_demo_corpus")
    rng = np.random.RandomState(0)
    for style in ("style1", "style2"):
        os.makedirs(tmp_path / style)
        for i in range(6):
            corpus.make_song(corpus.STYLES[style], rng, bars=4).write(
                str(tmp_path / style / f"{style}_{i}.mid"))
    cfg = {"bars_input_length": 4, "bars_output_length": 4, "max_voices": 2}
    got = port_dataset.import_midi_from_folder(str(tmp_path), port_config.Config(**cfg))
    want = jax_dataset.import_midi_from_folder(str(tmp_path), jax_config.Config(**cfg))
    assert got.train_paths == want.train_paths and got.test_paths == want.test_paths
    assert got.C_train == want.C_train and got.C_test == want.C_test
    for name in ("X_train", "Y_train", "V_test", "D_test", "I_train"):
        assert all(np.array_equal(a, b) for a, b in zip(getattr(got, name), getattr(want, name)))


@pytest.mark.parametrize("options", [[], ["--styles", "3"], ["--chords"], ["--hard", "--seed", "4"]],
                         ids=["two_styles", "three_styles", "chords", "hard"])
def test_corpus_twin_writes_the_same_bytes(tmp_path, options):
    from midi_vae_tpu_torch.tools import make_demo_corpus as twin

    jax_tool = tools_module("make_demo_corpus")
    args = ["--songs-per-style", "3", *options]
    assert jax_tool.main([str(tmp_path / "jax"), *args]) == 0
    assert twin.main([str(tmp_path / "port"), *args]) == 0
    files = sorted(os.path.relpath(p, tmp_path / "jax")
                   for p in glob.glob(str(tmp_path / "jax" / "*" / "*.mid")))
    assert len(files) == 3 * (3 if "3" in options else 2)
    assert sorted(os.path.relpath(p, tmp_path / "port")
                  for p in glob.glob(str(tmp_path / "port" / "*" / "*.mid"))) == files
    for name in files:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name, shallow=False), name
