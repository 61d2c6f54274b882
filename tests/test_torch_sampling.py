"""CPU parity of the port's decoder-output sampling
(``midi_vae_tpu_torch/evaluation/sampling.py``) against the JAX package's
(``midi_vae_tpu/evaluation/sampling.py``).

Both sides get the same probability arrays and a ``RandomState`` with the
same seed; every output must be bit-equal: the index each ``sample_vector``
draws (argmax and choice, several temperatures, cutoffs and numbers of
tries), the notes, instrument and held-notes samples, the velocity
override and its reference loop, ``process_decoder_outputs`` over every
head subset with and without ``independent_windows``,
``process_argmax_outputs`` and ``add_silent_column``. The port's module
also reads every ``Config`` field that its JAX twin reads.
"""

import ast
import os

import numpy as np
import pytest
import threadpoolctl
import torch

from midi_vae_tpu.config import Config as JaxConfig
from midi_vae_tpu.evaluation import sampling as jax_sampling
from midi_vae_tpu_torch.config import Config as PortConfig
from midi_vae_tpu_torch.evaluation import sampling as port_sampling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small numpy and torch work: one torch thread and one BLAS thread, so
    that beside the suite's other busy workers its threads do not wait on
    each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def configs(**kw):
    return JaxConfig(**kw), PortConfig(**kw)


def probs(rng, *shape, zeros=0.2):
    """Softmax-like rows with some exact zeros (the draws skip them)."""
    p = np.exp(rng.randn(*shape) * 2.0)
    p *= rng.rand(*shape) > zeros
    return (p / np.maximum(p.sum(-1, keepdims=True), 1e-30)).astype(np.float32)


def assert_same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
        return
    if isinstance(want, (int, np.integer)):
        assert int(got) == int(want)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tries", [1, 3])
@pytest.mark.parametrize("cutoff", [0.0, 0.05])
@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_sample_vector_choice_bit_equal(temperature, cutoff, tries):
    data = np.random.RandomState(7)
    rows = probs(data, 40, 61)
    rows[3] = 0.0  # an empty row draws 0 without touching the generator
    jrng, prng = np.random.RandomState(1), np.random.RandomState(1)
    want = [jax_sampling.sample_vector(r, "choice", temperature, cutoff, tries, jrng) for r in rows]
    got = [port_sampling.sample_vector(r, "choice", temperature, cutoff, tries, prng) for r in rows]
    assert got == want
    assert got[3] == 0
    assert jrng.random_sample() == prng.random_sample()  # the same draws consumed


def test_sample_vector_argmax_and_errors():
    rows = probs(np.random.RandomState(2), 20, 61)
    for r in rows:
        assert port_sampling.sample_vector(r, "argmax") == jax_sampling.sample_vector(r, "argmax")
    assert port_sampling.sample_vector(np.zeros(5), "choice") == 0
    for module in (jax_sampling, port_sampling):
        with pytest.raises(ValueError, match="unknown sample_method"):
            module.sample_vector(rows[0], "top_k")


@pytest.mark.parametrize("silent", [True, False])
@pytest.mark.parametrize("method", ["argmax", "choice"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_sample_notes_prediction(ndim, method, silent):
    jcfg, pcfg = configs(include_silent_note=silent, temperature=0.8, number_of_tries=2,
                         cutoff_sample_threshold=0.01)
    shape = (3, 16, jcfg.output_dim) if ndim == 3 else (24, jcfg.output_dim)
    Y = probs(np.random.RandomState(3), *shape)
    Y.reshape(-1, shape[-1])[5] = 0.0
    want = jax_sampling.sample_notes_prediction(Y, method, jcfg, np.random.RandomState(4))
    got = port_sampling.sample_notes_prediction(Y, method, pcfg, np.random.RandomState(4))
    assert_same(got, want)


@pytest.mark.parametrize("method", ["argmax", "choice"])
@pytest.mark.parametrize("shape", [(3, 4, 16), (4, 16), (16,)])
def test_sample_instrument_prediction(shape, method):
    jcfg, pcfg = configs(temperature=1.5)
    I = probs(np.random.RandomState(5), *shape)
    want = jax_sampling.sample_instrument_prediction(I, method, jcfg, np.random.RandomState(6))
    got = port_sampling.sample_instrument_prediction(I, method, pcfg, np.random.RandomState(6))
    assert_same(got, want)


@pytest.mark.parametrize("method", ["argmax", "choice"])
@pytest.mark.parametrize("shape", [(3, 16, 2), (16, 2), (2,)])
def test_sample_held_notes_prediction(shape, method):
    jcfg, pcfg = configs()
    D = probs(np.random.RandomState(8), *shape, zeros=0.0)
    want = jax_sampling.sample_held_notes_prediction(D, method, jcfg, np.random.RandomState(9))
    got = port_sampling.sample_held_notes_prediction(D, method, pcfg, np.random.RandomState(9))
    assert_same(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_velocity_override_and_its_loop(seed):
    jcfg, pcfg = configs()
    rng = np.random.RandomState(seed)
    Y = np.zeros((128, 60), np.float32)
    for i in range(128):
        if rng.rand() < 0.7:
            Y[i, rng.randint(60)] = 1
    V = rng.rand(128)
    want = jax_sampling.override_pitches_from_velocity(Y, V.copy(), jcfg)
    assert_same(port_sampling.override_pitches_from_velocity(Y, V.copy(), pcfg), want)
    loop = port_sampling._override_pitches_from_velocity_loop(Y, V.copy(), pcfg)
    assert_same(loop, jax_sampling._override_pitches_from_velocity_loop(Y, V.copy(), jcfg))
    np.testing.assert_allclose(loop, want)


HEAD_SETS = [("notes",), ("notes", "velocity"), ("notes", "instrument", "velocity"),
             ("notes", "instrument", "velocity", "held", "next")]


def head_outputs(cfg, heads, B, rng):
    T = 16
    shapes = {"notes": (B, T, cfg.output_dim), "instrument": (B, cfg.max_voices, cfg.instrument_dim),
              "velocity": (B, T, 1), "held": (B, T, 2), "next": (B, T, cfg.output_dim)}
    outs = {h: probs(rng, *shapes[h]) for h in heads}
    if "velocity" in outs:
        outs["velocity"] = rng.rand(B, T, 1).astype(np.float32)
    return outs


@pytest.mark.parametrize("override", [True, False])
@pytest.mark.parametrize("independent", [False, True])
@pytest.mark.parametrize("method", ["argmax", "choice"])
@pytest.mark.parametrize("heads", HEAD_SETS, ids=["+".join(h) for h in HEAD_SETS])
def test_process_decoder_outputs(heads, method, independent, override):
    jcfg, pcfg = configs(override_sampled_pitches_based_on_velocity_info=override,
                         temperature=0.9)
    outs = head_outputs(jcfg, heads, 3, np.random.RandomState(10))
    want = jax_sampling.process_decoder_outputs(outs, method, jcfg, np.random.RandomState(11),
                                                independent_windows=independent)
    got = port_sampling.process_decoder_outputs(outs, method, pcfg, np.random.RandomState(11),
                                                independent_windows=independent)
    assert_same(got, want)


@pytest.mark.parametrize("independent", [False, True])
@pytest.mark.parametrize("heads", HEAD_SETS, ids=["+".join(h) for h in HEAD_SETS])
def test_process_argmax_outputs(heads, independent):
    jcfg, pcfg = configs()
    outs = head_outputs(jcfg, heads, 3, np.random.RandomState(12))
    names = {"notes": "notes_idx", "instrument": "inst_idx", "held": "held_idx", "next": "next_idx"}
    idx = {names[h]: outs[h].argmax(-1) for h in heads if h != "velocity"}
    if "velocity" in outs:
        idx["vel"] = outs["velocity"][..., 0]
    want = jax_sampling.process_argmax_outputs(idx, jcfg, independent_windows=independent)
    assert_same(port_sampling.process_argmax_outputs(idx, pcfg, independent_windows=independent), want)
    # and the argmax of the probability path
    assert_same(port_sampling.process_decoder_outputs(outs, "argmax", pcfg,
                                                      independent_windows=independent), want)


@pytest.mark.parametrize("silent", [True, False])
def test_add_silent_column(silent):
    jcfg, pcfg = configs(include_silent_note=silent)
    Y = np.zeros((6, 60), np.float32)
    Y[0, 5] = Y[3, 59] = 1
    assert_same(port_sampling.add_silent_column(Y, pcfg), jax_sampling.add_silent_column(Y, jcfg))


def _cfg_fields(path):
    """The attribute names read off ``cfg`` in a module's source."""
    tree = ast.parse(open(path).read())
    return {node.attr for node in ast.walk(tree)
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "cfg"}


def test_reads_every_config_field_the_jax_module_reads():
    want = _cfg_fields(os.path.join(REPO, "midi_vae_tpu", "evaluation", "sampling.py"))
    got = _cfg_fields(os.path.join(REPO, "midi_vae_tpu_torch", "evaluation", "sampling.py"))
    assert {"temperature", "cutoff_sample_threshold", "number_of_tries"} <= want
    assert got == want
    for field in want:
        assert hasattr(PortConfig(), field), field
