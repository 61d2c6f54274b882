"""CPU tests of the port's serving bundles (``midi_vae_tpu_torch/serving.py``).

The same seeded weights (the JAX init, as numpy arrays) go into a JAX bundle
(``midi_vae_tpu.serving``, exported for the CPU: its jnp paths) and the
port's (``device="cpu"``: the registered operators' plain versions), at
``small_test_config`` with buckets [4, 8], judges included. The port's
bundle agrees with the JAX bundle (z and the judges' probs within atol 1e-5,
the transfer tests' tolerance; every argmax roll equal) and with the live
port (z within atol 1e-6, argmax equal). Also the cases of
``tests/test_serving.py`` (manifest and files, pad and trim, trailing dims,
the platform checks, a future format, zero-row judges, the ensemble), the
operators (``torch.library.opcheck``; the exported graphs call ``mvt::``
ops), the configs whose serving path reaches a kernel no operator serves
(refused at export), a JAX bundle refused, and a process that serves a
bundle with jax and the VAE model's module blocked.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import threadpoolctl
import torch

from conftest import tools_module
from midi_vae_tpu import serving as jax_serving
from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.models import classifier as jax_clf
from midi_vae_tpu.models.vae import MidiVAE as JaxVAE
from midi_vae_tpu_torch import serving
from midi_vae_tpu_torch.config import Config
from midi_vae_tpu_torch.evaluation.generation import GenerationContext
from midi_vae_tpu_torch.models import classifier as port_clf
from midi_vae_tpu_torch.models import rnn as port_rnn
from midi_vae_tpu_torch.models.vae import MidiVAE
from midi_vae_tpu_torch.ops import gru_decode as port_gd
from midi_vae_tpu_torch.ops import gru_layer as port_gl
from midi_vae_tpu_torch.ops import lstm_decode as port_ld
from midi_vae_tpu_torch.ops import lstm_layer as port_ll

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5       # against the JAX bundle: the transfer tests' tolerance
LIVE_ATOL = 1e-6  # against the live port on the same operators
BUCKETS = [4, 8]
KINDS = ("pitch", "velocity", "instrument")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU products: one torch thread and one BLAS thread, so that
    beside the suite's other busy workers its threads do not wait on each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def song(cfg, n, seed=0):
    """One song's windows: one-hot X (n, T, D), I, V, D as the tensorizer
    gives them."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, cfg.input_length, cfg.input_dim), np.float32)
    X[np.arange(n)[:, None], np.arange(cfg.input_length)[None],
      rng.integers(cfg.input_dim, size=(n, cfg.input_length))] = 1
    I = np.zeros((cfg.max_voices, cfg.instrument_dim), np.float32)
    I[:, 0] = 1
    V = rng.random((n, cfg.output_length)).astype(np.float32)
    D = np.zeros((n, cfg.output_length), np.float32)
    return X, I, V, D


def make_batch(cfg, B, seed=0):
    """An encoder batch with the keys the config's programs take."""
    X, I, V, _ = song(cfg, B, seed)
    batch = {"X": X}
    if cfg.meta_instrument:
        batch["I"] = np.tile(I[None], (B, 1, 1))
    if cfg.meta_velocity:
        batch["V"] = V[:, : cfg.meta_velocity_length, None]
    if cfg.meta_held_notes:
        batch["D"] = np.tile(np.float32([1, 0]), (B, cfg.meta_held_notes_length, 1))
    return batch


def judge_inputs(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return {"pitch": rng.random((n, cfg.output_length, cfg.input_dim)).astype(np.float32),
            "velocity": rng.random((n, cfg.output_length, 1)).astype(np.float32),
            "instrument": rng.random((n, cfg.max_voices, cfg.instrument_dim)).astype(np.float32)}


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """(cfg, numpy params, port judges, the JAX bundle dir, the port's)."""
    cfg = small_test_config()
    params = jax.tree_util.tree_map(np.asarray, JaxVAE(cfg).init_params(jax.random.PRNGKey(0)))
    jax_dir = str(tmp_path_factory.mktemp("jax_bundle"))
    port_dir = str(tmp_path_factory.mktemp("port_bundle"))
    jax_serving.export_serving_bundle(cfg, params, jax_dir, BUCKETS, platforms=["cpu"])
    jax_judges, port_judges = {}, {}
    for i, kind in enumerate(KINDS):
        spec = jax_clf.ClassifierSpec.for_kind(kind, cfg, lstm_size=8, num_layers=1)
        model = jax_clf.StyleClassifier(spec, platform="cpu")
        p = model.init_params(jax.random.PRNGKey(90 + i))
        jax_judges[kind] = (model, p)
        port_judges[kind] = port_clf.StyleClassifier(port_clf.ClassifierSpec(**spec.__dict__),
                                                     jax.tree_util.tree_map(np.asarray, p))
    jax_serving.export_classifier_judges(jax_judges, jax_dir, BUCKETS, platforms=["cpu"])
    serving.export_serving_bundle(cfg, params, port_dir, BUCKETS, device="cpu")
    serving.export_classifier_judges(port_judges, port_dir, BUCKETS, device="cpu")
    return cfg, params, port_judges, jax_dir, port_dir


@pytest.fixture(scope="module")
def loaded(bundles):
    """(the JAX bundle, the port's, the live port context)."""
    cfg, params, _, jax_dir, port_dir = bundles
    return (jax_serving.load_serving_bundle(jax_dir), serving.load_serving_bundle(port_dir, "cpu"),
            GenerationContext(cfg, MidiVAE(cfg, params), "cpu"))


def assert_same_rolls(got, want, atol):
    for name, g, w in zip("YIVDN", got, want):
        if w is None:
            assert g is None, name
        elif name == "V":
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# ---------------------------------------------------------------------------
# The port's bundle against the JAX package's and against the live port
# ---------------------------------------------------------------------------

def test_manifest_and_files(bundles):
    cfg, _, _, _, out = bundles
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["batch_sizes"] == BUCKETS and manifest["judge_batch_sizes"] == BUCKETS
    assert manifest["platforms"] == ["cpu"] and manifest["deterministic_encode"] is True
    assert manifest["torch_version"] == torch.__version__ and "jax_version" not in manifest
    assert manifest["programs"] == ["encode", "decode_argmax", "style_transfer"]
    files = [f"{n}@{B}.pt2" for n in manifest["programs"] for B in BUCKETS]
    assert sorted(manifest["blob_bytes"]) == sorted(files)
    for name in files:
        assert os.path.getsize(os.path.join(out, name)) == manifest["blob_bytes"][name]
        assert manifest["export_seconds"][name] > 0
    assert set(manifest["judges"]) == set(KINDS)
    for kind, meta in manifest["judges"].items():
        for B in BUCKETS:
            assert os.path.exists(os.path.join(out, f"judge_{kind}@{B}.pt2"))
        assert meta["spec"]["kind"] == kind
    assert Config.load(os.path.join(out, "config.json")).to_dict() == cfg.to_dict()


@pytest.mark.parametrize("rows", [3, 8])
def test_encode_matches_jax_bundle_and_live(bundles, loaded, rows):
    cfg, params, *_ = bundles
    jb, pb, ctx = loaded
    batch = make_batch(cfg, rows)
    z = pb.encode(batch)
    assert z.shape == (rows, cfg.latent_dim)
    np.testing.assert_allclose(z, jb.encode(batch), rtol=0, atol=ATOL)
    live = MidiVAE(cfg, params).encode({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(z, live.detach().numpy(), rtol=0, atol=LIVE_ATOL)


def test_decode_argmax_matches_jax_bundle_and_live(bundles, loaded):
    cfg, *_ = bundles
    jb, pb, ctx = loaded
    z = pb.encode(make_batch(cfg, 8, seed=1))
    H = np.roll(z, 1, axis=0)
    got, want = pb.decode_argmax(z, H), jb.decode_argmax(z, H)
    assert sorted(got) == sorted(want)
    live = ctx._decode_padded(ctx._decode_argmax, z, H, None)
    for k in want:
        if k == "vel":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL)
            np.testing.assert_allclose(got[k], live[k], rtol=0, atol=LIVE_ATOL)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], live[k], err_msg=k)


def test_style_transfer_one_program_matches_jax_bundle(bundles, loaded):
    cfg, *_ = bundles
    jb, pb, _ = loaded
    batch = make_batch(cfg, 8, seed=2)
    perm = np.arange(cfg.latent_dim)[::-1].copy()
    outs, switched = pb.style_transfer(batch, perm)
    want, want_switched = jb.style_transfer(batch, perm)
    np.testing.assert_allclose(switched, want_switched, rtol=0, atol=ATOL)
    np.testing.assert_allclose(switched, pb.encode(batch)[:, perm], rtol=0, atol=LIVE_ATOL)
    for k in want:
        if k == "vel":
            np.testing.assert_allclose(outs[k], want[k], rtol=0, atol=ATOL)
        else:
            np.testing.assert_array_equal(outs[k], want[k], err_msg=k)


@pytest.mark.parametrize("windows", [3, 13], ids=["one_program", "composed_long_song"])
def test_style_transfer_song_matches_jax_bundle_and_live(bundles, loaded, windows):
    """Songs up to the top bucket take the one-program path; longer ones
    compose encode -> host roll -> chunked decode: the rolls are those of
    the JAX bundle and of the live port either way."""
    cfg, *_ = bundles
    jb, pb, ctx = loaded
    X, I, V, D = song(cfg, windows, seed=windows)
    got, got_z = pb.style_transfer_song(X, I, V, D, C=0, C_switch=1)
    want, want_z = jb.style_transfer_song(X, I, V, D, C=0, C_switch=1)
    live, live_z = ctx.style_transfer_song(X, I, V, D, C=0, C_switch=1)
    np.testing.assert_allclose(got_z, want_z, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_z, live_z, rtol=0, atol=LIVE_ATOL)
    assert_same_rolls(got, want, ATOL)
    assert_same_rolls(got, live, LIVE_ATOL)


def test_sealed_judges_match_jax_and_live(bundles, loaded):
    cfg, _, port_judges, _, _ = bundles
    jb, pb, _ = loaded
    xs = judge_inputs(cfg, 19, seed=3)  # more rows than the top bucket: chunked
    judges, jax_judges = pb.judges, jb.judges
    assert set(judges) == set(KINDS)
    for kind in KINDS:
        got = judges[kind](xs[kind])
        assert got.shape == (19, cfg.num_classes)
        np.testing.assert_allclose(got, jax_judges[kind](xs[kind]), rtol=0, atol=ATOL,
                                   err_msg=kind)
        live = port_clf.make_judge(port_judges[kind])(xs[kind])
        np.testing.assert_allclose(got, live, rtol=0, atol=LIVE_ATOL, err_msg=kind)
    ens = pb.ensemble_prediction(xs["pitch"], xs["instrument"], xs["velocity"])
    np.testing.assert_allclose(ens, jb.ensemble_prediction(xs["pitch"], xs["instrument"],
                                                           xs["velocity"]), rtol=0, atol=ATOL)


def test_zero_row_judge_matches_make_judge_surface(bundles, loaded):
    cfg, _, port_judges, _, _ = bundles
    _, pb, _ = loaded
    empty = np.zeros((0, cfg.output_length, cfg.input_dim), np.float32)
    probs = pb.judges["pitch"](empty)
    live = port_clf.make_judge(port_judges["pitch"])(empty)
    assert probs.shape == live.shape == (0, cfg.num_classes)
    assert probs.dtype == live.dtype


def test_bundle_without_judges_is_empty(bundles, tmp_path):
    cfg, params, *_ = bundles
    out = str(tmp_path / "nojudges")
    serving.export_serving_bundle(cfg, params, out, [4], device="cpu")
    b = serving.load_serving_bundle(out, "cpu")
    assert b.judges == {}
    with pytest.raises(RuntimeError, match="sealed judges"):
        b.ensemble_prediction(None, None, None)


def test_bucket_pad_and_trim(bundles, loaded):
    """A 3-row request runs on the 4-bucket and trims back to 3; the padded
    rows do not perturb the real rows."""
    cfg, *_ = bundles
    _, pb, _ = loaded
    batch8 = make_batch(cfg, 8, seed=4)
    assert pb.bucket_for(3) == 4 and pb.bucket_for(5) == 8
    z3 = pb.encode({k: v[:3] for k, v in batch8.items()})
    assert z3.shape == (3, cfg.latent_dim)
    np.testing.assert_allclose(z3, pb.encode(batch8)[:3], rtol=0, atol=LIVE_ATOL)
    with pytest.raises(ValueError, match="largest bucket"):
        pb.bucket_for(9)


def test_trailing_dim_enforcement(bundles, loaded):
    cfg, *_ = bundles
    _, pb, _ = loaded
    bad = make_batch(cfg, 4)
    bad["X"] = bad["X"][:, :, :-1]  # wrong pitch dim
    with pytest.raises(ValueError, match="trailing dims"):
        pb.encode(bad)
    with pytest.raises(ValueError, match="trailing dims"):
        pb.judges["pitch"](np.zeros((2, cfg.output_length, 3), np.float32))


def test_encode_and_decode_song_roundtrip(bundles, loaded):
    cfg, *_ = bundles
    _, pb, ctx = loaded
    X, I, V, D = song(cfg, 2, seed=5)
    z = pb.encode_song(X, I, V, D)
    np.testing.assert_allclose(z, ctx.encode_song(X, I, V, D), rtol=0, atol=LIVE_ATOL)
    rolls = pb.decode_and_process(z, history=z)
    assert rolls[0].shape[0] == 2 * cfg.output_length
    assert_same_rolls(rolls, ctx.decode_and_process(z, history=z), LIVE_ATOL)
    with pytest.raises(ValueError, match="argmax"):
        pb.decode_and_process(z, sample_method="choice")


# ---------------------------------------------------------------------------
# The loader's checks
# ---------------------------------------------------------------------------

def _edited_copy(src, dst, **manifest):
    shutil.copytree(src, dst)
    path = os.path.join(dst, "manifest.json")
    with open(path) as f:
        m = json.load(f)
    m.update(manifest)
    with open(path, "w") as f:
        json.dump(m, f)
    return dst


def test_platform_mismatch_clean_error(bundles, tmp_path):
    alien = _edited_copy(bundles[4], str(tmp_path / "alien"), platforms=["cuda"])
    with pytest.raises(RuntimeError, match="exported for platform.*--device cpu"):
        serving.load_serving_bundle(alien, "cpu")


def test_cuda_bundle_without_a_card_is_an_error(bundles, tmp_path, monkeypatch):
    """A bundle exported on the card asks for one: no CPU fallback, at load
    or at export."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    on_card = _edited_copy(bundles[4], str(tmp_path / "on_card"), platforms=["cuda"])
    with pytest.raises(RuntimeError, match="cuda"):
        serving.load_serving_bundle(on_card)
    cfg, params, *_ = bundles
    with pytest.raises(RuntimeError, match="cuda"):
        serving.export_serving_bundle(cfg, params, str(tmp_path / "x"), [4])


def test_future_format_clean_error(bundles, tmp_path):
    future = _edited_copy(bundles[4], str(tmp_path / "future"),
                          bundle_format=serving.BUNDLE_FORMAT + 1)
    with pytest.raises(RuntimeError, match="newer than this framework"):
        serving.load_serving_bundle(future, "cpu")


def test_jax_bundle_is_refused(bundles):
    with pytest.raises(RuntimeError, match="JAX package bundle"):
        serving.load_serving_bundle(bundles[3], "cpu")


# ---------------------------------------------------------------------------
# The registered operators
# ---------------------------------------------------------------------------

def _head(cell_type, n_layers, D, H, B, seed):
    rng = np.random.default_rng(seed)
    G = (4 if cell_type == "LSTM" else 3) * H

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.3)

    cells = [{"w": t(D if i == 0 else H, G), "u": t(H, G), "b": t(G)} for i in range(n_layers)]
    states = [(t(B, H), t(B, H)) if cell_type == "LSTM" else t(B, H) for _ in range(n_layers)]
    return cells, {"w": t(H, D), "b": t(D)}, states, t(B, D)


def _opcheck_args(op):
    T, B, D, H = 5, 3, 7, 16
    if op in ("gru_layer", "lstm_layer"):
        cells, _, states, _ = _head("LSTM" if op == "lstm_layer" else "GRU", 1, D, H, B, 0)
        x = torch.randn(T, B, D, generator=torch.Generator().manual_seed(1))
        p = cells[0]
        if op == "gru_layer":
            return (x, states[0], p["w"], p["b"], p["u"], "tanh", True)
        return (x, *states[0], p["w"], p["b"], p["u"], "tanh", False, True)
    letter = "M" if op == "lstm_decode" else "B"
    args = []
    for n in (1, 2):
        head = _head("LSTM" if letter == "M" else "GRU", n, D, H, B, n)
        args.append((*port_gd.decode_operands(*head, letter), T, "relu", "sigmoid", None))
    return args


@pytest.mark.parametrize("op", ["gru_layer", "gru_decode", "lstm_layer", "lstm_decode"])
def test_opcheck(op):
    """``torch.library.opcheck`` on each operator: its schema (no mutation,
    no aliasing), its fake implementation against the CPU one, the
    autograd registration and the AOT dispatch (decode heads of 1 and 2
    layers)."""
    cases = _opcheck_args(op)
    for args in (cases if isinstance(cases, list) else [cases]):
        result = torch.library.opcheck(getattr(torch.ops.mvt, op).default, args)
        assert set(result.values()) == {"SUCCESS"}, result


def test_wrappers_call_the_operators_and_match_their_plain_versions():
    """Each public wrapper returns what its plain version does, through its
    operator (the op's call counted by a profiler record)."""
    T, B, D, H = 4, 3, 5, 16
    cells, out, states, start = _head("GRU", 2, D, H, B, 7)
    lcells, _, lstates, _ = _head("LSTM", 2, D, H, B, 8)
    x = torch.randn(T, B, D, generator=torch.Generator().manual_seed(2))
    p, lp = cells[0], lcells[0]
    calls = {
        "gru_layer": (lambda: port_gl.gru_layer(x, states[0], p["w"], p["b"], p["u"], "relu", True),
                      lambda: port_gl.gru_layer_reference(x, states[0], p["w"], p["b"], p["u"],
                                                          "relu", True)),
        "lstm_layer": (lambda: port_ll.lstm_layer(x, *lstates[0], lp["w"], lp["b"], lp["u"],
                                                  with_c=True),
                       lambda: port_ll.lstm_layer_reference(x, *lstates[0], lp["w"], lp["b"],
                                                            lp["u"], with_c=True)),
        "gru_decode": (lambda: port_gd.gru_decode(cells, out, states, start, T),
                       lambda: port_gd.gru_decode_reference(cells, out, states, start, T)),
        "lstm_decode": (lambda: port_ld.lstm_decode(lcells[:1], out, lstates[:1], start, T),
                        lambda: port_ld.lstm_decode_reference(lcells[:1], out, lstates[:1],
                                                              start, T)),
    }
    for name, (wrapper, plain) in calls.items():
        with torch.profiler.profile() as prof:
            got = wrapper()
        assert any(e.name == f"mvt::{name}" for e in prof.events()), name
        for g, w in zip(got, plain()):
            assert torch.equal(g, w), name


def _graph_ops(path):
    program = torch.export.load(path)
    return {str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("mvt.")}


def test_exported_graphs_call_the_operators(bundles):
    out = bundles[4]
    assert _graph_ops(os.path.join(out, "encode@4.pt2")) == {"mvt.gru_layer.default"}
    assert _graph_ops(os.path.join(out, "decode_argmax@4.pt2")) == {"mvt.gru_decode.default"}
    assert _graph_ops(os.path.join(out, "style_transfer@8.pt2")) == {"mvt.gru_layer.default",
                                                                     "mvt.gru_decode.default"}
    assert _graph_ops(os.path.join(out, "judge_pitch@4.pt2")) == {"mvt.gru_layer.default"}


def test_lstm_bundle_calls_l_and_m_and_matches_live(tmp_path):
    cfg = small_test_config(cell_type="LSTM")
    params = jax.tree_util.tree_map(np.asarray, JaxVAE(cfg).init_params(jax.random.PRNGKey(5)))
    out = str(tmp_path / "lstm")
    serving.export_serving_bundle(cfg, params, out, [8], device="cpu")
    assert _graph_ops(os.path.join(out, "style_transfer@8.pt2")) == {"mvt.lstm_layer.default",
                                                                     "mvt.lstm_decode.default"}
    b = serving.load_serving_bundle(out, "cpu")
    ctx = GenerationContext(cfg, MidiVAE(cfg, params), "cpu")
    X, I, V, D = song(cfg, 5, seed=6)
    got, got_z = b.style_transfer_song(X, I, V, D, C=0, C_switch=1)
    live, live_z = ctx.style_transfer_song(X, I, V, D, C=0, C_switch=1)
    np.testing.assert_allclose(got_z, live_z, rtol=0, atol=LIVE_ATOL)
    assert_same_rolls(got, live, LIVE_ATOL)


def test_loaded_programs_share_one_weight_set(loaded):
    """The programs of a bundle serve from one tensor per weight, so the
    decode kernels' packing cache holds one entry per head and plan."""
    _, pb, _ = loaded
    by_name: dict = {}
    for (name, _), program in pb._fns.items():
        if not name.startswith("judge_"):
            for k, t in program.named_parameters():
                by_name.setdefault(k, set()).add(id(t))
    assert by_name and all(len(ids) == 1 for ids in by_name.values())


# ---------------------------------------------------------------------------
# Configs whose serving path reaches a kernel no operator serves
# ---------------------------------------------------------------------------

UNREGISTERED = {
    # GRU heads that B does not take run kernel T step by step
    "gru_3layer_heads": ({"num_layers_decoder": 3},
                         ["kernel T on the notes head (3 layers, softmax output)"]),
    "gru_tanh_velocity": ({"meta_velocity_activation": "tanh"},
                          ["kernel T on the velocity head (1 layers, tanh output)"]),
    # LSTM heads that M does not take run kernel S
    "lstm_3layer_heads": ({"cell_type": "LSTM", "num_layers_decoder": 3},
                          ["kernel S on the notes head (3 layers, softmax output)"]),
    "lstm_relu_instrument": ({"cell_type": "LSTM", "meta_instrument_activation": "relu"},
                             ["kernel S on the instrument head (1 layers, relu output)"]),
    "gru_3layer_next_notes": ({"num_layers_decoder": 3, "meta_next_notes": True},
                              ["kernel T on the notes head (3 layers, softmax output)",
                               "kernel T on the next head (3 layers, softmax output)"]),
}


@pytest.mark.parametrize("name", sorted(UNREGISTERED))
def test_unregistered_kernels_are_refused_at_export(name, tmp_path):
    overrides, kernels = UNREGISTERED[name]
    cfg = small_test_config(**overrides)
    model = MidiVAE(cfg)
    assert serving.unregistered_kernels(model, "cpu") == kernels
    with pytest.raises(NotImplementedError, match="Queue 1 item 10") as err:
        serving.export_serving_bundle(cfg, None, str(tmp_path / "b"), [4], device="cpu")
    for k in kernels:
        assert k in str(err.value)
    assert not os.path.exists(tmp_path / "b" / "manifest.json")


@pytest.mark.parametrize("overrides", [
    {}, {"cell_type": "LSTM"}, {"fused_train_encoder": False},
    {"compute_dtype": "bfloat16", "fused_train_encoder": False},
    {"cell_type": "LSTM", "compute_dtype": "bfloat16", "fused_train_encoder": False},
    {"lstm_activation": "relu"}, {"cell_type": "LSTM", "lstm_activation": "relu"}],
    ids=["default", "lstm", "per_step", "whole_scan", "lstm_whole_scan", "relu", "lstm_relu"])
def test_serving_encoder_reaches_no_training_kernel(overrides, monkeypatch):
    """The serving encoder runs A or L (or the plain scan): the training
    path's whole-scan encoders X and Y and per-step cells T xp and S xp are
    never reached, whatever the training flags, so no config needs them
    registered."""
    def refused(*a, **k):
        raise AssertionError("a serving encode reached a training-only kernel")

    for name in ("gru_encoder_scan", "lstm_encoder_scan", "gru_recurrent_step",
                 "lstm_recurrent_step"):
        monkeypatch.setattr(port_rnn, name, refused)
    cfg = small_test_config(**overrides)
    model = MidiVAE(cfg)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 3).items()}
    with torch.no_grad():
        assert torch.isfinite(model.encode(batch)).all()
    assert serving.unregistered_kernels(model, "cpu") == []


# ---------------------------------------------------------------------------
# A process that serves a bundle with jax and the VAE model blocked
# ---------------------------------------------------------------------------

def test_bundle_serves_without_jax_or_the_model_class(bundles, tmp_path):
    corpus = tools_module("make_demo_corpus")
    songs = tmp_path / "songs" / "style1"
    songs.mkdir(parents=True)
    corpus.make_song(corpus.STYLES["style1"], np.random.RandomState(0), bars=6).write(
        str(songs / "s.mid"))
    code = (
        "import sys\n"
        "for name in ('jax', 'midi_vae_tpu', 'midi_vae_tpu_torch.models.vae'):\n"
        "    sys.modules[name] = None  # importing any of them now raises\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from midi_vae_tpu_torch.cli import transfer\n"
        f"rc = transfer.main(['--bundle', {bundles[4]!r}, '--input', {str(songs / 's.mid')!r},"
        " '--to-class', 'style2', '--output', 'out', '--device', 'cpu'])\n"
        "assert rc == 0\n"
        "from midi_vae_tpu_torch.data import smf\n"
        "assert smf.read_midi('out/s_style1_to_style2.mid').instruments\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "judging with sealed programs" in res.stdout
    assert res.stdout.strip().endswith("ok")
