"""CPU parity of the port's wide route (GRU(512): kernels F and G, the wide
builds of D and E) and of the route chooser, against the JAX package.

The JAX side takes its own wide path: ``fused_train._FORCE_TRAIN_MODE =
"wide"`` with its Pallas kernels in interpret mode (``_bwd_wide_pallas``,
``_dec_bwd_wide_pallas`` and their weight-grad passes), the in-kernel
projection and the multi-head kernel turned off as the VMEM checks turn them
off at H = 512. The port runs the same route, forced at small widths by
``ops._layout.FORCE_ROUTE``, with the kernels' plain versions (CPU tensors).
Same numpy inputs on both sides. Tolerances (float32, sums in another order):
- forward values: rtol 2e-5, atol 2e-6 (as tests/test_torch_ops.py);
- gradients of a functional of the outputs: atol 1e-5 + rtol 1e-4;
- the loss and every metric: atol 1e-5; every parameter gradient: atol 1e-5
  + rtol 1e-4 (as tests/test_torch_train.py).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from midi_vae_tpu.config import Config, small_test_config
from midi_vae_tpu.models.cells import GRUCell, dense_init
from midi_vae_tpu.models.vae import MidiVAE as JaxVAE
from midi_vae_tpu.models.vae import loss_and_metrics as jax_loss
from midi_vae_tpu.ops import fused_train as ft
from midi_vae_tpu.ops.fused_decoder import _encoder_scan_reference
from midi_vae_tpu_torch import bridge
from midi_vae_tpu_torch.models import rnn as port_rnn
from midi_vae_tpu_torch.models import vae as port_vae
from midi_vae_tpu_torch.models.vae import MidiVAE, loss_and_metrics
from midi_vae_tpu_torch.ops import _build, _layout
from midi_vae_tpu_torch.ops import grad_reduce as port_gr
from midi_vae_tpu_torch.ops import gru_decode as port_decode
from midi_vae_tpu_torch.ops import gru_layer as port_layer

RTOL, ATOL = 2e-5, 2e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
LOSS_ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, VALID = 5, 3  # training batch rows, of which the last two are padding


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.fixture
def jax_wide(monkeypatch):
    """The JAX package on its wide path: the wide kernels forced, the
    in-kernel-projection layer and the multi-head decode refused."""
    monkeypatch.setattr(ft, "_FORCE_TRAIN_MODE", "wide")
    monkeypatch.setattr(ft, "_x_use_pallas", lambda *a: False)
    monkeypatch.setattr(ft, "_mh_use_pallas", lambda *a: False)


@pytest.fixture
def port_wide(monkeypatch):
    monkeypatch.setattr(_layout, "FORCE_ROUTE", "wide")


# ---------------------------------------------------------------------------
# the layer over a precomputed x-projection: kernels F, G and W
# ---------------------------------------------------------------------------

def _layer_case(T=7, Bn=16, H=24, seed=3):
    rng = np.random.RandomState(seed)
    return ((0.3 * rng.randn(T, Bn, 3 * H)).astype(np.float32),
            (0.1 * rng.randn(Bn, H)).astype(np.float32),
            (0.1 * rng.randn(H, 3 * H)).astype(np.float32))


@pytest.mark.parametrize("return_sequences", [True, False])
def test_gru_layer_train_matches_jax_wide(return_sequences, jax_wide, monkeypatch):
    """gru_layer_train's output and its grads for xp, h0 and U against the
    JAX wide pair (_fwd_wide_pallas, _bwd_wide_pallas + the dU pass), with a
    budget small enough that the JAX batch tiling is real (as
    tests/test_ops_train.py::test_gru_wide_gradient_parity)."""
    monkeypatch.setattr(ft, "_WIDE_BUDGET_BYTES", 40_000)
    assert 0 < ft._gru_wide_btiles(16, 24, 4)[1] < 16
    args = _layer_case()
    want_out, vjp = jax.vjp(lambda *a: ft.gru_layer_train(*a, "tanh", return_sequences, True),
                            *map(jnp.asarray, args))
    want = vjp(jnp.cos(want_out))  # the cotangent of sum(sin(out))
    leaves = [_t(a).requires_grad_() for a in args]
    out = port_layer.gru_layer_train(*leaves, return_sequences)
    _close(out, want_out)
    for name, g, w in zip(("xp", "h0", "u"), torch.autograd.grad(torch.sin(out).sum(), leaves),
                          want):
        _close(g, w, GRAD_RTOL, GRAD_ATOL, f"d{name}")


@pytest.mark.parametrize("T", [1, 2, 6])
def test_kernel_g_plain_version_matches_jax_bwd_wide(T):
    """Kernel G's plain version emits what _bwd_wide_pallas emits (the gate
    grads = dxp, dh0) for a return-sequence layer, and r * h_{t-1}, from
    which W's dU matches _gru_wide_weight_grads."""
    xp, h0, u = _layer_case(T=T, Bn=8, H=16, seed=T)
    rng = np.random.RandomState(10 + T)
    seq = np.asarray(_encoder_scan_reference(*map(jnp.asarray, (xp, h0, u)), jnp.tanh, True))
    d_seq = rng.randn(*seq.shape).astype(np.float32)
    dacat, dh0 = ft._bwd_wide_pallas(*map(jnp.asarray, (xp, seq, h0, d_seq, np.zeros_like(h0), u)),
                                     True, True, 8)
    want_du = ft._gru_wide_weight_grads(*map(jnp.asarray, (xp, seq, h0, u)), dacat)
    got_da, got_dh0, _, rh = port_layer.gru_layer_xp_bwd_reference(_t(xp), _t(seq), _t(h0),
                                                                    _t(d_seq), None, _t(u))
    _close(got_da, dacat, GRAD_RTOL, GRAD_ATOL)
    _close(got_dh0, dh0, GRAD_RTOL, GRAD_ATOL)
    hprev = torch.cat([_t(h0)[None], _t(seq)[:-1]])
    _close(port_gr.gru_u_grad(hprev, rh, got_da), want_du, GRAD_RTOL, GRAD_ATOL)


# ---------------------------------------------------------------------------
# the wide decode builds of D and E
# ---------------------------------------------------------------------------

def _head(D, n, Bn, H, seed):
    rng = np.random.RandomState(seed)
    keys = [np.array([5, seed + i], np.uint32) for i in range(3)]
    cells = [GRUCell.init(keys[0], D, H)] + ([GRUCell.init(keys[1], H, H)] if n == 2 else [])
    out = dense_init(keys[2], H, D)
    out["b"] = (0.1 * rng.randn(D)).astype(np.float32)
    return {"cells": cells, "out": out,
            "init": [(0.3 * rng.randn(Bn, H)).astype(np.float32) for _ in range(n)],
            "start": (0.2 * rng.rand(Bn, D)).astype(np.float32)}


@pytest.mark.parametrize("D, n, out_act, T", [(12, 2, "softmax", 6), (1, 1, "sigmoid", 6),
                                              (16, 1, "softmax", 4)],
                         ids=["2layer_softmax", "1layer_sigmoid_D1", "1layer_softmax_T4"])
def test_wide_decode_matches_jax(D, n, out_act, T, jax_wide, monkeypatch):
    """probs, logits and the grads of sum(sin(probs)) + 0.3 sum(cos(logits))
    for every cell, the out dense, the init states and the start symbol,
    through gru_decode_train on the wide builds against the JAX wide decode pair
    (as tests/test_ops_train.py::test_wide_decode_gradient_parity)."""
    monkeypatch.setattr(ft, "_WIDE_BUDGET_BYTES", 200_000)
    spec = _head(D, n, 16, 16, D + n)
    jspec = jax.tree_util.tree_map(jnp.asarray, spec)
    (want_p, want_l), vjp = jax.vjp(lambda s: ft.gru_decode_train(
        s["cells"], s["out"], s["init"], s["start"], T, "tanh", out_act, True), jspec)
    (want,) = vjp((jnp.cos(want_p), -0.3 * jnp.sin(want_l)))
    leaves = [_t(a).requires_grad_() for a in port_decode._flatten_head(spec)]
    h = port_decode._unflatten_heads([(n, None, None)], leaves)[0]
    probs, logits = port_decode.gru_decode_train(h["cells"], h["out"], h["init"], h["start"], T,
                                                 "tanh", out_act, ("D_wide", "E_wide"))
    _close(probs, want_p)
    _close(logits, want_l)
    got = torch.autograd.grad(torch.sin(probs).sum() + 0.3 * torch.cos(logits).sum(), leaves)
    order = [want["start"], *want["init"], *[c[k] for c in want["cells"] for k in ("w", "u", "b")],
             want["out"]["w"], want["out"]["b"]]
    for g, w in zip(got, order):
        _close(g, w, GRAD_RTOL, GRAD_ATOL)


# ---------------------------------------------------------------------------
# the whole training step on the wide route, and the two repairs
# ---------------------------------------------------------------------------

def make_batch(cfg, seed=0):
    """A numpy training batch with rows VALID.. zeroed and masked out."""
    rng = np.random.RandomState(seed)
    eye = lambda d, idx: np.eye(d, dtype=np.float32)[idx]  # noqa: E731
    batch = {
        "X": eye(cfg.input_dim, rng.randint(0, cfg.input_dim, (B, cfg.input_length))),
        "Y": eye(cfg.output_dim, rng.randint(0, cfg.output_dim, (B, cfg.output_length))),
        "I": eye(cfg.instrument_dim, rng.randint(0, cfg.instrument_dim, (B, cfg.max_voices))),
        "V": rng.rand(B, cfg.output_length, 1).astype(np.float32),
        "D": eye(2, rng.randint(0, 2, (B, cfg.output_length))),
        "C": eye(cfg.num_classes, rng.randint(0, cfg.num_classes, B)),
        "S": rng.randn(B, cfg.signature_vector_length).astype(np.float32),
        "H": (0.5 * rng.randn(B, cfg.latent_dim)).astype(np.float32),
    }
    for v in batch.values():
        v[VALID:] = 0
    batch["M"] = (np.arange(B) < VALID).astype(np.float32)
    return batch


def _jax_step(cfg, params, batch):
    jm = JaxVAE(cfg)
    jm._interpret = True
    key = jax.random.PRNGKey(1)
    fn = jax.value_and_grad(lambda p, b: jax_loss(jm, p, b, key, cfg.epsilon_std), has_aux=True)
    (loss, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    noise = np.asarray(cfg.epsilon_std * jax.random.normal(key, (B, cfg.latent_dim), jnp.float32))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            bridge.flatten(jax.tree_util.tree_map(np.asarray, grads)), noise)


def _port_step(cfg, params, batch, noise):
    model = MidiVAE(cfg, params, trainable=True)
    tb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    loss, metrics = loss_and_metrics(model, tb, noise=torch.from_numpy(noise.copy()))
    named = list(model.params.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return loss.item(), metrics, {k.replace(".", "/"): g for (k, _), g in zip(named, grads)}


def _assert_step_matches(cfg, params, batch, want):
    want_loss, want_metrics, want_grads, noise = want
    loss, metrics, grads = _port_step(cfg, params, batch, noise)
    np.testing.assert_allclose(loss, want_loss, rtol=0, atol=LOSS_ATOL)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=0, atol=LOSS_ATOL, err_msg=k)
    assert sorted(grads) == sorted(want_grads)
    for k, w in want_grads.items():
        g = np.zeros_like(w) if grads[k] is None else grads[k].numpy()
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


class _Spy:
    """Records the calls of module functions, then calls them. ``targets``
    maps a name to a (module, attribute) or a list of them (one function
    imported by name into several modules)."""

    def __init__(self, monkeypatch, targets):
        self.calls = {name: [] for name in targets}
        for name, where in targets.items():
            for module, attr in (where if isinstance(where, list) else [where]):
                fn = getattr(module, attr)

                def spy(*a, _fn=fn, _name=name, **kw):
                    self.calls[_name].append((a, kw))
                    return _fn(*a, **kw)

                monkeypatch.setattr(module, attr, spy)

    def count(self):
        return {k: len(v) for k, v in self.calls.items() if v}


def _kernel_spy(monkeypatch):
    """One entry per kernel a CUDA run would launch, on the CPU path."""
    return _Spy(monkeypatch, {
        "A": (port_layer, "gru_layer"), "C": (port_layer, "gru_layer_bwd"),
        "F": (port_layer, "gru_layer_xp"), "G": (port_layer, "gru_layer_xp_bwd"),
        "D": (port_decode, "gru_decode_fwd_train"), "E": (port_decode, "gru_decode_bwd"),
        "D_wide": (port_decode, "gru_decode_fwd_train_wide"),
        "E_wide": (port_decode, "gru_decode_bwd_wide"),
        "W": [(port_gr, "grad_reduce"), (port_decode, "grad_reduce")],
    })


# the design's launches per training step of the default head set (notes
# 2 + instrument + velocity encoder layers; notes 2-layer, velocity and
# instrument 1-layer heads); chip_smoke.py holds the card's counters to them
STEP_LAUNCHES = {
    "narrow": {"A": 4, "C": 4, "D": 2, "E": 2, "W": 27},
    "wide": {"F": 4, "G": 4, "D_wide": 3, "E_wide": 3, "W": 23},
}


def test_loss_and_every_gradient_match_jax_on_the_wide_route(jax_wide, port_wide, monkeypatch):
    """loss_and_metrics and every parameter gradient of small_test_config,
    the port's wide route against the JAX package's wide path, with the
    noise injected; one step calls each kernel as the design says."""
    cfg = small_test_config()
    params = jax.tree_util.tree_map(np.asarray, JaxVAE(cfg).init_params(jax.random.PRNGKey(3)))
    batch = make_batch(cfg)
    want = _jax_step(cfg, params, batch)
    spy = _kernel_spy(monkeypatch)
    _assert_step_matches(cfg, params, batch, want)
    assert spy.count() == STEP_LAUNCHES["wide"]


def test_the_narrow_route_keeps_its_launches(monkeypatch):
    cfg = small_test_config()
    model = MidiVAE(cfg, MidiVAE(cfg).init_params(np.array([0, 2], np.uint32)), trainable=True)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    spy = _kernel_spy(monkeypatch)
    loss, _ = loss_and_metrics(model, batch, noise=torch.zeros(B, cfg.latent_dim))
    torch.autograd.grad(loss, list(model.params.parameters()), allow_unused=True)
    assert spy.count() == STEP_LAUNCHES["narrow"]


@pytest.mark.parametrize("overrides", [{"teacher_force": True},
                                       {"teacher_force": True, "meta_next_notes": True,
                                        "meta_next_notes_teacher_force": True},
                                       {"lstm_activation": "sigmoid"}],
                         ids=["teacher_force", "next_teacher_force", "sigmoid_cells"])
def test_repaired_configs_match_jax(overrides):
    """Teacher forcing and non-tanh cells, which the port refused on CUDA,
    train like the JAX package (its kernels in interpret mode)."""
    cfg = small_test_config(**overrides)
    params = jax.tree_util.tree_map(np.asarray, JaxVAE(cfg).init_params(jax.random.PRNGKey(5)))
    batch = make_batch(cfg, seed=2)
    if cfg.meta_next_notes:
        rng = np.random.RandomState(4)
        batch["N"] = np.eye(cfg.output_dim, dtype=np.float32)[
            rng.randint(0, cfg.output_dim, (B, cfg.output_length))]
        batch["N"][VALID:] = 0
    _assert_step_matches(cfg, params, batch, _jax_step(cfg, params, batch))


def test_teacher_forced_notes_head_stays_out_of_the_decode_kernels(monkeypatch):
    """With teacher forcing the notes head takes the plain scan over its
    ground truth; velocity and instrument still take kernels D and E (the
    multi-head call is skipped, midi_vae_tpu/models/vae.py:558-569), on the
    card as on the CPU."""
    cfg = small_test_config(teacher_force=True)
    model = MidiVAE(cfg, MidiVAE(cfg).init_params(np.array([0, 6], np.uint32)), trainable=True)
    assert model.train_kernels_enabled(torch.device("cuda"))
    spy = _Spy(monkeypatch, {"multihead": (port_vae, "gru_decode_multihead_train"),
                             "head": (port_vae, "gru_decode_train"),
                             "scan": (port_vae, "decode_autoregressive")})
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    loss_and_metrics(model, batch, noise=torch.zeros(B, cfg.latent_dim))
    assert spy.count() == {"head": 2, "scan": 1}
    (_, kw), = spy.calls["scan"]
    assert kw == {} and spy.calls["scan"][0][0][-1] is not None  # the ground truth
    assert sorted(a[6] for a, _ in spy.calls["head"]) == ["sigmoid", "softmax"]


def test_non_tanh_cells_train_through_the_plain_scans(monkeypatch):
    cfg = small_test_config(lstm_activation="sigmoid")
    model = MidiVAE(cfg, MidiVAE(cfg).init_params(np.array([0, 7], np.uint32)), trainable=True)
    assert model.train_kernels_enabled(torch.device("cuda")) is False
    spy = _kernel_spy(monkeypatch)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    loss, _ = loss_and_metrics(model, batch, noise=torch.zeros(B, cfg.latent_dim))
    assert np.isfinite(loss.item()) and spy.count() == {}


# ---------------------------------------------------------------------------
# the route chooser: a pure function of the config and the card's limits
# ---------------------------------------------------------------------------

def test_route_of_the_default_config_at_256_and_512():
    assert _layout.config_route(Config()) == "narrow"
    assert _layout.config_route(Config(lstm_size=512)) == "wide"
    # the limit that sends 512 wide: kernel D's registers; E runs as phases
    # on both routes, its chain's plan launching at 512 (the notes head's
    # slices streamed)
    assert "65,536" in _layout.launch_limit("D", 512, _layout.smem_bytes("D", 512, 61, 2))
    for build in ("E", "E_wide"):
        assert _layout.launch_limit(build, 512, 0) is None
    assert not _layout.gru_bptt_plan("E_chain", 512, 256, ((61, 2),)).resident


def test_a_width_no_build_launches_raises_naming_the_limit():
    # H = 1056 (since the chains took H = 1024, the widest the configs run):
    # A per block over its registers, F per block over its launch bounds,
    # and no chain takes a width that is not a multiple of 64 there
    with pytest.raises(_layout.LaunchLimitError, match="registers.*__launch_bounds__"):
        _layout.config_route(Config(lstm_size=1056))
    # off the card both routes run the plain versions
    assert _layout.config_route(Config(lstm_size=1056), on_card=False) == "narrow"
    with pytest.raises(_layout.LaunchLimitError, match="multiple of 32"):
        _layout.require("F", 48, 0)
    assert "shared memory" in _layout.launch_limit("G", 512, 300_000)
    model = MidiVAE.__new__(MidiVAE)
    model.cfg = Config(lstm_size=1056)
    with pytest.raises(_layout.LaunchLimitError, match="H=1056"):
        model.train_route(torch.device("cuda"))
    assert model.train_route(torch.device("cpu")) == "narrow"
    model.cfg = Config(lstm_size=1024)
    assert model.train_route(torch.device("cuda")) == "wide"


def test_ptxas_report_is_parsed():
    text = (
        "ptxas info    : Compiling entry function '_ZN3mvt15some_kernelEii' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN3mvt15some_kernelEii\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 128 registers, 384 bytes cmem[0]\n")
    assert _build.parse_ptxas(text) == {
        "_ZN3mvt15some_kernelEii": {"registers": 128, "spill_stores": 4, "spill_loads": 4}}


def test_wide_params_bridge_bit_equal():
    """The wide model's parameters: the port's numpy init equals the JAX
    package's at lstm_size = 512, and the bridge round-trips them. Both
    inits run numpy's QR (the orthogonal init) on one BLAS thread: OpenBLAS
    starts one thread a core, and beside the suite's other busy workers
    those threads wait on each other (1.1 s alone, 198 s beside five busy
    processes on eight cores; 5 s there on one thread)."""
    cfg = Config(lstm_size=512)
    key = np.array([0, cfg.seed], np.uint32)
    with threadpoolctl.threadpool_limits(limits=1, user_api="blas"):
        want = bridge.flatten(jax.tree_util.tree_map(np.asarray, JaxVAE(cfg).init_params(key)))
        model = MidiVAE(cfg)
    got = bridge.flatten(bridge.to_tree(model.params))
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert model.params["encoder"]["notes_rnn"][1]["u"].shape == (512, 1536)


def test_wide_ops_run_without_nvcc(tmp_path):
    """The wide route's CPU path imports and runs with no nvcc and no
    triton, builds nothing and counts no launch."""
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import torch\n"
        "from midi_vae_tpu_torch.ops import _build, gru_layer as gl, gru_decode as gd\n"
        "xp = torch.zeros(2, 3, 96, requires_grad=True); h = torch.zeros(3, 32)\n"
        "gl.gru_layer_train(xp, h, torch.zeros(32, 96), True).sum().backward()\n"
        "c = {'w': torch.zeros(4, 96), 'u': torch.zeros(32, 96, requires_grad=True), 'b': torch.zeros(96)}\n"
        "p, l = gd.gru_decode_train([c], {'w': torch.zeros(32, 4), 'b': torch.zeros(4)}, [h], torch.zeros(3, 4), 2, builds=('D_wide', 'E_wide'))\n"
        "(p.sum() + l.sum()).backward()\n"
        "assert xp.grad is not None and c['u'].grad is not None\n"
        "assert _build.load.cache_info().currsize == 0 and not _build.build_seconds\n"
        "assert gl.gru_layer_xp.launches == gl.gru_layer_xp_bwd.launches == 0\n"
        "assert gd.gru_decode_fwd_train_wide.launches == gd.gru_decode_bwd_wide.launches == 0\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path), PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")


def test_encode_sequence_wide_takes_the_projection_outside(monkeypatch):
    """At the wide route each encoder layer gets xp = x @ W + b (time-major)
    and runs gru_layer_train over it; the result equals the narrow layer's."""
    cfg = small_test_config()
    model = MidiVAE(cfg, MidiVAE(cfg).init_params(np.array([0, 8], np.uint32)), trainable=True)
    x = torch.from_numpy(make_batch(cfg)["X"])
    layers = model.params["encoder"]["notes_rnn"]
    spy = _Spy(monkeypatch, {"train": (port_rnn, "gru_layer_train"),
                             "train_x": (port_rnn, "gru_layer_train_x")})
    wide = port_rnn.encode_sequence(layers, x, "GRU", kernels=True, train=True, wide=True)
    narrow = port_rnn.encode_sequence(layers, x, "GRU", kernels=True, train=True)
    assert spy.count() == {"train": 2, "train_x": 2}
    xp = spy.calls["train"][0][0][0]
    assert xp.shape == (cfg.input_length, B, 3 * cfg.lstm_size)
    _close(wide, narrow.detach().numpy())
