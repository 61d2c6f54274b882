"""CPU parity of the port's LSTM training path against the JAX package.

The port's kernels L (with its c sequence), N, Q, R, S and W run their plain
PyTorch versions on CPU tensors; the JAX side runs its Pallas kernels in
interpret mode (``interpret=True`` on ``lstm_layer_train_x`` /
``lstm_layer_train`` / ``lstm_step``, ``MidiVAE._interpret = True``), with
``fused_train._FORCE_TRAIN_MODE`` set to ``"inplace"`` or ``"wide"`` where a
test takes one of its modes. Same numpy inputs, parameters and noise on both
sides. Tolerances (float32, sums in another order):
- forward values: atol 1e-5;
- gradients: atol 1e-5 + rtol 1e-4;
- the loss and every metric: atol 1e-5; every parameter gradient: atol 1e-5
  + rtol 1e-4 (as tests/test_torch_train.py);
- parameters after three Adam steps: atol 1e-5 + rtol 1e-4 (as
  tests/test_torch_train_loop.py).
Also the LSTM training dispatch on CUDA (decided from the device type, so no
card is needed), the route chooser and the launch limits of N, Q, R and S.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.config import Config, small_test_config
from midi_vae_tpu.models.cells import LSTMCell
from midi_vae_tpu.models.vae import MidiVAE as JaxVAE
from midi_vae_tpu.models.vae import loss_and_metrics as jax_loss
from midi_vae_tpu.ops import fused_lstm
from midi_vae_tpu.ops import fused_train as ft
from midi_vae_tpu.parallel import make_mesh
from midi_vae_tpu.training.trainer import VAETrainer as JaxTrainer
from midi_vae_tpu_torch import bridge
from midi_vae_tpu_torch.models import rnn as port_rnn
from midi_vae_tpu_torch.models import vae as port_vae
from midi_vae_tpu_torch.models.vae import MidiVAE, loss_and_metrics
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import grad_reduce as port_gr
from midi_vae_tpu_torch.ops import lstm_layer as port_layer
from midi_vae_tpu_torch.ops import lstm_step as port_step
from midi_vae_tpu_torch.training.trainer import VAETrainer, _slice_batch, pad_batch_to
from test_torch_train_loop import make_flat
from test_torch_wide import B, VALID, _Spy, make_batch

ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
LOSS_ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, rtol=0.0, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _layer_inputs(T, Bn, D, H, seed):
    rng = np.random.RandomState(seed)
    p = LSTMCell.init(np.array([3, seed], np.uint32), D, H)
    p["b"] = p["b"] + (0.1 * rng.randn(4 * H)).astype(np.float32)
    return ((0.5 * rng.randn(T, Bn, D)).astype(np.float32),
            (0.3 * rng.randn(Bn, H)).astype(np.float32),
            (0.3 * rng.randn(Bn, H)).astype(np.float32), p["w"], p["b"], p["u"])


# ---------------------------------------------------------------------------
# the layer ops: kernels L (with c), N, Q, R and W
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 16, 61])
@pytest.mark.parametrize("return_sequences", [True, False])
def test_lstm_layer_train_x_matches_jax(D, return_sequences):
    """lstm_layer_train_x's output and its grads for x, h0, c0, W, b and U
    against the JAX op (_lstm_fwdx_pallas + _lstm_bwdx_pallas, interpret
    mode), the cotangent that of sum(sin(out))."""
    args = _layer_inputs(6, 4, D, 16, D)
    want_out, vjp = jax.vjp(
        lambda *a: ft.lstm_layer_train_x(*a, "tanh", return_sequences, True),
        *map(jnp.asarray, args))
    want = vjp(jnp.cos(want_out))
    leaves = [_t(a).requires_grad_() for a in args]
    out = port_layer.lstm_layer_train_x(*leaves, return_sequences)
    _close(out, want_out)
    got = torch.autograd.grad(torch.sin(out).sum(), leaves)
    for name, g, w in zip(("x", "h0", "c0", "w", "b", "u"), got, want):
        _close(g, w, GRAD_RTOL, GRAD_ATOL, f"d{name}")
    assert all(getattr(port_layer, f).launches == 0 for f in port_layer.L_PHASES)
    assert port_layer.lstm_layer_bwd.launches == 0


@pytest.mark.parametrize("mode", ["inplace", "wide"])
@pytest.mark.parametrize("return_sequences", [True, False])
def test_lstm_layer_train_matches_jax(mode, return_sequences, monkeypatch):
    """lstm_layer_train over xp (kernels Q, R and W) against the JAX op in
    its in-place mode (_lstm_fwd_pallas, _lstm_bwd_pallas) and its wide mode
    (_lstm_fwd_wide_pallas, _lstm_bwd_wide_pallas + _lstm_wide_weight_grads,
    batch-tiled: the budget makes the JAX tiles real, as
    tests/test_ops_train.py::test_lstm_wide_gradient_parity)."""
    monkeypatch.setattr(ft, "_FORCE_TRAIN_MODE", mode)
    if mode == "wide":
        monkeypatch.setattr(ft, "_WIDE_BUDGET_BYTES", 27_000)
        assert 0 < ft._lstm_wide_btiles(16, 16, 4)[1] < 16
    rng = np.random.RandomState(4)
    T, Bn, H = 6, 16, 16
    args = ((0.3 * rng.randn(T, Bn, 4 * H)).astype(np.float32),
            (0.1 * rng.randn(Bn, H)).astype(np.float32),
            (0.1 * rng.randn(Bn, H)).astype(np.float32),
            (0.1 * rng.randn(H, 4 * H)).astype(np.float32))
    want_out, vjp = jax.vjp(lambda *a: ft.lstm_layer_train(*a, "tanh", return_sequences, True),
                            *map(jnp.asarray, args))
    want = vjp(jnp.cos(want_out))
    leaves = [_t(a).requires_grad_() for a in args]
    out = port_layer.lstm_layer_train(*leaves, return_sequences)
    _close(out, want_out)
    got = torch.autograd.grad(torch.sin(out).sum(), leaves)
    for name, g, w in zip(("xp", "h0", "c0", "u"), got, want):
        _close(g, w, GRAD_RTOL, GRAD_ATOL, f"{mode} d{name}")


def test_kernel_n_plain_version_matches_jax_bwdx():
    """Kernel N's plain version emits what _lstm_bwdx_pallas emits (dx, dh0,
    dc0) for a return-sequence layer from L's h and c sequences, and W over
    its gate grads gives the dW, db and dU that the TPU kernel sums."""
    x, h0, c0, w, b, u = _layer_inputs(5, 8, 12, 16, 7)
    hseq, cseq = port_layer.lstm_layer(*map(_t, (x, h0, c0, w, b, u)), "tanh", True, with_c=True)
    jh, jc = ft._lstm_fwdx_pallas(*map(jnp.asarray, (x, h0, c0, w, b, u)), "tanh", True)
    _close(hseq, jh)
    _close(cseq, jc)
    d_seq = np.random.RandomState(2).randn(*hseq.shape).astype(np.float32)
    want = ft._lstm_bwdx_pallas(*map(jnp.asarray, (x, hseq.numpy(), cseq.numpy(), h0, c0, d_seq,
                                                   np.zeros_like(h0), w, b, u)), True, True)
    dx, dh0, dc0, da = port_layer.lstm_layer_bwd_reference(
        _t(x), hseq, cseq, _t(h0), _t(c0), _t(d_seq), None, _t(w), _t(b), _t(u))
    dw, db, du = port_gr.lstm_weight_grads(_t(x), torch.cat([_t(h0)[None], hseq[:-1]]), da)
    for name, g, wnt in zip(("dx", "dh0", "dc0", "dw", "db", "du"), (dx, dh0, dc0, dw, db, du),
                            (want[0], want[1], want[2], want[3], want[4][0], want[5])):
        _close(g, wnt, GRAD_RTOL, GRAD_ATOL, name)


@pytest.mark.parametrize("T", [1, 2, 6])
def test_kernel_r_plain_version_matches_jax_bwd_wide(T):
    """Kernel R's plain version emits what _lstm_bwd_wide_pallas emits (the
    gate grads = dxp, dh0, dc0) for a last layer, and W's dU matches
    _lstm_wide_weight_grads."""
    rng = np.random.RandomState(20 + T)
    Bn, H = 8, 16
    xp = (0.3 * rng.randn(T, Bn, 4 * H)).astype(np.float32)
    h0, c0 = (0.1 * rng.randn(2, Bn, H)).astype(np.float32)
    u = (0.1 * rng.randn(H, 4 * H)).astype(np.float32)
    hseq, cseq = port_layer.lstm_layer_xp(_t(xp), _t(h0), _t(c0), _t(u))
    d_final = rng.randn(Bn, H).astype(np.float32)
    dacat, dh0, dc0 = ft._lstm_bwd_wide_pallas(
        *map(jnp.asarray, (xp, hseq.numpy(), cseq.numpy(), h0, c0, np.zeros_like(hseq[:1]),
                           d_final, u)), False, True, 8)
    want_du = ft._lstm_wide_weight_grads(jnp.asarray(hseq.numpy()), jnp.asarray(h0), dacat)
    da, got_dh0, got_dc0, da32 = port_layer.lstm_layer_xp_bwd_reference(
        _t(xp), hseq, cseq, _t(h0), _t(c0), None, _t(d_final), _t(u))
    assert da32 is da  # in float32 the gate grads are dxp
    _close(da, dacat, GRAD_RTOL, GRAD_ATOL)
    _close(got_dh0, dh0, GRAD_RTOL, GRAD_ATOL)
    _close(got_dc0, dc0, GRAD_RTOL, GRAD_ATOL)
    _close(port_gr.lstm_u_grad(torch.cat([_t(h0)[None], hseq[:-1]]), da), want_du, GRAD_RTOL,
           GRAD_ATOL)


@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "relu"])
def test_lstm_cell_step_matches_jax(activation):
    """lstm_cell_step's value and VJP (kernel S forward, the plain version's
    backward) against fused_lstm.lstm_step(..., interpret=True)."""
    rng = np.random.RandomState(9)
    Bn, D, H = 5, 12, 16
    p = LSTMCell.init(np.array([4, 1], np.uint32), D, H)
    args = ((0.5 * rng.randn(Bn, D)).astype(np.float32),
            (0.3 * rng.randn(Bn, H)).astype(np.float32),
            (0.3 * rng.randn(Bn, H)).astype(np.float32), p["w"], p["b"], p["u"])
    x, h, c, w, b, u = map(jnp.asarray, args)
    (wh, wc), vjp = jax.vjp(lambda *a: fused_lstm.lstm_step(a[0], a[1], a[2], a[3], a[5], a[4],
                                                           activation, True), x, h, c, w, b, u)
    want = vjp((jnp.cos(wh), -0.5 * jnp.sin(wc)))
    leaves = [_t(a).requires_grad_() for a in args]
    gh, gc = port_step.lstm_cell_step(*leaves, activation)
    _close(gh, wh)
    _close(gc, wc)
    got = torch.autograd.grad(torch.sin(gh).sum() + 0.5 * torch.cos(gc).sum(), leaves)
    for name, g, wnt in zip(("x", "h", "c", "w", "b", "u"), got, want):
        _close(g, wnt, GRAD_RTOL, GRAD_ATOL, f"{activation} d{name}")
    assert port_step.lstm_cell_step_fwd.launches == 0


# ---------------------------------------------------------------------------
# the whole LSTM training step
# ---------------------------------------------------------------------------

def _jax_step(cfg, params, batch):
    jm = JaxVAE(cfg)
    jm._interpret = True
    key = jax.random.PRNGKey(1)
    fn = jax.value_and_grad(lambda p, b: jax_loss(jm, p, b, key, cfg.epsilon_std), has_aux=True)
    (loss, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    noise = np.asarray(cfg.epsilon_std * jax.random.normal(key, (B, cfg.latent_dim), jnp.float32))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            bridge.flatten(jax.tree_util.tree_map(np.asarray, grads)), noise)


def _kernel_spy(monkeypatch):
    """One entry per kernel a CUDA run would launch, on the CPU path."""
    return _Spy(monkeypatch, {
        "L": (port_layer, "lstm_layer"), "N": (port_layer, "lstm_layer_bwd"),
        "Q": (port_layer, "lstm_layer_xp"), "R": (port_layer, "lstm_layer_xp_bwd"),
        "S": (port_step, "lstm_cell_step_fwd"), "W": (port_gr, "grad_reduce"),
    })


# per step of small_test_config(cell_type="LSTM"): 4 encoder layers (notes
# 2, instrument, velocity), S per cell and step (notes 2 x 8, velocity 8,
# instrument 2), W 2 per layer (dW with db, dU) or 1 (dU: dW and db are
# autograd over xp = x @ W + b on the wide route)
STEP_LAUNCHES = {"narrow": {"L": 4, "N": 4, "S": 26, "W": 8},
                 "wide": {"Q": 4, "R": 4, "S": 26, "W": 4}}

LSTM_CONFIGS = {
    "default": ({"cell_type": "LSTM"}, "narrow"),
    "wide": ({"cell_type": "LSTM"}, "wide"),
    # the notes head's plain teacher-forced scan beside S for the others
    "teacher_force": ({"cell_type": "LSTM", "teacher_force": True}, None),
    # relu cells: the encoder takes the plain scan, the heads S
    "relu_cells": ({"cell_type": "LSTM", "lstm_activation": "relu"}, None),
    # the heads one after another through S: the JAX package's merged scan
    "merge_decoder_scans": ({"cell_type": "LSTM", "merge_decoder_scans": True}, "narrow"),
}


@pytest.mark.parametrize("name", sorted(LSTM_CONFIGS))
def test_lstm_loss_and_every_gradient_match_jax(name, monkeypatch):
    """loss_and_metrics and every parameter gradient of the LSTM model, with
    padding rows and the noise injected, against the JAX model with its
    kernel tier in interpret mode (its wide mode for "wide": the
    in-kernel-projection layer refused, as at H = 512); one step calls each
    kernel as the design says."""
    overrides, route = LSTM_CONFIGS[name]
    cfg = small_test_config(**overrides)
    if name == "wide":
        monkeypatch.setattr(ft, "_FORCE_TRAIN_MODE", "wide")
        monkeypatch.setattr(ft, "_lstm_x_use_pallas", lambda *a: False)
        monkeypatch.setattr(_layout, "FORCE_ROUTE", "wide")
    params = jax.tree_util.tree_map(np.asarray, JaxVAE(cfg).init_params(jax.random.PRNGKey(11)))
    batch = make_batch(cfg, seed=3)
    want_loss, want_metrics, want_grads, noise = _jax_step(cfg, params, batch)
    spy = _kernel_spy(monkeypatch)
    model = MidiVAE(cfg, params, trainable=True)
    tb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    loss, metrics = loss_and_metrics(model, tb, noise=torch.from_numpy(noise.copy()))
    named = list(model.params.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=0, atol=LOSS_ATOL)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=0, atol=LOSS_ATOL, err_msg=k)
    got = {k.replace(".", "/"): g for (k, _), g in zip(named, grads)}
    assert sorted(got) == sorted(want_grads)
    for k, w in want_grads.items():
        g = np.zeros_like(w) if got[k] is None else got[k].numpy()
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"{name}: {k}")
    if route is not None:
        assert spy.count() == STEP_LAUNCHES[route]


def test_padding_rows_do_not_move_the_lstm_loss():
    """Rows with M = 0 contribute nothing: changing them leaves the loss and
    every gradient bit-equal on the LSTM training path."""
    cfg = small_test_config(cell_type="LSTM")
    params = MidiVAE(cfg).init_params(np.array([0, 5], np.uint32))
    batch = make_batch(cfg, seed=1)
    other = {k: v.copy() for k, v in batch.items()}
    other["X"][VALID:] = np.eye(cfg.input_dim, dtype=np.float32)[0]
    other["V"][VALID:] = 0.7
    out = []
    for b in (batch, other):
        model = MidiVAE(cfg, params, trainable=True)
        loss, _ = loss_and_metrics(model, {k: torch.from_numpy(v.copy()) for k, v in b.items()},
                                   noise=torch.zeros(B, cfg.latent_dim))
        out.append((loss, torch.autograd.grad(loss, list(model.params.parameters()),
                                              allow_unused=True)))
    assert out[0][0].item() == out[1][0].item()
    for a, b in zip(out[0][1], out[1][1]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_three_lstm_train_steps_match_jax():
    """Three Adam steps of the LSTM model on the same batches and noise as
    the JAX trainer (its kernels in interpret mode): losses and parameters."""
    cfg = small_test_config(batch_size=4, cell_type="LSTM")
    flat = make_flat(cfg)
    jt = JaxTrainer(cfg, mesh=make_mesh(devices=[jax.devices()[0]]))
    jt.model._interpret = True
    jstate = jt.init_state()
    port = VAETrainer(cfg, "cpu")
    state = port.new_state(jax.tree_util.tree_map(np.asarray, jstate.params))
    rng, p, o = jstate.rng, jstate.params, jstate.opt_state
    H = np.random.RandomState(1).randn(flat.num_windows, cfg.latent_dim).astype(np.float32)
    for step, idx in enumerate(([0, 5, 2, 7], [1, 3, 8, 9], [4, 6])):
        batch, mask = pad_batch_to(_slice_batch(flat, np.array(idx), cfg, H), cfg.batch_size)
        batch["M"] = mask
        _next, sample_key = jax.random.split(rng)
        noise = cfg.epsilon_std * jax.random.normal(sample_key, (cfg.batch_size, cfg.latent_dim))
        p, o, rng, jm = jt.train_step(p, o, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        pm = port.train_step(state, {k: torch.from_numpy(v.copy()) for k, v in batch.items()},
                             torch.from_numpy(np.asarray(noise).copy()))
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=0, atol=LOSS_ATOL,
                                   err_msg=f"step {step}")
    want = bridge.flatten(jax.tree_util.tree_map(np.asarray, p))
    got = bridge.flatten(bridge.to_tree(state.model.params))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# the dispatch on CUDA, decided from the device type
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overrides", [{}, {"merge_decoder_scans": True},
                                       {"fused_train_decoder": False},
                                       {"teacher_force": True}, {"lstm_activation": "relu"}],
                         ids=["default", "merge_decoder_scans", "no_fused_decoder",
                              "teacher_force", "relu_cells"])
def test_lstm_training_takes_the_kernels_on_cuda(overrides):
    """LSTM training no longer raises on CUDA: the JAX package decodes its
    LSTM heads step by step (fused_step) whatever merge_decoder_scans and
    fused_train_decoder say, and with any cell activation."""
    model = MidiVAE(small_test_config(cell_type="LSTM", **overrides))
    assert model.train_kernels_enabled(torch.device("cuda")) is True
    assert model.train_kernels_enabled(torch.device("cpu")) is True
    assert model.decode_step(True) is not None


@pytest.mark.parametrize("overrides, rows", [
    # S xp (row 31) is ported: the encoder takes it per step
    ({"fused_train_encoder": False}, None),
    # bf16 with the default flags runs the encoder's L, N and W (or Q, R and
    # W) in bf16 (rows 15-20); without fused_train_encoder the whole-scan
    # kernel Y (rows 32 and 33) and S's bf16 build; all ported
    ({"compute_dtype": "bfloat16"}, None),
    ({"fused_train_encoder": False, "compute_dtype": "bfloat16"}, None),
], ids=["no_fused_encoder", "bfloat16", "bfloat16_no_fused_encoder"])
def test_unported_lstm_training_raises_naming_its_rows(overrides, rows):
    model = MidiVAE(small_test_config(cell_type="LSTM", **overrides))
    if rows is None:
        for device in ("cuda", "cpu"):
            assert model.train_kernels(torch.device(device)) == (True, True)
        return
    with pytest.raises(NotImplementedError, match=rows):
        model.train_kernels_enabled(torch.device("cuda"))
    assert model.train_kernels_enabled(torch.device("cpu")) is False


@pytest.mark.parametrize("overrides, head, n_layers", [
    ({"num_layers_decoder": 3}, "notes", 3),
    ({"meta_velocity_activation": "relu"}, "velocity", 1),
], ids=["three_layer_notes_head", "relu_output_velocity_head"])
def test_lstm_heads_kernel_m_does_not_take_serve_through_s(overrides, head, n_layers,
                                                          monkeypatch):
    """A 3-layer LSTM head and a relu-output head serve through kernel S per
    cell and step on CUDA (no raise), and match the JAX model on the CPU."""
    cfg = small_test_config(cell_type="LSTM", **overrides)
    jm = JaxVAE(cfg)
    jm._interpret = True
    params = jm.init_params(jax.random.PRNGKey(6))
    model = MidiVAE(cfg, jax.tree_util.tree_map(np.asarray, params))
    out_act = cfg.activation if head == "notes" else cfg.meta_velocity_activation
    assert model.serving_head_kernel(head, n_layers, out_act, torch.device("cuda")) is False
    z = np.random.RandomState(0).randn(3, cfg.latent_dim).astype(np.float32)
    want = jm.decode(params, jnp.asarray(z), inference=True)
    spy = _Spy(monkeypatch, {"S": (port_step, "lstm_cell_step_fwd"),
                             "M": (port_vae, "lstm_decode")})
    with torch.inference_mode():
        got = model.decode(_t(z))
    T = cfg.output_length if head == "notes" else cfg.meta_velocity_length
    assert spy.count()["S"] == n_layers * T
    for name, (probs, logits) in got.items():
        _close(probs, want[name][0], msg=name)
        _close(logits, want[name][1], msg=name)


def test_gru_per_step_heads_still_raise_on_cuda():
    """A GRU serving head that kernel B does not take (3 layers, or a relu
    output) no longer raises on CUDA: it runs kernel T per cell and step
    (row 28), as LSTM heads run S."""
    model = MidiVAE(small_test_config())
    cuda = torch.device("cuda")
    assert model.serving_head_kernel("notes", 3, "softmax", cuda) is False
    assert model.serving_head_kernel("velocity", 1, "relu", cuda) is False
    step = model.decode_step(model.kernels_enabled(cuda))
    assert step.__qualname__.startswith("make_decoder_step") and step.__module__.endswith("gru_step")


def test_lstm_route_at_256_and_512():
    """The LSTM switches routes at 256 (the JAX package's in-kernel
    projection is pinned off at 512); the judges' layers take the same
    chooser."""
    assert _layout.config_route(Config(cell_type="LSTM")) == "narrow"
    assert _layout.config_route(Config(cell_type="LSTM", lstm_size=512)) == "wide"
    layers = [(61, False), (256, True)]
    assert _layout.train_route(256, layers, [], cell_type="LSTM") == "narrow"
    with pytest.raises(_layout.LaunchLimitError, match="H=1024"):
        _layout.config_route(Config(cell_type="LSTM", lstm_size=1024))
    assert _layout.config_route(Config(cell_type="LSTM", lstm_size=1024), on_card=False) == "wide"


@pytest.mark.parametrize("H", [256, 512])
def test_layout_of_n_q_r_and_s(H):
    """N, Q, R and S launch at the LSTM model's widths; S's tile ring is
    what the kernel allocates (gemm_tc.cuh's four stages of A and B), N's
    and R's chain (their serial phase) and Q's forward chain run on clusters
    whose plans fit a block's shared memory
    (``tests/test_torch_lstm_bptt_phases.py`` and
    ``tests/test_torch_lstm_fwd_chain.py`` hold the plans); S stops at 512
    (``STEP_MAX_H``), R's and Q's bf16 chains do not fit at 1024."""
    plan = _layout.fwd_plan("Q", H, B)
    assert plan.smem == _layout.fwd_chain_smem(H, plan.cluster, plan.rows, plan.splits,
                                               plan.stages, 4)
    step = _layout.step_plan(B, 61, H)
    assert step.smem == 4 * 4 * (step.rows * 20 + 16 * (4 * step.units + 8)) <= 48 * 1024
    assert step.threads == 8 * step.units and step.blocks == -(-B // step.rows) * (H // step.units)
    for kernel in ("N", "Q", "R", "S", "S_bf16"):
        assert _layout.launch_limit(kernel, H, 0) is None, kernel
    for kernel in ("N", "R"):
        assert _layout.bptt_plan(kernel, H, B).smem <= _layout.SMEM_PER_BLOCK
    assert plan.smem <= _layout.SMEM_PER_BLOCK
    assert "up to 512" in _layout.launch_limit("S", 1024, 0)
    assert "shared memory" in _layout.launch_limit("Q_bf16", 1024, 0)
    assert "shared memory" in _layout.launch_limit("R_bf16", 1024, 0)


def test_encode_sequence_lstm_routes(monkeypatch):
    """On the training path an LSTM layer runs lstm_layer_train_x (narrow)
    or xp = x @ W + b and lstm_layer_train (wide); both give the same h."""
    cfg = small_test_config(cell_type="LSTM")
    model = MidiVAE(cfg, MidiVAE(cfg).init_params(np.array([0, 8], np.uint32)), trainable=True)
    x = torch.from_numpy(make_batch(cfg)["X"])
    layers = model.params["encoder"]["notes_rnn"]
    spy = _Spy(monkeypatch, {"train": (port_rnn, "lstm_layer_train"),
                             "train_x": (port_rnn, "lstm_layer_train_x")})
    wide = port_rnn.encode_sequence(layers, x, "LSTM", kernels=True, train=True, wide=True)
    narrow = port_rnn.encode_sequence(layers, x, "LSTM", kernels=True, train=True)
    assert spy.count() == {"train": 2, "train_x": 2}
    assert spy.calls["train"][0][0][0].shape == (cfg.input_length, B, 4 * cfg.lstm_size)
    _close(wide, narrow.detach().numpy())


def test_lstm_ops_refuse_what_the_kernels_do_not_take():
    x, h = torch.zeros(3, 2, 4), torch.zeros(2, 32)
    w, b, u = torch.zeros(4, 128), torch.zeros(128), torch.zeros(32, 128)
    with pytest.raises(ValueError, match="cseq has shape"):
        port_layer.lstm_layer_bwd(x, torch.zeros(3, 2, 32), torch.zeros(3, 3, 32), h, h, None,
                                  None, w, b, u)
    with pytest.raises(ValueError, match="xp must be"):
        port_layer.lstm_layer_xp(torch.zeros(2, 128), h, h, u)
    with pytest.raises(ValueError, match="activation"):
        port_step.lstm_cell_step_fwd(x[0], h, h, w, b, u, "elu")
    with pytest.raises(ValueError, match="u has shape"):
        port_step.lstm_cell_step_fwd(x[0], h, h, w, b, torch.zeros(32, 96))


def test_lstm_training_ops_run_without_nvcc(tmp_path):
    """The LSTM training ops' CPU path imports and runs with no nvcc, builds
    nothing and counts no launch."""
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import torch\n"
        "from midi_vae_tpu_torch.ops import _build, lstm_layer as ll, lstm_step as ls\n"
        "x = torch.zeros(2, 3, 4, requires_grad=True); h = torch.zeros(3, 32)\n"
        "w, b = torch.zeros(4, 128, requires_grad=True), torch.zeros(128)\n"
        "u = torch.zeros(32, 128, requires_grad=True)\n"
        "ll.lstm_layer_train_x(x, h, h, w, b, u, True).sum().backward()\n"
        "xp = torch.zeros(2, 3, 128, requires_grad=True)\n"
        "ll.lstm_layer_train(xp, h, h, u).sum().backward()\n"
        "sum(t.sum() for t in ls.lstm_cell_step(x[0], h, h, w, b, u, 'relu')).backward()\n"
        "assert x.grad is not None and xp.grad is not None and u.grad is not None\n"
        "assert _build.load.cache_info().currsize == 0 and not _build.build_seconds\n"
        "assert all(getattr(ll, f).launches == 0 for f in ll.L_PHASES)\n"
        "assert ll.lstm_layer_bwd.launches == 0\n"
        "assert ll.lstm_layer_xp.launches == ll.lstm_layer_xp_bwd.launches == 0\n"
        "assert ls.lstm_cell_step_fwd.launches == 0\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path), PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
