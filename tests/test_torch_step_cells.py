"""CPU parity of the per-step cells (kernels T, T xp and S xp: rows 28, 29
and 31) and of the configs that run them, against the JAX package.

The JAX side runs its Pallas kernels in interpret mode (``interpret=True``
for the cells, ``MidiVAE._interpret = True`` for the model); the port runs
the same dispatch with the kernels' plain versions (CPU tensors). Same numpy
inputs and noise on both sides. Tolerances (float32, sums in another order):
- the cells' values and the decoded heads: rtol 0, atol 2e-6;
- the cells' VJPs: atol 1e-5 + rtol 1e-4;
- the loss and every metric: atol 1e-5; every parameter gradient: atol 1e-5
  + rtol 1e-4 (as tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.models import rnn as jax_rnn
from midi_vae_tpu.models.cells import GRUCell, LSTMCell
from midi_vae_tpu.models.vae import MidiVAE as JaxVAE
from midi_vae_tpu.ops import fused_gru, fused_lstm
from midi_vae_tpu.ops import fused_train as ft
from midi_vae_tpu_torch.models import rnn as port_rnn
from midi_vae_tpu_torch.models import vae as port_vae
from midi_vae_tpu_torch.models.vae import MidiVAE
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import gru_decode as port_decode
from midi_vae_tpu_torch.ops import gru_layer as port_layer
from midi_vae_tpu_torch.ops import gru_step as port_gru_step
from midi_vae_tpu_torch.ops import lstm_layer as port_lstm_layer
from midi_vae_tpu_torch.ops import lstm_step as port_lstm_step
from test_torch_wide import B, _assert_step_matches, _jax_step, _port_step, _Spy, make_batch

ATOL = 2e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
ACTIVATIONS = ["tanh", "sigmoid", "relu"]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, rtol=0.0, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# the cells: value and VJP against fused_gru / fused_lstm in interpret mode
# ---------------------------------------------------------------------------

def _cell_case(kind, activation, Bn=5, D=12, H=16):
    """(port function, its numpy args, the JAX function over jnp args, arg
    names) of one cell."""
    rng = np.random.RandomState(7)
    cell = LSTMCell if kind == "lstm_xp" else GRUCell
    p = cell.init(np.array([3, 1], np.uint32), D, H)
    h = (0.3 * rng.randn(Bn, H)).astype(np.float32)
    if kind == "gru":
        x = (0.5 * rng.randn(Bn, D)).astype(np.float32)
        return (lambda *a: port_gru_step.gru_cell_step(*a, activation),
                (x, h, p["w"], p["b"], p["u"]),
                lambda x, h, w, b, u: fused_gru.gru_step(x, h, w, u, b, activation, True),
                ("x", "h", "w", "b", "u"))
    xp = (0.5 * rng.randn(Bn, p["u"].shape[1])).astype(np.float32)
    if kind == "gru_xp":
        return (lambda *a: port_gru_step.gru_recurrent_step(*a, activation), (xp, h, p["u"]),
                lambda xp, h, u: fused_gru.gru_recurrent_step(xp, h, u, activation, True),
                ("xp", "h", "u"))
    c = (0.3 * rng.randn(Bn, H)).astype(np.float32)
    return (lambda *a: port_lstm_step.lstm_recurrent_step(*a, activation), (xp, h, c, p["u"]),
            lambda xp, h, c, u: fused_lstm.lstm_recurrent_step(xp, h, c, u, activation, True),
            ("xp", "h", "c", "u"))


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("kind", ["gru", "gru_xp", "lstm_xp"])
def test_cell_value_and_vjp_match_jax(kind, activation):
    """T (gru_cell_step), T xp (gru_recurrent_step) and S xp
    (lstm_recurrent_step): forward through the kernel's plain version,
    backward through the plain version recomputed under autograd, against
    the JAX cells (their Pallas kernels in interpret mode) and jax.vjp."""
    port_fn, args, jax_fn, names = _cell_case(kind, activation)
    want, vjp = jax.vjp(jax_fn, *map(jnp.asarray, args))
    want = want if isinstance(want, tuple) else (want,)
    cot = [jnp.cos(w) * (k + 1) for k, w in enumerate(want)]
    want_grads = vjp(tuple(cot) if len(cot) > 1 else cot[0])
    leaves = [_t(a).requires_grad_() for a in args]
    got = port_fn(*leaves)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        _close(g, w, msg=f"{kind} {activation}")
    grads = torch.autograd.grad(got, leaves, [_t(c) for c in cot])
    for name, g, w in zip(names, grads, want_grads):
        _close(g, w, GRAD_RTOL, GRAD_ATOL, f"{kind} {activation} d{name}")
    assert port_gru_step.gru_cell_step_fwd.launches == 0
    assert port_gru_step.gru_recurrent_step_fwd.launches == 0
    assert port_lstm_step.lstm_recurrent_step_fwd.launches == 0


def test_cells_refuse_what_the_kernels_do_not_take():
    h, u = torch.zeros(3, 32), torch.zeros(32, 96)
    with pytest.raises(ValueError, match="activation"):
        port_gru_step.gru_cell_step_fwd(torch.zeros(3, 4), h, torch.zeros(4, 96),
                                        torch.zeros(96), u, "elu")
    with pytest.raises(ValueError, match="xp has shape"):
        port_gru_step.gru_recurrent_step_fwd(torch.zeros(3, 64), h, u)
    with pytest.raises(ValueError, match="u has shape"):
        port_lstm_step.lstm_recurrent_step_fwd(torch.zeros(3, 128), h, h, u)


@pytest.mark.parametrize("H", [256, 512, 1024])
def test_layout_of_t_t_xp_and_s_xp(H):
    """T and T xp launch at the models' widths (256, 512) on their cluster
    plans (``gru_step_plan``: at most 16 CTAs a cluster, the shared memory
    within a CTA's), and S xp on its tile plan (no x segment: the same tiles
    as S); at 1024 T's and S xp's plans stop at ``STEP_MAX_H``."""
    for kernel in ("T", "T_xp", "S_xp"):
        why = _layout.launch_limit(kernel, H, 0)
        if H <= 512:
            assert why is None, kernel
        else:
            assert "up to 512" in why
            with pytest.raises(_layout.LaunchLimitError):
                _layout.require(kernel, H, 0)
    for D, xp in ((61, False), (H, False), (0, True)):
        if H <= 512:
            plan = _layout.gru_step_plan(B, D, H, 4, xp)
            assert plan.cluster * plan.units == H and plan.cluster <= 16
            assert plan.smem == _layout.gru_step_smem(D, H, plan.rows, plan.units, 4, xp)
            assert plan.smem <= _layout.SMEM_PER_BLOCK
        else:
            with pytest.raises(_layout.LaunchLimitError, match="up to 512"):
                _layout.gru_step_plan(B, D, H, 4, xp)
    if H <= 512:
        plan = _layout.step_plan(B, 0, H)
        assert _layout.STEP_TILES[plan.tile] == (plan.rows, plan.units)
        assert plan.smem == _layout.step_smem(plan.rows, plan.units) and plan.threads == 8 * plan.units
    else:
        with pytest.raises(_layout.LaunchLimitError, match="up to 512"):
            _layout.step_plan(B, 0, H)


# ---------------------------------------------------------------------------
# decode_heads_merged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell_type", ["GRU", "LSTM"])
def test_decode_heads_merged_matches_jax(cell_type):
    """Three heads (2-layer softmax, 1-layer sigmoid, 1-layer relu) in one
    loop through the per-step cell (T or S; their plain versions here),
    against the JAX merged scan with its fused_step in interpret mode."""
    rng = np.random.RandomState(2)
    cell = LSTMCell if cell_type == "LSTM" else GRUCell
    Bn, H, T = 4, 16, 6
    heads = {}
    for k, (name, D, n, out_act) in enumerate((("notes", 9, 2, "softmax"),
                                               ("velocity", 1, 1, "sigmoid"),
                                               ("held", 2, 1, "relu"))):
        cells = [cell.init(np.array([k, i], np.uint32), D if i == 0 else H, H) for i in range(n)]
        out = {"w": (0.3 * rng.randn(H, D)).astype(np.float32), "b": np.zeros(D, np.float32)}
        states = tuple(tuple((0.3 * rng.randn(Bn, H)).astype(np.float32)
                             for _ in range(cell.num_states)) for _ in range(n))
        heads[name] = {"cells": cells, "out": out, "init_states": states,
                       "start": np.zeros((Bn, D), np.float32), "out_activation": out_act}
    jax_step = (fused_lstm if cell_type == "LSTM" else fused_gru).make_fused_decoder_step(
        "tanh", True)

    def tree(convert):
        return {n: dict(jax.tree_util.tree_map(convert, {k: v for k, v in h.items()
                                                          if k != "out_activation"}),
                        out_activation=h["out_activation"]) for n, h in heads.items()}

    want = jax_rnn.decode_heads_merged(tree(jnp.asarray), T, cell_type, fused_step=jax_step)
    ops = port_lstm_step if cell_type == "LSTM" else port_gru_step
    got = port_rnn.decode_heads_merged(tree(_t), T, cell_type, step=ops.make_decoder_step("tanh"))
    for name in heads:
        for g, w in zip(got[name], want[name]):
            _close(g, w, msg=name)


# ---------------------------------------------------------------------------
# the training step of the configs that run the per-step cells
# ---------------------------------------------------------------------------

def _step_spy(monkeypatch):
    """One entry per kernel a CUDA run would launch, on the CPU path."""
    return _Spy(monkeypatch, {
        "A": (port_layer, "gru_layer"), "C": (port_layer, "gru_layer_bwd"),
        "F": (port_layer, "gru_layer_xp"),
        "D": (port_decode, "gru_decode_fwd_train"), "E": (port_decode, "gru_decode_bwd"),
        "D_wide": (port_decode, "gru_decode_fwd_train_wide"),
        "L": (port_lstm_layer, "lstm_layer"),
        "S": (port_lstm_step, "lstm_cell_step_fwd"),
        "S_xp": (port_lstm_step, "lstm_recurrent_step_fwd"),
        "T": (port_gru_step, "gru_cell_step_fwd"),
        "T_xp": (port_gru_step, "gru_recurrent_step_fwd"),
    })


# small_test_config: T = 8 output steps, an instrument head of 2 steps; the
# encoder's notes layers run 8 steps, the instrument layer 2 (max_voices),
# the velocity layer 8. Per step: (overrides, forward launches the design
# implies, whether the route is forced wide)
STEP_CONFIGS = {
    # the notes and velocity heads merged through T (2 x 8 + 8), the
    # instrument head through D and E
    "merge_decoder_scans": ({"merge_decoder_scans": True}, {"A": 4, "C": 4, "T": 24, "D": 1,
                                                            "E": 1}, False),
    # the encoder per step through T xp (8 + 8 + 2 + 8), the heads as usual
    "no_fused_encoder": ({"fused_train_encoder": False}, {"T_xp": 26, "D": 2, "E": 2}, False),
    # every head through T (2 x 8 + 8 + 2)
    "no_fused_decoder": ({"fused_train_decoder": False}, {"A": 4, "C": 4, "T": 26}, False),
    "no_fused_train": ({"fused_train_encoder": False, "fused_train_decoder": False},
                       {"T_xp": 26, "T": 26}, False),
    "lstm_no_fused_train": ({"cell_type": "LSTM", "fused_train_encoder": False,
                             "fused_train_decoder": False}, {"S_xp": 26, "S": 26}, False),
    # the encoder keeps the plain scan (the whole-layer kernels take tanh
    # only), the heads take T with sigmoid cells
    "sigmoid_no_fused_decoder": ({"lstm_activation": "sigmoid", "fused_train_decoder": False},
                                 {"T": 26}, False),
    # under fused_train_decoder a 3-layer notes head takes the plain scan
    # (_dec_mode "scan"), the other heads D and E; a relu-output head takes T
    "three_layer_notes_head": ({"num_layers_decoder": 3}, {"A": 4, "C": 4, "D": 2, "E": 2},
                               False),
    "relu_velocity_head": ({"meta_velocity_activation": "relu"},
                           {"A": 4, "C": 4, "D": 2, "E": 2, "T": 8}, False),
    # the wide route: F + G per layer, the merged heads through T, the
    # instrument head through the wide D and E
    "wide_merge_decoder_scans": ({"merge_decoder_scans": True}, {"F": 4, "T": 24, "D_wide": 1},
                                 True),
}


@pytest.mark.parametrize("name", sorted(STEP_CONFIGS))
def test_loss_and_every_gradient_match_jax(name, monkeypatch):
    """loss_and_metrics and every parameter gradient, with padding rows and
    the noise injected, against the JAX model with its kernel tier in
    interpret mode; one forward calls each kernel as the design says."""
    overrides, launches, wide = STEP_CONFIGS[name]
    cfg = small_test_config(**overrides)
    if wide:
        monkeypatch.setattr(ft, "_FORCE_TRAIN_MODE", "wide")
        monkeypatch.setattr(ft, "_x_use_pallas", lambda *a: False)
        monkeypatch.setattr(ft, "_mh_use_pallas", lambda *a: False)
        monkeypatch.setattr(_layout, "FORCE_ROUTE", "wide")
    params = jax.tree_util.tree_map(np.asarray, JaxVAE(cfg).init_params(jax.random.PRNGKey(13)))
    batch = make_batch(cfg, seed=5)
    want = _jax_step(cfg, params, batch)
    spy = _step_spy(monkeypatch)
    _assert_step_matches(cfg, params, batch, want)
    # the backward kernels run once per forward launch of a whole-layer or
    # whole-head kernel; the per-step cells' backward is plain autograd
    assert {k: v for k, v in spy.count().items() if k not in ("C", "E")} == {
        k: v for k, v in launches.items() if k not in ("C", "E")}
    assert spy.count().get("C", 0) == launches.get("C", 0)
    assert spy.count().get("E", 0) == launches.get("E", 0)


# ---------------------------------------------------------------------------
# serving heads that kernel B does not take, and the decode_residual_bf16 gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overrides, head, n_layers", [
    ({"num_layers_decoder": 3}, "notes", 3),
    ({"meta_velocity_activation": "relu"}, "velocity", 1),
], ids=["three_layer_notes_head", "relu_output_velocity_head"])
def test_gru_heads_kernel_b_does_not_take_serve_through_t(overrides, head, n_layers,
                                                         monkeypatch):
    """A 3-layer GRU head and a relu-output head serve through kernel T per
    cell and step, the other heads through B, and match the JAX model's
    decode(inference=True) (its fused_step and decode kernels in interpret
    mode)."""
    cfg = small_test_config(**overrides)
    jm = JaxVAE(cfg)
    jm._interpret = True
    params = jm.init_params(jax.random.PRNGKey(6))
    model = MidiVAE(cfg, jax.tree_util.tree_map(np.asarray, params))
    out_act = cfg.activation if head == "notes" else cfg.meta_velocity_activation
    assert model.serving_head_kernel(head, n_layers, out_act, torch.device("cuda")) is False
    z = np.random.RandomState(0).randn(3, cfg.latent_dim).astype(np.float32)
    want = jm.decode(params, jnp.asarray(z), inference=True)
    spy = _Spy(monkeypatch, {"T": (port_gru_step, "gru_cell_step_fwd"),
                             "B": (port_vae, "gru_decode")})
    with torch.inference_mode():
        got = model.decode(_t(z))
    T = cfg.output_length if head == "notes" else cfg.meta_velocity_length
    assert spy.count() == {"T": n_layers * T, "B": 2}
    for name, (probs, logits) in got.items():
        _close(probs, want[name][0], msg=name)
        _close(logits, want[name][1], msg=name)


@pytest.mark.parametrize("overrides, raises", [
    ({}, True),
    ({"merge_decoder_scans": True}, False),
    ({"fused_train_decoder": False}, False),
    ({"teacher_force": True}, False),
    ({"lstm_activation": "sigmoid"}, False),
    ({"cell_type": "LSTM"}, False),
], ids=["multihead", "merged", "no_fused_decoder", "teacher_force", "sigmoid_cells", "lstm"])
def test_decode_residual_bf16_raises_where_the_multihead_kernel_runs(overrides, raises,
                                                                     monkeypatch):
    """decode_residual_bf16 acts in the JAX package only where its
    multi-head kernel runs (models/vae.py:395-401, :560-572): there the port
    stores the multi-head call's h sequences in bf16 (D's and E's
    bf16-residual builds: ``raises`` names the cases where the flag acts,
    which raised on CUDA before those builds), on CUDA as on the CPU;
    elsewhere the flag is a no-op as in the JAX package. One CPU step's
    spies show which. Off the narrow route the TPU still runs the call: the
    CPU runs its plain versions and the card raises, as no build of rows 5
    and 6 launches there."""
    cfg = small_test_config(decode_residual_bf16=True, **overrides)
    params = MidiVAE(cfg).init_params(np.array([0, 2], np.uint32))
    model = MidiVAE(cfg, params)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert model.train_kernels(cuda) == model.train_kernels(cpu)
    assert model.train_kernels(cuda)[0] is True

    def d_builds():
        spy = _Spy(monkeypatch, {"D": (port_decode, "gru_decode_fwd_train")})
        _port_step(cfg, params, make_batch(cfg), np.zeros((B, cfg.latent_dim), np.float32))
        return [a[1] for a, _ in spy.calls["D"]]

    assert ("D_resid" in d_builds()) is raises
    if raises:
        monkeypatch.setattr(_layout, "FORCE_ROUTE", "wide")
        assert "D_resid" in d_builds()
        with pytest.raises(NotImplementedError, match="rows 5 and 6"):
            port_vae._multihead(cfg, model.train_route(cuda), B, on_card=True)


def test_per_step_encoder_takes_one_matmul_then_the_cell(monkeypatch):
    """With per_step the encoder computes xp = x @ W + b for every step in
    one matmul and runs T xp (GRU) or S xp (LSTM) per step over it, also on
    bidirectional layers; the h it returns equals the plain scan's."""
    for cell_type, attr, module in (("GRU", "gru_recurrent_step", port_gru_step),
                                    ("LSTM", "lstm_recurrent_step", port_lstm_step)):
        cfg = small_test_config(cell_type=cell_type, bidirectional=True)
        model = MidiVAE(cfg, MidiVAE(cfg).init_params(np.array([0, 9], np.uint32)))
        x = _t(make_batch(cfg)["X"])
        layers = model.params["encoder"]["notes_rnn"]
        spy = _Spy(monkeypatch, {"cell": (port_rnn, attr)})
        got = port_rnn.encode_sequence(layers, x, cell_type, bidirectional=True, kernels=True,
                                       train=True, per_step=True)
        want = port_rnn.encode_sequence(layers, x, cell_type, bidirectional=True)
        assert spy.count() == {"cell": 3 * cfg.input_length}  # fwd, bwd, last layer
        assert spy.calls["cell"][0][0][0].shape == (B, (4 if cell_type == "LSTM" else 3)
                                                    * cfg.lstm_size)
        _close(got, want.detach().numpy(), msg=cell_type)
