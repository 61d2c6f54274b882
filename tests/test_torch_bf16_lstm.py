"""CPU parity of bf16 LSTM training with the default fused flags against the
JAX package, and of the per-part bf16 dispatch: the bf16 builds of kernels
L and N (``lstm_layer_train_x``, rows 19 and 20) and of Q and R
(``lstm_layer_train`` over xp = x @ W + b, rows 15 and 16 in place, 17 and
18 wide), with W on their gate grads; the configs that run them
(``Config(cell_type="LSTM", compute_dtype="bfloat16")``, the soak's
``lstm_bf16``, at 256 and, as LSTM(512) at B = 256 runs rows 17 and 18, at
512); and the rows the JAX package runs per encoder layer and decode head
in a bf16 model, which depend on B, D and H (``ops/_layout.py``), for the
LSTM and for the GRU (whose B = 1024 and B <= 128 dispatch the port took
from H alone before).

The JAX side runs its Pallas kernels in interpret mode; the port runs the
kernels' plain versions (CPU tensors) through the autograd Functions the
card runs. Same numpy inputs, cast to bf16 the same way on both sides.
Tolerances (those of ``tests/test_torch_bf16_wide.py``):
- over one step (T = 1) every value and gradient: relative L2 error <=
  REL_L2 = 3e-4 per output (both sides take the products in float32 and
  round what the Pallas kernels store; what is left is a rounding flip
  where float32 sums taken in another order straddle a bf16 boundary); each
  control must land over it;
- over T_LAYER steps, on SEEDS: a flip in an early h or c entry carries on
  through the recurrence, so the value, dx, dxp, dh0 and dc0 are held to
  one bf16 step at their largest entry and FLIP_REL_L2 = 1.7e-3, the weight
  grads (rounded to bf16 from float32 sums over those sequences) to two
  bf16 steps and GRAD_FLIP_REL_L2 = 4e-3;
- the weight grads before their final bf16 cast, on JAX's own forward
  sequences (no flip carries): float32 sums of the same operands in another
  order, relative L2 <= W_RTOL = 1e-5 (measured <= 3e-7 on seeds 0-5),
  where a sum over the other rounding of the gate grads lands at 1.1e-4 to
  2.1e-4;
- the configs' loss and metrics: atol LOSS_ATOL = 5e-4; every parameter
  gradient: relative L2 error <= 3e-2 and max|diff| <= 4e-2 of its largest
  entry (the dense layers and the loss run in bf16 on both sides, where XLA
  on the CPU fuses bf16 elementwise ops that PyTorch rounds one by one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.models.vae import MidiVAE as JaxVAE
from midi_vae_tpu.models.vae import loss_and_metrics as jax_loss
from midi_vae_tpu.ops import fused_train as ft
from midi_vae_tpu_torch import bridge
from midi_vae_tpu_torch.config import Config
from midi_vae_tpu_torch.models import rnn as port_rnn
from midi_vae_tpu_torch.models.vae import MidiVAE
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import grad_reduce as port_gr
from midi_vae_tpu_torch.ops import gru_decode as port_decode
from midi_vae_tpu_torch.ops import gru_layer as port_gru
from midi_vae_tpu_torch.ops import lstm_layer as port_layer
from midi_vae_tpu_torch.ops import lstm_step as port_step
from test_torch_bf16_fused import (
    B_OP,
    BF,
    GRAD_REL_L2,
    GRAD_REL_MAX,
    H_OP,
    LOSS_ATOL,
    REL_L2,
    T_LAYER,
    W_RTOL,
    _assert_close,
    _np,
    _pair,
    _rel_l2,
)
from test_torch_bf16_wide import GRAD_FLIP_REL_L2, SEEDS, _assert_within_flips
from test_torch_wide import B, _port_step, _Spy, make_batch

JBF = jnp.bfloat16


def _t(a):
    return torch.from_numpy(_np(a).copy()).to(BF)


# ---------------------------------------------------------------------------
# (b) the layer: L + N + W against rows 19 and 20, Q + R + W against rows
# 15 and 16 and rows 17 and 18
# ---------------------------------------------------------------------------

def _x_inputs(D, seed, T=T_LAYER):
    """x (T, B, D) as one-hot-like rows in [0, 1), h0, c0, W, b, U."""
    rng = np.random.RandomState(seed)
    H = H_OP
    return (rng.rand(T, B_OP, D).astype(np.float32),
            (0.5 * np.tanh(rng.randn(B_OP, H))).astype(np.float32),
            (0.5 * rng.randn(B_OP, H)).astype(np.float32),
            (rng.randn(D, 4 * H) / np.sqrt(D)).astype(np.float32),
            (0.1 * rng.randn(4 * H)).astype(np.float32),
            (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32))


def _xp_inputs(seed, T=T_LAYER):
    """xp (T, B, 4H), h0, c0, U."""
    rng = np.random.RandomState(seed)
    H = H_OP
    return ((0.6 * rng.randn(T, B_OP, 4 * H)).astype(np.float32),
            (0.5 * np.tanh(rng.randn(B_OP, H))).astype(np.float32),
            (0.5 * rng.randn(B_OP, H)).astype(np.float32),
            (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32))


def _vjp_pair(jax_fn, port_fn, args, rs):
    """(JAX value, JAX grads, port value, port grads) of one op on the same
    bf16 inputs, the cotangent a bf16 function of JAX's value."""
    jargs, targs = zip(*(_pair(a) for a in args))
    want, vjp = jax.vjp(jax_fn, *jargs)
    cot = jnp.cos(3.0 * want.astype(jnp.float32)).astype(JBF)
    leaves = [t.clone().requires_grad_() for t in targs]
    got = port_fn(*leaves)
    grads = torch.autograd.grad(got, leaves, _t(cot))
    return want, vjp(cot), got, grads


X_NAMES = ("dx", "dh0", "dc0", "dW", "db", "dU")
XP_NAMES = ("dxp", "dh0", "dc0", "dU")


def _x_layer(D, rs, seed, T=T_LAYER):
    return _vjp_pair(lambda *a: ft.lstm_layer_train_x(*a, "tanh", rs, True),
                     lambda *a: port_layer.lstm_layer_train_x(*a, rs), _x_inputs(D, seed, T), rs)


def _xp_layer(mode, rs, seed, monkeypatch, T=T_LAYER):
    """``lstm_layer_train`` against the JAX op on the in-place pair (rows 15
    and 16) or, with ``_FORCE_TRAIN_MODE`` "wide", the batch-tiled pair and
    ``_lstm_wide_weight_grads`` (rows 17 and 18)."""
    monkeypatch.setattr(ft, "_FORCE_TRAIN_MODE", mode)
    return _vjp_pair(lambda *a: ft.lstm_layer_train(*a, "tanh", rs, True),
                     lambda *a: port_layer.lstm_layer_train(*a, rs, mode), _xp_inputs(seed, T), rs)


def _assert_layer(want, want_grads, got, grads, names, one_step):
    assert got.dtype == BF
    if one_step:
        _assert_close(got, want, "value")
    else:
        _assert_within_flips(got, want, "value")
    assert len(grads) == len(want_grads) == len(names)
    for name, g, w in zip(names, grads, want_grads):
        assert g.dtype == BF and w.dtype == JBF, name
        if one_step:
            _assert_close(g, w, name)
        elif name in ("dW", "db", "dU"):
            _assert_within_flips(g, w, name, steps=2, limit=GRAD_FLIP_REL_L2)
        else:
            _assert_within_flips(g, w, name)


X_CASES = [(D, rs) for D in (61, 16, 1) for rs in (True, False)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("D, rs", X_CASES, ids=[f"D{d}-{'seq' if r else 'last'}" for d, r in X_CASES])
def test_layer_train_x_bf16_matches_rows_19_and_20(D, rs, seed):
    """``lstm_layer_train_x`` in bf16 over T_LAYER steps, value and VJP (dx,
    dh0, dc0, dW, db, dU), against ``_lstm_fwdx_pallas`` and
    ``_lstm_bwdx_pallas`` in interpret mode at the encoder's input widths
    (notes 61, instrument 16, velocity 1: ``cast_x``), within the flips a
    recurrence carries on; every output and gradient bf16, as JAX's."""
    _assert_layer(*_x_layer(D, rs, seed), X_NAMES, one_step=False)
    assert all(getattr(port_layer, f).launches_bf16 == 0 for f in port_layer.L_PHASES)
    assert port_layer.lstm_layer_bwd.launches_bf16 == 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("D, rs", X_CASES, ids=[f"D{d}-{'seq' if r else 'last'}" for d, r in X_CASES])
def test_layer_train_x_bf16_one_step_matches_rows_19_and_20(D, rs, seed):
    """Over one step no flip carries on: every value and gradient within
    REL_L2."""
    _assert_layer(*_x_layer(D, rs, seed, T=1), X_NAMES, one_step=True)


XP_CASES = [(m, rs) for m in ("wide", "inplace") for rs in (True, False)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode, rs", XP_CASES,
                         ids=[f"{m}-{'seq' if r else 'last'}" for m, r in XP_CASES])
def test_layer_train_bf16_matches_rows_15_to_18(mode, rs, seed, monkeypatch):
    """``lstm_layer_train`` in bf16 over T_LAYER steps (Q, R and W; dU from
    the rounded dxp in "wide", rows 17 and 18, from the float32 gate grads
    in "inplace", rows 15 and 16), value and VJP, within the flips."""
    _assert_layer(*_xp_layer(mode, rs, seed, monkeypatch), XP_NAMES, one_step=False)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode, rs", XP_CASES,
                         ids=[f"{m}-{'seq' if r else 'last'}" for m, r in XP_CASES])
def test_layer_train_bf16_one_step_matches_rows_15_to_18(mode, rs, seed, monkeypatch):
    _assert_layer(*_xp_layer(mode, rs, seed, monkeypatch, T=1), XP_NAMES, one_step=True)


def test_backward_is_the_float32_transposition_with_both_roundings():
    """N's and R's plain versions in bf16: dx, dxp, dh0 and dc0 rounded to
    bf16, the gate grads unrounded in float32 (dxp their bf16 rounding); the
    forward stores h and c in bf16. In float32 R's dxp is its da."""
    x, h0, c0, w, b, u = (_t(a) for a in _x_inputs(61, seed=3))
    hseq, cseq = port_layer.lstm_layer_reference(x, h0, c0, w, b, u, "tanh", True, True)
    assert hseq.dtype == cseq.dtype == BF
    d_seq = _t(np.cos(3.0 * _np(hseq)))
    dx, dh0, dc0, da = port_layer.lstm_layer_bwd_reference(x, hseq, cseq, h0, c0, d_seq, None,
                                                           w, b, u)
    assert (dx.dtype, dh0.dtype, dc0.dtype, da.dtype) == (BF, BF, BF, torch.float32)
    xp = (x.reshape(-1, 61) @ w + b).reshape(T_LAYER, B_OP, -1)
    hs, cs = port_layer.lstm_layer_xp_reference(xp, h0, c0, u)
    dxp, dh0, dc0, da = port_layer.lstm_layer_xp_bwd_reference(xp, hs, cs, h0, c0, d_seq, None, u)
    assert (dxp.dtype, dh0.dtype, dc0.dtype, da.dtype) == (BF, BF, BF, torch.float32)
    assert torch.equal(dxp, da.to(BF)) and not torch.equal(dxp.float(), da)
    f = port_layer.lstm_layer_xp_bwd_reference(*(t.float() for t in (xp, hs, cs, h0, c0, d_seq)),
                                               None, u.float())
    assert f[0] is f[3]


# ---------------------------------------------------------------------------
# (b) the controls: each wrong rounding lands outside REL_L2
# ---------------------------------------------------------------------------

def _scan_wrong(xp, h0, c0, u, every_op_bf16=False, c_float=False):
    """Wrong plain forwards over xp (T, B, 4H): every op in bf16, or c carried
    in float32 (h still rounded). Returns the h sequence."""
    H = h0.shape[-1]
    h, c, hs = h0, c0.float() if c_float else c0, []
    for t in range(xp.shape[0]):
        if every_op_bf16:
            gates = xp[t] + h @ u
            act = lambda a: a  # noqa: E731
        else:
            gates = xp[t].float() + h.float() @ u.float()
            act = lambda a: a.float()  # noqa: E731
        i, f = torch.sigmoid(gates[:, :H]), torch.sigmoid(gates[:, H : 2 * H])
        g, o = torch.tanh(gates[:, 2 * H : 3 * H]), torch.sigmoid(gates[:, 3 * H :])
        c_new = f * act(c) + i * g
        h = (o * torch.tanh(c_new)).to(BF)
        c = c_new if c_float else c_new.to(BF)
        hs.append(h)
    return torch.stack(hs)


def _weight_grad_controls(seed):
    """Relative L2 of the port's and the wrong weight-grad sums against JAX's
    on JAX's own forward sequences: (port row 20, N + W from the rounded da,
    port row 18, R + W from the unrounded da, port row 16)."""
    x, h0, c0, w, b, u = (_pair(a)[0] for a in _x_inputs(61, 10 + seed))
    hseq, cseq = ft._lstm_fwdx_pallas(x, h0, c0, w, b, u, "tanh", True)
    d_seq = jnp.cos(3.0 * hseq.astype(jnp.float32)).astype(JBF)
    dfin = jnp.zeros_like(h0)
    _, _, _, dw20, _, du20 = ft._lstm_bwdx_pallas(x, hseq, cseq, h0, c0, d_seq, dfin, w, b, u,
                                                  True, True)
    tx, th0, tc0, tw, tb, tu, ths, tcs, td = map(_t, (x, h0, c0, w, b, u, hseq, cseq, d_seq))
    hprev = torch.cat([th0[None], ths[:-1]])
    _, _, _, da = port_layer.lstm_layer_bwd_reference(tx, ths, tcs, th0, tc0, td, None, tw, tb, tu)
    found = {}
    dw, _, du = port_gr.lstm_weight_grads(tx, hprev, da)
    found["N + W row 20"] = max(_rel_l2(dw, dw20), _rel_l2(du, du20))
    dw, _, du = port_gr.lstm_weight_grads(tx, hprev, da.to(BF).float())
    found["N + W from the rounded da"] = min(_rel_l2(dw, dw20), _rel_l2(du, du20))
    xp = (x.reshape(-1, 61) @ w + b).reshape(T_LAYER, B_OP, -1)
    hs, cs = ft._lstm_fwd_wide_pallas(xp, h0, c0, u, "tanh", True, B_OP)
    dacat, _, _ = ft._lstm_bwd_wide_pallas(xp, hs, cs, h0, c0, d_seq, dfin, u, True, True, 8)
    du18 = ft._lstm_wide_weight_grads(hs, h0, dacat)
    _, _, _, du16 = ft._lstm_bwd_pallas(xp, hs, cs, h0, c0, d_seq, dfin, u, True, True)
    txp, ths, tcs = map(_t, (xp, hs, cs))
    hprev = torch.cat([th0[None], ths[:-1]])
    dxp, _, _, da = port_layer.lstm_layer_xp_bwd_reference(txp, ths, tcs, th0, tc0, td, None, tu)
    found["R + W row 18"] = _rel_l2(port_gr.lstm_u_grad(hprev, dxp.float()), du18)
    found["R + W from the unrounded da"] = _rel_l2(port_gr.lstm_u_grad(hprev, da), du18)
    found["R + W row 16"] = _rel_l2(port_gr.lstm_u_grad(hprev, da), du16)
    return found


@pytest.mark.parametrize("seed", SEEDS)
def test_rounding_controls_land_outside_the_tolerance(seed, monkeypatch):
    """The kernels' plain versions meet the Pallas rows where each wrong
    rounding lands outside the limit: one step of the layer with every op in
    bf16, two steps with c carried in float32 (against rows 17 and 18's
    forward; REL_L2), N's weight grads summed from the rounded da (row 20
    sums the unrounded one), R's dU from the unrounded da (row 18 sums the
    stored bf16 stream; W_RTOL)."""
    sums = _weight_grad_controls(seed)
    for what in ("N + W row 20", "R + W row 18", "R + W row 16"):
        assert sums.pop(what) <= W_RTOL, what
    for what, err in sums.items():
        assert err > W_RTOL, f"the control {what} lands {err:.3e} from JAX, inside {W_RTOL:.1e}"
    found = {}
    jargs, targs = zip(*(_pair(a) for a in _xp_inputs(20 + seed, T=2)))
    bt = ft._lstm_wide_btiles(B_OP, H_OP, 2)[0]
    want, _ = ft._lstm_fwd_wide_pallas(*jargs, "tanh", True, bt)
    got, _ = port_layer.lstm_layer_xp_reference(*targs)
    _assert_close(got, want, "Q's plain version, two steps")
    found["every op in bf16, one step"] = _rel_l2(_scan_wrong(*targs, every_op_bf16=True)[:1],
                                                   want[:1])
    found["c carried in float32, two steps"] = _rel_l2(_scan_wrong(*targs, c_float=True), want)
    for what, err in found.items():
        assert err > REL_L2, f"the control {what} lands {err:.3e} from JAX, inside {REL_L2:.1e}"


# ---------------------------------------------------------------------------
# (a) the per-part dispatch: the JAX predicates on the TPU against the port's
# ---------------------------------------------------------------------------

def _jax_layer_mode(cell_type, B, D, H):
    """The rows the JAX package runs one bf16 encoder layer through on the TPU."""
    spec = jax.ShapeDtypeStruct
    x, h0 = spec((64, B, D), JBF), spec((B, H), JBF)
    gates = 4 if cell_type == "LSTM" else 3
    use_x, mode = ((ft._lstm_x_use_pallas, ft._lstm_mode) if cell_type == "LSTM"
                   else (ft._x_use_pallas, ft._gru_mode))
    if use_x(x, h0, "tanh", False):
        return "x"
    return mode(spec((64, B, gates * H), JBF), h0, "tanh", False)


def _jax_head_mode(B, D, H, n_layers):
    """The rows of one bf16 GRU decode head (narrower than 8: promoted to
    float32 first, as ``gru_decode_train`` does)."""
    dt = jnp.float32 if D < 8 else JBF
    spec = jax.ShapeDtypeStruct
    return ft._dec_mode([None] * n_layers, spec((B, D), dt), [spec((B, H), dt)], "tanh",
                        "softmax", False)


GRID = [(B_, H) for H in (256, 512) for B_ in (64, 128, 256, 512, 1024)]


@pytest.mark.parametrize("batch, H", GRID, ids=[f"B{b}-H{h}" for b, h in GRID])
def test_bf16_dispatch_follows_the_jax_predicates(batch, H, monkeypatch):
    """On the TPU (``jax.default_backend`` patched) the JAX package picks each
    bf16 encoder layer's rows from (B, D, H) and each decode head's from
    (B, D, H, layers); the port's copies of its predicates pick the same, for
    the LSTM and the GRU, at every input width of ``Config()``'s encoder and
    at each of its heads."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for cell_type in ("LSTM", "GRU"):
        for D in (1, 16, 61, H):
            assert (_layout.bf16_layer_mode(cell_type, batch, D, H)
                    == _jax_layer_mode(cell_type, batch, D, H)), (cell_type, D)
    for D, n in ((61, 2), (16, 1), (1, 1)):
        assert _layout.bf16_head_mode(batch, D, H, n) == _jax_head_mode(batch, D, H, n), D


def test_bf16_dispatch_at_the_shapes_that_differ(monkeypatch):
    """The rows of the shapes where the TPU's rows differ from one route per
    step: the LSTM at (B 256, H 256) takes rows 19 and 20 everywhere, at
    (256, 512) rows 17 and 18, at (512, 256) rows 17 and 18 for notes L2
    only, at (128, 512) rows 15 and 16; the GRU at (1024, 256) rows 11 and
    12 and the wide heads, at (128, 512) rows 1 and 4 for notes L1 and the
    branches, 9 and 10 for notes L2, the wide notes head and rows 7 and 8 for
    the others (on the card through the 2-row builds with row 8's rounding,
    as D's and E's 8-row builds do not launch at H = 512)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    lstm = lambda b, h: [_layout.bf16_layer_mode("LSTM", b, d, h) for d in (61, h, 16, 1)]  # noqa: E731
    gru = lambda b, h: [_layout.bf16_layer_mode("GRU", b, d, h) for d in (61, h, 16, 1)]  # noqa: E731
    heads = lambda b, h: [_layout.bf16_head_mode(b, d, h, n)  # noqa: E731
                          for d, n in ((61, 2), (16, 1), (1, 1))]
    assert lstm(256, 256) == ["x"] * 4 and lstm(256, 512) == ["wide"] * 4
    assert lstm(512, 256) == ["x", "wide", "x", "x"] and lstm(128, 512) == ["inplace"] * 4
    assert gru(1024, 256) == ["wide"] * 4 and heads(1024, 256) == ["wide"] * 3
    assert gru(128, 512) == ["x", "inplace", "x", "x"]
    assert heads(128, 512) == ["wide", "inplace", "inplace"]
    assert gru(256, 256) == ["x"] * 4 and heads(256, 256) == ["inplace"] * 3
    assert gru(256, 512) == ["inplace"] * 4 and heads(256, 512) == ["wide"] * 3
    # on the card: the rows 7 and 8 of a head at H = 512 run on the 2-row
    # builds (D's and E's 8-row builds do not launch there), in bf16 with
    # row 8's rounding or, promoted to float32, the wide float32 builds
    for D, builds in ((16, ("D_wide_bf16", "E_wide_row8_bf16")), (1, ("D_wide", "E_wide"))):
        assert _layout.bf16_head_mode(128, D, 512, 1, on_card=True) == "inplace"
        assert _layout.head_builds("inplace", D, 512, 1) == builds
    assert _layout.bf16_head_mode(128, 61, 512, 2, on_card=True) == "wide"
    for cell_type, (b, h) in (("LSTM", (256, 256)), ("LSTM", (256, 512)), ("LSTM", (128, 512)),
                              ("GRU", (1024, 256)), ("GRU", (128, 512))):
        for d in (61, h, 16, 1):
            _layout.bf16_layer_mode(cell_type, b, d, h, on_card=True)
    monkeypatch.setattr(_layout, "lstm_wide_btiles", lambda *a: (0, 0))
    assert _layout.bf16_layer_mode("LSTM", 1024, 61, 512) == "scan"
    with pytest.raises(NotImplementedError, match="the XLA scan"):
        _layout.bf16_layer_mode("LSTM", 1024, 61, 512, on_card=True)


# ---------------------------------------------------------------------------
# (c), (d) the bf16 LSTM configs: loss, metrics, every gradient, the builds
# ---------------------------------------------------------------------------

def _jax_lstm_wide(mp):
    """The JAX package's dispatch of LSTM(512) at B = 256 in bf16, at any
    width: no in-kernel projection, the batch-tiled pair (rows 17, 18)."""
    mp.setattr(ft, "_lstm_x_use_pallas", lambda *a: False)
    mp.setattr(ft, "_FORCE_TRAIN_MODE", "wide")


def _port_lstm_wide(mp):
    """The port's at the same shapes: no in-kernel projection, the in-place
    pair's VMEM refused, the batch tiled (its predicates at (B 256, H 512);
    at the tests' 5 rows ``_btile`` finds no tile of 8)."""
    mp.setattr(_layout, "FORCE_ROUTE", "wide")
    mp.setattr(_layout, "lstm_train_vmem_ok", lambda *a: False)
    mp.setattr(_layout, "lstm_wide_btiles", lambda *a: (256, 64))


def _jax_reference(cfg, jax_mirror):
    """(numpy params, batch, noise, loss, metrics, flat grads) of one config,
    the JAX side at the dispatch ``jax_mirror`` sets, its kernels in interpret
    mode."""
    with pytest.MonkeyPatch.context() as mp:
        jax_mirror(mp)
        jm = JaxVAE(cfg)
        jm._interpret = True
        params = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(3)))
        batch = make_batch(cfg)
        key = jax.random.PRNGKey(1)
        fn = jax.value_and_grad(lambda p, b: jax_loss(jm, p, b, key, cfg.epsilon_std),
                                has_aux=True)
        (loss, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    # sample_z draws the noise in z_mean's dtype: bf16 in a bf16 model
    noise = np.asarray(cfg.epsilon_std * jax.random.normal(key, (B, cfg.latent_dim), JBF),
                       np.float32)
    return (params, batch, noise, float(loss), {k: float(v) for k, v in metrics.items()},
            bridge.flatten(jax.tree_util.tree_map(np.asarray, grads)))


# the rows the TPU runs the bf16 LSTM encoder through: LSTM(256) at B = 256
# (rows 19 and 20: interpret mode's own dispatch) and LSTM(512) at B = 256
# (rows 17 and 18)
LSTM_DISPATCH = {"x": (lambda mp: None, lambda mp: None), "wide": (_jax_lstm_wide, _port_lstm_wide)}


@pytest.fixture(scope="module", params=sorted(LSTM_DISPATCH))
def lstm_pair(request):
    cfg = small_test_config(cell_type="LSTM", compute_dtype="bfloat16")
    return request.param, cfg, _jax_reference(cfg, LSTM_DISPATCH[request.param][0])


def _lstm_spy(monkeypatch):
    """Records every call of the kernel wrappers a bf16 LSTM step reaches on
    the CPU path."""
    return _Spy(monkeypatch, {
        "L": (port_layer, "lstm_layer"), "N": (port_layer, "lstm_layer_bwd"),
        "Q": (port_layer, "lstm_layer_xp"), "R": (port_layer, "lstm_layer_xp_bwd"),
        "W": [(port_gr, "grad_reduce")], "S": (port_step, "lstm_cell_step_fwd"),
        "Y": (port_rnn, "lstm_encoder_scan"),
    })


def _count_builds(spy) -> dict:
    """{kernel build: calls} as the card would launch them (by the dtype of
    the first operand)."""
    found: dict = {}
    for name, calls in spy.calls.items():
        for args, _ in calls:
            key = f"{name} {'bf16' if args[0].dtype == BF else 'f32'}"
            found[key] = found.get(key, 0) + 1
    return found


def _want_lstm_builds(cfg, mode) -> dict:
    """One bf16 LSTM step: per encoder layer L and N (or Q and R) in bf16 and
    W: dW + db and dU over the bf16 x and h_{t-1} (2; the velocity layer's
    x widened as its cast_x does, the same sums) or dU alone over xp; every
    head cell through S's bf16 build."""
    T = cfg.output_length
    fwd, bwd, w = ("L", "N", 8) if mode == "x" else ("Q", "R", 4)
    return {f"{fwd} bf16": 4, f"{bwd} bf16": 4, "W bf16": w,
            "S bf16": 2 * T + T + cfg.meta_instrument_length}


def _assert_grads(got, want, name):
    assert sorted(got) == sorted(want), name
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == np.float32
        scale = max(np.abs(w).max(), 1e-12)
        rel_l2 = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert rel_l2 <= GRAD_REL_L2, f"{name} {k}: relative L2 {rel_l2:.3e}"
        assert np.abs(g - w).max() <= GRAD_REL_MAX * scale, f"{name} {k}"


def _assert_loss(loss, metrics, want_loss, want_metrics):
    np.testing.assert_allclose(loss, want_loss, rtol=0, atol=LOSS_ATOL)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=0, atol=LOSS_ATOL, err_msg=k)


def test_lstm_bf16_loss_and_metrics_match_jax(lstm_pair, monkeypatch):
    """The bf16 LSTM config's loss and every metric against the JAX package at
    the TPU's dispatch of LSTM(256) ("x") and LSTM(512) ("wide") at B = 256,
    and the builds one step takes (spies on the CPU path, where a card
    launches)."""
    mode, cfg, (params, batch, noise, want_loss, want_metrics, _) = lstm_pair
    LSTM_DISPATCH[mode][1](monkeypatch)
    spy = _lstm_spy(monkeypatch)
    loss, metrics, _ = _port_step(cfg, params, batch, noise)
    _assert_loss(loss, metrics, want_loss, want_metrics)
    assert _count_builds(spy) == _want_lstm_builds(cfg, mode)


def test_lstm_bf16_every_gradient_matches_jax(lstm_pair, monkeypatch):
    mode, cfg, (params, batch, noise, _, _, want) = lstm_pair
    LSTM_DISPATCH[mode][1](monkeypatch)
    _, _, got = _port_step(cfg, params, batch, noise)
    _assert_grads(got, want, mode)


FORMERLY_UNPORTED = {"lstm_fused_encoder": {},
                     "lstm_fused_encoder_no_fused_decoder": {"fused_train_decoder": False}}


@pytest.mark.parametrize("name", sorted(FORMERLY_UNPORTED))
def test_formerly_unported_bf16_lstm_configs_train_through_the_bf16_builds(name, monkeypatch):
    """On CUDA as on the CPU the bf16 LSTM configs with the fused encoder
    train, which raised naming L, N, Q, R and W before their bf16 builds
    were ported: (steps, layers) of ``train_kernels``, and one CPU step's
    spies count the builds (L and N in bf16, no float32 build, no Y)."""
    cfg = small_test_config(cell_type="LSTM", compute_dtype="bfloat16", **FORMERLY_UNPORTED[name])
    params = MidiVAE(cfg).init_params(np.array([0, 5], np.uint32))
    model = MidiVAE(cfg, params)
    for device in ("cuda", "cpu"):
        assert model.train_kernels(torch.device(device)) == (True, True)
        assert model.train_kernels_enabled(torch.device(device)) is True
    spy = _lstm_spy(monkeypatch)
    _port_step(cfg, params, make_batch(cfg, seed=2), np.zeros((B, cfg.latent_dim), np.float32))
    assert _count_builds(spy) == _want_lstm_builds(cfg, "x")


def test_lstm_bf16_configs_train_at_full_width():
    """The bf16 LSTM trains on CUDA at 256 and 512, with and without
    ``fused_train_decoder``, and so does ``decode_residual_bf16`` on the
    multi-head path (D's and E's bf16-residual builds). ``config_route``
    labels the rows every part takes at the config's batch, checking their
    builds on the card: narrow at (256, 256), wide at (256, 512), per-part
    at (512, 256), where notes L2 alone takes rows 17 and 18."""
    cuda = torch.device("cuda")
    for H in (256, 512):
        for flags in ({}, {"fused_train_decoder": False}):
            cfg = Config(cell_type="LSTM", lstm_size=H, compute_dtype="bfloat16", **flags)
            assert MidiVAE(cfg, {}).train_kernels(cuda) == (True, True)
            assert _layout.config_route(cfg) == ("narrow" if H == 256 else "wide")
    assert _layout.config_route(Config(cell_type="LSTM", compute_dtype="bfloat16",
                                       batch_size=512)) == "per-part"
    assert MidiVAE(Config(decode_residual_bf16=True), {}).train_kernels(cuda) == (True, True)


# ---------------------------------------------------------------------------
# (e) the GRU's bf16 dispatch where it differs from one route per step
# ---------------------------------------------------------------------------

def _gru_mirror(which):
    """(JAX side, port side) of the TPU's GRU dispatch at (B 1024, H 256):
    every layer through rows 11 and 12, every head through 13 and 14; or at
    (B 128, H 512): notes L1 and the branches through rows 1 and 4, notes L2
    (D = H) through 9 and 10, the 2-layer notes head through 13 and 14, the
    1-layer heads through 7 and 8."""
    if which == "b1024_h256":
        def jax_side(mp):
            mp.setattr(ft, "_x_use_pallas", lambda *a: False)
            mp.setattr(ft, "_FORCE_TRAIN_MODE", "wide")

        def port_side(mp):  # the predicates' answers at (B 1024, H 256)
            for name in ("x_train_vmem_ok", "train_vmem_ok", "dec_train_vmem_ok"):
                mp.setattr(_layout, name, lambda *a: False)
            mp.setattr(_layout, "gru_wide_btiles", lambda *a: (1024, 256))
            mp.setattr(_layout, "dec_wide_btiles", lambda *a: (512, 128))
    else:
        def jax_side(mp):
            dec_mode = ft._dec_mode
            mp.setattr(ft, "_x_use_pallas", lambda x, h0, *a: x.shape[2] != h0.shape[-1])
            mp.setattr(ft, "_gru_mode", lambda *a: "inplace")
            mp.setattr(ft, "_dec_mode", lambda cells, *a: (
                "scan" if dec_mode(cells, *a) == "scan" else
                "wide" if len(cells) == 2 else "inplace"))

        head_builds = _layout.head_builds

        def port_side(mp):  # the predicates' and the builds' answers at (B 128, H 512)
            mp.setattr(_layout, "x_train_vmem_ok", lambda B_, D, H, s: D != H)
            mp.setattr(_layout, "dec_train_vmem_ok", lambda B_, D, H, n: n != 2)
            mp.setattr(_layout, "dec_wide_btiles", lambda *a: (128, 64))
            mp.setattr(_layout, "head_builds", lambda mode, D, H, n: head_builds(mode, D, 512, n))

    def jax_with_mh_off(mp):
        jax_side(mp)
        mp.setattr(ft, "_mh_use_pallas", lambda *a: False)

    return jax_with_mh_off, port_side


@pytest.fixture(scope="module", params=["b1024_h256", "b128_h512"])
def gru_pair(request):
    # H = 32, so that only notes L2 has D = H (the instrument branch's D is
    # 16), as at (B 128, H 512)
    cfg = small_test_config(compute_dtype="bfloat16", lstm_size=32)
    return request.param, cfg, _jax_reference(cfg, _gru_mirror(request.param)[0])


def _gru_spy(monkeypatch):
    return _Spy(monkeypatch, {
        "A": (port_gru, "gru_layer"), "C": (port_gru, "gru_layer_bwd"),
        "X": (port_gru, "gru_layer_xp"), "G": (port_gru, "gru_layer_xp_bwd"),
        "D": (port_decode, "gru_decode_fwd_train"), "E": (port_decode, "gru_decode_bwd"),
        "D_wide": (port_decode, "gru_decode_fwd_train_wide"),
        "E_wide": (port_decode, "gru_decode_bwd_wide"),
    })


def _gru_builds(spy) -> dict:
    """{kernel: calls}, the decode kernels by head width (each call takes
    one head), the wide E's build with row 8's rounding as "E_wide row8"."""
    found: dict = {}
    for name, calls in spy.calls.items():
        for args, _ in calls:
            row8 = name == "E_wide" and args[1] == "E_wide_row8_bf16"
            key = (f"{name}{' row8' if row8 else ''} D={args[0][0]['start'].shape[-1]}"
                   if name.startswith(("D", "E")) else name)
            found[key] = found.get(key, 0) + 1
    return found


GRU_WANT = {
    # every layer over xp (kernel X serves row 11, G the backward), every
    # head on the wide builds
    "b1024_h256": {"X": 4, "G": 4, "D_wide D=61": 1, "E_wide D=61": 1, "D_wide D=16": 1,
                   "E_wide D=16": 1, "D_wide D=1": 1, "E_wide D=1": 1},
    # A + C for notes L1 and the branches, X + G for notes L2; the notes head
    # wide, the 1-layer heads' rows 7 and 8 on the 2-row builds with row 8's
    # rounding (the velocity head's promoted to float32: E wide's float32
    # build, whose streams are unrounded too)
    "b128_h512": {"A": 3, "C": 3, "X": 1, "G": 1, "D_wide D=61": 1, "E_wide D=61": 1,
                  "D_wide D=16": 1, "E_wide row8 D=16": 1, "D_wide D=1": 1,
                  "E_wide D=1": 1},
}


def test_gru_bf16_per_part_dispatch_loss_matches_jax(gru_pair, monkeypatch):
    """The bf16 GRU config at the TPU's dispatch of (B 1024, H 256) and
    (B 128, H 512), each part on its own rows: the loss and every metric
    against the JAX package under the bf16 limits above, and the builds each
    part takes."""
    which, cfg, (params, batch, noise, want_loss, want_metrics, _) = gru_pair
    _gru_mirror(which)[1](monkeypatch)
    spy = _gru_spy(monkeypatch)
    loss, metrics, _ = _port_step(cfg, params, batch, noise)
    _assert_loss(loss, metrics, want_loss, want_metrics)
    assert _gru_builds(spy) == GRU_WANT[which]


def test_gru_bf16_per_part_dispatch_every_gradient_matches_jax(gru_pair, monkeypatch):
    which, cfg, (params, batch, noise, _, _, want) = gru_pair
    _gru_mirror(which)[1](monkeypatch)
    _, _, got = _port_step(cfg, params, batch, noise)
    _assert_grads(got, want, which)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("D", (61, 16, 1))
def test_gru_rows_11_and_12_one_step_and_the_narrow_route_as_control(D, seed, monkeypatch):
    """The fault this dispatch repairs, on one step (no flip carries): at
    (B 1024, H 256) the TPU runs a bf16 GRU layer as xp = x @ W + b rounded
    to bf16 and the batch-tiled rows 11 and 12 (dU from the rounded stream);
    the port's wide op with ``mode="wide"`` meets their value, dxp, dh0 and
    dU within REL_L2, where the narrow route's A + C (x @ W + b unrounded,
    inside the kernel), which the port ran at every B before, lands over it
    on the value, and dU summed from the float32 gate grads (row 10's) lands
    over it on dU."""
    from test_torch_bf16_fused import _layer_inputs

    monkeypatch.setattr(ft, "_FORCE_TRAIN_MODE", "wide")
    monkeypatch.setattr(ft, "_WIDE_BUDGET_BYTES", 50_000)  # tiles of 8 of the 16 rows
    x, h0, w, b, u = (a[:1] if i == 0 else a for i, a in enumerate(_layer_inputs(D, seed)))
    jx, jh0, jw, jb, ju = (_pair(a)[0] for a in (x, h0, w, b, u))
    xp = (jx.reshape(B_OP, D) @ jw + jb).reshape(1, B_OP, -1)
    want, vjp = jax.vjp(lambda *a: ft.gru_layer_train(*a, "tanh", True, True), xp, jh0, ju)
    cot = jnp.cos(3.0 * want.astype(jnp.float32)).astype(JBF)
    want_grads = vjp(cot)
    leaves = [_t(a).requires_grad_() for a in (xp, jh0, ju)]
    got = port_gru.gru_layer_train(*leaves, True, "wide")
    grads = torch.autograd.grad(got, leaves, _t(cot))
    _assert_close(got, want, "value")
    for name, g, wg in zip(("dxp", "dh0", "dU"), grads, want_grads):
        _assert_close(g, wg, name)
    assert torch.equal(_t(xp), (_t(jx).reshape(B_OP, D) @ _t(jw) + _t(jb)).reshape(1, B_OP, -1))
    leaves = [_t(a).requires_grad_() for a in (jx, jh0, jw, jb, ju)]
    narrow = port_gru.gru_layer_train_x(*leaves, True)
    assert _rel_l2(narrow, want) > REL_L2
    u10 = _t(ju).requires_grad_()
    du10, = torch.autograd.grad(port_gru.gru_layer_train(_t(xp), _t(jh0), u10, True, "inplace"),
                                [u10], _t(cot))
    assert _rel_l2(du10, want_grads[2]) > REL_L2
