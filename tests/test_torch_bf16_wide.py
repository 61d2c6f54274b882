"""CPU parity of bf16 training on the GRU's wide route against the JAX
package: ``gru_layer_train`` over xp = x @ W + b (kernel X forward, G's bf16
build and W backward), ``gru_decode_train`` on the wide builds (the bf16 builds of
the wide D and E, and W) and the configs that take them
(``Config(lstm_size=512, compute_dtype="bfloat16")``, the soak's
``wide512_bf16``, forced down the wide route at small widths).

The JAX side runs its Pallas kernels in interpret mode. At (B 256, H 512,
bf16) it runs the encoder's layers through ``_fwd_kernel`` and
``_bwd_kernel`` (rows 9 and 10: ``_x_train_vmem_ok`` refuses the in-kernel
projection, ``_train_vmem_ok`` admits the in-place pair) and the decode heads
through the wide pair (rows 13 and 14, then ``_dec_wide_weight_grads``);
``test_jax_dispatch_at_the_wide_bf16_shape`` holds the JAX predicates to
that, and ``_jax_wide_bf16`` mirrors it at small widths. The port
runs the kernels' plain versions (CPU tensors) through the autograd
Functions the card runs. Same numpy inputs, cast to bf16 the same way on
both sides. Tolerances (those of ``tests/test_torch_bf16_fused.py``):
- the ops' values and gradients over one step (T = 1), and the decode
  heads': relative L2 error <= REL_L2 = 3e-4 per output; both sides take
  the products in float32 and round what the Pallas kernels store, and what
  is left is a rounding flip where float32 sums taken in another order
  straddle a bf16 rounding boundary;
- the layer's outputs over T_LAYER steps, on SEEDS: such a flip in an early
  h entry carries on through the recurrence, so the value, dxp and dh0 are
  held to one bf16 step at their largest entry and a relative L2 error <=
  FLIP_REL_L2 = 1.7e-3 (``chip_smoke.py``'s BF16_OUT), and dU, rounded to
  bf16 from float32 sums over those sequences, to two bf16 steps and
  GRAD_FLIP_REL_L2 = 4e-3 (its BF16_GRAD_OP). Measured on seeds 0-7: at
  most 3.96e-4 and half a step (the value), 1.42e-4 (dxp), 1.09e-4 (dh0),
  1.02e-3 and one step (dU), all from seed 1, the one seed of the eight
  where a flip carries; 0 to 3.4e-5 elsewhere;
- the weight grads before their final bf16 cast (the controls): the same
  REL_L2. The two wrong roundings must land over it: dU summed from the
  rounded dxp (row 12's rounding) against row 10, and the heads' weight
  grads summed from the unrounded dlogits and gate grads (the narrow
  route's) against row 14 + ``_dec_wide_weight_grads``;
- the configs' loss and metrics: atol LOSS_ATOL = 5e-4; every parameter
  gradient: relative L2 error <= 3e-2 and max|diff| <= 4e-2 of its largest
  entry (the dense layers and the loss run in bf16 on both sides, where XLA
  on the CPU fuses bf16 elementwise ops that PyTorch rounds one by one).
The batch-tiled rows 11 and 12 give the same value, dxp and dh0; their dU is
summed from the rounded dxp, which the port does not take
(``test_rounding_controls_land_outside_the_tolerance``, on JAX's own
forward sequences, where no flip carries: there the port reads at most
2.9e-7 (dU) and 4.7e-5 (the heads) over seeds 0-5, the controls 6.2e-4 and
more).
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
from midi_vae_tpu_torch.ops import encoder_scan as port_scan
from midi_vae_tpu_torch.ops import grad_reduce as port_gr
from midi_vae_tpu_torch.ops import gru_decode as port_decode
from midi_vae_tpu_torch.ops import gru_layer as port_layer
from midi_vae_tpu_torch.ops import gru_step as port_gru_step
from test_torch_bf16_fused import (
    B_OP,
    BF,
    GRAD_REL_L2,
    GRAD_REL_MAX,
    H_OP,
    LOSS_ATOL,
    REL_L2,
    T_HEAD,
    T_LAYER,
    _assert_close,
    _head_inputs,
    _head_leaves,
    _np,
    _pair,
    _rel_l2,
    _torch_head,
)
from test_torch_wide import B, _port_step, _Spy, make_batch

SEEDS = (0, 1, 2)
FLIP_REL_L2, GRAD_FLIP_REL_L2 = 1.7e-3, 4e-3


def _assert_within_flips(got, want, what, steps=1, limit=FLIP_REL_L2):
    """``got`` within ``steps`` bf16 steps of ``want`` at its largest entry
    (2^-7 of it) and within ``limit`` relative L2."""
    _assert_close(got, want, what, limit)
    g, w = _np(got), _np(want)
    lim = steps * 2.0 ** -7 * np.abs(w).max()
    assert np.abs(g - w).max() <= lim, f"{what}: max|diff| {np.abs(g - w).max():.3e} > {lim:.3e}"


def _jax_wide_bf16(monkeypatch):
    """The JAX package's dispatch at (B 256, H 512, bf16), at any width: the
    decode heads' wide pair, the encoder's in-place pair over xp (rows 9 and
    10), no in-kernel projection, no multi-head call (float32 only)."""
    monkeypatch.setattr(ft, "_FORCE_TRAIN_MODE", "wide")
    monkeypatch.setattr(ft, "_gru_mode", lambda *a: "inplace")
    monkeypatch.setattr(ft, "_x_use_pallas", lambda *a: False)
    monkeypatch.setattr(ft, "_mh_use_pallas", lambda *a: False)


# ---------------------------------------------------------------------------
# (a) the JAX dispatch at the real shape
# ---------------------------------------------------------------------------

def test_jax_dispatch_at_the_wide_bf16_shape(monkeypatch):
    """At wide512_bf16's shapes (T 64, B 256, H 512) on the TPU the JAX
    package runs every encoder layer through xp = x @ W + b and rows 9 and
    10 (in float32: the batch-tiled rows 11 and 12), every decode head of 8
    outputs or more through the wide pair with tiles (256, 64), the velocity
    head through the same pair in float32 (``gru_decode_train`` promotes it
    first), and no multi-head call; the port's per-part dispatch picks the
    same rows for every part, whose bf16 builds all launch at H = 512, and
    labels the config's route wide; the narrow rows' bf16 heads do not
    launch there."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    cfg = Config(lstm_size=512, compute_dtype="bfloat16")
    layers, heads = _layout.config_shapes(cfg)
    T, H, bf, f32 = 64, cfg.lstm_size, jnp.bfloat16, jnp.float32
    rows = cfg.batch_size
    assert rows == 256
    assert [d for d, _ in layers] == [61, 512, 16, 1]
    for d, _ in layers:
        assert not ft._x_train_vmem_ok(rows, d, H, 2)
    assert ft._train_vmem_ok(rows, H, 2) and not ft._train_vmem_ok(rows, H, 4)
    spec = lambda shape, dt: jax.ShapeDtypeStruct(shape, dt)  # noqa: E731
    for dt, mode in ((bf, "inplace"), (f32, "wide")):
        assert ft._gru_mode(spec((T, rows, 3 * H), dt), spec((rows, H), dt), "tanh", False) == mode
    assert heads == [(61, 2), (16, 1), (1, 1)]
    for d, n in heads:
        start, init = spec((rows, d), bf), [spec((rows, H), bf)]
        mode = ft._dec_mode([None] * n, start, init, "tanh", "softmax", False)
        if d >= 8:
            assert not ft._dec_train_vmem_ok(rows, d, H, n) and mode == "wide"
        else:  # promoted to float32 by gru_decode_train, then wide
            assert mode == "scan"
            assert ft._dec_mode([None] * n, spec((rows, d), f32), [spec((rows, H), f32)], "tanh",
                                "sigmoid", False) == "wide"
    assert ft._dec_wide_btiles(rows, 61, H, 2, 2) == (256, 64)
    primary = {"start": spec((rows, 61), bf), "init": [spec((rows, H), bf)]}
    assert not ft._mh_use_pallas(primary, [], "tanh", ("softmax", "sigmoid"), False)
    assert _layout.config_route(cfg) == "wide"
    assert [_layout.bf16_layer_mode("GRU", rows, d, H, True, dx) for d, dx in layers] == [
        "inplace"] * 4
    assert [_layout.bf16_head_mode(rows, d, H, n, True) for d, n in heads] == ["wide"] * 3
    assert _layout.launch_limit("D_bf16", H, _layout.smem_bytes("D", H, 61, 2)) is not None


# ---------------------------------------------------------------------------
# (b), (c) the layer over xp: X + G + W against rows 9 and 10
# ---------------------------------------------------------------------------

def _xp_inputs(seed=0, T=T_LAYER):
    """xp (T, B, 3H), h0 (B, H), U (H, 3H)."""
    rng = np.random.RandomState(seed)
    H = H_OP
    return ((0.5 * rng.randn(T, B_OP, 3 * H)).astype(np.float32),
            (0.5 * np.tanh(rng.randn(B_OP, H))).astype(np.float32),
            (rng.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32))


def _jax_layer(rs, seed=0, T=T_LAYER):
    """The JAX op's value and VJP (dxp, dh0, dU) with its cotangent, bf16."""
    jargs, targs = zip(*(_pair(a) for a in _xp_inputs(seed, T)))
    want, vjp = jax.vjp(lambda *a: ft.gru_layer_train(*a, "tanh", rs, True), *jargs)
    cot = jnp.cos(3.0 * want.astype(jnp.float32)).astype(jnp.bfloat16)
    return jargs, targs, want, cot, vjp(cot)


def _port_layer_vjp(targs, rs, cot):
    leaves = [t.clone().requires_grad_() for t in targs]
    got = port_layer.gru_layer_train(*leaves, rs)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(_np(cot).copy()).to(BF))
    return got, grads


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rs", [True, False], ids=["seq", "last"])
def test_layer_train_bf16_matches_rows_9_and_10(rs, seed):
    """``gru_layer_train`` in bf16 over T_LAYER steps, value and VJP (dxp,
    dh0, dU), against the JAX op on ``_fwd_pallas`` and ``_bwd_pallas`` in
    interpret mode (its mode in interpret mode is the in-place pair), within
    the rounding flips a recurrence carries on. Every output and gradient in
    bf16, as JAX's."""
    _, targs, want, cot, want_grads = _jax_layer(rs, seed)
    got, grads = _port_layer_vjp(targs, rs, cot)
    assert got.dtype == BF
    _assert_within_flips(got, want, "value")
    for name, g, w in zip(("dxp", "dh0", "dU"), grads, want_grads):
        assert g.dtype == BF and w.dtype == jnp.bfloat16, name
        if name == "dU":
            _assert_within_flips(g, w, name, steps=2, limit=GRAD_FLIP_REL_L2)
        else:
            _assert_within_flips(g, w, name)
    assert port_layer.gru_layer_xp_bwd.launches_bf16 == port_scan.gru_encoder_scan_fwd.launches == 0


def _batch_tiled(monkeypatch):
    """The batch-tiled pair (rows 11 and 12): a budget small enough that the
    backward's tile is 8 of the 16 rows."""
    monkeypatch.setattr(ft, "_FORCE_TRAIN_MODE", "wide")
    monkeypatch.setattr(ft, "_WIDE_BUDGET_BYTES", 50_000)
    assert ft._gru_wide_btiles(B_OP, H_OP, 2) == (16, 8)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rs", [True, False], ids=["seq", "last"])
def test_layer_train_bf16_matches_the_batch_tiled_rows_11_and_12(rs, seed, monkeypatch):
    """The batch-tiled pair gives the same value, dxp and dh0 within the
    rounding flips of ``test_layer_train_bf16_matches_rows_9_and_10``; its
    dU comes from the rounded dxp (``_gru_wide_weight_grads``) and is the
    control of ``test_rounding_controls_land_outside_the_tolerance``."""
    _batch_tiled(monkeypatch)
    _, targs, want, cot, want_grads = _jax_layer(rs, seed)
    got, grads = _port_layer_vjp(targs, rs, cot)
    _assert_within_flips(got, want, "value")
    for name, g, w in zip(("dxp", "dh0"), grads, want_grads):
        _assert_within_flips(g, w, name)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("tiled", [False, True], ids=["rows_9_10", "rows_11_12"])
@pytest.mark.parametrize("rs", [True, False], ids=["seq", "last"])
def test_layer_train_bf16_one_step_matches_the_pallas_pair(rs, tiled, seed, monkeypatch):
    """Over one step no flip can carry on: the value and every gradient of
    ``gru_layer_train`` in bf16 (dU only against row 10, whose sum the port
    takes) meet the in-place pair and the batch-tiled one within REL_L2."""
    if tiled:
        _batch_tiled(monkeypatch)
    _, targs, want, cot, want_grads = _jax_layer(rs, seed, T=1)
    got, grads = _port_layer_vjp(targs, rs, cot)
    _assert_close(got, want, "value")
    for name, g, w in zip(("dxp", "dh0", "dU")[: 2 if tiled else 3], grads, want_grads):
        _assert_close(g, w, name)


def test_kernel_x_serves_row_9_in_bf16():
    """X's plain version (what ``gru_layer_xp`` launches kernel X for on a
    bf16 CUDA tensor) equals ``_fwd_pallas`` in bf16 in interpret mode: the
    same function as ``_encoder_kernel`` with the sequence emitted."""
    jargs, targs = zip(*(_pair(a) for a in _xp_inputs(seed=2)))
    want = ft._fwd_pallas(*jargs, "tanh", True)
    got = port_scan.gru_encoder_scan_reference(*targs, "tanh", True)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _assert_close(got, want, "X plain vs _fwd_pallas")
    assert torch.equal(port_layer.gru_layer_xp(*targs), got)


def test_layer_backward_emits_both_roundings():
    """G's plain version in bf16: dxp and dh0 rounded to bf16, the gate
    grads (the same values before rounding) and r * h in float32, with dxp
    the bf16 rounding of da_cat; in float32 dxp is da_cat."""
    _, targs, _, cot, _ = _jax_layer(True, seed=3)
    xp, h0, u = targs
    seq = port_layer.gru_layer_xp_reference(xp, h0, u)
    d_seq = torch.from_numpy(_np(cot).copy()).to(BF)
    dxp, dh0, da, rh = port_layer.gru_layer_xp_bwd_reference(xp, seq, h0, d_seq, None, u)
    assert (dxp.dtype, dh0.dtype, da.dtype, rh.dtype) == (BF, BF, torch.float32, torch.float32)
    assert torch.equal(dxp, da.to(BF)) and not torch.equal(dxp.float(), da)
    f = port_layer.gru_layer_xp_bwd_reference(*(t.float() for t in (xp, seq, h0, d_seq)), None,
                                              u.float())
    assert f[0] is f[2]


# ---------------------------------------------------------------------------
# (d) the wide decode heads: D wide + E wide + W against rows 13 and 14
# ---------------------------------------------------------------------------

HEAD_CASES = [(2, 61, "softmax"), (1, 16, "softmax"), (1, 1, "sigmoid"), (1, 10, "sigmoid"),
              (2, 12, "linear")]


@pytest.mark.parametrize("n_layers, D, out_act", HEAD_CASES,
                         ids=[f"{n}L-D{d}-{a}" for n, d, a in HEAD_CASES])
def test_wide_decode_train_bf16_matches_rows_13_and_14(n_layers, D, out_act, monkeypatch):
    """``gru_decode_train(wide=True)`` in bf16, probs, logits and the VJP of
    every input, against the JAX op on its wide path (``_dec_fwd_wide_pallas``,
    ``_dec_bwd_wide_pallas`` and ``_dec_wide_weight_grads`` in interpret
    mode): the notes head's shape, the instrument head's, the velocity
    head's (D = 1: promoted whole to float32, the wide float32 builds), and
    1- and 2-layer heads with sigmoid and linear outputs."""
    monkeypatch.setattr(ft, "_FORCE_TRAIN_MODE", "wide")
    cells, out, init, start = _head_inputs(n_layers, D, seed=D)
    jc = [{k: _pair(v)[0] for k, v in c.items()} for c in cells]
    jo = {k: _pair(v)[0] for k, v in out.items()}
    want, vjp = jax.vjp(lambda c, o, i, s: ft.gru_decode_train(c, o, i, s, T_HEAD, "tanh",
                                                                out_act, True),
                        jc, jo, [_pair(s)[0] for s in init], _pair(start)[0])
    cot = tuple(jnp.cos(3.0 * w.astype(jnp.float32) + k).astype(w.dtype)
                for k, w in enumerate(want))
    want_grads = jax.tree_util.tree_leaves(vjp(cot))
    tc, to, ti, ts = _torch_head(cells, out, init, start, grad=True)
    got = port_decode.gru_decode_train(tc, to, ti, ts, T_HEAD, "tanh", out_act,
                                       _layout.head_builds("wide", D, H_OP, n_layers))
    for name, g, w in zip(("probs", "logits"), got, want):
        assert g.dtype == BF and w.dtype == jnp.bfloat16, name
        _assert_close(g, w, name)
    leaves = _head_leaves(tc, to, ti, ts)
    grads = torch.autograd.grad(got, leaves, [torch.from_numpy(_np(c).copy()).to(BF) for c in cot])
    assert len(grads) == len(want_grads)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert g.dtype == BF and w.dtype == jnp.bfloat16, i
        _assert_close(g, w, f"grad {i}")
    assert port_decode.gru_decode_fwd_train_wide.launches_bf16 == 0
    assert port_decode.gru_decode_bwd_wide.launches_bf16 == 0


def test_wide_narrow_heads_take_the_float32_builds(monkeypatch):
    """A bf16 head narrower than 8 reaches the wide D and E in float32, a
    wider one in bf16."""
    spy = _Spy(monkeypatch, {"D": (port_decode, "gru_decode_fwd_train_wide"),
                             "E": (port_decode, "gru_decode_bwd_wide")})
    for n_layers, D, out_act in HEAD_CASES[:3]:
        cells, out, init, start = _torch_head(*_head_inputs(n_layers, D), grad=True)
        probs, logits = port_decode.gru_decode_train(cells, out, init, start, T_HEAD, "tanh",
                                                     out_act,
                                                     _layout.head_builds("wide", D, H_OP, n_layers))
        (probs.float().sum() + logits.float().sum()).backward()
    dtypes = {k: [args[0][0]["start"].dtype for args, _ in v] for k, v in spy.calls.items()}
    assert dtypes == {"D": [BF, BF, torch.float32], "E": [BF, BF, torch.float32]}


# ---------------------------------------------------------------------------
# (e) the two weight-grad roundings, and their controls
# ---------------------------------------------------------------------------

def _layer_du(seed):
    """dU of one layer before its bf16 cast: (row 10's, the port's G + W,
    W over the rounded dxp, row 12's), the backward on JAX's forward
    sequence."""
    jargs, targs = zip(*(_pair(a) for a in _xp_inputs(seed=4 + seed)))
    xp, h0, u = jargs
    seq = ft._fwd_pallas(xp, h0, u, "tanh", True)
    d_seq = jnp.cos(3.0 * seq.astype(jnp.float32)).astype(jnp.bfloat16)
    _, _, du_10 = ft._bwd_pallas(xp, seq, h0, d_seq, jnp.zeros_like(h0), u, True, True)
    dacat, _ = ft._bwd_wide_pallas(xp, seq, h0, d_seq, jnp.zeros_like(h0), u, True, True, 8)
    du_12 = ft._gru_wide_weight_grads(xp, seq, h0, u, dacat)
    tseq, td = (torch.from_numpy(_np(a).copy()).to(BF) for a in (seq, d_seq))
    dxp, _, da, rh = port_layer.gru_layer_xp_bwd_reference(targs[0], tseq, targs[1], td, None,
                                                           targs[2])
    hprev = torch.cat([targs[1][None], tseq[:-1]])
    return (du_10, port_gr.gru_u_grad(hprev, rh, da), port_gr.gru_u_grad(hprev, rh, dxp.float()),
            du_12)


def _head_weight_grads(n_layers, D, out_act, seed):
    """The weight grads of one wide head before their bf16 cast, flattened
    (per layer dW, dU; then dWo): row 14 + ``_dec_wide_weight_grads``, the
    port's E wide + W, and E + W with the narrow route's unrounded streams."""
    cells, out, init, start = _head_inputs(n_layers, D, seed=7 + seed)
    jc = [{k: _pair(v)[0] for k, v in c.items()} for c in cells]
    jo = {k: _pair(v)[0] for k, v in out.items()}
    ji, js = [_pair(s)[0] for s in init], _pair(start)[0]
    probs, _, *h_seqs = ft._dec_fwd_wide_pallas(jc, jo, ji, js, T_HEAD, "tanh", out_act, True,
                                                B_OP)
    rng = np.random.RandomState(8 + seed)
    g_probs, g_logits = (jnp.asarray(rng.randn(*probs.shape), jnp.bfloat16) for _ in range(2))
    outs = ft._dec_bwd_wide_pallas(jc, jo, ji, js, probs, h_seqs, g_probs, g_logits, out_act,
                                   True, 8)
    dlog, dacats = outs[0], list(outs[1 : 1 + n_layers])
    d_cells, d_out = ft._dec_wide_weight_grads(jc, jo, ji, js, probs, h_seqs, dlog, dacats)
    want = [g for c in d_cells for g in (c["w"], c["u"])] + [d_out["w"]]
    tc, to, ti, ts = _torch_head(cells, out, init, start)
    tp, tgp, tgl = (torch.from_numpy(_np(a).copy()).to(BF) for a in (probs, g_probs, g_logits))
    th = [torch.from_numpy(_np(h).copy()).to(BF) for h in h_seqs]
    found = []
    for wide in (True, False):
        g = port_decode.gru_decode_bwd_reference(tc, to, ti, ts, tp, th, tgp, tgl, out_act, wide)
        grads = []
        for i in range(n_layers):
            x = th[i - 1] if i > 0 else torch.cat([ts[None], tp[:-1]])
            hprev = torch.cat([ti[i][None], th[i][:-1]])
            dw, _db, du = port_gr.gru_weight_grads(x, hprev, g["rh"][i], g["da"][i])
            grads += [dw, du]
        dwo = torch.empty(H_OP, D)
        port_gr.grad_reduce(th[-1].reshape(-1, H_OP), g["dlogits"].reshape(-1, D), dwo)
        found.append(grads + [dwo])
    return want, found[0], found[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_rounding_controls_land_outside_the_tolerance(seed):
    """The encoder's dU sums the unrounded gate grads (row 10), the wide
    heads' weight grads the bf16-rounded streams (row 14's pass 2): the
    port's G + W and E wide + W meet their JAX counterparts within REL_L2
    before the final bf16 cast, and each wrong rounding lands over it: dU
    from the rounded dxp (row 12's sum: also over REL_L2 from row 10), and
    the heads' dW, dU and dWo from the unrounded streams (the narrow
    route's)."""
    du_10, du_port, du_rounded, du_12 = _layer_du(seed)
    _assert_close(du_port, du_10, "G + W dU")
    found = {"dU from the rounded dxp": _rel_l2(du_rounded, du_10),
             "row 12's dU": _rel_l2(du_12, du_10)}
    for n_layers, D, out_act in ((2, 61, "softmax"), (1, 16, "softmax")):
        want, port, unrounded = _head_weight_grads(n_layers, D, out_act, seed)
        for i, (p, u, w) in enumerate(zip(port, unrounded, want)):
            _assert_close(p, w, f"{n_layers}L D={D} E wide + W grad {i}")
            found[f"{n_layers}L D={D} unrounded streams grad {i}"] = _rel_l2(u, w)
    for what, err in found.items():
        assert err > REL_L2, f"the control {what} lands {err:.3e} from JAX, inside {REL_L2:.1e}"


# ---------------------------------------------------------------------------
# rows 7 and 8 on the 2-row builds: a bf16 head the TPU runs through
# _dec_fwd/_dec_bwd_pallas at a width (H = 512) where D's and E's 8-row bf16
# builds do not launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers, D, out_act", HEAD_CASES,
                         ids=[f"{n}L-D{d}-{a}" for n, d, a in HEAD_CASES])
def test_rows_7_and_8_on_the_wide_builds_match_the_pallas_kernels(n_layers, D, out_act,
                                                                  monkeypatch):
    """``gru_decode_train`` on D's and E's 2-row builds in bf16 (D's wide
    bf16 build, E's with row 8's rounding; a head narrower than 8 in float32)
    against the JAX op on its in-place rows (``_dec_fwd_pallas``,
    ``_dec_bwd_pallas`` in interpret mode): probs, logits and the VJP of
    every input within REL_L2, and the wide E is asked for its unrounded
    streams."""
    spy = _Spy(monkeypatch, {"E_wide": (port_decode, "gru_decode_bwd_wide")})
    cells, out, init, start = _head_inputs(n_layers, D, seed=D)
    jc = [{k: _pair(v)[0] for k, v in c.items()} for c in cells]
    jo = {k: _pair(v)[0] for k, v in out.items()}
    want, vjp = jax.vjp(lambda c, o, i, s: ft.gru_decode_train(c, o, i, s, T_HEAD, "tanh",
                                                                out_act, True),
                        jc, jo, [_pair(s)[0] for s in init], _pair(start)[0])
    cot = tuple(jnp.cos(3.0 * w.astype(jnp.float32) + k).astype(w.dtype)
                for k, w in enumerate(want))
    want_grads = jax.tree_util.tree_leaves(vjp(cot))
    tc, to, ti, ts = _torch_head(cells, out, init, start, grad=True)
    builds = ("D_wide_bf16", "E_wide_row8_bf16") if D >= 8 else ("D_wide", "E_wide")
    got = port_decode.gru_decode_train(tc, to, ti, ts, T_HEAD, "tanh", out_act, builds)
    for name, g, w in zip(("probs", "logits"), got, want):
        assert g.dtype == BF and w.dtype == jnp.bfloat16, name
        _assert_close(g, w, name)
    leaves = _head_leaves(tc, to, ti, ts)
    grads = torch.autograd.grad(got, leaves, [torch.from_numpy(_np(c).copy()).to(BF) for c in cot])
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert g.dtype == BF and w.dtype == jnp.bfloat16, i
        _assert_close(g, w, f"grad {i}")
    assert [(a[0][0]["start"].dtype, a[1]) for a, _ in spy.calls["E_wide"]] == [
        (BF, "E_wide_row8_bf16") if D >= 8 else (torch.float32, "E_wide")]


def _row8_weight_grads(n_layers, D, out_act, seed):
    """The weight grads of one head before their bf16 cast, flattened (per
    layer dW, dU; then dWo): rows 7 and 8's in-kernel float32 sums, the
    port's E wide + W with row 8's unrounded streams, and with row 14's
    rounded ones."""
    cells, out, init, start = _head_inputs(n_layers, D, seed=11 + seed)
    jc = [{k: _pair(v)[0] for k, v in c.items()} for c in cells]
    jo = {k: _pair(v)[0] for k, v in out.items()}
    ji, js = [_pair(s)[0] for s in init], _pair(start)[0]
    probs, _, *h_seqs = ft._dec_fwd_pallas(jc, jo, ji, js, T_HEAD, "tanh", out_act, True)
    rng = np.random.RandomState(12 + seed)
    g_probs, g_logits = (jnp.asarray(rng.randn(*probs.shape), jnp.bfloat16) for _ in range(2))
    outs = ft._dec_bwd_pallas(jc, jo, ji, js, probs, h_seqs, g_probs, g_logits, out_act, True)
    want = [outs[3 * i + k] for i in range(n_layers) for k in (0, 1)] + [outs[3 * n_layers]]
    tc, to, ti, ts = _torch_head(cells, out, init, start)
    tp, tgp, tgl = (torch.from_numpy(_np(a).copy()).to(BF) for a in (probs, g_probs, g_logits))
    th = [torch.from_numpy(_np(h).copy()).to(BF) for h in h_seqs]
    found = []
    for rounded in (False, True):
        g = port_decode.gru_decode_bwd_reference(tc, to, ti, ts, tp, th, tgp, tgl, out_act, rounded)
        grads = []
        for i in range(n_layers):
            x = th[i - 1] if i > 0 else torch.cat([ts[None], tp[:-1]])
            dw, _db, du = port_gr.gru_weight_grads(x, torch.cat([ti[i][None], th[i][:-1]]),
                                                   g["rh"][i], g["da"][i])
            grads += [dw, du]
        dwo = torch.empty(H_OP, D)
        port_gr.grad_reduce(th[-1].reshape(-1, H_OP), g["dlogits"].reshape(-1, D), dwo)
        found.append(grads + [dwo])
    return want, found[0], found[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_row_8_weight_grads_sum_the_unrounded_streams(seed):
    """Rows 7 and 8 sum their weight grads from the float32 gate grads in
    VMEM: the port's E wide + W with ``round_streams=False`` meets those
    sums within REL_L2 before the final bf16 cast, and row 14's rounded
    streams (E wide's other bf16 build) land over it on each head's dW, dU
    and dWo."""
    found = {}
    for n_layers, D, out_act in ((2, 61, "softmax"), (1, 16, "softmax")):
        want, port, rounded = _row8_weight_grads(n_layers, D, out_act, seed)
        for i, (p, r, w) in enumerate(zip(port, rounded, want)):
            _assert_close(p, w, f"{n_layers}L D={D} E wide row 8 + W grad {i}")
            found[f"{n_layers}L D={D} rounded streams grad {i}"] = _rel_l2(r, w)
    for what, err in found.items():
        assert err > REL_L2, f"the control {what} lands {err:.3e} from JAX, inside {REL_L2:.1e}"


# ---------------------------------------------------------------------------
# (f), (g) the configs: loss, metrics, every gradient, and the builds
# ---------------------------------------------------------------------------

# wide512_bf16 (the soak's, tools/tpu_soak.py:60) and the two configs with a
# fused flag off that the wide route also serves, at small_test_config's
# widths, forced down the wide route
CONFIGS = {
    "gru_wide": {},
    "gru_wide_fused_decoder": {"fused_train_encoder": False},
    "gru_wide_fused_encoder": {"fused_train_decoder": False},
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def config_pair(request):
    """(name, cfg, numpy params, batch, noise, jax loss, metrics, flat grads)
    of one config, the JAX side at its (B 256, H 512, bf16) dispatch with its
    kernels in interpret mode."""
    cfg = small_test_config(compute_dtype="bfloat16", **CONFIGS[request.param])
    with pytest.MonkeyPatch.context() as mp:
        _jax_wide_bf16(mp)
        jm = JaxVAE(cfg)
        jm._interpret = True
        params = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(3)))
        batch = make_batch(cfg)
        key = jax.random.PRNGKey(1)
        fn = jax.value_and_grad(lambda p, b: jax_loss(jm, p, b, key, cfg.epsilon_std),
                                has_aux=True)
        (loss, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    # sample_z draws the noise in z_mean's dtype: bf16 in a bf16 model
    noise = np.asarray(cfg.epsilon_std * jax.random.normal(key, (B, cfg.latent_dim), jnp.bfloat16),
                       np.float32)
    return (request.param, cfg, params, batch, noise, float(loss),
            {k: float(v) for k, v in metrics.items()},
            bridge.flatten(jax.tree_util.tree_map(np.asarray, grads)))


def _build_spy(monkeypatch):
    """Records every call of the kernel wrappers a wide bf16 step reaches on
    the CPU path; ``_builds`` names them by kernel and dtype."""
    return _Spy(monkeypatch, {
        "F": (port_layer, "gru_layer_xp"), "G": (port_layer, "gru_layer_xp_bwd"),
        "X": (port_rnn, "gru_encoder_scan"),
        "D_wide": (port_decode, "gru_decode_fwd_train_wide"),
        "E_wide": (port_decode, "gru_decode_bwd_wide"),
        "W": [(port_gr, "grad_reduce"), (port_decode, "grad_reduce")],
        "T": (port_gru_step, "gru_cell_step_fwd"),
        "A": (port_layer, "gru_layer"), "C": (port_layer, "gru_layer_bwd"),
        "D": (port_decode, "gru_decode_fwd_train"), "E": (port_decode, "gru_decode_bwd"),
    })


def _builds(spy) -> dict:
    """{kernel build: calls} as the card would launch them: F on bf16
    operands is kernel X (``gru_layer_xp``), the rest by the dtype of the
    first operand (D, E: the heads')."""
    found: dict = {}
    for name, calls in spy.calls.items():
        for args, _ in calls:
            first = args[0][0]["start"] if name.startswith(("D", "E")) else args[0]
            bf16 = first.dtype == BF
            key = "X" if name == "X" or (name == "F" and bf16) else \
                f"{name} {'bf16' if bf16 else 'f32'}"
            found[key] = found.get(key, 0) + 1
    return found


def _want_builds(name, cfg) -> dict:
    """What one step of config ``name`` launches on the card: X per encoder
    layer (4), and G bf16 per layer where the encoder is fused; the wide D
    and E in bf16 on the notes and instrument heads, in float32 on the
    velocity head (D = 1), where the decoder is fused, else T bf16 per head
    cell and step; W: 2 per fused encoder layer (dU[:, :2H] over the bf16
    h_{t-1}, dU[:, 2H:] over the float32 r * h), 3 per decoded cell (dW and
    dU[:, :2H] over its bf16 activations, or float32 in the promoted
    velocity head; dU[:, 2H:] over r * h) and 1 per decoded head's output
    dense."""
    T = cfg.output_length
    want = {"X": 4}
    if cfg.fused_train_encoder:
        want.update({"G bf16": 4, "W bf16": 4, "W f32": 4})
    if cfg.fused_train_decoder:
        for k, v in (("D_wide bf16", 2), ("E_wide bf16", 2), ("D_wide f32", 1),
                     ("E_wide f32", 1), ("W bf16", 5 + 3), ("W f32", 2 + 1 + 4)):
            want[k] = want.get(k, 0) + v
    else:
        want["T bf16"] = 2 * T + T + cfg.meta_instrument_length
    return want


def test_config_loss_and_metrics_match_jax(config_pair, monkeypatch):
    """The loss and every metric, and the builds one step takes (the spies
    count the wrappers' calls on the CPU path, where a card launches)."""
    name, cfg, params, batch, noise, want_loss, want_metrics, _ = config_pair
    monkeypatch.setattr(_layout, "FORCE_ROUTE", "wide")
    spy = _build_spy(monkeypatch)
    loss, metrics, _ = _port_step(cfg, params, batch, noise)
    np.testing.assert_allclose(loss, want_loss, rtol=0, atol=LOSS_ATOL)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=0, atol=LOSS_ATOL, err_msg=k)
    assert _builds(spy) == _want_builds(name, cfg)


def test_config_every_gradient_matches_jax(config_pair, monkeypatch):
    name, cfg, params, batch, noise, _, _, want = config_pair
    monkeypatch.setattr(_layout, "FORCE_ROUTE", "wide")
    _, _, got = _port_step(cfg, params, batch, noise)
    assert sorted(got) == sorted(want), name
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == np.float32
        scale = max(np.abs(w).max(), 1e-12)
        rel_l2 = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert rel_l2 <= GRAD_REL_L2, f"{name} {k}: relative L2 {rel_l2:.3e}"
        assert np.abs(g - w).max() <= GRAD_REL_MAX * scale, f"{name} {k}"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_formerly_unported_wide_bf16_configs_train_through_the_bf16_builds(name, monkeypatch):
    """On CUDA as on the CPU the wide route's bf16 configs train, which
    raised naming the wide route before its bf16 builds were ported:
    (steps, layers) of ``train_kernels``, and one CPU step's spies count the
    builds each takes (no A, C, narrow D or E, no F or G in float32)."""
    monkeypatch.setattr(_layout, "FORCE_ROUTE", "wide")
    cfg = small_test_config(compute_dtype="bfloat16", **CONFIGS[name])
    params = MidiVAE(cfg).init_params(np.array([0, 5], np.uint32))
    model = MidiVAE(cfg, params)
    for device in ("cuda", "cpu"):
        assert model.train_kernels(torch.device(device)) == (True, True)
        assert model.train_kernels_enabled(torch.device(device)) is True
        assert model.train_route(torch.device(device)) == "wide"
    spy = _build_spy(monkeypatch)
    _port_step(cfg, params, make_batch(cfg, seed=2), np.zeros((B, cfg.latent_dim), np.float32))
    found = _builds(spy)
    assert found == _want_builds(name, cfg)
    assert not any(k.startswith(("A ", "C ", "D ", "E ", "F ", "G f32")) for k in found)


def test_wide_bf16_config_takes_the_wide_route_at_full_width():
    """``Config(lstm_size=512, compute_dtype="bfloat16")`` trains on CUDA
    (no raise) on the wide route, and so does the bf16 LSTM(512) with the
    fused encoder (Q and R in bf16); so does ``decode_residual_bf16`` on the
    multi-head path (D's and E's bf16-residual builds)."""
    cuda = torch.device("cuda")
    wide = Config(lstm_size=512, compute_dtype="bfloat16")
    for variant in ({}, {"fused_train_encoder": False}, {"fused_train_decoder": False},
                    {"cell_type": "LSTM"}):
        cfg = Config(lstm_size=512, compute_dtype="bfloat16", **variant)
        assert MidiVAE(cfg, {}).train_kernels(cuda) == (True, True)
    assert _layout.config_route(wide) == "wide"
    assert MidiVAE(Config(decode_residual_bf16=True), {}).train_kernels(cuda) == (True, True)
