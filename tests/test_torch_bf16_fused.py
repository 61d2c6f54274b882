"""CPU parity of bf16 training with the default fused flags against the JAX
package: the bf16 builds of kernels A, C and W (``gru_layer_train_x``, the
encoder's layers), of D, E and W (``gru_decode_train``, each decode head
alone) and the configs that run them (``Config(compute_dtype="bfloat16")``,
the study's ``vae_bf16``, and the soak's ``merge_bf16``, ``held_bf16`` and
``teacher_force_bf16``).

The JAX side runs its Pallas kernels in interpret mode (``interpret=True``,
``MidiVAE._interpret = True``); the port runs the kernels' plain versions
(CPU tensors), through the same autograd Functions the card runs. Same numpy
inputs, cast to bf16 the same way on both sides (round to nearest even).
Tolerances:
- the ops' values and gradients (A + C + W, D + E + W): relative L2 error
  <= REL_L2 = 3e-4 per output. Both sides take the products in float32 and
  round what the Pallas kernels store; what is left is a rounding flip where
  float32 sums taken in another order straddle a bf16 rounding boundary.
  Measured here: 0 for most outputs, at most 1.1e-4 (dW). The controls of
  ``test_controls_land_outside_the_tolerance`` (r * h rounded to bf16, the
  gate grads rounded before W sums them, layer 2 fed the rounded h1) land at
  7e-4 and more;
- W's plain version: within 1e-5 relative of a float64 sum of the same
  widened operands;
- the configs' loss and metrics: atol LOSS_ATOL = 5e-4; every parameter
  gradient: relative L2 error <= 3e-2 and max|diff| <= 4e-2 of its largest
  entry (the limits of ``tests/test_torch_bf16.py``): the dense layers
  and the loss run in bf16 on both sides, where XLA on the CPU fuses bf16
  elementwise ops that PyTorch rounds one by one. Both sides draw the
  reparameterization noise as ``sample_z`` does in a bf16 model.
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
from midi_vae_tpu_torch.models import rnn as port_rnn
from midi_vae_tpu_torch.models.vae import MidiVAE
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import grad_reduce as port_gr
from midi_vae_tpu_torch.ops import gru_decode as port_decode
from midi_vae_tpu_torch.ops import gru_layer as port_layer
from midi_vae_tpu_torch.ops import gru_step as port_gru_step
from test_torch_wide import B, _port_step, _Spy, make_batch

BF = torch.bfloat16
REL_L2 = 3e-4
W_RTOL = 1e-5
LOSS_ATOL = 5e-4
GRAD_REL_L2, GRAD_REL_MAX = 3e-2, 4e-2
T_LAYER, B_OP, H_OP = 12, 16, 32


def _pair(a):
    """numpy a -> (jnp, torch) in bf16, rounded the same way."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(np.asarray(a, np.float32).copy()).to(BF)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _assert_close(got, want, what, limit=REL_L2):
    assert tuple(got.shape) == tuple(want.shape), what
    err = _rel_l2(got, want)
    assert err <= limit, f"{what}: relative L2 {err:.3e} > {limit:.1e}"


# ---------------------------------------------------------------------------
# (a) A + C + W in bf16: gru_layer_train_x
# ---------------------------------------------------------------------------

def _layer_inputs(D, seed=0):
    """x (T, B, D) as one-hot-like rows in [0, 1), h0, W, b, U."""
    rng = np.random.RandomState(seed)
    H = H_OP
    return ((rng.rand(T_LAYER, B_OP, D)).astype(np.float32),
            (0.5 * np.tanh(rng.randn(B_OP, H))).astype(np.float32),
            (rng.randn(D, 3 * H) / np.sqrt(D)).astype(np.float32),
            (0.1 * rng.randn(3 * H)).astype(np.float32),
            (rng.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32))


def _jax_layer(D, rs, seed=0):
    """The JAX layer's value and VJP (dx, dh0, dW, db, dU) with its
    cotangent, bf16, the Pallas kernels in interpret mode."""
    jargs, targs = zip(*(_pair(a) for a in _layer_inputs(D, seed)))
    want, vjp = jax.vjp(lambda *a: ft.gru_layer_train_x(*a, "tanh", rs, True), *jargs)
    cot = jnp.cos(3.0 * want.astype(jnp.float32)).astype(jnp.bfloat16)
    return targs, want, cot, vjp(cot)


LAYER_CASES = [(D, rs) for D in (61, 16, 1) for rs in (True, False)]


@pytest.mark.parametrize("D, rs", LAYER_CASES,
                         ids=[f"D{d}-{'seq' if rs else 'last'}" for d, rs in LAYER_CASES])
def test_layer_train_x_bf16_matches_the_pallas_kernels(D, rs):
    """``gru_layer_train_x`` in bf16, value and VJP, against the JAX op
    (``_fwdx_pallas`` and ``_bwdx_pallas`` in interpret mode) at the
    encoder's input widths: notes 61, instrument 16 and velocity 1 (the
    ``cast_x`` case: x and W widened to float32, the same products as the
    bf16 build's). Every output and gradient in bf16, as JAX's."""
    targs, want, cot, want_grads = _jax_layer(D, rs)
    leaves = [t.clone().requires_grad_() for t in targs]
    got = port_layer.gru_layer_train_x(*leaves, rs)
    assert got.dtype == BF
    _assert_close(got, want, "value")
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(_np(cot).copy()).to(BF))
    for name, g, w in zip(("dx", "dh0", "dW", "db", "dU"), grads, want_grads):
        assert g.dtype == BF and w.dtype == jnp.bfloat16, name
        _assert_close(g, w, name)
    assert all(getattr(port_layer, f).launches_bf16 == 0 for f in port_layer.A_PHASES)
    assert port_layer.gru_layer_bwd.launches_bf16 == 0


def test_layer_backward_is_the_float32_transposition_not_autograd():
    """C's plain version in bf16 is the explicit float32 transposition over
    the stored bf16 sequence (the f32 dh carry, dx and dh0 rounded once), not
    autograd through a bf16 forward: autograd through the plain forward lands
    outside the tolerance that the plain C meets."""
    targs, want, cot, want_grads = _jax_layer(61, True, seed=2)
    leaves = [t.clone().requires_grad_() for t in targs]
    cot_t = torch.from_numpy(_np(cot).copy()).to(BF)
    through = torch.autograd.grad(port_layer.gru_layer_reference(*leaves, "tanh", True), leaves,
                                  cot_t)
    assert max(_rel_l2(g, w) for g, w in zip(through, want_grads)) > REL_L2


# ---------------------------------------------------------------------------
# (b) D + E + W in bf16: gru_decode_train
# ---------------------------------------------------------------------------

T_HEAD = 10
HEAD_CASES = [(2, 61, "softmax"), (1, 16, "softmax"), (1, 1, "sigmoid")]


def _head_inputs(n_layers, D, seed=0):
    rng = np.random.RandomState(seed)
    H = H_OP
    cells, d = [], D
    for _ in range(n_layers):
        cells.append({"w": (rng.randn(d, 3 * H) / np.sqrt(d)).astype(np.float32),
                      "u": (rng.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32),
                      "b": (0.1 * rng.randn(3 * H)).astype(np.float32)})
        d = H
    out = {"w": (rng.randn(H, D) / np.sqrt(H)).astype(np.float32),
           "b": (0.1 * rng.randn(D)).astype(np.float32)}
    init = [(0.5 * np.tanh(rng.randn(B_OP, H))).astype(np.float32) for _ in range(n_layers)]
    return cells, out, init, np.zeros((B_OP, D), np.float32)


def _torch_head(cells, out, init, start, grad=False):
    def t(a):
        x = _pair(a)[1]
        return x.requires_grad_() if grad else x
    return ([{k: t(v) for k, v in c.items()} for c in cells], {k: t(v) for k, v in out.items()},
            [t(s) for s in init], t(start))


def _head_leaves(cells, out, init, start):
    """The tensors in the order of ``jax.tree_util.tree_leaves`` of the
    JAX op's arguments (dict keys sorted)."""
    return ([c[k] for c in cells for k in sorted(c)] + [out[k] for k in sorted(out)]
            + list(init) + [start])


def _jax_head(n_layers, D, out_act, seed=0):
    cells, out, init, start = _head_inputs(n_layers, D, seed)
    jc = [{k: _pair(v)[0] for k, v in c.items()} for c in cells]
    jo = {k: _pair(v)[0] for k, v in out.items()}
    want, vjp = jax.vjp(lambda c, o, i, s: ft.gru_decode_train(c, o, i, s, T_HEAD, "tanh", out_act,
                                                                True),
                        jc, jo, [_pair(s)[0] for s in init], _pair(start)[0])
    cot = tuple(jnp.cos(3.0 * w.astype(jnp.float32) + k).astype(w.dtype) for k, w in enumerate(want))
    return (cells, out, init, start), want, cot, jax.tree_util.tree_leaves(vjp(cot))


@pytest.mark.parametrize("n_layers, D, out_act", HEAD_CASES,
                         ids=[f"{n}L-D{d}-{a}" for n, d, a in HEAD_CASES])
def test_decode_train_bf16_matches_the_pallas_kernels(n_layers, D, out_act):
    """``gru_decode_train`` in bf16, probs, logits and the VJP of every
    input, against the JAX op (``_dec_fwd_pallas`` and ``_dec_bwd_pallas`` in
    interpret mode): the notes head's shape (2 layers, softmax), the
    instrument head's (1 layer, softmax, D = 16) and the velocity head's (1
    layer, sigmoid, D = 1: promoted whole to float32, its outputs and grads
    cast back to bf16). Every output and gradient has JAX's dtype."""
    inputs, want, cot, want_grads = _jax_head(n_layers, D, out_act)
    cells, out, init, start = _torch_head(*inputs, grad=True)
    got = port_decode.gru_decode_train(cells, out, init, start, T_HEAD, "tanh", out_act)
    for name, g, w in zip(("probs", "logits"), got, want):
        assert g.dtype == BF and w.dtype == jnp.bfloat16, name
        _assert_close(g, w, name)
    leaves = _head_leaves(cells, out, init, start)
    grads = torch.autograd.grad(got, leaves, [torch.from_numpy(_np(c).copy()).to(BF) for c in cot])
    assert len(grads) == len(want_grads)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert g.dtype == BF and w.dtype == jnp.bfloat16, i
        _assert_close(g, w, f"grad {i}")
    assert port_decode.gru_decode_fwd_train.launches_bf16 == 0
    assert port_decode.gru_decode_bwd.launches_bf16 == 0


def test_narrow_heads_take_the_float32_builds(monkeypatch):
    """A bf16 head narrower than 8 reaches D and E in float32 (the JAX
    package's promotion), a wider one in bf16."""
    spy = _Spy(monkeypatch, {"D": (port_decode, "gru_decode_fwd_train"),
                             "E": (port_decode, "gru_decode_bwd")})
    for n_layers, D, out_act in HEAD_CASES:
        cells, out, init, start = _torch_head(*_head_inputs(n_layers, D), grad=True)
        probs, logits = port_decode.gru_decode_train(cells, out, init, start, T_HEAD, "tanh", out_act)
        (probs.float().sum() + logits.float().sum()).backward()
    dtypes = {k: [args[0][0]["start"].dtype for args, _ in v] for k, v in spy.calls.items()}
    assert dtypes == {"D": [BF, BF, torch.float32], "E": [BF, BF, torch.float32]}


# ---------------------------------------------------------------------------
# (c) W's bf16 plain version
# ---------------------------------------------------------------------------

def test_weight_grad_bf16_plain_version_sums_in_float32():
    """W's plain version with bf16 activations and float32 gate grads (what
    its bf16 build reads) against a float64 sum of the same widened operands,
    with and without the bias sums, and on a column slice of the gate grads
    (the dU[:, 2H:] product)."""
    rng = np.random.RandomState(7)
    a = torch.from_numpy(rng.randn(300, 40).astype(np.float32)).to(BF)
    b = torch.from_numpy(rng.randn(300, 96).astype(np.float32))
    for bias in (True, False):
        out, bias_out = torch.empty(40, 96), (torch.empty(96) if bias else None)
        port_gr.grad_reduce(a, b, out, bias_out)
        want = a.double().t() @ b.double()
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=W_RTOL,
                                   atol=W_RTOL * want.abs().max().item())
        if bias:
            np.testing.assert_allclose(bias_out.numpy(), b.double().sum(0).numpy(), rtol=W_RTOL,
                                       atol=W_RTOL * 300)
    out = torch.zeros(40, 96)
    port_gr.grad_reduce(a, b[:, 64:], out[:, 64:])
    want = a.double().t() @ b[:, 64:].double()
    np.testing.assert_allclose(out[:, 64:].numpy(), want.numpy(), rtol=W_RTOL,
                               atol=W_RTOL * want.abs().max().item())
    assert out[:, :64].abs().max() == 0
    assert port_gr.grad_reduce.launches_bf16 == port_gr.grad_reduce.launches == 0


# ---------------------------------------------------------------------------
# (d) controls: the roundings the port must not take
# ---------------------------------------------------------------------------

def _scan_rounding_rh(x, h0, w, b, u):
    """A's plain version with r * h rounded to bf16 before its product with
    U_h (the Pallas kernel keeps it float32)."""
    H = h0.shape[-1]
    xp, uf, h, seq = x.float() @ w.float() + b.float(), u.float(), h0, []
    for t in range(x.shape[0]):
        hf = h.float()
        hu = hf @ uf[:, : 2 * H]
        z = torch.sigmoid(xp[t, :, :H] + hu[:, :H])
        r = torch.sigmoid(xp[t, :, H : 2 * H] + hu[:, H:])
        hh = torch.tanh(xp[t, :, 2 * H :] + (r * hf).to(BF).float() @ uf[:, 2 * H :])
        h = (z * hf + (1.0 - z) * hh).to(BF)
        seq.append(h)
    return torch.stack(seq)


def _decode_rounding_h1(cells, out, init, start, T, out_act):
    """D's plain version with layer 2 fed the rounded h1 (the Pallas kernel
    feeds it the float32 h1 of the step)."""
    act = port_decode.out_activation_fn(out_act)
    states, x, probs = list(init), start, []
    for _ in range(T):
        for i, p in enumerate(cells):
            x = states[i] = port_layer.gru_step(x, states[i], p["w"], p["u"], p["b"], torch.tanh)
        x = act(x.float() @ out["w"].float() + out["b"].float()).to(BF)
        probs.append(x)
    return torch.stack(probs)


def test_controls_land_outside_the_tolerance():
    """Three wrong plain versions against the same JAX outputs that the
    port's plain versions meet within REL_L2: r * h rounded to bf16 (A's
    value), the gate grads rounded to bf16 before W sums them (C's dW and
    dU), layer 2 fed the rounded h1 (D's probs of the 2-layer head). Each
    must land over REL_L2, or the tolerance does not tell them apart."""
    targs, want, cot, want_grads = _jax_layer(61, True)
    found = {"r*h rounded": _rel_l2(_scan_rounding_rh(*targs), want)}
    x, h0, w, b, u = targs
    seq = port_layer.gru_layer_reference(x, h0, w, b, u, "tanh", True)
    _, _, da, rh = port_layer.gru_layer_bwd_reference(
        x, seq, h0, torch.from_numpy(_np(cot).copy()).to(BF), None, w, b, u)
    dw, _, du = port_gr.gru_weight_grads(x, torch.cat([h0[None], seq[:-1]]), rh,
                                         da.to(BF).float())
    found["gate grads rounded: dW"] = _rel_l2(dw.to(BF), want_grads[2])
    found["gate grads rounded: dU"] = _rel_l2(du.to(BF), want_grads[4])
    inputs, want_head, _, _ = _jax_head(2, 61, "softmax")
    cells, out, init, start = _torch_head(*inputs)
    found["layer 2 fed the rounded h1"] = _rel_l2(
        _decode_rounding_h1(cells, out, init, start, T_HEAD, "softmax"), want_head[0])
    for what, err in found.items():
        assert err > REL_L2, f"the control {what} lands {err:.3e} from JAX, inside {REL_L2:.1e}"


# ---------------------------------------------------------------------------
# (e) the configs: loss, metrics, every gradient
# ---------------------------------------------------------------------------

# the bf16 configs with fused_train_* left True (the soak's bf16, merge_bf16,
# held_bf16, teacher_force_bf16; the study's vae_bf16), and the one with the
# fused decoder off, at small_test_config's widths
CONFIGS = {
    "default": {},
    "merge": {"merge_decoder_scans": True},
    "held": {"meta_held_notes": True},
    "teacher_force": {"teacher_force": True},
    "no_fused_decoder": {"fused_train_decoder": False},
}


def _cfg(name):
    return small_test_config(compute_dtype="bfloat16", **CONFIGS[name])


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def config_pair(request):
    """(name, cfg, numpy params, batch, noise, jax loss, metrics, flat grads)
    of one config, the JAX side with its kernels in interpret mode."""
    cfg = _cfg(request.param)
    jm = JaxVAE(cfg)
    jm._interpret = True
    params = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(3)))
    batch = make_batch(cfg)
    key = jax.random.PRNGKey(1)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss(jm, p, b, key, cfg.epsilon_std), has_aux=True))
    (loss, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    # sample_z draws the noise in z_mean's dtype: bf16 in a bf16 model
    noise = np.asarray(cfg.epsilon_std * jax.random.normal(key, (B, cfg.latent_dim), jnp.bfloat16),
                       np.float32)
    return (request.param, cfg, params, batch, noise, float(loss),
            {k: float(v) for k, v in metrics.items()},
            bridge.flatten(jax.tree_util.tree_map(np.asarray, grads)))


def _build_spy(monkeypatch):
    """Records every call of the kernel wrappers a bf16 step reaches on the
    CPU path; ``builds`` names them by kernel and dtype."""
    return _Spy(monkeypatch, {
        "A": (port_layer, "gru_layer"), "C": (port_layer, "gru_layer_bwd"),
        "D": (port_decode, "gru_decode_fwd_train"), "E": (port_decode, "gru_decode_bwd"),
        "W": [(port_gr, "grad_reduce"), (port_decode, "grad_reduce")],
        "T": (port_gru_step, "gru_cell_step_fwd"),
        "X": (port_rnn, "gru_encoder_scan"),
        "D_wide": (port_decode, "gru_decode_fwd_train_wide"),
        "F": (port_layer, "gru_layer_xp"),
    })


def _builds(spy) -> dict:
    """{kernel build: calls}: A bf16, D f32, ... from the spied calls' dtypes
    (A, C, W: the first operand's; D, E: the heads'; T: x's; X: no dtype
    split, it has the bf16 build only)."""
    found: dict = {}
    for name, calls in spy.calls.items():
        for args, _ in calls:
            first = args[0][0]["start"] if name in ("D", "E", "D_wide") else args[0]
            key = name if name == "X" else f"{name} {'bf16' if first.dtype == BF else 'f32'}"
            found[key] = found.get(key, 0) + 1
    return found


def _want_builds(name, cfg) -> dict:
    """What one bf16 training step of config ``name`` launches on the card:
    A and C bf16 per encoder layer (4, with the held-notes branch 5); D and E
    once per head that ``gru_decode_train`` decodes, in bf16 for heads of 8
    outputs and more, in f32 for the narrower ones (velocity, held notes);
    W 3 per GRU cell (dW and dU[:, :2H] over bf16 activations, dU[:, 2H:]
    over the float32 r * h) and 1 per decoded head's output dense (over its
    top h sequence: bf16, or f32 in a promoted head); T bf16 per cell and
    step of the heads that the per-step cell decodes."""
    layers = 4 + cfg.meta_held_notes
    T = cfg.output_length
    heads = {"notes": (cfg.output_dim, 2, T), "velocity": (1, 1, T),
             "instrument": (cfg.meta_instrument_dim, 1, cfg.meta_instrument_length)}
    if cfg.meta_held_notes:
        heads["held"] = (2, 1, T)
    if name == "merge":
        t_heads, d_heads = ["notes", "velocity"], ["instrument"]
    elif name == "no_fused_decoder":
        t_heads, d_heads = list(heads), []
    elif name == "teacher_force":
        t_heads, d_heads = [], ["velocity", "instrument"]
    else:
        t_heads, d_heads = [], list(heads)
    want = {"A bf16": layers, "C bf16": layers, "W bf16": 2 * layers, "W f32": layers}
    for h in d_heads:
        d, n, _ = heads[h]
        dt = "bf16" if d >= 8 else "f32"
        for k, v in ((f"D {dt}", 1), (f"E {dt}", 1), (f"W {dt}", 1 + 2 * n), ("W f32", n)):
            want[k] = want.get(k, 0) + v
    t_cells = sum(heads[h][1] * heads[h][2] for h in t_heads)
    if t_cells:
        want["T bf16"] = t_cells
    return want


def test_config_loss_and_metrics_match_jax(config_pair, monkeypatch):
    """The loss and every metric, and the builds one step takes (the spies
    count the wrappers' calls on the CPU path, where a card launches)."""
    name, cfg, params, batch, noise, want_loss, want_metrics, _ = config_pair
    spy = _build_spy(monkeypatch)
    loss, metrics, grads = _port_step(cfg, params, batch, noise)
    np.testing.assert_allclose(loss, want_loss, rtol=0, atol=LOSS_ATOL)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=0, atol=LOSS_ATOL, err_msg=k)
    assert _builds(spy) == _want_builds(name, cfg)


def test_config_every_gradient_matches_jax(config_pair):
    name, cfg, params, batch, noise, _, _, want = config_pair
    _, _, got = _port_step(cfg, params, batch, noise)
    assert sorted(got) == sorted(want), name
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == np.float32
        scale = max(np.abs(w).max(), 1e-12)
        rel_l2 = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert rel_l2 <= GRAD_REL_L2, f"{name} {k}: relative L2 {rel_l2:.3e}"
        assert np.abs(g - w).max() <= GRAD_REL_MAX * scale, f"{name} {k}"


# ---------------------------------------------------------------------------
# (f) the dispatch on CUDA, decided from the device type
# ---------------------------------------------------------------------------

# the configs that raised naming D and E or A, C and W in bf16 before their
# builds were ported; with fused_train_encoder=False the encoder is X
NOW_PORTED = {
    "gru_fused_decoder": {"fused_train_encoder": False},
    "gru_merged": {"fused_train_encoder": False, "merge_decoder_scans": True},
    "gru_teacher_forced": {"fused_train_encoder": False, "teacher_force": True},
    "gru_fused_encoder": {"fused_train_decoder": False},
}


@pytest.mark.parametrize("name", sorted(NOW_PORTED))
def test_formerly_unported_bf16_configs_train_through_the_bf16_builds(name, monkeypatch):
    """On CUDA as on the CPU these configs train: (steps, layers) of
    ``train_kernels``; one CPU step's spies count the bf16 builds each takes
    (D and E bf16 on the notes and instrument heads, f32 on the velocity
    head; A and C bf16 where the encoder is fused) and no float32 build of A
    or C, no wide build."""
    cfg = small_test_config(compute_dtype="bfloat16", **NOW_PORTED[name])
    params = MidiVAE(cfg).init_params(np.array([0, 5], np.uint32))
    model = MidiVAE(cfg, params)
    for device in ("cuda", "cpu"):
        assert model.train_kernels(torch.device(device)) == (True, True)
        assert model.train_kernels_enabled(torch.device(device)) is True
    spy = _build_spy(monkeypatch)
    _port_step(cfg, params, make_batch(cfg, seed=2),
               np.zeros((B, cfg.latent_dim), np.float32))
    found = _builds(spy)
    T = cfg.output_length
    d_heads = {"gru_fused_decoder": 3, "gru_merged": 1, "gru_teacher_forced": 2,
               "gru_fused_encoder": 0}[name]
    if name == "gru_fused_encoder":
        assert found["A bf16"] == found["C bf16"] == 4 and "X" not in found
        assert found["T bf16"] == 2 * T + T + cfg.meta_instrument_length
    else:
        assert found["X"] == 4 and not any(k.startswith(("A ", "C ")) for k in found)
        assert found["D bf16"] == found["E bf16"] == d_heads - (name != "gru_merged")
        assert found.get("D f32", 0) == found.get("E f32", 0) == (name != "gru_merged")
        assert found.get("T bf16", 0) == {"gru_fused_decoder": 0, "gru_merged": 3 * T,
                                          "gru_teacher_forced": 0}[name]
    assert not any(k.startswith(("D_wide", "F")) for k in found)


def test_route_is_decided_from_the_bf16_builds():
    """``config_route`` of a bf16 config dispatches each part at the
    config's batch and checks the bf16 builds of its rows: Config()'s parts
    take A, C, D and E in bf16 (D and E at float32 for heads narrower than
    8), the narrow route; forced onto those rows at H = 512, where D's and
    E's 8-row bf16 builds do not launch, the head takes the 2-row builds
    with row 8's rounding; the rows the TPU runs at H = 512 and B = 256 are
    the wide ones, whose bf16 builds train it on CUDA too."""
    from midi_vae_tpu_torch.config import Config

    assert _layout.config_route(Config(compute_dtype="bfloat16")) == "narrow"
    assert _layout.head_builds("inplace", 61, 256, 2) == ("D_bf16", "E_bf16")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_layout, "FORCE_ROUTE", "narrow")
        assert _layout.bf16_head_mode(256, 61, 512, 2, on_card=True) == "inplace"
        assert _layout.head_builds("inplace", 61, 512, 2) == ("D_wide_bf16", "E_wide_row8_bf16")
        assert _layout.launch_limit("D_bf16", 512, _layout.smem_bytes("D_bf16", 512, 61, 2))
    wide = Config(compute_dtype="bfloat16", lstm_size=512)
    assert _layout.config_route(wide) == "wide"
    for cfg in (wide, Config(compute_dtype="bfloat16")):
        assert MidiVAE(cfg, {}).train_kernels(torch.device("cuda")) == (True, True)
