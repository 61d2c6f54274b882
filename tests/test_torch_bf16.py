"""CPU parity of bf16 training with the whole-scan encoders against the JAX
package: kernels X and Y (``ops/encoder_scan.py``: rows 26, 27, 32 and 33)
and the bf16 builds of T and S (rows 28 and 30 in bf16), their plain
versions against the JAX functions, and the two configs that run them.

The JAX side runs its Pallas kernels in interpret mode (``interpret=True``,
``MidiVAE._interpret = True``); the port runs the kernels' plain versions
(CPU tensors). Same numpy inputs, cast to bf16 the same way on both sides
(round to nearest even). Tolerances:
- float32, the algorithm: values atol 1e-5; VJPs atol 1e-5 + rtol 1e-4;
- bf16 values: atol 4e-3, about one bf16 step (2**-8) of the carried state,
  whose entries lie in [-1, 1]. The plain versions compute as the Pallas
  kernels (products and gates in float32, the state rounded once a step),
  so they meet the kernels within a rounding flip of sums taken in another
  order; they meet the JAX references in bf16 only as far as those
  references do (``_encoder_scan_reference`` rounds every GRU op to bf16,
  1.2e-2 from its own Pallas kernel at this size);
- bf16 VJPs (the remat backward against ``jax.vjp`` of the JAX reference):
  each gradient within 5e-2 of its largest entry (measured: up to 3.0e-2
  for the scans, 1.2e-2 for the cells). The port differentiates the same
  formulas as the JAX custom VJPs (the GRU's every op in bf16, S's x @ W +
  b in bf16: ``test_bf16_remat_backward_rounds_as_the_jax_reference`` pins
  that exactly); what is left is XLA's rounding on the CPU, which fuses
  bf16 elementwise ops where PyTorch rounds each: differentiating the
  forward's float32-inside formula instead lands as far from ``jax.vjp``
  (relative L2 0.3-1.2 % per gradient either way);
- the two slice configs' loss and metrics: atol 5e-4; every parameter
  gradient: relative L2 error <= 3e-2 and max|diff| <= 4e-2 of its largest
  entry. Measured here (the fixture's seeds): |dloss| 1.4e-4 (GRU) and
  2.3e-4 (LSTM), worst gradient 1.4e-2 relative L2, 1.7e-2 of its largest
  entry; the JAX package's own interpret and reference paths differ by up
  to 2.3e-4 in the loss and 1.8e-2 in a gradient on the same configs. Both
  sides draw the reparameterization noise as ``sample_z`` does in a bf16
  model: ``jax.random.normal`` in bf16.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.models.vae import MidiVAE as JaxVAE
from midi_vae_tpu.models.vae import loss_and_metrics as jax_loss
from midi_vae_tpu.ops import fused_decoder, fused_gru, fused_lstm, fused_train
from midi_vae_tpu_torch import bridge
from midi_vae_tpu_torch.config import Config
from midi_vae_tpu_torch.models import vae as port_vae
from midi_vae_tpu_torch.models.vae import MidiVAE, loss_and_metrics
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import encoder_scan as port_scan
from midi_vae_tpu_torch.ops import gru_step as port_gru_step
from midi_vae_tpu_torch.ops import lstm_step as port_lstm_step
from test_torch_wide import B, _port_step, _Spy, make_batch

BF16_ATOL = 4e-3
BF16_GRAD_REL = 5e-2
F32_ATOL, F32_GRAD_RTOL = 1e-5, 1e-4
LOSS_ATOL = 5e-4
GRAD_REL_L2, GRAD_REL_MAX = 3e-2, 4e-2
ACTIVATIONS = ["tanh", "sigmoid", "relu"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the two slice configs, at small_test_config's widths
SLICE_CONFIGS = {
    "gru": {"compute_dtype": "bfloat16", "fused_train_encoder": False,
            "fused_train_decoder": False},
    "lstm": {"cell_type": "LSTM", "compute_dtype": "bfloat16", "fused_train_encoder": False},
}


def _pair(a, dtype):
    """numpy a -> (jnp, torch) of ``dtype``, rounded the same way."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32).copy()).to(td)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _scan_inputs(kind, T=12, B=16, H=32, seed=0):
    """xp (T, B, G), the initial states and U of one layer."""
    rng = np.random.RandomState(seed)
    G = (4 if kind == "lstm" else 3) * H
    xp = rng.randn(T, B, G).astype(np.float32)
    states = [(0.5 * np.tanh(rng.randn(B, H))).astype(np.float32)
              for _ in range(2 if kind == "lstm" else 1)]
    u = (rng.randn(H, G) / np.sqrt(H)).astype(np.float32)
    return xp, states, u


def _jax_scan(kind, grid, activation, rs):
    """The JAX whole-scan kernel in interpret mode: untiled, or the
    batch-tiled grid with 2 tiles (as ``tests/test_ops.py`` calls it)."""
    mod = fused_lstm if kind == "lstm" else fused_decoder
    if grid == "wide":
        return lambda *a: mod._encoder_scan_wide_pallas(*a, activation, rs, True, a[0].shape[1] // 2)
    return lambda *a: mod._encoder_scan_pallas(*a, activation, rs, True)


SCAN_CASES = [(kind, "untiled", act, rs) for kind in ("gru", "lstm") for act in ACTIVATIONS
              for rs in (True, False)]
SCAN_CASES += [(kind, "wide", "tanh", rs) for kind in ("gru", "lstm") for rs in (True, False)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind, grid, activation, rs", SCAN_CASES,
                         ids=[f"{k}-{g}-{a}-{'seq' if r else 'last'}" for k, g, a, r in SCAN_CASES])
def test_encoder_scan_plain_matches_the_pallas_kernel(kind, grid, activation, rs, dtype):
    """The plain versions of X and Y against ``_encoder_scan_pallas`` (row 26
    or 32) and ``_encoder_scan_wide_pallas`` (row 27 or 33) in interpret
    mode: float32 at 1e-5, bf16 at BF16_ATOL. The wrapper on CPU tensors runs
    the plain version and launches nothing."""
    xp, states, u = _scan_inputs(kind)
    jargs, targs = zip(*(_pair(a, dtype) for a in (xp, *states, u)))
    want = _jax_scan(kind, grid, activation, rs)(*jargs)
    fwd = port_scan.lstm_encoder_scan_fwd if kind == "lstm" else port_scan.gru_encoder_scan_fwd
    got = fwd(*targs, activation, rs)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == tuple(want.shape)
    atol = BF16_ATOL if dtype == "bfloat16" else F32_ATOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)
    assert port_scan.gru_encoder_scan_fwd.launches == port_scan.lstm_encoder_scan_fwd.launches == 0


def test_bf16_plain_versions_round_as_the_pallas_kernels_not_per_op():
    """The fault repaired in the port's plain cells: a bf16 step rounded h @ U
    (and, for the GRU, every op) to bf16 where the Pallas kernels keep float32
    until the state is stored. Over 12 steps the per-op rounding lands
    several bf16 steps away from the Pallas kernels; the repaired plain
    versions stay within one."""
    for kind in ("gru", "lstm"):
        xp, states, u = _scan_inputs(kind, seed=3)
        jargs, targs = zip(*(_pair(a, "bfloat16") for a in (xp, *states, u)))
        want = _np(_jax_scan(kind, "untiled", "tanh", True)(*jargs))
        got = port_scan.lstm_encoder_scan_reference if kind == "lstm" else \
            port_scan.gru_encoder_scan_reference
        assert np.abs(_np(got(*targs, "tanh", True)) - want).max() <= BF16_ATOL
        per_op = _per_op_bf16_scan(kind, *targs)
        assert np.abs(_np(per_op) - want).max() > BF16_ATOL


def _per_op_bf16_scan(kind, xp, *rest):
    """The scan as the parent's plain cells ran it in bf16: every op's
    result rounded to bf16 (``h @ u`` included)."""
    u = rest[-1]
    H = u.shape[0]
    h, c = rest[0], (rest[1] if kind == "lstm" else None)
    seq = []
    for t in range(xp.shape[0]):
        x = xp[t]
        if kind == "lstm":
            g = x + h @ u
            c = torch.sigmoid(g[:, H:2 * H]) * c + torch.sigmoid(g[:, :H]) * torch.tanh(
                g[:, 2 * H:3 * H])
            h = torch.sigmoid(g[:, 3 * H:]) * torch.tanh(c)
        else:
            hu = h @ u[:, :2 * H]
            z = torch.sigmoid(x[:, :H] + hu[:, :H])
            r = torch.sigmoid(x[:, H:2 * H] + hu[:, H:])
            hh = torch.tanh(x[:, 2 * H:] + (r * h) @ u[:, 2 * H:])
            h = z * h + (1 - z) * hh
        seq.append(h)
    return torch.stack(seq)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rs", [True, False], ids=["seq", "last"])
@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_encoder_scan_remat_backward_matches_jax_vjp(kind, rs, dtype):
    """``gru_encoder_scan`` and ``lstm_encoder_scan`` (autograd: the plain
    scan recomputed) against ``jax.vjp`` of ``fused_encoder_scan`` and
    ``fused_lstm_encoder_scan`` (``_fes_bwd``, ``_fles_bwd``: the reference
    scan under jax.vjp)."""
    xp, states, u = _scan_inputs(kind, seed=1)
    jargs, targs = zip(*(_pair(a, dtype) for a in (xp, *states, u)))
    if kind == "lstm":
        jax_fn = lambda *a: fused_lstm.fused_lstm_encoder_scan(*a, "tanh", rs, True)  # noqa: E731
        port_fn = port_scan.lstm_encoder_scan
    else:
        jax_fn = lambda *a: fused_decoder.fused_encoder_scan(*a, "tanh", rs, True)  # noqa: E731
        port_fn = port_scan.gru_encoder_scan
    want, vjp = jax.vjp(jax_fn, *jargs)
    cot = jnp.cos(3.0 * want.astype(jnp.float32)).astype(want.dtype)
    want_grads = vjp(cot)
    leaves = [t.clone().requires_grad_() for t in targs]
    got = port_fn(*leaves, "tanh", rs)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(_np(cot).copy()).to(got.dtype))
    for name, g, w in zip(("xp", "h0", "c0", "u")[:len(leaves)] if kind == "lstm"
                          else ("xp", "h0", "u"), grads, want_grads):
        assert g.dtype == DTYPES[dtype][1]
        if dtype == "bfloat16":
            limit = BF16_GRAD_REL * np.abs(_np(w)).max()
            assert np.abs(_np(g) - _np(w)).max() <= limit, f"{kind} d{name}"
        else:
            np.testing.assert_allclose(_np(g), _np(w), rtol=F32_GRAD_RTOL, atol=F32_ATOL,
                                       err_msg=f"{kind} d{name}")


def _jax_reference_rounding(name):
    """(inputs, fn) of the JAX reference that the bf16 backward of X, Y, T
    or S differentiates, written out op by op: the GRU's
    ``_encoder_scan_reference`` and ``_gru_step_reference`` in bf16 every
    op; the LSTM's ``_encoder_scan_reference`` and ``_lstm_step_reference``
    with ``_lstm_gates``' float32 product, x @ W + b rounded to bf16 first."""
    def lstm_gates(xp, h, c, u):
        H = h.shape[-1]
        gates = xp.float() + h.float() @ u.float()
        i, f = torch.sigmoid(gates[:, :H]), torch.sigmoid(gates[:, H:2 * H])
        g, o = torch.tanh(gates[:, 2 * H:3 * H]), torch.sigmoid(gates[:, 3 * H:])
        c = f * c.float() + i * g
        return (o * torch.tanh(c)).to(h.dtype), c.to(h.dtype)

    def lstm_scan(xp, h, c, u):
        seq = []
        for t in range(xp.shape[0]):
            h, c = lstm_gates(xp[t], h, c, u)
            seq.append(h)
        return torch.stack(seq)

    kind = "lstm" if name in ("Y", "S") else "gru"
    if name in ("X", "Y"):
        xp, states, u = _scan_inputs(kind, seed=4)
        inputs = [_pair(a, "bfloat16")[1] for a in (xp, *states, u)]
        return inputs, (lstm_scan if kind == "lstm" else
                        lambda *a: _per_op_bf16_scan("gru", *a))
    x, states, w, b, u = _cell_inputs(kind, seed=4)
    inputs = [_pair(a, "bfloat16")[1] for a in (x, *states, w, b, u)]
    if kind == "lstm":
        return inputs, lambda x, h, c, w, b, u: lstm_gates(x @ w + b, h, c, u)
    return inputs, lambda x, h, w, b, u: _per_op_bf16_scan("gru", (x @ w + b)[None], h, u)[0]


@pytest.mark.parametrize("name", ["X", "Y", "T", "S"])
def test_bf16_remat_backward_rounds_as_the_jax_reference(name):
    """The bf16 backward of X, Y, T and S differentiates what the JAX custom
    VJPs differentiate (``_fes_bwd``, ``_fles_bwd``, ``_gru_step_bwd``,
    ``_lstm_step_bwd``), not the forward's Pallas rounding: the GRU's every
    op in bf16, S's x @ W + b in bf16. Autograd through the references
    written out op by op (in the port's op order, which fixes the order bf16
    gradients are summed in) gives the same gradients; the forward's
    rounding lands whole bf16 steps away."""
    inputs, reference = _jax_reference_rounding(name)
    port = {"X": lambda *a: port_scan.gru_encoder_scan(*a, "tanh", True),
            "Y": lambda *a: port_scan.lstm_encoder_scan(*a, "tanh", True),
            "T": lambda *a: port_gru_step.gru_cell_step(*a, "tanh"),
            "S": lambda *a: port_lstm_step.lstm_cell_step(*a, "tanh")}[name]
    leaves = [t.clone().requires_grad_() for t in inputs]
    got = port(*leaves)
    got = got if isinstance(got, tuple) else (got,)
    cot = [torch.cos(3.0 * g.detach().float() + k).to(g.dtype) for k, g in enumerate(got)]
    grads = torch.autograd.grad(got, leaves, cot)
    ref_leaves = [t.clone().requires_grad_() for t in inputs]
    want = reference(*ref_leaves)
    want = want if isinstance(want, tuple) else (want,)
    want_grads = torch.autograd.grad(want, ref_leaves, cot)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert g.dtype == torch.bfloat16
        assert np.abs(_np(g) - _np(w)).max() <= 1e-6 * np.abs(_np(w)).max(), f"{name} grad {i}"


def _cell_inputs(kind, B=10, D=12, H=32, seed=2):
    rng = np.random.RandomState(seed)
    G = (4 if kind == "lstm" else 3) * H
    x = np.abs(rng.randn(B, D)).astype(np.float32) / D
    states = [(0.5 * np.tanh(rng.randn(B, H))).astype(np.float32)
              for _ in range(2 if kind == "lstm" else 1)]
    w = (rng.randn(D, G) / np.sqrt(D)).astype(np.float32)
    u = (rng.randn(H, G) / np.sqrt(H)).astype(np.float32)
    b = (0.1 * rng.randn(G)).astype(np.float32)
    return x, states, w, b, u


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_cell_steps_match_the_pallas_kernels(kind, activation, dtype):
    """T and S (``gru_cell_step``, ``lstm_cell_step``) in float32 and in
    bf16 (their bf16 builds' plain versions) against ``_gru_step_pallas``
    and ``_lstm_step_pallas`` in interpret mode; their remat VJPs against
    ``jax.vjp`` of ``gru_step`` and ``lstm_step``."""
    x, states, w, b, u = _cell_inputs(kind)
    (jx, tx), *rest = (_pair(a, dtype) for a in (x, *states, w, b, u))
    jst, tst = zip(*rest[:len(states)])
    (jw, tw), (jb, tb), (ju, tu) = rest[len(states):]
    if kind == "lstm":
        jax_fn = lambda x, h, c, w, b, u: fused_lstm.lstm_step(x, h, c, w, u, b, activation, True)  # noqa: E731
        pallas = fused_lstm._lstm_step_pallas(jx, *jst, jw, ju, jb, activation, True)
        port_fn = lambda *a: port_lstm_step.lstm_cell_step(*a, activation)  # noqa: E731
    else:
        jax_fn = lambda x, h, w, b, u: fused_gru.gru_step(x, h, w, u, b, activation, True)  # noqa: E731
        pallas = (fused_gru._gru_step_pallas(jx, *jst, jw, ju, jb, activation, True),)
        port_fn = lambda *a: port_gru_step.gru_cell_step(*a, activation)  # noqa: E731
    leaves = [t.clone().requires_grad_() for t in (tx, *tst, tw, tb, tu)]
    got = port_fn(*leaves)
    got = got if isinstance(got, tuple) else (got,)
    atol = BF16_ATOL if dtype == "bfloat16" else F32_ATOL
    for g, w_ in zip(got, pallas):
        assert g.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(_np(g), _np(w_), rtol=0, atol=atol)
    want, vjp = jax.vjp(jax_fn, jx, *jst, jw, jb, ju)
    want = want if isinstance(want, tuple) else (want,)
    cot = [jnp.cos(3.0 * w_.astype(jnp.float32) + k).astype(w_.dtype) for k, w_ in enumerate(want)]
    want_grads = vjp(tuple(cot) if len(cot) > 1 else cot[0])
    grads = torch.autograd.grad(got, leaves, [torch.from_numpy(_np(c).copy()).to(g.dtype)
                                              for c, g in zip(cot, got)])
    for i, (g, w_) in enumerate(zip(grads, want_grads)):
        if dtype == "bfloat16":
            assert np.abs(_np(g) - _np(w_)).max() <= BF16_GRAD_REL * np.abs(_np(w_)).max(), i
        else:
            np.testing.assert_allclose(_np(g), _np(w_), rtol=F32_GRAD_RTOL, atol=F32_ATOL,
                                       err_msg=str(i))
    assert port_gru_step.gru_cell_step_fwd.launches_bf16 == 0
    assert port_lstm_step.lstm_cell_step_fwd.launches_bf16 == 0


# ---------------------------------------------------------------------------
# the two slice configs: loss, metrics, every gradient, and the dispatch
# ---------------------------------------------------------------------------

def _spy(monkeypatch):
    """One entry per kernel a CUDA run of the slice configs (or of what they
    must not run) would launch, on the CPU path."""
    from midi_vae_tpu_torch.models import rnn
    from midi_vae_tpu_torch.ops import gru_decode, gru_layer, lstm_layer

    return _Spy(monkeypatch, {
        "X": (port_scan, "gru_encoder_scan_fwd"), "Y": (port_scan, "lstm_encoder_scan_fwd"),
        "T": (port_gru_step, "gru_cell_step_fwd"), "S": (port_lstm_step, "lstm_cell_step_fwd"),
        "T_xp": (port_gru_step, "gru_recurrent_step_fwd"),
        "S_xp": (port_lstm_step, "lstm_recurrent_step_fwd"),
        "A": [(gru_layer, "gru_layer"), (rnn, "gru_layer")],
        "L": [(lstm_layer, "lstm_layer"), (rnn, "lstm_layer")],
        "D": (gru_decode, "gru_decode_fwd_train"),
    })


@pytest.fixture(scope="module", params=sorted(SLICE_CONFIGS))
def slice_pair(request):
    """(name, cfg, numpy params, batch, noise, jax loss, metrics, flat grads)
    of one slice config, the JAX side with its kernels in interpret mode."""
    cfg = small_test_config(**SLICE_CONFIGS[request.param])
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


def test_slice_loss_and_metrics_match_jax(slice_pair, monkeypatch):
    """The loss and every metric, and the launches one forward implies: X or
    Y once per encoder layer (notes 2, instrument, velocity), T or S once per
    head cell and step, in bf16, and none of the float32 training kernels."""
    name, cfg, params, batch, noise, want_loss, want_metrics, _ = slice_pair
    spy = _spy(monkeypatch)
    loss, metrics, _ = _port_step(cfg, params, batch, noise)
    np.testing.assert_allclose(loss, want_loss, rtol=0, atol=LOSS_ATOL)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=0, atol=LOSS_ATOL, err_msg=k)
    per_head = 2 * cfg.output_length + cfg.meta_velocity_length + cfg.meta_instrument_length
    scan, cell = ("Y", "S") if name == "lstm" else ("X", "T")
    assert spy.count() == {scan: 4, cell: per_head}
    for args, _kw in spy.calls[scan] + spy.calls[cell]:
        assert all(a.dtype == torch.bfloat16 for a in args if isinstance(a, torch.Tensor))


def test_slice_every_gradient_matches_jax(slice_pair):
    name, cfg, params, batch, noise, _, _, want = slice_pair
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
# the dispatch on CUDA, decided from the device type
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SLICE_CONFIGS))
def test_slice_configs_take_the_whole_scan_wrappers(name, monkeypatch):
    """On the CPU as on CUDA the slice configs train: (steps, layers) of
    train_kernels, the encoder through the whole-scan wrapper with one
    matmul for xp per layer (also at a width forced down the wide route,
    which the whole-scan encoder ignores), the heads through the cells."""
    cfg = small_test_config(**SLICE_CONFIGS[name])
    model = MidiVAE(cfg, MidiVAE(cfg).init_params(np.array([0, 5], np.uint32)))
    for device in ("cuda", "cpu"):
        assert model.train_kernels(torch.device(device)) == (True, True)
        assert model.train_kernels_enabled(torch.device(device)) is True
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, seed=2).items()}
    scan = "Y" if name == "lstm" else "X"
    for route in (None, "wide"):
        monkeypatch.setattr(_layout, "FORCE_ROUTE", route)
        spy = _spy(monkeypatch)
        with torch.no_grad():
            z_mean, _ = model.encode_stats({k: v.to(torch.bfloat16) for k, v in batch.items()},
                                           inference=False,
                                           params=port_vae._cast_tree(model.params,
                                                                      torch.bfloat16))
        assert z_mean.dtype == torch.bfloat16
        assert spy.count() == {scan: 4}
        # serving stays float32 on the serving kernels (A or L)
        spy = _spy(monkeypatch)
        with torch.no_grad():
            assert model.encode(batch).dtype == torch.float32
        assert spy.count() == {"L" if name == "lstm" else "A": 4}


@pytest.mark.parametrize("cell_type, dtype, H", list(itertools.product(
    ("GRU", "LSTM"), ("float32", "bfloat16"), (128, 256, 512))))
def test_unported_bf16_configs_raise_naming_what_they_wait_for(cell_type, dtype, H):
    """No config at H <= 512 waits for a kernel any more: for every batch
    from 32 to 1024, with ``decode_residual_bf16`` and ``meta_held_notes`` on
    or off, ``config_route`` and ``train_kernels`` dispatch every part on
    CUDA without raising NotImplementedError (a part whose rows have no port
    build that launches) or LaunchLimitError (a width no build launches).
    The last configs that raised were bf16 GRU heads at rows 7 and 8 at
    H = 512, B <= 128 (``head_builds``: the 2-row builds with row 8's
    rounding) and the float32 multi-head decode with bf16 residuals, whose
    dispatch the flag axis checks: on the card ``_multihead`` takes the call
    (and the flag its bf16-residual builds, which
    ``tests/test_torch_residual_bf16.py`` spies on) exactly where the JAX
    package's ``_mh_use_pallas`` runs its kernel (float32, ``_mh_vmem_ok``
    at the batch), without raising."""
    cuda = torch.device("cuda")
    for batch, residual, held in itertools.product((32, 64, 128, 256, 512, 1024), (False, True),
                                                   (False, True)):
        cfg = Config(cell_type=cell_type, compute_dtype=dtype, lstm_size=H, batch_size=batch,
                     decode_residual_bf16=residual, meta_held_notes=held)
        route = _layout.config_route(cfg)
        assert route in ("narrow", "wide", "per-part")
        assert MidiVAE(cfg, {}).train_kernels(cuda) == (True, True)
        tpu = (cell_type == "GRU" and dtype == "float32"
               and fused_train._mh_vmem_ok(batch, cfg.output_dim, [1, 2] if held else [1], H))
        assert port_vae._multihead(cfg, route, batch, on_card=True) is tpu, (batch, residual, held)


def test_multihead_is_declined_in_bf16():
    """``_multihead`` carries ``_mh_use_pallas``'s float32 condition: the
    default GRU config takes the multi-head call in float32 only, so
    ``decode_residual_bf16`` is a no-op in a bf16 model."""
    f32 = small_test_config()
    bf16 = small_test_config(compute_dtype="bfloat16")
    assert port_vae._multihead(f32, "narrow", B) is True
    assert port_vae._multihead(bf16, "narrow", B) is False
    assert port_vae._multihead(small_test_config(compute_dtype="bfloat16",
                                                 decode_residual_bf16=True), "narrow", B) is False
