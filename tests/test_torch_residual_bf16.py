"""CPU parity of ``decode_residual_bf16`` against the JAX package: the
multi-head decode (rows 5 and 6: kernel D's and E's bf16-residual builds, W
over the rounded sequences) with its h sequences stored in bfloat16, the
configs that run it (the soak's ``residual_bf16`` and
``held_residual_bf16``, ``tools/tpu_soak.py:47-51``), and the dispatch that
decides where the multi-head call runs (``mh_vmem_ok``, a copy of
``_mh_vmem_ok``).

The JAX side runs its Pallas kernels in interpret mode
(``interpret=True``, ``MidiVAE._interpret = True``); the port runs the
kernels' plain versions (CPU tensors) through the autograd Function the
card runs. Same numpy inputs on both sides. Tolerances:
- forward values: rtol 2e-5, atol 2e-6 (float32, as tests/test_torch_ops.py),
  and bit-equal to the port's own float32-residual forward (the carries,
  probs and logits never read the rounded sequences);
- every VJP: rtol 3e-4, atol 2e-6, the JAX package's own tolerance of its
  multi-head kernel against its reference (tests/test_ops_train.py:540-546);
  the port's float32-residual gradients, as a control, must miss it;
- the configs' loss and metrics: atol 1e-5; every parameter gradient: atol
  1e-5 + rtol 1e-4 (as tests/test_torch_train.py).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.ops import fused_train as ft
from midi_vae_tpu_torch.config import Config
from midi_vae_tpu_torch.models import vae as port_vae
from midi_vae_tpu_torch.models.vae import MidiVAE
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import grad_reduce as port_gr
from midi_vae_tpu_torch.ops import gru_decode as port_decode
from test_torch_ops import _close, _decode_case, _port_head, _sin_cos_cotangent, _sin_cos_t
from test_torch_wide import B, _assert_step_matches, _jax_step, _port_step, _Spy, make_batch

BF = torch.bfloat16
VJP_RTOL, VJP_ATOL = 3e-4, 2e-6
ACTS = ("softmax", "sigmoid", "linear")


# ---------------------------------------------------------------------------
# the op: gru_decode_multihead_train with bf16 residuals
# ---------------------------------------------------------------------------

def _mh_case(n_side, primary_act):
    """A 2-layer primary head (D 7) and ``n_side`` 1-layer side heads (D 1,
    2), H 16, B 5; the output activations rotate from ``primary_act``."""
    T, Bn, H = 6, 5, 16
    primary = _decode_case(2, 7, H, Bn, 11)
    side = [_decode_case(1, 1, H, Bn, 12), _decode_case(1, 2, H, Bn, 13)][:n_side]
    i = ACTS.index(primary_act)
    out_acts = tuple(ACTS[(i + k) % 3] for k in range(1 + n_side))
    return T, primary, side, out_acts


def _port_mh(primary, side, T, out_acts, residual_dtype):
    """The port's outputs and every leaf's gradient of sum(sin(probs)) +
    0.3 sum(cos(logits))."""
    port = [_port_head(s) for s in [primary, *side]]
    outs = port_decode.gru_decode_multihead_train(port[0][1], [h for _, h in port[1:]], T,
                                                  "tanh", out_acts, residual_dtype)
    grads = torch.autograd.grad(_sin_cos_t(outs), [t for leaves, _ in port for t in leaves])
    return outs, grads


def _jax_mh(primary, side, T, out_acts):
    jp = jax.tree_util.tree_map(jnp.asarray, primary)
    jh = tuple(jax.tree_util.tree_map(jnp.asarray, s) for s in side)
    outs, vjp = jax.vjp(lambda p, hs: ft.gru_decode_multihead_train(
        p, hs, T, "tanh", out_acts, True, jnp.bfloat16), jp, jh)
    gp, gh = vjp(_sin_cos_cotangent(outs))
    want = []
    for g in [gp, *gh]:
        want += [g["start"], *g["init"], *[c[k] for c in g["cells"] for k in ("w", "u", "b")],
                 g["out"]["w"], g["out"]["b"]]
    return outs, want


def _vjp_close(got, want) -> bool:
    return all(np.allclose(g.numpy(), np.asarray(w), rtol=VJP_RTOL, atol=VJP_ATOL)
               for g, w in zip(got, want))


@pytest.mark.parametrize("primary_act", ACTS)
@pytest.mark.parametrize("n_side", [1, 2])
def test_multihead_bf16_residuals_match_jax(n_side, primary_act):
    """probs and logits against JAX's and bit-equal to the port's float32
    residuals; every VJP within the JAX package's own tolerance of its
    bf16-residual kernel, where the float32-residual gradients land outside."""
    T, primary, side, out_acts = _mh_case(n_side, primary_act)
    want_outs, want = _jax_mh(primary, side, T, out_acts)
    outs, got = _port_mh(primary, side, T, out_acts, BF)
    f32_outs, f32_got = _port_mh(primary, side, T, out_acts, None)
    for (p, lg), (wp, wl), (fp, fl) in zip(outs, want_outs, f32_outs):
        _close(p.detach(), wp)
        _close(lg.detach(), wl)
        assert p.dtype == lg.dtype == torch.float32
        assert torch.equal(p, fp) and torch.equal(lg, fl)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=VJP_RTOL, atol=VJP_ATOL,
                                   err_msg=f"leaf {i}")
    assert not _vjp_close(f32_got, want), "the float32 residuals land inside the tolerance"


def test_bf16_residual_forward_stores_the_rounded_sequences():
    """Kernel D's plain version with bf16 residuals: probs and logits equal
    the float32 instance's, every stored sequence equals the float32
    instance's rounded to bf16; kernel E's reads them (the launches count
    nothing on the CPU)."""
    T, primary, side, out_acts = _mh_case(2, "softmax")
    heads = [dict(_port_head(s)[1], T=T, out_activation=a)
             for s, a in zip([primary, *side], out_acts)]
    with torch.no_grad():
        rounded = port_decode.gru_decode_fwd_train(heads, "D_resid")
        exact = port_decode.gru_decode_fwd_train(heads)
    for (p, lg, hs), (fp, fl, fhs) in zip(rounded, exact):
        assert torch.equal(p, fp) and torch.equal(lg, fl)
        assert [h.dtype for h in hs] == [BF] * len(fhs)
        assert all(torch.equal(h, f.to(BF)) for h, f in zip(hs, fhs))
    # the bf16-residual builds hold 8 rows a block: there is no wide one
    with pytest.raises(ValueError, match="builds"):
        port_decode.gru_decode_fwd_train_wide(heads, "D_wide_resid")
    assert port_decode.gru_decode_fwd_train.launches_resid == 0


# ---------------------------------------------------------------------------
# the configs: loss, metrics, every gradient, the builds one step takes
# ---------------------------------------------------------------------------

RESIDUAL_CONFIGS = {"residual_bf16": {"decode_residual_bf16": True},
                    "held_residual_bf16": {"decode_residual_bf16": True, "meta_held_notes": True}}


def _spy(monkeypatch):
    return _Spy(monkeypatch, {
        "D": (port_decode, "gru_decode_fwd_train"), "E": (port_decode, "gru_decode_bwd"),
        "D_wide": (port_decode, "gru_decode_fwd_train_wide"),
        "E_wide": (port_decode, "gru_decode_bwd_wide"),
        "W": [(port_gr, "grad_reduce"), (port_decode, "grad_reduce")],
    })


def _builds(spy) -> dict:
    """{build: calls}: D and E by the build they are asked for (resid or
    f32), W by its first operand's dtype."""
    found: dict = {}
    for name, calls in spy.calls.items():
        for args, _ in calls:
            if name == "W":
                key = f"W {'bf16' if args[0].dtype == BF else 'f32'}"
            elif name in ("D", "E"):
                key = f"{name} {'resid' if args[1] == f'{name}_resid' else 'f32'}"
            else:
                key = name
            found[key] = found.get(key, 0) + 1
    return found


def _want_builds(cfg) -> dict:
    """One step: the notes, velocity (and held) heads in one multi-head call
    through the bf16-residual D and E, the instrument head through the f32
    ones; W over the rounded sequences for each multi-head head's dWo and
    the notes layer 2's dW (x = the rounded h1), in float32 for the rest (3
    per encoder layer, the instrument head's 4, each multi-head cell's dU
    over h_{t-1} beside the unrounded initial state and r * h, layer 1's dW
    over the float32 probs)."""
    side = 1 + cfg.meta_held_notes
    layers = 4 + cfg.meta_held_notes
    return {"D resid": 1, "D f32": 1, "E resid": 1, "E f32": 1,
            "W bf16": 2 + side, "W f32": 3 * layers + 4 + 5 + 3 * side}


@pytest.fixture(scope="module", params=sorted(RESIDUAL_CONFIGS))
def residual_pair(request):
    cfg = small_test_config(**RESIDUAL_CONFIGS[request.param])
    params = MidiVAE(cfg).init_params(np.array([0, 7], np.uint32))
    batch = make_batch(cfg)
    return request.param, cfg, params, batch, _jax_step(cfg, params, batch)


def test_residual_config_loss_and_metrics_match_jax(residual_pair, monkeypatch):
    """The loss and every metric against the JAX model in interpret mode,
    with the builds one step takes (spies on the CPU path, where a card
    launches)."""
    name, cfg, params, batch, want = residual_pair
    spy = _spy(monkeypatch)
    loss, metrics, _ = _port_step(cfg, params, batch, want[3])
    np.testing.assert_allclose(loss, want[0], rtol=0, atol=1e-5)
    for k, v in want[1].items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=0, atol=1e-5, err_msg=k)
    assert _builds(spy) == _want_builds(cfg), name


def test_residual_config_every_gradient_matches_jax(residual_pair):
    _name, cfg, params, batch, want = residual_pair
    _assert_step_matches(cfg, params, batch, want)


# ---------------------------------------------------------------------------
# the dispatch: where the multi-head call runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", [128, 256, 512])
def test_mh_vmem_ok_is_the_jax_predicate(H):
    for Bn, dks in itertools.product((32, 64, 128, 256, 512, 1024), ([1], [1, 2])):
        assert _layout.mh_vmem_ok(Bn, 61, dks, H) == ft._mh_vmem_ok(Bn, 61, dks, H), (Bn, dks)


def test_multihead_follows_the_batch():
    """``_multihead`` reads ``_mh_vmem_ok`` at the batch the decode is
    called with: Config() at B = 256 takes the multi-head call (its launch
    counts do not move), at B = 512 the TPU declines it (H = 256), and at
    H = 512 it declines it for every batch."""
    for held in (False, True):
        cfg = Config(decode_residual_bf16=True, meta_held_notes=held)
        assert port_vae._multihead(cfg, "narrow", 256) is True
        assert port_vae._multihead(cfg, "narrow", 512) is False
        wide = Config(lstm_size=512, meta_held_notes=held)
        assert not any(port_vae._multihead(wide, r, b) for r in ("narrow", "wide")
                       for b in (32, 128, 256))


def test_flag_is_a_noop_where_the_multihead_call_is_declined(monkeypatch):
    """At (B 512, H 256) the TPU declines the multi-head kernel, so the flag
    does nothing: mirrored at small widths (the JAX ``_mh_use_pallas`` and
    the port's ``mh_vmem_ok`` refusing), the step with the flag equals the
    step without it bit for bit, decodes every head alone through the
    float32 D and E, and matches the JAX model."""
    monkeypatch.setattr(ft, "_mh_use_pallas", lambda *a: False)
    monkeypatch.setattr(_layout, "mh_vmem_ok", lambda *a: False)
    cfg = small_test_config(decode_residual_bf16=True)
    params = MidiVAE(cfg).init_params(np.array([0, 7], np.uint32))
    batch = make_batch(cfg)
    want = _jax_step(cfg, params, batch)
    spy = _spy(monkeypatch)
    loss, _, grads = _port_step(cfg, params, batch, want[3])
    assert _builds(spy) == {"D f32": 3, "E f32": 3, "W f32": 3 * 4 + 7 + 4 + 4}
    off_loss, _, off_grads = _port_step(small_test_config(), params, batch, want[3])
    assert loss == off_loss
    assert all(torch.equal(grads[k], off_grads[k]) for k in grads if grads[k] is not None)
    _assert_step_matches(cfg, params, batch, want)


def test_flag_raises_on_the_card_off_the_narrow_route():
    """At H = 416, 448 and 480 the float32 route is wide (D's and E's 8-row
    builds do not launch), while ``_mh_vmem_ok`` still admits the multi-head
    call with the velocity head (at B = 32; at 480, B = 16). Without the flag the per-head
    wide builds compute its function; with ``decode_residual_bf16`` its
    sequences are stored rounded, which D resid's build does on the decode
    chain at every multiple of 32: at H = 448, where E resid's chain
    launches too, the call runs rows 5 and 6 on the card. At 416 and 480
    E's chain refuses H not a multiple of 64, so the card raises
    NotImplementedError naming rows 5 and 6, that limit and ROADMAP Queue 2
    item 4, and the CPU runs their plain versions (at 416 and 480 no whole
    step runs on the card: C's chain refuses those widths too). Where the
    JAX package declines the call at H = 448 (B = 64; the held head beside
    it at B = 32), the flag is a no-op and nothing raises."""
    # the batches at which the JAX package admits the call there
    for H_, Bn in ((416, 32), (448, 32), (480, 16)):
        cfg = Config(lstm_size=H_, decode_residual_bf16=True)
        assert ft._mh_vmem_ok(Bn, cfg.output_dim, [1], H_)
        if H_ == 448:
            assert _layout.config_route(cfg) == "wide"
            assert port_vae._multihead(cfg, "wide", Bn, on_card=True) is True
        else:
            # no route's every build launches there (C's and E's chains)
            with pytest.raises(_layout.LaunchLimitError, match="multiple of 64"):
                _layout.config_route(cfg)
            with pytest.raises(NotImplementedError,
                               match=r"rows 5 and 6.*multiple of 64.*Queue 2 item 4"):
                port_vae._multihead(cfg, "wide", Bn, on_card=True)
        assert port_vae._multihead(cfg, "wide", Bn) is True
        assert port_vae._multihead(Config(lstm_size=H_), "wide", Bn, on_card=True) is False
    assert not ft._mh_vmem_ok(64, cfg.output_dim, [1], 448)
    cfg = Config(lstm_size=448, decode_residual_bf16=True)
    assert port_vae._multihead(cfg, "wide", 64, on_card=True) is False
    held = Config(lstm_size=448, decode_residual_bf16=True, meta_held_notes=True)
    assert not ft._mh_vmem_ok(32, held.output_dim, [1, 2], 448)
    assert port_vae._multihead(held, "wide", 32, on_card=True) is False
