"""CPU parity of the fused GRU encoder stacks against the JAX package:
kernels U and V (``midi_vae_tpu_torch/ops/encoder_stack.py``, rows 22-25 of
the kernel table), their plain versions against the Pallas kernels
``_stack2_fwd_pallas``, ``_stack2_bwd_pallas``,
``encode_multibranch_train_fwd`` and ``encode_multibranch_train_bwd`` in
interpret mode, and the two ops ``gru_stack2_train_x`` and
``gru_encode_multibranch_train`` (value and every gradient) against the JAX
ops.

Interpret mode runs only where rounding matters: the stack in bf16 (layer 2
takes layer 1's float32 h within the step, so the kernels and the two-layer
reference differ there) and one float32 multi-branch case with a branch
shorter than the stack. In float32 the kernels equal the JAX references
``_stack2_reference`` and ``_encmb_reference`` to the JAX tests' own
tolerance, so the other float32 cases are held against those. Same numpy
inputs on both sides, cast to bf16 the same way (round to nearest even).
Tolerances:
- float32 values: atol 1e-5 (sums taken in another order over <= 12 steps);
  each gradient within 1e-4 of its largest entry (at least 1e-4);
- bf16 values: atol 4e-3, about one bf16 step (2**-8) of the state, whose
  entries lie in [-1, 1], and a relative L2 error |port - jax| / |jax| <=
  1e-3: the plain version and the kernel round the same float32 values once
  a step, and now and then round one entry the other way (measured: 2.1e-4
  at most, often 0). A scan that feeds layer 2 the rounded h1 differs in
  most entries by a step: 2.4e-3 with the kernels' rounding per layer,
  6.4e-3 to 7.5e-3 for the two-layer reference, which also rounds every op
  (the control);
- bf16 outputs of the backward (dx, the dh0s, and the weight grads cast to
  the parameters' bf16): one bf16 step (2**-7) of the output's largest
  entry, from float32 sums taken in another order;
- bf16 gradients of the op through both kernels: 2e-2 of the largest entry,
  since a state entry rounded the other way in the forward feeds the whole
  backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.ops import fused_train as ft
from midi_vae_tpu_torch.models.vae import MidiVAE
from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import encoder_stack as es
from midi_vae_tpu_torch.ops.grad_reduce import gru_weight_grads

F32_ATOL = 1e-5
F32_GRAD_REL = 1e-4
BF16_ATOL = 4e-3
BF16_REL_L2 = 1e-3
BF16_STEP = 2.0 ** -7
BF16_GRAD_REL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype="float32"):
    """numpy a -> (jnp, torch) of ``dtype``, rounded the same way."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32).copy()).to(td)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close_rel(got, want, rel, what):
    """max |got - want| <= rel * max(|want|.max(), 1)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    limit = rel * max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max()
    assert err <= limit, f"{what}: max |diff| {err:.3e} > {limit:.3e}"


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _close_bf16(got, want):
    """A bf16 value: max |diff| <= BF16_ATOL and relative L2 <= BF16_REL_L2."""
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=BF16_ATOL)
    assert _rel_l2(got, want) <= BF16_REL_L2


def _params(rng, d, H):
    return {"w": (0.2 * rng.randn(d, 3 * H)).astype(np.float32),
            "b": (0.05 * rng.randn(3 * H)).astype(np.float32),
            "u": (rng.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32)}


def _stack_inputs(T, B, D, H, seed):
    """x (T, B, D), h01, h02 (B, H), p1, p2 as numpy."""
    rng = np.random.RandomState(seed)
    x = (0.3 * rng.randn(T, B, D)).astype(np.float32)
    h01, h02 = ((0.1 * rng.randn(B, H)).astype(np.float32) for _ in range(2))
    return x, h01, h02, _params(rng, D, H), _params(rng, H, H), rng


def _both(x, h01, h02, p1, p2, dtype):
    """The stack's inputs on both sides: (jax args, torch args)."""
    pairs = [_pair(a, dtype) for a in (x, h01, h02)]
    jp = [{k: _pair(v, dtype)[0] for k, v in p.items()} for p in (p1, p2)]
    tp = [{k: _pair(v, dtype)[1] for k, v in p.items()} for p in (p1, p2)]
    return ([a for a, _ in pairs] + jp), ([b for _, b in pairs] + tp)


def _weight_grads(x, h0, seq, rh, da):
    """dW, db, dU of one layer from the plain backward's gate grads (the
    plain version of kernel W on CPU tensors)."""
    hprev = torch.cat([h0[None], seq[:-1]]).float()
    return gru_weight_grads(x.float(), hprev, rh, da)


@pytest.fixture(scope="module")
def bf16_stack():
    """The bf16 stack at T 12, B 9 (a ragged row tile), D 16, H 32: inputs
    on both sides and the Pallas forward in interpret mode."""
    x, h01, h02, p1, p2, rng = _stack_inputs(12, 9, 16, 32, seed=4)
    jargs, targs = _both(x, h01, h02, p1, p2, "bfloat16")
    return jargs, targs, ft._stack2_fwd_pallas(*jargs, "tanh", True), rng


# ---------------------------------------------------------------------------
# Rows 22 and 23: the stack's kernels, raw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rs", [False, True], ids=["final", "seq"])
def test_stack2_plain_versions_match_the_pallas_kernels(dtype, rs, bf16_stack):
    """``stack2_fwd_reference`` against ``_stack2_fwd_pallas`` (row 22) and
    ``stack2_bwd_reference`` + kernel W's plain version against
    ``_stack2_bwd_pallas`` (row 23), both in interpret mode: the h1 and h2
    sequences, dx, dh01, dh02 and each layer's dW, db, dU, with layer 2's
    grad coming as d_seq (``rs``) or d_final."""
    if dtype == "bfloat16":
        jargs, targs, (jh1, jh2), rng = bf16_stack
    else:
        x, h01, h02, p1, p2, rng = _stack_inputs(7, 9, 5, 16, seed=3)
        jargs, targs = _both(x, h01, h02, p1, p2, dtype)
        jh1, jh2 = ft._stack2_fwd_pallas(*jargs, "tanh", True)
    jd, td = DTYPES[dtype]
    th1, th2 = es.stack2_fwd_reference(*targs)
    for got, want in ((th1, jh1), (th2, jh2)):
        assert got.dtype == td
        if dtype == "bfloat16":
            _close_bf16(got, want)
        else:
            np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)
    # the backward from the Pallas forward's own sequences
    T, B, H = jh2.shape
    g = rng.randn(*((T, B, H) if rs else (B, H))).astype(np.float32)
    jg, tg = _pair(g, dtype)
    d_seq = jg if rs else jnp.zeros_like(jh2[:1])
    d_final = jnp.zeros_like(jargs[2]) if rs else jg
    want = ft._stack2_bwd_pallas(jargs[0], jh1, jh2, jargs[1], jargs[2], d_seq, d_final, *jargs[3:],
                                 rs, True)
    h1, h2 = (torch.from_numpy(_np(a).copy()).to(td) for a in (jh1, jh2))
    x, h01, h02, p1, p2 = targs
    dx, dh01, dh02, (da1, rh1), (da2, rh2) = es.stack2_bwd_reference(
        x, h1, h2, h01, h02, tg if rs else None, None if rs else tg, p1, p2)
    got = (dx, dh01, dh02, *_weight_grads(x, h01, h1, rh1, da1),
           *_weight_grads(h1, h02, h2, rh2, da2))
    names = ("dx", "dh01", "dh02", "dw1", "db1", "du1", "dw2", "db2", "du2")
    for name, a, b in zip(names, got, want):
        b = b.reshape(a.shape)
        rel = BF16_STEP if a.dtype == torch.bfloat16 else F32_GRAD_REL
        _close_rel(a, b, rel, name)


def test_bf16_two_layer_reference_lands_outside_the_tolerance(bf16_stack):
    """The control: the two-layer reference feeds layer 2 the rounded h1
    sequence and rounds every op. In bf16 it lands over the bf16 tolerance
    from the Pallas kernel (``_stack2_reference`` against
    ``_stack2_fwd_pallas``: over BF16_ATOL and BF16_REL_L2), the port's twin
    as far from the plain version, and so do two plain layer scans with the
    kernels' rounding (h1 rounded before layer 2, nothing else changed): the
    tolerance tells the kernel's rounding from the reference's."""
    jargs, targs, (_, jh2), _ = bf16_stack
    ref = ft._stack2_reference(*jargs, jnp.tanh, True)
    assert np.abs(_np(ref) - _np(jh2)).max() > BF16_ATOL
    assert _rel_l2(ref, jh2) > BF16_REL_L2
    plain = es.stack2_fwd_reference(*targs)[1]
    twin = es.stack2_reference(*targs, "tanh", True)
    assert _rel_l2(twin, plain) > BF16_REL_L2
    x, h01, h02, p1, p2 = targs
    per_layer = es._branch_fwd_reference(es._branch_fwd_reference(x, h01, p1), h02, p2)
    assert _rel_l2(per_layer, plain) > BF16_REL_L2
    assert _rel_l2(per_layer, jh2) > BF16_REL_L2


# ---------------------------------------------------------------------------
# Rows 24 and 25: the multi-branch kernels, raw
# ---------------------------------------------------------------------------

def _multibranch_inputs(T, B, D, H, K, seed):
    """The stack over x (T, B, D) and K branches: velocity-like (T, B, 1),
    instrument-like (2, B, 5) (shorter than the stack), held-like (T, B, 2);
    numpy."""
    rng = np.random.RandomState(seed)
    stack = {"x": (0.3 * rng.randn(T, B, D)).astype(np.float32), "p1": _params(rng, D, H),
             "p2": _params(rng, H, H)}
    branches = [{"x": (0.3 * rng.randn(tk, B, dk)).astype(np.float32), "p": _params(rng, dk, H)}
                for tk, dk in ((T, 1), (2, 5), (T, 2))[:K]]
    return stack, branches, rng


def _tree(stack, branches, side):
    """numpy stack and branches as jnp (side 0) or torch (side 1) float32."""
    conv = lambda a: _pair(a)[side]  # noqa: E731
    s = {"x": conv(stack["x"]), "p1": {k: conv(v) for k, v in stack["p1"].items()},
         "p2": {k: conv(v) for k, v in stack["p2"].items()}}
    return s, [{"x": conv(b["x"]), "p": {k: conv(v) for k, v in b["p"].items()}} for b in branches]


def test_multibranch_plain_versions_match_the_pallas_kernels():
    """``multibranch_fwd_reference`` against ``encode_multibranch_train_fwd``
    (row 24) and ``multibranch_bwd_reference`` + kernel W's plain version
    against ``encode_multibranch_train_bwd`` (row 25) in interpret mode, the
    stack and two branches, one of them shorter than the stack (T_k = 2 of
    T = 6) and one of width 1; B = 9."""
    stack, branches, rng = _multibranch_inputs(6, 9, 12, 16, 2, seed=5)
    js, jb = _tree(stack, branches, 0)
    ts, tb = _tree(stack, branches, 1)
    want = ft.encode_multibranch_train_fwd(js, tuple(jb), "tanh", True)
    pairs = [(b["x"], b["p"]) for b in tb]
    h1, h2, hk = es.multibranch_fwd_reference(ts["x"], ts["p1"], ts["p2"], pairs)
    for got, w in zip((h1, h2, *hk), want):
        np.testing.assert_allclose(_np(got), _np(w), rtol=0, atol=F32_ATOL)
    B, H = h2.shape[1:]
    g = [rng.randn(B, H).astype(np.float32) for _ in range(1 + len(branches))]
    jwant = ft.encode_multibranch_train_bwd(js, tuple(jb), want,
                                            (jnp.asarray(g[0]), tuple(map(jnp.asarray, g[1:]))),
                                            True)
    tg = [torch.from_numpy(a) for a in g]
    x, p1, p2 = ts["x"], ts["p1"], ts["p2"]
    dx, (da1, rh1), (da2, rh2), outs = es.multibranch_bwd_reference(
        x, h1, h2, p1, p2, tg[0],
        [(b["x"], h, gk, b["p"], True) for b, h, gk in zip(tb, hk, tg[1:])])
    zero = torch.zeros(B, H)
    got = [dx, *_weight_grads(x, zero, h1, rh1, da1), *_weight_grads(h1, zero, h2, rh2, da2)]
    for b, h, (dxk, dak, rhk) in zip(tb, hk, outs):
        got += [dxk, *_weight_grads(b["x"], zero, h, rhk, dak)]
    assert len(got) == len(jwant)
    for i, (a, b) in enumerate(zip(got, jwant)):
        _close_rel(a, b.reshape(a.shape), F32_GRAD_REL, f"output {i}")


# ---------------------------------------------------------------------------
# The ops: value and every gradient
# ---------------------------------------------------------------------------

def _stack2_vjp_jax(jargs, rs, interpret):
    """The JAX op's output and VJP: in interpret mode its Pallas kernels,
    else (on the CPU backend) ``_stack2_reference``."""
    return jax.vjp(lambda *a: ft.gru_stack2_train_x(*a, "tanh", rs, interpret), *jargs)


def _port_grads(fn, leaves, cotangents):
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    return outs, torch.autograd.grad(outs, leaves, cotangents)


STACK2_CASES = [("float32", False, 4), ("float32", True, 9), ("bfloat16", False, 9),
                ("bfloat16", True, 9)]


@pytest.mark.parametrize("dtype, rs, B", STACK2_CASES,
                         ids=[f"{d}-{'seq' if r else 'final'}-B{b}" for d, r, b in STACK2_CASES])
def test_gru_stack2_train_x_value_and_gradients(dtype, rs, B):
    """``gru_stack2_train_x`` (U, V and W's plain versions on the CPU)
    against the JAX op: the output and the gradients of x, h01, h02 and both
    layers' w, b, u for one numpy cotangent. float32 against the JAX
    reference (the JAX op's CPU path, equal to its kernels in float32), bf16
    against the JAX kernels in interpret mode (D = 16 >= 8: the op's bf16
    kernels)."""
    D = 16 if dtype == "bfloat16" else 5
    x, h01, h02, p1, p2, rng = _stack_inputs(8, B, D, 16, seed=6)
    jargs, targs = _both(x, h01, h02, p1, p2, dtype)
    want, vjp = _stack2_vjp_jax(jargs, rs, dtype == "bfloat16")
    ct = rng.randn(*want.shape).astype(np.float32)
    jct, tct = _pair(ct, dtype)
    jgrads = jax.tree_util.tree_leaves(vjp(jct))
    leaves = [t.clone().requires_grad_() for t in (targs[0], targs[1], targs[2],
                                                   *targs[3].values(), *targs[4].values())]

    def op(x, h01, h02, w1, b1, u1, w2, b2, u2):
        return es.gru_stack2_train_x(x, h01, h02, {"w": w1, "b": b1, "u": u1},
                                     {"w": w2, "b": b2, "u": u2}, "tanh", rs)

    (got,), tgrads = _port_grads(op, leaves, [tct])
    # jax orders a dict's leaves by key: b, u, w
    order = [0, 1, 2, 4, 5, 3, 7, 8, 6]
    bf16 = dtype == "bfloat16"
    if bf16:
        _close_bf16(got, want)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)
    assert got.dtype == DTYPES[dtype][1]
    names = ("x", "h01", "h02", "p1.b", "p1.u", "p1.w", "p2.b", "p2.u", "p2.w")
    for name, i, jg in zip(names, order, jgrads):
        assert tgrads[i].dtype == DTYPES[dtype][1], name
        _close_rel(tgrads[i], jg, BF16_GRAD_REL if bf16 else F32_GRAD_REL, name)


MB_CASES = [(0, 4), (1, 9), (2, 4), (2, 9), (3, 9)]


@pytest.mark.parametrize("K, B", MB_CASES, ids=[f"K{k}-B{b}" for k, b in MB_CASES])
def test_gru_encode_multibranch_train_value_and_gradients(K, B):
    """``gru_encode_multibranch_train`` against the JAX op's reference
    (``_encmb_reference``, equal to its kernels in float32): layer 2's final
    h and each branch's, and the gradients of every input and weight, with
    K = 0 to 3 branches (a width-1 branch, one shorter than the stack, a
    width-2 one)."""
    stack, branches, rng = _multibranch_inputs(8, B, 12, 16, K, seed=7 + K)
    js, jb = _tree(stack, branches, 0)
    want, vjp = jax.vjp(lambda s, b: ft._encmb_reference(s, b, jnp.tanh), js, tuple(jb))
    cts = [rng.randn(B, 16).astype(np.float32) for _ in range(1 + K)]
    jgrads = vjp((jnp.asarray(cts[0]), tuple(map(jnp.asarray, cts[1:]))))
    ts, tb = _tree(stack, branches, 1)
    leaves = [ts["x"], *ts["p1"].values(), *ts["p2"].values()]
    for b in tb:
        leaves += [b["x"], *b["p"].values()]
    leaves = [t.requires_grad_() for t in leaves]
    h2, finals = es.gru_encode_multibranch_train(ts, tuple(tb))
    assert len(finals) == K
    for got, w in zip((h2, *finals), (want[0], *want[1])):
        np.testing.assert_allclose(_np(got), _np(w), rtol=0, atol=F32_ATOL)
    tgrads = torch.autograd.grad((h2, *finals), leaves, [torch.from_numpy(c) for c in cts])
    # torch leaves: x, p1 (w, b, u), p2 (w, b, u), then per branch x, p (w, b, u)
    jflat = [jgrads[0]["x"], *(jgrads[0][p][k] for p in ("p1", "p2") for k in "wbu")]
    for b in jgrads[1]:
        jflat += [b["x"], *(b["p"][k] for k in "wbu")]
    for i, (a, b) in enumerate(zip(tgrads, jflat)):
        _close_rel(a, b, F32_GRAD_REL, f"gradient {i}")


def test_config_encoder_through_the_fused_ops():
    """The slice as a whole: the default encoder of ``small_test_config``
    (notes stack over 61 inputs, velocity and instrument branches) with the
    port's seeded ``MidiVAE`` weights, through ``gru_encode_multibranch_train``
    against the JAX op on the same numpy weights and batch, and against the
    port's per-layer route (``gru_layer_train_x``, what the model runs)."""
    from midi_vae_tpu_torch.ops.gru_layer import gru_layer_train_x

    cfg = small_test_config()
    enc = MidiVAE(cfg).params["encoder"]
    rng = np.random.RandomState(8)
    B = 4
    eye = lambda d, n: np.eye(d, dtype=np.float32)[rng.randint(0, d, (n, B))]  # noqa: E731
    xs = {"notes": eye(cfg.input_dim, cfg.input_length),
          "inst": eye(cfg.meta_instrument_dim, cfg.max_voices),
          "vel": rng.rand(cfg.output_length, B, 1).astype(np.float32)}
    npp = lambda p: {k: p[k].detach().numpy() for k in "wbu"}  # noqa: E731
    stack = {"x": xs["notes"], "p1": npp(enc["notes_rnn"][0]), "p2": npp(enc["notes_rnn"][1])}
    branches = [{"x": xs["vel"], "p": npp(enc["vel_rnn"][0])},
                {"x": xs["inst"], "p": npp(enc["inst_rnn"][0])}]
    js, jb = _tree(stack, branches, 0)
    ts, tb = _tree(stack, branches, 1)
    want = ft.gru_encode_multibranch_train(js, tuple(jb), "tanh", False)
    got = es.gru_encode_multibranch_train(ts, tuple(tb))
    for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=F32_ATOL)
    zero = torch.zeros(B, cfg.lstm_size)
    wbu = lambda p: (p["w"], p["b"], p["u"])  # noqa: E731
    seq1 = gru_layer_train_x(ts["x"], zero, *wbu(ts["p1"]), True)
    per_layer = [gru_layer_train_x(seq1, zero, *wbu(ts["p2"]), False)]
    per_layer += [gru_layer_train_x(b["x"], zero, *wbu(b["p"]), False) for b in tb]
    for a, b in zip((got[0], *got[1]), per_layer):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=F32_ATOL)


# ---------------------------------------------------------------------------
# Dispatch and launch limits
# ---------------------------------------------------------------------------

def test_dispatch_follows_the_jax_predicates(monkeypatch):
    """Where the JAX package runs its kernels on the TPU
    (``_stack2_use_pallas``, ``_encmb_use_pallas`` with the backend "tpu";
    their VMEM estimates admit these small shapes), the port runs U and V;
    elsewhere both run the reference: a non-tanh cell, the stack in bf16
    with D < 8, the multi-branch op in bf16, a branch longer than the
    stack."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    T, B, H = 6, 4, 16
    for dtype in sorted(DTYPES):
        jd, td = DTYPES[dtype]
        for D in (5, 12):
            for act in ("tanh", "sigmoid", "relu"):
                want = ft._stack2_use_pallas(jnp.zeros((T, B, D), jd), jnp.zeros((B, H), jd), act,
                                             False)
                assert es.stack2_use_kernels(torch.zeros(T, B, D, dtype=td), act) == want, \
                    (dtype, D, act)
                for tk in (2, T, T + 1):
                    stack = {"x": jnp.zeros((T, B, D), jd), "p1": {"u": jnp.zeros((H, 3 * H), jd)}}
                    branches = ({"x": jnp.zeros((tk, B, 1), jd)},)
                    want = ft._encmb_use_pallas(stack, branches, act, False)
                    got = es.multibranch_use_kernels({"x": torch.zeros(T, B, D, dtype=td)},
                                                     ({"x": torch.zeros(tk, B, 1, dtype=td)},), act)
                    assert got == want, (dtype, D, act, tk)


def test_ops_take_the_reference_where_the_jax_package_does(monkeypatch):
    """The ops send the predicates' False cases to the JAX references'
    twins (no autograd Function of the kernels is applied) and the True
    cases to the kernels' Functions."""
    x, h01, h02, p1, p2, _ = _stack_inputs(6, 4, 5, 16, seed=9)
    _, targs = _both(x, h01, h02, p1, p2, "float32")
    applied = []
    for cls in (es._Stack2Train, es._MultibranchTrain):
        monkeypatch.setattr(cls, "apply", lambda *a, cls=cls: applied.append(cls) or (
            (torch.zeros(4, 16),) if cls is es._MultibranchTrain else torch.zeros(4, 16)))
    got = es.gru_stack2_train_x(*targs, "sigmoid")
    torch.testing.assert_close(got, es.stack2_reference(*targs, "sigmoid"), rtol=0, atol=0)
    bf = [t.to(torch.bfloat16) for t in targs[:3]]
    bf += [{k: v.to(torch.bfloat16) for k, v in p.items()} for p in targs[3:]]
    es.gru_stack2_train_x(*bf)  # bf16 with D = 5 < 8: the reference
    stack = {"x": targs[0], "p1": targs[3], "p2": targs[4]}
    shapes = {"w": (1, 48), "b": (48,), "u": (16, 48)}
    long_branch = ({"x": torch.zeros(7, 4, 1), "p": {k: torch.zeros(s) for k, s in shapes.items()}},)
    es.gru_encode_multibranch_train(stack, long_branch)  # T_k = 7 > T = 6: the reference
    assert applied == []
    es.gru_stack2_train_x(*targs)
    es.gru_encode_multibranch_train(stack, ())
    assert applied == [es._Stack2Train, es._MultibranchTrain]


@pytest.mark.parametrize("H", [256, 512, 1024])
def test_launch_limits_of_u_and_v(H):
    """U's and V's tiles are what the kernels allocate (the stack's and a
    branch's); both launch at the model's 256; no build launches 1024
    threads (LaunchLimitError, as every kernel of the port at H = 1024);
    at 512 each launches where its registers (ops/_layout.py, from ptxas)
    allow H threads."""
    D = 61
    assert _layout.smem_bytes("U", H, D, 2) == 4 * 8 * (D + 3 * H)
    assert _layout.smem_bytes("U", H, 16, 1) == _layout.smem_bytes("A", H, 16)
    assert _layout.smem_bytes("V", H, D, 2, True) == 4 * 8 * (2 * D + 8 * H)
    assert _layout.smem_bytes("V", H, 16, 1) == 4 * 8 * (16 + 5 * H)  # x, h, r * h, da_cat
    for kernel in ("U", "V"):
        fits = -(-_layout.REGISTERS[kernel] // 8) * 8 * H <= _layout.REGS_PER_SM
        if H == 256:
            assert fits
        if H == 1024:
            assert not fits
        if fits:
            es.require_launch(kernel, H, D, [1, 16], dx=True)
        else:
            with pytest.raises(_layout.LaunchLimitError, match="registers"):
                es.require_launch(kernel, H, D, [1, 16], dx=True)
