"""GRU(1024) on the CPU: the JAX package's dispatch at the real shape, the
port's route and plans at H = 1024, and one training step of the slice
against the JAX package, in float32 and in bf16.

At (B 16 to 256, H 1024) the JAX package runs every encoder layer through
xp = x @ W + b and rows 11 and 12 (``_gru_wide_btiles`` (32, 16) in float32,
(128, 32) in bf16), the 1-layer decode heads through rows 13 and 14, and
the 2-layer notes head through its XLA scan (``_dec_wide_btiles`` (0, 0));
it serves through XLA scans at B = 256 (``_decoder_vmem_ok``,
``_encoder_vmem_ok`` false), and at one song (B = 16) the notes head alone
(the 1-layer heads and the encoder there through Pallas kernels). ``test_jax_predicates_at_the_real_shape`` holds the
port's copies of those predicates to the JAX functions there.

The port's float32 step takes the wide route (F, G, the wide D and E, W:
the notes head's decode on the wide D and E computes the function the XLA
scan does); its bf16 step the TPU's rows per part (X and G bf16, the wide D
and E in bf16 on the instrument head, float32 on the velocity head, the
plain scan on the notes head). The step tests run both packages on the
same numpy batch and weights (the bridge), the JAX side at that dispatch
with its Pallas kernels in interpret mode, the port on its plain versions
(CPU tensors) through the autograd Functions the card runs; at B = 5 the
batch-tile predicates find no tile of 8 rows, so both sides are held to
their answers at B = 256 (ROADMAP Queue 3 traps). Tolerances:
- float32 (``tests/test_torch_wide.py``'s): the loss and every metric atol
  1e-5, every gradient rtol 1e-4 and atol 1e-5 (sums taken in another order
  over 64-step chains of width 1024);
- bf16 (``tests/test_torch_bf16_fused.py``'s): the loss and every metric
  atol 5e-4, every gradient relative L2 <= 3e-2 and max|diff| <= 4e-2 of its
  largest entry (the dense layers and the loss in bf16 on both sides, where
  XLA on the CPU fuses bf16 elementwise ops that PyTorch rounds one by one).
One torch thread and one BLAS thread.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from midi_vae_tpu.config import small_test_config
from midi_vae_tpu.models.vae import MidiVAE as JaxVAE
from midi_vae_tpu.models.vae import loss_and_metrics as jax_loss
from midi_vae_tpu.ops import fused_decoder as fd
from midi_vae_tpu.ops import fused_train as ft
from midi_vae_tpu_torch import bridge
from midi_vae_tpu_torch.config import Config
from midi_vae_tpu_torch.ops import _layout
from test_torch_bf16_lstm import _assert_grads, _assert_loss
from test_torch_wide import B, _assert_step_matches, _port_step, make_batch

H = 1024
BATCHES = (16, 64, 256)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, "blas"):
        yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# (a) the JAX package's dispatch at (B 16 to 256, H 1024)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Bn", BATCHES)
@pytest.mark.parametrize("s", (4, 2))
def test_jax_predicates_at_the_real_shape(Bn, s):
    """The port's copies equal the JAX predicates at the real shape (f32:
    s = 4, bf16: s = 2), and give the rows the module note names at every
    batch from one song's bucket to the training batch."""
    for d in (61, H, 16, 1):
        assert _layout.x_train_vmem_ok(Bn, d, H, s) == ft._x_train_vmem_ok(Bn, d, H, s) is False
    assert _layout.train_vmem_ok(Bn, H, s) == ft._train_vmem_ok(Bn, H, s) is False
    assert _layout.gru_wide_btiles(Bn, H, s) == ft._gru_wide_btiles(Bn, H, s)
    assert _layout.gru_wide_btiles(Bn, H, s)[0] > 0  # rows 11 and 12
    for d, n in ((61, 2), (16, 1), (1, 1), (2, 1)):
        sd = 4 if d < 8 else s  # a head narrower than 8 in float32
        assert _layout.dec_wide_btiles(Bn, d, H, n, sd) == ft._dec_wide_btiles(Bn, d, H, n, sd)
        assert _layout.dec_train_vmem_ok(Bn, d, H, n) == ft._dec_train_vmem_ok(Bn, d, H, n) is False
        # the notes head: the XLA scan; the 1-layer heads: rows 13 and 14
        assert (_layout.dec_wide_btiles(Bn, d, H, n, sd)[0] == 0) == (n == 2)
    assert _layout.encoder_vmem_ok(Bn, H, s) == fd._encoder_vmem_ok(Bn, H, s)
    assert _layout.encoder_vmem_ok(Bn, H, s) == (Bn == 16 or (s == 2 and Bn == 64))


def test_jax_rows_at_the_training_batch():
    """The tiles at B = 256 (ROADMAP Queue 2), and serving: every decode
    head through an XLA scan at B = 256, the notes head also at one song (B
    = 16), where the 1-layer heads take the Pallas decode (row 3) and the
    encoder its Pallas scan; the port serves every part on A and B."""
    assert ft._gru_wide_btiles(256, H, 4) == (32, 16)
    assert ft._gru_wide_btiles(256, H, 2) == (128, 32)
    assert ft._dec_wide_btiles(256, 61, H, 2, 4) == ft._dec_wide_btiles(256, 61, H, 2, 2) == (0, 0)
    assert ft._dec_wide_btiles(256, 16, H, 1, 4) == (64, 16)
    assert ft._dec_wide_btiles(256, 16, H, 1, 2) == (128, 32)
    assert ft._dec_wide_btiles(256, 1, H, 1, 4) == (64, 16)
    for Bn in (256, 16):
        for d, n in ((61, 2), (1, 1), (16, 1)):
            assert fd._decoder_vmem_ok(Bn, d, H, n) == (Bn == 16 and n == 1)
    assert fd._encoder_vmem_ok(16, H) and not fd._encoder_vmem_ok(256, H)


# ---------------------------------------------------------------------------
# (b) the port's route at 1024, and at 512 and below as before
# ---------------------------------------------------------------------------

def test_route_at_1024_is_the_wide_route():
    """float32: the wide route (the chains' limits: F's tensor-core
    instance, G's and E's chains, the wide D's decode chain); bf16: every
    part dispatches without NotImplementedError, the layers to X and G bf16,
    the instrument head to the wide D and E in bf16, the velocity head to
    their float32 builds, the notes head to the plain scan, every named
    build with a plan."""
    for Bn in (256, 64):
        assert _layout.config_route(Config(lstm_size=H, batch_size=Bn)) == "wide"
        assert _layout.config_route(Config(lstm_size=H, batch_size=Bn,
                                           compute_dtype="bfloat16")) == "wide"
        for d in (61, H, 16, 1):
            assert _layout.bf16_layer_mode("GRU", Bn, d, H, on_card=True) == "wide"
        assert _layout.bf16_head_mode(Bn, 61, H, 2, on_card=True) == "scan"
        for d, builds in ((16, ("D_wide_bf16", "E_wide_bf16")), (1, ("D_wide", "E_wide"))):
            assert _layout.bf16_head_mode(Bn, d, H, 1, on_card=True) == "wide"
            assert _layout.head_builds("wide", d, H, 1) == builds
            assert _layout.dec_train_limit(builds[0], H, d, 1) is None
            assert _layout.gru_bptt_limit(builds[1], H, d, 1) is None
    assert _layout.train_route(H, *_layout.config_shapes(Config(lstm_size=H))) == "wide"
    for build in _layout.XP_LAYER_BUILDS:
        assert _layout.xp_layer_limit(build, H) is None
    assert _layout.gru_scan_route(H) == _layout.gru_xp_fwd_route(H) == "chain"
    # the narrow route keeps D's first design's limit, so the step is F + G
    assert "registers" in _layout._route_limits("narrow", H, *_layout.config_shapes(
        Config(lstm_size=H)))[0]


def _first_design_route_limits(route, Hn, layers, heads, cell_type="GRU"):
    """``_layout._route_limits`` as it was while the wide route held F and
    the wide D to their first designs' limits."""
    L = _layout
    whys = []
    if cell_type == "LSTM":
        if route == "narrow":
            whys = [L.l_limit(Hn, d) for d, _dx in layers]
            checks = [("N", 0)] if layers else []
        else:
            checks = [("Q", 0), ("R", 0)] if layers else []
        whys += [L.step_limit("S", Hn)] if heads else []
    else:
        if route == "narrow":
            whys = [L.a_limit(Hn, d) for d, _dx in layers]
            whys += [L.gru_bptt_limit("C", Hn)] if layers else []
            checks = []
        elif layers:
            checks = [("F", L.smem_bytes("F", Hn))]
            whys.append(L.xp_layer_limit("G", Hn))
        else:
            checks = []
        d_k = "D" if route == "narrow" else "D_wide"
        checks += [(d_k, L.smem_bytes(d_k, Hn, d, n)) for d, n in heads]
        whys += [L.gru_bptt_limit("E", Hn, d, n) for d, n in heads]
    whys += [L.launch_limit(k, Hn, smem) for k, smem in checks]
    return [why for why in whys if why is not None]


HEAD_SETS = ([(61, 2), (16, 1), (1, 1)], [(61, 2), (16, 1), (1, 1), (2, 1)], [(61, 2)],
             [(61, 3), (1, 1)], [])


@pytest.mark.parametrize("cell_type", ("GRU", "LSTM"))
def test_routes_at_512_and_below_are_unchanged(cell_type, monkeypatch):
    """Every width a multiple of 16 up to 512 (the widths the route tests
    sweep, and those between) keeps the route it took with the first
    designs' limits on the wide route, on the card and off it, for the
    configs' head sets; and X's chain keeps its resident slice (the
    streamed instance takes only widths over X's per-block route's 512)."""
    for Hn in range(16, 513, 16):
        for heads in HEAD_SETS:
            for layers in ([(61, False), (Hn, True), (16, False), (1, False)], []):
                for on_card in (True, False):
                    args = (Hn, layers, heads, on_card, cell_type)
                    try:
                        got = _layout.train_route(*args)
                    except _layout.LaunchLimitError:
                        got = "raises"
                    with monkeypatch.context() as mp:
                        mp.setattr(_layout, "_route_limits", _first_design_route_limits)
                        try:
                            want = _layout.train_route(*args)
                        except _layout.LaunchLimitError:
                            want = "raises"
                    assert got == want, (Hn, heads, bool(layers), on_card)
        try:
            assert _layout.gru_fwd_cluster(_layout.X_CHAIN_BUILD, Hn)[1] is False
        except _layout.LaunchLimitError:
            assert Hn % 32 or _layout.gru_scan_route(Hn) == "block"
    assert _layout.gru_fwd_cluster(_layout.X_CHAIN_BUILD, H) == (16, True)


@pytest.mark.parametrize("Hn", (64, 128, 256, 384, 512))
def test_e_bf16_keeps_its_two_tile_instance_at_512_and_below(Hn):
    """At every E bf16 shape up to 512 the warps' 2 tiles cover the whole
    partial, so the per-segment instance (chosen by the launch only where
    they do not) never runs there and no plan moves."""
    for heads in (((61, 2),), ((16, 1, 4),), ((61, 2), (16, 1, 4))):
        for Bn in (5, 16, 128, 256, 1024):
            plan = _layout.gru_bptt_plan("E_chain_bf16", Hn, Bn, heads)
            for rows, part in zip(plan.rows, _layout._bptt_parts("E_chain_bf16", Hn, heads)):
                assert _layout._items(rows, part.pw, 2) <= (
                    _layout.GRU_BWD_MAX_ITEMS * _layout.CHAIN_WARPS)


# ---------------------------------------------------------------------------
# (c) the plans of the two new instances at 1024
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Bn", (5, 16, 64, 256))
def test_x_streamed_bf16_plan_fits(Bn):
    """X's streamed instance: the plan's shared memory (the bf16 ring, the
    float h and r h tiles, the gate sums, the owners' xp) within a CTA's,
    term by term; its owners (one thread a unit and 8 rows), its warps'
    tensor-core items and its clusters cover the batch; the bf16 ring takes
    half the float32 one's bytes a chunk."""
    plan = _layout.gru_fwd_plan(_layout.X_CHAIN_BUILD, H, Bn)
    assert plan == _layout.gru_tc_plan(H, Bn, elem=2) and plan.chunk in _layout.GRU_TC_CHUNKS
    C, rows, K = plan.cluster, plan.rows, plan.chunk
    Hc, R8, mts, RS = H // C, -(-rows // 8) * 8, -(-rows // 16), _layout.gru_tc_stride(rows)
    s1 = _layout.gru_tc_splits(mts * 2 * Hc // 8, K // 8)
    s2 = _layout.gru_tc_splits(mts * Hc // 8, K // 8)
    terms = (2 * plan.stages * K * 2 * Hc, 4 * 2 * H * RS,
             4 * max(s1 * 16 * mts * (2 * Hc + 8), s2 * 16 * mts * (Hc + 8)),
             4 * Hc * (R8 // 8) * _layout.TILE_STRIDE)
    assert plan.smem == sum(terms) <= _layout.GRU_TC_SMEM
    assert _layout.gru_tc_smem(H, C, rows, plan.stages, K, 4) - plan.smem == 2 * plan.stages * K * 2 * Hc
    assert Hc * R8 // 8 <= _layout.CHAIN_THREADS
    assert -(-mts * 2 * Hc // 8 // _layout.CHAIN_WARPS) <= _layout.GRU_TC_MAX_ITEMS
    assert 2 <= plan.stages <= 8 and H % K == 0 and plan.clusters * rows >= Bn


@pytest.mark.parametrize("Bn", (5, 16, 64, 256))
def test_e_bf16_per_segment_plan_covers_the_partial(Bn):
    """E bf16 on the instrument head at 1024: its partial (H + 64 columns)
    holds 34 tiles of 32 units an m-tile, more than the 32 the CTA's warps
    hold at 2 each, so the launch takes the per-segment instance, whose
    segments (U_h^T, U_zr^T: H columns; W^T: 64) each fit the warps and
    together cover the partial; shared memory within a CTA's."""
    heads = ((16, 1, 4),)
    plan = _layout.gru_bptt_plan("E_chain_bf16", H, Bn, heads)
    part, = _layout._bptt_parts("E_chain_bf16", H, heads)
    assert part.pw == H + 64
    hold = _layout.GRU_BWD_MAX_ITEMS * _layout.CHAIN_WARPS
    rows = plan.rows[0]
    assert _layout._items(rows, part.pw, 2) > hold  # the two-tile instance does not launch
    segments = (H, H, 64)  # S1: U_h^T; S2: U_zr^T, W^T (columns H ..)
    assert all(_layout._items(rows, w, 2) <= hold for w in segments)
    assert sum(segments[1:]) == part.pw
    assert plan.smem <= _layout.GRU_BWD_SMEM and plan.clusters[0] * rows >= Bn
    assert rows * (H // plan.cluster) <= _layout.GRU_BWD_MAX_PAIRS * _layout.CHAIN_THREADS
    for build in ("E_bf16", "E_wide_bf16", "E_wide_row8_bf16"):
        assert _layout.gru_bptt_limit(build, H, 16, 1) is None


NEAR_BEST = json.load(open(os.path.join(os.path.dirname(__file__), "data",
                                     "gru1024_near_best.json")))["cases"]


def _pick_1024(case):
    """The plan the route chooser picks for a case of the card's timings
    (at the H100's active clusters), in the timing tool's key."""
    what, Bn = case["what"], case["B"]
    heads = {"notes": (61, 2, 64), "velocity": (1, 1, 64), "instrument": (16, 1, 4)}
    if what in ("F chain plans", "X streamed plans"):
        p = _layout.gru_tc_plan(H, Bn, elem=2 if what.startswith("X") else 4)
        return f"tc {p.cluster}x{p.rows}/{p.chunk}/st{p.stages}"
    if what.startswith("A chain"):
        p = _layout.gru_fwd_plan("A_chain", H, Bn)
        return f"{p.cluster}x{p.rows}/s{p.splits}/st{p.stages}"
    if what.startswith(("G_chain", "E_chain")):
        build = what.split()[0]
        shape = None if build.startswith("G") else (heads[case["head"]],)
        return _layout.gru_bptt_plan(build, H, Bn, shape).cluster
    D, n, steps = heads[case["head"]]
    p = (_layout.dec_train_plan(H, D, n, Bn, steps, case["bf16"]) if what == "D wide plans"
         else _layout.gru_decode_plan(H, D, n, Bn, T=steps))
    return f"{p.cluster}x{p.rows}/{p.chunk}"


@pytest.mark.parametrize("case", NEAR_BEST, ids=lambda c: f"{c['what']} B={c['B']} "
                         f"{c.get('head', '')}{' bf16' if c.get('bf16') else ''}".strip())
def test_plans_at_1024_are_within_10_percent_of_the_fastest(case):
    """Every chain's pick at the 1024 paths' shapes is one of the plans the
    H100 ran within 10 % of the fastest (``tests/data/gru1024_near_best.json``,
    from the plan sweeps its ``source`` names: F's and X's tensor-core
    plans, A's serving chain, G's and E's cluster sizes, the wide D's and
    B's (cluster, rows, chunk)); rerun them and update the file,
    ``_layout.GRU_TC_MEASURED``, ``BPTT_MEASURED`` and
    ``DEC_TRAIN_MEASURED`` when a chain changes."""
    assert _pick_1024(case) in case["near_best"]


# ---------------------------------------------------------------------------
# (d) one GRU(1024) training step against the JAX package
# ---------------------------------------------------------------------------

def _jax_1024(mp):
    """The JAX package's dispatch at (B 256, H 1024), at B = 5: every layer
    over xp through rows 11 and 12 (``_FORCE``d past the batch tile, which B
    = 5 does not find), the 1-layer heads through 13 and 14, the notes head
    through the XLA scan, no multi-head call."""
    dec_mode = ft._dec_mode
    mp.setattr(ft, "_x_use_pallas", lambda *a: False)
    mp.setattr(ft, "_gru_mode", lambda *a: "wide")
    mp.setattr(ft, "_mh_use_pallas", lambda *a: False)
    mp.setattr(ft, "_dec_mode", lambda cells, *a: (
        "scan" if dec_mode(cells, *a) == "scan" or len(cells) == 2 else "wide"))


def _port_1024(mp):
    """The port's batch-tile predicates held to their answers at B = 256."""
    btiles, dtiles = _layout.gru_wide_btiles, _layout.dec_wide_btiles
    mp.setattr(_layout, "gru_wide_btiles", lambda _B, Hn, s: btiles(256, Hn, s))
    mp.setattr(_layout, "dec_wide_btiles", lambda _B, d, Hn, n, s: dtiles(256, d, Hn, n, s))


@pytest.fixture(scope="module")
def params():
    """The JAX package's init at H = 1024 (numpy arrays, the same in a bf16
    config: the model casts them), made once for both steps."""
    with threadpool_limits(1, "blas"):
        cfg = small_test_config(lstm_size=H)
        return jax.tree_util.tree_map(np.asarray, JaxVAE(cfg).init_params(jax.random.PRNGKey(3)))


def _jax_value_and_grad(cfg, params, batch, noise_dtype):
    """(loss, metrics, flat grads, noise) of one JAX step at ``_jax_1024``'s
    dispatch, its kernels in interpret mode; the noise drawn in z_mean's
    dtype, as ``sample_z`` draws it."""
    jnp = jax.numpy
    with pytest.MonkeyPatch.context() as mp, threadpool_limits(1, "blas"):
        _jax_1024(mp)
        jm = JaxVAE(cfg)
        jm._interpret = True
        key = jax.random.PRNGKey(1)
        fn = jax.jit(jax.value_and_grad(lambda p, b: jax_loss(jm, p, b, key, cfg.epsilon_std),
                                        has_aux=True))
        (loss, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    noise = np.asarray(cfg.epsilon_std * jax.random.normal(key, (B, cfg.latent_dim), noise_dtype),
                       np.float32)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            bridge.flatten(jax.tree_util.tree_map(np.asarray, grads)), noise)


def test_gru1024_f32_step_matches_jax(params, monkeypatch):
    """The float32 step on the wide route (the notes head on the wide D and
    E, which compute what the JAX package's XLA scan does): loss, metrics
    and every gradient."""
    cfg = small_test_config(lstm_size=H)
    batch = make_batch(cfg)
    want = _jax_value_and_grad(cfg, params, batch, jax.numpy.float32)
    _port_1024(monkeypatch)
    assert _layout.config_route(Config(lstm_size=H), on_card=False) == "wide"
    _assert_step_matches(cfg, params, batch, want)


def test_gru1024_bf16_step_matches_jax(params, monkeypatch):
    """The bf16 step at the TPU's rows per part: loss, metrics and every
    gradient."""
    cfg = small_test_config(lstm_size=H, compute_dtype="bfloat16")
    batch = make_batch(cfg)
    want_loss, want_metrics, want, noise = _jax_value_and_grad(cfg, params, batch,
                                                               jax.numpy.bfloat16)
    _port_1024(monkeypatch)
    loss, metrics, got = _port_step(cfg, params, batch, noise)
    _assert_loss(loss, metrics, want_loss, want_metrics)
    _assert_grads(got, want, "bf16 GRU(1024)")


def test_jax_dispatch_mirror_is_the_real_one():
    """The mirror's modes are the JAX package's own at (B 256, H 1024) on
    the TPU: ``_gru_mode`` "wide", ``_dec_mode`` "scan" for the notes head and
    "wide" for the 1-layer heads (float32 and bf16), ``_x_use_pallas`` off."""
    jnp = jax.numpy
    spec = jax.ShapeDtypeStruct
    for dt in (jnp.float32, jnp.bfloat16):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "default_backend", lambda: "tpu")
            assert ft._gru_mode(spec((64, 256, 3 * H), dt), spec((256, H), dt), "tanh",
                                False) == "wide"
            for d, n, want in ((61, 2, "scan"), (16, 1, "wide"), (1, 1, "wide")):
                sdt = jnp.float32 if d < 8 else dt
                assert ft._dec_mode([None] * n, spec((256, d), sdt), [spec((256, H), sdt)], "tanh",
                                    "softmax", False) == want
                assert not ft._x_use_pallas(spec((64, 256, d), dt), spec((256, H), dt), "tanh",
                                            False)
