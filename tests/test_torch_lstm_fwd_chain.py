"""CPU tests of the LSTM forward over xp on thread-block clusters (kernels Q
and Y, ``midi_vae_tpu_torch/csrc/lstm_cell_fwd.cuh``): the chain's cluster
plan (``ops/_layout.py::fwd_plan``) and launch limits, and the wrappers' CPU
paths. The chain itself runs only on the card, where ``chip_smoke.py`` holds
it against its plain version; the plain versions are held against the
Pallas kernels in ``tests/test_torch_lstm_train.py``, ``test_torch_bf16.py``
and ``test_torch_bf16_lstm.py``.
"""

import numpy as np
import pytest
import torch

from midi_vae_tpu_torch.ops import _layout
from midi_vae_tpu_torch.ops import encoder_scan as port_scan
from midi_vae_tpu_torch.ops import lstm_layer as port_layer

BF = torch.bfloat16


def _inputs(seed, T, B, H, bf16):
    """xp (T, B, 4H), h0, c0 (B, H), u (H, 4H) from a numpy seed."""
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(0, 1, (T, B, 4 * H)), 0.5 * np.tanh(rng.normal(0, 1, (B, H))),
              0.5 * rng.normal(0, 1, (B, H)), rng.normal(0, H ** -0.5, (H, 4 * H)))
    return tuple(torch.tensor(a, dtype=BF if bf16 else torch.float32) for a in arrays)


# the cluster sizes and whether the slice streams (float32 at 512: 256 KiB)
CLUSTERS = {("Q", 256): (8, False), ("Q", 384): (16, False), ("Q", 512): (16, True),
            ("Q_bf16", 256): (4, False), ("Q_bf16", 384): (8, False),
            ("Q_bf16", 512): (16, False)}
PLAN_CASES = [(H, bf16, B) for H in (256, 384, 512) for bf16 in (False, True)
              for B in (5, 128, 256, 512)]


@pytest.mark.parametrize("H, bf16, B", PLAN_CASES,
                         ids=[f"H{c[0]}-{'bf16' if c[1] else 'f32'}-B{c[2]}" for c in PLAN_CASES])
def test_fwd_plan(H, bf16, B):
    """The forward chain's plan at (H, dtype, B) on the H100: the cluster
    size and whether the slice streams; rows from B over the card's active
    clusters, bounded by what fits beside the slice (at most three m-tiles
    of 16 in bf16); the slice (or its ring), the two h tiles and the
    partials fit a block's 227 KB; Q bf16 and Y share it."""
    build = "Q_bf16" if bf16 else "Q"
    plan = _layout.fwd_plan(build, H, B)
    if bf16:
        assert plan == _layout.fwd_plan("Y", H, B)
    C, stream = CLUSTERS[(build, H)]
    assert (plan.cluster, plan.stages > 0) == (C, stream)
    Hc, elem = H // C, 2 if bf16 else 4
    assert 4 * Hc * H * elem <= 144 * 1024 or stream  # the resident slices
    if stream:
        assert 4 * Hc * H * 4 > _layout.SMEM_PER_BLOCK and 2 <= plan.stages <= 8
    assert plan.smem == _layout.fwd_chain_smem(H, C, plan.rows, plan.splits, plan.stages, elem)
    assert plan.smem <= _layout.SMEM_PER_BLOCK
    assert plan.clusters == -(-B // plan.rows)
    active = _layout.MAX_CLUSTERS_H100[C]
    least = 2 if stream else 0
    cap = 48 if bf16 else 512 // Hc * 8
    most = max(r for r in range(1, cap + 1)
               if _layout.fwd_chain_smem(H, C, r, 1, least, elem) <= _layout.SMEM_PER_BLOCK)
    assert plan.rows == min(-(-B // active), most)
    if bf16:
        assert plan.rows <= 48 and plan.splits == 1
    else:  # split 0's threads own every (unit, 8 rows) tile; the splits share them
        tiles = Hc * (-(-plan.rows // 8))
        assert tiles * plan.splits <= 512 and plan.splits & (plan.splits - 1) == 0
    if plan.rows < most:
        assert plan.clusters <= active
    # more clusters active at once take fewer rows each
    assert _layout.fwd_plan(build, H, B, 2 * active).rows <= plan.rows


def test_fwd_launch_limits():
    """Where the chain does not launch, the route chooser's limit says why:
    at H = 1024 the bf16 builds' slices do not fit (float32 streams its);
    widths that are not multiples name the multiple."""
    for build in ("Q_bf16", "Y"):
        why = _layout.launch_limit(build, 1024, 0)
        assert "shared memory" in why and "clusters of 16" in why, why
        with pytest.raises(_layout.LaunchLimitError, match="shared memory"):
            _layout.fwd_plan(build, 1024, 256)
        assert "multiple of 128" in _layout.launch_limit(build, 320, 0)
    assert _layout.launch_limit("Q", 1024, 0) is None
    assert _layout.fwd_plan("Q", 1024, 256).stages >= 2
    assert "multiple of 64" in _layout.launch_limit("Q", 96, 0)
    for build in _layout.FWD_BUILDS:
        for H in (256, 384, 512):
            assert _layout.launch_limit(build, H, 0) is None
        assert build not in _layout.BOUNDED


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_wrappers_run_their_plain_versions_on_cpu(bf16):
    """Q's and Y's wrappers take their plain versions for CPU tensors (no
    launch counted) and check shapes."""
    xp, h0, c0, u = _inputs(5, 3, 4, 32, bf16)
    before = (port_layer.lstm_layer_xp.launches, port_layer.lstm_layer_xp.launches_bf16,
              port_scan.lstm_encoder_scan_fwd.launches)
    hs, cs = port_layer.lstm_layer_xp(xp, h0, c0, u)
    want = port_layer.lstm_layer_xp_reference(xp, h0, c0, u)
    assert hs.shape == cs.shape == (3, 4, 32) and hs.dtype == xp.dtype
    assert torch.equal(hs, want[0]) and torch.equal(cs, want[1])
    if bf16:
        for rs in (True, False):
            got = port_scan.lstm_encoder_scan_fwd(xp, h0, c0, u, "sigmoid", rs)
            assert got.shape == ((3, 4, 32) if rs else (4, 32))
            assert torch.equal(got, port_scan.lstm_encoder_scan_reference(xp, h0, c0, u,
                                                                          "sigmoid", rs))
    assert before == (port_layer.lstm_layer_xp.launches, port_layer.lstm_layer_xp.launches_bf16,
                      port_scan.lstm_encoder_scan_fwd.launches)
    with pytest.raises(ValueError, match="c0 has shape"):
        port_layer.lstm_layer_xp(xp, h0, c0[:3], u)
    with pytest.raises(ValueError, match="u has shape"):
        port_scan.lstm_encoder_scan_fwd(xp, h0, c0, u[:, :64])
