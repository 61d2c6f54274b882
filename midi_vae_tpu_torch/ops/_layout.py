"""Which kernel builds a layer or decode head takes, from the card's limits.

Every kernel of the port but C, E, N, R, Q, Y, the chains of L and A, and
S (GRU: B, D, F, G, T, T xp, X, A's per-block route, and the encoder
stacks' U and V; LSTM: L's per-block route, M) runs one
thread per hidden column (blockDim.x = H) and keeps a tile of batch rows per
block, so whether a build launches at a width is a matter of two limits of
the H100 (sm_90a):
- registers: the block's threads times their registers must fit the SM's
  65,536 (registers are allocated in steps of 8 per thread);
- shared memory: the block's tile must fit the 227 KB (232,448 bytes) a block
  may have.

Kernels A (its per-block route), B, D, L, M, U and V are built without
launch bounds; their register
counts (``REGISTERS``, from ``nvcc -Xptxas -v`` on the card; ``chip_smoke.py``
checks them against the build) decide how wide they go. F, G, the
per-step cells T and T xp, the GRU's bf16 whole-scan encoder X and
the wide decode builds are compiled under ``__launch_bounds__(WIDE_THREADS)``,
so the compiler guarantees that up to 512 threads launch (``chip_smoke.py``
checks their registers from ptxas against it). N and R, the LSTM's backward
through time, run as phases of fixed block sizes whatever H: a gate
pre-pass, a chain on thread-block clusters and N's dx pass (the section
"The LSTM's backward through time" below); whether they launch is the
chain's cluster plan (``bptt_plan``). Q and Y, the LSTM's forward over a
precomputed x-projection, are one chain on thread-block clusters of the
same shape (the section "The LSTM's forward over xp"); whether they launch
is its plan (``fwd_plan``). L runs an x @ W pre-pass and then that chain
(builds ``L_chain``, ``L_chain_bf16``); its first, per-block design (``L``,
``L_bf16`` here) is a route of its own for widths the chain does not take
(``lstm_fwd_route``). A runs the same pre-pass and then a GRU forward chain
on clusters (builds ``A_chain``, ``A_chain_bf16``; ``gru_fwd_plan``); its
per-block design (``A``, ``A_bf16``) is the route of widths that chain does
not take (``gru_fwd_route``). C and E, the GRU's backward through time,
run as a gate pre-pass and a chain on clusters (C also a dx pass; the
section "The GRU's backward through time"); whether they launch is the
chain's plan (``gru_bptt_plan``), the same for the narrow and the wide
builds of E. S and S xp, the LSTM step, are one product on the tensor cores
over tiles of batch rows x hidden units, whose plan (``step_plan``)
launches at H a multiple of 32 up to ``STEP_MAX_H``.

The training step takes one route for all its layers and heads:
- ``"narrow"``, the GRU(256) path: A + C per encoder layer (the x-projection
  inside them), D over 8 rows per block and E with the notes head's
  T-length side heads in one launch each;
- ``"wide"``, taken where a narrow build does not launch (from H = 512 on: D
  at 160 registers a thread): xp = x @ W + b as one
  torch.matmul and F + G per encoder layer, and every head decoded on its
  own by the 2-rows-per-block builds of D and E, as the JAX package does at
  H = 512 (``fused_train.py:2282-2288``, ``models/vae.py:392-394``). A and
  C alone would launch at 512, but with x @ W outside the serial kernel one
  notes layer's forward + backward took 18.6 / 19.8 ms (L1 / L2) against
  21.4 / 34.7 ms for A + C on the H100, so the encoder goes wide too.
An LSTM step decodes every head per step through S on both routes (the JAX
package has no LSTM whole-head training kernel), so its route is the
encoder's: ``"narrow"`` is L + N per layer, ``"wide"`` is xp = x @ W + b and
Q + R. L and N would launch at 512 too; the LSTM switches at
``LSTM_NARROW_MAX_H`` = 256 because the JAX package does: its in-kernel
projection (rows 19 and 20) is the layer's path only while
``_lstm_x_train_vmem_ok`` admits it, which holds at H = 256 and is pinned
off at 512 (``tests/test_ops_train.py:827-841``), where it falls back to
``_lstm_layer_fallback_x`` (``fused_train.py:2559-2565``), the wide pair.
On the H100 the wide route is also the faster one there: ``chip_smoke.py``
times one LSTM(512) notes layer's forward + backward both ways, and the
wide route took 19.6 / 21.2 ms (L1 / L2) against the narrow route's
21.3 / 47.7 ms (NVIDIA H100 80GB HBM3, 700 W).
In a bfloat16 model (``compute_dtype``) the parts take bf16 builds (their
tiles stay float, as every bf16 build's): in-kernel projection layers A and
C or L and N (``A_bf16``, ``C_bf16``, ``L_bf16``, ``N_bf16``), the GRU's xp layers X for the forward (kernel X computes
what F would in bf16: the JAX package's ``_fwd_kernel`` in bf16 is its
``_encoder_kernel`` with the sequence emitted) and ``G_bf16``, the LSTM's
``Q_bf16`` and ``R_bf16``, heads D and E (``D_bf16``, ``E_bf16``; D's 144
registers a thread keep it under 512 threads) or ``D_wide_bf16`` and
``E_wide_bf16``; a head narrower than 8 is promoted to float32 and takes
D's and E's float32 builds. Where the TPU runs a bf16 head through rows 7
and 8 at a width where D's 8-row build does not launch (H = 512: 144
registers a thread), it takes ``D_wide_bf16`` (rows 7 and 13 share their
forward) and ``E_wide_row8_bf16`` (E's chain with row 8's rounding: the
streams for W left unrounded), or for a head promoted to
float32 the float32 wide builds, which compute rows 7 and 8's function
(``head_builds``). A float32 model with ``decode_residual_bf16`` takes D's
and E's bf16-residual builds (``D_resid``, ``E_resid``) in the multi-head
call, which runs where the JAX package's ``_mh_vmem_ok`` admits it
(``mh_vmem_ok``) at the batch the decode is called with. In float32 every
row of a part computes the same function, so the route is the chooser's
(``train_route``). In bf16 the
TPU's rows round differently, and there is no step route: which row the
JAX package runs is decided per part from (B, D, H) by its VMEM predicates,
which the port keeps copies of here (``x_train_vmem_ok`` ...
``dec_wide_btiles``): ``bf16_layer_mode`` gives an encoder layer's rows
("x": the in-kernel projection, rows 1 and 4 or 19 and 20; "inplace":
xp = x @ W + b rounded to bf16 and rows 9 and 10 or 15 and 16, dU from the
unrounded gate grads; "wide": the same xp and rows 11 and 12 or 17 and 18,
dU from the rounded stream; "scan": the XLA scan), ``bf16_head_mode`` a
GRU decode head's ("inplace": rows 7 and 8; "wide": rows 13 and 14;
"scan"), both from the batch the part is called with, as the JAX dispatch
reads shapes; ``head_builds`` names the builds of a head's rows. On the
card both raise NotImplementedError, naming the rows, where their port
builds do not launch at that width; no other row's rounding runs in their
place.
A width at which neither route launches raises ``LaunchLimitError`` naming the
limit. ``FORCE_ROUTE`` is a test hook (like the JAX package's
``_FORCE_TRAIN_MODE``) that sends small widths down the wide route.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

REGS_PER_SM = 65_536
SMEM_PER_BLOCK = 232_448
ROWS = 8          # kRows: batch rows per block of A to G
WIDE_ROWS = 2     # kWideRows: the wide builds of D and E
WIDE_THREADS = 512  # kWideThreads: the launch bound of F, G and the wide D, E

# registers per thread of the builds without launch bounds (the largest over
# a build's template instances), from nvcc -Xptxas -v for sm_90a
REGISTERS = {"A": 90, "B": 94, "D": 160, "L": 88, "M": 75,
             "U": 78, "V": 172, "A_bf16": 94, "D_bf16": 144,
             "L_bf16": 80, "D_resid": 160}
# the builds compiled under __launch_bounds__(WIDE_THREADS)
BOUNDED = ("F", "G", "D_wide", "X", "G_bf16", "D_wide_bf16")
# the widest LSTM whose encoder takes the narrow route (L + N; see above)
LSTM_NARROW_MAX_H = 256

FORCE_ROUTE: str | None = None  # test hook: None | "narrow" | "wide"


class LaunchLimitError(ValueError):
    """A kernel build cannot launch at the asked shape on the card."""


def smem_bytes(kernel: str, H: int, D: int = 0, n_layers: int = 1,
               dx: bool = False) -> int:
    """Dynamic shared memory of one block of ``kernel``: D is the layer's
    input width (A, L; U and V: of the stack, ``n_layers`` = 2, or of a
    branch, ``n_layers`` = 1), the head's output width (B, D, M) or the
    cell's input width (T). The bf16 builds (X, those of A, B, D, G, the
    wide D, and T, and U's and V's) and D's bf16-residual build hold the
    tiles of the builds they are twins of, in float: a bf16 value is widened
    as it is loaded. C and E run as phases (``gru_bptt_plan``: 0 here)."""
    if kernel in C_BUILDS or kernel in E_BUILDS or kernel in T_BUILDS:
        return 0
    kernel = kernel.removesuffix("_bf16").removesuffix("_resid")
    rows = WIDE_ROWS if kernel.endswith("_wide") else ROWS
    floats = {
        "A": D + 2 * H,
        "B": 2 * D + (n_layers + 1) * H,
        "D": 2 * D + (n_layers + 1) * H,
        "F": 2 * H,
        "G": 5 * H,
        "L": D + 3 * H,  # x, h twice (h_{t-1} and h_t), c
        "M": 2 * D + (n_layers + 1) * H + n_layers * H,  # probs, logits, h tiles, c tiles
        "X": 2 * H,  # as F
        # the stack: x, h1, h2, r * h; a branch: as A
        "U": D + (n_layers + 1) * H,
        # the stack: x, h1_t, h1_{t-1}, h2_{t-1}, r * h, the gate grads (3H),
        # layer 2's dx (H); a branch: x, h_{t-1}, r * h, the gate grads (3H)
        "V": D + (3 * n_layers + 2) * H + (D if dx else 0),
    }[kernel.removesuffix("_wide")]
    return 4 * rows * floats


def launch_limit(kernel: str, H: int, smem: int) -> str | None:
    """Why a block of H threads of ``kernel`` with ``smem`` bytes of shared
    memory cannot launch on the card, or None when it can. For the LSTM's
    backward (N, R and their bf16 builds: ``BPTT_BUILDS``), its forward
    over xp (Q, Q bf16, Y, L's chain: ``FWD_BUILDS``) and A's chain
    (``GRU_FWD_BUILDS``) and C's and E's builds (``C_BUILDS``, ``E_BUILDS``)
    the chain's cluster plan decides, whatever ``smem``: ``bptt_limit``,
    ``fwd_limit``, ``gru_fwd_limit``, ``gru_bptt_limit``; for S and S xp
    their tile plan: ``step_limit``."""
    if kernel in C_BUILDS or kernel in E_BUILDS:
        return gru_bptt_limit(kernel, H)
    if kernel in BPTT_BUILDS:
        return bptt_limit(kernel, H)
    if kernel in FWD_BUILDS:
        return fwd_limit(kernel, H)
    if kernel in GRU_FWD_BUILDS:
        return gru_fwd_limit(kernel, H)
    if kernel in STEP_BUILDS:
        return step_limit(kernel, H)
    if kernel in T_BUILDS:
        return gru_step_limit(kernel, H)
    if H < 32 or H % 32:
        return f"kernel {kernel} takes H a multiple of 32 (one warp per 32 columns), got H={H}"
    if kernel in BOUNDED:
        if H > WIDE_THREADS:
            return (f"kernel {kernel} is built under __launch_bounds__({WIDE_THREADS}): "
                    f"H={H} threads per block do not launch")
    else:
        regs = -(-REGISTERS[kernel] // 8) * 8
        if regs * H > REGS_PER_SM:
            return (f"kernel {kernel} uses {REGISTERS[kernel]} registers a thread: {H} threads "
                    f"need {regs * H:,} > the {REGS_PER_SM:,} registers of an SM")
    if smem > SMEM_PER_BLOCK:
        return (f"kernel {kernel} needs {smem:,} bytes of shared memory a block at H={H}, "
                f"more than the {SMEM_PER_BLOCK:,} a block may have")
    return None


def require(kernel: str, H: int, smem: int) -> None:
    """Raise LaunchLimitError when ``kernel`` cannot launch at H."""
    why = launch_limit(kernel, H, smem)
    if why is not None:
        raise LaunchLimitError(why)


# ---------------------------------------------------------------------------
# The LSTM's backward through time (kernels N and R, csrc/lstm_cell_bwd.cuh):
# a gate pre-pass and N's dx pass, 256 threads over 128 x 128 output tiles
# with two (8, 128) float tiles of static shared memory, and the serial
# chain on thread-block clusters of 512-thread CTAs. A cluster owns
# ``rows`` batch rows; its C CTAs split the H units (Hc = H / C each) and
# keep their slices of U^T (4 Hc rows, H wide) in shared memory, beside the
# da tile (rows rounded up to 8, 4 Hc floats) and the partial dh buffers
# (nbuf x splits x rows x H floats; the bf16 builds take the product on the
# tensor cores, da split into three bf16 terms, in one split). C is the
# smallest cluster whose slice
# fits beside one row's buffers; float32 where none does (H = 512) streams
# its slice at C = 16 through a ring of ``stages`` chunks of 16 gate rows
# (as many as fit, 2 to 8). ``rows`` is
# ceil(B / the card's active clusters at that C), so that the clusters run
# at once where the buffers allow it.
# ---------------------------------------------------------------------------

BPTT_BUILDS = ("N", "N_bf16", "R", "R_bf16")
GEMM_THREADS = 256     # kGemmThreads: the pre-pass and dx pass
CHAIN_THREADS = 512    # kChainThreads
CHAIN_WARPS = CHAIN_THREADS // 32
CHAIN_MAX_PAIRS = 3    # kMaxPairs: (unit, row) pairs a chain thread owns
STREAM_CHUNK = 16      # kStreamChunk: gate rows of a streamed chunk
DA_PAD = 8             # kDaPad: the da tile's rows are 4 Hc + DA_PAD floats
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is a non-portable cluster size
# cudaOccupancyMaxActiveClusters of the chain on an NVIDIA H100 80GB HBM3 at
# one CTA an SM (chip_smoke.py prints what the card reports; the wrappers
# ask the card itself)
MAX_CLUSTERS_H100 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}

# the LSTM backward's phase builds (csrc/lstm_cell_bwd.cuh), each under
# __launch_bounds__ of its threads a block: the gate pre-pass (the bf16
# builds on the tensor cores), the chain and N's dx pass; their registers a
# thread from ptxas (``chip_smoke.py`` checks the builds against both)
BPTT_PHASE_THREADS = {f"{k}_{p}{s}": (CHAIN_THREADS if p == "chain" else GEMM_THREADS)
                      for k, phases in (("N", ("gates", "chain", "dx")), ("R", ("gates", "chain")))
                      for p in phases for s in ("", "_bf16")}
REGISTERS.update({"N_gates": 128, "N_chain": 128, "N_dx": 127, "R_gates": 127, "R_chain": 128,
                  "N_gates_bf16": 123, "N_chain_bf16": 128, "N_dx_bf16": 127,
                  "R_gates_bf16": 121, "R_chain_bf16": 128})


class BpttPlan(NamedTuple):
    """How the chain of a BPTT build runs at (H, B): ``cluster`` CTAs a
    cluster, ``rows`` batch rows a cluster, ``clusters`` clusters,
    ``splits`` partials per CTA (the warps split its gate rows when the
    product's tiles are fewer than the warps), ``nbuf`` partial buffers (2:
    one cluster barrier a step), ``stages`` chunks in the streamed ring (0
    where the slice is resident), ``smem`` bytes of dynamic shared memory a
    CTA."""

    cluster: int
    rows: int
    clusters: int
    splits: int
    nbuf: int
    stages: int
    smem: int


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def chain_smem(H: int, C: int, rows: int, splits: int, nbuf: int, stages: int,
               elem: int) -> int:
    """``chain_smem`` of csrc/lstm_cell_bwd.cuh, in bytes: the slice (or the
    ``stages`` chunks of its ring, when ``stages`` > 0), the da tile and the
    partial buffers."""
    Hc = H // C
    slice_ = stages * STREAM_CHUNK * H * 4 if stages else 4 * Hc * H * elem
    return slice_ + _round8(rows) * (4 * Hc + DA_PAD) * 4 + nbuf * splits * rows * H * 4


def bptt_cluster(build: str, H: int) -> tuple[int, bool]:
    """(cluster size, whether the slice streams) of a BPTT build at width H;
    raises LaunchLimitError where no cluster holds it."""
    if build not in BPTT_BUILDS:
        raise ValueError(f"{build!r} is not one of {BPTT_BUILDS}")
    if H < 64 or H % 64:
        raise LaunchLimitError(f"kernel {build}'s chain takes H a multiple of 64 (two units a "
                               f"lane), got H={H}")
    elem = 2 if build.endswith("_bf16") else 4
    if elem == 2 and H % 128:
        raise LaunchLimitError(f"kernel {build}'s chain takes H a multiple of 128 (a warp's "
                               f"units in tiles of 8 on the tensor cores), got H={H}")
    for C in CLUSTER_SIZES:
        if H % C == 0 and chain_smem(H, C, 1, 1, 1, 0, elem) <= SMEM_PER_BLOCK and (
                elem == 4 or (H // C) % 16 == 0):
            return C, False
    if elem == 4:
        return CLUSTER_SIZES[-1], True
    raise LaunchLimitError(
        f"kernel {build}'s chain needs {chain_smem(H, 16, 1, 1, 1, 0, elem):,} bytes of "
        f"shared memory a CTA at H={H} in clusters of 16, more than the {SMEM_PER_BLOCK:,} a "
        "block may have")


def bptt_plan(build: str, H: int, B: int, max_clusters: int | None = None) -> BpttPlan:
    """The chain's plan of BPTT build ``build`` at width H and batch B, with
    ``max_clusters`` clusters of its size active at once (default: the
    H100's, ``MAX_CLUSTERS_H100``). Raises LaunchLimitError where the chain
    does not launch."""
    C, stream = bptt_cluster(build, H)
    elem = 2 if build.endswith("_bf16") else 4
    Hc = H // C
    M = max_clusters or MAX_CLUSTERS_H100[C]
    least = 2 if stream else 0  # the ring's fewest chunks
    # the most rows a cluster takes: the pairs its threads own (and three
    # m-tiles of 16 on the tensor cores), and one partial buffer beside the
    # slice and the da tile
    most = CHAIN_MAX_PAIRS * CHAIN_THREADS // Hc
    if elem == 2:
        most = min(most, 48)
    while chain_smem(H, C, most, 1, 1, least, elem) > SMEM_PER_BLOCK:
        most -= 1
    rows = max(1, min(-(-B // M), most))
    tiles = (H // 64) * (_round8(rows) // 8)
    for nbuf in (2, 1):
        for splits in (8, 4, 2, 1) if elem == 4 else (1,):
            if (tiles * splits > CHAIN_WARPS and splits > 1) or Hc % splits:
                continue
            if chain_smem(H, C, rows, splits, nbuf, least, elem) > SMEM_PER_BLOCK:
                continue
            stages = least
            while stream and stages < min(8, 4 * Hc // STREAM_CHUNK) and chain_smem(
                    H, C, rows, splits, nbuf, stages + 1, elem) <= SMEM_PER_BLOCK:
                stages += 1
            return BpttPlan(C, rows, -(-B // rows), splits, nbuf, stages,
                            chain_smem(H, C, rows, splits, nbuf, stages, elem))
    raise AssertionError("one buffer of one split fits by the choice of rows")


def bptt_limit(build: str, H: int) -> str | None:
    """Why BPTT build ``build``'s chain cannot launch at width H, or None."""
    try:
        bptt_cluster(build, H)
    except LaunchLimitError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# The LSTM's forward over xp (kernels Q and Y, csrc/lstm_cell_fwd.cuh): one
# serial chain on thread-block clusters of 512-thread CTAs. A cluster owns
# ``rows`` batch rows; its C CTAs split the H units (Hc = H / C each), each
# keeps its 4 Hc gate columns of U (an H x 4 Hc slice) and the whole h of
# its rows in shared memory (twice in bf16: read and written), and each step ends
# with one all-gather of h through distributed shared memory. The bf16
# builds (Q_bf16, Y) keep the slice resident and take h @ U on the tensor
# cores (rows in m-tiles of 16, at most 48); float32 (Q) takes it as FFMA,
# ``splits`` threads sharing each tile's depth, and streams the slice in
# chunks of 64 depth rows through a ring of ``stages`` chunks where it does
# not fit (H = 512). C is the smallest cluster whose resident slice fits
# beside one row's tiles; ``rows`` is ceil(B / the card's active clusters at
# that C), bounded by what fits beside the slice.
# ---------------------------------------------------------------------------

FWD_BUILDS = ("Q", "Q_bf16", "Y", "L_chain", "L_chain_bf16")
FWD_MAX_ITEMS = 2   # kFwdMaxItems: (m-tile, unit group) items a warp owns
FWD_MAX_ROWS_MMA = 48  # kFwdMaxRowsMma: three m-tiles of 16
H_PAD = 8           # kHPad: the bf16 h tile's rows are H + H_PAD values
TILE_STRIDE = 33    # kTileStride: floats a float32 tile's partials (or xp) take
FWD_CHUNK = 64      # kFwdChunk: depth rows of a streamed chunk of Q's float32 slice
MAX_SPLITS = 16     # the float product's depth splits: powers of two up to 16
XS_PAD = 8          # kXsPad: L_chain_bf16's float xp tile rows are 4 Hc + XS_PAD floats
REGISTERS.update({"Q": 128, "Q_bf16": 128, "Y": 128, "L_chain": 128, "L_chain_bf16": 128})


class FwdPlan(NamedTuple):
    """How the forward chain of a build runs at (H, B): ``cluster`` CTAs a
    cluster, ``rows`` batch rows a cluster, ``clusters`` clusters,
    ``splits`` threads sharing a tile's depth (float32; 1 in bf16),
    ``stages`` chunks in the streamed ring (0 where the slice is resident),
    ``smem`` bytes of dynamic shared memory a CTA."""

    cluster: int
    rows: int
    clusters: int
    splits: int
    stages: int
    smem: int


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def fwd_chain_smem(H: int, C: int, rows: int, splits: int, stages: int, elem: int,
                   xs: bool = False) -> int:
    """``fwd_chain_smem`` of csrc/lstm_cell_fwd.cuh, in bytes: the slice (or
    the ``stages`` chunks of its ring), the h tiles (two in bf16, one in
    float32) and, in float32, the partials of splits 1 and up and the xp of
    the step to come (TILE_STRIDE floats a tile of 8 rows); in bf16 with
    ``xs`` (L's chain, xp in float32) the float xp tile."""
    Hc = H // C
    if elem == 2:
        return (4 * Hc * H * 2 + 2 * _round16(rows) * (H + H_PAD) * 2
                + (rows * (4 * Hc + XS_PAD) * 4 if xs else 0))
    slice_ = stages * FWD_CHUNK * 4 * Hc * 4 if stages else 4 * Hc * H * 4
    return (slice_ + _round8(rows) * H * 4
            + splits * TILE_STRIDE * Hc * (_round8(rows) // 8) * 4)


def _fwd_elem(build: str) -> int:
    if build not in FWD_BUILDS:
        raise ValueError(f"{build!r} is not one of {FWD_BUILDS}")
    return 4 if build in ("Q", "L_chain") else 2


def fwd_cluster(build: str, H: int) -> tuple[int, bool]:
    """(cluster size, whether the slice streams) of a forward chain build at
    width H; raises LaunchLimitError where no cluster holds it."""
    elem, xs = _fwd_elem(build), build == "L_chain_bf16"
    multiple = 64 if elem == 4 else 128
    if H < multiple or H % multiple:
        why = ("four units a 16-byte copy at 16 CTAs" if elem == 4
               else "units in groups of 16 on the tensor cores")
        raise LaunchLimitError(f"kernel {build}'s chain takes H a multiple of {multiple} "
                               f"({why}), got H={H}")
    for C in CLUSTER_SIZES:
        Hc = H // C
        if H % C == 0 and Hc % (4 if elem == 4 else 16) == 0 and fwd_chain_smem(
                H, C, 1, 1, 0, elem, xs) <= SMEM_PER_BLOCK:
            return C, False
    if elem == 4 and CHAIN_THREADS % (H // 16):
        raise LaunchLimitError(f"kernel {build}'s chain streams its slice in clusters of 16 at "
                               f"H a divisor of 8192 (its threads split a chunk's rows), got H={H}")
    if elem == 4 and fwd_chain_smem(H, 16, 1, 1, 2, elem) <= SMEM_PER_BLOCK:
        return CLUSTER_SIZES[-1], True
    need = fwd_chain_smem(H, 16, 1, 1, 2 if elem == 4 else 0, elem, xs)
    raise LaunchLimitError(
        f"kernel {build}'s chain needs {need:,} bytes of shared memory a CTA at H={H} in "
        f"clusters of 16, more than the {SMEM_PER_BLOCK:,} a block may have")


def fwd_plan(build: str, H: int, B: int, max_clusters: int | None = None) -> FwdPlan:
    """The forward chain's plan of build ``build`` (``FWD_BUILDS``) at width
    H and batch B, with ``max_clusters`` clusters of its size active at
    once (default: the H100's, ``MAX_CLUSTERS_H100``). Raises
    LaunchLimitError where the chain does not launch."""
    C, stream = fwd_cluster(build, H)
    elem, xs = _fwd_elem(build), build == "L_chain_bf16"
    Hc = H // C
    M = max_clusters or MAX_CLUSTERS_H100[C]
    least = 2 if stream else 0  # the ring's fewest chunks
    # the most rows a cluster takes: at most three m-tiles of 16 on the
    # tensor cores, each warp at most FWD_MAX_ITEMS (m-tile, 8 units) items,
    # or one tile of 8 rows a thread of split 0; one split beside the slice
    if elem == 2:
        most = min(FWD_MAX_ROWS_MMA, FWD_MAX_ITEMS * CHAIN_WARPS // (Hc // 8) * 16)
    else:
        most = CHAIN_THREADS // Hc * 8
    while fwd_chain_smem(H, C, most, 1, least, elem, xs) > SMEM_PER_BLOCK:
        most -= 1
    rows = max(1, min(-(-B // M), most))
    splits = 1
    if elem == 4:
        tiles = Hc * _round8(rows) // 8
        while (splits < MAX_SPLITS and tiles * 2 * splits <= CHAIN_THREADS
               and fwd_chain_smem(H, C, rows, 2 * splits, least, elem) <= SMEM_PER_BLOCK):
            splits *= 2
    stages = least
    while stream and stages < 8 and fwd_chain_smem(H, C, rows, splits, stages + 1,
                                                   elem) <= SMEM_PER_BLOCK:
        stages += 1
    return FwdPlan(C, rows, -(-B // rows), splits, stages,
                   fwd_chain_smem(H, C, rows, splits, stages, elem, xs))


def fwd_limit(build: str, H: int) -> str | None:
    """Why forward chain build ``build`` cannot launch at width H, or None."""
    try:
        fwd_cluster(build, H)
    except LaunchLimitError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# Kernel L (csrc/lstm_layer_fwd.cu): an x @ W pre-pass on the tensor cores,
# then the forward chain above over its float32 xp (builds "L_chain",
# "L_chain_bf16"); where the chain does not launch (H not a multiple of 64
# in float32, or of 128 in bf16) the first design, one block of 8 rows and
# H threads (builds "L", "L_bf16": REGISTERS and smem_bytes), as a route
# of its own, picked here before any launch.
# ---------------------------------------------------------------------------

def lstm_fwd_route(H: int, D: int, bf16: bool = False) -> str:
    """The route of kernel L at width H and input width D: "chain" (the
    pre-pass and the chain) where the chain launches, else "block" where
    the per-block build does; raises LaunchLimitError where neither does."""
    sfx = "_bf16" if bf16 else ""
    chain_why = fwd_limit("L_chain" + sfx, H)
    if chain_why is None:
        return "chain"
    block_why = launch_limit("L" + sfx, H, smem_bytes("L", H, D))
    if block_why is None:
        return "block"
    raise LaunchLimitError(f"kernel L launches at H={H} neither on its chain ({chain_why}) "
                           f"nor per block ({block_why})")


def l_limit(H: int, D: int, bf16: bool = False) -> str | None:
    """Why kernel L launches on no route at (H, D), or None."""
    try:
        lstm_fwd_route(H, D, bf16)
    except LaunchLimitError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# Kernel A (csrc/gru_layer_fwd.cu): L's x @ W pre-pass (csrc/xproj.cuh), then
# the GRU forward chain of csrc/gru_cell_fwd.cuh over its float32 xp (builds
# "A_chain", "A_chain_bf16"): clusters of 512-thread CTAs, CTA c owning the
# units [c Hc, (c+1) Hc) and their 3 Hc gate columns of U (an H x 3 Hc
# slice), the whole h and r * h of its rows in two tiles, two cluster
# barriers a step; bf16 takes h @ U[:, :2H] on the tensor cores (the h tile
# in bf16, rows in m-tiles of 16). C is the smallest cluster whose resident slice takes at
# most half of a block's shared memory; float32 where none does (H = 512)
# streams its slice at C = 16 in chunks of GRU_CHUNK depth rows through a
# ring of ``stages`` (as many as fit, 2 to 8). ``rows`` is ceil(B / the
# card's active clusters at that C), bounded by what fits; ``splits``
# threads share a tile's depth. Where the chain does not launch, A's first,
# per-block design (builds "A", "A_bf16": REGISTERS and smem_bytes) is a
# route of its own, picked here before any launch.
# ---------------------------------------------------------------------------

GRU_FWD_BUILDS = ("A_chain", "A_chain_bf16")
GRU_CHUNK = 32        # kGruChunk: depth rows of a streamed chunk of the float32 slice
GRU_MAX_SPLITS = 16   # kGruMaxSplits
REGISTERS.update({"A_chain": 128, "A_chain_bf16": 128})


class GruFwdPlan(NamedTuple):
    """How A's chain runs at (H, B): ``cluster`` CTAs a cluster, ``rows``
    batch rows a cluster, ``clusters`` clusters, ``splits`` threads sharing
    a tile's depth, ``stages`` chunks in the streamed ring (0 where the
    slice is resident), ``smem`` bytes of dynamic shared memory a CTA."""

    cluster: int
    rows: int
    clusters: int
    splits: int
    stages: int
    smem: int


def gru_chain_smem(H: int, C: int, rows: int, splits: int, stages: int, elem: int) -> int:
    """``gru_chain_smem`` of csrc/gru_cell_fwd.cuh, in bytes: the slice
    (``elem`` bytes a value) or the ``stages`` chunks of its ring; the h and
    r * h tiles in float32, or in bf16 (P1 on the tensor cores) the h tile
    in bf16 (rows in m-tiles of 16, H + H_PAD a row), the r * h tile, z's
    tile and the float32 xp of z and r (rows, 2 Hc + XS_PAD); the partials
    of splits 1 and up and the owners' xp (TILE_STRIDE floats a tile of 8
    rows)."""
    Hc, R8 = H // C, _round8(rows)
    tiles = splits * TILE_STRIDE * Hc * (R8 // 8) * 4
    if elem == 2:
        return (3 * Hc * H * 2 + _round16(rows) * (H + H_PAD) * 2 + H * R8 * 4 + R8 * Hc * 4
                + rows * (2 * Hc + XS_PAD) * 4 + tiles)
    slice_ = stages * GRU_CHUNK * 2 * Hc * 4 if stages else 3 * Hc * H * elem
    return slice_ + 2 * H * R8 * 4 + tiles


def _gru_elem(build: str) -> int:
    if build not in GRU_FWD_BUILDS:
        raise ValueError(f"{build!r} is not one of {GRU_FWD_BUILDS}")
    return 2 if build.endswith("_bf16") else 4


def gru_fwd_cluster(build: str, H: int) -> tuple[int, bool]:
    """(cluster size, whether the slice streams) of A's chain build at
    width H; raises LaunchLimitError where no cluster holds it."""
    elem = _gru_elem(build)
    # the units a CTA takes: whole 16-byte copies of the slice (float32), or
    # in bf16 whole groups of 32 (the z and r slice's 2 Hc / 8 chunks a row,
    # swizzled over 8)
    units = 4 if elem == 4 else 32
    for C in CLUSTER_SIZES:
        if H % C == 0 and (H // C) % units == 0 and 3 * (H // C) * H * elem <= SMEM_PER_BLOCK // 2:
            return C, False
    if elem == 4 and H % 64 == 0 and gru_chain_smem(H, 16, 1, 1, 2, elem) <= SMEM_PER_BLOCK:
        return CLUSTER_SIZES[-1], True
    raise LaunchLimitError(
        f"kernel {build}'s chain takes H whose slice of U fits a CTA of a cluster of at most 16 "
        f"({units} units a CTA at least; float32 streams it at H a multiple of 64), got H={H}")


def gru_fwd_plan(build: str, H: int, B: int, max_clusters: int | None = None) -> GruFwdPlan:
    """A's chain plan of build ``build`` (``GRU_FWD_BUILDS``) at width H and
    batch B, with ``max_clusters`` clusters of its size active at once
    (default: the H100's, ``MAX_CLUSTERS_H100``). Raises LaunchLimitError
    where the chain does not launch."""
    C, stream = gru_fwd_cluster(build, H)
    elem = _gru_elem(build)
    Hc = H // C
    M = max_clusters or MAX_CLUSTERS_H100[C]
    least = 2 if stream else 0  # the ring's fewest chunks
    # the most rows a cluster takes: one tile of 8 rows a thread of split 0
    # (bf16: each warp at most FWD_MAX_ITEMS (m-tile, 8 units) items of P1),
    # and one split beside the slice
    most = CHAIN_THREADS // Hc * 8
    if elem == 2:
        most = min(most, FWD_MAX_ITEMS * CHAIN_WARPS // (Hc // 8) * 16)
    while gru_chain_smem(H, C, most, 1, least, elem) > SMEM_PER_BLOCK:
        most -= 1
    rows = max(1, min(-(-B // M), most))
    tiles = Hc * _round8(rows) // 8
    depth = GRU_CHUNK if stream else H  # what the splits share
    splits = 1
    while (splits < GRU_MAX_SPLITS and tiles * 2 * splits <= CHAIN_THREADS
           and depth % (2 * splits) == 0
           and gru_chain_smem(H, C, rows, 2 * splits, least, elem) <= SMEM_PER_BLOCK):
        splits *= 2
    stages = least
    while stream and stages < min(8, H // GRU_CHUNK) and gru_chain_smem(
            H, C, rows, splits, stages + 1, elem) <= SMEM_PER_BLOCK:
        stages += 1
    return GruFwdPlan(C, rows, -(-B // rows), splits, stages,
                      gru_chain_smem(H, C, rows, splits, stages, elem))


def gru_fwd_limit(build: str, H: int) -> str | None:
    """Why A's chain build ``build`` cannot launch at width H, or None."""
    try:
        gru_fwd_cluster(build, H)
    except LaunchLimitError as e:
        return str(e)
    return None


def gru_fwd_route(H: int, D: int, bf16: bool = False) -> str:
    """The route of kernel A at width H and input width D: "chain" (the
    pre-pass and the chain) where the chain launches, else "block" where
    the per-block build does; raises LaunchLimitError where neither does."""
    sfx = "_bf16" if bf16 else ""
    chain_why = gru_fwd_limit("A_chain" + sfx, H)
    if chain_why is None:
        return "chain"
    block_why = launch_limit("A" + sfx, H, smem_bytes("A", H, D))
    if block_why is None:
        return "block"
    raise LaunchLimitError(f"kernel A launches at H={H} neither on its chain ({chain_why}) "
                           f"nor per block ({block_why})")


def a_limit(H: int, D: int, bf16: bool = False) -> str | None:
    """Why kernel A launches on no route at (H, D), or None."""
    try:
        gru_fwd_route(H, D, bf16)
    except LaunchLimitError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# The GRU's backward through time (kernels C and E,
# csrc/gru_cell_bwd_chain.cuh): a gate pre-pass on the tensor cores (and C's
# dx pass), then the serial chain on thread-block clusters of 512-thread
# CTAs. A cluster owns ``rows`` batch rows of a part (C: the layer; E: each
# head of a call, its clusters after the previous head's); its C CTAs split
# the H units (Hc = H / C each) and read their 3 Hc gate rows of U^T (E:
# also of W2^T and of W1^T, zero-padded to a multiple of 64 columns) through
# a ring of chunks of GRU_BWD_CHUNK rows, in the weights' element type:
# ``resident`` where the ring holds every chunk of a step (``stages`` = the
# chunks of the widest part), else streamed from L2 through ``stages`` slots
# (2 to 8). A stage's product writes a partial of ``pw`` columns (C: H; a
# 2-layer head: 2H, layer 2's dx beside dh; a 1-layer head: H + the padded
# D); ``nbuf`` partial buffers (2: one cluster barrier a stage). A warp owns
# at most GRU_BWD_MAX_ITEMS product tiles of 8 rows x 64 units and a thread
# at most GRU_BWD_MAX_PAIRS (row, unit) pairs, which bound a part's rows.
# ``gru_bptt_plan`` picks the cluster size by a cost model: a part's waves
# of clusters (the card's active clusters at that size) times the serial
# work of its steps (each stage's product tiles a warp walks over the
# stage's gate rows, a barrier and the peers' loads of its reductions, and
# a streamed ring's waits), the longest part's or, where more, the whole
# launch's work over the active clusters; smaller clusters first on a tie.
# Timed on the H100 at every cluster size at the paths' 16 shapes
# (tools/time_gru_bptt.py; PERF.md, Findings): no one size was within 10 %
# of the fastest everywhere (8 lost 11-124 % to 16 at B = 5 and on E's
# heads at H = 512, 16 lost 22-84 % to 8 where it takes more waves), and
# the model's pick is within 10 % of the fastest at all 16
# (tests/test_torch_gru_bwd_chain.py holds it there); without any one of
# its four constants it is not. There is
# no depth split: the product tiles over rows x units keep the warps busy.
# ---------------------------------------------------------------------------

GRU_BPTT_BUILDS = ("C_chain", "C_chain_bf16", "E_chain", "E_chain_bf16")
# the route chooser's names of C's and E's builds, each run by a chain build
C_BUILDS = ("C", "C_bf16")
E_BUILDS = ("E", "E_bf16", "E_resid", "E_wide", "E_wide_bf16", "E_wide_row8_bf16")
GRU_BWD_CHUNK = 16      # kBwdChunk: gate rows of a chunk of a slice
GRU_BWD_MAX_ITEMS = 2   # kBwdMaxItems: product tiles a warp owns in a stage
GRU_BWD_MAX_PAIRS = 3   # kBwdMaxPairs: (row, unit) pairs a thread owns
GRU_BWD_TILE = 64       # kBwdTile: units of a float product tile (8 rows)
GRU_BWD_TILE_MMA = 32   # kBwdTileMma: units of a bf16 product tile (16 rows, tensor cores)
GRU_BWD_SLICE_PAD = 8   # kBwdSlicePad: a bf16 ring row holds H + 8 values
GRU_BWD_MAX_STAGES = 8  # the most slots of a streamed ring (cp.async groups in flight)
# dynamic shared memory a chain CTA may take: the block's less what its
# static shared memory (the segments, E's head) may hold (kBwdStaticSmem)
GRU_BWD_SMEM = SMEM_PER_BLOCK - 1024
# the cost model's constants, in cycles of a scheduler (4 an SM): a warp's
# FFMA product tile over one gate row (16 FMA and 3 loads a lane, 4 warps a
# scheduler), a cluster barrier, one peer's load in a reduction, a streamed
# chunk's wait
_TILE_ROW_CYCLES = 4 * 19
_BARRIER_CYCLES = 1500
_PEER_CYCLES = 60
_CHUNK_CYCLES = 300
REGISTERS.update({"C_chain": 128, "C_chain_bf16": 128, "E_chain": 128, "E_chain_bf16": 128})


class GruBpttPlan(NamedTuple):
    """How the chain of C or E runs: ``cluster`` CTAs a cluster, ``rows``
    batch rows a cluster of each part (C: one; E: per head of the call),
    ``clusters`` per part, ``nbuf`` partial buffers, ``stages`` slots of the
    ring, ``resident`` whether it holds every chunk of a step, ``smem``
    bytes of dynamic shared memory a CTA, ``waves`` of clusters at the
    card's active clusters."""

    cluster: int
    rows: tuple
    clusters: tuple
    nbuf: int
    stages: int
    resident: bool
    smem: int
    waves: int


class _Part(NamedTuple):
    """A part of a chain launch: its partial's width ``pw``, its layers,
    whether its layers' dx feeds the chain (``head``), its steps ``T`` and
    its output width ``D`` (0 for C)."""

    pw: int
    layers: int
    head: bool
    T: int
    D: int

    def chunks(self, Hc: int) -> int:
        """Chunks of a step: a layer's 3 Hc gate rows of U^T, and of W^T in
        a head."""
        return self.layers * (6 if self.head else 3) * Hc // GRU_BWD_CHUNK


def _round64(n: int) -> int:
    return -(-n // 64) * 64


def gru_bptt_smem(H: int, C: int, rows_max: int, part_floats: int, nbuf: int, stages: int,
                  elem: int, D_max: int = 0) -> int:
    """``gru_bptt_smem`` of csrc/gru_cell_bwd_chain.cuh, in bytes: the ring
    (its bf16 rows padded), the partial buffers, the da tile (rows rounded
    to 16) and, for heads, Wo's own rows, the dlogits and the fed-back
    probs' grad."""
    Hc = H // C
    head = (Hc * D_max + 2 * rows_max * D_max) * 4 if D_max else 0
    ring = stages * GRU_BWD_CHUNK * (H + (GRU_BWD_SLICE_PAD if elem == 2 else 0)) * elem
    return ring + nbuf * part_floats * 4 + _round16(rows_max) * 3 * Hc * 4 + head


def _bptt_parts(build: str, H: int, heads) -> list[_Part]:
    """C's layer, or E's heads ((D, n_layers[, T]) each; T 64 by default)."""
    if build.startswith("C"):
        return [_Part(H, 1, False, 64, 0)]
    return [_Part(2 * H if h[1] == 2 else H + _round64(h[0]), h[1], True,
                  h[2] if len(h) > 2 else 64, h[0]) for h in heads]


def _items(rows: int, pw: int, elem: int) -> int:
    """Product tiles of a stage: 8 rows x 64 units in float, 16 x 32 on the
    tensor cores in bf16."""
    if elem == 2:
        return -(-rows // 16) * (pw // GRU_BWD_TILE_MMA)
    return -(-rows // 8) * (pw // GRU_BWD_TILE)


def _step_cycles(H: int, C: int, rows: int, part: _Part, streamed: bool, elem: int = 4) -> float:
    """The cost model's cycles of one reverse step of a part (a bf16 tile's
    gate row counted as a float tile's: its three products on the tensor
    cores take about the float tile's FFMA issue slots)."""
    Hc = H // C

    def tiles(w):  # product tiles a warp walks in a stage
        return -(-_items(rows, w, elem) // CHAIN_WARPS)

    pairs = -(-rows * Hc // CHAIN_THREADS)
    cyc = 0.0
    for layer in range(part.layers):
        # S1: the candidate's Hc gate rows; S2: U_zr's 2 Hc, and W's 3 Hc
        # where the layer's dx feeds the chain
        w2 = (part.pw if layer == part.layers - 1 else H) if part.head else H
        k2 = 5 * Hc if part.head else 2 * Hc
        cyc += (tiles(H) * Hc + tiles(w2) * k2) * 8 * _TILE_ROW_CYCLES
        cyc += 2 * (_BARRIER_CYCLES + pairs * C * _PEER_CYCLES)
    if streamed:
        cyc += part.chunks(Hc) * _CHUNK_CYCLES
    return cyc


def _bptt_cluster_ok(H: int, C: int) -> bool:
    return H % GRU_BWD_TILE == 0 and H % C == 0 and (H // C) % GRU_BWD_CHUNK == 0


def _bptt_fit(H: int, C: int, rows, parts, elem: int):
    """(nbuf, stages, resident, smem) of the first arrangement that fits at
    these rows: resident with 2 or 1 partial buffers, else streamed with the
    most slots (2 buffers first); None where none fits."""
    Hc = H // C
    part = max(r * p.pw for r, p in zip(rows, parts))
    D_max, rows_max = max(p.D for p in parts), max(rows)
    n_max = max(p.chunks(Hc) for p in parts)
    for nbuf in (2, 1):
        smem = gru_bptt_smem(H, C, rows_max, part, nbuf, n_max, elem, D_max)
        if smem <= GRU_BWD_SMEM:
            return nbuf, n_max, True, smem
    for nbuf in (2, 1):
        for stages in range(min(GRU_BWD_MAX_STAGES, n_max - 1), 1, -1):
            smem = gru_bptt_smem(H, C, rows_max, part, nbuf, stages, elem, D_max)
            if smem <= GRU_BWD_SMEM:
                return nbuf, stages, False, smem
    return None


def _most_rows(H: int, C: int, part: _Part, elem: int) -> int:
    """The most rows a cluster of a part takes: a thread's pairs and a
    warp's product tiles."""
    if elem == 2:
        tile_rows = GRU_BWD_MAX_ITEMS * CHAIN_WARPS // (part.pw // GRU_BWD_TILE_MMA) * 16
    else:
        tile_rows = GRU_BWD_MAX_ITEMS * CHAIN_WARPS // (part.pw // GRU_BWD_TILE) * 8
    return min(GRU_BWD_MAX_PAIRS * CHAIN_THREADS // (H // C), tile_rows)


def _bptt_candidate(H: int, B: int, C: int, parts, M: int, elem: int):
    """(plan, cost) at cluster size C with M clusters of it active at once,
    or None where nothing fits: each part first takes the fewest clusters
    its rows allow, the spare ones of a wave go to the part whose steps cost
    most, and rows shrink where shared memory runs short."""
    most = [_most_rows(H, C, p, elem) for p in parts]
    if min(most) < 1:
        return None
    k = [-(-B // m) for m in most]

    def cost(i, clusters):
        return parts[i].T * _step_cycles(H, C, -(-B // clusters), parts[i], False, elem)

    while sum(k) < M:
        worst = max(range(len(parts)), key=lambda i: cost(i, k[i]) if k[i] < B else -1.0)
        if k[worst] >= B:
            break
        k[worst] += 1
    while True:
        rows = [-(-B // ki) for ki in k]
        fit = _bptt_fit(H, C, rows, parts, elem)
        if fit is not None:
            break
        i = max(range(len(parts)), key=lambda j: rows[j] * parts[j].pw)
        if rows[i] == 1:
            return None
        k[i] = -(-B // (rows[i] - 1))
    nbuf, stages, resident, smem = fit
    clusters = [-(-B // r) for r in rows]
    Hc = H // C
    costs = [p.T * _step_cycles(H, C, r, p, p.chunks(Hc) > stages, elem)
             for r, p in zip(rows, parts)]
    # the launch's span: each part's clusters in waves of their own (the card
    # takes a part's clusters before the next part's), and at least the
    # work of every cluster spread over the M the card runs at once
    span = max(max(-(-k // M) * c for k, c in zip(clusters, costs)),
               sum(k * c for k, c in zip(clusters, costs)) / M)
    return GruBpttPlan(C, tuple(rows), tuple(clusters), nbuf, stages, resident, smem,
                       -(-sum(clusters) // M)), span


def gru_bptt_plan(build: str, H: int, B: int, heads=((61, 2),), active=None) -> GruBpttPlan:
    """The chain's plan of build ``build`` (``GRU_BPTT_BUILDS``) at width H
    and batch B: C's one layer, or E's ``heads`` ((D, n_layers[, T]) each,
    in the call's order). ``active(C)`` gives the clusters of size C the
    card runs at once (default: the H100's, ``MAX_CLUSTERS_H100``). Raises
    LaunchLimitError where the chain does not launch."""
    if build not in GRU_BPTT_BUILDS:
        raise ValueError(f"{build!r} is not one of {GRU_BPTT_BUILDS}")
    elem = 2 if build.endswith("_bf16") else 4
    parts = _bptt_parts(build, H, heads)
    if any(_round64(p.D) > H for p in parts):
        raise LaunchLimitError(f"kernel {build}'s chain takes heads whose width padded to 64 "
                               f"is at most H={H}")
    best = None
    for C in CLUSTER_SIZES:
        if not _bptt_cluster_ok(H, C):
            continue
        M = (active or MAX_CLUSTERS_H100.__getitem__)(C)
        got = _bptt_candidate(H, B, C, parts, M, elem)
        if got is not None and (best is None or got[1] < best[1]):
            best = got
    if best is None:
        raise LaunchLimitError(
            f"kernel {build}'s chain takes H a multiple of {GRU_BWD_TILE} whose slices fit a CTA "
            f"of a cluster of at most 16 ({GRU_BWD_CHUNK} units a CTA at least), got H={H}")
    return best[0]


def gru_bptt_limit(build: str, H: int, D: int = 61, n_layers: int = 2) -> str | None:
    """Why C's or E's build ``build`` (a name of ``C_BUILDS``, ``E_BUILDS``
    or ``GRU_BPTT_BUILDS``) cannot launch at width H (E: for a head of
    width D and ``n_layers``), or None."""
    if build in C_BUILDS:
        build = "C_chain" + ("_bf16" if build.endswith("_bf16") else "")
    elif build in E_BUILDS:
        build = "E_chain" + ("_bf16" if build.endswith("_bf16") else "")
    try:
        gru_bptt_plan(build, H, 1, ((D, n_layers),))
    except LaunchLimitError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# Kernels S and S xp (csrc/lstm_step.cu): one product [x | h] . [W ; U] on
# the tensor cores a launch (S xp: h . U), with the cell math in its
# epilogue. A block of 8 ``units`` threads owns ``rows`` batch rows x
# ``units`` hidden units (their 4 gate columns); the grid is H / units x
# ceil(B / rows) blocks. The plan is one of STEP_TILES: 32 x 8, except for
# bf16 S where 32 x 8 makes more than STEP_WIDE_BLOCKS blocks, which takes
# 64 x 16. Timed on the H100 at every path shape (tools/time_s_and_a.py
# --only tiles; PERF.md, Findings): 32 x 8 was the fastest tile or
# within 7 % of it everywhere but bf16 S at B = 256, H = 512 (512 blocks),
# where 64 x 16 took 18 % less; bf16 at B = 256, H = 256 (256 blocks) kept
# 32 x 8.
# ---------------------------------------------------------------------------

STEP_BUILDS = ("S", "S_bf16", "S_xp")
# the widest S the configs reach: above it the JAX package's step cells
# decline (``_fits_vmem`` at H = 1024) and a width mirror is Queue 2's work
STEP_MAX_H = 512
STEP_TILES = ((32, 8), (64, 16))  # (rows, units), by the kernel's tile index
SMS = 132  # streaming multiprocessors of an H100 SXM
STEP_WIDE_BLOCKS = 3 * SMS


class StepPlan(NamedTuple):
    """How S runs at (B, D, H): the tile's index in the kernel
    (``STEP_TILES``), its ``rows`` and ``units``, ``threads`` a block,
    ``blocks`` in the grid, ``smem`` bytes of dynamic shared memory a
    block."""

    tile: int
    rows: int
    units: int
    threads: int
    blocks: int
    smem: int


def step_smem(rows: int, units: int) -> int:
    """gemm_tc.cuh's ring (4 stages) of a kernel S tile: A (rows x (16 + 4)
    floats) and B (16 x (4 units + 8) floats) a stage."""
    return 4 * 4 * (rows * (16 + 4) + 16 * (4 * units + 8))


def step_limit(build: str, H: int) -> str | None:
    """Why kernel S's ``build`` cannot launch at width H, or None."""
    if build not in STEP_BUILDS:
        raise ValueError(f"{build!r} is not one of {STEP_BUILDS}")
    if H < 32 or H % 32 or H > STEP_MAX_H:
        return (f"kernel {build} takes H a multiple of 32 (its tiles of 8 or 16 units) up to "
                f"{STEP_MAX_H}, got H={H}")
    return None


def step_plan(B: int, D: int, H: int, elem: int = 4) -> StepPlan:
    """Kernel S's tile plan at batch B, input width D (0: S xp) and width H,
    operands of ``elem`` bytes; raises LaunchLimitError where it does not
    launch."""
    why = step_limit("S" if D else "S_xp", H)
    if why is not None:
        raise LaunchLimitError(why)
    tile = int(elem == 2 and -(-B // 32) * (H // 8) > STEP_WIDE_BLOCKS)
    rows, units = STEP_TILES[tile]
    return StepPlan(tile, rows, units, 8 * units, -(-B // rows) * (H // units),
                    step_smem(rows, units))


# ---------------------------------------------------------------------------
# Kernel T (csrc/gru_step.cu: T, T bf16, T xp): one GRU step on
# thread-block clusters and the tensor cores. A cluster of H / units CTAs
# owns ``rows`` batch rows; each CTA owns ``units`` hidden units and their
# gate columns, 32 (rows / 16) (units / 8) threads (a warp a fragment of 16
# rows x 8 units). Its shared memory: [x | h] of its rows in float32 (x's
# depth padded to STEP_T_KC, rows padded to 4 mod 32 floats), r * h in
# float32, and a ring of STEP_T_STAGES stages of STEP_T_KC depth rows x the
# gate columns of its units (3 units + 8 values; T xp 2 units + 8) in the
# operands' type. The plan (rows, units) is the kernel's tile index in
# STEP_T_PLANS; ``gru_step_plan`` picks it from the plans timed on the H100
# at the paths' shapes (``tools/time_t_and_b.py``; PERF.md, Findings).
# ---------------------------------------------------------------------------

T_BUILDS = ("T", "T_bf16", "T_xp")
# (rows, units); (16, 16) and (32, 16) were never within 10 % of the
# fastest where another plan launched (PERF.md, Findings)
STEP_T_PLANS = ((16, 32), (16, 64), (32, 32), (32, 64))
STEP_T_KC = 32      # kStepKC: depth rows of a ring stage
STEP_T_STAGES = 3   # kStepStages


class GruStepPlan(NamedTuple):
    """How T runs at (B, D, H): the plan's index in the kernel
    (``STEP_T_PLANS``), ``rows`` a cluster, ``units`` a CTA, ``cluster``
    CTAs a cluster (H / units), ``clusters``, ``threads`` a CTA, ``smem``
    bytes of dynamic shared memory a CTA; ``split``: the two-launch route
    (P1 and P2 as two launches, no clusters), taken where the plan's
    clusters outnumber the H100's active clusters of its size
    (``MAX_CLUSTERS_H100``)."""

    plan: int
    rows: int
    units: int
    cluster: int
    clusters: int
    threads: int
    smem: int
    split: bool = False


def gru_step_smem(D: int, H: int, rows: int, units: int, elem: int, xp: bool) -> int:
    """``gru_step_smem`` of csrc/gru_step.cu, in bytes (D is ignored for T
    xp)."""
    depth = H if xp else -(-D // STEP_T_KC) * STEP_T_KC + H
    row = -(-depth // 32) * 32 + 4
    return (rows * row * 4 + rows * (H + 4) * 4
            + STEP_T_STAGES * STEP_T_KC * ((2 if xp else 3) * units + 8) * elem)


def gru_step_limit(build: str, H: int) -> str | None:
    """Why kernel T's ``build`` (``T_BUILDS``) cannot launch at width H, or
    None."""
    if build not in T_BUILDS:
        raise ValueError(f"{build!r} is not one of {T_BUILDS}")
    if H < 32 or H % 32 or H > STEP_MAX_H:
        return (f"kernel {build} takes H a multiple of 32 (its plans' units) up to "
                f"{STEP_MAX_H}, got H={H}")
    return None


def gru_step_plans(B: int, D: int, H: int, elem: int = 4, xp: bool = False) -> list[GruStepPlan]:
    """Every plan of ``STEP_T_PLANS`` that launches at (B, D, H) (D ignored
    for T xp), operands of ``elem`` bytes: the units divide H into at most
    16 CTAs a cluster and the shared memory fits a CTA."""
    out = []
    for i, (rows, units) in enumerate(STEP_T_PLANS):
        smem = gru_step_smem(D, H, rows, units, elem, xp)
        if H % units or H // units > CLUSTER_SIZES[-1] or smem > SMEM_PER_BLOCK:
            continue
        out.append(GruStepPlan(i, rows, units, H // units, -(-B // rows),
                               32 * (rows // 16) * (units // 8), smem))
    return out


def gru_step_plan(B: int, D: int, H: int, elem: int = 4, xp: bool = False) -> GruStepPlan:
    """Kernel T's plan at batch B, input width D, width H (``xp``: T xp),
    operands of ``elem`` bytes; raises LaunchLimitError where T does not
    launch."""
    why = gru_step_limit("T_xp" if xp else "T", H)
    if why is not None:
        raise LaunchLimitError(why)
    plans = {(p.rows, p.units): p for p in gru_step_plans(B, D, H, elem, xp)}
    # the rule the H100's timings give (tools/time_t_and_b.py --only tplans
    # talt at the paths' 48 shapes; every pick within 10 % of the fastest
    # there, tests/test_torch_gru_step_cluster.py): at a training batch
    # above H = 256, 16 rows x 64 units, whose 16 clusters of 8 outnumber
    # the card's 15, so T takes its two-launch route (``split``: 128 CTAs in
    # one wave), 10-20 % faster than the best cluster plan and half the time
    # of its own clusters' two waves (T xp: 32 x 64); else bf16 16 x 64, and
    # float32 32 x 32 at a training batch, 16 x 32 at one song's or less
    if B >= 128 and H > 256:
        order = ((32, 64), (16, 64), (16, 32)) if xp else ((16, 64), (16, 32))
    elif elem == 2:
        order = ((16, 64), (16, 32))
    elif B >= 128:
        order = ((32, 32), (16, 32))
    else:
        order = ((16, 32), (16, 64))
    for key in order:
        if key in plans:
            p = plans[key]
            # the H100's active clusters were measured at the power-of-two
            # sizes alone: a cluster of 3, 5, 6 or 7 (H = 192, 320, 384,
            # 448) keeps the one launch
            active = MAX_CLUSTERS_H100.get(p.cluster)
            return p._replace(split=not xp and key == (16, 64) and active is not None
                              and p.clusters > active)
    raise LaunchLimitError(f"kernel T has no plan at (B={B}, D={D}, H={H})")


# ---------------------------------------------------------------------------
# Kernel B (csrc/gru_decode.cu): a serving decode head on thread-block
# clusters (csrc/gru_decode_chain.cuh), 512-thread CTAs: a cluster of C
# owns ``rows`` batch rows for every step, each CTA H / C units of each
# layer. Shared memory: the ring of ``stages`` chunks of ``chunk`` (32 to 128)
# depth rows x 3 H / C columns, x (D padded to a chunk), the logits, the h tiles
# and r * h (rows rounded to 8), every CTA's partial logits (C x rows x D
# padded to 4), Wo's rows of its units and the splits' partials. Its plan
# (``gru_decode_plan``) is timed on the H100 at every serving head
# (``tools/time_t_and_b.py``); the first, per-block design ("B") stays the route
# of shapes the chain's plan refuses (``gru_decode_route``).
# ---------------------------------------------------------------------------

DEC_CHUNKS = (128, 64, 32)  # a chunk's depth rows, the largest that fits first
DEC_MAX_SPLITS = 16  # kDecMaxSplits
DEC_MAX_STAGES = 8   # kDecMaxStages
DEC_SMEM = SMEM_PER_BLOCK - 1024  # kDecSmem: 1 KB left for the ring's mbarriers
REGISTERS.update({"B_chain": 128})


class GruDecodePlan(NamedTuple):
    """How B's chain runs: ``cluster`` CTAs a cluster, ``rows`` batch rows a
    cluster, ``clusters``, ``splits`` threads sharing a tile's depth,
    ``stages`` chunks in the ring, ``smem`` bytes of dynamic shared memory a
    CTA, ``chunk`` depth rows a chunk."""

    cluster: int
    rows: int
    clusters: int
    splits: int
    stages: int
    smem: int
    chunk: int = 32


def gru_decode_smem(n_layers: int, D: int, H: int, C: int, rows: int, splits: int,
                    stages: int, chunk: int = 32) -> int:
    """``gru_decode_chain_smem`` of csrc/gru_decode_chain.cuh, in bytes."""
    Hc, R8, Dq = H // C, _round8(rows), -(-D // 4) * 4
    Dp = -(-D // chunk) * chunk
    return 4 * (stages * chunk * 3 * Hc + Dp * R8 + Dq * R8 + (n_layers + 1) * H * R8
                + C * R8 * Dq + Hc * Dq + (splits - 1) * Hc * (R8 // 8) * TILE_STRIDE)


def _dec_cluster_ok(H: int, C: int) -> bool:
    return H >= 32 and H % DEC_CHUNKS[-1] == 0 and H % C == 0 and (H // C) % 4 == 0


def gru_decode_fit(n_layers: int, D: int, H: int, C: int, rows: int, chunk: int = 32):
    """(splits, stages) of the chain at C CTAs a cluster, ``rows`` rows a
    cluster and chunks of ``chunk`` depth rows: the most splits (a power of
    two up to DEC_MAX_SPLITS, within the CTA's threads) and then the most
    stages (2 to DEC_MAX_STAGES) that fit its shared memory; None where none
    fits."""
    if not _dec_cluster_ok(H, C) or H % chunk:
        return None
    tiles = H // C * _round8(rows) // 8

    def fits(splits, stages):
        return gru_decode_smem(n_layers, D, H, C, rows, splits, stages, chunk) <= DEC_SMEM

    if tiles > CHAIN_THREADS or not fits(1, 2):
        return None
    splits = 1
    while 2 * splits <= DEC_MAX_SPLITS and tiles * 2 * splits <= CHAIN_THREADS and fits(
            2 * splits, 2):
        splits *= 2
    stages = 2
    while stages < DEC_MAX_STAGES and fits(splits, stages + 1):
        stages += 1
    return splits, stages


@functools.cache
def gru_decode_most_rows(n_layers: int, D: int, H: int, C: int) -> int:
    """The most rows a cluster of C takes (0 where none fits)."""
    rows = CHAIN_THREADS // (H // C) * 8 if _dec_cluster_ok(H, C) else 0
    while rows > 0 and gru_decode_fit(n_layers, D, H, C, rows) is None:
        rows -= 1
    return rows


# The serving heads' plans the H100 ran fastest, (cluster, rows, chunk) by
# (H, D, n_layers, T, B): notes, velocity, instrument and held at H 256 and
# 512 and B 256, 16 (one song) and 5, every (cluster, rows, chunk) timed in
# one call (tools/time_t_and_b.py --only bplans; PERF.md, Findings); no
# rule of cluster size and rows was within 10 % of the fastest at more than
# 17 of the 24. Other shapes take the rule below.
DEC_MEASURED = {
    (256, 1, 1, 64, 5): (8, 4, 128), (256, 1, 1, 64, 16): (8, 8, 128),
    (256, 1, 1, 64, 256): (16, 37, 128), (256, 2, 1, 64, 5): (8, 4, 128),
    (256, 2, 1, 64, 16): (16, 4, 128), (256, 2, 1, 64, 256): (8, 18, 128),
    (256, 16, 1, 4, 5): (8, 4, 128), (256, 16, 1, 4, 16): (8, 4, 128),
    (256, 16, 1, 4, 256): (8, 32, 128), (256, 61, 2, 64, 5): (16, 1, 128),
    (256, 61, 2, 64, 16): (8, 2, 128), (256, 61, 2, 64, 256): (8, 18, 64),
    (512, 1, 1, 64, 5): (16, 4, 128), (512, 1, 1, 64, 16): (16, 8, 128),
    (512, 1, 1, 64, 256): (8, 18, 64), (512, 2, 1, 64, 5): (16, 5, 128),
    (512, 2, 1, 64, 16): (16, 3, 128), (512, 2, 1, 64, 256): (8, 18, 32),
    (512, 16, 1, 4, 5): (16, 4, 64), (512, 16, 1, 4, 16): (16, 3, 128),
    (512, 16, 1, 4, 256): (4, 9, 32), (512, 61, 2, 64, 5): (16, 4, 128),
    (512, 61, 2, 64, 16): (16, 4, 128), (512, 61, 2, 64, 256): (8, 8, 64),
}


def gru_decode_cluster(B: int, T: int) -> int:
    """The chain's cluster size for a head of T steps at batch B: the rule
    the H100's timings give (tools/time_t_and_b.py --only bplans on every
    serving head at H 256 and 512 and B 256, 16, 5: every pick within 10 %
    of the fastest, tests/test_torch_gru_decode_chain.py). A training-size
    batch takes clusters of 8 (4 for a head of a few steps, which the
    launch's start dominates), one song or less clusters of 16 (8 for a few
    steps of a few rows)."""
    if B >= 128:
        return 4 if T <= 8 else 8
    return 16 if T > 8 or B > 8 else 8


def gru_decode_plan(H: int, D: int, n_layers: int, B: int, cluster: int | None = None,
                    rows: int | None = None, max_clusters: int | None = None,
                    T: int = 64, chunk: int | None = None) -> GruDecodePlan:
    """B's chain plan for a head of width D, ``n_layers`` and T steps at
    (H, B): ``cluster`` CTAs a cluster, ``rows`` rows a cluster and
    ``chunk`` depth rows a chunk, by default ``DEC_MEASURED``'s at the
    shapes it has, else ``gru_decode_cluster``'s size, ceil(B / the card's
    active clusters at that size, ``max_clusters`` or the H100's) rows (as
    many as fit) and the deepest chunk that fits them; raises
    LaunchLimitError where the chain does not launch."""
    if n_layers not in (1, 2):
        raise LaunchLimitError(f"kernel B's chain decodes 1- or 2-layer heads, got {n_layers}")
    measured = DEC_MEASURED.get((H, D, n_layers, T, B))
    if measured and cluster is None and rows is None and chunk is None:
        cluster, rows, chunk = measured
    if cluster is None:
        # the rule's size, else the first of the others whose slices fit
        first = gru_decode_cluster(B, T)
        cluster = next((c for c in (first, 8, 16, 4)
                        if gru_decode_most_rows(n_layers, D, H, c) >= 1), first)
    most = gru_decode_most_rows(n_layers, D, H, cluster)
    if most < 1:
        raise LaunchLimitError(
            f"kernel B's chain takes H a multiple of 32 whose slices fit a cluster of "
            f"{cluster} CTAs, got H={H}, D={D}, {n_layers} layers")
    if rows is None:
        M = max_clusters or MAX_CLUSTERS_H100[cluster]
        rows = -(-B // M)
    rows = max(1, min(rows, most, B))
    # the deepest chunk that fits beside the rows (a chunk costs about the
    # same whatever its depth: tools/time_t_and_b.py; PERF.md, Findings)
    if chunk is None or gru_decode_fit(n_layers, D, H, cluster, rows, chunk) is None:
        chunk = next(c for c in DEC_CHUNKS if gru_decode_fit(n_layers, D, H, cluster, rows, c))
    splits, stages = gru_decode_fit(n_layers, D, H, cluster, rows, chunk)
    return GruDecodePlan(cluster, rows, -(-B // rows), splits, stages,
                         gru_decode_smem(n_layers, D, H, cluster, rows, splits, stages, chunk),
                         chunk)


@functools.cache
def gru_decode_route(H: int, D: int, n_layers: int) -> str:
    """The route of kernel B at width H for a head of width D and
    ``n_layers``: "chain" where the chain's plan launches, else "block"
    where the per-block build does; raises LaunchLimitError where neither
    does."""
    try:
        gru_decode_plan(H, D, n_layers, 1)
        return "chain"
    except LaunchLimitError as e:
        chain_why = str(e)
    block_why = launch_limit("B", H, smem_bytes("B", H, D, n_layers))
    if block_why is None:
        return "block"
    raise LaunchLimitError(f"kernel B launches at H={H} neither on its chain ({chain_why}) "
                           f"nor per block ({block_why})")


def _route_limits(route: str, H: int, layers, heads, cell_type: str = "GRU") -> list[str]:
    """The limits the route's float32 builds hit: ``layers`` is (D_in, dx
    wanted) per encoder layer, ``heads`` (D, n_layers) per decode head."""
    whys = []
    if cell_type == "LSTM":
        if route == "narrow":
            whys = [l_limit(H, d) for d, _dx in layers]
            checks = [("N", 0)] if layers else []
        else:
            checks = [("Q", 0), ("R", 0)] if layers else []
        # S per cell
        whys += [step_limit("S", H)] if heads else []
    else:
        if route == "narrow":
            whys = [a_limit(H, d) for d, _dx in layers]
            whys += [gru_bptt_limit("C", H)] if layers else []
            checks = []
        elif layers:  # the x-projection is outside: one tile for every layer
            checks = [(k, smem_bytes(k, H)) for k in ("F", "G")]
        else:
            checks = []
        d_k = "D" if route == "narrow" else "D_wide"
        checks += [(d_k, smem_bytes(d_k, H, d, n)) for d, n in heads]
        whys += [gru_bptt_limit("E", H, d, n) for d, n in heads]
    whys += [launch_limit(k, H, smem) for k, smem in checks]
    return [why for why in whys if why is not None]


def train_route(H: int, layers, heads, on_card: bool = True, cell_type: str = "GRU") -> str:
    """``"narrow"`` or ``"wide"`` for a training step at width H (see the
    module note): the preferred route (GRU: narrow; LSTM: narrow up to
    ``LSTM_NARROW_MAX_H``, wide above), else the other where the preferred
    one's builds do not launch. Off the card both routes run the same plain
    versions, so a width no build launches takes the preferred route there;
    on the card it raises LaunchLimitError. This is float32's chooser: a
    bf16 model's parts are dispatched one by one (``config_route``)."""
    if FORCE_ROUTE is not None:
        return FORCE_ROUTE
    order = _route_order(H, cell_type)
    first = _route_limits(order[0], H, layers, heads, cell_type)
    if not first:
        return order[0]
    second = _route_limits(order[1], H, layers, heads, cell_type)
    if not second:
        return order[1]
    if not on_card:
        return order[0]
    raise LaunchLimitError(f"no kernel build runs a training step at H={H}: {first[0]}; "
                           f"{second[0]}")


def config_shapes(cfg) -> tuple[list, list]:
    """(layers, heads) of ``cfg``'s training step for ``train_route``: every
    encoder layer's input width (the notes stack, its meta branches) with
    whether its dx is wanted, every decode head's (D, layers)."""
    H = cfg.lstm_size
    notes_in = cfg.embedding_dim if cfg.use_embedding else cfg.input_dim
    layers = []
    for i in range(cfg.num_layers_encoder):
        d = notes_in if i == 0 else (2 * H if cfg.bidirectional else H)
        layers.append((d, i > 0 or cfg.use_embedding))
    for flag, d in ((cfg.meta_instrument, cfg.meta_instrument_dim), (cfg.meta_velocity, 1),
                    (cfg.meta_held_notes, 2)):
        if flag:
            layers.append((d, False))
    heads = [(cfg.output_dim, cfg.num_layers_decoder)]
    for flag, d, n in ((cfg.meta_instrument, cfg.meta_instrument_dim, 1),
                       (cfg.meta_velocity, 1, 1), (cfg.meta_held_notes, 2, 1),
                       (cfg.meta_next_notes, cfg.output_dim, cfg.num_layers_decoder)):
        if flag:
            heads.append((d, n))
    return layers, heads


def _route_order(H: int, cell_type: str) -> tuple[str, str]:
    """The preferred route first (GRU: narrow; LSTM: narrow up to
    ``LSTM_NARROW_MAX_H``, wide above)."""
    if cell_type == "LSTM" and H > LSTM_NARROW_MAX_H:
        return ("wide", "narrow")
    return ("narrow", "wide")


def config_route(cfg, on_card: bool = True) -> str:
    """``train_route`` of a float32 model config. In bf16 the step's parts
    take the rows ``bf16_layer_mode`` and ``bf16_head_mode`` give at the
    batch each is called with; here every part whose training kernels the
    config runs (the encoder layers with ``fused_train_encoder``, the GRU's
    1- and 2-layer heads with ``fused_train_decoder``, tanh cells) is
    dispatched at ``cfg.batch_size``, so that on the card a part without a
    build that launches raises NotImplementedError before the step; the
    label is the route whose builds every such part takes (the preferred one
    when there are none), else "per-part". ``FORCE_ROUTE`` is returned as it
    is, as ``train_route`` returns it."""
    if cfg.compute_dtype != "bfloat16" or FORCE_ROUTE is not None:
        return train_route(cfg.lstm_size, *config_shapes(cfg), on_card=on_card,
                           cell_type=cfg.cell_type)
    layers, heads = config_shapes(cfg)
    B, H, tanh = cfg.batch_size, cfg.lstm_size, cfg.lstm_activation == "tanh"
    modes = set()
    if cfg.fused_train_encoder and tanh:
        modes |= {"narrow" if bf16_layer_mode(cfg.cell_type, B, d, H, on_card, dx) == "x"
                  else "wide" for d, dx in layers}
    if cfg.cell_type == "GRU" and cfg.fused_train_decoder and tanh:
        modes |= {"wide" if head_builds(bf16_head_mode(B, d, H, n, on_card), d, H, n)[0]
                  .startswith("D_wide") else "narrow" for d, n in heads if n in (1, 2)}
    if len(modes) > 1:
        return "per-part"
    return modes.pop() if modes else _route_order(H, cfg.cell_type)[0]


# ---------------------------------------------------------------------------
# The JAX package's per-part dispatch in a bf16 model: its VMEM predicates
# (midi_vae_tpu/ops/fused_train.py, fused_decoder.py, fused_gru.py), copied;
# ``s`` is the operands' itemsize (2 in bf16, 4 for the heads promoted to
# float32)
# ---------------------------------------------------------------------------

_VMEM_LIMIT_BYTES = 12 * 1024 * 1024  # fused_gru.py:34
_WIDE_BUDGET_BYTES = 15_500_000  # fused_train.py:1610
_TEMPS_FWD = {4: 12, 2: 24}  # fused_train.py:1621-1622
_TEMPS_BWD = {4: 34, 2: 109}


def encoder_vmem_ok(B: int, H: int, s: int = 4) -> bool:
    """``fused_decoder.py::_encoder_vmem_ok`` (:320)."""
    return (H * 3 * H + 3 * B * H + B * 3 * H) * s + 4 * B * 3 * H * 4 < 15_500_000


def x_train_vmem_ok(B: int, D: int, H: int, s: int = 4) -> bool:
    """``_x_train_vmem_ok`` (:2255): the GRU's in-kernel projection, rows 1
    and 4."""
    operand = D * 3 * H + H * 3 * H + 3 * H + 2 * (2 * B * D + 2 * B * H)
    f32 = 2 * (D * 3 * H + H * 3 * H + 3 * H) + 8 * B * H + 2 * B * 3 * H
    return operand * s + f32 * 4 < 15_500_000


def train_vmem_ok(B: int, H: int, s: int = 4) -> bool:
    """``_train_vmem_ok`` (:220): the GRU's in-place pair, rows 9 and 10."""
    operand = H * 3 * H + 2 * B * 3 * H + 2 * B * H
    f32 = H * 3 * H + B * H + 8 * B * H
    return operand * s + f32 * 4 < 13_000_000 and encoder_vmem_ok(B, H, s)


def lstm_x_train_vmem_ok(B: int, D: int, H: int, s: int = 4) -> bool:
    """``_lstm_x_train_vmem_ok`` (:2532-2542): rows 19 and 20."""
    operand = D * 4 * H + H * 4 * H + 4 * H + 2 * (2 * B * D + 4 * B * H)
    f32 = 2 * (D * 4 * H + H * 4 * H + 4 * H) + 10 * B * H + 2 * B * 4 * H
    return operand * s + f32 * 4 < 15_500_000


def lstm_train_vmem_ok(B: int, H: int, s: int = 4) -> bool:
    """``_lstm_train_vmem_ok`` (:1495-1502): rows 15 and 16."""
    operand = H * 4 * H + 2 * (2 * B * 4 * H + 4 * B * H)
    f32 = H * 4 * H + 2 * B * H + 8 * B * H
    return operand * s + f32 * 4 < _VMEM_LIMIT_BYTES


def mh_vmem_ok(B: int, Dp: int, dks, H: int) -> bool:
    """``_mh_vmem_ok`` (:3454): the multi-head decode (rows 5 and 6) of a
    2-layer primary head of width Dp and 1-layer side heads of widths
    ``dks``, always in float32."""
    def head_w(d):
        return d * 3 * H + H * 3 * H + 3 * H + H * d + d
    weights = head_w(Dp) + H * 3 * H + 3 * H  # the primary head has 2 cells
    streams = 8 * B * Dp + 8 * B * H
    carries = 2 * B * H + B * Dp
    for d in dks:
        weights += head_w(d)
        streams += 8 * B * max(d, 128) + 4 * B * H  # lane padding for narrow heads
        carries += B * H + B * max(d, 128)
    temps = 4 * B * 3 * H + 2 * B * H
    return (2 * weights + streams + temps + carries) * 4 < 19_000_000


def dec_train_vmem_ok(B: int, D: int, H: int, n_layers: int) -> bool:
    """``_dec_train_vmem_ok`` (:748): a decode head's rows 7 and 8."""
    weights = D * 3 * H + (n_layers - 1) * H * 3 * H + n_layers * H * 3 * H + H * D
    grads = weights + (n_layers * 3 * H + D)
    streams = 2 * (4 * B * D + 2 * n_layers * B * H)
    temps = 4 * B * 3 * H + 2 * B * H
    carries = n_layers * B * H + B * D
    return (weights + grads + streams + temps + carries) * 4 < 15_500_000


def _btile(B: int, fits) -> int:
    """``_btile`` (:1625): the largest power-of-two-descending divisor tile of
    B that ``fits``; 0 if none of 8 rows or more does."""
    bt = B
    while bt >= 8:
        if B % bt == 0 and fits(bt):
            return bt
        bt //= 2
    return 0


def _tiles(B: int, fwd_bytes, bwd_bytes) -> tuple[int, int]:
    fwd = _btile(B, lambda bt: fwd_bytes(bt) < _WIDE_BUDGET_BYTES)
    bwd = _btile(B, lambda bt: bwd_bytes(bt) < _WIDE_BUDGET_BYTES)
    return (fwd, bwd) if fwd and bwd else (0, 0)


def gru_wide_btiles(B: int, H: int, s: int) -> tuple[int, int]:
    """``_gru_wide_btiles`` (:1659): rows 11 and 12's batch tiles, or (0, 0)."""
    return _tiles(
        B,
        lambda bt: (H * 3 * H * s + (2 * bt * 3 * H + 2 * bt * H) * s + 2 * bt * H * s
                    + _TEMPS_FWD[min(s, 4)] * bt * H),
        lambda bt: (H * 3 * H * s + (4 * bt * 3 * H + 4 * bt * H) * s + 3 * bt * H * s
                    + 4 * bt * H + _TEMPS_BWD[min(s, 4)] * bt * H))


def lstm_wide_btiles(B: int, H: int, s: int) -> tuple[int, int]:
    """``_lstm_wide_btiles`` (:1863-1870): rows 17 and 18's batch tiles."""
    return _tiles(
        B,
        lambda bt: (H * 4 * H * s + (2 * bt * 4 * H + 4 * bt * H) * s + 4 * bt * H * s
                    + _TEMPS_FWD[min(s, 4)] * bt * H * 4 // 3),
        lambda bt: (H * 4 * H * s + (4 * bt * 4 * H + 8 * bt * H) * s + 5 * bt * H * s
                    + 8 * bt * H + _TEMPS_BWD[min(s, 4)] * bt * H * 4 // 3))


def dec_wide_btiles(B: int, D: int, H: int, n: int, s: int) -> tuple[int, int]:
    """``_dec_wide_btiles`` (:952): rows 13 and 14's batch tiles."""
    Dp = (D + 127) // 128 * 128  # _dpad: Mosaic pads to 128 lanes
    weights = (D * 3 * H + (2 * n - 1) * H * 3 * H + H * Dp + n * 3 * H + Dp) * s
    return _tiles(
        B,
        lambda bt: (weights + 2 * bt * (2 * Dp + n * H) * s + (n * bt * H + bt * Dp) * s
                    + _TEMPS_FWD[min(s, 4)] * bt * (n * H + Dp)),
        lambda bt: (weights + 2 * bt * (5 * Dp + 5 * n * H) * s + (2 * Dp + 2 * n * H) * bt * s
                    + (n * H + Dp) * bt * 4 + _TEMPS_BWD[min(s, 4)] * bt * (n * H + Dp)))


# which gate grads W sums dU from over a precomputed x-projection
# (``gru_layer_train``'s and ``lstm_layer_train``'s ``mode``): the in-place
# rows (10, 16) sum the unrounded float32 gate grads inside their kernel, the
# wide rows' pass 2 (12, 18) the stream as stored in the compute dtype; the
# same numbers in float32
XP_MODES = ("inplace", "wide")

# the rows each mode of a bf16 part runs on the TPU (PERF.md's kernel table)
LAYER_ROWS = {"GRU": {"x": "rows 1 and 4", "inplace": "rows 9 and 10",
                      "wide": "rows 11 and 12", "scan": "the XLA scan"},
              "LSTM": {"x": "rows 19 and 20", "inplace": "rows 15 and 16",
                       "wide": "rows 17 and 18", "scan": "the XLA scan"}}
HEAD_ROWS = {"inplace": "rows 7 and 8", "wide": "rows 13 and 14", "scan": "the XLA scan"}


def bf16_layer_mode(cell_type: str, B: int, D: int, H: int, on_card: bool = False,
                    dx: bool = True) -> str:
    """The rows the JAX package runs a bf16 encoder layer of batch B, input
    width D and width H through (``_x_use_pallas`` / ``_lstm_x_use_pallas``,
    then ``_gru_mode`` / ``_lstm_mode``): "x", "inplace", "wide" or "scan"
    (see the module note). ``FORCE_ROUTE`` "narrow" gives "x", "wide" skips
    the in-kernel projection (as a test hook of the JAX package's
    ``_x_use_pallas``). ``on_card``: raise NotImplementedError where the
    port has no build of those rows that launches (``dx``: the layer's dx is
    wanted)."""
    lstm = cell_type == "LSTM"
    if FORCE_ROUTE == "narrow" or (FORCE_ROUTE is None and (
            lstm_x_train_vmem_ok if lstm else x_train_vmem_ok)(B, D, H, 2)):
        mode = "x"
    elif (lstm_train_vmem_ok if lstm else train_vmem_ok)(B, H, 2):
        mode = "inplace"
    elif (lstm_wide_btiles if lstm else gru_wide_btiles)(B, H, 2)[0]:
        mode = "wide"
    else:
        mode = "scan"
    if on_card:
        if mode == "x":
            why = (l_limit if lstm else a_limit)(H, D, True)
            if why is not None:
                raise NotImplementedError(f"the JAX package runs this bf16 part through "
                                          f"{LAYER_ROWS[cell_type][mode]}; their port build "
                                          f"does not launch: {why}")
            builds = [("N_bf16", 0)] if lstm else [("C_bf16", 0)]
        else:
            builds = ([("Q_bf16", 0), ("R_bf16", 0)] if lstm else
                      [(k, smem_bytes(k, H)) for k in ("X", "G_bf16")])
            builds = builds if mode != "scan" else []
        _require_bf16(LAYER_ROWS[cell_type][mode], builds, H)
    return mode


def bf16_head_mode(B: int, D: int, H: int, n_layers: int, on_card: bool = False) -> str:
    """The rows the JAX package runs a bf16 GRU decode head of batch B and
    width D through (``_dec_mode``; a head narrower than 8 is promoted to
    float32 first, ``gru_decode_train``): "inplace", "wide" or "scan";
    ``FORCE_ROUTE`` "narrow" gives "inplace", "wide" "wide" (as the JAX
    package's ``_FORCE_TRAIN_MODE``). ``on_card``: raise
    NotImplementedError where the port has no build of those rows that
    launches (``head_builds``)."""
    if FORCE_ROUTE is not None:
        mode = "inplace" if FORCE_ROUTE == "narrow" else "wide"
    elif dec_train_vmem_ok(B, D, H, n_layers):
        mode = "inplace"
    elif dec_wide_btiles(B, D, H, n_layers, 4 if D < 8 else 2)[0]:
        mode = "wide"
    else:
        mode = "scan"
    if on_card:
        builds = ([(k, smem_bytes(k, H, D, n_layers)) for k in head_builds(mode, D, H, n_layers)]
                  if mode != "scan" else [])
        _require_bf16(HEAD_ROWS[mode], builds, H, D, n_layers)
    return mode


def head_builds(mode: str, D: int, H: int, n_layers: int) -> tuple[str, str]:
    """The builds of D and E that run a bf16 GRU decode head's rows ``mode``
    ("inplace": rows 7 and 8, "wide": rows 13 and 14) at width H; a head
    narrower than 8 is promoted to float32 and takes float32 builds. Rows 7
    and 8 take the 8-row builds where they launch, else the 2-row ones: D's
    wide build (``_dec_fwd1/2_kernel`` is the forward of rows 7 and 13
    alike) and E's with row 8's rounding (``E_wide_row8_bf16``; in float32
    the wide E, whose streams are not rounded either). E's builds other
    than the wide bf16 one run one chain with one launch limit, so D's
    builds decide."""
    sfx = "_bf16" if D >= 8 else ""
    if mode == "wide":
        return "D_wide" + sfx, "E_wide" + sfx
    if (_part_limit("D" + sfx, H, D, n_layers) is not None
            and _part_limit("D_wide" + sfx, H, D, n_layers) is None):
        return "D_wide" + sfx, "E_wide_row8_bf16" if sfx else "E_wide"
    return "D" + sfx, "E" + sfx


def _part_limit(build: str, H: int, D: int, n_layers: int) -> str | None:
    """``launch_limit`` of a decode head's build: D's from its tile, E's
    from its chain's plan for a head of width D and ``n_layers``."""
    if build in E_BUILDS:
        return gru_bptt_limit(build, H, D, n_layers)
    return launch_limit(build, H, smem_bytes(build, H, D, n_layers))


def _require_bf16(rows: str, builds, H: int, D: int = 61, n_layers: int = 2) -> None:
    """Raise NotImplementedError when the port has no build of the TPU's
    ``rows`` (``builds``: (build, shared memory) pairs) that launches at
    width H on the card (E's builds for a head of width D and
    ``n_layers``)."""
    if not builds:
        raise NotImplementedError(f"the JAX package runs this bf16 part through {rows}, which "
                                  "the port has no kernel build for")
    for k, smem in builds:
        why = gru_bptt_limit(k, H, D, n_layers) if k in E_BUILDS else launch_limit(k, H, smem)
        if why is not None:
            raise NotImplementedError(f"the JAX package runs this bf16 part through {rows}; "
                                      f"their port build does not launch: {why}")
