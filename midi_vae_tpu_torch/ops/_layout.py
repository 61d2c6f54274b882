"""Which kernel builds a layer or decode head takes, from the card's limits.

Every kernel of the port (GRU: A to G, T, T xp, X, and the encoder stacks'
U and V; LSTM: L, M, N, Q, R, S, S xp, Y) runs one
thread per hidden column (blockDim.x = H) and keeps a tile of batch rows per
block, so whether a build launches at a width is a matter of two limits of
the H100 (sm_90a):
- registers: the block's threads times their registers must fit the SM's
  65,536 (registers are allocated in steps of 8 per thread);
- shared memory: the block's tile must fit the 227 KB (232,448 bytes) a block
  may have.

Kernels A to E, L, M, N, U and V are built without launch bounds; their register
counts (``REGISTERS``, from ``nvcc -Xptxas -v`` on the card; ``chip_smoke.py``
checks them against the build) decide how wide they go. F, G, Q, R, the
per-step cells (S, S xp, T, T xp), the bf16 whole-scan encoders (X, Y) and
the wide decode builds are compiled under ``__launch_bounds__(WIDE_THREADS)``,
so the compiler guarantees that up to 512 threads launch (``chip_smoke.py``
checks their registers from ptxas against it).

The training step takes one route for all its layers and heads:
- ``"narrow"``, the GRU(256) path: A + C per encoder layer (the x-projection
  inside the kernels), D + E over 8 rows per block with the notes head's
  T-length side heads in one launch;
- ``"wide"``, taken where a narrow build does not launch (from H = 512 on: D
  and E at 160 and 168 registers a thread): xp = x @ W + b as one
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
In a bfloat16 model (``compute_dtype``) each route takes its bf16 builds
(their tiles stay float, as every bf16 build's), and the route is decided
from those: on the narrow route A, C, D and E (``A_bf16`` ... ``E_bf16``,
their own register counts, D's 144 a thread keep it under 512 threads); on
the wide route X for the layer's forward (kernel X computes what F would in
bf16: the JAX package's ``_fwd_kernel`` in bf16 is its ``_encoder_kernel``
with the sequence emitted), ``G_bf16`` for its backward and the wide D and
E's bf16 builds (``D_wide_bf16``, ``E_wide_bf16``), all launch-bounded. On
both routes a head narrower than 8 is promoted to float32 and takes D's and
E's float32 builds.
A width at which neither route launches raises ``LaunchLimitError`` naming the
limit. ``FORCE_ROUTE`` is a test hook (like the JAX package's
``_FORCE_TRAIN_MODE``) that sends small widths down the wide route.
"""

from __future__ import annotations

REGS_PER_SM = 65_536
SMEM_PER_BLOCK = 232_448
ROWS = 8          # kRows: batch rows per block of A to G
WIDE_ROWS = 2     # kWideRows: the wide builds of D and E
WIDE_THREADS = 512  # kWideThreads: the launch bound of F, G and the wide D, E

# registers per thread of the builds without launch bounds (the largest over
# a build's template instances), from nvcc -Xptxas -v for sm_90a
REGISTERS = {"A": 90, "B": 94, "C": 86, "D": 160, "E": 168, "L": 88, "M": 75, "N": 117,
             "U": 78, "V": 172, "A_bf16": 94, "C_bf16": 96, "D_bf16": 144, "E_bf16": 167}
# the builds compiled under __launch_bounds__(WIDE_THREADS)
BOUNDED = ("F", "G", "D_wide", "E_wide", "Q", "R", "S", "S_xp", "T", "T_xp", "X", "Y",
           "G_bf16", "D_wide_bf16", "E_wide_bf16")
# the widest LSTM whose encoder takes the narrow route (L + N; see above)
LSTM_NARROW_MAX_H = 256

FORCE_ROUTE: str | None = None  # test hook: None | "narrow" | "wide"


class LaunchLimitError(ValueError):
    """A kernel build cannot launch at the asked shape on the card."""


def smem_bytes(kernel: str, H: int, D: int = 0, n_layers: int = 1,
               dx: bool = False) -> int:
    """Dynamic shared memory of one block of ``kernel``: D is the layer's
    input width (A, C, L, N; U and V: of the stack, ``n_layers`` = 2, or of
    a branch, ``n_layers`` = 1), the head's output width (B, D, E, M) or the
    cell's input width (S, T). The bf16 builds (X, Y, those of A to E, G,
    the wide D and E, S and T, and U's and V's) hold their tiles in float
    too: a bf16 value is widened as it is loaded."""
    kernel = kernel.removesuffix("_bf16")
    rows = WIDE_ROWS if kernel.endswith("_wide") else ROWS
    floats = {
        "A": D + 2 * H,
        "B": 2 * D + (n_layers + 1) * H,
        "C": D + 5 * H + (D if dx else 0),
        "D": 2 * D + (n_layers + 1) * H,
        "E": 3 * D + 8 * H,
        "F": 2 * H,
        "G": 5 * H,
        "L": D + 3 * H,  # x, h twice (h_{t-1} and h_t), c
        "M": 2 * D + (n_layers + 1) * H + n_layers * H,  # probs, logits, h tiles, c tiles
        "N": D + 5 * H,  # x, h_{t-1}, the gate grads (4H)
        "Q": 3 * H,  # h twice, c
        "R": 5 * H,  # h_{t-1}, the gate grads (4H)
        "S": D + 3 * H,  # as L
        "S_xp": 3 * H,  # as Q
        "T": D + 2 * H,  # x, h, r * h
        "T_xp": 2 * H,  # h, r * h
        "X": 2 * H,  # as F
        "Y": 3 * H,  # as Q
        # the stack: x, h1, h2, r * h; a branch: as A
        "U": D + (n_layers + 1) * H,
        # the stack: x, h1_t, h1_{t-1}, h2_{t-1}, r * h, the gate grads (3H),
        # layer 2's dx (H); a branch: as C
        "V": D + (3 * n_layers + 2) * H + (D if dx else 0),
    }[kernel.removesuffix("_wide")]
    return 4 * rows * floats


def launch_limit(kernel: str, H: int, smem: int) -> str | None:
    """Why a block of H threads of ``kernel`` with ``smem`` bytes of shared
    memory cannot launch on the card, or None when it can."""
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


def _route_limits(route: str, H: int, layers, heads, cell_type: str = "GRU",
                  bf16: bool = False) -> list[str]:
    """The limits the route's builds hit: ``layers`` is (D_in, dx wanted) per
    encoder layer, ``heads`` (D, n_layers) per decode head; ``bf16``: the
    GRU route's bf16 builds (a head narrower than 8 is promoted to float32
    and takes D's and E's float32 builds)."""
    if cell_type == "LSTM":
        if route == "narrow":
            checks = [(k, smem_bytes(k, H, d)) for d, _dx in layers for k in ("L", "N")]
        else:
            checks = [(k, smem_bytes(k, H)) for k in ("Q", "R")] if layers else []
        # S per cell: the head's input for its first layer, h for the others
        checks += [("S", smem_bytes("S", H, max(d, H) if n > 1 else d)) for d, n in heads]
    else:
        sfx = "_bf16" if bf16 else ""
        if route == "narrow":
            checks = [(k + sfx, smem_bytes(k, H, d, dx=dx)) for d, dx in layers
                      for k in ("A", "C")]
        elif layers:  # the x-projection is outside: one tile for every layer
            checks = [(k, smem_bytes(k, H)) for k in (("X", "G_bf16") if bf16 else ("F", "G"))]
        else:
            checks = []
        heads_k = ("D", "E") if route == "narrow" else ("D_wide", "E_wide")
        checks += [(k + (sfx if d >= 8 else ""), smem_bytes(k, H, d, n)) for d, n in heads
                   for k in heads_k]
    return [why for k, smem in checks if (why := launch_limit(k, H, smem)) is not None]


def train_route(H: int, layers, heads, on_card: bool = True, cell_type: str = "GRU",
                bf16: bool = False) -> str:
    """``"narrow"`` or ``"wide"`` for a training step at width H (see the
    module note): the preferred route (GRU: narrow; LSTM: narrow up to
    ``LSTM_NARROW_MAX_H``, wide above), else the other where the preferred
    one's builds do not launch. Off the card both routes run the same plain
    versions, so a width no build launches takes the preferred route there;
    on the card it raises LaunchLimitError."""
    if FORCE_ROUTE is not None:
        return FORCE_ROUTE
    order = ("narrow", "wide")
    if cell_type == "LSTM" and H > LSTM_NARROW_MAX_H:
        order = ("wide", "narrow")
    first = _route_limits(order[0], H, layers, heads, cell_type, bf16)
    if not first:
        return order[0]
    second = _route_limits(order[1], H, layers, heads, cell_type, bf16)
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


def config_route(cfg, on_card: bool = True) -> str:
    """``train_route`` of a model config."""
    return train_route(cfg.lstm_size, *config_shapes(cfg), on_card=on_card,
                       cell_type=cfg.cell_type, bf16=cfg.compute_dtype == "bfloat16")
