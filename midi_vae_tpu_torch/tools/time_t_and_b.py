"""Time kernel T (csrc/gru_step.cu: T, T bf16, T xp) at each of its plans
and as a training step launches it, and kernel B (csrc/gru_decode.cu, its
decode chain on clusters) at each of its plans on every serving head.

Run from the repo root on a CUDA card:
    python -m midi_vae_tpu_torch.tools.time_t_and_b [--out FILE] [--only SECTION ...]
        [--H H ...] [--B B ...]

``--H`` and ``--B`` keep bplans' cases at those widths and batches
(``--H 1024 --only bplans``: GRU(1024)'s serving heads).

To compare two checkouts in one call, run the file from one with the
other's root on PYTHONPATH (``--only loops heads`` use the public wrappers
alone, which older checkouts have too):
    PYTHONPATH=OLD python NEW/midi_vae_tpu_torch/tools/time_t_and_b.py --only loops heads

1. tplans: T at every plan of ``_layout.gru_step_plans`` on T_CASES, the
   paths' shapes (B 256, 16, 5; the heads' cells: x the fed-back output, D
   61, 1 or 16, or the first cell's h, D = H; T xp over xp; H 256 and 512;
   float32 and bf16), beside the plan ``_layout.gru_step_plan`` picks. Each
   plan's time is the device's: LAUNCHES launches captured in a CUDA graph,
   the median of REPS replays, the plans once in order and once reversed,
   the two medians averaged; its max |diff| from the plain step.
   ``near_best`` lists the plans within NEAR of the fastest's time;
   tests/test_torch_gru_step_cluster.py holds ``gru_step_plan``'s picks
   against those sets.
2. talt: T's two-launch route (P1 and P2 as two launches, the second
   under programmatic dependent launch) beside the cluster design at the
   route's plan (16 x 64) on T_CASES' T shapes, float32 and bf16 (device
   time a launch, in turns).
3. bplans: B's chain at every plan of ``plans_of`` (cluster sizes 4, 8,
   16; rows a cluster: one wave of the card's active clusters, and 4, 8,
   16, 32, 64 where they fit; each chunk depth that fits: keys
   "cluster x rows / chunk") on B_CASES: every serving head (notes,
   velocity, instrument, held) at H 256 and 512 and B 256, 16, 5, and
   GRU(1024)'s notes, velocity and instrument heads at B 256 and 16
   (``_timing.sweep``): one launch, the median of 5 CUDA-event windows, in
   order then reversed; its max |diff| from ``gru_decode.decode_plan``'s
   pick. ``near_best`` as above; tests/test_torch_gru_decode_chain.py and
   tests/test_torch_gru1024.py hold the picks against those sets.
4. loops: T through the public wrapper as a GRU(256) training step with
   ``fused_train_decoder=False`` makes it (its four head cells: notes 1 and
   2, velocity, instrument: 64 + 64 + 64 + 4 = 196 launches, the state
   carried), float32 and bf16, and T xp over the four encoder layers (196
   launches), each loop in one CUDA-event window (median of REPS), at H 256
   and 512; and per cell the device time a launch (a CUDA graph of the
   cell's launches, replayed) and the wrapper's time on the host (calls
   issued back to back, the host clock over them, divided by their count).
5. heads: B through the public wrapper on the three heads of a transfer
   (notes, velocity, instrument) at B 256, 16, 5 and H 256, 512, one
   CUDA-event window each (median of REPS).
6. bsplits: B's chain at every (splits, stages) that fits, for the
   one-wave rows of clusters of 8 and 16 (notes and velocity heads).
Prints one JSON line per measurement, with the card's name and power limit.
"""

from __future__ import annotations

import functools
import sys
import time

if __package__:
    from midi_vae_tpu_torch.tools import _timing
else:  # run as a file, perhaps beside another checkout's package
    import _timing

REPS, LAUNCHES = 20, 64
NEAR = _timing.NEAR
median_ms = functools.partial(_timing.median_ms, reps=REPS)
in_turns = functools.partial(_timing.in_turns, reps=REPS)
BATCHES = (256, 16, 5)
WIDTHS = (256, 512)
# (B, D, H, dtype), D = 0 for T xp
T_CASES = [(B, D, H, dtype) for B in BATCHES for H in WIDTHS
           for D, dtype in ((61, "float32"), (H, "float32"), (1, "float32"), (16, "float32"),
                            (61, "bfloat16"), (H, "bfloat16"), (16, "bfloat16"),
                            (0, "float32"))]
# (name, D, layers, T, output activation) of the serving heads
HEADS = (("notes", 61, 2, 64, "softmax"), ("velocity", 1, 1, 64, "sigmoid"),
         ("instrument", 16, 1, 4, "softmax"), ("held", 2, 1, 64, "softmax"))
# (H, head, B) of B's plans: every serving head at H 256 and 512, and
# GRU(1024)'s three heads at a transfer batch and one song
B_CASES = ([(H, head, B) for H in WIDTHS for head in HEADS for B in BATCHES]
           + [(1024, head, B) for head in HEADS[:3] for B in (256, 16)])


def _step_operands(B, D, H, dt, seed):
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    h = (0.5 * torch.tanh(randn(B, H))).to(dt)
    u = (randn(H, 3 * H) / H ** 0.5).to(dt)
    if not D:
        return {"xp": randn(B, 3 * H), "h": h, "u": u}
    x = torch.softmax(randn(B, D), -1).to(dt) if D != H else (0.5 * torch.tanh(randn(B, D))).to(dt)
    return {"x": x, "h": h, "w": (randn(D, 3 * H) / D ** 0.5).to(dt),
            "b": (0.1 * randn(3 * H)).to(dt), "u": u}


def time_tplans(emit):
    import torch

    from midi_vae_tpu_torch.ops import _build, _layout
    from midi_vae_tpu_torch.ops import gru_step as gs

    lib, steps, step_xp, _ = gs._kernels()
    for B, D, H, dtype in T_CASES:
        dt = getattr(torch, dtype)
        o = _step_operands(B, D, H, dt, B + D + H)
        h_out = torch.empty_like(o["h"])
        # the current stream's handle at each launch: a graph captures on its own
        stream = lambda: torch._C._cuda_getCurrentRawStream(0)  # noqa: E731
        if D:
            want = gs.gru_cell_step_reference(o["x"], o["h"], o["w"], o["b"], o["u"])

            def launch(plan):
                rc = steps[dt](o["x"].data_ptr(), o["h"].data_ptr(), o["w"].data_ptr(),
                               o["b"].data_ptr(), o["u"].data_ptr(), h_out.data_ptr(), B, D, H,
                               0, plan, stream())
                _build.check(lib, rc, "gru_step launch")
        else:
            want = gs.gru_recurrent_step_reference(o["xp"], o["h"], o["u"])

            def launch(plan):
                rc = step_xp(o["xp"].data_ptr(), o["h"].data_ptr(), o["u"].data_ptr(),
                             h_out.data_ptr(), B, H, 0, plan, stream())
                _build.check(lib, rc, "gru_step_xp launch")

        plans = [p.plan for p in _layout.gru_step_plans(B, D, H, o["h"].element_size(), not D)]
        graphs, err = {}, {}
        for plan in plans:
            launch(plan)
            torch.cuda.synchronize()
            err[plan] = (h_out.float() - want.float()).abs().max().item()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(LAUNCHES):
                    launch(plan)
            graphs[plan] = graph
        ms = in_turns({p: graphs[p].replay for p in plans})
        best = min(ms.values())
        pick = _layout.gru_step_plan(B, D, H, o["h"].element_size(), not D)
        emit({"what": "T plans" if D else "T xp plans", "B": B, "D": D, "H": H, "dtype": dtype,
              "launches": LAUNCHES, "pick": pick.plan,
              "ms": {str(p): ms[p] for p in plans},
              "near_best": [p for p in plans if ms[p] <= (1 + NEAR) * best],
              "max_abs_err": {str(p): err[p] for p in plans}})


def time_talt(emit):
    """T's two-launch route (``mvt_gru_step_split``: P1 and P2 as two
    launches, no clusters, the second under programmatic dependent launch,
    r h and the gates through global memory) beside the one-launch cluster
    design at the same plan, 16 rows x 64 units (the route's), on T_CASES'
    T shapes (float32 and bf16): the device time a launch (CUDA graph
    replay, in turns fused, split, split, fused) and the route's max |diff|
    from the plain step; ``route`` is what ``gru_step_plan`` takes there."""
    import torch

    from midi_vae_tpu_torch.ops import _build, _layout
    from midi_vae_tpu_torch.ops import gru_step as gs

    lib, steps, _, splits = gs._kernels()
    plan = _layout.STEP_T_PLANS.index((16, 64))
    for B, D, H, dtype in T_CASES:
        if not D:
            continue
        dt = getattr(torch, dtype)
        o = _step_operands(B, D, H, dt, B + D + H)
        h_out = torch.empty_like(o["h"])
        scratch = torch.empty(3 * B * H, device="cuda")
        want = gs.gru_cell_step_reference(o["x"], o["h"], o["w"], o["b"], o["u"])
        ptrs = [o[k].data_ptr() for k in ("x", "h", "w", "b", "u")]

        def fused():
            rc = steps[dt](*ptrs, h_out.data_ptr(), B, D, H, 0, plan,
                           torch._C._cuda_getCurrentRawStream(0))
            _build.check(lib, rc, "gru_step launch")

        def two():
            rc = splits[dt](*ptrs, h_out.data_ptr(), scratch.data_ptr(), B, D, H, 0,
                            torch._C._cuda_getCurrentRawStream(0))
            _build.check(lib, rc, "gru_step_split launch")

        two()
        torch.cuda.synchronize()
        err = (h_out.float() - want.float()).abs().max().item()
        us = {"fused": [], "two launches": []}
        for fn in (fused, two, two, fused):
            us["fused" if fn is fused else "two launches"].append(graph_us(fn, LAUNCHES))
        pick = _layout.gru_step_plan(B, D, H, o["h"].element_size())
        emit({"what": "T 16x64, two launches beside one", "B": B, "D": D, "H": H,
              "dtype": dtype, "us_a_launch": {k: sum(v) / len(v) for k, v in us.items()},
              "two_launches_max_abs_err": err,
              "route": "two launches" if pick.split else f"plan {pick.plan}"})


def _head(name, D, n_layers, H, B, seed):
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    cells = [{"w": randn(d, 3 * H) / d ** 0.5, "u": randn(H, 3 * H) / H ** 0.5,
              "b": 0.1 * randn(3 * H)} for d in (D, H)[:n_layers]]
    out = {"w": randn(H, D) / H ** 0.5, "b": 0.1 * randn(D)}
    init = [0.5 * torch.tanh(randn(B, H)) for _ in range(n_layers)]
    return cells, out, init, torch.zeros(B, D, device=dev)


def plans_of(H, D, n_layers, B, T):
    """B's chain plans timed: cluster sizes 4, 8, 16 x rows a cluster (one
    wave of the H100's active clusters at that size, and 4, 8, 16, 32, 64)
    x every chunk depth that fits (``_layout.DEC_CHUNKS``), as
    ``_layout.gru_decode_plan`` fits them (duplicates dropped)."""
    from midi_vae_tpu_torch.ops import _layout

    found = {}
    for C in (4, 8, 16):
        if _layout.gru_decode_most_rows(n_layers, D, H, C) < 1:
            continue
        for rows in (None, 4, 8, 16, 32, 64):
            p = _layout.gru_decode_plan(H, D, n_layers, B, C, rows, T=T)
            for chunk in _layout.DEC_CHUNKS:
                fit = _layout.gru_decode_fit(n_layers, D, H, C, p.rows, chunk)
                if fit:
                    q = p._replace(splits=fit[0], stages=fit[1], chunk=chunk,
                                   smem=_layout.gru_decode_smem(n_layers, D, H, C, p.rows,
                                                                *fit, chunk))
                    found[(q.cluster, q.rows, q.chunk)] = q
    return list(found.values())


def time_bplans(emit, args):
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd

    key = lambda p: f"{p.cluster}x{p.rows}/{p.chunk}"  # noqa: E731
    with torch.no_grad():
        for H, (name, D, n_layers, T, out_act), B in _timing.select(B_CASES, args,
                                                                    B=lambda c: c[2]):
            cells, out, init, start = _head(name, D, n_layers, H, B, H + D + B)
            args_ = (cells, out, init, start, T, "tanh", out_act)
            plan = [None]

            def force(p):
                plan[0] = p
            _timing.sweep(emit, "B plans", plans_of(H, D, n_layers, B, T), force,
                          lambda: gd.gru_decode(*args_, plan=plan[0]), key,
                          gd.decode_plan(H, D, n_layers, B, T), reps=5, head=name, H=H, B=B,
                          D=D, T=T, layers=n_layers)


def time_bsplits(emit):
    """B's chain at every (splits, stages) that fits, for the one-wave rows
    of clusters of 8 and 16, on the notes and velocity heads at H 256 and
    512 and B 256 and 16: what the plan's other two numbers are worth."""
    import torch

    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import gru_decode as gd

    with torch.no_grad():
        for H in WIDTHS:
            for name, D, n_layers, T, out_act in HEADS[:2]:
                for B in (256, 16):
                    cells, out, init, start = _head(name, D, n_layers, H, B, H + D + B)
                    args = (cells, out, init, start, T, "tanh", out_act)
                    for C in (8, 16):
                        base = _layout.gru_decode_plan(H, D, n_layers, B, C, T=T)
                        plans = []
                        for splits in (1, 2, 4, 8, 16):
                            for stages in (2, 4, 8):
                                p = base._replace(splits=splits, stages=stages, smem=_layout.gru_decode_smem(
                                    n_layers, D, H, C, base.rows, splits, stages, base.chunk))
                                tiles = H // C * ((base.rows + 7) // 8)
                                if p.smem <= _layout.DEC_SMEM and tiles * splits <= 512:
                                    plans.append(p)
                        ms = in_turns({p: (lambda p=p: gd.gru_decode(*args, plan=p)) for p in plans},
                                      reps=5)
                        emit({"what": "B splits x stages", "head": name, "H": H, "B": B,
                              "cluster": C, "rows": base.rows, "default": f"{base.splits}x{base.stages}",
                              "ms": {f"{p.splits}x{p.stages}": ms[p] for p in plans}})


# (name, D, T) of a GRU training step's head cells with
# fused_train_decoder=False (x the fed-back output; notes cell 2 the first's
# h), and of the Config() encoder's layers
HEAD_CELLS = (("notes cell 1", 61, 64), ("notes cell 2", None, 64), ("velocity", 1, 64),
              ("instrument", 16, 4))
LAYERS = (("notes_l1", 64), ("notes_l2", 64), ("instrument", 4), ("velocity", 64))


def host_us(fn, n=200):
    """The wrapper's host time a call: n calls back to back, the host clock
    over them (the device runs them behind), divided by n."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def graph_us(fn, n):
    """The device time a launch: n launches of fn captured in a CUDA graph,
    the median of REPS replays over n."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return median_ms(graph.replay) / n * 1e3


def time_loops(emit):
    import torch

    from midi_vae_tpu_torch.ops import gru_step as gs

    B = 256
    with torch.no_grad():
        for H in WIDTHS:
            for dtype in ("float32", "bfloat16"):
                dt = getattr(torch, dtype)
                total = 0.0
                for i, (name, D, T) in enumerate(HEAD_CELLS):
                    o = _step_operands(B, D or H, H, dt, 17 + i)
                    x, w, b, u = o["x"], o["w"], o["b"], o["u"]

                    def loop(T=T, x=x, w=w, b=b, u=u, h0=o["h"]):
                        h = h0
                        for _ in range(T):
                            h = gs.gru_cell_step_fwd(x, h, w, b, u)

                    ms = median_ms(loop)
                    total += ms
                    one = lambda x=x, w=w, b=b, u=u, h=o["h"]: gs.gru_cell_step_fwd(x, h, w, b, u)  # noqa: E731
                    emit({"what": "loop T", "H": H, "dtype": dtype, "cell": name, "launches": T,
                          "ms": ms, "device_us_a_launch": graph_us(one, 64),
                          "host_us_a_call": host_us(one)})
                emit({"what": "loop T, the step's head cells", "H": H, "dtype": dtype,
                      "launches": 196, "ms": total})
            total = 0.0
            o = _step_operands(B, 0, H, torch.float32, 29)
            for name, T in LAYERS:
                xp = torch.randn(T, B, 3 * H, device="cuda")

                def loop(xp=xp, h0=o["h"], u=o["u"]):
                    h = h0
                    for x_t in xp:
                        h = gs.gru_recurrent_step_fwd(x_t, h, u)

                ms = median_ms(loop)
                total += ms
                one = lambda x_t=xp[0], h=o["h"], u=o["u"]: gs.gru_recurrent_step_fwd(x_t, h, u)  # noqa: E731
                emit({"what": "loop T xp", "H": H, "layer": name, "launches": T, "ms": ms,
                      "device_us_a_launch": graph_us(one, 64), "host_us_a_call": host_us(one)})
            emit({"what": "loop T xp, the step's encoder layers", "H": H, "launches": 196,
                  "ms": total})


def time_heads(emit):
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd

    with torch.no_grad():
        for H in WIDTHS:
            for B in BATCHES:
                total = 0.0
                for name, D, n_layers, T, out_act in HEADS[:3]:
                    cells, out, init, start = _head(name, D, n_layers, H, B, 7 + D)
                    ms = median_ms(lambda: gd.gru_decode(cells, out, init, start, T, "tanh",
                                                         out_act), reps=10)
                    total += ms
                    emit({"what": "B head", "head": name, "H": H, "B": B, "ms": ms})
                emit({"what": "B, a transfer's three heads", "H": H, "B": B, "ms": total})


SECTIONS = {"tplans": lambda emit, _a: time_tplans(emit), "talt": lambda emit, _a: time_talt(emit),
            "bplans": time_bplans, "bsplits": lambda emit, _a: time_bsplits(emit),
            "loops": lambda emit, _a: time_loops(emit), "heads": lambda emit, _a: time_heads(emit)}


def main(argv=None) -> int:
    return _timing.main(__doc__, SECTIONS, argv)


if __name__ == "__main__":
    sys.exit(main())
