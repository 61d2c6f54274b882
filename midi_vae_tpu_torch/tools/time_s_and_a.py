"""Time kernel S (csrc/lstm_step.cu) at each of its tile plans, and the
launches of kernels S, S xp and A (csrc/gru_layer_fwd.cu) that a training
step makes.

Run from the repo root on a CUDA card:
    python -m midi_vae_tpu_torch.tools.time_s_and_a [--out FILE] [--only SECTION ...]
        [--H H ...] [--B B ...]

To compare two checkouts in one call, run the file from one with the
other's root on PYTHONPATH (``--only loops`` uses the public wrappers
alone, which older checkouts have too):
    PYTHONPATH=OLD python NEW/midi_vae_tpu_torch/tools/time_s_and_a.py --only loops

1. tiles: S (and S xp) at every tile of ``_layout.STEP_TILES`` on
   TILE_CASES, the paths' shapes (B 256, 16, 5; the notes head's cells, the
   velocity and instrument heads, S xp; H 256 and 512; float32 and bf16),
   beside the tile ``_layout.step_plan`` picks. Each tile's time is the
   device's: LAUNCHES launches captured in a CUDA graph, the median of REPS
   replays, the tiles once in order and once reversed, the two medians
   averaged; its max |diff| from the plain step. ``near_best`` lists the
   tiles within NEAR of the fastest's time;
   tests/test_torch_lstm_step_tc.py holds ``step_plan``'s picks against
   those sets.
2. loops: the launches of a training step at B = 256 as the paths make
   them, each in one CUDA-event window (median of REPS), through the public
   wrappers: S over the LSTM(256) step's four head cells (notes 1 and 2,
   velocity, instrument: 64 + 64 + 64 + 4 = 196 launches, the state
   carried) in float32 and bf16 beside torch.lstm_cell's same loop; S xp
   over its four encoder layers (196 launches); A over the Config()
   encoder's four layers (the h sequence, as training runs them) in
   float32 and bf16. Seeded random weights at the paths' shapes.
3. aplans: A's float32 chain (the serving encoder's, ``gru_layer.
   gru_chain_plan``; at H = 1024 its streamed instance) at every plan of
   ``_layout.gru_fwd_plans("A_chain", ...)`` on A_CASES (T 64; H 1024, B
   256 and 16; ``--H``, ``--B`` keep those cases), beside the pick
   (``_timing.sweep``: one launch, the median of ``_timing.REPS``
   CUDA-event windows, in order then reversed; ``near_best`` the plans
   within ``_timing.NEAR`` of the fastest; tests/test_torch_gru1024.py
   holds the picks against those sets).
Prints one JSON line per measurement, with the card's name and power limit.
"""

from __future__ import annotations

import functools
import sys

if __package__:
    from midi_vae_tpu_torch.tools import _timing
else:  # run as a file, perhaps beside another checkout's package
    import _timing

# (B, D, H, dtype), D = 0 for S xp: the notes head's cell 1 (D 61) and
# cell 2 (D = H), the velocity (D 1) and instrument (D 16) heads, at a
# training batch, one song and a ragged bucket
TILE_CASES = [(B, D, H, dtype) for B in (256, 16, 5) for H in (256, 512)
              for D, dtype in ((61, "float32"), (H, "float32"), (1, "float32"), (16, "float32"),
                               (61, "bfloat16"), (H, "bfloat16"), (1, "bfloat16"),
                               (16, "bfloat16"), (0, "float32"))]
# (H, B) of A's serving chain plans: GRU(1024)'s encoder at a transfer
# batch and one song
A_CASES = [(1024, 256), (1024, 16)]
REPS, LAUNCHES = 20, 64
NEAR = _timing.NEAR
median_ms = functools.partial(_timing.median_ms, reps=REPS)


def time_tiles(emit):
    import torch

    from midi_vae_tpu_torch.ops import _build, _layout
    from midi_vae_tpu_torch.ops import lstm_step as ls

    dev = torch.device("cuda")
    lib, steps, step_xp = ls._kernels()
    for B, D, H, dtype in TILE_CASES:
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=dev).manual_seed(B + D + H)
        randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
        h, c = (0.5 * torch.tanh(randn(B, H))).to(dt), randn(B, H).to(dt)
        u = (randn(H, 4 * H) / H ** 0.5).to(dt)
        h_out, c_out = torch.empty_like(h), torch.empty_like(h)
        if D:
            x = torch.softmax(randn(B, D), -1).to(dt)
            w, b = (randn(D, 4 * H) / max(D, 1) ** 0.5).to(dt), (0.1 * randn(4 * H)).to(dt)
            want = ls.lstm_cell_step_reference(x, h, c, w, b, u)

            def launch(tile):
                rc = steps[dt](x.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(),
                               b.data_ptr(), u.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
                               B, D, H, 0, tile, torch._C._cuda_getCurrentRawStream(0))
                _build.check(lib, rc, "lstm_step launch")
        else:
            xp = randn(B, 4 * H)
            want = ls.lstm_recurrent_step_reference(xp, h, c, u)

            def launch(tile):
                rc = step_xp(xp.data_ptr(), h.data_ptr(), c.data_ptr(), u.data_ptr(),
                             h_out.data_ptr(), c_out.data_ptr(), B, H, 0, tile,
                             torch._C._cuda_getCurrentRawStream(0))
                _build.check(lib, rc, "lstm_step_xp launch")

        tiles = range(len(_layout.STEP_TILES))
        graphs, err = {}, {}
        for tile in tiles:
            launch(tile)
            torch.cuda.synchronize()
            err[tile] = max((h_out.float() - want[0].float()).abs().max().item(),
                            (c_out.float() - want[1].float()).abs().max().item())
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(LAUNCHES):
                    launch(tile)
            graphs[tile] = graph
        fwd = {t: median_ms(graphs[t].replay) for t in tiles}
        back = {t: median_ms(graphs[t].replay) for t in reversed(tiles)}
        ms = {t: (fwd[t] + back[t]) / 2 for t in tiles}
        best = min(ms.values())
        pick = _layout.step_plan(B, D, H, h.element_size() if D else 4)
        emit({"what": "S tiles" if D else "S xp tiles", "B": B, "D": D, "H": H,
              "dtype": dtype, "launches": LAUNCHES, "pick": pick.tile,
              "ms": {str(t): ms[t] for t in tiles},
              "near_best": [t for t in tiles if ms[t] <= (1 + NEAR) * best],
              "max_abs_err": {str(t): err[t] for t in tiles}})


# (name, D, T) of the LSTM(256) step's head cells, and of the Config()
# encoder's layers (return_sequences as training runs them: all)
HEAD_CELLS = (("notes cell 1", 61, 64), ("notes cell 2", 256, 64), ("velocity", 1, 64),
              ("instrument", 16, 4))
LAYERS = (("notes_l1", 61, 64), ("notes_l2", 256, 64), ("instrument", 16, 4),
          ("velocity", 1, 64))


def time_loops(emit):
    import torch

    from midi_vae_tpu_torch.ops import gru_layer as gl
    from midi_vae_tpu_torch.ops import lstm_step as ls

    dev = torch.device("cuda")
    H, B = 256, 256
    gen = torch.Generator(device=dev).manual_seed(16)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            h0, c0 = (0.5 * torch.tanh(randn(B, H))).to(dt), randn(B, H).to(dt)
            u = (randn(H, 4 * H) / H ** 0.5).to(dt)
            total = {"S": 0.0, "torch.lstm_cell": 0.0}
            for name, D, T in HEAD_CELLS:
                x = torch.softmax(randn(B, D), -1).to(dt)
                w, b = (randn(D, 4 * H) / D ** 0.5).to(dt), (0.1 * randn(4 * H)).to(dt)
                wt, ut, b0 = w.t().contiguous(), u.t().contiguous(), torch.zeros_like(b)

                def loop(f, T=T):
                    st = (h0, c0)
                    for _ in range(T):
                        st = f(st)

                s_ms = median_ms(lambda: loop(lambda st: ls.lstm_cell_step_fwd(x, *st, w, b, u)))
                lib_ms = median_ms(lambda: loop(lambda st: torch.lstm_cell(x, st, wt, ut, b, b0)))
                total["S"] += s_ms
                total["torch.lstm_cell"] += lib_ms
                emit({"what": "loop S", "dtype": dtype, "cell": name, "launches": T, "ms": s_ms,
                      "torch_lstm_cell_ms": lib_ms})
            emit({"what": "loop S, the step's head cells", "dtype": dtype, "launches": 196,
                  "ms": total["S"], "torch_lstm_cell_ms": total["torch.lstm_cell"]})
        total = 0.0
        h0, c0 = 0.5 * torch.tanh(randn(B, H)), randn(B, H)
        u = randn(H, 4 * H) / H ** 0.5
        for name, _D, T in LAYERS:
            xp = randn(T, B, 4 * H)

            def loop(xp=xp):
                st = (h0, c0)
                for x_t in xp:
                    st = ls.lstm_recurrent_step_fwd(x_t, *st, u)

            ms = median_ms(loop)
            total += ms
            emit({"what": "loop S xp", "layer": name, "launches": len(xp), "ms": ms})
        emit({"what": "loop S xp, the step's encoder layers", "launches": 196, "ms": total})
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            total = 0.0
            for name, D, T in LAYERS:
                x = torch.softmax(randn(T, B, D), -1).to(dt)
                w, b = (randn(D, 3 * H) / D ** 0.5).to(dt), (0.1 * randn(3 * H)).to(dt)
                u3, h = (randn(H, 3 * H) / H ** 0.5).to(dt), torch.zeros(B, H, device=dev, dtype=dt)
                ms = median_ms(lambda: gl.gru_layer(x, h, w, b, u3, "tanh", True))
                total += ms
                emit({"what": "A", "dtype": dtype, "layer": name, "ms": ms})
            emit({"what": "A, the Config() encoder's four layers", "dtype": dtype, "ms": total})


def time_aplans(emit, args):
    import torch

    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import gru_layer as gl

    key = lambda p: f"{p.cluster}x{p.rows}/s{p.splits}/st{p.stages}"  # noqa: E731
    for H, B in _timing.select(A_CASES, args):
        gen = torch.Generator(device="cuda").manual_seed(B)
        randn = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
        xp, h0, u = randn(64, B, 3 * H), torch.tanh(randn(B, H)), randn(H, 3 * H) / H ** 0.5
        plans = _layout.gru_fwd_plans("A_chain", H, B,
                                      lambda C: gl._max_clusters("gru_layer_fwd", False, C, True))
        with torch.no_grad():
            _timing.sweep(emit, "A chain plans (serving, float32)", plans,
                          _timing.patch("gru_chain_plan", gl),
                          lambda: gl.gru_layer_fwd_chain(xp, h0, u, "tanh", True), key,
                          gl.gru_chain_plan("A_chain", H, B), H=H, B=B)


SECTIONS = {"tiles": lambda emit, _a: time_tiles(emit), "loops": lambda emit, _a: time_loops(emit),
            "aplans": time_aplans}


def main(argv=None) -> int:
    return _timing.main(__doc__, SECTIONS, argv)


if __name__ == "__main__":
    sys.exit(main())
