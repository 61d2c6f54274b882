"""Time kernels F and D wide on their chains (F: the float32 GRU layer over
a given xp = x @ W + b, csrc/gru_layer_xp_fwd.cu; D wide: the decode heads'
training forward at H = 512 and 1024, csrc/gru_decode_train.cu, float32
and bf16) at the paths' shapes on the card.

Run from the repo root on a CUDA card:
    python -m midi_vae_tpu_torch.tools.time_f_and_d [--out FILE] [--only SECTION ...]
        [--H H ...] [--B B ...] [--parent DIR]

``--H`` and ``--B`` keep a section's cases at those widths and batches
(``--H 1024 --only fplans dplans``: GRU(1024)'s plans).

To compare two checkouts in one call, run the file from one with the
other's root on PYTHONPATH (``--only digests`` uses public wrappers that
older checkouts have too):
    PYTHONPATH=OLD python NEW/midi_vae_tpu_torch/tools/time_f_and_d.py --only digests

1. fplans: F's chain at every plan of ``_layout.gru_fwd_plans("F_chain",
   ...)`` (the resident slice at H = 256, the streamed one at 512, in
   clusters of 8 and 16, A's rows and X's balanced ones, each split count)
   and, where the slice streams, the tensor-core instance's
   (``_layout.gru_tc_plans``) on F_CASES (T 64; H 256 and 512: B 256, 16
   and 5; H 1024: B 256, 64, 16 and 5), beside the plan
   ``gru_layer.xp_fwd_plan`` picks (``_timing.sweep``). Each plan's time is
   the device's: one launch in a CUDA-event window, the median of
   ``_timing.REPS``, the plans once in order and once reversed, the two
   medians averaged; its max |diff| from the pick. ``near_best`` lists the
   plans within ``_timing.NEAR`` of the fastest's time;
   tests/test_torch_f_dwide_chains.py and tests/test_torch_gru1024.py hold
   the picks against those sets.
2. dplans: D wide's chain (one head a launch) at every (cluster, rows,
   chunk) of ``plans_of`` on D_CASES (the notes, velocity and instrument
   heads at H = 512: B 256, 128 and 5, float32, and bf16 for the heads of
   8 or more outputs; at H = 1024: B 256 and 5, every head in float32, the
   instrument head in bf16, B's FFMA instance alone), beside
   ``gru_decode.dec_plan``'s pick, timed as above.
3. phases: at F_CASES and D_CASES up to H = 512, F and D wide through their public
   wrappers beside their per-block routes (the first designs, run at the
   same shapes) and beside the plain chain each extends (F: A's chain over
   the same xp, at H = 512 its streamed FFMA instance; D wide, B's FFMA
   chain in its training instance: its tensor-core instance at that
   instance's rule, and in float32 B's serving chain on the same head at
   the same plan, which stores no h sequence); each in one CUDA-event
   window, the median of ``_timing.REPS``, in turns (block, chain, ...,
   chain, block).
4. digests: kernel A's, C's and E's outputs (``time_x_and_g.digests``) and
   kernel B's chain outputs (probs and logits of the notes, velocity and
   instrument heads at H 256 and 512, B 256, numpy-seeded): two checkouts
   whose A, B, C and E compute the same bits print the same digests.
5. steps: one training step (``time_train_step``: the median of 20 steps,
   CUDA events) of the float32 wide config, wide512_bf16 and the bf16
   GRU(512) at B = 128, from the ``--parent`` checkout's root and this
   one's in turns (parent, change, change, parent), each run a process of
   its own.
Prints one JSON line per measurement, with the card's name and power limit.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

if __package__:
    from midi_vae_tpu_torch.tools import _timing
else:  # run as a file, perhaps beside another checkout's package
    import _timing

in_turns, max_diff, select, sweep = _timing.in_turns, _timing.max_diff, _timing.select, _timing.sweep
T = 64
# (H, B) of F: rows 9 (GRU(256), the wide route's test hook) and 11 (the
# wide step), at a training batch, one song and B 5; GRU(1024)'s at B 256,
# 64, 16 and 5 (fplans only: the per-block route launches up to H = 512)
F_CASES = [(256, 256), (256, 16), (256, 5), (512, 256), (512, 16), (512, 5),
           (1024, 256), (1024, 64), (1024, 16), (1024, 5)]
# the decode heads of the wide configs: (name, D, layers, T, output
# activation)
HEADS = [("notes", 61, 2, 64, "softmax"), ("velocity", 1, 1, 64, "sigmoid"),
         ("instrument", 16, 1, 4, "softmax")]
# (H, bf16, head, B) of D wide: at H = 512 the f32 wide step (B 256), the
# bf16 GRU(512) at B = 128 (its velocity head in float32), wide512_bf16 (B
# 256; velocity promoted to float32), and B 5; at H = 1024 every head in
# float32 and the instrument head in bf16 (the bf16 notes head is the plain
# scan there), B 256 and 5 (dplans only)
D_CASES = ([(512, bf16, head, B) for bf16 in (False, True) for head in HEADS for B in (256, 128, 5)
            if not (bf16 and head[1] < 8)]
           + [(1024, bf16, head, B) for bf16, head in [(False, h) for h in HEADS] + [(True, HEADS[2])]
              for B in (256, 5)])
# the steps of the wide configs: f32, wide512_bf16, the bf16 GRU(512) at B 128
STEP_CONFIGS = ("lstm_size=512", "lstm_size=512,compute_dtype=bfloat16",
                "lstm_size=512,compute_dtype=bfloat16,batch_size=128")


def _f_operands(H, B, seed):
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    return randn(T, B, 3 * H), torch.tanh(randn(B, H)), randn(H, 3 * H) / H ** 0.5


def _d_head(head, H, B, bf16, seed):
    """One training head dict of ``head`` at (H, B) on the card: float32,
    or bf16 (its weights rounded)."""
    import torch

    _name, D, n_layers, steps, out_act = head
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.bfloat16 if bf16 else torch.float32
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    cells = [{"w": (randn(d, 3 * H) / d ** 0.5).to(dt), "u": (randn(H, 3 * H) / H ** 0.5).to(dt),
              "b": (0.1 * randn(3 * H)).to(dt)} for d in (D, H)[:n_layers]]
    return {"cells": cells, "out": {"w": (randn(H, D) / H ** 0.5).to(dt),
                                    "b": (0.1 * randn(D)).to(dt)},
            "init": [(0.5 * torch.tanh(randn(B, H))).to(dt) for _ in range(n_layers)],
            "start": torch.zeros(B, D, device=dev, dtype=dt), "T": steps,
            "out_activation": out_act}


def plans_of(H, D, n_layers, B, T_, bf16=False, tc=True):
    """D wide's chain plans timed: the tensor-core instance's
    (``_layout.dec_tc_plans``; with ``tc``) and B's FFMA instance's:
    cluster sizes 4, 8, 16 x rows a cluster (one wave of the H100's active
    clusters at that size, and 4, 8, 16, 32, 64) x every chunk depth that
    fits (``_layout.DEC_CHUNKS``), as ``_layout.dec_train_plan`` fits them
    (duplicates dropped)."""
    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import gru_decode as gd

    elem = 2 if bf16 else 4
    found = {(p.cluster, p.rows, p.chunk, True): p for p in (_layout.dec_tc_plans(
        H, D, n_layers, B, bf16, lambda C: gd.dec_max_clusters(bf16, True, C)) if tc else [])}
    for C in (4, 8, 16):
        if _layout.gru_decode_most_rows(n_layers, D, H, C, elem) < 1:
            continue
        for rows in (None, 4, 8, 16, 32, 64):
            for chunk in _layout.DEC_CHUNKS:
                if _layout.gru_decode_fit(n_layers, D, H, C, rows or 1, chunk, elem) is None:
                    continue
                q = _layout.dec_train_plan(H, D, n_layers, B, T_, bf16, C, rows, chunk)
                found[(q.cluster, q.rows, q.chunk, False)] = q
    return list(found.values())


def time_fplans(emit, args):
    """F's chain at every plan: A's float32 instance's and, where the slice
    streams, the tensor-core instance's."""
    import torch

    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import gru_layer as gl

    key = lambda p: (f"tc {p.cluster}x{p.rows}/{p.chunk}/st{p.stages}" if p.chunk  # noqa: E731
                     else f"{p.cluster}x{p.rows}/s{p.splits}/st{p.stages}")
    for H, B in select(F_CASES, args):
        xp, h0, u = _f_operands(H, B, H + B)
        stream = _layout.gru_fwd_cluster("F_chain", H)[1]
        plans = _layout.gru_fwd_plans("F_chain", H, B,
                                      lambda C: gl._max_clusters("gru_layer_xp_fwd", stream, C))
        if stream:  # the tensor-core instance's plans beside A's streamed ones
            plans += _layout.gru_tc_plans(H, B, gl._tc_max_clusters)
        with torch.no_grad():
            sweep(emit, "F chain plans", plans, _timing.patch("xp_fwd_plan", gl),
                  lambda: gl.gru_layer_xp_fwd_chain(xp, h0, u), key, gl.xp_fwd_plan(H, B),
                  H=H, B=B)


def time_dplans(emit, args):
    """D wide's chain on one head a launch at every plan of ``plans_of``
    (the tensor-core instance, which no shape takes, up to H = 512)."""
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd

    key = lambda p: f"{'tc ' if p.tc else ''}{p.cluster}x{p.rows}/{p.chunk}"  # noqa: E731
    with torch.no_grad():
        for H, bf16, head, B in select(D_CASES, args, B=lambda c: c[3]):
            name, D, n_layers, steps, _act = head
            h = _d_head(head, H, B, bf16, H + D + B)
            sweep(emit, "D wide plans", plans_of(H, D, n_layers, B, steps, bf16, tc=H <= 512),
                  _timing.patch("dec_plan", gd), lambda h=h: gd.gru_decode_fwd_train_wide([h]),
                  key, gd.dec_plan(H, D, n_layers, B, steps, bf16), reps=5, bf16=bf16,
                  head=name, H=H, B=B, D=D, T=steps, layers=n_layers)


def time_phases(emit, args):
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.ops import gru_layer as gl

    with torch.no_grad():
        for H, B in select([c for c in F_CASES if c[0] <= 512], args):
            xp, h0, u = _f_operands(H, B, 7 + H + B)
            fns = {"block": lambda: gl.gru_layer_xp_fwd_block(xp, h0, u),
                   "chain": lambda: gl.gru_layer_xp(xp, h0, u),
                   # A's float32 chain over the same xp (A's library)
                   "A_chain": lambda: gl.gru_layer_fwd_chain(xp, h0, u, "tanh", True)}
            diff = max_diff(fns["chain"](), gl.gru_layer_xp_reference(xp, h0, u))
            ms = in_turns(fns)
            emit({"what": "F", "H": H, "B": B, "T": T, "ms": ms["chain"],
                  "ms_block": ms["block"], "ms_a_chain": ms["A_chain"],
                  "plan": gl.xp_fwd_plan(H, B)._asdict(), "max_abs_diff_from_plain": diff,
                  "max_abs_diff_block": max_diff(fns["block"](), fns["chain"]())})
        for H, bf16, head, B in select([c for c in D_CASES if c[0] <= 512], args,
                                       B=lambda c: c[3]):
            name, D, n_layers, steps, out_act = head
            h = _d_head(head, H, B, bf16, 11 + D + B)
            sfx = "_bf16" if bf16 else ""
            plan = gd.dec_plan(H, D, n_layers, B, steps, bf16)

            def run_block(h=h):
                # the per-block route on the same head (the route chooser
                # told to take it)
                saved = gd._layout.dec_train_route
                gd._layout.dec_train_route = lambda *_a: "block"
                try:
                    return gd.gru_decode_fwd_train_wide([h])
                finally:
                    gd._layout.dec_train_route = saved

            tc = gd._layout.dec_train_plan(H, D, n_layers, B, steps, bf16, tc=True)

            def run_tc(h=h, p=tc):
                # the tensor-core instance at its rule's plan
                saved = gd.dec_plan
                gd.dec_plan = lambda *_a: p
                try:
                    return gd.gru_decode_fwd_train_wide([h])
                finally:
                    gd.dec_plan = saved

            fns = {"block": run_block, "chain": lambda h=h: gd.gru_decode_fwd_train_wide([h]),
                   "tc": run_tc}
            if not bf16:  # B's serving chain on the same head at the same plan (no stores)
                args = (h["cells"], h["out"], h["init"], h["start"], steps, "tanh", out_act)
                fns["B_chain"] = lambda a=args, p=plan: gd.gru_decode(*a, plan=p)
            plain = gd.gru_decode_train_reference(h["cells"], h["out"], h["init"], h["start"],
                                                  steps, out_act)
            diff = max_diff(fns["chain"](), [plain])
            ms = in_turns(fns)
            emit({"what": f"D wide{sfx}", "head": name, "H": H, "B": B, "D": D, "T": steps,
                  "layers": n_layers, "ms": ms["chain"], "ms_block": ms["block"],
                  "ms_tc": ms["tc"], "ms_b_chain": ms.get("B_chain"),
                  "plan": plan._asdict(), "tc_plan": tc._asdict(),
                  "max_abs_diff_from_plain": diff,
                  "max_abs_diff_block": max_diff(fns["block"](), fns["chain"]()),
                  "max_abs_diff_tc": max_diff(fns["tc"](), fns["chain"]())})


def _digest(ts):
    import torch

    h = hashlib.sha256()
    for t in ts:
        if t is not None:
            h.update(t.detach().contiguous().view(-1).cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def b_digests():
    """{name: sha256 prefix} of B's chain outputs (probs, logits) on
    numpy-seeded heads: notes, velocity and instrument at H 256 and 512, B
    256."""
    import numpy as np
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd

    out = {}
    with torch.no_grad():
        for H in (256, 512):
            for name, D, n_layers, steps, out_act in HEADS:
                rng = np.random.RandomState(H + D)
                arr = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
                    (scale * rng.standard_normal(s)).astype(np.float32)).cuda()
                cells = [{"w": arr(d, 3 * H, scale=d ** -0.5), "u": arr(H, 3 * H, scale=H ** -0.5),
                          "b": arr(3 * H, scale=0.1)} for d in (D, H)[:n_layers]]
                dense = {"w": arr(H, D, scale=H ** -0.5), "b": arr(D, scale=0.1)}
                init = [torch.tanh(arr(256, H)) for _ in range(n_layers)]
                start = torch.zeros(256, D, device="cuda")
                out[f"B chain {name} H{H}"] = _digest(gd.gru_decode(cells, dense, init, start,
                                                                   steps, "tanh", out_act))
    torch.cuda.synchronize()
    return out


def digests():
    """A's, C's and E's digests (``time_x_and_g.digests``) and B's chain's."""
    from midi_vae_tpu_torch.tools.time_x_and_g import digests as ace

    return {**ace(), **b_digests()}


def time_steps(emit, args):
    """The wide configs' step times from ``--parent`` and this checkout in
    turns (parent, change, change, parent), a process each."""
    parent = args.parent
    if not parent:
        raise ValueError("section steps needs --parent")
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tool = os.path.join(here, "midi_vae_tpu_torch", "tools", "time_train_step.py")
    runs = {"parent": [], "change": []}
    for label, root in (("parent", parent), ("change", here), ("change", here),
                        ("parent", parent)):
        env = dict(os.environ, PYTHONPATH=root)
        got = subprocess.run([sys.executable, tool, *STEP_CONFIGS], cwd=root, env=env,
                             capture_output=True, text=True, timeout=1200)
        if got.returncode != 0:
            raise RuntimeError(f"time_train_step in {root} failed:\n{got.stderr[-4000:]}")
        runs[label].append(json.loads(got.stdout.strip().splitlines()[-1])["steps"])
    emit({"what": "wide steps, parent and change in turns",
          "ms": {label: {cfg: [r[cfg]["ms"] for r in rs] for cfg in STEP_CONFIGS}
                 for label, rs in runs.items()}})


SECTIONS = {"fplans": time_fplans, "dplans": time_dplans, "phases": time_phases,
            "digests": lambda emit, _args: emit({"what": "digests of A, B, C and E",
                                                 "digests": digests()}),
            "steps": time_steps}


def main(argv=None) -> int:
    return _timing.main(__doc__, SECTIONS, argv, default=list(SECTIONS)[:4])


if __name__ == "__main__":
    sys.exit(main())
