"""What the timing tools share: a function's device time (CUDA events),
functions timed in turns, a chain's plans swept, and the tools' command
line (``--out``, ``--only``, ``--H``, ``--B``, ``--parent``), each record
printed as one JSON line with the card's name and power limit.

A tool run as a file (``python NEW/midi_vae_tpu_torch/tools/TOOL.py`` with
another checkout's root on PYTHONPATH) imports this module as its sibling,
so it runs against a checkout that predates the module too.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import traceback

REPS = 15
NEAR = 0.10


def median_ms(fn, reps=REPS):
    """The median device ms of ``fn`` over ``reps`` runs, each in one
    CUDA-event window."""
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def in_turns(fns, reps=REPS):
    """{key: ms}: each of ``fns``' median, once in order and once reversed
    (each run once before it is timed), the two medians averaged."""
    keys = list(fns)
    fwd, back = {}, {}
    for order, into in ((keys, fwd), (list(reversed(keys)), back)):
        for k in order:
            fns[k]()
            into[k] = median_ms(fns[k], reps)
    return {k: (fwd[k] + back[k]) / 2 for k in keys}


def flat(out):
    """The tensors of a wrapper's outputs, in order: nested tuples and
    lists, E's output dicts (dlogits, da, d_init, d_start); None dropped."""
    if isinstance(out, dict):
        return [t for k in ("dlogits", "da", "d_init", "d_start") for t in flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat(o)]
    return [out] if out is not None else []


def max_diff(got, want):
    return max((g.float() - w.float()).abs().max().item() for g, w in zip(flat(got), flat(want)))


def rel_l2(got, want):
    return max(((g.float() - w.float()).norm() / w.float().norm().clamp_min(1e-30)).item()
               for g, w in zip(flat(got), flat(want)))


def patch(name, *modules):
    """A ``force`` for the plan function ``name`` of ``modules``: a plan
    to return whatever the arguments, or None to restore each module's
    own."""
    orig = [getattr(m, name) for m in modules]

    def force(p):
        for m, o in zip(modules, orig):
            setattr(m, name, o if p is None else (lambda *_a, _p=p: _p))
    return force


def sweep(emit, what, plans, force, call, key, pick, reps=REPS, **info):
    """Times ``call`` under each of ``plans`` (``force(plan)`` makes the
    wrappers take it) in turns and emits the record: each plan's ms,
    ``near_best`` (the plans within NEAR of the fastest), the plan the
    wrappers pick today (``pick``) and each plan's max |diff| from its
    outputs, keyed by ``key(plan)``."""
    try:
        force(pick)
        want = [t.clone() for t in flat(call())]
        err, fns = {}, {}
        for p in plans:
            force(p)
            err[key(p)] = max_diff(call(), want)
            fns[key(p)] = lambda _p=p: (force(_p), call())
        ms = in_turns(fns, reps)
    finally:
        force(None)
    best = min(ms.values())
    emit({"what": what, **info, "picked": key(pick), "ms": ms,
          "near_best": [k for k in ms if ms[k] <= (1 + NEAR) * best],
          "max_abs_diff_from_pick": err, "plans": {str(key(p)): p._asdict() for p in plans}})


def bptt_plans(build, H, B, shape=None):
    """The plan of the GRU backward chain ``build`` (C's, E's or G's, at
    the call's head ``shape`` for E) at every cluster size its cost model
    gives one at (``_layout._bptt_candidate``, the card's active
    clusters)."""
    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import gru_layer as gl

    lib = {"C": "gru_layer_bwd", "E": "gru_decode_bwd", "G": "gru_layer_xp_bwd"}[build[0]]
    bf16 = build.endswith("_bf16")
    parts = _layout._bptt_parts(build, H, shape)
    plans = []
    for C in _layout.CLUSTER_SIZES:
        if _layout._bptt_cluster_ok(H, C):
            got = _layout._bptt_candidate(H, B, C, parts, gl._max_clusters(lib, bf16, C),
                                          2 if bf16 else 4)
            if got is not None:
                plans.append(got[0])
    return plans


def select(cases, args, H=lambda c: c[0], B=lambda c: c[1]):
    """The ``cases`` at the widths ``args.H`` and batches ``args.B`` (all
    where not given); ``H`` and ``B`` read a case's."""
    return [c for c in cases if (not args.H or H(c) in args.H) and (not args.B or B(c) in args.B)]


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(doc, sections, argv=None, default=None):
    """A tool's command line: ``--only SECTION ...`` (default ``default``,
    else every section), ``--out FILE`` (the JSON lines written there too),
    ``--H`` and ``--B`` (a section's cases at those widths and batches
    only), ``--parent DIR`` (the parent checkout's root, for the sections
    that compare two); each section is called as ``section(emit, args)``.
    Exits 1 without a CUDA card, and where a section failed (the others
    still run)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--only", nargs="+", choices=list(sections),
                    default=list(default or sections), help="the sections to run")
    ap.add_argument("--H", type=int, nargs="+", help="only the cases at these widths")
    ap.add_argument("--B", type=int, nargs="+", help="only the cases at these batches")
    ap.add_argument("--parent", help="the parent checkout's root")
    args = ap.parse_args(argv)
    if args.parent:
        args.parent = os.path.abspath(args.parent)
    import torch

    from midi_vae_tpu_torch import use_exact_f32

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    use_exact_f32()
    smi = card()
    out = open(args.out, "w") if args.out else None

    def emit(rec):
        line = json.dumps({**rec, "card": smi})
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    failed = []
    for name in args.only:
        try:
            sections[name](emit, args)
        except Exception:
            traceback.print_exc()
            failed.append(name)
    if out:
        out.close()
    if failed:
        print(f"sections failed: {failed}", file=sys.stderr)
    return 1 if failed else 0
