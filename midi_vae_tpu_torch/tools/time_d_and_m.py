"""Time kernels D (every build: the decode heads' training forward,
csrc/gru_decode_train.cu) and M (the LSTM serving decode, csrc/lstm_decode.cu)
on their decode chains at the paths' shapes on the card.

Run from the repo root on a CUDA card:
    python -m midi_vae_tpu_torch.tools.time_d_and_m [--out FILE] [--only SECTION ...]
        [--parent DIR]

Sections:
1. check: D's chain instances (D, D bf16, D resid) on numpy-seeded heads at
   the `Config()` step's shapes, each against its plain version, D resid's
   probs and logits bit-equal to D's, and M's chain (both counts of h tiles)
   on the LSTM transfer's heads against its plain version; every instance's
   registers and spills from ptxas.
2. dplans: D's chain (one head a launch) at every (cluster, rows, chunk) of
   ``time_f_and_d.plans_of`` at H = 256 on D_CASES (the notes, velocity,
   instrument and held heads; B 256, 16 and 5; float32, and bf16 for the
   heads of 8 or more outputs), beside ``gru_decode.dec_plan``'s pick. Each
   plan's time is the device's: one launch in a CUDA-event window, the
   median of 5, the plans once in order and once reversed, the two medians
   averaged (``_timing.sweep``). ``near_best`` lists the plans within
   ``_timing.NEAR`` of the fastest's time; tests/test_torch_d_chain.py holds the picks against
   those sets (tests/data/d_m_near_best.json).
3. mplans: M's chain at every plan of ``_layout.lstm_decode_plans`` (two h
   tiles a layer and one with a second barrier) on M_CASES (the LSTM
   serving heads: notes, velocity, instrument, held; H 256 and 512; B 256,
   16 and 5), beside ``lstm_decode.decode_plan``'s pick, timed as above;
   tests/test_torch_lstm_decode_chain.py holds the picks.
4. kernels: D, D bf16, D resid and M through their public wrappers at the
   paths' shapes (B = 256: the `Config()` step's notes + velocity call and
   instrument head, in f32, with bf16 residuals, and in bf16 (notes,
   instrument); the LSTM(256) transfer's three heads; the notes and velocity
   heads alone and side by side on two streams, and their slices'
   repacking), each the median of
   ``_timing.REPS`` CUDA-event windows. With ``--parent``, this file runs from the
   parent's root and this one's in turns (parent, change, change, parent),
   a process each; it uses only wrappers the parent has.
5. digests: D wide's outputs (probs, logits and h sequences of numpy-seeded
   notes, velocity and instrument heads at H = 512, B = 256, float32 and
   bf16): two checkouts whose wide D computes the same bits print the same
   digests (run from the parent's root with ``--parent``, as section 4).
6. steps: the device ms of the `Config()`, bf16 `Config()` and
   `residual_bf16` training steps (``profile_train``) and of the LSTM
   transfer at B = 256 (``tools/profile_transfer_torch.py``), from the
   ``--parent`` checkout's root and this one's in turns (parent, change,
   change, parent), a process each.
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

in_turns, median_ms, NEAR = _timing.in_turns, _timing.median_ms, _timing.NEAR
H_ATOL, LOGITS_ATOL = 5e-5, 1e-4  # chip_smoke.py's limits for D's and B's outputs
M_PROBS_ATOL = 1e-5  # chip_smoke.py's limit for M's probs
# the relative L2 limit of a bf16 decode against its plain version
# (chip_smoke.py's BF16_REL_L2)
BF16_REL_L2 = 1.7e-3
# the decode heads: (name, D, layers, T, output activation)
HEADS = [("notes", 61, 2, 64, "softmax"), ("velocity", 1, 1, 64, "sigmoid"),
         ("instrument", 16, 1, 4, "softmax"), ("held", 2, 1, 64, "sigmoid")]
# (bf16, head, B) of D at H = 256: the `Config()` step's heads (the held
# head with meta_held_notes), one song and B 5; bf16 for the heads of 8 or
# more outputs (the rest are promoted to float32)
D_CASES = [(bf16, head, B) for bf16 in (False, True) for head in HEADS for B in (256, 16, 5)
           if not (bf16 and head[1] < 8)]
# (H, head, B) of M: the LSTM serving heads at H 256 and 512
M_CASES = [(H, head, B) for H in (256, 512) for head in HEADS for B in (256, 16, 5)]
STEP_CONFIGS = ("", "compute_dtype=bfloat16", "decode_residual_bf16=True")


def _arr(rng, dev):
    import numpy as np
    import torch

    return lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (scale * rng.standard_normal(s)).astype(np.float32)).to(dev)


def gru_head(head, H, B, bf16, seed, dev="cuda"):
    """One numpy-seeded GRU training head dict of ``head`` at (H, B):
    float32, or bf16 (its values rounded)."""
    import numpy as np
    import torch

    _name, D, n_layers, steps, out_act = head
    arr = _arr(np.random.RandomState(seed), dev)
    dt = torch.bfloat16 if bf16 else torch.float32
    cells = [{"w": arr(d, 3 * H, scale=d ** -0.5).to(dt), "u": arr(H, 3 * H, scale=H ** -0.5).to(dt),
              "b": arr(3 * H, scale=0.1).to(dt)} for d in (D, H)[:n_layers]]
    return {"cells": cells, "out": {"w": arr(H, D, scale=H ** -0.5).to(dt),
                                    "b": arr(D, scale=0.1).to(dt)},
            "init": [(0.5 * torch.tanh(arr(B, H))).to(dt) for _ in range(n_layers)],
            "start": torch.zeros(B, D, device=dev, dtype=dt), "T": steps,
            "out_activation": out_act}


def lstm_head(head, H, B, seed, dev="cuda"):
    """The arguments of ``lstm_decode`` for a numpy-seeded LSTM serving head
    of ``head`` at (H, B) (tanh cells)."""
    import numpy as np
    import torch

    _name, D, n_layers, steps, out_act = head
    arr = _arr(np.random.RandomState(seed), dev)
    cells = [{"w": arr(d, 4 * H, scale=d ** -0.5), "u": arr(H, 4 * H, scale=H ** -0.5),
              "b": arr(4 * H, scale=0.1)} for d in (D, H)[:n_layers]]
    dense = {"w": arr(H, D, scale=H ** -0.5), "b": arr(D, scale=0.1)}
    states = [(0.5 * torch.tanh(arr(B, H)), 0.5 * arr(B, H)) for _ in range(n_layers)]
    return cells, dense, states, torch.zeros(B, D, device=dev), steps, "tanh", out_act


def _d_plain(heads, rdt=None):
    from midi_vae_tpu_torch.ops import gru_decode as gd

    return [gd.gru_decode_train_reference(h["cells"], h["out"], h["init"], h["start"], h["T"],
                                          h["out_activation"], rdt) for h in heads]


def check(emit):
    """D's chain instances and M's chain against their plain versions."""
    import torch

    from midi_vae_tpu_torch.ops import _build, _layout
    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.ops import lstm_decode as ld

    _build.build(["gru_decode_train", "lstm_decode"])  # one nvcc each, together
    failures = []
    with torch.no_grad():
        notes, vel, inst = (gru_head(h, 256, 256, False, 1 + k) for k, h in enumerate(HEADS[:3]))
        for build, heads in (("D", [notes, vel]), ("D", [inst]), ("D_resid", [notes, vel])):
            before = (gd.gru_decode_fwd_train.launches_chain,
                      gd.gru_decode_fwd_train.launches_chain_resid)
            got = gd.gru_decode_fwd_train(heads, build)
            torch.cuda.synchronize()
            want = _d_plain(heads, torch.bfloat16 if build == "D_resid" else None)
            diff = _timing.max_diff([g[:2] for g in got], [w[:2] for w in want])
            # D resid's h sequences: one bf16 step where a float h rounds the
            # other way
            hdiff = _timing.max_diff([g[2] for g in got], [w[2] for w in want])
            chains = (gd.gru_decode_fwd_train.launches_chain - before[0]
                      + gd.gru_decode_fwd_train.launches_chain_resid - before[1])
            ok = (diff <= LOGITS_ATOL and hdiff <= (4e-3 if build == "D_resid" else H_ATOL)
                  and chains == len(heads))
            emit({"what": f"check {build}", "heads": len(heads), "max_abs_diff": diff,
                  "max_abs_diff_h": hdiff, "chain_launches": chains, "ok": ok})
            failures += [] if ok else [f"{build} on {len(heads)} heads"]
        exact = gd.gru_decode_fwd_train([notes, vel], "D")
        resid = gd.gru_decode_fwd_train([notes, vel], "D_resid")
        bits = all(torch.equal(a, b) for e, r in zip(exact, resid) for a, b in zip(e[:2], r[:2]))
        emit({"what": "check D resid probs and logits bit-equal to D's", "ok": bits})
        failures += [] if bits else ["D resid bits"]
        for name, head in (("notes", HEADS[0]), ("instrument", HEADS[2])):
            h = gru_head(head, 256, 256, True, 5)
            got = gd.gru_decode_fwd_train([h], "D_bf16")
            torch.cuda.synchronize()
            err = _timing.rel_l2(got, _d_plain([h]))
            emit({"what": f"check D_bf16 {name}", "rel_l2": err, "ok": err <= BF16_REL_L2})
            failures += [] if err <= BF16_REL_L2 else [f"D_bf16 {name}"]
        for H in (256, 512):
            for head in HEADS:
                args = lstm_head(head, H, 256, H + head[1])
                want = ld.lstm_decode_reference(*args)
                for nb in (2, 1):
                    plan = _layout.lstm_decode_plan(H, head[1], head[2], 256, T=head[3], nb=nb)
                    got = ld.lstm_decode(*args, plan=plan)
                    torch.cuda.synchronize()
                    dp, dl = _timing.max_diff(got[0], want[0]), _timing.max_diff(got[1], want[1])
                    ok = dp <= M_PROBS_ATOL and dl <= LOGITS_ATOL
                    emit({"what": f"check M chain H{H} {head[0]} nb={nb}", "probs": dp,
                          "logits": dl, "plan": plan._asdict(), "ok": ok})
                    failures += [] if ok else [f"M H{H} {head[0]} nb={nb}"]
    regs = {lib: {k: v for k, v in _build.ptxas_report.get(lib, {}).items()
                  if "chain" in k} for lib in ("gru_decode_train", "lstm_decode")}
    emit({"what": "ptxas of the chain instances", "report": regs})
    if failures:
        raise RuntimeError(f"kernels off their plain versions: {failures}")


def time_dplans(emit):
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.tools.time_f_and_d import plans_of

    key = lambda p: f"{p.cluster}x{p.rows}/{p.chunk}"  # noqa: E731
    with torch.no_grad():
        for bf16, head, B in D_CASES:
            name, D, n_layers, steps, _act = head
            h = gru_head(head, 256, B, bf16, 256 + D + B)
            build = "D_bf16" if bf16 else "D"
            _timing.sweep(emit, "D plans", plans_of(256, D, n_layers, B, steps, bf16, tc=False),
                          _timing.patch("dec_plan", gd),
                          lambda h=h, b=build: gd.gru_decode_fwd_train([h], b), key,
                          gd.dec_plan(256, D, n_layers, B, steps, bf16), reps=5, bf16=bf16,
                          head=name, H=256, B=B, D=D, T=steps, layers=n_layers)


def time_mplans(emit):
    import torch

    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import lstm_decode as ld

    key = lambda p: f"{p.cluster}x{p.rows}/{p.chunk}/nb{p.nb}"  # noqa: E731
    with torch.no_grad():
        for H, head, B in M_CASES:
            name, D, n_layers, steps, _act = head
            args = lstm_head(head, H, B, H + D + B)
            pick = ld.decode_plan(H, D, n_layers, B, steps)
            plans = _layout.lstm_decode_plans(H, D, n_layers, B, steps, ld.chain_max_clusters)
            want = [t.clone() for t in ld.lstm_decode(*args, plan=pick)]
            err = {key(p): _timing.max_diff(ld.lstm_decode(*args, plan=p), want) for p in plans}
            ms = in_turns({key(p): (lambda _p=p: ld.lstm_decode(*args, plan=_p)) for p in plans},
                          reps=5)
            best = min(ms.values())
            emit({"what": "M plans", "head": name, "H": H, "B": B, "D": D, "T": steps,
                  "layers": n_layers, "picked": key(pick), "ms": ms,
                  "near_best": [k for k in ms if ms[k] <= (1 + NEAR) * best],
                  "max_abs_diff_from_pick": err})


def kernel_times():
    """{what: ms} of D's builds and M through their public wrappers at the
    paths' shapes (B = 256)."""
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.ops import lstm_decode as ld

    out = {}
    with torch.no_grad():
        f32 = [gru_head(h, 256, 256, False, 1 + k) for k, h in enumerate(HEADS[:3])]
        bf = [gru_head(h, 256, 256, True, 5 + k) for k, h in enumerate(HEADS[:3])]
        fns = {"D notes + velocity": lambda: gd.gru_decode_fwd_train(f32[:2], "D"),
               "D instrument": lambda: gd.gru_decode_fwd_train(f32[2:], "D"),
               "D resid notes + velocity": lambda: gd.gru_decode_fwd_train(f32[:2], "D_resid"),
               "D bf16 notes": lambda: gd.gru_decode_fwd_train([bf[0]], "D_bf16"),
               "D bf16 instrument": lambda: gd.gru_decode_fwd_train([bf[2]], "D_bf16")}
        for k, head in enumerate(HEADS[:3]):
            args = lstm_head(head, 256, 256, 256 + head[1])
            fns[f"M {head[0]}"] = lambda a=args: ld.lstm_decode(*a)
        if hasattr(gd, "dec_plan"):
            # the multi-head split's yardstick: the notes and velocity heads
            # alone, and side by side on two streams (what one launch that
            # shares the SMs between the heads could reach at most)
            side = torch.cuda.Stream()

            def two_streams():
                side.wait_stream(torch.cuda.current_stream())
                gd.gru_decode_fwd_train(f32[:1], "D")
                with torch.cuda.stream(side):
                    gd.gru_decode_fwd_train(f32[1:2], "D")
                torch.cuda.current_stream().wait_stream(side)

            # the slices' repacking, which a training step pays once a head
            # (the optimizer's update moves the weights' version counters)
            plans = [gd.dec_plan(256, h["start"].shape[1], len(h["cells"]), 256, h["T"])
                     for h in f32[:2]]
            fns.update({"D notes": lambda: gd.gru_decode_fwd_train(f32[:1], "D"),
                        "D velocity": lambda: gd.gru_decode_fwd_train(f32[1:2], "D"),
                        "D notes + velocity on two streams": two_streams,
                        "D repack notes + velocity": lambda: [
                            gd.pack_slices(h["cells"], p.cluster, p.chunk)
                            for h, p in zip(f32[:2], plans)]})
        for k, fn in fns.items():
            fn()
            out[k] = median_ms(fn)
    return out


def digests():
    """{name: sha256 prefix} of the wide D's outputs on numpy-seeded heads."""
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd

    out = {}
    with torch.no_grad():
        for bf16 in (False, True):
            for head in HEADS[:3]:
                if bf16 and head[1] < 8:
                    continue
                h = gru_head(head, 512, 256, bf16, 512 + head[1])
                got = gd.gru_decode_fwd_train_wide([h])
                hasher = hashlib.sha256()
                for t in _timing.flat(got):
                    hasher.update(t.detach().contiguous().view(-1).cpu().view(torch.uint8)
                                  .numpy().tobytes())
                out[f"D wide {head[0]} H512 {'bf16' if bf16 else 'f32'}"] = hasher.hexdigest()[:16]
    torch.cuda.synchronize()
    return out


def _in_turns_processes(parent, argv_of, what, order=("parent", "change", "change", "parent")):
    """Run ``argv_of(root)`` from ``parent`` and this checkout in turns
    (``order``: parent, change, change, parent); the last stdout line of
    each, parsed."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    runs = {"parent": [], "change": []}
    for label in order:
        root = parent if label == "parent" else here
        env = dict(os.environ, PYTHONPATH=root)
        got = subprocess.run(argv_of(root), cwd=root, env=env, capture_output=True, text=True,
                             timeout=1500)
        if got.returncode != 0:
            raise RuntimeError(f"{what} in {root} failed:\n{got.stderr[-4000:]}")
        runs[label].append(json.loads(got.stdout.strip().splitlines()[-1]))
    return runs


def time_kernels(emit, args):
    parent = args.parent
    if not parent:
        emit({"what": "kernels", "ms": kernel_times()})
        return
    me = os.path.abspath(__file__)
    runs = _in_turns_processes(parent, lambda root: [sys.executable, me, "--only", "kernels"],
                               "time_d_and_m --only kernels")
    emit({"what": "kernels, parent and change in turns",
          "ms": {label: [r["ms"] for r in rs] for label, rs in runs.items()}})


def time_digests(emit, args):
    parent = args.parent
    if not parent:
        emit({"what": "digests of D wide", "digests": digests()})
        return
    me = os.path.abspath(__file__)
    runs = _in_turns_processes(parent, lambda root: [sys.executable, me, "--only", "digests"],
                               "time_d_and_m --only digests", ("parent", "change"))
    emit({"what": "digests of D wide, parent and change",
          "digests": {label: rs[0]["digests"] for label, rs in runs.items()},
          "equal": runs["parent"][0]["digests"] == runs["change"][0]["digests"]})


def time_steps(emit, args):
    """The steps' and the LSTM transfer's device ms from ``--parent`` and
    this checkout in turns."""
    parent = args.parent
    if not parent:
        raise ValueError("section steps needs --parent")
    for spec in STEP_CONFIGS:
        sets = [a for kv in spec.split(",") if kv for a in ("--set", kv)]
        runs = _in_turns_processes(parent, lambda root: [
            sys.executable, "-m", "midi_vae_tpu_torch.tools.profile_train", "--steps", "10",
            *sets], f"profile_train {spec}")
        emit({"what": f"step {spec or 'Config()'}, parent and change in turns",
              "device_busy_ms": {k: [r["device_busy_ms_per_step"] for r in rs]
                                 for k, rs in runs.items()},
              "idle_share": {k: [r["device_idle_share"] for r in rs] for k, rs in runs.items()},
              "groups": {k: [r["device_ms_by_group"] for r in rs] for k, rs in runs.items()}})
    runs = _in_turns_processes(parent, lambda root: [
        sys.executable, os.path.join(root, "tools", "profile_transfer_torch.py"), "--batch",
        "256", "--set", "cell_type=LSTM"], "profile_transfer_torch LSTM")
    emit({"what": "LSTM transfer B = 256, parent and change in turns",
          "device_busy_ms": {k: [r["device_busy_ms_per_transfer"] for r in rs]
                             for k, rs in runs.items()},
          "wall_ms": {k: [r["wall_ms_median"] for r in rs] for k, rs in runs.items()},
          "kernels": {k: [r["device_ms_by_kernel"] for r in rs] for k, rs in runs.items()}})


SECTIONS = {"check": lambda emit, _a: check(emit), "dplans": lambda emit, _a: time_dplans(emit),
            "mplans": lambda emit, _a: time_mplans(emit), "kernels": time_kernels,
            "digests": time_digests, "steps": time_steps}


def main(argv=None) -> int:
    return _timing.main(__doc__, SECTIONS, argv, default=list(SECTIONS)[:5])


if __name__ == "__main__":
    sys.exit(main())
