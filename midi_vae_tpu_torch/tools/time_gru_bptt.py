"""Time the GRU backward chains of kernels C and E (csrc/gru_cell_bwd_chain.cuh)
at every cluster size their plan could take, at the paths' shapes.

Run from the repo root on a CUDA card:
    python -m midi_vae_tpu_torch.tools.time_gru_bptt [--out FILE]

For each case of CASES (the plan cases of tests/test_torch_gru_bwd_chain.py:
C's encoder layers and E's head groups, float32 and bf16, H 256 and 512, B
256, 512, 128 and 5) and each cluster size C that
``_layout._bptt_candidate`` gives a plan at (the rows and clusters of each
part as ``gru_bptt_plan`` would set them at that size, at the card's active
clusters), the chain's wrapper runs with that plan forced. Each size's time
is the device's: one launch in a CUDA-event window, the median of REPS,
the sizes once in order and once reversed, the two medians averaged; its
max |diff| from the plan ``gru_bptt_plan`` picks. ``near_best`` lists the
sizes within NEAR of the fastest's time; tests/test_torch_gru_bwd_chain.py
holds ``gru_bptt_plan``'s picks against those sets. Seeded random inputs
(the gates from C's pre-pass over random x and h). Prints one JSON line per
case, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# (chain build, H, B, heads): heads (D, n_layers, T, out activation) for E,
# None for C (one layer, T 64)
CASES = [("C_chain", 256, 256, None), ("C_chain", 256, 512, None),
         ("C_chain", 512, 256, None), ("C_chain", 256, 5, None),
         ("C_chain_bf16", 256, 256, None), ("C_chain_bf16", 512, 128, None),
         ("E_chain", 256, 256, ((61, 2, 64, "softmax"), (1, 1, 64, "sigmoid"))),
         ("E_chain", 256, 256, ((61, 2, 64, "softmax"), (1, 1, 64, "sigmoid"),
                                (2, 1, 64, "sigmoid"))),
         ("E_chain", 256, 256, ((16, 1, 4, "softmax"),)),
         ("E_chain", 512, 256, ((61, 2, 64, "softmax"),)),
         ("E_chain", 512, 256, ((1, 1, 64, "sigmoid"),)),
         ("E_chain", 256, 5, ((61, 2, 64, "softmax"),)),
         ("E_chain_bf16", 256, 256, ((61, 2, 64, "softmax"),)),
         ("E_chain_bf16", 512, 256, ((61, 2, 64, "softmax"),)),
         ("E_chain_bf16", 512, 256, ((16, 1, 4, "softmax"),)),
         ("E_chain_bf16", 512, 128, ((16, 1, 4, "softmax"),))]
REPS = 9
NEAR = 0.10
T_C = 64


def median_ms(fn, reps=REPS):
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


def _c_call(H, B, dtype, gen):
    """C's chain over random gates: a function of the forced plan's run."""
    import torch

    from midi_vae_tpu_torch.ops import gru_layer as gl

    dev = torch.device("cuda")
    rand = lambda *s: torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    gates = torch.cat([rand(T_C, B, 2 * H), 2 * rand(T_C, B, H) - 1], -1)
    hprev = torch.tanh(randn(T_C, B, H)).to(dtype)
    d_seq = randn(T_C, B, H).to(dtype)
    u = (randn(H, 3 * H) / H ** 0.5).to(dtype)
    return lambda: gl.gru_layer_bwd_chain(gates, hprev, d_seq, None, u)


def _e_call(H, B, dtype, heads, gen):
    """E's chain over a call's heads (their plain forward, the pre-pass's
    gates): a function of the forced plan's run."""
    import torch

    from midi_vae_tpu_torch.ops import gru_decode as gd

    dev = torch.device("cuda")
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    dicts = []
    for D, n, T, act in heads:
        cells = [{"w": (randn(D if i == 0 else H, 3 * H) / (D if i == 0 else H) ** 0.5).to(dtype),
                  "u": (randn(H, 3 * H) / H ** 0.5).to(dtype), "b": (0.1 * randn(3 * H)).to(dtype)}
                 for i in range(n)]
        out = {"w": (randn(H, D) / H ** 0.5).to(dtype), "b": (0.1 * randn(D)).to(dtype)}
        init = [torch.tanh(randn(B, H)).to(dtype) for _ in range(n)]
        start = torch.softmax(randn(B, D), -1).to(dtype)
        with torch.no_grad():
            probs, _lg, h_seqs = gd.gru_decode_train_reference(cells, out, init, start, T, act)
        dicts.append({"cells": cells, "out": out, "init": init, "start": start, "T": T,
                      "out_activation": act, "probs": probs, "h_seqs": h_seqs,
                      "g_probs": randn(T, B, D).to(dtype), "g_logits": randn(T, B, D).to(dtype)})
    inputs = [gd._layer_inputs(h) for h in dicts]
    gates = gd.gru_decode_bwd_gates(dicts, inputs)
    hprevs = [[hp for _x, hp in ins] for ins in inputs]
    build = ("E_wide" if H == 512 else "E") + ("_bf16" if dtype == torch.bfloat16 else "")
    return lambda: gd.gru_decode_bwd_chain(dicts, gates, build, hprevs)


def _flat(out):
    if isinstance(out, tuple):
        return list(out)
    return [t for o in out for t in (o["dlogits"], *o["da"], *o["d_init"], o["d_start"])]


def time_clusters(emit):
    import torch

    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.ops import gru_decode as gd
    from midi_vae_tpu_torch.ops import gru_layer as gl

    picked_plan = gl.gru_bptt_plan
    for build, H, B, heads in CASES:
        dtype = torch.bfloat16 if build.endswith("_bf16") else torch.float32
        gen = torch.Generator(device="cuda").manual_seed(H + B)
        shape = None if heads is None else tuple((d, n, T) for d, n, T, _a in heads)
        call = _c_call(H, B, dtype, gen) if heads is None else _e_call(H, B, dtype, heads, gen)
        lib = "gru_layer_bwd" if build[0] == "C" else "gru_decode_bwd"
        parts = _layout._bptt_parts(build, H, shape)
        elem = 2 if dtype == torch.bfloat16 else 4
        plans = {}
        for C in _layout.CLUSTER_SIZES:
            if not _layout._bptt_cluster_ok(H, C):
                continue
            got = _layout._bptt_candidate(H, B, C, parts, gl._max_clusters(lib, elem == 2, C),
                                          elem)
            if got is not None:
                plans[C] = got[0]
        pick = picked_plan(build, H, B, shape)
        want = [t.clone() for t in _flat(call())]
        err = {}
        try:
            for C, plan in plans.items():
                gl.gru_bptt_plan = gd.gru_bptt_plan = lambda *_a, _p=plan: _p
                got = _flat(call())
                err[C] = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            fwd, back = {}, {}
            for order, into in ((list(plans), fwd), (list(reversed(plans)), back)):
                for C in order:
                    gl.gru_bptt_plan = gd.gru_bptt_plan = lambda *_a, _p=plans[C]: _p
                    call()
                    into[C] = median_ms(call)
        finally:
            gl.gru_bptt_plan = gd.gru_bptt_plan = picked_plan
        ms = {C: (fwd[C] + back[C]) / 2 for C in plans}
        best = min(ms.values())
        emit({"what": f"{build} clusters", "H": H, "B": B, "heads": shape,
              "picked": pick.cluster, "ms": {str(C): ms[C] for C in plans},
              "near_best": [C for C in plans if ms[C] <= (1 + NEAR) * best],
              "plans": {str(C): {"rows": p.rows, "clusters": p.clusters, "waves": p.waves,
                                 "resident": p.resident, "stages": p.stages, "nbuf": p.nbuf}
                        for C, p in plans.items()},
              "max_abs_diff_from_pick": {str(C): err[C] for C in plans}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args(argv)
    import torch

    from midi_vae_tpu_torch import use_exact_f32

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    use_exact_f32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = open(args.out, "w") if args.out else None

    def emit(rec):
        line = json.dumps({**rec, "card": smi})
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    time_clusters(emit)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
