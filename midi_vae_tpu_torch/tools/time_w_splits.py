"""Time kernel W (csrc/grad_reduce.cu) at each split count of its rows, on
the reductions the training paths give it, beside the count that
``ops/grad_reduce.py::splits`` picks.

Run from the repo root on a CUDA card:
    python -m midi_vae_tpu_torch.tools.time_w_splits [--out FILE]

For each shape (N rows, I, J) of SHAPES, with and without the bias row,
every split count S in CANDIDATES that the instance allows (each chunk at
least its fewest rows) is timed with CUDA events: the median of REPS
windows of CALLS back-to-back calls, the candidates once in order and once
reversed, the two medians averaged. Prints one JSON line per case: the
pick, the fastest count, the time of each, and ``near_best``, the counts
within NEAR of the fastest's time. tests/test_torch_grad_reduce_tc.py
holds ``splits``' picks against those sets.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# the paths' reductions (N rows, I, J) at B = 256 windows of 64 steps: the
# dW of notes layer 1, GRU(256)'s two dU parts, the notes head's dWo, the
# velocity and instrument layers' dW, LSTM(512)'s dU, an LSTM judge's dU at
# B = 512; and fewer rows: an LSTM(256) dU over 4 steps (the instrument
# branch), a GRU(256) dU at B = 5, a dW over 5 rows
SHAPES = [(16384, 61, 768), (16384, 256, 512), (16384, 256, 256), (16384, 256, 61),
          (16384, 1, 768), (1024, 16, 768), (16384, 512, 2048), (32768, 256, 1024),
          (1024, 256, 1024), (320, 256, 768), (5, 61, 768)]
CANDIDATES = sorted({*range(1, 17), 18, 20, 22, 24, 26, 28, 30, 32, 33, 36, 40, 44, 48, 56, 64,
                     66, 80, 96, 112, 128, 132})
REPS, CALLS = 20, 10
NEAR = 0.05


def time_case(gr, N, I, J, with_bias):
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(N + I + J)
    a = torch.tanh(torch.randn(N, I, generator=gen, device=dev))
    b = 1e-2 * torch.randn(N, J, generator=gen, device=dev)
    out = torch.empty(I, J, device=dev)
    bias = torch.empty(J, device=dev) if with_bias else None
    least = gr._MIN_ROWS_SMALL if I <= gr.SMALL_I else gr._MIN_ROWS_TILED
    pick = gr.splits(N, I, J, with_bias)
    counts = sorted({s for s in CANDIDATES if s <= max(1, N // least)} | {pick})
    chosen = gr.splits

    def window(s):
        gr.splits = lambda *_: s
        try:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS):
                gr.grad_reduce(a, b, out, bias)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / CALLS
        finally:
            gr.splits = chosen

    def median(s):
        times = sorted(window(s) for _ in range(REPS))
        return times[REPS // 2]

    for s in counts:  # warm up, and the workspace's first allocation
        window(s)
    first = {s: median(s) for s in counts}
    second = {s: median(s) for s in reversed(counts)}
    ms = {s: (first[s] + second[s]) / 2 for s in counts}
    best = min(ms, key=ms.get)
    return {"N": N, "I": I, "J": J, "bias": with_bias, "pick": pick, "pick_ms": ms[pick],
            "best": best, "best_ms": ms[best],
            "near_best": [s for s in counts if ms[s] <= (1 + NEAR) * ms[best]],
            "ms": {str(s): round(t, 5) for s, t in ms.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    import torch

    from midi_vae_tpu_torch.ops import grad_reduce as gr

    if not torch.cuda.is_available():
        print("time_w_splits: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    lines = []
    for N, I, J in SHAPES:
        for with_bias in (False, True):
            lines.append(json.dumps(time_case(gr, N, I, J, with_bias) | {"card": smi}))
            print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
