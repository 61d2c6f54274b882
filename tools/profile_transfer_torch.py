#!/usr/bin/env python3
"""Where the time of one style transfer goes, on a CUDA card (PyTorch port).

For each batch size, runs ``GenerationContext.transfer_argmax`` (encode ->
latent swap -> history roll -> decode -> argmax) of the default Config()
model (``--set KEY=VALUE`` overrides any field, e.g. ``cell_type=LSTM``) with
seeded random weights on random windows, and prints one JSON line:
the median wall time per transfer (host clock around work that ends in a
synchronize), windows/s and note-steps/s, and from a torch.profiler window of
REPS transfers the device time per kernel name and the device's idle share.

Usage: python tools/profile_transfer_torch.py [--batch 16 256] [--reps 20] [--set KEY=VALUE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, nargs="+", default=[16, 256])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any Config field")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import random_batch
    from midi_vae_tpu_torch.config import Config, parse_overrides
    from midi_vae_tpu_torch.evaluation.generation import GenerationContext
    from midi_vae_tpu_torch.models.vae import MidiVAE

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool measures the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = Config(**parse_overrides(args.set))
    ctx = GenerationContext(cfg, MidiVAE(cfg), "cuda")
    perm = torch.arange(cfg.latent_dim, device="cuda")
    perm[[0, 1]] = perm[[1, 0]]
    for B in args.batch:
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in random_batch(cfg, B, 0).items()}
        A = torch.zeros(B, 1, device="cuda")
        for _ in range(3):
            ctx.transfer_argmax(batch, perm, A)
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            ctx.transfer_argmax(batch, perm, A)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        walls.sort()
        wall = walls[len(walls) // 2]

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.reps):
                ctx.transfer_argmax(batch, perm, A)
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        kernels = {}
        for ev in prof.key_averages():
            us = _device_us(ev)
            if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
                name = ev.key.split("(")[0]  # drop the argument list
                kernels[name] = kernels.get(name, 0.0) + us / args.reps / 1e3
        busy_ms = sum(kernels.values())
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
        print(json.dumps({
            "batch": B, "cell_type": cfg.cell_type, "lstm_size": cfg.lstm_size, "card": card, "wall_ms_median": wall * 1e3,
            "windows_per_s": B / wall, "note_steps_per_s": B * cfg.output_length / wall,
            "profiled_ms_per_transfer": window / args.reps * 1e3,
            "device_busy_ms_per_transfer": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (window / args.reps * 1e3),
            "device_ms_by_kernel": top,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
