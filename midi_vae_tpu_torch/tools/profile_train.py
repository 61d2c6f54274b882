#!/usr/bin/env python3
"""Where the time of one training step goes, on a CUDA card.

Runs ``VAETrainer.train_step`` (forward, loss, backward, Adam) of the default
Config() model (seeded numpy init; ``--set`` overrides fields, e.g.
``lstm_size=512`` for the wide model) on one random 256-window batch, and
prints one JSON line: the card, the route of the step, the median wall time
per step (host clock around work that ends in a synchronize), note-steps/s (B
x 64 output steps per step), and from a torch.profiler window of STEPS steps
the device time per kernel name, per kernel of the port (A, C, D, E, F, G,
the wide D and E, W) and for everything else, and the device's idle share.

Usage: python -m midi_vae_tpu_torch.tools.profile_train [--batch 256] [--steps 10]
           [--set lstm_size=512]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# kernel name prefixes of the port's hand-written kernels
PORT_KERNELS = {
    "gru_layer_fwd_kernel": "A gru_layer_fwd",
    "gru_decode_kernel": "B gru_decode",
    "gru_layer_bwd_kernel": "C gru_layer_bwd",
    "gru_decode_train_kernel": "D gru_decode_train",
    "gru_decode_bwd_kernel": "E gru_decode_bwd",
    "gru_layer_xp_fwd_kernel": "F gru_layer_xp_fwd",
    "gru_layer_xp_bwd_kernel": "G gru_layer_xp_bwd",
    "gru_decode_train_wide_kernel": "D wide gru_decode_train_wide",
    "gru_decode_bwd_wide_kernel": "E wide gru_decode_bwd_wide",
    "grad_reduce": "W grad_reduce",
}


def random_train_batch(cfg, n: int, seed: int, valid: int | None = None) -> dict:
    """A numpy training batch of n random windows (X, Y, I, V, D, C, S and
    H when the config has history); rows from ``valid`` on are zeroed and
    masked out in ``M``, as an epoch's padded last batch."""
    rng = np.random.RandomState(seed)
    eye = lambda d, idx: np.eye(d, dtype=np.float32)[idx]  # noqa: E731
    batch = {
        "X": eye(cfg.input_dim, rng.randint(0, cfg.input_dim, (n, cfg.input_length))),
        "Y": eye(cfg.output_dim, rng.randint(0, cfg.output_dim, (n, cfg.output_length))),
        "I": eye(cfg.instrument_dim, rng.randint(0, cfg.instrument_dim, (n, cfg.max_voices))),
        "V": rng.rand(n, cfg.output_length, 1).astype(np.float32),
        "D": eye(2, rng.randint(0, 2, (n, cfg.output_length))),
        "C": eye(cfg.num_classes, rng.randint(0, cfg.num_classes, n)),
        "S": rng.randn(n, cfg.signature_vector_length).astype(np.float32),
    }
    if cfg.history:
        batch["H"] = (0.1 * rng.randn(n, cfg.latent_dim)).astype(np.float32)
    valid = n if valid is None else valid
    for v in batch.values():
        v[valid:] = 0
    batch["M"] = (np.arange(n) < valid).astype(np.float32)
    return batch


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any Config field")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from midi_vae_tpu_torch.config import Config, parse_overrides
    from midi_vae_tpu_torch import use_exact_f32
    from midi_vae_tpu_torch.ops import _layout
    from midi_vae_tpu_torch.training.trainer import VAETrainer

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool measures the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    use_exact_f32()
    cfg = Config(batch_size=args.batch, **parse_overrides(args.set))
    trainer = VAETrainer(cfg, "cuda")
    state = trainer.init_state()
    batch = trainer.to_device(random_train_batch(cfg, args.batch, 0))
    for _ in range(3):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    walls.sort()
    wall = walls[len(walls) // 2]

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(state, batch)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) / args.steps * 1e3
    kernels = {}
    for ev in prof.key_averages():
        us = _device_us(ev)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.key.split("(")[0]  # drop the argument list
            kernels[name] = kernels.get(name, 0.0) + us / args.steps / 1e3
    busy = sum(kernels.values())
    groups: dict[str, float] = {}
    for name, ms in kernels.items():
        short = name.split("<")[0].replace("void ", "").replace("mvt::", "")
        group = next((g for prefix, g in PORT_KERNELS.items() if short == prefix
                      or short.startswith(prefix + "_")),
                     "other (ATen, cuBLAS, copies)")
        groups[group] = groups.get(group, 0.0) + ms
    print(json.dumps({
        "batch": args.batch, "lstm_size": cfg.lstm_size, "route": _layout.config_route(cfg),
        "card": card, "step_wall_ms_median": wall * 1e3,
        "note_steps_per_s": args.batch * cfg.output_length / wall,
        "profiled_ms_per_step": window, "device_busy_ms_per_step": busy,
        "device_idle_share": 1.0 - busy / window,
        "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "device_ms_by_kernel": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12]),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
