#!/usr/bin/env python3
"""Times one training step on a CUDA card, for comparing two checkouts.

For each config given (``KEY=VALUE`` overrides of ``Config()``, joined by
commas), runs ``VAETrainer.train_step`` on one random 256-window batch of
the seeded model: 3 warm-up steps, then the median of 20 steps, each timed
with CUDA events. Prints one JSON line: the card and its power limit, and
ms per step and note-steps/s per config. It uses only what the port has
had since its training slice, so a copy of this file runs in an older
checkout too; to compare two, run each from its own root in one call,
alternating them (parent, change, change, parent).

Usage: python -m midi_vae_tpu_torch.tools.time_train_step
           compute_dtype=bfloat16,fused_train_encoder=False,fused_train_decoder=False
           cell_type=LSTM,compute_dtype=bfloat16,fused_train_encoder=False
           lstm_size=512,compute_dtype=bfloat16
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

REPS = 20


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("configs", nargs="+", metavar="KEY=VALUE[,KEY=VALUE...]")
    args = p.parse_args(argv)

    import torch

    from midi_vae_tpu_torch import use_exact_f32
    from midi_vae_tpu_torch.config import Config, parse_overrides
    from midi_vae_tpu_torch.tools.profile_train import random_train_batch
    from midi_vae_tpu_torch.training.trainer import VAETrainer

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool measures the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    use_exact_f32()
    out = {"card": card, "steps": {}}
    for spec in args.configs:
        cfg = Config(**parse_overrides(spec.split(",")))
        trainer = VAETrainer(cfg, "cuda")
        state = trainer.init_state()
        batch = trainer.to_device(random_train_batch(cfg, cfg.batch_size, 0))
        for _ in range(3):
            trainer.train_step(state, batch)
        times = []
        for _ in range(REPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.train_step(state, batch)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = sorted(times)[REPS // 2]
        out["steps"][spec] = {"ms": ms,
                              "note_steps_per_s": cfg.batch_size * cfg.output_length / ms * 1e3}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
