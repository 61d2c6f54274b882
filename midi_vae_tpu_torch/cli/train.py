#!/usr/bin/env python
"""Train the MIDI-VAE on a labeled MIDI corpus, on PyTorch.

Counterpart of ``midi_vae_tpu/cli/train.py``, with the same flags except the
JAX package's own (``--cpu``, ``--profile`` and the multi-host ones), plus
``--device``: ``cuda`` (the default; fails when there is no card) runs the
hand-written kernels, ``cpu`` their plain versions. The output directory is
a run that the transfer CLI serves (``config.json`` + ``params.npz``), with a
checkpoint ``epoch_N/`` every ``save_step`` epochs and at the end.

Examples:
    python -m midi_vae_tpu_torch.cli.train --source data/original \\
        --output runs/port --classes Jazz,Pop --epochs 400 --set beta=0.1
    python -m midi_vae_tpu_torch.cli.train --source data/original \\
        --output runs/port --resume
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source", required=True, help="MIDI corpus folder")
    p.add_argument("--output", required=True, help="run/checkpoint directory")
    p.add_argument("--classes", default=None, help="comma-separated style labels")
    p.add_argument("--config", default=None, help="config JSON to start from")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--cache", default=None, help="dataset cache directory")
    p.add_argument("--workers", type=int, default=0, help="parallel import workers")
    p.add_argument("--resume", action="store_true", help="resume from --output")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any Config field")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    import numpy as np

    from midi_vae_tpu_torch.config import Config, parse_overrides
    from midi_vae_tpu_torch.data.batching import flatten_dataset
    from midi_vae_tpu_torch.data.dataset import import_midi_from_folder
    from midi_vae_tpu_torch import use_exact_f32
    from midi_vae_tpu_torch.training.trainer import VAETrainer

    run_config = os.path.join(args.output, "config.json")
    if args.config:
        cfg = Config.load(args.config)
    elif args.resume and os.path.exists(run_config):
        # resume under the run's saved hyperparameters; --set/--classes/
        # --epochs still override
        cfg = Config.load(run_config)
        print(f"resuming with {run_config}")
    else:
        cfg = Config()
    overrides = parse_overrides(args.set)
    if args.classes:
        overrides["classes"] = tuple(args.classes.split(","))
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    if overrides:
        cfg = cfg.replace(**overrides)

    use_exact_f32()
    # raises when --device cuda finds no card: no silent CPU run
    trainer = VAETrainer(cfg, args.device)
    print(f"importing corpus from {args.source} ...")
    # stratified split with scikit-learn, else the seeded shuffle split
    ds = import_midi_from_folder(args.source, cfg, cache_dir=args.cache, verbose=True,
                                 workers=args.workers)
    print(f"train songs: {ds.train_set_size}  test songs: {ds.test_set_size}")
    if ds.train_set_size == 0:
        print("no songs imported -- check --source and --classes")
        return 1
    train, test, sig_mean, sig_std = flatten_dataset(ds, cfg)
    print(f"train windows: {train.num_windows}  test windows: {test.num_windows}")

    if args.resume:
        state = trainer.restore(args.output)
        print(f"resumed from epoch {state.epoch}")
    else:
        state = trainer.init_state()
    os.makedirs(args.output, exist_ok=True)
    np.savez(os.path.join(args.output, "signature_stats.npz"), mean=sig_mean, std=sig_std)
    trainer.fit(state, train, test=test, output_dir=args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
