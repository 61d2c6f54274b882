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
import contextlib
import importlib.util
import os
import sys
import types


@contextlib.contextmanager
def _split_without_sklearn():
    """``import_midi_from_folder`` imports scikit-learn for its stratified
    train/test split (dataset.py:186); the card's machine has none. There a
    stand-in whose ``train_test_split`` raises ValueError sends the import to
    the package's own fallback, the seeded shuffle split (dataset.py:196-206),
    and is removed again afterwards."""
    if importlib.util.find_spec("sklearn") is not None:
        yield False
        return

    def train_test_split(*args, **kwargs):
        raise ValueError("scikit-learn is not installed")

    selection = types.ModuleType("sklearn.model_selection")
    selection.train_test_split = train_test_split
    root = types.ModuleType("sklearn")
    root.model_selection = selection
    stand_ins = {"sklearn": root, "sklearn.model_selection": selection}
    before = {name: sys.modules.get(name) for name in stand_ins}
    sys.modules.update(stand_ins)
    try:
        yield True
    finally:
        for name, module in before.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def import_corpus(source: str, cfg, cache_dir: str | None = None, workers: int = 0,
                  verbose: bool = False):
    """``midi_vae_tpu.data.dataset.import_midi_from_folder``, with the seeded
    shuffle split where scikit-learn is missing."""
    from midi_vae_tpu.data.dataset import import_midi_from_folder

    with _split_without_sklearn() as fallback:
        ds = import_midi_from_folder(source, cfg, cache_dir=cache_dir, verbose=verbose,
                                     workers=workers)
    if fallback and verbose:
        print("scikit-learn is not installed: seeded shuffle train/test split")
    return ds


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

    from midi_vae_tpu.config import Config, parse_overrides
    from midi_vae_tpu.data.batching import flatten_dataset
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
    ds = import_corpus(args.source, cfg, args.cache, args.workers, verbose=True)
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
