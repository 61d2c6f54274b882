#!/usr/bin/env python
"""Train the style classifiers (the judges of style-transfer evaluation), on
PyTorch.

Counterpart of ``midi_vae_tpu/cli/classify.py``, with the same flags except
``--cpu``, which becomes ``--device``: ``cuda`` (the default; fails when
there is no card) runs the hand-written kernels, ``cpu`` their plain
versions. Each kind is saved under <output>/<kind>/ with ``spec.json`` and
``params.npz`` (what ``cli.transfer --classifiers <output>`` reads),
``epoch_N/`` checkpoints, ``history.json`` and confusion-matrix plots (where
matplotlib is installed). Examples:

    python -m midi_vae_tpu_torch.cli.classify --source data/original \\
        --output runs/judges --classes Jazz,Pop --kinds pitch,velocity,instrument \\
        --epochs 30
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--classes", default=None)
    p.add_argument("--kinds", default="pitch,velocity,instrument")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--cache", default=None)
    p.add_argument("--workers", type=int, default=0, help="parallel import workers")
    p.add_argument("--lstm-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--learning-rate", type=float, default=None,
                   help="override the per-kind reference defaults "
                        "(pitch/velocity 2e-5, instrument 1e-5)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    from midi_vae_tpu_torch import use_exact_f32
    from midi_vae_tpu_torch.config import Config
    from midi_vae_tpu_torch.data.batching import flatten_dataset
    from midi_vae_tpu_torch.data.dataset import import_midi_from_folder
    from midi_vae_tpu_torch.models.classifier import ClassifierSpec
    from midi_vae_tpu_torch.training.classifier_trainer import (
        ClassifierTrainer,
        classifier_arrays,
    )

    cfg = Config()
    if args.classes:
        cfg = cfg.replace(classes=tuple(args.classes.split(",")))

    use_exact_f32()
    kinds = [k.strip() for k in args.kinds.split(",")]
    # raises when --device cuda finds no card: no silent CPU run
    trainers = {}
    for kind in kinds:
        overrides = dict(lstm_size=args.lstm_size, batch_size=args.batch_size)
        if args.learning_rate is not None:
            overrides["learning_rate"] = args.learning_rate
        trainers[kind] = ClassifierTrainer(ClassifierSpec.for_kind(kind, cfg, **overrides),
                                           args.device)

    print(f"importing corpus from {args.source} ...")
    ds = import_midi_from_folder(args.source, cfg, cache_dir=args.cache, workers=args.workers)
    print(f"train songs: {ds.train_set_size}  test songs: {ds.test_set_size}")
    train, test, _, _ = flatten_dataset(ds, cfg)

    for kind, trainer in trainers.items():
        state = trainer.init_state()
        tr_x, tr_c = classifier_arrays(train, kind)
        te_x, te_c = classifier_arrays(test, kind)
        print(f"[{kind}] train samples: {len(tr_x)}  test samples: {len(te_x)}")
        trainer.fit(state, tr_x, tr_c, te_x, te_c, epochs=args.epochs,
                    output_dir=os.path.join(args.output, kind), class_names=list(cfg.classes))
    return 0


if __name__ == "__main__":
    sys.exit(main())
