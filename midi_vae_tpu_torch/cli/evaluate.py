#!/usr/bin/env python
"""Run the evaluation/generation harness on a trained model, on PyTorch.

Counterpart of ``midi_vae_tpu/cli/evaluate.py``, with the same flags except
``--cpu``, which becomes ``--device``: ``cuda`` (the default; fails when
there is no card) runs the hand-written kernels, ``cpu`` their plain
versions. Example:

    python -m midi_vae_tpu_torch.cli.evaluate --source data/original \\
        --model runs/port --classifiers runs/judges --output eval/port \\
        --sections autoencoding,latent_sweep,chords

Sections: stats (always), harmonicity, medleys, random_interpolations,
latent_sweep, chords, sampling_regions, pitches, random_songs, long_songs,
autoencoding. Default: autoencoding.
"""

from __future__ import annotations

import argparse
import os
import sys

SECTIONS = (
    "stats", "harmonicity", "medleys", "random_interpolations", "latent_sweep", "chords",
    "sampling_regions", "pitches", "random_songs", "long_songs", "autoencoding",
)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source", required=True, help="MIDI corpus folder")
    p.add_argument("--model", required=True, help="VAE run dir (cli.train --output)")
    p.add_argument("--epoch", type=int, default=None, help="checkpoint epoch")
    p.add_argument("--classifiers", default=None,
                   help="judge dir (cli.classify --output): pitch/, velocity/, instrument/, "
                        "each spec.json + params.npz")
    p.add_argument("--output", required=True)
    p.add_argument("--cache", default=None)
    p.add_argument("--workers", type=int, default=0, help="parallel import workers")
    p.add_argument("--sections", default="autoencoding")
    p.add_argument("--test-train-set", action="store_true")
    p.add_argument("--num-songs", type=int, default=3,
                   help="count for generation sections")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    wanted = {s.strip() for s in args.sections.split(",")}
    unknown = wanted - set(SECTIONS)
    if unknown:
        raise SystemExit(f"unknown --sections {sorted(unknown)}; choose from {sorted(SECTIONS)}")

    from midi_vae_tpu_torch.data.dataset import import_midi_from_folder
    from midi_vae_tpu_torch.evaluation import EvalSections, Evaluator
    from midi_vae_tpu_torch.training import checkpoint as ckpt

    cfg = ckpt.load_config(args.model)
    print(f"importing corpus from {args.source} ...")
    ds = import_midi_from_folder(args.source, cfg, cache_dir=args.cache, workers=args.workers)
    print(f"train songs: {ds.train_set_size}  test songs: {ds.test_set_size}")

    params = ckpt.load_run_params(args.model, args.epoch)
    print(f"restored model {'from params.npz' if args.epoch is None else f'at epoch {args.epoch}'}")

    classifiers = {}
    if args.classifiers:
        for kind in ("pitch", "velocity", "instrument"):
            path = os.path.join(args.classifiers, kind)
            if os.path.isdir(path):
                classifiers[kind] = ckpt.load_classifier(path)
                print(f"loaded {kind} classifier")

    n = args.num_songs
    sections = EvalSections(
        harmonicity_evaluations="harmonicity" in wanted,
        frankenstein_harmonicity_evaluations="harmonicity" in wanted,
        max_new_chosen_interpolation_songs=n if "medleys" in wanted else 0,
        max_new_sampled_interpolation_songs=n if "random_interpolations" in wanted else 0,
        latent_sweep="latent_sweep" in wanted,
        chord_evaluation="chords" in wanted,
        evaluate_different_sampling_regions="sampling_regions" in wanted,
        pitch_evaluation="pitches" in wanted,
        max_new_sampled_songs=n if "random_songs" in wanted else 0,
        max_new_sampled_long_songs=n if "long_songs" in wanted else 0,
        evaluate_autoencoding_and_stuff="autoencoding" in wanted,
    )

    # raises when --device cuda finds no card: no silent CPU run
    evaluator = Evaluator(
        cfg, params, ds, args.output,
        classifiers=classifiers, test_train_set=args.test_train_set,
        seed=args.seed, device=args.device,
    )
    results = evaluator.run(sections)
    print(f"\nwrote artifacts to {args.output}")
    if "mean_reconstruction_accuracy" in results:
        print("mean pitch reconstruction accuracy:", results["mean_reconstruction_accuracy"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
