#!/usr/bin/env python
"""Export a run as a serving bundle (``midi_vae_tpu_torch/serving.py``):
``torch.export`` programs of encode, decode_argmax and style_transfer with
the weights baked in, one per batch bucket; with ``--classifiers`` the style
judges sealed beside them. Counterpart of ``tools/export_serving.py``.

    python -m midi_vae_tpu_torch.tools.export_serving --model RUN --out BUNDLE \\
        [--batch 16 256] [--epoch N] [--device cuda|cpu] [--classifiers JUDGES]

Each ``--batch`` value becomes a bucket; the loader pads any request to the
smallest adequate one. ``--device cuda`` (the default) exports on the card,
so the bundle loads only on a card; ``--device cpu`` exports the plain
versions for a host without one. Prints the manifest as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True, help="run dir (config.json + params.npz)")
    ap.add_argument("--out", required=True, help="bundle output dir")
    ap.add_argument("--batch", type=int, nargs="+", default=[256], help="batch bucket size(s)")
    ap.add_argument("--epoch", type=int, default=None,
                    help="export the epoch_N/ checkpoint (default: the run's params.npz)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the programs run (default cuda)")
    ap.add_argument("--classifiers", default=None,
                    help="judge dir (pitch/, velocity/, instrument/): also seal the judges, so "
                         "transfer --bundle judges from the bundle alone")
    args = ap.parse_args(argv)

    from midi_vae_tpu_torch.models.classifier import CLASSIFIER_KINDS
    from midi_vae_tpu_torch.serving import export_classifier_judges, export_serving_bundle
    from midi_vae_tpu_torch.training import checkpoint as ckpt

    cfg = ckpt.load_config(args.model)
    manifest = export_serving_bundle(cfg, ckpt.load_run_params(args.model, args.epoch), args.out,
                                     batch_size=args.batch, device=args.device)
    # a signature-conditioned run keeps its train-time normalization stats
    # beside the programs, so that transfer --bundle normalizes its inputs
    stats = os.path.join(args.model, "signature_stats.npz")
    if os.path.exists(stats):
        shutil.copy(stats, os.path.join(args.out, "signature_stats.npz"))
    if args.classifiers:
        judges = {kind: ckpt.load_classifier(os.path.join(args.classifiers, kind))
                  for kind in CLASSIFIER_KINDS
                  if os.path.isdir(os.path.join(args.classifiers, kind))}
        if not judges:
            raise SystemExit(f"no judge dirs under {args.classifiers!r} "
                             "(expected pitch/ velocity/ instrument/)")
        manifest = export_classifier_judges(judges, args.out, batch_size=args.batch,
                                            device=args.device)
    print(json.dumps({"bundle": os.path.abspath(args.out), **manifest}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
