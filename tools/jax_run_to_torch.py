#!/usr/bin/env python
"""Convert a JAX run directory (train.py --output) into a run directory of
the PyTorch port (midi_vae_tpu_torch): OUT/config.json + OUT/params.npz; and
a JAX judge directory (classify.py --output: pitch/, velocity/, instrument/)
into the port's judge directory.

The run is restored with the JAX package's template-checked
``training.checkpoint.restore_vae_state``, each judge with its
``training.classifier_trainer.load_classifier``, on the CPU; the params trees
are written through the port's bridge under the same key paths (a judge as
``spec.json`` + ``params.npz``, ``midi_vae_tpu_torch/training/
checkpoint.py::save_classifier``). A ``signature_stats.npz`` next to the
checkpoints is copied along. Runs where jax is installed; it is not part of
the port's package.

Usage: python tools/jax_run_to_torch.py RUN OUT [--epoch N]
       python tools/jax_run_to_torch.py --classifiers JAX_DIR OUT_DIR
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run", nargs="?", help="JAX run directory (config.json + epoch_N checkpoints)")
    p.add_argument("out", nargs="?", help="port run directory to write")
    p.add_argument("--epoch", type=int, default=None, help="checkpoint epoch (default: latest)")
    p.add_argument("--classifiers", nargs=2, metavar=("JAX_DIR", "OUT_DIR"), default=None,
                   help="convert a JAX judge directory instead of a run")
    args = p.parse_args(argv)
    if (args.classifiers is None) == (args.run is None or args.out is None):
        p.error("pass RUN OUT, or --classifiers JAX_DIR OUT_DIR")

    import jax

    # the conversion is host-side: never initialize an accelerator for it
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from midi_vae_tpu_torch.training import checkpoint as port_ckpt

    if args.classifiers is not None:
        from midi_vae_tpu.models.classifier import CLASSIFIER_KINDS
        from midi_vae_tpu.training.classifier_trainer import load_classifier

        src, dst = args.classifiers
        kinds = [k for k in CLASSIFIER_KINDS if os.path.isdir(os.path.join(src, k))]
        if not kinds:
            raise SystemExit(f"no judge directory ({', '.join(CLASSIFIER_KINDS)}) under {src}")
        for kind in kinds:
            model, params = load_classifier(os.path.join(src, kind), args.epoch)
            port_ckpt.save_classifier(os.path.join(dst, kind), model.spec,
                                      jax.tree_util.tree_map(np.asarray, params))
            print(f"{os.path.join(src, kind)} -> {os.path.join(dst, kind)}")
        return 0

    from midi_vae_tpu.training import checkpoint as jax_ckpt

    cfg = jax_ckpt.load_config(args.run)
    state = jax_ckpt.restore_vae_state(args.run, args.epoch)
    params = jax.tree_util.tree_map(np.asarray, state["params"])
    port_ckpt.save_run(args.out, cfg, params)
    stats = os.path.join(args.run, "signature_stats.npz")
    if os.path.exists(stats):
        shutil.copy(stats, os.path.join(args.out, "signature_stats.npz"))
    print(f"{args.run} (epoch {state['epoch']}) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
