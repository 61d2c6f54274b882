#!/usr/bin/env python
"""Convert a JAX run directory (train.py --output) into a run directory of
the PyTorch port (midi_vae_tpu_torch): OUT/config.json + OUT/params.npz.

The run is restored with the JAX package's template-checked
``training.checkpoint.restore_vae_state``, on the CPU; the params tree is
written through the port's bridge under the same key paths. A
``signature_stats.npz`` next to the checkpoints is copied along.

Usage: python tools/jax_run_to_torch.py RUN OUT [--epoch N]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run", help="JAX run directory (config.json + epoch_N checkpoints)")
    p.add_argument("out", help="port run directory to write")
    p.add_argument("--epoch", type=int, default=None, help="checkpoint epoch (default: latest)")
    args = p.parse_args(argv)

    import jax

    # the conversion is host-side: never initialize an accelerator for it
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from midi_vae_tpu.training import checkpoint as jax_ckpt
    from midi_vae_tpu_torch.training import checkpoint as port_ckpt

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
