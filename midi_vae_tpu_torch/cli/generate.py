#!/usr/bin/env python
"""Generate music from a trained MIDI-VAE run, on PyTorch.

Counterpart of ``midi_vae_tpu/cli/generate.py``, with the same flags except
``--cpu``, which becomes ``--device``: ``cuda`` (the default; fails when
there is no card) runs the hand-written kernels, ``cpu`` their plain
versions. The run directory holds ``config.json`` and ``params.npz``, and
``epoch_N/`` checkpoints after training (``--epoch N`` serves one). Modes:

  random         z ~ N(0, z_std) songs                  (vae_evaluation.py:1771-1785)
  style          composer-knob songs, one per class     (vae_evaluation.py:1787-1814)
  interpolate    latent walk between two random points  (vae_evaluation.py:841-887)
  long           nearest-z chained long songs           (vae_evaluation.py:1816-1896)

Examples:
    python -m midi_vae_tpu_torch.cli.generate --model runs/port --output songs/ \\
        --mode style --count 4
    python -m midi_vae_tpu_torch.cli.generate --model runs/port --output songs/ \\
        --mode long --source data/original --cache cache/   # 'long' needs corpus latents
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True)
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--output", required=True)
    p.add_argument("--mode", default="random",
                   choices=["random", "style", "interpolate", "long"])
    p.add_argument("--count", type=int, default=4)
    p.add_argument("--length", type=int, default=10,
                   help="windows per song (interpolate/long)")
    p.add_argument("--z-std", type=float, default=None,
                   help="latent sampling std (default: train-set std, or 1.0)")
    p.add_argument("--source", default=None, help="corpus (for z stats / long mode)")
    p.add_argument("--cache", default=None)
    p.add_argument("--bpm", type=float, default=100.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample-method", default=None, choices=[None, "choice", "argmax"])
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    import numpy as np

    from midi_vae_tpu_torch.data.dataset import import_midi_from_folder
    from midi_vae_tpu_torch.data.tensorize import instrument_matrix_to_programs, save_rolls_as_midi
    from midi_vae_tpu_torch.evaluation import generation
    from midi_vae_tpu_torch.models.vae import MidiVAE
    from midi_vae_tpu_torch.training import checkpoint as ckpt

    cfg = ckpt.load_config(args.model)
    if args.temperature is not None:
        cfg = cfg.replace(temperature=args.temperature)
    if args.sample_method:
        cfg = cfg.replace(sample_method=args.sample_method)
    params = ckpt.load_run_params(args.model, args.epoch)
    # raises when --device cuda finds no card: no silent CPU run
    ctx = generation.GenerationContext(cfg, MidiVAE(cfg, params), args.device)
    rng = np.random.RandomState(args.seed)
    os.makedirs(args.output, exist_ok=True)

    z_std = args.z_std
    all_z = None
    class_mean_z = None
    # style mode needs the class-conditional latent means whenever a corpus
    # is given, even when --z-std pins the sampling scale
    if args.source and (z_std is None or args.mode in ("long", "style")):
        ds = import_midi_from_folder(args.source, cfg, cache_dir=args.cache)
        zs, labels = [], []
        for i in range(ds.train_set_size):
            z = ctx.encode_song(ds.X_train[i], ds.I_train[i], ds.V_train[i], ds.D_train[i])
            zs.extend(z)
            labels.extend([ds.C_train[i]] * len(z))
        all_z = np.asarray(zs)
        labels = np.asarray(labels)
        if len(all_z):
            if z_std is None:
                z_std = float(np.std(all_z))
                print(f"z_std from train set: {z_std:.4f}")
            # class-conditional latent means: an in-distribution style knob
            # (the reference's hard z[C] = +-1 knob assumes unit-scale
            # latents, vae_evaluation.py:1796-1798). Requires every class to
            # have train samples: an empty slice would mean() to NaN latents
            if all(np.any(labels == C) for C in range(cfg.num_classes)):
                class_mean_z = np.stack([all_z[labels == C].mean(axis=0)
                                         for C in range(cfg.num_classes)])
            else:
                print("warning: some classes have no train songs; style mode "
                      "falls back to the hard composer knob")
    if z_std is None:
        z_std = 1.0
    if args.mode == "long" and (all_z is None or not len(all_z)):
        print("--mode long needs --source (train latents to chain through)")
        return 1

    def save(name, Y, programs, V, D):
        path = os.path.join(args.output, f"{name}.mid")
        save_rolls_as_midi(Y, programs, cfg, path, args.bpm, V, D)
        print(f"wrote {path}")

    for n in range(args.count):
        if args.mode == "random":
            Y, I, V, D, _ = generation.generate_random_song(ctx, z_std, rng, cfg.sample_method)
            programs = instrument_matrix_to_programs(I[0], cfg.instrument_attach_method)
            save(f"random_{n}", Y, programs, V, D)
        elif args.mode == "style":
            for C, class_name in enumerate(cfg.classes):
                if class_mean_z is not None:
                    z = rng.normal(0.0, z_std, (1, cfg.latent_dim)).astype(np.float32)
                    z[0, : cfg.num_classes] = class_mean_z[C, : cfg.num_classes]
                    Y, I, V, D, _ = ctx.decode_and_process(
                        z, additional=ctx.additional_for(C, None, 1),
                        sample_method=cfg.sample_method, rng=rng,
                    )
                else:
                    Y, I, V, D, _ = generation.generate_random_song(
                        ctx, z_std, rng, cfg.sample_method, style_class=C)
                programs = instrument_matrix_to_programs(I[0], cfg.instrument_attach_method)
                save(f"style_{n}_{class_name}", Y, programs, V, D)
        elif args.mode == "interpolate":
            z_a = rng.normal(0, z_std, cfg.latent_dim).astype(np.float32)
            z_b = rng.normal(0, z_std, cfg.latent_dim).astype(np.float32)
            Y, I, V, D = generation.generate_interpolation_song(
                ctx, z_a, z_b, args.length, cfg.sample_method, rng)
            programs = generation.vote_for_programs(I, cfg)
            save(f"interpolation_{n}", Y, programs, V, D)
        elif args.mode == "long":
            Y, I, V, D = generation.generate_long_song(
                ctx, all_z, z_std, args.length, rng, cfg.sample_method)
            programs = generation.vote_for_programs(I, cfg)
            save(f"long_{n}", Y, programs, V, D)
    return 0


if __name__ == "__main__":
    sys.exit(main())
