#!/usr/bin/env python
"""Style-transfer a MIDI file with a MIDI-VAE run, on PyTorch.

Counterpart of ``midi_vae_tpu/cli/transfer.py``: tensorize a song, encode
it, swap the style dimensions z[C] <-> z[C_switch], decode, and write the
transferred MIDI. The run directory holds ``config.json`` and
``params.npz`` (``tools/jax_run_to_torch.py`` converts a JAX run), and
``epoch_N/`` checkpoints after training (``--epoch N`` serves one). With
``--classifiers DIR`` (one ``pitch/``, ``velocity/``, ``instrument/`` judge
directory each, ``training/checkpoint.py::save_classifier``) the judges score
the original and the transferred song: per judge, the mean confidence of its
windows in the target class. ``--bundle DIR`` serves from a serving bundle
(``python -m midi_vae_tpu_torch.tools.export_serving``, ``serving.py``)
instead of a run: its exported programs alone, no model build, and its
sealed judges when it carries them and ``--classifiers`` is not given.

Examples:
    python -m midi_vae_tpu_torch.cli.transfer --model runs/port \\
        --input song.mid --to-class style2 --output out/
    python -m midi_vae_tpu_torch.cli.transfer --model runs/port \\
        --input song.mid --from-class style1 --to-class style2 \\
        --output out/ --write-reconstruction --classifiers runs/judges --device cpu
    python -m midi_vae_tpu_torch.cli.transfer --bundle bundles/port \\
        --input song.mid --to-class style2 --output out/
"""

from __future__ import annotations

import argparse
import os
import sys


def _class_index(cfg, value: str, flag: str) -> int:
    """A class name (case-insensitive) or an integer index."""
    lowered = [c.lower() for c in cfg.classes]
    if value.lower() in lowered:
        return lowered.index(value.lower())
    try:
        idx = int(value)
    except ValueError:
        raise SystemExit(f"{flag}: {value!r} is not one of {list(cfg.classes)} or an index")
    if not 0 <= idx < len(cfg.classes):
        raise SystemExit(f"{flag}: index {idx} out of range for {list(cfg.classes)}")
    return idx


def _source_class(cfg, path: str) -> int:
    """Match class names against the input's directories, deepest first."""
    parts = os.path.dirname(os.path.abspath(path)).split(os.sep)
    for component in reversed(parts):
        for i, c in enumerate(cfg.classes):
            if c.lower() in component.lower():
                return i
    print(
        f"note: no class name found in the directory of {path}; "
        f"assuming source class {cfg.classes[0]!r} (use --from-class to override)"
    )
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default=None, help="run dir (config.json + params.npz)")
    p.add_argument("--epoch", type=int, default=None,
                   help="serve the epoch_N/ checkpoint (default: the run's params.npz)")
    p.add_argument("--bundle", default=None,
                   help="serving bundle dir (midi_vae_tpu_torch.tools.export_serving): run the "
                        "transfer from its exported programs alone (exclusive with --model)")
    p.add_argument("--input", required=True, nargs="+", help="MIDI file(s)")
    p.add_argument("--output", required=True, help="output folder")
    p.add_argument("--to-class", required=True, help="target style: class name or index")
    p.add_argument("--from-class", default=None,
                   help="source style; default: class names matched against the input path, else class 0")
    p.add_argument("--write-reconstruction", action="store_true",
                   help="also write the un-switched autoencoding for comparison")
    p.add_argument("--classifiers", default=None,
                   help="judge dir (pitch/, velocity/, instrument/): report per-judge "
                        "target-class confidence for the original and the transferred song")
    p.add_argument("--bpm", type=float, default=None,
                   help="output tempo (default: the input's steady-span tempo)")
    p.add_argument("--keep-instruments", action="store_true",
                   help="render with the INPUT's programs instead of the predicted (voted) instruments")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    if (args.model is None) == (args.bundle is None):
        raise SystemExit("pass exactly one of --model or --bundle")
    if args.bundle is not None and args.epoch is not None:
        raise SystemExit("--epoch applies to --model runs, not bundles")

    import numpy as np

    from midi_vae_tpu_torch.data.tensorize import (
        instrument_matrix_to_programs,
        load_rolls_from_path,
        save_rolls_as_midi,
    )
    from midi_vae_tpu_torch.evaluation.generation import (
        GenerationContext,
        split_song_back_to_samples,
        vote_for_programs,
    )
    from midi_vae_tpu_torch.evaluation.sampling import add_silent_column
    from midi_vae_tpu_torch.models.classifier import CLASSIFIER_KINDS, make_judge
    from midi_vae_tpu_torch.training import checkpoint as ckpt

    # either raises when --device cuda finds no card: no silent CPU run
    if args.bundle is not None:
        from midi_vae_tpu_torch.serving import load_serving_bundle

        ctx = load_serving_bundle(args.bundle, args.device)
        cfg, run_dir = ctx.cfg, args.bundle
    else:
        from midi_vae_tpu_torch.models.vae import MidiVAE

        cfg, run_dir = ckpt.load_config(args.model), args.model
        ctx = GenerationContext(cfg, MidiVAE(cfg, ckpt.load_run_params(args.model, args.epoch)),
                                args.device)
    os.makedirs(args.output, exist_ok=True)

    judges = {}
    if args.classifiers:
        for kind in CLASSIFIER_KINDS:
            kind_dir = os.path.join(args.classifiers, kind)
            if os.path.isdir(kind_dir):
                judges[kind] = make_judge(ckpt.load_classifier(kind_dir).to(ctx.device))
    elif args.bundle is not None:
        judges = ctx.judges  # the bundle's sealed judges, if it carries them
        if judges:
            print(f"judging with sealed programs: {sorted(judges)}")

    def judge_windows(Y_song, I_pred, V_flat, label, C_target):
        """Mean per-judge confidence that the windows are class C_target."""
        windows = split_song_back_to_samples(Y_song, cfg.output_length)
        report = []
        if "pitch" in judges:
            x = np.stack([add_silent_column(w, cfg) for w in windows])
            report.append(("pitch", judges["pitch"](x)))
        if "velocity" in judges and V_flat is not None:
            v = V_flat.reshape(len(windows), cfg.output_length, 1)
            report.append(("velocity", judges["velocity"](v)))
        if "instrument" in judges and I_pred is not None:
            report.append(("instrument", judges["instrument"](I_pred)))
        if report:
            parts = ", ".join(f"{name} {float(np.mean(probs[:, C_target])):.3f}"
                              for name, probs in report)
            print(f"  judge confidence in {cfg.classes[C_target]} ({label}): {parts}")

    C_switch = _class_index(cfg, args.to_class, "--to-class")

    # signature-conditioned runs: normalize with the train-time stats
    sig_stats = None
    if cfg.append_signature_vector_to_latent:
        stats_path = os.path.join(run_dir, "signature_stats.npz")
        if os.path.exists(stats_path):
            d = np.load(stats_path)
            sig_stats = (d["mean"], d["std"])
        else:
            print("warning: signature-conditioned model but no signature_stats.npz "
                  "in the run dir; using zero signatures")

    for path in args.input:
        song = load_rolls_from_path(path, cfg)
        if song is None or song.X.shape[0] == 0:
            print(f"skip {path}: no usable windows")
            continue
        S_song = None
        if sig_stats is not None:
            from midi_vae_tpu_torch.data.batching import signature_vectors_for_songs

            S_song = (signature_vectors_for_songs([song.Y], cfg)[0] - sig_stats[0]) / sig_stats[1]
        if args.from_class is not None:
            C = _class_index(cfg, args.from_class, "--from-class")
        else:
            C = _source_class(cfg, path)
        if C == C_switch:
            print(f"skip {path}: source class equals target class")
            continue

        (Y_sw, I_sw, V_sw, D_sw, _N), _switched = ctx.style_transfer_song(
            song.X, song.I, song.V, song.D, C=C, C_switch=C_switch, S=S_song
        )
        input_programs = instrument_matrix_to_programs(song.I, cfg.instrument_attach_method)
        programs = (input_programs if args.keep_instruments or not cfg.meta_instrument
                    else vote_for_programs(I_sw, cfg))
        bpm = args.bpm if args.bpm is not None else song.tempo
        stem = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.output, f"{stem}_{cfg.classes[C]}_to_{cfg.classes[C_switch]}.mid")
        save_rolls_as_midi(Y_sw, programs, cfg, out, bpm, V_sw, D_sw)
        print(f"{path} [{cfg.classes[C]}] -> {out} (programs {input_programs} -> {programs})")
        if judges:
            judge_windows(song.Y[..., : cfg.new_num_notes].reshape(-1, cfg.new_num_notes),
                          song.I[None],  # one matrix per song, like the reference judge
                          song.V.reshape(-1), "original", C_switch)
            judge_windows(Y_sw, I_sw if cfg.meta_instrument else None,
                          V_sw if cfg.meta_velocity else None, "transferred", C_switch)

        if args.write_reconstruction:
            z = ctx.encode_song(song.X, song.I, song.V, song.D)
            # reconstruction semantics of the evaluation harness: H = z unshifted
            Y_r, I_r, V_r, D_r, _ = ctx.decode_and_process(
                z, history=z, additional=ctx.additional_for(C, S_song, len(z))
            )
            rec = os.path.join(args.output, f"{stem}_reconstruction.mid")
            rec_programs = (input_programs if args.keep_instruments or not cfg.meta_instrument
                            else vote_for_programs(I_r, cfg))
            save_rolls_as_midi(Y_r, rec_programs, cfg, rec, bpm, V_r, D_r)
            print(f"  reconstruction -> {rec}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
