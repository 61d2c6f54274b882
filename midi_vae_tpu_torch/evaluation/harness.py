"""The evaluation/generation harness: all sections of the reference's
``vae_evaluation.py`` as a toggleable pipeline.

A copy of ``midi_vae_tpu/evaluation/harness.py`` over the port's
``GenerationContext`` and judges, on one torch device (``Evaluator(...,
device=)``): the encodes run kernel A (L for an LSTM run) and the decodes
kernel B (M) on the card, the GRU judges A (LSTM judges L).

Section map (reference vae_evaluation.py -> here):
  :44-67   section toggles                 -> EvalSections dataclass
  :160-187 dataset stats + interactive gate-> run() logging (gate dropped)
  :193-299 harmonicity stats               -> stats.harmonicity_* section
  :301-400 instrument program stats        -> stats.program_statistics
  :403-472 signature prep                  -> _prepare_signatures
  :665-702 latent caching                  -> _cache_latents (batched)
  :705-837 chosen interpolation medleys    -> section_chosen_interpolations
  :841-887 random interpolations           -> section_random_interpolations
  :891-1304 latent sweep                   -> section_latent_sweep (batched)
  :1306-1526 chord probes                  -> section_chord_evaluation
  :1530-1649 sampling regions              -> section_sampling_regions
  :1651-1763 pitch probes                  -> section_pitch_evaluation
  :1766-1814 random songs + style knob     -> section_random_songs
  :1816-1896 long songs                    -> section_long_songs
  :1900-2636 autoencoding + style switch   -> section_autoencoding
  :2638-2909 aggregation, prints, CSV      -> results dict + CSV + JSON

Per-sample ``model.predict`` loops of the reference are replaced by batched
calls throughout. Crashing reference branches (undefined ``rolls``
variable, vae_evaluation.py:146, :2067) are fixed, not replicated.
"""

from __future__ import annotations

import csv
import json
import math
import os
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from ..config import Config
from ..data.dataset import Dataset
from ..data.tensorize import instrument_matrix_to_programs, save_rolls_as_midi
from ..models.classifier import ensemble_prediction
from ..models.vae import MidiVAE
from ..utils import music
from . import generation, probes, sampling, stats, sweep
from .generation import GenerationContext, split_song_back_to_samples, vote_for_programs


@dataclass
class EvalSections:
    """Toggles mirroring vae_evaluation.py:44-67 (counts set small-friendly)."""

    harmonicity_evaluations: bool = False
    frankenstein_harmonicity_evaluations: bool = False
    frankenstein_evaluations: int = 1000  # draws per baseline (vae_eval.py:196)
    max_new_chosen_interpolation_songs: int = 0
    interpolation_length: int = 4
    how_many_songs_in_one_medley: int = 3
    noninterpolated_samples_between_interpolation: int = 8
    max_new_sampled_interpolation_songs: int = 0
    interpolation_song_length: int = 10
    latent_sweep: bool = False
    num_latent_sweep_samples: int = 10
    num_latent_sweep_evaluation_songs: int = 2
    chord_evaluation: bool = False
    evaluate_different_sampling_regions: bool = False
    pitch_evaluation: bool = False
    max_new_sampled_songs: int = 0
    max_new_sampled_long_songs: int = 0
    long_song_length: int = 20
    evaluate_autoencoding_and_stuff: bool = True
    mix_with_previous: bool = True
    switch_styles: bool = True
    max_plots_per_song: int = 3
    save_anything: bool = True
    bpm: float = 100.0


class Evaluator:
    """Loads a trained VAE (+ optional classifiers) and runs sections.

    ``params``: the VAE's numpy params tree; ``classifiers``: kind ->
    ``StyleClassifier`` (``training/checkpoint.py::load_classifier``);
    ``device``: where the model and the judges run ("cuda" raises without a
    card)."""

    def __init__(
        self,
        cfg: Config,
        params,
        dataset: Dataset,
        save_folder: str,
        classifiers: dict | None = None,
        test_train_set: bool = False,
        seed: int = 0,
        device: str = "cuda",
    ):
        self.cfg = cfg
        self.ds = dataset
        self.save_folder = save_folder
        self.test_train_set = test_train_set
        self.rng = np.random.RandomState(seed)
        self.model = MidiVAE(cfg, params)
        self.ctx = GenerationContext(cfg, self.model, device)
        os.makedirs(save_folder, exist_ok=True)

        # classifier predict fns (batched, bucket-padded); None -> disabled
        from ..models.classifier import make_judge

        self.clf = {}
        classifiers = classifiers or {}
        for kind in ("pitch", "velocity", "instrument"):
            entry = classifiers.get(kind)
            self.clf[kind] = None if entry is None else make_judge(entry.to(self.ctx.device))

        self.results: dict = {}
        self._prepare_signatures()
        self._cache_latents()

    # ------------------------------------------------------------------
    # Preparation (vae_evaluation.py:403-472, :665-702)
    # ------------------------------------------------------------------
    def _prepare_signatures(self) -> None:
        from ..data.batching import normalize_signatures, signature_vectors_for_songs

        cfg = self.cfg
        self.S_train = signature_vectors_for_songs(self.ds.Y_train, cfg)
        self.S_test = signature_vectors_for_songs(self.ds.Y_test, cfg)
        (
            self.normalized_S_train,
            self.normalized_S_test,
            self.mean_signature,
            self.std_signature,
        ) = normalize_signatures(self.S_train, self.S_test)
        self.S_train_for_each_class = [[] for _ in range(cfg.num_classes)]
        for sigs, C in zip(self.S_train, self.ds.C_train):
            self.S_train_for_each_class[C].extend(sigs)
        self.all_S = (
            np.concatenate(self.S_train, axis=0)
            if self.S_train
            else np.zeros((0, cfg.signature_vector_length))
        )

    def _cache_latents(self) -> None:
        """Encode every train song once, batched (vae_eval.py:665-702)."""
        self.train_representation_list = []
        all_z = []
        for i in range(len(self.ds.X_train)):
            z = self.ctx.encode_song(
                self.ds.X_train[i], self.ds.I_train[i],
                self.ds.V_train[i], self.ds.D_train[i],
            )
            self.train_representation_list.append(z)
            all_z.extend(z)
        self.all_z = np.asarray(all_z) if all_z else np.zeros((0, self.cfg.latent_dim))
        self.z_mean_train = float(np.mean(self.all_z)) if len(self.all_z) else 0.0
        self.z_std_train = float(np.std(self.all_z)) if len(self.all_z) else 1.0
        self.results["z_mean_train"] = self.z_mean_train
        self.results["z_std_train"] = self.z_std_train

    # ------------------------------------------------------------------
    def _eval_songs(self):
        """The split being evaluated (test by default)."""
        ds = self.ds
        if self.test_train_set:
            return (
                ds.X_train, ds.Y_train, ds.C_train, ds.I_train, ds.V_train,
                ds.D_train, self.normalized_S_train, self.S_train, ds.train_paths,
            )
        return (
            ds.X_test, ds.Y_test, ds.C_test, ds.I_test, ds.V_test,
            ds.D_test, self.normalized_S_test, self.S_test, ds.test_paths,
        )

    def _save_midi(self, name, Y, programs, V=None, D=None, bpm=100.0):
        path = os.path.join(self.save_folder, f"{name}.mid")
        save_rolls_as_midi(Y, programs, self.cfg, path, bpm, V, D)

    # ------------------------------------------------------------------
    # Sections
    # ------------------------------------------------------------------
    def section_dataset_stats(self, sec: EvalSections) -> None:
        self.results["dataset_counts"] = stats.dataset_counts(self.ds, self.cfg)

    def section_harmonicity(self, sec: EvalSections) -> None:
        cfg = self.cfg
        r = {
            "train": stats.harmonicity_for_split(self.ds.Y_train, self.ds.C_train, cfg),
            "test": stats.harmonicity_for_split(self.ds.Y_test, self.ds.C_test, cfg),
        }
        if sec.frankenstein_harmonicity_evaluations:
            n_evals = sec.frankenstein_evaluations
            r["random_pitches"] = stats.frankenstein_random_pitches(
                cfg, n_evals, self.rng
            )
            r["frankenstein_train"] = stats.frankenstein_from_songs(
                self.ds.Y_train, cfg, n_evals, self.rng
            )
            r["frankenstein_test"] = stats.frankenstein_from_songs(
                self.ds.Y_test, cfg, n_evals, self.rng
            )
            # per-class frankenstein baselines (vae_eval.py:244-255)
            for split, Y_list, C_list in (
                ("train", self.ds.Y_train, self.ds.C_train),
                ("test", self.ds.Y_test, self.ds.C_test),
            ):
                per_class = []
                for C in range(cfg.num_classes):
                    Y_c = [y for y, c in zip(Y_list, C_list) if c == C]
                    per_class.append(
                        stats.frankenstein_from_songs(Y_c, cfg, n_evals, self.rng)
                    )
                r[f"frankenstein_{split}_per_class"] = per_class
        self.results["harmonicity"] = r

    def section_program_stats(self, sec: EvalSections) -> None:
        self.program_stats = stats.program_statistics(self.ds, self.cfg)
        self.results["program_switch_percentage"] = (
            stats.switch_percentage_between_classes(self.program_stats, self.cfg)
        )

    def section_chosen_interpolations(self, sec: EvalSections) -> None:
        ds = self.ds
        X_list, _, C_list, I_list, V_list, D_list, _, _, paths = self._eval_songs()
        if not X_list:
            return
        for song_num in range(sec.max_new_chosen_interpolation_songs):
            picks = []
            for _ in range(sec.how_many_songs_in_one_medley):
                idx = int(self.rng.randint(len(X_list)))
                picks.append(
                    {
                        "X": X_list[idx], "I": I_list[idx],
                        "V": V_list[idx], "D": D_list[idx],
                    }
                )
            Y, I_pred, V, D, info = generation.generate_medley(
                self.ctx, picks, sec.interpolation_length,
                sec.noninterpolated_samples_between_interpolation, rng=self.rng,
            )
            programs = vote_for_programs(I_pred, self.cfg)
            name = f"medley_{song_num}"
            if sec.save_anything:
                self._save_midi(name, Y, programs, V, D, sec.bpm)
                Yp, all_programs, Vp, Dp = (
                    generation.restructure_song_to_fit_more_instruments(
                        Y, I_pred, V, D, self.cfg
                    )
                )
                self._save_midi(
                    f"{name}_all_programs", Yp, all_programs, Vp, Dp, sec.bpm
                )
                with open(
                    os.path.join(self.save_folder, f"{name}_info.txt"), "w"
                ) as f:
                    for k, v in info.items():
                        f.write(f"{k}: {v}\n")
        del ds, C_list, paths

    def section_random_interpolations(self, sec: EvalSections) -> None:
        cfg = self.cfg
        for song_num in range(sec.max_new_sampled_interpolation_songs):
            z_a = self.rng.normal(0.0, self.z_std_train, size=(cfg.latent_dim,))
            z_b = self.rng.normal(0.0, self.z_std_train, size=(cfg.latent_dim,))
            Y, I_pred, V, D = generation.generate_interpolation_song(
                self.ctx, z_a.astype(np.float32), z_b.astype(np.float32),
                sec.interpolation_song_length, rng=self.rng,
            )
            programs = vote_for_programs(I_pred, cfg)
            if sec.save_anything:
                self._save_midi(
                    f"random_interpolation_{song_num}", Y, programs, V, D, sec.bpm
                )

    def section_latent_sweep(self, sec: EvalSections) -> None:
        cfg = self.cfg
        start = self.rng.normal(
            0.0, self.z_std_train, size=(sec.num_latent_sweep_samples, cfg.latent_dim)
        ).astype(np.float32)
        result = sweep.latent_sweep_over_all_dimensions(
            self.ctx, start, sigma=self.z_std_train,
            pitch_predict=self.clf["pitch"],
            velocity_predict=self.clf["velocity"],
            instrument_predict=self.clf["instrument"],
            log_fn=lambda s: None,
        )
        self.results["latent_sweep_best_dims"] = result["best_dims"]
        self.results["latent_sweep_best_peaks"] = {
            k: list(v) for k, v in result["best_peaks"].items()
        }
        if sec.save_anything:
            self._plot_safely(self._plot_sweep_influence, result)
        # render sweeped MIDI for a few train songs (vae_eval.py:1224-1274)
        if sec.num_latent_sweep_evaluation_songs and self.train_representation_list:
            values = result["values"]
            for key, best_dim in list(result["best_dims"].items())[:3]:
                for _ in range(min(
                    sec.num_latent_sweep_evaluation_songs,
                    len(self.train_representation_list),
                )):
                    idx = int(self.rng.randint(len(self.train_representation_list)))
                    z_song = self.train_representation_list[idx]
                    Y, programs, V, D = sweep.render_sweeped_songs(
                        self.ctx, z_song, best_dim, values[-1]
                    )
                    if sec.save_anything:
                        safe = key.replace("/", "_")[:60]
                        self._save_midi(
                            f"sweep_{safe}_dim{best_dim}_song{idx}",
                            Y, programs, V, D, sec.bpm,
                        )

    def _plot_safely(self, fn, *args, **kwargs) -> None:
        """Plots must never kill an evaluation run (a degenerate matrix once
        crashed matplotlib's tick locator mid-harness); metrics and MIDI
        artifacts always come first."""
        try:
            fn(*args, **kwargs)
        except Exception as err:
            print(f"plot failed ({getattr(fn, '__name__', fn)!s}): {err}")

    def _plot_sweep_influence(self, result: dict) -> None:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        for key, best_dim in list(result["best_dims"].items()):
            scores = [result["influence"][d][key] for d in range(self.cfg.latent_dim)]
            plt.figure(figsize=(20.0, 10.0))
            plt.title(f"{key}: overall best dim {best_dim}")
            plt.bar(np.arange(len(scores)), scores, align="center")
            plt.xlabel("Dimensions")
            plt.ylabel("Influence")
            safe = key.replace("/", "_")[:60]
            plt.savefig(os.path.join(self.save_folder, f"zsweep_{safe}.png"))
            plt.close()

    def _plot_embedding(self, plot, labels, zs, method: str, n_components: int, title: str,
                        name: str) -> None:
        """Embed the latents and scatter-plot them: both inside
        ``_plot_safely``, so that a machine without scikit-learn skips the
        plot as it does without matplotlib (the embedding feeds nothing
        else)."""
        plot(labels, probes.embed_2d(zs, method, n_components), title,
             os.path.join(self.save_folder, name))

    def section_chord_evaluation(self, sec: EvalSections) -> None:
        names, zs = probes.encode_chords(self.ctx, probes.MAJ_MIN_CHORDS)
        self.results["chord_latents"] = {"names": names, "z": zs}
        if sec.save_anything and len(zs) >= 3:
            for method in ("tsne", "pca"):
                self._plot_safely(
                    self._plot_embedding, probes.plot_chord_embedding, names, zs, method, 2,
                    f"Chords: {method.upper()} of latent chord-songs",
                    f"aaa_{method}_maj_min_chords.png",
                )

    def section_pitch_evaluation(self, sec: EvalSections) -> None:
        pitches, zs = probes.encode_pitches(self.ctx)
        self.results["pitch_latents"] = {"pitches": pitches, "z": zs}
        if sec.save_anything and len(zs) >= 3:
            self._plot_safely(
                self._plot_embedding, probes.plot_pitch_embedding, pitches, zs, "pca", 1,
                "PCA of latent pitch-songs", "aaa_pca_pitches.png",
            )
            self._plot_safely(
                self._plot_embedding, probes.plot_pitch_embedding, pitches, zs, "tsne", 2,
                "Octaves: t-SNE of latent pitch-songs", "aaa_tsne_octaves.png",
            )

    def section_sampling_regions(self, sec: EvalSections) -> None:
        if not len(self.all_S):
            return
        means, stds = probes.signature_mahalanobis_for_samples(
            self.ctx, self.all_S, probes.DEFAULT_SCALES, self.z_std_train,
            vary="scale", rng=self.rng,
        )
        self.results["sampling_region_scales"] = {
            "scales": probes.DEFAULT_SCALES, "means": means, "stds": stds,
        }
        if sec.save_anything:
            self._plot_safely(
                probes.plot_mahalanobis_curve,
                probes.DEFAULT_SCALES, means, stds,
                "Mahalanobis distance vs sampling scale",
                os.path.join(self.save_folder, "aaa_signature_scales.png"),
            )
        means, stds = probes.signature_mahalanobis_for_samples(
            self.ctx, self.all_S, probes.DEFAULT_LOCS, self.z_std_train,
            vary="loc", rng=self.rng,
        )
        self.results["sampling_region_locs"] = {
            "locs": probes.DEFAULT_LOCS, "means": means, "stds": stds,
        }
        if sec.save_anything:
            self._plot_safely(
                probes.plot_mahalanobis_curve,
                [max(v, 1e-6) for v in probes.DEFAULT_LOCS], means, stds,
                "Mahalanobis distance vs sampling loc",
                os.path.join(self.save_folder, "aaa_signature_locs.png"),
            )

    def section_random_songs(self, sec: EvalSections) -> None:
        cfg = self.cfg
        for song_num in range(sec.max_new_sampled_songs):
            Y, I, V, D, _ = generation.generate_random_song(
                self.ctx, self.z_std_train, self.rng, cfg.sample_method
            )
            programs = instrument_matrix_to_programs(
                I[0], cfg.instrument_attach_method
            )
            if sec.save_anything:
                self._save_midi(f"random_{song_num}", Y, programs, V, D, sec.bpm)
            if cfg.include_composer_decoder:
                # ONE shared random_code per song; only the composer knob
                # changes across classes, so per-class differences isolate
                # the knob effect (vae_evaluation.py:1792-1800)
                shared_z = self.rng.normal(
                    0.0, self.z_std_train, size=(1, cfg.latent_dim)
                ).astype(np.float32)
                previous_Y = None
                previous_programs = None
                for C in range(cfg.num_classes):
                    Y, I, V, D, _ = generation.generate_random_song(
                        self.ctx, self.z_std_train, self.rng,
                        cfg.sample_method, style_class=C, z=shared_z,
                    )
                    programs = instrument_matrix_to_programs(
                        I[0], cfg.instrument_attach_method
                    )
                    if sec.save_anything:
                        self._save_midi(
                            f"random_{song_num}_{C}", Y, programs, V, D, sec.bpm
                        )
                        if previous_Y is not None:
                            # cross-class switchdiff plot (vae_eval.py:1808)
                            from ..utils.plotting import draw_difference_pianoroll

                            self._plot_safely(
                                draw_difference_pianoroll,
                                generation.prepare_for_drawing(Y, cfg),
                                generation.prepare_for_drawing(previous_Y, cfg),
                                name_1=f"{song_num}_{C} programs {programs}",
                                name_2=f"{song_num}_{C-1} programs "
                                       f"{previous_programs}",
                                save_path=os.path.join(
                                    self.save_folder,
                                    f"random_{song_num}_{C}_vs_{C-1}"
                                    "_switchdiff.png",
                                ),
                            )
                    previous_Y, previous_programs = Y, programs

    def section_long_songs(self, sec: EvalSections) -> None:
        if not len(self.all_z):
            return
        for song_num in range(sec.max_new_sampled_long_songs):
            Y, I, V, D = generation.generate_long_song(
                self.ctx, self.all_z, self.z_std_train,
                sec.long_song_length, self.rng, self.cfg.sample_method,
            )
            programs = vote_for_programs(I, self.cfg)
            if sec.save_anything:
                self._save_midi(f"random_long_{song_num}", Y, programs, V, D, sec.bpm)

    # ------------------------------------------------------------------
    # The big one: autoencoding + style switch (vae_eval.py:1900-2636)
    # ------------------------------------------------------------------
    def _classify(self, kind: str, x: np.ndarray, C: int):
        """(accuracy, confidence, probs) for one batch under one judge."""
        predict = self.clf[kind]
        if predict is None or len(x) == 0:
            return None
        probs = predict(x)
        acc = float(np.mean(np.argmax(probs, -1) == C))
        conf = float(np.mean(probs[:, C]))
        return acc, conf, probs

    def section_autoencoding(self, sec: EvalSections) -> None:
        cfg = self.cfg
        X_list, Y_list, C_list, I_list, V_list, D_list, nS_list, S_list, paths = (
            self._eval_songs()
        )
        if not X_list:
            return
        metrics_rows: list[dict] = []
        mean_row: dict = defaultdict(float)
        mean_counts: dict = defaultdict(int)
        mean_row["song_name"] = "Mean"
        mean_row["class"] = "all"

        k = cfg.num_classes
        original_sig_per_class = [[] for _ in range(k)]
        autoenc_sig_per_class = [[] for _ in range(k)]
        switched_sig_per_class = [[] for _ in range(k)]
        instr_switched_sig_per_class = [[] for _ in range(k)]
        switched_instruments_per_class = [[[] for _ in range(k)] for _ in range(k)]
        inst_axis = 16 if "category" in cfg.instrument_attach_method else 128
        switch_matrix = np.zeros((k, k, inst_axis, inst_axis))
        harmonicity_autoencoded = []
        harmonicity_switched = [[[] for _ in range(k)] for _ in range(k)]
        reconstruction_accuracy_array = []
        previous_latent = None
        previous_song_name = ""

        program_stats = getattr(self, "program_stats", None)
        if program_stats is None:
            self.section_program_stats(sec)
            program_stats = self.program_stats

        for song_num in range(len(X_list)):
            song_name = os.path.basename(paths[song_num]).replace(".mid", "")
            X, Y, C, I, V, D = (
                X_list[song_num], Y_list[song_num], C_list[song_num],
                I_list[song_num], V_list[song_num], D_list[song_num],
            )
            S_original = S_list[song_num]
            num_samples = Y.shape[0]
            row: dict = {"song_name": song_name, "class": cfg.classes[C]}

            # flatten originals
            V_flat = V.reshape(-1)
            D_flat = D.reshape(-1)
            song = Y[:, :, : cfg.new_num_notes].reshape(-1, cfg.new_num_notes)
            original_sig_per_class[C].extend(S_original)
            programs = instrument_matrix_to_programs(I, cfg.instrument_attach_method)

            # --- original classification (batched) ---
            def record(prefix, kind, x):
                res = self._classify(kind, x, C)
                if res is None:
                    return None
                acc, conf, probs = res
                row[f"{prefix}_{kind}_classifier_accuracy"] = acc
                row[f"{prefix}_{kind}_classifier_confidence"] = conf
                return probs

            p_probs = record("original", "pitch", Y)
            v_probs = record("original", "velocity", V[..., None])
            i_probs = record("original", "instrument", I[None])
            if p_probs is not None and v_probs is not None and i_probs is not None:
                ens = ensemble_prediction(
                    p_probs, np.repeat(i_probs, num_samples, axis=0), v_probs
                )
                row["original_ensemble_classifier_accuracy"] = float(
                    np.mean(np.argmax(ens, -1) == C)
                )
                row["original_ensemble_classifier_confidence"] = float(
                    np.mean(ens[:, C])
                )

            # --- encode + autoencode ---
            z = self.ctx.encode_song(X, I, V, D)
            if sec.save_anything:
                class_dir = os.path.join(self.save_folder, cfg.classes[C])
                os.makedirs(class_dir, exist_ok=True)
                np.save(os.path.join(class_dir, f"z_{song_name}.npy"), z)
            # reference QUIRK deliberately replicated: the eval autoencode
            # feeds H = z UNSHIFTED (vae_evaluation.py:2190 passes the raw
            # encoded_representation into prepare_autoencoder_input...,
            # which appends it verbatim) -- each window is conditioned on
            # its OWN latent, unlike training's rolled H[i]=z[i-1]. The
            # released evaluation numbers were computed this way.
            nS_song = nS_list[song_num] if song_num < len(nS_list) else None
            Y_pred, I_pred, V_pred, D_pred, _ = self.ctx.decode_and_process(
                z, history=z,
                additional=self.ctx.additional_for(C, nS_song, len(z)),
                sample_method="argmax",
            )
            if sec.save_anything:
                self._save_midi(
                    f"{song_name}_autoencoded", Y_pred, programs, V_pred, D_pred, sec.bpm
                )
                if song_num < sec.max_plots_per_song:
                    # original-vs-reconstruction difference plot
                    # (data_class.draw_difference_pianoroll usage in the ref)
                    from ..utils.plotting import draw_difference_pianoroll

                    self._plot_safely(
                        draw_difference_pianoroll,
                        generation.prepare_for_drawing(song, cfg),
                        generation.prepare_for_drawing(Y_pred, cfg),
                        name_1=f"{song_name} original",
                        name_2="reconstruction",
                        save_path=os.path.join(
                            self.save_folder, f"{song_name}_diff.png"
                        ),
                    )
                self._save_midi(
                    f"{song_name}_auto+orig",
                    np.concatenate([Y_pred, song], axis=0), programs,
                    np.concatenate([V_pred, V_flat]),
                    np.concatenate([D_pred, D_flat]), sec.bpm,
                )

            # --- note start errors (vae_eval.py:2211-2244) ---
            start_errors = stats.note_start_errors(Y, Y_pred, D_pred, cfg)
            if start_errors is not None:
                row.update(start_errors)

            # --- per-window classification/signature/harmonicity of recon ---
            windows = split_song_back_to_samples(Y_pred, cfg.output_length)
            recon_with_silent = np.stack(
                [sampling.add_silent_column(w, cfg) for w in windows]
            )
            pa = record("autoencoded", "pitch", recon_with_silent)
            va = record(
                "autoencoded", "velocity",
                V_pred.reshape(num_samples, cfg.output_length, 1),
            ) if cfg.meta_velocity else None
            ia = record("autoencoded", "instrument", I_pred) if cfg.meta_instrument else None
            if pa is not None and va is not None and ia is not None:
                ens = ensemble_prediction(pa, ia, va)
                row["autoencoded_ensemble_classifier_accuracy"] = float(
                    np.mean(np.argmax(ens, -1) == C)
                )
                row["autoencoded_ensemble_classifier_confidence"] = float(
                    np.mean(ens[:, C])
                )
            for w in windows:
                harmonicity_autoencoded.append(
                    music.get_harmonicity_scores_for_each_track_combination(
                        w, cfg.max_voices, cfg.smallest_note
                    )
                )
                poly = music.monophonic_to_khot_pianoroll(w, cfg.max_voices)
                autoenc_sig_per_class[C].append(
                    music.signature_from_pianoroll(poly, cfg.low_crop)
                )

            # --- pitch reconstruction accuracy (vae_eval.py:2380-2415) ---
            recon_stats = stats.pitch_reconstruction_stats(song, Y_pred)
            recon_acc = recon_stats["pitch_reconstruction_accuracy"]
            row["total_original_notes"] = recon_stats["total_original_notes"]
            row["total_predicted_notes"] = recon_stats["total_predicted_notes"]
            row["pitch_reconstruction_accuracy"] = recon_acc
            reconstruction_accuracy_array.append(recon_acc)

            # --- mix with previous song (vae_eval.py:2422-2442) ---
            if sec.mix_with_previous and previous_latent is not None:
                from ..data.batching import history_from_latents

                n = min(len(z), len(previous_latent))
                mixed = (z[:n] + previous_latent[:n]) / 2
                # the reference decodes the mix through prepare_decoder_input
                # defaults: ROLLED history of the mixed latents, additional =
                # original class C + zero signature (S_mix, vae_eval.py:2433)
                Ym, Im, Vm, Dm, _ = self.ctx.decode_and_process(
                    mixed, history=history_from_latents(mixed),
                    additional=self.ctx.additional_for(C, None, n),
                    sample_method="argmax",
                )
                mixed_programs = vote_for_programs(Im, cfg)
                if sec.save_anything:
                    self._save_midi(
                        f"{song_name}_x_{previous_song_name}_mixed",
                        Ym, mixed_programs, Vm, Dm, sec.bpm,
                    )

            # --- style switch (vae_eval.py:2448-2625) ---
            # Each (C -> C_switch) pair gets its OWN row columns
            # (``..._{C}to{C_switch}``); the unsuffixed key is the per-song
            # mean over all switch targets, which for 2-class runs (the
            # reference's shipped configurations) equals the single pair
            # value. The reference keeps per-pair data only in pickled lists
            # and overwrites its CSV columns per C_switch
            # (vae_evaluation.py:2552-2604) -- lossy for >= 3 classes; fixed
            # here.
            if sec.switch_styles and cfg.include_composer_decoder:
                pair_stats: dict[str, list[float]] = defaultdict(list)

                def record_pair(key_base: str, value: float, pair: str) -> None:
                    row[f"{key_base}_{pair}"] = value
                    pair_stats[key_base].append(value)

                for C_switch in range(len(cfg.classes)):
                    if C_switch == C:
                        continue
                    pair = f"{C}to{C_switch}"
                    from ..data.batching import history_from_latents

                    switched = np.copy(z)
                    switched[:, C] = z[:, C_switch]
                    switched[:, C_switch] = z[:, C]
                    # rolled switched history + TARGET-class additional input
                    # (vae_eval.py:2480-2481: previous_switched_rep chain,
                    # prepare_decoder_input(switched, C_switch, S[i], ...))
                    Y_sw, I_sw, V_sw, D_sw, _ = self.ctx.decode_and_process(
                        switched, history=history_from_latents(switched),
                        additional=self.ctx.additional_for(
                            C_switch, nS_song, len(switched)
                        ),
                        sample_method="argmax",
                    )
                    sw_windows = split_song_back_to_samples(Y_sw, cfg.output_length)
                    sw_with_silent = np.stack(
                        [sampling.add_silent_column(w, cfg) for w in sw_windows]
                    )

                    def judge_pair(kind, x):
                        res = self._classify(kind, x, C)
                        if res is None:
                            return None
                        acc, conf, probs = res
                        record_pair(
                            f"switched_{kind}_classifier_accuracy", acc, pair
                        )
                        record_pair(
                            f"switched_{kind}_classifier_confidence", conf, pair
                        )
                        return probs

                    ps = judge_pair("pitch", sw_with_silent)
                    vs = judge_pair(
                        "velocity",
                        V_sw.reshape(num_samples, cfg.output_length, 1),
                    ) if cfg.meta_velocity else None
                    is_ = judge_pair("instrument", I_sw) if cfg.meta_instrument else None
                    if ps is not None and vs is not None and is_ is not None:
                        ens = ensemble_prediction(ps, is_, vs)
                        record_pair(
                            "switched_ensemble_classifier_accuracy",
                            float(np.mean(np.argmax(ens, -1) == C)),
                            pair,
                        )
                        record_pair(
                            "switched_ensemble_classifier_confidence",
                            float(np.mean(ens[:, C])),
                            pair,
                        )
                    switched_sigs = []
                    for w_i, w in enumerate(sw_windows):
                        harmonicity_switched[C][C_switch].append(
                            music.get_harmonicity_scores_for_each_track_combination(
                                w, cfg.max_voices, cfg.smallest_note
                            )
                        )
                        poly = music.monophonic_to_khot_pianoroll(w, cfg.max_voices)
                        sig = music.signature_from_pianoroll(poly, cfg.low_crop)
                        switched_sig_per_class[C_switch].append(sig)
                        switched_sigs.append(sig)
                        switched_programs = instrument_matrix_to_programs(
                            I_sw[w_i], cfg.instrument_attach_method
                        )
                        switched_instruments_per_class[C][C_switch].append(
                            switched_programs
                        )
                    switched_programs_song = vote_for_programs(I_sw, cfg)
                    for program, sw_program in zip(programs, switched_programs_song):
                        a = program // 8 if inst_axis == 16 else program
                        b = sw_program // 8 if inst_axis == 16 else sw_program
                        switch_matrix[C, C_switch, a, b] += 1
                    if cfg.meta_instrument and switched_programs_song != programs:
                        switch_string = "SI_"
                        instr_switched_sig_per_class[C].extend(switched_sigs)
                    else:
                        switch_string = ""
                        switched_programs_song = programs
                    if sec.save_anything:
                        self._save_midi(
                            f"{song_name}_fullswitch_{switch_string}{C}to{C_switch}",
                            Y_sw, switched_programs_song, V_sw, D_sw, sec.bpm,
                        )

                # per-song aggregate = mean over this song's switch targets
                for key_base, vals in pair_stats.items():
                    row[key_base] = float(np.mean(vals))

            previous_latent = z
            previous_song_name = song_name
            for key, value in row.items():
                if key not in ("song_name", "class"):
                    mean_row[key] += value
                    mean_counts[key] += 1
            metrics_rows.append(row)

        # ---- aggregation (vae_eval.py:2638-2909) ----
        # each key is averaged over the rows that actually contain it (e.g.
        # per-pair switch columns exist only for songs of class C, and a
        # song's class determines which pairs appear)
        for key in list(mean_row.keys()):
            if key not in ("song_name", "class"):
                mean_row[key] /= max(mean_counts[key], 1)
        metrics_rows.append(dict(mean_row))

        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            self.results["harmonicity_autoencoded"] = (
                np.nanmean(np.asarray(harmonicity_autoencoded), axis=0)
                if harmonicity_autoencoded
                else None
            )
        self.results["mean_reconstruction_accuracy"] = float(
            np.mean(reconstruction_accuracy_array)
        ) if reconstruction_accuracy_array else 0.0
        self.results["autoencoding_metrics"] = metrics_rows
        self.results["switch_matrix"] = switch_matrix

        # signature Mahalanobis distances per class pair (vae_eval.py:2826-2864)
        mahalanobis = {}
        for C in range(k):
            train_sigs = self.S_train_for_each_class[C]
            if len(train_sigs) < 2:
                continue
            mean, cov = music.get_mean_and_cov_from_vector_list(train_sigs)
            for other in range(k):
                for label, sig_list in (
                    ("original", original_sig_per_class[other]),
                    ("autoencoded", autoenc_sig_per_class[other]),
                    ("switched", switched_sig_per_class[other]),
                    ("instrument_switched", instr_switched_sig_per_class[other]),
                ):
                    if not sig_list:
                        continue
                    distances = [
                        music.mahalanobis_distance(s, mean, cov) for s in sig_list
                    ]
                    mahalanobis[f"{label}_{other}_to_train_{C}"] = (
                        float(np.mean(distances)), float(np.std(distances)),
                    )
        self.results["signature_mahalanobis"] = mahalanobis

        if sec.save_anything:
            self._write_csv(metrics_rows)
            self._plot_safely(self._plot_switch_matrices, switch_matrix)

    def _write_csv(self, rows: list[dict]) -> None:
        keys: list[str] = []
        for row in rows:
            for key in row:
                if key not in keys:
                    keys.append(key)
        path = os.path.join(self.save_folder, "evaluation_metrics.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(keys)
            for row in rows:
                w.writerow([row.get(key, "") for key in keys])

    def _plot_switch_matrices(self, switch_matrix: np.ndarray) -> None:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        from ..config import INSTRUMENT_CATEGORY_NAMES

        k = self.cfg.num_classes
        for C in range(k):
            for C_switch in range(k):
                confusion = switch_matrix[C, C_switch]
                total = confusion.sum()
                if total == 0:
                    continue
                switched = total - np.sum(np.diag(confusion))
                row_sums = confusion.sum(axis=1, keepdims=True)
                # out= is required: np.divide(..., where=...) leaves the
                # unselected entries UNINITIALIZED (garbage/NaN), which
                # crashed matplotlib's tick locator downstream
                normed = np.divide(
                    confusion, row_sums,
                    out=np.zeros_like(confusion), where=row_sums > 0,
                )
                plt.figure()
                plt.imshow(normed, interpolation="nearest")
                plt.title(
                    f"{self.cfg.classes[C]} to {self.cfg.classes[C_switch]}: "
                    f"switched {switched / total * 100.0:6.2f}%"
                )
                plt.ylabel("Original instrument")
                plt.xlabel("Switched instrument")
                if confusion.shape[0] == 16:
                    plt.xticks(np.arange(16), INSTRUMENT_CATEGORY_NAMES, rotation="vertical")
                    plt.yticks(np.arange(16), INSTRUMENT_CATEGORY_NAMES)
                plt.colorbar()
                plt.tight_layout()
                plt.savefig(
                    os.path.join(
                        self.save_folder,
                        f"aaa_switch_matrix_{self.cfg.classes[C]}_to_"
                        f"{self.cfg.classes[C_switch]}.png",
                    )
                )
                plt.close()

    # ------------------------------------------------------------------
    def run(self, sections: EvalSections | None = None, log_fn=print) -> dict:
        sec = sections or EvalSections()
        self.section_dataset_stats(sec)
        log_fn(f"dataset: {self.results['dataset_counts']}")
        self.section_program_stats(sec)
        if sec.harmonicity_evaluations:
            log_fn("harmonicity statistics...")
            self.section_harmonicity(sec)
        if sec.max_new_chosen_interpolation_songs:
            log_fn("chosen interpolation medleys...")
            self.section_chosen_interpolations(sec)
        if sec.max_new_sampled_interpolation_songs:
            log_fn("random interpolations...")
            self.section_random_interpolations(sec)
        if sec.latent_sweep:
            log_fn("latent sweep...")
            self.section_latent_sweep(sec)
        if sec.chord_evaluation:
            log_fn("chord latent probes...")
            self.section_chord_evaluation(sec)
        if sec.evaluate_different_sampling_regions:
            log_fn("sampling-region probes...")
            self.section_sampling_regions(sec)
        if sec.pitch_evaluation:
            log_fn("pitch latent probes...")
            self.section_pitch_evaluation(sec)
        if sec.max_new_sampled_songs:
            log_fn("random song generation...")
            self.section_random_songs(sec)
        if sec.max_new_sampled_long_songs:
            log_fn("long song generation...")
            self.section_long_songs(sec)
        if sec.evaluate_autoencoding_and_stuff:
            log_fn("autoencoding + style-switch evaluation...")
            self.section_autoencoding(sec)
        if sec.save_anything:
            self._dump_results_json()
        return self.results

    def _dump_results_json(self) -> None:
        # Non-finite floats become JSON null at DUMP time only: sweep stats
        # replicate the reference's single-element-window NaN strength edge
        # bit-for-bit (evaluation/sweep.py, pinned by the --sweepstats
        # differential), and Python's json would otherwise emit a bare
        # ``NaN`` literal that standard parsers reject. The in-memory
        # ``self.results`` values stay untouched.
        def sanitize(o):
            if isinstance(o, dict):
                return {k: sanitize(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return [sanitize(v) for v in o]
            if isinstance(o, np.ndarray):
                return sanitize(o.tolist())
            if isinstance(o, (np.floating, np.integer)):
                o = o.item()
            if isinstance(o, float) and not math.isfinite(o):
                return None
            return o

        with open(os.path.join(self.save_folder, "results.json"), "w") as f:
            json.dump(
                sanitize(self.results), f, default=str, indent=1,
                allow_nan=False,
            )
