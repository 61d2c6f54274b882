"""Dataset statistics sections: harmonicity baselines + instrument programs.

A copy of ``midi_vae_tpu/evaluation/stats.py`` (the port imports nothing of
the JAX package); host-side numpy, the semantics unchanged. Re-implements
the reference's vae_evaluation.py:160-400: per-class song/window counts,
per-split and per-class harmonicity score-pair matrices, frankenstein
baselines (random pitches / cross-song voice mixes), and the per-class
instrument program probability tables used by the style-switch evaluation;
also the per-song reconstruction bookkeeping of the autoencoding section
(vae_evaluation.py:2205-2244, 2380-2415) as free functions.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import Config
from ..data.dataset import Dataset
from ..data.tensorize import instrument_matrix_to_programs
from ..utils import music


def dataset_counts(ds: Dataset, cfg: Config) -> dict:
    """Songs/windows per class for both splits (vae_evaluation.py:165-182)."""
    out = {
        "train_songs_per_class": [0] * cfg.num_classes,
        "train_samples_per_class": [0] * cfg.num_classes,
        "test_songs_per_class": [0] * cfg.num_classes,
        "test_samples_per_class": [0] * cfg.num_classes,
    }
    for i, C in enumerate(ds.C_train):
        out["train_songs_per_class"][C] += 1
        out["train_samples_per_class"][C] += ds.X_train[i].shape[0]
    for i, C in enumerate(ds.C_test):
        out["test_songs_per_class"][C] += 1
        out["test_samples_per_class"][C] += ds.X_test[i].shape[0]
    return out


# ---------------------------------------------------------------------------
# Harmonicity (vae_evaluation.py:193-299)
# ---------------------------------------------------------------------------

def _strip_silent(Y: np.ndarray, cfg: Config) -> np.ndarray:
    return Y[..., : cfg.new_num_notes]


def harmonicity_for_split(Y_list, C_list, cfg: Config) -> dict:
    """Mean score-pair matrices per split + per class."""
    spm = np.zeros((len(Y_list), cfg.max_voices, cfg.max_voices))
    for i, Y in enumerate(Y_list):
        spm[i] = music.get_harmonicity_scores_for_each_track_combination(
            _strip_silent(np.copy(Y), cfg), cfg.max_voices, cfg.smallest_note
        )
    with np.errstate(all="ignore"):
        result = {"mean": np.nanmean(spm, axis=0) if len(spm) else spm}
        per_class = []
        for C in range(cfg.num_classes):
            rows = spm[np.asarray(C_list) == C]
            per_class.append(np.nanmean(rows, axis=0) if len(rows) else rows)
        result["per_class"] = per_class
    return result


def frankenstein_random_pitches(cfg: Config, total_evaluations: int = 1000, rng=None):
    """Harmonicity of fully random bars (vae_evaluation.py:196-214)."""
    rng = rng or np.random.RandomState()
    spms = np.zeros((total_evaluations, cfg.max_voices, cfg.max_voices))
    T = cfg.output_length
    for i in range(total_evaluations):
        bar = np.zeros((1, T, cfg.new_num_notes))
        for step in range(T):
            for _ in range(5):
                if rng.randint(3) != 0:
                    bar[0, step, rng.randint(cfg.new_num_notes)] = 1
        spms[i] = music.get_harmonicity_scores_for_each_track_combination(
            bar, cfg.max_voices, cfg.smallest_note
        )
    with np.errstate(all="ignore"):
        return np.nanmean(spms, axis=0)


def frankenstein_from_songs(Y_list, cfg: Config, total_evaluations: int = 1000, rng=None):
    """Harmonicity of bars stitched from voices of DIFFERENT songs
    (vae_evaluation.py:219-242) -- the 'how bad can mixing get' baseline."""
    rng = rng or np.random.RandomState()
    mv = cfg.max_voices
    T = cfg.output_length
    if len(Y_list) < mv:
        return np.full((mv, mv), np.nan)
    spms = np.zeros((total_evaluations, mv, mv))
    for i in range(total_evaluations):
        choices = rng.choice(len(Y_list), mv, replace=False)
        bar = np.zeros((1, T, cfg.new_num_notes))
        for voice, choice in enumerate(choices):
            Y = Y_list[choice]
            picked = np.copy(Y[rng.randint(Y.shape[0])])
            picked = _strip_silent(picked, cfg)
            bar[0, voice::mv, :] = picked[0::mv, :]
        spms[i] = music.get_harmonicity_scores_for_each_track_combination(
            bar, mv, cfg.smallest_note
        )
    with np.errstate(all="ignore"):
        return np.nanmean(spms, axis=0)


# ---------------------------------------------------------------------------
# Instrument program statistics (vae_evaluation.py:301-400)
# ---------------------------------------------------------------------------

@dataclass
class ProgramStats:
    programs_for_each_class: list = field(default_factory=list)
    all_programs_plus_length_for_each_class: list = field(default_factory=list)
    total_programs_for_each_class: list = field(default_factory=list)
    program_probability_dict_for_each_class: list = field(default_factory=list)


def program_statistics(ds: Dataset, cfg: Config) -> ProgramStats:
    stats = ProgramStats(
        programs_for_each_class=[[] for _ in range(cfg.num_classes)],
        all_programs_plus_length_for_each_class=[[] for _ in range(cfg.num_classes)],
        total_programs_for_each_class=[0] * cfg.num_classes,
        program_probability_dict_for_each_class=[dict() for _ in range(cfg.num_classes)],
    )
    for i in range(len(ds.I_train)):
        C = ds.C_train[i]
        num_samples = ds.X_train[i].shape[0]
        programs = instrument_matrix_to_programs(
            ds.I_train[i], cfg.instrument_attach_method
        )
        for program in programs:
            if program not in stats.programs_for_each_class[C]:
                stats.programs_for_each_class[C].append(program)
        stats.all_programs_plus_length_for_each_class[C].append((programs, num_samples))
        stats.total_programs_for_each_class[C] += num_samples * cfg.max_voices
        d = stats.program_probability_dict_for_each_class[C]
        for program in programs:
            d[program] = d.get(program, 0) + num_samples
    for C, d in enumerate(stats.program_probability_dict_for_each_class):
        total = stats.total_programs_for_each_class[C]
        if total:
            for k in d:
                d[k] /= total
    return stats


def note_start_errors(Y: np.ndarray, Y_pred: np.ndarray, D_pred, cfg: Config) -> dict | None:
    """Note-start error rates of a reconstruction (vae_evaluation.py:2205-2244).

    A "note start" is a step whose predicted duration/held flag is 0; the
    reference counts how often such a step is silent in the prediction
    (``predicted_errors``) and in the original (``original_errors``),
    normalized by total steps. Only meaningful when a duration signal exists
    (held-notes head, or velocity head with a played-note threshold) -- the
    reference guards on the same condition and we return None otherwise.

    Shapes: ``Y`` is the original windows (num_samples, output_length, dim
    incl. silent column when configured); ``Y_pred``/``D_pred`` are the
    flattened decoder outputs (num_samples*output_length, ...).
    """
    if not (cfg.meta_held_notes or (cfg.meta_velocity and cfg.velocity_threshold > 0)):
        return None
    pred_silent = np.asarray(Y_pred).sum(axis=1) == 0
    if cfg.include_silent_note:
        orig_silent = np.asarray(Y)[:, :, -1].reshape(-1) == 1
    else:
        Y_flat = np.asarray(Y).reshape(-1, np.asarray(Y).shape[-1])
        orig_silent = Y_flat.sum(axis=1) == 0
    starts = np.asarray(D_pred).reshape(-1) == 0
    return {
        "predicted_note_start_to_predicted_errors": float(
            np.mean(pred_silent & starts)
        ),
        "predicted_note_start_to_original_errors": float(
            np.mean(orig_silent & starts)
        ),
    }


def pitch_reconstruction_stats(song: np.ndarray, Y_pred: np.ndarray) -> dict:
    """Note-level reconstruction accuracy (vae_evaluation.py:2380-2415).

    ``difference = 2*original + predicted`` classifies every cell: 3 = note
    correctly predicted, 2 = original note missed, 1 = spurious new note.
    Accuracy = correct / total original notes (0 when the song is empty --
    the reference would divide by zero there).
    """
    song = np.asarray(song)
    Y_pred = np.asarray(Y_pred)
    difference = song * 2 + Y_pred
    unique, counts = np.unique(difference, return_counts=True)
    diff_stats = dict(zip(unique, counts))
    total_original = int(np.count_nonzero(song))
    total_predicted = int(np.count_nonzero(Y_pred))
    correct = int(diff_stats.get(3, 0))
    return {
        "total_original_notes": total_original,
        "total_predicted_notes": total_predicted,
        "not_predicted_notes": int(diff_stats.get(2, 0)),
        "new_predicted_notes": int(diff_stats.get(1, 0)),
        "pitch_reconstruction_accuracy": (
            correct / total_original if total_original else 0.0
        ),
    }


def switch_percentage_between_classes(stats: ProgramStats, cfg: Config) -> np.ndarray:
    """How many instrument switches a style change implies on the train set
    (vae_evaluation.py:384-400). Returns (num_classes, num_classes)."""
    out = np.zeros((cfg.num_classes, cfg.num_classes))
    for C in range(cfg.num_classes):
        for C_switch in range(cfg.num_classes):
            if C == C_switch:
                continue
            same = different = 0.0
            for programs, length in stats.all_programs_plus_length_for_each_class[C]:
                for programs_sw, length_sw in stats.all_programs_plus_length_for_each_class[C_switch]:
                    for a, b in zip(programs, programs_sw):
                        if a == b:
                            same += length * length_sw
                        else:
                            different += length * length_sw
            out[C, C_switch] = different / (same + different) if (same + different) else 0.0
    return out
