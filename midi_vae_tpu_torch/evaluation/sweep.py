"""Latent sweep: per-dimension influence analysis over the latent space.

A copy of ``midi_vae_tpu/evaluation/sweep.py`` over the port's
``GenerationContext``. The reference's heaviest hot loop
(vae_evaluation.py:891-1304) calls ``decoder.predict`` once per (dimension,
value) pair; here all values of a chunk of dimensions (about 256 latents)
are decoded in one batched call, kernel B's three launches a call on the
card.

Statistics machinery (strength/probability/direction of a monotone trend,
per-metric best-dimension summaries) mirrors vae_evaluation.py:913-1114.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import scipy.stats

from ..config import Config
from ..data.tensorize import instrument_matrix_to_programs
from ..utils import music
from . import sampling
from .generation import GenerationContext, vote_for_programs


def get_normal_distributed_values(
    range_end: float,
    evaluations_per_dimension: int,
    sigma: float,
    evaluate_positive_and_negative: bool,
) -> list[float]:
    """Gauss-spaced sweep values (vae_evaluation.py:898-911)."""
    values: list[float] = []
    cdf_values = np.linspace(0.5, 0.5 + float(range_end), evaluations_per_dimension)
    for cdf in cdf_values:
        x = float(scipy.stats.norm.ppf(cdf, loc=0.0, scale=sigma))
        if x != 0:
            if evaluate_positive_and_negative:
                values.append(-x)
            values.append(x)
        else:
            values.append(x)
    return sorted(values)


def get_strength_probability_direction(value_list) -> tuple[float, float, str]:
    """Monotone-trend strength/probability (vae_evaluation.py:917-951)."""
    value_list = list(value_list)
    if not value_list:
        return 0.0, 0.0, "ascending"
    if np.mean(value_list[: len(value_list) // 2]) > np.mean(
        value_list[len(value_list) // 2 :]
    ):
        value_list = value_list[::-1]
        direction = "descending"
    else:
        direction = "ascending"
    diffs = np.asarray(value_list[1:]) - np.asarray(value_list[:-1])
    # single-element lists: the reference takes np.mean of an empty diff
    # array -> nan strength (vae_evaluation.py:930-931); replicated so
    # influence/best-peak aggregation matches bit-for-bit
    if len(diffs):
        strength = float(np.mean(diffs))
    else:
        strength = float("nan")
    correct = int(np.sum(diffs >= 0))
    incorrect = len(diffs) - correct
    probability = correct / (correct + incorrect) if (correct + incorrect) else 0.0
    return strength, probability, direction


_STATS = {
    "mean": np.mean,
    "median": np.median,
    "std": np.std,
    "max": np.max,
    "min": np.min,
    "range": lambda v: np.max(v) - np.min(v),
}


def evaluate_statistic_value(splitted_list, value_name: str, statistic_name: str):
    values = [
        float(_STATS[statistic_name](v)) for v in splitted_list if len(v) > 0
    ]
    strength, probability, direction = get_strength_probability_direction(values)
    return (f"{statistic_name}_{value_name}_{direction}", strength, probability)


def evaluate_count_of_values(splitted_list, value_name: str, specific_value=None):
    counts = [
        len(v) if specific_value is None else list(v).count(specific_value)
        for v in splitted_list
    ]
    strength, probability, direction = get_strength_probability_direction(counts)
    return (f"total_count_of_{value_name}_{direction}", strength, probability)


def evaluate_change_of_values(splitted_list, value_name: str):
    previous = splitted_list[0]
    change = total = 0.0
    for values in splitted_list[1:]:
        for cur, prev in zip(values, previous):
            total += 1.0
            if cur != prev:
                change += 1.0
        previous = values
    return (f"total_change_of_{value_name}", change / total if total else 0.0, 1.0)


def run_all_statistics(list_of_lists, name: str, d: dict) -> None:
    for stat in ("mean", "median", "min", "max", "range", "std"):
        key, s, p = evaluate_statistic_value(list_of_lists, name, stat)
        d[key] = (s, p)


# ---------------------------------------------------------------------------
# Per-modality sweep evaluations (vae_evaluation.py:1018-1114)
# ---------------------------------------------------------------------------

def evaluate_velocityroll(V: np.ndarray, cfg: Config, velocity_predict=None) -> dict:
    d: dict = {}
    T = cfg.output_length
    if not np.any(V > cfg.velocity_threshold):
        return d
    splits = np.split(V, int(V.shape[0] / T))
    note_start_lists, velocity_lists = [], []
    for roll in splits:
        starts = np.where(roll > cfg.velocity_threshold)[0]
        note_start_lists.append(list(starts))
        velocity_lists.append(list(roll[starts]))
    if velocity_predict is not None:
        preds = velocity_predict(np.expand_dims(np.asarray(splits), 2))
        cls0 = [[float(p[0])] for p in preds]
        key, s, p = evaluate_statistic_value(cls0, "velocitystyle", "mean")
        d[key] = (s, p)
    run_all_statistics(velocity_lists, "velocity", d)
    run_all_statistics(note_start_lists, "note_starts", d)
    key, s, p = evaluate_count_of_values(note_start_lists, "note_starts")
    d[key] = (s, p)
    return d


def evaluate_pitchroll(Y: np.ndarray, cfg: Config, pitch_predict=None) -> dict:
    d: dict = {}
    if np.count_nonzero(Y) == 0:
        return d
    mv = cfg.max_voices
    bars_per_window = cfg.output_length // mv
    poly = music.monophonic_to_khot_pianoroll(Y, mv)
    splits = np.split(poly, int(poly.shape[0] / bars_per_window))
    pitch_lists = []
    for song in splits:
        notes: list[int] = []
        for step in range(song.shape[0]):
            notes.extend(int(n) for n in np.nonzero(song[step])[0])
        pitch_lists.append(notes)
    run_all_statistics(pitch_lists, "pitch", d)
    for args in (
        evaluate_count_of_values(pitch_lists, "pitch"),
        evaluate_count_of_values(pitch_lists, "specificpitch35", 35),
        evaluate_count_of_values(pitch_lists, "specificpitch39", 39),
    ):
        d[args[0]] = (args[1], args[2])
    if pitch_predict is not None:
        unrolled = np.asarray(np.split(Y, int(Y.shape[0] / cfg.output_length)))
        with_silent = np.stack(
            [sampling.add_silent_column(w, cfg) for w in unrolled]
        )
        preds = pitch_predict(with_silent)
        cls0 = [[float(p[0])] for p in preds]
        key, s, p = evaluate_statistic_value(cls0, "pitchstyle", "mean")
        d[key] = (s, p)
    return d


def evaluate_instrumentlist(I_list: np.ndarray, cfg: Config, instrument_predict=None) -> dict:
    d: dict = {}
    program_list = [
        instrument_matrix_to_programs(m, cfg.instrument_attach_method)
        for m in I_list
    ]
    if instrument_predict is not None:
        preds = instrument_predict(np.asarray(I_list))
        cls0 = [[float(p[0])] for p in preds]
        key, s, p = evaluate_statistic_value(cls0, "instrumentstyle", "mean")
        d[key] = (s, p)
    for args in (
        evaluate_change_of_values(program_list, "instruments"),
        evaluate_count_of_values(program_list, "pianos", 0),
    ):
        d[args[0]] = (args[1], args[2])
    return d


# ---------------------------------------------------------------------------
# The sweep itself
# ---------------------------------------------------------------------------

def sweep_dimension(
    ctx: GenerationContext,
    z: np.ndarray,
    values: list[float],
    dim: int,
    sample_method: str = "argmax",
):
    """Decode all ``values`` substituted on latent ``dim`` in ONE batch.

    z: (1, latent). Returns (Y, I, V, D) stacked across values -- layout
    identical to the reference's per-value extend loop
    (vae_evaluation.py:1125-1156).
    """
    zs = np.repeat(np.asarray(z, np.float32), len(values), axis=0)
    zs[:, dim] = np.asarray(values, np.float32)
    # the reference decodes per value (B=1 predict calls) -> window-
    # independent post-processing
    return ctx.decode_and_process(
        zs, sample_method=sample_method, independent_windows=True
    )[:4]


def sweep_dimensions_chunked(
    ctx: GenerationContext,
    z: np.ndarray,
    values: list[float],
    dims: list[int],
    sample_method: str = "argmax",
):
    """Decode a CHUNK of dimensions in one device call (dim-major layout).

    The reference decodes once per (dim, value) pair -- latent_dim x values
    sequential predicts per sample (vae_evaluation.py:1178-1191, its worst
    hot loop). This batches len(dims) x len(values) latents together and
    yields per-dim (Y, I, V, D) views.
    """
    nv = len(values)
    zs = np.repeat(np.asarray(z, np.float32), len(dims) * nv, axis=0)
    for j, dim in enumerate(dims):
        zs[j * nv : (j + 1) * nv, dim] = np.asarray(values, np.float32)
    # the reference decodes per value (B=1 predict calls) -> window-
    # independent post-processing
    Y, I, V, D, _ = ctx.decode_and_process(
        zs, sample_method=sample_method, independent_windows=True
    )
    T = ctx.cfg.output_length
    for j, dim in enumerate(dims):
        yield (
            dim,
            Y[j * nv * T : (j + 1) * nv * T],
            I[j * nv : (j + 1) * nv],
            V[j * nv * T : (j + 1) * nv * T],
            D[j * nv * T : (j + 1) * nv * T],
        )


def latent_sweep_over_all_dimensions(
    ctx: GenerationContext,
    start_latent_vectors: np.ndarray,
    sigma: float,
    range_end_in_stds: float = 3.0,
    evaluations_per_dimension: int = 5,
    evaluate_positive_and_negative: bool = True,
    pitch_predict=None,
    velocity_predict=None,
    instrument_predict=None,
    sample_method: str = "argmax",
    log_fn=print,
) -> dict:
    """Sweep every latent dimension for every start vector; aggregate
    per-metric influence and best dimensions (vae_evaluation.py:1123-1202).

    Returns {
      'influence': (latent_dim,) dict per dim of metric->score,
      'best_peaks': metric -> (strength, probability, dim),
      'best_dims':  metric -> overall best dim by accumulated influence,
      'values': the sweep values used,
    }
    """
    cfg = ctx.cfg
    num_samples, latent_size = start_latent_vectors.shape
    influence = [defaultdict(float) for _ in range(latent_size)]
    best_peaks: dict[str, tuple] = {}

    range_end = scipy.stats.norm.cdf(range_end_in_stds * sigma, loc=0.0, scale=sigma) - 0.5
    values = get_normal_distributed_values(
        range_end, evaluations_per_dimension, sigma, evaluate_positive_and_negative
    )

    dim_chunk = max(1, 256 // max(1, len(values)))  # ~256 latents per call
    for i in range(num_samples):
        log_fn(f"Sweeping sample {i + 1} of {num_samples}")
        z = start_latent_vectors[i : i + 1]
        summaries = [None] * latent_size
        for start in range(0, latent_size, dim_chunk):
            dims = list(range(start, min(start + dim_chunk, latent_size)))
            for dim, Y, I, V, D in sweep_dimensions_chunked(
                ctx, z, values, dims, sample_method
            ):
                summary: dict = {}
                summary.update(evaluate_pitchroll(Y, cfg, pitch_predict))
                summary.update(evaluate_velocityroll(V, cfg, velocity_predict))
                summary.update(evaluate_instrumentlist(I, cfg, instrument_predict))
                summaries[dim] = summary
                for key, (strength, probability) in summary.items():
                    influence[dim][key] += strength * probability
        for dim, summary in enumerate(summaries):
            for key, (strength, probability) in summary.items():
                if key not in best_peaks:
                    best_peaks[key] = (strength, probability, dim)
                else:
                    bs, bp, _bd = best_peaks[key]
                    if strength >= bs and probability >= bp:
                        best_peaks[key] = (strength, probability, dim)

    best_dims = {}
    for key in best_peaks:
        scores = [influence[dim][key] for dim in range(latent_size)]
        best_dims[key] = int(np.argmax(scores))

    return {
        "influence": influence,
        "best_peaks": best_peaks,
        "best_dims": best_dims,
        "values": values,
    }


def render_sweeped_songs(
    ctx: GenerationContext,
    z_song: np.ndarray,
    dim: int,
    value: float,
    sample_method: str = "argmax",
):
    """Decode a whole song's latents with one dimension pinned (the sweep MIDI
    rendering path, vae_evaluation.py:1224-1274). Returns (Y, programs, V, D).

    Decodes through the reference's prepare_decoder_input defaults
    (vae_evaluation.py:1136-1138): ROLLED history of the pinned latents,
    additional input = class 0 + zero signature."""
    from ..data.batching import history_from_latents

    zs = np.copy(np.atleast_2d(z_song)).astype(np.float32)
    zs[:, dim] = value
    Y, I, V, D, _ = ctx.decode_and_process(
        zs, history=history_from_latents(zs),
        additional=ctx.additional_for(0, None, len(zs)),
        sample_method=sample_method,
    )
    programs = vote_for_programs(I, ctx.cfg)
    return Y, programs, V, D
