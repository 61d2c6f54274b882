"""A copy of ``midi_vae_tpu/utils/music.py`` for the port, which imports
nothing of the JAX package.

Music-analysis utilities: harmonicity, signature vectors, roll transforms.

Re-implements the reference's data_class.py:25-252 (MuseGAN-derived tonal
distance metrics, 15-dim per-bar signature vectors, Mahalanobis tools and the
monophonic->k-hot transform) with the same semantics on numpy.

Deviation from the reference (SURVEY.md §2.4): ``tonal_dist`` tests BOTH
chromas for emptiness; the reference tests chroma1 twice (data_class.py:39).
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Harmonicity (data_class.py:25-88)
# ---------------------------------------------------------------------------

def get_tonal_matrix(r1: float = 1.0, r2: float = 1.0, r3: float = 0.5) -> np.ndarray:
    tm = np.empty((6, 12), dtype=np.float32)
    idx = np.arange(12)
    tm[0, :] = r1 * np.sin(idx * (7.0 / 6.0) * np.pi)
    tm[1, :] = r1 * np.cos(idx * (7.0 / 6.0) * np.pi)
    tm[2, :] = r2 * np.sin(idx * (3.0 / 2.0) * np.pi)
    tm[3, :] = r2 * np.cos(idx * (3.0 / 2.0) * np.pi)
    tm[4, :] = r3 * np.sin(idx * (2.0 / 3.0) * np.pi)
    tm[5, :] = r3 * np.cos(idx * (2.0 / 3.0) * np.pi)
    return tm


_TONAL_MATRIX = get_tonal_matrix()


def tonal_dist(beat_chroma1: np.ndarray, beat_chroma2: np.ndarray) -> float:
    """Tonal-centroid distance between two chroma vectors; nan if one is empty."""
    s1, s2 = np.sum(beat_chroma1), np.sum(beat_chroma2)
    if s1 == 0 or s2 == 0:
        return float("nan")
    c1 = _TONAL_MATRIX @ (beat_chroma1 / s1)
    c2 = _TONAL_MATRIX @ (beat_chroma2 / s2)
    return float(np.linalg.norm(c1 - c2))


def to_chroma(track: np.ndarray) -> np.ndarray:
    """(steps, 12k) pianoroll -> (steps, 12) chroma (data_class.py:50-52)."""
    return track.reshape(track.shape[0], 12, -1).sum(axis=2)


def metrics_harmonicity(
    chroma1: np.ndarray, chroma2: np.ndarray, resolution: int
) -> float:
    scores = []
    for r in range(chroma1.shape[0] // resolution):
        c1 = np.sum(chroma1[resolution * r : resolution * (r + 1)], axis=0)
        c2 = np.sum(chroma2[resolution * r : resolution * (r + 1)], axis=0)
        scores.append(tonal_dist(c1, c2))
    if not scores or np.all(np.isnan(scores)):
        return float("nan")
    with np.errstate(all="ignore"):
        return float(np.nanmean(scores))


def get_harmonicity_scores_for_each_track_combination(
    unrolled_pianoroll: np.ndarray, max_voices: int, smallest_note: int = 16
) -> np.ndarray:
    """All-pairs voice tonal distances (data_class.py:65-88)."""
    resolution = smallest_note // 4
    if unrolled_pianoroll.ndim > 2:
        spm = np.stack(
            [
                get_harmonicity_scores_for_each_track_combination(
                    s, max_voices, smallest_note
                )
                for s in unrolled_pianoroll
            ]
        )
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return np.nanmean(spm, axis=0)

    matrix = np.zeros((max_voices, max_voices))
    chromas = [
        to_chroma(np.copy(unrolled_pianoroll[v::max_voices]))
        for v in range(max_voices)
    ]
    for v1 in range(max_voices):
        for v2 in range(v1):
            matrix[v1, v2] = metrics_harmonicity(chromas[v1], chromas[v2], resolution)
            matrix[v2, v1] = matrix[v1, v2]
    return matrix


# ---------------------------------------------------------------------------
# Signature vectors (data_class.py:96-221)
# ---------------------------------------------------------------------------

SIGNATURE_VECTOR_LENGTH = 15


def get_statistics_on_list(values, scale: float = 1.0) -> list[float]:
    if len(values) > 0:
        arr = np.asarray(values, dtype=np.float64)
        stats = [arr.max(), arr.min(), arr.mean(), arr.std()]
    else:
        stats = [0.0, 0.0, 0.0, 0.0]
    return [float(s) / scale for s in stats]


def signature_from_index(song: list[tuple[int, ...]]) -> list[float]:
    """15-dim per-bar style statistics (data_class.py:116-206).

    ``song`` is a list of per-step tuples of sounding pitches.
    """
    polyphonic_count = 0
    previous_notes: tuple[int, ...] = ()
    all_notes: list[int] = []
    intervals: list[int] = []
    durations: list[int] = []
    held_notes: list[int] = []
    held_len: list[int] = []

    for notes in song:
        # close held notes that stopped sounding
        for note in list(held_notes):
            idx = held_notes.index(note)
            if note not in notes:
                durations.append(held_len[idx])
                del held_notes[idx]
                del held_len[idx]

        for note in notes:
            all_notes.append(note)
            if note in held_notes:
                held_len[held_notes.index(note)] += 1
            else:
                held_notes.append(note)
                held_len.append(1)

        # consecutive-note intervals with nearest-pitch matching for
        # unequal chord sizes (data_class.py:147-173)
        if len(notes) != len(previous_notes) and len(notes) != 0 and len(previous_notes) != 0:
            if len(notes) < len(previous_notes):
                shorter, longer = notes, previous_notes
            else:
                shorter, longer = previous_notes, notes
            shortest = [
                min(abs(pitch - other) for other in shorter) for pitch in longer
            ]
            # plain np.argsort (no kind=) exactly like data_class.py:164 so
            # tie-breaking among equal distances matches the reference
            # bit-for-bit (verified by tools/ref_parity_check.py --analysis)
            truncated = [
                longer[i] for i in np.argsort(shortest)[: len(shorter)]
            ]
            pairs = zip(sorted(shorter), sorted(truncated))
        else:
            pairs = zip(sorted(notes), sorted(previous_notes))
        for n1, n2 in pairs:
            intervals.append(abs(n1 - n2))

        if len(notes) > 1:
            polyphonic_count += 1
        if len(notes) > 0:
            previous_notes = notes
        else:
            durations.extend(held_len)
            held_notes = []
            held_len = []

    sig: list[float] = []
    sig.append(len(durations) / len(song))
    sig.append(len(all_notes) / len(song))
    sig.append(polyphonic_count / len(song))
    sig.extend(get_statistics_on_list(all_notes, scale=127))
    sig.extend(get_statistics_on_list(intervals, scale=127))
    sig.extend(get_statistics_on_list(durations, scale=1.0))
    return sig


def signature_from_pianoroll(pianoroll: np.ndarray, low_crop: int = 24) -> list[float]:
    """(steps, pitches) polyphonic roll -> signature (data_class.py:208-215)."""
    song = []
    for step in pianoroll:
        indices = np.nonzero(step)[0]
        song.append(tuple(int(x) + low_crop for x in indices))
    return signature_from_index(song)


def signature_from_unrolled_pianoroll(
    pianoroll: np.ndarray,
    max_voices: int,
    include_silent_note: bool,
    low_crop: int = 24,
) -> list[float]:
    poly = monophonic_to_khot_pianoroll(pianoroll, max_voices)
    if include_silent_note:
        poly = poly[:, :-1]
    return signature_from_pianoroll(poly, low_crop=low_crop)


# ---------------------------------------------------------------------------
# Mahalanobis tools (data_class.py:225-233)
# ---------------------------------------------------------------------------

def mahalanobis_distance(x: np.ndarray, mean: np.ndarray, cov: np.ndarray) -> float:
    cov_inv = np.linalg.pinv(cov)
    diff = np.asarray(x) - mean
    return float(np.sqrt(diff @ cov_inv @ diff.T))


def get_mean_and_cov_from_vector_list(vectors) -> tuple[np.ndarray, np.ndarray]:
    arr = np.asarray(vectors)
    return np.mean(arr, axis=0), np.cov(arr.T)


# ---------------------------------------------------------------------------
# Pianoroll transforms (data_class.py:241-252)
# ---------------------------------------------------------------------------

def monophonic_to_khot_pianoroll(
    pianoroll: np.ndarray, max_voices: int, set_all_nonzero_to_1: bool = True
) -> np.ndarray:
    """Unrolled monophonic rows -> polyphonic k-hot rows."""
    assert max_voices > 1
    steps = pianoroll.shape[0] // max_voices
    poly = (
        pianoroll[: steps * max_voices]
        .reshape(steps, max_voices, pianoroll.shape[1])
        .sum(axis=1)
    )
    if set_all_nonzero_to_1:
        poly = (poly > 0).astype(pianoroll.dtype)
    return poly
