"""Decoder-output sampling and postprocessing (host-side numpy).

A copy of ``midi_vae_tpu/evaluation/sampling.py`` (the port imports nothing
of the JAX package): temperature / argmax / choice sampling of the heads'
probabilities, silent-note handling, the velocity/pitch consistency
override, and defaults for missing heads. The semantics are unchanged: the
same probability arrays and the same ``RandomState`` give the same rolls.
The decode itself runs batched on the device (``generation.py``).
"""

from __future__ import annotations

import numpy as np

from ..config import Config


def sample_vector(
    vector: np.ndarray,
    sample_method: str,
    temperature: float = 1.0,
    cutoff_sample_threshold: float = 0.0,
    number_of_tries: int = 1,
    rng: np.random.RandomState | None = None,
) -> int:
    """Pick an index from a probability vector (vae_definition.py:1048-1067)."""
    if np.sum(vector) <= 0:
        return 0
    if sample_method == "argmax":
        return int(np.argmax(vector))
    if sample_method != "choice":
        raise ValueError(f"unknown sample_method {sample_method!r}")
    rng = rng or np.random
    vector = np.asarray(vector, dtype=np.float64)
    vector = vector / vector.sum()
    with np.errstate(divide="ignore"):
        logv = np.log(vector) / temperature
    vector = np.exp(logv - logv.max())
    vector = vector / vector.sum()
    max_index = 0
    for _ in range(max(1, number_of_tries)):
        max_index = int(rng.choice(len(vector), p=vector))
        if vector[max_index] > cutoff_sample_threshold:
            break
    return max_index


def sample_notes_prediction(
    Y: np.ndarray, sample_method: str, cfg: Config, rng=None
) -> np.ndarray:
    """(B, T, out_dim) or (T, out_dim) probs -> flat one-hot (steps, pitches)
    with silent rows all-zero (vae_definition.py:1071-1095)."""
    assert Y.ndim in (2, 3)
    if Y.ndim == 3:
        Y = Y.reshape(-1, Y.shape[-1])
    out = np.zeros((Y.shape[0], cfg.new_num_notes), dtype=np.float32)
    if sample_method == "argmax":
        # vectorized fast path (the evaluation harness default); an all-zero
        # row argmaxes to 0 = pitch 0, exactly like the reference's
        # sample_vector else-branch (vae_definition.py:1065-1066) and our
        # loop path / device-argmax path
        idx = np.argmax(Y, axis=-1)
        keep = idx < cfg.new_num_notes
        if cfg.include_silent_note:
            keep &= idx != Y.shape[-1] - 1
        rows = np.nonzero(keep)[0]
        out[rows, idx[rows]] = 1
        return out
    for i, step in enumerate(Y):
        idx = sample_vector(
            step, sample_method, cfg.temperature, cfg.cutoff_sample_threshold,
            cfg.number_of_tries, rng,
        )
        if cfg.include_silent_note and idx == len(step) - 1:
            continue
        if idx < cfg.new_num_notes:
            out[i, idx] = 1
    return out


def sample_instrument_prediction(I: np.ndarray, sample_method: str, cfg: Config, rng=None):
    """Recursive one-hot sampling over the last axis (vae_def.py:1097-1107)."""
    if I.ndim > 1:
        if sample_method == "argmax":
            flat = I.reshape(-1, I.shape[-1])
            out = np.zeros_like(flat, dtype=np.float32)
            idx = np.argmax(flat, axis=-1)
            idx = np.where(flat.sum(axis=-1) > 0, idx, 0)
            out[np.arange(len(flat)), idx] = 1
            return out.reshape(I.shape)
        return np.asarray(
            [sample_instrument_prediction(row, sample_method, cfg, rng) for row in I]
        )
    idx = sample_vector(
        I, sample_method, cfg.temperature, cfg.cutoff_sample_threshold,
        cfg.number_of_tries, rng,
    )
    out = np.zeros(I.shape, dtype=np.float32)
    out[idx] = 1
    return out


def sample_held_notes_prediction(D: np.ndarray, sample_method: str, cfg: Config, rng=None):
    """Categorical (.., 2) -> flat 0/1 held flags (vae_def.py:1109-1122)."""
    if D.ndim > 1:
        if sample_method == "argmax":
            flat = D.reshape(-1, D.shape[-1])
            idx = np.argmax(flat, axis=-1)
            idx = np.where(flat.sum(axis=-1) > 0, idx, 0)
            return idx.astype(np.float32)
        out: list[int] = []
        for row in D:
            pred = sample_held_notes_prediction(row, sample_method, cfg, rng)
            if isinstance(pred, int):
                out.append(pred)
            else:
                out.extend(pred)
        return np.asarray(out, dtype=np.float32)
    return int(
        sample_vector(
            D, sample_method, cfg.temperature, cfg.cutoff_sample_threshold,
            cfg.number_of_tries, rng,
        )
    )


def override_pitches_from_velocity(Y: np.ndarray, V: np.ndarray, cfg: Config) -> np.ndarray:
    """Velocity/pitch consistency pass (vae_definition.py:1161-1190).

    Vectorized per voice: previous_velocity is a forward-fill of the last
    non-silent velocity, previous_pitch a one-step shift. Returns V (new
    array)."""
    thr = cfg.velocity_threshold
    mv = cfg.max_voices
    V = np.asarray(V, np.float64).copy()
    steps = Y.shape[0] // mv
    if steps == 0:
        return V
    pitch = np.where(Y.sum(axis=1) > 0, Y.argmax(axis=1), -1).reshape(steps, mv)
    vel = V.reshape(steps, mv)
    vel_silent = vel < thr
    prev_pitch = np.vstack([np.full((1, mv), -1, pitch.dtype), pitch[:-1]])
    # previous loud velocity: forward-fill of vel where loud, shifted by one
    loud = ~vel_silent
    idx = np.where(loud, np.arange(steps)[:, None], -1)
    idx = np.maximum.accumulate(idx, axis=0)
    idx_prev = np.vstack([np.full((1, mv), -1), idx[:-1]])
    prev_vel = np.where(
        idx_prev >= 0,
        np.take_along_axis(vel, np.maximum(idx_prev, 0), axis=0),
        0.0,
    )
    pitch_silent = pitch < 0
    rule1 = vel_silent & ~pitch_silent & (prev_pitch > 0) & (prev_pitch != pitch)
    rule2 = ~vel_silent & pitch_silent
    out = np.where(rule1, prev_vel, vel)
    out = np.where(rule2, 0.0, out)
    return out.reshape(-1)


def _override_pitches_from_velocity_loop(Y: np.ndarray, V: np.ndarray, cfg: Config) -> np.ndarray:
    """Reference per-step loop (kept for the equivalence test)."""
    thr = cfg.velocity_threshold
    mv = cfg.max_voices
    for voice in range(mv):
        previous_pitch = -1
        previous_velocity = 0.0
        voice_pitch_roll = Y[voice::mv]
        voice_velocity_roll = V[voice::mv]
        for i, (note_vector, velocity) in enumerate(
            zip(voice_pitch_roll, voice_velocity_roll)
        ):
            pitch_is_silent = np.sum(note_vector) == 0
            pitch = -1 if pitch_is_silent else int(np.argmax(note_vector))
            velocity_is_silent = velocity < thr
            if velocity_is_silent:
                if not pitch_is_silent and previous_pitch > 0 and previous_pitch != pitch:
                    V[i * mv + voice] = previous_velocity
            else:
                if pitch_is_silent:
                    V[i * mv + voice] = 0
            previous_pitch = pitch
            if not velocity_is_silent:
                previous_velocity = velocity
    return V


def process_decoder_outputs(
    outputs: dict[str, np.ndarray],
    sample_method: str,
    cfg: Config,
    rng=None,
    independent_windows: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Head probabilities -> (Y, I, V, D, N) arrays
    (vae_definition.py:1131-1225).

    ``outputs`` maps head name -> probability array:
      notes (B, T, out_dim); instrument (B, mv, inst_dim);
      velocity (B, T, 1); held (B, T, 2); next (B, T, out_dim).
    Returns: Y (B*T, new_num_notes) one-hot w/ silent rows zero;
      I (B, mv, inst_dim) one-hot; V (B*T,), D (B*T,), N like Y.

    ``independent_windows``: process each batch row separately, matching
    callers of the reference that run ``decoder.predict`` once per window
    (e.g. the latent sweep, vae_evaluation.py:1136-1146): the
    velocity-override previous-pitch chain (vae_definition.py:1160-1190)
    then resets at every window boundary instead of running across the
    whole batch.
    """
    if independent_windows and np.asarray(outputs["notes"]).shape[0] > 1:
        parts = [
            process_decoder_outputs(
                {k: np.asarray(v)[b : b + 1] for k, v in outputs.items()},
                sample_method, cfg, rng,
            )
            for b in range(np.asarray(outputs["notes"]).shape[0])
        ]
        return tuple(
            np.concatenate([p[j] for p in parts], axis=0) for j in range(5)
        )

    Y = I = V = D = N = None

    notes = np.asarray(outputs["notes"])
    num_samples = notes.shape[0]
    T = notes.shape[1]
    Y = sample_notes_prediction(notes, sample_method, cfg, rng)

    if "instrument" in outputs:
        I = sample_instrument_prediction(
            np.asarray(outputs["instrument"]), sample_method, cfg, rng
        )

    if "velocity" in outputs:
        vel = np.asarray(outputs["velocity"])  # (B, T, 1)
        V = vel[..., 0].reshape(-1).astype(np.float64)
        silent_rows = Y.sum(axis=1) == 0
        V[silent_rows] = 0
        if cfg.override_sampled_pitches_based_on_velocity_info:
            V = override_pitches_from_velocity(Y, V, cfg)

    if "held" in outputs:
        D = sample_held_notes_prediction(
            np.asarray(outputs["held"]), sample_method, cfg, rng
        )

    if "next" in outputs:
        N = sample_notes_prediction(
            np.asarray(outputs["next"]), sample_method, cfg, rng
        )

    length = Y.shape[0]
    # defaults for missing heads (vae_definition.py:1207-1223)
    if I is None:
        I = np.zeros(
            (length // T, cfg.max_voices, cfg.meta_instrument_dim), np.float32
        )
        I[:, :, 0] = 1  # all piano
    if V is None:
        V = np.ones((length,)) * (
            cfg.velocity_threshold + (1.0 - cfg.velocity_threshold) * 0.5
        )
    if D is None:
        D = np.ones((length,))
        if "velocity" in outputs:
            D[np.asarray(V) > cfg.velocity_threshold] = 0
    if N is None:
        N = np.zeros_like(Y)

    del num_samples
    # V stays float64: the renderer's int() un-scaling (tensorize.py) can
    # flip a velocity integer at an f32 rounding boundary
    return Y, I, np.asarray(V, np.float64), np.asarray(D, np.float64), N


def add_silent_column(Y: np.ndarray, cfg: Config) -> np.ndarray:
    """Append + mark the silent one-hot column (used to feed sampled rolls
    back into the encoder/classifiers, e.g. vae_evaluation.py:1878-1884)."""
    if not cfg.include_silent_note:
        return np.copy(Y)
    out = np.concatenate([Y, np.zeros((Y.shape[0], 1), Y.dtype)], axis=1)
    out[out.sum(axis=1) == 0, -1] = 1
    return out


def process_argmax_outputs(
    idx: dict[str, np.ndarray], cfg: Config, independent_windows: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Device-argmaxed head indices -> (Y, I, V, D, N).

    Mirror of ``process_decoder_outputs`` for the argmax sample method when
    the argmax already ran on the accelerator (GenerationContext fetches
    per-step indices instead of full probability tensors -- ~60x less
    host<->device traffic on the evaluation paths).

    idx keys: notes_idx (B, T) int; optional inst_idx (B, mv), vel (B, T),
    held_idx (B, T), next_idx (B, T).

    ``independent_windows``: see ``process_decoder_outputs``.
    """
    notes_idx = np.asarray(idx["notes_idx"])
    B, T = notes_idx.shape
    if independent_windows and B > 1:
        parts = [
            process_argmax_outputs(
                {k: np.asarray(v)[b : b + 1] for k, v in idx.items()}, cfg
            )
            for b in range(B)
        ]
        return tuple(
            np.concatenate([p[j] for p in parts], axis=0) for j in range(5)
        )

    def notes_onehot(ni):
        flat = ni.reshape(-1)
        out = np.zeros((flat.shape[0], cfg.new_num_notes), np.float32)
        keep = flat < cfg.new_num_notes
        if cfg.include_silent_note:
            keep &= flat != (cfg.output_dim - 1)
        rows = np.nonzero(keep)[0]
        out[rows, flat[rows]] = 1
        return out

    Y = notes_onehot(notes_idx)
    I = V = D = N = None

    if "inst_idx" in idx:
        ii = np.asarray(idx["inst_idx"]).reshape(-1)
        flat = np.zeros((ii.shape[0], cfg.meta_instrument_dim), np.float32)
        flat[np.arange(len(ii)), ii] = 1
        I = flat.reshape(B, cfg.max_voices, cfg.meta_instrument_dim)

    if "vel" in idx:
        V = np.asarray(idx["vel"], np.float64).reshape(-1)
        V[Y.sum(axis=1) == 0] = 0
        if cfg.override_sampled_pitches_based_on_velocity_info:
            V = override_pitches_from_velocity(Y, V, cfg)

    if "held_idx" in idx:
        D = np.asarray(idx["held_idx"], np.float32).reshape(-1)

    if "next_idx" in idx:
        N = notes_onehot(np.asarray(idx["next_idx"]))

    length = Y.shape[0]
    if I is None:
        I = np.zeros((B, cfg.max_voices, cfg.meta_instrument_dim), np.float32)
        I[:, :, 0] = 1
    if V is None:
        V = np.ones((length,)) * (
            cfg.velocity_threshold + (1.0 - cfg.velocity_threshold) * 0.5
        )
    if D is None:
        D = np.ones((length,))
        if "vel" in idx:
            D[np.asarray(V) > cfg.velocity_threshold] = 0
    if N is None:
        N = np.zeros_like(Y)
    return Y, I, np.asarray(V, np.float64), np.asarray(D, np.float64), N
