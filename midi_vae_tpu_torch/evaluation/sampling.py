"""Decoder-output post-processing for the argmax path (host-side numpy).

A copy of ``process_argmax_outputs``, the helper it calls and
``add_silent_column`` from ``midi_vae_tpu/evaluation/sampling.py`` (the port
imports nothing of the JAX package). The semantics are unchanged.
"""

from __future__ import annotations

import numpy as np

from ..config import Config


def add_silent_column(Y: np.ndarray, cfg: Config) -> np.ndarray:
    """Append + mark the silent one-hot column (used to feed sampled rolls
    back into the encoder/classifiers, e.g. vae_evaluation.py:1878-1884)."""
    if not cfg.include_silent_note:
        return np.copy(Y)
    out = np.concatenate([Y, np.zeros((Y.shape[0], 1), Y.dtype)], axis=1)
    out[out.sum(axis=1) == 0, -1] = 1
    return out


def override_pitches_from_velocity(Y: np.ndarray, V: np.ndarray, cfg: Config) -> np.ndarray:
    """Velocity/pitch consistency pass, vectorized per voice: the previous
    velocity is a forward-fill of the last non-silent velocity, the previous
    pitch a one-step shift. Returns V (new array)."""
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
    loud = ~vel_silent
    idx = np.where(loud, np.arange(steps)[:, None], -1)
    idx = np.maximum.accumulate(idx, axis=0)
    idx_prev = np.vstack([np.full((1, mv), -1), idx[:-1]])
    prev_vel = np.where(
        idx_prev >= 0, np.take_along_axis(vel, np.maximum(idx_prev, 0), axis=0), 0.0
    )
    pitch_silent = pitch < 0
    rule1 = vel_silent & ~pitch_silent & (prev_pitch > 0) & (prev_pitch != pitch)
    rule2 = ~vel_silent & pitch_silent
    out = np.where(rule1, prev_vel, vel)
    out = np.where(rule2, 0.0, out)
    return out.reshape(-1)


def process_argmax_outputs(
    idx: dict[str, np.ndarray], cfg: Config, independent_windows: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Device-argmaxed head indices -> (Y, I, V, D, N).

    idx keys: notes_idx (B, T) int; optional inst_idx (B, mv), vel (B, T),
    held_idx (B, T), next_idx (B, T). ``independent_windows`` post-processes
    each window on its own (the velocity override chain then resets at every
    window boundary)."""
    notes_idx = np.asarray(idx["notes_idx"])
    B, T = notes_idx.shape
    if independent_windows and B > 1:
        parts = [
            process_argmax_outputs({k: np.asarray(v)[b : b + 1] for k, v in idx.items()}, cfg)
            for b in range(B)
        ]
        return tuple(np.concatenate([p[j] for p in parts], axis=0) for j in range(5))

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
        V = np.ones((length,)) * (cfg.velocity_threshold + (1.0 - cfg.velocity_threshold) * 0.5)
    if D is None:
        D = np.ones((length,))
        if "vel" in idx:
            D[np.asarray(V) > cfg.velocity_threshold] = 0
    if N is None:
        N = np.zeros_like(Y)
    return Y, I, np.asarray(V, np.float64), np.asarray(D, np.float64), N
