"""A copy of ``midi_vae_tpu/data/tensorize.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_isolation.py`` holds both
to bit-equal tensors.

MIDI -> piano-roll tensorization (the parity foundation of the framework).

Re-implements the reference pipeline (the reference's import_midi.py:13-350 and
the reference's midi_functions.py:14-137) with identical semantics but
vectorized numpy instead of per-tick Python loops:

* longest steady-tempo span selection          (import_midi.py:30-67)
* instrument ordering by activity              (import_midi.py:69-75)
* 1/SMALLEST_NOTE quantization with the same
  round-half-even edge rules                   (import_midi.py:83-129)
* polyphony -> monophonic voices, highest
  pitch first, per-track voice-count override  (import_midi.py:158-231)
* voice unrolling row = step*max_voices+voice  (import_midi.py:243-249)
* pitch crop, silent one-hot, velocity rescale (import_midi.py:253-277)
* window splitting with silent padding         (import_midi.py:303-345)
* rolls -> MIDI rendering                      (midi_functions.py:57-137)

Known reference bugs intentionally NOT replicated (SURVEY.md §2.4):
* `X[-0:,-1] = 1` flooding the silent column when a song length is an exact
  multiple of the window (import_midi.py:313-314) -- we only mark actual pad.
* `chosen_held_note_rolls.append()` crash in the monophonic-instruments path
  (import_midi.py:201) -- we append the held-note column.
* `2^exponent` XOR in the khot inverse (data_class.py:359-372) -- we use
  `2**exponent`.
* the renderer's velocity un-scaling subtracts a HARDCODED 0.5
  (midi_functions.py:77) even though the import scaled by
  `velocity_threshold` (import_midi.py:272) -- we subtract the threshold,
  the exact inverse, so round-trips hold at any threshold. Identical at
  the shipped default threshold 0.5.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..config import Config
from . import smf


@dataclass
class SongTensors:
    """Tensorized song: the X/Y/I/T/V/D tuple of import_midi.load_rolls."""

    X: np.ndarray           # (num_windows, input_length, input_dim)
    Y: np.ndarray           # (num_windows, output_length, output_dim)
    I: np.ndarray           # (max_voices, instrument_dim)
    tempo: float            # BPM of the steady span
    V: np.ndarray           # (num_windows, output_length) velocities in [0,1]
    D: np.ndarray           # (num_windows, output_length) held-note flags


# ---------------------------------------------------------------------------
# Instrument encodings (midi_functions.py:14-54 / data_class.py:352-373)
# ---------------------------------------------------------------------------

def programs_to_instrument_matrix(
    programs: list[int], method: str, max_voices: int
) -> np.ndarray:
    if method == "1hot-instrument":
        mat = np.zeros((max_voices, 128), dtype=np.float32)
        for i, program in enumerate(programs[:max_voices]):
            mat[i, program] = 1
    elif method == "1hot-category":
        mat = np.zeros((max_voices, 16), dtype=np.float32)
        for i, program in enumerate(programs[:max_voices]):
            mat[i, program // 8] = 1
    elif method == "khot-instrument":
        # 7-bit binary code of the program -- NOTE the reference encodes bit=1
        # when p % 2 == 0 (midi_functions.py:34-38), i.e. the COMPLEMENT of
        # the binary code. Replicated as-is for cache/metric parity.
        mat = np.zeros((max_voices, 7), dtype=np.float32)
        for i, program in enumerate(programs[:max_voices]):
            p = program
            for exponent in range(7):
                if p % 2 == 0:
                    mat[i, exponent] = 1
                p //= 2
    elif method == "khot-category":
        mat = np.zeros((max_voices, 4), dtype=np.float32)
        for i, program in enumerate(programs[:max_voices]):
            p = program // 8
            for exponent in range(4):
                if p % 2 == 1:
                    mat[i, exponent] = 1
                p //= 2
    else:
        raise ValueError(f"unknown instrument_attach_method {method!r}")
    return mat


def instrument_matrix_to_programs(I: np.ndarray, method: str) -> list[int]:
    """Inverse mapping (data_class.py:352-373, with the 2** fix)."""
    programs = []
    for vec in I:
        if method == "1hot-category":
            programs.append(int(np.argmax(vec)) * 8)
        elif method == "1hot-instrument":
            programs.append(int(np.argmax(vec)))
        elif method == "khot-category":
            index = sum(2 ** int(e) for e in np.nonzero(vec)[0])
            programs.append(index * 8)
        elif method == "khot-instrument":
            # invert the complemented code of programs_to_instrument_matrix
            index = sum(2 ** e for e in range(7) if vec[e] == 0)
            programs.append(index)
        else:
            raise ValueError(f"unknown instrument_attach_method {method!r}")
    return programs


# ---------------------------------------------------------------------------
# Steady-tempo span (import_midi.py:30-67)
# ---------------------------------------------------------------------------

def steady_tempo_span(mid: smf.MidiFile) -> tuple[float, float, float]:
    """Return (song_start, song_end, tempo_bpm) of the longest steady span."""
    change_times, change_bpm = mid.get_tempo_changes()
    song_start = 0.0
    song_end = mid.get_end_time()
    if len(change_times) > 1:
        longest = 0.0
        start, end, tempo = 0.0, song_end, change_bpm[0]
        for i, t in enumerate(change_times):
            seg_end = song_end if i == len(change_times) - 1 else change_times[i + 1]
            if seg_end - t > longest:
                longest = seg_end - t
                start, end, tempo = t, seg_end, change_bpm[i]
        return start, end, tempo
    return song_start, song_end, change_bpm[0]


def crop_to_span(mid: smf.MidiFile, start: float, end: float) -> None:
    """Keep only notes fully inside [start, end], shifted to t=0 (in place)."""
    for inst in mid.instruments:
        kept = []
        for n in inst.notes:
            if n.start >= start and n.end <= end:
                kept.append(smf.Note(n.pitch, n.velocity, n.start - start, n.end - start))
        inst.notes = kept


def _activity_counts(mid: smf.MidiFile) -> list[int]:
    """Per-instrument activity for ordering (import_midi.py:69-75).

    The reference counts nonzero cells of a 100Hz pretty_midi piano roll,
    which is 0 for drum instruments. We count active (10ms-bin, pitch) cells
    from merged note intervals, also 0 for drums.
    """
    counts = []
    end_time = mid.get_end_time()
    frames = int(math.ceil(end_time * 100)) + 1
    for inst in mid.instruments:
        if inst.is_drum or not inst.notes:
            counts.append(0)
            continue
        roll = np.zeros((frames, 128), dtype=bool)
        for n in inst.notes:
            roll[int(n.start * 100) : int(n.end * 100), n.pitch] = True
        counts.append(int(np.count_nonzero(roll)))
    return counts


# ---------------------------------------------------------------------------
# Quantized rolls for one instrument
# ---------------------------------------------------------------------------

@dataclass
class _InstrumentRolls:
    active: np.ndarray        # (T, 128) bool  -- note sounding
    starts: np.ndarray        # (T, 128) bool  -- a note starts at this tick
    velocity: np.ndarray      # (T, 128) int   -- velocity at note start ticks
    max_concurrent: int
    program: int


def _quantize_instrument(
    inst: smf.Instrument, fs: float, total_ticks: int
) -> _InstrumentRolls:
    active = np.zeros((total_ticks, 128), dtype=bool)
    starts = np.zeros((total_ticks, 128), dtype=bool)
    velocity = np.zeros((total_ticks, 128), dtype=np.int32)
    concurrent = np.zeros((total_ticks,), dtype=np.int32)
    for note in inst.notes:
        tick_start = note.start * fs
        tick_end = note.end * fs
        a = int(round(tick_start))   # round-half-even like the reference
        b = int(round(tick_end))
        decimal = tick_start - a
        # import_midi.py:122: off-grid notes shorter than one tick are dropped
        if decimal < 10e-3 or b - a >= 1:
            if b > a:
                # +1 per note regardless of pitch overlap, exactly like the
                # reference (import_midi.py:127): two overlapping notes on
                # the SAME pitch still count 2 concurrent
                concurrent[a:b] += 1
                active[a:b, note.pitch] = True
            if 0 <= a < total_ticks:
                starts[a, note.pitch] = True
                velocity[a, note.pitch] = note.velocity
    return _InstrumentRolls(
        active=active,
        starts=starts,
        velocity=velocity,
        max_concurrent=int(concurrent.max()) if total_ticks else 0,
        program=inst.program,
    )


def _voice_order(active: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per step: pitches of active notes sorted highest-first.

    Returns (order, counts): order (T, 128) pitch indices with the highest
    active pitch in column 0; counts (T,) number of active pitches.
    """
    T = active.shape[0]
    key = np.where(active, np.arange(128, dtype=np.int32)[None, :], -1)
    order = np.argsort(-key, axis=1, kind="stable").astype(np.int32)
    counts = active.sum(axis=1).astype(np.int32)
    del T
    return order, counts


# ---------------------------------------------------------------------------
# load_rolls: one MIDI file -> SongTensors
# ---------------------------------------------------------------------------

def load_rolls(
    mid: smf.MidiFile, cfg: Config, preprocessed_dir: str | None = None,
    name: str = "song",
) -> SongTensors | None:
    """Tensorize one parsed MIDI song (import_midi.py:13-350).

    ``preprocessed_dir``: when set (or cfg.save_preprocessed_midi), the
    unrolled rolls are rendered back to MIDI there (import_midi.py:300)."""
    song_start, song_end, tempo = steady_tempo_span(mid)
    if song_end <= song_start or tempo <= 0:
        return None
    crop_to_span(mid, song_start, song_end)
    # Reference quirk kept for parity (import_midi.py:91): total_ticks is
    # computed from the UNSHIFTED span end even though the notes were just
    # shifted to t=0 (import_midi.py:62-66), so multi-tempo songs gain
    # ``song_start * fs`` trailing ticks of silence (extra all-silent
    # windows). Verified bit-exact against the executing reference by
    # tools/ref_parity_check.py --adversarial (multi_tempo/span_straddle).

    # order instruments by activity, descending: np.argsort(counts)[::-1]
    # exactly as import_midi.py:74 -- DEFAULT sort kind, because numpy's
    # introsort is only stable below its insertion-sort threshold (16), and
    # tie order on >16 instrument streams must match the reference's
    counts = _activity_counts(mid)
    permutation = np.argsort(counts)[::-1]
    instruments = [mid.instruments[i] for i in permutation]

    # BIT-FOR-BIT the reference's float expression (import_midi.py:81-86):
    # 1./(tempo/60.) differs from 60./tempo by 1 ulp for some tempi, and
    # that ulp flips round-half-even at exact half-tick note boundaries
    # (found by tools/ref_parity_check.py --fuzz)
    quarter = 1.0 / (tempo / 60.0)
    fs = 1.0 / (quarter * 4.0 / cfg.smallest_note)
    total_ticks = int(math.ceil(song_end * fs))
    if total_ticks <= 0:
        return None

    rolls = [_quantize_instrument(inst, fs, total_ticks) for inst in instruments]
    max_concurrent_list = [r.max_concurrent for r in rolls]

    # voice-count override (import_midi.py:158-170)
    mv = cfg.max_voices
    per_track_cap = cfg.max_voices_per_track
    override = [per_track_cap for _ in rolls]
    silent_tracks = mv - sum(
        min(per_track_cap, x) if x > 0 else 0 for x in max_concurrent_list[:mv]
    )
    for voice in range(min(mv, len(rolls))):
        if silent_tracks > 0 and max_concurrent_list[voice] > per_track_cap:
            extra = min(silent_tracks, max_concurrent_list[voice] - per_track_cap)
            override[voice] += extra
            silent_tracks -= extra

    # choose monophonic voices (import_midi.py:176-231)
    chosen_active: list[np.ndarray] = []    # (T,) pitch or -1
    chosen_velocity: list[np.ndarray] = []
    chosen_held: list[np.ndarray] = []
    chosen_programs: list[int] = []
    for r, cap in zip(rolls, override):
        if r.max_concurrent <= 0:
            continue
        if cfg.include_only_monophonic_instruments and r.max_concurrent > 1:
            continue
        order, active_counts = _voice_order(r.active)
        n_voices = min(r.max_concurrent, max(per_track_cap, cap))
        if cfg.include_only_monophonic_instruments:
            n_voices = 1
        for voice in range(n_voices):
            if len(chosen_active) >= mv:
                break
            has_voice = active_counts > voice
            pitch_at = np.where(has_voice, order[:, voice], -1)
            steps = np.nonzero(has_voice)[0]
            vel = np.zeros((total_ticks,), dtype=np.float64)
            held = np.zeros((total_ticks,), dtype=np.float64)
            if steps.size:
                p = pitch_at[steps]
                started = r.starts[steps, p]
                vel[steps] = np.where(started, r.velocity[steps, p], 0)
                held[steps] = np.where(started, 0.0, 1.0)
            chosen_active.append(pitch_at)
            chosen_velocity.append(vel)
            chosen_held.append(held)
            chosen_programs.append(r.program)
        if len(chosen_active) >= mv:
            break

    if not chosen_active:
        return None

    # unroll: row = step * max_voices + voice (import_midi.py:243-249)
    song_length = total_ticks * mv
    pitch_grid = np.full((total_ticks, mv), -1, dtype=np.int32)
    vel_grid = np.zeros((total_ticks, mv), dtype=np.float64)
    held_grid = np.zeros((total_ticks, mv), dtype=np.float64)
    for v in range(len(chosen_active)):
        pitch_grid[:, v] = chosen_active[v]
        vel_grid[:, v] = chosen_velocity[v]
        held_grid[:, v] = chosen_held[v]

    flat_pitch = pitch_grid.reshape(-1)          # (song_length,)
    Y = np.zeros((song_length, 128), dtype=np.float32)
    rows = np.nonzero(flat_pitch >= 0)[0]
    Y[rows, flat_pitch[rows]] = 1.0

    # crop + silent note (import_midi.py:253-265)
    Y = Y[:, cfg.low_crop : cfg.high_crop]
    if cfg.include_silent_note:
        silent = (Y.sum(axis=1) == 0).astype(np.float32)
        Y = np.concatenate([Y, silent[:, None]], axis=1)

    # velocities scaled into [threshold, 1] for played notes (import_midi.py:267-277)
    flat_vel_raw = vel_grid.reshape(-1)
    thr = cfg.velocity_threshold
    V = np.where(
        flat_vel_raw > 0,
        thr + (flat_vel_raw / cfg.max_velocity) * (1.0 - thr),
        0.0,
    ).astype(np.float32)

    D = held_grid.reshape(-1).astype(np.float32)

    I = programs_to_instrument_matrix(
        chosen_programs, cfg.instrument_attach_method, mv
    )

    if cfg.attach_instruments:
        # (import_midi.py:290-292): tile per unrolled step and append
        tiled = np.tile(I, (song_length // mv, 1)).astype(np.float32)
        Y = np.concatenate([Y, tiled], axis=1)

    if preprocessed_dir is not None and cfg.save_preprocessed_midi:
        import os

        os.makedirs(preprocessed_dir, exist_ok=True)
        save_rolls_as_midi(
            Y, chosen_programs, cfg,
            os.path.join(preprocessed_dir, f"{name}.mid"),
            bpm=tempo, velocity_roll=V, held_notes_roll=D,
        )

    if cfg.song_completion:
        X = Y[::mv, :].copy()  # voice 0 only (import_midi.py:294-296)
    else:
        X = Y

    # window split with silent padding (import_midi.py:303-345);
    # pad-marking guarded to padding_length > 0 (reference bug, see module doc)
    def split(arr: np.ndarray, length: int, mark_silent: bool) -> np.ndarray:
        padding = length - (arr.shape[0] % length)
        if padding == length:
            padding = 0
        if arr.ndim == 2:
            arr = np.pad(arr, ((0, padding), (0, 0)))
            if mark_silent and cfg.include_silent_note and padding > 0:
                arr[-padding:, cfg.new_num_notes] = 1
        else:
            arr = np.pad(arr, (0, padding))
        return arr.reshape(-1, length, *arr.shape[1:])

    X_w = split(X, cfg.input_length, mark_silent=True)
    Y_w = split(Y, cfg.output_length, mark_silent=True)
    V_w = split(V, cfg.output_length, mark_silent=False)
    D_w = split(D, cfg.output_length, mark_silent=False)

    return SongTensors(
        X=X_w.astype(np.float32),
        Y=Y_w.astype(np.float32),
        I=I.astype(np.float32),
        tempo=float(tempo),
        V=V_w.astype(np.float32),
        D=D_w.astype(np.float32),
    )


def load_rolls_from_path(
    path: str, cfg: Config, preprocessed_dir: str | None = None
) -> SongTensors | None:
    """Parse + tensorize; broad exception swallow like import_midi.py:17-22."""
    try:
        mid = smf.read_midi(path)
    except Exception as e:  # noqa: BLE001 -- skip unreadable files, like the ref
        print(f"Unexpected error in {path}: {e!r}")
        return None
    if not mid.instruments:
        return None
    import os

    return load_rolls(
        mid, cfg, preprocessed_dir=preprocessed_dir,
        name=os.path.splitext(os.path.basename(path))[0],
    )


# ---------------------------------------------------------------------------
# rolls -> MIDI (midi_functions.py:57-137)
# ---------------------------------------------------------------------------

def rolls_to_midi(
    pianoroll: np.ndarray,
    programs: list[int],
    cfg: Config,
    bpm: float,
    velocity_roll: np.ndarray | None = None,
    held_notes_roll: np.ndarray | None = None,
) -> smf.MidiFile:
    """Reconstruct a MidiFile from an unrolled (monophonic-voice) pianoroll.

    pianoroll: (steps, new_num_notes[+silent]) -- silent column ignored if
    wider than new_num_notes; values > 0 are notes.
    """
    bpm = bpm * (cfg.smallest_note / 4)
    roll = np.asarray(pianoroll)[:, : cfg.new_num_notes]
    roll = np.pad(
        roll, ((0, 0), (cfg.low_crop, cfg.num_notes - cfg.high_crop))
    )

    mid = smf.MidiFile(initial_tempo=bpm, resolution=1000)
    mid.time_signature_changes.append(smf.TimeSignature(4, 4, 0.0))

    thr = cfg.velocity_threshold
    n_voices = len(programs)
    for voice, program in enumerate(programs):
        inst = smf.Instrument(program=program)
        current = roll[voice::n_voices, :]

        if velocity_roll is not None:
            vel = np.copy(np.asarray(velocity_roll, dtype=np.float64)[voice::n_voices])
            vel[vel < thr] = 0
            vel[vel >= thr] -= thr
            vel /= 1.0 - thr
            vel *= cfg.max_velocity
        else:
            vel = None

        if held_notes_roll is not None:
            held = np.copy(np.asarray(held_notes_roll)[voice::n_voices])
        else:
            held = None

        tracker: list[int] = []
        start_times: dict[int, int] = {}
        velocities: dict[int, int] = {}
        for i, note_vector in enumerate(current):
            notes = list(np.nonzero(note_vector)[0])
            removal = []
            for note in tracker:
                if held is not None:
                    hold = held[i] > 0.5
                    if note not in notes:
                        hold = False
                else:
                    # (midi_functions.py:109) hold while same pitch continues
                    # and we are not on a SMALLEST_NOTE boundary
                    hold = note in notes and (i % cfg.smallest_note) != 0
                if hold:
                    notes.remove(note)
                else:
                    if vel is not None:
                        velocity = velocities[note]
                        if velocity > cfg.max_velocity:
                            velocity = int(cfg.max_velocity)
                    else:
                        velocity = 80
                    if velocity > 0:
                        inst.notes.append(
                            smf.Note(
                                pitch=int(note),
                                velocity=int(velocity),
                                start=(60.0 / bpm) * start_times[note],
                                end=(60.0 / bpm) * i,
                            )
                        )
                    removal.append(note)
            for note in removal:
                tracker.remove(note)
            for note in notes:
                tracker.append(note)
                start_times[note] = i
                if vel is not None:
                    velocities[note] = int(vel[i])
        # close notes still sounding at the end
        for note in tracker:
            velocity = velocities.get(note, 80) if vel is not None else 80
            if velocity > 0:
                inst.notes.append(
                    smf.Note(
                        pitch=int(note),
                        velocity=int(min(velocity, cfg.max_velocity)),
                        start=(60.0 / bpm) * start_times[note],
                        end=(60.0 / bpm) * len(current),
                    )
                )
        mid.instruments.append(inst)
    return mid


def save_rolls_as_midi(
    pianoroll: np.ndarray,
    programs: list[int],
    cfg: Config,
    path: str,
    bpm: float = 100.0,
    velocity_roll: np.ndarray | None = None,
    held_notes_roll: np.ndarray | None = None,
) -> None:
    mid = rolls_to_midi(pianoroll, programs, cfg, bpm, velocity_roll, held_notes_roll)
    mid.write(path)
