#!/usr/bin/env python
"""Generate a synthetic multi-style MIDI corpus for demos and smoke tests.

A copy of ``tools/make_demo_corpus.py`` over the port's ``data.smf`` (the
port imports nothing of the JAX package): the same seed and styles write
the same bytes.

The styles are separable on every judged modality, mirroring what the
reference's style pairs (Jazz-vs-Pop etc.) look like to the classifiers:

  style1: low register, piano programs, quiet, long legato notes, minor-ish
  style2: high register, string programs, loud, short staccato notes, major
  style3: mid register, reed/brass programs, medium, dotted rhythms, pentatonic
          (only with --styles 3; exercises the full >= 3-class switch matrix)

Usage: python -m midi_vae_tpu_torch.tools.make_demo_corpus OUT_DIR [--songs-per-style 30]
       [--styles 3] [--chords]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from midi_vae_tpu_torch.data import smf

STYLES = {
    "style1": dict(
        programs=[0, 1, 2],            # pianos
        base_pitch=40, pitch_range=18,
        velocity=(35, 70),
        durations=[2, 3, 4, 6],        # in 16ths: legato
        scale=[0, 2, 3, 5, 7, 8, 10],  # minor
        bpm=90.0,
    ),
    "style2": dict(
        programs=[40, 41, 48],         # strings
        base_pitch=62, pitch_range=18,
        velocity=(85, 120),
        durations=[1, 1, 2],           # staccato
        scale=[0, 2, 4, 5, 7, 9, 11],  # major
        bpm=130.0,
    ),
    "style3": dict(
        programs=[64, 65, 56],         # soprano/alto sax, trumpet
        base_pitch=52, pitch_range=18,
        velocity=(60, 90),
        durations=[1, 3, 3, 4],        # dotted / syncopated
        scale=[0, 3, 5, 7, 10],        # minor pentatonic
        bpm=110.0,
    ),
}


def make_song(
    style: dict, rng: np.random.RandomState, bars: int = 16, chords: bool = False
) -> smf.MidiFile:
    mid = smf.MidiFile(initial_tempo=style["bpm"])
    sixteenth = 60.0 / style["bpm"] / 4.0
    n_voices = int(rng.randint(1, 3))
    for v in range(n_voices):
        program = int(rng.choice(style["programs"]))
        inst = smf.Instrument(program=program)
        step = 0
        total_steps = bars * 16
        while step < total_steps:
            dur = int(rng.choice(style["durations"]))
            if rng.rand() < 0.2:  # rests
                step += dur
                continue
            degree = int(rng.randint(len(style["scale"])))
            octave = int(rng.randint(0, 2))
            pitch = style["base_pitch"] + 12 * octave + style["scale"][degree] - 6 * v
            vel = int(rng.randint(*style["velocity"]))
            start = step * sixteenth
            end = (step + dur) * sixteenth
            inst.notes.append(smf.Note(int(pitch), vel, start, end))
            if chords and v == 0 and rng.rand() < 0.5:
                # stack a triad on the melody voice (exercises the
                # polyphony->voice splitting of the tensorizer)
                for offset in (style["scale"][(degree + 2) % len(style["scale"])],
                               style["scale"][(degree + 4) % len(style["scale"])]):
                    cp = style["base_pitch"] + 12 * octave + offset - 6 * v
                    if cp != pitch:
                        inst.notes.append(smf.Note(int(cp), vel, start, end))
            step += dur
        mid.instruments.append(inst)
    return mid


def make_song_hard(
    style: dict, rng: np.random.RandomState, bars: int = 16
) -> smf.MidiFile:
    """A song with real-music statistics the plain generator lacks:

    * mid-song tempo changes (1-2 section boundaries, +-10-20% bpm) --
      exercises the tensorizer's tempo map handling beyond a constant fs;
    * 3-4 instruments INCLUDING a drum track (is_drum channel 10) --
      drums have zero pianoroll activity in the reference's ordering
      (import_midi.py:69-75) and get deprioritized by the max_voices cut;
    * expressive velocity phrasing: 4-bar crescendo/decrescendo arcs +
      metric accents (downbeat/beat) + per-note jitter, so the velocity
      head sees a continuous, structured target instead of a 2-level one;
    * off-grid onsets: gaussian timing jitter (sigma 12 ms) on every
      played note, the humanized timing real corpora have.
    """
    # ---- tempo map: 2-3 sections, each with its own bpm ----
    total_steps = bars * 16
    n_bounds = 1 + int(rng.randint(2))
    bound_bars = sorted(rng.choice(np.arange(2, bars - 1), n_bounds, replace=False))
    section_starts = [0] + [int(b) * 16 for b in bound_bars]
    bpms = [style["bpm"] * float(rng.uniform(0.8, 1.2)) for _ in section_starts]
    # cumulative step->seconds map across tempo sections
    step_time = np.zeros(total_steps + 1)
    t, bpm_at = 0.0, {s: b for s, b in zip(section_starts, bpms)}
    cur_bpm = bpms[0]
    change_times, change_bpms = [0.0], [bpms[0]]
    for s in range(total_steps):
        if s in bpm_at and s > 0:
            cur_bpm = bpm_at[s]
            change_times.append(t)
            change_bpms.append(cur_bpm)
        step_time[s] = t
        t += 60.0 / cur_bpm / 4.0
    step_time[total_steps] = t

    mid = smf.MidiFile(initial_tempo=bpms[0])
    mid.set_tempo_changes(change_times, change_bpms)
    lo_v, hi_v = style["velocity"]
    mid_v = 0.5 * (lo_v + hi_v)

    def phrased_velocity(step: int) -> int:
        # 4-bar arc + metric accents + per-note jitter
        pos = (step % 64) / 64.0
        v = mid_v + (hi_v - lo_v) * 0.35 * np.sin(np.pi * pos)
        if step % 16 == 0:
            v += 10
        elif step % 4 == 0:
            v += 4
        v += rng.normal(0.0, 4.0)
        return int(np.clip(v, 20, 126))

    def jittered(sec: float) -> float:
        return max(0.0, sec + float(rng.normal(0.0, 0.012)))

    # ---- melodic voices: melody, harmony (3rds below), bass roots ----
    scale = style["scale"]
    for v, (reg_off, durs) in enumerate(
        [(0, style["durations"]), (-12, [d * 2 for d in style["durations"]]),
         (-24, [4, 4, 8])]
    ):
        inst = smf.Instrument(program=int(rng.choice(style["programs"])))
        step = 0
        while step < total_steps:
            dur = int(rng.choice(durs))
            if rng.rand() < (0.15 if v == 0 else 0.3):
                step += dur
                continue
            degree = int(rng.randint(len(scale)))
            if v == 2:
                degree = int(rng.choice([0, 3 % len(scale)]))  # roots/fifths
            octave = int(rng.randint(0, 2)) if v == 0 else 0
            pitch = style["base_pitch"] + reg_off + 12 * octave + scale[degree]
            start = jittered(step_time[step])
            end = step_time[min(step + dur, total_steps)]
            if end > start:
                inst.notes.append(
                    smf.Note(int(np.clip(pitch, 21, 108)),
                             phrased_velocity(step), start, end)
                )
            step += dur
        mid.instruments.append(inst)

    # ---- drum track (GM channel 10): kick/snare/hats + simple fills ----
    drums = smf.Instrument(program=0, is_drum=True)
    for step in range(total_steps):
        beat = step % 16
        hits = []
        if beat in (0, 8):
            hits.append(36)  # kick
        if beat in (4, 12):
            hits.append(38)  # snare
        if step % 2 == 0:
            hits.append(42)  # closed hat
        if beat >= 14 and step // 16 % 4 == 3 and rng.rand() < 0.5:
            hits.append(45)  # tom fill at phrase ends
        for pitch in hits:
            start = jittered(step_time[step])
            end = min(start + 0.05, step_time[min(step + 1, total_steps)])
            if end > start:
                drums.notes.append(
                    smf.Note(pitch, phrased_velocity(step), start, end)
                )
    mid.instruments.append(drums)
    return mid


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir")
    p.add_argument("--songs-per-style", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chords", action="store_true", help="polyphonic melodies")
    p.add_argument(
        "--hard", action="store_true",
        help="real-music statistics: mid-song tempo changes, 3 voices + "
             "drums, velocity phrasing arcs, off-grid (humanized) onsets",
    )
    p.add_argument(
        "--styles", type=int, default=2, choices=range(1, len(STYLES) + 1),
        help="number of styles to generate (default 2)",
    )
    args = p.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    chosen = dict(list(STYLES.items())[: args.styles])
    for style_name, style in chosen.items():
        d = os.path.join(args.out_dir, style_name)
        os.makedirs(d, exist_ok=True)
        for s in range(args.songs_per_style):
            song = (
                make_song_hard(style, rng)
                if args.hard
                else make_song(style, rng, chords=args.chords)
            )
            song.write(os.path.join(d, f"{style_name}_{s:03d}.mid"))
    print(f"wrote {args.songs_per_style} songs per style to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
