"""A copy of ``midi_vae_tpu/data/smf.py`` for the port, which imports nothing
of the JAX package, without the native C++ fast path of ``read_midi``.

Self-contained Standard MIDI File (SMF) reader/writer.

The reference delegates MIDI parsing/writing to ``pretty_midi``/``mido``
(the reference's import_midi.py:3, the reference's midi_functions.py:8-9).
Neither library is available in this image, so the framework ships its own
minimal SMF layer with the subset of semantics the pipeline needs:

* per-instrument note lists with absolute start/end **seconds** derived from
  the tempo map (pretty_midi semantics: one instrument per (track, channel,
  program) stream; note_on vel 0 == note_off; a note_off closes every open
  note at that pitch, notes starting at the same tick survive),
* all three SMF formats and both division kinds: PPQ files use the tempo
  map; SMPTE-division files use the fixed fps x ticks-per-frame wall clock
  (SMF spec -- tempo metas stay advisory BPM labels). Tempo/time-signature
  events are honored from the FIRST track only, matching pretty_midi's
  ``_load_tempo_changes``/``_load_metadata`` (tracks[0], warn-and-ignore
  elsewhere); format 2 takes the same uniform handling. See PARITY.md
  "SMF format and division semantics" and tests/test_smf_compat.py,
* ``tempo_changes`` / ``end_time`` / ``time_signature_changes`` accessors used
  by the tensorizer (import_midi.py:30-67),
* a writer used by the roll->MIDI renderer (midi_functions.py:57-137):
  format-1 file, tempo+4/4 meta track, one track per instrument.

Everything here is host-side I/O code (the CPU boundary of the TPU pipeline).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


@dataclass
class Note:
    pitch: int
    velocity: int
    start: float  # seconds
    end: float    # seconds


@dataclass
class Instrument:
    program: int = 0
    is_drum: bool = False
    name: str = ""
    notes: list[Note] = field(default_factory=list)


@dataclass
class TimeSignature:
    numerator: int
    denominator: int
    time: float  # seconds


class MidiFile:
    """In-memory MIDI song: instruments + tempo map, times in seconds.

    ``format`` is the SMF header format (0/1/2) of a parsed file (1 for
    in-memory songs); ``smpte`` is ``(fps, ticks_per_frame)`` when the file
    used SMPTE time division, else None -- in that case ``resolution`` holds
    the tick rate in ticks/second (fps x tpf) rather than ticks/quarter.
    """

    def __init__(self, initial_tempo: float = 120.0, resolution: int = 480):
        self.resolution = resolution
        self.format = 1
        self.smpte: tuple[float, int] | None = None
        self.instruments: list[Instrument] = []
        self.time_signature_changes: list[TimeSignature] = []
        # parallel arrays: change time (sec) and tempo in BPM from there on
        self._tempo_change_times: list[float] = [0.0]
        self._tempo_change_bpm: list[float] = [float(initial_tempo)]

    # -- pretty_midi-compatible accessors used by the tensorizer --
    def get_tempo_changes(self) -> tuple[list[float], list[float]]:
        return list(self._tempo_change_times), list(self._tempo_change_bpm)

    def get_end_time(self) -> float:
        end = 0.0
        for inst in self.instruments:
            for n in inst.notes:
                if n.end > end:
                    end = n.end
        return end

    def set_tempo_changes(self, times: list[float], bpm: list[float]) -> None:
        if not times or times[0] != 0.0:
            raise ValueError("tempo map must start at t=0")
        self._tempo_change_times = list(times)
        self._tempo_change_bpm = list(bpm)

    def write(self, path: str) -> None:
        write_midi(self, path)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

class MidiParseError(ValueError):
    pass


def _read_varlen(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    for _ in range(4):
        if pos >= len(data):
            raise MidiParseError("truncated variable-length quantity")
        byte = data[pos]
        pos += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, pos
    raise MidiParseError("variable-length quantity too long")


def _parse_track_events(data: bytes):
    """Yield (tick, status, payload_bytes) for one MTrk chunk body."""
    pos = 0
    tick = 0
    running_status = None
    while pos < len(data):
        delta, pos = _read_varlen(data, pos)
        tick += delta
        if pos >= len(data):
            # truncated mid-event: surface the trailing delta as a no-op so
            # consumers' max_tick (hanging-note close) matches the native
            # parser, which counts the delta before noticing truncation
            yield tick, 0xF8, b""
            break
        status = data[pos]
        if status & 0x80:
            pos += 1
            if status < 0xF0:
                running_status = status
        else:
            if running_status is None:
                raise MidiParseError("running status without prior status byte")
            status = running_status
        if status == 0xFF:  # meta
            if pos >= len(data):
                raise MidiParseError("truncated meta event")
            meta_type = data[pos]
            pos += 1
            length, pos = _read_varlen(data, pos)
            # a declared payload that over-runs the chunk is yielded EMPTY
            # (not truncated): the native parser's payload_ok guard skips
            # such tempo/time-signature metas entirely, and the two parsers
            # must agree bit-for-bit on malformed files
            payload = data[pos : pos + length] if pos + length <= len(data) \
                else b""
            pos += length
            yield tick, 0xFF00 | meta_type, payload
            if meta_type == 0x2F:  # end of track
                return
        elif status in (0xF0, 0xF7):  # sysex
            length, pos = _read_varlen(data, pos)
            pos += length
            # yielded (payload dropped) so consumers' max_tick sees the
            # delta, matching the native parser's hanging-note close tick
            yield tick, status, b""
        elif status >= 0xF0:
            # system common (0xF1-0xF6) / realtime (0xF8-0xFE): skip their
            # fixed-size payloads -- misreading them as 2-byte channel
            # events desynchronizes every later delta-time in the track
            pos += {0xF1: 1, 0xF2: 2, 0xF3: 1}.get(status, 0)
            yield tick, status, b""
        else:
            kind = status & 0xF0
            nbytes = 1 if kind in (0xC0, 0xD0) else 2
            payload = data[pos : pos + nbytes]
            pos += nbytes
            yield tick, status, payload


class _TempoMap:
    """tick -> seconds conversion from (tick, us_per_quarter) changes."""

    def __init__(self, changes: list[tuple[int, int]], resolution: int):
        # changes sorted by tick; ensure an entry at tick 0 (default 120bpm)
        changes = sorted(changes)
        if not changes or changes[0][0] != 0:
            changes = [(0, 500000)] + changes
        # deduplicate same-tick changes (last wins, like pretty_midi)
        dedup: list[tuple[int, int]] = []
        for tick, uspq in changes:
            if dedup and dedup[-1][0] == tick:
                dedup[-1] = (tick, uspq)
            else:
                dedup.append((tick, uspq))
        self.resolution = resolution
        self.ticks = [t for t, _ in dedup]
        self.uspq = [u for _, u in dedup]
        self.seconds = [0.0]
        for i in range(1, len(self.ticks)):
            dt = self.ticks[i] - self.ticks[i - 1]
            self.seconds.append(
                self.seconds[-1] + dt * self.uspq[i - 1] / (1e6 * resolution)
            )

    def to_seconds(self, tick: int) -> float:
        # linear scan is fine: tempo maps are tiny
        i = 0
        for j in range(len(self.ticks)):
            if self.ticks[j] <= tick:
                i = j
            else:
                break
        return self.seconds[i] + (tick - self.ticks[i]) * self.uspq[i] / (
            1e6 * self.resolution
        )

    def change_times_and_bpm(self) -> tuple[list[float], list[float]]:
        times = [self.seconds[i] for i in range(len(self.ticks))]
        bpm = [6e7 / u for u in self.uspq]
        return times, bpm


def decode_division(division: int) -> tuple[float, int] | None:
    """Decode the MThd division word: None for PPQ (ticks/quarter), or
    ``(fps, ticks_per_frame)`` for SMPTE division (bit 15 set; bits 8-14 are
    the negated frame rate in two's complement, -29 meaning 29.97 drop-frame
    per the SMF spec)."""
    if not division & 0x8000:
        return None
    fps = float(256 - ((division >> 8) & 0xFF))
    if fps == 29.0:
        fps = 29.97
    tpf = division & 0xFF
    if tpf == 0:
        raise MidiParseError("SMPTE division with zero ticks per frame")
    return fps, tpf


class _FrameClock:
    """tick -> seconds under SMPTE division: a fixed wall-clock tick rate of
    fps x ticks_per_frame ticks/second, independent of tempo metas (SMF spec;
    tempo events remain advisory BPM labels for get_tempo_changes)."""

    def __init__(self, fps: float, tpf: int):
        self.rate = fps * tpf  # ticks per second

    def to_seconds(self, tick: int) -> float:
        return tick / self.rate


def read_midi(path: str) -> MidiFile:
    """Parse a MIDI file with the pure-Python parser. (The JAX package's
    ``read_midi`` also has a native C++ fast path with the same results,
    ``midi_vae_tpu/data/smf.py:258-265``; the port does not carry it.)"""
    with open(path, "rb") as f:
        return parse_midi_bytes(f.read())


def parse_midi_bytes(data: bytes) -> MidiFile:
    if len(data) < 14 or data[:4] != b"MThd":
        raise MidiParseError("not a MIDI file (missing MThd)")
    header_len = struct.unpack(">I", data[4:8])[0]
    fmt, ntracks, division = struct.unpack(">HHH", data[8:14])
    smpte = decode_division(division)
    pos = 8 + header_len

    tracks: list[bytes] = []
    while pos + 8 <= len(data) and len(tracks) < ntracks:
        chunk_type = data[pos : pos + 4]
        chunk_len = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + chunk_len]
        pos += 8 + chunk_len
        if chunk_type == b"MTrk":
            tracks.append(body)

    # pass 1: tempo map + time signatures from the FIRST track only --
    # pretty_midi semantics (its _load_tempo_changes/_load_metadata read
    # midi_data.tracks[0] and it warns-and-ignores such events on other
    # tracks), applied uniformly to formats 0/1/2; see PARITY.md "SMF
    # format and division semantics"
    tempo_changes: list[tuple[int, int]] = []
    timesig_events: list[tuple[int, int, int]] = []
    parsed_tracks = []
    for track_idx, body in enumerate(tracks):
        events = list(_parse_track_events(body))
        parsed_tracks.append(events)
        if track_idx != 0:
            continue
        for tick, status, payload in events:
            if status == 0xFF51 and len(payload) >= 3:
                uspq = (payload[0] << 16) | (payload[1] << 8) | payload[2]
                if uspq > 0:
                    tempo_changes.append((tick, uspq))
            elif status == 0xFF58 and len(payload) >= 2:
                # denominator power clamped to 62 (matches the native
                # parser, where a >=63 shift would be UB; sane MIDI <= 7)
                timesig_events.append(
                    (tick, payload[0], 1 << min(payload[1], 62))
                )

    if smpte is None:
        resolution = division
        tmap = _TempoMap(tempo_changes, resolution)
        to_seconds = tmap.to_seconds
        times, bpm = tmap.change_times_and_bpm()
    else:
        # SMPTE: ticks advance on a fixed wall clock; tempo metas do not
        # affect timing but are surfaced as the advisory BPM map the
        # tensorizer reads for its quantization grid (default 120)
        clock = _FrameClock(*smpte)
        resolution = int(round(clock.rate))
        to_seconds = clock.to_seconds
        if not tempo_changes or tempo_changes[0][0] != 0:
            tempo_changes = [(0, 500000)] + tempo_changes
        times = [to_seconds(t) for t, _ in tempo_changes]
        bpm = [6e7 / u for _, u in tempo_changes]

    mid = MidiFile(resolution=resolution)
    mid.format = fmt
    mid.smpte = smpte
    mid.set_tempo_changes(times, bpm)
    for tick, num, den in sorted(timesig_events):
        mid.time_signature_changes.append(
            TimeSignature(num, den, to_seconds(tick))
        )

    # pass 2: notes. one Instrument per (track, channel, program) stream.
    for track_idx, events in enumerate(parsed_tracks):
        current_program = {ch: 0 for ch in range(16)}
        # open notes: (channel, pitch) -> list of (start_tick, velocity, program)
        open_notes: dict[tuple[int, int], list[tuple[int, int, int]]] = {}
        instruments: dict[tuple[int, int], Instrument] = {}

        def get_instrument(channel: int, program: int) -> Instrument:
            key = (channel, program)
            if key not in instruments:
                instruments[key] = Instrument(
                    program=program, is_drum=(channel == 9)
                )
            return instruments[key]

        def close_notes(channel: int, pitch: int, end_tick: int) -> None:
            key = (channel, pitch)
            stack = open_notes.get(key, [])
            keep = []
            for start_tick, velocity, program in stack:
                if start_tick == end_tick:
                    keep.append((start_tick, velocity, program))
                    continue
                start_s = to_seconds(start_tick)
                end_s = to_seconds(end_tick)
                if end_s > start_s:
                    get_instrument(channel, program).notes.append(
                        Note(pitch, velocity, start_s, end_s)
                    )
            if keep:
                open_notes[key] = keep
            elif key in open_notes:
                del open_notes[key]

        max_tick = 0
        for tick, status, payload in events:
            max_tick = max(max_tick, tick)
            if status >= 0xFF00:
                continue
            kind = status & 0xF0
            channel = status & 0x0F
            if kind == 0xC0 and payload:
                current_program[channel] = payload[0] & 0x7F
            elif kind == 0x90 and len(payload) >= 2 and payload[1] > 0:
                pitch, velocity = payload[0], payload[1]
                open_notes.setdefault((channel, pitch), []).append(
                    (tick, velocity, current_program[channel])
                )
            elif (kind == 0x80 and len(payload) >= 2) or (
                kind == 0x90 and len(payload) >= 2 and payload[1] == 0
            ):
                close_notes(channel, payload[0], tick)

        # close anything left hanging at end of track
        for (channel, pitch), stack in list(open_notes.items()):
            for start_tick, velocity, program in stack:
                start_s = to_seconds(start_tick)
                end_s = to_seconds(max_tick)
                if end_s > start_s:
                    get_instrument(channel, program).notes.append(
                        Note(pitch, velocity, start_s, end_s)
                    )

        for key in sorted(instruments):
            inst = instruments[key]
            if inst.notes:
                inst.notes.sort(key=lambda n: (n.start, n.pitch))
                mid.instruments.append(inst)

    return mid


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _varlen(value: int) -> bytes:
    if value < 0:
        raise ValueError("negative delta time")
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def _track_chunk(events: list[tuple[int, bytes]]) -> bytes:
    """events: list of (absolute_tick, raw_event_bytes), will be delta-encoded."""
    events = sorted(events, key=lambda e: e[0])
    body = bytearray()
    prev_tick = 0
    for tick, raw in events:
        body += _varlen(tick - prev_tick)
        body += raw
        prev_tick = tick
    body += _varlen(0) + bytes([0xFF, 0x2F, 0x00])
    return b"MTrk" + struct.pack(">I", len(body)) + bytes(body)


def write_midi(mid: MidiFile, path: str) -> None:
    resolution = mid.resolution
    times, bpms = mid.get_tempo_changes()

    # piecewise-linear seconds -> ticks under the full tempo map: segment i
    # starts at second times[i] / tick seg_ticks[i] and runs at bpms[i]
    seg_ticks = [0.0]
    for i in range(1, len(times)):
        spt_prev = 60.0 / (bpms[i - 1] * resolution)
        seg_ticks.append(seg_ticks[-1] + (times[i] - times[i - 1]) / spt_prev)

    def to_tick(seconds: float) -> int:
        i = len(times) - 1
        while i > 0 and seconds < times[i]:
            i -= 1
        spt = 60.0 / (bpms[i] * resolution)
        return max(0, int(round(seg_ticks[i] + (seconds - times[i]) / spt)))

    chunks = []
    # meta track: tempo map + time signatures
    meta_events = []
    for seg_tick, bpm in zip(seg_ticks, bpms):
        uspq = int(round(6e7 / bpm))
        meta_events.append(
            (
                int(round(seg_tick)),
                bytes([0xFF, 0x51, 0x03]) + uspq.to_bytes(3, "big"),
            )
        )
    for ts in mid.time_signature_changes:
        den_pow = max(0, ts.denominator.bit_length() - 1)
        meta_events.append(
            (
                to_tick(ts.time),
                bytes([0xFF, 0x58, 0x04, ts.numerator, den_pow, 24, 8]),
            )
        )
    chunks.append(_track_chunk(meta_events))

    for i, inst in enumerate(mid.instruments):
        channel = 9 if inst.is_drum else (i % 15 + (1 if i % 15 >= 9 else 0))
        events: list[tuple[int, bytes]] = [
            (0, bytes([0xC0 | channel, inst.program & 0x7F]))
        ]
        for note in inst.notes:
            velocity = int(max(1, min(127, round(note.velocity))))
            start_tick = to_tick(note.start)
            end_tick = max(start_tick + 1, to_tick(note.end))
            events.append(
                (start_tick, bytes([0x90 | channel, note.pitch & 0x7F, velocity]))
            )
            events.append((end_tick, bytes([0x80 | channel, note.pitch & 0x7F, 0])))
        chunks.append(_track_chunk(events))

    header = b"MThd" + struct.pack(">IHHH", 6, 1, len(chunks), resolution)
    with open(path, "wb") as f:
        f.write(header + b"".join(chunks))
