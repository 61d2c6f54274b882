"""A copy of ``midi_vae_tpu/data/dataset.py`` for the port, which imports
nothing of the JAX package. Where scikit-learn is missing, a multi-class
corpus takes the seeded shuffle split.

Folder -> dataset builder: walking, labeling, splitting, caching.

Mirrors ``import_midi_from_folder`` (the reference's import_midi.py:352-574):

* class label = first entry of ``cfg.classes`` whose lowercase name is a
  substring of the file's folder-relative path (import_midi.py:384-399),
* optional unknown class, ``only_unknown`` filtering, ``max_songs`` cap,
* stratified train/test split with the same sklearn call and seed
  (import_midi.py:449-454, random_state=42),
* ``equal_mini_songs`` class rebalancing by window counts
  (import_midi.py:502-546),
* dataset caching (the reference pickles 16 lists, import_midi.py:548-571);
  here one .npz-style pickle keyed by a config digest.
"""

from __future__ import annotations

import hashlib
import math
import os
import pickle
from dataclasses import dataclass, field

import numpy as np

from ..config import Config
from .tensorize import SongTensors, load_rolls_from_path


@dataclass
class Dataset:
    """Per-song lists, the V/D/T/I/Y/X/c/paths x {train,test} of the reference."""

    cfg: Config
    X_train: list[np.ndarray] = field(default_factory=list)
    X_test: list[np.ndarray] = field(default_factory=list)
    Y_train: list[np.ndarray] = field(default_factory=list)
    Y_test: list[np.ndarray] = field(default_factory=list)
    I_train: list[np.ndarray] = field(default_factory=list)
    I_test: list[np.ndarray] = field(default_factory=list)
    V_train: list[np.ndarray] = field(default_factory=list)
    V_test: list[np.ndarray] = field(default_factory=list)
    D_train: list[np.ndarray] = field(default_factory=list)
    D_test: list[np.ndarray] = field(default_factory=list)
    T_train: list[float] = field(default_factory=list)
    T_test: list[float] = field(default_factory=list)
    C_train: list[int] = field(default_factory=list)
    C_test: list[int] = field(default_factory=list)
    train_paths: list[str] = field(default_factory=list)
    test_paths: list[str] = field(default_factory=list)

    @property
    def train_set_size(self) -> int:
        return len(self.X_train)

    @property
    def test_set_size(self) -> int:
        return len(self.X_test)


def _config_digest(cfg: Config, folder: str) -> str:
    """Digest over the source folder + the fields that affect
    tensorization + splitting."""
    keys = [
        "classes", "include_unknown", "only_unknown", "test_fraction",
        "split_seed", "high_crop", "low_crop", "smallest_note",
        "max_voices_per_track", "max_songs", "equal_mini_songs",
        "attach_instruments", "include_only_monophonic_instruments",
        "max_voices", "instrument_attach_method", "song_completion",
        "velocity_threshold", "max_velocity", "smaller_training_set_factor",
        "bars_input_length", "bars_output_length", "include_silent_note",
    ]
    d = cfg.to_dict()
    blob = repr(
        [("source", os.path.abspath(folder))] + [(k, d[k]) for k in keys]
    ).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def find_midi_files(folder: str, cfg: Config) -> list[tuple[str, int]]:
    """Walk ``folder``; return (path, class_index) honoring the reference's
    substring labeling and unknown handling. The ``max_songs`` cap applies
    to successfully IMPORTED songs (the reference's ``no_imported`` counter,
    import_midi.py:383-433), so the import loop enforces it -- unparseable
    files must not shrink the corpus below the cap."""
    found: list[tuple[str, int]] = []
    for path, _subdirs, files in sorted(os.walk(folder)):
        for name in sorted(files):
            if not (name.endswith(".mid") or name.endswith(".midi")):
                continue
            full = os.path.join(path, name)
            shortpath = os.path.relpath(path, folder).replace("\\", "/") + "/"
            label = None
            for i, c in enumerate(cfg.classes):
                if c.lower() in shortpath.lower():
                    label = i
                    break
            if label is not None:
                if not cfg.only_unknown:
                    found.append((full, label))
            elif cfg.include_unknown:
                found.append((full, cfg.num_classes - 1))
    return found


def windows_per_song(song_X: np.ndarray, cfg: Config) -> int:
    """Window count used by equal_mini_songs (import_midi.py:506-508).

    The reference computes ceil(len(X_train[i]) / (output_length//max_voices))
    -- over the X windows specifically, which matters when
    bars_input_length != bars_output_length (X and Y then have different
    window counts).
    """
    return math.ceil(len(song_X) / (cfg.output_length // cfg.max_voices))


def _load_one(args):
    path, cfg, preprocessed_dir = args
    return load_rolls_from_path(path, cfg, preprocessed_dir=preprocessed_dir)


def import_midi_from_folder(
    folder: str,
    cfg: Config,
    cache_dir: str | None = None,
    verbose: bool = False,
    preprocessed_dir: str | None = None,
    workers: int = 0,
) -> Dataset:
    """Import + split a labeled MIDI corpus (import_midi.py:352-574)."""
    if cache_dir:
        cache_path = os.path.join(
            cache_dir, f"dataset_{_config_digest(cfg, folder)}.pkl"
        )
        if os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                payload = pickle.load(f)
            ds = Dataset(cfg=cfg)
            for k, v in payload.items():
                setattr(ds, k, v)
            return ds

    files = find_midi_files(folder, cfg)

    songs: list[SongTensors] = []
    labels: list[int] = []
    paths: list[str] = []
    if workers and workers > 1 and len(files) > 1:
        # parallel tensorization across files (the reference imports serially)
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=workers) as pool:
            results = list(
                pool.map(
                    _load_one,
                    [(full, cfg, preprocessed_dir) for full, _ in files],
                    chunksize=4,
                )
            )
        for (full, label), song in zip(files, results):
            if len(songs) >= cfg.max_songs:
                break
            if song is not None and song.X is not None:
                songs.append(song)
                labels.append(label)
                paths.append(full)
    else:
        for full, label in files:
            if len(songs) >= cfg.max_songs:
                break
            if verbose:
                print(f"Importing class {label} song {os.path.basename(full)}")
            song = load_rolls_from_path(full, cfg, preprocessed_dir=preprocessed_dir)
            if song is not None and song.X is not None:
                songs.append(song)
                labels.append(label)
                paths.append(full)

    ds = Dataset(cfg=cfg)
    if not songs:
        return ds

    indices = np.arange(len(songs))
    stratified = False
    if len(set(labels)) > 1 and len(songs) >= 2:
        try:
            # without scikit-learn the corpus takes the seeded shuffle split
            from sklearn.model_selection import train_test_split

            train_idx, test_idx = train_test_split(
                indices,
                test_size=cfg.test_fraction,
                random_state=cfg.split_seed,
                stratify=labels,
            )
            stratified = True
        except (ImportError, ValueError):
            # no scikit-learn, or a corpus too small for a stratified cut at
            # this fraction (sklearn needs test_size >= num_classes)
            pass
    if not stratified:
        # single class or tiny corpus: seeded shuffle split
        rng = np.random.RandomState(cfg.split_seed)
        perm = rng.permutation(indices)
        n_test = max(1, int(round(len(songs) * cfg.test_fraction))) if len(songs) > 1 else 0
        test_idx = perm[:n_test]
        train_idx = perm[n_test:]

    def take(idx_list):
        idx_list = list(idx_list)
        return (
            [songs[i] for i in idx_list],
            [labels[i] for i in idx_list],
            [paths[i] for i in idx_list],
        )

    train_songs, train_labels, train_paths = take(train_idx)
    test_songs, test_labels, test_paths = take(test_idx)

    # equal_mini_songs rebalancing (import_midi.py:502-546)
    if cfg.equal_mini_songs and train_songs:
        splits_per_class = np.zeros((cfg.num_classes,))
        for song, c in zip(train_songs, train_labels):
            splits_per_class[c] += windows_per_song(song.X, cfg)
        amount = int(min(splits_per_class) * cfg.smaller_training_set_factor)
        new_songs, new_labels, new_paths = [], [], []
        counts = np.zeros((cfg.num_classes,))
        for song, c, p in zip(train_songs, train_labels, train_paths):
            w = windows_per_song(song.X, cfg)
            if counts[c] + w <= amount:
                new_songs.append(song)
                new_labels.append(c)
                new_paths.append(p)
                counts[c] += w
        train_songs, train_labels, train_paths = new_songs, new_labels, new_paths

    for song, c, p in zip(train_songs, train_labels, train_paths):
        ds.X_train.append(song.X)
        ds.Y_train.append(song.Y)
        ds.I_train.append(song.I)
        ds.V_train.append(song.V)
        ds.D_train.append(song.D)
        ds.T_train.append(song.tempo)
        ds.C_train.append(c)
        ds.train_paths.append(p)
    for song, c, p in zip(test_songs, test_labels, test_paths):
        ds.X_test.append(song.X)
        ds.Y_test.append(song.Y)
        ds.I_test.append(song.I)
        ds.V_test.append(song.V)
        ds.D_test.append(song.D)
        ds.T_test.append(song.tempo)
        ds.C_test.append(c)
        ds.test_paths.append(p)

    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        payload = {
            k: getattr(ds, k)
            for k in (
                "X_train", "X_test", "Y_train", "Y_test", "I_train", "I_test",
                "V_train", "V_test", "D_train", "D_test", "T_train", "T_test",
                "C_train", "C_test", "train_paths", "test_paths",
            )
        }
        with open(cache_path, "wb") as f:
            pickle.dump(payload, f)
    return ds
