"""A copy of ``midi_vae_tpu/data/batching.py`` for the port, which imports
nothing of the JAX package.

Batch preparation: song tensors -> model input dicts.

Pure-function equivalents of the reference batch builders
(the reference's vae_definition.py:770-1045):

* ``prepare_song_batch``: D -> 2-class categorical, V -> (B,T,1) with the
  optional velocity/held merge, I tiled per window, C one-hot, history roll
  H[1:] = z[:-1] (prepare_decoder_input, vae_definition.py:816-833),
* ``flatten_dataset``: the whole corpus as flat window arrays + song ids --
  the global-batch layout consumed by the pjit'd train step (replacing the
  reference's per-song ``model.fit`` loop, vae_training.py:775-814),
* signature-vector computation + train-set normalization
  (vae_training.py:660-716).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import Config
from ..utils import music
from .dataset import Dataset


def one_hot(indices, depth: int) -> np.ndarray:
    arr = np.zeros((len(indices), depth), dtype=np.float32)
    arr[np.arange(len(indices)), np.asarray(indices, dtype=int)] = 1.0
    return arr


def bucket_pow2(n: int) -> int:
    """Next power-of-two >= n: the shared batch-padding policy that keeps
    jitted program shapes static (generation contexts, classifier judges)."""
    b = 1
    while b < n:
        b *= 2
    return b


def held_to_categorical(D: np.ndarray) -> np.ndarray:
    """(B, T) held flags -> (B, T, 2) one-hot (vae_definition.py:774-781)."""
    D = np.asarray(D)
    cat = np.zeros((*D.shape, 2), dtype=np.float32)
    held = D != 0
    cat[..., 0] = ~held
    cat[..., 1] = held
    return cat


def prepare_velocity(V: np.ndarray, D_cat: np.ndarray, cfg: Config) -> np.ndarray:
    """V -> (B, T, 1); merge held info if configured (vae_def.py:783-791)."""
    V = np.expand_dims(np.copy(np.asarray(V, dtype=np.float32)), -1)
    if cfg.combine_velocity_and_held_notes:
        V[D_cat[..., 1] == 1] = 1.0
    return V


def prepare_song_batch(
    X: np.ndarray,
    Y: np.ndarray,
    C: int,
    I: np.ndarray,
    V: np.ndarray,
    D: np.ndarray,
    S: np.ndarray | None,
    cfg: Config,
    H: np.ndarray | None = None,
) -> dict:
    """One song's windows -> model batch dict (prepare_autoencoder_input_and_
    output_list, vae_definition.py:880-1045)."""
    num = X.shape[0]
    D_cat = held_to_categorical(D)
    V3 = prepare_velocity(V, D_cat, cfg)
    batch = {
        "X": np.asarray(X, dtype=np.float32),
        "Y": np.asarray(Y, dtype=np.float32),
        "I": np.tile(I[None], (num, 1, 1)).astype(np.float32),
        "V": V3,
        "D": D_cat,
        "C": np.tile(one_hot([C], cfg.num_classes), (num, 1)),
    }
    if S is not None:
        batch["S"] = np.asarray(S, dtype=np.float32)
    if cfg.meta_next_notes:
        batch["N"] = batch["Y"][1:]
        for k in ("X", "Y", "I", "V", "D", "C", "S"):
            if k in batch:
                batch[k] = batch[k][:-1]
        if H is not None:
            H = H[:-1]
    if cfg.history:
        if H is None:
            H = np.zeros((batch["X"].shape[0], cfg.latent_dim), dtype=np.float32)
        batch["H"] = np.asarray(H, dtype=np.float32)
    if cfg.decoder_additional_input:
        parts = []
        if cfg.decoder_input_composer:
            parts.append(batch["C"])
        if cfg.append_signature_vector_to_latent:
            parts.append(batch["S"])
        batch["A"] = np.concatenate(parts, axis=-1)
    return batch


def history_from_latents(z: np.ndarray) -> np.ndarray:
    """H[i] = z[i-1], H[0] = 0 (vae_training.py:796-798)."""
    H = np.zeros_like(z)
    H[1:] = z[:-1]
    return H


# ---------------------------------------------------------------------------
# Signature vectors (vae_training.py:660-716)
# ---------------------------------------------------------------------------

def signature_vectors_for_songs(Y_list: list[np.ndarray], cfg: Config) -> list[np.ndarray]:
    out = []
    for Y in Y_list:
        sigs = np.zeros((Y.shape[0], cfg.signature_vector_length), dtype=np.float32)
        for i, window in enumerate(Y):
            sigs[i] = music.signature_from_unrolled_pianoroll(
                window, cfg.max_voices, cfg.include_silent_note, cfg.low_crop
            )
        out.append(sigs)
    return out


def normalize_signatures(
    S_train: list[np.ndarray], S_test: list[np.ndarray]
) -> tuple[list[np.ndarray], list[np.ndarray], np.ndarray, np.ndarray]:
    """Normalize by train mean/std; zero stds -> 1e-10 (vae_training.py:686-716)."""
    # empty-train fallback: take the signature width from whichever split
    # has data (a hardcoded 15 would break custom signature lengths)
    dim = next((s.shape[-1] for s in list(S_train) + list(S_test) if len(s)), 15)
    all_S = np.concatenate(S_train, axis=0) if S_train else np.zeros((0, dim))
    mean = all_S.mean(axis=0) if len(all_S) else np.zeros(dim)
    std = all_S.std(axis=0) if len(all_S) else np.ones(dim)
    std = np.where(std == 0, 1.0e-10, std)
    norm_train = [(s - mean) / std for s in S_train]
    norm_test = [(s - mean) / std for s in S_test]
    return norm_train, norm_test, mean, std


# ---------------------------------------------------------------------------
# Flat global-batch layout
# ---------------------------------------------------------------------------

@dataclass
class FlatSplit:
    """All windows of a split concatenated, with song bookkeeping.

    The global-batch alternative to per-song fit: window order preserves
    song-internal ordering so history rolls stay valid; ``song_id`` marks
    boundaries and ``first_in_song`` marks windows whose history is zero.
    """

    X: np.ndarray            # (N, T_in, input_dim)
    Y: np.ndarray            # (N, T, output_dim)
    I: np.ndarray            # (N, mv, inst_dim)
    V: np.ndarray            # (N, T, 1)
    D: np.ndarray            # (N, T, 2)
    C: np.ndarray            # (N, num_classes) one-hot
    S: np.ndarray            # (N, 15) normalized signatures
    song_id: np.ndarray      # (N,)
    first_in_song: np.ndarray  # (N,) bool
    labels: np.ndarray       # (N,) int class

    @property
    def num_windows(self) -> int:
        return int(self.X.shape[0])


def flatten_split(
    X_list, Y_list, I_list, V_list, D_list, C_list, S_list, cfg: Config
) -> FlatSplit:
    xs, ys, iis, vs, ds, cs, ss, sid, first, labels = ([] for _ in range(10))
    for song_idx in range(len(X_list)):
        n = X_list[song_idx].shape[0]
        D_cat = held_to_categorical(D_list[song_idx])
        xs.append(np.asarray(X_list[song_idx], np.float32))
        ys.append(np.asarray(Y_list[song_idx], np.float32))
        iis.append(np.tile(I_list[song_idx][None], (n, 1, 1)).astype(np.float32))
        vs.append(prepare_velocity(V_list[song_idx], D_cat, cfg))
        ds.append(D_cat)
        cs.append(np.tile(one_hot([C_list[song_idx]], cfg.num_classes), (n, 1)))
        if S_list is not None:
            ss.append(np.asarray(S_list[song_idx], np.float32))
        else:
            ss.append(np.zeros((n, cfg.signature_vector_length), np.float32))
        sid.append(np.full((n,), song_idx, np.int32))
        f = np.zeros((n,), bool)
        f[0] = True
        first.append(f)
        labels.append(np.full((n,), C_list[song_idx], np.int32))

    def cat(parts, width):
        if parts:
            return np.concatenate(parts, axis=0)
        return np.zeros((0, *width), np.float32)

    return FlatSplit(
        X=cat(xs, (cfg.input_length, cfg.input_dim)),
        Y=cat(ys, (cfg.output_length, cfg.output_dim)),
        I=cat(iis, (cfg.max_voices, cfg.instrument_dim)),
        V=cat(vs, (cfg.output_length, 1)),
        D=cat(ds, (cfg.output_length, 2)),
        C=cat(cs, (cfg.num_classes,)),
        S=cat(ss, (cfg.signature_vector_length,)),
        song_id=np.concatenate(sid) if sid else np.zeros((0,), np.int32),
        first_in_song=np.concatenate(first) if first else np.zeros((0,), bool),
        labels=np.concatenate(labels) if labels else np.zeros((0,), np.int32),
    )


def flatten_dataset(ds: Dataset, cfg: Config) -> tuple[FlatSplit, FlatSplit, np.ndarray, np.ndarray]:
    """Dataset -> (train_flat, test_flat, sig_mean, sig_std)."""
    S_train = signature_vectors_for_songs(ds.Y_train, cfg)
    S_test = signature_vectors_for_songs(ds.Y_test, cfg)
    nS_train, nS_test, mean, std = normalize_signatures(S_train, S_test)
    train = flatten_split(
        ds.X_train, ds.Y_train, ds.I_train, ds.V_train, ds.D_train,
        ds.C_train, nS_train, cfg,
    )
    test = flatten_split(
        ds.X_test, ds.Y_test, ds.I_test, ds.V_test, ds.D_test,
        ds.C_test, nS_test, cfg,
    )
    return train, test, mean, std
