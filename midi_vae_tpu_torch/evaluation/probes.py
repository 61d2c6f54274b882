"""Latent-geometry probes: chords, pitches, sampling regions.

A copy of ``midi_vae_tpu/evaluation/probes.py`` over the port's
``GenerationContext`` (the reference's vae_evaluation.py:1306-1763):
* encode synthetic chord bars (major/minor dictionaries) and single-pitch
  bars, embed the latents with t-SNE/PCA, scatter-plot,
* decode z ~ N(loc, scale) grids and measure signature Mahalanobis distance
  to the train distribution (vae_evaluation.py:1530-1649).

All encoder/decoder traffic is batched (one call per probe family instead of
one per chord/pitch). The embeddings only feed the plots: the harness makes
them inside its plot callbacks, so that a machine without scikit-learn skips
those plots as it skips them without matplotlib.
"""

from __future__ import annotations

import numpy as np

from ..config import Config
from ..utils import music
from .generation import GenerationContext, split_song_back_to_samples

# Chord tables relative to C of the chosen octave (vae_evaluation.py:1311-1352)
MAJ_CHORDS = {
    "C": (0, 4, 7), "C#/Db": (1, 5, 8), "D": (2, 6, 9), "D#/Eb": (3, 7, 10),
    "E": (4, 8, 11), "F": (-7, -3, 0), "F#/Gb": (-6, -2, 1), "G": (-5, -1, 2),
    "G#/Ab": (-4, 0, 3), "A": (-3, 1, 4), "A#/B": (-2, 2, 5), "H": (-1, 3, 6),
}
MIN_CHORDS = {
    "Cm": (0, 3, 7), "C#m/Dbm": (1, 4, 8), "Dm": (2, 5, 9), "D#m/Ebm": (3, 6, 10),
    "Em": (4, 7, 11), "Fm": (-7, -4, 0), "F#m/Gbm": (-6, -3, 1), "Gm": (-5, -2, 2),
    "G#m/Abm": (-4, -1, 3), "Am": (-3, 0, 4), "A#m/Bm": (-2, 1, 5), "Hm": (-1, 2, 6),
}
MAJ_MIN_CHORDS = {**MAJ_CHORDS, **MIN_CHORDS}

NOTE_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "H"]


def pitch_to_name(pitch: int) -> str:
    return NOTE_NAMES[pitch % 12] + str(pitch // 12)


def chord_window(chord: tuple[int, ...], octave: int, cfg: Config):
    """Synthetic encoder inputs for one chord (vae_evaluation.py:1355-1385)."""
    T = cfg.output_length
    X = np.zeros((T, cfg.new_num_notes + cfg.silent_dim), np.float32)
    offset = 12 * octave
    for step in range(T):
        if step % cfg.max_voices < len(chord):
            pitch = offset + chord[step % cfg.max_voices] - cfg.low_crop
            X[step, pitch] = 1
        elif cfg.include_silent_note:
            X[step, -1] = 1
    I = np.zeros((cfg.max_voices, cfg.meta_instrument_dim), np.float32)
    I[:, 0] = 1
    V = np.ones((T,), np.float32)
    D = np.ones((T,), np.float32)
    D[0] = 0
    return X[None], I, V[None], D[None]


def pitch_window(pitch: int, cfg: Config):
    """Synthetic encoder inputs for one held pitch (vae_eval.py:1662-1678)."""
    T = cfg.output_length
    X = np.zeros((T, cfg.new_num_notes + cfg.silent_dim), np.float32)
    X[:, pitch - cfg.low_crop] = 1
    I = np.zeros((cfg.max_voices, cfg.meta_instrument_dim), np.float32)
    I[:, 0] = 1
    V = np.ones((T,), np.float32)
    D = np.ones((T,), np.float32)
    D[0] = 0
    return X[None], I, V[None], D[None]


def _encode_windows(ctx: GenerationContext, windows):
    """Stack per-probe windows into ONE encode dispatch (the probes share
    the all-piano instrument matrix, so they batch like one song)."""
    X = np.concatenate([w[0] for w in windows], axis=0)
    V = np.concatenate([w[2] for w in windows], axis=0)
    D = np.concatenate([w[3] for w in windows], axis=0)
    return ctx.encode_song(X, windows[0][1], V, D)


def encode_chords(ctx: GenerationContext, chords: dict, octave: int = 5):
    """-> (names, latents (n, latent_dim)); one batched encode dispatch."""
    names = list(chords)
    windows = [chord_window(chord, octave, ctx.cfg) for chord in chords.values()]
    return names, _encode_windows(ctx, windows)


def encode_pitches(ctx: GenerationContext):
    cfg = ctx.cfg
    pitches = list(range(cfg.low_crop, cfg.high_crop))
    windows = [pitch_window(pitch, cfg) for pitch in pitches]
    return pitches, _encode_windows(ctx, windows)


def embed_2d(latents: np.ndarray, method: str = "pca", n_components: int = 2):
    if method == "pca":
        from sklearn.decomposition import PCA

        return PCA(n_components=n_components).fit_transform(latents)
    if method == "tsne":
        from sklearn.manifold import TSNE

        perplexity = min(30.0, max(2.0, len(latents) / 4))
        return TSNE(n_components=n_components, perplexity=perplexity).fit_transform(
            latents
        )
    raise ValueError(f"unknown embedding {method!r}")


def plot_chord_embedding(names, embedded, title: str, save_path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig, ax = plt.subplots()
    plt.title(title)
    colors = [0.0 if name.endswith("m") else 1.0 for name in names]
    plt.scatter(embedded[:, 0], embedded[:, 1], c=colors, cmap="jet")
    for i, name in enumerate(names):
        ax.annotate(name, (embedded[i, 0], embedded[i, 1]), size=7)
    plt.tight_layout()
    plt.savefig(save_path)
    plt.close(fig)


def plot_pitch_embedding(pitches, embedded, title: str, save_path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig, ax = plt.subplots()
    plt.title(title)
    emb = np.asarray(embedded).reshape(len(pitches), -1)
    if emb.shape[1] == 1:
        plt.scatter(pitches, emb[:, 0])
        for i, p in enumerate(pitches):
            ax.annotate(pitch_to_name(p), (pitches[i], emb[i, 0]), size=7)
    else:
        colors = [(p % 12) / 12.0 for p in pitches]
        plt.scatter(emb[:, 0], emb[:, 1], c=colors)
        for i, p in enumerate(pitches):
            ax.annotate(pitch_to_name(p), (emb[i, 0], emb[i, 1]), size=7)
    plt.tight_layout()
    plt.savefig(save_path)
    plt.close(fig)


# ---------------------------------------------------------------------------
# Sampling-region Mahalanobis probe (vae_evaluation.py:1535-1649)
# ---------------------------------------------------------------------------

# exactly the reference's grids, INCLUDING its duplicated trailing
# 10000.0 (vae_evaluation.py:1550, :1602 -- 11 entries each; the curve
# and the RNG consumption depend on the length, so the quirk is kept)
DEFAULT_SCALES = [
    1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0, 1000.0, 10000.0, 10000.0,
]
DEFAULT_LOCS = [
    0.0, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0, 1000.0, 10000.0, 10000.0,
]


def signature_mahalanobis_for_samples(
    ctx: GenerationContext,
    all_signatures: np.ndarray,
    locs_or_scales: list[float],
    z_std: float,
    vary: str,
    samples_per_setting: int = 20,
    rng: np.random.RandomState | None = None,
    sample_method: str = "argmax",
):
    """For each loc/scale setting, decode random latents and measure the
    Mahalanobis distance of their signatures to the train distribution.

    vary='scale': z ~ N(0, setting); vary='loc': z ~ N(setting, z_std).
    Returns (means, stds) arrays over settings.

    Reference-faithful decode conditioning (gated by the ``--probes``
    differential, tools/ref_parity_check.py): each reference draw runs
    through ``prepare_decoder_input(R, C=0, S=0)`` (vae_evaluation.py:
    1563-1566) as its own ``decoder.predict`` call, so the
    velocity-override previous-pitch chain resets per sample
    (``independent_windows``). The per-setting draw is one ``rng.normal``
    of shape (samples, latent): numpy's legacy gaussian cache persists
    across calls, so this consumes the bit-identical stream the
    reference's per-sample (1, latent) draws do. With
    ``decoder_input_composer`` on, the decoder is conditioned on the
    composer-0 one-hot -- the reference's intent, which its own code
    cannot execute (``prepare_decoder_input`` does ``list.extend(C)``
    with int C=0, a TypeError, vae_definition.py:838; the shipped
    configs run both additional-input flags off, where the sides agree).
    """
    cfg = ctx.cfg
    rng = rng or np.random.RandomState()
    mean, cov = music.get_mean_and_cov_from_vector_list(all_signatures)
    additional = ctx.additional_for(
        0, np.zeros((1, cfg.signature_vector_length), np.float32),
        samples_per_setting,
    )
    means, stds = [], []
    for setting in locs_or_scales:
        if vary == "scale":
            zs = rng.normal(0.0, setting, size=(samples_per_setting, cfg.latent_dim))
        elif vary == "loc":
            zs = rng.normal(setting, z_std, size=(samples_per_setting, cfg.latent_dim))
        else:
            raise ValueError("vary must be 'scale' or 'loc'")
        Y, _, _, _, _ = ctx.decode_and_process(
            zs.astype(np.float32), additional=additional,
            sample_method=sample_method, rng=rng, independent_windows=True,
        )
        distances = []
        for window in split_song_back_to_samples(Y, cfg.output_length):
            poly = music.monophonic_to_khot_pianoroll(window, cfg.max_voices)
            sig = music.signature_from_pianoroll(poly, cfg.low_crop)
            distances.append(music.mahalanobis_distance(sig, mean, cov))
        means.append(float(np.mean(distances)))
        stds.append(float(np.std(distances)))
    return np.asarray(means), np.asarray(stds)


def plot_mahalanobis_curve(settings, means, stds, title: str, save_path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig, ax = plt.subplots()
    plt.plot(settings, means, label="Mean Mahalanobis distance")
    plt.plot(settings, stds, label="Std Mahalanobis distance")
    plt.title(title)
    plt.xlabel("Scales")
    ax.set_xscale("log")
    plt.legend(loc="upper left", prop={"size": 8})
    plt.tight_layout()
    plt.savefig(save_path)
    plt.close(fig)
