"""A copy of ``midi_vae_tpu/utils/plotting.py`` for the port, which imports
nothing of the JAX package.

Plot helpers: training curves and pianoroll figures.

Replaces the reference's matplotlib plotting (vae_training.py:359-567 loss
grid, data_class.py:260-350 pianoroll plots). PNG only -- the matplotlib2tikz
.tex exports of the reference are dropped (SURVEY.md §2.2).
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt


def plot_training_history(history: dict, save_path: str) -> None:
    """3x2 loss/accuracy grid like vae_training.py:359-567."""
    plt = _plt()
    panels = [
        ("loss", "total loss"),
        ("notes_loss", "notes loss"),
        ("notes_acc", "notes accuracy"),
        ("kl_loss", "KL"),
        ("composer_loss", "composer loss"),
        ("meta_velocity_loss", "velocity loss"),
    ]
    train = history.get("train", [])
    test = history.get("test", [])
    epochs = history.get("epoch", list(range(len(train))))
    fig, axes = plt.subplots(3, 2, figsize=(12, 10))
    for ax, (key, title) in zip(axes.flat, panels):
        tr = [m.get(key) for m in train]
        if any(v is not None for v in tr):
            ax.plot(epochs, tr, label="train")
        if test:
            te_e = [m["epoch"] for m in test if key in m]
            te_v = [m[key] for m in test if key in m]
            if te_v:
                ax.plot(te_e, te_v, label="test")
        ax.set_title(title, fontsize=9)
        ax.legend(loc="best", prop={"size": 7})
    fig.tight_layout()
    fig.savefig(save_path)
    plt.close(fig)


def draw_pianoroll(pianoroll: np.ndarray, name: str = "Notes", save_path: str = "") -> None:
    """Plain pianoroll plot (data_class.py:333-350)."""
    plt = _plt()
    plt.figure(figsize=(20.0, 10.0))
    plt.title(f"Pianoroll Pitch-plot of {name}", fontsize=10)
    vmax = float(np.max(pianoroll)) if np.max(pianoroll) > 0 else 1.0
    plt.pcolor(pianoroll.T, cmap="Greys", vmin=0, vmax=vmax)
    plt.xlabel("step")
    plt.ylabel("pitch")
    if save_path:
        plt.savefig(save_path)
    plt.close()


def draw_difference_pianoroll(
    original: np.ndarray,
    predicted: np.ndarray,
    name_1: str = "Original",
    name_2: str = "Predicted",
    save_path: str = "",
) -> None:
    """Original-vs-predicted difference plot (data_class.py:298-329)."""
    if original.shape != predicted.shape:
        print("Shape mismatch. Not drawing a plot.")
        return
    plt = _plt()
    from matplotlib import colors

    draw_matrix = original + 2 * predicted
    cm = colors.ListedColormap(["white", "blue", "red", "black"])
    norm = colors.BoundaryNorm([0, 1, 2, 3, 4], cm.N)
    plt.figure(figsize=(20.0, 10.0))
    plt.title(f"Difference-Pitch-plot of {name_1} and {name_2}", fontsize=10)
    plt.pcolor(draw_matrix.T, cmap=cm, norm=norm)
    if save_path:
        plt.savefig(save_path)
    plt.close()


def draw_mixture_pianoroll(
    song_1: np.ndarray,
    song_2: np.ndarray,
    mixture_song: np.ndarray,
    name_1: str = "Song 1",
    name_2: str = "Song 2",
    mixture_name: str = "Mixture",
    save_path: str = "",
) -> None:
    """Three-way mixture plot (data_class.py:260-295)."""
    if song_1.shape != song_2.shape or song_1.shape != mixture_song.shape:
        print("Shape mismatch. Not drawing a plot.")
        return
    plt = _plt()
    draw_matrix = song_1 + song_2 * 2 + mixture_song * 4
    plt.figure(figsize=(20.0, 10.0))
    plt.title(f"Mixture-Pitch-plot of {name_1} and {name_2}", fontsize=10)
    plt.pcolor(draw_matrix.T, cmap="jet", vmin=-7, vmax=7)
    if save_path:
        plt.savefig(save_path)
    plt.close()


def plot_confusion_matrix(
    confusion: np.ndarray, class_names: list[str], accuracy: float, save_path: str
) -> None:
    """Classifier confusion matrix plot (pitch_classifier.py:166-179)."""
    plt = _plt()
    n = confusion.shape[0]
    row_sums = confusion.sum(axis=1, keepdims=True)
    # out= is required: where= alone leaves the masked (zero-sum) rows
    # UNINITIALIZED, corrupting the plot's color scale
    normed = np.divide(
        confusion, row_sums, out=np.zeros_like(confusion, dtype=np.float64),
        where=row_sums > 0,
    )
    plt.figure()
    plt.imshow(normed, interpolation="nearest")
    plt.title(f"Total accuracy: {accuracy * 100:.2f}%")
    plt.ylabel("True label")
    plt.xlabel("Predicted label")
    plt.xticks(np.arange(n), class_names)
    plt.yticks(np.arange(n), class_names)
    plt.colorbar()
    plt.savefig(save_path)
    plt.close()
